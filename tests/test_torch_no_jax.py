"""The port must import where jax does not exist: every mogasr_torch module and
chip_smoke.py import in a fresh interpreter with jax and flax blocked."""

import os
import pkgutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    import mogasr_torch

    names = ["mogasr_torch"]
    for info in pkgutil.walk_packages(mogasr_torch.__path__, "mogasr_torch."):
        names.append(info.name)
    return names


def test_port_imports_without_jax():
    modules = _port_modules()
    assert "mogasr_torch.pipeline" in modules and "mogasr_torch.am.gmm_cuda" in modules
    code = "\n".join([
        "import sys",
        "sys.modules['jax'] = None",
        "sys.modules['flax'] = None",
        "import importlib",
        f"for name in {modules!r}: importlib.import_module(name)",
        "import chip_smoke",
        "assert not any(m == 'jax' or m.startswith(('jax.', 'flax')) "
        "for m, v in sys.modules.items() if v is not None)",
        "print('ok')",
    ])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
