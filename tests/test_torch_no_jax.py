"""The port stands alone: every mogasr_torch module and chip_smoke.py import in
a fresh interpreter where jax, flax and the JAX package mogasr are blocked."""

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
    for name in ("mogasr_torch.pipeline", "mogasr_torch.am.gmm_cuda", "mogasr_torch.am.em",
                 "mogasr_torch.decoder.fb_cuda", "mogasr_torch.hmm.triphone", "mogasr_torch.eval.wer",
                 "mogasr_torch.am.neural", "mogasr_torch.am.params", "mogasr_torch.am.fast_lstm",
                 "mogasr_torch.am.lstm_cuda", "mogasr_torch.am.quantize", "mogasr_torch.am.mmi",
                 "mogasr_torch.am.smbr", "mogasr_torch.utils.checkpoint", "mogasr_torch.utils.metrics",
                 "mogasr_torch.utils.bundle", "mogasr_torch.cli.common", "mogasr_torch.cli.train_gmm",
                 "mogasr_torch.recipes.train_headline", "mogasr_torch.recipes.decode_held_out",
                 "mogasr_torch.lm.ngram", "mogasr_torch.lm.arpa", "mogasr_torch.decoder.lm_viterbi",
                 "mogasr_torch.decoder.lattice", "mogasr_torch.decoder.confusion", "mogasr_torch.decoder.kws",
                 "mogasr_torch.cli.decode", "mogasr_torch.cli.search", "mogasr_torch.utils.segment",
                 "mogasr_torch.native", "mogasr_torch.data.kaldi_io", "mogasr_torch.data.audio",
                 "mogasr_torch.data.flac_write", "mogasr_torch.data.manifest", "mogasr_torch.data.librispeech",
                 "mogasr_torch.data.augment", "mogasr_torch.cli.features", "mogasr_torch.cli.score",
                 "mogasr_torch.cli.align", "mogasr_torch.cli.eval"):
        assert name in modules
    code = "\n".join([
        "import sys",
        "sys.modules['jax'] = None",
        "sys.modules['flax'] = None",
        "sys.modules['mogasr'] = None",
        "import importlib",
        f"for name in {modules!r}: importlib.import_module(name)",
        "import chip_smoke",
        "assert not any(m in ('jax', 'mogasr') or m.startswith(('jax.', 'flax', 'mogasr.')) "
        "for m, v in sys.modules.items() if v is not None)",
        "print('ok')",
    ])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
