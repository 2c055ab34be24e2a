"""Build and load the port's CUDA kernels: nvcc into a plain C library, ctypes.

Each ``csrc/<name>.cu`` is compiled at first use into its own shared library
under ``build/mogasr_torch/`` at the repository root. The file name carries a
hash of the sources and the flags, so an unchanged kernel is never rebuilt
and a changed one never loads a stale library. No source includes PyTorch's
headers: a plain C interface builds in seconds, where a PyTorch extension
takes minutes.

Every C entry point takes device pointers and the CUDA stream as ``void*``,
sizes as ``int``, launches on that stream without synchronising, and returns
``cudaGetLastError()``; :func:`check` turns a nonzero code into an exception.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "mogasr_torch")

_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]
# viterbi.cu is held bitwise to the plain PyTorch recursion, which rounds a
# product and the sum that follows it separately: no FMA contraction there.
# forward_backward.cu follows the plain version's rounding the same way.
_EXTRA_FLAGS = {"viterbi": ["-fmad=false"], "forward_backward": ["-fmad=false"]}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME/bin, then $PATH, then /usr/local/cuda/bin."""
    candidates = []
    home = os.environ.get("CUDA_HOME")
    if home:
        candidates.append(os.path.join(home, "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found in $CUDA_HOME/bin, on $PATH or in /usr/local/cuda/bin: "
        "mogasr_torch compiles its CUDA kernels at first use and needs the "
        "CUDA toolkit"
    )


def _library_path(name: str, flags: Sequence[str]) -> str:
    h = hashlib.sha256()
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    h.update(" ".join(flags).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists."""
    src = os.path.join(CSRC, name + ".cu")
    flags = _FLAGS + _EXTRA_FLAGS.get(name, [])
    so = _library_path(name, flags)
    if os.path.exists(so):
        return so
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [nvcc, *flags, "-o", tmp, src], capture_output=True, text=True
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {src} (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, so)
    return so


def build_all() -> float:
    """Build every kernel in ``csrc/``, one nvcc per source, all at once;
    returns the wall seconds it took."""
    t0 = time.perf_counter()
    names = [os.path.splitext(os.path.basename(p))[0] for p in sorted(glob.glob(os.path.join(CSRC, "*.cu")))]
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        for fut in [pool.submit(build, n) for n in names]:
            fut.result()
    return time.perf_counter() - t0


def load(name: str, signatures: Dict[str, List]) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu`` with ``argtypes`` declared.

    signatures: entry point -> its ctypes argtypes (``c_void_p`` for every
    pointer and the stream, ``c_int`` for every int, ``c_float``). Every
    entry point returns an int CUDA error code; ``<name>_error_string``
    is bound as well.
    """
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            err_fn = getattr(lib, f"{name}_error_string")
            err_fn.argtypes = [ctypes.c_int]
            err_fn.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, name: str, err: int, what: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def refuse_grad(kernel: str, instead: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise RuntimeError when autograd would need a gradient through a
    kernel: grad mode is on and one of ``tensors`` requires grad.

    The kernels write their outputs through ctypes into tensors autograd
    knows nothing of, so their results carry no ``grad_fn``: a backward pass
    would leave the inputs' gradients at None, and an optimizer skips such
    parameters without a word. ``instead`` says what to call in their place.
    """
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{kernel} has no backward: its result would carry no gradient to the inputs that "
                           f"require one; {instead}")


def launch_counts() -> Dict[str, int]:
    """The wrappers' launch counters, by kernel: K1 ``gmm_score``, K1w
    ``gmm_score_wide``, K5 ``gmm_score_int8``, K2 ``viterbi``, K3
    ``fb_forward``/``fb_backward``/``fb_combine``, K4 ``lstm_scan``."""
    from mogasr_torch.am import gmm_cuda, lstm_cuda
    from mogasr_torch.decoder import fb_cuda, viterbi_cuda

    return {"gmm_score": gmm_cuda.LAUNCHES, "gmm_score_wide": gmm_cuda.WIDE_LAUNCHES,
            "gmm_score_int8": gmm_cuda.INT8_LAUNCHES, "viterbi": viterbi_cuda.LAUNCHES,
            "fb_forward": fb_cuda.FWD_LAUNCHES, "fb_backward": fb_cuda.BWD_LAUNCHES,
            "fb_combine": fb_cuda.COMBINE_LAUNCHES, "lstm_scan": lstm_cuda.LAUNCHES}
