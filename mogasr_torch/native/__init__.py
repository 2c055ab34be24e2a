"""The port's native (C++) host code, loaded through ctypes: the FLAC decoder
and the CTC prefix beam.

``flac_native.cpp`` and ``ctc_beam_native.cpp`` are byte-identical copies of
the reference's mogasr/native sources (host C++, not GPU kernels). At first
use each is compiled with the system g++ into ``build/mogasr_torch/`` at the
repository root (the directory the CUDA kernels build into, git-ignored),
never next to the source; the file name carries a hash of the source and
the flags, so a changed source never loads a stale library. Processes that
build it at once each write their own temporary file and rename it into
place. ``load_flac_lib`` and ``load_ctc_beam_lib`` return None when g++ or
the load fails, as the reference's do; ``data/audio.py`` then falls back to
``soundfile``, ``am.ctc.ctc_prefix_beam_decode_native`` returns None.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "mogasr_torch")
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_LOCK = threading.Lock()
_FLAC_LIB: Optional[ctypes.CDLL] = None
_FLAC_TRIED = False
_CTC_LIB: Optional[ctypes.CDLL] = None
_CTC_TRIED = False


def library_path(name: str) -> str:
    """Where ``<name>.cpp`` builds: build/mogasr_torch/<name>-<hash>.so."""
    h = hashlib.sha256()
    with open(os.path.join(_HERE, name + ".cpp"), "rb") as f:
        h.update(f.read())
    h.update(" ".join(_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _build(src: str, so_path: str) -> bool:
    os.makedirs(os.path.dirname(so_path), exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        subprocess.run(["g++", *_FLAGS, src, "-o", tmp], check=True, capture_output=True, timeout=120)
        os.replace(tmp, so_path)
        return True
    except (subprocess.SubprocessError, OSError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_flac_lib() -> Optional[ctypes.CDLL]:
    """The FLAC-decoder shared library, built on first call; None if g++ or
    dlopen is unavailable. Its ctypes signatures are the reference's."""
    global _FLAC_LIB, _FLAC_TRIED
    with _LOCK:
        if _FLAC_LIB is not None or _FLAC_TRIED:
            return _FLAC_LIB
        _FLAC_TRIED = True
        so_path = library_path("flac_native")
        if not os.path.exists(so_path) and not _build(os.path.join(_HERE, "flac_native.cpp"), so_path):
            return None
        try:
            lib = ctypes.CDLL(so_path)
        except OSError:
            return None
        lib.flac_stream_info.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_longlong),
        ]
        lib.flac_stream_info.restype = ctypes.c_int32
        lib.flac_decode.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.flac_decode.restype = ctypes.c_longlong
        _FLAC_LIB = lib
        return _FLAC_LIB


def load_ctc_beam_lib() -> Optional[ctypes.CDLL]:
    """The CTC prefix-beam shared library, built on first call; None if g++
    or dlopen is unavailable. Its ctypes signature is the reference's."""
    global _CTC_LIB, _CTC_TRIED
    with _LOCK:
        if _CTC_LIB is not None or _CTC_TRIED:
            return _CTC_LIB
        _CTC_TRIED = True
        so_path = library_path("ctc_beam_native")
        if not os.path.exists(so_path) and not _build(os.path.join(_HERE, "ctc_beam_native.cpp"), so_path):
            return None
        try:
            lib = ctypes.CDLL(so_path)
        except OSError:
            return None
        lib.ctc_prefix_beam.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_double,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int32,
        ]
        lib.ctc_prefix_beam.restype = ctypes.c_int32
        _CTC_LIB = lib
        return _CTC_LIB
