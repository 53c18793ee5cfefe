"""The port's host-side native code: the wire CRC.

`crc32c.cpp` is compiled by `g++` into `fedml_tpu_torch/_build/`
(git-ignored) at first use, named by a hash of the source and the flags,
and loaded with `ctypes`. There is no fallback: a frame without its CRC
trailer is never written, so a failed build or load raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "crc32c.cpp"
BUILD_DIR = _HERE.parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"crc32c-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.tmp{os.getpid()}")
    cmd = ["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(
            f"cannot build the wire CRC library ({' '.join(cmd)}): {e}") from e
    if r.returncode != 0:
        raise RuntimeError(f"the wire CRC library failed to build "
                           f"(g++ exit {r.returncode}):\n{r.stderr[-2000:]}")
    os.replace(tmp, out)   # atomic: a concurrent loader sees all or none


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            path = lib_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            lib.crc32c_init.argtypes = []
            lib.crc32c_init.restype = None
            lib.crc32c.argtypes = [ctypes.c_void_p, ctypes.c_int64]
            lib.crc32c.restype = ctypes.c_uint32
            lib.crc32c_init()
            _lib = lib
        return _lib


def crc32c(data) -> int:
    """CRC-32C of a bytes-like object (bytes, bytearray, memoryview; read
    in place). ctypes releases the GIL for the call."""
    lib = _load()
    buf = np.frombuffer(data, np.uint8)
    if not buf.flags.c_contiguous:
        buf = np.ascontiguousarray(buf)
    return int(lib.crc32c(buf.ctypes.data, buf.size))
