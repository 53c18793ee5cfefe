"""The port's host-side native code: the wire CRC (`crc32c.cpp`) and the
SecAgg path's finite-field functions (`finite_field.cpp`).

Each source is compiled by `g++` into `fedml_tpu_torch/_build/`
(git-ignored) at first use, named by a hash of the source and the flags,
and loaded with `ctypes`. There is no fallback: a frame without its CRC
trailer is never written and a Shamir reconstruction never runs on a
slower stand-in, so a failed build or load raises.
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
BUILD_DIR = _HERE.parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
# library name -> what it is, for the error message of a failed build
_LIBS = {"crc32c": "the wire CRC library",
         "finite_field": "the finite-field library"}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update((_HERE / f"{name}.cpp").read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _build(name: str, out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.tmp{os.getpid()}")
    cmd = ["g++", *GXX_FLAGS, str(_HERE / f"{name}.cpp"), "-o", str(tmp)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(
            f"cannot build {_LIBS[name]} ({' '.join(cmd)}): {e}") from e
    if r.returncode != 0:
        raise RuntimeError(f"{_LIBS[name]} failed to build "
                           f"(g++ exit {r.returncode}):\n{r.stderr[-2000:]}")
    os.replace(tmp, out)   # atomic: a concurrent loader sees all or none


def _bind(name: str, lib: ctypes.CDLL) -> None:
    if name == "crc32c":
        lib.crc32c_init.argtypes = []
        lib.crc32c_init.restype = None
        lib.crc32c.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.crc32c.restype = ctypes.c_uint32
        lib.crc32c_init()
    else:
        args = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64]
        for fn in (lib.ff_modinv_batch, lib.ff_lagrange_at_zero):
            fn.argtypes = args
            fn.restype = None


def _load(name: str) -> ctypes.CDLL:
    with _lock:
        if name not in _libs:
            path = lib_path(name)
            if not path.exists():
                _build(name, path)
            lib = ctypes.CDLL(str(path))
            _bind(name, lib)
            _libs[name] = lib
        return _libs[name]


def crc32c(data) -> int:
    """CRC-32C of a bytes-like object (bytes, bytearray, memoryview; read
    in place). ctypes releases the GIL for the call."""
    lib = _load("crc32c")
    buf = np.frombuffer(data, np.uint8)
    if not buf.flags.c_contiguous:
        buf = np.ascontiguousarray(buf)
    return int(lib.crc32c(buf.ctypes.data, buf.size))


def _field_call(fn: str, x, p: int) -> np.ndarray:
    lib = _load("finite_field")
    flat = np.ascontiguousarray(np.asarray(x, np.int64).ravel())
    out = np.empty_like(flat)
    getattr(lib, fn)(flat.ctypes.data, out.ctypes.data, flat.size, int(p))
    return out.reshape(np.shape(x))


def modinv_batch(x, p: int) -> np.ndarray:
    """x^(p-2) mod p element-wise (the Fermat inverse, p prime)."""
    return _field_call("ff_modinv_batch", x, p)


def lagrange_at_zero(points, p: int) -> np.ndarray:
    """The Lagrange basis at zero of `points` mod p: the coefficients that
    reconstruct a Shamir secret from the shares evaluated there."""
    return _field_call("ff_lagrange_at_zero", points, p)
