"""The port's host-side native code: the wire CRC (`crc32c.cpp`), the
SecAgg path's finite-field functions (`finite_field.cpp`) and the native
edge trainers (`edge_trainer.cpp`: `NativeLRTrainer`, `NativeCNNTrainer`).

Each source is compiled by `g++` into `fedml_tpu_torch/_build/`
(git-ignored) at first use, named by a hash of the source and the flags,
and loaded with `ctypes`. There is no fallback: a frame without its CRC
trailer is never written, a Shamir reconstruction never runs on a slower
stand-in, and an edge trainer never trains on another engine, so a failed
build or load raises.
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
         "finite_field": "the finite-field library",
         "edge_trainer": "the native edge-trainer library"}

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
    elif name == "finite_field":
        args = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64]
        for fn in (lib.ff_modinv_batch, lib.ff_lagrange_at_zero):
            fn.argtypes = args
            fn.restype = None
    else:
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        # (x, y, n, d, k, params, perm, steps, bs, lr)
        lib.lr_sgd_train.argtypes = [ptr, ptr, i64, i64, i64, ptr, ptr,
                                     i64, i64, ctypes.c_double]
        lib.lr_sgd_train.restype = ctypes.c_double
        # (x, y, n, H, W, Cin, C1, C2, Dh, K, params, perm, steps, bs, lr)
        lib.cnn_sgd_train.argtypes = ([ptr, ptr] + [i64] * 8
                                      + [ptr, ptr, i64, i64,
                                         ctypes.c_double])
        lib.cnn_sgd_train.restype = ctypes.c_double


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


def available() -> bool:
    """Whether every host library (`_LIBS`) builds and loads here. The
    libraries have no fallback, so a False here means the wire CRC,
    SecAgg's finite field and the edge trainers raise when used."""
    try:
        for name in _LIBS:
            _load(name)
    except (OSError, RuntimeError):
        return False
    return True


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


# ------------------------------------------------------ native edge trainers
class _NativeTrainer:
    """The edge-client contract, `train(params, round_idx) -> (params,
    n_samples, {"train_loss"})`: `params` is the flat float32 vector in
    the native layout (returned as such) or the port's parameter dict
    (flattened into that layout, returned as a dict of float32 numpy
    leaves), so the trainer rides `cross_device.EdgeClient` as it is.
    Each round's minibatch order is `epochs` permutations of the samples
    from RandomState(seed * 100003 + round_idx), each cut to whole
    batches, as the JAX wrappers draw it."""

    def __init__(self, x: np.ndarray, y: np.ndarray, num_classes: int,
                 lr: float, batch_size: int, epochs: int, seed: int):
        _load("edge_trainer")
        self.x = np.ascontiguousarray(np.asarray(x, np.float32))
        self.y = np.ascontiguousarray(np.asarray(y, np.int32))
        self.k = int(num_classes)
        # the C++ loops index logits[y[i]] unchecked: a bad label must be
        # a ValueError here, not a native heap overrun
        if self.y.size and (self.y.min() < 0 or self.y.max() >= self.k):
            raise ValueError(
                f"labels must be in [0, {self.k}); got range "
                f"[{self.y.min()}, {self.y.max()}]")
        self.lr, self.bs, self.epochs, self.seed = lr, batch_size, epochs, seed
        self.n_samples = int(self.x.shape[0])

    def _order(self, round_idx: int) -> tuple[int, int, np.ndarray]:
        """(batch size, steps, the [steps * batch] sample order)."""
        n = self.n_samples
        bs = min(self.bs, n)
        nb = n // bs
        rs = np.random.RandomState(self.seed * 100003 + round_idx)
        perm = np.concatenate([rs.permutation(n)[: nb * bs]
                               for _ in range(self.epochs)])
        return bs, self.epochs * nb, np.ascontiguousarray(perm, np.int64)

    def train(self, params, round_idx: int):
        flat = np.array(self.flatten(params) if isinstance(params, dict)
                        else params, np.float32, copy=True, order="C")
        if flat.shape != (self.n_params,):
            raise ValueError(f"params size {flat.size} != expected "
                             f"{self.n_params} for this architecture")
        loss = self._run(flat, *self._order(round_idx))
        out = self.unflatten(params, flat) if isinstance(params, dict) \
            else flat
        return out, self.n_samples, {"train_loss": float(loss)}


class NativeLRTrainer(_NativeTrainer):
    """Local SGD of a softmax linear model in host C++ (`lr_sgd_train`):
    the flat vector is W [d, k] row-major then b [k]; as a dict, the
    port's `lr` model (`Dense_0.kernel` [d, k], `Dense_0.bias` [k]).
    x [n, d] float32, y [n] int labels."""

    def __init__(self, x: np.ndarray, y: np.ndarray, num_classes: int,
                 lr: float = 0.1, batch_size: int = 16, epochs: int = 1,
                 seed: int = 0):
        super().__init__(x, y, num_classes, lr, batch_size, epochs, seed)

    @property
    def n_params(self) -> int:
        return self.x.shape[1] * self.k + self.k

    def flatten(self, params: dict) -> np.ndarray:
        return np.concatenate([
            np.asarray(params["Dense_0.kernel"], np.float32).reshape(-1),
            np.asarray(params["Dense_0.bias"], np.float32).reshape(-1)])

    def unflatten(self, template: dict, flat: np.ndarray) -> dict:
        d = self.x.shape[1]
        return {"Dense_0.kernel": flat[: d * self.k].reshape(d, self.k),
                "Dense_0.bias": flat[d * self.k:]}

    def _run(self, flat, bs, steps, perm) -> float:
        n, d = self.x.shape
        return _load("edge_trainer").lr_sgd_train(
            self.x.ctypes.data, self.y.ctypes.data, n, d, self.k,
            flat.ctypes.data, perm.ctypes.data, steps, bs, self.lr)


class NativeCNNTrainer(_NativeTrainer):
    """Local SGD of the 2-conv CNN of `models/hub.py` in host C++
    (`cnn_sgd_train`: conv, pool and dense forward and backward written
    by hand). The flat vector is the flax CNN's leaf order with HWIO conv
    kernels, `cross_silo.secagg_manager.flatten_params` of the port's
    `cnn` model, which is how a dict is flattened.

    x: [n, H, W, Cin] float32 (H, W divisible by 4); y: [n] int labels."""

    def __init__(self, x: np.ndarray, y: np.ndarray, num_classes: int,
                 c1: int = 32, c2: int = 64, hidden: int = 128,
                 lr: float = 0.1, batch_size: int = 16, epochs: int = 1,
                 seed: int = 0):
        x = np.asarray(x)
        if x.ndim != 4:
            raise ValueError(f"x must be [n, H, W, Cin]; got {x.shape}")
        if x.shape[1] % 4 or x.shape[2] % 4:
            raise ValueError(f"H, W must be divisible by 4 (two maxpool2 "
                             f"stages); got {x.shape[1:3]}")
        super().__init__(x, y, num_classes, lr, batch_size, epochs, seed)
        self.c1, self.c2, self.hidden = int(c1), int(c2), int(hidden)

    @property
    def n_params(self) -> int:
        _n, h, w, ci = self.x.shape
        f = (h // 4) * (w // 4) * self.c2
        return (self.c1 + 9 * ci * self.c1 + self.c2 + 9 * self.c1 * self.c2
                + self.hidden + f * self.hidden + self.k
                + self.hidden * self.k)

    def flatten(self, params: dict) -> np.ndarray:
        from ..cross_silo.secagg_manager import flatten_params

        return flatten_params(params).astype(np.float32)

    def unflatten(self, template: dict, flat: np.ndarray) -> dict:
        from ..cross_silo.secagg_manager import unflatten_params

        return unflatten_params(template, flat)

    def _run(self, flat, bs, steps, perm) -> float:
        n, h, w, ci = self.x.shape
        return _load("edge_trainer").cnn_sgd_train(
            self.x.ctypes.data, self.y.ctypes.data, n, h, w, ci, self.c1,
            self.c2, self.hidden, self.k, flat.ctypes.data,
            perm.ctypes.data, steps, bs, self.lr)
