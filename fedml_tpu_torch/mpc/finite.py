"""Finite-field primitives for secure aggregation (port of
`fedml_tpu/mpc/finite.py`; reference: core/mpc/secagg.py:8-79 modular
inverse and Lagrange coefficients, :344-383 quantization, :164-212 Shamir).

Batched numpy int64 arithmetic with explicit mod-p reductions, the same
operations in the same order as the JAX package's module, so quantized
vectors, shares, masks and packed frames come out bitwise the same from
the same inputs and generator states. The batch inverse and the Lagrange
basis at zero run in the host C++ library (`native/finite_field.cpp`);
unlike the JAX module, which falls back to Python `pow` when its native
library is missing, the port has no fallback: a failed build raises.

The default prime 2^31 - 1 keeps every product of two field elements
inside int64 before its reduction.
"""
from __future__ import annotations

import numpy as np

from .. import native

DEFAULT_PRIME = 2**31 - 1  # Mersenne prime: a*b fits in int64 before reduction


def modular_inv(a, p: int = DEFAULT_PRIME):
    """The Fermat inverse a^(p-2) mod p (reference: secagg.py:8-22): Python
    `pow` for a scalar, the native batch function for an array."""
    if isinstance(a, (int, np.integer)):
        return pow(int(a), p - 2, p)
    return native.modinv_batch(a, p)


def quantize(x: np.ndarray, q_bits: int = 16, p: int = DEFAULT_PRIME) -> np.ndarray:
    """Float -> field element: round(x * 2^q), negatives wrap to p - |.|
    (reference: my_q, secagg.py:344-349)."""
    scaled = np.round(np.asarray(x, np.float64) * (1 << q_bits)).astype(np.int64)
    return np.mod(scaled, p)


def dequantize(xq: np.ndarray, q_bits: int = 16,
               p: int = DEFAULT_PRIME) -> np.ndarray:
    """Field element -> float: values above p//2 are negative wrap-arounds
    (reference: my_q_inv, secagg.py:359-383). Sums stay exact while their
    magnitude is below p/2^(q_bits+1)."""
    xq = np.mod(np.asarray(xq, np.int64), p)
    half = p // 2
    signed = np.where(xq > half, xq - p, xq)
    return signed.astype(np.float64) / (1 << q_bits)


def _powers(points: np.ndarray, deg: int, p: int) -> np.ndarray:
    """Vandermonde rows [len(points), deg+1] mod p."""
    out = np.ones((len(points), deg + 1), dtype=np.int64)
    for j in range(1, deg + 1):
        out[:, j] = (out[:, j - 1] * points) % p
    return out


def shamir_share(secret: np.ndarray, n: int, t: int, rng: np.random.Generator,
                 p: int = DEFAULT_PRIME) -> np.ndarray:
    """Shamir t-of-n sharing of a vector secret (reference: BGW_encoding,
    secagg.py:164-178): shares [n, D], share i the degree-t polynomial at
    point i+1, its t random coefficients drawn from `rng`."""
    secret = np.mod(np.asarray(secret, np.int64), p)
    D = secret.size
    coeffs = np.concatenate(
        [secret.reshape(1, D),
         rng.integers(0, p, size=(t, D), dtype=np.int64)], axis=0
    )  # [t+1, D]
    points = np.arange(1, n + 1, dtype=np.int64)
    V = _powers(points, t, p)  # [n, t+1]
    # mod-p matmul, accumulated per degree to stay in int64
    shares = np.zeros((n, D), dtype=np.int64)
    for j in range(t + 1):
        shares = (shares + V[:, j : j + 1] * coeffs[j : j + 1]) % p
    return shares


def shamir_reconstruct(shares: np.ndarray, idxs: list[int],
                       p: int = DEFAULT_PRIME) -> np.ndarray:
    """The secret from >= t+1 shares (holders `idxs`, 0-based) by Lagrange
    at 0 (reference: BGW_decoding, secagg.py:180-212), the basis from the
    native library."""
    points = np.asarray([i + 1 for i in idxs], dtype=np.int64)
    lam = native.lagrange_at_zero(points, p)
    out = np.zeros(shares.shape[1], dtype=np.int64)
    for i in range(len(points)):
        out = (out + int(lam[i]) * shares[i]) % p
    return out


def lagrange_coeffs(alpha_s: np.ndarray, beta_s: np.ndarray,
                    p: int = DEFAULT_PRIME) -> np.ndarray:
    """U[i,j] = prod_{l!=j} (alpha_i - beta_l) / (beta_j - beta_l) mod p
    (reference: gen_Lagrange_coeffs, secagg.py:59-80)."""
    a = np.asarray(alpha_s, np.int64)
    b = np.asarray(beta_s, np.int64)
    U = np.zeros((len(a), len(b)), dtype=np.int64)
    for i in range(len(a)):
        for j in range(len(b)):
            num, den = 1, 1
            for l in range(len(b)):
                if l == j:
                    continue
                num = (num * ((int(a[i]) - int(b[l])) % p)) % p
                den = (den * ((int(b[j]) - int(b[l])) % p)) % p
            U[i, j] = (num * modular_inv(den, p)) % p
    return U


def lcc_encode(X: np.ndarray, alpha_s: np.ndarray, beta_s: np.ndarray,
               p: int = DEFAULT_PRIME) -> np.ndarray:
    """Lagrange-coded computing encode: X [K, D] chunks -> evaluations at
    the alpha points [N, D] (reference: LCC_encoding_with_points,
    secagg.py:41-48)."""
    U = lagrange_coeffs(alpha_s, beta_s, p)  # [N, K]
    N, D = U.shape[0], X.shape[1]
    out = np.zeros((N, D), dtype=np.int64)
    for j in range(U.shape[1]):
        out = (out + U[:, j : j + 1] * X[j : j + 1]) % p
    return out


def lcc_decode(f_eval: np.ndarray, eval_points: np.ndarray,
               target_points: np.ndarray, p: int = DEFAULT_PRIME) -> np.ndarray:
    """Evaluations back to values at the target points (reference:
    LCC_decoding_with_points, secagg.py:50-57)."""
    U = lagrange_coeffs(target_points, eval_points, p)
    K, D = U.shape[0], f_eval.shape[1]
    out = np.zeros((K, D), dtype=np.int64)
    for j in range(U.shape[1]):
        out = (out + U[:, j : j + 1] * f_eval[j : j + 1]) % p
    return out


def prg_mask(seed: int, size: int, p: int = DEFAULT_PRIME) -> np.ndarray:
    """A pseudo-random field vector from a shared seed: numpy's generator,
    as in the JAX package, so both packages draw the same mask."""
    return np.random.default_rng(seed % (2**63)).integers(
        0, p, size=size, dtype=np.int64
    )


# The wire leg of quantize-then-mask: lossy compression of a SecAgg upload
# happens before the mask (a masked vector is uniform in [0, p), nothing
# lossy may touch it); what the wire can do is pack the int64 field vector
# into uint32 losslessly (p < 2^32), an exact 2x that leaves the unmasked
# aggregate bitwise unchanged. comm/codec.py's `field_pack` codec calls
# these two functions.
def pack_field(xq: np.ndarray, p: int = DEFAULT_PRIME) -> np.ndarray:
    """Lossless uint32 wire packing of a field vector (values in [0, p),
    p <= 2^32). Out-of-range values mean the input is not a reduced field
    vector: refused rather than truncated."""
    if p > 2**32:
        raise ValueError(
            f"pack_field: prime {p} exceeds 32 bits — uint32 packing would "
            "truncate; use the dense int64 representation")
    a = np.asarray(xq)
    if a.dtype.kind not in "iu":
        raise ValueError(
            f"pack_field expects integer field elements; got dtype {a.dtype}")
    if a.size and (int(a.min()) < 0 or int(a.max()) >= p):
        raise ValueError(
            f"pack_field: values outside [0, {p}) — not a mod-p reduced "
            "vector (mask before packing)")
    return a.astype(np.uint32)


def unpack_field(buf: np.ndarray, p: int = DEFAULT_PRIME) -> np.ndarray:
    """Inverse of pack_field: uint32 wire form -> int64 field vector."""
    a = np.asarray(buf)
    if a.dtype != np.uint32:
        raise ValueError(
            f"unpack_field expects the uint32 wire form; got {a.dtype}")
    out = a.astype(np.int64)
    if out.size and int(out.max()) >= p:
        raise ValueError(
            f"unpack_field: values outside [0, {p}) — corrupted frame or "
            "prime mismatch between sender and receiver")
    return out
