"""LightSecAgg: MDS-coded mask sharing, one-shot dropout tolerance (port
of `fedml_tpu/mpc/lightsecagg.py`; So et al. 2021; reference:
core/mpc/lightsecagg.py — mask_encoding :97-124,
compute_aggregate_encoded_mask :126-132).

1. client i draws mask z_i, splits it into K chunks, pads with T random
   chunks, LCC-encodes to N shares and sends share j to client j.
2. client i uploads x_i + z_i (quantized, mod p).
3. each surviving client j sends the server sum_i(encoded share_ij) over
   the surviving set U; from any K+T of these the server LCC-decodes
   sum_{i in U} z_i and subtracts it.

Against SecAgg, dropout recovery costs one decode instead of a Shamir
reconstruction per client. No manager calls it: it is a library, held to
the JAX module bitwise by the tests.
"""
from __future__ import annotations

import numpy as np

from .finite import DEFAULT_PRIME, dequantize, lcc_decode, lcc_encode, quantize


def _chunk(z: np.ndarray, K: int) -> np.ndarray:
    """Pad to a K multiple and reshape to [K, D/K]."""
    d = z.size
    per = -(-d // K)
    padded = np.zeros(K * per, np.int64)
    padded[:d] = z
    return padded.reshape(K, per)


def mask_encoding(d: int, N: int, K: int, T: int, rng: np.random.Generator,
                  p: int = DEFAULT_PRIME) -> tuple[np.ndarray, np.ndarray]:
    """Draw mask z [d] and produce its N encoded shares [N, ceil(d/K)]
    (reference: mask_encoding, lightsecagg.py:97-124: [z chunks; T random]
    LCC-encoded at N points)."""
    z = rng.integers(0, p, size=d, dtype=np.int64)
    chunks = _chunk(z, K)                                     # [K, per]
    noise = rng.integers(0, p, size=(T, chunks.shape[1]), dtype=np.int64)
    X = np.concatenate([chunks, noise], axis=0)               # [K+T, per]
    alpha = np.arange(1, N + 1, dtype=np.int64)               # eval points
    beta = np.arange(N + 1, N + 1 + K + T, dtype=np.int64)    # interp points
    shares = lcc_encode(X, alpha, beta, p)                    # [N, per]
    return z, shares


def aggregate_encoded_masks(shares_held: list[np.ndarray],
                            p: int = DEFAULT_PRIME) -> np.ndarray:
    """Client j sums the shares it holds over the surviving set (reference:
    compute_aggregate_encoded_mask, lightsecagg.py:126-132)."""
    out = np.zeros_like(shares_held[0])
    for s in shares_held:
        out = (out + s) % p
    return out


def decode_aggregate_mask(agg_shares: dict[int, np.ndarray], N: int, K: int,
                          T: int, d: int, p: int = DEFAULT_PRIME) -> np.ndarray:
    """From any K+T clients' aggregate-encoded masks, decode sum(z_i)
    (reference: the server-side decode in lsa_fedml_server_manager)."""
    idxs = sorted(agg_shares)[: K + T]
    if len(idxs) < K + T:
        raise ValueError(f"need {K + T} surviving shares, got {len(agg_shares)}")
    f_eval = np.stack([agg_shares[j] for j in idxs])          # [K+T, per]
    eval_points = np.asarray([j + 1 for j in idxs], np.int64)
    beta = np.arange(N + 1, N + 1 + K + T, dtype=np.int64)
    decoded = lcc_decode(f_eval, eval_points, beta[:K + T], p)  # values at beta
    return decoded[:K].reshape(-1)[:d]


def lightsecagg_roundtrip(vectors: list[np.ndarray], K: int = 2, T: int = 1,
                          drop: list[int] | None = None, q_bits: int = 16,
                          seed: int = 0, p: int = DEFAULT_PRIME) -> np.ndarray:
    """End-to-end in-process protocol run; returns sum over surviving clients
    computed only from masked uploads + encoded mask shares."""
    n, d = len(vectors), vectors[0].size
    drop = set(drop or [])
    survivors = [i for i in range(n) if i not in drop]
    if len(survivors) < K + T:
        raise ValueError("too many dropouts for (K, T)")

    rngs = [np.random.default_rng(seed + i) for i in range(n)]
    masks, shares = {}, {}
    for i in range(n):
        masks[i], shares[i] = mask_encoding(d, n, K, T, rngs[i], p)

    # masked uploads from survivors
    agg = np.zeros(d, np.int64)
    for i in survivors:
        y = (quantize(vectors[i], q_bits, p) + masks[i]) % p
        agg = (agg + y) % p

    # each survivor j sends sum over survivors of share_ij
    agg_shares = {
        j: aggregate_encoded_masks([shares[i][j] for i in survivors], p)
        for j in survivors
    }
    z_sum = decode_aggregate_mask(agg_shares, n, K, T, d, p)
    agg = (agg - z_sum) % p
    return dequantize(agg, q_bits, p)
