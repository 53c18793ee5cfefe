"""SecAgg: pairwise-mask secure aggregation with dropout recovery (port
of `fedml_tpu/mpc/secagg.py`; Bonawitz et al. 2017; reference:
core/mpc/secagg.py — key agreement :329-342, masking :83-116).

1. each client i has a DH keypair; pairwise seed s_ij = agree(sk_i, pk_j).
2. client i uploads  y_i = x_i + b_i + sum_{j>i} PRG(s_ij) - sum_{j<i} PRG(s_ji)
   (all in the field); pairwise masks cancel in the sum.
3. the self-mask seed b_i is Shamir-shared to all clients; if i drops out,
   t+1 survivors reconstruct its sk and so its pairwise seeds; if i
   survives, they reconstruct b_i and the server subtracts it.

Host numpy, as in the JAX package, with the same generator calls in the
same order: keys, shares, masks and aggregates are bitwise the JAX
module's from the same seeds. The masked vectors are int64 arrays that
ride the comm layer.

SECURITY SCOPE: the protocol's structure for simulation and testing, not
production cryptography. Key agreement is DH over the 31-bit field prime
with generator 5 and the masks come from a non-cryptographic PRG; a real
deployment swaps `agree` / `prg_mask` for X25519 and a keyed PRF behind the
same interface, and the message flow and dropout recovery stay as they are.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np

from .finite import (
    DEFAULT_PRIME, dequantize, prg_mask, quantize, shamir_reconstruct,
    shamir_share,
)

_G = 5  # public DH generator (reference: my_pk_gen uses g**sk mod p)


def premask_sparsify(x: np.ndarray, ratio: float) -> np.ndarray:
    """The compression leg of quantize-then-mask: keep the top-k |values|
    of the float vector and zero the rest, before quantize and mask.
    Masked vectors are uniformly random field elements, so lossy
    compression can only live on this side of the mask; the kept
    coordinates then ride the shared field scale (finite.quantize(q_bits))
    unchanged, so the masked compressed aggregate unmasks to exactly the
    plain quantize-sum-dequantize of the same sparsified vectors."""
    flat = np.asarray(x, np.float64).ravel()
    if not 0.0 < float(ratio) <= 1.0:
        raise ValueError(f"premask_sparsify ratio must be in (0, 1]; got "
                         f"{ratio!r}")
    if flat.size == 0:
        return flat.reshape(np.shape(x))
    if not np.all(np.isfinite(flat)):
        raise ValueError("premask_sparsify: non-finite values in the update")
    k = max(1, int(flat.size * float(ratio)))
    if k >= flat.size:
        return flat.reshape(np.shape(x))
    idx = np.argpartition(np.abs(flat), -k)[-k:]
    out = np.zeros_like(flat)
    out[idx] = flat[idx]
    return out.reshape(np.shape(x))


def derive_round_key(seed: int, round_salt: int, label: bytes = b"mask") -> int:
    """Per-round PRG key: SHA-256(label || seed || salt) truncated to 62 bits.

    Additive salting (seed + salt) lets distinct (seed, salt) pairs collide
    and produce related keystreams across rounds; hashing makes the per-round
    key derivation a drop-in for a production PRF substitution (HKDF would
    slot in here unchanged)."""
    h = hashlib.sha256(
        label + int(seed).to_bytes(16, "little", signed=False)
        + int(round_salt).to_bytes(8, "little", signed=True)
    ).digest()
    return int.from_bytes(h[:8], "little") >> 2


def _share_pad(pair_secret: int, owner: int, holder: int, field: str,
               size: int, p: int = DEFAULT_PRIME) -> np.ndarray:
    """Deterministic field-element pad for encrypting one routed share
    payload: both endpoints of the (owner, holder) pair derive it from their
    DH secret; the routing server cannot. `field` (e.g. "b" vs "sk")
    domain-separates the keystream — reusing one pad for both payloads would
    be a two-time pad leaking their difference (shares of b_i - sk_i) to
    the router."""
    key = derive_round_key(pair_secret, owner * 0x10001 + holder,
                           label=b"share-enc:" + field.encode())
    return prg_mask(key, size, p)


def encrypt_share(share: np.ndarray, pair_secret: int, owner: int,
                  holder: int, field: str, p: int = DEFAULT_PRIME
                  ) -> np.ndarray:
    """Encrypt a Shamir share (field elements) to its holder so the routing
    server never sees plaintext shares (a server holding t+1 plaintext sk
    shares could reconstruct any client's masks and unmask individual
    updates — the aggregator is SecAgg's primary adversary)."""
    s = np.mod(np.asarray(share, np.int64), p)
    return (s + _share_pad(pair_secret, owner, holder, field, s.size, p)) % p


def decrypt_share(cipher: np.ndarray, pair_secret: int, owner: int,
                  holder: int, field: str, p: int = DEFAULT_PRIME
                  ) -> np.ndarray:
    c = np.mod(np.asarray(cipher, np.int64), p)
    return (c - _share_pad(pair_secret, owner, holder, field, c.size, p)) % p


@dataclasses.dataclass
class SecAggClient:
    """One participant's key material + masking logic."""
    idx: int
    num_clients: int
    threshold: int                      # Shamir t (t+1 reconstructors needed)
    p: int = DEFAULT_PRIME
    q_bits: int = 16
    seed: Optional[int] = None

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.sk = int(rng.integers(2, self.p - 2))
        self.pk = pow(_G, self.sk, self.p)
        # the self-mask seed is Shamir-shared, i.e. reconstructed mod p —
        # it must live in the field or reconstruction returns seed mod p
        self.self_seed = int(rng.integers(0, self.p))
        self._rng = rng

    # --- round 0: keys
    def public_key(self) -> int:
        return self.pk

    def agree(self, peer_pk: int) -> int:
        """DH shared secret -> PRG seed (reference: my_key_agreement,
        secagg.py:337-342)."""
        return pow(peer_pk, self.sk, self.p) % (2**62)

    # --- round 1: share the self-mask seed (and sk, for dropout recovery)
    def share_self_seed(self) -> np.ndarray:
        """Shamir shares [n, 1] of the self-mask seed, one per client."""
        return shamir_share(
            np.asarray([self.self_seed], np.int64),
            self.num_clients, self.threshold, self._rng, self.p,
        )

    def share_sk(self) -> np.ndarray:
        """Shamir shares [n, 1] of the DH secret key. If this client drops
        mid-round, t+1 survivors' shares let the server reconstruct sk and
        derive the pairwise seeds to strip (reference:
        sa_fedml_server_manager.py's ss_others flow)."""
        return shamir_share(
            np.asarray([self.sk], np.int64),
            self.num_clients, self.threshold, self._rng, self.p,
        )

    # --- round 2: masked input
    def mask(self, x: np.ndarray, peer_pks: dict[int, int],
             round_salt: int = 0) -> np.ndarray:
        """y_i = quantize(x_i) + PRG(H(b_i,salt)) + sum_{j>i} PRG(H(s_ij,salt))
        - sum_{j<i}. `round_salt` rotates every mask per round (hash-derived
        key, see derive_round_key) so the same key material serves many
        rounds without mask reuse.

        Validates the field magnitude budget before masking: the unmasked
        SUM over all n clients must stay below p/2 after the 2^q_bits
        quantization scale, or it silently wraps mod p and corrupts the
        aggregate. Raises with remediation instead of wrapping."""
        x = np.asarray(x, np.float64)
        max_abs = float(np.max(np.abs(x))) if x.size else 0.0
        budget = (self.p / 2.0) / (1 << self.q_bits)
        if max_abs * self.num_clients >= budget:
            raise ValueError(
                f"secagg field overflow: max|x|={max_abs:.4g} x n="
                f"{self.num_clients} clients exceeds the aggregate budget "
                f"p/2^(q_bits+1)={budget:.4g}. Lower q_bits, or send "
                f"normalized weights (n_i/n_total) instead of raw sample "
                f"counts (SecAggClientManager does this when weight_norm "
                f"is set).")
        D = x.size
        y = quantize(x, self.q_bits, self.p)
        key = derive_round_key(self.self_seed, round_salt)
        y = (y + prg_mask(key, D, self.p)) % self.p
        for j, pk in peer_pks.items():
            if j == self.idx:
                continue
            pair = prg_mask(derive_round_key(self.agree(pk), round_salt),
                            D, self.p)
            y = (y + pair) % self.p if j > self.idx else (y - pair) % self.p
        return y


class SecAggServer:
    """Aggregates masked inputs; recovers from dropouts with survivor shares
    (reference flow: cross_silo/secagg/sa_fedml_server_manager.py)."""

    def __init__(self, num_clients: int, threshold: int, dim: int,
                 p: int = DEFAULT_PRIME, q_bits: int = 16):
        self.n, self.t, self.D = num_clients, threshold, dim
        self.p, self.q_bits = p, q_bits

    def aggregate(
        self,
        masked: dict[int, np.ndarray],             # surviving i -> y_i
        self_seed_shares: dict[int, dict[int, np.ndarray]],
        # self_seed_shares[holder][owner] = holder's share of owner's b seed
        pairwise_seeds_of_dropped: dict[int, dict[int, int]],
        # dropped j -> {peer i: s_ij} reconstructed by survivors
        weights: Optional[np.ndarray] = None,
        round_salt: int = 0,
    ) -> np.ndarray:
        """Sum surviving masked vectors, strip surviving clients' self-masks
        (reconstructed from shares) and dropped clients' pairwise masks.
        `round_salt` must match the salt the clients masked with."""
        survivors = sorted(masked)
        agg = np.zeros(self.D, np.int64)
        for i in survivors:
            agg = (agg + masked[i]) % self.p

        # subtract each survivor's self-mask b_i
        for i in survivors:
            share_rows = []
            holders = []
            for h in survivors:
                if i in self_seed_shares.get(h, {}):
                    holders.append(h)
                    share_rows.append(self_seed_shares[h][i])
                if len(holders) == self.t + 1:
                    break
            if len(holders) < self.t + 1:
                raise ValueError(f"not enough shares to unmask client {i}")
            seed = int(shamir_reconstruct(
                np.stack([r.reshape(-1) for r in share_rows]), holders, self.p
            )[0])
            agg = (agg - prg_mask(derive_round_key(seed, round_salt),
                                  self.D, self.p)) % self.p

        # strip pairwise masks involving dropped clients
        for j, seeds in pairwise_seeds_of_dropped.items():
            for i in survivors:
                if i not in seeds:
                    continue
                pair = prg_mask(derive_round_key(seeds[i], round_salt),
                                self.D, self.p)
                # client i applied +pair if j > i else -pair; remove it
                agg = (agg - pair) % self.p if j > i else (agg + pair) % self.p

        return dequantize(agg, self.q_bits, self.p)

    @staticmethod
    def reconstruct_sk(sk_shares: dict[int, np.ndarray],
                       p: int = DEFAULT_PRIME) -> int:
        """Reconstruct a dropped client's DH secret from t+1 survivors'
        shares ({holder: share})."""
        holders = sorted(sk_shares)
        return int(shamir_reconstruct(
            np.stack([np.asarray(sk_shares[h]).reshape(-1) for h in holders]),
            holders, p)[0])

    @staticmethod
    def pairwise_seed(sk_j: int, pk_i: int, p: int = DEFAULT_PRIME) -> int:
        """s_ij from a reconstructed sk_j and a survivor's public key —
        the same value SecAggClient.agree computes on the other side."""
        return pow(pk_i, sk_j, p) % (2 ** 62)


def secagg_roundtrip(vectors: list[np.ndarray], threshold: Optional[int] = None,
                     drop: Optional[list[int]] = None, seed: int = 0) -> np.ndarray:
    """Reference-style end-to-end run (the shape of
    cross_silo/secagg/*'s message exchange, in-process): returns the sum of
    the surviving clients' vectors, computed only from masked data."""
    n, D = len(vectors), vectors[0].size
    t = threshold if threshold is not None else max(1, n // 2)
    drop = set(drop or [])
    clients = [SecAggClient(i, n, t, seed=seed + i) for i in range(n)]
    pks = {i: c.public_key() for i, c in enumerate(clients)}

    shares = {}  # holder -> owner -> share
    all_shares = {i: c.share_self_seed() for i, c in enumerate(clients)}
    for holder in range(n):
        if holder in drop:
            continue
        shares[holder] = {owner: all_shares[owner][holder]
                          for owner in range(n) if owner not in drop}

    masked = {i: c.mask(vectors[i], pks)
              for i, c in enumerate(clients) if i not in drop}

    # survivors reconstruct the *pairwise* seeds of dropped clients (in the
    # real protocol these come from shares of sk_j; the math is identical)
    pair_seeds = {j: {i: clients[j].agree(pks[i])
                      for i in range(n) if i not in drop}
                  for j in drop}

    server = SecAggServer(n, t, D)
    return server.aggregate(masked, shares, pair_seeds)
