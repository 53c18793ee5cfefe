"""Non-IID client partitioning (a copy of `fedml_tpu/data/partition.py`).

IID splitting, and the Dirichlet (LDA) partitioner: each class's indices
are split across clients with proportions drawn from Dir(alpha), a client
already at N / num_clients samples gets no more, and the draw repeats
until every client has at least `min_size_floor` samples. numpy only, and
bitwise equal to the JAX package's module for the same seed.
"""
from __future__ import annotations

import numpy as np


def partition_iid(labels: np.ndarray, num_clients: int, seed: int = 0) -> list[np.ndarray]:
    rng = np.random.RandomState(seed)
    idx = rng.permutation(len(labels))
    return [np.sort(part) for part in np.array_split(idx, num_clients)]


def partition_dirichlet(
    labels: np.ndarray,
    num_clients: int,
    alpha: float = 0.5,
    seed: int = 0,
    min_size_floor: int = 1,
) -> list[np.ndarray]:
    """LDA partition with the capacity-balancing retry loop (module
    docstring)."""
    rng = np.random.RandomState(seed)
    n = len(labels)
    classes = np.unique(labels)
    min_size = -1
    while min_size < min_size_floor:
        idx_batch: list[list[int]] = [[] for _ in range(num_clients)]
        for k in classes:
            idx_k = np.where(labels == k)[0]
            rng.shuffle(idx_k)
            p = rng.dirichlet(np.repeat(alpha, num_clients))
            # zero the proportions of clients already at capacity
            p = np.array(
                [pi * (len(idx_j) < n / num_clients) for pi, idx_j in zip(p, idx_batch)]
            )
            p = p / p.sum()
            cuts = (np.cumsum(p) * len(idx_k)).astype(int)[:-1]
            for j, part in enumerate(np.split(idx_k, cuts)):
                idx_batch[j].extend(part.tolist())
        min_size = min(len(b) for b in idx_batch)
    return [np.sort(np.array(b, dtype=np.int64)) for b in idx_batch]


def partition(
    labels: np.ndarray, num_clients: int, method: str, alpha: float, seed: int = 0
) -> list[np.ndarray]:
    if method in ("homo", "iid"):
        return partition_iid(labels, num_clients, seed)
    if method in ("hetero", "dirichlet", "lda", "noniid"):
        return partition_dirichlet(labels, num_clients, alpha, seed)
    raise ValueError(f"unknown partition_method {method!r}")


def record_data_stats(labels: np.ndarray, parts: list[np.ndarray]) -> dict:
    """Per-client class histograms {client: {class: count}}."""
    classes = np.unique(labels)
    return {
        cid: {int(c): int((labels[p] == c).sum()) for c in classes if (labels[p] == c).any()}
        for cid, p in enumerate(parts)
    }
