"""Poisoned / edge-case dataset construction (a numpy copy of
`fedml_tpu/data/poison.py`, held to it bitwise).

(reference: data/edge_case_examples/ ships curated out-of-distribution
images (southwest airplanes for cifar, ARDIS '7's for mnist) consumed by
core/security/attack/edge_case_backdoor_attack.py ("Attack of the Tails",
Wang et al. 2020, arXiv 2007.05084); data/data_loader.py:582 loads
poisoned variants. No curated OOD files exist in an air-gapped image, so
this module derives the edge-case pool from the dataset itself: the
lowest-density tail of a source class — samples farthest from their class
centroid — which is exactly the property the paper exploits (backdoors
hiding where clean data has no mass).)

All functions are host-side numpy on the stacked FedDataset arrays; the
poisoned shards upload to the device like any other data.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np


def edge_case_pool(x: np.ndarray, y: np.ndarray, source_class: int,
                   tail_frac: float = 0.1) -> np.ndarray:
    """Select the `tail_frac` of `source_class` samples farthest from the
    class centroid — the low-density 'edge' of the class manifold."""
    idx = np.flatnonzero(y == source_class)
    if idx.size == 0:
        raise ValueError(f"no samples of source class {source_class}")
    flat = x[idx].reshape(idx.size, -1).astype(np.float64)
    center = flat.mean(axis=0)
    d = np.linalg.norm(flat - center, axis=1)
    k = max(1, int(round(idx.size * tail_frac)))
    return x[idx[np.argsort(d)[-k:]]]


def replace_with_edge_cases(x_shard: np.ndarray, y_shard: np.ndarray,
                            mask: np.ndarray, pool: np.ndarray,
                            target_class: int, frac: float,
                            seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Swap `frac` of a client's REAL samples (mask==1) for edge-case pool
    samples labeled `target_class` (reference: edge_case_backdoor_attack.py
    poison_data replaces backdoor_sample_percentage of each batch)."""
    rng = np.random.RandomState(seed)
    real = np.flatnonzero(mask > 0)
    k = min(int(round(real.size * frac)), real.size)
    if k == 0 or pool.size == 0:
        return x_shard, y_shard
    victims = rng.choice(real, size=k, replace=False)
    donors = rng.randint(0, pool.shape[0], size=k)
    x_out, y_out = x_shard.copy(), y_shard.copy()
    x_out[victims] = pool[donors]
    y_out[victims] = target_class
    return x_out, y_out


def backdoor_eval_set(x_test: np.ndarray, y_test: np.ndarray,
                      trigger: Callable[[np.ndarray], np.ndarray],
                      target_class: int,
                      exclude_class: Optional[int] = None):
    """Build the attack-success evaluation set: triggered test inputs with
    the attacker's target label (accuracy on it = attack success rate).
    Samples already of the target class are excluded — they would inflate
    the success rate for free."""
    keep = y_test != target_class
    if exclude_class is not None:
        keep &= y_test != exclude_class
    x = trigger(x_test[keep].copy())
    y = np.full(int(keep.sum()), target_class, dtype=y_test.dtype)
    return x, y


def pixel_trigger(size: int = 3, value: float = 1.0):
    """Corner-patch trigger (the classic pixel-pattern backdoor used by
    security/attacks.backdoor_trigger; exposed here for eval sets)."""
    def apply(x: np.ndarray) -> np.ndarray:
        x = x.copy()
        x[..., :size, :size, :] = value
        return x

    return apply
