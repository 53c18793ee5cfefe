"""Federated dataset container (a copy of `fedml_tpu/data/fed_dataset.py`).

Per-client data is one stacked array with a leading client axis, padded
to a common shard size with a sample mask, so every client's shard has the
same static shape. Aggregation weights use the true counts, so padding
never biases the mean. Arrays are host numpy; the Simulator moves them to
the device once.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class FedDataset:
    x_train: np.ndarray        # [num_clients, shard_size, ...]
    y_train: np.ndarray        # [num_clients, shard_size] int labels
    mask_train: np.ndarray     # [num_clients, shard_size] float {0,1}
    counts: np.ndarray         # [num_clients] true per-client sample counts
    x_test: np.ndarray         # [num_test, ...] global test set
    y_test: np.ndarray         # [num_test]
    num_classes: int
    client_class_stats: Optional[dict] = None
    # True when the loader fell back to the synthetic generator: accuracy
    # on it is a smoke signal, not evidence of parity
    synthetic: bool = False

    @property
    def num_clients(self) -> int:
        return self.x_train.shape[0]

    @property
    def shard_size(self) -> int:
        return self.x_train.shape[1]

    @property
    def train_num(self) -> int:
        return int(self.counts.sum())


def pack_client_shards(
    x: np.ndarray,
    y: np.ndarray,
    parts: list[np.ndarray],
    x_test: np.ndarray,
    y_test: np.ndarray,
    num_classes: int,
    shard_size: Optional[int] = None,
    pad_multiple: int = 1,
) -> FedDataset:
    """Global (x, y) + per-client index lists -> a stacked FedDataset.

    shard_size defaults to the largest client shard, rounded up to
    pad_multiple (pass the batch size so every shard splits into whole
    batches). Clients larger than shard_size keep their first shard_size
    samples.
    """
    counts = np.array([len(p) for p in parts], dtype=np.int64)
    size = shard_size or int(counts.max())
    size = max(pad_multiple, ((size + pad_multiple - 1) // pad_multiple) * pad_multiple)

    n = len(parts)
    xs = np.zeros((n, size) + x.shape[1:], dtype=x.dtype)
    # y may be per-sample labels [N] or per-position targets [N, T]
    ys = np.zeros((n, size) + y.shape[1:], dtype=np.int64)
    mask = np.zeros((n, size), dtype=np.float32)
    for i, p in enumerate(parts):
        if len(p) > size:
            p = p[:size]
            counts[i] = size
        k = len(p)
        xs[i, :k] = x[p]
        ys[i, :k] = y[p]
        mask[i, :k] = 1.0
    return FedDataset(
        x_train=xs, y_train=ys, mask_train=mask, counts=counts,
        x_test=x_test, y_test=y_test, num_classes=num_classes,
    )
