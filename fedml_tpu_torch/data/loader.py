"""Dataset hub: name -> FedDataset (port of `fedml_tpu/data/loader.py`).

Real data is read from `data_args.data_cache_dir` when it is there (the
CIFAR python pickle batches, a pre-exported `<name>.npz`), sklearn's
bundled digits set is real data available offline, and any other
classification set falls back to a shape-faithful synthetic Gaussian
mixture. numpy only: shards, partitions and labels are bitwise those of
the JAX module for the same config.

Not ported yet (ROADMAP 'Port queue' item 5): the LEAF JSON, TFF h5 and
folder / CSV readers, and the token, segmentation and multi-label
synthetic tasks. Asking for a dataset that only they serve, or whose LEAF
files are on disk, raises NotImplementedError.
"""
from __future__ import annotations

import logging
import os
from pathlib import Path

import numpy as np

from ..config import Config
from ..core.registry import DATASETS
from .fed_dataset import FedDataset, pack_client_shards
from .partition import partition, record_data_stats

# (shape, num_classes) per known dataset name
DATASET_SHAPES = {
    "mnist": ((28, 28, 1), 10),
    "femnist": ((28, 28, 1), 62),
    "fashionmnist": ((28, 28, 1), 10),
    "cifar10": ((32, 32, 3), 10),
    "cifar100": ((32, 32, 3), 100),
    "cinic10": ((32, 32, 3), 10),
    "synthetic": ((60,), 10),
    "digits": ((8, 8, 1), 10),
    "shakespeare": ((80,), 81),
    "fed_cifar100": ((32, 32, 3), 100),
    "fed_shakespeare": ((80,), 90),
    "stackoverflow_nwp": ((20,), 10004),
    "stackoverflow_lr": ((10000,), 500),
    "ILSVRC2012": ((64, 64, 3), 1000),
    "imagenet": ((64, 64, 3), 1000),
    "gld23k": ((64, 64, 3), 203),
    "gld160k": ((64, 64, 3), 2028),
    "SUSY": ((18,), 2),
    "room_occupancy": ((5,), 2),
    "lending_club": ((90,), 2),
    "nus_wide": ((634,), 5),
    "pascal_voc": ((32, 32, 3), 21),
    "cityscapes": ((32, 32, 3), 19),
    "coco_seg": ((32, 32, 3), 81),
}

_LATER = ("is not ported yet (ROADMAP 'Port queue' item 5, the remaining "
          "data readers and tasks)")
# datasets only an unported reader or an unported synthetic task serves
_UNPORTED = {
    "shakespeare": "the LEAF shakespeare reader and the token tasks",
    "fed_shakespeare": "the TFF h5 reader and the token tasks",
    "stackoverflow_nwp": "the TFF h5 reader and the token tasks",
    "stackoverflow_lr": "the TFF h5 reader and the multi-label task",
    "fed_cifar100": "the TFF h5 reader",
    "ILSVRC2012": "the folder-image reader",
    "imagenet": "the folder-image reader",
    "cinic10": "the folder-image reader",
    "gld23k": "the landmarks CSV reader",
    "gld160k": "the landmarks CSV reader",
    "SUSY": "the tabular CSV reader",
    "room_occupancy": "the tabular CSV reader",
    "lending_club": "the tabular CSV reader",
    "nus_wide": "the tabular CSV reader",
    "pascal_voc": "the segmentation task",
    "cityscapes": "the segmentation task",
    "coco_seg": "the segmentation task",
}
# LEAF JSON directories the JAX loader reads before its fallbacks
_LEAF_DIRS = {"mnist": "MNIST", "femnist": "femnist"}


def synthetic_classification(
    num_samples: int,
    input_shape: tuple,
    num_classes: int,
    seed: int = 0,
    test_frac: float = 0.2,
):
    """Gaussian-mixture classification data: one Gaussian mean per class,
    labels recoverable by a linear model, so accuracy above 1/num_classes
    is a real convergence signal."""
    rng = np.random.RandomState(seed)
    dim = int(np.prod(input_shape))
    means = rng.randn(num_classes, dim).astype(np.float32) * 1.5
    y = rng.randint(0, num_classes, size=num_samples)
    x = means[y] + rng.randn(num_samples, dim).astype(np.float32)
    x = x.reshape((num_samples,) + tuple(input_shape))
    n_test = int(num_samples * test_frac)
    return (x[n_test:], y[n_test:]), (x[:n_test], y[:n_test])


def _build_from_arrays(x, y, x_test, y_test, num_classes,
                       cfg: Config) -> FedDataset:
    t, d = cfg.train_args, cfg.data_args
    # the Dirichlet partitioner needs one class label per sample: sequence
    # targets [N, T] partition by their last position
    part_labels = y if np.ndim(y) == 1 else np.asarray(y)[:, -1]
    parts = partition(
        part_labels, t.client_num_in_total, d.partition_method,
        d.partition_alpha, seed=cfg.common_args.random_seed,
    )
    ds = pack_client_shards(
        x, y, parts, x_test, y_test, num_classes, pad_multiple=t.batch_size
    )
    ds.client_class_stats = record_data_stats(part_labels, parts)
    return ds


def _synthetic_for(name: str, cfg: Config) -> FedDataset:
    if name in _UNPORTED:
        raise NotImplementedError(f"dataset {name!r} ({_UNPORTED[name]}) "
                                  f"{_LATER}")
    shape, num_classes = DATASET_SHAPES.get(name, DATASET_SHAPES["synthetic"])
    per_client = int(cfg.data_args.extra.get("synthetic_samples_per_client", 120))
    n = max(cfg.train_args.client_num_in_total * per_client, 500)
    (x, y), (xt, yt) = synthetic_classification(
        int(n * 1.25), shape, num_classes, seed=cfg.common_args.random_seed
    )
    ds = _build_from_arrays(x, y, xt, yt, num_classes, cfg)
    ds.synthetic = True
    return ds


def _digits(cfg: Config) -> FedDataset:
    """sklearn's bundled handwritten digits (1,797 8x8 grayscale images,
    10 classes): real data available offline. Deterministic 80/20 split.
    sklearn is imported here, so the package imports without it."""
    from sklearn.datasets import load_digits

    d = load_digits()
    x = (d.data.astype(np.float32) / 16.0).reshape(-1, 8, 8, 1)
    y = d.target.astype(np.int64)
    rng = np.random.RandomState(cfg.common_args.random_seed)
    order = rng.permutation(len(y))
    x, y = x[order], y[order]
    n_test = len(y) // 5
    return _build_from_arrays(x[n_test:], y[n_test:], x[:n_test], y[:n_test], 10, cfg)


def _cifar_batches(name: str, cache_dir: Path, cfg: Config) -> FedDataset | None:
    """The CIFAR python pickle batches (cifar-10-batches-py/data_batch_* +
    test_batch, or cifar-100-python/{train,test}), NCHW uint8 -> NHWC
    floats in [0, 1]."""
    import pickle

    if name == "cifar10":
        d = cache_dir / "cifar-10-batches-py"
        train_files = [d / f"data_batch_{i}" for i in range(1, 6)]
        test_files = [d / "test_batch"]
        label_key = b"labels"
    else:  # cifar100
        d = cache_dir / "cifar-100-python"
        train_files = [d / "train"]
        test_files = [d / "test"]
        label_key = b"fine_labels"
    if not all(f.is_file() for f in train_files + test_files):
        return None

    def read(files):
        xs, ys = [], []
        for f in files:
            with open(f, "rb") as fh:
                blob = pickle.load(fh, encoding="bytes")
            x = np.asarray(blob[b"data"], np.uint8).reshape(-1, 3, 32, 32)
            xs.append(x.transpose(0, 2, 3, 1))   # NCHW -> NHWC
            ys.append(np.asarray(blob[label_key], np.int64))
        return (np.concatenate(xs).astype(np.float32) / 255.0,
                np.concatenate(ys))

    x, y = read(train_files)
    xt, yt = read(test_files)
    return _build_from_arrays(x, y, xt, yt,
                              10 if name == "cifar10" else 100, cfg)


def _npz_dataset(name: str, cache_dir: Path, cfg: Config) -> FedDataset | None:
    """A pre-exported `<name>.npz` with x_train/y_train/x_test/y_test
    (uint8 images are scaled to [0, 1])."""
    f = cache_dir / f"{name}.npz"
    if not f.is_file():
        return None
    blob = np.load(f)
    shape, num_classes = DATASET_SHAPES.get(name, (None, int(blob["y_train"].max()) + 1))

    def as_x(a):
        scale = 255.0 if a.dtype == np.uint8 else 1.0
        return a.astype(np.float32) / scale

    return _build_from_arrays(
        as_x(blob["x_train"]), blob["y_train"].astype(np.int64),
        as_x(blob["x_test"]), blob["y_test"].astype(np.int64),
        num_classes if isinstance(num_classes, int) else int(blob["y_train"].max()) + 1,
        cfg,
    )


def _make_named_loader(name: str):
    def loader(cfg: Config) -> FedDataset:
        cache = Path(os.path.expanduser(cfg.data_args.data_cache_dir))
        if name == "digits":
            return _digits(cfg)
        if name in _UNPORTED:
            raise NotImplementedError(
                f"dataset {name!r} ({_UNPORTED[name]}) {_LATER}")
        if name in _LEAF_DIRS:
            leaf = cache / _LEAF_DIRS[name]
            if (leaf / "train").is_dir() and (leaf / "test").is_dir():
                raise NotImplementedError(
                    f"the LEAF JSON reader for {name!r} (files under "
                    f"{leaf}) {_LATER}")
        if name in ("cifar10", "cifar100"):
            ds = _cifar_batches(name, cache, cfg)
            if ds is not None:
                return ds
        ds = _npz_dataset(name, cache, cfg)
        if ds is not None:
            return ds
        logging.getLogger(__name__).warning(
            "dataset %r not found under %s — falling back to SYNTHETIC data "
            "(shape-faithful Gaussians). Export real data to <cache>/%s.npz "
            "to run on it.", name, cache, name,
        )
        return _synthetic_for(name, cfg)

    return loader


for _name in DATASET_SHAPES:
    DATASETS.register(_name)(_make_named_loader(_name))


def load(cfg: Config) -> FedDataset:
    """Dataset by `cfg.data_args.dataset`; an unknown name gets synthetic
    data of the default shape."""
    name = cfg.data_args.dataset.lower()
    if name in DATASETS:
        return DATASETS.get(name)(cfg)
    return _synthetic_for(name, cfg)
