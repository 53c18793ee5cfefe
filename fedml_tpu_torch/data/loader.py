"""Dataset hub: name -> FedDataset (port of `fedml_tpu/data/loader.py`).

Real data is read from `data_args.data_cache_dir` when it is there: the
LEAF JSON directories (MNIST, femnist, shakespeare), the CIFAR python
pickle batches, the TFF h5 sets (`tff_h5.py`), the folder-image, landmarks
CSV and tabular CSV sets (`folder_csv.py`) and a pre-exported
`<name>.npz`; sklearn's bundled digits set is real data available
offline. Any other set falls back to a shape-faithful synthetic task: a
Gaussian mixture for classification, next-token sequences for the token
tasks, one class-coloured square an image for segmentation, and sparse
bags of words for stackoverflow_lr's tags. numpy only: shards,
partitions, labels and vocabularies are bitwise those of the JAX module
for the same config.
"""
from __future__ import annotations

import json
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

# datasets served by the folder-image / landmarks-CSV / tabular-CSV
# readers (data/folder_csv.py)
_FOLDER_IMAGE = {"ILSVRC2012", "imagenet", "cinic10"}
_LANDMARKS = {"gld23k", "gld160k"}
_TABULAR = {"SUSY", "room_occupancy", "lending_club", "nus_wide"}
# token (next-token prediction) and dense-prediction synthetic tasks
_TOKEN_TASKS = {"shakespeare", "fed_shakespeare", "stackoverflow_nwp"}
_SEG_TASKS = {"pascal_voc", "cityscapes", "coco_seg"}


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


def _build_from_arrays(x, y, x_test, y_test, num_classes, cfg: Config,
                       part_labels=None) -> FedDataset:
    t, d = cfg.train_args, cfg.data_args
    # the Dirichlet partitioner needs one class label per sample: sequence
    # targets [N, T] partition by their last position; dense targets
    # ([N, H, W] masks) pass `part_labels`
    if part_labels is None:
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
    shape, num_classes = DATASET_SHAPES.get(name, DATASET_SHAPES["synthetic"])
    per_client = int(cfg.data_args.extra.get("synthetic_samples_per_client", 120))
    n = max(cfg.train_args.client_num_in_total * per_client, 500)
    if name == "stackoverflow_lr":
        from .tff_h5 import synthetic_multilabel

        # the h5 reader's width keys, when given, size the fallback too
        # (the JAX fallback is always 128 words / 16 tags; ROADMAP C.11)
        extra = cfg.data_args.extra
        return synthetic_multilabel(cfg, int(extra.get("so_vocab_size", 128)),
                                    int(extra.get("so_tag_size", 16)))
    if name in _TOKEN_TASKS:
        # next token = the wrap-around successor, targets per position;
        # tokens live in [1, V): id 0 is the pad the nwp objective
        # excludes
        rng = np.random.RandomState(cfg.common_args.random_seed)
        total = int(n * 1.25)
        starts = rng.randint(1, num_classes, size=(total, 1))
        x = (starts - 1 + np.arange(shape[0])) % (num_classes - 1) + 1
        y = x % (num_classes - 1) + 1
        n_test = int(total * 0.2)
        ds = _build_from_arrays(
            x[n_test:].astype(np.int64), y[n_test:].astype(np.int64),
            x[:n_test].astype(np.int64), y[:n_test].astype(np.int64),
            num_classes, cfg)
        ds.synthetic = True
        return ds
    if name in _SEG_TASKS:
        # one class-coloured square an image (its class readable from its
        # brightness) on background class 0; a sample partitions by its
        # square's class
        rng = np.random.RandomState(cfg.common_args.random_seed)
        total = int(n * 1.25)
        H, W, C = shape
        x = 0.1 * rng.randn(total, H, W, C).astype(np.float32)
        y = np.zeros((total, H, W), np.int64)
        cls = rng.randint(1, num_classes, size=total)
        h0 = rng.randint(1, H // 2, size=total)
        w0 = rng.randint(1, W // 2, size=total)
        sz = rng.randint(H // 4, H // 2, size=total)
        for i in range(total):
            hs, ws = slice(h0[i], h0[i] + sz[i]), slice(w0[i], w0[i] + sz[i])
            x[i, hs, ws, :] += 0.5 + 1.5 * cls[i] / num_classes
            y[i, hs, ws] = cls[i]
        n_test = int(total * 0.2)
        ds = _build_from_arrays(
            x[n_test:], y[n_test:], x[:n_test], y[:n_test], num_classes,
            cfg, part_labels=cls[n_test:])
        ds.synthetic = True
        return ds
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


def _read_leaf_dir(d: Path):
    """The LEAF JSON files of one split: *.json with {"users": [...],
    "user_data": {user: {"x": ..., "y": ...}}}, merged in file order."""
    users, data = [], {}
    for f in sorted(d.glob("*.json")):
        blob = json.loads(f.read_text())
        users.extend(blob["users"])
        data.update(blob["user_data"])
    return users, data


def _leaf_json_generic(dirname: str, shape: tuple, num_classes: int,
                       cache_dir: Path, cfg: Config) -> FedDataset | None:
    """LEAF per-client JSON (MNIST, femnist): `<cache>/<dirname>/
    {train,test}/*.json`, the first client_num_in_total users present in
    both splits as the clients. For MNIST the JAX reader takes the first
    users of the train split unfiltered and raises a KeyError on one
    missing from the test split; LEAF's splits hold the same users, and
    there the two agree."""
    train_dir = cache_dir / dirname / "train"
    test_dir = cache_dir / dirname / "test"
    if not train_dir.is_dir() or not test_dir.is_dir():
        return None

    users, train_data = _read_leaf_dir(train_dir)
    _, test_data = _read_leaf_dir(test_dir)
    users = [u for u in users if u in test_data][
        : cfg.train_args.client_num_in_total]
    if not users:
        return None
    xs, ys, parts, off = [], [], [], 0
    for u in users:
        ux = np.asarray(train_data[u]["x"], np.float32).reshape(
            (-1,) + tuple(shape))
        uy = np.asarray(train_data[u]["y"], np.int64)
        xs.append(ux)
        ys.append(uy)
        parts.append(np.arange(off, off + len(uy)))
        off += len(uy)
    x, y = np.concatenate(xs), np.concatenate(ys)
    xt = np.concatenate([
        np.asarray(test_data[u]["x"], np.float32).reshape((-1,) + tuple(shape))
        for u in users])
    yt = np.concatenate([np.asarray(test_data[u]["y"], np.int64)
                         for u in users])
    return pack_client_shards(x, y, parts, xt, yt, num_classes,
                              pad_multiple=cfg.train_args.batch_size)


# the shakespeare character vocabulary, shifted by +1 so that id 0 is the
# pad the nwp objective excludes (no real character encodes to 0)
_SHAKES_VOCAB = (
    "\n !\"&'(),-.0123456789:;>?ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    "[]abcdefghijklmnopqrstuvwxyz}"
)
_SHAKES_CHAR = {c: i + 1 for i, c in enumerate(_SHAKES_VOCAB)}
_SHAKES_UNK = _SHAKES_CHAR[" "]


def _encode_chars(s: str) -> np.ndarray:
    return np.asarray([_SHAKES_CHAR.get(c, _SHAKES_UNK) for c in s], np.int64)


def _leaf_shakespeare(cache_dir: Path, cfg: Config) -> FedDataset | None:
    """LEAF shakespeare (`<cache>/shakespeare/{train,test}/*.json`: x the
    80-character contexts, y the next character) as a next-token task:
    x [*, 80] token ids, y the context shifted left with the next
    character appended; shorter contexts pad to 80 with id 0."""
    train_dir = cache_dir / "shakespeare" / "train"
    test_dir = cache_dir / "shakespeare" / "test"
    if not train_dir.is_dir() or not test_dir.is_dir():
        return None

    users, train_data = _read_leaf_dir(train_dir)
    _, test_data = _read_leaf_dir(test_dir)
    users = [u for u in users if u in test_data][
        : cfg.train_args.client_num_in_total]
    if not users:
        return None
    L = DATASET_SHAPES["shakespeare"][0][0]

    def seqs(data, u):
        xs = [_encode_chars(s) for s in data[u]["x"]]
        ys = [_encode_chars(c)[0] for c in data[u]["y"]]
        out = np.zeros((len(xs), L), np.int64)
        tgt = np.zeros((len(xs), L), np.int64)
        for i, (s, nxt) in enumerate(zip(xs, ys)):
            out[i, : min(len(s), L)] = s[:L]
            shifted = np.concatenate([s[1:], [nxt]])
            tgt[i, : min(len(shifted), L)] = shifted[:L]
        return out, tgt

    xs, ys, parts, off = [], [], [], 0
    for u in users:
        ux, uy = seqs(train_data, u)
        xs.append(ux)
        ys.append(uy)
        parts.append(np.arange(off, off + len(uy)))
        off += len(uy)
    x, y = np.concatenate(xs), np.concatenate(ys)
    xt_list = [seqs(test_data, u) for u in users]
    xt = np.concatenate([a for a, _ in xt_list])
    yt = np.concatenate([b for _, b in xt_list])
    # ids run 1..len(vocab) ('}' is len(vocab)), so the head needs
    # len(vocab) + 1 classes; the JAX reader passes len(vocab) (ROADMAP
    # C.9)
    return pack_client_shards(x, y, parts, xt, yt, len(_SHAKES_VOCAB) + 1,
                              pad_multiple=cfg.train_args.batch_size)


# Token-dataset cache format version. Version 2 is the +1 vocabulary
# shift that reserves id 0 for the pad: an older cache encodes a real
# character as 0, which the nwp objective would silently exclude, so an
# unversioned or older token cache is refused, not reinterpreted.
_TOKEN_CACHE_VERSION = 2


def _npz_dataset(name: str, cache_dir: Path, cfg: Config) -> FedDataset | None:
    """A pre-exported `<name>.npz` with x_train/y_train/x_test/y_test
    (uint8 images are scaled to [0, 1]). A token dataset's archive must
    also hold `vocab_version == _TOKEN_CACHE_VERSION`."""
    f = cache_dir / f"{name}.npz"
    if not f.is_file():
        return None
    blob = np.load(f)
    if name in _TOKEN_TASKS:
        ver = int(blob["vocab_version"]) if "vocab_version" in blob else None
        if ver != _TOKEN_CACHE_VERSION:
            raise ValueError(
                f"{f} was exported with token-vocab version {ver} but this "
                f"build expects {_TOKEN_CACHE_VERSION} (id 0 is now a "
                "reserved pad excluded from NWP loss; old caches encode a "
                "real character as 0). Re-export the dataset with "
                f"vocab_version={_TOKEN_CACHE_VERSION} in the npz instead "
                "of silently reinterpreting old ids.")
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
        if name == "mnist":
            ds = _leaf_json_generic("MNIST", (28, 28, 1), 10, cache, cfg)
            if ds is not None:
                return ds
        if name in ("cifar10", "cifar100"):
            ds = _cifar_batches(name, cache, cfg)
            if ds is not None:
                return ds
        if name == "femnist":
            ds = _leaf_json_generic("femnist", (28, 28, 1), 62, cache, cfg)
            if ds is not None:
                return ds
        if name == "shakespeare":
            ds = _leaf_shakespeare(cache, cfg)
            if ds is not None:
                return ds
        if name in ("fed_cifar100", "fed_shakespeare", "stackoverflow_nwp",
                    "stackoverflow_lr"):
            from . import tff_h5

            ds = getattr(tff_h5, name)(cache, cfg)
            if ds is not None:
                return ds
        if name in _FOLDER_IMAGE or name in _LANDMARKS or name in _TABULAR:
            from . import folder_csv

            fn = (folder_csv.folder_image if name in _FOLDER_IMAGE else
                  folder_csv.landmarks_csv if name in _LANDMARKS else
                  folder_csv.tabular_csv)
            ds = fn(name, cache, cfg)
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
