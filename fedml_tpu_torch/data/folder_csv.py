"""Folder-image, landmarks-CSV and tabular-CSV datasets (port of
`fedml_tpu/data/folder_csv.py`). Each reader decodes once into stacked
numpy arrays and packs them as the rest of the hub does; a missing file
returns None (the loader's synthetic fallback).

- folder images (ImageNet / cinic10): `<cache>/<name>/train/<class>/*`
  and `/test` (or `/val`); labels in sorted class-folder order; the
  config's partition (Dirichlet / IID). Without a test split a seeded
  fifth is held out.
- landmarks CSV (gld23k / gld160k): the mapping files with user_id /
  image_id / class columns, images `<cache>/images/<image_id>.<ext>`;
  each user is a client (the first client_num_in_total, sorted).
- tabular CSV (SUSY / room_occupancy / lending_club / nus_wide):
  `<cache>/<name>.csv` with a header, the label the column named
  label / y / target / class or else the last; features standardised;
  a seeded 80/20 split; the config's partition.

`PIL` is imported by `_read_image` only, for files other than `.npy`.
"""
from __future__ import annotations

import csv as _csv
import logging
from pathlib import Path
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)

from .fed_dataset import FedDataset, pack_client_shards

_IMG_SUFFIXES = (".jpg", ".jpeg", ".png", ".bmp", ".npy")

# the mapping files' names per landmarks set
_LANDMARKS_FILES = {
    "gld23k": ("mini_gld_train_split.csv", "mini_gld_test.csv"),
    "gld160k": ("federated_train.csv", "test.csv"),
}


def _read_image(path: Path, size: Optional[tuple[int, int]]) -> np.ndarray:
    """One image as [H, W, 3] float32 in [0, 1]. A `.npy` array takes the
    same contract: uint8 scaled, grayscale [H, W] stacked to 3 channels,
    `size` by nearest-neighbour resampling."""
    if path.suffix == ".npy":
        a = np.load(path)
        if a.dtype == np.uint8:
            a = a.astype(np.float32) / 255.0
        a = a.astype(np.float32)
        if a.ndim == 2:
            a = np.repeat(a[..., None], 3, axis=-1)
        if size is not None and a.shape[:2] != size:
            ri = np.arange(size[0]) * a.shape[0] // size[0]
            ci = np.arange(size[1]) * a.shape[1] // size[1]
            a = a[ri][:, ci]
        return a
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB")
        if size is not None:
            im = im.resize((size[1], size[0]))
        return np.asarray(im, np.float32) / 255.0


def _img_size(cfg) -> Optional[tuple[int, int]]:
    s = cfg.data_args.extra.get("image_size")
    if s is None:
        return None
    if isinstance(s, int):
        return (s, s)
    return (int(s[0]), int(s[1]))


def folder_image(name: str, cache_dir: Path, cfg) -> Optional[FedDataset]:
    """A class-folder tree (`train/<class>/*`, labels in sorted class
    order)."""
    root = cache_dir / name
    train_dir = root / "train"
    test_dir = next((root / d for d in ("test", "val")
                     if (root / d).is_dir()), None)
    if not train_dir.is_dir():
        return None
    classes = sorted(d.name for d in train_dir.iterdir() if d.is_dir())
    if not classes:
        return None
    size = _img_size(cfg)

    def read_split(split_dir):
        xs, ys = [], []
        for ci, cname in enumerate(classes):
            cdir = split_dir / cname
            if not cdir.is_dir():
                continue
            for f in sorted(cdir.iterdir()):
                if f.suffix.lower() in _IMG_SUFFIXES:
                    xs.append(_read_image(f, size))
                    ys.append(ci)
        if not xs:
            return None, None
        shapes = {a.shape for a in xs}
        if len(shapes) > 1:
            raise ValueError(
                f"{name}: images have mixed shapes {sorted(shapes)}; set "
                "data_args.image_size to resize them to one shape")
        return np.stack(xs), np.asarray(ys, np.int64)

    x, y = read_split(train_dir)
    if x is None:
        return None
    if test_dir is not None:
        xt, yt = read_split(test_dir)
    else:
        xt, yt = None, None
    if xt is None:
        # a seeded holdout when no test split ships
        rs = np.random.RandomState(cfg.common_args.random_seed)
        idx = rs.permutation(len(y))
        k = max(1, len(y) // 5)
        xt, yt = x[idx[:k]], y[idx[:k]]
        x, y = x[idx[k:]], y[idx[k:]]
    from .loader import _build_from_arrays

    return _build_from_arrays(x, y, xt, yt, len(classes), cfg)


def landmarks_csv(name: str, cache_dir: Path, cfg) -> Optional[FedDataset]:
    """Google Landmarks mapping CSVs (rows user_id, image_id, class; image
    `<cache>/images/<image_id>.<ext>`); each user is one client."""
    train_name, test_name = _LANDMARKS_FILES.get(
        name, (f"{name}_train.csv", f"{name}_test.csv"))
    train_csv = cache_dir / train_name
    test_csv = cache_dir / test_name
    if not train_csv.is_file():
        return None
    size = _img_size(cfg)

    def img(image_id: str) -> np.ndarray:
        base = cache_dir / "images" / image_id
        for suf in _IMG_SUFFIXES:
            p = base.with_suffix(suf)
            if p.is_file():
                return _read_image(p, size)
        raise FileNotFoundError(
            f"{name}: image {image_id!r} listed in {train_name} not found "
            f"under {cache_dir / 'images'}")

    def rows(path: Path) -> list[dict]:
        with open(path, newline="") as f:
            rdr = _csv.DictReader(f)
            missing = {"image_id", "class"} - set(rdr.fieldnames or ())
            if missing:
                raise ValueError(
                    f"{path.name}: mapping file must have user_id/image_id/"
                    f"class columns; missing {missing}")
            return list(rdr)

    by_user: dict[str, list[dict]] = {}
    for r in rows(train_csv):
        by_user.setdefault(r.get("user_id", "0"), []).append(r)
    want = cfg.train_args.client_num_in_total
    if len(by_user) < want:
        # as the TFF readers: fewer clients than the config asks for fail
        raise ValueError(
            f"{name}: mapping file has {len(by_user)} users but "
            f"client_num_in_total={want}; lower the config to the file's "
            "client count")
    users = sorted(by_user)[:want]
    if len(by_user) > want:
        # keeping fewer users than the file has is the config's choice: say
        # what is dropped
        dropped = sum(len(by_user[u]) for u in sorted(by_user)[want:])
        log.warning(
            "%s: mapping file has %d users but client_num_in_total=%d — "
            "keeping the first %d (sorted) and DROPPING %d users / %d "
            "samples; raise client_num_in_total to use every user",
            name, len(by_user), want, want, len(by_user) - want, dropped)
    xs, ys, parts, off = [], [], [], 0
    for u in users:
        for r in by_user[u]:
            xs.append(img(r["image_id"]))
            ys.append(int(r["class"]))
        parts.append(np.arange(off, off + len(by_user[u])))
        off += len(by_user[u])
    x, y = np.stack(xs), np.asarray(ys, np.int64)
    if test_csv.is_file():
        trows = rows(test_csv)
        xt = np.stack([img(r["image_id"]) for r in trows])
        yt = np.asarray([int(r["class"]) for r in trows], np.int64)
    else:
        xt, yt = x[:1], y[:1]
    num_classes = int(max(y.max(), yt.max())) + 1
    return pack_client_shards(x, y, parts, xt, yt, num_classes,
                              pad_multiple=cfg.train_args.batch_size)


_LABEL_NAMES = ("label", "y", "target", "class")


def tabular_csv(name: str, cache_dir: Path, cfg) -> Optional[FedDataset]:
    """A tabular CSV with a header row, parsed with numpy: the label column
    by name (label / y / target / class) or the last; features
    standardised; a seeded 80/20 split; the config's partition."""
    f = cache_dir / f"{name}.csv"
    if not f.is_file():
        f = cache_dir / name / f"{name}.csv"
        if not f.is_file():
            return None
    with open(f, newline="") as fh:
        rdr = _csv.reader(fh)
        header = [h.strip() for h in next(rdr)]
        raw = [row for row in rdr if row]
    cols = {h.lower(): i for i, h in enumerate(header)}
    label_i = next((cols[n] for n in _LABEL_NAMES if n in cols),
                   len(header) - 1)
    data = np.asarray(raw, np.float64)
    y = data[:, label_i].astype(np.int64)
    x = np.delete(data, label_i, axis=1).astype(np.float32)
    # standardise (a constant column stays 0)
    mu, sd = x.mean(0), x.std(0)
    x = (x - mu) / np.where(sd > 0, sd, 1.0)
    # over every row, before the split: a class only in the holdout still
    # widens the head
    num_classes = int(y.max()) + 1
    rs = np.random.RandomState(cfg.common_args.random_seed)
    idx = rs.permutation(len(y))
    k = max(1, len(y) // 5)
    xt, yt = x[idx[:k]], y[idx[:k]]
    x, y = x[idx[k:]], y[idx[k:]]
    from .loader import _build_from_arrays

    return _build_from_arrays(x, y, xt, yt, num_classes, cfg)
