"""The port's dataset readers and synthetic tasks (`fedml_tpu_torch.data`:
the LEAF JSON readers, `tff_h5.py`, `folder_csv.py`, the token,
segmentation and multi-label synthetics, the loader's dispatch) against
the JAX package's, on the CPU.

Every reader runs on fixture files this module writes under `tmp_path`
(LEAF JSON, TFF h5, `.npy` class folders, landmarks CSVs, a tabular CSV)
and its shards, masks, counts, test arrays and labels are held to the JAX
loader's bitwise, dtypes included. The one difference by design is the
LEAF shakespeare reader's class count (ROADMAP C.9).
"""
import json

import numpy as np
import pytest

from fedml_tpu.config import Config as JaxConfig
from fedml_tpu.data import loader as jax_loader

from fedml_tpu_torch.config import Config
from fedml_tpu_torch.data import loader

FIELDS = ("x_train", "y_train", "mask_train", "counts", "x_test", "y_test")


def _load_both(cache, dataset, clients=4, batch=8, **data_extra):
    d = {"data_args": {"dataset": dataset, "data_cache_dir": str(cache),
                       "extra": data_extra},
         "train_args": {"client_num_in_total": clients,
                        "client_num_per_round": clients,
                        "batch_size": batch}}
    return (jax_loader.load(JaxConfig.from_dict(d)),
            loader.load(Config.from_dict(d)))


def _assert_bitwise(got, want, num_classes=True):
    for k in FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    if num_classes:
        assert got.num_classes == want.num_classes
    assert got.synthetic == want.synthetic
    assert got.client_class_stats == want.client_class_stats


# --------------------------------------------------------------- synthetic
@pytest.mark.parametrize("dataset", [
    "shakespeare", "fed_shakespeare", "stackoverflow_nwp", "stackoverflow_lr",
    "pascal_voc", "cityscapes", "coco_seg", "SUSY", "nus_wide", "cinic10",
    "gld23k", "fed_cifar100"])
def test_synthetic_fallbacks_bitwise(dataset, tmp_path):
    """With no file on disk every dataset name the port used to refuse
    falls back to the JAX loader's synthetic task, bitwise: token
    sequences (ids in [1, V)), one square a segmentation image with its
    class as the partition label, sparse multi-label bags of words, and
    Gaussian mixtures for the rest."""
    want, got = _load_both(tmp_path, dataset,
                           synthetic_samples_per_client=8)
    _assert_bitwise(got, want)
    assert got.synthetic
    if dataset in ("shakespeare", "fed_shakespeare", "stackoverflow_nwp"):
        assert got.y_train.ndim == 3 and got.x_train.dtype == np.int64
        assert got.x_train[got.mask_train > 0].min() >= 1
    if dataset == "pascal_voc":
        assert got.y_train.shape[2:] == (32, 32)


def test_multilabel_fallback_takes_the_h5_width_keys(tmp_path):
    """With so_vocab_size / so_tag_size in data_args.extra and no h5 file,
    the stackoverflow_lr fallback is the JAX synthetic_multilabel at that
    width, bitwise (the JAX loader's own fallback stays at 128 / 16:
    ROADMAP C.11)."""
    from fedml_tpu.data.tff_h5 import synthetic_multilabel as jax_multi
    want_default, got = _load_both(tmp_path, "stackoverflow_lr",
                                   synthetic_samples_per_client=8,
                                   so_vocab_size=40, so_tag_size=12)
    assert want_default.x_train.shape[2:] == (128,)
    d = {"data_args": {"dataset": "stackoverflow_lr",
                       "data_cache_dir": str(tmp_path),
                       "extra": {"synthetic_samples_per_client": 8}},
         "train_args": {"client_num_in_total": 4, "client_num_per_round": 4,
                        "batch_size": 8}}
    want = jax_multi(JaxConfig.from_dict(d), 40, 12)
    _assert_bitwise(got, want)
    assert got.x_train.shape[2:] == (40,) and got.y_train.shape[2:] == (12,)
    assert got.num_classes == 12 and got.synthetic


# -------------------------------------------------------------------- LEAF
def _leaf_split(path, users, make):
    path.mkdir(parents=True)
    half = len(users) // 2
    for i, part in enumerate((users[:half], users[half:])):
        blob = {"users": part, "user_data": {u: make(u) for u in part}}
        (path / f"all_data_{i}.json").write_text(json.dumps(blob))


def test_leaf_mnist_and_femnist_bitwise(tmp_path):
    rs = np.random.RandomState(0)

    def make(classes):
        def one(_u):
            n = int(rs.randint(3, 9))
            return {"x": rs.rand(n, 784).round(3).tolist(),
                    "y": rs.randint(0, classes, n).tolist()}
        return one

    users = [f"f_{i:03d}" for i in range(6)]
    for name, classes in (("MNIST", 10), ("femnist", 62)):
        _leaf_split(tmp_path / name / "train", users, make(classes))
        # femnist keeps only users present in both splits
        _leaf_split(tmp_path / name / "test", users[:5], make(classes))
    for dataset in ("mnist", "femnist"):
        want, got = _load_both(tmp_path, dataset, clients=4)
        _assert_bitwise(got, want)
        assert got.x_train.shape[2:] == (28, 28, 1) and not got.synthetic


def test_leaf_shakespeare_bitwise(tmp_path):
    """Contexts shorter than 80 characters pad with id 0; characters
    outside the vocabulary encode as ' '. The shards and labels are the
    JAX reader's bitwise; the class count is one more than JAX's, since
    the ids run to len(vocab) (ROADMAP C.9)."""
    rs = np.random.RandomState(1)
    alphabet = list("abcXYZ}{ ,.\n~")

    def make(_u):
        n = int(rs.randint(2, 6))
        xs = ["".join(rs.choice(alphabet, int(rs.randint(20, 81))))
              for _ in range(n)]
        return {"x": xs, "y": [str(rs.choice(alphabet)) for _ in range(n)]}

    users = [f"s{i}" for i in range(5)]
    _leaf_split(tmp_path / "shakespeare" / "train", users, make)
    _leaf_split(tmp_path / "shakespeare" / "test", users, make)
    want, got = _load_both(tmp_path, "shakespeare", clients=3)
    _assert_bitwise(got, want, num_classes=False)
    assert (got.num_classes, want.num_classes) == (81, 80)
    assert got.y_train.max() <= got.num_classes - 1
    assert got.x_train.shape[2:] == (80,)


# ---------------------------------------------------------------- TFF h5
def _h5(path, clients: dict):
    import h5py

    path.parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(path, "w") as f:
        ex = f.create_group("examples")
        for cid, fields in clients.items():
            g = ex.create_group(cid)
            for k, v in fields.items():
                g.create_dataset(k, data=v)


def test_tff_h5_readers_bitwise(tmp_path):
    """fed_cifar100, fed_shakespeare, stackoverflow_nwp and
    stackoverflow_lr on h5 files in TFF's `examples/<client>/<field>`
    layout: the file's clients in key order, vocabularies and tags built
    from the loaded clients, bitwise the JAX readers."""
    rs = np.random.RandomState(2)
    words = ["w%d" % i for i in range(30)]
    tags = ["t%d" % i for i in range(12)]

    def sentence(k):
        return " ".join(rs.choice(words, k)).encode()

    def cifar(n):
        return {"image": rs.randint(0, 256, (n, 32, 32, 3)).astype(np.uint8),
                "label": rs.randint(0, 100, (n,)).astype(np.int64)}

    def snippets(n):
        return {"snippets": np.array(
            ["".join(rs.choice(list("abc dEF!?\n"), int(rs.randint(5, 200))))
             .encode() for _ in range(n)], dtype=object)}

    def so(n):
        return {"tokens": np.array([sentence(int(rs.randint(2, 30)))
                                    for _ in range(n)], dtype=object),
                "title": np.array([sentence(3) for _ in range(n)],
                                  dtype=object),
                "tags": np.array(["|".join(rs.choice(tags, 2)).encode()
                                  for _ in range(n)], dtype=object)}

    for d, stem, make in (("fed_cifar100", "fed_cifar100", cifar),
                          ("fed_shakespeare", "shakespeare", snippets),
                          ("stackoverflow", "stackoverflow", so)):
        for split in ("train", "test"):
            _h5(tmp_path / d / f"{stem}_{split}.h5",
                {f"c{i:02d}": make(int(rs.randint(2, 7))) for i in range(5)})
    extra = {"so_vocab_size": 20, "so_tag_size": 8, "so_seq_len": 10}
    for dataset in ("fed_cifar100", "fed_shakespeare", "stackoverflow_nwp",
                    "stackoverflow_lr"):
        want, got = _load_both(tmp_path, dataset, clients=4, **extra)
        _assert_bitwise(got, want)
        assert not got.synthetic
    # a config asking for more clients than the file has fails in both
    for ld, C in ((jax_loader, JaxConfig), (loader, Config)):
        with pytest.raises(ValueError, match="clients but"):
            ld.load(C.from_dict({"data_args": {
                "dataset": "fed_cifar100", "data_cache_dir": str(tmp_path)},
                "train_args": {"client_num_in_total": 9,
                               "client_num_per_round": 9}}))


# ------------------------------------------------------- folder images, CSV
def _npy_image(path, rs, shape=(6, 6, 3), gray=False):
    path.parent.mkdir(parents=True, exist_ok=True)
    a = rs.randint(0, 256, shape[:2] if gray else shape).astype(np.uint8)
    np.save(path, a)


def test_folder_images_bitwise(tmp_path):
    """Class folders of `.npy` images (uint8, one grayscale), with a test
    split (ILSVRC2012) and without one (cinic10: a seeded holdout), and
    resized to data_args.image_size; a mixed-shape folder is refused in
    both."""
    rs = np.random.RandomState(3)
    for split, n in (("train", 5), ("val", 2)):
        for c in ("cat", "ant", "bee"):
            for i in range(n):
                _npy_image(tmp_path / "ILSVRC2012" / split / c / f"{i}.npy",
                           rs, gray=(c == "bee" and i == 0))
    for c in ("a", "b"):
        for i in range(6):
            _npy_image(tmp_path / "cinic10" / "train" / c / f"{i}.npy", rs,
                       shape=(8, 8, 3))
    for dataset, extra in (("ILSVRC2012", {}), ("cinic10", {}),
                           ("cinic10", {"image_size": 4})):
        want, got = _load_both(tmp_path, dataset, clients=2, batch=4,
                               **extra)
        _assert_bitwise(got, want)
    _npy_image(tmp_path / "imagenet" / "train" / "x" / "0.npy", rs)
    _npy_image(tmp_path / "imagenet" / "train" / "x" / "1.npy", rs,
               shape=(5, 5, 3))
    for ld, C in ((jax_loader, JaxConfig), (loader, Config)):
        with pytest.raises(ValueError, match="mixed shapes"):
            ld.load(C.from_dict({"data_args": {
                "dataset": "imagenet", "data_cache_dir": str(tmp_path)},
                "train_args": {"client_num_in_total": 1,
                               "client_num_per_round": 1}}))


def test_landmarks_and_tabular_csv_bitwise(tmp_path):
    """gld23k's mapping CSVs (each user a client, sorted; the first
    client_num_in_total kept) over `.npy` images, and a tabular CSV
    (label column by name, features standardised, a seeded 80/20
    split)."""
    rs = np.random.RandomState(4)
    rows = []
    for u in range(5):
        for i in range(int(rs.randint(2, 5))):
            iid = f"img{u}_{i}"
            _npy_image(tmp_path / "images" / f"{iid}.npy", rs)
            rows.append((f"user{u}", iid, int(rs.randint(0, 7))))
    test_rows = rows[::3]
    for name, body in (("mini_gld_train_split.csv", rows),
                       ("mini_gld_test.csv", test_rows)):
        (tmp_path / name).write_text(
            "user_id,image_id,class\n"
            + "".join(f"{u},{i},{c}\n" for u, i, c in body))
    want, got = _load_both(tmp_path, "gld23k", clients=3, batch=4)
    _assert_bitwise(got, want)
    assert got.num_clients == 3
    for ld, C in ((jax_loader, JaxConfig), (loader, Config)):
        with pytest.raises(ValueError, match="users but"):
            ld.load(C.from_dict({"data_args": {
                "dataset": "gld23k", "data_cache_dir": str(tmp_path)},
                "train_args": {"client_num_in_total": 6,
                               "client_num_per_round": 6}}))

    header = "f0,f1,target,f2,const\n"
    lines = "".join(f"{rs.randn():.5f},{rs.randn():.5f},{rs.randint(0, 3)},"
                    f"{rs.randn():.5f},1.0\n" for _ in range(60))
    (tmp_path / "SUSY.csv").write_text(header + lines)
    want, got = _load_both(tmp_path, "SUSY", clients=3, batch=4)
    _assert_bitwise(got, want)
    assert got.x_train.shape[2:] == (4,) and got.num_classes == 3


# ------------------------------------------------------- token npz version
@pytest.mark.parametrize("version", [None, 1, 2])
def test_token_npz_version_check(version, tmp_path):
    """A token dataset's npz must carry vocab_version 2 (id 0 is the pad
    the nwp objective excludes): an unversioned or older cache is
    refused by both loaders with the same message; version 2 loads
    bitwise."""
    rs = np.random.RandomState(5)
    blob = {"x_train": rs.randint(1, 81, (40, 80)),
            "y_train": rs.randint(1, 81, (40, 80)),
            "x_test": rs.randint(1, 81, (10, 80)),
            "y_test": rs.randint(1, 81, (10, 80))}
    if version is not None:
        blob["vocab_version"] = np.asarray(version)
    np.savez(tmp_path / "stackoverflow_nwp.npz", **blob)
    if version == 2:
        want, got = _load_both(tmp_path, "stackoverflow_nwp", clients=2)
        _assert_bitwise(got, want)
        return
    msgs = []
    for ld, C in ((jax_loader, JaxConfig), (loader, Config)):
        with pytest.raises(ValueError, match="token-vocab version") as e:
            ld.load(C.from_dict({"data_args": {
                "dataset": "stackoverflow_nwp",
                "data_cache_dir": str(tmp_path)},
                "train_args": {"client_num_in_total": 2,
                               "client_num_per_round": 2}}))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
