"""TFF-format h5 federated datasets (port of `fedml_tpu/data/tff_h5.py`):
fed_cifar100, fed_shakespeare, stackoverflow_nwp and stackoverflow_lr,
plus stackoverflow_lr's synthetic fallback.

The files keep TFF's layout, `examples/<client_id>/<field>`:
image / label (fed_cifar100), snippets (fed_shakespeare, byte strings),
tokens / title / tags (stackoverflow). Each set lands in one stacked
FedDataset whose clients are the file's clients, in key order (no
Dirichlet resplit). The stackoverflow vocabularies are built from the
clients loaded (top-K words and tags by count); their sizes come from
data_args.extra: so_vocab_size (10000), so_tag_size (500), so_seq_len
(20). `h5py` is imported by the reader only, so the package imports
without it.
"""
from __future__ import annotations

from collections import Counter
from pathlib import Path
from typing import Optional

import numpy as np

from ..config import Config
from .fed_dataset import FedDataset, pack_client_shards
from .partition import record_data_stats

# the TFF shakespeare character vocabulary: pad + 86 characters + bos +
# eos (+1 oov bucket at encode time)
CHAR_VOCAB = list(
    "dhlptx@DHLPTX $(,048cgkoswCGKOSW[_#'/37;?bfjnrvzBFJNRVZ\"&*.26:"
    "\naeimquyAEIMQUY]!%)-159\r"
)
SHAKESPEARE_SEQ_LEN = 80           # McMahan et al. AISTATS 2017
SHAKESPEARE_VOCAB = len(CHAR_VOCAB) + 4  # pad, bos, eos, oov


def _char_ids():
    # pad=0, chars=1.., bos, eos; oov = last id
    d = {c: i + 1 for i, c in enumerate(CHAR_VOCAB)}
    bos = len(CHAR_VOCAB) + 1
    eos = len(CHAR_VOCAB) + 2
    oov = len(CHAR_VOCAB) + 3
    return d, bos, eos, oov


def snippets_to_sequences(snippets, seq_len: int = SHAKESPEARE_SEQ_LEN):
    """byte-string snippets -> [n, seq_len] x and next-character targets
    y: bos + characters + eos, cut into windows of seq_len + 1."""
    d, bos, eos, oov = _char_ids()
    xs, ys = [], []
    for sn in snippets:
        text = sn.decode("utf-8", "ignore") if isinstance(sn, bytes) else str(sn)
        ids = [bos] + [d.get(c, oov) for c in text] + [eos]
        for off in range(0, max(len(ids) - 1, 1), seq_len):
            win = ids[off:off + seq_len + 1]
            if len(win) < 2:
                continue
            win = win + [0] * (seq_len + 1 - len(win))
            xs.append(win[:-1])
            ys.append(win[1:])
    if not xs:
        return (np.zeros((0, seq_len), np.int64),) * 2
    return np.asarray(xs, np.int64), np.asarray(ys, np.int64)


def _read_clients(path: Path, fields: list[str],
                  max_clients: Optional[int] = None) -> list[dict]:
    """examples/<client>/<field> -> [{field: ndarray}] in key order."""
    import h5py

    out = []
    with h5py.File(path, "r") as f:
        ex = f["examples"]
        for cid in sorted(ex.keys()):
            out.append({fl: ex[cid][fl][()] for fl in fields})
            if max_clients is not None and len(out) >= max_clients:
                break
    return out


def _pack_natural(xs: list[np.ndarray], ys: list[np.ndarray],
                  x_test: np.ndarray, y_test: np.ndarray,
                  num_classes: int, cfg: Config) -> FedDataset:
    """Stack per-client arrays with the file's own clients as the
    partition (no Dirichlet resplit)."""
    n_want = cfg.train_args.client_num_in_total
    if len(xs) < n_want:
        raise ValueError(
            f"dataset has {len(xs)} clients but client_num_in_total="
            f"{n_want}; lower the config or provide more h5 clients")
    xs, ys = xs[:n_want], ys[:n_want]
    x = np.concatenate(xs)
    y = np.concatenate(ys)
    parts, off = [], 0
    for cx in xs:
        parts.append(np.arange(off, off + len(cx)))
        off += len(cx)
    ds = pack_client_shards(x, y, parts, x_test, y_test, num_classes,
                            pad_multiple=cfg.train_args.batch_size)
    labels = y if y.ndim == 1 else y[:, -1]
    ds.client_class_stats = record_data_stats(labels, parts)
    return ds


def fed_cifar100(cache_dir: Path, cfg: Config) -> Optional[FedDataset]:
    """fed_cifar100: image / label groups, uint8 images scaled to [0, 1]."""
    tr = cache_dir / "fed_cifar100" / "fed_cifar100_train.h5"
    te = cache_dir / "fed_cifar100" / "fed_cifar100_test.h5"
    if not (tr.is_file() and te.is_file()):
        return None
    as_x = lambda a: np.asarray(a, np.float32) / (
        255.0 if np.asarray(a).dtype == np.uint8 else 1.0)
    train = _read_clients(tr, ["image", "label"],
                          cfg.train_args.client_num_in_total)
    test = _read_clients(te, ["image", "label"])
    return _pack_natural(
        [as_x(c["image"]) for c in train],
        [np.asarray(c["label"], np.int64).reshape(-1) for c in train],
        np.concatenate([as_x(c["image"]) for c in test]),
        np.concatenate([np.asarray(c["label"], np.int64).reshape(-1)
                        for c in test]),
        100, cfg)


def fed_shakespeare(cache_dir: Path, cfg: Config) -> Optional[FedDataset]:
    """fed_shakespeare: snippets -> next-character sequences."""
    tr = cache_dir / "fed_shakespeare" / "shakespeare_train.h5"
    te = cache_dir / "fed_shakespeare" / "shakespeare_test.h5"
    if not (tr.is_file() and te.is_file()):
        return None
    train = _read_clients(tr, ["snippets"],
                          cfg.train_args.client_num_in_total)
    test = _read_clients(te, ["snippets"])
    xs, ys = [], []
    for c in train:
        x, y = snippets_to_sequences(c["snippets"])
        xs.append(x)
        ys.append(y)
    tx, ty = zip(*(snippets_to_sequences(c["snippets"]) for c in test))
    return _pack_natural(xs, ys, np.concatenate(tx), np.concatenate(ty),
                         SHAKESPEARE_VOCAB, cfg)


def _build_word_vocab(token_lists, size: int) -> dict[str, int]:
    """Top-`size` words by count (ties in first-seen order); the special
    ids are pad 0, oov 1, bos 2, eos 3."""
    counts = Counter()
    for sent in token_lists:
        text = sent.decode("utf-8", "ignore") if isinstance(sent, bytes) else str(sent)
        counts.update(text.split())
    vocab = {}
    for w, _n in counts.most_common(size):
        vocab[w] = 4 + len(vocab)
    return vocab


def _so_sentences(clients: list[dict]) -> list:
    out = []
    for c in clients:
        out.extend(list(c["tokens"]))
    return out


def stackoverflow_nwp(cache_dir: Path, cfg: Config) -> Optional[FedDataset]:
    """stackoverflow_nwp: tokens -> word-id next-word sequences."""
    tr = cache_dir / "stackoverflow" / "stackoverflow_train.h5"
    te = cache_dir / "stackoverflow" / "stackoverflow_test.h5"
    if not (tr.is_file() and te.is_file()):
        return None
    extra = cfg.data_args.extra
    vocab_size = int(extra.get("so_vocab_size", 10000))
    seq_len = int(extra.get("so_seq_len", 20))
    train = _read_clients(tr, ["tokens"], cfg.train_args.client_num_in_total)
    test = _read_clients(te, ["tokens"])
    vocab = _build_word_vocab(_so_sentences(train), vocab_size)

    def encode(clients):
        xs, ys = [], []
        for c in clients:
            cx, cy = [], []
            for sent in c["tokens"]:
                text = sent.decode("utf-8", "ignore") if isinstance(
                    sent, bytes) else str(sent)
                ids = [2] + [vocab.get(w, 1) for w in text.split()] + [3]
                ids = ids[:seq_len + 1]
                ids += [0] * (seq_len + 1 - len(ids))
                cx.append(ids[:-1])
                cy.append(ids[1:])
            xs.append(np.asarray(cx, np.int64))
            ys.append(np.asarray(cy, np.int64))
        return xs, ys

    xs, ys = encode(train)
    txs, tys = encode(test)
    return _pack_natural(xs, ys, np.concatenate(txs), np.concatenate(tys),
                         vocab_size + 4, cfg)


def stackoverflow_lr(cache_dir: Path, cfg: Config) -> Optional[FedDataset]:
    """stackoverflow_lr: tokens + title -> a bag of words over the real
    words, tags -> a multi-hot target (task 'multilabel')."""
    tr = cache_dir / "stackoverflow" / "stackoverflow_train.h5"
    te = cache_dir / "stackoverflow" / "stackoverflow_test.h5"
    if not (tr.is_file() and te.is_file()):
        return None
    extra = cfg.data_args.extra
    vocab_size = int(extra.get("so_vocab_size", 10000))
    tag_size = int(extra.get("so_tag_size", 500))
    fields = ["tokens", "title", "tags"]
    train = _read_clients(tr, fields, cfg.train_args.client_num_in_total)
    test = _read_clients(te, fields)
    vocab = _build_word_vocab(
        _so_sentences(train)
        + [t for c in train for t in list(c["title"])], vocab_size)
    tag_counts = Counter()
    for c in train:
        for tags in c["tags"]:
            text = tags.decode("utf-8", "ignore") if isinstance(
                tags, bytes) else str(tags)
            tag_counts.update(text.split("|"))
    tag_vocab = {t: i for i, (t, _n) in
                 enumerate(tag_counts.most_common(tag_size))}

    def encode(clients):
        xs, ys = [], []
        for c in clients:
            n = len(c["tags"])
            bow = np.zeros((n, vocab_size), np.float32)
            mh = np.zeros((n, tag_size), np.int64)
            for i in range(n):
                dec = lambda b: b.decode("utf-8", "ignore") if isinstance(
                    b, bytes) else str(b)
                words = (dec(c["tokens"][i]) + " " + dec(c["title"][i])).split()
                for w in words:
                    j = vocab.get(w)
                    if j is not None:
                        bow[i, j - 4] = 1.0   # BoW over real words only
                for t in dec(c["tags"][i]).split("|"):
                    k = tag_vocab.get(t)
                    if k is not None:
                        mh[i, k] = 1
            xs.append(bow)
            ys.append(mh)
        return xs, ys

    xs, ys = encode(train)
    txs, tys = encode(test)
    return _pack_natural(xs, ys, np.concatenate(txs), np.concatenate(tys),
                         tag_size, cfg)


def synthetic_multilabel(cfg: Config, vocab_size: int = 128,
                         tag_size: int = 16) -> FedDataset:
    """stackoverflow_lr's synthetic fallback: sparse bags of words whose
    active words determine the tags linearly (learnable by the lr model
    under the multilabel objective)."""
    rng = np.random.RandomState(cfg.common_args.random_seed)
    t = cfg.train_args
    per = int(cfg.data_args.extra.get("synthetic_samples_per_client", 64))
    n = max(t.client_num_in_total * per, 256)
    total = int(n * 1.25)
    x = (rng.rand(total, vocab_size) < (8.0 / vocab_size)).astype(np.float32)
    # tag k fires iff word k (or its alias k + tag_size) appears
    y = np.maximum(x[:, :tag_size], x[:, tag_size:2 * tag_size]).astype(np.int64)
    n_test = int(total * 0.2)
    parts = np.array_split(rng.permutation(total - n_test),
                           t.client_num_in_total)
    ds = pack_client_shards(
        x[n_test:], y[n_test:], [np.asarray(p) for p in parts],
        x[:n_test], y[:n_test], tag_size, pad_multiple=t.batch_size)
    ds.synthetic = True
    return ds
