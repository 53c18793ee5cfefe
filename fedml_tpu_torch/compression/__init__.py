"""Update compression (port of `fedml_tpu/compression/__init__.py`).

- Simulation transforms: compress then decompress each client's update in
  the round, modelling the information loss (`topk`, `eftopk`, `randk`,
  `quantize`, `qsgd`). The random ones come in two halves, a draw from a
  `torch.Generator` and an apply that takes the draw, so a test can hand
  both sides the same draw. Top-k keeps the largest magnitudes, ties to
  the lower index (jax.lax.top_k's order; a stable sort).
- EF-TopK keeps each client's residual on the round's client-state plane
  (`wrap_algorithm_with_eftopk`).
- Wire codecs (`encode_sparse`, `decode_sparse` and their tree forms):
  numpy, host side, for the cross-silo transport; a tree's leaves go in
  sorted-key order, the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from ..ops import keys
from ..ops.tree import tree_leaves, tree_map

Tree = Any


def _leaf_k(size: int, ratio: float) -> int:
    return max(1, int(size * ratio))


def topk_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """The k largest |x| of a flat tensor, ties to the lower index."""
    return torch.sort(torch.abs(x), descending=True, stable=True).indices[:k]


def _keep(flat: torch.Tensor, idx: torch.Tensor,
          vals: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(flat).index_copy_(0, idx.long(), vals)


def topk_leaf(x: torch.Tensor, ratio: float) -> torch.Tensor:
    """The top-k |values| of one leaf kept, the rest zeroed."""
    flat = x.reshape(-1)
    idx = topk_indices(flat, _leaf_k(flat.numel(), ratio))
    return _keep(flat, idx, flat.index_select(0, idx)).reshape(x.shape)


def topk_compress(update: Tree, ratio: float) -> Tree:
    """'topk': each leaf sparsified on its own."""
    return tree_map(lambda x: topk_leaf(x, ratio), update)


def eftopk_compress(update: Tree, residual: Tree, ratio: float):
    """'eftopk': the carried residual added, top-k taken, what was dropped
    kept as the next residual. Returns (sparse update, new residual)."""
    acc = tree_map(torch.add, update, residual)
    sparse = topk_compress(acc, ratio)
    return sparse, tree_map(torch.sub, acc, sparse)


def draw_randk(gen: torch.Generator, update: Tree, ratio: float) -> Tree:
    """Each leaf's k distinct random flat indices."""
    return tree_map(lambda x: torch.randperm(
        x.numel(), generator=gen, device=x.device)[:_leaf_k(x.numel(), ratio)],
        update)


def randk_apply(update: Tree, idx: Tree) -> Tree:
    """'randk': the chosen entries kept, scaled by size / k (unbiased)."""
    def leaf(x, i):
        flat, i = x.reshape(-1), i.long()
        return _keep(flat, i, flat.index_select(0, i)
                     * (flat.numel() / i.numel())).reshape(x.shape)
    return tree_map(leaf, update, idx)


def draw_uniform(gen: torch.Generator, update: Tree) -> Tree:
    return tree_map(lambda x: torch.rand(x.shape, generator=gen,
                                         device=x.device), update)


def _stochastic_round(level: torch.Tensor, u: Optional[torch.Tensor]):
    if u is None:
        return torch.round(level)
    floor = torch.floor(level)
    return floor + (u < (level - floor)).to(level.dtype)


def quantize_apply(update: Tree, bits: int, u: Optional[Tree] = None) -> Tree:
    """'quantize': magnitudes on 2^(bits-1) levels of the leaf's largest,
    rounded stochastically by the uniforms `u` (unbiased), or to the
    nearest level when u is None; the sign kept."""
    levels = float(2 ** (bits - 1))

    def leaf(x, ux):
        scale = torch.clamp(torch.abs(x).max(), min=1e-12)
        q = _stochastic_round(torch.abs(x) / scale * levels, ux)
        return torch.sign(x) * q * scale / levels

    return tree_map(leaf, update, u) if u is not None else \
        tree_map(lambda x: leaf(x, None), update)


def qsgd_apply(update: Tree, bits: int, u: Tree) -> Tree:
    """'qsgd' (Alistarh et al. 2017): magnitudes on 2^bits levels of the
    leaf's L2 norm, rounded stochastically by the uniforms `u`."""
    s = float(2 ** bits)

    def leaf(x, ux):
        norm = torch.clamp(torch.linalg.vector_norm(x.reshape(-1)), min=1e-12)
        q = _stochastic_round(torch.abs(x) / norm * s, ux)
        return torch.sign(x) * q * norm / s

    return tree_map(leaf, update, u)


def _device(tree: Tree) -> torch.device:
    return tree_leaves(tree)[0].device


def randk_compress(update: Tree, ratio: float, gen: torch.Generator) -> Tree:
    return randk_apply(update, draw_randk(gen, update, ratio))


def quantize_compress(update: Tree, bits: int,
                      gen: Optional[torch.Generator] = None) -> Tree:
    return quantize_apply(update, bits, None if gen is None
                          else draw_uniform(gen, update))


def qsgd_compress(update: Tree, bits: int, gen: torch.Generator) -> Tree:
    return qsgd_apply(update, bits, draw_uniform(gen, update))


COMPRESSORS = ("none", "topk", "eftopk", "randk", "quantize", "qsgd")


def wrap_algorithm_with_eftopk(alg, ratio: float,
                               pre_transform: Optional[Callable] = None):
    """EF-TopK's residual on the round's client-state plane: the wrapped
    algorithm's client state is {"inner": the algorithm's own state (a 0-d
    placeholder without one), "residual": a params-shaped carry}, stacked
    over every client. The compression runs in the algorithm's
    `finish_update`, which the round calls for each client outside
    torch.func.vmap: first `pre_transform(update, key + (0x9A,))` (the
    client-side defense, so the order is defender -> compress -> DP as
    for every other compressor), then top-k of update + residual.
    Algorithms whose update is not a params-shaped delta are refused."""
    if alg.name in ("FedNova", "SCAFFOLD", "Mime"):
        raise ValueError(
            f"eftopk cannot wrap {alg.name}: its update payload is a "
            "structured dict, not a params-shaped delta; use 'topk'/'qsgd' "
            "on a params-delta algorithm instead")
    inner_init = alg.client_state_init

    def state_init(params):
        inner = inner_init(params) if inner_init is not None \
            else torch.zeros((), device=_device(params))
        return {"inner": inner,
                "residual": tree_map(torch.zeros_like, params)}

    def client_update(bcast, shard, cstate, batch_idx):
        upd, new_inner, met = alg.client_update(
            bcast, shard, cstate["inner"] if inner_init is not None else None,
            batch_idx)
        inner = new_inner if inner_init is not None else cstate["inner"]
        return upd, {"inner": inner, "residual": cstate["residual"]}, met

    def finish_update(upd, cstate, key):
        if pre_transform is not None:
            upd = pre_transform(upd, keys.fold(key, 0x9A))
        sparse, res = eftopk_compress(upd, cstate["residual"], ratio)
        return sparse, {"inner": cstate["inner"], "residual": res}

    return dataclasses.replace(
        alg, name=alg.name + "+eftopk", client_update=client_update,
        client_state_init=state_init, finish_update=finish_update)


def make_compression_transform(name: str, ratio: float = 0.05,
                               bits: int = 8) -> Optional[Callable]:
    """The round's `postprocess_update` hook, (update, key) -> update, for
    a compressor name; None for none. EF-TopK needs per-client state:
    `wrap_algorithm_with_eftopk`."""
    name = (name or "none").lower()
    if name in ("", "none", "no"):
        return None
    gen = lambda upd, key: keys.generator(key, _device(upd))  # noqa: E731
    if name == "topk":
        return lambda upd, key: topk_compress(upd, ratio)
    if name == "eftopk":
        raise ValueError(
            "'eftopk' carries a per-client residual and cannot run as a "
            "stateless transform; wrap the algorithm with "
            "wrap_algorithm_with_eftopk, or use 'topk' for the stateless "
            "variant")
    if name == "randk":
        return lambda upd, key: randk_compress(upd, ratio, gen(upd, key))
    if name == "quantize":
        return lambda upd, key: quantize_compress(upd, bits, gen(upd, key))
    if name == "qsgd":
        return lambda upd, key: qsgd_compress(upd, bits, gen(upd, key))
    raise ValueError(f"unknown compressor {name!r}; choose from {COMPRESSORS}")


# ---------------------------------------------------------------- wire codecs
def encode_sparse(vec: np.ndarray, ratio: float,
                  val_dtype=np.float32) -> dict:
    """Top-k of a flat vector as {"idx": uint16 or int32 [k], "val": [k],
    "n": size}. A zero-size vector encodes to an empty frame, a ratio that
    keeps everything to the identity index, and non-finite values are
    refused (top-k of |NaN| is undefined)."""
    flat = np.asarray(vec).ravel()
    if flat.size == 0:
        return {"idx": np.zeros(0, np.int32), "val": np.zeros(0, val_dtype),
                "n": 0}
    if not np.all(np.isfinite(flat)):
        raise ValueError(
            "encode_sparse: payload contains non-finite values (NaN/Inf) — "
            "magnitude top-k over them is undefined; clean the update "
            "before the wire")
    k = min(int(flat.size), _leaf_k(flat.size, ratio))
    # uint16 indices where the leaf fits them: 6 wire bytes a kept value
    idt = np.uint16 if flat.size <= np.iinfo(np.uint16).max + 1 else np.int32
    if k >= flat.size:
        idx = np.arange(flat.size, dtype=idt)
    else:
        idx = np.argpartition(np.abs(flat), -k)[-k:].astype(idt)
    return {"idx": idx, "val": flat[idx].astype(val_dtype),
            "n": int(flat.size)}


def decode_sparse(enc: dict) -> np.ndarray:
    """The inverse of encode_sparse; a malformed frame (index out of
    range, idx / val lengths apart) raises."""
    n = int(enc["n"])
    idx = np.asarray(enc["idx"])
    val = np.asarray(enc["val"], np.float32)
    if n < 0 or idx.shape != val.shape:
        raise ValueError(
            f"sparse frame malformed: n={n}, {idx.size} indices vs "
            f"{val.size} values")
    if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= n):
        raise ValueError(
            f"sparse frame indices out of range [0, {n}) — corrupted or "
            "mis-templated payload")
    out = np.zeros(n, np.float32)
    out[idx] = val
    return out


def _sorted_leaves(tree) -> list:
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _sorted_leaves(v)]
    return [tree]


def _rebuild(tree, it):
    if isinstance(tree, Mapping):
        vals = {k: _rebuild(tree[k], it) for k in sorted(tree)}
        return {k: vals[k] for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)


def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def encode_sparse_tree(tree, ratio: float) -> dict:
    """Per-leaf encode_sparse of a tree; integer and bool leaves ride
    dense (top-k of discrete state would corrupt it)."""
    out = []
    for leaf in _sorted_leaves(tree):
        a = _numpy(leaf)
        out.append({"dense": a, "n": int(a.size)} if a.dtype.kind not in "f"
                   else encode_sparse(a, ratio))
    return {"leaves": out}


def decode_sparse_tree(enc: dict, template):
    """The inverse of encode_sparse_tree on `template`'s structure and
    shapes (numpy leaves); a leaf count or size mismatch raises."""
    t_leaves = _sorted_leaves(template)
    if len(enc["leaves"]) != len(t_leaves):
        raise ValueError(
            f"sparse payload has {len(enc['leaves'])} leaves, template has "
            f"{len(t_leaves)} (model-version mismatch?)")
    out = []
    for tl, el in zip(t_leaves, enc["leaves"]):
        shape = tuple(np.shape(tl))
        n = int(np.prod(shape)) if shape else 1
        if int(el["n"]) != n:
            raise ValueError("sparse leaf size mismatch for template")
        if "dense" in el:
            out.append(np.asarray(el["dense"]).reshape(shape))
            continue
        if np.any(np.asarray(el["idx"]) >= n) or \
                np.any(np.asarray(el["idx"]) < 0):
            raise ValueError("sparse leaf indices out of range for template")
        out.append(decode_sparse(el).reshape(shape))
    return _rebuild(template, iter(out))
