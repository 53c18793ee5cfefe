"""Arithmetic over nested dicts, tuples and lists of tensors: what the
round engine, its plugins and the cross-silo aggregator need of
`fedml_tpu/ops/tree.py` (map, add, sub, scale, leaves, zeros-like, the f32
dot product, squared norm and norm, the global norm clip, cast, stack,
unstack and index along a stacked axis, the weighted mean over it, and
the flattening to one vector)."""
from __future__ import annotations

from typing import Any, Callable, Mapping

import torch

Tree = Any   # a tensor, or a Mapping, tuple or list of trees


def tree_map(f: Callable, *trees: Tree) -> Tree:
    if isinstance(trees[0], Mapping):
        return {k: tree_map(f, *(t[k] for t in trees)) for k in trees[0]}
    if isinstance(trees[0], (tuple, list)):
        return type(trees[0])(tree_map(f, *xs) for xs in zip(*trees))
    return f(*trees)


def tree_leaves(t: Tree) -> list[torch.Tensor]:
    if isinstance(t, Mapping):
        return [x for v in t.values() for x in tree_leaves(v)]
    if isinstance(t, (tuple, list)):
        return [x for v in t for x in tree_leaves(v)]
    return [t]


def tree_add(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.add, a, b)


def tree_sub(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.sub, a, b)


def tree_scale(t: Tree, s) -> Tree:
    return tree_map(lambda x: x * s, t)


def tree_zeros_like(t: Tree) -> Tree:
    return tree_map(torch.zeros_like, t)


def tree_dot(a: Tree, b: Tree) -> torch.Tensor:
    """The f32 dot product of two matching trees (bf16 leaves upcast, so
    norms do not saturate)."""
    return sum(torch.dot(x.reshape(-1).float(), y.reshape(-1).float())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def tree_sq_norm(t: Tree) -> torch.Tensor:
    return tree_dot(t, t)


def tree_norm(t: Tree) -> torch.Tensor:
    """The global L2 norm of a tree, summed in f32 over every leaf."""
    return torch.sqrt(tree_sq_norm(t))


def tree_clip_by_global_norm(t: Tree, max_norm) -> Tree:
    """The tree scaled by min(1, max_norm / max(norm, 1e-12)), so that its
    global L2 norm is at most max_norm."""
    scale = torch.clamp(max_norm / torch.clamp(tree_norm(t), min=1e-12),
                        max=1.0)
    return tree_scale(t, scale)


def tree_cast(t: Tree, dtype: torch.dtype) -> Tree:
    return tree_map(lambda x: x.to(dtype), t)


def tree_stack(trees: list) -> Tree:
    """[tree, tree, ...] -> one tree with a leading stacked axis on every
    leaf."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def tree_unstack(stacked: Tree) -> list:
    """The inverse of `tree_stack`: one tree per index of the leading
    axis."""
    n = tree_leaves(stacked)[0].shape[0]
    return [tree_index(stacked, i) for i in range(n)]


def tree_index(stacked: Tree, i) -> Tree:
    return tree_map(lambda x: x[i], stacked)


def tree_weighted_mean(stacked: Tree, weights: torch.Tensor) -> Tree:
    """The weighted mean over the leading (client) axis of a stacked tree,
    FedAvg's merge, as the JAX function computes it: the weights
    normalised by max(their sum, 1e-12), cast to each leaf's dtype, then
    sum(x * w) over the axis."""
    w = weights / torch.clamp(weights.sum(), min=1e-12)

    def mean_leaf(x):
        wb = w.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)
        return (x * wb).sum(dim=0)

    return tree_map(mean_leaf, stacked)


def tree_flatten_to_vector(t: Tree) -> tuple[torch.Tensor, Callable]:
    """(the leaves raveled into one 1-D vector in `tree_leaves` order, the
    function that puts such a vector back into `t`'s structure and leaf
    shapes)."""
    leaves = tree_leaves(t)
    shapes = [x.shape for x in leaves]
    vec = (torch.cat([x.reshape(-1) for x in leaves]) if leaves
           else torch.zeros(0))

    def unflatten(v: torch.Tensor) -> Tree:
        chunks, off = [], 0
        for shape in shapes:
            chunks.append(v[off:off + shape.numel()].reshape(shape))
            off += shape.numel()
        parts = iter(chunks)
        return tree_map(lambda _x: next(parts), t)

    return vec, unflatten
