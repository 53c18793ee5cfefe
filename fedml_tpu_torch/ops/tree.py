"""Arithmetic over nested dicts, tuples and lists of tensors: what the
round engine, its plugins and the cross-silo aggregator need of
`fedml_tpu/ops/tree.py` (map, add, sub, scale, leaves, zeros-like, the f32
dot product and norm, the global norm clip, stack, the weighted mean over
a stacked axis)."""
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


def tree_vdot(a: Tree, b: Tree) -> torch.Tensor:
    """The f32 dot product of two matching trees (bf16 leaves upcast, so
    norms do not saturate)."""
    return sum(torch.dot(x.reshape(-1).float(), y.reshape(-1).float())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def tree_norm(t: Tree) -> torch.Tensor:
    """The global L2 norm of a tree, summed in f32 over every leaf."""
    return torch.sqrt(tree_vdot(t, t))


def tree_clip_by_global_norm(t: Tree, max_norm) -> Tree:
    """The tree scaled by min(1, max_norm / max(norm, 1e-12)), so that its
    global L2 norm is at most max_norm."""
    scale = torch.clamp(max_norm / torch.clamp(tree_norm(t), min=1e-12),
                        max=1.0)
    return tree_scale(t, scale)



def tree_stack(trees: list) -> Tree:
    """[tree, tree, ...] -> one tree with a leading stacked axis on every
    leaf."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


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
