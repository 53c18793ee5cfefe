"""Arithmetic over nested dicts of tensors: what the round engine needs of
`fedml_tpu/ops/tree.py` (map, add, sub, scale, leaves, zeros-like, the
f32 dot product)."""
from __future__ import annotations

from typing import Any, Callable, Mapping

import torch

Tree = Any   # a tensor or a Mapping of trees


def tree_map(f: Callable, *trees: Tree) -> Tree:
    if isinstance(trees[0], Mapping):
        return {k: tree_map(f, *(t[k] for t in trees)) for k in trees[0]}
    return f(*trees)


def tree_leaves(t: Tree) -> list[torch.Tensor]:
    if isinstance(t, Mapping):
        return [x for v in t.values() for x in tree_leaves(v)]
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
