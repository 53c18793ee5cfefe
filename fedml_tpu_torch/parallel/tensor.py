"""Tensor parallelism's collectives over one axis of a `DeviceMesh`: the
Megatron operators the JAX package leaves to GSPMD, written out.

A `TPContext` names the axis (`mesh`, `axis`, this rank's `index` of
`size`). Each operator is an identity when the context is None or the
axis has one rank, so a one-rank mesh computes bit for bit what the
unmeshed path computes. Otherwise:

- `copy_in(x)`: identity forward, all-reduce (sum) backward. It sits in
  front of a column-split product, whose input gradient each rank sees
  only through its own output columns (Megatron's f).
- `reduce_out(x)`: all-reduce forward, identity backward. It follows a
  row-split product, whose output each rank holds as a partial sum
  (Megatron's g).
- `gather(x, dim)`: all-gather along `dim` forward; the backward keeps
  this rank's block of the gradient, which every rank holds whole and
  identical (the computation after the gather is replicated). It
  assembles the embedding's columns, the LM head's logits and a
  column-split Dense / Conv's output channels.

Each is an `autograd.Function` with a `setup_context`, so that
`torch.func.grad` and `vjp` take it (not `vmap`: a collective moves a
whole tensor, not a batch member's slice); a backward that needs a
collective calls another of these functions, whose forward then gets
plain tensors even under `torch.func.vjp` (the pattern of
`parallel/seq.py:_Rotate`).
"""
from __future__ import annotations

import torch

from . import mesh as mesh_mod


class TPContext:
    """The tensor-parallel axis of a mesh, as this rank sees it."""

    def __init__(self, mesh, axis: str = "tp"):
        names = tuple(mesh.mesh_dim_names or ())
        if axis not in names:
            raise ValueError(f"mesh axes {names} have no {axis!r} axis")
        self.mesh, self.axis = mesh, axis
        self.size = mesh_mod.axis_size(mesh, axis)
        self.index = mesh_mod.axis_index(mesh, axis)

    def block(self, n: int) -> slice:
        """This rank's contiguous block of n entries (n must divide)."""
        if n % self.size:
            raise ValueError(f"{n} does not split over the {self.size} "
                             f"ranks of mesh axis {self.axis!r}")
        b = n // self.size
        return slice(self.index * b, (self.index + 1) * b)

    def __repr__(self) -> str:
        return (f"TPContext(axis={self.axis!r}, size={self.size}, "
                f"index={self.index})")


def _on(tp) -> bool:
    return tp is not None and tp.size > 1


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(tp, x):
        return mesh_mod.all_reduce(x, tp.mesh, tp.axis)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return None, g


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(tp, x):
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.tp = inputs[0]

    @staticmethod
    def backward(ctx, g):
        return None, _ReduceOut.apply(ctx.tp, g)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(tp, x, dim):
        return mesh_mod.all_gather_dim(x, tp.mesh, tp.axis, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.tp, _x, ctx.dim = inputs

    @staticmethod
    def backward(ctx, g):
        n = g.shape[ctx.dim] // ctx.tp.size
        return None, g.narrow(ctx.dim, ctx.tp.index * n, n), None


def copy_in(x: torch.Tensor, tp) -> torch.Tensor:
    return _CopyIn.apply(tp, x) if _on(tp) else x


def reduce_out(x: torch.Tensor, tp) -> torch.Tensor:
    return _ReduceOut.apply(tp, x) if _on(tp) else x


def gather(x: torch.Tensor, tp, dim: int = -1) -> torch.Tensor:
    if not _on(tp):
        return x
    return _Gather.apply(tp, x, dim % x.dim())
