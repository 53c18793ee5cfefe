"""Tensor parallelism for the TransformerLM (port of `fedml_tpu/llm/tp.py`).

The JAX package annotates the Megatron layout on the weights and lets
GSPMD insert the collectives. The port holds on each rank of a `tp` axis
only its shard of every weight and writes the collectives out
(`parallel/tensor.py`), over that axis of a `DeviceMesh`:

    wq/wk/wv, w_gate/w_up : [D, F]  column blocks, P(None, tp)
    wo, w_down            : [F, D]  row blocks,    P(tp, None)
    embed                 : [V, D]  column blocks, then an all-gather on D
    lm_head               : [D, V]  column blocks, then an all-gather on V
    norms / LoRA adapters : replicated

A block runs its `H / tp` heads and its `d_ff / tp` columns, with one
all-reduce after wo and one after w_down (`llm/quant.py` block helpers);
the gradients follow Megatron's f / g pair. The shard is a
`TransformerLM(tp=TPContext(mesh, axis))` built over the rank's state
(`tp_model`), so the training forward, the decode functions and the
serving engine all run it unchanged. Replicated adapters are cut to the
shard inside each block (`quant.local_adapter`); each rank then holds
only its slice's share of an adapter gradient, so a trainer sums the
adapter gradients over `tp` once a step (`llm/scale.py` does).

Every function here runs SPMD, the same call in every rank of the mesh.
The batch a rank trains on is its `dp` block of the global batch (or the
whole batch with `dp_axis=None`).
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from ..parallel import mesh as mesh_mod
from ..parallel import partition
from ..parallel.tensor import TPContext
from .quant import flat_state
from .transformer import ModelDims, TransformerLM

Pytree = Any


def tp_param_specs(params: Pytree, axis: str = "tp") -> Pytree:
    """PartitionSpec tree for TransformerLM params (same structure).

    DEPRECATED entry point: a shim over the partition-rule registry's
    `transformer_lm` table (`parallel.partition.resolve`), which the
    serving engine, the centralized trainer and the round programs
    resolve through. It keeps the old behaviour of replicating params the
    table misses (`on_unmatched="replicated"`); the registry's default
    is a hard error. Both spellings resolve: flax trees (unrolled,
    scan-stacked, int8 {q, s}) and the port's state-dict names."""
    return partition.resolve("transformer_lm", params, axis=axis,
                             on_unmatched=partition.REPLICATED)


def shard_params_tp(params: Pytree, mesh, axis: str = "tp") -> Pytree:
    """This rank's shard of `params` under the Megatron layout over
    `axis` (a state dict stays a state dict; an int8 {q, s} leaf a dict of
    its two blocks)."""
    return partition.shard_params(params, mesh, axis=axis,
                                  specs=tp_param_specs(params, axis))


def dims_of(model) -> ModelDims:
    return model if isinstance(model, ModelDims) else model.dims


def tp_model(model, shard: Pytree, mesh, axis: str = "tp",
             **kw) -> TransformerLM:
    """The rank's `TransformerLM` over its `shard` (`shard_params_tp`),
    running the split forward over `axis`. `model` (a TransformerLM or
    its ModelDims) gives the full dims; `kw` (attn_fn, remat, eps) go to
    the constructor."""
    return TransformerLM.from_state(dims_of(model), shard,
                                    tp=TPContext(mesh, axis), **kw)


def _rows(tokens: torch.Tensor, mesh, dp_axis: Optional[str]):
    """This rank's dp block of a global batch."""
    if not dp_axis or mesh_mod.axis_size(mesh, dp_axis) == 1:
        return tokens
    return tokens[mesh_mod.client_share(mesh, tokens.shape[0], dp_axis)]


def make_tp_forward(model, mesh, dp_axis: Optional[str] = "dp",
                    axis: str = "tp"):
    """fwd(shard, tokens) -> logits [B, T, V] of the global batch: the
    rank runs its dp block of `tokens` (the whole batch when dp_axis is
    None) through its shard, and the blocks are gathered over dp."""

    def fwd(shard, tokens):
        m = tp_model(model, shard, mesh, axis)
        out = m(_rows(tokens, mesh, dp_axis))
        if dp_axis and mesh_mod.axis_size(mesh, dp_axis) > 1:
            out = mesh_mod.all_gather_rows(out, mesh, dp_axis)
        return out

    return fwd


def make_tp_train_step(model, mesh, lr: float = 1e-2,
                       dp_axis: Optional[str] = "dp", axis: str = "tp"):
    """step(shard, tokens, targets) -> (shard, loss): one SGD step of every
    parameter on this rank's shard, over the global batch's mean
    cross-entropy. The rank computes its dp block; gradients (and the
    loss) are summed over dp. A column / row block's gradient is the
    block's own, and a replicated parameter's is whole on every rank (the
    f / g pair), so nothing is reduced over `axis`."""
    cache: dict = {}

    def step(shard, tokens, targets):
        flat = flat_state(shard)
        if "model" not in cache:
            cache["model"] = tp_model(model, flat, mesh, axis)
        m = cache["model"]
        x, y = _rows(tokens, mesh, dp_axis), _rows(targets, mesh, dp_axis)
        n_global = float(targets.numel())

        def loss_fn(p):
            logits = torch.func.functional_call(m, p, (x,))
            ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                                 y.reshape(-1).long(), reduction="sum")
            return ce / n_global, ce.detach()

        grads, lsum = torch.func.grad(loss_fn, has_aux=True)(flat)
        if dp_axis and mesh_mod.axis_size(mesh, dp_axis) > 1:
            keys = sorted(grads)
            vals = [grads[k] for k in keys] + [lsum.reshape(1)]
            mesh_mod.all_reduce_sum(vals, mesh, dp_axis)
            grads = dict(zip(keys, vals[:-1]))
            lsum = vals[-1][0]
        new = {k: (v - lr * grads[k]).detach() for k, v in flat.items()}
        return new, lsum / n_global

    return step
