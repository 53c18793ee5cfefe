"""FedLLM: federated LoRA fine-tuning of the LLaMA-shaped LM (port of
`fedml_tpu/llm/__init__.py`).

Two compositions:

1. `federated_lora(...)`, the flat path: the adapters ARE the federated
   model. The round engine (`parallel/round.py`) and FedAvg train and
   exchange only the adapter dict, and the base weights never move.
   Gradients come from `torch.func.grad`, so the round vmaps a group of
   clients (`build_round_fn(group_size > 1)`).
2. `make_fedllm_seq_round(...)`, the long-context path: one round over a
   (silos, seq) `DeviceMesh`. Clients are split over `silos`; each
   client's token dimension is split over `seq`, and attention runs as
   ring or Ulysses attention (`parallel/seq.py`) across the seq group.
   Per-step adapter gradients are summed over `seq` (exact: sum-CE
   gradients divided by the global token count), and the aggregate is
   the weight-premultiplied sum over `silos`.

Sequence-parallel data layout: {"x": [N, S, T], "y": [N, S, T],
"mask": [N, S]}; `shard_fedllm_data` gives a rank its block.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..algorithms.builtin import make_fedavg
from ..config import TrainArgs
from ..core.algorithm import (
    FedAlgorithm, ServerState, make_batch_indices, make_client_optimizer,
)
from ..models.hub import mixed_precision_apply
from ..ops.tree import tree_leaves, tree_map
from ..parallel import mesh as mesh_mod
from ..parallel.seq import ring_attention, ulysses_attention
from .lora import count_params, lora_apply_fn, lora_init, lora_merge
from .quant import is_q, make_inscan_quant_apply
from .transformer import TransformerLM

__all__ = ["TransformerLM", "lora_init", "lora_merge", "lora_apply_fn",
           "count_params", "federated_lora", "make_fedllm_seq_round",
           "shard_fedllm_data"]


def federated_lora(model: TransformerLM, base_state: dict, t: TrainArgs,
                   generator, rank: int = 8, alpha: float = 16.0,
                   targets=("wq", "wk", "wv", "wo")
                   ) -> tuple[FedAlgorithm, dict]:
    """(FedAvg over adapters, initial adapters). `base_state` is the
    model's own state (`TransformerLM.from_state`); the adapters' A is
    drawn from `generator`. `t.compute_dtype` is honoured as in the JAX
    function: the model runs under `mixed_precision_apply`, the adapters
    and the optimizer stay f32. Gradients come from `torch.func.grad`
    (the flash attention and the per-block remat take it), so the
    algorithm runs in vmapped client groups."""
    own = model.state_dict()
    if own.keys() != base_state.keys() or any(
            own[k].data_ptr() != v.data_ptr() for k, v in base_state.items()):
        raise ValueError("base_state must be the model's own state "
                         "(build the model with TransformerLM.from_state)")
    adapters = lora_init(base_state, rank, targets, generator=generator)
    base_apply = mixed_precision_apply(model, t.compute_dtype)
    return make_fedavg(lora_apply_fn(base_apply, alpha), t), adapters


def _seq_attn(attn: str, mesh, seq_axis: str, n_heads: int):
    n_seq = mesh_mod.axis_size(mesh, seq_axis)
    if attn == "ring":
        return functools.partial(ring_attention, mesh=mesh, axis=seq_axis)
    if attn == "ulysses":
        if n_heads % n_seq:
            raise ValueError(
                f"ulysses needs n_heads ({n_heads}) divisible by the "
                f"{seq_axis!r} axis size ({n_seq}); use attn='ring'")
        return functools.partial(ulysses_attention, mesh=mesh,
                                 axis=seq_axis)
    raise ValueError(f"attn must be 'ring' or 'ulysses', got {attn!r}")


def _check_inscan_base(base_state) -> None:
    """inscan_quant's preconditions, raised here and not deep in the first
    step: an int8 base (`quant.quantize_tree_int8` of the port's state,
    the counterpart of JAX's scan_layers check) in the per-layer
    `blocks.{i}` layout."""
    if not isinstance(base_state, dict) or not any(
            k.startswith("blocks.") for k in base_state):
        raise ValueError(
            "inscan_quant=True needs base_state in the per-layer "
            "'blocks.{i}.*' layout (the port's state dict, optionally int8 "
            "via quant.quantize_tree_int8); got keys "
            f"{sorted(base_state)[:6] if isinstance(base_state, dict) else type(base_state)}")
    if not any(is_q(v) for v in base_state.values()):
        raise ValueError(
            "inscan_quant=True needs an int8 base: base_state from "
            "quant.quantize_tree_int8 (its forward dequantises one layer "
            "at a time); pass inscan_quant=False for a float base")


def make_fedllm_seq_round(model: TransformerLM, base_state: dict,
                          t: TrainArgs, mesh, alpha: float = 16.0,
                          client_axis: str = "silos", seq_axis: str = "seq",
                          attn: str = "ring", inscan_quant: bool = False):
    """The long-context federated LoRA round over a (silos, seq)
    `DeviceMesh`, run SPMD in every rank of the mesh:

        round_fn(server_state, data, ids, weights, seed, batch_idx=None)
            -> (server_state, metrics)

    `model` gives the dims (a `TransformerLM`); `base_state` is the frozen
    base, bound here (the JAX round takes it each call to donate it);
    server_state.params is the adapter dict, the same in every rank;
    `data` is this rank's block from `shard_fedllm_data`; ids / weights
    are the whole cohort's, as in the flat round. Silo rank k trains the
    cohort's k-th contiguous block of ids in sequence (the JAX
    `shard_map` split, each silo's clients a `lax.scan`), whose rows must
    lie in its data block. Client i's batch order is batch_idx[i]
    ([steps, B], the tests hand over JAX's) or `make_batch_indices` of
    `parallel.round.client_generator(seed, ids[i])`.

    attn: "ring" (K/V rotated over the seq group) or "ulysses" (heads
    scattered by all-to-all; n_heads % seq size == 0). inscan_quant: the
    forward is `quant.make_inscan_quant_apply` over an int8 base
    (remat per block), the long-context 7B layout; otherwise the float
    base with the adapters merged in each block, as `federated_lora`
    runs it. RoPE and the causal mask use global positions
    (pos_offset = seq index x T_local). Each local step's loss is the
    token-summed cross-entropy; its gradients, loss, correct and token
    sums are summed over `seq` and the gradients divided by the step's
    global token count, then the client optimizer steps (SGD with
    `t.momentum`). The round's aggregate is sum_i w_i (a_i - a_0) /
    max(sum_i w_i, 1e-12) over `silos`, added to the adapters. Metrics:
    train_loss and train_acc over every real token, n_tokens."""
    mesh_mod.check_mesh(mesh, "make_fedllm_seq_round's mesh")
    attn_fn = _seq_attn(attn, mesh, seq_axis, model.n_heads)
    if inscan_quant:
        _check_inscan_base(base_state)
        dtype = getattr(torch, t.compute_dtype)
        qmodel = TransformerLM.from_state(model.dims, base_state,
                                          attn_fn=attn_fn, remat=True)
        inscan = make_inscan_quant_apply(model.n_heads, alpha=alpha,
                                         dtype=dtype)

        def logits_fn(a, x, off):
            return inscan(qmodel, a, x, pos_offset=off).float()
    else:
        spmodel = TransformerLM.from_state(model.dims, base_state,
                                           attn_fn=attn_fn)
        sp_apply = mixed_precision_apply(spmodel, t.compute_dtype)

        def logits_fn(a, x, off):
            return sp_apply(x, pos_offset=off, adapters=a, alpha=alpha)

    opt = make_client_optimizer("sgd", t.learning_rate, t.momentum)
    seq_idx = mesh_mod.axis_index(mesh, seq_axis)

    def local_lora_sgd(ad0, shard, batch_idx, t_loc):
        """Local SGD on the adapters; each step's sums all-reduced over
        `seq` (one all-reduce a step)."""
        off = seq_idx * t_loc
        ad = ad0
        state = opt.init(ad)
        sums = torch.zeros(3, dtype=torch.float32)
        for step in range(batch_idx.shape[0]):
            idx = batch_idx[step]
            x, y, msk = shard["x"][idx], shard["y"][idx], shard["mask"][idx]
            p = tree_map(lambda v: v.detach().requires_grad_(True), ad)
            with torch.enable_grad():
                logits = logits_fn(p, x, off)
                ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                     y.reshape(-1).long(),
                                     reduction="none").reshape(y.shape)
                m = msk[:, None]
                lsum = (ce * m).sum()
                grads = torch.autograd.grad(lsum, tree_leaves(p))
            correct = ((logits.argmax(-1) == y) * m).sum()
            stats = torch.stack([lsum.detach(), correct.float(),
                                 msk.sum() * t_loc])
            flat = list(grads) + [stats]
            mesh_mod.all_reduce_sum(flat, mesh, seq_axis)
            denom = torch.clamp(stats[2], min=1.0)
            g_iter = iter(g / denom for g in flat[:-1])
            g_tree = tree_map(lambda _v: next(g_iter), p)
            ad, state = opt.step(ad, g_tree, state, step + 1)
            sums = sums + stats.cpu()
        return ad, sums

    def round_fn(server_state: ServerState, data: dict, ids, weights,
                 seed, batch_idx=None):
        from ..parallel.round import client_generator

        ids = np.asarray(ids)
        weights = np.asarray(weights, np.float32)
        share = mesh_mod.client_share(mesh, len(ids), client_axis)
        n_local = data["x"].shape[0]
        first = mesh_mod.axis_index(mesh, client_axis) * n_local
        rows = ids[share] - first
        if ((rows < 0) | (rows >= n_local)).any():
            raise ValueError(
                f"silo rank {mesh_mod.axis_index(mesh, client_axis)} trains "
                f"clients {ids[share].tolist()}, but its data block "
                f"(shard_fedllm_data) holds clients [{first}, "
                f"{first + n_local})")
        s_count, t_loc = data["y"].shape[1], data["y"].shape[2]
        bs = min(t.batch_size, s_count)
        ad0 = server_state.params
        num = tree_map(torch.zeros_like, ad0)
        den = torch.zeros((), dtype=torch.float32)
        mets = torch.zeros(3, dtype=torch.float32)
        for j, (i, row) in enumerate(zip(np.arange(len(ids))[share], rows)):
            shard = {k: v[int(row)] for k, v in data.items()}
            idx = (torch.as_tensor(batch_idx[i]) if batch_idx is not None
                   else make_batch_indices(client_generator(seed,
                                                            int(ids[i])),
                                           s_count, bs, t.epochs))
            ad, sums = local_lora_sgd(ad0, shard,
                                      idx.to(data["x"].device), t_loc)
            w = float(weights[i])
            num = tree_map(lambda n_, a, a0: n_ + (a - a0) * w, num, ad, ad0)
            den = den + w
            mets = mets + sums * float(w > 0)
        dev = tree_leaves(ad0)[0].device
        den_t, mets_t = den.to(dev), mets.to(dev)
        flat = tree_leaves(num) + [den_t, mets_t]
        mesh_mod.all_reduce_sum(flat, mesh, client_axis)
        agg = tree_map(lambda n_: n_ / torch.clamp(den_t, min=1e-12), num)
        new_state = dataclasses.replace(
            server_state, params=tree_map(torch.add, ad0, agg),
            round=server_state.round + 1)
        lsum, correct, cnt = mets_t
        n = torch.clamp(cnt, min=1.0)
        return new_state, {"train_loss": lsum / n, "train_acc": correct / n,
                           "n_tokens": cnt}

    return round_fn


def shard_fedllm_data(data: dict, mesh, client_axis: str = "silos",
                      seq_axis: str = "seq", device=None) -> dict:
    """This rank's block of {"x": [N, S, T], "y": [N, S, T], "mask":
    [N, S]} (host arrays or tensors): the contiguous clients of its silo
    coordinate and the contiguous token chunk of its seq coordinate, the
    block JAX's P(silos, None, seq) placement gives a device; tokens
    int64, mask f32, on `device` (CUDA unless "cpu"). N and T must divide
    by the axis sizes."""
    from .._device import resolve_device

    dev = resolve_device(device)
    ns = mesh_mod.axis_size(mesh, client_axis)
    nq = mesh_mod.axis_size(mesh, seq_axis)
    n, _s, t = np.shape(data["x"])
    if n % ns or t % nq:
        raise ValueError(
            f"[{n} clients, {t} tokens] do not split over {client_axis!r} "
            f"({ns}) and {seq_axis!r} ({nq})")
    ci = mesh_mod.axis_index(mesh, client_axis)
    qi = mesh_mod.axis_index(mesh, seq_axis)
    rows = slice(ci * (n // ns), (ci + 1) * (n // ns))
    toks = slice(qi * (t // nq), (qi + 1) * (t // nq))

    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(
            device=dev, dtype=dtype)

    return {"x": put(np.asarray(data["x"])[rows, :, toks], torch.int64),
            "y": put(np.asarray(data["y"])[rows, :, toks], torch.int64),
            "mask": put(np.asarray(data["mask"])[rows], torch.float32)}
