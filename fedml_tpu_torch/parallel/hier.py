"""The hierarchical federated round over a 2-D (silos, intra) mesh (port of
`fedml_tpu/parallel/hier.py`; reference: python/fedml/__init__.py:342-390,
process_group_manager.py:8, fedml_trainer_dist_adapter.py:9: torch DDP
inside the silos, FedAvg across them).

    mesh = make_mesh({"silos": n_silos, "intra": k})     # every rank calls

- `silos` is the federated axis: the sampled clients (silos) split over
  it in contiguous blocks, and the weighted sums of the updates are summed
  across it with one all-reduce (the outer level).
- `intra` is the data-parallel axis: each client's samples split over it
  (`shard_hier_data`), and each local step's gradient is all-reduced over
  it (the inner level).

The inner step (`hier_local_sgd`) sums the objective over the rank's rows
(its mean times its count, so every task head works), all-reduces the
gradient together with the loss, correct and count sums in one
collective, and divides by the global count: the update is the flat
batch-mean gradient's, step for step. Every intra rank draws the same
local batch positions (the client's key (seed..., id), as each JAX intra
device draws from the same key), so the global batch is their union.
Parameters stay replicated over `intra`, since every rank applies the same
reduced update. `allreduce_steps` counts the inner all-reduces of this
process.

The round re-derives the client step itself, so it takes exactly the
plain-delta algorithms, FedAvg and FedOpt, and gives JAX's error for any
other; algorithms with per-step corrections, structured payloads or FULL
aggregation run on the flat round (`parallel/round.py`).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from ..core.algorithm import (
    ClientOptimizer, FedAlgorithm, ServerState, make_batch_indices,
    masked_softmax_ce,
)
from ..ops.tree import tree_leaves, tree_map
from . import mesh as mesh_mod
from .round import client_generator, to_device

Pytree = Any

allreduce_steps = 0   # inner (data-axis) all-reduces run in this process


def hier_local_sgd(apply_fn: Callable, params: Pytree, shard: dict,
                   batch_idx: torch.Tensor, opt: ClientOptimizer, mesh,
                   data_axis: str, objective: Optional[Callable] = None):
    """Data-parallel local SGD in one rank of `data_axis`: `shard` is the
    rank's rows, `batch_idx` [steps, b] the rank's positions in them each
    step (module docstring). Returns (params, (loss sum, correct, count))
    summed over the axis and the steps."""
    global allreduce_steps
    obj = objective or masked_softmax_ce

    def loss_sum(p, x, y, mask):
        loss, correct, count = obj(apply_fn(p, x), y, mask)
        return loss * count, (loss * count, correct, count)

    grad = torch.func.grad(loss_sum, has_aux=True)
    state = opt.init(params)
    p = params
    tot = torch.zeros(3, dtype=torch.float32, device=shard["y"].device)
    for t in range(batch_idx.shape[0]):
        idx = batch_idx[t]
        g, aux = grad(p, shard["x"][idx], shard["y"][idx], shard["mask"][idx])
        stats = torch.stack([a.float() for a in aux])
        mesh_mod.all_reduce_sum(tree_leaves(g) + [stats], mesh, data_axis)
        allreduce_steps += 1
        denom = torch.clamp(stats[2], min=1.0)
        g = tree_map(lambda a: a / denom.to(a.dtype), g)
        p, state = opt.step(p, g, state, t + 1)
        tot = tot + stats
    return p, tuple(tot)


def make_hier_round(apply_fn: Callable, alg: FedAlgorithm, mesh,
                    opt: ClientOptimizer, batch_size: int, epochs: int,
                    client_axis: str = "silos", data_axis: str = "intra",
                    objective: Optional[Callable] = None) -> Callable:
    """The hierarchical round, run SPMD in every rank of `mesh`:

        round_fn(server_state, data, ids, weights, seed, batch_idx=None)
            -> (server_state, metrics)

    data is this rank's slice of the stacked client data
    (`shard_hier_data`: every client, the rank's samples), ids [m] the
    sampled clients (m divisible by the silos axis), weights [m] their
    aggregation weights. `batch_size` is the global per-silo batch; each
    intra rank takes batch_size // intra positions a step in its slice,
    client i's drawn from (seed..., ids[i]) unless `batch_idx[i]`
    ([steps, batch_size // intra], the same on every intra rank) is
    given."""
    if alg.name not in ("FedAvg", "FedOpt"):
        raise ValueError(
            f"hierarchical rounds support plain-delta algorithms "
            f"(FedAvg/FedOpt), not {alg.name!r}; use parallel/round.py's flat "
            "client-parallel path for algorithms with per-step corrections "
            "or structured payloads")
    mesh_mod.check_mesh(mesh, "the hierarchical round's mesh")
    n_intra = mesh_mod.axis_size(mesh, data_axis)
    if batch_size % n_intra:
        raise ValueError(
            f"batch_size={batch_size} must be divisible by the {data_axis!r} "
            f"axis size {n_intra} (each intra device takes an equal slice of "
            "every step's batch)")
    b_loc = batch_size // n_intra

    def round_fn(server_state: ServerState, data: dict, ids, weights, seed,
                 batch_idx=None):
        bcast = alg.broadcast(server_state)
        base = bcast["params"]
        ids = np.asarray(ids)
        weights = np.asarray(weights, np.float32)
        share = mesh_mod.client_share(mesh, len(ids), client_axis)
        dev = data["y"].device
        s_loc = data["y"].shape[1]
        num = tree_map(torch.zeros_like, base)
        sums = torch.zeros(4, dtype=torch.float32, device=dev)
        for j in range(share.start, share.stop):
            cid = int(ids[j])
            idx = (make_batch_indices(client_generator(seed, cid), s_loc,
                                      b_loc, epochs)
                   if batch_idx is None else torch.as_tensor(batch_idx[j]))
            shard = {k: v[cid] for k, v in data.items()}
            p, (lsum, correct, cnt) = hier_local_sgd(
                apply_fn, base, shard, to_device(idx, dev), opt, mesh,
                data_axis, objective)
            w = torch.tensor(weights[j], device=dev)
            num = tree_map(lambda n, a, b: n + (a - b) * w.to(a.dtype), num,
                           p, base)
            live = (w > 0).float()
            sums = sums + torch.stack([w, lsum * live, correct * live,
                                       cnt * live])
        # the outer level: the weighted mean across every silo
        mesh_mod.all_reduce_sum(tree_leaves(num) + [sums], mesh, client_axis)
        den = torch.clamp(sums[0], min=1e-12)
        agg = tree_map(lambda a: a / den.to(a.dtype), num)
        new_server = alg.server_update(server_state, agg)
        n = torch.clamp(sums[3], min=1.0)
        return new_server, {"train_loss": sums[1] / n,
                            "train_acc": sums[2] / n, "n_samples": sums[3]}

    return round_fn


def shard_hier_data(data: dict, mesh, data_axis: str = "intra",
                    device="cpu") -> dict:
    """This rank's layout of the stacked client data on the 2-D mesh: every
    client (the round gathers its cohort by id), and the rank's contiguous
    block of each client's samples along `data_axis` (S must divide)."""
    out = {}
    for k, v in data.items():
        sh = mesh_mod.client_share(mesh, v.shape[1], data_axis)
        out[k] = torch.from_numpy(np.ascontiguousarray(v[:, sh])).to(device)
    return out
