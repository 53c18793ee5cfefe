"""One federated round on one device (port of the single-device LINEAR
path of `fedml_tpu/parallel/round.py:build_round_fn(alg, mesh=None)`).

    round_fn(server_state, client_states, data, ids, weights, seed,
             batch_idx=None) -> RoundOutput

data = {"x": [N, S, ...], "y": [N, S, ...], "mask": [N, S]} on the device;
ids [m] are the sampled clients, weights [m] their aggregation weights.
The clients train in sequence, in id order (the JAX round's G = 1 scan);
each update is folded into num += w * update and den += w in that order,
and the aggregate num / max(den, 1e-12) goes to `alg.server_update`.
Client i draws its batch order from a `torch.Generator` seeded from
(seed..., ids[i]) (`seed` an int or a tuple of ints, such as the
Simulator's (random_seed, round)) unless `batch_idx[i]` ([steps, B])
gives it. Metrics: train_loss, train_acc and n_samples over the clients
with weight > 0; with `health_stats`, also metrics["health"] =
{"update_norm", "cosine", "loss_delta"}, [m] f32 each (`_client_health`).
Health keeps every client's update, stacked per leaf ([m, ...]), until
the round ends: m x the update's size of device memory.

client_states passes through untouched (these algorithms keep none).
Meshes, client groups, FULL-mode aggregation, the update/aggregate hooks
(and so their hook state), chaos faults and per-client state are not
ported: asking for any of them raises NotImplementedError naming its
ROADMAP port-queue item.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..core.algorithm import LINEAR, FedAlgorithm, ServerState
from ..ops.tree import tree_leaves, tree_map, tree_vdot


class RoundOutput(NamedTuple):
    server_state: ServerState
    client_states: Any
    metrics: dict


def client_generator(seed, client_id: int) -> torch.Generator:
    """A CPU generator seeded from (seed..., client id): numpy's
    SeedSequence mixes them into the 32 bits the generator reads. `seed`
    is an int or a sequence of ints."""
    entropy = [int(s) for s in np.atleast_1d(seed)] + [int(client_id)]
    g = torch.Generator()
    g.manual_seed(int(np.random.SeedSequence(entropy).generate_state(1)[0]))
    return g


def _client_health(upds, agg, loss_per_client: torch.Tensor,
                   loss_sum: torch.Tensor, count: torch.Tensor) -> dict:
    """Per-client run-health stats (`fedml_tpu/parallel/round.py:72`):
    update_norm, the L2 norm of each client's update; cosine, its cosine
    with the aggregate (before any post-processing); loss_delta, each
    client's mean training loss minus the cohort's. `upds` holds the
    stacked [m, ...] updates; every sum is in f32."""
    m = loss_per_client.shape[0]
    sq = torch.zeros(m, dtype=torch.float32, device=loss_per_client.device)
    dots = torch.zeros_like(sq)
    for u, a in zip(tree_leaves(upds), tree_leaves(agg)):
        u2 = u.reshape(m, -1).float()
        sq += torch.bmm(u2[:, None, :], u2[:, :, None]).reshape(m)
        dots += u2 @ a.reshape(-1).float()
    norms = torch.sqrt(torch.clamp(sq, min=0.0))
    agg_norm = torch.sqrt(torch.clamp(tree_vdot(agg, agg), min=0.0))
    cosine = dots / torch.clamp(norms * agg_norm, min=1e-12)
    cohort = loss_sum.float() / torch.clamp(count, min=1.0)
    return {"update_norm": norms, "cosine": cosine,
            "loss_delta": loss_per_client - cohort}


def build_round_fn(alg: FedAlgorithm, mesh=None, group_size: int = 1,
                   postprocess_update=None, postprocess_agg=None,
                   health_stats: bool = False, client_dropout: float = 0.0,
                   client_straggler: float = 0.0):
    """The single-round function (module docstring has its contract)."""
    if mesh is not None:
        raise NotImplementedError(
            "round over a device mesh is not ported yet (ROADMAP 'Port "
            "queue' item 4, multi-GPU)")
    later = {
        "group_size > 1 (clients batched with torch.func.vmap)":
            (group_size != 1, "3d.1"),
        "FULL-mode aggregation": (alg.agg_mode != LINEAR, "3e"),
        "postprocess_update": (postprocess_update is not None, "3e"),
        "postprocess_agg": (postprocess_agg is not None, "3e"),
        "client_dropout / client_straggler (chaos faults)":
            (client_dropout > 0.0 or client_straggler > 0.0, "3e"),
        "per-client state": (alg.client_state_init is not None, "3c"),
    }
    asked = [(name, item) for name, (on, item) in later.items() if on]
    if asked:
        raise NotImplementedError("; ".join(
            f"{name}: not ported yet (ROADMAP 'Port queue' item {item})"
            for name, item in asked))

    def round_fn(server_state: ServerState, client_states, data: dict, ids,
                 weights, seed, batch_idx=None):
        bcast = alg.broadcast(server_state)
        dev = data["y"].device
        ids = torch.as_tensor(ids).tolist()
        m = len(ids)
        weights = torch.as_tensor(weights, dtype=torch.float32, device=dev)
        num, den = None, torch.zeros((), dtype=torch.float32, device=dev)
        msum, stack = None, None
        client_loss = torch.zeros(m, dtype=torch.float32, device=dev)
        for i, cid in enumerate(ids):
            shard = {k: v[cid] for k, v in data.items()}
            upd, _state, met = alg.client_update(
                bcast, shard, None, client_generator(seed, cid),
                None if batch_idx is None else batch_idx[i])
            w = weights[i]
            num = (tree_map(lambda u: u * w, upd) if num is None else
                   tree_map(lambda n, u: n + u * w, num, upd))
            den = den + w
            # zero-weight clients stay out of the reported metrics
            live = (w > 0).float()
            met = [met.loss_sum * live, met.correct * live,
                   met.count * live]
            msum = met if msum is None else [a + b for a, b in
                                             zip(msum, met)]
            if health_stats:
                if stack is None:
                    stack = tree_map(lambda u: torch.empty(
                        (m,) + tuple(u.shape), dtype=u.dtype,
                        device=u.device), upd)
                tree_map(lambda s, u: s[i].copy_(u), stack, upd)
                client_loss[i] = met[0].float() / torch.clamp(met[2],
                                                              min=1.0)
        agg = tree_map(lambda a: a / torch.clamp(den, min=1e-12), num)
        loss_sum, correct, count = msum
        n = torch.clamp(count, min=1.0)
        metrics = {"train_loss": loss_sum / n, "train_acc": correct / n,
                   "n_samples": count}
        if health_stats:
            metrics["health"] = _client_health(stack, agg, client_loss,
                                               loss_sum, count)
        new_server = alg.server_update(server_state, agg)
        return RoundOutput(new_server, client_states, metrics)

    return round_fn
