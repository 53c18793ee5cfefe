"""One federated round on one device (port of the single-device LINEAR
path of `fedml_tpu/parallel/round.py:build_round_fn(alg, mesh=None)`).

    round_fn(server_state, client_states, data, ids, weights, seed,
             batch_idx=None) -> RoundOutput

data = {"x": [N, S, ...], "y": [N, S, ...], "mask": [N, S]} on the device;
ids [m] are the sampled clients, weights [m] their aggregation weights.
The clients train in sequence, in id order; each update is folded into
num += w * update and den += w in that order, and the aggregate
num / max(den, 1e-12) goes to `alg.server_update`. Client i draws its
batch order from a `torch.Generator` seeded from (seed, ids[i]) unless
`batch_idx[i]` ([steps, B]) gives it. Metrics: train_loss, train_acc and
n_samples over the clients with weight > 0.

client_states passes through untouched (FedAvg keeps none). Meshes,
client groups, FULL-mode aggregation, the update/aggregate hooks (and so
their hook state), health stats and chaos faults are not ported: asking
for any of them raises NotImplementedError naming its ROADMAP port-queue
item.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..core.algorithm import LINEAR, FedAlgorithm, ServerState
from ..ops.tree import tree_map


class RoundOutput(NamedTuple):
    server_state: ServerState
    client_states: Any
    metrics: dict


def client_generator(seed: int, client_id: int) -> torch.Generator:
    """A CPU generator seeded from (round seed, client id). numpy's
    SeedSequence mixes both into the 32 bits the CPU generator reads."""
    g = torch.Generator()
    g.manual_seed(int(np.random.SeedSequence(
        [int(seed), int(client_id)]).generate_state(1)[0]))
    return g


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
        "group_size > 1": group_size != 1,
        "FULL-mode aggregation": alg.agg_mode != LINEAR,
        "postprocess_update": postprocess_update is not None,
        "postprocess_agg": postprocess_agg is not None,
        "health_stats": health_stats,
        "client_dropout / client_straggler":
            client_dropout > 0.0 or client_straggler > 0.0,
        "per-client state": alg.client_state_init is not None,
    }
    asked = [name for name, on in later.items() if on]
    if asked:
        raise NotImplementedError(
            f"{', '.join(asked)}: not ported yet (ROADMAP 'Port queue' item "
            "3, the FedAvg simulation path)")

    def round_fn(server_state: ServerState, client_states, data: dict, ids,
                 weights, seed: int, batch_idx=None):
        bcast = alg.broadcast(server_state)
        dev = data["y"].device
        weights = torch.as_tensor(weights, dtype=torch.float32, device=dev)
        num, den = None, torch.zeros((), dtype=torch.float32, device=dev)
        msum = None
        for i, cid in enumerate(torch.as_tensor(ids).tolist()):
            shard = {k: v[cid] for k, v in data.items()}
            upd, _state, met = alg.client_update(
                bcast, shard, None, client_generator(seed, cid),
                None if batch_idx is None else batch_idx[i])
            w = weights[i]
            num = (tree_map(lambda u: u * w, upd) if num is None else
                   tree_map(lambda n, u: n + u * w, num, upd))
            den = den + w
            live = (w > 0).float()
            met = [met.loss_sum * live, met.correct * live,
                   met.count * live]
            msum = met if msum is None else [a + b for a, b in
                                             zip(msum, met)]
        agg = tree_map(lambda a: a / torch.clamp(den, min=1e-12), num)
        new_server = alg.server_update(server_state, agg)
        loss_sum, correct, count = msum
        n = torch.clamp(count, min=1.0)
        metrics = {"train_loss": loss_sum / n, "train_acc": correct / n,
                   "n_samples": count}
        return RoundOutput(new_server, client_states, metrics)

    return round_fn
