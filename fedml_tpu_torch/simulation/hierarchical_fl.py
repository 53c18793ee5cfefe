"""Two-tier hierarchical FL (HierFL): group rounds inside global rounds
(port of `fedml_tpu/simulation/hierarchical_fl.py`; reference:
simulation/sp/hierarchical_fl/trainer.py:10).

Clients are assigned to groups at random; each global round every group
starts from the global model and runs `group_comm_round` FedAvg rounds
among its sampled clients, then the server averages the group models
weighted by the groups' sample counts. Both tiers are FedAvg, and the
inner tier is the flat round engine (`parallel/round.py`), one round a
call with the group's sampled clients as ids.

Draws: group assignment and sampling are numpy's (bitwise JAX's). A
sub-round's client batch orders come from generators keyed (seed, R, gi,
r, client id), where JAX folds R, gi and r into its key;
`batch_schedule(R, gi, r)` returns a sub-round's [m, steps, B] orders
instead (the tests hand JAX's over).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..core.algorithm import FedAlgorithm
from ..ops.tree import tree_stack, tree_weighted_mean
from ..parallel.round import build_round_fn


def assign_groups(n_clients: int, n_groups: int, method: str = "random",
                  seed: int = 0) -> list[np.ndarray]:
    """Client -> group assignment (reference: trainer.py group_method
    'random', np.random.randint over the groups); empty groups dropped."""
    if method != "random":
        raise ValueError(f"unknown group_method {method!r} (reference "
                         "supports 'random')")
    rs = np.random.RandomState(seed)
    idx = rs.randint(0, n_groups, n_clients)
    groups = [np.where(idx == g)[0].astype(np.int32)
              for g in range(n_groups)]
    return [g for g in groups if g.size]


class HierFLRunner:
    """Global rounds of (per-group FedAvg sub-rounds -> weighted merge).
    `data` is {"x", "y", "mask"} stacked [N, S, ...]; `params` the initial
    global parameters; `group_size` the sub-rounds' vmapped client groups
    (`build_round_fn`'s G; JAX's runner has no such knob and runs one
    program a sub-round); `device` CUDA unless the caller names "cpu"."""

    def __init__(self, alg: FedAlgorithm, params: dict, data: dict,
                 counts: np.ndarray, n_groups: int = 2,
                 group_comm_round: int = 2,
                 clients_per_group_round: Optional[int] = None,
                 seed: int = 0, group_size: int = 1, device=None):
        self.alg = alg
        self.device = resolve_device(device)
        self.data = {k: torch.as_tensor(np.asarray(v)).to(self.device)
                     for k, v in data.items()}
        self.counts = np.asarray(counts, np.float32)
        self.groups = assign_groups(len(counts), n_groups, seed=seed)
        self.group_comm_round = group_comm_round
        self.m = clients_per_group_round
        self.seed = seed
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.round_fn = build_round_fn(alg, mesh=None, group_size=group_size)
        self.history: list[dict] = []

    def _sample(self, group: np.ndarray, global_r: int, sub_r: int):
        m = self.m or len(group)
        if m >= len(group):
            return group
        rs = np.random.RandomState(self.seed + 1000 * global_r + sub_r)
        return np.sort(rs.choice(group, m, replace=False)).astype(np.int32)

    def run(self, global_rounds: int,
            batch_schedule: Optional[Callable] = None) -> list[dict]:
        for R in range(global_rounds):
            group_params, group_weights, losses = [], [], []
            for gi, group in enumerate(self.groups):
                # each group starts the global round from the global model
                st = self.alg.server_init(
                    {k: v.clone() for k, v in self.params.items()}, None)
                for r in range(self.group_comm_round):
                    ids = self._sample(group, R, r)
                    out = self.round_fn(
                        st, None, self.data, ids, self.counts[ids],
                        (self.seed, R, gi, r),
                        None if batch_schedule is None
                        else batch_schedule(R, gi, r))
                    st = out.server_state
                    losses.append(out.metrics["train_loss"])
                group_params.append(st.params)
                group_weights.append(float(self.counts[group].sum()))
            self.params = tree_weighted_mean(
                tree_stack(group_params),
                torch.tensor(group_weights, dtype=torch.float32,
                             device=self.device))
            self.history.append(
                {"round": R, "train_loss": float(np.mean(
                    torch.stack(losses).double().cpu().numpy()))})
        return self.history
