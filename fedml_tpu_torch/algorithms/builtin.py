"""FedAvg and FedOpt (port of `fedml_tpu/algorithms/builtin.py:38-113`).

FedOpt treats the negative mean client delta as a pseudo-gradient for a
server optimizer; FedAvg is FedOpt with server SGD at lr 1.0, so the
server step is params + mean delta. The other algorithms of the JAX module
(FedProx, FedNova, SCAFFOLD, FedDyn, Mime) are in ROADMAP's port queue
(item 3).
"""
from __future__ import annotations

import dataclasses

from ..config import TrainArgs
from ..core.algorithm import (
    FedAlgorithm, ServerState, local_sgd, make_batch_indices,
    make_client_optimizer, masked_softmax_ce,
)
from ..ops.tree import tree_add, tree_map, tree_scale, tree_sub

_LATER = ("is not ported yet (ROADMAP 'Port queue' item 3, the FedAvg "
          "simulation path)")


def _server_optimizer(name: str, lr: float, momentum: float):
    """(init, update) of optax.sgd: with momentum, trace = g + mu * trace
    and the update is -lr * trace; without, -lr * g. Only sgd is ported."""
    name = (name or "sgd").lower()
    if name != "sgd":
        raise NotImplementedError(f"server_optimizer {name!r} {_LATER}")

    def init(params):
        return tree_map(lambda p: p * 0, params) if momentum else None

    def update(grads, state):
        if momentum:
            state = tree_map(lambda g, t: g + momentum * t, grads, state)
            grads = state
        return tree_scale(grads, -lr), state

    return init, update


def _make_client_sgd(apply_fn, t: TrainArgs):
    """The shared client body: batch order, local SGD, the delta."""
    make_opt = make_client_optimizer(t.client_optimizer, t.learning_rate,
                                     t.momentum, t.weight_decay)
    task = (t.extra.get("task") or "classification").lower()
    if task != "classification":
        raise NotImplementedError(f"task {task!r} {_LATER}")

    def run(bcast, shard, client_state, rng, batch_idx=None):
        if batch_idx is None:
            batch_idx = make_batch_indices(rng, shard["y"].shape[0],
                                           t.batch_size, t.epochs)
        new_params, metrics, tau = local_sgd(
            apply_fn, bcast["params"], shard, batch_idx, make_opt,
            masked_softmax_ce)
        return tree_sub(new_params, bcast["params"]), metrics, tau

    return run


def make_fedopt(apply_fn, t: TrainArgs, server_opt_name=None) -> FedAlgorithm:
    """FedOpt (Reddi et al.): the server treats -mean_delta as a
    pseudo-gradient."""
    opt_init, opt_update = _server_optimizer(
        server_opt_name or t.server_optimizer, t.server_lr, t.server_momentum)
    base = _make_client_sgd(apply_fn, t)

    def server_init(params, _cfg=None):
        return ServerState(params, opt_init(params), 0, None)

    def client_update(bcast, shard, client_state, rng, batch_idx=None):
        delta, metrics, _tau = base(bcast, shard, client_state, rng,
                                    batch_idx)
        return delta, client_state, metrics

    def server_update(st: ServerState, mean_delta) -> ServerState:
        updates, opt_state = opt_update(tree_scale(mean_delta, -1.0),
                                        st.opt_state)
        return dataclasses.replace(st, params=tree_add(st.params, updates),
                                   opt_state=opt_state, round=st.round + 1)

    return FedAlgorithm("FedOpt", server_init, client_update, server_update)


def make_fedavg(apply_fn, t: TrainArgs) -> FedAlgorithm:
    alg = make_fedopt(apply_fn, dataclasses.replace(t, server_optimizer="sgd"),
                      "sgd")
    return dataclasses.replace(alg, name="FedAvg")
