"""Built-in federated optimizers (port of `fedml_tpu/algorithms/builtin.py`):
FedAvg, FedOpt (server sgd, adam, yogi, adagrad), FedProx, FedNova,
SCAFFOLD, FedDyn and Mime.

FedOpt treats the negative mean client delta as a pseudo-gradient for a
server optimizer; FedAvg is FedOpt with server SGD at lr 1.0, so the
server step is params + mean delta. FedProx adds mu (w - w_global) to
every local gradient; FedNova normalises each client's delta by its
effective step count. The server optimizers are written out on tensors
with optax's arithmetic (optax's adagrad starts its accumulator at 0.1
with eps inside the rsqrt, and yogi has no torch.optim counterpart), not
taken from `torch.optim`. SCAFFOLD and FedDyn keep per-client state
(control variates c_i, the linear term h_i; `client_state_init` zeros,
stacked over every client by the engine), Mime a server momentum that
clients apply but never update, refreshed from each client's full-shard
gradient at the global parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..config import TrainArgs
from ..core.algorithm import (
    FedAlgorithm, ServerState, func_grad, local_sgd, make_batch_indices,
    make_client_optimizer, make_objective,
)
from ..ops.tree import (
    tree_add, tree_map, tree_scale, tree_sub, tree_zeros_like,
)


def _full_like(params, value: float):
    return tree_map(lambda p: torch.full_like(p, value), params)


def _server_optimizer(name: str, lr: float, momentum: float):
    """(init, update) of the optax server optimizer `name`: init(params) ->
    state; update(grads, state) -> (updates, state), the updates already
    scaled by -lr."""
    name = (name or "sgd").lower()
    if name == "sgd":
        def init(params):
            return tree_zeros_like(params) if momentum else None

        def update(grads, state):
            if momentum:   # optax trace: t = g + mu * t
                state = tree_map(lambda g, t: g + momentum * t, grads, state)
                grads = state
            return tree_scale(grads, -lr), state

        return init, update
    if name in ("adam", "yogi"):
        b1, b2 = 0.9, 0.999
        eps, v0 = (1e-8, 0.0) if name == "adam" else (1e-3, 1e-6)

        def init(params):
            return {"count": 0, "mu": _full_like(params, v0),
                    "nu": _full_like(params, v0)}

        def update(grads, state):
            mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads,
                          state["mu"])
            if name == "adam":
                nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v,
                              grads, state["nu"])
            else:          # yogi: v - (1 - b2) sign(v - g^2) g^2
                nu = tree_map(lambda g, v: v - (1 - b2) * torch.sign(
                    v - g * g) * (g * g), grads, state["nu"])
            count = state["count"] + 1
            # optax's bias corrections, 1 - decay ** count, in f32
            c1, c2 = (1 - torch.tensor(b, dtype=torch.float32) ** count
                      for b in (b1, b2))
            upd = tree_map(
                lambda m, v: -lr * ((m / c1) / (torch.sqrt(v / c2) + eps)),
                mu, nu)
            return upd, {"count": count, "mu": mu, "nu": nu}

        return init, update
    if name == "adagrad":
        def init(params):
            return _full_like(params, 0.1)

        def update(grads, state):
            state = tree_map(lambda g, t: g * g + t, grads, state)
            upd = tree_map(lambda g, t: -lr * (g * torch.where(
                t > 0, torch.rsqrt(t + 1e-7), 0.0)), grads, state)
            return upd, state

        return init, update
    raise ValueError(f"unknown server_optimizer {name!r}")


def _schedule(t: TrainArgs):
    """(generator, shard size) -> [epochs * nb, B]: the batch order a
    client draws from its generator."""
    return lambda gen, shard_size: make_batch_indices(
        gen, shard_size, t.batch_size, t.epochs)


def _make_client_sgd(apply_fn, t: TrainArgs, grad_correction_factory=None,
                     grad_engine=func_grad, opt=None):
    """The shared client body: local SGD over the batch order, the delta.
    `grad_correction_factory(bcast, client_state)` -> (g, p) -> g lets an
    algorithm correct every step's gradient; `opt` defaults to
    `t.client_optimizer`."""
    opt = opt or make_client_optimizer(t.client_optimizer, t.learning_rate,
                                       t.momentum, t.weight_decay)
    objective = make_objective(t.extra.get("task"))

    def run(bcast, shard, client_state, batch_idx):
        corr = (grad_correction_factory(bcast, client_state)
                if grad_correction_factory is not None else None)
        new_params, metrics, tau = local_sgd(
            apply_fn, bcast["params"], shard, batch_idx, opt, objective,
            grad_correction=corr, grad_engine=grad_engine)
        return tree_sub(new_params, bcast["params"]), metrics, tau

    return run


def make_fedopt(apply_fn, t: TrainArgs, server_opt_name=None,
                grad_engine=func_grad) -> FedAlgorithm:
    """FedOpt (Reddi et al.): the server treats -mean_delta as a
    pseudo-gradient. `grad_engine` (`core.algorithm.func_grad`, or
    `autograd_grad` for a model torch.func cannot differentiate) also says
    whether the client can be vmapped."""
    opt_init, opt_update = _server_optimizer(
        server_opt_name or t.server_optimizer, t.server_lr, t.server_momentum)
    base = _make_client_sgd(apply_fn, t, grad_engine=grad_engine)

    def server_init(params, _cfg=None):
        return ServerState(params, opt_init(params), 0, None)

    def client_update(bcast, shard, client_state, batch_idx):
        delta, metrics, _tau = base(bcast, shard, client_state, batch_idx)
        return delta, client_state, metrics

    def server_update(st: ServerState, mean_delta) -> ServerState:
        updates, opt_state = opt_update(tree_scale(mean_delta, -1.0),
                                        st.opt_state)
        return dataclasses.replace(st, params=tree_add(st.params, updates),
                                   opt_state=opt_state, round=st.round + 1)

    return FedAlgorithm("FedOpt", server_init, client_update, server_update,
                        schedule=_schedule(t),
                        vmap_ok=grad_engine is func_grad)


def make_fedavg(apply_fn, t: TrainArgs,
                grad_engine=func_grad) -> FedAlgorithm:
    alg = make_fedopt(apply_fn, dataclasses.replace(t, server_optimizer="sgd"),
                      "sgd", grad_engine)
    return dataclasses.replace(alg, name="FedAvg")


def make_fedprox(apply_fn, t: TrainArgs) -> FedAlgorithm:
    """FedProx: the local loss gains (mu/2)||w - w_global||^2, i.e. every
    local gradient gains mu (w - w_global); the server averages."""
    mu = t.fedprox_mu

    def corr_factory(bcast, _state):
        gp = bcast["params"]
        return lambda g, p: tree_add(g, tree_scale(tree_sub(p, gp), mu))

    base = _make_client_sgd(apply_fn, t, corr_factory)

    def client_update(bcast, shard, client_state, batch_idx):
        delta, metrics, _ = base(bcast, shard, client_state, batch_idx)
        return delta, client_state, metrics

    return dataclasses.replace(make_fedavg(apply_fn, t), name="FedProx",
                               client_update=client_update)


def make_fednova(apply_fn, t: TrainArgs) -> FedAlgorithm:
    """FedNova (Wang et al.): each client's delta divided by its effective
    local step count tau_i; the server adds server_lr x (weighted mean
    tau) x (weighted mean of the normalised deltas)."""
    base = _make_client_sgd(apply_fn, t)

    def server_init(params, _cfg=None):
        return ServerState(params, None, 0, None)

    def client_update(bcast, shard, client_state, batch_idx):
        delta, metrics, tau = base(bcast, shard, client_state, batch_idx)
        tau = torch.clamp(tau, min=1.0)
        return {"d": tree_scale(delta, 1.0 / tau), "tau": tau}, \
            client_state, metrics

    def server_update(st: ServerState, agg) -> ServerState:
        params = tree_add(st.params,
                          tree_scale(agg["d"], t.server_lr * agg["tau"]))
        return dataclasses.replace(st, params=params, round=st.round + 1)

    return FedAlgorithm("FedNova", server_init, client_update, server_update,
                        schedule=_schedule(t))


def make_scaffold(apply_fn, t: TrainArgs, client_num_in_total: int,
                  client_num_per_round: int) -> FedAlgorithm:
    """SCAFFOLD (Karimireddy et al.): control variates c (server) and c_i
    (per client, persistent). Every local gradient becomes g + (c - c_i);
    after tau steps c_i' = c_i - c - delta / (max(tau, 1) lr). The update
    is the pair (delta, dc = c_i' - c_i); the server adds server_lr x
    mean delta to the parameters and (m / N) x mean dc to c."""
    frac = client_num_per_round / max(client_num_in_total, 1)

    def corr_factory(bcast, c_i):
        c = bcast["extra"]
        return lambda g, p: tree_add(g, tree_sub(c, c_i))

    base = _make_client_sgd(apply_fn, t, corr_factory)

    def server_init(params, _cfg=None):
        return ServerState(params, None, 0, tree_zeros_like(params))

    def client_update(bcast, shard, client_state, batch_idx):
        delta, metrics, tau = base(bcast, shard, client_state, batch_idx)
        k_lr = torch.clamp(tau, min=1.0) * t.learning_rate
        new_ci = tree_sub(tree_sub(client_state, bcast["extra"]),
                          tree_scale(delta, 1.0 / k_lr))
        dc = tree_sub(new_ci, client_state)
        return {"delta": delta, "dc": dc}, new_ci, metrics

    def server_update(st: ServerState, agg) -> ServerState:
        params = tree_add(st.params, tree_scale(agg["delta"], t.server_lr))
        c = tree_add(st.extra, tree_scale(agg["dc"], frac))
        return dataclasses.replace(st, params=params, extra=c,
                                   round=st.round + 1)

    return FedAlgorithm("SCAFFOLD", server_init, client_update, server_update,
                        client_state_init=tree_zeros_like,
                        schedule=_schedule(t))


def make_feddyn(apply_fn, t: TrainArgs, client_num_in_total: int,
                client_num_per_round: int) -> FedAlgorithm:
    """FedDyn (Acar et al.): every local gradient becomes
    (g - h_i) + alpha (w - w_global); h_i' = h_i - alpha delta_i. The
    server keeps h -= alpha (m / N) mean delta and sets
    w = (w + mean delta) - h / alpha."""
    alpha = t.feddyn_alpha
    frac = client_num_per_round / max(client_num_in_total, 1)

    def corr_factory(bcast, h_i):
        gp = bcast["params"]
        return lambda g, p: tree_add(tree_sub(g, h_i),
                                     tree_scale(tree_sub(p, gp), alpha))

    base = _make_client_sgd(apply_fn, t, corr_factory)

    def server_init(params, _cfg=None):
        return ServerState(params, None, 0, tree_zeros_like(params))

    def client_update(bcast, shard, client_state, batch_idx):
        delta, metrics, _ = base(bcast, shard, client_state, batch_idx)
        return delta, tree_sub(client_state, tree_scale(delta, alpha)), \
            metrics

    def server_update(st: ServerState, mean_delta) -> ServerState:
        h = tree_sub(st.extra, tree_scale(mean_delta, alpha * frac))
        params = tree_sub(tree_add(st.params, mean_delta),
                          tree_scale(h, 1.0 / alpha))
        return dataclasses.replace(st, params=params, extra=h,
                                   round=st.round + 1)

    return FedAlgorithm("FedDyn", server_init, client_update, server_update,
                        client_state_init=tree_zeros_like,
                        schedule=_schedule(t))


def make_mime(apply_fn, t: TrainArgs) -> FedAlgorithm:
    """MimeLite (Karimireddy et al.): clients run plain SGD (whatever
    `client_optimizer` says) along beta m + (1 - beta) g, m the server's
    momentum, applied but never updated locally; each client also returns
    its full-shard gradient at the global parameters, and the server
    refreshes m = beta m + (1 - beta) mean g."""
    beta = t.mime_beta
    objective = make_objective(t.extra.get("task"))

    def corr_factory(bcast, _state):
        m = bcast["extra"]["m"]
        return lambda g, p: tree_add(tree_scale(m, beta),
                                     tree_scale(g, 1.0 - beta))

    base = _make_client_sgd(apply_fn, t, corr_factory,
                            opt=make_client_optimizer("sgd", t.learning_rate))

    def full_loss(p, x, y, mask):
        loss, _, _ = objective(apply_fn(p, x), y, mask)
        return loss, loss

    full_grad = func_grad(full_loss)

    def server_init(params, _cfg=None):
        return ServerState(params, None, 0, {"m": tree_zeros_like(params)})

    def client_update(bcast, shard, client_state, batch_idx):
        delta, metrics, _ = base(bcast, shard, client_state, batch_idx)
        g, _ = full_grad(bcast["params"], shard["x"], shard["y"],
                         shard["mask"])
        return {"delta": delta, "g": g}, client_state, metrics

    def server_update(st: ServerState, agg) -> ServerState:
        m = tree_add(tree_scale(st.extra["m"], beta),
                     tree_scale(agg["g"], 1.0 - beta))
        params = tree_add(st.params, tree_scale(agg["delta"], t.server_lr))
        return dataclasses.replace(st, params=params, extra={"m": m},
                                   round=st.round + 1)

    return FedAlgorithm("Mime", server_init, client_update, server_update,
                        schedule=_schedule(t))


def build_algorithm(name: str, apply_fn: Callable, t: TrainArgs,
                    client_num_in_total: int | None = None,
                    client_num_per_round: int | None = None) -> FedAlgorithm:
    """federated_optimizer name -> FedAlgorithm."""
    n_total = client_num_in_total or 1
    n_round = client_num_per_round or 1
    key = name.lower()
    if key == "fedavg":
        return make_fedavg(apply_fn, t)
    if key == "fedopt":
        return make_fedopt(apply_fn, t)
    if key == "fedprox":
        return make_fedprox(apply_fn, t)
    if key == "fednova":
        return make_fednova(apply_fn, t)
    if key == "scaffold":
        return make_scaffold(apply_fn, t, n_total, n_round)
    if key == "feddyn":
        return make_feddyn(apply_fn, t, n_total, n_round)
    if key in ("mime", "mimelite"):
        return make_mime(apply_fn, t)
    if key == "fedgan":
        raise NotImplementedError(
            "federated_optimizer 'FedGAN' is not ported yet (ROADMAP 'Port "
            "queue' item 5, the remaining models)")
    raise ValueError(f"unknown federated_optimizer {name!r}")
