"""The federated-algorithm contract, the local-training loop and the eval
function (port of the parts of `fedml_tpu/core/algorithm.py` the
simulation path runs).

- `client_update(bcast, shard, client_state, batch_idx)` -> (update, new
  client state, ClientMetrics): one client's local training over the
  [steps, B] batch order `batch_idx`. The round draws that order outside
  the client (`FedAlgorithm.schedule(generator, shard_size)`, or the
  tests hand over the JAX package's), so that no randomness runs under
  `torch.func.vmap`.
- `server_update(ServerState, aggregated update) -> ServerState`.
- The JAX `lax.scan` over local steps is a Python loop of functional
  steps: gradients from `torch.func.grad` over the model's
  `functional_call`, the client optimizer as arithmetic on tensors with
  optax's formulas (`make_client_optimizer`). One client's step is the
  same function a vmapped client group runs. `grad_correction(grads,
  params) -> grads` rewrites each step's gradient before the optimizer
  sees it (FedProx's proximal pull, SCAFFOLD's control variates,
  FedDyn's linear term, Mime's frozen momentum).
- Objectives: classification only; the other task heads (nwp,
  regression, multilabel, segmentation) are in ROADMAP's port queue
  (item 5).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.tree import tree_leaves, tree_map, tree_zeros_like

LINEAR = "linear"   # the update aggregates as a sample-count-weighted mean


@dataclasses.dataclass
class ServerState:
    """Global state carried across rounds."""
    params: Any
    opt_state: Any
    round: int
    extra: Any = None


@dataclasses.dataclass
class ClientMetrics:
    """Linear-aggregable training metrics (sums, not means; 0-d tensors)."""
    loss_sum: torch.Tensor
    correct: torch.Tensor
    count: torch.Tensor


def masked_softmax_ce(logits: torch.Tensor, y: torch.Tensor,
                      mask: torch.Tensor):
    """Cross-entropy over a padded batch -> (loss mean, correct, count).
    Padding rows (mask 0) contribute nothing. With [B, T, V] logits the
    per-sequence mask repeats over the T tokens."""
    if logits.dim() == 3:
        logits = logits.reshape(-1, logits.shape[-1])
        y = y.reshape(-1)
        mask = mask.repeat_interleave(logits.shape[0] // mask.shape[0])
    ce = F.cross_entropy(logits, y.long(), reduction="none")
    loss = (ce * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    correct = ((logits.argmax(-1) == y) * mask).sum()
    return loss, correct, mask.sum()


OBJECTIVES = {"classification": masked_softmax_ce}
_LATER_TASKS = ("nwp", "regression", "multilabel", "segmentation")


def make_objective(task: Optional[str]) -> Callable:
    t = (task or "classification").lower()
    if t in _LATER_TASKS:
        raise NotImplementedError(
            f"task {t!r} is not ported yet (ROADMAP 'Port queue' item 5, "
            "the remaining task heads)")
    if t not in OBJECTIVES:
        raise ValueError(f"unknown task {t!r}; choose from "
                         f"{sorted([*OBJECTIVES, *_LATER_TASKS])}")
    return OBJECTIVES[t]


def make_batch_indices(generator: torch.Generator, shard_size: int,
                       batch_size: int, epochs: int) -> torch.Tensor:
    """Per-epoch permutations of a shard, cut to whole batches and shaped
    [epochs * nb, B] (int64, on the generator's device)."""
    bs = min(batch_size, shard_size)
    nb = shard_size // bs
    perms = torch.stack([torch.randperm(shard_size, generator=generator,
                                        device=generator.device)
                         for _ in range(epochs)])
    return perms[:, :nb * bs].reshape(epochs * nb, bs)


class ClientOptimizer(NamedTuple):
    """A client optimizer as arithmetic on tensors, so that it composes
    with `torch.func.vmap`: `init(params) -> state` and
    `step(params, grads, state, count) -> (params, state)`, `count` the
    1-based step number (Adam's bias corrections)."""
    init: Callable
    step: Callable


def make_client_optimizer(name: str, lr: float, momentum: float = 0.0,
                          weight_decay: float = 0.0) -> ClientOptimizer:
    """What the JAX package's optax chain computes, in optax's order: sgd
    (weight decay adds wd * p to g first; trace = g + mu * trace; p +=
    trace * -lr), adam (the same decay, then Adam's bias-corrected
    moments) and adamw (Adam, then the decoupled wd * p)."""
    name = name.lower()
    if name not in ("sgd", "adam", "adamw"):
        raise ValueError(f"unknown client_optimizer {name!r}")
    b1, b2, eps = 0.9, 0.999, 1e-8

    def decay(params, grads):
        return tree_map(lambda g, p: g + weight_decay * p, grads, params)

    def apply(params, updates):
        return tree_map(lambda p, u: p + u * (-lr), params, updates)

    if name == "sgd":
        def init(params):
            return {"trace": tree_zeros_like(params)} if momentum else {}

        def step(params, grads, state, count):
            if weight_decay:
                grads = decay(params, grads)
            if momentum:
                grads = tree_map(lambda g, t: g + momentum * t, grads,
                                 state["trace"])
                state = {"trace": grads}
            return apply(params, grads), state

        return ClientOptimizer(init, step)

    def init(params):
        return {"mu": tree_zeros_like(params), "nu": tree_zeros_like(params)}

    def step(params, grads, state, count):
        if weight_decay and name == "adam":
            grads = decay(params, grads)
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state["mu"])
        nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads,
                      state["nu"])
        # optax's bias corrections, 1 - decay ** count, in f32
        c1, c2 = (float(np.float32(1) - np.float32(b) ** count)
                  for b in (b1, b2))
        upd = tree_map(lambda m, v: (m / c1) / (torch.sqrt(v / c2) + eps),
                       mu, nu)
        if weight_decay and name == "adamw":
            upd = decay(params, upd)
        return apply(params, upd), {"mu": mu, "nu": nu}

    return ClientOptimizer(init, step)


def func_grad(loss_fn: Callable) -> Callable:
    """(params, *batch) -> (grads, aux) of `loss_fn(params, *batch) ->
    (loss, aux)` through `torch.func.grad`: composes with `torch.func.vmap`
    (client groups)."""
    return torch.func.grad(loss_fn, has_aux=True)


def autograd_grad(loss_fn: Callable) -> Callable:
    """The same through `torch.autograd.grad`, for models whose forward
    `torch.func.grad` refuses: per-block remat (`torch.utils.checkpoint`)
    installs saved-tensor hooks, which torch.func does not take. Such a
    client cannot be vmapped either."""
    def grad(params, *batch):
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss, aux = loss_fn(p, *batch)
            leaves = tree_leaves(p)
            gs = iter(torch.autograd.grad(loss, leaves))
        grads = tree_map(lambda _t: next(gs), p)
        return grads, tree_map(lambda a: a.detach(), aux)

    return grad


def local_sgd(apply_fn: Callable, params, shard: dict,
              batch_idx: torch.Tensor, opt: ClientOptimizer,
              objective: Optional[Callable] = None,
              grad_correction: Optional[Callable] = None,
              grad_engine: Callable = func_grad):
    """Local training over the [steps, B] batch schedule, as arithmetic on
    tensors (the JAX `local_sgd`'s scan as a Python loop): each step takes
    the objective's gradient w.r.t. the parameters (`grad_engine`, by
    default `torch.func.grad` over the model's `functional_call`), passes
    it through `grad_correction(grads, params)` when given, and steps
    `opt`. `params` (a dict of tensors) is left unchanged. Every step
    runs, a batch with no real sample included (its gradient is 0, but
    weight decay and momentum still move the weights). The same function
    runs one client or, under `torch.func.vmap`, a group of them.
    Returns (trained params, summed ClientMetrics, number of batches with
    >= 1 real sample)."""
    obj = objective or masked_softmax_ce

    def loss_fn(p, x, y, mask):
        loss, correct, count = obj(apply_fn(p, x), y, mask)
        return loss, (loss, correct, count)

    grad = grad_engine(loss_fn)
    p, state = params, opt.init(params)
    per_step = []
    for i in range(batch_idx.shape[0]):
        idx = batch_idx[i]
        grads, (loss, correct, count) = grad(
            p, shard["x"][idx], shard["y"][idx], shard["mask"][idx])
        if grad_correction is not None:
            grads = grad_correction(grads, p)
        p, state = opt.step(p, grads, state, i + 1)
        per_step.append((loss * count, correct, count,
                         (count > 0).float()))
    loss_sum, correct, count, steps = (torch.stack(v).sum()
                                       for v in zip(*per_step))
    return p, ClientMetrics(loss_sum, correct, count), steps


@dataclasses.dataclass(frozen=True)
class FedAlgorithm:
    """The pluggable federated-optimizer contract (module docstring)."""
    name: str
    server_init: Callable[..., ServerState]
    client_update: Callable[..., tuple]
    server_update: Callable[[ServerState, Any], ServerState]
    # what clients see; default: the current global params + extra
    broadcast: Callable[[ServerState], dict] = None  # type: ignore
    # per-client persistent state (stacked [num_clients, ...] by the engine)
    client_state_init: Optional[Callable] = None
    agg_mode: str = LINEAR
    # (torch.Generator, shard size) -> the [steps, B] batch order
    schedule: Optional[Callable] = None
    # whether client_update runs under torch.func.vmap (client groups)
    vmap_ok: bool = True
    # (update, new client state, key) -> (update, new client state): run
    # by the round on each client outside vmap, so it may draw from the
    # client's key (`ops/keys.py`); EF-TopK's compression
    finish_update: Optional[Callable] = None

    def __post_init__(self):
        if self.broadcast is None:
            object.__setattr__(
                self, "broadcast",
                lambda st: {"params": st.params, "extra": st.extra})


def eval_step_fn(apply_fn: Callable, objective: Optional[Callable] = None):
    """Eval over the batched global test set: (params, x [nb, B, ...],
    y [nb, B], mask [nb, B]) -> {"loss", "acc", "n"} (0-d tensors), the
    sample-weighted means over the real rows."""
    obj = objective or masked_softmax_ce

    @torch.no_grad()
    def eval_batches(params, x, y, mask):
        losses, corrects, counts = [], [], []
        for xb, yb, mb in zip(x, y, mask):
            loss, c, n = obj(apply_fn(params, xb), yb, mb)
            losses.append(loss * n)
            corrects.append(c)
            counts.append(n)
        n_tot = torch.stack(counts).sum()
        denom = torch.clamp(n_tot, min=1.0)
        return {"loss": torch.stack(losses).sum() / denom,
                "acc": torch.stack(corrects).sum() / denom, "n": n_tot}

    return eval_batches


def make_eval_fn(apply_fn: Callable, task: Optional[str] = None):
    """The eval function for `task` (classification; segmentation's
    confusion-matrix eval is in ROADMAP's port queue, item 5)."""
    return eval_step_fn(apply_fn, make_objective(task))
