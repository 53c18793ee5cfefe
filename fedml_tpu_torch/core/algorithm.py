"""The federated-algorithm contract, the local-training loop and the eval
function (port of the parts of `fedml_tpu/core/algorithm.py` the FedAvg
path runs).

- `client_update(bcast, shard, client_state, rng, batch_idx=None)` ->
  (update, new client state, ClientMetrics): one client's local training.
  `rng` is a `torch.Generator` the batch order is drawn from; `batch_idx`
  ([steps, B] indices), when given, is the batch order itself (the tests
  hand over the JAX package's schedule this way).
- `server_update(ServerState, aggregated update) -> ServerState`.
- The JAX `lax.scan` over local steps is a Python loop; gradients come
  from autograd and the client optimizer is a `torch.optim` optimizer with
  optax's arithmetic. `grad_correction(grads, params) -> grads` rewrites
  each step's gradient before the optimizer sees it (FedProx's proximal
  pull).
- Objectives: classification only; the other task heads (nwp,
  regression, multilabel, segmentation) are in ROADMAP's port queue
  (item 5).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F

from ..ops.tree import tree_leaves, tree_map

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


def make_client_optimizer(name: str, lr: float, momentum: float = 0.0,
                          weight_decay: float = 0.0) -> Callable:
    """params -> a torch optimizer computing what the JAX package's optax
    chain computes: sgd (trace = g + mu * trace, p -= lr * trace; weight
    decay adds wd * p to g first), adam (same decay, then Adam) and adamw
    (decoupled decay)."""
    name = name.lower()
    if name == "sgd":
        return lambda ps: torch.optim.SGD(ps, lr=lr, momentum=momentum,
                                          weight_decay=weight_decay)
    if name == "adam":
        return lambda ps: torch.optim.Adam(ps, lr=lr,
                                           weight_decay=weight_decay)
    if name == "adamw":
        return lambda ps: torch.optim.AdamW(ps, lr=lr,
                                            weight_decay=weight_decay)
    raise ValueError(f"unknown client_optimizer {name!r}")


def local_sgd(apply_fn: Callable, params, shard: dict,
              batch_idx: torch.Tensor, make_opt: Callable,
              objective: Optional[Callable] = None,
              grad_correction: Optional[Callable] = None):
    """Local training over the [steps, B] batch schedule: the objective's
    gradient w.r.t. `params` (a dict of tensors, left unchanged), through
    `grad_correction(grads, params)` when given, then one optimizer step
    per batch. Every step runs, a batch with no real sample included (its
    gradient is 0, but weight decay and momentum still move the weights).
    Returns (trained params, summed ClientMetrics, number of batches with
    >= 1 real sample)."""
    obj = objective or masked_softmax_ce
    p = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    opt = make_opt(tree_leaves(p))
    dev = shard["y"].device
    loss_sum, correct, count, steps = (
        torch.zeros((), dtype=torch.float32, device=dev) for _ in range(4))
    for idx in batch_idx.to(dev):
        batch = {k: v[idx] for k, v in shard.items()}
        loss, c, n = obj(apply_fn(p, batch["x"]), batch["y"], batch["mask"])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if grad_correction is not None:
            with torch.no_grad():
                fixed = grad_correction(tree_map(lambda t: t.grad, p),
                                        tree_map(lambda t: t.detach(), p))
                for t, g in zip(tree_leaves(p), tree_leaves(fixed)):
                    t.grad = g
        opt.step()
        loss_sum += loss.detach() * n
        correct += c
        count += n
        steps += (n > 0).float()
    return (tree_map(lambda t: t.detach(), p),
            ClientMetrics(loss_sum, correct, count), steps)


@dataclasses.dataclass(frozen=True)
class FedAlgorithm:
    """The pluggable federated-optimizer contract (module docstring)."""
    name: str
    server_init: Callable[..., ServerState]
    client_update: Callable[..., tuple]
    server_update: Callable[[ServerState, Any], ServerState]
    # what clients see; default: the current global params + extra
    broadcast: Callable[[ServerState], dict] = None  # type: ignore
    client_state_init: Optional[Callable] = None
    agg_mode: str = LINEAR

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
