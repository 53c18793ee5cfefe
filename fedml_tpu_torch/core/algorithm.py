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
- Objectives (`OBJECTIVES`, picked by `train_args.extra.task`):
  classification, nwp (pad id 0 excluded), regression, multilabel and
  segmentation (ignore id 255). Each maps (model output, y, the [B]
  sample mask) -> (loss mean, correct, count). Segmentation's eval also
  accumulates a whole-set confusion matrix for the mIoU
  (`seg_eval_fn`).
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


NWP_PAD_ID = 0   # the reference's nn.CrossEntropyLoss(ignore_index=0)


def nwp_softmax_ce(logits: torch.Tensor, y: torch.Tensor,
                   mask: torch.Tensor):
    """Next-word prediction: per-token cross-entropy over [B, T, V]
    logits and [B, T] targets. A token counts in loss and accuracy when
    its sample is real (mask 1) and its target is not the pad id 0."""
    tok = (mask[:, None] * (y != NWP_PAD_ID)).to(logits.dtype).reshape(-1)
    logits = logits.reshape(-1, logits.shape[-1])
    y = y.reshape(-1)
    ce = F.cross_entropy(logits, y.long(), reduction="none")
    loss = (ce * tok).sum() / torch.clamp(tok.sum(), min=1.0)
    correct = ((logits.argmax(-1) == y) * tok).sum()
    return loss, correct, tok.sum()


def masked_mse(pred: torch.Tensor, y: torch.Tensor, mask: torch.Tensor):
    """Regression: mean squared error over the real rows; `correct`
    counts predictions within 0.5 of the target. A [B, 1] output is read
    as [B]."""
    if pred.dim() == 2 and pred.shape[-1] == 1:
        pred = pred[:, 0]
    err = (pred - y.to(pred.dtype)) ** 2
    loss = (err * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    close = (((pred - y).abs() < 0.5) * mask).sum()
    return loss, close, mask.sum()


def masked_bce_multilabel(logits: torch.Tensor, y: torch.Tensor,
                          mask: torch.Tensor):
    """Multi-label tags: y a [B, L] multi-hot matrix, the loss the mean
    sigmoid cross-entropy over the L labels, `correct` the share of
    labels predicted right (logit > 0 against y > 0.5) summed over the
    real rows."""
    yf = y.to(logits.dtype)
    bce = F.binary_cross_entropy_with_logits(logits, yf,
                                             reduction="none").mean(-1)
    loss = (bce * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    hits = (((logits > 0) == (yf > 0.5)).to(logits.dtype).mean(-1)
            * mask).sum()
    return loss, hits, mask.sum()


SEG_IGNORE_ID = 255   # the reference's segmentation losses' ignore_index


def seg_softmax_ce(logits: torch.Tensor, y: torch.Tensor,
                   mask: torch.Tensor):
    """Segmentation: per-pixel cross-entropy over [B, H, W, C] logits and
    [B, H, W] labels. A pixel counts when its sample is real and its
    label is not the ignore id 255 (which is read as class 0 for the
    argmax and the loss, both then masked out)."""
    valid = y != SEG_IGNORE_ID
    pix = (mask[:, None, None] * valid).to(torch.float32)
    y_safe = torch.where(valid, y, torch.zeros_like(y))
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         y_safe.reshape(-1).long(), reduction="none")
    loss = (ce.reshape(pix.shape) * pix).sum() / torch.clamp(pix.sum(),
                                                              min=1.0)
    correct = ((logits.argmax(-1) == y_safe) * pix).sum()
    return loss, correct, pix.sum()


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot rows of a flat index vector; an index outside [0, n)
    gives a row of zeros (as jax.nn.one_hot does)."""
    return (idx[:, None] == torch.arange(n, device=idx.device)).to(
        torch.float32)


def _seg_confusion(logits: torch.Tensor, y: torch.Tensor, num_classes: int,
                   mask: Optional[torch.Tensor], ignore_id: int):
    """The [true, pred] pixel confusion matrix (f32 counts) over the valid
    pixels (ignore label and padded samples excluded), as one one-hot
    product. Additive across batches."""
    pred = logits.argmax(-1)
    valid = y != ignore_id
    if mask is not None:
        valid = valid & (mask[:, None, None] > 0)
    vf = valid.reshape(-1).to(torch.float32)[:, None]
    py = _one_hot(y.reshape(-1), num_classes) * vf
    pp = _one_hot(pred.reshape(-1), num_classes) * vf
    return py.T @ pp


def _iou_from_confusion(confusion: torch.Tensor):
    """(miou, per-class IoU); a class absent from both prediction and
    target is left out of the mean."""
    inter = confusion.diagonal()
    union = confusion.sum(0) + confusion.sum(1) - inter
    present = union > 0
    iou = torch.where(present, inter / torch.clamp(union, min=1.0),
                      torch.zeros_like(inter))
    return iou.sum() / torch.clamp(present.sum(), min=1), iou


def miou_from_logits(logits: torch.Tensor, y: torch.Tensor,
                     num_classes: int, mask: Optional[torch.Tensor] = None,
                     ignore_id: int = SEG_IGNORE_ID):
    """Mean intersection-over-union of one batch from its confusion
    matrix -> (miou, per-class IoU)."""
    return _iou_from_confusion(
        _seg_confusion(logits, y, num_classes, mask, ignore_id))


OBJECTIVES = {
    "classification": masked_softmax_ce,
    "nwp": nwp_softmax_ce,
    "regression": masked_mse,
    "multilabel": masked_bce_multilabel,
    "segmentation": seg_softmax_ce,
}


def make_objective(task: Optional[str]) -> Callable:
    t = (task or "classification").lower()
    if t not in OBJECTIVES:
        raise ValueError(f"unknown task {t!r}; choose from "
                         f"{sorted(OBJECTIVES)}")
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
              grad_engine: Callable = func_grad,
              opt_state: Optional[tuple] = None,
              return_opt_state: bool = False):
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
    >= 1 real sample), and with `return_opt_state` the optimizer state
    after the last step as a fourth element.

    `opt_state`, that fourth element of an earlier call, continues the
    optimizer where it stopped (momentum traces, Adam's moments and its
    step count, which the JAX optimizer state carries), as ordinary
    training across epochs needs; None starts it fresh. It is the pair
    (`opt` state, steps taken)."""
    obj = objective or masked_softmax_ce

    def loss_fn(p, x, y, mask):
        loss, correct, count = obj(apply_fn(p, x), y, mask)
        return loss, (loss, correct, count)

    grad = grad_engine(loss_fn)
    state, done = (opt.init(params), 0) if opt_state is None else opt_state
    p = params
    per_step = []
    for i in range(batch_idx.shape[0]):
        idx = batch_idx[i]
        grads, (loss, correct, count) = grad(
            p, shard["x"][idx], shard["y"][idx], shard["mask"][idx])
        if grad_correction is not None:
            grads = grad_correction(grads, p)
        p, state = opt.step(p, grads, state, done + i + 1)
        per_step.append((loss * count, correct, count,
                         (count > 0).float()))
    loss_sum, correct, count, steps = (torch.stack(v).sum()
                                       for v in zip(*per_step))
    out = (p, ClientMetrics(loss_sum, correct, count), steps)
    if return_opt_state:
        return out + ((state, done + batch_idx.shape[0]),)
    return out


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


def seg_eval_fn(apply_fn: Callable, num_classes: int,
                ignore_id: int = SEG_IGNORE_ID):
    """Segmentation eval over the batched test set: loss, pixel accuracy
    and the mIoU of the confusion matrix summed over every batch (the
    whole set's, not a mean of per-batch IoUs)."""

    @torch.no_grad()
    def eval_batches(params, x, y, mask):
        conf = None
        losses, corrects, counts = [], [], []
        for xb, yb, mb in zip(x, y, mask):
            logits = apply_fn(params, xb)
            loss, c, n = seg_softmax_ce(logits, yb, mb)
            part = _seg_confusion(logits, yb, num_classes, mb, ignore_id)
            conf = part if conf is None else conf + part
            losses.append(loss * n)
            corrects.append(c)
            counts.append(n)
        miou, iou = _iou_from_confusion(conf)
        n_tot = torch.stack(counts).sum()
        denom = torch.clamp(n_tot, min=1.0)
        return {"loss": torch.stack(losses).sum() / denom,
                "acc": torch.stack(corrects).sum() / denom,
                "miou": miou, "per_class_iou": iou, "n": n_tot}

    return eval_batches


def make_eval_fn(apply_fn: Callable, task: Optional[str] = None,
                 num_classes: Optional[int] = None):
    """The eval function for `task`, one dispatch for every engine:
    segmentation gets the whole-set confusion-matrix eval (its mIoU rides
    the eval row), every other task `eval_step_fn` with its objective."""
    if (task or "").lower() == "segmentation":
        if num_classes is None:
            raise ValueError("segmentation eval needs num_classes (the "
                             "confusion matrix's shape)")
        return seg_eval_fn(apply_fn, num_classes)
    return eval_step_fn(apply_fn, make_objective(task))


def pad_test_batches(x: np.ndarray, y: np.ndarray, batch_size: int):
    """The test set as [nb, B, ...] batches, the last one zero-padded,
    with its [nb, B] sample mask."""
    n = x.shape[0]
    nb = (n + batch_size - 1) // batch_size
    pad = nb * batch_size - n
    xp = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)]) if pad else x
    yp = np.concatenate([y, np.zeros((pad,) + y.shape[1:], y.dtype)]) if pad else y
    mask = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
    rs = lambda a: a.reshape((nb, batch_size) + a.shape[1:])
    return rs(xp), rs(yp), rs(mask)


def eval_labels(y: np.ndarray) -> np.ndarray:
    """Test labels as the device takes them: integer labels int64,
    floating targets (regression) f32, as the JAX package keeps a float
    y_test (no cast to an integer)."""
    return (y.astype(np.float32) if np.issubdtype(y.dtype, np.floating)
            else y.astype(np.int64))


def eval_row(m: dict) -> dict:
    """An eval's device values -> the history row's test metrics, in one
    transfer; a segmentation eval adds `test_miou`."""
    keys_ = ("loss", "acc", "miou") if "miou" in m else ("loss", "acc")
    vals = torch.stack([m[k].float() for k in keys_]).cpu().tolist()
    return {"test_" + k: v for k, v in zip(keys_, vals)}
