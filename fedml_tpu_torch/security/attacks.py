"""Attacks for robustness testing (port of the model- and data-poisoning
parts of `fedml_tpu/security/attacks.py`, and its label inference from
gradients).

Model poisoning transforms the flat stacked updates U [m, D] of the
clients a boolean mask marks malicious, and returns a new matrix (U is
left as it is: the round's health stats read it after the hook). Data
poisoning transforms the host's numpy arrays before they reach the
device. The gradient-inversion attacks (`dlg_attack`,
`invert_gradient_attack`) reconstruct a training input from a shared
gradient by matching it: the label first, analytically (iDLG), then the
input by Adam on the match loss, whose gradient w.r.t. the input is a
second derivative through the model (`torch.func.grad` of a
`torch.func.grad`). They run on the device their tensors are on, outside
the round: the round's attacker does nothing with "dlg" or
"invert_gradient", as in the JAX package.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from ..ops.tree import tree_leaves

Tree = Any


# --------------------------------------------------------- model poisoning
def _rows(malicious: torch.Tensor) -> torch.Tensor:
    return torch.nonzero(malicious, as_tuple=False).reshape(-1)


def byzantine_attack(U: torch.Tensor, malicious: torch.Tensor,
                     mode: str = "random",
                     evil: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Modes zero | random | flip. U's rows are deltas, so flipping the
    client around the global model is -delta. `evil`, for mode random,
    is the malicious rows' standard normal noise ([n_malicious, D])."""
    if mode not in ("zero", "random", "flip"):
        raise ValueError(f"unknown byzantine attack_mode {mode!r}")
    idx = _rows(malicious)
    out = U.clone()
    if mode == "zero":
        out[idx] = 0.0
    elif mode == "random":
        out[idx] = evil.to(U.dtype)
    else:
        out[idx] = -U[idx]
    return out


def model_replacement_attack(U: torch.Tensor, malicious: torch.Tensor,
                             scale: float) -> torch.Tensor:
    """Model replacement (Bagdasaryan et al.): the malicious updates
    scaled so that they survive averaging."""
    idx = _rows(malicious)
    out = U.clone()
    out[idx] = U[idx] * scale
    return out


def lazy_worker_attack(U: torch.Tensor, malicious: torch.Tensor,
                       prev_U: torch.Tensor) -> torch.Tensor:
    """Malicious clients replay their previous round's update."""
    idx = _rows(malicious)
    out = U.clone()
    out[idx] = prev_U[idx]
    return out


# ---------------------------------------------------------- data poisoning
def label_flip(y: np.ndarray, num_classes: int,
               original_class: Optional[int] = None,
               target_class: Optional[int] = None) -> np.ndarray:
    """original -> target, or the mirror y -> C - 1 - y when unset."""
    y = np.array(y, copy=True)
    if original_class is None or target_class is None:
        return (num_classes - 1 - y).astype(y.dtype)
    y[y == original_class] = target_class
    return y


def backdoor_trigger(x: np.ndarray, y: np.ndarray, target_class: int,
                     trigger_value: float = 1.0, patch: int = 3) -> tuple:
    """A corner pixel patch stamped on every sample, relabelled to the
    target class."""
    x = np.array(x, copy=True)
    if x.ndim >= 3:
        x[..., :patch, :patch, :] = trigger_value
    else:
        x[..., :patch] = trigger_value
    return x, np.full_like(y, target_class)


def poison_clients_data(data: dict, client_ids: list,
                        transform: Callable[[np.ndarray, np.ndarray], tuple]
                        ) -> dict:
    """(x, y) -> (x, y) applied to the chosen clients of the stacked
    dataset."""
    x = np.array(data["x"], copy=True)
    y = np.array(data["y"], copy=True)
    for cid in client_ids:
        x[cid], y[cid] = transform(x[cid], y[cid])
    return {**data, "x": x, "y": y}


# ------------------------------------------------- labels from gradients
def reveal_labels_from_gradients(fc_weight_grad: torch.Tensor
                                 ) -> torch.Tensor:
    """iDLG (Zhao et al.): under cross-entropy the true class's row of the
    last layer's weight gradient is the only negative one."""
    g = fc_weight_grad
    return torch.argmin(g.reshape(g.shape[0], -1).sum(1))


def _infer_label_from_grads(true_grads: Tree, num_classes: int):
    """The class from a classifier-head leaf of the gradients: a bias of
    size C, else a kernel with C output columns; None if there is none."""
    leaves = tree_leaves(true_grads)
    for leaf in leaves:
        if leaf.dim() == 1 and leaf.shape[0] == num_classes:
            return torch.argmin(leaf)
    for leaf in leaves:
        if leaf.dim() == 2 and leaf.shape[-1] == num_classes:
            return torch.argmin(leaf.sum(0))
    return None


# ------------------------------------------------- gradient reconstruction
def _label_onehot(true_grads: Tree, num_classes: int,
                  device) -> torch.Tensor:
    label = _infer_label_from_grads(true_grads, num_classes)
    if label is None:
        label = torch.zeros((), dtype=torch.int64, device=device)
    return torch.nn.functional.one_hot(
        label.reshape(1), num_classes).to(torch.float32)


def _model_grads(apply_fn: Callable, params: Tree, y_onehot: torch.Tensor):
    """x -> the gradient w.r.t. `params` of the cross-entropy of
    `apply_fn(params, x)` against `y_onehot` (a function of x that
    `torch.func.grad` differentiates again)."""
    def loss_fn(p, x):
        logp = torch.log_softmax(apply_fn(p, x), dim=-1)
        return -(y_onehot * logp).sum(-1).mean()

    grad = torch.func.grad(loss_fn)
    return lambda x: grad(params, x)


def _adam_steps(objective: Callable, x0: torch.Tensor, steps: int,
                lr: float, signed: bool = False,
                box: Optional[tuple] = None):
    """`steps` Adam steps (optax's defaults, as the port's client
    optimizer computes them) on `objective(x)` from x0; `signed` steps on
    the gradient's sign, `box` clips x after each step. Returns (x, the
    [steps] objective values, each before its step)."""
    from ..core.algorithm import make_client_optimizer

    opt = make_client_optimizer("adam", lr)
    value_grad = torch.func.grad_and_value(objective)
    x = {"x": x0}
    state = opt.init(x)
    losses = []
    for i in range(steps):
        g, loss = value_grad(x["x"])
        losses.append(loss.detach())
        x, state = opt.step(x, {"x": torch.sign(g) if signed else g}, state,
                            i + 1)
        if box is not None:
            x = {"x": torch.clamp(x["x"], box[0], box[1])}
        x = {"x": x["x"].detach()}
    return x["x"], torch.stack(losses)


def dlg_attack(apply_fn: Callable, params: Tree, true_grads: Tree,
               data_shape: tuple, num_classes: int,
               x0: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               steps: int = 200, lr: float = 0.1, loss_type: str = "l2"):
    """Deep Leakage from Gradients (reference: dlg_attack.py; Zhu et al.
    2019) and its cosine variant (loss_type "cosine"; Geiping et al.
    2020). The label is recovered from the classifier head's gradient
    (iDLG, Zhao et al. 2020), then only x is optimised, by Adam on the
    gradient match: the summed squared difference of every leaf, or one
    minus their global cosine. `apply_fn(params, x) -> logits`; `x0`
    (shape (1, *data_shape)) is the start, by default a standard normal
    draw from `generator`. Returns (x reconstructed, the one-hot label
    [1, C], the [steps] match losses, each before its step)."""
    dev = next(iter(true_grads.values())).device
    y_onehot = _label_onehot(true_grads, num_classes, dev)
    if x0 is None:
        x0 = torch.randn((1,) + tuple(data_shape), generator=generator,
                         device=dev)
    grads_of = _model_grads(apply_fn, params, y_onehot)
    names = list(true_grads)

    def match_loss(x):
        g = grads_of(x)
        pairs = [(g[k], true_grads[k]) for k in names]
        if loss_type == "cosine":
            num = sum((a * b).sum() for a, b in pairs)
            den = torch.sqrt(sum((a * a).sum() for a, _ in pairs)) \
                * torch.sqrt(sum((b * b).sum() for _, b in pairs))
            return 1.0 - num / torch.clamp(den, min=1e-12)
        return sum(((a - b) ** 2).sum() for a, b in pairs)

    x, losses = _adam_steps(match_loss, x0, steps, lr)
    return x, y_onehot, losses


def invert_gradient_attack(apply_fn: Callable, params: Tree,
                           true_grads: Tree, data_shape: tuple,
                           num_classes: int,
                           x0: Optional[torch.Tensor] = None,
                           generator: Optional[torch.Generator] = None,
                           steps: int = 300, lr: float = 0.1,
                           tv_weight: float = 1e-2,
                           box: tuple = (0.0, 1.0)):
    """Inverting Gradients (reference: invert_gradient_attack.py; Geiping
    et al. 2020): one minus the mean per-layer cosine between the dummy
    input's gradient and the shared one, plus a total-variation prior
    (`tv_weight`) on the NHWC input, minimised by Adam on the gradient's
    sign with x clipped to `box` after each step. The label comes from
    iDLG first. `x0` is the start, by default uniform in `box` from
    `generator`. Returns (x reconstructed, the one-hot label [1, C], the
    [steps] objective values, each before its step)."""
    dev = next(iter(true_grads.values())).device
    y_onehot = _label_onehot(true_grads, num_classes, dev)
    if x0 is None:
        x0 = box[0] + (box[1] - box[0]) * torch.rand(
            (1,) + tuple(data_shape), generator=generator, device=dev)
    grads_of = _model_grads(apply_fn, params, y_onehot)
    names = list(true_grads)

    def total_variation(x):
        dh = (x[:, 1:] - x[:, :-1]).abs().mean() if x.dim() >= 3 else 0.0
        dw = (x[:, :, 1:] - x[:, :, :-1]).abs().mean() \
            if x.dim() >= 4 else 0.0
        return dh + dw

    def objective(x):
        g = grads_of(x)
        # per-layer cosine (Geiping eq. 4 sums layerwise), not one global
        # dot product
        sims = torch.stack([
            (g[k] * true_grads[k]).sum() / torch.clamp(
                torch.linalg.vector_norm(g[k])
                * torch.linalg.vector_norm(true_grads[k]), min=1e-12)
            for k in names])
        return 1.0 - sims.mean() + tv_weight * total_variation(x)

    x, losses = _adam_steps(objective, x0, steps, lr, signed=True, box=box)
    return x, y_onehot, losses
