"""Attacks for robustness testing (port of the model- and data-poisoning
parts of `fedml_tpu/security/attacks.py`, and its label inference from
gradients).

Model poisoning transforms the flat stacked updates U [m, D] of the
clients a boolean mask marks malicious, and returns a new matrix (U is
left as it is: the round's health stats read it after the hook). Data
poisoning transforms the host's numpy arrays before they reach the
device. The gradient-inversion attacks (DLG, inverting gradients) are
ROADMAP port-queue item 3e.2.
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
