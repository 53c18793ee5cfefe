"""Silo-side trainer (port of `fedml_tpu/cross_silo/trainer.py`; reference:
cross_silo/client/fedml_trainer.py:66-77).

The silo's shard lives on the card, and a round runs the port's functional
`core/algorithm.py:local_sgd`, the same local step the Simulator runs. The
host sees numpy trees only: `train(params_np, round_idx) -> (new params as
a numpy tree, n, metrics)`, the incoming parameters copied onto the card
and the result fetched back in one transfer, the trainer's one host sync.

The batch order comes from a `torch.Generator` keyed by (seed, round)
(`ops/keys.py`), not from JAX's `fold_in(key(seed), round)`: the bits
differ by design, as the Simulator's do (ROADMAP C, deviations).
`batch_schedule(round_idx)`, when given, returns the [steps, B] order
instead (the tests hand over the JAX draws this way). The intra-silo
device mesh (the JAX trainer's `mesh=`, data parallelism inside a silo)
is refused, naming ROADMAP 'Port queue' item 4.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import nn

from .._device import deterministic_cuda, resolve_device
from ..core.algorithm import (
    local_sgd, make_batch_indices, make_client_optimizer, make_objective,
)
from ..config import TrainArgs
from ..models import hub
from ..ops import keys
from ..ops.tree import tree_leaves, tree_map

Pytree = Any


def _same_tree(a, b) -> bool:
    """Bitwise equality of two host trees of the same structure."""
    try:
        la, lb = tree_leaves(a), tree_leaves(b)
    except (TypeError, KeyError):
        return False
    if len(la) != len(lb):
        return False
    return all(np.array_equal(np.asarray(x), np.asarray(y))
               and np.asarray(x).dtype == np.asarray(y).dtype
               for x, y in zip(la, lb))


def to_host(tree, extra: torch.Tensor) -> tuple:
    """(tree as numpy, `extra` as numpy) in one device-to-host transfer when
    every leaf has `extra`'s dtype; leaf by leaf otherwise."""
    leaves = tree_leaves(tree)
    if any(t.dtype != extra.dtype for t in leaves):
        return tree_map(lambda t: t.detach().cpu().numpy(), tree), \
            extra.detach().cpu().numpy()
    flat = torch.cat([t.detach().reshape(-1) for t in leaves]
                     + [extra.reshape(-1)]).cpu().numpy()
    offs = np.cumsum([0] + [t.numel() for t in leaves])
    it = iter(range(len(leaves)))

    def take(t):
        i = next(it)
        return flat[offs[i]:offs[i + 1]].reshape(tuple(t.shape))

    return tree_map(take, tree), flat[offs[-1]:]


class SiloTrainer:
    """Local trainer over one silo's shard on the card. `model` is either
    a module of `models/hub.py` (its parameters may live anywhere, "meta"
    included), which the trainer applies through a structure-only copy of
    its own (`hub.structure_copy`, since silos in one process train
    concurrently) at `t.compute_dtype`, federating all its parameters; or
    a `(params, x) -> logits` callable, the JAX trainer's `apply_fn`,
    federating whatever tree `params` is. The live loop hands over
    `llm.lora.lora_apply_fn` of one shared `TransformerLM`: the federated
    tree is the adapter dict, which reaches the forward as an argument,
    so silo threads share the frozen base without swapping tensors into
    it. `device=None` means CUDA, and raises without a GPU."""

    def __init__(self, model: nn.Module | Callable, t: TrainArgs,
                 x: np.ndarray, y: np.ndarray, mesh=None, seed: int = 0,
                 device=None,
                 batch_schedule: Optional[Callable] = None):
        if mesh is not None:
            raise NotImplementedError(
                "an intra-silo device mesh is not ported yet (ROADMAP 'Port "
                "queue' item 4, multi-GPU)")
        self.device = resolve_device(device)
        deterministic_cuda(self.device)
        self.apply_fn = (hub.apply_fn(hub.structure_copy(model),
                                      t.compute_dtype)
                         if isinstance(model, nn.Module) else model)
        self.t = t
        self.x = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        self.y = torch.from_numpy(np.ascontiguousarray(y)).to(self.device)
        self.mask = torch.ones(self.x.shape[0], dtype=torch.float32,
                               device=self.device)
        self.n_samples = int(self.x.shape[0])
        self.opt = make_client_optimizer(
            t.client_optimizer, t.learning_rate, t.momentum, t.weight_decay)
        self.objective = make_objective(t.extra.get("task"))
        self.seed = seed
        self.batch_schedule = batch_schedule
        # rejoin memo: a re-attach or a server resume re-sends the in-flight
        # round, and a round's inputs are deterministic (same round index,
        # same incoming parameters, same local result), so the last round
        # is cached and a re-send becomes an equality check
        self._memo: Optional[tuple] = None   # (round_idx, params_np, result)

    def batch_indices(self, round_idx: int) -> torch.Tensor:
        if self.batch_schedule is not None:
            idx = torch.from_numpy(np.array(self.batch_schedule(round_idx),
                                            dtype=np.int64))
        else:
            idx = make_batch_indices(
                keys.generator(keys.fold(self.seed, round_idx)),
                self.n_samples, self.t.batch_size, self.t.epochs)
        return idx.to(device=self.device, dtype=torch.int64)

    def train(self, params_np: Pytree, round_idx: int):
        """(params numpy tree) -> (new params numpy tree, n, metrics), the
        ClientTrainer.train contract (reference: client_trainer.py:52). A
        repeat of the memoised round with bit-identical incoming parameters
        (a durability re-send) returns the cached result."""
        if self._memo is not None and self._memo[0] == round_idx \
                and _same_tree(self._memo[1], params_np):
            return self._memo[2]
        params = tree_map(lambda a: torch.as_tensor(np.asarray(a)).to(
            self.device), params_np)
        shard = {"x": self.x, "y": self.y, "mask": self.mask}
        new_params, m, _steps = local_sgd(
            self.apply_fn, params, shard, self.batch_indices(round_idx),
            self.opt, objective=self.objective)
        stats = torch.stack([m.loss_sum, m.correct, m.count]).float()
        out, (loss_sum, correct, cnt) = to_host(new_params, stats)
        metrics = {
            "train_loss": float(loss_sum) / max(float(cnt), 1.0),
            "train_acc": float(correct) / max(float(cnt), 1.0),
        }
        result = (out, self.n_samples, metrics)
        self._memo = (round_idx, params_np, result)
        return result
