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
instead (the tests hand over the JAX draws this way).

Data parallelism inside a silo (the JAX trainer's `mesh=`, the
reference's DDP ranks) takes one of two meshes:

- a `DeviceMesh` with a `data_axis` ("data"): the trainer runs SPMD, one
  in every rank of the mesh with the same arguments. It pads the shard
  to a multiple of the axis size with zero-mask rows, as JAX's does, and
  counts only the real samples; the batch order is drawn over the padded
  rows. Each step, rank k takes block k of the global batch's positions
  and `parallel/hier.hier_local_sgd` all-reduces the gradient over the
  axis and divides by the global count, so every rank applies the flat
  batch-mean step and holds the same parameters.
- a `SiloMesh` (`cross_silo/hierarchical.silo_mesh`): the silo's ranks run
  as a world of their own (`parallel/launch.RankPool`), and this trainer,
  in the calling process, drives them: it ships the shard once, then each
  round the global parameters (and a given batch order), and takes rank
  0's result back, the shape of the reference's master and slave ranks
  (fedml_client_master_manager.py:195-207). The model is pickled to the
  ranks, so it must be a module (a callable `apply_fn` must be
  importable by name). `rank_stats` holds each rank's inner all-reduce
  count, peak device memory and K1-K4 launches (`ops/`) after a round.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import uuid

import numpy as np
import torch
from torch import nn

from .._device import deterministic_cuda, resolve_device
from ..core.algorithm import (
    ClientMetrics, local_sgd, make_batch_indices, make_client_optimizer,
    make_objective,
)
from ..config import TrainArgs
from ..models import hub
from ..ops import keys
from ..ops.tree import tree_leaves, tree_map
from ..parallel import mesh as mesh_mod

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


class SiloMesh:
    """A silo's intra-silo mesh driven from this process: one rank per
    entry of `devices` (NCCL on distinct GPUs, gloo otherwise), a world of
    their own with a 1-D `data_axis` mesh over it; `setup` runs once in
    each rank (`RankPool`). `close()` stops the ranks (so does interpreter
    exit) and returns their exit codes."""

    def __init__(self, devices, data_axis: str = "data",
                 timeout_s: float = 600.0, setup: Optional[Callable] = None):
        from ..parallel.launch import RankPool

        self.data_axis = data_axis
        self.pool = RankPool(devices, timeout_s=timeout_s, setup=setup)

    @property
    def size(self) -> int:
        return self.pool.size

    def close(self) -> list:
        return self.pool.close()


# rank side of a SiloMesh: this process's trainers and its data mesh
_RANK_TRAINERS: dict = {}
_RANK_MESH: dict = {}


def _rank_build(key: str, model, t, x, y, data_axis: str, seed: int):
    from ..parallel.launch import current

    info = current()
    if data_axis not in _RANK_MESH:
        _RANK_MESH[data_axis] = mesh_mod.make_mesh({data_axis: info.world})
    _RANK_TRAINERS[key] = SiloTrainer(
        model, t, x, y, mesh=_RANK_MESH[data_axis], data_axis=data_axis,
        seed=seed, device=info.device)


def _rank_train(key: str, params_np, round_idx: int, idx):
    from ..ops import flash_attention as fa
    from ..ops import paged_attention as pa
    from ..parallel import hier
    from ..parallel.launch import current

    tr = _RANK_TRAINERS[key]
    if idx is not None:
        tr.batch_schedule = lambda _r: idx
    before = hier.allreduce_steps
    out = tr.train(params_np, round_idx)
    dev = current().device
    stats = {"allreduce_steps": hier.allreduce_steps - before,
             "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                            if dev.type == "cuda" else 0),
             "kernel_launches": sum(fa.launch_count.values())
             + pa.launch_count}
    return (out if current().rank == 0 else None), stats


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
                 x: np.ndarray, y: np.ndarray, mesh=None,
                 data_axis: str = "data", seed: int = 0, device=None,
                 batch_schedule: Optional[Callable] = None):
        self.t = t
        self.seed = seed
        self.batch_schedule = batch_schedule
        self.mesh = mesh
        self.data_axis = data_axis
        self.n_samples = int(x.shape[0])
        # rejoin memo: a re-attach or a server resume re-sends the in-flight
        # round, and a round's inputs are deterministic (same round index,
        # same incoming parameters, same local result), so the last round
        # is cached and a re-send becomes an equality check
        self._memo: Optional[tuple] = None   # (round_idx, params_np, result)
        self.rank_stats: list = []   # a SiloMesh's ranks', after a round
        if isinstance(mesh, SiloMesh):
            # the silo's ranks hold the shard and train; this is the master
            self._key = uuid.uuid4().hex
            mesh.pool.run(_rank_build, self._key, model, t, x, y,
                          mesh.data_axis, seed)
            return
        mesh_mod.check_mesh(mesh, "the silo trainer's mesh")
        self.device = resolve_device(device)
        deterministic_cuda(self.device)
        self.apply_fn = (hub.apply_fn(hub.structure_copy(model),
                                      t.compute_dtype)
                         if isinstance(model, nn.Module) else model)
        mask = np.ones(x.shape[0], np.float32)
        if mesh is not None:
            # intra-silo data parallelism: pad to the axis size with
            # zero-mask rows (the batch order is drawn over them too)
            pad = (-x.shape[0]) % mesh_mod.axis_size(mesh, data_axis)
            x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
            y = np.concatenate([y, np.zeros((pad,) + y.shape[1:], y.dtype)])
            mask = np.concatenate([mask, np.zeros(pad, np.float32)])
        self.x = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        self.y = torch.from_numpy(np.ascontiguousarray(y)).to(self.device)
        self.mask = torch.from_numpy(mask).to(self.device)
        self.opt = make_client_optimizer(
            t.client_optimizer, t.learning_rate, t.momentum, t.weight_decay)
        self.objective = make_objective(t.extra.get("task"))

    def batch_indices(self, round_idx: int) -> torch.Tensor:
        """The round's [steps, B] batch order over the (padded) shard."""
        if self.batch_schedule is not None:
            idx = torch.from_numpy(np.array(self.batch_schedule(round_idx),
                                            dtype=np.int64))
        else:
            idx = make_batch_indices(
                keys.generator(keys.fold(self.seed, round_idx)),
                self.x.shape[0], self.t.batch_size, self.t.epochs)
        return idx.to(device=self.device, dtype=torch.int64)

    def _local(self, params, idx):
        """The local steps: flat, or this rank's block of each batch with
        the gradient all-reduced over the data axis."""
        shard = {"x": self.x, "y": self.y, "mask": self.mask}
        if self.mesh is None:
            p, m, _steps = local_sgd(self.apply_fn, params, shard, idx,
                                     self.opt, objective=self.objective)
            return p, m
        from ..parallel.hier import hier_local_sgd

        d = mesh_mod.axis_size(self.mesh, self.data_axis)
        k = mesh_mod.axis_index(self.mesh, self.data_axis)
        pos = np.array_split(np.arange(idx.shape[1]), d)[k]
        p, sums = hier_local_sgd(
            self.apply_fn, params, shard, idx[:, torch.from_numpy(pos).to(
                idx.device)], self.opt, self.mesh, self.data_axis,
            self.objective)
        return p, ClientMetrics(*sums)

    def train(self, params_np: Pytree, round_idx: int):
        """(params numpy tree) -> (new params numpy tree, n, metrics), the
        ClientTrainer.train contract (reference: client_trainer.py:52). A
        repeat of the memoised round with bit-identical incoming parameters
        (a durability re-send) returns the cached result."""
        if self._memo is not None and self._memo[0] == round_idx \
                and _same_tree(self._memo[1], params_np):
            return self._memo[2]
        if isinstance(self.mesh, SiloMesh):
            idx = (None if self.batch_schedule is None else np.asarray(
                self.batch_schedule(round_idx), np.int64))
            outs = self.mesh.pool.run(_rank_train, self._key, params_np,
                                      round_idx, idx)
            self.rank_stats = [st for _out, st in outs]
            result = outs[0][0]
            self._memo = (round_idx, params_np, result)
            return result
        params = tree_map(lambda a: torch.as_tensor(np.asarray(a)).to(
            self.device), params_np)
        new_params, m = self._local(params, self.batch_indices(round_idx))
        stats = torch.stack([m.loss_sum, m.correct, m.count]).float()
        out, (loss_sum, correct, cnt) = to_host(new_params, stats)
        metrics = {
            "train_loss": float(loss_sum) / max(float(cnt), 1.0),
            "train_acc": float(correct) / max(float(cnt), 1.0),
        }
        result = (out, self.n_samples, metrics)
        self._memo = (round_idx, params_np, result)
        return result
