"""Centralized (non-federated) baseline trainer (port of
`fedml_tpu/centralized/__init__.py`; reference:
python/fedml/centralized/centralized_trainer.py).

The stacked client shards are pooled into one shard on the device, put
once, and each epoch is one `core/algorithm.py:local_sgd` over it, the
same local step the federated rounds run, so a comparison isolates the
federation and not the implementation. The optimizer state (momentum,
Adam's moments and step count) carries across epochs, as in ordinary
training. Each epoch records a `centralized_epoch` span and sets the
`fed.epoch` gauge; the last one evaluates on the test set.

Batches come from the port's generators (`ops/keys.py`, keyed by
(random_seed, epoch)); `run(batch_idx=)` takes one [steps, B] schedule an
epoch instead (the tests hand over the JAX package's).

A `device_args.mesh_shape` naming an `mp` axis trains model-parallel,
SPMD in every rank of the world (`parallel/mesh.make_mesh`): the params
resolve through the partition-rule registry (the model's table,
`table_for_model`, unless `device_args.partition_rules` names one;
`device_args.unmatched_params` is the unmatched policy, an error by
default), each rank keeps its shard (`self.params`, laid out by
`self.param_specs` through every epoch), and every column-split Dense /
Conv / Embed computes its block of output features and all-gathers them
(`models/hub.py`); the backward keeps the rank's block of the gradient,
which every rank holds whole. The pooled data and the batch order are
the same on every rank. `partition.unshard_params(trainer.params, mesh,
trainer.param_specs)` gathers the whole parameters back.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .._device import deterministic_cuda, resolve_device
from ..config import Config
from ..core.algorithm import (
    eval_row, local_sgd, make_batch_indices, make_client_optimizer,
    make_eval_fn, make_objective, pad_test_batches, eval_labels,
)
from ..data.fed_dataset import FedDataset
from ..models import hub as model_hub
from ..ops import keys
from ..utils import metrics as _mx
from ..utils.events import recorder
from ..utils.prometheus import maybe_start_metrics_server


def pool_clients(dataset: FedDataset) -> dict:
    """The stacked [N, S, ...] client shards as one pooled shard, padding
    rows (mask 0) dropped. Per-sample targets keep their trailing axes
    (token [T] and pixel [H, W] labels), where the JAX function flattens
    them and then cannot index them by the [N * S] mask."""
    x = np.asarray(dataset.x_train).reshape(
        (-1,) + dataset.x_train.shape[2:])
    y = np.asarray(dataset.y_train).reshape(
        (-1,) + dataset.y_train.shape[2:])
    m = np.asarray(dataset.mask_train).reshape(-1)
    keep = m > 0
    return {"x": x[keep], "y": y[keep],
            "mask": np.ones(int(keep.sum()), np.float32)}


class CentralizedTrainer:
    """Plain training on the pooled data (reference:
    centralized_trainer.py). `device=None` takes the device `init`
    recorded, else CUDA (raising without a GPU); `params`, the initial
    parameters (a dict as `hub.init_params` returns, tensors or numpy
    arrays), by default drawn
    from a generator seeded with `common_args.random_seed`."""

    def __init__(self, cfg: Config, dataset: Optional[FedDataset] = None,
                 model=None, device=None, params=None):
        from ..data import loader as data_loader

        self.device = resolve_device(
            device if device is not None
            else cfg.device_args.extra.get("device"))
        deterministic_cuda(self.device)
        self.cfg = cfg
        t = cfg.train_args
        # opt-in live /metrics endpoint (common_args.extra.metrics_port)
        self.metrics_exporter = maybe_start_metrics_server(cfg)
        self.dataset = dataset if dataset is not None \
            else data_loader.load(cfg)
        self.model = model if model is not None else model_hub.create(
            cfg.model_args.model, self.dataset.num_classes,
            self.dataset.x_train.shape[2:], device="meta",
            **cfg.model_args.extra)
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(cfg.common_args.random_seed))
            params = model_hub.init_params(self.model, gen)
        self.params = {k: torch.as_tensor(v).to(self.device)
                       for k, v in params.items()}
        self.mesh = None
        self.param_specs = None
        mesh_shape = cfg.device_args.mesh_shape
        if mesh_shape and "mp" in mesh_shape:
            self._shard(mesh_shape, cfg.device_args.extra)
        self.apply_fn = model_hub.apply_fn(self.model, t.compute_dtype)
        pooled = pool_clients(self.dataset)
        self.pooled = {
            "x": torch.from_numpy(np.ascontiguousarray(pooled["x"])).to(
                self.device),
            "y": torch.from_numpy(pooled["y"]).to(self.device),
            "mask": torch.from_numpy(pooled["mask"]).to(self.device)}
        self.opt = make_client_optimizer(
            t.client_optimizer, t.learning_rate, t.momentum, t.weight_decay)
        # (optimizer state, steps taken): persists across epochs
        self.opt_state = None
        self.objective = make_objective(t.extra.get("task"))
        xb, yb, mb = pad_test_batches(
            self.dataset.x_test, self.dataset.y_test, max(t.batch_size, 64))
        self._test = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device) for a in (xb, eval_labels(yb), mb))
        self._eval = make_eval_fn(self.apply_fn, t.extra.get("task"),
                                  self.dataset.num_classes)
        self.history: list[dict] = []

    def _shard(self, mesh_shape: dict, extra: dict) -> None:
        """The model-parallel layout (module docstring): resolve, shard,
        and mark each split layer of a private copy of the model."""
        from ..parallel import partition
        from ..parallel.mesh import make_mesh
        from ..parallel.tensor import TPContext

        self.mesh = make_mesh(mesh_shape)
        table = (extra.get("partition_rules")
                 or partition.table_for_model(self.model))
        self.param_specs = partition.resolve(
            table, self.params, axis="mp",
            on_unmatched=extra.get("unmatched_params", partition.ERROR))
        self.params = partition.shard_params(self.params, self.mesh,
                                             specs=self.param_specs)
        self.model = model_hub.split_layers(self.model, self.param_specs,
                                            TPContext(self.mesh, "mp"))

    def _schedule(self, epoch: int) -> torch.Tensor:
        gen = keys.generator(keys.fold(self.cfg.common_args.random_seed,
                                       epoch))
        return make_batch_indices(gen, self.pooled["y"].shape[0],
                                  self.cfg.train_args.batch_size, 1)

    def _epoch(self, epoch: int, batch_idx=None):
        """One pass over the pooled shard -> (loss sum, correct, count),
        each a 0-d tensor on the device."""
        idx = self._schedule(epoch) if batch_idx is None \
            else torch.as_tensor(np.array(batch_idx, np.int64))
        self.params, metrics, _steps, self.opt_state = local_sgd(
            self.apply_fn, self.params, self.pooled, idx.to(self.device),
            self.opt, objective=self.objective, opt_state=self.opt_state,
            return_opt_state=True)
        return metrics.loss_sum, metrics.correct, metrics.count

    def evaluate(self) -> dict:
        return eval_row(self._eval(self.params, *self._test))

    def run(self, epochs: Optional[int] = None,
            batch_idx=None) -> list[dict]:
        """`epochs` epochs (default train_args.epochs), one history row
        each; `batch_idx[e]`, when given, is epoch e's [steps, B] order."""
        n_epochs = epochs if epochs is not None \
            else self.cfg.train_args.epochs
        for e in range(n_epochs):
            _mx.set_gauge("fed.epoch", float(e))
            with recorder.span("centralized_epoch", epoch=e):
                lsum, correct, cnt = self._epoch(
                    e, None if batch_idx is None else batch_idx[e])
            n = max(float(cnt), 1.0)
            row = {"epoch": e, "train_loss": float(lsum) / n,
                   "train_acc": float(correct) / n}
            if e == n_epochs - 1:
                row.update(self.evaluate())
            self.history.append(row)
            recorder.log(row)
        return self.history
