"""Asynchronous FedAvg simulation with staleness-weighted merging (port of
`fedml_tpu/simulation/async_simulator.py`; reference:
simulation/mpi/async_fedavg/).

A host-side discrete-event loop over two device steps:

  train_one(snapshot, client id, seq) -> (client params, metrics)
  merge(global, client, alpha_eff)    -> (1 - alpha_eff) g + alpha_eff c

Each client has a lognormal speed factor; completion events pop in time
order, and the merge weight decays with the staleness tau = server
version - the version the client started from (FedAsync, Xie et al.
2019: alpha_t = alpha (1 + tau)^-a). A client that never completes never
merges; nothing waits for it.

An event holds the snapshot of the global parameters it was launched
with. The merge builds new tensors and never writes the global
parameters in place, so a snapshot that a pending event holds stays the
parameters it was launched with.

Draws: the client choice (RandomState(seed + 1)), the speeds
(RandomState(seed).lognormal) and the chaos stream (RandomState(chaos
seed + seed + 0xFA17)) are numpy's, so the sequence of clients, sim
times, staleness, dropouts and stragglers is bitwise the JAX package's.
Event `seq`'s batch order comes from a generator keyed (seed, seq)
(`ops/keys.py`), where JAX folds seq into its key; `run(batch_idx=)`
takes the orders as a function of seq (the tests hand JAX's over).

With `train_args.cost_model` each merged client's simulated duration
feeds `schedule.CostModel` (per client, not amortised over a round), and
its `fed.cost_model.*` gauges refresh on the eval cadence; the loop
itself places nothing.
"""
from __future__ import annotations

import heapq
from typing import Callable, Optional

import numpy as np
import torch

from .. import schedule as lpt_sched
from .._device import deterministic_cuda, resolve_device
from ..comm.chaos import FaultSpec
from ..config import Config
from ..core.algorithm import (
    eval_labels, eval_row, local_sgd, make_batch_indices,
    make_client_optimizer, make_eval_fn, make_objective, pad_test_batches,
)
from ..data import loader as data_loader
from ..data.fed_dataset import FedDataset
from ..models import hub as model_hub
from ..ops import keys
from ..utils import metrics as _mx
from ..utils.events import recorder
from ..utils.health import record_participation, record_staleness
from ..utils.prometheus import maybe_start_metrics_server


def staleness_weight(alpha: float, tau, a: float = 0.5,
                     mode: str = "polynomial") -> torch.Tensor:
    """FedAsync's mixing weight as a 0-d f32 tensor: alpha (1 + tau)^-a
    ("polynomial", the default) or alpha ("constant", the reference's
    async_fedavg)."""
    alpha32 = np.float32(alpha)
    if mode == "constant":
        return torch.tensor(alpha32)
    return torch.tensor(alpha32 * np.float32(1.0 + tau) ** np.float32(-a))


class AsyncSimulator:
    """Event-driven async FL on one device. Config knobs
    (train_args.extra): async_concurrency (clients training at once,
    default 4), async_alpha (0.6), async_staleness ("polynomial" |
    "constant"), async_poly_a (0.5), async_speed_spread (the lognormal
    sigma of client speeds, 1.0), chaos_straggler_factor (4.0). A run
    merges comm_round x client_num_per_round updates.

    `device=None` takes `device_args.extra["device"]`, else CUDA;
    `params`, the initial global parameters, by default `hub.init_params`
    from a generator seeded with `common_args.random_seed`."""

    def __init__(self, cfg: Config, dataset: Optional[FedDataset] = None,
                 model=None, device=None, params=None):
        self.cfg = cfg
        t = cfg.train_args
        # the event loop trains one client at a time: there is no stacked
        # cohort to chunk, so the sync simulator's knobs are refused
        for knob in ("cohort_chunk", "ingest_prefetch"):
            if t.extra.get(knob) is not None:
                raise ValueError(
                    f"train_args.{knob} has no effect on the async "
                    "simulator (its event loop dispatches one client at a "
                    "time); remove it or run the sync simulator")
        self.device = resolve_device(
            device if device is not None
            else cfg.device_args.extra.get("device"))
        deterministic_cuda(self.device)
        ds = self.dataset = (dataset if dataset is not None
                             else data_loader.load(cfg))
        self.model = model if model is not None else model_hub.create(
            cfg.model_args.model, ds.num_classes, ds.x_train.shape[2:],
            device="meta", **cfg.model_args.extra)
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(cfg.common_args.random_seed))
            params = model_hub.init_params(self.model, gen)
        self.params = {k: v.to(self.device) for k, v in params.items()}

        self.concurrency = int(t.extra.get("async_concurrency", 4))
        self.alpha = float(t.extra.get("async_alpha", 0.6))
        self.staleness_mode = str(t.extra.get("async_staleness", "polynomial"))
        self.poly_a = float(t.extra.get("async_poly_a", 0.5))
        spread = float(t.extra.get("async_speed_spread", 1.0))
        # chaos client faults inject at the event queue: a dropout's
        # completion is discarded unmerged, a straggler trains at a
        # fraction of its speed (it merges later, staler)
        self.fault_spec = FaultSpec.from_config(cfg)
        self.straggler_factor = float(t.extra.get("chaos_straggler_factor",
                                                  4.0))
        self.metrics_exporter = maybe_start_metrics_server(cfg)
        rs = np.random.RandomState(cfg.common_args.random_seed)
        # each client's wall time per unit of work (lognormal heterogeneity)
        self.client_time = rs.lognormal(0.0, spread, ds.num_clients)
        # the Parrot cost model: the event loop sees every client's own
        # completion time, recorded per merged client
        self.cost_model = lpt_sched.CostModel.from_config(
            t.extra.get("cost_model"),
            {i: int(c) for i, c in enumerate(np.asarray(ds.counts))})

        self.data = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
            self.device) for k, v in (("x", ds.x_train), ("y", ds.y_train),
                                      ("mask", ds.mask_train))}
        self._opt = make_client_optimizer(
            t.client_optimizer, t.learning_rate, t.momentum, t.weight_decay)
        self.apply_fn = model_hub.apply_fn(self.model, t.compute_dtype)
        self._objective = make_objective(t.extra.get("task"))
        self._eval = make_eval_fn(self.apply_fn, t.extra.get("task"),
                                  ds.num_classes)
        xb, yb, mb = pad_test_batches(ds.x_test, ds.y_test,
                                      max(t.batch_size, 64))
        self._test = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device) for a in (xb, eval_labels(yb), mb))
        self.version = 0
        self.history: list[dict] = []

    def _sample_client(self, rs: np.random.RandomState) -> int:
        return int(rs.randint(self.dataset.num_clients))

    def _batch_order(self, seq: int) -> torch.Tensor:
        t = self.cfg.train_args
        gen = keys.generator((self.cfg.common_args.random_seed, seq))
        return make_batch_indices(gen, self.data["y"].shape[1],
                                  t.batch_size, t.epochs)

    def _train_one(self, params: dict, cid: int, batch_idx):
        """One client's local training from `params` (its snapshot)."""
        shard = {k: v[cid] for k, v in self.data.items()}
        idx = (batch_idx if isinstance(batch_idx, torch.Tensor)
               else torch.from_numpy(np.array(batch_idx))).to(self.device)
        new_params, metrics, _ = local_sgd(
            self.apply_fn, params, shard, idx, self._opt,
            objective=self._objective)
        return new_params, metrics

    @staticmethod
    def _merge(global_p: dict, client_p: dict, alpha_eff: torch.Tensor):
        """(1 - a) g + a c into new tensors, in JAX's order of operations;
        `global_p` itself (a snapshot pending events may hold) is never
        written."""
        return {k: (1.0 - alpha_eff.to(g.device)) * g
                + alpha_eff.to(g.device) * client_p[k]
                for k, g in global_p.items()}

    def evaluate(self) -> dict:
        with torch.no_grad():
            return eval_row(self._eval(self.params, *self._test))

    def run(self, num_updates: Optional[int] = None,
            batch_idx: Optional[Callable] = None) -> list[dict]:
        """Merge `num_updates` updates (default comm_round x
        client_num_per_round). `batch_idx(seq)`, when given, is event
        seq's [steps, B] batch order."""
        t = self.cfg.train_args
        total = (num_updates if num_updates is not None
                 else t.comm_round * t.client_num_per_round)
        seed = self.cfg.common_args.random_seed
        rs = np.random.RandomState(seed + 1)
        spec = self.fault_spec
        rs_fault = np.random.RandomState(
            ((spec.seed if spec else 0) + seed + 0xFA17) % (2 ** 31))
        order = batch_idx or self._batch_order

        # (finish time, seq, client id, start version, snapshot)
        heap: list = []
        seq = 0

        def launch(now: float):
            nonlocal seq
            cid = self._sample_client(rs)
            dur = self.client_time[cid] * max(
                float(self.dataset.counts[cid]), 1.0)
            if spec is not None and spec.client_straggler > 0.0 \
                    and rs_fault.rand() < spec.client_straggler:
                dur *= self.straggler_factor
                _mx.inc("fed.chaos.client_stragglers")
            heapq.heappush(heap, (now + dur, seq, cid, self.version,
                                  self.params, dur))
            seq += 1

        for _ in range(min(self.concurrency, total)):
            launch(0.0)

        eval_every = max(1, total // max(t.comm_round, 1))
        merged = 0
        with recorder.span("async_run"):
            while merged < total:
                finish, s, cid, v0, snap, dur = heapq.heappop(heap)
                if spec is not None and spec.client_dropout > 0.0 \
                        and rs_fault.rand() < spec.client_dropout:
                    # the client crashed mid-round: its update never
                    # merges and never counts as participation
                    _mx.inc("fed.chaos.client_dropouts")
                    if merged + len(heap) < total:
                        launch(finish)
                    continue
                client_p, met = self._train_one(snap, cid, order(s))
                tau = self.version - v0
                a_eff = staleness_weight(self.alpha, float(tau), self.poly_a,
                                         self.staleness_mode)
                self.params = self._merge(self.params, client_p, a_eff)
                self.version += 1
                merged += 1
                record_staleness(tau)
                record_participation(cid)
                if self.cost_model is not None:
                    self.cost_model.record_dispatch([cid], float(dur))
                _mx.set_gauge("fed.version", float(self.version))
                if merged % eval_every == 0 or merged == total:
                    if self.cost_model is not None:
                        # refresh the fit and its fed.cost_model.* gauges
                        # on the eval cadence; the loop places nothing
                        self.cost_model.engaged()
                    loss_sum, count = torch.stack(
                        [met.loss_sum, met.count]).float().tolist()
                    row = {"update": merged, "sim_time": finish,
                           "staleness": tau,
                           "train_loss": loss_sum / max(count, 1.0),
                           **self.evaluate()}
                    self.history.append(row)
                    recorder.log(row)
                if merged + len(heap) < total:
                    launch(finish)
        return self.history


def run_async_simulation(cfg: Config, dataset=None, model=None, *,
                         device=None, params=None,
                         batch_idx=None) -> list[dict]:
    return AsyncSimulator(cfg, dataset, model, device=device,
                          params=params).run(batch_idx=batch_idx)
