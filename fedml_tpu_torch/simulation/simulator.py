"""Host-driven federated simulation loop on one GPU (port of the
single-device path of `fedml_tpu/simulation/simulator.py`).

The host samples clients (seeded by round), runs one round
(`parallel/round.py`: every sampled client's local training in sequence,
the weighted aggregate, the server step, health stats), feeds the health
tracker, evaluates on its cadence and logs one history row per round. The
federated data goes onto the device once, at construction.

This is the JAX package's `backend: sp` path, and its `backend: xla` path
when one device is visible. Not ported yet, each refused with a
NotImplementedError naming its ROADMAP port-queue item: a mesh or several
GPUs (item 4), clients batched with vmap (`clients_per_device_parallel`
> 1, item 3d.1), round blocks (`rounds_per_block` > 1, item 3d.2), cohort
chunking (`cohort_chunk`, item 3d.3), checkpoints (`checkpoint_dir`, item
3d.4), attacks, defenses, DP, compression and chaos faults (item 3e), and
the artifact store and metrics endpoint (item 5).
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from ..algorithms.builtin import build_algorithm
from ..config import BACKEND_XLA, Config
from ..core.algorithm import make_eval_fn
from ..data import loader as data_loader
from ..data.fed_dataset import FedDataset
from ..models import hub as model_hub
from ..parallel.round import build_round_fn
from ..utils.events import recorder
from ..utils.health import HealthTracker


def _later(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP 'Port queue' item {item})")


def _refuse_unported(cfg: Config, device: torch.device) -> None:
    """Raise for every knob of the JAX Simulator this port does not run."""
    x = cfg.train_args.extra
    if cfg.device_args.mesh_shape or cfg.device_args.extra.get(
            "mesh_mapping_file"):
        raise _later("a device mesh", "4, multi-GPU")
    if (cfg.comm_args.backend == BACKEND_XLA and device.type == "cuda"
            and torch.cuda.device_count() > 1):
        raise _later("backend 'xla' over more than one GPU (a mesh)",
                     "4, multi-GPU")
    if int(x.get("clients_per_device_parallel", 1)) > 1:
        raise _later("clients_per_device_parallel > 1 (clients batched "
                     "with torch.func.vmap)", "3d.1")
    if int(x.get("rounds_per_block", 1) or 1) > 1:
        raise _later("rounds_per_block > 1 (round blocks)", "3d.2")
    if x.get("cohort_chunk"):
        raise _later("cohort_chunk (streamed cohorts)", "3d.3")
    if x.get("checkpoint_dir"):
        raise _later("checkpoint_dir (checkpoint and resume)", "3d.4")
    sec, dp = cfg.security_args, cfg.dp_args
    plugins = {
        "security_args.enable_attack": sec.enable_attack,
        "security_args.enable_defense": sec.enable_defense,
        "dp_args.enable_dp": dp.enable_dp,
        "train_args.compression":
            str(x.get("compression", "none")).lower() != "none",
        "common_args.chaos client faults": any(
            float((cfg.common_args.extra.get("chaos") or {}).get(k, 0) or 0)
            > 0 for k in ("client_dropout", "client_straggler")),
    }
    on = [k for k, v in plugins.items() if v]
    if on:
        raise _later(", ".join(on) + " (the round's plugins)", "3e")
    tr = cfg.tracking_args.extra
    if tr.get("artifact_store") or tr.get("artifact_dir"):
        raise _later("the model-artifact store", "5")
    if cfg.common_args.extra.get("metrics_port") is not None:
        raise _later("the /metrics endpoint (metrics_port)", "5")


def _pad_test_batches(x: np.ndarray, y: np.ndarray, batch_size: int):
    n = x.shape[0]
    nb = (n + batch_size - 1) // batch_size
    pad = nb * batch_size - n
    xp = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)]) if pad else x
    yp = np.concatenate([y, np.zeros((pad,) + y.shape[1:], y.dtype)]) if pad else y
    mask = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
    rs = lambda a: a.reshape((nb, batch_size) + a.shape[1:])
    return rs(xp), rs(yp), rs(mask)


class Simulator:
    """fedml.run_simulation on one GPU. `device=None` takes the device
    `fedml_tpu_torch.init` put in `device_args.extra["device"]`, else CUDA
    (the tests pass "cpu"); without a GPU anything but "cpu" raises.
    `model` is an nn.Module of `models/hub.py`'s kind (flax
    parameter names), by default `hub.create(cfg.model_args.model, ...)`;
    `params`, the initial global parameters (a dict as `hub.init_params`
    returns, e.g. `hub.params_from_flax` of the JAX package's), by default
    drawn by `hub.init_params` from a generator seeded with
    `common_args.random_seed`."""

    def __init__(self, cfg: Config, dataset: Optional[FedDataset] = None,
                 model=None, mesh=None, device=None, params=None):
        if mesh is not None:
            raise _later("a device mesh", "4, multi-GPU")
        self.device = resolve_device(
            device if device is not None
            else cfg.device_args.extra.get("device"))
        _refuse_unported(cfg, self.device)
        self.cfg = cfg
        t = cfg.train_args
        self.dataset = dataset if dataset is not None else data_loader.load(cfg)
        self.num_classes = self.dataset.num_classes
        input_shape = self.dataset.x_train.shape[2:]
        self.model = model if model is not None else model_hub.create(
            cfg.model_args.model, self.num_classes, input_shape,
            device="meta", **cfg.model_args.extra)
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(cfg.common_args.random_seed))
            params = model_hub.init_params(self.model, gen)
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.apply_fn = model_hub.apply_fn(self.model, t.compute_dtype)
        self.alg = build_algorithm(
            t.federated_optimizer, self.apply_fn, t,
            t.client_num_in_total, t.client_num_per_round)
        # per-client health stats ride the round's metrics (default on, as
        # in the JAX package; train_args.extra.health_stats=False opts out);
        # the tracker's participation and straggler accounting always runs
        self._health_enabled = bool(t.extra.get("health_stats", True))
        self.health = HealthTracker.from_config(cfg)
        self.round_fn = build_round_fn(self.alg,
                                       health_stats=self._health_enabled)
        self.server_state = self.alg.server_init(self.params, cfg)
        self.client_states = None
        ds = self.dataset
        self.data = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
            self.device) for k, v in (("x", ds.x_train), ("y", ds.y_train),
                                      ("mask", ds.mask_train))}
        self.counts = np.asarray(ds.counts, np.float32)
        xb, yb, mb = _pad_test_batches(ds.x_test, ds.y_test,
                                       max(t.batch_size, 64))
        self._test = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device) for a in (xb, yb.astype(np.int64), mb))
        self._eval = make_eval_fn(self.apply_fn, t.extra.get("task"))
        self.history: list[dict] = []

    # sampling seeded by round index: a local RandomState(round) draws the
    # reference's ids without touching numpy's global generator
    def sample_clients(self, round_idx: int) -> np.ndarray:
        t = self.cfg.train_args
        n, m = self.dataset.num_clients, t.client_num_per_round
        if n == m:
            return np.arange(m, dtype=np.int32)
        rs = np.random.RandomState(round_idx)
        return np.sort(rs.choice(range(n), m, replace=False)).astype(np.int32)

    def _pad_only(self, ids: np.ndarray):
        """(ids, weights, pad): the sampled ids with their sample counts
        as weights. Without a mesh or cohort chunks nothing is padded."""
        return ids, self.counts[ids].astype(np.float32), 0

    def run_round(self, round_idx: int, batch_idx=None) -> dict:
        """One round. `batch_idx` ([m, steps, B], optional) is every
        sampled client's batch order; by default each client draws its own
        from (random_seed, round, client id)."""
        ids, weights, _ = self._pad_only(self.sample_clients(round_idx))
        t0 = time.perf_counter()
        with recorder.span("train", round=round_idx):
            out = self.round_fn(
                self.server_state, self.client_states, self.data, ids,
                weights, seed=(self.cfg.common_args.random_seed, round_idx),
                batch_idx=batch_idx)
            metrics = out.metrics
            health = metrics.pop("health", None)
            # one device-to-host transfer for the scalars, one per health
            # array
            names = list(metrics)
            vals = torch.stack([metrics[k].float() for k in names]).tolist()
            metrics = dict(zip(names, vals))
            if health is not None:
                health = {k: v.cpu().numpy() for k, v in health.items()}
        self.server_state = out.server_state
        self.client_states = out.client_states
        dur = time.perf_counter() - t0
        self.health.observe_round(round_idx, ids, weights, health,
                                  duration_s=dur)
        return metrics

    def evaluate(self) -> dict:
        with recorder.span("eval"):
            m = self._eval(self.server_state.params, *self._test)
            loss, acc = torch.stack([m["loss"], m["acc"]]).tolist()
        return {"test_loss": loss, "test_acc": acc}

    def _eval_due(self, r: int, rounds: int) -> bool:
        f = self.cfg.validation_args.frequency_of_the_test
        return bool(f) and (r % f == 0 or r == rounds - 1)

    def _run_one(self, r: int, rounds: int, batch_idx=None) -> None:
        """One host-synchronous round: train, eval on cadence, log."""
        row = {"round": r, **self.run_round(r, batch_idx)}
        if self._eval_due(r, rounds):
            row.update(self.evaluate())
        recorder.log(row)
        self.history.append(row)

    def run(self, num_rounds: Optional[int] = None,
            batch_schedule=None) -> list[dict]:
        """`num_rounds` rounds (default comm_round); `batch_schedule(r)`,
        when given, returns round r's `batch_idx` (the tests hand the JAX
        package's schedules over this way)."""
        t = self.cfg.train_args
        rounds = num_rounds if num_rounds is not None else t.comm_round
        for r in range(rounds):
            self._run_one(r, rounds, None if batch_schedule is None
                          else batch_schedule(r))
        return self.history


def run_simulation(cfg: Config, dataset=None, model=None, *, device=None,
                   params=None, batch_schedule=None) -> list[dict]:
    return Simulator(cfg, dataset, model, device=device,
                     params=params).run(batch_schedule=batch_schedule)
