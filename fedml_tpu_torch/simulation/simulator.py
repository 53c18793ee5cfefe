"""Host-driven federated simulation loop on one GPU (port of the
single-device path of `fedml_tpu/simulation/simulator.py`).

The host samples clients (seeded by round), runs one round
(`parallel/round.py`: the sampled clients' local training in G-way vmapped
groups, `clients_per_device_parallel`, the weighted aggregate, the server
step, health stats), feeds the health tracker, evaluates on its cadence,
checkpoints on its cadence and logs one history row per round. Three
loops run the same round body:

- per round (the default);
- round blocks (`rounds_per_block` K > 1): K rounds queued back to back
  with no host synchronisation, their metrics fetched in one transfer,
  `block_pipeline_depth` blocks in flight; a block never spans an eval or
  checkpoint round, and the ragged pieces around those barriers run one
  round at a time, so the history is the per-round run's;
- cohort chunks (`cohort_chunk` C): the data stays in host memory and
  each round streams C clients at a time onto the card through
  `simulation/ingest.py` (`ingest_prefetch` chunks ahead); the cohort is
  padded to a multiple of C with zero-weight duplicates of its first id.
  Chunked rounds are the single-shot rounds bit for bit, and may run in
  blocks too.

The round's plugins come from the config as in the JAX Simulator:
attacks and defenses (`security_args`: the FULL-mode hook, the client
and aggregate transforms, data poisoning of the host arrays before
upload), DP (`dp_args`: its client transform, and its server noise after
the defense's post-processing, keyed apart from every client), update
compression (`train_args.compression`; `eftopk` keeps its residuals on
the client-state plane) and chaos client faults
(`common_args.extra.chaos`: client_dropout, client_straggler). The
client-side pipeline is defender, then compression, then DP. The DP
accountant steps once a round and `dp_epsilon` joins the history rows of
every loop.

`run(checkpoint_dir=..., checkpoint_every=n)` saves every n rounds
(`utils/checkpoint.py`) and resumes from the latest checkpoint it finds
there (the plugins' hook state too, and the DP accountant is set to the
rounds done); the resumed run is the uninterrupted one bit for bit. On a
GPU the Simulator makes cuDNN deterministic (`_device.deterministic_cuda`),
so the same round repeats bit for bit.

With an artifact store configured (`mlops.init`, `tracking_args.extra`
artifact_store / artifact_dir), every round's aggregated model is
published (`mlops.log_aggregated_model_info`); in blocked mode one a
block, its last round's, as in the JAX package. A failed publish is
logged and the run goes on. At the end of a run the buffering sinks are
flushed (`utils/sinks.flush_sinks`).

This is the JAX package's `backend: sp` path, and its `backend: xla` path
when one device is visible. Not ported yet, each refused with a
NotImplementedError naming its ROADMAP port-queue item: a mesh or several
GPUs, and the cost model that places clients across them (item 4).
`common_args.extra.metrics_port` starts the process's /metrics endpoint
(`utils/prometheus.py`).
"""
from __future__ import annotations

import logging
import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from .. import dp as dp_mod
from .. import security as sec_mod
from .._device import deterministic_cuda, resolve_device
from ..algorithms.builtin import build_algorithm
from ..comm.chaos import FaultSpec
from ..compression import (
    make_compression_transform, wrap_algorithm_with_eftopk,
)
from ..config import BACKEND_XLA, Config
from ..core.algorithm import (
    ServerState, eval_row, make_eval_fn, pad_test_batches, eval_labels,
)
from ..data import loader as data_loader
from ..data.fed_dataset import FedDataset
from ..models import hub as model_hub
from ..ops import keys
from ..ops.tree import tree_leaves, tree_map
from ..parallel.round import (
    build_block_fn, build_chunk_fns, build_round_fn, group_width,
    stack_metrics,
)
from ..utils import checkpoint as ckpt
from ..utils.events import recorder
from ..utils.health import HealthTracker
from ..utils.prometheus import maybe_start_metrics_server
from .ingest import DeviceChunk, IngestPipeline

log = logging.getLogger(__name__)


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
    if x.get("cost_model"):
        raise _later("train_args.cost_model (the Parrot cost model and LPT "
                     "placement, which only place clients across devices)",
                     "4, multi-GPU")


def _compose(*fns):
    """Chain (update, key) -> update transforms, None entries skipped;
    stage i draws from key + (0x9A + i,)."""
    fns = [f for f in fns if f is not None]
    if not fns:
        return None

    def chained(upd, key):
        for i, f in enumerate(fns):
            upd = f(upd, keys.fold(key, i + 0x9A))
        return upd

    return chained


def fetch(tree) -> dict:
    """Every leaf of a tree of device tensors as numpy, in one
    device-to-host transfer."""
    leaves = tree_leaves(tree)
    flat = torch.cat([t.float().reshape(-1) for t in leaves]).cpu().numpy()
    offs = np.cumsum([0] + [t.numel() for t in leaves])
    it = iter(range(len(leaves)))

    def take(t):
        i = next(it)
        return flat[offs[i]:offs[i + 1]].reshape(tuple(t.shape))

    return tree_map(take, tree)


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
        deterministic_cuda(self.device)
        self.cfg = cfg
        # opt-in live scrape surface (common_args.extra.metrics_port)
        self.metrics_exporter = maybe_start_metrics_server(cfg)
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
        # the round's plugins: security, DP, compression, chaos faults
        self.attacker, self.defender = sec_mod.from_config(cfg)
        self.dp = dp_mod.from_config(cfg, counts=self.dataset.counts)
        comp_name = str(t.extra.get("compression", "none")).lower()
        comp_ratio = float(t.extra.get("compression_ratio", 0.05))
        if comp_name == "eftopk":
            # the residual rides the client-state plane; the defender's
            # transform runs before the sparsification, as with every
            # other compressor (defender -> compress -> DP)
            self.alg = wrap_algorithm_with_eftopk(
                self.alg, comp_ratio,
                pre_transform=self.defender.update_transform())
            post_update = _compose(self.dp.client_transform())
        else:
            post_update = _compose(
                self.defender.update_transform(),
                make_compression_transform(
                    comp_name, comp_ratio,
                    int(t.extra.get("quantize_bits", 8))),
                self.dp.client_transform())
        agg_full = sec_mod.build_server_pipeline(self.attacker,
                                                 self.defender)
        dp_server = self.dp.server_transform()
        dfs_post = self.defender.postprocess_agg()
        post_agg = None
        if dp_server is not None or dfs_post is not None:
            def post_agg(agg, ctx):
                if dfs_post is not None:
                    agg = dfs_post(agg, ctx)
                if dp_server is not None:
                    agg = dp_server(agg, keys.fold(ctx["key"], 0xD9))
                return agg
        self.fault_spec = FaultSpec.from_config(cfg)
        fs = self.fault_spec
        self._plugins = dict(
            aggregate_full=agg_full, postprocess_update=post_update,
            postprocess_agg=post_agg,
            num_real_clients=t.client_num_per_round,
            client_dropout=fs.client_dropout if fs else 0.0,
            client_straggler=fs.client_straggler if fs else 0.0)
        self.group_size = int(t.extra.get("clients_per_device_parallel", 1))
        # per-client health stats ride the round's metrics (default on, as
        # in the JAX package; train_args.extra.health_stats=False opts out);
        # the tracker's participation and straggler accounting always runs
        self._health_enabled = bool(t.extra.get("health_stats", True))
        self.health = HealthTracker.from_config(cfg)
        self._cohort_chunk = int(t.extra.get("cohort_chunk", 0) or 0)
        cc, m = self._cohort_chunk, t.client_num_per_round
        g = group_width(cc or m, self.group_size)
        if g < self.group_size:
            log.warning(
                "clients_per_device_parallel=%d does not divide the %s (%d):"
                " the clients train in groups of %d, the largest divisor",
                self.group_size, "cohort chunk" if cc else "cohort",
                cc or m, g)
        self.round_fn = self.chunk_fn = self.finalize_fn = None
        self._make_carry = None
        if self._cohort_chunk:
            if self._health_enabled:
                log.info("cohort_chunk=%d: per-client health stats do not "
                         "ride chunked rounds; participation and straggler "
                         "tracking stay on", self._cohort_chunk)
            self._health_enabled = False
            self.chunk_fn, self.finalize_fn, self._make_carry = \
                build_chunk_fns(self.alg, self.group_size, **self._plugins)
        else:
            self.round_fn = build_round_fn(
                self.alg, group_size=self.group_size,
                health_stats=self._health_enabled, **self._plugins)
        self.block_fn = None   # built at the first blocked dispatch
        self.hook_state = sec_mod.init_pipeline_state(
            self.attacker, self.defender, self.params,
            t.client_num_per_round, self.device) \
            if agg_full is not None else None
        self.server_state = self.alg.server_init(self.params, cfg)
        n = self.dataset.num_clients
        self.client_states = None if self.alg.client_state_init is None \
            else tree_map(lambda a: a.unsqueeze(0).expand(
                (n,) + tuple(a.shape)).clone(),
                self.alg.client_state_init(self.params))
        ds = self.dataset
        raw = {"x": ds.x_train, "y": ds.y_train, "mask": ds.mask_train}
        # data poisoning changes the host arrays before they are uploaded
        raw = self.attacker.poison_dataset(raw, self.num_classes)
        if self._cohort_chunk:
            # the dataset stays in host memory; each round streams its
            # cohort chunk by chunk
            self._host_data = {k: np.asarray(v) for k, v in raw.items()}
            self.data = None
            self._ingest = IngestPipeline(
                int(t.extra.get("ingest_prefetch", 1) or 0))
            self._ingest_stream = (torch.cuda.Stream(self.device)
                                   if self.device.type == "cuda" else None)
        else:
            self._host_data = self._ingest = None
            self.data = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                self.device) for k, v in raw.items()}
        self.counts = np.asarray(ds.counts, np.float32)
        xb, yb, mb = pad_test_batches(ds.x_test, ds.y_test,
                                      max(t.batch_size, 64))
        self._test = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device) for a in (xb, eval_labels(yb), mb))
        self._eval = make_eval_fn(self.apply_fn, t.extra.get("task"),
                                  self.num_classes)
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
        as weights, padded to a multiple of the cohort chunk (when
        chunking) with zero-weight duplicates of ids[0]. A duplicate of an
        already-sampled client recomputes from the same pre-round state
        and is never the row the state scatter keeps; padding with id 0
        would corrupt client 0's persistent state on rounds it was not
        sampled."""
        weights = self.counts[ids].astype(np.float32)
        pad = (-len(ids)) % self._cohort_chunk if self._cohort_chunk else 0
        if pad:
            ids = np.concatenate([ids, np.full(pad, ids[0], np.int32)])
            weights = np.concatenate([weights, np.zeros(pad, np.float32)])
        return ids, weights, pad

    def _round_inputs(self, round_idx: int, batch_idx=None):
        """(ids, weights, batch_idx) of one round; a given schedule of the
        sampled clients gains its pads' rows (ids[0]'s, which is what a
        pad would draw)."""
        ids, weights, pad = self._pad_only(self.sample_clients(round_idx))
        if batch_idx is not None and pad:
            batch_idx = torch.as_tensor(np.asarray(batch_idx))
            batch_idx = torch.cat([batch_idx, batch_idx[:1].expand(
                (pad,) + tuple(batch_idx.shape[1:]))])
        return ids, weights, batch_idx

    def _seed(self, round_idx: int):
        return (self.cfg.common_args.random_seed, round_idx)

    def _observe(self, round_idx, ids, weights, metrics: dict,
                 duration_s: float) -> dict:
        """Feed the health tracker one round and step the DP accountant;
        returns the history row's scalar metrics (with dp_epsilon where
        the DP is accounted)."""
        health = metrics.pop("health", None)
        faults = metrics.pop("faults", None)
        self.health.observe_round(round_idx, ids, weights, health,
                                  duration_s=duration_s, faults=faults)
        row = {k: float(v) for k, v in metrics.items()}
        self.dp.step_round()
        if self.dp.enabled and self.dp.accountant is not None:
            row["dp_epsilon"] = self.dp.get_epsilon()
        return row

    def _pad_faults(self, faults, pad: int):
        """A given {"dropped", "straggled"} of the sampled clients, its
        pads' rows those of ids[0], which a pad shares."""
        if faults is None or not pad:
            return faults
        return {k: np.concatenate([np.asarray(v), np.full(pad, np.asarray(
            v)[0])]) for k, v in faults.items()}

    def run_round(self, round_idx: int, batch_idx=None, faults=None) -> dict:
        """One round. `batch_idx` ([m, steps, B], optional) is every
        sampled client's batch order; by default each client draws its own
        from (random_seed, round, client id). `faults` ({"dropped",
        "straggled"}, [m] 0/1, optional) replaces the chaos plane's draws
        (the tests hand the JAX round's masks over this way)."""
        if self._cohort_chunk:
            return self._run_round_chunked(round_idx, batch_idx, faults)
        ids, weights, batch_idx = self._round_inputs(round_idx, batch_idx)
        t0 = time.perf_counter()
        with recorder.span("train", round=round_idx):
            out = self.round_fn(
                self.server_state, self.client_states, self.data, ids,
                weights, seed=self._seed(round_idx), batch_idx=batch_idx,
                hook_state=self.hook_state, faults=faults)
            metrics = fetch(out.metrics)
        self.server_state = out.server_state
        self.client_states = out.client_states
        self.hook_state = out.hook_state
        return self._observe(round_idx, ids, weights, metrics,
                             time.perf_counter() - t0)

    # ------------------------------------------- chunked cohort execution
    def _chunk_thunk(self, cids: np.ndarray):
        """One ingest unit: host-gather the chunk's client rows and copy
        them onto the device (on the ingest worker's thread)."""
        def put():
            arrays = {k: v[cids] for k, v in self._host_data.items()}
            nbytes = sum(a.nbytes for a in arrays.values())
            return DeviceChunk(arrays, self.device,
                               self._ingest_stream), nbytes
        return put

    def _dispatch_chunked(self, round_idx: int, batch_idx=None, faults=None):
        """Queue one chunk-streamed round: chunk k+1's gather and copy
        overlap chunk k's compute, the partial aggregate rides the carry,
        finalize closes the round. Returns (ids, weights, RoundOutput)."""
        ids, weights, batch_idx = self._round_inputs(round_idx, batch_idx)
        c = self._cohort_chunk
        faults = self._pad_faults(
            faults, len(ids) - self.cfg.train_args.client_num_per_round)
        carry = self._make_carry(self.client_states, ids, self.device)
        thunks = [self._chunk_thunk(ids[j:j + c])
                  for j in range(0, len(ids), c)]
        for j, chunk in enumerate(self._ingest.stream(thunks)):
            lo = j * c
            carry = self.chunk_fn(
                carry, self.server_state, chunk.ready(), np.arange(c),
                ids[lo:lo + c], weights[lo:lo + c], self._seed(round_idx),
                lo, None if batch_idx is None else batch_idx[lo:lo + c],
                None if faults is None
                else {k: v[lo:lo + c] for k, v in faults.items()})
        out = self.finalize_fn(self.server_state, carry, ids, self.hook_state)
        self.server_state = out.server_state
        self.client_states = out.client_states
        self.hook_state = out.hook_state
        return ids, weights, out

    def _run_round_chunked(self, round_idx: int, batch_idx=None,
                           faults=None) -> dict:
        t0 = time.perf_counter()
        with recorder.span("train", round=round_idx) as sp:
            ids, weights, out = self._dispatch_chunked(round_idx, batch_idx,
                                                       faults)
            sp.meta["chunks"] = len(ids) // self._cohort_chunk
            metrics = fetch(out.metrics)
        return self._observe(round_idx, ids, weights, metrics,
                             time.perf_counter() - t0)

    def _eval_dispatch(self):
        """Queue the test-set eval; the values stay on the device until
        `_eval_finish`."""
        return self._eval(self.server_state.params, *self._test)

    @staticmethod
    def _eval_finish(m) -> dict:
        return eval_row(m)

    def evaluate(self) -> dict:
        with recorder.span("eval"):
            return self._eval_finish(self._eval_dispatch())

    # ---------------------------------------------------- checkpoint/resume
    def _server_dict(self) -> dict:
        st = self.server_state
        return {"params": st.params, "opt_state": st.opt_state,
                "round": st.round, "extra": st.extra}

    def save(self, ckpt_dir: str, keep: Optional[int] = 3) -> str:
        rounds_done = len(self.history)
        if rounds_done == 0:
            raise ValueError(
                "nothing to checkpoint: no rounds have completed (a "
                "round_-1 directory would be invisible to restore)")
        return ckpt.save_checkpoint(
            ckpt_dir, rounds_done - 1, self._server_dict(),
            client_states=self.client_states, history=self.history,
            keep=keep, hook_state=self.hook_state)

    def restore(self, ckpt_dir: str) -> int:
        """Load the latest checkpoint; returns the next round to run.
        Sampling and every draw are seeded by round, and the DP
        accountant is set to the rounds done, so the resumed run
        continues exactly where the dead one stopped."""
        r, server, clients, hook, history = ckpt.restore_checkpoint(
            ckpt_dir, self._server_dict(), self.client_states,
            device=self.device, hook_template=self.hook_state)
        self.server_state = ServerState(**server)
        if clients is not None:
            self.client_states = clients
        if hook is not None:
            self.hook_state = hook
        self.history = list(history)
        if self.dp.enabled and self.dp.accountant is not None:
            self.dp.accountant.steps = r + 1
        return r + 1

    # ------------------------------------------------------------ run loop
    def _eval_due(self, r: int, rounds: int) -> bool:
        f = self.cfg.validation_args.frequency_of_the_test
        return bool(f) and (r % f == 0 or r == rounds - 1)

    @staticmethod
    def _ckpt_due(r: int, rounds: int, checkpoint_dir,
                  checkpoint_every) -> bool:
        return checkpoint_dir is not None and bool(checkpoint_every) and (
            (r + 1) % checkpoint_every == 0 or r == rounds - 1)

    def _publish_model(self, r: int, params) -> None:
        """Publish round r's aggregated model to the artifact store (a
        no-op without one). A failed write is logged and the run goes on,
        as in the JAX package: a store hiccup must not end a long run."""
        from .. import mlops

        try:
            mlops.log_aggregated_model_info(r, params)
        except Exception as e:  # noqa: BLE001
            log.warning("round-%d model-artifact publish failed "
                        "(continuing): %s: %s", r, type(e).__name__, e)

    def _run_one(self, r: int, rounds: int, batch_idx=None) -> None:
        """One host-synchronous round: train, eval on cadence, log,
        publish."""
        row = {"round": r, **self.run_round(r, batch_idx)}
        if self._eval_due(r, rounds):
            row.update(self.evaluate())
        recorder.log(row)
        self.history.append(row)
        self._publish_model(r, self.server_state.params)

    # ------------------------------------------------- round-block pipeline
    def _dispatch_block(self, blk: list, rounds: int,
                        batch_schedule: Optional[Callable]):
        """Queue one block of rounds, and the eval that must read its
        parameters, without waiting for the device."""
        t0 = time.perf_counter()
        sched = (lambda r: None) if batch_schedule is None \
            else batch_schedule
        if self._cohort_chunk:
            # chunked and blocked: each round streams its chunks; the
            # block defers every metric fetch to drain time
            trips = [self._dispatch_chunked(r, sched(r)) for r in blk]
            ids = np.stack([i for i, _, _ in trips])
            weights = np.stack([w for _, w, _ in trips])
            metrics = [o.metrics for _, _, o in trips]
        else:
            if self.block_fn is None:
                self.block_fn = build_block_fn(
                    self.alg, self.group_size, self._health_enabled,
                    **self._plugins)
            trips = [self._round_inputs(r, sched(r)) for r in blk]
            ids = np.stack([i for i, _, _ in trips])
            weights = np.stack([w for _, w, _ in trips])
            batch_idx = (None if batch_schedule is None
                         else [b for _, _, b in trips])
            out = self.block_fn(
                self.server_state, self.client_states, self.data, ids,
                weights, self.cfg.common_args.random_seed, blk, batch_idx,
                self.hook_state)
            self.server_state = out.server_state
            self.client_states = out.client_states
            self.hook_state = out.hook_state
            metrics = out.metrics
        eval_out = (self._eval_dispatch()
                    if self._eval_due(blk[-1], rounds) else None)
        # a block publishes once, its last round's parameters, copied here
        # before the next block is queued
        from .. import mlops

        snap = ({k: v.clone() for k, v in self.server_state.params.items()}
                if mlops.artifact_store() is not None else None)
        return blk, ids, weights, metrics, eval_out, snap, t0

    def _drain_block(self, pending) -> None:
        """Materialise one queued block: ONE host transfer for its stacked
        [K] metrics, then per-round history rows as the per-round loop
        writes them. The block's `train` span covers queueing to
        materialisation (`recorder.log_block_span`: one span, one sink row
        a round)."""
        blk, ids, weights, metrics, eval_out, snap, t0 = pending
        if isinstance(metrics, list):
            metrics = stack_metrics(metrics)
        m = fetch(metrics)
        block_s = time.perf_counter() - t0
        recorder.log_block_span("train", blk, block_s)
        for j, r in enumerate(blk):
            row = {"round": r, **self._observe(
                r, ids[j], weights[j], tree_map(lambda v: v[j], m),
                block_s / len(blk))}
            if eval_out is not None and r == blk[-1]:
                te = time.perf_counter()
                row.update(self._eval_finish(eval_out))
                recorder.log_block_span("eval", [r],
                                        time.perf_counter() - te)
            recorder.log(row)
            self.history.append(row)
        if snap is not None:
            self._publish_model(blk[-1], snap)

    def _run_blocked(self, start: int, rounds: int, block_size: int,
                     checkpoint_dir, checkpoint_every,
                     batch_schedule: Optional[Callable]) -> None:
        """Pipelined round-block loop: K rounds per dispatch, block i+1
        queued before block i's metrics are fetched. Blocks never span an
        eval or checkpoint round, so blocked and per-round runs give the
        same history; the ragged pieces (a cadence K does not divide, the
        end of the horizon) run one round at a time."""
        t = self.cfg.train_args
        depth = max(1, int(t.extra.get("block_pipeline_depth", 2) or 1))
        cadences = [c for c in (
            self.cfg.validation_args.frequency_of_the_test,
            checkpoint_every if checkpoint_dir is not None else 0) if c]
        if cadences and min(cadences) < block_size:
            log.warning(
                "rounds_per_block=%d exceeds the eval/checkpoint cadence "
                "(%d): blocks between barriers never fill, so most or all "
                "rounds will run one at a time", block_size, min(cadences))
        pending: deque = deque()

        def drain_all():
            while pending:
                self._drain_block(pending.popleft())

        def one(r):
            self._run_one(r, rounds, None if batch_schedule is None
                          else batch_schedule(r))

        blk: list = []
        for r in range(start, rounds):
            blk.append(r)
            due = self._ckpt_due(r, rounds, checkpoint_dir, checkpoint_every)
            if not (self._eval_due(r, rounds) or due) \
                    and len(blk) < block_size:
                continue
            if len(blk) == block_size:
                pending.append(self._dispatch_block(blk, rounds,
                                                    batch_schedule))
                while len(pending) >= depth:
                    self._drain_block(pending.popleft())
            else:
                drain_all()
                for rr in blk:
                    one(rr)
            blk = []
            if due:
                drain_all()
                self.save(checkpoint_dir)
        drain_all()
        for rr in blk:   # a ragged tail with no barrier at the end
            one(rr)

    def run(self, num_rounds: Optional[int] = None,
            checkpoint_dir: Optional[str] = None, checkpoint_every: int = 0,
            batch_schedule: Optional[Callable] = None) -> list[dict]:
        """`num_rounds` rounds (default comm_round), resuming from the
        latest checkpoint under `checkpoint_dir` and saving every
        `checkpoint_every` rounds there; `batch_schedule(r)`, when given,
        returns round r's `batch_idx` for the sampled clients (the tests
        hand the JAX package's schedules over this way)."""
        t = self.cfg.train_args
        rounds = num_rounds if num_rounds is not None else t.comm_round
        start = 0
        if checkpoint_dir is not None \
                and ckpt.latest_round(checkpoint_dir) is not None:
            start = self.restore(checkpoint_dir)
        block_size = max(1, int(t.extra.get("rounds_per_block", 1) or 1))
        if block_size > 1:
            self._run_blocked(start, rounds, block_size, checkpoint_dir,
                              checkpoint_every, batch_schedule)
        else:
            for r in range(start, rounds):
                self._run_one(r, rounds, None if batch_schedule is None
                              else batch_schedule(r))
                if self._ckpt_due(r, rounds, checkpoint_dir,
                                  checkpoint_every):
                    self.save(checkpoint_dir)
        from ..utils.sinks import flush_sinks

        flush_sinks()   # a BrokerLogSink's tail batch ships here
        return self.history


def run_simulation(cfg: Config, dataset=None, model=None, *, device=None,
                   params=None, batch_schedule=None) -> list[dict]:
    """The simulation of `cfg`; `train_args.extra.checkpoint_dir` turns on
    saving and resuming (every round, or every `checkpoint_every`)."""
    ckpt_dir = cfg.train_args.extra.get("checkpoint_dir")
    every = int(cfg.train_args.extra.get("checkpoint_every", 1) or 0)
    return Simulator(cfg, dataset, model, device=device,
                     params=params).run(
        checkpoint_dir=ckpt_dir, checkpoint_every=every if ckpt_dir else 0,
        batch_schedule=batch_schedule)
