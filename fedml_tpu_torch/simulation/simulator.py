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

Over a device mesh the Simulator runs SPMD, one instance in every rank
of a `torch.distributed` world (`parallel/launch.py`, or torchrun): the
JAX package's `backend: xla` path. The mesh is `mesh=` (a `DeviceMesh`;
anything else is a TypeError), else, with backend xla over more than one
rank, `device_args.mesh_shape`, then `device_args.extra.mesh_mapping_file`
(`parallel/mesh.py`), then a `clients` axis over every rank. Every rank
samples the same cohort, pads it to a multiple of the federated axis (of
the cohort chunk when chunking) with zero-weight duplicates of ids[0]
(`_pad_only`), and places it with balanced LPT (`schedule/`) when the
weights vary or the cost model has engaged, unless padding meets FULL
aggregation (`_lpt_applies`); a given schedule or fault mask follows its
client through both. Each rank trains its block of the cohort and the
round all-reduces (`parallel/round.py`); with `cohort_chunk` each rank
streams only its own rows of every chunk. The stacked data is padded with
zero-mask ghost clients to a multiple of the axis, as JAX's is; each rank
holds the whole table, since any client can fall to any rank. Rank 0
alone writes the history rows to the recorder, publishes models and
saves checkpoints; every rank keeps the history and restores from the
same directory. A (silos, intra) mesh runs the hierarchical round
(`parallel/hier.py`, FedAvg / FedOpt, no round plugins, blocks or chunks):
each rank holds its intra block of every client's samples.

`train_args.cost_model` (`schedule.CostModel`) records each dispatch's
wall time (across a mesh, the slowest rank's, so every rank fits the same
model) and, once engaged, costs LPT by predicted runtime; the first
dispatch, which carries the warm-up, is not recorded. Without a mesh it
records and exports its gauges but places nothing, as in JAX.
`common_args.extra.metrics_port` starts the process's /metrics endpoint
(`utils/prometheus.py`; rank 0's).
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
from ..parallel import mesh as mesh_mod
from ..parallel.mesh import make_mesh, mesh_from_file
from ..parallel.round import (
    build_block_fn, build_chunk_fns, build_round_fn, group_width,
    stack_metrics,
)
from .. import schedule as lpt_sched
from ..utils import checkpoint as ckpt
from ..utils import xla_ledger
from ..utils.events import recorder
from ..utils.health import HealthTracker
from ..utils.prometheus import maybe_start_metrics_server
from .ingest import DeviceChunk, IngestPipeline

log = logging.getLogger(__name__)


def _config_mesh(cfg: Config):
    """The mesh the config asks for: with backend xla over more than one
    rank, `mesh_shape`, else `mesh_mapping_file`, else `clients` over
    every rank; None otherwise (one process is one device)."""
    import torch.distributed as dist

    if not (cfg.comm_args.backend == BACKEND_XLA and dist.is_available()
            and dist.is_initialized() and dist.get_world_size() > 1):
        return None
    mapping = cfg.device_args.extra.get("mesh_mapping_file")
    if cfg.device_args.mesh_shape:
        return make_mesh(cfg.device_args.mesh_shape)
    if mapping:
        return mesh_from_file(mapping)
    return make_mesh({"clients": dist.get_world_size()})


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
        self.device = resolve_device(
            device if device is not None
            else cfg.device_args.extra.get("device"))
        deterministic_cuda(self.device)
        self.cfg = cfg
        # every rank builds the config's mesh (collective); a rank it
        # leaves out stops here
        self.mesh = mesh if mesh is not None else _config_mesh(cfg)
        mesh_mod.check_mesh(self.mesh, "the Simulator's mesh")
        names = () if self.mesh is None else tuple(self.mesh.mesh_dim_names)
        self._hier = names == ("silos", "intra")
        self._axis = "silos" if self._hier else "clients"
        if names not in ((), ("clients",), ("silos", "intra")):
            raise ValueError(
                f"the Simulator runs a ('clients',) mesh, or a ('silos', "
                f"'intra') mesh for the hierarchical round; got {names}")
        self._d = (mesh_mod.axis_size(self.mesh, self._axis)
                   if self.mesh is not None else 0)
        # rank 0 of the mesh writes the run's rows, models and checkpoints
        self._lead = self.mesh is None or int(
            self.mesh.mesh.flatten()[0]) == torch.distributed.get_rank()
        # opt-in live scrape surface (common_args.extra.metrics_port)
        self.metrics_exporter = (maybe_start_metrics_server(cfg)
                                 if self._lead else None)
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
            mesh=self.mesh, axis=self._axis,
            aggregate_full=agg_full, postprocess_update=post_update,
            postprocess_agg=post_agg,
            num_real_clients=t.client_num_per_round,
            client_dropout=fs.client_dropout if fs else 0.0,
            client_straggler=fs.client_straggler if fs else 0.0)
        self._use_full = agg_full is not None
        self._schedule = bool(t.extra.get("heterogeneity_schedule", True))
        self.group_size = int(t.extra.get("clients_per_device_parallel", 1))
        # per-client health stats ride the round's metrics (default on, as
        # in the JAX package; train_args.extra.health_stats=False opts out);
        # the tracker's participation and straggler accounting always runs
        self._health_enabled = bool(t.extra.get("health_stats", True))
        self.health = HealthTracker.from_config(cfg)
        self._cohort_chunk = int(t.extra.get("cohort_chunk", 0) or 0)
        cc, m = self._cohort_chunk, t.client_num_per_round
        d = max(self._d, 1)
        if cc and cc % d:
            raise ValueError(
                f"train_args.cohort_chunk ({cc}) must be a multiple of "
                f"the mesh size ({d}): a chunk splits into per-device "
                "sub-batches")
        if cc and self.group_size > 1 and (cc // d) % self.group_size:
            raise ValueError(
                f"train_args.clients_per_device_parallel ({self.group_size})"
                f" must divide the per-device chunk (cohort_chunk/mesh = "
                f"{cc // d}): unaligned client groups break chunked == "
                "single-shot bit-identity")
        per_rank = cc // d if cc else -(-m // d)
        g = group_width(per_rank, self.group_size)
        if g < self.group_size:
            log.warning(
                "clients_per_device_parallel=%d does not divide the %s (%d):"
                " the clients train in groups of %d, the largest divisor",
                self.group_size, "cohort chunk" if cc else "cohort",
                per_rank, g)
        self.round_fn = self.chunk_fn = self.finalize_fn = None
        self._make_carry = None
        if self._hier:
            self._health_enabled = False
            self.round_fn = self._hier_round(agg_full, post_update, post_agg)
        elif self._cohort_chunk:
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
        # the device-memory ledger: the federated parameters and per-client
        # state (the round's resident trees)
        xla_ledger.register_buffers("fed_params", self.params)
        xla_ledger.register_buffers("client_states", self.client_states)
        ds = self.dataset
        raw = {"x": ds.x_train, "y": ds.y_train, "mask": ds.mask_train}
        # data poisoning changes the host arrays before they are uploaded
        raw = self.attacker.poison_dataset(raw, self.num_classes)
        counts = np.asarray(ds.counts, np.float32)
        if self._d and not self._cohort_chunk:
            # the stacked client axis a multiple of the mesh: zero-mask
            # ghost clients, never sampled (ids < num_clients)
            pad = (-raw["x"].shape[0]) % self._d
            if pad:
                raw = {k: np.concatenate([v, np.zeros(
                    (pad,) + v.shape[1:], v.dtype)]) for k, v in raw.items()}
                counts = np.concatenate([counts, np.zeros(pad, np.float32)])
        if self._hier:
            from ..parallel.hier import shard_hier_data

            self._host_data = self._ingest = None
            self.data = shard_hier_data(raw, self.mesh, device=self.device)
        elif self._cohort_chunk:
            # the dataset stays in host memory; each round streams its
            # cohort chunk by chunk
            self._host_data = {k: np.asarray(v) for k, v in raw.items()}
            self.data = None
            self._ingest = IngestPipeline(
                int(t.extra.get("ingest_prefetch", 1) or 0))
            self._ingest_stream = (torch.cuda.Stream(self.device)
                                   if self.device.type == "cuda" else None)
        else:
            # the whole table on every rank: any client can fall to any
            # rank's block of a cohort
            self._host_data = self._ingest = None
            self.data = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                self.device) for k, v in raw.items()}
        self.counts = counts
        self._cost_model = lpt_sched.CostModel.from_config(
            t.extra.get("cost_model"),
            {i: int(c) for i, c in enumerate(np.asarray(ds.counts))})
        # the first dispatch carries the warm-up: not a runtime sample
        self._cold_dispatch = True
        xb, yb, mb = pad_test_batches(ds.x_test, ds.y_test,
                                      max(t.batch_size, 64))
        self._test = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device) for a in (xb, eval_labels(yb), mb))
        self._eval = xla_ledger.track(
            make_eval_fn(self.apply_fn, t.extra.get("task"),
                         self.num_classes), "eval_fn")
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
        chunking), else of the mesh's federated axis, with zero-weight
        duplicates of ids[0]. A duplicate of an already-sampled client
        recomputes from the same pre-round state and is never the row the
        state scatter keeps; padding with id 0 would corrupt client 0's
        persistent state on rounds it was not sampled."""
        weights = self.counts[ids].astype(np.float32)
        mult = self._cohort_chunk or self._d
        pad = (-len(ids)) % mult if mult else 0
        if pad:
            ids = np.concatenate([ids, np.full(pad, ids[0], np.int32)])
            weights = np.concatenate([weights, np.zeros(pad, np.float32)])
        return ids, weights, pad

    def _lpt_applies(self, weights: np.ndarray, pad: int) -> bool:
        """Whether a padded id row gets the balanced-LPT permutation: on a
        mesh, with more clients than ranks, varied weights (or an engaged
        cost model), and not where padding meets FULL aggregation (the
        hook sees the real clients as a prefix, which a permutation would
        break)."""
        if self.mesh is None:
            return False
        schedulable = pad == 0 or not self._use_full
        varied = (len(np.unique(weights)) > 1
                  or (self._cost_model is not None
                      and self._cost_model.engaged()))
        return bool(self._schedule and schedulable
                    and len(weights) > self._d and varied)

    def _sched_costs(self, ids: np.ndarray, weights: np.ndarray) -> np.ndarray:
        """Per-slot LPT costs: the sample counts (the weights) until the
        cost model engages, then its predicted runtimes; pads cost 0."""
        cm = self._cost_model
        if cm is None or not cm.engaged():
            return weights
        costs = cm.predict_costs(ids)
        return np.where(weights > 0, costs, 0.0).astype(float)

    def _record_dispatch(self, ids, weights, duration_s: float) -> None:
        """Feed the cost model one dispatch's wall time over its real
        clients (across a mesh the slowest rank's, so every rank fits the
        same model and places alike); the cold first dispatch is
        dropped."""
        if self._cost_model is None or self._cold_dispatch:
            return
        if self.mesh is not None:
            duration_s = mesh_mod.agree_max(duration_s, self.mesh, self._axis)
        real = np.asarray(ids)[np.asarray(weights) > 0]
        self._cost_model.record_dispatch(real.tolist(), duration_s)
        # refresh the fit and the fed.cost_model.* gauges every time
        self._cost_model.engaged()

    def _round_inputs(self, round_idx: int, batch_idx=None, faults=None):
        """(ids, weights, batch_idx, faults) of one round: the sampled
        ids padded (`_pad_only`) and placed (`_lpt_applies`). A given
        schedule or fault mask of the sampled clients gains its pads' rows
        (ids[0]'s, which is what a pad draws) and follows the placement."""
        ids, weights, pad = self._pad_only(self.sample_clients(round_idx))
        perm = None
        if self._lpt_applies(weights, pad):
            blocks = lpt_sched.balanced_lpt(self._sched_costs(ids, weights),
                                            self._d)
            perm = np.concatenate([np.asarray(b, int) for b in blocks])
            ids, weights = ids[perm], weights[perm]
        if batch_idx is not None and (pad or perm is not None):
            batch_idx = torch.as_tensor(np.asarray(batch_idx))
            batch_idx = torch.cat([batch_idx, batch_idx[:1].expand(
                (pad,) + tuple(batch_idx.shape[1:]))])
            if perm is not None:
                batch_idx = batch_idx[torch.from_numpy(perm)]
        if faults is not None:
            faults = {k: np.asarray(v) for k, v in faults.items()}
            if pad:
                faults = {k: np.concatenate([v, np.full(pad, v[0])])
                          for k, v in faults.items()}
            if perm is not None:
                faults = {k: v[perm] for k, v in faults.items()}
        return ids, weights, batch_idx, faults

    def _seed(self, round_idx: int):
        return (self.cfg.common_args.random_seed, round_idx)

    def _observe(self, round_idx, ids, weights, metrics: dict,
                 duration_s: float) -> dict:
        """Feed the health tracker and the cost model one round and step
        the DP accountant; returns the history row's scalar metrics (with
        dp_epsilon where the DP is accounted)."""
        health = metrics.pop("health", None)
        faults = metrics.pop("faults", None)
        self.health.observe_round(round_idx, ids, weights, health,
                                  duration_s=duration_s, faults=faults)
        self._record_dispatch(ids, weights, duration_s)
        row = {k: float(v) for k, v in metrics.items()}
        self.dp.step_round()
        if self.dp.enabled and self.dp.accountant is not None:
            row["dp_epsilon"] = self.dp.get_epsilon()
        return row

    def _hier_round(self, agg_full, post_update, post_agg):
        """The (silos, intra) round: FedAvg / FedOpt with no plugins."""
        from ..core.algorithm import make_client_optimizer, make_objective
        from ..parallel.hier import make_hier_round

        t = self.cfg.train_args
        extras = [k for k, v in (
            ("round plugins (security, DP, compression, chaos)",
             agg_full or post_update or post_agg
             or self._plugins["client_dropout"]
             or self._plugins["client_straggler"]),
            ("cohort_chunk", t.extra.get("cohort_chunk")),
            ("rounds_per_block > 1",
             int(t.extra.get("rounds_per_block", 1) or 1) > 1)) if v]
        if extras:
            raise ValueError(
                f"the hierarchical round (a ('silos', 'intra') mesh) runs "
                f"plain FedAvg / FedOpt; it takes no {', '.join(extras)}")
        opt = make_client_optimizer(t.client_optimizer, t.learning_rate,
                                    t.momentum, t.weight_decay)
        return make_hier_round(self.apply_fn, self.alg, self.mesh, opt,
                               t.batch_size, t.epochs,
                               objective=make_objective(t.extra.get("task")))

    def run_round(self, round_idx: int, batch_idx=None, faults=None) -> dict:
        """One round. `batch_idx` ([m, steps, B], optional) is every
        sampled client's batch order; by default each client draws its own
        from (random_seed, round, client id). `faults` ({"dropped",
        "straggled"}, [m] 0/1, optional) replaces the chaos plane's draws
        (the tests hand the JAX round's masks over this way)."""
        if self._cohort_chunk:
            row = self._run_round_chunked(round_idx, batch_idx, faults)
            self._cold_dispatch = False
            return row
        ids, weights, batch_idx, faults = self._round_inputs(
            round_idx, batch_idx, faults)
        t0 = time.perf_counter()
        with recorder.span("train", round=round_idx):
            if self._hier:
                self.server_state, metrics = self.round_fn(
                    self.server_state, self.data, ids, weights,
                    self._seed(round_idx), batch_idx)
                metrics = fetch(metrics)
            else:
                out = self.round_fn(
                    self.server_state, self.client_states, self.data, ids,
                    weights, seed=self._seed(round_idx), batch_idx=batch_idx,
                    hook_state=self.hook_state, faults=faults)
                metrics = fetch(out.metrics)
                self.server_state = out.server_state
                self.client_states = out.client_states
                self.hook_state = out.hook_state
        row = self._observe(round_idx, ids, weights, metrics,
                            time.perf_counter() - t0)
        self._cold_dispatch = False
        return row

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
        finalize closes the round. Under a mesh each rank streams only its
        own block of the cohort, cohort_chunk / d clients a chunk, in the
        order the single-shot round trains them. Returns (ids, weights,
        RoundOutput)."""
        ids, weights, batch_idx, faults = self._round_inputs(
            round_idx, batch_idx, faults)
        c = self._cohort_chunk // max(self._d, 1)
        carry = self._make_carry(self.client_states, ids, self.device)
        sh = carry["share"]
        mine, w_mine = ids[sh], weights[sh]
        thunks = [self._chunk_thunk(mine[j:j + c])
                  for j in range(0, len(mine), c)]
        for j, chunk in enumerate(self._ingest.stream(thunks)):
            lo, hi = sh.start + j * c, sh.start + (j + 1) * c
            carry = self.chunk_fn(
                carry, self.server_state, chunk.ready(), np.arange(c),
                mine[j * c:(j + 1) * c], w_mine[j * c:(j + 1) * c],
                self._seed(round_idx), j * c,
                None if batch_idx is None else batch_idx[lo:hi],
                None if faults is None
                else {k: v[lo:hi] for k, v in faults.items()})
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

    def save(self, ckpt_dir: str, keep: Optional[int] = 3) -> Optional[str]:
        """Checkpoint the run (rank 0 of a mesh writes; the others return
        None)."""
        rounds_done = len(self.history)
        if rounds_done == 0:
            raise ValueError(
                "nothing to checkpoint: no rounds have completed (a "
                "round_-1 directory would be invisible to restore)")
        if not self._lead:
            return None
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
        as in the JAX package: a store hiccup must not end a long run.
        Rank 0 of a mesh publishes."""
        from .. import mlops

        if not self._lead:
            return

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
        if self._lead:
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
            ids = np.stack([i for i, _, _, _ in trips])
            weights = np.stack([w for _, w, _, _ in trips])
            batch_idx = (None if batch_schedule is None
                         else [b for _, _, b, _ in trips])
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
            if self._lead:
                recorder.log(row)
            self.history.append(row)
        # the whole first block carried the warm-up
        self._cold_dispatch = False
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
