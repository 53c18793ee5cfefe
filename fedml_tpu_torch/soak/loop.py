"""LiveLoopHarness — the whole port as ONE system (port of
`fedml_tpu/soak/loop.py`).

Composes the pieces into the closed production loop:

  train ──publish──▶ artifact store ──hot-swap──▶ serve ◀── loadgen
    ▲                                              │
    └───────────── chaos kills both tiers ─────────┘

- TRAIN: a durable cross-silo federation (cross_silo/soak.SiloSoakHarness
  over loopback threads, checkpoint/resume, generation fencing) whose
  federated model IS the serving model's LoRA adapter dict
  (llm.lora.lora_apply_fn over one shared, frozen `TransformerLM` + the
  `nwp` objective — clients train adapters on token shards, the round
  payload is adapters only, and they reach the forward as arguments).
- PUBLISH: the server's post-aggregation hook writes round N's aggregated
  adapters to `utils/artifacts.FileArtifactStore` under
  `adapters/round_N` — tensors-first/meta-last fsync'd publish, so the
  rolling fleet can never observe a half-written artifact.
- HOT-SWAP: a watcher thread sees each published round and drives
  `Deployment.rolling_update` (serialized /swap + /info convergence,
  per-request version pinning) to version N+1; a backlog collapses to the
  newest round (bounded lag, not unbounded swap debt).
- SERVE: N paged-engine LM replicas (`GreedyLMPredictor`, prefix cache on
  — the Zipf prefix pool hits it; all share the one base on the device)
  behind the least-loaded shedding gateway; loadgen drives unary + SSE
  traffic the whole time.
- CHAOS: ONE `FaultSpec` timeline kills both tiers — `silo_kill`
  (round-indexed, trainers; server restarts with resume, clients rejoin)
  and `replica_kill` (streamed-token-indexed; the gateway fails over
  mid-stream and the harness revives a replacement replica that swaps to
  the fleet version before joining routing).

The model, the adapters and the token shards are the port's draws: the
base from `llm.transformer.init_params(seed)`, the adapters from
`llm.lora.lora_init` with a generator seeded `seed + 1` on the device, the
shards from `numpy.random.RandomState(1000 * seed + cid)` (bitwise JAX's),
and each trainer's batch order from its (seed, round) generator
(`lora_trainer_factory`, which the tests hand JAX's draws). Everything
runs on `device` (CUDA unless "cpu").

Metrics: `soak.publishes` / `soak.replica_revives` / `soak.swap_retries`
counters, `soak.loop_round` / `soak.fleet_lag_rounds` / `soak.slo_ok`
gauges, `soak.round_to_serve_s` histogram (publish-to-fleet-converged
latency) — the `loop:` line in `python -m fedml_tpu_torch top`.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

import numpy as np

from ..utils import metrics as _mx
from ..utils.artifacts import FileArtifactStore, adapter_name

log = logging.getLogger(__name__)

# the default serving-model vocab — shared by __init__ and from_config so
# the config route's TrafficSpec stays inside the model's id range
DEFAULT_VOCAB = 32


def lora_trainer_factory(apply_fn: Callable, targs, *, seed: int,
                         vocab: int, seq_len: int, samples_per_client: int,
                         device, batch_schedule: Optional[Callable] = None
                         ) -> Callable:
    """cid -> the silo's `SiloTrainer` over `apply_fn` ((adapters, x) ->
    logits) on its next-token shard: `samples_per_client` sequences of
    `seq_len + 1` ids in [1, vocab) from `RandomState(1000 * seed + cid)`,
    x the first `seq_len`, y the last. `batch_schedule(cid, round)`, when
    given, is the trainer's batch order."""
    from ..cross_silo.trainer import SiloTrainer

    def factory(cid: int) -> SiloTrainer:
        rs = np.random.RandomState(1000 * seed + cid)
        seq = rs.randint(1, vocab, (samples_per_client, seq_len + 1))
        x = seq[:, :-1].astype(np.int64)
        y = seq[:, 1:].astype(np.int64)
        sched = None if batch_schedule is None else (
            lambda r, cid=cid: batch_schedule(cid, r))
        return SiloTrainer(apply_fn, targs, x, y, seed=cid, device=device,
                           batch_schedule=sched)

    return factory


class LiveLoopHarness:
    """One in-process live loop: training federation + serving fleet +
    gateway + artifact store + watcher, driven under one chaos timeline.

    Deterministic where it matters: the federation is seeded end to end
    (same final adapters as an unkilled run), and the loadgen schedule is
    a pure function of its seed; wall-clock latencies are the measured
    quantity, not a pinned one."""

    def __init__(self, *, rounds: int = 10, n_clients: int = 2,
                 n_replicas: int = 2, seed: int = 0,
                 store_dir: str, checkpoint_dir: Optional[str] = None,
                 fault_spec=None, traffic=None,
                 vocab: int = DEFAULT_VOCAB,
                 d_model: int = 16, n_layers: int = 1,
                 n_heads: int = 2, d_ff: int = 32, lora_rank: int = 2,
                 max_len: int = 48, decode_slots: int = 2,
                 kv_page_size: int = 4, kv_n_pages: Optional[int] = None,
                 prefill_chunk: int = 8,
                 seq_len: int = 16, samples_per_client: int = 32,
                 shed_watermark: float = 0.0, retry_after_s: float = 0.2,
                 server_timeout_s: float = 0.5,
                 revive_replicas: bool = True,
                 slo: Optional[dict] = None, device=None):
        import torch

        from .._device import resolve_device
        from ..config import TrainArgs
        from ..cross_silo.soak import SiloSoakHarness
        from ..llm.lora import lora_apply_fn, lora_init
        from ..llm.transformer import ModelDims, TransformerLM, init_params
        from .loadgen import TrafficSpec

        self.device = dev = resolve_device(device)
        self.rounds = rounds
        self.n_replicas = n_replicas
        self.seed = seed
        self.slo = dict(slo or {})
        self.revive_replicas = revive_replicas
        self.store = FileArtifactStore(store_dir)
        self.fault_spec = fault_spec
        if fault_spec is not None:
            # refuse schedules naming ranks/replicas that do not exist in
            # THIS topology — they would silently never fire
            fault_spec.validate_tiers(
                silo_ranks=range(n_clients + 1),
                replica_ranks=range(n_replicas))
        self.traffic = traffic or TrafficSpec(seed=seed, vocab=vocab)
        if self.traffic.max_total_len() > max_len:
            # fail BEFORE any model work: a traffic shape the engine cannot
            # admit would otherwise surface as mid-soak 400s
            raise ValueError(
                f"traffic shape needs prompt+output <= {max_len} "
                f"(engine max_len); spec's worst case is "
                f"{self.traffic.max_total_len()} — shrink the length "
                "tails or grow the engine")
        if self.traffic.vocab > vocab:
            # out-of-vocab ids would fail inside the embedding lookup —
            # the soak must refuse them up front
            raise ValueError(
                f"traffic vocab {self.traffic.vocab} exceeds the model "
                f"vocab {vocab} — requests would carry out-of-range "
                "token ids")

        # ---------------------------------------------------- model tier:
        # ONE frozen base on the device, shared by the trainers (adapters
        # as forward arguments) and every replica (merged adapted kernels
        # beside the shared rest)
        dims = ModelDims(vocab, d_model, n_layers, n_heads, d_ff)
        self.model = TransformerLM.from_state(
            dims, init_params(dims, seed=seed, device=dev))
        self.model.requires_grad_(False)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 1)
        self.adapters0 = {
            name: {k: v.cpu().numpy() for k, v in ab.items()}
            for name, ab in lora_init(self.model.state_dict(),
                                      rank=lora_rank, a_std=0.1,
                                      generator=gen).items()}
        self._apply = lora_apply_fn(self.model)

        # -------------------------------------------------- train tier:
        # the federated model IS the adapter dict; clients hold token
        # shards and train next-token prediction through the LoRA merge
        targs = TrainArgs(
            epochs=1, batch_size=8, learning_rate=0.1,
            client_num_in_total=n_clients, client_num_per_round=n_clients,
            comm_round=rounds, extra={"task": "nwp"})
        self.silo = SiloSoakHarness(
            n_clients=n_clients, rounds=rounds,
            checkpoint_dir=checkpoint_dir, seed=seed,
            init_params=self.adapters0,
            trainer_factory=lora_trainer_factory(
                self._apply, targs, seed=seed, vocab=vocab, seq_len=seq_len,
                samples_per_client=samples_per_client, device=dev),
            train_args=targs,
            server_kw=dict(round_timeout=10.0, quorum_frac=1.0,
                           postprocess_agg_fn=self._publish),
            client_kw=dict(server_timeout_s=server_timeout_s,
                           reattach=True, max_reattach=120),
            device=dev)

        # -------------------------------------------------- serve tier
        self.max_len = max_len
        self.decode_slots = decode_slots
        self.kv_page_size = kv_page_size
        # budget: every slot can hold a worst-case request, +1 null page
        self.kv_n_pages = kv_n_pages if kv_n_pages is not None else (
            decode_slots * ((max_len + kv_page_size - 1) // kv_page_size)
            + 1)
        self.prefill_chunk = prefill_chunk
        self._replicas: list = []      # [(runner, dep_replica)]
        self._revived: set = set()
        from ..serving.scheduler import Deployment, InferenceGateway

        runners = [self._make_runner(i, chaos=fault_spec)
                   for i in range(n_replicas)]
        self.dep = Deployment.adopt(
            [f"http://127.0.0.1:{r.port}" for r in runners])
        for runner, rep in zip(runners, self.dep.replicas):
            self._replicas.append((runner, rep))
        self.gateway = InferenceGateway(
            self.dep, scale_interval=30, shed_watermark=shed_watermark,
            retry_after_s=retry_after_s).start()
        self.url = f"http://127.0.0.1:{self.gateway.port}/predict"

        # ------------------------------------------------ loop plumbing
        self._pub_lock = threading.Lock()
        self._pub_queue: list[tuple[int, float]] = []
        self._published_round = -1
        self._swapped_round = -1
        self.lag_max_seen = 0
        self.publish_lat_s: list[float] = []
        self._watch_stop = threading.Event()
        self._watcher: Optional[threading.Thread] = None
        self._revive_threads: list[threading.Thread] = []

    # ------------------------------------------------------- serve tier
    def _device_adapters(self, tree: dict) -> dict:
        import torch

        return {name: {k: torch.as_tensor(np.asarray(v)).to(
            device=self.device, dtype=torch.float32)
            for k, v in ab.items()} for name, ab in tree.items()}

    def _make_predictor(self, adapters):
        from ..serving.predictor import GreedyLMPredictor

        return GreedyLMPredictor(
            self.model, adapters=self._device_adapters(adapters),
            max_len=self.max_len, kv_cache=True,
            decode_slots=self.decode_slots,
            kv_page_size=self.kv_page_size, kv_n_pages=self.kv_n_pages,
            prefill_chunk=self.prefill_chunk, prefix_cache=True,
            device=self.device)

    def _make_runner(self, rank: int, chaos=None, adapters=None,
                     version: int = 0):
        from ..serving.inference_runner import FedMLInferenceRunner

        pred = self._make_predictor(
            self.adapters0 if adapters is None else adapters)
        if version > 0 and adapters is not None:
            # a revived replica joins AT the fleet version, not at v0 —
            # the /info convergence checks and per-request pins must see
            # the truth
            pred.swap_adapters(self._device_adapters(adapters),
                               version=version)
        return FedMLInferenceRunner(pred, port=0, chaos=chaos,
                                    chaos_rank=rank).start()

    def warmup(self) -> None:
        """Run the serving path before traffic flows, so TTFT measurements
        reflect serving, not first-call costs: one request per chunk size
        the engine can dispatch (prompts of every pow2 final-chunk size up
        to prefill_chunk, plus the worst-case prompt), per replica."""
        for runner, _rep in self._replicas:
            self._warm_replica(runner)

    def _warm_replica(self, runner) -> None:
        from ..serving.fleet_harness import post

        lens = {self.traffic.max_prompt_len()}
        b = 1
        while b <= self.prefill_chunk:
            lens.add(b)
            b *= 2
        url = f"http://127.0.0.1:{runner.port}/predict"
        for n in sorted(lens):
            post(url, {"tokens": [t % (self.traffic.vocab - 1) + 1
                                  for t in range(n)],
                       "max_new_tokens": 2}, timeout=120)

    # ------------------------------------------------------ train hooks
    def _publish(self, params, round_idx: int):
        """FedServerManager post-aggregation hook: publish round N's
        aggregated adapter tree (tensors-first/meta-last — a rolling
        fleet never sees a torn artifact), then hand the params back
        unchanged. A resumed server may legitimately re-publish the round
        it re-ran; the content is bitwise-identical and the watcher skips
        already-swapped rounds."""
        self.store.put(adapter_name(round_idx), params)
        _mx.inc("soak.publishes")
        _mx.set_gauge("soak.loop_round", round_idx)
        with self._pub_lock:
            self._published_round = max(self._published_round, round_idx)
            self._pub_queue.append((round_idx, time.monotonic()))
            lag = max(0, self._published_round - self._swapped_round)
        self.lag_max_seen = max(self.lag_max_seen, lag)
        _mx.set_gauge("soak.fleet_lag_rounds", lag)
        return params

    # ---------------------------------------------------------- watcher
    def _watch(self) -> None:
        while not self._watch_stop.is_set():
            # revival is checked every tick, not only when a swap is
            # pending — a replica killed AFTER the last round's swap
            # must still be replaced
            if self.revive_replicas:
                self._revive_dead()
            with self._pub_lock:
                queue = [(r, t) for r, t in self._pub_queue
                         if r > self._swapped_round]
                self._pub_queue = queue
                target = queue[-1] if queue else None
            if target is None:
                self._watch_stop.wait(0.02)
                continue
            r, t_pub = target
            try:
                self.dep.rolling_update(
                    self.store, adapter_name(r), version=r + 1,
                    timeout=30)
            except RuntimeError as e:
                # a replica died mid-walk (chaos): it is SUSPECT now;
                # retry — probation/revival restores capacity and the
                # next attempt walks the survivors
                log.warning("rolling update to round %d failed "
                            "(retrying): %s", r, e)
                _mx.inc("soak.swap_retries")
                self._watch_stop.wait(0.05)
                continue
            lat = time.monotonic() - t_pub
            with self._pub_lock:
                self._swapped_round = r
                lag = max(0, self._published_round - r)
            self.publish_lat_s.append(lat)
            _mx.observe("soak.round_to_serve_s", lat)
            _mx.set_gauge("soak.fleet_lag_rounds", lag)

    def _revive_dead(self) -> None:
        """Replace chaos-killed replicas ASYNCHRONOUSLY: marking the dead
        record out of rotation is immediate, but building the replacement
        runs on its own thread — the watcher keeps rolling updates
        flowing to the survivors meanwhile (a synchronous revive would
        hold the fleet behind training; the lag bound exists to catch
        exactly that)."""
        from ..serving.scheduler import R_DEAD

        for i, (runner, rep) in enumerate(list(self._replicas)):
            if not runner._killed or i in self._revived:
                continue
            self._revived.add(i)
            if rep.state != R_DEAD:
                self.dep.mark_dead(rep)
            t = threading.Thread(target=self._revive_one, args=(i,),
                                 daemon=True)
            t.start()
            self._revive_threads.append(t)

    def _revive_one(self, dead_idx: int) -> None:
        """Build + warm a replacement replica OFF the routing path, swap
        it to the current fleet adapters, and only then adopt it into the
        deployment. If the fleet moved on meanwhile, the final
        `Deployment.converge` sweep (run()) or the next rolling update's
        post-walk sweep brings it level."""
        try:
            swapped = self._swapped_round
            adapters = (self.store.get(adapter_name(swapped))
                        if swapped >= 0 else None)
            new_runner = self._make_runner(
                rank=len(self._replicas), adapters=adapters,
                version=swapped + 1)
            self._warm_replica(new_runner)
            new_rep = self.dep.adopt_endpoint(
                f"http://127.0.0.1:{new_runner.port}")
            new_rep.model_version = swapped + 1 if swapped >= 0 else 0
            self._replicas.append((new_runner, new_rep))
            _mx.inc("soak.replica_revives")
            log.info("revived replica %d as %s at version %d", dead_idx,
                     new_rep.replica_id, swapped + 1)
        except Exception:  # noqa: BLE001 — a failed revive must not kill
            log.exception("replica %d revive failed", dead_idx)

    # -------------------------------------------------------------- run
    def run(self, timeout: float = 300.0, tail_s: float = 0.0) -> dict:
        """Drive the whole loop to completion: start training, watcher,
        and loadgen; execute the silo_kill timeline at round boundaries;
        wait for training to finish AND the fleet to converge on the
        final round's adapters; evaluate SLOs. `tail_s` keeps loadgen
        traffic flowing that long AFTER convergence — steady-state
        coverage of the final fleet (short training runs otherwise leave
        a thin request sample). Returns the report dict
        (slo.evaluate_slo output + loop facts)."""
        from ..utils import postmortem
        from ..utils.attribution import analyze_and_publish
        from ..utils.slo import SloMonitor, default_specs
        from .loadgen import LoadGenerator
        from .slo import evaluate_slo

        # arm the crash flight recorder at the artifact root: the chaos
        # timeline's silo kills flush postmortems there, and an OS-level
        # death of the whole harness leaves the inflight spill. Respect
        # an already-armed recorder — a parent harness may own it.
        if postmortem.flight.armed_dir is None:
            postmortem.arm(str(self.store.root), process="live-loop")
        self.warmup()
        self._watcher = threading.Thread(target=self._watch, daemon=True)
        self._watcher.start()
        t_train0 = time.monotonic()
        self.silo.start_all()
        # traffic starts once round 0 has completed: first-call costs all
        # land in round 0, and a loadgen sharing the host with them would
        # measure set-up, not the fleet
        self.silo.wait_history(1, timeout=120)
        gen = LoadGenerator(self.traffic, self.url).start()
        # live burn-rate watch over the SAME bars evaluate_slo judges
        # post hoc (utils/slo.py): starts with traffic, so a run trending
        # red alerts while it is still running
        slo_mon = SloMonitor(
            default_specs(self.slo),
            fast_window_s=float(self.slo.get("slo_fast_window_s", 5.0)),
            slow_window_s=float(self.slo.get("slo_slow_window_s", 30.0)),
        ).start()
        kills = dict(self.fault_spec.silo_kill) if self.fault_spec else {}
        pending = sorted(kills.items(), key=lambda kv: (kv[1], kv[0]))
        executed = []
        end = time.monotonic() + timeout
        wall_train = None
        while time.monotonic() < end:
            srv = self.silo.server
            done_rounds = len(srv.history) if srv is not None else 0
            fired = False
            for rank, after in list(pending):
                if srv is None or done_rounds < after:
                    continue
                pending.remove((rank, after))
                executed.append((rank, after))
                if rank == 0:
                    self.silo.kill_server()
                    self.silo.start_server(resume=True)
                else:
                    self.silo.kill_client(rank)
                    self.silo.start_client(rank)
                fired = True
                break            # one kill per poll; re-read state
            if fired:
                continue
            srv = self.silo.server
            if not pending and srv is not None and srv.done.wait(0.05):
                if wall_train is None:
                    wall_train = time.monotonic() - t_train0
                # training done: wait for the fleet to converge on the
                # final round before calling the loop complete
                if self._swapped_round >= self.rounds - 1:
                    break
            time.sleep(0.01)
        wall_train = wall_train or (time.monotonic() - t_train0)
        if tail_s > 0:
            time.sleep(min(tail_s, max(0.0, end - time.monotonic())))
        srv = self.silo.server
        train_done = srv is not None and srv.done.is_set()
        # bring late joiners level: a replica revived near the end may
        # have adopted at an older version than the final swap
        for t in self._revive_threads:
            t.join(timeout=60)
        if self._swapped_round >= 0:
            self.dep.converge(self.store,
                              adapter_name(self._swapped_round),
                              self._swapped_round + 1)
        results = gen.stop(timeout=60)
        slo_mon.stop()
        # round-time budget over the run's spans -> fed.budget.* gauges
        # (the report/top `budget:` line)
        analyze_and_publish(wall_s=wall_train)
        report = evaluate_slo(
            results, rounds_done=len(srv.history) if srv else 0,
            wall_s=wall_train,
            fleet_version=self._swapped_round + 1,
            lag_max_seen=self.lag_max_seen,
            publish_lat_s=self.publish_lat_s, slo=self.slo)
        report.update(
            train_done=train_done,
            train_error=srv.error if srv else "server dead",
            converged=self._swapped_round >= self.rounds - 1,
            kills_executed=executed,
            kills_pending=pending,
            history=[dict(h) for h in (srv.history if srv else [])],
            fleet_versions=self.dep.versions(),
            slo_alerts_firing=slo_mon.firing())
        report["loop_ok"] = bool(
            report["slo_ok"] and train_done and not report["train_error"]
            and report["converged"] and not pending)
        return report

    @classmethod
    def from_config(cls, cfg, *, store_dir: str,
                    checkpoint_dir: Optional[str] = None,
                    **overrides) -> "LiveLoopHarness":
        """Build the harness from a validated Config: the
        `common_args.extra.soak` knobs go through soak_plan (THE knob
        mapping), the chaos timeline rides `common_args.extra.chaos` as
        everywhere else, and the device is the config's
        (`fedml_tpu_torch.init(device=)`) unless `device=` overrides it."""
        from ..comm.chaos import FaultSpec
        from .knobs import soak_plan, validate_soak
        from .loadgen import TrafficSpec

        sk = dict(cfg.common_args.extra.get("soak") or {})
        validate_soak(sk)
        plan = soak_plan(sk)
        lg = plan["loadgen"]
        kw = dict(
            rounds=plan["rounds"], n_clients=plan["n_clients"],
            n_replicas=plan["n_replicas"], seed=plan["seed"],
            fault_spec=FaultSpec.from_config(cfg),
            slo=plan["slo"],
            device=cfg.device_args.extra.get("device"))
        kw["traffic"] = TrafficSpec(
            seed=lg["seed"], rate_rps=lg["rate_rps"],
            duration_s=lg["duration_s"], zipf_s=lg["zipf_s"],
            prefix_pool=lg["prefix_pool"],
            stream_frac=lg["stream_frac"],
            burst_every_s=lg["burst_every_s"],
            burst_factor=lg["burst_factor"],
            burst_len_s=lg["burst_len_s"],
            vocab=overrides.get("vocab", DEFAULT_VOCAB))
        kw.update(overrides)
        return cls(store_dir=store_dir, checkpoint_dir=checkpoint_dir,
                   **kw)

    # ------------------------------------------------------------ teardown
    def close(self) -> None:
        self._watch_stop.set()
        if self._watcher is not None:
            self._watcher.join(timeout=10)
        try:
            self.gateway.stop()
        except Exception:  # noqa: BLE001 — teardown best-effort
            pass
        for runner, _rep in self._replicas:
            try:
                runner.stop()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        self.silo.close()
