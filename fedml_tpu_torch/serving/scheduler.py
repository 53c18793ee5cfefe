"""Model-serving scheduler — deploy FSM, inference gateway, autoscaler
(port of `fedml_tpu/serving/scheduler.py`).

(reference: computing/scheduler/model_scheduler/ —
device_model_deployment.py:37 start_deployment packages a model and brings
up per-device inference containers with readiness polling;
device_model_inference.py:32-143 is the gateway that routes /predict to
ready devices; autoscaling rides the SaaS. Here the same three roles are
local-first over the port's own scheduler agents:)

- Deployment.deploy(): package (model spec + params/checkpoint) → submit one
  "serve" job per replica through the MasterAgent → workers start in-process
  HTTP replicas (serving/inference_runner.py) → poll /ready until live.
  FSM per replica: DISPATCHED → READY | SUSPECT | DEAD. SUSPECT is the
  probation state: a replica that failed a request window is re-probed
  (/ready with exponential backoff) instead of being removed forever — a
  transient stall rejoins the pool; only a probation that times out goes
  DEAD and triggers healing.
- InferenceGateway: HTTP /predict facade. Routing is LOAD-AWARE: among
  READY replicas the one with the fewest gateway-tracked in-flight
  requests wins (round-robin breaks ties), so a replica with a long
  decode queued doesn't keep collecting traffic. Above the configured
  `shed_watermark` (fleet-wide in-flight per ready replica) the gateway
  SHEDS with 429 + Retry-After — overload degrades to fast refusal, not
  piled-up timeouts. Streams (`"stream": true`) relay SSE events
  chunk-by-chunk; a stream cut by replica death mid-response is
  transparently re-served from token 0 on a survivor for deterministic
  (greedy) requests — already-relayed tokens are deduped so the client's
  total stream is byte-identical to an unkilled run, and an unpinned
  stream whose replay diverges (the survivor swapped mid-rolling-update,
  or, on the card, a bf16 survivor's batch flipped a near-tie argmax) is
  continued via a prompt+delivered-prefix re-issue instead of erroring —
  and surfaced as a terminal error event for sampled requests (re-running
  them would change the tokens; a half-stream must never look complete).
- Deployment.rolling_update(): the federated model-churn path — round-N
  LoRA adapters published through utils/artifacts.py are hot-swapped
  into each replica IN TURN via its /swap endpoint (no restart, no
  KV-cache teardown; engine story in serving/engine.py), with /info
  polled until the replica reports the new model_version before the
  next one swaps. Requests keep flowing the whole time; per-request
  `model_version` pinning (409 → gateway reroutes to a sibling) keeps a
  mixed-version window honest for callers that care.
- Autoscaler: queue-depth scaling — the gateway tracks in-flight requests;
  above high_water x replicas it submits another serve job, below low_water
  it retires one (min/max bounds).

Everything here but `start_replica` is host code, the JAX module's line
for line. `start_replica` builds the port's predictors on the spec's
`"device"` (CUDA unless it names "cpu"). Replicas on one host share the
card; the gateway, probation, the autoscaler and the replicas' engines all
run on threads of one process.
"""
from __future__ import annotations

import json
import logging
import math
import threading
import time
import urllib.error
import urllib.request
import uuid
from typing import Any, Optional

import numpy as np

from ..utils import metrics as _mx
from ..utils.events import recorder

log = logging.getLogger(__name__)

R_DISPATCHED = "DISPATCHED"
R_READY = "READY"
R_SUSPECT = "SUSPECT"
R_DEAD = "DEAD"


class _StreamCut(RuntimeError):
    """An upstream SSE stream died before its terminal event."""


class _ClientGone(RuntimeError):
    """The DOWNSTREAM client hung up mid-relay (a write to the handler's
    socket failed). Distinct from _StreamCut on purpose: the replica is
    healthy, so the gateway must not suspect it or burn a failover
    re-decode on a socket nobody is reading."""


class _StalePin(RuntimeError):
    """A pinned stream straddled its replica's hot swap (the replica
    emitted a terminal 409-coded error event): the replica is HEALTHY
    and now serves a newer version — reroute to a sibling like the
    HTTP-level 409, never suspect."""


class _ReplayDiverged(RuntimeError):
    """A greedy failover replay produced a DIFFERENT token inside the
    already-relayed prefix — the survivor serves other weights (e.g. a
    rolling update swapped it between the cut and the retry). The
    survivor is healthy — never suspected. For an UNPINNED stream the
    gateway recovers by re-issuing a CONTINUATION (prompt + the tokens
    the client already has, remaining budget) — the same
    prefix-from-old-weights/suffix-under-new semantics an in-place hot
    swap already gives unpinned in-flight streams, so nothing is
    fabricated. Splicing the diverged replay itself (a suffix continuing
    the SURVIVOR's prefix, not the client's) would fabricate output, and
    a PINNED stream's pin was the version guarantee — those surface a
    terminal error."""


def fleet_knobs(sv: dict) -> tuple[dict, dict]:
    """serve_args/serve-spec dict -> (Deployment kwargs, InferenceGateway
    kwargs): the fleet-side half of THE serve-knob mapping (predictor-side
    knobs ride predictor.lm_predictor_from_serve_knobs) — config and
    operator surfaces build fleets through one translation, so knob names
    cannot drift between YAML and constructors."""
    dep_kw = {}
    if sv.get("probation_deadline_s") is not None:
        dep_kw["probation_deadline_s"] = float(sv["probation_deadline_s"])
    if sv.get("probe_backoff_s") is not None:
        dep_kw["probe_backoff_s"] = float(sv["probe_backoff_s"])
    gw_kw = {}
    if sv.get("shed_watermark") is not None:
        gw_kw["shed_watermark"] = float(sv["shed_watermark"])
    if sv.get("retry_after_s") is not None:
        gw_kw["retry_after_s"] = float(sv["retry_after_s"])
    if sv.get("affinity_routing") is not None:
        gw_kw["affinity"] = bool(sv["affinity_routing"])
    return dep_kw, gw_kw


def start_replica(spec: dict):
    """Worker-side: build a predictor from a deployment spec and serve it.
    Spec sources (first match wins):
      - "export_dir": framework-neutral flat-tensor export (serving/
        export.py — the reference's ONNX/Triton model-repo analog,
        device_model_deployment.py:720 convert_model_to_onnx); the export's
        own manifest carries the model recipe, so no other spec keys needed
      - "model_kind": "lm": a `TransformerLM` from the "lm" dims
        (vocab_size, d_model, n_layers, n_heads, d_ff; max_len; dtype for a
        flax tree) whose weights are "params" (the port's state dict, used
        as given when its tensors already sit on the device in their dtype,
        so replicas built from one state share one copy; or a flax tree,
        through `llm.transformer.params_from_flax`), served through
        `lm_predictor_from_serve_knobs` with the "serve" knobs and the
        optional "adapters" (the port's adapter dict, or a JAX tree of
        "/"-joined paths through `llm.lora.adapters_from_jax`)
      - "checkpoint_dir": a checkpoint from utils/checkpoint.py, its server
        state held to `build_algorithm`'s template
      - "params": inline parameters (the port's flat dict, or a flax tree)
        that ride the tensor wire format
    plus "model"/"num_classes"/"input_shape"/"model_args"/"compute_dtype"
    to rebuild the model (reference: start_deployment's model-package
    unpack). "device" names where the replica runs (CUDA unless "cpu";
    without a GPU the CUDA default raises). A "chaos" dict (comm/chaos.py
    FaultSpec knobs) + "chaos_rank" arm the replica's deterministic kill
    schedule — the fault-injection surface the mid-stream failover tests
    drive."""
    from .._device import resolve_device
    from .inference_runner import FedMLInferenceRunner

    dev = resolve_device(spec.get("device"))
    chaos = None
    if spec.get("chaos"):
        from ..comm.chaos import FaultSpec

        chaos = (spec["chaos"] if isinstance(spec["chaos"], FaultSpec)
                 else FaultSpec.from_dict(spec["chaos"]))
    chaos_kw = {"chaos": chaos, "chaos_rank": int(spec.get("chaos_rank", 0))}

    def serve(pred):
        runner = FedMLInferenceRunner(pred, port=int(spec.get("port", 0)),
                                      **chaos_kw)
        runner.start()
        return uuid.uuid4().hex[:10], runner

    if spec.get("export_dir"):
        from .export import predictor_from_export

        return serve(predictor_from_export(spec["export_dir"], device=dev))

    if spec.get("model_kind") == "lm":
        return serve(_lm_predictor(spec, dev))

    import torch

    from ..models import hub
    from .export import _input_shape, torch_params
    from .predictor import TorchPredictor

    compute_dtype = spec.get("compute_dtype", "float32")
    if spec.get("checkpoint_dir"):
        from ..algorithms.builtin import build_algorithm
        from ..config import TrainArgs
        from ..utils.checkpoint import restore_checkpoint

        model = hub.create(spec["model"], int(spec.get("num_classes", 10)),
                           tuple(spec["input_shape"]), device=dev,
                           **dict(spec.get("model_args", {})))
        apply_fn = hub.apply_fn(model, compute_dtype)
        # the saved server-state STRUCTURE depends on the algorithm that
        # trained it; rebuild the same template the Simulator used
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        init = hub.init_params(model, gen)
        alg = build_algorithm(spec.get("federated_optimizer", "FedAvg"),
                              apply_fn, TrainArgs(), 1, 1)
        st = alg.server_init(init, None)
        _r, server, _c, _h, _hist = restore_checkpoint(
            spec["checkpoint_dir"],
            {"params": st.params, "opt_state": st.opt_state,
             "round": st.round, "extra": st.extra}, device=dev)
        params = server["params"]
    else:
        params = torch_params(spec["params"], dev)
        shape = spec.get("input_shape") or _input_shape(spec["model"],
                                                         params)
        model = hub.create(spec["model"], int(spec.get("num_classes", 10)),
                           None if shape is None else tuple(shape),
                           device="meta", **dict(spec.get("model_args", {})))
        apply_fn = hub.apply_fn(model, compute_dtype)
    return serve(TorchPredictor(apply_fn, params, device=dev))


def _lm_predictor(spec: dict, dev):
    """The "model_kind": "lm" replica's predictor (start_replica)."""
    from collections.abc import Mapping

    import torch

    from ..llm.lora import adapters_from_jax
    from ..llm.transformer import ModelDims, TransformerLM, params_from_flax
    from .predictor import lm_predictor_from_serve_knobs

    lm = dict(spec.get("lm", {}))
    dims = ModelDims(int(lm["vocab_size"]), int(lm["d_model"]),
                     int(lm["n_layers"]), int(lm["n_heads"]),
                     int(lm["d_ff"]))
    params = spec["params"]
    dtype = getattr(torch, lm["dtype"]) if lm.get("dtype") else None
    if any(isinstance(v, Mapping) for v in params.values()):
        state = params_from_flax(params, dtype=dtype or torch.float32,
                                 device=dev)
    else:
        state = {}
        for k, v in params.items():
            t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(v))
            state[k] = t.to(device=dev, dtype=dtype or t.dtype)
    model = TransformerLM.from_state(dims, state)
    adapters = spec.get("adapters")
    if adapters is not None:
        if any("/" in k for k in adapters):
            adapters = adapters_from_jax(adapters, device=dev)
        else:
            adapters = {name: {k: (v if isinstance(v, torch.Tensor)
                                   else torch.from_numpy(np.asarray(v))
                                   ).to(device=dev, dtype=torch.float32)
                               for k, v in ab.items()}
                        for name, ab in adapters.items()}
    return lm_predictor_from_serve_knobs(
        dict(spec.get("serve", {})), model, adapters=adapters, device=dev,
        default_max_len=int(lm.get("max_len", 256)))


class _Replica:
    def __init__(self, job_id: str):
        self.job_id = job_id
        self.state = R_DISPATCHED
        self.replica_id: Optional[str] = None
        self.endpoint: Optional[str] = None
        self.worker_id: Optional[int] = None
        # gateway-tracked outstanding requests (the least-loaded routing
        # signal; mutated under the Deployment lock)
        self.inflight = 0
        # last model_version this replica reported (/info; rolling update)
        self.model_version: Optional[int] = None
        # prefix-affinity residency hint: the first-page prefix digests
        # this replica's engine advertised (X-Prefix-Digest response
        # header / the /info "prefix_digests" field) and its page
        # geometry. Written by the gateway off successful responses,
        # read lock-free at routing time — a HINT, never correctness
        self.page_size = 0
        self.prefix_digests: frozenset = frozenset()


class Deployment:
    """Deploy FSM over a MasterAgent (reference:
    device_model_deployment.py:37 start_deployment).

    `probation_deadline_s` bounds how long a SUSPECT replica gets to
    answer /ready again before it is declared DEAD and healed over;
    `probe_backoff_s` seeds the exponential re-probe interval."""

    def __init__(self, master, serve_spec: dict, min_replicas: int = 1,
                 max_replicas: int = 4, probation_deadline_s: float = 10.0,
                 probe_backoff_s: float = 0.05):
        self.master = master
        self.spec = dict(serve_spec)
        self.spec["type"] = "serve"
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.probation_deadline_s = probation_deadline_s
        self.probe_backoff_s = probe_backoff_s
        self.replicas: list[_Replica] = []
        self._lock = threading.Lock()
        self._rr = 0
        # (swap body, version) of the last rolling_update that walked the
        # WHOLE fleet — probation recovery re-drives it so a replica that
        # was SUSPECT during the update can't rejoin serving stale weights
        self._adapter_target: Optional[tuple[bytes, int]] = None

    @classmethod
    def adopt(cls, endpoints: list[str], **kwargs) -> "Deployment":
        """A deployment over ALREADY-RUNNING replicas (no MasterAgent):
        the single-host shape where replicas are started in-process —
        tests, the diagnosis probe, the bench — and any setup where
        replica lifecycle is managed elsewhere. Healing/scaling are
        no-ops (there is no scheduler to submit to); probation and
        routing work unchanged."""
        dep = cls(None, {}, min_replicas=len(endpoints),
                  max_replicas=len(endpoints), **kwargs)
        for ep in endpoints:
            dep.adopt_endpoint(ep)
        return dep

    def adopt_endpoint(self, endpoint: str) -> _Replica:
        """Adopt ONE already-running replica into the pool mid-flight —
        the live-loop harness's replica-revival path (soak/loop.py): a
        chaos-killed replica's replacement runner is brought up out of
        band and joins routing here. The caller is responsible for the
        replica's model version (swap it to the fleet target BEFORE
        adopting, or the next rolling update's post-walk sweep converges
        it)."""
        with self._lock:
            i = len(self.replicas)
            rep = _Replica(f"adopted-{i}")
            rep.replica_id = f"adopted-{i}"
            rep.endpoint = endpoint.rstrip("/")
            rep.state = R_READY
            self.replicas.append(rep)
            self.max_replicas = max(self.max_replicas, len(self.replicas))
        self._publish_gauges()
        return rep

    # ------------------------------------------------------------ deploy
    def deploy(self, n_replicas: Optional[int] = None,
               timeout: float = 60.0) -> "Deployment":
        n = n_replicas if n_replicas is not None else self.min_replicas
        for _ in range(n):
            self._dispatch_one(timeout)
        self.wait_ready(n, timeout)
        return self

    def _dispatch_one(self, timeout: float = 60.0) -> Optional[_Replica]:
        if self.master is None:
            return None          # adopted deployment: nothing to dispatch
        jid = self.master.submit(dict(self.spec))
        rep = _Replica(jid)
        with self._lock:
            self.replicas.append(rep)
        threading.Thread(target=self._track, args=(rep, timeout),
                         daemon=True).start()
        return rep

    def _track(self, rep: _Replica, timeout: float = 60.0) -> None:
        """DISPATCHED -> (job result with endpoint) -> poll /ready -> READY."""
        job = self.master.wait(rep.job_id, timeout=timeout)
        if job.status != "FINISHED" or not isinstance(job.result, dict):
            rep.state = R_DEAD
            log.warning("replica job %s failed: %s", rep.job_id, job.result)
            return
        rep.replica_id = job.result["replica_id"]
        rep.worker_id = job.result.get("worker_id")
        rep.endpoint = f"http://{job.result['host']}:{job.result['port']}"
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._probe_ready(rep):
                rep.state = R_READY
                self._publish_gauges()
                return
            time.sleep(0.05)
        rep.state = R_DEAD
        self._publish_gauges()

    def _probe_ready(self, rep: _Replica) -> bool:
        try:
            with urllib.request.urlopen(rep.endpoint + "/ready",
                                        timeout=2) as r:
                return r.status == 200
        except (urllib.error.URLError, OSError):
            return False

    def wait_ready(self, n: int, timeout: float = 60.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if len(self.ready_replicas()) >= n:
                return True
            time.sleep(0.05)
        return False

    def ready_replicas(self) -> list[_Replica]:
        with self._lock:
            return [r for r in self.replicas if r.state == R_READY]

    def _publish_gauges(self) -> None:
        with self._lock:
            states = [r.state for r in self.replicas]
        _mx.set_gauge("serving.replicas_ready", states.count(R_READY))
        _mx.set_gauge("serving.replicas_suspect", states.count(R_SUSPECT))

    # ------------------------------------------------------------ routing
    def acquire(self, exclude: Optional[set] = None,
                prefer: Optional[frozenset] = None) -> Optional[_Replica]:
        """Least-loaded pick: among READY replicas, the one with the
        fewest gateway-tracked in-flight requests (round-robin breaks
        ties), with its inflight count already incremented — the caller
        MUST release(). First-ready routing piled new work onto a
        replica whose slots were already saturated while its siblings
        idled; in-flight depth is the signal the gateway actually has.
        `exclude` skips replica_ids the caller already ruled out this
        request (the 409 version-pin reroute: an idle stale replica
        would otherwise win least-loaded on every retry). `prefer`
        (prefix-affinity routing) restricts the pick to those
        replica_ids when any of them is READY and not excluded —
        otherwise the full pool competes, so affinity can only ever
        REORDER healthy candidates, never starve a request behind a
        SUSPECT/DEAD/stale preferred replica."""
        with self._lock:
            ready = [r for r in self.replicas if r.state == R_READY
                     and (not exclude or r.replica_id not in exclude)]
            if not ready:
                return None
            if prefer:
                hot = [r for r in ready if r.replica_id in prefer]
                if hot:
                    ready = hot
            self._rr += 1
            rep = min(
                (r for r in ready),
                key=lambda r: (r.inflight,
                               (self.replicas.index(r) - self._rr)
                               % max(len(self.replicas), 1)))
            rep.inflight += 1
            return rep

    def release(self, rep: _Replica) -> None:
        with self._lock:
            rep.inflight = max(0, rep.inflight - 1)

    # ----------------------------------------------------- failure states
    def mark_suspect(self, rep: _Replica) -> None:
        """A replica failed a request window: pull it from rotation and
        PROBE it instead of killing it — one bad window (GC pause, a
        long compile, a dropped connection) used to remove a replica
        permanently. Probation polls /ready with exponential backoff; an
        answer within `probation_deadline_s` returns the replica to
        READY (counted in serving.replica_recoveries), a timeout goes
        DEAD and triggers healing."""
        with self._lock:
            if rep.state != R_READY:
                return           # already suspect/dead/still starting
            rep.state = R_SUSPECT
        _mx.inc("serving.replica_suspects")
        self._publish_gauges()
        threading.Thread(target=self._probation, args=(rep,),
                         daemon=True).start()

    def _probation(self, rep: _Replica) -> None:
        deadline = time.monotonic() + self.probation_deadline_s
        backoff = self.probe_backoff_s
        while time.monotonic() < deadline:
            # read the current update target under the lock: this probe
            # thread races rolling_update's write, and the lock (not GIL
            # reference atomicity) is what makes the later
            # `is not target` re-check under the same lock coherent
            with self._lock:
                target = self._adapter_target
            if self._probe_ready(rep) and self._converge_version(rep, target):
                with self._lock:
                    if rep.state != R_SUSPECT:   # scale_down won the race
                        return
                    if self._adapter_target is not target:
                        # a rolling update completed between the version
                        # check and this rejoin — loop to converge on the
                        # NEW target before returning to rotation
                        continue
                    rep.state = R_READY
                _mx.inc("serving.replica_recoveries")
                self._publish_gauges()
                log.info("replica %s recovered from probation",
                         rep.replica_id)
                return
            time.sleep(backoff)
            backoff = min(backoff * 2, 1.0)
        with self._lock:
            if rep.state != R_SUSPECT:
                return
            rep.state = R_DEAD
        _mx.inc("serving.replica_deaths")
        self._publish_gauges()
        log.warning("replica %s failed probation; healing", rep.replica_id)
        self.reap_and_heal()

    def _converge_version(self, rep: _Replica,
                          target: Optional[tuple[bytes, int]]) -> bool:
        """A replica rejoining from probation may have been SUSPECT while
        a rolling update walked the fleet (the update only swaps the
        replicas READY at entry) — returning it to rotation on the old
        adapters would silently serve stale weights behind a fleet gauge
        that says otherwise. Re-drive the last successful swap before it
        rejoins; True = replica is at the fleet version (or no update has
        ever succeeded). `target` is the (swap body, version) the caller
        read, passed in so the check and the rejoin decide against the
        SAME update. A replica AT OR AHEAD of the target counts as
        converged: ahead just means a newer update already reached it,
        and re-driving the older body would only bounce off the engine's
        monotonic-version guard (400) until probation killed a healthy
        replica."""
        if target is None:
            return True
        body, version = target
        info = self.replica_info(rep)
        if info is None:
            return False
        have = info.get("model_version")
        if have is not None and int(have) >= version:
            return True
        req = urllib.request.Request(
            rep.endpoint + "/swap", data=body,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=10) as r:
                got = json.loads(r.read() or b"{}")
        except (urllib.error.URLError, OSError, json.JSONDecodeError):
            return False
        if int(got.get("model_version", -1)) != version:
            return False
        rep.model_version = version
        _mx.inc("serving.probation_reswaps")
        log.info("replica %s re-swapped to fleet version %d",
                 rep.replica_id, version)
        return True

    def mark_dead(self, rep: _Replica) -> None:
        """Immediate, probation-less removal — the scale-down/teardown
        path. Failure handling should go through mark_suspect."""
        rep.state = R_DEAD
        self._publish_gauges()

    # ------------------------------------------------------ rolling update
    def rolling_update(self, store, name: str, version: int,
                       timeout: float = 60.0) -> list[str]:
        """Drive a zero-downtime model update across the fleet: for each
        READY replica IN TURN, POST /swap (the replica fetches round-N
        adapters from the artifact store itself and hot-swaps them
        between decode iterations — no restart, no dropped requests),
        then poll /info until it reports `version` before touching the
        next replica. Serializing the fleet bounds the blast radius of a
        bad artifact to one replica; the mixed-version window in between
        is what per-request `model_version` pinning exists for. Returns
        the updated replica_ids; raises on the first replica that fails
        to swap or converge (after marking it SUSPECT)."""
        from ..utils.artifacts import store_spec

        body = json.dumps({"store": store_spec(store), "name": name,
                           "version": int(version)}).encode()
        updated: list[str] = []
        with recorder.span("serving.rolling_update", artifact=name,
                           version=int(version)):
            for rep in list(self.ready_replicas()):
                req = urllib.request.Request(
                    rep.endpoint + "/swap", data=body,
                    headers={"Content-Type": "application/json"})
                try:
                    with urllib.request.urlopen(req, timeout=timeout) as r:
                        got = json.loads(r.read() or b"{}")
                except (urllib.error.URLError, OSError,
                        json.JSONDecodeError) as e:
                    self.mark_suspect(rep)
                    raise RuntimeError(
                        f"rolling update: replica {rep.replica_id} failed "
                        f"to swap to {name!r}: {e}") from e
                if int(got.get("model_version", -1)) != int(version):
                    self.mark_suspect(rep)
                    raise RuntimeError(
                        f"rolling update: replica {rep.replica_id} "
                        f"reports version {got.get('model_version')} after "
                        f"swapping to {version}")
                # verify through the replica's own /info gauge — the swap
                # response could lie; the poll is what the recipe
                # documents operators check
                deadline = time.monotonic() + timeout
                while time.monotonic() < deadline:
                    info = self.replica_info(rep)
                    if info and info.get("model_version") == int(version):
                        rep.model_version = int(version)
                        break
                    time.sleep(0.05)
                else:
                    self.mark_suspect(rep)
                    raise RuntimeError(
                        f"rolling update: replica {rep.replica_id} never "
                        f"reported version {version} on /info")
                updated.append(rep.replica_id)
                _mx.inc("serving.rolling_swaps")
        # record the target only after the whole walk succeeded: a bad
        # artifact that raised above must not be re-driven onto replicas
        # recovering from probation (blast radius stays one replica)
        with self._lock:
            self._adapter_target = (body, int(version))
        _mx.set_gauge("serving.fleet_version", int(version))
        # a replica that recovered from probation DURING the walk
        # converged against the PREVIOUS target and rejoined on old
        # adapters — and the walk's entry snapshot never saw it. Sweep
        # the pool once more under the new target; a straggler that
        # cannot converge goes back through probation.
        for rep in self.ready_replicas():
            if rep.model_version == int(version):
                continue
            if not self._converge_version(rep, (body, int(version))):
                self.mark_suspect(rep)
        return updated

    def converge(self, store, name: str, version: int) -> bool:
        """Idempotent convergence sweep: bring every READY replica AT OR
        ABOVE `version` by re-driving the swap where needed — the tail of
        rolling_update as a standalone verb, for replicas that joined the
        pool OUT OF BAND after the last update walked (the live-loop
        harness's revived replicas, soak/loop.py). Unlike rolling_update
        it never bumps the fleet version and treats already-ahead
        replicas as done, so calling it twice is harmless. Returns True
        when every ready replica reports `version` or newer."""
        from ..utils.artifacts import store_spec

        body = json.dumps({"store": store_spec(store), "name": name,
                           "version": int(version)}).encode()
        ok = True
        for rep in self.ready_replicas():
            if rep.model_version is not None \
                    and rep.model_version >= int(version):
                continue
            ok = self._converge_version(rep, (body, int(version))) and ok
        return ok

    def replica_info(self, rep: _Replica) -> Optional[dict]:
        try:
            with urllib.request.urlopen(rep.endpoint + "/info",
                                        timeout=5) as r:
                return json.loads(r.read() or b"{}")
        except (urllib.error.URLError, OSError, json.JSONDecodeError):
            return None

    def versions(self) -> dict:
        """replica_id -> model_version over the live fleet (/info poll)."""
        out = {}
        for rep in self.ready_replicas():
            info = self.replica_info(rep)
            out[rep.replica_id] = (info or {}).get("model_version")
        return out

    # ------------------------------------------------------------ scaling
    def scale_up(self) -> Optional[_Replica]:
        with self._lock:
            live = [r for r in self.replicas if r.state != R_DEAD]
            if len(live) >= self.max_replicas:
                return None
        if self.master is None:
            return None
        log.info("autoscale: +1 replica")
        return self._dispatch_one()

    def scale_down(self) -> bool:
        ready = self.ready_replicas()
        if len(ready) <= self.min_replicas:
            return False
        rep = ready[-1]
        self.mark_dead(rep)  # drains immediately: routing skips it
        log.info("autoscale: -1 replica (%s)", rep.replica_id)
        if self.master is None:
            return True
        # pin the stop job to the worker hosting the replica — any other
        # worker's active_servers has no such replica_id and the HTTP
        # server would leak for the life of the right worker's process
        req = dict(self.spec.get("requirements", {}))
        req["worker_id"] = rep.worker_id
        self.master.submit({"type": "serve_stop",
                            "replica_id": rep.replica_id,
                            "requirements": req})
        return True

    def reap_and_heal(self) -> None:
        """Replace dead replicas down to min_replicas (the reference gateway
        reports unhealthy endpoints back to the deployment FSM). SUSPECT
        replicas count as live — probation decides their fate; healing
        over them would over-provision every transient stall."""
        if self.master is None:
            return
        with self._lock:
            live = [r for r in self.replicas
                    if r.state in (R_READY, R_SUSPECT, R_DISPATCHED)]
            need = self.min_replicas - len(live)
        for _ in range(max(0, need)):
            self._dispatch_one()


class InferenceGateway:
    """HTTP /predict facade with load-aware failover routing, load
    shedding, SSE stream relay with mid-stream failover, and queue-depth
    autoscaling (reference: device_model_inference.py:32-143).

    `shed_watermark` > 0 arms admission control: once fleet-wide
    in-flight requests exceed `shed_watermark × ready_replicas`, new
    requests are refused with 429 + a Retry-After header (`retry_after_s`)
    instead of queueing toward timeout — overload degrades to fast
    refusal the client can act on. Sheds ride `serving.shed_total`.

    `affinity` arms PREFIX-AFFINITY routing: replicas
    advertise which first-page prefix-cache keys are resident
    (X-Prefix-Digest/X-KV-Page-Size response headers, harvested off
    every successful forward; also on /info). The gateway hashes each
    prompt's leading page-aligned block with the engine's own chain
    hash and PREFERS a replica already holding that page — under a
    many-user Zipf mix this turns N independent prefix caches into one
    fleet-wide cache instead of N-way-diluting every hot prefix. The
    preference composes with (never overrides) the existing discipline:
    shed fires first, SUSPECT/excluded replicas are never preferred
    into, and when no advertiser is routable the pick falls back to
    plain least-loaded. Outcomes ride serving.affinity.{hits,misses,
    fallbacks}, counted once per request at its first placement."""

    def __init__(self, deployment: Deployment, host: str = "127.0.0.1",
                 port: int = 0, high_water: float = 2.0,
                 low_water: float = 0.25, scale_interval: float = 0.5,
                 retry_backoff_s: float = 0.05,
                 shed_watermark: float = 0.0, retry_after_s: float = 1.0,
                 affinity: bool = False):
        self.dep = deployment
        self.affinity = bool(affinity)
        # AtomicCounter (utils/metrics.py): += on the threading server
        # would race and drift the autoscaler's load signal; the gauge is
        # bound so it publishes under the counter's own lock
        self._inflight = _mx.AtomicCounter(gauge="serving.gateway_inflight")
        self.high_water = high_water
        self.low_water = low_water
        self.scale_interval = scale_interval
        self.retry_backoff_s = retry_backoff_s
        self.shed_watermark = float(shed_watermark)
        self.retry_after_s = float(retry_after_s)
        self._stop = threading.Event()
        gateway = self

        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                log.debug("gateway: " + fmt, *args)

            def _send(self, code: int, payload: dict,
                      headers: Optional[dict] = None) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/ready":
                    n = len(gateway.dep.ready_replicas())
                    self._send(200 if n else 503,
                               {"ready_replicas": n})
                elif self.path == "/metrics":
                    # the gateway is the serving tier's scrape point:
                    # inflight/forward/failover gauges + the whole registry
                    from ..utils.prometheus import write_metrics_response

                    write_metrics_response(self)
                else:
                    self._send(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                if self.path != "/predict":
                    self._send(404, {"error": f"no route {self.path}"})
                    return
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                try:
                    # parsed once here, shared with forward_stream — the
                    # hot routing path must not decode the body twice
                    parsed = json.loads(body or b"{}")
                except json.JSONDecodeError:
                    parsed = None    # replicas 400 malformed JSON themselves
                gateway._inflight.inc()
                try:
                    if gateway._overloaded():
                        # overload degrades to FAST refusal the client
                        # can schedule around — never to a request that
                        # queues toward a timeout
                        _mx.inc("serving.shed_total")
                        self._send(
                            429,
                            {"error": "gateway overloaded; retry later",
                             "retry_after_s": gateway.retry_after_s},
                            headers={"Retry-After": str(max(1, math.ceil(
                                gateway.retry_after_s)))})
                        return
                    if isinstance(parsed, dict) and parsed.get("stream"):
                        gateway.forward_stream(body, self, parsed=parsed)
                        return
                    code, payload = gateway.forward(body, parsed=parsed)
                    self._send(code, payload)
                finally:
                    gateway._inflight.dec()

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None
        self._scaler: Optional[threading.Thread] = None

    @property
    def inflight(self) -> int:
        return self._inflight.value()

    def fleet_roster(self) -> dict:
        """{process: /metrics url} for this gateway and every replica it
        knows — the serving tier's contribution to the fleet-observability
        roster (utils/obsfleet.FleetCollector consumes it directly). The
        gateway already knows its replicas' endpoints; a FleetCollector
        pointed here sees the whole serving fleet without extra config."""
        host = self._server.server_address[0]
        roster = {"gateway": f"http://{host}:{self.port}/metrics"}
        with self.dep._lock:
            reps = list(self.dep.replicas)
        for i, rep in enumerate(reps):
            if rep.endpoint:
                name = rep.replica_id or f"replica{i}"
                roster[name] = rep.endpoint.rstrip("/") + "/metrics"
        return roster

    # --------------------------------------------------- admission control
    def _overloaded(self) -> bool:
        """True when fleet-wide depth has crossed the shed watermark.
        Depth counts the CURRENT request too (it was inc'd on entry), so
        watermark W admits exactly W in-flight per ready replica."""
        if not self.shed_watermark:
            return False
        ready = len(self.dep.ready_replicas())
        if not ready:
            return False     # no-replica case stays a 503, not a shed
        return self._inflight.value() > self.shed_watermark * ready

    # ------------------------------------------------- prefix affinity
    def _affinity_prefer(self, parsed,
                         body: bytes) -> Optional[frozenset]:
        """replica_ids advertising THIS prompt's first page as resident,
        or None when affinity routing is off. Hashes the prompt's
        leading page-aligned block with the engine's own chain hash
        (engine._page_key, parent b"\\x00" — the same key the replica's
        prefix cache registered), per distinct advertised page size, so
        the probe can never drift from what replicas actually store. An
        empty frozenset means no routable advertiser (cold prefix,
        prompt shorter than a page, or a non-token request) — the
        caller counts it a miss and routes least-loaded."""
        if not self.affinity:
            return None
        if parsed is None:
            try:
                parsed = json.loads(body or b"{}")
            except json.JSONDecodeError:
                parsed = None
        toks = parsed.get("tokens") if isinstance(parsed, dict) else None
        if not isinstance(toks, list) or not toks:
            return frozenset()
        from .engine import _page_key
        digest: dict = {}        # page_size -> first-page hex digest
        pref = set()
        for rep in self.dep.ready_replicas():
            ps = rep.page_size
            if ps <= 0 or not rep.prefix_digests or len(toks) < ps:
                continue
            if ps not in digest:
                try:
                    digest[ps] = _page_key(b"\x00", toks[:ps]).hex()
                except (TypeError, ValueError, OverflowError):
                    digest[ps] = None    # non-int tokens: replica 400s it
            if digest[ps] is not None \
                    and digest[ps] in rep.prefix_digests:
                pref.add(rep.replica_id)
        return frozenset(pref)

    def _count_affinity(self, rep: _Replica,
                        prefer: Optional[frozenset]) -> None:
        """Outcome counter, called once per request at its FIRST
        placement (retries re-place the same request — counting them
        would double-weight failovers): hit = landed on an advertiser,
        fallback = an advertiser existed but was not routable
        (SUSPECT/excluded/not READY), miss = nothing advertised the
        prefix."""
        if prefer is None:
            return
        if not prefer:
            _mx.inc("serving.affinity.misses")
        elif rep.replica_id in prefer:
            _mx.inc("serving.affinity.hits")
        else:
            _mx.inc("serving.affinity.fallbacks")

    def _note_residency(self, rep: _Replica, headers) -> None:
        """Harvest a replica's residency advert off a successful
        response's X-KV-Page-Size / X-Prefix-Digest headers — the warm
        path keeps the hint fresh without an /info poll per request.
        Whole-set replacement (not a merge): the replica advertises its
        CURRENT resident first pages, and eviction must be able to
        retire stale digests."""
        if not self.affinity:
            return
        try:
            ps = int(headers.get("X-KV-Page-Size") or 0)
        except (TypeError, ValueError):
            return
        if ps <= 0:
            return
        dg = headers.get("X-Prefix-Digest")
        rep.page_size = ps
        rep.prefix_digests = frozenset(
            d for d in (dg or "").split(",") if d)

    # ---------------------------------------------------------- routing
    def forward(self, body: bytes, tries: int = 3,
                parsed: Optional[dict] = None) -> tuple[int, dict]:
        """Least-loaded with failover: a replica that errors at the
        transport level (or 5xx) goes to PROBATION and the request
        retries elsewhere; a 409 (stale version pin) reroutes to a
        sibling without suspecting anyone. With affinity routing on,
        the least-loaded pick is restricted to replicas advertising the
        prompt's first prefix page whenever one is routable. `parsed`
        is the decoded body when do_POST already parsed it."""
        t0 = time.perf_counter()
        try:
            with recorder.span("serving.forward"):
                return self._forward(body, tries, parsed)
        finally:
            _mx.observe("serving.gateway_forward_s",
                        time.perf_counter() - t0)

    def _note_409(self, e, rep, stale: set) -> tuple[int, dict]:
        """A version-pinned request hit a replica not serving the pin:
        healthy, just mid-rolling-update — never suspected. Exclude it
        for this request (an idle stale replica would win least-loaded
        again) and keep its payload for the out-of-tries tail, so the
        409 surfaces only when no replica serves the pin."""
        _mx.inc("serving.gateway_pin_reroutes")
        stale.add(rep.replica_id)
        try:
            return 409, json.loads(e.read() or b"{}")
        except (json.JSONDecodeError, OSError):
            return 409, {"error": "stale model_version"}

    def _forward(self, body: bytes, tries: int,
                 parsed: Optional[dict] = None) -> tuple[int, dict]:
        last_409: Optional[tuple[int, dict]] = None
        stale: set = set()       # replicas that 409'd this request's pin
        prefer = self._affinity_prefer(parsed, body)
        counted = False
        for attempt in range(tries):
            if attempt:
                # short exponential backoff between failover attempts — a
                # recovering/replacement replica needs a beat, and
                # hammering the next pick during a correlated outage just
                # burns the retry budget in microseconds
                time.sleep(self.retry_backoff_s * (2 ** (attempt - 1)))
            rep = self.dep.acquire(exclude=stale, prefer=prefer)
            if rep is None:
                return last_409 or (503, {"error": "no ready replicas"})
            if not counted:
                self._count_affinity(rep, prefer)
                counted = True
            req = urllib.request.Request(
                rep.endpoint + "/predict", data=body,
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=30) as r:
                    self._note_residency(rep, r.headers)
                    return r.status, json.loads(r.read() or b"{}")
            except urllib.error.HTTPError as e:
                if e.code == 409:
                    last_409 = self._note_409(e, rep, stale)
                    continue
                if e.code < 500:
                    # the replica is alive and rejected the request (bad
                    # input): surface the error, don't kill the replica —
                    # a client-side 4xx must never take a healthy replica
                    # out of rotation
                    try:
                        return e.code, json.loads(e.read() or b"{}")
                    except (json.JSONDecodeError, OSError):
                        return e.code, {"error": f"replica returned {e.code}"}
                # 5xx: the replica itself is failing — probation, retry
                # elsewhere (probation re-probes and either returns it to
                # READY or declares it DEAD and heals)
                log.warning("replica %s returned %d; rerouting",
                            rep.replica_id, e.code)
                _mx.inc("serving.gateway_failovers")
                self.dep.mark_suspect(rep)
            except (urllib.error.URLError, OSError, json.JSONDecodeError):
                log.warning("replica %s unreachable; rerouting",
                            rep.replica_id)
                _mx.inc("serving.gateway_failovers")
                self.dep.mark_suspect(rep)
            finally:
                self.dep.release(rep)
        return last_409 or (502, {"error": "all replicas failed"})

    # --------------------------------------------------------- streaming
    def forward_stream(self, body: bytes, handler, tries: int = 3,
                       parsed: Optional[dict] = None) -> None:
        """Relay an SSE stream from a replica to the client, surviving
        replica death mid-response. Failover semantics:

        - DETERMINISTIC requests (greedy: no temperature) are re-served
          from token 0 on a survivor; tokens the client already received
          are skipped AFTER verifying they match the replay, so a
          completed stream is byte-identical to an unkilled run. When
          the replay DIVERGES (the survivor swapped mid-rolling-update
          and decodes different tokens), an UNPINNED stream is recovered
          by a CONTINUATION re-issue — prompt + the delivered tokens,
          remaining budget — which greedily continues the CLIENT's
          prefix under the current fleet, the same semantics an
          in-place hot swap gives unpinned in-flight streams
          (serving.stream_continuations); a version-PINNED stream
          surfaces the divergence as a terminal error instead (the pin
          was the guarantee, and the replay itself is never spliced).
        - NON-REPLAYABLE requests (sampling — rerunning draws different
          tokens, seeded or not: the survivor's slot/seed schedule is
          the engine's, but a half-relayed stream spliced with a rerun
          would interleave two draws) surface a terminal error event
          (code 503) — the client sees a clean failure, never a stream
          that looks complete but isn't.
        Errors before the first relayed byte keep proper status codes.
        `parsed` is the decoded request dict when do_POST already parsed
        the body (one decode on the hot path); direct callers omit it."""
        if parsed is None:
            try:
                parsed = json.loads(body or b"{}")
            except json.JSONDecodeError:
                handler._send(400, {"error": "body must be JSON"})
                return
        try:
            greedy = float(parsed.get("temperature", 0) or 0) <= 0
        except (TypeError, ValueError):
            # the replica's own validation would 400 this on the
            # non-stream path; match it instead of severing the socket
            handler._send(400, {"error": "temperature must be a number; "
                                         f"got {parsed.get('temperature')!r}"})
            return
        delivered: list = []    # token values the CLIENT has, in order
        # client index where the CURRENT upstream request's token 0 lands
        # (> 0 after a divergence-recovery continuation re-issue)
        cur_start = 0
        headers_out = False
        last_409: Optional[tuple[int, dict]] = None
        stale: set = set()      # replicas that 409'd this request's pin
        attempts = 0
        # a divergence-recovery continuation re-issue is FREE: it is not
        # a failed placement (the survivor is healthy and about to serve)
        # so it must neither consume the retry budget nor pay a backoff —
        # otherwise the canonical cut+skew recovery always lands on the
        # last attempt with nothing left for a second fault
        cont_dispatch = False
        # affinity preference from the ORIGINAL prompt: a continuation
        # re-issue extends the same prefix, so the hint stays valid
        prefer = self._affinity_prefer(parsed, body)
        counted = False
        while True:
            if not cont_dispatch:
                if attempts >= tries:
                    break
                attempts += 1
                if attempts > 1:
                    time.sleep(self.retry_backoff_s * (2 ** (attempts - 2)))
            cont_dispatch = False
            rep = self.dep.acquire(exclude=stale, prefer=prefer)
            if rep is None:
                break
            if not counted:
                self._count_affinity(rep, prefer)
                counted = True
            req = urllib.request.Request(
                rep.endpoint + "/predict", data=body,
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=120) as r:
                    self._note_residency(rep, r.headers)
                    for ev in self._sse_events(r):
                        if "token" in ev:
                            # indices are the UPSTREAM request's frame;
                            # delivered[cur_start:] is that frame's
                            # already-relayed prefix
                            local = len(delivered) - cur_start
                            idx = int(ev.get("index", local))
                            if idx < local:
                                # replayed prefix: dedupe — but VERIFY it
                                # matches what the client already has (a
                                # survivor swapped mid-rolling-update
                                # decodes different tokens; splicing the
                                # replay itself would fabricate a
                                # cross-version stream)
                                if ev.get("token") != delivered[
                                        cur_start + idx]:
                                    raise _ReplayDiverged(
                                        f"token {idx} differs on replay")
                                continue
                            if not headers_out:
                                self._open_sse(handler)
                                headers_out = True
                            if cur_start:
                                ev = {**ev, "index": cur_start + idx}
                            self._relay(handler, ev)
                            delivered.append(ev.get("token"))
                        elif ev.get("done"):
                            if not headers_out:
                                self._open_sse(handler)
                                headers_out = True
                            if cur_start and "generated_tokens" in ev:
                                # a continuation's done event only knows
                                # its own suffix; the client's stream is
                                # the whole delivered sequence
                                ev = {**ev,
                                      "generated_tokens": list(delivered)}
                            self._relay(handler, ev)
                            return
                        elif "error" in ev:
                            if ev.get("code") == 409:
                                # pinned stream straddled that replica's
                                # hot swap: replica healthy, just newer —
                                # reroute like the HTTP-level 409
                                raise _StalePin(
                                    ev.get("error", "stale model_version"))
                            # replica-side terminal error event: the
                            # stream is dead on that replica — treat like
                            # a cut (failover if replayable)
                            raise _StreamCut(ev.get("error", "replica error"))
                    # upstream closed without done/error: a cut stream
                    raise _StreamCut("stream ended without done")
            except _ClientGone:
                # OUR client went away, not the replica — no suspect, no
                # retry: nothing downstream can receive another byte
                log.info("client hung up mid-stream (served by %s); "
                         "aborting relay", rep.replica_id)
                _mx.inc("serving.client_disconnects")
                return
            except _ReplayDiverged as e:
                # the survivor is HEALTHY and serves a different model
                # version than the one that produced the client's prefix
                # (a rolling update landed between the cut and the
                # replay) — never suspected either way
                _mx.inc("serving.stream_replay_divergences")
                cont = self._continuation_body(parsed, delivered)
                if cont is not None:
                    # UNPINNED greedy stream: continue the CLIENT's
                    # prefix under the current fleet — re-issue with
                    # prompt + delivered tokens and the remaining
                    # budget. This is exactly what an in-place hot swap
                    # mid-stream already gives unpinned streams (prefix
                    # from the old weights, greedy suffix under the
                    # new), so nothing is fabricated. The live loop's
                    # bar (zero non-2xx through kills DURING rolling
                    # updates) rides this path.
                    log.warning(
                        "stream failover replay diverged via %s (%s); "
                        "continuing the delivered prefix under the "
                        "current fleet", rep.replica_id, e)
                    _mx.inc("serving.stream_continuations")
                    body, done_ev = cont
                    if body is None:
                        # budget already fully delivered — only the
                        # terminal event was lost with the dead replica
                        try:
                            self._relay(handler, done_ev)
                        except (_ClientGone, OSError):
                            pass
                        return
                    cur_start = len(delivered)
                    cont_dispatch = True
                    continue
                # PINNED (the pin WAS the version guarantee) or a body
                # without tokens/budget to rebuild from: clean terminal
                # error, no further retries
                log.warning("stream failover replay diverged via %s: %s",
                            rep.replica_id, e)
                try:
                    if headers_out:
                        self._relay(handler, {
                            "error": "replica lost mid-stream and the "
                                     "failover replay diverged (model "
                                     "version changed?)", "code": 503})
                    else:
                        handler._send(503, {
                            "error": "replica lost mid-stream and the "
                                     "failover replay diverged"})
                except (_ClientGone, OSError):
                    pass
                return
            except _StalePin as e:
                # mid-stream 409 event: the replica swapped under a
                # pinned stream — healthy, never suspected; retry a
                # sibling (greedy replay-verify dedupes any prefix the
                # client already has)
                _mx.inc("serving.gateway_pin_reroutes")
                stale.add(rep.replica_id)
                last_409 = (409, {"error": str(e)})
                continue
            except urllib.error.HTTPError as e:
                if e.code == 409:
                    last_409 = self._note_409(e, rep, stale)
                    continue
                if e.code < 500:
                    try:
                        payload = json.loads(e.read() or b"{}")
                    except (json.JSONDecodeError, OSError):
                        payload = {"error": f"replica returned {e.code}"}
                    try:
                        if headers_out:
                            # a post-failover 4xx after bytes went out:
                            # a second status line would corrupt the open
                            # SSE body — terminal error event instead
                            self._relay(handler,
                                        {"error": payload.get(
                                            "error", f"replica returned "
                                                     f"{e.code}"),
                                         "code": e.code})
                        else:
                            handler._send(e.code, payload)
                    except (_ClientGone, OSError):
                        pass
                    return
                _mx.inc("serving.gateway_failovers")
                self.dep.mark_suspect(rep)
            except (_StreamCut, urllib.error.URLError, OSError,
                    ConnectionError, json.JSONDecodeError) as e:
                log.warning("stream via %s cut: %s; %s", rep.replica_id, e,
                            "re-serving on a survivor"
                            if greedy or not (headers_out or delivered)
                            else "surfacing")
                _mx.inc("serving.gateway_failovers")
                _mx.inc("serving.stream_failovers")
                self.dep.mark_suspect(rep)
                if not greedy and (headers_out or delivered):
                    # non-replayable AND bytes already reached the
                    # client: clean failure, never a fake done. A
                    # sampled stream cut BEFORE its first byte retries
                    # fresh on a survivor — nothing was relayed, so
                    # there is nothing to splice
                    try:
                        if headers_out:
                            self._relay(handler, {
                                "error": "replica lost mid-stream; sampled "
                                         "request is not replayable",
                                "code": 503})
                        else:
                            handler._send(
                                503, {"error": "replica lost mid-stream; "
                                               "sampled request is not "
                                               "replayable"})
                    except (_ClientGone, OSError):
                        pass
                    return
            finally:
                self.dep.release(rep)
        # out of tries / no replicas (a mid-stream pin reroute that ran
        # out of siblings keeps its 409, not a generic 502)
        try:
            if headers_out:
                code, payload = last_409 or (
                    502, {"error": "all replicas failed mid-stream"})
                self._relay(handler,
                            {"error": payload.get("error", "replica error"),
                             "code": code})
            else:
                code, payload = (last_409
                                 or (503, {"error": "no ready replicas"}))
                handler._send(code, payload)
        except (_ClientGone, OSError):
            pass

    @staticmethod
    def _continuation_body(parsed, delivered):
        """Divergence recovery for an UNPINNED stream: (new request
        body, None) to re-issue — prompt grown by the tokens the client
        already has, budget shrunk to the remainder — or (None, done
        event) when the budget was already fully delivered and only the
        terminal event was lost, or None when the stream cannot be
        continued (version-pinned, or no tokens/max_new_tokens fields
        to rebuild from)."""
        toks = parsed.get("tokens")
        mn = parsed.get("max_new_tokens")
        if parsed.get("model_version") is not None \
                or not isinstance(toks, list) \
                or not isinstance(mn, int) or isinstance(mn, bool):
            return None
        remaining = mn - len(delivered)
        if remaining <= 0:
            return None, {"done": True,
                          "generated_tokens": list(delivered)}
        return json.dumps({**parsed,
                           "tokens": list(toks) + list(delivered),
                           "max_new_tokens": remaining}).encode(), None

    @staticmethod
    def _open_sse(handler) -> None:
        """Send the SSE response head; a failed write means the CLIENT is
        gone (the replica is not involved) — raised as _ClientGone so the
        relay loop aborts instead of failing over."""
        try:
            handler.send_response(200)
            handler.send_header("Content-Type", "text/event-stream")
            handler.send_header("Cache-Control", "no-cache")
            handler.end_headers()
        except OSError as e:
            raise _ClientGone(str(e)) from e

    @staticmethod
    def _relay(handler, ev: dict) -> None:
        try:
            handler.wfile.write(b"data: " + json.dumps(ev).encode()
                                + b"\n\n")
            handler.wfile.flush()
        except OSError as e:
            raise _ClientGone(str(e)) from e

    @staticmethod
    def _sse_events(resp):
        """Incremental SSE parse: yield each `data: {...}` event as a
        dict the moment its blank-line terminator arrives."""
        buf = b""
        while True:
            chunk = resp.readline()
            if not chunk:
                return
            buf += chunk
            if not buf.endswith(b"\n"):
                continue
            line = buf.strip()
            buf = b""
            if not line or not line.startswith(b"data:"):
                continue
            try:
                yield json.loads(line[len(b"data:"):].strip())
            except json.JSONDecodeError:
                continue

    # ------------------------------------------------------- autoscaling
    def _scale_loop(self) -> None:
        while not self._stop.wait(self.scale_interval):
            ready = len(self.dep.ready_replicas())
            load = self._inflight.value()
            if ready == 0:
                self.dep.reap_and_heal()
            elif load / ready > self.high_water:
                self.dep.scale_up()
            elif load / ready < self.low_water:
                self.dep.scale_down()

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "InferenceGateway":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()
        self._scaler = threading.Thread(target=self._scale_loop, daemon=True)
        self._scaler.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
