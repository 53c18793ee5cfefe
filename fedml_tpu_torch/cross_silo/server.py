"""Cross-silo FL server, the message-driven FSM (port of
`fedml_tpu/cross_silo/server.py`; reference:
cross_silo/server/fedml_server_manager.py:82-246 and
server/fedml_aggregator.py:13-104).

Aggregation runs on the card: the received numpy trees, sorted by client
id, are stacked there and merged by `ops/tree.py:tree_weighted_mean`, the
weights being the clients' sample counts, and the result comes back to the
host as a numpy tree. Sorting by id makes the aggregate independent of the
order in which the clients' threads finish. The JAX aggregator's
`aggregate_fn` is not ported: its one caller is the hierarchical scenario
(ROADMAP 'Port queue' item 4).

Each round leaves one `round` span in the span recorder, from its
broadcast to its close (aggregate, eval and checkpoint included), with
`round`, `n_received`, `agg_ms` (the aggregate's time, by CUDA events on
the card) and `wire`: the comm backend's bytes and frames sent and
serialise / deserialise seconds in this process during the round
(`comm.<backend>.*` in `utils/metrics.py`; where the silos share the
server's process, as in the one-process federations, their wire work is
counted too).

Beyond the reference, as in the JAX package:

- `round_timeout` + `quorum_frac` close a round on a quorum after a
  deadline; below quorum the timer re-arms at most `max_rearms` times,
  then the run fails loudly (`error`, `fed.server.quorum_unreachable`).
- Checkpoint / restore at round boundaries through the port's
  `utils/checkpoint.py` (params, and the JSON-able FSM state in
  meta["extra"]); `resume=True` restarts at round N+1 with the generation
  bumped. A Simulator-written checkpoint restores its `params` subtree.
- Generation fencing: every S2C / C2S training message carries the run
  generation, so a pre-restart straggler whose round echo equals the live
  round is dropped.
- Client re-attach: a CONNECTION_IS_READY after initialisation re-runs the
  status handshake for that client and re-sends its round's payload.
- Liveness eviction: a client silent for `liveness_timeout_s` leaves the
  selection pool until it is heard from again.

The JAX server also publishes each round's model to the mlops artifact
store (`mlops.log_aggregated_model_info`); the port has no artifact store
(ROADMAP 'Port queue' item 5), and `init` and `FedMLRunner` refuse its
config keys (`tracking_args.artifact_store` / `artifact_dir`).
"""
from __future__ import annotations

import logging
import math
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..comm import FedCommManager, Message
from ..ops import tree as tu
from ..utils import metrics as _mx
from ..utils.events import Span, recorder
from . import message_define as md
from .trainer import to_host

Pytree = Any
log = logging.getLogger(__name__)


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))


def _wire_totals(backend: str) -> dict:
    """This process's wire work so far on `backend`: bytes and frames
    sent, serialise and deserialise seconds (summed over threads)."""
    snap = _mx.snapshot()
    c, h = snap["counters"], snap["histograms"]
    pre = f"comm.{backend}."
    return {"bytes_sent": c.get(pre + "bytes_sent", 0),
            "frames_sent": c.get(pre + "msgs_sent", 0),
            "serialize_s": h.get(pre + "serialize_s", {}).get("sum", 0.0),
            "deserialize_s": h.get(pre + "deserialize_s", {}).get("sum", 0.0)}


class FedAggregator:
    """Result pool + merge (reference: server/fedml_aggregator.py:13-104),
    the merge on `device`. `last_ms` is the last aggregate's time: CUDA
    events on the card, the host clock on the CPU."""

    def __init__(self, device=None):
        self.results: dict[int, tuple[Pytree, float]] = {}
        self.expected: set[int] = set()
        self.device = resolve_device(device)
        self.last_ms: Optional[float] = None

    def reset(self, client_ids) -> None:
        self.results.clear()
        self.expected = set(client_ids)

    def add_local_trained_result(self, client_id: int, params: Pytree,
                                 n_samples: float) -> None:
        self.results[client_id] = (params, n_samples)

    def check_whether_all_receive(self) -> bool:
        return self.expected.issubset(self.results)

    def aggregate(self) -> Pytree:
        cuda = self.device.type == "cuda"
        with recorder.span("agg", n=len(self.results)):
            if cuda:
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
            t0 = time.perf_counter()
            ids = sorted(self.results)
            stacked = tu.tree_stack([
                tu.tree_map(lambda a: _as_tensor(a).to(self.device),
                            self.results[i][0]) for i in ids])
            weights = torch.tensor([self.results[i][1] for i in ids],
                                   dtype=torch.float32, device=self.device)
            agg = tu.tree_weighted_mean(stacked, weights)
            out, _ = to_host(agg, torch.zeros(0, device=self.device))
            if cuda:
                end.record()
                end.synchronize()
                self.last_ms = start.elapsed_time(end)
            else:
                self.last_ms = (time.perf_counter() - t0) * 1e3
            return out


class FedServerManager:
    """(reference: FedMLServerManager, fedml_server_manager.py:22-246)

    round_timeout: seconds to wait for selected clients before attempting a
    partial aggregate. None (default) = reference behavior, wait forever.
    quorum_frac: fraction of selected clients that must have reported for a
    timed-out round to close (ceil; at least 1). Below quorum the timer
    re-arms, at most `max_rearms` times — then the run FAILS loudly
    (`self.error` set, `fed.server.quorum_unreachable` counted, clients
    released) instead of hanging forever. Dropped clients stay selectable
    and rejoin later rounds.
    postprocess_agg_fn: (params, round_idx) -> params applied after
    aggregation — the on_after_aggregation hook site (reference:
    core/alg_frame/server_aggregator.py:79-83; central-DP noise lands here).

    Durability knobs (module docstring):
    checkpoint_dir / checkpoint_every / checkpoint_keep — round-boundary
    checkpoints through utils/checkpoint.py (every N completed rounds plus
    the final one). resume=True loads the latest checkpoint at construction
    and restarts at round N+1 with generation bumped.
    liveness_timeout_s — evict clients silent for this long from selection
    (arm it alongside client heartbeats shorter than the budget).
    device — where the aggregate runs (None: CUDA, raising without a GPU).
    Parameters on the wire and in `params` are numpy trees.
    """

    def __init__(self, comm: FedCommManager, client_ids: list[int],
                 init_params: Pytree, num_rounds: int,
                 eval_fn: Optional[Callable[[Pytree, int], dict]] = None,
                 client_num_per_round: Optional[int] = None,
                 sample_seed: int = 0,
                 round_timeout: Optional[float] = None,
                 quorum_frac: float = 1.0,
                 postprocess_agg_fn: Optional[Callable] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 1,
                 checkpoint_keep: Optional[int] = 3,
                 resume: bool = False,
                 liveness_timeout_s: Optional[float] = None,
                 max_rearms: int = 5, device=None):
        self.comm = comm
        self.client_ids = list(client_ids)
        self.m = client_num_per_round or len(self.client_ids)
        self.params = init_params
        self.num_rounds = num_rounds
        self.round_idx = 0
        self.aggregator = FedAggregator(device)
        self.eval_fn = eval_fn
        self.sample_seed = sample_seed
        self.round_timeout = round_timeout
        self.quorum_frac = float(quorum_frac)
        self.postprocess_agg_fn = postprocess_agg_fn
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = int(checkpoint_every)
        self.checkpoint_keep = checkpoint_keep
        self.liveness_timeout_s = liveness_timeout_s
        self.max_rearms = int(max_rearms)
        # tri-state liveness: absent = never heard from (selectable — round 0
        # has no information yet), True = online, False = evicted. Only an
        # explicit False is excluded from selection.
        self.client_online: dict[int, bool] = {}
        self.last_seen: dict[int, float] = {}
        self.generation = 0          # incarnation index; bumped per resume
        self.is_initialized = False
        self.done = threading.Event()
        self.error: Optional[str] = None
        self.history: list[dict] = []
        self.dropped_log: list[tuple[int, list[int]]] = []  # (round, dropped ids)
        self.round_clients: list[int] = []
        self._synced: set[int] = set()   # sent the CURRENT round's payload
        self._resumed = False
        self._rearm_count = 0
        self._lock = threading.Lock()
        self._timer: Optional[threading.Timer] = None
        self._liveness_timer: Optional[threading.Timer] = None
        self._liveness_ref = time.monotonic()
        self._round_start: Optional[tuple] = None   # (t, wire totals)

        comm.register_message_receive_handler(
            md.CONNECTION_IS_READY, self._on_connection_ready)
        comm.register_message_receive_handler(
            md.C2S_CLIENT_STATUS, self._on_client_status)
        comm.register_message_receive_handler(
            md.C2S_SEND_MODEL, self._on_model_from_client)
        comm.register_message_receive_handler(
            md.C2S_HEARTBEAT, self._on_heartbeat)
        # clients ack S2C_FINISH with C2S_FINISHED; an unregistered type
        # raises in the receive loop, so the ack gets a no-op handler (the
        # ack races the stop sentinel, especially over gRPC)
        comm.register_message_receive_handler(
            md.C2S_FINISHED, lambda _msg: None)

        if resume and checkpoint_dir is not None:
            from ..utils.checkpoint import latest_round

            if latest_round(checkpoint_dir) is not None:
                self._restore(checkpoint_dir)
            else:
                log.info("resume requested but no checkpoints under %r — "
                         "starting fresh", checkpoint_dir)

    # --- selection (reference: fedml_aggregator.client_selection — seeded by
    # round, matching fedavg_api.py:127-135)
    def _select_clients(self, round_idx: int) -> list[int]:
        # exclude only clients the liveness sweep has explicitly EVICTED
        # (client_online[c] is False); never-seen clients stay selectable so
        # round 0 — before any status arrives — draws from the full list.
        # When eviction shrinks the pool below m, run the round over the
        # survivors rather than padding with known-dead clients (each dead
        # draftee used to cost a full round_timeout every round).
        pool = [c for c in self.client_ids
                if self.client_online.get(c, True) is not False]
        if not pool:
            pool = list(self.client_ids)   # everyone evicted: last resort
        if self.m >= len(pool):
            return sorted(pool)
        rng = np.random.RandomState(self.sample_seed + round_idx)
        return sorted(rng.choice(pool, self.m, replace=False).tolist())

    # ------------------------------------------------------------- liveness
    def _mark_alive(self, cid: int) -> None:
        """Caller holds the lock. Any C2S traffic refreshes liveness; a
        previously-evicted client re-enters the pool here."""
        if cid not in self.client_ids:
            return
        self.last_seen[cid] = time.monotonic()
        was = self.client_online.get(cid)
        self.client_online[cid] = True
        if was is False:
            _mx.inc("fed.server.rejoins")
            log.info("client %d recovered — back in the selection pool", cid)
        self._publish_liveness()
        if self.is_initialized:
            self._maybe_send_round(cid)

    def _publish_liveness(self) -> None:
        _mx.set_gauge("fed.server.clients_online",
                      sum(1 for v in self.client_online.values() if v))
        _mx.set_gauge("fed.server.clients_total", len(self.client_ids))

    def _arm_liveness(self) -> None:
        if self.liveness_timeout_s is None or self.done.is_set():
            return
        t = threading.Timer(max(self.liveness_timeout_s / 2.0, 0.05),
                            self._liveness_sweep)
        t.daemon = True
        t.start()
        self._liveness_timer = t

    def _liveness_sweep(self) -> None:
        try:
            with self._lock:
                if self.done.is_set():
                    return
                now = time.monotonic()
                for cid in self.client_ids:
                    ref = self.last_seen.get(cid, self._liveness_ref)
                    if self.client_online.get(cid) is not False \
                            and now - ref > self.liveness_timeout_s:
                        self.client_online[cid] = False
                        _mx.inc("fed.server.evicted")
                        log.warning(
                            "client %d silent for %.1fs (> "
                            "liveness_timeout_s=%.1fs) — evicted from "
                            "selection", cid, now - ref,
                            self.liveness_timeout_s)
                self._publish_liveness()
                if not self.is_initialized:
                    # the init handshake may be blocked on an evicted
                    # draftee: re-select round 0 over survivors, re-check
                    self.round_clients = self._select_clients(0)
                    self._maybe_init()
        except Exception:  # noqa: BLE001 — one bad sweep must not end
            log.exception("liveness sweep failed (chain continues)")
        # re-arm OUTSIDE the guarded body: an exception above must not
        # silently kill the whole liveness chain (_arm_liveness itself
        # no-ops once done is set)
        self._arm_liveness()

    # ------------------------------------------------------------- handlers
    def _on_connection_ready(self, msg: Message) -> None:
        if self.is_initialized:
            # re-attach (restarted client, or any client after a server
            # resume): re-run the status handshake for the SENDER; its
            # status reply re-registers it online and pulls the current
            # round's payload if it is selected and missing
            _mx.inc("fed.server.reattach_announces")
            self.comm.send_message(
                Message(md.S2C_CHECK_CLIENT_STATUS, 0, msg.sender_id))
            return
        self.round_clients = self._select_clients(0)
        # status-check EVERY client, not just round 0's selection — clients
        # selected in later rounds must be registered online too (the round-1
        # weakness: unselected clients never got a check)
        for cid in self.client_ids:
            self.comm.send_message(
                Message(md.S2C_CHECK_CLIENT_STATUS, 0, cid))

    def _on_client_status(self, msg: Message) -> None:
        status = msg.get(md.KEY_STATUS)
        if status == md.STATUS_FINISHED:
            return
        with self._lock:
            self._mark_alive(msg.sender_id)
            self._maybe_init()

    def _on_heartbeat(self, msg: Message) -> None:
        with self._lock:
            self._mark_alive(msg.sender_id)

    def _maybe_init(self) -> None:
        """Caller holds the lock."""
        if self.is_initialized or not self.round_clients:
            return
        if all(self.client_online.get(c, False) for c in self.round_clients):
            self.is_initialized = True
            self._send_init()

    def _stamp(self, m: Message) -> Message:
        m.add(md.KEY_MODEL_PARAMS, self.params)
        m.add(md.KEY_ROUND, self.round_idx)
        m.add(md.KEY_GENERATION, self.generation)
        return m

    def _send_init(self) -> None:
        self.aggregator.reset(self.round_clients)
        self._broadcast_round()
        self._arm_timer()

    def _broadcast_round(self) -> None:
        """Caller holds the lock (or is pre-run single-threaded). Sends the
        current round's payload to every selected client and records them
        as synced (rejoin re-sends go through _maybe_send_round)."""
        self._mark_round_start()
        self._synced = set()
        mtype = md.S2C_INIT_CONFIG if self.round_idx == 0 \
            else md.S2C_SYNC_MODEL
        for cid in self.round_clients:
            self.comm.send_message(self._stamp(Message(mtype, 0, cid)))
            self._synced.add(cid)

    def _maybe_send_round(self, cid: int) -> None:
        """Caller holds the lock. Re-send the in-flight round's payload to a
        (re)joined client that is selected, missing, and not yet served —
        the rejoin half of crash recovery: a restarted client (or every
        client, after a server restart) pulls its work back instead of
        waiting out the round."""
        if self.done.is_set() or cid not in self.aggregator.expected \
                or cid in self.aggregator.results or cid in self._synced:
            return
        mtype = md.S2C_INIT_CONFIG if self.round_idx == 0 \
            else md.S2C_SYNC_MODEL
        self.comm.send_message(self._stamp(Message(mtype, 0, cid)))
        self._synced.add(cid)
        _mx.inc("fed.server.rejoin_syncs")

    # ------------------------------------------------------ dropout handling
    def _arm_timer(self) -> None:
        if self.round_timeout is None:
            return
        self._cancel_timer()
        # bind the timer to the round it guards: a timer that fires while its
        # round completes would otherwise run against the NEXT round's state
        # (cancel() is a no-op on an already-fired Timer)
        t = threading.Timer(
            self.round_timeout, self._on_round_timeout, args=(self.round_idx,))
        t.daemon = True
        t.start()
        self._timer = t

    def _cancel_timer(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    def _quorum(self) -> int:
        n = len(self.aggregator.expected)
        return max(1, math.ceil(self.quorum_frac * n))

    def _on_round_timeout(self, armed_round: int) -> None:
        with self._lock:
            if self.done.is_set() or armed_round != self.round_idx:
                return  # stale timer from an already-completed round
            received = len(self.aggregator.results)
            if received >= self._quorum():
                dropped = sorted(self.aggregator.expected
                                 - set(self.aggregator.results))
                if dropped:
                    log.warning("round %d: aggregating %d/%d, dropped %s",
                                self.round_idx, received,
                                len(self.aggregator.expected), dropped)
                    self.dropped_log.append((self.round_idx, dropped))
                self._complete_round()
            else:
                # below quorum: re-arm, but BOUNDED (the reference waits
                # forever; an unreachable quorum must fail the run loudly,
                # not hang it silently)
                self._rearm_count += 1
                if self._rearm_count > self.max_rearms:
                    _mx.inc("fed.server.quorum_unreachable")
                    self._fail(
                        f"round {self.round_idx}: {received} received < "
                        f"quorum {self._quorum()} after {self.max_rearms} "
                        f"timeouts of {self.round_timeout}s — quorum "
                        "unreachable")
                    return
                log.warning("round %d: %d received < quorum %d — re-arming "
                            "(%d/%d)", self.round_idx, received,
                            self._quorum(), self._rearm_count,
                            self.max_rearms)
                self._arm_timer()

    def _fail(self, reason: str) -> None:
        """Caller holds the lock. Record the error and release everyone —
        clients get a FINISH so they exit instead of waiting on a server
        that has declared the run dead."""
        log.error("cross-silo run failed: %s", reason)
        self.error = reason
        self._finish()

    def _on_model_from_client(self, msg: Message) -> None:
        with self._lock:
            # generation fence FIRST: a straggler from a previous server
            # incarnation may echo the CURRENT round index (a resumed server
            # re-runs the round that was in flight when it died) — the round
            # echo alone cannot tell it apart
            gen = msg.get(md.KEY_GENERATION)
            if int(gen or 0) != self.generation:
                _mx.inc("fed.server.stale_gen_rejected")
                log.warning(
                    "dropping C2S_SEND_MODEL from %s: generation %s != "
                    "current %d (pre-restart straggler)", msg.sender_id,
                    gen, self.generation)
                return
            # a straggler's model from a closed round must not leak into the
            # current one — clients echo the round index they trained on;
            # a missing echo is rejected rather than assumed current (a
            # defaulted value would bypass exactly this guard)
            msg_round = msg.get(md.KEY_ROUND)
            if msg_round is None:
                log.warning("dropping C2S_SEND_MODEL from %s without %s",
                            msg.sender_id, md.KEY_ROUND)
                return
            self._mark_alive(msg.sender_id)
            if int(msg_round) != self.round_idx or \
                    msg.sender_id not in self.aggregator.expected:
                return
            self.aggregator.add_local_trained_result(
                msg.sender_id, msg.get(md.KEY_MODEL_PARAMS),
                float(msg.get(md.KEY_NUM_SAMPLES, 1.0)),
            )
            if not self.aggregator.check_whether_all_receive():
                return
            self._complete_round()

    def _complete_round(self) -> None:
        """Aggregate what's in the pool and advance. Caller holds the lock."""
        self._cancel_timer()
        self._rearm_count = 0
        self.params = self.aggregator.aggregate()
        if self.postprocess_agg_fn is not None:
            self.params = self.postprocess_agg_fn(self.params, self.round_idx)
        row = {"round": self.round_idx,
               "n_received": len(self.aggregator.results)}
        if self.eval_fn is not None:
            row.update(self.eval_fn(self.params, self.round_idx))
        self.history.append(row)
        recorder.log(row)
        _mx.set_gauge("fed.round", self.round_idx)
        if self._ckpt_due(self.round_idx):
            self._save_checkpoint(self.round_idx)
        self._record_round_span(row["n_received"])
        self.round_idx += 1
        if self.round_idx >= self.num_rounds:
            self._finish()
            return
        self.round_clients = self._select_clients(self.round_idx)
        self.aggregator.reset(self.round_clients)
        self._broadcast_round()
        self._arm_timer()

    def _mark_round_start(self) -> None:
        self._round_start = (time.perf_counter(),
                             _wire_totals(self.comm.backend))

    def _record_round_span(self, n_received: int) -> None:
        """Caller holds the lock: the closing round's `round` span (module
        docstring)."""
        if self._round_start is None:
            return
        t0, w0 = self._round_start
        w1 = _wire_totals(self.comm.backend)
        recorder.record(Span(
            "round", t0, time.perf_counter(),
            {"round": self.round_idx, "n_received": n_received,
             "agg_ms": self.aggregator.last_ms,
             "wire": {k: w1[k] - w0[k] for k in w1}}))
        self._round_start = None

    # ---------------------------------------------------- checkpoint/restore
    def _ckpt_due(self, r: int) -> bool:
        return self.checkpoint_dir is not None and self.checkpoint_every and (
            (r + 1) % self.checkpoint_every == 0 or r == self.num_rounds - 1)

    def _save_checkpoint(self, r: int) -> None:
        """Caller holds the lock. Round-boundary write: params + the
        JSON-able FSM state (meta["extra"]). Degrade, don't die — a full
        disk must not kill a healthy federation."""
        from ..utils import checkpoint as ckpt

        extra = {
            "kind": "cross_silo_server",
            "generation": self.generation,
            "sample_seed": self.sample_seed,
            "num_rounds": self.num_rounds,
            "client_ids": list(self.client_ids),
            "client_online": {str(c): bool(v)
                              for c, v in self.client_online.items()},
            "dropped_log": [[rr, list(ids)] for rr, ids in self.dropped_log],
        }
        try:
            with recorder.span("silo.checkpoint", round=r):
                ckpt.save_checkpoint(
                    self.checkpoint_dir, r,
                    {"params": tu.tree_map(_as_tensor, self.params)},
                    history=self.history, keep=self.checkpoint_keep,
                    extra=extra)
            _mx.inc("fed.server.checkpoints")
        except Exception as e:  # noqa: BLE001 — durability must not kill runs
            _mx.inc("fed.server.checkpoint_errors")
            log.warning("round-%d checkpoint to %r failed (continuing): "
                        "%s: %s", r, self.checkpoint_dir,
                        type(e).__name__, e)

    def _restore(self, path: str) -> None:
        """Load the latest checkpoint and resume at round N+1 with the
        generation bumped. Liveness is NOT trusted across a restart — the
        table keeps only its keys' identities via the re-run status
        handshake (every client re-registers before it gets work)."""
        from ..utils import checkpoint as ckpt

        # pin ONE round for both the meta read and the tensor restore: a
        # dying incarnation's in-flight checkpoint write landing between
        # the two would otherwise pair round N's liveness/generation state
        # with round N+1's params
        r = ckpt.latest_round(path)
        template = tu.tree_map(_as_tensor, self.params)
        meta = ckpt.read_meta(path, r)
        extra = meta.get("extra") or {}
        try:
            _r, server, _c, _h, hist = ckpt.restore_checkpoint(
                path, {"params": template}, round_idx=r)
            params = server["params"]
        except ckpt.CheckpointStructureError:
            # cross-runtime compatibility: a Simulator-written checkpoint
            # stores the full ServerState (params/opt_state/round/extra);
            # the server path needs only its params subtree
            raw = ckpt.restore_raw(path, round_idx=r)
            if not (isinstance(raw, dict) and "params" in raw):
                raise ckpt.CheckpointStructureError(
                    f"checkpoint under {path!r} has no 'params' subtree "
                    f"(top-level keys: {sorted(raw) if isinstance(raw, dict) else type(raw).__name__}) "
                    "— not restorable into the cross-silo server")
            try:
                ckpt.check_structure(path, "params", raw["params"], template)
                params = raw["params"]
            except ckpt.CheckpointStructureError as e:
                raise ckpt.CheckpointStructureError(
                    f"checkpoint 'params' under {path!r} does not match "
                    f"this server's model: {type(e).__name__}: "
                    f"{str(e)[:200]}") from e
            hist = meta.get("history", [])
        self.params = tu.tree_map(lambda t: t.numpy(), params)
        self.history = list(hist)
        self.round_idx = int(meta["round"]) + 1
        self.generation = int(extra.get("generation", 0)) + 1
        if "sample_seed" in extra:
            self.sample_seed = int(extra["sample_seed"])
        self.dropped_log = [(int(rr), list(ids))
                            for rr, ids in extra.get("dropped_log", [])]
        # keys only: every client must re-register through the handshake
        self.client_online = {}
        self.last_seen = {}
        self.is_initialized = True
        self._resumed = True
        if self.round_idx < self.num_rounds:
            self.round_clients = self._select_clients(self.round_idx)
        else:
            self.round_clients = []
        self.aggregator.reset(self.round_clients)
        self._synced = set()
        _mx.inc("fed.server.resumes")
        _mx.set_gauge("fed.server.generation", self.generation)
        _mx.set_gauge("fed.round", self.round_idx)
        log.info("resumed from %r: %d rounds done, continuing at round %d "
                 "as generation %d", path, len(self.history), self.round_idx,
                 self.generation)

    # ------------------------------------------------------------- shutdown
    def _finish(self) -> None:
        self._cancel_timer()
        if self._liveness_timer is not None:
            self._liveness_timer.cancel()
        for cid in self.client_ids:
            try:
                self.comm.send_message(
                    Message(md.S2C_FINISH, 0, cid)
                    .add(md.KEY_GENERATION, self.generation))
            except Exception:  # noqa: BLE001 — dead clients may be
                log.debug("S2C_FINISH to %s failed", cid, exc_info=True)
        self.done.set()
        # callers hold self._lock; comm.stop() joins the receive thread, which
        # may itself be blocked on the lock in a handler — stop from a fresh
        # thread so the join can't deadlock/stall against our lock
        threading.Thread(target=self.comm.stop, daemon=True).start()

    def run(self, background: bool = False) -> None:
        self._liveness_ref = time.monotonic()
        self._arm_liveness()
        if self._resumed and not self.done.is_set():
            if self.round_idx >= self.num_rounds:
                # checkpoint already covers the whole run: release clients
                with self._lock:
                    self._finish()
            else:
                # the resumed server INITIATES the re-handshake: clients
                # that survived the crash are idle in their receive loops
                # and (absent an optional watchdog) would never announce
                # on their own — recovery must not depend on client-side
                # knobs being set
                with self._lock:
                    self._mark_round_start()
                for cid in self.client_ids:
                    self.comm.send_message(
                        Message(md.S2C_CHECK_CLIENT_STATUS, 0, cid))
                if self.round_timeout is not None:
                    # guard the reconnect window the same way a live round
                    # is guarded: quorum math + bounded re-arms
                    self._arm_timer()
        self.comm.run(background=background)
        if not background and self.error:
            raise RuntimeError(self.error)
