"""Cross-silo secure aggregation over the message layer (port of
`fedml_tpu/cross_silo/secagg_manager.py`; reference:
cross_silo/secagg/sa_fedml_server_manager.py, sa_fedml_client_manager.py).
The same protocol, driving `mpc/secagg.py`:

  setup (once):  C2S_SA_PK (+ n_i) → S2C_SA_PKS (+ weight norm) →
                 C2S_SA_SHARES (encrypted-to-holder, routed and discarded)
                 → S2C_SA_SHARES (+ initial model, starts round 0)
  per round:     train → C2S_SA_MASKED (masked, normalised-weighted params)
                 all received → S2C_SA_UNMASK_REQ(survivors) →
                 C2S_SA_UNMASK (b-shares of survivors) → unmask → next round
  dropout:       round_timeout fires → S2C_SA_UNMASK_REQ(survivors, dropped)
                 → C2S_SA_UNMASK (b-shares of survivors + sk-shares of the
                 dropped) → reconstruct sk_j → strip its pairwise masks →
                 next round; a dropped client stays out of later rounds and
                 its pairwise masks are stripped every round after.

The server never holds share material: routed setup shares are encrypted
to their holder (`mpc.secagg.encrypt_share`) and deleted right after
forwarding, and the b-shares it needs to strip self-masks are collected
fresh from t+1 survivors every round.

Weighted mean under masking: clients mask quantize(params * n_i / N), with
N = sum(n_i) broadcast with the pk list and n_i sent in the clear; the
server divides the unmasked sum by sum(n_i) / N. `SecAggClient.mask`
refuses a vector that would overflow the field's budget.

The flat vector: the port's parameters are a flat dict with OIHW conv
kernels, the JAX package's a nested flax tree with HWIO ones.
`flatten_params` orders the leaves by the tuple of their name's segments
(flax's nesting, each level's keys sorted as strings) and gives conv
kernels in HWIO, so its vector is bitwise the JAX function's for the same
model and the PRG masks cover the same coordinates; `unflatten_params`
undoes both.

Host work, as in the JAX package: the masks, the unmask and the weighted
division run in numpy on the host; the clients train through the port's
`SiloTrainer` on the card. Readings: the server records one `round` span
a round (its broadcast to its close: `round`, `n_received`, `unmask_ms`
and the comm backend's `wire` work in this process, as the plain
server's) and a `secagg_unmask` span; each client a `sa_train` span and a
`sa_mask` span a round.

SECURITY SCOPE: `mpc/secagg.py`'s simulation-grade primitives (DH over the
field prime, a non-cryptographic PRG).
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..comm import FedCommManager, Message
from ..mpc.secagg import (
    SecAggClient, SecAggServer, decrypt_share, encrypt_share,
)
from ..utils.events import Span, recorder
from . import message_define as md
from .server import _wire_totals
from .trainer import SiloTrainer

Pytree = Any
log = logging.getLogger(__name__)


def _flax_order(params: dict) -> list:
    """The names of a flat parameter dict in flax's leaf order: by the
    tuple of their "."-separated segments, compared as strings."""
    return sorted(params, key=lambda k: tuple(k.split(".")))


def flatten_params(params: dict) -> np.ndarray:
    """A flat parameter dict -> the f64 vector of the JAX package's
    `flatten_params` for the same model: leaves in flax's order, conv
    kernels (OIHW here) in flax's HWIO."""
    parts = []
    for k in _flax_order(params):
        a = np.asarray(params[k])
        if a.ndim == 4:                  # a conv kernel, OIHW -> HWIO
            a = a.transpose(2, 3, 1, 0)
        parts.append(np.asarray(a, np.float64).reshape(-1))
    return np.concatenate(parts)


def unflatten_params(template: dict, vec: np.ndarray) -> dict:
    """The inverse of flatten_params on `template`'s names and shapes: a
    dict of f32 numpy leaves in the template's order."""
    out, off = {}, 0
    for k in _flax_order(template):
        shape = tuple(np.shape(template[k]))
        n = int(np.prod(shape)) if shape else 1
        leaf = np.asarray(vec[off:off + n], np.float32)
        if len(shape) == 4:
            o, i, h, w = shape
            leaf = leaf.reshape(h, w, i, o).transpose(3, 2, 0, 1)
        out[k] = np.ascontiguousarray(leaf.reshape(shape))
        off += n
    return {k: out[k] for k in template}


class SecAggServerManager:
    """Server FSM (reference: sa_fedml_server_manager.py:65-315).

    round_timeout: as FedServerManager's — after the deadline the round
    closes over the survivors, with mask recovery for the dropped. Without
    it the server waits for every client (the reference's behaviour).
    The server does no device work: the unmask is host numpy."""

    def __init__(self, comm: FedCommManager, client_ids: list[int],
                 init_params: Pytree, num_rounds: int,
                 threshold: Optional[int] = None,
                 eval_fn: Optional[Callable[[Pytree, int], dict]] = None,
                 round_timeout: Optional[float] = None,
                 q_bits: int = 16,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 1,
                 checkpoint_keep: Optional[int] = 3,
                 resume: bool = False):
        self.comm = comm
        self.client_ids = list(client_ids)
        self.n = len(self.client_ids)
        self.t = threshold if threshold is not None else max(1, self.n // 2)
        self.params = init_params
        self.dim = flatten_params(self.params).size
        self.num_rounds = num_rounds
        self.q_bits = q_bits
        self.round_idx = 0
        self.eval_fn = eval_fn
        self.round_timeout = round_timeout
        self.server = SecAggServer(self.n, self.t, self.dim, q_bits=q_bits)

        self.pks: dict[int, int] = {}
        self.client_counts: dict[int, float] = {}   # n_i sent with the pk
        self._pks_broadcast = False
        self.weight_norm = 1.0                      # N = sum(n_i), set at pks
        # transient routing buffer: _route_buf[holder][owner] = ciphertext
        # {"b":..,"sk":..}; deleted right after forwarding — the server must
        # never retain share material (module docstring)
        self._route_buf: Optional[dict[int, dict[int, dict]]] = {
            c: {} for c in client_ids}
        self.masked: dict[int, tuple[np.ndarray, float]] = {}
        self.active: set[int] = set(client_ids)      # not yet dropped
        self.dropped_sk: dict[int, int] = {}         # dropped id -> sk
        self.unmask_b: dict[int, dict[int, np.ndarray]] = {}
        self.unmask_sk: dict[int, dict[int, np.ndarray]] = {}
        self._awaiting_unmask = False
        self.client_online: dict[int, bool] = {}
        self.is_initialized = False
        self.done = threading.Event()
        self.error: Optional[str] = None
        self.history: list[dict] = []
        self.dropped_log: list[tuple[int, list[int]]] = []
        self._lock = threading.Lock()
        self._timer: Optional[threading.Timer] = None
        self._timer_gen = 0
        self._rearm_count = 0
        self.max_rearms = 5   # below-quorum retries before declaring failure
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = int(checkpoint_every)
        self.checkpoint_keep = checkpoint_keep
        self._resumed = False
        self._resume_kicked = False
        self._round_start: Optional[tuple] = None   # (t, wire totals)

        h = comm.register_message_receive_handler
        h(md.CONNECTION_IS_READY, self._on_connection_ready)
        h(md.C2S_CLIENT_STATUS, self._on_client_status)
        h(md.C2S_SA_PK, self._on_pk)
        h(md.C2S_SA_SHARES, self._on_shares)
        h(md.C2S_SA_MASKED, self._on_masked)
        h(md.C2S_SA_UNMASK, self._on_unmask)
        # clients ack S2C_FINISH; an unregistered type is counted and
        # logged by the receive loop, so the ack gets a no-op handler
        h(md.C2S_FINISHED, lambda _msg: None)

        if resume and checkpoint_dir is not None:
            from ..utils.checkpoint import latest_round

            if latest_round(checkpoint_dir) is not None:
                self._restore(checkpoint_dir)
            else:
                log.info("resume requested but no checkpoints under %r — "
                         "starting fresh", checkpoint_dir)

    # ------------------------------------------------------------ handlers
    def _on_connection_ready(self, msg: Message) -> None:
        if self.is_initialized:
            # a restarted server's clients re-announce; re-run the status
            # handshake for the sender so the resume broadcast can fire
            # once everyone is back
            self.comm.send_message(
                Message(md.S2C_CHECK_CLIENT_STATUS, 0, msg.sender_id))
            return
        for cid in self.client_ids:
            self.comm.send_message(
                Message(md.S2C_CHECK_CLIENT_STATUS, 0, cid))

    def _on_client_status(self, msg: Message) -> None:
        if msg.get(md.KEY_STATUS) == md.STATUS_FINISHED:
            return
        with self._lock:
            self.client_online[msg.sender_id] = True
            if not self.is_initialized and all(
                    self.client_online.get(c) for c in self.client_ids):
                self.is_initialized = True
                for cid in self.client_ids:
                    m = Message(md.S2C_INIT_CONFIG, 0, cid)
                    # the server is authoritative for the protocol params:
                    # a silent t / q_bits mismatch would corrupt the
                    # unmasked model, so clients adopt these on init
                    m.add(md.KEY_SA_THRESHOLD, self.t)
                    m.add(md.KEY_SA_QBITS, self.q_bits)
                    self.comm.send_message(m)
                return
            if self._resumed and not self._resume_kicked and all(
                    self.client_online.get(c) for c in self.active):
                # round-boundary resume: the surviving clients still hold
                # their key material (only the server died); restart the
                # in-flight round with a plain model sync — they re-mask
                # with the same round_salt, deterministically
                self._resume_kicked = True
                self._send_round(md.S2C_SYNC_MODEL)

    def _on_pk(self, msg: Message) -> None:
        with self._lock:
            if self._pks_broadcast:
                # a redelivered pk after the broadcast must not trigger a
                # second S2C_SA_PKS: clients would draw fresh Shamir
                # polynomials and a later reconstruction would mix shares
                # of different polynomials into a garbage seed
                return
            self.pks[msg.sender_id] = int(msg.get(md.KEY_SA_PK))
            self.client_counts[msg.sender_id] = float(
                msg.get(md.KEY_NUM_SAMPLES, 1.0))
            if len(self.pks) < self.n:
                return
            self._pks_broadcast = True
            # N = sum(n_i): clients normalise their mask weights by it, so
            # the field budget does not scale with the counts
            self.weight_norm = max(sum(self.client_counts.values()), 1.0)
            pks_wire = {str(c): self.pks[c] for c in self.client_ids}
            for cid in self.client_ids:
                m = Message(md.S2C_SA_PKS, 0, cid)
                m.add(md.KEY_SA_PKS, pks_wire)
                m.add(md.KEY_SA_WEIGHT_NORM, self.weight_norm)
                self.comm.send_message(m)

    def _on_shares(self, msg: Message) -> None:
        """Route each client's encrypted shares to their holders (the
        server is the relay: S2C_OTHER_SS_TO_CLIENT in the reference) and
        drop the ciphertexts right after forwarding."""
        owner = msg.sender_id
        shares = msg.get(md.KEY_SA_SHARES)  # {holder_str: {"b": .., "sk": ..}}
        with self._lock:
            if self._route_buf is None:
                return  # a late duplicate after setup completed
            for holder_s, sh in shares.items():
                self._route_buf[int(holder_s)][owner] = sh
            # n-1 per holder: each client keeps its own share locally
            ready = all(len(self._route_buf[c]) == self.n - 1
                        for c in self.client_ids)
            if not ready:
                return
            # deliver the routed shares and the initial model: training
            # starts
            self._mark_round_start()
            for cid in self.client_ids:
                m = Message(md.S2C_SA_SHARES, 0, cid)
                m.add(md.KEY_SA_SHARES,
                      {str(o): sh for o, sh in self._route_buf[cid].items()})
                m.add(md.KEY_MODEL_PARAMS, self.params)
                m.add(md.KEY_ROUND, self.round_idx)
                self.comm.send_message(m)
            self._route_buf = None  # never retain share material
            self._arm_timer()

    def _on_masked(self, msg: Message) -> None:
        with self._lock:
            if int(msg.get(md.KEY_ROUND, -1)) != self.round_idx:
                return
            # a just-dropped client's late upload must not close the round
            # while unmask shares are being collected — that would advance
            # twice and wipe the model with an empty survivor set
            if msg.sender_id not in self.active or self._awaiting_unmask:
                return
            self.masked[msg.sender_id] = (
                np.asarray(msg.get(md.KEY_SA_MASKED), np.int64),
                float(msg.get(md.KEY_NUM_SAMPLES, 1.0)),
            )
            if set(self.masked) >= self.active:
                self._begin_unmask()

    # ---------------------------------------------------- dropout recovery
    def _arm_timer(self) -> None:
        if self.round_timeout is None:
            return
        self._cancel_timer()
        # a generation counter, not the round index: a stale callback may
        # already wait on the lock when a phase transition (masked complete
        # -> begin_unmask) re-arms within the same round
        t = threading.Timer(self.round_timeout, self._on_timeout,
                            args=(self._timer_gen,))
        t.daemon = True
        t.start()
        self._timer = t

    def _cancel_timer(self) -> None:
        self._timer_gen += 1   # invalidate any in-flight stale callback
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    def _on_timeout(self, gen: int) -> None:
        with self._lock:
            if self.done.is_set() or gen != self._timer_gen:
                return
            if self._awaiting_unmask:
                # survivors' unmask replies never reached t+1: a survivor
                # died between its masked upload and its share reply, and
                # the sum cannot be unmasked (SecAgg's privacy working as
                # intended). Fail loudly rather than hang.
                self._fail(f"round {self.round_idx}: unmask shares "
                           f"({len(self.unmask_b)}) below t+1={self.t + 1}")
                return
            dropped_now = self.active - set(self.masked)
            survivors = sorted(self.active - dropped_now)
            if len(survivors) < self.t + 1:
                self._rearm_count += 1
                if self._rearm_count > self.max_rearms:
                    self._fail(
                        f"round {self.round_idx}: only {len(survivors)} "
                        f"survivors < t+1={self.t + 1} after "
                        f"{self.max_rearms} timeouts — quorum unreachable")
                    return
                log.warning("round %d: %d survivors < t+1=%d — re-arming "
                            "(%d/%d)", self.round_idx, len(survivors),
                            self.t + 1, self._rearm_count, self.max_rearms)
                self._arm_timer()
                return
            self._rearm_count = 0
            if not dropped_now:
                return
            log.warning("round %d: dropping %s", self.round_idx,
                        sorted(dropped_now))
            self.dropped_log.append((self.round_idx, sorted(dropped_now)))
            self.active -= dropped_now
            self._begin_unmask(dropped_now)

    def _fail(self, reason: str) -> None:
        """Caller holds the lock. Record the error and shut down."""
        log.error("secagg run failed: %s", reason)
        self.error = reason
        self._finish()

    def _begin_unmask(self, dropped_now: Optional[set] = None) -> None:
        """Caller holds the lock. Every round ends with a fresh collection
        of b-shares from t+1 survivors (the server retains no share
        material); after a dropout the same request also gathers the
        sk-shares of the newly dropped."""
        self._cancel_timer()
        survivors = sorted(self.active & set(self.masked))
        self._awaiting_unmask = True
        self.unmask_b.clear()
        self.unmask_sk.clear()
        need_sk = sorted(j for j in (dropped_now or set())
                         if j not in self.dropped_sk)
        for cid in survivors:
            m = Message(md.S2C_SA_UNMASK_REQ, 0, cid)
            m.add(md.KEY_SA_SURVIVORS, survivors)
            m.add(md.KEY_SA_DROPPED, need_sk)
            self.comm.send_message(m)
        # guard the collection phase: a survivor can die before replying
        self._arm_timer()

    def _on_unmask(self, msg: Message) -> None:
        holder = msg.sender_id
        with self._lock:
            if not self._awaiting_unmask:
                return
            self.unmask_b[holder] = {
                int(o): np.asarray(v, np.int64)
                for o, v in msg.get(md.KEY_SA_B_SHARES, {}).items()}
            self.unmask_sk[holder] = {
                int(o): np.asarray(v, np.int64)
                for o, v in msg.get(md.KEY_SA_SK_SHARES, {}).items()}
            if len(self.unmask_b) >= self.t + 1:
                self._awaiting_unmask = False
                self._unmask_and_advance()

    # ------------------------------------------------------------- rounds
    def _proto(self, cid: int) -> int:
        """Client id -> protocol index 0..n-1. Shamir's evaluation points
        and the +/- pairwise-mask convention run on protocol indices."""
        return self.client_ids.index(cid)

    def _mark_round_start(self) -> None:
        self._round_start = (time.perf_counter(),
                             _wire_totals(self.comm.backend))

    def _send_round(self, mtype: str) -> None:
        """Caller holds the lock. The current round's model to every active
        client, and the round's timer."""
        self._mark_round_start()
        for cid in sorted(self.active):
            m = Message(mtype, 0, cid)
            m.add(md.KEY_MODEL_PARAMS, self.params)
            m.add(md.KEY_ROUND, self.round_idx)
            self.comm.send_message(m)
        self._arm_timer()

    def _unmask_and_advance(self) -> None:
        """Caller holds the lock. Unmask the survivors' sum (b-shares
        freshly collected from survivors: _begin_unmask) and advance."""
        self._cancel_timer()
        survivors = sorted(self.masked)
        pr = self._proto
        b_shares = {pr(h): {pr(o): sh for o, sh in shares.items()}
                    for h, shares in self.unmask_b.items()}
        # reconstruct the newly dropped clients' sk from survivor shares
        per_owner: dict[int, dict[int, np.ndarray]] = {}
        for holder, shares in self.unmask_sk.items():
            for owner, sh in shares.items():
                per_owner.setdefault(owner, {})[pr(holder)] = sh
        for owner, shs in per_owner.items():
            if len(shs) >= self.t + 1:
                self.dropped_sk[owner] = SecAggServer.reconstruct_sk(
                    dict(sorted(shs.items())[: self.t + 1]))
        pair_seeds = {
            pr(j): {pr(i): SecAggServer.pairwise_seed(sk, self.pks[i])
                    for i in survivors}
            for j, sk in self.dropped_sk.items()}

        with recorder.span("secagg_unmask", round=self.round_idx) as sp:
            total = self.server.aggregate(
                {pr(i): y for i, (y, _n) in self.masked.items()},
                b_shares, pair_seeds, round_salt=self.round_idx)
        # clients masked params * (n_i / N): divide by sum(n_i) / N
        wsum = sum(n for (_y, n) in self.masked.values()) / self.weight_norm
        vec = total / max(wsum, 1e-9)
        self.params = unflatten_params(self.params, vec)

        row = {"round": self.round_idx, "n_received": len(self.masked)}
        if self.eval_fn is not None:
            row.update(self.eval_fn(self.params, self.round_idx))
        self.history.append(row)
        recorder.log(row)
        self._record_round_span(row["n_received"], sp.duration * 1e3)
        self.masked.clear()
        self.round_idx += 1
        self._maybe_checkpoint(self.round_idx - 1)
        if self.round_idx >= self.num_rounds:
            self._finish()
            return
        self._send_round(md.S2C_SYNC_MODEL)

    def _record_round_span(self, n_received: int, unmask_ms: float) -> None:
        """Caller holds the lock: the closing round's `round` span (module
        docstring)."""
        if self._round_start is None:
            return
        t0, w0 = self._round_start
        w1 = _wire_totals(self.comm.backend)
        recorder.record(Span(
            "round", t0, time.perf_counter(),
            {"round": self.round_idx, "n_received": n_received,
             "unmask_ms": unmask_ms,
             "wire": {k: w1[k] - w0[k] for k in w1}}))
        self._round_start = None

    # ---------------------------------------------------- checkpoint/restore
    # The SecAgg resume contract: restore is round-boundary only. A
    # checkpoint is written once per completed round, from
    # _unmask_and_advance, after the unmask state is cleared and before the
    # next round's syncs go out — never mid-setup, mid-collection or
    # mid-unmask — and a resume that would land inside a round (a foreign
    # or hand-made checkpoint claiming another phase) is refused. Only the
    # server may die and resume: the surviving clients keep their key
    # material and re-mask the restarted round with the same round_salt,
    # so the resumed aggregate is deterministic.
    def _maybe_checkpoint(self, r: int) -> None:
        """Caller holds the lock, at a round boundary."""
        if self.checkpoint_dir is None or not self.checkpoint_every or not (
                (r + 1) % self.checkpoint_every == 0
                or r == self.num_rounds - 1):
            return
        # an invariant, not input validation: the call site is the round
        # boundary, and tripping this means the write moved
        assert not self._awaiting_unmask and not self.masked, \
            "secagg checkpoint attempted mid-round"
        from ..utils import checkpoint as ckpt

        extra = {
            "kind": "secagg_server",
            "phase": "boundary",
            "threshold": self.t,
            "q_bits": self.q_bits,
            "num_rounds": self.num_rounds,
            "client_ids": list(self.client_ids),
            "pks": {str(c): int(pk) for c, pk in self.pks.items()},
            "client_counts": {str(c): float(n)
                              for c, n in self.client_counts.items()},
            "weight_norm": float(self.weight_norm),
            "active": sorted(self.active),
            "dropped_sk": {str(c): int(sk)
                           for c, sk in self.dropped_sk.items()},
            "dropped_log": [[rr, list(ids)] for rr, ids in self.dropped_log],
        }
        try:
            ckpt.save_checkpoint(
                self.checkpoint_dir, r,
                {"params": {k: torch.from_numpy(v)
                            for k, v in self.params.items()}},
                history=self.history, keep=self.checkpoint_keep, extra=extra)
        except Exception as e:  # noqa: BLE001 — durability must not kill runs
            log.warning("secagg round-%d checkpoint failed (continuing): "
                        "%s: %s", r, type(e).__name__, e)

    def _restore(self, path: str) -> None:
        from ..utils import checkpoint as ckpt

        # one pinned round for meta and tensors: a late in-flight write
        # must not split the pair
        r = ckpt.latest_round(path)
        meta = ckpt.read_meta(path, r)
        extra = meta.get("extra") or {}
        if extra.get("kind") != "secagg_server":
            raise ValueError(
                f"refusing to resume secagg from {path!r}: checkpoint was "
                f"written by {extra.get('kind', 'a non-secagg runtime')!r}, "
                "and secagg restore needs the protocol state (pks, dropped "
                "client keys, weight norm) only a secagg server writes")
        if extra.get("phase") != "boundary":
            raise ValueError(
                f"refusing to resume secagg from {path!r}: checkpoint "
                f"claims phase {extra.get('phase')!r} — secagg restore is "
                "round-boundary only (a resume landing inside a round "
                "cannot recover the in-flight masked uploads or unmask "
                "shares)")
        template = {k: torch.from_numpy(v) for k, v in self.params.items()}
        _r, server, _c, _h, hist = ckpt.restore_checkpoint(
            path, {"params": template}, round_idx=r)
        self.params = {k: v.cpu().numpy() for k, v in
                       server["params"].items()}
        self.history = list(hist)
        self.round_idx = int(meta["round"]) + 1
        self.t = int(extra["threshold"])
        self.q_bits = int(extra["q_bits"])
        self.pks = {int(c): int(pk) for c, pk in extra["pks"].items()}
        self.client_counts = {int(c): float(n)
                              for c, n in extra["client_counts"].items()}
        self.weight_norm = float(extra["weight_norm"])
        self.active = set(int(c) for c in extra["active"])
        self.dropped_sk = {int(c): int(sk)
                           for c, sk in extra["dropped_sk"].items()}
        self.dropped_log = [(int(rr), list(ids))
                            for rr, ids in extra.get("dropped_log", [])]
        self._pks_broadcast = True
        self._route_buf = None      # setup completed before the checkpoint
        self.client_online = {}     # liveness re-established by handshake
        self.is_initialized = True
        self._resumed = True
        log.info("secagg resumed from %r: %d rounds done, continuing at "
                 "round %d over %d active clients", path, len(self.history),
                 self.round_idx, len(self.active))

    def _finish(self) -> None:
        self._cancel_timer()
        for cid in self.client_ids:
            try:
                self.comm.send_message(Message(md.S2C_FINISH, 0, cid))
            except Exception:  # noqa: BLE001 — dropped clients may be
                # unreachable; a failed farewell must not keep done unset
                log.debug("S2C_FINISH to %s failed", cid, exc_info=True)
        self.done.set()
        # callers hold self._lock, and comm.stop() joins the receive
        # thread, which may wait on it: stop from a fresh thread
        threading.Thread(target=self.comm.stop, daemon=True).start()

    def run(self, background: bool = False) -> None:
        if self._resumed and not self.done.is_set():
            if self.round_idx >= self.num_rounds:
                # the checkpoint already covers the whole run
                with self._lock:
                    self._finish()
            else:
                # the resumed server initiates the re-handshake: secagg
                # clients have no watchdog, so recovery cannot depend on
                # them announcing first; their status replies trigger the
                # resume broadcast in _on_client_status
                for cid in sorted(self.active):
                    self.comm.send_message(
                        Message(md.S2C_CHECK_CLIENT_STATUS, 0, cid))
                # bound the reconnect window like a live round
                self._arm_timer()
        self.comm.run(background=background)
        if not background and self.error:
            raise RuntimeError(self.error)


class SecAggClientManager:
    """Client FSM (reference: sa_fedml_client_manager.py) over the port's
    `SiloTrainer` (on the card unless the trainer was built for the CPU):
    masks the weighted trained params before the upload."""

    def __init__(self, comm: FedCommManager, client_id: int,
                 trainer: SiloTrainer, num_clients: int,
                 client_ids: list[int], threshold: Optional[int] = None,
                 server_id: int = 0, q_bits: int = 16, seed: int = 0,
                 premask_ratio: Optional[float] = None):
        self.comm = comm
        self.client_id = client_id
        self.server_id = server_id
        self.trainer = trainer
        # quantize-then-mask (comm_codec.secagg_premask_ratio): the lossy
        # sparsify happens before the shared field quantization and the
        # mask (mpc/secagg.premask_sparsify)
        self.premask_ratio = premask_ratio
        self.client_ids = list(client_ids)
        self.n = num_clients
        self.t = threshold if threshold is not None else max(1, self.n // 2)
        self.q_bits = q_bits
        self._seed = seed
        # protocol index 0..n-1 (Shamir evaluation points)
        self.proto_idx = self.client_ids.index(client_id)
        # key material is drawn in _on_init, once the server's threshold
        # and q_bits arrive
        self.sa: Optional[SecAggClient] = None
        self.pks: dict[int, int] = {}          # protocol idx -> pk
        self.recv_shares: dict[int, dict] = {}  # owner proto idx -> {"b","sk"}
        self._self_share: dict = {}             # this client's own b/sk share
        self.weight_norm = 1.0                  # N = sum(n_i), from S2C_SA_PKS
        self.done = threading.Event()

        h = comm.register_message_receive_handler
        h(md.S2C_CHECK_CLIENT_STATUS, self._on_check_status)
        h(md.S2C_INIT_CONFIG, self._on_init)
        h(md.S2C_SA_PKS, self._on_pks)
        h(md.S2C_SA_SHARES, self._on_shares)
        h(md.S2C_SYNC_MODEL, self._on_sync)
        h(md.S2C_SA_UNMASK_REQ, self._on_unmask_req)
        h(md.S2C_FINISH, self._on_finish)

    def _cid_to_proto(self, cid: int) -> int:
        return self.client_ids.index(cid)

    def _on_check_status(self, msg: Message) -> None:
        m = Message(md.C2S_CLIENT_STATUS, self.client_id, self.server_id)
        m.add(md.KEY_STATUS, md.STATUS_ONLINE)
        self.comm.send_message(m)

    def _on_init(self, msg: Message) -> None:
        # adopt the server's protocol parameters (they must match on both
        # sides or reconstruction silently yields garbage)
        self.t = int(msg.get(md.KEY_SA_THRESHOLD, self.t))
        self.q_bits = int(msg.get(md.KEY_SA_QBITS, self.q_bits))
        self.sa = SecAggClient(self.proto_idx, self.n, self.t,
                               q_bits=self.q_bits,
                               seed=self._seed + self.client_id)
        m = Message(md.C2S_SA_PK, self.client_id, self.server_id)
        m.add(md.KEY_SA_PK, self.sa.public_key())
        # n_i rides with the pk so the server can broadcast N = sum(n_i)
        # (sample counts are public in this protocol, as in the reference)
        m.add(md.KEY_NUM_SAMPLES, self.trainer.n_samples)
        self.comm.send_message(m)

    def _on_pks(self, msg: Message) -> None:
        # the wire keys pks by client id; the protocol by index 0..n-1
        self.pks = {self._cid_to_proto(int(c)): int(pk)
                    for c, pk in msg.get(md.KEY_SA_PKS).items()}
        self.weight_norm = float(msg.get(md.KEY_SA_WEIGHT_NORM, 1.0))
        b_shares = self.sa.share_self_seed()    # [n, 1]
        sk_shares = self.sa.share_sk()
        # this client's own share never leaves the process: routing it
        # (even encrypted to itself) would hand the server one real Shamir
        # share of b_i / sk_i
        self._self_share = {"b": b_shares[self.proto_idx],
                            "sk": sk_shares[self.proto_idx]}
        out = Message(md.C2S_SA_SHARES, self.client_id, self.server_id)
        # each holder's shares are encrypted with the owner-holder DH pad:
        # the routing server sees only ciphertext
        enc = {}
        for h in range(self.n):
            if h == self.proto_idx:
                continue
            sec = self.sa.agree(self.pks[h])
            enc[str(self.client_ids[h])] = {
                "b": encrypt_share(b_shares[h], sec, self.proto_idx, h, "b"),
                "sk": encrypt_share(sk_shares[h], sec, self.proto_idx, h,
                                    "sk")}
        out.add(md.KEY_SA_SHARES, enc)
        self.comm.send_message(out)

    def _on_shares(self, msg: Message) -> None:
        self.recv_shares = {self.proto_idx: self._self_share}
        for o, sh in msg.get(md.KEY_SA_SHARES).items():
            owner = self._cid_to_proto(int(o))
            sec = self.sa.agree(self.pks[owner])
            self.recv_shares[owner] = {
                "b": decrypt_share(sh["b"], sec, owner, self.proto_idx, "b"),
                "sk": decrypt_share(sh["sk"], sec, owner, self.proto_idx,
                                    "sk")}
        self._train_and_send(msg.get(md.KEY_MODEL_PARAMS),
                             int(msg.get(md.KEY_ROUND, 0)))

    def _on_sync(self, msg: Message) -> None:
        self._train_and_send(msg.get(md.KEY_MODEL_PARAMS),
                             int(msg.get(md.KEY_ROUND, 0)))

    def _train_and_send(self, params, round_idx: int) -> None:
        with recorder.span("sa_train", round=round_idx, client=self.client_id):
            new_params, n, _metrics = self.trainer.train(params, round_idx)
        with recorder.span("sa_mask", round=round_idx, client=self.client_id):
            # the normalised weight n/N keeps the field budget independent
            # of the sample counts
            vec = flatten_params(new_params) * (float(n) / self.weight_norm)
            if self.premask_ratio is not None:
                from ..mpc.secagg import premask_sparsify

                vec = premask_sparsify(vec, self.premask_ratio)
            masked = self.sa.mask(vec, self.pks, round_salt=round_idx)
        out = Message(md.C2S_SA_MASKED, self.client_id, self.server_id)
        out.add(md.KEY_SA_MASKED, masked)
        out.add(md.KEY_NUM_SAMPLES, n)
        out.add(md.KEY_ROUND, round_idx)
        self.comm.send_message(out)

    def _on_unmask_req(self, msg: Message) -> None:
        survivors = [int(c) for c in msg.get(md.KEY_SA_SURVIVORS)]
        dropped = [int(c) for c in msg.get(md.KEY_SA_DROPPED)]
        out = Message(md.C2S_SA_UNMASK, self.client_id, self.server_id)
        out.add(md.KEY_SA_B_SHARES, {
            str(c): self.recv_shares[self._cid_to_proto(c)]["b"]
            for c in survivors if self._cid_to_proto(c) in self.recv_shares})
        out.add(md.KEY_SA_SK_SHARES, {
            str(c): self.recv_shares[self._cid_to_proto(c)]["sk"]
            for c in dropped if self._cid_to_proto(c) in self.recv_shares})
        self.comm.send_message(out)

    def _on_finish(self, msg: Message) -> None:
        m = Message(md.C2S_FINISHED, self.client_id, self.server_id)
        m.add(md.KEY_STATUS, md.STATUS_FINISHED)
        try:
            self.comm.send_message(m)
        except Exception:  # noqa: BLE001 — the server may be gone already
            pass
        self.done.set()
        self.comm.stop()

    def run(self, background: bool = False) -> None:
        self.comm.run(background=background)

    def announce_ready(self) -> None:
        self.comm.send_message(
            Message(md.CONNECTION_IS_READY, self.client_id, self.server_id))
