"""Reliable delivery — seq / ack / retransmit and receiver-side dedup
(port of `fedml_tpu/comm/reliable.py`).

Wraps any `BaseTransport` with an at-least-once envelope made exactly-once
at the receiver:

- outbound messages carry a per-destination sequence number (`_rel_seq`)
  and the sender incarnation's epoch (`_rel_epoch`);
- the receiver acks every data frame (`rel.ack`, consumed here, never
  dispatched to handlers) and drops already-seen sequence numbers inside
  a bounded dedup window, so retransmits and chaos-injected duplicates
  are idempotent;
- a background retransmitter resends unacked messages on an exponential
  backoff with seeded jitter until `max_attempts` / `deadline_s` is
  spent, then gives up loudly (`comm.rel.delivery_failed`, a log line, a
  `comm.rel.giveup` span, the `failed` list).

`send_message` stays non-blocking: FSM handlers send from the receive
loop's thread, and a blocking ack wait there would deadlock against the
loop that must consume the ack. Integrity is the wire format's job (the
FT02 CRC trailer): a corrupted frame is dropped in the transport pump
(`comm.<backend>.decode_errors`), never acked, and retransmitted. Knobs
ride `common_args.extra.comm_retry`, validated at config load.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import queue
import random
import threading
import time
from collections import deque
from typing import Optional

from ..utils import metrics as _mx
from ..utils.events import recorder
from .base import BaseTransport, Observer
from .message import Message

log = logging.getLogger(__name__)

#: ack frame type — consumed by ReliableTransport, never reaches handlers
REL_ACK = "rel.ack"
#: envelope headers (underscore: visually apart from payload keys)
HDR_SEQ = "_rel_seq"
#: per-transport-incarnation id: a restarted sender's sequence numbers
#: restart at 1, and without an epoch the receiver's dedup window would
#: silently swallow its first `dedup_window` messages as duplicates. The
#: receiver keeps ONE window per sender, reset whenever the epoch changes,
#: and acks echo the epoch so a stale pre-restart ack can't satisfy a
#: post-restart send.
HDR_EPOCH = "_rel_epoch"
#: sender-clock transmit timestamp, echoed verbatim in the ack:
#: the sender measures link RTT against its OWN monotonic clock, so no
#: cross-process clock agreement is needed. Restamped on every transmit
#: (Karn's rule) — an ack always echoes the attempt that actually landed,
#: never an earlier attempt's stamp inflated by backoff.
HDR_TS = "_rel_ts"


class DeliveryError(RuntimeError):
    """A message exhausted its retry budget (raised only by explicit
    `flush(raise_on_failure=True)` calls — the send path never throws)."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Retry/backoff/dedup knobs (`common_args.extra.comm_retry`).

      max_attempts  — transmits per message before giving up (>= 1)
      ack_timeout_s — wait before the FIRST retransmit
      backoff_mult  — timeout multiplier per further attempt
      max_backoff_s — cap on the per-attempt wait
      jitter        — +/- fraction of each wait (decorrelates retry storms)
      deadline_s    — total wall-clock budget per message
      rpc_timeout_s — per-RPC deadline for deadline-capable transports
                      (gRPC, not ported: validated and kept so a JAX
                      package config loads unchanged)
      dedup_window  — per-sender count of remembered sequence numbers
      seed          — jitter RNG seed (per-rank offset added internally)
    """

    max_attempts: int = 6
    ack_timeout_s: float = 0.25
    backoff_mult: float = 2.0
    max_backoff_s: float = 2.0
    jitter: float = 0.2
    deadline_s: float = 30.0
    rpc_timeout_s: float = 10.0
    dedup_window: int = 1024
    seed: int = 0

    def __post_init__(self):
        def bad(knob, why):
            raise ValueError(
                f"common_args.extra.comm_retry.{knob} {why}; got "
                f"{getattr(self, knob)!r}")

        if not isinstance(self.max_attempts, int) \
                or isinstance(self.max_attempts, bool) or self.max_attempts < 1:
            bad("max_attempts", "must be an integer >= 1")
        if not isinstance(self.dedup_window, int) \
                or isinstance(self.dedup_window, bool) or self.dedup_window < 1:
            bad("dedup_window", "must be an integer >= 1")
        if not isinstance(self.seed, int) or isinstance(self.seed, bool):
            bad("seed", "must be an integer")
        for knob, lo in (("ack_timeout_s", 1e-4), ("backoff_mult", 1.0),
                         ("max_backoff_s", 1e-4), ("deadline_s", 1e-3),
                         ("rpc_timeout_s", 1e-3)):
            v = getattr(self, knob)
            if not isinstance(v, (int, float)) or isinstance(v, bool) \
                    or float(v) < lo:
                bad(knob, f"must be a number >= {lo}")
        if not isinstance(self.jitter, (int, float)) \
                or isinstance(self.jitter, bool) \
                or not 0.0 <= float(self.jitter) < 1.0:
            bad("jitter", "must be a fraction in [0, 1)")

    @classmethod
    def from_dict(cls, d) -> "RetryPolicy":
        if d is True:  # `comm_retry: true` = defaults
            return cls()
        if not isinstance(d, dict):
            raise ValueError(
                "common_args.extra.comm_retry must be a mapping of retry "
                f"knobs (or `true` for defaults); got {d!r}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(
                f"unknown common_args.extra.comm_retry keys {unknown} "
                f"(known: {sorted(known)})")
        return cls(**d)


class _Pending:
    __slots__ = ("msg", "attempts", "due", "deadline")

    def __init__(self, msg: Message, due: float, deadline: float):
        self.msg = msg
        self.attempts = 1
        self.due = due
        self.deadline = deadline


class ReliableTransport(BaseTransport, Observer):
    """At-least-once sender + exactly-once receiver over any transport.

    Stack order with chaos: `ReliableTransport(ChaosTransport(inner))` —
    faults are injected UNDER the retry machinery, so data frames, acks and
    retransmits all face the injected weather and recovery is end-to-end.

    Deployment contract: enable `comm_retry` on BOTH ends of a link.
    Inbound messages without a `_rel_seq` header pass straight through (a
    plain peer's sends are simply unprotected), but the reverse mix —
    reliable sender, plain receiver — is broken by construction: the plain
    side never acks and has no dedup, so every retransmit is dispatched to
    its handlers again. The give-up log calls this out.
    """

    def __init__(self, inner: BaseTransport,
                 policy: Optional[RetryPolicy] = None):
        super().__init__()
        self.inner = inner
        self.policy = policy if policy is not None else RetryPolicy()
        self.failed: list[dict] = []    # give-ups, for tests/introspection
        self._lock = threading.Lock()
        self._pending: dict[tuple[int, int], _Pending] = {}
        self._next_seq: dict[int, int] = {}
        #: sender -> (epoch, seen-set, insertion-order deque): one bounded
        #: dedup window per sender, reset when its incarnation changes
        self._seen: dict[int, tuple[str, set, deque]] = {}
        self._jitter_rng = random.Random(
            self.policy.seed * 7919 + getattr(inner, "rank", 0) * 104729)
        self._epoch = os.urandom(6).hex()   # this incarnation's identity
        self._stop = threading.Event()
        self._tick = max(0.005, self.policy.ack_timeout_s / 4.0)
        inner.add_observer(self)
        self._thread = threading.Thread(
            target=self._retransmit_loop, name="rel-retransmit", daemon=True)
        self._thread.start()
        # acks go out on their own thread: the receive path runs on the
        # transport's singleton pump thread, and a synchronous ack RPC to an
        # unreachable sender (a network transport's timeout x retries) would
        # stall dispatch of every OTHER peer's queued frames behind it
        self._ack_q: queue.Queue = queue.Queue()
        self._ack_thread = threading.Thread(
            target=self._ack_loop, name="rel-acks", daemon=True)
        self._ack_thread.start()

    # ------------------------------------------------------------- plumbing
    @property
    def rank(self) -> int:
        return getattr(self.inner, "rank", 0)

    @property
    def backend_name(self) -> str:
        return self.inner.backend_name

    def set_codec(self, policy) -> None:
        # the wire codec lives on the innermost transport, whose
        # _encode_frame / _decode_frame run; set here it would leave the
        # frames dense
        self.inner.set_codec(policy)

    def handle_receive_message(self) -> None:
        self.inner.handle_receive_message()

    def stop_receive_message(self) -> None:
        self._stop.set()
        self._ack_q.put(None)
        self.inner.stop_receive_message()
        for t in (self._thread, self._ack_thread):
            if t is not threading.current_thread():
                t.join(timeout=2.0)

    def __getattr__(self, item):
        return getattr(object.__getattribute__(self, "inner"), item)

    # ----------------------------------------------------------------- send
    def send_message(self, msg: Message) -> None:
        dst = msg.receiver_id
        with self._lock:
            seq = self._next_seq[dst] = self._next_seq.get(dst, 0) + 1
        msg.params[HDR_SEQ] = seq
        msg.params[HDR_EPOCH] = self._epoch
        now = time.monotonic()
        with self._lock:
            self._pending[(dst, seq)] = _Pending(
                msg, now + self._wait_for(1),
                now + self.policy.deadline_s)
        _mx.inc("comm.rel.sends")
        self._transmit(msg)

    def _wait_for(self, attempt: int) -> float:
        p = self.policy
        base = min(p.ack_timeout_s * p.backoff_mult ** (attempt - 1),
                   p.max_backoff_s)
        return base * (1.0 + p.jitter * (2.0 * self._jitter_rng.random() - 1.0))

    def _transmit(self, msg: Message) -> None:
        msg.params[HDR_TS] = time.perf_counter()
        try:
            self.inner.send_message(msg)
        except Exception as e:  # noqa: BLE001 — retried in the background
            _mx.inc("comm.rel.send_errors")
            log.warning("rank %s: transmit of %r seq %s to %s failed "
                        "(will retry): %s: %s", self.rank, msg.type,
                        msg.params.get(HDR_SEQ), msg.receiver_id,
                        type(e).__name__, e)

    def _retransmit_loop(self) -> None:
        p = self.policy
        while not self._stop.wait(self._tick):
            now = time.monotonic()
            resend: list[Message] = []
            give_up: list[tuple[tuple, _Pending]] = []
            with self._lock:
                for key, ent in list(self._pending.items()):
                    if ent.due > now:
                        continue
                    if ent.attempts >= p.max_attempts or now >= ent.deadline:
                        del self._pending[key]
                        give_up.append((key, ent))
                        continue
                    ent.attempts += 1
                    ent.due = now + self._wait_for(ent.attempts)
                    resend.append(ent.msg)
            for msg in resend:
                _mx.inc("comm.rel.retransmits")
                self._transmit(msg)
            for (dst, seq), ent in give_up:
                _mx.inc("comm.rel.delivery_failed")
                self.failed.append({"receiver": dst, "seq": seq,
                                    "type": ent.msg.type,
                                    "attempts": ent.attempts})
                log.warning(
                    "rank %s: giving up on %r seq %d to %s after %d "
                    "attempts (budget max_attempts=%d deadline_s=%g) — "
                    "peer down, or running without comm_retry (no acks)?",
                    self.rank, ent.msg.type, seq, dst, ent.attempts,
                    p.max_attempts, p.deadline_s)
                with recorder.span("comm.rel.giveup", receiver=dst, seq=seq,
                                   msg_type=ent.msg.type,
                                   attempts=ent.attempts):
                    pass

    # -------------------------------------------------------------- receive
    def _ack_loop(self) -> None:
        while True:
            item = self._ack_q.get()
            if item is None:
                return
            peer, seq, epoch, ts = item
            params = {HDR_SEQ: seq, HDR_EPOCH: epoch}
            if ts is not None:
                params[HDR_TS] = ts      # echo: RTT on the sender's clock
            try:
                self.inner.send_message(
                    Message(REL_ACK, self.rank, peer, params))
            except Exception as e:  # noqa: BLE001
                _mx.inc("comm.rel.ack_send_errors")
                log.debug("rank %s: ack %d to %s failed: %s: %s", self.rank,
                          seq, peer, type(e).__name__, e)

    def receive_message(self, msg_type: str, msg: Message) -> None:
        if msg_type == REL_ACK:
            seq = msg.get(HDR_SEQ)
            # the ack must echo THIS incarnation's epoch: a stale ack from
            # before a restart must not satisfy a post-restart send that
            # happens to reuse the sequence number
            fresh = msg.get(HDR_EPOCH) == self._epoch
            with self._lock:
                ent = self._pending.pop((msg.sender_id, int(seq)), None) \
                    if fresh and seq is not None else None
            _mx.inc("comm.rel.acked" if ent is not None
                    else "comm.rel.stale_acks")
            ts = msg.get(HDR_TS)
            if ent is not None and ts is not None:
                # every acked frame yields a measured per-link RTT: the
                # echo is this process's own perf_counter stamp, so the
                # subtraction never crosses clock domains
                _mx.registry.histogram(
                    f"comm.link.{self.rank}.{msg.sender_id}.rtt_ms",
                    _mx.RTT_BUCKETS_MS).observe(
                    (time.perf_counter() - float(ts)) * 1e3)
            return
        seq = msg.get(HDR_SEQ)
        if seq is None:
            self._notify(msg)   # unprotected peer: pass through
            return
        seq = int(seq)
        epoch = str(msg.get(HDR_EPOCH, ""))
        # ack FIRST and ALWAYS — a duplicate means the previous ack was lost
        # (or chaos cloned the frame); re-acking is what makes retransmits
        # converge. Acks go through a dedicated sender thread so an
        # unreachable peer can't stall the transport pump this runs on.
        # The ack itself is unprotected: data-frame retransmission already
        # covers ack loss.
        self._ack_q.put((msg.sender_id, seq, epoch, msg.get(HDR_TS)))
        with self._lock:
            window = self._seen.get(msg.sender_id)
            if window is None or window[0] != epoch:
                # new sender incarnation: its seqs restart at 1, so the old
                # window would swallow them as duplicates — reset it
                window = (epoch, set(), deque())
                self._seen[msg.sender_id] = window
            _, seen, order = window
            if seq in seen:
                dup = True
            else:
                dup = False
                seen.add(seq)
                order.append(seq)
                while len(order) > self.policy.dedup_window:
                    seen.discard(order.popleft())
        if dup:
            _mx.inc("comm.rel.dedup_dropped")
            return
        self._notify(msg)

    # ------------------------------------------------------------ utilities
    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    def flush(self, timeout: float = 10.0,
              raise_on_failure: bool = False) -> bool:
        """Wait until every outstanding message is acked or given up.
        Returns True when the pending set drained in time."""
        end = time.monotonic() + timeout
        while time.monotonic() < end:
            if self.pending_count() == 0:
                if raise_on_failure and self.failed:
                    raise DeliveryError(
                        f"{len(self.failed)} message(s) exhausted their "
                        f"retry budget: {self.failed[:3]}")
                return True
            time.sleep(self._tick)
        return False
