"""The chaos plane (port of `fedml_tpu/comm/chaos.py`): `FaultSpec`, a
seeded declarative fault plan, and `ChaosTransport`, which injects its
link faults on a transport's send path.

The simulator reads the client-fault rates, `client_dropout` and
`client_straggler`: the round draws its masks from them
(`parallel/round.py`). The serving runner reads `replica_kill` through
`replica_killed` (`serving/inference_runner.py`), the cross-silo soak
`silo_kill` (`cross_silo/soak.py`). `ChaosTransport` drops, duplicates,
delays, reorders and corrupts messages and applies the per-rank crash and
flap schedules. Each draw comes from a `random.Random` keyed by (seed,
sender, receiver, per-link sequence number) (`link_rng`), in the JAX
package's draw order, so the same plan against the same sends makes the
same fault decisions in both packages, whatever the thread timing. Every
injected fault is counted (`fed.chaos.<fault>`) and leaves a
zero-duration `comm.chaos.<fault>` span.
"""
from __future__ import annotations

import dataclasses
import logging
import random
import struct
import threading
from typing import Optional

from ..utils import metrics as _mx
from ..utils.events import recorder
from .base import BaseTransport, Observer
from .message import Message

log = logging.getLogger(__name__)

# link-fault probability knobs (all in [0, 1])
_PROB_FIELDS = ("drop", "duplicate", "delay", "reorder", "corrupt")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Seeded fault plan. The probabilities are per message (link faults)
    or per sampled client and round (client faults), each in [0, 1];
    `crash` / `flap` are per-rank schedules counted in the sender's
    outbound sends.

      seed             - root of every fault draw (same seed, same faults)
      drop, duplicate, delay, reorder, corrupt
                       - P(a message is dropped / delivered twice / held /
                         held an extra beat / tampered with in flight)
      delay_max_s      - a held message waits uniformly in [0, delay_max_s)
      crash            - {rank: n}: the rank's link goes dark after its
                         n-th send
      flap             - {rank: {"up": u, "down": d}}: u sends delivered,
                         then d dropped, in cycles
      client_dropout   - P(a sampled client's update is lost this round)
      client_straggler - P(a sampled client misses the round's deadline;
                         its report is discarded like a lost one)
      replica_kill     - {replica_rank: n}: a serving replica dies once it
                         has streamed its n-th token (n >= 1)
      silo_kill        - {rank: round}: a cross-silo process is killed
                         once the run has completed `round` rounds
    """

    seed: int = 0
    drop: float = 0.0
    duplicate: float = 0.0
    delay: float = 0.0
    delay_max_s: float = 0.05
    reorder: float = 0.0
    corrupt: float = 0.0
    crash: dict = dataclasses.field(default_factory=dict)
    flap: dict = dataclasses.field(default_factory=dict)
    client_dropout: float = 0.0
    client_straggler: float = 0.0
    replica_kill: dict = dataclasses.field(default_factory=dict)
    silo_kill: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        for f in _PROB_FIELDS + ("client_dropout", "client_straggler"):
            v = getattr(self, f)
            if not isinstance(v, (int, float)) or isinstance(v, bool) \
                    or not 0.0 <= float(v) <= 1.0:
                raise ValueError(
                    f"common_args.extra.chaos.{f} must be a probability in "
                    f"[0, 1]; got {v!r}")
        if not isinstance(self.delay_max_s, (int, float)) \
                or isinstance(self.delay_max_s, bool) or self.delay_max_s < 0:
            raise ValueError(
                "common_args.extra.chaos.delay_max_s must be a non-negative "
                f"number of seconds; got {self.delay_max_s!r}")
        if not isinstance(self.seed, int) or isinstance(self.seed, bool):
            raise ValueError(
                f"common_args.extra.chaos.seed must be an int; got "
                f"{self.seed!r}")
        for name, sched in (("crash", self.crash), ("flap", self.flap),
                            ("replica_kill", self.replica_kill),
                            ("silo_kill", self.silo_kill)):
            if not isinstance(sched, dict):
                raise ValueError(
                    f"common_args.extra.chaos.{name} must be a dict keyed by "
                    f"rank; got {sched!r}")
        for sched_name, sched in (("crash", self.crash),
                                  ("replica_kill", self.replica_kill),
                                  ("silo_kill", self.silo_kill)):
            # replica_kill fires AFTER the n-th streamed token, so 0 would
            # silently behave as 1 — refuse it (kill-before-first-byte is
            # a listening-socket kill, not a mid-stream schedule)
            floor = 1 if sched_name == "replica_kill" else 0
            for rank, n in sched.items():
                if not (isinstance(n, int) and not isinstance(n, bool)
                        and n >= floor):
                    raise ValueError(
                        f"common_args.extra.chaos.{sched_name} values must "
                        f"be counts >= {floor}; got {rank!r}: {n!r}")
        for rank, cyc in self.flap.items():
            ok = (isinstance(cyc, dict)
                  and isinstance(cyc.get("up"), int) and cyc["up"] >= 1
                  and isinstance(cyc.get("down"), int) and cyc["down"] >= 1)
            if not ok:
                raise ValueError(
                    "common_args.extra.chaos.flap values must be "
                    '{"up": >=1, "down": >=1} send-count cycles; got '
                    f"{rank!r}: {cyc!r}")

    def any_link_faults(self) -> bool:
        return bool(self.crash or self.flap
                    or any(getattr(self, f) > 0.0 for f in _PROB_FIELDS))

    def any_client_faults(self) -> bool:
        return self.client_dropout > 0.0 or self.client_straggler > 0.0

    def link_rng(self, src: int, dst: int, seq: int) -> random.Random:
        """One fresh RNG per (sender, receiver, link sequence) triple: fault
        draws never depend on wall clock, thread interleaving or other
        links' traffic."""
        key = ((self.seed * 1000003 + src) * 1000003 + dst) * 1000003 + seq
        return random.Random(key)

    def crashed(self, rank: int, n_sends: int) -> bool:
        after = self.crash.get(rank)
        return after is not None and n_sends > after

    def flapped(self, rank: int, n_sends: int) -> bool:
        cyc = self.flap.get(rank)
        if cyc is None:
            return False
        u, d = int(cyc["up"]), int(cyc["down"])
        return (n_sends - 1) % (u + d) >= u

    def replica_killed(self, rank: int, n_tokens: int) -> bool:
        """True once serving replica `rank` has streamed `n_tokens` >= its
        scheduled kill count (the inference runner then dies mid-stream)."""
        after = self.replica_kill.get(rank)
        return after is not None and n_tokens >= after

    def validate_tiers(self, silo_ranks=None, replica_ranks=None) -> None:
        """A `silo_kill` or `replica_kill` schedule naming a rank the run
        does not have would never fire: refuse it. Pass the rank set of
        each tier the caller runs (None skips that tier)."""
        if silo_ranks is not None:
            unknown = sorted(set(self.silo_kill) - set(silo_ranks))
            if unknown:
                raise ValueError(
                    f"chaos.silo_kill names unknown rank(s) {unknown}; "
                    f"this federation has ranks "
                    f"{sorted(silo_ranks)} (0 = server)")
        if replica_ranks is not None:
            unknown = sorted(set(self.replica_kill) - set(replica_ranks))
            if unknown:
                raise ValueError(
                    f"chaos.replica_kill names unknown replica(s) "
                    f"{unknown}; this fleet has replicas "
                    f"{sorted(replica_ranks)}")

    @classmethod
    def from_config(cls, cfg) -> Optional["FaultSpec"]:
        """`common_args.extra.chaos` of a Config, or None when no plan is
        set."""
        raw = cfg.common_args.extra.get("chaos")
        if not raw:
            return None
        return raw if isinstance(raw, cls) else cls.from_dict(raw)

    @classmethod
    def from_dict(cls, d: dict) -> "FaultSpec":
        if not isinstance(d, dict):
            raise ValueError(
                "common_args.extra.chaos must be a mapping of FaultSpec "
                f"knobs; got {d!r}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(
                f"unknown common_args.extra.chaos keys {unknown} "
                f"(known: {sorted(known)})")
        # YAML keys arrive as strings; crash/flap/replica_kill schedules
        # are rank-keyed
        norm = dict(d)
        for sched in ("crash", "flap", "replica_kill", "silo_kill"):
            if isinstance(norm.get(sched), dict):
                norm[sched] = {int(k): v for k, v in norm[sched].items()}
        return cls(**norm)



class ChaosTransport(BaseTransport, Observer):
    """Fault-injecting wrapper over any transport. Byte-level faults
    (corrupt) and out-of-band delivery go through the inner transport's
    raw-frame hook (`_send_raw(frame, receiver_id)`, as loopback has); a
    spec with corrupt > 0 over a transport without one is refused.

    Faults act on the send path only; the receive path forwards the inner
    transport's notifications unchanged. On its own this wrapper makes
    runs fail, which is the point: stack `ReliableTransport`
    (comm/reliable.py) outside it, and acks and retransmits face the same
    weather as data frames.
    """

    def __init__(self, inner: BaseTransport, spec: FaultSpec):
        super().__init__()
        self.inner = inner
        self.spec = spec
        self._raw = getattr(inner, "_send_raw", None)
        if spec.corrupt > 0.0 and self._raw is None:
            raise ValueError(
                f"chaos corrupt faults need a raw-frame transport; "
                f"{type(inner).__name__} has no _send_raw hook")
        self._lock = threading.Lock()
        self._sends = 0                      # this rank's outbound total
        self._link_seq: dict[int, int] = {}  # receiver -> per-link seq
        self._timers: set[threading.Timer] = set()
        self._stopped = False
        inner.add_observer(self)

    # ------------------------------------------------------------- plumbing
    @property
    def rank(self) -> int:
        return getattr(self.inner, "rank", 0)

    @property
    def backend_name(self) -> str:  # metric namespace stays the inner one's
        return self.inner.backend_name

    def set_codec(self, policy) -> None:
        # raw-frame injection reads inner._encode_frame: the codec sits
        # there, so corrupt / duplicate faults act on compressed frames
        self.inner.set_codec(policy)

    def receive_message(self, msg_type: str, msg: Message) -> None:
        self._notify(msg)        # inner -> our observers, unchanged

    def handle_receive_message(self) -> None:
        self.inner.handle_receive_message()

    def stop_receive_message(self) -> None:
        self._stopped = True
        with self._lock:
            timers, self._timers = list(self._timers), set()
        for t in timers:
            t.cancel()
        self.inner.stop_receive_message()

    def __getattr__(self, item):
        return getattr(object.__getattribute__(self, "inner"), item)

    # -------------------------------------------------------------- faults
    def _count(self, kind: str, msg: Message, seq: int) -> None:
        _mx.inc(f"fed.chaos.{kind}")
        with recorder.span(f"comm.chaos.{kind}", sender=msg.sender_id,
                           receiver=msg.receiver_id, seq=seq,
                           msg_type=msg.type):
            pass

    @staticmethod
    def _corrupt_frame(frame: bytes, rng: random.Random) -> bytes:
        """Tamper one byte of the JSON header region; the frame's CRC
        trailer rejects it at the receiver."""
        ba = bytearray(frame)
        if len(ba) <= 8:
            return bytes(ba)
        (hlen,) = struct.unpack("<I", bytes(ba[4:8]))
        lo, hi = 8, min(8 + max(hlen, 1), len(ba))
        i = lo + rng.randrange(max(hi - lo, 1))
        ba[i] ^= 0xFF
        return bytes(ba)

    def _deliver(self, fn, delay_s: float) -> None:
        """Run `fn` now or after `delay_s` on a daemon timer; late timers
        firing into a stopped inner transport are swallowed."""

        def guarded():
            if self._stopped:
                return
            try:
                fn()
            except Exception as e:  # noqa: BLE001 — injected-latency path
                log.debug("chaos delayed delivery failed: %s: %s",
                          type(e).__name__, e)

        if delay_s <= 0.0:
            guarded()
            return

        def fire():
            with self._lock:
                self._timers.discard(t)
            guarded()

        t = threading.Timer(delay_s, fire)
        t.daemon = True
        with self._lock:
            self._timers.add(t)
        t.start()

    def send_message(self, msg: Message) -> None:
        spec = self.spec
        dst = msg.receiver_id
        with self._lock:
            self._sends += 1
            n = self._sends
            seq = self._link_seq[dst] = self._link_seq.get(dst, 0) + 1
        if spec.crashed(self.rank, n):
            self._count("crash_drops", msg, seq)
            return
        if spec.flapped(self.rank, n):
            self._count("flap_drops", msg, seq)
            return
        rng = spec.link_rng(self.rank, dst, seq)
        # the JAX package's fixed draw order: drop, duplicate, corrupt,
        # delay, reorder (another order reshuffles every seeded plan)
        if rng.random() < spec.drop:
            self._count("drop", msg, seq)
            return
        dup = rng.random() < spec.duplicate
        corrupt = rng.random() < spec.corrupt
        delay_s = 0.0
        if rng.random() < spec.delay:
            delay_s = rng.random() * spec.delay_max_s
            self._count("delay", msg, seq)
        if rng.random() < spec.reorder:
            # an extra hold long enough that in-flight later sends pass it
            delay_s += (0.5 + 0.5 * rng.random()) * max(spec.delay_max_s, 0.01)
            self._count("reorder", msg, seq)
        if dup:
            self._count("duplicate", msg, seq)
        if corrupt:
            self._count("corrupt", msg, seq)

        if self._raw is not None:
            frame = self.inner._encode_frame(msg)
            wire = self._corrupt_frame(frame, rng) if corrupt else frame
            self._deliver(lambda: self._raw(wire, dst), delay_s)
            if dup:
                # the duplicate is the clean frame: a duplicate of a
                # corrupt frame would just be rejected twice
                self._deliver(lambda: self._raw(frame, dst), delay_s)
        else:
            self._deliver(lambda: self.inner.send_message(msg), delay_s)
            if dup:
                self._deliver(lambda: self.inner.send_message(msg), delay_s)
