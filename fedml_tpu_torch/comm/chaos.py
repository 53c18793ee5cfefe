"""The chaos plane's fault plan (a trimmed copy of `FaultSpec` from
`fedml_tpu/comm/chaos.py`: the dataclass, `from_config` / `from_dict`,
their validation and `replica_killed`).

The simulator reads the client-fault rates, `client_dropout` and
`client_straggler`: the round draws its masks from them
(`parallel/round.py`). The serving runner reads `replica_kill` through
`replica_killed` (`serving/inference_runner.py`). The link faults, crash and flap schedules and the
transport that injects them (`ChaosTransport`) come with the
communication layer (ROADMAP 'Port queue' item 5); the spec already
validates them, so a plan that the JAX package refuses is refused here
too.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

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

    def replica_killed(self, rank: int, n_tokens: int) -> bool:
        """True once serving replica `rank` has streamed `n_tokens` >= its
        scheduled kill count (the inference runner then dies mid-stream)."""
        after = self.replica_kill.get(rank)
        return after is not None and n_tokens >= after

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

