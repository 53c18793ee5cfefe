"""Run-health analysis on the host (port of `fedml_tpu/utils/health.py`).

The round (`parallel/round.py`, health_stats=True) returns per-client
update norms, cosines to the aggregate and loss deltas with its metrics;
`HealthTracker.observe_round` turns them into signals:

- anomaly flags: a rolling robust z-score (median / MAD over a window of
  recent rounds' values, MAD scaled by 1.4826) of each client's update
  norm (either tail) and cosine (low tail); nothing is flagged in the
  first `warmup_rounds` rounds;
- participation: a `fed.participation.c<id>` counter per real
  (weight > 0) cohort appearance;
- stragglers: the same test over round wall times bumps
  `fed.health.straggler_rounds`.

Flags land in the `fed.health.*` counters and gauges of `utils/metrics.py`
and as a metrics row and a zero-duration `health.flag` span in
`utils/events.py`'s recorder. numpy only.
"""
from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np

from . import metrics as mx
from .events import recorder as _default_recorder

# MAD -> sigma for a normal distribution, so mad_threshold reads as a z
MAD_SCALE = 1.4826


def record_participation(client_id: int) -> None:
    """One real cohort appearance for `client_id`."""
    mx.inc(f"fed.participation.c{int(client_id)}")


def robust_z(values: np.ndarray, pool: np.ndarray) -> np.ndarray:
    """Robust z-scores of `values` against the pooled sample: (x - median)
    / (MAD * 1.4826); all zeros when the pool's MAD is ~0 (identical
    shards), so a degenerate cohort flags nothing."""
    pool = np.asarray(pool, np.float64)
    values = np.asarray(values, np.float64)
    if pool.size == 0:
        return np.zeros_like(values)
    med = float(np.median(pool))
    mad = float(np.median(np.abs(pool - med))) * MAD_SCALE
    if mad <= 1e-12 * max(1.0, abs(med)):
        return np.zeros_like(values)
    return (values - med) / mad


class HealthTracker:
    """Rolling per-run health analysis (one per simulator run);
    `observe_round` is the single entry point and returns the round's flag
    record."""

    def __init__(self, mad_threshold: float = 3.5, warmup_rounds: int = 3,
                 window: int = 20, recorder=None):
        if mad_threshold <= 0 or warmup_rounds < 0 or window < 1:
            raise ValueError(
                f"invalid health knobs: mad_threshold={mad_threshold!r} "
                f"(> 0), warmup_rounds={warmup_rounds!r} (>= 0), "
                f"window={window!r} (>= 1)")
        self.mad_threshold = float(mad_threshold)
        self.warmup_rounds = int(warmup_rounds)
        self._rec = recorder if recorder is not None else _default_recorder
        self._norms: deque = deque(maxlen=int(window))
        self._cosines: deque = deque(maxlen=int(window))
        self._durations: deque = deque(maxlen=int(window))
        self.rounds_seen = 0

    @classmethod
    def from_config(cls, cfg) -> "HealthTracker":
        """Knobs in train_args.extra: health_mad_threshold (3.5),
        health_warmup_rounds (3), health_window (20)."""
        x = cfg.train_args.extra
        return cls(
            mad_threshold=float(x.get("health_mad_threshold", 3.5)),
            warmup_rounds=int(x.get("health_warmup_rounds", 3)),
            window=int(x.get("health_window", 20)),
        )

    def _flag_clients(self, ids, norms, cosines) -> list[dict]:
        pool_n = np.concatenate(list(self._norms) + [norms])
        pool_c = np.concatenate(list(self._cosines) + [cosines])
        zn = robust_z(norms, pool_n)
        zc = robust_z(cosines, pool_c)
        flags = []
        for i, cid in enumerate(ids):
            reasons = []
            if abs(zn[i]) > self.mad_threshold:
                reasons.append("norm_outlier")
            if zc[i] < -self.mad_threshold:
                reasons.append("cosine_divergent")
            if reasons:
                flags.append({
                    "client": int(cid), "reasons": reasons,
                    "norm": float(norms[i]), "norm_z": round(float(zn[i]), 3),
                    "cosine": float(cosines[i]),
                    "cosine_z": round(float(zc[i]), 3),
                })
        return flags

    def observe_round(self, round_idx: int, ids, weights,
                      health: Optional[dict],
                      duration_s: Optional[float] = None) -> dict:
        """`health`: the round's {"update_norm", "cosine", ...} as numpy
        arrays over `ids`, or None when health stats are off."""
        ids = np.asarray(ids)
        real = np.asarray(weights) > 0
        mx.set_gauge("fed.round", float(round_idx))
        mx.inc("fed.rounds_total")
        for cid in ids[real]:
            record_participation(cid)

        flags: list[dict] = []
        if health is not None:
            norms = np.asarray(health["update_norm"], np.float64)[real]
            cosines = np.asarray(health["cosine"], np.float64)[real]
            mx.set_gauge("fed.health.update_norm_median",
                         float(np.median(norms)) if norms.size else 0.0)
            mx.set_gauge("fed.health.cosine_min",
                         float(cosines.min()) if cosines.size else 0.0)
            if self.rounds_seen >= self.warmup_rounds:
                flags = self._flag_clients(ids[real], norms, cosines)
            self._norms.append(norms)
            self._cosines.append(cosines)

        straggler = False
        if duration_s is not None:
            mx.set_gauge("fed.health.round_s", float(duration_s))
            pool = np.asarray(list(self._durations) + [duration_s])
            if self.rounds_seen >= self.warmup_rounds:
                z = float(robust_z(np.asarray([duration_s]), pool)[0])
                straggler = z > self.mad_threshold
            self._durations.append(float(duration_s))
            if straggler:
                mx.inc("fed.health.straggler_rounds")

        mx.set_gauge("fed.health.divergent", float(len(flags)))
        if flags:
            mx.inc("fed.health.flags_total", len(flags))
            for f in flags:
                mx.inc(f"fed.health.flags.c{f['client']}")
        if flags or straggler:
            self._rec.log({"health": {"round": int(round_idx),
                                      "flags": flags,
                                      "straggler_round": straggler}})
            with self._rec.span(
                    "health.flag", round=int(round_idx),
                    straggler=straggler,
                    clients=",".join(str(f["client"]) for f in flags)):
                pass
        self.rounds_seen += 1
        return {"round": int(round_idx), "flags": flags,
                "straggler_round": straggler}
