"""Windowed SLO evaluation for the live loop (own copy of
`fedml_tpu/soak/slo.py`).

The soak's acceptance bar is not "the run finished" — it is "the fleet
held its service levels THROUGH every kill". So evaluation is windowed:
loadgen results are bucketed into fixed wall-clock windows (by scheduled
offset) and the TTFT bound is asserted per window as well as overall —
a 5-second stall averaged away over a 60-second run still fails the
window that contains it. (Error counts need no windowed check: zero
overall IS zero in every window; the per-window rows still report them
for diagnosis.)

Checks (bounds ride the `soak.*` knobs — soak/knobs.py):
- zero non-2xx responses, where shed 429s are EXCLUDED (overload refusal
  is the fleet working as designed) but BOUNDED (`shed_frac_max`);
- TTFT p99 <= `ttft_p99_slo_ms` (client-side, streamed requests);
- fleet_version-vs-training-round lag <= `lag_rounds_max` at every
  observation the watcher took;
- training made progress: rounds/s > 0 over the loop wall time.

The result dict is the single source for the `loop:` line assertions in
tests, the diagnosis probe and the card's smoke run.
"""
from __future__ import annotations

from typing import Optional

from ..utils import metrics as _mx


def percentile(vals, q: float) -> Optional[float]:
    """Nearest-rank percentile of a list (None when empty)."""
    s = sorted(vals)
    if not s:
        return None
    return s[min(len(s) - 1, int(q * (len(s) - 1)))]


def _window_rows(results, window_s: float) -> list[dict]:
    if not results:
        return []
    horizon = max(r.t_sched for r in results)
    n_win = int(horizon // window_s) + 1
    wins = [{"t0": i * window_s, "requests": 0, "ok": 0, "shed": 0,
             "errors": 0, "ttft_ms": []} for i in range(n_win)]
    for r in results:
        w = wins[int(r.t_sched // window_s)]
        w["requests"] += 1
        w[r.klass if r.klass != "error" else "errors"] += 1
        if r.ttft_s is not None and r.klass == "ok":
            w["ttft_ms"].append(r.ttft_s * 1e3)
    for w in wins:
        w["ttft_p99_ms"] = percentile(w.pop("ttft_ms"), 0.99)
    return [w for w in wins if w["requests"]]


def evaluate_slo(results, *, rounds_done: int, wall_s: float,
                 fleet_version: Optional[int] = None,
                 lag_max_seen: Optional[int] = None,
                 publish_lat_s: Optional[list] = None,
                 slo: Optional[dict] = None,
                 window_s: float = 5.0) -> dict:
    """Evaluate loadgen `results` + loop facts against the SLO bounds.

    `slo` carries `shed_frac_max` / `ttft_p99_slo_ms` / `lag_rounds_max`
    (soak_plan defaults when omitted). Returns the report dict; also
    publishes the verdict as the `soak.slo_ok` gauge so a live `top` and
    the end-of-run snapshot both show it."""
    from .knobs import soak_plan

    slo = dict(soak_plan({})["slo"], **(slo or {}))
    n = len(results)
    ok = sum(1 for r in results if r.klass == "ok")
    shed = sum(1 for r in results if r.klass == "shed")
    errors = [r for r in results if r.klass == "error"]
    ttft_ms = [r.ttft_s * 1e3 for r in results
               if r.ttft_s is not None and r.klass == "ok"]
    tbt_ms = [g * 1e3 for r in results for g in r.tbt_s]
    total_ms = [r.total_s * 1e3 for r in results if r.klass == "ok"]
    windows = _window_rows(results, window_s)
    ttft_p99 = percentile(ttft_ms, 0.99)
    shed_frac = shed / n if n else 0.0
    checks = {
        "zero_non2xx": not errors,
        "shed_bounded": shed_frac <= slo["shed_frac_max"],
        "ttft_p99": (ttft_p99 is None
                     or ttft_p99 <= slo["ttft_p99_slo_ms"]),
        # the TTFT bound holds per WINDOW too — a stall long enough to
        # blow one window's p99 must not be averaged away by the rest of
        # the run (windows without streamed requests have nothing to
        # check)
        "windows_ttft": all(
            w["ttft_p99_ms"] is None
            or w["ttft_p99_ms"] <= slo["ttft_p99_slo_ms"]
            for w in windows),
        "lag_bounded": (lag_max_seen is None
                        or lag_max_seen <= slo["lag_rounds_max"]),
        "progress": rounds_done > 0 and wall_s > 0,
    }
    report = {
        "requests": n, "ok": ok, "shed_429s": shed,
        "non2xx_excl_shed": len(errors),
        "error_codes": sorted({r.status for r in errors}),
        "shed_frac": round(shed_frac, 4),
        "ttft_p99_ms": (round(ttft_p99, 1)
                        if ttft_p99 is not None else None),
        "ttft_p50_ms": (lambda p: round(p, 1) if p is not None else None)(
            percentile(ttft_ms, 0.5)),
        "tbt_p50_ms": (lambda p: round(p, 1) if p is not None else None)(
            percentile(tbt_ms, 0.5)),
        "total_p99_ms": (lambda p: round(p, 1) if p is not None else None)(
            percentile(total_ms, 0.99)),
        "rounds_done": rounds_done,
        "rounds_per_s": round(rounds_done / wall_s, 3) if wall_s else None,
        "fleet_version": fleet_version,
        "lag_max_seen": lag_max_seen,
        "round_to_serve_p50_ms": (
            (lambda p: round(p * 1e3, 1) if p is not None else None)(
                percentile(publish_lat_s or [], 0.5))),
        "windows": windows,
        "checks": checks,
        "slo_ok": all(checks.values()),
    }
    _mx.set_gauge("soak.slo_ok", 1.0 if report["slo_ok"] else 0.0)
    return report
