"""The soak-knob registry (own copy of `fedml_tpu/soak/knobs.py`).

One table for every `common_args.extra.soak` knob the live-loop harness
(`soak/loop.py`), the traffic generator (`soak/loadgen.py`) and the SLO
evaluator (`soak/slo.py`) consume. Config validation iterates this table
(unknown keys refused at load), and `soak_plan` is the one function that
translates a validated knob dict into the three consumers' kwargs, so a
knob that passes config load cannot be dropped on the way into the
harness. The key set, the kinds, the defaults and the messages are the
JAX package's.

`SOAK_KNOBS` stays a pure literal, and this module imports nothing but
the standard library: `config.py` reads it at load time.
"""
from __future__ import annotations

# knob -> spec. Kinds: "int" (min), "num" (strict: >0 vs >=0), "frac"
# (in [0, 1]). "requires" names the gating knob whose absence makes this
# one silently dead (refused at config load). Every soak knob is consumed
# by soak_plan below — consumer="plan".
SOAK_KNOBS = {
    "rounds":          {"kind": "int", "min": 1, "consumer": "plan"},
    "n_clients":       {"kind": "int", "min": 1, "consumer": "plan"},
    "n_replicas":      {"kind": "int", "min": 1, "consumer": "plan"},
    "seed":            {"kind": "int", "min": 0, "consumer": "plan"},
    "rate_rps":        {"kind": "num", "strict": True, "consumer": "plan"},
    "duration_s":      {"kind": "num", "strict": True, "consumer": "plan"},
    "zipf_s":          {"kind": "num", "strict": True, "consumer": "plan"},
    "prefix_pool":     {"kind": "int", "min": 1, "consumer": "plan"},
    "stream_frac":     {"kind": "frac", "consumer": "plan"},
    "burst_every_s":   {"kind": "num", "strict": True, "consumer": "plan"},
    "burst_factor":    {"kind": "num", "strict": True, "consumer": "plan",
                        "requires": "burst_every_s"},
    "burst_len_s":     {"kind": "num", "strict": True, "consumer": "plan",
                        "requires": "burst_every_s"},
    "shed_frac_max":   {"kind": "frac", "consumer": "plan"},
    "ttft_p99_slo_ms": {"kind": "num", "strict": True, "consumer": "plan"},
    "lag_rounds_max":  {"kind": "int", "min": 0, "consumer": "plan"},
    # live burn-rate alerting (utils/slo.py): the error budget
    # and the multi-window thresholds the SloMonitor pages on
    "slo_error_budget":  {"kind": "frac", "consumer": "plan"},
    "slo_fast_window_s": {"kind": "num", "strict": True, "consumer": "plan"},
    "slo_slow_window_s": {"kind": "num", "strict": True, "consumer": "plan"},
    "slo_fast_burn":     {"kind": "num", "strict": True, "consumer": "plan"},
    "slo_slow_burn":     {"kind": "num", "strict": True, "consumer": "plan"},
}


def validate_soak(extra: dict) -> None:
    """Validate a `common_args.extra.soak` knob dict against the registry.

    Unknown keys are refused (the soak section is fully owned by this
    framework — a misspelled rate_rps must not pass silently), kinds and
    bounds are enforced, and a knob whose gating prerequisite is absent is
    refused instead of silently ignored (the serve-knob discipline).
    """
    if not isinstance(extra, dict):
        raise ValueError(
            f"common_args.extra.soak must be a mapping of soak knobs; "
            f"got {extra!r}")
    unknown = set(extra) - set(SOAK_KNOBS)
    if unknown:
        raise ValueError(
            f"unknown soak knob(s) {sorted(unknown)}; valid: "
            f"{sorted(SOAK_KNOBS)}")
    for knob, spec in SOAK_KNOBS.items():
        val = extra.get(knob)
        if val is None:
            continue
        if spec["kind"] == "int":
            lo = spec["min"]
            try:
                ok = (not isinstance(val, bool)
                      and int(val) == float(val) and int(val) >= lo)
            except (TypeError, ValueError):
                ok = False
            if not ok:
                raise ValueError(
                    f"soak.{knob} must be an integer >= {lo}; got {val!r}")
        elif spec["kind"] == "num":
            strict = spec["strict"]
            try:
                ok = (not isinstance(val, bool)
                      and (float(val) > 0 if strict else float(val) >= 0))
            except (TypeError, ValueError):
                ok = False
            if not ok:
                raise ValueError(
                    f"soak.{knob} must be a "
                    f"{'positive' if strict else 'non-negative'} number; "
                    f"got {val!r}")
        elif spec["kind"] == "frac":
            try:
                ok = (not isinstance(val, bool)
                      and 0.0 <= float(val) <= 1.0)
            except (TypeError, ValueError):
                ok = False
            if not ok:
                raise ValueError(
                    f"soak.{knob} must be a fraction in [0, 1]; "
                    f"got {val!r}")
        req = spec.get("requires")
        if req is not None and extra.get(req) is None:
            raise ValueError(
                f"soak.{knob} requires soak.{req} — without it the knob "
                "would be silently ignored")


def soak_plan(sk: dict) -> dict:
    """THE validated-soak-knobs -> harness-kwargs mapping: loop shape,
    loadgen traffic spec kwargs, and SLO bounds, with one source of
    defaults. Every registry knob is read here, so a knob validated at
    config load cannot be dropped on the way into the harness."""
    return {
        "rounds": int(sk.get("rounds", 10)),
        "n_clients": int(sk.get("n_clients", 2)),
        "n_replicas": int(sk.get("n_replicas", 2)),
        "seed": int(sk.get("seed", 0)),
        "loadgen": {
            "seed": int(sk.get("seed", 0)),
            "rate_rps": float(sk.get("rate_rps", 20.0)),
            "duration_s": float(sk.get("duration_s", 60.0)),
            "zipf_s": float(sk.get("zipf_s", 1.2)),
            "prefix_pool": int(sk.get("prefix_pool", 8)),
            "stream_frac": float(sk.get("stream_frac", 0.25)),
            "burst_every_s": (
                None if sk.get("burst_every_s") is None
                else float(sk.get("burst_every_s"))),
            "burst_factor": float(sk.get("burst_factor", 3.0)),
            "burst_len_s": float(sk.get("burst_len_s", 1.0)),
        },
        "slo": {
            "shed_frac_max": float(sk.get("shed_frac_max", 0.2)),
            "ttft_p99_slo_ms": float(sk.get("ttft_p99_slo_ms", 2000.0)),
            "lag_rounds_max": int(sk.get("lag_rounds_max", 2)),
            "slo_error_budget": float(sk.get("slo_error_budget", 0.01)),
            "slo_fast_window_s": float(sk.get("slo_fast_window_s", 5.0)),
            "slo_slow_window_s": float(sk.get("slo_slow_window_s", 30.0)),
            "slo_fast_burn": float(sk.get("slo_fast_burn", 5.0)),
            "slo_slow_burn": float(sk.get("slo_slow_burn", 1.0)),
        },
    }
