"""Live federation soak (port of `fedml_tpu/soak/__init__.py`): the closed
production loop, train → publish → hot-swap → serve under million-user-
shaped traffic, with chaos on both tiers.

- `loadgen.py`: a seeded, replayable traffic generator (Zipf-shared
  prompt prefixes, heavy-tailed lengths, open-loop arrival with bursts,
  unary and SSE requests, per-request SLO bookkeeping; shed 429s counted
  apart from failures).
- `loop.py`: `LiveLoopHarness`, a durable cross-silo federation training
  the serving model's LoRA adapters, each round's aggregate published to
  the artifact store and rolled onto a paged-engine fleet while loadgen
  traffic flows; one `FaultSpec` timeline kills trainers (`silo_kill`)
  and replicas (`replica_kill`).
- `slo.py`: windowed SLO evaluation (TTFT p99, non-2xx excluding bounded
  sheds, fleet-version lag, progress).
- `knobs.py`: the `SOAK_KNOBS` registry `config.py` validates
  `common_args.extra.soak` against, and `soak_plan`, its one consumer.

Lazy re-exports (PEP 562): `knobs` stays importable without torch, since
`config.py` reads it at load time; the harness modules import on first
symbol access.
"""
from __future__ import annotations

import importlib

__all__ = [
    "SOAK_KNOBS", "validate_soak", "soak_plan",
    "TrafficSpec", "LoadGenerator", "build_schedule",
    "LiveLoopHarness", "evaluate_slo",
]

_LAZY = {
    "SOAK_KNOBS": "knobs", "validate_soak": "knobs", "soak_plan": "knobs",
    "TrafficSpec": "loadgen", "LoadGenerator": "loadgen",
    "build_schedule": "loadgen",
    "LiveLoopHarness": "loop",
    "evaluate_slo": "slo",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(name)
    return getattr(importlib.import_module(f".{mod}", __name__), name)
