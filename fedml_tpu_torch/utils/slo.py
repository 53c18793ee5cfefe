"""Live SLO burn-rate alerts over the metrics registry (own copy of
`fedml_tpu/utils/slo.py`).

`soak/slo.py` judges a finished run post hoc; this module watches the
SAME bars live so a run trending toward violation
alerts BEFORE the windowed verdict goes red. SRE-style multi-window
burn rates: an SLO with error budget B (allowed bad fraction) burns at
rate `bad_frac_in_window / B`; burn 1x exhausts the budget exactly at
the horizon, 5x five times faster. Two windows per spec:

- fast (default 5 s, `slo_fast_window_s`) at a high threshold (default
  5x, `slo_fast_burn`) — pages quickly on a sharp regression;
- slow (default 30 s, `slo_slow_window_s`) at 1x (`slo_slow_burn`) —
  catches sustained low-grade burn the fast window forgives.

Specs are declarative (`SloSpec`): ratio (bad/total counters — the
availability-excluding-sheds and shed-headroom bars), latency (bad =
histogram observations above the threshold bucket — the TTFT p99 bar at
budget 1-q), and gauge (bad = samples over the bar — fleet-version
lag). `default_specs()` derives all four from the soak plan's `slo`
dict so the live monitor and `soak/slo.py`'s post-hoc verdict share one
source of truth. Specs whose budget makes the global fast threshold
unreachable (shed headroom: budget 0.2 means 5x burn = 100% shed) are
capped at 0.5/budget — "half the fast window bad" always fires.

`SloMonitor.sample()` publishes `slo.burn.<name>` (fast) and
`slo.burn.<name>.slow` gauges; threshold crossings are edge-triggered:
`slo.alerts_total` + `slo.alerts.<name>` counters, a zero-duration
`slo.alert` span on the Chrome trace, and the `slo.alerts_firing` gauge
(read by `top`'s `alerts:` line). Time is injectable for tests.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

from . import metrics as _mx

# cap on fast-burn thresholds so every spec's bar is reachable: burn can
# never exceed 1/budget (all-bad window), so fire at half that
_FAST_CAP_BAD_FRAC = 0.5


@dataclass(frozen=True)
class SloSpec:
    """One declarative SLO bar.

    kind "ratio":   bad/good name tuples of counters; total = bad + good.
    kind "latency": `hist` histogram; observations above `threshold_s`
                    are bad (bucket-rounded UP — the bucket containing
                    the threshold counts as bad, so alerts err eager).
    kind "gauge":   each monitor sample of `gauge` above `gauge_max` is
                    one bad sample out of one.
    `budget` is the allowed bad fraction; burn = bad_frac / budget.
    """
    name: str
    kind: str
    budget: float = 0.01
    bad: tuple = ()
    good: tuple = ()
    hist: str = ""
    threshold_s: float = 0.0
    gauge: str = ""
    gauge_max: float = 0.0
    fast_burn: float = 5.0
    slow_burn: float = 1.0


def default_specs(slo: Optional[dict] = None) -> list[SloSpec]:
    """The soak plan's bars as live specs. `slo` defaults to
    `soak_plan({})["slo"]` — same defaults the post-hoc verdict uses."""
    if slo is None:
        from ..soak.knobs import soak_plan

        slo = soak_plan({})["slo"]
    budget = float(slo.get("slo_error_budget", 0.01))
    fast = float(slo.get("slo_fast_burn", 5.0))
    slow = float(slo.get("slo_slow_burn", 1.0))

    def capped(b: float) -> float:
        return min(fast, _FAST_CAP_BAD_FRAC / b)

    shed_budget = float(slo.get("shed_frac_max", 0.2))
    ttft_s = float(slo.get("ttft_p99_slo_ms", 2000.0)) / 1e3
    return [
        SloSpec("availability", "ratio", budget=budget,
                bad=("loadgen.errors",), good=("loadgen.ok",),
                fast_burn=capped(budget), slow_burn=slow),
        SloSpec("shed", "ratio", budget=shed_budget,
                bad=("loadgen.shed",),
                good=("loadgen.ok", "loadgen.errors"),
                fast_burn=capped(shed_budget), slow_burn=slow),
        SloSpec("ttft", "latency", budget=0.01, hist="loadgen.ttft_s",
                threshold_s=ttft_s, fast_burn=capped(0.01),
                slow_burn=slow),
        SloSpec("lag", "gauge", budget=0.25,
                gauge="soak.fleet_lag_rounds",
                gauge_max=float(slo.get("lag_rounds_max", 2)),
                fast_burn=capped(0.25), slow_burn=slow),
    ]


def _counter_sum(snap: dict, names: tuple) -> int:
    counters = snap.get("counters", {})
    return sum(int(counters.get(n, 0)) for n in names)


def _latency_cum(snap: dict, hist: str, threshold_s: float) -> tuple:
    h = snap.get("histograms", {}).get(hist)
    if not h:
        return 0, 0
    total = int(h.get("count", 0))
    good = 0
    for edge, n in zip(h.get("edges", ()), h.get("counts", ())):
        if edge <= threshold_s:
            good += int(n)
    return total - good, total


class SloMonitor:
    """Samples the registry on a cadence and turns cumulative counts
    into windowed burn rates. A window shorter than the run so far falls
    back to the oldest sample — burn is live from the first tick."""

    def __init__(self, specs: Optional[list] = None, *,
                 fast_window_s: float = 5.0, slow_window_s: float = 30.0,
                 time_fn: Callable[[], float] = time.monotonic,
                 registry=None, recorder=None):
        self.specs = list(specs) if specs is not None else default_specs()
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.time_fn = time_fn
        self._registry = registry
        self._recorder = recorder
        # (t, {spec: (bad_cum, total_cum)}) — pruned past the slow window
        self._samples: deque = deque()
        self._gauge_cum: dict[str, list] = {s.name: [0, 0]
                                            for s in self.specs
                                            if s.kind == "gauge"}
        self._firing: dict[str, bool] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- sampling
    def _cums(self, snap: dict) -> dict:
        out = {}
        for sp in self.specs:
            if sp.kind == "ratio":
                bad = _counter_sum(snap, sp.bad)
                out[sp.name] = (bad, bad + _counter_sum(snap, sp.good))
            elif sp.kind == "latency":
                out[sp.name] = _latency_cum(snap, sp.hist, sp.threshold_s)
            else:  # gauge: accumulate bad-sample counts ourselves
                v = snap.get("gauges", {}).get(sp.gauge)
                cum = self._gauge_cum[sp.name]
                if v is not None:
                    cum[0] += 1 if float(v) > sp.gauge_max else 0
                    cum[1] += 1
                out[sp.name] = (cum[0], cum[1])
        return out

    def _windowed_burn(self, sp: SloSpec, now: float, window: float,
                       cur: tuple) -> float:
        base = self._samples[0][1].get(sp.name, (0, 0))
        for t, cums in reversed(self._samples):
            if t <= now - window:
                base = cums.get(sp.name, (0, 0))
                break
        bad = cur[0] - base[0]
        total = cur[1] - base[1]
        if total <= 0:
            return 0.0
        return (bad / total) / sp.budget

    def sample(self) -> dict:
        """One tick: read the registry, update burns/alerts, return
        {spec: {fast, slow, firing_fast, firing_slow}}."""
        reg = self._registry if self._registry is not None else _mx.registry
        snap = reg.snapshot()
        now = self.time_fn()
        with self._lock:
            cums = self._cums(snap)
            self._samples.append((now, cums))
            horizon = now - max(self.slow_window_s, self.fast_window_s) - 1.0
            while len(self._samples) > 2 and self._samples[1][0] < horizon:
                self._samples.popleft()
            state: dict = {}
            firing_total = 0
            for sp in self.specs:
                fast = self._windowed_burn(sp, now, self.fast_window_s,
                                           cums[sp.name])
                slow = self._windowed_burn(sp, now, self.slow_window_s,
                                           cums[sp.name])
                _mx.set_gauge(f"slo.burn.{sp.name}", round(fast, 4))
                _mx.set_gauge(f"slo.burn.{sp.name}.slow", round(slow, 4))
                row = {"fast": fast, "slow": slow}
                for win, burn, thr in (("fast", fast, sp.fast_burn),
                                       ("slow", slow, sp.slow_burn)):
                    key = f"{sp.name}.{win}"
                    was = self._firing.get(key, False)
                    now_firing = burn >= thr
                    self._firing[key] = now_firing
                    row[f"firing_{win}"] = now_firing
                    firing_total += 1 if now_firing else 0
                    if now_firing and not was:
                        self._alert(sp, win, burn, thr)
                state[sp.name] = row
            _mx.set_gauge("slo.alerts_firing", firing_total)
        return state

    def _alert(self, sp: SloSpec, window: str, burn: float,
               threshold: float) -> None:
        _mx.inc("slo.alerts_total")
        _mx.inc(f"slo.alerts.{sp.name}")
        rec = self._recorder
        if rec is None:
            from .events import recorder as rec
        # zero-duration marker on the Chrome trace: the alert's rising
        # edge is findable next to the spans that caused it
        with rec.span("slo.alert", slo=sp.name, window=window,
                      burn=round(burn, 3), threshold=threshold):
            pass

    # ------------------------------------------------------------ lifecycle
    def start(self, interval_s: float = 0.5) -> "SloMonitor":
        """Background sampling thread (daemon); idempotent."""
        if self._thread is not None:
            return self

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.sample()
                except Exception:  # pragma: no cover — never kill the run
                    pass

        self._stop.clear()
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="slo-monitor")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    def state(self) -> dict:
        """Latest firing state: {spec.window: bool}."""
        with self._lock:
            return dict(self._firing)

    def firing(self) -> list[str]:
        """Names (spec.window) currently over their burn threshold."""
        with self._lock:
            return sorted(k for k, v in self._firing.items() if v)
