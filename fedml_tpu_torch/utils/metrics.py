"""Process-local counters, gauges and fixed-bucket histograms.

A trimmed copy of `fedml_tpu/utils/metrics.py`: the instruments the
decode engine, the serving runner and the health tracker call (`inc`,
`set_gauge`, `observe`, `AtomicCounter`) and `snapshot()`, under
the same metric names, so a later slice can expose them on `/metrics`
unchanged. Instruments are guarded by one lock each: the engine thread
and request threads both write them.
"""
from __future__ import annotations

import bisect
import threading
from typing import Optional, Sequence

# latency buckets in seconds, 1 µs .. 60 s, ~1-2-5 per decade (the JAX
# package's LATENCY_BUCKETS_S)
LATENCY_BUCKETS_S = (
    1e-6, 2e-6, 5e-6, 1e-5, 2e-5, 5e-5, 1e-4, 2e-4, 5e-4,
    1e-3, 2e-3, 5e-3, 1e-2, 2e-2, 5e-2, 1e-1, 2e-1, 5e-1,
    1.0, 2.0, 5.0, 10.0, 30.0, 60.0,
)


class Counter:
    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    def value(self) -> int:
        return self._value


class Gauge:
    """Last-value-wins; plain assignment is atomic under the GIL."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value: float = 0.0

    def set(self, v: float) -> None:
        self._value = v

    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket histogram (bucket i counts values <= edges[i]; the
    last bucket is the overflow)."""

    __slots__ = ("name", "edges", "_counts", "_sum", "_n", "_max", "_lock")

    def __init__(self, name: str,
                 buckets: Sequence[float] = LATENCY_BUCKETS_S):
        self.name = name
        self.edges = tuple(buckets)
        self._counts = [0] * (len(self.edges) + 1)
        self._sum = 0.0
        self._n = 0
        self._max = float("-inf")
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            self._counts[bisect.bisect_left(self.edges, v)] += 1
            self._sum += v
            self._n += 1
            self._max = max(self._max, v)

    def snapshot(self) -> dict:
        with self._lock:
            return {"count": self._n, "sum": self._sum,
                    "max": self._max if self._n else None,
                    "edges": list(self.edges), "counts": list(self._counts)}


class AtomicCounter:
    """Lock-protected up/down counter for in-flight accounting (the
    serving runner's queue depth). `gauge` names a registry gauge updated
    INSIDE the same lock, so two finishing threads cannot reorder their
    gauge writes and leave a phantom depth behind."""

    __slots__ = ("_value", "_lock", "_gauge")

    def __init__(self, initial: int = 0, gauge: Optional[str] = None):
        self._value = int(initial)
        self._lock = threading.Lock()
        self._gauge = gauge

    def inc(self, n: int = 1) -> int:
        with self._lock:
            self._value += n
            if self._gauge is not None:
                set_gauge(self._gauge, self._value)
            return self._value

    def dec(self, n: int = 1) -> int:
        return self.inc(-n)

    def value(self) -> int:
        with self._lock:
            return self._value


class MetricsRegistry:
    def __init__(self):
        self._instruments: dict = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = cls(name)
        if not isinstance(inst, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(inst).__name__}, requested {cls.__name__}")
        return inst

    def snapshot(self) -> dict:
        """{"counters": {name: int}, "gauges": {name: float},
        "histograms": {name: {count, sum, max, edges, counts}}}"""
        with self._lock:
            items = list(self._instruments.items())
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, inst in items:
            if isinstance(inst, Counter):
                out["counters"][name] = inst.value()
            elif isinstance(inst, Gauge):
                out["gauges"][name] = inst.value()
            else:
                out["histograms"][name] = inst.snapshot()
        return out


registry = MetricsRegistry()


def inc(name: str, n: int = 1) -> None:
    registry._get(name, Counter).inc(n)


def set_gauge(name: str, v: float) -> None:
    registry._get(name, Gauge).set(v)


def observe(name: str, v: float) -> None:
    registry._get(name, Histogram).observe(v)


def snapshot() -> dict:
    return registry.snapshot()
