"""Span recorder: a trimmed copy of `fedml_tpu/utils/events.py`.

`recorder.span(name, **meta)` is a context manager that records the
span's name, metadata and duration into a bounded ring (`recorder.spans`),
which is what the decode engine's admit and fetch spans need;
`recorder.record(span)` appends a span timed elsewhere. `recorder.dropped`
counts the spans the ring evicted, so a reader can tell a missing span
from one the ring no longer holds. `recorder.log(row)` appends a metrics
row (a simulation round, a health flag) to a second bounded ring
(`recorder.metrics`). Both rings hold the JAX recorder's default of
`DEFAULT_EVENTS_CAP` rows.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from dataclasses import dataclass, field


@dataclass
class Span:
    name: str
    start: float
    end: float = 0.0
    meta: dict = field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.end - self.start


DEFAULT_EVENTS_CAP = 100_000


class EventRecorder:
    def __init__(self, max_rows: int = DEFAULT_EVENTS_CAP):
        self.spans: deque = deque(maxlen=max_rows)   # appends are atomic
        self.metrics: deque = deque(maxlen=max_rows)
        self.dropped = 0
        self._lock = threading.Lock()

    def record(self, s: Span) -> None:
        with self._lock:
            if len(self.spans) == self.spans.maxlen:
                self.dropped += 1
            self.spans.append(s)

    @contextlib.contextmanager
    def span(self, name: str, **meta):
        s = Span(name, time.perf_counter(), meta=meta)
        try:
            yield s
        finally:
            s.end = time.perf_counter()
            self.record(s)

    def log(self, row: dict) -> None:
        self.metrics.append(row)


recorder = EventRecorder()
