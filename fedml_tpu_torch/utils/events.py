"""Span recorder: a trimmed copy of `fedml_tpu/utils/events.py`.

`recorder.span(name, **meta)` is a context manager that records the
span's name, metadata and duration into a bounded ring (`recorder.spans`),
which is what the decode engine's admit and fetch spans need;
`recorder.log(row)` appends a metrics row (a simulation round, a health
flag) to a second bounded ring (`recorder.metrics`).
"""
from __future__ import annotations

import contextlib
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


class EventRecorder:
    def __init__(self, max_rows: int = 10000):
        self.spans: deque = deque(maxlen=max_rows)   # appends are atomic
        self.metrics: deque = deque(maxlen=max_rows)

    @contextlib.contextmanager
    def span(self, name: str, **meta):
        s = Span(name, time.perf_counter(), meta=meta)
        try:
            yield s
        finally:
            s.end = time.perf_counter()
            self.spans.append(s)

    def log(self, row: dict) -> None:
        self.metrics.append(row)


recorder = EventRecorder()
