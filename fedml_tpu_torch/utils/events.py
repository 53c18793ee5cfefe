"""Span events and metric rows: the process-wide recorder (port of
`fedml_tpu/utils/events.py`).

`recorder.span(name, **meta)` is a context manager that records the span's
name, metadata, duration and trace context into a bounded ring
(`recorder.spans`) and hands every attached sink (`recorder.sinks`, each a
callable `(kind, payload)`) the span's row; `recorder.record(span)` does
the same for a span timed elsewhere. `recorder.log(row)` appends a metric
row to a second bounded ring (`recorder.metrics`) and hands it to the
sinks. As in the JAX package:

- every span carries a trace context (trace_id / span_id / parent_id),
  inherited on its thread (`current_trace`, `trace_context` adopts one);
- a span is also a `torch.profiler.record_function` range, so spans show
  in a torch profile (resolved once, at the first span);
- both rings hold `FEDML_TPU_EVENTS_CAP` rows (default 100 000), read when
  a recorder is built; `summary()` keeps exact per-name counts past
  eviction, and every evicted span is counted by Chrome-trace track
  (`recorder.dropped`, the `events.dropped.<track>` and
  `events.dropped_total` counters; evicted metric rows in
  `recorder.dropped_rows`);
- `dump(path)` writes the rings as JSON lines, and `export_chrome_trace`
  the spans in the Chrome trace-event schema (chrome://tracing,
  ui.perfetto.dev) on four named tracks, warning when the ring was
  truncated.

Sinks are called outside the recorder's lock, so a slow sink never holds
a thread that is recording.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

logger = logging.getLogger("fedml_tpu_torch")

DEFAULT_EVENTS_CAP = 100_000


def _events_cap() -> int:
    """The ring cap, read when a recorder is built (not at import), from
    the JAX package's variable `FEDML_TPU_EVENTS_CAP`."""
    raw = os.environ.get("FEDML_TPU_EVENTS_CAP")
    if raw is None:
        return DEFAULT_EVENTS_CAP
    try:
        cap = int(raw)
        if cap < 1:
            raise ValueError(cap)
        return cap
    except ValueError:
        logger.warning("ignoring FEDML_TPU_EVENTS_CAP=%r (not a positive "
                       "integer); using %d", raw, DEFAULT_EVENTS_CAP)
        return DEFAULT_EVENTS_CAP


# torch.profiler's range annotation, resolved once at the first span
_trace_annotation: Optional[Callable] = None


def _resolve_trace_annotation() -> Callable:
    global _trace_annotation
    if _trace_annotation is None:
        try:
            from torch.profiler import record_function

            _trace_annotation = record_function
        except Exception:  # pragma: no cover: a torch without profiler
            _trace_annotation = contextlib.nullcontext
    return _trace_annotation


def _new_id() -> str:
    return os.urandom(8).hex()


# ------------------------------------------------------------ trace context
_tl = threading.local()


def current_trace() -> tuple[Optional[str], Optional[str]]:
    """(trace_id, span_id) of the innermost open span on this thread, or
    (None, None) outside any span."""
    return getattr(_tl, "trace_id", None), getattr(_tl, "span_id", None)


@contextlib.contextmanager
def trace_context(trace_id: Optional[str], span_id: Optional[str] = None):
    """Adopt a propagated trace for the current thread: spans opened inside
    stitch to `trace_id` with `span_id` as their parent. No-op when
    trace_id is falsy."""
    if not trace_id:
        yield
        return
    prev = (getattr(_tl, "trace_id", None), getattr(_tl, "span_id", None))
    _tl.trace_id, _tl.span_id = trace_id, span_id
    try:
        yield
    finally:
        _tl.trace_id, _tl.span_id = prev


class _Ring(deque):
    """Bounded deque that also takes list-style slices
    (`recorder.metrics[n0:]`)."""

    def __getitem__(self, i):
        if isinstance(i, slice):
            return list(itertools.islice(self, *i.indices(len(self))))
        return deque.__getitem__(self, i)


@dataclass
class Span:
    name: str
    start: float
    end: float = 0.0
    meta: dict = field(default_factory=dict)
    trace_id: str = ""
    span_id: str = ""
    parent_id: str = ""

    @property
    def duration(self) -> float:
        return self.end - self.start


class EventRecorder:
    """Process-wide span and metric recorder. `max_rows` bounds both rings;
    the aggregate behind `summary()` stays exact past eviction."""

    _TRACKS = ("round", "comm", "serving", "other")

    def __init__(self, max_rows: Optional[int] = None):
        if max_rows is None:
            max_rows = _events_cap()
        self.spans: _Ring = _Ring(maxlen=max_rows)
        self.metrics: _Ring = _Ring(maxlen=max_rows)
        self.sinks: list[Callable[[str, dict], None]] = []
        # the truncation ledger: spans evicted by track, metric rows evicted
        self.dropped: dict[str, int] = {t: 0 for t in self._TRACKS}
        self.dropped_rows = 0
        self._agg: dict[str, dict] = {}
        # guards the aggregate and each append / snapshot pair: iterating a
        # deque another thread appends to raises
        self._agg_lock = threading.Lock()
        # perf_counter -> wall clock: rows are orderable across processes
        self._epoch = time.time() - time.perf_counter()

    def _open_trace(self) -> tuple[str, str, str, bool]:
        parent = getattr(_tl, "span_id", None) or ""
        trace_id = getattr(_tl, "trace_id", None)
        fresh = trace_id is None
        if fresh:
            trace_id = _new_id()
        return trace_id, _new_id(), parent, fresh

    def _record(self, s: Span) -> None:
        with self._agg_lock:
            if self.spans.maxlen is not None \
                    and len(self.spans) == self.spans.maxlen:
                track = self._track_of(self.spans[0].name)
                self.dropped[track] += 1
                dropped = True
            else:
                dropped = False
            self.spans.append(s)
            agg = self._agg.setdefault(s.name, {"count": 0, "total_s": 0.0})
            agg["count"] += 1
            agg["total_s"] += s.duration
        if dropped:
            # outside the lock: the metrics registry locks on its own
            from . import metrics as _mx

            _mx.inc(f"events.dropped.{track}")
            _mx.inc("events.dropped_total")

    def _sink_payload(self, s: Span) -> dict:
        # "t", the wall-clock start, lets utils/attribution.py rebuild the
        # timeline from a finished run's events file
        out = {"name": s.name, "duration": s.duration,
               "t": round(self._epoch + s.start, 6),
               "trace_id": s.trace_id, "span_id": s.span_id}
        if s.parent_id:
            out["parent_id"] = s.parent_id
        out.update(s.meta)
        return out

    def _emit(self, s: Span) -> None:
        payload = self._sink_payload(s)
        for sink in self.sinks:
            sink("span", payload)

    @contextlib.contextmanager
    def span(self, name: str, **meta):
        ctx = _resolve_trace_annotation()(name)
        trace_id, span_id, parent, fresh = self._open_trace()
        s = Span(name, time.perf_counter(), meta=meta,
                 trace_id=trace_id, span_id=span_id, parent_id=parent)
        _tl.trace_id, _tl.span_id = trace_id, span_id
        try:
            with ctx:
                yield s
        finally:
            s.end = time.perf_counter()
            _tl.span_id = parent or None
            if fresh:
                _tl.trace_id = None
            self._record(s)
            self._emit(s)

    def record(self, s: Span) -> None:
        """Record a span timed elsewhere (its start and end on the
        perf_counter clock), stitched to this thread's open trace."""
        if not s.span_id:
            s.trace_id, s.span_id, s.parent_id, _ = self._open_trace()
        self._record(s)
        self._emit(s)

    def log_block_span(self, name: str, rounds, duration: float, **meta):
        """One span over a round block (tagged with the covered round
        range) and one sink row per round with the block's duration split
        evenly, flagged `block: true`."""
        rounds = list(rounds)
        end = time.perf_counter()
        trace_id, span_id, parent, _fresh = self._open_trace()
        s = Span(name, end - duration, end,
                 meta={"rounds": [rounds[0], rounds[-1]], **meta}
                 if rounds else dict(meta),
                 trace_id=trace_id, span_id=span_id, parent_id=parent)
        self._record(s)
        per_round = duration / max(len(rounds), 1)
        for sink in self.sinks:
            for r in rounds:
                sink("span", {"name": name, "duration": per_round,
                              "round": r, "block": True,
                              "trace_id": trace_id, "span_id": span_id,
                              **meta})

    def log(self, metrics: dict):
        with self._agg_lock:
            dropped = (self.metrics.maxlen is not None
                       and len(self.metrics) == self.metrics.maxlen)
            if dropped:
                self.dropped_rows += 1
            self.metrics.append(metrics)
        if dropped:
            from . import metrics as _mx

            _mx.inc("events.dropped_total")
        for sink in self.sinks:
            sink("metrics", metrics)

    def summary(self) -> dict:
        """Per-span-name {count, total_s}, exact past ring eviction."""
        with self._agg_lock:
            return {k: dict(v) for k, v in self._agg.items()}

    def dump(self, path: str):
        with self._agg_lock:
            spans, metrics = list(self.spans), list(self.metrics)
        with open(path, "w") as f:
            for s in spans:
                f.write(json.dumps({
                    "span": s.name, "dur": s.duration,
                    "t": round(self._epoch + s.start, 6),
                    "start": round(s.start, 9),
                    "trace_id": s.trace_id, **s.meta}) + "\n")
            for m in metrics:
                f.write(json.dumps({"metrics": m}) + "\n")

    # --------------------------------------------------- Chrome trace export
    @staticmethod
    def _track_of(name: str) -> str:
        if name.startswith(("comm.", "comm_")) or name == "comm":
            return "comm"
        if name.startswith("serving"):
            return "serving"
        if name.startswith(("train", "eval", "round", "block", "agg",
                            "local_", "fit")):
            return "round"
        return "other"

    def export_chrome_trace(self, path: str) -> str:
        """Every span in the ring as a complete ("X") Chrome trace event on
        its track's named thread, `args` holding its scalar meta and trace
        ids. A ring that evicted spans is reported as truncated: a warning
        with the counts by track, and the same counts in the process
        metadata event's args."""
        dropped = {t: n for t, n in self.dropped.items() if n}
        if dropped:
            logger.warning(
                "chrome trace is TRUNCATED: %d spans were dropped past the "
                "ring cap (%s) before this export — the oldest part of the "
                "run is missing; raise FEDML_TPU_EVENTS_CAP to keep more",
                sum(dropped.values()),
                ", ".join(f"{t}: {n}" for t, n in sorted(dropped.items())))
        tids = {t: i for i, t in enumerate(self._TRACKS)}
        meta_args: dict = {"name": "fedml_tpu_torch"}
        if dropped:
            meta_args["dropped_spans"] = dict(sorted(dropped.items()))
        events: list[dict] = [{"ph": "M", "pid": 0, "tid": 0,
                               "name": "process_name",
                               "args": meta_args}]
        for t, i in tids.items():
            events.append({"ph": "M", "pid": 0, "tid": i,
                           "name": "thread_name", "args": {"name": t}})
        with self._agg_lock:
            spans = list(self.spans)
        for s in spans:
            end = s.end if s.end else s.start
            cat = self._track_of(s.name)
            args = {k: v for k, v in s.meta.items()
                    if isinstance(v, (str, int, float, bool))}
            args["trace_id"] = s.trace_id
            args["span_id"] = s.span_id
            if s.parent_id:
                args["parent_id"] = s.parent_id
            events.append({
                "name": s.name, "cat": cat, "ph": "X", "pid": 0,
                "tid": tids[cat],
                "ts": round((self._epoch + s.start) * 1e6, 3),
                "dur": round(max(end - s.start, 0.0) * 1e6, 3),
                "args": args,
            })
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
        return path


recorder = EventRecorder()
