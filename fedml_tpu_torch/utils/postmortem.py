"""Crash flight recorder: a bounded postmortem ring, spilled on the way
down (port of `fedml_tpu/utils/postmortem.py`).

The recorder keeps an always-on bounded ring of the last spans (as an
events-recorder sink), the last comm frame headers (noted by
`comm/base.py`'s `_encode_frame` / `_decode_frame`), and a metric-counter
baseline, and writes `<run>/postmortem.json`:

- atexit and SIGTERM flush it synchronously with a reason;
- SIGKILL cannot be trapped, so an armed recorder also spills the same
  document every `spill_every_s` (temp file + rename): a SIGKILLed
  process leaves its last spill, `"reason": "inflight"`, which
  `load_postmortem` reports as a hard kill;
- an in-process kill (the cross-silo soak severing a rank) calls
  `record_kill`, which counts it and, when armed, flushes a postmortem
  naming it.

The rings cost one deque append a span or frame; I/O happens only on the
armed spill cadence and at a flush.
"""
from __future__ import annotations

import atexit
import collections
import json
import os
import signal
import threading
import time
from typing import Optional

from . import metrics as mx
from .events import recorder

POSTMORTEM_FILE = "postmortem.json"


def _jsonable(d: dict) -> dict:
    """Headers may carry non-JSON scalars: anything else is stringified,
    so a postmortem write never fails on its own payload."""
    out = {}
    for k, v in d.items():
        out[str(k)] = v if isinstance(
            v, (str, int, float, bool, type(None))) else repr(v)
    return out


class FlightRecorder:
    """Bounded postmortem state and its spill / flush. One per process
    (the module-level `flight`); `arm` points it at a run directory and
    installs the exit hooks."""

    def __init__(self, cap_spans: int = 256, cap_frames: int = 64,
                 spill_every_s: float = 1.0):
        self._spans: collections.deque = collections.deque(
            maxlen=cap_spans)
        self._frames: collections.deque = collections.deque(
            maxlen=cap_frames)
        self._lock = threading.Lock()
        self._enabled = True
        self._armed_dir: Optional[str] = None
        self.process = "main"
        self.spill_every_s = float(spill_every_s)
        self._spill_thread: Optional[threading.Thread] = None
        self._spill_stop = threading.Event()
        self._baseline: dict = {}
        self._flushed = False
        self._prev_sigterm = None
        self._atexit_registered = False
        self._t0 = time.time()

    # ------------------------------------------------------------ intake
    def set_enabled(self, on: bool) -> None:
        """Ring appends become no-ops when off."""
        self._enabled = bool(on)

    def sink(self, kind: str, payload: dict) -> None:
        """Events-recorder sink: every span row lands in the ring."""
        if self._enabled and kind == "span":
            self._spans.append(payload)

    def note_frame(self, direction: str, msg_type: str, sender,
                   receiver, nbytes: int = 0,
                   headers: Optional[dict] = None) -> None:
        """One comm frame's header (the transports' encode / decode choke
        points); payload bytes never enter the ring."""
        if self._enabled:
            self._frames.append(
                (round(time.time() - self._t0, 6), direction, msg_type,
                 sender, receiver, nbytes, headers or {}))

    # ------------------------------------------------------------- state
    @property
    def armed_dir(self) -> Optional[str]:
        return self._armed_dir

    def snapshot(self, reason: str) -> dict:
        spans = list(self._spans)
        frames = list(self._frames)
        counters = (mx.snapshot().get("counters") or {})
        deltas = {k: v - self._baseline.get(k, 0)
                  for k, v in sorted(counters.items())
                  if v != self._baseline.get(k, 0)}
        last = spans[-1] if spans else None
        return {
            "schema": 1,
            "process": self.process,
            "pid": os.getpid(),
            "t": time.time(),
            "reason": reason,
            "last_span": (last or {}).get("name"),
            "spans": spans,
            "frames": [{"t": f[0], "dir": f[1], "type": f[2],
                        "sender": f[3], "receiver": f[4], "bytes": f[5],
                        "headers": _jsonable(f[6])}
                       for f in frames],
            "metric_deltas": deltas,
        }

    # ------------------------------------------------------------- spill
    def _write(self, doc: dict) -> Optional[str]:
        d = self._armed_dir
        if d is None:
            return None
        path = os.path.join(d, POSTMORTEM_FILE)
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
            return path
        except OSError:
            return None

    def _spill_loop(self) -> None:
        while not self._spill_stop.wait(self.spill_every_s):
            if not self._flushed:
                self._write(self.snapshot("inflight"))

    def flush(self, reason: str = "manual") -> Optional[str]:
        """Synchronous final write: a flush with a reason overwrites an
        inflight spill, never the reverse."""
        with self._lock:
            self._flushed = True
            path = self._write(self.snapshot(reason))
        if path:
            mx.inc("obs.postmortem.flushes")
        return path

    # --------------------------------------------------------- arm/disarm
    def arm(self, run_dir: str, process: str = "main",
            install_handlers: bool = True) -> "FlightRecorder":
        """Point the recorder at `run_dir` and start the spill cadence.
        `install_handlers` wires atexit and SIGTERM (the signal only from
        the main thread; elsewhere the atexit hook still covers graceful
        exits)."""
        os.makedirs(run_dir, exist_ok=True)
        self._armed_dir = run_dir
        self.process = process
        self._flushed = False
        self._baseline = dict(mx.snapshot().get("counters") or {})
        if self._spill_thread is None or not self._spill_thread.is_alive():
            self._spill_stop.clear()
            self._spill_thread = threading.Thread(
                target=self._spill_loop, daemon=True,
                name="fedml-flight-spill")
            self._spill_thread.start()
        if install_handlers:
            if not self._atexit_registered:
                atexit.register(self._atexit)
                self._atexit_registered = True
            # arming again must not chain the handler to itself: the
            # handler it replaced is kept from the first install
            if signal.getsignal(signal.SIGTERM) != self._on_sigterm:
                try:
                    self._prev_sigterm = signal.signal(
                        signal.SIGTERM, self._on_sigterm)
                except ValueError:    # not the main thread
                    pass
        return self

    def disarm(self) -> None:
        self._spill_stop.set()
        if self._spill_thread is not None:
            self._spill_thread.join(timeout=2)
            self._spill_thread = None
        self._armed_dir = None
        self._flushed = False

    def _atexit(self) -> None:
        if self._armed_dir is not None and not self._flushed:
            self.flush("exit")

    def _on_sigterm(self, signum, frame) -> None:
        self.flush("sigterm")
        prev = self._prev_sigterm
        if callable(prev):
            prev(signum, frame)
        elif prev == signal.SIG_DFL:
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)


# one recorder per process, attached as an events sink at import so the
# ring is warm before anything arms it
flight = FlightRecorder()
recorder.sinks.append(flight.sink)


def arm(run_dir: str, process: str = "main",
        install_handlers: bool = True) -> FlightRecorder:
    return flight.arm(run_dir, process=process,
                      install_handlers=install_handlers)


def note_frame(direction: str, msg_type: str, sender, receiver,
               nbytes: int = 0, headers: Optional[dict] = None) -> None:
    flight.note_frame(direction, msg_type, sender, receiver, nbytes,
                      headers)


def record_kill(what: str) -> Optional[str]:
    """An in-process kill (the soak severing a rank): counted and, when
    armed, flushed as a postmortem naming the kill."""
    mx.inc("obs.postmortem.kills")
    if flight.armed_dir is not None:
        return flight.flush(f"kill:{what}")
    return None


def load_postmortem(run_dir: str) -> Optional[dict]:
    """A run dir's postmortem. An `"inflight"` spill means the process
    never reached a graceful flush: it is reported as a hard kill."""
    path = os.path.join(run_dir, POSTMORTEM_FILE)
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if doc.get("reason") == "inflight":
        doc["reason"] = "hard-kill (inflight spill; SIGKILL or crash)"
    return doc
