"""Metric and event sinks for the process-wide recorder (port of
`fedml_tpu/utils/sinks.py`).

- `JsonlSink`: an append-only `<log_dir>/<run_name>.events.jsonl`, one
  JSON object a span or metric row, flushed a write so a killed run keeps
  its telemetry.
- `WandbSink`: metric rows to wandb, when `tracking_args.enable_wandb` is
  set and wandb imports; otherwise the run is tracked locally only.
- `BrokerLogSink`: rows batched onto the broker topic `fedml_logs_<run>`
  (`comm/broker.py`); `collect_logs` drains it on the collector's side.

`attach_from_config` (called by `fedml_tpu_torch.init`) registers the sinks
`tracking_args` asks for, once per key, so a tracked run writes its
telemetry with no user code.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

from .events import recorder


class JsonlSink:
    """Append JSON-lines events to <dir>/<run_name>.events.jsonl."""

    def __init__(self, log_dir: str, run_name: str = "fedml_tpu_run"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{run_name}.events.jsonl")
        self._lock = threading.Lock()
        self._f = open(self.path, "a")

    def __call__(self, kind: str, payload: dict) -> None:
        row = {"t": time.time(), "kind": kind, **_jsonable(payload)}
        with self._lock:
            self._f.write(json.dumps(row) + "\n")
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            self._f.close()


class WandbSink:
    def __init__(self, run_name: str, config: Optional[dict] = None):
        import wandb  # gated: raises ImportError when not installed

        self._wandb = wandb
        self._run = wandb.init(project="fedml_tpu_torch", name=run_name,
                               config=config or {})

    def __call__(self, kind: str, payload: dict) -> None:
        if kind == "metrics":
            self._wandb.log(_jsonable(payload))


class BrokerLogSink:
    """Ships rows off the box through the broker (the log-upload leg of
    the reference's log daemon, core/mlops/mlops_runtime_log_daemon.py):
    rows are batched and published as JSON frames on topic
    `fedml_logs_<run>`, store-and-forward, so they survive a collector's
    downtime; `collect_logs` is the collector's drain."""

    def __init__(self, run_name: str, broker_id: str = "default",
                 source: str = "", batch_size: int = 20):
        from ..comm.broker import get_broker

        self.broker = get_broker(broker_id)
        self.topic = f"fedml_logs_{run_name}"
        self.source = source
        self.batch_size = batch_size
        self._buf: list[dict] = []
        self._lock = threading.Lock()

    def __call__(self, kind: str, payload: dict) -> None:
        row = {"t": time.time(), "kind": kind, "source": self.source,
               **_jsonable(payload)}
        with self._lock:
            self._buf.append(row)
            if len(self._buf) >= self.batch_size:
                self._flush_locked()

    def _flush_locked(self) -> None:
        if self._buf:
            self.broker.publish(self.topic, json.dumps(self._buf).encode())
            self._buf = []

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    close = flush


def collect_logs(run_name: str, broker_id: str = "default",
                 out_dir: Optional[str] = None,
                 timeout: float = 0.05) -> list[dict]:
    """The collector's drain of a run's shipped rows. Returns them, and
    appends them to <out_dir>/<run_name>.collected.jsonl when out_dir is
    given."""
    from ..comm.broker import get_broker

    broker = get_broker(broker_id)
    topic = f"fedml_logs_{run_name}"
    rows: list[dict] = []
    while True:
        frame = broker.poll(topic, timeout=timeout)
        if frame is None:
            break
        rows.extend(json.loads(frame))
    if out_dir and rows:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{run_name}.collected.jsonl"),
                  "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return rows


def _jsonable(d: dict) -> dict:
    out = {}
    for k, v in d.items():
        try:
            json.dumps(v)
            out[k] = v
        except TypeError:
            out[k] = repr(v)
    return out


def flush_sinks() -> None:
    """Flush every attached sink that buffers (a BrokerLogSink's tail
    batch ships only here). Called by the Simulator at the end of a run
    and by mlops.finish."""
    for s in list(recorder.sinks):
        getattr(s, "flush", lambda: None)()


def attach_from_config(cfg) -> list:
    """Register the sinks `tracking_args` asks for; returns the ones
    attached now. Idempotent per key ((dir, run_name), ("wandb", run),
    ("broker", id, run)): a repeated init does not log twice."""
    t = cfg.tracking_args
    attached = []
    if not t.enable_tracking:
        return attached
    key = (os.path.abspath(t.log_file_dir), t.run_name)
    existing = {getattr(s, "_attach_key", None) for s in recorder.sinks}
    if key not in existing:
        sink = JsonlSink(t.log_file_dir, t.run_name)
        sink._attach_key = key
        recorder.sinks.append(sink)
        attached.append(sink)
    wkey = ("wandb", t.run_name)
    if t.enable_wandb and wkey not in existing:
        try:
            wsink = WandbSink(t.run_name)
            wsink._attach_key = wkey
            recorder.sinks.append(wsink)
            attached.append(wsink)
        except Exception:  # wandb absent or offline: tracked locally only
            pass
    # off-box shipping: tracking_args.extra.log_upload_broker names the
    # broker id; a collector drains with collect_logs
    bid = t.extra.get("log_upload_broker")
    bkey = ("broker", str(bid), t.run_name)
    if bid and bkey not in existing:
        bsink = BrokerLogSink(t.run_name, broker_id=str(bid),
                              source=t.extra.get("log_source", ""))
        bsink._attach_key = bkey
        recorder.sinks.append(bsink)
        attached.append(bsink)
    return attached
