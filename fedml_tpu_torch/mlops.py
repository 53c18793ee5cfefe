"""The MLOps facade: the reference's observability API, local-first (port
of `fedml_tpu/mlops.py`).

(reference: python/fedml/core/mlops/__init__.py — `mlops.init(args)` :91,
`mlops.event(name, event_started, ...)` :153, `mlops.log(metrics)` :170,
`mlops.log_round_info(...)` :763, the runtime log and the sys-perf
reporters.) The same calls feed the process-wide recorder, its sinks
(`utils/sinks.py`), a per-run log file, the sys-perf sampler, the crash
flight recorder and the model-artifact store:

    import fedml_tpu_torch
    from fedml_tpu_torch import mlops
    cfg = fedml_tpu_torch.init(...)
    mlops.init(cfg)                      # sinks, log file, sysperf
    with mlops.event("train"):           # or event(..., started/ended)
        ...
    mlops.log({"acc": 0.9})
    mlops.log_round_info(rounds, r)
    mlops.finish()                       # report row, Chrome trace

`tracking_args.extra` picks the artifact store: `artifact_store` "file"
(the default when `artifact_dir` is set) or "broker", with
`artifact_dir`, `artifact_broker_id` and `artifact_keep_rounds`.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Optional

from .utils.events import recorder
from .utils.sysperf import SysPerfMonitor

_state: dict = {"sysperf": None, "log_handler": None, "events": {},
                "sinks": [], "prev_root_level": None, "artifacts": None,
                "trace_run": None, "prev_capture": None}


def init(cfg, sysperf_interval: Optional[float] = None) -> None:
    """Attach sinks, redirect runtime logs to a per-run file (reference:
    mlops_runtime_log.init_logs), and start the sys-perf daemon when
    tracking is enabled."""
    from .utils.sinks import attach_from_config

    _state["sinks"].extend(attach_from_config(cfg))
    t = cfg.tracking_args
    if t.enable_tracking and _state["log_handler"] is None:
        os.makedirs(t.log_file_dir, exist_ok=True)
        h = logging.FileHandler(
            os.path.join(t.log_file_dir, f"{t.run_name}.log"))
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))
        root = logging.getLogger()
        root.addHandler(h)
        # records must actually reach the file: lower (never raise) the root
        # level to INFO; finish() restores it
        if root.level > logging.INFO:
            _state["prev_root_level"] = root.level
            root.setLevel(logging.INFO)
        _state["log_handler"] = h
    if t.enable_tracking and _state["sysperf"] is None:
        interval = sysperf_interval if sysperf_interval is not None else \
            float(t.extra.get("sysperf_interval", 10.0))
        _state["sysperf"] = SysPerfMonitor(interval).start()
    if t.enable_tracking:
        # remembered for finish(): the Chrome trace lands beside the run's
        # log and events files
        _state["trace_run"] = (t.log_file_dir, t.run_name)
        # the crash flight recorder, armed at the run dir, so a SIGTERM'd
        # or crashed tracked run leaves <log_dir>/postmortem.json; an
        # already-armed recorder belongs to an outer harness
        from .utils import postmortem

        if postmortem.flight.armed_dir is None:
            postmortem.arm(t.log_file_dir, process=str(t.run_name))
        # a tracked run asks for the cost ledger's captures (off otherwise:
        # a capture runs a program's first call under the counting mode);
        # finish() restores the setting
        if _state["prev_capture"] is None:
            from .utils import xla_ledger

            _state["prev_capture"] = xla_ledger.set_capture(True)
    # the model-artifact store (module docstring)
    if _state["artifacts"] is None:
        kind = t.extra.get("artifact_store")
        if kind not in (None, "file", "broker"):
            raise ValueError(
                f"tracking_args.extra.artifact_store={kind!r}: choose "
                "'file' or 'broker' (a typo here would silently disable "
                "model-artifact publishing)")
        if kind == "broker":
            from .utils.artifacts import BrokerArtifactStore

            _state["artifacts"] = BrokerArtifactStore(
                broker_id=str(t.extra.get("artifact_broker_id", "default")),
                run_id=str(t.run_name),
                keep_rounds=t.extra.get("artifact_keep_rounds"))
        elif kind == "file" or t.extra.get("artifact_dir"):
            from .utils.artifacts import FileArtifactStore

            root = t.extra.get("artifact_dir") or os.path.join(
                t.log_file_dir, f"{t.run_name}_artifacts")
            _state["artifacts"] = FileArtifactStore(root)


def event(name: str, event_started: Optional[bool] = None,
          event_value: Optional[str] = None, **meta):
    """Span event. Two call styles, both from the reference:
    - context manager: `with mlops.event("train"): ...`
    - paired calls:    `mlops.event("train", event_started=True)` then
                       `mlops.event("train", event_started=False)`
    (reference: mlops_profiler_event.py:74-121)."""
    if event_started is None:
        return recorder.span(name, **({"value": event_value} if event_value
                                      else {}), **meta)
    key = (name, event_value)
    if event_started:
        _state["events"][key] = time.perf_counter()
    else:
        t0 = _state["events"].pop(key, None)
        dur = (time.perf_counter() - t0) if t0 is not None else 0.0
        recorder.log({"event": name, "value": event_value, "duration": dur})
    return None


def log(metrics: dict) -> None:
    """reference: mlops.log(:170) — round/step metric row."""
    recorder.log(dict(metrics))


def log_round_info(total_rounds: int, round_index: int) -> None:
    """reference: mlops.log_round_info(:763)."""
    recorder.log({"round_index": round_index, "total_rounds": total_rounds})


def set_artifact_store(store) -> None:
    """Set the artifact store directly: any object with put(name, tree),
    get(name) and list() (utils/artifacts.py has the file and broker
    stores)."""
    _state["artifacts"] = store


def artifact_store():
    return _state["artifacts"]


def log_aggregated_model_info(round_idx: int, model_params) -> None:
    """Publish the round's aggregated global model (reference:
    core/mlops/__init__.py:388 — uploaded every round; serving loads it
    back). No-op when no artifact store is configured, like the reference
    when tracking is off."""
    store = _state["artifacts"]
    if store is None:
        return
    from .utils.artifacts import aggregated_name

    store.put(aggregated_name(round_idx), model_params)


def log_client_model_info(round_idx: int, client_rank: int,
                          model_params) -> None:
    """Publish one client's locally-trained model (reference:
    core/mlops/__init__.py:475 — client models on cadence)."""
    store = _state["artifacts"]
    if store is None:
        return
    from .utils.artifacts import client_name

    store.put(client_name(round_idx, client_rank), model_params)


def fetch_aggregated_model(round_idx: int):
    """Collector side: load the round-N aggregated model back from the
    artifact store (the reference fetches the S3 object by round)."""
    store = _state["artifacts"]
    if store is None:
        raise RuntimeError("no artifact store configured — call mlops.init "
                           "with tracking_args.extra.artifact_dir/"
                           "artifact_store, or set_artifact_store()")
    from .utils.artifacts import aggregated_name

    return store.get(aggregated_name(round_idx))


def system_stats() -> dict:
    from .utils.sysperf import sample_sysperf

    return sample_sysperf()


def metrics_snapshot() -> dict:
    """Every process-wide counter, gauge and histogram (utils/metrics.py):
    comm bytes and latency, serving request histograms."""
    from .utils import metrics

    return metrics.snapshot()


def prometheus_text() -> str:
    """The metrics snapshot as Prometheus text: what /metrics serves
    (utils/prometheus.py, `common_args.extra.metrics_port`) to scrapers
    and `python -m fedml_tpu_torch top`."""
    from .utils.prometheus import render_prometheus

    return render_prometheus()


def export_chrome_trace(path: str) -> str:
    """Write the recorder's spans as a Chrome-trace/Perfetto JSON
    (utils/events.py EventRecorder.export_chrome_trace)."""
    return recorder.export_chrome_trace(path)


def _finish_report() -> None:
    """The end-of-run summary row to the sinks, then the Chrome trace and
    the final postmortem of a tracked run."""
    # the measured MFU (span wall over the ledger's FLOPs) and the
    # round-time budget as gauges before the snapshot below, so the report
    # row and Prometheus carry them
    try:
        from .utils import attribution, xla_ledger

        xla_ledger.measured_mfu()
        attribution.analyze_and_publish()
    except Exception as e:  # noqa: BLE001 — attribution must not block exit
        logging.getLogger(__name__).warning(
            "attribution publish failed: %s: %s", type(e).__name__, e)
    # gate on recorder.sinks, not _state["sinks"]: init attaches the
    # config's sinks itself, so this run's JsonlSink may predate mlops.init
    if recorder.sinks:
        try:
            recorder.log({"report": {"spans": recorder.summary(),
                                     "metrics": metrics_snapshot()}})
        except Exception as e:  # noqa: BLE001 — a summary must not block exit
            logging.getLogger(__name__).warning(
                "end-of-run summary failed: %s: %s", type(e).__name__, e)
    run = _state["trace_run"]
    _state["trace_run"] = None
    if run is not None:
        try:
            recorder.export_chrome_trace(
                os.path.join(run[0], f"{run[1]}.trace.json"))
        except Exception as e:  # noqa: BLE001
            logging.getLogger(__name__).warning(
                "chrome-trace export failed: %s: %s", type(e).__name__, e)
        # a clean finish writes the final postmortem (reason "finish") and
        # stops the spill: no stale "inflight" document for report to read
        # as a hard kill
        try:
            from .utils import postmortem

            if postmortem.flight.armed_dir == run[0]:
                postmortem.flight.flush("finish")
                postmortem.flight.disarm()
        except Exception as e:  # noqa: BLE001 — never block run teardown
            logging.getLogger(__name__).warning(
                "postmortem flush failed: %s: %s", type(e).__name__, e)


def finish() -> None:
    """Emit the end-of-run summary and Chrome trace, stop the sampler,
    detach this run's sinks and log handler, restore the root log
    level."""
    from .utils.sinks import flush_sinks

    run = _state["trace_run"]     # before _finish_report clears it
    _finish_report()
    flush_sinks()   # a BrokerLogSink's tail batch ships here
    if _state["sysperf"] is not None:
        _state["sysperf"].stop()
        _state["sysperf"] = None
    for sink in _state["sinks"]:
        if sink in recorder.sinks:
            recorder.sinks.remove(sink)
        getattr(sink, "close", lambda: None)()
    _state["sinks"].clear()
    if run is not None:
        # init may have attached this run's sinks before mlops.init (so
        # _state["sinks"] never saw them): left attached, they would write
        # every later span to the finished run's file
        log_dir, run_name = os.path.abspath(run[0]), run[1]
        for sink in list(recorder.sinks):
            key = getattr(sink, "_attach_key", None)
            if (isinstance(key, tuple) and key and key[-1] == run_name
                    and (len(key) != 2 or key[0] in (log_dir, "wandb"))):
                recorder.sinks.remove(sink)
                getattr(sink, "close", lambda: None)()
    root = logging.getLogger()
    if _state["log_handler"] is not None:
        root.removeHandler(_state["log_handler"])
        _state["log_handler"].close()
        _state["log_handler"] = None
    if _state["prev_root_level"] is not None:
        root.setLevel(_state["prev_root_level"])
        _state["prev_root_level"] = None
    if _state["prev_capture"] is not None:
        from .utils import xla_ledger

        xla_ledger.set_capture(_state["prev_capture"])
        _state["prev_capture"] = None
    _state["artifacts"] = None
