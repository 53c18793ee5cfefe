"""The port's span recorder and sinks (`fedml_tpu_torch/utils/events.py`,
`utils/sinks.py`) against the JAX package's: the same span and row
sequences through both give the same sink rows, the same exact summary
past eviction, the same dump rows and the same Chrome trace (timestamps
and ids aside) with the same truncation ledger."""
import json
import threading
import time
import uuid

import numpy as np
import pytest
import torch

from fedml_tpu.utils import events as jev
from fedml_tpu.utils import sinks as jsinks
from fedml_tpu_torch.utils import events as pev
from fedml_tpu_torch.utils import metrics as pmx
from fedml_tpu_torch.utils import postmortem  # noqa: F401 (its always-on sink)
from fedml_tpu_torch.utils import sinks as psinks

torch.set_num_threads(2)

# volatile fields: clocks and random ids
_VOLATILE = {"t", "duration", "dur", "start", "ts", "trace_id", "span_id",
             "parent_id"}


@pytest.fixture(autouse=True)
def _isolate_port_recorder():
    """The port's process-wide recorder: sinks and rings restored after
    each test."""
    rec = pev.recorder
    spans, metrics, sinks = list(rec.spans), list(rec.metrics), list(
        rec.sinks)
    yield
    rec.spans.clear()
    rec.spans.extend(spans)
    rec.metrics.clear()
    rec.metrics.extend(metrics)
    rec.sinks[:] = sinks


def _sequence(rng):
    """A seeded sequence of (kind, name, meta) over every track."""
    names = ["train", "eval", "agg", "comm.send.c2s", "comm.handle.s2c",
             "serving.request", "fed.ingest.put", "other.thing",
             "round.drive", "local_step"]
    out = []
    for i in range(40):
        if rng.random() < 0.25:
            out.append(("log", None, {"round": int(i), "acc": float(
                np.round(rng.random(), 4))}))
        else:
            out.append(("span", names[rng.integers(len(names))],
                        {"round": int(rng.integers(5)), "i": i}))
    return out


def _drive(rec, seq):
    for kind, name, meta in seq:
        if kind == "log":
            rec.log(dict(meta))
        else:
            with rec.span(name, **meta):
                pass


def _strip(row: dict) -> dict:
    return {k: v for k, v in row.items() if k not in _VOLATILE}


def test_sink_rows_match_jax():
    seq = _sequence(np.random.default_rng(0))
    got = {"port": [], "jax": []}
    for tag, mod in (("port", pev), ("jax", jev)):
        rec = mod.EventRecorder(max_rows=1000)
        rec.sinks.append(lambda k, p, tag=tag: got[tag].append((k, dict(p))))
        _drive(rec, seq)
        with rec.span("outer", round=9):
            with rec.span("inner"):
                pass
        rec.log_block_span("train", [3, 4, 5], 0.6, block_tag=1)
    assert [(k, _strip(p)) for k, p in got["port"]] == \
        [(k, _strip(p)) for k, p in got["jax"]]
    # every span row carries a wall-clock "t" and its trace ids
    rows = [p for k, p in got["port"] if k == "span" and "block" not in p]
    assert all(abs(p["t"] - time.time()) < 60 and p["span_id"]
               for p in rows)
    span_in = next(p for p in rows if p["name"] == "inner")
    span_out = next(p for p in rows if p["name"] == "outer")
    assert span_in["parent_id"] == span_out["span_id"]
    assert span_in["trace_id"] == span_out["trace_id"]


def test_summary_exact_past_eviction_and_ledger():
    seq = _sequence(np.random.default_rng(1))
    recs = {}
    for tag, mod in (("port", pev), ("jax", jev)):
        rec = mod.EventRecorder(max_rows=10)
        _drive(rec, seq)
        recs[tag] = rec
    p, j = recs["port"], recs["jax"]
    assert {k: v["count"] for k, v in p.summary().items()} == \
        {k: v["count"] for k, v in j.summary().items()}
    assert sum(v["count"] for v in p.summary().values()) == \
        sum(kind == "span" for kind, _, _ in seq)
    assert p.dropped == j.dropped and sum(p.dropped.values()) > 0
    assert p.dropped_rows == j.dropped_rows
    assert len(p.spans) == len(p.metrics) == 10
    assert p.metrics[2:4] == j.metrics[2:4]       # list-style slices
    assert [s.name for s in p.spans] == [s.name for s in j.spans]


def test_eviction_counters():
    before = pmx.snapshot()["counters"]
    rec = pev.EventRecorder(max_rows=2)
    for name in ("comm.a", "comm.b", "serving.x", "train", "other"):
        with rec.span(name):
            pass
    after = pmx.snapshot()["counters"]

    def delta(k):
        return after.get(k, 0) - before.get(k, 0)

    assert rec.dropped == {"round": 0, "comm": 2, "serving": 1, "other": 0}
    assert delta("events.dropped.comm") == 2
    assert delta("events.dropped.serving") == 1
    assert delta("events.dropped_total") == 3


def test_dump_rows_match_jax(tmp_path):
    seq = _sequence(np.random.default_rng(2))
    rows = {}
    for tag, mod in (("port", pev), ("jax", jev)):
        rec = mod.EventRecorder()
        _drive(rec, seq)
        path = tmp_path / f"{tag}.jsonl"
        rec.dump(str(path))
        rows[tag] = [json.loads(x) for x in path.read_text().splitlines()]
    assert [_strip(r) for r in rows["port"]] == [_strip(r) for r in
                                                 rows["jax"]]
    spans = [r for r in rows["port"] if "span" in r]
    assert all(a["start"] <= b["start"] for a, b in zip(spans, spans[1:]))
    assert abs(spans[0]["t"] - time.time()) < 60


def test_chrome_trace_matches_jax_with_truncation(tmp_path, caplog):
    seq = _sequence(np.random.default_rng(3))
    docs = {}
    for tag, mod in (("port", pev), ("jax", jev)):
        rec = mod.EventRecorder(max_rows=16)
        _drive(rec, seq)
        path = tmp_path / f"{tag}.trace.json"
        with caplog.at_level("WARNING"):
            rec.export_chrome_trace(str(path))
        docs[tag] = json.loads(path.read_text())
    assert "TRUNCATED" in caplog.text
    p, j = docs["port"], docs["jax"]
    assert p["displayTimeUnit"] == j["displayTimeUnit"] == "ms"

    def shape(doc):
        return [{k: (_strip(v) if k == "args" else v)
                 for k, v in e.items() if k not in _VOLATILE}
                for e in doc["traceEvents"]]

    # the process is named after the package that wrote the trace
    assert p["traceEvents"][0]["args"].pop("name") == "fedml_tpu_torch"
    assert j["traceEvents"][0]["args"].pop("name") == "fedml_tpu"
    assert shape(p) == shape(j)
    meta = p["traceEvents"][0]
    assert meta["name"] == "process_name" and meta["args"]["dropped_spans"]
    tracks = {e["args"]["name"] for e in p["traceEvents"]
              if e["ph"] == "M" and e["name"] == "thread_name"}
    assert tracks == {"round", "comm", "serving", "other"}
    xs = [e for e in p["traceEvents"] if e["ph"] == "X"]
    assert len(xs) == 16 and all(e["dur"] >= 0 and e["args"]["trace_id"]
                                 for e in xs)


def test_trace_context_threads_and_adoption():
    rec = pev.EventRecorder()
    seen = {}

    def worker():
        seen["worker"] = pev.current_trace()
        with pev.trace_context("feedbeef", "parent01"):
            with rec.span("comm.handle.x") as s:
                seen["adopted"] = (s.trace_id, s.parent_id)
        seen["after"] = pev.current_trace()

    with rec.span("round.drive") as outer:
        assert pev.current_trace() == (outer.trace_id, outer.span_id)
        th = threading.Thread(target=worker)
        th.start()
        th.join()
    assert pev.current_trace() == (None, None)
    assert seen["worker"] == (None, None)     # thread-local, not inherited
    assert seen["adopted"] == ("feedbeef", "parent01")
    assert seen["after"] == (None, None)


@pytest.mark.parametrize("raw,want", [(None, 100_000), ("7", 7),
                                      ("0", 100_000), ("x", 100_000)])
def test_events_cap_variable_as_jax(monkeypatch, raw, want):
    if raw is None:
        monkeypatch.delenv("FEDML_TPU_EVENTS_CAP", raising=False)
    else:
        monkeypatch.setenv("FEDML_TPU_EVENTS_CAP", raw)
    assert pev._events_cap() == jev._events_cap() == want
    assert pev.EventRecorder().spans.maxlen == want


def test_jsonl_sink_rows_match_jax(tmp_path):
    seq = _sequence(np.random.default_rng(4))
    rows = {}
    for tag, ev, sk in (("port", pev, psinks), ("jax", jev, jsinks)):
        rec = ev.EventRecorder()
        sink = sk.JsonlSink(str(tmp_path / tag), "run")
        rec.sinks.append(sink)
        _drive(rec, seq)
        rec.log({"obj": object()})    # not JSON: repr'd, as in JAX
        sink.close()
        rows[tag] = [json.loads(x) for x in
                     (tmp_path / tag / "run.events.jsonl").read_text()
                     .splitlines()]
    strip = [[_strip(r) for r in rows[t]] for t in ("port", "jax")]
    for r in strip[0] + strip[1]:
        if "obj" in r:
            r["obj"] = r["obj"].split(" at ")[0]
    assert strip[0] == strip[1]
    assert {r["kind"] for r in rows["port"]} == {"span", "metrics"}


def test_attach_from_config_idempotent(tmp_path):
    import fedml_tpu_torch
    from fedml_tpu_torch import mlops

    rec = pev.recorder
    n0 = len(rec.sinks)
    cfg = fedml_tpu_torch.init(config={"tracking_args": {
        "enable_tracking": True, "log_file_dir": str(tmp_path),
        "run_name": "idem", "extra": {"sysperf_interval": 60.0}}},
        device="cpu")
    try:
        assert len(rec.sinks) == n0 + 1      # init attached the JSONL sink
        mlops.init(cfg)
        mlops.init(cfg)
        assert psinks.attach_from_config(cfg) == []
        assert len(rec.sinks) == n0 + 1
    finally:
        mlops.finish()
    assert len(rec.sinks) == n0            # finish detached this run's sink


def test_wandb_sink_gated_as_jax(tmp_path):
    """enable_wandb with no wandb importable: the run is tracked locally
    only, in both packages."""
    import importlib.util

    if importlib.util.find_spec("wandb") is not None:
        pytest.skip("wandb is installed here")
    t = {"enable_tracking": True, "enable_wandb": True,
         "log_file_dir": str(tmp_path), "run_name": "wb"}
    from fedml_tpu.config import Config as JaxConfig
    from fedml_tpu_torch.config import Config

    got = [type(s).__name__ for s in psinks.attach_from_config(
        Config.from_dict({"tracking_args": t}))]
    n0 = len(jev.recorder.sinks)
    want = [type(s).__name__ for s in jsinks.attach_from_config(
        JaxConfig.from_dict({"tracking_args": t}))]
    for s in pev.recorder.sinks[:]:
        if getattr(s, "_attach_key", (None,))[-1] == "wb":
            pev.recorder.sinks.remove(s)
            s.close()
    for s in jev.recorder.sinks[n0:]:
        s.close()
    del jev.recorder.sinks[n0:]
    assert got == want == ["JsonlSink"]


def test_collect_logs_drains_broker_tail_as_jax(tmp_path):
    """Rows below the batch size ship only on flush; the collector drains
    them in order, and appends them to <out_dir>/<run>.collected.jsonl."""
    from fedml_tpu.comm.broker import release_broker as jrelease
    from fedml_tpu_torch.comm.broker import release_broker

    got = {}
    for tag, ev, sk, rel in (("port", pev, psinks, release_broker),
                             ("jax", jev, jsinks, jrelease)):
        bid = f"telem-logs-{uuid.uuid4().hex[:6]}"
        sink = sk.BrokerLogSink("tail", broker_id=bid, source="s1",
                                batch_size=50)
        ev.recorder.sinks.append(sink)
        try:
            ev.recorder.log({"acc": 0.1})
            ev.recorder.log({"acc": 0.2})
            assert sk.collect_logs("tail", broker_id=bid) == []
            sk.flush_sinks()
            got[tag] = sk.collect_logs("tail", broker_id=bid,
                                       out_dir=str(tmp_path / tag))
        finally:
            ev.recorder.sinks.remove(sink)
            rel(bid)
    assert [_strip(r) for r in got["port"]] == [_strip(r) for r in
                                                got["jax"]]
    assert [r["acc"] for r in got["port"]] == [0.1, 0.2]
    assert all(r["source"] == "s1" for r in got["port"])
    lines = (tmp_path / "port" / "tail.collected.jsonl").read_text()
    assert len(lines.splitlines()) == 2
