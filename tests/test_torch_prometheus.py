"""The port's Prometheus exposition (`fedml_tpu_torch.utils.prometheus`)
and its registry snapshot against the JAX package's, on the CPU.

The same counter, gauge and histogram operations on a fresh registry in
each package render byte-equal text, and `parse_prometheus` of either
text gives equal dicts; the histogram snapshot (sum and max rounded to 9
places, p50 / p99 from the bucket counts) is JAX's. The exporter, the
Simulator's `metrics_port` and the HTTP runner's /metrics serve it.
"""
import http.client
import math

import numpy as np
import pytest
import torch

from fedml_tpu.utils import metrics as jmx
from fedml_tpu.utils import prometheus as jprom

import fedml_tpu_torch
from fedml_tpu_torch.serving.inference_runner import FedMLInferenceRunner
from fedml_tpu_torch.simulation.simulator import Simulator
from fedml_tpu_torch.utils import metrics as mx
from fedml_tpu_torch.utils import prometheus as prom

torch.set_num_threads(2)

OBS = [3e-7, 1e-6, 4.2e-4, 0.013, 0.7, 0.7, 2.5, 75.0, 1e-3 / 3]


def _drive(counter, gauge, histogram):
    """One script of metric operations, given each package's accessors."""
    counter("comm.loopback.bytes_sent").inc(1024)
    counter("comm.loopback.bytes_sent").inc(7)
    counter("fed.rounds_total").inc()
    counter("serving.requests").inc(3)
    gauge("fed.epoch").set(2.0)
    gauge("serving.kv_pages_free").set(17)
    gauge("weird-name.9x").set(0.1 + 0.2)
    gauge("big").set(1e16)
    for v in OBS:
        histogram("serving.request_s").observe(v)
    histogram("comm.link.1.0.rtt_ms", mx.RTT_BUCKETS_MS).observe(0.3)
    histogram("empty_s")


def _both():
    jreg, reg = jmx.MetricsRegistry(), mx.MetricsRegistry()
    _drive(jreg.counter, jreg.gauge, jreg.histogram)
    _drive(lambda n: reg._get(n, mx.Counter),
           lambda n: reg._get(n, mx.Gauge), reg.histogram)
    return jreg.snapshot(), reg.snapshot()


def test_histogram_snapshot_equals_jax():
    jsnap, snap = _both()
    assert snap["histograms"] == jsnap["histograms"]
    h = snap["histograms"]["serving.request_s"]
    assert h["p50"] == 0.02 and h["p99"] == 75.0 and h["max"] == 75.0
    assert snap["histograms"]["empty_s"]["p50"] is None
    for q in (0.0, 0.25, 0.5, 0.9, 1.0):
        assert mx.percentile_from_counts(h["edges"], h["counts"], q) == \
            jmx.percentile_from_counts(h["edges"], h["counts"], q)


def test_rendered_text_byte_equal_and_parses_alike():
    jsnap, snap = _both()
    text = prom.render_prometheus(snap)
    assert text == jprom.render_prometheus(jsnap)
    assert text == jprom.render_prometheus(snap)
    parsed = prom.parse_prometheus(text)
    assert parsed == jprom.parse_prometheus(text)
    assert parsed["counters"]["comm_loopback_bytes_sent_total"] == 1031
    assert parsed["gauges"]["weird_name_9x"] == 0.1 + 0.2
    hist = parsed["histograms"]["serving_request_s"]
    assert hist["count"] == len(OBS)
    assert prom.histogram_percentile(hist["buckets"], 0.5) == \
        jprom.histogram_percentile(hist["buckets"], 0.5)
    # labels: a process label on every sample, split back per process
    lab = prom.render_prometheus(snap, labels={"process": 'a"b'})
    assert lab == jprom.render_prometheus(jsnap, labels={"process": 'a"b'})
    split = prom.split_by_label(prom.parse_prometheus(lab))
    assert split == jprom.split_by_label(jprom.parse_prometheus(lab))
    assert set(split) == {'a"b'}
    assert split['a"b']["counters"] == parsed["counters"]
    with pytest.raises(ValueError, match="malformed sample"):
        prom.parse_prometheus("bad sample line here\n")


def _get(url_port: int, path: str = "/metrics"):
    conn = http.client.HTTPConnection("127.0.0.1", url_port, timeout=30)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = resp.read().decode()
    conn.close()
    return resp.status, resp.getheader("Content-Type"), body


def test_exporter_serves_the_registry():
    mx.inc("test.prometheus.exporter_hits", 5)
    exp = prom.MetricsExporter(port=0).start()
    try:
        code, ctype, body = _get(exp.port)
        assert code == 200 and ctype == prom.CONTENT_TYPE
        got = prom.parse_prometheus(body)["counters"]
        assert got["test_prometheus_exporter_hits_total"] >= 5
        assert _get(exp.port, "/other")[0] == 404
        assert exp.url == f"http://127.0.0.1:{exp.port}/metrics"
    finally:
        exp.stop()


@pytest.fixture
def fresh_exporter():
    old, prom._exporter = prom._exporter, None
    yield
    if prom._exporter is not None:
        prom._exporter.stop()
    prom._exporter = old


def test_simulator_metrics_port_serves(fresh_exporter, tmp_path):
    cfg = fedml_tpu_torch.init(config={
        "common_args": {"metrics_port": 0},
        "data_args": {"dataset": "synthetic",
                      "data_cache_dir": str(tmp_path),
                      "extra": {"synthetic_samples_per_client": 16}},
        "model_args": {"model": "lr"},
        "train_args": {"client_num_in_total": 2, "client_num_per_round": 2,
                       "comm_round": 1, "batch_size": 8},
        "validation_args": {"frequency_of_the_test": 0}}, device="cpu")
    sim = Simulator(cfg)
    exp = sim.metrics_exporter
    assert exp is not None and exp is prom.current_exporter()
    sim.run()
    code, _ctype, body = _get(exp.port)
    assert code == 200
    assert prom.parse_prometheus(body)["counters"]
    # one exporter a process: a second engine reuses it
    assert Simulator(cfg).metrics_exporter is exp
    for bad in (True, -1, 70000, "x", 1.5):
        with pytest.raises(ValueError, match="metrics_port"):
            fedml_tpu_torch.init(config={
                "common_args": {"metrics_port": bad}}, device="cpu")


class _Echo:
    def predict(self, body):
        return {"echo": body.get("x")}


def test_runner_metrics_route():
    runner = FedMLInferenceRunner(_Echo(), port=0).start()
    try:
        mx.observe("serving.test_route_s", 0.02)
        code, ctype, body = _get(runner.port)
        assert code == 200 and ctype == prom.CONTENT_TYPE
        h = prom.parse_prometheus(body)["histograms"]["serving_test_route_s"]
        assert h["count"] >= 1 and not math.isnan(h["sum"])
        assert np.isclose(prom.histogram_percentile(h["buckets"], 0.5), 0.02)
    finally:
        runner.stop()
