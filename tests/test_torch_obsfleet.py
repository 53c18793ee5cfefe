"""Fleet observability (`fedml_tpu_torch/utils/obsfleet.py`) held against
the JAX package's `utils/obsfleet.py` on the same inputs:

- `merge_traces` on the same trace files gives the same events, flows,
  offsets, clamp counts and merged document (the midpoint, infeasible,
  one-direction and unpaired cases of tests/test_obsfleet.py);
- `fleet_sums`, the stale marks and self-registration behave as JAX's;
- `validate_obs_fleet` accepts and rejects the same inputs, also at
  config load;
- two real processes on gRPC merge with zero ordering violations.
"""
import json
import os
import subprocess
import sys
import time
import uuid
from pathlib import Path

import pytest
import torch

from fedml_tpu.utils import obsfleet as jof
from fedml_tpu_torch.utils import obsfleet as pof
from fedml_tpu_torch.utils import metrics as pmx
from fedml_tpu_torch.utils.prometheus import (parse_prometheus,
                                              render_prometheus,
                                              split_by_label)

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent

_SNAP = {
    "counters": {"fed.rounds": 3, "serving.requests": 11},
    "gauges": {"fed.round.current": 2.0},
    "histograms": {"fed.round_s": {"count": 3, "sum": 0.75,
                                   "edges": [0.1, 0.5],
                                   "counts": [1, 2, 0]}},
}


def _trace(tmp_path, name, events):
    p = tmp_path / f"{name}.trace.json"
    p.write_text(json.dumps({"traceEvents": events}))
    return str(p)


def _send(ts, span_id, peer, dur=10):
    return {"ph": "X", "name": "comm.send.ping", "ts": ts, "dur": dur,
            "pid": 0, "tid": 1, "args": {"span_id": span_id,
                                         "receiver": peer}}


def _handle(ts, parent_id, dur=10):
    return {"ph": "X", "name": "comm.handle.ping", "ts": ts, "dur": dur,
            "pid": 0, "tid": 2, "args": {"parent_id": parent_id}}


_CASES = {
    # B's clock 100 ms ahead, one message each way: the midpoint
    "midpoint": ([_send(1000, "sA1", 1), _handle(5000, "sB1")],
                 [_handle(101500, "sA1"), _send(104800, "sB1", 0)]),
    # the two bounds cross: no offset fits, both receives clamp
    "infeasible": ([_send(1000, "sA1", 1), _handle(5000, "sB1")],
                   [_handle(100100, "sA1"), _send(104800, "sB1", 0)]),
    "one_direction": ([_send(1000, "sA1", 1)], [_handle(101500, "sA1")]),
    "unpaired": ([_send(1000, "sA1", 1)],
                 [{"ph": "X", "name": "train", "ts": 50, "dur": 5,
                   "pid": 0, "tid": 0, "args": {}}]),
    # three processes, a chain A -> B -> C and back
    "chain": ([_send(10, "a1", 1), _handle(900, "c1")],
              [_handle(5020, "a1"), _send(5100, "b1", 2)],
              [_handle(20200, "b1"), _send(20300, "c1", 0)]),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_merge_traces_equals_jax(tmp_path, case):
    procs = [(n, _trace(tmp_path, n, evs))
             for n, evs in zip("ABC", _CASES[case])]
    out_p, out_j = str(tmp_path / "p.json"), str(tmp_path / "j.json")
    res_p = pof.merge_traces(procs, out_path=out_p)
    res_j = jof.merge_traces(procs, out_path=out_j)
    assert {k: v for k, v in res_p.items() if k != "out"} == \
        {k: v for k, v in res_j.items() if k != "out"}
    assert Path(out_p).read_bytes() == Path(out_j).read_bytes()
    doc = pof.load_trace(out_p)
    assert pof.verify_merged_order(doc) == jof.verify_merged_order(doc) == 0
    # the clock skew gauges under the JAX names
    for pair, ms in res_p["clock_skew_ms"].items():
        a, b = pair.split("->")
        assert pmx.snapshot()["gauges"][
            f"obs.clock_skew_ms.{a}.{b}"] == ms
    if case == "midpoint":
        assert res_p["offsets_us"] == [0.0, 100150.0]
        assert res_p["flows"] == 2 and res_p["clamped"] == 0
    if case == "infeasible":
        assert res_p["clamped"] == 2


def test_verify_merged_order_counts_violations():
    doc = {"traceEvents": [
        {"name": "comm.flow", "ph": "s", "id": 0, "ts": 10},
        {"name": "comm.flow", "ph": "f", "id": 0, "ts": 5},
        {"name": "comm.flow", "ph": "s", "id": 1, "ts": 10},
        {"name": "comm.flow", "ph": "f", "id": 1, "ts": 11}]}
    assert pof.verify_merged_order(doc) == jof.verify_merged_order(doc) == 1


def _texts():
    return {"a": render_prometheus(_SNAP),
            "b": render_prometheus({"counters": {"fed.rounds": 7},
                                    "gauges": {"fed.round.current": 6.0},
                                    "histograms": {}})}


def test_fleet_sums_and_aggregate_equal_jax():
    """The sums column is the sum of the per-process scrapes, equal to
    JAX's on the same expositions; the aggregate splits back by
    process."""
    texts = _texts()
    colls = [mod.FleetCollector({"a": "a", "b": "b"},
                                fetch=lambda u: texts[u])
             for mod in (pof, jof)]
    for c in colls:
        assert c.scrape_once() == {"a": True, "b": True}
    sp, sj = (c.fleet_snapshot() for c in colls)
    assert sp["sums"] == sj["sums"]
    per = {n: parse_prometheus(t) for n, t in texts.items()}
    assert sp["sums"] == pof.fleet_sums(per) == jof.fleet_sums(per)
    assert sp["sums"]["counters"]["fed_rounds_total"] == 10
    assert colls[0].aggregated_text() == colls[1].aggregated_text()
    back = split_by_label(parse_prometheus(colls[0].aggregated_text()))
    assert back["b"]["counters"]["fed_rounds_total"] == 7


def test_stale_marks_as_jax():
    """A failed scrape keeps the last good snapshot and marks it stale;
    a process that never answered is stale with its error; both packages
    agree field for field (ages aside)."""
    texts = _texts()
    down = {"g"}

    def fetch(url):
        if url in down:
            raise OSError(f"{url}: connection refused")
        return texts[url]

    colls = [mod.FleetCollector({"a": "a", "b": "b", "ghost": "g"},
                                fetch=fetch) for mod in (pof, jof)]
    for c in colls:
        c.scrape_once()
    down.add("b")
    for c in colls:
        assert c.scrape_once() == {"a": True, "b": False, "ghost": False}

    def strip(snap):
        return {n: {k: v for k, v in p.items() if k != "age_s"}
                for n, p in snap["processes"].items()}

    sp, sj = (c.fleet_snapshot() for c in colls)
    assert strip(sp) == strip(sj)
    assert sp["processes"]["b"]["stale"] and not sp["processes"]["a"][
        "stale"]
    assert "refused" in sp["processes"]["b"]["error"]
    assert sp["processes"]["b"]["snapshot"]["counters"][
        "fed_rounds_total"] == 7
    assert sp["processes"]["ghost"]["stale"]
    assert pmx.snapshot()["gauges"]["obs.fleet.stale"] == 2


def test_http_serve_and_registration_over_loopback():
    """/metrics and /fleet over HTTP, and OBS_REGISTER frames over the
    loopback transport (`announce` from a rank, `install_registration` on
    the collector's host), as in JAX."""
    import urllib.request

    from fedml_tpu_torch.comm import FedCommManager
    from fedml_tpu_torch.comm.loopback import LoopbackTransport, \
        release_router

    assert pof.OBS_REGISTER == jof.OBS_REGISTER
    texts = _texts()
    coll = pof.FleetCollector(fetch=lambda u: texts[u])
    run = f"obsfleet-{uuid.uuid4().hex[:6]}"
    a = FedCommManager(LoopbackTransport(0, run), 0)
    b = FedCommManager(LoopbackTransport(1, run), 1)
    pof.install_registration(a, coll)
    a.run(background=True)
    b.run(background=True)
    try:
        b.announce_metrics("b", "b")
        pof.announce(b, "a", "a")
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and len(coll.roster()) < 2:
            time.sleep(0.01)
        assert coll.roster() == {"a": "a", "b": "b"}
    finally:
        a.stop()
        b.stop()
        release_router(run)
    coll.scrape_once()
    exp = coll.serve(port=0)
    try:
        with urllib.request.urlopen(exp.url, timeout=5) as r:
            per = split_by_label(parse_prometheus(r.read().decode()))
        assert per["a"]["counters"]["fed_rounds_total"] == 3
        with urllib.request.urlopen(exp.url.rsplit("/", 1)[0] + "/fleet",
                                    timeout=5) as r:
            doc = json.loads(r.read())
        assert doc["processes"]["b"]["ok"]
        assert doc["sums"]["counters"]["fed_rounds_total"] == 10
    finally:
        coll.stop()


_VALIDATION = [
    {"roster": {"a": "http://a/metrics"}, "port": 0, "interval_s": 1.0,
     "timeout_s": 2.0, "stale_after_s": 5.0},
    {}, {"port": 65535}, {"interval_s": 1},
    {"rooster": {}}, {"roster": {"a": 1}}, {"roster": []}, {"port": 70000},
    {"port": True}, {"port": 1.5}, {"interval_s": -1},
    {"stale_after_s": float("nan")}, {"timeout_s": 0}, {"timeout_s": "1"},
    ["roster"], None,
]


@pytest.mark.parametrize("d", _VALIDATION, ids=range(len(_VALIDATION)))
def test_validate_obs_fleet_as_jax(d):
    """The same inputs accepted and rejected, with the same message; the
    port's config refuses at load what the validator refuses."""
    import fedml_tpu_torch

    outcome = []
    for mod in (pof, jof):
        try:
            outcome.append(("ok", mod.validate_obs_fleet(d) is d))
        except ValueError as e:
            outcome.append(("err", str(e)))
    assert outcome[0] == outcome[1]
    cfg = {"common_args": {"extra": {"obs_fleet": d}}}
    if d is None:
        return          # an absent section is not validated
    if outcome[0][0] == "ok":
        fedml_tpu_torch.init(config=cfg, device="cpu")
    else:
        with pytest.raises(ValueError, match="obs_fleet"):
            fedml_tpu_torch.init(config=cfg, device="cpu")


def test_maybe_start_fleet_collector_one_per_process():
    import fedml_tpu_torch

    cfg = fedml_tpu_torch.init(config={"common_args": {"extra": {
        "obs_fleet": {"roster": {}, "interval_s": 0.05, "port": 0}}}},
        device="cpu")
    old = pof._collector
    pof._collector = None
    try:
        coll = pof.maybe_start_fleet_collector(cfg)
        assert coll is pof.current_collector()
        assert pof.maybe_start_fleet_collector(cfg) is coll
        assert coll._exporter is not None
        coll.stop()
    finally:
        pof._collector = old
    assert pof.maybe_start_fleet_collector(
        fedml_tpu_torch.init(config={}, device="cpu")) is None


def test_two_grpc_processes_merge_with_zero_violations():
    """The `fleet_obs_smoke` probe on this machine: two gRPC peers and a
    victim in child processes, the aggregate's three process labels, the
    stale victim, and the peers' traces merged with at least one stitched
    flow and no ordering violation."""
    pytest.importorskip("grpc")
    env = {**os.environ, "PYTHONPATH": str(ROOT), "JAX_PLATFORMS": "cpu"}
    r = subprocess.run(
        [sys.executable, "-m", "fedml_tpu_torch", "diagnosis", "--device",
         "cpu", "--only", "fleet_obs_smoke"],
        capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    chk = json.loads(r.stdout)["checks"]["fleet_obs_smoke"]
    assert chk["ok"] and chk["order_violations"] == 0 and chk["flows"] >= 1
    assert chk["processes"] == ["peer_a", "peer_b", "victim"]
    assert "hard-kill" in chk["postmortem_reason"]
