"""The port's round-time budgets (`fedml_tpu_torch/utils/attribution.py`)
against the JAX package's `utils/attribution.py` on the same rows, drawn
from a seed: `classify`, `attribute`, `critical_path`, the rendered
tables, `budget_line`, `link_table` and the published gauges."""
import numpy as np
import pytest
import torch

from fedml_tpu.utils import attribution as jat
from fedml_tpu.utils import events as jev
from fedml_tpu_torch.utils import attribution as pat
from fedml_tpu_torch.utils import events as pev
from fedml_tpu_torch.utils import metrics as pmx

torch.set_num_threads(2)

NAMES = ["train", "eval", "agg", "secagg_unmask", "cd_agg", "agg.finalize",
         "comm.send.c2s", "comm.handle.s2c", "comm_retry", "comm",
         "fed.ingest.put", "fed.ingest.wait", "round", "block", "local_step",
         "fit", "sa_train", "centralized_epoch", "gkt.step", "serving.x",
         "other"]


def _rows(seed: int, n: int = 120) -> list[dict]:
    """Seeded spans over 4 rounds: overlapping intervals, backends, links
    and a parent tree (each span's parent an earlier span, or none)."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        t0 = float(np.round(rng.uniform(0, 40), 6))
        parent = (f"s{rng.integers(i)}" if i and rng.random() < 0.6
                  else "")
        rows.append({
            "name": NAMES[rng.integers(len(NAMES))], "t0": t0,
            "dur": float(np.round(rng.exponential(1.5), 6)),
            "round": (int(t0 // 10) if rng.random() < 0.5 else None),
            "backend": (["loopback", "grpc", None][rng.integers(3)]),
            "sender": int(rng.integers(3)) if rng.random() < 0.5 else None,
            "receiver": int(rng.integers(3)),
            "span_id": f"s{i}", "parent_id": parent})
    return rows


@pytest.mark.parametrize("name", NAMES + ["commx", "trainer", "eval_x"])
def test_classify_as_jax(name):
    assert pat.classify(name) == jat.classify(name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_attribute_and_tables_match_jax(seed):
    rows = _rows(seed)
    got, want = pat.attribute(rows), jat.attribute(rows)
    assert got == want
    assert got["rounds"] and got["totals"]["transport_s"] > 0
    assert pat.critical_path(rows) == jat.critical_path(rows)
    assert pat.render_table(got) == jat.render_table(want)
    assert pat.budget_line(got) == jat.budget_line(want)
    snap = {"counters": {"comm.link.0.1.bytes": 4096,
                         "comm.link.2.1.bytes": 17},
            "histograms": {"comm.link.0.1.rtt_ms": {
                "count": 3, "p50": 0.5, "p99": 2.0}}}
    assert pat.link_table(got, snap) == jat.link_table(want, snap)
    assert pat.render_link_table(got, snap) == \
        jat.render_link_table(want, snap)
    # a wall clock longer than the spans' extent bills the rest to idle
    assert pat.attribute(rows, wall_s=100.0) == jat.attribute(rows,
                                                              wall_s=100.0)


def test_empty_and_payload_rows_as_jax():
    assert pat.attribute([]) == jat.attribute([])
    assert pat.render_table(pat.attribute([])) == \
        jat.render_table(jat.attribute([]))
    assert pat.budget_line({}) == jat.budget_line({})
    payloads = [{"name": "train", "t": 10.0, "duration": 2.0, "round": 0,
                 "span_id": "a"},
                {"name": "comm.send.x", "t": 10.5, "duration": 0.5,
                 "round": 0, "backend": "loopback", "sender": 0,
                 "receiver": 1, "span_id": "b", "parent_id": "a"},
                {"name": "train", "duration": 1.0, "round": 1,
                 "block": True}]                    # no "t": skipped
    assert pat.rows_from_payloads(payloads) == \
        jat.rows_from_payloads(payloads)
    assert len(pat.rows_from_payloads(payloads)) == 2


def test_live_recorder_rows_and_gauges():
    """The same span tree recorded live by both recorders gives the same
    budget (timestamps differ, so the comparison is on the structure),
    and `publish_gauges` lands `fed.budget.*` in the port's registry."""
    recs = {"port": pev.EventRecorder(), "jax": jev.EventRecorder()}
    for rec in recs.values():
        with rec.span("train", round=0):
            with rec.span("comm.send.c2s", backend="loopback", sender=1,
                          receiver=0):
                pass
        with rec.span("agg", round=0):
            pass
    p = pat.rows_from_recorder(recs["port"])
    j = jat.rows_from_recorder(recs["jax"])
    strip = ("t0", "dur", "span_id", "parent_id")
    assert [{k: v for k, v in r.items() if k not in strip} for r in p] == \
        [{k: v for k, v in r.items() if k not in strip} for r in j]
    assert p[0]["parent_id"] == p[1]["span_id"]     # comm under train
    att = pat.attribute(p)
    assert pat.critical_path(p)[0]["name"] == "train"
    pat.publish_gauges(att)
    g = pmx.snapshot()["gauges"]
    assert g["fed.budget.wall_s"] == att["totals"]["wall_s"]
    assert g["fed.budget.transport.loopback_s"] == \
        att["totals"]["transport_by_backend"]["loopback"]
