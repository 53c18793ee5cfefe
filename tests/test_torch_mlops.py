"""The port's mlops facade, sysperf sampler and model-artifact stores
(`fedml_tpu_torch/mlops.py`, `utils/sysperf.py`, `utils/artifacts.py`)
against the JAX package's: the facade's rows, sysperf's keys, and stores
whose files are byte-equal for the same tree and that each package reads
from the other; the Simulator and a 2-silo loopback federation publish
per-round artifacts, and `predictor_from_artifact` serves one."""
import json
import logging
import os
import threading
import time
import uuid

import numpy as np
import pytest
import torch

import fedml_tpu
from fedml_tpu import mlops as jmlops
from fedml_tpu.utils import artifacts as jart
from fedml_tpu.utils import events as jev
from fedml_tpu.utils import sysperf as jsys
import fedml_tpu_torch
from fedml_tpu_torch import mlops
from fedml_tpu_torch.utils import artifacts as part
from fedml_tpu_torch.utils import events as pev
from fedml_tpu_torch.utils import postmortem  # noqa: F401 (its always-on sink)
from fedml_tpu_torch.utils import sysperf as psys

torch.set_num_threads(2)

_VOLATILE = {"t", "duration", "trace_id", "span_id", "parent_id"}


@pytest.fixture(autouse=True)
def _isolate():
    """The port's recorder sinks and the facade's store restored after
    each test."""
    sinks = list(pev.recorder.sinks)
    yield
    pev.recorder.sinks[:] = sinks
    mlops.set_artifact_store(None)


def _tree(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"conv.kernel": rng.standard_normal((3, 3, 2, 4)).astype(
                np.float32),
            "dense.bias": rng.standard_normal(5).astype(np.float32),
            "count": np.arange(4, dtype=np.int64), "lr": 0.5,
            "nested": {"a": rng.standard_normal((2, 3)).astype(np.float16),
                       "tags": ("x", 1)}}


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return set(a) == set(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(
            _same(x, y) for x, y in zip(a, b))
    if isinstance(a, (np.ndarray, torch.Tensor)):
        a, b = (np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
                for x in (a, b))
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


# ------------------------------------------------------------------ facade
def _facade_rows(pkg, mod, tmp_path, name):
    cfg = pkg.init(config={"tracking_args": {
        "enable_tracking": True, "log_file_dir": str(tmp_path / name),
        "run_name": name, "extra": {"sysperf_interval": 0.1}}},
        **({"device": "cpu"} if pkg is fedml_tpu_torch else {}))
    rec = pev.recorder if pkg is fedml_tpu_torch else jev.recorder
    n0 = len(rec.sinks)
    mod.init(cfg)
    try:
        with mod.event("train", round=1):
            time.sleep(0.01)
        mod.event("comm", event_started=True)
        time.sleep(0.01)
        mod.event("comm", event_started=False)
        mod.log({"acc": 0.5})
        mod.log_round_info(10, 3)
        logging.getLogger(f"{name}.test").info("hello log daemon")
        time.sleep(0.35)                     # sysperf ticks
    finally:
        mod.finish()
        if pkg is fedml_tpu:
            del rec.sinks[n0:]
    d = tmp_path / name
    rows = [json.loads(x) for x in
            (d / f"{name}.events.jsonl").read_text().splitlines()]
    return d, rows


def test_facade_end_to_end_as_jax(tmp_path):
    d, rows = _facade_rows(fedml_tpu_torch, mlops, tmp_path, "port")
    _jd, jrows = _facade_rows(fedml_tpu, jmlops, tmp_path, "jax")

    def plain(rs):
        return [{k: v for k, v in r.items() if k not in _VOLATILE}
                for r in rs if "sysperf" not in r and "report" not in r]

    assert plain(rows) == plain(jrows)
    assert any(r.get("event") == "comm" and r["duration"] > 0 for r in rows)
    perf = [r["sysperf"] for r in rows if "sysperf" in r]
    assert perf and set(perf[0]) == set(
        [r for r in jrows if "sysperf" in r][0]["sysperf"])
    report = [r["report"] for r in rows if "report" in r][-1]
    assert report["spans"]["train"]["count"] >= 1
    assert "fed.budget.wall_s" in report["metrics"]["gauges"]
    assert "hello log daemon" in (d / "port.log").read_text()
    trace = json.loads((d / "port.trace.json").read_text())
    assert any(e.get("cat") == "round" for e in trace["traceEvents"])
    assert json.loads((d / "postmortem.json").read_text())["reason"] == \
        "finish"
    assert postmortem.flight.armed_dir is None
    mlops.finish()                           # idempotent


def test_sysperf_keys_equal_jax():
    got, want = psys.sample_sysperf(), jsys.sample_sysperf()
    assert set(got) == set(want)
    assert got["rss_mb"] > 0 and got["threads"] >= 1
    assert 0 <= got["host_mem_pct"] <= 100
    assert system_stats_ok(mlops.system_stats())


def system_stats_ok(row) -> bool:
    return row["rss_mb"] > 0 and set(row) >= {"cpu_pct", "rss_mb",
                                              "host_mem_pct", "threads"}


def test_sysperf_host_numbers_are_psutils():
    """Where psutil imports it gives the numbers `/proc` gives."""
    psutil = pytest.importorskip("psutil")
    p = psutil.Process()
    row = psys._proc_host_row()
    assert row["threads"] == p.num_threads()
    assert abs(row["rss_mb"] - p.memory_info().rss / 1e6) < 5.0
    assert abs(row["host_mem_pct"] - psutil.virtual_memory().percent) < 2.0
    psys.cpu_percent()
    x = np.ones((600, 600))
    for _ in range(20):
        x = x @ x / 600.0
    assert 0.0 <= psys.cpu_percent() <= 100.0


def test_sysperf_monitor_primes_and_logs():
    n0 = len(pev.recorder.metrics)
    psys._cpu_last = None
    mon = psys.SysPerfMonitor(interval=0.1).start()
    assert psys._cpu_last is not None          # primed at start
    time.sleep(0.45)
    mon.stop()
    rows = [m for m in pev.recorder.metrics[n0:] if "sysperf" in m]
    assert len(rows) >= 2 and rows[0]["sysperf"]["rss_mb"] > 0


def test_artifact_store_kind_is_checked_as_jax(tmp_path):
    d = {"tracking_args": {"log_file_dir": str(tmp_path),
                           "extra": {"artifact_store": "s3"}}}
    with pytest.raises(ValueError) as e:
        mlops.init(fedml_tpu_torch.init(config=d, device="cpu"))
    with pytest.raises(ValueError) as j:
        jmlops.init(fedml_tpu.init(config=d))
    assert str(e.value) == str(j.value)


# ------------------------------------------------------------ the stores
def test_file_store_bytes_equal_and_cross_read(tmp_path):
    tree = _tree(1)
    p = part.FileArtifactStore(str(tmp_path / "port"))
    j = jart.FileArtifactStore(str(tmp_path / "jax"))
    assert (part.aggregated_name(3), part.client_name(3, 2),
            part.adapter_name(1)) == (jart.aggregated_name(3),
                                      jart.client_name(3, 2),
                                      jart.adapter_name(1))
    for name in (part.aggregated_name(3), part.client_name(3, 2),
                 part.adapter_name(1)):
        p.put(name, tree)
        j.put(name, tree)
        for ext in (".bin", ".meta"):
            assert (tmp_path / "port" / (name + ext)).read_bytes() == \
                (tmp_path / "jax" / (name + ext)).read_bytes(), (name, ext)
    assert p.list() == j.list() == sorted(
        ["adapters/round_000001", "aggregated/round_000003",
         "client_2/round_000003"])
    # each package reads the other's store
    assert _same(part.FileArtifactStore(str(tmp_path / "jax"))
                 .get(part.adapter_name(1)), tree)
    assert _same(jart.FileArtifactStore(str(tmp_path / "port"))
                 .get(jart.adapter_name(1)), tree)
    # torch trees (a bf16 leaf) read back bitwise
    tt = {"w": torch.randn(4, 3, generator=torch.Generator().manual_seed(0))
          .to(torch.bfloat16), "b": torch.zeros(3)}
    p.put("adapters/round_000002", tt)
    back = p.get("adapters/round_000002")
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"],
                                                             tt["w"])
    p.delete(part.client_name(3, 2))
    assert part.client_name(3, 2) not in p.list()
    for bad in ("../escape", "/abs", "sp ace"):
        with pytest.raises(ValueError):
            p.put(bad, tree)


def test_file_store_waits_out_a_torn_publish(tmp_path, monkeypatch):
    """New tensors under an old meta: `get` waits for the meta and returns
    the new artifact; a meta that never comes raises after the budget, as
    in JAX."""
    st = part.FileArtifactStore(str(tmp_path))
    name = part.aggregated_name(0)
    st.put(name, {"w": np.zeros(3, np.float32)})
    old_meta = st._meta_path(name).read_bytes()
    st.put(name, {"w": np.ones(3, np.float32)})
    new_meta = st._meta_path(name).read_bytes()
    st._meta_path(name).write_bytes(old_meta)          # the race window
    t = threading.Timer(0.2, lambda: st._meta_path(name).write_bytes(
        new_meta))
    t.start()
    got = st.get(name)
    t.join()
    assert np.array_equal(got["w"], np.ones(3, np.float32))
    st._meta_path(name).write_bytes(old_meta)
    for mod, store in ((part, st), (jart, jart.FileArtifactStore(
            str(tmp_path)))):
        monkeypatch.setattr(mod.FileArtifactStore, "_META_RACE_BUDGET_S",
                            0.1)
        with pytest.raises(ValueError, match="torn publish"):
            store.get(name)
    st._meta_path(name).unlink()                       # no meta at all
    assert np.array_equal(st.get(name)["w"], np.ones(3, np.float32))
    with pytest.raises(KeyError):
        st.get(part.aggregated_name(9))


def _broker_case(mod, broker, bid):
    pub = mod.BrokerArtifactStore(broker_id=bid, run_id="r1", keep_rounds=2)
    for r in range(5):
        pub.put(mod.aggregated_name(r), {"w": np.full(4, float(r))})
    obs = mod.BrokerArtifactStore(broker_id=bid, run_id="r1")
    out = {"list": pub.list(),
           "blobs": len(broker.get_cas_broker(bid)._blobs),
           "w4": obs.get(mod.aggregated_name(4))["w"].tolist(),
           "again": obs.get(mod.aggregated_name(4))["w"].tolist()}
    st = mod.BrokerArtifactStore(broker_id=bid, run_id="leak")
    tree = {"w": np.ones(3, np.float32)}
    st.put(mod.aggregated_name(0), tree)
    st.put(mod.aggregated_name(0), tree)       # identical content
    st.delete(mod.aggregated_name(0))
    out["leak_blobs"] = len(broker.get_cas_broker(bid)._blobs)
    out["leak_list"] = st.list()
    out["spec"] = mod.store_spec(mod.store_from_spec(mod.store_spec(pub)))
    broker.release_broker(bid)
    return out


def test_broker_store_dedup_prune_and_late_reader_as_jax():
    from fedml_tpu.comm import broker as jbroker
    from fedml_tpu_torch.comm import broker as pbroker

    got = _broker_case(part, pbroker, f"arts-{uuid.uuid4().hex[:6]}")
    want = _broker_case(jart, jbroker, f"arts-{uuid.uuid4().hex[:6]}")
    got["spec"].pop("broker_id")
    want["spec"].pop("broker_id")
    assert got == want
    assert got["list"] == ["aggregated/round_000003",
                           "aggregated/round_000004"]
    assert got["blobs"] == 2 and got["leak_blobs"] == 2
    assert got["leak_list"] == []


def test_store_spec_round_trip(tmp_path):
    st = part.FileArtifactStore(str(tmp_path))
    assert part.store_spec(st) == jart.store_spec(
        jart.FileArtifactStore(str(tmp_path)))
    assert part.store_from_spec(part.store_spec(st)).root == st.root
    with pytest.raises(ValueError):
        part.store_from_spec({"kind": "s3"})
    with pytest.raises(TypeError):
        part.store_spec(object())


# ----------------------------------------------------------- publishing
def _sim_cfg(**train):
    return fedml_tpu_torch.init(config={
        "data_args": {"dataset": "synthetic",
                      "extra": {"synthetic_samples_per_client": 16}},
        "model_args": {"model": "lr"},
        "train_args": {"federated_optimizer": "FedAvg",
                       "client_num_in_total": 2, "client_num_per_round": 2,
                       "comm_round": 3, "epochs": 1, "batch_size": 8,
                       "learning_rate": 0.3, **train},
        "validation_args": {"frequency_of_the_test": 0},
        "comm_args": {"backend": "sp"}}, device="cpu")


@pytest.mark.parametrize("block,names", [
    (1, [0, 1, 2]),        # a publish a round
    (2, [1, 2])])          # a block publishes its last round, as in JAX
def test_simulator_publishes_round_artifacts(tmp_path, block, names):
    from fedml_tpu_torch.simulation.simulator import Simulator

    store = part.FileArtifactStore(str(tmp_path / "arts"))
    mlops.set_artifact_store(store)
    sim = Simulator(_sim_cfg(extra={"rounds_per_block": block}))
    sim.run(3)
    assert store.list() == [part.aggregated_name(r) for r in names]
    fetched = mlops.fetch_aggregated_model(2)
    assert _same(fetched, {k: v.numpy() for k, v in
                           sim.server_state.params.items()})


def test_simulator_publish_failure_warns_and_continues(caplog):
    from fedml_tpu_torch.simulation.simulator import Simulator

    class Full:
        def put(self, name, tree):
            raise OSError("disk full")

    mlops.set_artifact_store(Full())
    sim = Simulator(_sim_cfg())
    with caplog.at_level(logging.WARNING):
        hist = sim.run(2)
    assert [h["round"] for h in hist] == [0, 1]
    assert caplog.text.count("model-artifact publish failed") == 2


def test_two_silo_loopback_federation_publishes(tmp_path):
    """The server publishes each round's aggregate, each client its
    trained model; the last aggregate is the server's final parameters."""
    from fedml_tpu_torch.cross_silo.soak import uninterrupted_final_params

    store = part.FileArtifactStore(str(tmp_path / "arts"))
    mlops.set_artifact_store(store)
    params, hist = uninterrupted_final_params(n_clients=2, rounds=2,
                                              device="cpu")
    names = store.list()
    assert [h["round"] for h in hist] == [0, 1]
    assert {part.aggregated_name(r) for r in (0, 1)} <= set(names)
    assert {part.client_name(r, c) for r in (0, 1) for c in (1, 2)} \
        <= set(names)
    assert _same(store.get(part.aggregated_name(1)),
                 {k: np.asarray(v) for k, v in params.items()})


def test_predictor_from_a_store_the_jax_package_wrote(tmp_path):
    """The JAX package's store holds the round's flat parameter tree; the
    port's `predictor_from_artifact` serves it as the Simulator's model."""
    from fedml_tpu_torch import serving
    from fedml_tpu_torch.simulation.simulator import Simulator

    sim = Simulator(_sim_cfg())
    sim.run(1)
    params = {k: v.numpy() for k, v in sim.server_state.params.items()}
    jart.FileArtifactStore(str(tmp_path)).put(jart.aggregated_name(0),
                                              params)
    pred = serving.predictor_from_artifact(
        part.FileArtifactStore(str(tmp_path)), 0, sim.apply_fn,
        device="cpu")
    x = np.asarray(sim.dataset.x_test[:5], np.float32)
    with torch.no_grad():
        logits = sim.apply_fn(sim.server_state.params, torch.from_numpy(x))
    out = pred.predict({"inputs": x.tolist()})
    assert out["predictions"] == logits.argmax(-1).tolist()
    assert out["probabilities"] == torch.softmax(logits, -1).numpy() \
        .round(6).tolist()
    assert os.path.exists(tmp_path / "aggregated" / "round_000000.meta")
