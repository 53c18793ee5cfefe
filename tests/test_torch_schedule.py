"""The port's Parrot scheduler (`fedml_tpu_torch/schedule/`) against the
JAX package's `fedml_tpu/schedule/`, bitwise: both are host numpy, so
every function returns the same bits on the same seeded inputs. Also
bitwise: the Simulator's padded, LPT-placed id rows for the same ids,
weights and cost model (including the FULL-mode prefix rule of
`tests/test_schedule.py::test_schedule_skipped_when_padding_meets_full_mode`),
and the async simulator's cost-model records. The port's Simulator feeds
its cost model and exports the `fed.cost_model.*` gauges."""
import types

import numpy as np
import pytest
import torch

try:
    import fedml_tpu
    import fedml_tpu.schedule as J
    from fedml_tpu.simulation.async_simulator import (
        AsyncSimulator as JaxAsync,
    )
    from fedml_tpu.simulation.simulator import Simulator as JaxSimulator
    from fedml_tpu.utils import metrics as jax_mx
except ModuleNotFoundError:
    pass

import fedml_tpu_torch
import fedml_tpu_torch.schedule as T
from fedml_tpu_torch.simulation.async_simulator import AsyncSimulator
from fedml_tpu_torch.simulation.simulator import Simulator
from fedml_tpu_torch.utils import metrics as mx

torch.set_num_threads(2)


def _same(a, b):
    """Equal values of equal types, through lists, tuples and dicts."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(
            _same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return type(a) is type(b) and (a == b or (a != a and b != b))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_linear_fit_bitwise(seed):
    rs = np.random.RandomState(seed)
    x = rs.rand(20) * 100
    y = 0.3 * x + rs.rand(20)
    assert _same(T.linear_fit(x, y)[3], J.linear_fit(x, y)[3])
    for a, b in zip(T.linear_fit(x, y), J.linear_fit(x, y)):
        assert np.array_equal(np.asarray(a if not callable(a) else a(x)),
                              np.asarray(b if not callable(b) else b(x)))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("workers", [1, 3, 4])
def test_lpt_family_bitwise(seed, workers):
    """lpt_schedule (with and without speeds), balanced_lpt and
    dp_schedule; costs with ties, so the tie rules are exercised."""
    rs = np.random.RandomState(seed)
    costs = rs.randint(1, 6, 12).astype(float)
    speeds = rs.rand(workers) + 0.5
    assert _same(T.lpt_schedule(costs, workers),
                 J.lpt_schedule(costs, workers))
    assert _same(T.lpt_schedule(costs, workers, speeds),
                 J.lpt_schedule(costs, workers, speeds))
    assert _same(T.balanced_lpt(costs, workers),
                 J.balanced_lpt(costs, workers))
    assert _same(T.dp_schedule(costs[:7], workers),
                 J.dp_schedule(costs[:7], workers))


@pytest.mark.parametrize("workers", [2, 4])
def test_balanced_lpt_block_bitwise(workers):
    rs = np.random.RandomState(7)
    costs = rs.randint(0, 5, (6, 8)).astype(float)
    got = T.balanced_lpt_block(costs, workers)
    assert _same(got, J.balanced_lpt_block(costs, workers))
    for k in range(6):   # the block is K single-round schedules
        assert got[k].tolist() == np.concatenate(
            T.balanced_lpt(costs[k], workers)).tolist()
    for mod in (T, J):
        with pytest.raises(ValueError) as e:
            mod.balanced_lpt_block(costs[0], workers)
        assert "[K, n]" in str(e.value)
    with pytest.raises(ValueError, match="not divisible"):
        T.balanced_lpt(costs[0, :7], workers)


def _estimators(fill):
    out = []
    for mod in (T, J):
        est = mod.RuntimeEstimator(num_workers=2)
        fill(est)
        out.append(est)
    return out


@pytest.mark.parametrize("case", ["linear", "noisy", "sparse"])
def test_runtime_estimator_bitwise(case):
    sizes = {c: 10 * (c + 1) for c in range(6)}
    rs = np.random.RandomState(3)
    noise = rs.rand(2, 6)

    def fill(est):
        for c in range(6 if case != "sparse" else 1):
            for w in range(2):
                est.record(w, c, (0.05 + 0.05 * w) * sizes[c]
                           + (noise[w, c] if case == "noisy" else 0.1))

    a, b = _estimators(fill)
    for uniform in (False, True):
        pa, pb = a.fit(sizes, uniform), b.fit(sizes, uniform)
        assert _same(pa, pb)
        for w in range(2):
            assert _same(a.predict(w, 77, pa[0]), b.predict(w, 77, pb[0]))
            for c in (0, 5):
                assert _same(a.predict_client(w, c, sizes[c], pa[0]),
                             b.predict_client(w, c, sizes[c], pb[0]))
    for r in (0, 4, 10):
        for thr in (1.0, 1e-9):
            assert _same(
                T.generate_client_schedule(list(range(6)), sizes, 2, a, r,
                                           fit_error_threshold=thr),
                J.generate_client_schedule(list(range(6)), sizes, 2, b, r,
                                           fit_error_threshold=thr))
    assert _same(T.generate_client_schedule(list(range(7)), sizes, 3, None),
                 J.generate_client_schedule(list(range(7)), sizes, 3, None))


def _gauges(mod) -> dict:
    snap = mod.snapshot()
    return {k: v for part in ("counters", "gauges")
            for k, v in snap[part].items() if k.startswith("fed.cost_model")}


def test_cost_model_bitwise_with_its_gauges(monkeypatch):
    """The gating scenario of tests/test_schedule.py on both packages:
    the same engaged() answers, fits, predictions, placements and
    fed.cost_model.* readings at every step."""
    rs = np.random.RandomState(11)
    m = 16
    sizes = {c: int(s) for c, s in enumerate(rs.randint(8, 64, m))}
    speeds = np.where(np.arange(m) % 4 == 0, 6.0, 1.0)
    true_t = {c: speeds[c] * sizes[c] for c in range(m)}
    cms = [mod.CostModel(sizes, fit_after_rounds=3, error_threshold=0.8)
           for mod in (T, J)]
    monkeypatch.setattr(mx, "registry", mx.MetricsRegistry())
    monkeypatch.setattr(jax_mx, "registry", jax_mx.MetricsRegistry())

    def both(f):
        got = [f(cm) for cm in cms]
        assert _same(got[0], got[1])
        assert _gauges(mx) == _gauges(jax_mx)
        return got[0]

    both(lambda cm: cm.record_dispatch(range(m), sum(true_t.values())))
    both(lambda cm: cm.record_dispatch([], 1.0))   # nothing recorded
    assert both(lambda cm: cm.engaged()) is False
    for c in range(m):
        both(lambda cm: cm.record_dispatch([c], true_t[c]))
    on = both(lambda cm: cm.engaged())
    both(lambda cm: cm._fitted())
    pred = both(lambda cm: cm.predict_costs(range(m)))
    assert on and not np.array_equal(pred, [sizes[c] for c in range(m)])
    assert _same(T.balanced_lpt(pred, 4), J.balanced_lpt(pred, 4))
    assert both(lambda cm: cm.rounds_recorded) == m + 1
    assert _gauges(mx)["fed.cost_model.dispatches"] == m + 1
    assert T.CostModel.from_config(None, sizes) is None
    got = T.CostModel.from_config({"fit_after_rounds": 2}, sizes)
    assert got.fit_after_rounds == 2 and got.error_threshold == 0.5


def _hosts(counts, m, d, use_full, cost_model_fill=None, chunk=0):
    """A port and a JAX Simulator stripped to their placement state (no
    model, no data): the same counts, cohort, mesh size and cost model."""
    n = len(counts)
    t = types.SimpleNamespace(client_num_per_round=m)
    hosts = []
    for cls, mod in ((Simulator, T), (JaxSimulator, J)):
        h = cls.__new__(cls)
        h.cfg = types.SimpleNamespace(train_args=t)
        h.dataset = types.SimpleNamespace(num_clients=n)
        h.counts = np.asarray(counts, np.float32)
        h._cohort_chunk, h._use_full, h._schedule = chunk, use_full, True
        h._cost_model = None
        if cost_model_fill is not None:
            h._cost_model = mod.CostModel(dict(enumerate(counts)),
                                          fit_after_rounds=1,
                                          error_threshold=10.0)
            cost_model_fill(h._cost_model)
        hosts.append(h)
    hosts[0].mesh, hosts[0]._d = object(), d
    hosts[1].mesh = types.SimpleNamespace(devices=np.zeros(d))
    return hosts


@pytest.mark.parametrize("case", ["sizes", "cost_model", "full_padding",
                                  "full_no_padding", "chunk"])
def test_simulator_placement_bitwise(case):
    """`_round_inputs` (port) and `_pad_ids` (JAX) give the same id and
    weight rows over five rounds: sample-count costs, an engaged cost
    model's predicted runtimes, FULL mode with padding (no permutation:
    the real clients stay the prefix) and without, and chunk padding."""
    rs = np.random.RandomState(4)
    counts = rs.randint(5, 90, 20)
    m = {"full_no_padding": 8}.get(case, 10)

    def fill(cm):
        for c in range(20):
            cm.record_dispatch([c], float(counts[c] * (3.0 if c % 3 else 1)))

    port, jx = _hosts(counts, m, 4, case.startswith("full"),
                      fill if case == "cost_model" else None,
                      chunk=8 if case == "chunk" else 0)
    for r in range(5):
        ids, w, _b, _f = port._round_inputs(r)
        want_ids, want_w = jx._pad_ids(jx.sample_clients(r))
        assert _same(ids, want_ids) and _same(w, want_w)
        if case == "full_padding":
            sampled = port.sample_clients(r)
            assert len(ids) == 12 and (ids[:10] == sampled).all()
            assert (w[10:] == 0).all()
        if case in ("sizes", "cost_model"):
            assert sorted(ids.tolist()) != ids.tolist() or r > 0


def test_placement_carries_schedules_and_faults():
    """A given batch order and fault mask follow their client through the
    padding and the LPT permutation."""
    counts = np.random.RandomState(4).randint(5, 90, 20)
    port = _hosts(counts, 10, 4, False)[0]
    sampled = port.sample_clients(0)
    sched = np.arange(10)[:, None, None] * np.ones((1, 2, 3), np.int64)
    faults = {"dropped": (np.arange(10) % 3 == 0).astype(np.float32),
              "straggled": np.zeros(10, np.float32)}
    ids, _w, b, f = port._round_inputs(0, sched, faults)
    pos = {int(c): i for i, c in enumerate(sampled)}
    src = [pos[int(c)] for c in ids]
    assert (b[:, 0, 0].numpy() == np.asarray(src)).all()
    assert (f["dropped"] == faults["dropped"][src]).all()


def _sim_cfg(tmp, **train_extra):
    return {"common_args": {"random_seed": 0},
            "data_args": {"dataset": "synthetic", "data_cache_dir": str(tmp),
                          "partition_method": "hetero",
                          "partition_alpha": 0.5,
                          "extra": {"synthetic_samples_per_client": 16}},
            "model_args": {"model": "lr"},
            "train_args": {"client_num_in_total": 6,
                           "client_num_per_round": 4, "comm_round": 3,
                           "epochs": 1, "batch_size": 8,
                           "learning_rate": 0.1, "extra": train_extra},
            "validation_args": {"frequency_of_the_test": 0}}


def test_simulator_feeds_the_cost_model(tmp_path, monkeypatch):
    """Without a mesh the cost model records every dispatch but the cold
    first one and exports its gauges; it places nothing (as in JAX)."""
    monkeypatch.setattr(mx, "registry", mx.MetricsRegistry())
    cfg = fedml_tpu_torch.init(config=_sim_cfg(
        tmp_path, cost_model={"fit_after_rounds": 1}), device="cpu")
    sim = Simulator(cfg)
    sim.run()
    cm = sim._cost_model
    assert cm.rounds_recorded == 2 and sim.mesh is None
    assert sum(len(v) for v in cm.estimator.history[0].values()) == 8
    g = _gauges(mx)
    assert g["fed.cost_model.dispatches"] == 2
    assert "fed.cost_model.fit_error" in g and "fed.cost_model.engaged" in g
    assert not sim._lpt_applies(np.arange(4.0), 0)


def test_async_cost_model_records_as_jax(tmp_path):
    """The async simulator records each merged client's simulated
    duration: the same records as the JAX loop's, bitwise (the event
    order, speeds and dropouts are numpy draws on both sides)."""
    d = _sim_cfg(tmp_path, cost_model=True, **{"async": True})
    d["common_args"]["extra"] = {"chaos": {"client_dropout": 0.2}}
    d["train_args"]["comm_round"] = 2
    sim_j = JaxAsync(fedml_tpu.init(config=d))
    sim_j.run()
    sim_t = AsyncSimulator(fedml_tpu_torch.init(config=d, device="cpu"))
    sim_t.run()
    assert sim_t.cost_model.rounds_recorded == \
        sim_j.cost_model.rounds_recorded == 8
    assert _same(sim_t.cost_model.estimator.history,
                 sim_j.cost_model.estimator.history)
