"""The port's async simulator (`fedml_tpu_torch/simulation/
async_simulator.py`) against the JAX package's, on the CPU.

The event sequence is host numpy in both packages, so every history row's
`update`, `sim_time` and `staleness` and the chaos counters are bitwise.
The port gets the JAX initial parameters (`params_from_flax`) and the JAX
batch orders (`make_batch_indices(fold_in(key(seed), seq), ...)`), so the
losses and the parameters agree within 1e-3 of the largest parameter
update, the repo's rule for rounds.
"""
import jax
import numpy as np
import pytest
import torch

import fedml_tpu
from fedml_tpu.core.algorithm import make_batch_indices as jax_batch_indices
from fedml_tpu.simulation.async_simulator import AsyncSimulator as JaxAsync
from fedml_tpu.simulation.async_simulator import (
    staleness_weight as jax_staleness_weight,
)
from fedml_tpu.utils import metrics as jax_mx

import fedml_tpu_torch
from fedml_tpu_torch.config import Config
from fedml_tpu_torch.models import hub
from fedml_tpu_torch.runner import FedMLRunner
from fedml_tpu_torch.simulation import async_simulator as amod
from fedml_tpu_torch.simulation.async_simulator import (
    AsyncSimulator, staleness_weight,
)
from fedml_tpu_torch.utils import metrics as mx

torch.set_num_threads(2)

ROUND_TOL = 1e-3   # max |param diff| over the largest parameter update
LOSS_TOL = 1e-4
CHAOS = {"seed": 5, "client_dropout": 0.15, "client_straggler": 0.2}


def _cfg_dict(tmp, chaos=True, **extra):
    return {
        "data_args": {"dataset": "mnist", "data_cache_dir": str(tmp),
                      "synthetic_samples_per_client": 16},
        "model_args": {"model": "cnn"},
        "train_args": {"federated_optimizer": "FedAvg",
                       "client_num_in_total": 6, "client_num_per_round": 3,
                       "comm_round": 4, "epochs": 1, "batch_size": 8,
                       "learning_rate": 0.1, "async_concurrency": 3,
                       "async_speed_spread": 1.5, **extra},
        "common_args": {"random_seed": 3,
                        **({"chaos": CHAOS} if chaos else {})},
        "comm_args": {"backend": "sp"},
    }


def _counters(snap):
    return {k: v for k, v in snap["counters"].items()
            if k.startswith("fed.chaos.client_")}


def _delta(after, before):
    return {k: v - before.get(k, 0) for k, v in after.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("async")
    d = _cfg_dict(tmp)
    jsim = JaxAsync(fedml_tpu.init(config=d))
    p0 = hub.params_from_flax(jsim.params, device="cpu")
    shard = jsim.dataset.x_train.shape[1]

    def order(seq):
        return np.asarray(jax_batch_indices(
            jax.random.fold_in(jax.random.key(3), seq), shard, 8, 1))

    before = _counters(jax_mx.snapshot())
    jhist = jsim.run()
    jc = _delta(_counters(jax_mx.snapshot()), before)

    sim = AsyncSimulator(fedml_tpu_torch.init(config=d, device="cpu"),
                         params=p0)
    before = _counters(mx.snapshot())
    hist = sim.run(batch_idx=order)
    tc = _delta(_counters(mx.snapshot()), before)
    return {"jsim": jsim, "jhist": jhist, "jc": jc, "sim": sim,
            "hist": hist, "tc": tc, "p0": p0, "order": order, "cfg": d}


@pytest.mark.parametrize("tau", [0.0, 1.0, 4.0, 9.0, 37.0])
@pytest.mark.parametrize("mode", ["polynomial", "constant"])
def test_staleness_weight_matches_jax(tau, mode):
    got = float(staleness_weight(0.6, tau, 0.5, mode))
    want = float(jax_staleness_weight(0.6, tau, 0.5, mode))
    assert np.isclose(got, want, rtol=1e-6, atol=0), (got, want)
    assert staleness_weight(0.6, tau).dtype == torch.float32


def test_event_sequence_bitwise(runs):
    j, t = runs["jhist"], runs["hist"]
    assert len(t) == len(j) == 4
    for a, b in zip(t, j):
        assert (a["update"], a["sim_time"], a["staleness"]) == \
            (b["update"], b["sim_time"], b["staleness"])
    assert any(r["staleness"] > 0 for r in t)
    assert runs["sim"].version == runs["jsim"].version == 12
    # the chaos plane drew the same dropouts and stragglers
    assert runs["tc"] == runs["jc"]
    assert runs["tc"].get("fed.chaos.client_dropouts", 0) > 0
    assert runs["tc"].get("fed.chaos.client_stragglers", 0) > 0
    np.testing.assert_array_equal(runs["sim"].client_time,
                                  runs["jsim"].client_time)


def test_losses_and_params_within_the_round_rule(runs):
    for a, b in zip(runs["hist"], runs["jhist"]):
        for k in ("train_loss", "test_loss"):
            assert abs(a[k] - b[k]) <= LOSS_TOL * max(1.0, abs(b[k])), k
        assert abs(a["test_acc"] - b["test_acc"]) <= 1.0 / 64 + 1e-9
    want = hub.params_from_flax(runs["jsim"].params, device="cpu")
    p0 = runs["p0"]
    update = max(float((want[k] - p0[k]).abs().max()) for k in p0)
    diff = max(float((runs["sim"].params[k] - want[k]).abs().max())
               for k in p0)
    assert update > 0 and diff <= ROUND_TOL * update, (diff, update)


def test_a_pending_snapshot_is_not_changed_by_a_merge(runs, monkeypatch):
    """Every event trains from the global parameters of the version it was
    launched at, bit for bit, though merges happened while it was
    pending."""
    sim = AsyncSimulator(fedml_tpu_torch.init(config=runs["cfg"],
                                              device="cpu"),
                         params=runs["p0"])
    versions = [{k: v.clone() for k, v in sim.params.items()}]
    seen, taus = [], []
    merge, train = sim._merge, sim._train_one

    def spy_merge(g, c, a):
        out = merge(g, c, a)
        versions.append({k: v.clone() for k, v in out.items()})
        return out

    def spy_train(snap, cid, idx):
        seen.append(({k: v.clone() for k, v in snap.items()}, sim.version))
        return train(snap, cid, idx)

    monkeypatch.setattr(sim, "_merge", spy_merge)
    monkeypatch.setattr(sim, "_train_one", spy_train)
    monkeypatch.setattr(amod, "record_staleness", taus.append)
    sim.run(batch_idx=runs["order"])
    assert len(seen) == len(taus) == 12
    stale = 0
    for (snap, v), tau in zip(seen, taus):
        v0 = v - int(tau)
        for k, a in snap.items():
            assert torch.equal(a, versions[v0][k]), (v, tau, k)
        if tau > 0:
            stale += 1
            assert any(not torch.equal(a, versions[v][k])
                       for k, a in snap.items())
    assert stale > 0


def test_staleness_histogram_and_version_gauge(runs):
    snap = mx.snapshot()
    assert snap["histograms"]["fed.staleness"]["count"] >= 12
    assert snap["gauges"]["fed.version"] >= 12


def test_runner_dispatch_and_refusals(runs, tmp_path):
    d = _cfg_dict(tmp_path, chaos=False, **{"async": True})
    cfg = fedml_tpu_torch.init(config=d, device="cpu")
    r = FedMLRunner(cfg)
    assert isinstance(r.runner, AsyncSimulator)
    assert r.runner.device == torch.device("cpu")
    assert FedMLRunner(cfg, device="cpu").runner.device.type == "cpu"
    with pytest.raises(ValueError, match="does not accept"):
        FedMLRunner(cfg, device="cpu", mesh=object())
    for knob in ("cohort_chunk", "ingest_prefetch"):
        c = fedml_tpu_torch.init(config=_cfg_dict(tmp_path), device="cpu")
        c.train_args.extra[knob] = 2
        with pytest.raises(ValueError, match="no effect on the async"):
            AsyncSimulator(c)
    # the cost model is ported: it records each merged client's duration
    assert AsyncSimulator(fedml_tpu_torch.init(
        config=_cfg_dict(tmp_path, cost_model=True), device="cpu")
    ).cost_model is not None


def test_cuda_by_default(tmp_path):
    """No device named and none recorded: the entry points ask for CUDA,
    which raises on a host without a GPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    cfg = Config.from_dict(_cfg_dict(tmp_path, **{"async": True}))
    with pytest.raises(RuntimeError, match="no GPU"):
        AsyncSimulator(cfg)
    with pytest.raises(RuntimeError, match="no GPU"):
        FedMLRunner(cfg)
