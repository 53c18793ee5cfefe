"""The port's centralized baseline (`fedml_tpu_torch.centralized`) and the
optimizer state that `local_sgd` carries across calls, against the JAX
package's `fedml_tpu.centralized`, on the CPU.

`pool_clients` is bitwise. The epochs get the JAX trainer's batch
indices (`make_batch_indices(fold_in(key(seed), e), ...)`) and start from
its flax parameters, so both sides compute the same function; with
momentum over 3 epochs they agree within 1e-5 of the largest parameter
update (f32 sums in another order), and the history rows within 1e-5.
"""
import jax
import numpy as np
import pytest
import torch

import fedml_tpu
from fedml_tpu.centralized import CentralizedTrainer as JaxCentralized
from fedml_tpu.centralized import pool_clients as jax_pool_clients
from fedml_tpu.core.algorithm import make_batch_indices as jax_batch_indices

import fedml_tpu_torch
from fedml_tpu_torch.centralized import CentralizedTrainer, pool_clients
from fedml_tpu_torch.core.algorithm import (
    local_sgd, make_client_optimizer, masked_softmax_ce,
)
from fedml_tpu_torch.data import loader
from fedml_tpu_torch.models import hub
from fedml_tpu_torch.runner import FedMLRunner

torch.set_num_threads(2)

TOL = 1e-5   # max |param diff| over the largest parameter update
EPOCHS = 3


def _config(model: str, data_dir, dataset="mnist", **train) -> dict:
    return {"data_args": {"dataset": dataset, "data_cache_dir": str(data_dir),
                          "extra": {"synthetic_samples_per_client": 48}},
            "model_args": {"model": model},
            "train_args": {"client_num_in_total": 4,
                           "client_num_per_round": 4, "epochs": 1,
                           "batch_size": 16, "learning_rate": 0.1,
                           **train}}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A JAX trainer run for EPOCHS epochs (its parameters before and
    after, its history, the batch indices it drew) and the port's config
    for the same data (synthetic MNIST shapes)."""
    d = _config("cnn", tmp_path_factory.mktemp("data"), learning_rate=0.01,
                momentum=0.9,
                weight_decay=1e-3)
    jcfg = fedml_tpu.init(config=d)
    jt = JaxCentralized(jcfg)
    j0 = jax.tree.map(np.asarray, jt.params)
    idx = [np.asarray(jax_batch_indices(
        jax.random.fold_in(jax.random.key(jcfg.common_args.random_seed), e),
        jt.pooled["y"].shape[0], jcfg.train_args.batch_size, 1))
        for e in range(EPOCHS)]
    jhist = jt.run(epochs=EPOCHS)
    j1 = jax.tree.map(np.asarray, jt.params)
    cfg = fedml_tpu_torch.init(config=d, device="cpu")
    return {"jax_hist": jhist, "j0": j0, "j1": j1, "idx": idx, "cfg": cfg,
            "jax_ds": jt.dataset}


def test_pool_clients_bitwise(pair):
    ds = loader.load(pair["cfg"])
    ds.mask_train = ds.mask_train.copy()
    ds.mask_train[1, 5:] = 0.0          # padding rows are dropped
    jds = pair["jax_ds"]
    jds.mask_train = ds.mask_train
    got, want = pool_clients(ds), jax_pool_clients(jds)
    for k in ("x", "y", "mask"):
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
    assert got["y"].shape[0] == int((ds.mask_train > 0).sum())
    assert got["y"].shape[0] < ds.mask_train.size


def test_epochs_with_momentum_match_jax(pair):
    tr = CentralizedTrainer(pair["cfg"], device="cpu",
                            params=hub.params_from_flax(pair["j0"],
                                                        device="cpu"))
    hist = tr.run(epochs=EPOCHS, batch_idx=pair["idx"])
    want = hub.params_from_flax(pair["j1"], device="cpu")
    start = hub.params_from_flax(pair["j0"], device="cpu")
    upd = max(float((want[k] - start[k]).abs().max()) for k in want)
    err = max(float((tr.params[k] - want[k]).abs().max()) for k in want)
    assert upd > 1e-3 and err <= TOL * upd, (err, upd)
    assert len(hist) == len(pair["jax_hist"]) == EPOCHS
    for got, exp in zip(hist, pair["jax_hist"]):
        assert set(got) == set(exp)
        for k, v in exp.items():
            assert abs(got[k] - v) <= TOL * max(1.0, abs(v)), (k, got, exp)
    assert tr.opt_state[1] == sum(len(i) for i in pair["idx"])


def test_centralized_baseline_converges(tmp_path):
    cfg = fedml_tpu_torch.init(config={
        "data_args": {"dataset": "synthetic", "data_cache_dir": str(tmp_path),
                      "extra": {"synthetic_samples_per_client": 64}},
        "model_args": {"model": "lr"},
        "train_args": {"client_num_in_total": 4, "client_num_per_round": 4,
                       "epochs": 1, "batch_size": 16, "learning_rate": 0.3},
    }, device="cpu")
    tr = CentralizedTrainer(cfg)
    hist = tr.run(epochs=10)
    assert hist[-1]["train_loss"] < hist[0]["train_loss"] * 0.8
    assert hist[-1]["train_acc"] > hist[0]["train_acc"]
    assert 0.0 <= hist[-1]["test_acc"] <= 1.0
    assert "test_acc" not in hist[0]


@pytest.mark.parametrize("opt,momentum", [("sgd", 0.9), ("adam", 0.0)])
def test_local_sgd_opt_state_round_trip(opt, momentum):
    """Two calls that hand the optimizer state over are one call over the
    joined schedule, bit for bit (momentum traces, Adam's moments and its
    step count continue); without the state the second call starts
    fresh and differs."""
    g = torch.Generator().manual_seed(0)
    model = hub.create("lr", 3, (6,), device="cpu")
    params = hub.init_params(model, g)
    fn = hub.apply_fn(model)
    shard = {"x": torch.randn(40, 6, generator=g),
             "y": torch.randint(0, 3, (40,), generator=g),
             "mask": torch.ones(40)}
    idx = torch.randperm(40, generator=g)[:32].reshape(4, 8)
    o = make_client_optimizer(opt, 0.1, momentum)
    whole, m_all, steps_all = local_sgd(fn, params, shard, idx, o)
    p1, _, _, st = local_sgd(fn, params, shard, idx[:2], o,
                             return_opt_state=True)
    assert st[1] == 2
    p2, _, _, st2 = local_sgd(fn, p1, shard, idx[2:], o, opt_state=st,
                              return_opt_state=True)
    assert st2[1] == 4
    for k in whole:
        assert torch.equal(p2[k], whole[k]), k
    fresh, _, _ = local_sgd(fn, p1, shard, idx[2:], o)
    assert any(not torch.equal(fresh[k], whole[k]) for k in whole)
    # the metrics of the default call are unchanged by the new keywords
    _, m_again, steps_again = local_sgd(fn, params, shard, idx, o,
                                        objective=masked_softmax_ce)
    assert torch.equal(m_again.loss_sum, m_all.loss_sum)
    assert torch.equal(steps_again, steps_all)


def test_runner_centralized_and_refusals(tmp_path):
    d = _config("lr", tmp_path)
    cfg = fedml_tpu_torch.init(config={
        **d, "common_args": {"training_type": "centralized"}}, device="cpu")
    r = FedMLRunner(cfg)
    assert isinstance(r.runner, CentralizedTrainer)
    assert r.runner.device.type == "cpu"
    hist = r.run(epochs=2)
    assert [h["epoch"] for h in hist] == [0, 1]
    assert np.isfinite([h["train_loss"] for h in hist]).all()
    # a model-parallel mesh runs SPMD over ranks (test_torch_centralized_
    # mp.py); outside a torch.distributed world it refuses to start
    mp = fedml_tpu_torch.init(config={
        **d, "device_args": {"mesh_shape": {"mp": 2}}}, device="cpu")
    with pytest.raises(RuntimeError, match="torch.distributed initialised"):
        CentralizedTrainer(mp)


def test_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """Without a GPU the centralized trainer, and the runner's centralized
    route, raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = _config("lr", tmp_path)
    cfg = fedml_tpu_torch.config.Config.from_dict(d)
    with pytest.raises(RuntimeError, match="no GPU"):
        CentralizedTrainer(cfg)
    cfg = fedml_tpu_torch.config.Config.from_dict(
        {**d, "common_args": {"training_type": "centralized"}})
    with pytest.raises(RuntimeError, match="no GPU"):
        FedMLRunner(cfg)
