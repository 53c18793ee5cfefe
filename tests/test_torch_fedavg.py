"""The port's FedAvg simulation path (`fedml_tpu_torch`: config, data,
`models.hub`, the FedAvg family, the round with health stats, the
Simulator) against the JAX package's, on the CPU.

Integer and host-side logic (partitions, shards, client sampling) is
bitwise. Models are built from the flax parameters (`params_from_flax`)
and held to the flax logits and gradients. Rounds get the JAX round's
batch schedule (`make_batch_indices(fold_in(rng, id), ...)`), so both
sides compute the same function; they agree within 1e-3 of the largest
parameter update, the repo's rule for rounds.
"""
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu
from fedml_tpu.algorithms.builtin import build_algorithm as jax_build_algorithm
from fedml_tpu.config import Config as JaxConfig
from fedml_tpu.config import TrainArgs as JaxTrainArgs
from fedml_tpu.core.algorithm import make_batch_indices as jax_batch_indices
from fedml_tpu.core.algorithm import masked_softmax_ce as jax_ce
from fedml_tpu.data import loader as jax_loader
from fedml_tpu.data import partition as jax_partition
from fedml_tpu.models import hub as jax_hub
from fedml_tpu.parallel.round import build_round_fn as jax_build_round_fn
from fedml_tpu.simulation.simulator import Simulator as JaxSimulator

import fedml_tpu_torch
from fedml_tpu_torch.algorithms.builtin import build_algorithm
from fedml_tpu_torch.config import Config, TrainArgs
from fedml_tpu_torch.core.algorithm import masked_softmax_ce
from fedml_tpu_torch.data import loader, partition
from fedml_tpu_torch.models import hub
from fedml_tpu_torch.parallel.round import build_round_fn
from fedml_tpu_torch.simulation.simulator import Simulator

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402

torch.set_num_threads(2)

ROUND_TOL = 1e-3   # max |param diff| over the largest parameter update


# ------------------------------------------------------------ data (bitwise)
@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("n_clients", [4, 10, 23])
@pytest.mark.parametrize("alpha", [0.1, 0.5, 5.0])
def test_partitions_bitwise(seed, n_clients, alpha):
    labels = np.random.RandomState(seed + 7).randint(0, 10, 700)
    want = jax_partition.partition_dirichlet(labels, n_clients, alpha, seed)
    got = partition.partition_dirichlet(labels, n_clients, alpha, seed)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    for g, w in zip(partition.partition_iid(labels, n_clients, seed),
                    jax_partition.partition_iid(labels, n_clients, seed)):
        np.testing.assert_array_equal(g, w)
    assert (partition.record_data_stats(labels, got)
            == jax_partition.record_data_stats(labels, want))


def _cfgs(d: dict):
    return JaxConfig.from_dict(d), Config.from_dict(d)


@pytest.mark.parametrize("dataset,extra", [
    ("cifar10", {"synthetic_samples_per_client": 16}),
    ("digits", {}),
])
def test_loader_bitwise(dataset, extra, tmp_path):
    d = {"data_args": {"dataset": dataset, "data_cache_dir": str(tmp_path),
                       **extra},
         "train_args": {"client_num_in_total": 8, "client_num_per_round": 8,
                        "batch_size": 16}}
    cj, ct = _cfgs(d)
    want, got = jax_loader.load(cj), loader.load(ct)
    for k in ("x_train", "y_train", "mask_train", "counts", "x_test",
              "y_test"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert got.num_classes == want.num_classes
    assert got.synthetic == want.synthetic
    assert got.client_class_stats == want.client_class_stats


def test_config_round_trips_like_jax():
    d = bench._flagship_config("sp")
    cj, ct = _cfgs(d)
    assert ct.to_dict() == cj.to_dict()
    cj.merge_overrides({"learning_rate": 0.2, "dataset": "digits", "x": 1})
    ct.merge_overrides({"learning_rate": 0.2, "dataset": "digits", "x": 1})
    assert ct.to_dict() == cj.to_dict()
    for bad in ({"train_args": {"client_num_in_total": 2,
                                "client_num_per_round": 3}},
                {"train_args": {"rounds_per_block": 0}},
                {"train_args": {"resume": True}}):
        with pytest.raises(ValueError):
            Config.from_dict(bad)


def test_sample_clients_bitwise():
    t = types.SimpleNamespace(client_num_per_round=10)
    host = types.SimpleNamespace(
        cfg=types.SimpleNamespace(train_args=t),
        dataset=types.SimpleNamespace(num_clients=25))
    for r in range(10):
        got = Simulator.sample_clients(host, r)
        want = JaxSimulator.sample_clients(host, r)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


# ------------------------------------------------------------------ models
SMALL_RESNET = dict(stage_sizes=(1, 1), filters=8)
MODELS = {   # name -> (flax module, port module, input shape)
    "lr": (lambda: jax_hub.LogisticRegression(10),
           lambda s: hub.LogisticRegression(10, s, device="cpu"), (8, 8, 1)),
    "mlp": (lambda: jax_hub.MLP(10),
            lambda s: hub.MLP(10, s, device="cpu"), (8, 8, 1)),
    "cnn": (lambda: jax_hub.CNN(10),
            lambda s: hub.CNN(10, s, device="cpu"), (8, 8, 1)),
    "resnet": (lambda: jax_hub.ResNet(10, **SMALL_RESNET),
               lambda s: hub.ResNet(10, s, device="cpu", **SMALL_RESNET),
               (8, 8, 3)),
    # the 7x7 stride-2 stem and 3x3 stride-2 "SAME" max pool
    "resnet_stem7": (
        lambda: jax_hub.ResNet(10, cifar_stem=False, **SMALL_RESNET),
        lambda s: hub.ResNet(10, s, cifar_stem=False, device="cpu",
                             **SMALL_RESNET),
        (16, 16, 3)),
}


@pytest.fixture(scope="module")
def flax_params():
    out = {}
    for name, (fj, _ft, shape) in MODELS.items():
        init = jax.jit(lambda k, m=fj(), s=shape: jax_hub.init_params(m, s, k))
        out[name] = jax.tree.map(np.asarray, init(jax.random.key(1)))
    return out


def _batch(shape, n=6, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, *shape).astype(np.float32)
    y = rs.randint(0, 10, n).astype(np.int64)
    mask = np.ones(n, np.float32)
    mask[-2:] = 0.0
    return x, y, mask


def _flat(tree):
    return {k: np.asarray(v) for k, v in hub.params_from_flax(
        tree, device="cpu").items()}


@pytest.mark.parametrize("name", list(MODELS))
def test_model_matches_flax(name, flax_params):
    """Logits (f32: 1e-5 of the largest; bf16 through
    mixed_precision_apply: 2e-2 of the largest) and the masked CE
    gradient of every parameter (f32: 1e-4 of each leaf's largest)."""
    fj, ft, shape = MODELS[name]
    pj = flax_params[name]
    x, y, mask = _batch(shape)
    mj = fj()
    params = hub.params_from_flax(pj, device="cpu")
    module = ft(shape)
    assert {k: tuple(v.shape) for k, v in module.named_parameters()} == \
        {k: tuple(v.shape) for k, v in params.items()}
    xt = torch.from_numpy(x)
    for dt, tol in (("float32", 1e-5), ("bfloat16", 2e-2)):
        want = np.asarray(jax.jit(jax_hub.mixed_precision_apply(
            mj.apply, dt))({"params": pj}, x))
        got = hub.apply_fn(module, dt)(params, xt)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=tol * np.abs(want).max(),
                                   err_msg=dt)

    def loss_j(p):
        return jax_ce(mj.apply({"params": p}, x), y, mask)[0]

    gj = _flat(jax.jit(jax.grad(loss_j))(pj))
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    masked_softmax_ce(hub.apply_fn(module)(p, xt), torch.from_numpy(y),
                      torch.from_numpy(mask))[0].backward()
    for k, v in p.items():
        np.testing.assert_allclose(v.grad.numpy(), gj[k], rtol=0,
                                   atol=1e-4 * np.abs(gj[k]).max(),
                                   err_msg=k)


def test_create_ignores_extra_model_args():
    """As the JAX hub's factories do: reference YAMLs carry model_args keys
    no model reads."""
    m = hub.create("resnet20", 10, (32, 32, 3), device="meta",
                   model_file_cache_folder="./model_file_cache")
    assert m.n_blocks == 9
    assert hub.create("lr", 10, (8, 8, 1), device="meta",
                      global_model_file_path="").Dense_0.kernel.shape == (64,
                                                                          10)


def test_same_padding_at_stride_2():
    """flax pads an even input (0, 1) at stride 2 and an odd one (1, 1)."""
    assert hub._same_pad(8, 3, 2) == (0, 1)
    assert hub._same_pad(7, 3, 2) == (1, 1)
    assert hub._same_pad(8, 1, 2) == (0, 0)
    assert hub._same_pad(8, 3, 1) == (1, 1)


def test_init_params_shapes_and_scale():
    """resnet18_gn on the meta device: every parameter the flax model has,
    at its shape (conv kernels OIHW), drawn at flax's initialisers."""
    module = hub.create("resnet18_gn", 10, (32, 32, 3), device="meta")
    params = hub.init_params(module, torch.Generator().manual_seed(0))
    flax = jax.eval_shape(lambda: jax_hub.init_params(
        jax_hub.create("resnet18_gn", 10), (32, 32, 3), jax.random.key(0)))
    want = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(prefix + (k,), v)
        else:
            shape = node.shape
            want[".".join(prefix)] = (shape[3], shape[2], *shape[:2]) \
                if len(shape) == 4 else shape

    walk((), flax)
    assert {k: tuple(v.shape) for k, v in params.items()} == want
    for k, v in params.items():
        if k.endswith("kernel"):   # lecun normal: std 1 / sqrt(fan_in)
            fan_in = v.shape[0] if v.dim() == 2 else np.prod(v.shape[1:])
            std = 1.0 / np.sqrt(fan_in)
            assert v.std().item() == pytest.approx(std, rel=0.1), k
            assert v.abs().max().item() <= 2.0 * std / 0.8796 + 1e-6
        else:
            assert (v == (1.0 if k.endswith("scale") else 0.0)).all(), k


# ------------------------------------------------------------------ rounds
N_CLIENTS, S, B = 4, 16, 4
COUNTS = np.array([16, 9, 3, 12])


def _round_data(shape):
    rs = np.random.RandomState(5)
    x = rs.randn(N_CLIENTS, S, *shape).astype(np.float32)
    y = rs.randint(0, 10, (N_CLIENTS, S)).astype(np.int64)
    mask = (np.arange(S)[None] < COUNTS[:, None]).astype(np.float32)
    return {"x": x, "y": y, "mask": mask}


ROUND_CASES = [
    ("FedAvg", "resnet", {}),
    ("FedAvg", "mlp", {"momentum": 0.9, "weight_decay": 1e-3}),
    ("FedOpt", "lr", {"server_optimizer": "adam", "server_lr": 0.01}),
    ("FedOpt", "lr", {"server_optimizer": "yogi", "server_lr": 0.01}),
    ("FedOpt", "lr", {"server_optimizer": "adagrad", "server_lr": 0.05}),
    ("FedProx", "lr", {"fedprox_mu": 0.1}),
    ("FedNova", "lr", {}),
]


def _adam_conditioned(got, want, st_t, k, r, lr, steep):
    """Adam's step is lr x m_hat / (sqrt(v_hat) + 1e-8): where sqrt(v_hat)
    is below 1e-6 the quotient turns the pseudo-gradient's last-bit
    differences (the two sides' f32 sums of client deltas agree to ~1e-6
    of the largest) into percent-level differences of the step, a property
    of the function, not of either side. Entries that were that steep in
    any round so far (`steep`, updated here) are held to Adam's own step
    bound (|step| <= lr a round, so the sides differ by <= 2 lr a round);
    the rest are returned for the round rule. `test_server_optimizers_
    match_optax` holds every entry on identical pseudo-gradients."""
    nu_hat = st_t.opt_state["nu"][k].numpy() / (1 - 0.999 ** (r + 1))
    steep[k] = steep.get(k, False) | (np.sqrt(nu_hat) < 1e-6)
    assert np.abs(got - want)[steep[k]].max(initial=0.0) <= 2 * lr * (r + 1)
    return got[~steep[k]], want[~steep[k]]


@pytest.mark.parametrize("opt,lr,mom", [("sgd", 0.5, 0.9), ("adam", 0.01, 0),
                                        ("yogi", 0.01, 0),
                                        ("adagrad", 0.05, 0)])
def test_server_optimizers_match_optax(opt, lr, mom, flax_params):
    """FedOpt's server step on identical pseudo-gradients, three steps:
    the port's hand-written optimizers compute optax's arithmetic (adam's
    and yogi's bias-corrected moments, yogi's sign rule and 1e-6 start,
    adagrad's 0.1 start and eps inside the rsqrt)."""
    kw = dict(federated_optimizer="FedOpt", server_optimizer=opt,
              server_lr=lr, server_momentum=mom)
    alg_j = jax_build_algorithm("FedOpt", None, JaxTrainArgs(**kw))
    alg_t = build_algorithm("FedOpt", None, TrainArgs(**kw))
    p0 = flax_params["mlp"]
    st_j = alg_j.server_init(jax.tree.map(jnp.asarray, p0))
    st_t = alg_t.server_init(hub.params_from_flax(p0, device="cpu"))
    rs = np.random.RandomState(3)
    for _ in range(3):
        delta = jax.tree.map(
            lambda a: (1e-2 * rs.randn(*a.shape) * (rs.rand(*a.shape) > 0.1)
                       ).astype(np.float32), p0)
        st_j = alg_j.server_update(st_j, jax.tree.map(jnp.asarray, delta))
        st_t = alg_t.server_update(st_t, hub.params_from_flax(
            delta, device="cpu"))
    want = _flat(jax.tree.map(np.asarray, st_j.params))
    for k, v in st_t.params.items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)


@pytest.mark.parametrize("alg_name,model,knobs", ROUND_CASES,
                         ids=[f"{a}-{m}-{k.get('server_optimizer', '')}"
                              for a, m, k in ROUND_CASES])
def test_rounds_match_jax(alg_name, model, knobs, flax_params):
    """Two rounds of each algorithm with health stats: parameters within
    1e-3 of the largest update (adam: see `_adam_conditioned`), train_loss
    within 1e-5 relative, the health stats within 1e-5 relative. Client 2 has 3 real samples in 16
    slots, so some of its batches are all padding and still step (weight
    decay and momentum move the weights there)."""
    fj, ft, shape = MODELS[model]
    kw = dict(epochs=1, batch_size=B, learning_rate=0.1,
              federated_optimizer=alg_name, **knobs)
    alg_j = jax_build_algorithm(
        alg_name, jax_hub.mixed_precision_apply(fj().apply, "float32"),
        JaxTrainArgs(**kw))
    alg_t = build_algorithm(alg_name, hub.apply_fn(ft(shape)),
                            TrainArgs(**kw))
    data = _round_data(shape)
    ids = np.arange(N_CLIENTS)
    weights = COUNTS.astype(np.float32)
    st_j = alg_j.server_init(jax.tree.map(jnp.asarray, flax_params[model]))
    st_t = alg_t.server_init(hub.params_from_flax(flax_params[model],
                                                  device="cpu"))
    round_j = jax_build_round_fn(alg_j, mesh=None, health_stats=True)
    round_t = build_round_fn(alg_t, health_stats=True)
    data_j = {k: jnp.asarray(v) for k, v in data.items()}
    data_t = {k: torch.from_numpy(v) for k, v in data.items()}
    steep = {}
    for r in range(2):
        before = _flat(jax.tree.map(np.asarray, st_j.params))
        rng = jax.random.fold_in(jax.random.key(2), r)
        sched = torch.from_numpy(np.stack([np.asarray(jax_batch_indices(
            jax.random.fold_in(rng, i), S, B, 1)) for i in ids]).astype(
            np.int64))
        o_j = round_j(st_j, jnp.zeros((N_CLIENTS,)), data_j,
                      jnp.asarray(ids), jnp.asarray(weights), rng, None)
        o_t = round_t(st_t, None, data_t, ids, weights, seed=r,
                      batch_idx=sched)
        st_j, st_t = o_j.server_state, o_t.server_state
        after = _flat(jax.tree.map(np.asarray, st_j.params))
        update = max(np.abs(after[k] - before[k]).max() for k in after)
        assert update > 0
        for k, v in st_t.params.items():
            got, want = v.numpy(), after[k]
            if knobs.get("server_optimizer") == "adam":
                got, want = _adam_conditioned(got, want, st_t, k, r,
                                              knobs["server_lr"], steep)
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=ROUND_TOL * update,
                                       err_msg=f"round {r} {k}")
        assert float(o_t.metrics["train_loss"]) == pytest.approx(
            float(o_j.metrics["train_loss"]), rel=1e-5)
        assert float(o_t.metrics["n_samples"]) == COUNTS.sum()
        for k, want in o_j.metrics["health"].items():
            want = np.asarray(want)
            np.testing.assert_allclose(
                o_t.metrics["health"][k].numpy(), want, rtol=1e-5,
                atol=1e-5 * np.abs(want).max(), err_msg=f"round {r} {k}")


# ------------------------------------------------------------- whole slice
def _digits_cfg():
    d = bench._digits_config()
    # evaluate at the first and the last round, on both sides
    d["validation_args"]["frequency_of_the_test"] = \
        d["train_args"]["comm_round"]
    return d


def test_digits_simulation_matches_jax():
    """bench.py's digits config (MLP, 10 clients, Dirichlet alpha 0.5,
    PARITY_HP) through `run_simulation` on both sides, the port handed the
    JAX Simulator's initial parameters and the JAX schedule of every
    round: round 0's train_loss within 1e-4, the
    final test accuracy within 0.01."""
    d = _digits_cfg()
    cj = fedml_tpu.init(config=d)
    hist_j = fedml_tpu.run_simulation(cj)
    ct = fedml_tpu_torch.init(config=d, device="cpu")
    t = ct.train_args
    ds = loader.load(ct)
    seed = ct.common_args.random_seed

    def schedule(r):
        rng = jax.random.fold_in(jax.random.key(seed), r)
        return torch.from_numpy(np.stack([np.asarray(jax_batch_indices(
            jax.random.fold_in(rng, i), ds.shard_size, t.batch_size,
            t.epochs)) for i in range(t.client_num_per_round)]).astype(
            np.int64))

    p0 = jax_hub.init_params(jax_hub.create(ct.model_args.model, 10),
                             ds.x_train.shape[2:], jax.random.key(seed))
    hist_t = fedml_tpu_torch.run_simulation(
        ct, ds, params=hub.params_from_flax(p0, device="cpu"),
        batch_schedule=schedule)
    assert len(hist_t) == len(hist_j) == t.comm_round
    assert hist_t[0]["train_loss"] == pytest.approx(
        hist_j[0]["train_loss"], abs=1e-4)
    assert abs(hist_t[-1]["test_acc"] - hist_j[-1]["test_acc"]) <= 0.01
    assert hist_t[-1]["test_acc"] > 0.8
    assert hist_t[-1]["train_loss"] < 0.5 * hist_t[0]["train_loss"]


def test_simulator_runs_with_its_own_draws():
    """The port's own batch draws (seeded by (seed, round, id)): a
    deterministic run whose loss falls; the health tracker sees every
    round."""
    d = {"data_args": {"dataset": "cifar10"},
         "model_args": {"model": "cnn"},
         "train_args": {"client_num_in_total": 3, "client_num_per_round": 2,
                        "comm_round": 3, "batch_size": 16,
                        "learning_rate": 0.05},
         "validation_args": {"frequency_of_the_test": 0}}
    ct = fedml_tpu_torch.init(config=d, device="cpu")
    ds = loader.load(ct)
    ds.x_train = ds.x_train[:, :48, :8, :8]    # 8x8 crops, 3 local steps
    ds.y_train, ds.mask_train = ds.y_train[:, :48], ds.mask_train[:, :48]
    ds.x_test, ds.y_test = ds.x_test[:64, :8, :8], ds.y_test[:64]
    runs = [Simulator(ct, ds) for _ in range(2)]
    hists = [s.run() for s in runs]
    assert hists[0] == hists[1]
    assert runs[0].health.rounds_seen == 3
    assert np.isfinite([h["train_loss"] for h in hists[0]]).all()
    assert 0.0 <= runs[0].evaluate()["test_acc"] <= 1.0


# ----------------------------------------------------------------- refusals
# (override, the ROADMAP item its refusal names or None where the knob is
# ported and the Simulator builds, sections the case adds outside its id)
REFUSED = [
    ({"device_args": {"mesh_shape": {"clients": 2}}}, "item 4", {}),
    ({"train_args": {"cost_model": True}}, "item 4", {}),
    # ported since the artifact store: the Simulator builds, and publishes
    # only to a store mlops.init set up
    ({"tracking_args": {"artifact_dir": "/nonexistent"}}, None, {}),
    # ported since the task heads, readers and model families
    ({"train_args": {"task": "nwp"}}, None,
     {"data_args": {"dataset": "shakespeare"}}),
    ({"data_args": {"dataset": "shakespeare"}}, None,
     {"model_args": {"model": "rnn"}, "train_args": {"task": "nwp"}}),
    ({"data_args": {"dataset": "pascal_voc"}}, None,
     {"model_args": {"model": "unet"},
      "train_args": {"task": "segmentation"}}),
    ({"model_args": {"model": "rnn"}}, None,
     {"data_args": {"dataset": "shakespeare"}}),
    ({"model_args": {"model": "vgg11"}}, None,
     {"data_args": {"dataset": "cifar10"}}),
]


@pytest.mark.parametrize("override,item,more", REFUSED,
                         ids=[str(o) for o, _, _ in REFUSED])
def test_unported_knobs_raise(override, item, more, tmp_path):
    d = {"data_args": {"dataset": "synthetic",
                       "data_cache_dir": str(tmp_path)},
         "train_args": {"client_num_in_total": 2}}
    for sec, kv in (*override.items(), *more.items()):
        d[sec] = {**d.get(sec, {}), **kv}
    cfg = Config.from_dict(d)
    if item is None:
        from fedml_tpu_torch import mlops

        assert mlops.artifact_store() is None
        sim = Simulator(cfg, device="cpu")
        assert sim.round_fn is not None
        want = d.get("model_args", {}).get("model", "lr")
        assert type(sim.model) is type(hub.create(
            want, sim.num_classes, sim.dataset.x_train.shape[2:],
            device="meta"))
        return
    with pytest.raises(NotImplementedError, match=item):
        Simulator(cfg, device="cpu")


# the round's plugins (item 3e): each knob builds a Simulator now
PLUGIN_KNOBS = [
    {"security_args": {"enable_attack": True}},
    {"security_args": {"enable_defense": True, "defense_type": "krum"}},
    {"dp_args": {"enable_dp": True}},
    {"train_args": {"compression": "topk"}},
    {"common_args": {"chaos": {"client_dropout": 0.1}}},
]


@pytest.mark.parametrize("override", PLUGIN_KNOBS,
                         ids=[str(o) for o in PLUGIN_KNOBS])
def test_plugin_knobs_build(override, tmp_path):
    d = {"data_args": {"dataset": "synthetic",
                       "data_cache_dir": str(tmp_path)},
         "train_args": {"client_num_in_total": 2}}
    for sec, kv in override.items():
        d[sec] = {**d.get(sec, {}), **kv}
    sim = Simulator(Config.from_dict(d), device="cpu")
    assert sim.round_fn is not None


def test_unported_round_options_raise(tmp_path):
    """The round's hooks and chaos faults build (item 3e is ported); a
    mesh still raises with its item. The tracking sinks are ported: init
    attaches the run's JSONL sink, once however often it is called."""
    alg = build_algorithm("FedAvg", lambda p, x: x, TrainArgs())
    build_round_fn(alg, postprocess_update=lambda u, r: u)
    build_round_fn(alg, client_dropout=0.1)
    with pytest.raises(NotImplementedError, match="item 4"):
        build_round_fn(alg, mesh=object())
    from fedml_tpu_torch.utils.events import recorder
    from fedml_tpu_torch.utils.sinks import JsonlSink

    n0 = len(recorder.sinks)
    d = {"tracking_args": {"enable_tracking": True,
                           "log_file_dir": str(tmp_path), "run_name": "t"}}
    try:
        for _ in range(2):
            fedml_tpu_torch.init(config=d, device="cpu")
        added = recorder.sinks[n0:]
        assert len(added) == 1 and isinstance(added[0], JsonlSink)
        assert added[0].path == str(tmp_path / "t.events.jsonl")
    finally:
        for sink in recorder.sinks[n0:]:
            sink.close()
        del recorder.sinks[n0:]


def test_no_gpu_no_fallback():
    """Without device="cpu" the Simulator and init ask for CUDA and raise
    where no GPU is visible; nothing carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: CUDA is the right default here")
    cfg = Config.from_dict({"train_args": {"client_num_in_total": 2}})
    with pytest.raises(RuntimeError, match="no GPU"):
        Simulator(cfg)
    with pytest.raises(RuntimeError, match="no GPU"):
        fedml_tpu_torch.init(config={})
    with pytest.raises(RuntimeError, match="no GPU"):
        hub.create("mlp", 10, (8, 8, 1))
