"""Hierarchical cross-silo in the port (`parallel/hier.py`,
`SiloTrainer(mesh=)`, `cross_silo/hierarchical.py`, the runner's
`scenario: hierarchical` routes) against the JAX package's and against
flat FedAvg, on the CPU; `tests/test_hierarchical.py` is the model.

The SPMD cases run in 4 gloo ranks spawned once for the module (the
`runs` fixture runs them all, stops the ranks and checks their exit
codes); `run_hierarchical` and the client route's silo mesh start their
own ranks and stop them when they end. The JAX side runs over the CPU
devices `conftest.py` forces and hands the ranks its draws.

Bars (f32 max abs error over the largest update): the 4-rank silo trainer
within 1e-5 of JAX's 4-device silo mesh and of the port's unmeshed
trainer; the (silos 2, intra 2) round within 1e-5 of JAX's (2, 4) round
on the same global batches, and of the flat round with full batches; the
runner's Simulator over a (silos 2, intra 2) and a (clients 4) mesh
within 1e-5 of the unmeshed Simulator with full batches;
`run_hierarchical` within 1e-5 of flat FedAvg over the same trainers.
"""
import os
import sys

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from fedml_tpu.algorithms.builtin import make_fedavg as jax_make_fedavg
    from fedml_tpu.algorithms.builtin import (
        build_algorithm as jax_build_algorithm,
    )
    from fedml_tpu.config import TrainArgs as JaxTrainArgs
    from fedml_tpu.core.algorithm import (
        make_batch_indices as jax_batch_indices,
        make_client_optimizer as jax_make_opt,
    )
    from fedml_tpu.cross_silo import SiloTrainer as JaxSiloTrainer
    from fedml_tpu.cross_silo.hierarchical import (
        partition_devices as jax_partition_devices,
        silo_mesh as jax_silo_mesh,
    )
    from fedml_tpu.cross_silo.server import FedAggregator as JaxAggregator
    from fedml_tpu.models import hub as jax_hub
    from fedml_tpu.parallel.hier import (
        make_hier_round as jax_make_hier_round,
        shard_hier_data as jax_shard_hier_data,
    )
    from fedml_tpu.parallel.mesh import make_mesh as jax_make_mesh
except ModuleNotFoundError:
    pass

import fedml_tpu_torch
from fedml_tpu_torch.algorithms.builtin import build_algorithm
from fedml_tpu_torch.config import TrainArgs
from fedml_tpu_torch.cross_silo import FedAggregator, SiloTrainer
from fedml_tpu_torch.cross_silo.hierarchical import (
    partition_devices, run_hierarchical,
)
from fedml_tpu_torch.models import hub
from fedml_tpu_torch.ops import tree as tu
from fedml_tpu_torch.parallel.hier import make_hier_round
from fedml_tpu_torch.parallel.launch import RankPool
from fedml_tpu_torch.parallel.round import build_round_fn

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mesh_ranks as ranks  # noqa: E402

torch.set_num_threads(2)

TOL = 1e-5   # max |param diff| over the largest update


def _toy(seed, n=64, d=8, k=3):
    rs = np.random.RandomState(seed)
    w_true = rs.randn(d, k)
    x = rs.randn(n, d).astype(np.float32)
    y = np.argmax(x @ w_true, axis=1).astype(np.int32)
    return x, y


def _flat(tree):
    return {k: v.numpy() for k, v in hub.params_from_flax(
        tree, device="cpu").items()}


def _p0(seed=0):
    return jax.tree.map(np.asarray, jax_hub.init_params(
        jax_hub.create("lr", 3), (8,), jax.random.key(seed)))


def _close(got: dict, want: dict, start: dict, what: str):
    update = max(np.abs(want[k] - start[k]).max() for k in want)
    assert update > 0, what
    err = max(np.abs(np.asarray(got[k]) - want[k]).max() for k in want)
    assert err <= TOL * update, f"{what}: {err / update:.3g} of the update"


# ---------------------------------------------------------- no ranks
@pytest.mark.parametrize("n_silos,n_dev", [(2, 8), (3, 8), (4, 4), (5, 4)])
def test_partition_devices_as_jax(n_silos, n_dev):
    """Contiguous groups, the first silos one device more when uneven;
    more silos than devices is JAX's error."""
    devs = list(range(n_dev))
    try:
        want = jax_partition_devices(n_silos, devs)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            partition_devices(n_silos, devs)
        assert str(got.value) == str(e)
        return
    assert partition_devices(n_silos, devs) == want
    assert partition_devices(n_silos, ["cuda:0"] * n_dev) == [
        ["cuda:0"] * len(g) for g in want]


@pytest.mark.parametrize("name", ["FedProx", "SCAFFOLD", "FedNova"])
def test_hier_round_takes_fedavg_only_as_jax(name):
    t = dict(federated_optimizer=name)
    alg_j = jax_build_algorithm(name, None, JaxTrainArgs(**t), 4, 4)
    alg_t = build_algorithm(name, None, TrainArgs(**t), 4, 4)
    with pytest.raises(ValueError) as want:
        jax_make_hier_round(None, alg_j, None, None, 16, 1)
    with pytest.raises(ValueError) as got:
        make_hier_round(None, alg_t, None, None, 16, 1)
    assert str(got.value) == str(want.value)


def test_aggregate_fn_as_jax():
    """FedAggregator(aggregate_fn=) merges with the given function (a
    coordinate median here) on the stacked results, as JAX's does."""
    rs = np.random.RandomState(2)
    results = {c: ({"w": rs.randn(4, 3).astype(np.float32),
                    "b": rs.randn(3).astype(np.float32)}, float(c + 1))
               for c in (3, 1, 2)}
    aggs = [JaxAggregator(lambda s, w: jax.tree.map(
                lambda a: jnp.median(a, axis=0), s)),
            FedAggregator("cpu", lambda s, w: tu.tree_map(
                lambda a: a.median(0).values, s))]
    outs = []
    for agg in aggs:
        agg.reset(results)
        for c, (p, n) in results.items():
            agg.add_local_trained_result(c, p, n)
        outs.append(agg.aggregate())
    for k in outs[1]:
        np.testing.assert_array_equal(outs[1][k], np.asarray(outs[0][k]))
    plain = FedAggregator("cpu")
    plain.reset(results)
    for c, (p, n) in results.items():
        plain.add_local_trained_result(c, p, n)
    assert not np.array_equal(plain.aggregate()["w"], outs[1]["w"])


# ------------------------------------------------------- the SPMD cases
def _silo_specs():
    """SiloTrainer over a 4-rank data mesh: JAX's 4-device silo trainer
    (62 samples, padded to 64) with its draws, and the port's unmeshed
    trainer with draws over the 62 real rows."""
    x, y = _toy(0, n=62)
    train = dict(epochs=2, batch_size=16, learning_rate=0.2)
    p0 = _p0()
    tj = JaxSiloTrainer(jax_hub.create("lr", 3).apply, JaxTrainArgs(**train),
                        x, y, mesh=jax_silo_mesh(jax.devices()[:4]), seed=7)
    sched_j = np.asarray(jax_batch_indices(
        jax.random.fold_in(jax.random.key(7), 0), 64, 16, 2), np.int64)
    want = tj.train(p0, 0)
    sched_t = np.stack([np.random.RandomState(e).permutation(62)[:48]
                        for e in range(2)]).reshape(6, 16)
    flat = SiloTrainer(hub.create("lr", 3, (8,), device="meta"),
                       TrainArgs(**train), x, y, seed=7, device="cpu",
                       batch_schedule=lambda r: sched_t)
    spec = {"model": ("lr", 3, (8,)), "train": train, "x": x, "y": y,
            "params": _flat(p0)}
    return (dict(spec, sched=sched_j), want, dict(spec, sched=sched_t),
            flat.train(_flat(p0), 0), p0)


def _hier_specs():
    """Two (silos, intra) round pairs on 4 clients of 32 samples:
    minibatches against JAX's (2, 4) round (the port's intra rank i' takes
    JAX devices 2i' and 2i'+1's local draws), full batches against the
    port's flat round."""
    n, s = 4, 32
    xs, ys = zip(*[_toy(i, n=s) for i in range(n)])
    data = {"x": np.stack(xs), "y": np.stack(ys).astype(np.int64),
            "mask": np.ones((n, s), np.float32)}
    ids, weights = np.arange(n), np.full((n,), float(s), np.float32)
    p0 = _p0(1)
    out = {}
    for tag, batch, epochs in (("mini", 8, 1), ("full", s, 2)):
        train = dict(epochs=epochs, batch_size=batch, learning_rate=0.2)
        rounds = []
        for r in range(2):
            rng = jax.random.fold_in(jax.random.key(42), r)
            jdraw = [np.asarray(jax_batch_indices(jax.random.fold_in(
                rng, int(i)), s // 4, batch // 4, epochs)) for i in ids]
            rounds.append({"round": r, "ids": ids, "weights": weights,
                           "jax": jdraw, "sched": np.stack([
                               np.concatenate([d, d + s // 4], axis=1)
                               for d in jdraw]).astype(np.int64)})
        out[tag] = {"model": ("lr", 3, (8,)), "params": _flat(p0),
                    "data": data, "rounds": rounds,
                    "train": dict(train, federated_optimizer="FedAvg")}
    # JAX's (2, 4) rounds on the minibatch draws
    mesh = jax_make_mesh({"silos": 2, "intra": 4})
    t = JaxTrainArgs(**dict(out["mini"]["train"]))
    apply = jax_hub.create("lr", 3).apply
    alg = jax_make_fedavg(apply, t)
    fn = jax_make_hier_round(apply, alg, mesh, jax_make_opt(
        t.client_optimizer, t.learning_rate, t.momentum, t.weight_decay),
        batch_size=t.batch_size, epochs=t.epochs)
    st = alg.server_init(jax.tree.map(jnp.asarray, p0), None)
    hdata = jax_shard_hier_data(data, mesh)
    mets = []
    for r in range(2):
        st, m = fn(st, hdata, jnp.asarray(ids), jnp.asarray(weights),
                   jax.random.fold_in(jax.random.key(42), r))
        mets.append(jax.tree.map(float, m))
    out["jax"] = (_flat(jax.tree.map(np.asarray, st.params)), mets)
    # the port's flat round on the full batches (global rows, each step)
    full = out["full"]
    alg_t = build_algorithm("FedAvg", hub.apply_fn(hub.create(
        "lr", 3, (8,), device="cpu")), TrainArgs(**full["train"]))
    st_t = alg_t.server_init({k: torch.from_numpy(v)
                              for k, v in full["params"].items()}, None)
    flat = build_round_fn(alg_t)
    tdata = {k: torch.from_numpy(v) for k, v in data.items()}
    fmets = []
    for rd in full["rounds"]:
        o = flat(st_t, None, tdata, ids, weights, (0, rd["round"]),
                 batch_idx=torch.from_numpy(np.stack([
                     np.concatenate([d, d + 8, d + 16, d + 24], axis=1)
                     for d in rd["jax"]]).astype(np.int64)))
        st_t = o.server_state
        fmets.append({k: float(v) for k, v in o.metrics.items()})
    out["flat"] = ({k: v.numpy() for k, v in st_t.params.items()}, fmets)
    out["p0"] = _flat(p0)
    return out


FULL_B = 128   # the padded shard of _runner_cfg's largest client


def _runner_cfg(tmp, mesh_shape=None):
    """The runner's simulation case: 5 clients of varied counts (hetero,
    64-128 samples), 3 a round, two local steps, each a full batch (the
    batch is the padded shard), so the hierarchical round's split of the
    batch over `intra` leaves the step the flat one."""
    d = {"common_args": {"random_seed": 0, "scenario": "hierarchical"},
         "data_args": {"dataset": "synthetic", "data_cache_dir": str(tmp),
                       "partition_method": "hetero", "partition_alpha": 0.5,
                       "extra": {"synthetic_samples_per_client": 16}},
         "model_args": {"model": "lr"},
         "train_args": {"client_num_in_total": 5,
                        "client_num_per_round": 3, "comm_round": 2,
                        "epochs": 2, "batch_size": FULL_B,
                        "learning_rate": 0.1},
         "validation_args": {"frequency_of_the_test": 0}}
    if mesh_shape is not None:
        d.update(comm_args={"backend": "xla"},
                 device_args={"mesh_shape": mesh_shape})
    return d


def _unmeshed_sim(tmp, rounds=2):
    """The port's unmeshed Simulator on `_runner_cfg`: (history, initial
    and final parameters, the dataset)."""
    from fedml_tpu_torch.simulation.simulator import Simulator

    sim = Simulator(fedml_tpu_torch.init(config=_runner_cfg(tmp),
                                         device="cpu"))
    assert sim.mesh is None
    p0 = {k: v.numpy().copy() for k, v in sim.server_state.params.items()}
    hist = sim.run(num_rounds=rounds)
    return hist, p0, {k: v.numpy() for k, v in
                      sim.server_state.params.items()}, sim.dataset


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("hier")
    pool = RankPool(["cpu"] * 4, timeout_s=240.0)
    out = {}
    try:
        out["silo"] = _silo_specs()
        out["hier"] = _hier_specs()
        out["port"] = {
            "silo_jax": pool.run(ranks.silo_trainer, out["silo"][0]),
            "silo_flat": pool.run(ranks.silo_trainer, out["silo"][2]),
            "hier_mini": pool.run(ranks.hier_round, out["hier"]["mini"]),
            "hier_full": pool.run(ranks.hier_round, out["hier"]["full"]),
            "runner_hier": pool.run(ranks.runner_sim, _runner_cfg(
                tmp, {"silos": 2, "intra": 2})),
            "runner_flat": pool.run(ranks.runner_sim, _runner_cfg(
                tmp, {"clients": 4})),
        }
        out["runner_ref"] = _unmeshed_sim(tmp)
    finally:
        out["exitcodes"] = pool.close()
    return out


def test_ranks_exit_cleanly(runs):
    assert runs["exitcodes"] == [0, 0, 0, 0]


@pytest.mark.parametrize("case", ["silo_jax", "silo_flat"])
def test_silo_trainer_over_a_data_mesh(runs, case):
    """DDP inside the silo: every rank ends with the same parameters, the
    62 real samples padded to 64 with 2 zero-mask rows, counted as 62;
    within 1e-5 of JAX's 4-device silo trainer (its draws over the padded
    rows) and of the port's unmeshed trainer (draws over the real rows)."""
    spec_j, want_j, _spec_t, want_t, p0 = runs["silo"]
    got = runs["port"][case]
    for g in got:
        assert g["n"] == 62 and g["pad"] == 2
        for k, v in g["params"].items():
            np.testing.assert_array_equal(v, got[0]["params"][k])
    want = want_j if case == "silo_jax" else want_t
    ref = _flat(want[0]) if case == "silo_jax" else want[0]
    _close(got[0]["params"], ref, _flat(p0), case)
    assert got[0]["metrics"]["train_loss"] == pytest.approx(
        want[2]["train_loss"], rel=1e-5)


def test_hier_round_matches_jax_on_the_same_global_batches(runs):
    """(silos 2, intra 2) against JAX's (silos 2, intra 4), two minibatch
    rounds: each step's global batch is the same set of samples."""
    got = runs["port"]["hier_mini"]
    params_j, mets_j = runs["hier"]["jax"]
    assert [g["coord"] for g in got] == [[0, 0], [0, 1], [1, 0], [1, 1]]
    for g in got[1:]:
        for k, v in g["params"].items():
            np.testing.assert_array_equal(v, got[0]["params"][k])
    _close(got[0]["params"], params_j, runs["hier"]["p0"], "hier vs jax")
    for mt, mj in zip(got[0]["metrics"], mets_j):
        assert float(mt["train_loss"]) == pytest.approx(mj["train_loss"],
                                                        rel=1e-5)
        assert float(mt["n_samples"]) == mj["n_samples"]


def test_hier_round_matches_the_flat_round_full_batch(runs):
    """With every step a full batch, the intra all-reduced gradient over
    the global count is the flat batch-mean gradient."""
    got = runs["port"]["hier_full"][0]
    params_f, mets_f = runs["hier"]["flat"]
    _close(got["params"], params_f, runs["hier"]["p0"], "hier vs flat")
    for mt, mf in zip(got["metrics"], mets_f):
        assert float(mt["train_loss"]) == pytest.approx(mf["train_loss"],
                                                        rel=1e-5)
        assert float(mt["n_samples"]) == mf["n_samples"] == 4 * 32 * 2


@pytest.mark.parametrize("case", ["runner_hier", "runner_flat"])
def test_runner_simulation_routes(runs, case):
    """scenario: hierarchical through FedMLRunner: a (silos 2, intra 2)
    mesh runs the hierarchical round, a (clients 4) mesh the flat one.
    Each round's 3 sampled clients are padded to 4 with a zero-weight
    duplicate of the first, and over the 2 silos placed by balanced LPT
    (varied counts); the clients mesh (4 slots over 4 ranks) keeps the
    padded order. Against the unmeshed Simulator on the same config (its
    cohort unpadded and unplaced, every step a full batch, so the order
    of a client's rows does not matter): the parameters within 1e-5 of
    the largest update, train_loss within 1e-5 relative, and n_samples
    the sampled clients' real samples times the epochs."""
    got = runs["port"][case]
    hist_ref, p0_ref, params_ref, ds = runs["runner_ref"]
    hier = case == "runner_hier"
    assert ds.shard_size == FULL_B
    assert [r["hier"] for r in got] == [hier] * 4
    lead = got[0]
    for k, v in lead["p0"].items():
        np.testing.assert_array_equal(v, p0_ref[k])
    counts = np.asarray(ds.counts, np.float32)
    permuted = []
    for sampled, (ids, weights) in zip(lead["sampled"], lead["placed"]):
        padded = list(sampled) + [sampled[0]]
        assert sorted(ids.tolist()) == sorted(padded)
        assert sorted(weights.tolist()) == sorted(
            [0.0] + counts[sampled].tolist())
        real = weights > 0
        np.testing.assert_array_equal(weights[real], counts[ids[real]])
        permuted.append(ids.tolist() != padded)
    assert any(permuted) if hier else not any(permuted)
    assert len(lead["history"]) == len(hist_ref) == 2
    for r, (a, b) in enumerate(zip(lead["history"], hist_ref)):
        assert a["n_samples"] == b["n_samples"] == 2 * counts[
            lead["sampled"][r]].sum()
        assert a["train_loss"] == pytest.approx(b["train_loss"], rel=1e-5)
    _close(lead["params"], params_ref, p0_ref, case)


@pytest.mark.parametrize("n_dev", [4, 3])
def test_run_hierarchical_matches_flat_fedavg(n_dev):
    """2 silos over loopback, two rounds, against flat FedAvg computed
    from unmeshed trainers (the weighted mean by hand). Over 4 devices
    both silos are 2-rank silo meshes; over 3, the second silo has one
    device and trains flat in this process, with no ranks. Each silo rank
    ran one inner all-reduce a step, and every rank exited 0."""
    model = hub.create("lr", 3, (8,), device="meta")
    t = TrainArgs(epochs=1, batch_size=16, learning_rate=0.2)
    silo_data = [_toy(s) for s in (0, 1)]
    p0 = _flat(_p0())
    server = run_hierarchical(model, p0, t, silo_data, num_rounds=2,
                              devices=["cpu"] * n_dev, timeout_s=120)
    assert len(server.history) == 2
    ranked = [2, 2] if n_dev == 4 else [2, 0]
    assert server.silo_exitcodes == [[0] * k for k in ranked]
    steps = 64 // 16
    assert server.silo_rank_stats == [[{
        "allreduce_steps": steps, "peak_bytes": 0, "kernel_launches": 0}]
        * k for k in ranked]
    flats = [SiloTrainer(model, t, x, y, seed=i, device="cpu")
             for i, (x, y) in enumerate(silo_data)]
    p = p0
    for r in range(2):
        outs = [tr.train(p, r) for tr in flats]
        stacked = tu.tree_stack([{k: torch.from_numpy(v)
                                  for k, v in o[0].items()} for o in outs])
        w = torch.tensor([o[1] for o in outs], dtype=torch.float32)
        p = {k: v.numpy() for k, v in tu.tree_weighted_mean(
            stacked, w).items()}
    _close(server.params, p, p0, "run_hierarchical")


def test_runner_cross_silo_client_route(tmp_path):
    """A cross-silo client under `scenario: hierarchical`: with one device
    (a CPU `device` here, or one GPU) the flat trainer, bit for bit the
    plain SiloTrainer; over a given intra-silo mesh (a 2-rank silo mesh
    here, each step's gradient all-reduced over its ranks) within 1e-5 of
    it; anything but a mesh is a TypeError."""
    from fedml_tpu_torch.cross_silo.hierarchical import silo_mesh
    from fedml_tpu_torch.runner import FedMLRunner

    def cfg(tag):
        return fedml_tpu_torch.init(config={
            "common_args": {"training_type": "cross_silo",
                            "scenario": "hierarchical"},
            "train_args": {"client_num_in_total": 2, "epochs": 1,
                           "batch_size": 16, "learning_rate": 0.2},
            "comm_args": {"run_id": f"hier-{tag}-{os.getpid()}"}},
            device="cpu")

    x, y = _toy(3)
    model = hub.create("lr", 3, (8,), device="meta")
    p0 = _flat(_p0())
    want = SiloTrainer(model, cfg("flat").train_args, x, y, seed=1,
                       device="cpu").train(p0, 0)
    r = FedMLRunner(cfg("flat"), dataset=(x, y), model=model,
                    role="client", rank=1)
    try:
        tr = r.runner.trainer
        assert tr.mesh is None
        got = tr.train(p0, 0)
        for k, v in want[0].items():
            np.testing.assert_array_equal(got[0][k], v)
    finally:
        r.runner.comm.transport.stop_receive_message()
    silo = silo_mesh(["cpu"] * 2, timeout_s=120)
    try:
        r = FedMLRunner(cfg("mesh"), dataset=(x, y), model=model,
                        role="client", rank=1, mesh=silo)
        tr = r.runner.trainer
        assert tr.mesh is silo
        got = tr.train(p0, 0)
        _close(got[0], want[0], p0, "client route")
        assert tr.rank_stats == [{"allreduce_steps": 4, "peak_bytes": 0,
                                  "kernel_launches": 0}] * 2
        r.runner.comm.transport.stop_receive_message()
    finally:
        assert silo.close() == [0, 0]
    with pytest.raises(TypeError, match="DeviceMesh"):
        FedMLRunner(cfg("bad"), dataset=(x, y), model=model, role="client",
                    rank=1, mesh=object())
