"""The round's plugins in the port's Simulator (`fedml_tpu_torch`) against
the JAX Simulator, on the CPU: a small CNN on the digits set (bench.py's
`_digits_config` shape, 8 clients, 6 a round), the port handed the JAX
initial parameters (`Simulator(params=)`) and every round's JAX batch
schedule (`run_round(batch_idx=)`), and under chaos faults the JAX
round's masks (`run_round(faults=)`).

Bars: each deterministic plugin's run within 1e-5 of the JAX run's
largest parameter update, and its train_loss within 1e-5 relative;
dp_epsilon bitwise; and the port's own bars, bitwise: chunked ==
single-shot, block == per-round, resumed == uninterrupted.
"""
import numpy as np
import pytest
import torch

try:
    import jax

    import fedml_tpu
    from fedml_tpu.core.algorithm import (
        make_batch_indices as jax_batch_indices,
    )
    from fedml_tpu.simulation.simulator import Simulator as JaxSimulator
except ModuleNotFoundError:
    pass

import fedml_tpu_torch
from fedml_tpu_torch.data import loader
from fedml_tpu_torch.models import hub
from fedml_tpu_torch.simulation.simulator import Simulator

torch.set_num_threads(2)

pytestmark = pytest.mark.filterwarnings(
    "error:There is a performance drop because we have not yet implemented "
    "the batching rule")

TOL = 1e-5   # max |param diff| over the JAX run's largest update
N, M = 8, 6


def _cfg(rounds=2, opt="FedAvg", extra=None, **sections):
    d = {"common_args": {"random_seed": 0},
         "data_args": {"dataset": "digits", "partition_method": "hetero",
                       "partition_alpha": 0.5},
         "model_args": {"model": "cnn"},
         "train_args": {"federated_optimizer": opt,
                        "client_num_in_total": N, "client_num_per_round": M,
                        "comm_round": rounds, "epochs": 1, "batch_size": 32,
                        "learning_rate": 0.1, "extra": extra or {}},
         "validation_args": {"frequency_of_the_test": 0},
         "comm_args": {"backend": "sp"}}
    for sec, kv in sections.items():
        d[sec] = {**d.get(sec, {}), **kv}
    return d


def _defense(name, **spec):
    return {"security_args": {"enable_defense": True, "defense_type": name,
                              "defense_spec": spec}}


def _attack(name, **spec):
    return {"security_args": {"enable_attack": True, "attack_type": name,
                              "attack_spec": spec}}


@pytest.fixture(scope="module")
def digits():
    ct = fedml_tpu_torch.init(config=_cfg(), device="cpu")
    return loader.load(ct)


def _run_pair(d, digits, rounds):
    """The JAX Simulator's rounds, then the port's with its parameters,
    schedules and fault masks: (JAX rows, port rows, p0, JAX params, port
    sim, JAX sim)."""
    sim_j = JaxSimulator(fedml_tpu.init(config=d))
    faults = []
    observe = sim_j.health.observe_round

    def capture(*a, **kw):
        faults.append(kw.get("faults"))
        return observe(*a, **kw)

    sim_j.health.observe_round = capture
    p0 = jax.tree.map(np.asarray, sim_j.params)
    rows_j = [sim_j.run_round(r) for r in range(rounds)]
    ct = fedml_tpu_torch.init(config=d, device="cpu")
    sim_t = Simulator(ct, digits, params=hub.params_from_flax(p0,
                                                              device="cpu"))
    t = ct.train_args
    key = jax.random.key(ct.common_args.random_seed)
    rows_t = []
    for r in range(rounds):
        rng = jax.random.fold_in(key, r)
        sched = torch.from_numpy(np.stack([np.asarray(jax_batch_indices(
            jax.random.fold_in(rng, int(i)), digits.shard_size,
            t.batch_size, t.epochs)) for i in sim_t.sample_clients(r)
        ]).astype(np.int64))
        rows_t.append(sim_t.run_round(r, batch_idx=sched, faults=faults[r]))
    final_j = jax.tree.map(np.asarray, sim_j.server_state.params)
    return rows_j, rows_t, p0, final_j, sim_t, sim_j


def _flat(tree):
    return {k: v.numpy() for k, v in hub.params_from_flax(
        tree, device="cpu").items()}


def _flat_stacked(tree, n):
    """A [n, ...]-stacked flax tree as the port's stacked dict."""
    rows = [_flat(jax.tree.map(lambda a: np.asarray(a)[i], tree))
            for i in range(n)]
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def _assert_close_run(rows_j, rows_t, p0, final_j, sim_t, what):
    init, final = _flat(p0), _flat(final_j)
    update = max(np.abs(final[k] - init[k]).max() for k in final)
    assert update > 0, what
    err = max(np.abs(sim_t.server_state.params[k].numpy() - final[k]).max()
              for k in final)
    assert err <= TOL * update, f"{what}: {err / update:.3g} of the update"
    for a, b in zip(rows_t, rows_j):
        assert a["train_loss"] == pytest.approx(b["train_loss"], rel=1e-5), \
            what
        assert a["n_samples"] == b["n_samples"], what


DETERMINISTIC = {
    "krum": (_defense("krum", byzantine_client_num=1), 2),
    "multikrum": (_defense("multikrum", byzantine_client_num=1), 2),
    "wise_median": (_defense("wise_median"), 2),
    "trimmed_mean": (_defense("trimmed_mean", beta=1), 2),
    "foolsgold": (_defense("foolsgold"), 3),
    "norm_diff_clipping": (_defense("norm_diff_clipping", norm_bound=0.5),
                           2),
    "dp_clip": ({"dp_args": {"enable_dp": True, "dp_solution_type": "dp_clip",
                             "clipping_norm": 0.5}}, 2),
    "topk": ({"train_args": {"extra": {"compression": "topk",
                                       "compression_ratio": 0.1}}}, 2),
    "eftopk": ({"train_args": {"extra": {"compression": "eftopk",
                                         "compression_ratio": 0.1}}}, 3),
    "byzantine_flip": (_attack("byzantine", attack_mode="flip",
                               byzantine_client_num=2), 2),
    "lazy_worker": (_attack("lazy_worker", byzantine_client_num=2), 3),
    "label_flipping": (_attack("label_flipping",
                               poisoned_client_ids=[0, 3]), 2),
    "backdoor": (_attack("backdoor", poisoned_client_ids=[1],
                         target_class=2, scale_factor=2.0), 2),
}


@pytest.mark.parametrize("name", list(DETERMINISTIC))
def test_deterministic_plugin_matches_jax(name, digits):
    sections, rounds = DETERMINISTIC[name]
    extra = sections.get("train_args", {}).get("extra")
    others = {k: v for k, v in sections.items() if k != "train_args"}
    d = _cfg(rounds, extra=extra, **others)
    rows_j, rows_t, p0, final_j, sim_t, sim_j = _run_pair(d, digits, rounds)
    _assert_close_run(rows_j, rows_t, p0, final_j, sim_t, name)
    if name == "foolsgold":
        # the two flat layouts order the coordinates apart (flax's sorted
        # leaves and kernel layouts): hold the histories' gram matrices
        hist_j = np.asarray(sim_j.hook_state["dfs"], np.float64)
        h = sim_t.hook_state["dfs"].numpy().astype(np.float64)
        assert h.shape == hist_j.shape == (N, h.shape[1])
        gj = hist_j @ hist_j.T
        assert np.abs(h @ h.T - gj).max() <= TOL * np.abs(gj).max()
    if name == "eftopk":
        res_j = _flat_stacked(sim_j.client_states["residual"], N)
        for k, v in res_j.items():
            got = sim_t.client_states["residual"][k].numpy()
            assert np.abs(got - v).max() <= TOL * max(np.abs(v).max(), 1e-12)


def test_chaos_faults_match_jax(digits):
    """SCAFFOLD under client_dropout 0.3 and client_straggler 0.2 with the
    JAX round's masks: the aggregate over the survivors, and every
    faulted client's control variate at its pre-round value."""
    d = _cfg(3, opt="SCAFFOLD",
             common_args={"chaos": {"client_dropout": 0.3,
                                    "client_straggler": 0.2}})
    rows_j, rows_t, p0, final_j, sim_t, sim_j = _run_pair(d, digits, 3)
    _assert_close_run(rows_j, rows_t, p0, final_j, sim_t, "chaos")
    cs_j = _flat_stacked(sim_j.client_states, N)
    for k, v in cs_j.items():
        got = sim_t.client_states[k].numpy()
        assert np.abs(got - v).max() <= TOL * max(np.abs(v).max(), 1e-12), k


def test_chaos_keeps_faulted_state_and_reweights(digits):
    """The port alone: a faulted client's state unchanged bitwise by its
    round, a survivor's moved, and a round whose every client faults
    leaves the FedAvg parameters where they were."""
    d = _cfg(1, opt="SCAFFOLD")
    sim = Simulator(fedml_tpu_torch.init(config=d, device="cpu"), digits)
    sim.run_round(0)
    before = {k: v.clone() for k, v in sim.client_states.items()}
    ids = sim.sample_clients(1)
    dropped = np.zeros(M, np.float32)
    dropped[[0, 3]] = 1
    straggled = np.zeros(M, np.float32)
    straggled[5] = 1
    # a plain round has no chaos draws: give it a chaos-configured twin
    d2 = _cfg(1, opt="SCAFFOLD", common_args={"chaos": {
        "client_dropout": 0.5}})
    sim2 = Simulator(fedml_tpu_torch.init(config=d2, device="cpu"), digits,
                     params={k: v.clone() for k, v in
                             sim.server_state.params.items()})
    sim2.client_states = {k: v.clone() for k, v in before.items()}
    sim2.server_state = sim.server_state
    sim2.run_round(1, faults={"dropped": dropped, "straggled": straggled})
    for slot, c in enumerate(ids):
        same = all(torch.equal(sim2.client_states[k][c], before[k][c])
                   for k in before)
        assert same == bool(dropped[slot] or straggled[slot]), (slot, c)
    p = {k: v.clone() for k, v in sim2.server_state.params.items()}
    d3 = _cfg(1, common_args={"chaos": {"client_dropout": 0.5}})
    sim3 = Simulator(fedml_tpu_torch.init(config=d3, device="cpu"), digits,
                     params=p)
    row = sim3.run_round(0, faults={"dropped": np.ones(M),
                                    "straggled": np.zeros(M)})
    assert row["n_samples"] == 0
    for k in p:
        assert torch.equal(sim3.server_state.params[k], p[k])


def test_injected_faults_ride_chunks(digits):
    """The same injected masks in cohort chunks of 4 (the cohort padded
    with ids[0]'s duplicates) and single-shot: bitwise the same round."""
    faults = {"dropped": np.array([0, 1, 0, 0, 0, 1], np.float32),
              "straggled": np.array([0, 0, 1, 0, 0, 0], np.float32)}
    sims = []
    for extra in ({}, {"cohort_chunk": 4}):
        d = _cfg(1, opt="SCAFFOLD", extra=extra, **_defense("wise_median"),
                 common_args={"chaos": {"client_dropout": 0.5}})
        sim = Simulator(fedml_tpu_torch.init(config=d, device="cpu"), digits)
        sim.history.append({"round": 0, **sim.run_round(0, faults=faults)})
        sims.append(sim)
    _same(*sims)


def test_dp_epsilon_bitwise(digits):
    """LDP through both Simulators, 3 rounds: dp_epsilon equal bitwise
    every round (the noise itself is each package's own draw)."""
    d = _cfg(3, dp_args={"enable_dp": True, "dp_solution_type": "ldp",
                         "epsilon": 0.5, "clipping_norm": 1.0})
    hist_j = JaxSimulator(fedml_tpu.init(config=d)).run()
    sim = Simulator(fedml_tpu_torch.init(config=d, device="cpu"), digits)
    hist_t = sim.run()
    eps = [h["dp_epsilon"] for h in hist_t]
    assert eps == [h["dp_epsilon"] for h in hist_j]
    assert 0 < eps[0] < eps[1] < eps[2]
    assert all(np.isfinite(h["train_loss"]) for h in hist_t)


def test_crfl_refused_as_in_jax(digits):
    """CRFL has no aggregation of its own in the JAX dispatch: both
    Simulators raise the same error at the first round."""
    d = _cfg(1, **_defense("crfl"))
    with pytest.raises(ValueError, match="not dispatchable"):
        JaxSimulator(fedml_tpu.init(config=d)).run_round(0)
    with pytest.raises(ValueError, match="not dispatchable"):
        Simulator(fedml_tpu_torch.init(config=d, device="cpu"),
                  digits).run_round(0)


# ------------------------------------------------------ the port's own bars
BITWISE = {
    "median_chaos_ldp": dict(
        **_defense("wise_median"),
        dp_args={"enable_dp": True, "dp_solution_type": "ldp",
                 "epsilon": 0.5, "sensitivity": 0.002, "clipping_norm": 1.0},
        common_args={"chaos": {"client_dropout": 0.3,
                               "client_straggler": 0.2}}),
    "foolsgold": _defense("foolsgold"),
}


def _same(a, b):
    assert a.history == b.history
    for x, y in ((a.server_state.params, b.server_state.params),
                 (a.client_states, b.client_states)):
        if x is None:
            assert y is None
            continue
        for k in x:
            assert torch.equal(x[k], y[k]), k
    ha, hb = a.hook_state, b.hook_state
    assert (ha is None) == (hb is None)
    if ha is not None:
        for k in ha:
            assert (ha[k] is None) == (hb[k] is None)
            assert ha[k] is None or torch.equal(ha[k], hb[k]), k


@pytest.fixture(scope="module", params=list(BITWISE))
def reference_run(request, digits):
    d = _cfg(4, **BITWISE[request.param])
    ref = Simulator(fedml_tpu_torch.init(config=d, device="cpu"), digits)
    ref.run()
    return request.param, ref


@pytest.mark.parametrize("mode", ["chunked", "block", "resume"])
def test_port_runs_bitwise(mode, reference_run, digits, tmp_path):
    name, ref = reference_run
    extra = {"chunked": {"cohort_chunk": 4},
             "block": {"rounds_per_block": 2}, "resume": {}}[mode]
    d = _cfg(4, extra=extra, **BITWISE[name])
    if mode != "resume":
        sim = Simulator(fedml_tpu_torch.init(config=d, device="cpu"), digits)
        sim.run()
        if mode == "block":
            assert sim.block_fn is not None
        _same(ref, sim)
        return
    ck = str(tmp_path / "ck")
    first = Simulator(fedml_tpu_torch.init(config=d, device="cpu"), digits)
    first.run(num_rounds=2, checkpoint_dir=ck, checkpoint_every=1)
    resumed = Simulator(fedml_tpu_torch.init(config=d, device="cpu"), digits)
    resumed.run(checkpoint_dir=ck, checkpoint_every=0)
    _same(ref, resumed)
    if name == "median_chaos_ldp":
        assert resumed.dp.accountant.steps == 4
        assert [h["dp_epsilon"] for h in resumed.history] == \
            [h["dp_epsilon"] for h in ref.history]
