"""The port's mesh layer (`fedml_tpu_torch.parallel`: `mesh.py`,
`partition.py`, the round's mesh path, the Simulator over a mesh) against
the JAX package's, on the CPU.

The JAX side runs over the 8 CPU devices `conftest.py` forces; the port's
runs SPMD in 4 gloo ranks (`parallel/launch.RankPool`), spawned once for
the module by the `runs` fixture, which runs every rank case, stops the
ranks and checks they all exited 0. The ranks import no JAX
(`torch_mesh_ranks.py`); the JAX side hands them its initial parameters,
its batch schedules and its fault masks.

Bars: `make_mesh` / `mesh_from_file` shapes and error texts, the
partition registry's specs, errors and `explain` table equal JAX's; a
4-rank round, block and Simulator run within 1e-5 of the largest
parameter update of the JAX 4-device mesh run (f32; the sums are taken
per rank, then across ranks, in another order than XLA's), train_loss
and health within 1e-5 relative; the Simulator's padded, LPT-placed id
rows bitwise; a one-rank mesh round and the unmeshed round bitwise; a
chunked mesh run and the single-shot mesh run bitwise.
"""
import os
import sys

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    import fedml_tpu
    from fedml_tpu.algorithms.builtin import (
        build_algorithm as jax_build_algorithm,
    )
    from fedml_tpu.config import TrainArgs as JaxTrainArgs
    from fedml_tpu.core.algorithm import (
        make_batch_indices as jax_batch_indices,
    )
    from fedml_tpu.models import hub as jax_hub
    from fedml_tpu.parallel import mesh as jax_mesh
    from fedml_tpu.parallel import partition as jax_part
    from fedml_tpu.parallel.round import (
        build_block_fn as jax_build_block_fn,
        build_round_fn as jax_build_round_fn,
    )
    from fedml_tpu.simulation.simulator import Simulator as JaxSimulator
except ModuleNotFoundError:
    pass

from fedml_tpu_torch.models import hub
from fedml_tpu_torch.parallel import mesh as port_mesh
from fedml_tpu_torch.parallel import partition as port_part
from fedml_tpu_torch.parallel.launch import RankPool

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mesh_ranks as ranks  # noqa: E402

torch.set_num_threads(2)

TOL = 1e-5   # max |param diff| over the JAX run's largest update
S, B = 16, 4


def _flat(tree):
    return {k: v.numpy() for k, v in hub.params_from_flax(
        tree, device="cpu").items()}


def _close_params(got: dict, want_tree, start_tree, what: str):
    want, start = _flat(want_tree), _flat(start_tree)
    update = max(np.abs(want[k] - start[k]).max() for k in want)
    assert update > 0, what
    err = max(np.abs(got[k] - want[k]).max() for k in want)
    assert err <= TOL * update, f"{what}: {err / update:.3g} of the update"


# ------------------------------------------------------ make_mesh (no ranks)
AXES = [{"dp": 2, "tp": 0}, {"dp": 2, "mp": "four"}, {"a": -1, "b": -1},
        {"a": 3, "rest": -1}, {"dp": 2, "tp": 16}, {"clients": True},
        {"dp": 2, "mp": -1}, {"mp": 2}, {"silos": 2, "intra": 4},
        {"clients": -1}]


@pytest.mark.parametrize("axes", AXES, ids=[str(a) for a in AXES])
def test_make_mesh_shapes_and_errors_as_jax(axes):
    """JAX's accepted shapes and its error texts, word for word, with
    ranks for devices; a valid shape needs a process group, and without
    one make_mesh says so instead of starting one."""
    try:
        want = jax_mesh.make_mesh(axes, devices=jax.devices())
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            port_mesh.make_mesh(axes, devices=list(range(8)))
        assert str(got.value) == str(e)
        return
    assert port_mesh.mesh_sizes(dict(axes), 8) == list(want.shape.values())
    with pytest.raises(RuntimeError, match="torch.distributed initialised"):
        port_mesh.make_mesh(axes, devices=list(range(8)))


FILES = {
    "no_section": "axes: {clients: 2}\n",
    "repeats": "mesh: {clients: 2}\ndevice_ids: [1, 1, 2]\n",
    "missing": "mesh: {clients: 2}\ndevice_ids: [0, 9]\n",
    "bad_axis": "mesh: {clients: 0}\n",
}


@pytest.mark.parametrize("name", list(FILES))
def test_mesh_from_file_errors_as_jax(name, tmp_path):
    path = tmp_path / "mesh.yaml"
    path.write_text(FILES[name])
    with pytest.raises(ValueError) as want:
        jax_mesh.mesh_from_file(str(path), devices=jax.devices())
    with pytest.raises(ValueError) as got:
        port_mesh.mesh_from_file(str(path), devices=list(range(8)))
    assert str(got.value) == str(want.value)


# ------------------------------------------------ the partition registry
TREE = {"enc": {"wq": {"kernel": np.zeros((8, 8))},
                "norm": {"scale": np.zeros((8,))}},
        "step": np.zeros(()), "head": [np.zeros((4, 2)), np.zeros((1,))]}
RULES = {   # name -> (rule table as (regex, axes) pairs, on_unmatched)
    "match": ([(r"wq/kernel$", (None, "mp")), (r"scale$", ()),
               (r"^head/", ("mp",))], "error"),
    "unmatched": ([(r"wq", (None, "mp"))], "error"),
    "replicated": ([(r"wq", (None, "mp"))], "replicated"),
    "ambiguous": ([(r"wq", (None, "mp")), (r"kernel$", ("mp", None))],
                  "replicated"),
    "agreeing": ([(r"wq", (None, "mp")), (r"kernel$", (None, "mp"))],
                 "replicated"),
    "twice": ([(r"x", ()), (r"x", ("mp",))], "replicated"),
    "rank": ([(r"scale", (None, "mp"))], "replicated"),
    "regex": ([(r"(", ())], "replicated"),
}


def _outcome(mod, P, rules, policy):
    table = [(rx, P(*axes)) for rx, axes in rules]
    try:
        specs = mod.match_partition_rules(table, TREE, on_unmatched=policy)
        flat = jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda s: isinstance(s, (JP, port_part.P)))[0]
        return ("ok", [(jax_part.path_name(p), str(s)) for p, s in flat],
                mod.explain(table, TREE, on_unmatched=policy))
    except ValueError as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("name", list(RULES))
def test_partition_registry_as_jax(name):
    """Specs, the error classes and texts, and `explain`'s table equal
    JAX's on a small tree (nested dicts, a list, a scalar)."""
    rules, policy = RULES[name]
    assert _outcome(port_part, port_part.P, rules, policy) == \
        _outcome(jax_part, JP, rules, policy)


def test_fed_data_rules_and_tables():
    data = {"x": np.zeros((8, 4, 3)), "y": np.zeros((8, 4)),
            "mask": np.zeros((8, 4))}
    want = jax_part.match_partition_rules(jax_part.fed_data_rules(), data)
    got = port_part.match_partition_rules(port_part.fed_data_rules(), data)
    assert {k: str(v) for k, v in got.items()} == \
        {k: str(v) for k, v in want.items()} == \
        {k: "PartitionSpec('clients',)" for k in data}
    # the model-parallel tables (tensor parallelism, entry 6b) are named
    # as in JAX; an unknown name lists them (tests/test_torch_tp.py holds
    # the tables themselves to JAX's)
    assert set(port_part.TABLES) == set(jax_part.TABLES)
    with pytest.raises(port_part.PartitionRuleError,
                       match="valid: \\['lora', 'mlp_cnn', 'transformer_lm'\\]"):
        port_part.rules_for("transfomer")


# ------------------------------------------------------ the ranks' runs
def _round_spec():
    """MLP rounds of 8 clients with varied counts: the port's spec, and
    the JAX algorithm, data and initial parameters."""
    rs = np.random.RandomState(5)
    counts = rs.randint(3, S + 1, 8)
    data = {"x": rs.randn(8, S, 8, 8, 1).astype(np.float32),
            "y": rs.randint(0, 10, (8, S)).astype(np.int64),
            "mask": (np.arange(S)[None] < counts[:, None]).astype(
                np.float32)}
    train = dict(epochs=1, batch_size=B, learning_rate=0.1,
                 federated_optimizer="FedAvg", momentum=0.9)
    init = jax.jit(lambda k: jax_hub.init_params(jax_hub.MLP(10), (8, 8, 1),
                                                 k))
    p0 = jax.tree.map(np.asarray, init(jax.random.key(1)))
    alg_j = jax_build_algorithm(
        "FedAvg", jax_hub.mixed_precision_apply(jax_hub.MLP(10).apply,
                                                "float32"),
        JaxTrainArgs(**train))
    spec = {"model": ("mlp", 10, (8, 8, 1)), "train": train,
            "params": _flat(p0), "data": data, "seed": 3}
    return spec, alg_j, p0, counts.astype(np.float32)


def _jax_rounds(spec, alg_j, p0, weights, ids, block=False, full=None):
    """Two JAX rounds over make_mesh({"clients": 4}) (single or block);
    fills spec["rounds"] with their ids, weights and schedules."""
    mesh = jax_mesh.make_mesh({"clients": 4})
    data = {k: jnp.asarray(v) for k, v in spec["data"].items()}
    base = jax.random.key(spec["seed"])
    spec["rounds"] = []
    for r in range(2):
        rng = jax.random.fold_in(base, r)
        sched = np.stack([np.asarray(jax_batch_indices(
            jax.random.fold_in(rng, int(i)), S, B, 1)) for i in ids])
        spec["rounds"].append({"round": r, "ids": ids, "weights": weights,
                               "sched": sched.astype(np.int64)})
    st = alg_j.server_init(jax.tree.map(jnp.asarray, p0))
    if block:
        fn = jax_build_block_fn(alg_j, mesh=mesh)
        out = fn(st, jnp.zeros((8,)), data, jnp.asarray(np.stack([ids] * 2)),
                 jnp.asarray(np.stack([weights] * 2)), base,
                 jnp.asarray([0, 1], jnp.int32), None)
        return out.server_state.params, out.metrics
    fn = jax_build_round_fn(alg_j, mesh=mesh, health_stats=True)
    mets = []
    for r in range(2):
        out = fn(st, jnp.zeros((8,)), data, jnp.asarray(ids),
                 jnp.asarray(weights), jax.random.fold_in(base, r), None)
        st = out.server_state
        mets.append(jax.tree.map(np.asarray, out.metrics))
    return st.params, mets


def _sim_cfg(tmp, extra=None, opt="FedAvg", freq=0, **sections):
    d = {"common_args": {"random_seed": 0},
         "data_args": {"dataset": "synthetic", "data_cache_dir": str(tmp),
                       "partition_method": "hetero", "partition_alpha": 0.5,
                       "extra": {"synthetic_samples_per_client": 16}},
         "model_args": {"model": "lr"},
         "train_args": {"federated_optimizer": opt, "client_num_in_total": 9,
                        "client_num_per_round": 7, "comm_round": 2,
                        "epochs": 1, "batch_size": 8, "learning_rate": 0.1,
                        "extra": extra or {}},
         "validation_args": {"frequency_of_the_test": freq},
         "comm_args": {"backend": "xla"},
         "device_args": {"mesh_shape": {"clients": 4}}}
    for sec, kv in sections.items():
        d[sec] = {**d.get(sec, {}), **kv}
    return d


SIM_CASES = {
    "fedavg": dict(freq=1),
    "krum": dict(security_args={"enable_defense": True,
                                "defense_type": "krum",
                                "defense_spec": {"byzantine_client_num": 1}}),
    "chaos": dict(common_args={"random_seed": 0,
                               "extra": {"chaos": {"client_dropout": 0.3}}}),
    "scaffold": dict(opt="SCAFFOLD"),
    "block": dict(extra={"rounds_per_block": 2}),
    "chunk": dict(extra={"cohort_chunk": 4}),
}
ROUNDS = {"block": 4}


def _jax_sim(d, rounds):
    """The JAX Simulator over 4 CPU devices: (its rows, its per-round id
    rows and fault masks, initial params, schedules of the sampled ids,
    the finished simulator)."""
    sim = JaxSimulator(fedml_tpu.init(config=d))
    assert sim.mesh is not None and sim.mesh.devices.size == 4
    seen = []
    observe = sim.health.observe_round

    def capture(r, ids, weights, health, **kw):
        seen.append((np.asarray(ids), kw.get("faults")))
        return observe(r, ids, weights, health, **kw)

    sim.health.observe_round = capture
    p0 = jax.tree.map(np.asarray, sim.params)
    t = sim.cfg.train_args
    key = jax.random.key(sim.cfg.common_args.random_seed)
    scheds, faults = {}, {}
    for r in range(rounds):
        scheds[r] = np.stack([np.asarray(jax_batch_indices(
            jax.random.fold_in(jax.random.fold_in(key, r), int(i)),
            sim.dataset.shard_size, t.batch_size, t.epochs))
            for i in sim.sample_clients(r)]).astype(np.int64)
    if t.extra.get("rounds_per_block"):
        rows = sim.run(rounds)
    else:
        rows = [sim.run_round(r) for r in range(rounds)]
    for r, (ids, f) in enumerate(seen):
        if f is not None:   # the sampled clients' masks (a pad shares its
            # source's), in sampled order
            pos = [int(np.flatnonzero(ids == i)[0])
                   for i in sim.sample_clients(r)]
            faults[r] = {k: np.asarray(v)[pos] for k, v in f.items()}
    return rows, [s[0] for s in seen], p0, scheds, faults, sim


def _unmeshed_sim(d, rounds=2):
    """The port's Simulator on config `d` in this process (no process
    group, so no mesh): (history, initial and final parameters)."""
    import fedml_tpu_torch
    from fedml_tpu_torch.simulation.simulator import Simulator

    sim = Simulator(fedml_tpu_torch.init(config=d, device="cpu"))
    assert sim.mesh is None
    p0 = {k: v.numpy().copy() for k, v in sim.server_state.params.items()}
    hist = sim.run(num_rounds=rounds)
    return hist, p0, {k: v.numpy() for k, v in
                      sim.server_state.params.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank case in one 4-rank pool, the JAX sides beside them."""
    tmp = tmp_path_factory.mktemp("mesh")
    pool = RankPool(["cpu"] * 4, timeout_s=240.0)
    try:
        out = {"jax": {}, "port": {}}
        spec, alg_j, p0, counts = _round_spec()
        ids = np.arange(8)
        out["jax"]["round"] = _jax_rounds(spec, alg_j, p0, counts, ids) + (
            p0, spec)
        bspec = dict(spec)
        out["jax"]["block"] = _jax_rounds(bspec, alg_j, p0, counts, ids,
                                          block=True) + (p0, bspec)
        path = tmp / "mesh.yaml"
        path.write_text("mesh: {silos: 2, intra: -1}\n"
                        "device_ids: [0, 2, 1, 3]\n")
        out["jax"]["file"] = jax_mesh.mesh_from_file(
            str(path), devices=jax.devices()[:4])
        sims = {}
        for name, kw in SIM_CASES.items():
            d = _sim_cfg(tmp / name, **kw)
            sims[name] = (d,) + _jax_sim(d, ROUNDS.get(name, 2))
        out["jax"]["sim"] = sims
        onespec = dict(spec, rounds=spec["rounds"][:1])
        calls = [
            ("world", ranks.world_checks, ()),
            ("file", ranks.file_mesh, (str(path),)),
            ("shard", ranks.shard_rows, ({k: v for k, v in spec["data"]
                                          .items()},)),
            ("round", ranks.mesh_round, (dict(spec, health=True),)),
            ("block", ranks.mesh_round, (dict(bspec, block=True),)),
            ("one_plain", ranks.one_rank_bitwise, (onespec,)),
            ("one_full", ranks.one_rank_bitwise,
             (dict(onespec, full="krum", dropout=0.3),)),
            ("one_scaffold", ranks.one_rank_bitwise,
             (dict(onespec, train=dict(spec["train"],
                                       federated_optimizer="SCAFFOLD"),
                   n_total=8, n_round=8),)),
        ]
        for name, (d, rows, _ids, p0s, scheds, faults, _sim) in sims.items():
            calls.append((f"sim_{name}", ranks.sim_case,
                          (d, _flat(p0s), scheds,
                           faults if name == "chaos" else None,
                           ROUNDS.get(name, 2))))
        d = sims["chunk"][0]
        single = dict(d, train_args=dict(d["train_args"], extra={}))
        calls.append(("sim_single", ranks.sim_case,
                      (single, _flat(sims["chunk"][3]), sims["chunk"][4],
                       None, 2)))
        prefix = _sim_cfg(tmp / "prefix",
                          device_args={"mesh_shape": {"clients": 2}})
        calls.append(("prefix", ranks.prefix_mesh_sim, (prefix,)))
        out["prefix_ref"] = _unmeshed_sim(prefix)
        for name, fn, args in calls:
            out["port"][name] = pool.run(fn, *args)
    finally:
        out["exitcodes"] = pool.close()
    return out


def test_ranks_exit_cleanly(runs):
    assert runs["exitcodes"] == [0, 0, 0, 0]


def test_world_too_small_and_wildcard(runs):
    want = None
    try:
        jax_mesh.make_mesh({"clients": 8}, devices=jax.devices()[:4])
    except ValueError as e:
        want = str(e)
    got = runs["port"]["world"]
    assert all(r["too_big"] == want for r in got)
    assert [r["shape"] for r in got] == [[2, 2]] * 4
    assert [r["coord"] for r in got] == [[0, 0], [0, 1], [1, 0], [1, 1]]


def test_mesh_from_file_orders_ranks(runs):
    want = [[d.id for d in row] for row in runs["jax"]["file"].devices]
    got = runs["port"]["file"]
    assert got[0]["ranks"] == want == [[0, 2], [1, 3]]
    assert got[0]["names"] == ["silos", "intra"]
    # rank r sits where the file put it
    assert [g["coord"] for g in got] == [[0, 0], [1, 0], [0, 1], [1, 1]]


def test_shard_fed_data_through_the_registry(runs):
    x = runs["jax"]["round"][3]["data"]["x"]
    for k, r in enumerate(runs["port"]["shard"]):
        np.testing.assert_array_equal(r["x"], x[2 * k:2 * k + 2])
        assert r["error"].startswith("UnmatchedParamError") \
            and "'weights'" in r["error"]


def test_round_matches_jax_mesh(runs):
    """Two FedAvg rounds (momentum 0.9, health stats) on the 4-rank mesh
    against JAX's on make_mesh({"clients": 4})."""
    params_j, mets_j, p0, _spec = runs["jax"]["round"]
    got = runs["port"]["round"]
    for r in got[1:]:   # every rank holds the same server state
        for k, v in r["params"].items():
            np.testing.assert_array_equal(v, got[0]["params"][k])
    _close_params(got[0]["params"], jax.tree.map(np.asarray, params_j), p0,
                  "round")
    for mt, mj in zip(got[0]["metrics"], mets_j):
        assert float(mt["train_loss"]) == pytest.approx(
            float(mj["train_loss"]), rel=1e-5)
        assert float(mt["n_samples"]) == float(mj["n_samples"])
        for k, want in mj["health"].items():
            np.testing.assert_allclose(mt["health"][k], want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max())


def test_block_matches_jax_block(runs):
    params_j, mets_j, p0, _spec = runs["jax"]["block"]
    got = runs["port"]["block"][0]
    _close_params(got["params"], jax.tree.map(np.asarray, params_j), p0,
                  "block")
    np.testing.assert_allclose(got["metrics"]["train_loss"],
                               np.asarray(mets_j["train_loss"]), rtol=1e-5)


@pytest.mark.parametrize("case", ["one_plain", "one_full", "one_scaffold"])
def test_one_rank_mesh_is_the_unmeshed_round(runs, case):
    """A one-rank mesh (rank 0 of the 4) against the unmeshed round, with
    health stats: LINEAR, a krum FULL hook under chaos dropout, and
    SCAFFOLD's client states; the other ranks sit outside the mesh."""
    got = runs["port"][case]
    assert got[0] == {"same": True}
    assert got[1:] == [None] * 3


@pytest.mark.parametrize("name", list(SIM_CASES))
def test_simulator_matches_jax_over_a_mesh(runs, name):
    """7 of 9 clients a round (padded to 8 with a zero-weight duplicate),
    varied counts (LPT placement, skipped where padding meets krum's FULL
    hook): the id rows bitwise, the history and final parameters within
    the bars; SCAFFOLD's client states too."""
    d, rows_j, ids_j, p0, _sched, _faults, sim_j = runs["jax"]["sim"][name]
    got = runs["port"][f"sim_{name}"]
    lead = got[0]
    assert [g["lead"] for g in got] == [True, False, False, False]
    assert lead["d"] == 4
    for a, b in zip(lead["ids"], ids_j):
        np.testing.assert_array_equal(a, b)
    if name == "krum":   # real clients stay the prefix
        assert all(list(a[:7]) == sorted(a[:7]) for a in lead["ids"])
    elif name != "chunk":
        assert any(list(a) != sorted(a) for a in lead["ids"]), \
            "LPT never permuted a row"
    assert len(lead["history"]) == len(rows_j)
    for a, b in zip(lead["history"], rows_j):
        assert a["train_loss"] == pytest.approx(b["train_loss"], rel=1e-5)
        assert a["n_samples"] == b["n_samples"]
        if "test_acc" in b:
            assert a["test_loss"] == pytest.approx(b["test_loss"], rel=1e-5)
    _close_params(lead["params"], jax.tree.map(
        np.asarray, sim_j.server_state.params), p0, name)
    if name == "scaffold":
        from test_torch_plugin_round import _flat_stacked

        want = _flat_stacked(jax.tree.map(np.asarray, sim_j.client_states),
                             9)
        scale = max(np.abs(v).max() for v in want.values())
        assert scale > 0
        for k, v in want.items():
            np.testing.assert_allclose(lead["client_states"][k], v, rtol=0,
                                       atol=TOL * scale, err_msg=k)


def test_chunked_mesh_run_is_the_single_shot_run(runs):
    """cohort_chunk 4 over 4 ranks (each rank streams one client a chunk)
    against the unchunked mesh run: history and parameters bitwise."""
    a, b = runs["port"]["sim_chunk"][0], runs["port"]["sim_single"][0]
    assert a["history"] == b["history"]
    for k, v in a["params"].items():
        np.testing.assert_array_equal(v, b["params"][k])


def test_prefix_mesh_refuses_the_ranks_it_leaves_out(runs):
    """mesh_shape {clients: 2} in a world of 4: ranks 2 and 3 are refused
    as they build the Simulator, with a message that names the mesh's
    ranks; ranks 0 and 1 run it (7 clients a round padded to 8 and
    LPT-placed over 2 ranks), within 1e-5 of the largest update of the
    unmeshed Simulator on the same config, train_loss within 1e-5
    relative."""
    got = runs["port"]["prefix"]
    for r, g in enumerate(got[2:], start=2):
        assert g["refused"] == (
            f"the Simulator's mesh: rank {r} is not one of its ranks [0, 1];"
            " a mesh smaller than the world leaves the other ranks out, and"
            " only its own ranks may run it (parallel/mesh.in_mesh)")
    assert [g["refused"] for g in got[:2]] == [None, None]
    assert [g["d"] for g in got[:2]] == [2, 2]
    rows = [(list(ids), list(s) + [s[0]])
            for ids, s in zip(got[0]["placed"], got[0]["sampled"])]
    assert all(sorted(a) == sorted(b) for a, b in rows)
    assert any(a != b for a, b in rows), "LPT never permuted a row"
    hist_ref, p0, params_ref = runs["prefix_ref"]
    for a, b in zip(got[0]["history"], hist_ref):
        assert a["n_samples"] == b["n_samples"]
        assert a["train_loss"] == pytest.approx(b["train_loss"], rel=1e-5)
    update = max(np.abs(params_ref[k] - p0[k]).max() for k in p0)
    err = max(np.abs(got[0]["params"][k] - params_ref[k]).max() for k in p0)
    assert update > 0 and err <= TOL * update, err / update


def test_cohort_sharded_smoke_probe():
    """The diagnosis battery's probe: two spawned gloo ranks, a chunked
    streamed cohort over their mesh equal to the single-shot round."""
    from fedml_tpu_torch.diagnosis import REQUIRED, probe_cohort_sharded_smoke

    out = probe_cohort_sharded_smoke(torch.device("cpu"))
    assert out["exitcodes"] == [0, 0] and out["chunks"] == [4, 4]
    assert "cohort_sharded_smoke" in REQUIRED
