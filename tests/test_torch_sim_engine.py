"""The port's round engine beyond one client at a time (`fedml_tpu_torch`:
vmapped client groups, SCAFFOLD / FedDyn / Mime with per-client state,
round blocks, cohort chunks with the ingest pipeline, checkpoint and
resume) against the JAX package's, on the CPU.

Rounds that meet the JAX round get its batch schedules and parameters
handed over and agree within 1e-3 of the largest parameter update (the
repo's rule for rounds); train_loss and health within 1e-5 relative.
The port's own bars are the reference's, bitwise (`torch.equal`): a block
equals its rounds run one at a time, chunked equals single-shot, a
resumed run equals the uninterrupted one. No test here may reach vmap's
per-example fallback: its warning is an error. The `gpu` cases hold the
card's f32 round to itself, bitwise.
"""
import os
import threading
import time

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    import fedml_tpu
    from fedml_tpu.algorithms.builtin import (
        build_algorithm as jax_build_algorithm,
    )
    from fedml_tpu.config import TrainArgs as JaxTrainArgs
    from fedml_tpu.core.algorithm import (
        make_batch_indices as jax_batch_indices,
    )
    from fedml_tpu.models import hub as jax_hub
    from fedml_tpu.parallel.round import build_round_fn as jax_build_round_fn
    from fedml_tpu.simulation.simulator import Simulator as JaxSimulator
except ModuleNotFoundError:
    # the machine with the card has no flax: there only the `gpu` cases
    # run (`-m gpu`), and they need nothing of the JAX package
    pass

import fedml_tpu_torch
from fedml_tpu_torch.algorithms.builtin import build_algorithm
from fedml_tpu_torch.config import TrainArgs
from fedml_tpu_torch.data import loader
from fedml_tpu_torch.models import hub
from fedml_tpu_torch.parallel.round import build_round_fn, group_width
from fedml_tpu_torch.simulation.ingest import IngestPipeline
from fedml_tpu_torch.simulation.simulator import Simulator, run_simulation
from fedml_tpu_torch.utils import checkpoint as ckpt
from fedml_tpu_torch.utils import metrics as mx

torch.set_num_threads(2)

pytestmark = pytest.mark.filterwarnings(
    "error:There is a performance drop because we have not yet implemented "
    "the batching rule")

ROUND_TOL = 1e-3   # max |param diff| over the largest parameter update
MODELS = {   # name -> (flax module, port module, input shape)
    "mlp": (lambda: jax_hub.MLP(10),
            lambda s: hub.MLP(10, s, device="cpu"), (8, 8, 1)),
    "cnn": (lambda: jax_hub.CNN(10),
            lambda s: hub.CNN(10, s, device="cpu"), (8, 8, 1)),
}
S, B = 16, 4


@pytest.fixture(scope="module")
def flax_params():
    out = {}
    for name, (fj, _ft, shape) in MODELS.items():
        init = jax.jit(lambda k, m=fj(), s=shape: jax_hub.init_params(m, s, k))
        out[name] = jax.tree.map(np.asarray, init(jax.random.key(1)))
    return out


def _flat(tree):
    return {k: v.numpy() for k, v in hub.params_from_flax(
        tree, device="cpu").items()}


def _data(n, shape, seed=5):
    """n clients of S slots, client i holding counts[i] real samples."""
    rs = np.random.RandomState(seed)
    counts = rs.randint(3, S + 1, n)
    x = rs.randn(n, S, *shape).astype(np.float32)
    y = rs.randint(0, 10, (n, S)).astype(np.int64)
    mask = (np.arange(S)[None] < counts[:, None]).astype(np.float32)
    return {"x": x, "y": y, "mask": mask}, counts.astype(np.float32)


def _jax_schedule(rng, ids, epochs=1):
    return torch.from_numpy(np.stack([np.asarray(jax_batch_indices(
        jax.random.fold_in(rng, int(i)), S, B, epochs)) for i in ids
    ]).astype(np.int64))


def _algs(name, model, n_total=None, n_round=None, **knobs):
    fj, ft, shape = MODELS[model]
    kw = dict(epochs=1, batch_size=B, learning_rate=0.1,
              federated_optimizer=name, **knobs)
    alg_j = jax_build_algorithm(
        name, jax_hub.mixed_precision_apply(fj().apply, "float32"),
        JaxTrainArgs(**kw), n_total, n_round)
    alg_t = build_algorithm(name, hub.apply_fn(ft(shape)), TrainArgs(**kw),
                            n_total, n_round)
    return alg_j, alg_t


def _close(got: dict, want: dict, scale: float, what: str):
    for k, w in want.items():
        np.testing.assert_allclose(np.asarray(got[k]), w, rtol=0,
                                   atol=ROUND_TOL * scale,
                                   err_msg=f"{what} {k}")


# ------------------------------------------------ client groups (3d.1)
def test_group_width_is_the_jax_rounds():
    assert group_width(100, 8) == 5
    assert group_width(100, 10) == 10
    assert group_width(7, 4) == 1
    assert group_width(6, 4) == 3
    assert group_width(3, 8) == 3


GROUP_CASES = [
    ("FedAvg", "mlp", {"momentum": 0.9, "weight_decay": 1e-3}),
    ("FedAvg", "cnn", {}),
    ("FedProx", "mlp", {"fedprox_mu": 0.1}),
    ("FedNova", "mlp", {}),
    ("FedOpt", "mlp", {"server_optimizer": "yogi", "server_lr": 0.01}),
]


@pytest.mark.parametrize("name,model,knobs", GROUP_CASES,
                         ids=[f"{a}-{m}" for a, m, _ in GROUP_CASES])
def test_group_round_matches_jax(name, model, knobs, flax_params):
    """G = 4 at m = 8 (g = 4, two groups) against JAX's
    `build_round_fn(group_size=4)`, two rounds with health stats; and the
    port's G = 4 round against its own G = 1 round."""
    alg_j, alg_t = _algs(name, model, **knobs)
    n = 8
    data, counts = _data(n, MODELS[model][2])
    ids = np.arange(n)
    round_j = jax_build_round_fn(alg_j, mesh=None, group_size=4,
                                 health_stats=True)
    round_t = {g: build_round_fn(alg_t, group_size=g, health_stats=True)
               for g in (1, 4)}
    data_j = {k: jnp.asarray(v) for k, v in data.items()}
    data_t = {k: torch.from_numpy(v) for k, v in data.items()}
    st_j = alg_j.server_init(jax.tree.map(jnp.asarray, flax_params[model]))
    p0 = hub.params_from_flax(flax_params[model], device="cpu")
    st_t = {g: alg_t.server_init(dict(p0)) for g in (1, 4)}
    for r in range(2):
        before = _flat(jax.tree.map(np.asarray, st_j.params))
        rng = jax.random.fold_in(jax.random.key(2), r)
        sched = _jax_schedule(rng, ids)
        o_j = round_j(st_j, jnp.zeros((n,)), data_j, jnp.asarray(ids),
                      jnp.asarray(counts), rng, None)
        st_j = o_j.server_state
        after = _flat(jax.tree.map(np.asarray, st_j.params))
        update = max(np.abs(after[k] - before[k]).max() for k in after)
        assert update > 0
        outs = {g: round_t[g](st_t[g], None, data_t, ids, counts, seed=r,
                              batch_idx=sched) for g in (1, 4)}
        for g, o in outs.items():
            st_t[g] = o.server_state
            _close(o.server_state.params, after, update,
                   f"G={g} round {r}")
            assert float(o.metrics["train_loss"]) == pytest.approx(
                float(o_j.metrics["train_loss"]), rel=1e-5)
            for k, want in o_j.metrics["health"].items():
                want = np.asarray(want)
                np.testing.assert_allclose(
                    o.metrics["health"][k].numpy(), want, rtol=1e-5,
                    atol=1e-5 * np.abs(want).max(), err_msg=f"G={g} {k}")
        _close(st_t[4].params, {k: v.numpy() for k, v in
                                st_t[1].params.items()}, update, "G4 vs G1")


@pytest.mark.parametrize("name,mom,wd", [
    ("sgd", 0.0, 0.0), ("sgd", 0.9, 1e-2), ("adam", 0.0, 1e-2),
    ("adamw", 0.0, 1e-2)])
def test_client_optimizers_match_optax(name, mom, wd):
    """The functional client optimizer against the JAX package's optax
    chain on identical gradients, four steps: sgd (decay added to g
    first, the trace), adam (the same decay, bias-corrected moments) and
    adamw (decoupled decay)."""
    import optax

    from fedml_tpu.core.algorithm import (
        make_client_optimizer as jax_client_optimizer,
    )
    from fedml_tpu_torch.core.algorithm import make_client_optimizer

    rs = np.random.RandomState(4)
    p_np = {"w": rs.randn(5, 7).astype(np.float32),
            "b": rs.randn(7).astype(np.float32)}
    tx = jax_client_optimizer(name, 0.05, mom, wd)
    p_j = jax.tree.map(jnp.asarray, p_np)
    s_j = tx.init(p_j)
    opt = make_client_optimizer(name, 0.05, mom, wd)
    p_t = {k: torch.from_numpy(v) for k, v in p_np.items()}
    s_t = opt.init(p_t)
    for i in range(4):
        g = {k: (rs.randn(*v.shape) * 10.0 ** -i).astype(np.float32)
             for k, v in p_np.items()}
        u, s_j = tx.update(jax.tree.map(jnp.asarray, g), s_j, p_j)
        p_j = optax.apply_updates(p_j, u)
        p_t, s_t = opt.step(p_t, {k: torch.from_numpy(v)
                                  for k, v in g.items()}, s_t, i + 1)
        for k in p_np:
            np.testing.assert_allclose(p_t[k].numpy(), np.asarray(p_j[k]),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {i} {k}")


def test_vmap_refusals_name_their_items():
    """A client torch.func cannot batch (the FedLLM LoRA round) keeps
    refusing groups; the round's plugins keep refusing too."""
    from fedml_tpu_torch.core.algorithm import autograd_grad
    from fedml_tpu_torch.algorithms.builtin import make_fedavg

    alg = make_fedavg(lambda p, x: x, TrainArgs(), grad_engine=autograd_grad)
    assert not alg.vmap_ok
    with pytest.raises(NotImplementedError, match="group_size.*3d.1b"):
        build_round_fn(alg, group_size=2)
    build_round_fn(alg, group_size=1)
    ok = build_algorithm("FedAvg", lambda p, x: x, TrainArgs())
    assert ok.vmap_ok
    build_round_fn(ok, group_size=4)


# ------------------------------------------- SCAFFOLD, FedDyn, Mime (3c)
STATEFUL = [("SCAFFOLD", {}), ("FedDyn", {"feddyn_alpha": 0.1}),
            ("Mime", {"mime_beta": 0.5, "server_lr": 1.0})]


@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("name,knobs", STATEFUL, ids=[s for s, _ in STATEFUL])
def test_stateful_algorithms_match_jax(name, knobs, group, flax_params):
    """Two rounds of 6 of 10 clients at G = 1 and 2 against the JAX round:
    parameters and server `extra` within 1e-3 of their largest change,
    the stacked client states of the sampled clients within 1e-3 of the
    largest state, and every unsampled client's state bitwise what it was
    before the round."""
    n, m = 10, 6
    alg_j, alg_t = _algs(name, "mlp", n, m, **knobs)
    data, counts = _data(n, MODELS["mlp"][2], seed=11)
    data_j = {k: jnp.asarray(v) for k, v in data.items()}
    data_t = {k: torch.from_numpy(v) for k, v in data.items()}
    round_j = jax_build_round_fn(alg_j, mesh=None, group_size=group)
    round_t = build_round_fn(alg_t, group_size=group)
    p_j = jax.tree.map(jnp.asarray, flax_params["mlp"])
    st_j = alg_j.server_init(p_j)
    st_t = alg_t.server_init(hub.params_from_flax(flax_params["mlp"],
                                                  device="cpu"))
    stateful = alg_t.client_state_init is not None
    assert stateful == (name != "Mime")
    if stateful:
        cs_j = jax.tree.map(
            lambda a: jnp.broadcast_to(a, (n,) + a.shape).copy(),
            alg_j.client_state_init(p_j))
        cs_t = {k: v.unsqueeze(0).expand((n,) + v.shape).clone()
                for k, v in alg_t.client_state_init(st_t.params).items()}
    else:
        cs_j, cs_t = jnp.zeros((n,)), None
    for r, ids in enumerate((np.array([0, 2, 3, 5, 6, 9]),
                             np.array([1, 2, 4, 6, 7, 8]))):
        rng = jax.random.fold_in(jax.random.key(3), r)
        sched = _jax_schedule(rng, ids)
        w = counts[ids]
        before_j = _flat(jax.tree.map(np.asarray, st_j.params))
        extra_before = jax.tree.map(np.asarray, st_j.extra)
        o_j = round_j(st_j, cs_j, data_j, jnp.asarray(ids), jnp.asarray(w),
                      rng, None)
        prev_t = None if cs_t is None else {k: v.clone()
                                            for k, v in cs_t.items()}
        o_t = round_t(st_t, cs_t, data_t, ids, w, seed=r, batch_idx=sched)
        st_j, cs_j = o_j.server_state, o_j.client_states
        st_t, cs_t = o_t.server_state, o_t.client_states
        after = _flat(jax.tree.map(np.asarray, st_j.params))
        update = max(np.abs(after[k] - before_j[k]).max() for k in after)
        assert update > 0
        _close(st_t.params, after, update, f"{name} round {r} params")
        assert float(o_t.metrics["train_loss"]) == pytest.approx(
            float(o_j.metrics["train_loss"]), rel=1e-5)
        ex_j = jax.tree.map(np.asarray, st_j.extra)
        ex_t = st_t.extra["m"] if name == "Mime" else st_t.extra
        ex_j, ex_b = ((ex_j["m"], extra_before["m"]) if name == "Mime"
                      else (ex_j, extra_before))
        moved = max(np.abs(np.asarray(a) - np.asarray(b)).max() for a, b in
                    zip(jax.tree.leaves(ex_j), jax.tree.leaves(ex_b)))
        assert moved > 0
        _close(ex_t, _flat(ex_j), moved, f"{name} round {r} extra")
        if not stateful:
            assert cs_t is None
            continue
        cs_np = jax.tree.map(np.asarray, cs_j)
        scale = max(np.abs(a).max() for a in jax.tree.leaves(cs_np))
        assert scale > 0
        for c in range(n):
            row = {k: v[c] for k, v in cs_t.items()}
            if c in ids:
                _close(row, _flat(jax.tree.map(lambda a: a[c], cs_np)),
                       scale, f"{name} round {r} client {c}")
            else:
                for k, v in row.items():
                    assert torch.equal(v, prev_t[k][c]), (name, r, c, k)


# ------------------------------------------------- the port's own bars
def _cfg(opt="SCAFFOLD", n=12, m=5, rounds=6, extra=None, freq=0,
         model="lr", seed=0):
    d = {"common_args": {"random_seed": seed},
         "data_args": {"dataset": "synthetic", "partition_method": "hetero",
                       "partition_alpha": 0.5,
                       "extra": {"synthetic_samples_per_client": 16}},
         "model_args": {"model": model},
         "train_args": {"federated_optimizer": opt, "client_num_in_total": n,
                        "client_num_per_round": m, "comm_round": rounds,
                        "epochs": 1, "batch_size": 8, "learning_rate": 0.1,
                        "extra": extra or {}},
         "validation_args": {"frequency_of_the_test": freq},
         "comm_args": {"backend": "sp"}}
    return d


def _sim(d, **kw):
    return Simulator(fedml_tpu_torch.init(config=d, device="cpu"), **kw)


def _assert_bitwise(ref, got):
    """Histories equal (float ==) and parameters, server extra and client
    states bitwise."""
    assert ref.history == got.history, "history diverged"
    for a, b in ((ref.server_state.params, got.server_state.params),
                 (ref.server_state.extra, got.server_state.extra),
                 (ref.client_states, got.client_states)):
        if a is None:
            assert b is None
            continue
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def per_round_scaffold():
    ref = _sim(_cfg(rounds=12, freq=6))
    ref.run()
    return ref


@pytest.mark.parametrize("k,depth", [(4, 2), (3, 1), (2, 3)])
def test_block_equals_per_round_with_eval_cadence(per_round_scaffold, k,
                                                  depth):
    """K = 4 (and 3, 2) with SCAFFOLD and an eval cadence (6) K = 4 does
    not divide, 12 clients and 5 a round: full blocks mix with one-round
    pieces around the eval rounds, and client states ride the blocks
    (`tests/test_round_block.py:74` without the mesh)."""
    ref = per_round_scaffold
    blk = _sim(_cfg(rounds=12, freq=6, extra={"rounds_per_block": k,
                                              "block_pipeline_depth": depth}))
    blk.run()
    assert blk.block_fn is not None, "the blocked run never used a block"
    assert [r["round"] for r in blk.history if "test_acc" in r] == \
        [0, 6, 11]
    _assert_bitwise(ref, blk)


@pytest.fixture(scope="module")
def chunk_pair():
    """Single-shot against chunked at G = 2 (16 clients, chunks of 4), the
    ingest counters captured around the chunked run."""
    over = dict(opt="FedAvg", n=16, m=16, rounds=4)
    ref = _sim(_cfg(extra={"clients_per_device_parallel": 2}, **over))
    ref.run()
    before = mx.snapshot()["counters"]
    chk = _sim(_cfg(extra={"clients_per_device_parallel": 2,
                           "cohort_chunk": 4, "ingest_prefetch": 1},
                    **over))
    chk.run()
    after = mx.snapshot()["counters"]
    delta = {k: after.get(k, 0) - before.get(k, 0)
             for k in ("fed.ingest.chunks", "fed.ingest.bytes",
                       "fed.ingest.prefetched")}
    return ref, chk, delta


def test_chunked_equals_single_shot(chunk_pair):
    """`tests/test_sim_scale.py:78` on one device: 4 chunks a round."""
    ref, chk, delta = chunk_pair
    assert chk.data is None and chk.round_fn is None
    _assert_bitwise(ref, chk)
    assert delta["fed.ingest.chunks"] == 4 * 4
    assert delta["fed.ingest.bytes"] > 0


@pytest.mark.parametrize("chunk,group,prefetch", [(8, 4, 2), (2, 1, 0),
                                                  (8, 8, 1)])
def test_chunk_and_group_sizes(chunk, group, prefetch):
    """Other chunk / group / prefetch shapes of the same bar, each against
    the single-shot run at its own G."""
    over = dict(opt="SCAFFOLD", n=20, m=16, rounds=3)
    ref = _sim(_cfg(extra={"clients_per_device_parallel": group}, **over))
    ref.run()
    chk = _sim(_cfg(extra={"clients_per_device_parallel": group,
                           "cohort_chunk": chunk,
                           "ingest_prefetch": prefetch}, **over))
    chk.run()
    _assert_bitwise(ref, chk)


def test_chunked_blocked_equals_single_shot(chunk_pair):
    ref, _, _ = chunk_pair
    blk = _sim(_cfg(opt="FedAvg", n=16, m=16, rounds=4,
                    extra={"clients_per_device_parallel": 2,
                           "cohort_chunk": 4, "ingest_prefetch": 0,
                           "rounds_per_block": 2}))
    blk.run()
    _assert_bitwise(ref, blk)


def test_chunked_pads_crossing_chunks_keep_state_intact():
    """`tests/test_sim_scale.py:144`: a 14-client SCAFFOLD cohort in chunks
    of 8 is padded to 16 with zero-weight duplicates of its first id in
    the second chunk; states gathered at round start and scattered once
    keep it bitwise the unchunked, unpadded run."""
    over = dict(n=16, m=14, rounds=3)
    ref = _sim(_cfg(**over))
    ref.run()
    chk = _sim(_cfg(extra={"cohort_chunk": 8}, **over))
    ids, w, pad = chk._pad_only(chk.sample_clients(0))
    assert len(ids) == 16 and pad == 2 and (w[14:] == 0).all()
    assert (ids[14:] == ids[0]).all()
    chk.run()
    _assert_bitwise(ref, chk)


def test_kill_and_resume_is_identical(tmp_path):
    """`tests/test_checkpoint.py:38` with SCAFFOLD: three rounds with a
    checkpoint each, a new Simulator resumes and finishes; history,
    parameters, c and every c_i bitwise the uninterrupted run's."""
    d = str(tmp_path / "ckpt")
    full = _sim(_cfg(n=6, m=4, rounds=6))
    full.run()
    first = _sim(_cfg(n=6, m=4, rounds=6))
    first.run(num_rounds=3, checkpoint_dir=d, checkpoint_every=1)
    assert ckpt.latest_round(d) == 2
    del first
    resumed = _sim(_cfg(n=6, m=4, rounds=6))
    hist = resumed.run(checkpoint_dir=d, checkpoint_every=0)
    assert [h["round"] for h in hist] == list(range(6))
    _assert_bitwise(full, resumed)


def test_config_driven_checkpoints_and_pruning(tmp_path):
    """`train_args.extra.checkpoint_dir` through `run_simulation` saves
    every round and keeps the last 3 (`tests/test_checkpoint.py:114`);
    a second call resumes at the end and runs nothing more."""
    d = str(tmp_path / "ckpt")
    cfg = _cfg(opt="FedAvg", n=6, m=4, rounds=5,
               extra={"checkpoint_dir": d})
    hist = run_simulation(fedml_tpu_torch.init(config=cfg, device="cpu"),
                          device="cpu")
    rounds = sorted(int(n.split("_")[1]) for n in os.listdir(d)
                    if n.startswith("round_"))
    assert rounds == [2, 3, 4]
    assert ckpt.read_meta(d)["history"] == hist
    again = run_simulation(fedml_tpu_torch.init(config=cfg, device="cpu"),
                           device="cpu")
    assert again == hist


def test_meta_extra_roundtrip_and_raw_restore(tmp_path):
    """`tests/test_checkpoint.py:135`."""
    d = str(tmp_path / "ck")
    ckpt.save_checkpoint(d, 4, {"params": {"w": torch.arange(6.0)}},
                         history=[{"round": 4}],
                         extra={"kind": "x", "generation": 2,
                                "client_online": {"1": True, "2": False}})
    meta = ckpt.read_meta(d)
    assert meta["round"] == 4 and meta["present"]["client_states"] is False
    assert meta["extra"]["client_online"] == {"1": True, "2": False}
    raw = ckpt.restore_raw(d)
    assert torch.equal(raw["params"]["w"], torch.arange(6.0))
    with pytest.raises(FileNotFoundError):
        ckpt.restore_raw(d, "client_states")
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "nope"), {})
    # a meta-less round (a crash before meta.json) is not a checkpoint
    os.makedirs(os.path.join(d, "round_9"))
    assert ckpt.latest_round(d) == 4


@pytest.mark.parametrize("bad", ["params_only", "other_model"])
def test_structure_mismatch_raises_checkpoint_error(bad, tmp_path):
    d = str(tmp_path / "ckpt")
    sim = _sim(_cfg(opt="FedAvg", n=4, m=2, rounds=1))
    if bad == "params_only":
        ckpt.save_checkpoint(d, 0, {"params": sim.server_state.params})
    else:
        other = _sim(_cfg(opt="FedAvg", n=4, m=2, rounds=1, model="mlp"))
        other.run()
        other.save(d)
    with pytest.raises(ckpt.CheckpointStructureError,
                       match="does not match the restore template"):
        sim.restore(d)


@pytest.mark.parametrize("prefetch", [1, 2, 4])
def test_ingest_pipeline_order_bound_and_errors(prefetch):
    """`tests/test_sim_scale.py:199`: order kept, at most `prefetch`
    chunks waiting plus one being made while the consumer is slow, the
    synchronous mode, an error relayed at the next pull."""
    made, lock = [], threading.Lock()

    def thunk(i):
        def run():
            with lock:
                made.append(i)
            return np.full(4, i), 32
        return run

    before = mx.snapshot()["counters"]
    got, ahead = [], []
    for x in IngestPipeline(prefetch).stream([thunk(i) for i in range(8)]):
        got.append(int(x[0]))
        time.sleep(0.02)
        with lock:
            ahead.append(len(made) - len(got))
    assert got == list(range(8))
    assert max(ahead) <= prefetch + 1
    after = mx.snapshot()["counters"]
    assert after["fed.ingest.chunks"] - before.get("fed.ingest.chunks",
                                                   0) == 8
    assert after["fed.ingest.bytes"] - before.get("fed.ingest.bytes",
                                                  0) == 8 * 32
    assert after["fed.ingest.prefetched"] > before.get(
        "fed.ingest.prefetched", 0)
    assert [int(x[0]) for x in IngestPipeline(0).stream(
        [thunk(i) for i in range(3)])] == [0, 1, 2]

    def boom():
        raise RuntimeError("gather failed")

    with pytest.raises(RuntimeError, match="gather failed"):
        list(IngestPipeline(1).stream([thunk(0), boom, thunk(1)]))


def test_knob_validation_and_refusals():
    """The load-time checks this slice makes live, and the cost model's
    refusal (it only places clients across devices: item 4)."""
    from fedml_tpu_torch.config import Config

    def load(extra):
        return Config.from_dict({"train_args": {"client_num_in_total": 8,
                                                "extra": extra}})

    with pytest.raises(ValueError, match="clients_per_device_parallel"):
        load({"cohort_chunk": 4, "clients_per_device_parallel": 3})
    load({"cohort_chunk": 4, "clients_per_device_parallel": 2})
    for bad, match in (("yes", "cost_model"),
                       ({"fit_after_rounds": 0}, "fit_after_rounds"),
                       ({"error_threshold": -1}, "error_threshold"),
                       ({"fit_after": 3}, "unknown cost_model")):
        with pytest.raises(ValueError, match=match):
            load({"cost_model": bad})
    with pytest.raises(NotImplementedError, match="item 4"):
        _sim(_cfg(n=4, m=2, extra={"cost_model": True}))


# -------------------------------------------------------- the whole slice
def test_simulation_matches_jax_simulator():
    """The JAX Simulator and the port's on one config: SCAFFOLD,
    `clients_per_device_parallel` 2, `rounds_per_block` 2, 4 rounds of 6
    of 8 clients, the port handed the JAX initial parameters and every
    round's JAX schedule: train_loss within 1e-5 relative every round,
    the final parameters within 1e-3 of their largest change."""
    d = _cfg(n=8, m=6, rounds=4, model="mlp",
             extra={"clients_per_device_parallel": 2,
                    "rounds_per_block": 2})
    sim_j = JaxSimulator(fedml_tpu.init(config=d))
    assert sim_j.mesh is None
    p0 = jax.tree.map(np.asarray, sim_j.params)
    hist_j = sim_j.run()
    assert sim_j.block_fn is not None
    ct = fedml_tpu_torch.init(config=d, device="cpu")
    ds = loader.load(ct)
    seed = ct.common_args.random_seed
    host = Simulator.__new__(Simulator)
    host.cfg, host.dataset = ct, ds

    def schedule(r):
        rng = jax.random.fold_in(jax.random.key(seed), r)
        return torch.from_numpy(np.stack([np.asarray(jax_batch_indices(
            jax.random.fold_in(rng, int(i)), ds.x_train.shape[1],
            ct.train_args.batch_size, ct.train_args.epochs))
            for i in Simulator.sample_clients(host, r)]).astype(np.int64))

    sim_t = Simulator(ct, ds, params=hub.params_from_flax(p0, device="cpu"))
    hist_t = sim_t.run(batch_schedule=schedule)
    assert sim_t.block_fn is not None
    assert [h["round"] for h in hist_t] == [h["round"] for h in hist_j]
    for a, b in zip(hist_t, hist_j):
        assert a["train_loss"] == pytest.approx(b["train_loss"], rel=1e-5)
    init, final = _flat(p0), _flat(jax.tree.map(np.asarray,
                                                sim_j.server_state.params))
    update = max(np.abs(final[k] - init[k]).max() for k in final)
    _close(sim_t.server_state.params, final, update, "final")


# -------------------------------------------------------------- the card
@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the round's determinism is the "
                    "card's")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("group", [1, 4])
def test_card_round_repeats_bitwise(cuda, group, tmp_path):
    """The same f32 4-client ResNet-18-GN round, twice in one process
    from the same parameters: every parameter and every metric bitwise
    equal (the Simulator makes cuDNN deterministic)."""
    d = {"data_args": {"dataset": "cifar10", "data_cache_dir": str(tmp_path),
                       "synthetic_samples_per_client": 64},
         "model_args": {"model": "resnet18_gn"},
         "train_args": {"client_num_in_total": 4, "client_num_per_round": 4,
                        "batch_size": 32, "learning_rate": 0.05,
                        "extra": {"clients_per_device_parallel": group}},
         "validation_args": {"frequency_of_the_test": 0}}
    cfg = fedml_tpu_torch.init(config=d, device="cuda")
    ds = loader.load(cfg)
    runs = []
    for _ in range(2):
        sim = Simulator(cfg, ds)
        assert torch.backends.cudnn.deterministic
        m = sim.run_round(0)
        runs.append((m, sim.server_state.params))
    (m0, p0), (m1, p1) = runs
    assert m0 == m1
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k
