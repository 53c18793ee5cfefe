"""The ported examples (`fedml_tpu_torch/examples/`) as the port's smoke
suite, part 1: quick start, cross-silo (plain and SecAgg) and federated
analytics, in-process on the CPU with `--device cpu`, and every example's
refusal to run without a GPU when `--device` is left at `cuda`.

Each example asserts its own success (the JAX examples' asserts, kept);
these tests run them as `tests/test_examples.py` runs the JAX ones (its
12 cases span this file, test_torch_examples_mesh.py and
test_torch_examples_serving.py). Where a run is fixed once its draws
are, the example is handed the JAX example's initial parameters and
batch orders and held to the JAX example's calls
(`torch_examples_common.py` states the bars): quick start round by round,
cross-silo (plain and SecAgg) by its history and final parameters. The analytics are
host numpy in both packages, so their results are held bitwise."""
import ast
import copy
import os
import sys
import uuid
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import fedml_tpu
from fedml_tpu.comm import FedCommManager as JaxComm
from fedml_tpu.comm import create_transport as jax_create_transport
from fedml_tpu.comm.loopback import release_router as jax_release
from fedml_tpu.config import TrainArgs as JaxTrainArgs
from fedml_tpu.core.algorithm import make_batch_indices as jax_batch_indices
from fedml_tpu.cross_silo import FedClientManager as JaxClient
from fedml_tpu.cross_silo import FedServerManager as JaxServer
from fedml_tpu.cross_silo import SecAggClientManager as JaxSecAggClient
from fedml_tpu.cross_silo import SecAggServerManager as JaxSecAggServer
from fedml_tpu.cross_silo import SiloTrainer as JaxSiloTrainer
from fedml_tpu.models import hub as jax_hub

import fedml_tpu_torch
from fedml_tpu_torch.data import loader
from fedml_tpu_torch.examples import CASES, EXAMPLES
from fedml_tpu_torch.examples import quick_start_simulation as quick_start
from fedml_tpu_torch.models import hub

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_examples_common import (  # noqa: E402
    assert_acc, assert_losses, fresh_metrics, jax_batches, run,
)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PARAM_TOL = 1e-5   # max |param diff| over the largest update (f32, CPU)


def _flat(tree) -> dict:
    return {k: v.numpy() for k, v in hub.params_from_flax(
        tree, device="cpu").items()}


def test_case_table_is_jax_smoke_suite():
    """`examples.CASES` is the JAX package's smoke suite, case for case
    (tests/test_examples.py's `_CASES`, read with `ast`)."""
    tree = ast.parse((ROOT / "tests" / "test_examples.py").read_text())
    (want,) = [ast.literal_eval(node.value) for node in tree.body
               if isinstance(node, ast.Assign)
               and [t.id for t in node.targets] == ["_CASES"]]
    got = [(f"{name}.py", list(flags)) for name, flags in CASES]
    assert sorted(got) == sorted((s, list(a)) for s, a in want)
    assert {name for name, _ in CASES} == set(EXAMPLES)


def test_quick_start_simulation(capsys):
    """The inline config is the JAX example's; handed the JAX Simulator's
    initial parameters and batch orders, every round's losses match and
    the accuracies are within one sample."""
    src = (ROOT / "examples" / "quick_start_simulation.py").read_text()
    lit = [kw.value for node in ast.walk(ast.parse(src))
           if isinstance(node, ast.Call) for kw in node.keywords
           if kw.arg == "config"]
    assert ast.literal_eval(lit[0]) == quick_start.CONFIG

    want = fedml_tpu.run_simulation(fedml_tpu.init(
        config=copy.deepcopy(quick_start.CONFIG)))
    cfg = fedml_tpu_torch.init(config=copy.deepcopy(quick_start.CONFIG),
                               device="cpu")
    ds, t = loader.load(cfg), cfg.train_args
    seed = cfg.common_args.random_seed
    p0 = jax_hub.init_params(jax_hub.create("lr", ds.num_classes),
                             ds.x_train.shape[2:], jax.random.key(seed))
    batches = jax_batches(seed, t.comm_round, t.client_num_per_round,
                          ds.shard_size, t.batch_size, t.epochs)
    got = run("quick_start_simulation", draws={
        "params": hub.params_from_flax(p0, device="cpu"),
        "batches": [torch.from_numpy(b) for b in batches]})
    assert capsys.readouterr().out.splitlines()[-1].startswith("final round:")
    hist = got["history"]
    assert [h["round"] for h in hist] == [h["round"] for h in want]
    for k in ("train_loss", "test_loss"):
        assert_losses([h[k] for h in hist], [h[k] for h in want])
    for g, w in zip(hist, want):
        assert g["n_samples"] == w["n_samples"]
        assert_acc(g["train_acc"], w["train_acc"], w["n_samples"])
        assert_acc(g["test_acc"], w["test_acc"], len(ds.y_test))
    assert got["round"] == 9 and got["test_acc"] > 0.9


def _jax_cross_silo(secagg: bool):
    """The JAX example's federation (3 silos, 3 rounds; plain with a
    quorum of 2 of 3, or SecAgg); its initial and final parameters and
    history."""
    run_id = f"jx-example-{uuid.uuid4().hex[:6]}"
    model = jax_hub.create("lr", 3)
    t = JaxTrainArgs(epochs=2, batch_size=16, learning_rate=0.2)
    params = jax.tree.map(np.asarray, jax_hub.init_params(
        model, (8,), jax.random.key(0)))
    ids = [1, 2, 3]

    def mk(rank):
        return JaxComm(jax_create_transport("loopback", rank, run_id=run_id),
                       rank)

    if secagg:
        server = JaxSecAggServer(mk(0), client_ids=ids, init_params=params,
                                 num_rounds=3)
    else:
        server = JaxServer(mk(0), client_ids=ids, init_params=params,
                           num_rounds=3, round_timeout=30.0,
                           quorum_frac=2 / 3)
    rs = np.random.RandomState(0)
    w_true = rs.randn(8, 3)
    clients = []
    for cid in ids:
        x = rs.randn(64, 8).astype(np.float32)
        y = np.argmax(x @ w_true, 1).astype(np.int32)
        trainer = JaxSiloTrainer(model.apply, t, x, y, seed=cid)
        clients.append(JaxSecAggClient(mk(cid), cid, trainer, num_clients=3,
                                       client_ids=ids) if secagg
                       else JaxClient(mk(cid), cid, trainer))
    server.run(background=True)
    for c in clients:
        c.run(background=True)
    for c in clients:
        c.announce_ready()
    assert server.done.wait(timeout=300)
    jax_release(run_id)
    return params, server.params, server.history


@pytest.mark.parametrize("secagg", [False, True], ids=["plain", "secagg"])
def test_cross_silo_federation(capsys, secagg):
    """Handed the JAX example's initial parameters and each silo's JAX
    batch orders (`fold_in(key(silo), round)`), the history equals the
    JAX example's and the final global parameters are within 1e-5 of the
    largest update (SecAgg's masks are the port's own draws; they cancel
    in the field, and its quantized sum was bitwise JAX's when this test
    was written)."""
    p0, final, want = _jax_cross_silo(secagg)
    draws = {"params": _flat(p0), "batches": {cid: [
        np.asarray(jax_batch_indices(jax.random.fold_in(
            jax.random.key(cid), r), 64, 16, 2)) for r in range(3)]
        for cid in (1, 2, 3)}}
    got = run("cross_silo_federation", *(["--secagg"] if secagg else []),
              draws=draws)
    out = capsys.readouterr().out.splitlines()[-1]
    assert out.startswith(("secagg " if secagg else "")
                          + "federation history:"), out
    assert {k: got[k] for k in ("round", "n_received")} == \
        {"round": 2, "n_received": 3}
    assert [(r["round"], r["n_received"]) for r in got["history"]] == \
        [(r["round"], r["n_received"]) for r in want]
    init, final = _flat(p0), _flat(final)
    update = max(float(np.abs(final[k] - init[k]).max()) for k in final)
    err = max(float(np.abs(np.asarray(got["params"][k], np.float64)
                           - final[k]).max()) for k in final)
    assert update > 0 and err <= PARAM_TOL * update, (err, update)


def test_federated_analytics(capsys):
    from fedml_tpu.fa import FASimulator as JaxFASimulator
    from fedml_tpu.fa import run_fa_cross_silo as jax_run_fa_cross_silo

    got = run("federated_analytics")
    assert capsys.readouterr().out.splitlines()[-1].startswith(
        "federated p95:")
    clients = [["sunshine"] * 120 + ["moonlight"] * 100 + ["rare_word"]
               for _ in range(10)]
    assert got["heavy_hitters"] == JaxFASimulator(
        "triehh", clients, num_rounds=12, epsilon=8.0).run()
    rs = np.random.RandomState(0)
    data = [rs.lognormal(3.0, 1.0, 500) for _ in range(5)]
    want = jax_run_fa_cross_silo("k_percentile", data, k=95.0, lo=0, hi=500,
                                 bins=8192).result
    assert got["p95"] == float(want)
    assert abs(got["p95"] - got["central_p95"]) < 0.5


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is visible")
@pytest.mark.parametrize("name", EXAMPLES)
def test_example_refuses_without_gpu(name, capsys):
    """Left at its default `--device cuda`, every example raises where no
    GPU is visible, before it trains or serves anything."""
    import importlib

    mod = importlib.import_module(f"fedml_tpu_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="no GPU is visible"):
        mod.main([])
    assert "round" not in capsys.readouterr().out
