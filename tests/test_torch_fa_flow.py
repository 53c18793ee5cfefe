"""The port's federated analytics (`fedml_tpu_torch/fa/`) and flow DSL
(`core/flow.py`) against the JAX package's, on the CPU.

FA is numpy host code in both packages, its draws numpy's
(`RandomState(seed + r)` sampling, `default_rng((seed, r, client))`), so
every task's result and history is bitwise JAX's, through the simulator,
cross-silo over loopback and `FedMLRunner`. The flow-DSL FedAvg runs the
same stages over each package's loopback; the port's silo trainers get
the JAX trainers' batch orders, and the final parameters agree within
1e-3 of the largest parameter update (the repo's rule for rounds).
"""
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.comm import FedCommManager as JaxComm
from fedml_tpu.comm.loopback import LoopbackTransport as JaxLoopback
from fedml_tpu.comm.loopback import release_router as jax_release
from fedml_tpu.config import TrainArgs as JaxTrainArgs
from fedml_tpu.core import flow as jflow
from fedml_tpu.core.algorithm import make_batch_indices as jax_batch_indices
from fedml_tpu.cross_silo import SiloTrainer as JaxSiloTrainer
from fedml_tpu.fa import FASimulator as JaxFASimulator
from fedml_tpu.fa import run_fa_cross_silo as jax_run_fa_cross_silo
from fedml_tpu.models import hub as jax_hub

import fedml_tpu_torch
from fedml_tpu_torch.comm import FedCommManager
from fedml_tpu_torch.comm.loopback import LoopbackTransport, release_router
from fedml_tpu_torch.config import TrainArgs
from fedml_tpu_torch.core import flow
from fedml_tpu_torch.cross_silo import SiloTrainer
from fedml_tpu_torch.fa import FA_TASKS, FASimulator, run_fa_cross_silo
from fedml_tpu_torch.models import hub
from fedml_tpu_torch.runner import FedMLRunner

torch.set_num_threads(2)

ROUND_TOL = 1e-3


def _numeric(seed=0, n=5, per=120):
    rs = np.random.RandomState(seed)
    return [rs.randn(per) * (i + 1) + i for i in range(n)]


def _ints(seed=1, n=6, per=90):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 9, per) for _ in range(n)]


def _words(seed=3, n=10):
    rs = np.random.RandomState(seed)
    heavy, rare = ["sunshine", "moonlight"], ["aardvark", "zephyr", "qux"]
    out = []
    for _ in range(n):
        w = heavy * 60 + [rare[rs.randint(len(rare))] for _ in range(6)]
        rs.shuffle(w)
        out.append(w)
    return out


CASES = [
    ("avg", _numeric, {}),
    ("frequency_estimation", _ints, {}),
    ("union", _ints, {}),
    ("intersection", lambda: [[1, 2, 3, 4, 7], [3, 4, 5, 7], [4, 3, 9, 7],
                              [7, 3, 4, 4]], {}),
    ("k_percentile", _numeric, {"k": 75.0, "lo": -40, "hi": 40,
                                "bins": 512}),
    ("triehh", _words, {"epsilon": 8.0}),
    ("heavy_hitter", _words, {"epsilon": 8.0}),
]


@pytest.mark.parametrize("per_round", [None, 3])
@pytest.mark.parametrize("name,make,kw", CASES, ids=[c[0] for c in CASES])
def test_fa_simulator_bitwise(name, make, kw, per_round):
    data = make()
    nr = 12 if name in ("triehh", "heavy_hitter") else 3
    a = FASimulator(name, data, client_num_per_round=per_round,
                    num_rounds=nr, seed=2, **kw)
    b = JaxFASimulator(name, data, client_num_per_round=per_round,
                       num_rounds=nr, seed=2, **kw)
    got, want = a.run(), b.run()
    assert type(got) is type(want)
    assert got == want or (isinstance(got, float) and np.isnan(got)
                           and np.isnan(want))
    assert len(a.history) == len(b.history)
    for x, y in zip(a.history, b.history):
        assert x == y
    if name in ("triehh", "heavy_hitter") and per_round is None:
        assert set(got) == {"sunshine", "moonlight"}, got


def test_fa_task_registry_matches_jax():
    from fedml_tpu.fa import FA_TASKS as JAX_FA_TASKS

    assert FA_TASKS.names() == JAX_FA_TASKS.names()
    with pytest.raises(KeyError, match="fa_task"):
        FA_TASKS.get("bogus_task")


@pytest.mark.parametrize("name,make,kw", [CASES[1], CASES[4], CASES[5]],
                         ids=["frequency_estimation", "k_percentile",
                              "triehh"])
def test_fa_cross_silo_matches_simulator_and_jax(name, make, kw):
    data = make()[:4]
    nr = 6 if name == "triehh" else None
    server = run_fa_cross_silo(name, data, num_rounds=nr, **kw)
    jserver = jax_run_fa_cross_silo(name, data, num_rounds=nr, **kw)
    sim = FASimulator(name, data, num_rounds=nr, **kw).run()
    assert server.result == sim == jserver.result
    assert server.history == jserver.history


def test_runner_serves_fa_task():
    data = _ints()
    cfg = fedml_tpu_torch.init(config={
        "train_args": {"client_num_in_total": 6, "client_num_per_round": 4,
                       "comm_round": 3, "fa_task": "frequency_estimation"}},
        device="cpu")
    r = FedMLRunner(cfg, dataset=data)
    assert isinstance(r.runner, FASimulator)
    want = JaxFASimulator("frequency_estimation", data,
                          client_num_per_round=4, num_rounds=3).run()
    assert r.run() == want
    with pytest.raises(ValueError, match="needs `dataset`"):
        FedMLRunner(cfg)


# ------------------------------------------------------------------ flow DSL
def _flow_problem():
    rs = np.random.RandomState(0)
    w_true = rs.randn(8, 3)
    out = {}
    for cid in (1, 2):
        x = rs.randn(64, 8).astype(np.float32)
        out[cid] = (x, np.argmax(x @ w_true, 1).astype(np.int32))
    return out


def _weighted_mean(results):
    """The aggregate stage, numpy in both packages: the sample-weighted
    mean of the clients' trees (flat dicts or flax nests)."""
    w = np.asarray([r["n"] for r in results], np.float64)
    w = w / w.sum()

    def mean(*leaves):
        if isinstance(leaves[0], dict):
            return {k: mean(*(lf[k] for lf in leaves)) for k in leaves[0]}
        return sum(wi * np.asarray(lf, np.float64)
                   for wi, lf in zip(w, leaves)).astype(np.float32)

    return mean(*(r["model"] for r in results))


def _run_flow(mod, comm_cls, loop_cls, release, trainers, params0, rounds):
    run_id = f"flow-{uuid.uuid4().hex[:6]}"
    losses = []

    def init_model(params):
        return {"model": params0, "round": 0}

    def local_training(params):
        cid = params["client_id"]
        new_p, n, metrics = trainers[cid].train(params["model"],
                                                int(params["round"]))
        losses.append(metrics["train_loss"])
        return {"model": new_p, "n": n, "round": params["round"]}

    def aggregate(params):
        results = params["client_results"]
        return {"model": _weighted_mean(results),
                "round": int(results[0]["round"]) + 1}

    flows = []
    for rank, role in ((0, mod.ROLE_SERVER), (1, mod.ROLE_CLIENT),
                       (2, mod.ROLE_CLIENT)):
        f = mod.FedMLAlgorithmFlow(comm_cls(loop_cls(rank, run_id), rank),
                                   rank, role, client_ids=[1, 2])
        f.add_flow("init", init_model, mod.ROLE_SERVER)
        f.add_flow("local_training", local_training, mod.ROLE_CLIENT)
        f.add_flow("aggregate", aggregate, mod.ROLE_SERVER)
        f.build(loop_start="local_training", rounds=rounds)
        flows.append(f)
    for f in flows[1:]:
        f.run(background=True)
    flows[0].run(background=True)
    try:
        assert flows[0].done.wait(timeout=120), "flow did not finish"
    finally:
        release(run_id)
    return flows[0].final_params, losses


def test_flow_fedavg_matches_jax():
    data = _flow_problem()
    t = dict(epochs=1, batch_size=16, learning_rate=0.3)
    jm = jax_hub.create("lr", 3)
    jp0 = jax.tree.map(np.asarray,
                       jax_hub.init_params(jm, (8,), jax.random.key(0)))
    jtr = {c: JaxSiloTrainer(jm.apply, JaxTrainArgs(**t), *d, seed=c)
           for c, d in data.items()}
    jout, jlosses = _run_flow(jflow, JaxComm, JaxLoopback, jax_release,
                              jtr, jp0, rounds=4)

    model = hub.create("lr", 3, (8,), device="meta")
    p0 = {k: v.numpy() for k, v in hub.params_from_flax(
        jp0, device="cpu").items()}

    def schedule(c):
        return lambda r: np.asarray(jax_batch_indices(
            jax.random.fold_in(jax.random.key(c), r), 64, 16, 1))

    tr = {c: SiloTrainer(model, TrainArgs(**t), *d, seed=c, device="cpu",
                         batch_schedule=schedule(c))
          for c, d in data.items()}
    out, losses = _run_flow(flow, FedCommManager, LoopbackTransport,
                            release_router, tr, p0, rounds=4)
    assert out["round"] == jout["round"] == 4
    want = hub.params_from_flax(jax.tree.map(jnp.asarray, jout["model"]),
                                device="cpu")
    got = {k: torch.as_tensor(np.asarray(v)) for k, v in out["model"].items()}
    start = {k: torch.from_numpy(v) for k, v in p0.items()}
    update = max(float((want[k] - start[k]).abs().max()) for k in start)
    diff = max(float((got[k] - want[k]).abs().max()) for k in start)
    assert update > 0 and diff <= ROUND_TOL * update, (diff, update)
    assert len(losses) == len(jlosses) == 8
    np.testing.assert_allclose(sorted(losses), sorted(jlosses), rtol=1e-4)
    assert losses[-1] < losses[0]


def test_flow_refuses_bad_stages():
    comm = FedCommManager(LoopbackTransport(0, "flow-bad"), 0)
    f = flow.FedMLAlgorithmFlow(comm, 0, flow.ROLE_SERVER, client_ids=[1])
    with pytest.raises(ValueError, match="role"):
        f.add_flow("x", lambda p: p, "edge")
    f.add_flow("a", lambda p: p)
    with pytest.raises(ValueError, match="loop_start"):
        f.build(loop_start="nope")
    release_router("flow-bad")
