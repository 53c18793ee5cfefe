"""Rank halves of the port's mesh tests (`test_torch_mesh.py`,
`test_torch_hierarchical.py`): functions a gloo `RankPool` runs in every
rank. This module imports torch and the port only, so the ranks never load
JAX; inputs and results are host numpy."""
import numpy as np
import torch

import fedml_tpu_torch
from fedml_tpu_torch.algorithms.builtin import build_algorithm
from fedml_tpu_torch.config import TrainArgs
from fedml_tpu_torch.core.algorithm import make_client_optimizer
from fedml_tpu_torch.models import hub
from fedml_tpu_torch.parallel import mesh as mesh_mod
from fedml_tpu_torch.parallel.launch import current
from fedml_tpu_torch.parallel.round import (
    build_block_fn, build_round_fn, shard_fed_data,
)

_MESHES: dict = {}


def mesh(*axes):
    """The mesh {name: size for (name, size) in axes}, made once per
    process (every rank builds it in the same order)."""
    if axes not in _MESHES:
        _MESHES[axes] = mesh_mod.make_mesh(dict(axes))
    return _MESHES[axes]


def _t(tree):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in tree.items()}


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _alg(spec: dict):
    """(algorithm, apply_fn) of a round spec: model (name, classes, input
    shape), algorithm name and TrainArgs knobs."""
    name, classes, shape = spec["model"]
    model = hub.create(name, classes, tuple(shape), device="cpu")
    t = TrainArgs(**spec["train"])
    apply = hub.apply_fn(model)
    return build_algorithm(t.federated_optimizer, apply, t,
                           spec.get("n_total"), spec.get("n_round")), apply


def _full_hook(name):
    if name is None:
        return None
    from fedml_tpu_torch import security as sec

    cfg = fedml_tpu_torch.config.Config.from_dict({"security_args": {
        "enable_defense": True, "defense_type": name,
        "defense_spec": {"byzantine_client_num": 1}}})
    attacker, defender = sec.from_config(cfg)
    return sec.build_server_pipeline(attacker, defender)


# ------------------------------------------------------ test_torch_mesh
def world_checks() -> dict:
    """make_mesh in a world of 4: a mesh larger than the world is refused
    with JAX's message, a -1 axis takes the rest."""
    out = {"rank": current().rank}
    try:
        mesh_mod.make_mesh({"clients": 8})
    except ValueError as e:
        out["too_big"] = str(e)
    m = mesh(("silos", 2), ("intra", -1))
    out["shape"] = [mesh_mod.axis_size(m, "silos"),
                    mesh_mod.axis_size(m, "intra")]
    out["coord"] = list(m.get_coordinate())
    return out


def file_mesh(path: str) -> dict:
    m = mesh_mod.mesh_from_file(path)
    return {"ranks": m.mesh.tolist(), "names": list(m.mesh_dim_names),
            "coord": list(m.get_coordinate())}


def shard_rows(data: dict) -> dict:
    out = shard_fed_data(data, mesh(("clients", 4)))
    try:
        shard_fed_data({**data, "weights": np.ones(8)}, mesh(("clients", 4)))
    except ValueError as e:
        return {"x": out["x"].numpy(), "error": f"{type(e).__name__}: {e}"}
    return {"x": out["x"].numpy(), "error": None}


def mesh_round(spec: dict) -> dict:
    """Rounds of `spec` over the 4-rank clients mesh (`build_block_fn`
    when spec["block"]): rank results as numpy."""
    alg, _ = _alg(spec)
    m = mesh(("clients", 4))
    kw = dict(health_stats=spec.get("health", False),
              aggregate_full=_full_hook(spec.get("full")),
              num_real_clients=spec.get("num_real"))
    st = alg.server_init(_t(spec["params"]), None)
    data = _t(spec["data"])
    rounds = spec["rounds"]
    if spec.get("block"):
        fn = build_block_fn(alg, mesh=m, **kw)
        out = fn(st, None, data, np.stack([r["ids"] for r in rounds]),
                 np.stack([r["weights"] for r in rounds]), spec["seed"],
                 [r["round"] for r in rounds],
                 batch_idx=[torch.from_numpy(r["sched"]) for r in rounds])
        return {"params": _np(out.server_state.params),
                "metrics": _np(out.metrics)}
    fn = build_round_fn(alg, mesh=m, **kw)
    hook = None
    mets = []
    for r in rounds:
        out = fn(st, None, data, r["ids"], r["weights"], (0, r["round"]),
                 batch_idx=torch.from_numpy(r["sched"]), hook_state=hook,
                 faults=r.get("faults"))
        st, hook = out.server_state, out.hook_state
        mets.append(_np(out.metrics))
    return {"params": _np(st.params), "metrics": mets}


def one_rank_bitwise(spec: dict) -> dict:
    """The round on a one-rank mesh (rank 0) against the unmeshed round
    on the same inputs: every parameter, client state and metric equal
    bit for bit. The other ranks only help build the mesh."""
    m = mesh(("clients", 1))
    if not mesh_mod.in_mesh(m):
        return None
    alg, _ = _alg(spec)
    out = {}
    for tag, msh in (("mesh", m), ("flat", None)):
        fn = build_round_fn(alg, mesh=msh, health_stats=True,
                            aggregate_full=_full_hook(spec.get("full")),
                            client_dropout=spec.get("dropout", 0.0))
        st = alg.server_init(_t(spec["params"]), None)
        cs = (None if alg.client_state_init is None else
              {k: v.unsqueeze(0).repeat((8,) + (1,) * v.dim())
               for k, v in alg.client_state_init(st.params).items()})
        r = spec["rounds"][0]
        o = fn(st, cs, _t(spec["data"]), r["ids"], r["weights"], (0, 0),
               batch_idx=torch.from_numpy(r["sched"]))
        out[tag] = (o.server_state.params, o.client_states, o.metrics)

    def same(a, b):
        if isinstance(a, dict):
            return all(same(a[k], b[k]) for k in a)
        return a is None and b is None or bool(torch.equal(a, b))

    return {"same": same(dict(enumerate(out["mesh"])),
                         dict(enumerate(out["flat"])))}


def sim_case(cfg: dict, params: dict, schedules: dict, faults=None,
             rounds: int = 3, mesh_axes=None) -> dict:
    """The Simulator over the config's mesh (or `mesh_axes`) in every
    rank, handed the JAX initial parameters and schedules (and faults,
    one round at a time); rank 0's history, parameters and per-round id
    rows."""
    from fedml_tpu_torch.simulation.simulator import Simulator

    c = fedml_tpu_torch.init(config=cfg, device="cpu")
    sim = Simulator(c, params=_t(params),
                    mesh=None if mesh_axes is None else mesh(*mesh_axes))
    ids = [sim._round_inputs(r)[0] for r in range(rounds)]
    if faults is None:
        hist = sim.run(num_rounds=rounds, batch_schedule=schedules.get)
    else:
        hist = [sim.run_round(r, batch_idx=schedules[r], faults=faults[r])
                for r in range(rounds)]
    cs = (None if sim.client_states is None
          else {k: v.numpy() for k, v in sim.client_states.items()})
    return {"history": hist, "params": _np(sim.server_state.params),
            "ids": ids, "client_states": cs, "lead": sim._lead,
            "d": sim._d, "hier": sim._hier}


def prefix_mesh_sim(cfg: dict, rounds: int = 2) -> dict:
    """The Simulator over the config's mesh_shape, smaller than the world:
    the ranks it leaves out are refused as they build it (their message),
    its own ranks run the rounds (rank 0's history and parameters)."""
    from fedml_tpu_torch.simulation.simulator import Simulator

    c = fedml_tpu_torch.init(config=cfg, device="cpu")
    try:
        sim = Simulator(c)
    except ValueError as e:
        return {"refused": str(e)}
    placed = [sim._round_inputs(r)[0] for r in range(rounds)]
    sampled = [sim.sample_clients(r) for r in range(rounds)]
    hist = sim.run(num_rounds=rounds)
    return {"refused": None, "history": hist, "d": sim._d,
            "params": _np(sim.server_state.params), "placed": placed,
            "sampled": sampled}


def runner_sim(cfg: dict, rounds: int = 2) -> dict:
    """FedMLRunner's simulation route under `scenario: hierarchical`: the
    history, the initial and final parameters, and each round's sampled
    ids beside the padded, placed (ids, weights) rows it trained."""
    from fedml_tpu_torch.runner import FedMLRunner

    c = fedml_tpu_torch.init(config=cfg, device="cpu")
    sim = FedMLRunner(c).runner
    p0 = _np(sim.server_state.params)
    placed = [sim._round_inputs(r)[:2] for r in range(rounds)]
    sampled = [sim.sample_clients(r) for r in range(rounds)]
    hist = sim.run(num_rounds=rounds)
    return {"hier": sim._hier, "history": hist, "p0": p0,
            "params": _np(sim.server_state.params), "sampled": sampled,
            "placed": placed, "counts": sim.counts}


# ----------------------------------------------- test_torch_hierarchical
def silo_trainer(spec: dict) -> dict:
    """SiloTrainer over the 4-rank `data` mesh: each rank's result."""
    from fedml_tpu_torch.cross_silo import SiloTrainer

    name, classes, shape = spec["model"]
    model = hub.create(name, classes, tuple(shape), device="meta")
    tr = SiloTrainer(model, TrainArgs(**spec["train"]), spec["x"], spec["y"],
                     mesh=mesh(("data", 4)), seed=7, device="cpu",
                     batch_schedule=lambda r: spec["sched"])
    p, n, mets = tr.train(spec["params"], 0)
    return {"params": p, "n": n, "metrics": mets,
            "pad": int(tr.x.shape[0]) - n}


def hier_round(spec: dict) -> dict:
    """make_hier_round over (silos 2, intra 2), rounds with the given
    local schedules ([m, steps, b] per round, the same on every intra
    rank)."""
    from fedml_tpu_torch.parallel.hier import make_hier_round, shard_hier_data

    alg, apply = _alg(spec)
    t = TrainArgs(**spec["train"])
    m = mesh(("silos", 2), ("intra", 2))
    opt = make_client_optimizer(t.client_optimizer, t.learning_rate,
                                t.momentum, t.weight_decay)
    fn = make_hier_round(apply, alg, m, opt, t.batch_size, t.epochs)
    st = alg.server_init(_t(spec["params"]), None)
    data = shard_hier_data(spec["data"], m)
    mets = []
    for r in spec["rounds"]:
        st, met = fn(st, data, r["ids"], r["weights"], (0, r["round"]),
                     batch_idx=r["sched"])
        mets.append(_np(met))
    return {"params": _np(st.params), "metrics": mets,
            "coord": list(m.get_coordinate())}
