"""The port's small runtimes against the JAX package's, on the CPU: HierFL
(`simulation/hierarchical_fl.py`), SplitNN (`split_nn.py`), vertical FL
(`vertical.py`) and FedGKT (`fedgkt.py`).

Group assignment and sampling are numpy in both packages: bitwise. Each
runtime gets the JAX initial parameters (`params_from_flax`) and the JAX
batch orders (the `fold_in` keys of the JAX module, drawn here and
injected), so both compute the same function; parameters agree within
1e-3 of the largest parameter update (the repo's rule for rounds) and
losses within 1e-5 relative.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.builtin import make_fedavg as jax_make_fedavg
from fedml_tpu.config import TrainArgs as JaxTrainArgs
from fedml_tpu.core.algorithm import make_batch_indices as jax_batch_indices
from fedml_tpu.models import hub as jax_hub
from fedml_tpu.simulation import fedgkt as jgkt
from fedml_tpu.simulation.hierarchical_fl import HierFLRunner as JaxHier
from fedml_tpu.simulation.hierarchical_fl import (
    assign_groups as jax_assign_groups,
)
from fedml_tpu.simulation.split_nn import SplitNNRunner as JaxSplit
from fedml_tpu.simulation.vertical import VerticalFL as JaxVertical

from fedml_tpu_torch.algorithms.builtin import make_fedavg
from fedml_tpu_torch.config import TrainArgs
from fedml_tpu_torch.models import hub
from fedml_tpu_torch.simulation import fedgkt as gkt
from fedml_tpu_torch.simulation import split_nn
from fedml_tpu_torch.simulation.hierarchical_fl import (
    HierFLRunner, assign_groups,
)
from fedml_tpu_torch.simulation.vertical import VerticalFL

torch.set_num_threads(2)

ROUND_TOL = 1e-3
LOSS_TOL = 1e-5


def _flax(p):
    return hub.params_from_flax(p, device="cpu")


def _check_params(got: dict, want: dict, start: dict, tol=ROUND_TOL):
    assert set(got) == set(want) == set(start)
    update = max(float((want[k] - start[k]).abs().max()) for k in start)
    diff = max(float((got[k] - want[k]).abs().max()) for k in start)
    assert update > 0 and diff <= tol * update, (diff, update)


def _clients_data(n_clients=3, s=64, d=8, k=3, seed=0):
    rs = np.random.RandomState(seed)
    w = rs.randn(d, k)
    x = rs.randn(n_clients, s, d).astype(np.float32)
    y = np.argmax(x @ w, axis=-1).astype(np.int32)
    return {"x": x, "y": y}


# ------------------------------------------------------------------- HierFL
@pytest.mark.parametrize("n,g,seed", [(20, 4, 0), (7, 3, 5), (5, 8, 2),
                                      (50, 2, 11)])
def test_assign_groups_bitwise(n, g, seed):
    got, want = assign_groups(n, g, seed=seed), jax_assign_groups(
        n, g, seed=seed)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    with pytest.raises(ValueError, match="group_method"):
        assign_groups(n, g, method="kmeans")


@pytest.mark.parametrize("per_round", [None, 2])
def test_hierfl_matches_jax(per_round):
    n, s, seed = 8, 48, 5
    data = _clients_data(n_clients=n, s=s, seed=3)
    data["mask"] = np.ones((n, s), np.float32)
    jm = jax_hub.create("lr", 3)
    jt = JaxTrainArgs(epochs=1, batch_size=16, learning_rate=0.3)
    jp = jax_hub.init_params(jm, (8,), jax.random.key(0))
    jr = JaxHier(jax_make_fedavg(jm.apply, jt), jp, data,
                 counts=np.full(n, float(s)), n_groups=3,
                 group_comm_round=2, clients_per_group_round=per_round,
                 seed=seed)
    jh = jr.run(global_rounds=2)

    def sched(R, gi, r):
        ids = jr._sample(jr.groups[gi], R, r)
        rng = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
            jax.random.key(seed), R), gi), r)
        return np.stack([np.asarray(jax_batch_indices(
            jax.random.fold_in(rng, int(c)), s, 16, 1)) for c in ids])

    model = hub.create("lr", 3, (8,), device="meta")
    alg = make_fedavg(hub.apply_fn(model), TrainArgs(
        epochs=1, batch_size=16, learning_rate=0.3))
    p0 = _flax(jp)
    r = HierFLRunner(alg, p0, data, counts=np.full(n, float(s)), n_groups=3,
                     group_comm_round=2, clients_per_group_round=per_round,
                     seed=seed, device="cpu")
    for a, b in zip(r.groups, jr.groups):
        np.testing.assert_array_equal(a, b)
    h = r.run(2, batch_schedule=sched)
    for a, b in zip(h, jh):
        assert a["round"] == b["round"]
        assert abs(a["train_loss"] - b["train_loss"]) <= \
            LOSS_TOL * abs(b["train_loss"])
    _check_params(r.params, _flax(jr.params), p0)


# ------------------------------------------------------------------ SplitNN
class JBottom(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return fnn.relu(fnn.Dense(16)(x))


class JTop(fnn.Module):
    @fnn.compact
    def __call__(self, h):
        h = fnn.relu(fnn.Dense(16)(h))
        return fnn.Dense(3)(h)


class Bottom(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.Dense_0 = hub.Dense(8, 16, torch.float32, "cpu")

    def forward(self, x, dtype=None):
        return torch.relu(self.Dense_0(x))


class Top(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.Dense_0 = hub.Dense(16, 16, torch.float32, "cpu")
        self.Dense_1 = hub.Dense(16, 3, torch.float32, "cpu")

    def forward(self, h, dtype=None):
        return self.Dense_1(torch.relu(self.Dense_0(h)))


@pytest.fixture(scope="module")
def split():
    data = _clients_data()
    jr = JaxSplit(JBottom(), JTop(), data, lr=0.2, batch_size=16, epochs=2,
                  seed=4)
    c0, s0 = _flax(jr.client_params), _flax(jr.server_params)
    jh = jr.run(rounds=2)

    def order(r, k):
        return np.asarray(jax_batch_indices(jax.random.fold_in(
            jax.random.fold_in(jax.random.key(4), r), k), 64, 16, 2))

    r = split_nn.SplitNNRunner(Bottom(), Top(), data, lr=0.2, batch_size=16,
                               epochs=2, seed=4, client_params=c0,
                               server_params=s0, device="cpu")
    return {"jr": jr, "jh": jh, "r": r, "c0": c0, "s0": s0, "order": order,
            "data": data}


def test_splitnn_matches_jax(split):
    h = split["r"].run(2, batch_idx=split["order"])
    assert [(a["round"], a["client"]) for a in h] == \
        [(b["round"], b["client"]) for b in split["jh"]]
    for a, b in zip(h, split["jh"]):
        assert abs(a["loss"] - b["loss"]) <= LOSS_TOL * abs(b["loss"])
        assert a["acc"] == b["acc"]
    _check_params(split["r"].client_params, _flax(split["jr"].client_params),
                  split["c0"])
    _check_params(split["r"].server_params, _flax(split["jr"].server_params),
                  split["s0"])
    x0 = split["data"]["x"][0]
    np.testing.assert_array_equal(split["r"].predict(x0).numpy(),
                                  np.asarray(split["jr"].predict(x0)))


def test_splitnn_only_h_and_dh_cross(split, monkeypatch):
    """The server step sees the activations (detached: no graph back to
    the client's parameters) and the labels; the client's backward gets
    dL/dh and its own context."""
    r = split_nn.SplitNNRunner(Bottom(), Top(), split["data"], lr=0.2,
                               batch_size=16, epochs=1, seed=4,
                               client_params=split["c0"],
                               server_params=split["s0"], device="cpu")
    step = r._step
    crossed = []
    server_step, client_backward = step.server_step, step.client_backward

    def spy_server(sp, s_state, h, y, mask):
        crossed.append(("up", h))
        assert h.grad_fn is None and not h.requires_grad
        client = {v.data_ptr() for v in r.client_params.values()}
        assert all(t.data_ptr() not in client for t in (h, y, mask))
        return server_step(sp, s_state, h, y, mask)

    def spy_backward(cp, c_state, ctx, dh):
        crossed.append(("down", dh))
        assert crossed[-2][0] == "up"
        assert dh.shape == crossed[-2][1].shape
        return client_backward(cp, c_state, ctx, dh)

    monkeypatch.setattr(step, "server_step", spy_server)
    monkeypatch.setattr(step, "client_backward", spy_backward)
    r.run(1, batch_idx=lambda rr, k: split["order"](rr, k)[:2])
    assert [d for d, _ in crossed] == ["up", "down"] * 6


# -------------------------------------------------------------- vertical FL
def test_vertical_fl_matches_jax():
    rs = np.random.RandomState(1)
    n, dims = 256, (5, 4, 3)
    xs = [rs.randn(n, d).astype(np.float32) for d in dims]
    w_true = [rs.randn(d) for d in dims]
    y = (sum(x @ w for x, w in zip(xs, w_true)) > 0).astype(np.float32)
    jv = JaxVertical(list(dims), lr=0.5, seed=2)
    p0 = [{k: np.asarray(v) for k, v in p.items()} for p in jv.params]
    v = VerticalFL(list(dims), lr=0.5, params=p0, device="cpu")
    jv.fit(xs, y, epochs=4, batch_size=64, seed=3)
    v.fit(xs, y, epochs=4, batch_size=64, seed=3)
    np.testing.assert_allclose(v.loss_trace, jv.loss_trace, rtol=LOSS_TOL)
    assert v.loss_trace[-1] < v.loss_trace[0] * 0.6
    flat = lambda ps: {f"{i}.{k}": torch.as_tensor(np.array(a))
                       for i, p in enumerate(ps) for k, a in p.items()}
    _check_params(flat(v.params), flat(jv.params), flat(p0))
    np.testing.assert_array_equal(v.predict(xs), jv.predict(xs))
    # a one-party federation cannot see the label's other features
    solo = VerticalFL([dims[0]], lr=0.5, device="cpu")
    solo.fit(xs[:1], y, epochs=4)
    acc = lambda m, x: (m.predict(x) == y.astype(np.int32)).mean()
    assert acc(v, xs) > acc(solo, xs[:1])


# ------------------------------------------------------------------- FedGKT
@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("t", [1.0, 3.0])
def test_kd_kl_matches_jax(mask, t):
    rs = np.random.RandomState(int(t) + mask)
    s, te = (rs.randn(12, 5).astype(np.float32) * 3 for _ in range(2))
    m = (rs.rand(12) > 0.3).astype(np.float32) if mask else None
    got = gkt.kd_kl(torch.from_numpy(s), torch.from_numpy(te), t,
                    None if m is None else torch.from_numpy(m))
    want = jgkt.kd_kl(jnp.asarray(s), jnp.asarray(te), t,
                      None if m is None else jnp.asarray(m))
    assert np.isclose(float(got), float(want), rtol=1e-6), (got, want)


@pytest.fixture(scope="module")
def gkt_runs():
    rs = np.random.RandomState(0)
    n, s, k = 3, 16, 4
    data = {"x": rs.randn(n, s, 8, 8, 3).astype(np.float32),
            "y": rs.randint(0, k, (n, s)).astype(np.int32),
            "mask": np.ones((n, s), np.float32)}
    data["mask"][2, -3:] = 0.0
    kw = dict(batch_size=4, client_epochs=1, server_epochs=1, lr=0.05)
    jr = jgkt.FedGKTRunner(data, k, seed=1, **kw)
    c0, s0 = _flax(jr.client_params), _flax(jr.server_params)
    jrows = [jr.run_round(r) for r in range(2)]

    def orders(r):
        rng = jax.random.fold_in(jax.random.key(1), r)
        ci = np.stack([np.asarray(jax_batch_indices(
            jax.random.fold_in(rng, i), s, 4, 1)) for i in range(n)])
        si = np.asarray(jax_batch_indices(
            jax.random.fold_in(rng, 0x5E), n * s, 8, 1))
        return ci, si

    r = gkt.FedGKTRunner(data, k, seed=1, client_params=c0,
                         server_params=s0, device="cpu", **kw)
    rows = [r.run_round(i, *orders(i)) for i in range(2)]
    return {"jr": jr, "jrows": jrows, "r": r, "rows": rows, "c0": c0,
            "s0": s0, "data": data}


def test_gkt_parameter_names_are_flax_names(gkt_runs):
    assert set(gkt_runs["c0"]) == {
        n for n, _ in gkt_runs["r"].client_net.named_parameters()}
    assert set(gkt_runs["s0"]) == {
        n for n, _ in gkt_runs["r"].server_net.named_parameters()}


def test_gkt_rounds_match_jax(gkt_runs):
    for a, b in zip(gkt_runs["rows"], gkt_runs["jrows"]):
        assert a["round"] == b["round"]
        for key in ("client_loss", "server_loss"):
            assert abs(a[key] - b[key]) <= 1e-4 * abs(b[key]), key
        for key in ("client_acc", "server_acc"):
            assert a[key] == b[key], key
    r, jr = gkt_runs["r"], gkt_runs["jr"]
    _check_params(r.client_params, _flax(jr.client_params), gkt_runs["c0"])
    _check_params(r.server_params, _flax(jr.server_params), gkt_runs["s0"])
    np.testing.assert_allclose(r.server_logits.numpy(),
                               np.asarray(jr.server_logits), rtol=1e-3,
                               atol=1e-4)
    x = gkt_runs["data"]["x"][0]
    np.testing.assert_array_equal(r.predict(x).numpy(),
                                  np.asarray(jr.predict(x)))


def test_gkt_default_draws_and_cuda_default(gkt_runs):
    r = gkt_runs["r"]
    ci, si = r.draw_orders(0)
    assert ci.shape == (3, 4, 4) and si.shape == (6, 8)
    assert torch.equal(ci, r.draw_orders(0)[0])
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(RuntimeError, match="no GPU"):
        gkt.FedGKTRunner(gkt_runs["data"], 4)
