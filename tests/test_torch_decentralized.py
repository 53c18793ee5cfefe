"""The port's decentralized runtimes (`fedml_tpu_torch/comm/topology.py`,
`simulation/decentralized.py`) against the JAX package's, on the CPU.

The topologies and PushSum's push matrix are numpy in both packages:
bitwise. DSGD and PushSum run k iterations on an MLP from the same
scattered per-node initial parameters (JAX's, `params_from_flax`) with
JAX's minibatch draws (`jax.random.choice` of fold_in(fold_in(key, it),
node)) injected as `idx`; the stacked parameters agree within 1e-3 of
the largest parameter update (the repo's rule for rounds) and the losses
within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.comm.topology import (
    AsymmetricTopologyManager as JaxAsym,
    SymmetricTopologyManager as JaxSym,
)
from fedml_tpu.models import hub as jax_hub
from fedml_tpu.simulation import decentralized as jdec

from fedml_tpu_torch.comm import (
    AsymmetricTopologyManager, SymmetricTopologyManager,
)
from fedml_tpu_torch.models import hub
from fedml_tpu_torch.simulation import decentralized as dec

torch.set_num_threads(2)

ROUND_TOL = 1e-3
LOSS_TOL = 1e-5
N, S, D, K, B, ITERS = 8, 32, 8, 3, 8, 5


@pytest.mark.parametrize("n", [2, 3, 6, 9])
@pytest.mark.parametrize("k", [1, 2, 4, 7])
def test_topologies_bitwise(n, k):
    a, b = SymmetricTopologyManager(n, k), JaxSym(n, k)
    np.testing.assert_array_equal(a.topology, b.topology)
    c, d = AsymmetricTopologyManager(n, k, max(1, k - 1)), \
        JaxAsym(n, k, max(1, k - 1))
    np.testing.assert_array_equal(c.topology, d.topology)
    np.testing.assert_array_equal(dec.column_stochastic(c.topology),
                                  jdec.column_stochastic(d.topology))
    for node in range(n):
        assert a.get_in_neighbor_idx_list(node) == \
            b.get_in_neighbor_idx_list(node)
        assert a.get_out_neighbor_idx_list(node) == \
            b.get_out_neighbor_idx_list(node)
        assert c.get_in_neighbor_idx_list(node) == \
            d.get_in_neighbor_idx_list(node)
        assert c.get_out_neighbor_idx_list(node) == \
            d.get_out_neighbor_idx_list(node)


def _problem(seed=0):
    rs = np.random.RandomState(seed)
    w = rs.randn(D, K)
    x = rs.randn(N, S, D).astype(np.float32)
    y = np.argmax(x @ w, axis=-1).astype(np.int32)
    return {"x": x, "y": y}


def _jax_indices(seed: int) -> np.ndarray:
    """The JAX run's [iters, N, B] minibatch draws."""
    key = jax.random.key(seed)
    return np.stack([np.stack([np.asarray(jax.random.choice(
        jax.random.fold_in(jax.random.fold_in(key, it), i), S, (B,),
        replace=False)) for i in range(N)]) for it in range(ITERS)])


@pytest.fixture(scope="module")
def setup():
    jmodel = jax_hub.create("mlp", K)
    keys_ = jax.random.split(jax.random.key(1), N)
    stacks = [jax_hub.init_params(jmodel, (D,), k) for k in keys_]
    jstacked = jax.tree.map(lambda *ls: jnp.stack(ls), *stacks)
    model = hub.create("mlp", K, (D,), device="meta")
    return {"jmodel": jmodel, "jstacked": jstacked,
            "stacked": hub.params_from_flax(jstacked, device="cpu"),
            "apply": hub.apply_fn(model), "data": _problem(),
            "idx": _jax_indices(7)}


@pytest.mark.parametrize("algo", ["dsgd", "pushsum"])
@pytest.mark.parametrize("wd", [0.0, 1e-3])
def test_k_iterations_match_jax(setup, algo, wd):
    s = setup
    jrun, run = ((jdec.run_dsgd, dec.run_dsgd) if algo == "dsgd"
                 else (jdec.run_pushsum, dec.run_pushsum))
    kw = dict(iters=ITERS, lr=0.3, batch_size=B, weight_decay=wd)
    jfinal, jlosses = jrun(s["jmodel"].apply, s["jstacked"], s["data"],
                           seed=7, **kw)
    final, losses = run(s["apply"], s["stacked"], s["data"], idx=s["idx"],
                        device="cpu", **kw)
    want = hub.params_from_flax(jfinal, device="cpu")
    p0 = s["stacked"]
    update = max(float((want[k] - p0[k]).abs().max()) for k in p0)
    diff = max(float((final[k] - want[k]).abs().max()) for k in p0)
    assert update > 0 and diff <= ROUND_TOL * update, (diff, update)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    # the consensus metric agrees too
    assert np.isclose(dec.consensus_distance(final),
                      jdec.consensus_distance(jfinal), rtol=1e-3)


def test_gossip_is_one_product_per_leaf(setup):
    """One gossip step is W @ params over the node axis, leaf by leaf."""
    W = torch.tensor(SymmetricTopologyManager(N, 2).topology,
                     dtype=torch.float32)
    out = dec._gossip(setup["stacked"], W)
    for k, a in setup["stacked"].items():
        want = torch.einsum("ij,j...->i...", W, a)
        torch.testing.assert_close(out[k], want, rtol=1e-6, atol=1e-7)


def test_runs_converge_from_scattered_starts(setup):
    s = setup
    d0 = dec.consensus_distance(s["stacked"])
    final, losses = dec.run_dsgd(s["apply"], s["stacked"], s["data"],
                                 iters=60, lr=0.3, batch_size=16,
                                 device="cpu")
    assert float(losses[-5:].mean()) < float(losses[:5].mean()) * 0.7
    assert dec.consensus_distance(final) < d0 * 0.05
    final, losses = dec.run_pushsum(s["apply"], s["stacked"], s["data"],
                                    iters=60, lr=0.3, batch_size=16,
                                    device="cpu")
    assert dec.consensus_distance(final) < d0 * 0.1
    assert all(torch.isfinite(v).all() for v in final.values())


@pytest.mark.parametrize("n", [3, 4, 8])
def test_ensure_stacked_follows_jax(setup, n):
    """A tree whose first leaf in JAX's order (bias before kernel) leads
    with n counts as stacked; the port decides as JAX does, also where
    the dict's own first leaf (the kernel [8, 3]) would say otherwise."""
    jm = jax_hub.create("lr", K)
    jp = jax_hub.init_params(jm, (D,), jax.random.key(0))
    want = jdec._ensure_stacked(jp, n)
    got = dec._ensure_stacked(hub.params_from_flax(jp, device="cpu"), n)
    wp = hub.params_from_flax(want, device="cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in wp.items()}
    for k in got:
        torch.testing.assert_close(got[k], wp[k], rtol=0, atol=0)
    # an already stacked tree is kept as given
    st = setup["stacked"]
    assert dec._ensure_stacked(st, N) is st


def test_default_draws_are_deterministic_and_without_replacement():
    a = dec.draw_indices(3, 2, 4, S, B)
    b = dec.draw_indices(3, 2, 4, S, B)
    assert a.shape == (2, 4, B) and torch.equal(a, b)
    assert all(len(set(r.tolist())) == B for r in a.reshape(-1, B))


def test_cuda_by_default(setup):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(RuntimeError, match="no GPU"):
        dec.run_dsgd(setup["apply"], setup["stacked"], setup["data"],
                     iters=1)
