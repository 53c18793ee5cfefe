"""The port's contribution assessment (`fedml_tpu_torch.contribution`)
against the JAX package's `fedml_tpu.contribution`, on the CPU.

m client models of the digits MLP (the flax initial parameters plus
seeded per-client perturbations of different sizes) are valued with a
loss utility, the negative mean cross-entropy on the digits test rows, in
f32 on both sides. Leave-one-out, GTG-Shapley (the same seeded
permutations) and exact MR-Shapley agree within 1e-5; GTG takes the same
number of permutations, in a case whose utilities sit far from its
truncation thresholds. Chunked and unchunked evaluations agree within
1e-6 (the rows are independent; only the vmapped kernels' batch sizes
differ).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu import contribution as jc
from fedml_tpu.core.algorithm import masked_softmax_ce as jax_ce
from fedml_tpu.models import hub as jax_hub

from fedml_tpu_torch import contribution as pc
from fedml_tpu_torch.core.algorithm import masked_softmax_ce
from fedml_tpu_torch.models import hub

torch.set_num_threads(2)

TOL = 1e-5
M = 5


@pytest.fixture(scope="module")
def setup():
    from sklearn.datasets import load_digits

    d = load_digits()
    x = (d.data.astype(np.float32) / 16.0)[:400]
    y = d.target.astype(np.int32)[:400]
    model = jax_hub.create("mlp", 10)
    p0 = jax.tree.map(np.asarray, jax_hub.init_params(
        model, (64,), jax.random.key(0)))
    rs = np.random.RandomState(3)
    # client i moves further from the start than client i - 1, so the
    # values are spread and no prefix sits at GTG's thresholds
    clients = [jax.tree.map(
        lambda a, s=0.02 * (i + 1): a + s * rs.randn(*a.shape).astype(
            np.float32), p0) for i in range(M)]
    weights = np.asarray([30.0, 50.0, 20.0, 40.0, 60.0], np.float32)
    stacked_j = jax.tree.map(lambda *a: jnp.stack(a), *clients)

    def jax_utility(p):
        loss, _c, _n = jax_ce(model.apply({"params": p}, jnp.asarray(x)),
                              jnp.asarray(y), jnp.ones(len(y)))
        return -loss

    tmodel = hub.create("mlp", 10, (64,), device="cpu")
    fn = hub.apply_fn(tmodel)
    tx, ty, tm = (torch.from_numpy(x), torch.from_numpy(y).long(),
                  torch.ones(len(y)))
    tclients = [hub.params_from_flax(c, device="cpu") for c in clients]
    stacked_t = {k: torch.stack([c[k] for c in tclients])
                 for k in tclients[0]}

    def utility(p):
        loss, _c, _n = masked_softmax_ce(fn(p, tx), ty, tm)
        return -loss

    u0 = float(jax_utility(jax.tree.map(jnp.asarray, p0)))
    return {"j": (stacked_j, jnp.asarray(weights), jax_utility),
            "t": (stacked_t, torch.from_numpy(weights), utility), "u0": u0}


def _close(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= TOL, (k, got[k], want[k])


def test_batched_utilities_match_jax_and_chunks_agree(setup):
    masks = np.random.RandomState(0).randint(0, 2, (9, M)).astype(np.float32)
    masks[0] = 1.0
    want = jc.batched_subset_utilities(*setup["j"][:2], masks, setup["j"][2])
    whole = pc.batched_subset_utilities(*setup["t"][:2], masks,
                                        setup["t"][2])
    chunked = pc.batched_subset_utilities(*setup["t"][:2], masks,
                                          setup["t"][2], chunk=2)
    one = [pc.batched_subset_utilities(*setup["t"][:2], masks[i:i + 1],
                                       setup["t"][2], chunk=1)[0]
           for i in range(len(masks))]
    assert whole.dtype == np.float32 and whole.shape == (9,)
    np.testing.assert_allclose(whole, want, atol=TOL, rtol=0)
    np.testing.assert_allclose(chunked, whole, atol=1e-6, rtol=0)
    np.testing.assert_allclose(one, whole, atol=1e-6, rtol=0)
    assert pc.default_chunk(setup["t"][0]) >= len(masks)


def test_leave_one_out_matches_jax(setup):
    ids = [11, 12, 13, 14, 15]
    _close(pc.leave_one_out(*setup["t"][:2], ids, setup["t"][2], chunk=4),
           jc.leave_one_out(*setup["j"][:2], ids, setup["j"][2]))


def test_mr_shapley_matches_jax(setup):
    ids = list(range(M))
    _close(pc.mr_shapley(*setup["t"][:2], ids, setup["t"][2],
                         baseline_utility=setup["u0"], chunk=7),
           jc.mr_shapley(*setup["j"][:2], ids, setup["j"][2],
                         baseline_utility=setup["u0"]))


def test_gtg_matches_jax_with_the_same_permutations(setup):
    ids = list(range(M))
    full = float(setup["j"][2](jc.subset_aggregate(
        *setup["j"][:2], jnp.ones(M))))
    kw = dict(eps=1e-4, round_trunc_threshold=1e-4, seed=5)
    jg, tg = jc.GTGShapley(**kw), pc.GTGShapley(chunk=3, **kw)
    want = jg.run(*setup["j"][:2], ids, setup["j"][2], setup["u0"], full)
    got = tg.run(*setup["t"][:2], ids, setup["t"][2], setup["u0"], full)
    _close(got, want)
    # the same permutations were drawn: both generators are in one state
    assert tg.permutations > M
    assert jg.rng.randint(1 << 30) == tg.rng.randint(1 << 30)
    # round truncation: no movement, no evaluation
    assert set(tg.run(*setup["t"][:2], ids, setup["t"][2], 0.5, 0.5,
                      round_idx=1).values()) == {0.0}


def test_manager_matches_jax(setup):
    ids = list(range(M))
    full = float(setup["j"][2](jc.subset_aggregate(
        *setup["j"][:2], jnp.ones(M))))
    for alg in ("LOO", "GTG", "MR"):
        jm = jc.ContributionAssessorManager(alg)
        tm = pc.ContributionAssessorManager(alg, chunk=8)
        for r in range(2):
            jm.run(*setup["j"][:2], ids, setup["j"][2], setup["u0"], full,
                   round_idx=r)
            tm.run(*setup["t"][:2], ids, setup["t"][2], setup["u0"], full,
                   round_idx=r)
        _close(tm.get_final_contribution_assignment(),
               jm.get_final_contribution_assignment())
    with pytest.raises(ValueError, match="LOO | GTG | MR"):
        pc.ContributionAssessorManager("shap").run(
            *setup["t"][:2], ids, setup["t"][2])
