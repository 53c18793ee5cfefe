"""The round's plugins of the port (`fedml_tpu_torch`: dp/, security/,
compression/, data/poison.py, comm/chaos.py's FaultSpec, the health
tracker's faults, the tree clip) against the JAX package's, function by
function, on the CPU and the same inputs.

Bars: bitwise for the host-side numpy code (the accountant, the wire
codec, data poisoning, FaultSpec's validation) and for what the
selection-based defenses and top-k select (a constructed tie included:
both break it towards the lower index); within 1e-6 of the largest value
(f32) for the aggregators and for the apply halves of every random
transform, fed the noise the JAX function draws. The port's own draws
are held statistically (the JAX tests' bars) and to their key.
"""
import dataclasses

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from fedml_tpu import compression as jcomp
    from fedml_tpu import dp as jdp
    from fedml_tpu import security as jsec
    from fedml_tpu.comm.chaos import FaultSpec as JaxFaultSpec
    from fedml_tpu.config import DPArgs as JaxDPArgs
    from fedml_tpu.config import SecurityArgs as JaxSecurityArgs
    from fedml_tpu.data import poison as jpoison
    from fedml_tpu.dp import accountant as jacc
    from fedml_tpu.dp import mechanisms as jmech
    from fedml_tpu.ops import tree as jtree
    from fedml_tpu.security import attacks as jatk
    from fedml_tpu.security import defenses as jdfs
    from fedml_tpu.utils.health import HealthTracker as JaxHealthTracker
except ModuleNotFoundError:
    pass

from fedml_tpu_torch import compression as comp
from fedml_tpu_torch import dp
from fedml_tpu_torch import security as sec
from fedml_tpu_torch.comm.chaos import FaultSpec
from fedml_tpu_torch.config import DPArgs, SecurityArgs
from fedml_tpu_torch.data import poison
from fedml_tpu_torch.dp import accountant as acc
from fedml_tpu_torch.dp import mechanisms as mech
from fedml_tpu_torch.ops import keys
from fedml_tpu_torch.ops.tree import tree_clip_by_global_norm, tree_norm
from fedml_tpu_torch.security import attacks as atk
from fedml_tpu_torch.security import defenses as dfs
from fedml_tpu_torch.utils.health import HealthTracker

torch.set_num_threads(2)

REL = 1e-6   # f32: max |port - JAX| over the JAX result's largest value


def _rel(got, want, what=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= REL, f"{what}: {err:.3g} of the largest value"


def _t(a):
    return torch.from_numpy(np.array(a))


def _tree(seed=0):
    rs = np.random.RandomState(seed)
    return {"w": rs.randn(6, 7).astype(np.float32),
            "b": rs.randn(7).astype(np.float32),
            "c": {"k": rs.randn(3, 2, 4).astype(np.float32)}}


def _ttree(t):
    return {k: _ttree(v) if isinstance(v, dict) else _t(v)
            for k, v in t.items()}


def _jtree(t):
    return jax.tree.map(jnp.asarray, t)


def _tree_rel(got, want, what=""):
    for k, w in want.items():
        if isinstance(w, dict):
            _tree_rel(got[k], w, what + "/" + k)
        else:
            _rel(got[k], np.asarray(w), what + "/" + k)


def _jax_split(rng, tree):
    """The per-leaf keys the JAX transforms split off, in leaf order, as
    a tree of keys matching the port's tree order."""
    leaves, treedef = jax.tree.flatten(tree)
    return jax.tree.unflatten(treedef, list(jax.random.split(rng,
                                                             len(leaves))))


def _U(m=10, d=300, seed=0):
    rs = np.random.RandomState(seed)
    U = rs.randn(m, d).astype(np.float32)
    U[:, : d // 3] += 0.5   # a shared direction, as honest updates have
    w = rs.randint(5, 50, m).astype(np.float32)
    return U, w


# -------------------------------------------------------- host-side, bitwise
@pytest.mark.parametrize("q,z,steps", [(1.0, 1.1, 3), (0.05, 1.1, 10),
                                       (0.3, 0.7, 1), (0.01, 2.0, 100)])
def test_accountant_bitwise(q, z, steps):
    np.testing.assert_array_equal(acc.compute_rdp(q, z, steps),
                                  jacc.compute_rdp(q, z, steps))
    rdp = jacc.compute_rdp(q, z, steps)
    assert acc.get_privacy_spent(acc.DEFAULT_ORDERS, rdp, 1e-5) == \
        jacc.get_privacy_spent(jacc.DEFAULT_ORDERS, rdp, 1e-5)
    a, b = acc.RDPAccountant(z, q, 1e-5), jacc.RDPAccountant(z, q, 1e-5)
    assert a.get_epsilon() == b.get_epsilon() == 0.0
    a.step(steps)
    b.step(steps)
    assert a.get_epsilon() == b.get_epsilon()


@pytest.mark.parametrize("n,ratio,vdt", [(256, 0.1, np.float32),
                                         (70000, 0.01, np.float16),
                                         (5, 1.0, np.float32),
                                         (0, 0.5, np.float32)])
def test_wire_codec_bitwise(n, ratio, vdt):
    v = np.random.RandomState(n).randn(n).astype(np.float32)
    a, b = comp.encode_sparse(v, ratio, vdt), jcomp.encode_sparse(v, ratio,
                                                                  vdt)
    assert a["n"] == b["n"]
    for k in ("idx", "val"):
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(comp.decode_sparse(a),
                                  jcomp.decode_sparse(b))


def test_wire_codec_refusals_and_trees():
    bad = np.array([1.0, np.nan], np.float32)
    for mod in (comp, jcomp):
        with pytest.raises(ValueError, match="non-finite"):
            mod.encode_sparse(bad, 0.5)
        with pytest.raises(ValueError, match="out of range"):
            mod.decode_sparse({"idx": np.array([3]), "val": np.ones(1),
                               "n": 2})
        with pytest.raises(ValueError, match="malformed"):
            mod.decode_sparse({"idx": np.array([0, 1]), "val": np.ones(1),
                               "n": 2})
    tree = {"z": np.random.RandomState(1).randn(40, 3).astype(np.float32),
            "a": {"step": np.arange(4, dtype=np.int32),
                  "b": np.random.RandomState(2).randn(9).astype(np.float32)}}
    ea, eb = comp.encode_sparse_tree(tree, 0.2), jcomp.encode_sparse_tree(
        tree, 0.2)
    assert len(ea["leaves"]) == len(eb["leaves"]) == 3
    for x, y in zip(ea["leaves"], eb["leaves"]):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    da, db = comp.decode_sparse_tree(ea, tree), jcomp.decode_sparse_tree(
        eb, tree)
    np.testing.assert_array_equal(da["z"], db["z"])
    np.testing.assert_array_equal(da["a"]["step"], db["a"]["step"])
    np.testing.assert_array_equal(da["a"]["b"], db["a"]["b"])
    with pytest.raises(ValueError, match="leaves"):
        comp.decode_sparse_tree({"leaves": ea["leaves"][:2]}, tree)


def _fed_data(n=4, s=12, seed=3):
    rs = np.random.RandomState(seed)
    return {"x": rs.rand(n, s, 8, 8, 1).astype(np.float32),
            "y": rs.randint(0, 10, (n, s)).astype(np.int32),
            "mask": (np.arange(s)[None] < rs.randint(6, s + 1, n)[:, None])
            .astype(np.float32)}


def test_poison_module_bitwise():
    data = _fed_data()
    x = data["x"].reshape(-1, 8, 8, 1)
    y = data["y"].reshape(-1)
    pool = poison.edge_case_pool(x, y, 3, 0.3)
    np.testing.assert_array_equal(pool, jpoison.edge_case_pool(x, y, 3, 0.3))
    for seed in (0, 5):
        got = poison.replace_with_edge_cases(
            data["x"][1], data["y"][1], data["mask"][1], pool, 7, 0.5, seed)
        want = jpoison.replace_with_edge_cases(
            data["x"][1], data["y"][1], data["mask"][1], pool, 7, 0.5, seed)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    for excl in (None, 2):
        got = poison.backdoor_eval_set(x, y, poison.pixel_trigger(2, 0.5), 4,
                                       excl)
        want = jpoison.backdoor_eval_set(x, y, jpoison.pixel_trigger(2, 0.5),
                                         4, excl)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        poison.edge_case_pool(x, y, 99)


@pytest.mark.parametrize("kind,spec", [
    ("label_flipping", {"poisoned_client_ids": [0, 2]}),
    ("label_flipping", {"poisoned_client_ids": [1], "original_class": 3,
                        "target_class": 8}),
    ("backdoor", {"poisoned_client_ids": [2], "target_class": 5}),
    ("edge_case_backdoor", {"poisoned_client_ids": [0, 3],
                            "source_class": 1, "tail_frac": 0.4}),
])
def test_data_poisoning_bitwise(kind, spec):
    data = _fed_data()
    kw = dict(enable_attack=True, attack_type=kind, attack_spec=spec)
    got = sec.FedAttacker(SecurityArgs(**kw), 4).poison_dataset(data, 10)
    want = jsec.FedAttacker(JaxSecurityArgs(**kw), 4).poison_dataset(data, 10)
    for k in ("x", "y", "mask"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    y = data["y"][0]
    np.testing.assert_array_equal(atk.label_flip(y, 10),
                                  jatk.label_flip(y, 10))
    for a, b in zip(atk.backdoor_trigger(data["x"][0], y, 2),
                    jatk.backdoor_trigger(data["x"][0], y, 2)):
        np.testing.assert_array_equal(a, b)
    flat = np.arange(12.0).reshape(3, 4)
    for a, b in zip(atk.backdoor_trigger(flat, y[:3], 1, patch=2),
                    jatk.backdoor_trigger(flat, y[:3], 1, patch=2)):
        np.testing.assert_array_equal(a, b)


FAULT_PLANS = [
    {"client_dropout": 0.3, "client_straggler": 0.2, "seed": 4},
    {"drop": 0.1, "crash": {"1": 3}, "flap": {2: {"up": 2, "down": 1}}},
    {"replica_kill": {0: 1}, "silo_kill": {"2": 0}, "delay_max_s": 0.5},
    {"client_dropout": 1.5},
    {"client_dropout": True},
    {"seed": 1.0},
    {"delay_max_s": -1},
    {"crash": [1, 2]},
    {"crash": {1: -1}},
    {"replica_kill": {0: 0}},
    {"flap": {1: {"up": 0, "down": 1}}},
    {"bogus": 1},
    [0.1],
]


@pytest.mark.parametrize("plan", FAULT_PLANS,
                         ids=[str(p) for p in FAULT_PLANS])
def test_fault_spec_validation_bitwise(plan):
    def parse(cls):
        try:
            return dataclasses.asdict(cls.from_dict(plan)), None
        except ValueError as e:
            return None, str(e)

    assert parse(FaultSpec) == parse(JaxFaultSpec)


def test_fault_spec_from_config():
    from fedml_tpu_torch.config import Config

    assert FaultSpec.from_config(Config()) is None
    cfg = Config.from_dict({"common_args": {"chaos": {"client_dropout": 0.2}}})
    fs = FaultSpec.from_config(cfg)
    assert fs.client_dropout == 0.2 and fs.client_straggler == 0.0
    with pytest.raises(ValueError, match="probability"):
        Config.from_dict({"common_args": {"chaos": {"client_straggler": 2}}})


# ------------------------------------------------------ selection, bitwise
def _jax_lowest(x, k):
    return np.asarray(jax.lax.top_k(-jnp.asarray(x), k)[1])


def _tie_U():
    """Integer-valued updates (every distance exact in f32) with
    duplicated rows: krum's scores and bulyan's distances tie exactly."""
    rs = np.random.RandomState(7)
    base = rs.randint(-3, 4, (4, 40)).astype(np.float32)
    U = np.concatenate([base[[0, 1, 0, 2, 1, 0, 3, 2]],
                        rs.randint(-9, 10, (2, 40)).astype(np.float32)])
    return U, np.ones(10, np.float32)


@pytest.mark.parametrize("case", ["random", "tie"])
@pytest.mark.parametrize("f", [1, 2])
def test_krum_family_selects_jax_indices(case, f):
    U, w = _U() if case == "random" else _tie_U()
    m = U.shape[0]
    js = np.asarray(jdfs.krum_scores(jnp.asarray(U), f))
    ts = dfs.krum_scores(_t(U), f)
    _rel(ts, js, "scores")
    if case == "tie":
        assert len(np.unique(js)) < m, "the constructed case has no tie"
        np.testing.assert_array_equal(ts.numpy(), js)
    assert int(dfs.krum_select(_t(U), f)[0]) == int(np.argmin(js))
    for k in (None, 3):
        kk = k or max(1, m - f)
        np.testing.assert_array_equal(
            dfs.krum_select(_t(U), f, multi=True, k=k).numpy(),
            _jax_lowest(js, kk))
    np.testing.assert_array_equal(dfs.bulyan_select(_t(U), f).numpy(),
                                  _jax_lowest(js, max(1, m - 2 * f)))
    for multi in (False, True):
        _rel(dfs.krum(_t(U), _t(w), f, multi=multi),
             jdfs.krum(jnp.asarray(U), jnp.asarray(w), f, multi=multi),
             f"krum multi={multi}")
    _rel(dfs.bulyan(_t(U), _t(w), f),
         jdfs.bulyan(jnp.asarray(U), jnp.asarray(w), f), "bulyan")


@pytest.mark.parametrize("ratio", [0.05, 0.3, 1.0])
def test_topk_and_soteria_select_jax_indices(ratio):
    rs = np.random.RandomState(2)
    # few distinct magnitudes: ties at the k-th value in every leaf
    t = {"w": rs.randint(-3, 4, (16, 9)).astype(np.float32),
         "b": rs.randint(-2, 3, 11).astype(np.float32)}
    got = comp.topk_compress(_ttree(t), ratio)
    want = jcomp.topk_compress(_jtree(t), ratio)
    for k in t:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    u = t["w"].reshape(-1)
    np.testing.assert_array_equal(
        dfs.soteria_update_transform(_t(u), 1 - ratio).numpy(),
        np.asarray(jdfs.soteria_update_transform(jnp.asarray(u), 1 - ratio)))
    res = {k: rs.randn(*v.shape).astype(np.float32) for k, v in t.items()}
    gs, gr = comp.eftopk_compress(_ttree(t), _ttree(res), ratio)
    ws, wr = jcomp.eftopk_compress(_jtree(t), _jtree(res), ratio)
    for k in t:
        np.testing.assert_array_equal(gs[k].numpy(), np.asarray(ws[k]))
        np.testing.assert_array_equal(gr[k].numpy(), np.asarray(wr[k]))


# ------------------------------------------------- aggregators, 1e-6 relative
@pytest.mark.parametrize("m", [10, 9])
def test_order_statistics_match_jax(m):
    U, w = _U(m)
    Ut, wt, Uj, wj = _t(U), _t(w), jnp.asarray(U), jnp.asarray(w)
    # the even-m median: the two middle values' mean, not the lower one
    np.testing.assert_array_equal(dfs.coordinate_median(Ut, wt).numpy(),
                                  np.asarray(jnp.median(Uj, axis=0)))
    for b in (0, 1, 3, 7):
        _rel(dfs.trimmed_mean(Ut, wt, b), jdfs.trimmed_mean(Uj, wj, b),
             f"trimmed b={b}")


def test_aggregators_match_jax():
    U, w = _U()
    Ut, wt, Uj, wj = _t(U), _t(w), jnp.asarray(U), jnp.asarray(w)
    pairs = {
        "geometric_median": (dfs.geometric_median(Ut, wt, 10),
                             jdfs.geometric_median(Uj, wj, 10)),
        "cclip": (dfs.cclip(Ut, wt, 2.0, 3), jdfs.cclip(Uj, wj, 2.0, 3)),
        "three_sigma": (dfs.three_sigma_weights(Ut, wt),
                        jdfs.three_sigma_weights(Uj, wj)),
        "outlier": (dfs.outlier_detection_weights(Ut, wt),
                    jdfs.outlier_detection_weights(Uj, wj)),
        "robust_lr": (dfs.robust_learning_rate_aggregate(Ut, wt, 0.3),
                      jdfs.robust_learning_rate_aggregate(Uj, wj, 0.3)),
        "residual": (dfs.residual_reweight_aggregate(Ut, wt),
                     jdfs.residual_reweight_aggregate(Uj, wj)),
        "norm_clip": (dfs.clipped_mean(Ut, wt, 10.0),
                      jdfs._wmean(jax.vmap(lambda u: jdfs.norm_clip_update(
                          u, 10.0))(Uj), wj)),
        "foolsgold": (dfs.foolsgold_weights(Ut),
                      jdfs.foolsgold_weights(Uj)),
        "cross_round": (dfs.cross_round_weights(Ut, Ut.flip(0), wt),
                        jdfs.cross_round_weights(Uj, Uj[::-1], wj)),
    }
    for name, (got, want) in pairs.items():
        _rel(got, want, name)
    # an outlier lands outside the 3-sigma and k-NN filters on both sides
    U2 = U.copy()
    U2[3] *= 40.0
    a = dfs.three_sigma_weights(_t(U2), wt).numpy()
    assert a[3] == 0 and a.sum() > 0
    np.testing.assert_array_equal(a, np.asarray(jdfs.three_sigma_weights(
        jnp.asarray(U2), wj)))
    prev0 = np.zeros_like(U)
    np.testing.assert_array_equal(
        dfs.cross_round_weights(Ut, _t(prev0), wt).numpy(), w)


def _ctxs(ids, state_t=None, state_j=None):
    rng = jax.random.key(3)
    return ({"key": (0, 1, keys.SERVER), "ids": torch.as_tensor(ids),
             "state": state_t},
            {"rng": rng, "ids": jnp.asarray(ids), "state": state_j})


DETERMINISTIC_DEFENSES = [
    "krum", "multikrum", "bulyan", "wise_median", "trimmed_mean",
    "geo_median", "rfa", "cclip", "norm_diff_clipping", "diff_clipping",
    "robust_learning_rate", "residual_reweight", "outlier_detection",
    "3sigma", "3sigma_geo", "slsgd", "wbc", "soteria", "foolsgold",
    "3sigma_foolsgold", "cross_round"]


@pytest.mark.parametrize("name", DETERMINISTIC_DEFENSES)
def test_defender_dispatch_matches_jax(name):
    """`FedDefender._aggregate` for every defense without a draw, two
    rounds, with its history for the stateful ones (updated in place
    on the port's side)."""
    spec = {"byzantine_client_num": 2, "tau": 3.0, "norm_bound": 8.0,
            "trim_param_b": 2}
    kw = dict(enable_defense=True, defense_type=name, defense_spec=spec)
    dt = sec.FedDefender(SecurityArgs(**kw), 12)
    dj = jsec.FedDefender(JaxSecurityArgs(**kw), 12)
    st_t, st_j = dt.init_state(300), dj.init_state(300)
    for r in range(2):
        U, w = _U(seed=r)
        ids = np.sort(np.random.RandomState(r).choice(12, 10, replace=False))
        ct, cj = _ctxs(ids, st_t, st_j)
        got, st_t2 = dt._aggregate(_t(U), _t(w), ct, st_t)
        want, st_j = dj._aggregate(jnp.asarray(U), jnp.asarray(w), cj, st_j)
        _rel(got, want, f"{name} round {r}")
        if st_j is not None:
            assert st_t2 is st_t   # in place
            _rel(st_t, st_j, f"{name} state")


def test_server_pipeline_matches_jax():
    """Attack then defense through `build_server_pipeline` on stacked
    trees (lazy worker: its [m, D] state over two rounds) and the
    aggregate post-processing."""
    def pipes(atk_kw, dfs_kw):
        a = dict(enable_attack=True, **atk_kw)
        d = dict(enable_defense=bool(dfs_kw), **dfs_kw)
        out = []
        for mod, S in ((sec, SecurityArgs), (jsec, JaxSecurityArgs)):
            at = mod.FedAttacker(S(**a), 6)
            de = mod.FedDefender(S(**d), 8)
            out.append((mod.build_server_pipeline(at, de), at, de))
        return out

    (pt, at, de), (pj, aj, dj) = pipes(
        {"attack_type": "lazy_worker",
         "attack_spec": {"byzantine_client_num": 2}},
        {"defense_type": "trimmed_mean", "defense_spec": {"beta": 1}})
    params = {"a": np.zeros((5, 4), np.float32), "b": np.zeros(3, np.float32)}
    st_t = sec.init_pipeline_state(at, de, _ttree(params), 6)
    st_j = jsec.init_pipeline_state(aj, dj, _jtree(params), 6)
    for r in range(2):
        rs = np.random.RandomState(10 + r)
        stacked = {"a": rs.randn(6, 5, 4).astype(np.float32),
                   "b": rs.randn(6, 3).astype(np.float32)}
        w = rs.randint(1, 9, 6).astype(np.float32)
        ct, cj = _ctxs(np.arange(6), st_t, st_j)
        got, st_t = pt(_ttree(stacked), _t(w), ct)
        want, st_j = pj(_jtree(stacked), jnp.asarray(w), cj)
        _tree_rel(got, want, f"round {r}")
        _rel(st_t["atk"], st_j["atk"], "lazy state")
    assert pipes({"attack_type": "label_flipping"}, {})[0][0] is None


@pytest.mark.parametrize("mode", ["zero", "flip", "random"])
def test_model_poisoning_matches_jax(mode):
    U, _ = _U(6, 50)
    mal = np.array([1, 0, 1, 0, 0, 1], bool)
    rng = jax.random.key(5)
    want = jatk.byzantine_attack(jnp.asarray(U), jnp.asarray(mal), rng, mode)
    evil = None
    if mode == "random":
        evil = _t(np.asarray(jax.random.normal(rng, U.shape))[mal])
    got = atk.byzantine_attack(_t(U), _t(mal), mode, evil)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _rel(atk.model_replacement_attack(_t(U), _t(mal), 3.0),
         jatk.model_replacement_attack(jnp.asarray(U), jnp.asarray(mal), 3.0))
    prev = U[::-1].copy()
    np.testing.assert_array_equal(
        atk.lazy_worker_attack(_t(U), _t(mal), _t(prev)).numpy(),
        np.asarray(jatk.lazy_worker_attack(jnp.asarray(U), jnp.asarray(mal),
                                           jnp.asarray(prev))))
    with pytest.raises(ValueError, match="attack_mode"):
        atk.byzantine_attack(_t(U), _t(mal), "bogus")


def test_label_inference_matches_jax():
    rs = np.random.RandomState(4)
    g = rs.rand(10, 6).astype(np.float32)
    g[7] -= 2.0
    assert int(atk.reveal_labels_from_gradients(_t(g))) == int(
        jatk.reveal_labels_from_gradients(jnp.asarray(g))) == 7
    grads = {"Dense_0": {"kernel": rs.rand(6, 10).astype(np.float32) - 0.2,
                         "bias": rs.rand(10).astype(np.float32)}}
    grads["Dense_0"]["bias"][4] = -1.0
    assert int(atk._infer_label_from_grads(_ttree(grads), 10)) == int(
        jatk._infer_label_from_grads(_jtree(grads), 10)) == 4
    del grads["Dense_0"]["bias"]
    assert int(atk._infer_label_from_grads(_ttree(grads), 10)) == int(
        jatk._infer_label_from_grads(_jtree(grads), 10))
    assert atk._infer_label_from_grads({"x": torch.ones(3)}, 10) is None


def test_random_defense_apply_halves_match_jax():
    U, w = _U()
    rng = jax.random.key(11)
    z = np.asarray(jax.random.normal(rng, (U.shape[1],)))
    _rel(dfs.weak_dp_aggregate(_t(U), _t(w), _t(z), 1.0, 0.05),
         jdfs.weak_dp_aggregate(jnp.asarray(U), jnp.asarray(w), rng, 1.0,
                                0.05), "weak_dp")
    agg = U[0] * 10.0
    _rel(dfs.crfl_postprocess(_t(agg), _t(z), 15.0, 0.02),
         jdfs.crfl_postprocess(jnp.asarray(agg), rng, 15.0, 0.02), "crfl")
    _rel(dfs.slsgd_postprocess(_t(agg), _t(U[1]), 0.3),
         jdfs.slsgd_postprocess(jnp.asarray(agg), jnp.asarray(U[1]), 0.3))
    u = U[2] * 0.05
    lap = np.asarray(jax.random.laplace(rng, u.shape))
    _rel(dfs.wbc_update_transform(_t(u), _t(lap), 0.5, 0.2),
         jdfs.wbc_update_transform(jnp.asarray(u), rng, 0.5, 0.2), "wbc")


# ------------------------------------------------------------- DP halves
def test_tree_clip_matches_jax():
    t = _tree()
    _rel(tree_norm(_ttree(t)), jtree.tree_norm(_jtree(t)), "norm")
    for c in (0.5, 1e3):
        _tree_rel(tree_clip_by_global_norm(_ttree(t), c),
                  jtree.tree_clip_by_global_norm(_jtree(t), c), f"clip {c}")


@pytest.mark.parametrize("kind", ["gaussian", "laplace"])
def test_noise_apply_matches_jax(kind):
    t = _tree(1)
    rng = jax.random.key(9)
    draw = jax.random.normal if kind == "gaussian" else jax.random.laplace
    z = jax.tree.map(lambda r, x: np.asarray(draw(r, x.shape)),
                     _jax_split(rng, _jtree(t)), _jtree(t))
    add = jmech.add_gaussian_noise if kind == "gaussian" \
        else jmech.add_laplace_noise
    _tree_rel(mech.apply_noise(_ttree(t), _ttree(z), 0.7),
              add(rng, _jtree(t), 0.7), kind)


def _dp_args(**kw):
    base = dict(enable_dp=True, epsilon=0.5, delta=1e-5, sensitivity=1.0,
                clipping_norm=0.8)
    base.update(kw)
    return DPArgs(**base), JaxDPArgs(**base)


@pytest.mark.parametrize("sol,mech_t", [("ldp", "gaussian"),
                                        ("nbafl", "laplace"),
                                        ("dp_clip", "gaussian"),
                                        ("cdp", "gaussian")])
def test_dp_client_transforms_match_jax(sol, mech_t):
    """Each solution's client transform: the clip, then the apply half fed
    JAX's noise; the calibration (sigma, min_local_n, max_weight_frac,
    the accountant) equal."""
    counts = np.array([30, 5, 0, 12, 40, 7, 19], np.float32)
    a, b = _dp_args(dp_solution_type=sol, mechanism_type=mech_t)
    ft = dp.FedDP(a, 4, 7, 50, counts)
    fj = jdp.FedDP(b, 4, 7, 50, counts)
    assert (ft._sigma, ft.min_local_n, ft.max_weight_frac) == \
        (fj._sigma, fj.min_local_n, fj.max_weight_frac)
    assert (ft.accountant is None) == (fj.accountant is None)
    if fj.accountant is not None:
        assert (ft.accountant.z, ft.accountant.q) == \
            (fj.accountant.z, fj.accountant.q)
    t = jax.tree.map(lambda x: 3.0 * x, _tree(2))
    rng = jax.random.key(2)
    want = fj.client_transform()(_jtree(t), rng)
    if sol in ("ldp", "nbafl"):
        draw = jax.random.normal if mech_t == "gaussian" \
            else jax.random.laplace
        z = jax.tree.map(lambda r, x: np.asarray(draw(r, x.shape)),
                         _jax_split(rng, _jtree(t)), _jtree(t))
        clipped = tree_clip_by_global_norm(_ttree(t), a.clipping_norm) \
            if sol == "ldp" else dp._coord_clip(_ttree(t), a.clipping_norm)
        got = mech.apply_noise(clipped, _ttree(z), ft._sigma)
    else:
        got = ft.client_transform()(_ttree(t), (0, 1, 2))
    _tree_rel(got, want, sol)


def test_dp_server_transforms_and_epsilon_match_jax():
    counts = np.array([30, 5, 12, 40], np.float32)
    rng = jax.random.key(4)
    t = _tree(3)
    z = jax.tree.map(lambda r, x: np.asarray(jax.random.normal(r, x.shape)),
                     _jax_split(rng, _jtree(t)), _jtree(t))
    a, b = _dp_args(dp_solution_type="cdp")
    ft, fj = dp.FedDP(a, 2, 4, 10, counts), jdp.FedDP(b, 2, 4, 10, counts)
    want = fj.server_transform()(_jtree(t), rng)
    sigma = (ft._sigma / a.sensitivity) * a.clipping_norm \
        * ft.max_weight_frac
    _tree_rel(mech.apply_noise(_ttree(t), _ttree(z), sigma), want, "cdp")
    for _ in range(3):
        ft.step_round()
        fj.step_round()
    assert ft.get_epsilon() == fj.get_epsilon() > 0
    # NbAFL's down-link noise only when T > sqrt(N) m, over min_local_n
    for T in (3, 400):
        a, b = _dp_args(dp_solution_type="nbafl")
        ft, fj = dp.FedDP(a, 2, 4, T, counts), jdp.FedDP(b, 2, 4, T, counts)
        st, sj = ft.server_transform(), fj.server_transform()
        assert (st is None) == (sj is None)
        assert np.isnan(ft.get_epsilon()) and np.isnan(fj.get_epsilon())
        if sj is not None:
            scale = np.asarray(sj(_jtree(t), rng)["b"]) - t["b"]
            got = st(_ttree(t), (1, 2))["b"].numpy() - t["b"]
            # the same scale: the spread of the draws agrees to sampling
            assert np.std(got) > 0 and np.std(scale) > 0
    assert dp.from_config(_cfg_dp()).enabled
    assert dp.make_upload_dp(_cfg_dp("cdp")) is None
    assert dp.make_upload_dp(_cfg_dp("ldp")) is not None


def _cfg_dp(sol="ldp"):
    from fedml_tpu_torch.config import Config

    return Config.from_dict({"dp_args": {"enable_dp": True,
                                         "dp_solution_type": sol}})


def test_silo_upload_dp_keyed_by_round():
    up = dp.make_upload_dp(_cfg_dp(), seed=3)
    base = {"w": torch.zeros(50)}
    new = {"w": torch.full((50,), 0.01)}
    a, b = up.apply(new, base, 2), up.apply(new, base, 2)
    assert torch.equal(a["w"], b["w"])
    assert up.dp.accountant.steps == 1   # a re-send does not re-step
    c = up.apply(new, base, 3)
    assert not torch.equal(a["w"], c["w"]) and up.dp.accountant.steps == 2
    assert up.epsilon() > 0


# ------------------------------------------------------ compression halves
def test_compression_apply_halves_match_jax():
    t = _tree(4)
    rng = jax.random.key(6)
    kt = _jax_split(rng, _jtree(t))
    idx = jax.tree.map(lambda r, x: np.asarray(jax.random.choice(
        r, x.size, (max(1, int(x.size * 0.3)),), replace=False)), kt,
        _jtree(t))
    np.testing.assert_array_equal(
        comp.randk_apply(_ttree(t), _ttree(idx))["w"].numpy(),
        np.asarray(jcomp.randk_compress(_jtree(t), 0.3, rng)["w"]))
    u = jax.tree.map(lambda r, x: np.asarray(jax.random.uniform(r, x.shape)),
                     kt, _jtree(t))
    _tree_rel(comp.quantize_apply(_ttree(t), 4, _ttree(u)),
              jcomp.quantize_compress(_jtree(t), 4, rng), "quantize")
    _tree_rel(comp.quantize_apply(_ttree(t), 3),
              jcomp.quantize_compress(_jtree(t), 3), "quantize nearest")
    _tree_rel(comp.qsgd_apply(_ttree(t), 4, _ttree(u)),
              jcomp.qsgd_compress(_jtree(t), 4, rng), "qsgd")
    for name in ("topk", "randk", "quantize", "qsgd"):
        f = comp.make_compression_transform(name, 0.2)
        out = f(_ttree(t), (1, 2, 3))
        assert all(out[k].shape == _ttree(t)[k].shape for k in ("w", "b"))
    assert comp.make_compression_transform("none") is None
    with pytest.raises(ValueError, match="per-client residual"):
        comp.make_compression_transform("eftopk")
    with pytest.raises(ValueError, match="unknown compressor"):
        comp.make_compression_transform("zip")


def test_eftopk_wrapper_refuses_structured_updates():
    from fedml_tpu_torch.algorithms.builtin import build_algorithm
    from fedml_tpu_torch.config import TrainArgs

    for name in ("FedNova", "SCAFFOLD", "Mime"):
        alg = build_algorithm(name, lambda p, x: x, TrainArgs(), 4, 2)
        with pytest.raises(ValueError, match="eftopk cannot wrap"):
            comp.wrap_algorithm_with_eftopk(alg, 0.1)


# --------------------------------------------------- the port's own draws
def test_port_noise_statistics_and_keys():
    """The JAX tests' bars on the port's draws (`tests/test_dp.py`,
    `tests/test_compression.py`), each deterministic per key."""
    t = {"w": torch.zeros(20000)}
    g = mech.add_gaussian_noise(keys.generator((0, 1, 2, 3)), t, 2.0)["w"]
    assert abs(float(g.std()) - 2.0) < 0.1 and abs(float(g.mean())) < 0.05
    lap = mech.add_laplace_noise(keys.generator((0, 1, 2, 4)), t, 1.0)["w"]
    # Laplace(b = 1): mean 0, variance 2b^2, E|x| = b
    assert abs(float(lap.abs().mean()) - 1.0) < 0.05
    assert abs(float(lap.var()) - 2.0) < 0.15
    again = mech.add_gaussian_noise(keys.generator((0, 1, 2, 3)), t, 2.0)
    assert torch.equal(g, again["w"])
    other = mech.add_gaussian_noise(keys.generator((0, 1, 2, 5)), t, 2.0)
    assert not torch.equal(g, other["w"])
    ones = {"w": torch.ones(1000)}
    outs = [comp.randk_compress(ones, 0.25, keys.generator((i, 7)))["w"]
            for i in range(30)]
    assert abs(float(torch.stack(outs).mean()) - 1.0) < 0.15
    assert all(int((o != 0).sum()) == 250 for o in outs)
    half = {"w": torch.full((500,), 0.5)}
    outs = [comp.qsgd_compress(half, 4, keys.generator((i, 8)))["w"]
            for i in range(50)]
    assert abs(float(torch.stack(outs).mean()) - 0.5) < 0.05
    q = comp.quantize_compress(_ttree(_tree()), 8, keys.generator((1,)))
    for k in ("w", "b"):
        x = torch.from_numpy(_tree()[k])
        assert float((q[k] - x).abs().max()) <= float(x.abs().max()) / 2**7 \
            + 1e-6
    a = comp.make_compression_transform("randk", 0.1)(ones, (3, 4, 5, 0x9A))
    b = comp.make_compression_transform("randk", 0.1)(ones, (3, 4, 5, 0x9A))
    assert torch.equal(a["w"], b["w"])


# ------------------------------------------------------- health and faults
def test_health_tracker_faults_match_jax():
    ids = np.array([3, 8, 1, 5, 9, 2])
    w = np.array([4, 0, 2, 3, 1, 5], np.float32)   # slot 1 a pad
    rs = np.random.RandomState(0)
    trackers = (HealthTracker(warmup_rounds=1), JaxHealthTracker(
        warmup_rounds=1))
    for r in range(4):
        health = {"update_norm": rs.rand(6) + (5.0 if r == 3 else 0.0)
                  * (np.arange(6) == 2),
                  "cosine": rs.rand(6)}
        faults = {"dropped": (rs.rand(6) < 0.3).astype(np.float32),
                  "straggled": np.zeros(6, np.float32)}
        faults["straggled"][4] = float(r % 2)
        outs = [t.observe_round(r, ids, w, health, duration_s=1.0,
                                faults=faults) for t in trackers]
        assert outs[0] == outs[1]
    assert trackers[0].flag_counts == trackers[1].flag_counts
    assert sum(trackers[0].flag_counts.values()) > 0
