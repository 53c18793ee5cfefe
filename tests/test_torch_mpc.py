"""The port's secure aggregation primitives (`fedml_tpu_torch.mpc`, the
finite-field host library `native/finite_field.cpp`) and the SecAgg flat
vector (`cross_silo.secagg_manager.flatten_params`) against the JAX
package's, on the CPU.

Every comparison is bitwise: both packages run the same numpy operations
in the same order from the same seeds and generator states, and the
native inverse and Lagrange basis are held to Python `pow`.
"""
import jax
import numpy as np
import pytest
import torch

from fedml_tpu import mpc as J
from fedml_tpu.cross_silo.secagg_manager import (
    flatten_params as jax_flatten,
)
from fedml_tpu.models import hub as jax_hub
from fedml_tpu.mpc import finite as JF
from fedml_tpu.mpc import secagg as JS
from fedml_tpu_torch import mpc as P
from fedml_tpu_torch import native
from fedml_tpu_torch.cross_silo.secagg_manager import (
    flatten_params, unflatten_params,
)
from fedml_tpu_torch.models import hub
from fedml_tpu_torch.mpc import finite as PF
from fedml_tpu_torch.mpc import secagg as PS

torch.set_num_threads(2)
p = P.DEFAULT_PRIME


def _eq(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


# ------------------------------------------------------------ native
def test_native_modinv_matches_pow_and_jax():
    rs = np.random.RandomState(0)
    x = np.concatenate([rs.randint(1, p, 200), [1, 2, p - 1, -5, p + 3]])
    want = np.array([pow(int(v) % p, p - 2, p) for v in x], np.int64)
    got = native.modinv_batch(x, p)
    assert _eq(got, want)
    assert _eq(P.modular_inv(x), J.modular_inv(x))
    assert all(int(v) * int(w) % p == 1 for v, w in zip(x % p, got))
    assert P.modular_inv(12345) == J.modular_inv(12345) == pow(12345, p - 2, p)


@pytest.mark.parametrize("points", [[1, 2], [1, 3, 4], [2, 5, 7, 9, 11]])
def test_native_lagrange_at_zero_matches_pow_and_jax(points):
    pts = np.asarray(points, np.int64)
    want = []
    for i in range(len(pts)):
        num = den = 1
        for j in range(len(pts)):
            if i != j:
                num = num * (-int(pts[j]) % p) % p
                den = den * ((int(pts[i]) - int(pts[j])) % p) % p
        want.append(num * pow(den, p - 2, p) % p)
    got = native.lagrange_at_zero(pts, p)
    assert _eq(got, np.asarray(want, np.int64))
    from fedml_tpu import native as jax_native

    assert _eq(got, jax_native.lagrange_at_zero(pts, p))


# ------------------------------------------------------------ finite.py
def test_quantize_dequantize_bitwise():
    x = np.random.RandomState(1).randn(1000) * 3
    for q in (8, 16):
        assert _eq(PF.quantize(x, q), JF.quantize(x, q))
        xq = PF.quantize(x, q)
        assert _eq(PF.dequantize(xq, q), JF.dequantize(xq, q))
    assert np.abs(PF.dequantize(PF.quantize(x)) - x).max() <= 2.0 ** -17


@pytest.mark.parametrize("n,t", [(3, 1), (5, 2), (7, 3)])
def test_shamir_share_and_reconstruct_bitwise(n, t):
    secret = np.random.RandomState(n).randint(0, p, 17)
    ps = PF.shamir_share(secret, n, t, np.random.default_rng(9))
    js = JF.shamir_share(secret, n, t, np.random.default_rng(9))
    assert _eq(ps, js)
    for holders in (list(range(t + 1)), list(range(n - t - 1, n))):
        got = PF.shamir_reconstruct(ps[holders], holders)
        assert _eq(got, JF.shamir_reconstruct(js[holders], holders))
        assert _eq(got, secret.astype(np.int64))


def test_lagrange_coeffs_and_lcc_bitwise():
    a, b = np.arange(1, 6), np.arange(6, 9)
    assert _eq(PF.lagrange_coeffs(a, b), JF.lagrange_coeffs(a, b))
    X = np.random.RandomState(2).randint(0, p, (3, 11)).astype(np.int64)
    enc = PF.lcc_encode(X, a, b)
    assert _eq(enc, JF.lcc_encode(X, a, b))
    dec = PF.lcc_decode(enc[:3], a[:3], b)
    assert _eq(dec, JF.lcc_decode(enc[:3], a[:3], b))
    assert _eq(dec, X)


def test_prg_mask_and_field_packing_bitwise():
    for seed in (0, 7, 2**62 + 5):
        assert _eq(PF.prg_mask(seed, 333), JF.prg_mask(seed, 333))
    v = PF.prg_mask(3, 4096)
    packed = PF.pack_field(v)
    assert _eq(packed, JF.pack_field(v)) and packed.dtype == np.uint32
    assert _eq(PF.unpack_field(packed), JF.unpack_field(packed))
    with pytest.raises(ValueError, match="outside"):
        PF.pack_field(np.asarray([-1, 5], np.int64))
    with pytest.raises(ValueError, match="truncate"):
        PF.pack_field(v, p=2**33)
    with pytest.raises(ValueError, match="uint32 wire form"):
        PF.unpack_field(v)


# ------------------------------------------------------------ secagg.py
def test_derive_round_key_and_premask_bitwise():
    for seed, salt in ((1, 0), (2**61, 7), (5, -3)):
        assert PS.derive_round_key(seed, salt) == JS.derive_round_key(
            seed, salt)
    assert PS.derive_round_key(3, 1, b"x") == JS.derive_round_key(3, 1, b"x")
    x = np.random.RandomState(3).randn(500)
    for ratio in (0.05, 0.5, 1.0):
        assert _eq(PS.premask_sparsify(x, ratio),
                   JS.premask_sparsify(x, ratio))
    with pytest.raises(ValueError, match="ratio"):
        PS.premask_sparsify(x, 0.0)
    with pytest.raises(ValueError, match="non-finite"):
        PS.premask_sparsify(np.array([1.0, np.nan]), 0.5)


def test_encrypt_decrypt_share_bitwise_and_opaque():
    share = np.random.RandomState(4).randint(0, p, 3).astype(np.int64)
    for field in ("b", "sk"):
        c = PS.encrypt_share(share, 123456789, 1, 2, field)
        assert _eq(c, JS.encrypt_share(share, 123456789, 1, 2, field))
        assert not np.array_equal(c, share)
        assert _eq(PS.decrypt_share(c, 123456789, 1, 2, field), share)
    # the two fields' pads differ (no two-time pad)
    assert not np.array_equal(PS.encrypt_share(share, 9, 1, 2, "b"),
                              PS.encrypt_share(share, 9, 1, 2, "sk"))


def _clients(mod, n, t, seed=11):
    return [mod.SecAggClient(i, n, t, seed=seed + i) for i in range(n)]


@pytest.mark.parametrize("n", [3, 5])
def test_secagg_client_keys_shares_and_mask_bitwise(n):
    t = max(1, n // 2)
    pcs, jcs = _clients(PS, n, t), _clients(JS, n, t)
    pks = {i: c.public_key() for i, c in enumerate(pcs)}
    rs = np.random.RandomState(n)
    for pc, jc in zip(pcs, jcs):
        assert (pc.sk, pc.pk, pc.self_seed) == (jc.sk, jc.pk, jc.self_seed)
        assert _eq(pc.share_self_seed(), jc.share_self_seed())
        assert _eq(pc.share_sk(), jc.share_sk())
        x = rs.randn(257) * 0.1
        for salt in (0, 3):
            assert _eq(pc.mask(x, pks, salt), jc.mask(x, pks, salt))
        assert pc.agree(pks[(pc.idx + 1) % n]) == jc.agree(
            pks[(pc.idx + 1) % n])
    with pytest.raises(ValueError, match="field overflow"):
        pcs[0].mask(np.full(4, 1e5), pks)


@pytest.mark.parametrize("drop", [[], [1], [0, 3]])
def test_secagg_server_aggregate_bitwise(drop):
    n, t, D = 5, 2, 300
    vecs = [np.random.RandomState(20 + i).randn(D) * 0.1 for i in range(n)]
    out = {}
    for name, mod in (("port", PS), ("jax", JS)):
        cs = _clients(mod, n, t)
        pks = {i: c.public_key() for i, c in enumerate(cs)}
        shares = {i: c.share_self_seed() for i, c in enumerate(cs)}
        sk_sh = {i: c.share_sk() for i, c in enumerate(cs)}
        alive = [i for i in range(n) if i not in drop]
        masked = {i: cs[i].mask(vecs[i], pks, round_salt=2) for i in alive}
        b = {h: {o: shares[o][h] for o in alive} for h in alive}
        pair = {}
        for j in drop:
            sk = mod.SecAggServer.reconstruct_sk(
                {h: sk_sh[j][h] for h in alive[:t + 1]})
            assert sk == cs[j].sk
            pair[j] = {i: mod.SecAggServer.pairwise_seed(sk, pks[i])
                       for i in alive}
        out[name] = mod.SecAggServer(n, t, D).aggregate(
            masked, b, pair, round_salt=2)
    assert _eq(out["port"], out["jax"])
    want = PF.dequantize(np.sum([PF.quantize(vecs[i]) for i in range(n)
                                 if i not in drop], axis=0) % p)
    assert _eq(out["port"], want)


def test_secagg_roundtrip_bitwise_and_needs_shares():
    vecs = [np.random.RandomState(30 + i).randn(64) for i in range(4)]
    for drop in (None, [2]):
        assert _eq(P.secagg_roundtrip(vecs, drop=drop, seed=3),
                   J.secagg_roundtrip(vecs, drop=drop, seed=3))
    srv = PS.SecAggServer(3, 1, 4)
    with pytest.raises(ValueError, match="not enough shares"):
        srv.aggregate({0: np.zeros(4, np.int64)}, {}, {})


# ------------------------------------------------------------ lightsecagg
@pytest.mark.parametrize("drop", [None, [0], [1, 3]])
def test_lightsecagg_roundtrip_bitwise(drop):
    vecs = [np.random.RandomState(40 + i).randn(50) for i in range(5)]
    got = P.lightsecagg_roundtrip(vecs, K=2, T=1, drop=drop, seed=5)
    assert _eq(got, J.lightsecagg_roundtrip(vecs, K=2, T=1, drop=drop,
                                            seed=5))
    alive = [i for i in range(5) if i not in (drop or [])]
    np.testing.assert_allclose(got, sum(vecs[i] for i in alive), atol=1e-3)


def test_lightsecagg_pieces_and_too_many_dropouts():
    z, sh = P.mask_encoding(10, 4, 2, 1, np.random.default_rng(1))
    jz, jsh = J.mask_encoding(10, 4, 2, 1, np.random.default_rng(1))
    assert _eq(z, jz) and _eq(sh, jsh)
    agg = P.aggregate_encoded_masks([sh[0], sh[1]])
    assert _eq(agg, J.aggregate_encoded_masks([jsh[0], jsh[1]]))
    dec = P.decode_aggregate_mask({j: sh[j] for j in (0, 2, 3)}, 4, 2, 1, 10)
    assert _eq(dec, J.decode_aggregate_mask({j: jsh[j] for j in (0, 2, 3)},
                                            4, 2, 1, 10))
    assert _eq(dec, z)
    vecs = [np.ones(8)] * 4
    for mod in (P, J):
        with pytest.raises(ValueError, match="too many dropouts"):
            mod.lightsecagg_roundtrip(vecs, K=2, T=1, drop=[0, 1])
    with pytest.raises(ValueError, match="need 3 surviving shares"):
        P.decode_aggregate_mask({0: sh[0]}, 4, 2, 1, 10)


def test_mpc_exports_match_jax():
    import fedml_tpu.mpc as jm

    assert sorted(P.__all__) == sorted(jm.__all__)


# ------------------------------------------------------------ flat vector
@pytest.mark.parametrize("name,k,shape", [
    ("lr", 3, (8,)), ("cnn", 4, (8, 8, 1)), ("resnet18_gn", 10, (32, 32, 3))])
def test_flatten_params_bitwise_jax(name, k, shape):
    """flax's leaf order (nested keys sorted as strings: ResNetBlock_10
    before ResNetBlock_2) and HWIO conv kernels, from the port's flat OIHW
    dict; unflatten_params gives the dict back bitwise."""
    model = jax_hub.create(name, k)
    fp = jax.tree.map(np.asarray, jax_hub.init_params(
        model, shape, jax.random.key(0)))
    flat = {n: v.numpy() for n, v in
            hub.params_from_flax(fp, device="cpu").items()}
    vec = flatten_params(flat)
    assert _eq(vec, jax_flatten(fp))
    back = unflatten_params(flat, vec)
    assert list(back) == list(flat)
    assert all(_eq(back[n], flat[n]) for n in flat)
