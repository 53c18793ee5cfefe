"""The port's model and paged decode path held against the JAX package.

- `params_from_flax` + `TransformerLM`: logits against flax
  `TransformerLM.apply`, unrolled and scan-stacked layouts, atol 1e-4;
- `init_params`: the flax initialisers' scale;
- `_kv_quant_write`: the int8 pool BITWISE equal to JAX's and the scales
  within 1e-7 relative, over a freshly begun page, duplicate page indices
  within one write, a growing scale and a page reused from offset 0;
- `make_paged_kv_decode`: chunked prefill then verify (C = 2) and step
  logits against JAX's, gather and kernel paths, f32 and int8 KV, atol
  1e-4 (on the CPU the kernel path runs the plain version of the kernel;
  JAX runs its Pallas kernel in interpret mode).
All inputs are drawn with numpy from fixed seeds and handed to both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.llm.decode import _kv_quant_write as jax_kv_quant_write
from fedml_tpu.llm.decode import make_paged_kv_decode as jax_make_paged
from fedml_tpu.llm.transformer import TransformerLM as FlaxLM
from fedml_tpu_torch.llm.decode import (
    _kv_quant_write, make_paged_kv_decode, new_paged_cache,
)
from fedml_tpu_torch.llm.transformer import (
    ModelDims, TransformerLM, init_params, params_from_flax,
)

torch.set_num_threads(2)

V, D, L, H, FF = 96, 64, 2, 4, 128
DIMS = ModelDims(V, D, L, H, FF)
PS, P, MAX_PAGES = 4, 20, 6


def _flax(scan: bool):
    m = FlaxLM(vocab_size=V, d_model=D, n_layers=L, n_heads=H, d_ff=FF,
               scan_layers=scan)
    p = jax.jit(m.init)(jax.random.key(0),
                        jnp.zeros((1, 10), jnp.int32))["params"]
    return m, jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def flax_scan():
    return _flax(True)


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "scan"])
def test_params_from_flax_logits(scan, flax_scan):
    fm, params = flax_scan if scan else _flax(False)
    toks = np.random.default_rng(0).integers(0, V, (2, 12))
    want = np.asarray(jax.jit(fm.apply)({"params": params},
                                        jnp.asarray(toks)))
    model = TransformerLM.from_state(DIMS, params_from_flax(params,
                                                            device="cpu"))
    got = model(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_init_params_flax_scale():
    """Dense kernels: std 1/sqrt(fan_in), truncated at 2 pre-truncation
    standard deviations; embedding: std 1/sqrt(d_model), not truncated;
    norm scales one — the statistics of flax's own init."""
    dims = ModelDims(512, 256, 1, 4, 512)
    fm = FlaxLM(vocab_size=512, d_model=256, n_layers=1, n_heads=4, d_ff=512)
    fp = jax.jit(fm.init)(jax.random.key(0),
                          jnp.zeros((1, 4), jnp.int32))["params"]
    st = init_params(dims, seed=0, device="cpu")
    pairs = [("embed.embedding", fp["embed"]["embedding"]),
             ("blocks.0.wq.kernel", fp["block_0"]["wq"]["kernel"]),
             ("blocks.0.w_down.kernel", fp["block_0"]["w_down"]["kernel"]),
             ("lm_head.kernel", fp["lm_head"]["kernel"])]
    for name, ref in pairs:
        ref = np.asarray(ref)
        got = st[name].numpy()
        assert got.shape == ref.shape, name
        assert abs(got.std() / ref.std() - 1) < 0.03, name
        assert abs(np.abs(got).max() / np.abs(ref).max() - 1) < 0.2, name
    assert torch.equal(st["blocks.0.RMSNorm_1.scale"], torch.ones(256))
    again = init_params(dims, seed=0, device="cpu")["blocks.0.wq.kernel"]
    assert torch.equal(again, st["blocks.0.wq.kernel"])
    other = init_params(dims, seed=1, device="cpu")["blocks.0.wq.kernel"]
    assert not torch.equal(other, st["blocks.0.wq.kernel"])


def test_kv_quant_write_bitwise():
    rng = np.random.default_rng(3)
    hd = (H, D // H)
    pool_j = jnp.zeros((P,) + (PS,) + hd, jnp.int8)
    scales_j = jnp.zeros((P, H), jnp.float32)
    pool_t = torch.zeros((P, PS) + hd, dtype=torch.int8)
    scales_t = torch.zeros((P, H), dtype=torch.float32)
    # stale tenant on page 9 (it must be reset when the page is begun)
    writes = [
        (np.array([9, 9]), np.array([0, 1]), 30.0),
        # a fresh page begun at offset 0, three rows: duplicate indices
        (np.array([3, 3, 3]), np.array([0, 1, 2]), 1.0),
        # a larger row grows page 3's scale: resident rows requantize
        (np.array([3]), np.array([3]), 4.0),
        # 2-D [S, C] indices as verify passes them; page 9 reused from 0
        (np.array([[5, 5], [9, 9]]), np.array([[2, 3], [0, 1]]), 0.5),
        # the same rows again with a smaller value: scale factor 1.0
        (np.array([[5, 5], [0, 0]]), np.array([[2, 3], [1, 1]]), 0.1),
    ]
    jax_write = jax.jit(jax_kv_quant_write)
    for wpage, woff, mag in writes:
        vals = (mag * rng.standard_normal(wpage.shape + hd)).astype(np.float32)
        pool_j, scales_j = jax_write(
            pool_j, scales_j, jnp.asarray(wpage, jnp.int32),
            jnp.asarray(woff, jnp.int32), jnp.asarray(vals))
        _kv_quant_write(pool_t, scales_t, torch.from_numpy(wpage),
                        torch.from_numpy(woff), torch.from_numpy(vals))
        np.testing.assert_array_equal(pool_t.numpy(), np.asarray(pool_j))
        np.testing.assert_allclose(scales_t.numpy(), np.asarray(scales_j),
                                   rtol=1e-7, atol=0)


@pytest.mark.parametrize("quant", [False, True], ids=["f32kv", "int8kv"])
@pytest.mark.parametrize("kernel", [False, True], ids=["gather", "kernel"])
def test_paged_decode_matches_jax(flax_scan, kernel, quant):
    _fm, params = flax_scan
    model = TransformerLM.from_state(DIMS, params_from_flax(params,
                                                            device="cpu"))
    jc, js, jv, _ = (jax.jit(f) for f in jax_make_paged(
        H, PS, kernel=kernel, quant=quant))
    tc, ts, tv, _ = make_paged_kv_decode(H, PS, kernel=kernel, quant=quant)
    dt = jnp.int8 if quant else jnp.float32
    z = (L, P, PS, H, D // H)
    jcache = {"k": jnp.zeros(z, dt), "v": jnp.zeros(z, dt)}
    if quant:
        jcache["ks"] = jnp.zeros((L, P, H))
        jcache["vs"] = jnp.zeros((L, P, H))
    tcache = new_paged_cache(L, P, PS, H, D // H, torch.float32, "cpu",
                             quant)
    rng = np.random.default_rng(1)
    rows = np.zeros((3, MAX_PAGES), np.int32)     # 0 past each reservation
    rows[0, :4], rows[1, :3], rows[2, :5] = [3, 7, 1, 9], [2, 5, 11], \
        [4, 6, 8, 10, 12]
    plens = [9, 6, 13]
    for s, plen in enumerate(plens):
        prompt = rng.integers(1, V, plen)
        for t0 in range(0, plen, 4):              # chunks of 4, right-padded
            cl = min(4, plen - t0)
            buf = np.zeros((1, 4), np.int32)
            buf[0, :cl] = prompt[t0:t0 + cl]
            jcache, want = jc(params, None, jcache, jnp.asarray(rows[s]),
                              jnp.asarray(buf), t0, cl)
            got = tc(model, tcache, torch.from_numpy(rows[s]),
                     torch.from_numpy(buf).long(), t0, cl)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-4, rtol=0)
    pos = np.array(plens, np.int32)
    act = np.array([True, False, True])      # slot 1's writes -> null page
    for c in (2, 2, 1, 1):
        tok = rng.integers(1, V, (3, c)).astype(np.int32)
        args_t = (torch.from_numpy(rows), torch.from_numpy(pos))
        if c == 1:
            jcache, want = js(params, None, jcache, jnp.asarray(rows),
                               jnp.asarray(pos), jnp.asarray(tok[:, 0]),
                               jnp.asarray(act))
            got = ts(model, tcache, *args_t, torch.from_numpy(tok[:, 0]).long(),
                     torch.from_numpy(act))
        else:
            jcache, want = jv(params, None, jcache, jnp.asarray(rows),
                              jnp.asarray(pos), jnp.asarray(tok),
                              jnp.asarray(act))
            got = tv(model, tcache, *args_t, torch.from_numpy(tok).long(),
                     torch.from_numpy(act))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)
        pos = (pos + c * act).astype(np.int32)
    if quant:
        # the whole int8 pool, null page included, written identically
        np.testing.assert_array_equal(tcache["k"][:, 1:].numpy(),
                                      np.asarray(jcache["k"])[:, 1:])
