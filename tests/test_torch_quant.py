"""The port's int8 LoRA base (`fedml_tpu_torch.llm.quant`) against the JAX
package's `fedml_tpu/llm/quant.py`.

Shapes are tests/test_fedllm_scale.py's in-scan case (vocab 128,
d_model 64, 3 layers, 4 heads, d_ff 256, T 16): every kernel holds at
least 4096 elements a layer, so the JAX size rule, which counts a
scan-stacked leaf's L layers, and the port's, which reads one layer a
tensor, quantise the same weights.

Bars: `quantize_tree_int8`'s q and s bitwise JAX's for the unrolled and
the scan-stacked base (the stacked s [L, 1, dout] split per layer), the
bf16 passthrough leaves bitwise, dequantisation bitwise in f32 and bf16,
`quant_bytes` equal, `synth_quantized_base` of the same shapes equal in
shape, dtype and scale; `make_inscan_quant_apply` in f32 within rtol
1e-4 and 1e-4 of the largest logit of JAX's in-scan forward, with and
without adapters (both sum the same f32 products in another order; with
the large adapters, 0.3 std plus 0.1, 3 layers carry that to 5.8e-5 of
the largest logit, against JAX's own 5e-4 / 5e-3 between its module and
in-scan forwards, tests/test_fedllm_scale.py:285-286), and its adapter
gradients at moderate adapters within 2e-4 relative, floored at 2e-4 of
the largest gradient;
`lora_apply_fn_quant`'s 12 training steps (tests/test_fedllm_scale.py:
75-142) within 2e-2 of JAX's losses (both
compute in bf16, the frameworks round bf16 products at other points)
and falling as there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.llm import quant as jq
from fedml_tpu.llm.lora import lora_init as jax_lora_init
from fedml_tpu.llm.transformer import TransformerLM as FlaxLM
from fedml_tpu_torch.llm import quant
from fedml_tpu_torch.llm.lora import adapters_from_jax, count_params
from fedml_tpu_torch.llm.transformer import (
    ModelDims, TransformerLM, params_from_flax,
)

torch.set_num_threads(2)

V, D, L, H, FF, T = 128, 64, 3, 4, 256, 16
DIMS = ModelDims(V, D, L, H, FF)


def _flax(**kw):
    return FlaxLM(vocab_size=V, d_model=D, n_layers=L, n_heads=H, d_ff=FF,
                  **kw)


@pytest.fixture(scope="module")
def bases():
    """{layout: (flax params, JAX int8 tree, port state)} for the unrolled
    and the stacked layout of one init."""
    out = {}
    for name, scan in (("unrolled", False), ("stacked", True)):
        p = _flax(scan_layers=scan).init(
            jax.random.key(0), jnp.zeros((1, T), jnp.int32))["params"]
        out[name] = (p, jq.quantize_tree_int8(p),
                     params_from_flax(p, device="cpu"))
    return out


def _carried(qtree):
    """The JAX int8 tree in the port's layout (bf16 passthrough kept)."""
    return params_from_flax(jax.tree.map(np.asarray, qtree),
                            dtype=torch.bfloat16, device="cpu")


def _assert_state_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        x, y = a[k], b[k]
        if quant.is_q(x):
            assert quant.is_q(y), k
            assert torch.equal(x["q"], y["q"]) and x["q"].dtype == torch.int8
            assert torch.equal(x["s"], y["s"]) and x["s"].shape == y["s"].shape
        else:
            assert x.dtype == y.dtype and torch.equal(x, y), k


@pytest.mark.parametrize("layout", ["unrolled", "stacked"])
def test_quantize_bitwise_jax(bases, layout):
    _p, qtree, state = bases[layout]
    mine = quant.quantize_tree_int8(state)
    _assert_state_equal(mine, _carried(qtree))
    assert mine["blocks.1.wq.kernel"]["s"].shape == (1, D)
    assert mine["blocks.1.RMSNorm_0.scale"].dtype == torch.bfloat16
    assert sum(quant.is_q(v) for v in mine.values()) == 2 + 7 * L


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_dequantize_bitwise_jax(bases, dt):
    _p, qtree, state = bases["stacked"]
    mine = quant.dequantize_tree(quant.quantize_tree_int8(state),
                                 getattr(torch, dt))
    want = params_from_flax(jax.tree.map(np.asarray, jq.dequantize_tree(
        qtree, jnp.dtype(dt))), dtype=getattr(torch, dt), device="cpu")
    _assert_state_equal(mine, want)


def test_quant_bytes_and_synth_base(bases):
    for layout in ("unrolled", "stacked"):
        _p, qtree, state = bases[layout]
        assert quant.quant_bytes(quant.quantize_tree_int8(state)) == \
            jq.quant_bytes(qtree)
    p, _q, state = bases["stacked"]
    shapes = jax.eval_shape(lambda: p)
    theirs = _carried(jq.synth_quantized_base(jax.random.key(3), shapes))
    mine = quant.synth_quantized_base(
        {k: v.shape for k, v in state.items()},
        torch.Generator().manual_seed(3), device="cpu")
    assert mine.keys() == theirs.keys()
    for k, v in mine.items():
        w = theirs[k]
        if quant.is_q(v):
            assert v["q"].shape == w["q"].shape and v["q"].dtype == torch.int8
            assert v["q"].min() >= -127 and v["q"].max() <= 127
            assert torch.equal(v["s"], w["s"]), k
        else:
            assert v.shape == w.shape and v.dtype == w.dtype == torch.bfloat16
    assert quant.quant_bytes(mine) == quant.quant_bytes(theirs)


def _adapters(params, a_std=0.3, shift=0.1):
    ads = jax_lora_init(jax.random.key(1), params, rank=4, a_std=a_std)
    return jax.tree.map(lambda a: np.asarray(a + shift * jnp.ones_like(a)),
                        ads)


@pytest.mark.parametrize("with_adapters", [False, True])
def test_inscan_apply_matches_jax(bases, with_adapters):
    """Logits in f32 and, with adapters, their gradients."""
    p, qtree, state = bases["stacked"]
    qstate = quant.quantize_tree_int8(state)
    ads = _adapters(p) if with_adapters else None
    x = np.random.RandomState(0).randint(0, V, (2, T))
    w = np.random.RandomState(1).randn(2, T, V).astype(np.float32)
    j_apply = jq.make_inscan_quant_apply(H, dtype=jnp.float32)
    want = np.asarray(j_apply(qtree, ads, jnp.asarray(x)))
    apply = quant.make_inscan_quant_apply(H, dtype=torch.float32)
    t_ads = adapters_from_jax(ads, device="cpu") if ads else None
    got = apply(qstate, t_ads, torch.from_numpy(x))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4 * scale)
    if not with_adapters:
        return
    # the gradients on moderate adapters (0.1 N(0, 1), both factors, as
    # test_torch_fedllm.py's): the large ones above saturate softmax rows
    # and put gradients near 4e3, where f32 reordering reads 7e-4
    rs = np.random.RandomState(5)
    ads = {k: {n: 0.1 * rs.randn(*v.shape).astype(np.float32)
               for n, v in ab.items()} for k, ab in ads.items()}
    t_ads = adapters_from_jax(ads, device="cpu")
    g_j = jax.grad(lambda a: (j_apply(qtree, a, jnp.asarray(x))
                              * w).sum())(ads)
    model = quant.inscan_model(qstate, H)

    def loss(a):
        return (apply(model, a, torch.from_numpy(x)) * torch.from_numpy(w)
                ).sum()

    g_t = torch.func.grad(loss)(t_ads)
    want_g = adapters_from_jax(jax.tree.map(np.asarray, g_j), device="cpu")
    # the large adapters saturate some softmax rows, so a leaf's gradient
    # may be rounding noise (~1e-8): the floor is the largest gradient's
    top = max(float(ab[n].abs().max()) for ab in want_g.values()
              for n in ("a", "b"))
    for k, ab in want_g.items():
        for n in ("a", "b"):
            np.testing.assert_allclose(
                g_t[k][n].numpy(), ab[n].numpy(), rtol=2e-4,
                atol=2e-4 * top, err_msg=f"{k}/{n}")


def test_lora_apply_fn_quant_trains_as_jax():
    """tests/test_fedllm_scale.py:75-142 on both sides: the dequantisation
    error bound, the storage bound, and 12 SGD steps (lr 0.5) of LoRA
    through the int8 base, from the same adapters and batch."""
    qV, qD, qFF = 512, 64, 256
    model_j = FlaxLM(vocab_size=qV, d_model=qD, n_layers=2, n_heads=H,
                     d_ff=qFF)
    base = model_j.init(jax.random.key(0),
                        jnp.zeros((1, T), jnp.int32))["params"]
    qbase = jq.quantize_tree_int8(base)
    state = params_from_flax(base, device="cpu")
    qstate = quant.quantize_tree_int8(state)
    # dequant error per quantised leaf <= half a step, as the JAX test
    deq = quant.dequantize_tree(qstate, torch.float32)
    for k, v in state.items():
        if quant.is_q(qstate[k]):
            step = v.abs().amax(0, keepdim=True) / 127.0
            assert ((v - deq[k]).abs() <= step * 0.51 + 1e-8).all(), k
    assert quant.quant_bytes(qstate) < 0.45 * 4 * count_params(state)

    rs = np.random.RandomState(0)
    seqs = (rs.randint(1, qV, (8, 1)) + np.arange(T + 1)) % qV
    x, y = seqs[:, :-1], seqs[:, 1:]
    ads_j = jax_lora_init(jax.random.key(1), base, rank=4)
    apply_j = jq.lora_apply_fn_quant(model_j.apply, qbase)

    @jax.jit
    def step_j(ad):
        def loss_fn(a):
            lp = jax.nn.log_softmax(apply_j({"params": a}, jnp.asarray(x))
                                    .astype(jnp.float32), -1)
            return -jnp.take_along_axis(lp, jnp.asarray(y)[..., None],
                                        -1).mean()

        loss, g = jax.value_and_grad(loss_fn)(ad)
        return jax.tree.map(lambda p_, g_: p_ - 0.5 * g_, ad, g), loss

    qmodel = TransformerLM.from_state(DIMS.__class__(qV, qD, 2, H, qFF),
                                      qstate)
    assert qmodel.dtype == torch.bfloat16
    apply_t = quant.lora_apply_fn_quant(qmodel)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)

    def loss_t(a):
        lp = torch.log_softmax(apply_t(a, xt).float(), -1)
        return -lp.gather(-1, yt[..., None]).mean()

    grad_t = torch.func.grad_and_value(loss_t)
    ad_t = adapters_from_jax(jax.tree.map(np.asarray, ads_j), device="cpu")
    lj, lt = [], []
    ad = ads_j
    for _ in range(12):
        ad, loss = step_j(ad)
        lj.append(float(loss))
        g, loss = grad_t(ad_t)
        ad_t = {k: {n: v - 0.5 * g[k][n] for n, v in ab.items()}
                for k, ab in ad_t.items()}
        lt.append(float(loss))
    np.testing.assert_allclose(lt, lj, rtol=2e-2)
    assert lt[-1] < lt[0] - 0.1, lt
