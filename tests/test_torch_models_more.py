"""The port's model families beyond the FedAvg path (`fedml_tpu_torch.
models`: CharRNN, UNetLite, MobileNet v1 / v3-small, EfficientNet-lite,
VGG, the DARTS supernet, and `transformer_lm` through the hub) against the
flax models of the JAX package, on the CPU.

Each model is built from the flax parameters (`params_from_flax`) and
held to flax's f32 logits within 1e-5 of their largest magnitude, and to
one local SGD step (both packages' `local_sgd`, the same batch) within
1e-3 of the step's largest parameter update (the repo's rule for
rounds). The CV models run at width 0.25 on 32x32 (EfficientNet also at
depth 0.25, one block a stage), VGG at a quarter of vgg11's channels. bf16 logits (through `mixed_precision_apply`) are held within
2e-2 of the largest on the shallow models; the mobilenets and
EfficientNet chain 20-60 bf16 roundings whose order differs between
XLA's fused elementwise code and PyTorch's ops (read up to 8.9e-2 at
width 0.25), so they are held in f32 only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fedml_tpu.core import algorithm as jalg
from fedml_tpu.models import darts as jax_darts
from fedml_tpu.models import hub as jax_hub

from fedml_tpu_torch.core import algorithm as alg
from fedml_tpu_torch.models import darts, hub, seg

torch.set_num_threads(2)

FWD_TOL, BF16_TOL, ROUND_TOL = 1e-5, 2e-2, 1e-3
VGG_QUARTER = {"stages": ((16,), (32,), (64, 64), (128, 128), (128, 128)),
               "dense": 128}
# name -> (hub name, classes, input shape, kwargs, task, bf16 held)
MODELS = {
    "rnn": ("rnn", 30, (16,), {"hidden": 32}, "nwp", True),
    "unet": ("unet", 5, (16, 16, 3), {}, "segmentation", True),
    "mobilenet": ("mobilenet", 10, (32, 32, 3), {"width": 0.25},
                  "classification", False),
    "mobilenet_v3": ("mobilenet_v3", 10, (32, 32, 3), {"width": 0.25},
                     "classification", False),
    "efficientnet": ("efficientnet", 10, (32, 32, 3),
                     {"width": 0.25, "depth": 0.25}, "classification",
                     False),
    "vgg11": ("vgg11", 10, (32, 32, 3), VGG_QUARTER, "classification", True),
    "darts": ("darts", 10, (16, 16, 3), {}, "classification", True),
    "transformer_lm": ("transformer_lm", 40, (12,),
                       {"d_model": 32, "n_layers": 2, "n_heads": 4,
                        "d_ff": 64}, "nwp", True),
}


def _batch(name, n=4, seed=0):
    _h, classes, shape, _kw, task, _b = MODELS[name]
    rs = np.random.RandomState(seed)
    if task == "nwp":
        x = rs.randint(0, classes, (n,) + shape)
        y = rs.randint(0, classes, (n,) + shape)
    else:
        x = rs.randn(n, *shape).astype(np.float32)
        y = rs.randint(0, classes, (n,) + (shape[:2] if task ==
                                            "segmentation" else ()))
    mask = np.ones(n, np.float32)
    mask[-1] = 0.0
    return x, y.astype(np.int64), mask


@pytest.fixture(scope="module", params=list(MODELS))
def jax_run(request):
    """One jitted JAX call a model: its flax init, the f32 (and, where
    held, bf16) logits and one local SGD step over the batch."""
    name = request.param
    hname, classes, shape, kw, task, bf16_held = MODELS[name]
    mj = jax_hub.create(hname, classes, **kw)
    x, y, mask = _batch(name)
    obj = jalg.make_objective(task)
    opt = optax.sgd(0.1)
    shard = {"x": jnp.asarray(x), "y": jnp.asarray(y),
             "mask": jnp.asarray(mask)}

    @jax.jit
    def run(key):
        p = jax_hub.init_params(mj, shape, key)
        f32 = mj.apply({"params": p}, x)
        bf16 = (jax_hub.mixed_precision_apply(mj.apply, "bfloat16")(
            {"params": p}, x) if bf16_held else None)
        stepped = jalg.local_sgd(mj.apply, p, shard,
                                 jnp.arange(x.shape[0])[None], opt,
                                 objective=obj)[0]
        return p, f32, bf16, stepped

    out = jax.tree.map(np.asarray, run(jax.random.key(1)))
    return name, out


def test_model_matches_flax(jax_run):
    """Parameter names and shapes, f32 (and, where held, bf16) logits,
    and one local SGD step against flax."""
    name, (pj, f32, bf16, stepped) = jax_run
    hname, classes, shape, kw, task, bf16_held = MODELS[name]
    module = hub.create(hname, classes, shape, device="cpu", **kw)
    params = hub.params_from_flax(pj, device="cpu")
    assert {k: tuple(v.shape) for k, v in module.named_parameters()} == \
        {k: tuple(v.shape) for k, v in params.items()}
    x, y, mask = _batch(name)
    xt = torch.from_numpy(x)
    for dt, want, tol in (("float32", f32, FWD_TOL),
                          ("bfloat16", bf16, BF16_TOL)):
        if dt == "bfloat16" and not bf16_held:
            continue
        got = hub.apply_fn(module, dt)(params, xt)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=tol * np.abs(want).max(),
                                   err_msg=dt)
    opt = alg.make_client_optimizer("sgd", 0.1)
    shard = {"x": xt, "y": torch.from_numpy(y),
             "mask": torch.from_numpy(mask)}
    got = alg.local_sgd(hub.apply_fn(module), params, shard,
                        torch.arange(x.shape[0])[None], opt,
                        objective=alg.make_objective(task))[0]
    want = hub.params_from_flax(stepped, device="cpu")
    update = max(float((want[k] - params[k]).abs().max()) for k in want)
    assert update > 0
    for k, v in want.items():
        err = float((got[k] - v).abs().max())
        assert err <= ROUND_TOL * update, (k, err, update)


@pytest.mark.parametrize("hw,size", [((4, 4), (8, 8)), ((3, 5), (6, 10)),
                                     ((8, 2), (16, 4))])
def test_bilinear_upsample_matches_jax_resize(hw, size):
    """UNetLite's 2x upsample: `F.interpolate(bilinear, align_corners=
    False)` equals `jax.image.resize(..., "bilinear")` (half-pixel
    centres; at the borders both weigh the edge pixel fully)."""
    x = np.random.RandomState(2).randn(2, 3, *hw).astype(np.float32)
    want = np.asarray(jax.image.resize(
        x.transpose(0, 2, 3, 1), (2,) + size + (3,), "bilinear"))
    got = seg.upsample_bilinear(torch.from_numpy(x), size).numpy()
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, rtol=0,
                               atol=1e-6)


def test_unet_refuses_undivisible_input():
    m = hub.create("unet", 3, (12, 12, 3), device="cpu")
    p = hub.init_params(m, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="divisible by 4"):
        hub.apply_fn(m)(p, torch.zeros(1, 10, 12, 3))


def test_hub_builds_every_family_and_refuses_gan():
    """Each registered name builds on the meta device with flax's
    parameter names and shapes (vgg16 at full width: its structure only);
    `gan` builds FedGAN's generator / discriminator pair the same way."""
    cases = {**{k: v[:4] for k, v in MODELS.items()},
             "vgg16": ("vgg16", 10, (32, 32, 3), {}),
             "efficientnet_d": ("efficientnet", 7, (32, 32, 3),
                                {"width": 0.5, "depth": 0.5})}
    for name, (hname, classes, shape, kw) in cases.items():
        m = hub.create(hname, classes, shape, device="meta", **kw)
        flax = jax.eval_shape(lambda: jax_hub.init_params(
            jax_hub.create(hname, classes, **kw), shape, jax.random.key(0)))
        want = {k: tuple(v.shape) for k, v in hub.params_from_flax(
            jax.tree.map(lambda s: np.zeros(s.shape, np.float32), flax),
            device="cpu").items()}
        assert {k: tuple(v.shape) for k, v in m.named_parameters()} == \
            want, name
    from fedml_tpu.algorithms.fedgan import init_gan_params

    pair = hub.create("gan", 10, (28, 28, 1), device="meta")
    flax = jax.eval_shape(lambda: init_gan_params(
        jax_hub.create("gan", 10), (28, 28, 1), jax.random.key(0)))
    for part, net in (("g", "generator"), ("d", "discriminator")):
        want = {k: tuple(v.shape) for k, v in hub.params_from_flax(
            jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                         flax[part]), device="cpu").items()}
        assert {k: tuple(v.shape) for k, v in
                pair[net].named_parameters()} == want, net
    with pytest.raises(TypeError):          # as the JAX factory's
        hub.create("vgg16", 10, (32, 32, 3), device="meta",
                   stages=((8,),))


def test_init_params_follow_flax_initialisers():
    """CharRNN's parameters as flax draws them: a nonzero embedding of
    std 1/sqrt(features), orthogonal recurrent kernels, lecun-normal input
    kernels, zero biases; DARTS's alphas zero (a uniform mixture)."""
    m = hub.create("rnn", 81, (80,), device="cpu")
    p = hub.init_params(m, torch.Generator().manual_seed(3))
    emb = p["Embed_0.embedding"]
    assert float(emb.std()) == pytest.approx(8 ** -0.5, rel=0.15)
    eye = torch.eye(256)
    for layer in (0, 1):
        for g in "ifgo":
            k = p[f"OptimizedLSTMCell_{layer}.h{g}.kernel"]
            torch.testing.assert_close(k.T @ k, eye, atol=1e-5, rtol=0)
            assert not p[f"OptimizedLSTMCell_{layer}.h{g}.bias"].any()
            ki = p[f"OptimizedLSTMCell_{layer}.i{g}.kernel"]
            fan_in = ki.shape[0]
            assert float(ki.std()) == pytest.approx(fan_in ** -0.5,
                                                    rel=0.15)
    assert sum(v.numel() for v in p.values()) == 818137
    d = hub.create("darts", 10, (16, 16, 3), device="cpu")
    pd = hub.init_params(d, torch.Generator().manual_seed(0))
    assert not any(v.any() for k, v in pd.items() if k.endswith("alpha"))


def test_darts_alphas_and_discretize_match_jax():
    mj = jax_hub.create("darts", 10, channels=(8, 16), cells_per_stage=2)
    pj = jax.tree.map(np.asarray, jax.jit(lambda k: jax_hub.init_params(
        mj, (8, 8, 3), k))(jax.random.key(0)))
    rs = np.random.RandomState(4)
    for cell in pj:
        if cell.startswith("MixedOp"):
            pj[cell]["alpha"] = rs.randn(4).astype(np.float32)
    pt = hub.params_from_flax(pj, device="cpu")
    want = jax_darts.extract_alphas(pj)
    got = darts.extract_alphas(pt)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6)
    assert darts.discretize(pt) == jax_darts.discretize(pj)
