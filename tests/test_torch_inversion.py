"""The port's gradient-inversion attacks (`security.attacks.dlg_attack`,
`invert_gradient_attack`) against the JAX package's, on the CPU, on the
`TinyImg` model of `tests/test_invert_edge_attacks.py` (one dense layer
over a 6x6x1 image, 4 classes; the port's `lr` model with the flax
parameters).

From JAX's own initial draw (`x0` injected), DLG tracks the JAX attack
for 20 Adam steps within 1e-5 (l2 and cosine match losses), and the
inverting-gradients attack for its first 5 signed steps within 1e-6: a
signed step moves every coordinate by about lr, so rounding differences
show only where a gradient coordinate's sign flips at its zero. The
port alone then meets the JAX test's bars at its full 400 steps: the
label is recovered, the clean error is below half the mid-grey
baseline's, and Soteria pruning and DP noise each raise it more than
1.5x.
"""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.security import attacks as jatk

from fedml_tpu_torch.models import hub
from fedml_tpu_torch.security import attacks as atk
from fedml_tpu_torch.security.defenses import soteria_update_transform

torch.set_num_threads(2)

SHAPE, C, LABEL = (6, 6, 1), 4, 2


class TinyImg(nn.Module):
    @nn.compact
    def __call__(self, x):
        return nn.Dense(4)(x.reshape((x.shape[0], -1)))


@pytest.fixture(scope="module")
def setup():
    model = TinyImg()
    rs = np.random.RandomState(0)
    x_true = rs.rand(1, *SHAPE).astype(np.float32)
    params = model.init(jax.random.key(0), jnp.asarray(x_true))["params"]

    def loss(p):
        return -jax.nn.log_softmax(
            model.apply({"params": p}, jnp.asarray(x_true)))[0, LABEL]

    g = jax.grad(loss)(params)
    tmodel = hub.create("lr", C, SHAPE, device="cpu")
    return {"model": model, "params": params, "g": g, "x_true": x_true,
            "fn": hub.apply_fn(tmodel),
            "tparams": hub.params_from_flax(params, device="cpu"),
            "tg": hub.params_from_flax(g, device="cpu")}


@pytest.mark.parametrize("loss_type", ["l2", "cosine"])
def test_dlg_tracks_jax(setup, loss_type):
    key = jax.random.key(1)
    x0 = np.array(jax.random.normal(key, (1,) + SHAPE))
    want, wy = jatk.dlg_attack(setup["model"].apply, setup["params"],
                               setup["g"], SHAPE, C, key, steps=20, lr=0.1,
                               loss_type=loss_type)
    got, y, losses = atk.dlg_attack(
        setup["fn"], setup["tparams"], setup["tg"], SHAPE, C,
        x0=torch.from_numpy(x0), steps=20, lr=0.1, loss_type=loss_type)
    np.testing.assert_array_equal(y.numpy(), np.asarray(wy))
    moved = np.abs(np.asarray(want) - x0).max()
    assert moved > 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    assert losses.shape == (20,) and float(losses[-1]) < float(losses[0])


def test_invert_gradient_tracks_jax(setup):
    key = jax.random.key(1)
    x0 = np.array(jax.random.uniform(key, (1,) + SHAPE, minval=0.0,
                                     maxval=1.0))
    want, _ = jatk.invert_gradient_attack(
        setup["model"].apply, setup["params"], setup["g"], SHAPE, C, key,
        steps=5, lr=0.05, tv_weight=1e-3)
    got, y, losses = atk.invert_gradient_attack(
        setup["fn"], setup["tparams"], setup["tg"], SHAPE, C,
        x0=torch.from_numpy(x0), steps=5, lr=0.05, tv_weight=1e-3)
    assert int(y.argmax()) == LABEL
    assert np.abs(np.asarray(want) - x0).max() > 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    assert losses.shape == (5,)


def test_invert_gradient_reconstructs_and_degrades_under_defenses(setup):
    """The JAX test's bars on the port alone: its own true gradient, its
    own draws."""
    fn, p = setup["fn"], setup["tparams"]
    x_true = torch.from_numpy(setup["x_true"])

    def loss(pp):
        return -torch.log_softmax(fn(pp, x_true), -1)[0, LABEL]

    g = torch.func.grad(loss)(p)
    names = list(g)
    flat = torch.cat([g[k].reshape(-1) for k in names])

    def tree(v):
        out, off = {}, 0
        for k in names:
            out[k] = v[off:off + g[k].numel()].reshape(g[k].shape)
            off += g[k].numel()
        return out

    def run(grads):
        return atk.invert_gradient_attack(
            fn, p, grads, SHAPE, C, generator=torch.Generator().manual_seed(1),
            steps=400, lr=0.05, tv_weight=1e-3)

    def err(x):
        return float(((x - x_true) ** 2).mean())

    x_rec, y_rec, _ = run(g)
    assert int(y_rec.argmax()) == LABEL          # iDLG label recovery
    clean = err(x_rec)
    base = err(torch.full_like(x_true, 0.5))
    assert clean < 0.5 * base, (clean, base)
    sot = err(run(tree(soteria_update_transform(flat, 0.9)))[0])
    sigma = 0.5 * float(flat.std())
    noise = sigma * torch.randn(flat.shape,
                                generator=torch.Generator().manual_seed(7))
    dp = err(run(tree(flat + noise))[0])
    assert sot > 1.5 * clean, (sot, clean)
    assert dp > 1.5 * clean, (dp, clean)


def test_match_loss_differentiates_through_resnet_gn():
    """The match loss's gradient w.r.t. the input is a second derivative
    through convolutions and GroupNorm (a 2-stage ResNet-GN here, the
    chip phase's ResNet-18-GN at full width): it agrees with a central
    finite difference in f64, and DLG lowers the loss."""
    model = hub.ResNet(10, (8, 8, 3), stage_sizes=(1, 1), filters=8,
                       dtype=torch.float64, device="cpu")
    p = hub.init_params(model, torch.Generator().manual_seed(0),
                        dtype=torch.float64)
    fn = hub.apply_fn(model)
    x_true = torch.rand(1, 8, 8, 3, dtype=torch.float64,
                        generator=torch.Generator().manual_seed(2))
    g = torch.func.grad(
        lambda pp: -torch.log_softmax(fn(pp, x_true), -1)[0, 3])(p)
    y = atk._label_onehot(g, 10, "cpu").double()
    grads_of = atk._model_grads(fn, p, y)

    def match(x):
        gx = grads_of(x)
        return sum(((gx[k] - g[k]) ** 2).sum() for k in g)

    x = torch.rand(1, 8, 8, 3, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(3))
    d = torch.randn(x.shape, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(4))
    h = 1e-5
    fd = (match(x + h * d) - match(x - h * d)) / (2 * h)
    an = (torch.func.grad(match)(x) * d).sum()
    assert abs(float(fd - an)) <= 1e-6 * max(1.0, abs(float(an))), (fd, an)
    _x, y_rec, losses = atk.dlg_attack(
        fn, p, g, (8, 8, 3), 10, x0=x, steps=5, lr=0.05)
    assert int(y_rec.argmax()) == 3
    assert torch.isfinite(losses).all() and losses[-1] < losses[0]
