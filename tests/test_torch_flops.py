"""The port's FLOP counter (`fedml_tpu_torch.utils.flops`) against the JAX
package's `analytic_flops`, on the CPU.

On a two-stage ResNet-GN (stride-2 3x3 and 1x1 convolutions at the second
stage's entry), the gradient of the loss counts exactly JAX's count less
the stride term: for every convolution of stride s > 1 whose input
gradient is taken, JAX counts the input gradient as a convolution over
the stride-dilated cotangent, (s^2 - 1) x 2 |y| k_h k_w C_in more than
the taps the device multiplies (|y| the output's size). Forward passes,
and dense layers forward and backward, count the same outright.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.core.algorithm import masked_softmax_ce as jax_ce
from fedml_tpu.models import hub as jax_hub
from fedml_tpu.utils.flops import analytic_flops as jax_flops

from fedml_tpu_torch.core.algorithm import masked_softmax_ce
from fedml_tpu_torch.models import hub
from fedml_tpu_torch.utils import flops

torch.set_num_threads(2)

B, HW, C = 4, 16, 10


def _models(name, **kw):
    if name == "resnet":
        jm = jax_hub.ResNet(C, stage_sizes=(1, 1), filters=8)
        tm = hub.ResNet(C, (HW, HW, 3), stage_sizes=(1, 1), filters=8,
                        device="cpu")
        shape = (HW, HW, 3)
    else:
        jm = jax_hub.create("mlp", C)
        tm = hub.create("mlp", C, (64,), device="cpu")
        shape = (64,)
    jp = jax_hub.init_params(jm, shape, jax.random.key(0))
    return jm, jp, tm, hub.params_from_flax(jp, device="cpu"), shape


def _conv_terms(tm: torch.nn.Module, x: torch.Tensor) -> dict:
    """From one forward's shapes: the stride term, sum over stride-s > 1
    convolutions of (s^2 - 1) x 2 |y| k k C_in; the forward's conv and
    dense FLOPs; and the first convolution's (whose input gradient
    nobody takes)."""
    out = {"stride": 0.0, "forward": 0.0, "first_conv": None}

    def conv(mod, _inp, y):
        f = 2.0 * y.numel() * mod.k * mod.k * mod.kernel.shape[1]
        out["forward"] += f
        if out["first_conv"] is None:
            out["first_conv"] = f
        if mod.stride > 1:
            out["stride"] += (mod.stride ** 2 - 1) * f

    def dense(mod, _inp, y):
        out["forward"] += 2.0 * y.numel() * mod.kernel.shape[0]

    hooks = [m.register_forward_hook(conv if isinstance(m, hub.Conv)
                                     else dense)
             for m in tm.modules() if isinstance(m, (hub.Conv, hub.Dense))]
    params = {k: torch.empty(v.shape, device=x.device)
              for k, v in tm.named_parameters()}
    with torch.no_grad():
        hub.apply_fn(tm)(params, x)
    for h in hooks:
        h.remove()
    return out


def _stride_term(tm: torch.nn.Module, x: torch.Tensor) -> float:
    return _conv_terms(tm, x)["stride"]


@pytest.mark.parametrize("name", ["resnet", "mlp"])
def test_forward_and_backward_counts(name):
    jm, jp, tm, tp, shape = _models(name)
    rs = np.random.RandomState(0)
    x = rs.randn(B, *shape).astype(np.float32)
    y = rs.randint(0, C, B)
    jx, jy = jnp.asarray(x), jnp.asarray(y)

    def jloss(p):
        logp = jax.nn.log_softmax(jm.apply({"params": p}, jx))
        return -jnp.take_along_axis(logp, jy[:, None], 1).mean()

    fn = hub.apply_fn(tm)
    tx, ty, mask = (torch.from_numpy(x), torch.from_numpy(y).long(),
                    torch.ones(B))

    def tloss(p):
        return masked_softmax_ce(fn(p, tx), ty, mask)[0]

    j_fwd = jax_flops(lambda p: jm.apply({"params": p}, jx), jp)
    t_fwd = flops.analytic_flops(lambda p: fn(p, tx), tp)
    assert t_fwd == j_fwd > 0
    j_bwd = jax_flops(jax.grad(jloss), jp)
    t_bwd = flops.analytic_flops(torch.func.grad(tloss), tp)
    term = _stride_term(tm, tx) if name == "resnet" else 0.0
    if name == "resnet":
        assert term > 0
    assert t_bwd == j_bwd - term, (t_bwd, j_bwd, term)
    assert t_bwd > 2 * t_fwd


def test_counts_on_meta_tensors_and_groups():
    """A meta-device step counts as the real one (no data, no arithmetic),
    and a vmapped group of clients counts as the clients one by one (its
    convolutions run grouped: torch's own formula would count their
    weight gradients g-fold)."""
    _jm, _jp, tm, tp, shape = _models("resnet")
    fn = hub.apply_fn(tm)
    x = torch.randn(B, *shape)
    y = torch.randint(0, C, (B,))

    def loss(p, xx, yy):
        return masked_softmax_ce(fn(p, xx), yy,
                                 torch.ones(B, device=xx.device))[0]

    grad = torch.func.grad(loss)
    real = flops.analytic_flops(grad, tp, x, y)
    meta = flops.analytic_flops(
        grad, {k: v.to("meta") for k, v in tp.items()}, x.to("meta"),
        y.to("meta"))
    assert meta == real
    g = 3
    stacked = {k: v.expand((g,) + v.shape).clone() for k, v in tp.items()}
    grouped = flops.analytic_flops(torch.func.vmap(grad), stacked,
                                   x.expand((g,) + x.shape).clone(),
                                   y.expand((g,) + y.shape).clone())
    assert grouped == g * real


def test_spec_peak():
    assert flops.spec_peak_tflops("cpu") is None
    assert "mm" in flops.COUNTED and "convolution_backward" in flops.COUNTED


def test_flagship_step_counts_reconcile():
    """One flagship local step (ResNet-18-GN, bf16, batch 32), traced by
    the JAX counter (no execution) and counted by the port's on meta
    tensors: the JAX count x 700 local steps a round is BENCH_full.json's
    83.03 TFLOP; the port's is the JAX count less the stride term; and
    the 3 x forward rule of PR 10's 74.65 TFLOP counts the same plus the
    input gradient of the first convolution, which no step computes."""
    jm = jax_hub.create("resnet18_gn", 10)
    jp = jax.eval_shape(
        lambda: jax_hub.init_params(jm, (32, 32, 3), jax.random.key(0)))
    japply = jax_hub.mixed_precision_apply(jm.apply, "bfloat16")
    sd = jax.ShapeDtypeStruct

    def jloss(p, x, y, m):
        return jax_ce(japply({"params": p}, x), y, m)[0]

    j_step = jax_flops(jax.grad(jloss), jp,
                       sd((32, 32, 32, 3), jnp.float32),
                       sd((32,), jnp.int32), sd((32,), jnp.float32))
    tm = hub.create("resnet18_gn", 10, (32, 32, 3), device="meta")
    tp = {k: torch.empty(v.shape, device="meta")
          for k, v in tm.named_parameters()}
    fn = hub.apply_fn(tm, "bfloat16")
    x = torch.empty(32, 32, 32, 3, device="meta")

    def tloss(p, xx, yy, mm):
        return masked_softmax_ce(fn(p, xx), yy, mm)[0]

    t_step = flops.analytic_flops(
        torch.func.grad(tloss), tp, x,
        torch.empty(32, dtype=torch.long, device="meta"),
        torch.empty(32, device="meta"))
    terms = _conv_terms(tm, x)
    assert j_step == 118_607_511_552
    assert j_step * 700 == 83_025_258_086_400      # BENCH_full.json
    assert t_step == 106_527_916_032
    assert t_step == j_step - terms["stride"]
    assert terms["stride"] == 12_079_595_520
    assert 3 * terms["forward"] - terms["first_conv"] == t_step
    assert round(3 * terms["forward"] * 700 / 1e12, 2) == 74.65
