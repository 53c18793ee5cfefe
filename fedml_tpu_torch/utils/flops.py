"""Matmul and convolution FLOPs of one execution — the numerator of a
utilization figure (port of `fedml_tpu/utils/flops.py`).

`analytic_flops(fn, *args)` runs `fn` once under a dispatch mode and sums
the FLOPs of the matmul and convolution operators it dispatched (`mm`,
`addmm`, `bmm`, `baddbmm`, `convolution`, `convolution_backward`) by
torch's own formulas (`torch.utils.flop_counter.flop_registry`, what
FlopCounterMode applies), whatever transform produced them
(`torch.func.grad`, `vmap`, checkpoint recompute).
Elementwise, normalisation and reduction work is not counted, so the
count is a lower bound on what the device executed.

One deviation from the JAX count, by design: this counts the taps a
convolution's input gradient multiplies. JAX's counter reads the input
gradient as a convolution over the stride-dilated cotangent, so for a
convolution of stride s > 1 whose input gradient is taken it counts
s^2 x the forward's taps where s^2 - 1 of every s^2 are zeros; the port
counts (s^2 - 1) x 2 |y| k_h k_w C_in / groups fewer FLOPs for each such
convolution (|y| its output's size), and nothing else differs.

`convolution_backward` is counted as the forward convolution's FLOPs once
for each gradient it computes (input, weight). That is torch's own count
for an ungrouped convolution; torch's formula ignores `groups` in the
weight gradient, which overcounts a grouped convolution g-fold, and a
vmapped group of g clients runs its convolutions as grouped ones.

`counting()` runs a block under the same counter plus a count of the
bytes the counted operators' tensors occupy (inputs read once, outputs
written once): the cost ledger's capture (`utils/xla_ledger.py`).

`spec_peak_tflops` is the card's published dense bf16 peak by device
name (the utilization's denominator), None for the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch

# the operators counted, as FlopCounterMode names them
COUNTED = ("mm", "addmm", "bmm", "baddbmm", "convolution",
           "convolution_backward")

# published dense bf16 peaks (TFLOP/s) by CUDA device name, NVIDIA's data
# sheets at each part's full power limit
_SPEC_BF16 = (
    ("h100 nvl", 835.0),
    ("h100 pcie", 756.0),
    ("h100", 989.0),        # SXM (e.g. "NVIDIA H100 80GB HBM3")
    ("h200", 989.0),
)


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias, _stride,
                        _padding, _dilation, transposed, _output_padding,
                        _groups, output_mask, out_shape=None, **_kw) -> int:
    """The forward's count (`w_shape` holds C_in / groups) for each of
    the input and weight gradients computed."""
    from torch.utils.flop_counter import conv_flop_count

    fwd = conv_flop_count(x_shape, w_shape, grad_out_shape, transposed)
    return fwd * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def _formulas() -> dict:
    """{operator packet: flop formula} of the counted operators: torch's
    own `flop_registry` entries (shape-wrapped), `convolution_backward`
    by `_conv_backward_flop`."""
    from torch.utils.flop_counter import flop_registry, shape_wrapper

    aten = torch.ops.aten
    out = {p: flop_registry[p] for p in (aten.mm, aten.addmm, aten.bmm,
                                         aten.baddbmm, aten.convolution)}
    out[aten.convolution_backward] = shape_wrapper(_conv_backward_flop)
    return out


def _counter():
    """One dispatch mode that sums the counted operators' FLOPs (torch's
    formulas, as FlopCounterMode applies them) and the bytes of their
    tensor arguments and results; every other operator passes straight
    through (FlopCounterMode also tries to decompose each uncounted
    operator and tracks modules, which costs tens of microseconds an
    operator and refuses the per-block remat's backward)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    formulas = _formulas()

    class _Count(TorchDispatchMode):
        flops = 0
        nbytes = 0
        tally = None     # a cost ledger capture's (ops/cost.py)

        @classmethod
        def _should_skip_dynamo(cls) -> bool:
            # torch wraps a mode's __torch_dispatch__ to keep its compiler
            # out, which imports that compiler (seconds) at the first
            # operator; the port compiles nothing
            return False

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if isinstance(func, torch._ops.HigherOrderOperator):
                return NotImplemented
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            formula = formulas.get(func._overloadpacket)
            if formula is not None:
                self.flops += formula(*args, **kwargs, out_val=out)
                self.nbytes += sum(
                    t.numel() * t.element_size()
                    for t in tree_leaves((args, kwargs, out))
                    if isinstance(t, torch.Tensor))
            return out

    return _Count()


def analytic_flops(fn, *args, **kwargs) -> float:
    """Matmul + convolution FLOPs of one execution of `fn(*args,
    **kwargs)`. The function runs (on meta tensors it runs without data
    or arithmetic); recomputation is counted, as the device executes
    it."""
    with _counter() as counter:
        fn(*args, **kwargs)
    return float(counter.flops)


def counting():
    """A dispatch mode that counts a block's matmul and convolution work
    as `analytic_flops` does (`flops`), plus the bytes of those
    operators' tensors (`nbytes`): enter it around the block."""
    return _counter()


def spec_peak_tflops(device: Optional[torch.device] = None
                     ) -> Optional[float]:
    """The dense bf16 spec peak of a CUDA `device` (default: the current
    one) by its name, or None for the CPU or an unknown card."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device).lower()
    for tag, tflops in _SPEC_BF16:
        if tag in name:
            return tflops
    return None
