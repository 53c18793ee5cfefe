"""The rule a hand-written kernel's output is held to against its plain
PyTorch version, shared by every op of the port (`chip_smoke.py` and the
`gpu`-marked tests use it)."""
from __future__ import annotations

import torch


def rowwise_rel_err(got, want) -> float:
    """The rule a kernel's output is held to against its plain version:
    the largest |got - want| in a row (the last axis: a query row of a
    [BH, T, D] flash output, an (s, c, h) row of an [S, C, H, Dh] paged
    output; each entry of a [BH, T] LSE is a row of its own) relative to
    that row's max|want|,
    after one unit in the last place of the element in the output's dtype
    is forgiven. Attention outputs shrink along T (a late row averages
    many values), so a rule relative to the whole tensor's maximum would
    let late rows be wrong by their own size. Kernel and plain version
    round their f32 sums to the output dtype at the same point, so a
    last-bit difference in a sum can flip that rounding by one ulp (2^-7
    of the element in bf16): that much is not an error of the kernel. For
    inputs of unit scale, a row whose largest magnitude is below 1e-2 is
    held to 1e-2: such rows are cancellations (dQ's first row, and dQ/dK
    at T = 1, are 0 up to rounding), whose noise is not a signal."""
    eps = torch.finfo(got.dtype).eps
    g, w = got.float(), want.float()
    if w.dim() == 2:
        g, w = g[..., None], w[..., None]
    ulp = torch.where(w == 0, 0.0, torch.ldexp(torch.full_like(w, eps / 2),
                                               torch.frexp(w)[1]))
    diff = ((g - w).abs() - ulp).clamp(min=0).amax(-1)
    mag = w.abs().amax(-1)
    return (diff / mag.clamp(min=1e-2)).max().item()


# the bars each kernel is held to under `rowwise_rel_err` (the same numbers
# as chip_smoke.py's TOL and FLASH_TOL, where the readings behind them are
# given): K4 by pool kind, K1-K3 by dtype
PAGED_TOL = {"f32": 1e-5, "bf16": 1e-2, "int8": 1e-2}
FLASH_TOL = {"f32": 1e-4, "bf16": 1e-2}
