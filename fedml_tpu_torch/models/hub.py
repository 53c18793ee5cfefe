"""Mixed-precision apply (port of `fedml_tpu/models/hub.py:222`)."""
from __future__ import annotations

import torch

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def mixed_precision_apply(apply_fn, compute_dtype: str):
    """Wrap a model for mixed-precision compute: a floating input is cast
    to `compute_dtype`, the model runs with `dtype=compute_dtype` (it casts
    its floating weights to that dtype at use, so trained parameters and
    the optimizer stay f32), and the output comes back f32 so the loss is
    taken in f32. float32 returns `apply_fn` itself."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of "
                         f"{sorted(COMPUTE_DTYPES)}; got {compute_dtype!r}")
    dtype = COMPUTE_DTYPES[compute_dtype]
    if dtype == torch.float32:
        return apply_fn

    def wrapped(x, *args, **kwargs):
        if x.is_floating_point():
            x = x.to(dtype)
        return apply_fn(x, *args, dtype=dtype, **kwargs).float()

    return wrapped
