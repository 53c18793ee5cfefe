"""The LLaMA block math shared by the model forward and the decode path
(port of the float-weight half of `fedml_tpu/llm/quant.py:149-206`).

Weights keep the flax layout, `[in, out]`, and every projection is
`x @ W`. `dtype` is the compute dtype: weights are cast to it at use
(a no-op when they are stored in it), as the JAX package's
`dequant_leaf` casts float leaves. LoRA adapters and the int8 `{q, s}`
weight base are not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """The variance is taken in f32 and the normalised value cast back to
    x's dtype BEFORE the scale multiply, as in the JAX package. eps is
    1e-6 (flax's), not torch's default."""
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale


def project_qkv(block, h: torch.Tensor, n_heads: int, dtype: torch.dtype):
    """Pre-norm hidden [B, T, D] -> per-head q, k, v [B, T, H, Dh] (RoPE
    is the caller's: train and decode place positions differently)."""
    b, t, d = h.shape
    shape = (b, t, n_heads, d // n_heads)
    q = h @ block.wq.kernel.to(dtype)
    k = h @ block.wk.kernel.to(dtype)
    v = h @ block.wv.kernel.to(dtype)
    return q.reshape(shape), k.reshape(shape), v.reshape(shape)


def swiglu_mlp(block, x: torch.Tensor, dtype: torch.dtype,
               eps: float = 1e-6) -> torch.Tensor:
    """x + W_down(silu(W_gate h) * W_up h), h = RMSNorm_1(x)."""
    h = rms_norm(x, block.RMSNorm_1.scale.to(dtype), eps)
    gate = h @ block.w_gate.kernel.to(dtype)
    up = h @ block.w_up.kernel.to(dtype)
    return x + (F.silu(gate) * up) @ block.w_down.kernel.to(dtype)


def lm_head_logits(model, x: torch.Tensor, dtype: torch.dtype,
                   eps: float = 1e-6) -> torch.Tensor:
    x = rms_norm(x, model.final_norm.scale.to(dtype), eps)
    return x @ model.lm_head.kernel.to(dtype)
