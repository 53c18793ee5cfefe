"""The LLaMA block math shared by the model forward and the decode path
(port of the float-weight half of `fedml_tpu/llm/quant.py:149-206`).

Weights keep the flax layout, `[in, out]`, and every projection is
`x @ W`. `dtype` is the compute dtype: weights are cast to it at use
(a no-op when they are stored in it), as the JAX package's
`dequant_leaf` casts float leaves. LoRA adapters ride along as in the JAX
helpers: `ad_l` is one block's adapters ({"wq": {"a", "b"}, ...}, or None)
and `rank_scale` is alpha / rank. The int8 `{q, s}` weight base is not
ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .lora import merge_delta


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """The variance is taken in f32 and the normalised value cast back to
    x's dtype BEFORE the scale multiply, as in the JAX package. eps is
    1e-6 (flax's), not torch's default."""
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale


def split_adapters(adapters, alpha: float, n_layers: int):
    """(per-block adapter dicts [L], top-level adapters, rank_scale) from a
    `llm.lora` adapter dict keyed by state name (`blocks.{i}.wq.kernel`,
    `lm_head.kernel`); None/empty adapters -> ([None] * L, {}, 0.0)."""
    if not adapters:
        return [None] * n_layers, {}, 0.0
    rank = next(iter(adapters.values()))["a"].shape[-1]
    blocks: list = [None] * n_layers
    top = {}
    for key, ab in adapters.items():
        parts = key.split(".")
        if parts[0] == "blocks":
            i = int(parts[1])
            blocks[i] = {**(blocks[i] or {}), parts[2]: ab}
        else:
            top[parts[0]] = ab
    return blocks, top, alpha / rank


def merged_kernel(block, ad_l, name: str, rank_scale: float,
                  dtype: torch.dtype) -> torch.Tensor:
    """`block.<name>.kernel` with its LoRA delta merged in W's stored dtype
    (`llm.lora.merge_delta`), then cast to the compute dtype."""
    w = getattr(block, name).kernel
    ab = ad_l.get(name) if ad_l else None
    if ab is not None:
        w = merge_delta(w, ab, rank_scale)
    return w.to(dtype)


def project_qkv(block, ad_l, rank_scale: float, h: torch.Tensor,
                n_heads: int, dtype: torch.dtype):
    """Pre-norm hidden [B, T, D] -> per-head q, k, v [B, T, H, Dh] (RoPE
    is the caller's: train and decode place positions differently)."""
    b, t, d = h.shape
    shape = (b, t, n_heads, d // n_heads)
    return tuple((h @ merged_kernel(block, ad_l, n, rank_scale, dtype))
                 .reshape(shape) for n in ("wq", "wk", "wv"))


def swiglu_mlp(block, ad_l, rank_scale: float, x: torch.Tensor,
               dtype: torch.dtype, eps: float = 1e-6) -> torch.Tensor:
    """x + W_down(silu(W_gate h) * W_up h), h = RMSNorm_1(x)."""
    h = rms_norm(x, block.RMSNorm_1.scale.to(dtype), eps)
    gate = h @ merged_kernel(block, ad_l, "w_gate", rank_scale, dtype)
    up = h @ merged_kernel(block, ad_l, "w_up", rank_scale, dtype)
    return x + (F.silu(gate) * up) @ merged_kernel(block, ad_l, "w_down",
                                                   rank_scale, dtype)


def lm_head_logits(model, top_ads, rank_scale: float, x: torch.Tensor,
                   dtype: torch.dtype, eps: float = 1e-6) -> torch.Tensor:
    x = rms_norm(x, model.final_norm.scale.to(dtype), eps)
    return x @ merged_kernel(model, top_ads, "lm_head", rank_scale, dtype)
