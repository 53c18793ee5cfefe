"""LLaMA-shaped decoder-only LM (port of `fedml_tpu/llm/transformer.py`).

RMSNorm -> RoPE causal multi-head attention -> RMSNorm -> SwiGLU MLP, all
projections bias-free, then a final RMSNorm and the LM head.

Layout: parameters keep flax's names and shapes, so the JAX package's
tree maps across by renaming alone. Dense kernels stay `[in, out]` and
are applied as `x @ W` (they are NOT transposed into `nn.Linear`'s
`[out, in]`); the embedding is `[vocab, d_model]`. State-dict keys are
`embed.embedding`, `blocks.{i}.{RMSNorm_0,RMSNorm_1}.scale`,
`blocks.{i}.{wq,wk,wv,wo,w_gate,w_up,w_down}.kernel`,
`final_norm.scale` and `lm_head.kernel`.

The forward is the training path and the full-recompute reference the
decode path is held against (the serving hot path lives in
`llm/decode.py`). Attention is pluggable (`attn_fn`, default the plain
dense causal attention; `ops.flash_attention.flash_attn_fn` runs the
flash kernels), `remat=True` recomputes each block in the backward
(`torch.utils.checkpoint`, the counterpart of flax's `nn.remat(Block)`),
and the forward takes LoRA adapters, merged into each adapted kernel
inside its block, and a compute dtype that the weights are cast to at use.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from .quant import (
    lm_head_logits, merged_kernel, project_qkv, rms_norm, split_adapters,
    swiglu_mlp,
)

_NEG = -1e9   # fedml_tpu/parallel/seq.py's finite "-inf"
_EPS = 1e-6   # flax RMSNorm eps


@dataclass(frozen=True)
class ModelDims:
    vocab_size: int
    d_model: int
    n_layers: int
    n_heads: int
    d_ff: int


# the full width the JAX package's bench runs (bench.py LLaMA-2-7B shape)
LLAMA2_7B = ModelDims(vocab_size=32000, d_model=4096, n_layers=32,
                      n_heads=32, d_ff=11008)


def rope(x: torch.Tensor, pos: torch.Tensor,
         base: float = 10000.0) -> torch.Tensor:
    """Rotary embedding that rotates HALVES (not interleaved pairs).
    x [B, T, H, D] (D even), pos [T] global positions; angles in f32."""
    half = x.shape[-1] // 2
    freqs = base ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = pos.to(torch.float32)[:, None] * freqs[None, :]    # [T, half]
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def dense_causal_attention(q, k, v):
    """q/k/v [B, T, H, D] -> [B, T, H, D] (fedml_tpu/parallel/seq.py)."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    tq, tk = q.shape[1], k.shape[1]
    mask = (torch.arange(tq, device=q.device)[:, None]
            >= torch.arange(tk, device=q.device)[None, :])
    s = torch.where(mask, s, _NEG)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype, device):
        super().__init__()
        self.scale = _param((d,), dtype, device)


class Dense(nn.Module):
    """A bias-free flax Dense: `kernel` is [in, out], applied as x @ W."""

    def __init__(self, d_in: int, d_out: int, dtype, device):
        super().__init__()
        self.kernel = _param((d_in, d_out), dtype, device)


class Embed(nn.Module):
    def __init__(self, vocab: int, d: int, dtype, device):
        super().__init__()
        self.embedding = _param((vocab, d), dtype, device)


class Block(nn.Module):
    def __init__(self, dims: ModelDims, dtype, device, attn_fn=None):
        super().__init__()
        d, ff = dims.d_model, dims.d_ff
        self.n_heads = dims.n_heads
        self.attn_fn = attn_fn or dense_causal_attention
        self.RMSNorm_0 = RMSNorm(d, dtype, device)
        self.wq = Dense(d, d, dtype, device)
        self.wk = Dense(d, d, dtype, device)
        self.wv = Dense(d, d, dtype, device)
        self.wo = Dense(d, d, dtype, device)
        self.RMSNorm_1 = RMSNorm(d, dtype, device)
        self.w_gate = Dense(d, ff, dtype, device)
        self.w_up = Dense(d, ff, dtype, device)
        self.w_down = Dense(ff, d, dtype, device)

    def forward(self, x: torch.Tensor, pos: torch.Tensor, ad_l=None,
                rank_scale: float = 0.0) -> torch.Tensor:
        dt = x.dtype
        h = rms_norm(x, self.RMSNorm_0.scale.to(dt), _EPS)
        q, k, v = project_qkv(self, ad_l, rank_scale, h, self.n_heads, dt)
        o = self.attn_fn(rope(q, pos), rope(k, pos), v)
        x = x + o.reshape(x.shape) @ merged_kernel(self, ad_l, "wo",
                                                   rank_scale, dt)
        return swiglu_mlp(self, ad_l, rank_scale, x, dt, _EPS)


class TransformerLM(nn.Module):
    """tokens [B, T] int -> logits [B, T, vocab]. Parameters are allocated
    uninitialised on `device` (CUDA unless the caller names "cpu"; "meta"
    allocates nothing); fill them with `from_state`, or load a state from
    `init_params` / `params_from_flax`. `attn_fn` ([B, T, H, Dh] q/k/v ->
    [B, T, H, Dh]) defaults to `dense_causal_attention`; `remat`
    recomputes each block in the backward instead of keeping its
    activations."""

    def __init__(self, dims: ModelDims, *, dtype=torch.float32,
                 device=None, attn_fn=None, remat: bool = False):
        super().__init__()
        dev = (torch.device("meta") if str(device) == "meta"
               else resolve_device(device))
        self.dims = dims
        self.n_layers, self.n_heads = dims.n_layers, dims.n_heads
        self.d_model = dims.d_model
        self.remat = remat
        self.embed = Embed(dims.vocab_size, dims.d_model, dtype, dev)
        self.blocks = nn.ModuleList(Block(dims, dtype, dev, attn_fn)
                                    for _ in range(dims.n_layers))
        self.final_norm = RMSNorm(dims.d_model, dtype, dev)
        self.lm_head = Dense(dims.d_model, dims.vocab_size, dtype, dev)

    @classmethod
    def from_state(cls, dims: ModelDims, state: Mapping[str, torch.Tensor],
                   **kw) -> "TransformerLM":
        """A model whose parameters ARE the state's tensors (no copy): the
        module is built on the meta device and the state assigned in.
        `kw` (attn_fn, remat) go to the constructor."""
        dtype = next(iter(state.values())).dtype
        model = cls(dims, dtype=dtype, device="meta", **kw)
        model.load_state_dict(state, strict=True, assign=True)
        return model

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.embedding.dtype

    @property
    def device(self) -> torch.device:
        return self.embed.embedding.device

    def forward(self, tokens: torch.Tensor, pos_offset: int = 0,
                adapters=None, alpha: float = 16.0, dtype=None):
        """`adapters`: an `llm.lora` adapter dict, merged as
        W + (alpha / rank) * A @ B into each adapted kernel inside its
        block (so under remat the merge is recomputed, not kept). `dtype`:
        the compute dtype (default the parameters'); the weights are cast
        to it at use and the logits come back in it."""
        dt = dtype or self.dtype
        pos = pos_offset + torch.arange(tokens.shape[1], device=tokens.device)
        ads, top, rank_scale = split_adapters(adapters, alpha, self.n_layers)
        x = self.embed.embedding[tokens].to(dt)
        for blk, ad_l in zip(self.blocks, ads):
            if self.remat:
                x = checkpoint(blk, x, pos, ad_l, rank_scale,
                               use_reentrant=False)
            else:
                x = blk(x, pos, ad_l, rank_scale)
        return lm_head_logits(self, top, rank_scale, x, dt, _EPS)


def init_params(dims: ModelDims, seed: int = 0, dtype=torch.float32,
                device=None) -> dict[str, torch.Tensor]:
    """Random weights drawn directly on `device` from one seeded
    `torch.Generator`, at the flax initialisers' scale: Dense kernels
    lecun-normal (normal truncated at two standard deviations, std
    1/sqrt(fan_in) after truncation), the embedding normal with std
    1/sqrt(d_model), norm scales one. Each tensor is drawn in f32 and
    cast, so bf16 weights are the rounded f32 draw."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    state: dict[str, torch.Tensor] = {}

    def dense(name, d_in, d_out):
        std = 1.0 / math.sqrt(d_in) / 0.87962566103423978  # trunc. correction
        w = torch.empty((d_in, d_out), dtype=torch.float32, device=dev)
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)
        state[name] = w.to(dtype)

    def ones(name, d):
        state[name] = torch.ones((d,), dtype=dtype, device=dev)

    d, ff = dims.d_model, dims.d_ff
    state["embed.embedding"] = (torch.randn(
        (dims.vocab_size, d), generator=gen, device=dev)
        / math.sqrt(d)).to(dtype)
    for i in range(dims.n_layers):
        p = f"blocks.{i}."
        ones(p + "RMSNorm_0.scale", d)
        ones(p + "RMSNorm_1.scale", d)
        for name in ("wq", "wk", "wv", "wo"):
            dense(p + name + ".kernel", d, d)
        dense(p + "w_gate.kernel", d, ff)
        dense(p + "w_up.kernel", d, ff)
        dense(p + "w_down.kernel", ff, d)
    ones("final_norm.scale", d)
    dense("lm_head.kernel", d, dims.vocab_size)
    return state


def params_from_flax(params, dtype=torch.float32,
                     device=None) -> dict[str, torch.Tensor]:
    """The JAX package's TransformerLM parameter tree (nested dicts of
    numpy arrays) -> this module's state dict. Accepts both layouts:
    unrolled (`block_0` .. `block_{L-1}`) and scan-stacked (`blocks/...`
    with a leading [L] axis, the mapping `fedml_tpu/llm/decode.py`
    `stack_blocks` makes). Kernels keep their [in, out] layout."""
    dev = resolve_device(device)
    flat: dict[str, np.ndarray] = {}

    def walk(prefix, node):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(prefix + (str(k),), v)
        else:
            flat[".".join(prefix)] = np.asarray(node)

    walk((), params)
    state: dict[str, torch.Tensor] = {}

    def put(name, arr):
        state[name] = torch.from_numpy(np.array(arr, np.float32)).to(
            device=dev, dtype=dtype)

    for name, arr in flat.items():
        head, _, rest = name.partition(".")
        if head == "blocks":           # scan layout: split the [L] axis
            for i in range(arr.shape[0]):
                put(f"blocks.{i}.{rest}", arr[i])
        elif head.startswith("block_"):
            put(f"blocks.{head[len('block_'):]}.{rest}", arr)
        else:
            put(name, arr)
    return state
