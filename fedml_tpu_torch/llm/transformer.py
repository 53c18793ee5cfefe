"""LLaMA-shaped decoder-only LM (port of `fedml_tpu/llm/transformer.py`).

RMSNorm -> RoPE causal multi-head attention -> RMSNorm -> SwiGLU MLP, all
projections bias-free, then a final RMSNorm and the LM head.

Layout: parameters keep flax's names and shapes, so the JAX package's
tree maps across by renaming alone. Dense kernels stay `[in, out]` and
are applied as `x @ W` (they are NOT transposed into `nn.Linear`'s
`[out, in]`); the embedding is `[vocab, d_model]`. State-dict keys are
`embed.embedding`, `blocks.{i}.{RMSNorm_0,RMSNorm_1}.scale`,
`blocks.{i}.{wq,wk,wv,wo,w_gate,w_up,w_down}.kernel`,
`final_norm.scale` and `lm_head.kernel`. A kernel or the embedding may be
an int8 `QWeight` (`llm/quant.py`): its keys are then `<name>.q` (int8)
and `<name>.s` (f32 per-output-channel scales), and `from_state` builds
the module to the state's layout.

The forward is the training path and the full-recompute reference the
decode path is held against (the serving hot path lives in
`llm/decode.py`). Attention is pluggable (`attn_fn`, default the plain
dense causal attention; `ops.flash_attention.flash_attn_fn` runs the
flash kernels), `remat=True` recomputes each block in the backward
(`remat`, the counterpart of flax's `nn.remat(Block)`, which
`torch.func.grad` and `torch.func.vmap` take), and the forward takes LoRA
adapters, merged into each adapted kernel inside its block, and a compute
dtype that the weights are cast (or dequantised) to at use.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch
import torch.nn as nn

from .._device import resolve_device
from ..parallel.seq import dense_causal_attention
from .quant import (
    QWeight, attn_out, embed_rows, flat_state, lm_head_logits, project_qkv,
    rms_norm, split_adapters, swiglu_mlp,
)

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


class _Remat(torch.autograd.Function):
    """fn(*tensors) -> y, with nothing of fn kept for the backward but its
    inputs: the backward runs fn again under `torch.func.vjp`. Unlike
    `torch.utils.checkpoint` it installs no saved-tensor hooks, which
    `torch.func.grad` refuses, and `torch.func.vmap` batches it through
    the generated rule."""
    generate_vmap_rule = True

    @staticmethod
    def forward(fn, *tensors):
        return fn(*tensors)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.fn = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, grad):
        tensors = ctx.saved_tensors
        need = [i for i, n in enumerate(ctx.needs_input_grad[1:]) if n]

        def part(*sub):
            full = list(tensors)
            for i, t in zip(need, sub):
                full[i] = t
            return ctx.fn(*full)

        # torch.func.grad runs the backward with create_graph: without
        # no_grad the recompute would join the outer graph and every
        # block's activations would stay alive until the gradient returns
        # (no second derivative goes through a remat block)
        with torch.no_grad():
            _, vjp = torch.func.vjp(part, *(tensors[i] for i in need))
            grads = dict(zip(need, vjp(grad)))
        return (None,) + tuple(grads.get(i) for i in range(len(tensors)))


def remat(block, x: torch.Tensor, pos: torch.Tensor, ad_l,
          rank_scale: float) -> torch.Tensor:
    """block(x, pos, ad_l, rank_scale), recomputed in the backward instead
    of keeping its activations. Every tensor the block reads that is not
    a parameter (x, pos, the adapters) is an input of the function, not
    a closure: a tensor made inside a torch.func transform belongs to its
    level, which the generated vmap rule has left."""
    names = sorted(ad_l) if ad_l else []
    flat = [ad_l[n][k] for n in names for k in ("a", "b")]

    def fn(x, pos, *ab):
        ads = {n: {"a": ab[2 * i], "b": ab[2 * i + 1]}
               for i, n in enumerate(names)} or None
        return block(x, pos, ads, rank_scale)

    return _Remat.apply(fn, x, pos, *flat)


def _split(n: int, tp, what: str) -> int:
    """n / tp.size, the shard's share of a split dimension."""
    if tp is None:
        return n
    if n % tp.size:
        raise ValueError(f"{what} {n} is not divisible by the {tp.size} "
                         f"ranks of mesh axis {tp.axis!r}")
    return n // tp.size


class Block(nn.Module):
    """One block; with `tp` its tensor-parallel shard: the rank's heads
    (wq / wk / wv column blocks, wo's matching rows) and its block of
    d_ff (w_gate / w_up columns, w_down rows)."""

    def __init__(self, dims: ModelDims, dtype, device, attn_fn=None,
                 eps: float = _EPS, tp=None):
        super().__init__()
        d, ff = dims.d_model, dims.d_ff
        dl = _split(d, tp, "d_model")
        fl = _split(ff, tp, "d_ff")
        self.n_heads = _split(dims.n_heads, tp, "n_heads")
        self.tp = tp
        self.eps = eps
        self.attn_fn = attn_fn or dense_causal_attention
        self.RMSNorm_0 = RMSNorm(d, dtype, device)
        self.wq = Dense(d, dl, dtype, device)
        self.wk = Dense(d, dl, dtype, device)
        self.wv = Dense(d, dl, dtype, device)
        self.wo = Dense(dl, d, dtype, device)
        self.RMSNorm_1 = RMSNorm(d, dtype, device)
        self.w_gate = Dense(d, fl, dtype, device)
        self.w_up = Dense(d, fl, dtype, device)
        self.w_down = Dense(fl, d, dtype, device)

    def forward(self, x: torch.Tensor, pos: torch.Tensor, ad_l=None,
                rank_scale: float = 0.0) -> torch.Tensor:
        dt = x.dtype
        h = rms_norm(x, self.RMSNorm_0.scale.to(dt), self.eps)
        q, k, v = project_qkv(self, ad_l, rank_scale, h, self.n_heads, dt)
        o = self.attn_fn(rope(q, pos), rope(k, pos), v)
        x = attn_out(self, ad_l, rank_scale, x, o, dt)
        return swiglu_mlp(self, ad_l, rank_scale, x, dt, self.eps)


class TransformerLM(nn.Module):
    """tokens [B, T] int -> logits [B, T, vocab]. Parameters are allocated
    uninitialised on `device` (CUDA unless the caller names "cpu"; "meta"
    allocates nothing); fill them with `from_state`, or load a state from
    `init_params` / `params_from_flax`. `attn_fn` ([B, T, H, Dh] q/k/v ->
    [B, T, H, Dh]) defaults to `dense_causal_attention`; `remat`
    recomputes each block in the backward instead of keeping its
    activations; `eps` is the RMSNorms' (flax's 1e-6).

    `tp` (a `parallel.tensor.TPContext`) makes the module this rank's
    tensor-parallel shard of the model `dims` describes (`llm/tp.py`):
    its blocks hold their column / row blocks, the embedding its column
    block, the LM head its vocabulary block, and `n_heads` counts the
    rank's own heads (`head_dim` stays the model's)."""

    def __init__(self, dims: ModelDims, *, dtype=torch.float32,
                 device=None, attn_fn=None, remat: bool = False,
                 eps: float = _EPS, tp=None):
        super().__init__()
        dev = (torch.device("meta") if str(device) == "meta"
               else resolve_device(device))
        self.dims = dims
        self.tp = tp
        self.n_layers = dims.n_layers
        self.n_heads = _split(dims.n_heads, tp, "n_heads")
        self.head_dim = dims.d_model // dims.n_heads
        self.d_model = dims.d_model
        self.remat = remat
        self.eps = eps
        self.embed = Embed(dims.vocab_size,
                           _split(dims.d_model, tp, "d_model"), dtype, dev)
        self.blocks = nn.ModuleList(Block(dims, dtype, dev, attn_fn, eps, tp)
                                    for _ in range(dims.n_layers))
        self.final_norm = RMSNorm(dims.d_model, dtype, dev)
        self.lm_head = Dense(dims.d_model,
                             _split(dims.vocab_size, tp, "vocab_size"),
                             dtype, dev)

    @classmethod
    def from_state(cls, dims: ModelDims, state: Mapping[str, torch.Tensor],
                   **kw) -> "TransformerLM":
        """A model whose parameters ARE the state's tensors (no copy): the
        module is built on the meta device and the state assigned in.
        A weight the state holds int8 (`{"q", "s"}`, or `<name>.q` /
        `<name>.s` keys) becomes a `QWeight` there. `kw` (attn_fn, remat,
        eps, tp) go to the constructor; with `tp` the state is the rank's
        shard (`parallel.partition.shard_params`), whose replicated
        embedding / LM-head scales are cut here to the shard's columns."""
        state = flat_state(state)
        model = cls(dims, dtype=state["final_norm.scale"].dtype,
                    device="meta", **kw)
        for key in list(state):
            if key.endswith(".q"):
                owner, _, attr = key[:-2].rpartition(".")
                mod = model.get_submodule(owner)
                del mod._parameters[attr]
                setattr(mod, attr, QWeight(tuple(state[key].shape),
                                           device="meta"))
                s_key, cols = key[:-2] + ".s", state[key].shape[-1]
                if model.tp is not None and state[s_key].shape[-1] != cols:
                    state[s_key] = state[s_key][
                        ..., model.tp.block(state[s_key].shape[-1])]
        model.load_state_dict(state, strict=True, assign=True)
        return model

    @property
    def dtype(self) -> torch.dtype:
        """The float weights' dtype (bf16 for an int8 base, whose float
        leaves `quantize_tree_int8` stores bf16)."""
        return self.final_norm.scale.dtype

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device

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
        x = embed_rows(self.embed.embedding, tokens, dt, self.tp)
        for blk, ad_l in zip(self.blocks, ads):
            if self.remat:
                x = remat(blk, x, pos, ad_l, rank_scale)
            else:
                x = blk(x, pos, ad_l, rank_scale)
        return lm_head_logits(self, top, rank_scale, x, dt, self.eps)


def dims_of_state(state: Mapping, n_heads: int) -> ModelDims:
    """The ModelDims of a (possibly int8) state dict, from its shapes."""
    flat = flat_state(state)

    def shape(name):
        return tuple((flat.get(name) if name in flat
                      else flat[name + ".q"]).shape)

    vocab, d = shape("embed.embedding")
    n_layers = 1 + max(int(k.split(".")[1]) for k in flat
                       if k.startswith("blocks."))
    return ModelDims(vocab_size=vocab, d_model=d, n_layers=n_layers,
                     n_heads=n_heads, d_ff=shape("blocks.0.w_gate.kernel")[1])


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
                     device=None) -> dict:
    """The JAX package's TransformerLM parameter tree (nested dicts of
    numpy arrays) -> this module's state dict. Accepts both layouts:
    unrolled (`block_0` .. `block_{L-1}`) and scan-stacked (`blocks/...`
    with a leading [L] axis, the mapping `fedml_tpu/llm/decode.py`
    `stack_blocks` makes). Kernels keep their [in, out] layout. Float
    leaves go to `dtype`; an int8 `{"q", "s"}` leaf of
    `quantize_tree_int8` stays {"q": int8, "s": f32} under its weight's
    name, a stacked one split per layer (s [L, 1, dout] -> [1, dout]), so
    that stacked and unrolled bases give the same per-layer scales."""
    dev = resolve_device(device)
    flat: dict = {}

    def walk(prefix, node):
        if isinstance(node, Mapping) and set(node) == {"q", "s"}:
            flat[".".join(prefix)] = {k: np.asarray(v)
                                      for k, v in node.items()}
        elif isinstance(node, Mapping):
            for k, v in node.items():
                walk(prefix + (str(k),), v)
        else:
            flat[".".join(prefix)] = np.asarray(node)

    walk((), params)
    state: dict = {}

    def put(name, arr):
        if isinstance(arr, dict):
            state[name] = {
                "q": torch.from_numpy(np.array(arr["q"], np.int8)).to(dev),
                "s": torch.from_numpy(np.array(arr["s"], np.float32)).to(
                    dev)}
        else:
            state[name] = torch.from_numpy(np.array(arr, np.float32)).to(
                device=dev, dtype=dtype)

    def layer(arr, i):
        return ({k: v[i] for k, v in arr.items()} if isinstance(arr, dict)
                else arr[i])

    for name, arr in flat.items():
        head, _, rest = name.partition(".")
        if head == "blocks":           # scan layout: split the [L] axis
            n = (arr["q"] if isinstance(arr, dict) else arr).shape[0]
            for i in range(n):
                put(f"blocks.{i}.{rest}", layer(arr, i))
        elif head.startswith("block_"):
            put(f"blocks.{head[len('block_'):]}.{rest}", arr)
        else:
            put(name, arr)
    return state
