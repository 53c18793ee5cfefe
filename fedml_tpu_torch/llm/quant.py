"""The int8 LoRA base and the LLaMA block math shared by the model forward
and the decode path (port of `fedml_tpu/llm/quant.py`).

Weights keep the flax layout, `[in, out]`, and every projection is
`x @ W`. `dtype` is the compute dtype: weights are cast to it at use
(a no-op when they are stored in it), as the JAX package's
`dequant_leaf` casts float leaves. LoRA adapters ride along as in the JAX
helpers: `ad_l` is one block's adapters ({"wq": {"a", "b"}, ...}, or None)
and `rank_scale` is alpha / rank.

The int8 base (the QLoRA storage format): federated LoRA never updates
the base, so a frozen base may be STORED int8, symmetric per output
channel (scale = max|w| / 127 over every axis but the last, a zero scale
-> 1.0), and dequantised to the compute dtype at use. Only matmul weights
are quantised (`kernel` / `embedding` leaves of ndim >= 2 and at least
4096 elements); the other float leaves are stored bf16. A quantised
weight is `{"q": int8, "s": f32}` in a state dict and a `QWeight` module
(parameters `q`, `s`) inside a `TransformerLM`, under the name of the
weight it replaces (`blocks.0.wq.kernel.q`). For such a weight
`merged_kernel` keeps the JAX order: dequantise to the compute dtype,
then add the LoRA delta cast to that dtype. A float weight keeps the
port's order, the delta merged in W's stored dtype before the cast
(the JAX module-level path's `lora_merge` then compute-dtype cast); the
JAX in-scan forward casts first there too, which differs only for an
adapted kernel below the size rule, stored bf16 and run in f32 (none at
d_model >= 64).

The size rule reads each tensor as given: the port's state holds one
layer a tensor, where a JAX scan-stacked leaf counts L layers, so the
two agree on every kernel of at least 4096 elements a layer (d_model
>= 64 for the square projections).

`make_inscan_quant_apply` is the training forward over such a base: a
loop over the blocks that dequantises and merges one layer at a time,
inside the block's remat, so the backward dequantises again instead of
keeping the dense weights.
"""
from __future__ import annotations

from typing import Mapping

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.tensor import copy_in, gather, reduce_out
from .lora import merge_delta

_MIN_QUANT_SIZE = 4096   # leaves smaller than this stay bf16
_QUANT_SUFFIXES = ("kernel", "embedding")


class QWeight(nn.Module):
    """An int8 weight in a module: `q` int8 [din, dout] (or [vocab, d]),
    `s` f32 [1, dout], both frozen parameters."""

    def __init__(self, shape, device=None):
        super().__init__()
        self.q = nn.Parameter(torch.empty(shape, dtype=torch.int8,
                                          device=device),
                              requires_grad=False)
        self.s = nn.Parameter(torch.empty(
            (1,) * (len(shape) - 1) + (shape[-1],), dtype=torch.float32,
            device=device), requires_grad=False)


def is_q(leaf) -> bool:
    """A quantised weight: a `QWeight` or a {"q", "s"} dict."""
    return isinstance(leaf, QWeight) or (
        isinstance(leaf, Mapping) and set(leaf) == {"q", "s"})


def _qs(leaf):
    return (leaf.q, leaf.s) if isinstance(leaf, QWeight) else (
        leaf["q"], leaf["s"])


def _quantizable(name: str, t: torch.Tensor) -> bool:
    """Only matmul weights: the name ends in `kernel` or `embedding`, ndim
    >= 2, at least 4096 elements, floating (JAX `_quantizable`: a norm
    scale must stay bf16 whatever its size)."""
    return (name.rsplit(".", 1)[-1] in _QUANT_SUFFIXES and t.dim() >= 2
            and t.numel() >= _MIN_QUANT_SIZE and t.is_floating_point())


def quantize_leaf(w: torch.Tensor) -> dict:
    """{"q": int8, "s": f32} of one weight: per-output-channel scales over
    every axis but the last (a stacked [L, din, dout] weight keeps its
    layer axis: s [L, 1, dout]); round half to even, as jnp.round."""
    w = w.float()
    red = (1,) if w.dim() == 3 else tuple(range(w.dim() - 1))
    s = w.abs().amax(dim=red, keepdim=True) / 127.0
    s = torch.where(s > 0, s, 1.0)
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return {"q": q, "s": s}


def quantize_tree_int8(state: Mapping[str, torch.Tensor]) -> dict:
    """The int8 base of a float state dict, keyed by the same names: each
    quantisable weight -> {"q", "s"}, every other float tensor cast to
    bf16, the rest as it is. `dequantize_tree` inverts it up to the
    rounding."""
    out = {}
    for name, t in state.items():
        if _quantizable(name, t):
            out[name] = quantize_leaf(t)
        else:
            out[name] = t.to(torch.bfloat16) if t.is_floating_point() else t
    return out


def dequant_leaf(leaf, dtype=torch.bfloat16) -> torch.Tensor:
    """A weight in the compute dtype: (q * s) in f32, then cast, for a
    quantised weight; a float tensor cast (so the tree has one dtype)."""
    if is_q(leaf):
        q, s = _qs(leaf)
        return (q.float() * s).to(dtype)
    return leaf.to(dtype) if leaf.is_floating_point() else leaf


def dequantize_tree(qstate: Mapping, dtype=torch.bfloat16) -> dict:
    """The float state of a quantised one, every float leaf in `dtype`."""
    return {k: dequant_leaf(v, dtype) for k, v in qstate.items()}


def flat_state(state: Mapping) -> dict[str, torch.Tensor]:
    """A state dict with each {"q", "s"} weight as `name.q` / `name.s`
    (the keys a `TransformerLM` with `QWeight`s has)."""
    out = {}
    for name, v in state.items():
        if is_q(v):
            q, s = _qs(v)
            out[name + ".q"], out[name + ".s"] = q, s
        else:
            out[name] = v
    return out


def quant_bytes(qstate: Mapping) -> int:
    """The storage footprint of a (quantised) state, in bytes."""
    return sum(t.numel() * t.element_size()
               for t in flat_state(qstate).values())


def synth_quantized_base(shapes: Mapping[str, tuple], generator, *,
                         device=None) -> dict:
    """A random int8 base of the given {name: shape} (the JAX function's
    `jax.eval_shape` tree), built int8 directly so that no float init is
    ever materialised (a 7B f32 init is 28 GB): each quantisable weight
    gets q uniform in [-127, 127] and the constant scale
    sqrt(3 / fan_in) / 127 (s [1, dout], a stacked [L, din, dout] weight
    [L, 1, dout]); every other leaf 0.02 * N(0, 1) in bf16. Values are
    drawn from `generator` on `device`, in key order."""
    from .._device import resolve_device

    dev = resolve_device(device)
    out = {}
    for name, shape in shapes.items():
        shape = tuple(shape)
        meta = torch.empty(shape, device="meta")
        if not _quantizable(name, meta):
            out[name] = (0.02 * torch.randn(shape, generator=generator,
                                            device=dev)).to(torch.bfloat16)
            continue
        q = torch.randint(-127, 128, shape, generator=generator,
                          device=dev, dtype=torch.int8)
        fan_in = shape[-2]
        s_shape = ((shape[0], 1, shape[-1]) if len(shape) == 3
                   else (1,) * (len(shape) - 1) + shape[-1:])
        s = torch.full(s_shape, (3.0 / max(fan_in, 1)) ** 0.5 / 127.0,
                       dtype=torch.float32, device=dev)
        out[name] = {"q": q, "s": s}
    return out


# ---- the LLaMA block math, shared by the training forward and the decode
# path (one implementation, so dequant / LoRA-merge semantics cannot drift).
# A tensor-parallel shard (`llm/tp.py`) sets `tp` (a
# `parallel.tensor.TPContext`) on the model and its blocks: the helpers
# then run the Megatron split, with replicated adapters cut to the shard
# (a column kernel takes b's column block, a row kernel a's row block).
_ROW_KERNELS = ("wo", "w_down")


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


def embed_rows(embedding, tokens: torch.Tensor,
               dtype: torch.dtype, tp=None) -> torch.Tensor:
    """The embedding rows of `tokens` in the compute dtype. A quantised
    embedding gathers its int8 rows, then dequantises them: elementwise,
    so bitwise the JAX package's dequantise-then-gather. A shard of the
    embedding's columns (`tp`) gathers the other ranks' columns."""
    if is_q(embedding):
        q, s = _qs(embedding)
        return gather((q[tokens].float() * s).to(dtype), tp)
    return gather(embedding[tokens].to(dtype), tp)


def local_adapter(ab: dict, name: str, shape, tp) -> dict:
    """A replicated adapter of kernel `name` cut to the kernel's shard of
    `shape` [din, dout] on this rank of `tp`: a's row block for a row-split
    kernel (wo, w_down), b's column block for the column-split ones; an
    adapter already cut (or no `tp`) passes through."""
    if tp is None or tp.size == 1:
        return ab
    if name in _ROW_KERNELS:
        if ab["a"].shape[0] == shape[0]:
            return ab
        return {"a": ab["a"][tp.block(ab["a"].shape[0])], "b": ab["b"]}
    if ab["b"].shape[1] == shape[1]:
        return ab
    return {"a": ab["a"], "b": ab["b"][:, tp.block(ab["b"].shape[1])]}


def merged_kernel(block, ad_l, name: str, rank_scale: float,
                  dtype: torch.dtype) -> torch.Tensor:
    """`block.<name>.kernel` in the compute dtype with its LoRA delta
    merged: a quantised kernel is dequantised to `dtype` and the delta
    added in `dtype` (the JAX order); a float kernel has the delta merged
    in its stored dtype (`llm.lora.merge_delta`), then is cast."""
    w = getattr(block, name).kernel
    ab = ad_l.get(name) if ad_l else None
    if ab is not None:
        ab = local_adapter(ab, name, _qs(w)[0].shape if is_q(w)
                           else w.shape, getattr(block, "tp", None))
    if is_q(w):
        w = dequant_leaf(w, dtype)
        return w if ab is None else merge_delta(w, ab, rank_scale)
    if ab is not None:
        w = merge_delta(w, ab, rank_scale)
    return w.to(dtype)


def project_qkv(block, ad_l, rank_scale: float, h: torch.Tensor,
                n_heads: int, dtype: torch.dtype):
    """Pre-norm hidden [B, T, D] -> per-head q, k, v [B, T, H, Dh] (RoPE
    is the caller's: train and decode place positions differently). On a
    tensor-parallel shard `n_heads` is the rank's own heads."""
    b, t = h.shape[:2]
    h = copy_in(h, getattr(block, "tp", None))
    return tuple((h @ merged_kernel(block, ad_l, n, rank_scale, dtype))
                 .reshape(b, t, n_heads, -1) for n in ("wq", "wk", "wv"))


def attn_out(block, ad_l, rank_scale: float, x: torch.Tensor,
             o: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x + W_o o for the attention output o [B, T, H, Dh]; a shard's
    row-split W_o gives a partial sum, all-reduced over the axis."""
    w = merged_kernel(block, ad_l, "wo", rank_scale, dtype)
    return x + reduce_out(o.flatten(-2) @ w, getattr(block, "tp", None))


def swiglu_mlp(block, ad_l, rank_scale: float, x: torch.Tensor,
               dtype: torch.dtype, eps: float = 1e-6) -> torch.Tensor:
    """x + W_down(silu(W_gate h) * W_up h), h = RMSNorm_1(x); a shard
    holds a column block of gate / up and W_down's matching rows, whose
    partial sum is all-reduced over the axis."""
    tp = getattr(block, "tp", None)
    h = copy_in(rms_norm(x, block.RMSNorm_1.scale.to(dtype), eps), tp)
    gate = h @ merged_kernel(block, ad_l, "w_gate", rank_scale, dtype)
    up = h @ merged_kernel(block, ad_l, "w_up", rank_scale, dtype)
    return x + reduce_out((F.silu(gate) * up) @ merged_kernel(
        block, ad_l, "w_down", rank_scale, dtype), tp)


def lm_head_logits(model, top_ads, rank_scale: float, x: torch.Tensor,
                   dtype: torch.dtype, eps: float = 1e-6) -> torch.Tensor:
    """Final norm and LM head; a shard's column block of the head gives
    its block of the vocabulary, gathered over the axis."""
    tp = getattr(model, "tp", None)
    x = copy_in(rms_norm(x, model.final_norm.scale.to(dtype), eps), tp)
    return gather(x @ merged_kernel(model, top_ads, "lm_head", rank_scale,
                                    dtype), tp)


# ------------------------------------------------- training over the base
def inscan_model(qbase, n_heads: int, *, attn_fn=None, remat: bool = True,
                 eps: float = 1e-6):
    """The `TransformerLM` `make_inscan_quant_apply` runs over a
    (quantised) state dict, sharing its tensors, its dims read from the
    state's shapes; a `TransformerLM` is taken as it is. Build it outside
    any torch.func transform: its parameters are new tensor objects, and
    one made inside a transform belongs to that transform's level."""
    from .transformer import TransformerLM, dims_of_state

    if isinstance(qbase, TransformerLM):
        return qbase
    return TransformerLM.from_state(dims_of_state(qbase, n_heads), qbase,
                                    attn_fn=attn_fn, remat=remat, eps=eps)


def make_inscan_quant_apply(n_heads: int, attn_fn=None, alpha: float = 16.0,
                            remat: bool = True, dtype=torch.bfloat16,
                            eps: float = 1e-6):
    """apply(qbase, adapters, tokens, pos_offset=0) -> logits [B, T, V] in
    `dtype`: the forward over an int8 base that dequantises and merges one
    layer at a time, inside the layer loop (the JAX package's in-scan
    form). `qbase` is `quantize_tree_int8` of the port's state (or a float
    state), or the `TransformerLM` `inscan_model` builds over it, which is
    what a call under `torch.func.grad` / `vmap` takes; `adapters` an
    `llm.lora` adapter dict, which gradients reach through the loop.
    `remat` recomputes each block in the backward (`transformer.remat`),
    dequantisation included, so at most one layer's dense weights are
    alive at a time. `attn_fn` ([B, T, H, Dh] q/k/v -> o; default dense
    causal attention) may be a sequence-parallel attention bound to a mesh
    axis (`parallel.seq`), with `pos_offset` the chunk's global position
    so that RoPE and the causal mask see global positions."""

    def apply(qbase, adapters, tokens, pos_offset=0):
        model = inscan_model(qbase, n_heads, attn_fn=attn_fn, remat=remat,
                             eps=eps)
        return model(tokens, pos_offset=pos_offset, adapters=adapters,
                     alpha=alpha, dtype=dtype)

    return apply


def lora_apply_fn_quant(apply_fn, alpha: float = 16.0):
    """`llm.lora.lora_apply_fn` over an int8 base: `apply_fn` is a
    `TransformerLM` over the quantised state (or its
    `models.hub.mixed_precision_apply` wrap, which gives the compute
    dtype), and every adapted kernel is dequantised and merged inside its
    block on each call. Gradients reach only the adapters."""
    from .lora import lora_apply_fn

    return lora_apply_fn(apply_fn, alpha)
