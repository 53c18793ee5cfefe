"""LoRA adapters as a parameter-space transform (port of
`fedml_tpu/llm/lora.py`).

Adapters are a plain dict keyed by the base state's names:
{"blocks.{i}.wq.kernel": {"a": [din, r], "b": [r, dout]}, ...}, both f32.
The merged weight of an adapted kernel is W + (alpha / r) * (A @ B): the
product in f32, cast to W's dtype, scaled in that dtype -- the JAX
module's order, kept because a bf16 base rounds differently under
x @ W + s * (x @ A) @ B. The base never changes; federated rounds train
and exchange the adapters only.
"""
from __future__ import annotations

from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..ops.tree import tree_leaves


def lora_init(params: Mapping[str, torch.Tensor], rank: int = 8,
              targets: Sequence[str] = ("wq", "wk", "wv", "wo"),
              a_std: float = 0.01, *,
              generator: torch.Generator) -> dict:
    """Adapters for every 2-D `kernel` whose name contains one of
    `targets`: A normal with std `a_std`, B zero (the merged model starts
    exactly at the base), both f32 on the kernel's device, A drawn from
    `generator` (which must live on that device)."""
    adapters = {}
    for name, leaf in params.items():
        if leaf.dim() == 2 and name.endswith("kernel") and any(
                t in name for t in targets):
            din, dout = leaf.shape
            adapters[name] = {
                "a": a_std * torch.randn((din, rank), generator=generator,
                                         dtype=torch.float32,
                                         device=leaf.device),
                "b": torch.zeros((rank, dout), dtype=torch.float32,
                                 device=leaf.device),
            }
    if not adapters:
        raise ValueError(
            f"no kernels matched LoRA targets {list(targets)}; available: "
            f"{[n for n, p in params.items() if p.dim() == 2][:10]}")
    return adapters


def merge_delta(w: torch.Tensor, ab: dict, scale: float) -> torch.Tensor:
    """One adapted kernel, W + scale * (A @ B), in the order the module
    docstring gives."""
    return w + scale * (ab["a"] @ ab["b"]).to(w.dtype)


def lora_merge(base: Mapping[str, torch.Tensor], adapters: dict,
               alpha: float = 16.0) -> dict[str, torch.Tensor]:
    """The merged state: W + (alpha/r) * A @ B on adapted kernels, the base
    tensors themselves elsewhere."""
    if not adapters:
        return dict(base)
    rank = next(iter(adapters.values()))["a"].shape[-1]
    scale = alpha / rank
    out = dict(base)
    for name, ab in adapters.items():
        out[name] = merge_delta(base[name], ab, scale)
    return out


def lora_apply_fn(apply_fn: Callable, alpha: float = 16.0) -> Callable:
    """(adapters, x) -> logits over the frozen base that `apply_fn` holds:
    apply_fn(x, adapters=..., alpha=...) is a `TransformerLM` (or its
    `models.hub.mixed_precision_apply` wrap), which merges each adapted
    kernel inside its block -- the values `lora_merge` gives, without a
    merged copy of the whole base."""

    def wrapped(adapters, x):
        return apply_fn(x, adapters=adapters, alpha=alpha)

    return wrapped


def count_params(tree) -> int:
    return sum(t.numel() for t in tree_leaves(tree))


def adapters_from_jax(adapters: Mapping, device=None) -> dict:
    """The JAX package's adapter tree (numpy-convertible leaves) -> this
    module's adapter dict on `device` (CUDA unless "cpu"). Takes both
    layouts: unrolled (`block_{i}/wq/kernel`) and scan-stacked
    (`blocks/wq/kernel` with a leading [L] axis)."""
    dev = resolve_device(device)
    out = {}

    def put(name, ab, i=None):
        out[name] = {k: torch.from_numpy(np.array(
            v if i is None else np.asarray(v)[i], np.float32)).to(dev)
            for k, v in ab.items()}

    for path, ab in adapters.items():
        head, _, rest = path.partition("/")
        rest = rest.replace("/", ".")
        if head == "blocks":
            for i in range(np.asarray(ab["a"]).shape[0]):
                put(f"blocks.{i}.{rest}", ab, i)
        elif head.startswith("block_"):
            put(f"blocks.{head[len('block_'):]}.{rest}", ab)
        else:
            put(path.replace("/", "."), ab)
    return out
