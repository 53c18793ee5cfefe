"""FedLLM at scale: tensor parallelism x LoRA x ring attention x remat
(port of `fedml_tpu/llm/scale.py`).

The composition, run SPMD over a `DeviceMesh` with any of the axes `dp`,
`tp` and `seq`:
- the FROZEN base is the rank's tensor-parallel shard over `tp`
  (`llm/tp.py`: Megatron blocks, one all-reduce after wo and after
  w_down), float in the compute dtype or int8 (`llm/quant.py`);
- the LoRA adapters are REPLICATED (the federated round payload and the
  only trained state); each block cuts them to its shard, so each rank
  holds its slice's share of an adapter gradient, and the step sums the
  gradients over `tp` (one all-reduce a step), then over `dp` and `seq`;
- the batch's rows split over `dp` and its tokens over `seq`: attention
  is ring attention over the seq group (`parallel/seq.py`) on the rank's
  own heads, with RoPE and the causal mask at global positions
  (pos_offset = seq index x T_local);
- every block is recomputed in the backward (`transformer.remat`).

The JAX package's three layouts and its refusal of the fourth are kept.
The port's forward is one loop over the blocks whatever the layout, so
`scan_layers` changes nothing but that check; with `quantize_base` each
block dequantises its int8 shard at use, inside the remat (the JAX
in-scan form).

Init: without `base=`, each rank draws ONLY its own shard (a generator
seeded by the seed and its tp coordinate), so the full base never exists
on one rank. The port cannot reproduce flax's draws, so a parity run
injects a full `base=` (the port's state dict, float or
`quantize_tree_int8`'s) and `adapters=`, which each rank cuts to its
shard.

Sharded base checkpoint: `save_base_sharded` writes one file of local
shards per tp coordinate (the ranks at coordinate 0 of every other axis
write) and a meta file with the spec table and the mesh shape;
`restore_base_sharded` reads the rank's own file back and refuses a
checkpoint of another layout (the JAX package's orbax restore targets
the same layout too).
"""
from __future__ import annotations

import functools
import json
import math
import os
from typing import Any, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .._device import resolve_device
from ..parallel import mesh as mesh_mod
from ..parallel import partition
from ..parallel.seq import ring_attention
from ..parallel.tensor import TPContext
from .lora import lora_init
from .quant import _quantizable, quantize_tree_int8
from .tp import shard_params_tp, tp_param_specs
from .transformer import ModelDims

Pytree = Any
_META = "meta.json"


def _axis_names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names or ())


def make_ring_attn_fn(mesh, seq_axis: str = "seq",
                      dp_axis: Optional[str] = "dp",
                      tp_axis: Optional[str] = "tp"):
    """attn_fn for a TransformerLM shard: ring attention over `seq_axis`
    on the rank's [B_local, T_local, H_local, Dh] q/k/v (the batch block
    of `dp_axis` and the heads of `tp_axis` are already the rank's). An
    axis NAME that is not in the mesh is an error, not a silent
    replication; pass None to leave that dimension unsharded."""
    names = _axis_names(mesh)
    for what, ax in (("seq_axis", seq_axis), ("dp_axis", dp_axis),
                     ("tp_axis", tp_axis)):
        if ax is not None and ax not in names:
            raise ValueError(
                f"{what}={ax!r} is not an axis of mesh {names}; "
                f"pass {what}=None to leave that dimension unsharded")
    return functools.partial(ring_attention, mesh=mesh, axis=seq_axis)


def state_shapes(dims: ModelDims) -> dict:
    """{state name: full shape} of a TransformerLM of `dims`."""
    d, ff, v = dims.d_model, dims.d_ff, dims.vocab_size
    out = {"embed.embedding": (v, d)}
    for i in range(dims.n_layers):
        p = f"blocks.{i}."
        out[p + "RMSNorm_0.scale"] = (d,)
        out[p + "RMSNorm_1.scale"] = (d,)
        for n in ("wq", "wk", "wv", "wo"):
            out[p + n + ".kernel"] = (d, d)
        out[p + "w_gate.kernel"] = (d, ff)
        out[p + "w_up.kernel"] = (d, ff)
        out[p + "w_down.kernel"] = (ff, d)
    out["final_norm.scale"] = (d,)
    out["lm_head.kernel"] = (d, v)
    return out


def _local_shape(shape, spec, sizes: dict) -> tuple:
    return tuple(n // sizes[ax] if ax is not None else n
                 for n, ax in zip(shape, tuple(spec) + (None,) * len(shape)))


def init_base_shard(dims: ModelDims, mesh, tp_axis: Optional[str], *,
                    seed: int = 0, quantize: bool = False,
                    dtype=torch.bfloat16, device=None) -> dict:
    """This rank's shard of a random base, drawn at its local shapes only
    from a generator seeded by (seed, tp coordinate). Float: the
    `transformer.init_params` scales at the full fan-in, in `dtype`.
    int8 (`quantize`): the `quant.synth_quantized_base` rule, q uniform in
    [-127, 127] and s = sqrt(3 / fan_in) / 127 at the full fan-in, a
    replicated scale whole; every other leaf 0.02 * N(0, 1) in bf16."""
    dev = resolve_device(device)
    k = mesh_mod.axis_index(mesh, tp_axis) if tp_axis else 0
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) * 1_000_003 + k)
    sizes = {ax: mesh_mod.axis_size(mesh, ax) for ax in _axis_names(mesh)}
    shapes = state_shapes(dims)
    meta = {n: torch.empty(s, device="meta") for n, s in shapes.items()}
    ax = tp_axis or "tp"
    out = {}
    for name, shape in shapes.items():
        spec = (tp_param_specs({name: meta[name]}, ax)[name] if tp_axis
                else partition.P())
        local = _local_shape(shape, spec, sizes)
        if quantize and _quantizable(name, meta[name]):
            s_meta = torch.empty((1, shape[-1]), device="meta")
            s_spec = tp_param_specs({name: {"q": meta[name], "s": s_meta}},
                                    ax)[name]["s"]
            split = bool(tp_axis) and len(s_spec) and s_spec[-1] is not None
            q = torch.randint(-127, 128, local, generator=gen, device=dev,
                              dtype=torch.int8)
            s = torch.full((1, local[-1] if split else shape[-1]),
                           math.sqrt(3.0 / shape[-2]) / 127.0,
                           dtype=torch.float32, device=dev)
            out[name] = {"q": q, "s": s}
        elif quantize:
            out[name] = (0.02 * torch.randn(local, generator=gen,
                                            device=dev)).to(torch.bfloat16)
        elif name.endswith(".scale"):
            out[name] = torch.ones(local, dtype=dtype, device=dev)
        elif name == "embed.embedding":
            out[name] = (torch.randn(local, generator=gen, device=dev)
                         / math.sqrt(dims.d_model)).to(dtype)
        else:
            std = 1.0 / math.sqrt(shape[0]) / 0.87962566103423978
            w = torch.empty(local, dtype=torch.float32, device=dev)
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=gen)
            out[name] = w.to(dtype)
    return out


def _shape_leaves(dims: ModelDims, device) -> dict:
    """Zero-stride stand-ins of the full kernels (no memory): what
    `lora_init` reads of a base is its names, shapes and device."""
    z = torch.zeros((), device=device)
    return {n: z.expand(s) for n, s in state_shapes(dims).items()
            if len(s) == 2}


def build_scaled_fedllm(model_cls, mesh, *, vocab_size: int, d_model: int,
                        n_layers: int, n_heads: int, d_ff: int,
                        rank: int = 8, alpha: float = 16.0,
                        lr: float = 1e-3, seq_axis: Optional[str] = "seq",
                        dp_axis: str = "dp",
                        compute_dtype: str = "bfloat16",
                        scan_layers: bool = False,
                        quantize_base: bool = False,
                        rng: Optional[int] = None,
                        base: Optional[dict] = None,
                        adapters: Optional[dict] = None, attn_fn=None,
                        device=None):
    """(model, base, adapters, step_fn), run SPMD in every rank of `mesh`:
    step_fn(adapters, tokens, targets) -> (adapters, loss) trains ONLY the
    adapters on the global batch tokens / targets [B, T] (every rank
    passes the whole batch and computes its dp x seq block) against the
    rank's tp shard of the frozen base, with ring attention over `seq`
    and remat; loss is the global mean token cross-entropy, the update
    SGD at `lr`. `model` is the rank's `model_cls` shard (a
    TransformerLM), `base` its shard of the base.

    `rng` is the seed (default 0) of the init draws: each rank's base
    shard and the replicated adapters. `base=` / `adapters=` inject a
    full base (the port's state dict; quantised here when
    `quantize_base` and it is float) and full adapters instead.
    `scan_layers` and `quantize_base` are the JAX knobs: scan layers with
    the seq axis needs the int8 base (the JAX package's words below).
    `attn_fn` (a port addition) is the attention of a mesh without the
    seq axis, on the rank's heads: `ops.flash_attention.flash_attn_fn`
    runs the flash kernels there (default dense causal attention)."""
    names = _axis_names(mesh)
    seed = 0 if rng is None else int(rng)
    dev = resolve_device(device)
    has_seq = bool(seq_axis) and seq_axis in names
    inscan = scan_layers and has_seq
    if inscan and not quantize_base:
        raise ValueError(
            "scan_layers composes with the ring-attention seq axis only "
            "through the int8 in-scan path (quantize_base=True): flax "
            "nn.scan's broadcast-constant tracing rejects a shard_map "
            "island inside the scanned block ('broadcasted variable has a "
            "data dependency on the scan body'), but quant.make_inscan_"
            "quant_apply's hand-written lax.scan accepts one. Pick one: "
            "quantize_base=True (in-scan int8 + ring — the long-context "
            "deep-model layout), seq_axis=None (scan + TP + dp; attention "
            "stays per-chip), or scan_layers=False (unrolled blocks + ring "
            "attention).")
    tp_axis = "tp" if "tp" in names else None
    if has_seq and attn_fn is not None:
        raise ValueError("attn_fn is the attention of a mesh without the "
                         f"seq axis; this mesh rings over {seq_axis!r}")
    attn = (make_ring_attn_fn(mesh, seq_axis=seq_axis, dp_axis=dp_axis,
                              tp_axis=tp_axis) if has_seq else attn_fn)
    dims = ModelDims(vocab_size=vocab_size, d_model=d_model,
                     n_layers=n_layers, n_heads=n_heads, d_ff=d_ff)
    dtype = getattr(torch, compute_dtype)
    if base is None:
        shard = init_base_shard(dims, mesh, tp_axis, seed=seed,
                                quantize=quantize_base, dtype=dtype,
                                device=dev)
    else:
        full = dict(base)
        if quantize_base and not any(isinstance(v, dict)
                                     for v in full.values()):
            full = quantize_tree_int8(full)
        elif not quantize_base:
            full = {k: v.to(dtype) if v.is_floating_point() else v
                    for k, v in full.items()}
        full = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                    if isinstance(v, dict) else v.to(dev))
                for k, v in full.items()}
        shard = (shard_params_tp(full, mesh, tp_axis) if tp_axis
                 else full)
        del full
    if adapters is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 1)
        adapters = lora_init(_shape_leaves(dims, dev), rank=rank,
                             generator=gen)
    else:
        adapters = {k: {kk: vv.to(dev) for kk, vv in ab.items()}
                    for k, ab in adapters.items()}
    tp = TPContext(mesh, tp_axis) if tp_axis else None
    model = model_cls.from_state(dims, shard, attn_fn=attn, remat=True,
                                 tp=tp)
    ax_dp = dp_axis if dp_axis in names else None
    ax_seq = seq_axis if has_seq else None
    reduce_grads = [a for a in (tp_axis, ax_dp, ax_seq)
                    if a and mesh_mod.axis_size(mesh, a) > 1]
    reduce_sums = [a for a in (ax_dp, ax_seq)
                   if a and mesh_mod.axis_size(mesh, a) > 1]

    def block(x):
        """The rank's dp rows and seq columns of a global [B, T] array."""
        if ax_dp:
            x = x[mesh_mod.client_share(mesh, x.shape[0], ax_dp)]
        if ax_seq:
            x = x[:, mesh_mod.client_share(mesh, x.shape[1], ax_seq)]
        return x

    def step(ads, tokens, targets):
        x, y = block(tokens), block(targets)
        off = (mesh_mod.axis_index(mesh, ax_seq) * x.shape[1] if ax_seq
               else 0)
        keys = sorted(ads)
        leaves = [ads[k][c].detach().requires_grad_(True)
                  for k in keys for c in ("a", "b")]
        p = {k: {"a": leaves[2 * i], "b": leaves[2 * i + 1]}
             for i, k in enumerate(keys)}
        with torch.enable_grad():
            logits = model(x, pos_offset=off, adapters=p, alpha=alpha,
                           dtype=dtype)
            lsum = F.cross_entropy(
                logits.float().reshape(-1, logits.shape[-1]),
                y.reshape(-1).long(), reduction="sum")
            grads = list(torch.autograd.grad(lsum, leaves))
        for ax in reduce_grads:
            mesh_mod.all_reduce_sum(grads, mesh, ax)
        stat = [lsum.detach().reshape(1)]
        for ax in reduce_sums:
            mesh_mod.all_reduce_sum(stat, mesh, ax)
        n = float(targets.numel())
        g = iter(grads)
        new = {k: {c: (ads[k][c] - lr * next(g) / n).detach()
                   for c in ("a", "b")} for k in keys}
        return new, stat[0][0] / n

    return model, shard, adapters, step


# ---------------------------------------------------- sharded checkpointing
def _layout(mesh, tp_axis: Optional[str]) -> dict:
    return {"mesh": {ax: mesh_mod.axis_size(mesh, ax)
                     for ax in _axis_names(mesh)},
            "tp_axis": tp_axis}


def _spec_table(base: Pytree, tp_axis: Optional[str]) -> dict:
    specs = tp_param_specs(base, tp_axis or "tp")
    return {partition.path_name(p): list(s) if tp_axis else []
            for p, s in partition._flatten(specs)}


def _shard_file(path: str, k: int, n: int) -> str:
    return os.path.join(path, f"shard-{k}-of-{n}.pt")


def save_base_sharded(path: str, base: Pytree, mesh,
                      tp_axis: Optional[str] = "tp") -> None:
    """Write the rank's base shard: the ranks at coordinate 0 of every
    axis but `tp_axis` each write their tp coordinate's file of host
    tensors, the first of them also the meta file (layout and spec
    table). Collective: every rank of the mesh calls it, and it returns
    once every file is written."""
    tp_axis = tp_axis if tp_axis in _axis_names(mesh) else None
    k = mesh_mod.axis_index(mesh, tp_axis) if tp_axis else 0
    n = mesh_mod.axis_size(mesh, tp_axis) if tp_axis else 1
    writer = all(mesh_mod.axis_index(mesh, ax) == 0
                 for ax in _axis_names(mesh) if ax != tp_axis)
    if writer:
        os.makedirs(path, exist_ok=True)
        host = {name: ({kk: vv.detach().cpu() for kk, vv in v.items()}
                       if isinstance(v, dict) else v.detach().cpu())
                for name, v in base.items()}
        torch.save(host, _shard_file(path, k, n))
        if k == 0:
            with open(os.path.join(path, _META), "w") as f:
                json.dump({**_layout(mesh, tp_axis),
                           "specs": _spec_table(base, tp_axis)}, f,
                          indent=1, sort_keys=True)
    mesh_mod.barrier(mesh)


def restore_base_sharded(path: str, template: Pytree, mesh,
                         tp_axis: Optional[str] = "tp",
                         device=None) -> Pytree:
    """The rank's base shard, read back from `save_base_sharded`'s files
    onto `device` (CUDA unless "cpu"). `template` (the base or its shard,
    any leaves with shapes) names the leaves. A checkpoint written on
    another mesh shape, over another tp axis or with another spec table
    is refused: shards restore only onto the layout that wrote them."""
    dev = resolve_device(device)
    tp_axis = tp_axis if tp_axis in _axis_names(mesh) else None
    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)
    want = _layout(mesh, tp_axis)
    saved = {"mesh": meta["mesh"], "tp_axis": meta["tp_axis"]}
    if saved != want:
        raise ValueError(
            f"sharded base checkpoint {path!r} was written on layout "
            f"{saved}; this mesh is {want} — shards restore only onto the "
            "layout that wrote them")
    if meta["specs"] != _spec_table(template, tp_axis):
        raise ValueError(
            f"sharded base checkpoint {path!r} holds another spec table "
            "than the template resolves to (a different model or rule "
            "table)")
    k = mesh_mod.axis_index(mesh, tp_axis) if tp_axis else 0
    n = mesh_mod.axis_size(mesh, tp_axis) if tp_axis else 1
    host = torch.load(_shard_file(path, k, n), map_location="cpu",
                      weights_only=True)
    return {name: ({kk: vv.to(dev) for kk, vv in v.items()}
                   if isinstance(v, dict) else v.to(dev))
            for name, v in host.items()}

