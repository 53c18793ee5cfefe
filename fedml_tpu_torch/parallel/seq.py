"""Sequence parallelism: ring attention and Ulysses (port of
`fedml_tpu/parallel/seq.py`).

A sequence is sharded contiguously over the `seq` axis of a
`DeviceMesh` (`parallel/mesh.py`): rank i of the axis holds tokens
[i * T_local, (i + 1) * T_local). The JAX functions run inside a
`shard_map` body and name the mesh axis; these run SPMD in every rank of
the axis's process group, the same call in each.

- `ring_attention`: each rank keeps its Q chunk and the K/V chunks rotate
  around the ring (`batch_isend_irecv` to the next rank, from the
  previous) while an online-softmax accumulator (`_merge_block`, the
  flash-attention recurrence) merges each block. The rotation is an
  autograd function whose backward rotates the gradient the other way
  (the transpose of JAX's `ppermute`), so the backward rides the same
  ring.
- `ulysses_attention`: an all-to-all re-shards [B, T/n, H, D] into
  [B, T, H/n, D], dense causal attention runs on whole sequences a head
  group, and a second all-to-all shards the output back. The all-to-all
  is an autograd function too (its transpose is itself). It needs
  H % n == 0.

Both equal dense causal attention over the whole sequence and are
differentiable. Their arithmetic is plain PyTorch, as the JAX package's
is XLA einsums outside Pallas. Q/K/V come in [B, T, H, D] with RoPE
already applied at global positions (the model passes pos_offset =
seq index * T_local). Gloo moves host memory: a CUDA tensor on a gloo
group is staged through the host, as `mesh.all_reduce_sum` does.
"""
from __future__ import annotations

import torch

from ..ops import cost

_NEG = -1e9  # finite "-inf": keeps exp() NaN-free for fully-masked rows


def dense_causal_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, q_offset: int = 0,
                           k_offset: int = 0) -> torch.Tensor:
    """Reference causal attention. q/k/v: [B, T, H, D] -> [B, T, H, D].
    Offsets give the global position of element 0 (used when chunks of a
    sharded sequence are compared). The whole-sequence form is
    `_DenseCausal`, which a cost-ledger capture counts as the flash
    kernels' work (`ops/cost.py`)."""
    if q_offset == k_offset == 0 and q.shape[1] == k.shape[1]:
        return _DenseCausal.apply(q, k, v)[0]
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    qpos = q_offset + torch.arange(q.shape[1], device=q.device)
    kpos = k_offset + torch.arange(k.shape[1], device=q.device)
    mask = qpos[:, None] >= kpos[None, :]
    s = torch.where(mask, s, _NEG)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


def _dense_fwd(q, k, v):
    """(o, p): causal attention over the whole sequence and its softmax
    [B, H, T, T], counted by a capture as K1's work."""
    b, t, h, d = q.shape
    with cost.region(lambda: cost.flash_cost("fwd", b * h, t, d,
                                             q.element_size())):
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * d ** -0.5
        pos = torch.arange(t, device=q.device)
        s = torch.where(pos[:, None] >= pos[None, :], s, _NEG)
        p = torch.softmax(s, -1)
        return torch.einsum("bhqk,bkhd->bqhd", p, v), p


def _dense_bwd(q, k, v, p, do):
    """(dQ, dK, dV) of `_dense_fwd` from its softmax p, counted by a
    capture as K2's and K3's work. A masked entry has p = 0, so its dS is
    0 as the mask's own gradient would make it."""
    b, t, h, d = q.shape
    es = q.element_size()

    def work():
        qb, qf = cost.flash_cost("dq", b * h, t, d, es)
        kb, kf = cost.flash_cost("dkv", b * h, t, d, es)
        return qb + kb, qf + kf

    with cost.region(work):
        dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
        dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
        ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * d ** -0.5
        dq = torch.einsum("bhqk,bkhd->bqhd", ds, k)
        dk = torch.einsum("bhqk,bqhd->bkhd", ds, q)
    return dq, dk, dv


def _fold(x: torch.Tensor, dim, g: int) -> torch.Tensor:
    """A vmapped [B, ...] operand as one [g * B, ...] tensor (an unbatched
    operand broadcast to g)."""
    x = (x.unsqueeze(0).expand(g, *x.shape) if dim is None
         else x.movedim(dim, 0))
    return x.reshape((g * x.shape[1],) + tuple(x.shape[2:]))


def _unfold(x: torch.Tensor, g: int) -> torch.Tensor:
    return x.reshape((g, x.shape[0] // g) + tuple(x.shape[1:]))


class _DenseCausal(torch.autograd.Function):
    """(o, p) = whole-sequence causal attention, differentiable in q, k
    and v, with its backward (`_DenseCausalBackward`) written out: a
    capture sees both passes and counts each by the flash kernels' cost
    functions, so the ledger's FLOPs do not depend on which attention ran.
    Under `torch.func.vmap` the rule folds the vmapped dim into B (a batch
    row depends on no other), so the count sees the group's shape."""

    @staticmethod
    def forward(q, k, v):
        return _dense_fwd(q, k, v)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs, output[1])
        ctx.mark_non_differentiable(output[1])

    @staticmethod
    def backward(ctx, do, _dp):
        return _DenseCausalBackward.apply(*ctx.saved_tensors, do)

    @staticmethod
    def vmap(info, in_dims, q, k, v):
        g = info.batch_size
        o, p = _dense_fwd(*(_fold(x, d, g) for x, d in
                            zip((q, k, v), in_dims)))
        return (_unfold(o, g), _unfold(p, g)), (0, 0)


class _DenseCausalBackward(torch.autograd.Function):
    """(dQ, dK, dV) of `_DenseCausal`, with the same fold-into-B rule under
    `torch.func.vmap`. Not differentiable again."""

    @staticmethod
    def forward(q, k, v, p, do):
        return _dense_bwd(q, k, v, p, do)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "dense causal attention has no second derivative")

    @staticmethod
    def vmap(info, in_dims, q, k, v, p, do):
        g = info.batch_size
        grads = _dense_bwd(*(_fold(x, d, g) for x, d in
                             zip((q, k, v, p, do), in_dims)))
        return tuple(_unfold(x, g) for x in grads), (0, 0, 0)


def _merge_block(carry, q, k, v, qpos0: int, kpos0: int, scale: float):
    """One online-softmax accumulation step (running max m, normaliser
    l, unnormalised output o), in f32."""
    o, m, l = carry
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale          # [B,H,Tq,Tk]
    qpos = qpos0 + torch.arange(q.shape[1], device=q.device)
    kpos = kpos0 + torch.arange(k.shape[1], device=q.device)
    s = torch.where(qpos[:, None] >= kpos[None, :], s, _NEG)
    m_new = torch.maximum(m, s.amax(-1))                       # [B,H,Tq]
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    # fully-masked entries contribute exp(_NEG - m_new) ~ 0 once a real
    # block has been seen; before that they add mass that the next corr
    # factor exp(_NEG - m_real) zeroes out
    l = l * corr + p.sum(-1)
    o = o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v)
    return o, m_new, l


def _group(mesh, axis: str):
    import torch.distributed as dist

    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    return group, n, dist.get_rank(group)


def _staged(t: torch.Tensor, group) -> bool:
    import torch.distributed as dist

    return t.is_cuda and dist.get_backend(group) == "gloo"


def _shift(tensors, group, step: int) -> list:
    """Each tensor sent to the rank `step` places on along the group's
    ring and replaced by the one from the rank `step` places back (step
    1: to the next, from the previous)."""
    import torch.distributed as dist

    n, me = dist.get_world_size(group), dist.get_rank(group)
    if n == 1:
        return [t.clone() for t in tensors]
    to = dist.get_global_rank(group, (me + step) % n)
    frm = dist.get_global_rank(group, (me - step) % n)
    stage = _staged(tensors[0], group)
    srcs = [(t.cpu() if stage else t).contiguous() for t in tensors]
    outs = [torch.empty_like(s) for s in srcs]
    ops = []
    for s, o in zip(srcs, outs):
        ops.append(dist.P2POp(dist.isend, s, to, group))
        ops.append(dist.P2POp(dist.irecv, o, frm, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [o.to(t.device) for o, t in zip(outs, tensors)]


class _Rotate(torch.autograd.Function):
    """(k, v) of the rank `step` places back on the ring; the backward
    sends each gradient back to the rank its value came from (the same
    function at -step, so that a backward under `torch.func.vjp`, whose
    gradients are that transform's tensors, sends plain tensors)."""

    @staticmethod
    def forward(group, step, k, v):
        return tuple(_shift((k, v), group, step))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group, ctx.step = inputs[0], inputs[1]

    @staticmethod
    def backward(ctx, gk, gv):
        return (None, None) + _Rotate.apply(ctx.group, -ctx.step, gk, gv)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh, axis: str = "seq") -> torch.Tensor:
    """Causal ring attention over the `axis` group of `mesh`. q/k/v:
    [B, T_local, H, D], this rank's contiguous chunk of a sequence
    sharded over the axis; returns its output chunk [B, T_local, H, D],
    equal to dense causal attention over the whole sequence. At step s
    this rank holds the K/V chunk of rank (me - s) mod n; n steps visit
    every chunk once (n - 1 rotations). Fully-future blocks are computed
    and masked, as in the JAX function."""
    group, n, me = _group(mesh, axis)
    t = q.shape[1]
    scale = q.shape[-1] ** -0.5
    qf = q.float()
    z = torch.einsum("bqhd->bhqd", qf) * 0.0
    acc = (z, z.sum(-1) + _NEG, z.sum(-1))
    kk, vv = k, v
    for i in range(n):
        src = (me - i) % n
        acc = _merge_block(acc, qf, kk.float(), vv.float(), me * t, src * t,
                           scale)
        if i < n - 1:
            kk, vv = _Rotate.apply(group, 1, kk, vv)
    o, _m, l = acc
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return torch.einsum("bhqd->bqhd", out).to(q.dtype)


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    """All-to-all of x [n, ...]: row j goes to rank j of the group, and
    row j of the result came from rank j."""
    import torch.distributed as dist

    stage = _staged(x, group)
    src = (x.cpu() if stage else x).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(x.device)


class _AllToAll(torch.autograd.Function):
    """`_exchange`, whose transpose is itself: row j of rank r goes to
    row r of rank j, and the gradient goes back the same way (through
    this function again, as `_Rotate`'s does)."""

    @staticmethod
    def forward(group, x):
        return _exchange(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[0]

    @staticmethod
    def backward(ctx, g):
        return None, _AllToAll.apply(ctx.group, g)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh, axis: str = "seq") -> torch.Tensor:
    """Ulysses sequence parallelism over the `axis` group of `mesh`:
    [B, T/n, H, D] -> (all-to-all) [B, T, H/n, D] -> dense causal
    attention -> (all-to-all) [B, T/n, H, D]. Needs H % n == 0."""
    group, n, _me = _group(mesh, axis)
    b, t, h, d = q.shape
    if h % n:
        raise ValueError(
            f"ulysses needs heads ({h}) divisible by the {axis!r} axis "
            f"size ({n})")

    def to_heads(x):     # [B, T/n, H, D] -> [B, T, H/n, D]
        x = x.reshape(b, t, n, h // n, d).permute(2, 0, 1, 3, 4)
        x = _AllToAll.apply(group, x)          # [n: source rank, B, T/n, ..]
        return x.permute(1, 0, 2, 3, 4).reshape(b, n * t, h // n, d)

    o = dense_causal_attention(to_heads(q), to_heads(k), to_heads(v))
    o = o.reshape(b, n, t, h // n, d).permute(1, 0, 2, 3, 4)
    o = _AllToAll.apply(group, o)              # [n: head group, B, T/n, ..]
    return o.permute(1, 2, 0, 3, 4).reshape(b, t, h, d)
