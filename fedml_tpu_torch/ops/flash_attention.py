"""Causal flash attention: the port of `fedml_tpu/ops/flash_attention.py`.

Contract (the JAX module's):

    flash_attention(q, k, v, block_q=None, block_k=None)
        q/k/v [BH, T, D] float32 or bfloat16 (all alike), contiguous,
        D <= 128 and D % 8 == 0 -> o [BH, T, D] in q's dtype
    flash_attn_fn(q, k, v)
        [B, T, H, D] in and out: the `attn_fn` adapter for `TransformerLM`.
        It folds to [B*H, T, D] with one copy per operand, as the JAX
        adapter does, and unfolds the result.

Query i attends keys j <= i; scores are (q . k) * D^-0.5 in f32, masked
with -1e30. T must be divisible by the block sizes (auto-chosen as in the
JAX module when omitted). The block sizes set the plain version's
blocking, which the CUDA kernels do not share: they tile by 64 rows and
mask the ragged edge, so only the summation order differs.

Gradients: `flash_attention` is a `torch.autograd.Function`. Its forward
saves q, k, v, o and the per-row log-sum-exp (LSE, [BH, T] f32: the JAX
module's [BH, T/bq, bq] layout served Mosaic's tiling only); its backward
computes delta = rowsum(o * dO) in f32 with plain torch ops, as the JAX
module does outside Pallas, then dQ and dK/dV in two passes.

Each of the three passes has a wrapper -- `flash_fwd` (K1), `flash_dq`
(K2), `flash_dkv` (K3) -- that launches the hand-written kernel in
`csrc/flash_attention.cu` (built at first use, `ops/_build.py`) on a CUDA
tensor, or raises, and on a CPU tensor runs the plain PyTorch version
(`flash_fwd_ref`, `flash_dq_ref`, `flash_dkv_ref`): the Pallas kernels'
blocked math with their rounding points. It never falls back from a kernel
to a plain version. The kernels are chosen by one shape rule. Every head
the contract takes runs the forward on the tensor cores: bf16 on
`flash_fwd_tc_kernel` (`wgmma`), f32 on `flash_fwd_3xtf32_kernel`, where
each f32 product is made of three TF32 `wgmma` passes over a hi/lo split
of both operands (`tf32_split`; `matmul_3xtf32` is its plain emulation),
which keeps about 21 bits, where one TF32 pass would keep 10. The backward
runs on the tensor cores for every head too: bf16 dQ and dK/dV on
`flash_dq_tc_kernel` and `flash_dkv_tc_kernel`, f32 dK/dV on
`flash_dkv_3xtf32_kernel`, and f32 dQ on `flash_dq_3xtf32_kernel`: S and
dS.K in three TF32 passes, dP made exactly on the f64 tensor cores and
rounded once to f32 (`matmul_f64` in the plain version): dQ's first row
is 0 up to dP's rounding, and an f32 sum of dP in another order than the
plain version's puts it past the rule the kernels are held to. Every
kernel takes any D % 8 == 0 on a 64- or 128-column instance (the columns
past D zero-filled). `fwd_route`, `dq_route` and `dkv_route` name each
pass's kernel by its `launch_count` key. The kernels copy 16-byte chunks,
so their operands must start 16-byte aligned (a view at another storage
offset raises a ValueError). `launch_count` counts each kernel's
launches (and nothing else): "fwd_tc" and "fwd_3xtf32" for the two
forwards, "dq_tc" and "dq_3xtf32" for dQ, "dkv_tc" and "dkv_3xtf32" for
dK/dV.

`rowwise_rel_err` (from `ops/tolerance.py`) is the rule the kernels are
held to against their plain versions on the card.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .tolerance import rowwise_rel_err  # noqa: F401  (fa.rowwise_rel_err)

_NEG = -1e30
MAX_D = 128
_KIND = {torch.float32: 0, torch.bfloat16: 1}

launch_count = {"fwd_tc": 0, "fwd_3xtf32": 0, "dq_tc": 0, "dq_3xtf32": 0,
                "dkv_tc": 0, "dkv_3xtf32": 0}

_lib = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention")
        vp, i = ctypes.c_void_p, ctypes.c_int
        for fn, n_ptr in (("fedml_flash_fwd_tc", 5),
                          ("fedml_flash_fwd_3xtf32", 5),
                          ("fedml_flash_dq_tc", 7),
                          ("fedml_flash_dq_3xtf32", 7),
                          ("fedml_flash_dkv_tc", 8),
                          ("fedml_flash_dkv_3xtf32", 8)):
            getattr(lib, fn).argtypes = [vp] * n_ptr + [i] * 4 + [vp]
            getattr(lib, fn).restype = i
        lib.fedml_flash_error_string.argtypes = [i]
        lib.fedml_flash_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _auto_block(t: int, cap: int) -> int:
    """Largest divisor of t reachable by halving from min(cap, t)."""
    b = min(cap, t)
    while t % b:
        b //= 2
    return max(b, 1)


def _blocks(t: int, block_q, block_k) -> tuple[int, int]:
    bq = _auto_block(t, 512) if block_q is None else min(block_q, t)
    bk = _auto_block(t, 1024) if block_k is None else min(block_k, t)
    if t % bq or t % bk:
        raise ValueError(f"seq len {t} must be divisible by block sizes "
                         f"({bq}, {bk})")
    return bq, bk


def _check(q, k, v, *grads) -> None:
    """Raise on anything the kernels do not take (both devices check the
    same contract, so the CPU tests exercise it). `grads` is (do, lse,
    delta) for the backward passes."""
    if q.dim() != 3 or q.dtype not in _KIND:
        raise ValueError(f"q must be [BH, T, D] float32/bfloat16; got "
                         f"{tuple(q.shape)} {q.dtype}")
    same = (k, v) + grads[:1]
    if any(t.shape != q.shape or t.dtype != q.dtype for t in same):
        raise ValueError(
            "k, v (and dO) must match q's shape and dtype "
            f"{tuple(q.shape)} {q.dtype}; got "
            f"{[(tuple(t.shape), t.dtype) for t in same]}")
    d = q.shape[-1]
    if d > MAX_D or d % 8:
        raise ValueError(f"the flash-attention kernels take D <= {MAX_D} "
                         f"with D % 8 == 0; got D={d}")
    for t in grads[1:]:
        if t.dtype != torch.float32 or t.shape != q.shape[:2]:
            raise ValueError(f"lse/delta must be {tuple(q.shape[:2])} "
                             f"float32; got {tuple(t.shape)} {t.dtype}")
    tensors = (q, k, v) + grads
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash_attention operands must share one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attention operands must be contiguous")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention runs on cuda or cpu; got "
                         f"{q.device}")


def _launch(name: str, *tensors, bh: int, t: int, d: int, kind: int) -> None:
    lib = _kernel_lib()
    dev = tensors[0].device
    with torch.cuda.device(dev):
        err = getattr(lib, f"fedml_flash_{name}")(
            *(x.data_ptr() for x in tensors), bh, t, d, kind,
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(
            f"flash_{name} kernel launch failed: CUDA error {err} "
            f"({lib.fedml_flash_error_string(err).decode()})")
    launch_count[name] += 1


# --------------------------------------------------------------- wrappers
def fwd_route(q) -> str:
    """Which K1 kernel takes q (its `launch_count` key): "fwd_tc", the
    tensor-core kernel, for bf16; "fwd_3xtf32", the three-pass TF32
    tensor-core kernel, for f32. Every head of the contract (D <= 128,
    D % 8 == 0) has one: a shape rule, never a fallback."""
    return "fwd_tc" if q.dtype == torch.bfloat16 else "fwd_3xtf32"


def dq_route(q) -> str:
    """Which K2 kernel takes q (its `launch_count` key): "dq_tc" for bf16,
    "dq_3xtf32" (three TF32 passes) for f32, at every head of the
    contract. Never a fallback."""
    return "dq_tc" if q.dtype == torch.bfloat16 else "dq_3xtf32"


def dkv_route(q) -> str:
    """Which K3 kernel takes q (its `launch_count` key): "dkv_tc" for
    bf16, "dkv_3xtf32" (three TF32 passes) for f32, at every head of the
    contract. Never a fallback."""
    return "dkv_tc" if q.dtype == torch.bfloat16 else "dkv_3xtf32"


def _require_aligned(what: str, *tensors) -> None:
    """The kernels copy 16-byte chunks: a view that does not start
    16-byte aligned raises here, before any launch."""
    if any(x.data_ptr() % 16 for x in tensors):
        raise ValueError(f"the tensor-core flash {what} needs its operands "
                         "16-byte aligned; got views at storage offsets "
                         f"{[x.storage_offset() for x in tensors]}")


def flash_fwd(q, k, v, block_q=None, block_k=None):
    """(o [BH, T, D] in q's dtype, lse [BH, T] f32): K1 on CUDA (the kernel
    `fwd_route` names, on the tensor cores: q, k and v must start 16-byte
    aligned), the plain version on the CPU."""
    _check(q, k, v)
    bq, bk = _blocks(q.shape[1], block_q, block_k)
    if q.device.type == "cpu":
        return flash_fwd_ref(q, k, v, bq, bk)
    route = fwd_route(q)
    _require_aligned("forward", q, k, v)
    bh, t, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q.device)
    _launch(route, q, k, v, o, lse, bh=bh, t=t, d=d, kind=_KIND[q.dtype])
    return o, lse


def flash_dq(q, k, v, do, lse, delta, block_q=None, block_k=None):
    """dQ [BH, T, D] in q's dtype: K2 on CUDA (the kernel `dq_route`
    names, on the tensor cores: q, k, v and dO must start 16-byte
    aligned), the plain version on the CPU."""
    _check(q, k, v, do, lse, delta)
    bq, bk = _blocks(q.shape[1], block_q, block_k)
    if q.device.type == "cpu":
        return flash_dq_ref(q, k, v, do, lse, delta, bq, bk)
    name = dq_route(q)
    _require_aligned("backward", q, k, v, do)
    bh, t, d = q.shape
    dq = torch.empty_like(q)
    _launch(name, q, k, v, do, lse, delta, dq, bh=bh, t=t, d=d,
            kind=_KIND[q.dtype])
    return dq


def flash_dkv(q, k, v, do, lse, delta, block_q=None, block_k=None):
    """(dK, dV) [BH, T, D] in k's / v's dtype: K3 on CUDA (the kernel
    `dkv_route` names, on the tensor cores: q, k, v and dO must start
    16-byte aligned), the plain version on the CPU."""
    _check(q, k, v, do, lse, delta)
    bq, bk = _blocks(q.shape[1], block_q, block_k)
    if q.device.type == "cpu":
        return flash_dkv_ref(q, k, v, do, lse, delta, bq, bk)
    name = dkv_route(q)
    _require_aligned("backward", q, k, v, do)
    bh, t, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch(name, q, k, v, do, lse, delta, dk, dv, bh=bh, t=t, d=d,
            kind=_KIND[q.dtype])
    return dk, dv


def flash_delta(o, do) -> torch.Tensor:
    """delta = rowsum(o * dO) in f32, [BH, T] (plain torch: the JAX module
    computes it outside Pallas too)."""
    return (o.float() * do.float()).sum(-1)


def flash_bwd(q, k, v, o, lse, do, block_q=None, block_k=None):
    """(dQ, dK, dV): delta, then K2 and K3 (or their plain versions)."""
    delta = flash_delta(o, do)
    dq = flash_dq(q, k, v, do, lse, delta, block_q, block_k)
    dk, dv = flash_dkv(q, k, v, do, lse, delta, block_q, block_k)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, block_q, block_k):
        o, lse = flash_fwd(q, k, v, block_q, block_k)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.blocks = (block_q, block_k)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do.contiguous(), *ctx.blocks)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, block_q=None, block_k=None) -> torch.Tensor:
    """Causal flash attention over [BH, T, D] (module docstring has the
    contract), differentiable in q, k and v."""
    return _FlashAttention.apply(q, k, v, block_q, block_k)


def flash_attn_fn(q, k, v) -> torch.Tensor:
    """attn_fn adapter for TransformerLM: [B, T, H, D] in and out."""
    b, t, h, d = q.shape

    def fold(x):
        return x.transpose(1, 2).reshape(b * h, t, d).contiguous()

    o = flash_attention(fold(q), fold(k), fold(v))
    return o.reshape(b, h, t, d).transpose(1, 2)


# ---------------------------------------------------------- plain versions
def _q_blocks(t: int, bq: int, bk: int, k_block: int):
    """The q blocks the TPU's dK/dV kernel visits for K block `k_block`
    (the causal skip of `_dkv_kernel`)."""
    return [i for i in range(t // bq) if (i + 1) * bq > k_block * bk]


def _k_blocks(t: int, bq: int, bk: int, q_block: int):
    """The K blocks the forward and dQ kernels visit for q block `q_block`
    (the causal skip of `_fwd_kernel` / `_dq_kernel`)."""
    return [j for j in range(t // bk) if j * bk < (q_block + 1) * bq]


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of an f32 tensor, as the three-pass kernels split their
    operands: hi is x rounded to TF32's 10 mantissa bits, to nearest with
    ties away from zero (`cvt.rna.tf32.f32`: the low 13 bits are 0), and
    lo = x - hi, which is exact in f32."""
    bits = x.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return hi, x - hi


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """x as a TF32 tensor-core operand reads it: the low 13 bits of each
    f32 dropped (a hi of `tf32_split` is unchanged, a lo loses ~2^-11 of
    itself)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of f32 operands as three TF32 passes make it: a_lo.b_hi +
    a_hi.b_lo + a_hi.b_hi with each lo read truncated; the products of two
    TF32 values are exact in f32, and the sums are f32 (the plain
    emulation of the kernel's arithmetic)."""
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b)
    return (tf32_truncate(a_lo) @ b_hi + a_hi @ tf32_truncate(b_lo)) \
        + a_hi @ b_hi


def matmul_f64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of f32 operands with each entry summed in float64 (the f32
    products are exact there) and rounded once to f32: the same value
    whatever order the sum takes, which is how the f32 K2 makes dP."""
    return (a.double() @ b.double()).float()


def _scores_and_mask(qb, kb, i, j, bq, bk, scale, mm=torch.matmul):
    """f32 scaled scores of one (q block, K block) pair and its causal
    mask."""
    s = mm(qb, kb.transpose(-1, -2)) * scale
    qpos = i * bq + torch.arange(bq, device=qb.device)
    kpos = j * bk + torch.arange(bk, device=qb.device)
    return s, qpos[:, None] >= kpos[None, :]


def flash_fwd_ref(q, k, v, block_q: int, block_k: int, mm=torch.matmul):
    """The plain version of K1: the Pallas forward's blocked online
    softmax, vectorised over BH, with its rounding points (p rounded to V's
    dtype before P.V; o = acc / max(l, 1e-30) cast to q's dtype;
    lse = m + log(max(l, 1e-30))). `mm` makes its two f32 products
    (`matmul_3xtf32` repeats the three-pass kernel's arithmetic)."""
    bh, t, d = q.shape
    bq, bk = block_q, block_k
    scale = d ** -0.5
    o = torch.empty_like(q)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q.device)
    for i in range(t // bq):
        qb = q[:, i * bq:(i + 1) * bq].float()
        m = torch.full((bh, bq, 1), _NEG, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((bh, bq, 1), dtype=torch.float32, device=q.device)
        acc = torch.zeros((bh, bq, d), dtype=torch.float32, device=q.device)
        for j in _k_blocks(t, bq, bk, i):
            kb = k[:, j * bk:(j + 1) * bk].float()
            vb = v[:, j * bk:(j + 1) * bk]
            s, mask = _scores_and_mask(qb, kb, i, j, bq, bk, scale, mm)
            s = torch.where(mask, s, _NEG)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + mm(p.to(vb.dtype).float(), vb.float())
            m = m_new
        den = torch.clamp(l, min=1e-30)
        o[:, i * bq:(i + 1) * bq] = (acc / den).to(q.dtype)
        lse[:, i * bq:(i + 1) * bq] = (m + torch.log(den))[..., 0]
    return o, lse


def flash_dq_ref(q, k, v, do, lse, delta, block_q: int, block_k: int,
                 mm=torch.matmul, mm_dp=matmul_f64):
    """The plain version of K2: p = exp(s - lse) (0 where masked),
    dS = p * (dO.V^T - delta) * scale rounded to K's dtype, dQ = sum dS.K
    in f32, cast to q's dtype. `mm` makes S and dS.K, `mm_dp` makes dP,
    by default exactly and rounded once to f32 (`matmul_f64`): where a row
    attends one key (p = 1, dP = delta, always the first) dQ is 0 up to
    dP's rounding, which an f32 sum in another order changes by more than
    the rule the kernels are held to forgives there. `mm=matmul_3xtf32`
    repeats the f32 kernel's arithmetic."""
    bh, t, d = q.shape
    bq, bk = block_q, block_k
    scale = d ** -0.5
    dq = torch.empty_like(q)
    for i in range(t // bq):
        rows = slice(i * bq, (i + 1) * bq)
        qb, dob = q[:, rows].float(), do[:, rows].float()
        lse_b, dlt_b = lse[:, rows, None], delta[:, rows, None]
        acc = torch.zeros((bh, bq, d), dtype=torch.float32, device=q.device)
        for j in _k_blocks(t, bq, bk, i):
            kb = k[:, j * bk:(j + 1) * bk]
            vb = v[:, j * bk:(j + 1) * bk].float()
            s, mask = _scores_and_mask(qb, kb.float(), i, j, bq, bk, scale,
                                       mm)
            p = torch.where(mask, torch.exp(s - lse_b), 0.0)
            dp = mm_dp(dob, vb.transpose(-1, -2))
            ds = p * (dp - dlt_b) * scale
            acc = acc + mm(ds.to(kb.dtype).float(), kb.float())
        dq[:, rows] = acc.to(q.dtype)
    return dq


def flash_dkv_ref(q, k, v, do, lse, delta, block_q: int, block_k: int,
                  mm=torch.matmul):
    """The plain version of K3: dV = sum P^T.dO with p rounded to dO's
    dtype, dK = sum dS^T.Q with dS rounded to Q's dtype, over the q blocks
    from the diagonal on; f32 sums cast to k's / v's dtypes. `mm` makes its
    four f32 products (`matmul_3xtf32` repeats the three-pass kernel's
    arithmetic)."""
    bh, t, d = q.shape
    bq, bk = block_q, block_k
    scale = d ** -0.5
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for j in range(t // bk):
        cols = slice(j * bk, (j + 1) * bk)
        kb, vb = k[:, cols].float(), v[:, cols].float()
        dk_acc = torch.zeros((bh, bk, d), dtype=torch.float32,
                             device=q.device)
        dv_acc = torch.zeros_like(dk_acc)
        for i in _q_blocks(t, bq, bk, j):
            rows = slice(i * bq, (i + 1) * bq)
            qb, dob = q[:, rows], do[:, rows]
            s, mask = _scores_and_mask(qb.float(), kb, i, j, bq, bk, scale,
                                       mm)
            p = torch.where(mask, torch.exp(s - lse[:, rows, None]), 0.0)
            dv_acc = dv_acc + mm(p.to(dob.dtype).float().transpose(-1, -2),
                                 dob.float())
            dp = mm(dob.float(), vb.transpose(-1, -2))
            ds = p * (dp - delta[:, rows, None]) * scale
            dk_acc = dk_acc + mm(ds.to(qb.dtype).float().transpose(-1, -2),
                                 qb.float())
        dk[:, cols] = dk_acc.to(k.dtype)
        dv[:, cols] = dv_acc.to(v.dtype)
    return dk, dv


def flash_bwd_ref(q, k, v, o, lse, do, block_q: int, block_k: int):
    """The plain backward: delta, then the plain K2 and K3."""
    delta = flash_delta(o, do)
    return (flash_dq_ref(q, k, v, do, lse, delta, block_q, block_k),
            *flash_dkv_ref(q, k, v, do, lse, delta, block_q, block_k))
