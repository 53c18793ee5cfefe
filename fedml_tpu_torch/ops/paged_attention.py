"""Fused paged decode attention: the port of `fedml_tpu/ops/paged_attention.py`.

Each slot's K/V pages are read IN PLACE through its page-table row; no
virtually-contiguous gathered copy is made. Contract (one transformer
layer):

    q      [S, C, H, Dh]   float32 or bfloat16; C queries per slot at
                           positions pos[s] .. pos[s] + C - 1 (C == 1 is the
                           decode step, C > 1 a speculative verify window)
    k/v    [P, page_size, H, Dh]   the page pool, in q's dtype or int8
    pages  [S, max_pages] int32    page-table rows (entries past a slot's
                           reservation are 0, the reserved null page)
    pos    [S] int32       (a 0-d tensor broadcasts)
    k_scales / v_scales [P, H] float32 per-(page, head) scales, passed
                           together and only with an int8 pool
    ->     [S, C, H, Dh]   q's dtype

Query i of slot s attends the virtual positions <= pos[s] + i; online
softmax in f32; pages past the slot's last query contribute nothing.

On a CUDA tensor `paged_attention` launches the hand-written kernels
`csrc/paged_attention.cu` (built at first use, `ops/_build.py`) or raises;
on a CPU tensor it runs `paged_attention_ref`, the plain PyTorch version of
the same blocked math with the same rounding points. It never falls back
from the kernel to the plain version.

The CUDA path splits each slot's page table into runs of
`pages_per_split(max_pages)` pages (a rule on max_pages alone: the engine
dispatches ahead and never reads pos back): one block per (head, slot,
split) folds its run into an f32 partial (m, l, o), and a second kernel
merges the partials in split order. `paged_attention_split_ref` is the
plain version of that split-and-merge arithmetic, which the CPU tests pin
to the JAX kernel. `launch_count` counts `paged_attention` calls that
launched the kernels (one per call, though each launches two), and
nothing else, so a run can show its path went through the kernel;
`launches_by_c` counts the same launches by the query count C (1 for a
decode step, spec_k + 1 for a speculative verify window) and
`launches_by_h` by the head count H (a tensor-parallel engine's rank
launches at its own H / mp heads, on its own pool). All three update
under one lock, since engines on several threads (a fleet of replicas in
one process) launch concurrently; each process counts its own launches,
so a tensor-parallel run reads them rank by rank. Under the same lock a
launch notes its work (`ops/cost.py:paged_cost`) for a cost-ledger
capture running on the launching thread; the plain version counts the
same work (`cost.region`).
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _build, cost

_NEG = -1e30
MAX_C, MAX_PAGE_SIZE, MAX_DH = 16, 64, 256
MAX_SPLITS = 16   # splits per slot: enough blocks to cover the card
_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

launch_count = 0
launches_by_c: dict[int, int] = {}
launches_by_h: dict[int, int] = {}
_count_lock = threading.Lock()

_lib = None
_lib_lock = threading.Lock()   # one build / load, whichever thread asks first


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                lib = _build.load("paged_attention")
                vp, i = ctypes.c_void_p, ctypes.c_int
                lib.fedml_paged_attention.argtypes = ([vp] * 11 + [i] * 9
                                                      + [vp])
                lib.fedml_paged_attention.restype = i
                lib.fedml_cuda_error_string.argtypes = [i]
                lib.fedml_cuda_error_string.restype = ctypes.c_char_p
                _lib = lib
    return _lib


def _check(q, k_pool, v_pool, pages, pos, k_scales, v_scales) -> None:
    """Raise on anything the kernel does not take (both devices check the
    same contract, so the CPU tests exercise it)."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must be passed together")
    if q.dim() != 4 or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be [S, C, H, Dh] float32/bfloat16; got "
                         f"{tuple(q.shape)} {q.dtype}")
    s_, c, h, dh = q.shape
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape \
            or k_pool.shape[2:] != (h, dh):
        raise ValueError(f"k/v pools must both be [P, page_size, {h}, {dh}]; "
                         f"got {tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    if k_pool.dtype != v_pool.dtype:
        raise ValueError(f"k/v pool dtypes differ: {k_pool.dtype} / "
                         f"{v_pool.dtype}")
    quant = k_pool.dtype == torch.int8
    if not quant and k_pool.dtype != q.dtype:
        raise ValueError(f"a float pool must be in q's dtype {q.dtype}; got "
                         f"{k_pool.dtype}")
    if quant != (k_scales is not None):
        raise ValueError("an int8 pool needs k_scales/v_scales, and only an "
                         "int8 pool takes them")
    if quant:
        for sc in (k_scales, v_scales):
            if sc.dtype != torch.float32 or sc.shape != (k_pool.shape[0], h):
                raise ValueError(f"scales must be [{k_pool.shape[0]}, {h}] "
                                 f"float32; got {tuple(sc.shape)} {sc.dtype}")
    if pages.dtype != torch.int32 or pages.dim() != 2 \
            or pages.shape[0] != s_:
        raise ValueError(f"pages must be [{s_}, max_pages] int32; got "
                         f"{tuple(pages.shape)} {pages.dtype}")
    if pos.dtype != torch.int32 or pos.shape != (s_,):
        raise ValueError(f"pos must be [{s_}] int32; got {tuple(pos.shape)} "
                         f"{pos.dtype}")
    if c > MAX_C or k_pool.shape[1] > MAX_PAGE_SIZE or dh > MAX_DH:
        raise ValueError(
            f"the paged-attention kernel takes C <= {MAX_C}, page_size <= "
            f"{MAX_PAGE_SIZE}, Dh <= {MAX_DH}; got C={c}, page_size="
            f"{k_pool.shape[1]}, Dh={dh}")
    tensors = [q, k_pool, v_pool, pages, pos] + (
        [k_scales, v_scales] if quant else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_attention operands must share one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention operands must be contiguous")


def pages_per_split(max_pages: int) -> int:
    """Pages each block of the CUDA path folds: max_pages cut into at most
    MAX_SPLITS runs. A function of the page table's width alone."""
    return -(-max_pages // MAX_SPLITS)


def paged_attention(q, k_pool, v_pool, pages, pos, k_scales=None,
                    v_scales=None) -> torch.Tensor:
    """Fused paged decode attention (module docstring has the contract)."""
    global launch_count
    if pos.dim() == 0:
        pos = pos.expand(q.shape[0]).contiguous()
    _check(q, k_pool, v_pool, pages, pos, k_scales, v_scales)
    quant = k_scales is not None

    def work():
        return cost.paged_cost(q, pos, k_pool.shape[1], pages.shape[1],
                               k_pool.element_size(), quant)

    if q.device.type == "cpu":
        with cost.region(work):
            return paged_attention_ref(q, k_pool, v_pool, pages, pos,
                                       k_scales, v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu; got "
                         f"{q.device}")
    lib = _kernel_lib()
    s_, c, h, dh = q.shape
    max_pages = pages.shape[1]
    pps = pages_per_split(max_pages)
    n_split = -(-max_pages // pps)
    out = torch.empty_like(q)
    # the splits' f32 partials: scratch the kernels fill and merge
    o_part = torch.empty((s_, c, h, n_split, dh), dtype=torch.float32,
                         device=q.device)
    m_part = torch.empty((s_, c, h, n_split), dtype=torch.float32,
                         device=q.device)
    l_part = torch.empty_like(m_part)
    with torch.cuda.device(q.device):
        err = lib.fedml_paged_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            pages.data_ptr(), pos.data_ptr(),
            k_scales.data_ptr() if quant else None,
            v_scales.data_ptr() if quant else None, o_part.data_ptr(),
            m_part.data_ptr(), l_part.data_ptr(), out.data_ptr(),
            s_, c, h, dh, k_pool.shape[1], max_pages, pps,
            _KIND[q.dtype], _KIND[k_pool.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(
            "paged_attention kernel launch failed: CUDA error "
            f"{err} ({lib.fedml_cuda_error_string(err).decode()})")
    with _count_lock:
        launch_count += 1
        launches_by_c[c] = launches_by_c.get(c, 0) + 1
        launches_by_h[h] = launches_by_h.get(h, 0) + 1
        cost.note(work)     # reads pos back (a sync): only in a capture
    return out


def _fold_pages(q, k_pool, v_pool, pages, qpos, k_scales, v_scales,
                first: int, end: int):
    """The TPU kernel's page-by-page online softmax over pages
    [first, end) of every slot's table, vectorised over slots and heads,
    with its rounding points (int8 slabs dequantised then rounded to q's
    dtype; p rounded to V's dtype before P.V): f32 (m, l, o) of shapes
    [S, H, C, 1], [S, H, C, 1], [S, H, C, Dh]. A page past a slot's last
    query is fully masked for it, which leaves a real (m, l, o) exactly
    unchanged."""
    s_, c, h, dh = q.shape
    ps = k_pool.shape[1]
    scale = dh ** -0.5
    dev = q.device
    qf = q.float()
    m = torch.full((s_, h, c, 1), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((s_, h, c, 1), dtype=torch.float32, device=dev)
    o = torch.zeros((s_, h, c, dh), dtype=torch.float32, device=dev)
    for p in range(first, end):
        idx = pages[:, p].long()                                  # [S]
        kb, vb = k_pool[idx], v_pool[idx]                         # [S,ps,H,Dh]
        if k_scales is not None:
            kb = (kb.float() * k_scales[idx][:, None, :, None]).to(q.dtype)
            vb = (vb.float() * v_scales[idx][:, None, :, None]).to(q.dtype)
        s = torch.einsum("schd,sthd->shct", qf, kb.float()) * scale
        vpos = p * ps + torch.arange(ps, device=dev)
        s = torch.where(vpos[None, None, None, :] <= qpos[:, None, :, None],
                        s, _NEG)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        pr = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + pr.sum(-1, keepdim=True)
        o = o * corr + torch.einsum("shct,sthd->shcd",
                                    pr.to(vb.dtype).float(), vb.float())
        m = m_new
    return m, l, o


def _finish(q, o, l) -> torch.Tensor:
    out = o / torch.clamp(l, min=1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype).contiguous()


def paged_attention_ref(q, k_pool, v_pool, pages, pos, k_scales=None,
                        v_scales=None) -> torch.Tensor:
    """The plain PyTorch version: the TPU kernel's page-by-page online
    softmax over each slot's whole table (`_fold_pages`). Pages past every
    slot's last query are not visited."""
    c, ps = q.shape[1], k_pool.shape[1]
    qpos = pos.long()[:, None] + torch.arange(c, device=q.device)  # [S, C]
    n_pages = min(pages.shape[1], int(qpos.max()) // ps + 1)
    _m, l, o = _fold_pages(q, k_pool, v_pool, pages, qpos, k_scales,
                           v_scales, 0, n_pages)
    return _finish(q, o, l)


def paged_attention_split_ref(q, k_pool, v_pool, pages, pos, k_scales=None,
                              v_scales=None, *,
                              pages_per_split: int) -> torch.Tensor:
    """The plain version of the CUDA path's split-page arithmetic: each run
    of `pages_per_split` pages folded from a fresh (m, l, o) (an empty
    partial, m = -1e30 and l = o = 0, for a slot whose last live page lies
    before the run), then the partials merged in split order: M = max m_i,
    l = sum e^(m_i - M) l_i, o = sum e^(m_i - M) o_i, out = o / max(l,
    1e-30) in q's dtype. With one split it is `paged_attention_ref`.
    Used by the tests, which pin it to the JAX kernel."""
    s_, c, _h, _dh = q.shape
    ps, max_pages = k_pool.shape[1], pages.shape[1]
    pps = pages_per_split
    qpos = pos.long()[:, None] + torch.arange(c, device=q.device)  # [S, C]
    last = (qpos[:, -1] // ps).clamp(max=max_pages - 1)            # [S]
    parts = []
    for first in range(0, max_pages, pps):
        end = min(first + pps, int(last.max()) + 1)
        m, l, o = _fold_pages(q, k_pool, v_pool, pages, qpos, k_scales,
                              v_scales, first, end)
        live = (first <= last)[:, None, None, None]
        parts.append((torch.where(live, m, _NEG), torch.where(live, l, 0.0),
                      torch.where(live, o, 0.0)))
    big_m = torch.stack([m for m, _l, _o in parts]).amax(0)
    l_sum = torch.zeros_like(parts[0][1])
    o_sum = torch.zeros_like(parts[0][2])
    for m, l, o in parts:
        w = torch.exp(m - big_m)
        l_sum = l_sum + w * l
        o_sum = o_sum + w * o
    return _finish(q, o_sum, l_sum)
