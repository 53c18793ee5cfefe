"""One count of the hand-written kernels' work.

`paged_cost` (K4) and `flash_cost` (K1-K3) give the bytes a call must move
(each input read once, each output written once) and the operations it
must do, from the call's own shapes (and, for K4, the positions it was
given: pages past a slot's last query are not work). `peak_flops` is the
card's dense peak for an operand type. These are the numbers behind the
kernel table's "bound" column (`chip_smoke.py`) and behind the kernels'
share of the cost ledger (`utils/xla_ledger.py`), so both read one
definition.

The ledger counts a tracked call's matmul and convolution FLOPs under a
dispatch mode (`utils/flops.counting`), which cannot see a kernel bound
through ctypes. While a ledger capture runs (`tally`), each kernel launch
under it `note`s its work, and every other path that computes the same
attention -- the kernels' plain versions on the CPU, the engine's gather
path, the contiguous decode step and the dense causal attention's
forward and backward -- runs inside `region`, which takes out what the
counter saw there and puts in the same function's count. So the
ledger's FLOPs do not change with the path that computed attention.

A capture's tally rides on its counting mode, and a launch finds it on
the dispatch-mode stack of its thread: autograd carries that stack to
the threads that run a CUDA backward (where K2, K3 and the recomputed K1
launch), and an engine thread's capture never sees another thread's.
Outside any capture these calls read one module counter.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional

import torch

_active = 0                  # captures in progress, in any thread
_active_lock = threading.Lock()


# ------------------------------------------------------------ the counts
def paged_cost(q, pos, page_size: int, max_pages: int, kv_itemsize: int,
               scales_on: bool) -> tuple[int, int]:
    """(bytes, flops) of one paged decode attention (K4) over q [S, C, H,
    Dh] at positions pos [S]: each live page's K and V slab for every head
    once, its scales, q, out, the live page-table entries and pos; 4 flops
    per (query, head, dim, live key) for the two products. A page is live
    when it holds a position <= pos + C - 1 (reads pos: a device sync on a
    CUDA tensor)."""
    s_, c, h, dh = q.shape
    live = ((pos.long() + c - 1) // page_size + 1).clamp(max=max_pages)
    n_live = int(live.sum())
    slab = page_size * h * dh * kv_itemsize
    nbytes = 2 * n_live * slab + 2 * q.numel() * q.element_size() \
        + n_live * 4 + s_ * 4 + (2 * n_live * h * 4 if scales_on else 0)
    flops = 4 * c * h * dh * n_live * page_size
    return nbytes, flops


def flash_cost(kernel: str, bh: int, t: int, d: int,
               es: int) -> tuple[int, int]:
    """(bytes, flops) the causal flash pass `kernel` ("fwd" K1, "dq" K2,
    "dkv" K3, "bwd" K2 + K3) must move and do at [BH, T, D] with operands
    of `es` bytes: each input read once, each output written once; causal
    products count T(T+1)/2 score entries, 2*D flops each. The forward
    does 2 products (S, P.V), dQ 2 (dP, dS.K), dK/dV 2 (P^T.dO, dS^T.Q).
    Recomputing S (both backward passes), and dP in dK/dV, is the
    kernels' choice and is not counted."""
    tri = t * (t + 1) // 2
    tile = bh * t * d * es       # one [BH, T, D] operand
    row = bh * t * 4             # one [BH, T] f32 vector
    flops = 4 * bh * d * tri
    nbytes = {"fwd": 3 * tile + tile + row,              # q k v -> o lse
              "dq": 4 * tile + 2 * row + tile,           # q k v dO lse dlt
              "dkv": 4 * tile + 2 * row + 2 * tile,      # ... -> dK dV
              "bwd": 5 * tile + row + 3 * tile}[kernel]  # q k v o dO lse
    return nbytes, 2 * flops if kernel == "bwd" else flops


def peak_flops(dtype) -> float:
    """Dense peak for the operand type on an H100 SXM. f32 products at
    full f32 accuracy are at least three TF32 tensor-core passes each
    (hi/lo split, the floor the three-pass kernels and SDPA's f32 route
    both sit on): 495 / 3 TFLOP/s, above the CUDA cores' 67."""
    return 495e12 / 3 if dtype == torch.float32 else 989e12


# ----------------------------------------------------- the ledger's tally
class Tally:
    """The kernel work of one captured call. `counted()` reads what the
    capture's counting mode has seen so far, (flops, bytes); `adjust_*`
    is what to add to its totals, `attention_*` the attention work
    counted by the functions above."""

    def __init__(self, mode):
        self.mode = mode
        self.adjust_flops = 0.0
        self.adjust_bytes = 0.0
        self.attention_flops = 0.0
        self.attention_bytes = 0.0

    def counted(self) -> tuple[float, float]:
        return float(self.mode.flops), float(self.mode.nbytes)

    def replace(self, seen_flops: float, seen_bytes: float,
                flops: float, nbytes: float) -> None:
        """Count (flops, nbytes) of attention in place of what the
        counters saw of it."""
        self.adjust_flops += flops - seen_flops
        self.adjust_bytes += nbytes - seen_bytes
        self.attention_flops += flops
        self.attention_bytes += nbytes


def _current() -> Optional[Tally]:
    if not _active:
        return None
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    for mode in reversed(_get_current_dispatch_mode_stack()):
        t = getattr(mode, "tally", None)
        if t is not None:
            return t
    return None


def capturing() -> bool:
    """True while a ledger capture's counting mode is active here."""
    return _current() is not None


@contextlib.contextmanager
def tally(mode):
    """Collect the kernel work done under counting `mode` (one capture;
    `mode` has running `flops` and `nbytes` totals)."""
    global _active
    t = mode.tally = Tally(mode)
    with _active_lock:
        _active += 1
    try:
        yield t
    finally:
        with _active_lock:
            _active -= 1
        mode.tally = None


def note(work: Callable[[], tuple[int, int]]) -> None:
    """A kernel launch's work, `work()` -> (bytes, flops) (the launch
    sites call it under their launch counter's lock): added to this
    thread's capture, if one runs. `work` runs only during a capture."""
    t = _current()
    if t is not None:
        nbytes, flops = work()
        t.replace(0.0, 0.0, flops, nbytes)


@contextlib.contextmanager
def region(work: Callable[[], tuple[int, int]]):
    """Attention computed with plain operators: inside a capture, what the
    counters see in the block is replaced by `work()` -> (bytes, flops).
    `work` runs only during a capture."""
    t = _current()
    if t is None:
        yield
        return
    f0, b0 = t.counted()
    yield
    f1, b1 = t.counted()
    nbytes, flops = work()
    t.replace(f1 - f0, b1 - b0, flops, nbytes)
