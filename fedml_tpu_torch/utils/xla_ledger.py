"""Cost and memory ledger: what each tracked program costs and holds (port
of `fedml_tpu/utils/xla_ledger.py`, under its name so the counterpart is
easy to find).

The port has no XLA and compiles no programs. A "program" here is one of
the Python entry points the JAX package compiles, wrapped by `track`:
the round functions (`round_fn`, `block_fn`, `chunk_fn`, `finalize_fn`,
`parallel/round.py`), the Simulator's `eval_fn`, and the decode engine's
`engine_admit` / `engine_step` / `engine_spec` / `engine_admit_many`.
Each call bumps `xla.program.calls.<name>`. The first call at a new
input signature (the shapes, dtypes and devices of its tensors, the
types of everything else: when JAX would compile) is the capture: it
runs under `utils/flops.counting()` (one dispatch mode: the count
`analytic_flops` gives), and the hand-written kernels it launches note
their work on the side (`ops/cost.py`), since the counter cannot see a
kernel bound through ctypes. A program's FLOPs are its matmul and
convolution FLOPs plus the work of every K1-K4 launch, counted by the
same functions the kernel table's bound column uses; paths that compute
attention without the kernels count it by the same functions, so the
FLOPs do not depend on which path computed attention. `bytes` is the
bytes of the counted operators' tensors plus the kernels' (a lower bound
on what the card moves: elementwise work is not counted), `hbm_args` /
`hbm_out` the bytes of the call's tensor arguments (an `nn.Module`
argument's parameters and buffers included) and results, `hbm_peak`
their sum (a lower bound: temporaries are not seen),
`attention_flops` the K1-K4 share and `capture_s` the captured call's
wall time, synchronized with the card. They are published as
`xla.program.<field>.<name>` gauges, the JAX package's families.

Captures are opt-in. A capture runs the whole call under the counting
mode, tens of microseconds an operator on the host, so only a run that
asks for the ledger pays it: `mlops.init` with
`tracking_args.enable_tracking` turns captures on until `mlops.finish`
(`set_capture` does it by hand). Call counts and buffer entries are kept
either way. With captures on, a program is captured once per new
signature, never on the steady-state path; the engine's programs
(`track(..., once=True)`) are captured at their first call only, since
its prefill widths are not bucketed and nearly every admission would be
a new signature. A failure to start a capture runs the call uncounted,
and publishing never raises into the caller.

Two more ledgers ride along, as in JAX:
- `register_buffers(kind, tree)`: resident device tensors (parameters,
  the engine's KV pool and carry) summed by bytes into
  `xla.ledger.<kind>_bytes` and the `xla.ledger.device_bytes` total. The
  engine's kv_pool entry agrees with its `serving.kv_bytes_per_slot`
  math.
- `measured_mfu()`: utilization from measured span wall time over the
  captured FLOPs x calls: `xla.program.flops_per_s.*` always, and
  `xla.program.mfu.*` against the card's spec peak
  (`utils/flops.spec_peak_tflops`; None on the CPU, where no MFU is
  claimed).

`set_enabled(False)` turns the whole plane off, call counts and buffers
included.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
import time
from typing import Callable, Optional

import torch

from . import metrics as _mx

log = logging.getLogger(__name__)

_lock = threading.Lock()
_programs: dict[str, dict] = {}    # name -> cost/memory entry
_buffers: dict[str, int] = {}      # kind -> resident bytes
_enabled = True
_capture = False                   # captures run only when asked for

# program name -> recorder span name whose wall time measures it (the JAX
# package's map: one training program is active in a run; chunk and
# finalize split one span's wall, so their MFU is a lower bound)
SPAN_OF_PROGRAM = {"round_fn": "train", "block_fn": "train",
                   "chunk_fn": "train", "finalize_fn": "train",
                   "eval_fn": "eval"}


def set_enabled(on: bool) -> None:
    """The plane's switch."""
    global _enabled
    _enabled = bool(on)


def enabled() -> bool:
    return _enabled


def set_capture(on: bool) -> bool:
    """Turn captures on or off (module docstring); returns the previous
    setting."""
    global _capture
    prev, _capture = _capture, bool(on)
    return prev


def capture_on() -> bool:
    return _capture


def reset() -> None:
    """Drop captured programs and buffer entries (tests)."""
    with _lock:
        _programs.clear()
        _buffers.clear()


def programs() -> dict:
    """{program name: {flops, bytes, attention_flops, hbm_*, capture_s}},
    a copy."""
    with _lock:
        return {k: dict(v) for k, v in _programs.items()}


def buffers() -> dict:
    """{kind: resident bytes} of every registered tree."""
    with _lock:
        return dict(_buffers)


def note_call(name: str) -> None:
    """Per-call accounting: a program's executed FLOPs are its captured
    FLOPs x this counter."""
    if _enabled:
        _mx.inc(f"xla.program.calls.{name}")


# -------------------------------------------------------------- trees
def _tensors(obj):
    """The tensors of a nested argument: dicts, lists, tuples (named ones
    too), dataclasses, and a module's parameters and buffers."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)
    elif isinstance(obj, torch.nn.Module):
        yield from obj.parameters()
        yield from obj.buffers()
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))


def _signature(obj):
    """What decides a new capture: tensor shapes, dtypes and devices, and
    the types of everything else (a module by its type, not its
    weights)."""
    if isinstance(obj, torch.Tensor):
        return (tuple(obj.shape), obj.dtype, obj.device.type)
    if isinstance(obj, dict):
        return tuple((k, _signature(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return (type(obj).__name__,) + tuple(_signature(v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,) + tuple(
            _signature(getattr(obj, f.name))
            for f in dataclasses.fields(obj))
    shape = getattr(obj, "shape", None)     # numpy arrays
    if shape is not None:
        return (type(obj).__name__, tuple(shape), str(obj.dtype))
    return type(obj).__name__


def _nbytes(obj) -> int:
    seen: set = set()
    total = 0
    for t in _tensors(obj):
        if id(t) not in seen:
            seen.add(id(t))
            total += t.numel() * t.element_size()
    return total


def _sync(obj) -> None:
    if torch.cuda.is_available() and any(
            t.is_cuda for t in _tensors(obj)):
        torch.cuda.synchronize()


# ------------------------------------------------------------ capture
def capture(name: str, fn: Callable, args: tuple, kwargs: dict):
    """Run `fn(*args, **kwargs)` once under the counters and publish its
    `xla.program.*` gauges; returns the call's result. Called by `track`
    at a new input signature."""
    from ..ops import cost
    from .flops import counting

    stack = contextlib.ExitStack()
    try:
        mode = stack.enter_context(counting())
        tally = stack.enter_context(cost.tally(mode))
    except Exception as e:  # noqa: BLE001 — the ledger never breaks a call
        stack.close()
        log.debug("cost ledger: capture of %s not started: %s: %s", name,
                  type(e).__name__, e)
        return fn(*args, **kwargs)
    with stack:
        _sync((args, kwargs))
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _sync(out)
        wall = time.perf_counter() - t0
        seen_flops, seen_bytes = tally.counted()
    try:
        ent = {"flops": seen_flops + tally.adjust_flops,
               "bytes": seen_bytes + tally.adjust_bytes,
               "attention_flops": tally.attention_flops,
               "hbm_args": _nbytes((args, kwargs)),
               "hbm_out": _nbytes(out), "capture_s": wall}
        ent["hbm_peak"] = ent["hbm_args"] + ent["hbm_out"]
        with _lock:
            _programs.setdefault(name, {}).update(ent)
        for field, v in ent.items():
            _mx.set_gauge(f"xla.program.{field}.{name}", v)
    except Exception as e:  # noqa: BLE001 — the ledger never breaks a call
        log.debug("cost ledger: publishing %s failed: %s: %s", name,
                  type(e).__name__, e)
    return out


class _Tracked:
    """A program entry point under the ledger: each call counts
    `xla.program.calls.<name>`; with captures on, a call at a new input
    signature (with `once`, the first call) is captured."""

    def __init__(self, fn: Callable, name: str, once: bool = False):
        self._fn = fn
        self._name = name
        self._once = once
        self._seen: set = set()

    def __call__(self, *args, **kwargs):
        if not _enabled:
            return self._fn(*args, **kwargs)
        from ..ops import cost

        note_call(self._name)
        if not _capture or (self._once and self._seen) or cost.capturing():
            return self._fn(*args, **kwargs)
        try:
            sig = () if self._once else _signature((args, kwargs))
            new = sig not in self._seen
        except Exception:  # noqa: BLE001 — an unhashable argument
            new = False
        if not new:
            return self._fn(*args, **kwargs)
        self._seen.add(sig)
        return capture(self._name, self._fn, args, kwargs)


def track(fn: Callable, name: str, once: bool = False) -> Callable:
    """Wrap a program entry point for the ledger (see `_Tracked`); `once`
    captures its first call only."""
    return _Tracked(fn, name, once)


# ------------------------------------------------------------ buffers
def register_buffers(kind: str, tree) -> int:
    """Record a resident tree of device tensors: its bytes into the
    `xla.ledger.<kind>_bytes` gauge, and the `xla.ledger.device_bytes`
    total refreshed. Registering a kind again replaces its entry (a hot
    swap reports its new size)."""
    total = _nbytes(tree)
    with _lock:
        _buffers[kind] = total
        device_total = sum(_buffers.values())
    _mx.set_gauge(f"xla.ledger.{kind}_bytes", total)
    _mx.set_gauge("xla.ledger.device_bytes", device_total)
    return total


def measured_mfu(summary: Optional[dict] = None,
                 peak_flops_per_s: Optional[float] = None) -> dict:
    """Per-program utilization from measured span wall time over the
    captured FLOPs x calls: {program: {total_flops, wall_s, flops_per_s,
    mfu}}. `summary` defaults to the process recorder's span summary,
    `peak_flops_per_s` to the card's spec peak (None on the CPU: mfu is
    then None, flops_per_s still reported). Publishes
    `xla.program.flops_per_s.*` (and `xla.program.mfu.*` with a peak)."""
    if summary is None:
        from .events import recorder

        summary = recorder.summary()
    if peak_flops_per_s is None:
        try:
            from .flops import spec_peak_tflops

            peak_t = spec_peak_tflops()
            peak_flops_per_s = peak_t * 1e12 if peak_t is not None else None
        except Exception:  # noqa: BLE001 — no card in this process
            peak_flops_per_s = None
    out: dict = {}
    progs = programs()
    counters = _mx.snapshot()["counters"]
    for prog, span in SPAN_OF_PROGRAM.items():
        ent = progs.get(prog)
        row = summary.get(span)
        if not ent or not ent.get("flops") or not row or not row["total_s"]:
            continue
        calls = int(counters.get(f"xla.program.calls.{prog}", 0))
        if calls <= 0:
            continue
        total_flops = ent["flops"] * calls
        wall = float(row["total_s"])
        fps = total_flops / wall
        mfu = (fps / peak_flops_per_s) if peak_flops_per_s else None
        out[prog] = {"total_flops": total_flops, "wall_s": wall,
                     "flops_per_s": fps, "mfu": mfu}
        _mx.set_gauge(f"xla.program.flops_per_s.{prog}", fps)
        if mfu is not None:
            _mx.set_gauge(f"xla.program.mfu.{prog}", mfu)
    return out
