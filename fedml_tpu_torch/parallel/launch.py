"""Start ranks for the mesh paths: a pool of spawned processes, one per
device, that form a `torch.distributed` world of their own.

    with RankPool(["cuda:0", "cuda:1"]) as pool:     # NCCL: distinct GPUs
        outs = pool.run(fn, *args)                   # fn(*args) in each rank

    with RankPool(["cpu"] * 4) as pool: ...           # gloo: 4 CPU ranks

The backend follows the device list (`pick_backend`): NCCL only when every
device is a distinct CUDA device, gloo otherwise (CPU ranks, or several
ranks sharing one GPU, which NCCL refuses). Nothing falls back from one to
the other. Each rank sets its device and one torch thread, joins the world at
a free localhost port, and then runs the functions the pool sends it, in
order; `fn` must be importable by name (a module-level function), its
arguments and result picklable (host numpy, or CPU tensors). `current()`
tells a function which rank and device it runs on.

A rank that raises fails the call: the pool stops every rank and raises
`RankError` with the rank's traceback. A call that outlasts its timeout
stops every rank too and raises TimeoutError, so a rank stuck in a
collective never outlives its pool. `close()` (also on leaving the `with`
block, and at interpreter exit) stops the ranks, releases the rendezvous
port and keeps their exit codes in `exitcodes`.

`local_world(backend, device)` makes this process a one-rank world for
the length of a `with` block: a one-rank mesh needs no other process.
"""
from __future__ import annotations

import atexit
import contextlib
import datetime
import queue
import socket
import time
import traceback
import weakref
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from .._device import resolve_device


class RankInfo(NamedTuple):
    rank: int
    world: int
    device: torch.device
    backend: str


_CURRENT: Optional[RankInfo] = None
_RANK_THREADS = 1   # torch threads per rank: ranks share the host's cores


def current() -> RankInfo:
    """The rank this process is (inside a pool's rank or a local_world)."""
    if _CURRENT is None:
        raise RuntimeError("not inside a RankPool rank or a local_world")
    return _CURRENT


class RankError(RuntimeError):
    """A rank of a pool raised; the message holds its traceback."""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def pick_backend(devices: Sequence) -> str:
    """NCCL when every device is a distinct CUDA device, else gloo."""
    devs = [torch.device(d) for d in devices]
    cuda = all(d.type == "cuda" for d in devs)
    idx = [d.index if d.index is not None else 0 for d in devs]
    return "nccl" if cuda and len(set(idx)) == len(idx) else "gloo"


def _join(backend: str, rank: int, world: int, port: int,
          device: torch.device, timeout_s: float) -> None:
    import torch.distributed as dist

    global _CURRENT
    if device.type == "cuda":
        device = resolve_device(device)
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{port}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    _CURRENT = RankInfo(rank, world, device, backend)


def _leave() -> None:
    import torch.distributed as dist

    global _CURRENT
    if dist.is_initialized():
        dist.destroy_process_group()
    _CURRENT = None


def _rank_main(rank: int, devices: list, backend: str, port: int,
               timeout_s: float, setup, cmds, results) -> None:
    """A rank's life: join the world, run what the pool sends, leave."""
    try:
        torch.set_num_threads(_RANK_THREADS)
        _join(backend, rank, len(devices), port, torch.device(devices[rank]),
              timeout_s)
        if setup is not None:
            setup()
        results.put((rank, -1, True, None))
    except Exception:  # noqa: BLE001 — the pool reports it
        results.put((rank, -1, False, traceback.format_exc()))
        return
    while True:
        item = cmds.get()
        if item is None:
            break
        seq, fn, args, kwargs = item
        try:
            results.put((rank, seq, True, fn(*args, **kwargs)))
        except Exception:  # noqa: BLE001 — the pool reports it
            results.put((rank, seq, False, traceback.format_exc()))
    _leave()


_POOLS: "weakref.WeakSet[RankPool]" = weakref.WeakSet()


@atexit.register
def _close_all() -> None:
    for pool in list(_POOLS):
        pool.close()


class RankPool:
    """`len(devices)` ranks, rank r on `devices[r]` (module docstring).
    The processes start here; the first `run` waits for them to join.
    `timeout_s` bounds each call (and the world's collectives); `setup`,
    a module-level function, runs once in each rank after it joins
    (process-wide settings such as the TF32 flags)."""

    def __init__(self, devices: Sequence, timeout_s: float = 300.0,
                 setup: Optional[Callable] = None):
        import torch.multiprocessing as mp

        # "cuda" is a fresh process's current device, cuda:0
        self.devices = [str(torch.device("cuda", 0)) if str(d) == "cuda"
                        else str(torch.device(d)) for d in devices]
        self.backend = pick_backend(self.devices)
        self.timeout_s = float(timeout_s)
        self.exitcodes: Optional[list] = None
        self._seq = 0
        self._ready = False
        ctx = mp.get_context("spawn")
        self._results = ctx.Queue()
        self._cmds = [ctx.Queue() for _ in self.devices]
        port = free_port()
        self._procs = [
            ctx.Process(target=_rank_main, daemon=True, args=(
                r, self.devices, self.backend, port, self.timeout_s, setup,
                self._cmds[r], self._results))
            for r in range(len(self.devices))]
        for p in self._procs:
            p.start()
        _POOLS.add(self)

    @property
    def size(self) -> int:
        return len(self.devices)

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _collect(self, seq: int, timeout_s: float) -> list:
        """Every rank's answer to call `seq`, in rank order; the first
        failure (a raise, a dead rank, the deadline) stops the pool."""
        out: dict = {}
        deadline = time.monotonic() + timeout_s
        while len(out) < self.size:
            try:
                rank, s, ok, val = self._results.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs)
                        if r not in out and not p.is_alive()]
                if dead:
                    self.close(grace_s=0.0)
                    raise RankError(
                        f"rank(s) {dead} exited (codes "
                        f"{[self._procs[r].exitcode for r in dead]}) "
                        "without answering")
                if time.monotonic() > deadline:
                    self.close(grace_s=0.0)
                    raise TimeoutError(
                        f"ranks {sorted(set(range(self.size)) - set(out))} "
                        f"did not answer within {timeout_s:.0f} s; every "
                        "rank was stopped")
                continue
            if s != seq:
                continue
            if not ok:
                self.close(grace_s=2.0)
                raise RankError(f"rank {rank} of {self.size} raised:\n{val}")
            out[rank] = val
        return [out[r] for r in range(self.size)]

    def run(self, fn: Callable, *args, timeout_s: Optional[float] = None,
            **kwargs) -> list:
        """`fn(*args, **kwargs)` in every rank; their results in rank
        order."""
        if self.exitcodes is not None:
            raise RuntimeError("the rank pool is closed")
        t = self.timeout_s if timeout_s is None else float(timeout_s)
        if not self._ready:
            self._collect(-1, t)
            self._ready = True
        self._seq += 1
        for q in self._cmds:
            q.put((self._seq, fn, args, kwargs))
        return self._collect(self._seq, t)

    def close(self, grace_s: float = 30.0) -> list:
        """Stop every rank (politely, then by signal) and return their
        exit codes."""
        if self.exitcodes is not None:
            return self.exitcodes
        for q in self._cmds:
            with contextlib.suppress(Exception):
                q.put(None)
        end = time.monotonic() + grace_s
        for p in self._procs:
            p.join(max(0.0, end - time.monotonic()))
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(5.0)
            if p.is_alive():
                p.kill()
                p.join(5.0)
        self.exitcodes = [p.exitcode for p in self._procs]
        for q in (*self._cmds, self._results):
            q.close()
            q.cancel_join_thread()
        _POOLS.discard(self)
        return self.exitcodes


@contextlib.contextmanager
def local_world(backend: str = "gloo", device="cpu",
                timeout_s: float = 300.0):
    """This process as a one-rank world for the block (then left)."""
    import torch.distributed as dist

    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialised here")
    _join(backend, 0, 1, free_port(), torch.device(device), timeout_s)
    try:
        yield current()
    finally:
        _leave()

