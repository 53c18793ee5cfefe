"""Host and device telemetry sampler (port of `fedml_tpu/utils/sysperf.py`).

`sample_sysperf()` returns one row under the JAX package's keys:
`cpu_pct` (system-wide CPU use since the previous sample, 0.0 on the
first), `rss_mb`, `host_mem_pct`, `threads`, and for each visible GPU
`dev{i}_bytes_in_use` (`torch.cuda.memory_allocated`) and
`dev{i}_bytes_limit` (the card's total memory). The host keys are read
from `/proc` the way psutil reads them (the card's machine has no
psutil); where there is no `/proc`, psutil gives them. The device keys
are sampled only once the process has initialised CUDA, so a sampler
never creates a CUDA context itself.

`SysPerfMonitor(interval).start()` logs `{"sysperf": row}` through the
process-wide recorder every `interval` seconds until `stop()`, so the
rows reach every attached sink.
"""
from __future__ import annotations

import os
import threading
from typing import Optional

from .events import recorder

_cpu_lock = threading.Lock()
_cpu_last: Optional[tuple[float, float]] = None   # (total, busy) jiffies


def _proc_cpu_times() -> tuple[float, float]:
    """(total, busy) over all CPUs from /proc/stat, as psutil counts
    them: guest time is already inside user / nice, and idle + iowait is
    not busy."""
    with open("/proc/stat") as f:
        vals = [float(v) for v in f.readline().split()[1:]]
    vals += [0.0] * (10 - len(vals))
    user, nice, system, idle, iowait, irq, softirq, steal, guest, gnice = \
        vals[:10]
    total = sum(vals[:10]) - guest - gnice
    return total, total - idle - iowait


def cpu_percent() -> float:
    """System-wide CPU use since the previous call, in percent rounded to
    one place (psutil's `cpu_percent(interval=None)`); 0.0 the first
    time."""
    global _cpu_last
    if not os.path.exists("/proc/stat"):
        import psutil

        return psutil.cpu_percent(interval=None)
    total, busy = _proc_cpu_times()
    with _cpu_lock:
        last, _cpu_last = _cpu_last, (total, busy)
    if last is None:
        return 0.0
    dt, db = total - last[0], busy - last[1]
    if dt <= 0:
        return 0.0
    return round(min(max(db / dt * 100.0, 0.0), 100.0), 1)


def _proc_host_row() -> dict:
    with open("/proc/self/statm") as f:
        rss_pages = int(f.read().split()[1])
    with open("/proc/self/status") as f:
        threads = next(int(line.split()[1]) for line in f
                       if line.startswith("Threads:"))
    mem: dict = {}
    with open("/proc/meminfo") as f:
        for line in f:
            k, v = line.split(":", 1)
            mem[k] = int(v.split()[0]) * 1024
    total = mem["MemTotal"]
    avail = mem.get("MemAvailable", mem.get("MemFree", 0))
    return {"rss_mb": rss_pages * os.sysconf("SC_PAGE_SIZE") / 1e6,
            "host_mem_pct": round((total - avail) / total * 100.0, 1),
            "threads": threads}


def _device_row() -> dict:
    row: dict = {}
    try:
        import torch

        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return row
        for i in range(torch.cuda.device_count()):
            row[f"dev{i}_bytes_in_use"] = int(torch.cuda.memory_allocated(i))
            row[f"dev{i}_bytes_limit"] = int(
                torch.cuda.get_device_properties(i).total_memory)
    except Exception:   # a sample must never fail on the device leg
        pass
    return row


def sample_sysperf() -> dict:
    """One sample of host and device stats."""
    row = {"cpu_pct": cpu_percent()}
    if os.path.exists("/proc/self/statm"):
        row.update(_proc_host_row())
    else:
        import psutil

        p = psutil.Process()
        row.update(rss_mb=p.memory_info().rss / 1e6,
                   host_mem_pct=psutil.virtual_memory().percent,
                   threads=p.num_threads())
    row.update(_device_row())
    return row


class SysPerfMonitor:
    """Background sampler: `recorder.log({"sysperf": ...})` every
    `interval` seconds between start() and stop()."""

    def __init__(self, interval: float = 10.0):
        self.interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "SysPerfMonitor":
        if self._thread is not None:
            return self
        self._stop.clear()
        # prime the CPU reading: the first sample has nothing to diff
        # against and would open every run with a 0.0
        try:
            cpu_percent()
        except Exception:  # pragma: no cover
            pass

        def loop():
            while not self._stop.wait(self.interval):
                try:
                    recorder.log({"sysperf": sample_sysperf()})
                except Exception:  # sampling must never kill the host loop
                    pass

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="fedml-sysperf")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
