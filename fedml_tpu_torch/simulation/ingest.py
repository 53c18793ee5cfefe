"""Streaming of cohort chunks onto the card (port of
`fedml_tpu/simulation/ingest.py`).

The chunked round (`parallel/round.build_chunk_fns`) turns the round's
one resident dataset into a transfer per chunk. This pipeline runs the
host side of each transfer (the numpy gather of the chunk's client rows,
the copy to the device) on a worker thread, `prefetch` chunks ahead of
the consumer, so chunk k+1's transfer overlaps chunk k's compute.

On CUDA a chunk goes through pinned host buffers with a non-blocking
copy on a side stream, then an event; the worker waits for that event (so
the pinned buffers may go and "resident before the consumer asks" is
real), and the consumer's stream waits on it too before it reads the
chunk. On the CPU (asked for by the tests) the chunk is copied plainly.

Counters, under the JAX package's names: fed.ingest.chunks,
fed.ingest.bytes, fed.ingest.prefetched (chunks already resident when the
consumer asked), histograms fed.ingest.put_s and fed.ingest.wait_s, and a
"fed.ingest.put" span per transfer.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from ..utils import metrics as mx
from ..utils.events import recorder


class DeviceChunk:
    """Host arrays copied onto `device`: `.tensors` (dict of tensors) and,
    on CUDA, the event the copy recorded on its side stream."""

    def __init__(self, arrays: dict, device: torch.device,
                 stream=None):
        self.event = None
        if device.type != "cuda":
            self.tensors = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                device) for k, v in arrays.items()}
            return
        with torch.cuda.stream(stream):
            self.tensors = {k: torch.from_numpy(
                np.ascontiguousarray(v)).pin_memory().to(
                    device, non_blocking=True) for k, v in arrays.items()}
            self.event = torch.cuda.Event()
            self.event.record(stream)
        self.event.synchronize()

    def ready(self) -> dict:
        """The tensors, ordered after the copy on the current stream (and
        kept alive for it by the caching allocator)."""
        if self.event is not None:
            cur = torch.cuda.current_stream()
            cur.wait_event(self.event)
            for t in self.tensors.values():
                t.record_stream(cur)
        return self.tensors


class IngestPipeline:
    """Yields the results of ordered thunks with a bounded prefetch depth.

    Each thunk returns `(payload, nbytes)`; the payload is yielded to the
    consumer in order, nbytes feeds the byte counter. `prefetch=0` runs
    each thunk inline (same counters, no thread)."""

    def __init__(self, prefetch: int = 1):
        self.prefetch = max(0, int(prefetch))

    def _run(self, thunk: Callable, idx: int):
        t0 = time.perf_counter()
        with recorder.span("fed.ingest.put", chunk=idx):
            payload, nbytes = thunk()
        mx.observe("fed.ingest.put_s", time.perf_counter() - t0)
        mx.inc("fed.ingest.chunks")
        mx.inc("fed.ingest.bytes", int(nbytes))
        return payload

    def stream(self, thunks: Iterable[Callable]) -> Iterator:
        """Yield each thunk's payload in order, running up to `prefetch`
        thunks ahead on a worker thread. A thunk's exception re-raises at
        the consumer's next pull; abandoning the generator stops the
        worker."""
        thunks = list(thunks)
        if self.prefetch == 0:
            for i, t in enumerate(thunks):
                yield self._run(t, i)
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker():
            for i, t in enumerate(thunks):
                if stop.is_set():
                    return
                try:
                    item = ("ok", self._run(t, i))
                except BaseException as e:  # noqa: BLE001 — relayed below
                    item = ("err", e)
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if item[0] == "err":
                    return

        th = threading.Thread(target=worker, name="fed-ingest", daemon=True)
        th.start()
        try:
            for _ in range(len(thunks)):
                try:
                    kind, item = q.get_nowait()
                    mx.inc("fed.ingest.prefetched")
                except queue.Empty:
                    t0 = time.perf_counter()
                    kind, item = q.get()
                    mx.observe("fed.ingest.wait_s",
                               time.perf_counter() - t0)
                if kind == "err":
                    raise item
                yield item
        finally:
            stop.set()
            th.join(timeout=10.0)
