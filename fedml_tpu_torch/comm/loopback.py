"""In-process loopback transport (port of `fedml_tpu/comm/loopback.py`):
threads and queues in one process, the same Message flow as a network
transport. Frames still round-trip through encode/decode, so the wire
format and its CRC run on every message."""
from __future__ import annotations

import queue
import random
import threading
import time
from collections import defaultdict

from ..utils import metrics as _mx
from .base import BaseTransport
from .message import Message


class LoopbackRouter:
    """Shared mailbox set for one run: rank -> queue of frames."""

    def __init__(self):
        self._queues: dict[int, queue.Queue] = defaultdict(queue.Queue)
        self.lock = threading.Lock()

    def mailbox(self, rank: int) -> queue.Queue:
        with self.lock:
            return self._queues[rank]


_routers: dict[str, LoopbackRouter] = {}
_routers_lock = threading.Lock()


def get_router(run_id: str) -> LoopbackRouter:
    with _routers_lock:
        if run_id not in _routers:
            _routers[run_id] = LoopbackRouter()
        return _routers[run_id]


def release_router(run_id: str) -> None:
    """Drop a finished run's router (and any undrained frames). Long-lived
    processes that mint per-run ids must call this, or the registry keeps
    one mailbox set, with its encoded payloads, per run."""
    with _routers_lock:
        _routers.pop(run_id, None)


class LoopbackTransport(BaseTransport):
    backend_name = "loopback"

    def __init__(self, rank: int, run_id: str = "default"):
        super().__init__()
        self.rank = rank
        self.router = get_router(run_id)
        self._inbox = self.router.mailbox(rank)
        self._running = False
        # per-instance stop sentinel: a restarted rank shares its dead
        # incarnation's mailbox (stale in-flight frames must survive, like
        # a real process's unread sockets), so a sentinel left behind by
        # the dead instance's stop() must not end the new instance's loop
        self._stop_token = object()

    def send_message(self, msg: Message) -> None:
        frame = self._encode_frame(msg)
        self._send_raw(frame, msg.receiver_id)

    def _send_raw(self, frame: bytes, receiver_id: int) -> None:
        """Raw-frame enqueue: the chaos plane's injection point."""
        t0 = time.perf_counter()
        self.router.mailbox(receiver_id).put(frame)
        _mx.observe("comm.loopback.publish_s", time.perf_counter() - t0)

    def handle_receive_message(self) -> None:
        self._running = True
        while self._running:
            item = self._inbox.get()
            if item is self._stop_token:
                break
            if not isinstance(item, (bytes, bytearray)):
                continue    # a dead incarnation's stop token — not ours
            self._notify_frame(item)

    def stop_receive_message(self) -> None:
        self._running = False
        self._inbox.put(self._stop_token)


class JitterLoopbackTransport(LoopbackTransport):
    """Loopback with seeded per-send delays, the race-detection harness:
    a seeded sleep before each enqueue varies the arrival order across
    participants while keeping each sender's FIFO order, so runs under
    different seeds explore the comm FSM's interleavings; protocol
    outcomes must not depend on them."""

    def __init__(self, rank: int, run_id: str = "default", seed: int = 0,
                 max_delay: float = 0.01):
        super().__init__(rank, run_id)
        self._rng = random.Random(seed * 7919 + rank * 104729)
        self.max_delay = max_delay

    def send_message(self, msg: Message) -> None:
        time.sleep(self._rng.random() * self.max_delay)
        super().send_message(msg)
