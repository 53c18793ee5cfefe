"""FedCommManager — handler registry and event loop over a pluggable
transport (port of `fedml_tpu/comm/manager.py`).

Backends: "loopback" (in-process queues). Not ported, each refused with a
NotImplementedError naming its ROADMAP item: "grpc" (the `grpc` package
is not on the card's machine), the pub/sub "broker" family (mqtt_s3,
mqtt_web3, ...) and the wire codec plane (`comm_codec`), all ROADMAP
'Port queue' item 5. "xla", "trpc" and "mpi" raise ValueError as in the
JAX package.
"""
from __future__ import annotations

import logging
import threading
from typing import Callable, Optional

from ..utils import metrics as _mx
from ..utils.events import recorder
from .base import BaseTransport, Observer
from .loopback import LoopbackTransport
from .message import Message


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP 'Port queue' item 5, the "
        "cross-silo transports and codec)")


def _backend_of(transport: BaseTransport) -> str:
    """Innermost transport's backend tag (unwraps the reliability / chaos
    stack), stamped into the comm spans' metadata."""
    t = transport
    while hasattr(t, "inner"):
        t = t.inner
    name = type(t).__name__.lower()
    for tag in ("grpc", "loopback", "broker"):
        if tag in name:
            return tag
    return name.removesuffix("transport") or name


class FedCommManager(Observer):
    def __init__(self, transport: BaseTransport, rank: int = 0):
        self.transport = transport
        self.backend = _backend_of(transport)
        self.rank = rank
        self._handlers: dict[str, Callable[[Message], None]] = {}
        self.transport.add_observer(self)
        self._thread: Optional[threading.Thread] = None
        self._warned_unhandled: set[str] = set()

    # reference API (fedml_comm_manager.py:63)
    def register_message_receive_handler(
        self, msg_type: str, handler: Callable[[Message], None]
    ) -> None:
        self._handlers[msg_type] = handler

    def send_message(self, msg: Message) -> None:  # :53
        # the Message's own sender_id is authoritative (callers construct
        # it with their client id, which need not equal the transport rank)
        with recorder.span(f"comm.send.{msg.type}", sender=msg.sender_id,
                           receiver=msg.receiver_id, backend=self.backend):
            self.transport.send_message(msg)

    def receive_message(self, msg_type: str, msg: Message) -> None:
        handler = self._handlers.get(msg_type)
        if handler is None:
            # an unknown type must not kill the receive loop (a peer one
            # protocol version ahead would take down this rank's comm):
            # log once per type, count every occurrence, keep the loop
            _mx.inc("comm.msgs_unhandled")
            if msg_type not in self._warned_unhandled:
                self._warned_unhandled.add(msg_type)
                logging.getLogger(__name__).warning(
                    "rank %d: no handler registered for %r (registered: %s) "
                    "— dropping; further occurrences counted in "
                    "comm.msgs_unhandled", self.rank, msg_type,
                    sorted(self._handlers))
            return
        _mx.inc("comm.msgs_handled")
        with recorder.span(f"comm.handle.{msg_type}", sender=msg.sender_id,
                           receiver=msg.receiver_id, backend=self.backend):
            handler(msg)

    def run(self, background: bool = False) -> None:
        """Enter the receive loop (reference: run() :25 →
        handle_receive_message). background=True runs it in a daemon thread
        (the in-process multi-role topology)."""
        if background:
            self._thread = threading.Thread(
                target=self.transport.handle_receive_message, daemon=True
            )
            self._thread.start()
        else:
            self.transport.handle_receive_message()

    def stop(self) -> None:
        self.transport.stop_receive_message()
        # handlers run on the loop thread and may call stop() themselves
        if self._thread is not None and self._thread is not threading.current_thread():
            self._thread.join(timeout=5)


def _wrap_transport(t: BaseTransport, chaos, retry_policy) -> BaseTransport:
    """The robustness stack: chaos inside, reliability outside, so injected
    faults hit data frames, acks and retransmits alike and the retry /
    dedup machinery recovers from them."""
    if chaos is not None:
        from .chaos import ChaosTransport, FaultSpec

        spec = chaos if isinstance(chaos, FaultSpec) \
            else FaultSpec.from_dict(chaos)
        if spec.any_link_faults():
            t = ChaosTransport(t, spec)
    if retry_policy is not None:
        from .reliable import ReliableTransport

        t = ReliableTransport(t, retry_policy)
    return t


def create_transport(backend: str, rank: int, run_id: str = "default",
                     ip_table: Optional[dict] = None, chaos=None,
                     comm_retry=None, comm_codec=None, **kw) -> BaseTransport:
    """Backend factory (reference: _init_manager, fedml_comm_manager.py:131).

    chaos: FaultSpec or `common_args.extra.chaos` dict — wraps the transport
    in a fault-injecting ChaosTransport (comm/chaos.py).
    comm_retry: RetryPolicy, `common_args.extra.comm_retry` dict, or True
    for defaults — wraps the stack in a ReliableTransport (seq / ack /
    retransmit / dedup, comm/reliable.py).
    """
    if comm_codec is not None:
        raise _later("the wire codec plane (comm_args.comm_codec, "
                     "comm/codec.py)")
    policy = None
    if comm_retry is not None and comm_retry is not False:
        from .reliable import RetryPolicy

        policy = comm_retry if isinstance(comm_retry, RetryPolicy) \
            else RetryPolicy.from_dict(comm_retry)
    b = (backend or "loopback").lower()
    if b == "loopback":
        return _wrap_transport(LoopbackTransport(rank, run_id), chaos, policy)
    if b == "grpc":
        raise _later("the gRPC transport (the grpc package is not on the "
                     "card's machine)")
    if b in ("broker", "mqtt_s3", "mqtt", "mqtt_web3", "mqtt_thetastore",
             "web3"):
        raise _later(f"the pub/sub broker transport ({b!r})")
    if b == "xla":
        raise ValueError(
            "backend='xla' is the in-program collective path (simulation over "
            "a device mesh), not a message transport; use 'loopback' for the "
            "cross-silo message layer"
        )
    if b in ("trpc", "mpi"):
        raise ValueError(
            f"backend {b!r} is a reference transport not provided in this "
            "build; 'loopback' covers single-box runs")
    raise ValueError(f"unknown comm backend {backend!r}")
