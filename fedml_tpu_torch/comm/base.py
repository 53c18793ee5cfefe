"""Transport abstraction (port of `fedml_tpu/comm/base.py`): a transport
moves encoded Message frames between integer-addressed processes; the
comm manager on top owns dispatch.

Every transport funnels its wire traffic through `_encode_frame` /
`_decode_frame`, which feed the process-wide instruments
(`utils/metrics.py`) under the JAX package's names:
`comm.<backend>.bytes_sent` / `bytes_recv` / `msgs_sent` / `msgs_recv`
counters, the `serialize_s` / `deserialize_s` histograms and the per-link
`comm.link.<src>.<dst>.bytes`. The JAX package's flight-recorder frame
ring (its `utils/postmortem.py`) and wire codec plane (`comm/codec.py`,
`set_codec`) are not ported (ROADMAP 'Port queue' item 5):
`create_transport` refuses `comm_codec`.
"""
from __future__ import annotations

import abc
import logging
import time

from ..utils import metrics as _mx
from .message import Message

_log = logging.getLogger(__name__)

class Observer(abc.ABC):
    """(reference: observer.py:4-8)"""

    @abc.abstractmethod
    def receive_message(self, msg_type: str, msg: Message) -> None: ...


class BaseTransport(abc.ABC):
    """(reference: base_com_manager.py:7-26 — send_message /
    add_observer / remove_observer / handle_receive_message /
    stop_receive_message)"""

    #: metric namespace — `comm.<backend_name>.*`
    backend_name = "base"

    def __init__(self):
        self._observers: list[Observer] = []

    def add_observer(self, obs: Observer) -> None:
        self._observers.append(obs)

    def remove_observer(self, obs: Observer) -> None:
        self._observers.remove(obs)

    def _notify(self, msg: Message) -> None:
        # one faulty handler must not kill the transport pump: the receive
        # loop is a background thread, and an escaping exception there ends
        # all message delivery for the rank. Failures are counted and
        # logged, the loop survives.
        for obs in list(self._observers):
            try:
                obs.receive_message(msg.type, msg)
            except Exception:  # noqa: BLE001 — pump survival over strictness
                _mx.inc("comm.handler_errors")
                _log.exception(
                    "observer %s failed handling %r from %s (receive loop "
                    "continues)", type(obs).__name__, msg.type, msg.sender_id)

    def _notify_frame(self, frame: bytes) -> None:
        """Decode and dispatch one wire frame, surviving poison frames: a
        corrupted frame (CRC mismatch, garbled header) is counted and
        dropped instead of killing the receive loop; the reliable layer's
        retransmit covers the gap."""
        try:
            msg = self._decode_frame(frame)
        except Exception as e:  # noqa: BLE001 — poison frame, not a bug here
            _mx.inc(f"comm.{self.backend_name}.decode_errors")
            _log.warning("dropping undecodable %d-byte frame on %s: %s: %s",
                         len(frame), self.backend_name, type(e).__name__, e)
            return
        self._notify(msg)

    # ------------------------------------------------- instrumented codec
    def _encode_frame(self, msg: Message) -> bytes:
        """Serialize and count: the single choke point for outbound bytes
        on every transport."""
        t0 = time.perf_counter()
        frame = msg.encode()
        pre = f"comm.{self.backend_name}"
        _mx.observe(f"{pre}.serialize_s", time.perf_counter() - t0)
        _mx.inc(f"{pre}.bytes_sent", len(frame))
        _mx.inc(f"{pre}.msgs_sent")
        _mx.inc(f"comm.link.{msg.sender_id}.{msg.receiver_id}.bytes",
                len(frame))
        return frame

    def _decode_frame(self, frame: bytes) -> Message:
        t0 = time.perf_counter()
        msg = Message.decode(frame)
        pre = f"comm.{self.backend_name}"
        _mx.observe(f"{pre}.deserialize_s", time.perf_counter() - t0)
        _mx.inc(f"{pre}.bytes_recv", len(frame))
        _mx.inc(f"{pre}.msgs_recv")
        return msg

    @abc.abstractmethod
    def send_message(self, msg: Message) -> None: ...

    @abc.abstractmethod
    def handle_receive_message(self) -> None:
        """Blocking receive loop; returns when stopped."""

    @abc.abstractmethod
    def stop_receive_message(self) -> None: ...
