"""Transport abstraction (port of `fedml_tpu/comm/base.py`): a transport
moves encoded Message frames between integer-addressed processes; the
comm manager on top owns dispatch.

Every transport funnels its wire traffic through `_encode_frame` /
`_decode_frame`, which stamp the sender's trace context into the
message's headers (`Message.stamp_trace`) and feed the process-wide
instruments
(`utils/metrics.py`) under the JAX package's names:
`comm.<backend>.bytes_sent` / `bytes_recv` / `msgs_sent` / `msgs_recv`
counters, the `serialize_s` / `deserialize_s` histograms and the per-link
`comm.link.<src>.<dst>.bytes`. The wire codec plane (`comm/codec.py`)
hooks in here too: with a policy set (`set_codec`), `_encode_frame`
compresses a message's training payloads before framing, and
`_decode_frame` reverses any codec header a frame carries. Both note
each frame's header (type, sender, receiver, bytes and `msg.headers()`)
in the crash flight recorder's frame ring (`utils/postmortem.py`).
`set_link_telemetry(False)` turns the per-link byte counters off.
"""
from __future__ import annotations

import abc
import logging
import time

from ..utils import metrics as _mx
from ..utils import postmortem as _pm
from .message import Message

_log = logging.getLogger(__name__)

# the per-link byte counters (`comm.link.<src>.<dst>.bytes`), counted at
# the same encode choke point as the per-backend ones; a module switch so
# the plane's cost can be measured on against off
_link_telemetry = True


def set_link_telemetry(on: bool) -> None:
    global _link_telemetry
    _link_telemetry = bool(on)


def link_telemetry_enabled() -> bool:
    return _link_telemetry


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
        #: the wire codec plane: when set, `_encode_frame` compresses
        #: training payloads per message type and `_decode_frame` reverses
        #: them off the frame's own codec header. Attached to the innermost
        #: transport (create_transport does this before the chaos and
        #: reliable wrappers), so injected faults and retransmits see
        #: compressed frames.
        self._codec = None

    def set_codec(self, policy) -> None:
        """Attach a comm.codec.CodecPolicy (or None to disable)."""
        self._codec = policy

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
    def _encode_frame(self, msg: Message, stamp: bool = True) -> bytes:
        """Stamp the trace headers, compress (with a codec), serialize and
        count: the single choke point for outbound bytes on every
        transport. stamp=False keeps a frame byte-identical across a
        broadcast (the broker's content-addressed blob plane dedups by
        hash; the trace context rides its key frame instead)."""
        if stamp:
            msg.stamp_trace()
        if self._codec is not None:
            # idempotent per message object: a retransmit re-entering here
            # sees the codec header marker and passes through unchanged
            self._codec.encode_message(msg, self.backend_name)
        t0 = time.perf_counter()
        frame = msg.encode()
        pre = f"comm.{self.backend_name}"
        _mx.observe(f"{pre}.serialize_s", time.perf_counter() - t0)
        _mx.inc(f"{pre}.bytes_sent", len(frame))
        _mx.inc(f"{pre}.msgs_sent")
        if _link_telemetry:
            _mx.inc(f"comm.link.{msg.sender_id}.{msg.receiver_id}.bytes",
                    len(frame))
        _pm.note_frame("send", msg.type, msg.sender_id, msg.receiver_id,
                       len(frame), msg.headers())
        return frame

    def _decode_frame(self, frame: bytes) -> Message:
        t0 = time.perf_counter()
        msg = Message.decode(frame)
        # codec headers are self-describing, so this runs whatever the local
        # policy; a mismatched or unknown codec raises out of here and
        # `_notify_frame` counts and drops the frame
        from . import codec as _codec

        _codec.decode_message(msg, self._codec, self.backend_name)
        pre = f"comm.{self.backend_name}"
        _mx.observe(f"{pre}.deserialize_s", time.perf_counter() - t0)
        _mx.inc(f"{pre}.bytes_recv", len(frame))
        _mx.inc(f"{pre}.msgs_recv")
        _pm.note_frame("recv", msg.type, msg.sender_id, msg.receiver_id,
                       len(frame), msg.headers())
        return msg

    @abc.abstractmethod
    def send_message(self, msg: Message) -> None: ...

    @abc.abstractmethod
    def handle_receive_message(self) -> None:
        """Blocking receive loop; returns when stopped."""

    @abc.abstractmethod
    def stop_receive_message(self) -> None: ...
