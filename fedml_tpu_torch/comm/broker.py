"""Broker transport: pub/sub with store-and-forward and a blob
side-channel (port of `fedml_tpu/comm/broker.py`; reference:
core/distributed/communication/mqtt_s3/mqtt_s3_multi_clients_comm_manager.py:
control messages ride an MQTT topic per receiver, model payloads go to S3
and the topic message carries the object key).

`InMemoryBroker` implements the broker contract in one process (tests,
one-host multi-org runs); a deployment points the same transport at any
store with topic-queue and blob semantics. Kept from MQTT+S3:

- store-and-forward: publishing to an absent receiver's topic queues the
  frame; the receiver drains it on (re)connect, so senders never block on
  a receiver's liveness.
- payload split: frames above `blob_threshold` go to the blob store and
  the topic message carries only the key.

`ContentAddressedBroker` is the web3 / thetastore shape: blobs keyed by
their sha256, deduplicated and verified on read.
"""
from __future__ import annotations

import hashlib
import threading
import time
import uuid
from collections import defaultdict, deque
from typing import Optional

from ..utils import metrics as _mx
from .base import BaseTransport
from .message import ARG_PARENT_SPAN, ARG_TRACE_ID, Message

_BLOB_KEY_PREFIX = b"BLOB:"


class InMemoryBroker:
    """Topic queues + blob store (the MQTT broker + S3 bucket pair)."""

    def __init__(self):
        self._topics: dict[str, deque] = defaultdict(deque)
        self._blobs: dict[str, bytes] = {}
        self._retained: dict[str, bytes] = {}
        self._cv = threading.Condition()

    # --- topic plane (MQTT)
    def publish(self, topic: str, frame: bytes) -> None:
        with self._cv:
            self._topics[topic].append(frame)
            self._cv.notify_all()

    # --- retained frames (MQTT's retain flag): the last frame a topic got,
    # read without removing it by any later reader; the artifact store's
    # name index (utils/artifacts.py) lives here
    def retain(self, topic: str, frame: bytes) -> None:
        with self._cv:
            self._retained[topic] = frame

    def retained(self, topic: str) -> Optional[bytes]:
        with self._cv:
            return self._retained.get(topic)

    def unretain(self, topic: str) -> None:
        with self._cv:
            self._retained.pop(topic, None)

    def poll(self, topic: str, timeout: float = 0.2) -> Optional[bytes]:
        with self._cv:
            if not self._topics[topic]:
                self._cv.wait(timeout)
            if self._topics[topic]:
                return self._topics[topic].popleft()
        return None

    def pending(self, topic: str) -> int:
        with self._cv:
            return len(self._topics[topic])

    # --- blob plane (S3)
    def put_blob(self, data: bytes) -> str:
        key = uuid.uuid4().hex
        with self._cv:
            self._blobs[key] = data
        return key

    def get_blob(self, key: str, delete: bool = True) -> bytes:
        """The blob under `key`, removed unless `delete` is False."""
        with self._cv:
            return self._blobs.pop(key) if delete else self._blobs[key]


class ContentAddressedBroker(InMemoryBroker):
    """Broker whose blob plane is CONTENT-ADDRESSED — the MQTT+Web3/Theta
    transport shape (reference: core/distributed/communication/
    mqtt_web3/mqtt_web3_comm_manager.py and mqtt_thetastore/ — decentralized
    stores address blobs by content hash, not bucket key). Semantics gained
    over the S3-style plane:

    - dedup: broadcasting one model to n clients stores ONE blob (the key
      is sha256(content)); refcounts track outstanding readers.
    - integrity: get_blob re-hashes and refuses tampered content — the
      decentralized-storage trust model, where the store is not trusted.
    """

    def __init__(self):
        super().__init__()
        self._refs: dict[str, int] = {}

    def put_blob(self, data: bytes) -> str:
        key = hashlib.sha256(data).hexdigest()
        with self._cv:
            if key in self._blobs:
                self._refs[key] += 1          # dedup hit
            else:
                self._blobs[key] = bytes(data)
                self._refs[key] = 1
        return key

    def get_blob(self, key: str, delete: bool = True) -> bytes:
        """The blob under `key`, verified; with `delete`, the last of its
        readers removes it."""
        with self._cv:
            data = self._blobs[key]
            if delete:
                self._refs[key] -= 1
                if self._refs[key] <= 0:
                    del self._blobs[key]
                    del self._refs[key]
        if hashlib.sha256(data).hexdigest() != key:
            raise ValueError(
                f"content-addressed blob {key[:12]}… failed hash "
                "verification — storage corrupted or tampered")
        return data


_brokers: dict[str, InMemoryBroker] = {}
_brokers_lock = threading.Lock()


def get_broker(broker_id: str = "default") -> InMemoryBroker:
    with _brokers_lock:
        if broker_id not in _brokers:
            _brokers[broker_id] = InMemoryBroker()
        return _brokers[broker_id]


def get_cas_broker(broker_id: str = "default") -> ContentAddressedBroker:
    """Shared content-addressed broker for a run (the web3 backend's
    registry; namespaced so a run can use both planes side by side)."""
    key = f"cas:{broker_id}"
    with _brokers_lock:
        if key not in _brokers:
            _brokers[key] = ContentAddressedBroker()
        return _brokers[key]  # type: ignore[return-value]


def release_broker(broker_id: str) -> None:
    """Drops BOTH planes of a run: the plain broker and its content-
    addressed companion (get_cas_broker registers under cas:<id>) — a
    survivor would hand stale store-and-forward frames to the next run
    that reuses the id."""
    with _brokers_lock:
        _brokers.pop(broker_id, None)
        _brokers.pop(f"cas:{broker_id}", None)


class BrokerTransport(BaseTransport):
    """MQTT+S3-style transport over a broker object (reference:
    mqtt_s3_multi_clients_comm_manager.py:  topic fedml_<run>_<rank>, S3 for
    model params). Messages survive receiver downtime in the topic queue."""

    backend_name = "broker"

    def __init__(self, rank: int, run_id: str = "default",
                 broker: Optional[InMemoryBroker] = None,
                 blob_threshold: int = 16 * 1024,
                 publish_retries: int = 2, retry_backoff_s: float = 0.05):
        super().__init__()
        self.rank = rank
        self.run_id = run_id
        self.broker = broker if broker is not None else get_broker(run_id)
        self.blob_threshold = blob_threshold
        # publish retry: the in-memory broker never fails, but the broker
        # contract exists to be pointed at a real store, where a transient
        # publish or put failure should cost a retry, not the run
        self.publish_retries = int(publish_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        # out-of-band stop: an in-band sentinel could be left queued in the
        # topic and would kill the NEXT transport that reconnects to it,
        # stranding store-and-forward frames behind the stale marker
        self._stop_event = threading.Event()

    def _topic(self, rank: int) -> str:
        return f"fedml_{self.run_id}_{rank}"

    def _with_retry(self, what: str, fn):
        """Run a broker-store call with bounded retry + linear backoff;
        attempts beyond the first are counted as comm.broker.<what>_retries.
        The final failure propagates — callers see the same exception they
        always did, just after the transient window has been ridden out."""
        import logging

        for attempt in range(self.publish_retries + 1):
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 — broker-store contract
                if attempt >= self.publish_retries:
                    raise
                _mx.inc(f"comm.broker.{what}_retries")
                logging.getLogger(__name__).warning(
                    "broker %s failed (attempt %d/%d, retrying): %s: %s",
                    what, attempt + 1, self.publish_retries + 1,
                    type(e).__name__, e)
                time.sleep(self.retry_backoff_s * (attempt + 1))

    def send_message(self, msg: Message) -> None:
        # the receiver-canonical frame first (receiver forced to -1): on
        # the blob path it is the only full serialization, and a broadcast
        # of one payload to n receivers is then byte-identical, so the
        # content-addressed plane stores one blob, refcounted n. Below the
        # threshold the re-encode with the true receiver is cheap by
        # definition. Byte / message counters and serialize time ride the
        # canonical encode (the frame that carries the payload).
        # stamp=False: per-send trace headers inside the canonical frame
        # would break the broadcast's dedup; the trace context rides the
        # topic-plane key frame below instead.
        canonical = self._encode_frame(
            Message(msg.type, msg.sender_id, -1, msg.params), stamp=False)
        if len(canonical) > self.blob_threshold:
            key = self._with_retry(
                "blob_put", lambda: self.broker.put_blob(canonical))
            from ..utils.events import current_trace

            tid, sid = current_trace()
            frame = _BLOB_KEY_PREFIX + "|".join(
                (key, str(msg.receiver_id), tid or "", sid or "")).encode()
            _mx.inc("comm.broker.blob_puts")
            _mx.inc("comm.broker.bytes_sent", len(frame))  # topic-plane key
        else:
            # the true-receiver re-encode (trace headers stamped here:
            # inline frames never reach the content-addressed plane); the
            # payload's bytes were counted above
            msg.stamp_trace()
            frame = msg.encode()
        t0 = time.perf_counter()
        self._with_retry(
            "publish",
            lambda: self.broker.publish(self._topic(msg.receiver_id), frame))
        _mx.observe("comm.broker.publish_s", time.perf_counter() - t0)

    def handle_receive_message(self) -> None:
        # NOTE: no clear() here — a stop() issued before this thread is
        # scheduled must win, or the loop would spin forever; a stopped
        # transport is done (build a new one to reconnect).
        topic = self._topic(self.rank)
        while not self._stop_event.is_set():
            # poll_s measures the DEQUEUE cost only: a non-blocking poll is
            # timed (pure transport work on a non-empty queue — the
            # store-and-forward backlog case); when the queue is empty the
            # blocking wait runs untimed, so idle/inter-arrival gaps never
            # pollute the histogram
            t0 = time.perf_counter()
            frame = self.broker.poll(topic, timeout=0)
            if frame is not None:
                _mx.observe("comm.broker.poll_s", time.perf_counter() - t0)
            else:
                frame = self.broker.poll(topic, timeout=0.2)
            if frame is None:
                continue
            if frame.startswith(_BLOB_KEY_PREFIX):
                parts = frame[len(_BLOB_KEY_PREFIX):].decode().split("|")
                key, receiver = parts[0], parts[1] if len(parts) > 1 else ""
                msg = self._decode_frame(self.broker.get_blob(key))
                msg.receiver_id = int(receiver) if receiver else self.rank
                # the trace context the dedup-friendly canonical frame left
                # out rode the key frame
                if len(parts) > 2 and parts[2]:
                    msg.params[ARG_TRACE_ID] = parts[2]
                    if len(parts) > 3 and parts[3]:
                        msg.params[ARG_PARENT_SPAN] = parts[3]
                self._notify(msg)
                continue
            self._notify(self._decode_frame(frame))

    def stop_receive_message(self) -> None:
        self._stop_event.set()
