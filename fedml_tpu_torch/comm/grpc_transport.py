"""gRPC transport: cross-silo messaging with the FT02 frame as the RPC
payload (port of `fedml_tpu/comm/grpc_transport.py`; reference:
core/distributed/communication/grpc/grpc_comm_manager.py — one server per
process at GRPC_BASE_PORT + rank).

- No protoc: the service `/fedml_tpu.Comm/Send` is registered with raw
  bytes (de)serializers through `grpc.method_handlers_generic_handler`, so
  the frame (`comm/serialization.py`) is the payload, byte for byte the
  JAX transport's, and a JAX rank and a port rank exchange frames.
- The ip table: a {rank: "host:port"} dict or a csv of
  `receiver_id,ip[,port]` rows (the reference's grpc_ipconfig.csv). A
  rank listens on its own entry's port (the JAX transport listens on
  BASE_PORT + rank whatever its entry says; the two agree on a table of
  default ports), unless `port` is given.
- Each RPC has a deadline (`rpc_timeout_s`); a send that finds the peer
  UNAVAILABLE rebuilds the channel and retries (`comm.grpc.reconnects`,
  `send_retries`, `send_errors`, `publish_s`).

The `grpc` package is imported when a transport is built, not when this
module is imported: a host without it (the H100 machine) imports the port
and fails only when a grpc transport is asked for, with an ImportError
that names the package.
"""
from __future__ import annotations

import csv
import queue
import threading
import time
from concurrent import futures
from typing import Optional

from ..utils import metrics as _mx
from .base import BaseTransport
from .message import Message

_SERVICE = "fedml_tpu.Comm"
_METHOD = "Send"
_FULL_METHOD = f"/{_SERVICE}/{_METHOD}"
BASE_PORT = 8890  # reference: grpc_comm_manager.py GRPC_BASE_PORT


def _import_grpc():
    try:
        import grpc
    except ImportError as e:
        raise ImportError(
            "the gRPC transport needs the `grpc` package (grpcio), which "
            "this host does not have; use the loopback or broker "
            "transport") from e
    return grpc


def load_ip_table(path: str) -> dict[int, str]:
    """csv rows: receiver_id,ip[,port] (reference: grpc_ipconfig.csv); a
    header row or a row starting with "#" is skipped, the port defaults to
    BASE_PORT + rank."""
    table = {}
    with open(path) as f:
        for row in csv.reader(f):
            if not row or row[0].strip().startswith("#") \
                    or row[0] == "receiver_id":
                continue
            rank = int(row[0])
            host = row[1].strip()
            port = int(row[2]) if len(row) > 2 else BASE_PORT + rank
            table[rank] = f"{host}:{port}"
    return table


class GrpcTransport(BaseTransport):
    backend_name = "grpc"

    def __init__(self, rank: int, ip_table: dict[int, str],
                 port: Optional[int] = None, max_workers: int = 4,
                 max_message_mb: int = 512,
                 rpc_timeout_s: Optional[float] = 30.0,
                 send_retries: int = 2, retry_backoff_s: float = 0.1):
        """rpc_timeout_s: the per-RPC deadline, so a black-holed peer
        fails the send with DEADLINE_EXCEEDED instead of hanging a round
        (None: no deadline); `create_transport` takes it from
        `comm_retry.rpc_timeout_s`. send_retries: retries on UNAVAILABLE
        only (the peer was never reached, so a resend cannot duplicate),
        each on a rebuilt channel so that a restarted peer is reached. A
        deadline expiry is not retried here: the request may have been
        delivered with only the answer lost, and only the reliable
        layer's dedup (`comm/reliable.py`) makes that resend safe."""
        super().__init__()
        grpc = self._grpc = _import_grpc()
        self.rank = rank
        self.ip_table = dict(ip_table)
        if port is None:
            # listen where the table tells peers to reach this rank
            own = self.ip_table.get(rank)
            port = int(own.rsplit(":", 1)[1]) if own else BASE_PORT + rank
        self.port = port
        self.rpc_timeout_s = rpc_timeout_s
        self.send_retries = int(send_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self._ch_lock = threading.Lock()
        self._inbox: queue.Queue = queue.Queue()
        self._running = False
        self._opts = [
            ("grpc.max_send_message_length", max_message_mb * 1024 * 1024),
            ("grpc.max_receive_message_length",
             max_message_mb * 1024 * 1024),
        ]

        def handle_send(request: bytes, context) -> bytes:
            self._inbox.put(request)
            return b"ok"

        handler = grpc.method_handlers_generic_handler(_SERVICE, {
            _METHOD: grpc.unary_unary_rpc_method_handler(
                handle_send,
                request_deserializer=None,   # raw bytes in
                response_serializer=None,    # raw bytes out
            )
        })
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers),
            options=self._opts)
        self._server.add_generic_rpc_handlers((handler,))
        bound = self._server.add_insecure_port(f"[::]:{self.port}")
        if bound == 0:
            raise RuntimeError(
                f"rank {rank}: could not bind gRPC server to port "
                f"{self.port} (already in use?)")
        self.port = bound      # the ephemeral port when `port` was 0
        self._server.start()
        self._channels: dict = {}

    def _stub(self, rank: int):
        with self._ch_lock:
            if rank not in self._channels:
                # subchannels of its own: a rebuilt channel must not take
                # over the dropped one's connection from gRPC's
                # process-wide pool while it still backs off from the
                # dead peer
                self._channels[rank] = self._grpc.insecure_channel(
                    self.ip_table[rank], options=self._opts + [
                        ("grpc.use_local_subchannel_pool", 1)])
            ch = self._channels[rank]
        return ch.unary_unary(
            _FULL_METHOD, request_serializer=None, response_deserializer=None)

    def _drop_channel(self, rank: int) -> None:
        with self._ch_lock:
            ch = self._channels.pop(rank, None)
        if ch is not None:
            ch.close()

    def send_message(self, msg: Message) -> None:
        self._send_raw(self._encode_frame(msg), msg.receiver_id)

    def _send_raw(self, frame: bytes, receiver_id: int) -> None:
        # publish latency is the blocking unary RPC: the wire and the
        # remote handler's enqueue
        grpc = self._grpc
        t0 = time.perf_counter()
        attempt = 0
        while True:
            try:
                self._stub(receiver_id)(frame, timeout=self.rpc_timeout_s)
                break
            except grpc.RpcError as e:
                _mx.inc("comm.grpc.send_errors")
                code = e.code() if hasattr(e, "code") else None
                if (code == grpc.StatusCode.UNAVAILABLE
                        and attempt < self.send_retries):
                    # a dead subchannel stays dead until rebuilt, and a
                    # restarted peer needs a fresh channel
                    attempt += 1
                    _mx.inc("comm.grpc.reconnects")
                    _mx.inc("comm.grpc.send_retries")
                    self._drop_channel(receiver_id)
                    time.sleep(self.retry_backoff_s * attempt)
                    continue
                raise
        _mx.observe("comm.grpc.publish_s", time.perf_counter() - t0)

    def handle_receive_message(self) -> None:
        self._running = True
        while self._running:
            try:
                frame = self._inbox.get(timeout=0.2)
            except queue.Empty:
                continue
            if frame is None:
                break
            self._notify_frame(frame)

    def stop_receive_message(self) -> None:
        self.shutdown(grace=1.0)

    def shutdown(self, grace: float = 1.0) -> None:
        """Release the server's port and the peer channels. grace 0 for a
        bind probe; the default waits out RPCs in flight (peers may still
        be sending their last acks)."""
        self._running = False
        self._inbox.put(None)
        self._server.stop(grace=grace).wait(timeout=2.0)
        with self._ch_lock:
            channels, self._channels = list(self._channels.values()), {}
        for ch in channels:
            ch.close()
