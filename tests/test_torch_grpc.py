"""The port's gRPC transport (`comm/grpc_transport.py`) against the JAX
package's, on the CPU over localhost.

A JAX rank and a port rank exchange messages: the bytes each receives
are the FT02 frame both packages encode for that message, and each side
decodes the other's. A 4-silo FedAvg federation over grpc is bitwise the
same federation over loopback. A black-holed peer fails a send with a
`grpc.RpcError` within the deadline; a peer restarted on its port is
reached after one reconnect. `load_ip_table` reads the JAX csv format,
and a host without the `grpc` package gets an ImportError naming it.

Ports come from bound sockets (the suite runs under several workers), and
every server is shut down in a `finally`.
"""
import socket
import sys
import uuid

import grpc
import numpy as np
import pytest
import torch

from fedml_tpu.comm.grpc_transport import GrpcTransport as JaxGrpc
from fedml_tpu.comm.grpc_transport import load_ip_table as jax_load_ip_table
from fedml_tpu.comm.message import Message as JaxMessage

from fedml_tpu_torch.comm import (
    FedCommManager, Message, create_transport, release_router,
)
from fedml_tpu_torch.comm.grpc_transport import (
    BASE_PORT, GrpcTransport, load_ip_table,
)
from fedml_tpu_torch.config import TrainArgs
from fedml_tpu_torch.cross_silo import (
    FedClientManager, FedServerManager, SiloTrainer,
)
from fedml_tpu_torch.models import hub
from fedml_tpu_torch.utils import metrics as mx

torch.set_num_threads(2)
DEADLINE = 0.5


def _free_ports(n: int) -> list[int]:
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _wait_port_closed(port: int, timeout: float = 20.0) -> None:
    import time

    end = time.monotonic() + timeout
    while time.monotonic() < end:
        with socket.socket() as s:
            if s.connect_ex(("127.0.0.1", port)) != 0:
                return
        time.sleep(0.05)
    raise AssertionError(f"port {port} still listens after {timeout} s")


def _counter(name: str) -> int:
    return mx.snapshot()["counters"].get(name, 0)


def test_jax_and_port_ranks_exchange_frames():
    p0, p1 = _free_ports(2)
    j = JaxGrpc(0, {1: f"127.0.0.1:{p1}"}, port=p0, rpc_timeout_s=5.0)
    t = None
    try:
        t = GrpcTransport(1, {0: f"127.0.0.1:{p0}"}, port=p1,
                          rpc_timeout_s=5.0)
        assert t.port == p1
        payload = {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
                   "b": np.linspace(0, 1, 5)}
        jm = JaxMessage("s2c_sync_model", 0, 1,
                        {"model_params": payload, "round_idx": 3})
        want = jm.encode()
        j.send_message(jm)
        frame = t._inbox.get(timeout=10)
        port_msg = Message("s2c_sync_model", 0, 1).add(
            "model_params", payload).add("round_idx", 3)
        assert frame == want == port_msg.encode()
        got = t._decode_frame(frame)
        assert got.get("round_idx") == 3
        for k, v in payload.items():
            np.testing.assert_array_equal(got.get("model_params")[k], v)

        up = {"w": np.full((2, 2), 0.5, np.float32)}
        t.send_message(Message("c2s_send_model", 1, 0).add(
            "model_params", up).add("num_samples", 32))
        back = j._inbox.get(timeout=10)
        assert back == JaxMessage("c2s_send_model", 1, 0, {
            "model_params": up, "num_samples": 32}).encode()
        jgot = j._decode_frame(back)
        np.testing.assert_array_equal(jgot.get("model_params")["w"], up["w"])
        assert jgot.get("num_samples") == 32
    finally:
        j.shutdown(grace=0)
        if t is not None:
            t.shutdown(grace=0)


# ------------------------------------------------------------ federation
def _mk_data(cid, n=48, d=8, k=3):
    rs = np.random.RandomState(cid)
    w = rs.randn(d, k)
    x = rs.randn(n + 8 * cid, d).astype(np.float32)
    y = np.argmax(x @ w, axis=1).astype(np.int32)
    return x, y


def _federation(backend: str, silos: int = 4, rounds: int = 2):
    run, ids = f"grpc-{uuid.uuid4().hex[:8]}", list(range(1, silos + 1))
    ports = _free_ports(silos + 1)
    table = {r: f"127.0.0.1:{p}" for r, p in enumerate(ports)}
    comms = [FedCommManager(create_transport(
        backend, r, run, ip_table=table if backend == "grpc" else None), r)
        for r in range(silos + 1)]
    model = hub.create("lr", 3, (8,), device="meta")
    init = {k: v.numpy() for k, v in hub.init_params(
        model, torch.Generator().manual_seed(0)).items()}
    srv = FedServerManager(comms[0], ids, init, rounds, device="cpu")
    cls = []
    for c in ids:
        x, y = _mk_data(c)
        tr = SiloTrainer(model, TrainArgs(epochs=1, batch_size=16,
                                          learning_rate=0.2), x, y,
                         seed=c, device="cpu")
        cls.append(FedClientManager(comms[c], c, tr))
    try:
        srv.run(background=True)
        for c in cls:
            c.run(background=True)
            c.announce_ready()
        assert srv.done.wait(60) and srv.error is None
        # every client has sent its last frame (no send still retrying
        # when the next test reads the grpc counters)
        assert all(c.done.wait(30) for c in cls)
    finally:
        for m in comms:
            if backend == "grpc":
                m.transport.shutdown(grace=0)
        release_router(run)
    return srv


def test_four_silo_federation_over_grpc_bitwise_loopback():
    ref = _federation("loopback")
    got = _federation("grpc")
    assert [h["n_received"] for h in got.history] == [4, 4]
    assert list(got.params) == list(ref.params)
    for k in ref.params:
        np.testing.assert_array_equal(got.params[k], ref.params[k])
    assert got.history == ref.history


# ------------------------------------------------------------ faults
def test_black_holed_peer_fails_within_the_deadline():
    import time

    sink = socket.socket()
    sink.bind(("127.0.0.1", 0))
    sink.listen(1)              # accepts connections, answers nothing
    t = GrpcTransport(0, {1: f"127.0.0.1:{sink.getsockname()[1]}"}, port=0,
                      rpc_timeout_s=DEADLINE, send_retries=0)
    try:
        errors = _counter("comm.grpc.send_errors")
        t0 = time.perf_counter()
        with pytest.raises(grpc.RpcError) as e:
            t.send_message(Message("x", 0, 1).add("w", np.ones(4)))
        assert time.perf_counter() - t0 < DEADLINE + 5.0
        assert e.value.code() == grpc.StatusCode.DEADLINE_EXCEEDED
        assert _counter("comm.grpc.send_errors") == errors + 1
    finally:
        t.shutdown(grace=0)
        sink.close()


def test_restarted_peer_is_reached_after_one_reconnect():
    pa, pb = _free_ports(2)
    table = {0: f"127.0.0.1:{pa}", 1: f"127.0.0.1:{pb}"}
    a = GrpcTransport(0, table, rpc_timeout_s=5.0, send_retries=1,
                      retry_backoff_s=0.0)
    b = GrpcTransport(1, table, rpc_timeout_s=5.0)
    peers = [b]
    try:
        assert (a.port, b.port) == (pa, pb)
        a.send_message(Message("m", 0, 1).add("i", 1))
        assert Message.decode(b._inbox.get(timeout=10)).get("i") == 1
        b.shutdown(grace=0)
        # gRPC binds with SO_REUSEPORT: until the old listener is gone, a
        # connection may land on it as it closes and be refused, so wait
        # until nothing listens on the port
        _wait_port_closed(pb)
        # the first send after the restart meets the dead connection; the
        # peer comes back on its port before the retry (inside the
        # reconnect, so the order is fixed)
        drop = a._drop_channel

        def restart_then_drop(rank):
            peers.append(GrpcTransport(1, table, rpc_timeout_s=5.0))
            drop(rank)

        a._drop_channel = restart_then_drop
        before = _counter("comm.grpc.reconnects")
        a.send_message(Message("m", 0, 1).add("i", 2))
        assert _counter("comm.grpc.reconnects") == before + 1
        assert Message.decode(peers[-1]._inbox.get(timeout=10)).get("i") == 2
    finally:
        a.shutdown(grace=0)
        for p in peers:
            p.shutdown(grace=0)


# ------------------------------------------------------------ setup
def test_load_ip_table_reads_the_jax_csv(tmp_path):
    path = tmp_path / "grpc_ipconfig.csv"
    path.write_text("receiver_id,ip\n# a comment\n0,10.0.0.1\n"
                    "1, 10.0.0.2 ,9001\n\n2,localhost\n")
    got = load_ip_table(str(path))
    assert got == jax_load_ip_table(str(path))
    assert got == {0: f"10.0.0.1:{BASE_PORT}", 1: "10.0.0.2:9001",
                   2: f"localhost:{BASE_PORT + 2}"}
    # a csv path goes through the factory, and the rank listens on its
    # own entry's port
    (port,) = _free_ports(1)
    path.write_text(f"0,127.0.0.1,{port}\n")
    t = create_transport("grpc", 0, ip_table=str(path))
    try:
        assert isinstance(t, GrpcTransport) and t.port == port
    finally:
        t.shutdown(grace=0)


def test_missing_grpc_package_names_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "grpc", None)
    with pytest.raises(ImportError, match="grpc"):
        create_transport("grpc", 0, ip_table={0: "127.0.0.1:1"})
