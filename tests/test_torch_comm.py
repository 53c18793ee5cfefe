"""The port's message layer (`fedml_tpu_torch.comm`) against the JAX
package's (`fedml_tpu.comm`), on the CPU.

Bitwise bars: the port's frames are the JAX frames byte for byte (FT02
with its CRC-32C trailer, bf16 leaves included), each package decodes the
other's, both refuse the same corrupted frames, and `ChaosTransport`
makes the same drop / duplicate / delay / reorder / corrupt and crash /
flap decisions for one plan and one send sequence (the delivered frames
and their delays are compared). `ReliableTransport` over such a plan
delivers every message exactly once; the unported transports and the
wire codec are refused naming their ROADMAP item.
"""
import threading
import time
import uuid

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp
    import ml_dtypes

    from fedml_tpu.comm import base as jax_base
    from fedml_tpu.comm import chaos as jax_chaos
    from fedml_tpu.comm import message as jax_message
    from fedml_tpu.comm import serialization as jax_ser
    from fedml_tpu.native import crc32c as jax_crc32c
except ModuleNotFoundError:
    pass

from fedml_tpu_torch.comm import (
    ChaosTransport, FaultSpec, FedCommManager, LoopbackTransport, Message,
    ReliableTransport, RetryPolicy, create_transport, decode, encode,
    release_router,
)
from fedml_tpu_torch.comm import base as port_base
from fedml_tpu_torch.native import crc32c
from fedml_tpu_torch.utils import metrics as mx

torch.set_num_threads(2)


def _run_id(tag: str) -> str:
    return f"{tag}-{uuid.uuid4().hex[:8]}"


def _trees():
    """(name, numpy tree for both encoders) cases: f32, ints, bool, bf16
    leaves, tuples, scalars and nesting."""
    rs = np.random.RandomState(0)
    bf = rs.randn(3, 5).astype(np.float32).astype(ml_dtypes.bfloat16)
    return [
        ("f32", {"w": rs.randn(4, 3).astype(np.float32),
                 "b": np.zeros(3, np.float32)}),
        ("ints", {"i32": np.arange(7, dtype=np.int32),
                  "i64": np.arange(-3, 3, dtype=np.int64).reshape(2, 3),
                  "u8": np.arange(250, 256, dtype=np.uint8),
                  "bool": np.array([True, False, True])}),
        ("bf16", {"p": bf, "scale": np.float32(0.5)}),
        ("tuples_scalars", {"t": (1, 2.5, "x", None, True),
                            "n": np.int64(7), "f": np.float64(1.25),
                            "empty": np.zeros((0, 4), np.float32),
                            "s": np.float32(3.0)}),
        ("nested", {"model_params": {"Dense_0.kernel": rs.randn(8, 3)
                                     .astype(np.float32)},
                    "round_idx": 3, "list": [np.arange(4), {"a": 1}],
                    "msg": {"msg_type": "c2s_send_model", "sender": 1}}),
    ]


CASES = ["f32", "ints", "bf16", "tuples_scalars", "nested"]


def _case(name):
    return dict(_trees())[name]


def _equal(a, b) -> bool:
    """Structural equality of decoded trees (bf16 tensors by their bits)."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        ta = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.asarray(a).view(np.int16)).view(torch.bfloat16)
        tb = b if isinstance(b, torch.Tensor) else torch.from_numpy(
            np.asarray(b).view(np.int16)).view(torch.bfloat16)
        return torch.equal(ta.view(torch.int16), tb.view(torch.int16))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    if isinstance(a, dict):
        return set(a) == set(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(
            _equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.generic):   # numpy scalars travel as JSON numbers
        a = a.item()
    return a == b and type(a) is type(b)


# ------------------------------------------------------------ wire format
@pytest.mark.parametrize("name", CASES)
def test_encode_is_byte_equal_to_jax(name):
    tree = _case(name)
    ours = encode(tree)
    assert ours[:4] == b"FT02" and ours[-8:-4] == b"C32C"
    assert ours == jax_ser.encode(tree)


def test_torch_and_jax_arrays_frame_alike():
    """Torch tensors (f32 and bf16) frame as the JAX package frames its own
    arrays of the same values."""
    rs = np.random.RandomState(1)
    w = rs.randn(6, 4).astype(np.float32)
    ours = encode({"w": torch.from_numpy(w),
                   "h": torch.from_numpy(w).to(torch.bfloat16),
                   "i": torch.arange(5, dtype=torch.int64)})
    theirs = jax_ser.encode({"w": jnp.asarray(w),
                             "h": jnp.asarray(w, jnp.bfloat16),
                             "i": np.arange(5, dtype=np.int64)})
    assert ours == theirs


@pytest.mark.parametrize("name", CASES)
def test_each_package_decodes_the_others_frames(name):
    tree = _case(name)
    mine = decode(jax_ser.encode(tree))
    theirs = jax_ser.decode(encode(tree))
    assert _equal(tree, mine) and _equal(tree, theirs)
    if name == "bf16":
        assert mine["p"].dtype == torch.bfloat16


def test_crc_matches_jax_native():
    rs = np.random.RandomState(2)
    for n in (0, 1, 7, 4096, 100_003):
        data = rs.randint(0, 256, n).astype(np.uint8).tobytes()
        assert crc32c(data) == jax_crc32c(data)
        assert crc32c(memoryview(data)) == jax_crc32c(data)


@pytest.mark.parametrize("where", ["header", "payload", "trailer"])
def test_corrupted_frame_refused_as_in_jax(where):
    frame = bytearray(encode(_case("f32")))
    (hlen,) = np.frombuffer(bytes(frame[4:8]), "<u4")
    i = {"header": 12, "payload": 8 + int(hlen) + 5,
         "trailer": len(frame) - 2}[where]
    frame[i] ^= 0xFF
    for dec in (decode, jax_ser.decode):
        with pytest.raises(ValueError, match="CRC mismatch"):
            dec(bytes(frame))
    for dec in (decode, jax_ser.decode):
        with pytest.raises(ValueError, match="bad frame magic"):
            dec(b"XXXX" + bytes(frame[4:]))
        with pytest.raises(ValueError, match="missing its CRC trailer"):
            dec(bytes(frame[:-8]) + b"ABCD" + bytes(frame[-4:]))


def test_trailerless_frames_are_read():
    frame = jax_ser.encode(_case("nested"))
    ft01 = b"FT01" + frame[4:-8]
    assert _equal(decode(ft01), _case("nested"))


def test_encode_refuses_what_jax_refuses():
    for bad in ({"x": object()}, {1: np.zeros(2)}):
        with pytest.raises(TypeError):
            encode(bad)
        with pytest.raises(TypeError):
            jax_ser.encode(bad)


# ------------------------------------------------------ message, loopback
def test_message_roundtrip_and_jax_frame():
    m = Message("t", 1, 2).add("model_params", {"w": np.ones(3)}).add(
        "_rel_seq", 4)
    m2 = Message.decode(m.encode())
    assert (m2.type, m2.sender_id, m2.receiver_id) == ("t", 1, 2)
    assert np.array_equal(m2.get("model_params")["w"], np.ones(3))
    assert m2.get("_rel_seq") == 4
    jm = jax_message.Message("t", 1, 2, {"model_params": {"w": np.ones(3)},
                                         "_rel_seq": 4})
    assert m.encode() == jm.encode()


def test_loopback_dispatch_and_unknown_handler():
    run = _run_id("t-loop")
    mgr = FedCommManager(LoopbackTransport(0, run), rank=0)
    got = threading.Event()
    seen = []
    mgr.register_message_receive_handler(
        "ping", lambda m: (seen.append(m.get("x")), got.set()))
    before = mx.snapshot()["counters"].get("comm.msgs_unhandled", 0)
    mgr.run(background=True)
    sender = FedCommManager(LoopbackTransport(1, run), rank=1)
    try:
        sender.send_message(Message("nobody_handles_this", 1, 0))
        sender.send_message(Message("ping", 1, 0).add("x", 42))
        assert got.wait(10), "the ping never arrived"
        assert seen == [42]
        assert mx.snapshot()["counters"]["comm.msgs_unhandled"] == before + 1
        c = mx.snapshot()["counters"]
        assert c["comm.loopback.msgs_sent"] >= 2
        assert c["comm.loopback.bytes_recv"] > 0
    finally:
        mgr.stop()
        release_router(run)


# ------------------------------------------------------------------ chaos
PLANS = {
    "link_faults": dict(seed=11, drop=0.2, duplicate=0.2, delay=0.3,
                        delay_max_s=0.05, reorder=0.2, corrupt=0.2),
    "crash_flap": dict(seed=5, duplicate=0.3, corrupt=0.1,
                       flap={0: {"up": 3, "down": 2}}, crash={0: 17}),
}


def _recording_inner(base_cls):
    class Rec(base_cls):
        backend_name = "loopback"

        def __init__(self):
            super().__init__()
            self.rank = 0
            self.wire = []

        def _send_raw(self, frame, receiver_id):
            self.wire.append((receiver_id, bytes(frame)))

        def send_message(self, msg):
            self._send_raw(self._encode_frame(msg), msg.receiver_id)

        def handle_receive_message(self):
            pass

        def stop_receive_message(self):
            pass

    return Rec()


def _chaos_trace(chaos_cls, base_cls, msg_cls, plan, sends):
    inner = _recording_inner(base_cls)
    ct = chaos_cls(inner, plan)
    delays = []

    def deliver(fn, delay_s):
        delays.append(delay_s)
        fn()

    ct._deliver = deliver
    for dst, i in sends:
        ct.send_message(msg_cls("probe", 0, dst, {"i": i,
                                                  "w": np.full(4, i, np.float32)}))
    return delays, inner.wire


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_chaos_decisions_bitwise_equal_jax(plan):
    """The same plan against the same sends: the same frames are delivered
    (corrupted at the same byte), with the same delays, in the same
    order, and the same number of each fault is counted."""
    sends = [(1 + (i % 3), i) for i in range(60)]
    spec = FaultSpec(**PLANS[plan])
    jspec = jax_chaos.FaultSpec(**PLANS[plan])

    def faults():
        return {k: v for k, v in mx.snapshot()["counters"].items()
                if k.startswith("fed.chaos.")}

    before = faults()
    ours = _chaos_trace(ChaosTransport, port_base.BaseTransport, Message,
                        spec, sends)
    counted = {k: v - before.get(k, 0) for k, v in faults().items()
               if v != before.get(k, 0)}
    theirs = _chaos_trace(jax_chaos.ChaosTransport, jax_base.BaseTransport,
                          jax_message.Message, jspec, sends)
    assert ours[0] == theirs[0]
    assert ours[1] == theirs[1]
    # the plan did inject faults of every kind it names
    kinds = {"drop", "duplicate", "corrupt", "delay", "reorder"} \
        if plan == "link_faults" else {"duplicate", "corrupt", "flap_drops",
                                       "crash_drops"}
    assert {k.removeprefix("fed.chaos.") for k in counted} >= kinds
    assert len(ours[1]) != len(sends)


def _reliable_pair(run, plan, policy):
    spec = FaultSpec(**plan)
    mk = lambda r: FedCommManager(  # noqa: E731
        ReliableTransport(ChaosTransport(LoopbackTransport(r, run), spec),
                          policy), r)
    return mk(0), mk(1)


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_reliable_delivers_exactly_once_in_order(plan):
    """Stop-and-wait over the chaos plan: each message is sent after the
    previous one arrived, and every one arrives exactly once, in order;
    then a burst of 30 arrives exactly once as a set."""
    p = dict(PLANS[plan], delay_max_s=0.01)
    p.pop("crash", None)      # a crashed link never recovers
    run = _run_id("t-rel")
    policy = RetryPolicy(ack_timeout_s=0.03, max_attempts=40,
                         deadline_s=30.0)
    a, b = _reliable_pair(run, p, policy)
    got, arrived = [], threading.Event()
    lock = threading.Lock()

    def on_probe(m):
        with lock:
            got.append(m.get("i"))
        arrived.set()

    b.register_message_receive_handler("probe", on_probe)
    a.run(background=True)
    b.run(background=True)
    try:
        for i in range(20):
            arrived.clear()
            a.send_message(Message("probe", 0, 1).add("i", i))
            assert arrived.wait(20), f"message {i} never arrived"
        with lock:
            assert got == list(range(20))
        for i in range(20, 50):
            a.send_message(Message("probe", 0, 1).add("i", i))
        assert a.transport.flush(30), "the sender never drained"
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            with lock:
                if len(set(got)) == 50:
                    break
            arrived.clear()
            arrived.wait(0.2)
        with lock:
            assert sorted(set(got)) == list(range(50))
            assert len(got) == len(set(got)), "a message was applied twice"
        assert a.transport.failed == []
    finally:
        a.stop()
        b.stop()
        release_router(run)


def test_reliable_gives_up_loudly_on_a_dead_peer():
    run = _run_id("t-dead")
    before = mx.snapshot()["counters"].get("comm.rel.delivery_failed", 0)
    a = FedCommManager(ReliableTransport(
        ChaosTransport(LoopbackTransport(0, run), FaultSpec(drop=1.0)),
        RetryPolicy(ack_timeout_s=0.02, max_attempts=3, deadline_s=5.0)), 0)
    try:
        a.send_message(Message("x", 0, 1))
        assert a.transport.flush(10)
        assert [f["attempts"] for f in a.transport.failed] == [3]
        assert mx.snapshot()["counters"]["comm.rel.delivery_failed"] \
            == before + 1
    finally:
        a.transport.stop_receive_message()
        release_router(run)


# ------------------------------------------------------------- refusals
@pytest.mark.parametrize("backend", ["grpc", "broker", "mqtt_s3", "web3"])
def test_unported_transports_refused(backend):
    with pytest.raises(NotImplementedError, match="item 5"):
        create_transport(backend, 0, run_id=_run_id("t-refuse"))


def test_codec_refused_and_xla_is_no_transport():
    with pytest.raises(NotImplementedError, match="item 5"):
        create_transport("loopback", 0, run_id=_run_id("t-codec"),
                         comm_codec={"kind": "sparse_topk", "ratio": 0.1})
    with pytest.raises(ValueError, match="not a message transport"):
        create_transport("xla", 0)
    with pytest.raises(ValueError, match="unknown comm backend"):
        create_transport("carrier_pigeon", 0)


def test_retry_and_chaos_knobs_validated_at_config_load():
    from fedml_tpu_torch.config import Config

    with pytest.raises(ValueError, match="comm_retry"):
        Config.from_dict({"common_args": {"extra": {
            "comm_retry": {"max_attempts": 0}}}})
    with pytest.raises(ValueError, match="unknown common_args.extra.chaos"):
        Config.from_dict({"common_args": {"extra": {"chaos": {"dorp": 1}}}})
    with pytest.raises(ValueError, match="quorum_frac"):
        Config.from_dict({"train_args": {"quorum_frac": 1.5}})
    with pytest.raises(ValueError, match="round_timeout"):
        Config.from_dict({"train_args": {"round_timeout": -1}})
