"""Trace headers on the wire (`fedml_tpu_torch/comm/`), held against the
JAX package's comm layer on the same messages: a frame sent inside an
open span carries `_trace_id` / `_parent_span` on both sides, so under
the same injected ids (each package's `utils/events.trace_context`) the
frames are byte-equal; the broker's key frame carries `tid|sid` as
JAX's; a loopback send and its handler stitch into one trace
(tests/test_telemetry.py:181, :225 on the port)."""
import threading
import time
import uuid

import numpy as np
import pytest
import torch

from fedml_tpu.comm import broker as jb
from fedml_tpu.comm.loopback import LoopbackTransport as JaxLoopback
from fedml_tpu.comm.message import Message as JaxMessage
from fedml_tpu.utils import events as jev
from fedml_tpu_torch.comm import broker as pb
from fedml_tpu_torch.comm import FedCommManager
from fedml_tpu_torch.comm.loopback import LoopbackTransport, release_router
from fedml_tpu_torch.comm.message import (ARG_PARENT_SPAN, ARG_TRACE_ID,
                                          Message)
from fedml_tpu_torch.utils import events as pev
from fedml_tpu_torch.utils import postmortem as ppm

torch.set_num_threads(2)

TID, SID = "a1b2c3d4e5f60718", "0f1e2d3c4b5a6978"


def _params(seed=0):
    rs = np.random.default_rng(seed)
    return {"model_params": {"w": rs.standard_normal((6, 5)).astype(
        np.float32), "b": rs.standard_normal(5).astype(np.float32)},
        "num_samples": 12, "round_idx": 3}


def _frames(params, stamp_ids):
    """(port frame, JAX frame) of one message through each package's
    loopback `_encode_frame`, inside the same injected trace context (or
    outside any span)."""
    run = f"hdr-{uuid.uuid4().hex[:6]}"
    pt, jt = LoopbackTransport(0, run), JaxLoopback(0, run)
    try:
        if stamp_ids:
            with pev.trace_context(*stamp_ids):
                p = pt._encode_frame(Message("c2s_send_model", 1, 0,
                                             dict(params)))
            with jev.trace_context(*stamp_ids):
                j = jt._encode_frame(JaxMessage("c2s_send_model", 1, 0,
                                                dict(params)))
        else:
            p = pt._encode_frame(Message("c2s_send_model", 1, 0,
                                         dict(params)))
            j = jt._encode_frame(JaxMessage("c2s_send_model", 1, 0,
                                            dict(params)))
    finally:
        release_router(run)
    return p, j


@pytest.mark.parametrize("ids", [(TID, SID), (TID, None), None],
                         ids=["trace+parent", "trace-only", "no-span"])
def test_stamped_frames_byte_equal_to_jax(ids):
    """Byte equality of stamped (and unstamped) frames, and the decoded
    headers name the injected ids."""
    port, jax_frame = _frames(_params(), ids)
    assert port == jax_frame
    msg = Message.decode(port)
    if ids is None:
        assert msg.trace_context() == (None, None) and not msg.headers()
    else:
        assert msg.trace_context() == ids
        assert msg.headers() == {k: v for k, v in (
            (ARG_TRACE_ID, ids[0]), (ARG_PARENT_SPAN, ids[1])) if v}


def test_stamp_keeps_an_existing_trace_and_flight_ring_gets_headers():
    """A relay keeps the originating trace; the flight recorder's frame
    ring keeps each frame's headers (`msg.headers()`), as in JAX."""
    m = Message("x", 0, 1, {ARG_TRACE_ID: "orig", "v": 1})
    with pev.trace_context(TID, SID):
        m.stamp_trace()
    assert m.trace_context() == ("orig", None)
    run = f"hdr-{uuid.uuid4().hex[:6]}"
    t = LoopbackTransport(0, run)
    ppm.flight.set_enabled(True)
    try:
        with pev.trace_context(TID, SID):
            t._encode_frame(Message("ring", 0, 1, {"v": 2}))
    finally:
        release_router(run)
    last = ppm.flight._frames[-1]
    assert last[1:3] == ("send", "ring")
    assert last[6] == {ARG_TRACE_ID: TID, ARG_PARENT_SPAN: SID}


def _key_frame(mod, msg_cls, trace_mod, run):
    """The topic-plane frame a content-addressed broker carries for one
    blob-sized send inside the injected trace."""
    broker = mod.get_cas_broker(run)
    try:
        t = mod.BrokerTransport(0, run, broker=broker, blob_threshold=64)
        with trace_mod.trace_context(TID, SID):
            t.send_message(msg_cls("s2c_sync_model", 0, 2, _params(1)))
        return broker.poll(f"fedml_{run}_2", timeout=1.0), broker
    finally:
        mod.release_broker(run)


def test_broker_key_frame_byte_equal_to_jax():
    """The blob path's key frame is `key|receiver|tid|sid`, byte-equal to
    JAX's (the canonical blob is unstamped, so both packages address the
    same sha256); the receiver re-attaches the trace context."""
    run = f"bk-{uuid.uuid4().hex[:6]}"
    port, pbroker = _key_frame(pb, Message, pev, run + "p")
    jax_frame, _ = _key_frame(jb, JaxMessage, jev, run + "j")
    assert port is not None and port == jax_frame
    assert port.endswith(f"|2|{TID}|{SID}".encode())
    # the receive side: the blob decodes with the headers re-attached
    got = []
    broker = pb.get_cas_broker(run)
    try:
        tx = pb.BrokerTransport(0, run, broker=broker, blob_threshold=64)
        rx = pb.BrokerTransport(2, run, broker=broker, blob_threshold=64)

        class Obs:
            def receive_message(self, _t, msg):
                got.append(msg)

        rx.add_observer(Obs())
        with pev.trace_context(TID, SID):
            tx.send_message(Message("s2c_sync_model", 0, 2, _params(1)))
        th = threading.Thread(target=rx.handle_receive_message, daemon=True)
        th.start()
        deadline = time.monotonic() + 5
        while not got and time.monotonic() < deadline:
            time.sleep(0.01)
        rx.stop_receive_message()
        th.join(timeout=5)
    finally:
        pb.release_broker(run)
    assert got and got[0].trace_context() == (TID, SID)
    assert got[0].receiver_id == 2


def test_trace_stitches_across_loopback_send_handle():
    """A send inside a span and the receiver's handler span share one
    trace_id; the handle span's parent is the send span on the other
    side, and spans opened inside the handler inherit the trace."""
    run = f"telem-{uuid.uuid4().hex[:6]}"
    a = FedCommManager(LoopbackTransport(0, run), 0)
    b = FedCommManager(LoopbackTransport(1, run), 1)
    got = threading.Event()

    def handler(_msg):
        with pev.recorder.span("handler.work"):
            pass
        got.set()

    b.register_message_receive_handler("ping", handler)
    a.run(background=True)
    b.run(background=True)
    n0 = len(pev.recorder.spans)
    try:
        with pev.recorder.span("round.root") as root:
            a.send_message(Message("ping", 0, 1))
            assert got.wait(timeout=10)
        time.sleep(0.05)   # let the handle span close
    finally:
        a.stop()
        b.stop()
        release_router(run)
    spans = {s.name: s for s in pev.recorder.spans[n0:]}
    send, handle = spans["comm.send.ping"], spans["comm.handle.ping"]
    work = spans["handler.work"]
    assert send.trace_id == handle.trace_id == work.trace_id \
        == root.trace_id
    assert handle.parent_id == send.span_id
    assert work.parent_id == handle.span_id


def test_unstamped_message_gets_fresh_trace():
    """No open span: no headers, and the receiver's span starts a trace
    of its own (tests/test_telemetry.py's second case)."""
    m = Message("x", 0, 1)
    m.stamp_trace()
    assert ARG_TRACE_ID not in m.params
    assert m.trace_context() == (None, None)
    jm = JaxMessage("x", 0, 1)
    jm.stamp_trace()
    assert jm.params == m.params
