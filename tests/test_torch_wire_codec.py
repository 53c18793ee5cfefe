"""The port's wire codec plane (`fedml_tpu_torch.comm.codec`, its hooks in
`comm/base.py` and `create_transport(comm_codec=)`) against the JAX
package's, case by case after `tests/test_wire_codec.py`, on the CPU.

Frames are compared byte for byte on payloads both packages are given the
same way (plain dicts of numpy arrays: the digests walk the payload tree,
and a JAX model tree is nested where the port's is flat), and each
package decodes the other's frame to the same arrays. Streams, residuals
and anchors are bitwise.
"""
import copy
import threading
import time
import uuid

import numpy as np
import pytest
import torch

from fedml_tpu.comm import Message as JMessage
from fedml_tpu.comm.codec import decode_message as jax_decode
from fedml_tpu.comm.codec import make_policy as jax_policy
from fedml_tpu.comm.codec import validate_comm_codec as jax_validate
from fedml_tpu.config import Config as JaxConfig
from fedml_tpu_torch.comm import (
    BrokerTransport, ChaosTransport, CodecPolicy, FaultSpec, FedCommManager,
    LoopbackTransport, Message, ReliableTransport, RetryPolicy,
    create_transport, release_broker, release_router,
)
from fedml_tpu_torch.comm.codec import (
    decode_message, make_policy, tree_digest, validate_comm_codec,
)
from fedml_tpu_torch.compression import decode_sparse, encode_sparse
from fedml_tpu_torch.config import Config, TrainArgs
from fedml_tpu_torch.cross_silo import (
    FedClientManager, FedServerManager, SiloTrainer,
)
from fedml_tpu_torch.models import hub
from fedml_tpu_torch.utils import metrics as mx

torch.set_num_threads(2)


def _run_id(tag):
    return f"{tag}-{uuid.uuid4().hex[:8]}"


def _mk_data(seed, n=64, d=8, k=3):
    rs = np.random.RandomState(seed)
    w = rs.randn(d, k)
    x = rs.randn(n, d).astype(np.float32)
    y = np.argmax(x @ w, axis=1).astype(np.int32)
    return x, y


def _encode_both(mtype, params, cfg, port_pol=None, jax_pol=None,
                 sender=0, receiver=1):
    """The same message encoded by each package's policy: (port frame,
    JAX frame, port policy, JAX policy)."""
    port_pol = port_pol or make_policy(cfg)
    jax_pol = jax_pol or jax_policy(cfg)
    pm = Message(mtype, sender, receiver, copy.deepcopy(params))
    jm = JMessage(mtype, sender, receiver, copy.deepcopy(params))
    port_pol.encode_message(pm, "loopback")
    jax_pol.encode_message(jm, "loopback")
    return pm.encode(), jm.encode(), port_pol, jax_pol


def _decode(frame, pol):
    out = Message.decode(frame)
    decode_message(out, pol, "loopback")
    return out


def _jax_decode(frame, pol):
    out = JMessage.decode(frame)
    jax_decode(out, pol, "loopback")
    return out


def _tree_eq(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and all(
            _tree_eq(a[k], b[k]) for k in a)
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


# ------------------------------------------------------------- frames
_PAYLOAD = {"w": np.random.RandomState(0).randn(300).astype(np.float32),
            "m": np.random.RandomState(1).randn(40, 9).astype(np.float32),
            "n": np.arange(5, dtype=np.int64)}
# (codec kind, message type, payload key, config)
_KINDS = {
    "sparse_topk": ("probe", "model_params",
                    {"kind": "sparse_topk", "ratio": 0.25,
                     "per_type": {"probe": "sparse_topk"}}),
    "sparse_topk_fp16": ("probe", "model_params",
                         {"kind": "sparse_topk", "ratio": 0.1,
                          "val_bits": 16,
                          "per_type": {"probe": "sparse_topk"}}),
    "qsgd": ("probe", "model_params",
             {"kind": "qsgd", "bits": 6, "per_type": {"probe": "qsgd"}}),
    "dense": ("c2s_send_model", "model_params", {"kind": "dense"}),
    "field_pack": ("c2s_sa_masked", "sa_masked", {"kind": "dense"}),
}


@pytest.mark.parametrize("kind", sorted(_KINDS))
def test_frame_byte_equal_jax_and_cross_decodes(kind):
    mtype, key, cfg = _KINDS[kind]
    payload = (np.random.RandomState(4).randint(
        0, 2**31 - 1, size=512).astype(np.int64) if key == "sa_masked"
        else _PAYLOAD)
    snap0 = mx.snapshot()["counters"]
    pf, jf, pp, jp = _encode_both(mtype, {key: payload, "round_idx": 3},
                                  cfg)
    assert pf == jf
    mine, theirs = _decode(jf, None), _jax_decode(pf, None)
    assert _tree_eq(mine.get(key), theirs.get(key))
    if kind != "dense":
        raw = mx.snapshot()["counters"].get(
            "comm.codec.loopback.bytes_raw", 0) - snap0.get(
                "comm.codec.loopback.bytes_raw", 0)
        wire = mx.snapshot()["counters"].get(
            "comm.codec.loopback.bytes_wire", 0) - snap0.get(
                "comm.codec.loopback.bytes_wire", 0)
        assert 0 < wire < raw


def test_sparse_abs_mode_pinned_and_counted():
    """A non-anchored type compresses in absolute mode: the decode equals
    decode_sparse(encode_sparse(.)) bit for bit."""
    pol = make_policy({"kind": "sparse_topk", "ratio": 0.25,
                       "per_type": {"probe": "sparse_topk"}})
    w = np.random.RandomState(0).randn(300).astype(np.float32)
    m = Message("probe", 0, 1, {"model_params": {"w": w}})
    pol.encode_message(m, "loopback")
    assert m.get("model_params")["mode"] == "abs"
    out = _decode(m.encode(), None)
    assert np.array_equal(out.get("model_params")["w"],
                          decode_sparse(encode_sparse(w, 0.25)))


def test_big_leaf_indices_int32_through_the_header():
    """A leaf over 65536 entries (the flagship's 3x3x512x512 kernels) takes
    int32 indices, in both packages' frames alike."""
    w = np.random.RandomState(5).randn(70000).astype(np.float32)
    cfg = {"kind": "sparse_topk", "ratio": 0.12, "val_bits": 16,
           "per_type": {"probe": "sparse_topk"}}
    pf, jf, *_ = _encode_both("probe", {"model_params": {"w": w}}, cfg)
    assert pf == jf
    sp = Message.decode(pf).get("model_params")["tree"]["w"]["__sp__"]
    assert np.asarray(sp["idx"]).dtype == np.int32
    assert np.asarray(sp["val"]).dtype == np.float16


@pytest.mark.parametrize("val_bits,ef", [(32, True), (16, True), (32, False)])
def test_delta_and_error_feedback_stream_bitwise_jax(val_bits, ef):
    """Three rounds of the model stream (dense broadcast, sparse delta
    upload): every frame byte-equal to JAX's, the reconstructions, the
    anchors' digests and the error-feedback residuals bitwise."""
    cfg = {"kind": "sparse_topk", "ratio": 0.25, "val_bits": val_bits,
           "error_feedback": ef}
    ps, pc, js, jc = (make_policy(cfg), make_policy(cfg), jax_policy(cfg),
                      jax_policy(cfg))
    rs = np.random.RandomState(1)
    G = {"w": rs.randn(40, 8).astype(np.float32),
         "b": rs.randn(8).astype(np.float32)}
    for r in range(3):
        mtype = "s2c_init_config" if r == 0 else "s2c_sync_model"
        pf, jf, *_ = _encode_both(mtype, {"model_params": G}, cfg, ps, js)
        assert pf == jf
        _decode(pf, pc)
        _jax_decode(jf, jc)
        P = {"w": G["w"] + 0.01 * rs.randn(40, 8).astype(np.float32),
             "b": (G["b"] + 0.1 * (r + 1)).astype(np.float32)}
        pf, jf, *_ = _encode_both("c2s_send_model", {"model_params": P},
                                  cfg, pc, jc, sender=1, receiver=0)
        assert pf == jf
        hdr = Message.decode(pf).get("model_params")
        assert hdr["mode"] == "delta"
        mine, theirs = _decode(pf, ps), _jax_decode(jf, js)
        assert _tree_eq(mine.get("model_params"),
                        theirs.get("model_params"))
        if ef:
            res_p, res_j = pc._residuals[(0, "model_params")], \
                jc._residuals[(0, "model_params")]
            assert _tree_eq(res_p, res_j)
            # the residual is what the wire dropped
            for k in P:
                np.testing.assert_allclose(
                    res_p[k] + (mine.get("model_params")[k] - G[k]),
                    P[k] - G[k] + (0 if r == 0 else prev_res[k]),
                    atol=1e-5)
            prev_res = {k: v.copy() for k, v in res_p.items()}
        assert pc._latest_anchor(0, "model_params")[0] == \
            ps._latest_anchor(1, "model_params")[0] == \
            jc._latest_anchor(0, "model_params")[0] == tree_digest(
                mine.get("model_params"))
        G = {k: np.asarray(v) for k, v in mine.get("model_params").items()}


def test_encode_is_idempotent_per_message():
    pol = make_policy({"kind": "sparse_topk", "ratio": 0.5,
                       "per_type": {"probe": "sparse_topk"}})
    m = Message("probe", 0, 1,
                {"model_params": {"w": np.ones(64, np.float32)}})
    pol.encode_message(m, "loopback")
    first = copy.deepcopy(m.params["model_params"])
    frame = m.encode()
    pol.encode_message(m, "loopback")      # the retransmit path
    np.testing.assert_equal(m.params["model_params"], first)
    assert m.encode() == frame


def _delta_frame(pkg):
    mk, M = (make_policy, Message) if pkg == "port" else (jax_policy,
                                                           JMessage)
    pol = mk({"kind": "sparse_topk", "ratio": 0.5})
    G = {"w": np.ones(16, np.float32)}
    pol.encode_message(M("s2c_init_config", 0, 1, {"model_params": G}),
                       "loopback")
    pol.record_decoded_anchor(0, "model_params", G)
    up = M("c2s_send_model", 1, 0,
           {"model_params": {"w": (G["w"] + 1).astype(np.float32)}})
    pol.encode_message(up, "loopback")
    return pol, up.encode()


def _bad_codec(m):
    m.params["model_params"]["__wire_codec__"] = "zstd_v9"


def _bad_version(m):
    m.params["model_params"]["v"] = 99


def _bad_anchor(m):
    m.params["model_params"]["anchor"] = "deadbeefdeadbeef"


def _bad_indices(m):
    sp = m.params["model_params"]["tree"]["w"]["__sp__"]
    sp["idx"] = np.asarray(sp["idx"]).astype(np.int32) + 1000


@pytest.mark.parametrize("corrupt,policy,match", [
    (_bad_codec, True, "codec mismatch"),
    (_bad_version, True, "version mismatch"),
    (None, False, "no codec state"),
    (_bad_anchor, True, "anchor mismatch"),
    (_bad_indices, True, "out of range")])
def test_mismatches_are_loud_as_in_jax(corrupt, policy, match):
    for pkg, M, dec in (("port", Message, decode_message),
                        ("jax", JMessage, jax_decode)):
        pol, frame = _delta_frame(pkg)
        m = M.decode(frame)
        if corrupt is not None:
            corrupt(m)
        with pytest.raises(ValueError, match=match):
            dec(m, pol if policy else None, "loopback")


def test_control_frames_byte_identical():
    """Handshake, heartbeat, status and the default-dense S2C broadcast:
    the same bytes with and without the codec, and as JAX's."""
    pol = make_policy({"kind": "sparse_topk", "ratio": 0.1})
    G = {"w": np.random.RandomState(2).randn(32).astype(np.float32)}
    for mtype, params in (("connection_ready", {}),
                          ("c2s_heartbeat", {"run_gen": 3}),
                          ("c2s_client_status", {"client_status": "ONLINE"}),
                          ("s2c_check_client_status", {}),
                          ("s2c_sync_model", {"model_params": G,
                                              "round_idx": 2})):
        m = Message(mtype, 0, 1, copy.deepcopy(params))
        plain = copy.deepcopy(m).encode()
        pol.encode_message(m, "loopback")
        assert m.encode() == plain == JMessage(mtype, 0, 1,
                                               copy.deepcopy(params)).encode()


def test_qsgd_roundtrip_within_one_level():
    pol = make_policy({"kind": "qsgd", "bits": 8,
                       "per_type": {"probe": "qsgd"}})
    w = np.random.RandomState(3).randn(500).astype(np.float32)
    m = Message("probe", 0, 1, {"model_params": {"w": w}})
    pol.encode_message(m, "loopback")
    got = _decode(m.encode(), None).get("model_params")["w"]
    assert got.dtype == np.float32 and got.shape == w.shape
    assert float(np.abs(got - w).max()) <= float(
        np.linalg.norm(w)) / (2**8 - 1) + 1e-6
    with pytest.raises(ValueError, match="non-finite"):
        pol.encode_message(Message("probe", 0, 1, {"model_params": {
            "w": np.array([1.0, np.inf], np.float32)}}), "loopback")


def test_field_pack_refusals():
    pol = make_policy({"kind": "dense"})
    with pytest.raises(ValueError, match="integer field"):
        pol.encode_message(
            Message("c2s_sa_masked", 1, 0,
                    {"sa_masked": np.ones(4, np.float32)}), "loopback")
    m = Message("c2s_sa_masked", 1, 0,
                {"sa_masked": np.arange(4, dtype=np.int64)})
    pol.encode_message(m, "loopback")
    m.params["sa_masked"]["p"] = 3          # prime skew: values >= p
    with pytest.raises(ValueError, match="outside"):
        decode_message(Message.decode(m.encode()), None, "loopback")


# ----------------------------------------------------------- config
_GOOD = [
    {"kind": "sparse_topk", "ratio": 0.1, "error_feedback": True,
     "val_bits": 16, "per_type": {"s2c_sync_model": "dense"}},
    {"kind": "qsgd", "ratio": 0.1,
     "per_type": {"c2s_send_model": "sparse_topk"}},
    {"kind": "qsgd", "bits": 4},
    {"kind": "dense"},
]
_BAD = [
    ({"kind": "sparse_topk", "ratioo": 0.1}, "unknown comm_codec knob"),
    ({"ratio": 0.1}, "needs a 'kind'"),
    ({"kind": "gzip"}, "must be one of"),
    ({"kind": "qsgd", "ratio": 0.1}, "requires kind: sparse_topk"),
    ({"kind": "sparse_topk", "ratio": 0.1, "bits": 4}, "requires kind: qsgd"),
    ({"kind": "dense", "per_type": {"x": "bogus"}}, "per_type"),
    ({"kind": "sparse_topk", "ratio": 1.5}, "must be a number"),
    ({"kind": "qsgd", "bits": 1}, "must be an integer"),
    ({"kind": "sparse_topk", "error_feedback": 1}, "must be a boolean"),
    ("sparse", "must be a mapping"),
]


@pytest.mark.parametrize("cfg", _GOOD)
def test_codec_config_accepted_as_in_jax(cfg):
    validate_comm_codec(cfg)
    jax_validate(cfg)
    assert make_policy(cfg).type_map == jax_policy(cfg).type_map


@pytest.mark.parametrize("cfg,match", _BAD)
def test_codec_config_refused_as_in_jax(cfg, match):
    msgs = []
    for fn in (validate_comm_codec, jax_validate):
        with pytest.raises(ValueError, match=match) as e:
            fn(cfg)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("over,match", [
    ({"comm_args": {"comm_codec": {"kind": "dense", "ratioz": 1}}},
     "unknown comm_codec knob"),
    ({"comm_args": {"comm_codec": {"kind": "dense",
                                   "secagg_premask_ratio": 0.1}}},
     "requires\\s+train_args.secagg"),
    ({"common_args": {"training_type": "cross_silo"},
      "train_args": {"secagg": True},
      "dp_args": {"enable_dp": True, "epsilon": 0.9}},
     "secagg client has no client-side"),
    ({"comm_args": {"comm_codec": {"kind": "sparse_topk", "ratio": 0.1}}},
     None),
    ({"train_args": {"secagg": True}, "comm_args": {"comm_codec": {
        "kind": "dense", "secagg_premask_ratio": 0.1}}}, None),
])
def test_config_load_validates_codec_as_jax(over, match):
    d = {"train_args": {"client_num_in_total": 2, "client_num_per_round": 2}}
    for sec, kv in over.items():
        d.setdefault(sec, {}).update(kv)
    for C in (Config, JaxConfig):
        if match is None:
            C.from_dict(copy.deepcopy(d))
        else:
            with pytest.raises(ValueError, match=match):
                C.from_dict(copy.deepcopy(d))


# ----------------------------------------------------------- transports
@pytest.mark.parametrize("backend", ["loopback", "broker", "web3"])
def test_create_transport_attaches_codec_to_innermost(backend):
    run = _run_id("codec-wire")
    t = create_transport(
        backend, 0, run, chaos={"drop": 0.1, "seed": 1}, comm_retry=True,
        comm_codec={"kind": "sparse_topk", "ratio": 0.5})
    assert isinstance(t, ReliableTransport)
    assert isinstance(t.inner, ChaosTransport)
    base = t.inner.inner
    assert isinstance(base, LoopbackTransport if backend == "loopback"
                      else BrokerTransport)
    assert isinstance(base._codec, CodecPolicy)
    t.set_codec(None)          # through the wrapper stack
    assert base._codec is None
    t.stop_receive_message()
    release_router(run)
    release_broker(run)


def test_exactly_once_under_chaos_over_compressed_frames():
    """Drop, duplicate and corrupt injection with reliable delivery over
    sparse frames: every payload dispatched once, equal to the sender's
    reconstruction."""
    run = _run_id("codec-chaos")
    spec = FaultSpec(seed=7, drop=0.15, duplicate=0.2, corrupt=0.15)
    pol = RetryPolicy(ack_timeout_s=0.05, max_attempts=10, deadline_s=20.0)
    cc = {"kind": "sparse_topk", "ratio": 0.25,
          "per_type": {"probe": "sparse_topk"}}

    def mk(r):
        return create_transport("loopback", r, run, chaos=spec,
                                comm_retry=pol, comm_codec=cc)

    a, b = FedCommManager(mk(0), 0), FedCommManager(mk(1), 1)
    got: dict = {}
    done = threading.Event()
    n = 14
    rs = np.random.RandomState(5)
    payloads = [rs.randn(129).astype(np.float32) for _ in range(n)]

    def on_probe(m):
        got.setdefault(int(m.get("i")), []).append(
            np.asarray(m.get("model_params")["w"]))
        if len(got) >= n:
            done.set()

    b.register_message_receive_handler("probe", on_probe)
    a.run(background=True)
    b.run(background=True)
    snap0 = mx.snapshot()["counters"]
    try:
        for i in range(n):
            a.send_message(Message("probe", 0, 1)
                           .add("i", i).add("model_params",
                                            {"w": payloads[i]}))
        assert done.wait(timeout=20), f"delivered {len(got)}/{n}"
        time.sleep(0.1)
        assert all(len(v) == 1 for v in got.values()), "dispatched twice"
        for i in range(n):
            assert np.array_equal(
                got[i][0], decode_sparse(encode_sparse(payloads[i], 0.25)))
        assert mx.snapshot()["counters"].get("fed.chaos.corrupt", 0) \
            > snap0.get("fed.chaos.corrupt", 0)
    finally:
        a.stop()
        b.stop()
        release_router(run)


def test_federation_over_compressed_frames_under_chaos():
    """A 2-client lr federation trains to its end over sparse delta frames
    with chaos drop / duplicate / corrupt under the reliable layer."""
    run = _run_id("codec-fed")
    model = hub.create("lr", 3, (8,), device="meta")
    t = TrainArgs(epochs=2, batch_size=16, learning_rate=0.3)
    init = {k: v.numpy() for k, v in hub.init_params(
        hub.create("lr", 3, (8,), device="cpu"),
        torch.Generator().manual_seed(0)).items()}
    spec = FaultSpec(seed=9, drop=0.1, duplicate=0.1, corrupt=0.1)
    rpol = RetryPolicy(ack_timeout_s=0.1, max_attempts=10, deadline_s=30.0)
    cc = {"kind": "sparse_topk", "ratio": 0.3, "error_feedback": True}

    def mk(r):
        return FedCommManager(create_transport(
            "loopback", r, run, chaos=spec, comm_retry=rpol,
            comm_codec=cc), r)

    evals = [_mk_data(s) for s in (1, 2)]

    def eval_fn(p, r):
        accs = [float((np.argmax(x @ p["Dense_0.kernel"] + p["Dense_0.bias"],
                                 -1) == y).mean()) for x, y in evals]
        return {"test_acc": float(np.mean(accs))}

    snap0 = mx.snapshot()["counters"]
    server = FedServerManager(mk(0), client_ids=[1, 2], init_params=init,
                              num_rounds=3, eval_fn=eval_fn, device="cpu")
    clients = [FedClientManager(mk(c), c, SiloTrainer(
        model, t, *evals[c - 1], seed=c, device="cpu")) for c in (1, 2)]
    try:
        server.run(background=True)
        for c in clients:
            c.run(background=True)
            c.announce_ready()
        assert server.done.wait(timeout=120), "compressed chaos run stalled"
    finally:
        for c in clients:
            c.done.wait(5)
            c._stopped.set()
            c.comm.stop()
        release_router(run)
    assert len(server.history) == 3 and server.error is None
    assert server.history[-1]["test_acc"] > 0.6, server.history
    snap1 = mx.snapshot()["counters"]
    raw = snap1.get("comm.codec.loopback.bytes_raw", 0) \
        - snap0.get("comm.codec.loopback.bytes_raw", 0)
    wire = snap1.get("comm.codec.loopback.bytes_wire", 0) \
        - snap0.get("comm.codec.loopback.bytes_wire", 0)
    assert 0 < wire < raw


def test_kill_restart_soak_over_compressed_frames(tmp_path):
    """The kill–restart soak with the codec on: the server severed and
    resumed, every client killed once; the run completes with full
    participation over sparse delta frames."""
    from fedml_tpu_torch.cross_silo.soak import chaos_kill_soak

    out = chaos_kill_soak(
        FaultSpec(silo_kill={0: 2, 1: 1, 2: 3}), str(tmp_path / "ckpt"),
        n_clients=2, rounds=5, seed=0, device="cpu",
        comm_codec={"kind": "sparse_topk", "ratio": 0.3,
                    "error_feedback": True})
    assert out["error"] is None, out["error"]
    assert len(out["history"]) == 5 and len(out["kills"]) == 3
    assert all(r["n_received"] == 2 for r in out["history"])


# ------------------------------------------------- quantize-then-mask
@pytest.mark.parametrize("drop", [None, [2]])
def test_quantize_then_mask_bitwise_vs_plain_path(drop):
    """Masked sparsified vectors unmask to exactly the plain
    quantize-sum-dequantize of the same vectors, as in JAX."""
    from fedml_tpu.mpc.secagg import secagg_roundtrip as jax_roundtrip
    from fedml_tpu_torch.mpc.finite import dequantize, quantize
    from fedml_tpu_torch.mpc.secagg import premask_sparsify, secagg_roundtrip

    rs = np.random.RandomState(6)
    vecs = [premask_sparsify(rs.randn(64), 0.25) for _ in range(4)]
    masked = secagg_roundtrip(vecs, drop=drop, seed=3)
    plain = dequantize(np.sum([quantize(v, 16) for i, v in enumerate(vecs)
                               if i not in (drop or [])], axis=0)
                       % (2**31 - 1), 16)
    assert np.array_equal(masked, plain)
    assert np.array_equal(masked, jax_roundtrip(vecs, drop=drop, seed=3))


# ----------------------------------------------------------- DP ordering
def test_dp_noise_then_compress_ordering_and_epsilon():
    """The codec's input is the DP output (noise before the wire), and the
    accountant's epsilon does not depend on the codec."""
    from fedml_tpu_torch.dp import make_upload_dp

    cfg = Config.from_dict({
        "train_args": {"client_num_in_total": 2, "client_num_per_round": 2,
                       "comm_round": 4},
        "dp_args": {"enable_dp": True, "dp_solution_type": "ldp",
                    "epsilon": 0.9, "delta": 1e-5, "clipping_norm": 1.0}})
    model = hub.create("lr", 3, (8,), device="meta")
    trainer = SiloTrainer(model, TrainArgs(epochs=1, batch_size=16,
                                           learning_rate=0.2),
                          *_mk_data(1), seed=1, device="cpu")
    init = {k: v.numpy() for k, v in hub.init_params(
        hub.create("lr", 3, (8,), device="cpu"),
        torch.Generator().manual_seed(0)).items()}
    sent = []

    class _Spy:
        def send_message(self, msg):
            sent.append(msg)

        def register_message_receive_handler(self, *_a):
            pass

    dp = make_upload_dp(cfg, seed=1)
    FedClientManager(_Spy(), 1, trainer, dp_upload=dp)._train_and_send(
        init, 0, gen=0)
    uploaded = sent[-1].get("model_params")
    raw = trainer.train(init, 0)[0]
    assert not all(np.array_equal(uploaded[k], raw[k]) for k in raw)
    want = make_upload_dp(cfg, seed=1).apply(raw, init, 0)
    assert all(np.array_equal(np.asarray(uploaded[k]), np.asarray(want[k]))
               for k in raw)
    eps = dp.epsilon()
    pol = make_policy({"kind": "sparse_topk", "ratio": 0.25})
    pol.record_decoded_anchor(0, "model_params", init)
    pol.encode_message(Message("c2s_send_model", 1, 0,
                               {"model_params": dict(uploaded)}), "loopback")
    assert dp.epsilon() == eps > 0


def test_runner_plumbs_codec_and_dp():
    """FedMLRunner builds both cross-silo roles with the codec on the
    innermost transport, and the DP stage on the client."""
    from fedml_tpu_torch.runner import FedMLRunner

    run = _run_id("codec-run")
    cfg = Config.from_dict({
        "common_args": {"training_type": "cross_silo"},
        "train_args": {"client_num_in_total": 2, "client_num_per_round": 2,
                       "comm_round": 2},
        "comm_args": {"transport": "loopback", "run_id": run,
                      "comm_codec": {"kind": "sparse_topk", "ratio": 0.5}},
        "dp_args": {"enable_dp": True, "dp_solution_type": "ldp",
                    "epsilon": 0.9, "delta": 1e-5}})
    model = hub.create("lr", 3, (8,), device="cpu")
    client = FedMLRunner(cfg, dataset=_mk_data(0), model=model,
                         role="client", rank=1, device="cpu").runner
    server = FedMLRunner(cfg, model=model, role="server",
                         device="cpu").runner
    assert client.dp_upload is not None
    for r in (client, server):
        assert isinstance(r.comm.transport._codec, CodecPolicy)
        r.comm.transport.stop_receive_message()
    release_router(run)
