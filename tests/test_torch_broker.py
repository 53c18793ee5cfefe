"""The port's broker transports (`comm/broker.py`: the MQTT + S3 shape and
its content-addressed web3 form), cross-cloud (`cross_cloud`) and
cross-device (`cross_device`) runtimes, and `FedMLRunner`'s plumbing of
SecAgg, the wire codec and the cross-device role, on the CPU.

Federations over `broker` and `web3` are held bitwise to the same
federation over loopback (the transport moves the same frames); the
cross-device dense run is held to the JAX package's cross-device run
from the same initial params and batch draws within 1e-5 of the largest
update (the rule of `tests/test_torch_cross_silo.py`), and bitwise to a
plain FedServerManager run; the sparse uplink is held bitwise to its own
decoded deltas.
"""
import threading
import time
import uuid

import jax
import numpy as np
import pytest
import torch

import fedml_tpu_torch
from fedml_tpu.comm import FedCommManager as JaxComm
from fedml_tpu.comm.loopback import LoopbackTransport as JaxLoopback
from fedml_tpu.comm.loopback import release_router as jax_release
from fedml_tpu.config import TrainArgs as JaxTrainArgs
from fedml_tpu.core.algorithm import make_batch_indices as jax_batch_indices
from fedml_tpu.cross_device import CrossDeviceServer as JaxCDServer
from fedml_tpu.cross_device import EdgeClient as JaxEdge
from fedml_tpu.cross_silo import SiloTrainer as JaxSiloTrainer
from fedml_tpu.models import hub as jax_hub
from fedml_tpu_torch.comm import (
    BrokerTransport, CodecPolicy, ContentAddressedBroker, FedCommManager,
    LoopbackTransport, Message, create_transport, get_broker,
    get_cas_broker, release_broker, release_router,
)
from fedml_tpu_torch.compression import decode_sparse_tree
from fedml_tpu_torch.config import TrainArgs
from fedml_tpu_torch.cross_cloud import run_cross_cloud
from fedml_tpu_torch.cross_device import CrossDeviceServer, EdgeClient
from fedml_tpu_torch.cross_silo import (
    FedAggregator, FedClientManager, FedServerManager, SecAggClientManager,
    SecAggServerManager, SiloTrainer,
)
from fedml_tpu_torch.models import hub
from fedml_tpu_torch.runner import FedMLRunner

torch.set_num_threads(2)
T = dict(epochs=1, batch_size=16, learning_rate=0.2)
TOL = 1e-5


def _run_id(tag):
    return f"{tag}-{uuid.uuid4().hex[:8]}"


def _mk_data(cid, n=48, d=8, k=3):
    rs = np.random.RandomState(cid)
    w = rs.randn(d, k)
    x = rs.randn(n + 8 * cid, d).astype(np.float32)
    y = np.argmax(x @ w, axis=1).astype(np.int32)
    return x, y


def _jax_schedule(cid, r, n):
    rng = jax.random.fold_in(jax.random.key(cid), r)
    return np.asarray(jax_batch_indices(rng, n, T["batch_size"],
                                        T["epochs"]))


def _jax_init():
    return jax.tree.map(np.asarray, jax_hub.init_params(
        jax_hub.create("lr", 3), (8,), jax.random.key(0)))


def _init():
    return {k: v.numpy() for k, v in
            hub.params_from_flax(_jax_init(), device="cpu").items()}


class _Recording:
    """A trainer that keeps every round's result and can die from a round
    on (silent until the test releases it)."""

    def __init__(self, inner, die_from=None):
        self.inner, self.die_from = inner, die_from
        self.n_samples = inner.n_samples
        self.results = {}
        self.released = threading.Event()

    def train(self, params, r):
        if self.die_from is not None and r >= self.die_from:
            self.released.wait()
            raise RuntimeError("a dead device")
        out = self.inner.train(params, r)
        self.results[r] = out
        return out


def _trainer(cid, die_from=None):
    x, y = _mk_data(cid)
    return _Recording(SiloTrainer(
        hub.create("lr", 3, (8,), device="meta"), TrainArgs(**T), x, y,
        seed=cid, device="cpu",
        batch_schedule=lambda r: _jax_schedule(cid, r, len(x))), die_from)


def _same(a: dict, b: dict) -> bool:
    return list(a) == list(b) and all(np.array_equal(a[k], b[k]) for k in a)


# ------------------------------------------------------------ broker
def test_broker_store_and_forward():
    """Publish before the receiver exists; it drains on connect, a big
    payload through the blob plane."""
    run = _run_id("b")
    sender = BrokerTransport(0, run)
    sender.send_message(Message("hello", 0, 1).add("x", 7))
    big = np.arange(100_000, dtype=np.float32)
    sender.send_message(Message("blob", 0, 1).add("w", big))
    assert get_broker(run).pending(f"fedml_{run}_1") == 2
    got = []
    mgr = FedCommManager(BrokerTransport(1, run), 1)
    for t in ("hello", "blob"):
        mgr.register_message_receive_handler(t, got.append)
    mgr.run(background=True)
    for _ in range(100):
        if len(got) == 2:
            break
        time.sleep(0.05)
    mgr.stop()
    release_broker(run)
    assert got[0].get("x") == 7 and got[0].receiver_id == 1
    assert np.array_equal(got[1].get("w"), big) and got[1].receiver_id == 1


@pytest.mark.parametrize("backend,cas", [
    ("broker", False), ("mqtt_s3", False), ("mqtt", False),
    ("web3", True), ("mqtt_web3", True), ("mqtt_thetastore", True)])
def test_broker_backends_via_the_factory(backend, cas):
    run = _run_id("f")
    tr = create_transport(backend, 3, run_id=run)
    assert isinstance(tr, BrokerTransport)
    assert isinstance(tr.broker, ContentAddressedBroker) == cas
    assert tr.broker is (get_cas_broker(run) if cas else get_broker(run))
    release_broker(run)


def test_content_addressed_blobs_dedup_and_verify():
    """A broadcast of one payload stores one blob, refcounted per reader;
    a tampered blob is refused."""
    run = _run_id("cas")
    cas = get_cas_broker(run)
    tr = BrokerTransport(0, run, broker=cas, blob_threshold=64)
    w = np.ones(1000, np.float32)
    for r in (1, 2, 3):
        tr.send_message(Message("m", 0, r).add("w", w))
    assert len(cas._blobs) == 1 and list(cas._refs.values()) == [3]
    key = next(iter(cas._blobs))
    data = cas.get_blob(key)
    assert cas._refs[key] == 2
    cas._blobs[key] = data[:-1] + b"x"
    with pytest.raises(ValueError, match="hash verification"):
        cas.get_blob(key)
    release_broker(run)
    assert get_cas_broker(run) is not cas     # released with its run


def test_broker_publish_retries_then_raises():
    class Flaky:
        def __init__(self, fails):
            self.fails = fails
            self.published = []

        def publish(self, topic, frame):
            if self.fails:
                self.fails -= 1
                raise OSError("transient")
            self.published.append(topic)

    ok = Flaky(2)
    BrokerTransport(0, "x", broker=ok, retry_backoff_s=0.0).send_message(
        Message("m", 0, 1))
    assert ok.published == ["fedml_x_1"]
    with pytest.raises(OSError):
        BrokerTransport(0, "x", broker=Flaky(5),
                        retry_backoff_s=0.0).send_message(Message("m", 0, 1))


# ----------------------------------------------------- federations
def _plain_fed(backend, rounds=2, codec=None):
    run, ids = _run_id(f"fed-{backend}"), [1, 2, 3]
    mk = lambda r: FedCommManager(create_transport(  # noqa: E731
        backend, r, run, comm_codec=codec), r)
    srv = FedServerManager(mk(0), ids, _init(), rounds, device="cpu")
    cls = [FedClientManager(mk(c), c, _trainer(c)) for c in ids]
    try:
        srv.run(background=True)
        for c in cls:
            c.run(background=True)
            c.announce_ready()
        assert srv.done.wait(60) and srv.error is None
    finally:
        release_router(run)
        release_broker(run)
    return srv


def _secagg_fed(backend, rounds=2):
    run, ids = _run_id(f"sa-{backend}"), [1, 2, 3]
    mk = lambda r: FedCommManager(create_transport(  # noqa: E731
        backend, r, run, comm_codec={"kind": "dense"}), r)
    srv = SecAggServerManager(mk(0), ids, _init(), rounds)
    cls = [SecAggClientManager(mk(c), c, _trainer(c), num_clients=3,
                               client_ids=ids) for c in ids]
    try:
        srv.run(background=True)
        for c in cls:
            c.run(background=True)
            c.announce_ready()
        assert srv.done.wait(60) and srv.error is None
    finally:
        release_router(run)
        release_broker(run)
    return srv


@pytest.mark.parametrize("backend", ["broker", "web3"])
def test_federation_over_broker_bitwise_loopback(backend):
    ref = _plain_fed("loopback")
    got = _plain_fed(backend)
    assert _same(got.params, ref.params) and got.history == ref.history


@pytest.mark.parametrize("backend", ["broker", "web3"])
def test_secagg_over_broker_bitwise_loopback(backend):
    ref = _secagg_fed("loopback")
    got = _secagg_fed(backend)
    assert _same(got.params, ref.params) and got.history == ref.history


def test_codec_over_broker_completes_and_compresses():
    from fedml_tpu_torch.utils import metrics as mx

    c0 = mx.snapshot()["counters"]
    srv = _plain_fed("broker", codec={"kind": "sparse_topk", "ratio": 0.3})
    c1 = mx.snapshot()["counters"]
    assert [h["n_received"] for h in srv.history] == [3, 3]
    raw = c1.get("comm.codec.broker.bytes_raw", 0) - c0.get(
        "comm.codec.broker.bytes_raw", 0)
    wire = c1.get("comm.codec.broker.bytes_wire", 0) - c0.get(
        "comm.codec.broker.bytes_wire", 0)
    assert 0 < wire < raw


# ------------------------------------------------------------ cross-cloud
@pytest.mark.parametrize("late", [0.0, 0.5])
def test_cross_cloud_over_broker_with_late_join(late):
    parties = [_mk_data(c) for c in (1, 2, 3)]
    sched = [lambda r, c=c, n=len(parties[c - 1][0]): _jax_schedule(c, r, n)
             for c in (1, 2, 3)]
    srv = run_cross_cloud(
        hub.create("lr", 3, (8,), device="meta"), _init(), TrainArgs(**T),
        parties, num_rounds=2, round_timeout=30.0, late_join_delay=late,
        device="cpu", batch_schedules=sched)
    assert [h["n_received"] for h in srv.history] == [3, 3]
    assert _same(srv.params, _plain_fed("loopback").params)


# ------------------------------------------------------------ cross-device
def _cross_device(n, rounds, uplink_topk=None, flaky=None,
                  round_timeout=6.0):
    run = _run_id("cd")
    srv = CrossDeviceServer(
        FedCommManager(LoopbackTransport(0, run), 0), init_params=_init(),
        num_rounds=rounds, devices_per_round=n, min_devices=n,
        round_timeout=round_timeout, device="cpu")
    trainers = {d: _trainer(d, (flaky or {}).get(d))
                for d in range(1, n + 1)}
    clients = [EdgeClient(FedCommManager(LoopbackTransport(d, run), d), d,
                          trainers[d], uplink_topk=uplink_topk,
                          device_info={"os": "test"})
               for d in range(1, n + 1)]
    try:
        srv.run(background=True)
        for c in clients:
            c.run(background=True)
        for c in clients:
            c.register()
        assert srv.done.wait(120), "cross-device run did not finish"
    finally:
        for t in trainers.values():
            t.released.set()
        for c in clients:
            c.comm.stop()
        release_router(run)
    return srv, trainers


def _jax_cross_device(n, rounds):
    run = _run_id("jcd")
    model = jax_hub.create("lr", 3)
    srv = JaxCDServer(JaxComm(JaxLoopback(0, run), 0),
                      init_params=_jax_init(), num_rounds=rounds,
                      devices_per_round=n, min_devices=n, round_timeout=6.0)
    cls = [JaxEdge(JaxComm(JaxLoopback(d, run), d), d, JaxSiloTrainer(
        model.apply, JaxTrainArgs(**T), *_mk_data(d), seed=d))
        for d in range(1, n + 1)]
    srv.run(background=True)
    for c in cls:
        c.run(background=True)
    for c in cls:
        c.register()
    assert srv.done.wait(120)
    jax_release(run)
    return {k: v.numpy() for k, v in
            hub.params_from_flax(srv.params, device="cpu").items()}


def test_cross_device_dense_matches_jax_and_plain_fedavg():
    srv, _t = _cross_device(3, 2)
    assert [h["n_received"] for h in srv.history] == [3, 3]
    want = _jax_cross_device(3, 2)
    init = _init()
    upd = max(float(np.abs(want[k] - init[k]).max()) for k in want)
    assert max(float(np.abs(srv.params[k] - want[k]).max())
               for k in want) <= TOL * upd
    assert _same(srv.params, _plain_fed("loopback").params)


def test_cross_device_sparse_uplink_is_its_decoded_deltas():
    srv, trainers = _cross_device(3, 2, uplink_topk=0.5)
    assert [h["n_received"] for h in srv.history] == [3, 3]
    # round 1's aggregate from round 0's: each device's top-k delta,
    # decoded against the global model, then FedAvg
    from fedml_tpu_torch.compression import encode_sparse_tree

    g = _init()
    for r in range(2):
        agg = FedAggregator(device="cpu")
        agg.reset([1, 2, 3])
        for d, t in trainers.items():
            p, n, _m = t.results[r]
            delta = decode_sparse_tree(encode_sparse_tree(
                {k: p[k] - g[k] for k in p}, 0.5), g)
            agg.add_local_trained_result(d, {k: g[k] + delta[k] for k in g},
                                         float(n))
        g = agg.aggregate()
    assert _same(srv.params, g)


def test_cross_device_drops_a_flaky_device_from_the_registry():
    srv, _t = _cross_device(3, 3, flaky={3: 1}, round_timeout=2.0)
    assert len(srv.history) == 3 and srv.error is None
    assert srv.dropped_log and srv.dropped_log[0] == (1, [3])
    assert srv.history[-1]["n_online"] == 2
    assert srv.history[-1]["n_received"] == 2


def test_cross_device_rejects_a_malformed_upload():
    run = _run_id("cd-bad")
    srv = CrossDeviceServer(FedCommManager(LoopbackTransport(0, run), 0),
                            init_params=_init(), num_rounds=1,
                            devices_per_round=1, min_devices=1,
                            device="cpu")
    srv.devices[1] = {}
    srv._select = lambda: [1]
    srv.started = True
    srv._start_round()
    for params in ({"Dense_0.kernel": np.zeros(3)},
                   {"x": np.zeros(1)}, None):
        srv._on_model(Message("c2s_send_model", 1, 0)
                      .add("model_params", params).add("round_idx", 0))
    srv._on_model(Message("c2s_send_model", 1, 0).add("round_idx", 0)
                  .add("sparse_update", {"leaves": []}))
    assert not srv.aggregator.results and not srv.done.is_set()
    srv._cancel_timer()
    release_router(run)


# ------------------------------------------------------------ runner
def _cfg(run, tt="cross_silo", device="cpu", comm=None, **train):
    return fedml_tpu_torch.init(config={
        "common_args": {"training_type": tt, "random_seed": 0},
        "train_args": {"client_num_in_total": 3, "client_num_per_round": 3,
                       "comm_round": 2, **T, **train},
        "comm_args": {"extra": {"run_id": run, **(comm or {})}}},
        device=device)


def _innermost(comm):
    t = comm.transport
    while hasattr(t, "inner"):
        t = t.inner
    return t


def test_runner_runs_secagg_with_the_codec_on_both_roles():
    run = _run_id("r-sa")
    cfg = _cfg(run, secagg=True, comm={
        "transport": "broker",
        "comm_codec": {"kind": "dense", "secagg_premask_ratio": 0.5}})
    model = hub.create("lr", 3, (8,), device="cpu")
    srv = FedMLRunner(cfg, model=model, role="server", params=_init()).runner
    cls = [FedMLRunner(cfg, dataset=_mk_data(c), model=model, role="client",
                       rank=c).runner for c in (1, 2, 3)]
    assert isinstance(srv, SecAggServerManager)
    assert all(isinstance(c, SecAggClientManager) and c.premask_ratio == 0.5
               for c in cls)
    for m in [srv] + cls:
        assert isinstance(_innermost(m.comm), BrokerTransport)
        assert isinstance(_innermost(m.comm)._codec, CodecPolicy)
    try:
        srv.run(background=True)
        for c in cls:
            c.run(background=True)
            c.announce_ready()
        assert srv.done.wait(60) and srv.error is None
        assert [h["n_received"] for h in srv.history] == [3, 3]
    finally:
        release_broker(run)


def test_runner_wires_cross_device_roles():
    run = _run_id("r-cd")
    cfg = _cfg(run, tt="cross_device", uplink_topk=0.5, min_devices=3,
               round_timeout=10.0)
    model = hub.create("lr", 3, (8,), device="cpu")
    srv = FedMLRunner(cfg, model=model, role="server", params=_init()).runner
    cls = [FedMLRunner(cfg, dataset=_mk_data(d), model=model, role="client",
                       rank=d).runner for d in (1, 2, 3)]
    assert isinstance(srv, CrossDeviceServer)
    assert (srv.min_devices, srv.round_timeout, srv.m) == (3, 10.0, 3)
    assert all(isinstance(c, EdgeClient) and c.uplink_topk == 0.5
               for c in cls)
    try:
        srv.run(background=True)
        for c in cls:
            c.run(background=True)
        for c in cls:
            c.register()
        assert srv.done.wait(60) and srv.error is None
        assert [h["n_received"] for h in srv.history] == [3, 3]
    finally:
        release_router(run)


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = hub.create("lr", 3, (8,), device="meta")
    run = _run_id("t-cuda")
    comm = FedCommManager(LoopbackTransport(0, run), 0)
    with pytest.raises(RuntimeError, match="no GPU"):
        CrossDeviceServer(comm, init_params=_init(), num_rounds=1)
    with pytest.raises(RuntimeError, match="no GPU"):
        run_cross_cloud(model, _init(), TrainArgs(), [_mk_data(1)], 1)
    for tt, extra in (("cross_silo", {"secagg": True}),
                      ("cross_device", {})):
        cfg = fedml_tpu_torch.config.Config.from_dict({
            "common_args": {"training_type": tt},
            "train_args": extra, "comm_args": {"extra": {"run_id": run}}})
        with pytest.raises(RuntimeError, match="no GPU"):
            FedMLRunner(cfg, model=model, role="server", params=_init())
        with pytest.raises(RuntimeError, match="no GPU"):
            FedMLRunner(cfg, dataset=_mk_data(1), model=model,
                        role="client", rank=1)
    release_router(run)
    release_broker(run)
