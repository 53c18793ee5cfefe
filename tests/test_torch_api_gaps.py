"""The public names the port had lacked, each against its JAX original on
the CPU: the metrics registry's helpers (snapshots equal after the same
calls), the serve-knob sets, `FaultSpec.any_client_faults`'s truth table,
`CodecPolicy(field_prime=)` (frames byte-equal to JAX's, also at
primes other than the default 2**31 - 1),
the four `ARG_*` envelope keys, `native.available()`, the six tree
helpers (f32 tolerance; bitwise for cast, unstack and index),
`FedMLInferenceRunner.metrics_url`, the package re-exports and the
top-level `run_async_simulation`."""
import copy
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.comm import Message as JMessage
from fedml_tpu.comm import chaos as jchaos
from fedml_tpu.comm import codec as jcodec
from fedml_tpu.comm import message as jmessage
from fedml_tpu.ops import tree as jtree
from fedml_tpu.serving import knobs as jknobs
from fedml_tpu.utils import metrics as jmx

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu_torch import native
from fedml_tpu_torch.comm import Message, chaos, codec, message
from fedml_tpu_torch.ops import tree
from fedml_tpu_torch.serving import knobs
from fedml_tpu_torch.utils import metrics as mx

torch.set_num_threads(2)


# ------------------------------------------------------------- metrics
class _Clock:
    """perf_counter stand-in: each call advances by the next step."""

    def __init__(self, steps):
        self.t, self.steps = 0.0, list(steps)

    def __call__(self):
        self.t += self.steps.pop(0) if self.steps else 0.0
        return self.t


def _drive(m, clock_steps, monkeypatch):
    """One sequence of calls through a metrics module's helpers and its
    registry's methods; (snapshot before the window, after it)."""
    m.counter("c.a").inc(3)
    m.registry.counter("c.a").inc()
    m.inc("c.b", 5)
    m.gauge("g.a").set(2.5)
    m.registry.gauge("g.b").set(-1.0)
    m.set_gauge("g.c", 7)
    for v in (1e-5, 3e-4, 0.02, 0.5, 4.0):
        m.observe("h.a", v)
    m.histogram("h.b", (1.0, 2.0, 4.0)).observe(3.0)
    before = copy.deepcopy(m.snapshot())
    for v in (2e-3, 2e-3, 0.3, 90.0):
        m.observe("h.a", v)
    m.registry.histogram("h.b").observe(0.5)
    monkeypatch.setattr(m.time, "perf_counter", _Clock(clock_steps))
    for _ in range(3):
        with m.timer("h.t"):
            pass
    return before, m.snapshot()


def test_metrics_helpers_match_jax(monkeypatch):
    monkeypatch.setattr(jmx, "registry", jmx.MetricsRegistry())
    monkeypatch.setattr(mx, "registry", mx.MetricsRegistry())
    steps = [0.0, 0.004, 0.0, 0.07, 0.0, 1.5]
    jb, ja = _drive(jmx, list(steps), monkeypatch)
    pb, pa = _drive(mx, list(steps), monkeypatch)
    assert pb == jb and pa == ja
    assert pa["histograms"]["h.t"]["count"] == 3
    for key in ("h.a", "h.b", "h.t", "absent"):
        for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0):
            assert mx.percentile_from_snapshots(pb, pa, key, q) == \
                jmx.percentile_from_snapshots(jb, ja, key, q), (key, q)
    # a window whose start lacks the histogram counts from zero
    assert mx.percentile_from_snapshots({}, pa, "h.t", 0.5) == \
        jmx.percentile_from_snapshots({}, ja, "h.t", 0.5)
    with pytest.raises(TypeError, match="already registered"):
        mx.registry.gauge("c.a")
    mx.reset()
    jmx.reset()
    assert mx.snapshot() == jmx.snapshot() == {
        "counters": {}, "gauges": {}, "histograms": {}}


# --------------------------------------------------------- small names
def test_knob_sets_match_jax():
    assert knobs.knob_names() == jknobs.knob_names()
    for consumer in ("predictor", "fleet", "nobody"):
        assert knobs.consumer_knobs(consumer) == \
            jknobs.consumer_knobs(consumer)
    assert knobs.consumer_knobs("predictor") | knobs.consumer_knobs(
        "fleet") == knobs.knob_names()


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("straggler", [0.0, 0.25])
@pytest.mark.parametrize("drop", [0.0, 0.3])
def test_any_client_faults_truth_table(dropout, straggler, drop):
    kw = {"client_dropout": dropout, "client_straggler": straggler,
          "drop": drop}
    got = chaos.FaultSpec(**kw).any_client_faults()
    assert got == jchaos.FaultSpec(**kw).any_client_faults()
    assert got == (dropout > 0 or straggler > 0)


def test_envelope_keys_match_jax():
    for k in ("ARG_TYPE", "ARG_SENDER", "ARG_RECEIVER", "ARG_MODEL_PARAMS",
              "ARG_NUM_SAMPLES", "ARG_CLIENT_STATUS", "ARG_ROUND",
              "ARG_TRACE_ID", "ARG_PARENT_SPAN"):
        assert getattr(message, k) == getattr(jmessage, k), k


def test_native_available_and_no_fallback(monkeypatch):
    assert native.available() is True
    assert native.crc32c(b"123456789") == 0xE3069283

    def broken(name):
        raise RuntimeError(f"{name} failed to build")

    monkeypatch.setattr(native, "_load", broken)
    assert native.available() is False
    with pytest.raises(RuntimeError, match="failed to build"):
        native.crc32c(b"x")


def test_package_reexports():
    from fedml_tpu_torch import algorithms, cross_silo, dp, models
    from fedml_tpu_torch.core import registry
    from fedml_tpu_torch.cross_silo import hierarchical

    assert fedml_tpu_torch.ALGORITHMS is registry.ALGORITHMS
    assert fedml_tpu_torch.MODELS is registry.MODELS
    assert fedml_tpu_torch.DATASETS is registry.DATASETS
    assert "fedgan" in registry.ALGORITHMS
    assert algorithms.make_fedgan.__module__.endswith("fedgan")
    assert models.create("lr", 3, (8,), device="meta") is not None
    assert cross_silo.run_hierarchical is hierarchical.run_hierarchical
    assert dp.make_mechanism("gaussian", 1.0, 1e-5, 1.0) is not None


# --------------------------------------------------------------- codec
@pytest.mark.parametrize("p", [2**31 - 1, 2**32 - 5, 65521],
                         ids=["mersenne31", "p32", "p16"])
def test_field_prime_frames_byte_equal_jax(p):
    """`CodecPolicy(field_prime=p)` packs masked uploads over p and puts p
    in the frame's header, as the JAX policy: the frames are byte-equal
    (2**31 - 1 is the default prime, given explicitly; the other two are
    not), and a frame of a non-default prime is not the default's."""
    from fedml_tpu_torch.mpc.finite import DEFAULT_PRIME

    type_map = codec.make_policy({"kind": "dense"}).type_map
    assert type_map == jcodec.make_policy({"kind": "dense"}).type_map
    pol = codec.CodecPolicy(type_map, field_prime=p)
    jpol = jcodec.CodecPolicy(type_map, field_prime=p)
    assert pol.field_prime == jpol.field_prime == p
    vec = np.random.RandomState(4).randint(0, p, size=512).astype(np.int64)
    vec[:3] = [0, p - 1, 1]
    payload = {"sa_masked": vec, "round_idx": 3}
    pm = Message("c2s_sa_masked", 2, 0, copy.deepcopy(payload))
    jm = JMessage("c2s_sa_masked", 2, 0, copy.deepcopy(payload))
    pol.encode_message(pm, "loopback")
    jpol.encode_message(jm, "loopback")
    assert pm.get("sa_masked")["p"] == p
    frame = pm.encode()
    assert frame == jm.encode()
    dm = Message("c2s_sa_masked", 2, 0, copy.deepcopy(payload))
    if vec.max() >= DEFAULT_PRIME:   # the default policy packs over its own
        with pytest.raises(ValueError, match="not a mod-p reduced"):
            codec.CodecPolicy(type_map).encode_message(dm, "loopback")
    else:
        codec.CodecPolicy(type_map).encode_message(dm, "loopback")
        assert (dm.encode() == frame) == (p == DEFAULT_PRIME)
    out = Message.decode(frame)
    codec.decode_message(out, None, "loopback")
    np.testing.assert_array_equal(out.get("sa_masked"), vec)
    jout = JMessage.decode(frame)
    jcodec.decode_message(jout, None, "loopback")
    np.testing.assert_array_equal(jout.get("sa_masked"), vec)


# --------------------------------------------------------------- trees
def _trees():
    rs = np.random.RandomState(0)
    a = {"b": {"k": rs.randn(3, 4).astype(np.float32),
               "s": rs.randn(4).astype(np.float32)},
         "w": rs.randn(7).astype(np.float32)}
    b = {"b": {"k": rs.randn(3, 4).astype(np.float32),
               "s": rs.randn(4).astype(np.float32)},
         "w": rs.randn(7).astype(np.float32)}
    return a, b


def _torch(t):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in t.items()}


def _np(t):
    return {k: _np(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in t.items()}


def _jnp(t):
    return jax.tree.map(jnp.asarray, t)


def _eq(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _eq(a[k], b[k])
        else:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


def test_tree_helpers_match_jax():
    a, b = _trees()
    ta, tb = _torch(a), _torch(b)
    ja, jb = _jnp(a), _jnp(b)
    np.testing.assert_allclose(float(tree.tree_dot(ta, tb)),
                               float(jtree.tree_dot(ja, jb)), rtol=1e-6)
    np.testing.assert_allclose(float(tree.tree_sq_norm(ta)),
                               float(jtree.tree_sq_norm(ja)), rtol=1e-6)
    _eq(_np(tree.tree_cast(ta, torch.float16)),
        _np(jax.tree.map(np.asarray, jtree.tree_cast(ja, jnp.float16))))
    # bf16 bitwise through its f32 widening (numpy has no bf16)
    _eq(_np(tree.tree_map(lambda x: x.float(),
                          tree.tree_cast(ta, torch.bfloat16))),
        _np(jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)),
                         jtree.tree_cast(ja, jnp.bfloat16))))
    stacked = tree.tree_stack([ta, tb, ta])
    jstacked = jtree.tree_stack([ja, jb, ja])
    got, want = tree.tree_unstack(stacked), jtree.tree_unstack(jstacked)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _eq(_np(g), _np(jax.tree.map(np.asarray, w)))
    for i in (0, 1, 2, -1):
        _eq(_np(tree.tree_index(stacked, i)),
            _np(jax.tree.map(np.asarray, jtree.tree_index(jstacked, i))))
    vec, unflatten = tree.tree_flatten_to_vector(ta)
    jvec, junflatten = jtree.tree_flatten_to_vector(ja)
    np.testing.assert_array_equal(vec.numpy(), np.asarray(jvec))
    _eq(_np(unflatten(vec * 2)),
        _np(jax.tree.map(np.asarray, junflatten(jvec * 2))))


def test_tree_dot_upcasts_bf16():
    """The port's dot and squared norm sum in f32 over bf16 leaves (the
    JAX functions keep the leaves' dtype): the f32 sum of the bf16
    values."""
    a, b = _trees()
    ta = tree.tree_cast(_torch(a), torch.bfloat16)
    tb = tree.tree_cast(_torch(b), torch.bfloat16)
    want = sum(float(np.dot(x.float().numpy().ravel(),
                            y.float().numpy().ravel()))
               for x, y in zip(tree.tree_leaves(ta), tree.tree_leaves(tb)))
    assert tree.tree_dot(ta, tb).dtype == torch.float32
    np.testing.assert_allclose(float(tree.tree_dot(ta, tb)), want,
                               rtol=1e-6)
    np.testing.assert_allclose(float(tree.tree_sq_norm(ta)) ** 0.5,
                               float(tree.tree_norm(ta)), rtol=1e-6)


# ----------------------------------------------------- runner and async
def test_metrics_url_serves_metrics():
    from fedml_tpu_torch.serving import FedMLInferenceRunner

    class Echo:
        def predict(self, req):
            return req

    runner = FedMLInferenceRunner(Echo(), host="127.0.0.1", port=0).start()
    try:
        assert runner.metrics_url == \
            f"http://127.0.0.1:{runner.port}/metrics"
        with urllib.request.urlopen(runner.metrics_url, timeout=10) as r:
            assert r.status == 200
            assert r.headers["Content-Type"].startswith("text/plain")
    finally:
        runner.stop()


def test_top_level_run_async_simulation(tmp_path):
    """`fedml_tpu_torch.run_async_simulation` against JAX's top-level
    function on the same config, handed the JAX run's initial parameters
    and batch orders: the same events, bitwise, losses within 1e-4 and
    the test accuracy within one sample."""
    from fedml_tpu.core.algorithm import make_batch_indices
    from fedml_tpu.simulation.async_simulator import AsyncSimulator as JaxAsync

    from fedml_tpu_torch.models import hub

    d = {"data_args": {"dataset": "mnist", "data_cache_dir": str(tmp_path),
                       "synthetic_samples_per_client": 16},
         "model_args": {"model": "lr"},
         "train_args": {"federated_optimizer": "FedAvg",
                        "client_num_in_total": 4, "client_num_per_round": 2,
                        "comm_round": 3, "epochs": 1, "batch_size": 8,
                        "learning_rate": 0.1, "async_concurrency": 2},
         "common_args": {"random_seed": 3}, "comm_args": {"backend": "sp"}}
    jsim = JaxAsync(fedml_tpu.init(config=json.loads(json.dumps(d))))
    p0 = hub.params_from_flax(jsim.params, device="cpu")
    shard = jsim.dataset.x_train.shape[1]
    want = fedml_tpu.run_async_simulation(
        fedml_tpu.init(config=json.loads(json.dumps(d))))

    def order(seq):
        return np.asarray(make_batch_indices(
            jax.random.fold_in(jax.random.key(3), seq), shard, 8, 1))

    got = fedml_tpu_torch.run_async_simulation(
        fedml_tpu_torch.init(config=d, device="cpu"), params=p0,
        batch_idx=order)
    assert len(got) == len(want) > 0
    n_test = len(jsim.dataset.y_test)
    for a, b in zip(got, want):
        assert (a["update"], a["sim_time"], a["staleness"]) == \
            (b["update"], b["sim_time"], b["staleness"])
        for k in ("train_loss", "test_loss"):
            assert a[k] == pytest.approx(b[k], rel=1e-4, abs=1e-6), k
        assert abs(a["test_acc"] - b["test_acc"]) <= 1.0 / n_test + 1e-9
