"""The port's serving fleet (`fedml_tpu_torch/serving/scheduler.py`,
`fleet_harness.py`, `start_replica`) held against the JAX package's, on
the CPU.

- `fleet_knobs` and the gateway's prefix-affinity keys are bitwise the JAX
  module's.
- A tiny fleet (vocab 64, d_model 32, 1 layer, weights from flax): two
  port replicas behind the port's gateway answer the greedy tokens of the
  JAX `GreedyLMPredictor` on the same weights and adapters, before and
  after a rolling update to v2 adapters (JAX's v2 tree carried across
  with `adapters_from_jax`).
- The JAX fleet tests (`tests/test_serving_fleet.py`,
  `tests/test_scheduler_durability.py`'s gateway cases,
  `tests/test_serving_affinity.py`) on the port: version pinning with
  reroute, garbage bodies, probation, shedding, mid-stream kills (greedy
  re-served byte-identical in f32, sampled surfacing a terminal error),
  the version-skew continuation, the 4xx / 5xx / 409 policies and
  affinity routing.
"""
import json
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.llm.lora import lora_init as jax_lora_init
from fedml_tpu.llm.transformer import TransformerLM as FlaxLM
from fedml_tpu.serving.engine import _page_key as jax_page_key
from fedml_tpu.serving.predictor import GreedyLMPredictor as JaxGreedy
from fedml_tpu.serving.scheduler import fleet_knobs as jax_fleet_knobs
from fedml_tpu_torch.comm.chaos import FaultSpec
from fedml_tpu_torch.llm.lora import adapters_from_jax
from fedml_tpu_torch.llm.transformer import (
    ModelDims, TransformerLM, params_from_flax,
)
from fedml_tpu_torch.serving.engine import _page_key
from fedml_tpu_torch.serving.inference_runner import FedMLInferenceRunner
from fedml_tpu_torch.serving.predictor import GreedyLMPredictor, StaleVersion
from fedml_tpu_torch.serving.scheduler import (
    R_READY, R_SUSPECT, Deployment, InferenceGateway, _Replica, fleet_knobs,
    start_replica,
)
from fedml_tpu_torch.utils import metrics as mx
from fedml_tpu_torch.utils.artifacts import FileArtifactStore, adapter_name

torch.set_num_threads(2)

V, D, L, H, FF = 64, 32, 1, 2, 64
MAXLEN = 32


@pytest.fixture(autouse=True)
def _fresh_registry(monkeypatch):
    """A fresh port metrics registry per test, so counter bars read this
    test's increments only."""
    monkeypatch.setattr(mx, "registry", mx.MetricsRegistry())


def _counter(name):
    return mx.snapshot()["counters"].get(name, 0)


@pytest.fixture(scope="module")
def setup():
    """(flax model, flax params, JAX a1, JAX a2, port model, port a1,
    port a2): the JAX fleet test's adapters (a1 nudged off zero B, a2 a
    deliberately different tree), carried across."""
    fm = FlaxLM(vocab_size=V, d_model=D, n_layers=L, n_heads=H, d_ff=FF,
                scan_layers=True)
    params = fm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))[
        "params"]
    a1 = lora_init_np(params)
    a2 = jax.tree.map(lambda a: a * -1.2 + 0.07, a1)
    model = TransformerLM.from_state(
        ModelDims(V, D, L, H, FF),
        params_from_flax(jax.tree.map(np.asarray, params), device="cpu"))
    return (fm, params, a1, a2, model, adapters_from_jax(a1, device="cpu"),
            adapters_from_jax(a2, device="cpu"))


def lora_init_np(params):
    a1 = jax_lora_init(jax.random.key(1), params, rank=2, a_std=0.3)
    return jax.tree.map(
        lambda a: np.asarray(a + 0.05 * np.ones(a.shape, a.dtype)), a1)


@pytest.fixture(scope="module")
def want(setup):
    """JAX per-request reference predictors under a1 and a2."""
    fm, params, a1, a2 = setup[:4]
    return (JaxGreedy(fm, params, adapters=a1, max_len=MAXLEN, kv_cache=True),
            JaxGreedy(fm, params, adapters=a2, max_len=MAXLEN, kv_cache=True))


def _greedy(pred, prompt, n):
    return pred.predict({"tokens": prompt, "max_new_tokens": n})[
        "generated_tokens"]


def _prompt(n=6, seed=0):
    return np.random.RandomState(seed).randint(1, V, n).tolist()


def _post(url, payload, timeout=120):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _sse(url, payload, timeout=120):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        ctype = r.headers.get("Content-Type")
        raw = r.read().decode()
    events = [json.loads(ln[len("data:"):]) for ln in raw.split("\n\n")
              if ln.strip().startswith("data:")]
    return ctype, events


def _replica(model, adapters, chaos=None):
    return FedMLInferenceRunner(
        GreedyLMPredictor(model, adapters=adapters, max_len=MAXLEN,
                          kv_cache=True, decode_slots=2, device="cpu"),
        port=0, chaos=chaos, chaos_rank=0).start()


# --------------------------------------------------------------- bitwise
@pytest.mark.parametrize("sv", [
    {}, {"decode_slots": 2}, {"probation_deadline_s": 8,
                              "probe_backoff_s": 0.1},
    {"shed_watermark": 2.5, "retry_after_s": 2, "affinity_routing": True},
    {"shed_watermark": 0, "affinity_routing": False,
     "probation_deadline_s": 3.5}])
def test_fleet_knobs_equal_jax(sv):
    assert fleet_knobs(sv) == jax_fleet_knobs(sv)


def test_affinity_keys_bitwise_jax():
    """The gateway hashes a prompt's first page with the engine's chain
    hash; the port's keys are JAX's byte for byte, so a port gateway
    routes on a JAX replica's adverts and the other way round."""
    rs = np.random.RandomState(3)
    for ps in (4, 16):
        for _ in range(20):
            toks = rs.randint(0, 32000, rs.randint(ps, 3 * ps)).tolist()
            parent = b"\x00"
            for i in range(0, len(toks) - ps + 1, ps):
                k, kj = (_page_key(parent, toks[i:i + ps]),
                         jax_page_key(parent, toks[i:i + ps]))
                assert k == kj
                parent = k
    # the gateway's preference set over adverts keyed by JAX's digests
    dep = Deployment.adopt(["http://127.0.0.1:1", "http://127.0.0.1:2"])
    gw = InferenceGateway(dep, affinity=True)
    try:
        toks = rs.randint(1, 999, 9).tolist()
        dep.replicas[1].page_size = 4
        dep.replicas[1].prefix_digests = frozenset(
            {jax_page_key(b"\x00", toks[:4]).hex()})
        dep.replicas[0].page_size = 4
        dep.replicas[0].prefix_digests = frozenset({"00" * 16})
        assert gw._affinity_prefer({"tokens": toks}, b"") == frozenset(
            {"adopted-1"})
    finally:
        gw._server.server_close()


# ------------------------------------------------------------ tiny fleet
@pytest.fixture(scope="module")
def fleet(setup):
    """2 engine-backed port replicas on a1 + adopted deployment + gateway.
    The rolling-update test moves the fleet to v2; later tests see v2."""
    model, pa1 = setup[4], setup[5]
    runners = [_replica(model, pa1) for _ in range(2)]
    dep = Deployment.adopt([f"http://127.0.0.1:{r.port}" for r in runners],
                           probation_deadline_s=2.0)
    gw = InferenceGateway(dep, scale_interval=30, retry_backoff_s=0.02)
    gw.start()
    yield runners, dep, gw
    gw.stop()
    for r in runners:
        r.stop()


def test_fleet_matches_jax_greedy_then_rolls_to_v2_under_load(
        tmp_path, setup, want, fleet):
    """Greedy tokens through the port's gateway equal the JAX predictor's
    on v1; then a v1 -> v2 rolling update under sustained traffic drops
    nothing, both replicas report v2 on /info, and the answers equal the
    JAX predictor's on v2 (JAX's tree, carried across)."""
    p1, p2 = want
    runners, dep, gw = fleet
    url = f"http://127.0.0.1:{gw.port}/predict"
    prompts = [_prompt(6, s) for s in range(3)]
    for p in prompts:      # both replicas are hit: round-robin ties
        for _ in range(2):
            assert _post(url, {"tokens": p, "max_new_tokens": 6})[1][
                "generated_tokens"] == _greedy(p1, p, 6)
    store = FileArtifactStore(str(tmp_path))
    # the replica's /swap reads the port's names: the store holds JAX's v2
    # tree carried across
    store.put(adapter_name(2), {k: {n: t.numpy() for n, t in ab.items()}
                                for k, ab in setup[6].items()})
    codes: list = []
    stop = threading.Event()

    def load():
        while not stop.is_set():
            try:
                codes.append(_post(url, {"tokens": prompts[0],
                                         "max_new_tokens": 4})[0])
            except urllib.error.HTTPError as e:
                codes.append(e.code)

    threads = [threading.Thread(target=load, daemon=True) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        updated = dep.rolling_update(store, adapter_name(2), version=2,
                                     timeout=60)
    finally:
        time.sleep(0.2)
        stop.set()
        for t in threads:
            t.join(timeout=30)
    assert len(updated) == 2
    assert codes and all(c == 200 for c in codes), codes
    assert dep.versions() == {"adopted-0": 2, "adopted-1": 2}
    for p in prompts:
        for _ in range(2):
            assert _post(url, {"tokens": p, "max_new_tokens": 6})[1][
                "generated_tokens"] == _greedy(p2, p, 6)


def test_version_pinning_409_and_gateway_reroute(fleet):
    """A pinned request 409s on the wrong replica (replica stays READY);
    the gateway reroutes a pin to a replica that serves it, and surfaces
    409 only when nobody does. The fleet is at v2 (test above)."""
    runners, dep, gw = fleet
    url = f"http://127.0.0.1:{gw.port}/predict"
    prompt = _prompt()
    code, _ = _post(url, {"tokens": prompt, "max_new_tokens": 2,
                          "model_version": 2})
    assert code == 200
    info0 = dep.replica_info(dep.replicas[0])
    assert info0["model_version"] == 2
    pred0 = runners[0].predictor
    pred0.swap_adapters({k: {n: t * 0.5 for n, t in ab.items()}
                         for k, ab in pred0.adapters.items()}, version=3)
    before = _counter("serving.gateway_pin_reroutes")
    for pin in (3, 2, 3, 3, 3, 3):
        code, _ = _post(url, {"tokens": prompt, "max_new_tokens": 2,
                              "model_version": pin})
        assert code == 200, (pin, code)
        if _counter("serving.gateway_pin_reroutes") > before:
            break
    assert _counter("serving.gateway_pin_reroutes") > before
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(url, {"tokens": prompt, "max_new_tokens": 2,
                    "model_version": 99})
    assert ei.value.code == 409
    assert len(dep.ready_replicas()) == 2
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(f"{dep.replicas[1].endpoint}/predict",
              {"tokens": prompt, "max_new_tokens": 2, "model_version": 99})
    assert ei.value.code == 409
    assert json.loads(ei.value.read())["model_version"] == 2
    with pytest.raises(StaleVersion):
        runners[1].predictor.predict(
            {"tokens": prompt, "max_new_tokens": 2, "model_version": 99})


def test_garbage_body_is_400_and_never_drains_the_pool(fleet):
    _runners, dep, gw = fleet
    url = f"http://127.0.0.1:{gw.port}/predict"
    for body in (b"not json{{{", b"[1, 2, 3]", b'"hi"', b"42"):
        req = urllib.request.Request(
            url, data=body, headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=30)
        ei.value.read()
        assert ei.value.code == 400, (body, ei.value.code)
    assert len(dep.ready_replicas()) == 2


def test_gateway_sse_relay_and_info(fleet):
    """An SSE stream through the gateway: per-token events, then a done
    event equal to the JSON answer; /info carries version and load. The
    fleet is mixed (v3 and v2, test above): both requests pin v2."""
    runners, _dep, gw = fleet
    url = f"http://127.0.0.1:{gw.port}/predict"
    prompt = _prompt(8, seed=5)
    _code, want_ = _post(url, {"tokens": prompt, "max_new_tokens": 6,
                               "model_version": 2})
    ctype, events = _sse(url, {"tokens": prompt, "max_new_tokens": 6,
                               "stream": True, "model_version": 2})
    assert ctype == "text/event-stream"
    toks = [e["token"] for e in events if "token" in e]
    assert [e.get("index") for e in events if "token" in e] == list(range(6))
    assert toks == want_["generated_tokens"]
    assert events[-1]["done"] is True
    with urllib.request.urlopen(
            f"http://127.0.0.1:{runners[1].port}/info", timeout=30) as r:
        info = json.loads(r.read())
    assert info["model_version"] == 2 and info["draining"] is False
    assert info["queue_depth"] == 0


# ------------------------------------------------- probation / shedding
class _ToggleReplica:
    """Stub replica whose health is a flag: when down, /ready answers 503
    and /predict 500 — the transient-failure shape probation exists for."""

    def __init__(self, delay_s: float = 0.0):
        stub = self
        self.up = True
        self.delay_s = delay_s

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code, payload):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                self._send(200 if stub.up else 503, {"up": stub.up})

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                self.rfile.read(n)
                if not stub.up:
                    self._send(500, {"error": "flaking"})
                    return
                if stub.delay_s:
                    time.sleep(stub.delay_s)
                self._send(200, {"generated_tokens": [1]})

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.port = self.server.server_address[1]
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    def stop(self):
        self.server.shutdown()
        self.server.server_close()


def test_probation_flap_then_recover():
    stub = _ToggleReplica()
    dep = Deployment.adopt([f"http://127.0.0.1:{stub.port}"],
                           probation_deadline_s=5.0, probe_backoff_s=0.02)
    gw = InferenceGateway(dep, scale_interval=30, retry_backoff_s=0.01)
    gw.start()
    url = f"http://127.0.0.1:{gw.port}/predict"
    try:
        assert _post(url, {"x": 1})[0] == 200
        stub.up = False
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url, {"x": 1})
        assert ei.value.code in (502, 503)
        assert dep.replicas[0].state == "SUSPECT"
        assert dep.ready_replicas() == []
        assert _counter("serving.replica_suspects") == 1
        stub.up = True
        deadline = time.monotonic() + 5
        while (dep.replicas[0].state != "READY"
               and time.monotonic() < deadline):
            time.sleep(0.02)
        assert dep.replicas[0].state == "READY", "never recovered"
        assert _counter("serving.replica_recoveries") == 1
        assert _post(url, {"x": 1})[0] == 200
        stub.up = False
        try:
            _post(url, {"x": 1})
        except urllib.error.HTTPError:
            pass
        deadline = time.monotonic() + 8
        while (dep.replicas[0].state != "DEAD"
               and time.monotonic() < deadline):
            time.sleep(0.05)
        assert dep.replicas[0].state == "DEAD"
    finally:
        gw.stop()
        stub.stop()


def test_gateway_sheds_429_with_retry_after():
    stub = _ToggleReplica(delay_s=0.25)
    dep = Deployment.adopt([f"http://127.0.0.1:{stub.port}"])
    gw = InferenceGateway(dep, scale_interval=30, shed_watermark=2.0,
                          retry_after_s=1.5)
    gw.start()
    url = f"http://127.0.0.1:{gw.port}/predict"
    results: list = []
    lock = threading.Lock()

    def hit():
        t0 = time.perf_counter()
        try:
            code = _post(url, {"x": 1})[0]
            hdr = None
        except urllib.error.HTTPError as e:
            code = e.code
            hdr = e.headers.get("Retry-After")
            e.read()
        with lock:
            results.append((code, hdr, time.perf_counter() - t0))

    try:
        threads = [threading.Thread(target=hit) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        codes = [c for c, _h, _dt in results]
        sheds = [(c, h, dt) for c, h, dt in results if c == 429]
        assert sheds, f"nothing shed: {codes}"
        assert codes.count(200) >= 1
        assert set(codes) <= {200, 429}, codes
        for _c, hdr, dt in sheds:
            assert hdr == "2"
            assert dt < 0.2, f"shed was not fast: {dt:.3f}s"
        assert _counter("serving.shed_total") == len(sheds)
        assert _post(url, {"x": 1})[0] == 200
    finally:
        gw.stop()
        stub.stop()


# ------------------------------------------------- mid-stream failover
def test_midstream_chaos_kill_greedy_reserved_sampled_errors(setup, want):
    """A replica chaos-killed mid-stream: the greedy stream is re-served
    by the survivor with total output identical to an unkilled run (f32),
    and a sampled stream surfaces a terminal 503-coded error event, never
    a fake `done`."""
    model, pa1 = setup[4], setup[5]
    p1 = want[0]
    prompt = _prompt()
    want_toks = _greedy(p1, prompt, 12)
    doomed = _replica(model, pa1, chaos=FaultSpec(replica_kill={0: 4}))
    survivor = _replica(model, pa1)
    dep = Deployment.adopt([f"http://127.0.0.1:{doomed.port}",
                            f"http://127.0.0.1:{survivor.port}"],
                           probation_deadline_s=0.5)
    gw = InferenceGateway(dep, scale_interval=30, retry_backoff_s=0.01)
    gw.start()
    url = f"http://127.0.0.1:{gw.port}/predict"
    try:
        fired = False
        for _ in range(6):
            _ctype, events = _sse(url, {"tokens": prompt,
                                        "max_new_tokens": 12,
                                        "stream": True})
            toks = [e["token"] for e in events if "token" in e]
            assert events[-1].get("done") is True
            assert toks == want_toks, "failover stream diverged"
            if _counter("serving.stream_failovers"):
                fired = True
                break
        assert fired, "replica_kill never fired"
        assert dep.replicas[0].state in ("SUSPECT", "DEAD")

        doomed2 = _replica(model, pa1, chaos=FaultSpec(replica_kill={0: 2}))
        dep2 = Deployment.adopt([f"http://127.0.0.1:{doomed2.port}"],
                                probation_deadline_s=0.5)
        gw2 = InferenceGateway(dep2, scale_interval=30,
                               retry_backoff_s=0.01)
        gw2.start()
        url2 = f"http://127.0.0.1:{gw2.port}/predict"
        try:
            saw_clean_error = False
            for _ in range(4):
                try:
                    _ctype, events = _sse(
                        url2, {"tokens": prompt, "max_new_tokens": 10,
                               "stream": True, "temperature": 2.0,
                               "seed": 7})
                except urllib.error.HTTPError as e:
                    assert e.code == 503
                    saw_clean_error = True
                    break
                if any("error" in e for e in events):
                    assert not any(e.get("done") for e in events), events
                    assert events[-1]["code"] == 503
                    saw_clean_error = True
                    break
                assert events[-1].get("done") is True
            assert saw_clean_error, "sampled kill never surfaced"
        finally:
            gw2.stop()
            doomed2.stop()
    finally:
        gw.stop()
        doomed.stop()
        survivor.stop()


def test_midstream_kill_during_version_skew_continues_stream(setup, want):
    """A replica dies mid-stream while the only survivor serves a newer
    adapter version: the greedy replay diverges inside the delivered
    prefix, and the unpinned stream is CONTINUED — prompt + delivered
    tokens re-issued under v2 — with a real `done` and contiguous
    indices. The JAX predictors are the oracle for both halves."""
    model, pa1, pa2 = setup[4], setup[5], setup[6]
    p1, p2 = want
    prompt = _prompt()
    want1, want2 = _greedy(p1, prompt, 12), _greedy(p2, prompt, 12)
    assert want1[:4] != want2[:4], "fixture adapters too similar"
    doomed = _replica(model, pa1, chaos=FaultSpec(replica_kill={0: 4}))
    survivor = _replica(model, pa2)
    dep = Deployment.adopt([f"http://127.0.0.1:{doomed.port}",
                            f"http://127.0.0.1:{survivor.port}"],
                           probation_deadline_s=0.5)
    gw = InferenceGateway(dep, scale_interval=30, retry_backoff_s=0.01)
    gw.start()
    url = f"http://127.0.0.1:{gw.port}/predict"
    try:
        cut_toks = cut_events = None
        for _ in range(6):
            _ctype, events = _sse(url, {"tokens": prompt,
                                        "max_new_tokens": 12,
                                        "stream": True})
            toks = [e["token"] for e in events if "token" in e]
            assert events[-1].get("done") is True, events[-1]
            assert len(toks) == 12
            if _counter("serving.stream_continuations"):
                cut_toks, cut_events = toks, events
                break
            assert toks in (want1, want2)
        assert cut_toks is not None, "replica_kill never fired mid-stream"
        assert cut_toks[:4] == want1[:4]
        assert cut_toks[4:] == _greedy(p2, prompt + cut_toks[:4], 8)
        assert [e["index"] for e in cut_events if "token" in e] == \
            list(range(12))
        done_ev = [e for e in cut_events if e.get("done")][-1]
        assert done_ev["generated_tokens"] == cut_toks
        assert _counter("serving.stream_replay_divergences") == 1
        assert _counter("serving.stream_continuations") == 1
    finally:
        gw.stop()
        doomed.stop()
        survivor.stop()


# --------------------------------------- gateway policies over stubs
class _CodeHandler:
    """Tiny HTTP server whose /predict always answers a fixed code."""

    def __init__(self, code: int):
        status = code

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                self.rfile.read(n)
                body = json.dumps({"code": status}).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.port = self.server.server_address[1]
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    def stop(self):
        self.server.shutdown()
        self.server.server_close()


class _StubDep:
    """Duck-typed Deployment: deterministic acquire (first READY),
    records suspects instead of running real probation."""

    def __init__(self, reps):
        self.reps = reps
        self.suspected = 0

    def ready_replicas(self):
        return [r for r in self.reps if r.state == "READY"]

    def acquire(self, exclude=None, prefer=None):
        ready = [r for r in self.ready_replicas()
                 if not exclude or r.replica_id not in exclude]
        if prefer:
            hot = [r for r in ready if r.replica_id in prefer]
            if hot:
                ready = hot
        if ready:
            ready[0].inflight += 1
        return ready[0] if ready else None

    def release(self, rep):
        rep.inflight -= 1

    def mark_suspect(self, rep):
        rep.state = "SUSPECT"
        self.suspected += 1

    def reap_and_heal(self):
        pass


def _reps(servers):
    out = []
    for i, s in enumerate(servers):
        r = _Replica(f"job{i}")
        r.replica_id = f"rep{i}"
        r.endpoint = f"http://127.0.0.1:{s.port}"
        r.state = "READY"
        out.append(r)
    return out


def test_gateway_4xx_keeps_replica_5xx_suspects_with_backoff():
    servers = [_CodeHandler(500), _CodeHandler(400), _CodeHandler(200)]
    bad5, bad4, good = _reps(servers)
    try:
        dep = _StubDep([bad4, good])
        gw = InferenceGateway(dep, retry_backoff_s=0.1)
        code, payload = gw._forward(b"{}", tries=3)
        assert code == 400 and payload == {"code": 400}
        assert bad4.state == "READY" and dep.suspected == 0
        gw._server.server_close()
        dep = _StubDep([bad5, good])
        gw = InferenceGateway(dep, retry_backoff_s=0.1)
        t0 = time.monotonic()
        code, payload = gw._forward(b"{}", tries=3)
        elapsed = time.monotonic() - t0
        assert code == 200 and payload == {"code": 200}
        assert bad5.state == "SUSPECT" and dep.suspected == 1
        assert good.state == "READY"
        assert elapsed >= 0.09, f"no backoff between attempts ({elapsed})"
        assert bad5.inflight == 0 and good.inflight == 0
        gw._server.server_close()
    finally:
        for s in servers:
            s.stop()


def test_gateway_409_reroute_excludes_stale_replica():
    servers = [_CodeHandler(409), _CodeHandler(200)]
    reps = _reps(servers)
    try:
        dep = _StubDep(reps)
        gw = InferenceGateway(dep, retry_backoff_s=0.01)
        code, payload = gw._forward(b"{}", tries=3)
        assert code == 200 and payload == {"code": 200}
        assert dep.suspected == 0
        assert all(r.inflight == 0 for r in reps)
        gw._server.server_close()
    finally:
        for s in servers:
            s.stop()


class _SSEReplica:
    """/predict streams token events then done (or, with `stale`, one
    token then a terminal 409-coded error event)."""

    def __init__(self, n_tokens: int = 3, stale: bool = False):
        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                self.rfile.read(n)
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.end_headers()
                if stale:
                    self.wfile.write(b'data: {"token": 7, "index": 0}\n\n')
                    self.wfile.write(b'data: {"error": "StaleVersion: '
                                     b'pinned 1", "code": 409}\n\n')
                    return
                for i in range(n_tokens):
                    self.wfile.write(b"data: " + json.dumps(
                        {"token": 7, "index": i}).encode() + b"\n\n")
                self.wfile.write(b'data: {"done": true}\n\n')

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.port = self.server.server_address[1]
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    def stop(self):
        self.server.shutdown()
        self.server.server_close()


class _CaptureHandler:
    """Duck-typed downstream handler capturing what the gateway relays;
    with `dead`, every body write raises (the client hung up)."""

    def __init__(self, dead: bool = False):
        outer = self
        self.sent: list = []
        self.body = b""

        class _W:
            def write(self, data):
                if dead:
                    raise BrokenPipeError("client went away")
                outer.body += data

            def flush(self):
                pass

        self.wfile = _W()

    def send_response(self, code):
        self.sent.append(code)

    def send_header(self, *a):
        pass

    def end_headers(self):
        pass

    def _send(self, code, payload, headers=None):
        self.sent.append(code)
        self.body += json.dumps(payload).encode()


def test_stream_client_disconnect_does_not_suspect_replica():
    sse = _SSEReplica(n_tokens=3)
    (rep,) = _reps([sse])
    try:
        dep = _StubDep([rep])
        gw = InferenceGateway(dep, retry_backoff_s=0.01)
        gw.forward_stream(b'{"stream": true}', _CaptureHandler(dead=True),
                          tries=3)
        assert dep.suspected == 0 and rep.state == "READY"
        assert rep.inflight == 0
        gw._server.server_close()
    finally:
        sse.stop()


def test_stream_mid_409_event_reroutes_without_suspect():
    stale, full = _SSEReplica(stale=True), _SSEReplica(n_tokens=3)
    reps = _reps([stale, full])
    try:
        dep = _StubDep(reps)
        gw = InferenceGateway(dep, retry_backoff_s=0.01)
        handler = _CaptureHandler()
        gw.forward_stream(b'{"stream": true, "model_version": 1}',
                          handler, tries=3)
        assert dep.suspected == 0
        assert b'"done": true' in handler.body
        assert handler.body.count(b'"token"') == 3
        assert all(r.inflight == 0 for r in reps)
        gw._server.server_close()
    finally:
        stale.stop()
        full.stop()


def test_sampled_stream_cut_before_first_byte_fails_over():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead_port = s.getsockname()[1]
    s.close()
    full = _SSEReplica(n_tokens=2)
    dead, live = _reps([full, full])
    dead.endpoint = f"http://127.0.0.1:{dead_port}"
    try:
        dep = _StubDep([dead, live])
        gw = InferenceGateway(dep, retry_backoff_s=0.01)
        handler = _CaptureHandler()
        gw.forward_stream(b'{"stream": true, "temperature": 1.0}',
                          handler, tries=3)
        assert dead.state == "SUSPECT" and dep.suspected == 1
        assert live.state == "READY"
        assert b'"done": true' in handler.body
        gw._server.server_close()
    finally:
        full.stop()


class _SwapStubReplica:
    """/ready, /info (model_version) and /swap with the engine's
    monotonic-version guard (a 400)."""

    def __init__(self, model_version: int = 1):
        outer = self
        self.model_version = model_version
        self.swaps: list = []
        self.on_swap = None

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code, payload):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/ready":
                    self._send(200, {"status": "Success"})
                else:
                    self._send(200, {"model_version": outer.model_version})

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                ver = int(body.get("version", -1))
                if ver < outer.model_version:
                    self._send(400, {"error": "model_version must be "
                                              "monotonic"})
                    return
                outer.swaps.append(ver)
                outer.model_version = ver
                if outer.on_swap is not None:
                    outer.on_swap()
                self._send(200, {"model_version": ver})

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.port = self.server.server_address[1]
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    def stop(self):
        self.server.shutdown()
        self.server.server_close()


def test_probation_converges_replica_ahead_of_target():
    stub = _SwapStubReplica(model_version=2)
    try:
        dep = Deployment.adopt([f"http://127.0.0.1:{stub.port}"],
                               probation_deadline_s=3.0,
                               probe_backoff_s=0.02)
        rep = dep.replicas[0]
        dep._adapter_target = (b"{}", 1)
        dep.mark_suspect(rep)
        deadline = time.monotonic() + 2.5
        while rep.state != "READY" and time.monotonic() < deadline:
            time.sleep(0.02)
        assert rep.state == "READY"
        assert stub.swaps == [], "replica was re-driven backwards"
    finally:
        stub.stop()


def test_rolling_update_sweeps_probation_rejoiner(tmp_path):
    a, b = _SwapStubReplica(1), _SwapStubReplica(1)
    try:
        dep = Deployment.adopt([f"http://127.0.0.1:{a.port}",
                                f"http://127.0.0.1:{b.port}"])
        rep_b = dep.replicas[1]
        rep_b.state = "SUSPECT"
        a.on_swap = lambda: setattr(rep_b, "state", "READY")
        dep.rolling_update(FileArtifactStore(str(tmp_path)), "adapters-v2",
                           version=2, timeout=10)
        assert b.swaps == [2] and rep_b.model_version == 2
    finally:
        a.stop()
        b.stop()


# ---------------------------------------------------- affinity routing
PS_AFF, NP_AFF, NREQ_AFF = 4, 12, 60
_rs = np.random.RandomState(0)
AFF_PROMPTS = [_rs.randint(1, 999, 8).tolist() for _ in range(NP_AFF)]
AFF_STREAM = [(int(z) - 1) % NP_AFF for z in _rs.zipf(1.5, NREQ_AFF)]


def _digest(toks):
    return _page_key(b"\x00", toks[:PS_AFF]).hex()


def _aff_stub():
    """A replica that learns and advertises the first-page digests of the
    prompts it served (the headers a paged runner sends) and reports
    whether it had served a prompt's first page before."""
    state = {"served": set(), "count": 0, "lock": threading.Lock()}

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def do_POST(self):
            n = int(self.headers.get("Content-Length") or 0)
            toks = json.loads(self.rfile.read(n) or b"{}").get("tokens", [])
            with state["lock"]:
                state["count"] += 1
                hit = False
                if len(toks) >= PS_AFF:
                    d = _digest(toks)
                    hit = d in state["served"]
                    state["served"].add(d)
                advert = ",".join(sorted(state["served"]))
            body = json.dumps({"generated_tokens": [0], "hit": hit}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("X-KV-Page-Size", str(PS_AFF))
            self.send_header("X-Prefix-Digest", advert)
            self.end_headers()
            self.wfile.write(body)

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, state


@pytest.fixture(scope="module")
def aff_fleet():
    stubs = [_aff_stub() for _ in range(4)]
    dep = Deployment.adopt(
        [f"http://127.0.0.1:{s.server_address[1]}" for s, _ in stubs])
    _dep_kw, gw_kw = fleet_knobs({"affinity_routing": True})
    gw = InferenceGateway(dep, scale_interval=30, **gw_kw)
    yield gw, dep, [st for _, st in stubs]
    gw._server.server_close()
    for srv, _ in stubs:
        srv.shutdown()
        srv.server_close()


def _fwd(gw, toks):
    code, payload = gw.forward(json.dumps({"tokens": toks}).encode())
    assert code == 200, (code, payload)
    return payload


def test_affinity_zipf_hit_rate_and_counters(aff_fleet):
    gw, _dep, states = aff_fleet
    hits = sum(_fwd(gw, AFF_PROMPTS[i])["hit"] for i in AFF_STREAM)
    single = NREQ_AFF - len(set(AFF_STREAM))
    assert hits >= 0.8 * single, (hits, single)
    assert _counter("serving.affinity.hits") == hits == single
    assert _counter("serving.affinity.misses") == len(set(AFF_STREAM))
    assert sum(len(st["served"]) for st in states) == len(set(AFF_STREAM))
    _fwd(gw, [1, 2])           # shorter than a page: a served miss
    assert _counter("serving.affinity.misses") == len(set(AFF_STREAM)) + 1


def test_affinity_never_routes_to_suspect_and_falls_back(aff_fleet):
    gw, dep, states = aff_fleet
    hot = AFF_PROMPTS[AFF_STREAM[0]]
    holder = next(r for r in dep.ready_replicas()
                  if _digest(hot) in r.prefix_digests)
    idx = int(holder.replica_id.rsplit("-", 1)[1])
    with dep._lock:
        holder.state = R_SUSPECT
    before = states[idx]["count"]
    try:
        for _ in range(5):
            _fwd(gw, hot)
    finally:
        with dep._lock:
            holder.state = R_READY
    assert states[idx]["count"] == before, "affinity routed to SUSPECT"
    assert _counter("serving.affinity.misses") == 1
    assert _counter("serving.affinity.hits") == 4
    # the race window: the hint names an advertiser that then goes
    # SUSPECT before acquire() -> a fallback to the healthy pool
    fresh = [777] * 8
    _fwd(gw, fresh)
    holder = next(r for r in dep.ready_replicas()
                  if _digest(fresh) in r.prefix_digests)
    prefer = gw._affinity_prefer(None, json.dumps({"tokens": fresh}).encode())
    assert holder.replica_id in prefer
    with dep._lock:
        holder.state = R_SUSPECT
    try:
        rep = dep.acquire(prefer=prefer)
        gw._count_affinity(rep, prefer)
        assert rep is not None and rep.replica_id != holder.replica_id
        dep.release(rep)
    finally:
        with dep._lock:
            holder.state = R_READY
    assert _counter("serving.affinity.fallbacks") == 1


# ------------------------------------------------------- start_replica
def test_start_replica_lm_spec_matches_jax(setup, want):
    """A "model_kind": "lm" spec with the flax tree and JAX's adapter tree
    (both carried across inside start_replica) on the paged engine with
    the kernel flag: the replica's greedy answers are the JAX
    predictor's."""
    fm, params, a1 = setup[:3]
    rid, runner = start_replica({
        "model_kind": "lm", "device": "cpu",
        "lm": {"vocab_size": V, "d_model": D, "n_layers": L, "n_heads": H,
               "d_ff": FF, "max_len": MAXLEN},
        "params": jax.tree.map(np.asarray, params), "adapters": a1,
        "serve": {"decode_slots": 2, "kv_page_size": 4, "prefill_chunk": 4,
                  "paged_kernel": True}})
    try:
        assert isinstance(rid, str) and runner.predictor.engine is not None
        for s in range(3):
            p = _prompt(7, seed=10 + s)
            assert _post(f"http://127.0.0.1:{runner.port}/predict",
                         {"tokens": p, "max_new_tokens": 5})[1][
                "generated_tokens"] == _greedy(want[0], p, 5)
    finally:
        runner.stop()


def test_entry_points_default_to_cuda():
    """start_replica and FleetHarness run on CUDA unless told "cpu", and
    raise without a GPU."""
    from fedml_tpu_torch.serving.fleet_harness import FleetHarness

    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the CUDA default does not raise")
    spec = {"model": "lr", "num_classes": 3, "input_shape": [4],
            "params": {"Dense_0.kernel": np.zeros((4, 3), np.float32),
                       "Dense_0.bias": np.zeros(3, np.float32)}}
    with pytest.raises(RuntimeError, match="CUDA"):
        start_replica(spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        FleetHarness()
    rid, runner = start_replica({**spec, "device": "cpu"})
    try:
        assert _post(f"http://127.0.0.1:{runner.port}/predict",
                     {"inputs": [[0.1, 0.2, 0.3, 0.4]]})[1][
            "predictions"] == [0]
    finally:
        runner.stop()
