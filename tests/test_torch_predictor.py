"""The port's serving surface above the engine, held against the JAX
package: the per-request generate path and `GreedyLMPredictor` (routing,
fallbacks, the version pin, hot swap), `TorchPredictor` against
`JaxPredictor`, the HTTP runner (JSON, SSE, the 400/409/500/501 mapping,
/ready, /info, /metrics, chaos replica_kill), `validate_serve_args` on the JAX
package's accept/refuse dicts, `lm_predictor_from_config`, and
`serve_simulator` / `predictor_from_checkpoint` over a small Simulator.

Both packages get the same flax parameters and numpy-drawn adapters;
greedy streams are compared under the near-tie rule (test_torch_serving).
Sampled tokens differ between the packages by design (ROADMAP C), so
the sampling cases hold the port to its own seeded determinism.
"""
import http.client
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu_torch
from fedml_tpu.config import Config as JaxConfig
from fedml_tpu.llm.lora import lora_merge as jax_lora_merge
from fedml_tpu.llm.transformer import TransformerLM as FlaxLM
from fedml_tpu.models import hub as jax_hub
from fedml_tpu.serving.knobs import validate_serve_args as jax_validate
from fedml_tpu.serving.predictor import GreedyLMPredictor as JaxLM
from fedml_tpu.serving.predictor import JaxPredictor
from fedml_tpu_torch import serving
from fedml_tpu_torch.comm.chaos import FaultSpec
from fedml_tpu_torch.config import Config
from fedml_tpu_torch.llm.lora import adapters_from_jax
from fedml_tpu_torch.llm.transformer import (
    ModelDims, TransformerLM, params_from_flax,
)
from fedml_tpu_torch.models import hub
from fedml_tpu_torch.serving.inference_runner import FedMLInferenceRunner
from fedml_tpu_torch.serving.knobs import validate_serve_args
from fedml_tpu_torch.serving.predictor import (
    GreedyLMPredictor, InvalidRequest, StaleVersion, TorchPredictor,
)
from fedml_tpu_torch.simulation.simulator import Simulator
from fedml_tpu_torch.utils import metrics as mx

torch.set_num_threads(2)

V, D, L, H, FF = 96, 64, 2, 4, 128
MAXLEN, PS, RANK = 32, 4, 4
NEAR_TIE = 1e-4
ENGINE = dict(decode_slots=3, kv_page_size=PS, prefill_chunk=4,
              paged_kernel=True, spec_decode="ngram", spec_k=3)


def _prompts(ns, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, V, n).tolist() for n in ns]


PROMPTS = [[5] * 8] + _prompts((6, 10, 7, 9, 5), seed=13)
BUDGETS = [7, 6, 8, 6, 7, 5]


def _jax_adapters(seed):
    rs = np.random.RandomState(seed)
    return {f"blocks/{n}/kernel": {
        "a": (0.1 * rs.standard_normal((L, D, RANK))).astype(np.float32),
        "b": (0.1 * rs.standard_normal((L, RANK, D))).astype(np.float32)}
        for n in ("wq", "wv")}


@pytest.fixture(scope="module")
def setup():
    fm = FlaxLM(vocab_size=V, d_model=D, n_layers=L, n_heads=H, d_ff=FF,
                scan_layers=True)
    params = jax.jit(fm.init)(jax.random.key(0),
                              jnp.zeros((1, 10), jnp.int32))["params"]
    model = TransformerLM.from_state(
        ModelDims(V, D, L, H, FF),
        params_from_flax(jax.tree.map(np.asarray, params), device="cpu"))
    return fm, params, model


@pytest.fixture(scope="module")
def jax_ref(setup):
    """The JAX per-request predictor's greedy streams for PROMPTS, without
    and with adapters (a1), and with the swapped-in adapters (a2)."""
    fm, params, _ = setup
    out = {}
    for name, ads in (("base", None), ("a1", _jax_adapters(1)),
                      ("a2", _jax_adapters(2))):
        pred = JaxLM(fm, params, max_len=MAXLEN, kv_cache=True, adapters=ads)
        out[name] = [pred.predict({"tokens": p, "max_new_tokens": b})
                     ["generated_tokens"] for p, b in zip(PROMPTS, BUDGETS)]
    return out


def _near_tie_identical(setup, want, got, adapters=None, prompts=PROMPTS):
    fm, params, _ = setup
    p = params if adapters is None else jax_lora_merge(params, adapters)
    apply = jax.jit(fm.apply)
    for prompt, a, b in zip(prompts, want, got):
        if a == b:
            continue
        j = next((k for k in range(min(len(a), len(b))) if a[k] != b[k]),
                 None)
        assert j is not None, (a, b)
        logits = np.asarray(apply({"params": p},
                                  jnp.asarray([prompt + a[:j]])))[0, -1]
        top2 = np.sort(logits)[-2:]
        assert float(top2[1] - top2[0]) < NEAR_TIE, (j, a, b)


def _predict_all(pred, prompts=PROMPTS, budgets=BUDGETS, **kw):
    return [pred.predict({"tokens": p, "max_new_tokens": b, **kw})
            ["generated_tokens"] for p, b in zip(prompts, budgets)]


def _counter(name):
    return mx.snapshot()["counters"].get(name, 0)


@pytest.fixture(scope="module")
def per_request(setup):
    return GreedyLMPredictor(setup[2], max_len=MAXLEN, kv_cache=True,
                             device="cpu")


# ------------------------------------------------------- per-request path
def test_per_request_greedy_matches_jax(setup, jax_ref, per_request):
    """Single prompts, a batch of prompts of different lengths, and the
    recompute path: the JAX per-request predictor's greedy tokens."""
    fm, params, model = setup
    _near_tie_identical(setup, jax_ref["base"], _predict_all(per_request))
    batch = per_request.predict({"tokens": PROMPTS[1:4],
                                 "max_new_tokens": 5})["generated_tokens"]
    jbatch = JaxLM(fm, params, max_len=MAXLEN, kv_cache=True).predict(
        {"tokens": PROMPTS[1:4], "max_new_tokens": 5})["generated_tokens"]
    _near_tie_identical(setup, jbatch, batch, prompts=PROMPTS[1:4])
    recompute = GreedyLMPredictor(model, max_len=MAXLEN, device="cpu")
    _near_tie_identical(setup, jax_ref["base"][:2],
                        _predict_all(recompute, PROMPTS[:2], BUDGETS[:2]))


def test_per_request_adapters_match_jax(setup, jax_ref):
    pred = GreedyLMPredictor(
        setup[2], max_len=MAXLEN, kv_cache=True, device="cpu",
        adapters=adapters_from_jax(_jax_adapters(1), device="cpu"))
    _near_tie_identical(setup, jax_ref["a1"], _predict_all(pred),
                        _jax_adapters(1))


def test_top_k_seeded_determinism_and_sampler_cache(setup):
    pred = GreedyLMPredictor(setup[2], max_len=MAXLEN, kv_cache=True,
                             sampler_cache_size=2, device="cpu")
    req = {"tokens": PROMPTS[1], "max_new_tokens": 8, "temperature": 1.5}
    a = pred.predict({**req, "top_k": 5, "seed": 3})
    assert a == pred.predict({**req, "top_k": 5, "seed": 3})
    assert a != pred.predict({**req, "top_k": 5, "seed": 4})
    # top_k 5 rounds up to the bucket 8, as in the JAX predictor
    assert a == pred.predict({**req, "top_k": 8, "seed": 3})
    ev0 = _counter("serving.sampler_evictions")
    for k in (1, 2, 16):
        pred.predict({**req, "top_k": k, "seed": 1})
    assert _counter("serving.sampler_evictions") - ev0 == 2
    assert list(pred._samplers) == [2, 16]
    for bad, msg in (({"top_k": 200, "temperature": 1.0},
                      r"top_k must be in \[0, vocab_size=96\]"),
                     ({"top_k": 4}, "only apply when temperature > 0"),
                     ({"max_new_tokens": 30}, "bucketed to 32 decode steps")):
        with pytest.raises(InvalidRequest, match=msg):
            pred.predict({"tokens": PROMPTS[1], "max_new_tokens": 4, **bad})
    fm, params, _ = setup
    with pytest.raises(Exception, match=r"top_k must be in \[0, "
                                        r"vocab_size=96\]"):
        JaxLM(fm, params, max_len=MAXLEN, kv_cache=True).predict(
            {"tokens": PROMPTS[1], "max_new_tokens": 4, "top_k": 200,
             "temperature": 1.0})


# ---------------------------------------------------- engine route, degrade
def test_engine_route_and_fallbacks(setup, jax_ref):
    """Single greedy prompts go to the engine; top_k and batched requests
    and requests over the page budget take the per-request path; a
    stopped engine degrades greedy requests and surfaces seeded ones."""
    model = setup[2]
    pred = GreedyLMPredictor(model, max_len=MAXLEN, kv_cache=True,
                             decode_slots=2, kv_page_size=PS, kv_n_pages=3,
                             device="cpu")
    try:
        r0 = _counter("serving.engine.requests")
        got = _predict_all(pred, PROMPTS[:1], [3])   # 8 + 3 > 8: per-req
        assert _counter("serving.engine.requests") == r0
        short = pred.predict({"tokens": PROMPTS[1][:4], "max_new_tokens": 4})
        assert _counter("serving.engine.requests") == r0 + 1
        pred.predict({"tokens": PROMPTS[1][:4], "max_new_tokens": 4,
                      "temperature": 1.0, "top_k": 4, "seed": 1})
        pred.predict({"tokens": PROMPTS[1:3], "max_new_tokens": 2})
        assert _counter("serving.engine.requests") == r0 + 1
        _near_tie_identical(setup, [jax_ref["base"][0][:3]], got)
        pred.engine.stop()
        assert pred.predict({"tokens": PROMPTS[1][:4],
                             "max_new_tokens": 4}) == short
        with pytest.raises(RuntimeError, match="stopped"):
            pred.predict({"tokens": PROMPTS[1][:4], "max_new_tokens": 4,
                          "temperature": 1.0, "seed": 2})
    finally:
        pred.stop()
    eos = GreedyLMPredictor(model, max_len=MAXLEN, kv_cache=True,
                            decode_slots=2, kv_page_size=PS, kv_n_pages=3,
                            eos_id=0, device="cpu")
    try:
        with pytest.raises(InvalidRequest, match=r"ceil\(11/4\) = 3 KV"):
            eos.predict({"tokens": PROMPTS[0], "max_new_tokens": 3})
    finally:
        eos.stop()


def test_kernel_engine_failure_surfaces(setup, monkeypatch):
    """An engine on the paged kernel never degrades to the per-request
    path's dense attention: a failed K4 launch fails the request, and
    every later one (JSON and stream) surfaces the dead engine."""
    from fedml_tpu_torch.ops import paged_attention as pa

    def broken(*_a, **_k):
        raise RuntimeError("K4 launch failed")

    monkeypatch.setattr(pa, "paged_attention", broken)
    pred = GreedyLMPredictor(setup[2], max_len=MAXLEN, kv_cache=True,
                             device="cpu", **ENGINE)
    req = {"tokens": PROMPTS[1][:4], "max_new_tokens": 4}
    try:
        with pytest.raises(RuntimeError, match="K4 launch failed"):
            pred.predict(dict(req))
        with pytest.raises(RuntimeError, match="stopped"):
            pred.predict(dict(req))
        with pytest.raises(RuntimeError, match="stopped"):
            list(pred.predict_stream(dict(req)))
    finally:
        pred.stop()


def test_version_pin_and_swap_without_engine(setup, jax_ref):
    pred = GreedyLMPredictor(
        setup[2], max_len=MAXLEN, kv_cache=True, device="cpu",
        adapters=adapters_from_jax(_jax_adapters(1), device="cpu"))
    req = {"tokens": PROMPTS[0], "max_new_tokens": BUDGETS[0]}
    assert pred.predict({**req, "model_version": 0})["generated_tokens"] \
        == pred.predict(req)["generated_tokens"]
    assert pred.swap_adapters(adapters_from_jax(_jax_adapters(2),
                                                device="cpu")) == 1
    with pytest.raises(StaleVersion, match="pinned model_version 0"):
        pred.predict({**req, "model_version": 0})
    with pytest.raises(StaleVersion):
        next(pred.predict_stream({**req, "model_version": 0}))
    _near_tie_identical(setup, jax_ref["a2"], _predict_all(pred),
                        _jax_adapters(2))
    with pytest.raises(ValueError, match="built without adapters"):
        GreedyLMPredictor(setup[2], max_len=MAXLEN, kv_cache=True,
                          device="cpu").swap_adapters({})


@pytest.mark.parametrize("kw,msg", [
    (dict(decode_slots=2), "needs kv_cache=True"),
    (dict(kv_cache=True, kv_page_size=4), "need decode_slots > 0"),
    (dict(kv_cache=True, decode_slots=2, spec_decode="ngram"),
     "need the PAGED engine"),
    (dict(kv_cache=True, decode_slots=2, kv_quant="int8"),
     "kv_quant stores the PAGED"),
    (dict(kv_cache=True, admit_batch=2), "batches the decode ENGINE"),
    (dict(adapters={}), "need kv_cache=True"),
])
def test_predictor_gating_as_jax(setup, kw, msg):
    fm, params, model = setup
    with pytest.raises(ValueError, match=msg):
        JaxLM(fm, params, max_len=MAXLEN, **kw)
    with pytest.raises(ValueError, match=msg):
        GreedyLMPredictor(model, max_len=MAXLEN, device="cpu", **kw)


def test_engine_mp_not_ported(setup):
    """engine_mp > 1 builds an {"mp": N} mesh over torch.distributed ranks
    (test_torch_engine_tp.py runs it); outside a world of ranks it
    refuses to start."""
    with pytest.raises(RuntimeError, match="torch.distributed initialised"):
        GreedyLMPredictor(setup[2], max_len=MAXLEN, kv_cache=True,
                          decode_slots=2, engine_mp=2, device="cpu")


# ------------------------------------------------------------------- HTTP
def _http(port, method, path, body=None, raw=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    conn.request(method, path, body=data,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    payload = resp.read().decode()
    headers = dict(resp.getheaders())
    conn.close()
    return resp.status, payload, headers


def _sse_events(payload):
    return [json.loads(line[len("data: "):])
            for line in payload.splitlines() if line.startswith("data: ")]


@pytest.fixture(scope="module")
def served(setup):
    """A GreedyLMPredictor over the paged kernel engine with speculation
    and adapters, behind the runner on 127.0.0.1 (port 0)."""
    pred = GreedyLMPredictor(
        setup[2], max_len=MAXLEN, kv_cache=True, device="cpu",
        adapters=adapters_from_jax(_jax_adapters(1), device="cpu"),
        **ENGINE)
    runner = FedMLInferenceRunner(pred, port=0).start()
    yield pred, runner
    runner.stop()


def test_http_concurrent_predicts_match_direct_and_jax(setup, jax_ref,
                                                       served):
    pred, runner = served
    results = [None] * len(PROMPTS)

    def post(i):
        results[i] = _http(runner.port, "POST", "/predict",
                           {"tokens": PROMPTS[i],
                            "max_new_tokens": BUDGETS[i]})

    threads = [threading.Thread(target=post, args=(i,))
               for i in range(len(PROMPTS))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert [r[0] for r in results] == [200] * len(PROMPTS)
    got = [json.loads(r[1])["generated_tokens"] for r in results]
    direct = [t.result(timeout=120) for t in
              [pred.engine.submit(p, b) for p, b in zip(PROMPTS, BUDGETS)]]
    assert got == direct
    _near_tie_identical(setup, jax_ref["a1"], got, _jax_adapters(1))
    assert results[0][2]["X-KV-Page-Size"] == str(PS)
    assert results[0][2]["X-Prefix-Digest"]


def test_http_sse_ready_info_and_error_mapping(served, setup, jax_ref,
                                               tmp_path):
    pred, runner = served
    body = {"tokens": PROMPTS[2], "max_new_tokens": BUDGETS[2]}
    code, payload, _ = _http(runner.port, "POST", "/predict", body)
    assert code == 200
    want = json.loads(payload)["generated_tokens"]
    code, payload, headers = _http(runner.port, "POST", "/predict",
                                   {**body, "stream": True})
    assert code == 200 and headers["Content-Type"] == "text/event-stream"
    events = _sse_events(payload)
    assert [e["token"] for e in events[:-1]] == want
    assert events[-1] == {"done": True, "generated_tokens": want}
    assert _http(runner.port, "GET", "/ready")[:2] == (
        200, json.dumps({"status": "Success"}))
    info = json.loads(_http(runner.port, "GET", "/info")[1])
    assert info["model_version"] == 0 and info["kv_page_size"] == PS
    assert info["draining"] is False and info["decode_queue"] == 0
    assert isinstance(info["prefix_digests"], list)
    for bad, code in (({"max_new_tokens": 3}, 400),               # no tokens
                      ({"tokens": [1, 2], "top_k": 4}, 400),
                      ({"tokens": [1] * 30, "max_new_tokens": 8}, 400),
                      ({"tokens": [1, 2], "model_version": 7}, 409)):
        got = _http(runner.port, "POST", "/predict", bad)
        assert got[0] == code, (bad, got)
    stale = json.loads(_http(runner.port, "POST", "/predict",
                             {"tokens": [1, 2], "model_version": 7})[1])
    assert stale["model_version"] == 0
    assert _http(runner.port, "POST", "/predict", raw=b"{oops")[0] == 400
    assert _http(runner.port, "POST", "/predict", raw=b"[1]")[0] == 400
    # /metrics serves the process registry as Prometheus text (the
    # requests above were counted)
    code, payload, headers = _http(runner.port, "GET", "/metrics")
    assert code == 200 and headers["Content-Type"].startswith("text/plain")
    from fedml_tpu_torch.utils.prometheus import parse_prometheus

    assert parse_prometheus(payload)["histograms"]
    # /swap fetches adapters from the artifact store the body names: 400
    # for a body that names no store or no artifact, 200 and the new
    # version for a2, which then serves the JAX predictor's a2 streams
    from fedml_tpu_torch.utils.artifacts import (
        FileArtifactStore, adapter_name, store_spec,
    )

    store = FileArtifactStore(str(tmp_path / "arts"))
    a2 = adapters_from_jax(_jax_adapters(2), device="cpu")
    store.put(adapter_name(2), a2)
    spec = store_spec(store)
    for bad in ({}, {"store": spec}, {"store": spec, "name": "nope"},
                {"store": {"kind": "s3"}, "name": adapter_name(2)}):
        assert _http(runner.port, "POST", "/swap", bad)[0] == 400, bad
    assert _http(runner.port, "POST", "/swap", raw=b"[1]")[0] == 400
    code, payload, _ = _http(runner.port, "POST", "/swap",
                             {"store": spec, "name": adapter_name(2)})
    assert code == 200 and json.loads(payload) == {"model_version": 1}
    assert pred.model_version == 1
    assert all(torch.equal(pred.adapters[n][k], a2[n][k])
               for n in a2 for k in ("a", "b"))
    got = [json.loads(_http(runner.port, "POST", "/predict",
                            {"tokens": p_, "max_new_tokens": b_})[1])
           ["generated_tokens"] for p_, b_ in zip(PROMPTS, BUDGETS)]
    _near_tie_identical(setup, jax_ref["a2"], got, _jax_adapters(2))
    assert _http(runner.port, "GET", "/nope")[0] == 404

    class Broken:
        def predict(self, input_json):
            raise RuntimeError("device lost")

    broken = FedMLInferenceRunner(Broken(), port=0).start()
    try:
        code, payload, _ = _http(broken.port, "POST", "/predict",
                                 {"tokens": [1]})
        assert code == 500 and "device lost" in payload
    finally:
        broken.stop()


def test_http_chaos_replica_kill_cuts_the_stream(served):
    """A replica scheduled to die after its 2nd streamed token stops
    mid-stream: two token events, no `done`, and the socket is gone."""
    pred, _ = served
    runner = FedMLInferenceRunner(
        pred, port=0, chaos=FaultSpec(replica_kill={0: 2})).start()
    try:
        _code, payload, _ = _http(runner.port, "POST", "/predict",
                                  {"tokens": PROMPTS[3], "max_new_tokens": 6,
                                   "stream": True})
        events = _sse_events(payload)
    except (http.client.HTTPException, ConnectionError):
        events = []       # severed before the body was read
    assert runner._killed
    assert len(events) <= 2 and not any("done" in e for e in events)
    with pytest.raises(OSError):
        _http(runner.port, "GET", "/ready")


# ------------------------------------------------------ knobs and config
KNOB_CASES = [
    {}, {"decode_slots": 2}, {"decode_slots": -1}, {"decode_slots": True},
    {"decode_slots": 2.5}, {"bogus": 1}, {"kv_page_size": 4},
    {"decode_slots": 2, "kv_page_size": 4, "kv_n_pages": 9,
     "prefill_chunk": 4, "prefix_cache": False, "paged_kernel": True,
     "spec_decode": "ngram", "spec_k": 3, "kv_quant": "int8",
     "admit_batch": 2},
    {"decode_slots": 2, "prefill_chunk": 4},
    {"decode_slots": 2, "kv_page_size": 4, "spec_decode": False},
    {"decode_slots": 2, "kv_page_size": 4, "spec_decode": True},
    {"decode_slots": 2, "kv_page_size": 4, "spec_decode": "beam"},
    {"decode_slots": 2, "spec_decode": "ngram"}, {"spec_k": 3},
    {"decode_slots": 2, "kv_page_size": 4, "kv_quant": False},
    {"decode_slots": 2, "kv_page_size": 4, "kv_quant": "fp8"},
    {"decode_slots": 2, "kv_quant": "int8"}, {"admit_batch": 2},
    {"engine_mp": 2}, {"decode_slots": 2, "paged_kernel": True},
    {"decode_slots": 2, "kv_page_size": 4, "affinity_routing": True},
    {"decode_slots": 2, "kv_page_size": 4, "prefix_cache": False,
     "affinity_routing": True},
    {"drain_timeout_s": -1}, {"retry_after_s": 0}, {"shed_watermark": "x"},
    {"kv_cache": "yes"}, {"engine_eos_id": -1},
]


@pytest.mark.parametrize("knobs", KNOB_CASES, ids=[str(k) for k in
                                                   KNOB_CASES])
def test_validate_serve_args_as_jax(knobs):
    """Accepted and refused on the same dicts as the JAX registry, with
    the same messages and the same normalization."""
    mine, theirs = dict(knobs), dict(knobs)
    try:
        jax_validate(theirs)
        want = None
    except ValueError as e:
        want = str(e)
    try:
        validate_serve_args(mine)
        got = None
    except ValueError as e:
        got = str(e)
    assert got == want
    assert mine == theirs
    if want is not None:
        with pytest.raises(ValueError):
            Config.from_dict({"serve_args": dict(knobs)})


def test_lm_predictor_from_config(setup, jax_ref):
    """The config route maps every engine knob; both packages' configs
    accept it (and its `serve` alias)."""
    knobs = {"decode_slots": 2, "engine_max_len": MAXLEN,
             "kv_page_size": PS, "kv_n_pages": 20, "prefill_chunk": 4,
             "paged_kernel": True, "spec_decode": "ngram", "spec_k": 2,
             "admit_batch": 2, "engine_fetch_chunk": 1,
             "drain_timeout_s": 5.0}
    JaxConfig.from_dict({"serve": dict(knobs)})
    cfg = Config.from_dict({"serve": dict(knobs)})
    pred = serving.lm_predictor_from_config(cfg, setup[2], device="cpu")
    try:
        eng = pred.engine
        assert (eng.n_slots, eng.max_len, eng.kv_page_size, eng._n_pages,
                eng._prefill_chunk, eng._kernel_on, eng._spec_on,
                eng._spec_k, eng._admit_batch, eng._quant,
                eng.fetch_chunk) == (2, MAXLEN, PS, 20, 4, True, True, 2, 2,
                                     False, 1)
        assert pred.drain_timeout_s == 5.0
        got = _predict_all(pred, PROMPTS[:3], BUDGETS[:3])
    finally:
        pred.stop()
    _near_tie_identical(setup, jax_ref["base"][:3], got, prompts=PROMPTS[:3])
    int8 = serving.lm_predictor_from_config(Config.from_dict(
        {"serve_args": {"decode_slots": 1, "kv_page_size": PS,
                        "kv_quant": "int8"}}), setup[2], device="cpu")
    assert int8.engine._quant and int8.max_len == 256
    int8.stop()


# ---------------------------------------- classifier, simulator, checkpoint
def test_torch_predictor_matches_jax_predictor():
    fj = jax_hub.MLP(10)
    fparams = jax.tree.map(np.asarray, jax.jit(
        lambda k: jax_hub.init_params(fj, (8, 8, 1), k))(jax.random.key(1)))
    module = hub.MLP(10, (8, 8, 1), device="cpu")
    mine = TorchPredictor(hub.apply_fn(module),
                          hub.params_from_flax(fparams, device="cpu"),
                          device="cpu")
    theirs = JaxPredictor(fj.apply, fparams)
    x = np.random.RandomState(0).randn(3, 8, 8, 1).astype(np.float32)
    a, b = mine.predict({"inputs": x.tolist()}), theirs.predict(
        {"inputs": x.tolist()})
    assert a["predictions"] == b["predictions"]
    np.testing.assert_allclose(a["probabilities"], b["probabilities"],
                               atol=2e-6)
    with pytest.raises(InvalidRequest, match="rectangular"):
        mine.predict({"inputs": [[1.0], [1.0, 2.0]]})


def test_torch_predictor_concurrent_predicts():
    """Eight threads predicting at once over one module (an HTTP replica's
    request threads) all get the single-thread answer: `hub.apply_fn`
    swaps the parameters into the module for the length of a call, so
    unlocked calls see each other's restore (the module's own tensors
    live on "meta") and raise."""
    import sys

    module = hub.create("lr", 3, (4,), device="meta")
    params = hub.init_params(module, torch.Generator().manual_seed(0))
    pred = TorchPredictor(hub.apply_fn(module), params, device="cpu")
    x = np.random.RandomState(0).randn(5, 4).astype(np.float32).tolist()
    want = pred.predict({"inputs": x})
    errors, got = [], []

    def hammer():
        try:
            for _ in range(25):
                got.append(pred.predict({"inputs": x}))
        except Exception as e:  # noqa: BLE001 — counted below
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert len(got) == 8 * 25 and all(g == want for g in got)


def test_serve_simulator_and_checkpoint(tmp_path):
    d = {"data_args": {"dataset": "synthetic",
                       "data_cache_dir": str(tmp_path / "data"),
                       "extra": {"synthetic_samples_per_client": 16}},
         "model_args": {"model": "lr"},
         "train_args": {"client_num_in_total": 4, "client_num_per_round": 2,
                        "comm_round": 1, "batch_size": 8}}
    sim = Simulator(fedml_tpu_torch.init(config=d, device="cpu"))
    sim.run(1)
    sim.save(str(tmp_path / "ckpt"))
    x = sim.dataset.x_test[:5].astype(np.float32)
    with torch.no_grad():
        want = sim.apply_fn(sim.server_state.params,
                            torch.from_numpy(x)).argmax(-1).tolist()
    runner = serving.serve_simulator(sim, port=0, device="cpu")
    try:
        code, payload, _ = _http(runner.port, "POST", "/predict",
                                 {"inputs": x.tolist()})
    finally:
        runner.stop()
    assert code == 200 and json.loads(payload)["predictions"] == want
    pred = serving.predictor_from_checkpoint(
        str(tmp_path / "ckpt"), sim.apply_fn, sim._server_dict(),
        device="cpu")
    assert pred.predict({"inputs": x.tolist()})["predictions"] == want
    # the round's model published to the artifact store serves the same
    from fedml_tpu_torch.utils.artifacts import (
        FileArtifactStore, aggregated_name,
    )

    store = FileArtifactStore(str(tmp_path / "arts"))
    store.put(aggregated_name(0), sim.server_state.params)
    pred = serving.predictor_from_artifact(store, 0, sim.apply_fn,
                                           device="cpu")
    assert pred.predict({"inputs": x.tolist()})["predictions"] == want
    with pytest.raises(KeyError):
        serving.predictor_from_artifact(store, 1, sim.apply_fn,
                                        device="cpu")


def test_entry_points_default_to_cuda(setup, monkeypatch, tmp_path):
    """Without device=, every serving entry point asks for CUDA and raises
    where no GPU is visible; nothing falls back to the CPU."""
    model = setup[2]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config.from_dict({"serve_args": {"decode_slots": 2}})

    class Sim:
        apply_fn = None
        server_state = type("S", (), {"params": {}})()

    calls = [lambda: GreedyLMPredictor(model, max_len=MAXLEN),
             lambda: TorchPredictor(lambda p, x: x, {}),
             lambda: serving.lm_predictor_from_config(cfg, model),
             lambda: serving.serve_simulator(Sim(), port=0),
             lambda: serving.predictor_from_artifact(None, 0, None),
             lambda: serving.predictor_from_checkpoint(str(tmp_path),
                                                       None, {})]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
