"""The port's paged decode engine (the slice as a whole) held against the
JAX package's DecodeEngine, plus the engine's own contracts.

Identity: the port's `DecodeEngine(device="cpu", page_size=4,
prefill_chunk=4, paged_kernel=True)` serves the six prompts and budgets of
tests/test_decode_kernel_spec.py (two sharing an 8-token prefix, more
requests than slots, so admission and retirement interleave) with greedy
tokens identical to the JAX engine with the same knobs, float and int8 KV.
The comparison uses the near-tie rule: a stream may first differ only
where the JAX model's top-2 logit margin is below 1e-4 (the pinned seeds
give identical streams outright).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.llm.transformer import TransformerLM as FlaxLM
from fedml_tpu.serving.engine import DecodeEngine as JaxEngine
from fedml_tpu_torch.llm.transformer import (
    ModelDims, TransformerLM, params_from_flax,
)
from fedml_tpu_torch.serving.engine import DecodeEngine, _page_key
from fedml_tpu_torch.serving.predictor import InvalidRequest
from fedml_tpu_torch.utils import metrics as mx

torch.set_num_threads(2)

V, D, L, H, FF = 96, 64, 2, 4, 128
MAXLEN, PS = 32, 4
KNOBS = dict(n_slots=3, max_len=MAXLEN, page_size=PS, prefill_chunk=4,
             paged_kernel=True)
NEAR_TIE = 1e-4


def _prompts(ns, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, V, n).tolist() for n in ns]


SHARED = _prompts((8,), seed=9)[0]
PROMPTS = _prompts((6, 10, 8, 5)) + [SHARED + p
                                     for p in _prompts((3, 5), seed=2)]
BUDGETS = [4, 7, 5, 6, 4, 5]


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


def _wave(eng, prompts, budgets, **kw):
    tickets = [eng.submit(p, b, **kw) for p, b in zip(prompts, budgets)]
    return [t.result(timeout=120) for t in tickets]


def _assert_near_tie_identical(fm, params, prompts, want, got):
    apply = jax.jit(fm.apply)
    for prompt, a, b in zip(prompts, want, got):
        if a == b:
            continue
        j = next((k for k in range(min(len(a), len(b))) if a[k] != b[k]),
                 None)
        assert j is not None, (a, b)
        logits = np.asarray(apply({"params": params},
                                  jnp.asarray([prompt + a[:j]])))[0, -1]
        top2 = np.sort(logits)[-2:]
        margin = float(top2[1] - top2[0])
        print(f"near tie at pick {j}: top-2 margin {margin}")
        assert margin < NEAR_TIE, (j, margin, a, b)


@pytest.fixture(scope="module")
def engine(setup):
    _fm, _params, model = setup
    eng = DecodeEngine(model, device="cpu", **KNOBS).start()
    yield eng
    eng.stop()


@pytest.mark.parametrize("kv_quant", ["off", "int8"])
def test_greedy_identical_to_jax_engine(setup, kv_quant):
    fm, params, model = setup
    jeng = JaxEngine(fm, params, kv_quant=kv_quant, **KNOBS).start()
    try:
        want = _wave(jeng, PROMPTS, BUDGETS)
    finally:
        jeng.stop()
    eng = DecodeEngine(model, device="cpu", kv_quant=kv_quant,
                       **KNOBS).start()
    try:
        got = _wave(eng, PROMPTS, BUDGETS)
    finally:
        eng.stop()
    assert [len(g) for g in got] == BUDGETS
    _assert_near_tie_identical(fm, params, PROMPTS, want, got)


def test_prefix_hit_and_free_list_reclaim(engine):
    c0 = mx.snapshot()["counters"]
    first = engine.submit(SHARED + [3, 4, 5], 3).result(timeout=60)
    again = engine.submit(SHARED + [7], 4).result(timeout=60)
    c1 = mx.snapshot()["counters"]
    assert len(first) == 3 and len(again) == 4
    assert c1["serving.prefix_hits"] - c0.get("serving.prefix_hits", 0) >= 1
    assert c1["serving.prefix_hit_pages"] \
        - c0.get("serving.prefix_hit_pages", 0) >= 2
    # every page is free again or a resident prefix page nobody holds
    assert len(engine._free_pages) + len(engine._prefix) == engine._usable
    assert all(e.refs == 0 for e in engine._prefix.values())
    digest = _page_key(b"\x00", SHARED[:PS]).hex()
    assert digest in engine.prefix_digests()


def test_sampling_seeded(engine):
    prompt = _prompts((8,), seed=11)[0]
    a = engine.submit(prompt, 8, temperature=2.0, seed=7)
    b = engine.submit(prompt, 8, temperature=2.0, seed=7)
    c = engine.submit(prompt, 8, temperature=2.0, seed=8)
    a, b, c = (t.result(timeout=60) for t in (a, b, c))
    assert a == b
    assert a != c
    greedy = engine.submit(prompt, 8).result(timeout=60)
    assert engine.submit(prompt, 8, temperature=0.0,
                         seed=9).result(timeout=60) == greedy
    assert engine.submit(prompt, 8, temperature=-1.0,
                         seed=9).result(timeout=60) == greedy


def test_stream_yields_the_result(engine):
    t = engine.submit(PROMPTS[1], 6)
    assert list(t.stream(timeout=60)) == t.result(timeout=60)


def test_capacity_and_request_errors(setup, engine):
    _fm, _params, model = setup
    with pytest.raises(InvalidRequest, match="exceeds|max_len"):
        engine.submit([1] * 30, 5)
    with pytest.raises(InvalidRequest, match="at least one"):
        engine.submit([], 3)
    with pytest.raises(InvalidRequest, match=">= 1"):
        engine.submit([1, 2], 0)
    small = DecodeEngine(model, device="cpu", n_slots=2, max_len=MAXLEN,
                         page_size=PS, n_pages=5)
    assert small.admissible(10, 6) and not small.admissible(10, 7)
    msg = small.capacity_error(10, 10)
    assert "ceil(20/4) = 5" in msg and "4 usable pages" in msg
    with pytest.raises(ValueError, match="n_pages must be >= 2"):
        DecodeEngine(model, device="cpu", page_size=PS, n_pages=1)


def test_refused_knobs(setup, engine):
    """What the engine still refuses: a tensor-parallel mesh (not ported,
    naming its ROADMAP item), the paged-only knobs at page_size=0 (the JAX
    engine's gating, a ValueError), a swap on an engine built without
    adapters, and an unknown kv_quant."""
    _fm, _params, model = setup
    with pytest.raises(NotImplementedError, match="ROADMAP.*multi-GPU"):
        DecodeEngine(model, device="cpu", page_size=PS, mesh=object())
    for kw in (dict(spec_decode="ngram"), dict(admit_batch=2),
               dict(kv_quant="int8")):
        with pytest.raises(ValueError, match="page_size > 0"):
            DecodeEngine(model, device="cpu", page_size=0, **kw)
    with pytest.raises(ValueError, match="built without adapters"):
        engine.swap_adapters({})
    with pytest.raises(ValueError, match="kv_quant"):
        DecodeEngine(model, device="cpu", page_size=PS, kv_quant="fp8")


def test_default_device_is_cuda(setup, monkeypatch):
    """Without device=, the engine (and every entry point) wants a GPU and
    raises when there is none; there is no silent CPU fallback."""
    _fm, params, model = setup
    from fedml_tpu_torch.llm.transformer import init_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecodeEngine(model, page_size=PS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TransformerLM(ModelDims(V, D, L, H, FF))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(ModelDims(V, D, L, H, FF))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_flax(jax.tree.map(np.asarray, params))


def test_eos_retires_on_device(setup, engine):
    """An eos pick ends the request on the device; the ticket holds the eos
    token and nothing after it."""
    _fm, _params, model = setup
    full = engine.submit(PROMPTS[1], 7).result(timeout=60)
    eos = full[2]
    eng = DecodeEngine(model, device="cpu", eos_id=eos, **KNOBS).start()
    try:
        got = eng.submit(PROMPTS[1], 7).result(timeout=60)
    finally:
        eng.stop()
    assert got == full[:full.index(eos) + 1]


def test_drain_then_stop(setup):
    from fedml_tpu_torch.utils.events import recorder

    _fm, _params, model = setup
    eng = DecodeEngine(model, device="cpu", **KNOBS).start()
    n0 = len(recorder.spans)
    tickets = [eng.submit(p, b) for p, b in zip(PROMPTS, BUDGETS)]
    assert eng.drain(timeout_s=60) is True
    assert [len(t.result(timeout=1)) for t in tickets] == BUDGETS
    with pytest.raises(RuntimeError, match="draining"):
        eng.submit(PROMPTS[0], 1)
    eng.stop()
    assert not eng._thread.is_alive()
    with pytest.raises(RuntimeError, match="stopped"):
        eng.submit(PROMPTS[0], 1)
    names = {s.name for s in list(recorder.spans)[n0:]}
    assert {"serving.engine.admit", "serving.engine.fetch"} <= names
