"""The port's serving engine knobs held against the JAX package's
DecodeEngine: n-gram speculation (`ngram_propose` bitwise; greedy tokens
with eos inside a window and rollback across pages; spec-on equal to
spec-off inside the port, greedy and seeded), batched admission, LoRA
adapters and hot swap, the contiguous layout, and int8 KV under
speculation.

Both packages get the same flax parameters (`params_from_flax`) and the
same numpy-drawn adapters (`adapters_from_jax`). The JAX side runs its
gather path (`paged_kernel=False`); the port runs its kernel path, which
on the CPU is the kernel's plain version. Token streams are compared
under the near-tie rule: a stream may first differ only where the JAX
model's top-2 logit margin is below 1e-4 (the pinned seeds give
identical streams outright).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.llm.decode import ngram_propose as jax_ngram_propose
from fedml_tpu.llm.lora import lora_merge as jax_lora_merge
from fedml_tpu.llm.transformer import TransformerLM as FlaxLM
from fedml_tpu.serving.engine import DecodeEngine as JaxEngine
from fedml_tpu_torch.llm.decode import ngram_propose
from fedml_tpu_torch.llm.lora import adapters_from_jax
from fedml_tpu_torch.llm.transformer import (
    ModelDims, TransformerLM, params_from_flax,
)
from fedml_tpu_torch.serving.engine import DecodeEngine
from fedml_tpu_torch.utils import metrics as mx
from fedml_tpu_torch.utils.events import recorder

torch.set_num_threads(2)

V, D, L, H, FF = 96, 64, 2, 4, 128
MAXLEN, PS, RANK = 32, 4, 4
# spec_k 3 windows over 4-token pages: every window straddles a page
# boundary, so every rejection rolls the write position back across one
KNOBS = dict(n_slots=3, max_len=MAXLEN, page_size=PS, prefill_chunk=4)
SPEC = dict(spec_decode="ngram", spec_k=3)
NEAR_TIE = 1e-4


def _prompts(ns, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, V, n).tolist() for n in ns]


# acceptance-friendly (constant prompts whose continuations loop) and
# rejection-heavy (random prompts) traffic; more requests than slots
FRIENDLY = [[t] * 8 for t in (5, 40, 77)]
HOSTILE = _prompts((6, 10, 7), seed=13)
PROMPTS = FRIENDLY + HOSTILE
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


def _wave(eng, prompts, budgets, **kw):
    tickets = [eng.submit(p, b, **kw) for p, b in zip(prompts, budgets)]
    return [t.result(timeout=120) for t in tickets]


def _jax_wave(fm, params, prompts, budgets, adapters=None, **kw):
    eng = JaxEngine(fm, params, adapters, **kw).start()
    try:
        return _wave(eng, prompts, budgets)
    finally:
        eng.stop()


def _port_wave(model, prompts, budgets, adapters=None, **kw):
    eng = DecodeEngine(model, adapters, device="cpu", **kw).start()
    try:
        return _wave(eng, prompts, budgets)
    finally:
        eng.stop()


def _assert_near_tie_identical(fm, params, prompts, want, got,
                               adapters=None):
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
        margin = float(top2[1] - top2[0])
        print(f"near tie at pick {j}: top-2 margin {margin}")
        assert margin < NEAR_TIE, (j, margin, a, b)


def _counter(name):
    return mx.snapshot()["counters"].get(name, 0)


@pytest.fixture(scope="module")
def jax_plain(setup):
    fm, params, _ = setup
    return _jax_wave(fm, params, PROMPTS, BUDGETS, **KNOBS)


@pytest.fixture(scope="module")
def port_plain(setup):
    eng = DecodeEngine(setup[2], device="cpu", paged_kernel=True,
                       **KNOBS).start()
    yield eng
    eng.stop()


@pytest.fixture(scope="module")
def port_spec(setup):
    eng = DecodeEngine(setup[2], device="cpu", paged_kernel=True, **SPEC,
                       **KNOBS).start()
    yield eng
    eng.stop()


# ------------------------------------------------------------ ngram_propose
@pytest.mark.parametrize("k,w", [(1, 2), (3, 2), (4, 1), (3, 3)])
def test_ngram_propose_bitwise(k, w):
    rs = np.random.RandomState(k * 10 + w)
    hist = rs.randint(0, 4, (6, 24)).astype(np.int32)   # small vocab: repeats
    hist[5] = np.arange(24)                             # no match: fallback
    pos = np.array([0, 1, 7, 23, 12, 15], np.int32)
    want = np.asarray(jax_ngram_propose(jnp.asarray(hist), jnp.asarray(pos),
                                        k, w))
    got = ngram_propose(torch.from_numpy(hist).long(),
                        torch.from_numpy(pos), k, w)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ speculation
def test_spec_greedy_identical_and_rollback_across_pages(setup, port_spec):
    """Greedy spec-on tokens equal the JAX spec engine's on both traffic
    shapes; drafts are really accepted (the friendly lane) and really
    rejected (the hostile lane rolls the write position back across a
    page boundary)."""
    fm, params, _ = setup
    want = _jax_wave(fm, params, PROMPTS, BUDGETS, **SPEC, **KNOBS)
    p0, a0 = _counter("serving.spec.proposed"), _counter(
        "serving.spec.accepted")
    got = _wave(port_spec, PROMPTS, BUDGETS)
    prop = _counter("serving.spec.proposed") - p0
    acc = _counter("serving.spec.accepted") - a0
    assert [len(g) for g in got] == BUDGETS
    _assert_near_tie_identical(fm, params, PROMPTS, want, got)
    assert 0 < acc < prop, (acc, prop)
    # every page is free again or a resident prefix page nobody holds
    assert len(port_spec._free_pages) + len(port_spec._prefix) \
        == port_spec._usable


def test_spec_eos_inside_a_window(setup, jax_plain):
    """An eos picked mid-window stops the request at the eos token exactly
    as the JAX spec engine (and plain decode) does."""
    fm, params, model = setup
    # a friendly prompt whose plain stream first meets some token at pick
    # j >= 2: with that token as eos, the request ends inside a window
    i, j = next((i, j) for i, out in enumerate(jax_plain[:3])
                for j in range(2, len(out)) if out[j] not in out[:j])
    eos = jax_plain[i][j]
    kw = dict(n_slots=2, max_len=MAXLEN, page_size=PS, prefill_chunk=4,
              eos_id=eos, **SPEC)
    want = _jax_wave(fm, params, [PROMPTS[i]], [8], **kw)
    got = _port_wave(model, [PROMPTS[i]], [8], paged_kernel=True, **kw)
    assert got == want == [jax_plain[i][:j + 1]]


def test_spec_on_equals_spec_off_in_port(setup, port_plain, port_spec,
                                         jax_plain):
    """Inside the port, speculation changes no token: greedy, and seeded
    sampling (a window draws at the plain step's positions)."""
    fm, params, _ = setup
    off = _wave(port_plain, PROMPTS, BUDGETS)
    on = _wave(port_spec, PROMPTS, BUDGETS)
    _assert_near_tie_identical(fm, params, PROMPTS, off, on)
    _assert_near_tie_identical(fm, params, PROMPTS, jax_plain, off)
    # at temperature 0.3 sampled drafts are accepted, so the windows' draw
    # positions depend on the accepted counts; at 1.7 the seeds matter
    for temp in (0.3, 1.7):
        kw = dict(temperature=temp, seed=5)
        off_s = _wave(port_plain, PROMPTS, BUDGETS, **kw)
        a0 = _counter("serving.spec.accepted")
        on_s = _wave(port_spec, PROMPTS, BUDGETS, **kw)
        assert on_s == off_s, temp
        if temp == 0.3:
            assert _counter("serving.spec.accepted") > a0
    # the host's mirror of each sampled slot's position is the device's
    assert port_spec._host_pos == port_spec._carry["pos"].tolist()
    assert _wave(port_spec, PROMPTS, BUDGETS, temperature=1.7,
                 seed=6) != on_s


def test_int8_kv_with_spec(setup):
    """int8 KV pages under speculation: the JAX engine's tokens."""
    fm, params, model = setup
    kw = dict(kv_quant="int8", **SPEC, **KNOBS)
    want = _jax_wave(fm, params, PROMPTS, BUDGETS, **kw)
    got = _port_wave(model, PROMPTS, BUDGETS, paged_kernel=True, **kw)
    _assert_near_tie_identical(fm, params, PROMPTS, want, got)


# ------------------------------------------------------ batched admission
def test_admit_batch_identical_and_counted(setup, jax_plain):
    """admit_batch=3: the JAX engine's tokens; every chunk counted in
    serving.engine.prefill_chunks and each batch in the admit_batch
    histogram."""
    fm, params, model = setup
    want = _jax_wave(fm, params, PROMPTS, BUDGETS, admit_batch=3, **KNOBS)
    chunks = sum(-(-len(p) // 4) for p in PROMPTS)
    c0 = _counter("serving.engine.prefill_chunks")
    h0 = mx.snapshot()["histograms"].get("serving.engine.admit_batch",
                                         {"count": 0, "sum": 0})
    got = _port_wave(model, PROMPTS, BUDGETS, admit_batch=3, **KNOBS)
    h1 = mx.snapshot()["histograms"]["serving.engine.admit_batch"]
    _assert_near_tie_identical(fm, params, PROMPTS, want, got)
    _assert_near_tie_identical(fm, params, PROMPTS, jax_plain, got)
    assert _counter("serving.engine.prefill_chunks") - c0 == chunks
    assert h1["sum"] - h0["sum"] == chunks
    # three slots admit the first three prompts' chunks together
    assert h1["max"] == 3 and h1["count"] - h0["count"] < chunks


# ---------------------------------------------------------------- adapters
def test_adapters_identical_to_jax(setup):
    fm, params, model = setup
    ads = _jax_adapters(1)
    want = _jax_wave(fm, params, PROMPTS, BUDGETS, adapters=ads, **SPEC,
                     **KNOBS)
    got = _port_wave(model, PROMPTS, BUDGETS,
                     adapters=adapters_from_jax(ads, device="cpu"),
                     paged_kernel=True, **SPEC, **KNOBS)
    _assert_near_tie_identical(fm, params, PROMPTS, want, got, ads)
    base = _jax_wave(fm, params, PROMPTS, BUDGETS, **KNOBS)
    assert got != base    # the adapters change the output


def test_hot_swap_version_refusal_and_in_flight(setup):
    """A swap moves model_version 0 -> 1 (gauge and span), serves the new
    adapters (the JAX engine swapped the same way gives the same tokens),
    lets in-flight requests finish, and refuses a different layout, an
    empty set and a version that does not grow."""
    fm, params, model = setup
    a1, a2 = _jax_adapters(1), _jax_adapters(2)
    jeng = JaxEngine(fm, params, a1, **KNOBS).start()
    try:
        jeng.swap_adapters(a2)
        want = _wave(jeng, PROMPTS, BUDGETS)
    finally:
        jeng.stop()
    eng = DecodeEngine(model, adapters_from_jax(a1, device="cpu"),
                       device="cpu", paged_kernel=True, **KNOBS).start()
    try:
        assert eng.model_version == 0
        n0 = len(recorder.spans)
        tickets = [eng.submit(p, b) for p, b in zip(PROMPTS, BUDGETS)]
        # swap once the first request has its first token: its prompt
        # pages were prefilled (and registered) under a1
        next(tickets[0].stream(timeout=60))
        assert eng.swap_adapters(adapters_from_jax(a2, device="cpu")) == 1
        assert [len(t.result(timeout=120)) for t in tickets] == BUDGETS
        assert eng.model_version == 1
        assert mx.snapshot()["gauges"]["serving.model_version"] == 1
        assert "serving.swap" in {s.name for s in list(recorder.spans)[n0:]}
        # no page prefilled under a1 is hit by the a2 wave (the swap
        # dropped the prefix cache), and none leaked
        got = _wave(eng, PROMPTS, BUDGETS)
        assert len(eng._free_pages) + len(eng._prefix) == eng._usable
        bad = adapters_from_jax(a2, device="cpu")
        bad["blocks.0.wq.kernel"]["a"] = bad["blocks.0.wq.kernel"]["a"][:, :2]
        with pytest.raises(ValueError, match="shapes and dtypes"):
            eng.swap_adapters(bad)
        extra = {**adapters_from_jax(a2, device="cpu"),
                 "lm_head.kernel": {"a": torch.zeros(D, RANK),
                                    "b": torch.zeros(RANK, V)}}
        with pytest.raises(ValueError, match="structure differs"):
            eng.swap_adapters(extra)
        with pytest.raises(ValueError, match="non-empty"):
            eng.swap_adapters({})
        with pytest.raises(ValueError, match="monotonic"):
            eng.swap_adapters(adapters_from_jax(a1, device="cpu"), version=1)
        assert eng.model_version == 1
    finally:
        eng.stop()
    _assert_near_tie_identical(fm, params, PROMPTS, want, got, a2)
    with pytest.raises(ValueError, match="built without adapters"):
        DecodeEngine(model, device="cpu", **KNOBS).swap_adapters(a1)


# ------------------------------------------------------ contiguous layout
def test_contiguous_engine_identical_to_jax(setup, jax_plain):
    """page_size=0: the JAX contiguous engine's tokens (and the paged
    engine's), greedy and eos-free, with more requests than slots."""
    fm, params, model = setup
    kw = dict(n_slots=3, max_len=MAXLEN)
    want = _jax_wave(fm, params, PROMPTS, BUDGETS, **kw)
    eng = DecodeEngine(model, device="cpu", **kw).start()
    try:
        assert eng.kv_page_size == 0 and eng.prefix_digests() == []
        got = _wave(eng, PROMPTS, BUDGETS)
        assert not eng.admissible(20, 13) and eng.admissible(20, 12)
        assert "exceeds max_len 32" in eng.capacity_error(20, 13)
    finally:
        eng.stop()
    _assert_near_tie_identical(fm, params, PROMPTS, want, got)
    _assert_near_tie_identical(fm, params, PROMPTS, jax_plain, got)


@pytest.mark.parametrize("kw,msg", [
    (dict(spec_decode="ngram"), "spec_decode verifies"),
    (dict(admit_batch=2), "admit_batch groups"),
    (dict(kv_quant="int8"), "kv_quant stores"),
    (dict(paged_kernel=True), "paged_kernel fuses"),
    (dict(prefill_chunk=4), "configure the PAGED cache"),
])
def test_contiguous_refuses_paged_knobs_as_jax(setup, kw, msg):
    fm, params, model = setup
    with pytest.raises(ValueError, match=msg):
        JaxEngine(fm, params, n_slots=2, max_len=MAXLEN, **kw)
    with pytest.raises(ValueError, match=msg):
        DecodeEngine(model, device="cpu", n_slots=2, max_len=MAXLEN, **kw)
