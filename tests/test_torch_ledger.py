"""The cost ledger (`fedml_tpu_torch/utils/xla_ledger.py`) and the one
count of kernel work (`fedml_tpu_torch/ops/cost.py`), held against the
JAX package's `utils/xla_ledger.py` where the two compute the same thing:

- `measured_mfu` on the same span summary, entries and call counts
  gives JAX's numbers and gauges;
- `register_buffers`, `set_enabled(False)` and `reset` behave as JAX's,
  and a paged engine's kv_pool entry equals the JAX engine's at the same
  dims and agrees with its own `serving.kv_bytes_per_slot` math (1%);
- captures are off until a run asks for them (`mlops.init` with tracking
  on, until `mlops.finish`), and the engine's programs are captured at
  their first call only;
- a CPU round's `round_fn` FLOPs equal `analytic_flops` of the round plus
  the kernel-count function: exactly for a model without attention, and
  for a LoRA round with flash attention as the FLOPs of the same round
  with an attention that does no product, plus 2 x K1 (the remat
  recomputes the forward) + K2 + K3 a layer a step; the dense attention
  path gives the same FLOPs and bytes (rel. 0), with clients one at a
  time and vmapped in groups of 2, and the paged engine's gather path the
  K4 path's;
- the dense attention's written-out backward gives JAX's gradients
  (jax.grad of its dense causal attention; f32, 1e-5), vmapped too;
- the cost functions give the kernel table's bound column (PERF.md §6)
  at its shapes, to the table's printed precision.
"""
import numpy as np
import pytest
import torch

from fedml_tpu.utils import metrics as jmx
from fedml_tpu.utils import xla_ledger as jl
from fedml_tpu_torch.ops import cost
from fedml_tpu_torch.utils import metrics as pmx
from fedml_tpu_torch.utils import xla_ledger as pl
from fedml_tpu_torch.utils.flops import analytic_flops

torch.set_num_threads(2)

HBM = 3.35e12


@pytest.fixture(autouse=True)
def _fresh_ledgers():
    """Both ledgers and both registries start empty, the port's captures
    on (as a tracked run has them), and the port's ledger is restored
    after."""
    pl.reset()
    pl.set_enabled(True)
    prev = pl.set_capture(True)
    pmx.registry = pmx.MetricsRegistry()
    jl.reset()
    jmx.reset()
    yield
    pl.reset()
    pl.set_enabled(True)
    pl.set_capture(prev)
    pmx.registry = pmx.MetricsRegistry()


# ------------------------------------------------------------ mfu, buffers
@pytest.mark.parametrize("peak", [None, 989e12])
def test_measured_mfu_equals_jax(peak):
    summary = {"train": {"count": 3, "total_s": 2.5},
               "eval": {"count": 3, "total_s": 0.25}}
    entries = {"round_fn": {"flops": 7.457e13, "bytes": 1e9},
               "eval_fn": {"flops": 3.1e11},
               "chunk_fn": {"flops": 0.0}}          # no flops: skipped
    calls = {"round_fn": 4, "eval_fn": 3, "chunk_fn": 2}
    with pl._lock:
        pl._programs.update({k: dict(v) for k, v in entries.items()})
    with jl._lock:
        jl._programs.update({k: dict(v) for k, v in entries.items()})
    for name, n in calls.items():
        for _ in range(n):
            pl.note_call(name)
            jl.note_call(name)
    # without a peak (the CPU) neither package claims an MFU
    port = pl.measured_mfu(summary, peak_flops_per_s=peak)
    jax_out = jl.measured_mfu(summary, peak_flops_per_s=peak)
    assert port == jax_out and set(port) == {"round_fn", "eval_fn"}
    assert (port["round_fn"]["mfu"] is None) == (peak is None)
    pg, jg = pmx.snapshot()["gauges"], jmx.snapshot()["gauges"]
    for k, v in pg.items():
        if k.startswith("xla.program."):
            assert jg[k] == v, k


def test_register_disable_reset_as_jax():
    import jax.numpy as jnp

    shapes = [((4, 8), "float32"), ((3,), "int32"), ((2, 2, 2), "bfloat16")]
    tree_p = {f"t{i}": torch.zeros(s, dtype=getattr(torch, d))
              for i, (s, d) in enumerate(shapes)}
    tree_j = {f"t{i}": jnp.zeros(s, dtype=d)
              for i, (s, d) in enumerate(shapes)}
    assert pl.register_buffers("fed_params", tree_p) == \
        jl.register_buffers("fed_params", tree_j) == 128 + 12 + 16
    assert pl.register_buffers("kv_pool", [torch.zeros(10)]) == \
        jl.register_buffers("kv_pool", [jnp.zeros(10)]) == 40
    # re-registration replaces the entry, the total follows
    pl.register_buffers("kv_pool", [torch.zeros(20)])
    jl.register_buffers("kv_pool", [jnp.zeros(20)])
    assert pl.buffers() == jl.buffers()
    pg, jg = pmx.snapshot()["gauges"], jmx.snapshot()["gauges"]
    for k in ("xla.ledger.fed_params_bytes", "xla.ledger.kv_pool_bytes",
              "xla.ledger.device_bytes"):
        assert pg[k] == jg[k], k
    # disabled: calls are not counted and nothing is captured
    pl.set_enabled(False)
    f = pl.track(lambda a: a @ a, "probe")
    f(torch.ones(4, 4))
    assert pl.programs() == {}
    assert "xla.program.calls.probe" not in pmx.snapshot()["counters"]
    pl.set_enabled(True)
    f(torch.ones(4, 4))
    f(torch.ones(4, 4))               # the same signature: no new capture
    assert pl.programs()["probe"]["flops"] == 2 * 4 ** 3
    f(torch.ones(8, 8))               # a new one: captured again
    assert pl.programs()["probe"]["flops"] == 2 * 8 ** 3
    assert pmx.snapshot()["counters"]["xla.program.calls.probe"] == 3
    assert pmx.snapshot()["gauges"]["xla.program.flops.probe"] == 1024
    pl.reset()
    jl.reset()
    assert pl.programs() == jl.programs() == {}
    assert pl.buffers() == jl.buffers() == {}


def test_captures_only_when_a_run_asks(tmp_path):
    """Off, a tracked program's calls are counted and nothing runs under
    the counters; `mlops.init` with tracking on turns captures on, and
    `mlops.finish` restores the setting."""
    import fedml_tpu_torch
    from fedml_tpu_torch import mlops

    pl.set_capture(False)
    f = pl.track(lambda a: a @ a, "probe")
    f(torch.ones(4, 4))
    assert pl.programs() == {}
    assert pmx.snapshot()["counters"]["xla.program.calls.probe"] == 1
    cfg = fedml_tpu_torch.init(config={"tracking_args": {
        "enable_tracking": True, "log_file_dir": str(tmp_path),
        "run_name": "ledger", "extra": {"sysperf_interval": 60.0}}},
        device="cpu")
    mlops.init(cfg)
    try:
        assert pl.capture_on()
        f(torch.ones(4, 4))            # the signature's first captured call
        assert pl.programs()["probe"]["flops"] == 2 * 4 ** 3
    finally:
        mlops.finish()
    assert not pl.capture_on()


# ----------------------------------------------------------- the engine
V, D, L, H, FF = 96, 64, 2, 4, 128


@pytest.fixture(scope="module")
def lm():
    import jax
    import jax.numpy as jnp

    from fedml_tpu.llm.transformer import TransformerLM as FlaxLM
    from fedml_tpu_torch.llm.transformer import (ModelDims, TransformerLM,
                                                 params_from_flax)

    fm = FlaxLM(vocab_size=V, d_model=D, n_layers=L, n_heads=H, d_ff=FF,
                scan_layers=True)
    params = jax.jit(fm.init)(jax.random.key(0),
                              jnp.zeros((1, 8), jnp.int32))["params"]
    model = TransformerLM.from_state(
        ModelDims(V, D, L, H, FF),
        params_from_flax(jax.tree.map(np.asarray, params), device="cpu"))
    return fm, params, model


def _step_entry(model, kernel):
    from fedml_tpu_torch.serving.engine import DecodeEngine

    pl.reset()
    eng = DecodeEngine(model, device="cpu", n_slots=2, max_len=32,
                       page_size=4, n_pages=20, prefill_chunk=4,
                       paged_kernel=kernel).start()
    try:
        out = eng.submit(list(range(1, 11)), 5).result(timeout=120)
    finally:
        eng.stop()
    return out, pl.programs(), pl.buffers()


def test_kv_pool_bytes_match_jax_and_engine_math(lm):
    """The paged engine's kv_pool entry: the JAX engine's at the same
    dims, and within 1% of 2 slots x serving.kv_bytes_per_slot."""
    from fedml_tpu.serving.engine import DecodeEngine as JaxEngine

    fm, params, model = lm
    _out, _progs, bufs = _step_entry(model, True)
    engine_kv = 2 * pmx.snapshot()["gauges"]["serving.kv_bytes_per_slot"]
    assert abs(bufs["kv_pool"] - engine_kv) / engine_kv <= 0.01
    JaxEngine(fm, params, n_slots=2, max_len=32, page_size=4, n_pages=20,
              prefill_chunk=4)
    assert bufs["kv_pool"] == jl.buffers()["kv_pool"]
    assert bufs["serving_params"] == sum(
        p.numel() * p.element_size() for p in model.parameters())


def test_engine_step_counts_k4_work_on_either_path(lm):
    """engine_step's FLOPs through K4's plain version (the kernel path on
    the CPU) equal the gather path's, and are the counted non-attention
    work plus `paged_cost` of each layer's call; the tokens agree."""
    _fm, _params, model = lm
    out_k, progs_k, _ = _step_entry(model, True)
    out_g, progs_g, _ = _step_entry(model, False)
    assert out_k == out_g
    for name in ("engine_step", "engine_admit"):
        assert progs_k[name]["flops"] == progs_g[name]["flops"], name
        assert progs_k[name]["bytes"] == progs_g[name]["bytes"], name
        assert progs_k[name]["attention_flops"] > 0
    # the first step: both slots' pages, the prompt of 10 at pos 10 (one
    # request, so the other slot sits at pos 0): K4 at C 1 a layer
    q = torch.zeros(2, 1, H, D // H)
    one = cost.paged_cost(q, torch.tensor([10, 0]), 4, 8, 4, False)[1]
    assert progs_k["engine_step"]["attention_flops"] == L * one


def test_engine_programs_capture_their_first_call_only(lm, monkeypatch):
    """Prefill widths are not bucketed: admissions at three prompt
    lengths and every step after them leave one capture a program."""
    from fedml_tpu_torch.serving.engine import DecodeEngine

    _fm, _params, model = lm
    seen = []
    real = pl.capture
    monkeypatch.setattr(pl, "capture", lambda name, *a: (
        seen.append(name), real(name, *a))[1])
    eng = DecodeEngine(model, device="cpu", n_slots=2, max_len=32,
                       page_size=4, n_pages=20, prefill_chunk=4).start()
    try:
        for n in (5, 9, 14):
            eng.submit(list(range(1, n + 1)), 3).result(timeout=120)
    finally:
        eng.stop()
    assert sorted(seen) == ["engine_admit", "engine_step"]
    calls = pmx.snapshot()["counters"]
    assert calls["xla.program.calls.engine_admit"] > 3
    assert calls["xla.program.calls.engine_step"] > 3


# ------------------------------------------------------------ the rounds
def _lm_round(attn, group_size=1):
    from fedml_tpu_torch.config import TrainArgs
    from fedml_tpu_torch.llm import federated_lora
    from fedml_tpu_torch.llm.transformer import (ModelDims, TransformerLM,
                                                 init_params)
    from fedml_tpu_torch.parallel.round import build_round_fn

    dims = ModelDims(vocab_size=32, d_model=32, n_layers=2, n_heads=4,
                     d_ff=64)
    state = init_params(dims, seed=0, device="cpu")
    model = TransformerLM.from_state(dims, state, attn_fn=attn, remat=True)
    alg, ads = federated_lora(model, state, TrainArgs(
        epochs=1, batch_size=4, learning_rate=0.5),
        torch.Generator().manual_seed(0), rank=4)
    return (build_round_fn(alg, group_size=group_size),
            alg.server_init(ads), dims)


LM_N, LM_S, LM_T = 4, 8, 16


def _lm_data():
    rs = np.random.RandomState(0)
    seqs = (rs.randint(0, 32, (LM_N, LM_S, 1)) + np.arange(LM_T + 1)) % 32
    return {"x": torch.from_numpy(seqs[:, :, :-1].astype(np.int64)),
            "y": torch.from_numpy(seqs[:, :, 1:].astype(np.int64)),
            "mask": torch.ones(LM_N, LM_S)}


def _round_args(st, data):
    return (st, None, data, np.arange(LM_N), np.full((LM_N,), 8.0))


@pytest.mark.parametrize("group_size", [1, 2])
def test_lora_round_flops_are_analytic_plus_kernel_count(group_size):
    from fedml_tpu_torch.ops import flash_attention as fa

    data = _lm_data()
    entries = {}
    for name, attn in (("flash", fa.flash_attn_fn), ("dense", None)):
        pl.reset()
        rf, st, dims = _lm_round(attn, group_size)
        rf(*_round_args(st, data), seed=0)
        entries[name] = pl.programs()["round_fn"]
    # the same round with an attention that does no product (its gradient
    # still reaches q, k and v), counted by analytic_flops
    rf, st, dims = _lm_round(lambda q, k, v: q + k + v, group_size)
    no_attn = analytic_flops(rf._fn, *_round_args(st, data), seed=0)
    steps = LM_N * (LM_S // 4)
    bh, dh = 4 * dims.n_heads, dims.d_model // dims.n_heads
    fwd, dq, dkv = (cost.flash_cost(k, bh, LM_T, dh, 4)[1]
                    for k in ("fwd", "dq", "dkv"))
    kernels = dims.n_layers * steps * (2 * fwd + dq + dkv)
    assert entries["flash"]["attention_flops"] == kernels
    assert entries["flash"]["flops"] == no_attn + kernels
    for field in ("flops", "bytes", "attention_flops"):
        assert entries["dense"][field] == entries["flash"][field], field


def test_vision_round_flops_equal_analytic_flops():
    """A round without attention: the ledger's round_fn FLOPs are
    analytic_flops of the same round, and eval_fn is tracked too."""
    import fedml_tpu_torch
    from fedml_tpu_torch.simulation.simulator import Simulator

    cfg = fedml_tpu_torch.init(config={
        "data_args": {"dataset": "mnist",
                      "extra": {"synthetic_samples_per_client": 16}},
        "model_args": {"model": "cnn"},
        "train_args": {"federated_optimizer": "FedAvg",
                       "client_num_in_total": 3, "client_num_per_round": 3,
                       "comm_round": 1, "epochs": 1, "batch_size": 8,
                       "learning_rate": 0.1},
        "validation_args": {"frequency_of_the_test": 1},
        "comm_args": {"backend": "sp"}}, device="cpu")
    sim = Simulator(cfg, device="cpu")
    ids, weights, batch_idx, faults = sim._round_inputs(0, None, None)
    kw = dict(seed=sim._seed(0), batch_idx=batch_idx,
              hook_state=sim.hook_state, faults=faults)
    want = analytic_flops(sim.round_fn._fn, sim.server_state,
                          sim.client_states, sim.data, ids, weights, **kw)
    sim.run_round(0, batch_idx=batch_idx)
    got = pl.programs()["round_fn"]
    assert got["flops"] == want > 0 and got["attention_flops"] == 0
    assert got["hbm_peak"] == got["hbm_args"] + got["hbm_out"] > 0
    sim.evaluate()
    assert pl.programs()["eval_fn"]["flops"] > 0
    assert pl.buffers()["fed_params"] == sum(
        v.numel() * v.element_size() for v in sim.params.values())


def test_dense_attention_backward_gives_jax_gradients():
    """`dense_causal_attention`'s written-out backward: the gradients of a
    weighted sum equal jax.grad of JAX's dense causal attention, alone
    and vmapped over a client dim (f32, 1e-5)."""
    import jax
    import jax.numpy as jnp

    from fedml_tpu.parallel.seq import dense_causal_attention as jax_dense
    from fedml_tpu_torch.parallel.seq import dense_causal_attention

    rs = np.random.RandomState(0)
    q, k, v, w = (rs.randn(3, 2, 16, 4, 8).astype(np.float32)
                  for _ in range(4))

    def jloss(q, k, v, w):
        return jnp.sum(jax_dense(q, k, v) * w)

    def ploss(q, k, v, w):
        return (dense_causal_attention(q, k, v) * w).sum()

    want = jax.vmap(jax.grad(jloss, argnums=(0, 1, 2)))(q, k, v, w)
    got = torch.func.vmap(torch.func.grad(ploss, argnums=(0, 1, 2)))(
        *map(torch.from_numpy, (q, k, v, w)))
    for g, j in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=1e-5)
    tq, tk, tv = (torch.from_numpy(x[0]).requires_grad_() for x in (q, k, v))
    ploss(tq, tk, tv, torch.from_numpy(w[0])).backward()
    for g, j in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(j)[0], atol=1e-5)


# ---------------------------------------------- the kernel table's bounds
@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 128, 0.0695), (torch.float32, 128, 0.4167),
    (torch.bfloat16, 40, 0.0217), (torch.float32, 40, 0.1302)])
def test_flash_cost_gives_the_table_bounds(dtype, d, want):
    """K1, K2 and K3 at the table's flagship shape (BH 64, T 2048) are
    bound by operations, one bound each (the backward's four products
    split two and two); `bwd` is K2 + K3."""
    es = torch.tensor([], dtype=dtype).element_size()
    for kernel in ("fwd", "dq", "dkv"):
        nbytes, flops = cost.flash_cost(kernel, 64, 2048, d, es)
        t_ops = flops / cost.peak_flops(dtype) * 1e3
        assert t_ops > nbytes / HBM * 1e3
        assert round(t_ops, 4) == want, (kernel, t_ops)
    assert cost.flash_cost("bwd", 64, 2048, d, es)[1] == 2 * flops


def test_flash_cost_d40_small_case_bytes_bound():
    """The D 40 rows' small case (BH 4, T 256) is bound by bytes:
    0.0001 ms in bf16 for each pass, 0.0002 / 0.0002 / 0.0003 in f32."""
    for es, want in ((2, (0.0001, 0.0001, 0.0001)),
                     (4, (0.0002, 0.0002, 0.0003))):
        got = tuple(round(cost.flash_cost(k, 4, 256, 40, es)[0] / HBM
                          * 1e3, 4) for k in ("fwd", "dq", "dkv"))
        assert got == want


def test_paged_cost_counts_live_pages():
    """K4: each live page's K and V slab for every head once (its scales
    with an int8 pool), q and out, the live table entries and pos; 4
    flops a (query, head, dim, live key)."""
    s, c, h, dh, ps = 3, 2, 4, 8, 16
    q = torch.zeros(s, c, h, dh, dtype=torch.bfloat16)
    pos = torch.tensor([0, 15, 40], dtype=torch.int32)
    # live pages: (0+1)//16+1 = 1, (15+1)//16+1 = 2, (40+1)//16+1 = 3
    n_live = 6
    for kv_es, scales in ((2, False), (1, True)):
        nbytes, flops = cost.paged_cost(q, pos, ps, 8, kv_es, scales)
        slab = ps * h * dh * kv_es
        assert nbytes == 2 * n_live * slab + 2 * q.numel() * 2 \
            + n_live * 4 + s * 4 + (2 * n_live * h * 4 if scales else 0)
        assert flops == 4 * c * h * dh * n_live * ps
    # a table narrower than the positions caps the live count
    assert cost.paged_cost(q, pos, ps, 2, 2, False)[1] == \
        4 * c * h * dh * 5 * ps
    assert cost.peak_flops(torch.float32) == 495e12 / 3
    assert cost.peak_flops(torch.bfloat16) == 989e12
