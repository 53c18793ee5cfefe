"""The tensor-parallel DecodeEngine and the `engine_mp` predictor knob
(`fedml_tpu_torch.serving.engine`, `serving/predictor.py`) against the
JAX package, on the CPU.

The port's engines run SPMD in 2 gloo ranks (`parallel/launch.RankPool`),
spawned once for the module by the `runs` fixture, which checks they all
exit 0; the ranks import no JAX (`torch_tp_ranks.py`). Each rank decodes
its 2 of the 4 heads, K4 is the plain version on the CPU (one launch of
`paged_attention` per layer and step at H = 2 on each rank), and the
leader (rank 0) owns the queue. The JAX side is the flagship scan-layout
model of tests/test_partition.py; its parameters reach the ranks through
`params_from_flax`.

JAX's case (tests/test_partition.py:233-258): 5 requests of different
budgets through 2 slots, so admissions and retirements cross mid-flight.
Every engine (mp 1 and mp 2 over a mesh, and unmeshed) must give, in f32,
exactly the tokens of JAX's per-request path: contiguous, paged over the
kernel, with n-gram speculation (K4 at C = 5), and around a hot adapter
swap (each batch against JAX's per-request path on the merged weights of
its adapter version); over an int8 pool, exactly the tokens of JAX's
paged int8 engine. The JAX package's
own meshed-kernel test fails on this jax (ROADMAP C); nothing here is
held to it. The engine's, `shard_params`' and the config's refusals are
JAX's word for word.
"""
import os
import sys

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    import fedml_tpu
    from fedml_tpu.llm.lora import lora_init as jax_lora_init
    from fedml_tpu.llm.lora import lora_merge as jax_lora_merge
    from fedml_tpu.llm.transformer import TransformerLM as FlaxLM
    from fedml_tpu.parallel import partition as jax_part
    from fedml_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from fedml_tpu.serving.engine import DecodeEngine as JaxEngine
    from fedml_tpu.serving.predictor import GreedyLMPredictor as JaxPredictor
except ModuleNotFoundError:
    pass

import fedml_tpu_torch
from fedml_tpu_torch.llm.lora import adapters_from_jax
from fedml_tpu_torch.llm.transformer import params_from_flax
from fedml_tpu_torch.parallel.launch import RankPool

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_tp_ranks as ranks  # noqa: E402

torch.set_num_threads(2)

V, D, L, H, FF = 96, 64, 2, 4, 128
DIMS = dict(vocab_size=V, d_model=D, n_layers=L, n_heads=H, d_ff=FF)
ODD = dict(vocab_size=V, d_model=48, n_layers=1, n_heads=3, d_ff=96)
MAXLEN = 32
BUDGETS = [4, 7, 5, 6, 3]
PAGED = {"page_size": 4, "paged_kernel": True}
CASES = {
    "contiguous": {},
    "paged": PAGED,
    "int8": {**PAGED, "kv_quant": "int8"},
    "spec": {**PAGED, "spec_decode": "ngram", "spec_k": 4},
}


def _flax(dims=DIMS, scan=True, seed=0):
    model = FlaxLM(**dims, scan_layers=scan)
    return model, model.init(jax.random.key(seed),
                             jnp.zeros((1, 10), jnp.int32))["params"]


def _prompts(ns, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, V, n).tolist() for n in ns]


def _state_np(params):
    return {k: v.numpy() for k, v in params_from_flax(
        jax.tree.map(np.asarray, params), device="cpu").items()}


def _ads_np(ads):
    return {k: {c: t.numpy() for c, t in ab.items()}
            for k, ab in adapters_from_jax(ads, device="cpu").items()}


def _per_request(model, params, prompts, budgets):
    pred = JaxPredictor(model, params, max_len=MAXLEN, kv_cache=True)
    return [pred.predict({"tokens": p, "max_new_tokens": b})
            ["generated_tokens"] for p, b in zip(prompts, budgets)]


def _adapters(params, seed):
    ads = jax_lora_init(jax.random.key(seed), params, rank=4)
    rs = np.random.RandomState(seed)
    return {k: {"a": np.asarray(ab["a"]) * 20.0,
                "b": (0.2 * rs.randn(*ab["b"].shape)).astype(np.float32)}
            for k, ab in ads.items()}


@pytest.fixture(scope="module")
def runs():
    model, params = _flax()
    prompts = _prompts((6, 10, 8, 5, 7))
    reqs = list(zip(prompts, BUDGETS))
    state = _state_np(params)
    out = {"want": _per_request(model, params, prompts, BUDGETS)}
    # an int8 pool rounds K/V: its reference is JAX's int8 paged engine
    eng = JaxEngine(model, params, n_slots=2, max_len=MAXLEN, page_size=4,
                    kv_quant="int8").start()
    try:
        ts = [eng.submit(p, b) for p, b in zip(prompts, BUDGETS)]
        out["want_int8"] = [t.result(timeout=120) for t in ts]
    finally:
        eng.stop()
    v1, v2 = _adapters(params, 1), _adapters(params, 2)
    out["want_swap"] = [
        _per_request(model, jax_lora_merge(params, jax.tree.map(
            jnp.asarray, v)), prompts, BUDGETS) for v in (v1, v2)]
    pool = RankPool(["cpu"] * 2, timeout_s=240.0)
    try:
        for name, kw in CASES.items():
            for axes in (None, (("mp", 1),), (("mp", 2),)):
                if name in ("int8", "spec") and axes == (("mp", 1),):
                    continue
                out[(name, axes)] = pool.run(ranks.engine, {
                    "dims": DIMS, "state": state, "axes": axes,
                    "max_len": MAXLEN, "requests": reqs, "kw": kw})
        for axes in (None, (("mp", 2),)):
            out[("swap", axes)] = pool.run(ranks.engine, {
                "dims": DIMS, "state": state, "axes": axes,
                "max_len": MAXLEN, "requests": reqs, "kw": PAGED,
                "adapters": _ads_np(v1), "swap": _ads_np(v2)})
        _om, oparams = _flax(ODD, scan=False)
        out["refusals"] = pool.run(ranks.engine_refusals, {
            "dims": DIMS, "state": state, "odd_dims": ODD,
            "odd_state": _state_np(oparams)})
        out["predictor"] = pool.run(ranks.predictor, {
            "dims": DIMS, "state": state, "prompt": _prompts((7,))[0],
            "new": 5, "serve": {"decode_slots": 2,
                                "engine_max_len": MAXLEN, "engine_mp": 2}})
        out["want_pred"] = _per_request(model, params, _prompts((7,)), [5])
        # JAX's refusals, for the word-for-word comparison
        jm = {}
        with pytest.raises(ValueError) as e:
            JaxEngine(model, params, n_slots=1, max_len=16,
                      mesh=jax_make_mesh({"dp": 2}))
        jm["axis"] = str(e.value)
        omodel, _ = _flax(ODD, scan=False)
        with pytest.raises(ValueError) as e:
            JaxEngine(omodel, oparams, n_slots=1, max_len=16,
                      mesh=jax_make_mesh({"mp": 2}))
        jm["divisible"] = str(e.value)
        with pytest.raises(jax_part.PartitionRuleError) as e:
            jax_part.shard_params(params, jax_make_mesh({"dp": 2}),
                                  "transformer_lm")
        jm["shard"] = str(e.value)
        out["jax_refusals"] = jm
    finally:
        out["exitcodes"] = pool.close()
    return out


def test_ranks_exit_cleanly(runs):
    assert runs["exitcodes"] == [0, 0]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("axes", [None, (("mp", 1),), (("mp", 2),)],
                         ids=["unmeshed", "mp1", "mp2"])
def test_engine_token_identical_to_jax_per_request(runs, case, axes):
    if case in ("int8", "spec") and axes == (("mp", 1),):
        axes = None     # covered unmeshed and at mp 2
    leader, follower = runs[(case, axes)]
    assert leader["tokens"] == [runs["want_int8" if case == "int8"
                                     else "want"]]
    assert follower is None
    if axes == (("mp", 2),):
        assert leader["specs"]["blocks.0.wq.kernel"] == (None, "mp")


@pytest.mark.parametrize("axes", [None, (("mp", 2),)],
                         ids=["unmeshed", "mp2"])
def test_engine_hot_swap_token_identical(runs, axes):
    leader = runs[("swap", axes)][0]
    assert leader["tokens"] == runs["want_swap"]
    assert leader["version"] == 1


@pytest.mark.parametrize("key", ["axis", "divisible", "shard"])
def test_engine_mesh_refusals_word_for_word(runs, key):
    for o in runs["refusals"]:
        assert o[key] == runs["jax_refusals"][key]


def test_predictor_engine_mp_knob(runs):
    leader, follower = runs["predictor"]
    assert follower is None
    assert leader["mp"] == 2
    assert leader["out"]["generated_tokens"] == runs["want_pred"][0]


@pytest.mark.parametrize("bad", [
    {"serve": {"engine_mp": 0}}, {"serve": {"engine_mp": 2}},
    {"device_args": {"partition_rules": "transfomer"}},
    {"device_args": {"unmatched_params": "ignore"}}])
def test_config_refusals_word_for_word(bad):
    with pytest.raises(ValueError) as e:
        fedml_tpu_torch.config.Config.from_dict(bad)
    with pytest.raises(ValueError) as j:
        fedml_tpu.config.Config.from_dict(bad)
    assert str(e.value) == str(j.value)
    ok = {"device_args": {"partition_rules": "transformer_lm",
                          "unmatched_params": "error"}}
    cfg = fedml_tpu_torch.config.Config.from_dict(ok)
    assert cfg.device_args.extra["partition_rules"] == "transformer_lm"
