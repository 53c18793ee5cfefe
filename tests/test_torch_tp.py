"""Tensor parallelism's rule tables and Megatron forward / train step
(`fedml_tpu_torch.parallel.partition`, `llm/tp.py`) against the JAX
package's, on the CPU.

The table checks run in this process on flax trees and the port's state
dicts. The rank cases run SPMD in 4 gloo ranks (`parallel/launch.
RankPool`), spawned once for the module by the `runs` fixture, which
checks they all exit 0; the ranks import no JAX (`torch_tp_ranks.py`).
The JAX side runs unsharded on the CPU; parameters go to the ranks
through `params_from_flax`, and the ranks cut them with the registry.

Bars (JAX's own, tests/test_tp.py and tests/test_partition.py):
- the resolved tables (flax unrolled, flax stacked int8 {q, s}, the
  port's state dict, float and int8) equal JAX's specs bitwise, name by
  name, and `explain` prints JAX's table word for word;
- the TP forward over (dp 1, tp 2) and (dp 2, tp 2), float, with
  replicated LoRA adapters, and over the int8 base, within rtol / atol
  2e-5 of JAX's unsharded forward;
- three TP train steps over (dp 1, tp 2): each loss within 1e-5 and the
  parameters within 2e-5 of JAX's unsharded SGD steps.
"""
import os
import sys

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    import optax

    from fedml_tpu.llm import tp as jax_tp
    from fedml_tpu.llm.lora import lora_init as jax_lora_init
    from fedml_tpu.llm.lora import lora_merge as jax_lora_merge
    from fedml_tpu.llm.quant import dequantize_tree as jax_dequantize
    from fedml_tpu.llm.quant import quantize_tree_int8 as jax_quantize
    from fedml_tpu.llm.transformer import TransformerLM as FlaxLM
    from fedml_tpu.parallel import partition as jax_part
except ModuleNotFoundError:
    pass

from fedml_tpu_torch.llm import tp
from fedml_tpu_torch.llm.lora import adapters_from_jax
from fedml_tpu_torch.llm.quant import quantize_tree_int8
from fedml_tpu_torch.llm.transformer import params_from_flax
from fedml_tpu_torch.parallel import partition
from fedml_tpu_torch.parallel.launch import RankPool
from fedml_tpu_torch.parallel.partition import P

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_tp_ranks as ranks  # noqa: E402

torch.set_num_threads(2)

V, D, L, H, FF, T = 96, 64, 2, 4, 128, 16
DIMS = dict(vocab_size=V, d_model=D, n_layers=L, n_heads=H, d_ff=FF)
TP2 = (("dp", 1), ("tp", 2))
DP2TP2 = (("dp", 2), ("tp", 2))


def _flax(scan=False, seed=0):
    model = FlaxLM(**DIMS, scan_layers=scan)
    return model, model.init(jax.random.key(seed),
                             jnp.zeros((1, T), jnp.int32))["params"]


def _np_state(state):
    return {k: ({kk: vv.numpy() for kk, vv in v.items()}
                if isinstance(v, dict) else v.numpy())
            for k, v in state.items()}


def _toks(n=8, seed=0):
    rs = np.random.RandomState(seed)
    seqs = (rs.randint(0, V, (n, 1)) + np.arange(T + 1)) % V
    return seqs[:, :-1].astype(np.int64), seqs[:, 1:].astype(np.int64)


def _jax_flat_specs(specs):
    return {jax_part.path_name(p): tuple(s) for p, s in
            jax.tree_util.tree_flatten_with_path(specs)[0]}


def _port_flat_specs(specs):
    return {partition.path_name(p): tuple(s)
            for p, s in partition._flatten(specs)}


def _port_name_of(flax_name: str) -> str:
    """block_i/wq/kernel[/q] -> blocks.i.wq.kernel[/q]."""
    parts = flax_name.split("/")
    leaf = "/" + parts.pop() if parts[-1] in ("q", "s") else ""
    if parts[0].startswith("block_"):
        parts[0:1] = ["blocks", parts[0][len("block_"):]]
    return ".".join(parts) + leaf


# ------------------------------------------------------------ rule tables
@pytest.mark.parametrize("scan", [True, False], ids=["stacked", "unrolled"])
def test_int8_flax_tables_bitwise_jax(scan):
    """The flax-shaped int8 base ({q, s} leaves), stacked (the golden
    7B serving shape, 21 leaves) and unrolled, resolves to JAX's specs
    under the error policy, and so do its LoRA adapters."""
    _m, params = _flax(scan=scan)
    q = jax.tree.map(np.asarray, jax_quantize(params))
    want = _jax_flat_specs(jax_part.resolve("transformer_lm", q))
    got = _port_flat_specs(partition.resolve("transformer_lm", q))
    assert got == want
    if scan:
        assert len(got) == 21
        assert got["blocks/wq/kernel/s"] == (None, None, "mp")
        assert got["blocks/wo/kernel/s"] == ()
    ads = jax.tree.map(np.asarray, jax_lora_init(jax.random.key(1),
                                                 params, rank=4))
    assert set(_port_flat_specs(partition.resolve("lora", ads)).values()) \
        == {()}


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_port_state_names_resolve_to_jax_specs(quant):
    """The port's state dict (blocks.i.<name>.kernel, {q, s} under int8)
    resolves, under the error policy, to the spec JAX gives the same leaf
    of the unrolled flax tree; `flat_state`'s `.q` / `.s` keys too."""
    _m, params = _flax(scan=False)
    jtree = jax_quantize(params) if quant else params
    want = {_port_name_of(k): v for k, v in _jax_flat_specs(
        jax_part.resolve("transformer_lm", jtree)).items()}
    state = params_from_flax(params, device="cpu")
    if quant:
        state = quantize_tree_int8(state)
    got = _port_flat_specs(partition.resolve("transformer_lm", state))
    assert got == want
    if quant:
        from fedml_tpu_torch.llm.quant import flat_state

        flat = _port_flat_specs(partition.resolve("transformer_lm",
                                                  flat_state(state)))
        assert flat == {k.replace("/", "."): v for k, v in got.items()}


def test_unmatched_and_ambiguous_policies_as_jax():
    params = {"mystery/kernel": np.zeros((4, 4), np.float32)}
    with pytest.raises(partition.UnmatchedParamError) as e:
        partition.resolve("transformer_lm", params)
    with pytest.raises(jax_part.UnmatchedParamError) as j:
        jax_part.resolve("transformer_lm", params)
    assert str(e.value) == str(j.value)
    assert partition.resolve("transformer_lm", params,
                             on_unmatched="replicated")["mystery/kernel"] \
        == P()
    p2 = {"wq/kernel": np.zeros((8, 8), np.float32)}
    for rules in (((r"wq", P(None, "mp")), (r"kernel$", P("mp", None))),
                  ((r"x", P()), (r"x", P("mp"))),
                  ((r"kernel", P(None, None, None, "mp")),),
                  ((r"(", P()),)):
        jrules = tuple((r, jax.sharding.PartitionSpec(*s)) for r, s in rules)
        with pytest.raises(partition.PartitionRuleError) as e:
            partition.match_partition_rules(rules, p2)
        with pytest.raises(jax_part.PartitionRuleError) as j:
            jax_part.match_partition_rules(jrules, p2)
        assert str(e.value) == str(j.value)
        assert type(e.value).__name__ == type(j.value).__name__


@pytest.mark.parametrize("table", ["transformer_lm", "mlp_cnn", "lora"])
def test_explain_word_for_word(table):
    _m, params = _flax(scan=True)
    q = jax.tree.map(np.asarray, jax_quantize(params))
    kw = {} if table == "transformer_lm" else {"on_unmatched": "replicated"}
    assert partition.explain(table, q, **kw) == jax_part.explain(table, q,
                                                                 **kw)
    assert partition.rules_for(table, "mp")
    with pytest.raises(partition.PartitionRuleError) as e:
        partition.rules_for("transfomer")
    with pytest.raises(jax_part.PartitionRuleError) as j:
        jax_part.rules_for("transfomer")
    assert str(e.value) == str(j.value)


def test_kv_specs_and_table_pick_as_jax():
    for fn in ("kv_cache_spec", "paged_kv_cache_spec",
               "paged_kv_scale_spec"):
        assert tuple(getattr(partition, fn)("mp")) == \
            tuple(getattr(jax_part, fn)("mp"))
    from fedml_tpu_torch.llm.transformer import ModelDims, TransformerLM
    from fedml_tpu_torch.models import hub

    assert partition.table_for_model(TransformerLM(
        ModelDims(**DIMS), device="meta")) == "transformer_lm"
    assert partition.table_for_model(hub.create(
        "cnn", 10, (28, 28, 1), device="meta")) == "mlp_cnn"


def test_tp_shim_delegates_to_registry():
    _m, params = _flax(scan=False)
    p = jax.tree.map(np.asarray, params)
    old = _port_flat_specs(tp.tp_param_specs(p))
    assert old == _jax_flat_specs(jax_tp.tp_param_specs(params))
    assert old == _port_flat_specs(partition.resolve("transformer_lm", p,
                                                     axis="tp"))
    assert tp.tp_param_specs({"odd/leaf": np.zeros((3, 3))})["odd/leaf"] \
        == P()
    assert "DEPRECATED" in tp.tp_param_specs.__doc__


def test_train_and_serve_resolve_one_table(runs):
    """The engine's resolved table (mesh 'mp') is the registry's for the
    same state, which the centralized trainer and the round programs
    resolve too."""
    got = runs["engine_specs"]
    state = params_from_flax(_flax()[1], device="cpu")
    want = {k: tuple(v) for k, v in partition.resolve(
        "transformer_lm", state, axis="mp").items()}
    assert got == want


# --------------------------------------------------------------- the ranks
@pytest.fixture(scope="module")
def runs():
    """Every rank case in one 4-rank pool; the JAX sides beside them."""
    out = {}
    pool = RankPool(["cpu"] * 4, timeout_s=240.0)
    try:
        model, params = _flax(scan=False)
        state = _np_state(params_from_flax(params, device="cpu"))
        x, y = _toks()
        out["ref"] = np.asarray(model.apply({"params": params},
                                            jnp.asarray(x)))
        for axes in (TP2, DP2TP2):
            out[axes] = pool.run(ranks.tp_forward, {
                "dims": DIMS, "state": state, "tokens": x, "axes": axes})
        # LoRA over the TP base: adapters replicated, nonzero
        ads = jax.tree.map(lambda a: a + 0.01, jax_lora_init(
            jax.random.key(1), params, rank=4))
        out["lora_ref"] = np.asarray(model.apply(
            {"params": jax_lora_merge(params, ads)}, jnp.asarray(x)))
        pads = {k: {kk: vv.numpy() for kk, vv in v.items()} for k, v in
                adapters_from_jax(ads, device="cpu").items()}
        out["lora"] = pool.run(ranks.tp_forward, {
            "dims": DIMS, "state": state, "tokens": x, "axes": TP2,
            "adapters": pads})
        # the int8 base, stacked and converted: against JAX's dequantised
        # unsharded forward
        smodel, sparams = _flax(scan=True)
        qj = jax_quantize(sparams)
        out["q_ref"] = np.asarray(smodel.apply(
            {"params": jax_dequantize(qj, jnp.float32)}, jnp.asarray(x)))
        out["q"] = pool.run(ranks.tp_forward, {
            "dims": DIMS, "state": _np_state(params_from_flax(
                jax.tree.map(np.asarray, qj), device="cpu")),
            "tokens": x, "axes": TP2})
        # three SGD steps, JAX unsharded
        rs = np.random.RandomState(0)
        seqs = rs.randint(0, V, (8, T + 1))
        tx, ty = seqs[:, :-1], seqs[:, 1:]

        @jax.jit
        def step(p, a, b):
            def loss_fn(q):
                logits = model.apply({"params": q}, a)
                return optax.softmax_cross_entropy_with_integer_labels(
                    logits, b).mean()
            loss, g = jax.value_and_grad(loss_fn)(p)
            return jax.tree.map(lambda u, v: u - 0.1 * v, p, g), loss

        p, losses = params, []
        for _ in range(3):
            p, loss = step(p, jnp.asarray(tx), jnp.asarray(ty))
            losses.append(float(loss))
        out["train_ref"] = (losses, params_from_flax(
            jax.tree.map(np.asarray, p), device="cpu"))
        out["train"] = pool.run(ranks.tp_train, {
            "dims": DIMS, "state": state, "x": tx, "y": ty, "axes": TP2,
            "lr": 0.1, "steps": 3})
        eng = pool.run(ranks.engine, {
            "dims": DIMS, "state": state, "axes": (("mp", 2),),
            "max_len": 24, "requests": [([1, 2, 3], 2)]})
        out["engine_specs"] = eng[0]["specs"]
    finally:
        out["exitcodes"] = pool.close()
    return out


def test_ranks_exit_cleanly(runs):
    assert runs["exitcodes"] == [0, 0, 0, 0]


@pytest.mark.parametrize("axes", [TP2, DP2TP2], ids=["tp2", "dp2_tp2"])
def test_tp_forward_matches_jax_unsharded(runs, axes):
    got = runs[axes]
    for o in got:
        if o is not None:
            np.testing.assert_allclose(o, runs["ref"], rtol=2e-5, atol=2e-5)
    assert all(o is not None for o in got[:2])


def test_tp_base_with_replicated_lora_adapters(runs):
    for o in runs["lora"][:2]:
        np.testing.assert_allclose(o, runs["lora_ref"], rtol=2e-5,
                                   atol=2e-5)


def test_tp_int8_stacked_base_matches_jax(runs):
    for o in runs["q"][:2]:
        np.testing.assert_allclose(o, runs["q_ref"], rtol=2e-5, atol=2e-5)


def test_mesh_train_step_matches_unsharded(runs):
    losses, want = runs["train_ref"]
    for got_losses, params in runs["train"][:2]:
        np.testing.assert_allclose(got_losses, losses, rtol=1e-5, atol=1e-5)
        assert params.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_allclose(params[k], v.numpy(), rtol=2e-5,
                                       atol=2e-5, err_msg=k)
    assert losses[-1] < losses[0]


def test_shard_params_cuts_local_blocks():
    """`shard_params` keeps the rank's contiguous block of each split dim
    (a one-rank mesh keeps everything) and refuses a mesh without the
    axis with JAX's words."""
    from fedml_tpu_torch.parallel.launch import local_world
    from fedml_tpu_torch.parallel.mesh import make_mesh

    state = params_from_flax(_flax()[1], device="cpu")
    with local_world("gloo", "cpu"):
        m = make_mesh({"mp": 1})
        sh = partition.shard_params(state, m)
        assert all(torch.equal(sh[k], v) for k, v in state.items())
        with pytest.raises(partition.PartitionRuleError) as e:
            partition.shard_params(state, make_mesh({"dp": 1}))
    jm = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("dp",))
    with pytest.raises(jax_part.PartitionRuleError) as j:
        jax_part.shard_params(_flax()[1], jm)
    assert str(e.value) == str(j.value)


def test_partition_rules_smoke_probe():
    """The diagnosis battery's probe: both layouts of the int8 base and
    its adapters resolve under the error policy, then two spawned gloo
    ranks hold wq's column half and wo's row half."""
    from fedml_tpu_torch.diagnosis import (
        REQUIRED, probe_partition_rules_smoke,
    )

    out = probe_partition_rules_smoke(torch.device("cpu"))
    assert out["resolved_scan_params"] == 21
    assert out["wq_spec"] == "PartitionSpec(None, None, 'mp')"
    assert out["exitcodes"] == [0, 0]
    assert "partition_rules_smoke" in REQUIRED
