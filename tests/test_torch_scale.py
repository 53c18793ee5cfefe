"""The scaled FedLLM step and the sharded base checkpoint
(`fedml_tpu_torch.llm.scale`) against the JAX package's, on the CPU.

The port's side runs SPMD in 4 gloo ranks (`parallel/launch.RankPool`),
spawned once for the module by the `runs` fixture, which checks they all
exit 0; the ranks import no JAX (`torch_tp_ranks.py`). The JAX side runs
`build_scaled_fedllm` on the conftest's CPU devices; its base and
adapters go to the ranks (`params_from_flax`, `adapters_from_jax`) as
`base=` / `adapters=` injections, since the port cannot reproduce flax's
init draws.

Bars:
- float base over (dp 1, tp 2, seq 2), f32: the first loss within 1e-3
  of JAX's dense reference (the same base and adapters through
  `lora_apply_fn`, dense attention, no mesh: JAX's own bar,
  tests/test_fedllm_scale.py:27-56), and every loss of 9 steps within
  rtol 1e-5 of JAX's scaled step on the same mesh, base and tokens; the
  loss falls;
- the int8 base in the stacked layout over (tp 2, seq 2), f32 compute:
  every loss of 4 steps within rtol 1e-5 of JAX's in-scan step;
- the sharded base checkpoint, float and int8, round-trips bit for bit,
  and a checkpoint of one layout is refused on another;
- JAX's refusals, word for word: an absent axis name for the ring
  attention, scan layers with the seq axis over a float base.
"""
import os
import sys

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from fedml_tpu.llm.lora import lora_apply_fn as jax_lora_apply
    from fedml_tpu.llm.scale import build_scaled_fedllm as jax_build
    from fedml_tpu.llm.scale import make_ring_attn_fn as jax_ring
    from fedml_tpu.llm.transformer import TransformerLM as FlaxLM
    from fedml_tpu.parallel.mesh import make_mesh as jax_make_mesh
except ModuleNotFoundError:
    pass

from fedml_tpu_torch.llm import scale
from fedml_tpu_torch.llm.lora import adapters_from_jax
from fedml_tpu_torch.llm.quant import quant_bytes
from fedml_tpu_torch.llm.transformer import TransformerLM, params_from_flax
from fedml_tpu_torch.parallel.launch import RankPool, local_world
from fedml_tpu_torch.parallel.mesh import make_mesh

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_tp_ranks as ranks  # noqa: E402

torch.set_num_threads(2)

VOCAB, D, L, H, FF, T = 64, 32, 2, 4, 64, 16
DIMS = dict(vocab_size=VOCAB, d_model=D, n_layers=L, n_heads=H, d_ff=FF)
QDIMS = dict(vocab_size=VOCAB, d_model=64, n_layers=2, n_heads=4, d_ff=128)
MESH = (("dp", 1), ("tp", 2), ("seq", 2))
QMESH = (("tp", 2), ("seq", 2))
STEPS, QSTEPS = 9, 4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _state_np(state):
    return {k: ({kk: vv.numpy() for kk, vv in v.items()}
                if isinstance(v, dict) else v.numpy())
            for k, v in state.items()}


def _ads_np(ads):
    return {k: {c: t.numpy() for c, t in ab.items()}
            for k, ab in adapters_from_jax(ads, device="cpu").items()}


def _tokens():
    rs = np.random.RandomState(0)
    seqs = (rs.randint(0, VOCAB, (4, 1)) + np.arange(T + 1)) % VOCAB
    return seqs[:, :-1].astype(np.int64), seqs[:, 1:].astype(np.int64)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    x, y = _tokens()
    pool = RankPool(["cpu"] * 4, timeout_s=240.0)
    try:
        # float base: JAX's scaled step, its dense reference, the port's
        mesh = jax_make_mesh(dict(MESH), devices=jax.devices()[:4])
        _m, base, ads, step = jax_build(
            FlaxLM, mesh, rank=4, lr=0.5, compute_dtype="float32", **DIMS)
        dense = FlaxLM(**DIMS)
        logits = jax_lora_apply(dense.apply, jax.device_get(base))(
            {"params": ads}, jnp.asarray(x))
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
        out["dense_ref"] = float(-jnp.take_along_axis(
            logp, jnp.asarray(y)[..., None], -1).mean())
        losses, a = [], ads
        for _ in range(STEPS):
            a, loss = step(a, jnp.asarray(x), jnp.asarray(y))
            losses.append(float(loss))
        out["jax"] = losses
        out["port"] = pool.run(ranks.scaled, {
            "dims": DIMS, "axes": MESH, "lr": 0.5, "steps": STEPS,
            "base": _state_np(params_from_flax(_np(base), device="cpu")),
            "adapters": _ads_np(_np(ads)), "x": x, "y": y})
        # int8 stacked base, in-scan over (tp 2, seq 2)
        qmesh = jax_make_mesh(dict(QMESH), devices=jax.devices()[:4])
        _m, qbase, qads, qstep = jax_build(
            FlaxLM, qmesh, rank=4, lr=0.5, compute_dtype="float32",
            dp_axis=None, scan_layers=True, quantize_base=True, **QDIMS)
        losses, a = [], qads
        for _ in range(QSTEPS):
            a, loss = qstep(a, jnp.asarray(x), jnp.asarray(y))
            losses.append(float(loss))
        out["jax_q"] = losses
        out["q_full_bytes"] = quant_bytes(params_from_flax(_np(qbase),
                                                           device="cpu"))
        out["port_q"] = pool.run(ranks.scaled, {
            "dims": QDIMS, "axes": QMESH, "lr": 0.5, "steps": QSTEPS,
            "quant": True, "scan": True, "dp_axis": None,
            "base": _state_np(params_from_flax(_np(qbase), device="cpu")),
            "adapters": _ads_np(_np(qads)), "x": x, "y": y})
        # sharded checkpoints, float and int8
        for quant in (False, True):
            path = str(tmp_path_factory.mktemp("ckpt") / "base")
            out[("ckpt", quant)] = pool.run(ranks.checkpoint, {
                "dims": QDIMS, "axes": (("dp", 2), ("tp", 2)),
                "other_axes": (("tp", 4),), "path": path, "quant": quant})
        ring = {"seq": {"seq_axis": "sq"}, "dp": {"dp_axis": "data"},
                "tp": {"tp_axis": "model"}}
        out["errors"] = pool.run(ranks.scale_errors, {
            "axes": MESH, "ring": ring, "dims": DIMS})
        out["jax_errors"] = {}
        for key, kw in ring.items():
            with pytest.raises(ValueError) as e:
                jax_ring(mesh, **kw)
            out["jax_errors"][key] = str(e.value)
        with pytest.raises(ValueError) as e:
            jax_build(FlaxLM, mesh, scan_layers=True, **DIMS)
        out["jax_errors"]["scan"] = str(e.value)
    finally:
        out["exitcodes"] = pool.close()
    return out


def test_ranks_exit_cleanly(runs):
    assert runs["exitcodes"] == [0, 0, 0, 0]


def test_scaled_step_matches_dense_and_jax(runs):
    for o in runs["port"]:
        assert abs(o["losses"][0] - runs["dense_ref"]) < 1e-3
        np.testing.assert_allclose(o["losses"], runs["jax"], rtol=1e-5)
        assert o["losses"][-1] < o["losses"][0]
    # every rank ends on the same adapters, bit for bit
    first = runs["port"][0]["adapters"]
    for o in runs["port"][1:]:
        for k, ab in o["adapters"].items():
            for c in ("a", "b"):
                np.testing.assert_array_equal(ab[c], first[k][c])


def test_int8_inscan_step_matches_jax(runs):
    for o in runs["port_q"]:
        np.testing.assert_allclose(o["losses"], runs["jax_q"], rtol=1e-5)
    # the rank holds half of each split weight and the whole of the
    # replicated leaves: about half of the whole base
    for o in runs["port_q"]:
        assert 0.5 * runs["q_full_bytes"] <= o["base_bytes"] \
            < 0.6 * runs["q_full_bytes"]


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_base_sharded_checkpoint_roundtrip(runs, quant):
    outs = runs[("ckpt", quant)]
    assert all(o["same"] for o in outs)
    for o in outs:
        assert o["refusal"] is not None
        assert "restore only onto the layout" in o["refusal"]
    wq = outs[0]["shapes"]["blocks.0.wq.kernel" + (".q" if quant else "")]
    assert wq == (QDIMS["d_model"], QDIMS["d_model"] // 2)


@pytest.mark.parametrize("key", ["seq", "dp", "tp", "scan"])
def test_refusals_word_for_word(runs, key):
    for o in runs["errors"]:
        assert o[key] == runs["jax_errors"][key]


def test_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """Without a GPU the scaled builder, the shard init and the checkpoint
    restore raise instead of running on the CPU."""
    with local_world("gloo", "cpu"):
        m = make_mesh({"tp": 1})
        base = scale.init_base_shard(TransformerLM(
            scale.ModelDims(**DIMS), device="meta").dims, m, "tp",
            device="cpu")
        scale.save_base_sharded(str(tmp_path / "b"), base, m)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no GPU"):
            scale.build_scaled_fedllm(TransformerLM, m, seq_axis=None,
                                      **DIMS)
        with pytest.raises(RuntimeError, match="no GPU"):
            scale.init_base_shard(scale.ModelDims(**DIMS), m, "tp")
        with pytest.raises(RuntimeError, match="no GPU"):
            scale.restore_base_sharded(str(tmp_path / "b"), base, m)
