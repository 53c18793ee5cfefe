"""Sequence parallelism and the long-context FedLLM round
(`fedml_tpu_torch.parallel.seq`, `llm.make_fedllm_seq_round`,
`llm.shard_fedllm_data`) against the JAX package's, on the CPU.

The JAX side runs over the 8 CPU devices `conftest.py` forces; the
port's runs SPMD in 4 gloo ranks (`parallel/launch.RankPool`), spawned
once for the module by the `runs` fixture, which runs every rank case,
stops the ranks and checks they all exited 0. The ranks import no JAX
(`torch_seq_ranks.py`); the JAX side hands them its initial parameters,
adapters and batch schedules (`make_batch_indices(fold_in(rng, id))`).

Bars:
- ring and Ulysses attention over a seq-4 group, forward and the
  gradients of a weighted sum, within tests/test_fedllm.py's 2e-5 (the
  forward) and 2e-4 (gradients) of JAX's dense causal attention;
- the (silos 2, seq 2) round, ring and Ulysses, two rounds of 4 clients
  (two a silo, in sequence) with momentum, within tests/test_fedllm.py's
  rtol 5e-4 / atol 5e-5 (:178-180) of JAX's `make_fedllm_seq_round` on
  the same mesh, and its train_loss;
- `inscan_quant` over the int8 base (d_model 64, so that the size rule
  quantises the same kernels on both sides): the (silos 2, seq 2) round
  within JAX's inscan tolerance, atol 2e-4 / rtol 2e-3
  (tests/test_fedllm_scale.py:403-406), of the port's (silos 2, seq 1)
  round and of JAX's (silos 2, seq 2) round;
- JAX's errors for a bad `attn` and for Ulysses over a head count the
  seq axis does not divide, word for word; the port's for inscan_quant
  over a float base and over a base without the `blocks.{i}` layout.
"""
import os
import sys

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from fedml_tpu.config import TrainArgs as JaxTrainArgs
    from fedml_tpu.core.algorithm import ServerState as JaxServerState
    from fedml_tpu.core.algorithm import (
        make_batch_indices as jax_batch_indices,
    )
    from fedml_tpu.llm import make_fedllm_seq_round as jax_seq_round
    from fedml_tpu.llm import shard_fedllm_data as jax_shard
    from fedml_tpu.llm.lora import lora_init as jax_lora_init
    from fedml_tpu.llm.quant import quantize_tree_int8 as jax_quantize
    from fedml_tpu.llm.transformer import TransformerLM as FlaxLM
    from fedml_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from fedml_tpu.parallel.seq import dense_causal_attention as jax_dense
except ModuleNotFoundError:
    pass

from fedml_tpu_torch.parallel.launch import RankPool

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_seq_ranks as ranks  # noqa: E402

torch.set_num_threads(2)

VOCAB = 32
N_CLIENTS, S, T = 4, 8, 16
TRAIN = dict(epochs=1, batch_size=4, learning_rate=0.5, momentum=0.9,
             compute_dtype="float32")
ROUNDS = 2


def _lm_task(vocab=VOCAB):
    rs = np.random.RandomState(0)
    starts = rs.randint(0, vocab, (N_CLIENTS, S, 1))
    seqs = (starts + np.arange(T + 1)) % vocab
    return {"x": seqs[:, :, :-1].astype(np.int32),
            "y": seqs[:, :, 1:].astype(np.int32),
            "mask": np.ones((N_CLIENTS, S), np.float32)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_round(dims, attn, axes, quant=False):
    """ROUNDS rounds of JAX's seq round from adapters with random B (so
    that every factor has a gradient); the spec that replays it in the
    ranks and JAX's trained adapters and losses."""
    model = FlaxLM(**dims, scan_layers=quant)
    base = model.init(jax.random.key(0),
                      jnp.zeros((1, T), jnp.int32))["params"]
    ads = jax_lora_init(jax.random.key(1), base, rank=4)
    rs = np.random.RandomState(2)
    ads = {k: {"a": np.asarray(ab["a"]),
               "b": (0.05 * rs.randn(*ab["b"].shape)).astype(np.float32)}
           for k, ab in ads.items()}
    base_in = jax_quantize(base) if quant else base
    data = _lm_task(dims["vocab_size"])
    ids = np.arange(N_CLIENTS)
    weights = np.array([8.0, 6.0, 8.0, 4.0], np.float32)
    mesh = jax_make_mesh(dict(axes))
    rnd = jax_seq_round(model, base_in, JaxTrainArgs(**TRAIN), mesh,
                        attn=attn, inscan_quant=quant)
    hdata = jax_shard(data, mesh)
    st = JaxServerState(jax.tree.map(jnp.asarray, ads), None, jnp.int32(0),
                        None)
    scheds, losses = [], []
    for r in range(ROUNDS):
        rng = jax.random.fold_in(jax.random.key(3), r)
        scheds.append(np.stack([np.asarray(jax_batch_indices(
            jax.random.fold_in(rng, i), S, TRAIN["batch_size"], 1))
            for i in ids]).astype(np.int64))
        st, m = rnd(st, base_in, hdata, jnp.asarray(ids),
                    jnp.asarray(weights), rng)
        losses.append(float(m["train_loss"]))
    spec = {"dims": dims, "base": _np(base_in), "adapters": ads,
            "train": TRAIN, "attn": attn, "axes": axes, "data": data,
            "ids": ids, "weights": weights, "schedules": scheds,
            "quant": quant}
    return spec, _np(st.params), losses


SMALL = dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=4, d_ff=64)
QUANT = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, d_ff=256)
MESH22 = (("silos", 2), ("seq", 2))
MESH21 = (("silos", 2), ("seq", 1))


@pytest.fixture(scope="module")
def runs():
    """Every rank case in one 4-rank pool, the JAX sides beside them."""
    pool = RankPool(["cpu"] * 4, timeout_s=240.0)
    out = {"jax": {}, "port": {}}
    try:
        rs = np.random.RandomState(0)
        qkv = [rs.randn(2, 32, 4, 8).astype(np.float32) for _ in range(3)]
        w = rs.randn(2, 32, 4, 8).astype(np.float32)
        out["qkv"] = (qkv, w)
        for kind in ("ring", "ulysses"):
            out["port"][kind] = pool.run(ranks.attention, kind, *qkv, w)
        for attn in ("ring", "ulysses"):
            spec, params, losses = _jax_round(SMALL, attn, MESH22)
            out["jax"][attn] = (params, losses)
            out["port"][attn + "_round"] = pool.run(ranks.seq_round, spec)
        spec, params, losses = _jax_round(QUANT, "ring", MESH22, quant=True)
        out["jax"]["inscan"] = (params, losses)
        out["port"]["inscan"] = pool.run(ranks.seq_round, spec)
        out["port"]["inscan_seq1"] = pool.run(
            ranks.seq_round, dict(spec, axes=MESH21))
        small = FlaxLM(**SMALL).init(jax.random.key(0),
                                     jnp.zeros((1, T), jnp.int32))["params"]
        out["port"]["errors"] = pool.run(
            ranks.errors, _np(small), dict(SMALL, n_heads=2, d_model=32))
    finally:
        out["exitcodes"] = pool.close()
    return out


def test_ranks_exit_cleanly(runs):
    assert runs["exitcodes"] == [0, 0, 0, 0]


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_attention_matches_dense(runs, kind):
    (q, k, v), w = runs["qkv"]
    args = [jnp.asarray(a) for a in (q, k, v)]
    ref = np.asarray(jax_dense(*args))
    grads = jax.grad(lambda *a: (jax_dense(*a) * w).sum(),
                     argnums=(0, 1, 2))(*args)
    got = runs["port"][kind]
    out = np.concatenate([r[0] for r in got], axis=1)
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)
    for i, g in enumerate(grads):
        np.testing.assert_allclose(
            np.concatenate([r[1 + i] for r in got], axis=1), np.asarray(g),
            rtol=2e-4, atol=2e-4)


def _assert_adapters(port: dict, want: dict, rtol, atol):
    """Port adapters (per-layer keys) against a JAX tree (unrolled
    `block_i/...` or stacked `blocks/...` keys)."""
    for k, ab in port.items():
        _b, i, rest = k.split(".", 2)
        unrolled = f"block_{i}/" + rest.replace(".", "/")
        for n in ("a", "b"):
            if unrolled in want:
                ref = want[unrolled][n]
            else:
                ref = want["blocks/" + rest.replace(".", "/")][n][int(i)]
            np.testing.assert_allclose(ab[n], ref, rtol=rtol, atol=atol,
                                       err_msg=f"{k}/{n}")


@pytest.mark.parametrize("attn", ["ring", "ulysses"])
def test_seq_round_matches_jax(runs, attn):
    params, losses = runs["jax"][attn]
    outs = runs["port"][attn + "_round"]
    for o in outs:
        _assert_adapters(o["params"], params, rtol=5e-4, atol=5e-5)
        got = [m["train_loss"] for m in o["metrics"]]
        np.testing.assert_allclose(got, losses, rtol=5e-4, atol=5e-5)
        assert o["metrics"][0]["n_tokens"] == N_CLIENTS * S * T
    # every rank ends with the same adapters, bit for bit
    for o in outs[1:]:
        for k, ab in o["params"].items():
            for n in ab:
                np.testing.assert_array_equal(ab[n], outs[0]["params"][k][n])


def test_inscan_quant_round(runs):
    """The int8 base: seq 2 against seq 1 in the port, and against JAX."""
    seq2 = runs["port"]["inscan"][0]
    seq1 = runs["port"]["inscan_seq1"][0]
    assert runs["port"]["inscan_seq1"][2:] == [None, None]
    params_j, losses_j = runs["jax"]["inscan"]
    for k, ab in seq2["params"].items():
        for n in ("a", "b"):
            np.testing.assert_allclose(ab[n], seq1["params"][k][n],
                                       rtol=2e-3, atol=2e-4)
    _assert_adapters(seq2["params"], params_j, rtol=2e-3, atol=2e-4)
    for o in (seq1, seq2):
        got = [m["train_loss"] for m in o["metrics"]]
        np.testing.assert_allclose(got, losses_j, rtol=2e-3, atol=2e-4)
    moved = max(float(np.abs(ab["b"]).max())
                for ab in seq2["params"].values())
    assert moved > 0.0


def test_refusals(runs):
    errs = runs["port"]["errors"][0]
    assert all(e == errs for e in runs["port"]["errors"])
    small = FlaxLM(**SMALL).init(jax.random.key(0),
                                 jnp.zeros((1, T), jnp.int32))["params"]
    mesh = jax_make_mesh({"silos": 1, "seq": 4})
    want = {}
    for name, kw in (("attn", {"attn": "flash"}),
                     ("ulysses", {"attn": "ulysses"})):
        model = FlaxLM(**dict(SMALL, n_heads=2 if name == "ulysses" else 4))
        with pytest.raises(ValueError) as e:
            jax_seq_round(model, small, JaxTrainArgs(), mesh, **kw)
        want[name] = str(e.value)
    assert errs["attn"] == want["attn"]
    assert errs["ulysses"] == want["ulysses"]
    assert "int8 base" in errs["float_base"] and not errs["is_q"]
    assert "'blocks" in errs["layout"]
