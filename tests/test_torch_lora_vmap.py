"""Vmapped LoRA clients: the FedLLM LoRA round in groups of G clients
(`build_round_fn(group_size=G)` over `federated_lora`) against the JAX
package's, and the torch.func rules under it (the flash attention's vmap
rule, the per-block remat).

The setting is test_torch_fedllm.py's (tests/test_fedllm.py's
`_lm_task`: vocab 32, d_model 32, 2 layers, 4 heads, d_ff 64, 4 clients
of 8 sequences of 16 tokens), flash attention and per-block remat on
both sides (JAX: Pallas interpret mode), f32, the JAX batch schedule
handed to the port.

Bars: the G = 2 and G = 4 rounds within tests/test_fedllm.py's rtol
5e-4 / atol 5e-5 of JAX's round at the same G, and train_loss too; the
flash attention under `torch.func.vmap` (forward, and the gradients of
`vmap(grad(...))`) bitwise the per-item calls on the plain path, with
one call of each pass's wrapper for the whole batch; remat on and off
bitwise the same logits, and gradients within 1e-5 relative / 1e-6 of
the largest, vmapped or not.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.config import TrainArgs as JaxTrainArgs
from fedml_tpu.core.algorithm import make_batch_indices as jax_batch_indices
from fedml_tpu.llm import federated_lora as jax_federated_lora
from fedml_tpu.llm.transformer import TransformerLM as FlaxLM
from fedml_tpu.ops.flash_attention import flash_attn_fn as jax_flash_attn_fn
from fedml_tpu.parallel.round import build_round_fn as jax_build_round_fn
from fedml_tpu_torch.config import TrainArgs
from fedml_tpu_torch.llm import federated_lora
from fedml_tpu_torch.llm.lora import adapters_from_jax, lora_init
from fedml_tpu_torch.llm.transformer import (
    ModelDims, TransformerLM, params_from_flax,
)
from fedml_tpu_torch.ops import flash_attention as fa
from fedml_tpu_torch.parallel.round import build_round_fn

torch.set_num_threads(2)

VOCAB = 32
DIMS = ModelDims(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=4,
                 d_ff=64)
N_CLIENTS, S, T = 4, 8, 16


def _lm_task():
    rs = np.random.RandomState(0)
    starts = rs.randint(0, VOCAB, (N_CLIENTS, S, 1))
    seqs = (starts + np.arange(T + 1)) % VOCAB
    return {"x": seqs[:, :, :-1].astype(np.int32),
            "y": seqs[:, :, 1:].astype(np.int32),
            "mask": np.ones((N_CLIENTS, S), np.float32)}


def _flax_lm(**kw):
    return FlaxLM(vocab_size=VOCAB, d_model=DIMS.d_model,
                  n_layers=DIMS.n_layers, n_heads=DIMS.n_heads,
                  d_ff=DIMS.d_ff, **kw)


@pytest.fixture(scope="module")
def base():
    params = _flax_lm().init(jax.random.key(0),
                             jnp.zeros((1, T), jnp.int32))["params"]
    return params, params_from_flax(params, device="cpu")


def _port_model(state, remat=True):
    return TransformerLM.from_state(DIMS, state, attn_fn=fa.flash_attn_fn,
                                    remat=remat)


@pytest.mark.parametrize("group", [2, 4])
def test_grouped_round_matches_jax(base, group):
    params, state = base
    kw = dict(epochs=1, batch_size=4, learning_rate=0.5, momentum=0.9)
    alg_j, ads_j = jax_federated_lora(
        _flax_lm(attn_fn=jax_flash_attn_fn, remat=True), params,
        JaxTrainArgs(**kw), jax.random.key(1), rank=4)
    alg_t, _ = federated_lora(_port_model(state), state, TrainArgs(**kw),
                              torch.Generator().manual_seed(0), rank=4)
    assert alg_t.vmap_ok
    data = _lm_task()
    ids = np.arange(N_CLIENTS)
    weights = np.array([8.0, 6.0, 8.0, 4.0], np.float32)
    rng = jax.random.key(2)
    sched = [torch.from_numpy(np.asarray(jax_batch_indices(
        jax.random.fold_in(rng, i), S, 4, 1)).astype(np.int64)) for i in ids]
    o_j = jax_build_round_fn(alg_j, mesh=None, group_size=group)(
        alg_j.server_init(jax.tree.map(jnp.array, ads_j), None),
        jnp.zeros((N_CLIENTS,)), {k: jnp.asarray(v) for k, v in data.items()},
        jnp.asarray(ids), jnp.asarray(weights), rng, None)
    o_t = build_round_fn(alg_t, group_size=group)(
        alg_t.server_init(adapters_from_jax(ads_j, device="cpu")), None,
        {k: torch.from_numpy(v.astype(np.int64) if k != "mask" else v)
         for k, v in data.items()}, ids, weights, seed=0, batch_idx=sched)
    want = jax.tree.map(np.asarray, o_j.server_state.params)
    for k, ab in o_t.server_state.params.items():
        jk = k.replace("blocks.", "block_", 1).replace(".", "/")
        for n in ("a", "b"):
            np.testing.assert_allclose(ab[n].numpy(), want[jk][n], rtol=5e-4,
                                       atol=5e-5, err_msg=f"{k}/{n}")
    assert float(o_t.metrics["train_loss"]) == pytest.approx(
        float(o_j.metrics["train_loss"]), rel=5e-4, abs=5e-5)


def test_flash_vmap_rule_is_the_per_item_calls(monkeypatch):
    """[G, BH, T, D] through torch.func.vmap on the plain path: the
    forward and the gradients bitwise G separate calls, each pass's
    wrapper called once for the batch."""
    rs = np.random.RandomState(0)
    g, bh, t, d = 3, 4, 32, 16
    q, k, v = (torch.from_numpy(rs.randn(g, bh, t, d).astype(np.float32))
               for _ in range(3))
    w = torch.from_numpy(rs.randn(bh, t, d).astype(np.float32))
    calls = {"fwd": 0, "bwd": 0}
    for name, key in (("flash_fwd", "fwd"), ("flash_bwd", "bwd")):
        orig = getattr(fa, name)

        def counted(*a, _orig=orig, _key=key):
            calls[_key] += 1
            return _orig(*a)

        monkeypatch.setattr(fa, name, counted)

    def loss(q_, k_, v_):
        return (fa.flash_attention(q_, k_, v_) * w).sum()

    o = torch.func.vmap(fa.flash_attention)(q, k, v)
    grads = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    assert calls == {"fwd": 2, "bwd": 1}
    for i in range(g):
        assert torch.equal(o[i], fa.flash_attention(q[i], k[i], v[i]))
        one = torch.func.grad(loss, argnums=(0, 1, 2))(q[i], k[i], v[i])
        for got, want in zip(grads, one):
            assert torch.equal(got[i], want)
    # an unbatched operand is broadcast over the group
    o2 = torch.func.vmap(fa.flash_attention, in_dims=(0, None, 0))(
        q, k[0], v)
    assert torch.equal(o2[1], fa.flash_attention(q[1], k[0], v[1]))


def test_remat_on_and_off_agree(base):
    """Per-block remat recomputes the block in the backward: the logits
    are the ones without it bit for bit, and the adapter gradients, under
    torch.func.grad and under vmap(grad), within 1e-5 relative and 1e-6
    of the largest (the recompute's vjp sums a block's gradient in
    another order: read ~1e-9 on gradients of ~1e-2)."""
    _params, state = base
    ads = lora_init(state, 4, generator=torch.Generator().manual_seed(3))
    ads = {k: {"a": ab["a"], "b": ab["a"].T[:4] * 0 + 0.05}
           for k, ab in ads.items()}
    x = torch.from_numpy(_lm_task()["x"][0].astype(np.int64))
    out = {}
    for remat in (True, False):
        model = _port_model(state, remat)

        def loss(a, model=model):
            return model(x, adapters=a).square().mean()

        stacked = {k: {n: torch.stack([v, 1.5 * v]) for n, v in ab.items()}
                   for k, ab in ads.items()}
        out[remat] = (model(x, adapters=ads), torch.func.grad(loss)(ads),
                      torch.func.vmap(torch.func.grad(loss))(stacked))
    on, off = out[True], out[False]
    assert torch.equal(on[0], off[0])
    for k in ads:
        for n in ("a", "b"):
            for i in (1, 2):
                want = off[i][k][n]
                torch.testing.assert_close(
                    on[i][k][n], want, rtol=1e-5,
                    atol=1e-6 * want.abs().max().item(), msg=f"{k}/{n}")
