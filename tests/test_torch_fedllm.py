"""The port's federated LoRA training path (`fedml_tpu_torch.llm`,
`parallel.round`, `algorithms.builtin`) against the JAX package's.

The setting is tests/test_fedllm.py's `_lm_task`: vocab 32, d_model 32,
2 layers, 4 heads, d_ff 64, 4 clients with 8 sequences of 16 tokens each
(next token = token + 1). Both sides start from the same flax-drawn base
and the same JAX-drawn adapters (`params_from_flax`, `adapters_from_jax`)
and the port is handed the JAX round's batch schedule
(`make_batch_indices(fold_in(rng, id), ...)`), so the rounds compute the
same function. On the CPU the flash attention of both sides runs its
plain blocked math (JAX: Pallas interpret mode).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.config import TrainArgs as JaxTrainArgs
from fedml_tpu.core.algorithm import make_batch_indices as jax_batch_indices
from fedml_tpu.llm import federated_lora as jax_federated_lora
from fedml_tpu.llm.lora import lora_apply_fn as jax_lora_apply_fn
from fedml_tpu.llm.lora import lora_init as jax_lora_init
from fedml_tpu.llm.transformer import TransformerLM as FlaxLM
from fedml_tpu.ops.flash_attention import flash_attn_fn as jax_flash_attn_fn
from fedml_tpu.parallel.round import build_round_fn as jax_build_round_fn
from fedml_tpu_torch.config import TrainArgs
from fedml_tpu_torch.llm import (
    count_params, federated_lora, lora_init, lora_merge,
)
from fedml_tpu_torch.llm.lora import adapters_from_jax
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


def _lm_task(n_clients=N_CLIENTS, s=S, t=T, seed=0):
    """tests/test_fedllm.py:_lm_task: next token = (token + 1) mod VOCAB."""
    rs = np.random.RandomState(seed)
    starts = rs.randint(0, VOCAB, (n_clients, s, 1))
    seqs = (starts + np.arange(t + 1)) % VOCAB
    return {"x": seqs[:, :, :-1].astype(np.int32),
            "y": seqs[:, :, 1:].astype(np.int32),
            "mask": np.ones((n_clients, s), np.float32)}


def _flax_lm(**kw):
    return FlaxLM(vocab_size=VOCAB, d_model=DIMS.d_model,
                  n_layers=DIMS.n_layers, n_heads=DIMS.n_heads,
                  d_ff=DIMS.d_ff, **kw)


@pytest.fixture(scope="module")
def base():
    """(flax params, the port's state) of one base."""
    params = _flax_lm().init(jax.random.key(0),
                             jnp.zeros((1, T), jnp.int32))["params"]
    return params, params_from_flax(params, device="cpu")


def _port_model(state, flash=True):
    return TransformerLM.from_state(
        DIMS, state, attn_fn=fa.flash_attn_fn if flash else None, remat=True)


def _gen():
    return torch.Generator().manual_seed(0)


def test_lora_merge_with_zero_b_is_identity(base):
    _params, state = base
    model = _port_model(state)
    adapters = lora_init(state, rank=4, generator=_gen())
    toks = torch.from_numpy(_lm_task()["x"][0].astype(np.int64))
    want = model(toks)
    merged = _port_model(lora_merge(state, adapters))
    torch.testing.assert_close(merged(toks), want, rtol=0, atol=1e-6)
    torch.testing.assert_close(model(toks, adapters=adapters), want,
                               rtol=0, atol=1e-6)
    assert count_params(adapters) < 0.25 * count_params(state)


def test_adapter_keys_match_jax(base):
    """Port keys == adapters_from_jax of the JAX lora_init, for the
    unrolled and the scan-stacked layouts; A carried across exactly."""
    params, state = base
    mine = lora_init(state, rank=4, generator=_gen())
    theirs = jax_lora_init(jax.random.key(1), params, rank=4)
    carried = adapters_from_jax(theirs, device="cpu")
    assert carried.keys() == mine.keys()
    for k, ab in carried.items():
        assert ab["a"].shape == mine[k]["a"].shape
        assert ab["b"].shape == mine[k]["b"].shape
        jax_key = k.replace("blocks.", "block_", 1).replace(".", "/")
        np.testing.assert_array_equal(ab["a"].numpy(),
                                      np.asarray(theirs[jax_key]["a"]))
    stacked = _flax_lm(scan_layers=True).init(
        jax.random.key(0), jnp.zeros((1, T), jnp.int32))["params"]
    st_ads = jax_lora_init(jax.random.key(1), stacked, rank=4)
    st_carried = adapters_from_jax(st_ads, device="cpu")
    assert st_carried.keys() == mine.keys()
    np.testing.assert_array_equal(
        st_carried["blocks.1.wq.kernel"]["a"].numpy(),
        np.asarray(st_ads["blocks/wq/kernel"]["a"])[1])


def _random_adapters(params, seed):
    """JAX-layout adapters with both A and B random (B = 0 would zero the
    gradient of A)."""
    ads = jax_lora_init(jax.random.key(1), params, rank=4)
    rs = np.random.RandomState(seed)
    return {k: {n: 0.1 * rs.randn(*np.shape(v)).astype(np.float32)
                for n, v in ab.items()} for k, ab in ads.items()}


def test_logits_and_adapter_grads_match_jax(base):
    """Flash attention and per-block remat on both sides, f32: logits and
    the gradient of a weighted logit sum w.r.t. every adapter."""
    params, state = base
    ads_np = _random_adapters(params, seed=3)
    toks = _lm_task()["x"][0]
    w = np.random.RandomState(4).randn(S, T, VOCAB).astype(np.float32)
    apply_j = jax_lora_apply_fn(
        _flax_lm(attn_fn=jax_flash_attn_fn, remat=True).apply, params)

    def loss_j(ads):
        return (apply_j({"params": ads}, jnp.asarray(toks)) * w).sum()

    want_logits = apply_j({"params": ads_np}, jnp.asarray(toks))
    want_grads = jax.grad(loss_j)(ads_np)

    model = _port_model(state)
    ads = {k: {n: v.requires_grad_() for n, v in ab.items()}
           for k, ab in adapters_from_jax(ads_np, device="cpu").items()}
    logits = model(torch.from_numpy(toks.astype(np.int64)), adapters=ads)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), rtol=1e-4, atol=1e-5)
    (logits * torch.from_numpy(w)).sum().backward()
    # each gradient sums thousands of f32 terms in another order than XLA:
    # held at 2e-4 relative, with an absolute floor at 2e-5 of the largest
    # entry for the entries that cancel to near zero
    for k, ab in ads.items():
        jax_key = k.replace("blocks.", "block_", 1).replace(".", "/")
        for n in ("a", "b"):
            want = np.asarray(want_grads[jax_key][n])
            np.testing.assert_allclose(
                ab[n].grad.numpy(), want, rtol=2e-4,
                atol=2e-5 * np.abs(want).max(), err_msg=f"{k}/{n}")


def _run_rounds(base, n_rounds, momentum=0.0, compute_dtype="float32",
                flash=True):
    """n_rounds of the JAX flat round and of the port's, from the same
    adapters and batch schedules. Returns per round
    ((jax adapters, jax loss), (port adapters, port loss))."""
    params, state = base
    kw = dict(epochs=1, batch_size=4, learning_rate=0.5, momentum=momentum,
              compute_dtype=compute_dtype)
    model_j = _flax_lm(attn_fn=jax_flash_attn_fn if flash else None,
                       remat=True)
    alg_j, ads_j = jax_federated_lora(model_j, params, JaxTrainArgs(**kw),
                                      jax.random.key(1), rank=4)
    alg_t, _ = federated_lora(_port_model(state, flash), state,
                              TrainArgs(**kw), _gen(), rank=4)
    data = _lm_task()
    ids = np.arange(N_CLIENTS)
    weights = np.full((N_CLIENTS,), 8.0, np.float32)
    st_j = alg_j.server_init(jax.tree.map(jnp.array, ads_j), None)
    st_t = alg_t.server_init(adapters_from_jax(ads_j, device="cpu"))
    round_j = jax_build_round_fn(alg_j, mesh=None)
    round_t = build_round_fn(alg_t)
    data_j = {k: jnp.asarray(v) for k, v in data.items()}
    data_t = {k: torch.from_numpy(v.astype(np.int64) if k != "mask" else v)
              for k, v in data.items()}
    out = []
    for r in range(n_rounds):
        rng = jax.random.fold_in(jax.random.key(2), r)
        sched = [torch.from_numpy(np.asarray(jax_batch_indices(
            jax.random.fold_in(rng, i), S, 4, 1)).astype(np.int64))
            for i in ids]
        o_j = round_j(st_j, jnp.zeros((N_CLIENTS,)), data_j,
                      jnp.asarray(ids), jnp.asarray(weights), rng, None)
        o_t = round_t(st_t, None, data_t, ids, weights, seed=r,
                      batch_idx=sched)
        st_j, st_t = o_j.server_state, o_t.server_state
        out.append(((jax.tree.map(np.asarray, st_j.params),
                     float(o_j.metrics["train_loss"])),
                    (st_t.params, float(o_t.metrics["train_loss"]))))
    return out


def _assert_adapters_close(jax_ads, port_ads, rtol, atol):
    for k, ab in port_ads.items():
        jax_key = k.replace("blocks.", "block_", 1).replace(".", "/")
        for n in ("a", "b"):
            np.testing.assert_allclose(ab[n].numpy(), jax_ads[jax_key][n],
                                       rtol=rtol, atol=atol,
                                       err_msg=f"{k}/{n}")


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_rounds_match_jax(base, momentum):
    """One and two FedAvg rounds over the adapters equal the JAX flat
    round (tests/test_fedllm.py's tolerance, rtol 5e-4 / atol 5e-5), and
    so does train_loss."""
    for (ads_j, loss_j), (ads_t, loss_t) in _run_rounds(base, 2, momentum):
        _assert_adapters_close(ads_j, ads_t, rtol=5e-4, atol=5e-5)
        assert loss_t == pytest.approx(loss_j, rel=5e-4, abs=5e-5)


def test_bf16_round_matches_jax(base):
    """compute_dtype bfloat16: the model's matmuls, attention and logits
    run in bf16 on both sides while adapters and optimizer stay f32. The
    frameworks round bf16 at different points inside the matmuls (2^-8
    relative each), so the adapters after the round agree within 2e-2 of
    the largest adapter update and the loss within 1e-3 relative (f32
    rounds agree to ~1e-6 of the largest update)."""
    params, state = base
    (((ads_j, loss_j), (ads_t, loss_t)),) = _run_rounds(
        base, 1, compute_dtype="bfloat16")
    ads0 = jax_lora_init(jax.random.key(1), params, rank=4)
    delta = max(np.abs(ads_j[k][n] - np.asarray(ads0[k][n])).max()
                for k in ads_j for n in ("a", "b"))
    _assert_adapters_close(ads_j, ads_t, rtol=0, atol=2e-2 * delta)
    assert loss_t == pytest.approx(loss_j, rel=1e-3)


def test_loss_falls_over_eight_rounds(base):
    """tests/test_fedllm.py's convergence bar on the port alone, with its
    own batch draws (round seed r)."""
    _params, state = base
    t = TrainArgs(epochs=1, batch_size=4, learning_rate=0.5)
    alg, adapters = federated_lora(_port_model(state), state, t, _gen(),
                                   rank=4)
    data = {k: torch.from_numpy(v.astype(np.int64) if k != "mask" else v)
            for k, v in _lm_task().items()}
    round_fn = build_round_fn(alg)
    st = alg.server_init(adapters)
    losses = []
    for r in range(8):
        out = round_fn(st, None, data, np.arange(N_CLIENTS),
                       np.full((N_CLIENTS,), 8.0), seed=r)
        st = out.server_state
        losses.append(float(out.metrics["train_loss"]))
    assert losses[-1] < 0.8 * losses[0], losses
    assert st.params.keys() == adapters.keys()
    assert int(out.metrics["n_samples"]) == N_CLIENTS * 8 * T


def test_unported_options_raise(base):
    _params, state = base
    alg, _ = federated_lora(_port_model(state), state, TrainArgs(), _gen())
    from fedml_tpu_torch.parallel.launch import local_world
    from fedml_tpu_torch.parallel.mesh import make_mesh

    with local_world():
        build_round_fn(alg, mesh=make_mesh({"clients": 1}))
    with pytest.raises(TypeError, match="DeviceMesh"):
        build_round_fn(alg, mesh=object())
    # vmapped LoRA clients (item 3d.1b) are ported: a G = 2 round builds
    # and runs, and gives the G = 1 round's adapters
    data = {k: torch.from_numpy(v.astype(np.int64) if k != "mask" else v)
            for k, v in _lm_task().items()}
    ids, w = np.arange(N_CLIENTS), np.full((N_CLIENTS,), 8.0, np.float32)
    alg, ads = federated_lora(_port_model(state), state, TrainArgs(), _gen())
    outs = [build_round_fn(alg, group_size=g)(
        alg.server_init(ads), None, data, ids, w, seed=0).server_state.params
        for g in (1, 2)]
    _assert_adapters_close({k.replace("blocks.", "block_", 1).replace(
        ".", "/"): {n: v.numpy() for n, v in ab.items()}
        for k, ab in outs[0].items()}, outs[1], rtol=1e-5, atol=1e-6)
    # chaos faults (item 3e) are ported: the LoRA round takes them
    build_round_fn(alg, client_dropout=0.1)
    with pytest.raises(ValueError, match="model's own state"):
        federated_lora(_port_model(state), dict(params_from_flax(
            base[0], device="cpu")), TrainArgs(), _gen())
