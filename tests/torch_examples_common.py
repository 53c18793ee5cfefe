"""Shared by the tests of the ported examples (tests/test_torch_examples*.py):
the module's own metrics registry, the in-process runner, the JAX draws
handed to an example, the bars its run is held to against the JAX
example's calls, and FedLLM's case (the JAX example's calls and the
checks), which two of those files run.

Bars (f32 on the CPU, the same calls on both sides from the same initial
parameters and batch orders): every round's loss within 1e-4 relative
(1e-6 absolute, for losses near 0), and an accuracy within one sample of
its count.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fedml_tpu.algorithms.builtin import make_fedavg as jax_make_fedavg
from fedml_tpu.config import TrainArgs as JaxTrainArgs
from fedml_tpu.core.algorithm import ServerState as JaxServerState
from fedml_tpu.core.algorithm import make_batch_indices as jax_batch_indices
from fedml_tpu.llm import federated_lora as jax_federated_lora
from fedml_tpu.llm import make_fedllm_seq_round as jax_make_seq_round
from fedml_tpu.llm import shard_fedllm_data as jax_shard_fedllm_data
from fedml_tpu.llm.lora import lora_init as jax_lora_init
from fedml_tpu.llm.quant import (
    make_inscan_quant_apply as jax_inscan_apply,
    quantize_tree_int8 as jax_quantize,
)
from fedml_tpu.llm.transformer import TransformerLM as FlaxLM
from fedml_tpu.parallel.mesh import make_mesh as jax_make_mesh
from fedml_tpu.parallel.round import build_round_fn as jax_build_round_fn
from fedml_tpu.serving import GreedyLMPredictor as JaxGreedyLMPredictor

from fedml_tpu_torch.examples import fedllm_lora as fedllm
from fedml_tpu_torch.llm.lora import adapters_from_jax
from fedml_tpu_torch.llm.transformer import params_from_flax
from fedml_tpu_torch.utils import metrics as mx

LOSS_REL, LOSS_ABS = 1e-4, 1e-6


@pytest.fixture(scope="module", autouse=True)
def fresh_metrics():
    """The examples bump the process-wide metrics registry: give the
    module its own and put the old one back after."""
    old = mx.registry
    mx.registry = mx.MetricsRegistry()
    yield
    mx.registry = old


def run(name: str, *args: str, draws=None) -> dict:
    """`fedml_tpu_torch.examples.<name>.main` with `--device cpu`."""
    main = importlib.import_module(f"fedml_tpu_torch.examples.{name}").main
    argv = ["--device", "cpu", *args]
    return main(argv) if draws is None else main(argv, draws=draws)


def jax_batches(seed: int, rounds: int, n_clients: int, n: int, b: int,
                epochs: int = 1) -> list:
    """The JAX round's batch orders: round r's client i draws
    `make_batch_indices(fold_in(fold_in(key(seed), r), i), n, b, epochs)`;
    one int64 [clients, steps, b] array a round."""
    out = []
    for r in range(rounds):
        rng = jax.random.fold_in(jax.random.key(seed), r)
        out.append(np.stack([np.asarray(jax_batch_indices(
            jax.random.fold_in(rng, i), n, b, epochs))
            for i in range(n_clients)]).astype(np.int64))
    return out


def assert_losses(got: list, want: list):
    assert len(got) == len(want) and len(want) > 0
    for r, (g, w) in enumerate(zip(got, want)):
        assert g == pytest.approx(w, rel=LOSS_REL, abs=LOSS_ABS), (r, g, w)


def assert_acc(got: float, want: float, n: float):
    assert abs(got - want) <= 1.0 / n + 1e-9, (got, want, n)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------------------------ FedLLM
def _lm(**kw):
    d = fedllm.DIMS
    return FlaxLM(vocab_size=d.vocab_size, d_model=d.d_model,
                  n_layers=d.n_layers, n_heads=d.n_heads, d_ff=d.d_ff, **kw)


def _jax_fedllm(flag: str):
    """The JAX example's eight rounds (flat, --ring or --int8): its f32
    base and initial adapters, every round's loss, and with --int8 the
    greedy tokens served from the result."""
    model = _lm(scan_layers=flag == "--int8")
    base = model.init(jax.random.key(0),
                      jnp.zeros((1, fedllm.T), jnp.int32))["params"]
    t = JaxTrainArgs(epochs=1, batch_size=8, learning_rate=0.5)
    task = fedllm.task()
    data = {k: jnp.asarray(v.astype(np.float32 if k == "mask" else np.int32))
            for k, v in task.items()}
    n = fedllm.N_CLIENTS
    weights = jnp.full((n,), 16.0)
    losses, greedy = [], None
    if flag == "--ring":
        _alg, adapters = jax_federated_lora(model, base, t, jax.random.key(1),
                                            rank=8)
        p0 = np_tree(adapters)
        mesh = jax_make_mesh({"silos": 2, "seq": 4})
        rnd = jax_make_seq_round(model, base, t, mesh)
        st = JaxServerState(adapters, None, jnp.int32(0), None)
        hdata = jax_shard_fedllm_data({k: v[:2] for k, v in task.items()},
                                      mesh)
        for r in range(8):
            st, m = rnd(st, base, hdata, jnp.arange(2), weights[:2],
                        jax.random.fold_in(jax.random.key(2), r))
            losses.append(float(m["train_loss"]))
        return np_tree(base), p0, losses, greedy
    if flag == "--int8":
        qbase = jax_quantize(base)
        inscan = jax_inscan_apply(fedllm.HEADS, dtype=jnp.float32)
        alg = jax_make_fedavg(
            lambda variables, x: inscan(qbase, variables["params"], x), t)
        adapters = jax_lora_init(jax.random.key(1), base, rank=8)
    else:
        alg, adapters = jax_federated_lora(model, base, t, jax.random.key(1),
                                           rank=8)
    p0 = np_tree(adapters)
    rnd = jax_build_round_fn(alg, mesh=None)
    st = alg.server_init(adapters, None)
    for r in range(8):
        out = rnd(st, jnp.zeros((n,)), data, jnp.arange(n), weights,
                  jax.random.fold_in(jax.random.key(2), r), None)
        st = out.server_state
        losses.append(float(out.metrics["train_loss"]))
    if flag == "--int8":
        pred = JaxGreedyLMPredictor(model, qbase, max_len=64, kv_cache=True,
                                    adapters=st.params)
        prompt = task["x"][0, 0, :8].astype(int).tolist()
        greedy = pred.predict({"tokens": prompt,
                               "max_new_tokens": 8})["generated_tokens"]
    return np_tree(base), p0, losses, greedy


def fedllm_case(capsys, flag: str):
    """FedLLM's case `flag` ("", "--ring" or "--int8") held to the JAX
    example's calls (test_torch_examples_mesh.py runs --ring,
    test_torch_examples_lm.py the other two)."""
    base, adapters, want, greedy = _jax_fedllm(flag)
    n = 2 if flag == "--ring" else fedllm.N_CLIENTS
    got = run("fedllm_lora", *([flag] if flag else []), draws={
        "base": {k: v.numpy() for k, v in params_from_flax(
            base, device="cpu").items()},
        "adapters": {k: {n_: v.numpy() for n_, v in ab.items()}
                     for k, ab in adapters_from_jax(
                         adapters, device="cpu").items()},
        "batches": jax_batches(2, 8, n, 16, 8)})
    out = capsys.readouterr().out.splitlines()
    assert_losses(got["losses"], want)
    printed = [float(ln.rsplit("loss=", 1)[1]) for ln in out if "loss=" in ln]
    assert printed == [float(f"{v:.3f}") for v in got["losses"]]
    assert got["losses"][-1] < got["losses"][0] - 0.5
    if flag == "--ring":
        assert not any(got["rank_launches"].values())
        return
    assert out[-1] == "OK fedllm lora"
    if flag == "--int8":
        assert out[0].startswith("int8 base: ")
        assert got["served"] == 16
        assert got["greedy"] == greedy
