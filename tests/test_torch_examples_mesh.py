"""The ported examples as the port's smoke suite, part 2: the two that run
a device mesh as gloo ranks (hierarchical cross-silo over a (silos=4,
intra=2) mesh and FedLLM's --ring over (silos=2, seq=4), 8 ranks each, as
the JAX examples' 8 virtual CPU devices lay out), on the CPU with
`--device cpu`.

Each case is handed the JAX example's initial parameters (converted to
the port's state dicts) and the JAX round's batch orders, and held to
the JAX example's calls round by round (`torch_examples_common.py`
states the bars); the example's own asserts run on top, and the ranks'
K1-K4 launches must be 0. The JAX side runs over the 8 CPU devices
`conftest.py` forces."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from fedml_tpu.algorithms.builtin import make_fedavg as jax_make_fedavg
from fedml_tpu.config import TrainArgs as JaxTrainArgs
from fedml_tpu.core.algorithm import make_client_optimizer as jax_make_opt
from fedml_tpu.models import hub as jax_hub
from fedml_tpu.parallel.hier import make_hier_round as jax_make_hier_round
from fedml_tpu.parallel.hier import shard_hier_data as jax_shard_hier_data

from fedml_tpu_torch.models import hub

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_examples_common import (  # noqa: E402
    assert_acc, assert_losses, fedllm_case, fresh_metrics, jax_batches,
    np_tree, run,
)

torch.set_num_threads(2)


def _jax_hier():
    """The JAX example's five hierarchical rounds on a (silos=4, intra=2)
    mesh: its initial parameters and every round's metrics."""
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2),
                ("silos", "intra"))
    model = jax_hub.create("mlp", 3)
    t = JaxTrainArgs(epochs=1, batch_size=16, learning_rate=0.3)
    alg = jax_make_fedavg(model.apply, t)
    params = np_tree(jax_hub.init_params(model, (8,), jax.random.key(0)))
    rnd = jax_make_hier_round(model.apply, alg, mesh,
                              jax_make_opt("sgd", t.learning_rate), 16, 1)
    rs = np.random.RandomState(0)
    w_true = rs.randn(8, 3)
    x = rs.randn(4, 64, 8).astype(np.float32)
    y = np.argmax(x @ w_true, axis=-1)
    data = jax_shard_hier_data(
        {"x": x, "y": y, "mask": np.ones((4, 64), np.float32)}, mesh)
    st = alg.server_init(jax.tree.map(jnp.asarray, params), None)
    mets = []
    for r in range(5):
        st, m = rnd(st, data, jnp.arange(4), jnp.full((4,), 64.0),
                    jax.random.fold_in(jax.random.key(1), r))
        mets.append(jax.tree.map(float, m))
    return params, mets


def test_hierarchical_cross_silo(capsys):
    p0, want = _jax_hier()
    m = run("hierarchical_cross_silo", draws={
        "params": {k: v.numpy() for k, v in hub.params_from_flax(
            p0, device="cpu").items()},
        # each intra rank's slice of 64 // 2 samples, 16 // 2 a step
        "batches": jax_batches(1, 5, 4, 32, 8)})
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "mesh: silos=4 x intra=2 on cpu"
    assert out[-1] == "hierarchical federation converged"
    hist = m["history"]
    assert_losses([h["train_loss"] for h in hist],
                  [w["train_loss"] for w in want])
    for h, w in zip(hist, want):
        assert h["n_samples"] == w["n_samples"] == 4 * 64
        assert_acc(h["train_acc"], w["train_acc"], w["n_samples"])
    assert m["train_acc"] > 0.8
    assert not any(m["rank_launches"].values())


@pytest.mark.parametrize("flag", ["--ring"], ids=["ring"])
def test_fedllm_lora(capsys, flag):
    fedllm_case(capsys, flag)
