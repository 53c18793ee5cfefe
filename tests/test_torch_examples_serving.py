"""The ported examples as the port's smoke suite, part 4: serving deploy
(artifact and export paths over HTTP), federated segmentation, attack vs
defense and the platform API (cluster -> job -> model -> deploy ->
serve), in-process on the CPU with `--device cpu`. Each example's own
asserts decide; the tests check its closing line and reading. The
segmentation case is handed the JAX example's initial UNet parameters
and batch orders and held to the JAX example's calls round by round and
at its eval (`torch_examples_common.py` states the bars). The platform
example's model registry is pointed at a temporary directory."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.builtin import make_fedavg as jax_make_fedavg
from fedml_tpu.config import TrainArgs as JaxTrainArgs
from fedml_tpu.core.algorithm import seg_eval_fn as jax_seg_eval_fn
from fedml_tpu.models import hub as jax_hub
from fedml_tpu.parallel.round import build_round_fn as jax_build_round_fn

from fedml_tpu_torch.examples.federated_segmentation import square_masks
from fedml_tpu_torch.models import hub

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_examples_common import (  # noqa: E402
    assert_acc, assert_losses, fresh_metrics, jax_batches, np_tree, run,
)

torch.set_num_threads(2)


def test_serving_deploy(capsys):
    got = run("serving_deploy")
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "OK serving deploy (artifact + export paths)"
    assert "served round-1 artifact over HTTP" in out
    assert got["served"] == 8


def _jax_segmentation():
    """The JAX example's six rounds and eval: its initial parameters,
    every round's metrics and the eval's."""
    x, y = square_masks(np.random.RandomState(0), 3, 16)
    data = {"x": jnp.asarray(x), "y": jnp.asarray(y.astype(np.int32)),
            "mask": jnp.ones((3, 16), jnp.float32)}
    model = jax_hub.create("unet", 2)
    t = JaxTrainArgs(epochs=1, batch_size=8, learning_rate=0.2,
                     extra={"task": "segmentation"})
    alg = jax_make_fedavg(model.apply, t)
    params = jax_hub.init_params(model, (16, 16, 1), jax.random.key(0))
    p0 = np_tree(params)
    rnd = jax_build_round_fn(alg, mesh=None)
    st = alg.server_init(params, None)
    mets = []
    for r in range(6):
        out = rnd(st, jnp.zeros((3,)), data, jnp.arange(3),
                  jnp.full((3,), 16.0),
                  jax.random.fold_in(jax.random.key(1), r), None)
        st = out.server_state
        mets.append({k: float(out.metrics[k])
                     for k in ("train_loss", "train_acc")})
    xe, ye = square_masks(np.random.RandomState(7), 1, 8)
    m = jax_seg_eval_fn(model.apply, num_classes=2)(
        st.params, jnp.asarray(xe[0]).reshape(2, 4, 16, 16, 1),
        jnp.asarray(ye[0].astype(np.int32)).reshape(2, 4, 16, 16),
        jnp.ones((2, 4), jnp.float32))
    return p0, mets, {k: float(m[k]) for k in ("miou", "acc")}


def test_federated_segmentation(capsys):
    p0, want, want_eval = _jax_segmentation()
    got = run("federated_segmentation", draws={
        "params": {k: v.numpy() for k, v in hub.params_from_flax(
            p0, device="cpu").items()},
        "batches": jax_batches(1, 6, 3, 16, 8)})
    assert capsys.readouterr().out.splitlines()[-1] == \
        "OK federated segmentation"
    assert_losses([h["train_loss"] for h in got["history"]],
                  [w["train_loss"] for w in want])
    pixels = 3 * 16 * 16 * 16   # a round's labelled pixels, at most
    for h, w in zip(got["history"], want):
        assert_acc(h["train_acc"], w["train_acc"], pixels)
    assert_acc(got["acc"], want_eval["acc"], 8 * 16 * 16)
    assert got["miou"] == pytest.approx(want_eval["miou"], abs=1e-3)
    assert got["miou"] > 0.6


def test_attack_vs_defense(capsys):
    got = run("attack_vs_defense")
    assert capsys.readouterr().out.splitlines()[-1] == \
        "defense held against byzantine clients"
    assert got["test_acc"] > got["undefended_test_acc"] - 0.02


def test_platform_api(capsys, tmp_path, monkeypatch):
    import fedml_tpu_torch.api as api

    monkeypatch.setattr(api, "_REGISTRY", str(tmp_path / "models"))
    monkeypatch.setattr(api, "_PROFILE", str(tmp_path / "profile.json"))
    got = run("platform_api")
    out = capsys.readouterr().out.splitlines()
    assert any(ln.startswith("job: FINISHED") for ln in out), out
    assert got["served"] == 2 and got["job_status"] == "FINISHED"
    assert not (tmp_path / "models" / "digits-lr").exists()
