"""The port's framework-neutral export (`fedml_tpu_torch/serving/export.py`)
held against the JAX package's `serving/export.py`, on the CPU.

- The same numpy tree (a bf16 leaf included) gives the same manifest and
  the same archive under both `export_model`s; the port's own flat dict
  keeps its names, and a bf16 tensor comes back from `load_export`
  bitwise.
- A JAX-written export of a flax CNN, read by the port's
  `predictor_from_export` (carried across with `hub.params_from_flax`),
  predicts what the JAX predictor does: the same labels and
  probabilities within 1e-5 of the largest (`test_torch_fedavg.py`'s f32
  rule).
- The validation errors are JAX's, message for message, on the same
  broken exports; and `start_replica` serves an export directory.
"""
import json
import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from fedml_tpu.models import hub as jax_hub
from fedml_tpu.serving import export as jax_export
from fedml_tpu_torch.models import hub
from fedml_tpu_torch.serving import (
    export_model, load_export, predictor_from_export,
)
from fedml_tpu_torch.serving.predictor import TorchPredictor

torch.set_num_threads(2)


def _tree(seed=0):
    rs = np.random.RandomState(seed)
    return {"Dense_0": {"kernel": rs.randn(6, 3).astype(np.float32),
                        "bias": rs.randn(3).astype(np.float32)},
            "emb": {"embedding": rs.randn(5, 4).astype(ml_dtypes.bfloat16)},
            "steps": np.arange(4, dtype=np.int32)}


def _npz(path):
    with np.load(os.path.join(path, "tensors.npz")) as z:
        return {k: z[k] for k in z.files}


def test_manifest_and_archive_equal_jax(tmp_path):
    tree = _tree()
    kw = dict(model_name="lr", num_classes=3, model_args={"x": 1},
              input_shape=(6,), compute_dtype="bfloat16")
    got = export_model(str(tmp_path / "p"), tree, **kw)
    want = jax_export.export_model(str(tmp_path / "j"), tree, **kw)
    assert got == want
    assert got["tensors"]["emb/embedding"] == {
        "shape": [5, 4], "dtype": "float32", "cast_from": "bfloat16"}
    for name in ("manifest.json",):
        assert (tmp_path / "p" / name).read_text() == \
            (tmp_path / "j" / name).read_text()
    a, b = _npz(str(tmp_path / "p")), _npz(str(tmp_path / "j"))
    assert sorted(a) == sorted(b)
    assert all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
               for k in a)
    # a pure tensor interchange has no recipe in either package
    assert export_model(str(tmp_path / "q"), tree) == \
        jax_export.export_model(str(tmp_path / "k"), tree)


def test_port_flat_dict_round_trips_with_bf16(tmp_path):
    g = torch.Generator().manual_seed(0)
    state = {"Dense_0.kernel": torch.randn(6, 3, generator=g).to(
        torch.bfloat16),
             "Dense_0.bias": torch.randn(3, generator=g)}
    man = export_model(str(tmp_path), state, model_name="lr",
                       num_classes=3, input_shape=(6,))
    assert set(man["tensors"]) == set(state)
    assert man["tensors"]["Dense_0.kernel"]["cast_from"] == "bfloat16"
    params, man2 = load_export(str(tmp_path))
    assert man2 == man and sorted(params) == sorted(state)
    assert params["Dense_0.kernel"].dtype == torch.bfloat16
    assert torch.equal(params["Dense_0.kernel"], state["Dense_0.kernel"])
    np.testing.assert_array_equal(params["Dense_0.bias"],
                                  state["Dense_0.bias"].numpy())


def test_port_export_serves_like_a_torch_predictor(tmp_path):
    model = hub.create("cnn", 10, (8, 8, 1), device="cpu")
    params = hub.init_params(model, torch.Generator().manual_seed(3))
    export_model(str(tmp_path), params, model_name="cnn", num_classes=10,
                 input_shape=(8, 8, 1))
    x = np.random.RandomState(1).randn(5, 8, 8, 1).tolist()
    want = TorchPredictor(hub.apply_fn(model), params,
                          device="cpu").predict({"inputs": x})
    got = predictor_from_export(str(tmp_path), device="cpu").predict(
        {"inputs": x})
    assert got == want


def test_jax_export_predicts_as_jax_does(tmp_path):
    model = jax_hub.create("cnn", 10)
    params = jax.tree.map(np.asarray, jax_hub.init_params(
        model, (28, 28, 1), jax.random.key(0)))
    jax_export.export_model(str(tmp_path), params, model_name="cnn",
                            num_classes=10, input_shape=(28, 28, 1))
    x = np.random.RandomState(2).randn(6, 28, 28, 1).astype(np.float32)
    want = jax_export.predictor_from_export(str(tmp_path)).predict(
        {"inputs": x.tolist()})
    got = predictor_from_export(str(tmp_path), device="cpu").predict(
        {"inputs": x.tolist()})
    assert got["predictions"] == want["predictions"]
    pw, pg = (np.asarray(d["probabilities"]) for d in (want, got))
    np.testing.assert_allclose(pg, pw, rtol=0, atol=1e-5 * np.abs(pw).max())


def _errors(fn, *a, **kw):
    try:
        fn(*a, **kw)
    except (ValueError, KeyError, FileNotFoundError) as e:
        return type(e).__name__, str(e)
    return None


def test_validation_errors_match_jax(tmp_path):
    good = str(tmp_path / "good")
    jax_export.export_model(good, _tree(), model_name="lr", num_classes=3)
    assert _errors(export_model, str(tmp_path / "x"), _tree(),
                   model_name="lr") == \
        _errors(jax_export.export_model, str(tmp_path / "y"), _tree(),
                model_name="lr")
    cases = {}
    # wrong format tag
    d = tmp_path / "fmt"
    jax_export.export_model(str(d), _tree())
    man = json.loads((d / "manifest.json").read_text())
    man["format"] = "other/2"
    (d / "manifest.json").write_text(json.dumps(man))
    cases["fmt"] = str(d)
    # a tensor missing from the archive, one too many
    d = tmp_path / "set"
    jax_export.export_model(str(d), _tree())
    man = json.loads((d / "manifest.json").read_text())
    man["tensors"]["ghost"] = {"shape": [1], "dtype": "float32"}
    del man["tensors"]["steps"]
    (d / "manifest.json").write_text(json.dumps(man))
    cases["set"] = str(d)
    # a shape that disagrees with the manifest
    d = tmp_path / "shape"
    jax_export.export_model(str(d), _tree())
    man = json.loads((d / "manifest.json").read_text())
    man["tensors"]["Dense_0/bias"]["shape"] = [4]
    (d / "manifest.json").write_text(json.dumps(man))
    cases["shape"] = str(d)
    for name, path in cases.items():
        want = _errors(jax_export.load_export, path)
        assert want is not None, name
        assert _errors(load_export, path) == want, name
    # no recipe: a pure tensor interchange is not servable
    d = str(tmp_path / "norecipe")
    jax_export.export_model(d, _tree())
    assert _errors(predictor_from_export, d, device="cpu") == \
        _errors(jax_export.predictor_from_export, d)


def test_start_replica_serves_an_export(tmp_path):
    from fedml_tpu_torch.serving.scheduler import start_replica

    model = hub.create("lr", 3, (6,), device="cpu")
    params = hub.init_params(model, torch.Generator().manual_seed(5))
    export_model(str(tmp_path), params, model_name="lr", num_classes=3)
    rid, runner = start_replica({"export_dir": str(tmp_path),
                                 "device": "cpu"})
    try:
        import urllib.request

        x = np.random.RandomState(0).randn(3, 6).tolist()
        req = urllib.request.Request(
            f"http://127.0.0.1:{runner.port}/predict",
            data=json.dumps({"inputs": x}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            got = json.loads(r.read())
        assert got == TorchPredictor(hub.apply_fn(model), params,
                                     device="cpu").predict({"inputs": x})
    finally:
        runner.stop()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            predictor_from_export(str(tmp_path))


def test_start_replica_serves_a_checkpoint(tmp_path):
    """A "checkpoint_dir" spec restores the Simulator's saved server state
    against `build_algorithm`'s template and serves its global model."""
    import fedml_tpu_torch
    from fedml_tpu_torch.serving.scheduler import start_replica
    from fedml_tpu_torch.simulation.simulator import Simulator

    cfg = fedml_tpu_torch.init(config={
        "data_args": {"dataset": "synthetic",
                      "extra": {"synthetic_samples_per_client": 16}},
        "model_args": {"model": "lr"},
        "train_args": {"federated_optimizer": "FedAvg",
                       "client_num_in_total": 2, "client_num_per_round": 2,
                       "comm_round": 1, "epochs": 1, "batch_size": 8,
                       "learning_rate": 0.3},
        "validation_args": {"frequency_of_the_test": 0}}, device="cpu")
    sim = Simulator(cfg, device="cpu")
    sim.run()
    sim.save(str(tmp_path))
    shape = tuple(sim.dataset.x_test.shape[1:])
    rid, runner = start_replica({
        "checkpoint_dir": str(tmp_path), "model": "lr",
        "num_classes": sim.num_classes, "input_shape": list(shape),
        "device": "cpu"})
    try:
        x = np.asarray(sim.dataset.x_test[:4], np.float32)
        got = runner.predictor.predict({"inputs": x.tolist()})
        want = TorchPredictor(sim.apply_fn, sim.server_state.params,
                              device="cpu").predict({"inputs": x.tolist()})
        assert got == want
    finally:
        runner.stop()
