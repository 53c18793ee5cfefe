"""The centralized trainer over a model-parallel mesh
(`fedml_tpu_torch.centralized`, device_args.mesh_shape {"mp": 2}) against
the JAX package's, on the CPU.

The port's trainers run SPMD in 2 gloo ranks (`parallel/launch.
RankPool`), spawned once for the module, which checks they exit 0; the
ranks import no JAX (`torch_tp_ranks.py`). Both sides start from the JAX
trainer's flax parameters (`hub.params_from_flax`) and take its batch
order (`make_batch_indices(fold_in(key(seed), e), ...)`), so they compute
the same function. Two models, each through other split layers of
`models/hub.py`: the MLP (Dense) and the FedAvg CNN (Conv and Dense). The
port's mp = 2 run holds, after 2 epochs, its history and its gathered
parameters within JAX's bars (rtol 1e-4, atol 1e-6 on the losses, atol
1e-5 on the parameters, tests/test_partition.py:305-338) of JAX's mp = 2
run and of JAX's unsharded run; each rank holds its block of every split
leaf through every epoch, on the dim JAX's spec names (a conv kernel's
output channels: the last dim of flax's HWIO, the first of the port's
OIHW). The one model with an embedding, the fed_shakespeare LSTM, is a
next-token task JAX's trainer cannot pool, so its split embedding and
head (`hub.split_layers` under `mlp_cnn` with `unmatched_params:
replicated`: its recurrent kernels fall outside the table) are held at
one loss and gradient against JAX's at mp = 2 and unsharded, at the same
bars. The flagship ResNet-18-GN resolves under the auto-picked `mlp_cnn` table with
the error policy (62 leaves), and a model the table only partly covers
needs `unmatched_params`.
"""
import os
import sys

import numpy as np
import pytest
import torch

try:
    import jax

    import fedml_tpu
    from fedml_tpu.centralized import CentralizedTrainer as JaxCentralized
    from fedml_tpu.core.algorithm import (
        make_batch_indices as jax_batch_indices,
    )
    from fedml_tpu.parallel import partition as jax_part
except ModuleNotFoundError:
    pass

import fedml_tpu_torch
from fedml_tpu_torch.centralized import CentralizedTrainer
from fedml_tpu_torch.models import hub
from fedml_tpu_torch.parallel import partition
from fedml_tpu_torch.parallel.launch import RankPool, local_world

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_tp_ranks as ranks  # noqa: E402

torch.set_num_threads(2)

EPOCHS = 2


# model -> (dataset, learning rate): JAX's own MLP case; the CNN at the
# rate of test_torch_centralized.py's (at 0.05 its loss rises and f32
# rounding grows until even the unsharded runs of the two packages part)
MODELS = {"mlp": ("mnist", 0.3), "cnn": ("mnist", 0.01)}


def _config(data_dir, mp=None, model="mlp") -> dict:
    dataset, lr = MODELS[model]
    cfg = {"data_args": {"dataset": dataset, "data_cache_dir": str(data_dir),
                         "extra": {"synthetic_samples_per_client": 32}},
           "model_args": {"model": model},
           "train_args": {"client_num_in_total": 4,
                          "client_num_per_round": 4, "epochs": 1,
                          "batch_size": 16, "learning_rate": lr}}
    if mp:
        cfg["device_args"] = {"mesh_shape": {"mp": mp}}
    return cfg


def _jax_runs(data, model) -> dict:
    out = {}
    for mp in (None, 2):
        jt = JaxCentralized(fedml_tpu.init(config=_config(data, mp, model)))
        if mp is None:
            out["p0"] = jax.tree.map(np.asarray, jt.params)
            seed = jt.cfg.common_args.random_seed
            out["idx"] = [np.asarray(jax_batch_indices(
                jax.random.fold_in(jax.random.key(seed), e),
                jt.pooled["y"].shape[0], jt.cfg.train_args.batch_size, 1))
                for e in range(EPOCHS)]
        hist = jt.run(epochs=EPOCHS)
        out[("jax", mp)] = (hist, hub.params_from_flax(
            jax.tree.map(np.asarray, jt.params), device="cpu"))
        if mp:
            out["jax_specs"] = jt.param_specs
    return out


# the LSTM's case: fed_shakespeare's vocabulary, short sequences
RNN_V, RNN_B, RNN_T = 90, 8, 12


def _rnn_case() -> dict:
    """JAX's loss and gradient of the LSTM's next-token CE, unsharded and
    with the params on an {"mp": 2} mesh under `mlp_cnn` (replicated
    unmatched), and the inputs the ranks need."""
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh

    from fedml_tpu.models import hub as jax_hub

    rs = np.random.RandomState(0)
    x = rs.randint(0, RNN_V, (RNN_B, RNN_T)).astype(np.int32)
    y = rs.randint(0, RNN_V, (RNN_B, RNN_T)).astype(np.int32)
    model = jax_hub.create("rnn", RNN_V)
    params = model.init(jax.random.key(0), jnp.asarray(x))["params"]

    def loss(p, x, y):
        return optax.softmax_cross_entropy_with_integer_labels(
            model.apply({"params": p}, x), y).mean()

    vg = jax.jit(jax.value_and_grad(loss))
    mesh = Mesh(np.array(jax.devices()[:2]), ("mp",))
    sharded = jax_part.shard_params(params, mesh, "mlp_cnn",
                                    on_unmatched="replicated")
    out = {"inputs": {"x": x.astype(np.int64), "y": y.astype(np.int64),
                      "vocab": RNN_V,
                      "params": {k: v.numpy() for k, v in hub.params_from_flax(
                          jax.tree.map(np.asarray, params),
                          device="cpu").items()}}}
    for ref, p in ((2, sharded), (None, params)):
        lv, g = vg(p, jnp.asarray(x), jnp.asarray(y))
        out[("jax", ref)] = (float(lv), {k: v.numpy() for k, v in
                                         hub.params_from_flax(jax.tree.map(
                                             np.asarray, g),
                                             device="cpu").items()})
    out["jax_specs"] = _flat_specs(jax_part.resolve(
        "mlp_cnn", params, on_unmatched="replicated"))
    return out


@pytest.fixture(scope="module")
def all_runs(tmp_path_factory):
    """{model: JAX's runs and the port's mp = 2 ranks'}, every model's
    ranks in one pool."""
    data = tmp_path_factory.mktemp("data")
    out = {m: _jax_runs(data, m) for m in MODELS}
    out["rnn"] = _rnn_case()
    with RankPool(["cpu"] * 2, timeout_s=240.0) as pool:
        for m in MODELS:
            r = out[m]
            p0 = {k: v.numpy() for k, v in hub.params_from_flax(
                r["p0"], device="cpu").items()}
            r["port"] = pool.run(ranks.centralized, {
                "config": _config(data, 2, m), "params": p0,
                "idx": r["idx"]})
        out["rnn"]["port"] = pool.run(ranks.split_rnn_grad,
                                      out["rnn"]["inputs"])
    for r in out.values():
        r["exitcodes"] = pool.exitcodes
    return out


@pytest.fixture(scope="module")
def runs(all_runs):
    return all_runs["mlp"]


def test_ranks_exit_cleanly(runs):
    assert runs["exitcodes"] == [0, 0]


def _matches(runs, ref):
    hist, params = runs[("jax", ref)]
    for o in runs["port"]:
        for a, b in zip(o["hist"], hist):
            np.testing.assert_allclose(a["train_loss"], b["train_loss"],
                                       rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(a["train_acc"], b["train_acc"],
                                       rtol=1e-4, atol=1e-6)
        assert o["params"].keys() == params.keys()
        for k, v in params.items():
            np.testing.assert_allclose(o["params"][k], v.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)


@pytest.mark.parametrize("ref", [2, None], ids=["jax_mp2", "jax_unsharded"])
def test_centralized_mp2_matches_jax(runs, ref):
    _matches(runs, ref)


@pytest.mark.parametrize("ref", [2, None], ids=["jax_mp2", "jax_unsharded"])
def test_split_conv_matches_jax(all_runs, ref):
    """The CNN (split Conv and Dense kernels) at mp = 2 within JAX's bars
    of JAX's mp = 2 and unsharded runs."""
    _matches(all_runs["cnn"], ref)


@pytest.mark.parametrize("ref", [2, None], ids=["jax_mp2", "jax_unsharded"])
def test_split_embed_grad_matches_jax(all_runs, ref):
    """The LSTM with its embedding and head split over mp = 2: the loss
    and the whole gradient (gathered back) within JAX's bars of JAX's at
    mp = 2 and unsharded; each rank holds the column half of the
    embedding and of the head's kernel."""
    runs = all_runs["rnn"]
    loss, grads = runs[("jax", ref)]
    for o in runs["port"]:
        np.testing.assert_allclose(o["loss"], loss, rtol=1e-4, atol=1e-6)
        assert o["grads"].keys() == grads.keys()
        for k, v in grads.items():
            np.testing.assert_allclose(o["grads"][k], v, rtol=1e-4,
                                       atol=1e-5, err_msg=k)
        assert {k for k, v in o["specs"].items() if "mp" in v} == \
            {"Embed_0.embedding", "Dense_0.kernel"}
        assert o["specs"] == {k.replace("/", "."): tuple(v)
                              for k, v in runs["jax_specs"].items()}
        assert o["local"]["Embed_0.embedding"] == (RNN_V, 4)
        assert o["local"]["Dense_0.kernel"] == (256, RNN_V // 2)


def _port_spec(name: str, spec: tuple, ndim: int) -> tuple:
    """JAX's spec of a leaf as the port lays the leaf out: a conv kernel
    HWIO -> OIHW (its output channels first), trailing Nones dropped."""
    if ndim != 4:
        return spec
    oihw = [spec[3], spec[2], spec[0], spec[1]]
    while oihw and oihw[-1] is None:
        oihw.pop()
    return tuple(oihw)


def _layout(all_runs, model):
    runs = all_runs[model]
    full = runs[("jax", 2)][1]
    want = {k.replace("/", "."): _port_spec(k, tuple(v),
                                            full[k.replace("/", ".")].dim())
            for k, v in _flat_specs(runs["jax_specs"]).items()}
    split = {k for k, v in want.items() if "mp" in v}
    assert split == {"mlp": {"Dense_0.kernel", "Dense_1.kernel",
                             "Dense_2.kernel"},
                     "cnn": {"Conv_0.kernel", "Conv_1.kernel",
                             "Dense_0.kernel", "Dense_1.kernel"}}[model]
    for o in runs["port"]:
        assert o["specs"] == want
        for k, spec in o["specs"].items():
            shape = list(full[k].shape)
            if "mp" in spec:
                shape[spec.index("mp")] //= 2
            assert o["local"][k] == tuple(shape), k


def test_specs_and_local_layout(all_runs):
    """The auto-picked mlp_cnn table as JAX resolves it, and each rank
    holding the column half of each Dense kernel after the epochs."""
    _layout(all_runs, "mlp")


def test_split_conv_layout(all_runs):
    """The same for the CNN: each split leaf on the dim JAX's spec names,
    a conv kernel's in the port's OIHW layout."""
    _layout(all_runs, "cnn")


def _flat_specs(specs):
    return {jax_part.path_name(p): s for p, s in
            jax.tree_util.tree_flatten_with_path(specs)[0]}


def test_flagship_resolves_under_mlp_cnn():
    """ResNet-18-GN: every one of its 62 leaves under the error policy, each
    conv kernel on its output channels (OIHW dim 0)."""
    model = hub.create("resnet18_gn", 10, (32, 32, 3), device="meta")
    state = dict(model.named_parameters())
    assert partition.table_for_model(model) == "mlp_cnn"
    specs = partition.resolve("mlp_cnn", state)
    assert len(specs) == 62
    assert specs["Conv_0.kernel"] == ("mp",)
    assert specs["Dense_0.kernel"] == (None, "mp")
    assert specs["GroupNorm_0.scale"] == ()


def test_unmatched_policy_and_override(tmp_path):
    """The LSTM's recurrent kernels fall outside mlp_cnn: the default
    error policy refuses to start (JAX's words), the `replicated` policy
    trains them whole; the partition_rules override picks another
    table. One-rank mesh (a world of one)."""
    cfg = fedml_tpu_torch.init(config={
        **_config(tmp_path, 1), "model_args": {"model": "lr"},
        "device_args": {"mesh_shape": {"mp": 1},
                        "partition_rules": "lora"}}, device="cpu")
    with local_world("gloo", "cpu"):
        tr = CentralizedTrainer(cfg)
        assert set(tr.param_specs.values()) == {()}
        hist = tr.run(epochs=1)
    assert np.isfinite(hist[0]["train_loss"])
    d = {**_config(tmp_path, 1), "model_args": {"model": "rnn"},
         "data_args": {"dataset": "shakespeare",
                       "data_cache_dir": str(tmp_path)}}
    cfg = fedml_tpu_torch.init(config=d, device="cpu")
    with local_world("gloo", "cpu"):
        with pytest.raises(partition.UnmatchedParamError,
                           match="no partition rule matches"):
            CentralizedTrainer(cfg)
        d["device_args"] = {"mesh_shape": {"mp": 1},
                            "unmatched_params": "replicated"}
        tr = CentralizedTrainer(fedml_tpu_torch.init(config=d, device="cpu"))
        assert "()" in {str(tuple(s)) for s in tr.param_specs.values()}
