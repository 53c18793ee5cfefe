"""The port's engine adapters (`fedml_tpu_torch/engines.py`) against the JAX
package's, on the CPU.

`TorchSiloTrainer` is torch in both packages and draws its batch order
from a CPU generator, so on the CPU the port's trainer gives bitwise the
JAX package's trainer's parameters for the same module, data and seed.
Torch silos federate through the port's `FedServerManager` over loopback.
`TFSiloTrainer` (tensorflow imported inside its methods) gives bitwise
the JAX package's TF trainer's parameters and wire keys.
"""
import copy
import uuid

import numpy as np
import pytest
import torch
import torch.nn as nn

from fedml_tpu import engines as jeng

from fedml_tpu_torch import engines as eng
from fedml_tpu_torch.comm import FedCommManager
from fedml_tpu_torch.comm.loopback import LoopbackTransport, release_router
from fedml_tpu_torch.cross_silo import FedClientManager, FedServerManager

torch.set_num_threads(2)


def _mk_data(seed, n=64, d=8, k=3):
    # one shared task; each silo draws its own samples
    w = np.random.RandomState(42).randn(d, k)
    rs = np.random.RandomState(seed)
    x = rs.randn(n, d).astype(np.float32)
    return x, np.argmax(x @ w, axis=1).astype(np.int64)


def _torch_model(seed=0, d=8, k=3):
    torch.manual_seed(seed)
    return nn.Sequential(nn.Linear(d, 16), nn.ReLU(), nn.Linear(16, k))


@pytest.mark.parametrize("momentum,wd,epochs", [(0.0, 0.0, 1),
                                                (0.9, 1e-3, 2)])
def test_torch_trainer_bitwise_jax(momentum, wd, epochs):
    x, y = _mk_data(0, n=70)
    m = _torch_model(1)
    kw = dict(lr=0.3, batch_size=16, epochs=epochs, momentum=momentum,
              weight_decay=wd, seed=7)
    a = eng.TorchSiloTrainer(copy.deepcopy(m), x, y, device="cpu", **kw)
    b = jeng.TorchSiloTrainer(copy.deepcopy(m), x, y, **kw)
    pa, pb = a.get_params(), b.get_params()
    for r in range(3):
        pa, na, ma = a.train(pa, r)
        pb, nb, mb = b.train(pb, r)
        assert na == nb == 70 and ma == mb
        assert list(pa) == list(pb)
        for k in pa:
            np.testing.assert_array_equal(pa[k], pb[k])
    assert a.evaluate(x, y) == b.evaluate(x, y)
    assert (a.arch_fp, a.arch_desc) == (b.arch_fp, b.arch_desc)


def test_architecture_refusal_and_fingerprints():
    x, y = _mk_data(0)

    class Other(nn.Module):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(8, 16)
            self.fc2 = nn.Linear(16, 3)

        def forward(self, z):
            return self.fc2(torch.relu(self.fc1(z)))

    a = eng.TorchSiloTrainer(_torch_model(), x, y, device="cpu")
    b = eng.TorchSiloTrainer(Other(), x, y, device="cpu")
    pa = a.get_params()
    assert sorted(v.shape for v in pa.values()) == \
        sorted(v.shape for v in b.get_params().values())
    assert a.arch_fp != b.arch_fp
    with pytest.raises(ValueError, match="architecture mismatch"):
        b.set_params(pa)
    bad = dict(pa)
    bad["0.weight"] = np.zeros((4, 8), np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        a.set_params(bad)
    entries = [("dense/kernel", (8, 16), "float32"),
               ("dense/bias", (16,), "float32"),
               ("dense_1/kernel", (16, 3), "float32"),
               ("dense_1/bias", (3,), "float32"),
               ("dense_2/kernel", (3, 3), "float16")]
    assert eng.arch_fingerprint(entries) == jeng.arch_fingerprint(entries)
    assert eng.arch_fingerprint(entries[:4])[0] != \
        eng.arch_fingerprint(entries)[0]


@pytest.mark.parametrize("names", [
    ["sequential_3/dense_7/kernel:0", "sequential_3/dense_7/bias:0",
     "sequential_3/dense_8/kernel:0", "sequential_3/dense_8/bias:0"],
    ["model/block_1/conv_2/kernel", "model/block_3/conv/kernel",
     "model/branch_2/w", "model/dense/b:0"],
])
def test_var_path_normalisation_matches_jax(names):
    assert eng._normalize_var_paths(names) == jeng._normalize_var_paths(names)
    for n in names:
        assert eng._normalize_var_path(n) == jeng._normalize_var_path(n)


def test_torch_silos_federate_through_the_port_server():
    n_clients, rounds = 3, 3
    run_id = f"torch-fed-{uuid.uuid4().hex[:6]}"
    init = eng.TorchSiloTrainer(_torch_model(0), *_mk_data(99),
                                device="cpu").get_params()
    ids = list(range(1, n_clients + 1))
    seen = {}

    def record(params, r):
        seen[r] = {k: np.array(v) for k, v in params.items()}
        return {}

    server = FedServerManager(
        FedCommManager(LoopbackTransport(0, run_id), 0), client_ids=ids,
        init_params=init, num_rounds=rounds, device="cpu", eval_fn=record)
    trainers = {cid: eng.TorchSiloTrainer(
        _torch_model(0), *_mk_data(cid - 1), lr=0.3, batch_size=16,
        epochs=1, seed=10 + cid, device="cpu") for cid in ids}
    clients = [FedClientManager(
        FedCommManager(LoopbackTransport(cid, run_id), cid), cid,
        trainers[cid]) for cid in ids]
    try:
        server.run(background=True)
        for c in clients:
            c.run(background=True)
            c.announce_ready()
        assert server.done.wait(timeout=120), "torch federation hung"
    finally:
        release_router(run_id)
    final = eng.TorchSiloTrainer(_torch_model(0), *_mk_data(0),
                                 device="cpu")
    final.set_params({k: np.asarray(v) for k, v in server.params.items()})
    accs = [final.evaluate(*_mk_data(i))["test_acc"] for i in range(3)]
    assert min(accs) > 0.75, accs
    # the first round's aggregate is the sample-weighted mean of what the
    # silos sent (every silo holds 64 rows: the plain mean)
    replay = {cid: eng.TorchSiloTrainer(
        _torch_model(0), *_mk_data(cid - 1), lr=0.3, batch_size=16,
        epochs=1, seed=10 + cid, device="cpu") for cid in ids}
    outs = [replay[c].train(init, 0)[0] for c in ids]
    assert sorted(seen) == list(range(rounds))
    for k in init:
        np.testing.assert_allclose(seen[0][k], np.mean(
            [o[k] for o in outs], axis=0), rtol=1e-6, atol=1e-7)


def test_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(RuntimeError, match="no GPU"):
        eng.TorchSiloTrainer(_torch_model(), *_mk_data(0))


def _tf_model(seed, d=8, k=3):
    import tensorflow as tf

    tf.keras.utils.set_random_seed(seed)
    return tf.keras.Sequential([
        tf.keras.Input((d,)),
        tf.keras.layers.Dense(16, activation="relu"),
        tf.keras.layers.Dense(k),
    ])


def test_tf_trainer_contract_bitwise_jax():
    x, y = _mk_data(0)
    a = eng.TFSiloTrainer(_tf_model(3), x, y, lr=0.3, batch_size=16,
                          epochs=2, seed=4)
    b = jeng.TFSiloTrainer(_tf_model(3), x, y, lr=0.3, batch_size=16,
                           epochs=2, seed=4)
    pa, pb = a.get_params(), b.get_params()
    assert list(pa) == list(pb)
    assert all(k.startswith("v00") and "/" in k for k in pa)
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k])
    assert (a.arch_fp, a.arch_desc) == (b.arch_fp, b.arch_desc)
    for r in range(2):
        pa, na, ma = a.train(pa, r)
        pb, nb, mb = b.train(pb, r)
        assert na == nb == 64 and ma == mb
        for k in pa:
            np.testing.assert_array_equal(pa[k], pb[k])
    # set_params restores exactly; another architecture is refused
    a.set_params(pb)
    for k, v in a.get_params().items():
        np.testing.assert_array_equal(v, pb[k])
    import tensorflow as tf

    other = eng.TFSiloTrainer(tf.keras.Sequential([
        tf.keras.Input((8,)), tf.keras.layers.Dense(16),
        tf.keras.layers.Dense(3, name="head")]), x, y)
    with pytest.raises(ValueError, match="architecture mismatch"):
        other.set_params(pa)
