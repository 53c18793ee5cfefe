"""The port's native edge trainers (`native/edge_trainer.cpp`:
`NativeLRTrainer`, `NativeCNNTrainer`) against the JAX package's native
library, on the CPU.

The same C++ built with the same flags gives the same bits: both
trainers return bitwise JAX's parameters and losses from the same data,
parameters, seed and round. One full-batch CNN step equals one SGD step
of the port's `models/hub.py:CNN` (torch autograd) within 1e-5 of the
largest parameter, the flat vector being `flatten_params`' layout. The
trainers plug into the port's `cross_device.EdgeClient` as they are (the
dict contract), and a 3-device round with them is bitwise the JAX
package's round with its native trainers.
"""
import uuid

import jax
import numpy as np
import pytest
import torch

from fedml_tpu import native as jnative
from fedml_tpu.comm import FedCommManager as JaxComm
from fedml_tpu.comm.loopback import LoopbackTransport as JaxLoopback
from fedml_tpu.comm.loopback import release_router as jax_release
from fedml_tpu.cross_device import CrossDeviceServer as JaxCDServer
from fedml_tpu.cross_device import EdgeClient as JaxEdge
from fedml_tpu.cross_silo.secagg_manager import flatten_params as jflatten
from fedml_tpu.models import hub as jax_hub

from fedml_tpu_torch import native
from fedml_tpu_torch.comm import FedCommManager, LoopbackTransport
from fedml_tpu_torch.comm import release_router
from fedml_tpu_torch.core.algorithm import masked_softmax_ce
from fedml_tpu_torch.cross_device import CrossDeviceServer, EdgeClient
from fedml_tpu_torch.cross_silo.secagg_manager import flatten_params
from fedml_tpu_torch.models import hub

torch.set_num_threads(2)

D, K = 8, 3


def _lr_data(seed, n=96):
    rs = np.random.RandomState(seed)
    w = rs.randn(D, K)
    x = rs.randn(n, D).astype(np.float32)
    return x, np.argmax(x @ w, axis=1).astype(np.int32)


def _cnn_data(seed, n=20, hw=8, c=3, k=10):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, hw, hw, c).astype(np.float32),
            rs.randint(0, k, n).astype(np.int32))


def _cnn_flat(hw=8, c=3, k=10):
    p = jax_hub.init_params(jax_hub.create("cnn", k), (hw, hw, c),
                            jax.random.key(0))
    return jflatten(p).astype(np.float32), p


@pytest.mark.parametrize("kind", ["lr", "cnn"])
def test_trainers_bitwise_jax(kind):
    if kind == "lr":
        x, y = _lr_data(0)
        kw = dict(num_classes=K, lr=0.3, batch_size=16, epochs=2, seed=5)
        mk = (native.NativeLRTrainer, jnative.NativeLRTrainer)
        p = np.random.RandomState(1).randn(D * K + K).astype(np.float32)
    else:
        x, y = _cnn_data(0)
        kw = dict(num_classes=10, lr=0.1, batch_size=8, epochs=1, seed=2)
        mk = (native.NativeCNNTrainer, jnative.NativeCNNTrainer)
        p = _cnn_flat()[0]
    a, b = mk[0](x, y, **kw), mk[1](x, y, **kw)
    assert a.n_params == p.size
    pa, pb = p, p.copy()
    for r in range(2):
        pa, na, ma = a.train(pa, r)
        pb, nb, mb = b.train(pb, r)
        assert pa.dtype == np.float32 and np.array_equal(pa, pb)
        assert na == nb == len(x) and ma == mb
    assert not np.array_equal(pa, p)


def test_cnn_step_matches_torch_sgd():
    x, y = _cnn_data(1, n=16)
    flat, jp = _cnn_flat()
    tr = native.NativeCNNTrainer(x, y, 10, lr=0.1, batch_size=16, epochs=1)
    out, n, m = tr.train(flat, 0)
    model = hub.create("cnn", 10, (8, 8, 3), device="cpu")
    params = hub.params_from_flax(jp, device="cpu")
    fn = hub.apply_fn(model)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y).long()

    def loss(p):
        return masked_softmax_ce(fn(p, tx), ty, torch.ones(len(y)))[0]

    g, lv = torch.func.grad_and_value(loss)(params)
    want = flatten_params({k: (params[k] - 0.1 * g[k]).numpy()
                           for k in params}).astype(np.float32)
    scale = float(np.abs(want).max())
    assert float(np.abs(out - want).max()) <= 1e-5 * scale
    assert abs(m["train_loss"] - float(lv)) < 1e-5
    # the dict contract: the port's names in and out, the same step
    got, _n, _m = tr.train({k: v.numpy() for k, v in params.items()}, 0)
    assert list(got) == list(params)
    assert np.array_equal(flatten_params(got).astype(np.float32), out)


def test_bad_labels_and_shapes_refused():
    x = np.zeros((4, 6, 6, 1), np.float32)  # 6 % 4 != 0
    with pytest.raises(ValueError, match="divisible by 4"):
        native.NativeCNNTrainer(x, np.zeros(4, np.int32), 3)
    x = np.zeros((4, 8, 8, 1), np.float32)
    with pytest.raises(ValueError, match="labels"):
        native.NativeCNNTrainer(x, np.full(4, 9, np.int32), 3)
    with pytest.raises(ValueError, match="labels"):
        native.NativeLRTrainer(np.zeros((4, 2), np.float32),
                               np.array([0, 1, -1, 0]), 2)
    with pytest.raises(ValueError, match=r"x must be \[n, H, W, Cin\]"):
        native.NativeCNNTrainer(np.zeros((4, 8, 8), np.float32),
                                np.zeros(4, np.int32), 3)
    tr = native.NativeCNNTrainer(x, np.zeros(4, np.int32), 3)
    with pytest.raises(ValueError, match="params size"):
        tr.train(np.zeros(5, np.float32), 0)


class _FlatAdapter:
    """The JAX test's adapter: its EdgeClient speaks dicts, the native
    engine flat vectors."""

    def __init__(self, inner):
        self.inner, self.n_samples = inner, inner.n_samples

    def train(self, params, round_idx):
        flat = np.concatenate([np.asarray(params["w"], np.float32).ravel(),
                               np.asarray(params["b"], np.float32).ravel()])
        out, n, m = self.inner.train(flat, round_idx)
        return {"w": out[: D * K].reshape(D, K), "b": out[D * K:]}, n, m


def _round(server_cls, edge_cls, comm_cls, transport, release, trainers,
           init, **server_kw):
    run = f"nat-{uuid.uuid4().hex[:8]}"
    srv = server_cls(comm_cls(transport(0, run), 0), init_params=init,
                     num_rounds=2, devices_per_round=3, min_devices=3,
                     round_timeout=30.0, **server_kw)
    cls = [edge_cls(comm_cls(transport(d, run), d), d, trainers[d - 1])
           for d in (1, 2, 3)]
    srv.run(background=True)
    for c in cls:
        c.run(background=True)
    for c in cls:
        c.register()
    try:
        assert srv.done.wait(60) and len(srv.history) == 2
    finally:
        release(run)
    return srv


def test_cross_device_round_with_native_trainers_bitwise_jax():
    def trainers(lib, wrap=lambda t: t):
        return [wrap(lib.NativeLRTrainer(*_lr_data(d, 64 + 16 * d), K,
                                         lr=0.3, batch_size=32, seed=d))
                for d in (1, 2, 3)]

    zeros = (np.zeros((D, K), np.float32), np.zeros(K, np.float32))
    jsrv = _round(JaxCDServer, JaxEdge, JaxComm, JaxLoopback, jax_release,
                  trainers(jnative, _FlatAdapter),
                  {"w": zeros[0], "b": zeros[1]})
    srv = _round(CrossDeviceServer, EdgeClient, FedCommManager,
                 LoopbackTransport, release_router, trainers(native),
                 {"Dense_0.kernel": zeros[0], "Dense_0.bias": zeros[1]},
                 device="cpu")
    assert [h["n_received"] for h in srv.history] == [3, 3]
    assert np.array_equal(srv.params["Dense_0.kernel"], jsrv.params["w"])
    assert np.array_equal(srv.params["Dense_0.bias"], jsrv.params["b"])
    assert np.abs(srv.params["Dense_0.kernel"]).max() > 0.1
