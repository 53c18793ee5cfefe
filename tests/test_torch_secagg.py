"""SecAgg over the message layer: the port's `SecAggServerManager` /
`SecAggClientManager` (`fedml_tpu_torch.cross_silo`) against the JAX
package's and against the port's plain FedAvg, on the CPU.

The rules:
- against the JAX SecAgg federation (3 `lr` silos over loopback, the JAX
  initial parameters, the port's trainers handed the JAX trainers' batch
  draws), each round from the same params: within 1e-5 of the round's
  largest update (`tests/test_torch_cross_silo.py`'s rule for a port
  round against a JAX one) plus one quantization step, n x 2^-16 per
  coordinate (each silo's quantize can round the other way when the two
  trainings differ in the last bits);
- the unmasked aggregate is bitwise dequantize(sum quantize(vec_i n_i/N))
  / (sum n_i/N) of the silos' own trained vectors;
- against plain FedAvg (the port's `FedAggregator`, and a
  `FedServerManager` round) over the same trained results: within one
  quantization step, n x 2^-16 / (sum n_i/N) per coordinate.
"""
import functools
import json
import os
import threading
import uuid

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.comm import FedCommManager as JaxComm
from fedml_tpu.comm.loopback import LoopbackTransport as JaxLoopback
from fedml_tpu.comm.loopback import release_router as jax_release
from fedml_tpu.config import TrainArgs as JaxTrainArgs
from fedml_tpu.core.algorithm import make_batch_indices as jax_batch_indices
from fedml_tpu.cross_silo import SecAggClientManager as JaxSAClient
from fedml_tpu.cross_silo import SecAggServerManager as JaxSAServer
from fedml_tpu.cross_silo import SiloTrainer as JaxSiloTrainer
from fedml_tpu.models import hub as jax_hub
from fedml_tpu_torch.comm import (
    FedCommManager, create_transport, release_router,
)
from fedml_tpu_torch.config import TrainArgs
from fedml_tpu_torch.cross_silo import (
    FedAggregator, FedClientManager, FedServerManager, SecAggClientManager,
    SecAggServerManager, SiloTrainer,
)
from fedml_tpu_torch.cross_silo.secagg_manager import flatten_params
from fedml_tpu_torch.cross_silo.soak import secagg_server_kill_restart
from fedml_tpu_torch.models import hub
from fedml_tpu_torch.mpc.finite import DEFAULT_PRIME, dequantize, quantize

torch.set_num_threads(2)

N, ROUNDS, TOL = 3, 3, 1e-5
T = dict(epochs=1, batch_size=16, learning_rate=0.2)
STEP = 2.0 ** -16


def _run_id(tag):
    return f"{tag}-{uuid.uuid4().hex[:8]}"


def _mk_data(cid, n=48, d=8, k=3):
    rs = np.random.RandomState(cid)
    w = rs.randn(d, k)
    x = rs.randn(n + 8 * cid, d).astype(np.float32)
    y = np.argmax(x @ w, axis=1).astype(np.int32)
    return x, y


def _jax_schedule(cid, r, n):
    rng = jax.random.fold_in(jax.random.key(cid), r)
    return np.asarray(jax_batch_indices(rng, n, T["batch_size"],
                                        T["epochs"]))


def _flat(flax_tree) -> dict:
    return {k: v.numpy() for k, v in
            hub.params_from_flax(flax_tree, device="cpu").items()}


@functools.lru_cache(maxsize=None)
def _jax_run():
    """(the params before each round and after the last, flax trees) of the
    JAX SecAgg federation."""
    model = jax_hub.create("lr", 3)
    init = jax.tree.map(np.asarray, jax_hub.init_params(
        model, (8,), jax.random.key(0)))
    t = JaxTrainArgs(**T)
    run, ids = _run_id("jx-sa"), list(range(1, N + 1))
    rounds = [init]
    srv = JaxSAServer(JaxComm(JaxLoopback(0, run), 0), client_ids=ids,
                      init_params=init, num_rounds=ROUNDS,
                      eval_fn=lambda p, r: rounds.append(p) or {})
    clients = [JaxSAClient(JaxComm(JaxLoopback(c, run), c), c,
                           JaxSiloTrainer(model.apply, t, *_mk_data(c),
                                          seed=c),
                           num_clients=N, client_ids=ids) for c in ids]
    try:
        srv.run(background=True)
        for c in clients:
            c.run(background=True)
            c.announce_ready()
        assert srv.done.wait(120) and srv.error is None
    finally:
        jax_release(run)
    return rounds


class _Recording:
    """A trainer that keeps every round's (params in, result)."""

    def __init__(self, inner, die_from=None):
        self.inner, self.die_from = inner, die_from
        self.n_samples = inner.n_samples
        self.results = {}
        self.released = threading.Event()

    def train(self, params, r):
        if self.die_from is not None and r >= self.die_from:
            # the silo dies: silent until the test tears the run down
            self.released.wait()
            raise RuntimeError("a dead silo")
        out = self.inner.train(params, r)
        self.results[r] = out
        return out


def _trainer(cid, offset=0, die_from=None):
    x, y = _mk_data(cid)
    model = hub.create("lr", 3, (8,), device="meta")
    return _Recording(SiloTrainer(
        model, TrainArgs(**T), x, y, seed=cid, device="cpu",
        batch_schedule=lambda r: _jax_schedule(cid, r + offset, len(x))),
        die_from)


def _init():
    return _flat(_jax_run()[0])


def _federation(init, rounds, offset=0, codec=None, premask=None,
                round_timeout=None, dropper=None, client_cls=None,
                backend="loopback", ckpt=None):
    """A port SecAgg federation of N lr silos: (server, the silos'
    recording trainers, the params before each round and after the last).
    """
    run, ids = _run_id("pt-sa"), list(range(1, N + 1))
    mk = lambda r: FedCommManager(create_transport(  # noqa: E731
        backend, r, run, comm_codec=codec), r)
    seen = [init]
    srv = SecAggServerManager(
        mk(0), ids, init, rounds, round_timeout=round_timeout,
        eval_fn=lambda p, r: seen.append(p) or {},
        **({} if ckpt is None else dict(checkpoint_dir=ckpt)))
    trainers = {c: _trainer(c, offset, (dropper or {}).get(c)) for c in ids}
    clients = [(client_cls or {}).get(c, SecAggClientManager)(
        mk(c), c, trainers[c], num_clients=N, client_ids=ids,
        premask_ratio=premask) for c in ids]
    try:
        srv.run(background=True)
        for c in clients:
            c.run(background=True)
            c.announce_ready()
        assert srv.done.wait(120), "the secagg federation did not finish"
    finally:
        for c in clients:
            trainers[c.client_id].released.set()
            c.comm.stop()
        release_router(run)
    return srv, trainers, seen


def _max_dev(a: dict, b: dict) -> float:
    return max(float(np.abs(np.asarray(a[k], np.float64) - b[k]).max())
               for k in b)


def _quantized_mean(results: list, weight_norm: float) -> np.ndarray:
    """dequantize(sum quantize(vec_i n_i/N)) / (sum n_i/N)."""
    q = sum(quantize(flatten_params(p) * (n / weight_norm))
            for p, n, _m in results) % DEFAULT_PRIME
    wsum = sum(n for _p, n, _m in results) / weight_norm
    return dequantize(q) / max(wsum, 1e-9)


def _float_mean(results: list) -> dict:
    agg = FedAggregator(device="cpu")
    agg.reset(range(len(results)))
    for i, (p, n, _m) in enumerate(results):
        agg.add_local_trained_result(i, p, float(n))
    return agg.aggregate()


# ------------------------------------------------------------------ JAX
@pytest.mark.parametrize("r", range(ROUNDS))
def test_round_matches_jax_secagg_from_the_same_params(r):
    jr = [_flat(p) for p in _jax_run()]
    srv, _t, _s = _federation(jr[r], 1, offset=r)
    upd = _max_dev(jr[r + 1], jr[r])
    assert _max_dev(srv.params, jr[r + 1]) <= TOL * upd + N * STEP
    assert list(srv.params) == list(jr[r])


# ------------------------------------------------------------ itself
@functools.lru_cache(maxsize=None)
def _port_run():
    return _federation(_init(), ROUNDS)


def test_aggregate_is_the_quantized_sum_bitwise():
    srv, trainers, seen = _port_run()
    assert [h["n_received"] for h in srv.history] == [N] * ROUNDS
    for r in range(ROUNDS):
        res = [trainers[c].results[r] for c in sorted(trainers)]
        want = _quantized_mean(res, srv.weight_norm)
        assert np.array_equal(flatten_params(seen[r + 1]),
                              want.astype(np.float32).astype(np.float64))


def test_matches_plain_fedavg_within_a_quantization_step():
    srv, trainers, seen = _port_run()
    for r in range(ROUNDS):
        res = [trainers[c].results[r] for c in sorted(trainers)]
        assert _max_dev(seen[r + 1], _float_mean(res)) <= N * STEP
    # and a FedServerManager round from the same params and schedules
    run = _run_id("pt-plain")
    mk = lambda r: FedCommManager(create_transport(  # noqa: E731
        "loopback", r, run), r)
    plain = FedServerManager(mk(0), list(range(1, N + 1)), _init(), 1,
                             device="cpu")
    cls = [FedClientManager(mk(c), c, _trainer(c)) for c in range(1, N + 1)]
    try:
        plain.run(background=True)
        for c in cls:
            c.run(background=True)
            c.announce_ready()
        assert plain.done.wait(60) and plain.error is None
    finally:
        release_router(run)
    assert _max_dev(seen[1], plain.params) <= N * STEP


def test_server_never_retains_share_material():
    srv, _t, _s = _port_run()
    assert srv._route_buf is None
    assert not srv.unmask_sk or not any(srv.unmask_sk.values())
    assert not srv.dropped_sk


# ------------------------------------------------------------ dropout
def test_dropout_recovery_equals_fedavg_over_survivors():
    """Silo 3 dies after round 0: round_timeout fires, the server
    reconstructs its sk from the survivors' shares and strips its pairwise
    masks; rounds 1 and 2 are FedAvg over silos 1 and 2."""
    srv, trainers, seen = _federation(_init(), ROUNDS, round_timeout=2.0,
                                      dropper={3: 1})
    assert srv.error is None and len(srv.history) == ROUNDS
    assert srv.dropped_log == [(1, [3])] and 3 in srv.dropped_sk
    assert [h["n_received"] for h in srv.history] == [3, 2, 2]
    for r in range(ROUNDS):
        alive = [1, 2, 3] if r == 0 else [1, 2]
        res = [trainers[c].results[r] for c in alive]
        want = _quantized_mean(res, srv.weight_norm)
        assert np.array_equal(flatten_params(seen[r + 1]),
                              want.astype(np.float32).astype(np.float64))
        wsum = sum(n for _p, n, _m in res) / srv.weight_norm
        assert _max_dev(seen[r + 1], _float_mean(res)) \
            <= len(alive) * STEP / wsum


def test_unmask_below_quorum_fails_loudly():
    """A survivor dies between its masked upload and its share reply while
    silo 3 drops: the b-shares stay below t+1 and the run fails with the
    reason, instead of hanging."""
    class MuteUnmask(SecAggClientManager):
        def _on_unmask_req(self, msg):
            pass

    srv, _t, _s = _federation(_init(), ROUNDS, round_timeout=1.5,
                              dropper={3: 1}, client_cls={2: MuteUnmask})
    assert srv.error is not None and "unmask" in srv.error
    assert len(srv.history) == 1


# ------------------------------------------------------------ resume
def _resume_fed(ckpt, kill_after):
    run, ids = _run_id("pt-sa-kill"), list(range(1, N + 1))
    mk = lambda r: FedCommManager(create_transport(  # noqa: E731
        "loopback", r, run), r)

    def make_server(resume):
        return SecAggServerManager(mk(0), ids, _init(), ROUNDS,
                                   checkpoint_dir=ckpt, resume=resume)

    clients = [SecAggClientManager(mk(c), c, _trainer(c), num_clients=N,
                                   client_ids=ids) for c in ids]
    try:
        return secagg_server_kill_restart(make_server, clients, kill_after)
    finally:
        for c in clients:
            c.comm.stop()
        release_router(run)


def test_server_kill_and_resume_at_a_round_boundary_is_bitwise(tmp_path):
    ref, _t, _s = _port_run()
    srv = _resume_fed(str(tmp_path / "ck"), kill_after=2)
    assert srv.error is None and srv._resumed
    assert [h["round"] for h in srv.history] == list(range(ROUNDS))
    assert all(np.array_equal(srv.params[k], ref.params[k])
               for k in ref.params)


def test_resume_refuses_a_mid_round_or_foreign_checkpoint(tmp_path):
    d = str(tmp_path / "ck")
    _federation(_init(), 2, ckpt=d)
    from fedml_tpu_torch.utils.checkpoint import latest_round

    meta_path = os.path.join(d, f"round_{latest_round(d)}", "meta.json")
    meta = json.load(open(meta_path))
    run = _run_id("pt-sa-refuse")
    mk = lambda: FedCommManager(  # noqa: E731
        create_transport("loopback", 0, run), 0)
    # a boundary checkpoint resumes
    ok = SecAggServerManager(mk(), [1, 2, 3], _init(), 3,
                             checkpoint_dir=d, resume=True)
    assert ok.round_idx == 2 and ok._route_buf is None
    for field, value, match in (("phase", "masked", "round-boundary only"),
                                ("kind", "cross_silo_server",
                                 "non-secagg|cross_silo_server")):
        bad = json.loads(json.dumps(meta))
        bad["extra"][field] = value
        json.dump(bad, open(meta_path, "w"))
        with pytest.raises(ValueError, match=match):
            SecAggServerManager(mk(), [1, 2, 3], _init(), 3,
                                checkpoint_dir=d, resume=True)
    release_router(run)


# ------------------------------------------------------------ wire
def test_packed_wire_federation_bitwise_the_unpacked_one():
    """field_pack on the masked uploads and the pre-mask sparsifier: the
    final params are bitwise those of the same federation with the same
    pre-mask and no codec; the wire leg is representation only."""
    packed, *_ = _federation(_init(), 2, premask=0.25,
                             codec={"kind": "dense",
                                    "secagg_premask_ratio": 0.25})
    plain, *_ = _federation(_init(), 2, premask=0.25)
    assert all(np.array_equal(packed.params[k], plain.params[k])
               for k in plain.params)
