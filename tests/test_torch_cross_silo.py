"""Cross-silo FedAvg over the message layer: the port's server and client
managers and `SiloTrainer` (`fedml_tpu_torch.cross_silo`) against the JAX
package's, on the CPU.

Both federations run over loopback threads from the same data and initial
parameters (flax's, converted by `hub.params_from_flax`), the port's
trainers handed the JAX trainers' batch draws (`fold_in(key(client id),
round)` -> `make_batch_indices`): the final params agree within 1e-5 of
the largest update (f32), and the history rows (round, n_received) are
equal. Client sampling is bitwise the JAX server's `_select_clients`, the
upload DP equals the JAX client's fed the same noise, and `FedMLRunner`
wires both roles. The `gpu` cases hold the card's runs to the CPU's
(1e-3 of the largest update, the repo's rule for a card-vs-CPU round) and
to themselves, bitwise (repeat, kill and resume, chaos with retries).
"""
import functools
import time
import uuid

import numpy as np
import pytest
import torch

try:
    import jax

    from fedml_tpu.comm import FedCommManager as JaxComm
    from fedml_tpu.comm.loopback import LoopbackTransport as JaxLoopback
    from fedml_tpu.comm.loopback import release_router as jax_release
    from fedml_tpu.config import Config as JaxConfig
    from fedml_tpu.config import TrainArgs as JaxTrainArgs
    from fedml_tpu.core.algorithm import (
        make_batch_indices as jax_batch_indices,
    )
    from fedml_tpu.cross_silo import FedClientManager as JaxClient
    from fedml_tpu.cross_silo import FedServerManager as JaxServer
    from fedml_tpu.cross_silo import SiloTrainer as JaxSiloTrainer
    from fedml_tpu.dp import make_upload_dp as jax_make_upload_dp
    from fedml_tpu.models import hub as jax_hub
except ModuleNotFoundError:
    # the machine with the card has no flax: only the `gpu` cases run there
    pass

import fedml_tpu_torch
from fedml_tpu_torch.comm import (
    FedCommManager, LoopbackTransport, Message, create_transport,
    release_router,
)
from fedml_tpu_torch.comm.loopback import JitterLoopbackTransport
from fedml_tpu_torch.config import Config, TrainArgs
from fedml_tpu_torch.cross_silo import (
    FedClientManager, FedServerManager, SiloTrainer, message_define as md,
)
from fedml_tpu_torch.cross_silo.soak import (
    SiloSoakHarness, server_kill_restart_soak, uninterrupted_final_params,
)
from fedml_tpu_torch.dp import make_upload_dp
from fedml_tpu_torch.models import hub
from fedml_tpu_torch.runner import FedMLRunner

torch.set_num_threads(2)

TOL = 1e-5        # max |param diff| over the largest update, f32, CPU
CARD_TOL = 1e-3   # the card's round against the CPU's
# (model, classes, input shape, silos, silos a round, rounds, train args)
FEDS = {
    "lr": ("lr", 3, (8,), 3, 2, 3,
           dict(epochs=2, batch_size=16, learning_rate=0.3)),
    "cnn": ("cnn", 4, (8, 8, 1), 2, 2, 2,
            dict(epochs=1, batch_size=8, learning_rate=0.05)),
}


def _run_id(tag):
    return f"{tag}-{uuid.uuid4().hex[:8]}"


def _silo_data(name, cid):
    _m, k, shape, *_ = FEDS[name]
    rs = np.random.RandomState(100 + cid)
    n = 40 + 8 * cid
    x = rs.randn(n, *shape).astype(np.float32)
    w = rs.randn(int(np.prod(shape)), k)
    y = np.argmax(x.reshape(n, -1) @ w, axis=1).astype(np.int32)
    return x, y


def _jax_schedule(cid, r, n, t):
    """The JAX trainer's batch order for client `cid`, round `r`."""
    rng = jax.random.fold_in(jax.random.key(cid), r)
    return np.asarray(jax_batch_indices(rng, n, t["batch_size"],
                                        t["epochs"]))


def _numpy_schedule(cid, r, n, t):
    """A batch order from numpy's generator (the `gpu` cases: the machine
    with the card has no flax)."""
    bs = min(t["batch_size"], n)
    rs = np.random.RandomState(1000 * cid + r)
    return np.concatenate([rs.permutation(n)[:n // bs * bs]
                           for _ in range(t["epochs"])]).reshape(-1, bs)


def _drive(server, clients, timeout=120, clients_must_finish=True):
    """Run a federation to its end. Under a chaos plan a dropped
    S2C_FINISH is never resent (the server stops its transport after
    sending it, as the JAX server does: ROADMAP C.5), so there a client
    may be left running; it is stopped here."""
    server.run(background=True)
    for c in clients:
        c.run(background=True)
        c.announce_ready()
    assert server.done.wait(timeout), "the federation did not finish"
    try:
        for c in clients:
            assert c.done.wait(30 if clients_must_finish else 2) \
                or not clients_must_finish
        assert server.error is None
    finally:
        for c in clients:
            if not c.done.is_set():
                c._stopped.set()
                c.comm.stop()
    return server


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """(initial flax params, final flax params, history) of the JAX
    federation."""
    model_name, k, shape, n, m, rounds, t = FEDS[name]
    model = jax_hub.create(model_name, k)
    params = jax.tree.map(np.asarray, jax_hub.init_params(
        model, shape, jax.random.key(0)))
    targs = JaxTrainArgs(client_num_in_total=n, client_num_per_round=m,
                         comm_round=rounds, **t)
    run = _run_id(f"jx-{name}")
    srv = JaxServer(JaxComm(JaxLoopback(0, run), 0),
                    client_ids=list(range(1, n + 1)), init_params=params,
                    num_rounds=rounds, client_num_per_round=m, sample_seed=3)
    clients = [JaxClient(JaxComm(JaxLoopback(c, run), c), c, JaxSiloTrainer(
        model.apply, targs, *_silo_data(name, c), seed=c))
        for c in range(1, n + 1)]
    try:
        _drive(srv, clients)
    finally:
        jax_release(run)
    return params, srv.params, srv.history


def _flat(flax_tree) -> dict:
    return {k: v.numpy() for k, v in
            hub.params_from_flax(flax_tree, device="cpu").items()}


def _port_run(name, device="cpu", chaos=None, comm_retry=None,
              init=None, jitter_seed=None, schedule=None):
    model_name, k, shape, n, m, rounds, t = FEDS[name]
    model = hub.create(model_name, k, shape, device="meta")
    targs = TrainArgs(client_num_in_total=n, client_num_per_round=m,
                      comm_round=rounds, **t)
    run = _run_id(f"pt-{name}")
    if jitter_seed is None:
        mk = lambda r: FedCommManager(create_transport(  # noqa: E731
            "loopback", r, run, chaos=chaos, comm_retry=comm_retry), r)
    else:
        mk = lambda r: FedCommManager(JitterLoopbackTransport(  # noqa: E731
            r, run, seed=jitter_seed, max_delay=0.01), r)
    srv = FedServerManager(mk(0), client_ids=list(range(1, n + 1)),
                           init_params=init, num_rounds=rounds,
                           client_num_per_round=m, sample_seed=3,
                           device=device)

    def trainer(c):
        x, y = _silo_data(name, c)
        return SiloTrainer(model, targs, x, y, seed=c, device=device,
                           batch_schedule=lambda r, c=c, n_=len(x):
                           (schedule or _jax_schedule)(c, r, n_, t))

    clients = [FedClientManager(mk(c), c, trainer(c))
               for c in range(1, n + 1)]
    try:
        _drive(srv, clients, clients_must_finish=chaos is None)
    finally:
        release_router(run)
    return srv


def _max_rel(got: dict, want: dict, init: dict) -> float:
    upd = max(float(np.abs(want[k] - init[k]).max()) for k in want)
    return max(float(np.abs(np.asarray(got[k], np.float64) - want[k]).max())
               for k in want) / upd


@pytest.mark.parametrize("name", sorted(FEDS))
def test_federation_matches_jax(name):
    init, final, hist = _jax_run(name)
    srv = _port_run(name, init=_flat(init))
    assert [(r["round"], r["n_received"]) for r in srv.history] == \
        [(r["round"], r["n_received"]) for r in hist]
    assert sorted(srv.params) == sorted(_flat(final))
    assert _max_rel(srv.params, _flat(final), _flat(init)) <= TOL


def test_arrival_order_does_not_change_the_result():
    """Seeded per-send jitter reorders arrivals across ranks (each
    sender's FIFO kept): two seeds, the same final params bitwise."""
    init = _flat(_jax_run("lr")[0])
    a, b = (_port_run("lr", init=init, jitter_seed=s) for s in (1, 2))
    assert all(np.array_equal(a.params[k], b.params[k]) for k in a.params)
    assert a.history == b.history


def _jax_server(ids, m, seed):
    run = _run_id("jx-sel")
    return JaxServer(JaxComm(JaxLoopback(0, run), 0), client_ids=ids,
                     init_params={"w": np.zeros(1, np.float32)},
                     num_rounds=1, client_num_per_round=m,
                     sample_seed=seed), run


def test_client_sampling_bitwise_equal_jax():
    ids = list(range(1, 31))
    for m, seed in ((7, 0), (12, 5), (30, 1)):
        js, run = _jax_server(ids, m, seed)
        ps = FedServerManager(
            FedCommManager(LoopbackTransport(0, _run_id("pt-sel")), 0),
            client_ids=ids, init_params={"w": np.zeros(1, np.float32)},
            num_rounds=1, client_num_per_round=m, sample_seed=seed,
            device="cpu")
        for r in range(25):
            assert ps._select_clients(r) == js._select_clients(r)
        # evicted clients leave both pools alike
        for srv in (js, ps):
            srv.client_online.update({3: False, 8: False, 21: False})
        for r in range(10):
            assert ps._select_clients(r) == js._select_clients(r)
        jax_release(run)


def _lr_trainer(device="cpu", schedule=None):
    model = hub.create("lr", 3, (8,), device="meta")
    x, y = _silo_data("lr", 1)
    return SiloTrainer(model, TrainArgs(epochs=1, batch_size=16), x, y,
                       seed=1, device=device, batch_schedule=schedule)


def test_rejoin_memo_returns_cached_result():
    tr = _lr_trainer()
    params = _flat(_jax_run("lr")[0])
    first = tr.train(params, 2)
    again = tr.train({k: v.copy() for k, v in params.items()}, 2)
    assert again is first, "a bit-identical re-send retrained"
    moved = dict(params, **{"Dense_0.bias": params["Dense_0.bias"] + 1e-3})
    other = tr.train(moved, 2)
    assert other is not first
    assert tr.train(params, 3) is not first


def test_trainer_batch_order_is_keyed_by_seed_and_round():
    tr = _lr_trainer()
    a, b = tr.batch_indices(4), tr.batch_indices(4)
    assert torch.equal(a, b) and not torch.equal(a, tr.batch_indices(5))
    assert a.shape == (tr.n_samples // 16, 16)


def _noise_like(tree_leaves_by_name, scale):
    rs = np.random.RandomState(9)
    return {k: (scale * rs.randn(*v.shape)).astype(np.float32)
            for k, v in tree_leaves_by_name.items()}


def test_dp_upload_matches_jax_fed_the_same_noise():
    """LDP on the client's upload (clip the update, add noise, add back),
    with each package's noise draw replaced by the same numpy noise."""
    d = {"dp_args": {"enable_dp": True, "dp_solution_type": "ldp",
                     "mechanism_type": "gaussian", "clipping_norm": 0.5,
                     "epsilon": 1.0, "sensitivity": 1.0},
         "train_args": {"client_num_in_total": 3,
                        "client_num_per_round": 3}}
    init, final, _ = _jax_run("lr")
    base_f, new_f = _flat(init), _flat(final)
    noise = _noise_like(base_f, 0.01)
    jdp = jax_make_upload_dp(JaxConfig.from_dict(d), seed=1)
    pdp = make_upload_dp(Config.from_dict(d), seed=1)
    jdp.dp._noise = lambda rng, t, s: jax.tree.map(
        lambda a, n: a + n, t, {"Dense_0": {"kernel": noise["Dense_0.kernel"],
                                            "bias": noise["Dense_0.bias"]}})
    pdp.dp._noise = lambda gen, t, s: {
        k: v + torch.from_numpy(noise[k]) for k, v in t.items()}
    want = _flat(jdp.apply(final, init, 0))
    got = pdp.apply(new_f, base_f, 0)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=1e-6)
    assert pdp.epsilon() == pytest.approx(jdp.epsilon(), rel=1e-9)


def test_client_applies_dp_upload_before_the_send():
    sent = []

    class Comm:
        def register_message_receive_handler(self, *a):
            pass

        def send_message(self, msg):
            sent.append(msg)

    class Upload:
        def apply(self, new, base, r):
            return {k: v + 1.0 for k, v in new.items()}

    tr = _lr_trainer()
    params = _flat(_jax_run("lr")[0])
    c = FedClientManager(Comm(), 1, tr, dp_upload=Upload())
    c._on_init(Message(md.S2C_INIT_CONFIG, 0, 1)
               .add(md.KEY_MODEL_PARAMS, params).add(md.KEY_ROUND, 0)
               .add(md.KEY_GENERATION, 2))
    (out,) = sent
    trained = tr.train(params, 0)[0]
    for k in params:
        np.testing.assert_array_equal(out.get(md.KEY_MODEL_PARAMS)[k],
                                      trained[k] + 1.0)
    assert (out.get(md.KEY_ROUND), out.get(md.KEY_GENERATION)) == (0, 2)


def _runner_cfg(run, device="cpu", **extra):
    return fedml_tpu_torch.init(config={
        "common_args": {"training_type": "cross_silo", "random_seed": 0},
        "train_args": {"client_num_in_total": 3, "client_num_per_round": 3,
                       "comm_round": 2, "epochs": 1, "batch_size": 16,
                       "learning_rate": 0.3, **extra},
        "comm_args": {"extra": {"run_id": run}}}, device=device)


def test_runner_wires_both_roles():
    run = _run_id("t-runner")
    cfg = _runner_cfg(run)
    model = hub.create("lr", 3, (8,), device="cpu")
    srv = FedMLRunner(cfg, model=model, role="server")
    gen = torch.Generator().manual_seed(0)
    want = hub.init_params(model, gen)
    assert isinstance(srv.runner, FedServerManager)
    for k in want:
        np.testing.assert_array_equal(srv.runner.params[k], want[k].numpy())
    clients = [FedMLRunner(cfg, dataset=_silo_data("lr", c), model=model,
                           role="client", rank=c) for c in (1, 2, 3)]
    assert all(isinstance(c.runner, FedClientManager) for c in clients)
    assert clients[1].runner.trainer.seed == 2
    try:
        _drive(srv.runner, [c.runner for c in clients])
        assert [r["n_received"] for r in srv.runner.history] == [3, 3]
    finally:
        release_router(run)


def test_runner_simulation_branch(tmp_path):
    """`training_type: simulation` runs the Simulator: the runner's history
    is a direct `run_simulation`'s; async simulation is refused."""
    d = {"data_args": {"dataset": "synthetic",
                       "data_cache_dir": str(tmp_path),
                       "extra": {"synthetic_samples_per_client": 16}},
         "model_args": {"model": "lr"},
         "train_args": {"client_num_in_total": 4, "client_num_per_round": 4,
                        "comm_round": 2, "batch_size": 8},
         "validation_args": {"frequency_of_the_test": 0},
         "comm_args": {"backend": "sp"}}
    r = FedMLRunner(fedml_tpu_torch.init(config=d, device="cpu"))
    assert r.run() == fedml_tpu_torch.run_simulation(
        fedml_tpu_torch.init(config=d, device="cpu"))
    d["train_args"]["async"] = True
    with pytest.raises(NotImplementedError, match="item 5"):
        FedMLRunner(fedml_tpu_torch.init(config=d, device="cpu"))


def test_runner_params_keyword_and_refusals():
    run = _run_id("t-refuse")
    cfg = _runner_cfg(run)
    p = {"Dense_0.kernel": np.ones((8, 3), np.float32),
         "Dense_0.bias": np.zeros(3, np.float32)}
    srv = FedMLRunner(cfg, role="server", params=p)
    assert srv.runner.params["Dense_0.kernel"].sum() == 24
    for over, item in (
            ({"train_args": {"secagg": True}}, "item 5"),
            ({"common_args": {"scenario": "hierarchical"}}, "item 4"),
            ({"comm_args": {"comm_codec": {"kind": "dense"}}}, "item 5"),
            ({"comm_args": {"transport": "grpc"}}, "item 5"),
            ({"comm_args": {"transport": "broker"}}, "item 5"),
            ({"train_args": {"fa_task": "avg"}}, "item 5"),
            ({"common_args": {"training_type": "cross_device"}}, "item 5"),
            ({"common_args": {"training_type": "centralized"}}, "item 5"),
            ({"tracking_args": {"artifact_dir": "/x"}}, "item 5")):
        c = _runner_cfg(run)
        for sec, kv in over.items():
            for k, v in kv.items():
                obj = getattr(c, sec)
                setattr(obj, k, v) if hasattr(obj, k) else \
                    obj.extra.__setitem__(k, v)
        with pytest.raises(NotImplementedError, match=item):
            FedMLRunner(c, model=hub.create("lr", 3, (8,), device="meta"),
                        role="server", params=p)
    with pytest.raises(NotImplementedError, match="item 4"):
        FedMLRunner(cfg, dataset=_silo_data("lr", 1),
                    model=hub.create("lr", 3, (8,), device="meta"),
                    role="client", rank=1, mesh=object())
    with pytest.raises(NotImplementedError, match="artifact"):
        fedml_tpu_torch.init(config={"tracking_args": {
            "artifact_store": "file"}}, device="cpu")
    release_router(run)


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = hub.create("lr", 3, (8,), device="meta")
    x, y = _silo_data("lr", 1)
    with pytest.raises(RuntimeError, match="no GPU"):
        SiloTrainer(model, TrainArgs(), x, y)
    run = _run_id("t-cuda")
    with pytest.raises(RuntimeError, match="no GPU"):
        FedServerManager(FedCommManager(LoopbackTransport(0, run), 0),
                         client_ids=[1], init_params={}, num_rounds=1)
    cfg = Config.from_dict({"common_args": {"training_type": "cross_silo"},
                            "comm_args": {"extra": {"run_id": run}}})
    with pytest.raises(RuntimeError, match="no GPU"):
        FedMLRunner(cfg, role="server", params={})
    with pytest.raises(RuntimeError, match="no GPU"):
        SiloSoakHarness()
    release_router(run)


def test_server_records_one_round_span_per_round():
    """Each round leaves one `round` span, from its broadcast to its
    close, with the aggregate's ms and the round's wire work in it."""
    from fedml_tpu_torch.utils.events import recorder

    _m, _k, _s, _n, m, rounds, _t = FEDS["lr"]
    t0 = time.perf_counter()
    srv = _port_run("lr", init=_card_params("lr"), schedule=_numpy_schedule)
    spans = [s for s in list(recorder.spans)
             if s.name == "round" and s.start >= t0]
    assert [s.meta["round"] for s in spans] == list(range(rounds))
    assert [s.meta["n_received"] for s in spans] == \
        [r["n_received"] for r in srv.history]
    for a, b in zip(spans, spans[1:]):
        assert a.end <= b.start
    for s in spans:
        assert s.meta["agg_ms"] > 0 and s.duration * 1e3 > s.meta["agg_ms"]
        w = s.meta["wire"]
        # the round's m model frames out and m back, at least
        assert w["frames_sent"] >= 2 * m and w["bytes_sent"] > 0
        assert w["serialize_s"] > 0 and w["deserialize_s"] > 0


def test_span_ring_counts_what_it_evicts():
    """A full ring evicts its oldest span and counts it, through `span`
    and `record` alike; the default ring holds the JAX recorder's cap,
    which a 100-silo federation's start-up handshake (~4 x 100^2 status
    spans) fits in."""
    from fedml_tpu_torch.utils.events import (DEFAULT_EVENTS_CAP, EventRecorder,
                                              Span)

    assert EventRecorder().spans.maxlen == DEFAULT_EVENTS_CAP == 100_000
    rec = EventRecorder(max_rows=3)
    for i in range(4):
        with rec.span("s", i=i):
            pass
    rec.record(Span("r", 0.0, 1.0))
    assert rec.dropped == 2
    assert [s.meta.get("i") for s in rec.spans] == [2, 3, None]


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: these hold the card's cross-silo "
                    "runs to the CPU's and to themselves")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return "cuda"


def _card_params(name):
    model_name, k, shape, *_ = FEDS[name]
    gen = torch.Generator().manual_seed(0)
    return {k_: v.numpy() for k_, v in hub.init_params(
        hub.create(model_name, k, shape, device="cpu"), gen).items()}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(FEDS))
def test_card_federation_matches_cpu(cuda, name):
    init = _card_params(name)
    cpu = _port_run(name, init=init, schedule=_numpy_schedule).params
    card = _port_run(name, device=cuda, init=init,
                     schedule=_numpy_schedule).params
    assert _max_rel(card, cpu, init) <= CARD_TOL


@pytest.mark.gpu
def test_card_federation_repeats_bitwise(cuda):
    init = _card_params("cnn")
    a = _port_run("cnn", device=cuda, init=init,
                  schedule=_numpy_schedule).params
    b = _port_run("cnn", device=cuda, init=init,
                  schedule=_numpy_schedule).params
    assert all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.gpu
def test_card_kill_restart_bitwise(cuda, tmp_path):
    ref, _ = uninterrupted_final_params(device=cuda)
    out = server_kill_restart_soak(str(tmp_path / "ck"), device=cuda)
    assert out["error"] is None and out["generation"] == 1
    assert all(np.array_equal(ref[k], out["params"][k]) for k in ref)


@pytest.mark.gpu
def test_card_chaos_with_retries_bitwise(cuda):
    init = _card_params("cnn")
    clean = _port_run("cnn", device=cuda, init=init,
                      schedule=_numpy_schedule).params
    srv = _port_run("cnn", device=cuda, init=init, schedule=_numpy_schedule,
                    chaos=dict(seed=3, drop=0.1, duplicate=0.1,
                               reorder=0.1, delay_max_s=0.05),
                    comm_retry={"ack_timeout_s": 0.2, "max_attempts": 20})
    assert all(r["n_received"] == FEDS["cnn"][4] for r in srv.history)
    assert all(np.array_equal(clean[k], srv.params[k]) for k in clean)
