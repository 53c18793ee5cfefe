"""Cross-silo crash durability in the port (`fedml_tpu_torch.cross_silo`):
the counterparts of `tests/test_silo_durability.py`'s non-SecAgg cases —
server checkpoint / restore with generation fencing, client rejoin,
liveness-aware selection, bounded quorum re-arms, the client's silence
watchdog, and the kill–restart soaks — on the CPU.

The soaks run in one process over loopback (`cross_silo/soak.py`: the
SIGKILL analog severs the receive loop with no farewell and leaves stale
frames in the mailboxes). The bar is the JAX package's: a killed and
resumed run ends with final params bitwise equal to an uninterrupted
run's. Every wait is on an event or a bounded poll with its own deadline.
"""
import functools
import threading
import time
import uuid

import numpy as np
import pytest
import torch

import fedml_tpu_torch
from fedml_tpu_torch.comm import FedCommManager, Message
from fedml_tpu_torch.comm.chaos import FaultSpec
from fedml_tpu_torch.comm.loopback import LoopbackTransport, release_router
from fedml_tpu_torch.config import TrainArgs
from fedml_tpu_torch.cross_silo import (
    FedClientManager, FedServerManager, SiloTrainer, message_define as md,
)
from fedml_tpu_torch.cross_silo.soak import (
    SiloSoakHarness, chaos_kill_soak, server_kill_restart_soak,
    uninterrupted_final_params,
)
from fedml_tpu_torch.models import hub
from fedml_tpu_torch.runner import FedMLRunner
from fedml_tpu_torch.utils import checkpoint as ckpt
from fedml_tpu_torch.utils import metrics as mx

torch.set_num_threads(2)
CPU = "cpu"


def _run_id(tag):
    return f"{tag}-{uuid.uuid4().hex[:8]}"


def _bitwise_equal(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(
        np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
        and np.array_equal(a[k], b[k]) for k in a)


@functools.lru_cache(maxsize=4)
def _reference(n_clients: int, rounds: int):
    params, hist = uninterrupted_final_params(n_clients=n_clients,
                                              rounds=rounds, device=CPU)
    return params, tuple(r["round"] for r in hist)


def _wait_until(pred, timeout: float) -> bool:
    end = time.monotonic() + timeout
    ev = threading.Event()
    while time.monotonic() < end:
        if pred():
            return True
        ev.wait(0.01)
    return pred()


# ------------------------------------------------------------ kill–restart
def test_server_kill_restart_ends_bitwise_equal(tmp_path):
    """Kill the server after 2 of 4 rounds (round 3 in flight), resume it
    from its checkpoint as generation 1: the run completes with full
    participation, bitwise the uninterrupted run."""
    ref, ref_rounds = _reference(2, 4)
    out = server_kill_restart_soak(str(tmp_path / "ck"), device=CPU)
    assert out["error"] is None and out["generation"] == 1
    assert out["resumes"] >= 1
    assert tuple(h["round"] for h in out["history"]) == ref_rounds
    assert all(h["n_received"] == 2 for h in out["history"])
    assert _bitwise_equal(ref, out["params"])


def test_chaos_soak_server_and_each_client_killed_once(tmp_path):
    """The chaos plan's silo_kill schedule kills the server after round 2
    and each client once; everyone restarts, and the run ends bitwise the
    uninterrupted one."""
    ref, ref_rounds = _reference(2, 4)
    out = chaos_kill_soak(FaultSpec(silo_kill={0: 2, 1: 1, 2: 3}),
                          str(tmp_path / "ckpt"), n_clients=2, rounds=4,
                          device=CPU)
    assert out["error"] is None
    assert sorted(r for r, _ in out["kills"]) == [0, 1, 2]
    assert tuple(h["round"] for h in out["history"]) == ref_rounds
    assert all(h["n_received"] == 2 for h in out["history"]), \
        f"participation dropped: {out['history']}"
    assert out["generation"] == 1 and out["resumes"] >= 1
    assert _bitwise_equal(ref, out["params"])


def test_chaos_soak_accepts_empty_schedule_and_refuses_unknown_ranks(
        tmp_path):
    out = chaos_kill_soak(FaultSpec(), str(tmp_path / "ck"), n_clients=2,
                          rounds=2, device=CPU)
    assert out["kills"] == [] and out["error"] is None
    assert [h["round"] for h in out["history"]] == [0, 1]
    with pytest.raises(ValueError, match="unknown rank"):
        chaos_kill_soak(FaultSpec(silo_kill={7: 1}), str(tmp_path / "c2"),
                        n_clients=2, rounds=2, device=CPU)


def test_generation_fencing_rejects_crafted_stale_frame(tmp_path):
    """A C2S_SEND_MODEL with the live round index but the dead
    incarnation's generation is dropped; the same frame with the live
    generation is accepted."""
    h = SiloSoakHarness(n_clients=2, rounds=3,
                        checkpoint_dir=str(tmp_path / "ckpt"),
                        server_kw=dict(round_timeout=10.0), device=CPU)
    try:
        h.start_all()
        assert h.wait_history(1, timeout=60)
        h.kill_server()
        srv = h.start_server(resume=True)
        assert srv.generation == 1
        before = mx.snapshot()["counters"].get(
            "fed.server.stale_gen_rejected", 0)

        def frame(gen):
            return (Message(md.C2S_SEND_MODEL, 1, 0)
                    .add(md.KEY_MODEL_PARAMS, h.init_params)
                    .add(md.KEY_NUM_SAMPLES, 64)
                    .add(md.KEY_ROUND, srv.round_idx)
                    .add(md.KEY_GENERATION, gen))

        live = srv.round_idx
        srv._on_model_from_client(frame(0))
        with srv._lock:
            pooled = srv.aggregator.results.get(1, (None,))[0]
        assert pooled is not h.init_params, \
            "a stale-generation model entered the aggregation pool"
        assert mx.snapshot()["counters"]["fed.server.stale_gen_rejected"] \
            >= before + 1
        # the same frame with the live generation is accepted (unless the
        # live round closed meanwhile: then its round echo is stale)
        srv._on_model_from_client(frame(srv.generation))
        with srv._lock:
            pooled = srv.aggregator.results.get(1, (None,))[0]
            assert pooled is h.init_params or srv.round_idx != live
    finally:
        h.close()


def test_resume_restores_a_simulator_checkpoint_params(tmp_path):
    """A Simulator-written checkpoint (server_state = params, opt_state,
    round, extra) restores its params subtree into the server."""
    d = str(tmp_path / "sim")
    model = hub.create("lr", 3, (8,), device=CPU)
    params = hub.init_params(model, torch.Generator().manual_seed(4))
    ckpt.save_checkpoint(d, 2, {"params": params, "opt_state": {},
                                "round": 2, "extra": None},
                         history=[{"round": r} for r in range(3)])
    run = _run_id("t-simck")
    srv = FedServerManager(
        FedCommManager(LoopbackTransport(0, run), 0), client_ids=[1, 2],
        init_params={k: np.zeros_like(v.numpy()) for k, v in params.items()},
        num_rounds=5, checkpoint_dir=d, resume=True, device=CPU)
    try:
        assert srv.round_idx == 3 and srv.generation == 1
        assert _bitwise_equal(srv.params,
                              {k: v.numpy() for k, v in params.items()})
        wrong = FedServerManager.__new__(FedServerManager)
        wrong.params = {"other": np.zeros(2, np.float32)}
        with pytest.raises(ckpt.CheckpointStructureError):
            wrong._restore(d)
    finally:
        release_router(run)


# ------------------------------------------------- liveness + rejoin paths
def test_dead_client_evicted_then_recovered_rejoins():
    """A silent client is evicted from selection after its budget (before
    init too: the round-0 handshake must not block on it); once it comes
    back, its first status re-enters it into the pool."""
    h = SiloSoakHarness(
        n_clients=3, rounds=8, device=CPU,
        server_kw=dict(round_timeout=1.5, quorum_frac=0.5,
                       liveness_timeout_s=0.9))
    try:
        h.start_server()
        for cid in (1, 2):       # client 3 absent from the start
            h.start_client(cid, heartbeat_s=0.2)
        assert h.wait_history(2, timeout=60)
        snap = mx.snapshot()["counters"]
        assert snap.get("fed.server.evicted", 0) >= 1
        assert h.server.client_online.get(3) is False
        assert 3 not in h.server.round_clients, \
            "an evicted client is still being drafted"
        rejoins_before = snap.get("fed.server.rejoins", 0)
        h.start_client(3, heartbeat_s=0.2)
        assert _wait_until(lambda: h.server.client_online.get(3) is True,
                           30), "client 3 never rejoined"
        assert mx.snapshot()["counters"]["fed.server.rejoins"] \
            >= rejoins_before + 1
        round_at_recovery = h.server.round_idx
        assert 3 in h.server._select_clients(round_at_recovery + 1)
        assert h.wait_done(timeout=60)
        post = [r for r in h.server.history
                if r["round"] > round_at_recovery]
        if post:
            assert any(r["n_received"] == 3 for r in post), \
                f"the recovered client was never selected: {h.server.history}"
    finally:
        h.close()


def test_killed_client_restarts_and_rejoins_midrun():
    h = SiloSoakHarness(n_clients=2, rounds=4, device=CPU,
                        server_kw=dict(round_timeout=5.0, quorum_frac=0.5),
                        client_kw=dict(server_timeout_s=0.5, reattach=True))
    try:
        h.start_all()
        assert h.wait_history(1, timeout=60)
        h.kill_client(2)
        h.start_client(2)
        assert h.wait_done(timeout=90)
        assert h.server.error is None
        assert [r["round"] for r in h.server.history] == list(range(4))
        assert h.server.history[-1]["n_received"] == 2
    finally:
        h.close()


# ------------------------------------------------ bounded failure surfaces
def _lr_params():
    model = hub.create("lr", 3, (8,), device=CPU)
    return {k: v.numpy() for k, v in hub.init_params(
        model, torch.Generator().manual_seed(0)).items()}


def test_quorum_unreachable_fails_loudly():
    run = _run_id("t-quorum")
    srv = FedServerManager(
        FedCommManager(LoopbackTransport(0, run), 0), client_ids=[1],
        init_params=_lr_params(), num_rounds=2, round_timeout=0.1,
        max_rearms=2, device=CPU)
    stub = FedCommManager(LoopbackTransport(1, run), 1)
    stub.register_message_receive_handler(
        md.S2C_CHECK_CLIENT_STATUS,
        lambda m: stub.send_message(
            Message(md.C2S_CLIENT_STATUS, 1, 0)
            .add(md.KEY_STATUS, md.STATUS_ONLINE)))
    for t in (md.S2C_INIT_CONFIG, md.S2C_FINISH):
        stub.register_message_receive_handler(t, lambda m: None)
    before = mx.snapshot()["counters"].get("fed.server.quorum_unreachable", 0)
    try:
        srv.run(background=True)
        stub.run(background=True)
        stub.send_message(Message(md.CONNECTION_IS_READY, 1, 0))
        assert srv.done.wait(20), "the bounded re-arm never failed the run"
        assert srv.error and "quorum unreachable" in srv.error
        assert mx.snapshot()["counters"]["fed.server.quorum_unreachable"] \
            == before + 1
    finally:
        stub.stop()
        release_router(run)


def _mk_trainer(seed=0):
    rs = np.random.RandomState(seed)
    model = hub.create("lr", 3, (8,), device="meta")
    return SiloTrainer(model, TrainArgs(epochs=1, batch_size=8),
                       rs.randn(16, 8).astype(np.float32),
                       rs.randint(0, 3, 16).astype(np.int32), seed=seed,
                       device=CPU)


def test_client_server_silence_exits_nonzero():
    run = _run_id("t-silence")
    c = FedClientManager(
        FedCommManager(LoopbackTransport(5, run), 5), 5, _mk_trainer(),
        server_timeout_s=0.3, reattach=False)
    raised = []

    def fg():
        try:
            c.run(background=False)
            raised.append(None)
        except RuntimeError as e:
            raised.append(str(e))

    th = threading.Thread(target=fg, daemon=True)
    th.start()
    c.announce_ready()
    try:
        assert c.done.wait(10), "the watchdog never fired"
        th.join(10)
        assert not th.is_alive()
        assert c.error and "server silent" in c.error
        assert raised and raised[0], "a foreground run() did not raise"
    finally:
        release_router(run)


def test_watchdog_ignores_local_training_time():
    class SlowTrainer:
        n_samples = 1

        def train(self, params, r):
            threading.Event().wait(0.7)     # local work, not silence
            return params, 1, {}

    run = _run_id("t-busy")
    c = FedClientManager(
        FedCommManager(LoopbackTransport(9, run), 9), 9, SlowTrainer(),
        server_timeout_s=0.2, reattach=False)
    try:
        c.run(background=True)
        c._on_init(Message(md.S2C_INIT_CONFIG, 0, 9)
                   .add(md.KEY_MODEL_PARAMS, {"w": np.zeros(2)})
                   .add(md.KEY_ROUND, 0))
        assert c.error is None and not c.done.is_set(), \
            f"the watchdog fired during local training: {c.error}"
    finally:
        c._stopped.set()
        c.comm.stop()
        release_router(run)


def test_client_reattach_reannounces_and_budget_refunds():
    run = _run_id("t-reattach")
    got = []
    three = threading.Event()
    stub = FedCommManager(LoopbackTransport(0, run), 0)

    def on_ready(m):
        got.append(time.monotonic())
        if len(got) >= 3:
            three.set()

    stub.register_message_receive_handler(md.CONNECTION_IS_READY, on_ready)
    stub.register_message_receive_handler(md.C2S_HEARTBEAT, lambda m: None)
    c = FedClientManager(
        FedCommManager(LoopbackTransport(7, run), 7), 7, _mk_trainer(),
        server_timeout_s=0.2, reattach=True, max_reattach=3)
    try:
        stub.run(background=True)
        c.run(background=True)
        c.announce_ready()
        assert three.wait(10), "the watchdog never re-announced"
        assert not c.done.is_set()
        assert c._reattach_count >= 2
        c._on_check_status(Message(md.S2C_CHECK_CLIENT_STATUS, 0, 7))
        assert c._reattach_count == 0
    finally:
        c._stopped.set()
        c.comm.stop()
        stub.stop()
        release_router(run)


def test_runner_wires_the_durability_knobs(tmp_path):
    run = _run_id("t-knobs")
    cfg = fedml_tpu_torch.init(config={
        "common_args": {"training_type": "cross_silo",
                        "extra": {"comm_retry": {"ack_timeout_s": 0.1},
                                  "chaos": {"seed": 1, "drop": 0.05}}},
        "train_args": {"client_num_in_total": 2, "client_num_per_round": 2,
                       "comm_round": 3, "round_timeout": 7.5,
                       "quorum_frac": 0.5, "liveness_timeout_s": 4.0,
                       "max_rearms": 3, "checkpoint_dir": str(tmp_path),
                       "checkpoint_every": 2, "checkpoint_keep": 2,
                       "server_timeout_s": 1.5, "heartbeat_s": 0.5,
                       "resume": True},
        "comm_args": {"extra": {"run_id": run}}}, device=CPU)
    model = hub.create("lr", 3, (8,), device=CPU)
    try:
        s = FedMLRunner(cfg, model=model, role="server").runner
        assert (s.round_timeout, s.quorum_frac, s.liveness_timeout_s,
                s.max_rearms, s.checkpoint_dir, s.checkpoint_every,
                s.checkpoint_keep) == (7.5, 0.5, 4.0, 3, str(tmp_path), 2,
                                       2)
        t = s.comm.transport
        assert type(t).__name__ == "ReliableTransport"
        assert type(t.inner).__name__ == "ChaosTransport"
        assert t.policy.ack_timeout_s == 0.1
        c = FedMLRunner(cfg, dataset=(np.zeros((8, 8), np.float32),
                                      np.zeros(8, np.int32)),
                        model=model, role="client", rank=1).runner
        assert (c.server_timeout_s, c.heartbeat_s, c.reattach) == \
            (1.5, 0.5, True)
        assert c.dp_upload is None
        for obj in (s, c):
            obj.comm.transport.stop_receive_message()
    finally:
        release_router(run)
