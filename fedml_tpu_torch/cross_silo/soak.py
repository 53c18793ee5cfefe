"""Kill–restart soak harness for the cross-silo federation (port of
`fedml_tpu/cross_silo/soak.py`).

The chaos plane (`comm/chaos.py`) injects link faults under a live
process; this harness injects process death: it runs a whole federation
in one process over loopback threads and severs a role the way SIGKILL
would (receive loop cut at the transport, timers cancelled, no farewell,
no final checkpoint), then restarts it as a fresh manager on the same
rank. The loopback mailboxes keep the frames in flight, like a dead
process's unread sockets, so stale pre-restart traffic (the generation
fence's target) occurs naturally. Kill schedules can ride the chaos
plan's `FaultSpec.silo_kill = {rank: round}` (rank 0 is the server).

The federation is the JAX harness's default one: logistic regression over 8
features and 3 classes, 64 seeded samples a client, 2 epochs of batch 16
at lr 0.3. Its initial parameters are drawn by `hub.init_params` from a
`torch.Generator` seeded with `seed` (not JAX's key), so the final params
compare bitwise within the port, not with the JAX harness's. Every role
runs on `device` (None: CUDA, raising without a GPU). `init_params` +
`trainer_factory` (+ `train_args`) swap in another federation, as in the
JAX harness: the live loop (`soak/loop.py`) trains the serving model's
LoRA adapter dict here.
"""
from __future__ import annotations

import time
import uuid
from typing import Any, Callable, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..comm import FedCommManager
from ..comm.loopback import LoopbackTransport, release_router
from ..config import TrainArgs
from ..models import hub
from ..utils import metrics as _mx
from ..utils.postmortem import record_kill
from .client import FedClientManager
from .server import FedServerManager
from .trainer import SiloTrainer


def _client_data(seed: int, n: int = 64, d: int = 8, classes: int = 3):
    rs = np.random.RandomState(seed)
    w_true = rs.randn(d, classes)
    x = rs.randn(n, d).astype(np.float32)
    y = np.argmax(x @ w_true, axis=1).astype(np.int32)
    return x, y


def sever_server(srv) -> None:
    """Kill a server manager (plain or SecAgg) the way SIGKILL would: cut
    the receive loop, wait for the pump thread to wind down, then cancel
    the timers (in that order: an in-flight handler may still finish its
    transition and re-arm the round timer, which must not outlive the
    incarnation). No FINISH, no checkpoint flush."""
    srv.comm.transport.stop_receive_message()
    th = srv.comm._thread
    if th is not None:
        th.join(timeout=10)
    with srv._lock:
        srv._cancel_timer()
        liveness = getattr(srv, "_liveness_timer", None)
        if liveness is not None:
            liveness.cancel()
    _mx.inc("fed.chaos.silo_kills")
    record_kill("server rank 0")


class SiloSoakHarness:
    """One in-process federation: a server and `n_clients` clients on a
    private loopback namespace, each startable, killable and restartable
    on its own. Deterministic end to end (seeded data, round-keyed batch
    orders, sorted-id aggregation), so the final params of two runs with
    the same participation compare bitwise."""

    def __init__(self, n_clients: int = 2, rounds: int = 4,
                 checkpoint_dir: Optional[str] = None, seed: int = 0,
                 run_id: Optional[str] = None,
                 server_kw: Optional[dict] = None,
                 client_kw: Optional[dict] = None,
                 comm_codec: Optional[dict] = None,
                 init_params=None, trainer_factory=None,
                 train_args: Optional[TrainArgs] = None, device=None):
        self.n_clients = n_clients
        self.rounds = rounds
        self.checkpoint_dir = checkpoint_dir
        self.run_id = run_id or f"soak-{uuid.uuid4().hex[:8]}"
        self.server_kw = dict(server_kw or {})
        self.client_kw = dict(client_kw or {})
        # every (re)started rank gets a fresh CodecPolicy: anchor rings and
        # error-feedback residuals die with the process; the next dense
        # broadcast re-anchors and stale delta frames are loud-dropped
        self.comm_codec = comm_codec
        self.device = resolve_device(device)
        # the live loop's override points: the federation can be ANY
        # (init_params, per-client trainer) pairing; the defaults keep the
        # lr federation of the durability soaks
        self._trainer_factory = trainer_factory
        self.targs = train_args or TrainArgs(
            epochs=2, batch_size=16, learning_rate=0.3,
            client_num_in_total=n_clients, client_num_per_round=n_clients,
            comm_round=rounds)
        if init_params is not None:
            if trainer_factory is None:
                raise ValueError(
                    "SiloSoakHarness(init_params=...) requires "
                    "trainer_factory — the default lr trainers would "
                    "train a model those params do not fit")
            self.model = None
            self.init_params = init_params
        else:
            self.model = hub.create("lr", 3, (8,), device=self.device)
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            self.init_params = {k: v.cpu().numpy() for k, v in
                                hub.init_params(self.model, gen).items()}
        self.server: Optional[FedServerManager] = None
        self.clients: dict[int, FedClientManager] = {}
        self._dead = []          # killed managers, kept so threads can drain

    # ------------------------------------------------------------- plumbing
    def _comm(self, rank: int) -> FedCommManager:
        t = LoopbackTransport(rank, self.run_id)
        if self.comm_codec is not None:
            from ..comm.codec import CodecPolicy

            t.set_codec(CodecPolicy.from_config(self.comm_codec))
        return FedCommManager(t, rank)

    def _trainer(self, cid: int) -> SiloTrainer:
        if self._trainer_factory is not None:
            return self._trainer_factory(cid)
        x, y = _client_data(cid)
        return SiloTrainer(self.model, self.targs, x, y, seed=cid,
                           device=self.device)

    # --------------------------------------------------------------- roles
    def start_server(self, resume: bool = False, **over) -> FedServerManager:
        kw = dict(self.server_kw)
        kw.update(over)
        if self.checkpoint_dir is not None:
            kw.setdefault("checkpoint_dir", self.checkpoint_dir)
            kw.setdefault("checkpoint_every", 1)
        self.server = FedServerManager(
            self._comm(0), client_ids=list(range(1, self.n_clients + 1)),
            init_params=self.init_params, num_rounds=self.rounds,
            resume=resume, device=self.device, **kw)
        self.server.run(background=True)
        return self.server

    def start_client(self, cid: int, **over) -> FedClientManager:
        kw = dict(self.client_kw)
        kw.update(over)
        c = FedClientManager(self._comm(cid), cid, self._trainer(cid), **kw)
        self.clients[cid] = c
        c.run(background=True)
        c.announce_ready()
        return c

    def start_all(self) -> "SiloSoakHarness":
        self.start_server()
        for cid in range(1, self.n_clients + 1):
            self.start_client(cid)
        return self

    # ---------------------------------------------------------------- kills
    def kill_server(self) -> None:
        """The in-process SIGKILL analog: sever the receive loop, wait for
        the pump thread to wind down, then cancel the timers (in that
        order: an in-flight handler may still finish its transition and
        re-arm the round timer, which must not outlive the incarnation).
        No FINISH, no checkpoint flush."""
        srv = self.server
        assert srv is not None
        sever_server(srv)
        self._dead.append(srv)
        self.server = None

    def kill_client(self, cid: int) -> None:
        c = self.clients.pop(cid)
        c._stopped.set()                 # halt heartbeat/watchdog loops
        c.comm.transport.stop_receive_message()
        th = c.comm._thread
        if th is not None:
            th.join(timeout=10)
        _mx.inc("fed.chaos.silo_kills")
        record_kill(f"client rank {cid}")
        self._dead.append(c)

    # ------------------------------------------------------------- helpers
    def wait_history(self, n: int, timeout: float = 60.0) -> bool:
        """Block until the live server has completed >= n rounds."""
        end = time.monotonic() + timeout
        while time.monotonic() < end:
            srv = self.server
            if srv is not None and len(srv.history) >= n:
                return True
            time.sleep(0.01)
        return False

    def wait_done(self, timeout: float = 120.0) -> bool:
        srv = self.server
        assert srv is not None
        ok = srv.done.wait(timeout)
        for c in self.clients.values():
            c.done.wait(5)
        return ok

    def close(self) -> None:
        for obj in ([self.server] if self.server else []) \
                + list(self.clients.values()):
            try:
                if isinstance(obj, FedServerManager):
                    obj._cancel_timer()
                    if obj._liveness_timer is not None:
                        obj._liveness_timer.cancel()
                else:
                    obj._stopped.set()
                obj.comm.stop()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        release_router(self.run_id)


def uninterrupted_final_params(n_clients: int = 2, rounds: int = 4,
                               seed: int = 0, device=None):
    """Reference run: the same federation, no faults. Returns (params,
    history); the soaks' bitwise bar compares against it."""
    h = SiloSoakHarness(n_clients=n_clients, rounds=rounds, seed=seed,
                        device=device)
    try:
        h.start_all()
        if not h.wait_done(timeout=120):
            raise TimeoutError("uninterrupted reference run did not finish")
        return h.server.params, list(h.server.history)
    finally:
        h.close()


def _counters(srv: FedServerManager) -> dict:
    snap = _mx.snapshot()["counters"]
    return {
        "params": srv.params,
        "history": list(srv.history),
        "error": srv.error,
        "generation": srv.generation,
        "resumes": int(snap.get("fed.server.resumes", 0)),
        "stale_gen_rejected": int(
            snap.get("fed.server.stale_gen_rejected", 0)),
    }


def chaos_kill_soak(spec, checkpoint_dir: str, n_clients: int = 2,
                    rounds: int = 5, seed: int = 0,
                    server_timeout_s: float = 0.5,
                    timeout: float = 180.0, device=None,
                    comm_codec: Optional[dict] = None) -> dict:
    """Drive a federation under a `FaultSpec.silo_kill` schedule ({rank:
    round}, rank 0 the server): each scheduled rank is severed once the run
    has completed that many rounds, then restarted (the server with
    `resume=True`, a client as a fresh manager on its rank). Kills land at
    round boundaries, where each scheduled client is idle between its
    upload and the next sync, so a full-participation run stays full and
    its final params compare bitwise with an uninterrupted run's.
    `comm_codec` runs the same soak over compressed frames."""
    kills = dict(spec.silo_kill) if hasattr(spec, "silo_kill") \
        else dict(spec or {})
    if hasattr(spec, "validate_tiers"):
        spec.validate_tiers(silo_ranks=range(n_clients + 1))
    h = SiloSoakHarness(
        n_clients=n_clients, rounds=rounds, checkpoint_dir=checkpoint_dir,
        seed=seed, device=device, comm_codec=comm_codec,
        server_kw=dict(round_timeout=10.0, quorum_frac=1.0),
        # a generous re-attach budget: on a loaded box the restarted
        # server's restore can take seconds, and a client that spends its
        # budget in that window is gone for good
        client_kw=dict(server_timeout_s=server_timeout_s, reattach=True,
                       max_reattach=120))
    try:
        h.start_all()
        pending = sorted(kills.items(), key=lambda kv: (kv[1], kv[0]))
        executed = []
        end = time.monotonic() + timeout
        while time.monotonic() < end:
            srv = h.server
            done_rounds = len(srv.history) if srv is not None else 0
            fired = False
            for rank, after in list(pending):
                if srv is None or done_rounds < after:
                    continue
                pending.remove((rank, after))
                executed.append((rank, after))
                if rank == 0:
                    h.kill_server()
                    h.start_server(resume=True)
                else:
                    h.kill_client(rank)
                    h.start_client(rank)
                fired = True
                break       # one kill per poll; re-read state
            if not fired:
                if not pending and h.server is not None \
                        and h.server.done.wait(0.05):
                    break
                time.sleep(0.01)
        srv = h.server
        if srv is None or not srv.done.is_set():
            raise TimeoutError(
                f"chaos soak did not finish (kills executed: {executed}, "
                f"pending: {pending})")
        for c in h.clients.values():
            c.done.wait(10)
        return {**_counters(srv), "kills": executed}
    finally:
        h.close()


def server_kill_restart_soak(checkpoint_dir: str, n_clients: int = 2,
                             rounds: int = 4, kill_after: int = 2,
                             seed: int = 0, server_timeout_s: float = 0.5,
                             device=None) -> dict:
    """The headline soak: kill the server once it has completed
    `kill_after` rounds (the next round is in flight, its clients training
    against the dead incarnation), restart it with resume, and run to the
    end; clients re-attach through their silence watchdog. Returns the
    final params, history, the restart's recovery seconds and the
    counters the assertions read."""
    h = SiloSoakHarness(
        n_clients=n_clients, rounds=rounds, checkpoint_dir=checkpoint_dir,
        seed=seed, device=device,
        server_kw=dict(round_timeout=10.0, quorum_frac=1.0),
        client_kw=dict(server_timeout_s=server_timeout_s, reattach=True,
                       max_reattach=120))
    try:
        h.start_all()
        if not h.wait_history(kill_after, timeout=60):
            raise TimeoutError(
                f"server never completed {kill_after} rounds pre-kill")
        h.kill_server()
        t0 = time.perf_counter()
        srv = h.start_server(resume=True)
        recovered = h.wait_done(timeout=120)
        recovery_s = time.perf_counter() - t0
        if not recovered:
            raise TimeoutError("resumed run did not finish")
        snap = _mx.snapshot()["counters"]
        return {**_counters(srv), "recovery_s": recovery_s,
                "reattaches": int(snap.get("fed.client.reattaches", 0))}
    finally:
        h.close()


def secagg_server_kill_restart(make_server: Callable[[bool], Any],
                               clients: list, kill_after: int,
                               timeout: float = 120.0):
    """SecAgg's durability contract: only the server dies, at a round
    boundary, and resumes from its checkpoint while the clients keep their
    key material. `make_server(resume)` builds a
    `SecAggServerManager` writing checkpoints every round (resuming from
    them with `resume=True`); `clients` are its SecAgg client managers.
    The first server is severed once it has completed `kill_after` rounds
    and a resumed one drives the run to its end. Returns the resumed
    server; its final params are bitwise an uninterrupted run's."""
    srv = make_server(False)
    srv.run(background=True)
    for c in clients:
        c.run(background=True)
        c.announce_ready()
    end = time.monotonic() + timeout
    while len(srv.history) < kill_after:
        if srv.done.is_set() or time.monotonic() > end:
            raise TimeoutError(
                f"secagg server never completed {kill_after} rounds "
                f"pre-kill (error: {srv.error})")
        time.sleep(0.01)
    sever_server(srv)
    srv = make_server(True)
    srv.run(background=True)
    if not srv.done.wait(timeout):
        raise TimeoutError("the resumed secagg run did not finish")
    for c in clients:
        c.done.wait(30)
    return srv
