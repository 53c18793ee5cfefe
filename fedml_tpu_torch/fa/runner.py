"""FA runtimes: the in-process simulation and cross-silo over the message
layer (port of `fedml_tpu/fa/runner.py`; reference: fa/runner.py FARunner,
fa/simulation/sp/simulator.py FASimulatorSingleProcess,
fa/cross_silo/{fa_client,fa_server}.py): the FL round loop with analytics
submissions as payloads. Host code only; every draw is numpy's
(`RandomState(seed + r)` sampling, `default_rng((seed, r, client))`), so
results are bitwise the JAX package's.
"""
from __future__ import annotations

import threading
import uuid
from typing import Any, Optional, Sequence

import numpy as np

from ..comm import FedCommManager, Message
from ..comm.loopback import LoopbackTransport, release_router
from ..cross_silo import message_define as md
from ..utils.events import recorder
from .tasks import FA_TASKS, FATask

KEY_SUBMISSION = "fa_submission"
KEY_SERVER_DATA = "fa_server_data"


class FASimulator:
    """Single-process FA round loop (reference:
    fa/simulation/sp/simulator.py): sample clients, run local analyzers,
    aggregate — no device work, submissions are host objects."""

    def __init__(self, task: FATask | str, client_data: Sequence[Any],
                 client_num_per_round: Optional[int] = None,
                 num_rounds: Optional[int] = None, seed: int = 0, **task_kw):
        if isinstance(task, str):
            total = sum(len(np.asarray(d).reshape(-1)) if not isinstance(d, list)
                        else len(d) for d in client_data)
            task_kw.setdefault("train_data_num", total)
            task_kw.setdefault("client_num_per_round",
                               client_num_per_round or len(client_data))
            task = FA_TASKS.get(task)(**task_kw)
        self.task = task
        self.client_data = list(client_data)
        self.m = client_num_per_round or len(self.client_data)
        self.num_rounds = num_rounds or task.default_rounds
        self.seed = seed
        self.server_data = task.server_init()
        self.history: list[dict] = []

    def run(self) -> Any:
        n = len(self.client_data)
        for r in range(self.num_rounds):
            # host-driven sampling seeded by round (the FL sampler's
            # convention, simulator.py / fedavg_api.py:127)
            rs = np.random.RandomState(self.seed + r)
            ids = (rs.choice(n, self.m, replace=False)
                   if self.m < n else np.arange(n))
            subs = []
            for cid in sorted(ids.tolist()):
                rng = np.random.default_rng((self.seed, r, cid))
                sub = self.task.client_analyze(
                    self.client_data[cid], self.server_data, rng)
                subs.append((float(len(self.client_data[cid])), sub))
            self.server_data = self.task.server_aggregate(
                self.server_data, subs)
            row = {"round": r, "result": self.task.result(self.server_data)}
            self.history.append(row)
            recorder.log({"fa_round": r})
            if self.task.converged(self.server_data):
                break
        return self.task.result(self.server_data)


# ---------------------------------------------------------------- cross-silo
class FAServerManager:
    """FA over the comm layer (reference: fa/cross_silo/fa_server.py) —
    the FL server FSM with submissions instead of models."""

    def __init__(self, comm: FedCommManager, client_ids: list[int],
                 task: FATask, num_rounds: Optional[int] = None):
        self.comm = comm
        self.client_ids = list(client_ids)
        self.task = task
        self.num_rounds = num_rounds or task.default_rounds
        self.server_data = task.server_init()
        self.round_idx = 0
        self.subs: dict[int, tuple[float, Any]] = {}
        self.online: dict[int, bool] = {}
        self.is_initialized = False
        self.done = threading.Event()
        self.history: list[dict] = []
        self._lock = threading.Lock()

        h = comm.register_message_receive_handler
        h(md.CONNECTION_IS_READY, self._on_ready)
        h(md.C2S_CLIENT_STATUS, self._on_status)
        h(KEY_SUBMISSION, self._on_submission)
        h(md.C2S_FINISHED, lambda _m: None)

    def _on_ready(self, msg: Message) -> None:
        if self.is_initialized:
            return
        for cid in self.client_ids:
            self.comm.send_message(Message(md.S2C_CHECK_CLIENT_STATUS, 0, cid))

    def _on_status(self, msg: Message) -> None:
        with self._lock:
            self.online[msg.sender_id] = True
            if not self.is_initialized and all(
                    self.online.get(c) for c in self.client_ids):
                self.is_initialized = True
                self._start_round()

    def _start_round(self) -> None:
        self.subs.clear()
        for cid in self.client_ids:
            m = Message(md.S2C_SYNC_MODEL, 0, cid)
            m.add(KEY_SERVER_DATA, _encode_server_data(self.server_data))
            m.add(md.KEY_ROUND, self.round_idx)
            self.comm.send_message(m)

    def _on_submission(self, msg: Message) -> None:
        with self._lock:
            if int(msg.get(md.KEY_ROUND, -1)) != self.round_idx:
                return
            self.subs[msg.sender_id] = (
                float(msg.get(md.KEY_NUM_SAMPLES, 1.0)),
                msg.get(KEY_SUBMISSION))
            if set(self.subs) != set(self.client_ids):
                return
            subs = [self.subs[c] for c in sorted(self.subs)]
            self.server_data = self.task.server_aggregate(
                self.server_data, subs)
            self.history.append(
                {"round": self.round_idx,
                 "result": self.task.result(self.server_data)})
            self.round_idx += 1
            if self.round_idx >= self.num_rounds or \
                    self.task.converged(self.server_data):
                for cid in self.client_ids:
                    try:
                        self.comm.send_message(Message(md.S2C_FINISH, 0, cid))
                    except Exception:
                        pass  # a dead client must not block done.set()
                self.done.set()
                threading.Thread(target=self.comm.stop, daemon=True).start()
                return
            self._start_round()

    @property
    def result(self) -> Any:
        return self.task.result(self.server_data)

    def run(self, background: bool = False) -> None:
        self.comm.run(background=background)


class FAClientManager:
    """(reference: fa/cross_silo/fa_client.py)"""

    def __init__(self, comm: FedCommManager, client_id: int, data: Any,
                 task: FATask, server_id: int = 0, seed: int = 0,
                 rng_id: Optional[int] = None):
        self.comm = comm
        self.client_id = client_id
        self.server_id = server_id
        self.data = data
        self.task = task
        self.seed = seed
        # rng identity for sampling parity with FASimulator (which uses the
        # 0-based data index); defaults to the wire client id
        self.rng_id = client_id if rng_id is None else rng_id
        self.done = threading.Event()
        h = comm.register_message_receive_handler
        h(md.S2C_CHECK_CLIENT_STATUS, self._on_check)
        h(md.S2C_SYNC_MODEL, self._on_round)
        h(md.S2C_FINISH, self._on_finish)

    def _on_check(self, msg: Message) -> None:
        m = Message(md.C2S_CLIENT_STATUS, self.client_id, self.server_id)
        m.add(md.KEY_STATUS, md.STATUS_ONLINE)
        self.comm.send_message(m)

    def _on_round(self, msg: Message) -> None:
        r = int(msg.get(md.KEY_ROUND, 0))
        server_data = _decode_server_data(msg.get(KEY_SERVER_DATA))
        rng = np.random.default_rng((self.seed, r, self.rng_id))
        with recorder.span("fa_analyze", round=r, client=self.client_id):
            sub = self.task.client_analyze(self.data, server_data, rng)
        out = Message(KEY_SUBMISSION, self.client_id, self.server_id)
        out.add(KEY_SUBMISSION, sub)
        out.add(md.KEY_NUM_SAMPLES, float(len(self.data)))
        out.add(md.KEY_ROUND, r)
        self.comm.send_message(out)

    def _on_finish(self, msg: Message) -> None:
        m = Message(md.C2S_FINISHED, self.client_id, self.server_id)
        m.add(md.KEY_STATUS, md.STATUS_FINISHED)
        try:
            self.comm.send_message(m)
        except Exception:
            pass
        self.done.set()
        self.comm.stop()

    def run(self, background: bool = False) -> None:
        self.comm.run(background=background)

    def announce_ready(self) -> None:
        self.comm.send_message(
            Message(md.CONNECTION_IS_READY, self.client_id, self.server_id))


def _encode_server_data(sd: Any) -> Any:
    """Server state -> wire-safe pytree (sets become sorted lists)."""
    if isinstance(sd, set):
        return {"__set__": sorted(sd)}
    if isinstance(sd, tuple):
        return list(sd)
    return sd


def _decode_server_data(sd: Any) -> Any:
    if isinstance(sd, dict) and "__set__" in sd:
        return set(sd["__set__"])
    return sd


def run_fa_cross_silo(task_name: str, client_data: Sequence[Any],
                      num_rounds: Optional[int] = None,
                      run_id: Optional[str] = None,
                      **task_kw) -> FAServerManager:
    """One-call cross-silo FA over loopback (reference: FARunner with
    training_type=cross_silo on one box)."""
    if run_id is None:
        run_id = f"fa-{uuid.uuid4().hex[:8]}"
    total = sum(len(d) for d in client_data)
    task_kw.setdefault("train_data_num", total)
    task_kw.setdefault("client_num_per_round", len(client_data))
    task = FA_TASKS.get(task_name)(**task_kw)
    n = len(client_data)
    server = FAServerManager(
        FedCommManager(LoopbackTransport(0, run_id), 0),
        client_ids=list(range(1, n + 1)), task=task, num_rounds=num_rounds)
    clients = [
        FAClientManager(FedCommManager(LoopbackTransport(cid, run_id), cid),
                        cid, client_data[cid - 1], task, rng_id=cid - 1)
        for cid in range(1, n + 1)
    ]
    try:
        server.run(background=True)
        for c in clients:
            c.run(background=True)
        for c in clients:
            c.announce_ready()
        if not server.done.wait(timeout=300):
            raise TimeoutError("cross-silo FA run did not finish")
        for c in clients:
            c.done.wait(timeout=30)
    finally:
        release_router(run_id)
    return server
