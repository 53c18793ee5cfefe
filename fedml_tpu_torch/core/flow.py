"""Flow DSL: compose custom federated protocols as named stages (port of
`fedml_tpu/core/flow.py`; reference:
core/distributed/flow/fedml_flow.py, fedml_executor.py).

Stages are functions on a params dict. The engine derives the message
plumbing from the role transitions in the stage sequence:

    server -> client   broadcast (every client runs the next stage)
    client -> server   gather    (the server waits for every client; the
                                  stage receives params["client_results"])
    same role          a local call, no message

A loop segment repeats `rounds` times (the reference's run_loop). Stage
payloads ride the port's wire codec (`comm/serialization.py`), so a flow
built on loopback runs unchanged on any transport of `comm/`.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Any, Callable, Optional

from ..comm import FedCommManager, Message

log = logging.getLogger(__name__)

ROLE_SERVER = "server"
ROLE_CLIENT = "client"
_FLOW_MSG = "flow_stage"
_KEY_SEQ = "flow_seq"
_KEY_PARAMS = "flow_params"
_FINISH = "flow_finish"


@dataclasses.dataclass
class _Stage:
    name: str
    task: Callable[[dict], dict]
    role: str


class FedMLAlgorithmFlow:
    """One instance per node; every node registers the SAME stage sequence
    (reference: fedml_flow.py add_flow on both server and client scripts).

    task signature: task(params: dict) -> dict. On a client, params
    additionally contains "client_id". On a gather stage (client->server
    transition), params["client_results"] is the list of every client's
    returned dict, ordered by client id.
    """

    def __init__(self, comm: FedCommManager, rank: int, role: str,
                 client_ids: list[int], server_id: int = 0):
        self.comm = comm
        self.rank = rank
        self.role = role
        self.client_ids = list(client_ids)
        self.server_id = server_id
        self.stages: list[_Stage] = []
        self.sequence: list[_Stage] = []
        self.done = threading.Event()
        self.final_params: Optional[dict] = None
        self._gather: dict[int, dict] = {}
        self._gather_seq = -1
        self._lock = threading.Lock()
        comm.register_message_receive_handler(_FLOW_MSG, self._on_stage_msg)
        comm.register_message_receive_handler(_FINISH, self._on_finish)

    # ------------------------------------------------------------- building
    def add_flow(self, name: str, task: Callable[[dict], dict],
                 role: str = ROLE_SERVER) -> "FedMLAlgorithmFlow":
        if role not in (ROLE_SERVER, ROLE_CLIENT):
            raise ValueError(f"role must be server|client, got {role!r}")
        self.stages.append(_Stage(name, task, role))
        return self

    def build(self, loop_start: Optional[str] = None, rounds: int = 1) -> None:
        """Expand the stage list into the executed sequence: stages before
        `loop_start` run once, the rest repeat `rounds` times (reference:
        run_loop)."""
        if loop_start is None:
            self.sequence = list(self.stages) * max(rounds, 1)
            return
        idx = [i for i, s in enumerate(self.stages) if s.name == loop_start]
        if not idx:
            raise ValueError(f"loop_start {loop_start!r} is not a stage")
        pre, loop = self.stages[: idx[0]], self.stages[idx[0]:]
        self.sequence = pre + loop * max(rounds, 1)

    # ------------------------------------------------------------- running
    def run(self, initial_params: Optional[dict] = None,
            background: bool = True) -> None:
        """Start the flow; the owner of stage 0 kicks it off. The kick-off
        happens BEFORE entering a blocking receive loop (transports queue
        outbound/inbound frames until the loop drains them), so
        background=False cannot deadlock."""
        if not self.sequence:
            self.build()
        starter = (
            (self.sequence[0].role == ROLE_SERVER
             and self.role == ROLE_SERVER and self.rank == self.server_id)
            or (self.sequence[0].role == ROLE_CLIENT
                and self.role == ROLE_CLIENT))
        if background:
            self.comm.run(background=True)
            if starter:
                self._execute(0, dict(initial_params or {}))
        else:
            if starter:
                self._execute(0, dict(initial_params or {}))
            self.comm.run(background=False)

    def _execute(self, seq: int, params: dict) -> None:
        stage = self.sequence[seq]
        if self.role == ROLE_CLIENT:
            params = {**params, "client_id": self.rank}
        log.debug("rank %s: stage %d %s", self.rank, seq, stage.name)
        out = stage.task(params) or {}
        self._advance(seq, out)

    def _advance(self, seq: int, out: dict) -> None:
        nxt = seq + 1
        if nxt >= len(self.sequence):
            if self.role == ROLE_SERVER:
                self.final_params = out
                for cid in self.client_ids:
                    try:
                        self.comm.send_message(
                            Message(_FINISH, self.rank, cid))
                    except Exception:
                        pass
                self.done.set()
                threading.Thread(target=self.comm.stop, daemon=True).start()
            else:
                # a client-final sequence: clients gather-report with an
                # out-of-range seq; the server finishes on full collection
                self._send(self.server_id, nxt, out, gather=True)
            return
        cur_role, nxt_role = self.sequence[seq].role, self.sequence[nxt].role
        if cur_role == nxt_role:
            self._execute(nxt, out)
        elif cur_role == ROLE_SERVER:        # broadcast to clients
            for cid in self.client_ids:
                self._send(cid, nxt, out)
        else:                                 # client -> server gather
            self._send(self.server_id, nxt, out, gather=True)

    def _send(self, to: int, seq: int, params: dict,
              gather: bool = False) -> None:
        m = Message(_FLOW_MSG, self.rank, to)
        m.add(_KEY_SEQ, seq)
        m.add(_KEY_PARAMS, params)
        m.add("gather", bool(gather))
        self.comm.send_message(m)

    def _on_stage_msg(self, msg: Message) -> None:
        seq = int(msg.get(_KEY_SEQ))
        params = msg.get(_KEY_PARAMS) or {}
        if not msg.get("gather"):
            self._execute(seq, params)
            return
        # gather: collect one result per client, then run the server stage
        with self._lock:
            if seq != self._gather_seq:
                self._gather_seq = seq
                self._gather = {}
            self._gather[msg.sender_id] = params
            if set(self._gather) != set(self.client_ids):
                return
            results = [self._gather[c] for c in sorted(self._gather)]
            self._gather = {}
            self._gather_seq = -1
        if seq >= len(self.sequence):
            self.final_params = {"client_results": results}
            for cid in self.client_ids:
                try:
                    self.comm.send_message(Message(_FINISH, self.rank, cid))
                except Exception:
                    pass
            self.done.set()
            threading.Thread(target=self.comm.stop, daemon=True).start()
            return
        self._execute(seq, {"client_results": results})

    def _on_finish(self, msg: Message) -> None:
        self.done.set()
        self.comm.stop()
