"""Cross-device FL: many flaky lightweight clients, dynamic membership
(port of `fedml_tpu/cross_device/__init__.py`; reference:
python/fedml/cross_device/ — server_mnn/fedml_server_manager.py drives
MNN mobile clients over MQTT).

What sets cross-device apart from cross-silo:
- membership is dynamic: devices register and leave at any time
  (`C2D_REGISTER`); each round samples from the devices online now, not a
  fixed id list;
- dropout is the norm: rounds always run with a timeout and a quorum;
- uplink bandwidth is scarce: with `uplink_topk` a client sends a top-k
  sparse delta (`compression.encode_sparse_tree`) instead of dense params.

The server aggregates through the port's `FedAggregator` on `device`
(None: CUDA, raising without a GPU); the reference edge client trains
through the port's `SiloTrainer`. Parameters on the wire are the port's
flat dicts.
"""
from __future__ import annotations

import logging
import threading
from typing import Any, Callable, Optional

import numpy as np

from ..comm import FedCommManager, Message
from ..cross_silo import message_define as md
from ..cross_silo.server import FedAggregator
from ..utils.events import recorder

Pytree = Any
log = logging.getLogger(__name__)

C2D_REGISTER = "c2d_register"
KEY_DEVICE_INFO = "device_info"
KEY_SPARSE_UPDATE = "sparse_update"


class CrossDeviceServer:
    """Sampling server over a dynamic device registry (reference:
    server_mnn/fedml_server_manager.py). Starts round 0 once
    `min_devices` have registered; every round samples
    `devices_per_round` of the currently-registered devices and closes on
    quorum after `round_timeout`."""

    def __init__(self, comm: FedCommManager, init_params: Pytree,
                 num_rounds: int, devices_per_round: int = 2,
                 min_devices: int = 2, round_timeout: float = 30.0,
                 quorum_frac: float = 0.5,
                 eval_fn: Optional[Callable[[Pytree, int], dict]] = None,
                 sample_seed: int = 0, device=None):
        self.comm = comm
        self.params = init_params
        self.num_rounds = num_rounds
        self.m = devices_per_round
        self.min_devices = min_devices
        self.round_timeout = round_timeout
        self.quorum_frac = quorum_frac
        self.eval_fn = eval_fn
        self.sample_seed = sample_seed
        self.round_idx = 0
        self.devices: dict[int, dict] = {}     # id -> info (dynamic registry)
        self.aggregator = FedAggregator(device)
        self.started = False
        self.done = threading.Event()
        self.error: Optional[str] = None
        self.history: list[dict] = []
        self.dropped_log: list[tuple[int, list[int]]] = []
        self._lock = threading.Lock()
        self._timer: Optional[threading.Timer] = None

        h = comm.register_message_receive_handler
        h(C2D_REGISTER, self._on_register)
        h(md.C2S_SEND_MODEL, self._on_model)
        h(md.C2S_FINISHED, lambda _m: None)

    # ------------------------------------------------------------ handlers
    def _on_register(self, msg: Message) -> None:
        with self._lock:
            self.devices[msg.sender_id] = dict(msg.get(KEY_DEVICE_INFO) or {})
            log.info("device %s registered (%d online)", msg.sender_id,
                     len(self.devices))
            if not self.started and len(self.devices) >= self.min_devices:
                self.started = True
                self._start_round()

    def _select(self) -> list[int]:
        pool = sorted(self.devices)
        if self.m >= len(pool):
            return pool
        rs = np.random.RandomState(self.sample_seed + self.round_idx)
        return sorted(rs.choice(pool, self.m, replace=False).tolist())

    def _start_round(self) -> None:
        selected = self._select()
        self.aggregator.reset(selected)
        for did in selected:
            m = Message(md.S2C_SYNC_MODEL, 0, did)
            m.add(md.KEY_MODEL_PARAMS, self.params)
            m.add(md.KEY_ROUND, self.round_idx)
            try:
                self.comm.send_message(m)
            except Exception:
                log.warning("push to device %s failed", did)
        self._arm_timer()

    def _on_model(self, msg: Message) -> None:
        with self._lock:
            if int(msg.get(md.KEY_ROUND, -1)) != self.round_idx or \
                    msg.sender_id not in self.aggregator.expected:
                return
            params = msg.get(md.KEY_MODEL_PARAMS)
            sparse = msg.get(KEY_SPARSE_UPDATE)
            if params is None and sparse is not None:
                # top-k sparse uplink: the delta decoded against the
                # current global model. Devices self-register, so a
                # malformed payload must not kill the receive loop: reject
                # it, keep the round open.
                from ..compression import decode_sparse_tree

                try:
                    delta = decode_sparse_tree(sparse, self.params)
                except Exception:
                    log.warning("device %s: malformed sparse update "
                                "rejected", msg.sender_id, exc_info=True)
                    return
                params = {k: np.add(self.params[k], delta[k])
                          for k in self.params}
            # dense path, the same invariant: a payload that does not match
            # the global model's structure must not reach aggregate()
            if params is None:
                log.warning("device %s: model upload without payload "
                            "rejected", msg.sender_id)
                return
            if not isinstance(params, dict) or set(params) != set(
                    self.params) or any(np.shape(params[k])
                                        != np.shape(self.params[k])
                                        for k in self.params):
                log.warning("device %s: structurally wrong model rejected",
                            msg.sender_id)
                return
            self.aggregator.add_local_trained_result(
                msg.sender_id, params,
                float(msg.get(md.KEY_NUM_SAMPLES, 1.0)))
            if self.aggregator.check_whether_all_receive():
                self._complete_round()

    # ------------------------------------------------------------- rounds
    def _arm_timer(self) -> None:
        self._cancel_timer()
        t = threading.Timer(self.round_timeout, self._on_timeout,
                            args=(self.round_idx,))
        t.daemon = True
        t.start()
        self._timer = t

    def _cancel_timer(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    def _on_timeout(self, armed_round: int) -> None:
        with self._lock:
            if self.done.is_set() or armed_round != self.round_idx:
                return
            if not self.devices and not self.aggregator.results:
                # every device evicted and nothing received: unrecoverable
                # (evicted devices were told to finish) — fail loudly
                log.error("round %d: no devices left in the registry",
                          self.round_idx)
                self.error = (f"round {self.round_idx}: all devices "
                              "dropped — quorum unreachable")
                self._finish()
                return
            n_exp = len(self.aggregator.expected)
            quorum = max(1, int(np.ceil(self.quorum_frac * n_exp)))
            if len(self.aggregator.results) >= quorum:
                dropped = sorted(self.aggregator.expected
                                 - set(self.aggregator.results))
                if dropped:
                    self.dropped_log.append((self.round_idx, dropped))
                    # flaky devices leave the registry; they rejoin by
                    # re-registering (the cross-device membership model).
                    # Tell slow-but-alive ones their round is over so their
                    # client loop terminates instead of waiting forever.
                    for did in dropped:
                        self.devices.pop(did, None)
                        try:
                            self.comm.send_message(
                                Message(md.S2C_FINISH, 0, did))
                        except Exception:
                            pass
                self._complete_round()
            else:
                self._arm_timer()

    def _complete_round(self) -> None:
        self._cancel_timer()
        with recorder.span("cd_agg", round=self.round_idx):
            self.params = self.aggregator.aggregate()
        row = {"round": self.round_idx,
               "n_received": len(self.aggregator.results),
               "n_online": len(self.devices)}
        if self.eval_fn is not None:
            row.update(self.eval_fn(self.params, self.round_idx))
        self.history.append(row)
        recorder.log(row)
        self.round_idx += 1
        if self.round_idx >= self.num_rounds:
            self._finish()
            return
        self._start_round()

    def _finish(self) -> None:
        self._cancel_timer()
        for did in list(self.devices):
            try:
                self.comm.send_message(Message(md.S2C_FINISH, 0, did))
            except Exception:
                pass
        self.done.set()
        threading.Thread(target=self.comm.stop, daemon=True).start()

    def run(self, background: bool = False) -> None:
        self.comm.run(background=background)


class EdgeClient:
    """Reference python edge device (the MobileNN-client role): registers,
    trains on push (`trainer`: a `SiloTrainer`, on the card unless built
    for the CPU), uploads dense params or a top-k sparse delta."""

    def __init__(self, comm: FedCommManager, device_id: int, trainer,
                 server_id: int = 0, device_info: Optional[dict] = None,
                 uplink_topk: Optional[float] = None):
        self.comm = comm
        self.device_id = device_id
        self.server_id = server_id
        self.trainer = trainer
        self.device_info = device_info or {}
        self.uplink_topk = uplink_topk
        self.done = threading.Event()
        h = comm.register_message_receive_handler
        h(md.S2C_SYNC_MODEL, self._on_model)
        h(md.S2C_FINISH, self._on_finish)

    def register(self) -> None:
        m = Message(C2D_REGISTER, self.device_id, self.server_id)
        m.add(KEY_DEVICE_INFO, self.device_info)
        self.comm.send_message(m)

    def _on_model(self, msg: Message) -> None:
        params = msg.get(md.KEY_MODEL_PARAMS)
        r = int(msg.get(md.KEY_ROUND, 0))
        new_params, n, _metrics = self.trainer.train(params, r)
        out = Message(md.C2S_SEND_MODEL, self.device_id, self.server_id)
        if self.uplink_topk:
            from ..compression import encode_sparse_tree

            delta = {k: np.subtract(new_params[k], params[k])
                     for k in new_params}
            out.add(KEY_SPARSE_UPDATE,
                    encode_sparse_tree(delta, self.uplink_topk))
        else:
            out.add(md.KEY_MODEL_PARAMS, new_params)
        out.add(md.KEY_NUM_SAMPLES, n)
        out.add(md.KEY_ROUND, r)
        self.comm.send_message(out)

    def _on_finish(self, msg: Message) -> None:
        self.done.set()
        self.comm.stop()

    def run(self, background: bool = False) -> None:
        self.comm.run(background=background)
