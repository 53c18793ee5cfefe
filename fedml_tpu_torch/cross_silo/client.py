"""Cross-silo FL client, the master manager FSM (port of
`fedml_tpu/cross_silo/client.py`; reference:
cross_silo/client/fedml_client_master_manager.py:22-230).

Durability, as in the JAX package:

- `server_timeout_s` arms a silence watchdog: when nothing has arrived
  from the server for that long, the client either re-attaches
  (`reattach=True`: re-announces CONNECTION_IS_READY, so a resumed server
  re-runs the handshake and re-sends the in-flight round) or exits with
  `error` set (a foreground `run()` raises). The watchdog pauses while
  the local trainer runs: training time is not server silence.
- `heartbeat_s` sends C2S_HEARTBEAT beacons for the server's liveness
  sweep.
- Every upload echoes the run generation of the message that gave it its
  work, so a restarted server can fence pre-restart stragglers.
- `dp_upload` (`dp.make_upload_dp`) clips and noises the update before the
  upload leaves the client.

- Each trained model is published to the artifact store `mlops.init`
  configured (`mlops.log_client_model_info`; a no-op without one).
"""
from __future__ import annotations

import logging
import threading
import time

from ..comm import FedCommManager, Message
from ..utils import metrics as _mx
from ..utils.events import recorder
from . import message_define as md
from .trainer import SiloTrainer

log = logging.getLogger(__name__)


class FedClientManager:
    def __init__(self, comm: FedCommManager, client_id: int,
                 trainer: SiloTrainer, server_id: int = 0,
                 server_timeout_s: float = None,
                 reattach: bool = False,
                 heartbeat_s: float = None,
                 max_reattach: int = 10,
                 dp_upload=None):
        self.comm = comm
        self.client_id = client_id
        self.server_id = server_id
        self.trainer = trainer
        # client-side DP (dp.SiloUploadDP): clip + noise the local update
        # before the send
        self.dp_upload = dp_upload
        self.server_timeout_s = server_timeout_s
        self.reattach = reattach
        self.heartbeat_s = heartbeat_s
        self.max_reattach = int(max_reattach)
        self.run_gen = 0          # server incarnation, learned from S2C
        self.error = None
        self.done = threading.Event()
        self._stopped = threading.Event()   # done OR killed — stops aux loops
        self._last_contact = time.monotonic()
        self._reattach_count = 0
        self._aux_started = False
        self._training = False   # watchdog must not count local work

        comm.register_message_receive_handler(
            md.S2C_CHECK_CLIENT_STATUS, self._on_check_status)
        comm.register_message_receive_handler(md.S2C_INIT_CONFIG, self._on_init)
        comm.register_message_receive_handler(md.S2C_SYNC_MODEL, self._on_sync)
        comm.register_message_receive_handler(md.S2C_FINISH, self._on_finish)

    def _touch(self) -> None:
        """Reset the server-silence clock (any S2C arrival, or our own
        upload — the deadline measures silence while WAITING, not while the
        local trainer is busy)."""
        self._last_contact = time.monotonic()

    def _server_contact(self) -> None:
        """An actual S2C arrival: beyond the clock, it REFUNDS the
        re-attach budget — the budget bounds announcing into a void, and a
        server that answers is not a void. Without the refund a long run's
        sporadic slow rounds accumulate attempts until the watchdog
        declares a perfectly live server dead."""
        self._touch()
        self._reattach_count = 0

    def _on_check_status(self, msg: Message) -> None:
        self._server_contact()
        m = Message(md.C2S_CLIENT_STATUS, self.client_id, self.server_id)
        m.add(md.KEY_STATUS, md.STATUS_ONLINE)
        self.comm.send_message(m)

    def _train_and_send(self, params, round_idx: int, gen: int = 0) -> None:
        # the silence watchdog pauses while the local trainer runs: a round
        # whose training outlasts server_timeout_s is OUR work, not server
        # silence (the clock restarts at the post-send _touch below)
        self._training = True
        try:
            with recorder.span("train", round=round_idx,
                               client=self.client_id):
                new_params, n, metrics = self.trainer.train(params, round_idx)
        finally:
            self._training = False
        if self.dp_upload is not None:
            new_params = self.dp_upload.apply(new_params, params, round_idx)
        # the client's trained model to the artifact store (reference:
        # core/mlops/__init__.py:475 log_client_model_info); a no-op
        # without a store
        from .. import mlops

        mlops.log_client_model_info(round_idx, self.client_id, new_params)
        out = Message(md.C2S_SEND_MODEL, self.client_id, self.server_id)
        out.add(md.KEY_MODEL_PARAMS, new_params)
        out.add(md.KEY_NUM_SAMPLES, n)
        out.add(md.KEY_METRICS, metrics)
        # echo the round so a straggler's result can't leak into a later
        # round after a timeout-closed aggregation (server checks KEY_ROUND)
        out.add(md.KEY_ROUND, round_idx)
        # echo the incarnation that SENT this work (not the latest one we
        # know of): a stale pre-restart sync processed after a fresh one
        # must still be identifiable as stale at the server
        out.add(md.KEY_GENERATION, gen)
        self.comm.send_message(out)
        self._touch()

    def _on_init(self, msg: Message) -> None:
        self._server_contact()
        gen = int(msg.get(md.KEY_GENERATION, 0) or 0)
        # run_gen tracks the HIGHEST incarnation seen (fences stale FINISH);
        # the per-message gen rides through to the upload echo
        self.run_gen = max(self.run_gen, gen)
        self._train_and_send(msg.get(md.KEY_MODEL_PARAMS),
                             int(msg.get(md.KEY_ROUND, 0)), gen=gen)

    _on_sync = _on_init

    def _on_finish(self, msg: Message) -> None:
        # a STALE finish (older generation than the one we are training
        # under) is a dead server's farewell delivered late — a live
        # resumed server still owns this client; ignore it
        gen = msg.get(md.KEY_GENERATION)
        if gen is not None and int(gen) < self.run_gen:
            log.warning("client %d: ignoring S2C_FINISH from stale "
                        "generation %s (current %d)", self.client_id,
                        gen, self.run_gen)
            return
        m = Message(md.C2S_FINISHED, self.client_id, self.server_id)
        m.add(md.KEY_STATUS, md.STATUS_FINISHED)
        try:
            self.comm.send_message(m)
        except Exception:  # server may already be gone
            pass
        self.done.set()
        self._stopped.set()
        self.comm.stop()

    # ------------------------------------------------------------ durability
    def _heartbeat_loop(self) -> None:
        while not self._stopped.wait(self.heartbeat_s):
            try:
                self.comm.send_message(
                    Message(md.C2S_HEARTBEAT, self.client_id, self.server_id)
                    .add(md.KEY_GENERATION, self.run_gen))
            except Exception as e:  # noqa: BLE001 — beacon, not critical
                log.debug("heartbeat send failed: %s: %s",
                          type(e).__name__, e)

    def _watchdog_loop(self) -> None:
        assert self.server_timeout_s is not None
        tick = max(self.server_timeout_s / 4.0, 0.05)
        while not self._stopped.wait(tick):
            if self._training:
                self._touch()   # local work is not server silence
                continue
            silent = time.monotonic() - self._last_contact
            if silent <= self.server_timeout_s:
                continue
            if self.reattach and self._reattach_count < self.max_reattach:
                self._reattach_count += 1
                _mx.inc("fed.client.reattaches")
                log.warning(
                    "client %d: server silent %.1fs (> server_timeout_s="
                    "%.1fs) — re-announcing (%d/%d)", self.client_id,
                    silent, self.server_timeout_s, self._reattach_count,
                    self.max_reattach)
                self._touch()    # a fresh deadline per attempt
                try:
                    self.announce_ready()
                except Exception as e:  # noqa: BLE001 — retried next lap
                    log.debug("re-announce failed: %s: %s",
                              type(e).__name__, e)
                continue
            _mx.inc("fed.client.server_silence_exits")
            self.error = (
                f"server silent for {silent:.1f}s (> server_timeout_s="
                f"{self.server_timeout_s}s)"
                + (f" after {self._reattach_count} re-attach attempts"
                   if self.reattach else "")
                + " — giving up instead of blocking in the receive loop "
                "forever")
            log.error("client %d: %s", self.client_id, self.error)
            self.done.set()
            self._stopped.set()
            self.comm.stop()
            return

    def _start_aux(self) -> None:
        if self._aux_started:
            return
        self._aux_started = True
        if self.heartbeat_s is not None:
            threading.Thread(target=self._heartbeat_loop,
                             name=f"hb-c{self.client_id}",
                             daemon=True).start()
        if self.server_timeout_s is not None:
            self._touch()
            threading.Thread(target=self._watchdog_loop,
                             name=f"watchdog-c{self.client_id}",
                             daemon=True).start()

    def run(self, background: bool = False) -> None:
        self._start_aux()
        self.comm.run(background=background)
        if not background and self.error:
            # foreground runs surface the failure as a nonzero exit instead
            # of a silent return (the CLI contract)
            raise RuntimeError(self.error)

    def announce_ready(self) -> None:
        """Kick the FSM (the transport's CONNECTION_IS_READY event — reference
        transports synthesize it on connect; loopback/grpc need an explicit
        poke to the server)."""
        self.comm.send_message(
            Message(md.CONNECTION_IS_READY, self.client_id, self.server_id))
