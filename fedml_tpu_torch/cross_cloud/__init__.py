"""Cross-cloud FL: a federation across clouds and regions (port of
`fedml_tpu/cross_cloud/`; reference: python/fedml/cross_cloud/ and
runner.py `_init_cheetah_runner`).

Cross-cloud is cross-silo with two substitutions below the managers, which
are reused as they are:
- the transport: `comm/broker.py:BrokerTransport`, store-and-forward
  pub/sub with a blob side-channel (the MQTT + S3 shape); parties need to
  reach the broker only, never each other;
- tolerance on by default: round_timeout and quorum (parties over a WAN
  drop), as in cross-device.

`run_cross_cloud` composes a whole federation in one process against an
in-memory broker; the silos train through the port's `SiloTrainer` on
`device` and the server aggregates there.
"""
from __future__ import annotations

import time
import uuid
from typing import Any, Callable, Optional, Sequence

import numpy as np
from torch import nn

from ..comm import FedCommManager
from ..comm.broker import BrokerTransport, release_broker
from ..config import TrainArgs
from ..cross_silo import FedClientManager, FedServerManager, SiloTrainer

Pytree = Any


def run_cross_cloud(
    model: nn.Module,
    init_params_np: Pytree,
    t: TrainArgs,
    party_data: Sequence[tuple[np.ndarray, np.ndarray]],
    num_rounds: int,
    eval_fn: Optional[Callable[[Pytree, int], dict]] = None,
    round_timeout: Optional[float] = 60.0,
    quorum_frac: float = 0.5,
    run_id: Optional[str] = None,
    late_join_delay: float = 0.0,
    device=None,
    batch_schedules: Optional[Sequence[Callable]] = None,
) -> FedServerManager:
    """One federation over the broker: N cloud parties and a server. With
    `late_join_delay`, the parties announce at staggered times and the
    broker's store-and-forward keeps the early messages for them. `model`
    is a `models/hub.py` module (the JAX function takes `model.apply`);
    `device` None means CUDA, raising without a GPU; `batch_schedules[i]`,
    when given, is party i+1's batch order (`SiloTrainer`)."""
    if run_id is None:
        run_id = f"cc-{uuid.uuid4().hex[:8]}"
    n = len(party_data)
    server = FedServerManager(
        FedCommManager(BrokerTransport(0, run_id), 0),
        client_ids=list(range(1, n + 1)), init_params=init_params_np,
        num_rounds=num_rounds, eval_fn=eval_fn,
        round_timeout=round_timeout, quorum_frac=quorum_frac, device=device)
    clients = [
        FedClientManager(
            FedCommManager(BrokerTransport(cid, run_id), cid), cid,
            SiloTrainer(model, t, *party_data[cid - 1], seed=cid,
                        device=device,
                        batch_schedule=None if batch_schedules is None
                        else batch_schedules[cid - 1]))
        for cid in range(1, n + 1)
    ]
    try:
        server.run(background=True)
        for i, c in enumerate(clients):
            if late_join_delay and i:
                time.sleep(late_join_delay)
            c.run(background=True)
            c.announce_ready()
        if not server.done.wait(timeout=600):
            raise TimeoutError("cross-cloud run did not finish")
        for c in clients:
            c.done.wait(timeout=30)
    finally:
        # stop every manager's receive thread on every path: a timed-out
        # run would otherwise leak N+1 threads polling the broker
        for mgr in [server] + clients:
            try:
                mgr.comm.stop()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
        release_broker(run_id)
    return server
