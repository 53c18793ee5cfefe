"""Cross-silo federation on one box (port of
examples/cross_silo_federation.py; the reference "octopus" example,
python/examples/federate/quick_start/octopus/ — there run as separate
server/client processes; here composed in-process over loopback. Swap the
transports for "grpc" (+ip table) or "mqtt_s3" (broker) for real
deployments — the managers don't change).

Run:  python -m fedml_tpu_torch.examples.cross_silo_federation [--secagg]
          [--device cpu]
"""
from __future__ import annotations

import uuid

import numpy as np
import torch

from fedml_tpu_torch._device import resolve_device
from fedml_tpu_torch.comm import FedCommManager, create_transport
from fedml_tpu_torch.comm.loopback import release_router
from fedml_tpu_torch.config import TrainArgs
from fedml_tpu_torch.cross_silo import (
    FedClientManager, FedServerManager, SecAggClientManager,
    SecAggServerManager, SiloTrainer,
)
from fedml_tpu_torch.examples import parser
from fedml_tpu_torch.models import hub


def main(argv=None, draws=None) -> dict:
    """The server's last history row, with every row under "history" and
    the final global parameters under "params". `draws` (optional):
    {"params": the initial parameters, "batches": {silo id: each round's
    [steps, B] batch order, by round}}."""
    ap = parser(__doc__)
    ap.add_argument("--secagg", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    secagg = args.secagg
    run_id = f"example-{uuid.uuid4().hex[:6]}"
    n_silos = 3
    model = hub.create("lr", 3, (8,), device="meta")
    t = TrainArgs(epochs=2, batch_size=16, learning_rate=0.2)
    params = ({k: v.numpy() for k, v in hub.init_params(
        hub.create("lr", 3, (8,), device="cpu"),
        torch.Generator().manual_seed(0)).items()}
        if draws is None else draws["params"])
    client_ids = list(range(1, n_silos + 1))

    def mk(rank):
        return FedCommManager(
            create_transport("loopback", rank, run_id=run_id), rank)

    if secagg:
        server = SecAggServerManager(mk(0), client_ids=client_ids,
                                     init_params=params, num_rounds=3)
    else:
        # quorum 2-of-3: math.ceil(quorum_frac * 3) must equal 2, so use
        # the exact fraction (0.67 would ceil to 3 and demand every client)
        server = FedServerManager(mk(0), client_ids=client_ids,
                                  init_params=params, num_rounds=3,
                                  round_timeout=30.0, quorum_frac=2 / 3,
                                  device=dev)

    rs = np.random.RandomState(0)
    w_true = rs.randn(8, 3)
    clients = []
    for cid in client_ids:
        x = rs.randn(64, 8).astype(np.float32)
        y = np.argmax(x @ w_true, 1).astype(np.int32)
        trainer = SiloTrainer(
            model, t, x, y, seed=cid, device=dev,
            batch_schedule=None if draws is None
            else draws["batches"][cid].__getitem__)
        if secagg:
            clients.append(SecAggClientManager(
                mk(cid), cid, trainer, num_clients=n_silos,
                client_ids=client_ids))
        else:
            clients.append(FedClientManager(mk(cid), cid, trainer))

    server.run(background=True)
    for c in clients:
        c.run(background=True)
    for c in clients:
        c.announce_ready()
    finished = server.done.wait(timeout=300)
    release_router(run_id)
    if not finished:
        raise TimeoutError("federation did not finish within 300s "
                           f"(history so far: {server.history})")
    print(("secagg " if secagg else "") + "federation history:",
          server.history)
    return {**server.history[-1], "history": server.history,
            "params": server.params}


if __name__ == "__main__":
    main()
