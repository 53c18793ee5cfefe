"""Hierarchical cross-silo: per-silo device meshes under the cross-silo
message layer (port of `fedml_tpu/cross_silo/hierarchical.py`; reference:
python/fedml/__init__.py:342-390 spawns one process per intra-silo rank,
fedml_client_master_manager.py:195-207 has the master rank talk to the
server while slave ranks follow, fedml_trainer_dist_adapter.py:9 and
process_group_manager.py:8 run DDP inside the silo).

A silo's devices are a `SiloMesh` (`silo_mesh`): ranks that form a world
of their own and train the silo's shard data-parallel, each step's
gradient all-reduced over the silo's `data` axis. A silo of one device
needs no ranks: it is the flat `SiloTrainer` on that device. The silo's
`SiloTrainer`, in the calling process, is the master: only it exists at
the message layer, and the outer level is the ordinary cross-silo FSM
(`server.py`, `client.py`) over loopback, or gRPC between hosts.

`run_hierarchical` composes it all in one process, as JAX's does: the
server and every silo master share the process-global loopback mailboxes
under a fresh `run_id` a call, released in a `finally`, where the silos'
ranks are stopped too, whether the run ends or fails. For a deployment,
build one `SiloTrainer(mesh=silo_mesh(local devices))` per host and use
gRPC transports.
"""
from __future__ import annotations

import uuid
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from ..comm import FedCommManager
from ..comm.loopback import LoopbackTransport, release_router
from ..config import TrainArgs
from .client import FedClientManager
from .server import FedServerManager
from .trainer import SiloMesh, SiloTrainer

Pytree = Any


def silo_mesh(devices: Sequence, data_axis: str = "data",
              timeout_s: float = 600.0,
              setup: Optional[Callable] = None) -> SiloMesh:
    """A silo's intra mesh: one rank per device (a device may repeat:
    several gloo ranks can share one GPU), 1-D data-parallel on
    `data_axis`; `setup` runs once in each rank."""
    return SiloMesh(devices, data_axis, timeout_s, setup)


def _visible_gpus() -> list:
    return [f"cuda:{i}" for i in range(torch.cuda.device_count())]


def partition_devices(n_silos: int, devices=None) -> list[list]:
    """Split the devices (default: every visible GPU) into n_silos
    disjoint contiguous groups, the one-host stand-in for "each silo owns
    its own hosts". Uneven counts give the first silos one more device;
    no device is dropped."""
    devices = list(devices if devices is not None else _visible_gpus())
    if n_silos > len(devices):
        raise ValueError(
            f"{n_silos} silos need at least {n_silos} devices, have "
            f"{len(devices)}")
    per, extra = divmod(len(devices), n_silos)
    groups, start = [], 0
    for i in range(n_silos):
        size = per + (1 if i < extra else 0)
        groups.append(devices[start:start + size])
        start += size
    return groups


def run_hierarchical(
    model,
    init_params_np: Pytree,
    t: TrainArgs,
    silo_data: Sequence[tuple[np.ndarray, np.ndarray]],
    num_rounds: int,
    eval_fn: Optional[Callable[[Pytree, int], dict]] = None,
    run_id: Optional[str] = None,
    round_timeout: Optional[float] = None,
    quorum_frac: float = 1.0,
    aggregate_fn: Optional[Callable] = None,
    devices=None,
    device=None,
    timeout_s: float = 600.0,
    setup: Optional[Callable] = None,
) -> FedServerManager:
    """N silos (`silo_data`, a (x, y) each), silo i a `SiloTrainer` on its
    share of `devices` (`partition_devices`; default: every visible GPU):
    over a silo mesh of that share (`silo_mesh`, `setup` run once in each
    of its ranks), or, for a share of one device, the flat trainer on it
    in this process; FedAvg across them over loopback. `model` is a module
    of `models/hub.py` (pickled to the silos' ranks); the server
    aggregates on `device` (default: the first silo's first device).
    Returns the finished server manager (history, params) with
    `silo_rank_stats` (each silo's ranks' stats of the last round) and
    `silo_exitcodes` (their exit codes; both empty for a one-device
    silo)."""
    # a fresh run_id per call: loopback mailboxes are process-global per
    # run_id, so reusing one would hand this run a previous run's frames
    if run_id is None:
        run_id = f"hier-{uuid.uuid4().hex[:8]}"
    n_silos = len(silo_data)
    groups = partition_devices(n_silos, devices)
    meshes: list = []
    try:
        # every silo's ranks start before the first trainer waits on its own
        meshes = [silo_mesh(g, timeout_s=timeout_s, setup=setup)
                  if len(g) > 1 else None for g in groups]
        trainers = [
            SiloTrainer(model, t, x, y, mesh=meshes[i], seed=i,
                        device=groups[i][0])
            for i, (x, y) in enumerate(silo_data)]
        server = FedServerManager(
            FedCommManager(LoopbackTransport(0, run_id), 0),
            client_ids=list(range(1, n_silos + 1)),
            init_params=init_params_np, num_rounds=num_rounds,
            eval_fn=eval_fn, round_timeout=round_timeout,
            quorum_frac=quorum_frac, aggregate_fn=aggregate_fn,
            device=device if device is not None else groups[0][0])
        clients = [
            FedClientManager(FedCommManager(LoopbackTransport(cid, run_id),
                                            cid), cid, trainers[cid - 1])
            for cid in range(1, n_silos + 1)]
        server.run(background=True)
        for c in clients:
            c.run(background=True)
        for c in clients:
            c.announce_ready()
        if not server.done.wait(timeout=timeout_s):
            raise TimeoutError("hierarchical cross-silo run did not finish")
        for c in clients:
            c.done.wait(timeout=30)
        server.silo_rank_stats = [tr.rank_stats for tr in trainers]
    finally:
        release_router(run_id)
        codes = [[] if m is None else m.close() for m in meshes]
    server.silo_exitcodes = codes
    return server
