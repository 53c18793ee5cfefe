"""FedMLRunner — one dispatch from (training_type, role) to a runtime (port
of `fedml_tpu/runner.py`; reference: python/fedml/runner.py:19-181).

Ported modes:
- simulation:          `simulation.simulator.Simulator` on one GPU
- cross_silo, server:  `cross_silo.FedServerManager`, its initial
                       parameters from `hub.init_params` with a generator
                       seeded by `common_args.random_seed` (or `params=`)
- cross_silo, client:  `cross_silo.FedClientManager` over a `SiloTrainer`
                       (`dataset` = the silo's (x, y)); `rank` is the
                       client id, 1-based

Both cross-silo roles read the robustness and durability keys the JAX
runner reads: `common_args.extra.chaos` and `comm_retry`, the transport
(`comm_args.extra.transport`, loopback), `run_id`, and `train_args.extra`
round_timeout, quorum_frac, liveness_timeout_s, max_rearms,
checkpoint_dir / checkpoint_every / checkpoint_keep / resume,
server_timeout_s, reattach, heartbeat_s; the client's upload DP comes from
`dp_args` (`dp.make_upload_dp`). Every role runs on `device` (default: the
device `init` recorded, else CUDA).

Not ported, each refused with a NotImplementedError naming its ROADMAP
'Port queue' item: async simulation, `fa_task`, cross_device and
centralized (item 5); SecAgg (`train_args.extra.secagg`) and the wire
codec (`comm_args.extra.comm_codec`) (item 5); the hierarchical scenario
and a silo `mesh` (item 4); the gRPC and broker transports (item 5,
`comm.create_transport`); the model-artifact store
(`tracking_args.extra.artifact_store` / `artifact_dir`, item 5).
"""
from __future__ import annotations

from typing import Optional

import torch

from ._device import resolve_device
from .config import (
    Config, SCENARIO_HIERARCHICAL, TRAINING_TYPE_CENTRALIZED,
    TRAINING_TYPE_CROSS_DEVICE, TRAINING_TYPE_CROSS_SILO,
    TRAINING_TYPE_SIMULATION,
)


def _later(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP 'Port queue' item {item})")


def refuse_artifact_store(cfg: Config) -> None:
    """The JAX package publishes models to an artifact store named by these
    keys; the port has none, so it refuses them rather than ignore them."""
    tr = cfg.tracking_args.extra
    if tr.get("artifact_store") or tr.get("artifact_dir"):
        raise _later("the model-artifact store (tracking_args."
                     "artifact_store / artifact_dir)", "5")


class FedMLRunner:
    """(reference: runner.py:19) config -> runtime with .run()."""

    def __init__(self, cfg: Config, dataset=None, model=None,
                 role: str = "server", rank: int = 0,
                 transport: Optional[str] = None, **kw):
        self.cfg = cfg
        refuse_artifact_store(cfg)
        tt = cfg.common_args.training_type
        if cfg.train_args.extra.get("fa_task"):
            raise _later("federated analytics (train_args.fa_task)", "5")
        if tt == TRAINING_TYPE_SIMULATION:
            self.runner = self._init_simulation(dataset, model, **kw)
        elif tt == TRAINING_TYPE_CROSS_SILO:
            self.runner = self._init_cross_silo(
                dataset, model, role, rank, transport, **kw)
        elif tt in (TRAINING_TYPE_CROSS_DEVICE, TRAINING_TYPE_CENTRALIZED):
            raise _later(f"training_type {tt!r}", "5")
        else:
            raise ValueError(
                f"no runner for training_type={tt!r} (reference parity: "
                "simulation / cross_silo / cross_device / centralized; "
                "cross_cloud is covered by cross_silo across regions)")

    def _device(self, kw: dict) -> torch.device:
        dev = kw.pop("device", None)
        return resolve_device(dev if dev is not None else
                              self.cfg.device_args.extra.get("device"))

    # ------------------------------------------------------------ simulation
    def _init_simulation(self, dataset, model, **kw):
        t = self.cfg.train_args
        if t.extra.get("async") or t.extra.get("async_mode"):
            raise _later("the async simulator (train_args.async)", "5")
        from .simulation.simulator import Simulator

        return Simulator(self.cfg, dataset, model, **kw)

    # ------------------------------------------------------------ cross-silo
    def _init_cross_silo(self, dataset, model, role, rank, transport, **kw):
        from .comm import FedCommManager, create_transport

        cfg = self.cfg
        t = cfg.train_args
        if t.extra.get("secagg"):
            raise _later("secure aggregation (train_args.secagg: "
                         "cross_silo/secagg_manager.py with mpc/)", "5")
        if cfg.common_args.scenario == SCENARIO_HIERARCHICAL \
                or kw.get("mesh") is not None:
            raise _later("the hierarchical scenario (an intra-silo device "
                         "mesh)", "4, multi-GPU")
        kw.pop("mesh", None)
        device = self._device(kw)
        backend = transport or cfg.comm_args.extra.get("transport", "loopback")
        run_id = cfg.comm_args.extra.get("run_id", "cs")
        # the robustness stack rides the same config keys on both roles;
        # create_transport refuses the unported transports and the codec
        tr = create_transport(
            backend, rank, run_id=run_id,
            chaos=cfg.common_args.extra.get("chaos"),
            comm_retry=cfg.common_args.extra.get("comm_retry"),
            comm_codec=cfg.comm_args.extra.get("comm_codec"))
        comm = FedCommManager(tr, rank)
        client_ids = list(range(1, t.client_num_in_total + 1))
        ck_every = t.extra.get("checkpoint_every")
        ckpt_kw = dict(
            checkpoint_dir=t.extra.get("checkpoint_dir"),
            # an explicit 0 means no cadence checkpoints
            checkpoint_every=1 if ck_every is None else int(ck_every),
            checkpoint_keep=int(t.extra.get("checkpoint_keep", 3)),
            resume=bool(t.extra.get("resume")),
        )

        if role == "server":
            params = kw.pop("params", None)
            kw.pop("input_shape", None)   # the port's modules carry theirs
            if params is None:
                if model is None:
                    raise ValueError("cross-silo server needs `model` (or "
                                     "`params`)")
                from .models import hub

                gen = torch.Generator(device=device)
                gen.manual_seed(int(cfg.common_args.random_seed))
                params = hub.init_params(model, gen)
            params = {k: (v.detach().cpu().numpy()
                          if isinstance(v, torch.Tensor) else v)
                      for k, v in params.items()}
            from .cross_silo import FedServerManager

            return FedServerManager(
                comm, client_ids=client_ids, init_params=params,
                num_rounds=t.comm_round,
                client_num_per_round=t.client_num_per_round,
                round_timeout=t.extra.get("round_timeout"),
                quorum_frac=float(t.extra.get("quorum_frac", 1.0)),
                liveness_timeout_s=t.extra.get("liveness_timeout_s"),
                max_rearms=int(t.extra.get("max_rearms", 5)),
                device=device, **ckpt_kw, **kw)

        # role == client: rank is the client id (1-based)
        if dataset is None or model is None:
            raise ValueError("cross-silo client needs `dataset`=(x, y) and "
                             "`model`")
        from .cross_silo import FedClientManager, SiloTrainer
        from .dp import make_upload_dp

        x, y = dataset
        trainer = SiloTrainer(model, t, x, y, seed=rank, device=device,
                              batch_schedule=kw.pop("batch_schedule", None))
        # a resumable server implies re-attaching clients (they must
        # re-announce to the restarted incarnation); `reattach` overrides
        return FedClientManager(
            comm, rank, trainer,
            server_timeout_s=t.extra.get("server_timeout_s"),
            reattach=bool(t.extra.get("reattach", t.extra.get("resume"))),
            heartbeat_s=t.extra.get("heartbeat_s"),
            dp_upload=make_upload_dp(cfg, seed=rank), **kw)

    def run(self, *a, **kw):
        return self.runner.run(*a, **kw)
