"""FedMLRunner — one dispatch from (training_type, role) to a runtime (port
of `fedml_tpu/runner.py`; reference: python/fedml/runner.py:19-181).

Ported modes:
- simulation:            `simulation.simulator.Simulator` on one GPU
- cross_silo, server:    `cross_silo.FedServerManager` (with
                         `train_args.extra.secagg`: `SecAggServerManager`),
                         its initial parameters from `hub.init_params` with
                         a generator seeded by `common_args.random_seed`
                         (or `params=`)
- cross_silo, client:    `cross_silo.FedClientManager` (with secagg:
                         `SecAggClientManager`, its pre-mask sparsifier
                         from `comm_codec.secagg_premask_ratio`) over a
                         `SiloTrainer` (`dataset` = the silo's (x, y));
                         `rank` is the client id, 1-based
- cross_device, server:  `cross_device.CrossDeviceServer` (`min_devices`,
                         `round_timeout` default 30 s, in train_args.extra)
- cross_device, client:  `cross_device.EdgeClient` over a `SiloTrainer`
                         (`uplink_topk` in train_args.extra)

The message-layer roles read the keys the JAX runner reads:
`common_args.extra.chaos` and `comm_retry`, the transport
(`comm_args.extra.transport`: loopback, broker / mqtt_s3 / mqtt, or
mqtt_web3 / mqtt_thetastore / web3), `run_id`, the wire codec
(`comm_args.extra.comm_codec`, cross-silo, on both roles), and
`train_args.extra` round_timeout, quorum_frac, liveness_timeout_s,
max_rearms, checkpoint_dir / checkpoint_every / checkpoint_keep / resume,
server_timeout_s, reattach, heartbeat_s; the plain client's upload DP
comes from `dp_args` (`dp.make_upload_dp`). Every role runs on `device`
(default: the device `init` recorded, else CUDA); the SecAgg server's
unmask is host work.

Not ported, each refused with a NotImplementedError naming its ROADMAP
'Port queue' item: async simulation, `fa_task` and centralized (item 5);
the hierarchical scenario and a silo `mesh` (item 4); the gRPC transport
(item 5, `comm.create_transport`); the model-artifact store
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
        elif tt == TRAINING_TYPE_CROSS_DEVICE:
            self.runner = self._init_cross_device(
                dataset, model, role, rank, transport, **kw)
        elif tt == TRAINING_TYPE_CENTRALIZED:
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

    def _comm(self, backend, rank: int, default_run_id: str, **codec):
        """A FedCommManager over `backend` (or comm_args.extra.transport),
        with the chaos and retry stack of common_args.extra. Loopback and
        broker runs are namespaced by run_id: the broker is
        store-and-forward, so a shared namespace would leak one run's
        frames into the next."""
        from .comm import FedCommManager, create_transport

        cfg = self.cfg
        tr = create_transport(
            backend or cfg.comm_args.extra.get("transport", "loopback"),
            rank, run_id=cfg.comm_args.extra.get("run_id", default_run_id),
            chaos=cfg.common_args.extra.get("chaos"),
            comm_retry=cfg.common_args.extra.get("comm_retry"), **codec)
        return FedCommManager(tr, rank)

    def _init_params(self, model, device, kw: dict) -> dict:
        """The server's initial parameters as a numpy dict: `params=`, or
        `hub.init_params` drawn with common_args.random_seed on `device`."""
        params = kw.pop("params", None)
        kw.pop("input_shape", None)   # the port's modules carry theirs
        if params is None:
            if model is None:
                raise ValueError("the server needs `model` (or `params`)")
            from .models import hub

            gen = torch.Generator(device=device)
            gen.manual_seed(int(self.cfg.common_args.random_seed))
            params = hub.init_params(model, gen)
        return {k: (v.detach().cpu().numpy()
                    if isinstance(v, torch.Tensor) else v)
                for k, v in params.items()}

    # ------------------------------------------------------------ cross-silo
    def _init_cross_silo(self, dataset, model, role, rank, transport, **kw):
        cfg = self.cfg
        t = cfg.train_args
        if cfg.common_args.scenario == SCENARIO_HIERARCHICAL \
                or kw.get("mesh") is not None:
            raise _later("the hierarchical scenario (an intra-silo device "
                         "mesh)", "4, multi-GPU")
        kw.pop("mesh", None)
        device = self._device(kw)
        # the wire codec rides comm_args.comm_codec on both roles: delta
        # frames decode against the receiving end's anchor state, so a
        # one-sided codec would be a loud decode error, not savings
        codec_cfg = cfg.comm_args.extra.get("comm_codec")
        comm = self._comm(transport, rank, "cs", comm_codec=codec_cfg)
        secagg = bool(t.extra.get("secagg"))
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
            params = self._init_params(model, device, kw)
            if secagg:
                from .cross_silo import SecAggServerManager

                return SecAggServerManager(
                    comm, client_ids=client_ids, init_params=params,
                    num_rounds=t.comm_round,
                    round_timeout=t.extra.get("round_timeout"),
                    **ckpt_kw, **kw)
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
        from .cross_silo import SiloTrainer

        x, y = dataset
        trainer = SiloTrainer(model, t, x, y, seed=rank, device=device,
                              batch_schedule=kw.pop("batch_schedule", None))
        if secagg:
            from .cross_silo import SecAggClientManager

            # quantize-then-mask: the lossy sparsify before the shared
            # field scale and the mask; the wire leg (field_pack) rides the
            # transport's codec above
            return SecAggClientManager(
                comm, rank, trainer, num_clients=len(client_ids),
                client_ids=client_ids,
                premask_ratio=(codec_cfg or {}).get("secagg_premask_ratio"),
                **kw)
        from .cross_silo import FedClientManager
        from .dp import make_upload_dp

        # a resumable server implies re-attaching clients (they must
        # re-announce to the restarted incarnation); `reattach` overrides
        return FedClientManager(
            comm, rank, trainer,
            server_timeout_s=t.extra.get("server_timeout_s"),
            reattach=bool(t.extra.get("reattach", t.extra.get("resume"))),
            heartbeat_s=t.extra.get("heartbeat_s"),
            dp_upload=make_upload_dp(cfg, seed=rank), **kw)

    # ---------------------------------------------------------- cross-device
    def _init_cross_device(self, dataset, model, role, rank, transport, **kw):
        t = self.cfg.train_args
        device = self._device(kw)
        comm = self._comm(transport, rank, "cd")
        if role == "server":
            from .cross_device import CrossDeviceServer

            return CrossDeviceServer(
                comm, init_params=self._init_params(model, device, kw),
                num_rounds=t.comm_round,
                devices_per_round=t.client_num_per_round,
                min_devices=int(t.extra.get("min_devices",
                                            t.client_num_per_round)),
                round_timeout=float(t.extra.get("round_timeout", 30.0)),
                device=device, **kw)
        if dataset is None or model is None:
            raise ValueError("cross-device client needs `dataset`=(x, y) "
                             "and `model`")
        from .cross_device import EdgeClient
        from .cross_silo import SiloTrainer

        x, y = dataset
        trainer = SiloTrainer(model, t, x, y, seed=rank, device=device,
                              batch_schedule=kw.pop("batch_schedule", None))
        return EdgeClient(comm, rank, trainer,
                          uplink_topk=t.extra.get("uplink_topk"), **kw)

    def run(self, *a, **kw):
        return self.runner.run(*a, **kw)
