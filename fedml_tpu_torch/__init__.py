"""fedml_tpu_torch: the PyTorch/CUDA port of fedml_tpu for NVIDIA Hopper.

The JAX package `fedml_tpu` is the reference; this package imports
nothing of it (nor JAX) and is held against it by the `tests/test_torch_*`
suite. Ported so far: the FedAvg simulation path (`init` ->
`run_simulation` -> `simulation.Simulator`: config, data, the vision
models of `models.hub`, FedAvg / FedOpt / FedProx / FedNova, the round
with health stats, eval) on one GPU; the paged continuous-batching decode
engine (`serving.engine.DecodeEngine`) over a LLaMA-shaped
`llm.TransformerLM`, with decode attention through a hand-written CUDA
paged-attention kernel (`ops.paged_attention`); and federated LoRA
training (`llm.federated_lora` under `parallel.round.build_round_fn`) with
causal attention through hand-written CUDA flash-attention kernels
(`ops.flash_attention`: forward, dQ, dK/dV); and cross-silo FedAvg over
the message layer (`FedMLRunner` with `training_type: cross_silo`:
`comm/`, `cross_silo/`). Kernel sources are in `csrc/`.

Entry points default to `device="cuda"` and raise when no GPU is
visible; pass `device="cpu"` to run the plain PyTorch versions.
"""
from __future__ import annotations

import random

import numpy as np

from ._device import resolve_device
from .config import Config, load_config

__all__ = ["Config", "load_config", "init", "run_simulation",
           "resolve_device", "FedMLRunner"]


def __getattr__(name):
    # lazy, as in the JAX package: the runner pulls in the runtimes
    if name == "FedMLRunner":
        from .runner import FedMLRunner

        return FedMLRunner
    raise AttributeError(name)


def init(config_path: str | None = None, config: Config | dict | None = None,
         device=None, **overrides) -> Config:
    """Load and validate the config, seed Python's and numpy's global
    generators from `common_args.random_seed` (torch draws come only from
    explicit generators), and record the run's device (None: CUDA, which
    raises without a GPU) in `device_args.extra["device"]` for
    `run_simulation` and `FedMLRunner`. Tracking sinks, the model-artifact
    store (`tracking_args.artifact_store` / `artifact_dir`) and per-client
    silo overrides are not ported yet and raise (ROADMAP 'Port queue'
    item 5)."""
    if config_path is not None:
        cfg = load_config(config_path)
    elif isinstance(config, Config):
        cfg = config
    elif isinstance(config, dict):
        cfg = Config.from_dict(config)
    else:
        cfg = Config()
    for k, v in overrides.items():
        setattr(cfg, k, v)
    t = cfg.tracking_args
    if t.enable_tracking or t.enable_wandb or t.extra.get("log_upload_broker"):
        raise NotImplementedError(
            "tracking sinks (tracking_args) are not ported yet (ROADMAP "
            "'Port queue' item 5)")
    from .runner import refuse_artifact_store

    refuse_artifact_store(cfg)
    if cfg.rank > 0 and (cfg.client_specific_args.get("data_silo_config")
                         or cfg.train_args.extra.get("data_silo_config")):
        raise NotImplementedError(
            "per-client silo overrides (data_silo_config) are not ported "
            "yet (ROADMAP 'Port queue' item 5)")
    cfg.device_args.extra["device"] = str(resolve_device(device))
    random.seed(cfg.common_args.random_seed)
    np.random.seed(cfg.common_args.random_seed)
    return cfg


def run_simulation(cfg: Config, dataset=None, model=None, **kw):
    """The FedAvg simulation of `cfg` on one GPU (`simulation.simulator.
    run_simulation`; `kw`: device, params, batch_schedule). Returns the
    history."""
    from .simulation.simulator import run_simulation as _run

    return _run(cfg, dataset, model, **kw)
