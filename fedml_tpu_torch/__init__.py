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
training (`llm.federated_lora` under `parallel.round.build_round_fn`,
clients one at a time or in vmapped groups) with causal attention through
hand-written CUDA flash-attention kernels (`ops.flash_attention`:
forward, dQ, dK/dV), over a float or an int8 base (`llm.quant`), and the
long-context round over a (silos, seq) mesh (`llm.make_fedllm_seq_round`,
`parallel.seq`); and cross-silo FedAvg over
the message layer (`FedMLRunner` with `training_type: cross_silo`:
`comm/`, `cross_silo/`); and the single-process entry surface
(`python -m fedml_tpu_torch`, `mlops`, the telemetry sinks, the
model-artifact store). Kernel sources are in `csrc/`.

Entry points default to `device="cuda"` and raise when no GPU is
visible; pass `device="cpu"` to run the plain PyTorch versions.
"""
from __future__ import annotations

import logging
import random
from pathlib import Path

import numpy as np

from ._device import resolve_device
from .config import Config, load_config
from .core.registry import ALGORITHMS, DATASETS, MODELS

__version__ = "0.1.0"

__all__ = ["Config", "load_config", "init", "run_simulation",
           "run_async_simulation", "resolve_device", "FedMLRunner",
           "ALGORITHMS", "DATASETS", "MODELS", "__version__"]


def __getattr__(name):
    # lazy, as in the JAX package: the runner pulls in the runtimes
    if name == "FedMLRunner":
        from .runner import FedMLRunner

        return FedMLRunner
    raise AttributeError(name)


def init(config_path: str | None = None, config: Config | dict | None = None,
         device=None, **overrides) -> Config:
    """Load and validate the config, merge a client rank's
    `data_silo_config` override file (resolved against the config file's
    directory), seed Python's and numpy's global generators from
    `common_args.random_seed` (torch draws come only from explicit
    generators), set up logging, attach the tracking sinks
    `tracking_args` asks for (`utils/sinks.attach_from_config`), and
    record the run's device (None: CUDA, which raises without a GPU) in
    `device_args.extra["device"]` for `run_simulation` and
    `FedMLRunner`."""
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
    cfg.apply_data_silo_config(
        Path(config_path).expanduser().parent if config_path else None)
    cfg.device_args.extra["device"] = str(resolve_device(device))
    random.seed(cfg.common_args.random_seed)
    np.random.seed(cfg.common_args.random_seed)
    logging.basicConfig(level=logging.INFO)
    from .utils.sinks import attach_from_config

    attach_from_config(cfg)
    return cfg


def run_simulation(cfg: Config, dataset=None, model=None, **kw):
    """The FedAvg simulation of `cfg` on one GPU (`simulation.simulator.
    run_simulation`; `kw`: device, params, batch_schedule). Returns the
    history."""
    from .simulation.simulator import run_simulation as _run

    return _run(cfg, dataset, model, **kw)


def run_async_simulation(cfg: Config, dataset=None, model=None, **kw):
    """Staleness-weighted asynchronous FL of `cfg` (`simulation.
    async_simulator.run_async_simulation`; `kw`: device, params,
    batch_idx). Returns
    the history."""
    from .simulation.async_simulator import run_async_simulation as _run

    return _run(cfg, dataset, model, **kw)
