"""Model serving: predictors, the continuous-batching decode engine and the
HTTP inference runner (port of `fedml_tpu/serving/__init__.py`).

`lm_predictor_from_config` builds the LM predictor from a Config's
`serve_args` (validated at load against `serving/knobs.py`);
`serve_simulator` serves a Simulator's global model over HTTP,
`predictor_from_checkpoint` a checkpoint it saved,
`predictor_from_artifact` a round's model from the artifact store and
`predictor_from_export` a framework-neutral export (`export_model`,
`load_export`; `serving/export.py`). The fleet (deploy FSM, gateway,
autoscaler) is `serving/scheduler.py`. Importing this package
stays light: the heavy symbols import on first attribute access (PEP
562), so `config.py` can read the knob registry at load time.
"""
from __future__ import annotations

import importlib
from typing import Callable

__all__ = [
    "Predictor", "TorchPredictor", "GreedyLMPredictor", "InvalidRequest",
    "StaleVersion", "DecodeEngine", "Ticket", "lm_predictor_from_config",
    "FedMLInferenceRunner", "DEFAULT_PORT", "serve_simulator",
    "predictor_from_checkpoint", "predictor_from_artifact",
    "export_model", "load_export", "predictor_from_export",
]

_LAZY = {
    "DecodeEngine": "engine", "Ticket": "engine",
    "export_model": "export", "load_export": "export",
    "predictor_from_export": "export",
    "DEFAULT_PORT": "inference_runner",
    "FedMLInferenceRunner": "inference_runner",
    "GreedyLMPredictor": "predictor", "TorchPredictor": "predictor",
    "Predictor": "predictor", "InvalidRequest": "predictor",
    "StaleVersion": "predictor",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(name)
    return getattr(importlib.import_module(f".{mod}", __name__), name)


def lm_predictor_from_config(cfg, model, adapters=None, detokenize=None,
                             device=None):
    """The LM serving predictor from a Config's `serve_args`:
    `decode_slots` > 0 starts the continuous-batching engine,
    `kv_page_size` > 0 makes it paged (`kv_n_pages`, `prefill_chunk`,
    `prefix_cache`, `paged_kernel`, `spec_decode` / `spec_k`, `kv_quant`),
    `admit_batch` batches its admissions, and `engine_max_len`,
    `engine_eos_id`, `engine_fetch_chunk`, `sampler_cache_size`,
    `kv_cache` and `drain_timeout_s` tune it
    (`predictor.lm_predictor_from_serve_knobs`). `model` is a
    `TransformerLM` on `device` (CUDA unless the caller names "cpu")."""
    from .predictor import lm_predictor_from_serve_knobs

    return lm_predictor_from_serve_knobs(
        cfg.serve_args.extra, model, adapters=adapters,
        detokenize=detokenize, device=device)


def predictor_from_artifact(store, round_idx: int, apply_fn: Callable,
                            device=None):
    """The round-N aggregated model from an artifact store
    (`utils/artifacts.py`; what `mlops.log_aggregated_model_info`
    published) wrapped as a `TorchPredictor` on `device` (CUDA unless the
    caller names "cpu")."""
    from .._device import resolve_device
    from ..utils.artifacts import aggregated_name
    from .predictor import TorchPredictor, params_to_torch

    dev = resolve_device(device)
    params = params_to_torch(store.get(aggregated_name(round_idx)))
    return TorchPredictor(apply_fn, params, device=dev)


def predictor_from_checkpoint(ckpt_dir: str, apply_fn: Callable,
                              server_template: dict, device=None):
    """The latest checkpoint's global model (`utils/checkpoint.py`, as a
    Simulator saves it) wrapped as a `TorchPredictor` on `device` (CUDA
    unless the caller names "cpu"). `server_template` is the saved
    server part's structure (a Simulator's `_server_dict()`)."""
    from .._device import resolve_device
    from ..utils.checkpoint import restore_checkpoint
    from .predictor import TorchPredictor

    dev = resolve_device(device)
    _r, server, _c, _h, _hist = restore_checkpoint(ckpt_dir, server_template,
                                                   device=dev)
    return TorchPredictor(apply_fn, server["params"], device=dev)


def serve_simulator(sim, host: str = "127.0.0.1", port: int = 0,
                    background: bool = True, device=None):
    """Serve a (trained) Simulator's global model over HTTP on `device`
    (CUDA unless the caller names "cpu"). The parameters are copied, so
    training can go on after this call without changing what is
    served."""
    from .inference_runner import FedMLInferenceRunner
    from .predictor import TorchPredictor

    pred = TorchPredictor(
        sim.apply_fn, {k: v.detach().clone()
                       for k, v in sim.server_state.params.items()},
        device=device)
    runner = FedMLInferenceRunner(pred, host=host, port=port)
    if background:
        runner.start()
    else:
        runner.run()
    return runner
