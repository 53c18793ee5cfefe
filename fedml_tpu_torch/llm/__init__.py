"""FedLLM: federated LoRA fine-tuning of the LLaMA-shaped LM (port of the
flat composition of `fedml_tpu/llm/__init__.py`).

`federated_lora` makes the adapters the federated model: the round engine
(`parallel/round.py`) and FedAvg train and exchange only the adapter dict,
and the base weights never move. The long-context `make_fedllm_seq_round`
(ring / Ulysses attention over a sequence mesh) is in ROADMAP's port queue.
"""
from __future__ import annotations

from ..algorithms.builtin import make_fedavg
from ..config import TrainArgs
from ..core.algorithm import FedAlgorithm, autograd_grad
from ..models.hub import mixed_precision_apply
from .lora import count_params, lora_apply_fn, lora_init, lora_merge
from .transformer import TransformerLM

__all__ = ["TransformerLM", "lora_init", "lora_merge", "lora_apply_fn",
           "count_params", "federated_lora"]


def federated_lora(model: TransformerLM, base_state: dict, t: TrainArgs,
                   generator, rank: int = 8, alpha: float = 16.0,
                   targets=("wq", "wk", "wv", "wo")
                   ) -> tuple[FedAlgorithm, dict]:
    """(FedAvg over adapters, initial adapters). `base_state` is the
    model's own state (`TransformerLM.from_state`); the adapters' A is
    drawn from `generator`. `t.compute_dtype` is honoured as in the JAX
    function: the model runs under `mixed_precision_apply`, the adapters
    and the optimizer stay f32. Gradients come from `torch.autograd.grad`
    (`core.algorithm.autograd_grad`): the model's per-block remat installs
    saved-tensor hooks, which `torch.func.grad` refuses, and so the round
    cannot vmap these clients either (ROADMAP 'Port queue' item 3d.1b)."""
    own = model.state_dict()
    if own.keys() != base_state.keys() or any(
            own[k].data_ptr() != v.data_ptr() for k, v in base_state.items()):
        raise ValueError("base_state must be the model's own state "
                         "(build the model with TransformerLM.from_state)")
    adapters = lora_init(base_state, rank, targets, generator=generator)
    base_apply = mixed_precision_apply(model, t.compute_dtype)
    return make_fedavg(lora_apply_fn(base_apply, alpha), t,
                       grad_engine=autograd_grad), adapters
