"""fedml_tpu_torch: the PyTorch/CUDA port of fedml_tpu for NVIDIA Hopper.

The JAX package `fedml_tpu` is the reference; this package imports
nothing of it (nor JAX) and is held against it by the `tests/test_torch_*`
suite. Ported so far: the paged continuous-batching decode engine
(`serving.engine.DecodeEngine`) over a LLaMA-shaped `llm.TransformerLM`,
with decode attention through a hand-written CUDA paged-attention kernel
(`ops.paged_attention`), and federated LoRA training
(`llm.federated_lora` under `parallel.round.build_round_fn`) with causal
attention through hand-written CUDA flash-attention kernels
(`ops.flash_attention`: forward, dQ, dK/dV). Kernel sources are in
`csrc/`.

Entry points default to `device="cuda"` and raise when no GPU is
visible; pass `device="cpu"` to run the plain PyTorch versions.
"""
from ._device import resolve_device

__all__ = ["resolve_device"]
