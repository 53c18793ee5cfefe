"""Device resolution for the port's entry points.

Every entry point (`DecodeEngine`, `TransformerLM`, `init_params`,
`params_from_flax`) runs on the GPU unless the caller names the CPU.
There is no silent fallback: asking for CUDA on a machine without a
visible GPU raises, so a run that was meant for the card can never
quietly measure the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(
        device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`None` means CUDA. Returns a `torch.device` of type cuda (with its
    index: "cuda" becomes the current device) or cpu; raises RuntimeError
    for CUDA without a GPU and ValueError for any other device type."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "fedml_tpu_torch runs on a CUDA GPU by default and no GPU "
                "is visible; pass device='cpu' explicitly to run the plain "
                "PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(
            f"fedml_tpu_torch supports device 'cuda' or 'cpu'; got {dev}")
    return dev
