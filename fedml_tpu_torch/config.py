"""Client and server training arguments: the fields of
`fedml_tpu/config.py:TrainArgs` that the ported training path reads,
with the same names and defaults."""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class TrainArgs:
    epochs: int = 1
    batch_size: int = 10
    client_optimizer: str = "sgd"
    learning_rate: float = 0.03
    momentum: float = 0.0
    weight_decay: float = 0.0
    server_optimizer: str = "sgd"
    server_lr: float = 1.0
    server_momentum: float = 0.0
    # "float32" or "bfloat16": bf16 runs the model's matmuls in bf16 while
    # the trained parameters and the optimizer stay f32
    compute_dtype: str = "float32"
    extra: dict = field(default_factory=dict)
