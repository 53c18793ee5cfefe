"""The ported examples as the port's smoke suite, part 3: FedLLM's flat
and --int8 cases (`fedml_tpu_torch/examples/fedllm_lora.py`), in-process
on the CPU with `--device cpu`.

Each is handed the JAX example's f32 base and initial adapters
(converted to the port's state dicts; --int8 quantizes the base itself)
and the JAX round's batch orders, and held to the JAX example's calls
round by round (`torch_examples_common.py` states the bars); the
example's own asserts run on top. --int8's greedy tokens, served from
the trained adapters over the int8 base, equal the JAX example's."""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_examples_common import fedllm_case, fresh_metrics  # noqa: E402,F401

torch.set_num_threads(2)


@pytest.mark.parametrize("flag", ["", "--int8"], ids=["flat", "int8"])
def test_fedllm_lora(capsys, flag):
    fedllm_case(capsys, flag)
