"""The shipped examples, ported (`examples/*.py` of the JAX package): the
same flows, sizes, printed lines and internal asserts, on the port.

    python -m fedml_tpu_torch.examples.<name> [flags] [--device cpu]

Each module's `main(argv)` runs the example and returns its final
reading (a dict); `--device` defaults to `cuda`, which raises where no
GPU is visible, as every entry point of the port does. Draws come from
explicit `torch.Generator`s under the JAX examples' seeds. The examples
whose run is fixed once their draws are, take `main(argv, draws=...)`:
given initial parameters and batch orders in place of their own draws
(the keys in each `main`'s docstring), so that a run can be held to
another one's, the JAX example's in the tests. Where a JAX example runs
a `jax.sharding.Mesh` over 8 virtual devices, the port's runs the same
mesh as 8 `parallel/launch.RankPool` ranks (gloo; on one card the ranks
share it); their kernel launches happen in the ranks, which return them
(`kernel_launches`) for the reading's `rank_launches`.
"""
from __future__ import annotations

import argparse

EXAMPLES = ("quick_start_simulation", "cross_silo_federation",
            "hierarchical_cross_silo", "fedllm_lora", "serving_deploy",
            "federated_segmentation", "attack_vs_defense",
            "federated_analytics", "platform_api")
# the smoke suite: (example, flags), the 12 cases of the JAX package's
# tests/test_examples.py
CASES = (
    ("quick_start_simulation", ()),
    ("cross_silo_federation", ()),
    ("cross_silo_federation", ("--secagg",)),
    ("hierarchical_cross_silo", ()),
    ("fedllm_lora", ()),
    ("fedllm_lora", ("--ring",)),
    ("fedllm_lora", ("--int8",)),
    ("serving_deploy", ()),
    ("federated_segmentation", ()),
    ("attack_vs_defense", ()),
    ("federated_analytics", ()),
    ("platform_api", ()),
)


def kernel_launches(reset: bool = False) -> dict:
    """This process's K1-K4 launch counts: `ops/flash_attention`'s by
    kernel and `ops/paged_attention`'s as "paged"; `reset` sets them to
    0 first."""
    from fedml_tpu_torch.ops import flash_attention as fa
    from fedml_tpu_torch.ops import paged_attention as pa

    if reset:
        fa.launch_count.update(dict.fromkeys(fa.launch_count, 0))
        pa.launch_count = 0
    return {**fa.launch_count, "paged": pa.launch_count}


def summed(counts: list) -> dict:
    """The launch counts of several ranks, added up by kernel."""
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def parser(doc: str) -> argparse.ArgumentParser:
    """An example's argument parser: its docstring's first paragraph as
    the description, and `--device`."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a GPU) or cpu")
    return ap
