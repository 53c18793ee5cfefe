"""Federated analytics, non-ML federated computation (port of
`fedml_tpu/fa/`; reference: python/fedml/fa/): the tasks of `fa/tasks.py`
(avg, frequency estimation, union, intersection, k-percentile, TrieHH
heavy hitters with DP) and the runtimes of `fa/runner.py` (the in-process
FASimulator and a cross-silo manager pair over the comm layer).
"""
from .runner import (
    FAClientManager, FASimulator, FAServerManager, run_fa_cross_silo,
)
from .tasks import FA_TASKS, FATask

__all__ = [
    "FA_TASKS", "FATask", "FASimulator", "FAServerManager",
    "FAClientManager", "run_fa_cross_silo",
]
