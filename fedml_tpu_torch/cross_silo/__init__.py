"""Cross-silo FL runtime (port of `fedml_tpu/cross_silo/`): the server
and client managers over the comm layer, their SecAgg variants, the silo
trainer on the card (data-parallel over an intra-silo mesh when given
one), the hierarchical composition (`hierarchical.py`) and the
kill–restart soak harness."""
from .client import FedClientManager
from .hierarchical import partition_devices, run_hierarchical, silo_mesh
from .message_define import *  # noqa: F401,F403
from .secagg_manager import SecAggClientManager, SecAggServerManager
from .server import FedAggregator, FedServerManager
from .trainer import SiloTrainer

__all__ = [
    "FedClientManager", "FedServerManager", "FedAggregator", "SiloTrainer",
    "SecAggServerManager", "SecAggClientManager", "run_hierarchical",
    "partition_devices", "silo_mesh",
]
