"""Cross-silo FL runtime (port of `fedml_tpu/cross_silo/`): the server
and client managers over the comm layer, their SecAgg variants, the silo
trainer on the card, and the kill–restart soak harness. The hierarchical
scenario (an intra-silo device mesh) is not ported (ROADMAP 'Port queue'
item 4)."""
from .client import FedClientManager
from .message_define import *  # noqa: F401,F403
from .secagg_manager import SecAggClientManager, SecAggServerManager
from .server import FedAggregator, FedServerManager
from .trainer import SiloTrainer

__all__ = [
    "FedClientManager", "FedServerManager", "FedAggregator", "SiloTrainer",
    "SecAggServerManager", "SecAggClientManager",
]
