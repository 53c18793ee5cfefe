"""Cross-silo FL runtime (port of `fedml_tpu/cross_silo/`): the server
and client managers over the comm layer, the silo trainer on the card, and
the kill–restart soak harness. The SecAgg managers and the hierarchical
scenario (an intra-silo device mesh) are not ported (ROADMAP 'Port queue'
items 5 and 4)."""
from .client import FedClientManager
from .message_define import *  # noqa: F401,F403
from .server import FedAggregator, FedServerManager
from .trainer import SiloTrainer

__all__ = [
    "FedClientManager", "FedServerManager", "FedAggregator", "SiloTrainer",
]
