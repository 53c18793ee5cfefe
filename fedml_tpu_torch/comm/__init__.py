"""The cross-silo message layer (port of `fedml_tpu/comm/`): the wire
format, the loopback, gRPC and broker transports, the comm manager,
reliable delivery, the chaos plane, the wire codec and the gossip
topologies. The gRPC transport (`comm.grpc_transport`) is not imported
here: it imports the `grpc` package, which a host may lack."""
from .base import BaseTransport, Observer
from .broker import (
    BrokerTransport, ContentAddressedBroker, InMemoryBroker, get_broker,
    get_cas_broker, release_broker,
)
from .chaos import ChaosTransport, FaultSpec
from .codec import CodecPolicy, validate_comm_codec
from .loopback import LoopbackTransport, get_router, release_router
from .manager import FedCommManager, create_transport
from .message import Message
from .reliable import DeliveryError, ReliableTransport, RetryPolicy
from .serialization import decode, encode
from .topology import AsymmetricTopologyManager, SymmetricTopologyManager

__all__ = [
    "BaseTransport", "Observer", "Message", "FedCommManager",
    "create_transport", "LoopbackTransport", "get_router", "release_router",
    "encode", "decode", "ChaosTransport", "FaultSpec", "ReliableTransport",
    "RetryPolicy", "DeliveryError", "BrokerTransport", "InMemoryBroker",
    "ContentAddressedBroker", "get_broker", "get_cas_broker",
    "release_broker", "CodecPolicy", "validate_comm_codec",
    "SymmetricTopologyManager", "AsymmetricTopologyManager",
]
