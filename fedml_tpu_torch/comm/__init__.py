"""The cross-silo message layer (port of `fedml_tpu/comm/`): the wire
format, the loopback and broker transports, the comm manager, reliable
delivery, the chaos plane and the wire codec. The gRPC transport is not
ported (ROADMAP 'Port queue' item 5)."""
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

__all__ = [
    "BaseTransport", "Observer", "Message", "FedCommManager",
    "create_transport", "LoopbackTransport", "get_router", "release_router",
    "encode", "decode", "ChaosTransport", "FaultSpec", "ReliableTransport",
    "RetryPolicy", "DeliveryError", "BrokerTransport", "InMemoryBroker",
    "ContentAddressedBroker", "get_broker", "get_cas_broker",
    "release_broker", "CodecPolicy", "validate_comm_codec",
]
