"""The cross-silo message layer (port of `fedml_tpu/comm/`): the wire
format, the loopback transport, the comm manager, reliable delivery and
the chaos plane. The gRPC and broker transports and the wire codec are not
ported (ROADMAP 'Port queue' item 5)."""
from .base import BaseTransport, Observer
from .chaos import ChaosTransport, FaultSpec
from .loopback import LoopbackTransport, get_router, release_router
from .manager import FedCommManager, create_transport
from .message import Message
from .reliable import DeliveryError, ReliableTransport, RetryPolicy
from .serialization import decode, encode

__all__ = [
    "BaseTransport", "Observer", "Message", "FedCommManager",
    "create_transport", "LoopbackTransport", "get_router", "release_router",
    "encode", "decode", "ChaosTransport", "FaultSpec", "ReliableTransport",
    "RetryPolicy", "DeliveryError",
]
