"""Message envelope for the cross-silo comm layer (port of
`fedml_tpu/comm/message.py`): a typed dict envelope with sender and
receiver ranks, framed by `serialization.encode`. The JAX package's trace
headers (`stamp_trace`) are not ported: the port's span recorder keeps no
trace ids."""
from __future__ import annotations

import dataclasses
from typing import Any

from . import serialization

# the envelope's keys (reference: message.py:9-24)
ARG_TYPE = "msg_type"
ARG_SENDER = "sender"
ARG_RECEIVER = "receiver"


@dataclasses.dataclass
class Message:
    type: str
    sender_id: int
    receiver_id: int
    params: dict = dataclasses.field(default_factory=dict)

    def add(self, key: str, value: Any) -> "Message":
        self.params[key] = value
        return self

    def get(self, key: str, default=None) -> Any:
        return self.params.get(key, default)

    # reference API names (message.py:40-70)
    add_params = add
    get_params = get

    def encode(self) -> bytes:
        return serialization.encode({
            ARG_TYPE: self.type,
            ARG_SENDER: self.sender_id,
            ARG_RECEIVER: self.receiver_id,
            "params": self.params,
        })

    @classmethod
    def decode(cls, data: bytes) -> "Message":
        d = serialization.decode(data)
        return cls(d[ARG_TYPE], int(d[ARG_SENDER]), int(d[ARG_RECEIVER]),
                   d["params"])
