"""Message envelope for the cross-silo comm layer (port of
`fedml_tpu/comm/message.py`): a typed dict envelope with sender and
receiver ranks, framed by `serialization.encode`.

Trace headers: the sending transport stamps the sender's active span into
`ARG_TRACE_ID` / `ARG_PARENT_SPAN` (`stamp_trace`), and `FedCommManager`
adopts them around the handler, so a send -> receive -> handle chain
across ranks is one trace. The underscore prefix keeps headers apart from
payload keys; handlers read params by key, so the extra entries are
inert."""
from __future__ import annotations

import dataclasses
from typing import Any

from . import serialization

# the envelope's keys (reference: message.py:9-24)
ARG_TYPE = "msg_type"
ARG_SENDER = "sender"
ARG_RECEIVER = "receiver"
ARG_MODEL_PARAMS = "model_params"
ARG_NUM_SAMPLES = "num_samples"
ARG_CLIENT_STATUS = "client_status"
ARG_ROUND = "round_idx"

# trace-context headers, the JAX package's keys
ARG_TRACE_ID = "_trace_id"
ARG_PARENT_SPAN = "_parent_span"


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

    def stamp_trace(self) -> "Message":
        """Copy the calling thread's active trace context into the
        headers. A no-op when no span is open or the headers are already
        set (a relay keeps the originating trace)."""
        from ..utils.events import current_trace

        tid, sid = current_trace()
        if tid and ARG_TRACE_ID not in self.params:
            self.params[ARG_TRACE_ID] = tid
            if sid:
                self.params[ARG_PARENT_SPAN] = sid
        return self

    def trace_context(self) -> tuple:
        """(trace_id, parent_span_id) from the headers; (None, None) for
        an unstamped message."""
        return (self.params.get(ARG_TRACE_ID),
                self.params.get(ARG_PARENT_SPAN))

    def headers(self) -> dict:
        """The underscore-prefixed entries (trace context, the reliable
        layer's seq / epoch / ts, ...) without the payload: what the crash
        flight recorder keeps per frame (`utils/postmortem.py`)."""
        return {k: v for k, v in self.params.items()
                if isinstance(k, str) and k.startswith("_")}

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
