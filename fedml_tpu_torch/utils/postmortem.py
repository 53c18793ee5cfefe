"""The postmortem plane's kill count: a trimmed copy of
`fedml_tpu/utils/postmortem.py` (`record_kill` only).

An in-process kill (the cross-silo soak severing a rank) is counted under
`obs.postmortem.kills`. The flight recorder's frame ring, arming a run
directory, spilling and flushing a postmortem file are not ported
(ROADMAP 'Port queue' item 5, the observability planes).
"""
from __future__ import annotations

from . import metrics as mx


def record_kill(what: str) -> None:
    """An in-process kill event (a soak severing a rank): counted."""
    mx.inc("obs.postmortem.kills")
