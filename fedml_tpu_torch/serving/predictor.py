"""Request errors shared by the serving surfaces (copied from
`fedml_tpu/serving/predictor.py`; the predictor itself is not ported
yet)."""
from __future__ import annotations


class InvalidRequest(ValueError):
    """Client-side request error. The HTTP layer maps this to 400; every
    other exception is a 500, so a hostile request can never take a
    healthy replica out of rotation while a real internal failure still
    triggers failover."""
