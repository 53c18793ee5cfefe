"""Secure multi-party computation for federated aggregation (port of
`fedml_tpu/mpc/`; reference: core/mpc/secagg.py, core/mpc/lightsecagg.py).
Host numpy mod-p arithmetic with the finite-field inverse and Lagrange
basis in host C++ (`native/finite_field.cpp`); the masked updates ride the
ordinary comm and aggregation path. The names are the JAX package's."""
from .finite import (
    DEFAULT_PRIME, dequantize, lagrange_coeffs, lcc_decode, lcc_encode,
    modular_inv, prg_mask, quantize, shamir_reconstruct, shamir_share,
)
from .lightsecagg import (
    aggregate_encoded_masks, decode_aggregate_mask, lightsecagg_roundtrip,
    mask_encoding,
)
from .secagg import SecAggClient, SecAggServer, secagg_roundtrip

__all__ = [
    "DEFAULT_PRIME", "quantize", "dequantize", "modular_inv", "prg_mask",
    "shamir_share", "shamir_reconstruct", "lagrange_coeffs", "lcc_encode",
    "lcc_decode", "SecAggClient", "SecAggServer", "secagg_roundtrip",
    "mask_encoding", "aggregate_encoded_masks", "decode_aggregate_mask",
    "lightsecagg_roundtrip",
]
