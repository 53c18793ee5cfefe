"""The wire format (port of `fedml_tpu/comm/serialization.py`): no pickle.

    [4B magic][4B header_len][header JSON][raw tensor buffers][8B CRC trailer]

A pytree is JSON with each array leaf swapped for a {"__nd__": i, dtype,
shape} descriptor pointing into the buffer region. `encode` of a numpy
pytree gives the same bytes as the JAX package's `encode` with its native
tier: FT02 frames with a CRC-32C trailer (`native/crc32c.cpp`). Torch
tensors are moved to the host first; a bf16 leaf (a torch.bfloat16
tensor, or a numpy array whose dtype is named "bfloat16") is framed as
dtype "bfloat16" with its raw 2-byte buffer, as the JAX package frames
it, and `decode` returns it as a torch.bfloat16 tensor on the CPU (numpy
has no bf16 without ml_dtypes). Every other array leaf decodes to numpy.

Unlike the JAX package, which writes a trailer-less FT01 frame when its
native library is missing, the port never writes FT01: a CRC library that
fails to build or load raises. It still reads FT01 frames.
"""
from __future__ import annotations

import json
import struct
from typing import Any

import numpy as np
import torch

from ..native import crc32c

Pytree = Any
_MAGIC = b"FT01"        # trailer-less frame (read only)
_MAGIC_CRC = b"FT02"    # frame with a CRC-32C trailer (last 8 bytes)
_CRC_TAG = b"C32C"
_BF16 = "bfloat16"


def _nd(buffers: list, raw: bytes, dtype: str, shape) -> dict:
    idx = len(buffers)
    buffers.append(raw)
    return {"__nd__": idx, "dtype": dtype, "shape": list(shape)}


def _encode_obj(obj: Any, buffers: list):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return _nd(buffers, t.view(torch.int16).numpy().tobytes(), _BF16,
                       t.shape)
        return _encode_obj(t.numpy(), buffers)
    if isinstance(obj, np.ndarray):
        arr = np.ascontiguousarray(obj)
        return _nd(buffers, arr.tobytes(), str(arr.dtype), arr.shape)
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, dict):
        for k in obj:
            if not isinstance(k, str):
                raise TypeError(
                    f"dict keys must be str for lossless JSON round-trip, got "
                    f"{type(k).__name__} key {k!r}"
                )
        return {k: _encode_obj(v, buffers) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        enc = [_encode_obj(v, buffers) for v in obj]
        return {"__tuple__": enc} if isinstance(obj, tuple) else enc
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if hasattr(obj, "__array__"):
        return _encode_obj(np.asarray(obj), buffers)
    raise TypeError(f"unserializable type {type(obj)!r} (no pickle fallback by design)")


def _decode_obj(obj: Any, buffers: list):
    if isinstance(obj, dict):
        if "__nd__" in obj:
            buf = buffers[obj["__nd__"]]
            if obj["dtype"] == _BF16:
                raw = np.frombuffer(buf, dtype=np.int16).reshape(obj["shape"])
                return torch.from_numpy(raw.copy()).view(torch.bfloat16)
            return np.frombuffer(buf, dtype=np.dtype(obj["dtype"])).reshape(
                obj["shape"]
            ).copy()
        if "__tuple__" in obj:
            return tuple(_decode_obj(v, buffers) for v in obj["__tuple__"])
        return {k: _decode_obj(v, buffers) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode_obj(v, buffers) for v in obj]
    return obj


def encode(tree: Pytree) -> bytes:
    """pytree (dict / list / tuple / scalars / numpy arrays / torch
    tensors) -> an FT02 frame with its CRC-32C trailer."""
    buffers: list = []
    header = _encode_obj(tree, buffers)
    sizes = [len(b) for b in buffers]
    head = json.dumps({"tree": header, "sizes": sizes}).encode()
    frame = b"".join([_MAGIC_CRC, struct.pack("<I", len(head)), head]
                     + buffers)
    return frame + _CRC_TAG + struct.pack("<I", crc32c(frame))


def decode(data: bytes | memoryview) -> Pytree:
    """An FT02 (or FT01) frame -> its pytree. A frame whose CRC does not
    match raises ValueError before its header is parsed."""
    data = memoryview(data)
    magic = bytes(data[:4])
    if magic not in (_MAGIC, _MAGIC_CRC):
        raise ValueError("bad frame magic (not a fedml_tpu wire frame)")
    # integrity trailer first: corruption anywhere (the JSON header
    # included) surfaces as a CRC error, not a parse error
    if magic == _MAGIC_CRC:
        if len(data) < 16:
            raise ValueError("FT02 frame too short for its CRC trailer")
        if bytes(data[-8:-4]) != _CRC_TAG:
            raise ValueError("FT02 frame missing its CRC trailer tag")
        (want,) = struct.unpack("<I", data[-4:])
        got = crc32c(data[:-8])
        if got != want:
            raise ValueError(
                f"wire frame CRC mismatch (got {got:#x}, want "
                f"{want:#x}) — payload corrupted in transit")
        data = data[:-8]
    (hlen,) = struct.unpack("<I", data[4:8])
    head = json.loads(bytes(data[8 : 8 + hlen]))
    buffers: list = []
    off = 8 + hlen
    for size in head["sizes"]:
        buffers.append(data[off : off + size])
        off += size
    return _decode_obj(head["tree"], buffers)
