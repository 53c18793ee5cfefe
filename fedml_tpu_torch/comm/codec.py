"""Wire codec plane: compression of training frames per message type
(port of `fedml_tpu/comm/codec.py`).

The plane plugs into `BaseTransport._encode_frame` / `_decode_frame` and
compresses by message type: the C2S model upload and the masked SecAgg
upload shrink, while control, handshake and heartbeat frames stay
byte-identical to a codec-less build. The header dicts, the leaf codecs
(`compression.encode_sparse`, the qsgd leaf, `mpc.finite.pack_field`) and
the stream state are the JAX module's, so a frame of a numpy payload is
byte-equal in both packages.

Self-describing frames: a compressed payload is replaced in the message by
a `{"__wire_codec__": <kind>, ...}` header dict carrying the codec id and
its params, so a receiver decodes without out-of-band config. An unknown
codec id, a wire-version bump, an out-of-range sparse index, or a delta
frame whose anchor digest matches nothing on the receiver is a loud
ValueError: the transport pump counts and drops the frame
(`comm.<backend>.decode_errors`) and the reliable layer's retransmit and
give-up machinery surfaces the failure.

Delta and anchor rings: sparse top-k of full params would zero most of the
model, so the codec encodes the delta against an anchor both ends hold.
Every model-stream message (S2C init / sync, C2S upload) pushes its
reconstructed payload into a small per-(peer, key) digest-keyed ring on
both sides, in the same order, so the rings never diverge. A delta frame
names its base by digest, which survives duplicates, retransmits and
reordering; a digest that fell off the ring is the loud error above, and
the next dense broadcast re-anchors the pair.

Error feedback rides the sender's per-(peer, key) state the same way: the
residual (what top-k dropped) is added to the next round's delta. Encoding
is idempotent per message object (a retransmit sees the header marker and
skips), so the reliable layer's retries never spend a residual twice.

SecAgg (quantize-then-mask): a masked vector is uniformly random, so lossy
compression happens before the mask (`mpc.secagg.premask_sparsify`, then
the shared field scale), and the wire packs the masked int64 vector into
uint32 (`field_pack`) losslessly: the unmasked aggregate is bitwise the
plain one.

DP ordering: client-side DP noise is applied before the transport encodes
the update, so the codec is post-processing of the DP mechanism's output.

Readings: the JAX package's counters (`comm.codec.<backend>.bytes_raw` /
`bytes_wire`) and histograms (`encode_s` / `decode_s`), and one span per
message the codec touched (`comm.codec.encode`, meta `type`, `sender`,
`bytes_raw`, `bytes_wire`; `comm.codec.decode`, meta `type`, `sender`),
from which a reader takes per-message times and a round's bytes.
"""
from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from typing import Any, Optional

import numpy as np

from ..utils import metrics as _mx
from ..utils.events import Span, recorder
from .message import Message

Pytree = Any

#: wire-format version: bumped when the frame layout changes incompatibly;
#: a receiver seeing a newer version refuses loudly instead of misparsing
WIRE_VERSION = 1

#: the header key that marks an encoded payload (and makes encode idempotent)
MARKER = "__wire_codec__"

#: codec ids a receiver accepts — the registry the mismatch check consults
WIRE_KINDS = ("dense", "sparse_topk", "qsgd", "field_pack")

# ---------------------------------------------------------------- knob table
# The comm_codec knob registry: every knob here is validated at config load
# and read by `make_policy` (consumer "policy").
CODEC_KNOBS = {
    "kind":            {"kind": "choice",
                        "choices": ["dense", "sparse_topk", "qsgd"],
                        "consumer": "policy"},
    "ratio":           {"kind": "num", "max": 1.0,
                        "requires_kind": "sparse_topk",
                        "consumer": "policy"},
    "val_bits":        {"kind": "choice", "choices": [16, 32],
                        "requires_kind": "sparse_topk",
                        "consumer": "policy"},
    "bits":            {"kind": "int", "min": 2, "max": 8,
                        "requires_kind": "qsgd",
                        "consumer": "policy"},
    "error_feedback":  {"kind": "bool", "requires_kind": "sparse_topk",
                        "consumer": "policy"},
    "per_type":        {"kind": "map", "consumer": "policy"},
    "secagg_premask_ratio": {"kind": "num", "max": 1.0,
                             "consumer": "policy"},
}


def _kinds_in_play(extra: dict) -> set:
    """Every codec kind this config can select (default kind + overrides) —
    the gating check: a knob owned by a kind that can never run is refused."""
    kinds = {extra.get("kind")}
    per = extra.get("per_type")
    if isinstance(per, dict):
        kinds.update(per.values())
    kinds.discard(None)
    return kinds


def validate_comm_codec(extra: dict) -> None:
    """Validate a `comm_args.extra.comm_codec` knob dict at config load.

    Unknown keys are refused (a misspelled `ratio` must not silently run
    dense), kinds/bounds come from CODEC_KNOBS, and a knob whose owning
    codec kind is selected nowhere (e.g. `bits` without any `qsgd`) is
    refused rather than silently ignored — the same gating discipline as
    serving/knobs.py. Config load calls this.
    """
    if not isinstance(extra, dict):
        raise ValueError(
            "comm_args.comm_codec must be a mapping of codec knobs; got "
            f"{extra!r}")
    unknown = set(extra) - set(CODEC_KNOBS)
    if unknown:
        raise ValueError(
            f"unknown comm_codec knob(s) {sorted(unknown)}; valid: "
            f"{sorted(CODEC_KNOBS)}")
    if "kind" not in extra:
        raise ValueError(
            "comm_codec needs a 'kind' (one of "
            f"{CODEC_KNOBS['kind']['choices']}) — the codec plane never "
            "guesses a default compressor")
    for knob, spec in CODEC_KNOBS.items():
        val = extra.get(knob)
        if val is None:
            continue
        if spec["kind"] == "bool":
            if not isinstance(val, bool):
                raise ValueError(
                    f"comm_codec.{knob} must be a boolean; got {val!r}")
        elif spec["kind"] == "int":
            lo, hi = spec["min"], spec["max"]
            ok = (isinstance(val, int) and not isinstance(val, bool)
                  and lo <= val <= hi)
            if not ok:
                raise ValueError(
                    f"comm_codec.{knob} must be an integer in [{lo}, {hi}]; "
                    f"got {val!r}")
        elif spec["kind"] == "num":
            hi = spec.get("max")
            try:
                ok = (not isinstance(val, bool) and float(val) > 0
                      and (hi is None or float(val) <= hi))
            except (TypeError, ValueError):
                ok = False
            if not ok:
                raise ValueError(
                    f"comm_codec.{knob} must be a number in (0, {hi}]; "
                    f"got {val!r}")
        elif spec["kind"] == "choice":
            if val not in spec["choices"]:
                raise ValueError(
                    f"comm_codec.{knob} must be one of {spec['choices']}; "
                    f"got {val!r}")
        elif spec["kind"] == "map":
            if not isinstance(val, dict):
                raise ValueError(
                    f"comm_codec.{knob} must be a mapping of message type "
                    f"-> codec kind; got {val!r}")
            for mt, k in val.items():
                if not isinstance(mt, str):
                    raise ValueError(
                        f"comm_codec.per_type keys must be message-type "
                        f"strings; got {mt!r}")
                if k not in WIRE_KINDS:
                    raise ValueError(
                        f"comm_codec.per_type[{mt!r}] must be one of "
                        f"{list(WIRE_KINDS)}; got {k!r}")
        # gating: a knob owned by a codec kind that can never run would be
        # silently dead — refuse at load (serve-knob discipline)
        owner = spec.get("requires_kind")
        if owner is not None and owner not in _kinds_in_play(extra):
            raise ValueError(
                f"comm_codec.{knob} requires kind: {owner} (or a per_type "
                f"override selecting it) — without {owner!r} anywhere the "
                "knob would be silently ignored")


def make_policy(d: dict) -> "CodecPolicy":
    """comm_codec config dict -> CodecPolicy: the consumer of every knob in
    CODEC_KNOBS but `secagg_premask_ratio`, which the SecAgg client reads
    (the sparsifier runs before the mask, not on the wire)."""
    validate_comm_codec(d)
    kind = d.get("kind")
    per_type = dict(d.get("per_type") or {})
    ef = d.get("error_feedback")
    type_map = {"c2s_send_model": kind, "c2s_sa_masked": "field_pack"}
    type_map.update(per_type)
    return CodecPolicy(
        type_map,
        ratio=float(d.get("ratio", 0.05)),
        bits=int(d.get("bits", 8)),
        val_bits=int(d.get("val_bits", 32)),
        error_feedback=bool(ef) if ef is not None else kind == "sparse_topk",
    )


# ------------------------------------------------------------- tree plumbing
def _np_tree(obj):
    """Normalize a payload tree exactly the way serialization.py will: array
    leaves to ndarray, numpy scalars to python scalars — so the anchor a
    sender records equals, BIT FOR BIT, what the receiver decodes."""
    if isinstance(obj, np.ndarray):
        return obj
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, dict):
        return {k: _np_tree(v) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return tuple(_np_tree(v) for v in obj)
    if isinstance(obj, list):
        return [_np_tree(v) for v in obj]
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if hasattr(obj, "__array__"):
        return np.asarray(obj)
    raise TypeError(f"wire codec cannot handle payload leaf of type "
                    f"{type(obj)!r}")


def _same_structure(a, b) -> bool:
    if isinstance(a, dict) and isinstance(b, dict):
        return set(a) == set(b) and all(_same_structure(a[k], b[k])
                                        for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same_structure(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray) and isinstance(b, np.ndarray):
        return a.shape == b.shape and a.dtype == b.dtype
    return type(a) is type(b)


def tree_digest(tree) -> str:
    """16-hex-char blake2b over structure + leaf bytes — the anchor identity
    a delta frame names its base by."""
    h = hashlib.blake2b(digest_size=8)

    def walk(obj):
        if isinstance(obj, dict):
            h.update(b"d")
            for k in obj:            # serialization preserves dict order
                h.update(str(k).encode())
                walk(obj[k])
        elif isinstance(obj, (list, tuple)):
            h.update(b"l" if isinstance(obj, list) else b"t")
            for v in obj:
                walk(v)
        elif isinstance(obj, np.ndarray):
            h.update(str(obj.dtype).encode() + str(obj.shape).encode())
            h.update(np.ascontiguousarray(obj).tobytes())
        else:
            h.update(repr(obj).encode())

    walk(tree)
    return h.hexdigest()


def _walk_pair(payload, base, fn):
    """Map `fn(leaf, base_leaf)` -> (wire_leaf, recon_leaf) over the array
    leaves of `payload` (base_leaf is None in absolute mode); containers are
    rebuilt around the results. Returns (wire_tree, recon_tree)."""
    if isinstance(payload, dict):
        wire, recon = {}, {}
        for k, v in payload.items():
            wire[k], recon[k] = _walk_pair(v, base[k] if base is not None
                                           else None, fn)
        return wire, recon
    if isinstance(payload, (list, tuple)):
        pairs = [_walk_pair(v, base[i] if base is not None else None, fn)
                 for i, v in enumerate(payload)]
        typ = type(payload)
        return (typ(p[0] for p in pairs), typ(p[1] for p in pairs))
    if isinstance(payload, np.ndarray):
        return fn(payload, base)
    return payload, payload


# ------------------------------------------------------------- leaf codecs
def _sparse_leaf(ratio: float, val_dtype=np.float32):
    """Leaf encoder for sparse_topk: float leaves ride
    compression.encode_sparse (top-k idx/val), int/bool/empty leaves pass
    through dense — the codec plane is what makes those edge cases
    load-bearing (tests/test_compression.py pins them)."""
    from ..compression import decode_sparse, encode_sparse

    def fn(leaf: np.ndarray, base: Optional[np.ndarray]):
        if leaf.dtype.kind not in "f" or leaf.size == 0:
            return leaf, leaf          # dense passthrough, recon == payload
        d = leaf if base is None else leaf - base
        enc = encode_sparse(d.ravel(), ratio, val_dtype=val_dtype)
        recon_d = decode_sparse(enc).reshape(leaf.shape).astype(leaf.dtype)
        recon = recon_d if base is None else (base + recon_d).astype(leaf.dtype)
        wire = {"__sp__": enc, "shape": list(leaf.shape),
                "dtype": str(leaf.dtype)}
        nbytes = int(enc["idx"].nbytes + enc["val"].nbytes)
        return (wire, recon, int(leaf.nbytes), nbytes)

    return fn


def _qsgd_leaf(bits: int):
    """Leaf encoder for qsgd: norm-scaled deterministic quantization to
    `levels = 2^bits - 1` uint8 magnitudes + packed sign bits + one float32
    norm per leaf (~3.8x vs float32; the stochastic-rounding unbiasedness of
    the in-jit transform is traded for wire determinism)."""
    levels = float(2 ** bits - 1)

    def fn(leaf: np.ndarray, base: Optional[np.ndarray]):
        if leaf.dtype.kind not in "f" or leaf.size == 0:
            return leaf, leaf
        flat = np.asarray(leaf, np.float64).ravel()
        if not np.all(np.isfinite(flat)):
            raise ValueError(
                "qsgd codec: non-finite values in payload — refuse to "
                "quantize NaN/Inf into silently-wrong tensors")
        norm = float(np.linalg.norm(flat))
        if norm <= 0.0:
            q = np.zeros(flat.size, np.uint8)
        else:
            q = np.clip(np.round(np.abs(flat) / norm * levels), 0,
                        levels).astype(np.uint8)
        sgn = np.packbits((flat < 0).astype(np.uint8))
        recon = (np.where(flat < 0, -1.0, 1.0) * q * (norm / levels)) \
            .astype(leaf.dtype).reshape(leaf.shape)
        wire = {"__q__": {"mag": q, "sgn": sgn, "norm": norm,
                          "n": int(flat.size)},
                "shape": list(leaf.shape), "dtype": str(leaf.dtype)}
        return (wire, recon, int(leaf.nbytes),
                int(q.nbytes + sgn.nbytes + 4))

    return fn


def _field_pack_leaf(p: int):
    """Leaf encoder for field_pack: LOSSLESS uint32 packing of masked
    finite-field vectors via mpc/finite.pack_field — an exact 2x over the
    int64 representation, so the unmasked aggregate is bitwise unchanged."""
    from ..mpc.finite import pack_field

    def fn(leaf: np.ndarray, base: Optional[np.ndarray]):
        if leaf.dtype.kind not in "iu":
            raise ValueError(
                "field_pack codec expects integer field vectors (a masked "
                f"secagg upload); got dtype {leaf.dtype}")
        packed = pack_field(leaf, p)
        wire = {"__fp__": packed, "shape": list(leaf.shape)}
        return wire, leaf, int(leaf.nbytes), int(packed.nbytes)

    return fn


def _decode_tree(tree, kind: str, params: dict):
    """Replace wire leaf dicts with reconstructed arrays."""
    from ..compression import decode_sparse
    from ..mpc.finite import unpack_field

    def walk(obj):
        if isinstance(obj, dict):
            if "__sp__" in obj:
                return decode_sparse(obj["__sp__"]).reshape(
                    obj["shape"]).astype(np.dtype(obj["dtype"]))
            if "__q__" in obj:
                q = obj["__q__"]
                n = int(q["n"])
                mag = np.asarray(q["mag"], np.float64).ravel()
                if mag.size != n:
                    raise ValueError(
                        "qsgd frame: magnitude length mismatch")
                bits = int(params.get("bits", 8))
                levels = float(2 ** bits - 1)
                sgn = np.unpackbits(np.asarray(q["sgn"], np.uint8))
                if sgn.size < n:
                    raise ValueError("qsgd frame: sign bits truncated")
                sign = np.where(sgn[:n] > 0, -1.0, 1.0)
                norm = float(q["norm"])
                return (sign * mag * (norm / levels)).astype(
                    np.dtype(obj["dtype"])).reshape(obj["shape"])
            if "__fp__" in obj:
                return unpack_field(np.asarray(obj["__fp__"]),
                                    int(params["p"])).reshape(obj["shape"])
            return {k: walk(v) for k, v in obj.items()}
        if isinstance(obj, list):
            return [walk(v) for v in obj]
        if isinstance(obj, tuple):
            return tuple(walk(v) for v in obj)
        return obj

    return walk(tree)


def _tree_add(a, b):
    """a + b leafwise (anchor + decoded delta); non-array leaves take b."""
    if isinstance(a, dict):
        return {k: _tree_add(a[k], b[k]) for k in b}
    if isinstance(a, (list, tuple)):
        typ = type(a)
        return typ(_tree_add(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) and isinstance(b, np.ndarray) \
            and b.dtype.kind == "f":
        return (a + b).astype(b.dtype)
    return b


def _tree_sub(a, b):
    """a - b leafwise for float leaves; others pass a through."""
    if isinstance(a, dict):
        return {k: _tree_sub(a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        typ = type(a)
        return typ(_tree_sub(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) and a.dtype.kind == "f":
        return a - b
    return a


# ----------------------------------------------------------------- policy
class CodecPolicy:
    """Per-message-type codec selection + the stream state (anchor rings,
    error-feedback residuals) one transport endpoint carries.

    Attach to the INNERMOST transport (`BaseTransport.set_codec`;
    `create_transport(comm_codec=...)` does this before wrapping) so the
    chaos/reliable wrappers see compressed frames — corrupt injection then
    exercises the sparse decoder's validation and retransmits carry the
    compressed bytes.

    THREAD OWNERSHIP: encode runs on whatever thread sends (FSM handlers,
    the reliable retransmitter) and decode runs on the transport pump —
    all anchor/residual state is accessed under `self._lock`.
    """

    #: message payload keys the codec may touch; everything else is inert
    PAYLOAD_KEYS = ("model_params", "sa_masked")
    #: model-stream types whose payloads anchor the delta codec (both ends
    #: push the reconstruction on encode AND decode, keeping rings in sync)
    ANCHOR_TYPES = frozenset(
        {"s2c_init_config", "s2c_sync_model", "c2s_send_model"})
    #: anchors remembered per (peer, key): large enough that a late
    #: straggler or chaos-reordered frame still finds its base by digest
    RING = 4

    def __init__(self, type_map: dict, ratio: float = 0.05, bits: int = 8,
                 val_bits: int = 32, error_feedback: bool = True):
        from ..mpc.finite import DEFAULT_PRIME

        self.type_map = {t: k for t, k in type_map.items() if k is not None}
        bad = sorted(set(self.type_map.values()) - set(WIRE_KINDS))
        if bad:
            raise ValueError(f"unknown codec kind(s) {bad}; valid: "
                             f"{list(WIRE_KINDS)}")
        self.ratio = float(ratio)
        self.bits = int(bits)
        self.val_dtype = np.float16 if int(val_bits) == 16 else np.float32
        self.error_feedback = bool(error_feedback)
        self.field_prime = DEFAULT_PRIME
        # anchors exist ONLY for sparse_topk delta mode: a qsgd/dense-only
        # policy must not pay a full-model digest + 4-deep model ring per
        # peer on every broadcast for a codec that can never consume them
        self._wants_anchors = "sparse_topk" in self.type_map.values()
        self._lock = threading.Lock()
        #: (peer, key) -> OrderedDict[digest -> anchor tree], newest last
        self._anchors: dict = {}
        #: (peer, key) -> error-feedback residual tree (delta mode only)
        self._residuals: dict = {}

    @classmethod
    def from_config(cls, d) -> "CodecPolicy":
        return d if isinstance(d, cls) else make_policy(d)

    # ------------------------------------------------------------ anchors
    def _push_anchor(self, peer: int, key: str, recon) -> None:
        """Caller holds the lock."""
        ring = self._anchors.setdefault((peer, key), OrderedDict())
        dig = tree_digest(recon)
        ring.pop(dig, None)
        ring[dig] = recon
        while len(ring) > self.RING:
            ring.popitem(last=False)

    def _latest_anchor(self, peer: int, key: str):
        """Caller holds the lock. (digest, tree) of the newest anchor or
        (None, None)."""
        ring = self._anchors.get((peer, key))
        if not ring:
            return None, None
        dig = next(reversed(ring))
        return dig, ring[dig]

    # ------------------------------------------------------------- encode
    def kind_for(self, msg_type: str) -> Optional[str]:
        return self.type_map.get(msg_type)

    def encode_message(self, msg: Message, backend: str = "base") -> None:
        """Compress eligible payloads IN PLACE. Idempotent per message
        object: a retransmit re-entering `_encode_frame` sees the marker and
        skips, so stream state (residuals, anchors) advances exactly once
        per logical send."""
        t0 = time.perf_counter()
        touched = False
        raw_total = wire_total = 0
        for key in self.PAYLOAD_KEYS:
            val = msg.params.get(key)
            if val is None or (isinstance(val, dict) and MARKER in val):
                continue
            kind = self.kind_for(msg.type)
            anchored = (self._wants_anchors
                        and msg.type in self.ANCHOR_TYPES
                        and key == "model_params")
            if kind in (None, "dense"):
                if anchored:
                    # dense model-stream frames still advance the anchor
                    # ring (the broadcast IS the delta base) — the frame
                    # bytes are untouched, control stays byte-identical
                    with self._lock:
                        self._push_anchor(msg.receiver_id, key,
                                          _np_tree(val))
                continue
            wire, recon, raw, nb = self._encode_payload(
                kind, val, msg.receiver_id, key, anchored)
            msg.params[key] = wire
            touched = True
            pre = f"comm.codec.{backend}"
            _mx.inc(f"{pre}.bytes_raw", raw)
            _mx.inc(f"{pre}.bytes_wire", nb)
            raw_total += raw
            wire_total += nb
        if touched:
            t1 = time.perf_counter()
            _mx.observe(f"comm.codec.{backend}.encode_s", t1 - t0)
            recorder.record(Span("comm.codec.encode", t0, t1, {
                "type": msg.type, "sender": msg.sender_id,
                "bytes_raw": raw_total, "bytes_wire": wire_total}))

    def _encode_payload(self, kind: str, val, peer: int, key: str,
                        anchored: bool):
        payload = _np_tree(val)
        header = {MARKER: kind, "v": WIRE_VERSION}
        with self._lock:
            base_dig, base = (self._latest_anchor(peer, key)
                              if (anchored and kind == "sparse_topk")
                              else (None, None))
            if base is not None and not _same_structure(base, payload):
                base_dig = base = None      # model-shape change: go absolute
            residual = None
            if kind == "sparse_topk":
                leaf_fn = _sparse_leaf(self.ratio, self.val_dtype)
                header["ratio"] = self.ratio
                if base is not None:
                    header["mode"], header["anchor"] = "delta", base_dig
                    delta = _tree_sub(payload, base)
                    if self.error_feedback:
                        res = self._residuals.get((peer, key))
                        if res is not None and _same_structure(res, delta):
                            delta = _tree_add(res, delta)
                        residual = delta    # recon subtracted below
                    src, src_base = delta, None
                else:
                    header["mode"], header["anchor"] = "abs", None
                    src, src_base = payload, None
            elif kind == "qsgd":
                leaf_fn = _qsgd_leaf(self.bits)
                header["bits"] = self.bits
                header["mode"], header["anchor"] = "abs", None
                src, src_base = payload, None
            elif kind == "field_pack":
                leaf_fn = _field_pack_leaf(self.field_prime)
                header["p"] = self.field_prime
                src, src_base = payload, None
            else:  # pragma: no cover — constructor validated kinds
                raise ValueError(f"unknown codec kind {kind!r}")

            raw_total, wire_total = 0, 0

            def fn(leaf, b):
                nonlocal raw_total, wire_total
                out = leaf_fn(leaf, b)
                if isinstance(out, tuple) and len(out) == 4:
                    wire, recon, raw, nb = out
                    raw_total += raw
                    wire_total += nb
                    return wire, recon
                return out

            wire_tree, recon_src = _walk_pair(src, src_base, fn)
            if kind == "sparse_topk" and base is not None:
                recon = _tree_add(base, recon_src)
                if self.error_feedback:
                    self._residuals[(peer, key)] = _tree_sub(residual,
                                                             recon_src)
            else:
                recon = recon_src
            if anchored:
                self._push_anchor(peer, key, recon)
        header["tree"] = wire_tree
        return header, recon, raw_total, wire_total

    # ------------------------------------------------------------- decode
    def record_decoded_anchor(self, peer: int, key: str, recon) -> None:
        if not self._wants_anchors:
            return
        with self._lock:
            self._push_anchor(peer, key, recon)

    def lookup_anchor(self, peer: int, key: str, digest: str):
        with self._lock:
            ring = self._anchors.get((peer, key), {})
            if digest not in ring:
                raise ValueError(
                    f"wire codec anchor mismatch: delta frame names base "
                    f"{digest!r} but this endpoint holds "
                    f"{list(ring) or 'no anchors'} for peer {peer} — "
                    "sender and receiver disagree on the reference model "
                    "(enable comm_codec on both ends; a dense re-broadcast "
                    "re-anchors the pair)")
            return ring[digest]


def decode_message(msg: Message, policy: Optional[CodecPolicy],
                   backend: str = "base") -> None:
    """Reverse `encode_message` IN PLACE, keyed entirely off the frame's own
    codec header — no out-of-band config needed for stateless kinds. Delta
    frames need the receiving endpoint's anchor ring (`policy`); decoding
    one without a policy is a loud error, not garbage. Also advances the
    anchor ring for dense model-stream frames so both ends stay in sync."""
    t0 = time.perf_counter()
    touched = False
    for key in CodecPolicy.PAYLOAD_KEYS:
        val = msg.params.get(key)
        if val is None:
            continue
        anchored = (msg.type in CodecPolicy.ANCHOR_TYPES
                    and key == "model_params")
        if not (isinstance(val, dict) and MARKER in val):
            if anchored and policy is not None and policy._wants_anchors:
                policy.record_decoded_anchor(msg.sender_id, key,
                                             _np_tree(val))
            continue
        kind = val.get(MARKER)
        if kind not in WIRE_KINDS:
            raise ValueError(
                f"wire codec mismatch: frame names codec {kind!r} but this "
                f"build knows {list(WIRE_KINDS)} — version skew between "
                "sender and receiver")
        ver = int(val.get("v", 0))
        if ver != WIRE_VERSION:
            raise ValueError(
                f"wire codec version mismatch: frame is v{ver}, this build "
                f"speaks v{WIRE_VERSION}")
        recon = _decode_tree(val["tree"], kind, val)
        if val.get("mode") == "delta":
            if policy is None:
                raise ValueError(
                    "anchored delta frame but this transport has no codec "
                    "state — enable comm_codec on both ends of the link")
            base = policy.lookup_anchor(msg.sender_id, key, val["anchor"])
            recon = _tree_add(base, recon)
        msg.params[key] = recon
        if anchored and policy is not None:
            policy.record_decoded_anchor(msg.sender_id, key, recon)
        touched = True
    if touched:
        t1 = time.perf_counter()
        _mx.observe(f"comm.codec.{backend}.decode_s", t1 - t0)
        recorder.record(Span("comm.codec.decode", t0, t1, {
            "type": msg.type, "sender": msg.sender_id}))
