"""The serve-knob registry (own copy of `fedml_tpu/serving/knobs.py`).

One table for every `serve_args` knob: its kind and bounds, its gating
prerequisite, and the surface that consumes it. "predictor" knobs are
mapped by `predictor.lm_predictor_from_serve_knobs` (the route
`serving.lm_predictor_from_config` rides); "fleet" knobs are mapped by
`serving/scheduler.py:fleet_knobs` into the `Deployment` (probation) and
`InferenceGateway` (shedding, affinity) keyword arguments, the route
`api.model_deploy` and `api.model_gateway` ride.
`config.Config.validate` calls `validate_serve_args` at load; the key
set, the kinds and the messages are the JAX package's.
"""
from __future__ import annotations

# knob -> spec. Kinds: "int" (min), "num" (strict: >0 vs >=0), "bool",
# "choice" (choices). "requires" names the gating knob whose absence makes
# this one silently dead (refused at config load). "consumer" names the
# mapping that must read the knob: "predictor" =
# predictor.lm_predictor_from_serve_knobs, "fleet" =
# serving/scheduler.py:fleet_knobs.
KNOBS = {
    "decode_slots":       {"kind": "int", "min": 0,
                           "consumer": "predictor"},
    "engine_max_len":     {"kind": "int", "min": 1,
                           "consumer": "predictor"},
    "engine_fetch_chunk": {"kind": "int", "min": 1,
                           "consumer": "predictor"},
    "engine_eos_id":      {"kind": "int", "min": 0,
                           "consumer": "predictor"},
    "sampler_cache_size": {"kind": "int", "min": 1,
                           "consumer": "predictor"},
    "kv_cache":           {"kind": "bool", "consumer": "predictor"},
    "engine_mp":          {"kind": "int", "min": 1,
                           "consumer": "predictor",
                           "requires": "decode_slots"},
    "kv_page_size":       {"kind": "int", "min": 1,
                           "consumer": "predictor",
                           "requires": "decode_slots"},
    "kv_n_pages":         {"kind": "int", "min": 2,
                           "consumer": "predictor",
                           "requires": "kv_page_size"},
    "prefill_chunk":      {"kind": "int", "min": 0,
                           "consumer": "predictor",
                           "requires": "kv_page_size"},
    "prefix_cache":       {"kind": "bool", "consumer": "predictor",
                           "requires": "kv_page_size"},
    "paged_kernel":       {"kind": "bool", "consumer": "predictor",
                           "requires": "kv_page_size"},
    "spec_decode":        {"kind": "choice", "choices": ["off", "ngram"],
                           "consumer": "predictor",
                           "requires": "kv_page_size"},
    "spec_k":             {"kind": "int", "min": 1,
                           "consumer": "predictor",
                           "requires": "spec_decode"},
    "kv_quant":           {"kind": "choice", "choices": ["off", "int8"],
                           "consumer": "predictor",
                           "requires": "kv_page_size"},
    "admit_batch":        {"kind": "int", "min": 1,
                           "consumer": "predictor",
                           "requires": "decode_slots"},
    "drain_timeout_s":    {"kind": "num", "strict": False,
                           "consumer": "predictor"},
    "affinity_routing":   {"kind": "bool", "consumer": "fleet",
                           "requires": "prefix_cache"},
    "shed_watermark":     {"kind": "num", "strict": False,
                           "consumer": "fleet"},
    "retry_after_s":      {"kind": "num", "strict": True,
                           "consumer": "fleet"},
    "probation_deadline_s": {"kind": "num", "strict": True,
                             "consumer": "fleet"},
    "probe_backoff_s":    {"kind": "num", "strict": True,
                           "consumer": "fleet"},
}


def validate_serve_args(extra: dict) -> None:
    """Validate (and normalize, in place) a `serve_args` knob dict.

    `config.Config.validate` calls this at load time. Raises ValueError
    with the JAX package's messages.

    serve_args is fully owned by this framework (no reference-YAML
    grab-bag to stay compatible with), so UNKNOWN keys are rejected too —
    a misspelled decode_slots must not pass silently.
    """
    unknown = set(extra) - set(KNOBS)
    if unknown:
        raise ValueError(
            f"unknown serve_args knob(s) {sorted(unknown)}; valid: "
            f"{sorted(KNOBS)}")
    for knob, spec in KNOBS.items():
        val = extra.get(knob)
        if val is None:
            continue
        if spec["kind"] == "bool":
            if not isinstance(val, bool):
                raise ValueError(
                    f"serve_args.{knob} must be a boolean; got {val!r}")
        elif spec["kind"] == "int":
            lo = spec["min"]
            try:
                ok = (not isinstance(val, bool)
                      and int(val) == float(val) and int(val) >= lo)
            except (TypeError, ValueError):
                ok = False
            if not ok:
                raise ValueError(
                    f"serve_args.{knob} must be an integer >= {lo}; "
                    f"got {val!r}")
        elif spec["kind"] == "num":
            strict = spec["strict"]
            try:
                ok = (not isinstance(val, bool)
                      and (float(val) > 0 if strict else float(val) >= 0))
            except (TypeError, ValueError):
                ok = False
            if not ok:
                raise ValueError(
                    f"serve_args.{knob} must be a "
                    f"{'positive' if strict else 'non-negative'} number; "
                    f"got {val!r}")
    # engine_mp only takes effect inside the engine (decode_slots > 0):
    # a config asking for tensor-parallel serving without the engine
    # would silently run single-chip per-request — refuse at load
    # instead (the other engine_* knobs double as per-request knobs,
    # e.g. engine_max_len sizes both paths, so only this one is gated)
    mp_knob = extra.get("engine_mp")
    if mp_knob is not None and int(mp_knob) > 1 \
            and not extra.get("decode_slots"):
        raise ValueError(
            "serve_args.engine_mp > 1 requires decode_slots > 0 — "
            "tensor-parallel serving runs inside the decode engine; "
            "without slots the knob would be silently ignored")
    # paged-cache knobs (serving/engine.py page_size > 0) are gated
    # the same way: each only takes effect inside the paged engine,
    # so a config naming one without its prerequisite would silently
    # serve contiguous/per-request — refuse at load instead
    if extra.get("kv_page_size") and not extra.get("decode_slots"):
        raise ValueError(
            "serve_args.kv_page_size requires decode_slots > 0 — the "
            "paged KV cache lives inside the decode engine; without "
            "slots the knob would be silently ignored")
    for knob in ("kv_n_pages", "prefill_chunk", "prefix_cache"):
        if extra.get(knob) is not None and not extra.get("kv_page_size"):
            raise ValueError(
                f"serve_args.{knob} requires kv_page_size > 0 (the "
                "paged KV cache) — without paging the knob would be "
                "silently ignored")
    # decode-speed knobs: the paged-attention kernel and n-gram
    # speculative decoding both live inside the PAGED engine
    # — same gating discipline, a knob that would be silently ignored
    # is refused at load
    if extra.get("paged_kernel") and not extra.get("kv_page_size"):
        raise ValueError(
            "serve_args.paged_kernel requires kv_page_size > 0 — the "
            "fused kernel reads the paged KV pool in place; without "
            "paging the knob would be silently ignored")
    sd = extra.get("spec_decode")
    if sd is not None:
        # YAML 1.1 reads an unquoted `off` as boolean False — that IS
        # the documented disable spelling, so normalize it instead of
        # rejecting the user's own docs back at them (True has no
        # mode to normalize to: name the quoting problem)
        if sd is False:
            sd = extra["spec_decode"] = "off"
        if sd is True:
            raise ValueError(
                "serve_args.spec_decode: true is not a mode — use "
                "'ngram' (YAML parses unquoted off/on as booleans; "
                "quote the value)")
        if sd not in KNOBS["spec_decode"]["choices"]:
            raise ValueError(
                "serve_args.spec_decode must be 'off' or 'ngram'; "
                f"got {sd!r}")
        if sd != "off" and not extra.get("kv_page_size"):
            raise ValueError(
                "serve_args.spec_decode requires kv_page_size > 0 — "
                "speculative verify-and-rollback rides the paged KV "
                "cache's page table; without paging the knob would "
                "be silently ignored")
    if extra.get("spec_k") is not None and sd in (None, "off"):
        raise ValueError(
            "serve_args.spec_k requires spec_decode: ngram — "
            "the draft length only exists under speculation; "
            "without it the knob would be silently ignored")
    # serving-density knobs: int8 KV pages, batched
    # admission, and gateway prefix-affinity routing — same discipline
    kq = extra.get("kv_quant")
    if kq is not None:
        # YAML 1.1 reads unquoted `off` as False — the documented
        # disable spelling, same normalization as spec_decode
        if kq is False:
            kq = extra["kv_quant"] = "off"
        if kq is True:
            raise ValueError(
                "serve_args.kv_quant: true is not a mode — use 'int8' "
                "(YAML parses unquoted off/on as booleans; quote the "
                "value)")
        if kq not in KNOBS["kv_quant"]["choices"]:
            raise ValueError(
                f"serve_args.kv_quant must be 'off' or 'int8'; got {kq!r}")
        if kq != "off" and not extra.get("kv_page_size"):
            raise ValueError(
                "serve_args.kv_quant requires kv_page_size > 0 — int8 "
                "KV storage is a property of the paged pool (per-page-"
                "per-head scales ride the page table); without paging "
                "the knob would be silently ignored")
    ab = extra.get("admit_batch")
    if ab is not None and int(ab) > 1 and not extra.get("decode_slots"):
        raise ValueError(
            "serve_args.admit_batch > 1 requires decode_slots > 0 — "
            "batched admission groups the decode engine's prefill "
            "chunks; without slots the knob would be silently ignored")
    if extra.get("affinity_routing"):
        if not extra.get("kv_page_size") \
                or extra.get("prefix_cache") is False:
            raise ValueError(
                "serve_args.affinity_routing requires the engine prefix "
                "cache (kv_page_size > 0, prefix_cache not disabled) — "
                "affinity routes requests to the replica whose cache "
                "already holds their prefix; without one the knob would "
                "be silently ignored")
