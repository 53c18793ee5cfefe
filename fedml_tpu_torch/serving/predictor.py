"""Predictors: the servable model contract and its PyTorch implementations
(port of `fedml_tpu/serving/predictor.py`).

- `TorchPredictor` is `JaxPredictor`'s counterpart: a classifier over
  (apply_fn, params), the batch padded up to a power-of-two bucket.
- `GreedyLMPredictor` serves the LLaMA-shaped LM. Single prompts without
  a `top_k` cutoff go to the continuous-batching `DecodeEngine`
  (`decode_slots` > 0); batched prompts and `top_k` requests decode on the
  per-request path (`llm/decode.py` make_generate: prefill once, then
  KV-cached steps), which is also where a stopped engine degrades to when
  it can honour the same contract. `kv_cache=False` is the recompute path
  (a full forward per token, greedy only).

The JAX predictors compile one program per bucket, and the buckets bound
their compile caches. The port runs eagerly, so nothing is compiled; it
keeps the buckets only where they are part of the contract: the
per-request capacity check (prompt + bucket(max_new_tokens) <= max_len),
`top_k` rounded up to a power of two, and the (first call per bucket)
split of `serving.predict.compile_s` from `serving.predict.serve_s`.
"""
from __future__ import annotations

import random
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Optional, Protocol

import numpy as np
import torch

from .._device import resolve_device
from ..utils import metrics as _mx
from ..utils.events import recorder


class InvalidRequest(ValueError):
    """Client-side request error. The HTTP layer maps this (and a missing
    field's KeyError) to 400; every other exception is a 500, so a hostile
    request can never take a healthy replica out of rotation while a real
    internal failure still triggers failover."""


class StaleVersion(InvalidRequest):
    """The request PINNED a `model_version` this replica does not serve.
    The HTTP layer maps this to 409: the replica is healthy, and the
    request should be retried on a sibling that serves the pinned
    version."""


def _req_int(input_json: dict, key: str, default) -> int:
    try:
        return int(input_json.get(key, default))
    except (TypeError, ValueError):
        raise InvalidRequest(
            f"{key} must be an integer; got {input_json.get(key)!r}"
        ) from None


class Predictor(Protocol):
    def predict(self, input_json: dict) -> Any: ...


class _InstrumentedPredictor:
    """`predict` wraps the subclass's `_predict(input_json) -> (out, key)`
    in a `serving.predict` span; the first call for a given bucket key
    lands in `serving.predict.compile_s`, later ones in
    `serving.predict.serve_s` (the JAX package's split, so dashboards read
    the same names; on the card the first call also pays kernel builds
    and library warm-up)."""

    def predict(self, input_json: dict) -> dict:
        compiled = self.__dict__.setdefault("_compiled_keys", set())
        t0 = time.perf_counter()
        with recorder.span("serving.predict",
                           kind=type(self).__name__) as sp:
            out, key = self._predict(input_json)
            first = key not in compiled
            sp.meta["compile"] = first
        compiled.add(key)
        # the pin is re-checked AFTER compute: a hot swap that landed while
        # this request decoded finished it on the NEW adapters, and that
        # answer must not go out under the old pin
        chk = getattr(self, "_check_pin", None)
        if chk is not None:
            chk(input_json)
        _mx.inc("serving.predictions")
        _mx.observe("serving.predict.compile_s" if first
                    else "serving.predict.serve_s",
                    time.perf_counter() - t0)
        return out


def lm_predictor_from_serve_knobs(sv: dict, model, adapters=None,
                                  detokenize=None, device=None,
                                  default_max_len: int = 256
                                  ) -> "GreedyLMPredictor":
    """THE serve-knob -> GreedyLMPredictor mapping for every knob
    `serving/knobs.py` tags `consumer: predictor`. The config route
    (`serving.lm_predictor_from_config`) and the deploy route
    (`serving/scheduler.py:start_replica`, with the spec's `lm.max_len`
    as `default_max_len`) both ride it, so the two cannot drift."""
    eos = sv.get("engine_eos_id")
    n_pages = sv.get("kv_n_pages")
    return GreedyLMPredictor(
        model, adapters=adapters, detokenize=detokenize,
        max_len=int(sv.get("engine_max_len", default_max_len)),
        kv_cache=bool(sv.get("kv_cache", True)),
        decode_slots=int(sv.get("decode_slots", 0)),
        eos_id=None if eos is None else int(eos),
        engine_fetch_chunk=int(sv.get("engine_fetch_chunk", 2)),
        sampler_cache_size=int(sv.get("sampler_cache_size", 4)),
        engine_mp=int(sv.get("engine_mp", 0)),
        kv_page_size=int(sv.get("kv_page_size", 0)),
        kv_n_pages=None if n_pages is None else int(n_pages),
        prefill_chunk=int(sv.get("prefill_chunk", 0)),
        prefix_cache=bool(sv.get("prefix_cache", True)),
        paged_kernel=bool(sv.get("paged_kernel", False)),
        # a YAML-1.1 spec reads unquoted `off` as False, the documented
        # disable spelling
        spec_decode=("off" if sv.get("spec_decode") in (None, False)
                     else str(sv.get("spec_decode"))),
        spec_k=int(sv.get("spec_k", 4)),
        kv_quant=("off" if sv.get("kv_quant") in (None, False)
                  else str(sv.get("kv_quant"))),
        admit_batch=int(sv.get("admit_batch", 1)),
        drain_timeout_s=float(sv.get("drain_timeout_s", 30.0)),
        device=device)


def _as_tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(v))


def params_to_torch(tree: dict) -> dict:
    """An artifact store's flat parameter tree (numpy leaves, a bf16 leaf
    as a CPU tensor) as CPU torch tensors."""
    return {k: _as_tensor(v) for k, v in tree.items()}


def adapters_like(tree: dict, like: Optional[dict]) -> dict:
    """An artifact store's adapter tree ({name: {"a", "b"}}) as torch
    tensors on the device and in the dtype of the served adapters `like`
    (where `like` names the same leaf), so a swap can merge them."""
    out = {}
    for name, ab in tree.items():
        if not isinstance(ab, dict):
            raise ValueError(f"adapter {name!r} must be a dict of 'a' and "
                             "'b'")
        cur = (like or {}).get(name) or {}
        out[name] = {}
        for k, v in ab.items():
            t = _as_tensor(v)
            ref = cur.get(k)
            out[name][k] = t if ref is None else t.to(device=ref.device,
                                                      dtype=ref.dtype)
    return out


def _bucket(n: int, pow2_cap: int = 1024) -> int:
    """Power-of-two buckets up to the cap, then multiples of the cap."""
    if n > pow2_cap:
        return ((n + pow2_cap - 1) // pow2_cap) * pow2_cap
    b = 1
    while b < n:
        b *= 2
    return b


class TorchPredictor(_InstrumentedPredictor):
    """Classification predictor over (apply_fn, params), the counterpart
    of the JAX package's `JaxPredictor`: apply_fn(params, x) -> logits, as
    `models.hub.apply_fn` makes it.

    predict({"inputs": [[...], ...]}) -> {"predictions": [...],
    "probabilities": [[...], ...]}: the batch padded to a power-of-two
    bucket, run on `device` (CUDA unless the caller names "cpu"), the
    probabilities rounded to 6 places. Calls into apply_fn take a lock:
    `hub.apply_fn` swaps the parameters into one module for the length of
    a call (`functional_call`), so two HTTP threads running it at once
    would each see the other's restore."""

    def __init__(self, apply_fn: Callable, params, return_probs: bool = True,
                 device=None):
        self.device = resolve_device(device)
        self.apply_fn = apply_fn
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.return_probs = return_probs
        self._apply_lock = threading.Lock()

    def _predict(self, input_json: dict) -> tuple[dict, tuple]:
        try:
            x = np.asarray(input_json["inputs"], np.float32)
        except (TypeError, ValueError):
            raise InvalidRequest(
                "inputs must be a rectangular numeric array") from None
        n = x.shape[0]
        b = _bucket(n)
        if b > n:
            x = np.concatenate([x, np.zeros((b - n,) + x.shape[1:], x.dtype)])
        with torch.no_grad(), self._apply_lock:
            logits = self.apply_fn(self.params,
                                   torch.from_numpy(x).to(self.device))
            labels = logits.argmax(-1)
            probs = torch.softmax(logits.float(), -1)
        out = {"predictions": labels[:n].cpu().numpy().tolist()}
        if self.return_probs:
            out["probabilities"] = (probs[:n].cpu().numpy()
                                    .round(6).tolist())
        return out, (b, x.shape[1:])


class GreedyLMPredictor(_InstrumentedPredictor):
    """Causal-LM predictor over an `llm.transformer.TransformerLM` (its
    weights are the model's; LoRA `adapters` ride beside them and are
    merged once, `engine.merged_model`).

    predict({"tokens": [...], "max_new_tokens": k}) -> {"generated_tokens":
    [...]} (+ "generated_text" with a detokenizer); {"tokens": [[...],
    ...]} decodes a batch of prompts in lockstep. Sampling knobs:
    temperature > 0, top_k, seed (per-request path and engine alike).

    `kv_cache=True` decodes through the KV cache (`llm/decode.py`); False
    recomputes the whole prefix each token (greedy, no adapters).
    `decode_slots` > 0 (needs kv_cache) starts the continuous-batching
    `DecodeEngine`; `kv_page_size` > 0 makes it paged (`kv_n_pages`,
    `prefill_chunk`, `prefix_cache`, `paged_kernel`, `spec_decode` +
    `spec_k`, `kv_quant`), `admit_batch` batches its admissions. The
    engine's capacity (`engine.admissible`) decides routing, so a request
    the page budget refuses falls back to the per-request path when that
    path can serve it honestly; an engine failure degrades to that path
    the same way, except on the paged kernel, where it always surfaces.
    `engine_mp` > 1 runs the engine tensor-parallel over an {"mp": N}
    mesh of the world's first N ranks (`parallel/mesh.make_mesh`): every
    rank of that world builds the predictor (SPMD) with the whole model,
    the engine shards it, and requests go to the first rank's predictor
    (the engine's leader; a follower's engine refuses submits). The
    per-request path keeps the whole merged model. Runs on `device`
    (CUDA unless the caller names "cpu"), where the model must already
    be."""

    def __init__(self, model,
                 detokenize: Optional[Callable[[list[int]], str]] = None,
                 max_len: int = 256, kv_cache: bool = False,
                 adapters: Optional[dict] = None,
                 compute_dtype: Optional[str] = None,
                 decode_slots: int = 0, eos_id: Optional[int] = None,
                 sampler_cache_size: int = 4, engine_fetch_chunk: int = 2,
                 engine_mp: int = 0, kv_page_size: int = 0,
                 kv_n_pages: Optional[int] = None, prefill_chunk: int = 0,
                 prefix_cache: bool = True, paged_kernel: bool = False,
                 spec_decode: str = "off", spec_k: int = 4,
                 kv_quant: str = "off", admit_batch: int = 1,
                 drain_timeout_s: float = 30.0, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.detokenize = detokenize
        self.max_len = max_len
        self.kv_cache = kv_cache
        self.adapters = adapters
        self.engine = None
        self.eos_id = eos_id
        self.drain_timeout_s = float(drain_timeout_s)
        self._version = 0
        # an engine on the paged kernel never gives way to the per-request
        # path's dense attention: its failures surface
        self._kernel_engine = bool(decode_slots) and bool(paged_kernel)

        if decode_slots and not kv_cache:
            raise ValueError(
                "decode_slots (the continuous-batching engine, "
                "serving/engine.py) needs kv_cache=True — the engine IS "
                "the KV-cached decode with a slot axis")
        if (kv_page_size or kv_n_pages or prefill_chunk) \
                and not decode_slots:
            raise ValueError(
                "kv_page_size/kv_n_pages/prefill_chunk configure the "
                "PAGED decode engine — they need decode_slots > 0 "
                "(otherwise they would be silently ignored)")
        if (paged_kernel or spec_decode != "off") and not kv_page_size:
            raise ValueError(
                "paged_kernel/spec_decode need the PAGED engine "
                "(kv_page_size > 0, which itself needs decode_slots) — "
                "otherwise they would be silently ignored")
        if kv_quant != "off" and not kv_page_size:
            raise ValueError(
                "kv_quant stores the PAGED KV pool in int8 — it needs "
                "kv_page_size > 0 (which itself needs decode_slots); "
                "otherwise it would be silently ignored")
        if int(admit_batch) > 1 and not decode_slots:
            raise ValueError(
                "admit_batch batches the decode ENGINE's admissions — "
                "it needs decode_slots > 0 (otherwise it would be "
                "silently ignored)")
        if adapters is not None and not kv_cache:
            raise ValueError(
                "adapters (frozen base + LoRA) need kv_cache=True — the "
                "KV-cached decode serves them merged; or pre-merge with "
                "llm.lora.lora_merge and pass the merged model")
        if compute_dtype is not None and not kv_cache:
            raise ValueError(
                "compute_dtype only applies to kv_cache=True (the "
                "recompute path runs the model in its own dtype); cast the "
                "model's weights instead")
        if model.device != self.device:
            raise ValueError(f"the model's weights are on {model.device}, "
                             f"the predictor runs on {self.device}")
        if not kv_cache:
            return
        from ..llm.decode import make_greedy_generate
        from ..llm.transformer import dense_causal_attention
        from .engine import DecodeEngine, merged_model

        if any(bl.attn_fn is not dense_causal_attention
               for bl in model.blocks):
            raise ValueError(
                "kv_cache=True supports the default dense attention only "
                "(a custom attn_fn is not replicated by the KV-cached "
                "decode)")
        self._kv_dtype = (getattr(torch, compute_dtype) if compute_dtype
                          else model.dtype)
        self._generate_kv = make_greedy_generate(model.n_heads,
                                                 dtype=self._kv_dtype)
        # top_k -> sampling generate, LRU-bounded (the JAX predictor's
        # sampler cache; its size and evictions are the same knobs)
        self._samplers: "OrderedDict[int, Any]" = OrderedDict()
        self._samplers_cap = max(1, int(sampler_cache_size))
        self._samplers_lock = threading.Lock()
        if decode_slots:
            mesh = None
            if int(engine_mp) > 1:
                from ..parallel.mesh import make_mesh

                mesh = make_mesh({"mp": int(engine_mp)})
            self.engine = DecodeEngine(
                model, adapters, n_slots=int(decode_slots), max_len=max_len,
                eos_id=eos_id, dtype=self._kv_dtype,
                fetch_chunk=engine_fetch_chunk, page_size=kv_page_size,
                n_pages=kv_n_pages, prefill_chunk=prefill_chunk,
                prefix_cache=prefix_cache, paged_kernel=paged_kernel,
                spec_decode=spec_decode, spec_k=spec_k, kv_quant=kv_quant,
                admit_batch=int(admit_batch), mesh=mesh,
                device=self.device).start()
        # the per-request path's weights; an unmeshed engine's are its own
        # (swaps change them there), a tensor-parallel engine's are shards
        self._serving = (None if self.engine is not None
                         and self.engine.mesh is None
                         else merged_model(model, adapters,
                                           dtype=self._kv_dtype))

    def _serving_model(self):
        """The weights both paths serve: the engine's merged model when an
        engine runs (swaps change it there), else this predictor's."""
        return (self.engine.serving_model if self._serving is None
                else self._serving)

    def stop(self, drain: bool = False) -> None:
        """Shut down the engine, if one was started; `drain=True` lets
        in-flight engine requests finish first (bounded by
        `drain_timeout_s`)."""
        if self.engine is not None:
            self.engine.stop(drain=drain,
                             drain_timeout_s=self.drain_timeout_s)

    # ------------------------------------------------------ fleet surface
    @property
    def model_version(self) -> int:
        return (self.engine.model_version if self.engine is not None
                else self._version)

    def swap_adapters(self, adapters: dict,
                      version: Optional[int] = None) -> int:
        """Hot-swap the LoRA adapter values this predictor serves (the
        engine's swap when one runs; the per-request path serves the same
        merged weights). Returns the new model_version."""
        if not self.kv_cache:
            raise ValueError(
                "adapter hot swap needs kv_cache=True — the recompute path "
                "serves a pre-merged model; redeploy the replica instead")
        if self.adapters is None:
            raise ValueError(
                "this predictor was built without adapters — hot swap "
                "replaces adapter VALUES only; deploy with adapters "
                "(zero-initialized LoRA serves the base model exactly)")
        if self.engine is not None:
            ver = self.engine.swap_adapters(adapters, version=version)
            self.adapters = self.engine.adapters
            self._version = ver
            if self._serving is not None:
                self._serving = merged_model(self.model, self.adapters,
                                             dtype=self._kv_dtype)
            return ver
        from .engine import merged_model, prepare_adapter_swap

        new, ver = prepare_adapter_swap(self.adapters, adapters,
                                        self._version, version,
                                        who="this replica")
        serving = merged_model(self.model, new, dtype=self._kv_dtype)
        with recorder.span("serving.swap", version=ver):
            self.adapters, self._serving = new, serving
            self._version = ver
        _mx.set_gauge("serving.model_version", ver)
        _mx.inc("serving.engine.swaps")
        return ver

    def _check_pin(self, input_json: dict) -> None:
        """A request naming `model_version` is answered only by a replica
        serving exactly that version (409 otherwise)."""
        pin = input_json.get("model_version")
        if pin is None:
            return
        try:
            pin = int(pin)
        except (TypeError, ValueError):
            raise InvalidRequest(
                f"model_version must be an integer; got {pin!r}") from None
        if pin != self.model_version:
            raise StaleVersion(
                f"request pinned model_version {pin}; this replica "
                f"serves {self.model_version}")

    def _parse_request(self, input_json: dict, batched: bool
                       ) -> tuple[list, float, list, int]:
        """The validation /predict and its streaming form share: integer
        tokens, numeric sampling knobs, non-empty rows, sampling needs
        kv_cache, knobs need temperature. Returns (rows, temperature,
        knobs, max_new_tokens)."""
        raw = input_json["tokens"]
        try:
            rows = [[int(t) for t in r]
                    for r in (raw if batched else [raw])]
            temperature = float(input_json.get("temperature", 0.0))
            knobs = [k for k in ("top_k", "seed")
                     if int(input_json.get(k) or 0) != 0]
        except (TypeError, ValueError):
            raise InvalidRequest(
                "tokens must be integers and temperature/top_k/seed "
                "numeric") from None
        if not rows or any(not r for r in rows):
            raise InvalidRequest(
                "tokens must contain at least one prompt token"
                " (per row, for a batch)")
        if (temperature > 0 or knobs) and not self.kv_cache:
            raise InvalidRequest(
                "sampling (temperature/top_k/seed) needs kv_cache=True; "
                "the recompute path is greedy-only")
        if temperature <= 0 and knobs:
            raise InvalidRequest(
                f"{'/'.join(knobs)} only apply when temperature > 0 "
                "(temperature omitted or 0 means greedy decoding — the "
                "knobs would be silently ignored)")
        return (rows, temperature, knobs,
                _req_int(input_json, "max_new_tokens", 16))

    def _must_surface_engine_failure(self, prompt_len: int, new: int,
                                     temperature: float,
                                     seed: Optional[int]) -> bool:
        """True when an engine failure must surface (a 500) instead of
        degrading to the per-request path: always for an engine on the
        paged kernel (the per-request path attends densely, so degrading
        would serve the plain version where the kernel failed); otherwise
        when that path could NOT honour what the engine promised: seeded
        sampling (its draws differ), engine_eos_id (no eos on the
        per-request path), or engine-only capacity."""
        return (self._kernel_engine
                or (temperature > 0 and seed is not None)
                or self.eos_id is not None
                or prompt_len + _bucket(max(new, 1), pow2_cap=self.max_len)
                > self.max_len)

    def _sampler(self, top_k: int):
        from ..llm.decode import make_generate

        with self._samplers_lock:
            gen = self._samplers.get(top_k)
            if gen is not None:
                self._samplers.move_to_end(top_k)
                return gen
            gen = make_generate(self.model.n_heads, dtype=self._kv_dtype,
                                sample=True, top_k=top_k)
            self._samplers[top_k] = gen
            while len(self._samplers) > self._samplers_cap:
                self._samplers.popitem(last=False)
                _mx.inc("serving.sampler_evictions")
            return gen

    def _recompute(self, toks: list[int], steps: int) -> list[int]:
        """The recompute path: a whole forward over the prefix per token,
        argmax of the last position."""
        buf = list(toks)
        out = []
        for _ in range(steps):
            logits = self.model(torch.tensor([buf], device=self.device))
            nxt = int(logits[0, -1].float().argmax())
            out.append(nxt)
            buf.append(nxt)
        return out

    def _predict(self, input_json: dict) -> tuple[dict, tuple]:
        self._check_pin(input_json)
        raw = input_json["tokens"]
        batched = bool(raw) and isinstance(raw[0], (list, tuple))
        rows, temperature, knobs, new = self._parse_request(
            input_json, batched)
        if batched and not self.kv_cache:
            raise InvalidRequest(
                "batched prompts need kv_cache=True (the recompute path "
                "decodes one prompt per call)")
        toks = max(rows, key=len)     # the longest row drives capacity
        top_k_req = int(input_json.get("top_k", 0) or 0)
        # engine route: single prompts without a top_k cutoff; capacity is
        # the ENGINE's oracle, so a request its page budget refuses falls
        # through to the per-request path when that path can serve it
        if (self.engine is not None and not batched and top_k_req == 0
                and not self.engine.admissible(len(rows[0]), max(new, 1))):
            if self.eos_id is not None or len(rows[0]) + _bucket(
                    max(new, 1), pow2_cap=self.max_len) > self.max_len:
                raise InvalidRequest(
                    self.engine.capacity_error(len(rows[0]), max(new, 1)))
        elif self.engine is not None and not batched and top_k_req == 0:
            seed = int(input_json["seed"]) if "seed" in input_json else None
            gen = None
            try:
                # a stopped or dead engine degrades to the per-request
                # path below unless _must_surface_engine_failure (a ticket
                # timeout never does)
                gen = self.engine.submit(
                    rows[0], max(new, 1), temperature=temperature,
                    seed=seed).result(timeout=600.0)[:new]
            except RuntimeError:
                if self._must_surface_engine_failure(
                        len(rows[0]), new, temperature, seed):
                    raise
            if gen is not None:
                out = {"generated_tokens": gen}
                if self.detokenize is not None:
                    out["generated_text"] = self.detokenize(gen)
                return out, ("engine",
                             min(_bucket(len(toks), pow2_cap=self.max_len),
                                 self.max_len))
        # the per-request contract: prompt + bucket(max_new_tokens) <=
        # max_len (the JAX predictor's fixed buffer)
        steps = _bucket(max(new, 1), pow2_cap=self.max_len)
        if len(toks) + steps > self.max_len:
            raise InvalidRequest(
                f"prompt {len(toks)} + max_new_tokens {new} (bucketed to "
                f"{steps} decode steps) exceeds max_len {self.max_len}; "
                "shorten the prompt, lower max_new_tokens, or raise "
                "max_len")
        n_dec = max(new, 1)   # decoding past max_new_tokens changes nothing
        if not self.kv_cache:
            with torch.no_grad():
                gen = self._recompute(toks, n_dec)[:new]
            out = {"generated_tokens": gen}
            if self.detokenize is not None:
                out["generated_text"] = self.detokenize(gen)
            return out, ("recompute", steps)
        pbucket = min(_bucket(len(toks), pow2_cap=self.max_len), self.max_len)
        n_rows = len(rows)
        bbucket = _bucket(n_rows) if batched else 1
        prompt = np.zeros((n_rows, len(toks)), np.int64)
        for i, r in enumerate(rows):
            prompt[i, :len(r)] = r
        lengths = [len(r) for r in rows]
        prompt_t = torch.from_numpy(prompt).to(self.device)
        serving = self._serving_model()
        with torch.no_grad():
            if temperature > 0:
                top_k = int(input_json.get("top_k", 0))
                vocab = int(self.model.dims.vocab_size)
                if top_k < 0 or top_k > vocab:
                    raise InvalidRequest(
                        f"top_k must be in [0, vocab_size={vocab}]; got "
                        f"{top_k} (0 disables the cutoff)")
                if top_k:
                    # rounded UP to a power of two, as the JAX predictor
                    top_k = min(_bucket(top_k, pow2_cap=vocab), vocab)
                gen_fn = self._sampler(top_k)
                seed = (int(input_json["seed"]) if "seed" in input_json
                        else random.getrandbits(31))
                key = ("kv", pbucket, bbucket, steps, top_k)
                out_toks = gen_fn(serving, prompt_t, self.max_len, n_dec,
                                  length=lengths, seed=seed,
                                  temperature=temperature)
            else:
                key = ("kv", pbucket, bbucket, steps, -1)
                out_toks = self._generate_kv(serving, prompt_t, self.max_len,
                                             n_dec, length=lengths)
        arr = out_toks.cpu().numpy()
        if batched:
            gen = np.atleast_2d(arr)[:, :new].tolist()
            out = {"generated_tokens": gen}
            if self.detokenize is not None:
                out["generated_text"] = [self.detokenize(g) for g in gen]
        else:
            gen = arr[:new].tolist()
            out = {"generated_tokens": gen}
            if self.detokenize is not None:
                out["generated_text"] = self.detokenize(gen)
        return out, key

    # ---------------------------------------------------------- streaming
    def predict_stream(self, input_json: dict):
        """Generator form of predict() for one prompt: one {"token": t,
        "index": i} per generated token, then {"done": True,
        "generated_tokens": [...]} (+ generated_text). Engine-backed
        requests stream as the engine's frames land; the rest compute
        through predict() and then emit."""
        self._check_pin(input_json)
        raw = input_json["tokens"]
        if raw and isinstance(raw[0], (list, tuple)):
            raise InvalidRequest(
                "streaming serves one prompt per request (batched rows "
                "return a single response; use /predict without stream)")
        rows_w, temperature, _knobs, new = self._parse_request(
            input_json, batched=False)
        rows = rows_w[0]
        top_k = int(input_json.get("top_k", 0) or 0)
        pin = input_json.get("model_version")
        pin = int(pin) if pin is not None else None   # _check_pin validated
        ticket = None
        if (self.engine is not None and top_k == 0
                and self.engine.admissible(len(rows), max(new, 1))):
            seed = int(input_json["seed"]) if "seed" in input_json else None
            try:
                ticket = self.engine.submit(
                    rows, max(new, 1), temperature=temperature, seed=seed)
            except RuntimeError:
                if self._must_surface_engine_failure(
                        len(rows), new, temperature, seed):
                    raise
        if ticket is not None:
            _mx.inc("serving.stream_requests")
            out: list[int] = []
            for tok in ticket.stream(timeout=600.0):
                # a swap that lands mid-stream finishes this slot on the
                # NEW adapters: a pinned stream fails instead of splicing
                if pin is not None and self.model_version != pin:
                    raise StaleVersion(
                        f"request pinned model_version {pin}; this "
                        f"replica swapped to {self.model_version} "
                        "mid-stream")
                if len(out) >= new:
                    break       # new == 0: the engine still decoded one
                out.append(int(tok))
                yield {"token": int(tok), "index": len(out) - 1}
            final = {"done": True, "generated_tokens": out}
            if self.detokenize is not None:
                final["generated_text"] = self.detokenize(out)
            yield final
            return
        res = self.predict(dict(input_json))
        gen = res["generated_tokens"]
        _mx.inc("serving.stream_requests")
        for i, t in enumerate(gen):
            yield {"token": int(t), "index": i}
        yield {"done": True, **res}
