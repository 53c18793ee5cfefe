"""Continuous-batching decode engine (port of `fedml_tpu/serving/engine.py`).

- The engine owns S decode SLOTS over one persistent KV cache on the
  device. Every engine iteration advances all slots through ONE forward
  (`llm/decode.py`) with per-slot positions and an active mask.
- PAGED layout (`page_size` > 0): a pool `[L, n_pages, page_size, H, Dh]`
  (page 0 is the reserved null page) and an int32 `[S, max_pages]` page
  table. Admission reserves ceil((prompt + max_new) / page_size) pages up
  front (host free list), then prefills the prompt in `prefill_chunk`-sized
  chunks, ONE chunk per iteration round-robin across admissions, so a long
  prompt never stalls the decoding slots for its whole prefill; with
  `admit_batch` > 1 up to that many admissions whose next chunks fall in
  the same power-of-two bucket prefill through one batched forward. With
  `paged_kernel=True` decode attention is the hand-written CUDA kernel
  (`ops/paged_attention.py`), which reads each slot's pages in place.
- PREFIX CACHE (paged): full prompt pages are registered under a chained
  blake2b hash of their token ids; a later prompt with the same prefix
  reuses those pages (ref-counted, LRU-evicted leaf-first under pressure)
  and starts its prefill after the hit.
- CONTIGUOUS layout (`page_size=0`): `[L, S, max_len, H, Dh]`, one row per
  slot; admission prefills the whole prompt into the slot's row at once.
  An inactive slot's step writes land on its frozen position, which the
  next admission's prefill or its own decode writes cover before any read.
- SPECULATIVE DECODING (`spec_decode="ngram"`, paged only): each iteration
  self-drafts `spec_k` tokens per slot from the slot's own token history
  (`ngram_propose`) and verifies the window [tok, d1 .. dk] in ONE forward
  (`verify`: the kernel at C = spec_k + 1), accepting the longest prefix
  the target itself would have produced: token i is emitted only when
  every input before it was the target's own pick, so the stream is the
  plain stream. Rollback is positional: pos advances only past accepted
  tokens, and the next window rewrites the rejected positions before
  anything reads them (writes past a slot's reservation go to the null
  page). Counters `serving.spec.proposed` / `.accepted`.
- LoRA ADAPTERS: served as merged weights. The engine merges an adapter
  set ONCE (`merged_model`: `llm.lora.lora_merge`, the arithmetic the
  decode functions' per-call merge uses, so the same bits) and decodes on
  the merged model; the JAX engine merges inside every jitted step, where
  XLA fuses it. Cost: one copy of each adapted kernel. `swap_adapters`
  replaces the set between iterations (no KV teardown): in-flight requests
  finish on the new adapters from their next step; a swap whose keys,
  shapes or dtypes differ is refused. A swap empties the prefix cache,
  whose pages hold K/V of the old adapters (the JAX engine keeps them, so
  a later hit would mix versions). `model_version` is monotonic and rides
  the `serving.model_version` gauge and a `serving.swap` span.
- Retirement is decided ON THE DEVICE (token budget or eos); the host
  learns it from the token frames it fetches. Frames are fetched
  `fetch_chunk` at a time: their device-to-host copies are queued when
  the step is dispatched and waited on in `_drain`, so the host's
  bookkeeping overlaps the device's next steps and no step synchronises.
- Greedy picks are argmax over f32 logits. Temperature sampling draws
  from a per-slot `torch.Generator` seeded from (request seed, position),
  the port's counterpart of the JAX engine's fold_in(key(seed), pos + 1)
  schedule: deterministic per (seed, position), not the same bits. A
  speculative window draws at the plain step's positions, so seeded
  sampling gives the same tokens with speculation on and off; the host
  knows those positions only from the accepted counts, so a window with a
  sampled slot reads its counts back before the next window (greedy
  windows never synchronise).

Capacity contract per request: prompt + max_new_tokens <= max_len, and
(paged) ceil((prompt + max_new_tokens) / page_size) <= n_pages - 1.

Deviations by design: the JAX engine's XLA ledger hooks, its
`program_counts()` and the retrace guards describe compiled XLA programs
and have no torch counterpart. A tensor-parallel `mesh` is not ported yet
(NotImplementedError naming its ROADMAP item).
"""
from __future__ import annotations

import hashlib
import logging
import random
import threading
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from ..llm.decode import (
    draw_seed, gumbel_pick, make_kv_decode, make_paged_kv_decode,
    new_paged_cache, ngram_propose,
)
from ..llm.lora import lora_merge
from ..llm.transformer import TransformerLM
from ..utils import metrics as _mx
from ..utils.events import recorder
from .predictor import InvalidRequest, _bucket

log = logging.getLogger(__name__)

LORA_ALPHA = 16.0   # the JAX engine's (make_*_kv_decode's default alpha)
MULTI_GPU = ("not ported yet (ROADMAP.md, 'Port queue', entry 6, item 4: "
             "multi-GPU)")


def _page_key(parent: bytes, tokens) -> bytes:
    """Chain hash for one prefix page over its token ids (int32 bytes) and
    the parent page's key: identical to the JAX engine's, so the gateway's
    prefix-affinity digests agree across the two."""
    h = hashlib.blake2b(parent, digest_size=16)
    h.update(np.asarray(tokens, np.int32).tobytes())
    return h.digest()


def check_adapter_swap(current: dict, new: dict) -> None:
    """Hot swap replaces adapter VALUES: the replacement must name the same
    kernels, each with the same {"a", "b"} leaves of the same shapes and
    dtypes. Raises ValueError naming the first difference."""
    if current.keys() != new.keys() or any(
            set(current[k]) != set(new[k]) for k in current):
        raise ValueError(
            "adapter swap tree structure differs from the serving tree — "
            "hot swap replaces VALUES of the layout the engine was built "
            "with; redeploy the replica instead")
    for name in current:
        for leaf in current[name]:
            a, b = current[name][leaf], new[name][leaf]
            if a.shape != b.shape or a.dtype != b.dtype:
                raise ValueError(
                    f"adapter swap leaf {name + '/' + leaf!r} is "
                    f"{tuple(b.shape)}/{b.dtype}; the serving tree has "
                    f"{tuple(a.shape)}/{a.dtype} — shapes and dtypes are "
                    "fixed for the engine's lifetime")


def prepare_adapter_swap(current: dict, adapters: dict,
                         current_version: int, version: Optional[int],
                         who: str = "the engine") -> tuple[dict, int]:
    """The validate-and-version step shared by `DecodeEngine.swap_adapters`
    and the predictor's engine-less path: refuse an empty set and a layout
    change, and compute the monotonic target version. Returns (adapters,
    new_version)."""
    if not adapters:
        raise ValueError("swap_adapters needs a non-empty adapter tree")
    check_adapter_swap(current, adapters)
    ver = current_version + 1 if version is None else int(version)
    if ver <= current_version:
        raise ValueError(
            f"model_version must be monotonic: swap to {ver} but "
            f"{who} already serves {current_version}")
    return adapters, ver


def merged_model(model, adapters: Optional[dict],
                 alpha: float = LORA_ALPHA):
    """`model` with `adapters` merged into its adapted kernels, W +
    (alpha / r) * A @ B in W's dtype (`llm.lora.lora_merge`), as a
    `TransformerLM` that shares every other tensor with `model`; `model`
    itself when there are no adapters."""
    if not adapters:
        return model
    state = model.state_dict()
    for name, ab in adapters.items():
        w = state.get(name)
        if w is None or w.dim() != 2:
            raise ValueError(f"adapter {name!r} names no kernel of the "
                             "model")
        if set(ab) != {"a", "b"} or ab["a"].shape[0] != w.shape[0] \
                or ab["b"].shape[1] != w.shape[1] \
                or ab["a"].shape[1] != ab["b"].shape[0]:
            raise ValueError(
                f"adapter {name!r} must be {{'a': [{w.shape[0]}, r], "
                f"'b': [r, {w.shape[1]}]}}")
        if ab["a"].device != w.device or ab["b"].device != w.device:
            raise ValueError(f"adapter {name!r} is on {ab['a'].device}, the "
                             f"model on {w.device}")
    with torch.no_grad():
        merged = lora_merge(state, adapters, alpha)
    return TransformerLM.from_state(model.dims, merged)


class _PrefixEntry:
    """One resident prefix page: refs counts slots decoding over it, kids
    its resident chain extensions; evictable only at refs == kids == 0.
    `stale` marks an entry an adapter swap dropped from the map while
    slots still held it: its page is freed when the last one lets go."""

    __slots__ = ("page", "parent", "refs", "kids", "tick", "stale")

    def __init__(self, page: int, parent: Optional[bytes], tick: int):
        self.page = page
        self.parent = parent
        self.refs = 1
        self.kids = 0
        self.tick = tick
        self.stale = False


class _Admission:
    """One in-flight chunked admission: `row` is the slot's page-table row
    (prefix-hit pages then fresh ones), `t0` the next prompt position to
    prefill, `keys` the chain hashes of every full prompt page."""

    __slots__ = ("req", "slot", "row", "row_dev", "t0", "keys", "hit_pages",
                 "version")

    def __init__(self, req, slot, row, t0, keys, hit_pages, version):
        self.req = req
        self.slot = slot
        self.row = row
        self.row_dev = None
        self.t0 = t0
        self.keys = keys
        self.hit_pages = hit_pages
        self.version = version


class Ticket:
    """Per-request handle. Tokens are pushed as the host observes them, so
    `stream()` relays them while the request still decodes; `result()`
    blocks until it retires."""

    __slots__ = ("_cv", "_done", "_tokens", "_error", "t_submit", "t_first",
                 "t_done")

    def __init__(self):
        self._cv = threading.Condition()
        self._done = threading.Event()
        self._tokens: list[int] = []
        self._error: Optional[BaseException] = None
        self.t_submit = time.perf_counter()
        self.t_first: Optional[float] = None
        self.t_done: Optional[float] = None

    def _push(self, tok: int) -> None:
        with self._cv:
            self._tokens.append(tok)
            self._cv.notify_all()

    def _finish(self, error: Optional[BaseException] = None) -> None:
        with self._cv:
            if error is not None and self._error is None:
                self._error = error
            self._done.set()
            self._cv.notify_all()

    def result(self, timeout: Optional[float] = None) -> list[int]:
        """The generated tokens (an eos that ended generation included)."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"decode engine ticket not done after "
                               f"{timeout}s")
        if self._error is not None:
            raise self._error
        with self._cv:
            return list(self._tokens)

    def stream(self, timeout: Optional[float] = None):
        """Yield tokens as the engine delivers them; `timeout` bounds the
        wait for each next token. Raises the ticket's error after the
        tokens that arrived before it."""
        i = 0
        while True:
            with self._cv:
                while i >= len(self._tokens) and not self._done.is_set():
                    if not self._cv.wait(timeout):
                        raise TimeoutError(
                            f"no token from the decode engine in {timeout}s")
                if i >= len(self._tokens):
                    if self._error is not None:
                        raise self._error
                    return
                tok = self._tokens[i]
            yield tok
            i += 1

    def done(self) -> bool:
        return self._done.is_set()


class _Request:
    __slots__ = ("tokens", "max_new", "temperature", "seed", "ticket")

    def __init__(self, tokens, max_new, temperature, seed):
        self.tokens = tokens
        self.max_new = max_new
        self.temperature = temperature
        self.seed = seed
        self.ticket = Ticket()


class _Swap:
    """One queued hot adapter swap, applied by the engine thread between
    iterations; `applied` releases the waiting caller."""

    __slots__ = ("adapters", "model", "version", "applied", "error")

    def __init__(self, adapters, model, version: int):
        self.adapters = adapters
        self.model = model
        self.version = version
        self.applied = threading.Event()
        self.error: Optional[BaseException] = None


class _SlotState:
    """Host view of an occupied slot: what retirement must release is
    `entries` (prefix pages it holds a ref on) and `private` (pages it
    owns outright)."""

    __slots__ = ("req", "out", "t_first", "entries", "private")

    def __init__(self, req: _Request):
        self.req = req
        self.out: list[int] = []
        self.t_first: Optional[float] = None
        self.entries: list[_PrefixEntry] = []
        self.private: list[int] = []


class DecodeEngine:
    """S-slot continuous-batching decoder.

    `model` is an `llm.transformer.TransformerLM` already on `device`
    (CUDA unless the caller passes device="cpu"; with no GPU and no
    device= the constructor raises); `adapters` an `llm.lora` adapter dict
    on the same device, or None. `page_size` > 0 selects the paged pool:
    `n_pages` sizes it (default: n_slots * ceil(max_len / page_size) + the
    null page), `prefill_chunk` bounds one admission chunk (0 = the whole
    prompt), `prefix_cache` toggles prefix page reuse, `paged_kernel`
    routes decode attention through the CUDA kernel, `spec_decode="ngram"`
    (+ `spec_k` drafts) verifies self-drafted windows, `kv_quant="int8"`
    stores the pool in int8 with per-(page, head) f32 scales, and
    `admit_batch` > 1 batches same-bucket admission chunks; each of these
    is refused with page_size=0 (the contiguous layout), as in the JAX
    engine. `dtype` is the compute and KV dtype (default: the model's).
    `eos_id=None` disables eos retirement."""

    def __init__(self, model, adapters=None, *, n_slots: int = 4,
                 max_len: int = 256, eos_id: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None, fetch_chunk: int = 2,
                 page_size: int = 0, n_pages: Optional[int] = None,
                 prefill_chunk: int = 0, prefix_cache: bool = True,
                 paged_kernel: bool = False, spec_decode: str = "off",
                 spec_k: int = 4, kv_quant: str = "off",
                 admit_batch: int = 1, mesh=None, device=None):
        self.device = resolve_device(device)
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1; got {n_slots}")
        if mesh is not None:
            raise NotImplementedError(
                "a tensor-parallel mesh is " + MULTI_GPU)
        self.model = model
        self.n_slots = S = int(n_slots)
        self.max_len = int(max_len)
        self.fetch_chunk = max(1, int(fetch_chunk))
        # page_size > 0 selects the paged pool; the paged knobs are
        # refused in contiguous mode so a config asking for them is never
        # silently ignored (the JAX engine's gating and messages)
        self._paged = int(page_size or 0) > 0
        if self._paged:
            self._page_size = int(page_size)
            self._max_pages = -(-self.max_len // self._page_size)
            self._n_pages = (int(n_pages) if n_pages
                             else S * self._max_pages + 1)
            if self._n_pages < 2:
                raise ValueError(f"n_pages must be >= 2 (page 0 is the "
                                 f"reserved null page); got {self._n_pages}")
            if int(prefill_chunk) < 0:
                raise ValueError(f"prefill_chunk must be >= 0 (0 = whole-"
                                 f"prompt chunks); got {prefill_chunk}")
            self._usable = self._n_pages - 1
            self._prefill_chunk = int(prefill_chunk)
            self._prefix_on = bool(prefix_cache)
            self._free_pages: list[int] = list(range(1, self._n_pages))
            self._prefix: dict[bytes, _PrefixEntry] = {}
            self._ticks = 0
            _mx.set_gauge("serving.kv_pages_budget", self._usable)
            _mx.set_gauge("serving.kv_pages_free", len(self._free_pages))
        elif n_pages or prefill_chunk:
            raise ValueError(
                "kv_n_pages/prefill_chunk configure the PAGED cache — set "
                "page_size > 0 (they would be silently ignored in "
                "contiguous mode)")
        self._kernel_on = bool(paged_kernel)
        if self._kernel_on and not self._paged:
            raise ValueError(
                "paged_kernel fuses attention over the PAGED KV pool — set "
                "page_size > 0 (in contiguous mode the knob would be "
                "silently ignored)")
        if spec_decode not in ("off", "ngram"):
            raise ValueError(
                f"spec_decode must be 'off' or 'ngram'; got {spec_decode!r}")
        self._spec_on = spec_decode == "ngram"
        self._spec_k = int(spec_k)
        if self._spec_on and not self._paged:
            raise ValueError(
                "spec_decode verifies draft windows over the PAGED KV cache "
                "(write positions roll back through the page table) — set "
                "page_size > 0")
        if self._spec_on and self._spec_k < 1:
            raise ValueError(
                f"spec_k must be >= 1 draft tokens; got {spec_k}")
        if kv_quant not in ("off", "int8"):
            raise ValueError(f"kv_quant must be 'off' or 'int8'; got "
                             f"{kv_quant!r}")
        self._quant = kv_quant == "int8"
        if self._quant and not self._paged:
            raise ValueError(
                "kv_quant stores the PAGED KV pool in int8 (per-page-per-"
                "head scales ride the page table) — set page_size > 0 (in "
                "contiguous mode the knob would be silently ignored)")
        self._admit_batch = int(admit_batch)
        if self._admit_batch < 1:
            raise ValueError(f"admit_batch must be >= 1; got {admit_batch}")
        if self._admit_batch > 1 and not self._paged:
            raise ValueError(
                "admit_batch groups PAGED admission chunks into one batched "
                "prefill — set page_size > 0 (in contiguous mode the knob "
                "would be silently ignored)")
        if model.device != self.device:
            raise ValueError(f"the model's weights are on {model.device}, "
                             f"the engine runs on {self.device}")
        self._eos = -1 if eos_id is None else int(eos_id)  # -1 never matches
        self.dtype = dtype or model.dtype
        self.adapters = adapters
        # what every forward runs on: the model with the adapters merged
        self._serving = merged_model(model, adapters)
        heads, dh = model.n_heads, model.d_model // model.n_heads
        dev = self.device
        if self._paged:
            (self._chunk_fn, self._step_fn, self._verify_fn,
             self._chunk_batch_fn) = make_paged_kv_decode(
                heads, self._page_size, dtype=self.dtype,
                kernel=self._kernel_on, quant=self._quant)
            self._cache = new_paged_cache(
                model.n_layers, self._n_pages, self._page_size, heads, dh,
                self.dtype, dev, quant=self._quant)
        else:
            self._prefill_fn, self._cstep_fn = make_kv_decode(
                heads, dtype=self.dtype)
            z = (model.n_layers, S, self.max_len, heads, dh)
            self._cache = {"k": torch.zeros(z, dtype=self.dtype, device=dev),
                           "v": torch.zeros(z, dtype=self.dtype, device=dev)}
        kv_bytes = sum(t.numel() * t.element_size()
                       for t in self._cache.values())
        _mx.set_gauge("serving.kv_bytes_per_slot", kv_bytes // S)
        self._carry = {
            "pos": torch.zeros((S,), dtype=torch.int32, device=dev),
            "tok": torch.zeros((S,), dtype=torch.int64, device=dev),
            "active": torch.zeros((S,), dtype=torch.bool, device=dev),
            "limit": torch.zeros((S,), dtype=torch.int32, device=dev),
        }
        if self._paged:
            self._carry["pages"] = torch.zeros(
                (S, self._max_pages), dtype=torch.int32, device=dev)
        if self._spec_on:
            # each slot's token history (prompt + generated), the draft
            # source; column max_len is a trash column that absorbs the
            # writes of inactive slots and out-of-range window positions
            self._carry["hist"] = torch.zeros(
                (S, self.max_len + 1), dtype=torch.int64, device=dev)
            self._slot_idx = torch.arange(S, device=dev)
            self._win = torch.arange(self._spec_k + 1, device=dev)
        # host mirrors of what sampling needs: each slot's temperature,
        # seed and next write position (an active slot's device pos)
        self._temp = [0.0] * S
        self._seed = [0] * S
        self._host_pos = [0] * S
        self._gens = [torch.Generator(device=dev) for _ in range(S)]
        self.decode_steps = 0
        self._admissions: deque[_Admission] = deque()

        self._cond = threading.Condition()
        self._waiting: deque[_Request] = deque()
        self._free: list[int] = list(range(S))
        self._slots: list[Optional[_SlotState]] = [None] * S
        self._stopping = False
        self._draining = False
        self._thread: Optional[threading.Thread] = None
        self._version = 0
        self._pending_swap: Optional[_Swap] = None
        _mx.set_gauge("serving.model_version", 0)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "DecodeEngine":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="decode-engine")
        self._thread.start()
        return self

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Refuse new submits and wait (bounded) for every accepted request
        to finish. Returns False when the deadline expired first."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()
            deadline = time.monotonic() + timeout_s
            while self._waiting or any(s is not None for s in self._slots):
                if (self._stopping or self._thread is None
                        or not self._thread.is_alive()):
                    break
                left = deadline - time.monotonic()
                if left <= 0:
                    _mx.inc("serving.engine.drain_timeouts")
                    return False
                self._cond.wait(min(0.1, left))
        return True

    def stop(self, drain: bool = False,
             drain_timeout_s: float = 30.0) -> None:
        """Tear down; `drain=True` first lets in-flight requests finish
        (bounded). Whatever is still in flight is errored."""
        if drain and self._thread is not None and self._thread.is_alive():
            self.drain(drain_timeout_s)
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10)
        self._fail_outstanding(RuntimeError("decode engine stopped"))

    # ------------------------------------------------------------- hot swap
    @property
    def model_version(self) -> int:
        return self._version

    @property
    def serving_model(self):
        """The model every forward runs on (adapters merged)."""
        return self._serving

    def swap_adapters(self, adapters: dict, version: Optional[int] = None,
                      timeout: float = 60.0) -> int:
        """Replace the served adapter VALUES between iterations: the KV
        cache survives, in-flight requests finish on the new adapters from
        their next step, and a swap whose layout differs is refused
        (`check_adapter_swap`). The new set is merged here, in the
        caller's thread, so the engine thread only swaps a reference.
        Returns the new monotonic `model_version` (default current + 1)."""
        with self._cond:
            cur = self.adapters
            self._check_no_pending_swap()
        if cur is None:
            raise ValueError(
                "this engine was built without adapters — hot swap replaces "
                "adapter VALUES only; deploy the replica with adapters "
                "(zero-initialized LoRA serves the base model exactly) to "
                "enable rolling updates")
        # validated and merged outside the lock: the engine thread takes it
        # every iteration, so decoding goes on during the merge
        new, _ver = prepare_adapter_swap(cur, adapters, self._version,
                                         version)
        merged = merged_model(self.model, new)
        with self._cond:
            self._check_no_pending_swap()
            # re-checked against the version now served: a swap may have
            # landed during the merge
            new, ver = prepare_adapter_swap(self.adapters, new,
                                            self._version, version)
            swap = _Swap(new, merged, ver)
            running = (self._thread is not None and self._thread.is_alive()
                       and not self._stopping)
            if running:
                self._pending_swap = swap
                self._cond.notify_all()
        if not running:
            self._apply_swap(swap)
            return self._version
        if not swap.applied.wait(timeout):
            raise TimeoutError(f"adapter swap not applied in {timeout}s")
        if swap.error is not None:
            raise swap.error
        return self._version

    def _check_no_pending_swap(self) -> None:
        if self._pending_swap is not None:
            raise RuntimeError(
                "an adapter swap is already pending — serialize swaps "
                "(the rolling updater does)")

    def _apply_swap(self, swap: _Swap) -> None:
        """Between iterations: one reference swap; the next forward reads
        the new weights. The prefix cache goes with the old adapters: its
        pages hold K/V they computed (wq / wk / wv are adapted), so a hit
        after the swap would splice versions (the JAX engine keeps them)."""
        with recorder.span("serving.swap", version=swap.version):
            self.adapters = swap.adapters
            self._serving = swap.model
            self._version = swap.version
            if self._paged:
                self._drop_prefix_cache()
        _mx.set_gauge("serving.model_version", swap.version)
        _mx.inc("serving.engine.swaps")
        swap.applied.set()

    # ------------------------------------------------------------ admission
    def submit(self, tokens, max_new_tokens: int, temperature: float = 0.0,
               seed: Optional[int] = None) -> Ticket:
        """Queue one prompt; returns the Ticket its tokens stream to.
        temperature <= 0 is greedy; a sampled request is deterministic per
        seed (a random one when seed is None)."""
        tokens = [int(t) for t in tokens]
        if not tokens:
            raise InvalidRequest("tokens must contain at least one prompt "
                                 "token")
        max_new = int(max_new_tokens)
        if max_new < 1:
            raise InvalidRequest(f"max_new_tokens must be >= 1; got "
                                 f"{max_new}")
        if not self.admissible(len(tokens), max_new):
            raise InvalidRequest(self.capacity_error(len(tokens), max_new))
        if seed is None:
            seed = random.getrandbits(31)
        req = _Request(tokens, max_new, float(temperature),
                       int(seed) & 0xFFFFFFFF)
        with self._cond:
            if self._stopping or (self._thread is not None
                                  and not self._thread.is_alive()):
                raise RuntimeError("decode engine is stopped")
            if self._draining:
                raise RuntimeError("decode engine is draining (replica "
                                   "stopping) — request refused")
            if self._thread is None:
                raise RuntimeError("decode engine not started (call "
                                   ".start())")
            self._waiting.append(req)
            _mx.set_gauge("serving.engine.queue", len(self._waiting))
            self._cond.notify_all()
        _mx.inc("serving.engine.requests")
        return req.ticket

    def admissible(self, prompt_len: int, max_new: int) -> bool:
        """THE capacity oracle: prompt + max_new <= max_len and (paged) its
        pages fit the usable pool."""
        total = int(prompt_len) + int(max_new)
        if total > self.max_len:
            return False
        return (not self._paged
                or -(-total // self._page_size) <= self._usable)

    def capacity_error(self, prompt_len: int, max_new: int) -> str:
        if not self._paged:
            return (f"prompt {prompt_len} + max_new_tokens {max_new} "
                    f"exceeds max_len {self.max_len} (engine slot capacity "
                    "contract: prompt + max_new_tokens <= max_len)")
        tot = prompt_len + max_new
        need = -(-tot // self._page_size)
        return (f"prompt {prompt_len} + max_new_tokens {max_new} = {tot} "
                f"tokens needs ceil({tot}/{self._page_size}) = {need} KV "
                f"pages, but the engine budget is {self._usable} usable "
                f"pages (n_pages {self._n_pages} minus the reserved null "
                f"page) with per-request cap max_len {self.max_len} (paged "
                "capacity contract: prompt + max_new_tokens <= max_len AND "
                "ceil((prompt + max_new_tokens) / page_size) <= n_pages - 1)")

    @property
    def kv_page_size(self) -> int:
        """Page size of the paged pool (0 = contiguous), advertised on
        /info for prefix-affinity routing."""
        return self._page_size if self._paged else 0

    def prefix_digests(self, limit: int = 64) -> list:
        """Hex digests of resident FIRST-page prefix keys (the residency
        hint replicas advertise for prefix-affinity routing)."""
        if not (self._paged and self._prefix_on):
            return []
        out = []
        for key, ent in list(self._prefix.items()):
            if ent.parent is None:
                out.append(key.hex())
                if len(out) >= limit:
                    break
        return out

    # ------------------------------------------------------ device helpers
    def _h2d(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without blocking the host: pinned
        staging plus a non-blocking copy on the current stream."""
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _d2h(self, t: torch.Tensor):
        """Queue a device -> host copy now; `_drain` waits on its event."""
        if self.device.type != "cuda":
            return t.clone(), None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    def _pick(self, logits: torch.Tensor, draws) -> torch.Tensor:
        """Greedy argmax over f32 logits [N, V]; rows listed in `draws` as
        (row, slot, position) sample instead, by the Gumbel-max rule, from
        the slot's generator seeded by (request seed, position)."""
        out = logits.float().argmax(-1)
        for row, slot, position in draws:
            g = self._gens[slot]
            g.manual_seed(draw_seed(self._seed[slot], position))
            out[row] = gumbel_pick(logits[row], self._temp[slot], g)
        return out

    def _arm(self, slot: int, req: _Request, logits: torch.Tensor):
        """A request's final prefill logits [1, V] -> its first token [1];
        the slot's rows arm (active iff that token did not end it and
        budget remains)."""
        c = self._carry
        plen = len(req.tokens)
        limit = plen + req.max_new - 1
        self._temp[slot], self._seed[slot] = req.temperature, req.seed
        self._host_pos[slot] = plen
        draws = [(0, slot, plen)] if req.temperature > 0 else []
        first = self._pick(logits, draws)
        c["pos"][slot] = plen
        c["tok"][slot] = first[0]
        c["active"][slot] = (first[0] != self._eos) & (plen < limit)
        c["limit"][slot] = limit
        return first

    def _admit(self, adm: _Admission, clen: int, final: bool):
        """ONE prefill chunk of one admission. On the final chunk the first
        token is picked and the slot's rows arm; returns the first-token
        tensor [1], or None for a non-final chunk."""
        c, slot, req = self._carry, adm.slot, adm.req
        if adm.row_dev is None:
            adm.row_dev = self._h2d(adm.row)
            c["pages"][slot] = adm.row_dev
        toks = self._h2d(np.asarray(req.tokens[adm.t0:adm.t0 + clen],
                                    np.int64)[None])
        if self._spec_on:
            c["hist"][slot, adm.t0:adm.t0 + clen] = toks[0]
        logits = self._chunk_fn(self._serving, self._cache, adm.row_dev,
                                toks, adm.t0, clen)
        if not final:
            c["active"][slot] = False
            return None
        return self._arm(slot, req, logits)

    def _step_all(self, stepping: list[int]):
        """Advance every slot one token; retirement (budget, eos) decided
        on the device. Returns (tokens [S], the entry active mask [S])."""
        c = self._carry
        if self._paged:
            logits = self._step_fn(self._serving, self._cache, c["pages"],
                                   c["pos"], c["tok"], c["active"])
        else:
            logits = self._cstep_fn(self._serving, self._cache, c["pos"],
                                    c["tok"])
        draws = [(s, s, self._host_pos[s] + 1) for s in stepping
                 if self._temp[s] > 0]
        nxt = self._pick(logits, draws)
        active = c["active"]
        pos2 = torch.where(active, c["pos"] + 1, c["pos"])
        c["active"] = active & (pos2 < c["limit"]) & (nxt != self._eos)
        c["tok"] = torch.where(active, nxt, c["tok"])
        c["pos"] = pos2
        for s in stepping:
            self._host_pos[s] += 1
        return nxt, active

    def _spec_all(self, stepping: list[int]):
        """One speculative window for every slot: draft spec_k tokens from
        each slot's history, verify [tok, d1..dk] in one forward, accept
        the longest prefix of the target's own picks (the JAX engine's
        rule). Returns (picks [S, C], accepted counts [S], 0 = inert)."""
        c = self._carry
        C, ml, eos = self._spec_k + 1, self.max_len, self._eos
        pos, tok, active = c["pos"], c["tok"], c["active"]
        hist, ar = c["hist"], self._slot_idx
        pos_l = pos.long()
        # the current token is real history at its write position: anchor
        # it before drafting (inactive slots write the trash column)
        hist[ar, torch.where(active, pos_l, ml)] = tok
        drafts = ngram_propose(hist[:, :ml], pos_l, C - 1)
        inputs = torch.cat([tok[:, None], drafts], dim=1)         # [S, C]
        widx = pos_l[:, None] + self._win
        # the window's inputs: accepted ones become history, rejected ones
        # sit past the new pos and are rewritten before they can anchor
        hist[ar[:, None], torch.where(active[:, None] & (widx < ml),
                                      widx, ml)] = inputs
        logits = self._verify_fn(self._serving, self._cache, c["pages"],
                                 pos, inputs, active)             # [S, C, V]
        # the plain step's draw positions: window entry i of slot s is the
        # pick made at position pos + i + 1
        sampled = [s for s in stepping if self._temp[s] > 0]
        draws = [(s * C + i, s, self._host_pos[s] + i + 1)
                 for s in sampled for i in range(C)]
        g = self._pick(logits.reshape(-1, logits.shape[-1]),
                       draws).reshape(pos.shape[0], C)
        limit = c["limit"]
        emit = [active]
        for i in range(1, C):
            emit.append(emit[-1] & (inputs[:, i] == g[:, i - 1])
                        & (g[:, i - 1] != eos) & (pos + i < limit))
        n_acc = torch.stack(emit, dim=1).sum(dim=1)
        last = g[ar, (n_acc - 1).clamp(min=0)]
        pos2 = torch.where(active, pos + n_acc.to(pos.dtype), pos)
        c["tok"] = torch.where(active, last, tok)
        c["active"] = active & (pos2 < limit) & (last != eos)
        c["pos"] = pos2
        counts = torch.where(active, n_acc, 0)
        if sampled:
            # the next window's draws need these slots' positions, which
            # only the accepted counts give: read them back now
            host = counts.cpu()
            for s in stepping:
                self._host_pos[s] += int(host[s])
        return g, counts

    # ------------------------------------------------------------ engine loop
    def _loop(self) -> None:
        # frames: ("admit", slot, copy) | ("step", toks, mask)
        #         | ("spec", picks, counts)
        pending: deque[tuple] = deque()
        try:
            with torch.no_grad():
                while True:
                    with self._cond:
                        if self._stopping:
                            break
                        swap, self._pending_swap = self._pending_swap, None
                        idle = (swap is None and not self._waiting
                                and not pending
                                and all(s is None for s in self._slots))
                        if idle:
                            self._cond.wait(0.2)
                            continue
                    if swap is not None:
                        # between iterations: every later forward reads the
                        # new weights
                        self._apply_swap(swap)
                    if self._paged:
                        self._advance_admissions(pending)
                    else:
                        self._admit_ready(pending)
                    # step when any occupied slot is past admission (a slot
                    # mid-prefill is inert on the device)
                    admitting = {a.slot for a in self._admissions}
                    stepping = [i for i, s in enumerate(self._slots)
                                if s is not None and i not in admitting]
                    if stepping:
                        if self._spec_on:
                            toks, counts = self._spec_all(stepping)
                            pending.append(("spec", self._d2h(toks),
                                            self._d2h(counts)))
                        else:
                            toks, mask = self._step_all(stepping)
                            pending.append(("step", self._d2h(toks),
                                            self._d2h(mask)))
                        self.decode_steps += 1
                    # keep `fetch_chunk` frames in flight; drain eagerly
                    # when requests starve for a slot or nothing decodes
                    with self._cond:
                        starved = bool(self._waiting) and not self._free
                    eager = starved or all(s is None for s in self._slots)
                    while pending and (eager
                                       or len(pending) >= self.fetch_chunk):
                        self._drain(pending.popleft())
        except Exception as e:  # noqa: BLE001 — fail tickets, not silently
            log.exception("decode engine loop died")
            _mx.inc("serving.engine.errors")
            with self._cond:
                self._stopping = True
            self._fail_outstanding(
                RuntimeError(f"decode engine failed: {type(e).__name__}: {e}"))

    def _admit_ready(self, pending: deque) -> None:
        """Contiguous admission: each waiting request with a free slot
        prefills its whole prompt into the slot's row."""
        while True:
            with self._cond:
                if not (self._free and self._waiting):
                    return
                req = self._waiting.popleft()
                slot = self._free.pop()
                self._slots[slot] = _SlotState(req)
                _mx.set_gauge("serving.engine.queue", len(self._waiting))
            with recorder.span("serving.engine.admit", slot=slot,
                               prompt=len(req.tokens)):
                toks = self._h2d(np.asarray(req.tokens, np.int64)[None])
                _cache, logits = self._prefill_fn(
                    self._serving, toks, self.max_len, cache=self._cache,
                    rows=slot)
                first = self._arm(slot, req, logits)
            pending.append(("admit", slot, self._d2h(first)))
            _mx.inc("serving.engine.admissions")

    # ----------------------------------------------- paged admission plane
    # The page machinery runs on the engine thread only; _cond guards the
    # _waiting/_free/_slots handoff with submit()/stop().
    def _next_tick(self) -> int:
        self._ticks += 1
        return self._ticks

    def _prefix_lookup(self, toks: list[int]):
        """(chain keys of every FULL prompt page, resident hit entries);
        hits stop at (prompt_len - 1) // page_size pages so the prompt's
        last token is always prefilled (its logits give the first token)."""
        ps = self._page_size
        keys: list[bytes] = []
        key = b"\x00"
        for i in range(len(toks) // ps):
            key = _page_key(key, toks[i * ps:(i + 1) * ps])
            keys.append(key)
        hits: list[_PrefixEntry] = []
        for i in range((len(toks) - 1) // ps):
            e = self._prefix.get(keys[i])
            if e is None:
                break
            hits.append(e)
        return keys, hits

    def _alloc(self, n: int) -> Optional[list[int]]:
        """Pop n free pages, evicting LRU leaf prefix entries (refs == 0,
        kids == 0) under pressure; None when in-flight requests pin the
        pool (the caller re-queues)."""
        while len(self._free_pages) < n:
            victim, vkey = None, None
            for k, e in self._prefix.items():
                if e.refs == 0 and e.kids == 0 and (
                        victim is None or e.tick < victim.tick):
                    victim, vkey = e, k
            if victim is None:
                return None
            del self._prefix[vkey]
            if victim.parent is not None and victim.parent in self._prefix:
                self._prefix[victim.parent].kids -= 1
            self._free_pages.append(victim.page)
            _mx.inc("serving.prefix_evictions")
        pages = [self._free_pages.pop() for _ in range(n)]
        _mx.set_gauge("serving.kv_pages_free", len(self._free_pages))
        return pages

    def _release_slot_pages(self, st: _SlotState) -> None:
        """Drop the slot's refs on shared prefix pages (they stay resident,
        evictable; a stale one is freed by its last holder) and return its
        private pages to the free list."""
        for e in st.entries:
            e.refs -= 1
            if e.stale and e.refs == 0:
                self._free_pages.append(e.page)
        self._free_pages.extend(st.private)
        st.entries, st.private = [], []
        _mx.set_gauge("serving.kv_pages_free", len(self._free_pages))

    def _drop_prefix_cache(self) -> None:
        """Empty the prefix map: unheld pages go back to the free list,
        held ones are marked stale and freed by their last holder."""
        for e in self._prefix.values():
            if e.refs == 0:
                self._free_pages.append(e.page)
            else:
                e.stale = True
        self._prefix.clear()
        _mx.set_gauge("serving.kv_pages_free", len(self._free_pages))

    def _start_admissions(self) -> None:
        """Claim (slot, pages) for waiting requests, FIFO; a request whose
        pages are pinned right now goes back to the queue head."""
        while True:
            with self._cond:
                if not (self._free and self._waiting):
                    return
                req = self._waiting.popleft()
                slot = self._free.pop()
                self._slots[slot] = _SlotState(req)
                _mx.set_gauge("serving.engine.queue", len(self._waiting))
            ps = self._page_size
            keys, hits = (self._prefix_lookup(req.tokens)
                          if self._prefix_on else ([], []))
            total = -(-(len(req.tokens) + req.max_new) // ps)
            # hold the hit refs BEFORE allocating: _alloc evicts refs == 0
            # entries, and evicting the pages just looked up would leave
            # this row pointing at pages another request may own
            now = self._next_tick()
            for e in hits:
                e.refs += 1
                e.tick = now
            fresh = self._alloc(total - len(hits))
            if fresh is None:
                for e in hits:
                    e.refs -= 1
                with self._cond:
                    self._slots[slot] = None
                    self._free.append(slot)
                    self._waiting.appendleft(req)
                    _mx.set_gauge("serving.engine.queue", len(self._waiting))
                return
            st = self._slots[slot]
            st.entries = list(hits)
            st.private = list(fresh)
            row = np.zeros(self._max_pages, np.int32)
            row[:len(hits)] = [e.page for e in hits]
            row[len(hits):total] = fresh
            if hits:
                _mx.inc("serving.prefix_hits")
                _mx.inc("serving.prefix_hit_pages", len(hits))
            elif self._prefix_on:
                _mx.inc("serving.prefix_misses")
            self._admissions.append(_Admission(
                req, slot, row, len(hits) * ps, keys, len(hits),
                self._version))
            _mx.inc("serving.engine.admissions")

    def _advance_admissions(self, pending: deque) -> None:
        """ONE prefill chunk per iteration, round-robin across admissions:
        `prefill_chunk`-sized chunks, then the remainder (admit_batch > 1:
        up to that many same-bucket chunks in one forward)."""
        self._start_admissions()
        if not self._admissions:
            return
        if self._admit_batch > 1:
            self._advance_admissions_batched(pending)
            return
        adm = self._admissions.popleft()
        plen = len(adm.req.tokens)
        clen = min(self._prefill_chunk or self.max_len, plen - adm.t0)
        final = adm.t0 + clen == plen
        with recorder.span("serving.engine.admit", slot=adm.slot,
                           prompt=plen, t0=adm.t0, chunk=clen, final=final):
            first = self._admit(adm, clen, final)
        _mx.inc("serving.engine.prefill_chunks")
        if final:
            self._register_prefix(adm)
            pending.append(("admit", adm.slot, self._d2h(first)))
        else:
            adm.t0 += clen
            self._admissions.append(adm)

    def _advance_admissions_batched(self, pending: deque) -> None:
        """Batched admission: pop up to admit_batch admissions whose NEXT
        chunk lands in the SAME power-of-two chunk bucket (the JAX
        engine's grouping) and prefill them through one forward, rows
        right-padded to the group's longest chunk; admissions of another
        bucket go back ahead of the queue, keeping round-robin order."""
        cap = self._prefill_chunk or self.max_len

        def clen_of(adm):
            return min(cap, len(adm.req.tokens) - adm.t0)

        def bucket(adm):
            return min(_bucket(clen_of(adm), pow2_cap=cap), cap)

        group = [self._admissions.popleft()]
        cb = bucket(group[0])
        skipped = []
        while self._admissions and len(group) < self._admit_batch:
            adm = self._admissions.popleft()
            (group if bucket(adm) == cb else skipped).append(adm)
        self._admissions.extendleft(reversed(skipped))
        b = len(group)
        clens = [clen_of(adm) for adm in group]
        toks = np.zeros((b, max(clens)), np.int64)
        for i, adm in enumerate(group):
            toks[i, :clens[i]] = adm.req.tokens[adm.t0:adm.t0 + clens[i]]
        finals = [adm.t0 + n == len(adm.req.tokens)
                  for adm, n in zip(group, clens)]
        c = self._carry
        with recorder.span("serving.engine.admit", batch=b, chunk=cb):
            for adm in group:
                if adm.row_dev is None:
                    adm.row_dev = self._h2d(adm.row)
                    c["pages"][adm.slot] = adm.row_dev
            toks_dev = self._h2d(toks)
            rows = torch.stack([adm.row_dev for adm in group])
            if self._spec_on:
                for i, adm in enumerate(group):
                    c["hist"][adm.slot, adm.t0:adm.t0 + clens[i]] = \
                        toks_dev[i, :clens[i]]
            logits = self._chunk_batch_fn(
                self._serving, self._cache, rows, toks_dev,
                self._h2d(np.array([a.t0 for a in group], np.int64)),
                self._h2d(np.array(clens, np.int64)))
            firsts = {}
            for i, adm in enumerate(group):
                if finals[i]:
                    firsts[i] = self._arm(adm.slot, adm.req, logits[i:i + 1])
                else:
                    c["active"][adm.slot] = False
        _mx.inc("serving.engine.prefill_chunks", b)
        _mx.observe("serving.engine.admit_batch", b)
        for i, adm in enumerate(group):
            if finals[i]:
                self._register_prefix(adm)
                pending.append(("admit", adm.slot, self._d2h(firsts[i])))
            else:
                adm.t0 += clens[i]
                self._admissions.append(adm)

    def _register_prefix(self, adm: _Admission) -> None:
        """Publish the request's full prompt pages AT ADMISSION, so a
        concurrent identical prompt hits while this one still decodes.
        A page whose key is already resident stays private, and so do all
        pages of an admission that began before an adapter swap (their K/V
        mix the two versions)."""
        if not self._prefix_on or adm.version != self._version:
            return
        st = self._slots[adm.slot]
        if st is None:   # raced a crash/stop reset
            return
        full = len(adm.req.tokens) // self._page_size
        for i in range(adm.hit_pages, full):
            if adm.keys[i] in self._prefix:
                continue
            page = int(adm.row[i])
            parent = adm.keys[i - 1] if i else None
            ent = _PrefixEntry(page, parent, self._next_tick())
            self._prefix[adm.keys[i]] = ent
            if parent is not None and parent in self._prefix:
                self._prefix[parent].kids += 1
            st.entries.append(ent)
            st.private.remove(page)

    # -------------------------------------------------------------- draining
    @staticmethod
    def _wait(*copies):
        """The host arrays of queued device-to-host copies, once landed."""
        for _host, ev in copies:
            if ev is not None:
                ev.synchronize()
        return [host.numpy() for host, _ev in copies]

    def _drain(self, frame: tuple) -> None:
        """Wait for one frame's host copy and route its tokens: the only
        host/device synchronisation point; the span measures the wait."""
        kind = frame[0]
        with recorder.span("serving.engine.fetch", kind=kind):
            if kind == "admit":
                (host,) = self._wait(frame[2])
            else:
                toks, second = self._wait(frame[1], frame[2])
        if kind == "admit":
            self._deliver(frame[1], int(host[0]), first=True)
        elif kind == "spec":
            # a window's yield: toks [S, C] target picks, second [S]
            # accepted lengths (0 = the slot was inert)
            live = second > 0
            if live.any():
                # every live slot consumed spec_k drafts and banked
                # count - 1 beyond the guaranteed token
                _mx.inc("serving.spec.proposed",
                        int(live.sum()) * (toks.shape[1] - 1))
                _mx.inc("serving.spec.accepted",
                        int((second[live] - 1).sum()))
            for slot in np.nonzero(live)[0]:
                for t in toks[slot, :second[slot]]:
                    self._deliver(int(slot), int(t), first=False)
        else:
            for slot in np.nonzero(second)[0]:
                self._deliver(int(slot), int(toks[slot]), first=False)
        _mx.set_gauge("serving.slots_active",
                      sum(s is not None for s in self._slots))

    def _deliver(self, slot: int, tok: int, first: bool) -> None:
        st = self._slots[slot]
        if st is None:
            # host and device retirement diverged: loud beats wrong
            log.warning("engine: token for free slot %d dropped", slot)
            return
        st.out.append(tok)
        _mx.inc("serving.tokens_total")
        now = time.perf_counter()
        if first:
            st.t_first = now
            st.req.ticket.t_first = now
            _mx.observe("serving.ttft", now - st.req.ticket.t_submit)
        st.req.ticket._push(tok)
        if tok == self._eos or len(st.out) >= st.req.max_new:
            if len(st.out) > 1 and st.t_first is not None:
                _mx.observe("serving.tbt",
                            (now - st.t_first) / (len(st.out) - 1))
            st.req.ticket.t_done = now
            # release BEFORE the done event, so a waiter returning from
            # result() sees the pool already reclaimed
            if self._paged:
                self._release_slot_pages(st)
            st.req.ticket._finish()
            with self._cond:
                self._slots[slot] = None
                if not self._stopping:
                    self._free.append(slot)
                self._cond.notify_all()
            _mx.inc("serving.engine.completions")

    def _fail_outstanding(self, err: BaseException) -> None:
        with self._cond:
            reqs = list(self._waiting)
            self._waiting.clear()
            slots = [s for s in self._slots if s is not None]
            self._slots = [None] * self.n_slots
            self._free = list(range(self.n_slots))
            swap, self._pending_swap = self._pending_swap, None
        if swap is not None:
            # release the waiting swapper with the failure, not a timeout
            swap.error = err
            swap.applied.set()
        if self._paged:
            # the device cache is garbage after a crash: every page and
            # every cached prefix goes with it
            self._admissions.clear()
            self._free_pages = list(range(1, self._n_pages))
            self._prefix.clear()
            _mx.set_gauge("serving.kv_pages_free", len(self._free_pages))
        _mx.set_gauge("serving.engine.queue", 0)
        _mx.set_gauge("serving.slots_active", 0)
        for r in reqs:
            r.ticket._finish(err)
        for s in slots:
            s.req.ticket._finish(err)
