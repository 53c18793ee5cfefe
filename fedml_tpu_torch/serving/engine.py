"""Continuous-batching paged decode engine (port of the paged mode of
`fedml_tpu/serving/engine.py`).

- The engine owns S decode SLOTS over one persistent paged KV pool
  `[L, n_pages, page_size, H, Dh]` (page 0 is the reserved null page) and
  an int32 `[S, max_pages]` page table on the device. Every engine
  iteration advances all slots one token through ONE forward
  (`llm/decode.py` step) with per-slot positions and an active mask; with
  `paged_kernel=True` its attention is the hand-written CUDA kernel
  (`ops/paged_attention.py`), which reads each slot's pages in place.
- Admission reserves ceil((prompt + max_new) / page_size) pages up front
  (host free list), then prefills the prompt in `prefill_chunk`-sized
  chunks, ONE chunk per iteration round-robin across admissions, so a long
  prompt never stalls the decoding slots for its whole prefill.
- PREFIX CACHE: full prompt pages are registered under a chained
  blake2b hash of their token ids; a later prompt with the same prefix
  reuses those pages (ref-counted, LRU-evicted leaf-first under pressure)
  and starts its prefill after the hit.
- Retirement is decided ON THE DEVICE (token budget or eos); the host
  learns it from the token frames it fetches. Frames are fetched
  `fetch_chunk` at a time: their device-to-host copies are queued when
  the step is dispatched and waited on in `_drain`, so the host's
  bookkeeping overlaps the device's next steps and no step synchronises.
- Greedy picks are argmax over f32 logits. Temperature sampling draws
  from a per-slot `torch.Generator` seeded from (request seed, position),
  the port's counterpart of the JAX engine's fold_in(key(seed), pos + 1)
  schedule: deterministic per (seed, position), not the same bits.

Capacity contract per request: prompt + max_new_tokens <= max_len AND
ceil((prompt + max_new_tokens) / page_size) <= n_pages - 1.

Not ported yet (each refused with NotImplementedError naming its ROADMAP
item): the contiguous layout (page_size=0), speculative decoding,
batched admission (admit_batch > 1), tensor-parallel meshes, LoRA
adapters and hot swap.
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
from ..llm.decode import make_paged_kv_decode, new_paged_cache
from ..utils import metrics as _mx
from ..utils.events import recorder
from .predictor import InvalidRequest

log = logging.getLogger(__name__)

_LATER = "not ported yet (ROADMAP.md, 'Port queue', item {}: {})"


def _page_key(parent: bytes, tokens) -> bytes:
    """Chain hash for one prefix page over its token ids (int32 bytes) and
    the parent page's key: identical to the JAX engine's, so the gateway's
    prefix-affinity digests agree across the two."""
    h = hashlib.blake2b(parent, digest_size=16)
    h.update(np.asarray(tokens, np.int32).tobytes())
    return h.digest()


def _draw_seed(seed: int, position: int) -> int:
    """Generator seed for the draw at `position` of a request seeded `seed`:
    splitmix64 of (seed, position), so every bit of both reaches the low
    32 bits (the CPU generator reads only those)."""
    mask = (1 << 64) - 1
    z = (((seed & 0xFFFFFFFF) << 32 | (position & 0xFFFFFFFF))
         + 0x9E3779B97F4A7C15) & mask
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
    return z ^ (z >> 31)


class _PrefixEntry:
    """One resident prefix page: refs counts slots decoding over it, kids
    its resident chain extensions; evictable only at refs == kids == 0."""

    __slots__ = ("page", "parent", "refs", "kids", "tick")

    def __init__(self, page: int, parent: Optional[bytes], tick: int):
        self.page = page
        self.parent = parent
        self.refs = 1
        self.kids = 0
        self.tick = tick


class _Admission:
    """One in-flight chunked admission: `row` is the slot's page-table row
    (prefix-hit pages then fresh ones), `t0` the next prompt position to
    prefill, `keys` the chain hashes of every full prompt page."""

    __slots__ = ("req", "slot", "row", "row_dev", "t0", "keys", "hit_pages")

    def __init__(self, req, slot, row, t0, keys, hit_pages):
        self.req = req
        self.slot = slot
        self.row = row
        self.row_dev = None
        self.t0 = t0
        self.keys = keys
        self.hit_pages = hit_pages


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
    """S-slot continuous-batching decoder over a paged KV pool.

    `model` is an `llm.transformer.TransformerLM` already on `device`
    (CUDA unless the caller passes device="cpu"; with no GPU and no
    device= the constructor raises). `page_size` > 0 is required; `n_pages`
    sizes the pool (default: n_slots * ceil(max_len / page_size) + the
    null page), `prefill_chunk` bounds one admission chunk (0 = the whole
    prompt), `prefix_cache` toggles prefix page reuse, `paged_kernel`
    routes decode attention through the CUDA kernel, and `kv_quant="int8"`
    stores the pool in int8 with per-(page, head) f32 scales. `dtype` is
    the compute and KV dtype (default: the model's). `eos_id=None`
    disables eos retirement."""

    def __init__(self, model, adapters=None, *, n_slots: int = 4,
                 max_len: int = 256, eos_id: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None, fetch_chunk: int = 2,
                 page_size: int = 0, n_pages: Optional[int] = None,
                 prefill_chunk: int = 0, prefix_cache: bool = True,
                 paged_kernel: bool = False, spec_decode: str = "off",
                 kv_quant: str = "off", admit_batch: int = 1, mesh=None,
                 device=None):
        self.device = resolve_device(device)
        if int(page_size or 0) <= 0:
            raise NotImplementedError(
                "the contiguous KV layout (page_size=0) is "
                + _LATER.format(2, "contiguous mode") + "; pass page_size > 0")
        if spec_decode != "off":
            raise NotImplementedError(
                f"spec_decode={spec_decode!r}: speculative decoding is "
                + _LATER.format(2, "spec_decode"))
        if int(admit_batch) != 1:
            raise NotImplementedError(
                f"admit_batch={admit_batch}: batched admission is "
                + _LATER.format(2, "admit_batch"))
        if mesh is not None:
            raise NotImplementedError(
                "a tensor-parallel mesh is " + _LATER.format(4, "multi-GPU"))
        if adapters is not None:
            raise NotImplementedError(
                "LoRA adapters are " + _LATER.format(2, "adapters and hot swap"))
        if kv_quant not in ("off", "int8"):
            raise ValueError(f"kv_quant must be 'off' or 'int8'; got "
                             f"{kv_quant!r}")
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1; got {n_slots}")
        if int(prefill_chunk) < 0:
            raise ValueError(f"prefill_chunk must be >= 0 (0 = whole-prompt "
                             f"chunks); got {prefill_chunk}")
        if model.device != self.device:
            raise ValueError(f"the model's weights are on {model.device}, "
                             f"the engine runs on {self.device}")
        self.model = model
        self.n_slots = S = int(n_slots)
        self.max_len = int(max_len)
        self.fetch_chunk = max(1, int(fetch_chunk))
        self._page_size = int(page_size)
        self._max_pages = -(-self.max_len // self._page_size)
        self._n_pages = (int(n_pages) if n_pages
                         else S * self._max_pages + 1)
        if self._n_pages < 2:
            raise ValueError(f"n_pages must be >= 2 (page 0 is the reserved "
                             f"null page); got {self._n_pages}")
        self._usable = self._n_pages - 1
        self._prefill_chunk = int(prefill_chunk)
        self._prefix_on = bool(prefix_cache)
        self._free_pages: list[int] = list(range(1, self._n_pages))
        self._prefix: dict[bytes, _PrefixEntry] = {}
        self._ticks = 0
        _mx.set_gauge("serving.kv_pages_budget", self._usable)
        _mx.set_gauge("serving.kv_pages_free", len(self._free_pages))
        self._kernel_on = bool(paged_kernel)
        self._quant = kv_quant == "int8"
        self._eos = -1 if eos_id is None else int(eos_id)  # -1 never matches
        self.dtype = dtype or model.dtype
        self._chunk_fn, self._step_fn, _verify = make_paged_kv_decode(
            model.n_heads, self._page_size, dtype=self.dtype,
            kernel=self._kernel_on, quant=self._quant)
        self._cache = new_paged_cache(
            model.n_layers, self._n_pages, self._page_size, model.n_heads,
            model.d_model // model.n_heads, self.dtype, self.device,
            quant=self._quant)
        kv_bytes = sum(t.numel() * t.element_size()
                       for t in self._cache.values())
        _mx.set_gauge("serving.kv_bytes_per_slot", kv_bytes // S)
        dev = self.device
        self._carry = {
            "pages": torch.zeros((S, self._max_pages), dtype=torch.int32,
                                 device=dev),
            "pos": torch.zeros((S,), dtype=torch.int32, device=dev),
            "tok": torch.zeros((S,), dtype=torch.int64, device=dev),
            "active": torch.zeros((S,), dtype=torch.bool, device=dev),
            "limit": torch.zeros((S,), dtype=torch.int32, device=dev),
        }
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

    def swap_adapters(self, adapters, version: Optional[int] = None,
                      timeout: float = 60.0) -> int:
        raise NotImplementedError(
            "hot adapter swap is " + _LATER.format(2, "adapters and hot swap"))

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
        """THE capacity oracle: prompt + max_new <= max_len and its pages
        fit the usable pool."""
        total = int(prompt_len) + int(max_new)
        if total > self.max_len:
            return False
        return -(-total // self._page_size) <= self._usable

    def capacity_error(self, prompt_len: int, max_new: int) -> str:
        tot = prompt_len + max_new
        need = -(-tot // self._page_size)
        return (f"prompt {prompt_len} + max_new_tokens {max_new} = {tot} "
                f"tokens needs ceil({tot}/{self._page_size}) = {need} KV "
                f"pages, but the engine budget is {self._usable} usable "
                f"pages (n_pages {self._n_pages} minus the reserved null "
                f"page) with per-request cap max_len {self.max_len} (paged "
                "capacity contract: prompt + max_new_tokens <= max_len AND "
                "ceil((prompt + max_new_tokens) / page_size) <= n_pages - 1)")

    def prefix_digests(self, limit: int = 64) -> list:
        """Hex digests of resident FIRST-page prefix keys (the residency
        hint replicas advertise for prefix-affinity routing)."""
        if not self._prefix_on:
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
            g.manual_seed(_draw_seed(self._seed[slot], position))
            lg = logits[row].float() / max(self._temp[slot], 1e-6)
            u = torch.rand(lg.shape, generator=g, device=lg.device)
            out[row] = torch.argmax(lg - torch.log(-torch.log(u)))
        return out

    def _admit(self, adm: _Admission, clen: int, final: bool):
        """ONE prefill chunk of one admission. On the final chunk the first
        token is picked and the slot's rows arm; returns the first-token
        tensor [1], or None for a non-final chunk."""
        c, slot, req = self._carry, adm.slot, adm.req
        if adm.row_dev is None:
            adm.row_dev = self._h2d(adm.row)
            c["pages"][slot] = adm.row_dev
        toks = np.asarray(req.tokens[adm.t0:adm.t0 + clen], np.int64)[None]
        logits = self._chunk_fn(self.model, self._cache, adm.row_dev,
                                self._h2d(toks), adm.t0, clen)
        if not final:
            c["active"][slot] = False
            return None
        plen = len(req.tokens)
        limit = plen + req.max_new - 1
        self._temp[slot], self._seed[slot] = req.temperature, req.seed
        self._host_pos[slot] = plen
        draws = [(0, slot, plen)] if req.temperature > 0 else []
        first = self._pick(logits, draws)
        c["pos"][slot] = plen
        c["tok"][slot] = first[0]
        # active iff the first token did not end it and budget remains
        c["active"][slot] = (first[0] != self._eos) & (plen < limit)
        c["limit"][slot] = limit
        return first

    def _step_all(self, stepping: list[int]):
        """Advance every slot one token; retirement (budget, eos) decided
        on the device. Returns (tokens [S], the entry active mask [S])."""
        c = self._carry
        logits = self._step_fn(self.model, self._cache, c["pages"], c["pos"],
                               c["tok"], c["active"])
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

    # ------------------------------------------------------------ engine loop
    def _loop(self) -> None:
        # frames: ("admit", slot, host_copy) | ("step", toks_copy, mask_copy)
        pending: deque[tuple] = deque()
        try:
            with torch.no_grad():
                while True:
                    with self._cond:
                        if self._stopping:
                            break
                        idle = (not self._waiting and not pending
                                and all(s is None for s in self._slots))
                        if idle:
                            self._cond.wait(0.2)
                            continue
                    self._advance_admissions(pending)
                    # step when any occupied slot is past admission (a slot
                    # mid-prefill is inert on the device)
                    admitting = {a.slot for a in self._admissions}
                    stepping = [i for i, s in enumerate(self._slots)
                                if s is not None and i not in admitting]
                    if stepping:
                        toks, mask = self._step_all(stepping)
                        self.decode_steps += 1
                        pending.append(("step", self._d2h(toks),
                                        self._d2h(mask)))
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
        evictable) and return its private pages to the free list."""
        for e in st.entries:
            e.refs -= 1
        self._free_pages.extend(st.private)
        st.entries, st.private = [], []
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
                req, slot, row, len(hits) * ps, keys, len(hits)))
            _mx.inc("serving.engine.admissions")

    def _advance_admissions(self, pending: deque) -> None:
        """ONE prefill chunk per iteration, round-robin across admissions:
        `prefill_chunk`-sized chunks, then the remainder."""
        self._start_admissions()
        if not self._admissions:
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

    def _register_prefix(self, adm: _Admission) -> None:
        """Publish the request's full prompt pages AT ADMISSION, so a
        concurrent identical prompt hits while this one still decodes.
        A page whose key is already resident stays private."""
        if not self._prefix_on:
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
    def _drain(self, frame: tuple) -> None:
        """Wait for one frame's host copy and route its tokens: the only
        host/device synchronisation point; the span measures the wait."""
        if frame[0] == "admit":
            _kind, slot, (host, ev) = frame
            with recorder.span("serving.engine.fetch", kind="admit"):
                if ev is not None:
                    ev.synchronize()
                tok = int(host[0])
            self._deliver(slot, tok, first=True)
        else:
            _kind, (toks, ev_t), (mask, ev_m) = frame
            with recorder.span("serving.engine.fetch", kind="step"):
                for ev in (ev_t, ev_m):
                    if ev is not None:
                        ev.synchronize()
                toks, mask = toks.numpy(), mask.numpy()
            for slot in np.nonzero(mask)[0]:
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
        # the device cache is garbage after a crash: every page and every
        # cached prefix goes with it
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
