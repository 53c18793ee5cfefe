"""KV-cache decoding for the LLaMA-shaped LM (port of
`fedml_tpu/llm/decode.py`).

Two cache layouts:

- CONTIGUOUS (`make_kv_decode`): `{"k", "v": [L, B, max_len, H, Dh]}`, one
  row of `max_len` positions per sequence. `prefill` runs the prompt once
  and emits every layer's roped K and raw V; `step` decodes one token per
  row at per-row positions. `make_generate` is the per-request path built
  on it: prefill once, then KV-cached steps.
- PAGED (`make_paged_kv_decode`): K/V live in a POOL of fixed-size pages
  `[L, n_pages, page_size, H, Dh]`; each slot's logical sequence is an
  int32 page-table row mapping virtual position
  `t -> (row[t // page_size], t % page_size)`. Page 0 is the null/trash
  page by contract: never allocated to a request, it absorbs padded-
  position and inactive-slot writes, and reads of it only ever land at
  virtual positions past a slot's `pos`, which the live mask discards.

Unlike the JAX package, which threads the cache through donated jit
calls, the port updates a cache IN PLACE (`index_put_` / `index_reduce_`
on each layer's view of the persistent tensors): the cache dict passed in
is the cache that comes out.

LoRA adapters are not an argument here, unlike the JAX functions, which
merge them into every adapted kernel inside their jit on every call: the
callers (the serving engine and predictor) merge an adapter set once
(`serving.engine.merged_model`, the arithmetic of `llm.quant.merged_kernel`)
and call these functions on the merged model. The model may hold an int8
base (`llm/quant.py`): each step dequantises its int8 weights to the
compute dtype at use, as the JAX functions do inside their jit.

Over a tensor-parallel mesh (`llm/tp.py`) the model is the rank's shard
(`TransformerLM(tp=...)`), `n_heads` its own heads and the cache its own
contiguous tensors at those heads: `[L, B, max_len, H/tp, Dh]`, or a pool
`[L, P, ps, H/tp, Dh]` with int8 scales `[L, P, H/tp]` (the JAX package's
`kv_cache_spec` / `paged_kv_cache_spec` / `paged_kv_scale_spec` blocks).
The page table and the positions are the same on every rank, and with
`kernel` K4 runs on each rank over its own heads (the JAX package's
`shard_map` over `mp`). The block helpers (`llm/quant.py`) add the one
all-reduce after wo and after w_down and the embedding and LM-head
gathers.

Sampling draws from a `torch.Generator` seeded from (request seed,
position) through `draw_seed`; the JAX package folds the position into a
`jax.random` key. Both are deterministic per (seed, position); the bits
differ.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops import cost
from .quant import (
    attn_out, embed_rows, lm_head_logits, project_qkv, rms_norm,
    swiglu_mlp,
)
from .transformer import dense_causal_attention, rope

_NEG = -1e9   # the gather path's mask value (fedml_tpu/parallel/seq.py)


def draw_seed(seed: int, position: int) -> int:
    """Generator seed for the draw at `position` of a request seeded `seed`:
    splitmix64 of (seed, position), so every bit of both reaches the low
    32 bits (the CPU generator reads only those)."""
    mask = (1 << 64) - 1
    z = (((seed & 0xFFFFFFFF) << 32 | (position & 0xFFFFFFFF))
         + 0x9E3779B97F4A7C15) & mask
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
    return z ^ (z >> 31)


def gumbel_pick(logits: torch.Tensor, temperature: float,
                gen: torch.Generator, top_k: int = 0) -> torch.Tensor:
    """One categorical draw per row of `logits` [..., V] from
    softmax(logits / temperature), by the Gumbel-max rule with uniforms
    from `gen`; `top_k` > 0 keeps only the k largest logits (ties at the
    k-th kept), as the JAX sampler's static cutoff."""
    lg = logits.float() / max(float(temperature), 1e-6)
    if top_k:
        kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
        lg = torch.where(lg < kth, float("-inf"), lg)
    u = torch.rand(lg.shape, generator=gen, device=lg.device)
    return torch.argmax(lg - torch.log(-torch.log(u)), dim=-1)


def _rope_rows(x: torch.Tensor, pos_rows: torch.Tensor,
               base: float = 10000.0) -> torch.Tensor:
    """`transformer.rope` with PER-ROW positions: x [B, T, H, D], pos_rows
    [B, T]. Rotates halves; angles in f32."""
    half = x.shape[-1] // 2
    freqs = base ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = pos_rows.to(torch.float32)[..., None] * freqs     # [B, T, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _kv_quant_write(pool: torch.Tensor, scales: torch.Tensor,
                    wpage: torch.Tensor, woff: torch.Tensor,
                    vals: torch.Tensor) -> None:
    """Quantize-at-write into an int8 page pool, IN PLACE. pool [P, ps, H,
    Dh] int8, scales [P, H] f32, wpage/woff [...] page/offset indices,
    vals [..., H, Dh] new K or V rows in the compute dtype.

    The four scatters of the JAX version, in its order (its docstring has
    the full argument): 0. a write at offset 0 begins a page, so the
    previous tenant's scale is reset to 0 first (scatter-min); 1. each
    touched page's scale grows to cover the new rows' |max| / 127
    (scatter-max, duplicates fold); 2. the resident rows of every touched
    page are requantized by s_old / s_new (exactly 1.0 when the scale did
    not grow, so round() is the identity; duplicate pages write identical
    bytes); 3. the new rows are quantized with the grown scale at their
    (page, offset) cells. Both divisions stay divisions, and torch.round
    rounds half to even like jnp.round, so the pool matches the JAX
    package bit for bit."""
    h = scales.shape[1]
    f = vals.float()
    cand = f.abs().amax(-1) / 127.0                               # [..., H]
    fresh = torch.where((woff == 0)[..., None], 0.0, float("inf")
                        ).expand(cand.shape)
    idx = wpage.reshape(-1).long()
    scales.index_reduce_(0, idx, fresh.reshape(-1, h), "amin",
                         include_self=True)
    so = scales[idx]                                              # [n, H]
    scales.index_reduce_(0, idx, cand.reshape(-1, h), "amax",
                         include_self=True)
    sn = scales[idx]
    snd = torch.where(sn > 0, sn, 1.0)
    factor = torch.where(sn > 0, so / snd, 1.0)
    resident = pool[idx].float()                                  # [n,ps,H,Dh]
    pool[idx] = torch.clamp(torch.round(resident * factor[:, None, :, None]),
                            -127, 127).to(torch.int8)
    q = torch.clamp(torch.round(f.reshape(-1, h, f.shape[-1])
                                / snd[..., None]), -127, 127).to(torch.int8)
    pool.index_put_((idx, woff.reshape(-1).long()), q)


def make_kv_decode(n_heads: int, dtype=torch.float32, eps: float = 1e-6,
                   prefill_attn_fn=None):
    """Returns (prefill, step) over a `TransformerLM` and a CONTIGUOUS
    cache {"k", "v": [L, B, max_len, H, Dh]}:

    prefill(model, tokens, max_len, length=None, cache=None, rows=None) -> (cache, logits [B, V])
        one forward over tokens [B, T] (right-padded past each row's
        `length`, a scalar or [B]; None means T) that writes each layer's
        roped K and raw V at positions 0 .. T - 1 and reads the logits at
        each row's last real position. A new zeroed cache is made unless
        `cache` is given, in which case the rows land in `cache` at batch
        rows `rows` (an int or a list) and `cache` is returned.
    step(model, cache, pos, token) -> logits [B, V]
        token [B] at per-row positions `pos` ([B] or a scalar): each layer
        writes its K/V at pos (in place) and attends positions <= pos.

    `prefill_attn_fn` ([B, T, H, Dh] q/k/v -> o) swaps the prompt pass's
    attention (default dense causal); `ops.flash_attention.flash_attn_fn`
    runs the flash kernels (K1) there. The steps are unaffected."""
    attn = prefill_attn_fn or dense_causal_attention

    def prefill(model, tokens, max_len: int, length=None, cache=None,
                rows=None):
        b, t = tokens.shape
        dev = tokens.device
        x = embed_rows(model.embed.embedding, tokens, dtype,
                       model.tp)                                  # [B, T, D]
        pos = torch.arange(t, device=dev)
        dh = model.head_dim
        if cache is None:
            z = (model.n_layers, b, max_len, n_heads, dh)
            cache = {"k": torch.zeros(z, dtype=dtype, device=dev),
                     "v": torch.zeros(z, dtype=dtype, device=dev)}
            rows = slice(None)
        elif isinstance(rows, int):
            rows = [rows]
        for i, bl in enumerate(model.blocks):
            h = rms_norm(x, bl.RMSNorm_0.scale.to(dtype), eps)
            q, k, v = project_qkv(bl, None, 0.0, h, n_heads, dtype)
            q, k = rope(q, pos), rope(k, pos)
            cache["k"][i, rows, :t] = k
            cache["v"][i, rows, :t] = v
            o = attn(q, k, v)
            x = attn_out(bl, None, 0.0, x, o, dtype)
            x = swiglu_mlp(bl, None, 0.0, x, dtype, eps)
        if length is None:
            last = x[:, -1]
        else:
            lengths = torch.as_tensor(length, device=dev).long().expand(b)
            last = x[torch.arange(b, device=dev), lengths - 1]
        logits = lm_head_logits(model, None, 0.0, last[:, None], dtype, eps)
        return cache, logits[:, 0]

    def step(model, cache, pos, token):
        b = token.shape[0]
        dev = token.device
        x = embed_rows(model.embed.embedding, token, dtype,
                       model.tp)[:, None]                         # [B,1,D]
        max_len = cache["k"].shape[2]
        pos = torch.as_tensor(pos, device=dev).long().expand(b)
        bidx = torch.arange(b, device=dev)
        live = (torch.arange(max_len, device=dev)[None, :]
                <= pos[:, None])                                  # [B, T]
        for i, bl in enumerate(model.blocks):
            ck, cv = cache["k"][i], cache["v"][i]                 # [B,T,H,Dh]
            h = rms_norm(x, bl.RMSNorm_0.scale.to(dtype), eps)
            q, k, v = project_qkv(bl, None, 0.0, h, n_heads, dtype)
            q = _rope_rows(q, pos[:, None])
            k = _rope_rows(k, pos[:, None])
            ck[bidx, pos] = k[:, 0]
            cv[bidx, pos] = v[:, 0]
            # a ledger capture counts it as K4 over pages of one position
            with cost.region(lambda: cost.paged_cost(
                    q, pos, 1, max_len, ck.element_size(), False)):
                scale = q.shape[-1] ** -0.5
                s = torch.einsum("bqhd,bkhd->bhqk", q, ck) * scale
                s = torch.where(live[:, None, None, :], s, _NEG)
                o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1),
                                 cv)
            x = attn_out(bl, None, 0.0, x, o, dtype)
            x = swiglu_mlp(bl, None, 0.0, x, dtype, eps)
        return lm_head_logits(model, None, 0.0, x, dtype, eps)[:, 0]

    return prefill, step


def make_paged_kv_decode(n_heads: int, page_size: int,
                         dtype=torch.float32, eps: float = 1e-6,
                         kernel: bool = False, quant: bool = False):
    """Returns (chunk, step, verify, chunk_batch) over a `TransformerLM`
    and a paged cache dict {"k", "v": [L, P, page_size, H, Dh]} (+ {"ks",
    "vs": [L, P, H] f32} when `quant`, the pool then int8):

    chunk(model, cache, pages_row, tokens, t0, length) -> logits [1, V]
        ONE slot's prefill chunk: tokens [1, C] (right-padded past
        `length`) at positions t0 .. t0 + length - 1 are written into the
        slot's pages (padded positions go to the null page) and attend the
        gathered history plus themselves; logits at position
        t0 + length - 1. Always the gather path, as in the JAX package.
    step(model, cache, pages, pos, token, active) -> logits [S, V]
        every slot one token (verify at C == 1).
    verify(model, cache, pages, pos, tokens, active) -> logits [S, C, V]
        every slot, C tokens at positions pos .. pos + C - 1. Writes land
        BEFORE attention, so query i attends this call's own rows up to
        pos + i; inactive slots' writes, and writes past a slot's
        page-table reservation, go to the null page. With `kernel` the
        attention is `ops.paged_attention.paged_attention` (pages read in
        place); otherwise each slot's pages are gathered into a contiguous
        [max_pages * page_size] view and attended densely.
    chunk_batch(model, cache, pages, tokens, t0, lengths) -> logits [B, V]
        B slots' prefill chunks through ONE forward (batched admission):
        pages [B, max_pages], tokens [B, C] right-padded per row, t0 and
        lengths [B]; logits at each row's t0 + length - 1, exactly chunk's.
        Tokens past a row's length go to the null page (a row of length 0
        writes nothing). The gather path, like chunk.
    """
    ps = int(page_size)
    if kernel:
        from ..ops.paged_attention import paged_attention

    def dq_pages(pool, scales, idx):
        """Gather pages + dequant: scales[idx] [..., H] broadcast over the
        (page_size, Dh) axes of pool[idx]."""
        return (pool[idx].float()
                * scales[idx][..., None, :, None]).to(dtype)

    def layer_cache(cache, i):
        return (cache["k"][i], cache["v"][i],
                cache["ks"][i] if quant else None,
                cache["vs"][i] if quant else None)

    def write(ck, cv, ks, vs, wpage, woff, k, v):
        wpage, woff = wpage.long(), woff.long()
        if quant:
            _kv_quant_write(ck, ks, wpage, woff, k)
            _kv_quant_write(cv, vs, wpage, woff, v)
        else:
            ck.index_put_((wpage, woff), k)
            cv.index_put_((wpage, woff), v)

    def gather_attend(q, ck, cv, ks, vs, pages, posr):
        """Each row's pages gathered into a contiguous view, attended
        densely with query i live at virtual positions <= posr[:, i]. A
        ledger capture counts it as K4's work (`ops/cost.py`)."""
        with cost.region(lambda: cost.paged_cost(
                q, posr[:, 0], ps, pages.shape[1], ck.element_size(),
                quant)):
            return _gather_attend(q, ck, cv, ks, vs, pages, posr)

    def _gather_attend(q, ck, cv, ks, vs, pages, posr):
        b = q.shape[0]
        n_virt = pages.shape[1] * ps
        idx = pages.long()
        if quant:
            kk, vv = dq_pages(ck, ks, idx), dq_pages(cv, vs, idx)
        else:
            kk, vv = ck[idx], cv[idx]
        kk = kk.reshape((b, n_virt) + ck.shape[2:])
        vv = vv.reshape((b, n_virt) + cv.shape[2:])
        live = (torch.arange(n_virt, device=q.device)[None, None, :]
                <= posr[:, :, None])                              # [B, C, T]
        s = torch.einsum("bqhd,bkhd->bhqk", q, kk) * q.shape[-1] ** -0.5
        s = torch.where(live[:, None], s, _NEG)
        return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vv)

    def forward(model, cache, tokens, posr, wpage, woff, attend):
        """The layer stack over tokens [B, C] at positions posr [B, C]:
        each layer writes its K/V at (wpage, woff), then `attend`s; returns
        the final hidden [B, C, D]."""
        x = embed_rows(model.embed.embedding, tokens, dtype,
                       model.tp)                                  # [B, C, D]
        for i, bl in enumerate(model.blocks):
            ck, cv, ks, vs = layer_cache(cache, i)
            h = rms_norm(x, bl.RMSNorm_0.scale.to(dtype), eps)
            q, k, v = project_qkv(bl, None, 0.0, h, n_heads, dtype)
            q = _rope_rows(q, posr)
            k = _rope_rows(k, posr)
            write(ck, cv, ks, vs, wpage, woff, k, v)
            o = attend(q, ck, cv, ks, vs)
            x = attn_out(bl, None, 0.0, x, o, dtype)
            x = swiglu_mlp(bl, None, 0.0, x, dtype, eps)
        return x

    def chunk_batch(model, cache, pages, tokens, t0, lengths):
        b, c = tokens.shape
        dev = tokens.device
        j = torch.arange(c, device=dev)
        t0 = torch.as_tensor(t0, device=dev).long().expand(b)
        lengths = torch.as_tensor(lengths, device=dev).long().expand(b)
        posr = t0[:, None] + j[None, :]                           # [B, C]
        max_pages = pages.shape[1]
        rowidx = posr // ps
        # tokens past a row's length go to the null page; the row index is
        # clamped like XLA's gather clamps it
        wpage = torch.where(
            (j[None, :] < lengths[:, None]) & (rowidx < max_pages),
            torch.gather(pages.long(), 1, rowidx.clamp(max=max_pages - 1)),
            0)
        woff = posr % ps
        x = forward(
            model, cache, tokens, posr, wpage, woff,
            lambda q, ck, cv, ks, vs: gather_attend(q, ck, cv, ks, vs,
                                                    pages, posr))
        # each row's last real position (a length-0 row reads position 0,
        # garbage its caller discards)
        last = x[torch.arange(b, device=dev), lengths.clamp(min=1) - 1]
        return lm_head_logits(model, None, 0.0, last[:, None], dtype,
                              eps)[:, 0]

    def chunk(model, cache, pages_row, tokens, t0: int, length: int):
        return chunk_batch(model, cache, pages_row[None], tokens, t0, length)

    def verify(model, cache, pages, pos, tokens, active):
        s_, c = tokens.shape
        dev = tokens.device
        posr = pos[:, None] + torch.arange(c, device=dev, dtype=pos.dtype)
        max_pages = pages.shape[1]
        rowidx = posr // ps
        # positions past the reservation and inactive slots' writes go to
        # the null page: a clamped row read could alias a REAL page
        wpage = torch.where(
            active[:, None] & (rowidx < max_pages),
            torch.gather(pages, 1,
                         torch.clamp(rowidx, max=max_pages - 1).long()), 0)
        woff = posr % ps
        if kernel:
            # pages read in place; an int8 pool goes in as-is and the
            # kernel dequantizes each slab
            def attend(q, ck, cv, ks, vs):
                return paged_attention(q, ck, cv, pages, pos, ks, vs)
        else:
            def attend(q, ck, cv, ks, vs):
                return gather_attend(q, ck, cv, ks, vs, pages, posr)
        x = forward(model, cache, tokens, posr, wpage, woff, attend)
        return lm_head_logits(model, None, 0.0, x, dtype, eps)

    def step(model, cache, pages, pos, token, active):
        return verify(model, cache, pages, pos, token[:, None], active)[:, 0]

    return chunk, step, verify, chunk_batch


def new_paged_cache(n_layers: int, n_pages: int, page_size: int,
                    n_heads: int, head_dim: int, dtype, device,
                    quant: bool = False) -> dict[str, torch.Tensor]:
    """A zeroed paged cache in the layout make_paged_kv_decode consumes."""
    z = (n_layers, n_pages, page_size, n_heads, head_dim)
    pool_dtype = torch.int8 if quant else dtype
    cache = {"k": torch.zeros(z, dtype=pool_dtype, device=device),
             "v": torch.zeros(z, dtype=pool_dtype, device=device)}
    if quant:
        zs = (n_layers, n_pages, n_heads)
        cache["ks"] = torch.zeros(zs, dtype=torch.float32, device=device)
        cache["vs"] = torch.zeros(zs, dtype=torch.float32, device=device)
    return cache


def ngram_propose(hist: torch.Tensor, pos: torch.Tensor, k: int,
                  w: int = 2) -> torch.Tensor:
    """Self-drafting n-gram (prompt-lookup) proposer: for each slot, the
    most recent PREVIOUS occurrence of the trailing `w`-gram
    hist[pos - w + 1 .. pos] in that slot's own history, and the `k`
    tokens that followed it. hist [S, T] (hist[s, :pos[s] + 1] the slot's
    true tokens; entries past pos may be stale rejected drafts and are
    never match anchors), pos [S]. Returns [S, k] drafts; a slot with no
    match repeats its last token. Bitwise the JAX function."""
    s_, t = hist.shape
    dev = hist.device
    pos = pos.long()
    idx = torch.arange(t, device=dev)[None, :]                    # [1, T]
    # candidate continuation start j: positions j-w..j-1 hold the same
    # w-gram as positions pos-w+1..pos; j must be a PAST point (<= pos)
    # with a full gram before it (>= w)
    match = (idx >= w) & (idx <= pos[:, None])
    for shift in range(w):
        a = torch.gather(hist, 1,
                         (idx - 1 - shift).clamp(min=0).expand(s_, t))
        b = torch.gather(hist, 1, (pos[:, None] - shift).clamp(min=0))
        match = match & (a == b)
    found = match.any(dim=1)
    # the most recent occurrence wins (largest j)
    j = torch.where(match, idx, 0).amax(dim=1)                    # [S]
    gidx = (j[:, None] + torch.arange(k, device=dev)).clamp(max=t - 1)
    draft = torch.gather(hist, 1, gidx)
    last = torch.gather(hist, 1, pos[:, None])
    return torch.where(found[:, None], draft, last)


def make_generate(n_heads: int, dtype=torch.float32, eps: float = 1e-6,
                  sample: bool = False, top_k: int = 0,
                  prefill_attn_fn=None):
    """generate(model, tokens, max_len, n_steps, length=None, seed=0,
    temperature=1.0) -> [n_steps] tokens for a
    batch-1 prompt, [B, n_steps] for a batch: prefill once, then
    n_steps - 1 KV-cached steps (the JAX function's `lax.scan` as a loop).

    tokens [B, T] may be right-padded with `length` (a scalar or [B]) the
    real prompt lengths; every row decodes n_steps tokens in lockstep.
    sample=False is greedy argmax over f32 logits. sample=True draws from
    softmax(logits / temperature) with an optional `top_k` cutoff; pick i
    draws from a generator seeded by (seed, i) (`draw_seed`), one [B, V]
    field for the batch."""
    prefill, step = make_kv_decode(n_heads, dtype=dtype, eps=eps,
                                   prefill_attn_fn=prefill_attn_fn)

    def generate(model, tokens, max_len: int, n_steps: int, length=None,
                 seed: Optional[int] = 0, temperature: float = 1.0):
        gen = (torch.Generator(device=tokens.device) if sample else None)

        def pick(logits, i):
            if not sample:
                return logits.float().argmax(-1)
            gen.manual_seed(draw_seed(int(seed or 0), i))
            return gumbel_pick(logits, temperature, gen, top_k)

        b, t = tokens.shape
        cache, logits = prefill(model, tokens, max_len, length=length)
        tok = pick(logits, 0)
        out = [tok]
        pos0 = torch.as_tensor(t if length is None else length,
                               device=tokens.device).long().expand(b)
        # n_steps - 1 steps: token 1 comes from the prefill, and the last
        # emitted token needs no further step
        for i in range(n_steps - 1):
            logits = step(model, cache, pos0 + i, tok)
            tok = pick(logits, i + 1)
            out.append(tok)
        toks = torch.stack(out)                                   # [n, B]
        return toks[:, 0] if b == 1 else toks.T

    return generate


def make_greedy_generate(n_heads: int, dtype=torch.float32,
                         eps: float = 1e-6):
    """Greedy `make_generate`, the name the predictor and tests use."""
    return make_generate(n_heads, dtype=dtype, eps=eps, sample=False)
