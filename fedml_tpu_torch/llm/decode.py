"""Paged KV-cache decoding: the paged half of `fedml_tpu/llm/decode.py`.

K/V live in a POOL of fixed-size pages `[L, n_pages, page_size, H, Dh]`;
each slot's logical sequence is an int32 page-table row mapping virtual
position `t -> (row[t // page_size], t % page_size)`. Page 0 is the
null/trash page by contract: never allocated to a request, it absorbs
padded-position and inactive-slot writes, and reads of it only ever land
at virtual positions past a slot's `pos`, which the live mask discards.

Unlike the JAX package, which threads the cache through donated jit
calls, the port updates the pool IN PLACE (`index_put_` /
`index_reduce_` on each layer's view of the persistent tensors): the
cache dict passed in is the cache that comes out.

`make_kv_decode` (contiguous cache), `chunk_batch` (batched admission),
`ngram_propose` and `make_generate` are not ported yet.
"""
from __future__ import annotations

import torch

from .quant import lm_head_logits, project_qkv, rms_norm, swiglu_mlp

_NEG = -1e9   # the gather path's mask value (fedml_tpu/parallel/seq.py)


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


def make_paged_kv_decode(n_heads: int, page_size: int,
                         dtype=torch.float32, eps: float = 1e-6,
                         kernel: bool = False, quant: bool = False):
    """Returns (chunk, step, verify) over a `TransformerLM` and a paged
    cache dict {"k", "v": [L, P, page_size, H, Dh]} (+ {"ks", "vs": [L, P,
    H] f32} when `quant`, the pool then int8):

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

    def gather(ck, cv, ks, vs, idx):
        if quant:
            return dq_pages(ck, ks, idx), dq_pages(cv, vs, idx)
        return ck[idx], cv[idx]

    def chunk(model, cache, pages_row, tokens, t0: int, length: int):
        x = model.embed.embedding.to(dtype)[tokens]               # [1, C, D]
        c = tokens.shape[1]
        dev = tokens.device
        j = torch.arange(c, device=dev)
        posr = t0 + j                                             # [C]
        max_pages = pages_row.shape[0]
        # padded tail positions (j >= length) write to the null page; the
        # row index is clamped like XLA's gather clamps it
        wpage = torch.where(
            j < length, pages_row[torch.clamp(posr // ps, max=max_pages - 1)],
            0)
        woff = posr % ps
        n_virt = max_pages * ps
        live = (torch.arange(n_virt, device=dev)[None, :]
                <= posr[:, None])                                 # [C, T]
        for i, bl in enumerate(model.blocks):
            ck, cv, ks, vs = layer_cache(cache, i)
            h = rms_norm(x, bl.RMSNorm_0.scale.to(dtype), eps)
            q, k, v = project_qkv(bl, None, 0.0, h, n_heads, dtype)
            q = _rope_rows(q, posr[None, :])
            k = _rope_rows(k, posr[None, :])
            write(ck, cv, ks, vs, wpage, woff, k[0], v[0])
            # gather AFTER the write so the chunk attends to itself
            kk, vv = gather(ck, cv, ks, vs, pages_row.long())
            kk = kk.reshape((n_virt,) + ck.shape[2:])
            vv = vv.reshape((n_virt,) + cv.shape[2:])
            scale = q.shape[-1] ** -0.5
            s = torch.einsum("bqhd,khd->bhqk", q, kk) * scale
            s = torch.where(live[None, None], s, _NEG)
            o = torch.einsum("bhqk,khd->bqhd", torch.softmax(s, -1), vv)
            x = x + o.reshape(x.shape) @ bl.wo.kernel.to(dtype)
            x = swiglu_mlp(bl, None, 0.0, x, dtype, eps)
        last = x[0, length - 1]
        return lm_head_logits(model, None, 0.0, last[None, None], dtype,
                              eps)[:, 0]

    def verify(model, cache, pages, pos, tokens, active):
        x = model.embed.embedding.to(dtype)[tokens]               # [S, C, D]
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
        n_virt = max_pages * ps
        if not kernel:
            live = (torch.arange(n_virt, device=dev)[None, None, :]
                    <= posr[:, :, None])                          # [S, C, T]
        for i, bl in enumerate(model.blocks):
            ck, cv, ks, vs = layer_cache(cache, i)
            h = rms_norm(x, bl.RMSNorm_0.scale.to(dtype), eps)
            q, k, v = project_qkv(bl, None, 0.0, h, n_heads, dtype)
            q = _rope_rows(q, posr)
            k = _rope_rows(k, posr)
            write(ck, cv, ks, vs, wpage, woff, k, v)
            if kernel:
                # pages read in place; an int8 pool goes in as-is and the
                # kernel dequantizes each slab
                o = paged_attention(q, ck, cv, pages, pos, ks, vs)
            else:
                kk, vv = gather(ck, cv, ks, vs, pages.long())
                kk = kk.reshape((s_, n_virt) + ck.shape[2:])
                vv = vv.reshape((s_, n_virt) + cv.shape[2:])
                scale = q.shape[-1] ** -0.5
                s = torch.einsum("bqhd,bkhd->bhqk", q, kk) * scale
                s = torch.where(live[:, None], s, _NEG)
                o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vv)
            x = x + o.reshape(x.shape) @ bl.wo.kernel.to(dtype)
            x = swiglu_mlp(bl, None, 0.0, x, dtype, eps)
        return lm_head_logits(model, None, 0.0, x, dtype, eps)

    def step(model, cache, pages, pos, token, active):
        return verify(model, cache, pages, pos, token[:, None], active)[:, 0]

    return chunk, step, verify


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

