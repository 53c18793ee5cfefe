"""The port's paged-attention op (fedml_tpu_torch/ops/paged_attention.py)
held against the JAX package's Pallas kernel (interpret mode on the CPU).

On a CPU tensor the port's wrapper runs its plain PyTorch version, so the
CPU cases pin that version to the TPU kernel's semantics: f32 and int8
pools, C in {1, 4}, page tables with null-page-0 entries past each
reservation, and a `pos` whose slot skips reserved pages. The CUDA path
splits each page table into runs and merges the runs' partials; its plain
version `paged_attention_split_ref` is pinned to the TPU kernel here too,
at every split size. The CUDA kernels themselves are held against the
plain versions by the `gpu`-marked tests at the end (and by chip_smoke.py
at full width), under `rowwise_rel_err`.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.ops.paged_attention import paged_attention as jax_paged_attention
from fedml_tpu_torch.ops import paged_attention as pa
from fedml_tpu_torch.ops.tolerance import rowwise_rel_err

torch.set_num_threads(2)

S, H, DH, PS, P, MAX_PAGES = 3, 4, 16, 4, 24, 6
N_RES = (6, 3, 2)            # pages reserved per slot; the rest of a row is 0


def _case(c: int, quant: bool, seed: int = 0, dh: int = DH, ps: int = PS,
          h: int = H):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(np.arange(1, P))
    pages = np.zeros((S, MAX_PAGES), np.int32)
    at = 0
    for s, n in enumerate(N_RES):
        pages[s, :n] = perm[at:at + n]
        at += n
    # slot 0 ends on its last reserved row; slot 1 has 3 pages reserved but
    # only page 0 live (skips 2); slot 2 sits mid-page
    pos = np.array([N_RES[0] * ps - c, 1, ps + 1], np.int32)
    q = rng.standard_normal((S, c, h, dh), np.float32)
    shape = (P, ps, h, dh)
    if quant:
        k = rng.integers(-127, 128, shape, np.int8)
        v = rng.integers(-127, 128, shape, np.int8)
        ks = rng.uniform(0.005, 0.05, (P, h)).astype(np.float32)
        vs = rng.uniform(0.005, 0.05, (P, h)).astype(np.float32)
        scales = (ks, vs)
    else:
        k = rng.standard_normal(shape, np.float32)
        v = rng.standard_normal(shape, np.float32)
        scales = (None, None)
    return (q, k, v, pages, pos) + scales


def _torch(args):
    return [None if a is None else torch.from_numpy(a) for a in args]


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("c", [1, 4])
def test_matches_jax_kernel(c, quant):
    args = _case(c, quant)
    want = np.asarray(jax_paged_attention(
        *[None if a is None else jnp.asarray(a) for a in args]))
    before = pa.launch_count
    got = pa.paged_attention(*_torch(args))
    assert pa.launch_count == before          # CPU: the plain version
    assert got.dtype == torch.float32 and got.shape == (S, c, H, DH)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@functools.lru_cache(maxsize=None)
def _split_case(kind: str, c: int):
    """(port inputs, JAX kernel's output as f32 numpy) for one pool kind:
    "f32", "int8" (f32 queries, int8 pool) or "bf16" (bf16 queries and
    pool)."""
    args = _case(c, kind == "int8", seed=5)
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    targs = _torch(args)
    if kind == "bf16":
        jargs[:3] = [a.astype(jnp.bfloat16) for a in jargs[:3]]
        targs[:3] = [t.bfloat16() for t in targs[:3]]
    want = np.array(jax_paged_attention(*jargs).astype(jnp.float32))
    return targs, want


@pytest.mark.parametrize("kind", ["f32", "int8", "bf16"])
@pytest.mark.parametrize("c", [1, 5])
@pytest.mark.parametrize("pps", [1, 2, 3, MAX_PAGES])
def test_split_ref_matches_jax_kernel(kind, c, pps):
    """The split-and-merge arithmetic of the CUDA path, at split sizes that
    leave splits empty for short slots (3), start a split on a slot's last
    live page (2), cut a slot's pages one by one (1), or take the whole
    table (MAX_PAGES), against the JAX kernel and the unsplit plain
    version: f32 within 1e-5 (another summation order), bf16 within 1e-2
    row by row (the order can flip a bf16 rounding of p or of the
    output)."""
    targs, want = _split_case(kind, c)
    got = pa.paged_attention_split_ref(*targs, pages_per_split=pps)
    plain = pa.paged_attention(*targs)
    assert got.dtype == targs[0].dtype and got.shape == (S, c, H, DH)
    if kind == "bf16":
        assert rowwise_rel_err(got, torch.from_numpy(want).bfloat16()) <= 1e-2
        assert rowwise_rel_err(got, plain) <= 1e-2
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5,
                                   rtol=1e-5)
    if pps == MAX_PAGES:   # one split: the unsplit fold, bit for bit
        assert torch.equal(got, plain)


def test_pages_per_split_rule():
    """The split size depends on the table's width alone: the smallest that
    cuts it into at most MAX_SPLITS runs."""
    for mp in (1, 6, 16, 17, 37, 64, 128, 1000):
        pps = pa.pages_per_split(mp)
        assert -(-mp // pps) <= pa.MAX_SPLITS
        assert pps == 1 or -(-mp // (pps - 1)) > pa.MAX_SPLITS
    assert pa.pages_per_split(64) == 4 and pa.pages_per_split(128) == 8


def test_scalar_pos_broadcasts():
    q, k, v, pages, _pos, _, _ = _case(1, False)
    pos = np.int32(2)
    want = np.asarray(jax_paged_attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), jnp.asarray(pages),
                                          jnp.asarray(pos)))
    got = pa.paged_attention(*_torch((q, k, v, pages)),
                             torch.tensor(pos, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v, pages, pos, ks, vs = _torch(_case(1, True))
    qf, kf, vf, _, _, _, _ = _torch(_case(1, False))
    with pytest.raises(ValueError, match="together"):
        pa.paged_attention(q, k, v, pages, pos, ks, None)
    with pytest.raises(ValueError, match="int8 pool needs"):
        pa.paged_attention(q, k, v, pages, pos)
    with pytest.raises(ValueError, match="only an int8 pool"):
        pa.paged_attention(qf, kf, vf, pages, pos, ks, vs)
    with pytest.raises(ValueError, match="q's dtype"):
        pa.paged_attention(qf.bfloat16(), kf, vf, pages, pos)
    with pytest.raises(ValueError, match="int32"):
        pa.paged_attention(qf, kf, vf, pages.long(), pos)
    with pytest.raises(ValueError, match="int32"):
        pa.paged_attention(qf, kf, vf, pages, pos.long())
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_attention(qf.transpose(2, 3).contiguous().transpose(2, 3),
                           kf, vf, pages, pos)
    big_c = torch.zeros((S, pa.MAX_C + 1, H, DH))
    with pytest.raises(ValueError, match="C <= 16"):
        pa.paged_attention(big_c, kf, vf, pages, pos)
    wide = torch.zeros((P, PS, H, pa.MAX_DH + 2))
    with pytest.raises(ValueError, match="Dh <= 256"):
        pa.paged_attention(torch.zeros((S, 1, H, pa.MAX_DH + 2)), wide,
                           wide, pages, pos)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        pa.paged_attention(qf.half(), kf.half(), vf.half(), pages, pos)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("c,ps,dh,h", [(1, 4, 16, 4), (4, 16, 128, 2),
                                       (16, 64, 256, 1), (3, 7, 40, 3),
                                       (1, 4, 7, 2)])
def test_cuda_kernel_matches_plain_version(cuda, dtype, c, ps, dh, h):
    """The kernel at the limits it takes (C 16, page_size 64, Dh 256: one
    staging buffer, two do not fit), at shapes that fill no warp, and at
    slab rows 16 bytes do not divide (Dh 7, and Dh 40 in int8: element
    copies), against the plain version on the card,
    each (s, c, h) row's error relative to that row's largest value with
    one ulp of the output forgiven (`rowwise_rel_err`): f32 within 1e-5
    (summation order), bf16/int8 within 1e-2 (the order can flip the bf16
    rounding of p and of the output)."""
    q, k, v, pages, pos, ks, vs = _case(c, dtype == "int8", seed=3, dh=dh,
                                        ps=ps, h=h)
    args = [None if a is None else torch.from_numpy(a).to(cuda)
            for a in (q, k, v, pages, pos, ks, vs)]
    if dtype != "f32":
        args[0] = args[0].bfloat16()
    if dtype == "bf16":
        args[1], args[2] = args[1].bfloat16(), args[2].bfloat16()
    before = pa.launch_count
    got = pa.paged_attention(*args)
    torch.cuda.synchronize()
    assert pa.launch_count == before + 1
    ref = pa.paged_attention_ref(*args)
    tol = 1e-5 if dtype == "f32" else 1e-2
    assert rowwise_rel_err(got, ref) <= tol


def _edge_case(rng, dtype, c, s_, h, dh, ps, max_pages, pos, n_pool):
    """Full page tables over a pool of n_pool pages (no null entries) and
    the given positions, on the card."""
    dev = torch.device("cuda")
    pages = np.stack([rng.permutation(np.arange(1, n_pool))[:max_pages]
                      for _ in range(s_)]).astype(np.int32)
    shape = (n_pool, ps, h, dh)
    qdt = torch.float32 if dtype == "f32" else torch.bfloat16
    q = torch.from_numpy(rng.standard_normal((s_, c, h, dh), np.float32))
    if dtype == "int8":
        k, v = (torch.from_numpy(rng.integers(-127, 128, shape, np.int8))
                for _ in range(2))
        ks, vs = (torch.from_numpy(rng.uniform(0.005, 0.05, (n_pool, h))
                                   .astype(np.float32)).to(dev)
                  for _ in range(2))
    else:
        k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
                .to(qdt) for _ in range(2))
        ks = vs = None
    return (q.to(dev, qdt), k.to(dev), v.to(dev),
            torch.from_numpy(pages).to(dev),
            torch.tensor(pos, dtype=torch.int32, device=dev), ks, vs)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("edge", ["ragged_last_split", "single_slot_head"])
@pytest.mark.parametrize("c", [1, 5])
def test_cuda_kernel_split_edges(cuda, dtype, edge, c):
    """The split-page kernel at its edges, against both plain versions:
    "ragged_last_split" has 37-entry tables (3 pages per split, the last
    split holding one page), a slot ending on its table's last position, a
    slot whose last live page is the first page of a split, and a slot at
    pos 0; "single_slot_head" is S = H = 1 at Dh 128. Limits as above,
    row by row."""
    rng = np.random.default_rng(11)
    if edge == "ragged_last_split":
        s_, h, dh, ps, mp = 4, 2, 64, 16, 37
        pos = [mp * ps - c, 3 * ps + 5 - c + 1, 0, 100]
    else:
        s_, h, dh, ps, mp = 1, 1, 128, 16, 64
        pos = [500]
    assert pa.pages_per_split(mp) == (3 if mp == 37 else 4)
    args = _edge_case(rng, dtype, c, s_, h, dh, ps, mp, pos, n_pool=160)
    before = pa.launch_count
    got = pa.paged_attention(*args)
    torch.cuda.synchronize()
    assert pa.launch_count == before + 1
    tol = 1e-5 if dtype == "f32" else 1e-2
    assert rowwise_rel_err(got, pa.paged_attention_ref(*args)) <= tol
    split = pa.paged_attention_split_ref(
        *args, pages_per_split=pa.pages_per_split(mp))
    assert rowwise_rel_err(got, split) <= tol
