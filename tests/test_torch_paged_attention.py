"""The port's paged-attention op (fedml_tpu_torch/ops/paged_attention.py)
held against the JAX package's Pallas kernel (interpret mode on the CPU).

On a CPU tensor the port's wrapper runs its plain PyTorch version, so the
CPU cases pin that version to the TPU kernel's semantics: f32 and int8
pools, C in {1, 4}, page tables with null-page-0 entries past each
reservation, and a `pos` whose slot skips reserved pages. The CUDA kernel
itself is held against the plain version by the `gpu`-marked test at the
end (and by chip_smoke.py at full width).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.ops.paged_attention import paged_attention as jax_paged_attention
from fedml_tpu_torch.ops import paged_attention as pa

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
                                       (16, 64, 256, 1), (3, 7, 40, 3)])
def test_cuda_kernel_matches_plain_version(cuda, dtype, c, ps, dh, h):
    """The kernel at the limits it takes (C 16, page_size 64, Dh 256) and
    at shapes that fill no warp, against the plain version on the card:
    f32 within 1e-5 (summation order), bf16/int8 within 2e-2 (the order
    can flip the bf16 rounding of p and of the output)."""
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
    tol = 1e-5 if dtype == "f32" else 2e-2
    assert (got.float() - ref.float()).abs().max().item() <= tol
