"""The port's flash attention (`fedml_tpu_torch/ops/flash_attention.py`)
against the JAX package's Pallas kernels.

On the CPU the JAX side runs `fedml_tpu.ops.flash_attention.flash_attention`
in interpret mode, as tests/test_flash_attention.py runs it, and the port
runs its plain versions (the Pallas kernels' blocked math with their
rounding points). The CUDA kernels themselves are held against the plain
versions by the `gpu`-marked test at the end, on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.ops.flash_attention import _blocked_lse
from fedml_tpu.ops.flash_attention import flash_attention as jax_flash
from fedml_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(2)


def _qkv(seed, bh=4, t=128, d=32):
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(bh, t, d).astype(np.float32) for _ in range(3))


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("t,bq,bk,seed", [(128, 32, 32, 0), (96, 32, 48, 1)])
def test_values_and_lse_match_jax(t, bq, bk, seed):
    """f32 at the JAX test's own tolerance (2e-5); the LSE against the JAX
    module's blocked oracle."""
    q, k, v = _qkv(seed, t=t)
    want = np.asarray(jax_flash(*(jnp.asarray(x) for x in (q, k, v)),
                                block_q=bq, block_k=bk))
    got = fa.flash_attention(*_t(q, k, v), block_q=bq, block_k=bk)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    _o, lse = fa.flash_fwd(*_t(q, k, v), block_q=bq, block_k=bk)
    want_lse = np.asarray(_blocked_lse(jnp.asarray(q), jnp.asarray(k), bk))
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=2e-5, atol=2e-5)


def test_grads_match_jax():
    """dQ/dK/dV through torch.autograd against jax.grad of the Pallas
    kernels (2e-4, the JAX test's tolerance)."""
    q, k, v = _qkv(2, bh=2, t=64, d=16)

    def loss_jax(q, k, v):
        return (jax_flash(q, k, v, block_q=16, block_k=16) ** 2).sum()

    want = jax.grad(loss_jax, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    qt, kt, vt = (x.requires_grad_() for x in _t(q, k, v))
    (fa.flash_attention(qt, kt, vt, block_q=16, block_k=16) ** 2).sum() \
        .backward()
    for got, w in zip((qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-4)


def test_bf16_matches_jax():
    """bf16 operands, auto blocks, values and gradients. Both sides round p
    and dS to bf16 at the same points, but a last-bit difference in an f32
    sum can flip one bf16 rounding, and the outputs are bf16 (2^-8
    relative): 2e-2 of each output's largest magnitude."""
    q, k, v = _qkv(3, bh=2, t=64, d=32)
    do = np.random.RandomState(4).randn(2, 64, 32).astype(np.float32)
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    o_j, vjp = jax.vjp(jax_flash, jq, jk, jv)
    want = (o_j,) + vjp(jdo)
    qt, kt, vt = (x.requires_grad_() for x in _t(q, k, v,
                                                  dtype=torch.bfloat16))
    o = fa.flash_attention(qt, kt, vt)
    o.backward(torch.from_numpy(do).bfloat16())
    for got, w in zip((o, qt.grad, kt.grad, vt.grad), want):
        w = np.asarray(w.astype(jnp.float32))
        err = np.abs(got.detach().float().numpy() - w).max()
        assert err <= 2e-2 * np.abs(w).max(), err


def test_flash_attn_fn_folds_heads():
    """[B, T, H, D] in and out, equal to flash_attention on the folded
    operands."""
    rs = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(rs.randn(2, 32, 3, 16).astype(np.float32))
               for _ in range(3))
    got = fa.flash_attn_fn(q, k, v)
    fold = lambda x: x.transpose(1, 2).reshape(6, 32, 16).contiguous()
    want = fa.flash_attention(fold(q), fold(k), fold(v))
    assert got.shape == (2, 32, 3, 16)
    torch.testing.assert_close(got, want.reshape(2, 3, 32, 16)
                               .transpose(1, 2), rtol=0, atol=0)


def test_contract_errors():
    q, k, v = _t(*_qkv(6, bh=2, t=96, d=16))
    with pytest.raises(ValueError, match="divisible by block sizes"):
        fa.flash_attention(q, k, v, block_q=64, block_k=32)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match=r"\[BH, T, D\]"):
        fa.flash_attention(q[None], k[None], v[None])
    with pytest.raises(ValueError, match="match q's shape and dtype"):
        fa.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="D <= 128"):
        wide = torch.zeros((1, 8, 136))
        fa.flash_attention(wide, wide, wide)
    with pytest.raises(ValueError, match="D % 8 == 0"):
        odd = torch.zeros((1, 8, 12))
        fa.flash_attention(odd, odd, odd)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(0, 1), k.transpose(0, 1),
                           v.transpose(0, 1))
    with pytest.raises(ValueError, match="lse/delta"):
        fa.flash_dq(q, k, v, q, torch.zeros(2, 96, dtype=torch.float64),
                    torch.zeros(2, 96))


def test_cpu_tensors_launch_no_kernel():
    """CPU tensors run the plain versions on every route: f32 heads of D 8
    and 32 (the three-pass TF32 kernels' route in every pass) and bf16
    heads of D 16 and 8 (the one-pass tensor-core kernels' route in every
    pass) leave every counter as it was. The counters are the six
    tensor-core kernels': there is no FMA kernel and no key for one."""
    assert fa.launch_count.keys() == {"fwd_tc", "fwd_3xtf32", "dq_tc",
                                      "dq_3xtf32", "dkv_tc", "dkv_3xtf32"}
    before = dict(fa.launch_count)
    for d, dtype in ((8, torch.float32), (16, torch.bfloat16),
                     (8, torch.bfloat16), (32, torch.float32)):
        q, k, v = (x.requires_grad_()
                   for x in _t(*_qkv(7, bh=1, t=32, d=d), dtype=dtype))
        fa.flash_attention(q, k, v).sum().backward()
    assert fa.launch_count == before
    assert fa.launch_count["fwd_3xtf32"] == before["fwd_3xtf32"] == 0
    assert fa.launch_count["dq_3xtf32"] == before["dq_3xtf32"] == 0
    assert fa.launch_count["dkv_3xtf32"] == before["dkv_3xtf32"] == 0


@pytest.mark.parametrize("seed,spread", [(0, 1.0), (1, 8.0)])
def test_tf32_split_is_exact(seed, spread):
    """On values from ~1e-14 to ~1e14: hi + lo == x bitwise, hi's low 13
    bits are 0 (a TF32 value), |lo| is at most half a TF32 ulp of x; ties round away from zero (cvt.rna); the
    tensor cores' truncation zeroes lo's low 13 bits and leaves hi."""
    rs = np.random.RandomState(seed)
    x = torch.from_numpy((rs.randn(4096) * np.exp(rs.randn(4096) * spread))
                         .astype(np.float32))
    hi, lo = fa.tf32_split(x)
    assert torch.equal(hi + lo, x)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    assert (lo.abs() <= hi.abs() * 2.0 ** -11).all()
    assert torch.equal(fa.tf32_truncate(hi), hi)
    assert ((fa.tf32_truncate(lo).view(torch.int32) & 0x1FFF) == 0).all()
    ties = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11])
    assert fa.tf32_split(ties)[0].tolist() == [1 + 2 ** -10, -(1 + 2 ** -10),
                                               1 + 2 ** -9]


@pytest.mark.parametrize("t,bq,bk,seed", [(128, 32, 32, 0), (96, 32, 48, 1)])
def test_3xtf32_products_match_jax(t, bq, bk, seed):
    """The plain version with every f32 product made as the three-pass
    TF32 kernel makes it (`matmul_3xtf32`) against the JAX K1 in interpret
    mode (f32, HIGHEST): O and LSE within 1e-5 row-relative, a tenth of
    the 1e-4 the kernel is held to on the card."""
    q, k, v = _qkv(seed, t=t)
    want = np.array(jax_flash(*(jnp.array(x) for x in (q, k, v)),
                                block_q=bq, block_k=bk))
    want_lse = np.array(_blocked_lse(jnp.array(q), jnp.array(k), bk))
    o, lse = fa.flash_fwd_ref(*_t(q, k, v), bq, bk, mm=fa.matmul_3xtf32)
    assert fa.rowwise_rel_err(o, torch.from_numpy(want)) <= 1e-5
    assert fa.rowwise_rel_err(lse, torch.from_numpy(want_lse)) <= 1e-5


def test_one_tf32_pass_misses_the_f32_limit():
    """Why three passes: with one TF32 pass (hi . hi) the same forward is
    off the JAX K1 by more than the 1e-4 the f32 kernels are held to."""
    q, k, v = _qkv(0, t=128)
    want = np.array(jax_flash(*(jnp.array(x) for x in (q, k, v)),
                                block_q=32, block_k=32))

    def one_pass(a, b):
        return fa.tf32_split(a)[0] @ fa.tf32_split(b)[0]

    o, _lse = fa.flash_fwd_ref(*_t(q, k, v), 32, 32, mm=one_pass)
    assert fa.rowwise_rel_err(o, torch.from_numpy(want)) > 1e-4


def _jax_dkv(q, k, v, do, bq, bk):
    """dK, dV of the JAX flash attention (f32, interpret mode on the CPU)
    through `jax.vjp`."""
    _o, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v, block_q=bq,
                                                block_k=bk),
                      *(jnp.array(x) for x in (q, k, v)))
    _dq, dk, dv = vjp(jnp.array(do))
    return torch.from_numpy(np.array(dk)), torch.from_numpy(np.array(dv))


def _port_dkv(q, k, v, do, bq, bk, mm):
    """dK, dV of the port's plain K3 with its products made by `mm`, fed
    the LSE of the plain forward made the same way."""
    q, k, v, do = _t(q, k, v, do)
    o, lse = fa.flash_fwd_ref(q, k, v, bq, bk, mm=mm)
    delta = fa.flash_delta(o, do)
    return fa.flash_dkv_ref(q, k, v, do, lse, delta, bq, bk, mm=mm)


@pytest.mark.parametrize("t,bq,bk,seed", [(128, 32, 32, 0), (96, 32, 48, 1)])
def test_3xtf32_dkv_products_match_jax(t, bq, bk, seed):
    """The plain K3 with every f32 product made as the three-pass TF32
    kernel makes it (`matmul_3xtf32`) against the JAX K3 (f32, interpret
    mode, `jax.vjp`): dK and dV within 1e-5 row-relative, a tenth of the
    1e-4 the kernel is held to on the card."""
    q, k, v = _qkv(seed, t=t)
    do = np.random.RandomState(seed + 20).randn(*q.shape).astype(np.float32)
    want_dk, want_dv = _jax_dkv(q, k, v, do, bq, bk)
    dk, dv = _port_dkv(q, k, v, do, bq, bk, fa.matmul_3xtf32)
    assert fa.rowwise_rel_err(dk, want_dk) <= 1e-5
    assert fa.rowwise_rel_err(dv, want_dv) <= 1e-5


@pytest.mark.parametrize("d,seed", [(40, 5), (8, 6)])
def test_3xtf32_dkv_products_match_jax_at_small_heads(d, seed):
    """The widened f32 K3 route: heads of D 40 and 8 (which the three-pass
    K3 now takes on its 64-column instance, the Q^T and dO^T rows past D
    zero) through the plain K3 made as that kernel makes it
    (`matmul_3xtf32`) against the JAX K3 (f32, interpret mode, `jax.vjp`):
    dK and dV within 1e-5 row-relative, a tenth of the 1e-4 the kernel is
    held to on the card. dK is 0 up to rounding only at T 1 (the first
    key's one query, p = 1, dP = delta), so no row here is a cancellation
    and every row is held to the same 1e-5 (read: ~1e-6)."""
    q, k, v = _qkv(seed, bh=2, t=64, d=d)
    do = np.random.RandomState(seed + 20).randn(*q.shape).astype(np.float32)
    want_dk, want_dv = _jax_dkv(q, k, v, do, 32, 32)
    dk, dv = _port_dkv(q, k, v, do, 32, 32, fa.matmul_3xtf32)
    assert fa.rowwise_rel_err(dk, want_dk) <= 1e-5
    assert fa.rowwise_rel_err(dv, want_dv) <= 1e-5


def test_one_tf32_pass_misses_the_f32_limit_in_dkv():
    """Why K3 takes three passes too: with one TF32 pass (hi . hi) the
    same dK and dV are off the JAX K3 by more than 1e-4."""
    q, k, v = _qkv(0, t=128)
    do = np.random.RandomState(20).randn(*q.shape).astype(np.float32)
    want_dk, want_dv = _jax_dkv(q, k, v, do, 32, 32)

    def one_pass(a, b):
        return fa.tf32_split(a)[0] @ fa.tf32_split(b)[0]

    dk, dv = _port_dkv(q, k, v, do, 32, 32, one_pass)
    assert fa.rowwise_rel_err(dk, want_dk) > 1e-4
    assert fa.rowwise_rel_err(dv, want_dv) > 1e-4


def _jax_dq(q, k, v, do, bq, bk):
    """dQ of the JAX flash attention (f32, interpret mode on the CPU)
    through `jax.vjp`."""
    _o, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v, block_q=bq,
                                                block_k=bk),
                      *(jnp.array(x) for x in (q, k, v)))
    return torch.from_numpy(np.array(vjp(jnp.array(do))[0]))


def _port_dq(q, k, v, do, bq, bk, mm):
    """dQ of the port's plain K2 with its products made by `mm`, fed the
    LSE of the plain forward made the same way."""
    q, k, v, do = _t(q, k, v, do)
    o, lse = fa.flash_fwd_ref(q, k, v, bq, bk, mm=mm)
    delta = fa.flash_delta(o, do)
    return fa.flash_dq_ref(q, k, v, do, lse, delta, bq, bk, mm=mm)


def _row0_and_rest(got, want):
    """`rowwise_rel_err` on dQ's first row and on the rest apart. The
    first row attends one key (p = 1, dP = delta): dQ there is 0 up to the
    rounding of dP (magnitude ~sqrt(D)), which two f32 dot products in
    different orders put ~1e-7 apart, read against the rule's 1e-2 floor."""
    return (fa.rowwise_rel_err(got[:, :1], want[:, :1]),
            fa.rowwise_rel_err(got[:, 1:], want[:, 1:]))


@pytest.mark.parametrize("t,bq,bk,seed", [(128, 32, 32, 0), (96, 32, 48, 1)])
def test_3xtf32_dq_products_match_jax(t, bq, bk, seed):
    """The plain K2 made as the f32 kernel makes it (S and dS.K with
    `matmul_3xtf32`, dP exactly) against the JAX K2 (f32, interpret mode,
    `jax.vjp`): dQ within 1e-5 row-relative on every row but the first, a
    tenth of the 1e-4 the kernel is held to on the card. The first row is
    a cancellation (`_row0_and_rest`): the JAX K2 rounds its dP as an f32
    sum, which reads up to ~5e-5 there against any other rounding; it is
    held to the card's 1e-4."""
    q, k, v = _qkv(seed, t=t)
    do = np.random.RandomState(seed + 30).randn(*q.shape).astype(np.float32)
    want = _jax_dq(q, k, v, do, bq, bk)
    dq = _port_dq(q, k, v, do, bq, bk, fa.matmul_3xtf32)
    row0, rest = _row0_and_rest(dq, want)
    assert rest <= 1e-5
    assert row0 <= 1e-4


def test_one_tf32_pass_misses_the_f32_limit_in_dq():
    """Why K2 takes three passes for S and dS.K: with one TF32 pass
    (hi . hi) there, the same dQ is off the JAX K2 by more than 1e-4 on
    the rows past the first."""
    q, k, v = _qkv(0, t=128)
    do = np.random.RandomState(30).randn(*q.shape).astype(np.float32)
    want = _jax_dq(q, k, v, do, 32, 32)

    def one_pass(a, b):
        return fa.tf32_split(a)[0] @ fa.tf32_split(b)[0]

    dq = _port_dq(q, k, v, do, 32, 32, one_pass)
    assert _row0_and_rest(dq, want)[1] > 1e-4


def _fma_chain(a, b):
    """a @ b of f32 operands as one f32 FMA chain per entry in the order of
    the inner index (how a GPU's f32 product sums it): each step rounds
    a_d * b_d + acc once to f32 (exact in f64 before that rounding)."""
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for d in range(a.shape[-1]):
        acc = (a[..., d, None].double() * b[..., d, None, :].double()
               + acc.double()).float()
    return acc


def test_dq_row0_reads_the_rounding_of_dp():
    """Why the f32 K2 makes dP exactly (f64 FMAs, rounded once) and not in
    three TF32 passes or as an f32 FMA chain: the rows that attend one key
    or a few (p = 1, dP = delta on the first) are 0 up to dP's rounding,
    and three passes, or one f32 FMA chain over d, round dP (magnitude ~11
    at D 128) far enough from the exact sum that the rule reads more than
    1e-4 there at BH 64, the check shape's head count. With dP made
    exactly (the kernel's arithmetic) the same dQ is within 1e-5 of the
    plain version on every row."""
    rs = np.random.RandomState(40)
    q, k, v, do = (torch.from_numpy(rs.randn(64, 4, 128).astype(np.float32))
                   for _ in range(4))
    o, lse = fa.flash_fwd_ref(q, k, v, 4, 4, mm=fa.matmul_3xtf32)
    delta = fa.flash_delta(o, do)
    want = fa.flash_dq_ref(q, k, v, do, lse, delta, 4, 4)
    three = fa.flash_dq_ref(q, k, v, do, lse, delta, 4, 4,
                            mm=fa.matmul_3xtf32, mm_dp=fa.matmul_3xtf32)
    f32_sum = fa.flash_dq_ref(q, k, v, do, lse, delta, 4, 4,
                              mm_dp=_fma_chain)
    kernel = fa.flash_dq_ref(q, k, v, do, lse, delta, 4, 4,
                             mm=fa.matmul_3xtf32)
    assert fa.rowwise_rel_err(three, want) > 1e-4
    assert fa.rowwise_rel_err(f32_sum, want) > 1e-4
    assert fa.rowwise_rel_err(kernel, want) <= 1e-5


def test_3xtf32_products_match_jax_at_a_head_of_40():
    """The widened f32 routes: a head of D 40 (which the three-pass
    forward and K2 now take on their 64-column instance) through the
    plain forward and K2 made as those kernels make them against the JAX
    module: O and LSE within 1e-5 row-relative, dQ within 1e-5 past its
    first row and 1e-4 on it (`_row0_and_rest`)."""
    q, k, v = _qkv(4, bh=2, t=64, d=40)
    do = np.random.RandomState(34).randn(*q.shape).astype(np.float32)
    want_o = torch.from_numpy(np.array(jax_flash(
        *(jnp.array(x) for x in (q, k, v)), block_q=32, block_k=32)))
    want_lse = torch.from_numpy(np.array(_blocked_lse(jnp.array(q),
                                                      jnp.array(k), 32)))
    o, lse = fa.flash_fwd_ref(*_t(q, k, v), 32, 32, mm=fa.matmul_3xtf32)
    assert fa.rowwise_rel_err(o, want_o) <= 1e-5
    assert fa.rowwise_rel_err(lse, want_lse) <= 1e-5
    dq = _port_dq(q, k, v, do, 32, 32, fa.matmul_3xtf32)
    row0, rest = _row0_and_rest(dq, _jax_dq(q, k, v, do, 32, 32))
    assert rest <= 1e-5
    assert row0 <= 1e-4


def test_rowwise_rel_err_rule():
    """The rule the kernels are held to on the card: one ulp of the output
    forgiven, the rest relative to the row's own magnitude (a late row
    cannot hide behind an early row's large values), rows below 1e-2 held
    to 1e-2; an LSE entry is a row of its own."""
    want = torch.tensor([[[4.0, -2.0], [0.0625, 0.03125]]]).bfloat16()
    one_ulp = want + torch.tensor([[[2 ** -5, 0.0], [2 ** -11, 0.0]]])
    assert fa.rowwise_rel_err(one_ulp.bfloat16(), want) == 0.0
    late = want.clone()
    late[0, 1, 0] = 0.0625 + 2 ** -10  # two ulps (2^-11) of a 2^-4 row
    assert fa.rowwise_rel_err(late, want) == pytest.approx(2 ** -7)
    tiny = torch.zeros((1, 1, 2))
    assert fa.rowwise_rel_err(tiny + 1e-6, tiny) == pytest.approx(1e-4)
    lse = torch.tensor([[1.0, 8.0]])
    assert fa.rowwise_rel_err(lse + 1e-3, lse) == pytest.approx(1e-3,
                                                                rel=1e-3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,t,d", [(3, 96, 16), (2, 200, 128), (1, 1, 8),
                                    (2, 130, 40), (2, 65, 32), (2, 129, 96),
                                    (2, 70, 24), (2, 100, 72), (1, 33, 120)])
def test_cuda_kernels_match_plain_versions(cuda, dtype, bh, t, d):
    """K1, K2 and K3 against their plain versions on the card, at ragged
    tiles (T not a multiple of 64) and at D 8 to 128: every pass on the
    tensor-core kernels (bf16 one pass, f32 three TF32 passes), D below 64
    on the 64-column instances and the rest on the 128-column ones, the
    columns past D zero; under the rule chip_smoke.py holds them to
    (`rowwise_rel_err`: each row's error relative to that row's largest
    magnitude, one ulp of the output forgiven): f32 within 1e-4 (sums in
    another order), bf16 within 1e-2 (the order can also flip a bf16
    rounding of p or dS before a product)."""
    rs = np.random.RandomState(8)
    q, k, v, do = (torch.from_numpy(rs.randn(bh, t, d).astype(np.float32))
                   .to(cuda, dtype) for _ in range(4))
    before = dict(fa.launch_count)
    o, lse = fa.flash_fwd(q, k, v, block_q=t, block_k=t)
    delta = fa.flash_delta(o, do)
    dq = fa.flash_dq(q, k, v, do, lse, delta, block_q=t, block_k=t)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, block_q=t, block_k=t)
    torch.cuda.synchronize()
    launched = {fa.fwd_route(q), fa.dq_route(q), fa.dkv_route(q)}
    assert fa.launch_count == {n: before[n] + (n in launched) for n in before}
    want_o, want_lse = fa.flash_fwd_ref(q, k, v, t, t)
    want_dq = fa.flash_dq_ref(q, k, v, do, want_lse, delta, t, t)
    want_dk, want_dv = fa.flash_dkv_ref(q, k, v, do, want_lse, delta, t, t)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for got, want in ((o, want_o), (lse, want_lse), (dq, want_dq),
                      (dk, want_dk), (dv, want_dv)):
        assert fa.rowwise_rel_err(got, want) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("t", [1, 63, 64, 65, 127, 128, 129, 2048])
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_tensor_core_forward_tile_edges(cuda, t, d):
    """The bf16 tensor-core kernels at their tile edges (T of 1, one row
    short of, at and one row past a 64-row K/V or q step and a 128-row
    block, and 2048) against their plain versions: the forward's O and LSE
    row by row within 1e-2, then K2 and K3 on the tensor cores, fed its
    LSE, within the same rule."""
    rs = np.random.RandomState(9)
    bh = 2 if t == 2048 else 3
    q, k, v, do = (torch.from_numpy(rs.randn(bh, t, d).astype(np.float32))
                   .to(cuda, torch.bfloat16) for _ in range(4))
    assert (fa.fwd_route(q), fa.dq_route(q), fa.dkv_route(q)) == \
        ("fwd_tc", "dq_tc", "dkv_tc")
    before = dict(fa.launch_count)
    o, lse = fa.flash_fwd(q, k, v, block_q=t, block_k=t)
    torch.cuda.synchronize()
    assert fa.launch_count == {**before, "fwd_tc": before["fwd_tc"] + 1}
    want_o, want_lse = fa.flash_fwd_ref(q, k, v, t, t)
    assert fa.rowwise_rel_err(o, want_o) <= 1e-2
    assert fa.rowwise_rel_err(lse, want_lse) <= 1e-2
    delta = fa.flash_delta(o, do)
    dq = fa.flash_dq(q, k, v, do, lse, delta, block_q=t, block_k=t)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, block_q=t, block_k=t)
    torch.cuda.synchronize()
    assert fa.launch_count == {**before, "fwd_tc": before["fwd_tc"] + 1,
                               "dq_tc": before["dq_tc"] + 1,
                               "dkv_tc": before["dkv_tc"] + 1}
    want_dq = fa.flash_dq_ref(q, k, v, do, lse, delta, t, t)
    want_dk, want_dv = fa.flash_dkv_ref(q, k, v, do, lse, delta, t, t)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert fa.rowwise_rel_err(got, want) <= 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_tensor_core_forward_refuses_misaligned_views(cuda, dtype):
    """A contiguous view 8 bytes into its storage (4 bf16 or 2 f32
    elements) is not 16-byte aligned: the tensor-core forward of either
    dtype raises before any launch, and the card still runs the next,
    aligned call through the same kernel."""
    n = 8 // dtype.itemsize
    buf = torch.zeros(2 * 64 * 64 + n, dtype=dtype, device=cuda)
    off = buf[n:].view(2, 64, 64)
    route = fa.fwd_route(off)
    assert route == ("fwd_tc" if dtype == torch.bfloat16 else "fwd_3xtf32")
    before = dict(fa.launch_count)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_fwd(off, off, off)
    assert fa.launch_count == before
    o, _lse = fa.flash_fwd(off.clone(), off.clone(), off.clone())
    torch.cuda.synchronize()
    assert torch.isfinite(o.float()).all()
    assert fa.launch_count == {**before, route: before[route] + 1}


@pytest.mark.gpu
@pytest.mark.parametrize("t", [1, 31, 32, 33, 63, 64, 65, 127, 128, 129,
                               2048])
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_3xtf32_forward_tile_edges(cuda, t, d):
    """The f32 three-pass TF32 forward at its tile edges (T of 1, one row
    short of, at and one row past a 32-key tile, a 64-row warpgroup and a
    128-row block, and 2048) against the plain version: O and LSE row by
    row within 1e-4, one launch through "fwd_3xtf32"; then K2 and K3 on
    the three-pass kernels, fed its LSE, within the same rule."""
    rs = np.random.RandomState(11)
    bh = 2 if t == 2048 else 3
    q, k, v, do = (torch.from_numpy(rs.randn(bh, t, d).astype(np.float32))
                   .to(cuda) for _ in range(4))
    assert (fa.fwd_route(q), fa.dq_route(q), fa.dkv_route(q)) == \
        ("fwd_3xtf32", "dq_3xtf32", "dkv_3xtf32")
    before = dict(fa.launch_count)
    o, lse = fa.flash_fwd(q, k, v, block_q=t, block_k=t)
    torch.cuda.synchronize()
    assert fa.launch_count == {**before,
                               "fwd_3xtf32": before["fwd_3xtf32"] + 1}
    want_o, want_lse = fa.flash_fwd_ref(q, k, v, t, t)
    assert fa.rowwise_rel_err(o, want_o) <= 1e-4
    assert fa.rowwise_rel_err(lse, want_lse) <= 1e-4
    delta = fa.flash_delta(o, do)
    dq = fa.flash_dq(q, k, v, do, lse, delta, block_q=t, block_k=t)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, block_q=t, block_k=t)
    torch.cuda.synchronize()
    assert fa.launch_count == {**before,
                               "fwd_3xtf32": before["fwd_3xtf32"] + 1,
                               "dq_3xtf32": before["dq_3xtf32"] + 1,
                               "dkv_3xtf32": before["dkv_3xtf32"] + 1}
    want_dq = fa.flash_dq_ref(q, k, v, do, lse, delta, t, t)
    want_dk, want_dv = fa.flash_dkv_ref(q, k, v, do, lse, delta, t, t)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert fa.rowwise_rel_err(got, want) <= 1e-4


@pytest.mark.gpu
def test_cuda_tensor_core_backward_refuses_misaligned_views(cuda):
    """A dO view 8 bytes into its storage: K2 and K3 on the tensor cores
    raise before any launch, and run on an aligned copy of it."""
    rs = np.random.RandomState(10)
    q, k, v = (torch.from_numpy(rs.randn(2, 64, 64).astype(np.float32))
               .to(cuda, torch.bfloat16) for _ in range(3))
    buf = torch.zeros(2 * 64 * 64 + 4, dtype=torch.bfloat16, device=cuda)
    do = buf[4:].view(2, 64, 64)
    o, lse = fa.flash_fwd(q, k, v)
    delta = fa.flash_delta(o, do)
    before = dict(fa.launch_count)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_dq(q, k, v, do, lse, delta)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_dkv(q, k, v, do, lse, delta)
    assert fa.launch_count == before
    dq = fa.flash_dq(q, k, v, do.clone(), lse, delta)
    dk, dv = fa.flash_dkv(q, k, v, do.clone(), lse, delta)
    torch.cuda.synchronize()
    assert all(torch.isfinite(x.float()).all() for x in (dq, dk, dv))


@pytest.mark.gpu
@pytest.mark.parametrize("t", [1, 15, 16, 17, 63, 64, 65, 127, 128, 129,
                               2048])
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_3xtf32_dkv_tile_edges(cuda, t, d):
    """K3 in f32 on the three-pass TF32 kernel at its tile edges (T of 1,
    one row short of, at and one row past a 16-query tile and a 64-key
    block, and 2048), fed the three-pass forward's LSE: dK and dV row by
    row within 1e-4 of the plain version, one launch through
    "dkv_3xtf32"."""
    rs = np.random.RandomState(12)
    bh = 2 if t == 2048 else 3
    q, k, v, do = (torch.from_numpy(rs.randn(bh, t, d).astype(np.float32))
                   .to(cuda) for _ in range(4))
    assert fa.dkv_route(q) == "dkv_3xtf32"
    o, lse = fa.flash_fwd(q, k, v, block_q=t, block_k=t)
    delta = fa.flash_delta(o, do)
    before = dict(fa.launch_count)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, block_q=t, block_k=t)
    torch.cuda.synchronize()
    assert fa.launch_count == {**before,
                               "dkv_3xtf32": before["dkv_3xtf32"] + 1}
    want_dk, want_dv = fa.flash_dkv_ref(q, k, v, do, lse, delta, t, t)
    assert fa.rowwise_rel_err(dk, want_dk) <= 1e-4
    assert fa.rowwise_rel_err(dv, want_dv) <= 1e-4


@pytest.mark.gpu
def test_cuda_3xtf32_dkv_refuses_misaligned_views(cuda):
    """An f32 dO view 8 bytes into its storage: K3 on the three-pass
    route raises before any launch (and so does K2, on its three-pass
    route), and runs on an aligned copy of it."""
    rs = np.random.RandomState(13)
    q, k, v = (torch.from_numpy(rs.randn(2, 64, 64).astype(np.float32))
               .to(cuda) for _ in range(3))
    buf = torch.zeros(2 * 64 * 64 + 2, device=cuda)
    do = buf[2:].view(2, 64, 64)
    o, lse = fa.flash_fwd(q, k, v)
    delta = fa.flash_delta(o, do)
    before = dict(fa.launch_count)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_dkv(q, k, v, do, lse, delta)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_dq(q, k, v, do, lse, delta)
    assert fa.launch_count == before
    dq = fa.flash_dq(q, k, v, do.clone(), lse, delta)
    dk, dv = fa.flash_dkv(q, k, v, do.clone(), lse, delta)
    torch.cuda.synchronize()
    assert fa.launch_count == {**before, "dq_3xtf32": before["dq_3xtf32"] + 1,
                               "dkv_3xtf32": before["dkv_3xtf32"] + 1}
    assert all(torch.isfinite(x).all() for x in (dq, dk, dv))


@pytest.mark.gpu
@pytest.mark.parametrize("t", [1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 127,
                               128, 129, 2048])
@pytest.mark.parametrize("d", [40, 64, 128])
def test_cuda_3xtf32_dq_tile_edges(cuda, t, d):
    """K2 in f32 on its three-pass kernel at its tile edges (T of 1, one
    row short of, at and one row past a 16-key tile, a 32-key tile and a
    64-row q tile, and 2048; D 40 on the 64-column instance), fed the
    three-pass forward's LSE: dQ row by row within 1e-4 of the plain
    version, one launch through "dq_3xtf32". At T 1, and on every first
    row, dQ is 0 up to the rounding of dP (p = 1, dP = delta)."""
    rs = np.random.RandomState(14)
    bh = 2 if t == 2048 else 3
    q, k, v, do = (torch.from_numpy(rs.randn(bh, t, d).astype(np.float32))
                   .to(cuda) for _ in range(4))
    assert fa.dq_route(q) == "dq_3xtf32"
    o, lse = fa.flash_fwd(q, k, v, block_q=t, block_k=t)
    delta = fa.flash_delta(o, do)
    before = dict(fa.launch_count)
    dq = fa.flash_dq(q, k, v, do, lse, delta, block_q=t, block_k=t)
    torch.cuda.synchronize()
    assert fa.launch_count == {**before,
                               "dq_3xtf32": before["dq_3xtf32"] + 1}
    want = fa.flash_dq_ref(q, k, v, do, lse, delta, t, t)
    assert fa.rowwise_rel_err(dq, want) <= 1e-4


@pytest.mark.gpu
def test_cuda_3xtf32_dq_refuses_misaligned_views(cuda):
    """An f32 K view 8 bytes into its storage: K2 on the three-pass route
    raises before any launch, and runs on an aligned copy of it within
    1e-4 of the plain version."""
    rs = np.random.RandomState(15)
    q, v, do = (torch.from_numpy(rs.randn(2, 64, 40).astype(np.float32))
                .to(cuda) for _ in range(3))
    buf = torch.zeros(2 * 64 * 40 + 2, device=cuda)
    k = buf[2:].view(2, 64, 40)
    k.copy_(torch.from_numpy(rs.randn(2, 64, 40).astype(np.float32)))
    o, lse = fa.flash_fwd(q, k.clone(), v)
    delta = fa.flash_delta(o, do)
    before = dict(fa.launch_count)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_dq(q, k, v, do, lse, delta)
    assert fa.launch_count == before
    dq = fa.flash_dq(q, k.clone(), v, do, lse, delta)
    torch.cuda.synchronize()
    assert fa.launch_count == {**before,
                               "dq_3xtf32": before["dq_3xtf32"] + 1}
    want = fa.flash_dq_ref(q, k, v, do, lse, delta, 64, 64)
    assert fa.rowwise_rel_err(dq, want) <= 1e-4


_NEW_WIDTHS = [(torch.bfloat16, d) for d in (8, 24, 40, 56, 72, 104, 120)] \
    + [(torch.float32, d) for d in (8, 16, 24, 40, 48, 56, 72, 80, 104, 112,
                                    120)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d", _NEW_WIDTHS,
                         ids=[f"{str(dt)[6:]}-{d}" for dt, d in _NEW_WIDTHS])
def test_cuda_forward_takes_every_head(cuda, dtype, d):
    """The tensor-core forwards at the head sizes the old shape rule sent
    to the FMA forward (bf16 D % 16 != 0, f32 D % 32 != 0), each on its
    64- or 128-column instance with the columns past D zero-filled, at T
    of 1, one row short of, at and one row past a 32-key tile, a 64-key
    tile and a 128-row block: O and LSE row by row within 1e-4 (f32) or
    1e-2 (bf16) of the plain version, one launch each; in f32 K2 on its
    three-pass kernel too, fed the forward's LSE, within 1e-4."""
    rs = np.random.RandomState(16)
    route = "fwd_tc" if dtype == torch.bfloat16 else "fwd_3xtf32"
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for t in (1, 31, 32, 33, 63, 64, 65, 127, 128, 129):
        q, k, v, do = (torch.from_numpy(rs.randn(3, t, d).astype(np.float32))
                       .to(cuda, dtype) for _ in range(4))
        assert fa.fwd_route(q) == route
        before = dict(fa.launch_count)
        o, lse = fa.flash_fwd(q, k, v, block_q=t, block_k=t)
        torch.cuda.synchronize()
        assert fa.launch_count == {**before, route: before[route] + 1}
        want_o, want_lse = fa.flash_fwd_ref(q, k, v, t, t)
        assert fa.rowwise_rel_err(o, want_o) <= tol, t
        assert fa.rowwise_rel_err(lse, want_lse) <= tol, t
        if dtype == torch.float32:
            delta = fa.flash_delta(o, do)
            dq = fa.flash_dq(q, k, v, do, lse, delta, block_q=t, block_k=t)
            want_dq = fa.flash_dq_ref(q, k, v, do, lse, delta, t, t)
            assert fa.rowwise_rel_err(dq, want_dq) <= tol, t


_BWD_HEADS = [(torch.bfloat16, d) for d in (8, 24, 40, 56, 72, 88, 104,
                                              120)] \
    + [(torch.float32, d) for d in (8, 16, 24, 40, 48, 56, 72, 80, 88, 104,
                                    112, 120)]
_BWD_T = [1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 127, 128, 129]


@pytest.mark.gpu
@pytest.mark.parametrize("t", _BWD_T)
@pytest.mark.parametrize("dtype,d", _BWD_HEADS,
                         ids=[f"{str(dt)[6:]}-{d}" for dt, d in _BWD_HEADS])
def test_cuda_backward_takes_every_head(cuda, dtype, d, t):
    """K2 and K3 at the head sizes the old shape rule sent to the deleted
    FMA kernels (bf16 D % 16 != 0: the last k16 step of S and dP reads 8
    real columns and 8 zero-filled ones; f32 D % 32 != 0: Q^T and dO^T
    rows past D zero), each on the 64- or 128-column instance of its
    tensor-core kernel, at T of 1, one row short of, at and one row past a
    16-row tile, a 32-key tile, a 64-row tile and a 128-row block: one
    launch of the named key per pass, and dQ, dK and dV row by row within
    1e-4 (f32) or 1e-2 (bf16) of the plain versions fed the same LSE and
    delta. At T 1 dQ and dK are 0 up to the rounding of dP."""
    rs = np.random.RandomState(17)
    q, k, v, do = (torch.from_numpy(rs.randn(3, t, d).astype(np.float32))
                   .to(cuda, dtype) for _ in range(4))
    bf16 = dtype == torch.bfloat16
    assert (fa.dq_route(q), fa.dkv_route(q)) == \
        (("dq_tc", "dkv_tc") if bf16 else ("dq_3xtf32", "dkv_3xtf32"))
    o, lse = fa.flash_fwd(q, k, v, block_q=t, block_k=t)
    delta = fa.flash_delta(o, do)
    before = dict(fa.launch_count)
    dq = fa.flash_dq(q, k, v, do, lse, delta, block_q=t, block_k=t)
    torch.cuda.synchronize()
    assert fa.launch_count == {**before, fa.dq_route(q):
                               before[fa.dq_route(q)] + 1}
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, block_q=t, block_k=t)
    torch.cuda.synchronize()
    assert fa.launch_count == {**before,
                               fa.dq_route(q): before[fa.dq_route(q)] + 1,
                               fa.dkv_route(q): before[fa.dkv_route(q)] + 1}
    want_dq = fa.flash_dq_ref(q, k, v, do, lse, delta, t, t)
    want_dk, want_dv = fa.flash_dkv_ref(q, k, v, do, lse, delta, t, t)
    tol = 1e-2 if bf16 else 1e-4
    for name, got, want in (("dq", dq, want_dq), ("dk", dk, want_dk),
                            ("dv", dv, want_dv)):
        assert fa.rowwise_rel_err(got, want) <= tol, name


@pytest.mark.gpu
@pytest.mark.parametrize("t", [1, 2, 2048])
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_tensor_core_backward_tile_edges(cuda, t, d):
    """The bf16 tensor-core K2 and K3 alone at the edges of T (one row,
    two rows, and 2048) on both instances, fed the plain forward's LSE: one
    launch of "dq_tc" and one of "dkv_tc", and dQ, dK and dV row by row
    within 1e-2 of the plain versions. At T 1 dQ and dK are 0 up to the
    rounding of dP."""
    rs = np.random.RandomState(18)
    bh = 2 if t == 2048 else 3
    q, k, v, do = (torch.from_numpy(rs.randn(bh, t, d).astype(np.float32))
                   .to(cuda, torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_fwd_ref(q, k, v, min(t, 512), min(t, 1024))
    delta = fa.flash_delta(o, do)
    before = dict(fa.launch_count)
    dq = fa.flash_dq(q, k, v, do, lse, delta)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    assert fa.launch_count == {**before, "dq_tc": before["dq_tc"] + 1,
                               "dkv_tc": before["dkv_tc"] + 1}
    bq, bk = min(t, 512), min(t, 1024)
    want_dq = fa.flash_dq_ref(q, k, v, do, lse, delta, bq, bk)
    want_dk, want_dv = fa.flash_dkv_ref(q, k, v, do, lse, delta, bq, bk)
    for name, got, want in (("dq", dq, want_dq), ("dk", dk, want_dk),
                            ("dv", dv, want_dv)):
        assert fa.rowwise_rel_err(got, want) <= 1e-2, name


def test_forward_route_rule():
    """Every head of the contract takes a tensor-core forward: bf16 the
    one-pass kernel, f32 the three-pass TF32 kernel, at any D % 8 == 0
    (the heads of D 40, 8 and 16 on the 64-column instance)."""
    for d, dt, want in ((128, torch.bfloat16, "fwd_tc"),
                        (64, torch.bfloat16, "fwd_tc"),
                        (16, torch.bfloat16, "fwd_tc"),
                        (40, torch.bfloat16, "fwd_tc"),
                        (8, torch.bfloat16, "fwd_tc"),
                        (128, torch.float32, "fwd_3xtf32"),
                        (64, torch.float32, "fwd_3xtf32"),
                        (40, torch.float32, "fwd_3xtf32"),
                        (16, torch.float32, "fwd_3xtf32"),
                        (8, torch.float32, "fwd_3xtf32")):
        assert fa.fwd_route(torch.zeros((1, 4, d), dtype=dt)) == want


@pytest.mark.parametrize("d,dtype,want_dq,want_dkv", [
    (128, torch.bfloat16, "dq_tc", "dkv_tc"),
    (64, torch.bfloat16, "dq_tc", "dkv_tc"),
    (16, torch.bfloat16, "dq_tc", "dkv_tc"),
    (40, torch.bfloat16, "dq_tc", "dkv_tc"),
    (8, torch.bfloat16, "dq_tc", "dkv_tc"),
    (120, torch.bfloat16, "dq_tc", "dkv_tc"),
    (128, torch.float32, "dq_3xtf32", "dkv_3xtf32"),
    (64, torch.float32, "dq_3xtf32", "dkv_3xtf32"),
    (32, torch.float32, "dq_3xtf32", "dkv_3xtf32"),
    (40, torch.float32, "dq_3xtf32", "dkv_3xtf32"),
    (24, torch.float32, "dq_3xtf32", "dkv_3xtf32"),
    (16, torch.float32, "dq_3xtf32", "dkv_3xtf32"),
    (8, torch.float32, "dq_3xtf32", "dkv_3xtf32")])
def test_backward_route_rule(d, dtype, want_dq, want_dkv):
    """Every head of the contract (D <= 128, D % 8 == 0) takes the
    tensor-core K2 and K3: bf16 the one-pass kernels, f32 the three-pass
    TF32 ones, on the 64- or 128-column instance (heads of D 40, 24, 16
    and 8 on the 64-column one, D 120 on the 128-column one). The forward
    takes the tensor cores too."""
    q = torch.zeros((1, 4, d), dtype=dtype)
    assert fa.dq_route(q) == want_dq
    assert fa.dkv_route(q) == want_dkv
    assert fa.fwd_route(q) == ("fwd_tc" if dtype == torch.bfloat16
                               else "fwd_3xtf32")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,bh,t,d", [(2, 3, 130, 40), (3, 2, 65, 128),
                                      (2, 4, 256, 64)])
def test_cuda_vmap_fold_is_the_per_client_launches(cuda, dtype, g, bh, t,
                                                   d):
    """A vmapped group through the kernels: the forward and the gradients
    of `vmap(grad(...))` bitwise G separate launches (a bh row depends on
    no other), one launch of K1 for the forward, and K1, K2 and K3 once
    each for the gradient, whatever G."""
    rs = np.random.RandomState(10)
    q, k, v, do = (torch.from_numpy(rs.randn(g, bh, t, d).astype(np.float32))
                   .to(cuda, dtype) for _ in range(4))

    def loss(q_, k_, v_, do_):
        return (fa.flash_attention(q_, k_, v_).float() * do_.float()).sum()

    grad = torch.func.grad(loss, argnums=(0, 1, 2))
    before = dict(fa.launch_count)
    o = torch.func.vmap(fa.flash_attention)(q, k, v)
    grads = torch.func.vmap(grad)(q, k, v, do)
    torch.cuda.synchronize()
    routes = (fa.fwd_route(q), fa.dq_route(q), fa.dkv_route(q))
    assert fa.launch_count == {
        n: before[n] + (2 if n == routes[0] else int(n in routes))
        for n in before}
    for i in range(g):
        assert torch.equal(o[i], fa.flash_attention(q[i], k[i], v[i]))
        for got, want in zip(grads, grad(q[i], k[i], v[i], do[i])):
            assert torch.equal(got[i], want)
