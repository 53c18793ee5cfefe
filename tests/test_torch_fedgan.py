"""The port's GAN pair (`fedml_tpu_torch/models/gan.py`) and FedGAN
(`algorithms/fedgan.py`) against the JAX package's, on the CPU.

The pair is built from the flax parameters (`params_from_flax`) and held
to the flax outputs within 1e-5 at img_size 8 (no crop, even sizes) and
30 (the Generator crops 32 -> 30; the Discriminator's "SAME" convs pad
15 -> 8 asymmetrically). One FedGAN round through the port's
`build_round_fn` gets JAX's initial parameters and JAX's draws (each
step's real rows and both noise batches, from the JAX client's
`fold_in` keys) as its schedule, and agrees with the JAX round within
1e-3 of the largest parameter update (the repo's rule for rounds).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.fedgan import init_gan_params as jax_init_gan
from fedml_tpu.algorithms.fedgan import make_fedgan as jax_make_fedgan
from fedml_tpu.config import TrainArgs as JaxTrainArgs
from fedml_tpu.models import hub as jax_hub
from fedml_tpu.parallel.round import build_round_fn as jax_build_round_fn

from fedml_tpu_torch.algorithms.builtin import build_algorithm
from fedml_tpu_torch.algorithms.fedgan import init_gan_params, make_fedgan
from fedml_tpu_torch.config import TrainArgs
from fedml_tpu_torch.core.registry import ALGORITHMS
from fedml_tpu_torch.models import hub
from fedml_tpu_torch.models.gan import Discriminator, Generator
from fedml_tpu_torch.parallel.round import build_round_fn

torch.set_num_threads(2)

FWD_TOL = 1e-5
ROUND_TOL = 1e-3


def _flax(p):
    return hub.params_from_flax(p, device="cpu")


@pytest.mark.parametrize("img_size,width,latent", [(8, 8, 8), (30, 16, 12)])
def test_gan_pair_forward_matches_flax(img_size, width, latent):
    jm = jax_hub.create("gan", 0, img_size=img_size, width=width,
                        latent=latent)
    jp = jax_init_gan(jm, (img_size, img_size, 1), jax.random.key(1),
                      latent=latent)
    m = hub.create("gan", 0, img_size=img_size, width=width, latent=latent,
                   device="cpu")
    assert isinstance(m["generator"], Generator)
    assert isinstance(m["discriminator"], Discriminator)
    g, d = _flax(jp["g"]), _flax(jp["d"])
    assert set(g) == {n for n, _ in m["generator"].named_parameters()}
    assert set(d) == {n for n, _ in m["discriminator"].named_parameters()}
    rs = np.random.RandomState(img_size)
    z = rs.randn(5, latent).astype(np.float32)
    img = np.tanh(rs.randn(5, img_size, img_size, 1)).astype(np.float32)
    want_fake = np.asarray(jm["generator"].apply({"params": jp["g"]},
                                                 jnp.asarray(z)))
    fake = hub.apply_fn(m["generator"])(g, torch.from_numpy(z))
    assert fake.shape == (5, img_size, img_size, 1)
    np.testing.assert_allclose(fake.detach().numpy(), want_fake,
                               rtol=FWD_TOL, atol=FWD_TOL)
    for x in (img, want_fake):
        want = np.asarray(jm["discriminator"].apply({"params": jp["d"]},
                                                    jnp.asarray(x)))
        got = hub.apply_fn(m["discriminator"])(d, torch.from_numpy(
            np.array(x)))
        assert got.shape == (5,)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=FWD_TOL,
                                   atol=FWD_TOL)


def test_hub_create_gan_defaults():
    m = hub.create("gan", 0, device="meta")
    g, d = m["generator"], m["discriminator"]
    assert (g.img_size, g.channels, g.latent, g.width) == (28, 1, 64, 64)
    # 28 -> 14 -> 7: the discriminator's Dense reads 7 x 7 x 128
    assert tuple(d.Dense_0.kernel.shape) == (7 * 7 * 128, 1)
    assert "fedgan" in ALGORITHMS


def test_config_path_raises_jax_value_error():
    with pytest.raises(ValueError, match="construct it directly"):
        build_algorithm("FedGAN", lambda p, x: x, TrainArgs())


# width 16: GroupNorm(8) then holds two channels a group. At width 8 each
# group is one channel, GroupNorm cancels the bias of the ConvTranspose
# before it, that bias's gradient is rounding noise (~1e-9) in both
# packages, and Adam's first step (g / (|g| + eps), a sign step of lr)
# turns the noise into +-lr on either side
N, S, B, LATENT, IMG, WIDTH = 3, 16, 8, 8, 8, 16


def _jax_draws(seed: int, ids) -> dict:
    """The JAX client's draws: step i's rows from fold_in(rng_c, 2i), its
    noise from fold_in(rng_c, 2i + 1) and that folded with 7, rng_c =
    fold_in(round key, client id)."""
    steps = S // B
    out = {"idx": [], "z_d": [], "z_g": []}
    for c in ids:
        rc = jax.random.fold_in(jax.random.key(seed), int(c))
        rows, zd, zg = [], [], []
        for i in range(steps):
            r1 = jax.random.fold_in(rc, 2 * i)
            r2 = jax.random.fold_in(rc, 2 * i + 1)
            rows.append(np.asarray(jax.random.choice(r1, S, (B,),
                                                     replace=False)))
            zd.append(np.asarray(jax.random.normal(r2, (B, LATENT))))
            zg.append(np.asarray(jax.random.normal(
                jax.random.fold_in(r2, 7), (B, LATENT))))
        for k, v in (("idx", rows), ("z_d", zd), ("z_g", zg)):
            out[k].append(np.stack(v))
    return {k: torch.from_numpy(np.stack(v)) for k, v in out.items()}


@pytest.fixture(scope="module")
def rounds():
    jm = jax_hub.create("gan", 0, img_size=IMG, latent=LATENT, width=WIDTH)
    jt = JaxTrainArgs(epochs=1, batch_size=B, learning_rate=2e-3)
    jalg = jax_make_fedgan(jm, jt, latent=LATENT)
    jp = jax_init_gan(jm, (IMG, IMG, 1), jax.random.key(0), latent=LATENT)
    rs = np.random.RandomState(0)
    data = {"x": np.tanh(rs.randn(N, S, IMG, IMG, 1)).astype(np.float32),
            "y": np.zeros((N, S), np.int32),
            "mask": np.ones((N, S), np.float32)}
    data["mask"][1, -4:] = 0.0
    weights = np.array([16.0, 12.0, 16.0], np.float32)
    ids = np.arange(N)
    # the JAX round donates its server state: convert first
    p0 = {"g": _flax(jp["g"]), "d": _flax(jp["d"])}
    out = jax_build_round_fn(jalg, mesh=None)(
        jalg.server_init(jp, None), jnp.zeros((N,)),
        {k: jnp.asarray(v) for k, v in data.items()}, jnp.asarray(ids),
        jnp.asarray(weights), jax.random.key(3), None)

    m = hub.create("gan", 0, img_size=IMG, latent=LATENT, width=WIDTH,
                   device="meta")
    alg = make_fedgan(m, TrainArgs(epochs=1, batch_size=B,
                                   learning_rate=2e-3), latent=LATENT)
    tdata = {k: torch.from_numpy(v) for k, v in data.items()}
    res = {}
    for g in (1, 3):
        o = build_round_fn(alg, group_size=g)(
            alg.server_init(p0), None, tdata, ids, weights, seed=3,
            batch_idx=_jax_draws(3, ids))
        res[g] = o
    return {"jout": out, "out": res, "p0": p0, "alg": alg, "tdata": tdata,
            "models": m}


@pytest.mark.parametrize("g", [1, 3])
def test_fedgan_round_matches_jax(rounds, g):
    o, jo, p0 = rounds["out"][g], rounds["jout"], rounds["p0"]
    for part in ("g", "d"):
        want = _flax(jo.server_state.params[part])
        got = o.server_state.params[part]
        update = max(float((want[k] - p0[part][k]).abs().max())
                     for k in want)
        diff = max(float((got[k] - want[k]).abs().max()) for k in want)
        assert update > 0 and diff <= ROUND_TOL * update, (part, diff,
                                                           update)
    assert abs(float(o.metrics["train_loss"])
               - float(jo.metrics["train_loss"])) <= 1e-4
    assert float(o.metrics["n_samples"]) == float(jo.metrics["n_samples"])
    assert o.server_state.round == 1


def test_fedgan_default_draws_run_in_vmapped_groups(rounds):
    """The port's own draws ({"idx", "z_d", "z_g"}, from the client's
    generator outside vmap) have the JAX shapes, depend only on (seed,
    client id), and drive a G = 3 round that repeats bit for bit and
    moves both networks."""
    from fedml_tpu_torch.parallel.round import client_generator, \
        draw_schedules

    alg, tdata, p0 = rounds["alg"], rounds["tdata"], rounds["p0"]
    ids, w = np.arange(N), np.ones(N, np.float32)
    sched = alg.schedule(client_generator(5, 1), S)
    assert sched["idx"].shape == (S // B, B)
    assert sched["z_d"].shape == sched["z_g"].shape == (S // B, B, LATENT)
    assert all(len(set(r.tolist())) == B for r in sched["idx"])
    stacked = draw_schedules(alg, 5, ids, S)
    for k, v in sched.items():
        assert torch.equal(stacked[k][1], v)
    outs = [build_round_fn(alg, group_size=3)(
        alg.server_init(p0), None, tdata, ids, w, seed=5) for _ in range(2)]
    for part in ("g", "d"):
        a, b = (o.server_state.params[part] for o in outs)
        assert all(torch.equal(a[k], b[k]) for k in a)
        assert any(not torch.equal(a[k], p0[part][k]) for k in a)
        assert all(torch.isfinite(v).all() for v in a.values())


def test_init_gan_params_checks_the_pair(rounds):
    m = rounds["models"]
    p = init_gan_params(m, (IMG, IMG, 1), torch.Generator().manual_seed(0),
                        latent=LATENT)
    assert set(p) == {"g", "d"}
    with pytest.raises(ValueError, match="generator's"):
        init_gan_params(m, (28, 28, 1), torch.Generator(), latent=LATENT)
