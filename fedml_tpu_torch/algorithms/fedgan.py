"""FedGAN, federated adversarial training (Rasouli et al. 2020; port of
`fedml_tpu/algorithms/fedgan.py`; reference: simulation/mpi/fedgan/).

A client update is a step function like every other algorithm's: the
payload is the {"g": ..., "d": ...} delta pair, so the round engine
(`parallel/round.py`) averages both networks at once, and compression, DP
and the defenses apply unchanged. Local training alternates one
discriminator and one generator step of the non-saturating GAN loss,
each network with its own Adam (b1 0.5), fresh per client per round.

Client data: shard["x"] real images [S, H, W, C] in (-1, 1), shard["mask"]
marks the real rows (shard["y"] is not read).

Draws: JAX draws each step's real rows (without replacement) and its two
noise batches inside the step. The round runs client updates under
`torch.func.vmap(randomness="error")`, so here they are the algorithm's
schedule, drawn outside vmap from the client's generator: {"idx" [steps,
B], "z_d" [steps, B, latent], "z_g" [steps, B, latent]} (the tests hand
JAX's draws over as the round's `batch_idx`).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..config import TrainArgs
from ..core.algorithm import (
    ClientMetrics, FedAlgorithm, ServerState, make_client_optimizer,
)
from ..core.registry import ALGORITHMS
from ..models import hub
from ..ops.tree import tree_add, tree_sub


def _bce_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    return F.binary_cross_entropy_with_logits(
        logits, torch.full_like(logits, target))


def make_fedgan(models: dict, t: TrainArgs, latent: int = 64,
                d_steps: int = 1) -> FedAlgorithm:
    """`models`: {"generator", "discriminator"} (`hub.create("gan", ...)`).
    A client runs epochs x max(1, S // B) alternating D / G steps; the
    aggregate is the engine's weighted mean over both networks."""
    # f32, as the JAX algorithm applies both nets (no compute_dtype)
    gen_apply = hub.apply_fn(models["generator"])
    disc_apply = hub.apply_fn(models["discriminator"])
    g_opt = make_client_optimizer("adam", t.learning_rate, b1=0.5)
    d_opt = make_client_optimizer("adam", t.learning_rate, b1=0.5)

    def steps_of(shard_size: int) -> tuple[int, int]:
        bs = min(t.batch_size, shard_size)
        return t.epochs * max(1, shard_size // bs), bs

    def schedule(gen: torch.Generator, shard_size: int) -> dict:
        n_steps, bs = steps_of(shard_size)
        idx = torch.stack([torch.randperm(shard_size, generator=gen,
                                          device=gen.device)[:bs]
                           for _ in range(n_steps)])
        z = torch.randn((2, n_steps, bs, latent), generator=gen,
                        device=gen.device)
        return {"idx": idx, "z_d": z[0], "z_g": z[1]}

    def server_init(params, _cfg=None) -> ServerState:
        return ServerState(params, None, 0, None)

    def d_loss(dp, gp, real, m, z):
        fake = gen_apply(gp, z)
        lr_ = disc_apply(dp, real)
        lf = disc_apply(dp, fake)
        # padded rows are out of the real term's mean
        real_term = (F.binary_cross_entropy_with_logits(
            lr_, torch.ones_like(lr_), reduction="none") * m).sum() \
            / torch.clamp(m.sum(), min=1.0)
        loss = real_term + _bce_logits(lf, 0.0)
        return loss, loss

    def g_loss(gp, dp, z):
        loss = _bce_logits(disc_apply(dp, gen_apply(gp, z)), 1.0)
        return loss, loss

    d_grad = torch.func.grad(d_loss, has_aux=True)
    g_grad = torch.func.grad(g_loss, has_aux=True)

    def client_update(bcast, shard, client_state, sched):
        p = bcast["params"]
        gp, dp = p["g"], p["d"]
        g_state, d_state = g_opt.init(gp), d_opt.init(dp)
        losses, counts = [], []
        for i in range(sched["idx"].shape[0]):
            idx = sched["idx"][i]
            real, m = shard["x"][idx], shard["mask"][idx]
            dg, dl = d_grad(dp, gp, real, m, sched["z_d"][i])
            dp, d_state = d_opt.step(dp, dg, d_state, i + 1)
            gg, gl = g_grad(gp, dp, sched["z_g"][i])
            gp, g_state = g_opt.step(gp, gg, g_state, i + 1)
            losses.append(dl + gl)
            counts.append(m.sum())
        losses, counts = torch.stack(losses), torch.stack(counts)
        delta = {"g": tree_sub(gp, p["g"]), "d": tree_sub(dp, p["d"])}
        metrics = ClientMetrics((losses * counts).sum(),
                                torch.zeros_like(counts[0]), counts.sum())
        return delta, client_state, metrics

    def server_update(st: ServerState, mean_delta) -> ServerState:
        return dataclasses.replace(st, params=tree_add(st.params, mean_delta),
                                   round=st.round + 1)

    return FedAlgorithm("FedGAN", server_init, client_update, server_update,
                        schedule=schedule)


def init_gan_params(models: dict, img_shape: tuple,
                    generator: torch.Generator, latent: int = 64) -> dict:
    """{"g": generator params, "d": discriminator params} drawn from
    `generator` (the generator's first), at flax's initialisers."""
    gen = models["generator"]
    shape = (gen.img_size, gen.img_size, gen.channels)
    if tuple(img_shape) != shape or gen.latent != latent:
        raise ValueError(
            f"img_shape {tuple(img_shape)} / latent {latent} are not the "
            f"generator's {shape} / {gen.latent}: the discriminator takes "
            "the generator's images")
    return {"g": hub.init_params(gen, generator),
            "d": hub.init_params(models["discriminator"], generator)}


ALGORITHMS.register("FedGAN")(make_fedgan)
