"""Differential privacy on the round (port of `fedml_tpu/dp/__init__.py`).

- LDP: clip each client's update to `clipping_norm` (global L2) and noise
  it, in the round's `postprocess_update` hook (`parallel/round.py`).
- CDP: clip each client's update; noise the aggregate once
  (`postprocess_agg`), calibrated to the largest normalised aggregation
  weight a client can have.
- NbAFL: per-coordinate clip and local noise, and down-link noise on the
  aggregate when T > sqrt(N) * m, divided by the smallest local dataset.
- dp_clip: the clip alone.

Hooks take a key (`ops/keys.py`): a client's transform draws from a
generator of (seed, round, client id, salts), the aggregate's from the
Simulator's server key. Budget tracking is the RDP accountant
(`accountant.py`), stepped once a round.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from ..config import Config, DPArgs
from ..ops import keys
from ..ops.tree import tree_clip_by_global_norm, tree_leaves, tree_map
from ..utils import metrics as mx
from .accountant import RDPAccountant
from .mechanisms import (
    add_gaussian_noise, add_laplace_noise, gaussian_sigma, laplace_scale,
    make_mechanism,
)

Tree = Any

LDP = "ldp"
CDP = "cdp"
NBAFL = "nbafl"
DP_CLIP = "dp_clip"


def _coord_clip(tree: Tree, c: float) -> Tree:
    """Per-coordinate clip: x / max(1, |x| / c)."""
    return tree_map(lambda x: x / torch.clamp(torch.abs(x) / c, min=1.0),
                    tree)


def _device(tree: Tree) -> torch.device:
    return tree_leaves(tree)[0].device


class FedDP:
    """The DP pipeline of a config; attach `client_transform` and
    `server_transform` to the round."""

    def __init__(self, d: DPArgs, client_num_per_round: int,
                 client_num_in_total: int, comm_round: int,
                 counts: Optional[np.ndarray] = None):
        self.args = d
        self.solution = (d.dp_solution_type or LDP).lower()
        self.m = client_num_per_round
        self.n = client_num_in_total
        self.T = comm_round
        self.enabled = bool(d.enable_dp)
        self.accountant: Optional[RDPAccountant] = None
        # sample counts calibrate NbAFL's down-link divisor (the smallest
        # local dataset) and CDP's sensitivity (the largest normalised
        # weight: the heaviest client sampled with the m - 1 lightest)
        cts = None
        if counts is not None:
            cts = np.asarray(counts, np.float64)
            cts = cts[cts > 0]
        self.min_local_n = (
            float(cts.min()) if cts is not None and cts.size
            else float(max(self.m, 1)))
        if cts is not None and cts.size and self.m > 1:
            srt = np.sort(cts)
            lightest = srt[:-1][: self.m - 1].sum()
            self.max_weight_frac = float(
                srt[-1] / max(srt[-1] + lightest, 1e-12))
        else:
            self.max_weight_frac = 1.0 / max(self.m, 1)
        if not self.enabled:
            return
        if d.mechanism_type.lower() == "gaussian":
            self._sigma = gaussian_sigma(d.epsilon, d.delta, d.sensitivity)
            self._noise = add_gaussian_noise
            q = min(1.0, self.m / max(self.n, 1))
            # accounted only where the noise / sensitivity ratio is known:
            # LDP (the clip bounds the update) and CDP (sigma and the
            # sensitivity scale together); dp_clip adds no noise and
            # NbAFL's L2 sensitivity is unknown, so their epsilon is NaN
            if self.solution == LDP:
                self.accountant = RDPAccountant(
                    noise_multiplier=self._sigma / max(d.clipping_norm, 1e-12),
                    sampling_rate=q, target_delta=d.delta)
            elif self.solution == CDP:
                self.accountant = RDPAccountant(
                    noise_multiplier=self._sigma / max(d.sensitivity, 1e-12),
                    sampling_rate=q, target_delta=d.delta)
        else:
            self._sigma = laplace_scale(d.epsilon, d.sensitivity)
            self._noise = add_laplace_noise

    def _noised(self, tree: Tree, key, scale: float) -> Tree:
        return self._noise(keys.generator(key, _device(tree)), tree, scale)

    def client_transform(self) -> Optional[Callable[[Tree, tuple], Tree]]:
        """(update, key) -> update, one client's."""
        if not self.enabled:
            return None
        d = self.args
        if self.solution == LDP:
            return lambda upd, key: self._noised(
                tree_clip_by_global_norm(upd, d.clipping_norm), key,
                self._sigma)
        if self.solution == NBAFL:
            return lambda upd, key: self._noised(
                _coord_clip(upd, d.clipping_norm), key, self._sigma)
        if self.solution in (DP_CLIP, CDP):
            # CDP clips on the client and noises the aggregate
            return lambda upd, key: tree_clip_by_global_norm(
                upd, d.clipping_norm)
        raise ValueError(f"unknown dp_solution_type {self.solution!r}")

    def server_transform(self) -> Optional[Callable[[Tree, tuple], Tree]]:
        """(aggregate, key) -> aggregate: the global noise."""
        if not self.enabled:
            return None
        d = self.args
        if self.solution == CDP:
            # the weighted mean of norm-C updates moves by at most
            # C * max_weight_frac: the configured sensitivity divided out
            sigma = (self._sigma / max(d.sensitivity, 1e-12)) \
                * d.clipping_norm * self.max_weight_frac
            return lambda agg, key: self._noised(agg, key, sigma)
        if self.solution == NBAFL and self.T > np.sqrt(self.n) * self.m:
            c_small = np.sqrt(2 * np.log(1.25 / d.delta))
            scale_d = (
                2 * c_small * d.clipping_norm
                * np.sqrt(self.T**2 - self.m**2 * self.n)
                / (max(self.n, 1) * d.epsilon)
            ) / max(self.min_local_n, 1.0)
            return lambda agg, key: self._noised(agg, key, float(scale_d))
        return None

    def step_round(self) -> None:
        if self.accountant is not None:
            self.accountant.step()

    def get_epsilon(self) -> float:
        return self.accountant.get_epsilon() if self.accountant \
            else float("nan")


def from_config(cfg: Config, counts: Optional[np.ndarray] = None) -> FedDP:
    t = cfg.train_args
    return FedDP(cfg.dp_args, t.client_num_per_round, t.client_num_in_total,
                 t.comm_round, counts=counts)


class SiloUploadDP:
    """Client-side DP for the cross-silo upload: clip and noise the update
    (trained - received parameters) before it leaves the trainer, then
    params = received + noised update. It runs before any wire codec, so
    compression is post-processing and leaves the accountant alone. The
    noise is keyed by (seed, round): a re-send of a round re-noises to the
    same value, and the accountant steps once per distinct round."""

    def __init__(self, dp: FedDP, seed: int = 0):
        self.dp = dp
        self._f = dp.client_transform()
        self.seed = int(seed)
        self._stepped_rounds: set = set()

    def apply(self, new_params: Tree, base_params: Tree,
              round_idx: int) -> Tree:
        if self._f is None:
            return new_params
        delta = tree_map(lambda a, b: torch.as_tensor(a) - torch.as_tensor(b),
                         new_params, base_params)
        noised = self._f(delta, (self.seed, int(round_idx)))
        out = tree_map(lambda b, d: torch.as_tensor(b) + d, base_params,
                       noised)
        if round_idx not in self._stepped_rounds:
            self._stepped_rounds.add(round_idx)
            self.dp.step_round()
        eps = self.dp.get_epsilon()
        if np.isfinite(eps):
            mx.set_gauge("fed.client.dp_epsilon", eps)
        return out

    def epsilon(self) -> float:
        return self.dp.get_epsilon()


def make_upload_dp(cfg: Config, seed: int = 0) -> Optional[SiloUploadDP]:
    """The cross-silo client's upload DP stage, or None when DP is off or
    central (CDP noises the aggregate on the server)."""
    if not cfg.dp_args.enable_dp:
        return None
    if (cfg.dp_args.dp_solution_type or LDP).lower() == CDP:
        return None
    return SiloUploadDP(from_config(cfg), seed=seed)
