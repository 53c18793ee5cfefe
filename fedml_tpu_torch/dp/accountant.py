"""RDP accountant for the sampled Gaussian mechanism (a copy of
`fedml_tpu/dp/accountant.py`, numpy and math only, held to it bitwise).

Numpy reimplementation of the standard Renyi-DP moments accountant the
reference vendors (reference: core/dp/budget_accountant/rdp_accountant.py,
178 LoC; originally the Mironov/TF-privacy analysis). Tracks RDP at a grid of
orders across FL rounds, converts to (epsilon, delta).

Math (public, standard):
- q = client sampling rate per round, z = noise multiplier (sigma/sensitivity).
- q == 1:  rdp(a) = a / (2 z^2).
- q < 1:   log-moment bound via the binomial expansion
           A(a) = log sum_{i=0..a} C(a,i) (1-q)^(a-i) q^i exp((i^2-i)/(2 z^2))
           rdp(a) = A(a) / (a - 1)   (integer orders; fractional orders use the
           quadrature-free upper bound at ceil/floor interpolation).
- composition over T rounds: rdp *= T.
- conversion: eps(delta) = min_a rdp(a) + log(1/delta)/(a-1)  (improved
  conversion of Canonne-Kamath-Steinke also computed; we take the tighter).
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np

DEFAULT_ORDERS: tuple = tuple([1 + x / 10.0 for x in range(1, 100)] + list(range(12, 64)))


def _log_add(a: float, b: float) -> float:
    if a == -np.inf:
        return b
    if b == -np.inf:
        return a
    m, n = max(a, b), min(a, b)
    return m + math.log1p(math.exp(n - m))


def _rdp_int_order(q: float, z: float, alpha: int) -> float:
    """RDP of sampled Gaussian at integer order alpha (log-moment bound)."""
    log_a = -np.inf
    for i in range(alpha + 1):
        log_coef = (
            math.lgamma(alpha + 1)
            - math.lgamma(i + 1)
            - math.lgamma(alpha - i + 1)
            + i * math.log(q)
            + (alpha - i) * math.log1p(-q)
        )
        log_a = _log_add(log_a, log_coef + (i * i - i) / (2.0 * z * z))
    return log_a / (alpha - 1)


def compute_rdp(q: float, noise_multiplier: float, steps: int,
                orders: Sequence[float] = DEFAULT_ORDERS) -> np.ndarray:
    """Per-order RDP of `steps` compositions of the sampled Gaussian mechanism
    (reference: rdp_accountant.py `compute_rdp`)."""
    z = float(noise_multiplier)
    if z == 0:
        return np.full(len(orders), np.inf)
    out = []
    for a in orders:
        if q >= 1.0:
            rdp = a / (2 * z * z)
        elif a == math.floor(a) and a > 1:
            rdp = _rdp_int_order(q, z, int(a))
        else:
            lo, hi = int(math.floor(a)), int(math.ceil(a))
            if lo <= 1:
                rdp = _rdp_int_order(q, z, max(hi, 2))
            else:
                r_lo, r_hi = _rdp_int_order(q, z, lo), _rdp_int_order(q, z, hi)
                t = a - lo
                rdp = (1 - t) * r_lo + t * r_hi  # RDP is convex in alpha; chord is an upper bound
        out.append(rdp * steps)
    return np.asarray(out)


def get_privacy_spent(orders: Sequence[float], rdp: np.ndarray,
                      target_delta: float) -> tuple[float, float]:
    """(epsilon, optimal_order) at target_delta (reference: rdp_accountant.py
    `get_privacy_spent`), using the standard and the CKS-improved conversion,
    whichever is tighter per order."""
    orders = np.asarray(orders, dtype=float)
    rdp = np.asarray(rdp, dtype=float)
    eps_std = rdp + math.log(1.0 / target_delta) / (orders - 1)
    with np.errstate(invalid="ignore", divide="ignore"):
        # Canonne-Kamath-Steinke 2020, Thm 21
        eps_cks = rdp + np.log1p(-1.0 / orders) - (
            np.log(target_delta) + np.log(orders)
        ) / (orders - 1)
    eps = np.minimum(eps_std, np.where(np.isnan(eps_cks), np.inf, eps_cks))
    idx = int(np.nanargmin(eps))
    return float(max(eps[idx], 0.0)), float(orders[idx])


class RDPAccountant:
    """Round-by-round accountant (reference: RDP_Accountant class,
    rdp_accountant.py — held by FedMLDifferentialPrivacy and stepped per
    aggregation, fedml_differential_privacy.py:73-100)."""

    def __init__(self, noise_multiplier: float, sampling_rate: float,
                 target_delta: float = 1e-5,
                 orders: Sequence[float] = DEFAULT_ORDERS):
        self.z = noise_multiplier
        self.q = sampling_rate
        self.delta = target_delta
        self.orders = tuple(orders)
        self.steps = 0

    def step(self, n: int = 1) -> None:
        self.steps += n

    def get_epsilon(self) -> float:
        if self.steps == 0:
            return 0.0
        rdp = compute_rdp(self.q, self.z, self.steps, self.orders)
        eps, _ = get_privacy_spent(self.orders, rdp, self.delta)
        return eps
