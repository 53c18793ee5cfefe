"""DP noise mechanisms on trees of tensors (port of
`fedml_tpu/dp/mechanisms.py`).

Each noise function comes in two halves: a draw of standard noise from an
explicit `torch.Generator` (`draw_gaussian`, `draw_laplace`: one tensor a
leaf, f32, drawn leaf after leaf on the leaf's device) and an apply that
takes the noise (`apply_noise`: x + (scale * z) in x's dtype, the JAX
function's arithmetic). The analytic calibration sigma = sqrt(2 ln(1.25 /
delta)) * sensitivity / epsilon is kept, for epsilon <= 1.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from ..ops.tree import tree_map

Tree = Any
# the largest float32 below 1 is 1 - EPSNEG: JAX's laplace draws its
# uniform from [-1 + EPSNEG, 1), so log1p never sees -1
EPSNEG = 2.0 ** -24


def gaussian_sigma(epsilon: float, delta: float,
                   sensitivity: float = 1.0) -> float:
    """Analytic Gaussian calibration."""
    if epsilon <= 0 or delta <= 0:
        raise ValueError("epsilon and delta must be positive")
    if epsilon > 1.0:
        raise ValueError("analytic Gaussian calibration requires epsilon <= 1")
    return math.sqrt(2 * math.log(1.25 / delta)) * sensitivity / epsilon


def laplace_scale(epsilon: float, sensitivity: float = 1.0) -> float:
    """Laplace mechanism b = sensitivity / epsilon."""
    if epsilon <= 0:
        raise ValueError("epsilon must be positive")
    return sensitivity / epsilon


def draw_gaussian(gen: torch.Generator, tree: Tree) -> Tree:
    """Standard normal noise shaped like every leaf of `tree`."""
    return tree_map(lambda x: torch.randn(
        x.shape, generator=gen, device=x.device), tree)


def laplace_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """Standard Laplace noise from uniforms on [-1 + EPSNEG, 1):
    -sign(u) log1p(-|u|), JAX's inverse CDF."""
    return -torch.sign(u) * torch.log1p(-torch.abs(u))


def draw_laplace(gen: torch.Generator, tree: Tree) -> Tree:
    """Standard Laplace noise shaped like every leaf of `tree`."""
    lo = -1.0 + EPSNEG
    return tree_map(lambda x: laplace_from_uniform(
        lo + (1.0 - lo) * torch.rand(x.shape, generator=gen,
                                     device=x.device)), tree)


def apply_noise(tree: Tree, noise: Tree, scale: float) -> Tree:
    """x + (scale * z) cast to x's dtype, leaf by leaf."""
    return tree_map(lambda x, z: x + (scale * z).to(x.dtype), tree, noise)


def add_gaussian_noise(gen: torch.Generator, tree: Tree, sigma: float) -> Tree:
    return apply_noise(tree, draw_gaussian(gen, tree), sigma)


def add_laplace_noise(gen: torch.Generator, tree: Tree, scale: float) -> Tree:
    return apply_noise(tree, draw_laplace(gen, tree), scale)


def make_mechanism(name: str, epsilon: float, delta: float,
                   sensitivity: float):
    """name -> (generator, tree) -> noised tree."""
    name = (name or "gaussian").lower()
    if name == "gaussian":
        sigma = gaussian_sigma(epsilon, delta, sensitivity)
        return lambda gen, tree: add_gaussian_noise(gen, tree, sigma)
    if name == "laplace":
        b = laplace_scale(epsilon, sensitivity)
        return lambda gen, tree: add_laplace_noise(gen, tree, b)
    raise ValueError(f"unknown DP mechanism {name!r}")
