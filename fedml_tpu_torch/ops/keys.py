"""Keys for the port's random draws.

A key is a tuple of non-negative ints, such as (random_seed, round,
client id, salt, ...): numpy's SeedSequence mixes its entries into the
32-bit seed of a `torch.Generator` (a CPU generator reads only the low 32
bits). The JAX package derives its draws with `jax.random.fold_in`; the
port's keys play that part, so every draw is deterministic per key and
independent of how the cohort is grouped or chunked, but its bits are not
JAX's.
"""
from __future__ import annotations

import numpy as np
import torch

# the aggregate's place in a key where a client's id would stand: above
# any real client id, so the server's draws never share a client's key
SERVER = 1 << 40


def fold(key, *salts) -> tuple:
    """`key` (an int or a sequence of ints) extended by `salts`."""
    return tuple(int(k) for k in np.atleast_1d(key)) + tuple(
        int(s) for s in salts)


def seed_of(key) -> int:
    return int(np.random.SeedSequence(list(fold(key))).generate_state(1)[0])


def generator(key, device="cpu") -> torch.Generator:
    """A generator on `device` seeded from `key`."""
    g = torch.Generator(device=device)
    g.manual_seed(seed_of(key))
    return g
