"""Decentralized FL: DSGD and PushSum as gossip-matrix programs (port of
`fedml_tpu/simulation/decentralized.py`; reference:
simulation/sp/decentralized/).

There are no client objects: the N nodes' parameters are one stacked
dict of [N, ...] tensors, and an iteration is

    every node's local SGD step (`torch.func.vmap` of one functional
    step, randomness="error")  ->  gossip: params' = W @ params

with W the row-stochastic mixing matrix of `comm/topology.py`, one
[N, N] x [N, D] f32 product a leaf. JAX's `lax.scan` over iterations is
a Python loop.

PushSum (Nedic & Olshevsky; reference client_pushsum.py) runs on
directed graphs, where W is not doubly stochastic: each node pushes mass
to its out-neighbours through a column-stochastic P, carries a weight
omega, and trains on the de-biased z = x / omega.

Draws: each node's minibatch (`jax.random.choice` without replacement in
JAX) is drawn on the host, outside vmap, as the first B entries of a
permutation from the generator keyed (seed, iteration, node); `idx=`
([iters, N, B]) takes the indices instead (the tests hand JAX's over).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..comm.topology import AsymmetricTopologyManager, SymmetricTopologyManager
from ..core.algorithm import make_client_optimizer, masked_softmax_ce
from ..ops import keys
from ..ops.tree import tree_leaves, tree_map


def column_stochastic(topology: np.ndarray) -> np.ndarray:
    """PushSum's push matrix: every node splits its mass evenly among the
    nodes that listen to it (the adjacency's columns normalised to 1),
    derived from the listen graph's matrix so the two cannot disagree."""
    adj = (topology > 0).astype(np.float64)
    return adj / adj.sum(axis=0, keepdims=True)


def _gossip(stacked: dict, W: torch.Tensor) -> dict:
    """params' = W @ params over the leading node axis, leaf by leaf."""
    def mix(a):
        n = a.shape[0]
        return (W.to(a.dtype) @ a.reshape(n, -1)).reshape(a.shape)

    return tree_map(mix, stacked)


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(
        np.asarray(a))


def _bcast(v: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """A [N] vector shaped to broadcast over a [N, ...] leaf."""
    return v.reshape((-1,) + (1,) * (a.dim() - 1))


def draw_indices(seed: int, iters: int, n: int, shard_size: int,
                 batch_size: int) -> torch.Tensor:
    """[iters, n, B] int64: node i's minibatch at iteration it, B rows
    without replacement, from the generator keyed (seed, it, i)."""
    bs = min(batch_size, shard_size)
    return torch.stack([torch.stack([
        torch.randperm(shard_size, generator=keys.generator((seed, it, i)))[
            :bs] for i in range(n)]) for it in range(iters)])


def _build_run(apply_fn: Callable, W: torch.Tensor, lr: float,
               weight_decay: float, pushsum: bool):
    opt = make_client_optimizer("sgd", lr, 0.0, weight_decay)

    def loss_fn(p, x, y, mask):
        loss, _c, _n = masked_softmax_ce(apply_fn(p, x), y, mask)
        return loss, loss

    grad = torch.func.grad(loss_fn, has_aux=True)

    def local_step(p, shard, idx):
        g, loss = grad(p, shard["x"][idx], shard["y"][idx],
                       shard["mask"][idx])
        return opt.step(p, g, {}, 1)[0], loss

    step = torch.func.vmap(local_step, randomness="error")

    def iterate(x, omega, data, idx_it):
        """One iteration: (x, omega) -> (x', omega', mean loss)."""
        # PushSum trains on the de-biased z = x / omega, DSGD on x
        z = tree_map(lambda a: a / _bcast(omega, a), x) if pushsum else x
        new_z, losses = step(z, data, idx_it)
        if pushsum:
            # fold the step back into the biased iterate, then push x and
            # omega through the column-stochastic matrix
            delta = tree_map(torch.sub, new_z, z)
            x = tree_map(lambda xv, d: xv + d * _bcast(omega, d), x, delta)
            x = _gossip(x, W)
            omega = W.to(omega.dtype) @ omega
        else:
            x = _gossip(new_z, W)
        return x, omega, losses.mean()

    def run(stacked0: dict, data: dict, idx: torch.Tensor):
        n = data["y"].shape[0]
        x = stacked0
        # f32 as JAX's omega (f64 only for an f64 run)
        omega = torch.ones(n, dtype=tree_leaves(x)[0].dtype,
                           device=data["y"].device)
        losses = []
        for it in range(idx.shape[0]):
            x, omega, loss = iterate(x, omega, data, idx[it])
            losses.append(loss)
        z = tree_map(lambda a: a / _bcast(omega, a), x) if pushsum else x
        return z, torch.stack(losses)

    return run


def consensus_distance(stacked: dict) -> float:
    """The mean squared distance of each node's parameters to the nodes'
    mean (0: full agreement)."""
    tot, cnt = 0.0, 0
    for a in tree_leaves(stacked):
        tot += float(((a - a.mean(0, keepdim=True)) ** 2).sum())
        cnt += int(np.prod(a.shape[1:])) * a.shape[0]
    return tot / max(cnt, 1)


def _run(apply_fn, params0, data, W: np.ndarray, iters, lr, batch_size,
         weight_decay, seed, idx, device, pushsum):
    dev = resolve_device(device)
    data = _with_mask(data, dev)
    n, s = data["y"].shape[:2]
    stacked = _ensure_stacked(tree_map(lambda a: _tensor(a).to(dev),
                                       params0), n)
    if idx is None:
        idx = draw_indices(seed, iters, n, s, batch_size)
    idx = _tensor(idx).to(dev, torch.int64)
    run = _build_run(apply_fn, torch.as_tensor(W, dtype=torch.float32,
                                               device=dev),
                     lr, weight_decay, pushsum)
    return run(stacked, data, idx)


def run_dsgd(apply_fn: Callable, params0: dict, data: dict,
             topology: Optional[SymmetricTopologyManager] = None,
             iters: int = 100, lr: float = 0.1, batch_size: int = 8,
             weight_decay: float = 0.0, neighbor_num: int = 2,
             seed: int = 0, idx=None, device=None):
    """Decentralized SGD over an undirected gossip graph (reference:
    client_dsgd.py) -> (stacked final parameters [N, ...], the [iters]
    mean losses). `apply_fn(params, x)` is the model (`hub.apply_fn`);
    `params0` one parameter dict (copied to every node) or already
    stacked; `idx` [iters, N, B] the minibatch indices (default: drawn,
    module docstring); `device` CUDA unless the caller names "cpu"."""
    n = data["y"].shape[0]
    topo = topology or SymmetricTopologyManager(n, neighbor_num=neighbor_num)
    return _run(apply_fn, params0, data, topo.topology, iters, lr,
                batch_size, weight_decay, seed, idx, device, pushsum=False)


def run_pushsum(apply_fn: Callable, params0: dict, data: dict,
                topology: Optional[AsymmetricTopologyManager] = None,
                iters: int = 100, lr: float = 0.1, batch_size: int = 8,
                weight_decay: float = 0.0, in_num: int = 2, out_num: int = 1,
                seed: int = 0, idx=None, device=None):
    """PushSum over a directed gossip graph (reference: client_pushsum.py):
    column-stochastic pushes and omega de-biasing, so the nodes converge
    to the uniform average though the digraph is not doubly stochastic.
    Arguments as `run_dsgd`'s."""
    n = data["y"].shape[0]
    topo = topology or AsymmetricTopologyManager(n, in_num=in_num,
                                                 out_num=out_num)
    return _run(apply_fn, params0, data, column_stochastic(topo.topology),
                iters, lr, batch_size, weight_decay, seed, idx, device,
                pushsum=True)


def _leaf_paths(tree, prefix=()):
    """(path, leaf) pairs of a dict tree, a path the tuple of its keys with
    each flat name split at its dots."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_paths(v, prefix + tuple(str(k).split(".")))
    else:
        yield prefix, tree


def _ensure_stacked(params: dict, n: int) -> dict:
    """`params` as [n, ...] leaves. JAX's rule: a tree whose first leaf
    (in JAX's flattening order, the sorted key paths) has a leading axis
    of n counts as stacked already; otherwise every leaf is copied n
    times."""
    paths = sorted(_leaf_paths(params), key=lambda pl: pl[0])
    if paths and tuple(paths[0][1].shape[:1]) == (n,):
        return params
    return tree_map(lambda a: a.unsqueeze(0).expand(
        (n,) + tuple(a.shape)).clone(), params)


def _with_mask(data: dict, device) -> dict:
    """The nodes' data as tensors on `device`, with an all-ones [N, S] f32
    sample mask where none is given."""
    out = {k: _tensor(v).to(device) for k, v in data.items()}
    if "mask" not in out:
        out["mask"] = torch.ones(tuple(out["y"].shape[:2]),
                                 dtype=torch.float32, device=device)
    return out
