"""Contribution assessment: client valuation by subset utility (port of
`fedml_tpu/contribution/__init__.py`; reference: core/contribution/ —
ContributionAssessorManager, LeaveOneOut, GTGShapleyValue,
MRShapleyValue).

A subset's utility is `utility_fn(weighted mean of its members' models)`.
The aggregates of many subsets are evaluated together: a [S, m] batch of
0/1 member masks goes through `torch.func.vmap`, so subsets are rows of
one computation and not host round trips. At full width the rows do not
all fit (S aggregates of D f32 parameters), so the masks go through in
chunks of `chunk` rows; each row is independent of the others, so a
chunk changes no value beyond the batch-size effects of the vmapped
kernels. `utility_fn(params) -> 0-d tensor` must be vmappable: no
`.item()`, no host synchronisation.
"""
from __future__ import annotations

import itertools
import math
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from ..ops.tree import tree_leaves, tree_weighted_mean

Tree = Any
# default bound on a chunk's aggregates and their [m, leaf] products
CHUNK_BYTES = 2 << 30


def subset_aggregate(stacked: Tree, weights: torch.Tensor,
                     member_mask: torch.Tensor) -> Tree:
    """The weighted mean over the clients a [m] 0/1 mask selects
    (reference: get_aggregated_model_with_client_subset,
    base_contribution_assessor.py:34-44); the mask multiplies the weights,
    so shapes stay fixed and the function vmaps over masks."""
    return tree_weighted_mean(stacked, weights * member_mask)


def default_chunk(stacked: Tree) -> int:
    """Rows a chunk holds under CHUNK_BYTES: each row makes one aggregate
    and, leaf by leaf, an [m, leaf] product."""
    leaves = tree_leaves(stacked)
    m = leaves[0].shape[0]
    row = sum(t[0].numel() * t.element_size() for t in leaves) * (m + 1)
    return max(1, CHUNK_BYTES // row)


def batched_subset_utilities(stacked: Tree, weights: torch.Tensor,
                             masks: np.ndarray,
                             utility_fn: Callable[[Tree], torch.Tensor],
                             chunk: Optional[int] = None) -> np.ndarray:
    """utility(aggregate(subset)) for a batch of subset masks [S, m], by
    `torch.func.vmap` over chunks of `chunk` rows (default:
    `default_chunk`) — the reference's per-subset aggregate-and-validate
    loop (gtg_shapley_value.py:88-93) as rows of one computation.
    Returns the [S] utilities as float32."""
    masks = torch.as_tensor(np.asarray(masks, np.float32),
                            device=weights.device)
    step = chunk or default_chunk(stacked)

    def one(mask):
        return utility_fn(subset_aggregate(stacked, weights, mask))

    run = torch.func.vmap(one)
    with torch.no_grad():
        out = [run(masks[i:i + step]) for i in range(0, masks.shape[0], step)]
    return torch.cat(out).float().cpu().numpy()


def leave_one_out(stacked: Tree, weights: torch.Tensor,
                  client_ids: Sequence[int],
                  utility_fn: Callable[[Tree], torch.Tensor],
                  chunk: Optional[int] = None) -> dict[int, float]:
    """U(all) - U(all \\ {i}) for each client (reference:
    leave_one_out.py:26-105): one batched evaluation of m + 1 models."""
    m = len(client_ids)
    masks = np.ones((m + 1, m), np.float32)
    for i in range(m):
        masks[i + 1, i] = 0.0
    utils = batched_subset_utilities(stacked, weights, masks, utility_fn,
                                     chunk)
    full = float(utils[0])
    return {cid: full - float(utils[i + 1])
            for i, cid in enumerate(client_ids)}


class GTGShapley:
    """Guided-truncation-gradient Shapley (reference:
    gtg_shapley_value.py:8-126, Liu et al. 2022): permutation-sampled
    marginal contributions with truncation within a permutation and a
    convergence test between permutations; the permutations come from
    `np.random.RandomState(seed)`, as in the JAX package."""

    def __init__(self, eps: float = 0.001,
                 round_trunc_threshold: float = 0.001,
                 convergence_criteria: float = 0.05, last_k: int = 10,
                 max_percentage: float = 0.8, seed: int = 0,
                 chunk: Optional[int] = None):
        self.eps = eps
        self.round_trunc_threshold = round_trunc_threshold
        self.convergence_criteria = convergence_criteria
        self.last_k = last_k
        self.max_percentage = max_percentage
        self.rng = np.random.RandomState(seed)
        self.chunk = chunk
        self.shapley_values_by_round: dict[int, dict[int, float]] = {}
        # the last run's permutations (the convergence test's k) and the
        # subsets it evaluated (prefixes not cached yet)
        self.permutations = 0
        self.evaluated = 0

    def _converged(self, records: list, k: int, n: int) -> bool:
        """(reference: _is_not_converged, gtg_shapley_value.py:112-124):
        the running means of the last_k marginal estimates settle."""
        if k >= max(n, 1) * 2 ** min(n, 10) * self.max_percentage + 1:
            return True
        if k <= self.last_k:
            return False
        all_vals = (np.cumsum(records, 0)
                    / np.arange(1, len(records) + 1)[:, None])
        errors = np.mean(
            np.abs(all_vals[-self.last_k:] - all_vals[-1:])
            / (np.abs(all_vals[-1:]) + 1e-12), axis=1)
        return bool(np.max(errors) < self.convergence_criteria)

    def run(self, stacked: Tree, weights: torch.Tensor,
            client_ids: Sequence[int],
            utility_fn: Callable[[Tree], torch.Tensor],
            acc_last_round: float, acc_aggregated: float,
            round_idx: int = 0) -> dict[int, float]:
        n = len(client_ids)
        self.permutations = self.evaluated = 0
        if abs(acc_aggregated - acc_last_round) <= self.round_trunc_threshold:
            # round truncation (gtg_shapley_value.py:62-66)
            out = {cid: 0.0 for cid in client_ids}
            self.shapley_values_by_round[round_idx] = out
            return out

        util: dict[tuple, float] = {(): acc_last_round,
                                    tuple(sorted(range(n))): acc_aggregated}
        records: list = []
        k = 0
        while not self._converged(records, k, n):
            for first in range(n):
                k += 1
                order = np.concatenate([
                    [first],
                    self.rng.permutation([i for i in range(n) if i != first]),
                ]).astype(int)
                v = np.zeros(n + 1)
                v[0] = acc_last_round
                marg = np.zeros(n)
                # every prefix subset of this permutation in one evaluation
                prefixes = [tuple(sorted(order[:j])) for j in range(1, n + 1)]
                todo = [pfx for pfx in prefixes if pfx not in util]
                if todo:
                    masks = np.zeros((len(todo), n), np.float32)
                    for r, pfx in enumerate(todo):
                        masks[r, list(pfx)] = 1.0
                    vals = batched_subset_utilities(
                        stacked, weights, masks, utility_fn, self.chunk)
                    self.evaluated += len(todo)
                    util.update({pfx: float(x) for pfx, x in zip(todo, vals)})
                for j in range(1, n + 1):
                    # truncation within the permutation (gtg:84-95)
                    if abs(acc_aggregated - v[j - 1]) >= self.eps:
                        v[j] = util[prefixes[j - 1]]
                    else:
                        v[j] = v[j - 1]
                    marg[order[j - 1]] = v[j] - v[j - 1]
                records.append(marg)
        self.permutations = k

        sv = (np.cumsum(records, 0)
              / np.arange(1, len(records) + 1)[:, None])[-1]
        out = {cid: float(sv[i]) for i, cid in enumerate(client_ids)}
        self.shapley_values_by_round[round_idx] = out
        return out


def mr_shapley(stacked: Tree, weights: torch.Tensor,
               client_ids: Sequence[int],
               utility_fn: Callable[[Tree], torch.Tensor],
               baseline_utility: float = 0.0,
               chunk: Optional[int] = None) -> dict[int, float]:
    """Exact Shapley values over the whole power set (reference:
    mr_shapley_value.py:27-63): 2^m - 1 subset utilities in one batched
    evaluation, so for small cohorts. U(empty) is `baseline_utility` (the
    previous round's utility), not the utility of an all-zero model."""
    m = len(client_ids)
    subsets = list(itertools.chain.from_iterable(
        itertools.combinations(range(m), r) for r in range(1, m + 1)))
    masks = np.zeros((len(subsets), m), np.float32)
    for r, s in enumerate(subsets):
        masks[r, list(s)] = 1.0
    utils = dict(zip(subsets, batched_subset_utilities(
        stacked, weights, masks, utility_fn, chunk)))
    utils[()] = np.float32(baseline_utility)
    subsets = [()] + subsets
    sv = np.zeros(m)
    for i in range(m):
        for s in subsets:
            if i in s:
                continue
            s_with = tuple(sorted(s + (i,)))
            weight = math.factorial(len(s)) * math.factorial(m - len(s) - 1) \
                / math.factorial(m)
            sv[i] += weight * (float(utils[s_with]) - float(utils[s]))
    return {cid: float(sv[i]) for i, cid in enumerate(client_ids)}


class ContributionAssessorManager:
    """The config-driven front (reference:
    contribution_assessor_manager.py:9-60 builds the assessor from
    args.contribution_alg): LOO, GTG or MR; `kwargs` configure GTG."""

    def __init__(self, alg: str = "GTG", chunk: Optional[int] = None,
                 **kwargs):
        self.alg = (alg or "").upper()
        self.chunk = chunk
        self._gtg = GTGShapley(chunk=chunk, **kwargs) \
            if self.alg == "GTG" else None
        self.history: dict[int, dict[int, float]] = {}

    def run(self, stacked, weights, client_ids, utility_fn,
            acc_last_round=0.0, acc_aggregated=1.0, round_idx=0):
        if self.alg == "LOO":
            out = leave_one_out(stacked, weights, client_ids, utility_fn,
                                self.chunk)
        elif self.alg == "GTG":
            out = self._gtg.run(stacked, weights, client_ids, utility_fn,
                                acc_last_round, acc_aggregated, round_idx)
        elif self.alg == "MR":
            out = mr_shapley(stacked, weights, client_ids, utility_fn,
                             chunk=self.chunk)
        else:
            raise ValueError(f"unknown contribution_alg {self.alg!r}; "
                             "one of LOO | GTG | MR")
        self.history[round_idx] = out
        return out

    def get_final_contribution_assignment(self) -> dict[int, float]:
        """Each client's values summed over the rounds (reference:
        contribution_assessor_manager.py:59)."""
        out: dict[int, float] = {}
        for vals in self.history.values():
            for cid, v in vals.items():
                out[cid] = out.get(cid, 0.0) + v
        return out
