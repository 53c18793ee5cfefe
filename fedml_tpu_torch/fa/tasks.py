"""Federated-analytics tasks (a numpy copy of `fedml_tpu/fa/tasks.py`,
bitwise the JAX package's results).

The reference implements each FA task as a (client analyzer, server
aggregator) class pair (reference: fa/local_analyzer/*.py +
fa/aggregator/*.py). Here a task is one frozen dataclass of pure
functions, the FL algorithm contract transplanted to analytics:

    client_analyze(client_data, server_data, rng) -> submission
    server_aggregate(server_data, [(weight, submission), ...]) -> server_data
    result(server_data) -> final answer

Value domains are host-side sets and histograms, so the analyzers are
numpy; FA does no device work.

Tasks (reference parity): avg (fa/local_analyzer/avg.py), frequency
estimation (frequency_estimation.py), union (union.py), intersection
(intersection.py), k-percentile (k_percentage_element.py), heavy hitters
via TrieHH (heavy_hitter_triehh.py; Zhu et al. 2020, federated heavy
hitters with DP).
"""
from __future__ import annotations

import dataclasses
import math
from collections import defaultdict
from typing import Any, Callable, Optional

import numpy as np

from ..core.registry import Registry

FA_TASKS: "Registry" = Registry("fa_task")

Submission = Any
ServerData = Any


@dataclasses.dataclass(frozen=True)
class FATask:
    """One federated-analytics computation (the reference's analyzer +
    aggregator pair as pure functions)."""
    name: str
    client_analyze: Callable[[Any, ServerData, np.random.Generator], Submission]
    server_aggregate: Callable[[ServerData, list], ServerData]
    server_init: Callable[[], ServerData] = lambda: None
    result: Callable[[ServerData], Any] = lambda s: s
    # early-stop predicate on the server state (TrieHH stops when no prefix
    # survives a round); an explicit field so data-derived dict keys can
    # never collide with control flow
    converged: Callable[[ServerData], bool] = lambda s: False
    # server -> client one-time setup payload (TrieHH's per-client batch)
    init_msg: Optional[Any] = None
    default_rounds: int = 1


# ------------------------------------------------------------------ average
@FA_TASKS.register("avg")
def make_avg(**_kw) -> FATask:
    """Weighted global mean (reference: fa/local_analyzer/avg.py +
    fa/aggregator/avg_aggregator.py)."""

    def analyze(data, _server, _rng):
        v = np.asarray(data, np.float64)
        return {"sum": float(v.sum()), "n": int(v.size)}

    def aggregate(server, subs):
        # the mean weights every *sample* equally: sum of sums / sum of
        # counts (reference avg_aggregator keeps the same running pair)
        total_sum = sum(s["sum"] for _w, s in subs)
        total_n = sum(s["n"] for _w, s in subs)
        prev_sum, prev_n = server if server is not None else (0.0, 0)
        return (prev_sum + total_sum, prev_n + total_n)

    return FATask(
        "avg", analyze, aggregate,
        server_init=lambda: (0.0, 0),
        result=lambda s: s[0] / max(s[1], 1),
    )


# ------------------------------------------------------- frequency estimation
@FA_TASKS.register("frequency_estimation")
def make_frequency_estimation(**_kw) -> FATask:
    """Global value frequencies (reference:
    fa/local_analyzer/frequency_estimation.py — clients submit local counts,
    server sums and normalizes)."""

    def analyze(data, _server, _rng):
        vals, counts = np.unique(np.asarray(data), return_counts=True)
        return {str(v): int(c) for v, c in zip(vals.tolist(), counts.tolist())}

    def aggregate(server, subs):
        acc = dict(server or {})
        for _w, counts in subs:
            for v, c in counts.items():
                acc[v] = acc.get(v, 0) + int(c)
        return acc

    def result(server):
        total = sum(server.values()) or 1
        return {v: c / total for v, c in server.items()}

    return FATask("frequency_estimation", analyze, aggregate,
                  server_init=dict, result=result)


# ------------------------------------------------------------ union / intersect
@FA_TASKS.register("union")
def make_union(**_kw) -> FATask:
    """Union of client value sets (reference: fa/local_analyzer/union.py)."""

    def analyze(data, _server, _rng):
        return sorted({str(v) for v in np.asarray(data).reshape(-1).tolist()})

    def aggregate(server, subs):
        acc = set(server or ())
        for _w, vals in subs:
            acc |= set(vals)
        return acc

    return FATask("union", analyze, aggregate, server_init=set,
                  result=lambda s: sorted(s))


@FA_TASKS.register("intersection")
def make_intersection(**_kw) -> FATask:
    """Intersection across clients (reference:
    fa/local_analyzer/intersection.py + intersection_aggregator.py). The
    server intersects per-round submissions; across rounds the running set
    only shrinks."""

    def analyze(data, _server, _rng):
        return sorted({str(v) for v in np.asarray(data).reshape(-1).tolist()})

    def aggregate(server, subs):
        round_set = None
        for _w, vals in subs:
            round_set = set(vals) if round_set is None else round_set & set(vals)
        if round_set is None:
            return server
        return round_set if server is None else (set(server) & round_set)

    return FATask("intersection", analyze, aggregate,
                  server_init=lambda: None,
                  result=lambda s: sorted(s or ()))


# --------------------------------------------------------------- k-percentile
@FA_TASKS.register("k_percentile")
def make_k_percentile(k: float = 50.0, bins: int = 2048,
                      lo: float = -1e6, hi: float = 1e6, **_kw) -> FATask:
    """k-th percentile of the union of client values (reference:
    fa/local_analyzer/k_percentage_element.py gathers raw values; here
    clients submit fixed-grid histograms — O(bins) per client instead of
    O(samples), and no raw value leaves a client)."""
    edges = np.linspace(lo, hi, bins + 1)

    def analyze(data, _server, _rng):
        v = np.clip(np.asarray(data, np.float64).reshape(-1), lo, hi)
        hist, _ = np.histogram(v, bins=edges)
        return hist.astype(np.int64)

    def aggregate(server, subs):
        acc = np.zeros(bins, np.int64) if server is None else np.asarray(server)
        for _w, h in subs:
            acc = acc + np.asarray(h, np.int64)
        return acc

    def result(server):
        total = int(server.sum())
        if total == 0:
            return float("nan")
        target = k / 100.0 * total
        cum = np.cumsum(server)
        idx = int(np.searchsorted(cum, target))
        return float(0.5 * (edges[idx] + edges[idx + 1]))

    return FATask("k_percentile", analyze, aggregate,
                  server_init=lambda: None, result=result)


# ------------------------------------------------------------------- TrieHH
@FA_TASKS.register("heavy_hitter")
@FA_TASKS.register("triehh")
def make_triehh(train_data_num: int = 1000, client_num_per_round: int = 10,
                max_word_len: int = 10, epsilon: float = 4.0,
                delta: float = 2.3e-12, comm_round: int = 10,
                **_kw) -> FATask:
    """Federated heavy hitters with central DP — TrieHH (reference:
    fa/local_analyzer/heavy_hitter_triehh.py + heavy_hitter_triehh_
    aggregator.py; Zhu et al. 2020, arXiv:1902.08534). The trie grows one
    character level per round; a prefix survives if >= theta sampled clients
    voted for it. theta and the vote batch size implement the (eps, delta)
    guarantee (Corollary 1 of the paper)."""
    # theta: smallest vote threshold satisfying the (eps, delta) bound
    # (reference: aggregator _set_theta — factorial condition from the
    # paper's Corollary 1)
    theta = 5
    while ((theta - 3) / (theta - 2)) * math.factorial(theta) < 1.0 / delta:
        theta += 1
    while theta < np.e ** (epsilon / max_word_len) - 1:
        theta += 1
    gamma = np.e ** (epsilon / max_word_len)
    batch_size = max(1, int(train_data_num * (gamma - 1) / (theta * gamma)))
    per_client = max(1, math.ceil(batch_size / client_num_per_round))

    def server_init():
        return {"trie": {}, "round": 0}

    def analyze(data, server, rng):
        """Vote on prefixes one character longer than the current trie.
        Words carry a '$' terminator (as in the paper/reference) so short
        heavy hitters survive in the trie after they complete."""
        words = [str(w) + "$" for w in data]
        r = (server or {"round": 0})["round"] + 1   # prefix length this round
        trie = (server or {"trie": {}})["trie"]
        take = min(per_client, len(words))
        idx = rng.choice(len(words), take, replace=False)
        votes: dict[str, int] = defaultdict(int)
        for i in idx:
            w = words[int(i)]
            if len(w) < r:
                continue
            pre = w[: r - 1]
            # a vote counts only if the prefix one shorter is already in the
            # trie (reference: one_word_vote)
            if r > 1 and pre not in trie:
                continue
            votes[w[:r]] += 1
        return dict(votes)

    def aggregate(server, subs):
        votes: dict[str, int] = defaultdict(int)
        for _w, v in subs:
            for prefix, c in v.items():
                votes[prefix] += int(c)
        # the trie is the UNION of surviving prefixes across rounds
        # (reference: server_update w_global[prefix] = None)
        survivors = {p: c for p, c in votes.items() if c >= theta}
        trie = dict(server["trie"])
        trie.update(survivors)
        return {"trie": trie, "round": server["round"] + 1,
                "grew": bool(survivors)}

    def result(server):
        # heavy hitters = trie entries that reached their terminator
        # (reference: print_heavy_hitters keeps words ending in '$')
        return sorted(p[:-1] for p in server["trie"] if p.endswith("$"))

    return FATask("triehh", analyze, aggregate, server_init=server_init,
                  result=result,
                  converged=lambda s: s["round"] > 0 and not s["grew"],
                  init_msg=per_client, default_rounds=comm_round)
