"""Heterogeneity-aware workload scheduling, the "Parrot" scheduler (port
of `fedml_tpu/schedule/__init__.py`; reference: core/schedule/, the linear
runtime fit runtime_estimate.py:16, the DP makespan scheduler
seq_train_scheduler.py:165, wired from the fedavg_seq aggregator
FedAVGAggregator.py:126-187).

Host numpy, the JAX package's arithmetic line for line, so every function
returns its bits: the runtime estimator and its linear fit, the cost
model that switches LPT costs from sample counts to predicted runtimes
once its fit is trustworthy (with the `fed.cost_model.*` counters and
gauges), LPT and its cardinality-balanced forms (`balanced_lpt`, one
round; `balanced_lpt_block`, K rounds at once), the DP makespan search and
the reference's client schedule. The Simulator places clients on a
mesh's ranks with `balanced_lpt`: SPMD ranks take equal contiguous blocks
of the cohort, so the schedule permutes clients among fixed-size slots.
"""
from __future__ import annotations

import numpy as np


def linear_fit(x, y):
    """Degree-1 polyfit + mean relative error (reference:
    runtime_estimate.py:4-14)."""
    z = np.polyfit(x, y, 1)
    p = np.poly1d(z)
    yv = p(x)
    err = float(np.mean(np.abs(yv - y) / np.maximum(np.abs(y), 1e-12)))
    return z, p, yv, err


class RuntimeEstimator:
    """Per-(worker, client) runtime history -> per-worker linear cost model
    (reference: t_sample_fit, runtime_estimate.py:16-120; recording site
    record_client_runtime, FedAVGAggregator.py:111)."""

    def __init__(self, num_workers: int):
        self.num_workers = num_workers
        self.history: dict[int, dict[int, list[float]]] = {
            w: {} for w in range(num_workers)
        }

    def record(self, worker: int, client: int, runtime: float) -> None:
        self.history[worker].setdefault(client, []).append(float(runtime))

    def fit(self, data_sizes: dict[int, int], uniform_workers: bool = False):
        """Fit runtime ~ a*num_samples + b per worker (or one global fit when
        uniform_workers). Returns {worker: (a, b)}, {worker: rel_error}."""
        params, errors = {}, {}
        groups = [list(range(self.num_workers))] if uniform_workers else \
            [[w] for w in range(self.num_workers)]
        for group in groups:
            xs, ys = [], []
            for w in group:
                for cid, times in self.history[w].items():
                    xs += [data_sizes[cid]] * len(times)
                    ys += times
            if len(xs) < 2 or len(set(xs)) < 2:
                ab, err = (0.0, float(np.mean(ys)) if ys else 1.0), float("inf")
            else:
                z, _, _, err = linear_fit(np.asarray(xs, float),
                                          np.asarray(ys, float))
                ab = (float(z[0]), float(z[1]))
            for w in group:
                params[w], errors[w] = ab, err
        return params, errors

    def predict(self, worker: int, num_samples: int,
                params: dict[int, tuple]) -> float:
        a, b = params[worker]
        return a * num_samples + b

    def predict_client(self, worker: int, client: int, num_samples: int,
                       params: dict[int, tuple]) -> float:
        """Per-client cost: the client's own empirical mean runtime when
        history exists (the reference keeps the full per-(worker, client)
        table for exactly this — runtime_estimate.py's fit is the FALLBACK
        for unseen clients, not a replacement for observations), else the
        worker's linear fit at `num_samples`."""
        times = self.history.get(worker, {}).get(client)
        if times:
            return float(np.mean(times))
        return self.predict(worker, num_samples, params)


class CostModel:
    """Wall-time-driven LPT costs — the Parrot scheduling loop as a host
    helper (reference: FedAVGAggregator.py:126-187 — uniform schedule for
    the first rounds while runtimes are recorded, then runtime-fit
    rebalancing once the fit is trustworthy).

    The simulator records dispatch wall times (`record_dispatch` attributes
    a dispatch's duration equally across its clients — the dispatch is the
    smallest observable unit of a round; per-client resolution
    sharpens as `cohort_chunk` shrinks). Once at least `fit_after_rounds`
    dispatches are recorded AND the runtime~samples fit's mean relative
    error is <= `error_threshold`, `engaged()` flips and `predict_costs`
    supplies predicted per-client runtimes for `balanced_lpt` /
    `balanced_lpt_block` in place of raw sample counts.
    """

    def __init__(self, data_sizes: dict[int, int],
                 fit_after_rounds: int = 3,
                 error_threshold: float = 0.5):
        self.data_sizes = {int(k): int(v) for k, v in data_sizes.items()}
        self.fit_after_rounds = int(fit_after_rounds)
        self.error_threshold = float(error_threshold)
        self.estimator = RuntimeEstimator(num_workers=1)
        self.rounds_recorded = 0
        self._fit: tuple | None = None     # (params, error) cache

    def record_dispatch(self, clients, duration_s: float) -> None:
        """The simulator's wall-time recording hook: one dispatch (round or
        chunk) covering `clients` took `duration_s` seconds."""
        clients = [int(c) for c in clients]
        if not clients or duration_s <= 0.0:
            return
        per = float(duration_s) / len(clients)
        hist = self.estimator.history[0]
        for c in clients:
            self.estimator.record(0, c, per)
            h = hist[c]
            if len(h) > 64:    # bound per-client history: a 10k-client,
                del h[:-32]    # 10k-round run must not grow without limit
        self.rounds_recorded += 1
        self._fit = None
        from ..utils import metrics as _mx

        _mx.inc("fed.cost_model.dispatches")

    def _fitted(self) -> tuple:
        if self._fit is None:
            params, errors = self.estimator.fit(self.data_sizes,
                                                uniform_workers=True)
            self._fit = (params, float(errors[0]))
            from ..utils import metrics as _mx

            err = self._fit[1]
            _mx.set_gauge("fed.cost_model.fit_error",
                          err if np.isfinite(err) else -1.0)
        return self._fit

    def engaged(self) -> bool:
        """True once enough dispatches are recorded AND the fit error has
        dropped below the threshold — the activation rule (never engage
        on a model that can't explain the observations; fall back to
        size-LPT instead). The fit (and its
        fed.cost_model.* gauges) refreshes on every call, including during
        warm-up, so `top`/`/metrics` show the warming state too."""
        _, err = self._fitted()
        on = bool(self.rounds_recorded >= self.fit_after_rounds
                  and np.isfinite(err) and err <= self.error_threshold)
        from ..utils import metrics as _mx

        _mx.set_gauge("fed.cost_model.engaged", 1.0 if on else 0.0)
        return on

    def predict_costs(self, clients) -> np.ndarray:
        """Predicted per-client runtimes for an id row (empirical per-client
        means where observed, linear-fit extrapolation elsewhere)."""
        params, _ = self._fitted()
        return np.asarray([
            self.estimator.predict_client(
                0, int(c), self.data_sizes.get(int(c), 0), params)
            for c in clients
        ], float)

    @classmethod
    def from_config(cls, spec, data_sizes: dict[int, int]):
        """train_args.extra.cost_model: true or {fit_after_rounds,
        error_threshold} (validated at config load). None/false -> None."""
        if spec in (None, False):
            return None
        opts = dict(spec) if isinstance(spec, dict) else {}
        return cls(data_sizes, **opts)


def lpt_schedule(costs: np.ndarray, num_workers: int,
                 speeds: np.ndarray | None = None) -> list[list[int]]:
    """Longest-processing-time-first makespan scheduling of jobs with `costs`
    onto `num_workers` (optionally speed-scaled) workers — the greedy
    workhorse behind the reference's DP search (seq_train_scheduler.py:165
    explores assignments; LPT is its 4/3-approximation with n log n cost)."""
    speeds = np.ones(num_workers) if speeds is None else np.asarray(speeds, float)
    order = np.argsort(-np.asarray(costs, float))
    loads = np.zeros(num_workers)
    out: list[list[int]] = [[] for _ in range(num_workers)]
    for j in order:
        w = int(np.argmin((loads + costs[j]) / speeds))
        out[w].append(int(j))
        loads[w] += costs[j] / speeds[w]
    return out


def balanced_lpt(costs: np.ndarray, num_workers: int) -> list[list[int]]:
    """LPT with a cardinality constraint: every worker receives exactly
    len(costs)/num_workers jobs. This is the shape SPMD placement needs —
    a mesh round splits the sampled-client axis into equal contiguous blocks
    per rank, so the schedule can only permute clients among fixed-size slots
    (unlike the reference's MPI workers, which take variable-length client
    lists — FedAVGAggregator.py:126-187)."""
    costs = np.asarray(costs, float)
    n = len(costs)
    if n % num_workers:
        raise ValueError(f"{n} jobs not divisible by {num_workers} workers")
    slots = n // num_workers
    order = np.argsort(-costs)
    loads = np.zeros(num_workers)
    fill = np.zeros(num_workers, int)
    out: list[list[int]] = [[] for _ in range(num_workers)]
    for j in order:
        open_ws = np.flatnonzero(fill < slots)
        w = int(open_ws[np.argmin(loads[open_ws])])
        out[w].append(int(j))
        loads[w] += costs[j]
        fill[w] += 1
    return out


def balanced_lpt_block(costs: np.ndarray, num_workers: int) -> np.ndarray:
    """Vectorized `balanced_lpt` over a block of K independent rounds.

    costs [K, n] -> perm [K, n], where perm[k] ==
    np.concatenate(balanced_lpt(costs[k], num_workers)) — the permutation the
    simulator applies to round k's padded id row (parity is exact, including
    argsort/argmin tie behavior: ties pick the earlier job position and the
    lowest-indexed open worker in both implementations). Round-block
    execution puts the host scheduler on the hot path — one blocked dispatch
    covers K rounds of device work, so K scheduler runs must cost one: this
    does one K-wide argsort plus n K-wide masked argmins instead of K
    python-loop scheduler invocations."""
    costs = np.asarray(costs, float)
    if costs.ndim != 2:
        raise ValueError(f"costs must be [K, n]; got shape {costs.shape}")
    k, n = costs.shape
    if n % num_workers:
        raise ValueError(f"{n} jobs not divisible by {num_workers} workers")
    slots = n // num_workers
    order = np.argsort(-costs, axis=1)        # per-round LPT job order
    rows = np.arange(k)
    loads = np.zeros((k, num_workers))
    fill = np.zeros((k, num_workers), int)
    workers = np.empty((k, n), int)           # chosen worker per pick
    for p in range(n):
        j = order[:, p]
        open_loads = np.where(fill < slots, loads, np.inf)
        w = np.argmin(open_loads, axis=1)
        workers[:, p] = w
        loads[rows, w] += costs[rows, j]
        fill[rows, w] += 1
    # concatenate per-worker job lists in pick order — a stable sort of the
    # pick positions by assigned worker reproduces balanced_lpt's
    # list-append order exactly
    grouped = np.argsort(workers, axis=1, kind="stable")
    return np.take_along_axis(order, grouped, axis=1)


def dp_schedule(costs: np.ndarray, num_workers: int,
                max_states: int = 200_000) -> list[list[int]]:
    """Exact(ish) branch-and-prune makespan minimization for small instances
    (reference: SeqTrainScheduler.assign_a_workload_serial/DP_schedule —
    breadth-first expansion of assignment maps with cost pruning)."""
    costs = np.asarray(costs, float)
    n = len(costs)
    # state key: SORTED load tuple (worker-permutation symmetric states are
    # equivalent for makespan); value: (assignment, actual loads)
    states: dict[tuple, tuple] = {(0.0,) * num_workers: ((), [0.0] * num_workers)}
    order = list(np.argsort(-costs))
    for j in order:
        new: dict[tuple, tuple] = {}
        for assign, loads in states.values():
            for w in range(num_workers):
                nl = list(loads)
                nl[w] += costs[j]
                key = tuple(sorted(nl))
                if key not in new:
                    new[key] = (assign + ((j, w),), nl)
        items = sorted(new.items(), key=lambda kv: kv[0][-1])[:max_states]
        states = dict(items)
    _, (best_assign, _) = min(states.items(), key=lambda kv: kv[0][-1])
    out: list[list[int]] = [[] for _ in range(num_workers)]
    for j, w in best_assign:
        out[w].append(j)
    return out


def generate_client_schedule(
    round_clients: list[int], data_sizes: dict[int, int], num_workers: int,
    estimator: RuntimeEstimator | None = None, round_idx: int = 0,
    fit_after_round: int = 5, fit_error_threshold: float = 1.0,
) -> list[list[int]]:
    """Client → worker assignment for sequential simulation (reference:
    generate_client_schedule, FedAVGAggregator.py:126-187: uniform chunks for
    the first `fit_after_round` rounds, then runtime-fit LPT balancing if the
    fit error is acceptable)."""
    if estimator is None or round_idx < fit_after_round:
        chunks = np.array_split(np.asarray(round_clients), num_workers)
        return [c.tolist() for c in chunks]
    params, errors = estimator.fit(data_sizes, uniform_workers=False)
    if np.mean([e for e in errors.values()]) > fit_error_threshold:
        chunks = np.array_split(np.asarray(round_clients), num_workers)
        return [c.tolist() for c in chunks]
    # speed per worker = 1/a (samples per second slope); cost per client = n_i
    speeds = np.asarray([
        1.0 / max(params[w][0], 1e-9) for w in range(num_workers)
    ])
    speeds = speeds / speeds.max()
    costs = np.asarray([data_sizes[c] for c in round_clients], float)
    sched = lpt_schedule(costs, num_workers, speeds)
    return [[round_clients[j] for j in jobs] for jobs in sched]
