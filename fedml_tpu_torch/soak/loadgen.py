"""Seeded, replayable traffic generator — the million-user request shape
(own copy of `fedml_tpu/soak/loadgen.py`: `build_schedule` draws the same
numpy stream, so a spec gives the JAX package's schedule element for
element).

Production LLM traffic is not uniform: many users share prompt heads
(system prompts, templates — a Zipf-distributed prefix popularity), the
prompt/output length distribution is heavy-tailed (lognormal bodies with
long maxima), arrival is OPEN-LOOP (users do not wait for each other; a
slow fleet gets more concurrent requests, not fewer), and demand bursts.
`TrafficSpec` + `build_schedule` shape all four deterministically: the
whole schedule — arrival times, prefix choices, prompt/output lengths,
burst windows, stream/unary mix — is a pure function of the seed, so a
failing soak replays exactly (the chaos-plane determinism contract,
comm/chaos.py, applied to load).

`LoadGenerator` executes a schedule against a gateway URL from a thread
pool with per-request SLO bookkeeping: TTFT (first streamed token),
TBT (inter-token gaps), total latency, and a status taxonomy where shed
429s are counted SEPARATELY from failures — overload refusal is the
fleet degrading as designed; a 5xx/connection error is not. Execution
timing is real time (open-loop dispatch at the scheduled offsets);
determinism covers the schedule, not the wall clock.

Metrics: `loadgen.requests` / `loadgen.ok` / `loadgen.shed` /
`loadgen.errors` counters, `loadgen.ttft_s` / `loadgen.tbt_s` /
`loadgen.total_s` histograms — scraped by `/metrics`, rendered on the
`loop:` line of `python -m fedml_tpu_torch top`, and summarized by `report`.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from ..utils import metrics as _mx


@dataclasses.dataclass(frozen=True)
class TrafficSpec:
    """The deterministic traffic shape. `rate_rps` is the open-loop base
    arrival rate; inside a burst window (every `burst_every_s`, lasting
    `burst_len_s`) the rate is multiplied by `burst_factor` — size the
    factor above the gateway's shed watermark to exercise 429 shedding.
    Prompts are `prefix + suffix`: the prefix is drawn from a pool of
    `prefix_pool` shared heads with Zipf(`zipf_s`) popularity (rank-1 is
    hottest — the prefix-cache target), the suffix is unique per request.
    Suffix/output lengths are heavy-tailed lognormal (median `*_med`,
    log-sigma `*_sigma`) clipped to [1, `*_max`]."""

    seed: int = 0
    rate_rps: float = 20.0
    duration_s: float = 30.0
    vocab: int = 64
    prefix_pool: int = 8
    prefix_len: int = 8
    zipf_s: float = 1.2
    suffix_len_med: float = 4.0
    suffix_len_sigma: float = 0.6
    suffix_len_max: int = 16
    out_len_med: float = 4.0
    out_len_sigma: float = 0.6
    out_len_max: int = 12
    stream_frac: float = 0.25
    burst_every_s: Optional[float] = None
    burst_factor: float = 3.0
    burst_len_s: float = 1.0

    def max_prompt_len(self) -> int:
        return self.prefix_len + self.suffix_len_max

    def max_total_len(self) -> int:
        """Worst-case prompt+output — size engine capacity
        (`engine_max_len`, page budget) against this."""
        return self.max_prompt_len() + self.out_len_max


@dataclasses.dataclass(frozen=True)
class PlannedRequest:
    t: float                 # dispatch offset from schedule start (s)
    prefix_id: int           # index into the shared prefix pool
    tokens: tuple            # full prompt (prefix + unique suffix)
    max_new: int
    stream: bool
    in_burst: bool


@dataclasses.dataclass
class RequestResult:
    status: int              # HTTP status; 599 = connection-level failure
    klass: str               # "ok" | "shed" | "error"
    t_sched: float           # the schedule offset this request ran at
    total_s: float
    ttft_s: Optional[float]  # streams only: first token event
    tbt_s: tuple             # streams only: inter-token gaps
    stream: bool
    tokens_out: int
    in_burst: bool


def _heavy_tail(rs: np.random.RandomState, med: float, sigma: float,
                hi: int) -> int:
    """Lognormal(median=med, log-sigma=sigma) clipped to [1, hi] — the
    heavy-tailed length draw."""
    return int(np.clip(round(med * np.exp(sigma * rs.randn())), 1, hi))


def zipf_weights(n: int, s: float) -> np.ndarray:
    """Normalized Zipf pmf over ranks 0..n-1 (rank 0 hottest)."""
    w = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64), s)
    return w / w.sum()


def _rate_at(spec: TrafficSpec, t: float) -> tuple[float, bool]:
    """(arrival rate, inside-a-burst-window) at absolute offset `t`."""
    in_burst = bool(spec.burst_every_s
                    and (t % spec.burst_every_s) < spec.burst_len_s)
    return spec.rate_rps * (spec.burst_factor if in_burst else 1.0), \
        in_burst


def build_schedule(spec: TrafficSpec) -> list:
    """The whole request stream as a pure function of the spec: same spec
    (same seed) => identical schedule, element for element — pinned in
    tests/test_torch_soak.py.

    Arrival is an inhomogeneous Poisson process generated by THINNING:
    candidates are drawn at the peak rate and accepted with probability
    rate(t)/peak — so the rate (and the in_burst label) is evaluated AT
    each arrival's own timestamp, and burst windows start exactly on
    schedule rather than one inter-arrival gap late."""
    rs = np.random.RandomState(spec.seed)
    prefixes = [tuple(int(v) for v in rs.randint(1, spec.vocab,
                                                 spec.prefix_len))
                for _ in range(spec.prefix_pool)]
    w = zipf_weights(spec.prefix_pool, spec.zipf_s)
    peak = spec.rate_rps * max(
        1.0, spec.burst_factor if spec.burst_every_s else 1.0)
    out: list[PlannedRequest] = []
    t = 0.0
    while True:
        t += float(rs.exponential(1.0 / peak))
        if t >= spec.duration_s:
            return out
        rate, in_burst = _rate_at(spec, t)
        if rate < peak and float(rs.random_sample()) >= rate / peak:
            continue            # thinning: candidate arrival rejected
        pid = int(rs.choice(spec.prefix_pool, p=w))
        suffix_len = _heavy_tail(rs, spec.suffix_len_med,
                                 spec.suffix_len_sigma, spec.suffix_len_max)
        suffix = tuple(int(v) for v in rs.randint(1, spec.vocab, suffix_len))
        max_new = _heavy_tail(rs, spec.out_len_med, spec.out_len_sigma,
                              spec.out_len_max)
        stream = bool(rs.random_sample() < spec.stream_frac)
        out.append(PlannedRequest(
            t=t, prefix_id=pid, tokens=prefixes[pid] + suffix,
            max_new=max_new, stream=stream, in_burst=in_burst))


def _classify(status: int) -> str:
    if 200 <= status < 300:
        return "ok"
    if status == 429:
        return "shed"      # deliberate overload refusal, not a failure
    return "error"


class LoadGenerator:
    """Open-loop executor for a built schedule. A dispatcher thread walks
    the schedule and hands each request to a worker pool AT its scheduled
    offset without waiting for earlier requests to finish — a slow fleet
    accumulates in-flight work exactly like real user traffic. stop()
    halts dispatch (remaining schedule entries are simply never issued)
    and drains in-flight requests."""

    def __init__(self, spec: TrafficSpec, url: str, max_workers: int = 16,
                 request_timeout_s: float = 60.0):
        self.spec = spec
        self.url = url
        self.schedule = build_schedule(spec)
        self.results: list[RequestResult] = []
        self.request_timeout_s = float(request_timeout_s)
        self._pool = ThreadPoolExecutor(max_workers=max_workers)
        self._futures: list = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.done = threading.Event()    # schedule fully dispatched
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------- dispatch
    def start(self) -> "LoadGenerator":
        self._thread = threading.Thread(target=self._dispatch, daemon=True)
        self._thread.start()
        return self

    def _dispatch(self) -> None:
        t0 = time.monotonic()
        for req in self.schedule:
            delay = req.t - (time.monotonic() - t0)
            if delay > 0 and self._stop.wait(delay):
                break
            if self._stop.is_set():
                break
            _mx.inc("loadgen.requests")
            self._futures.append(self._pool.submit(self._issue, req))
        self.done.set()

    def stop(self, timeout: float = 30.0) -> list:
        """Stop dispatching, drain in-flight requests (bounded by
        `timeout`), return results. A straggler that outlives the drain
        budget is left to its worker thread (its row lands in `results`
        whenever it finishes) — the report must never be destroyed by
        one slow stream after the run already completed."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        end = time.monotonic() + timeout
        for f in self._futures:
            try:
                f.result(timeout=max(0.1, end - time.monotonic()))
            except Exception:  # noqa: BLE001 — drain-budget overrun only
                # (workers swallow their own errors); the late row is
                # appended by its worker if it ever completes
                break
        self._pool.shutdown(wait=False)
        with self._lock:
            return list(self.results)

    # ------------------------------------------------------------- workers
    def _issue(self, req: PlannedRequest) -> None:
        try:
            res = (self._issue_stream(req) if req.stream
                   else self._issue_unary(req))
        except Exception as e:  # noqa: BLE001 — a worker must never die
            res = RequestResult(599, "error", req.t, 0.0, None, (),
                                req.stream, 0, req.in_burst)
            _mx.inc("loadgen.errors")
            import logging

            logging.getLogger(__name__).warning(
                "loadgen worker failed: %s: %s", type(e).__name__, e)
        with self._lock:
            self.results.append(res)

    def _record(self, res: RequestResult) -> RequestResult:
        if res.klass == "ok":
            _mx.inc("loadgen.ok")
        elif res.klass == "shed":
            _mx.inc("loadgen.shed")
        else:
            _mx.inc("loadgen.errors")
        _mx.observe("loadgen.total_s", res.total_s)
        if res.ttft_s is not None:
            _mx.observe("loadgen.ttft_s", res.ttft_s)
        for gap in res.tbt_s:
            _mx.observe("loadgen.tbt_s", gap)
        return res

    def _issue_unary(self, req: PlannedRequest) -> RequestResult:
        body = json.dumps({"tokens": list(req.tokens),
                           "max_new_tokens": req.max_new}).encode()
        r = urllib.request.Request(
            self.url, data=body,
            headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        n_out = 0
        try:
            with urllib.request.urlopen(
                    r, timeout=self.request_timeout_s) as resp:
                payload = json.loads(resp.read() or b"{}")
                status = resp.status
                n_out = len(payload.get("generated_tokens") or ())
        except urllib.error.HTTPError as e:
            e.read()
            status = e.code
        except (urllib.error.URLError, OSError, json.JSONDecodeError):
            status = 599
        total = time.perf_counter() - t0
        return self._record(RequestResult(
            status, _classify(status), req.t, total, None, (), False,
            n_out, req.in_burst))

    def _issue_stream(self, req: PlannedRequest) -> RequestResult:
        body = json.dumps({"tokens": list(req.tokens),
                           "max_new_tokens": req.max_new,
                           "stream": True}).encode()
        r = urllib.request.Request(
            self.url, data=body,
            headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        ttft = None
        gaps: list[float] = []
        n_out = 0
        status = 200
        complete = False
        try:
            with urllib.request.urlopen(
                    r, timeout=self.request_timeout_s) as resp:
                last = None
                for ev in _sse_events(resp):
                    now = time.perf_counter()
                    if "token" in ev:
                        if ttft is None:
                            ttft = now - t0
                        else:
                            gaps.append(now - last)
                        last = now
                        n_out += 1
                    elif ev.get("done"):
                        complete = True
                        break
                    elif "error" in ev:
                        status = int(ev.get("code", 503))
                        break
            if not complete and status == 200:
                # upstream closed without done/error: a cut stream
                status = 599
        except urllib.error.HTTPError as e:
            e.read()
            status = e.code
        except (urllib.error.URLError, OSError):
            status = 599
        total = time.perf_counter() - t0
        return self._record(RequestResult(
            status, _classify(status) if not complete else "ok", req.t,
            total, ttft, tuple(gaps), True, n_out, req.in_burst))


def _sse_events(resp):
    """Minimal client-side SSE parse: yield each `data: {...}` event."""
    for raw in resp:
        line = raw.strip()
        if not line.startswith(b"data:"):
            continue
        try:
            yield json.loads(line[len(b"data:"):].strip())
        except json.JSONDecodeError:
            continue
