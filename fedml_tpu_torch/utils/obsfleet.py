"""Fleet observability: metric federation and merged, clock-corrected
traces (port of `fedml_tpu/utils/obsfleet.py`).

- `FleetCollector`: a background scraper over a roster of /metrics
  endpoints. Each scrape is parsed with `parse_prometheus`, cached, and
  re-exposed as one exposition where every family carries a `process`
  label. A process that stops answering keeps its last good snapshot
  and is marked stale, so a crashed peer stays visible. The roster comes
  from config (`common_args.extra.obs_fleet`) or from registration
  frames over the comm layer (`announce` / `install_registration`).
  `serve` exposes /metrics (the aggregate) and /fleet (JSON).
- `merge_traces`: N processes' Chrome traces folded into one Perfetto
  timeline: a pid lane per process, cross-process send -> handle spans
  stitched into flow events through the `_trace_id` / `_parent_span`
  headers (`comm/message.py`), and per-pair clock offsets estimated
  from matched send / receive pairs (the midpoint of the feasible
  interval). The merged trace never shows a receive before its
  corrected send: an offset the pairs cannot satisfy is clamped per
  event and counted. Offsets publish as `obs.clock_skew_ms.<a>.<b>`.
- `validate_obs_fleet` checks the config section at load;
  `maybe_start_fleet_collector` starts one collector per process.

Host Python over the standard library and `utils/prometheus.py`; the
JAX module's schema, names and behaviour.
"""
from __future__ import annotations

import collections
import json
import logging
import math
import os
import threading
import time
import urllib.request
from typing import Callable, Optional

from . import metrics as mx
from .prometheus import (CONTENT_TYPE, parse_prometheus, render_prometheus,
                         series_key, split_series_key)

log = logging.getLogger(__name__)

# self-registration frame type: a process that serves /metrics announces
# {"process": name, "url": url} to whoever hosts the collector (rank 0 by
# convention). Handlers read params by key, so the frame is inert to every
# other receiver.
OBS_REGISTER = "obs.register"


# ---------------------------------------------------------------- collector
class FleetCollector:
    """Scrape a roster of /metrics endpoints into one fleet view.

    `fetch` is injectable (url -> exposition text) so tests federate
    N registries without sockets; the default is a urllib GET with a
    per-scrape timeout. Thread-safe: the scrape loop, registration
    handler, and renderers share one lock."""

    def __init__(self, roster: Optional[dict] = None, *,
                 interval_s: float = 1.0, timeout_s: float = 2.0,
                 stale_after_s: float = 5.0,
                 fetch: Optional[Callable[[str], str]] = None):
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self.stale_after_s = float(stale_after_s)
        self._fetch = fetch or self._http_fetch
        self._lock = threading.Lock()
        self._roster: dict[str, str] = dict(roster or {})
        # process -> {"snapshot", "t", "ok", "error"}
        self._scrapes: dict[str, dict] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._exporter = None

    def _http_fetch(self, url: str) -> str:
        with urllib.request.urlopen(url, timeout=self.timeout_s) as r:
            return r.read().decode("utf-8", "replace")

    # ------------------------------------------------------------- roster
    def register(self, process: str, url: str) -> None:
        with self._lock:
            prev = self._roster.get(process)
            self._roster[process] = url
        if prev != url:
            mx.inc("obs.fleet.registrations")
            log.info("fleet roster: %s -> %s", process, url)

    def roster(self) -> dict:
        with self._lock:
            return dict(self._roster)

    def handle_register(self, msg) -> None:
        """comm-layer handler for OBS_REGISTER frames (Message in)."""
        p = msg.params if hasattr(msg, "params") else dict(msg)
        name = p.get("process")
        url = p.get("url")
        if name and url:
            self.register(str(name), str(url))

    # ------------------------------------------------------------- scrape
    def scrape_once(self) -> dict:
        """One pass over the roster. Returns {process: ok_bool}. A failed
        scrape keeps the previous snapshot (staleness marks it)."""
        ok: dict = {}
        for name, url in self.roster().items():
            try:
                snap = parse_prometheus(self._fetch(url))
                with self._lock:
                    self._scrapes[name] = {
                        "snapshot": snap, "t": time.monotonic(),
                        "ok": True, "error": None}
                mx.inc("obs.fleet.scrapes")
                ok[name] = True
            except Exception as e:          # noqa: BLE001 — keep scraping
                with self._lock:
                    ent = self._scrapes.get(name)
                    if ent is not None:
                        ent["ok"] = False
                        ent["error"] = str(e)
                    else:
                        self._scrapes[name] = {
                            "snapshot": None, "t": None,
                            "ok": False, "error": str(e)}
                mx.inc("obs.fleet.scrape_errors")
                ok[name] = False
        with self._lock:
            n_stale = sum(1 for s in self._scrapes.values()
                          if not self._is_fresh(s))
            mx.set_gauge("obs.fleet.processes", len(self._roster))
        mx.set_gauge("obs.fleet.stale", n_stale)
        return ok

    def _is_fresh(self, ent: dict) -> bool:
        return bool(ent.get("ok")) and ent.get("t") is not None and (
            time.monotonic() - ent["t"]) <= self.stale_after_s

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.scrape_once()
            except Exception:               # pragma: no cover — belt
                log.exception("fleet scrape pass failed")
            self._stop.wait(self.interval_s)

    def start(self) -> "FleetCollector":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="fedml-fleet-scraper")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self._exporter is not None:
            self._exporter.stop()
            self._exporter = None

    # ------------------------------------------------------------ views
    def fleet_snapshot(self) -> dict:
        """{"processes": {name: {"ok", "stale", "age_s", "error",
        "snapshot"}}, "sums": 3-key snapshot} — per-process columns plus
        fleet sums (counters/gauges summed, histograms bucket-merged)."""
        with self._lock:
            scrapes = {k: dict(v) for k, v in self._scrapes.items()}
            roster = dict(self._roster)
        procs: dict = {}
        for name in roster:
            ent = scrapes.get(
                name, {"snapshot": None, "t": None, "ok": False,
                       "error": "never scraped"})
            age = (time.monotonic() - ent["t"]) if ent["t"] else None
            procs[name] = {
                "ok": bool(ent["ok"]), "stale": not self._is_fresh(ent),
                "age_s": round(age, 3) if age is not None else None,
                "error": ent.get("error"), "snapshot": ent["snapshot"]}
        return {"processes": procs,
                "sums": fleet_sums(
                    {n: p["snapshot"] for n, p in procs.items()
                     if p["snapshot"]})}

    def aggregated_text(self) -> str:
        """All processes' last-good snapshots as ONE exposition, every
        family labeled with its process (plus the collector's own
        obs.fleet.* families, unlabeled)."""
        with self._lock:
            parts = [(name, ent["snapshot"]) for name, ent in
                     sorted(self._scrapes.items()) if ent["snapshot"]]
        merged: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, snap in parts:
            for section in ("counters", "gauges", "histograms"):
                for skey, v in (snap.get(section) or {}).items():
                    base, lbls = split_series_key(skey)
                    lbls["process"] = name
                    merged[section][series_key(base, lbls)] = v
        return render_prometheus(merged)

    # ------------------------------------------------------------ serving
    def serve(self, host: str = "127.0.0.1", port: int = 0):
        """Expose the aggregated view over HTTP: /metrics (exposition)
        and /fleet (JSON snapshot). Returns the exporter (has .url)."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        collector = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                log.debug("fleet: " + fmt, *args)

            def do_GET(self):
                if self.path in ("/metrics", "/"):
                    body = collector.aggregated_text().encode()
                    ctype = CONTENT_TYPE
                elif self.path == "/fleet":
                    snap = collector.fleet_snapshot()
                    body = json.dumps(snap).encode()
                    ctype = "application/json"
                else:
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        server = ThreadingHTTPServer((host, port), Handler)

        class _Exporter:
            def __init__(self):
                self.host = host
                self.port = server.server_address[1]
                self.url = f"http://{host}:{self.port}/metrics"
                self._thread = threading.Thread(
                    target=server.serve_forever, daemon=True,
                    name="fedml-fleet-exporter")
                self._thread.start()

            def stop(self):
                server.shutdown()
                server.server_close()
                self._thread.join(timeout=5)

        self._exporter = _Exporter()
        return self._exporter


def fleet_sums(per_process: dict) -> dict:
    """Sum N 3-key snapshots family-wise: counters/gauges add, histograms
    merge count/sum and cumulative buckets by le. The fleet-sums column —
    equal to the sum of per-process scrapes."""
    out: dict = {"counters": collections.defaultdict(float),
                 "gauges": collections.defaultdict(float),
                 "histograms": {}}
    for snap in per_process.values():
        for name, v in (snap.get("counters") or {}).items():
            out["counters"][name] += v
        for name, v in (snap.get("gauges") or {}).items():
            out["gauges"][name] += v
        for name, h in (snap.get("histograms") or {}).items():
            agg = out["histograms"].setdefault(
                name, {"count": 0, "sum": 0.0,
                       "buckets": collections.defaultdict(float)})
            agg["count"] += int(h.get("count", 0))
            agg["sum"] += float(h.get("sum", 0.0))
            for le, cum in h.get("buckets") or []:
                agg["buckets"][float(le)] += cum
    return {
        "counters": dict(out["counters"]),
        "gauges": {k: round(v, 9) for k, v in out["gauges"].items()},
        "histograms": {
            name: {"count": h["count"], "sum": round(h["sum"], 9),
                   "buckets": sorted(h["buckets"].items(),
                                     key=lambda kv: kv[0])}
            for name, h in out["histograms"].items()},
    }


# ------------------------------------------------------- self-registration
def announce(comm_manager, process: str, url: str,
             collector_rank: int = 0) -> None:
    """Send one OBS_REGISTER frame over the existing transport: the
    process serving /metrics at `url` asks the collector's host (rank 0
    by convention) to add it to the roster."""
    from ..comm.message import Message

    comm_manager.send_message(Message(
        OBS_REGISTER, comm_manager.rank, collector_rank,
        {"process": process, "url": url}))


def install_registration(comm_manager, collector: FleetCollector) -> None:
    """Route incoming OBS_REGISTER frames into the collector's roster."""
    comm_manager.register_message_receive_handler(
        OBS_REGISTER, collector.handle_register)


# ----------------------------------------------------------- trace merging
def load_trace(path: str) -> list[dict]:
    with open(path) as f:
        doc = json.load(f)
    return doc["traceEvents"] if isinstance(doc, dict) else doc


def _span_index(events: list[dict]) -> tuple[dict, list]:
    """(sends, handles) from one process's trace: sends keyed by span_id,
    handles as (ts, parent_id, tid, dur)."""
    sends: dict = {}
    handles: list = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        args = ev.get("args") or {}
        name = ev.get("name", "")
        if name.startswith("comm.send.") and args.get("span_id"):
            sends[args["span_id"]] = ev
        elif name.startswith("comm.handle.") and args.get("parent_id"):
            handles.append(ev)
    return sends, handles


def _pair_offsets(pairs_by_edge: dict) -> tuple[dict, int]:
    """Per-edge clock offsets (µs) from matched send/recv constraints.

    For edge (a, b) define θ as b's clock minus a's clock (corrected
    b-time = ts_b − θ). Every a→b message bounds θ from ABOVE
    (recv_b − θ ≥ send_a, network latency is nonnegative), every b→a
    message bounds it from BELOW. With both directions θ is the midpoint
    of the feasible interval — the classic NTP-style estimate that
    cancels symmetric path latency; one direction alone uses its tight
    bound (latency → 0 assumption). Returns ({(a, b): θ_us}, n_pairs)."""
    offsets: dict = {}
    n_pairs = 0
    for (a, b), pairs in pairs_by_edge.items():
        uppers = [recv - send for direction, send, recv in pairs
                  if direction == "ab"]
        lowers = [send - recv for direction, send, recv in pairs
                  if direction == "ba"]
        n_pairs += len(pairs)
        if uppers and lowers:
            lo, hi = max(lowers), min(uppers)
            theta = (lo + hi) / 2.0
        elif uppers:
            theta = min(uppers)
        elif lowers:
            theta = max(lowers)
        else:
            continue
        offsets[(a, b)] = theta
    return offsets, n_pairs


def _propagate(n: int, edge_offsets: dict) -> list[float]:
    """Absolute per-process offsets (vs process 0's clock) by BFS over
    the pair graph; unreachable processes keep offset 0 (nothing to
    correct against)."""
    adj: dict = collections.defaultdict(list)
    for (a, b), th in edge_offsets.items():
        adj[a].append((b, th))
        adj[b].append((a, -th))
    offs = [0.0] * n
    seen = {0}
    queue = collections.deque([0])
    while queue:
        cur = queue.popleft()
        for nxt, th in adj[cur]:
            if nxt in seen:
                continue
            seen.add(nxt)
            offs[nxt] = offs[cur] + th
            queue.append(nxt)
    # components not containing 0: anchor each at its lowest index
    for root in range(1, n):
        if root in seen:
            continue
        seen.add(root)
        queue.append(root)
        while queue:
            cur = queue.popleft()
            for nxt, th in adj[cur]:
                if nxt in seen:
                    continue
                seen.add(nxt)
                offs[nxt] = offs[cur] + th
                queue.append(nxt)
    return offs


def merge_traces(inputs: list[tuple[str, str]],
                 out_path: Optional[str] = None) -> dict:
    """Merge [(process_name, trace_path), ...] into one Chrome/Perfetto
    trace: per-process pid lanes, clock-offset-corrected timestamps, and
    a flow event ("s"→"f") for every cross-process send→handle pair.
    Guarantees no stitched recv precedes its corrected send — offsets the
    constraints cannot satisfy are clamped per event and counted.
    Returns the merge summary (and writes the trace to `out_path`)."""
    procs = [(name, load_trace(path)) for name, path in inputs]
    indexed = [_span_index(evts) for _, evts in procs]

    # cross-process send→handle pairs, grouped by unordered process edge
    send_owner = {sid: i for i, (sends, _) in enumerate(indexed)
                  for sid in sends}
    matches = []                      # (send_proc, recv_proc, send_ev, hev)
    pairs_by_edge: dict = collections.defaultdict(list)
    for i, (_, handles) in enumerate(indexed):
        for hev in handles:
            pid_from = send_owner.get((hev.get("args") or {}).get(
                "parent_id"))
            if pid_from is None or pid_from == i:
                continue
            sev = indexed[pid_from][0][hev["args"]["parent_id"]]
            matches.append((pid_from, i, sev, hev))
            a, b = (pid_from, i) if pid_from < i else (i, pid_from)
            direction = "ab" if pid_from == a else "ba"
            pairs_by_edge[(a, b)].append(
                (direction, sev["ts"], hev["ts"]))

    edge_offsets, n_pairs = _pair_offsets(pairs_by_edge)
    offs = _propagate(len(procs), edge_offsets)

    skew_ms = {}
    for (a, b), th in edge_offsets.items():
        name_a, name_b = procs[a][0], procs[b][0]
        ms = round(th / 1000.0, 3)
        skew_ms[f"{name_a}->{name_b}"] = ms
        mx.set_gauge(f"obs.clock_skew_ms.{name_a}.{name_b}", ms)

    # per-event clamp shifts: a corrected recv may still precede its
    # corrected send when the pair constraints were infeasible (relative
    # drift, asymmetric routes) — the invariant wins over the estimate
    shifts: dict = {}
    clamped = 0
    for pid_from, pid_to, sev, hev in matches:
        send_t = sev["ts"] - offs[pid_from]
        recv_t = hev["ts"] - offs[pid_to] + shifts.get(id(hev), 0.0)
        if recv_t < send_t:
            shifts[id(hev)] = shifts.get(id(hev), 0.0) + (send_t - recv_t)
            clamped += 1

    merged: list[dict] = []
    by_orig: dict = {}                # original event -> corrected copy
    for i, (name, evts) in enumerate(procs):
        merged.append({"ph": "M", "name": "process_name", "pid": i,
                       "tid": 0, "args": {"name": name}})
        for ev in evts:
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                continue                  # replaced by the lane label
            copy = dict(ev)
            copy["pid"] = i
            if "ts" in copy:
                copy["ts"] = (copy["ts"] - offs[i]
                              + shifts.get(id(ev), 0.0))
            merged.append(copy)
            by_orig[id(ev)] = copy

    flows = 0
    for k, (pid_from, pid_to, sev, hev) in enumerate(matches):
        s_copy, h_copy = by_orig[id(sev)], by_orig[id(hev)]
        common = {"cat": "comm", "name": "comm.flow", "id": k}
        merged.append({"ph": "s", "pid": pid_from, "tid": sev.get("tid", 0),
                       "ts": s_copy["ts"], **common})
        merged.append({"ph": "f", "bp": "e", "pid": pid_to,
                       "tid": hev.get("tid", 0), "ts": h_copy["ts"],
                       **common})
        flows += 1

    doc = {"traceEvents": merged, "displayTimeUnit": "ms",
           "otherData": {"clock_skew_ms": skew_ms,
                         "processes": [n for n, _ in procs],
                         "clamped_events": clamped}}
    if out_path:
        tmp = out_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, out_path)
    return {"out": out_path, "processes": [n for n, _ in procs],
            "events": len(merged), "pairs": n_pairs, "flows": flows,
            "clock_skew_ms": skew_ms, "clamped": clamped,
            "offsets_us": [round(o, 3) for o in offs],
            "trace": doc if not out_path else None}


def verify_merged_order(doc: dict) -> int:
    """Violation count: stitched flows whose finish ("f") precedes their
    start ("s") in the merged timeline. 0 is the pinned invariant."""
    starts: dict = {}
    bad = 0
    evts = doc["traceEvents"] if isinstance(doc, dict) else doc
    for ev in evts:
        if ev.get("name") != "comm.flow":
            continue
        if ev.get("ph") == "s":
            starts[ev["id"]] = ev["ts"]
    for ev in evts:
        if ev.get("name") == "comm.flow" and ev.get("ph") == "f":
            s = starts.get(ev["id"])
            if s is not None and ev["ts"] < s:
                bad += 1
    return bad


# ----------------------------------------------------------------- config
_KNOWN_KEYS = ("roster", "port", "interval_s", "timeout_s", "stale_after_s")


def validate_obs_fleet(d: dict) -> dict:
    """Validate `common_args.extra.obs_fleet` at config-load time (the
    config.py pattern: fail at load, not mid-run). Returns the dict."""
    if not isinstance(d, dict):
        raise ValueError(f"obs_fleet must be a dict, got {type(d).__name__}")
    unknown = set(d) - set(_KNOWN_KEYS)
    if unknown:
        raise ValueError(
            f"obs_fleet: unknown keys {sorted(unknown)} "
            f"(known: {list(_KNOWN_KEYS)})")
    roster = d.get("roster", {})
    if not isinstance(roster, dict) or not all(
            isinstance(k, str) and isinstance(v, str)
            for k, v in roster.items()):
        raise ValueError("obs_fleet.roster must be {process_name: url}")
    port = d.get("port")
    if port is not None and (isinstance(port, bool)
                             or not isinstance(port, int)
                             or not 0 <= port <= 65535):
        raise ValueError(f"obs_fleet.port must be an int in [0, 65535], "
                         f"got {port!r}")
    for key in ("interval_s", "timeout_s", "stale_after_s"):
        v = d.get(key)
        if v is not None and (isinstance(v, bool) or
                              not isinstance(v, (int, float))
                              or not math.isfinite(v) or v <= 0):
            raise ValueError(f"obs_fleet.{key} must be a positive number, "
                             f"got {v!r}")
    return d


_collector: Optional[FleetCollector] = None
_collector_lock = threading.Lock()


def current_collector() -> Optional[FleetCollector]:
    return _collector


def maybe_start_fleet_collector(cfg):
    """Start (or return) the process's fleet collector when
    `common_args.extra.obs_fleet` is configured. Mirrors
    maybe_start_metrics_server: one collector per process, degrade on
    bind failure instead of dying."""
    global _collector
    d = cfg.common_args.extra.get("obs_fleet")
    if not d:
        return None
    d = validate_obs_fleet(d)
    with _collector_lock:
        if _collector is not None:
            return _collector
        coll = FleetCollector(
            d.get("roster"),
            interval_s=d.get("interval_s", 1.0),
            timeout_s=d.get("timeout_s", 2.0),
            stale_after_s=d.get("stale_after_s", 5.0)).start()
        if d.get("port") is not None:
            try:
                exp = coll.serve(port=int(d["port"]))
                log.info("fleet /metrics on %s", exp.url)
            except OSError as e:
                log.warning("obs_fleet.port=%r could not be bound "
                            "(collector runs without its endpoint): %s",
                            d["port"], e)
        _collector = coll
        return _collector
