"""Round-time budgets: where a run's wall time went, from its span tree
(port of `fedml_tpu/utils/attribution.py`).

It walks the recorder's spans (live, or rebuilt from a finished run's
events JSONL, whose span rows carry a wall-clock "t") and splits each
round's wall clock into:

- transport: `comm.*` spans, broken out by the backend in span meta and
  by link (sender -> receiver);
- ingest: `fed.ingest.*` host-side staging;
- agg: the server's aggregation (`agg`, `secagg_unmask`, `cd_agg`);
- compute: the round's device work (`train`, `eval`, block and chunk
  variants, the centralized lane);
- idle: wall time none of the above claims.

Per category the intervals are unioned, and overlap across categories is
claimed once in the order transport > ingest > agg > compute, so the
transport share reads as the fraction of wall time a comm span was in
flight. Round r runs from its first round-tagged span to round r+1's.

`attribute()` is the analyzer; `render_table()` prints `report`'s table,
`budget_line()` the one-line `top` summary, `publish_gauges()` lands the
totals as `fed.budget.*` gauges, and `critical_path()` follows parent
links down the longest inclusive chain.
"""
from __future__ import annotations

from typing import Iterable, Optional

from . import metrics as _mx

# priority order for cross-category overlap claiming (first wins)
_CATEGORIES = ("transport", "ingest", "agg", "compute")


def classify(name: str) -> str:
    """Span name -> budget category (or "other", which bills to idle)."""
    if name.startswith(("comm.", "comm_")) or name == "comm":
        return "transport"
    if name.startswith("fed.ingest"):
        return "ingest"
    if name in ("agg", "secagg_unmask", "cd_agg") or name.startswith("agg."):
        return "agg"
    if name.startswith(("train", "eval", "round", "block", "local_", "fit",
                        "sa_train", "centralized", "gkt")):
        return "compute"
    return "other"


# ------------------------------------------------------------ interval math
def _union(iv: list) -> list:
    """Merge overlapping (a, b) intervals; returns sorted disjoint list."""
    out: list = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _subtract(iv: list, minus: list) -> list:
    """`iv` minus `minus`; both disjoint+sorted; result likewise."""
    out: list = []
    for a, b in iv:
        cur = a
        for ma, mb in minus:
            if mb <= cur or ma >= b:
                continue
            if ma > cur:
                out.append((cur, ma))
            cur = max(cur, mb)
            if cur >= b:
                break
        if cur < b:
            out.append((cur, b))
    return out


def _total(iv: list) -> float:
    return sum(b - a for a, b in iv)


# ------------------------------------------------------------- row adapters
def rows_from_recorder(rec=None) -> list[dict]:
    """Normalize the live recorder's spans to analyzer rows."""
    if rec is None:
        from .events import recorder

        rec = recorder
    with rec._agg_lock:
        spans = list(rec.spans)
    epoch = rec._epoch
    rows = []
    for s in spans:
        rows.append({"name": s.name, "t0": epoch + s.start,
                     "dur": max(s.duration, 0.0),
                     "round": s.meta.get("round"),
                     "backend": s.meta.get("backend"),
                     "sender": s.meta.get("sender"),
                     "receiver": s.meta.get("receiver"),
                     "span_id": s.span_id, "parent_id": s.parent_id})
    return rows


def rows_from_payloads(payloads: Iterable[dict]) -> list[dict]:
    """Normalize span sink rows (the events JSONL) to analyzer rows.
    Rows without a wall-clock "t" (a block's per-round rows) are skipped:
    they cannot be placed on the timeline."""
    rows = []
    for p in payloads:
        t = p.get("t")
        if t is None or p.get("name") is None:
            continue
        rows.append({"name": p["name"], "t0": float(t),
                     "dur": max(float(p.get("duration", 0.0)), 0.0),
                     "round": p.get("round"), "backend": p.get("backend"),
                     "sender": p.get("sender"),
                     "receiver": p.get("receiver"),
                     "span_id": p.get("span_id", ""),
                     "parent_id": p.get("parent_id", "")})
    return rows


# ----------------------------------------------------------------- analyzer
def _window_budget(rows: list[dict], a: float, b: float) -> dict:
    per_cat: dict[str, list] = {c: [] for c in _CATEGORIES}
    backends: dict[str, float] = {}
    links: dict[str, float] = {}
    for r in rows:
        lo = max(r["t0"], a)
        hi = min(r["t0"] + r["dur"], b)
        if hi <= lo:
            continue
        cat = classify(r["name"])
        if cat in per_cat:
            per_cat[cat].append((lo, hi))
        if cat == "transport":
            bk = r.get("backend") or "unknown"
            backends[bk] = backends.get(bk, 0.0) + (hi - lo)
            # per link: comm.send / comm.handle spans carry sender and
            # receiver meta, keyed "src->dst"
            snd, rcv = r.get("sender"), r.get("receiver")
            if snd is not None and rcv is not None:
                key = f"{snd}->{rcv}"
                links[key] = links.get(key, 0.0) + (hi - lo)
    claimed: list = []
    out: dict = {}
    for cat in _CATEGORIES:
        mine = _subtract(_union(per_cat[cat]), claimed)
        out[f"{cat}_s"] = round(_total(mine), 6)
        claimed = _union(claimed + mine)
    wall = b - a
    out["wall_s"] = round(wall, 6)
    out["idle_s"] = round(max(wall - _total(claimed), 0.0), 6)
    out["transport_share"] = (round(out["transport_s"] / wall, 4)
                              if wall > 0 else 0.0)
    out["transport_by_backend"] = {k: round(v, 6)
                                   for k, v in sorted(backends.items())}
    out["transport_by_link"] = {k: round(v, 6)
                                for k, v in sorted(links.items())}
    return out


def critical_path(rows: list[dict]) -> list[dict]:
    """Longest inclusive chain through the span tree: start at the
    longest root span and descend into the longest child at each level.
    [{name, dur}] from root to leaf."""
    by_id = {r["span_id"]: r for r in rows if r.get("span_id")}
    children: dict[str, list] = {}
    for r in rows:
        p = r.get("parent_id")
        if p and p in by_id:
            children.setdefault(p, []).append(r)
    roots = [r for r in rows if r.get("span_id")
             and (not r.get("parent_id") or r["parent_id"] not in by_id)]
    if not roots:
        return []
    cur = max(roots, key=lambda r: r["dur"])
    path = [{"name": cur["name"], "dur": round(cur["dur"], 6)}]
    seen = {cur["span_id"]}
    while True:
        kids = [k for k in children.get(cur["span_id"], [])
                if k.get("span_id") not in seen]
        if not kids:
            return path
        cur = max(kids, key=lambda r: r["dur"])
        seen.add(cur["span_id"])
        path.append({"name": cur["name"], "dur": round(cur["dur"], 6)})


def attribute(rows: list[dict], wall_s: Optional[float] = None) -> dict:
    """The budget: overall totals, per-round windows, and the critical
    path. `wall_s` overrides the observed first-to-last span extent
    (e.g. a harness passes its own run wall clock)."""
    rows = [r for r in rows if r.get("dur") is not None]
    if not rows:
        return {"wall_s": 0.0, "totals": None, "rounds": [],
                "critical_path": []}
    t0 = min(r["t0"] for r in rows)
    t1 = max(r["t0"] + r["dur"] for r in rows)
    if wall_s is not None and wall_s > 0:
        t1 = max(t1, t0 + wall_s)
    totals = _window_budget(rows, t0, t1)
    # round windows: first round-tagged span starts the round's window,
    # which runs to the next round's first span (last one to run end)
    starts: dict[int, float] = {}
    for r in rows:
        rd = r.get("round")
        if isinstance(rd, (int, float)):
            rd = int(rd)
            if rd not in starts or r["t0"] < starts[rd]:
                starts[rd] = r["t0"]
    rounds = []
    ordered = sorted(starts.items())
    for i, (rd, a) in enumerate(ordered):
        b = ordered[i + 1][1] if i + 1 < len(ordered) else t1
        if b <= a:
            continue
        rounds.append({"round": rd, **_window_budget(rows, a, b)})
    return {"wall_s": totals["wall_s"], "totals": totals, "rounds": rounds,
            "critical_path": critical_path(rows)}


# ----------------------------------------------------------------- renderers
def _fmt_backends(by_backend: dict, wall: float) -> str:
    if not by_backend:
        return "-"
    return ", ".join(f"{k} {v / wall:.0%}" if wall > 0 else f"{k} {v:.3f}s"
                     for k, v in by_backend.items())


def render_table(att: dict) -> str:
    """The report's budget table; transport share is the headline column."""
    if not att.get("totals"):
        return "round-time budget: no spans recorded"
    hdr = (f"{'round':>7}  {'wall_s':>8}  {'transport%':>10}  "
           f"{'compute_s':>9}  {'ingest_s':>8}  {'agg_s':>7}  {'idle_s':>7}"
           f"  by backend")
    lines = ["round-time budget (transport share = fraction of wall time "
             "a comm span was in flight):", hdr]

    def row(label, w):
        lines.append(
            f"{label:>7}  {w['wall_s']:>8.3f}  "
            f"{w['transport_share']:>10.1%}  {w['compute_s']:>9.3f}  "
            f"{w['ingest_s']:>8.3f}  {w['agg_s']:>7.3f}  "
            f"{w['idle_s']:>7.3f}  "
            f"{_fmt_backends(w['transport_by_backend'], w['wall_s'])}")

    for r in att["rounds"]:
        row(str(r["round"]), r)
    row("all", att["totals"])
    cp = att.get("critical_path") or []
    if cp:
        lines.append("critical path: " + " > ".join(
            f"{s['name']} {s['dur']:.3f}s" for s in cp[:6]))
    return "\n".join(lines)


def link_table(att: dict, snapshot: Optional[dict] = None) -> list[dict]:
    """Per-link transport rows: the span budget's time share joined with
    the `comm.link.<src>.<dst>.{bytes,rtt_ms}` instruments, one row a link
    either side saw (acks have bytes and no spans)."""
    totals = att.get("totals") or {}
    by_link = dict(totals.get("transport_by_link") or {})
    wall = float(totals.get("wall_s") or 0.0)
    snap = snapshot or {}
    counters = snap.get("counters") or {}
    hists = snap.get("histograms") or {}
    link_bytes: dict[str, float] = {}
    link_rtt: dict[str, dict] = {}
    for name, v in counters.items():
        parts = name.split(".")
        if name.startswith("comm.link.") and len(parts) == 5 \
                and parts[4] == "bytes":
            link_bytes[f"{parts[2]}->{parts[3]}"] = v
    for name, h in hists.items():
        parts = name.split(".")
        if name.startswith("comm.link.") and len(parts) == 5 \
                and parts[4] == "rtt_ms":
            link_rtt[f"{parts[2]}->{parts[3]}"] = h
    rows = []
    for link in sorted(set(by_link) | set(link_bytes) | set(link_rtt)):
        t = by_link.get(link, 0.0)
        h = link_rtt.get(link) or {}
        rows.append({
            "link": link,
            "transport_s": round(t, 6),
            "share": round(t / wall, 4) if wall > 0 else 0.0,
            "bytes": int(link_bytes.get(link, 0)),
            "rtt_ms_p50": h.get("p50"),
            "rtt_ms_p99": h.get("p99"),
            "rtt_count": h.get("count", 0),
        })
    return rows


def render_link_table(att: dict, snapshot: Optional[dict] = None) -> str:
    """The report's per-link transport table."""
    rows = link_table(att, snapshot)
    if not rows:
        return "per-link transport: no links observed"
    lines = ["per-link transport (share = fraction of wall time that "
             "link's spans were in flight):",
             f"{'link':>10}  {'transport_s':>11}  {'share':>6}  "
             f"{'bytes':>10}  {'rtt_p50':>8}  {'rtt_p99':>8}  {'acks':>6}"]
    for r in rows:
        p50 = f"{r['rtt_ms_p50']:.2f}ms" if r["rtt_ms_p50"] is not None \
            else "-"
        p99 = f"{r['rtt_ms_p99']:.2f}ms" if r["rtt_ms_p99"] is not None \
            else "-"
        lines.append(
            f"{r['link']:>10}  {r['transport_s']:>11.3f}  "
            f"{r['share']:>6.1%}  {r['bytes']:>10}  {p50:>8}  {p99:>8}  "
            f"{r['rtt_count']:>6}")
    return "\n".join(lines)


def budget_line(att: dict) -> str:
    """One-line summary for `top`."""
    t = att.get("totals")
    if not t:
        return "budget: no spans recorded"
    bk = _fmt_backends(t["transport_by_backend"], t["wall_s"])
    return (f"budget: wall {t['wall_s']:.1f}s transport "
            f"{t['transport_share']:.0%} ({bk}) compute {t['compute_s']:.1f}s"
            f" ingest {t['ingest_s']:.1f}s agg {t['agg_s']:.1f}s idle "
            f"{t['idle_s']:.1f}s")


def publish_gauges(att: dict) -> None:
    """Land the overall budget as `fed.budget.*` gauges (read by the
    `top` frame's `budget:` line and exportable over Prometheus)."""
    t = att.get("totals")
    if not t:
        return
    for k in ("wall_s", "compute_s", "transport_s", "ingest_s", "agg_s",
              "idle_s", "transport_share"):
        _mx.set_gauge(f"fed.budget.{k}", t[k])
    for bk, v in t["transport_by_backend"].items():
        _mx.set_gauge(f"fed.budget.transport.{bk}_s", v)


def analyze_and_publish(rec=None, wall_s: Optional[float] = None) -> dict:
    """For a run's teardown (`mlops._finish_report`): analyze the live
    recorder and publish the gauges."""
    att = attribute(rows_from_recorder(rec), wall_s=wall_s)
    publish_gauges(att)
    return att
