"""Prometheus text exposition of the metrics registry and the /metrics
endpoint (port of `fedml_tpu/utils/prometheus.py`).

`render_prometheus()` turns a registry snapshot into the text exposition
format 0.0.4 (HELP / TYPE comments, `_total`-suffixed counters,
cumulative `_bucket{le=...}` / `_sum` / `_count` histogram series), byte
for byte the JAX package's for the same metric operations;
`MetricsExporter` serves it from a background `ThreadingHTTPServer`.
Opt-in through `common_args.extra.metrics_port` (0 picks an ephemeral
port): the Simulator and the CentralizedTrainer call
`maybe_start_metrics_server(cfg)` at startup, and the serving runner
answers the same text on its own `/metrics` route.

`parse_prometheus()` is the inverse, so the exposition is checked by a
parser and not by string matching; `split_by_label` and
`histogram_percentile` read a parsed scrape.
"""
from __future__ import annotations

import logging
import math
import re
import threading
from typing import Optional

from . import metrics as mx

log = logging.getLogger(__name__)

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_INVALID = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize_name(name: str) -> str:
    """Dotted instrument names -> valid Prometheus metric names."""
    s = _INVALID.sub("_", name)
    if s and s[0].isdigit():
        s = "_" + s
    return s or "_"


def _fmt(v: float) -> str:
    if isinstance(v, float):
        if math.isinf(v):
            return "+Inf" if v > 0 else "-Inf"
        if math.isnan(v):
            return "NaN"
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


# ------------------------------------------------------------- label sets
# Label sets: a fleet collector re-renders each process's parsed
# snapshot with a `process` label, so the renderer and parser round-trip
# arbitrary label sets — escaping, multi-label, stable (sorted-by-key,
# `le` last) ordering — not just histogram `le`.
# Series identity is the canonical string `name{a="x",b="y"}`; snapshot
# dicts may use these identity strings as keys and everything downstream
# (render, parse, split_by_label) agrees on that convention. Label-less
# snapshots render byte-identically to the pre-label format.

def escape_label_value(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n")


def format_labels(labels: Optional[dict]) -> str:
    """Canonical `{a="x",b="y"}` rendering: keys sorted, except `le`
    always LAST (Prometheus convention for bucket series). Empty -> ""."""
    if not labels:
        return ""
    keys = sorted(k for k in labels if k != "le")
    if "le" in labels:
        keys.append("le")
    inner = ",".join(
        f'{k}="{escape_label_value(labels[k])}"' for k in keys)
    return "{" + inner + "}"


def parse_labels(s: Optional[str]) -> dict:
    """Inverse of `format_labels` on the text INSIDE the braces. Handles
    escaped `\\"`, `\\\\`, `\\n` in values; raises ValueError on anything
    a round trip could not have produced."""
    out: dict = {}
    if not s:
        return out
    i, n = 0, len(s)
    while i < n:
        j = s.find("=", i)
        if j < 0 or j + 1 >= n or s[j + 1] != '"':
            raise ValueError(f"malformed label set: {s!r}")
        key = s[i:j].strip()
        if not key or _INVALID.search(key):
            raise ValueError(f"malformed label name {key!r} in {s!r}")
        i = j + 2
        buf = []
        while i < n:
            c = s[i]
            if c == "\\":
                if i + 1 >= n:
                    raise ValueError(f"dangling escape in {s!r}")
                nxt = s[i + 1]
                buf.append({"n": "\n", '"': '"', "\\": "\\"}.get(nxt, nxt))
                i += 2
                continue
            if c == '"':
                break
            buf.append(c)
            i += 1
        if i >= n or s[i] != '"':
            raise ValueError(f"unterminated label value in {s!r}")
        out[key] = "".join(buf)
        i += 1
        if i < n:
            if s[i] != ",":
                raise ValueError(f"expected ',' after label in {s!r}")
            i += 1
    return out


def series_key(name: str, labels: Optional[dict] = None) -> str:
    """Canonical series identity: `name{a="x"}`; bare name when no
    labels. Snapshot dict keys use exactly this form."""
    return name + format_labels(labels)


def split_series_key(key: str) -> tuple[str, dict]:
    """Inverse of `series_key`."""
    brace = key.find("{")
    if brace < 0:
        return key, {}
    if not key.endswith("}"):
        raise ValueError(f"malformed series key: {key!r}")
    return key[:brace], parse_labels(key[brace + 1:-1])


def _merged_key(raw_key: str, extra: Optional[dict]) -> tuple[str, dict]:
    base, lbls = split_series_key(raw_key)
    if extra:
        lbls = {**lbls, **extra}
    return base, lbls


def render_prometheus(snapshot: Optional[dict] = None,
                      labels: Optional[dict] = None) -> str:
    """One registry snapshot as Prometheus text exposition. Counters gain
    the conventional `_total` suffix; histograms emit CUMULATIVE bucket
    counts (the registry stores per-bucket counts) with a closing
    `le="+Inf"` bucket equal to `_count`.

    `labels` (e.g. `{"process": "server"}`) is attached to EVERY sample;
    snapshot keys that are already series identities (`name{a="x"}`)
    keep their own labels merged under the extra ones. Histogram values
    accept either the registry form (`edges`/`counts`) or the parsed
    form (cumulative `buckets`), so a parsed snapshot re-renders."""
    snap = snapshot if snapshot is not None else mx.snapshot()
    lines: list[str] = []
    seen_meta: set[str] = set()

    def sort_key(raw: str) -> tuple[str, str]:
        base, lbls = _merged_key(raw, labels)
        return base, format_labels(lbls)

    def meta(n: str, kind: str, raw_base: str) -> None:
        if n not in seen_meta:
            seen_meta.add(n)
            lines.append(f"# HELP {n} fedml_tpu {kind} {raw_base}")
            lines.append(f"# TYPE {n} {kind}")

    for name in sorted(snap.get("counters", {}), key=sort_key):
        base, lbls = _merged_key(name, labels)
        n = sanitize_name(base)
        if not n.endswith("_total"):
            n += "_total"
        meta(n, "counter", base)
        lines.append(
            f"{n}{format_labels(lbls)} {_fmt(snap['counters'][name])}")
    for name in sorted(snap.get("gauges", {}), key=sort_key):
        base, lbls = _merged_key(name, labels)
        n = sanitize_name(base)
        meta(n, "gauge", base)
        lines.append(
            f"{n}{format_labels(lbls)} "
            f"{_fmt(float(snap['gauges'][name]))}")
    for name in sorted(snap.get("histograms", {}), key=sort_key):
        h = snap["histograms"][name]
        base, lbls = _merged_key(name, labels)
        n = sanitize_name(base)
        meta(n, "histogram", base)
        if "buckets" in h:                # parsed (cumulative) form
            cum = 0
            for le, c in h["buckets"]:
                cum = int(c)
                if math.isinf(le):
                    break
                lines.append(
                    f"{n}_bucket"
                    f"{format_labels({**lbls, 'le': _fmt(float(le))})} "
                    f"{cum}")
        else:                             # registry (per-bucket) form
            cum = 0
            counts = h.get("counts") or []
            edges = h.get("edges") or []
            for edge, c in zip(edges, counts):
                cum += c
                lines.append(
                    f"{n}_bucket"
                    f"{format_labels({**lbls, 'le': _fmt(float(edge))})} "
                    f"{cum}")
            if len(counts) > len(edges):      # overflow bucket
                cum += counts[len(edges)]
        lines.append(
            f"{n}_bucket{format_labels({**lbls, 'le': '+Inf'})} {cum}")
        lines.append(
            f"{n}_sum{format_labels(lbls)} "
            f"{_fmt(float(h.get('sum', 0.0)))}")
        # _count is the accumulated bucket total, not the snapshot's count
        # field: the JAX package's lock-free shards can tear the two apart
        # in a scrape, and rendering from the buckets keeps both packages'
        # text the same (parse_prometheus enforces +Inf == _count)
        lines.append(f"{n}_count{format_labels(lbls)} {cum}")
    return "\n".join(lines) + "\n"


_SAMPLE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)\s*$')


def parse_prometheus(text: str) -> dict:
    """Parse text exposition back into
    {"counters": {name: v}, "gauges": {name: v},
     "histograms": {name: {"count", "sum", "buckets": [(le, cum), ...]}}}.
    Names stay in their sanitized exposition form (counters keep `_total`);
    labeled samples key under their series identity (`name{a="x"}`, labels
    sorted — see `series_key`), so the same family scraped from N
    processes parses into N distinct, individually-validated series.
    Raises ValueError on malformed sample lines, so tests using it really
    do validate the format."""
    types: dict[str, str] = {}
    out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4:
                raise ValueError(f"line {lineno}: malformed TYPE: {line!r}")
            types[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE.match(line)
        if not m:
            raise ValueError(f"line {lineno}: malformed sample: {line!r}")
        name, labels, raw = m.groups()
        try:
            lbls = parse_labels(labels)
        except ValueError as e:
            raise ValueError(f"line {lineno}: malformed sample: {e}")
        value = float(raw.replace("+Inf", "inf").replace("-Inf", "-inf"))
        base = re.sub(r"_(bucket|sum|count)$", "", name)
        if types.get(base) == "histogram":
            le_s = lbls.pop("le", None)
            key = series_key(base, lbls)
            h = out["histograms"].setdefault(
                key, {"count": 0, "sum": 0.0, "buckets": []})
            if name.endswith("_bucket"):
                if le_s is None:
                    raise ValueError(
                        f"line {lineno}: histogram bucket without le label")
                le = float(le_s.replace("+Inf", "inf"))
                h["buckets"].append((le, value))
            elif name.endswith("_sum"):
                h["sum"] = value
            elif name.endswith("_count"):
                h["count"] = int(value)
            continue
        key = series_key(name, lbls)
        if types.get(name) == "counter":
            out["counters"][key] = value
        else:
            out["gauges"][key] = value
    # cumulative bucket sanity per series: monotone, +Inf == count
    for skey, h in out["histograms"].items():
        prev = 0.0
        for le, cum in h["buckets"]:
            if cum < prev:
                raise ValueError(
                    f"{skey}: non-monotonic cumulative bucket at le={le}")
            prev = cum
        if h["buckets"] and not math.isinf(h["buckets"][-1][0]):
            raise ValueError(f"{skey}: missing le=\"+Inf\" bucket")
        if h["buckets"] and int(h["buckets"][-1][1]) != h["count"]:
            raise ValueError(
                f"{skey}: +Inf bucket {h['buckets'][-1][1]} != "
                f"count {h['count']}")
    return out


def split_by_label(parsed: dict, label: str = "process") -> dict:
    """Group a parsed (or aggregated) snapshot by one label's value:
    {value: snapshot-with-that-label-stripped}. Series that do not carry
    the label land under "" — the fleet collector's own families, or a
    plain single-process scrape. The inverse of rendering N per-process
    snapshots with `labels={"process": name}` into one exposition."""
    out: dict = {}
    for section in ("counters", "gauges", "histograms"):
        for skey, v in (parsed.get(section) or {}).items():
            base, lbls = split_series_key(skey)
            who = lbls.pop(label, "")
            snap = out.setdefault(
                who, {"counters": {}, "gauges": {}, "histograms": {}})
            snap[section][series_key(base, lbls)] = v
    return out


def histogram_percentile(buckets, q: float) -> Optional[float]:
    """Percentile from PARSED cumulative buckets (a live reader's path):
    de-accumulate, then reuse the registry's percentile_from_counts."""
    if not buckets:
        return None
    edges = [le for le, _ in buckets if not math.isinf(le)]
    cums = [c for _, c in buckets]
    counts, prev = [], 0.0
    for c in cums:
        counts.append(int(c - prev))
        prev = c
    return mx.percentile_from_counts(edges, counts, q)


def write_metrics_response(handler) -> None:
    """Serve the current registry as a /metrics response on any
    BaseHTTPRequestHandler (shared by the exporter and the inference
    runner)."""
    body = render_prometheus().encode()
    handler.send_response(200)
    handler.send_header("Content-Type", CONTENT_TYPE)
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


class MetricsExporter:
    """Background /metrics HTTP server over the process-wide registry."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                log.debug("metrics: " + fmt, *args)

            def do_GET(self):
                if self.path in ("/metrics", "/"):
                    write_metrics_response(self)
                else:
                    body = b"see /metrics\n"
                    self.send_response(404)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.host = host
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def start(self) -> "MetricsExporter":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="fedml-metrics-exporter")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)


# one exporter per process: the Simulator and the CentralizedTrainer
# call maybe_start_metrics_server at startup; the registry is process-
# wide, so a second engine in the same process reuses the first endpoint.
_exporter: Optional[MetricsExporter] = None
_exporter_lock = threading.Lock()


def current_exporter() -> Optional[MetricsExporter]:
    return _exporter


def maybe_start_metrics_server(cfg) -> Optional[MetricsExporter]:
    """Start (or return) the process's /metrics endpoint when
    `common_args.extra.metrics_port` is set; port 0 binds an ephemeral port
    (the resolved port is on the returned exporter). Degrades instead of
    dying: a bind failure logs a warning and returns None — losing a
    training run to a busy port would be worse than losing the scrape."""
    global _exporter
    port = cfg.common_args.extra.get("metrics_port")
    if port is None:
        return None
    with _exporter_lock:
        if _exporter is not None:
            if int(port) not in (0, _exporter.port):
                log.warning(
                    "metrics_port=%r requested but this process's /metrics "
                    "endpoint is already bound on port %d — reusing it "
                    "(one exporter per process; the registry is process-"
                    "wide)", port, _exporter.port)
            return _exporter
        try:
            _exporter = MetricsExporter(port=int(port)).start()
            log.info("metrics endpoint on %s", _exporter.url)
        except OSError as e:
            log.warning("metrics_port=%r could not be bound (continuing "
                        "without /metrics): %s", port, e)
            return None
        return _exporter
