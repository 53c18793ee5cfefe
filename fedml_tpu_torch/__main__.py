"""CLI: `python -m fedml_tpu_torch <cmd>` (port of `fedml_tpu/__main__.py`).

(reference: python/fedml/cli/cli.py:18-76, the click commands `fedml
version / env / run / build / logs / diagnosis / ...`.)

  version    the package version
  env        torch, CUDA, the visible cards, nvcc and triton
  run        a simulation or centralized config (`--cf`, `--rounds`,
             `--device`: CUDA unless `--device cpu`; it raises without a
             GPU, as every entry point does)
  launch     a scheduler job spec (YAML or JSON: {"type": "simulation" |
             "python" | "serve", ..., "requirements": {...}}) through a
             local MasterAgent and one WorkerAgent (`--store` for a durable
             sqlite queue, `--timeout`, `--device`); prints {"job_id",
             "status", "result"} and exits 0 iff the job FINISHED
  build      a job directory as a tarball with a sha256 manifest
  logs       the per-run logs and events the mlops facade wrote
  report     a tracked run's telemetry (text, or `--format json`);
             `--merge dirA dirB ...` folds N processes' Chrome traces into
             one clock-corrected timeline (exit 1 if a stitched receive
             still precedes its send), `--fleet URL` folds a fleet
             collector's snapshot in
  top        one screen of run health from /metrics or a finished run;
             `--fleet` renders a collector's aggregate per process
  lint       graftlint over the port's tree (`analysis/`): exit 0 clean,
             1 findings, 2 usage error (`--format json`, `--rules`,
             `--list-rules`, explicit paths)
  diagnosis  the port's battery: the card, the kernels K1-K4 against
             their plain versions, the transports, the codec, the serving
             engine, the ledger, the fleet plane and the linter
             (`--only`, `--device`)

`bench` is not ported yet (the port has no benchmark): it exits 2.
Output formats, schemas and exit codes are the JAX package's.
"""
from __future__ import annotations

import argparse
import json
import sys

_LATER = {
    "bench": "a benchmark of the port (there is none yet; bench.py at the "
             "repository root is the JAX package's)",
}


def _later(verb: str) -> int:
    print(f"{verb} is not ported yet: it comes with {_LATER[verb]}",
          file=sys.stderr)
    return 2


def cmd_version(_args) -> int:
    from . import __version__

    print(f"fedml_tpu_torch {__version__}")
    return 0


def cmd_env(_args) -> int:
    """Environment report (reference: `fedml env`)."""
    import importlib
    import importlib.util
    import platform

    info = {"python": sys.version.split()[0],
            "platform": platform.platform()}
    try:
        import torch

        info["torch"] = torch.__version__
        info["cuda"] = torch.version.cuda
        info["cuda_available"] = torch.cuda.is_available()
        n = torch.cuda.device_count() if info["cuda_available"] else 0
        info["device_count"] = n
        info["devices"] = [torch.cuda.get_device_name(i) for i in range(n)]
        info["capability"] = [list(torch.cuda.get_device_capability(i))
                              for i in range(n)]
    except Exception as e:  # noqa: BLE001 — a report, not a gate
        info["torch_error"] = str(e)
    try:
        from .ops._build import _nvcc

        info["nvcc"] = _nvcc()
    except Exception as e:  # noqa: BLE001
        info["nvcc"] = None
        info["nvcc_error"] = str(e)
    info["triton"] = None
    if importlib.util.find_spec("triton") is not None:
        info["triton"] = getattr(importlib.import_module("triton"),
                                 "__version__", "?")
    for mod in ("numpy", "yaml", "psutil", "grpc"):
        try:
            m = importlib.import_module(mod)
            info[mod] = getattr(m, "__version__", "?")
        except Exception:
            info[mod] = None
    print(json.dumps(info, indent=2))
    return 0


def cmd_run(args) -> int:
    """Config-driven run (reference: `fedml run` on a fedml_config.yaml);
    training_type picks the runtime. Prints the last history row."""
    import fedml_tpu_torch

    from .config import TRAINING_TYPE_CENTRALIZED, TRAINING_TYPE_SIMULATION
    from .runner import FedMLRunner

    cfg = fedml_tpu_torch.init(config_path=args.config, device=args.device)
    if args.rounds is not None:
        cfg.train_args.comm_round = args.rounds
    tt = cfg.common_args.training_type
    if tt == TRAINING_TYPE_SIMULATION:
        hist = fedml_tpu_torch.run_simulation(cfg)
        print(json.dumps(hist[-1]))
        return 0
    if tt == TRAINING_TYPE_CENTRALIZED:
        hist = FedMLRunner(cfg).run()
        print(json.dumps(hist[-1]))
        return 0
    # cross_silo / cross_device need model and per-role dataset wiring the
    # config alone cannot express: those run through the Python API
    print(f"training_type={tt!r} requires the python API "
          "(fedml_tpu_torch.FedMLRunner with model/dataset); the CLI "
          "runs simulation and centralized configs", file=sys.stderr)
    return 2


def cmd_launch(args) -> int:
    """Submit a job spec through the scheduler tier (reference: `fedml
    launch job.yaml` submits to the Launch platform; here the MasterAgent
    is local-first — loopback, and durable when --store is given). The
    worker runs simulation and serve jobs on --device (CUDA unless "cpu";
    without a GPU the default raises before anything starts). A python
    job's "package.module:function" entry is imported here, from the job
    file the user handed over, and registered on this command's own
    worker; a worker never imports an entry that reaches it on the wire."""
    import importlib
    import uuid

    from ._device import resolve_device
    from .comm import FedCommManager
    from .comm.loopback import LoopbackTransport, release_router
    from .config import read_config_file
    from .scheduler import MasterAgent, WorkerAgent

    dev = resolve_device(args.device)
    spec = read_config_file(args.job)
    run_id = f"launch-{uuid.uuid4().hex[:6]}"
    master = MasterAgent(FedCommManager(LoopbackTransport(0, run_id), 0),
                         store_path=args.store)
    worker = WorkerAgent(FedCommManager(LoopbackTransport(1, run_id), 1), 1,
                         device=dev)
    entry = spec.get("entry") if spec.get("type") == "python" else None
    if isinstance(entry, str) and ":" in entry:
        mod, _, name = entry.partition(":")
        fn = getattr(importlib.import_module(mod), name, None)
        if fn is not None:
            worker.register_python_job(entry, fn)
    master.run()
    worker.run()
    worker.announce()
    jid = master.submit(spec)
    job = master.wait(jid, timeout=args.timeout)
    print(json.dumps({"job_id": jid, "status": job.status,
                      "result": _jsonable(job.result)}))
    master.stop()
    worker.stop()
    release_router(run_id)
    return 0 if job.status == "FINISHED" else 1


def _jsonable(x):
    try:
        json.dumps(x)
        return x
    except (TypeError, ValueError):
        return repr(x)


def cmd_build(args) -> int:
    """A job directory as a tarball with a manifest (reference: `fedml
    build`): the source, the entry and a sha256 manifest."""
    import hashlib
    import io
    import os
    import tarfile
    import time

    src = os.path.abspath(args.source)
    if not os.path.isdir(src):
        print(f"source dir not found: {src}", file=sys.stderr)
        return 1
    entry = args.entry
    if entry and not os.path.exists(os.path.join(src, entry)):
        print(f"entry {entry!r} not found under {src}", file=sys.stderr)
        return 1
    name = args.name or os.path.basename(src.rstrip("/"))
    os.makedirs(args.dest, exist_ok=True)
    out = os.path.join(args.dest, f"{name}.tar.gz")
    manifest = {"name": name, "entry": entry, "created": time.time(),
                "files": {}}
    for root, _dirs, files in os.walk(src):
        for fn in sorted(files):
            p = os.path.join(root, fn)
            rel = os.path.relpath(p, src)
            if rel == "fedml_manifest.json":
                continue  # superseded by the generated manifest below
            with open(p, "rb") as f:
                manifest["files"][rel] = hashlib.sha256(f.read()).hexdigest()
    # the manifest goes into the tarball from memory, never into the
    # source dir; an older fedml_manifest.json there is left out, so the
    # archive holds exactly one
    man_bytes = json.dumps(manifest, indent=2).encode()
    with tarfile.open(out, "w:gz") as tar:
        tar.add(src, arcname=name,
                filter=lambda ti: None
                if ti.name == f"{name}/fedml_manifest.json" else ti)
        info = tarfile.TarInfo(f"{name}/fedml_manifest.json")
        info.size = len(man_bytes)
        info.mtime = int(manifest["created"])
        tar.addfile(info, io.BytesIO(man_bytes))
    print(json.dumps({"package": out, "files": len(manifest["files"]),
                      "entry": entry}))
    return 0


def cmd_logs(args) -> int:
    """The per-run logs and events the mlops facade wrote under
    tracking_args.log_file_dir (reference: `fedml logs`)."""
    import os

    d = args.log_dir
    if not os.path.isdir(d):
        print(f"no log dir {d!r}", file=sys.stderr)
        return 1
    names = sorted(os.listdir(d))
    if args.run is not None:
        names = [n for n in names if n.startswith(args.run)]
    if args.list or not names:
        print(json.dumps({"log_dir": d, "runs": names}))
        return 0
    for n in names:
        p = os.path.join(d, n)
        if not os.path.isfile(p):
            continue
        with open(p) as f:
            lines = f.readlines()
        for line in lines[-args.tail:]:
            sys.stdout.write(f"[{n}] {line}")
    return 0


def _newest_events_file(log_dir: str, run) -> str:
    """The newest `<run>.events.jsonl` under `log_dir` (optionally by
    run-name prefix), for `report` and `top`."""
    import os

    if not os.path.isdir(log_dir):
        raise FileNotFoundError(f"no log dir {log_dir!r}")
    names = sorted(n for n in os.listdir(log_dir)
                   if n.endswith(".events.jsonl")
                   and (run is None or n.startswith(run)))
    if not names:
        raise FileNotFoundError(
            f"no *.events.jsonl under {log_dir!r}"
            + (f" matching {run!r}" if run else ""))
    return max((os.path.join(log_dir, n) for n in names),
               key=os.path.getmtime)


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024 or unit == "TB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}TB"


def cmd_report(args) -> int:
    """A tracked run's telemetry from its events JSONL
    (`utils/sinks.JsonlSink`): span durations, the round-time budget
    table, SLO alert totals, metric-row counts, the end-of-run snapshot
    `mlops.finish` appended, the postmortem and the Chrome trace's path.
    `--format json` prints the same facts as one object (schema 2, the
    JAX package's); the exit codes are the same in both formats.
    `--merge` switches to trace federation (`_report_merge`); `--fleet
    URL` folds a fleet collector's snapshot (per-process columns, fleet
    sums, staleness marks) into the report, or makes the whole report
    when there is no local run."""
    import os

    if getattr(args, "merge", None):
        return _report_merge(args)

    fleet = None
    if getattr(args, "fleet", None):
        try:
            fleet = _fetch_fleet(args.fleet)
        except Exception as e:  # noqa: BLE001 — operator-facing CLI
            print(f"fleet fetch failed: {type(e).__name__}: {e}",
                  file=sys.stderr)
            return 1

    path = args.events
    if path is None:
        try:
            path = _newest_events_file(args.log_dir, args.run)
        except FileNotFoundError as e:
            if fleet is not None:
                # a fleet-only report: a live fleet needs no local run
                if getattr(args, "format", "text") == "json":
                    print(json.dumps({"schema": 2, "fleet": fleet},
                                     indent=2, sort_keys=True))
                else:
                    print(_render_fleet(fleet))
                return 0
            print(str(e), file=sys.stderr)
            return 1

    spans: dict = {}
    span_rows: list = []
    n_metrics = n_sysperf = 0
    report_row = None
    with open(path) as f:
        for line in f:
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                continue
            if row.get("kind") == "span":
                agg = spans.setdefault(row.get("name", "?"),
                                       {"count": 0, "total_s": 0.0})
                agg["count"] += 1
                agg["total_s"] += float(row.get("duration", 0.0))
                span_rows.append(row)
            elif row.get("kind") == "metrics":
                n_metrics += 1
                if "sysperf" in row:
                    n_sysperf += 1
                if "report" in row:
                    report_row = row["report"]

    if not spans and n_metrics == 0:
        print(f"no telemetry rows in {path} — the run wrote no spans or "
              "metrics (did it crash before the first round, or run with "
              "tracking disabled?)", file=sys.stderr)
        return 1

    from .utils.attribution import (
        attribute, link_table, render_link_table, render_table,
        rows_from_payloads,
    )
    from .utils.postmortem import load_postmortem

    att = attribute(rows_from_payloads(span_rows))
    snap = (report_row or {}).get("metrics", {})
    counters = snap.get("counters", {})
    hists = snap.get("histograms", {})
    gauges = snap.get("gauges", {})
    dropped_total = int(counters.get("events.dropped_total", 0))
    raw = sum(v for k, v in counters.items()
              if k.startswith("comm.codec.") and k.endswith(".bytes_raw"))
    wire = sum(v for k, v in counters.items()
               if k.startswith("comm.codec.") and k.endswith(".bytes_wire"))
    lg_req = counters.get("loadgen.requests", 0)
    alerts_total = int(counters.get("slo.alerts_total", 0))
    alerts = {k[len("slo.alerts."):]: int(v) for k, v in counters.items()
              if k.startswith("slo.alerts.")}
    burns = {k[len("slo.burn."):]: v for k, v in gauges.items()
             if k.startswith("slo.burn.")}
    trace = path.replace(".events.jsonl", ".trace.json")
    links = link_table(att, snapshot=snap if report_row else None)
    # a crashed or SIGKILLed process leaves <run_dir>/postmortem.json
    pm = load_postmortem(os.path.dirname(os.path.abspath(path)))

    if getattr(args, "format", "text") == "json":
        out = {
            "schema": 2,
            "links": links,
            "postmortem": pm,
            "fleet": fleet,
            "events_path": path,
            "trace_path": trace if os.path.exists(trace) else None,
            "metric_rows": n_metrics,
            "sysperf_rows": n_sysperf,
            "spans": spans,
            "budget": att,
            "slo": {"alerts_total": alerts_total, "alerts": alerts,
                    "burn": burns},
            "dropped_spans_total": dropped_total,
            "headline": {
                "wire_codec_reduction": (raw / wire) if raw and wire
                else None,
                "loadgen_requests": int(lg_req) if lg_req else None,
            },
            "metrics": snap if report_row else None,
        }
        print(json.dumps(out, indent=2, sort_keys=True))
        return 0

    print(f"run events: {path}")
    if dropped_total:
        print(f"WARNING: trace TRUNCATED — {dropped_total} span/metric "
              "rows dropped past the in-memory ring cap "
              "(FEDML_TPU_EVENTS_CAP); the events JSONL keeps every row, "
              "but the exported Chrome trace is missing the oldest spans",
              file=sys.stderr)
    if os.path.exists(trace):
        print(f"chrome trace: {trace}  (open at ui.perfetto.dev)")
    if pm is not None and pm.get("reason") != "finish":
        import time as _time

        died = _time.strftime("%Y-%m-%d %H:%M:%S",
                              _time.localtime(pm.get("t", 0)))
        print(f"POSTMORTEM: process {pm.get('process')!r} died at {died} "
              f"({pm.get('reason')}); last span was "
              f"{pm.get('last_span')!r} — {len(pm.get('spans') or [])} "
              f"spans, {len(pm.get('frames') or [])} comm frames in "
              + os.path.join(os.path.dirname(os.path.abspath(path)),
                             "postmortem.json"))
    print(f"metric rows: {n_metrics} ({n_sysperf} sysperf)")
    if spans:
        print("spans:")
        width = max(len(n) for n in spans)
        for name, agg in sorted(spans.items(),
                                key=lambda kv: -kv[1]["total_s"]):
            avg_ms = agg["total_s"] / agg["count"] * 1e3
            print(f"  {name:<{width}}  count={agg['count']:<8d} "
                  f"total={agg['total_s']:.3f}s  avg={avg_ms:.2f}ms")
    if att.get("totals"):
        print(render_table(att))
    if links:
        print(render_link_table(att, snapshot=snap if report_row else None))
    if fleet is not None:
        print(_render_fleet(fleet))
    if report_row:
        if raw and wire:
            print(f"wire codec: {raw / wire:.1f}x payload reduction "
                  f"({_fmt_bytes(raw)} raw -> {_fmt_bytes(wire)} wire)")
        if lg_req:
            print(f"live loop: {int(lg_req)} requests — "
                  f"ok {int(counters.get('loadgen.ok', 0))}, "
                  f"shed {int(counters.get('loadgen.shed', 0))}, "
                  f"err {int(counters.get('loadgen.errors', 0))}; "
                  f"{int(counters.get('soak.publishes', 0))} rounds "
                  "published to serving")
        if alerts_total:
            worst = max(burns.items(), key=lambda kv: kv[1],
                        default=(None, 0.0))
            print(f"slo alerts: {alerts_total} fired ("
                  + ", ".join(f"{k} x{v}" for k, v in sorted(alerts.items()))
                  + (f"); worst burn {worst[0]} {worst[1]:.1f}x"
                     if worst[0] else ")"))
        if counters:
            print("counters:")
            for k in sorted(counters):
                print(f"  {k} = {counters[k]}")
        if hists:
            print("histograms:")
            for k in sorted(hists):
                h = hists[k]
                print(f"  {k}  count={h.get('count')} "
                      f"p50={h.get('p50')} p99={h.get('p99')} "
                      f"max={h.get('max')}")
        if gauges:
            print("gauges:")
            for k in sorted(gauges):
                print(f"  {k} = {gauges[k]}")
    else:
        print("(no end-of-run metrics snapshot row — run finished without "
              "mlops.finish, or predates the telemetry layer)")
    return 0


def _report_merge(args) -> int:
    """`report --merge dirA dirB ...`: fold N run dirs' (or trace files')
    Chrome traces into one clock-corrected Perfetto timeline with a flow
    arrow per cross-process send -> handle pair
    (`utils/obsfleet.merge_traces`). Exit 1 if the corrected timeline
    still shows a receive before its send."""
    import os

    from .utils.obsfleet import (load_trace, merge_traces,
                                 verify_merged_order)

    inputs = []
    for spec in args.merge:
        if os.path.isfile(spec):
            path = spec
            name = os.path.basename(spec).split(".")[0] or spec
        elif os.path.isdir(spec):
            names = [n for n in os.listdir(spec)
                     if n.endswith(".trace.json")]
            if not names:
                print(f"--merge: no *.trace.json under {spec!r}",
                      file=sys.stderr)
                return 1
            path = max((os.path.join(spec, n) for n in names),
                       key=os.path.getmtime)
            name = os.path.basename(os.path.normpath(spec))
        else:
            print(f"--merge: {spec!r} is neither a trace file nor a run "
                  "dir", file=sys.stderr)
            return 1
        inputs.append((name, path))
    # duplicate lane names would fold two processes into one pid label
    counts: dict = {}
    uniq = []
    for name, path in inputs:
        n = counts.get(name, 0)
        counts[name] = n + 1
        uniq.append((f"{name}#{n}" if n else name, path))
    out_path = args.out or "merged.trace.json"
    res = merge_traces(uniq, out_path=out_path)
    bad = verify_merged_order(load_trace(out_path))
    if getattr(args, "format", "text") == "json":
        print(json.dumps(
            {**{k: v for k, v in res.items() if k != "trace"},
             "order_violations": bad}, indent=2, sort_keys=True))
        return 0 if bad == 0 else 1
    print(f"merged trace: {out_path}  (open at ui.perfetto.dev)")
    print(f"processes: {len(res['processes'])} "
          f"({', '.join(res['processes'])})  events: {res['events']}  "
          f"send->handle pairs: {res['pairs']}  "
          f"stitched flows: {res['flows']}")
    if res["clock_skew_ms"]:
        print("clock skew: " + "  ".join(
            f"{k} {v:+.3f}ms"
            for k, v in sorted(res["clock_skew_ms"].items())))
    if res["clamped"]:
        print(f"clamped events: {res['clamped']} (pair constraints "
              "infeasible — ordering invariant enforced per event)")
    if bad:
        print(f"ERROR: {bad} flow(s) still show recv before the "
              "corrected send", file=sys.stderr)
        return 1
    return 0


def _fetch_fleet(spec: str) -> dict:
    """A fleet snapshot from a FleetCollector: its base URL (the /fleet
    JSON endpoint; a .../metrics URL is rewritten), or a JSON file a
    snapshot was saved to."""
    import os

    if os.path.isfile(spec):
        with open(spec) as f:
            return json.load(f)
    import urllib.request

    url = spec
    if url.endswith("/metrics"):
        url = url[:-len("/metrics")] + "/fleet"
    elif not url.endswith("/fleet"):
        url = url.rstrip("/") + "/fleet"
    with urllib.request.urlopen(url, timeout=5) as r:
        return json.loads(r.read().decode())


def _render_fleet(fs: dict) -> str:
    """Per-process columns and a fleet-sums column from a FleetCollector
    snapshot ({"processes": ..., "sums": ...}); stale processes are
    starred in the header and called out on the status line."""
    procs = fs.get("processes") or {}
    sums = fs.get("sums") or {}
    names = sorted(procs)

    def fmt(v):
        return "-" if v is None else f"{v:g}"

    def cell(snap, kind, key):
        if not snap:
            return "-"
        v = (snap.get(kind) or {}).get(key)
        if v is not None and kind == "histograms":
            v = v.get("count", 0)
        return fmt(v)

    rows = []
    for kind, suffix in (("counters", ""), ("gauges", ""),
                         ("histograms", " (count)")):
        keys = set(sums.get(kind) or {})
        for p in procs.values():
            keys |= set(((p.get("snapshot") or {}).get(kind)) or {})
        for k in sorted(keys):
            sv = (sums.get(kind) or {}).get(k)
            if sv is not None and kind == "histograms":
                sv = sv.get("count", 0)
            rows.append(
                [k + suffix]
                + [cell((procs[n].get("snapshot")), kind, k)
                   for n in names] + [fmt(sv)])
    head = (["metric"]
            + [n + ("*" if procs[n].get("stale") else "") for n in names]
            + ["fleet"])
    widths = [max(len(str(r[i])) for r in [head] + rows)
              for i in range(len(head))]
    status = []
    for n in names:
        p = procs[n]
        s = f"{n}=" + ("STALE" if p.get("stale") else "ok")
        if p.get("age_s") is not None:
            s += f" ({p['age_s']:.1f}s ago)"
        if p.get("error"):
            s += f" [{p['error'][:60]}]"
        status.append(s)
    lines = ["fleet: " + ", ".join(status)
             + "   (* = stale: last scrape failed or too old)"]
    lines.append("  ".join(h.ljust(w) for h, w in zip(head, widths)))
    for r in rows:
        lines.append("  ".join(str(c).ljust(w) for c, w in zip(r, widths)))
    return "\n".join(lines)


def _top_frame(snap: dict, source: str, prev: dict = None,
               dt: float = None) -> str:
    """One screen of run health from a parsed /metrics snapshot (sanitized
    Prometheus names); `prev` and `dt` turn counters into rates. The JAX
    package's frame, line for line."""
    import time as _time

    from .utils.prometheus import histogram_percentile

    c, g, h = snap["counters"], snap["gauges"], snap["histograms"]

    def rate(key):
        if prev is None or not dt:
            return None
        return (c.get(key, 0) - prev["counters"].get(key, 0)) / dt

    def p50_of(key):
        hh = h.get(key)
        if hh and hh["count"]:
            return histogram_percentile(hh["buckets"], 0.5)
        return None

    lines = [f"fedml_tpu top — {source}  "
             f"({_time.strftime('%Y-%m-%d %H:%M:%S')})"]
    rnd = g.get("fed_round")
    row = [f"round {int(rnd)}" if rnd is not None else "round -",
           f"rounds_total {int(c.get('fed_rounds_total', 0))}"]
    rr = rate("fed_rounds_total")
    if rr is not None:
        row.append(f"rounds/s {rr:.2f}")
    if "fed_health_round_s" in g:
        row.append(f"last_round {g['fed_health_round_s'] * 1e3:.1f}ms")
    if "fed_version" in g:
        row.append(f"async_version {int(g['fed_version'])}")
    lines.append("  ".join(row))

    lines.append(
        "health: divergent_now {}  flags_total {}  straggler_rounds {}  "
        "norm_median {:.4g}  cosine_min {:.3f}".format(
            int(g.get("fed_health_divergent", 0)),
            int(c.get("fed_health_flags_total", 0)),
            int(c.get("fed_health_straggler_rounds_total", 0)),
            g.get("fed_health_update_norm_median", float("nan")),
            g.get("fed_health_cosine_min", float("nan"))))
    flags = {k[len("fed_health_flags_c"):-len("_total")]: int(v)
             for k, v in c.items()
             if k.startswith("fed_health_flags_c") and k.endswith("_total")}
    lines.append("flags: " + (" ".join(
        f"c{cid}x{n}" for cid, n in sorted(
            flags.items(), key=lambda kv: -kv[1])[:12]) or "none"))

    part = {k[len("fed_participation_c"):-len("_total")]: int(v)
            for k, v in c.items()
            if k.startswith("fed_participation_c") and k.endswith("_total")}
    if part:
        top = sorted(part.items(), key=lambda kv: (-kv[1], int(kv[0])))[:10]
        lines.append(
            f"participation: {len(part)} clients seen | top "
            + " ".join(f"c{cid}:{n}" for cid, n in top))
    else:
        lines.append("participation: (none yet)")

    st = h.get("fed_staleness")
    if st and st["count"]:
        p50 = histogram_percentile(st["buckets"], 0.5)
        p99 = histogram_percentile(st["buckets"], 0.99)
        lines.append(
            f"staleness: n={st['count']} mean={st['sum'] / st['count']:.2f} "
            f"p50<={p50:g} p99<={p99:g}")

    if c.get("fed_ingest_chunks_total"):
        n_ch = int(c["fed_ingest_chunks_total"])
        seg = (f"ingest: chunks {n_ch}  "
               f"{_fmt_bytes(c.get('fed_ingest_bytes_total', 0))}  "
               f"prefetched {int(c.get('fed_ingest_prefetched_total', 0))}"
               f"/{n_ch}")
        p50 = p50_of("fed_ingest_put_s")
        if p50 is not None:
            seg += f"  put_p50<={p50 * 1e3:.2f}ms"
        br = rate("fed_ingest_bytes_total")
        if br is not None:
            seg += f"  {_fmt_bytes(br)}/s"
        lines.append(seg)
    if "fed_cost_model_fit_error" in g:
        err = g["fed_cost_model_fit_error"]
        lines.append(
            "cost_model: "
            + ("ENGAGED" if g.get("fed_cost_model_engaged") else "warming")
            + (f"  fit_err {err:.2f}" if err >= 0 else "  fit_err inf")
            + f"  dispatches {int(c.get('fed_cost_model_dispatches_total', 0))}")

    if "fed_server_clients_online" in g or c.get("fed_server_resumes_total") \
            or c.get("fed_server_checkpoints_total"):
        seg = (f"silo: online {int(g.get('fed_server_clients_online', 0))}"
               f"/{int(g.get('fed_server_clients_total', 0))}"
               f"  gen {int(g.get('fed_server_generation', 0))}")
        for label, key in (("resumes", "fed_server_resumes_total"),
                           ("ckpts", "fed_server_checkpoints_total"),
                           ("evicted", "fed_server_evicted_total"),
                           ("rejoins", "fed_server_rejoins_total"),
                           ("stale_gen",
                            "fed_server_stale_gen_rejected_total"),
                           ("quorum_fail",
                            "fed_server_quorum_unreachable_total"),
                           ("reattach", "fed_client_reattaches_total")):
            v = int(c.get(key, 0))
            if v:
                seg += f"  {label} {v}"
        lines.append(seg)

    backends = sorted({k.split("_")[1] for k in c
                       if k.startswith("comm_") and "_bytes_" in k
                       and not k.startswith("comm_codec_")})
    for b in backends:
        tx = c.get(f"comm_{b}_bytes_sent_total", 0)
        rx = c.get(f"comm_{b}_bytes_recv_total", 0)
        seg = f"comm[{b}]: tx {_fmt_bytes(tx)}  rx {_fmt_bytes(rx)}"
        txr = rate(f"comm_{b}_bytes_sent_total")
        if txr is not None:
            seg += f"  tx/s {_fmt_bytes(txr)}"
        rxr = rate(f"comm_{b}_bytes_recv_total")
        if rxr is not None:
            seg += f"  rx/s {_fmt_bytes(rxr)}"
        raw = c.get(f"comm_codec_{b}_bytes_raw_total", 0)
        wire = c.get(f"comm_codec_{b}_bytes_wire_total", 0)
        if raw and wire:
            seg += (f"  codec {raw / wire:.1f}x "
                    f"({_fmt_bytes(wire)} wire)")
        lines.append(seg)

    if "serving_requests_total" in c or "serving_tokens_total" in c:
        seg = (f"serving: requests {int(c.get('serving_requests_total', 0))}"
               f"  errors {int(c.get('serving_errors_total', 0))}  "
               f"queue {int(g.get('serving_queue_depth', 0))}")
        p50 = p50_of("serving_request_s")
        if p50 is not None:
            seg += f"  p50<={p50 * 1e3:.2f}ms"
        lines.append(seg)
        if ("serving_replicas_ready" in g or "serving_model_version" in g
                or c.get("serving_shed_total")):
            seg = (f"fleet: ready {int(g.get('serving_replicas_ready', 0))}"
                   f"  suspect "
                   f"{int(g.get('serving_replicas_suspect', 0))}")
            ver = g.get("serving_fleet_version",
                        g.get("serving_model_version"))
            if ver is not None:
                seg += f"  version {int(ver)}"
            seg += f"  shed {int(c.get('serving_shed_total', 0))}"
            sr = rate("serving_shed_total")
            if sr is not None:
                seg += f"  shed/s {sr:.1f}"
            rec = int(c.get("serving_replica_recoveries_total", 0))
            if rec:
                seg += f"  recovered {rec}"
            fo = int(c.get("serving_stream_failovers_total", 0))
            if fo:
                seg += f"  stream_failovers {fo}"
            ah = int(c.get("serving_affinity_hits_total", 0))
            am = int(c.get("serving_affinity_misses_total", 0))
            af = int(c.get("serving_affinity_fallbacks_total", 0))
            if ah + am + af:
                seg += f"  affinity {ah / (ah + am + af) * 100:.0f}%"
            p50 = p50_of("serving_stream_ttft")
            if p50 is not None:
                seg += f"  stream_ttft_p50<={p50 * 1e3:.2f}ms"
            lines.append(seg)
        if "serving_tokens_total" in c:
            seg = (f"engine: tokens {int(c['serving_tokens_total'])}  "
                   f"slots {int(g.get('serving_slots_active', 0))}  "
                   f"queue {int(g.get('serving_engine_queue', 0))}")
            tr = rate("serving_tokens_total")
            if tr is not None:
                seg += f"  tok/s {tr:.1f}"
            pt = g.get("serving_kv_pages_budget")
            if pt:
                free = g.get("serving_kv_pages_free", 0)
                seg += (f"  pages {int(pt - free)}/{int(pt)} "
                        f"({(pt - free) / pt * 100:.0f}%)")
            hits = int(c.get("serving_prefix_hits_total", 0))
            miss = int(c.get("serving_prefix_misses_total", 0))
            if hits + miss:
                seg += f"  prefix {hits / (hits + miss) * 100:.0f}%"
            prop = int(c.get("serving_spec_proposed_total", 0))
            if prop:
                acc = int(c.get("serving_spec_accepted_total", 0))
                seg += f"  spec {acc / prop * 100:.0f}%"
            for label, key in (("ttft", "serving_ttft"),
                               ("tbt", "serving_tbt")):
                p50 = p50_of(key)
                if p50 is not None:
                    seg += f"  {label}_p50<={p50 * 1e3:.2f}ms"
            lines.append(seg)

    if c.get("soak_publishes_total") or c.get("loadgen_requests_total"):
        seg = (f"loop: round {int(g.get('soak_loop_round', 0))}"
               f"  fleet_v {int(g.get('serving_fleet_version', 0))}"
               f"  lag {int(g.get('soak_fleet_lag_rounds', 0))}"
               f"  pub {int(c.get('soak_publishes_total', 0))}")
        p50 = p50_of("soak_round_to_serve_s")
        if p50 is not None:
            seg += f"  pub2serve_p50<={p50 * 1e3:.0f}ms"
        revived = int(c.get("soak_replica_revives_total", 0))
        if revived:
            seg += f"  revived {revived}"
        seg += (f"  load ok {int(c.get('loadgen_ok_total', 0))}"
                f" shed {int(c.get('loadgen_shed_total', 0))}"
                f" err {int(c.get('loadgen_errors_total', 0))}")
        tt = h.get("loadgen_ttft_s")
        if tt and tt["count"]:
            p99 = histogram_percentile(tt["buckets"], 0.99)
            if p99 is not None:
                seg += f"  ttft_p99<={p99 * 1e3:.0f}ms"
        if "soak_slo_ok" in g:
            seg += "  slo " + ("OK" if g["soak_slo_ok"] else "VIOLATED")
        lines.append(seg)

    if "fed_budget_wall_s" in g:
        by_bk = {k[len("fed_budget_transport_"):-len("_s")]: v
                 for k, v in g.items()
                 if k.startswith("fed_budget_transport_")
                 and k.endswith("_s") and k != "fed_budget_transport_s"}
        seg = (f"budget: wall {g['fed_budget_wall_s']:.1f}s"
               f"  transport {g.get('fed_budget_transport_share', 0):.0%}")
        if by_bk:
            seg += " (" + ", ".join(
                f"{b} {v:.1f}s" for b, v in sorted(by_bk.items())) + ")"
        seg += (f"  compute {g.get('fed_budget_compute_s', 0):.1f}s"
                f"  ingest {g.get('fed_budget_ingest_s', 0):.1f}s"
                f"  agg {g.get('fed_budget_agg_s', 0):.1f}s"
                f"  idle {g.get('fed_budget_idle_s', 0):.1f}s")
        lines.append(seg)
    if "slo_alerts_firing" in g or c.get("slo_alerts_total"):
        burns = {k[len("slo_burn_"):]: v for k, v in g.items()
                 if k.startswith("slo_burn_") and not k.endswith("_slow")}
        seg = (f"alerts: firing {int(g.get('slo_alerts_firing', 0))}"
               f"  fired_total {int(c.get('slo_alerts_total', 0))}")
        if burns:
            worst = max(burns.items(), key=lambda kv: kv[1])
            seg += "  burn " + " ".join(
                f"{k}:{v:.1f}x" for k, v in sorted(burns.items()))
            seg += f"  worst {worst[0]}"
        lines.append(seg)

    # the cost ledger's measured utilization (utils/xla_ledger.py)
    mfu = {k[len("xla_program_mfu_"):]: v for k, v in g.items()
           if k.startswith("xla_program_mfu_")}
    if mfu:
        lines.append("mfu: " + " ".join(
            f"{k}:{v:.3f}" for k, v in sorted(mfu.items())))
    return "\n".join(lines)


def cmd_top(args) -> int:
    """Live one-screen run health (reference: the MLOps run dashboard):
    scrape a run's /metrics, or read a finished run's end-of-run snapshot
    from its events file."""
    import time as _time

    from .utils.prometheus import parse_prometheus, render_prometheus

    url = args.url
    if url is None and args.port is not None:
        url = f"http://127.0.0.1:{args.port}/metrics"
    if getattr(args, "fleet", False) and url is None:
        print("top --fleet needs --url/--port pointing at a "
              "FleetCollector's aggregated /metrics "
              "(common_args.extra.obs_fleet.port)", file=sys.stderr)
        return 2
    # the run-dir fallback is a finished run's static snapshot: one frame
    once = args.once or url is None

    def fetch() -> tuple[dict, str]:
        if url:
            import urllib.request

            with urllib.request.urlopen(url, timeout=5) as r:
                return parse_prometheus(r.read().decode()), url
        path = _newest_events_file(args.log_dir, args.run)
        report = None
        with open(path) as f:
            for line in f:
                try:
                    row = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if "report" in row:
                    report = row["report"]
        if report is None or "metrics" not in report:
            raise ValueError(
                f"{path} has no end-of-run metrics snapshot (run without "
                "mlops.finish?) — use --url against a live run")
        # through the exposition and its parser, so the names are the
        # scraped ones
        return parse_prometheus(
            render_prometheus(report["metrics"])), path

    prev, prev_t = None, None
    frame = 0
    misses = 0
    try:
        while True:
            try:
                snap, source = fetch()
                misses = 0
            except Exception as e:  # noqa: BLE001 — operator-facing CLI
                # fatal before the first frame and in one-shot mode; a live
                # watch skips a transient miss until five in a row
                misses += 1
                print(f"top: {type(e).__name__}: {e}", file=sys.stderr)
                if frame == 0 or once or misses >= 5:
                    return 1
                _time.sleep(args.interval)
                continue
            now = _time.monotonic()
            if getattr(args, "fleet", False):
                text = _fleet_frame(snap, source)
            else:
                text = _top_frame(
                    snap, source, prev,
                    (now - prev_t) if prev_t is not None else None)
            if not once and frame:
                print("\x1b[2J\x1b[H", end="")  # clear screen between frames
            print(text, flush=True)
            frame += 1
            if once or (args.frames and frame >= args.frames):
                return 0
            prev, prev_t = snap, now
            _time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0        # ^C is the documented way to stop a live watch


def _fleet_frame(snap: dict, source: str) -> str:
    """`top --fleet`: the scraped exposition is a collector's aggregate;
    split it back by process and render the per-process columns."""
    import time as _time

    from .utils.obsfleet import fleet_sums
    from .utils.prometheus import split_by_label

    split = split_by_label(snap, "process")
    per = {k: v for k, v in split.items() if k}
    # the collector's own (unlabeled) families carry the staleness gauge
    n_stale = ((split.get("") or {}).get("gauges")
               or {}).get("obs_fleet_stale")
    fs = {"processes": {
        n: {"ok": True, "stale": False, "age_s": None, "error": None,
            "snapshot": s} for n, s in per.items()},
        "sums": fleet_sums(per)}
    head = (f"fedml_tpu_torch top --fleet — {source}  "
            f"({_time.strftime('%Y-%m-%d %H:%M:%S')})")
    if n_stale:
        head += f"  STALE PROCESSES: {int(n_stale)}"
    return head + "\n" + _render_fleet(fs)


def cmd_lint(args) -> int:
    """graftlint, the port's static analysis (`analysis/`): exit 0 clean,
    1 findings, 2 usage error; `--format json` is the JAX package's
    schema."""
    from .analysis import all_rules, render_json, render_text, run_lint

    if args.list_rules:
        for r in all_rules():
            print(f"{r.name}: {r.summary}")
        return 0
    rules = None
    if args.rules:
        rules = [t.strip() for t in args.rules.split(",") if t.strip()]
    try:
        findings, stats = run_lint(paths=args.paths or None, rules=rules)
    except (ValueError, OSError) as e:
        print(f"lint: {e}", file=sys.stderr)
        return 2
    print(render_json(findings, stats) if args.format == "json"
          else render_text(findings, stats))
    return 1 if findings else 0


def cmd_diagnosis(args) -> int:
    """The port's battery (reference: slave/client_diagnosis.py, probes
    before joining a run; module `diagnosis.py` holds the probes). Exit 0
    iff every required probe that ran passed."""
    from . import diagnosis

    return diagnosis.run_battery(args.only, args.device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="fedml_tpu_torch",
        description="the PyTorch/CUDA port of fedml_tpu (reference CLI: "
                    "fedml)")
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("version", help="print the version")
    sub.add_parser("env", help="report the runtime environment")
    runp = sub.add_parser("run", help="run a fedml_config.yaml")
    runp.add_argument("--cf", "--config", dest="config", required=True,
                      help="path to a config (YAML, or JSON)")
    runp.add_argument("--rounds", type=int, default=None,
                      help="override comm_round")
    runp.add_argument("--device", default=None,
                      help="cuda (the default; raises without a GPU) or cpu")
    sub.add_parser("bench", help="not ported yet (exits 2)")
    lp = sub.add_parser("launch", help="submit a job spec to the scheduler")
    lp.add_argument("job", help="job spec yaml/json (scheduler spec)")
    lp.add_argument("--store", default=None,
                    help="sqlite path for a durable job queue")
    lp.add_argument("--timeout", type=float, default=600.0)
    lp.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    bp = sub.add_parser("build", help="package a job dir into a tarball")
    bp.add_argument("--source", required=True, help="job directory")
    bp.add_argument("--entry", default=None, help="entry file inside source")
    bp.add_argument("--dest", default="./dist", help="output directory")
    bp.add_argument("--name", default=None, help="package name")
    gp = sub.add_parser("logs", help="show per-run logs/events")
    gp.add_argument("--log-dir", default="./log")
    gp.add_argument("--run", default=None, help="run-name prefix filter")
    gp.add_argument("--tail", type=int, default=50)
    gp.add_argument("--list", action="store_true", help="list runs only")
    dp = sub.add_parser("diagnosis",
                        help="device, kernel, transport and serving checks")
    dp.add_argument("--only", nargs="+", default=None, metavar="PROBE",
                    help="run only the named probe(s)")
    dp.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu "
                         "(the plain versions; the kernels are not run)")
    lint_p = sub.add_parser(
        "lint", help="graftlint: the port's static analysis "
                     "(donation/retrace/knob/metric/lock/purity rules)")
    lint_p.add_argument("paths", nargs="*", default=None,
                        help="files/dirs to scan (default: the "
                             "fedml_tpu_torch package tree)")
    lint_p.add_argument("--format", choices=("text", "json"),
                        default="text",
                        help="json emits the stable CI schema")
    lint_p.add_argument("--rules", default=None,
                        help="comma-separated rule subset (see "
                             "--list-rules)")
    lint_p.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog and exit")
    rp = sub.add_parser("report",
                        help="summarize a tracked run's telemetry "
                             "(spans, counters, trace pointer)")
    rp.add_argument("--events", default=None,
                    help="path to a <run>.events.jsonl (overrides "
                         "--log-dir/--run)")
    rp.add_argument("--log-dir", default="./log")
    rp.add_argument("--run", default=None, help="run-name prefix filter")
    rp.add_argument("--format", choices=("text", "json"), default="text",
                    help="json emits one stable machine-readable object")
    rp.add_argument("--merge", nargs="+", default=None, metavar="RUN_DIR",
                    help="merge N run dirs' (or *.trace.json files') "
                         "Chrome traces into one clock-corrected Perfetto "
                         "timeline with cross-process send->handle flow "
                         "arrows; exits 1 if a recv still precedes its "
                         "corrected send")
    rp.add_argument("--out", default=None,
                    help="--merge output path (default merged.trace.json)")
    rp.add_argument("--fleet", default=None, metavar="URL",
                    help="FleetCollector URL (or saved /fleet JSON file): "
                         "fold the fleet snapshot (per-process columns, "
                         "fleet sums, staleness marks) into the report")
    tp = sub.add_parser("top",
                        help="live one-screen run health from a /metrics "
                             "endpoint (or a finished run's events file)")
    tp.add_argument("--url", default=None,
                    help="…/metrics endpoint URL of a live run "
                         "(common_args.extra.metrics_port)")
    tp.add_argument("--port", type=int, default=None,
                    help="shorthand for --url http://127.0.0.1:PORT/metrics")
    tp.add_argument("--log-dir", default="./log",
                    help="fallback: newest run's end-of-run snapshot here")
    tp.add_argument("--run", default=None, help="run-name prefix filter")
    tp.add_argument("--interval", type=float, default=2.0,
                    help="seconds between frames")
    tp.add_argument("--once", action="store_true",
                    help="render one frame and exit")
    tp.add_argument("--frames", type=int, default=0,
                    help="stop after N frames (0 = run until ^C)")
    tp.add_argument("--fleet", action="store_true",
                    help="treat --url/--port as a FleetCollector's "
                         "aggregated /metrics and render per-process "
                         "columns instead of the single-process frame")
    args = p.parse_args(argv)
    return {"version": cmd_version, "env": cmd_env, "run": cmd_run,
            "bench": lambda a: _later("bench"),
            "launch": cmd_launch, "build": cmd_build,
            "logs": cmd_logs, "diagnosis": cmd_diagnosis,
            "lint": cmd_lint,
            "report": cmd_report, "top": cmd_top}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
