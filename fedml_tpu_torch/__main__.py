"""CLI: `python -m fedml_tpu_torch <cmd>` (port of `fedml_tpu/__main__.py`).

(reference: python/fedml/cli/cli.py:18-76, the click commands `fedml
version / env / run / build / logs / diagnosis / ...`.)

  version    the package version
  env        torch, CUDA, the visible cards, nvcc and triton
  run        a simulation or centralized config (`--cf`, `--rounds`,
             `--device`: CUDA unless `--device cpu`; it raises without a
             GPU, as every entry point does)
  build      a job directory as a tarball with a sha256 manifest
  logs       the per-run logs and events the mlops facade wrote
  report     a tracked run's telemetry (text, or `--format json`)
  top        one screen of run health from /metrics or a finished run
  diagnosis  the port's battery: the card, the kernels K1-K4 against
             their plain versions, the transports, the codec and the
             serving engine (`--only`, `--device`)

`bench`, `launch`, `lint`, `report --merge / --fleet` and `top --fleet`
are not ported yet: each exits 2 naming the ROADMAP entry that brings it.
Output formats, schemas and exit codes are the JAX package's.
"""
from __future__ import annotations

import argparse
import json
import sys

_LATER = {
    "bench": "a benchmark of the port (there is none yet; bench.py at the "
             "repository root is the JAX package's)",
    "launch": "ROADMAP 'Port queue' entry 5 (the scheduler)",
    "lint": "ROADMAP 'Port queue' entry 8 (analysis/)",
    "report --merge": "ROADMAP 'Port queue' entry 8 (utils/obsfleet.py)",
    "report --fleet": "ROADMAP 'Port queue' entry 8 (utils/obsfleet.py)",
    "top --fleet": "ROADMAP 'Port queue' entry 8 (utils/obsfleet.py)",
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
    JAX package's); the exit codes are the same in both formats."""
    import os

    if getattr(args, "merge", None):
        return _later("report --merge")
    if getattr(args, "fleet", None):
        return _later("report --fleet")
    fleet = None

    path = args.events
    if path is None:
        try:
            path = _newest_events_file(args.log_dir, args.run)
        except FileNotFoundError as e:
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

    retr = {k: int(v) for k, v in c.items() if k.startswith("xla_retraces_")}
    if retr:
        lines.append("xla retraces: " + " ".join(
            f"{k[len('xla_retraces_'):-len('_total')]}:{v}"
            for k, v in sorted(retr.items())))
    return "\n".join(lines)


def cmd_top(args) -> int:
    """Live one-screen run health (reference: the MLOps run dashboard):
    scrape a run's /metrics, or read a finished run's end-of-run snapshot
    from its events file."""
    import time as _time

    from .utils.prometheus import parse_prometheus, render_prometheus

    if getattr(args, "fleet", False):
        return _later("top --fleet")
    url = args.url
    if url is None and args.port is not None:
        url = f"http://127.0.0.1:{args.port}/metrics"
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
            text = _top_frame(snap, source, prev,
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
    lp = sub.add_parser("launch", help="not ported yet (exits 2)")
    lp.add_argument("job", nargs="?")
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
    lint_p = sub.add_parser("lint", help="not ported yet (exits 2)")
    lint_p.add_argument("paths", nargs="*", default=None)
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
                    help="not ported yet (exits 2)")
    rp.add_argument("--out", default=None, help="--merge output path")
    rp.add_argument("--fleet", default=None, metavar="URL",
                    help="not ported yet (exits 2)")
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
                    help="not ported yet (exits 2)")
    args = p.parse_args(argv)
    return {"version": cmd_version, "env": cmd_env, "run": cmd_run,
            "bench": lambda a: _later("bench"),
            "launch": lambda a: _later("launch"), "build": cmd_build,
            "logs": cmd_logs, "diagnosis": cmd_diagnosis,
            "lint": lambda a: _later("lint"),
            "report": cmd_report, "top": cmd_top}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
