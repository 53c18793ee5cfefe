"""Serving speed of two or more trees of this repo on one card, run in turn.

Runs `python3 chip_smoke.py --only serve fleet` (or `--phases`) from
each tree in the order given (name a tree twice to interleave, e.g.
parent, change, change, parent) and prints, per run and per tree, the
readings a user of the decode engine feels:

- phase `serve` (one engine, 10 requests at once, LLaMA-2-7B in bf16):
  TTFT p50 and decode tokens/s of the bf16-pool and the int8-pool waves;
- phase `fleet` (a) (the gateway and two replicas under the open-loop
  wave): TTFT p50 / p99, output tokens/s and the stream's decode
  tokens/s.

Each run's whole output goes to `<out>/<i>_<label>.log`, the readings to
`<out>/summary.json`. Exits non-zero if any run failed.

    python3 scripts/serving_ab.py parent=_parent_tree change=. \\
        change=. parent=_parent_tree --out chiprun_out/serving_ab
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def _readings(lines: list[str]) -> dict:
    out: dict = {}
    for line in lines:
        if not line.startswith("{"):
            continue
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if obj.get("phase") == "serve" and "bf16_pool" in obj:
            for pool in ("bf16_pool", "int8_pool"):
                st = obj[pool]
                out[f"serve_{pool}_ttft_p50_s"] = st["ttft_p50_s"]
                out[f"serve_{pool}_decode_tokens_per_s"] = \
                    st["decode_tokens_per_s"]
        elif obj.get("phase") == "fleet" and obj.get("part") == "a_wave":
            for k in ("ttft_p50_s", "ttft_p99_s", "output_tokens_per_s",
                      "stream_decode_tokens_per_s"):
                out[f"fleet_{k}"] = obj[k]
        elif obj.get("phase") in ("serve", "fleet") and "wall_s" in obj:
            out[f"{obj['phase']}_wall_s"] = obj["wall_s"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", metavar="LABEL=DIR")
    ap.add_argument("--out", default="chiprun_out/serving_ab")
    ap.add_argument("--phases", nargs="+", default=["serve", "fleet"],
                    choices=["serve", "fleet"])
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds for one run")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    runs, failed = [], 0
    for i, spec in enumerate(args.trees):
        label, tree = spec.split("=", 1)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "chip_smoke.py", "--only", *args.phases],
            cwd=tree, capture_output=True, text=True, timeout=args.timeout)
        wall = time.perf_counter() - t0
        with open(os.path.join(args.out, f"{i}_{label}.log"), "w") as f:
            f.write(proc.stdout)
            f.write("\n--- stderr ---\n")
            f.write(proc.stderr)
        row = {"run": i, "label": label, "rc": proc.returncode,
               "command_s": wall, **_readings(proc.stdout.splitlines())}
        failed += proc.returncode != 0
        runs.append(row)
        print(json.dumps(row), flush=True)
    by_label: dict = {}
    for row in runs:
        by_label.setdefault(row["label"], []).append(row)
    summary = {"nvidia_smi": smi.strip(), "runs": runs, "median": {
        label: {k: statistics.median(r[k] for r in rows)
                for k in rows[0] if k not in ("run", "label", "rc")
                and all(isinstance(r.get(k), (int, float)) for r in rows)}
        for label, rows in by_label.items()}}
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary["median"]), flush=True)
    print(smi.strip(), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
