#!/usr/bin/env python3
"""Time the flash backward passes (K2 dQ, K3 dK/dV) at heads of D 40 on one
NVIDIA GPU, through whatever kernels a checkout's shape rule sends them to.

    python3 scripts/flash_bwd_d40.py [--tree DIR] [--label NAME]

`--tree` is the root of the checkout whose `fedml_tpu_torch` is imported
(default: this repository). Two versions of the kernels are compared in one
run on one card by unpacking another commit into `_parent_tree/`, which
`.gitignore` lists (`git archive <commit> | tar -x -C _parent_tree`), and
timing both in turns: A, B, B, A. Each pass is
timed with this repository's `chip_smoke.time_ms` (CUDA-event median of
60, L2 flushed) at BH 4, T 256 and BH 64, T 2048, in f32 and bf16, after a
check against the checkout's plain version under the rule `chip_smoke.py`
holds it to. Prints one JSON line: the label, the card's `nvidia-smi` name
and power limit, and per dtype and shape the route, the launch key, the
time and the row error of each pass.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parent.parent
SHAPES = ((4, 256), (64, 2048))   # (BH, T)
D = 40
DEV = "cuda"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  _REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(_REPO))
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("flash_bwd_d40: needs one CUDA GPU", file=sys.stderr)
        return 2
    cs = _chip_smoke()
    from fedml_tpu_torch.ops import flash_attention as fa

    root = Path(fa.__file__).resolve().parents[2]
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(5)
    out = {"label": args.label, "tree": str(root),
           "nvidia_smi": cs.nvidia_smi_line(), "D": D}
    for kind, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for bh, t in SHAPES:
            q, k, v, do = (torch.from_numpy(
                rng.standard_normal((bh, t, D), np.float32)).to(DEV, dt)
                for _ in range(4))
            o, lse = fa.flash_fwd(q, k, v)
            delta = fa.flash_delta(o, do)
            bq, bk = min(t, 512), min(t, 1024)
            row = {"shape": [bh, t, D]}
            for name, run, ref in (
                    ("dq", lambda: (fa.flash_dq(q, k, v, do, lse, delta),),
                     lambda: (fa.flash_dq_ref(q, k, v, do, lse, delta, bq,
                                              bk),)),
                    ("dkv", lambda: fa.flash_dkv(q, k, v, do, lse, delta),
                     lambda: fa.flash_dkv_ref(q, k, v, do, lse, delta, bq,
                                              bk))):
                before = dict(fa.launch_count)
                got = run()
                torch.cuda.synchronize()
                keys = [n for n in fa.launch_count
                        if fa.launch_count[n] != before[n]]
                err = max(fa.rowwise_rel_err(g, w)
                          for g, w in zip(got, ref()))
                cs.check(err <= cs.FLASH_TOL[kind], f"{args.label} {kind} "
                         f"{name} at {row['shape']}: row error {err}")
                row[name] = {"launched": keys, "max_row_rel_err": err,
                             "ms": cs.time_ms(run)}
            out[f"{kind} BH {bh} T {t}"] = row
            del q, k, v, do, o, lse, delta
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
