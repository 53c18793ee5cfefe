#!/usr/bin/env python3
"""How far `chip_smoke.py` phase tp (b)'s adapters move, and how far tp 2's
change of them is from tp 1's, at a narrow width on the CPU.

    python3 scripts/tp_update_probe.py D_MODEL D_FF T LR [LR ...]

Runs phase tp (b)'s rank function (`_tp_rank_b`: `build_scaled_fedllm`
over (dp 1, tp 2) with an injected int8 base, then tp 1 in rank 0; the
dense attention, since there is no card) in two gloo ranks on the CPU, at
LLaMA-2-7B's vocabulary and 2 layers with 8 heads of D_MODEL / 8, 3 SGD
steps of 2 x T tokens, in bf16 and in f32, once for each LR. One JSON
line each LR and dtype:
the losses at tp 2 and tp 1, every step's loss distance
(`loss_rel_diff`), the worst adapter leaf's change distance over the
largest change (`update_rel_err`), and the largest change over its
leaf's largest start entry (`adapter_moved`), as phase tp reads them
(`_tp_b_readings`).
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    from fedml_tpu_torch.llm.transformer import LLAMA2_7B
    from fedml_tpu_torch.parallel.launch import RankPool

    d, ff, t = (int(x) for x in sys.argv[1:4])
    dims = dataclasses.asdict(dataclasses.replace(
        LLAMA2_7B, n_layers=2, d_model=d, n_heads=8, d_ff=ff))
    with RankPool(["cpu", "cpu"], timeout_s=600.0) as pool:
        for lr in (float(x) for x in sys.argv[4:]):
            rb = pool.run(cs._tp_rank_b, {"dims": dims, "bs": 2, "t": t,
                                          "steps": 3, "lr": lr,
                                          "dtypes": ("bfloat16", "float32")})
            for dt, sfx in (("bfloat16", ""), ("float32", "_float32")):
                r = cs._tp_b_readings(rb[0]["tp2" + sfx],
                                      rb[0]["tp1" + sfx], rb[1]["tp2" + sfx])
                print(json.dumps({"d_model": d, "t": t, "lr": lr,
                                  "dtype": dt, **{
                    k: r[k] for k in ("losses_tp2", "losses_tp1",
                                      "loss_rel_diff", "update_rel_err",
                                      "adapter_moved")}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
