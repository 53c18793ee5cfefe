#!/usr/bin/env python3
"""Where the time of `chip_smoke.py` phase mesh (b)'s rank rounds goes,
on one CUDA card.

    python3 scripts/mesh_share_card.py

Runs phase mesh (b)'s f32 Simulator round (its config: the flagship
ResNet-18-GN, 9 of 10 hetero synthetic CIFAR-10 clients, TF32 off) four
ways, one JSON line each: `here`, in this process without a mesh, its
first round and its second; then, every rank warmed as it joins
(`_rank_setup`), `one_rank`, in one spawned process alone on the card (a
world of one, so no mesh); `two_ranks`, the phase's two gloo ranks
sharing the card over a `clients` mesh. Each line has the round's seconds
(host clock after a synchronise) in every rank.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    import fedml_tpu_torch
    from fedml_tpu_torch.models import hub
    from fedml_tpu_torch.parallel.launch import RankPool
    from fedml_tpu_torch.simulation.simulator import Simulator

    if not torch.cuda.is_available():
        print("mesh_share_card: needs a CUDA card", file=sys.stderr)
        return 2
    model = hub.create("resnet18_gn", 10, (32, 32, 3), device="meta")
    params = {k: v.numpy() for k, v in hub.init_params(
        model, torch.Generator().manual_seed(0)).items()}
    with cs._tf32_off():
        sim = Simulator(fedml_tpu_torch.init(config=cs._mesh_dict(),
                                             device="cuda"),
                        params={k: torch.from_numpy(v)
                                for k, v in params.items()})
        seconds = []
        for _ in range(2):   # a cold round, then a warm one
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sim.run_round(0)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        print(json.dumps({"case": "here", "seconds": seconds}), flush=True)
    mesh_cfg = cs._mesh_dict(comm_args={"backend": "xla"},
                             device_args={"mesh_shape": {"clients": 2}})
    for case, n, cfg in (("one_rank", 1, cs._mesh_dict()),
                         ("two_ranks", 2, mesh_cfg)):
        with RankPool(["cuda"] * n, timeout_s=300,
                      setup=cs._rank_setup) as pool:
            outs = pool.run(cs._mesh_rank_b, cfg, params)
        print(json.dumps({"case": case, "backend": pool.backend,
                          "seconds": [o["seconds"] for o in outs],
                          "exitcodes": pool.exitcodes}), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
