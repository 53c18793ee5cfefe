#!/usr/bin/env python3
"""How many aten operations one local step of ResNet-18-GN dispatches, by
the way its gradient is taken (CPU, no JAX; counts, not times).

    python3 scripts/local_step_ops.py [--steps 2] [--batch 32]

Three forms of the same bf16 local SGD step at the flagship width
(32 x 32 x 3 inputs, batch 32): `core.algorithm.local_sgd` with
`torch.func.grad` (the vision path, G = 1 and inside vmap) and with
`torch.autograd.grad` (the LoRA path), and the eager form the FedAvg
path ran before the step became functional (`loss.backward()` and a
`torch.optim.SGD` step). Each operation the profiler records under
`aten::` is one dispatch; on the card most of them launch a kernel, so
the ratio of the counts is the ratio of host dispatch work a step. One
JSON line: per-step counts and each form's most frequent operations.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from fedml_tpu_torch.core.algorithm import (  # noqa: E402
    autograd_grad, func_grad, local_sgd, make_client_optimizer,
    masked_softmax_ce,
)
from fedml_tpu_torch.models import hub  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--batch", type=int, default=32)
    args = ap.parse_args()
    torch.set_num_threads(4)
    model = hub.create("resnet18_gn", 10, (32, 32, 3), device="meta")
    params = hub.init_params(model, torch.Generator().manual_seed(0))
    apply = hub.apply_fn(model, "bfloat16")
    rs = np.random.RandomState(0)
    n = args.steps * args.batch
    shard = {"x": torch.from_numpy(rs.randn(n, 32, 32, 3).astype(np.float32)),
             "y": torch.from_numpy(rs.randint(0, 10, n)),
             "mask": torch.ones(n)}
    idx = torch.randperm(n).reshape(args.steps, args.batch)
    opt = make_client_optimizer("sgd", 0.05)

    def eager():
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        sgd = torch.optim.SGD(list(p.values()), lr=0.05)
        for i in range(args.steps):
            b = {k: v[idx[i]] for k, v in shard.items()}
            loss = masked_softmax_ce(apply(p, b["x"]), b["y"], b["mask"])[0]
            sgd.zero_grad(set_to_none=True)
            loss.backward()
            sgd.step()

    forms = {
        "func_grad": lambda: local_sgd(apply, params, shard, idx, opt,
                                       grad_engine=func_grad),
        "autograd_grad": lambda: local_sgd(apply, params, shard, idx, opt,
                                           grad_engine=autograd_grad),
        "eager_backward_optim": eager,
    }
    out = {}
    for name, run in forms.items():
        run()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            run()
        ops = [e for e in prof.key_averages() if e.key.startswith("aten::")]
        total = sum(e.count for e in ops)
        out[name] = {"aten_ops_per_step": total / args.steps,
                     "top": sorted(((e.count // args.steps, e.key)
                                    for e in ops), reverse=True)[:8]}
    print(json.dumps({"steps": args.steps, "batch": args.batch, **out}))


if __name__ == "__main__":
    main()
