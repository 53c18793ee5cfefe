#!/usr/bin/env python3
"""How far f32 arithmetic carries the FedAvg flagship's parity round, on
the CPU.

    python3 scripts/fedavg_round_conditioning.py [--steps N] [--clients M]
                                                 [--lr LR]

Runs the round `chip_smoke.py`'s phase `fedavg` holds the card to (the
first clients of the flagship's synthetic CIFAR-10, ResNet-18-GN, FedAvg,
one init_params draw, one batch schedule cut to `--steps` local steps a
client) three times on the CPU: in f64, and in f32 at 8 and at 3 torch
threads (another blocking of the same sums). Prints one JSON line: each
run's train loss and seconds, the f32 runs' largest parameter difference
from the f64 run and from each other over the largest update, and the
parameters whose f32 error exceeds 1e-4 of that update (their own largest
update beside it). Needs no GPU and no JAX.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

_REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(_REPO))

from fedml_tpu_torch.algorithms.builtin import build_algorithm  # noqa: E402
from fedml_tpu_torch.config import TrainArgs  # noqa: E402
from fedml_tpu_torch.core.algorithm import make_batch_indices  # noqa: E402
from fedml_tpu_torch.data import loader  # noqa: E402
from fedml_tpu_torch.models import hub  # noqa: E402
from fedml_tpu_torch.parallel.round import (  # noqa: E402
    build_round_fn, client_generator,
)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  _REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=7,
                    help="local steps a client (the flagship runs 7)")
    ap.add_argument("--clients", type=int, default=1)
    ap.add_argument("--lr", type=float, default=0.05)
    args = ap.parse_args()
    cs = _chip_smoke()
    ds = loader.load(cs._fedavg_cfg("cpu"))
    n, bs = args.clients, cs.FEDAVG_CONFIG["train_args"]["batch_size"]
    t = TrainArgs(epochs=1, batch_size=bs, learning_rate=args.lr)
    model = hub.create("resnet18_gn", ds.num_classes, ds.x_train.shape[2:],
                       device="meta")
    params0 = hub.init_params(model, torch.Generator().manual_seed(0))
    sched = torch.stack([make_batch_indices(
        client_generator(0, c), ds.shard_size, bs, 1)[:args.steps]
        for c in range(n)])
    ids, weights = np.arange(n), ds.counts[:n].astype(np.float32)
    runs = {}
    for name, dt, threads in (("f64", torch.float64, 8),
                              ("f32_8_threads", torch.float32, 8),
                              ("f32_3_threads", torch.float32, 3)):
        torch.set_num_threads(threads)
        t0 = time.perf_counter()
        alg = build_algorithm("FedAvg", hub.apply_fn(model), t)
        data = {"x": torch.from_numpy(ds.x_train[:n]).to(dt),
                "y": torch.from_numpy(ds.y_train[:n]),
                "mask": torch.from_numpy(ds.mask_train[:n]).to(dt)}
        out = build_round_fn(alg)(
            alg.server_init({k: v.to(dt) for k, v in params0.items()}),
            None, data, ids, weights, seed=0, batch_idx=sched)
        runs[name] = ({k: v.double() for k, v in
                       out.server_state.params.items()},
                      out.metrics["train_loss"].item(),
                      time.perf_counter() - t0)
    p0 = {k: v.double() for k, v in params0.items()}
    update = max((runs["f64"][0][k] - p0[k]).abs().max().item() for k in p0)

    def ratio(a, b):
        return max((runs[a][0][k] - runs[b][0][k]).abs().max().item()
                   for k in p0) / update

    worst = {}
    for k in p0:
        err = (runs["f32_8_threads"][0][k] - runs["f64"][0][k]).abs().max()
        if err.item() > 1e-4 * update:
            worst[k] = {"err_over_update": err.item() / update,
                        "own_update": (runs["f64"][0][k] - p0[k]).abs()
                        .max().item()}
    print(json.dumps({
        "clients": n, "steps": args.steps, "lr": args.lr,
        "max_abs_update": update,
        "loss": {k: v[1] for k, v in runs.items()},
        "seconds": {k: v[2] for k, v in runs.items()},
        "f32_8_vs_f64": ratio("f32_8_threads", "f64"),
        "f32_3_vs_f64": ratio("f32_3_threads", "f64"),
        "f32_8_vs_f32_3": ratio("f32_8_threads", "f32_3_threads"),
        "f32_err_over_1e-4": worst}))


if __name__ == "__main__":
    main()
