"""Federated semantic segmentation (FedSeg): UNet-lite + per-pixel CE with
an ignore label + whole-set mIoU eval (port of
examples/federated_segmentation.py; reference:
python/fedml/simulation/mpi/fedseg/FedSegAPI.py — the runtime is the
task-agnostic round engine; the task is the objective + model).

Run:  python -m fedml_tpu_torch.examples.federated_segmentation
          [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from fedml_tpu_torch._device import resolve_device
from fedml_tpu_torch.algorithms.builtin import make_fedavg
from fedml_tpu_torch.config import TrainArgs
from fedml_tpu_torch.core.algorithm import SEG_IGNORE_ID, seg_eval_fn
from fedml_tpu_torch.examples import parser
from fedml_tpu_torch.models import hub
from fedml_tpu_torch.parallel.round import build_round_fn


def square_masks(rs, n_clients, s, hw=16):
    """Synthetic dense-prediction task: segment one bright square."""
    x = 0.1 * rs.randn(n_clients, s, hw, hw, 1).astype(np.float32)
    y = np.zeros((n_clients, s, hw, hw), np.int64)
    for c in range(n_clients):
        for i in range(s):
            h0, w0 = rs.randint(1, hw // 2, 2)
            sz = rs.randint(3, hw // 2)
            x[c, i, h0:h0 + sz, w0:w0 + sz, 0] += 1.0
            y[c, i, h0:h0 + sz, w0:w0 + sz] = 1
    # a sprinkle of ignore pixels (unlabeled regions, reference
    # ignore_index=255 semantics)
    y = np.where(rs.rand(*y.shape) < 0.02, SEG_IGNORE_ID, y)
    return x, y


def main(argv=None, draws=None) -> dict:
    """The last round's train_loss, every round's metrics under
    "history", and the eval's miou and acc. `draws` (optional):
    {"params": the initial state dict, "batches": each round's
    [clients, steps, B] batch order, by round}."""
    args = parser(__doc__).parse_args(argv)
    dev = resolve_device(args.device)
    rs = np.random.RandomState(0)
    n_clients, shard = 3, 16
    x, y = square_masks(rs, n_clients, shard)
    data = {"x": torch.from_numpy(x).to(dev), "y": torch.from_numpy(y).to(dev),
            "mask": torch.ones((n_clients, shard), device=dev)}

    model = hub.create("unet", 2, (16, 16, 1), device=dev)
    apply = hub.apply_fn(model)
    t = TrainArgs(epochs=1, batch_size=8, learning_rate=0.2,
                  extra={"task": "segmentation"})
    alg = make_fedavg(apply, t)
    params = (hub.init_params(model, torch.Generator(dev).manual_seed(0))
              if draws is None else {k: torch.as_tensor(v).to(dev)
                                     for k, v in draws["params"].items()})
    rnd = build_round_fn(alg, mesh=None)
    st = alg.server_init(params, None)
    history = []
    for r in range(6):
        out = rnd(st, None, data, np.arange(n_clients),
                  np.full((n_clients,), float(shard), np.float32), (1, r),
                  batch_idx=None if draws is None
                  else torch.as_tensor(draws["batches"][r]).to(dev))
        st = out.server_state
        history.append({k: float(v) for k, v in out.metrics.items()
                        if k in ("train_loss", "train_acc")})
        print(f"round {r}: loss={float(out.metrics['train_loss']):.3f} "
              f"pixel_acc={float(out.metrics['train_acc']):.3f}")

    # server-side eval: whole-set mIoU via the accumulated confusion matrix
    xe, ye = square_masks(np.random.RandomState(7), 1, 8)
    ev = seg_eval_fn(apply, num_classes=2)
    m = ev(st.params, torch.from_numpy(xe[0]).to(dev).reshape(2, 4, 16, 16, 1),
           torch.from_numpy(ye[0]).to(dev).reshape(2, 4, 16, 16),
           torch.ones((2, 4), device=dev))
    print(f"eval: miou={float(m['miou']):.3f} acc={float(m['acc']):.3f} "
          f"per_class_iou="
          f"{np.round(m['per_class_iou'].cpu().numpy(), 3).tolist()}")
    assert float(m["miou"]) > 0.6, float(m["miou"])
    print("OK federated segmentation")
    return {"train_loss": history[-1]["train_loss"], "history": history,
            "miou": float(m["miou"]), "acc": float(m["acc"])}


if __name__ == "__main__":
    main()
