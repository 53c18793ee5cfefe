"""Hierarchical cross-silo: intra-silo data parallelism (the reference's
torch-DDP-inside-the-silo, python/fedml/__init__.py:342-390) composed with
cross-silo FedAvg (port of examples/hierarchical_cross_silo.py). Both
levels are axes of ONE (silos, intra) mesh over `torch.distributed` ranks
(parallel/hier.py): each local step's gradient is all-reduced over
`intra`, the round's aggregate over `silos`.

Run:  python -m fedml_tpu_torch.examples.hierarchical_cross_silo
          [--device cpu]
      (8 gloo ranks in a (silos=4, intra=2) layout, the JAX example's on
       8 virtual CPU devices; on one GPU the ranks share it)
"""
from __future__ import annotations

import numpy as np
import torch

from fedml_tpu_torch._device import resolve_device
from fedml_tpu_torch.examples import parser, summed
from fedml_tpu_torch.parallel.launch import RankPool

SILOS, INTRA = 4, 2


def silo_rank(draws=None) -> list:
    """One rank of the hierarchical federation: five rounds of the same
    round program in every rank; the lines to print, the last metrics,
    every round's metrics and the rank's kernel launches."""
    from fedml_tpu_torch.algorithms.builtin import make_fedavg
    from fedml_tpu_torch.config import TrainArgs
    from fedml_tpu_torch.core.algorithm import make_client_optimizer
    from fedml_tpu_torch.examples import kernel_launches
    from fedml_tpu_torch.models import hub
    from fedml_tpu_torch.parallel.hier import make_hier_round, shard_hier_data
    from fedml_tpu_torch.parallel.launch import current
    from fedml_tpu_torch.parallel.mesh import make_mesh

    kernel_launches(reset=True)
    dev = current().device
    mesh = make_mesh({"silos": SILOS, "intra": INTRA})
    n_silos = SILOS
    shard, batch = 64, 16
    model = hub.create("mlp", 3, (8,), device=dev)
    t = TrainArgs(epochs=1, batch_size=batch, learning_rate=0.3)
    apply = hub.apply_fn(model)
    alg = make_fedavg(apply, t)
    params = {k: torch.as_tensor(v).to(dev) for k, v in (hub.init_params(
        hub.create("mlp", 3, (8,), device="cpu"),
        torch.Generator().manual_seed(0)) if draws is None
        else draws["params"]).items()}
    opt = make_client_optimizer("sgd", t.learning_rate)
    rnd = make_hier_round(apply, alg, mesh, opt, batch, t.epochs)

    rs = np.random.RandomState(0)
    w_true = rs.randn(8, 3)
    x = rs.randn(n_silos, shard, 8).astype(np.float32)
    y = np.argmax(x @ w_true, axis=-1)
    data = shard_hier_data(
        {"x": x, "y": y, "mask": np.ones((n_silos, shard), np.float32)},
        mesh, device=dev)

    st = alg.server_init(params, None)
    ids = np.arange(n_silos)
    w = np.full((n_silos,), float(shard), np.float32)
    lines, history = [], []
    for r in range(5):
        st, metrics = rnd(st, data, ids, w, (1, r), batch_idx=None
                          if draws is None else draws["batches"][r])
        lines.append(f"round {r}: loss={float(metrics['train_loss']):.4f} "
                     f"acc={float(metrics['train_acc']):.3f}")
        history.append({k: float(v) for k, v in metrics.items()})
    return [lines, history[-1], history, kernel_launches()]


def main(argv=None, draws=None) -> dict:
    """The last round's metrics, with every round's under "history" and
    the ranks' summed K1-K4 launches under "rank_launches". `draws`
    (optional): {"params": the initial state dict, "batches": each
    round's [silos, steps, batch // intra] batch order (the same in every
    intra rank), by round}."""
    args = parser(__doc__).parse_args(argv)
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"mesh: silos={SILOS} x intra={INTRA} on {name}")
    with RankPool([args.device] * (SILOS * INTRA)) as pool:
        outs = pool.run(silo_rank, draws)
    lines, metrics, history, _ = outs[0]
    print("\n".join(lines))
    assert all(o[1] == metrics for o in outs), "the ranks disagree"
    assert metrics["train_acc"] > 0.8, "did not learn"
    print("hierarchical federation converged")
    return {**metrics, "history": history,
            "rank_launches": summed([o[3] for o in outs])}


if __name__ == "__main__":
    main()
