"""Reference-parity harness (port of `fedml_tpu/parity.py`): a torch
re-creation of the reference's sequential FedAvg loop, run on the same
partitions as the port's Simulator.

The reference trains clients one by one in Python and averages state
dicts key by key (reference: simulation/sp/fedavg/fedavg_api.py:66-159,
:127-135 round-seeded sampling). This module runs that loop on the CPU
over a `FedDataset` the port already partitioned, so a final-accuracy
gap between the two is measured on identical data, partitions and client
sampling.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .data.fed_dataset import FedDataset

# The one set of hyperparameters both sides of a parity comparison run
# with: a drift between the two sides' configs would turn the parity gap
# into flattery.
PARITY_HP = {
    "comm_round": 30,
    "epochs": 2,
    "batch_size": 32,
    "learning_rate": 0.1,
}


def _build_torch_model(model_name: str, input_dim: int, num_classes: int):
    import torch.nn as nn

    if model_name == "lr":
        # reference: model/linear/lr.py
        return nn.Sequential(nn.Flatten(), nn.Linear(input_dim, num_classes))
    if model_name == "mlp":
        # the hub's MLP(hidden=(256, 128)) (models/hub.py)
        return nn.Sequential(
            nn.Flatten(),
            nn.Linear(input_dim, 256), nn.ReLU(),
            nn.Linear(256, 128), nn.ReLU(),
            nn.Linear(128, num_classes),
        )
    raise ValueError(f"parity harness supports lr/mlp, not {model_name!r}")


def torch_fedavg(
    dataset: FedDataset,
    model_name: str = "mlp",
    comm_round: int = 30,
    epochs: int = 2,
    batch_size: int = 32,
    learning_rate: float = 0.1,
    clients_per_round: Optional[int] = None,
    seed: int = 0,
) -> float:
    """Run the reference-style sequential FedAvg loop; returns final test acc.

    Client sampling matches Simulator.sample_clients exactly (np seeded by
    round index — reference fedavg_api.py:127-135); aggregation is the
    reference's per-key sample-count-weighted state-dict average
    (fedavg_api.py:144-159).
    """
    import copy

    import torch
    import torch.nn.functional as F

    torch.manual_seed(seed)
    n_clients = dataset.num_clients
    m = clients_per_round or n_clients
    input_dim = int(np.prod(dataset.x_train.shape[2:]))
    model = _build_torch_model(model_name, input_dim, dataset.num_classes)
    w_global = copy.deepcopy(model.state_dict())

    xs = torch.tensor(np.asarray(dataset.x_train, np.float32))
    ys = torch.tensor(np.asarray(dataset.y_train, np.int64))
    counts = np.asarray(dataset.counts, np.int64)

    for r in range(comm_round):
        if m == n_clients:
            ids = np.arange(n_clients)
        else:
            # local RandomState(r) draws the bit-identical ids the
            # reference's np.random.seed(r) global path draws (same MT19937
            # seeding) without clobbering the process-global numpy RNG
            rs = np.random.RandomState(r)
            ids = np.sort(rs.choice(range(n_clients), m, replace=False))
        w_locals = []
        for cid in ids:
            k = int(counts[cid])
            if k == 0:
                continue
            model.load_state_dict(copy.deepcopy(w_global))
            opt = torch.optim.SGD(model.parameters(), lr=learning_rate)
            xc, yc = xs[cid, :k], ys[cid, :k]
            g = torch.Generator().manual_seed(seed * 100003 + r * 1009 + int(cid))
            for _ in range(epochs):
                order = torch.randperm(k, generator=g)
                for b in range(0, k - batch_size + 1, batch_size):
                    idx = order[b:b + batch_size]
                    opt.zero_grad()
                    F.cross_entropy(model(xc[idx]), yc[idx]).backward()
                    opt.step()
                if k < batch_size:  # tiny client: one full-shard step/epoch
                    opt.zero_grad()
                    F.cross_entropy(model(xc), yc).backward()
                    opt.step()
            w_locals.append((k, copy.deepcopy(model.state_dict())))
        if not w_locals:
            continue
        total = sum(n for n, _ in w_locals)
        agg = copy.deepcopy(w_locals[0][1])
        for key in agg:
            agg[key] = sum(w[key] * (n / total) for n, w in w_locals)
        w_global = agg

    model.load_state_dict(w_global)
    model.eval()
    with torch.no_grad():
        xt = torch.tensor(np.asarray(dataset.x_test, np.float32))
        yt = np.asarray(dataset.y_test, np.int64)
        pred = model(xt).argmax(dim=1).numpy()
    return float((pred == yt).mean())
