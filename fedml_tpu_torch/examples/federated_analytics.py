"""Federated analytics (port of examples/federated_analytics.py; the
reference fa/ examples): heavy-hitter discovery with TrieHH + a
k-percentile over the federation, no model training at all. The analytics
are host numpy; `--device` is resolved like every entry point's.

Run:  python -m fedml_tpu_torch.examples.federated_analytics [--device cpu]
"""
from __future__ import annotations

import numpy as np

from fedml_tpu_torch._device import resolve_device
from fedml_tpu_torch.examples import parser
from fedml_tpu_torch.fa import FASimulator, run_fa_cross_silo


def main(argv=None) -> dict:
    args = parser(__doc__).parse_args(argv)
    resolve_device(args.device)
    # heavy hitters: which words are common across clients, with DP
    clients = [["sunshine"] * 120 + ["moonlight"] * 100 + ["rare_word"]
               for _ in range(10)]
    hh = FASimulator("triehh", clients, num_rounds=12, epsilon=8.0).run()
    print("heavy hitters:", hh)

    # k-percentile over numeric data, cross-silo over the comm layer
    rs = np.random.RandomState(0)
    data = [rs.lognormal(3.0, 1.0, 500) for _ in range(5)]
    server = run_fa_cross_silo("k_percentile", data, k=95.0, lo=0, hi=500,
                               bins=8192)
    central = float(np.percentile(np.concatenate(data), 95))
    print("federated p95:", round(server.result, 2),
          "| centralized p95:", round(central, 2))
    return {"heavy_hitters": hh, "p95": float(server.result),
            "central_p95": central}


if __name__ == "__main__":
    main()
