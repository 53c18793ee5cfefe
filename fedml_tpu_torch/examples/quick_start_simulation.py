"""Quick start: config-driven FL simulation (port of
examples/quick_start_simulation.py; the reference "parrot" example,
python/examples/federate/quick_start/parrot/).

Run:  python -m fedml_tpu_torch.examples.quick_start_simulation
          [path/to/fedml_config.yaml] [--device cpu]

Reference fedml_config.yaml files load unchanged. Without an argument this
uses an inline config (synthetic fallback data when no dataset files exist).
"""
from __future__ import annotations

import copy

import fedml_tpu_torch
from fedml_tpu_torch.examples import parser


# the JAX example's inline config
CONFIG = {
    "data_args": {"dataset": "mnist"},
    "model_args": {"model": "lr"},
    "train_args": {
        "federated_optimizer": "FedAvg",
        "client_num_in_total": 10,
        "client_num_per_round": 10,
        "comm_round": 10,
        "epochs": 1,
        "batch_size": 10,
        "learning_rate": 0.03,
    },
}


def main(argv=None, draws=None) -> dict:
    """The run's last history row, with every row under "history".
    `draws` (optional): {"params": the initial state dict, "batches":
    each round's [clients, steps, B] batch order, by round}."""
    ap = parser(__doc__)
    ap.add_argument("config", nargs="?", help="a fedml_config.yaml")
    args = ap.parse_args(argv)
    if args.config:
        cfg = fedml_tpu_torch.init(config_path=args.config,
                                   device=args.device)
    else:
        cfg = fedml_tpu_torch.init(config=copy.deepcopy(CONFIG),
                                   device=args.device)

    kw = {} if draws is None else {
        "params": draws["params"],
        "batch_schedule": draws["batches"].__getitem__}
    history = fedml_tpu_torch.run_simulation(cfg, **kw)
    print("final round:", history[-1])
    return {**history[-1], "history": history}


if __name__ == "__main__":
    main()
