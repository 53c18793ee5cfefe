"""Attack vs defense: byzantine clients against a robust aggregator, all as
round-program plugins (port of examples/attack_vs_defense.py; reference:
core/security/fedml_attacker.py / fedml_defender.py wired by
security_args; here the same config keys compose transforms into the
round — simulation/simulator.py).

Run:  python -m fedml_tpu_torch.examples.attack_vs_defense [--device cpu]
"""
from __future__ import annotations

import fedml_tpu_torch
from fedml_tpu_torch.examples import parser
from fedml_tpu_torch.simulation.simulator import Simulator


def run(defense: bool, device) -> float:
    cfg = fedml_tpu_torch.init(config={
        "data_args": {"dataset": "digits", "partition_method": "hetero",
                      "partition_alpha": 0.5},
        "model_args": {"model": "mlp"},
        "train_args": {"federated_optimizer": "FedAvg",
                       "client_num_in_total": 8, "client_num_per_round": 8,
                       "comm_round": 10, "epochs": 1, "batch_size": 32,
                       "learning_rate": 0.1},
        "validation_args": {"frequency_of_the_test": 0},
        "comm_args": {"backend": "sp"},
        "security_args": {
            "enable_attack": True, "attack_type": "byzantine",
            "attack_spec": {"byzantine_client_num": 2,
                            "attack_mode": "random"},
            **({"enable_defense": True, "defense_type": "multikrum",
                "defense_spec": {"byzantine_client_num": 2}} if defense
               else {}),
        },
    }, device=device)
    sim = Simulator(cfg)
    sim.run(10)
    return sim.evaluate()["test_acc"]


def main(argv=None) -> dict:
    args = parser(__doc__).parse_args(argv)
    acc_defended = run(defense=True, device=args.device)
    acc_undefended = run(defense=False, device=args.device)
    print(f"under byzantine attack: defended acc={acc_defended:.3f}  "
          f"undefended acc={acc_undefended:.3f}")
    assert acc_defended > acc_undefended - 0.02, (
        "multikrum should not be worse than no defense under attack")
    print("defense held against byzantine clients")
    return {"test_acc": acc_defended, "undefended_test_acc": acc_undefended}


if __name__ == "__main__":
    main()
