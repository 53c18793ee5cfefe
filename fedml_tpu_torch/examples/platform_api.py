"""Platform-tier example: cluster -> job -> trained model -> deploy -> serve
(port of examples/platform_api.py).

The reference's `fedml launch` + model-serving workflow (reference:
python/fedml/api/__init__.py launch_job / model_deploy), local-first:

    python -m fedml_tpu_torch.examples.platform_api [--device cpu]

The model registry is `api._REGISTRY` (~/.fedml_tpu_torch/models); the
example deletes what it registers.
"""
from __future__ import annotations

import json
import urllib.request

import fedml_tpu_torch
import fedml_tpu_torch.api as api
from fedml_tpu_torch.examples import parser


def main(argv=None) -> dict:
    args = parser(__doc__).parse_args(argv)
    # 1. bring up a local "cluster" (master + 2 workers over loopback)
    cluster = api.cluster_start(n_workers=2, device=args.device)

    # 2. launch a federated training job through the scheduler
    out = api.launch_job({
        "type": "simulation", "requirements": {}, "config": {
            "data_args": {"dataset": "digits",
                          "partition_method": "hetero",
                          "partition_alpha": 0.5},
            "model_args": {"model": "mlp"},
            "train_args": {"federated_optimizer": "FedAvg",
                           "client_num_in_total": 10,
                           "client_num_per_round": 10,
                           "comm_round": 10, "epochs": 1,
                           "batch_size": 32, "learning_rate": 0.1},
            "validation_args": {"frequency_of_the_test": 0}},
    }, cluster=cluster, wait=True, timeout=600)
    print("job:", out["status"], out["result"])

    # 3. train a quick model locally and register it
    from fedml_tpu_torch.simulation.simulator import Simulator

    cfg = fedml_tpu_torch.init(config={
        "data_args": {"dataset": "digits"},
        "model_args": {"model": "lr"},
        "train_args": {"federated_optimizer": "FedAvg",
                       "client_num_in_total": 5, "client_num_per_round": 5,
                       "comm_round": 10, "epochs": 1, "batch_size": 32,
                       "learning_rate": 0.3},
        "validation_args": {"frequency_of_the_test": 0}},
        device=args.device)
    sim = Simulator(cfg)
    sim.run(10)
    trained = sim.evaluate()
    print("trained:", trained)
    api.model_create("digits-lr", model="lr", num_classes=10,
                     params={k: v.cpu() for k, v in
                             sim.server_state.params.items()})

    # 4. deploy to the cluster's workers + query through a replica
    dep = api.model_deploy("digits-lr", cluster, n_replicas=2)
    ep = dep.ready_replicas()[0].endpoint
    x = sim.dataset.x_test[:2].reshape(2, -1).tolist()
    req = urllib.request.Request(
        ep + "/predict", data=json.dumps({"inputs": x}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        served = json.loads(r.read())["predictions"]
    print("served prediction:", served,
          "truth:", sim.dataset.y_test[:2].tolist())

    api.model_delete("digits-lr")
    api.cluster_stop(cluster)
    return {"job_status": out["status"], "test_acc": trained["test_acc"],
            "served": len(served)}


if __name__ == "__main__":
    main()
