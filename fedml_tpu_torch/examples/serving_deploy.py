"""Serving deploy: train federated, publish per-round model artifacts, serve
round N over HTTP (port of examples/serving_deploy.py; reference:
python/fedml/serving/ FedMLInferenceRunner + the mlops model-artifact
upload, core/mlops/__init__.py:388).

Run:  python -m fedml_tpu_torch.examples.serving_deploy [--device cpu]
"""
from __future__ import annotations

import json
import os
import tempfile
import urllib.request

import numpy as np

import fedml_tpu_torch
from fedml_tpu_torch import mlops
from fedml_tpu_torch.examples import parser
from fedml_tpu_torch.serving import (
    FedMLInferenceRunner, export_model, predictor_from_artifact,
)
from fedml_tpu_torch.serving.scheduler import start_replica
from fedml_tpu_torch.simulation.simulator import Simulator
from fedml_tpu_torch.utils.artifacts import FileArtifactStore, aggregated_name


def post(port: int, x: np.ndarray) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict",
        data=json.dumps({"inputs": x.tolist()}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


def main(argv=None) -> dict:
    args = parser(__doc__).parse_args(argv)
    cfg = fedml_tpu_torch.init(config={
        "data_args": {"dataset": "digits"},
        "model_args": {"model": "mlp"},
        "train_args": {"federated_optimizer": "FedAvg",
                       "client_num_in_total": 4, "client_num_per_round": 4,
                       "comm_round": 3, "epochs": 1, "batch_size": 32,
                       "learning_rate": 0.1},
        "validation_args": {"frequency_of_the_test": 0},
        "comm_args": {"backend": "sp"},
    }, device=args.device)
    with tempfile.TemporaryDirectory() as tmp:
        store = FileArtifactStore(os.path.join(tmp, "artifacts"))
        mlops.set_artifact_store(store)

        sim = Simulator(cfg)
        for r in range(3):
            sim.run_round(r)
            mlops.log_aggregated_model_info(r, sim.server_state.params)
        print("published:", store.list())
        assert aggregated_name(1) in store.list()

        # deploy round 1 (not the latest — artifacts are addressable by
        # round)
        pred = predictor_from_artifact(store, 1, sim.apply_fn,
                                       device=args.device)
        runner = FedMLInferenceRunner(pred, host="127.0.0.1", port=0)
        runner.start()
        try:
            x = np.asarray(sim.dataset.x_test[:4], np.float32)
            out = post(runner.port, x)
            print("served predictions:", out["predictions"],
                  "labels:", sim.dataset.y_test[:4].tolist())
        finally:
            runner.stop()
            mlops.set_artifact_store(None)
        print("served round-1 artifact over HTTP")

        # --- framework-neutral export (the ONNX/Triton-repo analog):
        # write the trained model as manifest.json + tensors.npz, then
        # boot a replica from the export alone — the manifest carries the
        # model recipe
        exp_dir = os.path.join(tmp, "export")
        export_model(exp_dir, sim.server_state.params, model_name="mlp",
                     num_classes=sim.num_classes, input_shape=(64,))
        print("exported:", sorted(os.listdir(exp_dir)))
        _rid, runner2 = start_replica({"export_dir": exp_dir, "port": 0,
                                       "device": args.device})
        try:
            out2 = post(runner2.port, x)
            print("served from export:", out2["predictions"])
            assert len(out2["predictions"]) == len(x)
        finally:
            runner2.stop()
    print("OK serving deploy (artifact + export paths)")
    return {"served": len(out["predictions"]) + len(out2["predictions"])}


if __name__ == "__main__":
    main()
