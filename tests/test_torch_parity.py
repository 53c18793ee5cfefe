"""The reference-parity harness (`fedml_tpu_torch/parity.py`) held against
the JAX package's `fedml_tpu/parity.py`: the same hyperparameter dict,
the port's loader giving JAX's partition of sklearn digits (Dirichlet
non-IID) bit for bit, the port's `torch_fedavg` over the port's
`FedDataset` equal to JAX's over JAX's (the same torch loop on the same
arrays: the final accuracy is the same number), client sampling equal to
the port Simulator's, and the harness's accuracy beside the port
Simulator's after the same rounds (tests/test_reference_parity.py's bar:
within 0.05, both above 0.8, at PARITY_HP's 30 rounds)."""
import inspect

import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu.data import loader as jax_loader
from fedml_tpu.parity import PARITY_HP as JAX_HP
from fedml_tpu.parity import torch_fedavg as jax_torch_fedavg
from fedml_tpu_torch.data import loader as port_loader
from fedml_tpu_torch.parity import PARITY_HP, torch_fedavg

torch.set_num_threads(2)
pytest.importorskip("sklearn")


def _cfg(model="mlp", per_round=10, rounds=None) -> dict:
    return {
        "data_args": {"dataset": "digits", "partition_method": "hetero",
                      "partition_alpha": 0.5},
        "model_args": {"model": model},
        "train_args": {"federated_optimizer": "FedAvg",
                       "client_num_in_total": 10,
                       "client_num_per_round": per_round,
                       **PARITY_HP,
                       **({"comm_round": rounds} if rounds else {})},
        "validation_args": {"frequency_of_the_test": 0},
        "comm_args": {"backend": "sp"},
    }


@pytest.fixture(scope="module")
def datasets():
    port = port_loader.load(fedml_tpu_torch.init(config=_cfg(),
                                                 device="cpu"))
    jax_ds = jax_loader.load(fedml_tpu.init(config=_cfg()))
    return port, jax_ds


def test_hyperparameters_are_jax_and_every_key_is_an_argument():
    assert PARITY_HP == JAX_HP
    assert set(PARITY_HP) <= set(inspect.signature(
        torch_fedavg).parameters)
    assert inspect.signature(torch_fedavg).parameters.keys() == \
        inspect.signature(jax_torch_fedavg).parameters.keys()


def test_port_partition_is_jax_bitwise(datasets):
    port, jax_ds = datasets
    assert not port.synthetic
    for f in ("x_train", "y_train", "mask_train", "counts", "x_test",
              "y_test"):
        assert np.array_equal(np.asarray(getattr(port, f)),
                              np.asarray(getattr(jax_ds, f))), f
    assert port.num_classes == jax_ds.num_classes


@pytest.mark.parametrize("model,per_round", [("mlp", 4), ("lr", 10)])
def test_torch_fedavg_equals_jax(datasets, model, per_round):
    """Same partition, same sampling, same torch loop: the same final
    accuracy (exact; the CPU's float arithmetic is deterministic here)."""
    port, jax_ds = datasets
    kw = dict(model_name=model, comm_round=3, epochs=1, batch_size=32,
              learning_rate=0.1, clients_per_round=per_round, seed=0)
    acc_p = torch_fedavg(port, **kw)
    acc_j = jax_torch_fedavg(jax_ds, **kw)
    assert acc_p == acc_j and 0.0 < acc_p <= 1.0


def test_client_sampling_matches_the_port_simulator():
    """The harness's ids (a RandomState seeded by the round) are the
    Simulator's `sample_clients`, which is the reference's
    np.random.seed(round) choice."""
    from fedml_tpu_torch.simulation.simulator import Simulator

    sim = Simulator(fedml_tpu_torch.init(config=_cfg("lr", 4),
                                         device="cpu"), device="cpu")
    for r in range(5):
        rs = np.random.RandomState(r)
        ids = np.sort(rs.choice(range(10), 4, replace=False))
        np.random.seed(r)
        ref = np.sort(np.random.choice(range(10), 4, replace=False))
        assert np.array_equal(sim.sample_clients(r), ids)
        assert np.array_equal(ids, ref)


def test_final_accuracy_beside_the_port_simulator(datasets):
    """The parity bar on the port: the Simulator's FedAvg and the
    reference-style loop, the shared hyperparameters on the same
    partition, within 0.05 of each other and both above 0.8."""
    from fedml_tpu_torch.simulation.simulator import Simulator

    rounds = PARITY_HP["comm_round"]
    port, _ = datasets
    sim = Simulator(fedml_tpu_torch.init(config=_cfg(rounds=rounds),
                                         device="cpu"),
                    dataset=port, device="cpu")
    sim.run(rounds)
    sim_acc = sim.evaluate()["test_acc"]
    ref_acc = torch_fedavg(port, model_name="mlp", comm_round=rounds,
                           epochs=PARITY_HP["epochs"],
                           batch_size=PARITY_HP["batch_size"],
                           learning_rate=PARITY_HP["learning_rate"],
                           clients_per_round=10)
    assert sim_acc > 0.8 and ref_acc > 0.8, (sim_acc, ref_acc)
    assert abs(sim_acc - ref_acc) < 0.05, (sim_acc, ref_acc)
