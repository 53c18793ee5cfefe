"""Per-client (data-silo) config overrides in the port
(`fedml_tpu_torch.config.Config.apply_data_silo_config`, applied by
`fedml_tpu_torch.init`), held against the JAX package on the seven cases
of `tests/test_config_silo.py`: each case builds both packages' configs
from the same files and compares every section."""
import dataclasses
import json

import pytest
import yaml

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu.config import _FLAT_KEY_SECTION as JAX_FLAT
from fedml_tpu_torch.config import _FLAT_KEY_SECTION, Config


def _sections(cfg) -> dict:
    d = cfg.to_dict()
    d["train_args"].pop("data_silo_config", None)
    return d


def _both(**kw):
    """The JAX and the port config from the same init arguments (the
    port's run device: the CPU)."""
    want = fedml_tpu.init(**kw)
    got = fedml_tpu_torch.init(device="cpu", **kw)
    got.device_args.extra.pop("device")
    assert _sections(got) == _sections(want)
    return got


def _write_configs(tmp_path, fmt="yaml"):
    dump = yaml.safe_dump if fmt == "yaml" else json.dumps
    (tmp_path / f"silo_1.{fmt}").write_text(dump({
        "train_args": {"batch_size": 8, "learning_rate": 0.5}}))
    # silo 2 in the reference's flat key style
    (tmp_path / f"silo_2.{fmt}").write_text(dump({"batch_size": 64}))
    base = {
        "common_args": {"training_type": "cross_silo"},
        "train_args": {"client_num_in_total": 2, "client_num_per_round": 2,
                       "batch_size": 32, "learning_rate": 0.1},
        "client_specific_args": {
            "data_silo_config": [f"silo_1.{fmt}", f"silo_2.{fmt}"]},
    }
    p = tmp_path / f"fedml_config.{fmt}"
    p.write_text(dump(base))
    return p


@pytest.mark.parametrize("fmt", ["yaml", "json"])
def test_two_silos_get_different_batch_sizes(tmp_path, fmt, monkeypatch):
    p = _write_configs(tmp_path, fmt)
    monkeypatch.chdir(tmp_path.parent)      # paths resolve by the config
    c1 = _both(config_path=str(p), rank=1, role="client")
    assert c1.train_args.batch_size == 8
    assert c1.train_args.learning_rate == 0.5
    c2 = _both(config_path=str(p), rank=2, role="client")
    assert c2.train_args.batch_size == 64
    assert c2.train_args.learning_rate == 0.1


def test_server_rank_keeps_base_config(tmp_path):
    p = _write_configs(tmp_path)
    c0 = _both(config_path=str(p))
    assert c0.rank == 0 and c0.train_args.batch_size == 32


def test_rank_beyond_silo_list_raises(tmp_path):
    p = _write_configs(tmp_path)
    with pytest.raises(ValueError, match="no data_silo_config entry") as e:
        fedml_tpu_torch.init(config_path=str(p), rank=3, device="cpu")
    with pytest.raises(ValueError) as j:
        fedml_tpu.init(config_path=str(p), rank=3)
    assert str(e.value) == str(j.value)


def test_data_silo_config_in_train_args_extra(tmp_path):
    (tmp_path / "s1.yaml").write_text(yaml.safe_dump({"epochs": 7}))
    cfg = _both(config={
        "train_args": {"data_silo_config": [str(tmp_path / "s1.yaml")]},
        "rank": 1})
    assert cfg.train_args.epochs == 7


def test_override_cannot_break_validation(tmp_path):
    (tmp_path / "bad.yaml").write_text(yaml.safe_dump(
        {"train_args": {"client_num_per_round": 99}}))
    d = {"train_args": {"client_num_in_total": 2, "client_num_per_round": 2,
                        "data_silo_config": [str(tmp_path / "bad.yaml")]},
         "rank": 1}
    with pytest.raises(ValueError, match="client_num_per_round") as e:
        fedml_tpu_torch.init(config=d, device="cpu")
    with pytest.raises(ValueError) as j:
        fedml_tpu.init(config=d)
    assert str(e.value) == str(j.value)


def test_flat_override_keys_route_to_owning_section(tmp_path):
    (tmp_path / "s1.yaml").write_text(yaml.safe_dump({
        "data_cache_dir": "/silo1/data", "model": "cnn", "batch_size": 4}))
    cfg = _both(config={
        "train_args": {"data_silo_config": [str(tmp_path / "s1.yaml")]},
        "rank": 1})
    assert cfg.data_args.data_cache_dir == "/silo1/data"
    assert cfg.model_args.model == "cnn"
    assert cfg.train_args.batch_size == 4


def test_flat_key_routing_train_args_wins_collisions():
    train_fields = {
        f.name for f in dataclasses.fields(Config.SECTION_TYPES["train_args"])
        if f.name != "extra"}
    assert train_fields
    for name in train_fields:
        assert _FLAT_KEY_SECTION[name] == "train_args", name
    assert {k: v for k, v in _FLAT_KEY_SECTION.items() if k in JAX_FLAT} \
        == {k: v for k, v in JAX_FLAT.items() if k in _FLAT_KEY_SECTION}


def test_json_config_loads_without_yaml(tmp_path, monkeypatch):
    """A JSON config (and its JSON silo files) load with `json` alone: the
    card's machine may have no PyYAML."""
    import sys

    p = _write_configs(tmp_path, "json")
    want = _sections(fedml_tpu.init(config_path=str(p), rank=2))
    monkeypatch.setitem(sys.modules, "yaml", None)
    got = fedml_tpu_torch.init(config_path=str(p), rank=2, device="cpu")
    got.device_args.extra.pop("device")
    assert _sections(got) == want and got.train_args.batch_size == 64
