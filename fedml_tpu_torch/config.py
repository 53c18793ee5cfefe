"""Typed configuration tree (port of `fedml_tpu/config.py`).

The same YAML sections as the JAX package (common_args, data_args,
model_args, train_args, validation_args, device_args, comm_args,
tracking_args, security_args, dp_args, serve_args), validated into
dataclasses at load time; keys a section does not declare go to its
`extra` dict. `validate` holds the rules of the knobs the ported
simulation path reads. `load_config` reads a file that is valid JSON with
`json` and imports `yaml` only for other files: a machine without PyYAML
still loads a JSON config, or builds a `Config` from a dict.
`apply_data_silo_config` merges a client rank's override file.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional

TRAINING_TYPE_SIMULATION = "simulation"
TRAINING_TYPE_CROSS_SILO = "cross_silo"
TRAINING_TYPE_CROSS_DEVICE = "cross_device"
TRAINING_TYPE_CROSS_CLOUD = "cross_cloud"
TRAINING_TYPE_CENTRALIZED = "centralized"

# simulation backends: "sp" is one device; "xla" is the JAX package's
# mesh backend, which on one device is the same single-device path
BACKEND_SP = "sp"
BACKEND_XLA = "xla"

SCENARIO_HORIZONTAL = "horizontal"
SCENARIO_HIERARCHICAL = "hierarchical"


def _apply(dc, d: dict):
    """Fill dataclass fields from a dict; unknown keys go to .extra."""
    names = {f.name for f in dataclasses.fields(dc)}
    for k, v in d.items():
        if k in names:
            setattr(dc, k, v)
        else:
            dc.extra[k] = v
    return dc


@dataclass
class CommonArgs:
    training_type: str = TRAINING_TYPE_SIMULATION
    random_seed: int = 0
    scenario: str = SCENARIO_HORIZONTAL
    config_version: str = "release"
    extra: dict = field(default_factory=dict)


@dataclass
class DataArgs:
    dataset: str = "synthetic"
    data_cache_dir: str = "~/fedml_data"
    partition_method: str = "hetero"   # hetero = Dirichlet non-IID, homo = IID
    partition_alpha: float = 0.5
    extra: dict = field(default_factory=dict)


@dataclass
class ModelArgs:
    model: str = "lr"
    extra: dict = field(default_factory=dict)


@dataclass
class TrainArgs:
    federated_optimizer: str = "FedAvg"
    client_id_list: Any = "[]"
    client_num_in_total: int = 2
    client_num_per_round: int = 2
    comm_round: int = 10
    epochs: int = 1
    batch_size: int = 10
    client_optimizer: str = "sgd"
    learning_rate: float = 0.03
    momentum: float = 0.0
    weight_decay: float = 0.0
    server_optimizer: str = "sgd"
    server_lr: float = 1.0
    server_momentum: float = 0.0
    # "float32" or "bfloat16": bf16 runs the model's matmuls and convolutions
    # in bf16 while the trained parameters and the optimizer stay f32
    compute_dtype: str = "float32"
    # FedProx / FedDyn / Mime hyper-parameters (explicit zeros are honoured)
    fedprox_mu: float = 0.01
    feddyn_alpha: float = 0.01
    mime_beta: float = 0.9
    extra: dict = field(default_factory=dict)


@dataclass
class ValidationArgs:
    frequency_of_the_test: int = 1
    extra: dict = field(default_factory=dict)


@dataclass
class DeviceArgs:
    using_gpu: bool = False
    gpu_id: int = 0
    mesh_shape: Optional[dict] = None
    extra: dict = field(default_factory=dict)


@dataclass
class CommArgs:
    backend: str = BACKEND_XLA
    grpc_ipconfig_path: str = ""
    extra: dict = field(default_factory=dict)


@dataclass
class TrackingArgs:
    enable_tracking: bool = False
    enable_wandb: bool = False
    log_file_dir: str = "./log"
    run_name: str = "fedml_tpu_run"
    extra: dict = field(default_factory=dict)


@dataclass
class SecurityArgs:
    enable_attack: bool = False
    attack_type: str = ""
    attack_spec: dict = field(default_factory=dict)
    enable_defense: bool = False
    defense_type: str = ""
    defense_spec: dict = field(default_factory=dict)
    extra: dict = field(default_factory=dict)


@dataclass
class DPArgs:
    enable_dp: bool = False
    mechanism_type: str = "gaussian"
    dp_solution_type: str = "ldp"
    epsilon: float = 1.0
    delta: float = 1e-5
    sensitivity: float = 1.0
    clipping_norm: float = 1.0
    extra: dict = field(default_factory=dict)


@dataclass
class ServeArgs:
    """Model-serving knobs; all ride `extra`, validated at load against
    `serving/knobs.py` and mapped onto the LM predictor by
    `serving.lm_predictor_from_config`."""
    extra: dict = field(default_factory=dict)


@dataclass
class Config:
    common_args: CommonArgs = field(default_factory=CommonArgs)
    data_args: DataArgs = field(default_factory=DataArgs)
    model_args: ModelArgs = field(default_factory=ModelArgs)
    train_args: TrainArgs = field(default_factory=TrainArgs)
    validation_args: ValidationArgs = field(default_factory=ValidationArgs)
    device_args: DeviceArgs = field(default_factory=DeviceArgs)
    comm_args: CommArgs = field(default_factory=CommArgs)
    tracking_args: TrackingArgs = field(default_factory=TrackingArgs)
    security_args: SecurityArgs = field(default_factory=SecurityArgs)
    dp_args: DPArgs = field(default_factory=DPArgs)
    serve_args: ServeArgs = field(default_factory=ServeArgs)
    rank: int = 0
    role: str = "server"
    run_id: str = "0"
    client_specific_args: dict = field(default_factory=dict)

    SECTION_TYPES = {
        "common_args": CommonArgs,
        "data_args": DataArgs,
        "model_args": ModelArgs,
        "train_args": TrainArgs,
        "validation_args": ValidationArgs,
        "device_args": DeviceArgs,
        "comm_args": CommArgs,
        "tracking_args": TrackingArgs,
        "security_args": SecurityArgs,
        "dp_args": DPArgs,
        "serve_args": ServeArgs,
    }

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        cfg = cls()
        # "serve" is an alias for "serve_args"; both present is ambiguous
        if "serve" in d and isinstance(d["serve"], dict):
            if "serve_args" in d:
                raise ValueError(
                    "config has both 'serve' and 'serve_args' sections — "
                    "'serve' is an alias for 'serve_args'; keep one")
            d = {**d, "serve_args": d["serve"]}
        for section in cls.SECTION_TYPES:
            if section in d and isinstance(d[section], dict):
                _apply(getattr(cfg, section), d[section])
        for k in ("rank", "role", "run_id"):
            if k in d:
                setattr(cfg, k, d[k])
        if isinstance(d.get("client_specific_args"), dict):
            cfg.client_specific_args = dict(d["client_specific_args"])
        cfg.validate()
        return cfg

    @classmethod
    def from_yaml(cls, path: str | Path) -> "Config":
        return cls.from_dict(read_config_file(path))

    def to_dict(self) -> dict:
        out = {}
        for section in self.SECTION_TYPES:
            sec = dataclasses.asdict(getattr(self, section))
            extra = sec.pop("extra", {})
            sec.update(extra)
            out[section] = sec
        out.update(rank=self.rank, role=self.role, run_id=self.run_id)
        return out

    def merge_overrides(self, d: dict) -> None:
        """Merge a (possibly partial) config dict over this config: section
        dicts merge into their sections; a flat key goes to the section
        that declares it (train_args wins a collision), an undeclared flat
        key to train_args.extra. Re-validates after the merge."""
        for k, v in d.items():
            if k in self.SECTION_TYPES and isinstance(v, dict):
                _apply(getattr(self, k), v)
            elif k in ("rank", "role", "run_id"):
                setattr(self, k, v)
            else:
                _apply(getattr(self, _FLAT_KEY_SECTION.get(k, "train_args")),
                       {k: v})
        self.validate()

    def apply_data_silo_config(self, base_dir: Optional[Path] = None) -> None:
        """Per-client config overrides (reference: python/fedml/__init__.py
        :188-214 `_update_client_specific_args`): when
        `client_specific_args.data_silo_config` (or the flat
        `train_args.data_silo_config`) lists override files and this
        config's rank is a client rank (> 0), merge file [rank - 1] over
        the config. A relative path resolves against `base_dir` (the main
        config file's directory) when the file is there, else against the
        working directory."""
        silo_cfgs = (self.client_specific_args.get("data_silo_config")
                     or self.train_args.extra.get("data_silo_config"))
        if not silo_cfgs or self.rank <= 0:
            return
        if self.rank > len(silo_cfgs):
            raise ValueError(
                f"rank {self.rank} has no data_silo_config entry "
                f"({len(silo_cfgs)} files listed)")
        p = Path(str(silo_cfgs[self.rank - 1])).expanduser()
        if not p.is_absolute() and base_dir is not None \
                and (Path(base_dir) / p).exists():
            p = Path(base_dir) / p
        self.merge_overrides(read_config_file(p))

    def validate(self) -> None:
        t = self.train_args
        if t.client_num_per_round > t.client_num_in_total:
            raise ValueError(
                f"client_num_per_round ({t.client_num_per_round}) > "
                f"client_num_in_total ({t.client_num_in_total})"
            )
        if t.comm_round < 1 or t.epochs < 1 or t.batch_size < 1:
            raise ValueError("comm_round, epochs and batch_size must be >= 1")
        # the simulator's execution knobs, validated as the JAX package
        # validates them
        for knob, lo in (("rounds_per_block", 1), ("block_pipeline_depth", 1),
                         ("cohort_chunk", 1), ("ingest_prefetch", 0)):
            val = t.extra.get(knob)
            if val is None:
                continue
            try:
                ok = (not isinstance(val, bool)
                      and int(val) == float(val) and int(val) >= lo)
            except (TypeError, ValueError):
                ok = False
            if not ok:
                raise ValueError(
                    f"train_args.{knob} must be an integer >= {lo}; "
                    f"got {val!r}")
        if t.extra.get("ingest_prefetch") is not None \
                and not t.extra.get("cohort_chunk"):
            raise ValueError(
                "train_args.ingest_prefetch requires cohort_chunk — the "
                "streaming ingest pipeline only exists for chunked rounds; "
                "without it the knob would be silently ignored")
        cm = t.extra.get("cost_model")
        if cm not in (None, False, True):
            if not isinstance(cm, dict):
                raise ValueError(
                    "train_args.cost_model must be a boolean or a dict of "
                    f"{{fit_after_rounds, error_threshold}}; got {cm!r}")
            unknown_cm = set(cm) - {"fit_after_rounds", "error_threshold"}
            if unknown_cm:
                raise ValueError(
                    f"unknown cost_model knob(s) {sorted(unknown_cm)}; "
                    "valid: ['error_threshold', 'fit_after_rounds']")
            far = cm.get("fit_after_rounds")
            if far is not None and (isinstance(far, bool)
                                    or not isinstance(far, int) or far < 1):
                raise ValueError(
                    "cost_model.fit_after_rounds must be an integer >= 1; "
                    f"got {far!r}")
            et = cm.get("error_threshold")
            if et is not None:
                try:
                    ok = not isinstance(et, bool) and float(et) > 0
                except (TypeError, ValueError):
                    ok = False
                if not ok:
                    raise ValueError(
                        "cost_model.error_threshold must be a positive "
                        f"number; got {et!r}")
        # a client group that does not divide the chunk would change the
        # groups' boundaries against the single-shot round, and chunked ==
        # single-shot would hold only to float tolerance (one device: the
        # per-device chunk is the chunk; the JAX Simulator's check)
        group = int(t.extra.get("clients_per_device_parallel", 1) or 1)
        cc = t.extra.get("cohort_chunk")
        if cc and group > 1 and int(cc) % group:
            raise ValueError(
                f"train_args.clients_per_device_parallel ({group}) must "
                f"divide the per-device chunk (cohort_chunk = {int(cc)}): "
                "unaligned client groups break chunked == single-shot "
                "bit-identity")
        if t.extra.get("cohort_chunk") and t.extra.get("health_stats") is True:
            raise ValueError(
                "train_args.health_stats=true cannot be combined with "
                "cohort_chunk: per-client health stats need the full "
                "update stack the chunked engine exists to avoid "
                "materializing")
        # the /metrics endpoint's port (utils/prometheus.py), validated at
        # load as in the JAX package, so a typo'd value fails before a run
        # comes up unscrapeable
        mp = self.common_args.extra.get("metrics_port")
        if mp is not None:
            try:
                # bool is an int subtype: `metrics_port: true` would pass
                # as port 1 and fail only at bind time
                ok = (not isinstance(mp, bool)
                      and int(mp) == float(mp) and 0 <= int(mp) <= 65535)
            except (TypeError, ValueError):
                ok = False
            if not ok:
                raise ValueError(
                    "common_args.extra.metrics_port must be an integer in "
                    f"[0, 65535] (0 = ephemeral); got {mp!r}")
        # the cross-silo durability knobs, validated as the JAX package
        # validates them, so a typo'd config fails at load, not as a hang
        # rounds into a federation
        for knob in ("round_timeout", "heartbeat_s", "liveness_timeout_s",
                     "server_timeout_s"):
            val = t.extra.get(knob)
            if val is None:
                continue
            try:
                ok = not isinstance(val, bool) and float(val) > 0
            except (TypeError, ValueError):
                ok = False
            if not ok:
                raise ValueError(
                    f"train_args.{knob} must be a positive number of "
                    f"seconds; got {val!r}")
        qf = t.extra.get("quorum_frac")
        if qf is not None:
            try:
                ok = not isinstance(qf, bool) and 0.0 < float(qf) <= 1.0
            except (TypeError, ValueError):
                ok = False
            if not ok:
                raise ValueError(
                    "train_args.quorum_frac must be a fraction in (0, 1]; "
                    f"got {qf!r}")
        for knob, lo in (("max_rearms", 1), ("checkpoint_every", 0),
                         ("checkpoint_keep", 1)):
            val = t.extra.get(knob)
            if val is None:
                continue
            try:
                ok = (not isinstance(val, bool)
                      and int(val) == float(val) and int(val) >= lo)
            except (TypeError, ValueError):
                ok = False
            if not ok:
                raise ValueError(
                    f"train_args.{knob} must be an integer >= {lo}; "
                    f"got {val!r}")
        for knob in ("resume", "reattach"):
            val = t.extra.get(knob)
            if val is not None and not isinstance(val, bool):
                raise ValueError(
                    f"train_args.{knob} must be a boolean; got {val!r}")
        # the chaos plane's plan and the retry budget fail at load, not at
        # the first round
        chaos = self.common_args.extra.get("chaos")
        if chaos is not None:
            from .comm.chaos import FaultSpec

            FaultSpec.from_dict(chaos)
        cr = self.common_args.extra.get("comm_retry")
        if cr not in (None, False):
            from .comm.reliable import RetryPolicy

            RetryPolicy.from_dict(cr)
        # the live loop's soak knobs (soak/knobs.py, the JAX registry's
        # keys and messages): unknown keys, bad kinds and gated knobs
        # without their prerequisite fail here, at load
        sk = self.common_args.extra.get("soak")
        if sk is not None:
            from .soak.knobs import validate_soak

            validate_soak(sk)
        # the fleet-observability section (roster, port, cadence): a typo
        # fails at load, not as a fleet view that never aggregates
        of = self.common_args.extra.get("obs_fleet")
        if of is not None:
            from .utils.obsfleet import validate_obs_fleet

            validate_obs_fleet(of)
        # the serving knobs fail at load too (serving/knobs.py, the
        # registry the predictor's knob mapping reads)
        from .serving.knobs import validate_serve_args

        validate_serve_args(self.serve_args.extra)
        # the partitioning knobs (parallel/partition.py): the rule-table
        # name must be in the registry and the unmatched policy a known
        # one, so a typo fails at load, not mid-init
        pr = self.device_args.extra.get("partition_rules")
        if pr is not None:
            from .parallel.partition import TABLES

            if pr not in TABLES:
                raise ValueError(
                    f"device_args.partition_rules must be one of "
                    f"{sorted(TABLES)}; got {pr!r}")
        um = self.device_args.extra.get("unmatched_params")
        if um is not None and um not in ("error", "replicated"):
            raise ValueError(
                "device_args.unmatched_params must be 'error' or "
                f"'replicated'; got {um!r}")
        # the wire codec's knobs (comm/codec.py CODEC_KNOBS): unknown keys,
        # bad kinds and knobs gated on an unselected codec fail at load
        cc = self.comm_args.extra.get("comm_codec")
        if cc is not None:
            from .comm.codec import validate_comm_codec

            validate_comm_codec(cc)
            # the pre-mask sparsifier lives in the SecAgg client; without
            # SecAgg the knob would be silently ignored
            if cc.get("secagg_premask_ratio") is not None \
                    and not t.extra.get("secagg"):
                raise ValueError(
                    "comm_codec.secagg_premask_ratio requires "
                    "train_args.secagg — the pre-mask sparsifier lives in "
                    "the secagg client; without it the knob would be "
                    "silently ignored")
        # the SecAgg client has no noise stage: DP with SecAgg would upload
        # un-noised masked updates while the operator believes DP is on
        if self.common_args.training_type == TRAINING_TYPE_CROSS_SILO \
                and t.extra.get("secagg") and self.dp_args.enable_dp:
            raise ValueError(
                "dp_args.enable_dp cannot be combined with "
                "train_args.secagg: the secagg client has no client-side "
                "noise stage yet, so DP would be silently dropped — "
                "disable one (noise-before-mask is the composition a "
                "future PR can add behind this same check)")
        if t.extra.get("resume") and not t.extra.get("checkpoint_dir"):
            raise ValueError(
                "train_args.resume requires checkpoint_dir — resume loads "
                "the latest checkpoint under it; without one the knob "
                "would be silently ignored")
        if self.common_args.training_type not in (
            TRAINING_TYPE_SIMULATION,
            TRAINING_TYPE_CROSS_SILO,
            TRAINING_TYPE_CROSS_DEVICE,
            TRAINING_TYPE_CROSS_CLOUD,
            TRAINING_TYPE_CENTRALIZED,
        ):
            raise ValueError(
                f"unknown training_type {self.common_args.training_type!r}")


# flat override key -> owning section; train_args last so its field names
# win any collision (the JAX module's order)
_FLAT_KEY_SECTION: dict = {}
for _section in ("dp_args", "security_args", "tracking_args", "comm_args",
                 "device_args", "validation_args", "model_args", "data_args",
                 "common_args", "train_args"):
    for _f in dataclasses.fields(Config.SECTION_TYPES[_section]):
        if _f.name != "extra":
            _FLAT_KEY_SECTION[_f.name] = _section


def read_config_file(path: str | Path) -> dict:
    """A config file's dict: `json` parses a file that is valid JSON (the
    dict `yaml.safe_load` gives for it), and only other files import
    PyYAML, which the card's machine may not have."""
    with open(Path(path).expanduser()) as f:
        text = f.read()
    try:
        d = json.loads(text)
    except json.JSONDecodeError:
        import yaml

        d = yaml.safe_load(text)
    return d or {}


def load_config(path: str | Path) -> Config:
    return Config.from_yaml(path)
