"""Python API — the reference's `fedml.api` surface, local-first (port of
`fedml_tpu/api.py`).

(reference: python/fedml/api/__init__.py:26-242 — launch_job, run_* job
management, cluster_* lifecycle, fedml_build/train_build/federate_build
packaging, model_* registry + deploy, logs/diagnosis. Those call the FedML
SaaS; here every verb has a local-first implementation over the port's own
scheduler tier, model registry directory and serving scheduler — same
names, no cloud. SaaS-only verbs (login) keep a local profile file so
scripted flows that call them still run.)

    import fedml_tpu_torch.api as api
    cluster = api.cluster_start(n_workers=2)          # CUDA; device="cpu"
    job_id = api.launch_job({"type": "simulation", "config": {...}},
                            cluster=cluster)
    api.run_status(job_id, cluster=cluster)   # -> "FINISHED"
    api.model_create("mnist-lr", model="lr", params=trained_params,
                     input_shape=(784,))
    dep = api.model_deploy("mnist-lr", cluster=cluster, n_replicas=2)

The model registry keeps the JAX package's layout (`<name>/spec.json`,
`<name>/params.npz`) under its own root, `~/.fedml_tpu_torch/models`: the
npz keys are the port's parameter names ("Dense_0.kernel"), where the JAX
registry's are "/"-joined flax paths, so the two registries are not
shared. `model_create` also takes a flax tree (nested dicts), stored
under its "/"-joined paths; `model_deploy` serves either kind
(`serving/scheduler.py:start_replica`). A bf16 tensor is stored as
float32, as `numpy.savez` cannot hold bf16.
"""
from __future__ import annotations

import json
import os
import time
import uuid
from collections.abc import Mapping
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

_PROFILE = os.path.expanduser("~/.fedml_tpu_torch/profile.json")
_REGISTRY = os.path.expanduser("~/.fedml_tpu_torch/models")


# ------------------------------------------------------------------ cluster
@dataclass
class LocalCluster:
    """A process-local 'cluster': one MasterAgent + N WorkerAgents over the
    loopback transport (reference: cluster_start/cluster_status — SaaS
    clusters of bound edges; here the same lifecycle, in-process)."""

    master: Any
    workers: list = field(default_factory=list)
    run_id: str = ""

    def status(self) -> dict:
        return {
            "workers": {w.worker_id: w.resources for w in self.workers},
            "jobs": {jid: j.status for jid, j in self.master.jobs.items()},
        }

    def stop(self) -> None:
        self.master.stop()
        for w in self.workers:
            w.stop()
        from .comm.loopback import release_router

        release_router(self.run_id)


def cluster_start(n_workers: int = 1, resources: Optional[dict] = None,
                  store_path: Optional[str] = None,
                  device=None) -> LocalCluster:
    """reference: api cluster_start — bring up a master + workers. The
    workers run their simulation and serve jobs on `device` (CUDA unless
    the caller names "cpu"; without a GPU the default raises here)."""
    from ._device import resolve_device
    from .comm import FedCommManager
    from .comm.loopback import LoopbackTransport
    from .scheduler import MasterAgent, WorkerAgent

    dev = resolve_device(device)
    run_id = f"api-{uuid.uuid4().hex[:8]}"
    master = MasterAgent(FedCommManager(LoopbackTransport(0, run_id), 0),
                         store_path=store_path)
    master.run()
    cluster = LocalCluster(master, [], run_id)
    for wid in range(1, n_workers + 1):
        w = WorkerAgent(FedCommManager(LoopbackTransport(wid, run_id), wid),
                        wid, resources=(resources or {}).get(wid)
                        if isinstance(resources, dict) else resources,
                        device=dev)
        w.run()
        w.announce()
        cluster.workers.append(w)
    return cluster


def cluster_status(cluster: LocalCluster) -> dict:
    return cluster.status()


def cluster_stop(cluster: LocalCluster) -> bool:
    cluster.stop()
    return True


# ------------------------------------------------------------------- jobs
def launch_job(job: dict | str, cluster: Optional[LocalCluster] = None,
               wait: bool = False, timeout: float = 600.0, device=None):
    """reference: api launch_job(yaml) -> submits to the Launch platform.
    Here: submit a scheduler job spec (dict, or path to a YAML / JSON file)
    to a LocalCluster's master.

    Returns, by argument combination:
    - ``cluster`` given, ``wait=False`` -> the job id (str). The cluster
      stays yours.
    - ``cluster`` given, ``wait=True``  -> ``{"job_id", "status", "result"}``.
    - ``cluster=None``, ``wait=True``   -> same dict; a throwaway cluster is
      created on `device` and stopped internally.
    - ``cluster=None``, ``wait=False``  -> ``(job_id, cluster)``: the
      auto-created cluster is returned because the CALLER owns it — keep it
      to poll/wait and call ``cluster.stop()`` (or ``cluster_stop``) when
      done, or it leaks its worker threads."""
    if isinstance(job, str):
        from .config import read_config_file

        job = read_config_file(job)
    owns = cluster is None
    if owns:
        cluster = cluster_start(1, device=device)
    jid = cluster.master.submit(dict(job))
    if not wait:
        return jid if not owns else (jid, cluster)
    j = cluster.master.wait(jid, timeout=timeout)
    out = {"job_id": jid, "status": j.status, "result": j.result}
    if owns:
        cluster.stop()
    return out


def run_status(job_id: str, cluster: LocalCluster) -> str:
    """reference: api run_status — job lifecycle state."""
    return cluster.master.status(job_id)


def run_list(cluster: LocalCluster) -> list[dict]:
    return [{"job_id": jid, "status": j.status, "worker": j.worker}
            for jid, j in cluster.master.jobs.items()]


def run_stop(job_id: str, cluster: LocalCluster) -> bool:
    """Best-effort cancel: QUEUED jobs are removed; RUNNING jobs finish
    (workers execute on daemon threads — the reference's SaaS kill has no
    local analog without process isolation)."""
    m = cluster.master
    with m._lock:
        if job_id in m.queue:
            m.queue.remove(job_id)
            m.jobs[job_id].status = "STOPPED"
            m.jobs[job_id].done.set()
            m._persist(m.jobs[job_id])
            return True
    return False


def run_logs(log_dir: str = "./log", run: Optional[str] = None,
             tail: int = 50) -> list[str]:
    """reference: api run_logs — pull run logs; local: read the mlops
    facade's per-run files."""
    out = []
    if not os.path.isdir(log_dir):
        return out
    for name in sorted(os.listdir(log_dir)):
        if run and not name.startswith(run):
            continue
        p = os.path.join(log_dir, name)
        if os.path.isfile(p):
            with open(p) as f:
                out.extend(f"[{name}] {ln.rstrip()}"
                           for ln in f.readlines()[-tail:])
    return out


# ------------------------------------------------------------------ build
def fedml_build(source_folder: str, entry_point: Optional[str] = None,
                dest_folder: str = "./dist",
                name: Optional[str] = None) -> str:
    """reference: api fedml_build / train_build / federate_build — package
    a job directory; local: the CLI's tarball+manifest builder. Returns the
    package path."""
    from .__main__ import main as cli_main

    args = ["build", "--source", source_folder, "--dest", dest_folder]
    if entry_point:
        args += ["--entry", entry_point]
    if name:
        args += ["--name", name]
    rc = cli_main(args)
    if rc != 0:
        raise RuntimeError(f"build failed (rc={rc}) for {source_folder}")
    pkg = name or os.path.basename(os.path.abspath(source_folder).rstrip("/"))
    return os.path.join(dest_folder, f"{pkg}.tar.gz")


train_build = fedml_build
federate_build = fedml_build


# ----------------------------------------------------------- model registry
def _registry_dir(name: str) -> str:
    return os.path.join(_REGISTRY, name)


def _flat_arrays(params, prefix: str = "") -> dict:
    """{name: numpy array}: the port's flat names as they are, a nested
    (flax) tree under its "/"-joined paths; bf16 tensors widened to
    float32."""
    import torch

    out = {}
    for k, v in params.items():
        if isinstance(v, Mapping):
            out.update(_flat_arrays(v, f"{prefix}{k}/"))
        elif isinstance(v, torch.Tensor):
            t = v.detach().cpu()
            out[prefix + k] = (t.float() if t.dtype == torch.bfloat16
                               else t).numpy()
        else:
            out[prefix + k] = np.asarray(v)
    return out


def model_create(name: str, model: str, params: Any = None,
                 num_classes: int = 10, model_config: Optional[dict] = None,
                 input_shape: Optional[tuple] = None) -> str:
    """reference: api model_create — register a servable model. Local
    registry layout: ~/.fedml_tpu_torch/models/<name>/{spec.json,
    params.npz} (module docstring)."""
    d = _registry_dir(name)
    os.makedirs(d, exist_ok=True)
    spec = {"name": name, "model": model, "num_classes": int(num_classes),
            "model_args": dict(model_config or {}), "created": time.time(),
            "input_shape": list(input_shape) if input_shape else None}
    with open(os.path.join(d, "spec.json"), "w") as f:
        json.dump(spec, f, indent=2)
    if params is not None:
        np.savez(os.path.join(d, "params.npz"), **_flat_arrays(params))
    return d


def model_list(name: Optional[str] = None) -> list[str]:
    if not os.path.isdir(_REGISTRY):
        return []
    names = sorted(os.listdir(_REGISTRY))
    return [n for n in names if name is None or name in n]


def model_delete(name: str) -> bool:
    import shutil

    d = _registry_dir(name)
    if not os.path.isdir(d):
        return False
    shutil.rmtree(d)
    return True


def model_package(name: str, dest_folder: str = "./dist") -> str:
    """reference: api model_package — bundle a registered model for
    distribution (the local analog of model_push's artifact)."""
    d = _registry_dir(name)
    if not os.path.isdir(d):
        raise FileNotFoundError(f"no registered model {name!r}")
    return fedml_build(d, dest_folder=dest_folder, name=f"model-{name}")


def _load_registered(name: str) -> dict:
    d = _registry_dir(name)
    with open(os.path.join(d, "spec.json")) as f:
        spec = json.load(f)
    pf = os.path.join(d, "params.npz")
    if os.path.exists(pf):
        blob = np.load(pf)
        params: dict = {}
        for key in blob.files:
            node = params
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = blob[key]
        spec["params"] = params
    return spec


def _serve_extra(config) -> dict:
    """Config (or a bare serve_args.extra dict, or None) -> the validated
    fleet-knob dict scheduler.fleet_knobs translates."""
    if config is None:
        return {}
    sv = getattr(config, "serve_args", None)
    if sv is not None:
        return dict(getattr(sv, "extra", {}) or {})
    return dict(config)


def model_deploy(name: str, cluster: LocalCluster, n_replicas: int = 1,
                 timeout: float = 60.0, config=None):
    """reference: api model_deploy — deploy a registered model to workers;
    local: the serving scheduler's deploy FSM over the cluster's master.
    Returns the Deployment (attach a gateway via model_gateway for
    routing). `config` (a Config or a serve_args.extra dict) routes the
    validated fleet knobs — probation_deadline_s / probe_backoff_s —
    through scheduler.fleet_knobs into the Deployment; without this
    consumer the YAML knobs would validate at load and then silently
    drop. The replicas run on the workers' device."""
    from .serving.scheduler import Deployment, fleet_knobs

    spec = _load_registered(name)
    serve_spec = {"model": spec["model"],
                  "num_classes": spec["num_classes"],
                  "model_args": spec.get("model_args", {}),
                  "params": spec.get("params"),
                  "requirements": {}}
    if spec.get("input_shape"):
        serve_spec["input_shape"] = spec["input_shape"]
    dep_kw, _gw_kw = fleet_knobs(_serve_extra(config))
    dep = Deployment(cluster.master, serve_spec, min_replicas=n_replicas,
                     max_replicas=max(n_replicas, len(cluster.workers)),
                     **dep_kw)
    dep.deploy(n_replicas, timeout=timeout)
    return dep


def model_gateway(deployment, config=None, **kwargs):
    """Start an InferenceGateway over a Deployment with the config's
    fleet knobs — shed_watermark / retry_after_s / affinity_routing —
    applied (the gateway half of scheduler.fleet_knobs; model_deploy
    consumes the Deployment half). Explicit keyword arguments override
    the config. Returns the STARTED gateway; callers own gw.stop()."""
    from .serving.scheduler import InferenceGateway, fleet_knobs

    _dep_kw, gw_kw = fleet_knobs(_serve_extra(config))
    gw_kw.update(kwargs)
    return InferenceGateway(deployment, **gw_kw).start()


# ------------------------------------------------------ profile (no SaaS)
def fedml_login(api_key: Optional[str] = None) -> dict:
    """reference: api fedml_login — SaaS auth. No cloud exists here; the
    local analog records a profile so scripted flows that login first keep
    working, and is explicit about its scope."""
    os.makedirs(os.path.dirname(_PROFILE), exist_ok=True)
    profile = {"api_key": api_key, "mode": "local",
               "note": "fedml_tpu_torch is local-first; no SaaS account "
                       "exists",
               "logged_in_at": time.time()}
    with open(_PROFILE, "w") as f:
        json.dump(profile, f, indent=2)
    return profile


def logout() -> bool:
    if os.path.exists(_PROFILE):
        os.remove(_PROFILE)
        return True
    return False


def fedml_diagnosis(only=None, device=None) -> dict:
    """reference: api fedml_diagnosis — connectivity probes; local: the
    CLI's battery (`diagnosis.py`) on `device` (CUDA unless "cpu"),
    returned as a dict. `only` selects a probe subset by name (the CLI's
    `diagnosis --only` flag)."""
    import io
    from contextlib import redirect_stdout

    from . import diagnosis

    buf = io.StringIO()
    with redirect_stdout(buf):
        diagnosis.run_battery(list(only) if only else None, device)
    return json.loads(buf.getvalue())
