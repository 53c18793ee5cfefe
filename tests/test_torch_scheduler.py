"""The port's scheduler tier and platform API (`fedml_tpu_torch/scheduler/`,
`api.py`, the CLI's `launch`) held against the JAX package's, on the CPU.

- `ResourceMatcher.match` is bitwise JAX's over random worker tables, and
  the job store's sqlite blobs are byte-equal to the JAX store's for the
  same specs and results (both ride the wire codec).
- The JAX scheduler tests (`tests/test_scheduler.py`,
  `tests/test_scheduler_durability.py`, `tests/test_api.py`) on the port:
  simulation and python jobs, failure reporting, the unmatchable grace,
  master restarts that requeue from the store, deploy -> gateway ->
  failover -> reap_and_heal, the autoscaler, the registry and the
  cluster lifecycle; `launch` runs python and simulation jobs.
- Entry points default to CUDA: `api.cluster_start`, `launch` and a
  WorkerAgent's serve runner raise without a GPU unless given "cpu".
"""
import json
import os
import sqlite3
import subprocess
import sys
import threading
import time
import urllib.request
import uuid

import numpy as np
import pytest
import torch

import fedml_tpu.api as jax_api
from fedml_tpu.scheduler import ResourceMatcher as JaxMatcher
from fedml_tpu.scheduler.store import JobStore as JaxJobStore
import fedml_tpu_torch.api as api
from fedml_tpu_torch.__main__ import main
from fedml_tpu_torch.comm import FedCommManager
from fedml_tpu_torch.comm.loopback import LoopbackTransport, release_router
from fedml_tpu_torch.scheduler import (
    STATUS_FAILED, STATUS_FINISHED, STATUS_UNMATCHABLE, MasterAgent,
    ResourceMatcher, WorkerAgent,
)
from fedml_tpu_torch.scheduler.store import JobStore
from fedml_tpu_torch.utils import metrics as mx

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIM_CONFIG = {
    "data_args": {"dataset": "synthetic",
                  "extra": {"synthetic_samples_per_client": 16}},
    "model_args": {"model": "lr"},
    "train_args": {"federated_optimizer": "FedAvg",
                   "client_num_in_total": 2, "client_num_per_round": 2,
                   "comm_round": 1, "epochs": 1, "batch_size": 8,
                   "learning_rate": 0.3},
    "validation_args": {"frequency_of_the_test": 0},
}
RES = {"devices": 1, "mem_mb": 64, "tags": []}


@pytest.fixture(autouse=True)
def _fresh_registry(monkeypatch):
    monkeypatch.setattr(mx, "registry", mx.MetricsRegistry())


def _post(url, payload, timeout=30.0):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def python_job_add(args):
    """A python job `launch` imports by its "module:function" entry (a
    worker that gets the same entry on the wire refuses it)."""
    return {"sum": args["a"] + args["b"]}


# -------------------------------------------------------------- bitwise
def test_matcher_bitwise_jax_over_random_tables():
    rs = np.random.RandomState(0)
    tags = ["gpu", "cpu", "serve", "big"]
    for _ in range(300):
        workers = {int(w): {"devices": int(rs.randint(0, 9)),
                            "mem_mb": int(rs.randint(0, 4096)),
                            "tags": list(rs.choice(tags, rs.randint(0, 3),
                                                   replace=False))}
                   for w in rs.choice(20, rs.randint(1, 6), replace=False)}
        busy = {w for w in workers if rs.rand() < 0.3}
        req = {}
        if rs.rand() < 0.6:
            req["min_devices"] = int(rs.randint(0, 9))
        if rs.rand() < 0.4:
            req["min_mem_mb"] = int(rs.randint(0, 4096))
        if rs.rand() < 0.4:
            req["tags"] = list(rs.choice(tags, rs.randint(1, 3),
                                         replace=False))
        if rs.rand() < 0.2:
            req["worker_id"] = int(rs.choice(list(workers)))
        job = {"requirements": req}
        assert ResourceMatcher.match(job, workers, busy) == \
            JaxMatcher.match(job, workers, busy)
        assert ResourceMatcher.matchable(job, workers) == \
            JaxMatcher.matchable(job, workers)


def _rows(db):
    con = sqlite3.connect(db)
    try:
        return (con.execute("SELECT job_id, spec, status, worker, result "
                            "FROM jobs ORDER BY job_id").fetchall(),
                con.execute("SELECT worker_id, resources FROM workers "
                            "ORDER BY worker_id").fetchall())
    finally:
        con.close()


def test_job_store_blobs_byte_equal_jax(tmp_path):
    """The same transitions through both stores leave the same bytes in
    every spec, result and resources blob."""
    spec = {"type": "python", "entry": "f", "args": {"x": 1, "v": [1.5, 2]},
            "requirements": {"tags": ["gpu"], "min_devices": 1}}
    result = {"acc": 0.9, "w": np.arange(12, dtype=np.float32).reshape(3, 4),
              "ids": np.array([3, 1, 2], np.int64), "name": "done"}
    for cls, name in ((JobStore, "port.db"), (JaxJobStore, "jax.db")):
        s = cls(str(tmp_path / name))
        s.upsert_job("j1", spec, "QUEUED")
        s.upsert_job("j2", {"type": "serve", "params": {
            "k": np.ones((2, 2), np.float32)}}, "QUEUED")
        s.set_status("j1", "FINISHED", worker=3, result=result)
        s.set_status("j2", "FAILED", worker=1, result="boom")
        s.record_worker(3, {"devices": 8, "tags": ["gpu"]})
        s.close()
    assert _rows(str(tmp_path / "port.db")) == _rows(str(tmp_path / "jax.db"))
    # and each package reads the other's file
    jobs = JobStore(str(tmp_path / "jax.db")).load_jobs()
    got = {j["job_id"]: j for j in jobs}
    np.testing.assert_array_equal(got["j1"]["result"]["w"], result["w"])
    assert got["j1"]["spec"] == spec and got["j2"]["result"] == "boom"


def test_probe_resources_names_the_backend_as_jax_does():
    res = WorkerAgent._probe_resources()
    assert res["tags"] == (["gpu"] if torch.cuda.is_available() else ["cpu"])
    assert res["devices"] >= 1 and res["mem_mb"] > 0


# ------------------------------------------------------------ the agents
def _launch(n_workers=2, resources=None, **master_kw):
    run_id = f"sched-{uuid.uuid4().hex[:6]}"
    master = MasterAgent(FedCommManager(LoopbackTransport(0, run_id), 0),
                         **master_kw)
    workers = []
    for wid in range(1, n_workers + 1):
        w = WorkerAgent(FedCommManager(LoopbackTransport(wid, run_id), wid),
                        wid, resources=(resources or {}).get(wid, RES),
                        device="cpu")
        workers.append(w)
    master.run()
    for w in workers:
        w.run()
        w.announce()
    return run_id, master, workers


def _stop(run_id, master, workers):
    master.stop()
    for w in workers:
        w.stop()
    release_router(run_id)


def test_simulation_jobs_run_on_two_workers():
    run_id, master, workers = _launch(2)
    try:
        spec = {"type": "simulation", "config": SIM_CONFIG}
        j1, j2 = master.submit(spec), master.submit(spec)
        a, b = master.wait(j1, timeout=300), master.wait(j2, timeout=300)
        assert a.status == STATUS_FINISHED, a.result
        assert b.status == STATUS_FINISHED, b.result
        assert np.isfinite(a.result["train_loss"])
        assert {a.worker, b.worker} == {1, 2}
    finally:
        _stop(run_id, master, workers)


def test_python_jobs_failure_reporting_and_unmatchable_grace():
    run_id, master, workers = _launch(
        1, resources={1: {"devices": 1, "mem_mb": 100, "tags": []}},
        unmatchable_grace=1.0)
    try:
        workers[0].register_python_job("add",
                                       lambda args: args["a"] + args["b"])
        ok = master.submit({"type": "python", "entry": "add",
                            "args": {"a": 2, "b": 3}})
        bad = master.submit({"type": "python", "entry": "nope"})
        by_path = master.submit({
            "type": "python", "entry": f"{__name__}:python_job_add",
            "args": {"a": 4, "b": 5}})
        assert master.wait(ok, timeout=60).result == 5
        j = master.wait(bad, timeout=60)
        assert j.status == STATUS_FAILED and "nope" in j.result
        # an entry that reaches a worker on the wire is never imported,
        # as in JAX: only a registered name runs
        j = master.wait(by_path, timeout=60)
        assert j.status == STATUS_FAILED and "python_job_add" in j.result
        time.sleep(0.2)
        jid = master.submit({"type": "python", "entry": "x",
                             "requirements": {"min_devices": 64}})
        assert master.status(jid) == "QUEUED"
        assert master.wait(jid, timeout=60).status == STATUS_UNMATCHABLE
    finally:
        _stop(run_id, master, workers)


def test_master_restart_requeues_queued_and_running_jobs(tmp_path):
    """A job QUEUED and a job RUNNING when the master dies are both
    requeued from the store by the next incarnation and finish there; a
    terminal state survives another restart."""
    db = str(tmp_path / "master.db")
    run1 = f"dur-{uuid.uuid4().hex[:6]}"
    m1 = MasterAgent(FedCommManager(LoopbackTransport(0, run1), 0),
                     store_path=db, unmatchable_grace=30)
    w1 = WorkerAgent(FedCommManager(LoopbackTransport(1, run1), 1), 1,
                     resources=RES, device="cpu")
    hang = threading.Event()
    w1.register_python_job("slow", lambda args: hang.wait(60))
    m1.run()
    w1.run()
    w1.announce()
    running = m1.submit({"type": "python", "entry": "slow",
                         "requirements": {}})
    deadline = time.monotonic() + 10
    while m1.status(running) != "RUNNING" and time.monotonic() < deadline:
        time.sleep(0.02)
    assert m1.status(running) == "RUNNING"
    queued = m1.submit({"type": "python", "entry": "noop",
                        "requirements": {}})
    time.sleep(0.2)
    assert m1.status(queued) == "QUEUED"       # the one worker is busy
    m1.stop()
    w1.stop()
    release_router(run1)
    hang.set()

    run2 = f"dur-{uuid.uuid4().hex[:6]}"
    m2 = MasterAgent(FedCommManager(LoopbackTransport(0, run2), 0),
                     store_path=db, unmatchable_grace=30)
    assert m2.status(running) == "QUEUED" and m2.status(queued) == "QUEUED"
    w2 = WorkerAgent(FedCommManager(LoopbackTransport(1, run2), 1), 1,
                     resources=RES, device="cpu")
    w2.register_python_job("slow", lambda args: {"done": True})
    w2.register_python_job("noop", lambda args: {"ok": True})
    m2.run()
    w2.run()
    w2.announce()
    assert m2.wait(running, timeout=30).result == {"done": True}
    assert m2.wait(queued, timeout=30).result == {"ok": True}
    m2.stop()
    w2.stop()
    release_router(run2)
    m3 = MasterAgent(FedCommManager(LoopbackTransport(0, "dur-x"), 0),
                     store_path=db)
    try:
        assert m3.status(running) == STATUS_FINISHED
        assert m3.wait(queued, timeout=1).result == {"ok": True}
    finally:
        m3.stop()
        release_router("dur-x")


# --------------------------------------------------------- serving tier
def _serving_cluster(n_workers=2):
    from fedml_tpu_torch.serving.scheduler import Deployment

    run_id, master, workers = _launch(
        n_workers, resources={w: {"devices": 1, "mem_mb": 64,
                                  "tags": ["serve"]}
                              for w in range(1, n_workers + 1)})
    rng = np.random.RandomState(0)
    # a flax tree, as the JAX test deploys it: start_replica carries it
    # across (`hub.params_from_flax`) and sizes lr from its kernel
    params = {"Dense_0": {"kernel": rng.randn(4, 3).astype(np.float32),
                          "bias": np.zeros(3, np.float32)}}
    spec = {"model": "lr", "num_classes": 3, "params": params,
            "requirements": {"tags": ["serve"]}}
    dep = Deployment(master, spec, min_replicas=2, max_replicas=3,
                     probation_deadline_s=1.5, probe_backoff_s=0.05)
    return run_id, master, workers, dep


def test_deploy_gateway_failover_then_heal():
    """deploy -> gateway /predict -> kill a worker's replica -> traffic
    re-routes to the survivor with no non-2xx -> probation declares the
    victim DEAD -> reap_and_heal brings a replacement to READY."""
    from fedml_tpu_torch.serving.scheduler import InferenceGateway

    run_id, master, workers, dep = _serving_cluster(3)
    try:
        assert dep.deploy(2, timeout=60).ready_replicas()
        gw = InferenceGateway(dep, scale_interval=30).start()
        url = f"http://127.0.0.1:{gw.port}"
        x = [[0.1, 0.2, 0.3, 0.4]]
        want = _post(url + "/predict", {"inputs": x})
        assert "predictions" in want, want
        victim = None
        for w in workers:
            if w.active_servers:
                rid, runner = next(iter(w.active_servers.items()))
                runner.stop()
                victim = rid
                break
        assert victim is not None
        for _ in range(4):
            assert _post(url + "/predict", {"inputs": x}) == want
        deadline = time.monotonic() + 10
        while not any(r.state == "DEAD" and r.replica_id == victim
                      for r in dep.replicas):
            assert time.monotonic() < deadline, "probation never gave up"
            time.sleep(0.05)
        # probation's death heals down to min_replicas: a third replica
        deadline = time.monotonic() + 30
        while len(dep.ready_replicas()) < 2:
            assert time.monotonic() < deadline, "no replacement came up"
            time.sleep(0.05)
        assert victim not in {r.replica_id for r in dep.ready_replicas()}
        assert _post(url + "/predict", {"inputs": x}) == want
        gw.stop()
    finally:
        _stop(run_id, master, workers)


def test_autoscaler_scales_up_under_load():
    from fedml_tpu_torch.serving.scheduler import InferenceGateway

    run_id, master, workers, dep = _serving_cluster(3)
    try:
        dep.min_replicas, dep.max_replicas = 1, 3
        assert dep.deploy(1, timeout=60).ready_replicas()
        gw = InferenceGateway(dep, high_water=0.5, low_water=-1.0,
                              scale_interval=0.1).start()
        url = f"http://127.0.0.1:{gw.port}/predict"
        stop = threading.Event()

        def load():
            for _ in range(50):
                if stop.is_set():
                    return
                try:
                    _post(url, {"inputs": [[0.0] * 4]})
                except OSError:     # urllib's errors: load, not a check
                    pass

        threads = [threading.Thread(target=load, daemon=True)
                   for _ in range(4)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            if len(dep.ready_replicas()) >= 2:
                break
            time.sleep(0.1)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        assert len(dep.ready_replicas()) >= 2, "autoscaler never scaled up"
        gw.stop()
    finally:
        _stop(run_id, master, workers)


# ------------------------------------------------------------ platform
@pytest.fixture()
def registry(tmp_path, monkeypatch):
    for mod in (api, jax_api):
        monkeypatch.setattr(mod, "_REGISTRY", str(tmp_path / mod.__name__))
        monkeypatch.setattr(mod, "_PROFILE",
                            str(tmp_path / f"{mod.__name__}.json"))
    return tmp_path


def test_cluster_and_job_lifecycle(registry):
    cluster = api.cluster_start(n_workers=2, resources=RES, device="cpu")
    try:
        assert len(api.cluster_status(cluster)["workers"]) == 2
        jid = api.launch_job({"type": "simulation", "requirements": {},
                              "config": SIM_CONFIG}, cluster=cluster)
        assert cluster.master.wait(jid, timeout=300).status == "FINISHED"
        assert api.run_status(jid, cluster) == "FINISHED"
        assert any(r["job_id"] == jid for r in api.run_list(cluster))
    finally:
        assert api.cluster_stop(cluster)
    cluster = api.cluster_start(n_workers=0, device="cpu")
    try:
        jid = api.launch_job({"type": "python", "entry": "x",
                              "requirements": {}}, cluster=cluster)
        assert api.run_stop(jid, cluster)
        assert api.run_status(jid, cluster) == "STOPPED"
    finally:
        cluster.stop()


def test_model_registry_layout_and_deploy(registry):
    """The registry keeps JAX's layout: for the same flax tree the spec
    keys and the npz arrays equal the JAX registry's; the port's own flat
    names round-trip as they are; a deployed replica answers /predict
    like a TorchPredictor on the same parameters."""
    from fedml_tpu_torch.models import hub
    from fedml_tpu_torch.serving.predictor import TorchPredictor

    rng = np.random.RandomState(0)
    flax = {"Dense_0": {"kernel": rng.randn(4, 3).astype(np.float32),
                        "bias": np.zeros(3, np.float32)}}
    d = api.model_create("toy-lr", model="lr", params=flax, num_classes=3)
    dj = jax_api.model_create("toy-lr", model="lr", params=flax,
                              num_classes=3)
    assert sorted(os.listdir(d)) == sorted(os.listdir(dj))
    spec, spec_j = (json.load(open(os.path.join(x, "spec.json")))
                    for x in (d, dj))
    spec.pop("created")
    spec_j.pop("created")
    assert spec == spec_j
    z, zj = (np.load(os.path.join(x, "params.npz")) for x in (d, dj))
    assert sorted(z.files) == sorted(zj.files)
    assert all(np.array_equal(z[k], zj[k]) for k in z.files)
    assert "toy-lr" in api.model_list()
    # the port's flat names, with the input shape for the replica
    port = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
            hub.params_from_flax(flax, device="cpu").items()}
    api.model_create("flat-lr", model="lr", params=port, num_classes=3,
                     input_shape=(4,))
    got = api._load_registered("flat-lr")["params"]
    assert sorted(got) == ["Dense_0.bias", "Dense_0.kernel"]
    cluster = api.cluster_start(n_workers=1, resources=RES, device="cpu")
    try:
        dep = api.model_deploy("flat-lr", cluster, n_replicas=1, timeout=60)
        reps = dep.ready_replicas()
        assert reps, "deploy produced no ready replica"
        x = rng.randn(5, 4).tolist()
        out = _post(reps[0].endpoint + "/predict", {"inputs": x})
        want = TorchPredictor(hub.apply_fn(hub.create("lr", 3, (4,),
                                                      device="meta")),
                              port, device="cpu").predict({"inputs": x})
        assert out == want
    finally:
        cluster.stop()
    assert api.model_delete("toy-lr") and api.model_delete("flat-lr")
    assert api.model_list() == []


def test_build_package_profile_and_diagnosis(registry, tmp_path):
    src = tmp_path / "job"
    src.mkdir()
    (src / "main.py").write_text("print('x')\n")
    pkg = api.fedml_build(str(src), entry_point="main.py",
                          dest_folder=str(tmp_path / "dist"))
    assert os.path.isfile(pkg)
    api.model_create("pkgme", model="lr")
    assert os.path.isfile(api.model_package(
        "pkgme", dest_folder=str(tmp_path / "dist")))
    prof = api.fedml_login("k-123")
    assert prof["mode"] == "local" and os.path.exists(api._PROFILE)
    assert set(prof) == set(jax_api.fedml_login("k-123"))
    assert api.logout() and not os.path.exists(api._PROFILE)
    rep = api.fedml_diagnosis(only=["wire_codec", "loopback_transport"],
                              device="cpu")
    assert rep["checks"]["loopback_transport"]["ok"]
    assert "chaos_smoke" not in rep["checks"]


# -------------------------------------------------------------- launch
def test_cli_launch_runs_python_and_simulation_jobs(tmp_path, capsys):
    job = tmp_path / "job.json"
    job.write_text(json.dumps({"type": "python",
                               "entry": f"{__name__}:python_job_add",
                               "args": {"a": 2, "b": 40}}))
    assert main(["launch", str(job), "--device", "cpu",
                 "--timeout", "60"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["status"] == "FINISHED" and out["result"] == {"sum": 42}
    job = tmp_path / "sim.json"
    job.write_text(json.dumps({"type": "simulation", "requirements": {},
                               "config": SIM_CONFIG}))
    db = str(tmp_path / "queue.db")
    assert main(["launch", str(job), "--store", db, "--device", "cpu",
                 "--timeout", "300"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["status"] == "FINISHED", out
    jobs = JobStore(db).load_jobs()
    assert jobs and jobs[0]["status"] == "FINISHED"
    # a failing job exits 1
    job = tmp_path / "bad.json"
    job.write_text(json.dumps({"type": "python", "entry": "nope"}))
    assert main(["launch", str(job), "--device", "cpu",
                 "--timeout", "60"]) == 1
    assert json.loads(capsys.readouterr().out)["status"] == "FAILED"


def test_launch_in_a_subprocess(tmp_path):
    """`python -m fedml_tpu_torch launch` on a YAML python job exits 0."""
    pytest.importorskip("yaml")
    job = tmp_path / "job.yaml"
    job.write_text("type: python\nentry: json:dumps\nargs: {a: 1}\n")
    out = subprocess.run(
        [sys.executable, "-m", "fedml_tpu_torch", "launch", str(job),
         "--device", "cpu", "--timeout", "60"], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["status"] == "FINISHED" and res["result"] == '{"a": 1}'


def test_entry_points_default_to_cuda(tmp_path):
    """cluster_start, launch and a worker's serve runner ask for CUDA
    unless told "cpu" (a serve job then FAILs with the reason)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the CUDA default does not raise")
    with pytest.raises(RuntimeError, match="CUDA"):
        api.cluster_start(1)
    job = tmp_path / "job.json"
    job.write_text(json.dumps({"type": "python", "entry": "json:dumps"}))
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["launch", str(job)])
    run_id = f"cuda-{uuid.uuid4().hex[:6]}"
    master = MasterAgent(FedCommManager(LoopbackTransport(0, run_id), 0))
    w = WorkerAgent(FedCommManager(LoopbackTransport(1, run_id), 1), 1,
                    resources=RES)
    master.run()
    w.run()
    w.announce()
    try:
        jid = master.submit({"type": "serve", "model": "lr",
                             "num_classes": 3, "input_shape": [4],
                             "params": {
                                 "Dense_0.kernel": np.zeros((4, 3),
                                                            np.float32),
                                 "Dense_0.bias": np.zeros(3, np.float32)}})
        j = master.wait(jid, timeout=30)
        assert j.status == STATUS_FAILED and "CUDA" in j.result
    finally:
        _stop(run_id, master, [w])
