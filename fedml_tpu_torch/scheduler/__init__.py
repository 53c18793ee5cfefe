"""Scheduler agents — the "Launch" platform tier, local-first (port of
`fedml_tpu/scheduler/__init__.py`).

(reference: python/fedml/computing/scheduler/ — master agent
FedMLServerRunner (master/server_runner.py:66) accepts jobs over MQTT and
dispatches them; slave agents (slave/client_runner.py) register their
device resources and execute; SchedulerMatcher
(scheduler_core/scheduler_matcher.py:4,
match_and_assign_gpu_resources_to_devices :73) matches a job's resource
request to active edges. Here the same roles ride the port's own comm
layer, so `loopback` schedules on one box and `broker`/`grpc` schedule
across machines with zero agent changes.)

Roles:
- WorkerAgent: registers {devices, mem_mb, tags}; executes assigned job
  specs through a pluggable job-runner registry (built-in: "simulation" →
  fedml_tpu_torch.run_simulation(config), "python" → a registered
  callable, "serve" / "serve_stop" → an inference replica's lifecycle);
  reports RESULT/FAILED. `device` (CUDA unless "cpu") is where its
  simulation and serve jobs run; a serve spec's own "device" wins.
- MasterAgent: job queue + ResourceMatcher + dispatch + status tracking.
  submit() returns a job id; wait(job_id) blocks on completion.

The messages, the matcher, the job states and the store's blobs are the
JAX package's. A worker's resource tags name the backend as the JAX
package does (`["gpu"]` with a CUDA device, `["cpu"]` without), so a
job's `requirements.tags` mean the same to both. A worker runs a
"python" job only when its `entry` is a name registered with
`register_python_job`, as the JAX worker does; any other entry fails the
job. `python -m fedml_tpu_torch launch` runs a job file's
"package.module:function" entry by importing it and registering it on
the worker it starts itself.
"""
from __future__ import annotations

import logging
import threading
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ..comm import FedCommManager, Message

log = logging.getLogger(__name__)

W2M_REGISTER = "sched_register"
M2W_ASSIGN = "sched_assign"
W2M_RESULT = "sched_result"
KEY_RESOURCES = "resources"
KEY_JOB = "job"
KEY_JOB_ID = "job_id"
KEY_STATUS = "status"
KEY_RESULT = "result"

STATUS_QUEUED = "QUEUED"
STATUS_RUNNING = "RUNNING"
STATUS_FINISHED = "FINISHED"
STATUS_FAILED = "FAILED"
STATUS_UNMATCHABLE = "UNMATCHABLE"


class ResourceMatcher:
    """Match a job's resource request to a registered worker (reference:
    SchedulerMatcher.match_and_assign_gpu_resources_to_devices). Chooses
    the least-loaded worker that satisfies every requirement."""

    @staticmethod
    def match(job: dict, workers: dict[int, dict],
              busy: set[int]) -> Optional[int]:
        req = job.get("requirements", {})
        candidates = []
        for wid, res in workers.items():
            if wid in busy:
                continue
            # pin-to-worker: lifecycle jobs (e.g. serve_stop) must land on
            # the worker that owns the resource, not any capable one
            if req.get("worker_id") is not None and wid != req["worker_id"]:
                continue
            if res.get("devices", 0) < req.get("min_devices", 0):
                continue
            if res.get("mem_mb", 0) < req.get("min_mem_mb", 0):
                continue
            need_tags = set(req.get("tags", ()))
            if not need_tags <= set(res.get("tags", ())):
                continue
            candidates.append((res.get("devices", 0), wid))
        if not candidates:
            return None
        # smallest sufficient worker first: keep big ones free for big jobs
        return sorted(candidates)[0][1]

    @staticmethod
    def matchable(job: dict, workers: dict[int, dict]) -> bool:
        """Could ANY registered worker ever run this job (ignoring load)?"""
        return ResourceMatcher.match(job, workers, busy=set()) is not None


@dataclass
class _Job:
    job_id: str
    spec: dict
    status: str = STATUS_QUEUED
    worker: Optional[int] = None
    result: Any = None
    submitted: float = 0.0
    done: threading.Event = field(default_factory=threading.Event)


class MasterAgent:
    """(reference: master/server_runner.py) job queue + dispatch.

    unmatchable_grace: seconds a job may wait for a capable worker to
    register before being declared UNMATCHABLE — workers register
    asynchronously (broker/grpc ordering is nondeterministic), so an
    instant verdict would race late registrations."""

    def __init__(self, comm: FedCommManager, unmatchable_grace: float = 5.0,
                 store_path: Optional[str] = None):
        self.comm = comm
        self.unmatchable_grace = unmatchable_grace
        self.workers: dict[int, dict] = {}
        self.busy: set[int] = set()
        self.jobs: dict[str, _Job] = {}
        self.queue: list[str] = []
        self._lock = threading.Lock()
        # durable state (reference: master/server_data_interface.py sqlite):
        # every job transition is written through; restart replays the queue
        self.store = None
        if store_path is not None:
            from .store import JobStore

            self.store = JobStore(store_path)
            self._recover()
        h = comm.register_message_receive_handler
        h(W2M_REGISTER, self._on_register)
        h(W2M_RESULT, self._on_result)

    def _recover(self) -> None:
        """Replay persisted jobs after a restart: terminal jobs keep their
        results queryable; QUEUED and RUNNING jobs are re-queued (jobs are
        assumed idempotent — a worker that kept running through the master's
        death may double-execute, and the first terminal report wins).
        Workers must re-register to rejoin the live registry (their comm
        endpoints don't survive the restart); the persisted worker table is
        history for diagnosis, not live state."""
        import time

        for row in self.store.load_jobs():
            job = _Job(row["job_id"], row["spec"], status=row["status"],
                       worker=row["worker"], result=row["result"],
                       submitted=time.monotonic())
            self.jobs[job.job_id] = job
            if job.status in (STATUS_QUEUED, STATUS_RUNNING):
                job.status = STATUS_QUEUED
                job.worker = None
                self.queue.append(job.job_id)
                self.store.set_status(job.job_id, STATUS_QUEUED)
                t = threading.Timer(self.unmatchable_grace + 0.1,
                                    self._grace_check)
                t.daemon = True
                t.start()
            else:
                job.done.set()

    def _on_register(self, msg: Message) -> None:
        with self._lock:
            self.workers[msg.sender_id] = dict(msg.get(KEY_RESOURCES) or {})
            log.info("worker %s registered: %s", msg.sender_id,
                     self.workers[msg.sender_id])
            if self.store is not None:
                self.store.record_worker(msg.sender_id,
                                         self.workers[msg.sender_id])
            self._dispatch()

    def submit(self, spec: dict) -> str:
        """Queue a job spec: {"type": "simulation"|"python", ...,
        "requirements": {min_devices, min_mem_mb, tags}}. Returns job id."""
        import time

        job = _Job(uuid.uuid4().hex[:12], dict(spec),
                   submitted=time.monotonic())
        with self._lock:
            self.jobs[job.job_id] = job
            self.queue.append(job.job_id)
            if self.store is not None:
                self.store.upsert_job(job.job_id, job.spec, job.status)
            self._dispatch()
            # a lone unmatchable job has no future event to re-trigger
            # dispatch; arm a timer to deliver the verdict after the grace
            t = threading.Timer(self.unmatchable_grace + 0.1,
                                self._grace_check)
            t.daemon = True
            t.start()
        return job.job_id

    def _grace_check(self) -> None:
        with self._lock:
            self._dispatch()

    def _persist(self, job: "_Job") -> None:
        """Caller holds the lock. Best-effort write-through; a broken store
        must not take the live scheduler down with it."""
        if self.store is None:
            return
        try:
            self.store.set_status(job.job_id, job.status, job.worker,
                                  job.result)
        except Exception:
            log.exception("job store write failed for %s", job.job_id)

    def _dispatch(self) -> None:
        """Caller holds the lock. Assign queued jobs to free workers."""
        import time

        remaining = []
        for jid in self.queue:
            job = self.jobs[jid]
            wid = ResourceMatcher.match(job.spec, self.workers, self.busy)
            if wid is None:
                waited = time.monotonic() - job.submitted
                if (self.workers
                        and waited > self.unmatchable_grace
                        and not ResourceMatcher.matchable(
                            job.spec, self.workers)):
                    # past the registration grace AND nobody registered so
                    # far could ever run it
                    job.status = STATUS_UNMATCHABLE
                    self._persist(job)
                    job.done.set()
                    log.warning("job %s unmatchable by any registered "
                                "worker", jid)
                else:
                    remaining.append(jid)     # wait for a free/new worker
                continue
            m = Message(M2W_ASSIGN, 0, wid)
            m.add(KEY_JOB_ID, jid)
            m.add(KEY_JOB, job.spec)
            try:
                self.comm.send_message(m)
            except Exception as e:
                # an unserializable spec would fail on every retry — fail
                # the job; state stays consistent (never marked RUNNING)
                log.exception("dispatch of job %s failed", jid)
                job.status = STATUS_FAILED
                job.result = f"dispatch failed: {type(e).__name__}: {e}"
                self._persist(job)
                job.done.set()
                continue
            job.status = STATUS_RUNNING
            job.worker = wid
            self.busy.add(wid)
            self._persist(job)
        self.queue = remaining

    def _on_result(self, msg: Message) -> None:
        with self._lock:
            jid = msg.get(KEY_JOB_ID)
            job = self.jobs.get(jid)
            if job is None:
                return
            job.status = msg.get(KEY_STATUS, STATUS_FINISHED)
            job.result = msg.get(KEY_RESULT)
            self.busy.discard(msg.sender_id)
            self._persist(job)
            job.done.set()
            self._dispatch()

    def wait(self, job_id: str, timeout: Optional[float] = None) -> _Job:
        job = self.jobs[job_id]
        job.done.wait(timeout)
        return job

    def status(self, job_id: str) -> str:
        return self.jobs[job_id].status

    def run(self, background: bool = True) -> None:
        self.comm.run(background=background)

    def stop(self) -> None:
        self.comm.stop()
        if self.store is not None:
            self.store.close()


class WorkerAgent:
    """(reference: slave/client_runner.py) registers resources, executes
    assigned jobs on a worker thread, reports results."""

    def __init__(self, comm: FedCommManager, worker_id: int,
                 resources: Optional[dict] = None, master_id: int = 0,
                 device=None):
        self.comm = comm
        self.worker_id = worker_id
        self.master_id = master_id
        # where simulation and serve jobs run (None: CUDA, raising without
        # a GPU when a job needs it); resolved per job, not here, so an
        # agent that only runs python jobs needs no card
        self.device = device
        self.resources = resources or self._probe_resources()
        self.runners: dict[str, Callable[[dict], Any]] = {
            "simulation": self._run_simulation,
            "python": self._run_python,
            "serve": self._run_serve,
            "serve_stop": self._run_serve_stop,
        }
        self._py_registry: dict[str, Callable] = {}
        # replica_id -> FedMLInferenceRunner started by "serve" jobs
        # (reference: model_scheduler/device_model_deployment.py keeps the
        # per-device containers; here replicas are in-process HTTP servers)
        self.active_servers: dict[str, Any] = {}
        comm.register_message_receive_handler(M2W_ASSIGN, self._on_assign)

    @staticmethod
    def _probe_resources() -> dict:
        """{devices, mem_mb, tags}: the visible CUDA devices (the host
        counts as one device without them) and the backend's name as the
        JAX package writes it, "gpu" or "cpu"; the host's available memory
        from /proc/meminfo (the JAX agent reads psutil's)."""
        import torch

        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        res = {"devices": max(n, 1), "mem_mb": 1024,
               "tags": ["gpu" if n else "cpu"]}
        try:
            with open("/proc/meminfo") as f:
                for line in f:
                    if line.startswith("MemAvailable:"):
                        res["mem_mb"] = int(int(line.split()[1]) * 1024
                                            / 1e6)
                        break
        except OSError:
            pass
        return res

    def register_python_job(self, name: str, fn: Callable[[dict], Any]):
        self._py_registry[name] = fn

    def _run_simulation(self, spec: dict):
        import fedml_tpu_torch

        cfg = fedml_tpu_torch.init(config=spec["config"], device=self.device)
        hist = fedml_tpu_torch.run_simulation(cfg)
        return hist[-1]

    def _run_python(self, spec: dict):
        fn = self._py_registry.get(spec.get("entry", ""))
        if fn is None:
            raise ValueError(
                f"no registered python job {spec.get('entry')!r}")
        return fn(spec.get("args", {}))

    def _run_serve(self, spec: dict):
        """Start an inference replica on this worker; the job result is the
        replica's endpoint. The HTTP server keeps running after the job
        completes — deployment lifetime is managed by serve_stop (reference:
        model_scheduler/device_model_deployment.py start_deployment)."""
        from ..serving.scheduler import start_replica

        if self.device is not None and spec.get("device") is None:
            spec = {**spec, "device": str(self.device)}
        replica_id, runner = start_replica(spec)
        self.active_servers[replica_id] = runner
        return {"replica_id": replica_id, "host": "127.0.0.1",
                "port": runner.port, "worker_id": self.worker_id}

    def _run_serve_stop(self, spec: dict):
        rid = spec.get("replica_id", "")
        runner = self.active_servers.pop(rid, None)
        if runner is None:
            return {"stopped": False, "replica_id": rid}
        runner.stop()
        return {"stopped": True, "replica_id": rid}

    def _on_assign(self, msg: Message) -> None:
        jid = msg.get(KEY_JOB_ID)
        spec = msg.get(KEY_JOB)

        def work():
            out = Message(W2M_RESULT, self.worker_id, self.master_id)
            out.add(KEY_JOB_ID, jid)
            try:
                runner = self.runners.get(spec.get("type", ""))
                if runner is None:
                    raise ValueError(f"unknown job type {spec.get('type')!r}")
                result = runner(spec)
                out.add(KEY_STATUS, STATUS_FINISHED)
                out.add(KEY_RESULT, result)
            except Exception as e:  # report, never crash the agent
                log.exception("job %s failed", jid)
                out.add(KEY_STATUS, STATUS_FAILED)
                out.add(KEY_RESULT, f"{type(e).__name__}: {e}")
            try:
                self.comm.send_message(out)
            except Exception as e:
                # an unserializable RESULT must still free the worker on
                # the master — retry with the stringified payload
                log.warning("job %s result not wire-serializable (%s); "
                            "reporting as FAILED", jid, e)
                fb = Message(W2M_RESULT, self.worker_id, self.master_id)
                fb.add(KEY_JOB_ID, jid)
                fb.add(KEY_STATUS, STATUS_FAILED)
                fb.add(KEY_RESULT,
                       f"result not serializable: {type(e).__name__}: {e}")
                try:
                    self.comm.send_message(fb)
                except Exception:
                    log.exception("job %s: failure report also failed", jid)

        threading.Thread(target=work, daemon=True,
                         name=f"sched-job-{jid}").start()

    def announce(self) -> None:
        m = Message(W2M_REGISTER, self.worker_id, self.master_id)
        m.add(KEY_RESOURCES, self.resources)
        self.comm.send_message(m)

    def run(self, background: bool = True) -> None:
        self.comm.run(background=background)

    def stop(self) -> None:
        self.comm.stop()
