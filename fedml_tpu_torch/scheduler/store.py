"""Durable agent state — sqlite-backed job + worker persistence (port of
`fedml_tpu/scheduler/store.py`; the blobs are the port's wire codec,
byte-equal to the JAX package's for the same numpy trees).

(reference: computing/scheduler/master/server_data_interface.py — the master
agent keeps jobs/status/run-history in sqlite so daemons survive restarts;
slave/client_data_interface.py is the worker-side twin. Here one small WAL
store covers both roles: the MasterAgent writes every job transition through
it and replays unfinished jobs on restart; workers re-register idempotently
on reconnect, which repopulates the live resource registry.)

Results are persisted with the framework's own tensor-native wire codec
(comm/serialization.py) — job results may contain ndarrays, which sqlite
can't store as JSON and pickle is banned by design.
"""
from __future__ import annotations

import sqlite3
import threading
import time
from typing import Any, Optional

from ..comm.serialization import decode, encode

_SCHEMA = """
CREATE TABLE IF NOT EXISTS jobs (
    job_id    TEXT PRIMARY KEY,
    spec      BLOB NOT NULL,
    status    TEXT NOT NULL,
    worker    INTEGER,
    result    BLOB,
    submitted REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS workers (
    worker_id INTEGER PRIMARY KEY,
    resources BLOB NOT NULL,
    last_seen REAL NOT NULL
);
"""


class JobStore:
    """One sqlite file per agent; safe for the comm layer's handler threads
    (a single serialized connection; WAL keeps readers non-blocking)."""

    def __init__(self, path: str):
        self.path = path
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        with self._lock:
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.executescript(_SCHEMA)
            self._conn.commit()

    # ------------------------------------------------------------- jobs
    def upsert_job(self, job_id: str, spec: dict, status: str,
                   worker: Optional[int] = None, result: Any = None) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT INTO jobs (job_id, spec, status, worker, result, "
                "submitted) VALUES (?, ?, ?, ?, ?, ?) "
                "ON CONFLICT(job_id) DO UPDATE SET status=excluded.status, "
                "worker=excluded.worker, result=excluded.result",
                (job_id, encode(spec), status, worker,
                 encode(result) if result is not None else None,
                 time.time()))
            self._conn.commit()

    def set_status(self, job_id: str, status: str,
                   worker: Optional[int] = None, result: Any = None) -> None:
        with self._lock:
            self._conn.execute(
                "UPDATE jobs SET status=?, worker=?, result=? WHERE job_id=?",
                (status, worker,
                 encode(result) if result is not None else None, job_id))
            self._conn.commit()

    def load_jobs(self) -> list[dict]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT job_id, spec, status, worker, result, submitted "
                "FROM jobs ORDER BY submitted").fetchall()
        return [{
            "job_id": r[0],
            "spec": decode(r[1]),
            "status": r[2],
            "worker": r[3],
            "result": decode(r[4]) if r[4] is not None else None,
            "submitted": r[5],
        } for r in rows]

    # ---------------------------------------------------------- workers
    def record_worker(self, worker_id: int, resources: dict) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT INTO workers (worker_id, resources, last_seen) "
                "VALUES (?, ?, ?) ON CONFLICT(worker_id) DO UPDATE SET "
                "resources=excluded.resources, last_seen=excluded.last_seen",
                (worker_id, encode(resources), time.time()))
            self._conn.commit()

    def load_workers(self) -> dict[int, dict]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT worker_id, resources FROM workers").fetchall()
        return {r[0]: decode(r[1]) for r in rows}

    def close(self) -> None:
        with self._lock:
            self._conn.close()
