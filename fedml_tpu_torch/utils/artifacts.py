"""Model artifact stores: per-round aggregated and client models (port of
`fedml_tpu/utils/artifacts.py`).

The reference uploads the aggregated model every round and client models
on a cadence (core/mlops/__init__.py:388 `log_aggregated_model_info`, :475
`log_client_model_info`), and its serving path loads them back by round.
The same verbs (`mlops.log_aggregated_model_info` /
`log_client_model_info`) write the wire codec's pickle-free frames
(`comm/serialization.py`, byte-equal to the JAX package's for the same
tree) to one of two stores:

- `FileArtifactStore`: a directory tree, for one host or a simulation;
- `BrokerArtifactStore`: the broker's content-addressed blob plane
  (`comm/broker.py`), its name index kept as retained frames, so a
  process that attaches after the publish (a serving replica) still
  fetches round N.

The two packages read each other's stores. `get` returns numpy leaves (a
bf16 leaf as a CPU torch.bfloat16 tensor).
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import threading
import time
from pathlib import Path
from typing import Any, Optional

from ..comm.serialization import decode, encode

Pytree = Any

_NAME_RE = re.compile(r"^[A-Za-z0-9._/-]+$")


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name) or ".." in name or name.startswith("/"):
        raise ValueError(
            f"artifact name {name!r} must be a relative slash-path of "
            "[A-Za-z0-9._-] segments")
    return name


def aggregated_name(round_idx: int) -> str:
    return f"aggregated/round_{int(round_idx):06d}"


def client_name(round_idx: int, client_rank: int) -> str:
    return f"client_{int(client_rank)}/round_{int(round_idx):06d}"


def adapter_name(round_idx: int) -> str:
    """Round-N LoRA adapters: what a replica's POST /swap fetches."""
    return f"adapters/round_{int(round_idx):06d}"


def store_spec(store) -> dict:
    """A store's handle (not its contents) as JSON: a /swap request names
    the store and the artifact, and the replica fetches the tensors
    itself."""
    if isinstance(store, FileArtifactStore):
        return {"kind": "file", "root": str(store.root)}
    if isinstance(store, BrokerArtifactStore):
        return {"kind": "broker", "broker_id": store.broker_id,
                "run_id": store.run_id}
    raise TypeError(f"not an artifact store: {type(store).__name__}")


def store_from_spec(spec: dict):
    """The store a `store_spec` names. A file store needs a shared
    filesystem; a broker store meets its peers on the broker id."""
    kind = spec.get("kind")
    if kind == "file":
        return FileArtifactStore(spec["root"])
    if kind == "broker":
        return BrokerArtifactStore(spec.get("broker_id", "default"),
                                   spec.get("run_id", "default"))
    raise ValueError(f"unknown artifact store kind {kind!r} "
                     "(expected 'file' or 'broker')")


class FileArtifactStore:
    """Directory-backed store: one codec blob an artifact name, and a meta
    sidecar written last.

    A publish writes the tensors first and the meta last, each through an
    fsync'd temp file and `os.replace`, so each file is atomically the old
    or the new version, and a crash leaves nothing new or a complete blob.
    The meta (the blob's byte count and blake2b digest) is the reader's
    barrier: `get` checks the blob against it and, in the window where
    new tensors have landed and the new meta has not, waits for the meta,
    so a reader racing a publish gets the complete new artifact, never a
    torn pair."""

    # how long `get` waits out a publisher between its two replaces
    _META_RACE_BUDGET_S = 2.0

    def __init__(self, root: str):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, name: str) -> Path:
        return self.root / (_check_name(name) + ".bin")

    def _meta_path(self, name: str) -> Path:
        return self.root / (_check_name(name) + ".meta")

    @staticmethod
    def _digest(blob: bytes) -> str:
        return hashlib.blake2b(blob, digest_size=16).hexdigest()

    @staticmethod
    def _write_atomic(path: Path, blob: bytes) -> None:
        """fsync'd temp-file + os.replace: `path` is atomically either
        absent/old or the complete new content, even across a crash."""
        tmp = path.with_name(path.name + ".tmp")
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def put(self, name: str, tree: Pytree) -> str:
        p = self._path(name)
        p.parent.mkdir(parents=True, exist_ok=True)
        blob = encode(tree)
        self._write_atomic(p, blob)                      # tensors FIRST
        self._write_atomic(self._meta_path(name), json.dumps(
            {"bytes": len(blob),
             "digest": self._digest(blob)}).encode())    # meta LAST
        return str(p)

    def get(self, name: str) -> Pytree:
        p = self._path(name)
        mp = self._meta_path(name)
        deadline = time.monotonic() + self._META_RACE_BUDGET_S
        while True:
            if not p.exists():
                raise KeyError(f"no artifact {name!r} under {self.root}")
            blob = p.read_bytes()
            try:
                meta = json.loads(mp.read_bytes())
            except (OSError, json.JSONDecodeError):
                # a store written without metas: the blob is complete
                # (os.replace is atomic), so serve it as it is
                return decode(blob)
            if (meta.get("bytes") == len(blob)
                    and meta.get("digest") == self._digest(blob)):
                return decode(blob)
            # tensors and meta disagree: a publish is between its two
            # replaces; wait for its meta
            if time.monotonic() >= deadline:
                raise ValueError(
                    f"artifact {name!r} tensors do not match their meta "
                    f"after {self._META_RACE_BUDGET_S}s — torn publish "
                    "(publisher died between tensor and meta replace?)")
            time.sleep(0.005)

    def list(self) -> list[str]:
        return sorted(
            str(f.relative_to(self.root))[: -len(".bin")]
            for f in self.root.rglob("*.bin"))

    def delete(self, name: str) -> None:
        self._path(name).unlink(missing_ok=True)
        self._meta_path(name).unlink(missing_ok=True)


class BrokerArtifactStore:
    """Broker-backed store: blobs on the content-addressed plane, the
    name -> key index as retained frames. Publisher and fetcher build
    their stores independently and meet on the broker id.

    `keep_rounds` bounds the history: publishing round N drops rounds
    <= N - keep_rounds of the same prefix and releases their blobs, so a
    long run does not pin every round's model in the broker.
    """

    _INDEX_TOPIC = "artifacts/_names"

    # the name index's read-modify-write lock is per (broker_id, run_id),
    # not per instance: two publishers in one process with separate
    # instances would otherwise interleave and lose index entries
    _locks: dict = {}
    _locks_guard = threading.Lock()

    def __init__(self, broker_id: str = "default", run_id: str = "default",
                 keep_rounds: Optional[int] = None):
        from ..comm.broker import get_cas_broker

        self.broker = get_cas_broker(broker_id)
        self.broker_id = broker_id
        self.run_id = run_id
        self.keep_rounds = keep_rounds
        with BrokerArtifactStore._locks_guard:
            self._lock = BrokerArtifactStore._locks.setdefault(
                (broker_id, run_id), threading.Lock())

    def _topic(self, name: str) -> str:
        return f"{self.run_id}/artifacts/{name}"

    def _names(self) -> set[str]:
        raw = self.broker.retained(f"{self.run_id}/{self._INDEX_TOPIC}")
        return set(decode(raw)["names"]) if raw is not None else set()

    def _write_names(self, names: set[str]) -> None:
        self.broker.retain(f"{self.run_id}/{self._INDEX_TOPIC}",
                           encode({"names": sorted(names)}))

    def put(self, name: str, tree: Pytree) -> str:
        _check_name(name)
        key = self.broker.put_blob(encode(tree))
        with self._lock:
            old = self.broker.retained(self._topic(name))
            self.broker.retain(self._topic(name), key.encode())
            if old is not None:
                # release the replaced artifact's ref, also when the new
                # content hashes the same (put_blob's dedup hit took a ref)
                try:
                    self.broker.get_blob(old.decode(), delete=True)
                except KeyError:
                    pass
            self._write_names(self._names() | {name})
        if self.keep_rounds is not None:
            self._prune(name)
        return key

    def get(self, name: str) -> Pytree:
        raw = self.broker.retained(self._topic(_check_name(name)))
        if raw is None:
            raise KeyError(f"no artifact {name!r} on broker run "
                           f"{self.run_id!r}")
        return decode(self.broker.get_blob(raw.decode(), delete=False))

    def list(self) -> list[str]:
        return sorted(self._names())

    def delete(self, name: str) -> None:
        with self._lock:
            raw = self.broker.retained(self._topic(name))
            if raw is None:
                return
            self.broker.unretain(self._topic(name))
            try:
                self.broker.get_blob(raw.decode(), delete=True)
            except KeyError:
                pass
            self._write_names(self._names() - {name})

    def _prune(self, just_put: str) -> None:
        m = re.match(r"^(.*/)round_(\d+)$", just_put)
        if not m:
            return
        prefix, n = m.group(1), int(m.group(2))
        cutoff = n - self.keep_rounds
        for name in self.list():
            pm = re.match(r"^(.*/)round_(\d+)$", name)
            if pm and pm.group(1) == prefix and int(pm.group(2)) <= cutoff:
                self.delete(name)
