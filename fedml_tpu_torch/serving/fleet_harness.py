"""Shared 2-replica fleet harness (port of
`fedml_tpu/serving/fleet_harness.py`): the scaffolding the
`fleet_rolling_update_smoke` diagnosis probe drives — an engine-backed LM
deployment with v1 LoRA adapters live and a deliberately different v2
tree ready to publish, plus the closed-loop load helpers whose
599-on-connection-failure accounting the zero-dropped-request bars rely
on. Changing the /swap body shape or the dropped-request accounting is
ONE edit here. Not a production surface — fleets are built through
api.model_deploy / api.model_gateway."""
from __future__ import annotations

import json
import tempfile
import threading
import time
import urllib.error
import urllib.request


def post(url: str, payload: dict,
         timeout: float = 120.0) -> tuple[int, float]:
    """POST JSON -> (status, latency_s). A connection-level failure IS a
    dropped request: it returns 599 so it counts against a zero-non-2xx
    bar (and keeps the calling load thread alive) instead of vanishing
    with an exception."""
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            r.read()
            return r.status, time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        e.read()
        return e.code, time.perf_counter() - t0
    except (urllib.error.URLError, OSError):
        return 599, time.perf_counter() - t0


class FleetHarness:
    """N engine-backed LM replicas adopted into a Deployment, on `device`
    (CUDA unless the caller names "cpu"; the replicas share one copy of
    the weights). The weights are `llm.transformer.init_params(seed 0)`,
    the v1 adapters `llm.lora.lora_init` (A std 0.2) from a generator
    seeded 1 on the device, and v2 = v1 * -1.1 + 0.05. Gateways opened
    through gateway() are tracked and torn down with the replicas by
    close()."""

    def __init__(self, *, vocab_size: int = 64, d_model: int = 32,
                 n_layers: int = 1, n_heads: int = 2, d_ff: int = 64,
                 slots: int = 2, max_len: int = 32, lora_rank: int = 2,
                 prompt_len: int = 6, n_replicas: int = 2, device=None):
        import numpy as np
        import torch

        from .._device import resolve_device
        from ..llm.lora import lora_init
        from ..llm.transformer import ModelDims, TransformerLM, init_params
        from ..ops.tree import tree_map
        from .inference_runner import FedMLInferenceRunner
        from .predictor import GreedyLMPredictor
        from .scheduler import Deployment

        self.device = dev = resolve_device(device)
        dims = ModelDims(vocab_size, d_model, n_layers, n_heads, d_ff)
        self.model = TransformerLM.from_state(
            dims, init_params(dims, seed=0, device=dev))
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        self.adapters_v1 = lora_init(self.model.state_dict(), rank=lora_rank,
                                     a_std=0.2, generator=gen)
        # v2 = a deliberately different tree, so a completed swap is
        # observable in the decoded tokens, not just the version gauge
        self.adapters_v2 = tree_map(lambda a: a * -1.1 + 0.05,
                                    self.adapters_v1)
        self.prompt = np.random.RandomState(0).randint(
            1, vocab_size, prompt_len).tolist()
        self.runners = [FedMLInferenceRunner(
            GreedyLMPredictor(self.model, adapters=self.adapters_v1,
                              max_len=max_len, kv_cache=True,
                              decode_slots=slots, device=dev),
            port=0).start() for _ in range(n_replicas)]
        self.dep = Deployment.adopt(
            [f"http://127.0.0.1:{r.port}" for r in self.runners])
        self._gateways: list = []
        self._load_stops: list = []
        self._store_dir: str | None = None

    def gateway(self, **kw):
        from .scheduler import InferenceGateway

        gw = InferenceGateway(self.dep, scale_interval=30, **kw).start()
        self._gateways.append(gw)
        return gw

    def sustained_load(self, url: str, n_threads: int, payload: dict):
        """Closed-loop load until the returned stop() runs; the results
        list of (status, latency_s) grows live."""
        results: list = []
        stop = threading.Event()
        lock = threading.Lock()

        def hit():
            while not stop.is_set():
                res = post(url, dict(payload))
                with lock:
                    results.append(res)

        threads = [threading.Thread(target=hit, daemon=True)
                   for _ in range(n_threads)]
        for t in threads:
            t.start()

        def stop_load(timeout: float = 30.0):
            stop.set()
            for t in threads:
                t.join(timeout=timeout)

        self._load_stops.append(stop)
        return results, stop_load

    def burst(self, url: str, n_threads: int, payload: dict,
              duration_s: float) -> list:
        """n_threads clients in closed loop for duration_s ->
        [(status, latency_s), ...]."""
        results, stop_load = self.sustained_load(url, n_threads, payload)
        time.sleep(duration_s)
        stop_load()
        return results

    def publish_and_roll(self, version: int = 2,
                         timeout: float = 60.0) -> tuple[list, float]:
        """Publish the v2 adapter tree under `version` to a temp
        FileArtifactStore and drive Deployment.rolling_update ->
        (updated replica_ids, swap wall seconds)."""
        from ..utils.artifacts import FileArtifactStore, adapter_name

        # the store must OUTLIVE this call: the Deployment records it as
        # its adapter target, and a replica recovering from probation
        # AFTER the walk converges by re-driving /swap from that root —
        # a deleted tempdir would turn every probe into a 400 and
        # probation would declare the healthy replica DEAD
        if self._store_dir is None:
            self._store_dir = tempfile.mkdtemp(prefix="fleet-adapters-")
        store = FileArtifactStore(self._store_dir)
        store.put(adapter_name(version), self.adapters_v2)
        t0 = time.perf_counter()
        updated = self.dep.rolling_update(
            store, adapter_name(version), version=version,
            timeout=timeout)
        swap_s = time.perf_counter() - t0
        return updated, swap_s

    def close(self) -> None:
        # a caller that raised before its stop_load() must not leave
        # closed-loop threads spinning 599s against a dead gateway
        for stop in self._load_stops:
            stop.set()
        for gw in self._gateways:
            try:
                gw.stop()
            except Exception:  # noqa: BLE001 — teardown is best-effort
                pass
        for r in self.runners:
            r.stop()
        if self._store_dir is not None:
            import shutil

            shutil.rmtree(self._store_dir, ignore_errors=True)
            self._store_dir = None
