"""HTTP inference runner over stdlib `http.server` (port of
`fedml_tpu/serving/inference_runner.py`): POST /predict (JSON, or SSE with
`"stream": true`), GET /ready, GET /info and GET /metrics.

- POST /predict with `"stream": true` answers `text/event-stream`: one
  `data: {"token": t, "index": i}` event per generated token as the
  decode engine delivers it, then a final `data: {"done": true,
  "generated_tokens": [...]}` event. Errors before the first event keep
  their status codes (400/409/500); an error after the stream opened is a
  terminal `data: {"error": ..., "code": ...}` event, never `done`.
- Errors: InvalidRequest, a missing field (KeyError) and a body that is
  not JSON are the client's (400); StaleVersion is 409 with the
  `model_version` this replica serves; anything else is 500.
- GET /info reports `model_version`, `queue_depth`, `slots_active`,
  `decode_queue`, `draining`, `kv_page_size` and `prefix_digests`; every
  /predict response (and the SSE head) carries the prefix-affinity
  headers `X-KV-Page-Size` / `X-Prefix-Digest` when a paged engine with a
  prefix cache serves it.
- `chaos` (a `comm.chaos.FaultSpec`) arms this replica's `replica_kill`
  schedule: after streaming its n-th token the replica dies abruptly
  (`kill()`).
- `stop()` drains the predictor's engine first.

GET /metrics answers the process registry in the Prometheus text format
(`utils/prometheus.py`). POST /swap hot-swaps adapters from the
model-artifact store: the body `{"store": store_spec(store), "name":
adapter_name(r), "version": optional}` names the store
(`utils/artifacts.py`) and the artifact, the replica fetches the tensors
itself, moves them to the served adapters' device and dtype, and swaps
them into the live predictor (`GreedyLMPredictor.swap_adapters`, under a
`serving.swap.http` span). It answers 200 `{"model_version": N}`; 400 for
a body that is not a JSON object, a predictor with no adapters, an
unknown store or artifact, or a refused swap; 500 when the replica fails.
"""
from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..utils import metrics as _mx
from ..utils.events import recorder
from ..utils.prometheus import write_metrics_response
from .predictor import Predictor

log = logging.getLogger(__name__)
DEFAULT_PORT = 2345  # the reference runner's port


class FedMLInferenceRunner:
    """Serve a Predictor over HTTP.

    run() blocks; start()/stop() run it on a daemon
    thread for embedding in tests and larger processes.

    `chaos` (a comm.chaos.FaultSpec) + `chaos_rank` arm this replica's
    `replica_kill` schedule: after streaming its n-th token the replica
    dies abruptly (kill()), which is how the mid-stream failover tests
    and the chaos bench make a replica fail at a deterministic point."""

    def __init__(self, predictor: Predictor, host: str = "127.0.0.1",
                 port: int = DEFAULT_PORT, chaos=None, chaos_rank: int = 0):
        self.predictor = predictor
        self._chaos = chaos
        self._chaos_rank = int(chaos_rank)
        self._chaos_tokens = 0
        self._chaos_lock = threading.Lock()
        runner = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet the default stderr spam
                log.debug("serving: " + fmt, *args)

            def _send(self, code: int, payload: dict,
                      headers: Optional[dict] = None) -> None:
                # a chaos-killed replica runs no cleanup: connections that
                # were in flight when the kill landed are severed before
                # any response byte (real process death answers nobody)
                if runner._killed:
                    raise ConnectionError("replica killed")
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _residency_headers(self) -> Optional[dict]:
                """Prefix-affinity advert for the routing gateway: the
                engine's page geometry + its resident first-page prefix
                digests, stamped on every /predict response (and the SSE
                head) so the gateway learns residency off the warm path
                without polling /info. None for non-engine predictors
                and contiguous/prefix-off engines — the headers' absence
                IS the "no affinity signal" case."""
                eng = getattr(runner.predictor, "engine", None)
                if eng is None or not getattr(eng, "kv_page_size", 0):
                    return None
                return {"X-KV-Page-Size": str(eng.kv_page_size),
                        "X-Prefix-Digest": ",".join(eng.prefix_digests())}

            def do_GET(self):
                if runner._killed:
                    self.close_connection = True
                    return      # severed: no response, socket closes
                if self.path == "/ready":
                    self._send(200, {"status": "Success"})
                elif self.path == "/info":
                    # the fleet-control signal: version for the rolling
                    # updater's convergence check, load for operators and
                    # telemetry — the gateway routes on its own in-flight
                    # counts, it does not poll this (engine attrs read
                    # lock-free — a snapshot, not a transaction)
                    eng = getattr(runner.predictor, "engine", None)
                    self._send(200, {
                        "model_version": getattr(
                            runner.predictor, "model_version", None),
                        "queue_depth": runner._inflight.value(),
                        "slots_active": (
                            sum(s is not None for s in eng._slots)
                            if eng is not None else None),
                        "decode_queue": (
                            len(eng._waiting) + len(eng._inbox)
                            if eng is not None else None),
                        "draining": (bool(eng._draining)
                                     if eng is not None else False),
                        "kv_page_size": (getattr(eng, "kv_page_size", 0)
                                         if eng is not None else 0),
                        "prefix_digests": (eng.prefix_digests()
                                           if eng is not None else []),
                    })
                elif self.path == "/metrics":
                    # the process registry (request latency, queue depth,
                    # the engine's counters) in Prometheus text
                    write_metrics_response(self)
                else:
                    self._send(404, {"error": f"no route {self.path}"})

            def _error_code(self, e: BaseException) -> int:
                # input errors are the CLIENT's (400); anything else is
                # this replica failing (500). The split matters to the
                # gateway both ways: a 4xx never kills a replica (so
                # hostile input can't drain the pool), and internal
                # failures must be 5xx so failover happens. Only the
                # dedicated InvalidRequest (raised at the predictors'
                # validation sites) and a missing-field KeyError count
                # as client errors — matching builtin ValueError/
                # TypeError would misfile internal shape errors.
                # StaleVersion gets its own 409: the replica is healthy,
                # the request just pinned a model_version a SIBLING
                # serves — the gateway reroutes instead of surfacing.
                # A body that isn't JSON is likewise the client's (the
                # decode error can only come from the request body here);
                # 500 would let one garbage request suspect every replica
                # it is retried on and drain the ready pool.
                from .predictor import InvalidRequest, StaleVersion

                if isinstance(e, StaleVersion):
                    return 409
                return (400 if isinstance(e, (InvalidRequest, KeyError,
                                              json.JSONDecodeError))
                        else 500)

            def do_POST(self):
                if runner._killed:
                    self.close_connection = True
                    return      # severed: no response, socket closes
                if self.path == "/swap":
                    self._do_swap()
                    return
                if self.path != "/predict":
                    self._send(404, {"error": f"no route {self.path}"})
                    return
                # queue depth = requests in flight on the threading server
                # (each request holds a thread; a per-request predictor
                # serializes device work through jit so depth > 1 means
                # queueing; an engine-backed predictor blocks each request
                # on its own ticket instead, so depth counts slots+queue).
                # AtomicCounter with the gauge bound: += on a
                # ThreadingHTTPServer would race and drift permanently, and
                # publishing the gauge outside the counter's lock would let
                # two finishing threads reorder their writes.
                t0 = time.perf_counter()
                runner._inflight.inc()
                _mx.inc("serving.requests")
                try:
                    with recorder.span("serving.request", path=self.path):
                        n = int(self.headers.get("Content-Length", 0))
                        input_json = json.loads(self.rfile.read(n) or b"{}")
                        if not isinstance(input_json, dict):
                            from .predictor import InvalidRequest

                            raise InvalidRequest(
                                "request body must be a JSON object; got "
                                f"{type(input_json).__name__}")
                        if input_json.get("stream"):
                            self._do_stream(input_json, t0)
                            return
                        result = runner.predictor.predict(input_json)
                        if not isinstance(result, dict):
                            result = {"generated_text": str(result)}
                        # residency read AFTER the predict: this
                        # prompt's own first page is already registered,
                        # so the advert includes it
                        self._send(200, result,
                                   headers=self._residency_headers())
                except ConnectionError as e:
                    # the peer can't receive another byte: the client hung
                    # up, or a chaos kill severed this replica mid-stream.
                    # A _send here would write a SECOND status line into an
                    # already-open SSE body (protocol garbage); just return
                    # — the socket closes and the gateway sees a cut stream
                    log.warning("connection lost mid-request: %s", e)
                    _mx.inc("serving.conn_lost")
                except Exception as e:  # noqa: BLE001 — surface to caller
                    log.exception("predict failed")
                    _mx.inc("serving.errors")
                    payload = {"error": f"{type(e).__name__}: {e}"}
                    code = self._error_code(e)
                    if code == 409:
                        # tell the router what this replica DOES serve
                        payload["model_version"] = getattr(
                            runner.predictor, "model_version", None)
                    self._send(code, payload)
                finally:
                    runner._inflight.dec()
                    _mx.observe("serving.request_s",
                                time.perf_counter() - t0)

            def _do_swap(self) -> None:
                """Hot adapter swap from the artifact store the request
                names (module docstring)."""
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) or b"{}")
                    if not isinstance(body, dict):
                        self._send(400, {"error": "swap body must be a "
                                                  "JSON object"})
                        return
                    swap = getattr(runner.predictor, "swap_adapters", None)
                    if swap is None:
                        self._send(400, {
                            "error": "this replica's predictor has no "
                                     "adapter plane to swap"})
                        return
                    from ..utils.artifacts import store_from_spec
                    from .predictor import adapters_like

                    store = store_from_spec(dict(body.get("store") or {}))
                    tree = adapters_like(
                        store.get(body["name"]),
                        getattr(runner.predictor, "adapters", None))
                    ver = body.get("version")
                    with recorder.span("serving.swap.http",
                                       artifact=body.get("name")):
                        new_ver = swap(
                            tree, version=None if ver is None else int(ver))
                    self._send(200, {"model_version": new_ver})
                except (KeyError, ValueError, TypeError) as e:
                    _mx.inc("serving.errors")
                    self._send(400, {"error": f"{type(e).__name__}: {e}"})
                except Exception as e:  # noqa: BLE001 — replica failing
                    log.exception("swap failed")
                    _mx.inc("serving.errors")
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})

            def _do_stream(self, input_json: dict, t0: float) -> None:
                """SSE branch of /predict. The FIRST chunk is pulled
                before any byte is written, so validation errors (and a
                stale version pin) still travel as proper status codes;
                from the second chunk on, failures become a terminal
                `data: {"error": ...}` event — never a fake `done`."""
                from .predictor import InvalidRequest

                ps = getattr(runner.predictor, "predict_stream", None)
                if ps is None:
                    raise InvalidRequest(
                        "this replica's predictor does not stream "
                        "(LM replicas do; classification replicas "
                        "answer /predict without stream)")
                gen = ps(input_json)
                first = next(gen)
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                # the first chunk was pulled above, so admission already
                # registered this prompt's prefix — the SSE head can
                # advertise residency like the non-stream path
                for k, v in (self._residency_headers() or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                _mx.inc("serving.stream_responses")
                _mx.observe("serving.stream_ttft",
                            time.perf_counter() - t0)
                try:
                    self._emit(first)
                    for chunk in gen:
                        self._emit(chunk)
                except (BrokenPipeError, ConnectionError):
                    raise           # client (or chaos kill) went away
                except Exception as e:  # noqa: BLE001 — headers are sent
                    log.exception("stream failed mid-flight")
                    _mx.inc("serving.errors")
                    # a pinned stream that straddled a hot swap carries
                    # its 409 so the gateway reroutes to a sibling
                    # instead of suspecting this (healthy) replica;
                    # every other mid-flight failure stays a 503
                    code = self._error_code(e)
                    self.wfile.write(
                        b"data: " + json.dumps(
                            {"error": f"{type(e).__name__}: {e}",
                             "code": code if code == 409 else 503}
                        ).encode() + b"\n\n")
                    self.wfile.flush()

            def _emit(self, chunk: dict) -> None:
                # concurrent streams on a killed replica die at their next
                # emit, not just the stream whose token tripped the kill
                if runner._killed:
                    raise ConnectionError("replica killed")
                self.wfile.write(b"data: " + json.dumps(chunk).encode()
                                 + b"\n\n")
                self.wfile.flush()
                if "token" in chunk:
                    runner._chaos_tick()

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]  # resolved when port=0
        self._thread: Optional[threading.Thread] = None
        self._serving = False
        self._killed = False
        self._inflight = _mx.AtomicCounter(gauge="serving.queue_depth")

    def arm_chaos(self, chaos, chaos_rank: int = 0) -> None:
        """(Re)arm the `replica_kill` schedule on a running replica: `chaos`
        (a FaultSpec, or None to disarm) counts from the next streamed
        token as rank `chaos_rank`."""
        with self._chaos_lock:
            self._chaos = chaos
            self._chaos_rank = int(chaos_rank)
            self._chaos_tokens = 0

    def _chaos_tick(self) -> None:
        """Count one streamed token against this replica's kill schedule;
        dying means: server down NOW, this connection severed (the raise
        propagates out of the handler and closes the socket abruptly)."""
        # one read of the schedule under the lock: a re-arm between two
        # bare reads would judge this token by a mix of both schedules
        with self._chaos_lock:
            chaos, rank = self._chaos, self._chaos_rank
            if chaos is None:
                return
            self._chaos_tokens += 1
            n = self._chaos_tokens
        if chaos.replica_killed(rank, n):
            _mx.inc("fed.chaos.replica_kills")
            with recorder.span("serving.chaos.replica_kill",
                               rank=rank, tokens=n):
                self.kill()
            raise ConnectionError(
                f"chaos: replica {rank} killed after {n} streamed tokens")

    @property
    def metrics_url(self) -> str:
        """This replica's /metrics scrape URL: what a `FleetCollector`
        roster entry (`utils/obsfleet.py`) wants for this process."""
        host = self._server.server_address[0]
        return f"http://{host}:{self.port}/metrics"

    def run(self) -> None:
        log.info("serving on :%d (/predict, /ready, /info)",
                 self.port)
        self._serving = True
        self._server.serve_forever()

    def start(self) -> "FedMLInferenceRunner":
        self._thread = threading.Thread(target=self.run, daemon=True)
        self._thread.start()
        return self

    def kill(self) -> None:
        """CHAOS: simulate replica process death. The listening socket
        closes immediately and /ready stops answering; the connection
        that tripped the kill is severed (its handler raises); the
        predictor/engine is NOT stopped or drained (a real process death
        runs no cleanup). The deterministic fault the mid-stream
        failover tests aim at."""
        if self._killed:
            return
        self._killed = True
        if self._serving:
            # shutdown() from a handler thread would deadlock only if
            # called synchronously from serve_forever's own thread — these
            # handlers run on their own threads, but be safe and fire it
            # from a dedicated one; server_close() severs the socket now
            threading.Thread(target=self._server.shutdown,
                             daemon=True).start()
        self._server.server_close()

    def stop(self) -> None:
        # shutdown() blocks on an event only serve_forever sets — calling
        # it on a never-started server would deadlock. A chaos-killed
        # server is already down — only the predictor cleanup remains
        # (test teardown; a real dead process has nothing to clean).
        if not self._killed:
            if self._serving:
                self._server.shutdown()
            self._server.server_close()
            if self._thread is not None:
                self._thread.join(timeout=5)
        # an engine-backed predictor owns a decode thread — DRAIN it first
        # (in-flight decodes finish, bounded by the predictor's
        # drain_timeout_s), then shut it down with the HTTP surface, so a
        # scale-down or rolling replacement never kills a request that
        # was already decoding
        stop = getattr(self.predictor, "stop", None)
        if callable(stop):
            # probe the signature instead of catching TypeError — a
            # TypeError raised INSIDE stop(drain=True) must surface, not
            # trigger a second, drainless teardown
            import inspect

            try:
                drains = "drain" in inspect.signature(stop).parameters
            except (TypeError, ValueError):   # builtins/C callables
                drains = False
            stop(drain=True) if drains else stop()
