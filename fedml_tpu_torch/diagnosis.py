"""The port's diagnosis battery: `python -m fedml_tpu_torch diagnosis`.

(reference: slave/client_diagnosis.py, the probes a client runs before
joining a run; the JAX package's battery is `fedml_tpu/__main__.py`'s
`cmd_diagnosis`.) Each probe returns a dict of readings or raises; the
battery prints `{"ok": ..., "device": ..., "checks": {name: {"ok", ...,
"seconds"}}, "not_run": [...]}` and exits 0 iff every required probe that
ran passed.

Required:
- `cuda`: the card's name, the count, and compute capability 9.x;
- `kernels`: K1-K3 (`ops/flash_attention.py`) and K4
  (`ops/paged_attention.py`) built by `ops/_build.py`, each launched once
  at a small shape in f32 and bf16 (K4 also over an int8 pool, at C 1 and
  3) and held against its plain version under `ops/tolerance.py`'s bars;
- `wire_codec`, `loopback_transport`, `chaos_smoke` (exactly-once over
  injected faults), `codec_smoke` (sparse frames under chaos, bitwise);
- `serving_engine_smoke` (slots decode concurrently),
  `serving_paged_smoke` (the paged engine through K4: a prefix hit, pages
  reclaimed, K4 launched), `serving_spec_smoke` (speculation token-
  identical to plain decoding, drafts accepted, K4 at C > 1),
  `serving_density_smoke` (int8 pages match, >= 2x density, batched
  admission invisible in the tokens);
- `fleet_rolling_update_smoke`: a 2-replica engine fleet takes a v1 -> v2
  rolling adapter update under load with zero non-2xx, both replicas at
  version 2, and a streamed request completes;
- `cross_silo_durability_smoke`: a server killed and resumed gives the
  uninterrupted run's parameters bit for bit;
- `live_loop_smoke`: a 3-round live loop (train -> publish -> hot-swap ->
  serve under load, one trainer kill) converges on version 3 with zero
  non-2xx, inside 20 s;
- `attribution_smoke`: the round-time budget over a round span and
  loopback traffic, with a transport share > 0; a tracked program's
  ledger FLOPs > 0 (`utils/xla_ledger.py`); a 2-slot engine's kv_pool
  ledger bytes within 1% of 2 x its `serving.kv_bytes_per_slot`;
- `cohort_sharded_smoke`: two spawned gloo ranks on the device (a
  `clients` mesh of 2) run a chunk-streamed cohort round and the
  single-shot round: history and parameters bitwise, every chunk
  streamed, ingest overlapping compute;
- `partition_rules_smoke`: the partitioning plane end to end: the int8
  TransformerLM in the JAX package's scan (stacked) layout and in the
  port's state-dict layout, and its LoRA adapters, resolve under the
  error policy (full coverage, no ambiguity), then two spawned gloo ranks
  on the device (an {"mp": 2} mesh) shard the int8 base and hold the
  halves of a column and a row kernel;
- `lint_clean`: graftlint (`analysis/`) over the package tree reports
  zero findings, inside 20 s;
- `fleet_obs_smoke`: three child processes (two gRPC peers exchanging
  reliable traffic both ways, one victim) scraped by a FleetCollector
  into one exposition with three `process` label values, the peers'
  traces merged into one timeline with a stitched send -> handle flow
  and no ordering violation, and the victim, SIGKILLed, marked stale
  and leaving a postmortem that names its last span, inside 20 s. The
  peers need the `grpc` module: without it the probe fails with an
  ImportError naming it (the card's machine has none, so `chip_smoke.py`
  leaves this probe out of its battery).

Reported, not required: `grpc_transport` (the card's machine has no
grpc), `native_lib`, `metrics_endpoint`.

`device` is CUDA unless the caller asks for "cpu" (and raises without a
GPU: the battery never drops to the CPU by itself). On the CPU the
probes run the plain versions, and `cuda` and `kernels` are reported
under `not_run` with the reason: no probe claims a kernel passed there.
"""
from __future__ import annotations

import json
import sys
import threading
import time
import uuid

import numpy as np
import torch

from ._device import resolve_device

REQUIRED = ("cuda", "kernels", "wire_codec", "loopback_transport",
            "chaos_smoke", "codec_smoke", "serving_engine_smoke",
            "serving_paged_smoke", "serving_spec_smoke",
            "serving_density_smoke", "fleet_rolling_update_smoke",
            "cross_silo_durability_smoke", "live_loop_smoke",
            "attribution_smoke", "cohort_sharded_smoke",
            "partition_rules_smoke", "lint_clean", "fleet_obs_smoke")


class NotRun(Exception):
    """A probe that cannot run on the chosen device."""


def _card_only(dev: torch.device, what: str) -> None:
    if dev.type != "cuda":
        raise NotRun(f"{what} runs only on a CUDA device; --device "
                     f"{dev.type} runs the plain versions, not the kernels")


# ------------------------------------------------------------------ device
def probe_cuda(dev):
    _card_only(dev, "the card probe")
    major, minor = torch.cuda.get_device_capability(dev)
    if major != 9:
        raise RuntimeError(f"compute capability {major}.{minor}: the "
                           "kernels are built for sm_90a (Hopper)")
    return {"name": torch.cuda.get_device_name(dev),
            "count": torch.cuda.device_count(),
            "capability": f"{major}.{minor}"}


def _row_err(name, got, want, tol, errs) -> None:
    from .ops.tolerance import rowwise_rel_err

    if not torch.isfinite(got.float()).all():
        raise ValueError(f"{name}: non-finite output")
    rel = rowwise_rel_err(got, want)
    errs[name] = rel
    if rel > tol:
        raise ValueError(f"{name}: row-relative error {rel:.3g} over the "
                         f"bar {tol:g}")


def probe_kernels(dev):
    """K1-K4 built, launched once each at a small shape, and held against
    their plain versions (module docstring)."""
    _card_only(dev, "the kernel probe")
    from .ops import _build
    from .ops import flash_attention as fa
    from .ops import paged_attention as pa
    from .ops.tolerance import FLASH_TOL, PAGED_TOL

    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    errs: dict = {}
    routes_run: list = []
    bh, t, d, bq, bk = 4, 128, 64, 64, 64
    for kind, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        q, k, v, do = (torch.from_numpy(
            rng.standard_normal((bh, t, d), np.float32)).to(dev, dt)
            for _ in range(4))
        routes = (fa.fwd_route(q), fa.dq_route(q), fa.dkv_route(q))
        before = dict(fa.launch_count)
        o, lse = fa.flash_fwd(q, k, v)
        delta = fa.flash_delta(o, do)
        dq = fa.flash_dq(q, k, v, do, lse, delta)
        dk, dv = fa.flash_dkv(q, k, v, do, lse, delta)
        torch.cuda.synchronize(dev)
        if fa.launch_count != {n: before[n] + (n in routes)
                               for n in before}:
            raise RuntimeError(f"flash {kind}: launches {fa.launch_count} "
                               f"are not one each of {routes}")
        routes_run += routes
        want_o, want_lse = fa.flash_fwd_ref(q, k, v, bq, bk)
        want_dq = fa.flash_dq_ref(q, k, v, do, lse, delta, bq, bk)
        want_dk, want_dv = fa.flash_dkv_ref(q, k, v, do, lse, delta, bq, bk)
        for name, got, want in (("K1.o", o, want_o), ("K1.lse", lse,
                                                      want_lse),
                                ("K2.dq", dq, want_dq), ("K3.dk", dk,
                                                         want_dk),
                                ("K3.dv", dv, want_dv)):
            _row_err(f"{name} {kind}", got, want, FLASH_TOL[kind], errs)
    # K4: 4 slots over a 33-page pool, 8-entry tables, pages of 16
    s_, h, dh, ps, n_pool, mp = 4, 4, 128, 16, 33, 8
    perm = rng.permutation(np.arange(1, n_pool))
    pages = np.zeros((s_, mp), np.int32)
    for s in range(s_):
        pages[s, :mp] = perm[s * mp:(s + 1) * mp]
    k4 = 0
    for c in (1, 3):
        pos = np.array([rng.integers(0, mp * ps - c + 1) for _ in range(s_)],
                       np.int32)
        for kind in ("f32", "bf16", "int8"):
            qdt = torch.float32 if kind == "f32" else torch.bfloat16
            shape = (n_pool, ps, h, dh)
            if kind == "int8":
                kp, vp = (torch.from_numpy(rng.integers(
                    -127, 128, shape, np.int8)).to(dev) for _ in range(2))
                ks, vs = (torch.from_numpy(rng.uniform(
                    0.005, 0.02, (n_pool, h)).astype(np.float32)).to(dev)
                    for _ in range(2))
            else:
                kp, vp = (torch.from_numpy(rng.standard_normal(
                    shape, np.float32)).to(dev, qdt) for _ in range(2))
                ks = vs = None
            q = torch.from_numpy(rng.standard_normal(
                (s_, c, h, dh), np.float32)).to(dev, qdt)
            pg = torch.from_numpy(pages).to(dev)
            ps_t = torch.from_numpy(pos).to(dev)
            n0 = pa.launch_count
            got = pa.paged_attention(q, kp, vp, pg, ps_t, ks, vs)
            torch.cuda.synchronize(dev)
            if pa.launch_count != n0 + 1:
                raise RuntimeError("K4 did not launch its kernel")
            k4 += 1
            want = pa.paged_attention_ref(q, kp, vp, pg, ps_t, ks, vs)
            _row_err(f"K4 {kind} C={c}", got, want, PAGED_TOL[kind], errs)
    return {"build_s": round(build_s, 3), "flash_routes": routes_run,
            "k4_launches": k4, "max_row_rel_err": errs}


# ------------------------------------------------------------- transports
def probe_wire_codec(dev):
    from .comm.serialization import decode, encode

    x = {"a": np.arange(8, dtype=np.float32)}
    got = decode(encode(x))
    if not np.array_equal(got["a"], x["a"]):
        raise ValueError("wire codec roundtrip mismatch")


def probe_loopback_transport(dev):
    from .comm import FedCommManager, Message
    from .comm.loopback import LoopbackTransport, release_router

    run = f"diag-{uuid.uuid4().hex[:6]}"
    got = threading.Event()
    a = FedCommManager(LoopbackTransport(0, run), 0)
    b = FedCommManager(LoopbackTransport(1, run), 1)
    b.register_message_receive_handler("ping", lambda m: got.set())
    a.run(background=True)
    b.run(background=True)
    a.send_message(Message("ping", 0, 1))
    ok = got.wait(timeout=5)
    a.stop()
    b.stop()
    release_router(run)
    if not ok:
        raise TimeoutError("loopback roundtrip timed out")


def probe_grpc_transport(dev):
    from .comm.grpc_transport import GrpcTransport

    t = GrpcTransport(0, {}, port=0)
    t.shutdown(grace=0)


def probe_native_lib(dev):
    from .native import crc32c

    return {"crc32c_x": crc32c(b"x")}


def probe_metrics_endpoint(dev):
    import urllib.request

    from .utils import metrics as mx
    from .utils.prometheus import MetricsExporter, parse_prometheus

    mx.inc("diagnosis.metrics_probe")
    exp = MetricsExporter(port=0).start()
    try:
        with urllib.request.urlopen(exp.url, timeout=5) as r:
            parsed = parse_prometheus(r.read().decode())
        if "diagnosis_metrics_probe_total" not in parsed["counters"]:
            raise ValueError("probe counter missing from exposition")
        return {"port": exp.port,
                "series": len(parsed["counters"]) + len(parsed["gauges"])
                + len(parsed["histograms"])}
    finally:
        exp.stop()


def probe_chaos_smoke(dev):
    """20 messages over loopback under injected drop / duplicate / delay /
    corrupt faults with the reliable layer on: each lands exactly once."""
    from .comm import FedCommManager, Message
    from .comm.chaos import ChaosTransport, FaultSpec
    from .comm.loopback import LoopbackTransport, release_router
    from .comm.reliable import ReliableTransport, RetryPolicy
    from .utils import metrics as mx

    run = f"chaos-{uuid.uuid4().hex[:6]}"
    spec = FaultSpec(seed=7, drop=0.2, duplicate=0.15, delay=0.3,
                     delay_max_s=0.01, corrupt=0.1)
    pol = RetryPolicy(ack_timeout_s=0.05, max_attempts=10, deadline_s=15.0)

    def mk(r):
        return ReliableTransport(ChaosTransport(LoopbackTransport(r, run),
                                                spec), pol)

    a, b = FedCommManager(mk(0), 0), FedCommManager(mk(1), 1)
    got: list = []
    done = threading.Event()
    n = 20

    def on_probe(m):
        got.append(m.get("i"))
        if len(set(got)) >= n:
            done.set()

    b.register_message_receive_handler("chaos_probe", on_probe)
    a.run(background=True)
    b.run(background=True)
    try:
        for i in range(n):
            a.send_message(Message("chaos_probe", 0, 1).add("i", i))
        ok = done.wait(timeout=15)
        time.sleep(0.1)      # let straggling duplicates land
        if not ok or sorted(set(got)) != list(range(n)):
            raise TimeoutError(
                f"delivered {len(set(got))}/{n} under injected faults")
        if len(got) != len(set(got)):
            raise ValueError("dedup window failed: a message was applied "
                             "twice")
        snap = mx.snapshot()["counters"]
        return {"delivered": n,
                "faults_injected": sum(v for k, v in snap.items()
                                       if k.startswith("fed.chaos.")),
                "retransmits": snap.get("comm.rel.retransmits", 0)}
    finally:
        a.stop()
        b.stop()
        release_router(run)


def probe_codec_smoke(dev):
    """12 model-payload frames through the sparse codec under chaos with
    reliable delivery: each lands once, decodes to the sender's
    reconstruction bit for bit, and costs fewer wire bytes than raw."""
    from .comm import FedCommManager, Message
    from .comm.chaos import ChaosTransport, FaultSpec
    from .comm.codec import CodecPolicy
    from .comm.loopback import LoopbackTransport, release_router
    from .comm.reliable import ReliableTransport, RetryPolicy
    from .compression import decode_sparse, encode_sparse
    from .utils import metrics as mx

    run = f"codec-{uuid.uuid4().hex[:6]}"
    spec = FaultSpec(seed=11, duplicate=0.2, corrupt=0.15, drop=0.1)
    pol = RetryPolicy(ack_timeout_s=0.05, max_attempts=10, deadline_s=15.0)
    cc = {"kind": "sparse_topk", "ratio": 0.25,
          "per_type": {"codec_probe": "sparse_topk"}}

    def mk(r):
        base = LoopbackTransport(r, run)
        base.set_codec(CodecPolicy.from_config(cc))
        return ReliableTransport(ChaosTransport(base, spec), pol)

    a, b = FedCommManager(mk(0), 0), FedCommManager(mk(1), 1)
    got: dict = {}
    done = threading.Event()
    n = 12
    rs = np.random.RandomState(3)
    payloads = [rs.randn(257).astype(np.float32) for _ in range(n)]

    def on_probe(m):
        got.setdefault(int(m.get("i")), []).append(
            np.asarray(m.get("model_params")["w"]))
        if len(got) >= n:
            done.set()

    b.register_message_receive_handler("codec_probe", on_probe)
    a.run(background=True)
    b.run(background=True)
    snap0 = mx.snapshot()["counters"]
    try:
        for i in range(n):
            a.send_message(Message("codec_probe", 0, 1).add("i", i)
                           .add("model_params", {"w": payloads[i]}))
        ok = done.wait(timeout=15)
        time.sleep(0.1)
        if not ok:
            raise TimeoutError(f"delivered {len(got)}/{n} compressed "
                               "frames under injected faults")
        if any(len(v) != 1 for v in got.values()):
            raise ValueError("exactly-once violated: a compressed frame "
                             "was dispatched twice")
        for i in range(n):
            want = decode_sparse(encode_sparse(payloads[i], 0.25))
            if not np.array_equal(got[i][0], want):
                raise ValueError(f"payload {i}: decoded != encoded "
                                 "reconstruction")
        snap1 = mx.snapshot()["counters"]
        raw = snap1.get("comm.codec.loopback.bytes_raw", 0) \
            - snap0.get("comm.codec.loopback.bytes_raw", 0)
        wire = snap1.get("comm.codec.loopback.bytes_wire", 0) \
            - snap0.get("comm.codec.loopback.bytes_wire", 0)
        if not 0 < wire < raw:
            raise ValueError(f"no payload reduction: raw={raw} wire={wire}")
        return {"delivered": n, "bytes_raw": raw, "bytes_wire": wire,
                "reduction_x": round(raw / wire, 2)}
    finally:
        a.stop()
        b.stop()
        release_router(run)


# ----------------------------------------------------------------- serving
def _tiny_lm(dev):
    """A one-block LM with heads of 64 (K4 takes any head up to 256), f32
    weights from seed 0 on `dev`."""
    from .llm.transformer import ModelDims, TransformerLM, init_params

    dims = ModelDims(vocab_size=64, d_model=128, n_layers=1, n_heads=2,
                     d_ff=128)
    return TransformerLM.from_state(dims, init_params(dims, seed=0,
                                                      device=dev))


def _k4_count(dev) -> tuple[int, dict]:
    from .ops import paged_attention as pa

    return pa.launch_count, dict(pa.launches_by_c)


def probe_serving_engine_smoke(dev):
    """8 concurrent requests on a 4-slot engine: every request answered in
    full, and more than one slot decoding at once."""
    from .serving.engine import DecodeEngine
    from .utils import metrics as mx

    model = _tiny_lm(dev)
    rs = np.random.RandomState(0)
    prompts = [rs.randint(1, 64, n).tolist()
               for n in (4, 6, 5, 7, 4, 6, 5, 7)]
    eng = DecodeEngine(model, n_slots=4, max_len=32, device=dev).start()
    max_active = [0]
    stop = threading.Event()

    def poll():
        while not stop.is_set():
            g = mx.snapshot()["gauges"].get("serving.slots_active", 0)
            max_active[0] = max(max_active[0], int(g))
            time.sleep(0.002)

    th = threading.Thread(target=poll, daemon=True)
    th.start()
    try:
        outs = [t.result(timeout=60)
                for t in [eng.submit(p, 6) for p in prompts]]
    finally:
        stop.set()
        th.join()
        eng.stop()
    if len(outs) != 8 or any(len(o) != 6 for o in outs):
        raise ValueError(f"responses malformed: {[len(o) for o in outs]}")
    if max_active[0] <= 1:
        raise ValueError("slots never decoded concurrently (max "
                         f"slots_active {max_active[0]})")
    return {"requests": 8, "max_slots_active": max_active[0]}


def probe_serving_paged_smoke(dev):
    """6 requests sharing an 8-token prefix on the paged engine through K4
    under a budget below the contiguous equivalent: all served, the prefix
    cache hit, retirement reclaims every page, K4 launched (on CUDA)."""
    from .serving.engine import DecodeEngine
    from .utils import metrics as mx

    model = _tiny_lm(dev)
    rs = np.random.RandomState(0)
    head = rs.randint(1, 64, 8).tolist()
    prompts = [head + rs.randint(1, 64, 4).tolist() for _ in range(6)]
    # 19 usable pages against the contiguous 3 * 32 / 4 = 24
    eng = DecodeEngine(model, n_slots=3, max_len=32, page_size=4,
                       n_pages=20, prefill_chunk=4, paged_kernel=True,
                       device=dev).start()
    h0 = mx.snapshot()["counters"].get("serving.prefix_hits", 0)
    k0, _ = _k4_count(dev)
    try:
        outs = [t.result(timeout=60)
                for t in [eng.submit(p, 4) for p in prompts]]
        snap = mx.snapshot()
        free = snap["gauges"]["serving.kv_pages_free"]
        resident = len(eng._prefix)
    finally:
        eng.stop()
    k4 = _k4_count(dev)[0] - k0
    if len(outs) != 6 or any(len(o) != 4 for o in outs):
        raise ValueError(f"responses malformed: {[len(o) for o in outs]}")
    hits = snap["counters"].get("serving.prefix_hits", 0) - h0
    if hits < 1:
        raise ValueError("the shared prompt prefix never hit the prefix "
                         f"cache (hits {hits})")
    if free + resident != 19:
        raise ValueError(f"retirement did not reclaim pages: free {free} + "
                         f"resident prefix {resident} != budget 19")
    if dev.type == "cuda" and k4 < 1:
        raise ValueError("the paged engine never launched K4")
    return {"requests": 6, "prefix_hits": int(hits), "pages_free": int(free),
            "prefix_resident": resident, "k4_launches": k4}


def probe_serving_spec_smoke(dev):
    """4 repetitive prompts through the paged K4 engine with n-gram
    speculation: token-identical to speculation off, drafts accepted, and
    (on CUDA) K4 launched at C = spec_k + 1 > 1."""
    from .serving.engine import DecodeEngine
    from .utils import metrics as mx

    model = _tiny_lm(dev)
    prompts = [[3, 9] * 4, [2] * 8, [11, 5, 7, 11, 5, 7, 11, 5], [7] * 8]

    def run(spec):
        eng = DecodeEngine(model, n_slots=4, max_len=32, page_size=4,
                           prefill_chunk=4, paged_kernel=True,
                           spec_decode="ngram" if spec else "off",
                           spec_k=3, device=dev).start()
        try:
            return [t.result(timeout=60)
                    for t in [eng.submit(p, 6) for p in prompts]]
        finally:
            eng.stop()

    base = run(spec=False)
    c0 = mx.snapshot()["counters"]
    _, by_c0 = _k4_count(dev)
    got = run(spec=True)
    c1 = mx.snapshot()["counters"]
    _, by_c1 = _k4_count(dev)
    accepted = int(c1.get("serving.spec.accepted", 0)
                   - c0.get("serving.spec.accepted", 0))
    proposed = int(c1.get("serving.spec.proposed", 0)
                   - c0.get("serving.spec.proposed", 0))
    wide = {c: n - by_c0.get(c, 0) for c, n in by_c1.items()
            if c > 1 and n - by_c0.get(c, 0) > 0}
    if got != base:
        raise ValueError("speculation-on output differs from speculation-"
                         "off: the greedy-exact acceptance contract is "
                         "broken")
    if accepted < 1:
        raise ValueError("no draft token was ever accepted on repetitive "
                         f"prompts (proposed {proposed})")
    if dev.type == "cuda" and not wide:
        raise ValueError("speculation never launched K4 at C > 1")
    return {"requests": len(prompts), "accepted": accepted,
            "proposed": proposed,
            "accept_rate": round(accepted / max(proposed, 1), 3),
            "k4_launches_by_c": {str(c): n for c, n in sorted(wide.items())}}


def probe_serving_density_smoke(dev):
    """The same prompts through the paged K4 engine with an f32 pool, an
    int8 pool, and int8 with batched admission: int8 matches >= 0.99 of
    the baseline's greedy tokens, >= 2x the bytes a slot, and batched
    admission leaves the tokens alone and records its batches."""
    from .serving.engine import DecodeEngine
    from .utils import metrics as mx

    model = _tiny_lm(dev)
    rs = np.random.RandomState(0)
    prompts = [rs.randint(1, 64, 8).tolist() for _ in range(4)]

    def run(**kw):
        eng = DecodeEngine(model, n_slots=4, max_len=32, page_size=4,
                           prefill_chunk=4, paged_kernel=True, device=dev,
                           **kw).start()
        try:
            outs = [t.result(timeout=60)
                    for t in [eng.submit(p, 6) for p in prompts]]
            return outs, int(mx.snapshot()["gauges"][
                "serving.kv_bytes_per_slot"])
        finally:
            eng.stop()

    def admit_batches():
        return mx.snapshot()["histograms"].get(
            "serving.engine.admit_batch", {}).get("count", 0)

    base, bps_base = run()
    h0 = admit_batches()
    quant, bps_q = run(kv_quant="int8")
    batched, _ = run(kv_quant="int8", admit_batch=4)
    h1 = admit_batches()
    total = sum(len(o) for o in base)
    matched = sum(a == b for ob, oq in zip(base, quant)
                  for a, b in zip(ob, oq))
    if matched / total < 0.99:
        raise ValueError(f"int8 KV pages diverged from the baseline: "
                         f"{matched}/{total} greedy tokens matched (bar "
                         "0.99)")
    if batched != quant:
        raise ValueError("batched admission changed int8 outputs")
    if bps_q * 2 > bps_base:
        raise ValueError(f"int8 pool density below 2x: {bps_q} bytes/slot "
                         f"vs baseline {bps_base}")
    if h1 <= h0:
        raise ValueError("serving.engine.admit_batch never recorded")
    return {"requests": len(prompts), "match_rate": round(matched / total, 4),
            "kv_bytes_per_slot": {"base": bps_base, "int8": bps_q},
            "density_x": round(bps_base / bps_q, 2),
            "admit_batches": int(h1 - h0)}


# -------------------------------------------------------------- cross-silo
def probe_cross_silo_durability_smoke(dev):
    """A 2-silo loopback federation whose server is severed after round 1
    and resumed: the run completes and its final parameters are the
    uninterrupted run's bit for bit."""
    import tempfile

    from .cross_silo.soak import (
        server_kill_restart_soak, uninterrupted_final_params,
    )

    ref, _hist = uninterrupted_final_params(n_clients=2, rounds=3,
                                            device=dev)
    with tempfile.TemporaryDirectory() as d:
        out = server_kill_restart_soak(d, n_clients=2, rounds=3,
                                       kill_after=1, device=dev)
    if out["error"]:
        raise RuntimeError(f"resumed run failed: {out['error']}")
    if [h["round"] for h in out["history"]] != [0, 1, 2]:
        raise ValueError(f"resumed history malformed: {out['history']}")
    def host(v):
        return v.cpu().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)

    if set(ref) != set(out["params"]) or not all(
            np.array_equal(host(ref[k]), host(out["params"][k]))
            for k in ref):
        raise ValueError("resumed final params differ bitwise from the "
                         "uninterrupted run")
    if out["resumes"] < 1:
        raise ValueError("server never recorded a resume")
    return {"rounds": len(out["history"]),
            "recovery_s": round(out["recovery_s"], 3),
            "resumes": out["resumes"],
            "stale_gen_rejected": out["stale_gen_rejected"],
            "generation": out["generation"]}


def probe_fleet_rolling_update_smoke(dev):
    """A 2-replica engine-backed LM deployment under sustained concurrent
    load takes a v1 -> v2 adapter hot swap through the rolling updater:
    zero non-2xx responses (no shedding armed, so none are deliberate),
    both replicas report model_version 2 on /info afterwards, and a
    streamed request completes and records a first-token time."""
    import json as _json
    import urllib.request as _ur

    from .serving.fleet_harness import FleetHarness
    from .utils import metrics as mx

    fleet = FleetHarness(device=dev)   # the probe-lean dims are its defaults
    try:
        gw = fleet.gateway()
        url = f"http://127.0.0.1:{gw.port}/predict"
        results, stop_load = fleet.sustained_load(
            url, 3, {"tokens": fleet.prompt, "max_new_tokens": 4})
        updated, _swap_s = fleet.publish_and_roll(version=2, timeout=30)
        # one streamed request through the gateway records TTFT
        req = _ur.Request(url, data=_json.dumps(
            {"tokens": fleet.prompt, "max_new_tokens": 4,
             "stream": True}).encode(),
            headers={"Content-Type": "application/json"})
        with _ur.urlopen(req, timeout=60) as r:
            body = r.read().decode()
        stop_load(timeout=10)
        versions = fleet.dep.versions()
    finally:
        fleet.close()
    codes = [cd for cd, _lat in results]
    bad = [cd for cd in codes if cd != 200]
    if bad:
        raise ValueError(
            f"rolling update dropped requests: {len(bad)}/{len(codes)} "
            f"non-2xx (codes {sorted(set(bad))})")
    if len(updated) != 2 or any(v != 2 for v in versions.values()):
        raise ValueError(f"fleet did not converge on v2: {versions}")
    if '"done": true' not in body:
        raise ValueError("streamed response never completed")
    snap = mx.snapshot()
    if not snap["histograms"].get("serving.stream_ttft", {}).get("count"):
        raise ValueError("serving.stream_ttft never recorded")
    return {"requests_under_swap": len(codes), "non_2xx": 0,
            "versions": versions,
            "swaps": int(snap["counters"].get("serving.engine.swaps", 0))}


def probe_attribution_smoke(dev):
    """The round-time budget: a round-tagged `train` span around a tracked
    program on the device and loopback traffic; the program's ledger
    FLOPs > 0, the table renders with a transport share > 0, and a 2-slot
    engine's kv_pool ledger bytes agree with its own math within 1%."""
    from .comm.manager import FedCommManager, create_transport
    from .comm.loopback import release_router
    from .comm.message import Message
    from .serving.engine import DecodeEngine
    from .utils import metrics as mx
    from .utils import xla_ledger
    from .utils.attribution import attribute, render_table, \
        rows_from_recorder
    from .utils.events import recorder

    f = xla_ledger.track(lambda a, b: a @ b, "probe_matmul")
    prev = xla_ledger.set_capture(True)     # as a tracked run asks for it
    try:
        with recorder.span("train", round=0):
            x = torch.ones((64, 64), device=dev)
            f(x, x).sum().item()
    finally:
        xla_ledger.set_capture(prev)
    prog = xla_ledger.programs().get("probe_matmul", {})
    if prog.get("flops") != 2 * 64 ** 3:
        raise ValueError(f"the cost ledger captured {prog!r} for a 64^3 "
                         "matmul (want 524288 flops)")
    run = f"diag-attr-{uuid.uuid4().hex[:6]}"
    a = FedCommManager(create_transport("loopback", 0, run), rank=0)
    b = FedCommManager(create_transport("loopback", 1, run), rank=1)
    got: list = []
    b.register_message_receive_handler("probe", lambda m: got.append(m))
    b.run(background=True)
    for _ in range(3):
        a.send_message(Message("probe", 0, 1))
    deadline = time.monotonic() + 5
    while len(got) < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    a.stop()
    b.stop()
    release_router(run)
    if len(got) != 3:
        raise RuntimeError(f"loopback delivered {len(got)}/3")
    eng = DecodeEngine(_tiny_lm(dev), n_slots=2, max_len=32,
                       device=dev).start()
    try:
        eng.submit([1, 2, 3], 4).result(timeout=60)
    finally:
        eng.stop()
    ledger_kv = xla_ledger.buffers().get("kv_pool", 0)
    engine_kv = 2 * mx.snapshot()["gauges"].get(
        "serving.kv_bytes_per_slot", 0)
    if not engine_kv or abs(ledger_kv - engine_kv) / engine_kv > 0.01:
        raise ValueError(
            f"KV ledger disagrees with the engine: ledger {ledger_kv} vs "
            f"engine {engine_kv} (must agree within 1%)")
    att = attribute(rows_from_recorder())
    table = render_table(att)
    share = att["totals"]["transport_share"]
    if "transport%" not in table or share <= 0:
        raise ValueError(f"budget table missing transport share: {share} "
                         f"(table: {table.splitlines()[0]!r})")
    return {"program_flops": prog["flops"], "kv_ledger_bytes": ledger_kv,
            "kv_engine_bytes": engine_kv, "transport_share": share,
            "rounds": len(att["rounds"])}


def probe_live_loop_smoke(dev):
    """A 3-round miniature live loop: 1 silo client federated-training
    LoRA adapters, 1 paged-engine replica serving them behind the
    gateway, loadgen at a low rate and one trainer kill (the server is
    severed after round 1 and resumes from its checkpoint). It must end
    with the fleet hot-swapped to the final round's version and zero
    non-2xx responses (shed 429s excluded), inside 20 s."""
    import tempfile

    from .comm.chaos import FaultSpec
    from .soak.loadgen import TrafficSpec
    from .soak.loop import LiveLoopHarness

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as store, \
            tempfile.TemporaryDirectory() as ckpt:
        h = LiveLoopHarness(
            rounds=3, n_clients=1, n_replicas=1, seed=0,
            store_dir=store, checkpoint_dir=ckpt,
            max_len=32, prefill_chunk=4,
            fault_spec=FaultSpec(silo_kill={0: 1}),
            traffic=TrafficSpec(
                seed=0, vocab=32, rate_rps=8.0, duration_s=20.0,
                stream_frac=0.3, prefix_len=6, suffix_len_max=8,
                out_len_max=6), device=dev)
        try:
            # a 2 s post-convergence traffic tail: the zero-non-2xx bar
            # covers steady-state serving too, not 3 requests
            rep = h.run(timeout=60, tail_s=2.0)
        finally:
            h.close()
    dt = time.perf_counter() - t0
    if rep["non2xx_excl_shed"]:
        raise ValueError(
            f"live loop dropped requests: {rep['non2xx_excl_shed']} "
            f"non-2xx (codes {rep['error_codes']}) — shed 429s "
            "excluded, so these are real failures")
    if not rep["train_done"] or rep["train_error"]:
        raise RuntimeError(
            f"training did not complete: {rep['train_error']}")
    if rep["fleet_version"] != 3 or not rep["converged"]:
        raise ValueError(
            f"fleet never reached the final round's adapters: "
            f"fleet_version {rep['fleet_version']} (want 3), "
            f"versions {rep['fleet_versions']}")
    if len(rep["kills_executed"]) != 1:
        raise ValueError(
            f"trainer kill never fired: {rep['kills_executed']}")
    if dt > 20:
        raise RuntimeError(
            f"live loop smoke took {dt:.1f}s (budget 20s) — the "
            "probe is too slow for the diagnosis battery")
    return {"rounds": rep["rounds_done"],
            "requests": rep["requests"], "ok_requests": rep["ok"],
            "shed_429s": rep["shed_429s"], "non_2xx": 0,
            "fleet_version": rep["fleet_version"],
            "lag_max": rep["lag_max_seen"],
            "kills": rep["kills_executed"],
            "elapsed_s": round(dt, 1)}


def _cohort_sharded_rank(data_dir: str) -> dict:
    """One rank's half of `cohort_sharded_smoke` (the JAX package's
    `_cohort_sharded_check` over the world's ranks): a chunked, streamed
    cohort over a `clients` mesh of every rank against the single-shot
    round, two rounds each."""
    import torch.distributed as dist

    import fedml_tpu_torch
    from .parallel.launch import current
    from .simulation.simulator import Simulator
    from .utils import metrics as mx

    d = dist.get_world_size()
    m = 2 * d

    def sim(extra=None):
        cfg = fedml_tpu_torch.init(config={
            "common_args": {"training_type": "simulation", "random_seed": 0},
            "data_args": {"dataset": "synthetic", "data_cache_dir": data_dir,
                          "extra": {"synthetic_samples_per_client": 8}},
            "model_args": {"model": "lr"},
            "train_args": {"federated_optimizer": "FedAvg",
                           "client_num_in_total": m,
                           "client_num_per_round": m, "comm_round": 2,
                           "epochs": 1, "batch_size": 8,
                           "learning_rate": 0.1, "extra": extra or {}},
            "validation_args": {"frequency_of_the_test": 0},
            "comm_args": {"backend": "xla"}}, device=str(current().device))
        return Simulator(cfg)

    before = mx.snapshot()["counters"]
    chk = sim({"cohort_chunk": d, "ingest_prefetch": 1})
    if chk.mesh is None or chk._d != d:
        raise RuntimeError("chunked sim did not build the client mesh")
    chk.run()
    after = mx.snapshot()["counters"]
    ref = sim()
    ref.run()
    same = ref.history == chk.history and all(
        torch.equal(ref.server_state.params[k], v)
        for k, v in chk.server_state.params.items())
    return {"same": same, "chunks": after.get("fed.ingest.chunks", 0)
            - before.get("fed.ingest.chunks", 0),
            "prefetched": after.get("fed.ingest.prefetched", 0)
            - before.get("fed.ingest.prefetched", 0)}


def probe_cohort_sharded_smoke(dev):
    """A chunked, streamed cohort round over a 2-rank mesh (two spawned
    gloo ranks on `dev`) equals the single-shot 2-rank round bitwise,
    with every chunk streamed and ingest overlapping compute."""
    import tempfile

    from .parallel.launch import RankPool

    with tempfile.TemporaryDirectory() as tmp, \
            RankPool([str(dev)] * 2, timeout_s=180.0) as pool:
        outs = pool.run(_cohort_sharded_rank, tmp)
    if not all(o["same"] for o in outs):
        raise ValueError("chunked round history or params diverged from "
                         "the single-shot round")
    if any(o["chunks"] < 4 for o in outs):   # 2 rounds x 2 chunks a rank
        raise ValueError(f"expected >= 4 streamed chunks a rank: {outs}")
    if not any(o["prefetched"] >= 1 for o in outs):
        raise ValueError("ingest never overlapped compute")
    return {"ranks": 2, "backend": pool.backend,
            "chunks": [o["chunks"] for o in outs],
            "exitcodes": pool.exitcodes,
            "mode": "2 spawned gloo ranks"}


def _partition_base(dev):
    """The probe's base (d_model 64, so that the size rule quantises the
    block kernels): dims, the float state, its int8 form, its adapters."""
    from .llm.lora import lora_init
    from .llm.quant import quantize_tree_int8
    from .llm.transformer import ModelDims, init_params

    dims = ModelDims(vocab_size=64, d_model=64, n_layers=2, n_heads=2,
                     d_ff=128)
    state = init_params(dims, seed=0, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    return (dims, state, quantize_tree_int8(state),
            lora_init(state, rank=2, generator=gen))


def _partition_rank() -> dict:
    """One rank's half of `partition_rules_smoke`: the shapes of its shard
    of the int8 base over an {"mp": 2} mesh."""
    from .llm.quant import flat_state
    from .parallel import partition as part
    from .parallel.launch import current
    from .parallel.mesh import make_mesh

    qbase = _partition_base(current().device)[2]
    sh = flat_state(part.shard_params(qbase, make_mesh({"mp": 2}),
                                      "transformer_lm"))
    return {k: tuple(sh[k].shape) for k in
            ("blocks.0.wq.kernel.q", "blocks.0.wo.kernel.q")}


def probe_partition_rules_smoke(dev):
    """The rule tables resolve the int8 base in both layouts and its
    adapters under the error policy; two gloo ranks shard it over
    {"mp": 2}: wq's columns and wo's rows halve."""
    from .llm.quant import quantize_leaf
    from .parallel import partition as part
    from .parallel.launch import RankPool

    dims, state, qbase, ads = _partition_base(dev)
    specs = part.resolve("transformer_lm", qbase)
    # the JAX package's scan layout: each block leaf stacked [L, ...]
    blocks: dict = {}
    for name in state:
        if name.startswith("blocks.0."):
            *path, leaf = name.split(".")[2:]
            w = torch.stack([state[f"blocks.{i}.{'.'.join(path)}.{leaf}"]
                             for i in range(dims.n_layers)])
            node = blocks
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = (quantize_leaf(w) if leaf == "kernel"
                          else w.to(torch.bfloat16))
    scan = {"blocks": blocks,
            "embed": {"embedding": qbase["embed.embedding"]},
            "final_norm": {"scale": qbase["final_norm.scale"]},
            "lm_head": {"kernel": qbase["lm_head.kernel"]}}
    scan_specs = part.resolve("transformer_lm", scan)
    part.resolve("lora", ads)
    with RankPool([str(dev)] * 2, timeout_s=120.0) as pool:
        outs = pool.run(_partition_rank)
    d = dims.d_model
    for k, o in enumerate(outs):
        if o != {"blocks.0.wq.kernel.q": (d, d // 2),
                 "blocks.0.wo.kernel.q": (d // 2, d)}:
            raise ValueError(f"rank {k} holds {o}, not wq's column half "
                             "and wo's row half")
    return {"resolved_params": len(part._flatten(specs)),
            "resolved_scan_params": len(part._flatten(scan_specs)),
            "wq_spec": str(scan_specs["blocks"]["wq"]["kernel"]["q"]),
            "ranks": 2, "backend": pool.backend,
            "exitcodes": pool.exitcodes, "mode": "2 spawned gloo ranks"}


def probe_lint_clean(dev):
    """graftlint over the whole package tree: zero findings, inside its
    own 20 s budget (pure AST, about a second here)."""
    from .analysis import run_lint

    t0 = time.perf_counter()
    findings, stats = run_lint()
    dt = time.perf_counter() - t0
    if findings:
        raise ValueError(f"{len(findings)} graftlint finding(s); first: "
                         f"{findings[0].format()}")
    if dt > 20:
        raise RuntimeError(f"lint took {dt:.1f}s (budget 20s)")
    return {"files": stats["files"], "rules": len(stats["rules"]),
            "suppressed": stats["suppressed"], "scan_s": round(dt, 3)}


# fleet_obs_smoke's children (they import the comm and telemetry modules
# only, so each starts well inside the probe's 20 s budget). The peers exchange reliable gRPC
# traffic both ways (pings out, pongs back: both clock-offset directions
# get constraints), export their Chrome traces, then serve /metrics and
# block on stdin until the parent is done scraping. The victim arms the
# flight recorder on a fast spill cadence and heartbeats until SIGKILLed.
_FLEET_PEER_SRC = """\
import json, sys, threading, time
from fedml_tpu_torch.comm.manager import FedCommManager
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.comm.grpc_transport import GrpcTransport
from fedml_tpu_torch.comm.reliable import ReliableTransport, RetryPolicy
from fedml_tpu_torch.utils.events import recorder
from fedml_tpu_torch.utils.prometheus import MetricsExporter

rank = {rank}
n = {n}
ipmap = {{0: "127.0.0.1:{port_a}", 1: "127.0.0.1:{port_b}"}}
t = ReliableTransport(
    GrpcTransport(rank, ipmap, port={my_port}),
    RetryPolicy(ack_timeout_s=0.2, max_attempts=20, deadline_s=20.0))
m = FedCommManager(t, rank)
got = set()
done = threading.Event()

def on_msg(msg):
    got.add(msg.get("i"))
    if rank == 1:
        m.send_message(Message("fleet_pong", 1, 0).add("i", msg.get("i")))
    if len(got) >= n:
        done.set()

m.register_message_receive_handler(
    "fleet_ping" if rank == 1 else "fleet_pong", on_msg)
m.run(background=True)
if rank == 0:
    time.sleep(0.4)
    for i in range(n):
        m.send_message(Message("fleet_ping", 0, 1).add("i", i))
ok = done.wait(timeout=20)
recorder.export_chrome_trace(r"{trace}")
exp = MetricsExporter(port=0).start()
print(json.dumps({{"ok": bool(ok), "url": exp.url, "got": len(got)}}),
      flush=True)
sys.stdin.read()
m.stop()
"""

_FLEET_VICTIM_SRC = """\
import json, sys, time
from fedml_tpu_torch.utils import metrics as mx
from fedml_tpu_torch.utils import postmortem
from fedml_tpu_torch.utils.events import recorder
from fedml_tpu_torch.utils.prometheus import MetricsExporter

postmortem.flight.spill_every_s = 0.05
postmortem.arm(r"{run_dir}", process="victim")
mx.inc("victim.steps")
with recorder.span("victim.work", step=0):
    pass
exp = MetricsExporter(port=0).start()
print(json.dumps({{"url": exp.url}}), flush=True)
while True:
    with recorder.span("victim.heartbeat"):
        time.sleep(0.05)
"""


def probe_fleet_obs_smoke(dev):
    """The fleet-observability plane end to end, on real processes (the
    JAX probe's legs; see the module docstring). Runs on the host: `dev`
    is not used."""
    import os
    import signal
    import socket
    import subprocess
    import tempfile

    from .comm.grpc_transport import _import_grpc
    from .utils.obsfleet import (FleetCollector, load_trace, merge_traces,
                                 verify_merged_order)
    from .utils.postmortem import POSTMORTEM_FILE, load_postmortem
    from .utils.prometheus import parse_prometheus, split_by_label

    _import_grpc()     # the peers' transport: an ImportError naming grpc
    t0 = time.perf_counter()

    def free_port():
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        p = s.getsockname()[1]
        s.close()
        return p

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [root] + ([os.environ["PYTHONPATH"]]
                  if os.environ.get("PYTHONPATH") else []))}
    pa, pb = free_port(), free_port()

    def spawn(src):
        return subprocess.Popen([sys.executable, "-c", src], env=env,
                                stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    def ready_line(p, timeout=30):
        out: list = []
        th = threading.Thread(target=lambda: out.append(p.stdout.readline()),
                              daemon=True)
        th.start()
        th.join(timeout)
        if not out or not out[0]:
            err = (p.stderr.read()[-400:] if p.poll() is not None
                   else "(still running)")
            raise TimeoutError(f"child never reported ready: {err}")
        return json.loads(out[0])

    n = 4
    with tempfile.TemporaryDirectory() as d:
        tr_a = os.path.join(d, "a.trace.json")
        tr_b = os.path.join(d, "b.trace.json")
        victim_dir = os.path.join(d, "victim")
        procs = [
            spawn(_FLEET_PEER_SRC.format(rank=0, n=n, port_a=pa, port_b=pb,
                                         my_port=pa, trace=tr_a)),
            spawn(_FLEET_PEER_SRC.format(rank=1, n=n, port_a=pa, port_b=pb,
                                         my_port=pb, trace=tr_b)),
            spawn(_FLEET_VICTIM_SRC.format(run_dir=victim_dir))]
        try:
            ready = [ready_line(p) for p in procs]
            if not (ready[0]["ok"] and ready[1]["ok"]):
                raise RuntimeError(f"peer exchange failed: {ready[:2]}")
            coll = FleetCollector({"peer_a": ready[0]["url"],
                                   "peer_b": ready[1]["url"],
                                   "victim": ready[2]["url"]})
            ok = coll.scrape_once()
            if not all(ok.values()):
                raise RuntimeError(f"scrape failed: {ok}")
            agg = parse_prometheus(coll.aggregated_text())
            per = {k: v for k, v in split_by_label(agg, "process").items()
                   if k}
            if sorted(per) != ["peer_a", "peer_b", "victim"]:
                raise ValueError("aggregated /metrics missing process "
                                 f"labels: {sorted(per)}")
            vs = per["victim"]["counters"].get("victim_steps_total")
            if not vs:
                raise ValueError("victim counter absent from the "
                                 "aggregated view")
            # the victim's inflight spill must exist before the kill:
            # SIGKILL runs no handler, the spill is all that survives
            pm_path = os.path.join(victim_dir, POSTMORTEM_FILE)
            deadline = time.monotonic() + 10
            while (not os.path.exists(pm_path)
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            if not os.path.exists(pm_path):
                raise TimeoutError(
                    "victim never spilled an inflight postmortem")
            procs[2].send_signal(signal.SIGKILL)
            procs[2].wait(timeout=10)
            coll.scrape_once()     # a dead endpoint -> the stale mark
            fsnap = coll.fleet_snapshot()
            if not fsnap["processes"]["victim"]["stale"]:
                raise ValueError("SIGKILLed victim not marked stale")
            pm = load_postmortem(victim_dir)
            if pm is None or "hard-kill" not in pm["reason"]:
                raise ValueError("postmortem unreadable or wrong reason: "
                                 f"{pm and pm.get('reason')}")
            if not str(pm["last_span"] or "").startswith("victim."):
                raise ValueError(f"postmortem last span {pm['last_span']!r}")
            for p in procs[:2]:    # the peers exit when stdin closes
                p.stdin.close()
            for p in procs[:2]:
                p.wait(timeout=15)
            res = merge_traces([("peer_a", tr_a), ("peer_b", tr_b)],
                               out_path=os.path.join(d, "merged.trace.json"))
            if res["flows"] < 1:
                raise ValueError(f"no stitched send->handle flow: {res}")
            bad = verify_merged_order(load_trace(res["out"]))
            if bad:
                raise ValueError(f"{bad} flow(s) violate corrected ordering")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait(timeout=10)
    dt = time.perf_counter() - t0
    if dt > 20:
        raise RuntimeError(f"fleet obs smoke took {dt:.1f}s (budget 20s)")
    return {"processes": sorted(per), "victim_steps": int(vs),
            "flows": res["flows"], "order_violations": 0,
            "clock_skew_ms": res["clock_skew_ms"],
            "clamped": res["clamped"], "postmortem_reason": pm["reason"],
            "last_span": pm["last_span"], "elapsed_s": round(dt, 1)}


PROBES = {
    "cuda": probe_cuda,
    "kernels": probe_kernels,
    "wire_codec": probe_wire_codec,
    "loopback_transport": probe_loopback_transport,
    "grpc_transport": probe_grpc_transport,
    "native_lib": probe_native_lib,
    "metrics_endpoint": probe_metrics_endpoint,
    "chaos_smoke": probe_chaos_smoke,
    "codec_smoke": probe_codec_smoke,
    "serving_engine_smoke": probe_serving_engine_smoke,
    "serving_paged_smoke": probe_serving_paged_smoke,
    "serving_spec_smoke": probe_serving_spec_smoke,
    "serving_density_smoke": probe_serving_density_smoke,
    "fleet_rolling_update_smoke": probe_fleet_rolling_update_smoke,
    "cross_silo_durability_smoke": probe_cross_silo_durability_smoke,
    "live_loop_smoke": probe_live_loop_smoke,
    "attribution_smoke": probe_attribution_smoke,
    "cohort_sharded_smoke": probe_cohort_sharded_smoke,
    "partition_rules_smoke": probe_partition_rules_smoke,
    "lint_clean": probe_lint_clean,
    "fleet_obs_smoke": probe_fleet_obs_smoke,
}


def run_battery(only=None, device=None) -> int:
    """Run the selected probes (all by default) on `device`; print the
    report; 0 iff every required probe that ran passed, 2 for an unknown
    probe name."""
    selected = list(only) if only else list(PROBES)
    unknown = sorted(set(selected) - set(PROBES))
    if unknown:
        print(f"unknown probe(s) {unknown}; available: {sorted(PROBES)}",
              file=sys.stderr)
        return 2
    dev = resolve_device(device)
    checks: dict = {}
    not_run: dict = {}
    for name, fn in PROBES.items():
        if name not in selected:
            continue
        t0 = time.perf_counter()
        try:
            checks[name] = {"ok": True, **(fn(dev) or {})}
        except NotRun as e:
            not_run[name] = str(e)
            continue
        except Exception as e:  # noqa: BLE001 — each probe reports
            checks[name] = {"ok": False,
                            "error": f"{type(e).__name__}: {e}"[:300]}
        checks[name]["seconds"] = round(time.perf_counter() - t0, 3)
    required_ok = all(checks[k]["ok"] for k in REQUIRED if k in checks)
    print(json.dumps({"ok": required_ok, "device": str(dev),
                      "checks": checks, "not_run": not_run}, indent=2))
    return 0 if required_ok else 1
