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
  loopback traffic, with a transport share > 0.

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
            "attribution_smoke")


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
    """The round-time budget: a round-tagged `train` span around device
    work and loopback traffic; the table renders with a transport share
    > 0."""
    from .comm.manager import FedCommManager, create_transport
    from .comm.loopback import release_router
    from .comm.message import Message
    from .utils.attribution import attribute, render_table, \
        rows_from_recorder
    from .utils.events import recorder

    with recorder.span("train", round=0):
        x = torch.ones((64, 64), device=dev)
        (x @ x).sum().item()
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
    att = attribute(rows_from_recorder())
    table = render_table(att)
    share = att["totals"]["transport_share"]
    if "transport%" not in table or share <= 0:
        raise ValueError(f"budget table missing transport share: {share} "
                         f"(table: {table.splitlines()[0]!r})")
    return {"transport_share": share, "rounds": len(att["rounds"])}


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
