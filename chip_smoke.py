#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`fedml_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --only kernel   # a subset of phases

Phases, each printing one JSON line (a failing phase raises and the script
exits non-zero; nothing is caught and carried past):

1. device  - the card's name and `nvidia-smi` name / power limit.
2. build   - nvcc builds every kernel under fedml_tpu_torch/csrc (seconds).
3. kernel  - the paged-attention kernel against its plain PyTorch version at
             the LLaMA-2-7B attention width (H=32, Dh=128, page_size=16,
             S=8 slots, 128-entry page tables over a 1100-page pool; mixed
             positions, null-page entries past each reservation, C in
             {1, 5}) for f32, bf16 and int8 pools; then CUDA-event medians
             of the kernel, the plain version, the library yardstick and the
             HBM bound at C=1.
4. engine  - LLaMA-2-7B width in f32 (seeded random weights, TF32 off): the
             kernel engine and the gather engine, on the same weights, serve
             10 greedy requests (prompts 40-600 tokens, two sharing a
             256-token prefix, more requests than slots); token identity
             under the near-tie rule, full budgets, a prefix hit, the free
             list back to budget, and kernel launches == layers x steps.
5. serve   - the same requests in bf16 through the kernel engine with a bf16
             pool and with an int8 pool: decode tokens/s, TTFT p50, the int8
             engine's greedy match rate against bf16 (printed, not gated:
             the weights are random), kernel launches.

Then the `kernels` line, the raw `nvidia-smi` name/power-limit line, and as
the last line {"ok": true, "device": {...}}. Imports nothing of JAX or of
the JAX package; without a CUDA device it exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
import time

import numpy as np

PHASES = ("device", "build", "kernel", "engine", "serve")
OPTIONAL = ("profile",)   # run only when named in --only
DEV = "cuda"

# the kernel check's shapes: LLaMA-2-7B attention at the engine's page size
H, DH, PS, S_CHECK, MP_CHECK, P_CHECK = 32, 128, 16, 8, 128, 1100
# engine shapes (phases 4-5)
N_SLOTS, MAX_LEN, PREFILL_CHUNK = 8, 1024, 256
# tolerances of the kernel against its plain version. f32: both sum the
# same f32 products in a different order (~1e-7 relative per sum). bf16 and
# int8 (dequantised to bf16): the order differences can flip the bf16
# rounding of p before P.V and of the output (2^-8 relative).
TOL = {"f32": 1e-5, "bf16": 2e-2, "int8": 2e-2}
NEAR_TIE = 1e-3   # top-2 logit margin under which a flipped argmax is a tie


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def hbm_bytes_per_s(name: str) -> tuple[float, str]:
    """Data-sheet HBM bandwidth for the card's name."""
    n = name.upper()
    if "H200" in n:
        return 4.8e12, "H200 SXM data sheet"
    if "H100" in n and "PCIE" in n:
        return 2.0e12, "H100 PCIe data sheet"
    if "H100" in n and "NVL" in n:
        return 3.9e12, "H100 NVL data sheet"
    return 3.35e12, "H100 SXM data sheet"


def peak_flops(dtype) -> float:
    """Dense peak for the operand type (f32 outside the tensor cores)."""
    import torch

    return 67e12 if dtype == torch.float32 else 989e12


def time_ms(fn, n: int = 60, warmup: int = 5) -> float:
    """Median CUDA-event time of one call. L2 is flushed before each call
    and the GPU is kept busy while the host enqueues it, so the window
    holds the call's device work and not the host's launch latency."""
    import torch

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ------------------------------------------------------------------ phase 3
def _kernel_case(rng, c: int, kind: str):
    """Random pool, page tables and positions at the check shapes."""
    import torch

    dev = DEV
    qdt = torch.float32 if kind == "f32" else torch.bfloat16
    n_res = [128, 96, 64, 64, 40, 17, 8, 2]         # pages reserved per slot
    perm = rng.permutation(np.arange(1, P_CHECK))
    pages = np.zeros((S_CHECK, MP_CHECK), np.int32)  # 0 = the null page
    at = 0
    for s, n in enumerate(n_res):
        pages[s, :n] = perm[at:at + n]
        at += n
    pos = np.array([rng.integers(0, n * PS - c + 1) for n in n_res],
                   np.int32)
    pos[0] = MP_CHECK * PS - c     # the table's last position
    pos[7] = 0                     # one live row
    pos[3] = 20                    # 64 pages reserved, 2 live: skips 62
    shape = (P_CHECK, PS, H, DH)
    if kind == "int8":
        k = torch.from_numpy(rng.integers(-127, 128, shape, np.int8))
        v = torch.from_numpy(rng.integers(-127, 128, shape, np.int8))
        ks = torch.from_numpy(rng.uniform(0.005, 0.02, (P_CHECK, H))
                              .astype(np.float32))
        vs = torch.from_numpy(rng.uniform(0.005, 0.02, (P_CHECK, H))
                              .astype(np.float32))
        scales = (ks.to(dev), vs.to(dev))
    else:
        k = torch.from_numpy(rng.standard_normal(shape, np.float32)).to(qdt)
        v = torch.from_numpy(rng.standard_normal(shape, np.float32)).to(qdt)
        scales = (None, None)
    q = torch.from_numpy(
        rng.standard_normal((S_CHECK, c, H, DH), np.float32)).to(qdt)
    return (q.to(dev), k.to(dev), v.to(dev), torch.from_numpy(pages).to(dev),
            torch.from_numpy(pos).to(dev)) + scales


def _case_cost(q, k, pages, pos, scales_on: bool):
    """(bytes, flops) the call must move/do for THESE positions: each live
    page's K and V slab for every head once, its scales, q, out, the live
    page-table entries and pos."""
    s_, c, h, dh = q.shape
    live = ((pos.long() + c - 1) // PS + 1).clamp(max=pages.shape[1])
    n_live = int(live.sum())
    slab = PS * h * dh * k.element_size()
    nbytes = 2 * n_live * slab + 2 * q.numel() * q.element_size() \
        + n_live * 4 + s_ * 4 + (2 * n_live * h * 4 if scales_on else 0)
    flops = 4 * c * h * dh * n_live * PS
    return nbytes, flops


def phase_kernel(bw: float) -> dict:
    import torch
    import torch.nn.functional as F

    from fedml_tpu_torch.ops import paged_attention as pa

    rng = np.random.default_rng(0)
    out = {}
    for kind in ("f32", "bf16", "int8"):
        errs = []
        for c in (1, 5):
            q, k, v, pages, pos, ks, vs = _kernel_case(rng, c, kind)
            got = pa.paged_attention(q, k, v, pages, pos, ks, vs)
            ref = pa.paged_attention_ref(q, k, v, pages, pos, ks, vs)
            torch.cuda.synchronize()
            check(torch.isfinite(got).all().item(), f"{kind} C={c}: non-finite")
            err = (got.float() - ref.float()).abs().max().item()
            rel = err / ref.float().abs().max().item()
            errs.append(err)
            emit({"phase": "kernel", "pool": kind, "C": c, "max_abs_err": err,
                  "max_rel_err": rel, "tol": TOL[kind]})
            check(err <= TOL[kind], f"{kind} C={c}: max abs err {err} > "
                  f"{TOL[kind]}")
            if c != 1:
                continue
            # timing at the decode step's C=1
            ms = time_ms(lambda: pa.paged_attention(q, k, v, pages, pos, ks,
                                                    vs))
            plain_ms = time_ms(lambda: pa.paged_attention_ref(
                q, k, v, pages, pos, ks, vs), n=50, warmup=2)
            # library yardstick: SDPA on PRE-GATHERED contiguous K/V (gather
            # and dequant excluded from the time), the same causal mask
            n_pg = int(((pos.long() + c - 1) // PS + 1).max())
            idx = pages[:, :n_pg].long()

            def gathered(pool, sc):
                g = pool[idx]
                if sc is not None:
                    g = (g.float() * sc[idx][:, :, None, :, None]).to(q.dtype)
                return g.reshape(S_CHECK, n_pg * PS, H, DH).transpose(
                    1, 2).contiguous()

            kk, vv = gathered(k, ks), gathered(v, vs)
            qq = q.transpose(1, 2).contiguous()
            vpos = torch.arange(n_pg * PS, device=DEV)
            mask = (vpos[None, None, None, :]
                    <= (pos.long()[:, None] + torch.arange(
                        c, device=DEV))[:, None, :, None])
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qq, kk, vv, attn_mask=mask))
            nbytes, flops = _case_cost(q, k, pages, pos, ks is not None)
            t_bytes = nbytes / bw * 1e3
            t_ops = flops / peak_flops(q.dtype) * 1e3
            out[kind] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                         "bound_ms": max(t_bytes, t_ops),
                         "bound_by": "bytes" if t_bytes >= t_ops
                         else "operations",
                         "bytes": nbytes, "flops": flops}
            emit({"phase": "kernel", "pool": kind, "C": c, **out[kind]})
        out[kind]["max_abs_err"] = max(errs)
        del q, k, v
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------- phases 4-5
def _requests(vocab: int, seed: int = 1):
    """10 greedy requests: prompts 40-600 tokens, the first and the last
    sharing a 256-token prefix (the last queues behind 8 slots, so it is
    admitted after the first registered its pages), budgets 16-48."""
    rs = np.random.RandomState(seed)
    shared = rs.randint(1, vocab, 256).tolist()
    lens = [40, 600, 40, 120, 333, 75, 480, 150, 64, 90]
    news = [16, 48, 32, 24, 40, 16, 20, 48, 28, 32]
    prompts = [rs.randint(1, vocab, n).tolist() for n in lens]
    prompts[0] = shared + prompts[0]
    prompts[9] = shared + prompts[9]
    return list(zip(prompts, news))


def _wave(eng, reqs):
    """Submit every request at once, wait for all; returns (token lists,
    stats)."""
    t0 = time.perf_counter()
    tickets = [eng.submit(p, n) for p, n in reqs]
    outs = [t.result(timeout=600) for t in tickets]
    t1 = time.perf_counter()
    first = min(t.t_first for t in tickets)
    last = max(t.t_done for t in tickets)
    n_tok = sum(len(o) for o in outs)
    return outs, {
        "wall_s": t1 - t0,
        "tokens": n_tok,
        "tokens_per_s": n_tok / (t1 - t0),
        # tokens after each request's first, over the window from the
        # first first-token to the last completion
        "decode_tokens_per_s": (n_tok - len(reqs)) / (last - first),
        "ttft_p50_s": statistics.median(t.t_first - t.t_submit
                                        for t in tickets),
    }


def _engine(model, **kw):
    from fedml_tpu_torch.serving.engine import DecodeEngine

    return DecodeEngine(model, n_slots=N_SLOTS, max_len=MAX_LEN,
                        page_size=PS, prefill_chunk=PREFILL_CHUNK,
                        device=DEV, **kw).start()


def _serve(model, reqs, **kw) -> tuple[list, dict]:
    """One engine over `model`: warm it up, then serve `reqs` with the
    kernel launch count and prefix hits read around the wave."""
    import torch

    from fedml_tpu_torch.ops import paged_attention as pa
    from fedml_tpu_torch.utils import metrics as mx

    eng = _engine(model, **kw)
    try:
        eng.submit(list(range(1, 33)), 4).result(timeout=600)   # warm-up
        hits0 = mx.snapshot()["counters"].get("serving.prefix_hits", 0)
        steps0 = eng.decode_steps
        pa.launch_count = 0
        outs, stats = _wave(eng, reqs)
        stats["launches"] = pa.launch_count
        stats["decode_steps"] = eng.decode_steps - steps0
        stats["prefix_hits"] = (mx.snapshot()["counters"]
                                .get("serving.prefix_hits", 0) - hits0)
        # every page is free again or a resident prefix page nobody holds
        stats["pool_back_to_budget"] = (
            len(eng._free_pages) + len(eng._prefix) == eng._usable
            and all(e.refs == 0 for e in eng._prefix.values()))
    finally:
        eng.stop()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return outs, stats


def _top2_margin(model, tokens) -> float:
    import torch

    with torch.no_grad():
        lg = model(torch.tensor([tokens], device=DEV))[0, -1].float()
    top = torch.topk(lg, 2).values
    return float(top[0] - top[1])


def _near_tie_identical(model, reqs, ref_outs, outs) -> dict:
    """Token identity under the near-tie rule: identical streams pass; a
    stream whose first difference sits where the reference's top-2 margin
    is below NEAR_TIE passes (nothing after it is checked); anything else
    fails."""
    ties = []
    for i, ((prompt, _n), a, b) in enumerate(zip(reqs, ref_outs, outs)):
        if a == b:
            continue
        j = next((k for k in range(min(len(a), len(b))) if a[k] != b[k]),
                 None)
        check(j is not None, f"request {i}: lengths {len(a)} vs {len(b)}")
        margin = _top2_margin(model, prompt + a[:j])
        emit({"phase": "engine", "near_tie": {"request": i, "pick": j,
                                              "margin": margin}})
        check(margin < NEAR_TIE, f"request {i} differs at pick {j} with "
              f"top-2 margin {margin} >= {NEAR_TIE}")
        ties.append(i)
    return {"identical": len(reqs) - len(ties), "near_ties": ties}


def phase_engine(reqs) -> dict:
    import torch

    from fedml_tpu_torch.llm.transformer import (
        LLAMA2_7B, TransformerLM, init_params,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    model = TransformerLM.from_state(
        LLAMA2_7B, init_params(LLAMA2_7B, seed=0, dtype=torch.float32,
                               device=DEV))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    outs_k, st_k = _serve(model, reqs, paged_kernel=True)
    outs_g, st_g = _serve(model, reqs, paged_kernel=False)
    ident = _near_tie_identical(model, reqs, outs_g, outs_k)
    L = LLAMA2_7B.n_layers
    emit({"phase": "engine", "dtype": "float32", "init_s": init_s,
          "kernel": st_k, "gather": st_g, **ident})
    for outs, st in ((outs_k, st_k), (outs_g, st_g)):
        check(all(len(o) == n for o, (_p, n) in zip(outs, reqs)),
              "a ticket ended short of max_new_tokens")
        check(st["prefix_hits"] >= 1, "no prefix hit")
        check(st["pool_back_to_budget"], "pages leaked")
    check(st_k["launches"] == L * st_k["decode_steps"] > 0,
          f"kernel launches {st_k['launches']} != {L} x "
          f"{st_k['decode_steps']} decode steps")
    check(st_g["launches"] == 0, "the gather engine launched the kernel")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return st_k


def phase_serve(reqs) -> dict:
    import torch

    from fedml_tpu_torch.llm.transformer import (
        LLAMA2_7B, TransformerLM, init_params,
    )

    model = TransformerLM.from_state(
        LLAMA2_7B, init_params(LLAMA2_7B, seed=0, dtype=torch.bfloat16,
                               device=DEV))
    outs_b, st_b = _serve(model, reqs, paged_kernel=True)
    outs_q, st_q = _serve(model, reqs, paged_kernel=True, kv_quant="int8")
    same = sum(x == y for a, b in zip(outs_b, outs_q) for x, y in zip(a, b))
    match = same / sum(len(a) for a in outs_b)
    emit({"phase": "serve", "dtype": "bfloat16", "bf16_pool": st_b,
          "int8_pool": st_q, "int8_greedy_match_rate": match})
    L = LLAMA2_7B.n_layers
    for outs, st in ((outs_b, st_b), (outs_q, st_q)):
        check(all(len(o) == n for o, (_p, n) in zip(outs, reqs)),
              "a ticket ended short of max_new_tokens")
        check(st["launches"] == L * st["decode_steps"] > 0,
              "kernel launches != layers x decode steps")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"bf16": st_b, "int8": st_q}


def phase_profile(reqs, top: int = 15) -> None:
    """Where a bf16 wave's device time goes: torch.profiler over the
    kernel engine serving `reqs` (after a warm-up request); device time per
    kernel name, the device-busy share of the wave's wall time, and the
    time per decode step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fedml_tpu_torch.llm.transformer import (
        LLAMA2_7B, TransformerLM, init_params,
    )

    model = TransformerLM.from_state(
        LLAMA2_7B, init_params(LLAMA2_7B, seed=0, dtype=torch.bfloat16,
                               device=DEV))
    eng = _engine(model, paged_kernel=True)
    try:
        eng.submit(list(range(1, 33)), 4).result(timeout=600)
        steps0 = eng.decode_steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _outs, stats = _wave(eng, reqs)
            torch.cuda.synchronize()
        steps = eng.decode_steps - steps0
    finally:
        eng.stop()
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[2])
    busy_ms = sum(r[2] for r in rows)
    wall_ms = stats["wall_s"] * 1e3
    emit({"phase": "profile", "dtype": "bfloat16", "wall_ms": wall_ms,
          "device_busy_ms": busy_ms, "device_idle_share": 1 - busy_ms / wall_ms,
          "decode_steps": steps, "wall_ms_per_step": wall_ms / steps,
          "top": [{"name": k[:90], "calls": n, "device_ms": ms,
                   "share_of_busy": ms / busy_ms}
                  for k, n, ms in rows[:top]]})
    del model, eng
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", choices=PHASES + OPTIONAL,
                    default=PHASES, help="run only these phases (device and "
                    "build always run; profile only when named)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this smoke run needs one "
              "GPU", file=sys.stderr)
        return 2
    from fedml_tpu_torch.ops import _build

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    bw, bw_src = hbm_bytes_per_s(name)
    emit({"phase": "device", "name": name, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "hbm_bytes_per_s": bw,
          "hbm_source": bw_src})

    t0 = time.perf_counter()
    reports = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {k: [ln.strip() for ln in v.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for k, v in reports.items()}})

    kern = phase_kernel(bw) if "kernel" in args.only else {}
    reqs = _requests(32000)
    runs = {}   # pool kind -> the main-path wave that used it
    if "engine" in args.only:
        runs["f32"] = phase_engine(reqs)
    if "serve" in args.only:
        runs.update(phase_serve(reqs))
    if "profile" in args.only:
        phase_profile(reqs)

    kernels = []
    for kind, k in kern.items():
        run = runs.get(kind, {"launches": 0, "decode_steps": 0})
        kernels.append({
            "name": f"paged_attention_{kind}", "route": "cuda",
            "source": "fedml_tpu_torch/csrc/paged_attention.cu",
            "replaces": "fedml_tpu/ops/paged_attention.py:84",
            "launches": run["launches"],
            "launches_per_decode_step":
                run["launches"] / max(run["decode_steps"], 1),
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"]})
    if set(PHASES) <= set(args.only):
        check(all(k["launches"] > 0 for k in kernels),
              "a kernel of the main path was never launched")
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
