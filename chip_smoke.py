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
             {1, 5}) for f32, bf16 and int8 pools, each (s, c, h) row's
             error relative to that row's magnitude; then CUDA-event medians
             of the kernel, the plain version, the library yardstick and the
             HBM bound at C=1, and of the kernel at the serve shape phase
             `serve` gives it (64-entry tables, the wave's reservations) at
             C=1 and at the speculative window's C=5, checked there too.
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
6. serve_surface - the serving surface at LLaMA-2-7B width. In f32 at
             full width and 4 layers (TF32 off; width is not cut, depth is,
             to keep the phase short): spec-on (spec_k 4, K4 at C = 5) vs
             spec-off, admit_batch 4 vs 1, an engine with rank-8 adapters
             (nonzero B) vs one over the lora_merge'd weights, the
             contiguous layout vs paged, the per-request path vs the
             engine, and FedMLInferenceRunner's 10 concurrent answers vs
             direct submits, all under the near-tie rule, plus one SSE
             stream equal to its JSON answer and /ready, /info. In bf16 at
             full depth: the spec-on wave's decode tokens/s, TTFT p50 and
             accept rate against spec-off, K4 launches by C (all at C = 5);
             admit_batch 4's TTFT p50; rank-8 adapters hot-swapped mid-wave
             (version 0 -> 1, every ticket finishes, a mismatched swap
             refused) and the peak memory; then the main path: the runner
             over GreedyLMPredictor (8 slots, paged, kernel, spec,
             adapters), 10 concurrent POSTs, each answered 200 and in
             full, with the K4 counts zeroed just before and read after.
7. flash   - the flash-attention kernels (K1 forward, K2 dQ, K3 dK/dV: the
             tensor-core kernels in bf16; in f32 the three-pass TF32
             tensor-core kernels) against their plain versions at the shape
             phase train gives them (BH = 2 x 32, T = 2048, D = 128) in f32
             and bf16, each row's error relative to that row's magnitude;
             CUDA-event medians of each kernel, of the forward and the
             backward, of the plain versions and of the library yardsticks
             (SDPA's forward, and its backward alone, which computes dQ, dK
             and dV together), and each kernel's bound. Then heads of D 40
             in f32 and bf16, which every pass takes on the 64-column
             instance of the same tensor-core kernels, checked and timed
             the same way at BH 4, T 256 and at the flagship BH 64,
             T 2048.
8. train   - federated LoRA at full LLaMA-2-7B width and depth (bf16 base,
             rank 8 on wq/wk/wv/wo, per-block remat, flash attention, bf16
             compute): two FedAvg rounds of 2 clients x 4 sequences x 2048
             tokens; losses finite, every adapter moved, the base bitwise
             unchanged, launches K1 = 2 x layers x steps and K2 = K3 =
             layers x steps, all through the tensor-core kernels. Then an
             f32 round at full width and 2 layers (TF32 off for cuBLAS) with
             flash (the three-pass TF32 forward, dQ and dK/dV, and only
             they) and with dense attention from the same adapters and
             batch schedule: the adapters agree.
9. fedavg  - the FedAvg simulation path at bench.py's flagship shape
             (`_flagship_config`: 100 clients of synthetic CIFAR-10, 96
             samples each, Dirichlet alpha 0.5, all 100 per round, batch
             32, 1 epoch, lr 0.05, resnet18_gn, bf16 compute, health stats
             on): first one f32 round of 4 clients on the card and on the
             CPU from the same parameters and batch schedule (TF32 off),
             within 1e-3 of the CPU round's largest update or, where f32
             itself departs further from the f64 round, as close to the
             f64 round as the CPU's f32 round (`_fedavg_parity`); then,
             through
             `fedml_tpu_torch.init` and the Simulator, a warm round and a
             timed one (rounds/s, ms per round and per local step, peak
             memory, losses, conv + matmul FLOPs and their share of the
             bf16 peak), the loss falling, then one eval. No K1-K4 launch.
10. fedsim - the rest of the round engine (vmapped client groups,
             SCAFFOLD / FedDyn / Mime, round blocks, cohort chunks,
             checkpoint and resume), vmap's per-example fallback an
             error: the f32 4-client round through the Simulator twice in
             this process and once in a child process, bitwise the same
             (sha256 of parameters and metrics; G = 4 twice too); one
             local step of that round on the card within 1e-3 of the
             CPU's largest update, and at G = 4 within 1e-3 of G = 1;
             the flagship at G = 1 (one timed round, after a warm one
             unless phase fedavg ran the same round in this process),
             G = 4 (the determinism setting on and off, a round each)
             and G = 10 (a warm round and a timed one): ms a round and a
             group step, rounds/s, peak memory, the loss falling;
             SCAFFOLD, FedDyn and Mime one round each at the flagship
             with G = 10, and SCAFFOLD over 12 clients, 5 a round,
             leaving unsampled states bitwise alone; at the flagship
             model over 8 clients, a block of 4 rounds, cohort chunks of
             4 and a SCAFFOLD run resumed from its checkpoint, each
             bitwise its one-at-a-time, single-shot or
             uninterrupted run. No K1-K4 launch.
11. plugins - the round's plugins at the flagship shape (100 clients,
             ResNet-18-GN, synthetic CIFAR-10, bf16, G = 10): the plain
             round, then (a) multikrum (f = 10) against a byzantine random
             attack on 10 clients, (b) wise_median under chaos dropout 0.1
             and straggler 0.05, (c) FoolsGold with its [100, D] history,
             (d) LDP Gaussian (clip 1.0) after top-k 0.05, (e) EF-TopK
             0.05: a warm round and PLUGIN_ROUNDS timed ones each, ms a
             round, the plugin's own ms (its hooks between CUDA events),
             peak memory, the losses finite. Then a 4-client f32 round of
             one local step with krum, dp_clip and top-k on the card and
             on the CPU from one parameter draw and schedule (TF32 off):
             the training within 1e-3 of the CPU's largest update, the
             plugins fed the same updates within 1e-6 (top-k flips coordinates at its threshold:
             `_plugin_parity`); and (b)
             over 8 clients in cohort chunks of 4, bitwise its
             single-shot run. No K1-K4 launch.
12. cross_silo - cross-silo FedAvg over the message layer through
             `FedMLRunner(training_type: cross_silo)`: (a) the flagship
             shape as one server and 100 client runners over loopback in
             this process (100 silos of the non-IID synthetic CIFAR-10
             shards, all 100 a round, ResNet-18-GN, batch 32, 1 epoch, lr
             0.05, bf16), a warm round and CS_ROUNDS timed: ms a round
             (the median), the clients' `train` spans (sum and largest),
             the wire's serialise / deserialise seconds, bytes and frames
             a round, the aggregate's ms (CUDA events), peak memory,
             every round receiving 100 results; then the port
             Simulator's G = 1 round at the same shape for comparison.
             (b) A 4-silo f32 federation (silos of 32, 48, 64 and 96
             N(0, 1) images at the same shape, so that the aggregate's
             weights differ; 2 rounds of one local step of 32, one CPU
             parameter draw and numpy batch orders, TF32 off) on the card
             and on the CPU: within 1e-3 of the CPU's largest update; and
             each of its rounds on the card against the port Simulator's
             run_round from the same params and batch orders, within
             1e-5 of the round's largest update (the only difference is
             the aggregate's order of summation). Reported beside it, not
             held to 1e-5: the Simulator's 2 rounds chained from the
             federation's start, and how far the Simulator's own round 1
             moves between the two starts. (c) That federation twice,
             bitwise; `server_kill_restart_soak` bitwise
             `uninterrupted_final_params` on the card. (d) It under a
             chaos plan (drop, duplicate, reorder 0.1 each) with
             `comm_retry`, bitwise (c)'s clean run. No K1-K4 launch.
13. cross_silo_secure - the rest of cross-silo over the message layer:
             (a) SecAgg (`train_args.extra.secagg`, field_pack on the
             masked uploads) at the flagship width over the first
             SA_SILOS = 10 shards (each client draws SA_SILOS PRG masks
             of 11.17 M entries a round: the cut), bf16, a warm round and
             a timed one (one round when phase cross_silo warmed the
             shapes in this process): ms a round, a client's mask ms,
             the unmask ms, the masked bytes raw and packed, peak
             memory; the unmasked
             aggregate bitwise dequantize(sum quantize(vec_i n_i/N)) /
             (sum n_i/N) of the silos' own trained vectors and within
             n x 2^-16 of their float weighted mean. (b) On phase
             cross_silo's 4-silo f32 federation: silo 4 stops after
             setup, round_timeout drops it and its sk is rebuilt, the
             round within 3 x 2^-16 / (sum n_i/N) of a FedServerManager
             round over the survivors; silo 4 stopped and silo 3 mute on
             the unmask request fail the run loudly; the server severed
             after round 0 and resumed from its checkpoint, bitwise an
             uninterrupted run. (c) The flagship as 100 silos with
             bench.py's codec (sparse_topk 0.12, val_bits 16, error
             feedback), a warm round and a timed one (as (a)): bytes raw
             and on the wire, the reduction (the codec's arithmetic
             exactly, 5.59x here), encode / decode ms p50, the round's
             ms beside phase cross_silo's dense round, 100 results and no frame
             dropped. (d) The 4-silo federation over broker and web3,
             `run_cross_cloud` with a late join and cross-device dense,
             each bitwise the loopback run; cross-device with
             uplink_topk; a flaky device dropped from the registry. No
             K1-K4 launch.

Then the `kernels` line, the raw `nvidia-smi` name/power-limit line, and as
the last line {"ok": true, "device": {...}}. Imports nothing of JAX or of
the JAX package; without a CUDA device it exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np

PHASES = ("device", "build", "kernel", "engine", "serve", "serve_surface",
          "flash", "train", "fedavg", "fedsim", "plugins", "cross_silo",
          "cross_silo_secure")
# run only when named in --only
OPTIONAL = ("profile", "train_profile", "fedavg_profile")
DEV = "cuda"

# the kernel check's shapes: LLaMA-2-7B attention at the engine's page size
H, DH, PS, S_CHECK, MP_CHECK, P_CHECK = 32, 128, 16, 8, 128, 1100
# pages reserved per slot: the check's mix, and the serve wave's
# (ceil((prompt + max_new) / 16) for 8 of `_requests`) over 64-entry tables
RES_CHECK = [128, 96, 64, 64, 40, 17, 8, 2]
RES_SERVE, MP_SERVE = [20, 41, 5, 9, 24, 6, 32, 13], 64
# engine shapes (phases 4-5)
N_SLOTS, MAX_LEN, PREFILL_CHUNK = 8, 1024, 256
# phase serve_surface: spec_k drafts a window (K4 at C = SPEC_K + 1), the
# batched admission width, the adapters' rank, and the depth of its f32
# identity checks (full width; the bf16 main path runs at full depth)
SPEC_K, ADMIT_BATCH, LORA_RANK, SURFACE_F32_LAYERS = 4, 4, 8, 4
# the kernel against its plain version under `rowwise_rel_err` (each
# (s, c, h) row's error relative to that row's largest value, one ulp of
# the output forgiven). f32: both sum the same f32 products in another
# order (split partials merged, ~1e-7 relative per sum). bf16 and int8
# (dequantised to bf16): the order can also flip the bf16 rounding of p
# before P.V (2^-8 relative).
TOL = {"f32": 1e-5, "bf16": 1e-2, "int8": 1e-2}
NEAR_TIE = 1e-3   # top-2 logit margin under which a flipped argmax is a tie
# train shapes: 2 clients x 4 sequences x 2048 tokens, batch 2 -> 2 local
# steps per client, 4 per round
TRAIN_CLIENTS, TRAIN_SEQS, TRAIN_T, TRAIN_BS, TRAIN_ROUNDS = 2, 4, 2048, 2, 2
# flash check shapes: one LLaMA-2-7B layer's attention as phase `train`
# launches it (B = TRAIN_BS sequences x H = 32 heads folded into BH),
# T = 2048, Dh = 128; the plain versions block as the JAX module's
# defaults do at T = 2048 (_auto_block(T, 512 / 1024))
FLASH_BH, FLASH_T, FLASH_D = TRAIN_BS * H, TRAIN_T, DH
FLASH_BQ, FLASH_BK = 512, 1024
# the D 40 case: heads every pass takes on the 64-column instance of its
# tensor-core kernel (columns past D zero-filled), at a small shape (the
# plain versions block by T) and at the flagship BH and T
D40_BH, D40_T, D40_D = 4, 256, 40
D40_BIG_BH, D40_BIG_T = FLASH_BH, FLASH_T
# kernel vs plain version under `flash_attention.rowwise_rel_err` (each
# row's error relative to that row's largest magnitude, one ulp of the
# output forgiven). f32: the same f32 products summed in another order
# (tiles of 64 against blocks of 512/1024); read at <= 5.3e-6 on the H100
# over two seeds. bf16: the order can also flip the bf16 rounding of p or
# dS before a product; read at <= 4.4e-3 (O) and <= 2.2e-3 (dQ, dK, dV)
# over two seeds, so 1e-2 is 2.3x the largest reading.
FLASH_TOL = {"f32": 1e-4, "bf16": 1e-2}
# flash-vs-dense f32 round: max |adapter difference| over max |adapter
# update|. Both compute the same f32 attention up to summation order
# (~1e-6 relative); two local steps carry it into the adapters.
PARITY_TOL = 1e-3
# phase fedavg: bench.py's `_flagship_config` (FedAvg, 100 clients x 96
# synthetic CIFAR-10 samples, ResNet-18-GN, bf16), FEDAVG_ROUNDS timed
# rounds (bench.py's MEASURE_ROUNDS is 5: cut to 3, as phase fedsim times
# the same G = 1 round three more times, then to 2 when phase
# serve_surface joined the script, to 1 when phase cross_silo_secure did,
# to keep the script near 75% of its time limit);
# the f32 card-vs-CPU round takes the first FEDAVG_PARITY_CLIENTS clients
FEDAVG_CONFIG = {
    "data_args": {"dataset": "cifar10"},
    "model_args": {"model": "resnet18_gn"},
    "train_args": {"federated_optimizer": "FedAvg",
                   "client_num_in_total": 100, "client_num_per_round": 100,
                   "comm_round": 5, "epochs": 1, "batch_size": 32,
                   "learning_rate": 0.05, "compute_dtype": "bfloat16"},
    "validation_args": {"frequency_of_the_test": 0},
    "comm_args": {"backend": "sp"},
}
FEDAVG_SAMPLES, FEDAVG_ROUNDS, FEDAVG_PARITY_CLIENTS = 96, 1, 4
# phase fedsim: the client-group widths timed at the flagship beside
# G = 1, G = 10's timed rounds after its warm one (3 since phase plugins
# joined the script, 2 since phase serve_surface did, 1 since phase
# cross_silo_secure did, to keep the script near 75% of its time limit;
# G = 1 times one round, G = 4 two, with the determinism setting on and
# off), and the reduced cohort of the bitwise bars
FEDSIM_GROUPS, FEDSIM_ROUNDS, FEDSIM_SMALL = (4, 10), 1, 8
# phase plugins: timed rounds after the warm one, each configuration's
# train_args / security / dp / chaos sections over the flagship config at
# G = 10. LDP's sensitivity is 1e-3 (sigma 4.8e-3 a coordinate), so that
# the noised flagship keeps a finite loss over its rounds; the noise's
# arithmetic is the same at any scale.
# timed rounds a configuration: one each ((a) and (b) took two until phase
# cross_silo_secure joined the script)
PLUGIN_G = 10
PLUGIN_ROUNDS = dict.fromkeys(
    ("plain", "a_multikrum_vs_byzantine", "b_median_chaos", "c_foolsgold",
     "d_ldp_topk", "e_eftopk"), 1)
PLUGIN_CONFIGS = {
    "plain": {},
    "a_multikrum_vs_byzantine": {
        "security_args": {"enable_defense": True, "defense_type": "multikrum",
                          "defense_spec": {"byzantine_client_num": 10},
                          "enable_attack": True, "attack_type": "byzantine",
                          "attack_spec": {"byzantine_client_num": 10,
                                          "attack_mode": "random"}}},
    "b_median_chaos": {
        "security_args": {"enable_defense": True,
                          "defense_type": "wise_median"},
        "common_args": {"chaos": {"client_dropout": 0.1,
                                  "client_straggler": 0.05}}},
    "c_foolsgold": {
        "security_args": {"enable_defense": True,
                          "defense_type": "foolsgold"}},
    "d_ldp_topk": {
        "dp_args": {"enable_dp": True, "dp_solution_type": "ldp",
                    "mechanism_type": "gaussian", "clipping_norm": 1.0,
                    "epsilon": 1.0, "sensitivity": 1e-3},
        "train_args": {"compression": "topk", "compression_ratio": 0.05}},
    "e_eftopk": {
        "train_args": {"compression": "eftopk", "compression_ratio": 0.05}},
}
# phase cross_silo: timed flagship rounds after the warm one (2 until
# phase cross_silo_secure joined the script); the f32
# federation of its bars (silos of CS_SHARDS samples, so that the
# aggregate's weights differ, each taking one local step of CS_BATCH a
# round for CS_SMALL_ROUNDS rounds), its chaos plan (with the retry budget
# that makes it deliver), and its tolerance against the Simulator's rounds
CS_ROUNDS = 1
CS_SHARDS, CS_BATCH, CS_SMALL_ROUNDS = (32, 48, 64, 96), 32, 2
CS_SILOS = len(CS_SHARDS)
CS_CHAOS = {"seed": 3, "drop": 0.1, "duplicate": 0.1, "reorder": 0.1}
CS_RETRY = {"ack_timeout_s": 1.0, "max_attempts": 20, "deadline_s": 120.0}
CS_SIM_TOL = 1e-5
# phase cross_silo_secure: (a) SecAgg at the flagship over the first
# SA_SILOS shards of its partition (each client draws SA_SILOS PRG masks of
# D = 11.17 M field elements a round, so the host's work grows with
# SA_SILOS^2; 100 silos would draw ~1.1e11 a round); (b)'s round timeouts
# (dropout recovery, then the loud quorum failure); (c) the wire codec of
# bench.py:bench_comm_codec at the flagship; (d)'s flaky device's timeout
SA_SILOS, SA_TIMEOUT, SA_FAIL_TIMEOUT = 10, 6.0, 4.0
SA_CODEC = {"kind": "dense"}       # field_pack rides c2s_sa_masked
CODEC = {"kind": "sparse_topk", "ratio": 0.12, "val_bits": 16,
         "error_feedback": True}
CD_TIMEOUT = 6.0
# vmap's per-example fallback warns; phase fedsim makes it an error
VMAP_FALLBACK = ("There is a performance drop because we have not yet "
                 "implemented the batching rule")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def ptxas_summary(report: str) -> list:
    """One line per compiled kernel of an `nvcc -Xptxas=-v` report: its
    (shortened) name, registers and spill bytes."""
    out, name, spill = [], None, ""
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            spill = ""
            k = re.search(r"\d+((?:flash|paged)_[a-z0-9_]*?_kernel)(?:I|E|v)",
                          m.group(1))
            name = k.group(1) if k else m.group(1)[:60]
            tmpl = re.search(r"_kernelI(.*?)EEv", m.group(1))
            name += f"<{tmpl.group(1)}>" if tmpl else ""
        elif "spill" in ln and name:
            spill = ln.strip()
        elif "registers" in ln and name:
            regs = re.search(r"Used (\d+) registers", ln)
            out.append(f"{name}: {regs.group(1) if regs else '?'} registers; "
                       f"{spill}")
            name = None
    return out


def sass_counts(lib: str) -> dict:
    """Tensor-core instructions in a built library's SASS (`cuobjdump
    -sass`): HMMA (mma.sync) and HGMMA (wgmma)."""
    from torch.utils.cpp_extension import CUDA_HOME

    sass = subprocess.run([f"{CUDA_HOME}/bin/cuobjdump", "-sass", lib],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    return {op: len(re.findall(rf"\b{op}\.", sass))
            for op in ("HMMA", "HGMMA")}


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
    """Dense peak for the operand type. f32 products at full f32 accuracy
    are at least three TF32 tensor-core passes each (hi/lo split, the
    floor the three-pass kernel and SDPA's f32 route both sit on): 495 /
    3 TFLOP/s, above the CUDA cores' 67."""
    import torch

    return 495e12 / 3 if dtype == torch.float32 else 989e12


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
def _kernel_case(rng, c: int, kind: str, serve: bool = False):
    """Random pool, page tables and positions at the check shape (or, with
    `serve`, at the serve wave's tables and reservations)."""
    import torch

    dev = DEV
    qdt = torch.float32 if kind == "f32" else torch.bfloat16
    n_res, max_pages = (RES_SERVE, MP_SERVE) if serve else (RES_CHECK,
                                                            MP_CHECK)
    perm = rng.permutation(np.arange(1, P_CHECK))
    pages = np.zeros((S_CHECK, max_pages), np.int32)  # 0 = the null page
    at = 0
    for s, n in enumerate(n_res):
        pages[s, :n] = perm[at:at + n]
        at += n
    pos = np.array([rng.integers(0, n * PS - c + 1) for n in n_res],
                   np.int32)
    if not serve:
        pos[0] = max_pages * PS - c    # the table's last position
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


def _bound(nbytes: int, flops: int, dtype, bw: float) -> dict:
    t_bytes = nbytes / bw * 1e3
    t_ops = flops / peak_flops(dtype) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def _sdpa_gathered_ms(q, k, v, pages, pos, ks, vs) -> float:
    """Library yardstick: SDPA on PRE-GATHERED contiguous K/V (gather and
    dequant excluded from the time), the same causal mask."""
    import torch
    import torch.nn.functional as F

    s_, c = q.shape[:2]
    n_pg = int(((pos.long() + c - 1) // PS + 1).max())
    idx = pages[:, :n_pg].long()

    def gathered(pool, sc):
        g = pool[idx]
        if sc is not None:
            g = (g.float() * sc[idx][:, :, None, :, None]).to(q.dtype)
        return g.reshape(s_, n_pg * PS, H, DH).transpose(1, 2).contiguous()

    kk, vv = gathered(k, ks), gathered(v, vs)
    qq = q.transpose(1, 2).contiguous()
    vpos = torch.arange(n_pg * PS, device=DEV)
    mask = (vpos[None, None, None, :]
            <= (pos.long()[:, None] + torch.arange(
                c, device=DEV))[:, None, :, None])
    return time_ms(lambda: F.scaled_dot_product_attention(
        qq, kk, vv, attn_mask=mask))


def phase_kernel(bw: float) -> dict:
    import torch

    from fedml_tpu_torch.ops import paged_attention as pa
    from fedml_tpu_torch.ops.tolerance import rowwise_rel_err

    out = {}
    for kind in ("f32", "bf16", "int8"):
        errs, rels = [], []
        # every pool kind gets the same page tables and positions (one seed
        # per case), so the kinds' times compare like with like
        for seed, c, serve in ((0, 1, False), (1, 5, False), (2, 1, True),
                               (3, 5, True)):
            case = _kernel_case(np.random.default_rng(seed), c, kind, serve)
            q, k, v, pages, pos, ks, vs = case
            got = pa.paged_attention(*case)
            ref = pa.paged_attention_ref(*case)
            torch.cuda.synchronize()
            where = f"{kind} C={c}{' serve' if serve else ''}"
            check(torch.isfinite(got).all().item(), f"{where}: non-finite")
            err = (got.float() - ref.float()).abs().max().item()
            rel = rowwise_rel_err(got, ref)
            errs.append(err)
            rels.append(rel)
            emit({"phase": "kernel", "pool": kind, "C": c, "serve": serve,
                  "max_abs_err": err, "max_row_rel_err": rel,
                  "tol_row_rel": TOL[kind]})
            check(rel <= TOL[kind], f"{where}: row-relative err {rel} > "
                  f"{TOL[kind]}")
            if c != 1 and not serve:
                continue
            # timing at the decode step's C=1, and at the serve shape's
            # speculative verify window (C = spec_k + 1 = 5)
            ms = time_ms(lambda: pa.paged_attention(*case))
            lib_ms = _sdpa_gathered_ms(*case)
            nbytes, flops = _case_cost(q, k, pages, pos, ks is not None)
            row = {"ms": ms, "library_ms": lib_ms,
                   "plain_ms": time_ms(lambda: pa.paged_attention_ref(*case),
                                       n=50, warmup=2),
                   **_bound(nbytes, flops, q.dtype, bw)}
            if not serve:
                out[kind] = row
            elif c == 1:
                out[kind]["serve_shape"] = row
            else:
                row.update(max_abs_err=err, max_row_rel_err=rel)
                out[kind]["serve_c5"] = row
            emit({"phase": "kernel", "pool": kind, "C": c, "serve": serve,
                  "max_pages": pages.shape[1],
                  "pages_per_split": pa.pages_per_split(pages.shape[1]),
                  **row})
        out[kind]["max_abs_err"] = max(errs)
        out[kind]["max_row_rel_err"] = max(rels)
        del case, q, k, v
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


def _wave(eng, reqs, **submit_kw):
    """Submit every request at once, wait for all; returns (token lists,
    stats). `submit_kw` (temperature, seed) goes to every submit."""
    t0 = time.perf_counter()
    tickets = [eng.submit(p, n, **submit_kw) for p, n in reqs]
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

    return DecodeEngine(model, **{
        "n_slots": N_SLOTS, "max_len": MAX_LEN, "page_size": PS,
        "prefill_chunk": PREFILL_CHUNK, "device": DEV, **kw}).start()


def _serve(model, reqs, submit_kw=None, **kw) -> tuple[list, dict]:
    """One engine over `model`: warm it up, then serve `reqs` with the
    kernel launches (all, and by query count C), the prefix hits and the
    speculation counters read around the wave."""
    import torch

    from fedml_tpu_torch.ops import paged_attention as pa
    from fedml_tpu_torch.utils import metrics as mx

    def counters():
        c = mx.snapshot()["counters"]
        return {k: c.get(k, 0) for k in (
            "serving.prefix_hits", "serving.spec.proposed",
            "serving.spec.accepted")}

    eng = _engine(model, **kw)
    try:
        eng.submit(list(range(1, 33)), 4).result(timeout=600)   # warm-up
        c0 = counters()
        steps0 = eng.decode_steps
        pa.launch_count = 0
        pa.launches_by_c.clear()
        outs, stats = _wave(eng, reqs, **(submit_kw or {}))
        stats["launches"] = pa.launch_count
        stats["launches_by_c"] = dict(pa.launches_by_c)
        stats["decode_steps"] = eng.decode_steps - steps0
        c1 = counters()
        stats["prefix_hits"] = (c1["serving.prefix_hits"]
                                - c0["serving.prefix_hits"])
        prop = c1["serving.spec.proposed"] - c0["serving.spec.proposed"]
        acc = c1["serving.spec.accepted"] - c0["serving.spec.accepted"]
        if prop:
            stats["spec"] = {"proposed": prop, "accepted": acc,
                             "accept_rate": acc / prop}
        # every page is free again or a resident prefix page nobody holds
        stats["pool_back_to_budget"] = not eng.kv_page_size or (
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


def _near_tie_identical(model, reqs, ref_outs, outs,
                        phase: str = "engine") -> dict:
    """Token identity under the near-tie rule: identical streams pass; a
    stream whose first difference sits where the reference's top-2 margin
    (under `model`) is below NEAR_TIE passes (nothing after it is
    checked); anything else fails."""
    ties = []
    for i, ((prompt, _n), a, b) in enumerate(zip(reqs, ref_outs, outs)):
        if a == b:
            continue
        j = next((k for k in range(min(len(a), len(b))) if a[k] != b[k]),
                 None)
        check(j is not None, f"request {i}: lengths {len(a)} vs {len(b)}")
        margin = _top2_margin(model, prompt + a[:j])
        emit({"phase": phase, "near_tie": {"request": i, "pick": j,
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


# ------------------------------------------------------------- phase 6
def _adapters(model, seed: int) -> dict:
    """Rank-LORA_RANK adapters on wq/wk/wv/wo (the LoRA round's targets)
    with a nonzero B, drawn on the card from one seeded generator."""
    import torch

    from fedml_tpu_torch.llm.lora import lora_init

    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    ads = lora_init(model.state_dict(), rank=LORA_RANK, generator=gen)
    for ab in ads.values():
        ab["b"] = 0.05 * torch.randn(ab["b"].shape, generator=gen,
                                     device=DEV)
    return ads


def _post(port: int, body: dict) -> tuple[int, bytes]:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request("POST", "/predict", body=json.dumps(body).encode(),
                  headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = resp.status, resp.read()
    conn.close()
    return out


def _get(port: int, path: str) -> tuple[int, dict]:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    out = resp.status, json.loads(resp.read())
    conn.close()
    return out


def _http_wave(port: int, reqs) -> tuple[list, list, float]:
    """Every request POSTed at once, one thread each: (status codes, token
    lists, wall seconds)."""
    import threading

    res = [None] * len(reqs)

    def post(i):
        prompt, n = reqs[i]
        res[i] = _post(port, {"tokens": prompt, "max_new_tokens": n})

    threads = [threading.Thread(target=post, args=(i,))
               for i in range(len(reqs))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    return ([c for c, _b in res],
            [json.loads(b)["generated_tokens"] if c == 200 else None
             for c, b in res], wall)


def _surface_f32(reqs) -> dict:
    """The f32 identity checks at full width and SURFACE_F32_LAYERS
    layers (TF32 off): (a) spec-on vs spec-off, (b) admit_batch vs one
    admission a chunk, (c) adapters vs the lora_merge'd weights, (d) the
    contiguous layout vs paged, (e) the HTTP runner's answers vs direct
    submits, one SSE stream vs its JSON answer, and the per-request path
    vs the engine."""
    import torch

    from fedml_tpu_torch.llm.lora import lora_merge
    from fedml_tpu_torch.llm.transformer import (
        LLAMA2_7B, TransformerLM, init_params,
    )
    from fedml_tpu_torch.serving.inference_runner import FedMLInferenceRunner
    from fedml_tpu_torch.serving.predictor import GreedyLMPredictor

    dims = dataclasses.replace(LLAMA2_7B, n_layers=SURFACE_F32_LAYERS)
    out = {"layers": SURFACE_F32_LAYERS}
    with _tf32_off():
        state = init_params(dims, seed=0, dtype=torch.float32, device=DEV)
        model = TransformerLM.from_state(dims, state)
        base, st = _serve(model, reqs, paged_kernel=True)
        out["base"] = st
        checks = {
            "a_spec": dict(spec_decode="ngram", spec_k=SPEC_K),
            "b_admit_batch": dict(admit_batch=ADMIT_BATCH),
            "d_contiguous": dict(page_size=0, prefill_chunk=0,
                                 paged_kernel=False)}
        for name, kw in checks.items():
            outs, st = _serve(model, reqs, **{"paged_kernel": True, **kw})
            out[name] = {**_near_tie_identical(model, reqs, base, outs,
                                               "serve_surface"), **st}
            check(all(len(o) == n for o, (_p, n) in zip(outs, reqs)),
                  f"{name}: a ticket ended short of max_new_tokens")
        check(out["a_spec"]["launches_by_c"].get(SPEC_K + 1, 0) > 0,
              "the f32 spec wave launched no C = 5 window")
        ads = _adapters(model, seed=1)
        merged = TransformerLM.from_state(dims, lora_merge(state, ads))
        ref, _st = _serve(merged, reqs, paged_kernel=True)
        outs, st = _serve(model, reqs, paged_kernel=True, adapters=ads)
        out["c_adapters"] = {**_near_tie_identical(
            merged, reqs, ref, outs, "serve_surface"), **st}
        per_req = GreedyLMPredictor(model, max_len=MAX_LEN, kv_cache=True,
                                    device=DEV)
        p_outs = [per_req.predict({"tokens": p, "max_new_tokens": n})
                  ["generated_tokens"] for p, n in reqs[:3]]
        out["e_per_request"] = _near_tie_identical(
            model, reqs[:3], base[:3], p_outs, "serve_surface")
        pred = GreedyLMPredictor(
            model, max_len=MAX_LEN, kv_cache=True, adapters=ads,
            decode_slots=N_SLOTS, kv_page_size=PS,
            prefill_chunk=PREFILL_CHUNK, paged_kernel=True,
            spec_decode="ngram", spec_k=SPEC_K, device=DEV)
        runner = FedMLInferenceRunner(pred, port=0).start()
        try:
            codes, http_outs, _wall = _http_wave(runner.port, reqs)
            check(codes == [200] * len(reqs), f"HTTP codes {codes}")
            direct = [t.result(timeout=600) for t in
                      [pred.engine.submit(p, n) for p, n in reqs]]
            out["e_http"] = _near_tie_identical(merged, reqs, direct,
                                                http_outs, "serve_surface")
            # a prompt shorter than a page: no prefix hit can change the
            # chunking between the two calls, so the tokens are equal
            body = {"tokens": reqs[0][0][:12], "max_new_tokens": 24}
            code, raw = _post(runner.port, body)
            check(code == 200, f"JSON predict answered {code}")
            want = json.loads(raw)["generated_tokens"]
            code, raw = _post(runner.port, {**body, "stream": True})
            events = [json.loads(ln[len(b"data: "):])
                      for ln in raw.splitlines() if ln.startswith(b"data: ")]
            check(code == 200 and [e.get("token") for e in events[:-1]]
                  == want and events[-1] == {"done": True,
                                             "generated_tokens": want},
                  "the SSE stream differs from its JSON answer")
            ready, info = _get(runner.port, "/ready"), _get(runner.port,
                                                            "/info")
            check(ready[0] == 200 and info[0] == 200
                  and info[1]["kv_page_size"] == PS, f"/ready {ready}, "
                  f"/info {info}")
            out["e_sse_equals_json"] = True
            out["e_info"] = info[1] | {"prefix_digests": len(
                info[1]["prefix_digests"])}
        finally:
            runner.stop()
    del model, merged, state, per_req, pred
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_serve_surface(reqs, serve_runs: dict) -> dict:
    """The serving surface at LLaMA-2-7B width: f32 identity checks at
    reduced depth (`_surface_f32`; width is not cut), then in bf16 at full
    depth: (a) two spec-on waves (spec_k 4, kernel) between two spec-off
    ones, accept rate, K4 launches by C, then a seeded sampled wave with
    and without speculation (the accepted-count read-back's cost; bf16
    equality reported, not gated); (b) admit_batch 4's TTFT
    against the spec-off waves' (one admission a chunk); (c) an engine
    with rank-8 adapters, hot-swapped mid-wave (version 0 -> 1, every
    ticket finishes, a mismatched swap refused) and its peak memory;
    (e) the main path: FedMLInferenceRunner -> GreedyLMPredictor (8 slots,
    paged, kernel, spec, adapters) -> DecodeEngine, 10 concurrent POSTs
    with the launch counts zeroed just before and read just after: the
    engine serves all 10 and every window launches K4 at C = 5 in every
    layer."""
    import torch

    from fedml_tpu_torch.llm.transformer import (
        LLAMA2_7B, TransformerLM, init_params,
    )
    from fedml_tpu_torch.ops import paged_attention as pa
    from fedml_tpu_torch.serving.inference_runner import FedMLInferenceRunner
    from fedml_tpu_torch.serving.predictor import GreedyLMPredictor
    from fedml_tpu_torch.utils import metrics as mx

    t0 = time.perf_counter()
    out = {"f32": _surface_f32(reqs)}
    emit({"phase": "serve_surface", "f32": out["f32"]})
    model = TransformerLM.from_state(
        LLAMA2_7B, init_params(LLAMA2_7B, seed=0, dtype=torch.bfloat16,
                               device=DEV))
    L = LLAMA2_7B.n_layers
    # spec-off and spec-on waves in turns (off, on, on, off): the wave is
    # host-bound and the host drifts within a call
    spec = dict(paged_kernel=True, spec_decode="ngram", spec_k=SPEC_K)
    off_outs, off = _serve(model, reqs, paged_kernel=True)
    on_outs, on = _serve(model, reqs, **spec)
    _o, on2 = _serve(model, reqs, **spec)
    _o, off2 = _serve(model, reqs, paged_kernel=True)
    c5 = on["launches_by_c"].get(SPEC_K + 1, 0)
    check(c5 == L * on["decode_steps"] > 0 and on["launches"] == c5,
          f"spec wave: C = {SPEC_K + 1} launches {on['launches_by_c']} != "
          f"{L} x {on['decode_steps']} windows")

    def mean(key, *waves):
        return statistics.mean(w[key] for w in waves)

    out["a_spec"] = {
        "spec_off": off, "spec_on": on, "spec_on_2": on2, "spec_off_2": off2,
        "serve_phase_spec_off": serve_runs.get("bf16"),
        "decode_tokens_per_s_ratio": (
            mean("decode_tokens_per_s", on, on2)
            / mean("decode_tokens_per_s", off, off2)),
        "ttft_p50_ratio": (mean("ttft_p50_s", on, on2)
                           / mean("ttft_p50_s", off, off2)),
        "ms_per_iteration": {
            name: w["wall_s"] * 1e3 / w["decode_steps"]
            for name, w in (("off", off), ("on", on), ("on_2", on2),
                            ("off_2", off2))},
        "tokens_equal_spec_off": sum(a == b for a, b in zip(off_outs,
                                                            on_outs))}
    # seeded sampling: a window with a sampled slot reads its accepted
    # counts back before the next window's draws (greedy windows do not)
    sampled = {"temperature": 0.7, "seed": 11}
    s_off_outs, s_off = _serve(model, reqs, submit_kw=sampled,
                               paged_kernel=True)
    s_on_outs, s_on = _serve(model, reqs, submit_kw=sampled, **spec)
    out["a_spec"]["sampled"] = {
        "spec_off": s_off, "spec_on": s_on,
        "ms_per_iteration": {
            name: w["wall_s"] * 1e3 / w["decode_steps"]
            for name, w in (("off", s_off), ("on", s_on))},
        "tokens_equal_spec_off": sum(a == b for a, b in zip(s_off_outs,
                                                            s_on_outs))}
    _outs, ab = _serve(model, reqs, paged_kernel=True,
                       admit_batch=ADMIT_BATCH)
    out["b_admit_batch"] = {"admit_batch_4": ab,
                            "ttft_p50_ratio": ab["ttft_p50_s"]
                            / mean("ttft_p50_s", off, off2)}
    # (c) adapters, merged once, hot-swapped mid-wave
    from fedml_tpu_torch.serving.engine import DecodeEngine

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ads, ads2 = _adapters(model, seed=1), _adapters(model, seed=2)
    eng = _engine(model, adapters=ads, paged_kernel=True,
                  spec_decode="ngram", spec_k=SPEC_K)
    try:
        tickets = [eng.submit(p, n) for p, n in reqs]
        next(tickets[0].stream(timeout=600))
        t_swap = time.perf_counter()
        ver = eng.swap_adapters(ads2)
        swap_s = time.perf_counter() - t_swap
        outs = [t.result(timeout=600) for t in tickets]
        check(ver == 1 == eng.model_version, f"model_version {ver}")
        check(all(len(o) == n for o, (_p, n) in zip(outs, reqs)),
              "a ticket ended short of max_new_tokens across the swap")
        bad = {k: {"a": ab_["a"][:, :4], "b": ab_["b"][:4]}
               for k, ab_ in ads2.items()}
        try:
            eng.swap_adapters(bad)
            refused = False
        except ValueError:
            refused = True
        check(refused and eng.model_version == 1,
              "a mismatched adapter swap was not refused")
        torch.cuda.synchronize()
        merged_bytes = sum(
            p.numel() * p.element_size()
            for n, p in eng.serving_model.state_dict().items() if n in ads)
        out["c_adapters"] = {
            "version_after_swap": eng.model_version,
            "swap_s": swap_s, "mismatched_swap_refused": refused,
            "merged_kernel_bytes": merged_bytes,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    finally:
        eng.stop()
    del eng, ads2
    gc.collect()
    torch.cuda.empty_cache()
    # (e) the main path over HTTP
    pred = GreedyLMPredictor(
        model, max_len=MAX_LEN, kv_cache=True, adapters=ads,
        decode_slots=N_SLOTS, kv_page_size=PS, prefill_chunk=PREFILL_CHUNK,
        paged_kernel=True, spec_decode="ngram", spec_k=SPEC_K, device=DEV)
    runner = FedMLInferenceRunner(pred, port=0).start()
    try:
        code, _raw = _post(runner.port, {"tokens": list(range(1, 33)),
                                         "max_new_tokens": 4})   # warm-up
        check(code == 200, f"warm-up answered {code}")
        served0 = mx.snapshot()["counters"].get("serving.engine.requests", 0)
        steps0 = pred.engine.decode_steps
        pa.launch_count = 0
        pa.launches_by_c.clear()
        codes, outs, wall = _http_wave(runner.port, reqs)
        launches = {"all": pa.launch_count, "by_c": dict(pa.launches_by_c)}
        windows = pred.engine.decode_steps - steps0
        served = (mx.snapshot()["counters"].get("serving.engine.requests", 0)
                  - served0)
    finally:
        runner.stop()
    check(codes == [200] * len(reqs), f"HTTP codes {codes}")
    check(all(len(o) == n for o, (_p, n) in zip(outs, reqs)),
          "an HTTP answer is short of max_new_tokens")
    # every request went through the engine, and every window of the wave
    # through K4 at C = 5 in every layer (none served by the plain path)
    check(served == len(reqs), f"the engine served {served} of {len(reqs)}")
    c5 = launches["by_c"].get(SPEC_K + 1, 0)
    check(c5 == L * windows > 0 and launches["all"] == c5,
          f"main path: C = {SPEC_K + 1} launches {launches['by_c']} != "
          f"{L} x {windows} windows")
    out["e_main_path"] = {"launches": launches, "windows": windows,
                          "engine_requests": served, "wall_s": wall,
                          "tokens_per_s": sum(map(len, outs)) / wall}
    out["launches_c5"] = launches["by_c"].get(SPEC_K + 1, 0)
    out["seconds"] = time.perf_counter() - t0
    emit({"phase": "serve_surface", "dtype": "bfloat16",
          **{k: v for k, v in out.items() if k != "f32"}})
    del pred, runner, model, ads
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _kernel_rows(prof) -> list:
    """(name, calls, device ms) of each kernel in a torch.profiler run,
    longest first. Only the device's own events: a host op's row (aten::mm,
    an autograd Function) carries the device time of the kernels it
    launched, which the kernels' rows already hold."""
    from torch.autograd import DeviceType

    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[2])


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
    rows = _kernel_rows(prof)
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


# ------------------------------------------------------------------ phase 7
def _flash_cost(kernel: str, bh: int, t: int, d: int, es: int):
    """(bytes, flops) the function must move/do: each input read once,
    each output written once; causal products count T(T+1)/2 score
    entries, 2*D flops each. The forward does 2 products (S, P.V), dQ 2
    (dP, dS.K), dK/dV 2 (P^T.dO, dS^T.Q): the backward's 4 products split
    between its two kernels. Recomputing S (both), and dP in dK/dV, is the
    kernels' choice and is not counted."""
    tri = t * (t + 1) // 2
    tile = bh * t * d * es       # one [BH, T, D] operand
    row = bh * t * 4             # one [BH, T] f32 vector
    flops = 4 * bh * d * tri
    nbytes = {"fwd": 3 * tile + tile + row,              # q k v -> o lse
              "dq": 4 * tile + 2 * row + tile,           # q k v dO lse dlt
              "dkv": 4 * tile + 2 * row + 2 * tile,      # ... -> dK dV
              "bwd": 5 * tile + row + 3 * tile}[kernel]  # q k v o dO lse
    return nbytes, 2 * flops if kernel == "bwd" else flops


def _errors(pairs, where: str, tol: float) -> dict:
    """{name: max abs and row-relative error} of (name, got, want) pairs,
    each checked finite and within `tol` under `rowwise_rel_err`."""
    import torch

    from fedml_tpu_torch.ops import flash_attention as fa

    errs = {}
    for name, got, want in pairs:
        check(torch.isfinite(got).all().item(), f"{where} {name}: non-finite")
        rel = fa.rowwise_rel_err(got, want)
        errs[name] = {"max_abs_err": (got.float() - want.float()).abs()
                      .max().item(), "max_row_rel_err": rel}
        check(rel <= tol, f"{where} {name}: row-relative err {rel} > {tol}")
    return errs


def phase_flash(bw: float) -> dict:
    import torch
    import torch.nn.functional as F

    from fedml_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    bh, t, d = FLASH_BH, FLASH_T, FLASH_D
    rng = np.random.default_rng(2)
    out = {}
    for kind, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        q, k, v, do = (torch.from_numpy(
            rng.standard_normal((bh, t, d), np.float32)).to(DEV, dt)
            for _ in range(4))
        # bf16 D 128: the tensor-core kernels; f32: the three-pass TF32
        # kernels
        routes = (fa.fwd_route(q), fa.dq_route(q), fa.dkv_route(q))
        before = dict(fa.launch_count)
        o, lse = fa.flash_fwd(q, k, v)
        delta = fa.flash_delta(o, do)
        dq = fa.flash_dq(q, k, v, do, lse, delta)
        dk, dv = fa.flash_dkv(q, k, v, do, lse, delta)
        torch.cuda.synchronize()
        check(fa.launch_count == {n: before[n] + (n in routes)
                                  for n in before},
              f"flash {kind}: launches {fa.launch_count} (before {before}) "
              f"are not one each of {routes}")
        # each kernel against its plain version on the same inputs
        want_o, want_lse = fa.flash_fwd_ref(q, k, v, FLASH_BQ, FLASH_BK)
        want_dq = fa.flash_dq_ref(q, k, v, do, lse, delta, FLASH_BQ,
                                  FLASH_BK)
        want_dk, want_dv = fa.flash_dkv_ref(q, k, v, do, lse, delta,
                                            FLASH_BQ, FLASH_BK)
        errs = _errors((("o", o, want_o), ("lse", lse, want_lse),
                        ("dq", dq, want_dq), ("dk", dk, want_dk),
                        ("dv", dv, want_dv)), f"flash {kind}",
                       FLASH_TOL[kind])
        emit({"phase": "flash", "dtype": kind, "shape": [bh, t, d],
              "errors": errs, "tol_row_rel": FLASH_TOL[kind]})
        del want_o, want_lse, want_dq, want_dk, want_dv

        ms = {"fwd": time_ms(lambda: fa.flash_fwd(q, k, v)),
              "dq": time_ms(lambda: fa.flash_dq(q, k, v, do, lse, delta)),
              "dkv": time_ms(lambda: fa.flash_dkv(q, k, v, do, lse, delta)),
              "bwd": time_ms(lambda: fa.flash_bwd(q, k, v, o, lse, do))}
        plain = {
            "fwd": time_ms(lambda: fa.flash_fwd_ref(
                q, k, v, FLASH_BQ, FLASH_BK), n=10, warmup=1),
            "dq": time_ms(lambda: fa.flash_dq_ref(
                q, k, v, do, lse, delta, FLASH_BQ, FLASH_BK), n=10,
                warmup=1),
            "dkv": time_ms(lambda: fa.flash_dkv_ref(
                q, k, v, do, lse, delta, FLASH_BQ, FLASH_BK), n=10,
                warmup=1),
            "bwd": time_ms(lambda: fa.flash_bwd_ref(
                q, k, v, o, lse, do, FLASH_BQ, FLASH_BK), n=10, warmup=1)}
        # library yardsticks, timed here only: SDPA on [B, H, T, D]; its
        # backward alone ("bwd": the graph built once, then dQ, dK and dV
        # together per call) is the one call that does K2's and K3's work
        q4, k4, v4, do4 = (x.view(TRAIN_BS, H, t, d) for x in (q, k, v, do))
        qg, kg, vg = (x.detach().requires_grad_() for x in (q4, k4, v4))

        def sdpa_fwd_bwd():
            y = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
            torch.autograd.grad(y, (qg, kg, vg), do4)

        y = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        library = {"fwd": time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True)), "fwd_bwd": time_ms(sdpa_fwd_bwd),
            "bwd": time_ms(lambda: torch.autograd.grad(
                y, (qg, kg, vg), do4, retain_graph=True))}
        del y
        bounds = {name: _bound(*_flash_cost(name, bh, t, d,
                                            q.element_size()), dt, bw)
                  for name in ms}
        out[kind] = {"ms": ms, "plain_ms": plain, "library_ms": library,
                     "bounds": bounds, "errors": errs, "routes": routes}
        emit({"phase": "flash", "dtype": kind, "routes": routes, "ms": ms,
              "plain_ms": plain, "library_ms": library, "bounds": bounds})
        del q, k, v, do, o, lse, delta, dq, dk, dv, qg, kg, vg
        gc.collect()
        torch.cuda.empty_cache()
    out["d40"] = _flash_d40_case(bw)
    return out


def _flash_passes(kind: str, dt, bh: int, t: int, blocks, rng, bw: float,
                  launches: dict, n_plain: int) -> dict:
    """One shape of the D 40 case: random q, k, v, dO of [bh, t, D40_D]
    through K1, K2 and K3 (one launch each of the routes the shape rule
    names, added to `launches`), each against its plain version blocked by
    `blocks`, then timed beside it, SDPA's forward or backward alone, and
    its bound."""
    import torch
    import torch.nn.functional as F

    from fedml_tpu_torch.ops import flash_attention as fa

    d = D40_D
    q, k, v, do = (torch.from_numpy(
        rng.standard_normal((bh, t, d), np.float32)).to(DEV, dt)
        for _ in range(4))
    routes = (fa.fwd_route(q), fa.dq_route(q), fa.dkv_route(q))
    before = dict(fa.launch_count)
    o, lse = fa.flash_fwd(q, k, v)
    delta = fa.flash_delta(o, do)
    dq = fa.flash_dq(q, k, v, do, lse, delta)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    where = f"D {d} {kind} at BH {bh}, T {t}"
    check(fa.launch_count == {n: before[n] + (n in routes) for n in before},
          f"{where}: launches {fa.launch_count} (before {before}) are not "
          f"one each of {routes}")
    for n in routes:
        launches[n] += 1
    bq, bk = blocks
    want_o, want_lse = fa.flash_fwd_ref(q, k, v, bq, bk)
    want_dq = fa.flash_dq_ref(q, k, v, do, lse, delta, bq, bk)
    want_dk, want_dv = fa.flash_dkv_ref(q, k, v, do, lse, delta, bq, bk)
    errs = _errors((("o", o, want_o), ("lse", lse, want_lse),
                    ("dq", dq, want_dq), ("dk", dk, want_dk),
                    ("dv", dv, want_dv)), where, FLASH_TOL[kind])
    del want_o, want_lse, want_dq, want_dk, want_dv
    q4, k4, v4, do4 = (x.view(1, bh, t, d) for x in (q, k, v, do))
    qg, kg, vg = (x.detach().requires_grad_() for x in (q4, k4, v4))
    y = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    res = {
        "shape": [bh, t, d], "routes": routes, "errors": errs,
        "ms": {"fwd": time_ms(lambda: fa.flash_fwd(q, k, v)),
               "dq": time_ms(lambda: fa.flash_dq(q, k, v, do, lse, delta)),
               "dkv": time_ms(lambda: fa.flash_dkv(q, k, v, do, lse,
                                                   delta))},
        "plain_ms": {
            "fwd": time_ms(lambda: fa.flash_fwd_ref(q, k, v, bq, bk),
                           n=n_plain, warmup=2),
            "dq": time_ms(lambda: fa.flash_dq_ref(
                q, k, v, do, lse, delta, bq, bk), n=n_plain, warmup=2),
            "dkv": time_ms(lambda: fa.flash_dkv_ref(
                q, k, v, do, lse, delta, bq, bk), n=n_plain, warmup=2)},
        "library_ms": {
            "fwd": time_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=True)),
            "bwd": time_ms(lambda: torch.autograd.grad(
                y, (qg, kg, vg), do4, retain_graph=True))},
        "bounds": {n: _bound(*_flash_cost(n, bh, t, d, q.element_size()),
                             dt, bw) for n in ("fwd", "dq", "dkv")}}
    del y, qg, kg, vg, q, k, v, do, o, lse, delta, dq, dk, dv
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _flash_d40_case(bw: float) -> dict:
    """Heads of D 40 in f32 and bf16 through every pass, on the 64-column
    instance of the tensor-core kernels (f32: the three-pass forward, dQ
    and dK/dV; bf16: the one-pass ones), against the plain versions and
    timed beside them, SDPA and the bound: at BH 4, T 256 and at the
    flagship BH 64, T 2048 (under `at_flagship`)."""
    import torch

    from fedml_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(3)
    want_routes = {"f32": ("fwd_3xtf32", "dq_3xtf32", "dkv_3xtf32"),
                   "bf16": ("fwd_tc", "dq_tc", "dkv_tc")}
    out = {"shape": [D40_BH, D40_T, D40_D],
           "launches": dict.fromkeys(fa.launch_count, 0)}
    for kind, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        small = _flash_passes(kind, dt, D40_BH, D40_T, (D40_T, D40_T), rng,
                              bw, out["launches"], n_plain=20)
        check(small["routes"] == want_routes[kind],
              f"D {D40_D} {kind}: routes {small['routes']}, not "
              f"{want_routes[kind]}")
        small["at_flagship"] = _flash_passes(
            kind, dt, D40_BIG_BH, D40_BIG_T, (FLASH_BQ, FLASH_BK), rng, bw,
            out["launches"], n_plain=10)
        out[kind] = small
    emit({"phase": "flash", "d40_case": out, "tol_row_rel": FLASH_TOL})
    return out


# ------------------------------------------------------------------ phase 8
def _token_data(vocab: int, seed: int) -> dict:
    """{"x", "y": [clients, seqs, T] next-token pairs of random tokens,
    "mask": [clients, seqs]} on the device, from numpy's generator."""
    import torch

    rng = np.random.default_rng(seed)
    seqs = rng.integers(0, vocab, (TRAIN_CLIENTS, TRAIN_SEQS, TRAIN_T + 1))
    return {"x": torch.from_numpy(seqs[..., :-1]).to(DEV),
            "y": torch.from_numpy(seqs[..., 1:]).to(DEV),
            "mask": torch.ones((TRAIN_CLIENTS, TRAIN_SEQS),
                               dtype=torch.float32, device=DEV)}


def _fed_lora(dims, state, t, flash: bool, seed: int = 1):
    """(FedAvg over LoRA adapters, initial adapters, round fn) for a model
    over `state` with per-block remat, rank 8 / alpha 16 on wq/wk/wv/wo."""
    import torch

    from fedml_tpu_torch.llm import federated_lora
    from fedml_tpu_torch.llm.transformer import TransformerLM
    from fedml_tpu_torch.ops.flash_attention import flash_attn_fn
    from fedml_tpu_torch.parallel.round import build_round_fn

    model = TransformerLM.from_state(
        dims, state, attn_fn=flash_attn_fn if flash else None, remat=True)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    alg, adapters = federated_lora(model, state, t, gen, rank=8, alpha=16.0)
    return alg, adapters, build_round_fn(alg)


def _max_abs_diff(a: dict, b: dict) -> float:
    return max((a[k][n] - b[k][n]).abs().max().item()
               for k in a for n in ("a", "b"))


def phase_train(dims=None, parity_layers: int = 2) -> dict:
    """The slice's main path at `dims` (default LLaMA-2-7B), then the f32
    flash-vs-dense round at the same widths and `parity_layers` layers."""
    import dataclasses

    import torch

    from fedml_tpu_torch.config import TrainArgs
    from fedml_tpu_torch.core.algorithm import make_batch_indices
    from fedml_tpu_torch.llm import count_params
    from fedml_tpu_torch.llm.transformer import LLAMA2_7B, init_params
    from fedml_tpu_torch.ops import flash_attention as fa
    from fedml_tpu_torch.parallel.round import client_generator

    dims = dims or LLAMA2_7B
    L = dims.n_layers
    ids = np.arange(TRAIN_CLIENTS)
    weights = np.full((TRAIN_CLIENTS,), float(TRAIN_SEQS), np.float32)
    data = _token_data(dims.vocab_size, seed=0)
    t0 = time.perf_counter()
    state = init_params(dims, seed=0, dtype=torch.bfloat16, device=DEV)
    base_copy = {k: v.clone() for k, v in state.items()}
    t = TrainArgs(epochs=1, batch_size=TRAIN_BS, learning_rate=1e-3,
                  compute_dtype="bfloat16")
    alg, adapters, round_fn = _fed_lora(dims, state, t, flash=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    st = alg.server_init(adapters)
    steps_per_round = TRAIN_CLIENTS * (TRAIN_SEQS // TRAIN_BS)
    rounds = []
    fa.launch_count.update(dict.fromkeys(fa.launch_count, 0))
    torch.cuda.reset_peak_memory_stats()
    for r in range(TRAIN_ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = round_fn(st, None, data, ids, weights, seed=r)
        loss = out.metrics["train_loss"].item()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = out.server_state
        tokens = steps_per_round * TRAIN_BS * TRAIN_T
        rounds.append({"round": r, "wall_s": wall, "train_loss": loss,
                       "tokens_per_s": tokens / wall,
                       "ms_per_local_step": wall / steps_per_round * 1e3})
    launches = dict(fa.launch_count)
    steps = steps_per_round * TRAIN_ROUNDS
    res = {"init_s": init_s, "rounds": rounds, "launches": launches,
           "steps": steps,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "adapter_payload_fraction":
               count_params(adapters) / count_params(state)}
    moved = min((st.params[k][n] - adapters[k][n]).abs().max().item()
                for k in adapters for n in ("a", "b"))
    same_base = all(torch.equal(state[k], base_copy[k]) for k in state)
    emit({"phase": "train", "dims": dataclasses.asdict(dims),
          "clients": TRAIN_CLIENTS, "seqs_per_client": TRAIN_SEQS,
          "seq_len": TRAIN_T, "batch_size": TRAIN_BS, **res,
          "min_adapter_move": moved, "base_unchanged": same_base})
    check(all(np.isfinite(r["train_loss"]) for r in rounds),
          "a round's loss is not finite")
    check(moved > 0, "an adapter did not move")
    check(same_base, "the frozen base changed")
    check(launches == {"fwd_tc": 2 * L * steps, "fwd_3xtf32": 0,
                       "dq_tc": L * steps, "dq_3xtf32": 0,
                       "dkv_tc": L * steps, "dkv_3xtf32": 0},
          f"flash launches {launches} != K1 2 x {L} x {steps}, K2 = K3 "
          f"{L} x {steps}, all on the tensor cores")
    del state, base_copy, alg, adapters, round_fn, st, out
    gc.collect()
    torch.cuda.empty_cache()

    # f32 at full width, reduced depth: flash vs dense attention, one
    # round from the same adapters and batch schedule
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pdims = dataclasses.replace(dims, n_layers=parity_layers)
    state = init_params(pdims, seed=0, dtype=torch.float32, device=DEV)
    t32 = dataclasses.replace(t, compute_dtype="float32")
    sched = [make_batch_indices(client_generator(7, int(c)), TRAIN_SEQS,
                                TRAIN_BS, 1) for c in ids]
    after = {}
    adapters = None
    fa.launch_count.update(dict.fromkeys(fa.launch_count, 0))
    for flash in (True, False):
        alg, drawn, round_fn = _fed_lora(pdims, state, t32, flash)
        adapters = adapters or drawn     # both rounds start from these
        o = round_fn(alg.server_init(adapters), None, data, ids, weights,
                     seed=7, batch_idx=sched)
        after[flash] = (o.server_state.params,
                        o.metrics["train_loss"].item())
    update = _max_abs_diff(after[True][0], adapters)
    diff = _max_abs_diff(after[True][0], after[False][0])
    parity = {"layers": parity_layers, "max_abs_adapter_diff": diff,
              "max_abs_adapter_update": update, "ratio": diff / update,
              "tol": PARITY_TOL, "loss_flash": after[True][1],
              "loss_dense": after[False][1],
              "launches": dict(fa.launch_count)}
    emit({"phase": "train", "f32_flash_vs_dense": parity})
    check(update > 0 and diff <= PARITY_TOL * update,
          f"f32 flash vs dense round: adapter diff {diff} > {PARITY_TOL} x "
          f"update {update}")
    # the flash round alone launches: K1 twice a layer and step (remat),
    # K2 and K3 once, all through the three-pass TF32 kernels
    n = parity_layers * steps_per_round
    want = {"fwd_tc": 0, "fwd_3xtf32": 2 * n, "dq_tc": 0, "dq_3xtf32": n,
            "dkv_tc": 0, "dkv_3xtf32": n}
    check(parity["launches"] == want, f"f32 round launches "
          f"{parity['launches']} != {want}")
    del state, alg, adapters, drawn, round_fn, after, o
    gc.collect()
    torch.cuda.empty_cache()
    res["f32_flash_vs_dense"] = parity
    return res


def phase_train_profile(top: int = 25) -> None:
    """Where one bf16 local step's device time goes at LLaMA-2-7B width:
    torch.profiler over one FedAvg round of one client with two local
    steps, after a warm-up round."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fedml_tpu_torch.config import TrainArgs
    from fedml_tpu_torch.llm.transformer import LLAMA2_7B, init_params

    state = init_params(LLAMA2_7B, seed=0, dtype=torch.bfloat16, device=DEV)
    t = TrainArgs(epochs=1, batch_size=TRAIN_BS, learning_rate=1e-3,
                  compute_dtype="bfloat16")
    alg, adapters, round_fn = _fed_lora(LLAMA2_7B, state, t, flash=True)
    data = _token_data(LLAMA2_7B.vocab_size, seed=0)
    ids, w = np.arange(1), np.ones(1, np.float32)
    st = round_fn(alg.server_init(adapters), None, data, ids, w,
                  seed=0).server_state
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        round_fn(st, None, data, ids, w, seed=1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = _kernel_rows(prof)
    busy_ms = sum(r[2] for r in rows)
    steps = TRAIN_SEQS // TRAIN_BS
    emit({"phase": "train_profile", "dtype": "bfloat16", "wall_ms": wall_ms,
          "local_steps": steps, "device_busy_ms": busy_ms,
          "device_idle_share": 1 - busy_ms / wall_ms,
          "top": [{"name": k[:90], "calls": n, "device_ms": ms,
                   "share_of_busy": ms / busy_ms}
                  for k, n, ms in rows[:top]]})
    del state, alg, adapters, round_fn, st
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 9
def _fedavg_cfg(device: str, **train):
    """The flagship config through `fedml_tpu_torch.init` (`train`
    overrides train_args keys; an "extra" dict goes to train_args.extra),
    its data cache a directory of the checkout that holds no data, so the
    loader takes the synthetic CIFAR-10 path."""
    import copy
    import os

    import fedml_tpu_torch

    d = copy.deepcopy(FEDAVG_CONFIG)
    d["train_args"].update(train)
    d["data_args"]["data_cache_dir"] = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "chiprun_out", "no_data")
    d["data_args"]["synthetic_samples_per_client"] = FEDAVG_SAMPLES
    return fedml_tpu_torch.init(config=d, device=device)


def _conv_matmul_flops(model, params, input_shape) -> int:
    """Forward conv + matmul FLOPs of one sample (2 x the MACs of every
    conv and dense layer, from the shapes one forward sees), the rule of
    `fedml_tpu/utils/flops.py`."""
    import torch

    from fedml_tpu_torch.models import hub

    total = [0]

    def conv(mod, _inp, out):
        total[0] += 2 * out.numel() * mod.kernel.shape[1] * mod.k * mod.k

    def dense(mod, _inp, out):
        total[0] += 2 * out.numel() * mod.kernel.shape[0]

    hooks = [m.register_forward_hook(conv if isinstance(m, hub.Conv)
                                     else dense)
             for m in model.modules() if isinstance(m, (hub.Conv, hub.Dense))]
    with torch.no_grad():
        hub.apply_fn(model)(params, torch.zeros(
            (1, *input_shape), device=next(iter(params.values())).device))
    for h in hooks:
        h.remove()
    return total[0]


def _fedavg_parity(ds) -> dict:
    """One f32 FedAvg round of the first clients at full ResNet-18-GN
    width on the card and on the CPU, from one init_params draw and one
    batch schedule, with cuDNN's and cuBLAS's TF32 off; and the same round
    in f64 on the CPU, which measures how far f32 arithmetic itself
    carries this round. On this data it carries it far: the images keep
    their class means (1.5 x N(0, 1) a pixel), so GroupNorm's backward
    subtracts nearly equal sums, and one local step of two f32 rounds
    differs from the f64 one by ~7e-4 of the largest update, seven steps
    by ~1e-2 (two CPU f32 runs at 3 and 8 threads: 4e-3). The card's f32
    round is therefore held to the repo's rule for rounds against the
    CPU's (1e-3 of the update) or, where f32 itself departs from exact
    arithmetic by more, to be as close to the f64 round as the CPU's f32
    round is, within 2x: a wrong convolution, padding or norm on the card
    departs by the size of the update. The card runs with the port's
    determinism (`_device.deterministic_cuda`, which the Simulator sets),
    so the round reads the same in every call."""
    import torch

    from fedml_tpu_torch._device import deterministic_cuda
    from fedml_tpu_torch.algorithms.builtin import build_algorithm
    from fedml_tpu_torch.config import TrainArgs
    from fedml_tpu_torch.core.algorithm import make_batch_indices
    from fedml_tpu_torch.models import hub
    from fedml_tpu_torch.parallel.round import (
        build_round_fn, client_generator,
    )

    n = FEDAVG_PARITY_CLIENTS
    cfg_t = FEDAVG_CONFIG["train_args"]
    t = TrainArgs(epochs=1, batch_size=cfg_t["batch_size"],
                  learning_rate=cfg_t["learning_rate"])
    model = hub.create("resnet18_gn", ds.num_classes, ds.x_train.shape[2:],
                       device="meta")
    params0 = hub.init_params(model, torch.Generator().manual_seed(0))
    sched = torch.stack([make_batch_indices(
        client_generator(0, c), ds.shard_size, t.batch_size, 1)
        for c in range(n)])
    ids, weights = np.arange(n), ds.counts[:n].astype(np.float32)
    deterministic_cuda(torch.device(DEV))
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        for name, dev, dt in (("cpu_f64", "cpu", torch.float64),
                              ("cpu", "cpu", torch.float32),
                              ("card", DEV, torch.float32)):
            t0 = time.perf_counter()
            alg = build_algorithm("FedAvg", hub.apply_fn(model), t)
            data = {"x": torch.from_numpy(ds.x_train[:n]).to(dev, dt),
                    "y": torch.from_numpy(ds.y_train[:n]).to(dev),
                    "mask": torch.from_numpy(ds.mask_train[:n]).to(dev, dt)}
            o = build_round_fn(alg, health_stats=True)(
                alg.server_init({k: v.to(dev, dt)
                                 for k, v in params0.items()}),
                None, data, ids, weights, seed=0, batch_idx=sched)
            out[name] = ({k: v.cpu().double()
                          for k, v in o.server_state.params.items()},
                         o.metrics["train_loss"].item(),
                         time.perf_counter() - t0)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32

    def dist(a, b):
        return max((out[a][0][k] - out[b][0][k]).abs().max().item()
                   for k in params0)

    update = max((out["cpu"][0][k] - params0[k]).abs().max().item()
                 for k in params0)
    diff, e_cpu, e_card = dist("card", "cpu"), dist("cpu", "cpu_f64"), \
        dist("card", "cpu_f64")
    res = {"clients": n, "local_steps": n * (ds.shard_size // t.batch_size),
           "max_abs_update": update, "max_abs_param_diff": diff,
           "ratio": diff / update, "tol": PARITY_TOL,
           "cpu_f32_vs_f64_ratio": e_cpu / update,
           "card_f32_vs_f64_ratio": e_card / update,
           "losses": {k: v[1] for k, v in out.items()},
           "seconds": {k: v[2] for k, v in out.items()}}
    emit({"phase": "fedavg", "f32_card_vs_cpu": res})
    check(update > 0 and (diff <= PARITY_TOL * update
                          or e_card <= 2 * e_cpu),
          f"f32 FedAvg round on the card vs the CPU: param diff {diff} > "
          f"{PARITY_TOL} x update {update}, and the card's distance to the "
          f"f64 round {e_card} > 2 x the CPU f32 round's {e_cpu}")
    return res


def phase_fedavg() -> dict:
    """Phase 8 (module docstring)."""
    import torch

    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.ops import flash_attention as fa
    from fedml_tpu_torch.ops import paged_attention as pa
    from fedml_tpu_torch.simulation.simulator import Simulator

    t0 = time.perf_counter()
    cfg = _fedavg_cfg(DEV)
    ds = loader.load(cfg)
    check(ds.synthetic, "the flagship data is not the synthetic CIFAR-10")
    data_s = time.perf_counter() - t0
    parity = _fedavg_parity(ds)

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    sim = Simulator(cfg, ds)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    bs = cfg.train_args.batch_size
    steps = ds.num_clients * (ds.shard_size // bs)
    flops = 3 * _conv_matmul_flops(sim.model, sim.params,
                                   ds.x_train.shape[2:]) * bs * steps
    fa.launch_count.update(dict.fromkeys(fa.launch_count, 0))
    pa.launch_count = 0
    rows = []
    for r in range(1 + FEDAVG_ROUNDS):     # round 0 is the warm round
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = sim.run_round(r)
        torch.cuda.synchronize()
        rows.append({"round": r, "ms": (time.perf_counter() - t0) * 1e3,
                     "train_loss": m["train_loss"],
                     "train_acc": m["train_acc"]})
    launches = {**fa.launch_count, "paged": pa.launch_count}
    peak = torch.cuda.max_memory_allocated()
    timed = [r["ms"] for r in rows[1:]]
    med = statistics.median(timed)
    ev = sim.evaluate()
    res = {
        "clients": ds.num_clients, "shard_size": ds.shard_size,
        "local_steps_per_round": steps, "data_s": data_s, "init_s": init_s,
        "rounds": rows, "ms_per_round_median": med,
        "ms_per_round_min": min(timed), "ms_per_round_max": max(timed),
        "rounds_per_s": 1e3 / med, "ms_per_local_step": med / steps,
        "max_memory_allocated_bytes": peak,
        "conv_matmul_flops_per_round": flops,
        "achieved_tflops": flops / med / 1e9,
        "bf16_peak_share": flops / (med / 1e3) / peak_flops(torch.bfloat16),
        "test_acc": ev["test_acc"], "test_loss": ev["test_loss"],
        "k1_k4_launches": launches,
    }
    emit({"phase": "fedavg", **res})
    losses = [r["train_loss"] for r in rows]
    check(all(np.isfinite(losses)), "a FedAvg round's loss is not finite")
    check(losses[-1] < losses[0], f"train_loss did not fall: {losses}")
    check(not any(launches.values()),
          f"the FedAvg path launched a flash or paged kernel: {launches}")
    del sim
    gc.collect()
    torch.cuda.empty_cache()
    res["f32_card_vs_cpu"] = parity
    return res


def phase_fedavg_profile(top: int = 25) -> None:
    """Where one flagship round's time goes: torch.profiler over one bf16
    round after a warm round: device busy and idle share, the top kernels
    by device time, and kernel launches per local step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.simulation.simulator import Simulator

    cfg = _fedavg_cfg(DEV)
    ds = loader.load(cfg)
    sim = Simulator(cfg, ds)
    sim.run_round(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run_round(1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = _kernel_rows(prof)
    busy_ms = sum(r[2] for r in rows)
    steps = ds.num_clients * (ds.shard_size // cfg.train_args.batch_size)
    launches = sum(r[1] for r in rows)
    emit({"phase": "fedavg_profile", "dtype": "bfloat16", "wall_ms": wall_ms,
          "local_steps": steps, "device_busy_ms": busy_ms,
          "device_idle_share": 1 - busy_ms / wall_ms,
          "kernel_launches": launches,
          "launches_per_local_step": launches / steps,
          "top": [{"name": k[:90], "calls": n, "device_ms": ms,
                   "share_of_busy": ms / busy_ms}
                  for k, n, ms in rows[:top]]})
    del sim
    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def _tf32_off():
    """cuBLAS's and cuDNN's TF32 off inside, restored after."""
    import torch

    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _parity_params():
    """ResNet-18-GN's parameters from one CPU draw (the parity rounds')."""
    import torch

    from fedml_tpu_torch.models import hub

    model = hub.create("resnet18_gn", 10, (32, 32, 3), device="meta")
    return hub.init_params(model, torch.Generator().manual_seed(0))


def f32_round_digest(group: int = 1) -> str:
    """sha256 of one f32 round of FEDAVG_PARITY_CLIENTS clients at full
    ResNet-18-GN width through the Simulator (its parameters after the
    round, then its metrics row), TF32 off, under the determinism setting
    the Simulator makes. Phase fedsim runs this in its own process and in
    a child process."""
    import hashlib

    from fedml_tpu_torch.simulation.simulator import Simulator

    n = FEDAVG_PARITY_CLIENTS
    cfg = _fedavg_cfg(DEV, client_num_in_total=n, client_num_per_round=n,
                      compute_dtype="float32",
                      extra={"clients_per_device_parallel": group})
    with _tf32_off():
        sim = Simulator(cfg, params=_parity_params())
        row = sim.run_round(0)
    h = hashlib.sha256()
    for k in sorted(sim.server_state.params):
        h.update(sim.server_state.params[k].cpu().numpy().tobytes())
    h.update(json.dumps(row, sort_keys=True).encode())
    return h.hexdigest()


def _one_step_rounds(ds) -> dict:
    """One f32 FedAvg round of FEDAVG_PARITY_CLIENTS clients, ONE local
    step each, from one parameter draw and one batch schedule, TF32 off:
    on the CPU in f64 and f32, and on the card at G = 1 and G = 4 (one
    vmapped group), each with cuDNN deterministic (the Simulator's
    setting) and without. One step is far better conditioned than the
    flagship round's seven (PERF.md §6), so the card is held to the plain
    rule, 1e-3 of the CPU round's largest update, and G = 4 to the same
    rule against G = 1; every run's distance to the f64 round and the
    card's worst leaves are reported beside them."""
    import torch

    from fedml_tpu_torch.algorithms.builtin import build_algorithm
    from fedml_tpu_torch.config import TrainArgs
    from fedml_tpu_torch.models import hub
    from fedml_tpu_torch.parallel.round import (
        build_round_fn, draw_schedules,
    )

    n = FEDAVG_PARITY_CLIENTS
    cfg_t = FEDAVG_CONFIG["train_args"]
    t = TrainArgs(epochs=1, batch_size=cfg_t["batch_size"],
                  learning_rate=cfg_t["learning_rate"])
    model = hub.create("resnet18_gn", ds.num_classes, ds.x_train.shape[2:],
                       device="meta")
    params0 = _parity_params()
    alg = build_algorithm("FedAvg", hub.apply_fn(model), t)
    ids, weights = np.arange(n), ds.counts[:n].astype(np.float32)
    sched = draw_schedules(alg, 0, ids, ds.shard_size)[:, :1]
    runs = (("cpu_f64", "cpu", torch.float64, 1, True),
            ("cpu", "cpu", torch.float32, 1, True),
            ("card", DEV, torch.float32, 1, True),
            ("card_g4", DEV, torch.float32, 4, True),
            ("card_nondet", DEV, torch.float32, 1, False),
            ("card_g4_nondet", DEV, torch.float32, 4, False))
    out = {}
    det = torch.backends.cudnn.deterministic
    try:
        with _tf32_off():
            for name, dev, dt, g, deterministic in runs:
                torch.backends.cudnn.deterministic = deterministic
                data = {"x": torch.from_numpy(ds.x_train[:n]).to(dev, dt),
                        "y": torch.from_numpy(ds.y_train[:n]).to(dev),
                        "mask": torch.from_numpy(ds.mask_train[:n]).to(
                            dev, dt)}
                o = build_round_fn(alg, group_size=g)(
                    alg.server_init({k: v.to(dev, dt)
                                     for k, v in params0.items()}),
                    None, data, ids, weights, seed=0, batch_idx=sched)
                out[name] = ({k: v.cpu().double()
                              for k, v in o.server_state.params.items()},
                             o.metrics["train_loss"].item())
    finally:
        torch.backends.cudnn.deterministic = det

    def leaf(a, b, k):
        return (out[a][0][k] - out[b][0][k]).abs().max().item()

    def dist(a, b):
        return max(leaf(a, b, k) for k in params0)

    update = max((out["cpu"][0][k] - params0[k].double()).abs().max().item()
                 for k in params0)
    worst = sorted(params0, key=lambda k: -leaf("card", "cpu_f64", k))[:3]
    res = {"clients": n, "local_steps": n, "max_abs_update": update,
           "card_vs_cpu_ratio": dist("card", "cpu") / update,
           "g4_vs_g1_ratio": dist("card_g4", "card") / update,
           "tol": PARITY_TOL,
           "vs_f64_ratio": {k: dist(k, "cpu_f64") / update
                            for k, *_ in runs[1:]},
           "card_worst_leaves_vs_f64": {
               k: leaf("card", "cpu_f64", k) / update for k in worst},
           "losses": {k: v[1] for k, v in out.items()}}
    emit({"phase": "fedsim", "one_step_f32": res})
    check(update > 0 and res["card_vs_cpu_ratio"] <= PARITY_TOL,
          f"one-step f32 round, card vs CPU: {res['card_vs_cpu_ratio']} "
          f"of the update > {PARITY_TOL}")
    check(res["g4_vs_g1_ratio"] <= PARITY_TOL,
          f"one-step f32 round on the card, G = 4 vs G = 1: "
          f"{res['g4_vs_g1_ratio']} of the update > {PARITY_TOL}")
    return res


def _timed_rounds(sim, first: int, n: int, modes=None) -> list:
    """`n` synchronised rounds from round `first`: ms each and the loss;
    `modes[i]`, when given, sets cuDNN's deterministic flag for round i."""
    import torch

    rows = []
    for i in range(n):
        if modes is not None:
            torch.backends.cudnn.deterministic = modes[i] == "on"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = sim.run_round(first + i)
        torch.cuda.synchronize()
        rows.append({"round": first + i,
                     "ms": (time.perf_counter() - t0) * 1e3,
                     "train_loss": m["train_loss"],
                     **({"determinism": modes[i]} if modes else {})})
    return rows


def _flagship_groups(ds, g1_warm: bool = True) -> dict:
    """The flagship at G = 1 (one timed round, the determinism setting on;
    after a warm round unless `g1_warm` is false, when phase fedavg has
    just run the same round in this process), at G = 4 (the determinism
    setting on and off, a round each: its cost; a warm round read within
    their spread on the H100, so there is none) and
    at G = 10 (a warm round, then FEDSIM_ROUNDS timed): ms a round,
    rounds/s, ms a group step, peak memory, the losses. (The profiled
    rounds of two groups went when phase cross_silo_secure joined the
    script: PERF.md keeps their readings, and `--only fedavg_profile`
    profiles the flagship round.)"""
    import torch

    from fedml_tpu_torch.parallel.round import group_width
    from fedml_tpu_torch.simulation.simulator import Simulator

    steps = ds.shard_size // FEDAVG_CONFIG["train_args"]["batch_size"]
    res = {}
    for g in (1,) + FEDSIM_GROUPS:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        sim = Simulator(_fedavg_cfg(
            DEV, extra={"clients_per_device_parallel": g}), ds)
        gw = group_width(ds.num_clients, g)
        warm = (_timed_rounds(sim, 0, 1)
                if {1: g1_warm, 4: False}.get(g, True) else [])
        extra = {}
        if g == 4:
            modes = ("on", "off")
            timed = _timed_rounds(sim, 0, len(modes), modes)
            torch.backends.cudnn.deterministic = True
            on = [r["ms"] for r in timed if r["determinism"] == "on"]
            off = [r["ms"] for r in timed if r["determinism"] == "off"]
            extra = {"determinism_on_ms": on, "determinism_off_ms": off,
                     "determinism_cost": statistics.mean(on)
                     / statistics.mean(off) - 1}
        else:
            timed = _timed_rounds(sim, len(warm),
                                  1 if g == 1 else FEDSIM_ROUNDS)
        med = statistics.median(r["ms"] for r in timed)
        peak = torch.cuda.max_memory_allocated()
        groups = ds.num_clients // gw
        res[g] = {"group_size": gw, "groups_per_round": groups,
                  "rounds": warm + timed, "ms_per_round_median": med,
                  "rounds_per_s": 1e3 / med,
                  "ms_per_group_step": med / (groups * steps),
                  "ms_per_client_step": med / (ds.num_clients * steps),
                  "max_memory_allocated_bytes": peak, **extra,
                  "seconds": time.perf_counter() - t0}
        emit({"phase": "fedsim", "flagship": res[g]})
        losses = [r["train_loss"] for r in res[g]["rounds"]]
        check(all(np.isfinite(losses)), f"G = {g}: a loss is not finite")
        if len(losses) > 1:
            check(losses[-1] < losses[0], f"G = {g}: the loss did not "
                  f"fall: {losses}")
        del sim
        gc.collect()
        torch.cuda.empty_cache()
    return res


def _stateful_at_flagship(ds) -> dict:
    """SCAFFOLD, FedDyn and Mime, one round each at the flagship width
    (100 clients, G = 10): the loss finite, the client state (Mime: the
    server momentum) moved, the peak memory. Then SCAFFOLD over 12
    clients, 5 a round: every unsampled client's state bitwise unchanged
    by a round, every sampled one's moved."""
    import torch

    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.simulation.simulator import Simulator

    res = {}
    for opt in ("SCAFFOLD", "FedDyn", "Mime"):
        torch.cuda.reset_peak_memory_stats()
        sim = Simulator(_fedavg_cfg(
            DEV, federated_optimizer=opt,
            extra={"clients_per_device_parallel": 10}), ds)
        (row,) = _timed_rounds(sim, 0, 1)
        state = (sim.client_states if sim.client_states is not None
                 else sim.server_state.extra["m"])
        moved = max(v.abs().max().item() for v in state.values())
        res[opt] = {**row, "state_max_abs": moved,
                    "max_memory_allocated_bytes":
                        torch.cuda.max_memory_allocated()}
        check(np.isfinite(row["train_loss"]), f"{opt}: loss not finite")
        check(moved > 0, f"{opt}: the client state did not move")
        del sim, state
        gc.collect()
        torch.cuda.empty_cache()
    cfg = _fedavg_cfg(DEV, federated_optimizer="SCAFFOLD",
                      client_num_in_total=12, client_num_per_round=5,
                      extra={"clients_per_device_parallel": 5})
    sim = Simulator(cfg, loader.load(cfg))
    sim.run_round(0)
    before = {k: v.clone() for k, v in sim.client_states.items()}
    ids = set(sim.sample_clients(1).tolist())
    sim.run_round(1)
    same = [all(torch.equal(sim.client_states[k][c], before[k][c])
                for k in before) for c in range(12)]
    res["unsampled_unchanged"] = all(same[c] for c in range(12)
                                     if c not in ids)
    res["sampled_moved"] = not any(same[c] for c in ids)
    emit({"phase": "fedsim", "stateful": res})
    check(res["unsampled_unchanged"], "SCAFFOLD: an unsampled client's "
          "state changed")
    check(res["sampled_moved"], "SCAFFOLD: a sampled client's state did "
          "not move")
    del sim, before
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _same_run(a, b) -> bool:
    """Histories equal and parameters, server extra and client states
    bitwise."""
    import torch

    from fedml_tpu_torch.ops.tree import tree_leaves

    def leaves(s):
        return [x for t in (s.server_state.params, s.server_state.extra,
                            s.client_states) if t is not None
                for x in tree_leaves(t)]

    la, lb = leaves(a), leaves(b)
    return a.history == b.history and len(la) == len(lb) and all(
        torch.equal(x, y) for x, y in zip(la, lb))


def _bitwise_bars() -> dict:
    """The reference's bars on the card at the flagship model with a
    reduced cohort of FEDSIM_SMALL clients, bf16, G = 2: four rounds as a
    block of K = 4 against one at a time; cohort_chunk 4 against
    single-shot; SCAFFOLD (6 of the clients a round) killed after two
    rounds and resumed from its checkpoint against an uninterrupted run."""
    import os
    import shutil

    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.simulation.simulator import Simulator

    n = FEDSIM_SMALL

    def cfg(**extra):
        opt = extra.pop("opt", "FedAvg")
        m = extra.pop("m", n)
        return _fedavg_cfg(DEV, federated_optimizer=opt,
                           client_num_in_total=n, client_num_per_round=m,
                           comm_round=4,
                           extra={"clients_per_device_parallel": 2, **extra})

    ds = loader.load(cfg())
    t0 = time.perf_counter()
    ref = Simulator(cfg(), ds)
    ref.run()
    blk = Simulator(cfg(rounds_per_block=4), ds)
    blk.run()
    chk = Simulator(cfg(cohort_chunk=4), ds)
    chk.run()
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "chiprun_out", "fedsim_ckpt")
    shutil.rmtree(d, ignore_errors=True)
    full = Simulator(cfg(opt="SCAFFOLD", m=6), ds)
    full.run()
    first = Simulator(cfg(opt="SCAFFOLD", m=6), ds)
    first.run(num_rounds=2, checkpoint_dir=d, checkpoint_every=1)
    resumed = Simulator(cfg(opt="SCAFFOLD", m=6), ds)
    resumed.run(checkpoint_dir=d, checkpoint_every=0)
    shutil.rmtree(d, ignore_errors=True)
    res = {"clients": n, "rounds": 4,
           "block_equals_per_round": _same_run(ref, blk)
           and blk.block_fn is not None,
           "chunked_equals_single_shot": _same_run(ref, chk),
           "resumed_equals_uninterrupted": _same_run(full, resumed),
           "losses": [r["train_loss"] for r in ref.history],
           "seconds": time.perf_counter() - t0}
    emit({"phase": "fedsim", "bitwise": res})
    for k in ("block_equals_per_round", "chunked_equals_single_shot",
              "resumed_equals_uninterrupted"):
        check(res[k], f"on the card: {k} is false")
    return res


def phase_fedsim(fedavg_ran: bool = False) -> dict:
    """Phase 10 (module docstring). `fedavg_ran`: phase fedavg ran the
    flagship's G = 1 round in this process, so G = 1 needs no warm
    round here."""
    import os
    import subprocess
    import warnings

    import torch

    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.ops import flash_attention as fa
    from fedml_tpu_torch.ops import paged_attention as pa

    warnings.filterwarnings("error", message=VMAP_FALLBACK)
    fa.launch_count.update(dict.fromkeys(fa.launch_count, 0))
    pa.launch_count = 0
    t0 = time.perf_counter()
    # C.1: the same f32 round twice here and once in a child process
    here = [f32_round_digest(), f32_round_digest()]
    child = subprocess.run(
        [sys.executable, "-c",
         "import chip_smoke; print(chip_smoke.f32_round_digest())"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=600)
    check(child.returncode == 0,
          f"the digest's child process failed: {child.stderr[-2000:]}")
    there = child.stdout.strip().splitlines()[-1]
    g4 = [f32_round_digest(4), f32_round_digest(4)]
    c1 = {"digests": here + [there], "g4_digests": g4,
          "repeats_in_process": here[0] == here[1],
          "repeats_across_processes": here[0] == there,
          "g4_repeats": g4[0] == g4[1], "seconds": time.perf_counter() - t0}
    emit({"phase": "fedsim", "f32_round_repeats": c1})
    check(c1["repeats_in_process"] and c1["repeats_across_processes"]
          and c1["g4_repeats"], f"the f32 round does not repeat bit for "
          f"bit: {c1}")
    ds = loader.load(_fedavg_cfg(DEV))
    res = {"f32_round_repeats": c1}
    for part, fn in (
            ("one_step_f32", lambda: _one_step_rounds(ds)),
            ("flagship", lambda: _flagship_groups(ds, not fedavg_ran)),
            ("stateful", lambda: _stateful_at_flagship(ds)),
            ("bitwise", _bitwise_bars)):
        t1 = time.perf_counter()
        res[part] = fn()
        emit({"phase": "fedsim", "part": part,
              "seconds": time.perf_counter() - t1})
    launches = {**fa.launch_count, "paged": pa.launch_count}
    res["k1_k4_launches"] = launches
    emit({"phase": "fedsim", "k1_k4_launches": launches,
          "seconds": time.perf_counter() - t0})
    check(not any(launches.values()),
          f"the simulation engine launched a flash or paged kernel: "
          f"{launches}")
    return res


# ----------------------------------------------------------------- phase 11
def _plugin_cfg(device: str, sections: dict, **train):
    """The flagship config (`_fedavg_cfg`) with a configuration's
    sections merged in; `train` overrides train_args keys."""
    import copy

    extra = {"clients_per_device_parallel": PLUGIN_G,
             **train.pop("extra", {})}
    cfg = _fedavg_cfg(device, extra=extra, **train)
    for sec, kv in copy.deepcopy(sections).items():
        if sec == "train_args":
            cfg.train_args.extra.update(kv)
            continue
        dc = getattr(cfg, sec)
        for k, v in kv.items():
            if k in {f.name for f in dataclasses.fields(dc)}:
                setattr(dc, k, v)
            else:
                dc.extra[k] = v
    cfg.validate()
    return cfg


class _HookTimer:
    """CUDA events around every call of the round's plugin hooks; `take()`
    returns the device ms between each pair, summed, since the last
    take."""

    def __init__(self):
        self.pairs = []

    def wrap(self, f):
        import torch

        if f is None:
            return None

        def timed(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = f(*a, **kw)
            end.record()
            self.pairs.append((start, end))
            return out

        return timed

    def take(self) -> tuple:
        import torch

        torch.cuda.synchronize()
        ms = sum(s.elapsed_time(e) for s, e in self.pairs)
        n, self.pairs = len(self.pairs), []
        return ms, n


def _timed_hooks(sim) -> _HookTimer:
    """Rebuild the Simulator's round with its plugin hooks (and EF-TopK's
    finish_update) between CUDA events."""
    from fedml_tpu_torch.parallel.round import build_round_fn

    timer = _HookTimer()
    hooks = ("aggregate_full", "postprocess_update", "postprocess_agg")
    plugins = {k: timer.wrap(v) if k in hooks else v
               for k, v in sim._plugins.items()}
    if sim.alg.finish_update is not None:
        sim.alg = dataclasses.replace(
            sim.alg, finish_update=timer.wrap(sim.alg.finish_update))
    sim.round_fn = build_round_fn(sim.alg, group_size=sim.group_size,
                                  health_stats=sim._health_enabled,
                                  **plugins)
    return timer


def _plugins_at_flagship(ds) -> dict:
    """Each of PLUGIN_CONFIGS at the flagship (module docstring)."""
    import torch

    from fedml_tpu_torch.simulation.simulator import Simulator

    res = {}
    for name, sections in PLUGIN_CONFIGS.items():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sim = Simulator(_plugin_cfg(DEV, sections), ds)
        timer = _timed_hooks(sim)
        rows = []
        for r in range(1 + PLUGIN_ROUNDS[name]):   # round 0 is the warm one
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            m = sim.run_round(r)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t1) * 1e3
            hook_ms, calls = timer.take()
            rows.append({"round": r, "ms": ms, "plugin_ms": hook_ms,
                         "hook_calls": calls, "train_loss": m["train_loss"],
                         **({"dp_epsilon": m["dp_epsilon"]}
                            if "dp_epsilon" in m else {})})
        timed = rows[1:]
        hook = sim.hook_state
        res[name] = {
            "rounds": rows,
            "ms_per_round_median": statistics.median(r["ms"] for r in timed),
            "plugin_ms_median": statistics.median(
                r["plugin_ms"] for r in timed),
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "hook_state_bytes": 0 if hook is None else sum(
                v.numel() * v.element_size() for v in hook.values()
                if v is not None),
            "client_state_bytes": 0 if sim.client_states is None else sum(
                v.numel() * v.element_size()
                for v in _leaves(sim.client_states)),
            "health_flags": sum(sim.health.flag_counts.values()),
            "seconds": time.perf_counter() - t0}
        emit({"phase": "plugins", "config": name, "nvidia_smi":
              nvidia_smi_line(), **res[name]})
        losses = [r["train_loss"] for r in rows]
        check(all(np.isfinite(losses)), f"{name}: a loss is not finite: "
              f"{losses}")
        del sim, hook
    plain = res["plain"]["ms_per_round_median"]
    for name in res:
        res[name]["vs_plain"] = res[name]["ms_per_round_median"] / plain - 1
    return res


def _leaves(tree):
    from fedml_tpu_torch.ops.tree import tree_leaves

    return tree_leaves(tree)


def _plugin_parity(ds) -> dict:
    """The f32 round of FEDAVG_PARITY_CLIENTS clients, one local step
    each, with krum, dp_clip (1.0) and top-k (0.05) in the Simulator's
    order, on the card (in one vmapped group, as the flagship's clients
    train, and, reported, one client at a time) and on the CPU, from one
    parameter draw and batch schedule, TF32 off. Top-k is
    discontinuous: where a leaf's k-th magnitude falls between two
    coordinates whose f32 values the card and the CPU round apart, each
    side keeps another one; that coordinate differs by about the
    threshold, and dp_clip's global norm carries the difference to every
    kept coordinate. So the round is held in its two halves. The
    training: the kept client's update before the transforms within
    1e-3 of its largest value, card against CPU. The plugins: the
    card's transforms and
    krum fed the CPU's updates, within 1e-6 of the CPU's aggregate with
    the same coordinates kept, and krum keeping the same client
    everywhere. The whole round's ratio (to the CPU round's largest
    update), that ratio on the coordinates both sides kept or dropped,
    and the coordinates kept on one side only are reported beside
    them."""
    import torch

    from fedml_tpu_torch import compression, security
    from fedml_tpu_torch import dp as dp_mod
    from fedml_tpu_torch.algorithms.builtin import build_algorithm
    from fedml_tpu_torch.config import TrainArgs
    from fedml_tpu_torch.models import hub
    from fedml_tpu_torch.ops import keys
    from fedml_tpu_torch.ops.tree import tree_map
    from fedml_tpu_torch.parallel.round import (
        build_round_fn, draw_schedules,
    )
    from fedml_tpu_torch.security import defenses
    from fedml_tpu_torch.simulation.simulator import _compose

    n = FEDAVG_PARITY_CLIENTS
    cfg = _plugin_cfg("cpu", {
        "security_args": {"enable_defense": True, "defense_type": "krum",
                          "defense_spec": {"byzantine_client_num": 1}},
        "dp_args": {"enable_dp": True, "dp_solution_type": "dp_clip",
                    "clipping_norm": 1.0},
        "train_args": {"compression": "topk", "compression_ratio": 0.05}},
        client_num_in_total=n, client_num_per_round=n,
        compute_dtype="float32")
    pipeline = security.build_server_pipeline(*security.from_config(cfg))
    post = _compose(compression.make_compression_transform("topk", 0.05),
                    dp_mod.from_config(cfg).client_transform())
    runs = (("cpu", "cpu", 1), ("card", DEV, n), ("card_g1", DEV, 1))
    seen = {name: {"pre": {}} for name, *_ in runs}

    def hooks(name):
        def post_seen(upd, key):
            seen[name]["pre"][key[-1]] = tree_map(
                lambda a: a.detach().cpu().double(), upd)
            return post(upd, key)

        def agg_seen(stacked, w, ctx):
            U, _ = defenses.stack_flat(stacked)
            seen[name]["kept"] = int(defenses.krum_select(U, 1)[0])
            agg, st = pipeline(stacked, w, ctx)
            seen[name]["agg"] = tree_map(lambda a: a.detach().cpu(), agg)
            return agg, st
        return post_seen, agg_seen

    cfg_t = FEDAVG_CONFIG["train_args"]
    t = TrainArgs(epochs=1, batch_size=cfg_t["batch_size"],
                  learning_rate=cfg_t["learning_rate"])
    model = hub.create("resnet18_gn", ds.num_classes, ds.x_train.shape[2:],
                       device="meta")
    params0 = _parity_params()
    alg = build_algorithm("FedAvg", hub.apply_fn(model), t)
    ids, weights = np.arange(n), ds.counts[:n].astype(np.float32)
    sched = draw_schedules(alg, 0, ids, ds.shard_size)[:, :1]
    out = {}
    with _tf32_off():
        for name, dev, g in runs:
            t0 = time.perf_counter()
            data = {"x": torch.from_numpy(ds.x_train[:n]).to(dev),
                    "y": torch.from_numpy(ds.y_train[:n]).to(dev),
                    "mask": torch.from_numpy(ds.mask_train[:n]).to(dev)}
            post_seen, agg_seen = hooks(name)
            o = build_round_fn(alg, group_size=g, aggregate_full=agg_seen,
                               postprocess_update=post_seen)(
                alg.server_init({k: v.to(dev) for k, v in params0.items()}),
                None, data, ids, weights, seed=0, batch_idx=sched)
            out[name] = ({k: v.cpu().double()
                          for k, v in o.server_state.params.items()},
                         time.perf_counter() - t0)
        # the card's transforms and krum on the CPU's updates
        rows = [post({k: v.float().to(DEV) for k, v in
                      seen["cpu"]["pre"][int(c)].items()}, (0, int(c)))
                for c in ids]
        same_in, _ = pipeline(
            {k: torch.stack([r[k] for r in rows]) for k in params0},
            torch.from_numpy(weights).to(DEV),
            {"key": keys.fold(0, keys.SERVER), "state": None,
             "ids": torch.from_numpy(ids).to(DEV), "params": params0})
    p0 = {k: v.double() for k, v in params0.items()}
    upd = {k: out[k][0] for k in ("cpu", "card")}
    kc = seen["cpu"]["kept"]
    pre = {name: seen[name]["pre"][kc] for name in seen}
    pre_max = max(v.abs().max().item() for v in pre["cpu"].values())

    def diff(a, b):
        return max((a[k].double() - b[k].double()).abs().max().item()
                   for k in p0)

    update = max((upd["cpu"][k] - p0[k]).abs().max().item() for k in p0)
    moved = {s: {k: upd[s][k] != p0[k] for k in p0} for s in upd}
    agreed = max(((upd["card"][k] - upd["cpu"][k]).abs()
                  * (moved["card"][k] == moved["cpu"][k])).max().item()
                 for k in p0)
    agg_cpu = seen["cpu"]["agg"]
    same_mask = all(torch.equal(same_in[k].cpu() != 0, agg_cpu[k] != 0)
                    for k in p0)
    res = {"clients": n, "local_steps": n, "card_group": n,
           "max_abs_update": update, "tol": PARITY_TOL,
           "krum_kept": {s: seen[s]["kept"] for s in seen},
           "pre_transform_ratio": {
               s: diff(pre[s], pre["cpu"]) / pre_max
               for s in ("card", "card_g1")},
           "same_input_rel": diff({k: v.cpu() for k, v in same_in.items()},
                                  agg_cpu)
           / max(v.abs().max().item() for v in agg_cpu.values()),
           "same_input_same_coordinates": same_mask,
           "whole_round_ratio": diff(upd["card"], upd["cpu"]) / update,
           "agreed_coordinates_ratio": agreed / update,
           "topk_kept_on_one_side_only": sum(
               int((moved["card"][k] != moved["cpu"][k]).sum()) for k in p0),
           "coordinates_moved": sum(int(moved["cpu"][k].sum()) for k in p0),
           "seconds": {k: v[1] for k, v in out.items()}}
    emit({"phase": "plugins", "f32_card_vs_cpu": res})
    check(len(set(res["krum_kept"].values())) == 1,
          f"krum kept another client somewhere: {res['krum_kept']}")
    check(update > 0 and res["pre_transform_ratio"]["card"] <= PARITY_TOL,
          f"f32 krum + dp_clip + top-k round, card vs CPU: {res}")
    check(res["same_input_rel"] <= 1e-6 and same_mask,
          f"the plugins on the card fed the CPU's updates: {res}")
    return res


def _plugin_chunks_bitwise(ds) -> dict:
    """(b), wise_median under chaos faults, over FEDSIM_SMALL clients of
    the flagship model at G = 2, three rounds: cohort chunks of 4 against
    the single-shot round, bitwise."""
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.simulation.simulator import Simulator

    n = FEDSIM_SMALL
    sections = PLUGIN_CONFIGS["b_median_chaos"]

    def cfg(**extra):
        return _plugin_cfg(DEV, sections, client_num_in_total=n,
                           client_num_per_round=n, comm_round=3,
                           extra={"clients_per_device_parallel": 2, **extra})

    small = loader.load(cfg())
    t0 = time.perf_counter()
    ref = Simulator(cfg(), small)
    ref.run()
    chk = Simulator(cfg(cohort_chunk=4), small)
    chk.run()
    res = {"clients": n, "rounds": 3,
           "chunked_equals_single_shot": _same_run(ref, chk),
           "injected_faults": sum(ref.health.flag_counts.values()),
           "losses": [r["train_loss"] for r in ref.history],
           "seconds": time.perf_counter() - t0}
    emit({"phase": "plugins", "bitwise": res})
    check(res["chunked_equals_single_shot"], "on the card, under wise_median "
          "and chaos faults: chunked != single-shot")
    return res


def phase_plugins() -> dict:
    """Phase 10 (module docstring)."""
    import warnings

    import torch

    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.ops import flash_attention as fa
    from fedml_tpu_torch.ops import paged_attention as pa

    warnings.filterwarnings("error", message=VMAP_FALLBACK)
    fa.launch_count.update(dict.fromkeys(fa.launch_count, 0))
    pa.launch_count = 0
    t0 = time.perf_counter()
    ds = loader.load(_fedavg_cfg(DEV))
    res = {"flagship": _plugins_at_flagship(ds),
           "f32_card_vs_cpu": _plugin_parity(ds),
           "bitwise": _plugin_chunks_bitwise(ds)}
    launches = {**fa.launch_count, "paged": pa.launch_count}
    res["k1_k4_launches"] = launches
    emit({"phase": "plugins", "nvidia_smi": nvidia_smi_line(),
          "vs_plain": {k: v["vs_plain"] for k, v in res["flagship"].items()},
          "k1_k4_launches": launches, "seconds": time.perf_counter() - t0})
    check(not any(launches.values()),
          f"the plugins launched a flash or paged kernel: {launches}")
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ----------------------------------------------------------------- phase 12
def _cs_cfg(device: str, run_id: str, rounds: int, **train):
    """The flagship config (`_fedavg_cfg`) as a cross-silo run over
    loopback; `train` overrides train_args keys, a "common_extra" dict
    goes to common_args.extra and a "comm_extra" dict (transport,
    comm_codec) to comm_args.extra."""
    common = train.pop("common_extra", {})
    comm = train.pop("comm_extra", {})
    cfg = _fedavg_cfg(device, comm_round=rounds, **train)
    cfg.common_args.training_type = "cross_silo"
    cfg.common_args.extra.update(common)
    cfg.comm_args.extra.update(comm, run_id=run_id)
    cfg.validate()
    return cfg


def _federation(cfg, silos: list, init=None, schedules=None,
                timeout: float = 900.0, clients_must_finish: bool = True,
                eval_fn=None, prepare=None, expect_error: bool = False):
    """One cross-silo federation through `FedMLRunner`: a server and one
    client per (x, y) of `silos`, each rank's receive loop a thread of this
    process (SecAgg's managers with `train_args.extra.secagg`). `init`
    (the server's initial params) and `schedules[i](r)` (client i+1's
    batch order) are handed over when given, and `eval_fn` (the server's
    per-round hook) too; `prepare(clients)` runs before the start. With
    `expect_error` the server's failure is the expected outcome. Returns
    (the server manager, the clients that finished, the client
    managers).
    A client whose S2C_FINISH a chaos plan dropped never finishes: the
    server stops its transport, retransmitter included, right after
    sending it, as the JAX server does (ROADMAP C.5);
    `clients_must_finish=False` allows that, and every client still
    running is stopped at the end."""
    import torch

    from fedml_tpu_torch.comm import release_broker, release_router
    from fedml_tpu_torch.models import hub
    from fedml_tpu_torch.runner import FedMLRunner

    model = hub.create(cfg.model_args.model, 10, silos[0][0].shape[1:],
                       device="meta")
    srv = FedMLRunner(cfg, model=model, role="server", eval_fn=eval_fn,
                      **({} if init is None else {"params": init})).runner
    clients = [FedMLRunner(cfg, dataset=xy, model=model, role="client",
                           rank=i + 1, **({} if schedules is None else
                                          {"batch_schedule": schedules[i]})
                           ).runner for i, xy in enumerate(silos)]
    if prepare is not None:
        prepare(clients)
    try:
        srv.run(background=True)
        for c in clients:
            c.run(background=True)
            c.announce_ready()
        check(srv.done.wait(timeout), "the cross-silo run did not finish")
        finished = sum(c.done.wait(60 if clients_must_finish else 5)
                       for c in clients)
        check(finished == len(clients) or not clients_must_finish,
              f"{len(clients) - finished} client(s) did not finish")
        check(srv.error is None or expect_error,
              f"the cross-silo server failed: {srv.error}")
    finally:
        for c in clients:
            if not c.done.is_set():
                if hasattr(c, "_stopped"):
                    c._stopped.set()
                c.comm.stop()
        release_router(cfg.comm_args.extra["run_id"])
        release_broker(cfg.comm_args.extra["run_id"])
    torch.cuda.synchronize()
    return srv, finished, clients


def _wire_alone(params: dict, n: int = 5) -> dict:
    """One model frame's host costs with nothing else running: the median
    ms of `Message.encode` (leaf copies, join, CRC), `Message.decode`
    (CRC, parse, leaf copies) and the CRC alone, over `n` runs each."""
    from fedml_tpu_torch.comm import Message
    from fedml_tpu_torch.native import crc32c

    msg = Message("s2c_sync_model", 0, 1, {"model_params": params,
                                           "round_idx": 1, "run_gen": 0})

    def med(f):
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            f()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts)

    frame = msg.encode()
    return {"frame_bytes": len(frame), "encode_ms": med(msg.encode),
            "decode_ms": med(lambda: Message.decode(frame)),
            "crc_ms": med(lambda: crc32c(frame))}


def _cs_flagship(ds) -> dict:
    """(a): the flagship as 100 silos, a warm round and CS_ROUNDS timed."""
    import torch

    from fedml_tpu_torch.utils.events import recorder

    silos = [(ds.x_train[i][:int(ds.counts[i])],
              ds.y_train[i][:int(ds.counts[i])])
             for i in range(ds.num_clients)]
    cfg = _cs_cfg(DEV, "cs-flagship", 1 + CS_ROUNDS)
    recorder.spans.clear()
    dropped0 = recorder.dropped
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    srv, _, clients = _federation(cfg, silos)
    del clients
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    spans = list(recorder.spans)
    # the start-up handshake alone records ~4 x silos^2 status spans (every
    # CONNECTION_IS_READY before the first round re-checks every silo, as
    # in the JAX server); the counts below need the whole run in the ring
    check(recorder.dropped == dropped0,
          f"the span ring evicted {recorder.dropped - dropped0} of the "
          f"run's {len(spans)} spans")
    rounds = sorted((s for s in spans if s.name == "round"),
                    key=lambda s: s.meta["round"])
    check(len(rounds) == 1 + CS_ROUNDS,
          f"{len(rounds)} round spans for {1 + CS_ROUNDS} rounds")
    rows = []
    for rs in rounds:
        # the server's `round` span: its broadcast to its close, with the
        # aggregate's CUDA-event ms and the process's wire work in it
        r, lo, hi = rs.meta["round"], rs.start, rs.end

        def span_s(prefix):
            return sum(s.duration for s in spans if s.name.startswith(prefix)
                       and lo <= s.start < hi)

        train = [s.duration * 1e3 for s in spans
                 if s.name == "train" and s.meta.get("round") == r
                 and "client" in s.meta]
        rows.append(dict(
            round=r, ms=rs.duration * 1e3, **rs.meta["wire"],
            n_received=rs.meta["n_received"], agg_ms=rs.meta["agg_ms"],
            train_spans=len(train), train_sum_ms=sum(train),
            train_max_ms=max(train),
            server_model_sends_s=span_s("comm.send.s2c_"),
            client_model_sends_s=span_s("comm.send.c2s_send_model")))
    timed = rows[1:]
    res = {"silos": len(silos), "samples": int(ds.counts.sum()),
           "steps_per_round": int(sum(len(x) // min(32, len(x))
                                      for x, _ in silos)),
           "rounds": rows,
           "ms_per_round_median": statistics.median(r["ms"] for r in timed),
           "timed_mean": {k: statistics.mean(r[k] for r in timed) for k in (
               "ms", "serialize_s", "deserialize_s", "bytes_sent",
               "frames_sent", "agg_ms", "train_sum_ms", "train_max_ms",
               "server_model_sends_s", "client_model_sends_s")},
           "wall_s": wall_s, "spans": len(spans),
           "max_memory_allocated_bytes": peak}
    res["frame_bytes"] = res["timed_mean"]["bytes_sent"] / max(
        res["timed_mean"]["frames_sent"], 1)
    res["wire_alone"] = _wire_alone(srv.params)
    emit({"phase": "cross_silo", "flagship": res,
          "nvidia_smi": nvidia_smi_line()})
    check(all(r["n_received"] == len(silos) for r in srv.history),
          f"a round did not receive every silo's result: {srv.history}")
    check(all(r["train_spans"] == len(silos) for r in rows),
          "a round did not train every silo once: train spans a round "
          f"{[r['train_spans'] for r in rows]}")
    check(all(np.isfinite(v).all() for v in srv.params.values()),
          "the aggregate is not finite")
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _cs_sim_round(ds) -> dict:
    """The port Simulator's G = 1 round at the same shape, for comparison
    (after phase (a), which warmed the same convolution shapes)."""
    import torch

    from fedml_tpu_torch.simulation.simulator import Simulator

    sim = Simulator(_fedavg_cfg(DEV), ds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = sim.run_round(0)
    torch.cuda.synchronize()
    res = {"ms": (time.perf_counter() - t0) * 1e3,
           "train_loss": m["train_loss"]}
    del sim
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _cs_small():
    """The 4-silo f32 federation of (b)-(d): silos of CS_SHARDS N(0, 1)
    images at the flagship's shape with random labels, the initial
    parameters of one CPU draw, and one [1, CS_BATCH] batch order per
    (silo, round) from numpy's generator."""
    rs = np.random.RandomState(7)
    silos = [(rs.randn(n, 32, 32, 3).astype(np.float32),
              rs.randint(0, 10, n).astype(np.int64)) for n in CS_SHARDS]
    orders = [[rs.permutation(n)[:CS_BATCH] for _ in range(CS_SMALL_ROUNDS)]
              for n in CS_SHARDS]
    schedules = [(lambda r, i=i: orders[i][r][None])
                 for i in range(CS_SILOS)]
    init = {k: v.numpy() for k, v in _parity_params().items()}
    return silos, schedules, init


def _cs_run_small(device: str, tag: str, silos=None, comm_extra=None,
                  prepare=None, expect_error: bool = False, rounds=None,
                  train_extra=None, **common_extra):
    """The 4-silo f32 federation on `device` (`silos`: the indices of the
    silos that take part, all four by default; `comm_extra`: transport and
    codec; `train_extra`: train_args.extra, SecAgg's knobs): (server
    manager, initial params followed by the params after each round, the
    clients that finished, the client managers)."""
    every, schedules, init = _cs_small()
    keep = list(range(CS_SILOS)) if silos is None else list(silos)
    cfg = _cs_cfg(device, f"cs-{tag}", rounds or CS_SMALL_ROUNDS,
                  client_num_in_total=len(keep),
                  client_num_per_round=len(keep), compute_dtype="float32",
                  common_extra=common_extra, comm_extra=comm_extra or {},
                  extra=train_extra or {})
    rounds_seen = [init]
    with _tf32_off():
        srv, finished, clients = _federation(
            cfg, [every[i] for i in keep], init=init,
            schedules=[schedules[i] for i in keep], timeout=300,
            clients_must_finish="chaos" not in common_extra
            and prepare is None,
            eval_fn=lambda params, r: rounds_seen.append(params) or {},
            prepare=prepare, expect_error=expect_error)
    return srv, rounds_seen, finished, clients


def _cs_sim(device: str, starts=None) -> list:
    """The 4-silo federation again as CS_SMALL_ROUNDS rounds of the port
    Simulator's run_round with the same batch orders (FedAvg, server lr
    1, the shards padded to the largest and masked, weighted by their
    counts), chained from the same initial params, or with `starts`,
    round r started from starts[r]: the only difference is the
    aggregate's order of summation (the Simulator adds the weighted mean
    of the updates to the params; the server takes the weighted mean of
    the params). Returns the params after each round."""
    import torch

    from fedml_tpu_torch.data.fed_dataset import FedDataset
    from fedml_tpu_torch.simulation.simulator import Simulator

    silos, schedules, init = _cs_small()
    n_max = max(CS_SHARDS)

    def pad(a):
        return np.concatenate(
            [a, np.zeros((n_max - len(a),) + a.shape[1:], a.dtype)])

    ds = FedDataset(
        x_train=np.stack([pad(x) for x, _ in silos]),
        y_train=np.stack([pad(y) for _, y in silos]),
        mask_train=np.stack([(np.arange(n_max) < n).astype(np.float32)
                             for n in CS_SHARDS]),
        counts=np.array(CS_SHARDS), x_test=silos[0][0][:8],
        y_test=silos[0][1][:8], num_classes=10)
    cfg = _fedavg_cfg(device, client_num_in_total=CS_SILOS,
                      client_num_per_round=CS_SILOS, compute_dtype="float32",
                      comm_round=CS_SMALL_ROUNDS)
    out = []
    with _tf32_off():
        sim = Simulator(cfg, ds, device=device)
        for r in range(CS_SMALL_ROUNDS):
            if r == 0 or starts is not None:
                start = init if starts is None else starts[r]
                sim.server_state = sim.alg.server_init(
                    {k: torch.from_numpy(v).to(sim.device)
                     for k, v in start.items()}, cfg)
            sim.run_round(r, batch_idx=np.stack([s(r) for s in schedules]))
            out.append({k: v.cpu().numpy()
                        for k, v in sim.server_state.params.items()})
    return out


def _rel(a: dict, b: dict, init: dict) -> float:
    """max |a - b| over the largest |b - init|."""
    upd = max(float(np.abs(b[k].astype(np.float64) - init[k]).max())
              for k in init)
    return max(float(np.abs(a[k].astype(np.float64) - b[k]).max())
               for k in init) / upd


def _same(a: dict, b: dict) -> bool:
    return all(np.array_equal(a[k], b[k]) for k in a)


def _cs_bars() -> dict:
    """(b) parity, (c) repeat and durability, (d) chaos (module
    docstring). The readings, and under "card_params" the card's 4-silo
    params (phase cross_silo_secure's loopback reference)."""
    import tempfile

    from fedml_tpu_torch.cross_silo.soak import (
        server_kill_restart_soak, uninterrupted_final_params,
    )

    t0 = time.perf_counter()
    card, card_rounds, *_ = _cs_run_small(DEV, "card")
    init = card_rounds[0]
    cpu, *_ = _cs_run_small("cpu", "cpu")
    chained = _cs_sim(DEV)
    by_round = _cs_sim(DEV, card_rounds)
    again, *_ = _cs_run_small(DEV, "again")
    chaos, _, chaos_finished, _ = _cs_run_small(
        DEV, "chaos", chaos=CS_CHAOS, comm_retry=CS_RETRY)
    with tempfile.TemporaryDirectory() as d:
        soak = server_kill_restart_soak(d, device=DEV)
    ref, _ = uninterrupted_final_params(device=DEV)
    res = {
        "silos": CS_SILOS, "shards": CS_SHARDS, "rounds": CS_SMALL_ROUNDS,
        "card_vs_cpu_ratio": _rel(card.params, cpu.params, init),
        # each round against the Simulator's from the same params, over
        # that round's largest update (the bar); each round's params
        # against the Simulator's rounds chained from the same start, over
        # the largest update since the start; and the Simulator's rounds
        # from the federation's params against its chained ones: how far
        # round 0's differences in the order of summation grow in training
        "card_vs_simulator_by_round": [
            _rel(card_rounds[r + 1], by_round[r], card_rounds[r])
            for r in range(CS_SMALL_ROUNDS)],
        "card_vs_simulator_chained": [
            _rel(card_rounds[r + 1], chained[r], init)
            for r in range(CS_SMALL_ROUNDS)],
        "simulator_by_round_vs_chained": [
            _rel(by_round[r], chained[r], init)
            for r in range(CS_SMALL_ROUNDS)],
        "tol": {"cpu": PARITY_TOL, "simulator": CS_SIM_TOL},
        "repeat_bitwise": _same(card.params, again.params),
        "chaos_bitwise": _same(card.params, chaos.params),
        "chaos_n_received": [r["n_received"] for r in chaos.history],
        "chaos_clients_finished": chaos_finished,
        "soak_bitwise": _same(ref, soak["params"]),
        "soak_generation": soak["generation"],
        "soak_recovery_s": soak["recovery_s"],
        "seconds": time.perf_counter() - t0}
    emit({"phase": "cross_silo", "bars": res,
          "nvidia_smi": nvidia_smi_line()})
    check(res["card_vs_cpu_ratio"] <= PARITY_TOL,
          f"the card's 4-silo f32 run vs the CPU's: "
          f"{res['card_vs_cpu_ratio']} of the update > {PARITY_TOL}")
    check(max(res["card_vs_simulator_by_round"]) <= CS_SIM_TOL,
          f"the card's 4-silo rounds vs the Simulator's from the same "
          f"params: {res['card_vs_simulator_by_round']} of the round's "
          f"update > {CS_SIM_TOL}")
    check(res["repeat_bitwise"], "the 4-silo run does not repeat bitwise")
    check(res["chaos_bitwise"] and all(
        n == CS_SILOS for n in res["chaos_n_received"]),
          "the chaos run with retries is not bitwise the clean run")
    check(res["soak_bitwise"] and soak["error"] is None
          and soak["generation"] == 1,
          "the server kill-restart soak is not bitwise the uninterrupted run")
    return {**res, "card_params": card.params}


def phase_cross_silo(fedsim_g1=None) -> dict:
    """Phase 12 (module docstring). `fedsim_g1`, phase fedsim's G = 1
    result when that phase ran in this call, stands for the Simulator's
    round at the same shape (it timed the same round on the same card),
    instead of one more round here."""
    import torch

    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.ops import flash_attention as fa
    from fedml_tpu_torch.ops import paged_attention as pa

    fa.launch_count.update(dict.fromkeys(fa.launch_count, 0))
    pa.launch_count = 0
    t0 = time.perf_counter()
    ds = loader.load(_fedavg_cfg(DEV))
    res = {"flagship": _cs_flagship(ds)}
    launches = {**fa.launch_count, "paged": pa.launch_count}
    res["k1_k4_launches"] = launches
    res["simulator_g1_round"] = _cs_sim_round(ds) if fedsim_g1 is None \
        else {"ms": fedsim_g1["ms_per_round_median"],
              "from": "phase fedsim, G = 1, this call"}
    emit({"phase": "cross_silo", "simulator_g1_round":
          res["simulator_g1_round"], "cross_silo_vs_simulator":
          res["flagship"]["ms_per_round_median"]
          / res["simulator_g1_round"]["ms"],
          "nvidia_smi": nvidia_smi_line()})
    res["bars"] = _cs_bars()
    emit({"phase": "cross_silo", "k1_k4_launches": launches,
          "nvidia_smi": nvidia_smi_line(),
          "seconds": time.perf_counter() - t0})
    check(not any(launches.values()),
          f"the cross-silo path launched a flash or paged kernel: "
          f"{launches}")
    gc.collect()
    torch.cuda.empty_cache()
    return res



# ----------------------------------------------------------------- phase 13
def _round_rows(spans: list, round_spans: list, upload: str) -> list:
    """Per-round readings of a federation's spans: the server's `round`
    span (ms, wire work, results), the clients' spans that started in its
    window, and the wire codec's bytes on `upload` messages (raw and on
    the wire) and encode / decode ms."""
    rows = []
    for rs in round_spans:
        lo, hi = rs.start, rs.end

        def inside(name, mtype=None):
            return [x for x in spans if x.name == name and lo <= x.start < hi
                    and (mtype is None or x.meta.get("type") == mtype)]

        enc = inside("comm.codec.encode", upload)
        dec = inside("comm.codec.decode", upload)
        rows.append(dict(
            round=rs.meta["round"], ms=rs.duration * 1e3,
            n_received=rs.meta["n_received"], **rs.meta["wire"],
            codec_bytes_raw=sum(x.meta["bytes_raw"] for x in enc),
            codec_bytes_wire=sum(x.meta["bytes_wire"] for x in enc),
            codec_encodes=len(enc), codec_decodes=len(dec),
            encode_ms_p50=statistics.median(
                x.duration * 1e3 for x in enc) if enc else None,
            decode_ms_p50=statistics.median(
                x.duration * 1e3 for x in dec) if dec else None,
            **{k: v for k, v in rs.meta.items()
               if k not in ("round", "n_received", "wire")}))
    return rows


def _run_spans(run, *a, **kw):
    """`run(*a, **kw)` with the span ring emptied before and read after:
    (its result, the spans); fails by name if the ring evicted any."""
    from fedml_tpu_torch.utils.events import recorder

    recorder.spans.clear()
    dropped0 = recorder.dropped
    out = run(*a, **kw)
    spans = list(recorder.spans)
    check(recorder.dropped == dropped0,
          f"the span ring evicted {recorder.dropped - dropped0} of the "
          f"run's {len(spans)} spans")
    return out, spans


def _sa_expected(results: list, weight_norm: float):
    """What the unmask must give for the silos' trained `results`
    ((params, n, metrics) each): dequantize(sum quantize(vec_i n_i / N))
    / (sum n_i / N) as f32, the weights' sum, and max|vec_i n_i/N| x n
    against the field's budget p / 2^(q_bits + 1)."""
    from fedml_tpu_torch.cross_silo.secagg_manager import flatten_params
    from fedml_tpu_torch.mpc.finite import DEFAULT_PRIME, dequantize, quantize

    q, peak = 0, 0.0
    for p, n, _m in results:
        x = flatten_params(p) * (n / weight_norm)
        peak = max(peak, float(np.abs(x).max()))
        q = (q + quantize(x)) % DEFAULT_PRIME
    wsum = sum(n for _p, n, _m in results) / weight_norm
    want = (dequantize(q) / max(wsum, 1e-9)).astype(np.float32)
    return want, wsum, {"max_abs_x_times_n": peak * len(results),
                        "budget": DEFAULT_PRIME / 2.0 / (1 << 16)}


def _float_mean(results: list) -> dict:
    """Plain FedAvg of the same results: the port's aggregator on the
    card."""
    from fedml_tpu_torch.cross_silo import FedAggregator

    agg = FedAggregator(DEV)
    agg.reset(range(len(results)))
    for i, (p, n, _m) in enumerate(results):
        agg.add_local_trained_result(i, p, float(n))
    return agg.aggregate()


def _max_dev(a: dict, b: dict) -> float:
    return max(float(np.abs(np.asarray(a[k], np.float64) - b[k]).max())
               for k in b)


def _sa_flagship(ds, rounds: int) -> dict:
    """(a): SecAgg at the flagship width over SA_SILOS silos, `rounds`
    rounds (the last one timed)."""
    import torch

    from fedml_tpu_torch.cross_silo.secagg_manager import flatten_params

    silos = [(ds.x_train[i][:int(ds.counts[i])],
              ds.y_train[i][:int(ds.counts[i])]) for i in range(SA_SILOS)]
    cfg = _cs_cfg(DEV, "sa-flagship", rounds, client_num_in_total=SA_SILOS,
                  client_num_per_round=SA_SILOS, extra={"secagg": True},
                  comm_extra={"comm_codec": SA_CODEC})
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (srv, _, clients), spans = _run_spans(_federation, cfg, silos)
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    round_spans = sorted((x for x in spans if x.name == "round"),
                         key=lambda x: x.meta["round"])
    check(len(round_spans) == rounds,
          f"{len(round_spans)} round spans for {rounds} rounds")
    rows = _round_rows(spans, round_spans, "c2s_sa_masked")
    for row in rows:
        mask = [x.duration * 1e3 for x in spans if x.name == "sa_mask"
                and x.meta["round"] == row["round"]]
        train = [x.duration * 1e3 for x in spans if x.name == "sa_train"
                 and x.meta["round"] == row["round"]]
        row.update(mask_ms_mean=statistics.mean(mask), mask_ms_max=max(mask),
                   masks=len(mask), train_ms_max=max(train))
    # the bars, on the trainers' cached last round
    memo = [c.trainer._memo for c in clients]
    check(all(m[0] == rounds - 1 for m in memo),
          "a silo's cached round is not the last one")
    results = [m[2] for m in memo]
    want, wsum, budget = _sa_expected(results, srv.weight_norm)
    got = flatten_params(srv.params)
    step = SA_SILOS * 2.0 ** -16 / wsum
    res = {"silos": SA_SILOS, "samples": int(sum(len(x) for x, _ in silos)),
           "params": int(got.size), "rounds": rows,
           "timed": rows[-1], "wall_s": wall_s,
           "max_memory_allocated_bytes": peak,
           "aggregate_bitwise_quantized_sum": bool(np.array_equal(
               got, want.astype(np.float64))),
           "vs_float_mean": _max_dev(srv.params, _float_mean(results)),
           "quantization_step_x_n": step, "field": budget,
           "losses": [m[2][2]["train_loss"] for m in memo]}
    emit({"phase": "cross_silo_secure", "a_secagg_flagship": res,
          "nvidia_smi": nvidia_smi_line()})
    check(all(r["n_received"] == SA_SILOS for r in srv.history),
          f"a SecAgg round missed a silo: {srv.history}")
    check(all(r["masks"] == SA_SILOS for r in rows),
          "a round did not mask every silo's upload once")
    check(res["aggregate_bitwise_quantized_sum"],
          "the unmasked aggregate is not bitwise the plain quantized sum")
    check(res["vs_float_mean"] <= step,
          f"the SecAgg aggregate is {res['vs_float_mean']} from the float "
          f"weighted mean, over one quantization step ({step})")
    check(budget["max_abs_x_times_n"] < budget["budget"],
          f"the field budget is exceeded: {budget}")
    check(all(np.isfinite(res["losses"])), "a silo's loss is not finite")
    del srv, clients, memo, results
    gc.collect()
    torch.cuda.empty_cache()
    return res


class _DeadSilo:
    """A silo's trainer that fails from round `after` on: its manager's
    handler raises (counted, the receive loop survives) and the silo
    never uploads that round."""

    def __init__(self, inner, after: int):
        self.inner, self.after = inner, after
        self.n_samples = inner.n_samples

    def train(self, params, r):
        if r >= self.after:
            raise RuntimeError(f"silo stopped before round {r}")
        return self.inner.train(params, r)


def _kill_silo(i: int, after: int = 0, mute_unmask=()):
    """A `prepare` hook: silo i's trainer stops at round `after`; the
    silos in `mute_unmask` never answer an unmask request."""
    from fedml_tpu_torch.cross_silo import message_define as md

    def prepare(clients):
        clients[i].trainer = _DeadSilo(clients[i].trainer, after)
        for j in mute_unmask:
            clients[j].comm.register_message_receive_handler(
                md.S2C_SA_UNMASK_REQ, lambda _m: None)

    return prepare


def _sa_kill_resume(ref_params: dict) -> dict:
    """The 4-silo SecAgg federation with the server severed after round 0
    and resumed from its round-boundary checkpoint, against
    `ref_params` (the same federation uninterrupted)."""
    import tempfile

    from fedml_tpu_torch.comm import release_router
    from fedml_tpu_torch.cross_silo.soak import secagg_server_kill_restart
    from fedml_tpu_torch.models import hub
    from fedml_tpu_torch.runner import FedMLRunner

    every, schedules, init = _cs_small()
    tmp = tempfile.TemporaryDirectory()
    d = tmp.name
    cfg = _cs_cfg(DEV, "sa-kill", CS_SMALL_ROUNDS,
                  client_num_in_total=CS_SILOS,
                  client_num_per_round=CS_SILOS, compute_dtype="float32",
                  extra={"secagg": True, "checkpoint_dir": d},
                  comm_extra={"comm_codec": SA_CODEC})
    model = hub.create("resnet18_gn", 10, (32, 32, 3), device="meta")
    clients = [FedMLRunner(cfg, dataset=every[i], model=model, role="client",
                           rank=i + 1, batch_schedule=schedules[i]).runner
               for i in range(CS_SILOS)]

    def make_server(resume):
        cfg.train_args.extra["resume"] = resume
        return FedMLRunner(cfg, model=model, role="server",
                           params=init).runner

    t0 = time.perf_counter()
    try:
        with _tf32_off():
            srv = secagg_server_kill_restart(make_server, clients, 1)
    finally:
        for c in clients:
            c.comm.stop()
        release_router("sa-kill")
        tmp.cleanup()
    return {"resumed": srv._resumed, "error": srv.error,
            "rounds": [h["round"] for h in srv.history],
            "bitwise": _same(srv.params, ref_params),
            "seconds": time.perf_counter() - t0}


def _sa_bars() -> dict:
    """(b): dropout recovery, a loud quorum failure and a server kill and
    resume on the 4-silo f32 federation of phase cross_silo's bars."""
    sa = dict(comm_extra={"comm_codec": SA_CODEC})
    t0 = time.perf_counter()
    # silo 4 stops after setup: the timeout drops it, its sk is rebuilt
    drop, drop_rounds, *_ = _cs_run_small(
        DEV, "sa-drop", rounds=1, prepare=_kill_silo(3),
        train_extra={"secagg": True, "round_timeout": SA_TIMEOUT}, **sa)
    plain, *_ = _cs_run_small(DEV, "sa-drop-plain", silos=[0, 1, 2],
                              rounds=1)
    n_surv = sum(CS_SHARDS[:3])
    wsum = n_surv / drop.weight_norm
    step = 3 * 2.0 ** -16 / wsum
    # silo 4 stops and silo 3 never answers the unmask request: the
    # b-shares stay below t+1 = 3
    fail, *_ = _cs_run_small(
        DEV, "sa-fail", rounds=1, expect_error=True,
        prepare=_kill_silo(3, mute_unmask=(2,)),
        train_extra={"secagg": True, "round_timeout": SA_FAIL_TIMEOUT}, **sa)
    ref, *_ = _cs_run_small(DEV, "sa-ref", train_extra={"secagg": True},
                            **sa)
    res = {"dropped_log": drop.dropped_log,
           "sk_rebuilt": sorted(drop.dropped_sk),
           "n_received": [h["n_received"] for h in drop.history],
           "vs_plain_fedavg_over_survivors": _max_dev(drop.params,
                                                      plain.params),
           "quantization_step_x_n": step,
           "quorum_failure": fail.error,
           "kill_resume": _sa_kill_resume(ref.params),
           "seconds": time.perf_counter() - t0}
    emit({"phase": "cross_silo_secure", "b_secagg_bars": res,
          "nvidia_smi": nvidia_smi_line()})
    check(drop.dropped_log == [(0, [CS_SILOS])]
          and res["sk_rebuilt"] == [CS_SILOS] and res["n_received"] == [3],
          f"the dropout was not recovered: {res}")
    check(res["vs_plain_fedavg_over_survivors"] <= step,
          f"the recovered round is {res['vs_plain_fedavg_over_survivors']} "
          f"from plain FedAvg over the survivors, over {step}")
    check(fail.error is not None and "unmask" in fail.error,
          f"an unmask below quorum did not fail loudly: {fail.error!r}")
    kr = res["kill_resume"]
    check(kr["resumed"] and kr["error"] is None and kr["bitwise"]
          and kr["rounds"] == list(range(CS_SMALL_ROUNDS)),
          f"the SecAgg kill and resume is not bitwise: {kr}")
    return res


def _leaf_wire_bytes(params: dict, ratio: float, val_bytes: int) -> int:
    """The sparse codec's payload bytes for one upload of `params`: each
    float leaf's k = max(1, int(n * ratio)) kept values, with uint16
    indices up to 65536 entries and int32 past that (the JAX package's
    `encode_sparse`)."""
    total = 0
    for a in params.values():
        n = int(np.size(a))
        k = min(n, max(1, int(n * ratio)))
        total += k * ((2 if n <= 65536 else 4) + val_bytes)
    return total


def _codec_flagship(ds, rounds: int, dense_round=None) -> dict:
    """(c): the flagship as 100 silos with CODEC on the uploads, `rounds`
    rounds (the last one timed)."""
    import torch

    from fedml_tpu_torch.utils import metrics as mx

    silos = [(ds.x_train[i][:int(ds.counts[i])],
              ds.y_train[i][:int(ds.counts[i])])
             for i in range(ds.num_clients)]
    cfg = _cs_cfg(DEV, "codec-flagship", rounds,
                  comm_extra={"comm_codec": CODEC})
    errs0 = mx.snapshot()["counters"].get("comm.loopback.decode_errors", 0)
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (srv, _, clients), spans = _run_spans(_federation, cfg, silos)
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    errs = mx.snapshot()["counters"].get("comm.loopback.decode_errors",
                                         0) - errs0
    round_spans = sorted((x for x in spans if x.name == "round"),
                         key=lambda x: x.meta["round"])
    check(len(round_spans) == rounds,
          f"{len(round_spans)} round spans for {rounds} rounds")
    rows = _round_rows(spans, round_spans, "c2s_send_model")
    for r in rows:
        r["reduction_x"] = r["codec_bytes_raw"] / max(r["codec_bytes_wire"], 1)
    per_upload = _leaf_wire_bytes(srv.params, CODEC["ratio"], 2)
    raw_upload = sum(int(np.size(a)) * 4 for a in srv.params.values())
    losses = [c.trainer._memo[2][2]["train_loss"] for c in clients]
    res = {"silos": len(silos), "rounds": rows, "timed": rows[-1],
           "wall_s": wall_s, "decode_errors": errs,
           "expected_bytes_wire_per_upload": per_upload,
           "expected_reduction_x": raw_upload / per_upload,
           "digits_bench_bar_x": 8.0,
           "max_memory_allocated_bytes": peak,
           "loss_min": min(losses), "loss_max": max(losses),
           "dense_round_ms": dense_round}
    emit({"phase": "cross_silo_secure", "c_codec_flagship": res,
          "nvidia_smi": nvidia_smi_line()})
    n = len(silos)
    check(all(h["n_received"] == n for h in srv.history),
          f"a codec round did not receive every silo: {srv.history}")
    check(all(np.isfinite(losses)), "a silo's loss is not finite")
    check(errs == 0, f"{errs} frames were dropped for a decode error")
    check(all(r["codec_encodes"] == r["codec_decodes"] == n
              and r["codec_bytes_raw"] == n * raw_upload
              and r["codec_bytes_wire"] == n * per_upload for r in rows),
          f"the uploads' bytes are not the codec's arithmetic: {rows}")
    check(rows[-1]["reduction_x"] >= 5.5,
          f"the payload reduction {rows[-1]['reduction_x']} is under 5.5x")
    del srv, clients
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _cd_run(tag: str, uplink_topk=None, flaky=None, timeout=None) -> object:
    """The 4-silo f32 federation as cross-device: a CrossDeviceServer and
    four EdgeClients through `FedMLRunner` (all four sampled a round);
    `flaky`, a device index whose trainer stops from round 1."""
    from fedml_tpu_torch.comm import release_router
    from fedml_tpu_torch.models import hub
    from fedml_tpu_torch.runner import FedMLRunner

    every, schedules, init = _cs_small()
    cfg = _cs_cfg(DEV, f"cd-{tag}", CS_SMALL_ROUNDS,
                  client_num_in_total=CS_SILOS,
                  client_num_per_round=CS_SILOS, compute_dtype="float32",
                  extra={"min_devices": CS_SILOS,
                         "round_timeout": timeout or 120.0,
                         **({} if uplink_topk is None else
                            {"uplink_topk": uplink_topk})})
    cfg.common_args.training_type = "cross_device"
    model = hub.create("resnet18_gn", 10, (32, 32, 3), device="meta")
    srv = FedMLRunner(cfg, model=model, role="server", params=init).runner
    clients = [FedMLRunner(cfg, dataset=every[i], model=model, role="client",
                           rank=i + 1, batch_schedule=schedules[i]).runner
               for i in range(CS_SILOS)]
    if flaky is not None:
        clients[flaky].trainer = _DeadSilo(clients[flaky].trainer, 1)
    try:
        with _tf32_off():
            srv.run(background=True)
            for c in clients:
                c.run(background=True)
            for c in clients:
                c.register()
            check(srv.done.wait(300), f"cross-device {tag} did not finish")
    finally:
        for c in clients:
            c.comm.stop()
        release_router(f"cd-{tag}")
    check(srv.error is None, f"cross-device {tag} failed: {srv.error}")
    return srv


def _transports_and_edges(ref_params=None) -> dict:
    """(d): the 4-silo f32 federation over broker and web3 against its
    loopback run (`ref_params`, or run here); `run_cross_cloud` with a
    late join; cross-device dense, with `uplink_topk` and with a flaky
    device."""
    from fedml_tpu_torch.cross_cloud import run_cross_cloud
    from fedml_tpu_torch.models import hub

    t0 = time.perf_counter()
    ref = ref_params if ref_params is not None else \
        _cs_run_small(DEV, "tr-loopback")[0].params
    broker, *_ = _cs_run_small(DEV, "tr-broker",
                               comm_extra={"transport": "broker"})
    web3, *_ = _cs_run_small(DEV, "tr-web3", comm_extra={"transport": "web3"})
    every, schedules, init = _cs_small()
    t = _cs_cfg(DEV, "cc-args", CS_SMALL_ROUNDS, client_num_in_total=4,
                client_num_per_round=4,
                compute_dtype="float32").train_args
    with _tf32_off():
        cc = run_cross_cloud(
            hub.create("resnet18_gn", 10, (32, 32, 3), device="meta"), init,
            t, every, CS_SMALL_ROUNDS, round_timeout=120.0,
            late_join_delay=0.5, run_id="cc-late", device=DEV,
            batch_schedules=schedules)
    dense = _cd_run("dense")
    sparse = _cd_run("topk", uplink_topk=CODEC["ratio"])
    flaky = _cd_run("flaky", flaky=CS_SILOS - 1, timeout=CD_TIMEOUT)
    res = {"loopback_from_phase_cross_silo": ref_params is not None,
           "broker_bitwise_loopback": _same(broker.params, ref),
           "web3_bitwise_loopback": _same(web3.params, ref),
           "cross_cloud_n_received": [h["n_received"] for h in cc.history],
           "cross_cloud_bitwise_loopback": _same(cc.params, ref),
           "cross_device_dense_bitwise_loopback": _same(dense.params, ref),
           "cross_device_topk_n_received": [h["n_received"]
                                            for h in sparse.history],
           "cross_device_topk_vs_dense": _max_dev(sparse.params,
                                                  dense.params),
           "cross_device_flaky": {"dropped_log": flaky.dropped_log,
                                  "history": flaky.history},
           "seconds": time.perf_counter() - t0}
    emit({"phase": "cross_silo_secure", "d_transports_and_edges": res,
          "nvidia_smi": nvidia_smi_line()})
    check(res["broker_bitwise_loopback"] and res["web3_bitwise_loopback"],
          "a broker federation is not bitwise the loopback one")
    check(res["cross_cloud_n_received"] == [CS_SILOS] * CS_SMALL_ROUNDS
          and res["cross_cloud_bitwise_loopback"],
          f"the late-join cross-cloud run is not the loopback one: {res}")
    check(res["cross_device_dense_bitwise_loopback"],
          "cross-device dense is not bitwise the loopback federation")
    check(res["cross_device_topk_n_received"]
          == [CS_SILOS] * CS_SMALL_ROUNDS and all(
              np.isfinite(v).all() for v in sparse.params.values()),
          "cross-device with uplink_topk did not complete")
    check(flaky.dropped_log == [(1, [CS_SILOS])]
          and flaky.history[-1]["n_online"] == CS_SILOS - 1
          and flaky.history[-1]["n_received"] == CS_SILOS - 1,
          f"the flaky device was not dropped: {res['cross_device_flaky']}")
    return res


def phase_cross_silo_secure(cs_flagship=None, loopback_params=None) -> dict:
    """Phase 13 (module docstring). `cs_flagship`, phase cross_silo's
    flagship result when that phase ran in this call, gives the dense
    round's ms beside the codec's; that phase has then warmed the
    flagship's shapes in this process, so (a) and (c) time one round
    with no warm round before it. `loopback_params`, its 4-silo card
    federation's params, stand for (d)'s loopback run (the same
    program)."""
    import torch

    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.ops import flash_attention as fa
    from fedml_tpu_torch.ops import paged_attention as pa

    fa.launch_count.update(dict.fromkeys(fa.launch_count, 0))
    pa.launch_count = 0
    t0 = time.perf_counter()
    ds = loader.load(_fedavg_cfg(DEV))
    rounds = 2 if cs_flagship is None else 1
    res = {}
    for part, fn in (
            ("a_secagg_flagship", lambda: _sa_flagship(ds, rounds)),
            ("b_secagg_bars", _sa_bars),
            ("c_codec_flagship", lambda: _codec_flagship(
                ds, rounds, None if cs_flagship is None
                else cs_flagship["ms_per_round_median"])),
            ("d_transports_and_edges",
             lambda: _transports_and_edges(loopback_params))):
        t1 = time.perf_counter()
        res[part] = fn()
        emit({"phase": "cross_silo_secure", "part": part,
              "seconds": time.perf_counter() - t1})
    launches = {**fa.launch_count, "paged": pa.launch_count}
    res["k1_k4_launches"] = launches
    emit({"phase": "cross_silo_secure", "k1_k4_launches": launches,
          "nvidia_smi": nvidia_smi_line(),
          "seconds": time.perf_counter() - t0})
    check(not any(launches.values()),
          f"the secure cross-silo path launched a flash or paged kernel: "
          f"{launches}")
    gc.collect()
    torch.cuda.empty_cache()
    return res


def kernel_rows(kern: dict, runs: dict, flash: dict, train: dict,
                surface: dict, every_phase: bool) -> list:
    """The `kernels` line's rows from the phases' results; with
    `every_phase`, also checks that each kernel was launched where it
    should have been."""
    kernels = []
    for kind, k in kern.items():
        if kind == "bf16" and "serve_c5" in k:
            # K4 at the speculative verify window's C = 5, at the serve
            # shape; `launches` from phase serve_surface's main path
            c5 = k["serve_c5"]
            kernels.append({
                "name": "paged_attention_bf16_c5", "route": "cuda",
                "design": "split-page",
                "source": "fedml_tpu_torch/csrc/paged_attention.cu",
                "replaces": "fedml_tpu/ops/paged_attention.py:84",
                "launches": surface.get("launches_c5", 0),
                "max_abs_err": c5["max_abs_err"],
                "max_row_rel_err": c5["max_row_rel_err"], "ms": c5["ms"],
                "plain_ms": c5["plain_ms"], "bound_ms": c5["bound_ms"],
                "bound_by": c5["bound_by"],
                "library_ms": c5["library_ms"]})
        run = runs.get(kind, {"launches": 0, "decode_steps": 0})
        kernels.append({
            "name": f"paged_attention_{kind}", "route": "cuda",
            "design": "split-page",
            "source": "fedml_tpu_torch/csrc/paged_attention.cu",
            "replaces": "fedml_tpu/ops/paged_attention.py:84",
            "launches": run["launches"],
            "launches_per_decode_step":
                run["launches"] / max(run["decode_steps"], 1),
            "max_abs_err": k["max_abs_err"],
            "max_row_rel_err": k["max_row_rel_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"], "serve_shape": k["serve_shape"]})
    # the flash kernels at the main path's dtype (bf16: the tensor-core
    # kernels) and at f32 (the three-pass TF32 kernels). `launches` is each
    # kernel's count from phase train's main path; `parity_launches` its
    # count from the f32 flash-vs-dense round after it, the only path that
    # reaches the f32 kernels (`fa.fwd_route` / `dq_route` / `dkv_route`
    # send the main path's bf16 D 128 heads to the bf16 kernels). Each row
    # also carries phase flash's D 40 case for its kernel under `d40` (BH 4,
    # T 256; BH 64, T 2048 under `d40.at_flagship`), `check_launches` the
    # launches that case made. K2's and K3's library yardstick is SDPA's
    # backward, which computes dQ, dK and dV in one call
    outputs = {"fwd": ("o", "lse"), "dq": ("dq",), "dkv": ("dk", "dv")}
    parity = train.get("f32_flash_vs_dense", {}).get("launches", {})
    tc, tf32 = "wgmma+cp.async", "wgmma tf32x3 + cp.async"
    # (name, dtype, pass, counter, line of the TPU kernel, design)
    rows = (("flash_fwd_tc", "bf16", "fwd", "fwd_tc", 58, tc),
            ("flash_fwd_3xtf32", "f32", "fwd", "fwd_3xtf32", 58, tf32),
            ("flash_dq_tc", "bf16", "dq", "dq_tc", 204, tc),
            ("flash_dq_3xtf32", "f32", "dq", "dq_3xtf32", 204,
             "wgmma tf32x3 (S, dS.K) + f64 mma.sync dP + cp.async"),
            ("flash_dkv_tc", "bf16", "dkv", "dkv_tc", 232, tc),
            ("flash_dkv_3xtf32", "f32", "dkv", "dkv_3xtf32", 232, tf32))
    off_main_path = {r[0] for r in rows if r[1] == "f32"}

    def timed(f, fk, lib_key) -> dict:
        return {"shape": f["shape"], "ms": f["ms"][fk],
                "plain_ms": f["plain_ms"][fk],
                "library_ms": f["library_ms"][lib_key],
                "bound_ms": f["bounds"][fk]["bound_ms"],
                "bound_by": f["bounds"][fk]["bound_by"],
                "max_row_rel_err": max(f["errors"][e]["max_row_rel_err"]
                                       for e in outputs[fk])}

    d40 = flash.get("d40")
    for kname, dt, fk, counter, line, design in rows if d40 else ():
        f = flash[dt]
        lib_key, lib_call = (("fwd", "SDPA forward") if fk == "fwd" else
                             ("bwd", "SDPA backward: dQ+dK+dV together"))
        errs = [f["errors"][e] for e in outputs[fk]]
        g = d40[dt]
        kernels.append({
            "name": kname, "route": "cuda", "design": design, "dtype": dt,
            "source": "fedml_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"fedml_tpu/ops/flash_attention.py:{line}",
            "launches": train["launches"].get(counter, 0),
            "parity_launches": parity.get(counter, 0),
            "max_abs_err": max(e["max_abs_err"] for e in errs),
            "max_row_rel_err": max(e["max_row_rel_err"] for e in errs),
            "ms": f["ms"][fk], "plain_ms": f["plain_ms"][fk],
            "bound_ms": f["bounds"][fk]["bound_ms"],
            "bound_by": f["bounds"][fk]["bound_by"],
            "library_ms": f["library_ms"][lib_key], "library_call": lib_call,
            "d40": {**timed(g, fk, lib_key),
                    "check_launches": d40["launches"][counter],
                    "at_flagship": timed(g["at_flagship"], fk, lib_key)}})
    # no kernel can beat the least time the card needs for its work
    flash_rows = [k for k in kernels if "d40" in k]
    every_time = kernels + [k["d40"] for k in flash_rows] + [
        k["d40"]["at_flagship"] for k in flash_rows]
    check(all(k["ms"] >= k["bound_ms"] for k in every_time),
          "a kernel's time is below its bound: the bound is wrong")
    if every_phase:
        # the f32 flash kernels are off the main path (phase train checked
        # their counts are 0 there); the f32 round must have run them, and
        # phase flash's D 40 case every flash kernel
        check(all(k["launches"] > 0 for k in kernels
                  if k["name"] not in off_main_path),
              "a kernel of the main path was never launched")
        check(all(k["parity_launches"] > 0 for k in kernels
                  if k["name"] in off_main_path),
              "an f32 flash kernel was never launched by the f32 round")
        check(all(k["d40"]["check_launches"] > 0 for k in flash_rows),
              "a flash kernel was never launched by the D 40 case")
    return kernels


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
    build_s = time.perf_counter() - t0
    sass = sass_counts(str(_build.lib_path("flash_attention")))
    emit({"phase": "build", "seconds": build_s,
          "ptxas": {k: ptxas_summary(v) for k, v in reports.items()},
          "flash_attention_sass": sass})
    check(sass["HMMA"] + sass["HGMMA"] > 0,
          "the flash library holds no tensor-core instruction")

    def run(name, fn, *a, default=None):
        """Phase `name` when selected, its wall seconds on a line of its
        own; `default` otherwise."""
        if name not in args.only:
            return default
        t1 = time.perf_counter()
        out = fn(*a)
        emit({"phase": name, "wall_s": time.perf_counter() - t1})
        return out

    kern = run("kernel", phase_kernel, bw, default={})
    reqs = _requests(32000)
    runs = {}   # pool kind -> the main-path wave that used it
    if "engine" in args.only:
        runs["f32"] = run("engine", phase_engine, reqs)
    runs.update(run("serve", phase_serve, reqs, default={}))
    surface = run("serve_surface", phase_serve_surface, reqs, runs,
                  default={})
    run("profile", phase_profile, reqs)
    flash = run("flash", phase_flash, bw, default={})
    train = run("train", phase_train, default={"launches": {}})
    run("train_profile", phase_train_profile)
    run("fedavg", phase_fedavg)
    run("fedavg_profile", phase_fedavg_profile)
    fedsim = run("fedsim", phase_fedsim, "fedavg" in args.only, default={})
    run("plugins", phase_plugins)
    cross_silo = run("cross_silo", phase_cross_silo,
                     fedsim.get("flagship", {}).get(1), default={})
    run("cross_silo_secure", phase_cross_silo_secure,
        cross_silo.get("flagship"),
        cross_silo.get("bars", {}).get("card_params"))

    kernels = kernel_rows(kern, runs, flash, train, surface,
                          every_phase=set(PHASES) <= set(args.only))
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
