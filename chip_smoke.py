#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`fedml_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --only kernel   # a subset of phases

Phases, each printing one JSON line (a failing phase raises and the script
exits non-zero; nothing is caught and carried past). They run in two lanes
on the one card: after device, build, kernel and flash (the kernels timed
alone), the phases in LANE_B (mesh, fedavg, fedsim, plugins, cross_silo,
standalone, examples, in that order) run in a child process of this
script, while
this process runs engine, serve, serve_surface, train, tasks, runtimes,
entry, qlora, tp and fleet; when both are done, cross_silo_secure runs
alone here (it takes phase cross_silo's results from the child). The
phases in HEAVY, whose memory peaks would not fit beside each other, take
turns across the lanes. Each phase's line of wall seconds names its lane,
the seconds it waited for its turn, the memory it left allocated and when
it ended (seconds from the script's start). A failed lane fails the
script, and every process the script started is stopped when it ends.

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
             Then at the head split a tensor-parallel rank launches (the
             serve shape at H = 16 heads, its own contiguous pool): f32,
             bf16 and int8 (bf16 q) at C=1, bf16 at C=5 and the int8 pool
             under f32 q at C=1 (phase tp's f32 gate), each checked and
             timed as above.
4. engine  - LLaMA-2-7B width in f32 (seeded random weights, TF32 off): the
             kernel engine and the gather engine, on the same weights, serve
             10 greedy requests (prompts 40-600 tokens, two sharing a
             256-token prefix, more requests than slots); token identity
             under the near-tie rule, full budgets, a prefix hit, the free
             list back to budget, and kernel launches == layers x steps.
5. serve   - the same requests in bf16 through the kernel engine with a bf16
             pool and with an int8 pool: decode tokens/s, TTFT p50, the int8
             engine's greedy match rate against bf16 (printed, not gated:
             the weights are random), kernel launches; each engine's
             kv_pool ledger bytes within 1% of its slots x
             `serving.kv_bytes_per_slot`, and the ledger's `engine_step`
             entry (with K4's work).
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
             batch schedule: the adapters agree. The cost ledger: the 7B
             round's `round_fn` FLOPs (captured in round 0), their K1-K3
             share equal to ops/cost.py's count of 2 forwards, dQ and
             dK/dV a layer and step, and the MFU over the steady round;
             the f32 flash and dense rounds' ledger FLOPs equal.
9. fedavg  - the FedAvg simulation path at bench.py's flagship shape
             (`_flagship_config`: 100 clients of synthetic CIFAR-10, 96
             samples each, Dirichlet alpha 0.5, all 100 per round, batch
             32, 1 epoch, lr 0.05, resnet18_gn, bf16 compute, health stats
             on): through `fedml_tpu_torch.init` and the Simulator, a warm
             round and a timed one (rounds/s, ms per round and per local
             step, peak memory, losses, conv + matmul FLOPs and their
             share of the bf16 peak), the loss falling, then one eval;
             then one f32 round of FEDAVG_CPU_CLIENTS clients on the card
             and on the CPU from the same parameters and batch schedule
             (TF32 off; the CPU's rounds in a child process started with
             the second lane), within 1e-3 of the CPU round's largest
             update or, where f32 itself departs further from the f64
             round, as close to the f64 round as the CPU's f32 round
             (`_fedavg_parity`). No K1-K4 launch. The cost ledger's
             `round_fn` entry (captured in the warm round): its FLOPs
             within 1% of `analytic_flops` of one local step x the
             round's steps, no K1-K4 work, its calls and capture
             seconds, and the MFU those FLOPs give over the timed round
             against the bf16 peak (989 TFLOP/s).
10. fedsim - the rest of the round engine (vmapped client groups,
             SCAFFOLD / FedDyn / Mime, round blocks, cohort chunks,
             checkpoint and resume), vmap's per-example fallback an
             error: the f32 4-client round through the Simulator twice in
             this process and once in a child process, bitwise the same
             (sha256 of parameters and metrics; G = 4 twice too); one
             local step of that round on the card within 1e-3 of the
             CPU's largest update, and at G = 4 within 1e-3 of G = 1;
             the flagship at G = 1 (one timed round after a warm one;
             phase fedavg's timed round when it ran in this process)
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
             0.05: PLUGIN_ROUNDS timed rounds each (after a warm one for
             the plain round only), ms a round, the plugin's own ms (its hooks between CUDA events),
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
             shape as one server and CS_FLAGSHIP_SILOS client runners over
             loopback in this process (the first CS_FLAGSHIP_SILOS of the
             100 non-IID synthetic CIFAR-10 shards, all of them a round,
             ResNet-18-GN, batch 32, 1 epoch, lr 0.05, bf16), a warm round
             and CS_ROUNDS timed: ms a round (the median), the clients'
             `train` spans (sum and largest), the wire's serialise /
             deserialise seconds, bytes and frames a round, the
             aggregate's ms (CUDA events), peak memory, every round
             receiving every silo's result, and in every round each
             silo's handle span of the server's broadcast stitched to
             its send span (trace headers: one chain a silo); then the
             port Simulator's
             G = 1 round of the 100 clients, compared per client.
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
             a timed one (one round when phase cross_silo ran in this
             call; phase entry has then run the flagship's rounds in this
             process): ms a round, a client's mask ms,
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
             uninterrupted run. (c) The flagship's first CODEC_SILOS
             silos with bench.py's codec (sparse_topk 0.12, val_bits 16,
             error feedback), a warm round and a timed one (as (a)):
             bytes raw and on the wire, the reduction (the codec's
             arithmetic exactly, 5.59x here), encode / decode ms p50, the
             round's ms a silo beside phase cross_silo's dense round's,
             every silo's result and no frame
             dropped. (d) The 4-silo federation over broker and web3,
             `run_cross_cloud` with a late join and cross-device dense,
             each bitwise the loopback run; cross-device with
             uplink_topk; a flaky device dropped from the registry. No
             K1-K4 launch.

14. standalone - the tools around a round, at the flagship (synthetic
             CIFAR-10, ResNet-18-GN, batch 32): (a) the centralized
             baseline through `FedMLRunner(training_type: centralized)`
             with `metrics_port: 0` over the 9600 pooled rows (300 steps
             an epoch), a warm epoch (with its eval) and a timed one: ms
             an epoch and a step, launches a step, peak memory, one
             /metrics scrape holding the `fed_epoch` gauge, the ratio to
             phase fedsim's G = 1 round when it ran (700 steps: its
             shards are padded to 224 rows); then 2 f32 epochs of one
             batch (ST_BAR_ROWS rows, momentum 0.9, so the second step
             reads the carried optimizer state) on the card and the CPU
             from one parameter draw (TF32 off), within 1e-3 of the CPU's
             largest update. (b) Contribution: ST_CONTRIB_M clients trained one
             local epoch (bf16) from one global model, each subset's
             utility the negative mean cross-entropy on ST_TEST_ROWS test
             images in f32 (TF32 off); leave-one-out and GTG-Shapley over
             the 10, MR-Shapley over the first ST_MR_M (255 subsets),
             ST_CHUNK subsets a vmapped call: subsets evaluated, subsets a
             second, peak memory; ST_SINGLE_CHECKS sampled subsets one at
             a time within ST_SUBSET_TOL of the batched values. (c)
             Gradient inversion of one test image through ResNet-18-GN in
             f32 (TF32 off): `dlg_attack` and `invert_gradient_attack`,
             ST_INVERT_STEPS steps each (a second derivative through
             cuDNN convolutions and GroupNorm): ms a step, the match loss
             at the first and last step (it must fall), the iDLG label
             recovered; DLG on the card against the CPU from one start:
             the loss at the start and the share of the input's
             coordinates that agree after one step (its first
             ST_INVERT_CHECK steps printed beside it). (d) `utils/flops.py`'s
             count of one local step and one G = 10 group step, TFLOP a
             round, and with phase fedsim's G = 10 round its achieved
             TFLOP/s and share of the bf16 peak (printed, not gated). (e)
             ST_EDGES `NativeCNNTrainer` devices (host C++,
             `native/edge_trainer.cpp`, built here) of ST_EDGE_ROWS rows
             in one cross-device round through `CrossDeviceServer` on the
             card: the build's seconds, ms a device's train, and the
             aggregate bitwise the weighted mean of the returned vectors
             recomputed on the card (and its distance from their f64
             mean). No K1-K4 launch.

15. entry  - the single-process entry surface at the flagship (G = 10,
             ENTRY_ROUNDS rounds): (a) the same rounds untracked, then
             `init` -> `mlops.init` -> the Simulator's run (what
             `run_simulation` runs) -> `mlops.finish`, tracked into a run
             dir with the file artifact store, sysperf every
             ENTRY_SYSPERF_S and /metrics: a `train` span a round in the
             events JSONL, sysperf rows with the card's bytes in use, the
             end-of-run report row, the Chrome trace's round track, the
             postmortem's reason `finish`, an aggregated artifact a round
             and the last bitwise the final parameters; ms of the warm
             round with and without tracking, ms a publish, the
             artifact's bytes. (b) `report --format json` (a `train` span
             a round, each round's compute time > 0), `top --once` and
             `logs --list` on the run dir, as subprocesses started
             together with (c) and `env`. (c) `python -m fedml_tpu_torch
             run` on the same config written as JSON, one round: rc 0 and
             a round-0 last line. (d)
             `predictor_from_artifact` behind the HTTP runner: /predict on
             32 test images equal to apply_fn of the final parameters on
             the same batch (labels and rounded probabilities). (e) in
             phase serve_surface, on its runner over the kernel engine:
             rank-8 adapters put into a file store and swapped in by POST
             /swap (200, version 2, the fetched tree bitwise the one put),
             then 4 concurrent POSTs answered in full with K4 launched;
             the swap's ms. (f) `env` names nvidia-smi's card, and
             `diagnosis` (K1-K4 built and held against their plain
             versions, the transports, the serving engine through K4;
             started with the phase, beside (a)-(c)) exits 0 with every
             required probe passed (`lint_clean`: graftlint's zero
             findings; `attribution_smoke` with the ledger's legs); each
             probe's seconds. `fleet_obs_smoke` is left out where the
             `grpc` module is missing (the card's machine), named on
             (f)'s line with the reason.

16. tasks  - the simulator's other tasks, datasets and models through
             `fedml_tpu_torch.init` and the Simulator (vmap's per-example
             fallback an error): (a) the token task, synthetic
             shakespeare (vocab 81, T 80) with CharRNN at its defaults
             (embed 8, two LSTM layers of 256, 818,137 parameters), task
             nwp, bf16, TASKS_CLIENTS IID clients, TASKS_PER_ROUND a
             round, batch TASKS_BATCH, 1 epoch: a warm and a timed round
             at G = 1 and at G = TASKS_G, ms a round and a local step,
             launches a local (group) step and the idle share from
             TASKS_PROFILE_STEPS profiled local steps (G = 1) and one
             profiled round (G = TASKS_G); one f32 local step on the card
             within 1e-3 of the CPU's largest update (TF32 off); the two
             LSTM layers against cuDNN's nn.LSTM on the same f32 weights
             (within TASKS_LSTM_TOL), both timed forward + backward, and
             whether vmap batches nn.LSTM's gradient (printed). (b)
             synthetic pascal_voc (32x32x3, 21 classes) with UNetLite,
             task segmentation, G = TASKS_G: a warm and a timed round,
             the eval row with test_miou; the trained parameters'
             confusion matrix on TASKS_SEG_CHECK test images on the card
             and the CPU (f32, TF32 off) within twice the CPU's near-tie
             pixels. (c) stackoverflow_lr at its published width (10000
             words, 500 tags, as so_vocab_size / so_tag_size through
             `loader.load`; the synthetic bags of words) with lr, task
             multilabel: one round and an eval. No K1-K4 launch.

17. runtimes - the remaining runtimes and models through the port's entry
             points on the card: (a) `FedMLRunner` with train_args.async
             at the flagship (RT_ASYNC_PER_ROUND x RT_ASYNC_ROUNDS merged
             updates, RT_ASYNC_CONCURRENCY in flight, chaos client_dropout
             RT_ASYNC_DROPOUT): ms a merged update, the largest
             staleness, the eval rows, every event trained from the
             parameters of the version it was launched at (bitwise,
             though merges ran while it was pending), and one f32 local
             step on the card within 1e-3 of the CPU's largest update
             (TF32 off). (b) DSGD (neighbor_num 2) and PushSum (in 2,
             out 1) over RT_NODES flagship nodes from scattered starts,
             minibatches of RT_DEC_BATCH, a warm and RT_DEC_ITERS timed
             iterations: ms an iteration, the gossip's ms alone, the
             consensus distance before and after; the first iteration in
             f32 over the first FEDAVG_PARITY_CLIENTS nodes from one
             replicated CPU draw on the card and the CPU (the same
             indices) within 1e-3. (c) FedGKT at its default
             nets over the first RT_GKT_CLIENTS flagship clients (S 224):
             a warm round, then the client and server phase ms; the
             client phase in f32 on the card and the CPU (the same batch
             orders) within 1e-3. (d) FedGAN at the hub defaults (img 28,
             1 channel, width 64, latent 64) over the mnist fallback's
             shards, RT_GAN_CLIENTS a round at G = RT_GAN_G through
             `build_round_fn`: a warm and a timed round; the first 2
             clients' one-step f32 update on the card and the CPU (the
             same draws) within 1e-3, or with at least ST_INVERT_SHARE
             of its coordinates within it (Adam's first step is a sign
             step, as DLG's in phase standalone). Each f32 check also
             runs the CPU in f64, and where f32 itself departs further
             holds the card to phase fedavg's clause. (e) HierFL (2
             groups x 2 sub-rounds over the first RT_HIER_CLIENTS, G =
             RT_HIER_G), SplitNN (the GKT nets as bottom and top),
             vertical FL (3 parties) and a flow-DSL FedAvg over loopback:
             each one's seconds and whether its loss fell (printed, not
             gated). (f) RT_TORCH_SILOS `TorchSiloTrainer` silos over the
             hub CNN on the card through `FedServerManager` over
             loopback for RT_TORCH_ROUNDS rounds. No K1-K4 launch.
18. fleet  - the serving fleet, the scheduler tier and the live loop.
             (a) at LLaMA-2-7B width and depth in bf16: two replicas from
             `start_replica` (the `serve` cell's knobs: 8 slots,
             engine_max_len 1024, 16-token pages, prefill chunks of 256,
             paged_kernel) sharing one copy of the weights, rank-8 v1
             adapters, adopted into a `Deployment` behind the load-aware,
             shedding `InferenceGateway` (affinity on); a `LoadGenerator`
             wave of FLEET_LOAD_S (Zipf prefixes, half the requests
             streamed, one burst) takes a rolling update to v2 adapters
             through a `FileArtifactStore` mid-wave: no non-2xx but 429
             sheds, both replicas at version 2, K4 launched 32 x the two
             engines' decode steps (counts zeroed before the wave, read
             after), no K1-K3; four probe prompts through the gateway
             against one engine on v2 driven directly (near-tie rule);
             then a `replica_kill` at a streamed greedy request's 8th
             token: the stream ends in a terminal event with every index
             once, its replay matched or continued. (b) the platform tier
             at the flagship ResNet-18-GN: `api.cluster_start(2)` ->
             `model_create` -> `model_deploy(n_replicas=2)` (replicas come
             up through MasterAgent -> WorkerAgent -> `start_replica`, the
             params on the loopback wire) -> `model_gateway`: 64 synthetic
             CIFAR images equal a `TorchPredictor`'s answer; a replica's
             runner stopped: failover with no non-2xx and `reap_and_heal`
             brings a replacement to READY; a `python` job through
             `launch_job` and `python -m fedml_tpu_torch launch`; then one
             master-dispatched LM serve job at 7B width and FLEET_LM_LAYERS
             layers (its bf16 params on the wire) answering 4 greedy
             requests with K4 launched FLEET_LM_LAYERS x its decode
             steps. (c) `LiveLoopHarness` at its own defaults, 4 rounds, 2
             silos, 2 replicas, one FaultSpec killing the trainer server,
             a trainer client and a replica: no non-2xx but sheds, the
             fleet at the last round's version, the SLOs held (the JAX
             soak test's bounds), and the final adapters bitwise an
             unkilled run's on the card. A `FleetCollector` over the
             gateway's `fleet_roster()` (the gateway and both replicas)
             scrapes every FLEET_SCRAPE_S through (a)'s wave: three
             `process` label values in its aggregate, each split back
             equal to the process's own scrape, the fleet sums of the
             wave's `serving_*` counters equal to the sum of the
             per-process deltas (the three share this process's
             registry); after the kill the killed replica stays in the
             view, marked stale.
19. mesh   - rounds over a device mesh and hierarchical cross-silo at the
             flagship ResNet-18-GN width (bench.py's batch and shapes;
             the cut is depth: MESH_CLIENTS of a 10-client synthetic
             CIFAR-10 partitioned hetero, MESH_SAMPLES samples a client,
             not 100 x 96). (a) one bf16 round of the first 8 clients
             over a one-rank NCCL `clients` mesh (this process as a
             one-rank world): the aggregate and every metric bitwise the
             unmeshed round's, with the same batch_idx. (b) one f32 round
             (TF32 off) of 9 clients through the Simulator in two gloo
             ranks sharing the card, started by `parallel/launch.RankPool`
             with device_args.mesh_shape {clients: 2}: the cohort padded
             to 10 with one zero-weight duplicate, the varied counts
             placed by balanced LPT (both rows printed), within 1e-3 of
             the largest update of the unmeshed f32 Simulator round.
             (c) `run_hierarchical`: 2 silos x intra 2 (gloo ranks on the
             card, TF32 off), one f32 round over loopback, within 1e-3 of
             flat FedAvg over the same trainers without a mesh, or where
             f32 itself departs further, phase fedavg's clause against
             the flat run in f64; each rank's inner all-reduce count a
             step and its exit code printed.
             K1-K4 launch 0 times in the phase (this process and the
             ranks); seconds per part and peak memory per rank. A rank
             that fails fails the phase; one that hangs is stopped after
             MESH_TIMEOUT_S and fails it.
20. qlora  - the int8 LoRA base, vmapped LoRA clients and the seq round.
             (a) LLaMA-2-7B at full width and depth, the seeded bf16 init
             quantised on the card (`quantize_tree_int8`: its
             `quant_bytes` beside the bf16 base's), served by the
             `serve` cell's engine (8 slots, max_len 1024, pages of 16,
             prefill chunks of 256, paged_kernel) with rank-8 adapters
             (nonzero B) on the first QLORA_WAVE requests, beside the
             bf16 base's engine on the same wave: peak memory, ms a
             decode step, decode tokens/s, K4 launches = 32 x decode
             steps; then the f32 engine over the int8 base (TF32 off)
             on QLORA_CHECK of them for QLORA_CHECK_NEW tokens, token
             identical to the f32 recompute greedy loop of
             `make_inscan_quant_apply` under the near-tie rule (the bf16
             engine's match with the bf16 loop printed, not gated).
             (b) `make_fedllm_seq_round(inscan_quant=True)` over that
             int8 base on a one-rank NCCL (silos 1, seq 1) mesh, bf16:
             one round of 2 clients x QLORA_SEQS sequences of 2048
             tokens, batch 1: adapters finite and moved, peak memory.
             (c) the flash LoRA round at 7B width and QLORA_LAYERS
             layers, bf16, at G = QLORA_G against G = 1 (phase train's
             clients, sequences and schedule): the adapters within
             QLORA_VMAP_TOL of G = 1's largest update, launches K1 =
             2 x layers x group steps (not x G), K2 = K3 = layers x
             group steps; at the group's shape (G 2, BH 64, T 2048, D
             128) the folded K1-K3 bitwise the per-client launches, one
             launch each, and within FLASH_TOL of their plain versions;
             the folded forward and gradient timed against the clients'
             launches one by one.
             (d) two gloo ranks sharing the card, 7B width, QLORA_LAYERS
             layers, f32 (TF32 off): the (silos 1, seq 2) round, ring
             and Ulysses, over the float and the int8 base (2 clients x
             QLORA_SEQS sequences of QLORA_SEQ_T), each within
             QLORA_SEQ_TOL (atol, rtol) of the (silos 1, seq 1) round,
             the ranks' adapters bitwise, exit codes 0.

21. tp     - tensor parallelism: two gloo ranks sharing the card
             (an {"mp": 2} or {"dp": 1, "tp": 2} mesh, 16 of the 32 heads a
             rank); one card, so no part is a speed of several GPUs.
             (a) the tensor-parallel DecodeEngine at LLaMA-2-7B width and
             TP_A_LAYERS layers in bf16, the `serve` cell's knobs (8 slots, pages of
             16, prefill chunks of 256, paged_kernel) with rank-8 adapters
             and spec_k 4, over the first TP_WAVE requests: K4 on each
             rank at H 16 only and at C 5 only, layers x windows a rank;
             ms a decode step (wave wall / windows), peak memory a rank,
             the tokens against rank 0's unmeshed engine (reported, not
             gated: bf16 sums in another order). (a') the f32 gate at 7B
             width and TP_F32_LAYERS layers, TF32 off: the mp 2 kernel
             engine token-identical to the unmeshed kernel engine under
             the near-tie rule, over an f32 and an int8 pool, each
             request cut to TP_F32_NEW tokens; a margin is the reference
             engine's own at the first differing pick (an int8 pool's
             rounding moves the logits off the float model's, whose
             margin is printed beside it). (b) `build_scaled_fedllm`
             over (dp 1, tp 2) with an int8 base at 7B width and
             TP_B_LAYERS layers (the same seeded base injected in both
             ranks), the flash kernels on each rank's heads, bf16,
             TP_B_STEPS steps of TP_B_BS x TP_B_T tokens: K1 = 2 x
             layers x steps, K2 = K3 = layers x steps a rank, at SGD
             rate TP_B_LR: every step's loss within TP_B_TOL of the tp 1
             run's (rank 0, the same base and tokens), the adapters
             moved by at least TP_B_MOVED and bitwise the same in both
             ranks, seconds a step; the same steps again in f32 (TF32
             off, the f32 flash kernels): each adapter leaf's change
             over the steps within TP_B_UPD_TOL of tp 1's (over the
             largest change; the bf16 pass's distance reported), base
             bytes a rank 45-60% of the whole int8 base, and the
             sharded base checkpoint bitwise after a write and a read.
             (c) the centralized trainer on the flagship ResNet-18-GN at
             {"mp": 2}, one epoch over the synthetic loader's 500 images
             (TP_C_CLIENTS x TP_C_SAMPLES is under its floor) from one
             seeded start, against {"mp": 1}: in f64 within rtol 1e-4 /
             atol 1e-5 (the parameters) and rtol 1e-4 (the loss); in f32
             (TF32 off) the distance reported beside the update, and
             each f32 run's distance from the f64 run at its mp (how far
             one epoch of the cell carries f32 rounding); 62 leaves;
             K1-K4 0.

22. examples - the shipped examples' smoke suite: the 12 cases of
             tests/test_examples.py (`examples.CASES`) through the ported
             examples (`fedml_tpu_torch/examples/`), each its module's
             `main(["--device", "cuda", ...])` in this process, at the
             JAX examples' sizes; the two mesh cases (hierarchical
             cross-silo over (silos 4, intra 2), FedLLM --ring over
             (silos 2, seq 4)) start 8 gloo ranks sharing the card. Each
             example's own asserts decide; a line a case: its wall
             seconds, its final reading (what `main` returns: the last
             round's test_acc or train_loss, tokens served) and K1-K4's
             launches, which must be 0 (the examples run dense attention
             and the contiguous decode): this process's, plus for the
             two mesh cases the sum over their 8 ranks, which count
             their own launches from 0 and return them
             (`rank_launches`). The platform example's model registry is
             a temporary directory. The digits cases read scikit-learn's
             digits from the port's copy (`data/digits.npz`).

Then the `kernels` line, the raw `nvidia-smi` name/power-limit line, and as
the last line {"ok": true, "device": {...}}. Imports nothing of JAX or of
the JAX package; without a CUDA device it exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import atexit
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
          "cross_silo_secure", "standalone", "entry", "tasks", "runtimes",
          "fleet", "mesh", "qlora", "tp", "examples")
# run only when named in --only
OPTIONAL = ("profile", "train_profile", "fedavg_profile")
# the second lane: these phases run in their order in a child process,
# beside the first lane's (the rest) in this one, from when phases kernel
# and flash have timed the kernels alone on the card (the script read
# 949-1224 s with every phase in one line, over its 1200 s limit on a
# slow host); the phases whose peaks would not fit beside each other
# (engine's f32 7B weights alone are 27 GB, fleet peaks at 41 GB, fedsim
# at 28 and plugins at 23 on the H100; every other pair of peaks stays
# under 60 of its 80 GB) take turns
# across the lanes; the seconds from the start by which the second lane
# must have ended
LANE_B = ("mesh", "fedavg", "fedavg_profile", "fedsim", "plugins",
          "cross_silo", "standalone", "examples")
HEAVY = ("engine", "fleet", "fedsim", "plugins")
LANE_JOIN_S = 1100.0
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
# to keep the script near 75% of its time limit); the parity rounds of
# phases fedsim and plugins take its first FEDAVG_PARITY_CLIENTS clients
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
# phase fedavg's card-vs-CPU round (f64 and f32 on the CPU, f32 on the
# card) over its first clients, and the threads of the child process that
# runs the CPU's two rounds beside the second lane's phases before it
# (inline they read 46-76 s of the host; 2 clients while phase fleet
# first joined the script)
FEDAVG_CPU_CLIENTS, CPU_PARITY_THREADS = 4, 6
# phase fedsim: the client-group widths timed at the flagship beside
# G = 1, G = 10's timed rounds after its warm one (3 since phase plugins
# joined the script, 2 since phase serve_surface did, 1 since phase
# cross_silo_secure did, to keep the script near 75% of its time limit;
# G = 1 times one round; G = 4's two rounds, with the determinism setting
# on and off, went when phase fleet joined the script: PERF.md keeps their
# reading), and the reduced cohort of the bitwise bars
FEDSIM_GROUPS, FEDSIM_ROUNDS, FEDSIM_SMALL = (10,), 1, 8
# phase entry: rounds of each flagship run (the first warms), and the
# sysperf sampler's period in the tracked run
ENTRY_ROUNDS, ENTRY_SYSPERF_S = 2, 1.0
# phase plugins: timed rounds after the warm one, each configuration's
# train_args / security / dp / chaos sections over the flagship config at
# G = 10. LDP's sensitivity is 1e-3 (sigma 4.8e-3 a coordinate), so that
# the noised flagship keeps a finite loss over its rounds; the noise's
# arithmetic is the same at any scale.
# timed rounds a configuration: one each ((a) and (b) took two until phase
# cross_silo_secure joined the script); only "plain" warms first: the
# configurations after it find the flagship's shapes warm (each one's
# warm round read 0.97-1.08x its timed round on the H100 before phase
# tasks joined the script and cut them)
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
# phase cross_silo: the flagship's silos (its first 50 of 100 since phase
# fleet joined the script: a round is the server's serial wire work, so
# its ms a silo is the reading), timed flagship rounds after the warm one
# (2 until phase cross_silo_secure joined the script); the f32
# federation of its bars (silos of CS_SHARDS samples, so that the
# aggregate's weights differ, each taking one local step of CS_BATCH a
# round for CS_SMALL_ROUNDS rounds), its chaos plan (with the retry budget
# that makes it deliver), and its tolerance against the Simulator's rounds
CS_FLAGSHIP_SILOS, CS_ROUNDS = 50, 1
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
# bench.py:bench_comm_codec at the flagship, over its first CODEC_SILOS
# silos (100 until phase fleet joined the script: a round read 63 s); (d)'s
# flaky device's timeout
SA_SILOS, SA_TIMEOUT, SA_FAIL_TIMEOUT = 10, 6.0, 4.0
CODEC_SILOS = 30
SA_CODEC = {"kind": "dense"}       # field_pack rides c2s_sa_masked
CODEC = {"kind": "sparse_topk", "ratio": 0.12, "val_bits": 16,
         "error_feedback": True}
CD_TIMEOUT = 6.0
# phase standalone: (a) the centralized bar: ST_BAR_ROWS rows (one batch,
# so an epoch is one step; 8 steps over 154 rows read 4.1e-2 of the
# update on the H100, where f32 itself departs, C.2) for two f32 epochs
# with momentum ST_BAR_MOMENTUM on the card and the CPU; (b) contribution
# over ST_CONTRIB_M trained clients (LOO, GTG), MR over the first ST_MR_M
# (2^8 - 1 = 255 subsets), utilities on ST_TEST_ROWS test images (1024
# until the H100 read 135 ms a subset there, 151 s for the part: GTG took
# 890 of the 1023 subsets; 256 until phase tasks joined the script, 41 s
# for the part), ST_CHUNK subsets a vmapped call,
# ST_SINGLE_CHECKS subsets one at a time within ST_SUBSET_TOL of the
# batch (f32, TF32 off: the same products, only the vmapped kernels'
# batch sizes differ); (c) ST_INVERT_STEPS attack steps (50 until phase
# tasks joined the script); DLG on the card
# and the CPU from one start (TF32 off): the match loss at the start
# within ST_INVERT_LOSS_TOL, and after one step at least ST_INVERT_SHARE
# of the input's coordinates within ST_INVERT_X_TOL. Adam's first step is
# a sign step of size lr = 0.1: it agrees wherever the two devices'
# gradients agree in sign. The first ST_INVERT_CHECK steps are printed,
# not gated: a coordinate whose gradient sits within f32 rounding of zero
# moves +lr on one side and -lr on the other, which moves every later
# gradient (the H100 read the third step's loss 8.8e-3 apart, and 92% of
# the coordinates more than 1e-3 apart after 3 steps); (e)
# ST_EDGES native devices of ST_EDGE_ROWS rows each at ST_EDGE_LR (the
# plain CNN has no normalisation; at the flagship's 0.05 its loss on the
# synthetic images, std 1.8, runs to 11-14 in the first epoch)
ST_BAR_ROWS, ST_BAR_MOMENTUM = 32, 0.9
ST_CONTRIB_M, ST_MR_M, ST_TEST_ROWS, ST_CHUNK = 10, 8, 128, 16
ST_SINGLE_CHECKS, ST_SUBSET_TOL = 8, 1e-4
ST_INVERT_STEPS, ST_INVERT_CHECK = 20, 3
ST_INVERT_X_TOL, ST_INVERT_LOSS_TOL, ST_INVERT_SHARE = 1e-3, 1e-4, 0.99
ST_EDGES, ST_EDGE_ROWS, ST_EDGE_LR = 10, 96, 0.01
# phase tasks: (a) the token task at the shakespeare shape (vocab 81, T
# 80) with CharRNN at its defaults: TASKS_CLIENTS clients of
# TASKS_SAMPLES synthetic sequences (IID; 4 local steps a client: at 120
# the H100 read 10.6-19.8 s a G = 1 round, the host-bound step at 89-165
# ms, and the script 987.6 s), TASKS_PER_ROUND a round, batch
# TASKS_BATCH (McMahan et al.'s shakespeare batch), lr TASKS_LR, 1 epoch,
# a warm and a timed round at G = 1 and at G = TASKS_G; launches and the
# idle share from TASKS_PROFILE_STEPS profiled local steps at G = 1 and
# one profiled round at G = TASKS_G; the port's two LSTM layers against
# cuDNN's nn.LSTM within TASKS_LSTM_TOL of the output (f32, TF32 off:
# the same products summed in another order over 80 steps). (b)
# pascal_voc with UNetLite at G = TASKS_G, the confusion matrix on
# TASKS_SEG_CHECK test images. (c) stackoverflow_lr at its published
# width (TASKS_SO_WIDTH words, TASKS_SO_TAGS tags), TASKS_SO_SAMPLES
# samples a client
TASKS_CLIENTS, TASKS_PER_ROUND, TASKS_BATCH, TASKS_SAMPLES = 100, 10, 10, 40
TASKS_LR, TASKS_G, TASKS_PROFILE_STEPS = 0.5, 10, 3
TASKS_LSTM_TOL, TASKS_SEG_CHECK = 1e-4, 128
TASKS_SO_WIDTH, TASKS_SO_TAGS, TASKS_SO_SAMPLES = 10000, 500, 64
# phase runtimes: (a) async at the flagship, RT_ASYNC_PER_ROUND x
# RT_ASYNC_ROUNDS merged updates, RT_ASYNC_CONCURRENCY clients in flight,
# chaos client_dropout RT_ASYNC_DROPOUT; (b) DSGD and PushSum over the
# first RT_NODES flagship shards, minibatches of RT_DEC_BATCH, one warm
# and RT_DEC_ITERS timed iterations; (c) FedGKT over the first
# RT_GKT_CLIENTS; (d) FedGAN at the hub defaults, RT_GAN_CLIENTS a round
# at G = RT_GAN_G, batch RT_GAN_BATCH, Adam lr RT_GAN_LR (the DCGAN
# rate); (e) HierFL over the first RT_HIER_CLIENTS at G = RT_HIER_G,
# SplitNN over RT_SPLIT_CLIENTS, vertical FL over RT_VFL_ROWS rows of
# RT_VFL_DIMS features, the flow-DSL FedAvg for RT_FLOW_ROUNDS rounds;
# (f) RT_TORCH_SILOS torch silos for RT_TORCH_ROUNDS rounds at lr
# RT_TORCH_LR (phase standalone's rate for the plain CNN)
RT_ASYNC_PER_ROUND, RT_ASYNC_ROUNDS, RT_ASYNC_CONCURRENCY = 10, 2, 4
RT_ASYNC_DROPOUT = 0.1
RT_NODES, RT_DEC_BATCH, RT_DEC_ITERS = 16, 8, 5
RT_GKT_CLIENTS = 10
RT_GAN_CLIENTS, RT_GAN_G, RT_GAN_BATCH, RT_GAN_LR = 10, 10, 32, 2e-4
RT_HIER_CLIENTS, RT_HIER_G, RT_SPLIT_CLIENTS = 20, 10, 4
# the group assignment seed that splits the 20 clients 10 / 10, so each
# sub-round is one group of G = 10 (seed 0 splits 9 / 11, and 11 clients,
# a prime, run one at a time)
RT_HIER_SEED = 3
RT_VFL_DIMS, RT_VFL_ROWS, RT_FLOW_ROUNDS = (5, 4, 3), 4096, 2
RT_TORCH_SILOS, RT_TORCH_ROUNDS, RT_TORCH_LR = 4, 2, 0.01
# phase fleet: (a) the serve cell's knobs on both replicas, the loadgen
# wave's seconds and base rate (one burst at FLEET_BURST x the rate for
# its first FLEET_BURST_S seconds; prompt + output <= 560 of the 1024
# tokens; outputs of median 16 and at most 48, cut from 32 and 128 when
# the script read 1207.9 s, so the wave drains in seconds; at 1 rps the
# H100 read 1.8 slots a decode step of 8, so 2.5 rps keeps ~4-5 of each
# replica's 8 busy), the second of the wave the rolling update starts at,
# the shed watermark (in flight per ready replica: its decode slots, so a
# replica sheds only what it could not batch at once), the greedy
# streams' budget and the probe prompts; (b) the LM serve job's depth at
# 7B width, the flagship images; (c) the live loop's rounds
FLEET_SERVE = {"decode_slots": N_SLOTS, "engine_max_len": MAX_LEN,
               "kv_page_size": PS, "prefill_chunk": PREFILL_CHUNK,
               "paged_kernel": True}
FLEET_LOAD_S, FLEET_RATE, FLEET_SWAP_AT_S = 20.0, 2.5, 8.0
FLEET_SHED = float(N_SLOTS)
FLEET_SCRAPE_S = 2.0   # the fleet collector's interval through the wave
FLEET_BURST, FLEET_BURST_S = 3.0, 2.0
FLEET_TRAFFIC = dict(prefix_pool=16, prefix_len=256, zipf_s=1.2,
                     suffix_len_med=64.0, suffix_len_sigma=0.8,
                     suffix_len_max=256, out_len_med=16.0,
                     out_len_sigma=0.6, out_len_max=48, stream_frac=0.5)
FLEET_STREAM_NEW, FLEET_PROBES, FLEET_PROBE_NEW = 24, 4, 16
FLEET_LM_LAYERS, FLEET_IMAGES, FLEET_LOOP_ROUNDS = 2, 64, 4
# (c)'s SLO bounds: the JAX soak test's (tests/test_live_loop.py's fixture,
# whose bars its tests 70-127 assert); the harness's default 2000 ms TTFT
# p99 read 2074.3 ms on a slow host, the 2 s bar a CPU default
FLEET_LOOP_SLO = {"shed_frac_max": 0.4, "ttft_p99_slo_ms": 5000.0,
                  "lag_rounds_max": 2}
# vmap's per-example fallback warns; phases fedsim and tasks make it an
# error
# phase mesh: (b)'s odd cohort of a 10-client hetero partition (padded
# to 10 over 2 ranks), samples a client before the partition, (c)'s rows
# a silo (2 steps of 32), and the seconds after which a rank that has not
# answered is stopped and fails the phase
MESH_CLIENTS, MESH_SAMPLES, MESH_SILO_ROWS, MESH_TIMEOUT_S = 9, 64, 64, 240
# phase qlora: (a) the first QLORA_WAVE of `_requests` through the serve
# cell's engine, bf16 and int8 bases, and QLORA_CHECK of them for
# QLORA_CHECK_NEW tokens through the f32 engine against the f32 recompute
# loop; (b) QLORA_SEQS sequences of TRAIN_T a client, batch 1; (c) the
# group width and depth of the vmapped round, and the bar on its adapters:
# max |a(G=2) - a(G=1)| over max |a(G=1) - a0| (bf16: the vmapped group
# runs its products as batched cuBLAS calls, which round bf16 at other
# points than the per-client calls; the flash kernels themselves give the
# same bits); (d) the seq round's depth, its tokens a sequence and the
# JAX inscan bar (tests/test_fedllm_scale.py:403-406)
QLORA_WAVE, QLORA_CHECK, QLORA_CHECK_NEW = 8, (0, 2, 3), 8
QLORA_SEQS, QLORA_G, QLORA_LAYERS, QLORA_VMAP_TOL = 2, 2, 2, 5e-2
QLORA_SEQ_T, QLORA_SEQ_TOL, QLORA_TIMEOUT_S = 256, (2e-4, 2e-3), 300
# phase tp: two gloo ranks sharing the card, mp = 2 (16 heads a
# rank). (a) the bf16 engine at TP_A_LAYERS layers (cut from 32 to keep the
# script near 1000 s: every collective is staged through the host, and at
# full depth the phase read 92 s) over the first TP_WAVE requests;
# (a') the f32 gate at TP_F32_LAYERS layers over the same requests, each
# cut to TP_F32_NEW tokens; (b) the int8 scaled step at TP_B_LAYERS
# layers, TP_B_STEPS steps of TP_B_BS x TP_B_T tokens; (c) the flagship's
# centralized epoch over TP_C_CLIENTS clients' synthetic images, batch
# TP_C_BATCH, f32. (b)'s bars against tp = 1: TP_B_TOL on every bf16
# step's loss; TP_B_UPD_TOL on each adapter leaf's change over the f32
# steps (TF32 off), over the largest change (a missing adapter all-reduce
# halves wv's and wo's; the bf16 pass, reported, read 6.7e-2 on an
# H100: its rounding, summed over 2048 tokens that mostly cancel); an
# SGD rate TP_B_LR that moves an adapter by at least TP_B_MOVED of its
# largest entry
TP_WAVE, TP_A_LAYERS, TP_F32_LAYERS, TP_F32_NEW = 4, 8, 2, 16
TP_TIMEOUT_S = 300
TP_B_LAYERS, TP_B_STEPS, TP_B_BS, TP_B_T = 2, 3, 2, 1024
TP_B_LR, TP_B_TOL, TP_B_UPD_TOL, TP_B_MOVED = 1.0, 1e-4, 1e-4, 1e-2
# (c)'s 4 x 32 images fall under the synthetic loader's floor of 500
# (`data/loader._synthetic_for`), which sets (c)'s set: 16 steps of 32
TP_C_CLIENTS, TP_C_SAMPLES, TP_C_BATCH = 4, 32, 32
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


def _cost():
    """The package's one count of kernel work
    (`fedml_tpu_torch/ops/cost.py`: `paged_cost`, `flash_cost`,
    `peak_flops`): the bounds below and the cost ledger read the same
    functions."""
    from fedml_tpu_torch.ops import cost

    return cost


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
def _kernel_case(rng, c: int, kind: str, serve: bool = False, h: int = H,
                 qdt=None):
    """Random pool, page tables and positions at the check shape (or, with
    `serve`, at the serve wave's tables and reservations), at `h` heads;
    `qdt` overrides q's dtype (an int8 pool under f32 q)."""
    import torch

    dev = DEV
    qdt = qdt or (torch.float32 if kind == "f32" else torch.bfloat16)
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
    shape = (P_CHECK, PS, h, DH)
    # the pools (2 x 72 M entries) are drawn on the card, from a seed the
    # case's generator draws: set-up, not the check, and slow on the host
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(2 ** 62)))
    if kind == "int8":
        k, v = (torch.randint(-127, 128, shape, generator=gen, device=dev,
                              dtype=torch.int8) for _ in range(2))
        ks = torch.from_numpy(rng.uniform(0.005, 0.02, (P_CHECK, h))
                              .astype(np.float32))
        vs = torch.from_numpy(rng.uniform(0.005, 0.02, (P_CHECK, h))
                              .astype(np.float32))
        scales = (ks.to(dev), vs.to(dev))
    else:
        k, v = (torch.randn(shape, generator=gen, device=dev).to(qdt)
                for _ in range(2))
        scales = (None, None)
    q = torch.from_numpy(
        rng.standard_normal((S_CHECK, c, h, DH), np.float32)).to(qdt)
    return (q.to(dev), k, v, torch.from_numpy(pages).to(dev),
            torch.from_numpy(pos).to(dev)) + scales


def _bound(nbytes: int, flops: int, dtype, bw: float) -> dict:
    t_bytes = nbytes / bw * 1e3
    t_ops = flops / _cost().peak_flops(dtype) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def _sdpa_gathered_ms(q, k, v, pages, pos, ks, vs) -> float:
    """Library yardstick: SDPA on PRE-GATHERED contiguous K/V (gather and
    dequant excluded from the time), the same causal mask."""
    import torch
    import torch.nn.functional as F

    s_, c, h = q.shape[:3]
    n_pg = int(((pos.long() + c - 1) // PS + 1).max())
    idx = pages[:, :n_pg].long()

    def gathered(pool, sc):
        g = pool[idx]
        if sc is not None:
            g = (g.float() * sc[idx][:, :, None, :, None]).to(q.dtype)
        return g.reshape(s_, n_pg * PS, h, DH).transpose(1, 2).contiguous()

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
            nbytes, flops = _cost().paged_cost(
                q, pos, PS, pages.shape[1], k.element_size(),
                ks is not None)
            row = {"ms": ms, "library_ms": lib_ms,
                   "plain_ms": time_ms(lambda: pa.paged_attention_ref(*case),
                                       n=10, warmup=1),
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
    out["head_split"] = _kernel_head_split(bw)
    return out


# K4 at the head split (phase tp's ranks): (name, pool kind, C, q dtype)
HEAD_SPLIT_CASES = (("f32", "f32", 1, "float32"), ("bf16", "bf16", 1, None),
                    ("bf16_c5", "bf16", 5, None), ("int8", "int8", 1, None),
                    ("int8_f32q", "int8", 1, "float32"))


def _kernel_head_split(bw: float) -> dict:
    """K4 at the serve shape over H / 2 heads, each case checked against
    the plain version under TOL and timed (kernel, plain, SDPA on
    pre-gathered K/V, bound)."""
    import torch

    from fedml_tpu_torch.ops import paged_attention as pa
    from fedml_tpu_torch.ops.tolerance import rowwise_rel_err

    out = {}
    for i, (name, kind, c, qdt) in enumerate(HEAD_SPLIT_CASES):
        case = _kernel_case(np.random.default_rng(40 + i), c, kind,
                            serve=True, h=H // 2,
                            qdt=getattr(torch, qdt) if qdt else None)
        q, k, v, pages, pos, ks, vs = case
        got = pa.paged_attention(*case)
        ref = pa.paged_attention_ref(*case)
        torch.cuda.synchronize()
        check(torch.isfinite(got).all().item(), f"h16 {name}: non-finite")
        rel = rowwise_rel_err(got, ref)
        check(rel <= TOL[kind], f"h16 {name}: row-relative err {rel} > "
              f"{TOL[kind]}")
        nbytes, flops = _cost().paged_cost(
            q, pos, PS, pages.shape[1], k.element_size(), ks is not None)
        out[name] = {
            "heads": H // 2, "C": c, "q_dtype": str(q.dtype),
            "max_abs_err": (got.float() - ref.float()).abs().max().item(),
            "max_row_rel_err": rel,
            "ms": time_ms(lambda: pa.paged_attention(*case)),
            "plain_ms": time_ms(lambda: pa.paged_attention_ref(*case),
                                n=10, warmup=1),
            "library_ms": _sdpa_gathered_ms(*case),
            **_bound(nbytes, flops, q.dtype, bw)}
        emit({"phase": "kernel", "head_split": name, **out[name]})
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
    from fedml_tpu_torch.utils import xla_ledger

    def counters():
        c = mx.snapshot()["counters"]
        return {k: c.get(k, 0) for k in (
            "serving.prefix_hits", "serving.spec.proposed",
            "serving.spec.accepted")}

    eng = _engine(model, **kw)
    # the device-memory ledger's kv_pool entry beside the engine's own
    # math, read before another engine in this process re-registers
    ledger = {"kv_pool_bytes": xla_ledger.buffers()["kv_pool"],
              "engine_kv_bytes": eng.n_slots * mx.snapshot()["gauges"][
                  "serving.kv_bytes_per_slot"]}
    try:
        # the warm-up with the cost ledger's captures on, as a tracked run
        # has them (each engine program captured at its first call); the
        # wave runs with them off, as an untracked server does
        prev = xla_ledger.set_capture(True)
        try:
            eng.submit(list(range(1, 33)), 4).result(timeout=600)
        finally:
            xla_ledger.set_capture(prev)
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
        # the programs the warm-up captured (its first admission and step)
        progs = xla_ledger.programs()
        stats["ledger"] = {**ledger, **{
            k: progs.get(k) for k in ("engine_step", "engine_admit",
                                      "engine_spec")}}
    finally:
        eng.stop()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return outs, stats


def _top2_margin(model, tokens) -> float:
    import torch

    with torch.no_grad():
        lg = model(torch.tensor([tokens], device=model.device))[0, -1].float()
    top = torch.topk(lg, 2).values
    return float(top[0] - top[1])


def _record_margins(eng) -> dict:
    """Wrap an engine's picks (a harness around the non-speculative
    engine, greedy requests): {id(ticket): [top-2 logit margin of each
    pick, in order]} from the logits the engine itself picks from (its
    first token at admission, then one a step while its slot is
    active). Reads the margins back each step, so the wave synchronises."""
    import torch

    rec: dict = {}
    last: dict = {}
    pick, arm, step_all = eng._pick, eng._arm, eng._step_all

    def rec_pick(logits, draws):
        top = torch.topk(logits.float(), 2, dim=-1).values
        last["m"] = top[..., 0] - top[..., 1]
        return pick(logits, draws)

    def rec_arm(slot, req, logits):
        first = arm(slot, req, logits)
        rec.setdefault(id(req.ticket), []).append(float(last["m"][0]))
        return first

    def rec_step(stepping):
        nxt, active = step_all(stepping)
        m, act = last["m"].cpu(), active.cpu()
        for sl in stepping:
            if act[sl]:
                rec.setdefault(id(eng._slots[sl].req.ticket), []).append(
                    float(m[sl]))
        return nxt, active

    eng._pick, eng._arm, eng._step_all = rec_pick, rec_arm, rec_step
    return rec


def _diff_picks(ref_outs, outs) -> list:
    """[(request, first differing pick, or None for streams of unequal
    length that agree as far as both go)] of every stream that differs
    from its reference."""
    out = []
    for i, (a, b) in enumerate(zip(ref_outs, outs)):
        if a != b:
            out.append((i, next((k for k in range(min(len(a), len(b)))
                                 if a[k] != b[k]), None)))
    return out


def _first_differences(model, reqs, ref_outs, outs) -> list:
    """`_diff_picks` with the reference's top-2 margin at each first
    difference under `model` (the full-recompute forward)."""
    return [(i, j, None if j is None else _top2_margin(
        model, reqs[i][0] + ref_outs[i][:j]))
        for i, j in _diff_picks(ref_outs, outs)]


def _near_tie_check(diffs, n: int, phase: str = "engine") -> dict:
    """Token identity under the near-tie rule over `_first_differences`:
    identical streams pass; a stream whose first difference sits where
    the reference's top-2 margin is below NEAR_TIE passes (nothing after
    it is checked); anything else fails."""
    for i, j, margin in diffs:
        check(j is not None, f"request {i}: lengths differ")
        emit({"phase": phase, "near_tie": {"request": i, "pick": j,
                                           "margin": margin}})
        check(margin < NEAR_TIE, f"request {i} differs at pick {j} with "
              f"top-2 margin {margin} >= {NEAR_TIE}")
    return {"identical": n - len(diffs),
            "near_ties": [i for i, _j, _m in diffs]}


def _near_tie_identical(model, reqs, ref_outs, outs,
                        phase: str = "engine") -> dict:
    """`_near_tie_check` of `model`'s margins at each stream's first
    difference from its reference."""
    return _near_tie_check(_first_differences(model, reqs, ref_outs, outs),
                           len(reqs), phase)


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
        led = st["ledger"]
        check(abs(led["kv_pool_bytes"] - led["engine_kv_bytes"])
              <= 0.01 * led["engine_kv_bytes"],
              f"the kv_pool ledger bytes {led['kv_pool_bytes']} are not the "
              f"engine's {led['engine_kv_bytes']} within 1%")
        check((led["engine_step"] or {}).get("attention_flops", 0) > 0,
              f"engine_step's ledger entry has no K4 work: {led}")
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


def _post(port: int, body: dict, path: str = "/predict") -> tuple[int,
                                                                  bytes]:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request("POST", path, body=json.dumps(body).encode(),
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
        swap = _swap_from_store(runner, pred, model, reqs)
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
    out["swap"] = swap
    out["launches_c5"] = launches["by_c"].get(SPEC_K + 1, 0)
    out["seconds"] = time.perf_counter() - t0
    emit({"phase": "serve_surface", "dtype": "bfloat16",
          **{k: v for k, v in out.items() if k != "f32"}})
    del pred, runner, model, ads
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _swap_from_store(runner, pred, model, reqs) -> dict:
    """Phase entry (e), on phase serve_surface's runner (the kernel engine
    at full depth): rank-8 adapters put into a FileArtifactStore, POST
    /swap naming the store and version 2, the fetched tree bitwise the
    tree put, then 4 concurrent POSTs all answered in full with K4
    launched in that wave."""
    import tempfile

    import torch

    from fedml_tpu_torch.ops import paged_attention as pa
    from fedml_tpu_torch.utils.artifacts import (
        FileArtifactStore, adapter_name, store_spec,
    )

    ads3 = _adapters(model, seed=3)
    with tempfile.TemporaryDirectory() as d:
        store = FileArtifactStore(d)
        t0 = time.perf_counter()
        store.put(adapter_name(1), ads3)
        put_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        code, raw = _post(runner.port, {"store": store_spec(store),
                                        "name": adapter_name(1),
                                        "version": 2}, path="/swap")
        swap_ms = (time.perf_counter() - t0) * 1e3
    check(code == 200, f"/swap answered {code}: {raw[:300]!r}")
    ver = json.loads(raw)["model_version"]
    check(ver == 2 == pred.model_version, f"/swap model_version {ver}")
    served = pred.adapters
    check(set(served) == set(ads3) and all(
        torch.equal(served[n][k].cpu(), ads3[n][k].cpu())
        for n in ads3 for k in ("a", "b")),
        "the adapters /swap fetched are not bitwise the ones put")
    pa.launch_count = 0
    pa.launches_by_c.clear()
    wave = reqs[:4]
    codes, outs, wall = _http_wave(runner.port, wave)
    launches = {"all": pa.launch_count, "by_c": dict(pa.launches_by_c)}
    check(codes == [200] * len(wave), f"post-swap HTTP codes {codes}")
    check(all(len(o) == n for o, (_p, n) in zip(outs, wave)),
          "a post-swap answer is short of max_new_tokens")
    check(launches["all"] > 0, "the post-swap wave launched no K4")
    return {"put_ms": put_ms, "swap_ms": swap_ms, "model_version": ver,
            "adapter_bytes": sum(t.numel() * t.element_size()
                                 for ab in ads3.values()
                                 for t in ab.values()),
            "wave_launches": launches, "wave_wall_s": wall}


def _kernel_rows(prof) -> list:
    """(name, calls, device ms) of each kernel in a torch.profiler run,
    longest first. Only the device's own events: a host op's row (aten::mm,
    an autograd Function) carries the device time of the kernels it
    launched, which the kernels' rows already hold, and a recorder span's
    `record_function` range is an annotation over them, not a kernel."""
    from torch.autograd import DeviceType

    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
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
        bounds = {name: _bound(*_cost().flash_cost(name, bh, t, d,
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
        "bounds": {n: _bound(*_cost().flash_cost(n, bh, t, d,
                                                 q.element_size()), dt, bw)
                   for n in ("fwd", "dq", "dkv")}}
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
    from fedml_tpu_torch.utils import xla_ledger

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
    # the cost ledger's captures on for this phase, as a tracked run has
    # them: each round_fn's first call is captured
    prev_capture = xla_ledger.set_capture(True)
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
    # the cost ledger's round_fn entry (captured in round 0): matmul FLOPs
    # plus K1-K3's work by ops/cost.py, its K1-K3 share, and the
    # utilization over the steady round's measured wall
    entry = xla_ledger.programs()["round_fn"]
    steady = rounds[-1]["wall_s"]
    peak = _cost().peak_flops(torch.bfloat16)
    ledger = {"round_fn": entry,
              "k1_k3_share": entry["attention_flops"] / entry["flops"],
              "measured_mfu": entry["flops"] / steady / peak,
              "capture_over_steady_round_s": entry["capture_s"] - steady,
              "peak_tflops": peak / 1e12, "nvidia_smi": nvidia_smi_line()}
    res = {"init_s": init_s, "rounds": rounds, "launches": launches,
           "steps": steps, "ledger": ledger,
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
    # the K1-K3 work a round: two forwards (the remat recomputes it), dQ
    # and dK/dV a layer and step, at BH = TRAIN_BS x heads
    bh, dh = TRAIN_BS * dims.n_heads, dims.d_model // dims.n_heads
    want_att = L * steps_per_round * sum(
        k * _cost().flash_cost(n, bh, TRAIN_T, dh, 2)[1]
        for n, k in (("fwd", 2), ("dq", 1), ("dkv", 1)))
    check(entry["attention_flops"] == want_att
          and 0 < ledger["k1_k3_share"] < 1,
          f"the ledger's K1-K3 FLOPs {entry['attention_flops']} != "
          f"{want_att} (share {ledger['k1_k3_share']})")
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
    counted = {}
    adapters = None
    fa.launch_count.update(dict.fromkeys(fa.launch_count, 0))
    for flash in (True, False):
        alg, drawn, round_fn = _fed_lora(pdims, state, t32, flash)
        adapters = adapters or drawn     # both rounds start from these
        o = round_fn(alg.server_init(adapters), None, data, ids, weights,
                     seed=7, batch_idx=sched)
        after[flash] = (o.server_state.params,
                        o.metrics["train_loss"].item())
        counted[flash] = xla_ledger.programs()["round_fn"]
    xla_ledger.set_capture(prev_capture)
    update = _max_abs_diff(after[True][0], adapters)
    diff = _max_abs_diff(after[True][0], after[False][0])
    parity = {"layers": parity_layers, "max_abs_adapter_diff": diff,
              "max_abs_adapter_update": update, "ratio": diff / update,
              "tol": PARITY_TOL, "loss_flash": after[True][1],
              "loss_dense": after[False][1],
              "launches": dict(fa.launch_count),
              "ledger_flops": {"flash": counted[True]["flops"],
                               "dense": counted[False]["flops"]},
              "ledger_attention_flops": counted[True]["attention_flops"]}
    emit({"phase": "train", "f32_flash_vs_dense": parity})
    check(update > 0 and diff <= PARITY_TOL * update,
          f"f32 flash vs dense round: adapter diff {diff} > {PARITY_TOL} x "
          f"update {update}")
    # one count of attention: the dense path's FLOPs are the kernels'
    check(counted[True]["flops"] == counted[False]["flops"]
          and counted[True]["attention_flops"]
          == counted[False]["attention_flops"] > 0,
          f"the ledger counts the flash and dense rounds apart: {counted}")
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
def _flagship_dict(**train) -> dict:
    """The flagship config as a dict (`train` overrides train_args keys;
    an "extra" dict goes to train_args.extra), its data cache a directory
    of the checkout that holds no data, so the loader takes the synthetic
    CIFAR-10 path."""
    import copy
    import os

    d = copy.deepcopy(FEDAVG_CONFIG)
    d["train_args"].update(train)
    d["data_args"]["data_cache_dir"] = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "chiprun_out", "no_data")
    d["data_args"]["synthetic_samples_per_client"] = FEDAVG_SAMPLES
    return d


def _fedavg_cfg(device: str, **train):
    """The flagship config (`_flagship_dict`) through
    `fedml_tpu_torch.init`."""
    import fedml_tpu_torch

    return fedml_tpu_torch.init(config=_flagship_dict(**train),
                                device=device)


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


def _parity_round(ds, dev: str, dt) -> tuple:
    """One FedAvg round of the flagship's first FEDAVG_CPU_CLIENTS clients
    at full ResNet-18-GN width on `dev` in `dt`, from one init_params draw
    and one batch schedule: (its parameters as f64 on the CPU, its loss,
    its seconds)."""
    import torch

    from fedml_tpu_torch.algorithms.builtin import build_algorithm
    from fedml_tpu_torch.config import TrainArgs
    from fedml_tpu_torch.core.algorithm import make_batch_indices
    from fedml_tpu_torch.models import hub
    from fedml_tpu_torch.parallel.round import (
        build_round_fn, client_generator,
    )

    n = FEDAVG_CPU_CLIENTS
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
    t0 = time.perf_counter()
    alg = build_algorithm("FedAvg", hub.apply_fn(model), t)
    data = {"x": torch.from_numpy(ds.x_train[:n]).to(dev, dt),
            "y": torch.from_numpy(ds.y_train[:n]).to(dev),
            "mask": torch.from_numpy(ds.mask_train[:n]).to(dev, dt)}
    o = build_round_fn(alg, health_stats=True)(
        alg.server_init({k: v.to(dev, dt) for k, v in params0.items()}),
        None, data, ids, weights, seed=0, batch_idx=sched)
    return ({k: v.cpu().double() for k, v in o.server_state.params.items()},
            o.metrics["train_loss"].item(), time.perf_counter() - t0)


def fedavg_cpu_rounds(path: str) -> None:
    """Phase fedavg's two CPU rounds (f64, then f32) into `path`. The
    second lane runs this in a child process beside its phases before
    fedavg (niced,
    CPU_PARITY_THREADS threads, no card visible): inline they read 76 s of
    the host at 4 clients."""
    import os

    import torch

    from fedml_tpu_torch.data import loader

    os.nice(10)
    torch.set_num_threads(CPU_PARITY_THREADS)
    ds = loader.load(_fedavg_cfg("cpu"))
    t0 = time.perf_counter()
    out = {name: _parity_round(ds, "cpu", dt) for name, dt in (
        ("cpu_f64", torch.float64), ("cpu", torch.float32))}
    out["wall_s"] = time.perf_counter() - t0
    torch.save(out, path)


def start_cpu_rounds() -> tuple:
    """Start `fedavg_cpu_rounds` in a child process: (the process, the
    file it writes). The child is killed when this process exits."""
    import atexit
    import os
    import tempfile

    fd, path = tempfile.mkstemp(prefix="fedavg-cpu-", suffix=".pt")
    os.close(fd)
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "chip_smoke.fedavg_cpu_rounds(sys.argv[1])", path],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    atexit.register(proc.kill)
    atexit.register(lambda: os.path.exists(path) and os.remove(path))
    return proc, path


def _fedavg_parity(ds, cpu_rounds=None) -> dict:
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
    so the round reads the same in every call. `cpu_rounds`, the child
    process `start_cpu_rounds` started, holds the CPU's rounds (started
    here when None)."""
    import os

    import torch

    from fedml_tpu_torch._device import deterministic_cuda

    proc, path = cpu_rounds or start_cpu_rounds()
    deterministic_cuda(torch.device(DEV))
    with _tf32_off():
        out = {"card": _parity_round(ds, DEV, torch.float32)}
    t0 = time.perf_counter()
    try:
        _so, se = proc.communicate(timeout=1200)
    finally:
        proc.kill()
    waited_s = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"the CPU rounds' child process failed: {se[-2000:]}")
    cpu = torch.load(path)
    os.remove(path)
    out.update(cpu_f64=cpu["cpu_f64"], cpu=cpu["cpu"])
    params0 = _parity_params()

    def dist(a, b):
        return max((out[a][0][k] - out[b][0][k]).abs().max().item()
                   for k in params0)

    update = max((out["cpu"][0][k] - params0[k].double()).abs().max().item()
                 for k in params0)
    diff, e_cpu, e_card = dist("card", "cpu"), dist("cpu", "cpu_f64"), \
        dist("card", "cpu_f64")
    steps = ds.shard_size // FEDAVG_CONFIG["train_args"]["batch_size"]
    res = {"clients": FEDAVG_CPU_CLIENTS,
           "local_steps": FEDAVG_CPU_CLIENTS * steps,
           "max_abs_update": update, "max_abs_param_diff": diff,
           "ratio": diff / update, "tol": PARITY_TOL,
           "cpu_f32_vs_f64_ratio": e_cpu / update,
           "card_f32_vs_f64_ratio": e_card / update,
           "losses": {k: v[1] for k, v in out.items()},
           "seconds": {k: v[2] for k, v in out.items()},
           "cpu_child_wall_s": cpu["wall_s"], "cpu_child_waited_s": waited_s}
    emit({"phase": "fedavg", "f32_card_vs_cpu": res})
    check(update > 0 and (diff <= PARITY_TOL * update
                          or e_card <= 2 * e_cpu),
          f"f32 FedAvg round on the card vs the CPU: param diff {diff} > "
          f"{PARITY_TOL} x update {update}, and the card's distance to the "
          f"f64 round {e_card} > 2 x the CPU f32 round's {e_cpu}")
    return res


def phase_fedavg(cpu_rounds=None) -> dict:
    """Phase 9 (module docstring). `cpu_rounds`: `start_cpu_rounds`'s
    child, started when the second lane began."""
    import torch

    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.ops import flash_attention as fa
    from fedml_tpu_torch.ops import paged_attention as pa
    from fedml_tpu_torch.simulation.simulator import Simulator
    from fedml_tpu_torch.utils import metrics as mx
    from fedml_tpu_torch.utils import xla_ledger

    t0 = time.perf_counter()
    cfg = _fedavg_cfg(DEV)
    ds = loader.load(cfg)
    check(ds.synthetic, "the flagship data is not the synthetic CIFAR-10")
    data_s = time.perf_counter() - t0

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
    # the cost ledger's captures on for the timed rounds, as a tracked run
    # has them: the warm round is round_fn's first call, the one captured
    prev_capture = xla_ledger.set_capture(True)
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
    # the cost ledger's round_fn entry, captured in the warm round (this
    # Simulator's first call); the parity rounds run uncaptured
    xla_ledger.set_capture(prev_capture)
    ledger = xla_ledger.programs()["round_fn"]
    calls = int(mx.snapshot()["counters"].get("xla.program.calls.round_fn",
                                              0))
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
        "bf16_peak_share": flops / (med / 1e3)
        / _cost().peak_flops(torch.bfloat16),
        "test_acc": ev["test_acc"], "test_loss": ev["test_loss"],
        "k1_k4_launches": launches,
    }
    # the ledger beside analytic_flops of one local step x the round's
    # steps (every step of the padded shards runs), and the utilization
    # the ledger's FLOPs give over the timed rounds' measured wall
    step_flops = _step_flops(image=ds.x_train.shape[2:])
    res["ledger"] = {
        "round_fn": ledger, "calls": calls,
        "analytic_step_flops": step_flops,
        "analytic_round_flops": step_flops * steps,
        "rel_to_analytic": ledger["flops"] / (step_flops * steps) - 1,
        "capture_over_timed_round_s": ledger["capture_s"] - med / 1e3,
        "measured_mfu": ledger["flops"] / (med / 1e3)
        / _cost().peak_flops(torch.bfloat16),
        "peak_tflops": _cost().peak_flops(torch.bfloat16) / 1e12,
        "nvidia_smi": nvidia_smi_line()}
    emit({"phase": "fedavg", **res})
    losses = [r["train_loss"] for r in rows]
    check(all(np.isfinite(losses)), "a FedAvg round's loss is not finite")
    check(losses[-1] < losses[0], f"train_loss did not fall: {losses}")
    check(not any(launches.values()),
          f"the FedAvg path launched a flash or paged kernel: {launches}")
    check(abs(res["ledger"]["rel_to_analytic"]) <= 0.01
          and ledger["attention_flops"] == 0,
          f"the ledger's round FLOPs {ledger['flops']} are not analytic_flops"
          f" x steps {step_flops * steps} within 1%")
    del sim
    gc.collect()
    torch.cuda.empty_cache()
    # after the rounds: the CPU's child has had their time to finish
    res["f32_card_vs_cpu"] = _fedavg_parity(ds, cpu_rounds)
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


def _timed_rounds(sim, first: int, n: int) -> list:
    """`n` synchronised rounds from round `first`: ms each and the loss."""
    import torch

    rows = []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = sim.run_round(first + i)
        torch.cuda.synchronize()
        rows.append({"round": first + i,
                     "ms": (time.perf_counter() - t0) * 1e3,
                     "train_loss": m["train_loss"]})
    return rows


def _flagship_groups(ds, fedavg=None) -> dict:
    """The flagship at G = 1 (a warm round and one timed, the determinism
    setting on; when phase fedavg ran in this process, `fedavg`, its timed
    round of the same G = 1 configuration stands for this one, which
    phase tasks' room cut) and at G = 10 (a warm round, then
    FEDSIM_ROUNDS timed): ms a round, rounds/s, ms a group step, peak
    memory, the losses. (The profiled rounds of two groups went when
    phase cross_silo_secure joined the script: PERF.md keeps their
    readings, and `--only fedavg_profile` profiles the flagship round.)"""
    import torch

    from fedml_tpu_torch.parallel.round import group_width
    from fedml_tpu_torch.simulation.simulator import Simulator

    steps = ds.shard_size // FEDAVG_CONFIG["train_args"]["batch_size"]
    res = {}
    if fedavg is not None:
        med = fedavg["ms_per_round_median"]
        res[1] = {"group_size": 1, "groups_per_round": ds.num_clients,
                  "rounds": fedavg["rounds"], "ms_per_round_median": med,
                  "rounds_per_s": 1e3 / med,
                  "ms_per_group_step": med / (ds.num_clients * steps),
                  "ms_per_client_step": med / (ds.num_clients * steps),
                  "max_memory_allocated_bytes":
                      fedavg["max_memory_allocated_bytes"],
                  "from_phase": "fedavg", "seconds": 0.0}
        emit({"phase": "fedsim", "flagship": res[1]})
    for g in ((1,) if fedavg is None else ()) + FEDSIM_GROUPS:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        sim = Simulator(_fedavg_cfg(
            DEV, extra={"clients_per_device_parallel": g}), ds)
        gw = group_width(ds.num_clients, g)
        warm = _timed_rounds(sim, 0, 1)
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
                  "max_memory_allocated_bytes": peak,
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


def phase_fedsim(fedavg=None) -> dict:
    """Phase 10 (module docstring). `fedavg`, phase fedavg's results when
    it ran in this process: its timed G = 1 round stands for the
    flagship's G = 1 here."""
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
    # (started first: it spends seconds importing torch beside the rounds
    # here)
    child = subprocess.Popen(
        [sys.executable, "-c",
         "import chip_smoke; print(chip_smoke.f32_round_digest())"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        here = [f32_round_digest(), f32_round_digest()]
        g4 = [f32_round_digest(4), f32_round_digest(4)]
        so, se = child.communicate(timeout=600)
    finally:
        child.kill()
    check(child.returncode == 0,
          f"the digest's child process failed: {se[-2000:]}")
    there = so.strip().splitlines()[-1]
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
            ("flagship", lambda: _flagship_groups(ds, fedavg)),
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
        warm = int(name == "plain")
        rows = []
        for r in range(warm + PLUGIN_ROUNDS[name]):
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
        timed = rows[warm:]
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
    """(a): the flagship's first CS_FLAGSHIP_SILOS silos, a warm round and
    CS_ROUNDS timed."""
    import torch

    from fedml_tpu_torch.utils.events import recorder

    silos = [(ds.x_train[i][:int(ds.counts[i])],
              ds.y_train[i][:int(ds.counts[i])])
             for i in range(min(CS_FLAGSHIP_SILOS, ds.num_clients))]
    cfg = _cs_cfg(DEV, "cs-flagship", 1 + CS_ROUNDS,
                  client_num_in_total=len(silos),
                  client_num_per_round=len(silos))
    recorder.spans.clear()
    dropped0 = sum(recorder.dropped.values())
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
    evicted = sum(recorder.dropped.values()) - dropped0
    check(evicted == 0,
          f"the span ring evicted {evicted} of the run's {len(spans)} spans")
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
    # trace headers on the wire: each round's broadcast (the server's
    # model sends inside its round span) and the silos' handle spans of
    # it, stitched by the `_trace_id` / `_parent_span` headers
    stitched = []
    for rs in rounds:
        sends = {s.span_id: s for s in spans
                 if s.name in ("comm.send.s2c_init_config",
                               "comm.send.s2c_sync_model")
                 and rs.start <= s.start < rs.end}
        stitched.append(sum(
            1 for s in spans if s.name.startswith("comm.handle.s2c_")
            and s.parent_id in sends
            and s.trace_id == sends[s.parent_id].trace_id
            and s.meta.get("receiver") == sends[s.parent_id].meta.get(
                "receiver")))
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
           "stitched_broadcast_chains": stitched,
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
    check(stitched == [len(silos)] * len(rounds),
          f"stitched broadcast chains a round {stitched}, not one for each "
          f"of the {len(silos)} silos")
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
    # per client: the federation's silos against the Simulator's 100
    emit({"phase": "cross_silo", "simulator_g1_round":
          res["simulator_g1_round"], "cross_silo_vs_simulator_per_client":
          (res["flagship"]["ms_per_round_median"] / res["flagship"]["silos"])
          / (res["simulator_g1_round"]["ms"] / ds.num_clients),
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
    dropped0 = sum(recorder.dropped.values())
    out = run(*a, **kw)
    spans = list(recorder.spans)
    evicted = sum(recorder.dropped.values()) - dropped0
    check(evicted == 0,
          f"the span ring evicted {evicted} of the run's {len(spans)} spans")
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


def _codec_flagship(ds, rounds: int, dense_ms_per_silo=None) -> dict:
    """(c): the flagship's first CODEC_SILOS silos with CODEC on the
    uploads, `rounds` rounds (the last one timed); `dense_ms_per_silo`,
    phase cross_silo's dense round a silo, is set beside it."""
    import torch

    from fedml_tpu_torch.utils import metrics as mx

    silos = [(ds.x_train[i][:int(ds.counts[i])],
              ds.y_train[i][:int(ds.counts[i])])
             for i in range(min(CODEC_SILOS, ds.num_clients))]
    cfg = _cs_cfg(DEV, "codec-flagship", rounds,
                  client_num_in_total=len(silos),
                  client_num_per_round=len(silos),
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
           "ms_per_silo": rows[-1]["ms"] / len(silos),
           "dense_ms_per_silo": dense_ms_per_silo}
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
    flagship result when that phase ran in this call (in the second
    lane, which hands it on), gives the dense round's ms beside the
    codec's; (a) and (c) then time one round with no warm round before
    it (phase entry has run the flagship's rounds in this process).
    `loopback_params`, its 4-silo card federation's params, stand for
    (d)'s loopback run (the same program)."""
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
                else cs_flagship["ms_per_round_median"]
                / cs_flagship["silos"])),
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


# ----------------------------------------------------------------- phase 14
def _http_metrics(port: int) -> dict:
    """One scrape of a /metrics endpoint, parsed."""
    import http.client

    from fedml_tpu_torch.utils.prometheus import parse_prometheus

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", "/metrics")
    resp = conn.getresponse()
    body = resp.read().decode()
    conn.close()
    check(resp.status == 200, f"/metrics answered {resp.status}")
    return parse_prometheus(body)


def _profiled(fn) -> dict:
    """Wall ms, device-busy ms, idle share and kernel launches of one call
    of `fn` under torch.profiler (the device's kernel rows only)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = sum(r[2] for r in _kernel_rows(prof))
    launches = sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and not e.key.startswith(("Memcpy", "Memset")))
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms,
            "launches": launches}


def _step_launches(fn, steps: int) -> float:
    """Kernel launches per step of `fn()` (which runs `steps` steps), from
    torch.profiler's device rows."""
    return _profiled(fn)["launches"] / steps


def _small_pool(ds, clients: int, rows: int):
    """The flagship dataset cut to the first `rows` rows of its first
    `clients` clients."""
    return dataclasses.replace(
        ds, x_train=ds.x_train[:clients, :rows],
        y_train=ds.y_train[:clients, :rows],
        mask_train=ds.mask_train[:clients, :rows],
        counts=np.minimum(ds.counts[:clients], rows))


def _centralized(ds, fedsim_g1=None) -> dict:
    """(a): the centralized baseline through FedMLRunner at the flagship
    (the 9600 pooled rows, 300 steps an epoch), a warm epoch and a timed
    one, /metrics scraped once; then the f32 bar on ST_BAR_ROWS rows,
    card against CPU."""
    import torch

    from fedml_tpu_torch.runner import FedMLRunner
    from fedml_tpu_torch.utils import prometheus as prom

    cfg = _fedavg_cfg(DEV)
    cfg.common_args.training_type = "centralized"
    cfg.common_args.extra["metrics_port"] = 0
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runner = FedMLRunner(cfg, dataset=ds)
    tr = runner.runner
    rows = tr.pooled["y"].shape[0]
    steps = rows // cfg.train_args.batch_size
    warm = runner.run(epochs=1)           # the entry point: epoch + eval
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    lsum, _correct, cnt = tr._epoch(1)
    loss = float(lsum) / float(cnt)       # synchronises
    epoch_ms = (time.perf_counter() - t1) * 1e3
    peak = torch.cuda.max_memory_allocated()
    launches = _step_launches(
        lambda: tr._epoch(2, tr._schedule(2)[:3]), 3)
    scrape = _http_metrics(tr.metrics_exporter.port)
    res = {"pooled_rows": rows, "steps_per_epoch": steps,
           "warm_epoch_and_eval_s": warm_s, "epoch_ms": epoch_ms,
           "ms_per_step": epoch_ms / steps, "launches_per_step": launches,
           "max_memory_allocated_bytes": peak,
           "losses": [warm[0]["train_loss"], loss],
           "test_acc": warm[0]["test_acc"],
           "fed_epoch_gauge": scrape["gauges"].get("fed_epoch")}
    if fedsim_g1 is not None:
        g1_steps = ds.num_clients * (ds.shard_size
                                     // cfg.train_args.batch_size)
        res["fedsim_g1_round_ms"] = fedsim_g1["ms_per_round_median"]
        res["fedsim_g1_local_steps"] = g1_steps
        res["epoch_over_g1_round"] = epoch_ms / res["fedsim_g1_round_ms"]
        res["step_over_g1_step"] = (res["ms_per_step"] * g1_steps
                                    / res["fedsim_g1_round_ms"])
    prom._exporter.stop()
    prom._exporter = None
    del runner, tr
    gc.collect()
    torch.cuda.empty_cache()

    # the bar: 2 f32 epochs of one batch each (with momentum, so the
    # second step reads the optimizer state the first epoch left) on the
    # card and on the CPU from one parameter draw; the batch orders come
    # from the same CPU generators
    from fedml_tpu_torch.centralized import CentralizedTrainer

    small = _small_pool(ds, 1, ST_BAR_ROWS)
    init = _parity_params()
    out = {}
    with _tf32_off():
        for dev in (DEV, "cpu"):
            c = _fedavg_cfg(dev, compute_dtype="float32",
                            momentum=ST_BAR_MOMENTUM)
            t = CentralizedTrainer(c, small, device=dev, params=init)
            t.run(epochs=2)
            out[dev] = {k: v.float().cpu() for k, v in t.params.items()}
    upd = max(float((out["cpu"][k] - init[k]).abs().max()) for k in init)
    err = max(float((out[DEV][k] - out["cpu"][k]).abs().max())
              for k in init)
    res["f32_card_vs_cpu"] = {"rows": ST_BAR_ROWS, "epochs": 2,
                              "momentum": ST_BAR_MOMENTUM,
                              "max_abs_err": err, "max_update": upd,
                              "rel": err / upd}
    emit({"phase": "standalone", "a_centralized": res,
          "nvidia_smi": nvidia_smi_line()})
    check(all(np.isfinite(res["losses"])), "a centralized loss is not finite")
    check(res["fed_epoch_gauge"] is not None,
          "the fed_epoch gauge is not on /metrics")
    check(err <= PARITY_TOL * upd, f"the centralized f32 run is "
          f"{err / upd:.3g} of its update from the CPU's (bar {PARITY_TOL})")
    return res


def _contribution(ds) -> dict:
    """(b): ST_CONTRIB_M flagship clients trained one local epoch from one
    global model; LOO and GTG over them, MR over the first ST_MR_M, each
    subset's utility the negative mean cross-entropy on ST_TEST_ROWS test
    images in f32 (TF32 off); then ST_SINGLE_CHECKS subsets one at a
    time against the batched values."""
    import torch

    from fedml_tpu_torch import contribution as ca
    from fedml_tpu_torch.core.algorithm import (
        local_sgd, make_batch_indices, make_client_optimizer,
        masked_softmax_ce,
    )
    from fedml_tpu_torch.models import hub
    from fedml_tpu_torch.ops import keys

    m = ST_CONTRIB_M
    model = hub.create("resnet18_gn", 10, (32, 32, 3), device="meta")
    g0 = {k: v.to(DEV) for k, v in _parity_params().items()}
    train_fn = hub.apply_fn(model, "bfloat16")
    opt = make_client_optimizer("sgd", FEDAVG_CONFIG["train_args"][
        "learning_rate"])
    bs = FEDAVG_CONFIG["train_args"]["batch_size"]
    clients, counts = [], []
    for i in range(m):
        n = int(ds.counts[i])
        shard = {"x": torch.from_numpy(ds.x_train[i][:n]).to(DEV),
                 "y": torch.from_numpy(
                     ds.y_train[i][:n].astype(np.int64)).to(DEV),
                 "mask": torch.ones(n, device=DEV)}
        idx = make_batch_indices(keys.generator((0, i)), n, bs, 1).to(DEV)
        p, _m, _s = local_sgd(train_fn, g0, shard, idx, opt)
        clients.append(p)
        counts.append(float(n))
    stacked = {k: torch.stack([c[k] for c in clients]) for k in g0}
    weights = torch.tensor(counts, device=DEV)
    del clients
    f32 = hub.apply_fn(model)
    # an NHWC view of NCHW storage: the model's NCHW permute is then
    # contiguous, as group_norm needs under vmap (it cannot query
    # channels-last contiguity of a tensor the vmap does not batch)
    tx = torch.from_numpy(ds.x_test[:ST_TEST_ROWS]).to(DEV).permute(
        0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    ty = torch.from_numpy(ds.y_test[:ST_TEST_ROWS].astype(np.int64)).to(DEV)
    tm = torch.ones(ST_TEST_ROWS, device=DEV)

    def utility(p):
        return -masked_softmax_ce(f32(p, tx), ty, tm)[0]

    res = {"clients": m, "mr_clients": ST_MR_M, "chunk": ST_CHUNK,
           "test_rows": ST_TEST_ROWS}
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    with _tf32_off(), torch.no_grad():
        u0 = float(utility(g0))
        ids = list(range(m))
        t0 = time.perf_counter()
        loo = ca.leave_one_out(stacked, weights, ids, utility, ST_CHUNK)
        res["loo_s"] = time.perf_counter() - t0
        full = float(ca.batched_subset_utilities(
            stacked, weights, np.ones((1, m), np.float32), utility)[0])
        gtg = ca.GTGShapley(seed=0, chunk=ST_CHUNK)
        t0 = time.perf_counter()
        sv = gtg.run(stacked, weights, ids, utility, u0, full)
        res["gtg_s"] = time.perf_counter() - t0
        sub = {k: v[:ST_MR_M] for k, v in stacked.items()}
        t0 = time.perf_counter()
        mr = ca.mr_shapley(sub, weights[:ST_MR_M], list(range(ST_MR_M)),
                           utility, baseline_utility=u0, chunk=ST_CHUNK)
        res["mr_s"] = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        # the bar: sampled subsets one at a time against one batch
        rs = np.random.RandomState(0)
        masks = rs.randint(0, 2, (ST_SINGLE_CHECKS, m)).astype(np.float32)
        masks[:, 0] = 1.0
        batched = ca.batched_subset_utilities(stacked, weights, masks,
                                              utility, ST_CHUNK)
        single = np.array([ca.batched_subset_utilities(
            stacked, weights, masks[i:i + 1], utility, 1)[0]
            for i in range(ST_SINGLE_CHECKS)])
    timed_s = res["loo_s"] + res["gtg_s"] + res["mr_s"]
    counted_rows = (m + 1) + gtg.evaluated + 2 ** ST_MR_M - 1
    res.update(u_global=u0, u_all=full, loo=loo, gtg=sv, mr=mr,
               gtg_permutations=gtg.permutations,
               gtg_subsets=gtg.evaluated,
               subsets_evaluated=counted_rows,
               subsets_per_s=counted_rows / timed_s,
               max_memory_allocated_bytes=peak,
               single_vs_batched_max_abs=float(np.abs(single
                                                      - batched).max()))
    emit({"phase": "standalone", "b_contribution": res,
          "nvidia_smi": nvidia_smi_line()})
    check(all(np.isfinite(list(loo.values()) + list(sv.values())
                          + list(mr.values()))),
          "a contribution value is not finite")
    check(res["single_vs_batched_max_abs"] <= ST_SUBSET_TOL,
          f"subsets one at a time differ from the batch by "
          f"{res['single_vs_batched_max_abs']} (bar {ST_SUBSET_TOL})")
    del stacked, sub
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _inversion(ds) -> dict:
    """(c): one 32x32x3 image through ResNet-18-GN in f32 and its true
    gradient; dlg_attack and invert_gradient_attack, ST_INVERT_STEPS steps
    each; then DLG's first ST_INVERT_CHECK steps on the card against the
    CPU (TF32 off) from one start."""
    import torch

    from fedml_tpu_torch.models import hub
    from fedml_tpu_torch.security import attacks as atk

    model = hub.create("resnet18_gn", 10, (32, 32, 3), device="meta")
    fn = hub.apply_fn(model)
    label = int(ds.y_test[0])
    x_true = torch.from_numpy(ds.x_test[:1])
    init = _parity_params()

    def true_grads(dev):
        p = {k: v.to(dev) for k, v in init.items()}
        g = torch.func.grad(lambda pp: -torch.log_softmax(
            fn(pp, x_true.to(dev)), -1)[0, label])(p)
        return p, g

    res = {"label": label}
    with _tf32_off():
        p, g = true_grads(DEV)
        for name, attack, kw in (
                ("dlg", atk.dlg_attack, {"lr": 0.1}),
                ("invert_gradient", atk.invert_gradient_attack,
                 {"lr": 0.05, "tv_weight": 1e-3})):
            gen = torch.Generator(device=DEV).manual_seed(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x, y, losses = attack(fn, p, g, (32, 32, 3), 10, generator=gen,
                                  steps=ST_INVERT_STEPS, **kw)
            losses = losses.cpu()
            ms = (time.perf_counter() - t0) * 1e3
            res[name] = {"ms_per_step": ms / ST_INVERT_STEPS,
                         "loss_step_1": float(losses[0]),
                         "loss_step_last": float(losses[-1]),
                         "label_recovered": int(y.argmax()) == label,
                         "mse_to_true": float(((x.cpu() - x_true) ** 2)
                                              .mean())}
        # card against CPU from one start: one step (gated) and
        # ST_INVERT_CHECK steps (printed)
        x0 = torch.randn((1, 32, 32, 3),
                         generator=torch.Generator().manual_seed(2))
        runs = {}
        for dev in (DEV, "cpu"):
            pd, gd = true_grads(dev)
            runs[dev] = [atk.dlg_attack(fn, pd, gd, (32, 32, 3), 10,
                                        x0=x0.to(dev), steps=n, lr=0.1)
                         for n in (1, ST_INVERT_CHECK)]
            runs[dev] = [(x.cpu(), losses.cpu()) for x, _y, losses
                         in runs[dev]]

    def compare(i):
        diff = (runs[DEV][i][0] - runs["cpu"][i][0]).abs()
        rel = ((runs[DEV][i][1] - runs["cpu"][i][1]).abs()
               / runs["cpu"][i][1].abs()).tolist()
        return {"share_within_x_tol": float((diff <= ST_INVERT_X_TOL)
                                            .float().mean()),
                "max_abs_x": float(diff.max()), "rel_loss_by_step": rel}

    res["card_vs_cpu"] = {"one_step": compare(0),
                          f"{ST_INVERT_CHECK}_steps": compare(1)}
    agree = res["card_vs_cpu"]["one_step"]["share_within_x_tol"]
    rel = res["card_vs_cpu"]["one_step"]["rel_loss_by_step"]
    emit({"phase": "standalone", "c_inversion": res,
          "nvidia_smi": nvidia_smi_line()})
    for name in ("dlg", "invert_gradient"):
        r = res[name]
        check(r["label_recovered"], f"{name}: iDLG did not recover the label")
        check(r["loss_step_last"] < r["loss_step_1"],
              f"{name}: the match loss did not fall: {r}")
    check(agree >= ST_INVERT_SHARE and rel[0] <= ST_INVERT_LOSS_TOL,
          f"DLG on the card departs from the CPU's: {res['card_vs_cpu']}")
    return res


def _step_flops(g: int = 1, image=(32, 32, 3)) -> float:
    """The port's analytic_flops of one flagship local step (B 32, bf16,
    `image` inputs), or of one vmapped group step of `g` clients,
    executed on the card."""
    import torch

    from fedml_tpu_torch.core.algorithm import masked_softmax_ce
    from fedml_tpu_torch.models import hub
    from fedml_tpu_torch.utils.flops import analytic_flops

    bs = FEDAVG_CONFIG["train_args"]["batch_size"]
    model = hub.create("resnet18_gn", 10, tuple(image), device="meta")
    fn = hub.apply_fn(model, "bfloat16")
    p = {k: v.to(DEV) for k, v in _parity_params().items()}
    x = torch.randn(bs, *image, device=DEV)
    y = torch.randint(0, 10, (bs,), device=DEV)
    mk = torch.ones(bs, device=DEV)

    def loss(pp, xx, yy, mm):
        return masked_softmax_ce(fn(pp, xx), yy, mm)[0]

    grad = torch.func.grad(loss)
    if g == 1:
        return analytic_flops(grad, p, x, y, mk)
    stk = lambda t: t.expand((g,) + t.shape).clone()  # noqa: E731
    return analytic_flops(torch.func.vmap(grad), {k: stk(v) for k, v
                                                  in p.items()},
                          stk(x), stk(y), stk(mk))


def _round_flops(ds, fedsim_g10=None) -> dict:
    """(d): the port's analytic_flops of one flagship local step (B 32,
    bf16) and one G = 10 group step, executed on the card; TFLOP a round
    (100 clients x 7 steps: every step over the shards padded to 224
    runs); with phase fedsim's G = 10 round, its achieved TFLOP/s and
    share of the bf16 peak."""
    from fedml_tpu_torch.utils.flops import spec_peak_tflops

    bs = FEDAVG_CONFIG["train_args"]["batch_size"]
    step = _step_flops()
    g = 10
    group = _step_flops(g)
    steps = ds.num_clients * (ds.shard_size // bs)
    res = {"step_flops": step, "group_step_flops_g10": group,
           "group_over_10_steps": group / (10 * step),
           "local_steps_per_round": steps,
           "tflop_per_round": step * steps / 1e12,
           "spec_peak_tflops": spec_peak_tflops()}
    if fedsim_g10 is not None:
        ms = fedsim_g10["ms_per_round_median"]
        res["fedsim_g10_round_ms"] = ms
        res["achieved_tflops_g10"] = step * steps / (ms / 1e3) / 1e12
        res["share_of_peak"] = res["achieved_tflops_g10"] / (
            res["spec_peak_tflops"] or 989.0)
    emit({"phase": "standalone", "d_flops": res,
          "nvidia_smi": nvidia_smi_line()})
    return res


class _Kept:
    """An edge trainer that keeps what it returned."""

    def __init__(self, inner):
        self.inner, self.n_samples = inner, inner.n_samples
        self.out = None
        self.ms = None

    def train(self, params, round_idx):
        t0 = time.perf_counter()
        self.out = self.inner.train(params, round_idx)
        self.ms = (time.perf_counter() - t0) * 1e3
        return self.out


def _native_edges(ds) -> dict:
    """(e): ST_EDGES NativeCNNTrainer devices of ST_EDGE_ROWS flagship
    rows each (32x32x3; conv 32, conv 64, dense 128) in one cross-device
    round through CrossDeviceServer on the card; the aggregate against
    the weighted mean of the returned vectors."""
    import torch

    from fedml_tpu_torch import native
    from fedml_tpu_torch.comm import (
        FedCommManager, LoopbackTransport, release_router,
    )
    from fedml_tpu_torch.cross_device import CrossDeviceServer, EdgeClient
    from fedml_tpu_torch.models import hub
    from fedml_tpu_torch.ops.tree import tree_weighted_mean

    built = native.lib_path("edge_trainer").exists()
    keep = ds.mask_train.reshape(-1) > 0
    xs = ds.x_train.reshape((-1, 32, 32, 3))[keep]
    ys = ds.y_train.reshape(-1)[keep]
    init = {k: v.numpy() for k, v in hub.init_params(
        hub.create("cnn", 10, (32, 32, 3), device="meta"),
        torch.Generator().manual_seed(0)).items()}
    t0 = time.perf_counter()      # the first trainer builds the library
    trainers = [_Kept(native.NativeCNNTrainer(
        xs[i * ST_EDGE_ROWS:(i + 1) * ST_EDGE_ROWS],
        ys[i * ST_EDGE_ROWS:(i + 1) * ST_EDGE_ROWS], 10,
        lr=ST_EDGE_LR, batch_size=FEDAVG_CONFIG["train_args"]["batch_size"],
        seed=i + 1))
        for i in range(ST_EDGES)]
    build_s = time.perf_counter() - t0
    run = "st-edges"
    srv = CrossDeviceServer(FedCommManager(LoopbackTransport(0, run), 0),
                            init_params=init, num_rounds=1,
                            devices_per_round=ST_EDGES,
                            min_devices=ST_EDGES, round_timeout=120.0,
                            device=DEV)
    edges = [EdgeClient(FedCommManager(LoopbackTransport(d, run), d), d,
                        trainers[d - 1]) for d in range(1, ST_EDGES + 1)]
    t0 = time.perf_counter()
    try:
        srv.run(background=True)
        for e in edges:
            e.run(background=True)
        for e in edges:
            e.register()
        check(srv.done.wait(300), "the native cross-device round did not "
              "finish")
    finally:
        for e in edges:
            e.comm.stop()
        release_router(run)
    round_s = time.perf_counter() - t0
    check(srv.error is None and srv.history[0]["n_received"] == ST_EDGES,
          f"the native round missed a device: {srv.history} {srv.error}")
    outs = [t.out for t in trainers]
    stacked = {k: torch.stack([torch.from_numpy(o[0][k]) for o in outs])
               .to(DEV) for k in init}
    w = torch.tensor([float(o[1]) for o in outs], device=DEV)
    want = {k: v.cpu().numpy() for k, v in
            tree_weighted_mean(stacked, w).items()}
    f64 = {k: np.einsum("i,i...->...", np.array([o[1] for o in outs],
                                                np.float64)
                        / sum(o[1] for o in outs),
                        np.stack([o[0][k] for o in outs]).astype(np.float64))
           for k in init}
    res = {"devices": ST_EDGES, "rows_each": ST_EDGE_ROWS,
           "edge_trainer_built_here": not built,
           "edge_trainer_build_s": build_s, "round_s": round_s,
           "train_ms_per_device": statistics.mean(t.ms for t in trainers),
           "train_ms_max": max(t.ms for t in trainers),
           "losses": [o[2]["train_loss"] for o in outs],
           "aggregate_bitwise_weighted_mean": all(
               np.array_equal(srv.params[k], want[k]) for k in init),
           "aggregate_vs_f64_mean": max(float(np.abs(
               srv.params[k] - f64[k]).max()) for k in init)}
    emit({"phase": "standalone", "e_native_edges": res,
          "nvidia_smi": nvidia_smi_line()})
    check(res["aggregate_bitwise_weighted_mean"], "the cross-device "
          "aggregate is not the weighted mean of the returned vectors")
    check(all(np.isfinite(res["losses"])), "a native loss is not finite")
    return res


def phase_standalone(fedsim=None) -> dict:
    """Phase 14 (module docstring). `fedsim`, phase fedsim's flagship
    results when it ran in this call, gives the G = 1 and G = 10 rounds
    beside (a) and (d)."""
    import torch

    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.ops import flash_attention as fa
    from fedml_tpu_torch.ops import paged_attention as pa

    fa.launch_count.update(dict.fromkeys(fa.launch_count, 0))
    pa.launch_count = 0
    t0 = time.perf_counter()
    ds = loader.load(_fedavg_cfg(DEV))
    fedsim = fedsim or {}
    res = {}
    for part, fn in (
            ("a_centralized", lambda: _centralized(ds, fedsim.get(1))),
            ("b_contribution", lambda: _contribution(ds)),
            ("c_inversion", lambda: _inversion(ds)),
            ("d_flops", lambda: _round_flops(ds, fedsim.get(10))),
            ("e_native_edges", lambda: _native_edges(ds))):
        t1 = time.perf_counter()
        res[part] = fn()
        emit({"phase": "standalone", "part": part,
              "seconds": time.perf_counter() - t1})
    launches = {**fa.launch_count, "paged": pa.launch_count}
    res["k1_k4_launches"] = launches
    emit({"phase": "standalone", "k1_k4_launches": launches,
          "nvidia_smi": nvidia_smi_line(),
          "seconds": time.perf_counter() - t0})
    check(not any(launches.values()),
          f"the standalone tools launched a flash or paged kernel: "
          f"{launches}")
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _cli(*args, timeout: float = 300) -> subprocess.CompletedProcess:
    """`python -m fedml_tpu_torch <args>` from the checkout's root."""
    return _clis([args], timeout)[0]


def _cli_start(*args, to_files: bool = False) -> subprocess.Popen:
    """`python -m fedml_tpu_torch <args>` from the checkout's root, started
    (`_cli_wait` collects it). `to_files`: its output goes to temporary
    files, not pipes, so that a process left running beside other work
    never stalls on a full pipe."""
    import os
    import tempfile

    files = (tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")) \
        if to_files else (subprocess.PIPE, subprocess.PIPE)
    p = subprocess.Popen(
        [sys.executable, "-m", "fedml_tpu_torch", *args],
        stdout=files[0], stderr=files[1], text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    p.files = files if to_files else None
    return p


def _cli_wait(p: subprocess.Popen, timeout: float = 300
              ) -> subprocess.CompletedProcess:
    try:
        so, se = p.communicate(timeout=timeout)
    finally:
        p.kill()
    if p.files:
        for f in p.files:
            f.seek(0)
        so, se = (f.read() for f in p.files)
    return subprocess.CompletedProcess(p.args, p.returncode, so, se)


def _clis(argvs, timeout: float = 300) -> list:
    """Several `python -m fedml_tpu_torch` commands started together (each
    spends seconds importing torch), their CompletedProcesses in order."""
    procs = [_cli_start(*a) for a in argvs]
    return [_cli_wait(p, timeout) for p in procs]


def _entry_cfg(log_dir, tracking: bool) -> dict:
    """The flagship config (G = 10, ENTRY_ROUNDS rounds) as a dict; with
    `tracking`, tracked into `log_dir` with its artifact store and
    /metrics."""
    import os

    d = _flagship_dict(comm_round=ENTRY_ROUNDS,
                       extra={"clients_per_device_parallel": 10})
    if tracking:
        d["tracking_args"] = {
            "enable_tracking": True, "log_file_dir": str(log_dir),
            "run_name": "entry",
            "extra": {"artifact_dir": os.path.join(str(log_dir), "arts"),
                      "sysperf_interval": ENTRY_SYSPERF_S}}
        d["common_args"] = {"extra": {"metrics_port": 0}}
    return d


def _round_ms(first_span: int) -> dict:
    """{round: ms} of the `train` spans recorded since `first_span`."""
    from fedml_tpu_torch.utils.events import recorder

    return {s.meta["round"]: s.duration * 1e3
            for s in list(recorder.spans)[first_span:]
            if s.name == "train" and "round" in s.meta}


def _entry_tracked(d) -> dict:
    """(a): init -> mlops.init -> the Simulator's run (what run_simulation
    runs) -> mlops.finish, tracked; then the untracked run's round beside
    it, and (d) predictor_from_artifact behind the HTTP runner."""
    import os

    import torch

    import fedml_tpu_torch
    from fedml_tpu_torch import mlops, serving
    from fedml_tpu_torch.simulation.simulator import Simulator
    from fedml_tpu_torch.utils.artifacts import aggregated_name
    from fedml_tpu_torch.utils.events import recorder
    from fedml_tpu_torch.utils.postmortem import load_postmortem

    out = {}
    # untracked first: the same rounds with no sink, sampler or store
    n0 = len(recorder.spans)
    sim = Simulator(fedml_tpu_torch.init(config=_entry_cfg(d, False),
                                         device=DEV))
    sim.run()
    out["untracked_round_ms"] = _round_ms(n0)
    del sim
    gc.collect()
    torch.cuda.empty_cache()

    cfg = fedml_tpu_torch.init(config=_entry_cfg(d, True), device=DEV)
    mlops.init(cfg)
    store = mlops.artifact_store()
    put_ms = []
    put = store.put

    def timed_put(name, tree):
        t0 = time.perf_counter()
        r = put(name, tree)
        put_ms.append((time.perf_counter() - t0) * 1e3)
        return r

    store.put = timed_put
    n0 = len(recorder.spans)
    try:
        sim = Simulator(cfg)
        sim.run()
    finally:
        mlops.finish()
    out["tracked_round_ms"] = _round_ms(n0)
    out["publish_ms"] = put_ms
    final = {k: v.detach().cpu().numpy()
             for k, v in sim.server_state.params.items()}
    rows = [json.loads(x) for x in
            open(os.path.join(d, "entry.events.jsonl"))]
    trains = sorted(r.get("round") for r in rows
                    if r.get("kind") == "span" and r.get("name") == "train")
    check(trains == list(range(ENTRY_ROUNDS)),
          f"events: train spans for rounds {trains}")
    perf = [r["sysperf"] for r in rows if "sysperf" in r]
    check(perf and max(p.get("dev0_bytes_in_use", 0) for p in perf) > 0,
          f"events: {len(perf)} sysperf rows, none with dev0 bytes in use")
    check(any("report" in r for r in rows), "events: no end-of-run report")
    with open(os.path.join(d, "entry.trace.json")) as f:
        trace = json.load(f)["traceEvents"]
    check(any(e.get("cat") == "round" for e in trace),
          "the Chrome trace has no round track event")
    pm = load_postmortem(d)
    check(pm is not None and pm["reason"] == "finish",
          f"postmortem reason {pm and pm.get('reason')}")
    names = store.list()
    check({aggregated_name(r) for r in range(ENTRY_ROUNDS)} <= set(names),
          f"artifacts {names}")
    last = store.get(aggregated_name(ENTRY_ROUNDS - 1))
    check(set(last) == set(final) and all(
        np.array_equal(np.asarray(last[k]), final[k]) for k in final),
        "the last round's artifact is not bitwise the final parameters")
    out.update(
        sysperf_rows=len(perf),
        dev0_bytes_in_use_max=max(p.get("dev0_bytes_in_use", 0)
                                  for p in perf),
        artifact_bytes=os.path.getsize(os.path.join(
            d, "arts", aggregated_name(ENTRY_ROUNDS - 1) + ".bin")),
        events_rows=len(rows), postmortem=pm["reason"])

    # (d) the round's model served from the store over HTTP
    from fedml_tpu_torch.serving.inference_runner import FedMLInferenceRunner

    x = np.asarray(sim.dataset.x_test[:32], np.float32)
    pred = serving.predictor_from_artifact(store, ENTRY_ROUNDS - 1,
                                           sim.apply_fn, device=DEV)
    runner = FedMLInferenceRunner(pred, port=0).start()
    try:
        code, raw = _post(runner.port, {"inputs": x.tolist()})
    finally:
        runner.stop()
    check(code == 200, f"/predict from the artifact answered {code}")
    got = json.loads(raw)
    with torch.no_grad():
        logits = sim.apply_fn(sim.server_state.params,
                              torch.from_numpy(x).to(DEV))
        want_labels = logits.argmax(-1).cpu().numpy().tolist()
        want_probs = (torch.softmax(logits.float(), -1).cpu().numpy()
                      .round(6).tolist())
    check(got["predictions"] == want_labels
          and got["probabilities"] == want_probs,
          "/predict from the artifact differs from apply_fn of the final "
          "parameters on the same batch")
    out["d_predict"] = {"images": len(x), "bitwise": True}
    del sim, pred, runner
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _battery() -> tuple:
    """(the probes phase entry (f) runs, {probe left out: why}): every
    probe of the port's battery, but fleet_obs_smoke where the `grpc`
    module is missing (its peers' transport; the card's machine has
    none)."""
    import importlib.util

    from fedml_tpu_torch.diagnosis import PROBES

    left_out = {}
    if importlib.util.find_spec("grpc") is None:
        left_out["fleet_obs_smoke"] = (
            "its peers talk over gRPC and this machine has no `grpc` "
            "module (the probe fails naming it); its legs run on the CPU "
            "in tests/test_torch_obsfleet.py")
    return [p for p in PROBES if p not in left_out], left_out


def phase_entry(surface=None) -> dict:
    """Phase 15 (module docstring): the single-process entry surface at the
    flagship. `surface`, phase serve_surface's results when it ran in this
    call, carries (e), the /swap leg on its runner."""
    import os
    import tempfile

    from fedml_tpu_torch.ops import flash_attention as fa
    from fedml_tpu_torch.ops import paged_attention as pa

    fa.launch_count.update(dict.fromkeys(fa.launch_count, 0))
    pa.launch_count = 0
    t0 = time.perf_counter()
    # (f)'s diagnosis battery runs beside (a)-(c): it reads nothing of
    # theirs, and its probes' budgets (the live loop's 20 s) sit far
    # above their readings (2.9 s). fleet_obs_smoke's peers talk over
    # gRPC: on a machine without the module the probe fails naming it, so
    # the battery here leaves it out, and says so on (f)'s line
    battery, left_out = _battery()
    diag_p = _cli_start("diagnosis", "--only", *battery, to_files=True)
    atexit.register(diag_p.kill)
    res = {}
    with tempfile.TemporaryDirectory() as d:
        t1 = time.perf_counter()
        res["a_tracked"] = _entry_tracked(d)
        res["a_tracked"]["seconds"] = time.perf_counter() - t1
        launches = {**fa.launch_count, "paged": pa.launch_count}
        res["a_tracked"]["k1_k4_launches"] = launches
        emit({"phase": "entry", "part": "a_d_tracked_run",
              **res["a_tracked"]})
        check(not any(launches.values()),
              f"the flagship run launched a flash or paged kernel: "
              f"{launches}")
        # (b) the CLI on the run dir, (c) `run` on the same config
        # written as JSON (one round, its own run dir) and (f)'s `env`,
        # started together: (b) and `env` read files and names only
        t1 = time.perf_counter()
        cfg_path = os.path.join(d, "fedml_config.json")
        with open(cfg_path, "w") as f:
            json.dump(_entry_cfg(os.path.join(d, "cli_run"), True), f)
        rep, top, logs, env, run = _clis([
            ("report", "--log-dir", d, "--format", "json"),
            ("top", "--once", "--log-dir", d),
            ("logs", "--list", "--log-dir", d), ("env",),
            ("run", "--cf", cfg_path, "--rounds", "1")], timeout=600)
        check(rep.returncode == 0, f"report rc {rep.returncode}: "
              f"{rep.stderr[-500:]}")
        doc = json.loads(rep.stdout)
        rounds = doc["budget"]["rounds"]
        check(doc["spans"]["train"]["count"] == ENTRY_ROUNDS
              and len(rounds) == ENTRY_ROUNDS
              and all(r["compute_s"] > 0 for r in rounds),
              f"report: train {doc['spans'].get('train')}, rounds {rounds}")
        check(top.returncode == 0 and "rounds_total" in top.stdout,
              f"top rc {top.returncode}: {top.stderr[-300:]}")
        runs = json.loads(logs.stdout)["runs"] if logs.returncode == 0 \
            else []
        check({"entry.events.jsonl", "entry.log", "entry.trace.json",
               "postmortem.json"} <= set(runs), f"logs --list {runs}")
        res["b_cli"] = {"report_train_spans": doc["spans"]["train"],
                        "round_compute_s": [r["compute_s"] for r in rounds],
                        "round_share_compute": [
                            r["compute_s"] / r["wall_s"] for r in rounds],
                        "top_lines": len(top.stdout.splitlines()),
                        "runs": runs}
        emit({"phase": "entry", "part": "b_cli", **res["b_cli"]})
        last = run.stdout.strip().splitlines()[-1] if run.stdout.strip() \
            else ""
        check(run.returncode == 0 and json.loads(last).get("round") == 0,
              f"run rc {run.returncode}, last line {last!r}: "
              f"{run.stderr[-500:]}")
        res["c_run"] = {"last_row": json.loads(last),
                        "b_c_seconds": time.perf_counter() - t1}
        emit({"phase": "entry", "part": "c_run", **res["c_run"]})
    # (e) /swap from the store, on phase serve_surface's runner
    res["e_swap"] = (surface or {}).get("swap") or \
        "not run: phase serve_surface did not run in this call"
    emit({"phase": "entry", "part": "e_swap", "swap": res["e_swap"]})
    # (f) the diagnosis battery (started with the phase) and `env` (run
    # in (b)), as subprocesses
    t1 = time.perf_counter()
    check(env.returncode == 0, f"env rc {env.returncode}")
    card = json.loads(env.stdout)["devices"][0]
    smi_name = nvidia_smi_line().split(",")[0].strip()
    check(card == smi_name, f"env names {card!r}, nvidia-smi {smi_name!r}")
    diag = _cli_wait(diag_p, timeout=600)
    report = json.loads(diag.stdout) if diag.stdout.strip() else {}
    checks = report.get("checks", {})
    from fedml_tpu_torch.diagnosis import REQUIRED

    failed = [k for k in REQUIRED if k in battery
              and not checks.get(k, {}).get("ok")]
    check(diag.returncode == 0 and not failed and set(checks) == set(
        battery), f"diagnosis rc {diag.returncode}, failed {failed}: "
          f"{ {k: checks.get(k) for k in failed} } {diag.stderr[-500:]}")
    res["f_diagnosis"] = {
        "env_device": card,
        "probe_seconds": {k: v.get("seconds") for k, v in checks.items()},
        "probe_ok": {k: v.get("ok") for k, v in checks.items()},
        "kernels": checks.get("kernels"),
        "lint_clean": checks.get("lint_clean"),
        "attribution_smoke": checks.get("attribution_smoke"),
        "left_out": left_out,
        "seconds": time.perf_counter() - t1}
    emit({"phase": "entry", "part": "f_diagnosis", **res["f_diagnosis"]})
    res["seconds"] = time.perf_counter() - t0
    return res


# ----------------------------------------------------------------- phase 16
def _tasks_cfg(dataset: str, model: str, task: str, group: int = 1,
               dtype: str = "bfloat16", samples: int = TASKS_SAMPLES,
               lr: float = TASKS_LR, **data_extra):
    """A phase-tasks config through `fedml_tpu_torch.init`: TASKS_CLIENTS
    clients, IID, TASKS_PER_ROUND a round, batch TASKS_BATCH, 1 epoch, the
    data cache the flagship's, a directory that holds no data (the
    synthetic tasks); `data_extra` more data_args keys."""
    import fedml_tpu_torch

    d = {"data_args": {"dataset": dataset, "partition_method": "homo",
                       "synthetic_samples_per_client": samples,
                       **data_extra,
                       "data_cache_dir": _flagship_dict()["data_args"][
                           "data_cache_dir"]},
         "model_args": {"model": model},
         "train_args": {"federated_optimizer": "FedAvg",
                        "client_num_in_total": TASKS_CLIENTS,
                        "client_num_per_round": TASKS_PER_ROUND,
                        "comm_round": 2, "epochs": 1,
                        "batch_size": TASKS_BATCH, "learning_rate": lr,
                        "compute_dtype": dtype,
                        "extra": {"task": task,
                                  "clients_per_device_parallel": group}},
         "validation_args": {"frequency_of_the_test": 0},
         "comm_args": {"backend": "sp"}}
    return fedml_tpu_torch.init(config=d, device=DEV)


def _lstm_library(vocab: int, params: dict, x) -> dict:
    """CharRNN's two LSTM layers (the port's cell) against cuDNN's
    `nn.LSTM` on the same f32 weights and inputs (TF32 off): outputs
    within TASKS_LSTM_TOL of their largest, then forward + backward
    timed for each (CUDA events). Whether vmap batches `nn.LSTM`'s
    gradient on the card, or falls back to a loop, is printed."""
    import warnings

    import torch

    from fedml_tpu_torch.models import hub

    dev = x.device
    cell = hub.create("rnn", vocab, (x.shape[1],), device=dev)
    for n, t in cell.named_parameters():
        t.data.copy_(params[n].float())
        t.requires_grad_(True)
    cells = [cell.OptimizedLSTMCell_0, cell.OptimizedLSTMCell_1]
    weights = [t for c in cells for t in c.parameters()]
    lstm = torch.nn.LSTM(x.shape[-1], cells[0].hidden, num_layers=2,
                         batch_first=True).to(dev)
    with torch.no_grad():
        for i, c in enumerate(cells):
            cat = lambda pre, leaf: torch.cat(
                [getattr(getattr(c, pre + g), leaf) for g in "ifgo"], -1)
            getattr(lstm, f"weight_ih_l{i}").copy_(cat("i", "kernel").T)
            getattr(lstm, f"weight_hh_l{i}").copy_(cat("h", "kernel").T)
            getattr(lstm, f"bias_hh_l{i}").copy_(cat("h", "bias"))
            getattr(lstm, f"bias_ih_l{i}").zero_()

    def port():
        out = cells[1](cells[0](x, torch.float32), torch.float32)
        torch.autograd.grad(out.square().sum(), weights)
        return out

    def cudnn():
        out = lstm(x)[0]
        torch.autograd.grad(out.square().sum(), list(lstm.parameters()))
        return out

    with _tf32_off():
        a, b = port().detach(), cudnn().detach()
        err = float((a - b).abs().max() / b.abs().max())
        res = {"shape": list(x.shape) + [cells[0].hidden],
               "max_rel_err": err, "port_ms": time_ms(port, n=20),
               "cudnn_lstm_ms": time_ms(cudnn, n=20)}
    res["port_over_cudnn"] = res["port_ms"] / res["cudnn_lstm_ms"]
    check(err <= TASKS_LSTM_TOL, f"the port's LSTM is {err:.3g} of its "
          f"output from cuDNN's (bar {TASKS_LSTM_TOL})")
    # does torch.func batch cuDNN's LSTM gradient (printed, not gated)?
    xs = x.reshape(2, -1, *x.shape[1:])
    p = {k: v.detach() for k, v in lstm.named_parameters()}
    g = torch.func.vmap(torch.func.grad(
        lambda pp, xb: torch.func.functional_call(lstm, pp, (xb,))[0].sum()),
        in_dims=(None, 0))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            g(p, xs)
            res["cudnn_lstm_under_vmap"] = (
                "loop fallback" if any(VMAP_FALLBACK in str(w.message)
                                       for w in caught) else "batched")
        except RuntimeError as e:          # printed, not gated
            res["cudnn_lstm_under_vmap"] = f"refused: {str(e)[:200]}"
    return res


def _tasks_token() -> dict:
    """(a): the token task, CharRNN at its defaults, nwp, bf16."""
    import torch

    from fedml_tpu_torch.core.algorithm import (
        local_sgd, make_client_optimizer, make_objective,
    )
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.models import hub
    from fedml_tpu_torch.simulation.simulator import Simulator

    ds = loader.load(_tasks_cfg("shakespeare", "rnn", "nwp"))
    check(ds.synthetic and ds.num_classes == 81
          and ds.x_train.shape[2:] == (80,),
          "the token data is not the synthetic shakespeare shape")
    steps = ds.shard_size // TASKS_BATCH
    res = {"clients": ds.num_clients, "shard_size": ds.shard_size,
           "local_steps_per_client": steps}
    obj = make_objective("nwp")
    for g in (1, TASKS_G):
        t0 = time.perf_counter()
        sim = Simulator(_tasks_cfg("shakespeare", "rnn", "nwp", group=g), ds)
        res.setdefault("parameters", sum(
            v.numel() for v in sim.params.values()))
        rows = _timed_rounds(sim, 0, 2)              # warm, timed
        if g == 1:
            shard = {k: v[0] for k, v in sim.data.items()}
            idx = torch.arange(TASKS_PROFILE_STEPS * TASKS_BATCH,
                               device=shard["x"].device).reshape(
                -1, TASKS_BATCH)
            opt = make_client_optimizer("sgd", TASKS_LR)
            prof = _profiled(lambda: local_sgd(
                sim.apply_fn, sim.server_state.params, shard, idx, opt,
                objective=obj))
            per = TASKS_PROFILE_STEPS
        else:
            prof = _profiled(lambda: sim.run_round(2))
            per = steps * (TASKS_PER_ROUND // g)     # group steps
        res[f"g{g}"] = {
            "rounds": rows, "ms_per_round": rows[1]["ms"],
            "local_steps_per_round": steps * TASKS_PER_ROUND,
            "ms_per_local_step": rows[1]["ms"] / (steps * TASKS_PER_ROUND),
            "profiled": {**prof, "steps": per,
                         "launches_per_step": prof["launches"] / per},
            "seconds": time.perf_counter() - t0}
        emit({"phase": "tasks", "part": f"a_token_g{g}", **res[f"g{g}"]})
        check(all(np.isfinite(r["train_loss"]) for r in rows),
              f"G = {g}: a token round's loss is not finite")
        del sim
        gc.collect()
        torch.cuda.empty_cache()
    # one f32 local step on the card against the CPU (TF32 off), from one
    # CPU parameter draw and client 0's first batch
    model = hub.create("rnn", 81, (80,), device="meta")
    init = hub.init_params(model, torch.Generator().manual_seed(0))
    opt = make_client_optimizer("sgd", TASKS_LR)
    out = {}
    with _tf32_off():
        for dev in (DEV, "cpu"):
            sh = {k: torch.from_numpy(np.ascontiguousarray(
                getattr(ds, f"{k}_train")[0, :TASKS_BATCH])).to(dev)
                for k in ("x", "y", "mask")}
            p = {k: v.to(dev) for k, v in init.items()}
            out[dev] = {k: v.float().cpu() for k, v in local_sgd(
                hub.apply_fn(model), p, sh,
                torch.arange(TASKS_BATCH, device=dev)[None], opt,
                objective=obj)[0].items()}
    upd = max(float((out["cpu"][k] - init[k]).abs().max()) for k in init)
    err = max(float((out[DEV][k] - out["cpu"][k]).abs().max())
              for k in init)
    res["f32_step_card_vs_cpu"] = {"max_abs_err": err, "max_update": upd,
                                   "rel": err / upd}
    emb = init["Embed_0.embedding"].to(DEV)
    tokens = torch.from_numpy(ds.x_train[0, :TASKS_BATCH]).to(DEV)
    res["lstm_vs_cudnn"] = _lstm_library(
        ds.num_classes, init, torch.nn.functional.embedding(tokens, emb))
    emit({"phase": "tasks", "part": "a_token_checks",
          "f32_step_card_vs_cpu": res["f32_step_card_vs_cpu"],
          "lstm_vs_cudnn": res["lstm_vs_cudnn"]})
    check(err <= PARITY_TOL * upd, f"the f32 token step is {err / upd:.3g} "
          f"of its update from the CPU's (bar {PARITY_TOL})")
    return res


def _tasks_seg() -> dict:
    """(b): pascal_voc with UNetLite at G = TASKS_G; the eval row's
    test_miou; the card's confusion matrix against the CPU's."""
    import torch

    from fedml_tpu_torch.core.algorithm import _seg_confusion
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.models import hub
    from fedml_tpu_torch.simulation.simulator import Simulator

    cfg = _tasks_cfg("pascal_voc", "unet", "segmentation", group=TASKS_G)
    ds = loader.load(cfg)
    check(ds.synthetic and ds.num_classes == 21
          and ds.y_train.shape[2:] == (32, 32),
          "the segmentation data is not the synthetic pascal_voc shape")
    t0 = time.perf_counter()
    sim = Simulator(cfg, ds)
    rows = _timed_rounds(sim, 0, 2)
    ev = sim.evaluate()
    res = {"shard_size": ds.shard_size, "rounds": rows,
           "ms_per_round": rows[1]["ms"], **ev}
    # the confusion matrix of the trained parameters on a fixed set, f32
    # (TF32 off), card against CPU: only near-tie pixels (top-2 margin
    # under NEAR_TIE on the CPU) may flip, each moving 2 counts
    params = {k: v.float().cpu() for k, v in sim.server_state.params.items()}
    n = TASKS_SEG_CHECK
    conf, near = {}, 0
    with _tf32_off(), torch.no_grad():
        for dev in (DEV, "cpu"):
            x = torch.from_numpy(ds.x_test[:n]).to(dev)
            y = torch.from_numpy(ds.y_test[:n]).to(dev)
            logits = hub.apply_fn(sim.model)(
                {k: v.to(dev) for k, v in params.items()}, x)
            conf[dev] = _seg_confusion(logits, y, 21, None, 255).cpu()
            if dev == "cpu":
                top2 = logits.topk(2, dim=-1).values
                near = int(((top2[..., 0] - top2[..., 1]) < NEAR_TIE).sum())
    diff = int((conf[DEV] - conf["cpu"]).abs().sum())
    res["confusion_card_vs_cpu"] = {
        "images": n, "pixels": int(conf["cpu"].sum()), "abs_diff": diff,
        "near_tie_pixels": near, "bar": 2 * near}
    res["seconds"] = time.perf_counter() - t0
    emit({"phase": "tasks", "part": "b_segmentation", **res})
    check(all(np.isfinite(r["train_loss"]) for r in rows),
          "a segmentation round's loss is not finite")
    check("test_miou" in ev and 0.0 <= ev["test_miou"] <= 1.0,
          f"the segmentation eval row has no valid test_miou: {ev}")
    check(diff <= 2 * near, f"the card's confusion matrix is {diff} counts "
          f"from the CPU's (bar {2 * near}: twice the near-tie pixels)")
    del sim
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _tasks_multilabel() -> dict:
    """(c): stackoverflow_lr at its published width (TASKS_SO_WIDTH words,
    TASKS_SO_TAGS tags, given as the h5 reader's so_vocab_size and
    so_tag_size, which size the loader's synthetic bags of words when no
    h5 file is there) with lr, task multilabel: one round and an eval."""
    import torch

    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.simulation.simulator import Simulator

    cfg = _tasks_cfg("stackoverflow_lr", "lr", "multilabel",
                     dtype="float32", samples=TASKS_SO_SAMPLES,
                     so_vocab_size=TASKS_SO_WIDTH, so_tag_size=TASKS_SO_TAGS)
    ds = loader.load(cfg)
    check(ds.synthetic and ds.x_train.shape[2:] == (TASKS_SO_WIDTH,)
          and ds.y_train.shape[2:] == (TASKS_SO_TAGS,),
          "the multilabel data is not the synthetic stackoverflow_lr at "
          "its published width")
    t0 = time.perf_counter()
    sim = Simulator(cfg, ds)
    rows = _timed_rounds(sim, 0, 1)
    ev = sim.evaluate()
    res = {"x_shape": list(ds.x_train.shape), "y_shape":
           list(ds.y_train.shape), "rounds": rows,
           "ms_per_round": rows[0]["ms"], **ev,
           "seconds": time.perf_counter() - t0}
    emit({"phase": "tasks", "part": "c_multilabel", **res})
    check(np.isfinite(rows[0]["train_loss"]) and np.isfinite(
        ev["test_loss"]), "the multilabel round or eval is not finite")
    del sim
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_tasks() -> dict:
    """Phase 16 (module docstring)."""
    import warnings

    from fedml_tpu_torch.ops import flash_attention as fa
    from fedml_tpu_torch.ops import paged_attention as pa

    warnings.filterwarnings("error", message=VMAP_FALLBACK)
    fa.launch_count.update(dict.fromkeys(fa.launch_count, 0))
    pa.launch_count = 0
    t0 = time.perf_counter()
    res = {}
    for part, fn in (("a_token", _tasks_token), ("b_segmentation", _tasks_seg),
                     ("c_multilabel", _tasks_multilabel)):
        t1 = time.perf_counter()
        res[part] = fn()
        emit({"phase": "tasks", "part": part,
              "seconds": time.perf_counter() - t1})
    launches = {**fa.launch_count, "paged": pa.launch_count}
    res["k1_k4_launches"] = launches
    emit({"phase": "tasks", "k1_k4_launches": launches,
          "nvidia_smi": nvidia_smi_line(),
          "seconds": time.perf_counter() - t0})
    check(not any(launches.values()),
          f"the tasks launched a flash or paged kernel: {launches}")
    return res


# ----------------------------------------------------------------- phase 17
def _rt_sync() -> float:
    """perf_counter after the card's queue drains (plain on the CPU)."""
    import torch

    if str(DEV).startswith("cuda"):
        torch.cuda.synchronize()
    return time.perf_counter()


def _rel_diff(a: dict, b: dict, start: dict) -> dict:
    """max |a - b| over the largest |b - start|, leaf by leaf over dicts of
    tensors (nested one level for FedGAN's {"g", "d"}), and the share of
    coordinates within PARITY_TOL of that update."""
    def flat(t):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out.update({f"{k}.{kk}": vv for kk, vv in v.items()})
            else:
                out[k] = v
        return {k: v.detach().double().cpu() for k, v in out.items()}

    a, b, s = flat(a), flat(b), flat(start)
    update = max(float((b[k] - s[k].expand_as(b[k])).abs().max()) for k in s)
    err = max(float((a[k] - b[k]).abs().max()) for k in s)
    close = sum(int(((a[k] - b[k]).abs() <= PARITY_TOL * update).sum())
                for k in s)
    return {"max_abs_err": err, "max_update": update,
            "rel": err / update if update else float("inf"),
            "share_within_tol": close / sum(a[k].numel() for k in s)}


def _card_vs_cpu(part: str, run, start: dict,
                 sign_steps: bool = False) -> dict:
    """`run(device, dtype)` -> parameters, on the CPU in f64 and f32 and on
    the card in f32 (TF32 off). The card is held to the repo's rule for
    rounds, 1e-3 of the CPU f32 run's largest update, or, where f32
    itself departs further from the f64 run, to phase fedavg's clause:
    as close to the f64 run as the CPU's f32 run, within 2x (the f64 run
    is made only where the first rule fails). With `sign_steps` (Adam's
    first steps, lr g / (|g| + eps): a coordinate whose gradient is
    within rounding of 0 moves +-lr on either side), the second clause
    is phase standalone's DLG rule instead: at least ST_INVERT_SHARE of
    the coordinates within 1e-3 of the update."""
    import torch

    with _tf32_off():
        cpu, card = (run(dev, torch.float32) for dev in ("cpu", DEV))
        rel = _rel_diff(card, cpu, start)
        rel["tol"] = PARITY_TOL
        second, why = True, ""
        if rel["rel"] > PARITY_TOL and sign_steps:
            second = rel["share_within_tol"] >= ST_INVERT_SHARE
            why = (f"{rel['share_within_tol']:.4f} of the coordinates "
                   f"within the bar (at least {ST_INVERT_SHARE})")
        elif rel["rel"] > PARITY_TOL:
            f64 = run("cpu", torch.float64)
            e_cpu = _rel_diff(cpu, f64, start)["max_abs_err"]
            e_card = _rel_diff(card, f64, start)["max_abs_err"]
            rel.update(cpu_f32_vs_f64_ratio=e_cpu / rel["max_update"],
                       card_f32_vs_f64_ratio=e_card / rel["max_update"])
            second = e_card <= 2 * e_cpu
            why = (f"{e_card:.3g} from the f64 run against the CPU f32 "
                   f"run's {e_cpu:.3g}")
    emit({"phase": "runtimes", "part": part, **rel})
    check(rel["max_update"] > 0 and second,
          f"{part}: the card's f32 run is {rel['rel']:.3g} of its update "
          f"from the CPU's (bar {PARITY_TOL}); {why}")
    return rel


def _on(tree: dict, dev, dt) -> dict:
    """A parameter dict (or FedGAN's {"g", "d"}) on `dev` in `dt`."""
    return {k: _on(v, dev, dt) if isinstance(v, dict) else v.to(dev, dt)
            for k, v in tree.items()}


def _shards(ds, rows, dev, dt) -> dict:
    """The clients `rows` of a FedDataset as tensors on `dev`, x and mask
    in `dt`."""
    import torch

    return {"x": torch.from_numpy(np.ascontiguousarray(
        ds.x_train[rows])).to(dev, dt),
        "y": torch.from_numpy(np.ascontiguousarray(ds.y_train[rows])).to(
            dev),
        "mask": torch.from_numpy(np.ascontiguousarray(
            ds.mask_train[rows])).to(dev, dt)}


def _rt_async(ds) -> dict:
    """(a): `FedMLRunner` with train_args.async at the flagship."""
    import torch

    import fedml_tpu_torch
    from fedml_tpu_torch.core.algorithm import (
        local_sgd, make_client_optimizer,
    )
    from fedml_tpu_torch.models import hub
    from fedml_tpu_torch.runner import FedMLRunner
    from fedml_tpu_torch.simulation import async_simulator as amod
    from fedml_tpu_torch.utils import metrics as mx

    d = _flagship_dict(client_num_per_round=RT_ASYNC_PER_ROUND,
                       comm_round=RT_ASYNC_ROUNDS,
                       extra={"async": True,
                              "async_concurrency": RT_ASYNC_CONCURRENCY})
    d["common_args"] = {"chaos": {"client_dropout": RT_ASYNC_DROPOUT}}
    cfg = fedml_tpu_torch.init(config=d, device=DEV)
    runner = FedMLRunner(cfg, dataset=ds)
    sim = runner.runner
    check(isinstance(sim, amod.AsyncSimulator),
          "FedMLRunner with train_args.async did not build the async "
          "simulator")
    # every version's parameters, and each event's snapshot against the
    # version it was launched at
    versions = [{k: v.clone() for k, v in sim.params.items()}]
    seen, taus = [], []
    merge, train = sim._merge, sim._train_one

    def spy_merge(g, c, a):
        out = merge(g, c, a)
        versions.append({k: v.clone() for k, v in out.items()})
        return out

    train_ms, eval_ms = [], []

    def spy_train(snap, cid, idx):
        seen.append((snap, sim.version))
        t1 = _rt_sync()
        out = train(snap, cid, idx)
        train_ms.append((_rt_sync() - t1) * 1e3)
        return out

    evaluate = sim.evaluate

    def spy_eval():
        t1 = _rt_sync()
        out = evaluate()
        eval_ms.append((_rt_sync() - t1) * 1e3)
        return out

    sim._merge, sim._train_one, sim.evaluate = spy_merge, spy_train, \
        spy_eval
    record = amod.record_staleness

    def spy_staleness(tau):
        taus.append(tau)
        record(tau)

    amod.record_staleness = spy_staleness
    drops0 = mx.snapshot()["counters"].get("fed.chaos.client_dropouts", 0)
    try:
        t0 = _rt_sync()
        hist = runner.run()
        run_s = _rt_sync() - t0
    finally:
        amod.record_staleness = record
    merged = len(taus)
    snap_ok = all(all(torch.equal(a, versions[v - int(tau)][k])
                      for k, a in s.items())
                  for (s, v), tau in zip(seen, taus))
    stale_events = sum(1 for t in taus if t > 0)
    res = {"merged": merged, "ms_per_merged_update": run_s * 1e3 / merged,
           "run_s": run_s, "train_ms_first": train_ms[0],
           "train_ms_median_after_first": statistics.median(train_ms[1:]),
           "eval_ms": eval_ms, "max_staleness": max(taus),
           "stale_events": stale_events,
           "dropouts": mx.snapshot()["counters"].get(
               "fed.chaos.client_dropouts", 0) - drops0,
           "eval_rows": hist, "snapshots_unchanged_by_merges": snap_ok}
    emit({"phase": "runtimes", "part": "a_async", **res})
    check(merged == RT_ASYNC_PER_ROUND * RT_ASYNC_ROUNDS,
          f"the async run merged {merged} updates")
    check(snap_ok and stale_events > 0,
          "an event did not train from the parameters it was launched with "
          "(or no event was stale)")
    check(all(np.isfinite(r["train_loss"]) and np.isfinite(r["test_loss"])
              for r in hist), "an async eval row is not finite")
    del versions, seen
    # one f32 local step on the card against the CPU, client 0's first
    # batch, from one CPU parameter draw (TF32 off)
    model = hub.create("resnet18_gn", ds.num_classes, ds.x_train.shape[2:],
                       device="meta")
    init = _parity_params()
    bs = cfg.train_args.batch_size
    opt = make_client_optimizer("sgd", cfg.train_args.learning_rate)

    def step(dev, dt):
        sh = {k: v[:bs] for k, v in _shards(ds, 0, dev, dt).items()}
        return local_sgd(hub.apply_fn(model), _on(init, dev, dt), sh,
                         torch.arange(bs, device=dev)[None], opt)[0]

    res["f32_step_card_vs_cpu"] = _card_vs_cpu("a_async_f32_step", step,
                                               init)
    del sim, runner
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _rt_decentralized(ds) -> dict:
    """(b): DSGD and PushSum over RT_NODES flagship nodes."""
    import torch

    from fedml_tpu_torch.comm import SymmetricTopologyManager
    from fedml_tpu_torch.models import hub
    from fedml_tpu_torch.simulation import decentralized as dec

    n = RT_NODES
    data = {k: torch.from_numpy(np.ascontiguousarray(
        getattr(ds, f"{k}_train")[:n])).to(DEV) for k in ("x", "y", "mask")}
    model = hub.create("resnet18_gn", ds.num_classes, ds.x_train.shape[2:],
                       device="meta")
    apply_bf16 = hub.apply_fn(model, "bfloat16")
    # scattered starts: consensus has to come from the gossip
    draws = [hub.init_params(model,
                             torch.Generator(device=DEV).manual_seed(i))
             for i in range(n)]
    stacked0 = {k: torch.stack([p[k] for p in draws]) for k in draws[0]}
    del draws
    idx = dec.draw_indices(0, 1 + RT_DEC_ITERS, n, ds.shard_size,
                           RT_DEC_BATCH)
    lr = FEDAVG_CONFIG["train_args"]["learning_rate"]
    res = {"nodes": n, "batch": RT_DEC_BATCH,
           "consensus_before": dec.consensus_distance(stacked0)}
    runs = (("dsgd", dec.run_dsgd, {"neighbor_num": 2}),
            ("pushsum", dec.run_pushsum, {"in_num": 2, "out_num": 1}))
    for name, run, kw in runs:
        run(apply_bf16, stacked0, data, iters=1, idx=idx[:1], lr=lr,
            batch_size=RT_DEC_BATCH, device=DEV, **kw)          # warm
        t0 = _rt_sync()
        final, losses = run(apply_bf16, stacked0, data, iters=RT_DEC_ITERS,
                            idx=idx[1:], lr=lr, batch_size=RT_DEC_BATCH,
                            device=DEV, **kw)
        ms = (_rt_sync() - t0) * 1e3 / RT_DEC_ITERS
        res[name] = {"ms_per_iteration": ms,
                     "losses": losses.float().cpu().tolist(),
                     "consensus_after": dec.consensus_distance(final)}
        del final
        check(all(np.isfinite(res[name]["losses"])),
              f"{name}: a loss is not finite")
        check(res[name]["consensus_after"] < res["consensus_before"],
              f"{name}: gossip did not move the nodes toward consensus")
    W = torch.tensor(SymmetricTopologyManager(n, 2).topology,
                     dtype=torch.float32, device=DEV)
    res["gossip_ms"] = time_ms(lambda: dec._gossip(stacked0, W), n=20,
                               warmup=3)
    emit({"phase": "runtimes", "part": "b_decentralized", **res})
    del stacked0
    # the first iteration in f32 on the card and the CPU from one
    # (replicated) CPU parameter draw and the same indices, TF32 off
    # over the first FEDAVG_PARITY_CLIENTS nodes (the CPU's f64 and f32
    # iterations of 16 nodes read ~35 s)
    init = _parity_params()
    del data
    m = FEDAVG_PARITY_CLIENTS
    for name, run, kw in runs:
        res[name]["f32_first_iteration_card_vs_cpu"] = _card_vs_cpu(
            f"b_{name}_f32", lambda dev, dt, run=run, kw=kw: run(
                hub.apply_fn(model), _on(init, dev, dt),
                _shards(ds, slice(0, m), dev, dt), iters=1,
                idx=idx[:1, :m], lr=lr, batch_size=RT_DEC_BATCH,
                device=dev, **kw)[0], init)
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _rt_fedgkt(ds) -> dict:
    """(c): FedGKT at its default nets over the first RT_GKT_CLIENTS
    flagship clients."""
    import torch

    from fedml_tpu_torch.simulation.fedgkt import FedGKTRunner

    n = RT_GKT_CLIENTS
    data = {k: np.ascontiguousarray(getattr(ds, f"{k}_train")[:n])
            for k in ("x", "y", "mask")}
    r = FedGKTRunner(data, ds.num_classes, device=DEV)
    t0 = _rt_sync()
    warm = r.run_round(0)
    warm_s = _rt_sync() - t0
    ci, si = (a.to(DEV) for a in r.draw_orders(1))
    t0 = _rt_sync()
    feats, logits, cm = r._client_phase(ci)
    t1 = _rt_sync()
    sm = r._server_phase(feats, logits, si)
    t2 = _rt_sync()
    res = {"clients": n, "shard": ds.shard_size, "warm_round_s": warm_s,
           "warm_row": warm, "client_phase_ms": (t1 - t0) * 1e3,
           "server_phase_ms": (t2 - t1) * 1e3,
           "client_steps": int(ci.shape[1]), "server_steps": int(si.shape[0]),
           "round1_client_loss": float(cm[0] / cm[2]),
           "round1_server_loss": float(sm[0] / sm[2])}
    emit({"phase": "runtimes", "part": "c_fedgkt", **res})
    check(all(np.isfinite([res["round1_client_loss"],
                           res["round1_server_loss"]])),
          "a FedGKT loss is not finite")
    del r, feats, logits
    # the client phase on the card and the CPU, one parameter draw (the
    # runners' default, from a CPU generator), the same orders
    start = FedGKTRunner(data, ds.num_classes, device="cpu").client_params

    def client_phase(dev, dt):
        rr = FedGKTRunner(data, ds.num_classes, device=dev)
        rr.client_params = _on(start, dev, dt)
        rr.data = _shards(ds, slice(0, n), dev, dt)
        rr.server_logits = rr.server_logits.to(dt)
        rr._client_phase(ci.to(dev))
        return rr.client_params

    res["f32_client_phase_card_vs_cpu"] = _card_vs_cpu(
        "c_fedgkt_f32", client_phase, start)
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _rt_fedgan() -> dict:
    """(d): FedGAN at the hub defaults over the mnist fallback's shards."""
    import torch

    import fedml_tpu_torch
    from fedml_tpu_torch.algorithms.fedgan import init_gan_params, make_fedgan
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.models import hub
    from fedml_tpu_torch.parallel.round import build_round_fn, draw_schedules

    d = _flagship_dict(batch_size=RT_GAN_BATCH,
                       learning_rate=RT_GAN_LR)
    d["data_args"]["dataset"] = "mnist"
    cfg = fedml_tpu_torch.init(config=d, device=DEV)
    ds = loader.load(cfg)
    check(ds.synthetic and ds.x_train.shape[2:] == (28, 28, 1),
          "the FedGAN data is not the synthetic mnist shape")
    models = hub.create("gan", 0, device="meta")
    t = cfg.train_args
    alg = make_fedgan(models, t)
    params = init_gan_params(models, (28, 28, 1),
                             torch.Generator(device=DEV).manual_seed(0))
    data = {k: torch.from_numpy(np.ascontiguousarray(v)).to(DEV)
            for k, v in (("x", ds.x_train), ("y", ds.y_train),
                         ("mask", ds.mask_train))}
    round_fn = build_round_fn(alg, group_size=RT_GAN_G)
    st = alg.server_init(params)
    rows = []
    for r in range(2):                       # warm, timed
        ids = np.arange(r * RT_GAN_CLIENTS, (r + 1) * RT_GAN_CLIENTS)
        t0 = _rt_sync()
        o = round_fn(st, None, data, ids, ds.counts[ids].astype(np.float32),
                     seed=(0, r))
        st = o.server_state
        loss = float(o.metrics["train_loss"])
        rows.append({"round": r, "ms": (_rt_sync() - t0) * 1e3,
                     "train_loss": loss})
    res = {"clients_per_round": RT_GAN_CLIENTS, "group": RT_GAN_G,
           "batch": t.batch_size, "local_steps": int(
               alg.schedule(torch.Generator(), ds.shard_size)["idx"].shape[0]),
           "rounds": rows, "ms_per_round": rows[1]["ms"]}
    emit({"phase": "runtimes", "part": "d_fedgan", **res})
    check(all(np.isfinite(r["train_loss"]) for r in rows),
          "a FedGAN round's loss is not finite")
    # the round's first 2 clients, one local step each, f32 on the card
    # and the CPU from one CPU parameter draw and one set of draws
    ids = np.arange(2)
    sched = {k: v[:, :1] for k, v in draw_schedules(
        alg, (0, 0), ids, ds.shard_size).items()}
    p0 = init_gan_params(models, (28, 28, 1), torch.Generator().manual_seed(0))
    del data

    def two_clients(dev, dt):
        return build_round_fn(alg)(
            alg.server_init(_on(p0, dev, dt)), None,
            _shards(ds, slice(0, 2), dev, dt), ids,
            ds.counts[ids].astype(np.float32), seed=0,
            batch_idx={k: v.to(dt) if v.is_floating_point() else v
                       for k, v in sched.items()}).server_state.params

    res["f32_two_clients_card_vs_cpu"] = _card_vs_cpu(
        "d_fedgan_f32", two_clients, p0, sign_steps=True)
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _rt_small(ds) -> dict:
    """(e): HierFL, SplitNN, vertical FL and a flow-DSL FedAvg."""
    import uuid

    import torch

    from fedml_tpu_torch.algorithms.builtin import make_fedavg
    from fedml_tpu_torch.comm import FedCommManager
    from fedml_tpu_torch.comm.loopback import (
        LoopbackTransport, release_router,
    )
    from fedml_tpu_torch.config import TrainArgs
    from fedml_tpu_torch.core import flow
    from fedml_tpu_torch.cross_silo import SiloTrainer
    from fedml_tpu_torch.models import hub
    from fedml_tpu_torch.simulation.fedgkt import GKTClientNet, GKTServerNet
    from fedml_tpu_torch.simulation.hierarchical_fl import HierFLRunner
    from fedml_tpu_torch.simulation.split_nn import SplitNNRunner
    from fedml_tpu_torch.simulation.vertical import VerticalFL

    res = {}
    ft = FEDAVG_CONFIG["train_args"]
    t = TrainArgs(epochs=1, batch_size=ft["batch_size"],
                  learning_rate=ft["learning_rate"],
                  compute_dtype=ft["compute_dtype"])
    model = hub.create("resnet18_gn", ds.num_classes, ds.x_train.shape[2:],
                       device="meta")
    init = hub.init_params(model, torch.Generator(device=DEV).manual_seed(0))
    n = RT_HIER_CLIENTS
    data = {k: np.ascontiguousarray(getattr(ds, f"{k}_train")[:n])
            for k in ("x", "y", "mask")}
    t0 = _rt_sync()
    hier = HierFLRunner(make_fedavg(hub.apply_fn(model, t.compute_dtype), t),
                        init, data, ds.counts[:n], n_groups=2,
                        group_comm_round=2, seed=RT_HIER_SEED,
                        group_size=RT_HIER_G, device=DEV)
    sub, round_fn = [], hier.round_fn

    def spy_round(*a, **kw):
        out = round_fn(*a, **kw)
        sub.append(float(out.metrics["train_loss"]))
        return out

    hier.round_fn = spy_round
    h = hier.run(1)
    # sub-rounds run group by group: each group's second against its first
    res["hierfl"] = {"seconds": _rt_sync() - t0, "clients": n,
                     "groups": [len(g) for g in hier.groups], "history": h,
                     "sub_round_losses": sub,
                     "loss_fell": all(b < a for a, b in zip(sub[::2],
                                                            sub[1::2]))}
    del hier

    class Bottom(torch.nn.Module):
        """The GKT client net's extractor as SplitNN's bottom."""

        def __init__(self, net):
            super().__init__()
            self.net = net

        def forward(self, x, dtype=None):
            return self.net(x, part="extract")

    k = RT_SPLIT_CLIENTS
    t0 = _rt_sync()
    split = SplitNNRunner(
        Bottom(GKTClientNet(ds.num_classes, device="meta")),
        GKTServerNet(ds.num_classes, device="meta"),
        {key: v[:k] for key, v in data.items()}, lr=0.02, batch_size=32,
        epochs=1, device=DEV)
    sh = split.run(2)
    res["splitnn"] = {"seconds": _rt_sync() - t0, "clients": k,
                      "losses": [r["loss"] for r in sh],
                      "loss_fell": bool(
                          np.mean([r["loss"] for r in sh[k:]])
                          < np.mean([r["loss"] for r in sh[:k]]))}
    del split

    rs = np.random.RandomState(1)
    dims = RT_VFL_DIMS
    xs = [rs.randn(RT_VFL_ROWS, dd).astype(np.float32) for dd in dims]
    y = (sum(x @ rs.randn(dd) for x, dd in zip(xs, dims)) > 0).astype(
        np.float32)
    t0 = _rt_sync()
    vfl = VerticalFL(dims, lr=0.5, device=DEV)
    vfl.fit(xs, y, epochs=5, batch_size=256)
    res["vertical"] = {"seconds": _rt_sync() - t0, "parties": len(dims),
                       "first_loss": vfl.loss_trace[0],
                       "last_loss": vfl.loss_trace[-1],
                       "acc": float((vfl.predict(xs) == y).mean()),
                       "loss_fell": vfl.loss_trace[-1] < vfl.loss_trace[0]}

    run_id = f"rt-flow-{uuid.uuid4().hex[:6]}"
    trainers = {c: SiloTrainer(model, t, ds.x_train[c - 1][
        ds.mask_train[c - 1] > 0], ds.y_train[c - 1][
        ds.mask_train[c - 1] > 0], seed=c, device=DEV) for c in (1, 2)}
    p0 = {key: v.cpu().numpy() for key, v in init.items()}
    losses = []

    def local_training(params):
        cid = params["client_id"]
        new_p, m, metrics = trainers[cid].train(params["model"],
                                                int(params["round"]))
        losses.append(metrics["train_loss"])
        return {"model": new_p, "n": m, "round": params["round"]}

    def aggregate(params):
        rr = params["client_results"]
        w = np.asarray([r["n"] for r in rr], np.float64)
        w /= w.sum()
        return {"model": {key: sum(wi * r["model"][key] for wi, r in zip(
            w, rr)).astype(np.float32) for key in rr[0]["model"]},
            "round": int(rr[0]["round"]) + 1}

    flows = []
    t0 = _rt_sync()
    for rank, role in ((0, flow.ROLE_SERVER), (1, flow.ROLE_CLIENT),
                       (2, flow.ROLE_CLIENT)):
        f = flow.FedMLAlgorithmFlow(
            FedCommManager(LoopbackTransport(rank, run_id), rank), rank,
            role, client_ids=[1, 2])
        f.add_flow("init", lambda p: {"model": p0, "round": 0})
        f.add_flow("local_training", local_training, flow.ROLE_CLIENT)
        f.add_flow("aggregate", aggregate)
        f.build(loop_start="local_training", rounds=RT_FLOW_ROUNDS)
        flows.append(f)
    try:
        for f in flows[1:]:
            f.run(background=True)
        flows[0].run(background=True)
        check(flows[0].done.wait(timeout=300), "the flow did not finish")
    finally:
        release_router(run_id)
    res["flow_fedavg"] = {"seconds": _rt_sync() - t0, "silos": 2,
                          "rounds": flows[0].final_params["round"],
                          "losses": losses,
                          "loss_fell": bool(np.mean(losses[2:])
                                            < np.mean(losses[:2]))}
    emit({"phase": "runtimes", "part": "e_small_runtimes",
          **{k: {kk: vv for kk, vv in v.items() if kk != "history"}
             for k, v in res.items()}})
    check(flows[0].final_params["round"] == RT_FLOW_ROUNDS,
          "the flow did not run its rounds")
    for k, v in res.items():
        check(all(np.isfinite(x) for x in v.get("losses", [0.0])),
              f"{k}: a loss is not finite")
    return res


def _rt_torch_silos(ds) -> dict:
    """(f): four TorchSiloTrainer silos over the hub CNN on the card,
    federating through the port's FedServerManager over loopback."""
    import uuid

    import torch

    from fedml_tpu_torch.comm import FedCommManager
    from fedml_tpu_torch.comm.loopback import (
        LoopbackTransport, release_router,
    )
    from fedml_tpu_torch.cross_silo import FedClientManager, FedServerManager
    from fedml_tpu_torch.engines import TorchSiloTrainer
    from fedml_tpu_torch.models import hub

    def cnn():
        m = hub.create("cnn", ds.num_classes, ds.x_train.shape[2:],
                       device=DEV)
        init = hub.init_params(m, torch.Generator().manual_seed(0))
        with torch.no_grad():
            for name, p in m.named_parameters():
                p.copy_(init[name])
                p.requires_grad_(True)
        return m

    ids = list(range(1, RT_TORCH_SILOS + 1))
    silos = {}
    for c in ids:
        keep = ds.mask_train[c - 1] > 0
        silos[c] = TorchSiloTrainer(
            cnn(), ds.x_train[c - 1][keep], ds.y_train[c - 1][keep],
            lr=RT_TORCH_LR, batch_size=FEDAVG_CONFIG["train_args"][
                "batch_size"], seed=c, device=DEV)
    losses = {c: [] for c in ids}
    for c, tr in silos.items():
        def wrapped(params, r, _c=c, _train=tr.train):
            out = _train(params, r)
            losses[_c].append(out[2]["train_loss"])
            return out

        tr.train = wrapped
    run_id = f"rt-torch-{uuid.uuid4().hex[:6]}"
    server = FedServerManager(
        FedCommManager(LoopbackTransport(0, run_id), 0), client_ids=ids,
        init_params=silos[1].get_params(), num_rounds=RT_TORCH_ROUNDS,
        device=DEV)
    clients = [FedClientManager(
        FedCommManager(LoopbackTransport(c, run_id), c), c, silos[c])
        for c in ids]
    t0 = _rt_sync()
    try:
        server.run(background=True)
        for cl in clients:
            cl.run(background=True)
            cl.announce_ready()
        check(server.done.wait(timeout=300), "the torch federation hung")
    finally:
        release_router(run_id)
    res = {"silos": len(ids), "rounds": RT_TORCH_ROUNDS,
           "seconds": _rt_sync() - t0,
           "device": str(silos[1].device),
           "losses": losses,
           "loss_fell": all(v[-1] < v[0] for v in losses.values())}
    emit({"phase": "runtimes", "part": "f_torch_silos", **res})
    check(all(len(v) == RT_TORCH_ROUNDS for v in losses.values()),
          "a torch silo missed a round")
    check(all(np.isfinite(np.asarray(v)).all()
              for v in server.params.values()),
          "the torch federation's parameters are not finite")
    return res


def phase_runtimes() -> dict:
    """Phase 17 (module docstring)."""
    import warnings

    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.ops import flash_attention as fa
    from fedml_tpu_torch.ops import paged_attention as pa

    warnings.filterwarnings("error", message=VMAP_FALLBACK)
    ds = loader.load(_fedavg_cfg(DEV))
    check(ds.synthetic, "the flagship data is not the synthetic CIFAR-10")
    fa.launch_count.update(dict.fromkeys(fa.launch_count, 0))
    pa.launch_count = 0
    t0 = time.perf_counter()
    res = {}
    for part, fn, args in (("a_async", _rt_async, (ds,)),
                           ("b_decentralized", _rt_decentralized, (ds,)),
                           ("c_fedgkt", _rt_fedgkt, (ds,)),
                           ("d_fedgan", _rt_fedgan, ()),
                           ("e_small", _rt_small, (ds,)),
                           ("f_torch_silos", _rt_torch_silos, (ds,))):
        t1 = time.perf_counter()
        res[part] = fn(*args)
        emit({"phase": "runtimes", "part": part,
              "seconds": time.perf_counter() - t1})
    launches = {**fa.launch_count, "paged": pa.launch_count}
    res["k1_k4_launches"] = launches
    emit({"phase": "runtimes", "k1_k4_launches": launches,
          "nvidia_smi": nvidia_smi_line(),
          "seconds": time.perf_counter() - t0})
    check(not any(launches.values()),
          f"the runtimes launched a flash or paged kernel: {launches}")
    return res


# ------------------------------------------------------------- phase 18
def _sse_timed(port: int, body: dict) -> tuple[list, list]:
    """One streamed POST: (events, their arrival times)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request("POST", "/predict", body=json.dumps(body).encode(),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    check(resp.status == 200, f"stream answered {resp.status}")
    events, times = [], []
    for raw in resp:
        line = raw.strip()
        if line.startswith(b"data:"):
            events.append(json.loads(line[5:]))
            times.append(time.perf_counter())
    conn.close()
    return events, times


def _fleet_counters() -> dict:
    from fedml_tpu_torch.utils import metrics as mx

    c = mx.snapshot()["counters"]
    return {k: c.get(k, 0) for k in (
        "serving.shed_total", "serving.stream_failovers",
        "serving.stream_replay_divergences", "serving.stream_continuations",
        "serving.gateway_failovers", "serving.affinity.hits",
        "serving.prefix_hits", "fed.chaos.replica_kills")}


def _fleet_obs_wave(coll, before: dict) -> dict:
    """(a)'s fleet plane after the wave: one more scrape, then the gates:
    three `process` label values in the aggregated exposition, each
    process's split-back series equal to its own scrape, and the fleet
    sums of the wave's `serving_*` counters (after minus before) equal to
    the sum of the per-process deltas. The gateway and the replicas run
    in this one process, so their /metrics serve one registry: each
    column is the same snapshot, and the sums count it three times."""
    from fedml_tpu_torch.utils import metrics as mx
    from fedml_tpu_torch.utils.prometheus import (parse_prometheus,
                                                  split_by_label)

    ok = coll.scrape_once()
    after = coll.fleet_snapshot()
    per = {k: v for k, v in split_by_label(
        parse_prometheus(coll.aggregated_text()), "process").items() if k}
    procs = after["processes"]
    check(all(ok.values()) and len(per) == 3 and sorted(per)
          == sorted(procs), f"the aggregate's process labels {sorted(per)}"
          f" (scrapes {ok})")
    for name, p in procs.items():
        check(per[name]["counters"] == p["snapshot"]["counters"],
              f"{name}'s split-back counters are not its scrape")

    def delta(snap_of, key):
        return (snap_of(after).get(key, 0) - snap_of(before).get(key, 0))

    keys = sorted(k for k in after["sums"]["counters"]
                  if k.startswith("serving_"))
    sums = {k: delta(lambda f: f["sums"]["counters"], k) for k in keys}
    parts = {k: sum(
        p["snapshot"]["counters"].get(k, 0)
        - ((before["processes"].get(n) or {}).get("snapshot") or {}).get(
            "counters", {}).get(k, 0) for n, p in procs.items())
        for k in keys}
    check(sums == parts and any(sums.values()),
          f"the fleet sums of the wave's serving counters {sums} are not "
          f"the per-process deltas {parts}")
    return {"processes": sorted(per), "serving_counter_deltas": sums,
            "scrapes": mx.snapshot()["counters"].get("obs.fleet.scrapes"),
            "stale": {n: p["stale"] for n, p in procs.items()}}


def _fleet_headline() -> dict:
    """(a): two 7B replicas behind the gateway under a loadgen wave with a
    rolling update to v2 mid-wave, the probes against a direct v2 engine,
    then a mid-stream replica kill."""
    import tempfile
    import threading

    import torch

    from fedml_tpu_torch.comm.chaos import FaultSpec
    from fedml_tpu_torch.llm.transformer import (
        LLAMA2_7B, TransformerLM, init_params,
    )
    from fedml_tpu_torch.ops import flash_attention as fa
    from fedml_tpu_torch.ops import paged_attention as pa
    from fedml_tpu_torch.serving.scheduler import (
        Deployment, InferenceGateway, start_replica,
    )
    from fedml_tpu_torch.soak.loadgen import LoadGenerator, TrafficSpec
    from fedml_tpu_torch.utils.artifacts import FileArtifactStore, adapter_name
    from fedml_tpu_torch.utils.obsfleet import FleetCollector

    smi = nvidia_smi_line()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dims = LLAMA2_7B
    state = init_params(dims, seed=0, dtype=torch.bfloat16, device=DEV)
    base_bytes = sum(t.numel() * t.element_size() for t in state.values())
    base = TransformerLM.from_state(dims, state)
    v1, v2 = _adapters(base, seed=1), _adapters(base, seed=2)
    del base
    spec = {"model_kind": "lm", "device": DEV,
            "lm": {"vocab_size": dims.vocab_size, "d_model": dims.d_model,
                   "n_layers": dims.n_layers, "n_heads": dims.n_heads,
                   "d_ff": dims.d_ff, "max_len": MAX_LEN},
            "params": state, "adapters": v1, "serve": dict(FLEET_SERVE)}
    runners = [start_replica(dict(spec))[1] for _ in range(2)]
    engines = [r.predictor.engine for r in runners]
    # one copy of the weights: an unadapted kernel of both replicas' served
    # models IS the base tensor; the adapted kernels are merged per replica
    probe = "blocks.0.w_up.kernel"
    shared = all(e.serving_model.state_dict()[probe].data_ptr()
                 == state[probe].data_ptr() for e in engines)
    check(shared, "the replicas hold their own copies of the base weights")
    merged_bytes = sum(t.numel() * t.element_size() for n, t in
                       engines[0].serving_model.state_dict().items()
                       if n in v1)
    dep = Deployment.adopt([f"http://127.0.0.1:{r.port}" for r in runners],
                           probation_deadline_s=5.0)
    gw = InferenceGateway(dep, scale_interval=30, shed_watermark=FLEET_SHED,
                          retry_after_s=1.0, affinity=True).start()
    url = f"http://127.0.0.1:{gw.port}/predict"
    store_dir = tempfile.mkdtemp(prefix="fleet-store-")
    out = {"nvidia_smi": smi, "setup_s": time.perf_counter() - t0,
           "base_weights_gb": base_bytes / 1e9,
           "merged_kernel_gb_per_replica": merged_bytes / 1e9,
           "weights_shared": shared}
    # the fleet plane: a collector over the gateway's roster (the gateway
    # and both replicas) scraping through the wave
    roster = gw.fleet_roster()
    coll = FleetCollector(roster, interval_s=FLEET_SCRAPE_S,
                          timeout_s=5.0, stale_after_s=60.0).start()
    try:
        # warm both replicas (first-call costs off the wave)
        for r in runners:
            code, _b = _post(r.port, {"tokens": list(range(1, 300)),
                                      "max_new_tokens": 4})
            check(code == 200, f"warm-up answered {code}")
        traffic = TrafficSpec(seed=0, vocab=dims.vocab_size,
                              rate_rps=FLEET_RATE, duration_s=FLEET_LOAD_S,
                              burst_every_s=2 * FLEET_LOAD_S,
                              burst_factor=FLEET_BURST,
                              burst_len_s=FLEET_BURST_S, **FLEET_TRAFFIC)
        check(traffic.max_total_len() <= MAX_LEN,
              f"traffic needs {traffic.max_total_len()} > {MAX_LEN} tokens")
        store = FileArtifactStore(store_dir)
        store.put(adapter_name(2), v2)
        c0 = _fleet_counters()
        check(all(coll.scrape_once().values()), "a fleet scrape failed "
              "before the wave")
        fleet0 = coll.fleet_snapshot()
        steps0 = [e.decode_steps for e in engines]
        slots0 = [e.decode_slot_steps for e in engines]
        fa.launch_count.update(dict.fromkeys(fa.launch_count, 0))
        pa.launch_count = 0
        pa.launches_by_c.clear()
        gen = LoadGenerator(traffic, url, max_workers=16,
                            request_timeout_s=300)
        swap = {}

        def roll():
            time.sleep(FLEET_SWAP_AT_S)
            t1 = time.perf_counter()
            try:
                swap["updated"] = dep.rolling_update(
                    store, adapter_name(2), version=2, timeout=120)
            except Exception as e:  # noqa: BLE001 — checked below
                swap["error"] = f"{type(e).__name__}: {e}"
            swap["seconds"] = time.perf_counter() - t1

        t_wave = time.perf_counter()
        gen.start()
        roller = threading.Thread(target=roll)
        roller.start()
        gen.done.wait(FLEET_LOAD_S + 60)
        roller.join(timeout=300)
        results = gen.stop(timeout=300)
        wave_s = time.perf_counter() - t_wave
        torch.cuda.synchronize()
        launches = {"all": pa.launch_count, "by_c": dict(pa.launches_by_c)}
        steps = [e.decode_steps - s for e, s in zip(engines, steps0)]
        slot_steps = [e.decode_slot_steps - s
                      for e, s in zip(engines, slots0)]
        flash = dict(fa.launch_count)
        c1 = _fleet_counters()
        check("error" not in swap, f"rolling update failed: {swap}")
        versions = dep.versions()
        codes = sorted({r.status for r in results})
        bad = [r.status for r in results if r.klass == "error"]
        ok = [r for r in results if r.klass == "ok"]
        shed = sum(r.klass == "shed" for r in results)
        ttft = sorted(r.ttft_s for r in ok if r.ttft_s is not None)
        tbt = sorted(g for r in ok for g in r.tbt_s)
        out["a_wave"] = {
            "requests": len(results), "ok": len(ok), "shed_429": shed,
            "non2xx_excl_shed": len(bad), "codes": codes,
            "rate_rps": FLEET_RATE, "burst_x": FLEET_BURST,
            "wave_s": wave_s,
            "ttft_p50_s": ttft[len(ttft) // 2] if ttft else None,
            "ttft_p99_s": ttft[min(len(ttft) - 1, int(0.99 * (len(ttft) - 1)))]
            if ttft else None,
            "output_tokens_per_s": sum(r.tokens_out for r in ok) / wave_s,
            "stream_decode_tokens_per_s": 1.0 / tbt[len(tbt) // 2]
            if tbt else None,
            "ttft_samples": len(ttft),
            "swap_s": swap.get("seconds"), "versions": versions,
            "decode_steps": steps,
            "mean_live_slots_per_step": [n / max(k, 1) for n, k in
                                         zip(slot_steps, steps)],
            "decode_slots": N_SLOTS, "k4_launches": launches,
            "k1_k3_launches": flash,
            "counters": {k: c1[k] - c0[k] for k in c0},
            "nvidia_smi": smi}
        emit({"phase": "fleet", "part": "a_wave", **out["a_wave"]})
        out["a_fleet_obs"] = _fleet_obs_wave(coll, fleet0)
        emit({"phase": "fleet", "part": "a_fleet_obs",
              **out["a_fleet_obs"]})
        check(not bad, f"the wave answered non-2xx other than 429: {bad}")
        check(len(ok) > 0, "no request of the wave was answered")
        check(sorted(versions.values()) == [2, 2],
              f"the fleet is not at version 2: {versions}")
        check(launches["all"] == dims.n_layers * sum(steps) > 0
              and launches["by_c"] == {1: launches["all"]},
              f"K4 launches {launches} != {dims.n_layers} x decode steps "
              f"{steps}")
        check(not any(flash.values()), f"a flash kernel ran: {flash}")
        # probes through the gateway, one at a time, against one engine on
        # v2 driven directly
        rs = np.random.RandomState(7)
        probes = [(rs.randint(1, dims.vocab_size,
                              int(rs.randint(64, 400))).tolist(),
                   FLEET_PROBE_NEW) for _ in range(FLEET_PROBES)]
        got = []
        for p, n in probes:
            code, raw = _post(gw.port, {"tokens": p, "max_new_tokens": n})
            check(code == 200, f"probe answered {code}")
            got.append(json.loads(raw)["generated_tokens"])
        eng = _engine(TransformerLM.from_state(dims, state), adapters=v2,
                      paged_kernel=True)
        try:
            want = [eng.submit(p, n).result(timeout=600) for p, n in probes]
            ties = _near_tie_identical(eng.serving_model, probes, want, got,
                                       phase="fleet")
        finally:
            eng.stop()
        del eng
        out["a_probes"] = {**ties, "exact": sum(a == b for a, b in
                                                 zip(want, got))}
        # the kill: a greedy stream's 8th token on replica 0
        body = {"tokens": probes[0][0], "max_new_tokens": FLEET_STREAM_NEW,
                "stream": True}
        ref_ev, _t = _sse_timed(gw.port, body)
        ref = [e["token"] for e in ref_ev if "token" in e]
        check(ref_ev[-1].get("done") is True, "the unkilled stream did not end")
        # the replica affinity routes this prompt to (it served the
        # unkilled stream, so it holds the prompt's first page) is the one
        # armed to die
        prefer = gw._affinity_prefer(body, b"")
        doomed_i = next((i for i, rep in enumerate(dep.replicas)
                         if rep.replica_id in (prefer or ())), 0)
        doomed = runners[doomed_i]
        doomed.arm_chaos(FaultSpec(replica_kill={0: 8}), 0)
        k0 = _fleet_counters()
        kill = None
        for _ in range(4):
            t1 = time.perf_counter()
            ev, times = _sse_timed(gw.port, body)
            wall = time.perf_counter() - t1
            k1 = _fleet_counters()
            if k1["fed.chaos.replica_kills"] > k0["fed.chaos.replica_kills"]:
                kill = (ev, times, wall, k1)
                break
        check(kill is not None, "the replica_kill never fired")
        ev, times, wall, k1 = kill
        toks = [e["token"] for e in ev if "token" in e]
        idx = [e["index"] for e in ev if "token" in e]
        check(idx == list(range(len(idx))) and len(idx) == FLEET_STREAM_NEW,
              f"the killed stream's indices {idx}")
        check(ev[-1].get("done") is True,
              f"the killed stream ended in {ev[-1]}")
        tok_t = [t for e, t in zip(ev, times) if "token" in e]
        cont = (k1["serving.stream_continuations"]
                - k0["serving.stream_continuations"])
        out["a_kill"] = {
            "path": ("continuation" if cont else
                     "replay_matched" if toks == ref else
                     "replay_verified_then_differed"),
            "stream_s": wall,
            "failover_s": max(b - a for a, b in zip(tok_t, tok_t[1:])),
            "stream_failovers": (k1["serving.stream_failovers"]
                                 - k0["serving.stream_failovers"]),
            "doomed_state": dep.replicas[doomed_i].state, "nvidia_smi": smi}
        # the killed replica's endpoint is gone: it stays in the fleet
        # view, marked stale with the scrape's error
        doomed_name = next(n for n, u in roster.items()
                           if f":{doomed.port}/" in u)
        ok = coll.scrape_once()
        gone = coll.fleet_snapshot()["processes"]
        out["a_fleet_obs"]["after_kill"] = {
            "scrape_ok": ok, "doomed": doomed_name,
            "stale": {n: p["stale"] for n, p in gone.items()},
            "error": gone[doomed_name]["error"]}
        check(sorted(gone) == sorted(roster) and gone[doomed_name]["stale"]
              and gone[doomed_name]["snapshot"] is not None
              and not ok[doomed_name],
              f"the stopped replica is not a stale column: "
              f"{out['a_fleet_obs']['after_kill']}")
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["launches"] = launches["all"]
        emit({"phase": "fleet", "part": "a_probes_kill",
              "probes": out["a_probes"], "kill": out["a_kill"],
              "stale_after_kill": out["a_fleet_obs"]["after_kill"],
              "peak_gb": out["peak_gb"], "nvidia_smi": smi})
    finally:
        coll.stop()
        gw.stop()
        for r in runners:
            r.stop()
        import shutil

        shutil.rmtree(store_dir, ignore_errors=True)
    del runners, engines, dep, gw, state, v1, v2, spec
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def python_job(args):
    """The python job phase fleet (b) launches ("chip_smoke:python_job")."""
    return {"sum": int(args["a"]) + int(args["b"])}


def _fleet_platform() -> dict:
    """(b): the platform tier at the flagship ResNet-18-GN, then a
    master-dispatched LM serve job at 7B width."""
    import os
    import tempfile

    import torch

    import fedml_tpu_torch.api as api
    from fedml_tpu_torch.llm.transformer import (
        LLAMA2_7B, ModelDims, init_params,
    )
    from fedml_tpu_torch.models import hub
    from fedml_tpu_torch.ops import paged_attention as pa
    from fedml_tpu_torch.serving.predictor import TorchPredictor
    from fedml_tpu_torch.serving.scheduler import Deployment

    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="fleet-platform-")
    # the registry and the profile under the run's temp dir, not HOME
    api._REGISTRY = os.path.join(tmp, "models")
    api._PROFILE = os.path.join(tmp, "profile.json")
    out = {"nvidia_smi": smi}
    model = hub.create("resnet18_gn", 10, (32, 32, 3), device="meta")
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    params = hub.init_params(hub.create("resnet18_gn", 10, (32, 32, 3),
                                        device=DEV), gen)
    n_params = sum(t.numel() for t in params.values())
    # the CLI's `launch` of a python job, started here: its process spends
    # seconds importing torch while the flagship deploys
    path = os.path.join(tmp, "job.yaml")
    with open(path, "w") as f:   # JSON is YAML, and needs no PyYAML
        json.dump({"type": "python", "entry": "chip_smoke:python_job",
                   "args": {"a": 1, "b": 2}}, f)
    launch = _cli_start("launch", path, "--timeout", "120")
    cluster = api.cluster_start(2)
    served = []
    try:
        api.model_create("flagship", model="resnet18_gn", params=params,
                         num_classes=10, input_shape=(32, 32, 3))
        t1 = time.perf_counter()
        dep = api.model_deploy("flagship", cluster, n_replicas=2,
                               timeout=300, config={
                                   "probation_deadline_s": 3.0,
                                   "probe_backoff_s": 0.05})
        deploy_s = time.perf_counter() - t1
        check(len(dep.ready_replicas()) == 2,
              f"{len(dep.ready_replicas())} of 2 flagship replicas READY")
        gw = api.model_gateway(dep, scale_interval=30)
        try:
            x = np.random.RandomState(0).randn(
                FLEET_IMAGES, 32, 32, 3).astype(np.float32).tolist()
            want = TorchPredictor(hub.apply_fn(model), params,
                                  device=DEV).predict({"inputs": x})
            t1 = time.perf_counter()
            code, raw = _post(gw.port, {"inputs": x})
            predict_s = time.perf_counter() - t1
            check(code == 200, f"the gateway answered {code}")
            got = json.loads(raw)
            check(got["predictions"] == want["predictions"]
                  and got["probabilities"] == want["probabilities"],
                  "the deployed flagship disagrees with a TorchPredictor")
            # heal: stop one replica's runner under the gateway
            victim = next(rid for w in cluster.workers
                          for rid in list(w.active_servers))
            for w in cluster.workers:
                if victim in w.active_servers:
                    w.active_servers[victim].stop()
            t1 = time.perf_counter()
            codes = [_post(gw.port, {"inputs": x[:8]})[0] for _ in range(6)]
            check(codes == [200] * 6, f"failover answered {codes}")
            deadline = time.monotonic() + 120
            while not (any(r.replica_id == victim and r.state == "DEAD"
                           for r in dep.replicas)
                       and len(dep.ready_replicas()) >= 2):
                check(time.monotonic() < deadline,
                      "no replacement replica came up")
                time.sleep(0.05)
            heal_s = time.perf_counter() - t1
            check(json.loads(_post(gw.port, {"inputs": x})[1]) == got,
                  "the healed fleet answers differently")
        finally:
            gw.stop()
        # jobs: one through launch_job (its entry registered on the
        # cluster's workers: a worker never imports a name off the wire),
        # one through the CLI (which imports the job file's entry itself)
        for w in cluster.workers:
            w.register_python_job("chip_smoke:python_job", python_job)
        job = api.launch_job({"type": "python",
                              "entry": "chip_smoke:python_job",
                              "args": {"a": 2, "b": 40}},
                             cluster=cluster, wait=True, timeout=120)
        check(job["status"] == "FINISHED" and job["result"] == {"sum": 42},
              f"launch_job: {job}")
        cli = _cli_wait(launch)
        check(cli.returncode == 0, f"launch exited {cli.returncode}: "
              f"{cli.stderr[-2000:]}")
        check(json.loads(cli.stdout.strip().splitlines()[-1])["result"]
              == {"sum": 3}, f"launch printed {cli.stdout[-500:]}")
        out["b_flagship"] = {
            "params": n_params, "deploy_s": deploy_s,
            "predict_64_s": predict_s, "heal_s": heal_s,
            "launch_job": job["status"], "cli_launch_rc": cli.returncode,
            "nvidia_smi": smi}
        emit({"phase": "fleet", "part": "b_flagship", **out["b_flagship"]})
        for w in cluster.workers:
            for rid in list(w.active_servers):
                w.active_servers.pop(rid).stop()
        # an LM serve job with its params on the wire
        dims = ModelDims(LLAMA2_7B.vocab_size, LLAMA2_7B.d_model,
                         FLEET_LM_LAYERS, LLAMA2_7B.n_heads, LLAMA2_7B.d_ff)
        state = init_params(dims, seed=0, dtype=torch.bfloat16, device=DEV)
        wire_gb = sum(t.numel() * t.element_size()
                      for t in state.values()) / 1e9
        spec = {"model_kind": "lm", "lm": {
            "vocab_size": dims.vocab_size, "d_model": dims.d_model,
            "n_layers": dims.n_layers, "n_heads": dims.n_heads,
            "d_ff": dims.d_ff, "max_len": MAX_LEN},
            "params": state, "serve": dict(FLEET_SERVE),
            "requirements": {}}
        t1 = time.perf_counter()
        lm_dep = Deployment(cluster.master, spec, min_replicas=1,
                            max_replicas=1).deploy(1, timeout=600)
        lm_deploy_s = time.perf_counter() - t1
        check(len(lm_dep.ready_replicas()) == 1, "the LM replica never READY")
        rep = lm_dep.ready_replicas()[0]
        runner = next(w.active_servers[rep.replica_id]
                      for w in cluster.workers
                      if rep.replica_id in w.active_servers)
        served.append(runner)
        eng = runner.predictor.engine
        check(eng is not None and eng._kernel_on,
              "the LM replica does not run the K4 engine")
        port = int(rep.endpoint.rsplit(":", 1)[1])
        _post(port, {"tokens": list(range(1, 40)), "max_new_tokens": 2})
        rs = np.random.RandomState(3)
        steps0 = eng.decode_steps
        pa.launch_count = 0
        pa.launches_by_c.clear()
        outs = []
        for _ in range(4):
            p = rs.randint(1, dims.vocab_size, 48).tolist()
            code, raw = _post(port, {"tokens": p, "max_new_tokens": 16})
            check(code == 200, f"the LM replica answered {code}")
            outs.append(json.loads(raw)["generated_tokens"])
        launches, steps = pa.launch_count, eng.decode_steps - steps0
        check(all(len(o) == 16 for o in outs), "an LM answer is short")
        check(launches == FLEET_LM_LAYERS * steps > 0,
              f"LM job: K4 launches {launches} != {FLEET_LM_LAYERS} x "
              f"{steps} steps")
        out["b_lm_job"] = {"wire_gb": wire_gb, "deploy_s": lm_deploy_s,
                           "decode_steps": steps, "k4_launches": launches,
                           "nvidia_smi": smi}
        emit({"phase": "fleet", "part": "b_lm_job", **out["b_lm_job"]})
        del state, spec
    finally:
        launch.kill()
        for r in served:
            r.stop()
        for w in cluster.workers:
            for rid in list(w.active_servers):
                w.active_servers.pop(rid).stop()
        api.cluster_stop(cluster)
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def _fleet_loop() -> dict:
    """(c): the live loop at its own defaults, chaos on both tiers, against
    an unkilled run."""
    import tempfile

    from fedml_tpu_torch.comm.chaos import FaultSpec
    from fedml_tpu_torch.soak.loop import LiveLoopHarness

    smi = nvidia_smi_line()
    runs = {}
    for name, spec in (("chaos", FaultSpec(silo_kill={0: 1, 2: 2},
                                           replica_kill={0: 8})),
                       ("unkilled", None)):
        t1 = time.perf_counter()
        with tempfile.TemporaryDirectory() as store, \
                tempfile.TemporaryDirectory() as ckpt:
            h = LiveLoopHarness(rounds=FLEET_LOOP_ROUNDS, store_dir=store,
                                checkpoint_dir=ckpt, fault_spec=spec,
                                slo=FLEET_LOOP_SLO, device=DEV)
            try:
                rep = h.run(timeout=300, tail_s=1.0)
                params = {k: {j: v.copy() for j, v in ab.items()}
                          for k, ab in h.silo.server.params.items()}
            finally:
                h.close()
        runs[name] = (rep, params, time.perf_counter() - t1)
    rep, params, wall = runs["chaos"]
    rep0, params0, wall0 = runs["unkilled"]
    bitwise = sorted(params) == sorted(params0) and all(
        np.array_equal(np.asarray(params[k][j]), np.asarray(params0[k][j]))
        for k in params for j in ("a", "b"))
    res = {"requests": rep["requests"], "ok": rep["ok"],
           "shed_429": rep["shed_429s"],
           "non2xx_excl_shed": rep["non2xx_excl_shed"],
           "fleet_version": rep["fleet_version"],
           "fleet_versions": rep["fleet_versions"],
           "kills": rep["kills_executed"], "slo_ok": rep["slo_ok"],
           "checks": rep["checks"], "ttft_p99_ms": rep["ttft_p99_ms"],
           "round_to_serve_p50_ms": rep["round_to_serve_p50_ms"],
           "lag_max": rep["lag_max_seen"], "bitwise_unkilled": bitwise,
           "chaos_s": wall, "unkilled_s": wall0,
           "unkilled_loop_ok": rep0["loop_ok"], "nvidia_smi": smi}
    emit({"phase": "fleet", "part": "c_live_loop", **res})
    check(rep["non2xx_excl_shed"] == 0,
          f"the live loop answered non-2xx: {rep['error_codes']}")
    check(rep["fleet_version"] == FLEET_LOOP_ROUNDS and rep["converged"]
          and all(v == FLEET_LOOP_ROUNDS
                  for v in rep["fleet_versions"].values()),
          f"the fleet did not track the last round: {rep['fleet_versions']}")
    check(rep["kills_executed"] == [(0, 1), (2, 2)],
          f"the trainer kills: {rep['kills_executed']}")
    check(rep["slo_ok"] and rep["loop_ok"], f"SLOs: {rep['checks']}")
    check(rep0["loop_ok"], f"the unkilled loop: {rep0['checks']}")
    check(bitwise, "the chaos run's final adapters differ from an unkilled "
          "run's")
    return res


def phase_fleet() -> dict:
    """Phase 18 (module docstring)."""
    t0 = time.perf_counter()
    res = {"a": _fleet_headline(), "b": _fleet_platform(),
           "c": _fleet_loop()}
    res["seconds"] = time.perf_counter() - t0
    return res


# ------------------------------------------------------------- phase 19
def _mesh_dict(**extra) -> dict:
    """Phase mesh's config: the flagship's model, batch and shapes over 10
    clients of MESH_SAMPLES synthetic CIFAR-10 images, partitioned hetero
    (varied counts), MESH_CLIENTS a round, f32; `extra` sections on top."""
    d = _flagship_dict(client_num_in_total=10,
                       client_num_per_round=MESH_CLIENTS,
                       compute_dtype="float32")
    d["data_args"].update(partition_method="hetero", partition_alpha=0.5,
                          synthetic_samples_per_client=MESH_SAMPLES)
    for sec, kv in extra.items():
        d[sec] = {**d.get(sec, {}), **kv}
    return d


def _k1_k4() -> int:
    from fedml_tpu_torch.ops import flash_attention as fa
    from fedml_tpu_torch.ops import paged_attention as pa

    return sum(fa.launch_count.values()) + pa.launch_count


def _rank_setup() -> None:
    """Phase mesh's rank setup, run as each rank joins: cuBLAS's and
    cuDNN's TF32 off in the rank's process (as `_tf32_off` does here, for
    the f32 bars), cuDNN deterministic, and one f32 ResNet-18-GN local
    step at the flagship batch and one at half of it (the batch of each
    rank of a 2-rank silo), so that the process's first-step costs come
    before its rounds ((b)'s ranks warm while part (a) runs); the peak
    memory reading starts after it."""
    import torch

    from fedml_tpu_torch._device import deterministic_cuda
    from fedml_tpu_torch.core.algorithm import (
        local_sgd, make_client_optimizer,
    )
    from fedml_tpu_torch.models import hub
    from fedml_tpu_torch.parallel.launch import current

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = current().device
    deterministic_cuda(dev)
    model = hub.create("resnet18_gn", 10, (32, 32, 3), device="meta")
    params = {k: v.to(dev) for k, v in hub.init_params(
        model, torch.Generator().manual_seed(0)).items()}
    b = FEDAVG_CONFIG["train_args"]["batch_size"]
    shard = {"x": torch.zeros((b, 32, 32, 3), device=dev),
             "y": torch.zeros(b, dtype=torch.int64, device=dev),
             "mask": torch.ones(b, device=dev)}
    for rows in (b, b // 2):
        local_sgd(hub.apply_fn(model), params, shard,
                  torch.arange(rows, device=dev)[None],
                  make_client_optimizer("sgd", 0.0))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def _mesh_rank_b(cfg: dict, params: dict) -> dict:
    """Phase mesh (b) in one gloo rank: the Simulator over the config's
    mesh, one f32 round."""
    import torch

    import fedml_tpu_torch
    from fedml_tpu_torch.parallel.launch import current
    from fedml_tpu_torch.simulation.simulator import Simulator

    info = current()
    cuda = info.device.type == "cuda"
    sim = Simulator(fedml_tpu_torch.init(config=cfg, device=str(info.device)),
                    params={k: torch.from_numpy(v) for k, v in params.items()})
    ids, weights, _b, _f = sim._round_inputs(0)
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    row = sim.run_round(0)
    if cuda:
        torch.cuda.synchronize()
    out = {"rank": info.rank, "backend": info.backend, "ranks": sim._d,
           "ids": ids.tolist(), "weights": weights.tolist(), "row": row,
           "seconds": time.perf_counter() - t0, "k1_k4": _k1_k4(),
           "peak_bytes": (torch.cuda.max_memory_allocated(info.device)
                          if cuda else 0)}
    if info.rank == 0:
        out["params"] = {k: v.cpu().numpy()
                         for k, v in sim.server_state.params.items()}
    return out


def _mesh_a(ds, params0: dict) -> dict:
    """Phase mesh (a): a bf16 round over a one-rank NCCL mesh against the
    unmeshed round, bitwise."""
    import torch

    from fedml_tpu_torch.algorithms.builtin import build_algorithm
    from fedml_tpu_torch.config import TrainArgs
    from fedml_tpu_torch.models import hub
    from fedml_tpu_torch.ops.tree import tree_leaves
    from fedml_tpu_torch.parallel.launch import local_world
    from fedml_tpu_torch.parallel.mesh import make_mesh
    from fedml_tpu_torch.parallel.round import build_round_fn, draw_schedules

    cfg_t = FEDAVG_CONFIG["train_args"]
    t = TrainArgs(epochs=1, batch_size=cfg_t["batch_size"],
                  learning_rate=cfg_t["learning_rate"])
    model = hub.create("resnet18_gn", ds.num_classes, ds.x_train.shape[2:],
                       device="meta")
    alg = build_algorithm("FedAvg", hub.apply_fn(model, "bfloat16"), t)
    ids = np.arange(8)
    weights = ds.counts[:8].astype(np.float32)
    data = {k: torch.from_numpy(np.ascontiguousarray(v[:8])).to(DEV)
            for k, v in (("x", ds.x_train), ("y", ds.y_train),
                         ("mask", ds.mask_train))}
    sched = draw_schedules(alg, 0, ids, ds.shard_size)
    res, outs = {}, {}
    if str(DEV).startswith("cuda"):   # the part's own peak, not the script's
        torch.cuda.reset_peak_memory_stats()
    with local_world("nccl", DEV):
        mesh = make_mesh({"clients": 1})
        for tag, m in (("flat", None), ("mesh", mesh)):
            fn = build_round_fn(alg, mesh=m, health_stats=True)
            st = alg.server_init({k: v.to(DEV) for k, v in params0.items()})
            _rt_sync()
            t0 = time.perf_counter()
            o = fn(st, None, data, ids, weights, seed=0, batch_idx=sched)
            res[f"{tag}_seconds"] = _rt_sync() - t0
            outs[tag] = (o.server_state.params, o.metrics)
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(outs["mesh"]), tree_leaves(outs["flat"])))
    res.update(bitwise=same, backend="nccl", ranks=1,
               train_loss=outs["mesh"][1]["train_loss"].item(),
               peak_bytes=torch.cuda.max_memory_allocated())
    emit({"phase": "mesh", "part": "a_one_rank_nccl", **res})
    check(same, "mesh (a): the one-rank NCCL mesh round is not the "
          "unmeshed round bit for bit")
    return res


def _mesh_rel(got: dict, want: dict, start: dict) -> dict:
    err = max(float(np.abs(got[k] - want[k]).max()) for k in want)
    upd = max(float(np.abs(want[k] - start[k]).max()) for k in want)
    return {"max_abs_err": err, "max_update": upd,
            "rel": err / upd if upd else float("inf"), "tol": PARITY_TOL}


def _mesh_b(pool, params_np: dict) -> dict:
    """Phase mesh (b): the Simulator over two gloo ranks on the card
    against the unmeshed f32 Simulator round."""
    import torch

    import fedml_tpu_torch
    from fedml_tpu_torch.simulation.simulator import Simulator

    cfg = _mesh_dict(comm_args={"backend": "xla"},
                     device_args={"mesh_shape": {"clients": 2}})
    t0 = time.perf_counter()
    outs = pool.run(_mesh_rank_b, cfg, params_np, timeout_s=MESH_TIMEOUT_S)
    ranks_s = time.perf_counter() - t0
    with _tf32_off():
        ref = Simulator(fedml_tpu_torch.init(config=_mesh_dict(), device=DEV),
                        params={k: torch.from_numpy(v)
                                for k, v in params_np.items()})
        sampled = ref.sample_clients(0).tolist()
        _rt_sync()
        t1 = time.perf_counter()
        ref_row = ref.run_round(0)
        ref_s = _rt_sync() - t1
    want = {k: v.cpu().numpy() for k, v in ref.server_state.params.items()}
    lead = outs[0]
    rel = _mesh_rel(lead["params"], want, params_np)
    pads = [w for w in lead["weights"] if w == 0]
    res = {"backend": pool.backend, "ranks": lead["ranks"],
           "sampled": sampled, "placed_ids": lead["ids"],
           "placed_weights": lead["weights"], "padded": len(pads),
           "lpt_applied": lead["ids"] != sorted(lead["ids"]),
           "train_loss": lead["row"]["train_loss"],
           "ref_train_loss": ref_row["train_loss"], **rel,
           "rank_seconds": [o["seconds"] for o in outs],
           "ranks_call_seconds": ranks_s, "unmeshed_seconds": ref_s,
           "peak_bytes": [o["peak_bytes"] for o in outs],
           "k1_k4": [o["k1_k4"] for o in outs]}
    emit({"phase": "mesh", "part": "b_two_gloo_ranks", **res})
    check(all(o["ids"] == lead["ids"] for o in outs),
          "mesh (b): the ranks placed the cohort differently")
    check(len(pads) == 1 and len(lead["ids"]) == MESH_CLIENTS + 1,
          f"mesh (b): expected one zero-weight pad, got {lead['weights']}")
    check(res["lpt_applied"], "mesh (b): LPT did not permute the cohort")
    check(rel["max_update"] > 0 and rel["rel"] <= PARITY_TOL,
          f"mesh (b): {rel['rel']:.3g} of the update from the unmeshed "
          f"round (bar {PARITY_TOL})")
    return res


def _mesh_c(ds, params_np: dict) -> dict:
    """Phase mesh (c): run_hierarchical (2 silos x intra 2, gloo ranks on
    the card, each warmed by `_rank_setup` as it joins) against flat
    FedAvg over the same trainers, f32 with TF32 off; where f32 itself
    departs further, phase fedavg's clause against the flat run in f64:
    as close to it as the flat f32 run, within 2x."""
    import torch

    from fedml_tpu_torch.config import TrainArgs
    from fedml_tpu_torch.cross_silo import SiloTrainer
    from fedml_tpu_torch.cross_silo.hierarchical import run_hierarchical
    from fedml_tpu_torch.models import hub

    real = [(ds.x_train[c][:int(n)], ds.y_train[c][:int(n)])
            for c, n in enumerate(ds.counts)]
    xs = np.concatenate([x for x, _ in real])
    ys = np.concatenate([y for _, y in real])
    r = MESH_SILO_ROWS
    silos = [(xs[i * r:(i + 1) * r], ys[i * r:(i + 1) * r]) for i in (0, 1)]
    t = TrainArgs(epochs=1, batch_size=FEDAVG_CONFIG["train_args"][
        "batch_size"], learning_rate=FEDAVG_CONFIG["train_args"][
        "learning_rate"])
    model = hub.create("resnet18_gn", ds.num_classes, ds.x_train.shape[2:],
                       device="meta")
    t0 = time.perf_counter()
    server = run_hierarchical(model, params_np, t, silos, num_rounds=1,
                              devices=[DEV] * 4, device=DEV,
                              timeout_s=MESH_TIMEOUT_S, setup=_rank_setup)
    hier_s = time.perf_counter() - t0
    got = {k: np.asarray(v) for k, v in server.params.items()}

    def flat(dt):
        """Flat FedAvg over the same trainers in `dt`, TF32 off."""
        with _tf32_off():
            outs = [SiloTrainer(model, t, x.astype(dt), y, seed=i,
                                device=DEV).train(
                {k: v.astype(dt) for k, v in params_np.items()}, 0)
                for i, (x, y) in enumerate(silos)]
        w = np.asarray([o[1] for o in outs], np.float64)
        return {k: sum(wi * o[0][k].astype(np.float64)
                       for wi, o in zip(w, outs)) / w.sum()
                for k in params_np}

    t1 = time.perf_counter()
    want = flat(np.float32)
    flat_s = time.perf_counter() - t1
    rel = _mesh_rel(got, want, params_np)
    second, why = True, ""
    if rel["rel"] > PARITY_TOL:
        f64 = flat(np.float64)
        e_flat = max(float(np.abs(want[k] - f64[k]).max()) for k in f64)
        e_hier = max(float(np.abs(got[k] - f64[k]).max()) for k in f64)
        rel.update(flat_f32_vs_f64_ratio=e_flat / rel["max_update"],
                   hier_f32_vs_f64_ratio=e_hier / rel["max_update"])
        second = e_hier <= 2 * e_flat
        why = (f"; {e_hier:.3g} from the f64 run against the flat f32 "
               f"run's {e_flat:.3g}")
    stats = server.silo_rank_stats
    res = {"silos": 2, "intra": 2, **rel,
           "allreduce_steps_per_rank": [[s["allreduce_steps"] for s in silo]
                                        for silo in stats],
           "steps_per_round": r // t.batch_size,
           "peak_bytes": [[s["peak_bytes"] for s in silo] for silo in stats],
           "k1_k4": [[s["kernel_launches"] for s in silo] for silo in stats],
           "exitcodes": server.silo_exitcodes,
           "hier_seconds": hier_s, "flat_seconds": flat_s}
    emit({"phase": "mesh", "part": "c_run_hierarchical", **res})
    check(server.silo_exitcodes == [[0, 0], [0, 0]],
          f"mesh (c): rank exit codes {server.silo_exitcodes}")
    check(res["allreduce_steps_per_rank"] == [[r // t.batch_size] * 2] * 2,
          f"mesh (c): inner all-reduces {res['allreduce_steps_per_rank']}")
    check(rel["max_update"] > 0 and second,
          f"mesh (c): {rel['rel']:.3g} of the update from flat FedAvg "
          f"(bar {PARITY_TOL}){why}")
    return res


def phase_mesh() -> dict:
    """Phase 19 (module docstring)."""
    import torch

    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.models import hub
    from fedml_tpu_torch.ops import flash_attention as fa
    from fedml_tpu_torch.ops import paged_attention as pa
    from fedml_tpu_torch.parallel.launch import RankPool

    t0 = time.perf_counter()
    fa.launch_count.update(dict.fromkeys(fa.launch_count, 0))
    pa.launch_count = 0
    # (b)'s two ranks reach the card while (a) runs here; (c)'s four
    # are started and stopped by run_hierarchical
    pool = RankPool([DEV, DEV], timeout_s=MESH_TIMEOUT_S,
                    setup=_rank_setup)
    res = {}
    try:
        import fedml_tpu_torch

        ds = loader.load(fedml_tpu_torch.init(config=_mesh_dict(),
                                              device=DEV))
        check(ds.synthetic and len(set(ds.counts.tolist())) > 1,
              "phase mesh's data is not the varied synthetic CIFAR-10")
        model = hub.create("resnet18_gn", ds.num_classes,
                           ds.x_train.shape[2:], device="meta")
        params0 = hub.init_params(model, torch.Generator().manual_seed(0))
        params_np = {k: v.numpy() for k, v in params0.items()}
        for part, fn, args in (("a", _mesh_a, (ds, params0)),
                               ("b", _mesh_b, (pool, params_np)),
                               ("c", _mesh_c, (ds, params_np))):
            t1 = time.perf_counter()
            res[part] = fn(*args)
            res[part]["part_seconds"] = time.perf_counter() - t1
            emit({"phase": "mesh", "part": part,
                  "seconds": res[part]["part_seconds"]})
    finally:
        res["b_exitcodes"] = pool.close()
    launches = _k1_k4() + sum(res["b"]["k1_k4"]) + sum(
        sum(s) for s in res["c"]["k1_k4"])
    res["k1_k4_launches"] = launches
    res["seconds"] = time.perf_counter() - t0
    emit({"phase": "mesh", "k1_k4_launches": launches,
          "b_exitcodes": res["b_exitcodes"], "nvidia_smi": nvidia_smi_line(),
          "seconds": res["seconds"]})
    check(res["b_exitcodes"] == [0, 0],
          f"mesh (b): rank exit codes {res['b_exitcodes']}")
    check(launches == 0, f"phase mesh launched K1-K4 {launches} times")
    return res


# ------------------------------------------------------------- phase 20
def _qlora_rank_setup() -> None:
    """Phase qlora (d)'s rank setup, run as each rank joins: cuBLAS's and
    cuDNN's TF32 off in the rank's process (the f32 bar)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _recompute_greedy(apply, model, ads, prompt, n_new) -> tuple:
    """(tokens, top-2 margins) of the greedy loop over the full-recompute
    forward `apply(model, ads, tokens)`, one forward a token."""
    import torch

    buf, margins = list(prompt), []
    with torch.no_grad():
        for _ in range(n_new):
            lg = apply(model, ads, torch.tensor([buf], device=DEV))[0, -1]
            top = torch.topk(lg.float(), 2).values
            margins.append(float(top[0] - top[1]))
            buf.append(int(lg.float().argmax()))
    return buf[len(prompt):], margins


def _against_recompute(outs, refs) -> dict:
    """Token identity against the recompute loop under the near-tie rule:
    a stream whose first difference sits at a pick where the recompute's
    top-2 margin is below NEAR_TIE passes (nothing after it is read)."""
    ties = []
    for i, (a, (b, margins)) in enumerate(zip(outs, refs)):
        j = next((k for k in range(len(b)) if a[k] != b[k]), None)
        if j is None:
            continue
        emit({"phase": "qlora", "near_tie": {"request": i, "pick": j,
                                            "margin": margins[j]}})
        check(margins[j] < NEAR_TIE, f"qlora (a): request {i} differs from "
              f"the recompute at pick {j}, top-2 margin {margins[j]}")
        ties.append(i)
    return {"identical": len(refs) - len(ties), "near_ties": ties}


def _qlora_a(reqs) -> tuple:
    """Phase qlora (a): the int8 7B base served by the engine at the serve
    cell's knobs with rank-8 adapters, beside the bf16 base; the f32
    engine over the int8 base against the f32 recompute loop. Returns
    (results, the int8 state, the adapters)."""
    import torch

    from fedml_tpu_torch.llm import quant
    from fedml_tpu_torch.llm.transformer import (
        LLAMA2_7B, TransformerLM, init_params,
    )

    L, nh = LLAMA2_7B.n_layers, LLAMA2_7B.n_heads
    wave = reqs[:QLORA_WAVE]
    t0 = time.perf_counter()
    state = init_params(LLAMA2_7B, seed=0, dtype=torch.bfloat16, device=DEV)
    model = TransformerLM.from_state(LLAMA2_7B, state)
    ads = _adapters(model, seed=5)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    res = {"bf16_bytes": quant.quant_bytes(state), "init_s": init_s}
    torch.cuda.reset_peak_memory_stats()
    outs_b, st_b = _serve(model, wave, adapters=ads, paged_kernel=True)
    st_b["peak_bytes"] = torch.cuda.max_memory_allocated()
    t1 = time.perf_counter()
    qstate = quant.quantize_tree_int8(state)
    torch.cuda.synchronize()
    res["quantize_s"] = time.perf_counter() - t1
    del model, state
    gc.collect()
    torch.cuda.empty_cache()
    res["int8_bytes"] = quant.quant_bytes(qstate)
    qmodel = TransformerLM.from_state(LLAMA2_7B, qstate)
    torch.cuda.reset_peak_memory_stats()
    outs_q, st_q = _serve(qmodel, wave, adapters=ads, paged_kernel=True)
    st_q["peak_bytes"] = torch.cuda.max_memory_allocated()
    for st in (st_b, st_q):
        st["ms_per_decode_step"] = st["wall_s"] * 1e3 / st["decode_steps"]
    # the bf16 engine against the bf16 recompute loop: printed, not gated
    # (bf16 rounds at other points in the two paths; random weights)
    apply_b = quant.make_inscan_quant_apply(nh, dtype=torch.bfloat16)
    same_b = sum(
        x == y for i in QLORA_CHECK for x, y in zip(_recompute_greedy(
            apply_b, qmodel, ads, wave[i][0], QLORA_CHECK_NEW)[0],
            outs_q[i]))
    # the bar: the f32 engine over the int8 base against the f32 recompute
    # loop of make_inscan_quant_apply, TF32 off
    checks = [(reqs[i][0], QLORA_CHECK_NEW) for i in QLORA_CHECK]
    with _tf32_off():
        outs_f, st_f = _serve(qmodel, checks, adapters=ads,
                              paged_kernel=True, dtype=torch.float32)
        apply_f = quant.make_inscan_quant_apply(nh, dtype=torch.float32)
        refs = [_recompute_greedy(apply_f, qmodel, ads, p, n)
                for p, n in checks]
    ident = _against_recompute(outs_f, refs)
    res.update(bf16_wave=st_b, int8_wave=st_q, f32_check=st_f,
               bf16_recompute_match=same_b / (len(QLORA_CHECK)
                                              * QLORA_CHECK_NEW),
               f32_vs_recompute=ident,
               int8_vs_bf16_greedy_match=sum(
                   x == y for a, b in zip(outs_b, outs_q)
                   for x, y in zip(a, b)) / sum(len(a) for a in outs_b))
    emit({"phase": "qlora", "part": "a_serving", **res})
    for outs, st in ((outs_b, st_b), (outs_q, st_q), (outs_f, st_f)):
        check(all(len(o) == n for o, (_p, n) in zip(
            outs, wave if st is not st_f else checks)),
              "qlora (a): a ticket ended short of max_new_tokens")
        check(st["launches"] == L * st["decode_steps"] > 0,
              f"qlora (a): K4 launches {st['launches']} != {L} x "
              f"{st['decode_steps']} decode steps")
    del qmodel
    gc.collect()
    torch.cuda.empty_cache()
    return res, qstate, ads


def _qlora_b(qstate, ads) -> dict:
    """Phase qlora (b): make_fedllm_seq_round(inscan_quant=True) over the
    int8 7B base on a one-rank NCCL (silos 1, seq 1) mesh, one round."""
    import torch

    from fedml_tpu_torch.config import TrainArgs
    from fedml_tpu_torch.core.algorithm import ServerState
    from fedml_tpu_torch.llm import make_fedllm_seq_round, shard_fedllm_data
    from fedml_tpu_torch.llm.transformer import LLAMA2_7B, TransformerLM
    from fedml_tpu_torch.parallel.launch import local_world
    from fedml_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(11)
    seqs = rng.integers(0, LLAMA2_7B.vocab_size,
                        (TRAIN_CLIENTS, QLORA_SEQS, TRAIN_T + 1))
    raw = {"x": seqs[..., :-1], "y": seqs[..., 1:],
           "mask": np.ones((TRAIN_CLIENTS, QLORA_SEQS), np.float32)}
    t = TrainArgs(epochs=1, batch_size=1, learning_rate=1e-3,
                  compute_dtype="bfloat16")
    model = TransformerLM.from_state(LLAMA2_7B, qstate)
    k0 = _k1_k4()
    torch.cuda.reset_peak_memory_stats()
    with local_world("nccl", DEV):
        mesh = make_mesh({"silos": 1, "seq": 1})
        rnd = make_fedllm_seq_round(model, qstate, t, mesh,
                                    inscan_quant=True)
        data = shard_fedllm_data(raw, mesh, device=DEV)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, met = rnd(ServerState(ads, None, 0), data,
                      np.arange(TRAIN_CLIENTS),
                      np.full(TRAIN_CLIENTS, float(QLORA_SEQS)), seed=0)
        loss = float(met["train_loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    moved = min((st.params[k][n] - ads[k][n]).abs().max().item()
                for k in ads for n in ("a", "b"))
    finite = all(torch.isfinite(v).all().item() for ab in st.params.values()
                 for v in ab.values())
    steps = TRAIN_CLIENTS * QLORA_SEQS
    res = {"clients": TRAIN_CLIENTS, "seqs": QLORA_SEQS, "seq_len": TRAIN_T,
           "steps": steps, "round_s": wall, "s_per_step": wall / steps,
           "tokens_per_s": steps * TRAIN_T / wall, "train_loss": loss,
           "n_tokens": float(met["n_tokens"]), "min_adapter_move": moved,
           "finite": finite, "peak_bytes": torch.cuda.max_memory_allocated(),
           "k1_k4": _k1_k4() - k0}
    emit({"phase": "qlora", "part": "b_seq_round_int8_7b", **res})
    check(finite and np.isfinite(loss), "qlora (b): adapters not finite")
    check(moved > 0, "qlora (b): an adapter did not move")
    return res


def _qlora_c(bw: float) -> dict:
    """Phase qlora (c): the flash LoRA round at 7B width and QLORA_LAYERS
    layers in bf16, G = QLORA_G against G = 1, and the folded flash
    kernels at the group's shape: bitwise the per-client launches and
    within the rule of their plain versions, timed beside the per-client
    launches, the plain forward, SDPA's forward and the forward's bound
    (HBM rate `bw`)."""
    import torch
    import torch.nn.functional as F

    from fedml_tpu_torch.config import TrainArgs
    from fedml_tpu_torch.core.algorithm import make_batch_indices
    from fedml_tpu_torch.llm.transformer import LLAMA2_7B, init_params
    from fedml_tpu_torch.ops import flash_attention as fa
    from fedml_tpu_torch.parallel.round import build_round_fn, client_generator

    g, bh, t, d = QLORA_G, TRAIN_BS * H, TRAIN_T, DH
    rng = np.random.default_rng(21)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (g, bh, t, d), np.float32)).to(DEV, torch.bfloat16) for _ in range(4))

    def loss(q_, k_, v_, do_):
        return (fa.flash_attention(q_, k_, v_).float() * do_.float()).sum()

    grad = torch.func.grad(loss, argnums=(0, 1, 2))
    before = dict(fa.launch_count)
    o_v = torch.func.vmap(fa.flash_attention)(q, k, v)
    g_v = torch.func.vmap(grad)(q, k, v, do)
    torch.cuda.synchronize()
    fold = {n: fa.launch_count[n] - before[n] for n in before}
    bitwise = all(
        torch.equal(o_v[i], fa.flash_attention(q[i], k[i], v[i]))
        and all(torch.equal(a[i], b) for a, b in
                zip(g_v, grad(q[i], k[i], v[i], do[i])))
        for i in range(g))
    qf, kf, vf, dof = (x.reshape(g * bh, t, d) for x in (q, k, v, do))
    o_f, lse = fa.flash_fwd(qf, kf, vf)
    delta = fa.flash_delta(o_f, dof)
    bq, bk = FLASH_BQ, FLASH_BK
    errs = _errors((
        ("o", o_v.reshape(g * bh, t, d), fa.flash_fwd_ref(qf, kf, vf, bq,
                                                          bk)[0]),
        ("dq", g_v[0].reshape(g * bh, t, d),
         fa.flash_dq_ref(qf, kf, vf, dof, lse, delta, bq, bk)),
        *zip(("dk", "dv"), (x.reshape(g * bh, t, d) for x in g_v[1:]),
             fa.flash_dkv_ref(qf, kf, vf, dof, lse, delta, bq, bk))),
        f"qlora (c) folded at G {g}, BH {bh}, T {t}", FLASH_TOL["bf16"])
    same_fold = torch.equal(o_f, o_v.reshape(g * bh, t, d))
    # the group's folded launches against its clients' launches one by
    # one (CUDA-event medians): the forward, and the gradient (forward,
    # delta, dQ, dK/dV)
    vfwd = torch.func.vmap(fa.flash_attention)
    vgrad = torch.func.vmap(grad)
    fold_ms = {
        "fwd": time_ms(lambda: vfwd(q, k, v)),
        "fwd_per_client": time_ms(lambda: [fa.flash_attention(
            q[i], k[i], v[i]) for i in range(g)]),
        "grad": time_ms(lambda: vgrad(q, k, v, do)),
        "grad_per_client": time_ms(lambda: [grad(q[i], k[i], v[i], do[i])
                                            for i in range(g)]),
        "fwd_plain": time_ms(lambda: fa.flash_fwd_ref(qf, kf, vf, bq, bk),
                             n=10, warmup=2),
        "fwd_library": time_ms(lambda: F.scaled_dot_product_attention(
            qf[None], kf[None], vf[None], is_causal=True))}
    fold_bound = _bound(*_cost().flash_cost("fwd", g * bh, t, d, 2),
                        torch.bfloat16, bw)
    del q, k, v, do, o_v, g_v, qf, kf, vf, dof, o_f, lse, delta
    gc.collect()
    torch.cuda.empty_cache()

    dims = dataclasses.replace(LLAMA2_7B, n_layers=QLORA_LAYERS)
    L = QLORA_LAYERS
    state = init_params(dims, seed=0, dtype=torch.bfloat16, device=DEV)
    data = _token_data(dims.vocab_size, seed=0)
    tr = TrainArgs(epochs=1, batch_size=TRAIN_BS, learning_rate=1e-3,
                   compute_dtype="bfloat16")
    alg, adapters, _fn = _fed_lora(dims, state, tr, flash=True)
    ids = np.arange(TRAIN_CLIENTS)
    weights = np.full((TRAIN_CLIENTS,), float(TRAIN_SEQS), np.float32)
    sched = [make_batch_indices(client_generator(7, int(c)), TRAIN_SEQS,
                                TRAIN_BS, 1) for c in ids]
    steps = TRAIN_SEQS // TRAIN_BS
    rounds = {}
    for group in (1, g):
        fn = build_round_fn(alg, group_size=group)
        fa.launch_count.update(dict.fromkeys(fa.launch_count, 0))
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = fn(alg.server_init(adapters), None, data, ids, weights, seed=7,
               batch_idx=sched)
        loss_v = o.metrics["train_loss"].item()
        torch.cuda.synchronize()
        rounds[group] = {"round_s": time.perf_counter() - t0,
                         "train_loss": loss_v,
                         "launches": dict(fa.launch_count),
                         "peak_bytes": torch.cuda.max_memory_allocated(),
                         "params": o.server_state.params}
    update = _max_abs_diff(rounds[1]["params"], adapters)
    diff = _max_abs_diff(rounds[g]["params"], rounds[1]["params"])
    for r in rounds.values():
        del r["params"]
    res = {"fold": {"group": g, "shape": [bh, t, d], "launches": fold,
                    "bitwise_per_client": bitwise,
                    "folded_is_one_launch": same_fold, "errors": errs,
                    "ms": fold_ms, "fwd_bound": fold_bound},
           "layers": L, "rounds": rounds, "max_abs_adapter_diff": diff,
           "max_abs_adapter_update": update,
           "ratio": diff / update if update else float("inf"),
           "tol": QLORA_VMAP_TOL, "launches": rounds[g]["launches"]}
    emit({"phase": "qlora", "part": "c_vmapped_lora", **res})
    zero = dict.fromkeys(fa.launch_count, 0)
    check(fold == {**zero, "fwd_tc": 2, "dq_tc": 1, "dkv_tc": 1},
          f"qlora (c): the folded passes launched {fold}, not K1 twice "
          "(forward, and the grad's forward), K2 and K3 once")
    check(bitwise and same_fold, "qlora (c): the folded launches are not "
          "the per-client launches bit for bit")
    for group, n in ((1, TRAIN_CLIENTS * steps), (g, steps)):
        want = {**zero, "fwd_tc": 2 * L * n, "dq_tc": L * n, "dkv_tc": L * n}
        check(rounds[group]["launches"] == want,
              f"qlora (c): G = {group} launched {rounds[group]['launches']}"
              f" != {want}")
    check(update > 0 and diff <= QLORA_VMAP_TOL * update,
          f"qlora (c): G = {g} round {diff} from G = 1's, over "
          f"{QLORA_VMAP_TOL} x its update {update}")
    del state, data, alg, adapters, rounds, o
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _qlora_rank_d(cfg: dict) -> dict:
    """Phase qlora (d) in one gloo rank: the f32 seq round at the dims
    `cfg["dims"]` (7B width, QLORA_LAYERS layers) on the (silos 1, seq 2)
    mesh, ring and Ulysses, over the float and the int8 base, sequences
    of `cfg["seq_t"]` tokens; rank 0 also the (silos 1, seq 1) round of
    each (a prefix mesh without rank 1). The dims come as an argument and
    the device from the rank, so that a CPU rehearsal can cut them."""
    import torch

    from fedml_tpu_torch.config import TrainArgs
    from fedml_tpu_torch.core.algorithm import ServerState
    from fedml_tpu_torch.llm import (
        make_fedllm_seq_round, quant, shard_fedllm_data,
    )
    from fedml_tpu_torch.llm.lora import lora_init
    from fedml_tpu_torch.llm.transformer import (
        ModelDims, TransformerLM, init_params,
    )
    from fedml_tpu_torch.parallel import mesh as mesh_mod
    from fedml_tpu_torch.parallel.launch import current

    info = current()
    dev = info.device
    cuda = dev.type == "cuda"
    dims = ModelDims(**cfg["dims"])
    state = init_params(dims, seed=0, dtype=torch.float32, device=dev)
    qstate = quant.quantize_tree_int8(state)
    model = TransformerLM.from_state(dims, state)
    gen = torch.Generator(device=dev).manual_seed(5)
    ads = lora_init(state, LORA_RANK, generator=gen)
    for ab in ads.values():
        ab["b"] = 0.05 * torch.randn(ab["b"].shape, generator=gen, device=dev)
    meshes = (("seq2", mesh_mod.make_mesh({"silos": 1, "seq": 2})),
              ("seq1", mesh_mod.make_mesh({"silos": 1, "seq": 1})))
    rng = np.random.default_rng(13)
    seqs = rng.integers(0, dims.vocab_size,
                        (TRAIN_CLIENTS, QLORA_SEQS, cfg["seq_t"] + 1))
    raw = {"x": seqs[..., :-1], "y": seqs[..., 1:],
           "mask": np.ones((TRAIN_CLIENTS, QLORA_SEQS), np.float32)}
    t = TrainArgs(epochs=1, batch_size=1, learning_rate=1e-2,
                  compute_dtype="float32")
    ids = np.arange(TRAIN_CLIENTS)
    w = np.full(TRAIN_CLIENTS, float(QLORA_SEQS))
    k0 = _k1_k4()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    runs = {}
    for attn in ("ring", "ulysses"):
        for inscan in (False, True):
            res = {}
            for tag, m in meshes:
                if not mesh_mod.in_mesh(m):
                    continue
                rnd = make_fedllm_seq_round(
                    model, qstate if inscan else state, t, m, attn=attn,
                    inscan_quant=inscan)
                data = shard_fedllm_data(raw, m, device=dev)
                if cuda:
                    torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                st, met = rnd(ServerState(ads, None, 0), data, ids, w,
                              seed=0)
                if cuda:
                    torch.cuda.synchronize(dev)
                res[tag] = {"seconds": time.perf_counter() - t0,
                            "train_loss": float(met["train_loss"]),
                            "params": {k: {n: x.cpu().numpy()
                                           for n, x in ab.items()}
                                       for k, ab in st.params.items()}}
            runs[attn + ("_inscan" if inscan else "")] = res
    return {"rank": info.rank, "backend": info.backend, "runs": runs,
            "start": {k: {n: x.cpu().numpy() for n, x in ab.items()}
                      for k, ab in ads.items()},
            "k1_k4": _k1_k4() - k0,
            "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda
            else 0}


def _qlora_d(pool) -> dict:
    """Phase qlora (d): two gloo ranks sharing the card run `_qlora_rank_d`;
    each (silos 1, seq 2) round within QLORA_SEQ_TOL of the (silos 1,
    seq 1) round, the two ranks' adapters the same bit for bit."""
    from fedml_tpu_torch.llm.transformer import LLAMA2_7B

    outs = pool.run(_qlora_rank_d, {
        "dims": dataclasses.asdict(dataclasses.replace(
            LLAMA2_7B, n_layers=QLORA_LAYERS)), "seq_t": QLORA_SEQ_T})
    r0, r1 = outs
    atol, rtol = QLORA_SEQ_TOL
    res = {"backend": r0["backend"], "seq_len": QLORA_SEQ_T,
           "k1_k4": [o["k1_k4"] for o in outs],
           "peak_bytes": [o["peak_bytes"] for o in outs], "runs": {}}
    for name, runs in r0["runs"].items():
        a, b = runs["seq2"]["params"], runs["seq1"]["params"]
        err = max(float(np.abs(a[k][n] - b[k][n]).max()) for k in a
                  for n in ("a", "b"))
        upd = max(float(np.abs(b[k][n] - r0["start"][k][n]).max())
                  for k in b for n in ("a", "b"))
        within = all(np.allclose(a[k][n], b[k][n], rtol=rtol, atol=atol)
                     for k in a for n in ("a", "b"))
        same_ranks = all(np.array_equal(a[k][n],
                                        r1["runs"][name]["seq2"]["params"][k][n])
                         for k in a for n in ("a", "b"))
        res["runs"][name] = {
            "max_abs_err": err, "max_update": upd, "within_tol": within,
            "ranks_bitwise": same_ranks,
            "loss_seq2": runs["seq2"]["train_loss"],
            "loss_seq1": runs["seq1"]["train_loss"],
            "seconds_seq2": runs["seq2"]["seconds"],
            "seconds_seq1": runs["seq1"]["seconds"]}
    emit({"phase": "qlora", "part": "d_seq_round_gloo", **res})
    for name, r in res["runs"].items():
        check(r["max_update"] > 0 and r["within_tol"],
              f"qlora (d) {name}: seq 2 is {r['max_abs_err']} from seq 1, "
              f"outside atol {atol} / rtol {rtol}")
        check(r["ranks_bitwise"], f"qlora (d) {name}: the ranks' adapters "
              "differ")
        check(np.isclose(r["loss_seq2"], r["loss_seq1"], rtol=rtol,
                         atol=atol), f"qlora (d) {name}: losses "
              f"{r['loss_seq2']} vs {r['loss_seq1']}")
    return res


def phase_qlora(reqs, bw: float) -> dict:
    """Phase 20 (module docstring)."""
    import torch

    from fedml_tpu_torch.ops import flash_attention as fa
    from fedml_tpu_torch.ops import paged_attention as pa
    from fedml_tpu_torch.parallel.launch import RankPool

    t0 = time.perf_counter()
    fa.launch_count.update(dict.fromkeys(fa.launch_count, 0))
    pa.launch_count = 0
    # (d)'s two ranks reach the card while (a)-(c) run here
    pool = RankPool([DEV, DEV], timeout_s=QLORA_TIMEOUT_S,
                    setup=_qlora_rank_setup)
    res = {}

    def part(name, fn, *args):
        t1 = time.perf_counter()
        out = fn(*args)
        res[name] = out[0] if isinstance(out, tuple) else out
        res[name]["part_seconds"] = time.perf_counter() - t1
        emit({"phase": "qlora", "part": name,
              "seconds": res[name]["part_seconds"]})
        return out

    try:
        _res, qstate, ads = part("a", _qlora_a, reqs)
        part("b", _qlora_b, qstate, ads)
        del qstate, ads
        gc.collect()
        torch.cuda.empty_cache()
        part("c", _qlora_c, bw)
        part("d", _qlora_d, pool)
    finally:
        res["d_exitcodes"] = pool.close()
    res["seconds"] = time.perf_counter() - t0
    emit({"phase": "qlora", "d_exitcodes": res["d_exitcodes"],
          "nvidia_smi": nvidia_smi_line(), "seconds": res["seconds"]})
    check(res["d_exitcodes"] == [0, 0],
          f"qlora (d): rank exit codes {res['d_exitcodes']}")
    return res

# ------------------------------------------------------------- phase 21
def _k4_counts() -> dict:
    from fedml_tpu_torch.ops import paged_attention as pa

    with pa._count_lock:
        return {"launches": pa.launch_count, "by_c": dict(pa.launches_by_c),
                "by_h": dict(pa.launches_by_h)}


def _k4_reset() -> None:
    from fedml_tpu_torch.ops import paged_attention as pa

    with pa._count_lock:
        pa.launch_count = 0
        pa.launches_by_c.clear()
        pa.launches_by_h.clear()


def _tp_wave(model, ads, reqs, dev, mesh, margins: bool = False,
             **kw) -> dict:
    """One engine wave over `reqs` (every rank of `mesh` runs it; the
    leader submits): K4's counts from the engine's start to its stop,
    the decode steps, the leader's tokens and wall seconds; with
    `margins`, each request's top-2 margin at every pick
    (`_record_margins`)."""
    from fedml_tpu_torch.serving.engine import DecodeEngine

    _k4_reset()
    eng = DecodeEngine(model, ads, n_slots=N_SLOTS, max_len=MAX_LEN,
                       page_size=PS, prefill_chunk=PREFILL_CHUNK,
                       paged_kernel=True, mesh=mesh, device=dev,
                       **kw)
    rec = _record_margins(eng) if margins else None
    eng.start()
    outs, wall, picks = None, None, None
    if eng._leader:
        t0 = time.perf_counter()
        tickets = [eng.submit(p, n) for p, n in reqs]
        outs = [t.result(timeout=600) for t in tickets]
        wall = time.perf_counter() - t0
        if rec is not None:
            picks = [rec.get(id(t), []) for t in tickets]
    eng.stop()
    res = {**_k4_counts(), "decode_steps": eng.decode_steps,
           "outs": outs, "wall_s": wall, "margins": picks}
    del eng
    gc.collect()
    return res


def _tp_rank_a(cfg: dict) -> dict:
    """Phase tp (a) and (a') in one gloo rank: the mp = 2 engine with K4
    on the rank's 16 heads. (a) bf16 at 7B width and TP_A_LAYERS layers,
    rank-8 adapters, spec_k 4 (K4 at C = 5), the first TP_WAVE
    requests; rank 0 then serves them unmeshed (tokens reported). (a')
    f32 at TP_F32_LAYERS layers, TF32 off: the mp = 2 kernel engine, over
    an f32 and an int8 pool, against the unmeshed kernel engine under the
    near-tie rule (rank 0 checks)."""
    import torch

    from fedml_tpu_torch.llm.lora import lora_init
    from fedml_tpu_torch.llm.transformer import (
        ModelDims, TransformerLM, init_params,
    )
    from fedml_tpu_torch.parallel import mesh as mesh_mod
    from fedml_tpu_torch.parallel.launch import current

    info = current()
    dev = info.device
    cuda = dev.type == "cuda"
    mesh = mesh_mod.make_mesh({"mp": 2})
    reqs = [tuple(r) for r in cfg["reqs"]]
    out = {"rank": info.rank, "backend": info.backend}
    # (a) bf16, the main path
    dims = ModelDims(**{**cfg["dims"], "n_layers": TP_A_LAYERS})
    t0 = time.perf_counter()
    model = TransformerLM.from_state(dims, init_params(
        dims, seed=0, dtype=torch.bfloat16, device=dev))
    gen = torch.Generator(device=dev).manual_seed(7)
    ads = lora_init(model.state_dict(), rank=LORA_RANK, generator=gen)
    for ab in ads.values():
        ab["b"] = 0.05 * torch.randn(ab["b"].shape, generator=gen,
                                     device=dev)
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    out["init_s"] = time.perf_counter() - t0
    a = _tp_wave(model, ads, reqs, dev, mesh, spec_decode="ngram",
                 spec_k=SPEC_K)
    a["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if info.rank == 0:
        ref = _tp_wave(model, ads, reqs, dev, None, spec_decode="ngram",
                       spec_k=SPEC_K)
        a["unmeshed_identical"] = sum(x == y for x, y in zip(a["outs"],
                                                             ref["outs"]))
        a["unmeshed_ms_per_decode_step"] = (ref["wall_s"] * 1e3
                                            / ref["decode_steps"])
    out["a"] = a
    del model, ads
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    # (a') the f32 gate
    dims = ModelDims(**{**cfg["dims"], "n_layers": TP_F32_LAYERS})
    model = TransformerLM.from_state(dims, init_params(
        dims, seed=1, dtype=torch.float32, device=dev))
    checks = [(p, min(n, TP_F32_NEW)) for p, n in reqs]
    # the f32 TP forward against the whole model's on one prompt
    from fedml_tpu_torch.llm import tp as tp_mod

    toks = torch.tensor([reqs[0][0]], device=dev)
    with torch.no_grad():
        got = tp_mod.tp_model(dims, tp_mod.shard_params_tp(
            model.state_dict(), mesh, "mp"), mesh, "mp")(toks)
        want = model(toks)
    out["a2_logits_max_rel_diff"] = float(
        (got - want).abs().max() / want.abs().max())
    for pool in ("f32", "int8"):
        kw = {"kv_quant": "int8"} if pool == "int8" else {}
        w = _tp_wave(model, None, checks, dev, mesh, margins=True, **kw)
        if info.rank == 0:
            # the reference engine's own margins at each pick: an int8
            # pool's rounding moves its logits, so the float model's
            # margin (reported beside it) is not the reference's
            ref = _tp_wave(model, None, checks, dev, None, margins=True,
                           **kw)
            w["diffs"] = [(i, j, None if j is None
                           else ref["margins"][i][j])
                          for i, j in _diff_picks(ref["outs"], w["outs"])]
            w["float_margins"] = [_top2_margin(model, checks[i][0]
                                               + ref["outs"][i][:j])
                                  for i, j, _m in w["diffs"]
                                  if j is not None]
            # the meshed engine's own margin at the same pick
            w["mesh_margins"] = [w["margins"][i][j]
                                 for i, j, _m in w["diffs"] if j is not None]
        out["a2_" + pool] = w
    return out


def _tp_rank_b(cfg: dict) -> dict:
    """Phase tp (b) in one gloo rank: `build_scaled_fedllm` over (dp 1,
    tp 2) with an injected int8 base at 7B width (the same full base in
    both ranks, each keeping its shard) and the flash kernels on the
    rank's heads, once for each of `cfg["dtypes"]`; K1-K3 counted; in
    bf16 the sharded checkpoint written, read back and compared; rank 0
    then runs the same steps at tp = 1 (a prefix mesh)."""
    import tempfile

    import torch

    from fedml_tpu_torch.llm import quant, scale
    from fedml_tpu_torch.llm.lora import lora_init
    from fedml_tpu_torch.llm.transformer import ModelDims, TransformerLM
    from fedml_tpu_torch.ops import flash_attention as fa
    from fedml_tpu_torch.parallel import mesh as mesh_mod
    from fedml_tpu_torch.parallel.launch import current

    info = current()
    dev = info.device
    cuda = dev.type == "cuda"
    dims = ModelDims(**cfg["dims"])
    gen = torch.Generator(device=dev).manual_seed(11)
    full = quant.synth_quantized_base(scale.state_shapes(dims), gen,
                                      device=dev)
    ads = lora_init(scale._shape_leaves(dims, dev), rank=LORA_RANK,
                    generator=gen)
    for ab in ads.values():
        ab["b"] = 0.05 * torch.randn(ab["b"].shape, generator=gen,
                                     device=dev)
    rng = np.random.default_rng(12)
    seqs = torch.from_numpy(rng.integers(
        0, dims.vocab_size, (cfg["bs"], cfg["t"] + 1))).to(dev)
    x, y = seqs[:, :-1], seqs[:, 1:]
    meshes = {"tp2": mesh_mod.make_mesh({"dp": 1, "tp": 2}),
              "tp1": mesh_mod.make_mesh({"dp": 1, "tp": 1})}
    attn = fa.flash_attn_fn if cuda else None
    out = {"rank": info.rank, "full_bytes": quant.quant_bytes(full)}
    runs = [(tag, m, dt) for dt in cfg["dtypes"] for tag, m in meshes.items()]
    for tag, m, dt in runs:
        if not mesh_mod.in_mesh(m):
            continue
        fa.launch_count.update(dict.fromkeys(fa.launch_count, 0))
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        _m, base, a, step = scale.build_scaled_fedllm(
            TransformerLM, m, **dataclasses.asdict(dims), rank=LORA_RANK,
            lr=cfg["lr"], seq_axis=None, quantize_base=True, base=full,
            adapters=ads, attn_fn=attn, compute_dtype=dt, device=dev)
        a0 = {k: {c: t.float().cpu() for c, t in ab.items()}
              for k, ab in a.items()}
        losses, secs = [], []
        for _ in range(cfg["steps"]):
            if cuda:
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            a, loss = step(a, x, y)
            losses.append(float(loss))
            secs.append(time.perf_counter() - t0)
        # each adapter leaf's change over the steps, and its largest
        # entry at the start
        r = {"losses": losses, "seconds": secs,
             "update": {f"{k}.{c}": (t.float().cpu() - a0[k][c]).numpy()
                        for k, ab in a.items() for c, t in ab.items()},
             "start_max": {f"{k}.{c}": float(t.abs().max())
                           for k, ab in a0.items() for c, t in ab.items()},
             "launches": dict(fa.launch_count),
             "base_bytes": quant.quant_bytes(base),
             "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda
             else 0}
        if tag == "tp2" and dt == "bfloat16":
            with tempfile.TemporaryDirectory() as tmp:
                path = tmp if info.rank == 0 else None
                path = mesh_mod.broadcast_object(path, m, "tp")
                t0 = time.perf_counter()
                scale.save_base_sharded(path, base, m)
                got = scale.restore_base_sharded(path, base, m, device=dev)
                r["ckpt_s"] = time.perf_counter() - t0
                fb, fg = quant.flat_state(base), quant.flat_state(got)
                r["ckpt_bitwise"] = fb.keys() == fg.keys() and all(
                    torch.equal(fb[k], fg[k]) for k in fb)
                mesh_mod.barrier(m)
        out[tag if dt == "bfloat16" else f"{tag}_{dt}"] = r
        del base, a, step, _m
        gc.collect()
    return out


def _tp_rank_c(cfg: dict) -> dict:
    """Phase tp (c) in one gloo rank: the centralized trainer on the
    flagship ResNet-18-GN over {"mp": 2}, one epoch from the same seeded
    start, in f64 and in f32 (TF32 off); rank 0 then the same epochs at
    {"mp": 1} (a prefix mesh rank 1 also builds). The whole parameters
    gathered back and K1-K4 counted."""
    import torch

    import fedml_tpu_torch
    from fedml_tpu_torch.centralized import CentralizedTrainer
    from fedml_tpu_torch.models import hub
    from fedml_tpu_torch.parallel import mesh as mesh_mod
    from fedml_tpu_torch.parallel import partition
    from fedml_tpu_torch.parallel.launch import current

    info = current()
    dev = info.device
    k0 = _k1_k4()
    p0 = hub.init_params(hub.create("resnet18_gn", 10, (32, 32, 3),
                                    device="meta"),
                         torch.Generator(device=dev).manual_seed(0))
    out = {"rank": info.rank}
    for dt in ("float64", "float32"):
        start = {k: v.to(getattr(torch, dt)) for k, v in p0.items()}
        out[dt] = {"start": {k: v.cpu().numpy() for k, v in start.items()}}
        for mp in (2, 1):
            d = {**cfg["config"], "device_args": {"mesh_shape": {"mp": mp}}}
            if mp == 1 and info.rank != 0:
                mesh_mod.make_mesh({"mp": 1})  # every rank builds each mesh
                continue
            tr = CentralizedTrainer(fedml_tpu_torch.init(
                config=d, device=str(dev)), params=start)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            hist = tr.run(epochs=1)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            secs = time.perf_counter() - t0
            whole = partition.unshard_params(tr.params, tr.mesh,
                                             tr.param_specs)
            out[dt][f"mp{mp}"] = {
                "seconds": secs, "train_loss": hist[0]["train_loss"],
                "params": {k: v.cpu().numpy() for k, v in whole.items()},
                "split": sum("mp" in tuple(sp) for sp in
                             tr.param_specs.values()),
                "leaves": len(tr.param_specs)}
    out["k1_k4"] = _k1_k4() - k0
    return out


def _tp_b_readings(t2: dict, t1: dict, t2_other: dict) -> dict:
    """Phase tp (b)'s readings of one pass (rank 0's tp 2 and tp 1 runs,
    rank 1's tp 2 run): every step's loss against tp 1's; the worst
    adapter leaf's change over the steps against tp 1's change of it,
    over the largest change of any leaf (wq's and wk's adapters barely
    move from a random start, so a leaf's own change is below the f32
    resolution of its entries), and that leaf; how far the adapters
    moved (the largest change over its leaf's largest start entry); the
    ranks' replicas bitwise."""
    top = max(float(np.abs(u).max()) for u in t1["update"].values())
    errs = {k: float(np.abs(t2["update"][k] - u).max())
            for k, u in t1["update"].items()}
    worst = max(errs, key=errs.get)
    return {
        "losses_tp2": t2["losses"], "losses_tp1": t1["losses"],
        "loss_rel_diff": max(abs(x - y) / abs(y) for x, y in
                             zip(t2["losses"], t1["losses"])),
        "update_rel_err": errs[worst] / top, "update_max": top,
        "worst_leaf": [worst, float(np.abs(t1["update"][worst]).max()),
                       errs[worst]],
        "adapter_moved": max(float(np.abs(u).max()) / t1["start_max"][k]
                             for k, u in t1["update"].items()),
        "replicas_bitwise": all(np.array_equal(u, t2_other["update"][k])
                                for k, u in t2["update"].items()),
        "seconds_per_step_tp2": t2["seconds"],
        "seconds_per_step_tp1": t1["seconds"],
        "launches_per_rank": [t2["launches"], t2_other["launches"]],
        "peak_bytes_per_rank": [t2["peak_bytes"], t2_other["peak_bytes"]]}


def phase_tp() -> dict:
    """Phase 21 (module docstring)."""
    from fedml_tpu_torch.llm.transformer import LLAMA2_7B
    from fedml_tpu_torch.parallel.launch import RankPool

    t0 = time.perf_counter()
    pool = RankPool([DEV, DEV], timeout_s=TP_TIMEOUT_S,
                    setup=_qlora_rank_setup)
    res = {}
    try:
        t1 = time.perf_counter()
        ra = pool.run(_tp_rank_a, {
            "dims": dataclasses.asdict(LLAMA2_7B),
            "reqs": _requests(LLAMA2_7B.vocab_size)[:TP_WAVE]})
        res["a_seconds"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        rb = pool.run(_tp_rank_b, {
            "dims": dataclasses.asdict(dataclasses.replace(
                LLAMA2_7B, n_layers=TP_B_LAYERS)),
            "bs": TP_B_BS, "t": TP_B_T, "steps": TP_B_STEPS,
            "lr": TP_B_LR, "dtypes": ("bfloat16", "float32")})
        res["b_seconds"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        rc = pool.run(_tp_rank_c, {"config": _tp_c_config()})
        res["c_seconds"] = time.perf_counter() - t1
    finally:
        res["exitcodes"] = pool.close()
    L = TP_A_LAYERS
    # every part's readings first, then every bar
    for pool_kind in ("f32", "int8"):
        w0, w1 = ra[0]["a2_" + pool_kind], ra[1]["a2_" + pool_kind]
        res["a2_" + pool_kind] = {
            "launches_per_rank": [w0["launches"], w1["launches"]],
            "by_h": [w0["by_h"], w1["by_h"]],
            "decode_steps": w0["decode_steps"], "diffs": w0["diffs"],
            "mesh_engine_margins": w0["mesh_margins"],
            "float_model_margins": w0["float_margins"]}
        emit({"phase": "tp", "part": f"a2_f32_gate_{pool_kind}_pool",
              "logits_max_rel_diff": ra[0]["a2_logits_max_rel_diff"],
              **res["a2_" + pool_kind]})
    a0, a1 = ra[0]["a"], ra[1]["a"]
    res["a"] = {
        "launches_per_rank": [a0["launches"], a1["launches"]],
        "by_h": [a0["by_h"], a1["by_h"]], "by_c": [a0["by_c"], a1["by_c"]],
        "decode_steps": a0["decode_steps"],
        "ms_per_decode_step": a0["wall_s"] * 1e3 / a0["decode_steps"],
        "unmeshed_ms_per_decode_step": a0["unmeshed_ms_per_decode_step"],
        "wall_s": a0["wall_s"], "init_s": [ra[0]["init_s"], ra[1]["init_s"]],
        "peak_bytes_per_rank": [a0["peak_bytes"], a1["peak_bytes"]],
        "tokens": sum(len(o) for o in a0["outs"]),
        "unmeshed_identical": f"{a0['unmeshed_identical']}/{TP_WAVE}"}
    emit({"phase": "tp", "part": "a_engine_bf16", **res["a"]})
    b0, b1 = rb[0], rb[1]
    res["b"] = {dt: _tp_b_readings(b0[f"tp2{sfx}"], b0[f"tp1{sfx}"],
                                   b1[f"tp2{sfx}"])
                for dt, sfx in (("bfloat16", ""), ("float32", "_float32"))}
    res["b"].update({
        "lr": TP_B_LR,
        "base_bytes_per_rank": [b0["tp2"]["base_bytes"],
                                b1["tp2"]["base_bytes"]],
        "full_base_bytes": b0["full_bytes"],
        "base_share": b0["tp2"]["base_bytes"] / b0["full_bytes"],
        "ckpt_bitwise": [b0["tp2"]["ckpt_bitwise"],
                         b1["tp2"]["ckpt_bitwise"]],
        "ckpt_s": b0["tp2"]["ckpt_s"]})
    emit({"phase": "tp", "part": "b_scaled_step_int8", **res["b"]})
    c0, c1 = rc[0], rc[1]
    res["c"] = {"leaves": c0["float64"]["mp2"]["leaves"],
                "split_leaves": c0["float64"]["mp2"]["split"],
                "k1_k4": [c0["k1_k4"], c1["k1_k4"]]}
    for dt in ("float64", "float32"):
        want = c0[dt]["mp1"]["params"]
        worst = {}
        for got in (c0[dt]["mp2"]["params"], c1[dt]["mp2"]["params"]):
            for k, v in want.items():
                den = np.abs(v) * 1e-4 + 1e-5
                worst[k] = max(worst.get(k, 0.0),
                               float((np.abs(got[k] - v) / den).max()))
        err = max(float(np.abs(c0[dt]["mp2"]["params"][k] - v).max())
                  for k, v in want.items())
        upd = max(float(np.abs(v - c0[dt]["start"][k]).max())
                  for k, v in want.items())
        res["c"][dt] = {
            "max_abs_err": err, "max_update": upd,
            "err_of_update": err / upd,
            "worst_share_of_bar": max(worst.values()),
            "seconds_mp2": [c0[dt]["mp2"]["seconds"],
                            c1[dt]["mp2"]["seconds"]],
            "seconds_mp1": c0[dt]["mp1"]["seconds"],
            "train_loss_mp2": c0[dt]["mp2"]["train_loss"],
            "train_loss_mp1": c0[dt]["mp1"]["train_loss"]}
    # f32 against f64 from the same start, at mp 1 and at mp 2: how far
    # the cell itself carries f32 rounding in one epoch
    for mp in ("mp1", "mp2"):
        want, got = c0["float64"][mp]["params"], c0["float32"][mp]["params"]
        err = max(float(np.abs(got[k] - v).max()) for k, v in want.items())
        res["c"][f"f32_vs_f64_{mp}_err_of_update"] = (
            err / res["c"]["float64"]["max_update"])
    emit({"phase": "tp", "part": "c_centralized_mp2", **res["c"]})
    # (a') the f32 gate under the near-tie rule, each margin the
    # reference engine's own at the first differing pick
    for pool_kind in ("f32", "int8"):
        res["a2_" + pool_kind].update(_near_tie_check(
            ra[0]["a2_" + pool_kind]["diffs"], TP_WAVE, phase="tp"))
    for pool_kind in ("f32", "int8"):
        for r in (ra[0]["a2_" + pool_kind], ra[1]["a2_" + pool_kind]):
            check(r["launches"] == TP_F32_LAYERS * r["decode_steps"] > 0
                  and r["by_h"] == {H // 2: r["launches"]},
                  f"tp (a') {pool_kind}: K4 launches {r['by_h']}")
    # (a) the bf16 engine: K4 on each rank's own 16 heads, every launch a
    # verify window (C = spec_k + 1), layers x windows a rank
    check(all(len(o) == n for o, (_p, n) in zip(
        a0["outs"], _requests(32000)[:TP_WAVE])),
        "tp (a): a ticket ended short of max_new_tokens")
    for r in (a0, a1):
        check(r["decode_steps"] == a0["decode_steps"] > 0,
              "tp (a): the ranks stepped differently")
        check(r["launches"] == L * r["decode_steps"]
              and r["by_h"] == {H // 2: r["launches"]}
              and r["by_c"] == {SPEC_K + 1: r["launches"]},
              f"tp (a): K4 launches {r['by_h']} / {r['by_c']} != {L} x "
              f"{r['decode_steps']} windows at H {H // 2}, C {SPEC_K + 1}")
    # (b) the scaled step: K1-K3 in both passes, the bf16 pass's losses
    # and the f32 pass's adapters against tp 1's
    n = TP_B_LAYERS * TP_B_STEPS
    for r in (b0["tp2"], b1["tp2"]):
        check(r["ckpt_bitwise"], "tp (b): the checkpoint did not round-trip")
        check(0.45 <= r["base_bytes"] / b0["full_bytes"] <= 0.6,
              f"tp (b): a rank holds {r['base_bytes']} of "
              f"{b0['full_bytes']} base bytes")
    for dt, route in (("bfloat16", "tc"), ("float32", "3xtf32")):
        rd = res["b"][dt]
        for r in rd["launches_per_rank"]:
            check(r[f"fwd_{route}"] == 2 * n
                  and r[f"dq_{route}"] == r[f"dkv_{route}"] == n,
                  f"tp (b) {dt}: K1-K3 launches {r} != 2 x {n}, {n}, {n}")
        check(all(np.isfinite(rd["losses_tp2"])),
              f"tp (b) {dt}: a loss is not finite")
        check(rd["adapter_moved"] >= TP_B_MOVED, f"tp (b) {dt}: the "
              f"adapters moved {rd['adapter_moved']} of their largest "
              "entry, too little to check their change")
        check(rd["replicas_bitwise"], f"tp (b) {dt}: the ranks' adapters "
              "differ")
    check(res["b"]["bfloat16"]["loss_rel_diff"] <= TP_B_TOL,
          f"tp (b): a bf16 tp 2 loss is "
          f"{res['b']['bfloat16']['loss_rel_diff']} from tp 1's")
    check(res["b"]["float32"]["update_rel_err"] <= TP_B_UPD_TOL,
          f"tp (b): an f32 adapter leaf's change over the steps is "
          f"{res['b']['float32']['update_rel_err']} of the largest change "
          "from tp 1's")
    # (c) the centralized trainer at mp 2 against mp 1, in f64: in f32 the
    # two sum in other orders (the split halves each conv's output
    # channels, and cuDNN picks its algorithm by shape), and the epoch
    # carries that rounding on; the f32 distances are reported beside
    # each f32 run's distance from f64
    c64 = res["c"]["float64"]
    check(res["c"]["leaves"] == 62, "tp (c): ResNet-18-GN has not 62 leaves")
    check(c64["worst_share_of_bar"] <= 1.0,
          "tp (c): f64 mp 2's parameters are outside rtol 1e-4 / atol 1e-5 "
          "of mp 1's")
    check(np.isclose(c64["train_loss_mp2"], c64["train_loss_mp1"],
                     rtol=1e-4, atol=1e-6), "tp (c): the f64 losses differ")
    check(res["c"]["k1_k4"] == [0, 0], "tp (c): K1-K4 launched")
    res["seconds"] = time.perf_counter() - t0
    emit({"phase": "tp", "exitcodes": res["exitcodes"],
          "a_seconds": res["a_seconds"], "b_seconds": res["b_seconds"],
          "c_seconds": res["c_seconds"], "nvidia_smi": nvidia_smi_line(),
          "seconds": res["seconds"]})
    check(res["exitcodes"] == [0, 0], f"tp: rank exit codes "
          f"{res['exitcodes']}")
    return res


def _tp_c_config() -> dict:
    """Phase tp (c)'s config: the flagship's model, batch and shapes over
    TP_C_CLIENTS clients of synthetic CIFAR-10 images (TP_C_SAMPLES
    asked for each, the loader's floor of 500 in all), f32."""
    d = _flagship_dict(client_num_in_total=TP_C_CLIENTS,
                       client_num_per_round=TP_C_CLIENTS,
                       batch_size=TP_C_BATCH, compute_dtype="float32")
    d["data_args"]["synthetic_samples_per_client"] = TP_C_SAMPLES
    return d


# ------------------------------------------------------------- phase 22
def _example_reading(out: dict) -> dict:
    """The numbers an example's `main` returned: its final reading."""
    return {k: v for k, v in out.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)}


def phase_examples() -> dict:
    """Phase 22 (module docstring): the 12 cases of tests/test_examples.py
    through `fedml_tpu_torch.examples`, in this process, on the card."""
    import importlib
    import os
    import tempfile

    import torch

    import fedml_tpu_torch.api as api
    from fedml_tpu_torch.examples import CASES, kernel_launches, summed

    t0 = time.perf_counter()
    res = {"cases": {}}
    saved = api._REGISTRY, api._PROFILE
    with tempfile.TemporaryDirectory(prefix="chip-smoke-ex-") as tmp:
        api._REGISTRY = os.path.join(tmp, "models")
        api._PROFILE = os.path.join(tmp, "profile.json")
        try:
            for name, flags in CASES:
                case = name + "".join(" " + f for f in flags)
                main = importlib.import_module(
                    f"fedml_tpu_torch.examples.{name}").main
                kernel_launches(reset=True)
                t1 = time.perf_counter()
                out = main(["--device", DEV, *flags])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t1
                # a mesh case's launches happen in its ranks
                ranks = out.get("rank_launches")
                launches = summed([kernel_launches()]
                                  + ([ranks] if ranks else []))
                line = {"phase": "examples", "case": case, "wall_s": wall,
                        "final": _example_reading(out),
                        "k1_k4_launches": launches}
                if ranks:
                    line["rank_launches"] = ranks
                res["cases"][case] = {k: line[k] for k in (
                    "wall_s", "final", "k1_k4_launches")}
                emit(line)
                check(not any(launches.values()),
                      f"examples: {case} launched a flash or paged kernel "
                      f"(the examples use dense attention and the "
                      f"contiguous decode): {launches}")
        finally:
            api._REGISTRY, api._PROFILE = saved
    res["seconds"] = time.perf_counter() - t0
    emit({"phase": "examples", "cases": len(res["cases"]),
          "nvidia_smi": nvidia_smi_line(), "seconds": res["seconds"]})
    check(len(res["cases"]) == len(CASES), "examples: a case is missing")
    return res


def kernel_rows(kern: dict, runs: dict, flash: dict, train: dict,
                surface: dict, every_phase: bool, fleet=None,
                qlora=None, tp=None) -> list:
    """The `kernels` line's rows from the phases' results; with
    `every_phase`, also checks that each kernel was launched where it
    should have been. The bf16 K4 row carries phase fleet's main-path
    launches (its loadgen wave over two replicas) as `fleet_launches`,
    and phase qlora's (the engine over the int8 7B base) as
    `qlora_launches`; the bf16 K1-K3 rows carry phase qlora's vmapped
    LoRA round (G = 2, one launch a layer and pass a group step) as
    `qlora_launches`; the K1-K3 rows of each dtype carry phase tp's
    scaled step (b) in that dtype (the ranks' sum) as `tp_launches`. K4 at phase tp's head split (H 16 a rank, its own
    pool) has rows of its own, their `launches` the ranks' sum on
    phase tp's main paths: bf16 at C = 5 from (a), the f32 and int8 pools
    under f32 q from (a'); the bf16 and int8 rows carry their C = 1 H 16
    case, checked and timed in phase kernel, as `head_split_h16`."""
    qlora = qlora or {}
    tp = tp or {}
    split = kern.get("head_split", {})
    kernels = []
    for kind, k in kern.items():
        if kind == "head_split":
            continue
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
        if kind == "bf16":
            kernels[-1]["fleet_launches"] = (fleet or {}).get(
                "a", {}).get("launches", 0)
            kernels[-1]["qlora_launches"] = qlora.get("a", {}).get(
                "int8_wave", {}).get("launches", 0)
        if kind in ("bf16", "int8") and kind in split:
            kernels[-1]["head_split_h16"] = split[kind]
    # K4 at the head split on phase tp's main paths
    for name, case, part in (("paged_attention_bf16_c5_h16", "bf16_c5", "a"),
                             ("paged_attention_f32_h16", "f32", "a2_f32"),
                             ("paged_attention_int8_f32q_h16", "int8_f32q",
                              "a2_int8")):
        if case not in split:
            continue
        c = split[case]
        per_rank = tp.get(part, {}).get("launches_per_rank", [0])
        kernels.append({
            "name": name, "route": "cuda", "design": "split-page",
            "source": "fedml_tpu_torch/csrc/paged_attention.cu",
            "replaces": "fedml_tpu/ops/paged_attention.py:84",
            "heads": c["heads"], "C": c["C"], "q_dtype": c["q_dtype"],
            "launches": sum(per_rank), "launches_per_rank": per_rank,
            "max_abs_err": c["max_abs_err"],
            "max_row_rel_err": c["max_row_rel_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"]})
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
        if dt == "bf16":
            kernels[-1]["qlora_launches"] = qlora.get("c", {}).get(
                "launches", {}).get(counter, 0)
        # phase tp (b)'s bf16 pass (the main path) and its f32 pass
        kernels[-1]["tp_launches"] = sum(
            r.get(counter, 0) for r in tp.get("b", {}).get(
                {"bf16": "bfloat16", "f32": "float32"}[dt], {}).get(
                    "launches_per_rank", []))
        fold = qlora.get("c", {}).get("fold")
        if fold and counter == "fwd_tc":
            # K1 over the vmapped group (G x BH folded into one launch)
            m, b = fold["ms"], fold["fwd_bound"]
            kernels[-1]["qlora_fold"] = {
                "shape": [fold["group"] * fold["shape"][0]]
                + fold["shape"][1:], "ms": m["fwd"],
                "per_client_ms": m["fwd_per_client"],
                "plain_ms": m["fwd_plain"], "library_ms": m["fwd_library"],
                "bound_ms": b["bound_ms"], "bound_by": b["bound_by"]}
    # no kernel can beat the least time the card needs for its work
    flash_rows = [k for k in kernels if "d40" in k]
    every_time = kernels + [k["d40"] for k in flash_rows] + [
        k["d40"]["at_flagship"] for k in flash_rows] + [
        k["qlora_fold"] for k in kernels if "qlora_fold" in k] + [
        k["head_split_h16"] for k in kernels if "head_split_h16" in k]
    check(all(k["ms"] >= k["bound_ms"] for k in every_time),
          "a kernel's time is below its bound: the bound is wrong")
    if tp:
        check(all(k["launches"] > 0 for k in kernels if "heads" in k),
              "K4 at the head split was never launched by phase tp")
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
        check(all(k["fleet_launches"] > 0 for k in kernels
                  if "fleet_launches" in k),
              "K4 was never launched by phase fleet's main path")
        check(all(k["qlora_launches"] > 0 for k in kernels
                  if "qlora_launches" in k),
              "a kernel was never launched by phase qlora's main paths")
        check(all(k["tp_launches"] > 0 for k in kernels
                  if "tp_launches" in k),
              "a flash kernel was never launched by phase tp (b)")
    return kernels


class _Lane:
    """The second lane: LANE_B's phases in a child process (this script
    with --lane, in a process group of its own) beside the first lane's
    here, on the same card. Its JSON lines go to a file and are printed
    here when it has ended; a lane that fails fails the script, and
    `stop` ends the child and every process it started."""

    def __init__(self, phases: list, work: str):
        import os

        self.work = work
        self.out_path = os.path.join(work, "lane.jsonl")
        self._out = open(self.out_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--only", *phases,
             "--lane", work],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=self._out, process_group=0)

    def stop(self) -> None:
        import os
        import signal

        with contextlib.suppress(ProcessLookupError):
            os.killpg(self.proc.pid, signal.SIGKILL)
        self.proc.wait()

    def _relay(self) -> None:
        self._out.close()
        with open(self.out_path) as f:
            sys.stdout.write(f.read())
        sys.stdout.flush()

    def poll(self) -> None:
        """Fail at once when the lane has already failed."""
        if self.proc.poll() not in (None, 0):
            self._relay()
            check(False, f"the second lane failed (exit "
                  f"{self.proc.returncode})")

    def join(self, timeout: float) -> dict:
        """Wait for the lane; its phase lines printed here, and what it
        hands on (`_lane_main`) returned."""
        import os

        import torch

        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.stop()
            self._relay()
            check(False, f"the second lane did not end within {timeout:.0f}"
                  f" s of the join")
        self._relay()
        check(rc == 0, f"the second lane failed (exit {rc})")
        return torch.load(os.path.join(self.work, "lane.pt"),
                          weights_only=False)


def _phase_runner(selected, lock: str, lane_no: int, poll=None):
    """`run(name, fn, *a, default=None)`: phase `name` when it is in
    `selected`, its wall seconds on a line of its own; `default`
    otherwise. A phase in HEAVY first takes the lock file `lock`, which
    both lanes share, and gives back its memory before it lets go; `poll`
    is called before each phase."""
    import fcntl
    import os

    import torch

    t_zero = float(os.environ.get("CHIP_SMOKE_T0", time.time()))

    def run(name, fn, *a, default=None):
        if name not in selected:
            return default
        if poll is not None:
            poll()
        with open(lock, "a") as f:
            t1 = time.perf_counter()
            if name in HEAVY:
                fcntl.flock(f, fcntl.LOCK_EX)
            t2 = time.perf_counter()
            try:
                out = fn(*a)
                wall = time.perf_counter() - t2
                gc.collect()
                torch.cuda.empty_cache()
            finally:
                if name in HEAVY:
                    fcntl.flock(f, fcntl.LOCK_UN)
        emit({"phase": name, "wall_s": wall, "lane": lane_no,
              "lock_wait_s": t2 - t1,
              "resident_bytes": torch.cuda.memory_allocated(),
              "end_s": time.time() - t_zero})
        return out

    return run


def _lane_main(selected, work: str) -> int:
    """The second lane (`_Lane`): LANE_B's phases in their order, then
    what phase cross_silo_secure needs of phase cross_silo saved under
    `work`. The first lane's earlier phases leave TF32 off (phases engine
    and train), cuDNN deterministic (the first Simulator) and vmap's
    fallback an error (phase fedsim) for every phase after them; this
    process starts from the same settings."""
    import os
    import warnings

    import torch

    from fedml_tpu_torch._device import deterministic_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    deterministic_cuda(torch.device(DEV))
    warnings.filterwarnings("error", message=VMAP_FALLBACK)
    cpu_rounds = start_cpu_rounds() if "fedavg" in selected else None
    run = _phase_runner(selected, os.path.join(work, "card.lock"), 2)
    run("mesh", phase_mesh)
    fedavg = run("fedavg", phase_fedavg, cpu_rounds)
    run("fedavg_profile", phase_fedavg_profile)
    fedsim = run("fedsim", phase_fedsim, fedavg, default={})
    run("plugins", phase_plugins)
    cross_silo = run("cross_silo", phase_cross_silo,
                     fedsim.get("flagship", {}).get(1), default={})
    run("standalone", phase_standalone, fedsim.get("flagship"))
    run("examples", phase_examples)
    torch.save({"cross_silo_flagship": cross_silo.get("flagship"),
                "card_params": cross_silo.get("bars", {}).get(
                    "card_params")}, os.path.join(work, "lane.pt"))
    sys.stdout.flush()
    # end here: a thread a phase left behind (a server waiting out its
    # timeout) would hold the interpreter's exit, and the first lane
    # waits for this one
    atexit._run_exitfuncs()
    os._exit(0)


def main() -> int:
    import os
    import shutil
    import signal
    import tempfile

    t_start = time.perf_counter()
    # the second lane inherits the first's start, and its lines count
    # from it
    os.environ.setdefault("CHIP_SMOKE_T0", repr(time.time()))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", choices=PHASES + OPTIONAL,
                    default=PHASES, help="run only these phases (device and "
                    "build always run; profile only when named)")
    ap.add_argument("--lane", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this smoke run needs one "
              "GPU", file=sys.stderr)
        return 2
    if args.lane:
        return _lane_main(args.only, args.lane)
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

    work = tempfile.mkdtemp(prefix="chip-smoke-")
    atexit.register(shutil.rmtree, work, True)
    second = [p for p in LANE_B if p in args.only]
    lane = None

    def start_lane():
        nonlocal lane
        lane = _Lane(second, work)
        atexit.register(lane.stop)

        def on_term(signum, frame):
            lane.stop()
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)

        signal.signal(signal.SIGTERM, on_term)

    run = _phase_runner([p for p in args.only if p not in second],
                        os.path.join(work, "card.lock"), 1,
                        poll=lambda: lane and lane.poll())
    # the kernels' timings first, alone on the card
    kern = run("kernel", phase_kernel, bw, default={})
    flash = run("flash", phase_flash, bw, default={})
    if second:
        start_lane()
    reqs = _requests(32000)
    runs = {}   # pool kind -> the main-path wave that used it
    if "engine" in args.only:
        runs["f32"] = run("engine", phase_engine, reqs)
    runs.update(run("serve", phase_serve, reqs, default={}))
    surface = run("serve_surface", phase_serve_surface, reqs, runs,
                  default={})
    run("profile", phase_profile, reqs)
    train = run("train", phase_train, default={"launches": {}})
    run("train_profile", phase_train_profile)
    run("tasks", phase_tasks)
    run("runtimes", phase_runtimes)
    run("entry", phase_entry, surface)
    qlora = run("qlora", phase_qlora, reqs, bw, default={})
    tp = run("tp", phase_tp, default={})
    # last here: the second lane's fedsim and plugins are done by then
    fleet = run("fleet", phase_fleet, default={})
    t1 = time.perf_counter()
    handed = lane.join(LANE_JOIN_S - (t1 - t_start)) if lane else {}
    emit({"phase": "lanes", "join_wait_s": time.perf_counter() - t1,
          "end_s": time.perf_counter() - t_start})
    run("cross_silo_secure", phase_cross_silo_secure,
        handed.get("cross_silo_flagship"), handed.get("card_params"))

    kernels = kernel_rows(kern, runs, flash, train, surface,
                          every_phase=set(PHASES) <= set(args.only),
                          fleet=fleet, qlora=qlora, tp=tp)
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
