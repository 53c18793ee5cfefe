// Causal flash attention for NVIDIA Hopper (sm_90a): forward (K1), dQ (K2)
// and dK/dV (K3).
//
// Replaces the Pallas TPU kernels of fedml_tpu/ops/flash_attention.py by
// tensor-core kernels chosen with one shape rule (ops/flash_attention.py):
// every head of the contract (D % 8 == 0, D <= 128) runs each pass on the
// tensor cores, bf16 in one pass and f32 in three TF32 passes:
//   K1 _fwd_kernel  (launched by _flash_fwd)   -> flash_fwd_tc_kernel,
//                                                 flash_fwd_3xtf32_kernel
//   K2 _dq_kernel   (launched by _pallas_bwd)  -> flash_dq_tc_kernel,
//                                                 flash_dq_3xtf32_kernel
//   K3 _dkv_kernel  (launched by _pallas_bwd)  -> flash_dkv_tc_kernel,
//                                                 flash_dkv_3xtf32_kernel
// Contract, shared with the plain PyTorch versions in
// ops/flash_attention.py (flash_fwd_ref / flash_dq_ref / flash_dkv_ref):
//
//   q, k, v, o, do, dq, dk, dv  [BH, T, D] contiguous, float or bf16 (all
//                               alike), D <= 128
//   lse, delta                  [BH, T] float32
//
// Query row i attends keys j <= i. Scores are (q . k) * D^-0.5 in f32 (the
// scale applied after the dot), masked with -1e30; the forward folds K
// tiles in with an online softmax (running max m, sum l, o accumulator, all
// f32), rounds p to V's dtype before P.V, and writes o / max(l, 1e-30) in
// q's dtype and lse = m + log(max(l, 1e-30)). The backward recomputes
// p = exp(s - lse) (0 where masked) and dS = p * (dP - delta) * scale with
// dP = dO . V^T; K2 rounds dS to K's dtype before dS . K, K3 rounds p to
// dO's dtype before P^T . dO and dS to Q's dtype before dS^T . Q -- the
// rounding points of the TPU kernels (flash_attention.py:91, :225, :254,
// :257). f32 products keep f32 accuracy (the TPU kernels use
// Precision.HIGHEST for f32, a multi-pass bf16 product): three TF32 passes
// over a hi/lo split of each operand (~21 bits a product, f32 sums), never
// one TF32 pass (~10 bits).
//
// The TPU kernels carry their accumulators in VMEM across a sequential grid
// axis; Hopper blocks run in no order, so that axis becomes a loop inside
// one block: K2 one block per q tile, looping over the K tiles up to the
// diagonal (the causal skip of :213); K3 one block per key tile, looping
// over the q tiles from the diagonal on (the skip of :244). The backward
// stays two kernels, so every sum has one owner and a fixed order: no
// atomics. The ragged tile at T's end is masked inside the kernels, so any
// T >= 1 is taken.
//
// What bounds them on the H100: at T = 2048, D = 128 attention does ~1000
// flops per byte of q/k/v/o, far above the ridge, so the floor is the
// products' flops over the tensor-core peak: 989 TFLOP/s in bf16; in f32
// at full accuracy three TF32 passes at 495 TFLOP/s, 165 a product (the
// CUDA cores' f32 peak is 67).
//
// Every kernel takes any D % 8 == 0 on an instance of kD = 64 or
// 128 columns (D rounded up): their loads zero-fill every 16-byte chunk
// past D, so the columns past D add nothing to Q.K^T, and their stores
// write only d < D; the softmax scale is the real D's.
//
// The bf16 forward (flash_fwd_tc_kernel) runs both products on the tensor
// cores with wgmma (bf16 in, f32 accumulate in registers): one block of two
// warpgroups per (bh, 128-row q tile), each warpgroup owning 64 query rows.
// Q and the K/V tiles of 64 keys are bf16 in shared memory in the 128-byte
// swizzle wgmma's descriptors read (64-column blocks of 128-byte rows, each
// row's 16-byte chunks XOR-ed by the row's low 3 bits), the K/V tiles in a
// ring of two stages filled by cp.async: the next tile's copy is in flight
// behind the current tile's products. S = Q.K^T (m64n64k16, both operands
// from shared memory, K-major) lands in registers; the online softmax
// reduces each row over the four lanes that share it in the accumulator
// layout; P is rounded to bf16 and fed from registers as the A operand of
// O += P.V (m64n128k16, V read MN-major). Tiles past the diagonal are never
// loaded, the causal mask is applied only on tiles that reach past a warp's
// first row, and a warpgroup whose rows all precede a tile skips it. Rows
// past T and columns past D are zero-filled on load and never stored. One
// block per SM (157 registers a thread); still left: TMA-fed tiles and
// warp specialisation, so that one warpgroup's softmax overlaps the other's
// products.
//
// The bf16 backward on the tensor cores keeps the two passes, each bound
// like the forward by its products' flops (three products per tile in
// K2, four in K3, against the two the backward must do per pass), and
// reuses the forward's machinery: the swizzled cp.async tiles, the
// m64n64k16 product from shared memory and the m64nDk16 product with A
// from registers, and the fragment map that turns an accumulator into an A
// operand. p = exp(s * scale - lse) and dS = p (dP - delta) scale are
// computed in registers from unrounded f32 p; they never touch shared
// memory.
//   flash_dq_tc_kernel (K2): one block of two warpgroups per (bh, 128-row
//     q tile), each owning 64 rows, the longest tiles first. Q and dO
//     stay in shared memory, K/V tiles of 64 keys stream through the
//     forward's two-stage ring up to the diagonal, lse and delta of the
//     thread's two rows sit in registers. S = Q.K^T and dP = dO.V^T read
//     both operands K-major; dS, rounded to bf16, is the A operand of
//     dQ += dS.K, which reads the same K tile MN-major (as P.V reads V).
//     184 registers at D 128.
//   flash_dkv_tc_kernel (K3): one block of two warpgroups per (bh,
//     128-key tile), each owning 64 keys; the first key tiles, which see
//     the most q tiles, first. K and V stay in shared memory; q tiles of
//     64 rows from the diagonal on stream through a two-stage ring that
//     also carries their 64 lse and delta values. The tiles are
//     transposed (a row is a key, a column a query): S^T = K.Q^T and
//     dP^T = V.dO^T from shared memory (K-major), then dV += P^T.dO and
//     dK += dS^T.Q with P^T and dS^T rounded to bf16 in registers and dO
//     and Q read MN-major. A query is masked where it precedes the key or
//     lies past T (a zero-filled Q row scores 0, but its lse and delta
//     mean nothing). dK, dV, S^T and dP^T take 192 f32 registers a thread:
//     252 in all at D 128, no spills, one block per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kMaxD = 128;

// ------------------------------------------------------ K1, tensor cores
// bf16, every D % 8 == 0 (the backward kernels too). kD (64 or 128) is D
// rounded up: columns past D are zero in shared memory (they add
// nothing to Q.K^T) and are never stored.
//
// Register fragments (g = lane / 4, t = lane % 4; warp w of a warpgroup
// owns its rows 16w .. 16w+15): an f32 accumulator of wgmma.m64nNk16 holds,
// for each 8-column block j, d[j][0..1] = (row g, cols 8j+2t, +1) and
// d[j][2..3] = (row g+8, same cols); an A operand from registers (m64k16)
// holds a0 = (g, k 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..), a3 =
// (g+8, 2t+8..), two bf16 per register. Hence S's accumulators over keys
// 16kk..16kk+15 (blocks 2kk, 2kk+1), rounded to bf16, are exactly P's A
// operand for the kk-th k-step of P.V.
namespace tc {

constexpr int kBM = 128;      // q rows per block: 2 warpgroups x 64
constexpr int kBN = 64;       // keys per K/V tile
constexpr int kThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

// two f32 values rounded to bf16 (nearest-even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------- wgmma (sm_90a only)
// the descriptors' layout types (bits 62-63): 128-byte and 64-byte swizzle
constexpr uint64_t kSwizzle128 = 1, kSwizzle64 = 2;

// shared-memory matrix descriptor: start address, leading and stride byte
// offsets (all in 16-byte units), layout type
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout = kSwizzle128) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// registers an asynchronous wgmma wrote are read only after this
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(r[i][e])::"memory");
}

// S (m64n64, f32) = A . B with A and B in shared memory (K-major
// descriptors); `accumulate` 0 overwrites S
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// O (m64n64, f32) += A . B with A in registers (per warp, the A layout
// of mma.m16n8k16) and B in shared memory (MN-major descriptor)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (m64n128, f32) += A . B with A in registers (per warp, the A layout
// of mma.m16n8k16) and B in shared memory (MN-major descriptor)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// byte offset of 16-byte chunk c of row r in a [rows][kD] bf16 tile laid
// out for wgmma: kD / 64 column blocks of [rows][128 B] one after another,
// each in the 128-byte swizzle (chunk c ^ (r % 8) within its row)
template <int ROWS>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>((c >> 3) * ROWS * 128 + r * 128 +
                               (((c & 7) ^ (r & 7)) << 4));
}

// rows [row0, row0 + ROWS) of a [T, D] bf16 matrix -> such a tile, by
// cp.async; rows past T and columns past D are zero-filled
template <int ROWS, int kD>
__device__ __forceinline__ void load_tile(uint32_t tile, const __nv_bfloat16* src,
                                          int row0, int T_, int D) {
  constexpr int kChunks = kD / 8;
#pragma unroll
  for (int it = 0; it < ROWS * kChunks / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x;
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = row0 + r < T_ && c * 8 < D;
    const __nv_bfloat16* p = ok ? src + static_cast<size_t>(row0 + r) * D + c * 8 : src;
    fedml::cp_async16(tile + swz<ROWS>(r, c), p, ok ? 16 : 0);
  }
}

// the cp.async writes of this thread's finished groups, and (after the
// barrier) of every thread's, become visible to wgmma's async reads
__device__ __forceinline__ void tiles_arrived() {
  fedml::cp_async_wait<0>();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// D (m64n64, f32) = A . B^T over kD columns, both from shared memory,
// K-major: A is the 64 rows at `a` of a tile of AROWS rows, B a tile of kBN
// rows. A descriptor's start address counts 16-byte units: k-step kk moves
// 32 bytes along a 128-byte row, and every fourth one to the next 64-column
// block, AROWS (kBN) x 128 bytes on.
template <int kD, int AROWS>
__device__ __forceinline__ void ss_product(float (&d)[kBN / 8][4], uint32_t a, uint32_t b) {
  const uint64_t da = gmma_desc(a, 16, 1024), db = gmma_desc(b, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma_ss_n64(d, da + (((kk >> 2) * (AROWS * 128) + (kk & 3) * 32) >> 4),
                 db + (((kk >> 2) * (kBN * 128) + (kk & 3) * 32) >> 4), kk > 0);
}

// D (m64 x kD, f32) += A . B: A from registers (kBN / 16 k-steps), B a tile
// of kBN rows read MN-major (the next 64 columns kBN x 128 bytes on, 8 rows
// 1024 bytes on; k-step kk moves 16 rows)
template <int kD>
__device__ __forceinline__ void rs_product(float (&d)[kD / 8][4],
                                           const uint32_t (&a)[kBN / 16][4], uint32_t b) {
  const uint64_t db = gmma_desc(b, kBN * 128, 1024);
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    if constexpr (kD == 128) wgmma_rs_n128(d, a[kk], db + ((kk * 16 * 128) >> 4));
    else wgmma_rs_n64(d, a[kk], db + ((kk * 16 * 128) >> 4));
  }
}

// an m64n64 f32 accumulator rounded to bf16 as the A operand of a product
// over its 64 columns (the fragment map above)
__device__ __forceinline__ void pack_a(uint32_t (&a)[kBN / 16][4], const float (&s)[kBN / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    a[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    a[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    a[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// rows g and g + 8 of the warp's 16 (row0 = the first) of an m64 x kD f32
// accumulator -> bf16 rows of a [T, D] matrix; rows past T and columns
// past D are not stored
template <int kD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float (&acc)[kD / 8][4],
                                           int row0, int T_, int D) {
  const int g = (threadIdx.x & 31) >> 2, t4 = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= T_) continue;
    __nv_bfloat16* out = dst + static_cast<size_t>(row) * D;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      const int d = 8 * n + 2 * t4;
      if (d < D)
        *reinterpret_cast<__nv_bfloat162*>(out + d) =
            __floats2bfloat162_rn(acc[n][2 * h], acc[n][2 * h + 1]);
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                        int T_, int D, float scale) {
  constexpr int kTile = kBN * kD * 2;  // bytes of one K or V tile
  extern __shared__ __align__(1024) unsigned char smem_tc[];
  const uint32_t q_s = fedml::smem_addr(smem_tc);
  const uint32_t kv_s = q_s + kBM * kD * 2;  // stage st: K, then V

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;  // longest tiles first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wg = warp >> 2;                 // warpgroup: rows 64 wg .. 64 wg + 63
  const int r0 = warp * 16;                 // the warp's first row in the tile
  const size_t base = static_cast<size_t>(bh) * T_ * D;
  const int n_kt = min((q0 + kBM + kBN - 1) / kBN, (T_ + kBN - 1) / kBN);
  const float scale_log2 = scale * kLog2e;

  load_tile<kBM, kD>(q_s, q + base, q0, T_, D);
  load_tile<kBN, kD>(kv_s, k + base, 0, T_, D);
  load_tile<kBN, kD>(kv_s + kTile, v + base, 0, T_, D);
  fedml::cp_async_commit();

  float acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_kt; ++j) {
    tiles_arrived();
    if (j + 1 < n_kt) {
      const uint32_t nxt = kv_s + ((j + 1) & 1) * 2 * kTile;
      load_tile<kBN, kD>(nxt, k + base, (j + 1) * kBN, T_, D);
      load_tile<kBN, kD>(nxt + kTile, v + base, (j + 1) * kBN, T_, D);
      fedml::cp_async_commit();
    }
    const int k0 = j * kBN;
    if (k0 > q0 + 64 * wg + 63) continue;  // every key past every row of the warpgroup
    const uint32_t k_s = kv_s + (j & 1) * 2 * kTile, v_s = k_s + kTile;

    float s[kBN / 8][4];
    wgmma_fence();
    ss_product<kD, kBM>(s, q_s + wg * 64 * 128, k_s);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);

    if (k0 + kBN - 1 > q0 + r0) {
      // key > row  <=>  8n + (e & 1) - 8 (e >> 1) > row_g - (k0 + 2 t4)
      const int lim = q0 + r0 + g - k0 - 2 * t4;
#pragma unroll
      for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * n + (e & 1) - 8 * (e >> 1) > lim) s[n][e] = kNeg;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNeg;
#pragma unroll
      for (int n = 0; n < kBN / 8; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx * scale);
      const float corr = exp2f((m[h] - m_new) * kLog2e);
      const float m_log2 = m_new * kLog2e;
      m[h] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          const float p = exp2f(fmaf(s[n][e], scale_log2, -m_log2));
          s[n][e] = p;
          sum += p;
        }
      l[h] = l[h] * corr + sum;
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        acc[n][2 * h] *= corr;
        acc[n][2 * h + 1] *= corr;
      }
    }
    uint32_t a[kBN / 16][4];
    pack_a(a, s);
    wgmma_fence();
    rs_product<kD>(acc, a, v_s);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = q0 + r0 + g + 8 * h;
    if (row >= T_) continue;
    const float den = fmaxf(l[h], 1e-30f);
    __nv_bfloat16* orow = o + base + static_cast<size_t>(row) * D;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      const int d = 8 * n + 2 * t4;
      if (d < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + d) =
            __floats2bfloat162_rn(acc[n][2 * h] / den, acc[n][2 * h + 1] / den);
    }
    if (t4 == 0) lse[static_cast<size_t>(bh) * T_ + row] = m[h] + logf(den);
  }
}

// ------------------------------------------------------ K2, tensor cores
// dQ of one 128-row q tile, each warpgroup owning 64 rows. Q and dO stay in
// shared memory; K/V tiles of 64 keys stream through K1's two-stage ring.
// S = Q.K^T and dP = dO.V^T from shared memory (K-major), p and dS in
// registers, dQ += dS.K with dS from registers and K read MN-major.
template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, int T_, int D, float scale) {
  constexpr int kTile = kBN * kD * 2;  // bytes of one K or V tile
  extern __shared__ __align__(1024) unsigned char smem_tc[];
  const uint32_t q_s = fedml::smem_addr(smem_tc);
  const uint32_t do_s = q_s + kBM * kD * 2;
  const uint32_t kv_s = do_s + kBM * kD * 2;  // stage st: K, then V

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;  // longest tiles first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wg = warp >> 2;
  const int r0 = warp * 16;
  const size_t base = static_cast<size_t>(bh) * T_ * D;
  const int n_kt = min((q0 + kBM + kBN - 1) / kBN, (T_ + kBN - 1) / kBN);
  const float scale_log2 = scale * kLog2e;

  load_tile<kBM, kD>(q_s, q + base, q0, T_, D);
  load_tile<kBM, kD>(do_s, dout + base, q0, T_, D);
  load_tile<kBN, kD>(kv_s, k + base, 0, T_, D);
  load_tile<kBN, kD>(kv_s + kTile, v + base, 0, T_, D);
  fedml::cp_async_commit();

  // lse (times log2 e) and delta of the thread's rows g and g + 8
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + g + 8 * h;
    const size_t at = static_cast<size_t>(bh) * T_ + min(row, T_ - 1);
    lse2[h] = row < T_ ? lse[at] * kLog2e : 0.f;
    dlt[h] = row < T_ ? delta[at] : 0.f;
  }
  float acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < n_kt; ++j) {
    tiles_arrived();
    if (j + 1 < n_kt) {
      const uint32_t nxt = kv_s + ((j + 1) & 1) * 2 * kTile;
      load_tile<kBN, kD>(nxt, k + base, (j + 1) * kBN, T_, D);
      load_tile<kBN, kD>(nxt + kTile, v + base, (j + 1) * kBN, T_, D);
      fedml::cp_async_commit();
    }
    const int k0 = j * kBN;
    if (k0 > q0 + 64 * wg + 63) continue;  // every key past every row of the warpgroup
    const uint32_t k_s = kv_s + (j & 1) * 2 * kTile, v_s = k_s + kTile;

    float s[kBN / 8][4], dp[kBN / 8][4];
    wgmma_fence();
    ss_product<kD, kBM>(s, q_s + wg * 64 * 128, k_s);
    ss_product<kD, kBM>(dp, do_s + wg * 64 * 128, v_s);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);
    fence_regs(dp);

    // p = exp(s * scale - lse), 0 where key > row (only on tiles that reach
    // past the warp's first row: elsewhere lim is past every column);
    // dS = p (dP - delta) scale with p unrounded, then rounded to bf16
    // key > row  <=>  8n + (e & 1) - 8 (e >> 1) > row_g - (k0 + 2 t4)
    const int lim = k0 + kBN - 1 > q0 + r0 ? q0 + r0 + g - k0 - 2 * t4 : kBN;
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float p = 8 * n + (e & 1) - 8 * h > lim
                            ? 0.f : exp2f(fmaf(s[n][e], scale_log2, -lse2[h]));
        s[n][e] = p * (dp[n][e] - dlt[h]) * scale;
      }
    uint32_t a[kBN / 16][4];
    pack_a(a, s);
    wgmma_fence();
    rs_product<kD>(acc, a, k_s);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
  }
  store_rows<kD>(dq + base, acc, q0 + r0, T_, D);
}

// ------------------------------------------------------ K3, tensor cores
// dK and dV of one 128-key tile, each warpgroup owning 64 keys, over the q
// tiles of 64 rows from the diagonal on. K and V stay in shared memory; Q,
// dO and the tile's 64 lse and delta values stream through a two-stage
// ring. The tiles are transposed (a row is a key, a column a query):
// S^T = K.Q^T and dP^T = V.dO^T from shared memory (all K-major), then
// dV += P^T.dO and dK += dS^T.Q with P^T and dS^T from registers and dO
// and Q read MN-major. P and dS never touch shared memory.
template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dkv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                        int T_, int D, float scale) {
  constexpr int kTile = kBN * kD * 2;  // bytes of one Q or dO tile
  extern __shared__ __align__(1024) unsigned char smem_tc[];
  const uint32_t k_s = fedml::smem_addr(smem_tc);
  const uint32_t v_s = k_s + kBM * kD * 2;
  const uint32_t ring = v_s + kBM * kD * 2;  // stage st: Q, then dO
  // after the ring, stage st: kBN lse values, then kBN delta values
  const float* vec = reinterpret_cast<const float*>(smem_tc + 2 * kBM * kD * 2 + 4 * kTile);

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBM;  // the first key tiles have the most q tiles
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wg = warp >> 2;                 // warpgroup: keys 64 wg .. 64 wg + 63
  const int r0 = warp * 16;                 // the warp's first key in the tile
  const size_t base = static_cast<size_t>(bh) * T_ * D;
  const float* lse_bh = lse + static_cast<size_t>(bh) * T_;
  const float* dlt_bh = delta + static_cast<size_t>(bh) * T_;
  const int qt0 = k0 / kBN;  // q tiles before it hold only masked queries
  const int n_qt = (T_ + kBN - 1) / kBN;
  const float scale_log2 = scale * kLog2e;

  // q tile i into ring stage st; lse and delta past T are zeros
  auto load_step = [&](int i, int st) {
    const int q0 = i * kBN;
    load_tile<kBN, kD>(ring + st * 2 * kTile, q + base, q0, T_, D);
    load_tile<kBN, kD>(ring + st * 2 * kTile + kTile, dout + base, q0, T_, D);
    if (threadIdx.x < 2 * kBN) {
      const int c = threadIdx.x & (kBN - 1);
      const bool ok = q0 + c < T_;
      fedml::cp_async4(fedml::smem_addr(vec + st * 2 * kBN + threadIdx.x),
                       (threadIdx.x < kBN ? lse_bh : dlt_bh) + (ok ? q0 + c : 0), ok ? 4 : 0);
    }
    fedml::cp_async_commit();
  };

  load_tile<kBM, kD>(k_s, k + base, k0, T_, D);
  load_tile<kBM, kD>(v_s, v + base, k0, T_, D);
  load_step(qt0, 0);

  float acc_k[kD / 8][4], acc_v[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  for (int i = qt0; i < n_qt; ++i) {
    const int st = (i - qt0) & 1;
    tiles_arrived();
    if (i + 1 < n_qt) load_step(i + 1, st ^ 1);
    const int q0 = i * kBN;
    if (q0 + kBN - 1 < k0 + 64 * wg) continue;  // every query before every key of the warpgroup
    const uint32_t q_s = ring + st * 2 * kTile, do_s = q_s + kTile;
    const float* lse_s = vec + st * 2 * kBN;
    const float* dlt_s = lse_s + kBN;

    float s[kBN / 8][4], dp[kBN / 8][4];
    wgmma_fence();
    ss_product<kD, kBM>(s, k_s + wg * 64 * 128, q_s);
    ss_product<kD, kBM>(dp, v_s + wg * 64 * 128, do_s);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);
    fence_regs(dp);

    // p = 0 where query < key or query >= T (rows past T are zero-filled,
    // but their lse and delta mean nothing); the comparisons are exact on
    // every tile, so none is skipped by a branch:
    // query < key   <=>  8n + (e & 1) - 8 (e >> 1) < key_g - (q0 + 2 t4)
    // query >= T    <=>  8n + (e & 1) >= T - (q0 + 2 t4)
    const int lim = k0 + r0 + g - q0 - 2 * t4, lim_t = T_ - q0 - 2 * t4;
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * n + 2 * t4);
      const float2 d2 = *reinterpret_cast<const float2*>(dlt_s + 8 * n + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + (e & 1);
        const float p = (c - 8 * (e >> 1) < lim || c >= lim_t)
                            ? 0.f
                            : exp2f(fmaf(s[n][e], scale_log2, -(e & 1 ? l2.y : l2.x) * kLog2e));
        s[n][e] = p;  // rounded to bf16 only for P^T.dO
        dp[n][e] = p * (dp[n][e] - (e & 1 ? d2.y : d2.x)) * scale;
      }
    }
    uint32_t a_p[kBN / 16][4], a_ds[kBN / 16][4];
    pack_a(a_p, s);
    pack_a(a_ds, dp);
    wgmma_fence();
    rs_product<kD>(acc_v, a_p, do_s);
    rs_product<kD>(acc_k, a_ds, q_s);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc_v);
    fence_regs(acc_k);
  }
  store_rows<kD>(dk + base, acc_k, k0 + r0, T_, D);
  store_rows<kD>(dv + base, acc_v, k0 + r0, T_, D);
}

// ------------------------------------------ K1 in f32, three-pass TF32
// f32, every D % 8 == 0 (kD = 64 or 128, D rounded up: columns past D are
// zero in shared memory and never stored). Same structure as the bf16
// forward: one block of two warpgroups per (bh, 128-row q tile), each
// owning 64 rows; S = Q.K^T from shared memory, the online softmax in
// registers, O += P.V with P from registers. What differs is how a product
// is made: every f32 operand x is split as hi = cvt.rna.tf32(x), lo = x - hi
// (exact in f32), and a product is A_lo.B_hi + A_hi.B_lo + A_hi.B_hi, three
// m64nNk8 TF32 wgmma passes into one f32 accumulator, small terms first.
// The tensor cores read the low 13 bits of lo as zero, an error near 2^-22
// of x; the products keep ~21 bits (ops/flash_attention.py:matmul_3xtf32 is
// the plain emulation).
//
// TF32 wgmma takes both operands K-major (no transpose for 32-bit types),
// so P.V needs V^T: the kernel writes it when it stages V. A TF32 A operand
// from registers holds columns t and t + 4 of each 8-column k-step, while
// S's accumulator holds columns 2t and 2t + 1: V^T takes each group of 8
// keys in the order kPerm = [0, 2, 4, 6, 1, 3, 5, 7], so that S's
// accumulator is P's A operand without moving a value between lanes.
//
// Shared memory, kD = 128 (a 128-byte row is 32 f32, one TF32 k-step 32
// bytes, so the bf16 kernels' swizzle and descriptors carry over on
// 32-column blocks): Q hi + lo resident, 128 KB; K hi + lo and V^T hi + lo
// of the current tile of kBN3 = 32 keys, 64 KB; a landing buffer for the
// next raw K and V tile, filled by cp.async behind the current tile's
// products, 32 KB: 224 KB of the 227 a block may hold. Each tile is split
// once, by all 256 threads, between two barriers.
//
// Bound at BH 64, T 2048, D 128: 68.7 GFLOP of products, three TF32 passes
// each, over 495 TFLOP/s = 0.416 ms.
constexpr int kBN3 = 32;  // keys per K/V tile

// x rounded to TF32 (nearest, ties away from zero): the low 13 bits are 0
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

__device__ __forceinline__ void split4(const float4 x, float4& hi, float4& lo) {
  hi = make_float4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z), tf32_rna(x.w));
  lo = make_float4(x.x - hi.x, x.y - hi.y, x.z - hi.z, x.w - hi.w);
}

// S (m64n32, f32) = A . B, TF32, both from shared memory (K-major
// descriptors); `accumulate` 0 overwrites S
__device__ __forceinline__ void wgmma_tf32_ss_n32(float (&d)[4][4], uint64_t da, uint64_t db,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// S (m64n16, f32) = A . B, TF32: as wgmma_tf32_ss_n32
__device__ __forceinline__ void wgmma_tf32_ss_n16(float (&d)[2][4], uint64_t da, uint64_t db,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// O (m64n64, f32) (+)= A . B, TF32: A from registers (per warp, the A
// layout of mma.m16n8k8.tf32: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3
// (g + 8, t + 4)), B from shared memory (K-major descriptor); `accumulate`
// 0 overwrites O
__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[8][4], const uint32_t (&a)[4],
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// O (m64n32, f32) (+)= A . B, TF32: as wgmma_tf32_rs_n64
__device__ __forceinline__ void wgmma_tf32_rs_n32(float (&d)[4][4], const uint32_t (&a)[4],
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// O (m64n128, f32) (+)= A . B, TF32: as wgmma_tf32_rs_n64
__device__ __forceinline__ void wgmma_tf32_rs_n128(float (&d)[16][4], const uint32_t (&a)[4],
                                                   uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// S (m64n32, f32) = A . B^T in three TF32 passes over kD columns, both
// from shared memory, K-major: A the 64 rows at a_hi / a_lo of hi/lo tiles
// of kBM rows, B hi/lo tiles of kBN3 rows. k-step kk (8 f32) moves 32 bytes
// along a 128-byte row, every fourth one to the next 32-column block.
template <int kD>
__device__ __forceinline__ void ss_product_3xtf32(float (&d)[kBN3 / 8][4], uint32_t a_hi,
                                                  uint32_t a_lo, uint32_t b_hi, uint32_t b_lo) {
  const uint32_t as[3] = {a_lo, a_hi, a_hi}, bs[3] = {b_hi, b_lo, b_hi};
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
    const uint64_t da = gmma_desc(as[pass], 16, 1024), db = gmma_desc(bs[pass], 16, 1024);
#pragma unroll
    for (int kk = 0; kk < kD / 8; ++kk)
      wgmma_tf32_ss_n32(d, da + (((kk >> 2) * (kBM * 128) + (kk & 3) * 32) >> 4),
                        db + (((kk >> 2) * (kBN3 * 128) + (kk & 3) * 32) >> 4),
                        pass + kk > 0);
  }
}

// descriptor of a K-major B tile whose rows hold KROWS f32: 32 (128-byte
// rows in the 128-byte swizzle, 8-row groups 1024 bytes apart) or 16
// (64-byte rows in the 64-byte swizzle, 512 bytes apart)
template <int KROWS>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  static_assert(KROWS == 32 || KROWS == 16, "a TF32 B tile row is 128 or 64 bytes");
  return KROWS == 32 ? gmma_desc(addr, 16, 1024, kSwizzle128)
                     : gmma_desc(addr, 16, 512, kSwizzle64);
}

// D (m64 x N, f32) = A . B in three TF32 passes over KROWS: A (hi, lo)
// from registers, KROWS / 8 k-steps; B hi/lo tiles of N rows of KROWS f32
// (V^T in K1: 32 keys; Q^T or dO^T in K3: 16 queries; half of K^T's kD
// rows in K2: 16 keys), k-step kk 32 bytes along the row. D starts from
// zero: the tensor cores' f32 sums drop the bits past an ulp of the running
// sum, so a sum carried over every tile would lose up to an ulp a step, 768
// steps at T 2048; the caller adds each tile's D to its sum in f32 instead
template <int N, int KROWS>
__device__ __forceinline__ void rs_product_3xtf32(float (&d)[N / 8][4],
                                                  const uint32_t (&a_hi)[KROWS / 8][4],
                                                  const uint32_t (&a_lo)[KROWS / 8][4],
                                                  uint32_t b_hi, uint32_t b_lo) {
  static_assert(N == 128 || N == 64 || N == 32, "an m64nNk8 product with N 32, 64 or 128");
  const uint64_t dh = kmajor_desc<KROWS>(b_hi), dl = kmajor_desc<KROWS>(b_lo);
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
    const uint64_t db = pass == 1 ? dl : dh;
#pragma unroll
    for (int kk = 0; kk < KROWS / 8; ++kk) {
      const uint32_t(&a)[4] = pass == 0 ? a_lo[kk] : a_hi[kk];
      if constexpr (N == 128) wgmma_tf32_rs_n128(d, a, db + ((kk * 32) >> 4), pass + kk > 0);
      else if constexpr (N == 64) wgmma_tf32_rs_n64(d, a, db + ((kk * 32) >> 4), pass + kk > 0);
      else wgmma_tf32_rs_n32(d, a, db + ((kk * 32) >> 4), pass + kk > 0);
    }
  }
}

// an accumulator (m64 x 8 NB, f32) split into the hi and lo TF32 A
// operands of a product over its 8 NB columns: k-step kk's a0..a3 are (g,
// column 8kk + 2t), (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1), A's columns t
// and t + 4 under kPerm
template <int NB>
__device__ __forceinline__ void split_a(uint32_t (&hi)[NB][4], uint32_t (&lo)[NB][4],
                                        const float (&s)[NB][4]) {
#pragma unroll
  for (int kk = 0; kk < NB; ++kk) {
    const float x[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float h = tf32_rna(x[e]);
      hi[kk][e] = __float_as_uint(h);
      lo[kk][e] = __float_as_uint(x[e] - h);
    }
  }
}

// byte offset of 16-byte chunk c of row r in the landing buffer, a raw
// [kBN3][kD] f32 tile: within each group of 8 chunks, c ^ ((r & 1) | ((r >>
// 2) & 6)), so that the V^T staging's 8 lanes reading rows 8m + h + 2i
// (m < 4, h < 2) at one chunk hit 8 different bank quads
template <int kD>
__device__ __forceinline__ uint32_t land_off(int r, int c) {
  return static_cast<uint32_t>((r * (kD / 4) + (c ^ ((r & 1) | ((r >> 2) & 6)))) * 16);
}

// rows [row0, row0 + kBN3) of a [T, D] f32 matrix -> the landing buffer,
// by cp.async; rows past T and columns past D are zero-filled
template <int kD>
__device__ __forceinline__ void land_tile(uint32_t land, const float* src, int row0, int T_,
                                          int D) {
  constexpr int kChunks = kD / 4;
#pragma unroll
  for (int it = 0; it < kBN3 * kChunks / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x;
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = row0 + r < T_ && c * 4 < D;
    const float* p = ok ? src + static_cast<size_t>(row0 + r) * D + c * 4 : src;
    fedml::cp_async16(land + land_off<kD>(r, c), p, ok ? 16 : 0);
  }
}

// rows [row0, row0 + ROWS) of a [T, D] f32 matrix -> hi and lo tiles in
// the 128-byte swizzle (32-column blocks), read straight from global
// memory; rows past T and columns past D are zeros
template <int ROWS, int kD>
__device__ __forceinline__ void stage_rows(unsigned char* hi, unsigned char* lo,
                                           const float* __restrict__ src, int row0, int T_,
                                           int D) {
  constexpr int kChunks = kD / 4;
#pragma unroll 4
  for (int it = 0; it < ROWS * kChunks / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x;
    const int r = i / kChunks, c = i % kChunks;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < T_ && c * 4 < D)
      x = __ldg(reinterpret_cast<const float4*>(src + static_cast<size_t>(row0 + r) * D + c * 4));
    float4 h, l;
    split4(x, h, l);
    *reinterpret_cast<float4*>(hi + swz<ROWS>(r, c)) = h;
    *reinterpret_cast<float4*>(lo + swz<ROWS>(r, c)) = l;
  }
}

// the landing buffer's raw K tile -> K hi and lo tiles ([kBN3][kD], swizzled)
template <int kD>
__device__ __forceinline__ void stage_k(unsigned char* hi, unsigned char* lo,
                                        const unsigned char* land) {
  constexpr int kChunks = kD / 4;
#pragma unroll
  for (int it = 0; it < kBN3 * kChunks / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x;
    const int r = i / kChunks, c = i % kChunks;
    float4 h, l;
    split4(*reinterpret_cast<const float4*>(land + land_off<kD>(r, c)), h, l);
    *reinterpret_cast<float4*>(hi + swz<kBN3>(r, c)) = h;
    *reinterpret_cast<float4*>(lo + swz<kBN3>(r, c)) = l;
  }
}

// the landing buffer's raw V tile -> V^T hi and lo tiles: kD rows (one per
// column of V) of kBN3 keys, one swizzled 128-byte column block. Chunk
// 2m + h of row d holds keys 8m + h + 2i, i < 4 (kPerm); a thread reads a
// 4 x 4 block of V (4 keys x 4 columns) and writes its 4 transposed chunks
template <int kD>
__device__ __forceinline__ void stage_vt(unsigned char* hi, unsigned char* lo,
                                         const unsigned char* land) {
#pragma unroll
  for (int it = 0; it < (8 * kD / 4 + kThreads - 1) / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x;
    if (i >= 8 * kD / 4) break;
    const int cc = i & 7, d4 = i >> 3;
    const int key0 = 8 * (cc >> 1) + (cc & 1);
    float4 x[4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
      x[ii] = *reinterpret_cast<const float4*>(land + land_off<kD>(key0 + 2 * ii, d4));
    const float4 cols[4] = {make_float4(x[0].x, x[1].x, x[2].x, x[3].x),
                            make_float4(x[0].y, x[1].y, x[2].y, x[3].y),
                            make_float4(x[0].z, x[1].z, x[2].z, x[3].z),
                            make_float4(x[0].w, x[1].w, x[2].w, x[3].w)};
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float4 h, l;
      split4(cols[jj], h, l);
      *reinterpret_cast<float4*>(hi + swz<kD>(4 * d4 + jj, cc)) = h;
      *reinterpret_cast<float4*>(lo + swz<kD>(4 * d4 + jj, cc)) = l;
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_3xtf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, float* __restrict__ o,
                            float* __restrict__ lse, int T_, int D, float scale) {
  constexpr int kQ = kBM * kD * 4;    // bytes of Q hi (or lo)
  constexpr int kKV = kBN3 * kD * 4;  // bytes of one K, V^T or raw tile
  constexpr int kQHi = 0, kQLo = kQ, kKHi = 2 * kQ, kKLo = kKHi + kKV, kVHi = kKLo + kKV,
                kVLo = kVHi + kKV, kLandK = kVLo + kKV, kLandV = kLandK + kKV;
  extern __shared__ __align__(1024) unsigned char smem_tc[];
  const uint32_t sa = fedml::smem_addr(smem_tc);

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;  // longest tiles first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wg = warp >> 2;                 // warpgroup: rows 64 wg .. 64 wg + 63
  const int r0 = warp * 16;                 // the warp's first row in the tile
  const size_t base = static_cast<size_t>(bh) * T_ * D;
  const int n_kt = min((q0 + kBM + kBN3 - 1) / kBN3, (T_ + kBN3 - 1) / kBN3);
  const float scale_log2 = scale * kLog2e;

  land_tile<kD>(sa + kLandK, k + base, 0, T_, D);
  land_tile<kD>(sa + kLandV, v + base, 0, T_, D);
  fedml::cp_async_commit();
  stage_rows<kBM, kD>(smem_tc + kQHi, smem_tc + kQLo, q + base, q0, T_, D);

  float acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_kt; ++j) {
    // tile j: raw in the landing buffer once every thread's copies are in
    // and every warpgroup is done with tile j - 1; split, then make the
    // hi/lo tiles visible to wgmma and start tile j + 1's copy
    fedml::cp_async_wait<0>();
    __syncthreads();
    stage_k<kD>(smem_tc + kKHi, smem_tc + kKLo, smem_tc + kLandK);
    stage_vt<kD>(smem_tc + kVHi, smem_tc + kVLo, smem_tc + kLandV);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (j + 1 < n_kt) {
      land_tile<kD>(sa + kLandK, k + base, (j + 1) * kBN3, T_, D);
      land_tile<kD>(sa + kLandV, v + base, (j + 1) * kBN3, T_, D);
      fedml::cp_async_commit();
    }
    const int k0 = j * kBN3;
    if (k0 > q0 + 64 * wg + 63) continue;  // every key past every row of the warpgroup

    float s[kBN3 / 8][4];
    wgmma_fence();
    ss_product_3xtf32<kD>(s, sa + kQHi + wg * 64 * 128, sa + kQLo + wg * 64 * 128, sa + kKHi,
                          sa + kKLo);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);

    if (k0 + kBN3 - 1 > q0 + r0) {
      // key > row  <=>  8n + (e & 1) - 8 (e >> 1) > row_g - (k0 + 2 t4)
      const int lim = q0 + r0 + g - k0 - 2 * t4;
#pragma unroll
      for (int n = 0; n < kBN3 / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * n + (e & 1) - 8 * (e >> 1) > lim) s[n][e] = kNeg;
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNeg;
#pragma unroll
      for (int n = 0; n < kBN3 / 8; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx * scale);
      corr[h] = exp2f((m[h] - m_new) * kLog2e);
      const float m_log2 = m_new * kLog2e;
      m[h] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < kBN3 / 8; ++n)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          const float p = exp2f(fmaf(s[n][e], scale_log2, -m_log2));
          s[n][e] = p;
          sum += p;  // l sums the unsplit p
        }
      l[h] = l[h] * corr[h] + sum;
    }
    uint32_t a_hi[kBN3 / 8][4], a_lo[kBN3 / 8][4];
    split_a(a_hi, a_lo, s);
    float pv[kD / 8][4];
    wgmma_fence();
    rs_product_3xtf32<kD, kBN3>(pv, a_hi, a_lo, sa + kVHi, sa + kVLo);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(pv);
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = fmaf(acc[n][e], corr[e >> 1], pv[n][e]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = q0 + r0 + g + 8 * h;
    if (row >= T_) continue;
    const float den = fmaxf(l[h], 1e-30f);
    float* orow = o + base + static_cast<size_t>(row) * D;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      const int d = 8 * n + 2 * t4;
      if (d < D)
        *reinterpret_cast<float2*>(orow + d) =
            make_float2(acc[n][2 * h] / den, acc[n][2 * h + 1] / den);
    }
    if (t4 == 0) lse[static_cast<size_t>(bh) * T_ + row] = m[h] + logf(den);
  }
}


// ------------------------------------------ K3 in f32, three-pass TF32
// dK and dV in f32, every D % 8 == 0 (kD = 64 or 128, D rounded up: rows
// and columns past D zero in shared memory, never stored), replacing
// _dkv_kernel (fedml_tpu/ops/flash_attention.py:232) on that route:
// per key, dV = sum_q P^T.dO and dK = sum_q dS^T.Q over the queries from the
// diagonal on, with p = exp(s scale - lse) (0 where the query precedes the
// key or lies past T) and dS = p (dP - delta) scale, every product in three
// TF32 passes over a hi/lo split (as K1's f32 kernel makes them).
//
// One block of two warpgroups per (bh, 64-key tile), the first key tiles
// (which see the most q tiles) first, looping over q tiles of kBS = 16
// queries from the diagonal on. The two warpgroups split the products, not
// the keys; each covers all 64 keys:
//   wg0: S^T = K.Q^T (A = K, B = Q, both hi/lo in shared memory),
//        p from lse, P written raw to a 4 KB slot, then dV += P^T.dO with
//        P^T from registers and B = dO^T (m64nDk8);
//   wg1: dP^T = V.dO^T (A = V, B = dO), then at a named barrier reads P
//        (thread i of wg1 holds the same (key, query) entries as thread i
//        of wg0), forms dS from delta and does dK += dS^T.Q with B = Q^T.
// Each thread carries one sum (dV or dK) and a fresh per-tile accumulator
// that is added to it in f32 (the tensor cores' f32 sums truncate: carried
// over 128 q tiles the first key tile's sums would read ~4e-5 row-relative).
// A single warpgroup doing all four products would need dK, dV and the
// fresh accumulator, over 240 registers.
//
// TF32 wgmma takes B K-major only, so the products over queries need Q^T and
// dO^T (kD rows of 16 queries, in K1's kPerm order within each 8, so that
// the S^T / dP^T accumulators are the A operands as they stand). Their rows
// are 64 bytes: they sit in the 64-byte swizzle (descriptor layout type 2,
// 8-row atoms 512 bytes apart; chunk c of row r at c ^ ((r >> 1) & 3),
// CUTLASS's Swizzle<2,4,3> of GMMA::Layout_K_SW64_Atom). lse and delta are
// read in natural order: the accumulators' columns are natural queries.
//
// Shared memory at kD 128: K and V hi + lo resident, 128 KB; the q tile's Q,
// dO, Q^T and dO^T hi + lo, 64 KB; a cp.async landing buffer for the next
// raw Q and dO tile with its 16 lse and 16 delta values, 16 KB; the P slot,
// 4 KB: 212 KB of the 227 a block may hold (32-query tiles or 128-key
// blocks would need 256 KB or more). kD 64 halves it. ptxas: 221
// registers at kD 128 and 173 at kD 64, no spills; one block per SM.
//
// Bound at BH 64, T 2048, D 128: the two products K3 must do, 68.7 GFLOP,
// three TF32 passes each, over 495 TFLOP/s = 0.4167 ms. Recomputing S^T and
// dP^T doubles the kernel's own floor (0.833 ms), so it reads at most 50% of
// the bound. Per (64-key, 16-query) pair the block reads ~224 KB of shared
// memory in its products (A once for A_lo.B_hi and once for A_hi.[B_lo;
// B_hi], in each warpgroup) and stages ~112 KB. Reading A_hi once instead of
// twice did not move its time: what holds it is what is serial in each
// tile (staging between two barriers while the tensor cores idle, the P
// hand-off, each product chain's wait).
constexpr int kBR = 64;  // resident rows a block owns: K3's keys, K2's queries
constexpr int kBS = 16;  // rows of a streamed tile: K3's queries, K2's keys

// S^T (m64n16, f32) = A . B^T in three TF32 passes over kD columns, for
// K3 (and S, dP in K2): A the hi/lo tiles of kBR rows; B one tile of 2 kBS
// rows, lo in rows
// 0-15 and hi in rows 16-31 (128-byte swizzle, 32-column blocks 4 KB
// apart). A_lo.B_hi is one m64n16 product; A_hi.[B_lo; B_hi] is one m64n32
// product, which reads A_hi once for both terms (three m64n16 passes
// would read A three times). Its k-steps go round four accumulators: the
// tensor cores' f32 sums truncate, and the hi.hi sum over D 128 on one
// accumulator put dK at T 1 (0 up to rounding) 1.3e-4 off its plain
// version. The caller waits for the products, then adds them in f32
// (`add_scores`)
template <int kD>
__device__ __forceinline__ void ss_product_k3(float (&lo_hi)[2][4], float (&hi)[4][4][4],
                                              uint32_t a_hi, uint32_t a_lo, uint32_t b) {
  const uint64_t dah = gmma_desc(a_hi, 16, 1024), dal = gmma_desc(a_lo, 16, 1024),
                 db = gmma_desc(b, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < kD / 8; ++kk) {
    const int a_off = ((kk >> 2) * (kBR * 128) + (kk & 3) * 32) >> 4;
    const int b_off = ((kk >> 2) * (2 * kBS * 128) + (kk & 3) * 32) >> 4;
    wgmma_tf32_ss_n16(lo_hi, dal + a_off, db + b_off + ((kBS * 128) >> 4), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < kD / 8; ++kk) {
    const int a_off = ((kk >> 2) * (kBR * 128) + (kk & 3) * 32) >> 4;
    const int b_off = ((kk >> 2) * (2 * kBS * 128) + (kk & 3) * 32) >> 4;
    wgmma_tf32_ss_n32(hi[kk & 3], dah + a_off, db + b_off, kk >= 4);
  }
}

// S^T from ss_product_k3's accumulators, in f32, small terms first: A_lo.
// B_hi, the four A_hi.B_lo sums (columns 0-15), the four A_hi.B_hi sums
// (columns 16-31)
__device__ __forceinline__ void add_scores(float (&s)[2][4], const float (&lo_hi)[2][4],
                                           const float (&hi)[4][4][4]) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[j][e] = ((lo_hi[j][e] + hi[0][j][e]) + (hi[1][j][e] + hi[2][j][e]) + hi[3][j][e]) +
                ((hi[0][j + 2][e] + hi[1][j + 2][e]) + (hi[2][j + 2][e] + hi[3][j + 2][e]));
}

// byte offset of 16-byte chunk c (< 4) of row r in a tile of 64-byte rows
// in the 64-byte swizzle
__device__ __forceinline__ uint32_t swz64(int r, int c) {
  return static_cast<uint32_t>(r * 64 + ((c ^ ((r >> 1) & 3)) << 4));
}

// byte offset of chunk c of row r in a 16-row landing buffer (K3's q
// tile, K2's key tile), a raw [kBS][kD] f32 tile: within each group of 8
// chunks, c ^ (2 (r & 1) + 4 ((r >> 3) & 1)), so that the transposing reads
// of a quarter-warp (rows h + 2i and 8 + h + 2i, h < 2, at two neighbouring
// chunks) hit 8 different bank quads
template <int kD>
__device__ __forceinline__ uint32_t land16_off(int r, int c) {
  return static_cast<uint32_t>((r * (kD / 4) + (c ^ (((r & 1) << 1) | ((r >> 1) & 4)))) * 16);
}

// rows [row0, row0 + kBS) of two of the bh's [T, D] f32 matrices (K3: Q and
// dO; K2: K and V) -> the landing buffer (raw a, then raw b), by cp.async;
// past T and past D: zeros
template <int kD>
__device__ __forceinline__ void land_pair(uint32_t land, const float* a, const float* b,
                                          int row0, int T_, int D) {
  constexpr int kChunks = kD / 4, kTile = kBS * kChunks, kQ = kBS * kD * 4;
#pragma unroll
  for (int it = 0; it < 2 * kTile / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x;
    const int op = i / kTile, r = (i % kTile) / kChunks, c = i % kChunks;
    const float* src = op ? b : a;
    const bool ok = row0 + r < T_ && c * 4 < D;
    fedml::cp_async16(land + op * kQ + land16_off<kD>(r, c),
                      ok ? src + static_cast<size_t>(row0 + r) * D + c * 4 : src, ok ? 16 : 0);
  }
}

// queries [q0, q0 + kBS) of Q and dO and of lse and delta -> K3's landing
// buffer (raw Q, raw dO, 16 lse, 16 delta), by cp.async; past T and past
// D: zeros
template <int kD>
__device__ __forceinline__ void land_q_tile(uint32_t land, const float* q, const float* dout,
                                            const float* lse, const float* delta, int q0,
                                            int T_, int D) {
  land_pair<kD>(land, q, dout, q0, T_, D);
  if (threadIdx.x < 2 * kBS) {
    const int c = threadIdx.x % kBS;
    const bool ok = q0 + c < T_;
    fedml::cp_async4(land + 2 * kBS * kD * 4 + threadIdx.x * 4,
                     (threadIdx.x < kBS ? lse : delta) + (ok ? q0 + c : 0), ok ? 4 : 0);
  }
}

// the first N of the landing buffer's raw pair (K3: Q and dO, N = 2; K2:
// K, N = 1) -> hi/lo tiles at st: each as a [2 kBS][kD] tile of 2 kQ bytes,
// lo in rows 0-15 and hi in rows 16-31 (128-byte swizzle: K3's B operands
// of S^T and dP^T, K2's of S), then, from st + 2 N kQ on, each transposed,
// hi and lo of kQ bytes (kD rows of kBS rows' values, 64-byte swizzle:
// K3's Q^T and dO^T, the B operands of dK and dV; K2's K^T, the B operand
// of dQ). Chunk 2m + h
// of a transposed row holds rows 8m + h + 2i, i < 4 (kPerm); a thread reads
// a 4 x 4 block (4 rows x 4 columns) and writes its 4 transposed chunks, an
// odd column group's in the order 1 0 3 2, so that a quarter-warp's stores
// cover rows of both parities (all 8 bank quads)
template <int kD, int N>
__device__ __forceinline__ void stage_tile16(unsigned char* st, const unsigned char* land) {
  constexpr int kChunks = kD / 4, kTile = kBS * kChunks, kQ = kBS * kD * 4;
#pragma unroll
  for (int it = 0; it < N * kTile / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x;
    const int op = i / kTile, r = (i % kTile) / kChunks, c = i % kChunks;
    float4 h, l;
    split4(*reinterpret_cast<const float4*>(land + op * kQ + land16_off<kD>(r, c)), h, l);
    *reinterpret_cast<float4*>(st + 2 * op * kQ + swz<2 * kBS>(r + kBS, c)) = h;
    *reinterpret_cast<float4*>(st + 2 * op * kQ + swz<2 * kBS>(r, c)) = l;
  }
#pragma unroll
  for (int it = 0; it < (N * kD + kThreads - 1) / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x;
    if (i >= N * kD) break;
    const int op = i / kD, cc = i & 3, d4 = (i % kD) >> 2;
    const int qa = 8 * (cc >> 1) + (cc & 1);
    const unsigned char* src = land + op * kQ;
    float4 x[4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
      x[ii] = *reinterpret_cast<const float4*>(src + land16_off<kD>(qa + 2 * ii, d4));
    const float4 cols[4] = {make_float4(x[0].x, x[1].x, x[2].x, x[3].x),
                            make_float4(x[0].y, x[1].y, x[2].y, x[3].y),
                            make_float4(x[0].z, x[1].z, x[2].z, x[3].z),
                            make_float4(x[0].w, x[1].w, x[2].w, x[3].w)};
    unsigned char* hi = st + (2 * N + 2 * op) * kQ;
    const int odd = d4 & 1;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      float4 h, l;
      split4(odd ? cols[s ^ 1] : cols[s], h, l);
      const uint32_t at = swz64(4 * d4 + (s ^ odd), cc);
      *reinterpret_cast<float4*>(hi + at) = h;
      *reinterpret_cast<float4*>(hi + kQ + at) = l;
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dkv_3xtf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv, int T_, int D,
                            float scale) {
  constexpr int kKV = kBR * kD * 4;  // bytes of K or V hi (or lo)
  constexpr int kQ = kBS * kD * 4;   // bytes of one staged or raw q-tile operand
  constexpr int kKHi = 0, kKLo = kKV, kVHi = 2 * kKV, kVLo = 3 * kKV, kStage = 4 * kKV,
                kLand = kStage + 8 * kQ, kVec = kLand + 2 * kQ, kSlot = kVec + 2 * kBS * 4;
  extern __shared__ __align__(1024) unsigned char smem_tc[];
  const uint32_t sa = fedml::smem_addr(smem_tc);
  const uint32_t qs = sa + kStage;  // Q and dO (lo and hi), Q^T, dO^T (hi, lo)

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBR;  // the first key tiles have the most q tiles
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wg = warp >> 2;                     // 0: S^T, P, dV; 1: dP^T, dS, dK
  const int key_g = k0 + 16 * (warp & 3) + g;   // the thread's keys: key_g, key_g + 8
  const size_t base = static_cast<size_t>(bh) * T_ * D;
  const float* lse_bh = lse + static_cast<size_t>(bh) * T_;
  const float* dlt_bh = delta + static_cast<size_t>(bh) * T_;
  const int qt0 = k0 / kBS;  // q tiles before it hold only masked queries
  const int n_qt = (T_ + kBS - 1) / kBS;
  const float scale_log2 = scale * kLog2e;
  // thread i of either warpgroup: its 8 S^T / dP^T entries, two float4s
  float4* slot = reinterpret_cast<float4*>(smem_tc + kSlot) + (threadIdx.x & 127);

  land_q_tile<kD>(sa + kLand, q + base, dout + base, lse_bh, dlt_bh, qt0 * kBS, T_, D);
  fedml::cp_async_commit();
  stage_rows<kBR, kD>(smem_tc + kKHi, smem_tc + kKLo, k + base, k0, T_, D);
  stage_rows<kBR, kD>(smem_tc + kVHi, smem_tc + kVLo, v + base, k0, T_, D);

  float acc[kD / 8][4];  // wg0: dV, wg1: dK
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int i = qt0; i < n_qt; ++i) {
    // tile i: raw in the landing buffer once every thread's copies are in
    // and both warpgroups are done with tile i - 1 (its staged tiles and
    // the P slot); split and transpose, make the tiles visible to wgmma,
    // then start tile i + 1's copy
    const int q0 = i * kBS;
    fedml::cp_async_wait<0>();
    __syncthreads();
    stage_tile16<kD, 2>(smem_tc + kStage, smem_tc + kLand);
    // lse (wg0) or delta (wg1) of the thread's queries 8j + 2 t4 + {0, 1}
    const float* vec = reinterpret_cast<const float*>(smem_tc + kVec) + wg * kBS;
    const float2 lv[2] = {*reinterpret_cast<const float2*>(vec + 2 * t4),
                          *reinterpret_cast<const float2*>(vec + 8 + 2 * t4)};
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (i + 1 < n_qt) {
      land_q_tile<kD>(sa + kLand, q + base, dout + base, lse_bh, dlt_bh, q0 + kBS, T_, D);
      fedml::cp_async_commit();
    }

    // wg0: S^T = K.Q^T; wg1: dP^T = V.dO^T (B: the Q or dO tile, K-major)
    float lo_hi[2][4], hi[4][4][4], s[kBS / 8][4];
    wgmma_fence();
    ss_product_k3<kD>(lo_hi, hi, sa + (wg ? kVHi : kKHi), sa + (wg ? kVLo : kKLo),
                      qs + (wg ? 2 : 0) * kQ);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(lo_hi);
#pragma unroll
    for (int a = 0; a < 4; ++a) fence_regs(hi[a]);
    add_scores(s, lo_hi, hi);

    if (wg == 0) {
      // p = 0 where query < key or query >= T (rows past T are zero-filled,
      // but their lse means nothing), exactly, on every tile:
      // query < key   <=>  8j + (e & 1) - 8 (e >> 1) < key_g - (q0 + 2 t4)
      // query >= T    <=>  8j + (e & 1) >= T - (q0 + 2 t4)
      const int lim = key_g - q0 - 2 * t4, lim_t = T_ - q0 - 2 * t4;
#pragma unroll
      for (int j = 0; j < kBS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + (e & 1);
          s[j][e] = (c - 8 * (e >> 1) < lim || c >= lim_t)
                        ? 0.f
                        : exp2f(fmaf(s[j][e], scale_log2,
                                     -(e & 1 ? lv[j].y : lv[j].x) * kLog2e));
        }
      slot[0] = make_float4(s[0][0], s[0][1], s[0][2], s[0][3]);
      slot[128] = make_float4(s[1][0], s[1][1], s[1][2], s[1][3]);
      asm volatile("bar.arrive 1, 256;\n" ::: "memory");  // P is in the slot
    } else {
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      const float4 p[2] = {slot[0], slot[128]};
#pragma unroll
      for (int j = 0; j < kBS / 8; ++j) {
        const float pj[4] = {p[j].x, p[j].y, p[j].z, p[j].w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = pj[e] * (s[j][e] - (e & 1 ? lv[j].y : lv[j].x)) * scale;
      }
    }

    // wg0: dV_i = P^T.dO (B = dO^T); wg1: dK_i = dS^T.Q (B = Q^T); each from
    // a fresh accumulator, added to the sum in f32
    uint32_t a_hi[kBS / 8][4], a_lo[kBS / 8][4];
    split_a(a_hi, a_lo, s);
    float part[kD / 8][4];
    wgmma_fence();
    rs_product_3xtf32<kD, kBS>(part, a_hi, a_lo, qs + (wg ? 4 : 6) * kQ,
                                qs + (wg ? 5 : 7) * kQ);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(part);
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
  }

  float* out = (wg ? dk : dv) + base;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = key_g + 8 * h;
    if (row >= T_) continue;
    float* orow = out + static_cast<size_t>(row) * D;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      const int d = 8 * n + 2 * t4;
      if (d < D)
        *reinterpret_cast<float2*>(orow + d) = make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
    }
  }
}

// ------------------------------------------ K2 in f32, three-pass TF32
// dQ in f32 (every D % 8 == 0: kD = 64 or 128, columns past D zero in
// shared memory and never stored), replacing _dq_kernel
// (fedml_tpu/ops/flash_attention.py:204) on that route: per query row,
// dQ = sum_k dS.K over the keys up to the diagonal, with p = exp(s scale -
// lse) (0 where the key follows the row) and dS = p (dP - delta) scale. S
// and dS.K are made on the tensor cores in three TF32 passes over a hi/lo
// split (as K1's and K3's f32 kernels make them); dP = dO.V^T is made
// exactly and rounded once to f32: on the f64 tensor cores (DMMA, the f32
// products are exact in f64, the sum keeps ~1e-16), as the plain version
// makes it (`ops/flash_attention.py:matmul_f64`). The reason
// is dQ's first row (and any row whose p sits on one key): there p = 1 and
// dP = delta, so dQ is dP's rounding times scale times K, ~1e-7, which the
// row-relative rule holds to 1e-2 x 1e-4. Two f32 sums of the same
// products in different orders differ by more (magnitude ~11 at D 128):
// three TF32 passes against the plain f32 product read 2-4e-4 at BH 64
// (tests/test_torch_flash_attention.py::
// test_dq_row0_reads_the_rounding_of_dp), and an f32 FMA chain in d order
// matched cuBLAS only where cuBLAS sums in that order (not for a 1 x 1
// product at T 1). A dP rounded once from an exact sum is the same value
// whatever the order.
//
// K3 mirrored: one block of two warpgroups per (bh, 64-row q tile), the
// longest tiles first, looping over key tiles of kBS = 16 keys up to the
// diagonal. Q hi + lo and dO (in f64) stay in shared memory; each key tile
// lands raw by cp.async behind the current tile's products and is staged
// as K K-major ([lo; hi], the B operand of S), as K^T (kD rows of 16 keys
// in kPerm order, 64-byte swizzle: the B operand of dQ += dS.K, since TF32
// wgmma has no transpose) and as V in f64. The warpgroups split the work,
// not the rows; each covers all 64 rows:
//   wg0: S = Q.K^T (TF32 wgmma), then p;
//   wg1: dP = dO.V^T, each warp its 16 rows x 16 keys as four m8n8k4 f64
//        mma.sync per 4 columns of D, whose accumulators (row g, columns
//        2t and 2t + 1 of each 8 x 8) are the m64n16 layout as it stands,
//        so that thread i of either warpgroup holds the same (row, key)
//        entries; it overlaps wg0's product;
// both write theirs to a slot, meet at one barrier and read the other's,
// form the same dS, and each makes half of dQ: wg0 its first kD / 2
// columns, wg1 the rest (m64n(kD/2)k8, A = dS from registers, B = half of
// K^T's rows). A thread carries one half-sum (32 f32 at kD 128) and a fresh
// per-tile accumulator that is added to it in f32 (the tensor cores' f32
// sums truncate); S's hi.hi k-steps go round four accumulators
// (`ss_product_k3`).
//
// Shared memory at kD 128: Q hi + lo resident, 64 KB; the key tile's K
// ([lo; hi]) and K^T hi + lo, 32 KB; the landing buffer for the next raw K
// and V tile, 16 KB; the p / dP slot, 8 KB; dO (66 KB) and V (16.5 KB) in
// f64 at a row pitch of kD + 4 doubles (a warp's reads of 4 doubles from
// each of 8 rows take two wavefronts, the fewest): 203 KB of the 227 a
// block may hold. kD 64 halves the tiles.
//
// Bound at BH 64, T 2048, D 128: the two products K2 must do (dP, dS.K),
// 68.7 GFLOP, three TF32 passes each, over 495 TFLOP/s = 0.4167 ms. The
// kernel recomputes S on the tensor cores and makes dP in f64, 34.4 GFLOP
// at the f64 tensor cores' 67 TFLOP/s: 0.51 ms, alongside S; like K3 it is
// serial within each 16-key tile (staging between two barriers, the slot
// exchange, each product chain's wait).
constexpr int kF64Pad = 4;  // doubles past kD in an f64 row

// D (8 x 8, f64) += A (8 x 4) . B (4 x 8), per warp: a = A[g][t], b =
// B[t][g], d[i] = D[g][2t + i]
__device__ __forceinline__ void dmma_m8n8k4(double (&d)[2], double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
               : "+d"(d[0]), "+d"(d[1])
               : "d"(a), "d"(b));
}

// rows [row0, row0 + ROWS) of a [T, D] f32 matrix -> f64 rows of kD +
// kF64Pad doubles, read straight from global memory; rows past T and
// columns past D are zeros
template <int ROWS, int kD>
__device__ __forceinline__ void stage_rows_f64(double* dst, const float* __restrict__ src,
                                               int row0, int T_, int D) {
  constexpr int kChunks = kD / 4;
#pragma unroll 4
  for (int it = 0; it < ROWS * kChunks / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x;
    const int r = i / kChunks, c = i % kChunks;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < T_ && c * 4 < D)
      x = __ldg(reinterpret_cast<const float4*>(src + static_cast<size_t>(row0 + r) * D + c * 4));
    double2* out = reinterpret_cast<double2*>(dst + r * (kD + kF64Pad) + 4 * c);
    out[0] = make_double2(x.x, x.y);
    out[1] = make_double2(x.z, x.w);
  }
}

// the landing buffer's raw V tile (16 rows, land16_off layout) -> f64 rows
// of kD + kF64Pad doubles
template <int kD>
__device__ __forceinline__ void copy_tile_f64(double* dst, const unsigned char* land) {
  constexpr int kChunks = kD / 4;
#pragma unroll
  for (int it = 0; it < kBS * kChunks / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x;
    const int r = i / kChunks, c = i % kChunks;
    const float4 x = *reinterpret_cast<const float4*>(land + land16_off<kD>(r, c));
    double2* out = reinterpret_cast<double2*>(dst + r * (kD + kF64Pad) + 4 * c);
    out[0] = make_double2(x.x, x.y);
    out[1] = make_double2(x.z, x.w);
  }
}

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dq_3xtf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           float* __restrict__ dq, int T_, int D, float scale) {
  constexpr int kA = kBR * kD * 4;   // bytes of Q hi (or lo)
  constexpr int kK = kBS * kD * 4;   // bytes of one staged or raw key-tile operand
  constexpr int kP = kD + kF64Pad;   // f64 row pitch, doubles
  constexpr int kQHi = 0, kQLo = kA, kKs = 2 * kA, kKtHi = kKs + 2 * kK, kKtLo = kKtHi + kK,
                kLand = kKtLo + kK, kSlot = kLand + 2 * kK, kDo = kSlot + 2 * kThreads * 16,
                kV = kDo + kBR * kP * 8;
  constexpr int kHalf = kD / 2;  // dQ columns a warpgroup makes
  extern __shared__ __align__(1024) unsigned char smem_tc[];
  const uint32_t sa = fedml::smem_addr(smem_tc);
  const double* do_f64 = reinterpret_cast<const double*>(smem_tc + kDo);
  double* v_f64 = reinterpret_cast<double*>(smem_tc + kV);

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBR;  // longest tiles first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wg = warp >> 2;                     // 0: S, p; 1: dP
  const int r_g = 16 * (warp & 3) + g;          // the thread's rows in the tile: r_g, r_g + 8
  const int row_g = q0 + r_g;
  const size_t base = static_cast<size_t>(bh) * T_ * D;
  const int n_kt = min((q0 + kBR + kBS - 1) / kBS, (T_ + kBS - 1) / kBS);
  const float scale_log2 = scale * kLog2e;
  // the slot: the thread's 8 S / dP entries as two float4s at `mine` and
  // kThreads + `mine`; its partner in the other warpgroup at `theirs`
  float4* slot = reinterpret_cast<float4*>(smem_tc + kSlot);
  const int mine = threadIdx.x, theirs = threadIdx.x ^ 128;

  land_pair<kD>(sa + kLand, k + base, v + base, 0, T_, D);
  fedml::cp_async_commit();
  stage_rows<kBR, kD>(smem_tc + kQHi, smem_tc + kQLo, q + base, q0, T_, D);
  stage_rows_f64<kBR, kD>(reinterpret_cast<double*>(smem_tc + kDo), dout + base, q0, T_, D);

  // lse (times log2 e) and delta of the thread's rows; past T: zeros
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_g + 8 * h;
    const size_t at = static_cast<size_t>(bh) * T_ + min(row, T_ - 1);
    lse2[h] = row < T_ ? lse[at] * kLog2e : 0.f;
    dlt[h] = row < T_ ? delta[at] : 0.f;
  }
  float acc[kHalf / 8][4];
#pragma unroll
  for (int n = 0; n < kHalf / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < n_kt; ++j) {
    // tile j: raw in the landing buffer once every thread's copies are in
    // and both warpgroups are done with tile j - 1 (its staged tiles, V
    // and the slot); split, transpose and widen, make the tiles visible to
    // wgmma, then start tile j + 1's copy
    const int k0 = j * kBS;
    fedml::cp_async_wait<0>();
    __syncthreads();
    stage_tile16<kD, 1>(smem_tc + kKs, smem_tc + kLand);
    copy_tile_f64<kD>(v_f64, smem_tc + kLand + kK);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (j + 1 < n_kt) {
      land_pair<kD>(sa + kLand, k + base, v + base, k0 + kBS, T_, D);
      fedml::cp_async_commit();
    }

    float s[kBS / 8][4];
    if (wg == 0) {
      // S = Q.K^T (B: the K tile, K-major), then p = exp(s scale - lse), 0
      // where the key follows the row (keys past T are zero-filled and
      // follow every row that is stored):
      // key > row  <=>  8j + (e & 1) - 8 (e >> 1) > row_g - (k0 + 2 t4)
      float lo_hi[2][4], hi[4][4][4];
      wgmma_fence();
      ss_product_k3<kD>(lo_hi, hi, sa + kQHi, sa + kQLo, sa + kKs);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(lo_hi);
#pragma unroll
      for (int a = 0; a < 4; ++a) fence_regs(hi[a]);
      add_scores(s, lo_hi, hi);
      const int lim = row_g - k0 - 2 * t4;
#pragma unroll
      for (int jj = 0; jj < kBS / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[jj][e] = 8 * jj + (e & 1) - 8 * (e >> 1) > lim
                         ? 0.f
                         : exp2f(fmaf(s[jj][e], scale_log2, -lse2[e >> 1]));
    } else {
      // dP = dO.V^T in f64, rounded once to f32: acc[h][jj] is the 8 x 8
      // block of rows r_g - g + 8 h .. + 7 and keys 8 jj .. 8 jj + 7, the
      // thread's entries (row r_g + 8 h, keys 8 jj + 2 t4 + {0, 1}), i.e.
      // s[jj][2 h + {0, 1}]; per 4 columns of D, A[g][t] = dO[row][d + t]
      // and B[t][g] = V[key 8 jj + g][d + t]
      const double* x = do_f64 + r_g * kP + t4;
      const double* y = v_f64 + g * kP + t4;
      double acc2[2][kBS / 8][2] = {};
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        const double a[2] = {x[d], x[8 * kP + d]};
        const double b[kBS / 8] = {y[d], y[8 * kP + d]};
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int jj = 0; jj < kBS / 8; ++jj) dmma_m8n8k4(acc2[h][jj], a[h], b[jj]);
      }
#pragma unroll
      for (int jj = 0; jj < kBS / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[jj][e] = __double2float_rn(acc2[e >> 1][jj][e & 1]);
    }
    slot[mine] = make_float4(s[0][0], s[0][1], s[0][2], s[0][3]);
    slot[kThreads + mine] = make_float4(s[1][0], s[1][1], s[1][2], s[1][3]);
    __syncthreads();  // p and dP are in the slot
    const float4 o[2] = {slot[theirs], slot[kThreads + theirs]};
    // dS = p (dP - delta) scale: the same values in both warpgroups
#pragma unroll
    for (int jj = 0; jj < kBS / 8; ++jj) {
      const float oj[4] = {o[jj].x, o[jj].y, o[jj].z, o[jj].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = wg ? oj[e] : s[jj][e], dp = wg ? s[jj][e] : oj[e];
        s[jj][e] = p * (dp - dlt[e >> 1]) * scale;
      }
    }

    // dQ_j = dS.K over the warpgroup's half of the columns (B: its half of
    // K^T's rows), from a fresh accumulator, added to the sum in f32
    uint32_t a_hi[kBS / 8][4], a_lo[kBS / 8][4];
    split_a(a_hi, a_lo, s);
    float part[kHalf / 8][4];
    wgmma_fence();
    rs_product_3xtf32<kHalf, kBS>(part, a_hi, a_lo, sa + kKtHi + wg * kHalf * 64,
                                  sa + kKtLo + wg * kHalf * 64);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(part);
#pragma unroll
    for (int n = 0; n < kHalf / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_g + 8 * h;
    if (row >= T_) continue;
    float* orow = dq + base + static_cast<size_t>(row) * D;
#pragma unroll
    for (int n = 0; n < kHalf / 8; ++n) {
      const int d = wg * kHalf + 8 * n + 2 * t4;
      if (d < D)
        *reinterpret_cast<float2*>(orow + d) = make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
    }
  }
}

}  // namespace tc

// ------------------------------------------------------------ launches
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

float softmax_scale(int D) {
  return static_cast<float>(pow(static_cast<double>(D), -0.5));
}

template <int kD>
cudaError_t fwd_tc(const void* q, const void* k, const void* v, void* o, void* lse,
                   int BH, int T_, int D, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(tc::kBM + 4 * tc::kBN) * kD * 2;
  auto kernel = tc::flash_fwd_tc_kernel<kD>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(BH, (T_ + tc::kBM - 1) / tc::kBM), tc::kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), T_, D, softmax_scale(D));
  return cudaGetLastError();
}

// K1 in f32 on the tensor cores: Q hi/lo, K, V^T hi/lo and the landing
// buffer (224 KB at kD 128)
template <int kD>
cudaError_t fwd_3xtf32(const void* q, const void* k, const void* v, void* o, void* lse,
                       int BH, int T_, int D, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(2 * tc::kBM + 6 * tc::kBN3) * kD * 4;
  auto kernel = tc::flash_fwd_3xtf32_kernel<kD>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(BH, (T_ + tc::kBM - 1) / tc::kBM), tc::kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), static_cast<float*>(lse), T_, D,
      softmax_scale(D));
  return cudaGetLastError();
}

// K2/K3 on the tensor cores: Q and dO (K and V) tiles of 128 rows, a ring
// of two stages of 64-row tiles; K3's ring also carries lse and delta
template <int kD>
cudaError_t dq_tc(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, void* dq_, int BH, int T_,
                  int D, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(2 * tc::kBM + 4 * tc::kBN) * kD * 2;
  auto kernel = tc::flash_dq_tc_kernel<kD>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(BH, (T_ + tc::kBM - 1) / tc::kBM), tc::kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq_), T_, D, softmax_scale(D));
  return cudaGetLastError();
}

template <int kD>
cudaError_t dkv_tc(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dk, void* dv, int BH,
                   int T_, int D, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(2 * tc::kBM + 4 * tc::kBN) * kD * 2 +
                      4 * tc::kBN * sizeof(float);
  auto kernel = tc::flash_dkv_tc_kernel<kD>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(BH, (T_ + tc::kBM - 1) / tc::kBM), tc::kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), T_, D,
      softmax_scale(D));
  return cudaGetLastError();
}

// K3 in f32 on the tensor cores: K and V hi/lo, a q tile in four layouts,
// its landing buffer and the P slot (212 KB at kD 128)
template <int kD>
cudaError_t dkv_3xtf32(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int BH,
                       int T_, int D, cudaStream_t st) {
  if ((T_ + tc::kBR - 1) / tc::kBR > 65535) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(4 * tc::kBR + 10 * tc::kBS) * kD * 4 +
                      (2 * tc::kBS + tc::kBR * tc::kBS) * sizeof(float);
  auto kernel = tc::flash_dkv_3xtf32_kernel<kD>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(BH, (T_ + tc::kBR - 1) / tc::kBR), tc::kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), T_, D, softmax_scale(D));
  return cudaGetLastError();
}

// K2 in f32: Q hi/lo, the key tile as K, K^T hi/lo, its landing buffer,
// the p / dP slot, dO and V in f64 (203 KB at kD 128)
template <int kD>
cudaError_t dq_3xtf32(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq_, int BH, int T_, int D,
                      cudaStream_t st) {
  if ((T_ + tc::kBR - 1) / tc::kBR > 65535) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(2 * tc::kBR + 6 * tc::kBS) * kD * 4 +
                      2 * tc::kThreads * sizeof(float4) +
                      static_cast<size_t>(tc::kBR + tc::kBS) * (kD + tc::kF64Pad) * 8;
  auto kernel = tc::flash_dq_3xtf32_kernel<kD>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(BH, (T_ + tc::kBR - 1) / tc::kBR), tc::kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq_), T_, D, softmax_scale(D));
  return cudaGetLastError();
}

// what the kernels refuse: a dtype other than `want` (1: bf16, 0: f32), a
// D that is not a multiple of 8 or past kMaxD, and operands their 16-byte
// cp.async copies cannot read (0: taken)
cudaError_t tc_refusal(int BH, int T_, int D, int kind, int want, const void* a, const void* b,
                       const void* c, const void* d = nullptr) {
  if (kind != want || BH < 1 || T_ < 1 || D < 8 || D > kMaxD || D % 8 ||
      (T_ + tc::kBM - 1) / tc::kBM > 65535)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
       reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d)) % 16)
    return cudaErrorMisalignedAddress;
  return cudaSuccess;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. The wrapper has already checked
// shapes, contiguity and D <= 128, D % 8 == 0. Each returns
// cudaGetLastError() after its launch (0 = launched).
//
// The tensor-core kernels: one dtype each (bf16: kind 1, f32: kind 0),
// D % 8 == 0 (kD 64 or 128, the columns past D zero), q/k/v (and dO)
// 16-byte aligned (their cp.async copies are 16 bytes)
extern "C" int fedml_flash_fwd_tc(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int BH, int T_, int D,
                                  int kind, void* stream) {
  if (cudaError_t err = tc_refusal(BH, T_, D, kind, 1, q, k, v)) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(D <= 64 ? fwd_tc<64>(q, k, v, o, lse, BH, T_, D, st)
                                  : fwd_tc<128>(q, k, v, o, lse, BH, T_, D, st));
}

// K1 in f32 on the tensor cores, three TF32 passes
extern "C" int fedml_flash_fwd_3xtf32(const void* q, const void* k, const void* v,
                                      void* o, void* lse, int BH, int T_, int D,
                                      int kind, void* stream) {
  if (cudaError_t err = tc_refusal(BH, T_, D, kind, 0, q, k, v))
    return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(D <= 64 ? fwd_3xtf32<64>(q, k, v, o, lse, BH, T_, D, st)
                                  : fwd_3xtf32<128>(q, k, v, o, lse, BH, T_, D, st));
}

extern "C" int fedml_flash_dq_tc(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dq_, int BH, int T_, int D, int kind,
                                 void* stream) {
  if (cudaError_t err = tc_refusal(BH, T_, D, kind, 1, q, k, v, dout))
    return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      D <= 64 ? dq_tc<64>(q, k, v, dout, lse, delta, dq_, BH, T_, D, st)
              : dq_tc<128>(q, k, v, dout, lse, delta, dq_, BH, T_, D, st));
}

// K2 in f32 on the tensor cores, three TF32 passes
extern "C" int fedml_flash_dq_3xtf32(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dq_, int BH, int T_, int D, int kind,
                                     void* stream) {
  if (cudaError_t err = tc_refusal(BH, T_, D, kind, 0, q, k, v, dout))
    return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      D <= 64 ? dq_3xtf32<64>(q, k, v, dout, lse, delta, dq_, BH, T_, D, st)
              : dq_3xtf32<128>(q, k, v, dout, lse, delta, dq_, BH, T_, D, st));
}

extern "C" int fedml_flash_dkv_tc(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* delta,
                                  void* dk, void* dv, int BH, int T_, int D, int kind,
                                  void* stream) {
  if (cudaError_t err = tc_refusal(BH, T_, D, kind, 1, q, k, v, dout))
    return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      D <= 64 ? dkv_tc<64>(q, k, v, dout, lse, delta, dk, dv, BH, T_, D, st)
              : dkv_tc<128>(q, k, v, dout, lse, delta, dk, dv, BH, T_, D, st));
}

// K3 in f32 on the tensor cores, three TF32 passes
extern "C" int fedml_flash_dkv_3xtf32(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dk, void* dv, int BH, int T_, int D, int kind,
                                      void* stream) {
  if (cudaError_t err = tc_refusal(BH, T_, D, kind, 0, q, k, v, dout))
    return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      D <= 64 ? dkv_3xtf32<64>(q, k, v, dout, lse, delta, dk, dv, BH, T_, D, st)
              : dkv_3xtf32<128>(q, k, v, dout, lse, delta, dk, dv, BH, T_, D, st));
}

extern "C" const char* fedml_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
