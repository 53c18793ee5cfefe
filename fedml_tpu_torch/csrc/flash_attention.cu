// Causal flash attention for NVIDIA Hopper (sm_90a): forward (K1), dQ (K2)
// and dK/dV (K3).
//
// Replaces the Pallas TPU kernels of fedml_tpu/ops/flash_attention.py:
//   K1 _fwd_kernel  (launched by _flash_fwd)   -> flash_fwd_kernel
//   K2 _dq_kernel   (launched by _pallas_bwd)  -> flash_dq_kernel
//   K3 _dkv_kernel  (launched by _pallas_bwd)  -> flash_dkv_kernel
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
// :257). f32 inputs are multiplied in full f32 on the CUDA cores (the TPU
// kernels use Precision.HIGHEST for f32), never in TF32.
//
// Design (first, simple version). The TPU kernels carry their accumulators
// in VMEM across a sequential grid axis; Hopper blocks run in no order, so
// that axis becomes a loop inside one block:
//   K1, K2: one block per (bh, 64-row q tile), looping over the K tiles up
//           to the diagonal (the causal skip of :70 / :213);
//   K3:     one block per (bh, 64-row k tile), looping over the q tiles
//           from the diagonal on (the skip of :244).
// The backward stays two kernels, so every sum has one owner and a fixed
// order: no atomics. Tiles are 64 x D, staged in shared memory as f32 with
// a row pitch of D + 1 words (odd, so a column walk across rows hits 32
// different banks); 256 threads as 16 x 16, thread (ty, tx) owning rows
// 4*ty .. 4*ty+3 and columns tx, tx+16, ... of every 64 x 64 score tile
// and of the 64 x D accumulators. Row softmax statistics reduce over the 16
// lanes that share a row with shuffles. The q-tile grid axis runs the
// longest (last) tiles first. The ragged tile at T's end is masked inside
// the kernel, so any T >= 1 is taken.
//
// What bounds it on the H100: at T = 2048, D = 128 attention does ~1000
// flops per byte of q/k/v/o, far above the ridge, so the floor is the
// products' flops over the tensor-core peak (bf16) or the CUDA-core f32
// peak. This version does every product with scalar FMAs from shared
// memory (two shared loads per four FMAs), so it reaches a fraction of the
// f32 CUDA-core rate in both dtypes and leaves the tensor cores idle. Left
// for later PRs: mma/wgmma products for bf16, TMA or cp.async double
// buffering of the next tile, and more than one block per SM (the f32 tiles
// take 116-166 KB of shared memory).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using fedml::from_float;
using fedml::round_to;
using fedml::to_float;

constexpr float kNeg = -1e30f;
constexpr int kB = 64;          // tile rows, q and k alike
constexpr int kThreads = 256;   // 16 x 16
constexpr int kPitchP = kB + 1; // row pitch of the 64 x 64 p / dS tiles
constexpr int kMaxD = 128;

// rows [0, 64) of a tile of `rows_valid` live rows -> shared f32, pitch D+1;
// rows past the end are zeros
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int rows_valid, int D) {
  const int pitch = D + 1;
  for (int i = threadIdx.x; i < kB * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    dst[r * pitch + d] =
        r < rows_valid ? to_float(src[static_cast<size_t>(r) * D + d]) : 0.f;
  }
}

// 64 floats of a [BH, T] row vector starting at row0; past T: zeros
__device__ __forceinline__ void load_rowvec(float* dst, const float* __restrict__ src,
                                            int rows_valid) {
  const int t = threadIdx.x;
  if (t < kB) dst[t] = t < rows_valid ? src[t] : 0.f;
}

// acc[i][j] += sum_d a[(4 ty + i) * pitch + d] * b[(tx + 16 j) * pitch + d]:
// the thread's 4 x 4 part of a 64 x 64 tile of A . B^T
__device__ __forceinline__ void tile_abt(float (&acc)[4][4], const float* a,
                                         const float* b, int D, int ty, int tx) {
  const int pitch = D + 1;
  const float* ar = a + 4 * ty * pitch;
  const float* br = b + tx * pitch;
  for (int d = 0; d < D; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = ar[i * pitch + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = br[16 * j * pitch + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// acc[i][j] += sum_c p[(4 ty + i) * kPitchP + c] * m[c * pitch + tx + 16 j]:
// the thread's rows of a [64, 64] x [64, D] product, columns tx + 16 j < D
template <int NJ>
__device__ __forceinline__ void tile_pm(float (&acc)[4][NJ], const float* p,
                                        const float* m, int D, int ty, int tx) {
  const int pitch = D + 1;
  const float* pr = p + 4 * ty * kPitchP;
  for (int c = 0; c < kB; ++c) {
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = pr[i * kPitchP + c];
    const float* mr = m + c * pitch + tx;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (tx + 16 * j < D) {
        const float y = mr[16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(x[i], y, acc[i][j]);
      }
    }
  }
}

// ------------------------------------------------------------------ K1
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int T_, int D, float scale) {
  extern __shared__ float smem[];
  const int pitch = D + 1;
  float* q_s = smem;
  float* k_s = q_s + kB * pitch;
  float* v_s = k_s + kB * pitch;
  float* p_s = v_s + kB * pitch;  // [64][kPitchP]

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest tiles first
  const int q0 = qt * kB;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t base = static_cast<size_t>(bh) * T_ * D;

  load_tile(q_s, q + base + static_cast<size_t>(q0) * D, min(kB, T_ - q0), D);
  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int kt = 0; kt <= qt; ++kt) {  // tiles past the diagonal: all masked
    const int k0 = kt * kB;
    __syncthreads();  // the previous tile's readers are done
    load_tile(k_s, k + base + static_cast<size_t>(k0) * D, min(kB, T_ - k0), D);
    load_tile(v_s, v + base + static_cast<size_t>(k0) * D, min(kB, T_ - k0), D);
    __syncthreads();
    float s[4][4] = {};
    tile_abt(s, q_s, k_s, D, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        s[i][j] = qpos >= kpos ? s[i][j] * scale : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], fedml::group_max<16>(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - m_new);
        sum += e;  // l sums p in f32; P.V takes p rounded to V's dtype
        p_s[(4 * ty + i) * kPitchP + tx + 16 * j] = round_to<T>(e);
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + fedml::group_sum<16>(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();
    tile_pm<NJ>(acc, p_s, v_s, D, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + 4 * ty + i;
    if (qpos >= T_) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) o[base + static_cast<size_t>(qpos) * D + d] = from_float<T>(acc[i][j] / den);
    }
    if (tx == 0) lse[static_cast<size_t>(bh) * T_ + qpos] = m[i] + logf(den);
  }
}

// ------------------------------------------------------------------ K2
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int T_, int D, float scale) {
  extern __shared__ float smem[];
  const int pitch = D + 1;
  float* q_s = smem;
  float* do_s = q_s + kB * pitch;
  float* k_s = do_s + kB * pitch;
  float* v_s = k_s + kB * pitch;
  float* ds_s = v_s + kB * pitch;  // [64][kPitchP]
  float* lse_s = ds_s + kB * kPitchP;
  float* dlt_s = lse_s + kB;

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int q0 = qt * kB;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t base = static_cast<size_t>(bh) * T_ * D;
  const size_t row0 = static_cast<size_t>(bh) * T_ + q0;
  const int q_valid = min(kB, T_ - q0);

  load_tile(q_s, q + base + static_cast<size_t>(q0) * D, q_valid, D);
  load_tile(do_s, dout + base + static_cast<size_t>(q0) * D, q_valid, D);
  load_rowvec(lse_s, lse + row0, q_valid);
  load_rowvec(dlt_s, delta + row0, q_valid);
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();
    load_tile(k_s, k + base + static_cast<size_t>(k0) * D, min(kB, T_ - k0), D);
    load_tile(v_s, v + base + static_cast<size_t>(k0) * D, min(kB, T_ - k0), D);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    tile_abt(s, q_s, k_s, D, ty, tx);
    tile_abt(dp, do_s, v_s, D, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      const int qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const float p = qpos >= kpos ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        const float ds = p * (dp[i][j] - dlt_s[r]) * scale;
        ds_s[r * kPitchP + tx + 16 * j] = round_to<T>(ds);
      }
    }
    __syncthreads();
    tile_pm<NJ>(acc, ds_s, k_s, D, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + 4 * ty + i;
    if (qpos >= T_) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) dq[base + static_cast<size_t>(qpos) * D + d] = from_float<T>(acc[i][j]);
    }
  }
}

// ------------------------------------------------------------------ K3
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int T_, int D,
                     float scale) {
  extern __shared__ float smem[];
  const int pitch = D + 1;
  float* k_s = smem;
  float* v_s = k_s + kB * pitch;
  float* q_s = v_s + kB * pitch;
  float* do_s = q_s + kB * pitch;
  float* pt_s = do_s + kB * pitch;   // P^T  [64 k][kPitchP]
  float* dst_s = pt_s + kB * kPitchP; // dS^T [64 k][kPitchP]
  float* lse_s = dst_s + kB * kPitchP;
  float* dlt_s = lse_s + kB;

  const int bh = blockIdx.x;
  const int kt = blockIdx.y;  // the first tiles have the most q tiles
  const int k0 = kt * kB;
  const int n_qt = gridDim.y;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t base = static_cast<size_t>(bh) * T_ * D;

  load_tile(k_s, k + base + static_cast<size_t>(k0) * D, min(kB, T_ - k0), D);
  load_tile(v_s, v + base + static_cast<size_t>(k0) * D, min(kB, T_ - k0), D);
  float acc_k[4][NJ], acc_v[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  for (int qt = kt; qt < n_qt; ++qt) {  // q tiles before the diagonal: masked
    const int q0 = qt * kB;
    const int q_valid = min(kB, T_ - q0);
    __syncthreads();
    load_tile(q_s, q + base + static_cast<size_t>(q0) * D, q_valid, D);
    load_tile(do_s, dout + base + static_cast<size_t>(q0) * D, q_valid, D);
    load_rowvec(lse_s, lse + static_cast<size_t>(bh) * T_ + q0, q_valid);
    load_rowvec(dlt_s, delta + static_cast<size_t>(bh) * T_ + q0, q_valid);
    __syncthreads();
    // transposed tiles: thread rows are keys, columns are queries
    float st[4][4] = {}, dpt[4][4] = {};
    tile_abt(st, k_s, q_s, D, ty, tx);
    tile_abt(dpt, v_s, do_s, D, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      const int kpos = k0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int qpos = q0 + c;
        const float p = (qpos >= kpos && qpos < T_)
                            ? expf(st[i][j] * scale - lse_s[c]) : 0.f;
        const float ds = p * (dpt[i][j] - dlt_s[c]) * scale;
        pt_s[r * kPitchP + c] = round_to<T>(p);
        dst_s[r * kPitchP + c] = round_to<T>(ds);
      }
    }
    __syncthreads();
    tile_pm<NJ>(acc_v, pt_s, do_s, D, ty, tx);
    tile_pm<NJ>(acc_k, dst_s, q_s, D, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + 4 * ty + i;
    if (kpos >= T_) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) {
        const size_t at = base + static_cast<size_t>(kpos) * D + d;
        dk[at] = from_float<T>(acc_k[i][j]);
        dv[at] = from_float<T>(acc_v[i][j]);
      }
    }
  }
}

// ------------------------------------------------------------ launches
size_t tile_floats(int D) { return static_cast<size_t>(kB) * (D + 1); }

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

float softmax_scale(int D) {
  return static_cast<float>(pow(static_cast<double>(D), -0.5));
}

template <typename T, int NJ>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                int BH, int T_, int D, cudaStream_t st) {
  const size_t smem = sizeof(float) * (3 * tile_floats(D) + kB * kPitchP);
  auto kernel = flash_fwd_kernel<T, NJ>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(BH, (T_ + kB - 1) / kB), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), T_, D, softmax_scale(D));
  return cudaGetLastError();
}

template <typename T, int NJ>
cudaError_t dq(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dq_, int BH, int T_,
               int D, cudaStream_t st) {
  const size_t smem = sizeof(float) * (4 * tile_floats(D) + kB * kPitchP + 2 * kB);
  auto kernel = flash_dq_kernel<T, NJ>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(BH, (T_ + kB - 1) / kB), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq_), T_, D, softmax_scale(D));
  return cudaGetLastError();
}

template <typename T, int NJ>
cudaError_t dkv(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dk, void* dv, int BH,
                int T_, int D, cudaStream_t st) {
  const size_t smem = sizeof(float) * (4 * tile_floats(D) + 2 * kB * kPitchP + 2 * kB);
  auto kernel = flash_dkv_kernel<T, NJ>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(BH, (T_ + kB - 1) / kB), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), T_,
      D, softmax_scale(D));
  return cudaGetLastError();
}

// one instantiation per (dtype, accumulator width): D <= 32, 64, 128
#define FEDML_FLASH_DISPATCH(FN, ...)                                          \
  do {                                                                         \
    if (BH < 1 || T_ < 1 || D < 1 || D > kMaxD || D % 8 || (T_ + kB - 1) / kB > 65535) \
      return static_cast<int>(cudaErrorInvalidValue);                          \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                       \
    cudaError_t err = cudaErrorInvalidValue;                                   \
    if (kind == 0) {                                                           \
      err = D <= 32 ? FN<float, 2>(__VA_ARGS__, st)                            \
          : D <= 64 ? FN<float, 4>(__VA_ARGS__, st)                            \
                    : FN<float, 8>(__VA_ARGS__, st);                           \
    } else if (kind == 1) {                                                    \
      err = D <= 32 ? FN<__nv_bfloat16, 2>(__VA_ARGS__, st)                    \
          : D <= 64 ? FN<__nv_bfloat16, 4>(__VA_ARGS__, st)                    \
                    : FN<__nv_bfloat16, 8>(__VA_ARGS__, st);                   \
    }                                                                          \
    return static_cast<int>(err);                                              \
  } while (0)

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. The wrapper has already checked
// shapes, contiguity and D <= 128, D % 8 == 0. Each returns
// cudaGetLastError() after its launch (0 = launched).
extern "C" int fedml_flash_fwd(const void* q, const void* k, const void* v, void* o,
                               void* lse, int BH, int T_, int D, int kind,
                               void* stream) {
  FEDML_FLASH_DISPATCH(fwd, q, k, v, o, lse, BH, T_, D);
}

extern "C" int fedml_flash_dq(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse, const void* delta,
                              void* dq_, int BH, int T_, int D, int kind,
                              void* stream) {
  FEDML_FLASH_DISPATCH(dq, q, k, v, dout, lse, delta, dq_, BH, T_, D);
}

extern "C" int fedml_flash_dkv(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse, const void* delta,
                               void* dk, void* dv, int BH, int T_, int D, int kind,
                               void* stream) {
  FEDML_FLASH_DISPATCH(dkv, q, k, v, dout, lse, delta, dk, dv, BH, T_, D);
}

extern "C" const char* fedml_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
