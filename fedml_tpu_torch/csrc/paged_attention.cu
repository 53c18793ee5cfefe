// Fused paged decode attention for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fedml_tpu/ops/paged_attention.py:_kernel
// (launched by _call / paged_attention there). Contract, shared with the
// plain PyTorch version ops/paged_attention.py:paged_attention_ref:
//
//   q      [S, C, H, Dh]  float or bf16; query i of slot s sits at position
//                         pos[s] + i (C == 1 is the decode step, C > 1 a
//                         speculative verify window)
//   k/v    [P, page_size, H, Dh]  the page pool: q's dtype, or int8 with
//                         per-(page, head) f32 scales k_scales/v_scales [P, H]
//   pages  [S, max_pages] int32   page table (entries past a slot's
//                         reservation are 0, the null page)
//   pos    [S] int32
//   out    [S, C, H, Dh]  q's dtype
//
// Query i attends the virtual positions <= pos[s] + i of its slot's page
// table view; scores are (q . k) * Dh^-0.5 in f32 (the scale is applied
// AFTER the dot, not folded into q), masked with -1e30, and folded in page
// by page with an online softmax (running max m, sum l, o accumulator, all
// f32). int8 slabs are dequantised as float(x) * scale and ROUNDED TO q's
// DTYPE before the dot, and p is rounded to V's dtype before P.V -- the
// rounding points of the TPU kernel (paged_attention.py:115-118, :131-132).
// The result is o / max(l, 1e-30) cast to q's dtype.
//
// Design (first, simple version): one thread block per (head h, slot s),
// round_up(Dh, 32) threads; the TPU's sequential page grid axis becomes a
// loop inside the block. The block reads pos[s] and its page-table row
// itself and loops p = 0 .. (pos[s] + C - 1) / page_size: pages past the
// last query are not read at all (the TPU kernel still steps over them).
// Each step stages the page's [page_size, Dh] K slab for head h in shared
// memory (rows H*Dh apart in the pool, each a contiguous run), one warp per
// (query, row) pair reduces a dot product, one warp per query row updates
// (m, l), then the V slab replaces K in shared memory and thread d
// accumulates o[c][d] for every query in registers.
//
// What bounds it on the H100: the K/V bytes of live pages (C <= 16 queries
// do ~2*C flops per loaded element, far below the card's ~20 flop/byte f32
// ridge), so its floor is live K/V bytes / HBM bandwidth. This first design
// leaves out: split-K over pages ("flash-decoding") to fill the SMs when
// S*H blocks are few, vectorised 16-byte loads, cp.async/TMA double
// buffering of the next page behind the current one's math, and
// tensor-core (mma/wgmma) products for C > 1. Those come in later PRs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

using fedml::from_float;
using fedml::round_to;
using fedml::to_float;

constexpr float kNeg = -1e30f;
constexpr int kMaxC = 16;

// QT: query/output dtype (float or bf16). PT: pool dtype (QT, or int8).
template <typename QT, typename PT>
__global__ void paged_attention_kernel(
    const QT* __restrict__ q, const PT* __restrict__ k_pool,
    const PT* __restrict__ v_pool, const int* __restrict__ pages,
    const int* __restrict__ pos, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, QT* __restrict__ out, int C, int H,
    int Dh, int page_size, int max_pages, float scale) {
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  extern __shared__ float smem[];
  float* q_s = smem;                      // [C][Dh]
  float* kv_s = q_s + C * Dh;             // [page_size][Dh], K then V
  float* p_s = kv_s + page_size * Dh;     // [C][page_size] scores, then p
  float* m_s = p_s + C * page_size;       // [C] running max
  float* l_s = m_s + C;                   // [C] running sum
  float* corr_s = l_s + C;                // [C] this page's rescale

  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const size_t row_stride = static_cast<size_t>(H) * Dh;

  const int p0 = pos[s];
  int last = (p0 + C - 1) / page_size;
  if (last > max_pages - 1) last = max_pages - 1;

  for (int i = tid; i < C * Dh; i += nthreads) {
    const int c = i / Dh, d = i - c * Dh;
    q_s[i] = to_float(q[(static_cast<size_t>(s) * C + c) * row_stride +
                        static_cast<size_t>(h) * Dh + d]);
  }
  for (int c = tid; c < C; c += nthreads) {
    m_s[c] = kNeg;
    l_s[c] = 0.f;
  }
  float acc[kMaxC];
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) acc[c] = 0.f;
  __syncthreads();

  for (int p = 0; p <= last; ++p) {
    const int page = pages[static_cast<size_t>(s) * max_pages + p];
    const size_t base = static_cast<size_t>(page) * page_size * row_stride +
                        static_cast<size_t>(h) * Dh;
    float k_sc = 1.f, v_sc = 1.f;
    if constexpr (kQuant) {
      k_sc = k_scales[static_cast<size_t>(page) * H + h];
      v_sc = v_scales[static_cast<size_t>(page) * H + h];
    }
    // K slab -> shared (int8: dequantised, rounded to q's dtype)
    for (int i = tid; i < page_size * Dh; i += nthreads) {
      const int r = i / Dh, d = i - r * Dh;
      float x = to_float(k_pool[base + r * row_stride + d]);
      if constexpr (kQuant) x = round_to<QT>(x * k_sc);
      kv_s[i] = x;
    }
    __syncthreads();
    // masked, scaled scores: one warp per (query c, row r)
    for (int pr = warp; pr < C * page_size; pr += nwarps) {
      const int c = pr / page_size, r = pr - c * page_size;
      float dot = 0.f;
      for (int d = lane; d < Dh; d += 32) dot += q_s[c * Dh + d] * kv_s[r * Dh + d];
      dot = fedml::group_sum(dot);
      if (lane == 0) {
        const int vpos = p * page_size + r;
        p_s[pr] = (vpos <= p0 + c) ? dot * scale : kNeg;
      }
    }
    __syncthreads();
    // online-softmax update: one warp per query row
    for (int c = warp; c < C; c += nwarps) {
      float* row = p_s + c * page_size;
      float mx = kNeg;
      for (int r = lane; r < page_size; r += 32) mx = fmaxf(mx, row[r]);
      mx = fedml::group_max(mx);
      const float m_old = m_s[c];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < page_size; r += 32) {
        const float e = expf(row[r] - m_new);
        sum += e;                 // l sums p in f32 ...
        row[r] = round_to<QT>(e); // ... P.V takes p rounded to V's dtype
      }
      sum = fedml::group_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[c] = corr;
        l_s[c] = l_s[c] * corr + sum;
        m_s[c] = m_new;
      }
    }
    __syncthreads();
    // V slab -> shared, over the K slab every warp is done with
    for (int i = tid; i < page_size * Dh; i += nthreads) {
      const int r = i / Dh, d = i - r * Dh;
      float x = to_float(v_pool[base + r * row_stride + d]);
      if constexpr (kQuant) x = round_to<QT>(x * v_sc);
      kv_s[i] = x;
    }
    __syncthreads();
    if (tid < Dh) {
      float pv[kMaxC];
#pragma unroll
      for (int c = 0; c < kMaxC; ++c) pv[c] = 0.f;
      for (int r = 0; r < page_size; ++r) {
        const float v = kv_s[r * Dh + tid];
#pragma unroll
        for (int c = 0; c < kMaxC; ++c)
          if (c < C) pv[c] += p_s[c * page_size + r] * v;
      }
#pragma unroll
      for (int c = 0; c < kMaxC; ++c)
        if (c < C) acc[c] = acc[c] * corr_s[c] + pv[c];
    }
    __syncthreads();  // the next page overwrites kv_s and p_s
  }

  if (tid < Dh) {
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      if (c < C) {
        out[(static_cast<size_t>(s) * C + c) * row_stride +
            static_cast<size_t>(h) * Dh + tid] =
            from_float<QT>(acc[c] / fmaxf(l_s[c], 1e-30f));
      }
    }
  }
}

template <typename QT, typename PT>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* pages, const void* pos, const void* k_scales,
                   const void* v_scales, void* out, int S, int C, int H,
                   int Dh, int page_size, int max_pages, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(C) * Dh +
                       static_cast<size_t>(page_size) * Dh + C * page_size + 3 * C);
  auto kernel = paged_attention_kernel<QT, PT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const float scale = static_cast<float>(pow(static_cast<double>(Dh), -0.5));
  const dim3 grid(H, S);
  const dim3 block((Dh + 31) / 32 * 32);
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const PT*>(k_pool),
      static_cast<const PT*>(v_pool), static_cast<const int*>(pages),
      static_cast<const int*>(pos), static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales), static_cast<QT*>(out), C, H, Dh,
      page_size, max_pages, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8. The wrapper has already
// checked shapes, contiguity and the limits C <= 16, page_size <= 64,
// Dh <= 256. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int fedml_paged_attention(const void* q, const void* k_pool,
                                     const void* v_pool, const void* pages,
                                     const void* pos, const void* k_scales,
                                     const void* v_scales, void* out, int S,
                                     int C, int H, int Dh, int page_size,
                                     int max_pages, int q_kind, int pool_kind,
                                     void* stream) {
  if (C < 1 || C > kMaxC || page_size < 1 || page_size > 64 || Dh < 1 ||
      Dh > 256 || S < 1 || H < 1 || max_pages < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (q_kind == 0 && pool_kind == 0)
    err = launch<float, float>(q, k_pool, v_pool, pages, pos, k_scales, v_scales,
                               out, S, C, H, Dh, page_size, max_pages, st);
  else if (q_kind == 0 && pool_kind == 2)
    err = launch<float, int8_t>(q, k_pool, v_pool, pages, pos, k_scales,
                                v_scales, out, S, C, H, Dh, page_size, max_pages, st);
  else if (q_kind == 1 && pool_kind == 1)
    err = launch<__nv_bfloat16, __nv_bfloat16>(q, k_pool, v_pool, pages, pos,
                                               k_scales, v_scales, out, S, C, H,
                                               Dh, page_size, max_pages, st);
  else if (q_kind == 1 && pool_kind == 2)
    err = launch<__nv_bfloat16, int8_t>(q, k_pool, v_pool, pages, pos, k_scales,
                                        v_scales, out, S, C, H, Dh, page_size,
                                        max_pages, st);
  return static_cast<int>(err);
}

extern "C" const char* fedml_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
