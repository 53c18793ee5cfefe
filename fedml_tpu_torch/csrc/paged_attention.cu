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
// What bounds it on the H100: the K/V bytes of live pages (C <= 16 queries
// do ~2*C flops per loaded element, far below the card's ridge), so its
// floor is live K/V bytes / HBM bandwidth. Reaching it needs many bytes in
// flight: one block walking a long slot's pages one after another (the
// first design) is bound by the latency of each page's loads instead.
//
// Design: split-page ("flash-decoding"), two kernels.
//   paged_split_kernel  grid (head, slot, split). Split i owns pages
//       [i * pps, (i + 1) * pps) of its slot's table, pps chosen by the
//       wrapper from max_pages alone (never from pos: the engine dispatches
//       ahead without reading pos back). A block whose split starts past
//       the slot's last live page writes an empty partial (m = -1e30, l = 0)
//       and exits; otherwise it folds its live pages into an f32 partial
//       (m, l, o[Dh]) per query. Each page's K and V slabs for the head
//       ([page_size, Dh], rows H*Dh apart in the pool) are staged in shared
//       memory by cp.async in 16-byte chunks (element copies where 16
//       bytes do not divide a row or the pools are not 16-byte aligned),
//       in a ring of two stages: page p+1's copy is in flight behind page p's
//       math (one stage where two do not fit in shared memory: C 16,
//       page_size 64, Dh 256 in f32). The whole block works on every page:
//       groups of 8 lanes take the (query, row) dot products, each lane
//       reading 16-byte chunks of the K row, one warp per query updates
//       (m, l), and thread d accumulates o[c][d] for every query in
//       registers (an instance for C == 1, the decode step, keeps one).
//   paged_combine_kernel  one block per (slot, query, head) merges the
//       live splits' partials in split order: M = max m_i,
//       l = sum e^(m_i - M) l_i, o = sum e^(m_i - M) o_i / max(l, 1e-30),
//       written in q's dtype. A split that is live for the slot but whose
//       pages all lie past query c's position keeps m = -1e30 for it and
//       weighs e^(-1e30 - M) = 0.
// The products stay on the CUDA cores for every C; tensor-core products
// for the C > 1 verify window are left for a later PR.

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
constexpr int kThreads = 128;      // 4 warps
constexpr int kGroup = 8;          // lanes per (query, row) dot product
constexpr int kGroups = kThreads / kGroup;
constexpr int kMaxDhPerThread = 2; // Dh <= 256 = 2 x kThreads

constexpr int kMaxSmem = 232448;  // bytes of shared memory a block can use

// Shared-memory layout of one split block, in bytes from the base.
struct Layout {
  int pitch;   // bytes per staged slab row: Dh * size rounded up to 16, + 16
  int slab;    // bytes per staged [page_size, Dh] slab
  int stages;  // 2 (page p+1 staged behind page p), or 1 where 2 do not fit
  int q_off, kv_off, p_off, m_off, total;
};

__host__ __device__ inline Layout layout(int C, int Dh, int ps, int elem) {
  Layout L;
  L.pitch = (Dh * elem + 15) / 16 * 16 + 16;  // +16: rows start 4 banks apart
  L.slab = ps * L.pitch;
  L.q_off = 0;                                // f32 [C][Dh]
  L.kv_off = (C * Dh * 4 + 15) / 16 * 16;     // stages x {K, V} slabs
  for (L.stages = 2; L.stages >= 1; --L.stages) {
    L.p_off = L.kv_off + 2 * L.stages * L.slab;  // f32 [C][page_size]
    L.m_off = L.p_off + C * ps * 4;              // f32 m, l, corr [C] each
    L.total = L.m_off + 3 * C * 4;
    if (L.total <= kMaxSmem) break;
  }
  return L;
}

// page `page`'s [ps, Dh] slab of head h -> shared rows of `pitch` bytes,
// by 16-byte cp.async chunks (CB == 16: 16 divides Dh * sizeof(PT) and the
// pool is 16-byte aligned); CB == 0: element by element, synchronously
template <int CB, typename PT>
__device__ __forceinline__ void stage_slab(unsigned char* dst, const PT* pool,
                                           int page, int h, int H, int Dh, int ps,
                                           int pitch) {
  const size_t row_stride = static_cast<size_t>(H) * Dh;
  const PT* src0 =
      pool + static_cast<size_t>(page) * ps * row_stride + static_cast<size_t>(h) * Dh;
  if constexpr (CB == 0) {
    for (int i = threadIdx.x; i < ps * Dh; i += kThreads) {
      const int r = i / Dh, d = i - r * Dh;
      reinterpret_cast<PT*>(dst + r * pitch)[d] = src0[r * row_stride + d];
    }
  } else {
    const int nch = Dh * static_cast<int>(sizeof(PT)) / CB;
    const uint32_t d0 = fedml::smem_addr(dst);
    for (int i = threadIdx.x; i < ps * nch; i += kThreads) {
      const int r = i / nch, c = i - r * nch;
      fedml::cp_async16(d0 + r * pitch + c * CB,
                        reinterpret_cast<const char*>(src0 + r * row_stride) + c * CB);
    }
  }
}

// 16 bytes of pool elements (a uint4) -> 16 / sizeof(PT) floats
__device__ __forceinline__ void unpack16(const uint4& w, const float*, float* x) {
  const float* f = reinterpret_cast<const float*>(&w);
#pragma unroll
  for (int e = 0; e < 4; ++e) x[e] = f[e];
}
__device__ __forceinline__ void unpack16(const uint4& w, const __nv_bfloat16*, float* x) {
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(b[e]);
    x[2 * e] = f.x;
    x[2 * e + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack16(const uint4& w, const int8_t*, float* x) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
  for (int e = 0; e < 16; ++e) x[e] = static_cast<float>(b[e]);
}

// QT: query/output dtype (float or bf16). PT: pool dtype (QT, or int8).
// CB: cp.async chunk bytes (16, or 0 for element copies). MC: the largest
// C the instance takes (1 for the decode step, kMaxC for a verify window):
// o's registers per column.
template <typename QT, typename PT, int CB, int MC>
__global__ void __launch_bounds__(kThreads)
    paged_split_kernel(const QT* __restrict__ q, const PT* __restrict__ k_pool,
                       const PT* __restrict__ v_pool, const int* __restrict__ pages,
                       const int* __restrict__ pos, const float* __restrict__ k_scales,
                       const float* __restrict__ v_scales, float* __restrict__ o_part,
                       float* __restrict__ m_part, float* __restrict__ l_part, int C,
                       int H, int Dh, int ps, int max_pages, int pps, float scale) {
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(C, Dh, ps, sizeof(PT));
  float* q_s = reinterpret_cast<float*>(smem + L.q_off);
  unsigned char* kv_s = smem + L.kv_off;
  float* p_s = reinterpret_cast<float*>(smem + L.p_off);
  float* m_s = reinterpret_cast<float*>(smem + L.m_off);
  float* l_s = m_s + C;
  float* corr_s = l_s + C;

  const int h = blockIdx.x, s = blockIdx.y, sp = blockIdx.z;
  const int n_split = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p0 = pos[s];
  const int last = min((p0 + C - 1) / ps, max_pages - 1);
  const int first = sp * pps;
  const int end = min(first + pps, last + 1);  // exclusive
  // partial (s, c, h, sp) lives at ((s * C + c) * H + h) * n_split + sp
  const size_t part0 = (static_cast<size_t>(s) * C * H + h) * n_split + sp;
  const size_t cstride = static_cast<size_t>(H) * n_split;

  if (first > last) {  // an empty split: nothing of this slot lives here
    for (int c = tid; c < C; c += kThreads) {
      m_part[part0 + c * cstride] = kNeg;
      l_part[part0 + c * cstride] = 0.f;
    }
    return;
  }

  const int* table = pages + static_cast<size_t>(s) * max_pages;
  stage_slab<CB>(kv_s, k_pool, table[first], h, H, Dh, ps, L.pitch);
  stage_slab<CB>(kv_s + L.slab, v_pool, table[first], h, H, Dh, ps, L.pitch);
  fedml::cp_async_commit();
  const size_t row_stride = static_cast<size_t>(H) * Dh;
  for (int i = tid; i < C * Dh; i += kThreads) {
    const int c = i / Dh, d = i - c * Dh;
    q_s[i] = to_float(q[(static_cast<size_t>(s) * C + c) * row_stride +
                        static_cast<size_t>(h) * Dh + d]);
  }
  for (int c = tid; c < C; c += kThreads) {
    m_s[c] = kNeg;
    l_s[c] = 0.f;
  }
  float acc[kMaxDhPerThread][MC];
#pragma unroll
  for (int j = 0; j < kMaxDhPerThread; ++j)
#pragma unroll
    for (int c = 0; c < MC; ++c) acc[j][c] = 0.f;

  const int pitch_e = L.pitch / static_cast<int>(sizeof(PT));  // in elements
  const int grp = tid / kGroup, lig = tid % kGroup;
  for (int p = first; p < end; ++p) {
    const int stage = L.stages == 2 ? (p - first) & 1 : 0;
    const PT* k_s = reinterpret_cast<const PT*>(kv_s + stage * 2 * L.slab);
    const PT* v_s = reinterpret_cast<const PT*>(kv_s + stage * 2 * L.slab + L.slab);
    const int page = table[p];
    fedml::cp_async_wait<0>();
    __syncthreads();  // page p has landed; every thread is done with page p - 1
    if (L.stages == 2 && p + 1 < end) {  // page p+1's copy runs behind page p's math
      unsigned char* nxt = kv_s + (stage ^ 1) * 2 * L.slab;
      stage_slab<CB>(nxt, k_pool, table[p + 1], h, H, Dh, ps, L.pitch);
      stage_slab<CB>(nxt + L.slab, v_pool, table[p + 1], h, H, Dh, ps, L.pitch);
      fedml::cp_async_commit();
    }
    float k_sc = 1.f, v_sc = 1.f;
    if constexpr (kQuant) {
      k_sc = k_scales[static_cast<size_t>(page) * H + h];
      v_sc = v_scales[static_cast<size_t>(page) * H + h];
    }
    // masked, scaled scores: 8 lanes per (query c, row r); the loop count
    // is the same for every lane of a warp, so the shuffles see all lanes
    for (int b = 0; b < C * ps; b += kGroups) {
      const int pr = b + grp;
      const bool ok = pr < C * ps;
      const int c = ok ? pr / ps : 0, r = ok ? pr - c * ps : 0;
      float dot = 0.f;
      if (ok) {
        const PT* krow = k_s + r * pitch_e;
        const float* qrow = q_s + c * Dh;
        if constexpr (CB == 16) {  // 16-byte chunks: lane takes chunks lig, lig + 8, ..
          constexpr int kE = 16 / sizeof(PT);
          for (int ch = lig; ch < Dh / kE; ch += kGroup) {
            float x[kE];
            unpack16(reinterpret_cast<const uint4*>(krow)[ch], krow, x);
            const float4* q4 = reinterpret_cast<const float4*>(qrow + ch * kE);
#pragma unroll
            for (int e4 = 0; e4 < kE / 4; ++e4) {
              const float4 qv = q4[e4];
              float y[4] = {x[4 * e4], x[4 * e4 + 1], x[4 * e4 + 2], x[4 * e4 + 3]};
              if constexpr (kQuant) {
#pragma unroll
                for (int e = 0; e < 4; ++e) y[e] = round_to<QT>(y[e] * k_sc);
              }
              dot += qv.x * y[0];
              dot += qv.y * y[1];
              dot += qv.z * y[2];
              dot += qv.w * y[3];
            }
          }
        } else {
          for (int d = lig; d < Dh; d += kGroup) {
            float x = to_float(krow[d]);
            if constexpr (kQuant) x = round_to<QT>(x * k_sc);
            dot += qrow[d] * x;
          }
        }
      }
      dot = fedml::group_sum<kGroup>(dot);
      if (ok && lig == 0) {
        const int vpos = p * ps + r;
        p_s[pr] = (vpos <= p0 + c) ? dot * scale : kNeg;
      }
    }
    __syncthreads();
    // online-softmax update: one warp per query row
    for (int c = warp; c < C; c += kThreads / 32) {
      float* row = p_s + c * ps;
      float mx = kNeg;
      for (int r = lane; r < ps; r += 32) mx = fmaxf(mx, row[r]);
      mx = fedml::group_max(mx);
      const float m_old = m_s[c];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < ps; r += 32) {
        const float e = expf(row[r] - m_new);
        sum += e;                  // l sums p in f32 ...
        row[r] = round_to<QT>(e);  // ... P.V takes p rounded to V's dtype
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
    // P.V: thread owns columns d = tid, tid + 128
#pragma unroll
    for (int j = 0; j < kMaxDhPerThread; ++j) {
      const int d = tid + j * kThreads;
      if (d >= Dh) continue;
      float pv[MC];
#pragma unroll
      for (int c = 0; c < MC; ++c) pv[c] = 0.f;
      for (int r = 0; r < ps; ++r) {
        float x = to_float(v_s[r * pitch_e + d]);
        if constexpr (kQuant) x = round_to<QT>(x * v_sc);
#pragma unroll
        for (int c = 0; c < MC; ++c)
          if (c < C) pv[c] += p_s[c * ps + r] * x;
      }
#pragma unroll
      for (int c = 0; c < MC; ++c)
        if (c < C) acc[j][c] = acc[j][c] * corr_s[c] + pv[c];
    }
    if (L.stages == 1 && p + 1 < end) {  // one stage: copy after the math
      __syncthreads();
      const int next_page = table[p + 1];
      stage_slab<CB>(kv_s, k_pool, next_page, h, H, Dh, ps, L.pitch);
      stage_slab<CB>(kv_s + L.slab, v_pool, next_page, h, H, Dh, ps, L.pitch);
      fedml::cp_async_commit();
    }
  }

  // m_s / l_s were last written before the loop's final __syncthreads
#pragma unroll
  for (int j = 0; j < kMaxDhPerThread; ++j) {
    const int d = tid + j * kThreads;
    if (d >= Dh) continue;
#pragma unroll
    for (int c = 0; c < MC; ++c)
      if (c < C) o_part[(part0 + c * cstride) * Dh + d] = acc[j][c];
  }
  for (int c = tid; c < C; c += kThreads) {
    m_part[part0 + c * cstride] = m_s[c];
    l_part[part0 + c * cstride] = l_s[c];
  }
}

// one block per (slot s, query c, head h): merge the live splits in order
template <typename QT>
__global__ void __launch_bounds__(kThreads)
    paged_combine_kernel(const float* __restrict__ o_part,
                         const float* __restrict__ m_part,
                         const float* __restrict__ l_part, const int* __restrict__ pos,
                         QT* __restrict__ out, int C, int H, int Dh, int ps,
                         int max_pages, int pps, int n_split) {
  const int row = blockIdx.x;  // (s * C + c) * H + h, out's row order too
  const int s = row / (C * H);
  const int last = min((pos[s] + C - 1) / ps, max_pages - 1);
  const int n_live = last / pps + 1;
  const size_t part0 = static_cast<size_t>(row) * n_split;
  float M = kNeg;
  for (int i = 0; i < n_live; ++i) M = fmaxf(M, m_part[part0 + i]);
  float l = 0.f;
  for (int i = 0; i < n_live; ++i) l += expf(m_part[part0 + i] - M) * l_part[part0 + i];
  const float den = fmaxf(l, 1e-30f);
  for (int d = threadIdx.x; d < Dh; d += kThreads) {
    float o = 0.f;
    for (int i = 0; i < n_live; ++i)
      o += expf(m_part[part0 + i] - M) * o_part[(part0 + i) * Dh + d];
    out[static_cast<size_t>(row) * Dh + d] = from_float<QT>(o / den);
  }
}

template <typename QT, typename PT, int CB, int MC>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* pages, const void* pos, const void* k_scales,
                   const void* v_scales, void* o_part, void* m_part, void* l_part,
                   void* out, int S, int C, int H, int Dh, int ps, int max_pages,
                   int pps, cudaStream_t stream) {
  const int n_split = (max_pages + pps - 1) / pps;
  const size_t smem = layout(C, Dh, ps, sizeof(PT)).total;
  auto kernel = paged_split_kernel<QT, PT, CB, MC>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const float scale = static_cast<float>(pow(static_cast<double>(Dh), -0.5));
  kernel<<<dim3(H, S, n_split), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const PT*>(k_pool),
      static_cast<const PT*>(v_pool), static_cast<const int*>(pages),
      static_cast<const int*>(pos), static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales), static_cast<float*>(o_part),
      static_cast<float*>(m_part), static_cast<float*>(l_part), C, H, Dh, ps,
      max_pages, pps, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_combine_kernel<QT><<<S * C * H, kThreads, 0, stream>>>(
      static_cast<const float*>(o_part), static_cast<const float*>(m_part),
      static_cast<const float*>(l_part), static_cast<const int*>(pos),
      static_cast<QT*>(out), C, H, Dh, ps, max_pages, pps, n_split);
  return cudaGetLastError();
}

// launch with the cp.async chunk `cb` (16, or 0 for element copies)
template <typename QT, typename PT>
cudaError_t launch_cb(int cb, const void* q, const void* k_pool, const void* v_pool,
                      const void* pages, const void* pos, const void* k_scales,
                      const void* v_scales, void* o_part, void* m_part, void* l_part,
                      void* out, int S, int C, int H, int Dh, int ps, int max_pages,
                      int pps, cudaStream_t st) {
#define FEDML_PAGED_LAUNCH(CB)                                                 \
  (C == 1 ? launch<QT, PT, CB, 1>(q, k_pool, v_pool, pages, pos, k_scales,     \
                                  v_scales, o_part, m_part, l_part, out, S, C, \
                                  H, Dh, ps, max_pages, pps, st)               \
          : launch<QT, PT, CB, kMaxC>(q, k_pool, v_pool, pages, pos, k_scales, \
                                      v_scales, o_part, m_part, l_part, out, S, \
                                      C, H, Dh, ps, max_pages, pps, st))
  return cb == 16 ? FEDML_PAGED_LAUNCH(16) : FEDML_PAGED_LAUNCH(0);
#undef FEDML_PAGED_LAUNCH
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8. The wrapper has already
// checked shapes, contiguity and the limits C <= 16, page_size <= 64,
// Dh <= 256, chosen pages_per_split and allocated the f32 partials
// o_part [S, C, H, n_split, Dh], m_part / l_part [S, C, H, n_split] with
// n_split = ceil(max_pages / pages_per_split). Launches the split kernel,
// then the combine kernel; returns the first cudaGetLastError() that is not
// 0 (0 = both launched).
extern "C" int fedml_paged_attention(const void* q, const void* k_pool,
                                     const void* v_pool, const void* pages,
                                     const void* pos, const void* k_scales,
                                     const void* v_scales, void* o_part,
                                     void* m_part, void* l_part, void* out, int S,
                                     int C, int H, int Dh, int page_size,
                                     int max_pages, int pages_per_split,
                                     int q_kind, int pool_kind, void* stream) {
  if (C < 1 || C > kMaxC || page_size < 1 || page_size > 64 || Dh < 1 ||
      Dh > kMaxDhPerThread * kThreads || S < 1 || H < 1 || max_pages < 1 ||
      pages_per_split < 1 || (max_pages + pages_per_split - 1) / pages_per_split > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // the cp.async chunk: 16 bytes where they divide a slab row and the
  // pools' alignment, else 0 (element copies)
  const int row_bytes = Dh * (pool_kind == 0 ? 4 : pool_kind == 1 ? 2 : 1);
  const uintptr_t align = reinterpret_cast<uintptr_t>(k_pool) |
                          reinterpret_cast<uintptr_t>(v_pool);
  const int cb = row_bytes % 16 == 0 && align % 16 == 0 ? 16 : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define FEDML_PAGED_ARGS                                                         \
  cb, q, k_pool, v_pool, pages, pos, k_scales, v_scales, o_part, m_part, l_part, \
      out, S, C, H, Dh, page_size, max_pages, pages_per_split, st
  if (q_kind == 0 && pool_kind == 0)
    err = launch_cb<float, float>(FEDML_PAGED_ARGS);
  else if (q_kind == 0 && pool_kind == 2)
    err = launch_cb<float, int8_t>(FEDML_PAGED_ARGS);
  else if (q_kind == 1 && pool_kind == 1)
    err = launch_cb<__nv_bfloat16, __nv_bfloat16>(FEDML_PAGED_ARGS);
  else if (q_kind == 1 && pool_kind == 2)
    err = launch_cb<__nv_bfloat16, int8_t>(FEDML_PAGED_ARGS);
#undef FEDML_PAGED_ARGS
  return static_cast<int>(err);
}

extern "C" const char* fedml_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
