// Element conversions and warp reductions shared by the port's kernels.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace fedml {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

// round an f32 value to T (nearest-even) and widen it back: exact in f32
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

template <typename T>
__device__ __forceinline__ T from_float(float x) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __float2bfloat16_rn(x);
  } else {
    return x;
  }
}

// reductions over the `width` lanes (a power of two) of an aligned group
template <int width = 32>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = width / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int width = 32>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = width / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// ---- asynchronous global -> shared copies (cp.async, sm_80+)
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, both addresses 16-byte aligned; `src_bytes` < 16 zero-fills
// the rest (0: all)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes) : "memory");
}

// 4 bytes (the .ca form: .cg takes 16 only), both addresses 4-byte
// aligned; `src_bytes` 0 writes a zero
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes = 4) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace fedml
