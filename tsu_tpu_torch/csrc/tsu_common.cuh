// Device helpers shared by the port's CUDA kernels: the counter-based
// Philox4x32-10 generator (tsu_tpu_torch/rng.py:philox4x32 is the same
// generator in PyTorch) and float32 <-> plane dtype conversions.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint4 philox4x32_10(uint4 x, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, x.x), lo0 = 0xD2511F53u * x.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, x.z), lo1 = 0xCD9E8D57u * x.z;
    x = make_uint4(hi1 ^ x.y ^ k0, lo1, hi0 ^ x.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return x;
}

__device__ __forceinline__ uint32_t pick(const uint4& w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}

// The word of site (r, c): output c % 4 of Philox at counter (r, c / 4, 0, 0).
__device__ __forceinline__ uint32_t site_word(int r, int c, uint32_t k0, uint32_t k1) {
  return pick(philox4x32_10(make_uint4((uint32_t)r, (uint32_t)(c >> 2), 0u, 0u), k0, k1), c & 3);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

}  // namespace
