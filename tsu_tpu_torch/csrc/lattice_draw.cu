// A lattice's random start drawn on the card, shard by shard (K12).
//
// Replaces no TPU kernel. The JAX package, and the port's default, draw the
// initial lattice on the host (rand < 0.5, float32) and copy it to the
// device; at 262,144^2 that is 275 GB of host memory and minutes of host
// time. This kernel writes the +-1 red and black planes (the compact layout
// of ops/checkerboard.py) of rows [row0, row0 + R) of a lattice straight
// into a shard's device memory, so a lattice sharded over several cards is
// drawn on them, each card its own rows, and never exists whole anywhere.
//
// Stream. Compact site (r, c) of the shard takes the word of global row
// row0 + r: output c % 4 of Philox4x32-10 at counter (row0 + r, c / 4, 0, 0)
// under the key (fold_seed(base), DRAW_TAG) (tsu_tpu_torch/rng.py:draw_key),
// the counter of the fused sweep's words. Red is +1 iff bit 15 of the word is
// clear (its low 16 bits below 2^15), black +1 iff bit 31 is clear. The
// planes depend only on global coordinates, so the lattice is the same for
// any number of shards. ops/lattice_draw.py:draw_planes_reference is the
// same draw in PyTorch.
//
// Bound. The draw writes 2 B a site in bf16 (4 in float32) and reads
// nothing: 34.4 GB for a 65,536 x 262,144 shard, 10.3 ms at 3.35 TB/s.
// Philox adds one 10-round call per four compact sites (eight sites), ~60
// int32 instructions: 2.1e9 calls, ~8 ms of the int32 pipes of 132 SMs, so
// the writes bound it, as long as they are wide and coalesced. A block
// walks whole rows (blockIdx.x, then gridDim.x apart, so no 64-bit division
// a site); its threads take consecutive groups of four compact columns, one
// Philox call each, and store each plane's four values in one 8 B (bf16) or
// 16 B (float32) store when C2 % 4 == 0 and the planes are aligned to it,
// site by site otherwise. Offsets are size_t: a shard plane passes 2^31
// sites.

#include "tsu_common.cuh"

namespace {

constexpr int NT = 256;     // threads a block (ops/lattice_draw.py: THREADS)

template <typename T> struct Plane;
template <> struct Plane<__nv_bfloat16> {
  using U = uint16_t;
  using Quad = uint2;
  static constexpr uint32_t ONE = 0x3F80u, SIGN = 0x8000u;
  static __device__ __forceinline__ Quad quad(const uint32_t b[4]) {
    return make_uint2(b[0] | (b[1] << 16), b[2] | (b[3] << 16));
  }
};
template <> struct Plane<float> {
  using U = uint32_t;
  using Quad = uint4;
  static constexpr uint32_t ONE = 0x3F800000u, SIGN = 0x80000000u;
  static __device__ __forceinline__ Quad quad(const uint32_t b[4]) {
    return make_uint4(b[0], b[1], b[2], b[3]);
  }
};

// The bits of the spin drawn from word bit `bit`: +1 when clear, -1 when set.
template <typename T>
__device__ __forceinline__ uint32_t spin_bits(uint32_t w, uint32_t bit) {
  return Plane<T>::ONE | ((w & bit) ? Plane<T>::SIGN : 0u);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(NT) lattice_draw_kernel(T* __restrict__ red,
                                                          T* __restrict__ black, int R, int C2,
                                                          int row0, uint32_t k0, uint32_t k1) {
  using U = typename Plane<T>::U;
  const int quads = (C2 + 3) / 4;
  for (int r = blockIdx.x; r < R; r += gridDim.x) {
    const size_t row = (size_t)r * C2;
    for (int q = threadIdx.x; q < quads; q += NT) {
      const uint4 w4 = philox4x32_10(make_uint4((uint32_t)(row0 + r), (uint32_t)q, 0u, 0u),
                                     k0, k1);
      const uint32_t w[4] = {w4.x, w4.y, w4.z, w4.w};
      uint32_t rb[4], bb[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        rb[t] = spin_bits<T>(w[t], 0x8000u);
        bb[t] = spin_bits<T>(w[t], 0x80000000u);
      }
      const size_t at = row + 4 * (size_t)q;
      if (VEC) {
        *reinterpret_cast<typename Plane<T>::Quad*>(red + at) = Plane<T>::quad(rb);
        *reinterpret_cast<typename Plane<T>::Quad*>(black + at) = Plane<T>::quad(bb);
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if (4 * q + t < C2) {
            reinterpret_cast<U*>(red)[at + t] = (U)rb[t];
            reinterpret_cast<U*>(black)[at + t] = (U)bb[t];
          }
        }
      }
    }
  }
}

template <typename T>
void launch(void* red, void* black, int R, int C2, int row0, uint32_t k0, uint32_t k1,
            int blocks, cudaStream_t st) {
  const uintptr_t quad = sizeof(typename Plane<T>::Quad);
  const bool vec = C2 % 4 == 0 && ((uintptr_t)red | (uintptr_t)black) % quad == 0;
  auto kernel = vec ? lattice_draw_kernel<T, true> : lattice_draw_kernel<T, false>;
  kernel<<<blocks, NT, 0, st>>>((T*)red, (T*)black, R, C2, row0, k0, k1);
}

}  // namespace

// Draw rows [row0, row0 + R) of a lattice's red and black planes, (R, C2)
// each, contiguous, float32 (is_bf16 == 0) or bfloat16, under the key
// (k0, k1), with `blocks` blocks (1 <= blocks; a block walks rows blocks
// apart). 1 <= R, 1 <= C2, 0 <= row0, row0 + R < 2^31. Returns
// cudaGetLastError() after the launch.
extern "C" int tsu_lattice_draw(void* red, void* black, int is_bf16, int R, int C2, int row0,
                                unsigned int k0, unsigned int k1, int blocks, void* stream) {
  const auto st = (cudaStream_t)stream;
  if (is_bf16)
    launch<__nv_bfloat16>(red, black, R, C2, row0, k0, k1, blocks, st);
  else
    launch<float>(red, black, R, C2, row0, k0, k1, blocks, st);
  return (int)cudaGetLastError();
}
