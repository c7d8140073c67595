// The first body of the exact-sigmoid half-sweep kernel (K3), kept only to
// be held against checkerboard_halfsweep.cu bit for bit and timed beside it
// in one process (tools/halfsweep_bodies.py, chip_smoke.py phases 19 and 23).
// No path of the port launches it. Its C entry is tsu_halfsweep_scalar, with
// the stride-less interface: column halos are contiguous (R,) values.
//
// Checkerboard heat-bath half-sweep of the uniform-J 2-D Ising model with an
// exact sigmoid, for one lattice or one shard of a sharded lattice.
//
// Replaces the Pallas TPU kernel _halfsweep_kernel of
// tsu_tpu/ops/checkerboard_pallas.py on NVIDIA Hopper (sm_90a). One launch
// resamples one colour of the compact (R, C/2) planes of
// tsu_tpu/ops/checkerboard.py from the other colour's plane and writes a new
// plane, so no launch reads what it writes and the blocks need no order.
//
// What a site computes. Its vertical neighbours are the other plane's rows
// r-1 and r+1; past the plane's first and last row they are the caller's halo
// rows up_row and down_row (the wrap rows of one lattice, the neighbour
// shard's rows, or zeros at an open edge). Its horizontal pair is its own
// column and, by the row-parity rule of tsu_tpu/ops/checkerboard.py, column
// c-1 or c+1; past the plane's edge that column is the caller's column halo
// (left_col, right_col: a column-sharded shard's neighbours, or zeros) when
// given, else the wrapped column when periodic, else nothing (an open edge).
// The local field is J * nbr + field in float32 (nbr is an exact integer in
// -4..4), p = 1 / (1 + exp(-2 local / T)) in the reference's order without
// contraction (a division by T, not a multiply by beta), and the site is +1
// if u24 * 2^-24 < p. The new spin is written in the plane's dtype (float32
// or bfloat16).
//
// Random numbers. One 24-bit uniform per site: the top 24 bits of the site's
// Philox4x32-10 word at counter (global row, global col / 4, 0, 0), output
// global col % 4, under the launch's key, which the wrappers make
// (fold_seed(base, colour), sweep). A shard passes its global row and column
// offsets (row0, col0), so every shard of a lattice draws the words the whole
// lattice would draw at those sites. A thread owns one global group of four
// columns and one Philox call serves them; where a shard's columns start
// inside a group (col0 % 4 != 0) the edge threads keep only the lanes of
// their own sites. Injected uniforms, (R, C2) int32 in [0, 2^24), replace
// the generator.
//
// Bound. Compulsory traffic per site: read the other plane once and write
// the new one, 8 B at float32 and 4 B at bfloat16; the up, down and partner
// reads of the other plane hit L1/L2. At the H100's 3.35 TB/s a 4096^2
// half-sweep (8.4 M sites) needs 0.020 ms at float32. Each site also takes
// one expf and two IEEE divisions, and a quarter of a Philox call. This
// first version is K4's continuous mode without bond planes: scalar loads,
// no shared memory.

#include "tsu_common.cuh"

namespace {

constexpr int BX = 32;  // threads along a row, one group of four columns each
constexpr int BY = 8;   // rows per block

template <typename S>
__global__ void __launch_bounds__(BX * BY) halfsweep_kernel(
    const S* __restrict__ other, S* __restrict__ out, const S* __restrict__ up_row,
    const S* __restrict__ down_row, const S* __restrict__ left_col,
    const S* __restrict__ right_col, const int* __restrict__ uniforms, int R, int C2,
    int update_red, int periodic, float J, float field, float T, int row0, int col0,
    uint32_t k0, uint32_t k1) {
  const int r = blockIdx.y * BY + threadIdx.y;
  const int q = (col0 >> 2) + blockIdx.x * BX + threadIdx.x;  // global group of 4 columns
  const int c0 = 4 * q - col0;                                // its first local column
  if (r >= R || c0 >= C2) return;
  // The partner is column c-1 on picked rows, c+1 on the others. A shard
  // starts on an even global row, so local parity is global parity.
  const bool picked = ((r & 1) == 0) == (update_red != 0);
  const size_t row = (size_t)r * C2;
  uint4 words = make_uint4(0u, 0u, 0u, 0u);
  if (uniforms == nullptr)
    words = philox4x32_10(make_uint4((uint32_t)(row0 + r), (uint32_t)q, 0u, 0u), k0, k1);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int c = c0 + t;
    if (c < 0 || c >= C2) continue;
    const size_t o = row + c;
    const float self = to_f32(other[o]);
    const float up = to_f32(r > 0 ? other[o - C2] : up_row[c]);
    const float dn = to_f32(r + 1 < R ? other[o + C2] : down_row[c]);
    float partner;
    if (picked) {
      partner = c > 0 ? to_f32(other[o - 1])
                : left_col != nullptr ? to_f32(left_col[r])
                : periodic ? to_f32(other[row + C2 - 1]) : 0.0f;
    } else {
      partner = c + 1 < C2 ? to_f32(other[o + 1])
                : right_col != nullptr ? to_f32(right_col[r])
                : periodic ? to_f32(other[row]) : 0.0f;
    }
    const float nbr = up + dn + self + partner;  // an exact integer
    const float local = __fadd_rn(__fmul_rn(J, nbr), field);
    const float x = __fdiv_rn(__fmul_rn(2.0f, local), T);
    const float p = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
    const int u24 = uniforms != nullptr ? uniforms[o] : (int)(pick(words, t) >> 8);
    out[o] = from_f32<S>(__fmul_rn((float)u24, 5.9604644775390625e-08f) < p ? 1.0f : -1.0f);
  }
}

template <typename S>
int launch(const void* other, void* out, const void* up_row, const void* down_row,
           const void* left_col, const void* right_col, const void* uniforms, int R, int C2,
           int update_red, int periodic, float J, float field, float T, int row0, int col0,
           uint32_t k0, uint32_t k1, cudaStream_t s) {
  const int groups = ((col0 & 3) + C2 + 3) / 4;
  const dim3 grid((groups + BX - 1) / BX, (R + BY - 1) / BY);
  halfsweep_kernel<S><<<grid, dim3(BX, BY), 0, s>>>(
      (const S*)other, (S*)out, (const S*)up_row, (const S*)down_row, (const S*)left_col,
      (const S*)right_col, (const int*)uniforms, R, C2, update_red, periodic, J, field, T, row0,
      col0, k0, k1);
  return (int)cudaGetLastError();
}

}  // namespace

// One half-sweep on `stream`: resample the colour given by update_red from
// `other` into `out`, both (R, C2) float32 (is_bf16 == 0) or bfloat16.
// up_row and down_row are (C2,) halo rows of the same dtype; left_col and
// right_col are both null or both (R,) column halos; uniforms is null or
// (R, C2) int32 in [0, 2^24). row0 (even) and col0 are the plane's global
// offsets, which key Philox with k0, k1. 2 <= R <= 8 * 65535, R even.
// Returns cudaGetLastError() after the launch.
extern "C" int tsu_halfsweep_scalar(const void* other, void* out, const void* up_row,
                                    const void* down_row, const void* left_col,
                                    const void* right_col, const void* uniforms, int R, int C2,
                                    int update_red, int periodic, float J, float field, float T,
                                    int row0, int col0, unsigned int k0, unsigned int k1,
                                    int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16>(other, out, up_row, down_row, left_col, right_col, uniforms, R,
                                 C2, update_red, periodic, J, field, T, row0, col0, k0, k1, s);
  return launch<float>(other, out, up_row, down_row, left_col, right_col, uniforms, R, C2,
                       update_red, periodic, J, field, T, row0, col0, k0, k1, s);
}
