// The earlier, grid-stride body of the resident kernel (K6, K7), kept only
// to be timed against checkerboard_resident.cu in one process
// (tools/resident_bodies.py, chip_smoke.py phase 18). No path of the port
// launches it. Its results equal the banded body's bit for bit.
//
// Resident multi-sweep checkerboard heat-bath kernel of the uniform-J 2-D
// Ising model: S full sweeps in one cooperative launch.
//
// Replaces two Pallas TPU kernels of tsu_tpu/ops/checkerboard_resident.py on
// NVIDIA Hopper (sm_90a): _resident_kernel (S sweeps at one temperature) and
// _resident_anneal_kernel (one threshold table per sweep). One kernel body
// serves both: the table pointer advances by `table_stride` ints per sweep,
// 0 for the fixed temperature and 9 for the anneal.
//
// Design. The TPU kernel keeps both colour planes in VMEM and walks row
// chunks in order. Here every block grid-strides over (row, 4-column group)
// items of the compact (R, C/2) planes, and the whole grid meets at
// cooperative_groups::this_grid().sync() after every half-step: red from
// black, sync, black from the new red, sync. The update is in place: a
// half-step reads only the other colour's plane and writes only its own, so
// no block ever reads a site of `mine` that another block is writing, and the
// result is the exact heat-bath checkerboard update of the reference. The
// grid is as large as the card keeps resident at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs), which a cooperative
// launch requires; a launch the card refuses returns its error and the
// wrapper raises. The planes are not marked __restrict__ and are read with
// ordinary loads, never the non-coherent read-only path, because the kernel
// writes them; grid.sync() orders one half-step's writes before the next
// half-step's reads.
//
// Random numbers. Each site takes one 32-bit word of Philox4x32-10 per
// half-step, keyed (fold_seed(seed), 2 * sweep + colour) at counter
// (row, col / 4, 0, 0), output col % 4; its top 24 bits are the uniform, held
// against the 24-bit threshold of the local field (the 9-entry table of
// sigmoid_table). On a periodic lattice the local field is even and the
// 9-entry lookup gives the bits of the reference's 5-entry parity table. With
// injected uniforms (S, 2, R, C2) int32, [s][0] drives red and [s][1] black
// of sweep s.
//
// Bound. A 4096^2 bf16 lattice is two 16 MB planes, so both stay in the
// 50 MB L2 for the whole call: device memory is read and written once per
// call, and a sweep moves 4 x 16 MB through L2 (each half-step reads one plane,
// writes the other). Each site costs a quarter of a Philox call (ten rounds of
// two 32x32 multiplies) per half-step, twice the generator work of the fused
// kernel per sweep, so integer issue, not memory, is expected to bound it.
// The grid barrier costs a few microseconds per half-step.

#include <cooperative_groups.h>

#include "tsu_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;   // threads per block

template <typename T>
__device__ __forceinline__ int spin_at(const T* p, size_t i) {
  return __float2int_rn(to_f32(p[i]));
}

// Resample the (up to) four sites (r, 4q .. 4q+3) of `mine` from `other`.
template <typename T>
__device__ __forceinline__ void halfstep_quad(const T* other, T* mine, const int* st,
                                              const int* u24, int r, int q, int R, int C2,
                                              int periodic, bool update_red, uint32_t k0,
                                              uint32_t k1) {
  const int c0 = 4 * q;
  const int ru = r > 0 ? r - 1 : (periodic ? R - 1 : -1);
  const int rd = r < R - 1 ? r + 1 : (periodic ? 0 : -1);
  // Horizontal partner: column c-1 for red on even rows and black on odd
  // rows, c+1 otherwise (the compact layout of tsu_tpu/ops/checkerboard.py).
  const int dh = update_red == ((r & 1) == 0) ? -1 : 1;
  const size_t row = (size_t)r * C2;
  uint4 w = make_uint4(0u, 0u, 0u, 0u);
  if (u24 == nullptr) w = philox4x32_10(make_uint4((uint32_t)r, (uint32_t)q, 0u, 0u), k0, k1);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int c = c0 + t;
    if (c >= C2) break;
    int cp = c + dh;
    int horiz = 0;
    if (cp >= 0 && cp < C2) {
      horiz = spin_at(other, row + cp);
    } else if (periodic) {
      cp = cp < 0 ? C2 - 1 : 0;
      horiz = spin_at(other, row + cp);
    }
    int nbr = spin_at(other, row + c) + horiz;
    if (ru >= 0) nbr += spin_at(other, (size_t)ru * C2 + c);
    if (rd >= 0) nbr += spin_at(other, (size_t)rd * C2 + c);
    const int u = u24 != nullptr ? u24[row + c] : (int)(pick(w, t) >> 8);
    mine[row + c] = from_f32<T>(u < st[nbr + 4] ? 1.0f : -1.0f);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) resident_kernel(
    T* red, T* black, const int* __restrict__ tables, int table_stride,
    const int* __restrict__ uniforms, int n_sweeps, int R, int C2, int periodic, uint32_t k0) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int st[9];   // thresholds of this sweep for local fields -4..4
  const int Q = (C2 + 3) / 4;
  const size_t plane = (size_t)R * C2;
  const size_t n_quads = (size_t)R * Q;
  const size_t stride = (size_t)gridDim.x * NT;
  for (int s = 0; s < n_sweeps; ++s) {
    // The previous sweep's last grid.sync() has passed, so no thread of the
    // block still reads st.
    if (threadIdx.x < 9) st[threadIdx.x] = tables[(size_t)s * table_stride + threadIdx.x];
    __syncthreads();
    for (int color = 0; color < 2; ++color) {
      const T* other = color == 0 ? black : red;
      T* mine = color == 0 ? red : black;
      const int* u = uniforms == nullptr ? nullptr : uniforms + (2 * (size_t)s + color) * plane;
      const uint32_t k1 = 2u * (uint32_t)s + (uint32_t)color;
      for (size_t i = (size_t)blockIdx.x * NT + threadIdx.x; i < n_quads; i += stride) {
        halfstep_quad<T>(other, mine, st, u, (int)(i / Q), (int)(i % Q), R, C2, periodic,
                         color == 0, k0, k1);
      }
      grid.sync();
    }
  }
}

template <typename T>
int launch(void* red, void* black, const void* tables, int table_stride, const void* uniforms,
           int n_sweeps, int R, int C2, int periodic, uint32_t k0, int* blocks_out,
           cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, resident_kernel<T>, NT, 0);
  if (e != cudaSuccess) return (int)e;
  if (!coop || per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const size_t quads = (size_t)R * ((C2 + 3) / 4);
  const size_t want = (quads + NT - 1) / NT;
  const size_t most = (size_t)per_sm * sms;
  int blocks = (int)(want < most ? want : most);
  if (blocks < 1) blocks = 1;
  if (blocks_out != nullptr) *blocks_out = blocks;
  if (n_sweeps < 1) return 0;
  T* r = (T*)red;
  T* b = (T*)black;
  const int* t = (const int*)tables;
  const int* u = (const int*)uniforms;
  void* args[] = {&r, &b, &t, &table_stride, &u, &n_sweeps, &R, &C2, &periodic, &k0};
  e = cudaLaunchCooperativeKernel((const void*)resident_kernel<T>, dim3(blocks), dim3(NT), args,
                                  0, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// n_sweeps full sweeps in place on `stream`, in one cooperative launch. red
// and black are (R, C2) planes of float32 (is_bf16 == 0) or bfloat16; tables
// holds 9 int32 thresholds per sweep, sweep s's at s * table_stride (0: one
// table for every sweep); uniforms is null or (n_sweeps, 2, R, C2) int32 in
// [0, 2^24). R is even, C2 >= 1. k0 is fold_seed(seed). blocks_out, if not
// null, receives the grid size. Returns a CUDA error code, 0 on success.
extern "C" int tsu_resident_sweeps(void* red, void* black, const void* tables, int table_stride,
                                   const void* uniforms, int n_sweeps, int R, int C2,
                                   int periodic, unsigned int k0, int is_bf16, int* blocks_out,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16>(red, black, tables, table_stride, uniforms, n_sweeps, R, C2,
                                 periodic, k0, blocks_out, s);
  return launch<float>(red, black, tables, table_stride, uniforms, n_sweeps, R, C2, periodic, k0,
                       blocks_out, s);
}
