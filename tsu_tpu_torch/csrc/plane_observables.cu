// The magnetization and energy of a lattice's compact planes in one launch
// (K11).
//
// Replaces no TPU kernel. The JAX package takes a sample's observables with
// XLA ops; the port's plain version merges the red and black planes into the
// lattice and sums it in float64 (ops/checkerboard.py: merge_checkerboard,
// lattice_energy_batch), which on the card is some twenty ATen kernels a
// sample over float64 copies of the whole lattice (~1.2 ms at 4096^2 on an
// H100). This kernel reads the two planes once, in the compact layout the
// fused sweep writes (ops/checkerboard.py's layout note), and takes
//
//   spin = sum(red) + sum(black)
//   bond = sum over red sites of red * (its four black neighbours)
//
// the neighbours wrapped (periodic) or zero past an open edge, as
// plane_energy_batch forms them: every bond of the lattice joins one red site
// to one black one. Both sums are integers: each thread sums a strip of
// STRIP rows x W columns in float32 (at most 4 STRIP W in magnitude, exact),
// a block in int32, the blocks in int64. The last block to finish writes
//
//   m = (double)spin / n_sites,   e = (-J) (double)bond - field (double)spin
//
// with the plain version's operations in its order, unfused, so that every
// value equals its float64 sums bit for bit (they are exact integers there
// too, below 2^53).
//
// One launch a sample, no memset, no read from the host. Each block stores
// its two partial sums, fences, and takes a ticket; the block that takes the
// last ticket sums the partials, writes the two doubles into row `index` of
// the outputs and sets the ticket back to zero for the next launch on the
// stream. The scratch of partials and tickets is zeroed once, by the wrapper.
//
// Bytes: a sample reads the two planes once (33.5 MB at 4096^2 in bf16,
// 0.010 ms at 3.35 TB/s; less from L2, which holds them after the sweep).
// A thread walks its strip down the rows with the rows above, at and below
// in registers, so each black row is read once a strip plus two halo rows,
// with 16-byte loads where W columns divide the row; the one black neighbour
// outside a thread's columns comes from L1.
//
// Shard mode (plane_sums_kernel, the same body): one row shard of a lattice
// sharded by rows over several cards (parallel/lattice.py). The black rows
// above and below the shard come from the caller's halo rows, and the last
// block writes the shard's int64 (spin, bond) instead of m and E; the caller
// adds the shards' sums on one card and forms m and E from them in float64,
// as the whole-plane kernel does. Offsets are size_t and a thread's rows and
// columns int: a 65,536 x 131,072 shard plane (8.6e9 sites) is walked by
// 1,024 blocks of 8.4e6 red sites each, whose int32 sums stay within
// 4 x 8.4e6 = 3.4e7 in magnitude.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;     // threads a block (ops/plane_observables.py: THREADS)
constexpr int STRIP = 8;    // rows a thread walks (ops/plane_observables.py: STRIP)

struct F32 {
  using Bits = uint32_t;
  static constexpr int VEC = 4;   // elements a 16-byte load
  static __device__ __forceinline__ float widen(Bits x) { return __uint_as_float(x); }
  static __device__ __forceinline__ void unpack(uint4 v, float* out) {
    out[0] = __uint_as_float(v.x);
    out[1] = __uint_as_float(v.y);
    out[2] = __uint_as_float(v.z);
    out[3] = __uint_as_float(v.w);
  }
};

struct Bf16 {
  using Bits = uint16_t;
  static constexpr int VEC = 8;
  static __device__ __forceinline__ float widen(Bits x) {
    return __uint_as_float(uint32_t(x) << 16);
  }
  static __device__ __forceinline__ void unpack(uint4 v, float* out) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      out[2 * k] = __uint_as_float(w[k] << 16);
      out[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
};

enum { DT_F32 = 0, DT_BF16 = 1 };   // the wrapper's dtype codes

// W elements from p, widened to float32: one 16-byte load, or one element.
template <class D, int W>
__device__ __forceinline__ void load(const typename D::Bits* p, float (&v)[W]) {
  if constexpr (W == 1) {
    v[0] = D::widen(__ldg(p));
  } else {
    D::unpack(__ldg(reinterpret_cast<const uint4*>(p)), v);
  }
}

template <int W>
__device__ __forceinline__ void zero(float (&v)[W]) {
#pragma unroll
  for (int k = 0; k < W; ++k) v[k] = 0.f;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_down_sync(0xffffffffu, x, d);
  return x;
}

// The block's total of x in thread 0 (every thread must call it).
template <typename T>
__device__ __forceinline__ T block_sum(T x, T* shared) {
  x = warp_sum(x);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) shared[warp] = x;
  __syncthreads();
  T total = 0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) total += shared[w];
  }
  __syncthreads();
  return total;
}

// Where a reduction's rows end. The whole-plane kernel wraps row -1 and row
// R onto the plane's last and first rows (periodic) or reads zeros there
// (open); shard mode reads them from the black halo rows `up` and `down`,
// the neighbour shards' edge rows (zeros at an open lattice's edge).
template <class D>
struct Edges {
  const typename D::Bits* up;
  const typename D::Bits* down;
};

// The sums of lattice blockIdx.y of the batch, W columns a thread (W divides
// C2), ending in the last block, which gets the lattice's (spin, bond) in s
// and t and returns true; every other block returns false. SHARD takes rows
// -1 and R from `edges`.
template <class D, int W, bool SHARD>
__device__ __forceinline__ bool reduce_planes(
    const typename D::Bits* __restrict__ red, const typename D::Bits* __restrict__ black,
    const Edges<D>& edges, long long* __restrict__ partials,
    unsigned long long* __restrict__ tickets, int R, int C2, bool periodic, long long& s,
    long long& t) {
  const int b = blockIdx.y;
  const size_t plane = (size_t)R * C2;
  red += b * plane;
  black += b * plane;
  const int chunks = C2 / W;
  const long long items = (long long)((R + STRIP - 1) / STRIP) * chunks;

  int spin = 0, bond = 0;
  for (long long it = (long long)blockIdx.x * NT + threadIdx.x; it < items;
       it += (long long)gridDim.x * NT) {
    const int r0 = (int)(it / chunks) * STRIP, j0 = (int)(it % chunks) * W;
    const int r1 = min(r0 + STRIP, R);
    float up[W], mid[W], dn[W], rv[W];
    if (SHARD && r0 == 0)
      load<D, W>(edges.up + j0, up);
    else if (r0 > 0 || periodic)
      load<D, W>(black + (size_t)(r0 > 0 ? r0 - 1 : R - 1) * C2 + j0, up);
    else
      zero(up);
    load<D, W>(black + (size_t)r0 * C2 + j0, mid);
    float fs = 0.f, fb = 0.f;
    for (int i = r0; i < r1; ++i) {
      if (SHARD && i + 1 == R)
        load<D, W>(edges.down + j0, dn);
      else if (i + 1 < R || periodic)
        load<D, W>(black + (size_t)(i + 1 < R ? i + 1 : 0) * C2 + j0, dn);
      else
        zero(dn);
      load<D, W>(red + (size_t)i * C2 + j0, rv);
      // A red site's horizontal neighbours are black columns j - 1 and j on
      // an even row, j and j + 1 on an odd one: one of them, x, lies outside
      // this thread's columns.
      const bool even = !(i & 1);
      int jx = even ? j0 - 1 : j0 + W;
      float x = 0.f;
      if (jx < 0 || jx >= C2) jx = periodic ? (jx < 0 ? C2 - 1 : 0) : -1;
      if (jx >= 0) x = D::widen(__ldg(black + (size_t)i * C2 + jx));
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const float left = even ? (k > 0 ? mid[k - 1] : x) : mid[k];
        const float right = even ? mid[k] : (k + 1 < W ? mid[k + 1] : x);
        fb += rv[k] * (up[k] + dn[k] + left + right);
        fs += rv[k] + mid[k];
      }
#pragma unroll
      for (int k = 0; k < W; ++k) {
        up[k] = mid[k];
        mid[k] = dn[k];
      }
    }
    spin += __float2int_rn(fs);
    bond += __float2int_rn(fb);
  }

  __shared__ int shared32[NT / 32];
  __shared__ long long shared64[NT / 32];
  __shared__ bool last;
  const int block_spin = block_sum(spin, shared32);
  const int block_bond = block_sum(bond, shared32);
  if (threadIdx.x == 0) {
    long long* p = partials + 2 * ((size_t)b * gridDim.x + blockIdx.x);
    p[0] = block_spin;
    p[1] = block_bond;
    __threadfence();
    last = atomicAdd(tickets + b, 1ull) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
  s = t = 0;
  for (int k = threadIdx.x; k < (int)gridDim.x; k += NT) {
    const long long* p = partials + 2 * ((size_t)b * gridDim.x + k);
    s += __ldcg(p);
    t += __ldcg(p + 1);
  }
  s = block_sum(s, shared64);
  t = block_sum(t, shared64);
  return true;
}

// K11 on whole periodic or open planes: float64 m and E into row out_row.
template <class D, int W>
__global__ void __launch_bounds__(NT) plane_observables_kernel(
    const typename D::Bits* __restrict__ red, const typename D::Bits* __restrict__ black,
    double* __restrict__ m, double* __restrict__ e, long long* __restrict__ partials,
    unsigned long long* __restrict__ tickets, int R, int C2, bool periodic, int out_row,
    double J, double field, double n_sites) {
  long long s, t;
  if (!reduce_planes<D, W, false>(red, black, Edges<D>{}, partials, tickets, R, C2, periodic, s,
                                  t))
    return;
  if (threadIdx.x == 0) {
    const int b = blockIdx.y;
    const double ds = (double)s, dt = (double)t;
    const size_t o = (size_t)out_row * gridDim.y + b;
    m[o] = __ddiv_rn(ds, n_sites);
    e[o] = __dsub_rn(__dmul_rn(-J, dt), __dmul_rn(field, ds));
    tickets[b] = 0;
  }
}

// K11's shard mode on one row shard: its int64 (spin, bond) into row out_row
// of `sums`, for the caller to add across shards.
template <class D, int W>
__global__ void __launch_bounds__(NT) plane_sums_kernel(
    const typename D::Bits* __restrict__ red, const typename D::Bits* __restrict__ black,
    Edges<D> edges, long long* __restrict__ sums, long long* __restrict__ partials,
    unsigned long long* __restrict__ tickets, int R, int C2, bool periodic, int out_row) {
  long long s, t;
  if (!reduce_planes<D, W, true>(red, black, edges, partials, tickets, R, C2, periodic, s, t))
    return;
  if (threadIdx.x == 0) {
    sums[2 * (size_t)out_row] = s;
    sums[2 * (size_t)out_row + 1] = t;
    tickets[0] = 0;
  }
}

bool aligned16(const void* a, const void* b, const void* c = nullptr,
               const void* d = nullptr) {
  return (((uintptr_t)a | (uintptr_t)b | (uintptr_t)c | (uintptr_t)d) % 16) == 0;
}

template <class D>
int launch(const void* red, const void* black, double* m, double* e, long long* partials,
           unsigned long long* tickets, int B, int R, int C2, bool periodic, int blocks,
           int index, double J, double field, cudaStream_t st) {
  const auto* r = static_cast<const typename D::Bits*>(red);
  const auto* k = static_cast<const typename D::Bits*>(black);
  const double n_sites = 2.0 * R * (double)C2;
  const dim3 grid(blocks, B);
  const bool vec = C2 % D::VEC == 0 && aligned16(red, black);
  if (vec)
    plane_observables_kernel<D, D::VEC><<<grid, NT, 0, st>>>(
        r, k, m, e, partials, tickets, R, C2, periodic, index, J, field, n_sites);
  else
    plane_observables_kernel<D, 1><<<grid, NT, 0, st>>>(
        r, k, m, e, partials, tickets, R, C2, periodic, index, J, field, n_sites);
  return (int)cudaGetLastError();
}

template <class D>
int launch_sums(const void* red, const void* black, const void* up, const void* down,
                long long* sums, long long* partials, unsigned long long* tickets, int R, int C2,
                bool periodic, int blocks, int index, cudaStream_t st) {
  using Bits = typename D::Bits;
  const auto* r = static_cast<const Bits*>(red);
  const auto* k = static_cast<const Bits*>(black);
  const Edges<D> edges = {static_cast<const Bits*>(up), static_cast<const Bits*>(down)};
  const bool vec = C2 % D::VEC == 0 && aligned16(red, black, up, down);
  if (vec)
    plane_sums_kernel<D, D::VEC><<<blocks, NT, 0, st>>>(r, k, edges, sums, partials, tickets, R,
                                                        C2, periodic, index);
  else
    plane_sums_kernel<D, 1><<<blocks, NT, 0, st>>>(r, k, edges, sums, partials, tickets, R, C2,
                                                   periodic, index);
  return (int)cudaGetLastError();
}

}  // namespace

// red, black: B contiguous (R, C2) planes of the type `dtype` names (DT_F32 or
// DT_BF16); m, e: float64 outputs of rows of B, of which row `index` is
// written (lattice b at index * B + b); scratch: 2 B blocks partial sums then
// B tickets, int64, zero before the first launch and left zero by each.
// 1 <= B <= 65535, 1 <= R, 1 <= C2, 1 <= blocks. Returns cudaGetLastError()
// after the launch; 1 (cudaErrorInvalidValue) for another dtype.
extern "C" int tsu_plane_observables(const void* red, const void* black, void* m, void* e,
                                     void* scratch, int dtype, int B, int R, int C2,
                                     int periodic, int blocks, int index, double J,
                                     double field, void* stream) {
  auto* partials = static_cast<long long*>(scratch);
  auto* tickets = reinterpret_cast<unsigned long long*>(partials + 2 * (size_t)B * blocks);
  auto* dm = static_cast<double*>(m);
  auto* de = static_cast<double*>(e);
  const auto st = (cudaStream_t)stream;
  switch (dtype) {
    case DT_F32:
      return launch<F32>(red, black, dm, de, partials, tickets, B, R, C2, periodic != 0, blocks,
                         index, J, field, st);
    case DT_BF16:
      return launch<Bf16>(red, black, dm, de, partials, tickets, B, R, C2, periodic != 0, blocks,
                          index, J, field, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Shard mode: the spin sum and the bond sum of one row shard of a lattice,
// its contiguous (R, C2) red and black planes of the type `dtype` names, as
// int64 into row `index` of the (rows, 2) int64 `sums`. up and down: the (C2,)
// black rows above and below the shard (the neighbour shards' edge rows,
// zeros at an open lattice's edge), each red site's vertical neighbours
// outside the shard; `periodic` wraps the columns. scratch: as
// tsu_plane_observables' with B = 1. Returns cudaGetLastError() after the
// launch; 1 (cudaErrorInvalidValue) for another dtype.
extern "C" int tsu_plane_sums(const void* red, const void* black, const void* up,
                              const void* down, void* sums, void* scratch, int dtype, int R,
                              int C2, int periodic, int blocks, int index, void* stream) {
  auto* partials = static_cast<long long*>(scratch);
  auto* tickets = reinterpret_cast<unsigned long long*>(partials + 2 * (size_t)blocks);
  auto* out = static_cast<long long*>(sums);
  const auto st = (cudaStream_t)stream;
  switch (dtype) {
    case DT_F32:
      return launch_sums<F32>(red, black, up, down, out, partials, tickets, R, C2, periodic != 0,
                              blocks, index, st);
    case DT_BF16:
      return launch_sums<Bf16>(red, black, up, down, out, partials, tickets, R, C2,
                               periodic != 0, blocks, index, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
