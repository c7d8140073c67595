// Houdayer cluster moves of a batch of replica pairs in one launch (K9).
//
// Replaces no Pallas kernel. The JAX package grows the cluster with
// lax.while_loop (tsu_tpu/samplers/tempering_ladder.py); the port's plain
// version (houdayer_cluster_reference in tsu_tpu_torch/ops/houdayer_kernel.py)
// grows it with some thirty tensor operations a step from the host and asks
// the card every GROWTH_CHECK steps whether the last step changed anything.
// A move of 16 pairs at 256^2 took ~370 steps, so ~10,900 host launches and
// 24 waits on the card. This kernel does the whole move in one launch: the
// seed pick, the growth to its fixed point and the flip.
//
// What a pair computes. The overlap q = s1 s2 of its two replicas is read
// from the compact (R, C/2) red and black planes of both (q = -1 where the
// float32 product of the two values is negative, as the plain version
// computes it). The seed is the k-th q = -1 site, red plane first, row-major,
// k = min(floor(double(u) * count), max(count - 1, 0)); no seed when count is
// 0. Then, until a step changes nothing, a step is red |= q_red & N(black),
// then black |= q_black & N(red), N being the 4-neighbour OR across the
// checkerboard (the plain version's _neighbor_or: rows r-1 and r+1 wrapped or
// zero, the same column, and column j-1 in the colour's picked rows (even
// rows for red, odd for black) or j+1 in the others, wrapped, or zero past an
// open edge). Last, every element under the mask is negated (its sign bit
// flipped) in both replicas; the rest is copied.
//
// Why the update order is free. The growth's fixed point is the seed's
// 4-connected q = -1 component whatever order the sites are updated in, and
// the masks only grow, so any order that stops at a step which changes
// nothing ends with the plain version's masks bit for bit. This kernel keeps
// the plain version's order anyway, a red then a black half-step with every
// site of a colour updated from the other colour's mask, so its step count
// to the fixed point equals the plain version's step by step: the first step
// that changes nothing, counted. Each block writes its pair's count to an
// output of the launch.
//
// Bound. The work is bounded by the chain of dependent steps, not by bytes:
// each pair reads its four planes once and writes four (8.4 MB for 16 pairs
// of 256^2 in bf16, 2.5 us at 3.35 TB/s), but a cluster that spans the
// lattice takes a few hundred steps, each two barriers of the block. So a
// pair is one block of NT = 1024 threads, and its four bit planes (q and the
// mask of each colour, 32 columns to a word) live in shared memory for the
// whole move: 4 x 4 KB at 256^2. A step costs each thread one word a colour
// (at 256^2) of shared loads, shifts and ORs, and the two barriers;
// __syncthreads_or ends the loop. The planes are read and written a warp per
// 32-column word: the warp's lanes load 32 adjacent elements and
// __ballot_sync packs their bits, so the loads and stores are coalesced.
//
// Large lattices. Where a pair's four bit planes do not fit the block's
// shared memory (16 R ceil(C2 / 32) bytes above the card's opt-in limit,
// about L = 960), the same body runs on bit planes in a global scratch that
// the wrapper allocates. Slower (0.48 against 0.37 ms a move of 16 pairs of
// 256^2 on an H100), but it takes every shape the plain version takes. __syncthreads orders the block's global accesses as it does its
// shared ones, and the scratch is never read through the read-only cache.

#include <cstdint>

#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 1024;             // threads of a block, one block a pair
constexpr int NWARPS = NT / 32;
constexpr unsigned FULL_MASK = 0xFFFFFFFFu;

// The element types, by the bits that hold them: each widens its value to
// float32 as the plain version's .float() does (bf16 is float32's top half,
// float64 rounds to nearest). A flip is the sign bit's.
struct F32 {
  using Bits = uint32_t;
  static __device__ __forceinline__ float widen(Bits x) { return __uint_as_float(x); }
};
struct Bf16 {
  using Bits = uint16_t;
  static __device__ __forceinline__ float widen(Bits x) {
    return __uint_as_float(uint32_t(x) << 16);
  }
};
struct F16 {
  using Bits = uint16_t;
  static __device__ __forceinline__ float widen(Bits x) {
    return __half2float(__ushort_as_half(x));
  }
};
struct F64 {
  using Bits = uint64_t;
  static __device__ __forceinline__ float widen(Bits x) {
    return __double2float_rn(__longlong_as_double((long long)x));
  }
};
enum { DT_F32 = 0, DT_BF16 = 1, DT_F16 = 2, DT_F64 = 3 };   // the wrapper's dtype codes

struct Pair {
  const void* r1; const void* b1; const void* r2; const void* b2;  // (B, R, C2) each
  void* o_r1; void* o_b1; void* o_r2; void* o_b2;
};

// One half-step at word i of one colour: m_self |= q_self & N(m_other).
// pick is the parity of the rows whose horizontal neighbour is column j - 1;
// last is the bit of column C2 - 1 in a row's last word. Returns whether the
// word grew.
__device__ __forceinline__ bool grow_word(uint32_t* m_self, const uint32_t* q_self,
                                         const uint32_t* m_other, int i, int R, int W, int last,
                                         bool periodic, int pick) {
  const int r = i / W, w = i - r * W;
  const uint32_t* row = m_other + r * W;
  const uint32_t c = row[w];
  const uint32_t up = r > 0 ? row[w - W] : (periodic ? m_other[(R - 1) * W + w] : 0u);
  const uint32_t down = r < R - 1 ? row[w + W] : (periodic ? m_other[w] : 0u);
  uint32_t side;
  if ((r & 1) == pick) {   // column j - 1: the row shifted up a bit, the carry from the left
    const uint32_t carry = w > 0 ? row[w - 1] >> 31
                                 : (periodic ? (row[W - 1] >> last) & 1u : 0u);
    side = (c << 1) | carry;
  } else {                 // column j + 1: shifted down a bit, the carry from the right
    const uint32_t carry = w < W - 1 ? row[w + 1] << 31
                                     : (periodic ? (row[0] & 1u) << last : 0u);
    side = (c >> 1) | carry;
  }
  const uint32_t old = m_self[i];
  const uint32_t grown = old | (q_self[i] & (up | down | c | side));
  m_self[i] = grown;
  return grown != old;
}

template <typename E, bool SMEM>
__global__ void __launch_bounds__(NT)
houdayer_cluster_kernel(Pair pr, const void* u, int u_is_double, uint32_t* scratch,
                        int* steps_out, int R, int C2, int W, int periodic) {
  using U = typename E::Bits;
  extern __shared__ uint32_t smem_bits[];
  __shared__ int warp_sums[NWARPS];
  const int p = blockIdx.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int n = R * W;             // words of one bit plane
  // q_red, q_black, m_red, m_black, n words each: word s < 2n of the q
  // planes is red word s or black word s - n, and its mask is bits[2n + s].
  uint32_t* bits = SMEM ? smem_bits : scratch + (size_t)p * 4 * n;
  const size_t base = (size_t)p * R * C2;
  const U* r1 = static_cast<const U*>(pr.r1) + base;
  const U* b1 = static_cast<const U*>(pr.b1) + base;
  const U* r2 = static_cast<const U*>(pr.r2) + base;
  const U* b2 = static_cast<const U*>(pr.b2) + base;

  // The q = -1 bits, a warp per word; the masks cleared.
  for (int s = warp; s < 2 * n; s += NWARPS) {
    const bool black = s >= n;
    const int i = black ? s - n : s;
    const int r = i / W, j = (i - r * W) * 32 + lane;
    bool neg = false;
    if (j < C2) {
      const size_t off = (size_t)r * C2 + j;
      neg = E::widen(black ? b1[off] : r1[off]) * E::widen(black ? b2[off] : r2[off]) < 0.0f;
    }
    const uint32_t word = __ballot_sync(FULL_MASK, neg);
    if (lane == 0) {
      bits[s] = word;
      bits[2 * n + s] = 0u;
    }
  }
  __syncthreads();

  // The seed: thread t counts the set bits of its run of words, a block
  // prefix sum places its run, and the thread whose run holds the k-th set
  // bit sets it in the mask.
  const int per = (2 * n + NT - 1) / NT;
  const int lo = min(t * per, 2 * n), hi = min(lo + per, 2 * n);
  int mine = 0;
  for (int s = lo; s < hi; ++s) mine += __popc(bits[s]);
  int incl = mine;
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(FULL_MASK, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = incl - mine, count = 0;
  for (int k = 0; k < NWARPS; ++k) {
    const int v = warp_sums[k];
    before += k < warp ? v : 0;
    count += v;
  }
  const double draw = u_is_double ? static_cast<const double*>(u)[p]
                                  : (double)static_cast<const float*>(u)[p];
  const long long k = min((long long)(draw * (double)count), (long long)max(count - 1, 0));
  if (count > 0 && k >= before && k < before + mine) {
    int rest = (int)(k - before);
    for (int s = lo; s < hi; ++s) {
      uint32_t x = bits[s];
      const int c = __popc(x);
      if (rest < c) {
        for (; rest > 0; --rest) x &= x - 1u;
        bits[2 * n + s] = x & (0u - x);
        break;
      }
      rest -= c;
    }
  }
  __syncthreads();

  // The growth: steps of a red and a black half-step until one changes
  // nothing.
  const uint32_t* q_red = bits;
  const uint32_t* q_black = bits + n;
  uint32_t* m_red = bits + 2 * n;
  uint32_t* m_black = bits + 3 * n;
  const int last = (C2 - 1) & 31;
  int steps = 0, more;
  do {
    ++steps;
    bool changed = false;
    for (int i = t; i < n; i += NT)
      changed |= grow_word(m_red, q_red, m_black, i, R, W, last, periodic, 0);
    __syncthreads();
    for (int i = t; i < n; i += NT)
      changed |= grow_word(m_black, q_black, m_red, i, R, W, last, periodic, 1);
    more = __syncthreads_or(changed);
  } while (more);

  // The flip, a warp per word.
  U* o_r1 = static_cast<U*>(pr.o_r1) + base;
  U* o_b1 = static_cast<U*>(pr.o_b1) + base;
  U* o_r2 = static_cast<U*>(pr.o_r2) + base;
  U* o_b2 = static_cast<U*>(pr.o_b2) + base;
  for (int s = warp; s < 2 * n; s += NWARPS) {
    const bool black = s >= n;
    const int i = black ? s - n : s;
    const int r = i / W, j = (i - r * W) * 32 + lane;
    if (j < C2) {
      const size_t off = (size_t)r * C2 + j;
      const U flip = ((bits[2 * n + s] >> lane) & 1u) ? U(U(1) << (8 * sizeof(U) - 1)) : U(0);
      if (black) {
        o_b1[off] = U(b1[off] ^ flip);
        o_b2[off] = U(b2[off] ^ flip);
      } else {
        o_r1[off] = U(r1[off] ^ flip);
        o_r2[off] = U(r2[off] ^ flip);
      }
    }
  }

  if (t == 0) steps_out[p] = steps;
}

template <typename E, bool SMEM>
int launch(const Pair& pr, const void* u, int u_is_double, uint32_t* scratch, int* steps_out,
           int B, int R, int C2, int periodic, cudaStream_t stream) {
  const int W = (C2 + 31) / 32;
  const size_t smem = SMEM ? (size_t)16 * R * W : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(houdayer_cluster_kernel<E, SMEM>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  houdayer_cluster_kernel<E, SMEM><<<B, NT, smem, stream>>>(pr, u, u_is_double, scratch,
                                                            steps_out, R, C2, W, periodic);
  return (int)cudaGetLastError();
}

template <typename E>
int launch_route(const Pair& pr, const void* u, int u_is_double, uint32_t* scratch,
                 int* steps_out, int B, int R, int C2, int periodic, cudaStream_t stream) {
  return scratch ? launch<E, false>(pr, u, u_is_double, scratch, steps_out, B, R, C2, periodic,
                                    stream)
                 : launch<E, true>(pr, u, u_is_double, scratch, steps_out, B, R, C2, periodic,
                                   stream);
}

}  // namespace

// One Houdayer move of B replica pairs on `stream`. r1, b1, r2, b2 are the
// (B, R, C2) red and black planes of each pair's two replicas, contiguous, of
// the type `dtype` names (DT_F32, DT_BF16, DT_F16 or DT_F64); o_* the four
// output planes; u the B uniforms, float32 or float64 (u_is_double); scratch
// null for the shared route, else (B, 4, R, ceil(C2 / 32)) words; steps_out
// B int32, where pair i's growth steps go. 1 <= B, 1 <= R, 1 <= C2, and
// 2 R C2 < 2^31. Returns cudaGetLastError() after the launch, or the error of
// raising the kernel's shared memory; 1 (cudaErrorInvalidValue) for another
// dtype.
extern "C" int tsu_houdayer_cluster(const void* r1, const void* b1, const void* r2,
                                    const void* b2, void* o_r1, void* o_b1, void* o_r2,
                                    void* o_b2, const void* u, int u_is_double, int dtype,
                                    int B, int R, int C2, int periodic, void* scratch,
                                    void* steps_out, void* stream) {
  const Pair pr = {r1, b1, r2, b2, o_r1, o_b1, o_r2, o_b2};
  uint32_t* s = static_cast<uint32_t*>(scratch);
  int* steps = static_cast<int*>(steps_out);
  const auto st = (cudaStream_t)stream;
  switch (dtype) {
    case DT_F32: return launch_route<F32>(pr, u, u_is_double, s, steps, B, R, C2, periodic, st);
    case DT_BF16: return launch_route<Bf16>(pr, u, u_is_double, s, steps, B, R, C2, periodic, st);
    case DT_F16: return launch_route<F16>(pr, u, u_is_double, s, steps, B, R, C2, periodic, st);
    case DT_F64: return launch_route<F64>(pr, u, u_is_double, s, steps, B, R, C2, periodic, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The dynamic shared memory a block of the kernel may take on the current
// device: the opt-in limit less the largest static shared memory of its
// element types.
extern "C" int tsu_houdayer_smem_limit(int* bytes) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  size_t most = 0;
  const void* kernels[] = {(const void*)houdayer_cluster_kernel<F32, true>,
                           (const void*)houdayer_cluster_kernel<Bf16, true>,
                           (const void*)houdayer_cluster_kernel<F16, true>,
                           (const void*)houdayer_cluster_kernel<F64, true>};
  for (const void* k : kernels) {
    cudaFuncAttributes a;
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, k);
    if (e == cudaSuccess && a.sharedSizeBytes > most) most = a.sharedSizeBytes;
  }
  if (e == cudaSuccess) *bytes = optin - (int)most;
  return (int)e;
}
