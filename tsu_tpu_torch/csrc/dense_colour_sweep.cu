// One systematic-scan colour sweep of a batch of dense Boltzmann chains in one
// launch (K10).
//
// Replaces no TPU kernel. The JAX package's dense engine runs its colour steps
// as XLA matrix products on one-hot tables (tsu_tpu/samplers/gibbs.py); the
// port's plain version is colour_step in tsu_tpu_torch/samplers/gibbs.py: a
// colour of the plan's slice a:b is
//
//   field = states @ J[a:b].T + h[a:b] - diag[a:b] * states[:, a:b]
//   states[:, a:b] = u[:, a:b] < sigmoid(field / T)
//
// in float32, which on the card is cuBLAS's gemv and five ATen element-wise
// kernels a colour, ~7 launches of ~1.5 us each. A 4,096-spin SK plan has a
// colour a site, so a sweep was 28,672 small kernels replayed from a CUDA graph.
// This kernel computes the same function, site for site, in one launch a
// sweep: for site k of a colour and chain r,
//
//   field = sum_j J[k, j] b_j + h_k - diag_k b_k,   b_k = u[r, k] < 1 / (1 + expf(-field / T_r))
//
// with the precise expf and true divisions (no -use_fast_math), the bits of the
// colour read as they were before it. Only the order of the sum differs from
// cuBLAS, so with integer-valued J and h (every partial sum exact) the bits
// equal the plain version's bit for bit.
//
// What bounds it. A chain's sweep is a chain of n_colors dependent steps: each
// colour reads its rows of J (4 n bytes a site), takes a block-wide sum a site
// and decides. The bytes are few (a 4,096-spin sweep reads the 64 MB of J
// once from device memory, ~20 us at 3.35 TB/s, and each chain's block reads
// it from L2), so at a colour a site the latency of one step bounds the sweep:
// a row's dot product, a warp's shuffle sum, a barrier, the sum over the
// warps, the sigmoid and the decision, n times in a row. On an H100 a step
// of 4,096 spins takes ~0.57 us: ~0.3 us the row's share of every warp
// (five shuffle levels of ~45 cycles each the most), ~0.19 us the decision
// (the sum, two true divisions and expf), ~0.1 us the barrier's wait.
//
// What the design does about it.
//  - A chain is one block; the chains of a batch are independent within a
//    sweep and run side by side on their own SMs. (A chain on a cluster of
//    two blocks, each with half the columns and the partial sums read through
//    distributed shared memory, took 5.91 against 3.65 ms a sweep of 4,096
//    spins x 64 chains on an H100, in this kernel's first body: the cluster
//    barrier costs more a step than the second SM saves.)
//  - A thread owns four adjacent columns per chunk (C chunks) and keeps their
//    bits in registers for the whole sweep, with the bits the sweep started
//    from, the uniforms, h and diag in shared memory. The only exchange a
//    colour is each warp's partial sums in shared memory and one barrier.
//  - The rows are walked in plan order, the same order in every chain, so each
//    thread keeps a ring of D rows' 16-byte pieces in flight with cp.async
//    (a thread copies and reads only its own pieces: no barrier for the ring)
//    and no step waits for L2; the warp's shuffle sum goes before the copy's
//    wait. The blocks walk the same rows in near lockstep, so J comes from
//    device memory about once a sweep.
//  - At a colour's end, after the one barrier, the warps' partials are summed
//    in a fixed pairwise tree. A one-site colour is decided by every thread,
//    the same arithmetic on the same shared values, so no warp waits on a
//    branch of the owner's; the owner keeps the bit. A wider colour's sites
//    are decided by their owners. The partials are double-buffered, so one
//    barrier a colour is enough.
//  - The block's width is the host's (ops/dense_sweep_kernel.py:geometry): at
//    4,096 spins x 64 chains on an H100 a sweep took 2.92 ms at 512 threads of
//    two chunks and at 1,024 of one, 3.85 at 256 of four and 6.85 at 128 of
//    eight: a thread's serial work a step grows faster than the barrier and
//    the sums shrink, so a thread takes at most two chunks.
//  - A colour of w sites costs w dot products and warp sums but one barrier,
//    so narrow colours of any width take this route; for wide colours one
//    matrix product a colour is the better tool, and the host's route rule
//    (samplers/gibbs.py:dense_route) keeps those on the graph of colour steps.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL_MASK = 0xFFFFFFFFu;

struct Args {
  float* states;        // (chains, n) bits in plan order, updated in place
  const float* u;       // (chains, n) uniforms in plan order
  const float* T;       // (chains,) temperatures
  const float* J;       // (n, ldj) couplings in plan order, zero past column n
  const float* h;       // (n,)
  const float* diag;    // (n,)
  const int* ends;      // (n_colors,) the end of each colour's slice, the last n
  int n, ldj, n_colors, widest;
};

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The sum of NW partials in a fixed pairwise tree: ((p0 + p1) + (p2 + p3)) + ...
template <int NW>
__device__ __forceinline__ float sum_partials(const float* p) {
  static_assert(NW == 4 || NW == 8 || NW == 16, "4, 8 or 16 warps");
  float v[NW];
#pragma unroll
  for (int w = 0; w < NW; w += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + w);
    v[w] = q.x;
    v[w + 1] = q.y;
    v[w + 2] = q.z;
    v[w + 3] = q.w;
  }
  constexpr int LEVELS = NW == 4 ? 2 : NW == 8 ? 3 : 4;
#pragma unroll
  for (int l = 0; l < LEVELS; ++l) {
#pragma unroll
    for (int w = 0; w < NW; w += 2 << l) v[w] = v[w] + v[w + (1 << l)];
  }
  return v[0];
}

constexpr int D = 4;    // rows of J in flight

// One sweep of chain blockIdx.x by a block of NW warps, C 16-byte column
// pieces a thread.
template <int NW, int C>
__global__ void __launch_bounds__(NW * 32, 1) dense_colour_sweep_kernel(const Args a) {
  constexpr int NT = NW * 32;
  constexpr int OWN = 4 * NT * C;                      // floats of a row this block holds
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);       // D x OWN
  float* s_b = ring + D * OWN;                         // OWN: the bits, as the registers
  float* s_u = s_b + OWN;                              // OWN: this chain's uniforms
  float* s_h = s_u + OWN;                              // OWN: h
  float* s_d = s_h + OWN;                              // OWN: diag
  float* part = s_d + OWN;                             // 2 x widest x NW
  int* s_ends = reinterpret_cast<int*>(part + 2 * a.widest * NW);   // n_colors
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int r = blockIdx.x;

  const int n = a.n;
  float* st = a.states + static_cast<size_t>(r) * n;
  const float* ur = a.u + static_cast<size_t>(r) * n;
  const float Tr = a.T[r];

  // The columns this thread owns, 4 (t + NT i) + e for chunk i and e < 4, at
  // the same index in shared memory. s_b keeps the bits the sweep started
  // from: a site is decided once a sweep, so its old bit is that one.
  float b[C][4];
  bool has[C];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int c0 = 4 * (t + NT * i);
    has[i] = c0 < a.ldj;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = c0 + e;
      const bool in = col < n;
      b[i][e] = in ? st[col] : 0.f;
      s_b[col] = b[i][e];
      s_u[col] = in ? ur[col] : 1.f;
      s_h[col] = in ? a.h[col] : 0.f;
      s_d[col] = in ? a.diag[col] : 0.f;
    }
  }

  auto copy_row = [&](int row) {
    float* slot = ring + (row % D) * OWN;
    const float* src = a.J + static_cast<size_t>(row) * a.ldj;
#pragma unroll
    for (int i = 0; i < C; ++i)
      if (has[i]) cp_async16(slot + 4 * (t + NT * i), src + 4 * (t + NT * i));
  };
  float4 x[C];
  auto fetch = [&](int row) {
    const float* slot = ring + (row % D) * OWN;
#pragma unroll
    for (int i = 0; i < C; ++i)
      x[i] = has[i] ? *reinterpret_cast<const float4*>(slot + 4 * (t + NT * i))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  };

  for (int i = t; i < a.n_colors; i += NT) s_ends[i] = a.ends[i];
#pragma unroll
  for (int s = 0; s < D; ++s) {
    if (s < n) copy_row(s);
    cp_async_commit();
  }
  cp_async_wait<D - 1>();
  fetch(0);
  __syncthreads();

  int c = 0, start = 0, buf = 0;
  int end = s_ends[0];

  for (int k = 0; k < n; ++k) {
    // This thread's share of site k's sum, from the bits before k's colour,
    // one accumulator a lane of the pieces.
    float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      p0 = fmaf(x[i].x, b[i][0], p0);
      p1 = fmaf(x[i].y, b[i][1], p1);
      p2 = fmaf(x[i].z, b[i][2], p2);
      p3 = fmaf(x[i].w, b[i][3], p3);
    }
    float p = (p0 + p1) + (p2 + p3);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) p += __shfl_xor_sync(FULL_MASK, p, off);
    if (lane == 0) part[(buf * a.widest + (k - start)) * NW + warp] = p;
    // Row k's slot is free again: refill it with row k + D, then wait for
    // row k + 1 and take this thread's piece of it. (After the shuffles, so
    // that they do not wait behind the copy.)
    if (k + D < n) copy_row(k + D);
    cp_async_commit();
    cp_async_wait<D - 1>();
    if (k + 1 < n) fetch(k + 1);
    if (k + 1 != end) continue;

    // The colour [start, end) is summed.
    __syncthreads();
    if (end - start == 1) {
      // A colour of one site: every thread decides it, the same arithmetic
      // on the same shared values, so no warp waits on the owner's branch;
      // the owner takes the bit into its registers.
      const float f = fmaf(-s_d[start], s_b[start],
                           sum_partials<NW>(part + buf * a.widest * NW) + s_h[start]);
      const float bit = s_u[start] < 1.0f / (1.0f + expf(-(f / Tr))) ? 1.0f : 0.0f;
#pragma unroll
      for (int i = 0; i < C; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * (t + NT * i) + e == start) b[i][e] = bit;
      }
      buf ^= 1;
      start = end;
      end = ++c < a.n_colors ? s_ends[c] : n;
      continue;
    }
    // A wider colour: the owner of each of its sites decides it (the
    // arithmetic written once, the new bit kept in s_b, which only the owner
    // reads), then takes the new bits into its registers.
    int last_col = -1;
    float last_bit = 0.f;
#pragma unroll 1
    for (int i = 0; i < C; ++i) {
      const int c0 = 4 * (t + NT * i);
      const int hi = min(c0 + 4, end);
#pragma unroll 1
      for (int col = max(c0, start); col < hi; ++col) {
        float f = sum_partials<NW>(part + (buf * a.widest + (col - start)) * NW);
        f = f + s_h[col];
        f = fmaf(-s_d[col], s_b[col], f);
        const float prob = 1.0f / (1.0f + expf(-(f / Tr)));
        last_bit = s_u[col] < prob ? 1.0f : 0.0f;
        s_b[col] = last_bit;
        last_col = col;
      }
    }
    if (last_col >= 0) {
#pragma unroll
      for (int i = 0; i < C; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 4 * (t + NT * i) + e;
          if (col >= start && col < end) b[i][e] = col == last_col ? last_bit : s_b[col];
        }
      }
    }
    buf ^= 1;
    start = end;
    end = ++c < a.n_colors ? s_ends[c] : n;
  }

#pragma unroll
  for (int i = 0; i < C; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 4 * (t + NT * i) + e;
      if (col < n) st[col] = b[i][e];
    }
  }
}

// Raises the dynamic shared memory that `kernel` may take to `smem` bytes,
// where that is over the default 48 KB.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// f(warps, chunks) with both as std::integral_constant, for a block of
// `threads` threads (128, 256 or 512) of `chunks` pieces a thread (1 or 2);
// cudaErrorInvalidValue for any other block.
template <int C, typename F>
int with_warps(int threads, F&& f) {
  switch (threads) {
    case 128: return f(std::integral_constant<int, 4>{}, std::integral_constant<int, C>{});
    case 256: return f(std::integral_constant<int, 8>{}, std::integral_constant<int, C>{});
    case 512: return f(std::integral_constant<int, 16>{}, std::integral_constant<int, C>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename F>
int with_block(int threads, int chunks, F&& f) {
  switch (chunks) {
    case 1: return with_warps<1>(threads, f);
    case 2: return with_warps<2>(threads, f);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// One colour sweep of `chains` chains on `stream`. states, u: (chains, n)
// float32 in plan order; T: (chains,) float32; J: (n, ldj) float32, ldj a
// multiple of 4 and at least n, zero past column n, 16-byte aligned; h, diag:
// (n,) float32; ends: (n_colors,) int32, the exclusive end of each colour's
// slice in plan order, increasing, the last n; widest: the most sites of a
// colour. threads: 128, 256 or 512, with 4 * threads * chunks >= ldj;
// chunks 1 or 2; smem: the dynamic shared memory, at least 4 * (8 * 4 *
// threads * chunks + 2 * widest * threads / 32 + n_colors) bytes (the ring of 4 rows,
// the owned columns' bits, uniforms, h and diag, the partial sums, the
// colours' ends). Returns
// cudaGetLastError() after the launch, the error of raising the kernel's
// shared memory, or 1 (cudaErrorInvalidValue) for a geometry outside these.
extern "C" int tsu_dense_colour_sweep(void* states, const void* u, const void* T, const void* J,
                                      const void* h, const void* diag, const void* ends,
                                      int chains, int n, int ldj, int n_colors, int widest,
                                      int threads, int chunks, long long smem, void* stream) {
  const Args a = {static_cast<float*>(states), static_cast<const float*>(u),
                  static_cast<const float*>(T), static_cast<const float*>(J),
                  static_cast<const float*>(h), static_cast<const float*>(diag),
                  static_cast<const int*>(ends), n, ldj, n_colors, widest};
  const auto st = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(smem);
  return with_block(threads, chunks, [&](auto warps, auto pieces) {
    constexpr int NW = decltype(warps)::value, C = decltype(pieces)::value;
    const auto kernel = dense_colour_sweep_kernel<NW, C>;
    cudaError_t e = allow_smem(kernel, bytes);
    if (e == cudaSuccess) {
      kernel<<<chains, NW * 32, bytes, st>>>(a);
      e = cudaGetLastError();
    }
    return static_cast<int>(e);
  });
}

// The blocks of the launch (threads, chunks, smem bytes), as above, that one
// SM of the current device holds at once, by the occupancy calculator
// (threads, registers and shared memory), in *blocks. Returns the CUDA error.
extern "C" int tsu_dense_colour_sweep_blocks_per_sm(int threads, int chunks, long long smem,
                                                    int* blocks) {
  const size_t bytes = static_cast<size_t>(smem);
  return with_block(threads, chunks, [&](auto warps, auto pieces) {
    constexpr int NW = decltype(warps)::value, C = decltype(pieces)::value;
    const auto kernel = dense_colour_sweep_kernel<NW, C>;
    cudaError_t e = allow_smem(kernel, bytes);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, NW * 32, bytes);
    return static_cast<int>(e);
  });
}
