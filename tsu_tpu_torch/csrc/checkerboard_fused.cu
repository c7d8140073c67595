// Fused checkerboard heat-bath sweeps of the uniform-J 2-D Ising model.
//
// Replaces two Pallas TPU kernels of tsu_tpu/ops/checkerboard_fused.py on
// NVIDIA Hopper (sm_90a): _fused_sweep_kernel (one lattice) and
// _fused_sweep_kernel_batched (B lattices, each with its own Philox key and
// threshold table, in one launch). One launch is one full sweep: red from
// black, then black from the new red, on the compact (R, C/2) planes of
// tsu_tpu/ops/checkerboard.py. Both kernels run the same tile body; the
// batched one takes its lattice from blockIdx.z and loads that lattice's key
// and table, so element b is what the single-lattice kernel gives under b's
// key.
//
// Design. Blocks run in parallel and in no order, so the TPU kernel's
// in-place update of black cannot be carried over: a block that reads black
// rows next to its tile would race a neighbour writing them. Each launch
// reads black_in and writes red_out and a separate black_out (ping-pong). A
// block owns a TR x TC tile of output sites. It stages black for the tile plus
// two halo rows and columns on every side in shared memory, recomputes the
// new red for the tile plus one halo row and column (the halo reds are the
// neighbours' outputs, recomputed bit-identically), then updates black from
// the staged red. Spins sit in shared memory as int8; the local field is an
// exact integer in {-4..4} and indexes a 9-entry 16-bit threshold table that
// the wrapper computes per sweep (per lattice in the batched kernel).
//
// Random numbers. Each site takes one 32-bit word from Philox4x32-10 keyed by
// (fold_seed(base), sweep) at counter (row, col / 4, 0, 0), output col % 4:
// lo16 drives the red update, hi16 the black one. The word depends only on
// the site's global coordinates, so the halo reds a block redraws equal what
// the owning block drew. One Philox call serves four sites of a quad;
// tsu_tpu_torch/rng.py:philox_words is the same generator in PyTorch. With
// injected uniforms (2, R, C2) int32 per lattice, [0] drives red and [1]
// black.
//
// Shard mode. fused_sweep_shard_kernel is K1 on one shard of a row-sharded
// lattice, the reference kernel's mode with external halos (up2/down2,
// shard_info, uniforms_halo of fused_sweep_pallas): the rows past the plane's
// edges come from the neighbour shards' halo rows instead of the plane's
// wrap, and the draws are keyed by global rows. The red rows a shard
// recomputes at its edges are then its neighbours' stored rows bit for bit,
// and a sharded run returns what one lattice would. It is sweep_tile under
// SHARD = true; the other kernels instantiate SHARD = false.
//
// Bound. At bf16 a sweep moves ~3 B/site of compulsory traffic (read black,
// write red, write black: three half-lattice planes of 2 B), ~3.3 B/site with
// the staged halo, against 3.35 TB/s; Philox adds ~0.3 calls (10 rounds of two
// 32x32 multiplies) per site. The tile keeps each red in shared memory between
// the two colour updates, so red is never read back from device memory, and
// the quad-wide Philox call shares one generator call among four sites. On an
// H100 SXM at 700 W a 4096^2 sweep takes 93 us, ~0.3 TB/s: the integer and
// shared-memory work, not HBM, bounds this first version, and the batched
// kernel (16 x 1024^2 is the same work) has the same bound. Plane offsets are
// size_t: B * R * C2 passes 2^31 at 256 lattices of 4096^2.
//
// Cost decomposition. decomposition_kernel replaces the variants of
// make_kernel(mode) in scripts/kernel_decomposition.py, which time the TPU
// kernel with parts taken out. Here they are K1's tile body under a Mode
// template parameter (FULL, the default, is K1 itself): the same grid, tiles
// and Philox keys, with the select chain and second colour (NOMATH), then
// the staged black and its reads (PRNG_GROUPED), then the halo redraws and
// the shared-memory staging (PRNG_ONLY) removed. Their times, beside K1's,
// attribute K1's time to those parts: what ncu would say, on a machine where
// ncu does not run. Each still writes both planes (~2 B/site/plane), and
// NOMATH reads black too, so device memory sets the same floor as for K1.

#include "tsu_common.cuh"

namespace {

constexpr int TR = 16;         // output rows per block
constexpr int TC = 128;        // output compact columns per block (multiple of 4)
constexpr int NT = 256;        // threads per block
constexpr int SB_R = TR + 4;   // staged black rows: r0-2 .. r0+TR+1
constexpr int SB_C = TC + 4;   // staged black cols: c0-2 .. c0+TC+1
constexpr int SR_R = TR + 2;   // new red rows: r0-1 .. r0+TR
constexpr int SR_C = TC + 2;   // new red cols: c0-1 .. c0+TC
constexpr int NG = TC / 4 + 2; // red work items per row: col c0-1, TC/4 quads, col c0+TC

// Global index i on an axis of length n: wrapped when periodic, -1 when it
// falls outside an open lattice.
__device__ __forceinline__ int wrap_or_out(int i, int n, int periodic) {
  if (i >= 0 && i < n) return i;
  if (!periodic) return -1;
  i %= n;
  return i < 0 ? i + n : i;
}

// What a tile computes. FULL is the heat-bath sweep (K1, K2). The others are
// the cost-decomposition variants of scripts/kernel_decomposition.py:41
// (make_kernel), each K1 with parts taken out, same tiles and keying:
//   PRNG_ONLY    one Philox word per tile site, red = lo16 < 32768, black =
//                hi16 < 32768; nothing is read;
//   PRNG_GROUPED K1's whole draw pattern, the words it redraws for its red
//                halo included, thresholded at 32768; nothing is read (the
//                reference's 8-row-group seeding has no GPU counterpart, so
//                its port isolates the halo redraws instead);
//   NOMATH       the whole draw pattern and the staged black's vertical reads:
//                red = lo16 < (up + centre + down) * 1000 + 32768, black_out =
//                red_out; no horizontal partner, table or second colour.
enum Mode { FULL = 0, PRNG_ONLY = 1, PRNG_GROUPED = 2, NOMATH = 3 };

// PRNG_ONLY: each thread draws quads of tile sites and writes both planes.
template <typename T>
__device__ __forceinline__ void prng_only_tile(
    T* __restrict__ red_out, T* __restrict__ black_out, const int* __restrict__ uniforms,
    int R, int C2, uint32_t k0, uint32_t k1) {
  const int r0 = blockIdx.y * TR;
  const int c0 = blockIdx.x * TC;
  const size_t plane = (size_t)R * C2;
  for (int idx = threadIdx.x; idx < TR * (TC / 4); idx += NT) {
    const int gr = r0 + idx / (TC / 4), gc0 = c0 + 4 * (idx % (TC / 4));
    if (gr >= R || gc0 >= C2) continue;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (uniforms == nullptr)
      w = philox4x32_10(make_uint4((uint32_t)gr, (uint32_t)(gc0 >> 2), 0u, 0u), k0, k1);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (gc0 + t >= C2) break;
      const size_t o = (size_t)gr * C2 + gc0 + t;
      const int lo = uniforms != nullptr ? uniforms[o] : (int)(pick(w, t) & 0xFFFFu);
      const int hi = uniforms != nullptr ? uniforms[plane + o] : (int)(pick(w, t) >> 16);
      red_out[o] = from_f32<T>(lo < 32768 ? 1.0f : -1.0f);
      black_out[o] = from_f32<T>(hi < 32768 ? 1.0f : -1.0f);
    }
  }
}

// Shard mode: the plane is rows [row0, row0 + R) of a lattice of R_global
// rows, sharded by rows only. Rows outside [0, R) come from the neighbours:
// black from up2 (global rows row0-2, row0-1) and down2 (row0+R, row0+R+1),
// the red extension rows -1 and R are recomputed from them and drawn at their
// global rows (wrapped), or read from the injected u_top / u_bot (the
// neighbours' red uniforms of those rows). At an open lattice's global top
// (is_top) or bottom (is_bot) the caller's halos are zeros and the extension
// row is 0, as outside one lattice.
template <typename T>
struct Shard {
  const T* up2;
  const T* down2;
  const int* u_top;
  const int* u_bot;
  int row0, R_global, is_top, is_bot;
};

// One sweep of the tile (blockIdx.y, blockIdx.x) of one lattice; MODE FULL
// is the heat-bath sweep, PRNG_GROUPED and NOMATH its ablations (above).
// SHARD takes the plane's outside rows from `sh` instead of wrapping.
template <typename T, int MODE = FULL, bool SHARD = false>
__device__ __forceinline__ void sweep_tile(
    const T* __restrict__ black_in, T* __restrict__ red_out, T* __restrict__ black_out,
    const int* __restrict__ table, const int* __restrict__ uniforms, int R, int C2,
    int periodic, uint32_t k0, uint32_t k1, const Shard<T>& sh = Shard<T>{}) {
  __shared__ int8_t sb[SB_R][SB_C];     // black, staged with halos (0 outside an open lattice)
  __shared__ int8_t sr[SR_R][SR_C];     // new red, with one halo row/col
  __shared__ uint16_t sub[TR][TC];      // hi16 words for the black update (PRNG mode)
  __shared__ int st[9];                 // thresholds for local fields -4..4

  const int tid = threadIdx.x;
  const int r0 = blockIdx.y * TR;
  const int c0 = blockIdx.x * TC;
  const size_t plane = (size_t)R * C2;

  if constexpr (MODE == FULL) {
    if (tid < 9) st[tid] = table[tid];
  }
  if constexpr (MODE != PRNG_GROUPED) {
    for (int idx = tid; idx < SB_R * SB_C; idx += NT) {
      const int i = idx / SB_C, j = idx % SB_C;
      const int gc = wrap_or_out(c0 - 2 + j, C2, periodic);
      if constexpr (SHARD) {
        // Local rows -2, -1 are up2's, R and R+1 down2's; rows past R+1 feed
        // no output.
        const int lr = r0 - 2 + i;
        const T* row = lr < 0 ? sh.up2 + (size_t)(lr + 2) * C2
                       : lr < R ? black_in + (size_t)lr * C2
                       : lr <= R + 1 ? sh.down2 + (size_t)(lr - R) * C2 : nullptr;
        sb[i][j] = (row != nullptr && gc >= 0) ? (int8_t)__float2int_rn(to_f32(row[gc]))
                                               : (int8_t)0;
      } else {
        const int gr = wrap_or_out(r0 - 2 + i, R, periodic);
        sb[i][j] = (gr >= 0 && gc >= 0)
            ? (int8_t)__float2int_rn(to_f32(black_in[(size_t)gr * C2 + gc])) : (int8_t)0;
      }
    }
  }
  __syncthreads();

  // Red update on rows r0-1..r0+TR, cols c0-1..c0+TC. Red site (i, j) sits
  // at staged-black (i+1, j+1); its horizontal partner is column j-1 on even
  // rows and j+1 on odd rows.
  for (int idx = tid; idx < SR_R * NG; idx += NT) {
    const int i = idx / NG, g = idx % NG;
    // `in`: the row is inside the lattice; lr: its row in the plane, whose
    // parity picks the partner; pr: its row in the lattice, which keys its
    // draw; u_row: its injected red uniforms.
    int lr, pr;
    bool in;
    const int* u_row = uniforms;
    if constexpr (SHARD) {
      lr = r0 - 1 + i;
      in = lr < 0 ? periodic || !sh.is_top : lr < R || (lr == R && (periodic || !sh.is_bot));
      pr = (sh.row0 + lr + sh.R_global) % sh.R_global;
      if (uniforms != nullptr && in)
        u_row = lr < 0 ? sh.u_top : lr == R ? sh.u_bot : uniforms + (size_t)lr * C2;
    } else {
      const int gr = wrap_or_out(r0 - 1 + i, R, periodic);   // -1 outside an open lattice
      in = gr >= 0;
      lr = pr = gr;
      if (uniforms != nullptr && in) u_row = uniforms + (size_t)gr * C2;
    }
    const int j0 = g == 0 ? 0 : g == NG - 1 ? SR_C - 1 : 1 + 4 * (g - 1);
    const int n = (g == 0 || g == NG - 1) ? 1 : 4;
    const int gc0 = c0 - 1 + j0;
    // A whole quad inside the lattice shares one Philox call.
    const bool quad = uniforms == nullptr && n == 4 && in && gc0 + 3 < C2;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (quad) w = philox4x32_10(make_uint4((uint32_t)pr, (uint32_t)(gc0 >> 2), 0u, 0u), k0, k1);
    for (int t = 0; t < n; ++t) {
      const int j = j0 + t;
      const int gc = wrap_or_out(gc0 + t, C2, periodic);
      int8_t s = 0;
      if (in && gc >= 0) {
        int u_red;
        if (uniforms != nullptr) {
          u_red = u_row[gc];
        } else {
          const uint32_t word = quad ? pick(w, t) : site_word(pr, gc, k0, k1);
          u_red = (int)(word & 0xFFFFu);
          const int bi = i - 1, bj = j - 1;
          if (MODE != NOMATH && bi >= 0 && bi < TR && bj >= 0 && bj < TC)
            sub[bi][bj] = (uint16_t)(word >> 16);
        }
        if constexpr (MODE == FULL) {
          const int horiz = (lr & 1) ? sb[i + 1][j + 2] : sb[i + 1][j];
          const int nbr = sb[i][j + 1] + sb[i + 2][j + 1] + sb[i + 1][j + 1] + horiz;
          s = u_red < st[nbr + 4] ? 1 : -1;
        } else if constexpr (MODE == NOMATH) {
          const int nbr = sb[i][j + 1] + sb[i + 1][j + 1] + sb[i + 2][j + 1];
          s = u_red < nbr * 1000 + 32768 ? 1 : -1;
        } else {
          s = u_red < 32768 ? 1 : -1;
        }
      }
      sr[i][j] = s;
    }
  }
  __syncthreads();

  // Black update of the tile from the new red; black site (bi, bj) sits at
  // red (bi+1, bj+1); its horizontal partner is column +1 on even rows and
  // -1 on odd rows.
  for (int idx = tid; idx < TR * TC; idx += NT) {
    const int bi = idx / TC, bj = idx % TC;
    const int gr = r0 + bi, gc = c0 + bj;
    if (gr >= R || gc >= C2) continue;
    const int i = bi + 1, j = bj + 1;
    const size_t o = (size_t)gr * C2 + gc;
    red_out[o] = from_f32<T>((float)sr[i][j]);
    if constexpr (MODE == FULL) {
      const int horiz = (gr & 1) ? sr[i][j - 1] : sr[i][j + 1];
      const int nbr = sr[i - 1][j] + sr[i + 1][j] + sr[i][j] + horiz;
      const int u_black = uniforms != nullptr ? uniforms[plane + o] : (int)sub[bi][bj];
      black_out[o] = from_f32<T>(u_black < st[nbr + 4] ? 1.0f : -1.0f);
    } else if constexpr (MODE == NOMATH) {
      black_out[o] = from_f32<T>((float)sr[i][j]);
    } else {
      const int u_black = uniforms != nullptr ? uniforms[plane + o] : (int)sub[bi][bj];
      black_out[o] = from_f32<T>(u_black < 32768 ? 1.0f : -1.0f);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) fused_sweep_kernel(
    const T* __restrict__ black_in, T* __restrict__ red_out, T* __restrict__ black_out,
    const int* __restrict__ table, const int* __restrict__ uniforms, int R, int C2,
    int periodic, uint32_t k0, uint32_t k1) {
  sweep_tile<T>(black_in, red_out, black_out, table, uniforms, R, C2, periodic, k0, k1);
}

// K1 on one shard of a row-sharded lattice (Shard).
template <typename T>
__global__ void __launch_bounds__(NT) fused_sweep_shard_kernel(
    const T* __restrict__ black_in, T* __restrict__ red_out, T* __restrict__ black_out,
    const int* __restrict__ table, const int* __restrict__ uniforms, int R, int C2,
    int periodic, uint32_t k0, uint32_t k1, Shard<T> sh) {
  sweep_tile<T, FULL, true>(black_in, red_out, black_out, table, uniforms, R, C2, periodic, k0,
                            k1, sh);
}

// Lattice b = blockIdx.z: planes at b * R * C2, table row b, key row b,
// injected uniforms (if any) at b * 2 * R * C2.
template <typename T>
__global__ void __launch_bounds__(NT) fused_sweep_batched_kernel(
    const T* __restrict__ blacks_in, T* __restrict__ reds_out, T* __restrict__ blacks_out,
    const int* __restrict__ tables, const uint32_t* __restrict__ keys,
    const int* __restrict__ uniforms, int R, int C2, int periodic) {
  const size_t b = blockIdx.z;
  const size_t plane = (size_t)R * C2;
  sweep_tile<T>(blacks_in + b * plane, reds_out + b * plane, blacks_out + b * plane,
                tables + 9 * b, uniforms == nullptr ? nullptr : uniforms + 2 * b * plane,
                R, C2, periodic, keys[2 * b], keys[2 * b + 1]);
}

// K1 with parts taken out (Mode), on K1's grid and keys.
template <typename T, int MODE>
__global__ void __launch_bounds__(NT) decomposition_kernel(
    const T* __restrict__ black_in, T* __restrict__ red_out, T* __restrict__ black_out,
    const int* __restrict__ uniforms, int R, int C2, int periodic, uint32_t k0, uint32_t k1) {
  if constexpr (MODE == PRNG_ONLY) {
    prng_only_tile<T>(red_out, black_out, uniforms, R, C2, k0, k1);
  } else {
    sweep_tile<T, MODE>(black_in, red_out, black_out, nullptr, uniforms, R, C2, periodic, k0, k1);
  }
}

template <typename T>
int launch_decomposition(int mode, const void* black_in, void* red_out, void* black_out,
                         const void* uniforms, int R, int C2, int periodic, uint32_t k0,
                         uint32_t k1, cudaStream_t s) {
  const dim3 grid((C2 + TC - 1) / TC, (R + TR - 1) / TR);
  const T* b = (const T*)black_in;
  T* ro = (T*)red_out;
  T* bo = (T*)black_out;
  const int* u = (const int*)uniforms;
  switch (mode) {
    case PRNG_ONLY:
      decomposition_kernel<T, PRNG_ONLY><<<grid, NT, 0, s>>>(b, ro, bo, u, R, C2, periodic, k0, k1);
      break;
    case PRNG_GROUPED:
      decomposition_kernel<T, PRNG_GROUPED><<<grid, NT, 0, s>>>(b, ro, bo, u, R, C2, periodic, k0,
                                                                 k1);
      break;
    case NOMATH:
      decomposition_kernel<T, NOMATH><<<grid, NT, 0, s>>>(b, ro, bo, u, R, C2, periodic, k0, k1);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One sweep on `stream`. black_in, red_out and black_out are (R, C2) planes of
// float32 (is_bf16 == 0) or bfloat16; table is (9,) int32; uniforms is null or
// (2, R, C2) int32. R and C2 are at least 1 and R is even. Returns
// cudaGetLastError() after the launch.
extern "C" int tsu_fused_sweep(const void* black_in, void* red_out, void* black_out,
                               const void* table, const void* uniforms, int R, int C2,
                               int periodic, unsigned int k0, unsigned int k1, int is_bf16,
                               void* stream) {
  const dim3 grid((C2 + TC - 1) / TC, (R + TR - 1) / TR);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    fused_sweep_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(
        (const __nv_bfloat16*)black_in, (__nv_bfloat16*)red_out, (__nv_bfloat16*)black_out,
        (const int*)table, (const int*)uniforms, R, C2, periodic, k0, k1);
  } else {
    fused_sweep_kernel<float><<<grid, NT, 0, s>>>(
        (const float*)black_in, (float*)red_out, (float*)black_out, (const int*)table,
        (const int*)uniforms, R, C2, periodic, k0, k1);
  }
  return (int)cudaGetLastError();
}

// One sweep of one shard of a row-sharded lattice on `stream`: the plane is
// rows [row0, row0 + R) of R_global (row0 even). Operands as
// tsu_fused_sweep's, plus up2 and down2, (2, C2) black halo rows of the
// planes' dtype (global rows row0-2, row0-1 and row0+R, row0+R+1, zeros at an
// open global edge), is_top and is_bot (the shard holds the lattice's first
// or last row), and with uniforms u_top and u_bot, (C2,) int32 red uniforms
// of global rows row0-1 and row0+R. Returns cudaGetLastError() after the
// launch.
extern "C" int tsu_fused_sweep_shard(const void* black_in, void* red_out, void* black_out,
                                     const void* table, const void* uniforms, const void* up2,
                                     const void* down2, const void* u_top, const void* u_bot,
                                     int R, int C2, int row0, int R_global, int is_top,
                                     int is_bot, int periodic, unsigned int k0, unsigned int k1,
                                     int is_bf16, void* stream) {
  const dim3 grid((C2 + TC - 1) / TC, (R + TR - 1) / TR);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    using T = __nv_bfloat16;
    const Shard<T> sh = {(const T*)up2, (const T*)down2, (const int*)u_top, (const int*)u_bot,
                         row0, R_global, is_top, is_bot};
    fused_sweep_shard_kernel<T><<<grid, NT, 0, s>>>(
        (const T*)black_in, (T*)red_out, (T*)black_out, (const int*)table, (const int*)uniforms,
        R, C2, periodic, k0, k1, sh);
  } else {
    const Shard<float> sh = {(const float*)up2, (const float*)down2, (const int*)u_top,
                             (const int*)u_bot, row0, R_global, is_top, is_bot};
    fused_sweep_shard_kernel<float><<<grid, NT, 0, s>>>(
        (const float*)black_in, (float*)red_out, (float*)black_out, (const int*)table,
        (const int*)uniforms, R, C2, periodic, k0, k1, sh);
  }
  return (int)cudaGetLastError();
}

// One sweep of B lattices on `stream`. blacks_in, reds_out and blacks_out are
// (B, R, C2) planes of float32 (is_bf16 == 0) or bfloat16; tables is (B, 9)
// int32; keys is (B, 2) uint32, row b = (fold_seed(seed_b), sweep_b); uniforms
// is null or (B, 2, R, C2) int32. 1 <= B <= 65535 (gridDim.z), R is even.
// Returns cudaGetLastError() after the launch.
extern "C" int tsu_fused_sweep_batched(const void* blacks_in, void* reds_out, void* blacks_out,
                                       const void* tables, const void* keys,
                                       const void* uniforms, int B, int R, int C2,
                                       int periodic, int is_bf16, void* stream) {
  const dim3 grid((C2 + TC - 1) / TC, (R + TR - 1) / TR, B);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    fused_sweep_batched_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(
        (const __nv_bfloat16*)blacks_in, (__nv_bfloat16*)reds_out, (__nv_bfloat16*)blacks_out,
        (const int*)tables, (const uint32_t*)keys, (const int*)uniforms, R, C2, periodic);
  } else {
    fused_sweep_batched_kernel<float><<<grid, NT, 0, s>>>(
        (const float*)blacks_in, (float*)reds_out, (float*)blacks_out, (const int*)tables,
        (const uint32_t*)keys, (const int*)uniforms, R, C2, periodic);
  }
  return (int)cudaGetLastError();
}

// One decomposition variant of the sweep on `stream`: mode 1 PRNG_ONLY, 2
// PRNG_GROUPED, 3 NOMATH (see Mode). Operands as tsu_fused_sweep's, without
// a table; uniforms is null or (2, R, C2) int32 in [0, 2^16) standing for the
// lo16 and hi16 halves of the words. Returns cudaGetLastError() after the
// launch.
extern "C" int tsu_decomposition_sweep(int mode, const void* black_in, void* red_out,
                                       void* black_out, const void* uniforms, int R, int C2,
                                       int periodic, unsigned int k0, unsigned int k1,
                                       int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_decomposition<__nv_bfloat16>(mode, black_in, red_out, black_out, uniforms, R,
                                               C2, periodic, k0, k1, s);
  return launch_decomposition<float>(mode, black_in, red_out, black_out, uniforms, R, C2,
                                     periodic, k0, k1, s);
}
