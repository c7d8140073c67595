// Fused checkerboard heat-bath sweeps of the uniform-J 2-D Ising model.
//
// Replaces two Pallas TPU kernels of tsu_tpu/ops/checkerboard_fused.py on
// NVIDIA Hopper (sm_90a): _fused_sweep_kernel (one lattice) and
// _fused_sweep_kernel_batched (B lattices, each with its own Philox key and
// threshold table, in one launch). One launch is one full sweep: red from
// black, then black from the new red, on the compact (R, C/2) planes of
// tsu_tpu/ops/checkerboard.py. Every kernel here runs one body, sweep_strip;
// the batched one takes its lattice from blockIdx.z and loads that lattice's
// key and table, so element b is what the single-lattice kernel gives under
// b's key.
//
// Design. Blocks run in parallel and in no order, so the TPU kernel's
// in-place update of black cannot be carried over: each launch reads black_in
// and writes red_out and a separate black_out (ping-pong). A thread owns one
// Philox group, four adjacent compact columns starting at a global multiple
// of 4, and walks down a strip of `tr` rows; a warp owns 32 groups, 128
// columns, so its quad loads and stores cover whole 128 B lines. The thread
// keeps black rows r-1, r, r+1 (and r+2, loaded a row ahead) and the new red
// rows r-3, r-2, r-1 in registers as a sliding window. At row r it draws the
// four words of row r in one philox4x32_10 call, updates red row r from
// their lo16, and updates black row r-2 from the hi16 words it kept: black
// lags red by two rows so that the two colours' chains of shuffles and
// table reads do not wait on each other. No barrier and no shared memory
// sits in the row loop (the 9-entry table is read into shared memory once,
// before it). A strip recomputes the red row above and below it (2/tr extra
// red rows, against 2/16 for tiles of 16 rows). Horizontal neighbours
// across a group's edge come from the adjacent lane by __shfl_up_sync /
// __shfl_down_sync; across the warp's edge from an edge batch (sweep_strip).
//
// Spins are read from the sign bit of the bf16 or f32 value (the planes hold
// +-1) and written as 0x3F80 / 0xBF80 (or 0x3F800000 / 0xBF800000); the
// local field is an exact integer in {-4..4} that indexes the 9-entry 16-bit
// threshold table the wrapper computes per sweep (per lattice in the batched
// kernel). Where C2 % 4 == 0 and every plane pointer is aligned to a quad
// (8 B at bf16, 16 B at f32), the C entry picks the vector path (template
// flag VEC): a quad of black is one 8 or 16 B load and each plane write one
// store, lane-consecutive. Otherwise the same kernel loads and stores site by
// site; that scalar path also serves the ragged last group. Injected
// uniforms are a template flag too (INJ), so the Philox kernels carry no
// code for them.
//
// Columns. Lane l of column warp w stands for the virtual columns v0..v0+3,
// v0 = 128 w + 4 l; a virtual column maps to the plane's column by the wrap
// (periodic) or to nothing (open, where its spins count 0). Every value a
// lane holds is the true value at its mapped column, so the neighbour at
// virtual v +- 1 is the mapped column's neighbour, also across a periodic
// edge and past a ragged last group (whose columns past C2 wrap to the
// plane's first ones). A lane stores only where v < C2.
//
// Random numbers. Each site takes one 32-bit word from Philox4x32-10 keyed by
// (fold_seed(base), sweep) at counter (row, col / 4, 0, 0), output col % 4:
// lo16 drives the red update, hi16 the black one. The word depends only on
// the site's global coordinates, so the halo reds a strip or a warp edge
// redraws equal what the owner drew. A lane whose four columns are one
// aligned group draws them in one call; a lane at a ragged or wrapped edge
// draws site by site (site_word). tsu_tpu_torch/rng.py:philox_words is the
// same generator in PyTorch. With injected uniforms (2, R, C2) int32 per
// lattice, [0] drives red and [1] black.
//
// Shard mode. fused_sweep_shard_kernel is K1 on one shard of a row-sharded
// lattice, the reference kernel's mode with external halos (up2/down2,
// shard_info, uniforms_halo of fused_sweep_pallas): the rows past the plane's
// edges come from the neighbour shards' halo rows instead of the plane's
// wrap, and the draws are keyed by global rows. The red rows a shard
// recomputes at its edges are then its neighbours' stored rows bit for bit,
// and a sharded run returns what one lattice would. It is sweep_strip under
// SHARD = true; the other kernels instantiate SHARD = false.
//
// Bound. At bf16 a sweep moves 3 B/site of compulsory traffic (read black,
// write red, write black: three half-lattice planes of 2 B) against
// 3.35 TB/s, 15.0 us at 4096^2; Philox adds one 10-round call per group of
// four sites and row (x (tr + 2) / tr with the halo rows). PERF.md has this
// body's time on an H100 beside the earlier staged-tile body's, and the
// decomposition below splits it into its parts. Plane offsets are size_t: B * R * C2
// passes 2^31 at 256 lattices of 4096^2.
//
// Strips. The C entry picks the strip height tr (a power of two, MAX_TR down
// to 8) as the tallest strip whose grid still holds MIN_WARPS warps: 32 rows
// at 4096^2, 16 for a 1024 x 4096 shard; taller strips redraw fewer halo
// rows, and the grid still fills the card.
//
// Cost decomposition. decomposition_kernel replaces the variants of
// make_kernel(mode) in scripts/kernel_decomposition.py, which time the TPU
// kernel with parts taken out. Here they are K1's strip body under a Mode
// template parameter (FULL, the default, is K1 itself): the same grid,
// strips, lanes and Philox keys, with the select chain, shuffles, warp-edge
// batch and second colour (NOMATH), then the black reads (PRNG_GROUPED),
// then the strips' halo-row redraws (PRNG_ONLY) removed. Their times, beside
// K1's, attribute K1's time to those parts: what ncu would say, on a machine
// where ncu does not run. Each still writes both planes with K1's stores
// (2 B/site/plane), and NOMATH reads black too, so device memory sets the
// same floor as for K1.

#include "tsu_common.cuh"


namespace {

constexpr int NT = 128;              // threads per block: four column warps of one strip
constexpr int WARPS = NT / 32;
constexpr unsigned FULL_MASK = 0xFFFFFFFFu;
constexpr int MAX_TR = 64;           // the tallest strip
constexpr int MIN_WARPS = 1056;      // warps a grid should hold: 132 SMs x 8

// Global index i on an axis of length n: wrapped when periodic, -1 when it
// falls outside an open lattice.
__device__ __forceinline__ int wrap_or_out(int i, int n, int periodic) {
  if (i >= 0 && i < n) return i;
  if (!periodic) return -1;
  i %= n;
  return i < 0 ? i + n : i;
}

// The bits of a plane element: its sign, the pattern of +1, and the vector
// type that holds a quad.
template <typename T> struct Bits;
template <> struct Bits<__nv_bfloat16> {
  using U = uint16_t;
  using Quad = uint2;
  static constexpr uint32_t SIGN = 0x8000u, ONE = 0x3F80u;
};
template <> struct Bits<float> {
  using U = uint32_t;
  using Quad = uint4;
  static constexpr uint32_t SIGN = 0x80000000u, ONE = 0x3F800000u;
};

template <typename T>
__device__ __forceinline__ int spin_of(uint32_t bits) {
  return (bits & Bits<T>::SIGN) ? -1 : 1;
}

template <typename T>
__device__ __forceinline__ uint32_t bits_of(int s) {
  return Bits<T>::ONE | (s < 0 ? Bits<T>::SIGN : 0u);
}

__device__ __forceinline__ void unpack(uint2 q, int s[4]) {
  s[0] = (q.x & 0x8000u) ? -1 : 1;
  s[1] = (q.x & 0x80000000u) ? -1 : 1;
  s[2] = (q.y & 0x8000u) ? -1 : 1;
  s[3] = (q.y & 0x80000000u) ? -1 : 1;
}

__device__ __forceinline__ void unpack(uint4 q, int s[4]) {
  s[0] = (q.x & 0x80000000u) ? -1 : 1;
  s[1] = (q.y & 0x80000000u) ? -1 : 1;
  s[2] = (q.z & 0x80000000u) ? -1 : 1;
  s[3] = (q.w & 0x80000000u) ? -1 : 1;
}

template <typename Quad> __device__ __forceinline__ Quad pack(const int s[4]);
template <> __device__ __forceinline__ uint2 pack<uint2>(const int s[4]) {
  return make_uint2(bits_of<__nv_bfloat16>(s[0]) | (bits_of<__nv_bfloat16>(s[1]) << 16),
                    bits_of<__nv_bfloat16>(s[2]) | (bits_of<__nv_bfloat16>(s[3]) << 16));
}
template <> __device__ __forceinline__ uint4 pack<uint4>(const int s[4]) {
  return make_uint4(bits_of<float>(s[0]), bits_of<float>(s[1]), bits_of<float>(s[2]),
                    bits_of<float>(s[3]));
}

// What a strip computes. FULL is the heat-bath sweep (K1, K2). The others are
// the cost-decomposition variants of scripts/kernel_decomposition.py:41
// (make_kernel), each K1 with parts taken out, same strips, lanes and keying:
//   PRNG_ONLY    one Philox word per owned site, red = lo16 < 32768, black =
//                hi16 < 32768; nothing is read, no halo row drawn;
//   PRNG_GROUPED the strips' draw pattern, the words of their halo rows
//                included, thresholded at 32768; nothing is read (the
//                reference's 8-row-group seeding has no GPU counterpart, so
//                its port isolates the halo redraws instead);
//   NOMATH       that draw pattern and the black reads: red = lo16 <
//                (up + centre + down) * 1000 + 32768, black_out = red_out; no
//                horizontal partner, shuffle, warp-edge batch, table or
//                second colour.
enum Mode { FULL = 0, PRNG_ONLY = 1, PRNG_GROUPED = 2, NOMATH = 3 };

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

// A lane's four columns: gc[t] the plane column of virtual column v0 + t (-1
// outside an open lattice); quad when they are one aligned Philox group;
// own[t] when this lane stores column t, all_own when it stores all four.
struct Cols {
  int gc[4];
  bool quad, own[4], all_own;
};

// Black row lr of the plane (-2 <= lr <= R + 1): its pointer, or null where
// it lies outside an open lattice (its spins count 0). A shard's halo rows
// there are the caller's zeros, which have no sign to read, so they are null
// too.
template <typename T, bool SHARD>
__device__ __forceinline__ const T* black_row(const T* black_in, int lr, int R, int C2,
                                              int periodic, const Shard<T>& sh) {
  if constexpr (SHARD) {
    if (!periodic && ((lr < 0 && sh.is_top) || (lr >= R && sh.is_bot))) return nullptr;
    return lr < 0 ? sh.up2 + (size_t)(lr + 2) * C2
           : lr < R ? black_in + (size_t)lr * C2
           : sh.down2 + (size_t)(lr - R) * C2;
  } else {
    const int gr = wrap_or_out(lr, R, periodic);
    return gr < 0 ? nullptr : black_in + (size_t)gr * C2;
  }
}

template <typename T, bool VEC>
__device__ __forceinline__ void load_quad(const T* row, const Cols& c, int s[4]) {
  using U = typename Bits<T>::U;
  if (row == nullptr) {
#pragma unroll
    for (int t = 0; t < 4; ++t) s[t] = 0;
  } else if (VEC && c.quad) {
    unpack(*reinterpret_cast<const typename Bits<T>::Quad*>(row + c.gc[0]), s);
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t)
      s[t] = c.gc[t] < 0 ? 0 : spin_of<T>(reinterpret_cast<const U*>(row)[c.gc[t]]);
  }
}

template <typename T, bool VEC>
__device__ __forceinline__ void store_quad(T* row, const Cols& c, const int s[4]) {
  using U = typename Bits<T>::U;
  if (VEC && c.all_own) {
    *reinterpret_cast<typename Bits<T>::Quad*>(row + c.gc[0]) = pack<typename Bits<T>::Quad>(s);
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (c.own[t]) reinterpret_cast<U*>(row)[c.gc[t]] = (U)bits_of<T>(s[t]);
  }
}

// Red row lr of the plane: whether it lies inside the lattice (in), its row
// in the lattice (pr, which keys its draw), and its injected red uniforms.
struct RowKey {
  bool in;
  int pr;
  const int* u_row;
};

template <typename T, bool SHARD, bool INJ>
__device__ __forceinline__ RowKey row_key(int lr, const int* uniforms, int R, int C2,
                                          int periodic, const Shard<T>& sh) {
  RowKey k;
  k.u_row = uniforms;
  if constexpr (SHARD) {
    k.in = lr < 0 ? periodic || !sh.is_top : lr < R || periodic || !sh.is_bot;
    k.pr = (sh.row0 + lr + sh.R_global) % sh.R_global;
    if (INJ)
      k.u_row = lr < 0 ? sh.u_top : lr == R ? sh.u_bot : uniforms + (size_t)lr * C2;
  } else {
    k.pr = wrap_or_out(lr, R, periodic);
    k.in = k.pr >= 0;
    if (INJ) k.u_row = uniforms + (size_t)(k.in ? k.pr : 0) * C2;
  }
  return k;
}

// The words of a lane's four sites on red row `k` (zeros with injected
// uniforms or outside the lattice): one Philox call for an aligned group,
// one per site at a ragged or wrapped edge.
template <bool INJ>
__device__ __forceinline__ void draw(const RowKey& k, const Cols& c, const int* uniforms,
                                     uint32_t k0, uint32_t k1, uint32_t w[4]) {
#pragma unroll
  for (int t = 0; t < 4; ++t) w[t] = 0u;
  if (INJ || !k.in) return;
  if (c.quad) {
    const uint4 q = philox4x32_10(make_uint4((uint32_t)k.pr, (uint32_t)(c.gc[0] >> 2), 0u, 0u),
                                  k0, k1);
    w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (c.gc[t] >= 0) w[t] = site_word(k.pr, c.gc[t], k0, k1);
  }
}

// Spin of black row `row` (null: outside an open lattice) at column g (-1:
// outside an open lattice), for the edge columns a warp reads site by site.
template <typename T>
__device__ __forceinline__ int load_site(const T* row, int g) {
  using U = typename Bits<T>::U;
  return row == nullptr || g < 0 ? 0 : spin_of<T>(reinterpret_cast<const U*>(row)[g]);
}

// The edge batch of a warp for red row r (lane i takes row lr0 + i): its
// edge site is column c0-1 on an odd row and c0+128 on an even row, where
// black's horizontal partner lies across the warp's edge. e is the new red
// there (0 outside the lattice), x the black across the warp's other edge,
// red's horizontal partner on row r. Five site loads and a Philox call per
// 32 rows and warp edge, instead of per row.
template <typename T, bool SHARD, bool INJ>
__device__ __forceinline__ void edge_batch(const T* black_in, const int* uniforms, int r, int last,
                                           int c0, int R, int C2, int periodic, uint32_t k0,
                                           uint32_t k1, const int* st, const Shard<T>& sh,
                                           int& x, int& e) {
  x = e = 0;
  if (r > last) return;
  const bool odd = r & 1;
  const int g = wrap_or_out(odd ? c0 - 1 : c0 + 128, C2, periodic);
  const T* row = black_row<T, SHARD>(black_in, r, R, C2, periodic, sh);
  x = load_site<T>(row, wrap_or_out(odd ? c0 + 128 : c0 - 1, C2, periodic));
  const RowKey k = row_key<T, SHARD, INJ>(r, uniforms, R, C2, periodic, sh);
  if (!k.in || g < 0) return;
  const int nbr = load_site<T>(black_row<T, SHARD>(black_in, r - 1, R, C2, periodic, sh), g) +
                  load_site<T>(row, g) +
                  load_site<T>(black_row<T, SHARD>(black_in, r + 1, R, C2, periodic, sh), g) +
                  load_site<T>(row, wrap_or_out(odd ? c0 : c0 + 127, C2, periodic));
  const int u = INJ ? k.u_row[g] : (int)(site_word(k.pr, g, k0, k1) & 0xFFFFu);
  e = u < st[nbr + 4] ? 1 : -1;
}

// One sweep of the strip blockIdx.y (rows [r0, r0 + tr)) of one lattice, by
// the column warps of block blockIdx.x; MODE FULL is the heat-bath sweep,
// the others its ablations (above). SHARD takes the plane's outside rows
// from `sh` instead of wrapping. VEC: C2 % 4 == 0 and every plane pointer
// aligned to a quad.
//
// Warp edges. The warp's lanes own 32 groups, 128 columns from c = 128 w,
// so that its quad loads and stores cover whole 128 B lines. The neighbours
// across its edges are read or recomputed by its edge lanes: lane 0 for
// column c-1, lane 31 for column c+128 (the edge column). Each reads its
// edge column's black site by site, and recomputes the red of its edge
// column on the rows where its side needs it (odd rows on the left, even
// rows on the right: there black's horizontal partner lies across the
// edge). The words of those red sites are drawn for 32 rows at once, one
// per lane, and handed out by a shuffle, so the edges cost one Philox call
// per 32 rows and lane instead of one per row.
template <typename T, int MODE, bool SHARD, bool VEC, bool INJ>
__device__ __forceinline__ void sweep_strip(
    const T* __restrict__ black_in, T* __restrict__ red_out, T* __restrict__ black_out,
    const int* __restrict__ table, const int* __restrict__ uniforms, int R, int C2,
    int periodic, uint32_t k0, uint32_t k1, int tr, const Shard<T>& sh = Shard<T>{}) {
  constexpr bool READS = MODE == FULL || MODE == NOMATH;
  __shared__ int st[9];                 // thresholds for local fields -4..4
  if constexpr (MODE == FULL) {
    if (threadIdx.x < 9) st[threadIdx.x] = table[threadIdx.x];
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int cw = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int c0 = 128 * cw;
  if (c0 >= C2) return;                            // the whole warp lies past the plane
  const int v0 = c0 + 4 * lane;
  Cols c;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    c.gc[t] = wrap_or_out(v0 + t, C2, periodic);
    c.own[t] = v0 + t < C2;
  }
  c.quad = c.gc[0] >= 0 && (c.gc[0] & 3) == 0 && c.gc[0] + 3 < C2;
  c.all_own = v0 + 3 < C2;
  const size_t plane = (size_t)R * C2;
  const int r0 = blockIdx.y * tr;
  const int r1 = min(r0 + tr, R);
  // Red rows r0-1 .. r1 (the first and last are the strip's halo rows);
  // PRNG_ONLY draws the strip's own rows only.
  const int first = MODE == PRNG_ONLY ? r0 : r0 - 1;
  const int last = MODE == PRNG_ONLY ? r1 - 1 : r1;

  // Black rows lr-1, lr, lr+1 and lr+2 (loaded a row ahead).
  int b_up[4], b_c[4], b_dn[4], ahead[4];
  // New red rows lr-3, lr-2, lr-1 with the red across the warp's edge that
  // black needs on each (er_*), and the hi16 words of rows lr-2, lr-1: black
  // row lr-2 is updated from them while red row lr is, so that the two
  // colours' chains of shuffles and table reads do not wait on each other.
  int r_a[4] = {0, 0, 0, 0}, r_b[4] = {0, 0, 0, 0}, r_c[4] = {0, 0, 0, 0};
  int er_a = 0, er_b = 0, er_c = 0;
  uint32_t hi_b[4] = {0u, 0u, 0u, 0u}, hi_c[4] = {0u, 0u, 0u, 0u};
  if constexpr (READS) {
    load_quad<T, VEC>(black_row<T, SHARD>(black_in, first - 1, R, C2, periodic, sh), c, b_c);
    load_quad<T, VEC>(black_row<T, SHARD>(black_in, first, R, C2, periodic, sh), c, b_dn);
    load_quad<T, VEC>(black_row<T, SHARD>(black_in, first + 1, R, C2, periodic, sh), c, ahead);
  }
  // Lane i's part of the edge batch of rows lr0 .. lr0+31 (lr0 = lr - (lr -
  // first) % 32): the black across the warp's edge that red row lr0+i needs
  // (x_batch), and the red across it that black row lr0+i needs (e_batch).
  int x_batch = 0, e_batch = 0;
  if constexpr (MODE == FULL)               // the first batch's loads overlap the rows'
    edge_batch<T, SHARD, INJ>(black_in, uniforms, first + lane, last, c0, R, C2, periodic, k0,
                              k1, st, sh, x_batch, e_batch);

  // FULL runs one more row than it draws: black row last - 1 comes after red
  // row last.
  const int stop = MODE == FULL ? last + 1 : last;
  for (int lr = first; lr <= stop; ++lr) {
    if constexpr (MODE == FULL) {
      // Black row lb from red rows lb-1, lb and lb+1; its horizontal partner
      // is column +1 on even rows and -1 on odd rows, across the group's
      // edge from the neighbouring lane, across the warp's from the edge red.
      const int lb = lr - 2;
      if (lb >= r0 && lb < r1) {
        const bool odd_b = lb & 1;
        int redge = odd_b ? __shfl_up_sync(FULL_MASK, r_b[3], 1)
                          : __shfl_down_sync(FULL_MASK, r_b[0], 1);
        if (lane == (odd_b ? 0 : 31)) redge = er_b;
        int blk[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int horiz = odd_b ? (t == 0 ? redge : r_b[t - 1]) : (t == 3 ? redge : r_b[t + 1]);
          const int nbr = r_a[t] + r_b[t] + r_c[t] + horiz;
          const int u = INJ
              ? (c.gc[t] >= 0 ? uniforms[plane + (size_t)lb * C2 + c.gc[t]] : 0) : (int)hi_b[t];
          blk[t] = u < st[nbr + 4] ? 1 : -1;
        }
        store_quad<T, VEC>(black_out + (size_t)lb * C2, c, blk);
      }
      if (lr > last) break;
    }
    if constexpr (READS) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        b_up[t] = b_c[t];
        b_c[t] = b_dn[t];
        b_dn[t] = ahead[t];
      }
      // The last black row the strip reads is last + 1.
      load_quad<T, VEC>(lr + 2 <= last + 1
                            ? black_row<T, SHARD>(black_in, lr + 2, R, C2, periodic, sh)
                            : nullptr, c, ahead);
    }
    const RowKey key = row_key<T, SHARD, INJ>(lr, uniforms, R, C2, periodic, sh);
    const bool odd = lr & 1;              // the row's parity picks the horizontal partner
    uint32_t w[4];
    draw<INJ>(key, c, uniforms, k0, k1, w);
    if (MODE == FULL && lr != first && (lr - first) % 32 == 0)
      edge_batch<T, SHARD, INJ>(black_in, uniforms, lr + lane, last, c0, R, C2, periodic, k0, k1, st,
                           sh, x_batch, e_batch);

    int red[4];
    uint32_t hi[4];
    int red_e = 0;                        // lanes 0 and 31: the red across the warp's edge on row lr
    if constexpr (MODE == FULL) {
      const int x = __shfl_sync(FULL_MASK, x_batch, (lr - first) % 32);
      red_e = __shfl_sync(FULL_MASK, e_batch, (lr - first) % 32);
      // Red's horizontal partner across the group's edge: column v0-1 (even
      // rows) from the lane below, v0+4 (odd rows) from the lane above; at
      // the warp's edge the edge column's black.
      int edge = odd ? __shfl_down_sync(FULL_MASK, b_c[0], 1)
                     : __shfl_up_sync(FULL_MASK, b_c[3], 1);
      if (lane == (odd ? 31 : 0)) edge = x;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        int s = 0;
        if (key.in && c.gc[t] >= 0) {
          const int u = INJ ? key.u_row[c.gc[t]] : (int)(w[t] & 0xFFFFu);
          const int horiz = odd ? (t == 3 ? edge : b_c[t + 1]) : (t == 0 ? edge : b_c[t - 1]);
          s = u < st[b_up[t] + b_dn[t] + b_c[t] + horiz + 4] ? 1 : -1;
        }
        red[t] = s;
      }
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        int s = 0;
        if (key.in && c.gc[t] >= 0) {
          const int u = INJ ? key.u_row[c.gc[t]] : (int)(w[t] & 0xFFFFu);
          if constexpr (MODE == NOMATH)
            s = u < (b_up[t] + b_c[t] + b_dn[t]) * 1000 + 32768 ? 1 : -1;
          else
            s = u < 32768 ? 1 : -1;
        }
        red[t] = s;
      }
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) hi[t] = w[t] >> 16;

    if (lr >= r0 && lr < r1) {
      store_quad<T, VEC>(red_out + (size_t)lr * C2, c, red);
      if constexpr (MODE == NOMATH) {
        store_quad<T, VEC>(black_out + (size_t)lr * C2, c, red);
      } else if constexpr (MODE != FULL) {
        int blk[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int u = INJ
              ? (c.gc[t] >= 0 ? uniforms[plane + (size_t)lr * C2 + c.gc[t]] : 0) : (int)hi[t];
          blk[t] = u < 32768 ? 1 : -1;
        }
        store_quad<T, VEC>(black_out + (size_t)lr * C2, c, blk);
      }
    }
    if constexpr (MODE == FULL) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        r_a[t] = r_b[t];
        r_b[t] = r_c[t];
        r_c[t] = red[t];
        hi_b[t] = hi_c[t];
        hi_c[t] = hi[t];
      }
      er_a = er_b;
      er_b = er_c;
      er_c = red_e;
    }
  }
}

template <typename T, bool VEC, bool INJ>
__global__ void __launch_bounds__(NT) fused_sweep_kernel(
    const T* __restrict__ black_in, T* __restrict__ red_out, T* __restrict__ black_out,
    const int* __restrict__ table, const int* __restrict__ uniforms, int R, int C2,
    int periodic, uint32_t k0, uint32_t k1, int tr) {
  sweep_strip<T, FULL, false, VEC, INJ>(black_in, red_out, black_out, table, uniforms, R, C2,
                                        periodic, k0, k1, tr);
}

// K1 on one shard of a row-sharded lattice (Shard).
template <typename T, bool VEC, bool INJ>
__global__ void __launch_bounds__(NT) fused_sweep_shard_kernel(
    const T* __restrict__ black_in, T* __restrict__ red_out, T* __restrict__ black_out,
    const int* __restrict__ table, const int* __restrict__ uniforms, int R, int C2,
    int periodic, uint32_t k0, uint32_t k1, int tr, Shard<T> sh) {
  sweep_strip<T, FULL, true, VEC, INJ>(black_in, red_out, black_out, table, uniforms, R, C2,
                                       periodic, k0, k1, tr, sh);
}

// Lattice b = blockIdx.z: planes at b * R * C2, table row b, key row b,
// injected uniforms (if any) at b * 2 * R * C2.
template <typename T, bool VEC, bool INJ>
__global__ void __launch_bounds__(NT) fused_sweep_batched_kernel(
    const T* __restrict__ blacks_in, T* __restrict__ reds_out, T* __restrict__ blacks_out,
    const int* __restrict__ tables, const uint32_t* __restrict__ keys,
    const int* __restrict__ uniforms, int R, int C2, int periodic, int tr) {
  const size_t b = blockIdx.z;
  const size_t plane = (size_t)R * C2;
  sweep_strip<T, FULL, false, VEC, INJ>(blacks_in + b * plane, reds_out + b * plane,
                                        blacks_out + b * plane, tables + 9 * b,
                                        INJ ? uniforms + 2 * b * plane : nullptr, R, C2, periodic,
                                        keys[2 * b], keys[2 * b + 1], tr);
}

// K1 with parts taken out (Mode), on K1's grid and keys.
template <typename T, int MODE, bool VEC, bool INJ>
__global__ void __launch_bounds__(NT) decomposition_kernel(
    const T* __restrict__ black_in, T* __restrict__ red_out, T* __restrict__ black_out,
    const int* __restrict__ uniforms, int R, int C2, int periodic, uint32_t k0, uint32_t k1,
    int tr) {
  sweep_strip<T, MODE, false, VEC, INJ>(black_in, red_out, black_out, nullptr, uniforms, R, C2,
                                        periodic, k0, k1, tr);
}

// The strip height: the tallest power of two from MAX_TR down to 8 whose grid
// holds MIN_WARPS column warps over the B lattices.
int strip_rows(int B, int R, int C2) {
  const long long warps = (C2 + 127) / 128;
  int tr = MAX_TR;
  while (tr > 8 && warps * ((R + tr - 1) / tr) * B < MIN_WARPS) tr /= 2;
  return tr;
}

dim3 grid_of(int B, int R, int C2, int tr) {
  const int warps = (C2 + 127) / 128;
  return dim3((warps + WARPS - 1) / WARPS, (R + tr - 1) / tr, B);
}

// The vector path: C2 % 4 == 0 and every plane pointer aligned to a quad of
// the dtype (a null pointer passes).
bool vector_path(int C2, int is_bf16, const void* a, const void* b, const void* c,
                 const void* d = nullptr, const void* e = nullptr) {
  const uintptr_t quad = is_bf16 ? 8 : 16;
  return C2 % 4 == 0 && ((uintptr_t)a | (uintptr_t)b | (uintptr_t)c | (uintptr_t)d |
                         (uintptr_t)e) % quad == 0;
}

template <typename T, bool VEC>
void launch_fused(const void* black_in, void* red_out, void* black_out, const void* table,
                  const void* uniforms, int R, int C2, int periodic, uint32_t k0, uint32_t k1,
                  cudaStream_t s) {
  const int tr = strip_rows(1, R, C2);
  auto kernel = uniforms ? fused_sweep_kernel<T, VEC, true> : fused_sweep_kernel<T, VEC, false>;
  kernel<<<grid_of(1, R, C2, tr), NT, 0, s>>>(
      (const T*)black_in, (T*)red_out, (T*)black_out, (const int*)table, (const int*)uniforms,
      R, C2, periodic, k0, k1, tr);
}

template <typename T, bool VEC>
void launch_shard(const void* black_in, void* red_out, void* black_out, const void* table,
                  const void* uniforms, const Shard<T>& sh, int R, int C2, int periodic,
                  uint32_t k0, uint32_t k1, cudaStream_t s) {
  const int tr = strip_rows(1, R, C2);
  auto kernel = uniforms ? fused_sweep_shard_kernel<T, VEC, true>
                         : fused_sweep_shard_kernel<T, VEC, false>;
  kernel<<<grid_of(1, R, C2, tr), NT, 0, s>>>(
      (const T*)black_in, (T*)red_out, (T*)black_out, (const int*)table, (const int*)uniforms,
      R, C2, periodic, k0, k1, tr, sh);
}

template <typename T, bool VEC>
void launch_batched(const void* blacks_in, void* reds_out, void* blacks_out, const void* tables,
                    const void* keys, const void* uniforms, int B, int R, int C2, int periodic,
                    cudaStream_t s) {
  const int tr = strip_rows(B, R, C2);
  auto kernel = uniforms ? fused_sweep_batched_kernel<T, VEC, true>
                         : fused_sweep_batched_kernel<T, VEC, false>;
  kernel<<<grid_of(B, R, C2, tr), NT, 0, s>>>(
      (const T*)blacks_in, (T*)reds_out, (T*)blacks_out, (const int*)tables,
      (const uint32_t*)keys, (const int*)uniforms, R, C2, periodic, tr);
}

template <typename T, int MODE, bool VEC>
void launch_mode(const void* black_in, void* red_out, void* black_out, const void* uniforms,
                 int R, int C2, int periodic, uint32_t k0, uint32_t k1, cudaStream_t s) {
  const int tr = strip_rows(1, R, C2);
  auto kernel = uniforms ? decomposition_kernel<T, MODE, VEC, true>
                         : decomposition_kernel<T, MODE, VEC, false>;
  kernel<<<grid_of(1, R, C2, tr), NT, 0, s>>>((const T*)black_in, (T*)red_out, (T*)black_out,
                                              (const int*)uniforms, R, C2, periodic, k0, k1, tr);
}

template <typename T, bool VEC>
int launch_decomposition(int mode, const void* black_in, void* red_out, void* black_out,
                         const void* uniforms, int R, int C2, int periodic, uint32_t k0,
                         uint32_t k1, cudaStream_t s) {
  switch (mode) {
    case PRNG_ONLY:
      launch_mode<T, PRNG_ONLY, VEC>(black_in, red_out, black_out, uniforms, R, C2, periodic, k0,
                                     k1, s);
      break;
    case PRNG_GROUPED:
      launch_mode<T, PRNG_GROUPED, VEC>(black_in, red_out, black_out, uniforms, R, C2, periodic,
                                        k0, k1, s);
      break;
    case NOMATH:
      launch_mode<T, NOMATH, VEC>(black_in, red_out, black_out, uniforms, R, C2, periodic, k0, k1,
                                  s);
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
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = vector_path(C2, is_bf16, black_in, red_out, black_out);
  auto go = is_bf16 ? (vec ? launch_fused<__nv_bfloat16, true> : launch_fused<__nv_bfloat16, false>)
                    : (vec ? launch_fused<float, true> : launch_fused<float, false>);
  go(black_in, red_out, black_out, table, uniforms, R, C2, periodic, k0, k1, s);
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
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = vector_path(C2, is_bf16, black_in, red_out, black_out, up2, down2);
  if (is_bf16) {
    using T = __nv_bfloat16;
    const Shard<T> sh = {(const T*)up2, (const T*)down2, (const int*)u_top, (const int*)u_bot,
                         row0, R_global, is_top, is_bot};
    (vec ? launch_shard<T, true> : launch_shard<T, false>)(
        black_in, red_out, black_out, table, uniforms, sh, R, C2, periodic, k0, k1, s);
  } else {
    const Shard<float> sh = {(const float*)up2, (const float*)down2, (const int*)u_top,
                             (const int*)u_bot, row0, R_global, is_top, is_bot};
    (vec ? launch_shard<float, true> : launch_shard<float, false>)(
        black_in, red_out, black_out, table, uniforms, sh, R, C2, periodic, k0, k1, s);
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
  const bool vec = vector_path(C2, is_bf16, blacks_in, reds_out, blacks_out);
  auto go = is_bf16
      ? (vec ? launch_batched<__nv_bfloat16, true> : launch_batched<__nv_bfloat16, false>)
      : (vec ? launch_batched<float, true> : launch_batched<float, false>);
  go(blacks_in, reds_out, blacks_out, tables, keys, uniforms, B, R, C2, periodic,
     (cudaStream_t)stream);
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
  const bool vec = vector_path(C2, is_bf16, black_in, red_out, black_out);
  auto go = is_bf16 ? (vec ? launch_decomposition<__nv_bfloat16, true>
                           : launch_decomposition<__nv_bfloat16, false>)
                    : (vec ? launch_decomposition<float, true> : launch_decomposition<float, false>);
  return go(mode, black_in, red_out, black_out, uniforms, R, C2, periodic, k0, k1,
            (cudaStream_t)stream);
}
