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
// The local field is J * nbr + field in float32, p = 1 / (1 + exp(-2 local /
// T)) in the reference's order without contraction (a division by T, not a
// multiply by beta), and the site is +1 if u24 * 2^-24 < p. The new spin is
// written in the plane's dtype (float32 or bfloat16) as the bit pattern of +1
// or -1.
//
// Preconditions. The plane holds +-1. A halo value (up_row, down_row,
// left_col, right_col) is +-1 or a zero of either sign. The first body of
// this kernel (checkerboard_halfsweep_scalar.cu) summed any values; on these
// inputs the two write the same bits at every site.
//
// The threshold table. With J uniform, nbr is an exact integer in -4..4,
// zero halos included, so p takes at most nine values in a launch. Threads
// 0..8 of each block compute p for nbr = -4..4 with the very float32
// expression a site would use and store t = ceil(p * 2^24), in 0..2^24; one
// barrier follows, and then no exp or division remains per site. Since
// u24 * 2^-24 and p * 2^24 are exact in float32, u24 * 2^-24 < p holds
// exactly when u24 < t, so the table changes no result. In Philox mode the
// whole 32-bit word is compared against t << 8 when every t < 2^24 (word >> 8
// < t is word < t << 8); a launch whose table reaches 2^24 (p = 1) compares
// word >> 8 < t instead (template flag SHIFTED, picked once per block).
//
// Random numbers. One 24-bit uniform per site: the top 24 bits of the site's
// Philox4x32-10 word at counter (global row, global col / 4, 0, 0), output
// global col % 4, under the launch's key, which the wrappers make
// (fold_seed(base, colour), sweep). A shard passes its global row and column
// offsets (row0, col0), so every shard of a lattice draws the words the whole
// lattice would draw at those sites. The C entry computes Philox's ten round
// keys and passes them as a kernel parameter (RoundKeys), so each round
// xors a constant-bank operand and no lane spends an instruction on the key
// schedule. Injected uniforms, (R, C2) int32 in [0, 2^24), replace the
// generator (template flag INJ).
//
// Bound. Compulsory traffic per site: read the other plane once and write
// the new one, 8 B at float32 and 4 B at bfloat16. At the H100's 3.35 TB/s a
// 4096^2 half-sweep (8.4 M sites) needs 0.020 ms at float32 and 0.010 ms at
// bfloat16. The first body loaded each neighbour one by one (every element
// fetched about four times, each behind a halo branch) and took one expf and
// two divisions per site: its instruction count, not its bytes, bound it.
//
// Design: the strip body of checkerboard_bonds.cu (bond_strip) with every
// bond +1, leaner. A thread owns one Philox group, four compact columns
// starting at a global multiple of 4, and walks down a strip of STRIP_TR
// rows; a warp owns 32 groups, 128 columns. The warp first issues every load
// of its strip, rows r0-1 .. r0+STRIP_TR of the other plane, each row index
// clamped into the plane so that no load sits behind a branch, and only
// then converts them, so STRIP_TR + 2 quads a lane are in flight at once;
// the loads are issued before the block's table barrier, so their latency
// overlaps the table. Then the warp updates its rows one by one. (A first
// draft loaded one row ahead behind per-row branches and waited out each
// load in turn: 0.033 ms per 4096^2 f32 half-sweep against 0.0255 for this
// body, tools/halfsweep_bodies.py.) A neighbour word holds a row of the
// lane's four sites, one byte each: 0x20 where the neighbour is -1, 0x10
// where it is a zero (a halo value), 0 where it is +1. The sum of the four
// neighbour words up + dn + mid + partner, two IADD3, is then 16 (2 n_minus
// + n_zero) in each byte, at most 128, which is 16 (4 - nbr): each byte,
// taken out with one PRMT, is the byte offset of the site's entry in a table
// of nine entries spaced 16 B apart, in shared memory. The horizontal partner
// is the centre word shifted by a byte, with the byte across the group's
// edge from lane l-1 (picked rows, column c-1) or lane l+1 (the other rows,
// column c+1) by one rotation shuffle; across the warp's edge lanes 0 and 31
// take that one column, which every lane of the warp loads from the same
// address (one transaction, no branch), except where C2 divides 128 and the
// rotation carries the wrap. The colour is a template argument and a
// strip starts on an even row, so each unrolled row knows its parity, its
// partner side and its shuffle's source lane at compile time.
//
// The edges bond_strip does not have. (1) The halo rows sit above row 0 and
// below row R-1 and are read only by the strips that touch them, site by
// site, a zero as 0x10 (a sign bit cannot hold 0). (2) The horizontal edge
// sites (column 0 on picked rows, column C2-1 on the others) take their
// partner from the column halo, left_col[r * left_stride] or
// right_col[r * right_stride], which the warps at the plane's edges load
// with their rows, one address for the whole warp; on an open edge without
// column halos the partner is a zero; periodic without column halos, the
// wrapped column comes by the mapping below. (3) The global column offset: a
// lane's group starts at a global multiple of 4, so where col0 % 4 != 0 the
// first lane's columns start at -(col0 % 4) and it keeps only its own
// sites.
//
// Vector and scalar paths. Where C2 % 4 == 0, col0 % 4 == 0 and the other
// plane and the output are aligned to a quad of their dtype and the uniforms
// to 16 B, the C entry picks the vector path (template flag VEC): one quad
// load per row of the other plane, one quad of uniforms, one quad store.
// Otherwise the same body loads and stores site by site. Lane l of column
// warp w stands for the virtual columns v0..v0+3, v0 = 128 w + 4 l -
// col0 % 4, each mapped to the plane's column v mod C2: every value a lane
// holds is the true value at its mapped column, so the neighbour at v +- 1 is
// the mapped column's neighbour, and a ragged last group, C2 < 4 and the
// periodic wrap need no special case. A lane stores only the columns
// 0 <= v < C2. Halo rows and column halos are always read site by site.
//
// Layout. A block is four warps, each one strip of the same 128 columns;
// STRIP_TR = 8 rows, the row loop unrolled. The card chose it
// (tools/halfsweep_bodies.py, NVIDIA H100 80GB HBM3): 4 rows are 2% faster
// at 4096^2 f32 and 6% slower at bf16, 16 rows 4% slower at f32, and a first
// draft with bond_strip's rule (the tallest strip that still gives 1,056
// warps, 32 rows at 4096^2, not unrolled) lost 17% to 8 unrolled rows.

#include "tsu_common.cuh"

namespace {

constexpr int NW = 4;                // warps per block, one strip each
constexpr unsigned FULL_MASK = 0xFFFFFFFFu;
constexpr int STRIP_TR = 8;          // rows of a strip, even, the row loop unrolled
constexpr uint32_t T_FULL = 1u << 24;        // a threshold of p = 1
constexpr uint32_t MINUS = 0x20u, ZERO = 0x10u;   // a neighbour's byte: -1, zero (+1: 0)

// The horizontal edge of the plane: the wrapped column (periodic), nothing
// (open), or the column halos.
enum Edge { EDGE_WRAP = 0, EDGE_OPEN = 1, EDGE_COLS = 2 };

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

// Neighbour words of a row of the plane (which holds +-1): byte t is MINUS
// where site t is -1, else 0.
__device__ __forceinline__ uint32_t signs(uint2 q) {      // four bfloat16
  return (__byte_perm(q.x, q.y, 0x7531) >> 2) & 0x20202020u;
}

__device__ __forceinline__ uint32_t signs(uint4 q) {      // four float32
  return (__byte_perm(__byte_perm(q.x, q.y, 0x0073), __byte_perm(q.z, q.w, 0x0073), 0x5410) >>
          2) & 0x20202020u;
}

// Philox4x32-10 with its round keys given: k[2i] and k[2i+1] are the keys
// of round i, k0 + i 0x9E3779B9 and k1 + i 0xBB67AE85, so the words are
// tsu_common.cuh's philox4x32_10(x, k0, k1). The round keys are a kernel
// parameter: each round xors a constant-bank operand, and no lane spends an
// instruction on the key schedule.
struct RoundKeys {
  uint32_t k[20];
};

__device__ __forceinline__ uint4 philox_rounds(uint4 x, const RoundKeys& rk) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, x.x), lo0 = 0xD2511F53u * x.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, x.z), lo1 = 0xCD9E8D57u * x.z;
    x = make_uint4(hi1 ^ x.y ^ rk.k[2 * i], lo1, hi0 ^ x.w ^ rk.k[2 * i + 1], lo0);
  }
  return x;
}

// A neighbour byte from the bits of a plane element (+-1).
template <typename S>
__device__ __forceinline__ uint32_t minus_byte(typename Bits<S>::U b) {
  return (uint32_t)(b >> (8 * sizeof(b) - 6)) & MINUS;
}

// A row of a lane's four sites as loaded, one quad (VEC) or four elements,
// and its neighbour word.
template <typename S, bool VEC> struct Raw;
template <typename S> struct Raw<S, true> {
  typename Bits<S>::Quad q;
  __device__ __forceinline__ void load(const S* row, const int gc[4]) {
    q = *reinterpret_cast<const typename Bits<S>::Quad*>(row + gc[0]);
  }
  __device__ __forceinline__ uint32_t word() const { return signs(q); }
};
template <typename S> struct Raw<S, false> {
  typename Bits<S>::U u[4];
  __device__ __forceinline__ void load(const S* row, const int gc[4]) {
#pragma unroll
    for (int t = 0; t < 4; ++t) u[t] = reinterpret_cast<const typename Bits<S>::U*>(row)[gc[t]];
  }
  __device__ __forceinline__ uint32_t word() const {
    uint32_t w = 0u;
#pragma unroll
    for (int t = 0; t < 4; ++t) w |= minus_byte<S>(u[t]) << (8 * t);
    return w;
  }
};

// A halo value as a neighbour byte: ZERO for a zero of either sign, MINUS
// for -1, 0 for +1.
template <typename S>
__device__ __forceinline__ uint32_t halo_byte(typename Bits<S>::U b) {
  if ((b & (typename Bits<S>::U)~Bits<S>::SIGN) == 0) return ZERO;
  return minus_byte<S>(b);
}

// The neighbour word of a halo row at a lane's columns gc[].
template <typename S>
__device__ __forceinline__ uint32_t halo_signs(const S* row, const int gc[4]) {
  using U = typename Bits<S>::U;
  uint32_t w = 0u;
#pragma unroll
  for (int t = 0; t < 4; ++t) w |= halo_byte<S>(reinterpret_cast<const U*>(row)[gc[t]]) << (8 * t);
  return w;
}

// The bits of four new spins: +1 where plus[t], else -1.
__device__ __forceinline__ uint2 pack(const bool plus[4], uint2) {
  const uint32_t one = Bits<__nv_bfloat16>::ONE, minus = one | Bits<__nv_bfloat16>::SIGN;
  return make_uint2((plus[0] ? one : minus) | ((plus[1] ? one : minus) << 16),
                    (plus[2] ? one : minus) | ((plus[3] ? one : minus) << 16));
}

__device__ __forceinline__ uint4 pack(const bool plus[4], uint4) {
  const uint32_t one = Bits<float>::ONE, minus = one | Bits<float>::SIGN;
  return make_uint4(plus[0] ? one : minus, plus[1] ? one : minus, plus[2] ? one : minus,
                    plus[3] ? one : minus);
}

// v mod C2 in 0..C2-1.
__device__ __forceinline__ int wrap_col(int v, int C2) { return (v % C2 + C2) % C2; }

// The injected uniforms of a lane's sites v0 .. v0+3 of a row at offset
// `at`: one quad with VEC, otherwise one load per site 0 <= v < C2.
template <bool VEC>
__device__ __forceinline__ void load_u(int u[4], const int* __restrict__ uniforms, size_t at,
                                       int v0, int C2) {
  if (VEC) {
    const int4 q = *reinterpret_cast<const int4*>(uniforms + at + v0);
    u[0] = q.x; u[1] = q.y; u[2] = q.z; u[3] = q.w;
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t)
      u[t] = v0 + t >= 0 && v0 + t < C2 ? uniforms[at + (size_t)(v0 + t)] : 0;
  }
}

struct Halos {
  const void* up_row;
  const void* down_row;
  const void* left_col;
  const void* right_col;
  long long left_stride, right_stride;   // elements between rows of the column halos
  int edge;                              // Edge
};

// What a lane of a strip knows once its rows are loaded: the neighbour
// words of rows r0 .. r0 + TR (word[j] is row r0 + j), of row r0 - 1 (top)
// and of the row below the strip's last one (bottom); per row, the edge
// column's element (lanes 0 and 31 use it) and the column halo's byte (the
// edge lanes use it).
template <typename S, int TR>
struct Strip {
  uint32_t word[TR + 1], top, bottom, halo[TR];
  typename Bits<S>::U edge[TR];
  int r0, rows, lane, v0, sh_left, sh_right;
  uint32_t group;
  bool own, edge_left, edge_right, fix_left, fix_right;
};

// Update the strip's rows against the thresholds `table` (byte offset
// 16 (4 - nbr) of nbr's entry; `shifted`: the same entries << 8). RED: the
// colour updated; SHIFTED: every threshold below 2^24 (Philox mode only).
template <typename S, bool VEC, bool INJ, bool RED, bool SHIFTED, int TR>
__device__ __forceinline__ void update_rows(const Strip<S, TR>& s, S* __restrict__ out,
                                            const int* __restrict__ uniforms,
                                            const uint32_t* table, const uint32_t* shifted,
                                            int C2, int row0, const RoundKeys& rk) {
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    if (i >= s.rows) break;
    const bool picked = (i % 2 == 0) == RED;     // r0 is even
    const uint32_t up = i == 0 ? s.top : s.word[i - 1], mid = s.word[i];
    const uint32_t dn = i + 1 == s.rows ? s.bottom : s.word[i + 1];
    // The partner is column c-1 on picked rows, c+1 on the others. Across
    // the group's edge it comes from the next lane, across the warp's from
    // the edge column; at the plane's edge from the column halo, or it is a
    // zero (open).
    uint32_t e = __shfl_sync(FULL_MASK, mid, (s.lane + (picked ? 31 : 1)) & 31);
    if (picked ? s.edge_left : s.edge_right) e = minus_byte<S>(s.edge[i]) * 0x01000001u;
    uint32_t partner = picked ? __funnelshift_l(e, mid, 8) : __funnelshift_r(mid, e, 8);
    if (picked ? s.fix_left : s.fix_right) {
      const int sh = picked ? s.sh_left : s.sh_right;
      partner = (partner & ~((MINUS | ZERO) << sh)) | (s.halo[i] << sh);
    }
    if (!s.own) continue;

    const int r = s.r0 + i;
    const size_t at = (size_t)r * C2;
    int u[4] = {0, 0, 0, 0};
    uint4 words = make_uint4(0u, 0u, 0u, 0u);
    if (INJ)
      load_u<VEC>(u, uniforms, at, s.v0, C2);
    else
      words = philox_rounds(make_uint4((uint32_t)(row0 + r), s.group, 0u, 0u), rk);
    // Byte t: 16 (4 - nbr) of site t, the byte offset of its threshold.
    const uint32_t at16 = up + dn + mid + partner;
    bool plus[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const uint32_t off = __byte_perm(at16, 0u, 0x4440 + t);
      if (INJ) {
        plus[t] = u[t] < *reinterpret_cast<const int*>(reinterpret_cast<const char*>(table) + off);
      } else {
        const uint32_t thr = *reinterpret_cast<const uint32_t*>(
            reinterpret_cast<const char*>(SHIFTED ? shifted : table) + off);
        plus[t] = SHIFTED ? pick(words, t) < thr : (pick(words, t) >> 8) < thr;
      }
    }
    S* row_out = out + at;
    if (VEC) {
      using Quad = typename Bits<S>::Quad;
      *reinterpret_cast<Quad*>(row_out + s.v0) = pack(plus, Quad{});
    } else {
      using U = typename Bits<S>::U;
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (s.v0 + t >= 0 && s.v0 + t < C2)
          reinterpret_cast<U*>(row_out)[s.v0 + t] =
              (U)(plus[t] ? Bits<S>::ONE : Bits<S>::ONE | Bits<S>::SIGN);
    }
  }
}

// One half-sweep of the strip of rows [r0, r0 + TR) of the plane by the
// column warp blockIdx.x. VEC: C2 % 4 == 0, col0 % 4 == 0 and the planes
// aligned for their quads. TR: the strip's rows, even. The warp issues every
// load of its strip first, then the block computes its table, then the warp
// updates its rows.
template <typename S, bool VEC, bool INJ, bool RED, int TR>
__global__ void __launch_bounds__(32 * NW) halfsweep_kernel(
    const S* __restrict__ other, S* __restrict__ out, Halos h, const int* __restrict__ uniforms,
    int R, int C2, float J, float field, float T, int row0, int col0, RoundKeys rk) {
  using U = typename Bits<S>::U;
  Strip<S, TR> s;
  s.r0 = (blockIdx.y * NW + threadIdx.y) * TR;
  s.rows = min(TR, R - s.r0);             // even where positive: R is even
  s.lane = threadIdx.x;
  const int c0 = (int)(128 * blockIdx.x) - (col0 & 3);   // the warp's first virtual column
  s.v0 = c0 + 4 * s.lane;
  s.own = s.v0 < C2;                      // the lane stores columns max(v0, 0) .. min(v0 + 3, C2 - 1)
  s.group = (uint32_t)((col0 >> 2) + 32 * blockIdx.x + s.lane);   // global col / 4
  // The lane's columns, and across the warp's edges lane 0's column c0 - 1
  // (picked rows) and lane 31's c0 + 128 (the other rows), all mapped into
  // the plane; a mapping that wraps takes the slow branch.
  int gc[4] = {s.v0, s.v0 + 1, s.v0 + 2, s.v0 + 3};
  int ge_left = c0 - 1, ge_right = c0 + 128;
  if (s.v0 < 0 || s.v0 + 3 >= C2 || ge_left < 0 || ge_right >= C2) {
#pragma unroll
    for (int t = 0; t < 4; ++t) gc[t] = wrap_col(s.v0 + t, C2);
    ge_left = wrap_col(ge_left, C2);
    ge_right = wrap_col(ge_right, C2);
  }
  // Where C2 divides 128 the warp's columns wrap onto themselves and the
  // rotation of the lanes brings the edge columns.
  const bool rotate = 128 % C2 == 0;
  s.edge_left = !rotate && s.lane == 0;
  s.edge_right = !rotate && s.lane == 31;
  // The plane's edge sites: column 0 in byte -v0 of the lane with
  // -3 <= v0 <= 0, column C2-1 in byte C2-1-v0 of the lane with
  // C2-4 <= v0 <= C2-1. Their partner is the column halo's, or a zero.
  s.fix_left = h.edge != EDGE_WRAP && s.v0 <= 0;
  s.fix_right = h.edge != EDGE_WRAP && s.v0 <= C2 - 1 && C2 - 1 < s.v0 + 4;
  s.sh_left = 8 * (-s.v0 & 3);
  s.sh_right = 8 * ((C2 - 1 - s.v0) & 3);

  // Every load of the strip, rows clamped into the plane so that none needs
  // a branch: the rows as loaded, the edge column of each row (one address
  // for the whole warp) and, in the warps at the plane's edges, the column
  // halo of each row (one address too).
  Raw<S, VEC> raw[TR + 1], raw_top;
  const size_t stride = C2;
  const int last = R - 1;
  raw_top.load(other + (size_t)max(s.r0 - 1, 0) * stride, gc);
#pragma unroll
  for (int j = 0; j <= TR; ++j) raw[j].load(other + (size_t)min(s.r0 + j, last) * stride, gc);
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const bool picked = (i % 2 == 0) == RED;
    s.edge[i] = reinterpret_cast<const U*>(other + (size_t)min(s.r0 + i, last) * stride)[
        picked ? ge_left : ge_right];
    s.halo[i] = h.edge == EDGE_OPEN ? ZERO : 0u;
  }
  if (h.edge == EDGE_COLS && (blockIdx.x == 0 || blockIdx.x + 1 == gridDim.x)) {
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const long long r = min(s.r0 + i, last);
      s.halo[i] = halo_byte<S>((i % 2 == 0) == RED
          ? reinterpret_cast<const U*>(h.left_col)[r * h.left_stride]
          : reinterpret_cast<const U*>(h.right_col)[r * h.right_stride]);
    }
  }

  // The thresholds of nbr = -4..4, each from the expression of a site of the
  // first body: local = J * nbr + field, x = 2 local / T, p = 1 / (1 + e^-x);
  // nbr's entry at word 4 (4 - nbr), 16 B apart.
  __shared__ uint32_t table[33], shifted[33];
  const int i = threadIdx.y * 32 + threadIdx.x;
  int full = 0;
  if (i < 9) {
    const float local = __fadd_rn(__fmul_rn(J, (float)(i - 4)), field);
    const float x = __fdiv_rn(__fmul_rn(2.0f, local), T);
    const float p = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
    const uint32_t t = p > 0.0f ? (uint32_t)ceilf(__fmul_rn(p, 16777216.0f)) : 0u;
    table[4 * (8 - i)] = t;
    shifted[4 * (8 - i)] = t << 8;
    full = t >= T_FULL;
  }
  const int any_full = __syncthreads_or(full);
  if (s.r0 >= R) return;                  // the whole warp lies past the plane

  s.top = s.r0 == 0 ? halo_signs(static_cast<const S*>(h.up_row), gc) : raw_top.word();
#pragma unroll
  for (int j = 0; j <= TR; ++j) s.word[j] = raw[j].word();
  s.bottom = s.r0 + s.rows == R ? halo_signs(static_cast<const S*>(h.down_row), gc)
                                : s.word[TR];
  if (INJ || any_full)
    update_rows<S, VEC, INJ, RED, false, TR>(s, out, uniforms, table, shifted, C2, row0, rk);
  else if constexpr (!INJ)
    update_rows<S, VEC, false, RED, true, TR>(s, out, uniforms, table, shifted, C2, row0, rk);
}

template <typename S, bool VEC, bool INJ, bool RED>
void launch_one(const void* other, void* out, const Halos& h, const void* uniforms, int R, int C2,
                float J, float field, float T, int row0, int col0, const RoundKeys& rk,
                cudaStream_t s) {
  const int warps = ((col0 & 3) + C2 + 127) / 128;   // column warps of 32 groups
  const dim3 grid(warps, ((R + STRIP_TR - 1) / STRIP_TR + NW - 1) / NW);
  halfsweep_kernel<S, VEC, INJ, RED, STRIP_TR><<<grid, dim3(32, NW), 0, s>>>(
      (const S*)other, (S*)out, h, (const int*)uniforms, R, C2, J, field, T, row0, col0, rk);
}

template <typename S, bool VEC, bool INJ>
void launch_colour(const void* other, void* out, const Halos& h, const void* uniforms, int R,
                   int C2, int update_red, float J, float field, float T, int row0, int col0,
                   const RoundKeys& rk, cudaStream_t s) {
  (update_red ? launch_one<S, VEC, INJ, true> : launch_one<S, VEC, INJ, false>)(
      other, out, h, uniforms, R, C2, J, field, T, row0, col0, rk, s);
}

template <typename S>
int launch(const void* other, void* out, const Halos& h, const void* uniforms, int R, int C2,
           int update_red, float J, float field, float T, int row0, int col0, uint32_t k0,
           uint32_t k1, cudaStream_t s) {
  RoundKeys rk;
  for (int i = 0; i < 10; ++i) {
    rk.k[2 * i] = k0 + (uint32_t)i * 0x9E3779B9u;
    rk.k[2 * i + 1] = k1 + (uint32_t)i * 0xBB67AE85u;
  }
  const uintptr_t q = 4 * sizeof(S);
  const bool vec = C2 % 4 == 0 && col0 % 4 == 0 && (uintptr_t)other % q == 0 &&
                   (uintptr_t)out % q == 0 && (uintptr_t)uniforms % 16 == 0;
  auto go = uniforms ? (vec ? launch_colour<S, true, true> : launch_colour<S, false, true>)
                     : (vec ? launch_colour<S, true, false> : launch_colour<S, false, false>);
  go(other, out, h, uniforms, R, C2, update_red, J, field, T, row0, col0, rk, s);
  return (int)cudaGetLastError();
}

}  // namespace

// One half-sweep on `stream`: resample the colour given by update_red from
// `other` into `out`, both (R, C2) float32 (is_bf16 == 0) or bfloat16.
// up_row and down_row are (C2,) contiguous halo rows of the same dtype;
// left_col and right_col are both null or both column halos of R values,
// value r at left_col[r * left_stride] and right_col[r * right_stride] (a
// column of the neighbour shard's plane read in place); uniforms is null or
// (R, C2) int32 in [0, 2^24). row0 (even) and col0 are the plane's global
// offsets, which key Philox with k0, k1. 2 <= R <= 8 * 65535, R even. The
// plane holds +-1; halo values are +-1 or zero. Returns cudaGetLastError()
// after the launch.
extern "C" int tsu_halfsweep(const void* other, void* out, const void* up_row,
                             const void* down_row, const void* left_col, const void* right_col,
                             long long left_stride, long long right_stride, const void* uniforms,
                             int R, int C2, int update_red, int periodic, float J, float field,
                             float T, int row0, int col0, unsigned int k0, unsigned int k1,
                             int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Halos h = {up_row, down_row, left_col, right_col, left_stride, right_stride,
                   left_col != nullptr ? EDGE_COLS : periodic ? EDGE_WRAP : EDGE_OPEN};
  if (is_bf16)
    return launch<__nv_bfloat16>(other, out, h, uniforms, R, C2, update_red, J, field, T, row0,
                                 col0, k0, k1, s);
  return launch<float>(other, out, h, uniforms, R, C2, update_red, J, field, T, row0, col0, k0,
                       k1, s);
}
