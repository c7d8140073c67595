// Checkerboard heat-bath half-sweeps with per-bond (disordered) couplings:
// the +-J Edwards-Anderson spin glass and random-bond lattices.
//
// Replaces two Pallas TPU kernels of tsu_tpu/ops/checkerboard_bonds_pallas.py
// on NVIDIA Hopper (sm_90a): _halfsweep_bonds_kernel (one lattice) and
// _halfsweep_bonds_kernel_batched (B replicas sharing one bond set, each at
// its own temperature, in one launch). One launch resamples one colour of the
// compact (R, C/2) planes of tsu_tpu/ops/checkerboard.py from the other
// colour's plane and writes it to a new plane, so no launch reads what it
// writes and the blocks need no order. Both kernels run one body,
// bond_strip; the batched one takes its replica from blockIdx.z and loads
// that replica's key and temperature or table row, so element b is what the
// single-lattice kernel gives under b's key.
//
// What a site computes. Its four neighbours come from the other plane: up
// and down from rows r-1 and r+1 (wrapped when periodic, 0 past the edge of
// an open lattice); left and right from the same row with the checkerboard
// row-parity pick of tsu_tpu/ops/checkerboard_bonds.py:_neighbor_values,
// always wrapping horizontally: an open lattice's edge bonds are zero
// weights, so the kernel never masks an edge. Two modes:
//   continuous: five weight planes (w_up, w_down, w_left, w_right, field) in
//     float32 or bfloat16, widened to float32; local is summed in the
//     reference's order without contraction, p = 1 / (1 + exp(-2 local / T))
//     in float32 (a division by T, not a multiply by beta), and the site is
//     +1 if u24 * 2^-24 < p;
//   discrete: one uint8 code per site, bits 2i..2i+1 holding w_i + 1 in
//     {0, 1, 2} for (up, down, left, right); the integer local field in -4..4 indexes a
//     9-entry 24-bit threshold table, and the site is +1 if u24 < table[l+4].
//     The TPU kernel's 5-entry parity table ("pure") picks the same entries
//     for the even fields of a periodic pure +-1 lattice, so it has no
//     variant here.
// Spins are read from the sign bit of the other plane's values (the planes
// hold +-1) and the new spin is written in that plane's dtype as the bit
// pattern 0x3F80 / 0xBF80 (bfloat16) or 0x3F800000 / 0xBF800000 (float32).
//
// Random numbers. One 24-bit uniform per site per half-sweep: the top 24
// bits of the site's Philox4x32-10 word at counter (row, col / 4, 0, 0),
// output col % 4, under the launch's key. The wrappers key the single-lattice
// kernel by (fold_seed(seed, colour), sweep) and replica b of the batched one
// by (fold_seed(seed_b), 2 * sweep + colour), so the two colours of a sweep
// draw different words. Injected uniforms, (R, C2) int32 in [0, 2^24) per
// lattice, replace the generator (template flag INJ).
//
// Bound. Compulsory traffic per site per half-sweep: discrete bf16 reads 2 B
// of the other plane and 1 B of code and writes 2 B, 5 B; continuous float32
// reads 16 B of bond weights, 4 B of field and 4 B of the other plane and
// writes 4 B, 28 B. At the H100's 3.35 TB/s that is 12.5 us discrete and
// 70.1 us continuous per 4096^2 half-sweep; Philox adds one call per four
// sites and the continuous mode one expf and two divisions per site.
//
// Design. What held the first version of this kernel (a thread per four
// sites of one row, loading each neighbour one by one) at 2.9x its byte
// bound was the count of instructions per site, not the bytes: about seven
// loads and stores of 1-2 B per site, every element of the other plane
// fetched five times, and the local field decoded site by site. Here a
// thread owns one Philox group, four adjacent compact columns starting at a
// global multiple of 4, and walks down a strip of rows; a warp owns 32
// groups, 128 columns, so its quad loads and stores cover whole 128 B lines.
// The thread keeps rows r-1, r and r+1 of the other plane in registers as
// sign words (bit 8t+7 the sign of its site t) and loads row r+2 a row
// ahead, so each element is read once per strip, plus two halo rows per
// strip; the codes or weights and the injected uniforms of row r+1 are
// loaded a row ahead too. Per row a lane issues one quad load of the other
// plane, one 4 B load of codes (or five weight quads), one Philox call (or
// one quad of uniforms), one shuffle and one quad store. The horizontal
// neighbours are the centre word shifted by a byte, with the byte across the
// group's edge from lane l-1 (picked rows, column c-1) or lane l+1 (the
// other rows, column c+1) by a rotation of the warp's lanes; across the
// warp's edge lanes 0 and 31 read that one column with a scalar load (a row
// ahead, with the row), except where the warp's 128 columns wrap onto
// themselves (C2 divides 128: every 256^2 ladder and tempering plane), where
// the rotation carries the wrap. In the discrete mode the four sites' local
// fields are computed together in one 32-bit word: the neighbours' sign
// words give each code field's term by one xor, and the four terms of each
// byte are summed within it (local_plus4), so a row of four sites costs a
// dozen integer instructions besides Philox, four table reads from shared
// memory and the compares. The 9-entry table is read into shared memory
// once, before the row loop; no barrier sits in it.
//
// Vector and scalar paths. Where C2 % 4 == 0 and every plane pointer is
// aligned for its quad (the other plane and the output to 8 B at bf16 or
// 16 B at f32, codes to 4 B, weights to their quad, uniforms to 16 B), the C
// entry picks the vector path (template flag VEC). Otherwise the same body
// loads and stores site by site. Lane l of column warp w stands for the
// virtual columns v0..v0+3, v0 = 128 w + 4 l, each mapped to the plane's
// column v mod C2: every value a lane holds is the true value at its mapped
// column, so the neighbour at v +- 1 is the mapped column's neighbour, and a
// ragged last group, C2 < 4 and the periodic wrap need no special case. A
// lane stores only the columns v < C2, and its sites share one Philox group.
//
// Layout. A block is four warps, each one strip of the same 128 columns.
// The discrete mode runs strips of DISCRETE_TR = 8 rows with the row loop
// unrolled: its row is so short that more warps to hide the loads' latency
// gain more than taller strips save in halo rows. The continuous mode, with
// seven times the bytes per site in flight, takes the tallest strip (a power
// of two, MAX_TR down to 8) whose grid still holds MIN_WARPS warps, and a
// row loop that is not unrolled. The batched kernel takes its replica from
// blockIdx.z (B <= 65535) and offsets the planes and uniforms by b * R * C2
// in size_t. Every replica reads the same weight or code planes, indexed
// without b.

#include <type_traits>

#include "tsu_common.cuh"

namespace {

constexpr int NW = 4;                // warps per block, one strip each
constexpr unsigned FULL_MASK = 0xFFFFFFFFu;
constexpr int MAX_TR = 64;           // the tallest strip of weight planes
constexpr int MIN_WARPS = 1056;      // warps a grid of them should hold: 132 SMs x 8
constexpr int DISCRETE_TR = 8;       // the strip of code planes

struct Planes5 {
  const void* p[5];  // w_up, w_down, w_left, w_right, field; or p[0] = codes
};

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

// Sign words. A lane holds a row of its four sites as one 32-bit word whose
// bit 8t+7 is the sign bit of site t (1 for -1) and whose other bits are 0.
__device__ __forceinline__ uint32_t signs(uint2 q) {      // four bfloat16
  return __byte_perm(q.x, q.y, 0x7531) & 0x80808080u;
}

__device__ __forceinline__ uint32_t signs(uint4 q) {      // four float32
  return __byte_perm(__byte_perm(q.x, q.y, 0x0073), __byte_perm(q.z, q.w, 0x0073), 0x5410) &
         0x80808080u;
}

template <typename S>
__device__ __forceinline__ uint32_t sign_byte(const S* row, int c) {
  using U = typename Bits<S>::U;
  return (uint32_t)(reinterpret_cast<const U*>(row)[c] >> (8 * sizeof(U) - 8)) & 0x80u;
}

// The sign word of a lane's four columns gc[] on row `row` (null: 0).
template <typename S, bool VEC>
__device__ __forceinline__ uint32_t load_signs(const S* row, const int gc[4]) {
  if (row == nullptr) return 0u;
  if (VEC) return signs(*reinterpret_cast<const typename Bits<S>::Quad*>(row + gc[0]));
  uint32_t w = 0u;
#pragma unroll
  for (int t = 0; t < 4; ++t) w |= sign_byte(row, gc[t]) << (8 * t);
  return w;
}

// Lane 0's left neighbour on a picked row, lane 31's right one on the other
// rows: the column across the warp's edge, column `ge` of row `row`, as a
// sign word with the sign in bits 7 and 31 (the two shifts of bond_strip
// take one of them). 0 for every other lane, and where a rotation of the
// warp's lanes carries it.
template <typename S>
__device__ __forceinline__ uint32_t edge_signs(const S* row, int lr, int lane, int ge,
                                               bool rotate, int update_red) {
  const bool picked = ((lr & 1) == 0) == (update_red != 0);
  if (rotate || lane != (picked ? 0 : 31)) return 0u;
  return sign_byte(row, ge) ? 0x80000080u : 0u;
}

// The spin of site t of a sign word as float32.
__device__ __forceinline__ float spin(uint32_t w, int t) {
  return (w >> (8 * t + 7)) & 1u ? -1.0f : 1.0f;
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

// Row lr (-1 <= lr <= R) of the other plane: its pointer, or null where it
// lies outside an open lattice (its spins count 0).
template <typename S>
__device__ __forceinline__ const S* other_row(const S* other, int lr, int R, int C2,
                                              int periodic) {
  if (lr < 0 || lr >= R) {
    if (!periodic) return nullptr;
    lr = lr < 0 ? lr + R : lr - R;
  }
  return other + (size_t)lr * C2;
}

// The per-site operands of one row that are not spins: the four codes, one
// byte per site (discrete), or the five weights widened to float32
// (continuous); and the injected uniforms.
struct SiteOps {
  uint32_t code;
  float w[5][4];
  int u[4];
};

__device__ __forceinline__ void widen(uint4 q, float w[4]) {
  w[0] = __uint_as_float(q.x);
  w[1] = __uint_as_float(q.y);
  w[2] = __uint_as_float(q.z);
  w[3] = __uint_as_float(q.w);
}

__device__ __forceinline__ void widen(uint2 q, float w[4]) {
  w[0] = __uint_as_float(q.x << 16);
  w[1] = __uint_as_float(q.x & 0xFFFF0000u);
  w[2] = __uint_as_float(q.y << 16);
  w[3] = __uint_as_float(q.y & 0xFFFF0000u);
}

// Load the operands of the sites v0 .. v0+3 of a row owned by a lane (v0 <
// C2), at offset `at` of the planes: with VEC one load per plane, otherwise
// one per site v < C2.
template <typename W, bool VEC, bool INJ>
__device__ __forceinline__ void load_ops(SiteOps& o, const Planes5& w,
                                         const int* __restrict__ uniforms, size_t at, int v0,
                                         int C2) {
  if constexpr (std::is_same<W, uint8_t>::value) {
    const uint8_t* codes = static_cast<const uint8_t*>(w.p[0]);
    if (VEC) {
      o.code = *reinterpret_cast<const uint32_t*>(codes + at);
    } else {
      o.code = 0u;
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (v0 + t < C2) o.code |= (uint32_t)codes[at + t] << (8 * t);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const W* p = static_cast<const W*>(w.p[i]) + at;
      if (VEC) {
        widen(*reinterpret_cast<const typename Bits<W>::Quad*>(p), o.w[i]);
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t) o.w[i][t] = v0 + t < C2 ? to_f32(p[t]) : 0.0f;
      }
    }
  }
  if constexpr (INJ) {
    if (VEC) {
      const int4 q = *reinterpret_cast<const int4*>(uniforms + at);
      o.u[0] = q.x; o.u[1] = q.y; o.u[2] = q.z; o.u[3] = q.w;
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t) o.u[t] = v0 + t < C2 ? uniforms[at + t] : 0;
    }
  }
}

// The discrete local fields of a lane's four sites, plus 4, one per byte
// (0..8). Field i of a code byte holds f = w_i + 1 in {0, 1, 2}, and the
// term w_i s_i + 1 is f where s_i = +1, 2 - f where s_i = -1 (f with bit 1
// flipped unless bit 0 is set) and 1 where s_i = 0 (zero: the fields of the
// up or down row outside an open lattice). `neg` has bit 1 of field i set
// where s_i = -1. The four terms of each byte are then summed within it.
__device__ __forceinline__ uint32_t local_plus4(uint32_t code, uint32_t neg, uint32_t zero) {
  uint32_t x = code ^ (~(code << 1) & neg);
  x = (x & ~zero) | (0x55555555u & zero);
  const uint32_t pairs = (x & 0x33333333u) + ((x >> 2) & 0x33333333u);
  return (pairs & 0x0F0F0F0Fu) + ((pairs >> 4) & 0x0F0F0F0Fu);
}

// One half-sweep of the strip of rows [r0, r0 + tr) of one lattice, by the
// column warp blockIdx.x. W is float or __nv_bfloat16 for weight planes,
// uint8_t for codes with a 9-entry table. VEC: C2 % 4 == 0 and every plane
// pointer aligned for its quad. TR: a fixed strip height (the row loop is
// unrolled), or 0 for strips of `tr` rows.
template <typename S, typename W, bool VEC, bool INJ, int TR>
__device__ __forceinline__ void bond_strip(
    const S* __restrict__ other, S* __restrict__ out, const Planes5& w, float T,
    const int* __restrict__ table, const int* __restrict__ uniforms, int R, int C2,
    int update_red, int periodic, uint32_t k0, uint32_t k1, int tr) {
  constexpr bool CODES = std::is_same<W, uint8_t>::value;
  __shared__ int st[9];                 // thresholds for local fields -4..4
  if constexpr (CODES) {
    const int i = threadIdx.y * 32 + threadIdx.x;
    if (i < 9) st[i] = table[i];
    __syncthreads();
  }
  const int rows = TR ? TR : tr;
  const int r0 = (blockIdx.y * NW + threadIdx.y) * rows;
  if (r0 >= R) return;                  // the whole warp lies past the plane
  const int r1 = min(r0 + rows, R);
  const int lane = threadIdx.x;
  const int c0 = 128 * blockIdx.x;
  const int v0 = c0 + 4 * lane;
  const bool own = v0 < C2;             // the lane stores columns v0 .. min(v0 + 3, C2 - 1)
  int gc[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) gc[t] = (v0 + t) % C2;
  // Across the warp's edges: lane 0's column c0 - 1 and lane 31's c0 + 128,
  // both wrapped. Where C2 divides 128 they are the warp's own columns 127
  // and 0, and the rotation of the lanes brings them.
  const bool rotate = 128 % C2 == 0;
  const int ge = lane == 0 ? (c0 + C2 - 1) % C2 : (c0 + 128) % C2;

  // The strip's halo rows r0 - 1 and r1, wrapped or null; the rows between
  // lie inside the plane, row r at offset `at`.
  const S* top = other_row(other, r0 - 1, R, C2, periodic);
  const S* bottom = other_row(other, r1, R, C2, periodic);
  const size_t stride = C2;
  size_t at = (size_t)r0 * C2;
  // Sign words of rows r-1, r, r+1 and r+2 (loaded a row ahead) of the other
  // plane, and of the edge column of rows r+1 and r+2 (lanes 0 and 31).
  uint32_t up, mid = load_signs<S, VEC>(top, gc);
  uint32_t dn = load_signs<S, VEC>(other + at, gc);
  uint32_t ahead = load_signs<S, VEC>(other + at + stride, gc);
  uint32_t e_dn = edge_signs(other + at, r0, lane, ge, rotate, update_red);
  uint32_t e_ahead = edge_signs(other + at + stride, r0 + 1, lane, ge, rotate, update_red);
  SiteOps next;
  if (own) load_ops<W, VEC, INJ>(next, w, uniforms, at + v0, v0, C2);

#pragma unroll
  for (int i = 0; i < rows; ++i, at += stride) {
    const int r = r0 + i;
    if (r >= r1) break;
    const uint32_t e_mid = e_dn;
    up = mid;
    mid = dn;
    dn = ahead;
    e_dn = e_ahead;
    if (r + 2 < r1) {
      const S* row = other + at + 2 * stride;
      ahead = load_signs<S, VEC>(row, gc);
      e_ahead = edge_signs(row, r + 2, lane, ge, rotate, update_red);
    } else if (r + 2 == r1) {
      ahead = load_signs<S, VEC>(bottom, gc);
    }
    const SiteOps cur = next;
    if (own && r + 1 < r1) load_ops<W, VEC, INJ>(next, w, uniforms, at + stride + v0, v0, C2);

    // The left neighbour is column c-1 on picked rows, the site's own column
    // otherwise; the right one is its own column on picked rows, c+1
    // otherwise. Across the group's edge it comes from the next lane.
    const bool picked = ((r & 1) == 0) == (update_red != 0);
    uint32_t e = __shfl_sync(FULL_MASK, mid, (lane + (picked ? 31 : 1)) & 31);
    if (!rotate && lane == (picked ? 0 : 31)) e = e_mid;
    const uint32_t left = picked ? __funnelshift_l(e, mid, 8) : mid;
    const uint32_t right = picked ? mid : __funnelshift_r(mid, e, 8);
    const bool up_zero = !periodic && r == 0, dn_zero = !periodic && r == R - 1;
    if (!own) continue;

    uint4 words = make_uint4(0u, 0u, 0u, 0u);
    if (!INJ)
      words = philox4x32_10(make_uint4((uint32_t)r, (uint32_t)(v0 >> 2), 0u, 0u), k0, k1);
    bool plus[4];
    uint32_t fields = 0u;
    if constexpr (CODES)
      fields = local_plus4(cur.code, (up >> 6) | (dn >> 4) | (left >> 2) | right,
                           (up_zero ? 0x03030303u : 0u) | (dn_zero ? 0x0C0C0C0Cu : 0u));
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int u24 = INJ ? cur.u[t] : (int)(pick(words, t) >> 8);
      if constexpr (CODES) {
        plus[t] = u24 < st[(fields >> (8 * t)) & 0xFFu];
      } else {
        float local = __fmul_rn(cur.w[0][t], up_zero ? 0.0f : spin(up, t));
        local = __fadd_rn(local, __fmul_rn(cur.w[1][t], dn_zero ? 0.0f : spin(dn, t)));
        local = __fadd_rn(local, __fmul_rn(cur.w[2][t], spin(left, t)));
        local = __fadd_rn(local, __fmul_rn(cur.w[3][t], spin(right, t)));
        local = __fadd_rn(local, cur.w[4][t]);
        const float x = __fdiv_rn(__fmul_rn(2.0f, local), T);
        const float p = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
        plus[t] = __fmul_rn((float)u24, 5.9604644775390625e-08f) < p;
      }
    }
    S* row_out = out + at;
    if (VEC) {
      using Quad = typename Bits<S>::Quad;
      *reinterpret_cast<Quad*>(row_out + v0) = pack(plus, Quad{});
    } else {
      using U = typename Bits<S>::U;
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (v0 + t < C2)
          reinterpret_cast<U*>(row_out)[v0 + t] =
              (U)(plus[t] ? Bits<S>::ONE : Bits<S>::ONE | Bits<S>::SIGN);
    }
  }
}

template <typename S, typename W, bool VEC, bool INJ, int TR>
__global__ void __launch_bounds__(32 * NW) bond_halfsweep_kernel(
    const S* __restrict__ other, S* __restrict__ out, Planes5 w, float T,
    const int* __restrict__ table, const int* __restrict__ uniforms, int R, int C2,
    int update_red, int periodic, uint32_t k0, uint32_t k1, int tr) {
  bond_strip<S, W, VEC, INJ, TR>(other, out, w, T, table, uniforms, R, C2, update_red, periodic,
                                 k0, k1, tr);
}

// Replica b = blockIdx.z: planes and uniforms at b * R * C2, temperature
// temps[b] or table row b, key row b; the weight or code planes are shared.
template <typename S, typename W, bool VEC, bool INJ, int TR>
__global__ void __launch_bounds__(32 * NW) bond_halfsweep_batched_kernel(
    const S* __restrict__ others, S* __restrict__ outs, Planes5 w,
    const float* __restrict__ temps, const int* __restrict__ tables,
    const uint32_t* __restrict__ keys, const int* __restrict__ uniforms, int R, int C2,
    int update_red, int periodic, int tr) {
  const size_t b = blockIdx.z;
  const size_t plane = (size_t)R * C2;
  bond_strip<S, W, VEC, INJ, TR>(others + b * plane, outs + b * plane, w,
                                 temps == nullptr ? 1.0f : temps[b],
                                 tables == nullptr ? nullptr : tables + 9 * b,
                                 INJ ? uniforms + b * plane : nullptr, R, C2, update_red,
                                 periodic, keys[2 * b], keys[2 * b + 1], tr);
}

// The strip height of a mode: DISCRETE_TR rows for codes; for weight planes
// the tallest power of two from MAX_TR down to 8 whose grid holds MIN_WARPS
// column warps over the B lattices.
template <typename W>
int strip_rows(int B, int R, int C2) {
  if (std::is_same<W, uint8_t>::value) return DISCRETE_TR;
  const long long warps = (C2 + 127) / 128;
  int tr = MAX_TR;
  while (tr > 8 && warps * ((R + tr - 1) / tr) * B < MIN_WARPS) tr /= 2;
  return tr;
}

dim3 grid_of(int B, int R, int C2, int tr) {
  const int strips = (R + tr - 1) / tr;
  return dim3((C2 + 127) / 128, (strips + NW - 1) / NW, B);
}

// The vector path: C2 % 4 == 0, the other plane and the output aligned to a
// quad of S, the codes to 4 B or the weights to a quad of W, and the
// uniforms to 16 B (a null pointer passes).
template <typename S, typename W>
bool vector_path(int C2, const void* other, const void* out, const Planes5& w,
                 const void* uniforms) {
  if (C2 % 4 != 0) return false;
  const uintptr_t s = 4 * sizeof(S), q = 4 * sizeof(W);
  bool ok = (uintptr_t)other % s == 0 && (uintptr_t)out % s == 0 && (uintptr_t)uniforms % 16 == 0;
  const int n = std::is_same<W, uint8_t>::value ? 1 : 5;
  for (int i = 0; i < n; ++i) ok = ok && (uintptr_t)w.p[i] % q == 0;
  return ok;
}

// Codes run fixed strips of DISCRETE_TR rows with the row loop unrolled;
// weight planes strips of strip_rows rows.
template <typename W>
constexpr int fixed_rows() {
  return std::is_same<W, uint8_t>::value ? DISCRETE_TR : 0;
}

template <typename S, typename W, bool VEC, bool INJ>
void launch_one(const void* other, void* out, Planes5 w, float T, const void* table,
                const void* uniforms, int R, int C2, int update_red, int periodic, uint32_t k0,
                uint32_t k1, cudaStream_t s) {
  constexpr int TR = fixed_rows<W>();
  const int tr = strip_rows<W>(1, R, C2);
  bond_halfsweep_kernel<S, W, VEC, INJ, TR><<<grid_of(1, R, C2, tr), dim3(32, NW), 0, s>>>(
      (const S*)other, (S*)out, w, T, (const int*)table, (const int*)uniforms, R, C2,
      update_red, periodic, k0, k1, tr);
}

template <typename S, typename W>
int launch(const void* other, void* out, Planes5 w, float T, const void* table,
           const void* uniforms, int R, int C2, int update_red, int periodic, uint32_t k0,
           uint32_t k1, cudaStream_t s) {
  const bool vec = vector_path<S, W>(C2, other, out, w, uniforms);
  auto go = uniforms ? (vec ? launch_one<S, W, true, true> : launch_one<S, W, false, true>)
                     : (vec ? launch_one<S, W, true, false> : launch_one<S, W, false, false>);
  go(other, out, w, T, table, uniforms, R, C2, update_red, periodic, k0, k1, s);
  return (int)cudaGetLastError();
}

template <typename S, typename W, bool VEC, bool INJ>
void launch_batch(const void* others, void* outs, Planes5 w, const void* temps,
                  const void* tables, const void* keys, const void* uniforms, int B, int R,
                  int C2, int update_red, int periodic, cudaStream_t s) {
  constexpr int TR = fixed_rows<W>();
  const int tr = strip_rows<W>(B, R, C2);
  bond_halfsweep_batched_kernel<S, W, VEC, INJ, TR><<<grid_of(B, R, C2, tr), dim3(32, NW), 0,
                                                      s>>>(
      (const S*)others, (S*)outs, w, (const float*)temps, (const int*)tables,
      (const uint32_t*)keys, (const int*)uniforms, R, C2, update_red, periodic, tr);
}

template <typename S, typename W>
int launch_batched(const void* others, void* outs, Planes5 w, const void* temps,
                   const void* tables, const void* keys, const void* uniforms, int B, int R,
                   int C2, int update_red, int periodic, cudaStream_t s) {
  const bool vec = vector_path<S, W>(C2, others, outs, w, uniforms);
  auto go = uniforms ? (vec ? launch_batch<S, W, true, true> : launch_batch<S, W, false, true>)
                     : (vec ? launch_batch<S, W, true, false> : launch_batch<S, W, false, false>);
  go(others, outs, w, temps, tables, keys, uniforms, B, R, C2, update_red, periodic, s);
  return (int)cudaGetLastError();
}

// Plane dtype (is_bf16) x weight kind (0 float32 weights, 1 bfloat16
// weights, 2 uint8 codes); -1 for an unknown combination.
#define TSU_BOND_DISPATCH(FN, ...)                                    \
  switch (3 * is_bf16 + wkind) {                                      \
    case 0: return FN<float, float>(__VA_ARGS__);                     \
    case 1: return FN<float, __nv_bfloat16>(__VA_ARGS__);             \
    case 2: return FN<float, uint8_t>(__VA_ARGS__);                   \
    case 3: return FN<__nv_bfloat16, float>(__VA_ARGS__);             \
    case 4: return FN<__nv_bfloat16, __nv_bfloat16>(__VA_ARGS__);     \
    case 5: return FN<__nv_bfloat16, uint8_t>(__VA_ARGS__);           \
    default: return -1;                                               \
  }

}  // namespace

// One half-sweep of one lattice on `stream`: resample the colour whose
// weights (w0..w4) or codes (w0, wkind 2, with the (9,) int32 `table`) are
// given, from `other`, into `out`. other and out are (R, C2) float32
// (is_bf16 == 0) or bfloat16; T is the temperature of the continuous mode;
// uniforms is null or (R, C2) int32. 1 <= R <= 32 * 65535 (the grid holds
// 65535 blocks of four strips of at least 8 rows). Returns cudaGetLastError()
// after the launch, or -1 for an unknown dtype.
extern "C" int tsu_bond_halfsweep(const void* other, void* out, const void* w0, const void* w1,
                                  const void* w2, const void* w3, const void* w4, int wkind,
                                  int is_bf16, float T, const void* table, const void* uniforms,
                                  int R, int C2, int update_red, int periodic, unsigned int k0,
                                  unsigned int k1, void* stream) {
  const Planes5 w = {{w0, w1, w2, w3, w4}};
  TSU_BOND_DISPATCH(launch, other, out, w, T, table, uniforms, R, C2, update_red, periodic, k0,
                    k1, (cudaStream_t)stream)
}

// One half-sweep of B replicas of one bond set on `stream`. others and outs
// are (B, R, C2); temps is (B,) float32 (continuous) or null; tables is
// (B, 9) int32 (codes) or null; keys is (B, 2) uint32, row b the Philox key
// of replica b; uniforms is null or (B, R, C2) int32. 1 <= B <= 65535 and
// 1 <= R <= 32 * 65535. Returns cudaGetLastError() after the launch, or -1
// for an unknown dtype.
extern "C" int tsu_bond_halfsweep_batched(const void* others, void* outs, const void* w0,
                                          const void* w1, const void* w2, const void* w3,
                                          const void* w4, int wkind, int is_bf16,
                                          const void* temps, const void* tables,
                                          const void* keys, const void* uniforms, int B, int R,
                                          int C2, int update_red, int periodic, void* stream) {
  const Planes5 w = {{w0, w1, w2, w3, w4}};
  TSU_BOND_DISPATCH(launch_batched, others, outs, w, temps, tables, keys, uniforms, B, R, C2,
                    update_red, periodic, (cudaStream_t)stream)
}
