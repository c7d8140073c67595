// Checkerboard heat-bath half-sweeps with per-bond (disordered) couplings:
// the +-J Edwards-Anderson spin glass and random-bond lattices.
//
// Replaces two Pallas TPU kernels of tsu_tpu/ops/checkerboard_bonds_pallas.py
// on NVIDIA Hopper (sm_90a): _halfsweep_bonds_kernel (one lattice) and
// _halfsweep_bonds_kernel_batched (B replicas sharing one bond set, each at
// its own temperature, in one launch). One launch resamples one colour of the
// compact (R, C/2) planes of tsu_tpu/ops/checkerboard.py from the other
// colour's plane and writes it to a new plane, so no launch reads what it
// writes and the blocks need no order.
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
//   discrete: one uint8 code per site, bits 2i..2i+1 holding w_i + 1 for
//     (up, down, left, right); the integer local field in -4..4 indexes a
//     9-entry 24-bit threshold table, and the site is +1 if u24 < table[l+4].
//     The TPU kernel's 5-entry parity table ("pure") picks the same entries
//     for the even fields of a periodic pure +-1 lattice, so it has no
//     variant here.
// The new spin is written in the other plane's dtype (float32 or bfloat16).
//
// Random numbers. One 24-bit uniform per site per half-sweep: the top 24
// bits of the site's Philox4x32-10 word at counter (row, col / 4, 0, 0),
// output col % 4, under the launch's key. The wrappers key the single-lattice
// kernel by (fold_seed(seed, colour), sweep) and replica b of the batched one
// by (fold_seed(seed_b), 2 * sweep + colour), so the two colours of a sweep
// draw different words. A thread owns four sites of a row and one Philox
// call serves them. Injected uniforms, (R, C2) int32 in [0, 2^24) per
// lattice, replace the generator.
//
// Layout. A block of 32 x 8 threads covers 128 compact columns of 8 rows;
// the batched kernel takes its replica from blockIdx.z (B <= 65535) and
// offsets the planes and uniforms by b * R * C2 in size_t. Every replica
// reads the same weight or code planes, indexed without b, and its own
// temperature, or table row, and key row.
//
// Bound. Compulsory traffic per site per half-sweep: discrete bf16 reads 2 B
// of the other plane and 1 B of code and writes 2 B, ~5 B (the up/down/
// left/right reads of the other plane hit L1/L2); continuous float32 reads
// 16 B of bond weights, 4 B of field and 4 B of the other plane and writes
// 4 B, ~28 B. At the H100's 3.35 TB/s that is ~1.5 ps/site discrete and
// ~8.4 ps/site continuous; Philox adds 0.25 calls per site and the
// continuous mode one expf and two divisions. This first version loads with
// scalar reads from device memory and keeps nothing in shared memory.

#include <type_traits>

#include "tsu_common.cuh"

namespace {

constexpr int BX = 32;  // threads along a row, four compact columns each
constexpr int BY = 8;   // rows per block

struct Planes5 {
  const void* p[5];  // w_up, w_down, w_left, w_right, field; or p[0] = codes
};

// Resample the four sites (r, 4q .. 4q+3) owned by this thread. W is float or
// __nv_bfloat16 for weight planes, uint8_t for codes with a 9-entry table.
template <typename S, typename W>
__device__ __forceinline__ void bond_quad(
    const S* __restrict__ other, S* __restrict__ out, const Planes5& w, float T,
    const int* __restrict__ table, const int* __restrict__ uniforms, int R, int C2,
    int update_red, int periodic, uint32_t k0, uint32_t k1) {
  const int r = blockIdx.y * BY + threadIdx.y;
  const int q = blockIdx.x * BX + threadIdx.x;
  const int c0 = 4 * q;
  if (r >= R || c0 >= C2) return;
  // The left neighbour is column c-1 (wrapped) on picked rows, the site's own
  // column otherwise; the right one is its own column on picked rows, c+1.
  const bool picked = ((r & 1) == 0) == (update_red != 0);
  const int ru = r > 0 ? r - 1 : (periodic ? R - 1 : -1);
  const int rd = r + 1 < R ? r + 1 : (periodic ? 0 : -1);
  const size_t row = (size_t)r * C2;
  uint4 words = make_uint4(0u, 0u, 0u, 0u);
  if (uniforms == nullptr) words = philox4x32_10(make_uint4((uint32_t)r, (uint32_t)q, 0u, 0u), k0, k1);
  const int n = C2 - c0 < 4 ? C2 - c0 : 4;
  for (int t = 0; t < n; ++t) {
    const int c = c0 + t;
    const size_t o = row + c;
    const float self = to_f32(other[o]);
    const float up = ru >= 0 ? to_f32(other[(size_t)ru * C2 + c]) : 0.0f;
    const float dn = rd >= 0 ? to_f32(other[(size_t)rd * C2 + c]) : 0.0f;
    const float left = picked ? to_f32(other[row + (c == 0 ? C2 - 1 : c - 1)]) : self;
    const float right = picked ? self : to_f32(other[row + (c == C2 - 1 ? 0 : c + 1)]);
    const int u24 = uniforms != nullptr ? uniforms[o] : (int)(pick(words, t) >> 8);
    bool plus;
    if constexpr (std::is_same<W, uint8_t>::value) {
      const int code = static_cast<const uint8_t*>(w.p[0])[o];
      const int local = ((code & 3) - 1) * (int)up + (((code >> 2) & 3) - 1) * (int)dn +
                        (((code >> 4) & 3) - 1) * (int)left + (((code >> 6) & 3) - 1) * (int)right;
      plus = u24 < table[local + 4];
    } else {
      const W* wu = static_cast<const W*>(w.p[0]);
      const W* wd = static_cast<const W*>(w.p[1]);
      const W* wl = static_cast<const W*>(w.p[2]);
      const W* wr = static_cast<const W*>(w.p[3]);
      const W* f = static_cast<const W*>(w.p[4]);
      float local = __fmul_rn(to_f32(wu[o]), up);
      local = __fadd_rn(local, __fmul_rn(to_f32(wd[o]), dn));
      local = __fadd_rn(local, __fmul_rn(to_f32(wl[o]), left));
      local = __fadd_rn(local, __fmul_rn(to_f32(wr[o]), right));
      local = __fadd_rn(local, to_f32(f[o]));
      const float x = __fdiv_rn(__fmul_rn(2.0f, local), T);
      const float p = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
      plus = __fmul_rn((float)u24, 5.9604644775390625e-08f) < p;
    }
    out[o] = from_f32<S>(plus ? 1.0f : -1.0f);
  }
}

template <typename S, typename W>
__global__ void __launch_bounds__(BX * BY) bond_halfsweep_kernel(
    const S* __restrict__ other, S* __restrict__ out, Planes5 w, float T,
    const int* __restrict__ table, const int* __restrict__ uniforms, int R, int C2,
    int update_red, int periodic, uint32_t k0, uint32_t k1) {
  bond_quad<S, W>(other, out, w, T, table, uniforms, R, C2, update_red, periodic, k0, k1);
}

// Replica b = blockIdx.z: planes and uniforms at b * R * C2, temperature
// temps[b] or table row b, key row b; the weight or code planes are shared.
template <typename S, typename W>
__global__ void __launch_bounds__(BX * BY) bond_halfsweep_batched_kernel(
    const S* __restrict__ others, S* __restrict__ outs, Planes5 w,
    const float* __restrict__ temps, const int* __restrict__ tables,
    const uint32_t* __restrict__ keys, const int* __restrict__ uniforms, int R, int C2,
    int update_red, int periodic) {
  const size_t b = blockIdx.z;
  const size_t plane = (size_t)R * C2;
  bond_quad<S, W>(others + b * plane, outs + b * plane, w,
                  temps == nullptr ? 1.0f : temps[b], tables == nullptr ? nullptr : tables + 9 * b,
                  uniforms == nullptr ? nullptr : uniforms + b * plane, R, C2, update_red,
                  periodic, keys[2 * b], keys[2 * b + 1]);
}

dim3 grid_of(int R, int C2, int B) {
  const int quads = (C2 + 3) / 4;
  return dim3((quads + BX - 1) / BX, (R + BY - 1) / BY, B);
}

template <typename S, typename W>
int launch(const void* other, void* out, Planes5 w, float T, const void* table,
           const void* uniforms, int R, int C2, int update_red, int periodic, uint32_t k0,
           uint32_t k1, cudaStream_t s) {
  bond_halfsweep_kernel<S, W><<<grid_of(R, C2, 1), dim3(BX, BY), 0, s>>>(
      (const S*)other, (S*)out, w, T, (const int*)table, (const int*)uniforms, R, C2,
      update_red, periodic, k0, k1);
  return (int)cudaGetLastError();
}

template <typename S, typename W>
int launch_batched(const void* others, void* outs, Planes5 w, const void* temps,
                   const void* tables, const void* keys, const void* uniforms, int B, int R,
                   int C2, int update_red, int periodic, cudaStream_t s) {
  bond_halfsweep_batched_kernel<S, W><<<grid_of(R, C2, B), dim3(BX, BY), 0, s>>>(
      (const S*)others, (S*)outs, w, (const float*)temps, (const int*)tables,
      (const uint32_t*)keys, (const int*)uniforms, R, C2, update_red, periodic);
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
// uniforms is null or (R, C2) int32. 1 <= R <= 8 * 65535. Returns
// cudaGetLastError() after the launch, or -1 for an unknown dtype.
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
// of replica b; uniforms is null or (B, R, C2) int32. 1 <= B <= 65535.
// Returns cudaGetLastError() after the launch, or -1 for an unknown dtype.
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
