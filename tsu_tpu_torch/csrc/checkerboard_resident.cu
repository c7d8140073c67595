// Resident multi-sweep checkerboard heat-bath kernel of the uniform-J 2-D
// Ising model: S full sweeps in one cooperative launch, the spins held on
// chip as sign bits for the whole call.
//
// Replaces two Pallas TPU kernels of tsu_tpu/ops/checkerboard_resident.py on
// NVIDIA Hopper (sm_90a): _resident_kernel (S sweeps at one temperature) and
// _resident_anneal_kernel (one threshold table per sweep). One kernel body
// serves both: the table pointer advances by `table_stride` ints per sweep,
// 0 for the fixed temperature and 9 for the anneal.
//
// Design. The TPU kernel keeps both colour planes in VMEM for the whole call.
// Here each block owns a fixed tile of the compact (R, C2) planes for the
// whole call: a band of rows and a range of 32-column words, chosen by the
// wrapper (ops/checkerboard_resident.py:resident_plan; one range of words,
// the full row, unless the lattice is too wide for a band's rows to fit).
// Its sites live in dynamic shared memory as bits, bit c % 32 of word c / 32
// for compact column c, 1 for spin +1, both colours, with one halo row above
// and below and one halo word left and right of every row. The input black
// plane is read once at the start (the sign bit of each bf16 or f32 value;
// the planes hold +-1; red is recomputed before it is read), and both planes
// are written once at the end as 0x3F80 / 0xBF80 (or the f32 patterns), so
// device memory is touched once per call.
//
// Halos. A half-step reads the other colour's tile and writes its own. A
// block publishes the edges of the colour it wrote (its first and last rows,
// and where rows are cut into ranges its first and last words of every row)
// into that colour's bit image in device memory (R x ceil(C2 / 32) words,
// one per colour, allocated by the wrapper), then raises its flag to the
// half-step's epoch (st.release). Before the next half-step it waits until
// the flags of the blocks its halos come from reach that epoch (ld.acquire)
// and reads their edges from the image into its halo slots (through L2,
// __ldcg, since other blocks wrote them in this launch). With whole rows a
// block updates its two edge rows first and publishes them before the rest,
// so the exchange overlaps its own interior rows. One image per colour
// suffices: a block rewrites a colour's edges two half-steps later, after it
// has waited for its neighbours' next epoch, which they raise only after
// reading the edges it overwrites. The launch is cooperative, so every block
// is resident and no wait is for a block that has not started. Halo rows
// past an open lattice's top or bottom are zeros; a periodic lattice wraps,
// so at R = 2 a row's upper and lower neighbour are the same row and count
// twice.
//
// Local field. A lane owns a byte of a word, eight compact columns, two
// Philox groups; a warp owns eight words (256 columns) of one row. The
// horizontal partner (column c - 1 for red on even rows and black on odd
// rows, c + 1 otherwise: the compact layout of tsu_tpu/ops/checkerboard.py)
// is the centre word shifted by one with the carry from the adjacent word;
// at the lattice's first or last column the partner is the wrapped column
// (also at a ragged last word and at C2 = 1, where it is the column itself)
// or absent. Each of the four neighbour nibbles is spread to one bit per
// byte, scaled so that their sum is 8 * (number of +1 neighbours) per site;
// adding 4 per absent neighbour of an open edge makes each byte the byte
// offset of the site's entry nbr + 4 of the 9-entry table (nbr = 2 * plus -
// present), so a site's uniform meets its threshold in one byte extract, one
// shared load and one compare. Where every threshold of the sweep is below
// 2^24 (as sigmoid_table makes them) the table holds them shifted left by 8
// and the Philox word itself is compared, without its shift. The eight
// sites' bits are merged into the word by two xor-shuffles across the
// word's four lanes.
//
// Random numbers. Unchanged from the first, grid-stride body: each site
// takes one 32-bit word of Philox4x32-10 per half-step, keyed
// (fold_seed(seed), 2 * sweep + colour) at counter (row, col / 4, 0, 0),
// output col % 4; its top 24 bits are the uniform, held against the 24-bit
// threshold of the local field (the 9-entry table of sigmoid_table). With
// injected uniforms (S, 2, R, C2) int32, [s][0] drives red and [s][1] black
// of sweep s.
//
// Bound. Device memory is read and written once per call, so its bytes do
// not bound a sweep. The work is one Philox call per group of four sites per
// half-step (ten rounds of two 32 x 32 -> 64 bit multiplies and two
// three-input xors: 40 int32 instructions, the key schedule on uniform
// registers) and the field and select around it: the int32 pipe bounds the
// kernel, plus one halo exchange per half-step. PERF.md has its time beside
// the grid-stride body's and its SASS count.

#include "tsu_common.cuh"

namespace {

constexpr int NT = 512;               // threads per block
constexpr int WARPS = NT / 32;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int TABLE_WORDS = 16;       // shared words before the tiles: the 9-entry table

// The raw bits of a plane element: the sign bit and the patterns of +-1.
template <typename T> struct Spin;
template <> struct Spin<__nv_bfloat16> {
  using U = uint16_t;
  static constexpr int SIGN_BIT = 15;
  static constexpr U UP = 0x3F80u, DOWN = 0xBF80u;
};
template <> struct Spin<float> {
  using U = uint32_t;
  static constexpr int SIGN_BIT = 31;
  static constexpr U UP = 0x3F800000u, DOWN = 0xBF800000u;
};

// The lattice, and this block's tile: rows [r0, r0 + nr), words [w0, w0 + nw)
// of the W = ceil(C2 / 32) words of a row; tile (by, bx) of ty bands by tx
// ranges. A colour's tile holds rows 0 .. nr + 1 (0 and nr + 1 the halos)
// of `stride` words, slot s for word w0 - 1 + s (slots 0 and nw + 1 the
// halos, wrapped). nb: the blocks whose edges this tile's halos hold (-1:
// none, past an open edge).
struct Tile {
  int R, C2, W, stride, ty, tx;
  int r0, nr, w0, nw;
  int nb[4];
};

// Bits of the four sites of a nibble, one per byte at bit 3: 8 per +1 spin.
__device__ __forceinline__ uint32_t spread8(uint32_t nibble) {
  return ((nibble & 0xFu) * 0x01020408u) & 0x08080808u;
}

__device__ __forceinline__ int wrap(int i, int n) { return i < 0 ? i + n : (i >= n ? i - n : i); }

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Bits of word w (columns 32w .. 32w + 31) of row r of a plane, one warp.
template <typename T>
__device__ __forceinline__ uint32_t pack_word(const T* plane, int r, int w, int C2, int lane) {
  const int c = 32 * w + lane;
  bool up = false;
  if (c < C2) {
    const typename Spin<T>::U v =
        reinterpret_cast<const typename Spin<T>::U*>(plane)[(size_t)r * C2 + c];
    up = ((v >> Spin<T>::SIGN_BIT) & 1u) == 0u;
  }
  return __ballot_sync(FULL, up);
}

// Dynamic shared memory: the sweep's 9-entry table at byte 0, then the red
// tile and the black tile from word TABLE_WORDS on.
extern __shared__ uint32_t block_smem[];

// The table entry at byte offset b (4 * (nbr + 4)).
__device__ __forceinline__ int table_at(uint32_t b) {
  return *reinterpret_cast<const int*>(reinterpret_cast<const char*>(block_smem) + b);
}

// Byte offsets of the table entries of the four sites of the nibble at bit sh
// of the neighbour words, plus `miss` (4 per absent neighbour in each byte).
__device__ __forceinline__ uint32_t offsets(uint32_t M, uint32_t U, uint32_t D, uint32_t H,
                                            int sh, uint32_t miss) {
  return spread8(M >> sh) + spread8(U >> sh) + spread8(D >> sh) + spread8(H >> sh) + miss;
}

// Resample `count` rows of this block's sites of one colour (`mine`), tile
// rows first, first + step, ..., from the other colour's tile. u: the
// half-step's injected (R, C2) uniforms, or null for Philox. SHIFTED: the
// table holds max(threshold, 0) << 8 (every threshold of the sweep is below
// 2^24), and a site is +1 when its 32-bit word is below it, which is its top
// 24 bits below the threshold; otherwise the table holds the thresholds and
// the top 24 bits are compared. A lane owns a byte of a word, two Philox
// groups; a warp owns eight words of a row (an item) at a time.
template <bool INJ, bool PER, bool SHIFTED>
__device__ __forceinline__ void update_rows(const uint32_t* other, uint32_t* mine,
                                            const int* __restrict__ u, const Tile& g, bool red,
                                            uint32_t k0, uint32_t k1, int first, int step,
                                            int count) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int jl = lane >> 2, n = lane & 3, sh = 8 * n;
  const int nchunk = (g.nw + 7) >> 3;
  const int last = g.C2 - 1;
  const uint32_t tail = (g.C2 & 31) ? (1u << (g.C2 & 31)) - 1u : FULL;   // last word's columns
  // Items (row q, chunk k of eight words) in row-major order, WARPS apart.
  const int dq = WARPS / nchunk, dk = WARPS % nchunk;
  for (int q = warp / nchunk, k = warp % nchunk; q < count;) {
    const int i = first + q * step;
    const int j = 8 * k + jl;                 // tile word of this lane
    const int w = g.w0 + j;
    const int r = g.r0 + i;
    const int c0 = 32 * w + sh;
    const uint32_t* o = other + (i + 1) * g.stride + j + 1;
    const uint32_t M = o[0], U = o[-g.stride], D = o[g.stride];
    const bool left = red == ((r & 1) == 0);  // partner column c - 1, else c + 1
    uint32_t H, miss0 = 0u, miss1 = 0u;
    if (left) {
      const uint32_t P = o[-1];
      H = (M << 1) | (P >> 31);
      if (w == 0) {
        H &= ~1u;
        if (PER) H |= (P >> (last & 31)) & 1u;
        else if (n == 0) miss0 = 4u;            // column 0 is site 0 of byte 0
      }
    } else {
      const uint32_t N = o[1];
      H = (M >> 1) | (N << 31);
      if (w == g.W - 1) {
        const int p = last & 31;
        H &= ~(1u << p);
        if (PER) {
          H |= (N & 1u) << p;
        } else if (c0 <= last && last < c0 + 8) {
          const uint32_t m = 4u << (8 * ((last - c0) & 3));
          if (last - c0 < 4) miss0 = m;
          else miss1 = m;
        }
      }
    }
    if (!PER) {
      const uint32_t vert = (uint32_t)((r == 0) + (r == g.R - 1)) * 0x04040404u;
      miss0 += vert;
      miss1 += vert;
    }
    const uint32_t off[2] = {offsets(M, U, D, H, sh, miss0), offsets(M, U, D, H, sh + 4, miss1)};

    uint32_t uw[8];
    if (INJ) {
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const uint32_t x =
            (j < g.nw && c0 + t < g.C2) ? (uint32_t)u[(size_t)r * g.C2 + c0 + t] : 0u;
        uw[t] = SHIFTED ? x << 8 : x;
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 x =
            philox4x32_10(make_uint4((uint32_t)r, (uint32_t)(c0 >> 2) + h, 0u, 0u), k0, k1);
        uw[4 * h + 0] = SHIFTED ? x.x : x.x >> 8;
        uw[4 * h + 1] = SHIFTED ? x.y : x.y >> 8;
        uw[4 * h + 2] = SHIFTED ? x.z : x.z >> 8;
        uw[4 * h + 3] = SHIFTED ? x.w : x.w >> 8;
      }
    }

    uint32_t bits = 0u;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int th = table_at(__byte_perm(off[t >> 2], 0u, 0x4440u | (t & 3)));
      const bool up = SHIFTED ? uw[t] < (uint32_t)th : (int)uw[t] < th;
      bits |= (uint32_t)up << t;
    }
    bits <<= sh;
    bits |= __shfl_xor_sync(FULL, bits, 1);
    bits |= __shfl_xor_sync(FULL, bits, 2);
    if (n == 0 && j < g.nw) mine[(i + 1) * g.stride + j + 1] = w == g.W - 1 ? bits & tail : bits;
    q += dq;
    k += dk;
    if (k >= nchunk) {
      k -= nchunk;
      ++q;
    }
  }
}

template <bool INJ, bool PER>
__device__ __forceinline__ void update(bool shifted, const uint32_t* other, uint32_t* mine,
                                       const int* u, const Tile& g, bool red, uint32_t k0,
                                       uint32_t k1, int first, int step, int count) {
  if (shifted)
    update_rows<INJ, PER, true>(other, mine, u, g, red, k0, k1, first, step, count);
  else
    update_rows<INJ, PER, false>(other, mine, u, g, red, k0, k1, first, step, count);
}

// Write this block's edge rows of one colour, and with cols its edge words
// of every row, into the colour's image; then, once every thread's writes
// are done, raise the block's flag to e.
__device__ __forceinline__ void publish(const uint32_t* mine, uint32_t* img, int* flags,
                                        const Tile& g, bool cols, int e) {
  for (int x = threadIdx.x; x < 2 * g.nw; x += NT) {
    const int i = x < g.nw ? 1 : g.nr, j = x < g.nw ? x : x - g.nw;
    img[(size_t)(g.r0 + i - 1) * g.W + g.w0 + j] = mine[i * g.stride + j + 1];
  }
  if (cols) {
    for (int x = threadIdx.x; x < 2 * g.nr; x += NT) {
      const int i = (x >> 1) + 1, j = (x & 1) ? g.nw : 1;
      img[(size_t)(g.r0 + i - 1) * g.W + g.w0 + j - 1] = mine[i * g.stride + j];
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    store_release(flags + blockIdx.x, e);
  }
}

// Wait until the neighbours have published epoch e, then read the halo rows
// of one colour from its image, and its halo words from the image (tx > 1)
// or from the tile's own first and last words (whole rows).
template <bool PER>
__device__ __forceinline__ void fill_halos(uint32_t* mine, const uint32_t* img,
                                           const int* flags, const Tile& g, int e) {
  if (threadIdx.x < 4 && g.nb[threadIdx.x] >= 0)
    while (load_acquire(flags + g.nb[threadIdx.x]) < e) {
    }
  __syncthreads();
  for (int x = threadIdx.x; x < 2 * g.nw; x += NT) {
    const bool top = x < g.nw;
    const int j = top ? x : x - g.nw;
    const int rr = top ? g.r0 - 1 : g.r0 + g.nr;
    uint32_t v = 0u;
    if (PER || (rr >= 0 && rr < g.R)) v = __ldcg(img + (size_t)wrap(rr, g.R) * g.W + g.w0 + j);
    mine[(top ? 0 : g.nr + 1) * g.stride + j + 1] = v;
  }
  for (int x = threadIdx.x; x < 2 * g.nr; x += NT) {
    const int i = (x >> 1) + 1;
    const bool right = x & 1;
    uint32_t v;
    if (g.tx == 1) {
      v = mine[i * g.stride + (right ? 1 : g.nw)];
    } else {
      const int w = right ? wrap(g.w0 + g.nw, g.W) : wrap(g.w0 - 1, g.W);
      v = __ldcg(img + (size_t)(g.r0 + i - 1) * g.W + w);
    }
    mine[i * g.stride + (right ? g.nw + 1 : 0)] = v;
  }
  __syncthreads();
}

template <typename T, bool INJ, bool PER>
__global__ void __launch_bounds__(NT) resident_kernel(
    T* red, T* black, const int* __restrict__ tables, int table_stride,
    const int* __restrict__ uniforms, int n_sweeps, int R, int C2, uint32_t k0, int ty, int tx,
    int band_rows, int stride, uint32_t* img, int* flags) {
  Tile g;
  g.R = R;
  g.C2 = C2;
  g.W = (C2 + 31) >> 5;
  g.stride = stride;
  g.ty = ty;
  g.tx = tx;
  const int by = blockIdx.x / tx, bx = blockIdx.x % tx;
  g.r0 = (int)((long long)by * R / ty);
  g.nr = (int)((long long)(by + 1) * R / ty) - g.r0;
  g.w0 = (int)((long long)bx * g.W / tx);
  g.nw = (int)((long long)(bx + 1) * g.W / tx) - g.w0;
  g.nb[0] = by > 0 ? (by - 1) * tx + bx : (PER ? (ty - 1) * tx + bx : -1);
  g.nb[1] = by < ty - 1 ? (by + 1) * tx + bx : (PER ? bx : -1);
  g.nb[2] = tx > 1 ? by * tx + wrap(bx - 1, tx) : -1;
  g.nb[3] = tx > 1 ? by * tx + wrap(bx + 1, tx) : -1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile_words = (band_rows + 2) * stride;
  uint32_t* const tiles = block_smem + TABLE_WORDS;   // red tile, then black tile
  int* const st = reinterpret_cast<int*>(block_smem);
  const size_t plane = (size_t)R * C2;

  // Black's tile and its halos, straight from the input plane.
  for (int x = warp; x < (g.nr + 2) * (g.nw + 2); x += WARPS) {
    const int i = x / (g.nw + 2), s = x % (g.nw + 2);
    const int r = g.r0 - 1 + i;
    uint32_t v = 0u;
    if (PER || (r >= 0 && r < R))
      v = pack_word(black, wrap(r, R), wrap(g.w0 - 1 + s, g.W), C2, lane);
    if (lane == 0) tiles[tile_words + i * stride + s] = v;
  }

  const int edge_rows = g.nr < 2 ? g.nr : 2;
  for (int s = 0; s < n_sweeps; ++s) {
    // Every thread has passed the previous sweep's last half-step, which
    // ended in a barrier, so none still reads st.
    const int th = threadIdx.x < 9 ? tables[(size_t)s * table_stride + threadIdx.x] : 0;
    const bool shifted = !__syncthreads_or(threadIdx.x < 9 && th >= (1 << 24));
    if (threadIdx.x < 9) st[threadIdx.x] = shifted ? (th > 0 ? (int)((uint32_t)th << 8) : 0) : th;
    __syncthreads();
    for (int color = 0; color < 2; ++color) {
      const uint32_t* other = tiles + (color == 0 ? tile_words : 0);
      uint32_t* mine = tiles + (color == 0 ? 0 : tile_words);
      uint32_t* im = img + (size_t)color * R * g.W;
      const int* u = INJ ? uniforms + (2 * (size_t)s + color) * plane : nullptr;
      const uint32_t k1 = 2u * (uint32_t)s + (uint32_t)color;
      const int e = 2 * s + color + 1;       // this half-step's epoch
      const bool last = s == n_sweeps - 1 && color == 1;
      // The edge rows first: with whole rows they are all the neighbours
      // need, and they go on while this block updates the rest.
      update<INJ, PER>(shifted, other, mine, u, g, color == 0, k0, k1, 0, g.nr - 1,
                       edge_rows);
      __syncthreads();
      if (!last && tx == 1) publish(mine, im, flags, g, false, e);
      update<INJ, PER>(shifted, other, mine, u, g, color == 0, k0, k1, 1, 1,
                       g.nr - edge_rows);
      __syncthreads();
      if (last) break;
      if (tx > 1) publish(mine, im, flags, g, true, e);
      fill_halos<PER>(mine, im, flags, g, e);
    }
  }

  // Both planes, once.
  for (int x = warp; x < 2 * g.nr * g.nw; x += WARPS) {
    const int p = x / (g.nr * g.nw), y = x % (g.nr * g.nw);
    const int i = y / g.nw, j = y % g.nw;
    const int c = 32 * (g.w0 + j) + lane;
    if (c < C2) {
      const uint32_t v = tiles[p * tile_words + (i + 1) * stride + j + 1];
      reinterpret_cast<typename Spin<T>::U*>(p == 0 ? red : black)[(size_t)(g.r0 + i) * C2 + c] =
          ((v >> lane) & 1u) ? Spin<T>::UP : Spin<T>::DOWN;
    }
  }
}

template <typename T, bool INJ, bool PER>
int blocks_per_sm(int smem_bytes, int* per_sm) {
  cudaError_t e = cudaFuncSetAttribute(resident_kernel<T, INJ, PER>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, resident_kernel<T, INJ, PER>, NT,
                                                      (size_t)smem_bytes);
  return (int)e;
}

// The fewest blocks per SM over the dtype's four kernels.
template <typename T>
int fewest_blocks_per_sm(int smem_bytes, int* per_sm) {
  int n[4] = {0, 0, 0, 0};
  int e = blocks_per_sm<T, false, false>(smem_bytes, &n[0]);
  if (!e) e = blocks_per_sm<T, false, true>(smem_bytes, &n[1]);
  if (!e) e = blocks_per_sm<T, true, false>(smem_bytes, &n[2]);
  if (!e) e = blocks_per_sm<T, true, true>(smem_bytes, &n[3]);
  *per_sm = n[0];
  for (int i = 1; i < 4; ++i) *per_sm = n[i] < *per_sm ? n[i] : *per_sm;
  return e;
}

template <typename T, bool INJ, bool PER>
int launch(void* red, void* black, const void* tables, int table_stride, const void* uniforms,
           int n_sweeps, int R, int C2, uint32_t k0, int ty, int tx, int band_rows, int stride,
           void* img, void* flags, cudaStream_t stream) {
  const int smem = 4 * (TABLE_WORDS + 2 * (band_rows + 2) * stride);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (int err = blocks_per_sm<T, INJ, PER>(smem, &per_sm)) return err;
  if ((long long)ty * tx > (long long)per_sm * sms) return (int)cudaErrorCooperativeLaunchTooLarge;
  T* r = (T*)red;
  T* b = (T*)black;
  const int* t = (const int*)tables;
  const int* u = (const int*)uniforms;
  uint32_t* im = (uint32_t*)img;
  int* fl = (int*)flags;
  void* args[] = {&r, &b, &t, &table_stride, &u, &n_sweeps, &R, &C2, &k0,
                  &ty, &tx, &band_rows, &stride, &im, &fl};
  // Cooperative: the card runs every block at once or refuses the launch, so
  // a block that waits for its neighbours' flags never waits for a block that
  // has not started.
  e = cudaLaunchCooperativeKernel((const void*)resident_kernel<T, INJ, PER>, dim3(ty * tx),
                                  dim3(NT), args, (size_t)smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_any(void* red, void* black, const void* tables, int table_stride,
               const void* uniforms, int n_sweeps, int R, int C2, int periodic, uint32_t k0,
               int ty, int tx, int band_rows, int stride, void* img, void* flags,
               cudaStream_t s) {
  if (uniforms)
    return periodic ? launch<T, true, true>(red, black, tables, table_stride, uniforms, n_sweeps,
                                            R, C2, k0, ty, tx, band_rows, stride, img, flags, s)
                    : launch<T, true, false>(red, black, tables, table_stride, uniforms,
                                             n_sweeps, R, C2, k0, ty, tx, band_rows, stride, img,
                                             flags, s);
  return periodic ? launch<T, false, true>(red, black, tables, table_stride, uniforms, n_sweeps,
                                           R, C2, k0, ty, tx, band_rows, stride, img, flags, s)
                  : launch<T, false, false>(red, black, tables, table_stride, uniforms, n_sweeps,
                                            R, C2, k0, ty, tx, band_rows, stride, img, flags, s);
}

}  // namespace

// The card's facts the band plan needs: SMs, the most dynamic shared memory
// a block may opt in to, and whether it takes cooperative launches. Returns a
// CUDA error code, 0 on success.
extern "C" int tsu_resident_limits(int* sms, int* smem_optin, int* coop) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(coop, cudaDevAttrCooperativeLaunch, dev);
  return (int)e;
}

// Blocks of the kernel the card keeps resident per SM at smem_bytes of
// dynamic shared memory a block: the fewest over the dtype's kernels (Philox
// or injected, periodic or open). Returns a CUDA error code, 0 on success.
extern "C" int tsu_resident_occupancy(int smem_bytes, int is_bf16, int* per_sm) {
  return is_bf16 ? fewest_blocks_per_sm<__nv_bfloat16>(smem_bytes, per_sm)
                 : fewest_blocks_per_sm<float>(smem_bytes, per_sm);
}

// n_sweeps full sweeps in place on `stream`, in one cooperative launch of
// ty * tx blocks: ty bands of rows by tx ranges of words, each tile at most
// band_rows rows, its rows `stride` words apart in shared memory (the plan of
// resident_plan). red and black are (R, C2) planes of float32 (is_bf16 == 0)
// or bfloat16; black is read, both are written, red is not read. tables
// holds 9 int32 thresholds per sweep, sweep s's at s * table_stride (0: one
// table for every sweep); uniforms is null or (n_sweeps, 2, R, C2) int32 in
// [0, 2^24); img is scratch of 2 * R * ceil(C2 / 32) words, flags ty * tx
// int32 zeros. R is even, C2 >= 1. k0 is fold_seed(seed). Returns a CUDA
// error code, 0 on success (also for n_sweeps < 1, which launches nothing).
extern "C" int tsu_resident_run(void* red, void* black, const void* tables, int table_stride,
                                const void* uniforms, int n_sweeps, int R, int C2, int periodic,
                                unsigned int k0, int is_bf16, int ty, int tx, int band_rows,
                                int stride, void* img, void* flags, void* stream) {
  if (n_sweeps < 1) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_any<__nv_bfloat16>(red, black, tables, table_stride, uniforms, n_sweeps, R, C2,
                                     periodic, k0, ty, tx, band_rows, stride, img, flags, s);
  return launch_any<float>(red, black, tables, table_stride, uniforms, n_sweeps, R, C2, periodic,
                           k0, ty, tx, band_rows, stride, img, flags, s);
}
