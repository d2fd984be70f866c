// B3: the fused passes of a Beneš / barrel-shifter permutation network.
//
// Replaces the TPU kernels of flow_updating_tpu/ops/pallas_fused.py:
// _local_pass, _window_pass, _wide_pass and _wide2_pass.  One launch is
// one pass of a FusedPlan (ops/fused_passes.py): it reads the network
// array x (batch rows of P raw words, 4 or 8 bytes) once and writes the
// permuted copy to out (never in place: a pass reads the pre-pass values
// of the neighbouring tile).  The array is cut into tiles of `tile`
// elements (a power of two; the planner's block_rows * 128, or P when
// that is smaller):
//
//  * local  — up to 32 butterflies x[p] <- x[p ^ d], d < tile, bit j of
//             the int32 mask word at p selecting stage j;
//  * window — up to 32 rolls x[q] <- x[q - d] on the window [prev; own]
//             of 2*tile elements, circular inside the window (the TPU
//             kernel's roll semantics), prev = tile max(i - 1, 0), so
//             tile 0's window repeats tile 0 exactly as the TPU grid
//             does; only the own half is written;
//  * wide   — one stage whose partner tile is i ^ D (swap) or
//             max(i - D, 0) (roll): out = m ? x[partner] : x;
//  * wide2  — two merged wide stages: stage 1's result is rebuilt at the
//             own tile and at the D2 partner (whose stage-1 mask bit is a
//             second mask read), then stage 2 selects between them.
//
// What bounds it on an H100: bytes.  Every pass moves x in and out once
// plus its mask plane (4 bytes per element for local/window, 1 for wide),
// and does no arithmetic.  Offsets are 64-bit: batch * P passes 2^31 at
// the k=160 network with a batch.
//
//  * local (butterfly_pass).  Staging the tile in shared memory and
//    paying a round trip and two barriers per stage made it an
//    instruction- and barrier-bound kernel at 9x its byte bound.  Here
//    the 12 bits of a tile index get roles: 4 register bits (16 words
//    per thread), 5 lane bits and the rest warp bits (fewer lanes and no
//    warp bits below a 1,024-element tile).  A stage on a register bit is
//    a select between two of a thread's registers, a stage on a lane bit
//    one __shfl_xor_sync and a select.  The host schedule
//    (ops/fused_passes.py, plan_local_schedule) cuts the stage list into
//    segments whose bits are register or lane bits of one layout; between
//    two layouts the words pass once through shared memory (one barrier,
//    two alternating buffers).  The k=160 list 2048..1..2048 runs as
//    bits 11..3 | 2..0..8 | 9..11: two re-layouts, where the old kernel
//    made 22 round trips.  Every layout's lane bits are 5 consecutive
//    position bits, so the XOR swizzle below keeps each warp's
//    shared-memory accesses free of bank conflicts; the tile comes in
//    through a swizzled staging buffer in the first segment's layout and
//    goes out from registers in a coalesced one.  The mask tile is read
//    once per tile and serves every batch row; each segment reads its
//    positions' mask words from shared memory, since a mask bit belongs
//    to the destination position.  What is left bounds it by
//    instructions (a bit test and a select per word and stage, plus the
//    shuffles), so the blocks are persistent and copy the next (tile,
//    row) in with cp.async while they compute the current one.
//  * window (staged_pass<T, true>) stages its window of 2*tile elements
//    in shared memory and keeps each thread's mask words and current
//    values in registers: one trip through HBM and two __syncthreads()
//    per stage.  The template still carries the former local branch;
//    only the window instantiation is launched.
//  * wide, wide2 are coalesced elementwise kernels that read only the
//    one source word each mask selects.
//
// Plain C interface, loaded with ctypes (flow_updating_tpu_torch/kernels).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxStages = 32;
constexpr int kThreads = 512;
constexpr int kMaxPer = 16;                      // window words per thread
constexpr long long kMaxTile = kThreads * kMaxPer / 2;   // 4096 elements
constexpr int kWideThreads = 256;

struct Dists {
  int d[kMaxStages];
};

enum Kind {
  kLocal = 0,
  kWindow = 1,
  kWideSwap = 2,
  kWideRoll = 3,
  kWideSwap2 = 4,
  kWideRoll2 = 5,
};

template <typename T, bool kIsWindow>
__global__ void __launch_bounds__(kThreads)
staged_pass(const T* __restrict__ x, T* __restrict__ out,
            const unsigned* __restrict__ mask, long long P, int tile,
            int n_stages, Dists ds) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int elems = kIsWindow ? 2 * tile : tile;
  const int wrap = elems - 1;  // elems is a power of two
  const long long blk = blockIdx.x;
  const long long prev = blk > 0 ? blk - 1 : 0;
  const T* xb = x + (long long)blockIdx.y * P;
  T v[kMaxPer];
  unsigned m[kMaxPer];
#pragma unroll
  for (int k = 0; k < kMaxPer; ++k) {
    const int q = threadIdx.x + k * blockDim.x;
    if (q < elems) {
      long long g;
      if (kIsWindow)
        g = q < tile ? prev * tile + q : blk * tile + (q - tile);
      else
        g = blk * tile + q;
      v[k] = xb[g];
      m[k] = mask[g];
      s[q] = v[k];
    }
  }
  __syncthreads();
  for (int j = 0; j < n_stages; ++j) {
    const int d = ds.d[j];
#pragma unroll
    for (int k = 0; k < kMaxPer; ++k) {
      const int q = threadIdx.x + k * blockDim.x;
      if (q < elems && ((m[k] >> j) & 1u))
        v[k] = kIsWindow ? s[(q - d) & wrap] : s[q ^ d];
    }
    if (j + 1 < n_stages) {
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kMaxPer; ++k) {
        const int q = threadIdx.x + k * blockDim.x;
        if (q < elems) s[q] = v[k];
      }
      __syncthreads();
    }
  }
  T* ob = out + (long long)blockIdx.y * P + blk * tile;
#pragma unroll
  for (int k = 0; k < kMaxPer; ++k) {
    const int q = threadIdx.x + k * blockDim.x;
    if (kIsWindow) {
      if (q >= tile && q < elems) ob[q - tile] = v[k];
    } else if (q < elems) {
      ob[q] = v[k];
    }
  }
}

// ---- local: butterfly_pass -------------------------------------------------

constexpr int kRegBits = 4;                      // 16 words per thread
constexpr int kLaneBits = 5;
constexpr int kLayouts = kMaxStages + 2;
// a layout's per-warp and per-lane columns in shared memory
constexpr int kBaseStride = kThreads / 32 + 32;

struct LocalSched {
  int n;                      // log2 of the tile
  int n_seg;                  // segments, in stage order
  int seg_end[kMaxStages];    // first stage after segment s
  int slot[kMaxStages];       // slot bit each stage runs on
  // layout 0 loads, layout s + 1 runs segment s, layout n_seg + 1 stores;
  // change[s]: layout s differs from layout s - 1
  int change[kLayouts];
  // per layout and slot bit: the byte offset of the swizzled word of that
  // bit's position (XOR-linear, so a word's offset is the XOR of its slot
  // bits'); per slot bit of the store layout: 1 << its position bit
  int col[kLayouts][12];
  int out_col[12];
};

// Shared-memory word index of tile position p: the low 5 bits are XORed
// with every higher 5-bit group, so position bit b lands in bank b mod 5.
// Lanes that differ in 5 consecutive position bits hit 32 distinct banks.
// 8-byte words are kept as two such 4-byte planes.
__host__ __device__ __forceinline__ int swizzle(int p) {
  return p ^ (((p >> 5) ^ (p >> 10)) & 31);
}

template <int Bytes>
__device__ __forceinline__ void cp_async(void* smem, const void* global) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(smem)),
               "l"(global), "n"(Bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// waits for this thread's copies; a barrier then makes every thread's
// copies visible to the block
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A word at byte offset `at` of a swizzled tile: 8-byte words as a low
// and a high 4-byte plane, `tile` words apart.
__device__ __forceinline__ unsigned& word_at(unsigned* s, int at) {
  return *reinterpret_cast<unsigned*>(reinterpret_cast<char*>(s) + at);
}
template <typename W> struct Words;
template <> struct Words<unsigned> {
  __device__ static void put(unsigned* s, int at, int, unsigned v) {
    word_at(s, at) = v;
  }
  __device__ static unsigned get(unsigned* s, int at, int) {
    return word_at(s, at);
  }
};
template <> struct Words<unsigned long long> {
  __device__ static void put(unsigned* s, int at, int tile,
                             unsigned long long v) {
    word_at(s, at) = (unsigned)v;
    word_at(s + tile, at) = (unsigned)(v >> 32);
  }
  __device__ static unsigned long long get(unsigned* s, int at, int tile) {
    return word_at(s, at) | ((unsigned long long)word_at(s + tile, at) << 32);
  }
};

// XOR-linear addresses of this thread's 2^R words, from one row of
// columns (`col`, one per slot bit): the thread's part (per warp and per
// lane, from row `row` of the shared-memory table) XOR register k's part.
// Shared-memory byte offsets for a layout, positions for the store.
template <int R>
struct Addresses {
  int a[1 << R];
  __device__ Addresses(const int* bases, int row, const int* col) {
    const int t = bases[row * kBaseStride + threadIdx.x / 32] ^
                  bases[row * kBaseStride + kThreads / 32 + threadIdx.x % 32];
    const int c0 = col[0];
    const int c1 = R > 1 ? col[1] : 0;
    const int c2 = R > 2 ? col[2] : 0;
    const int c3 = R > 3 ? col[3] : 0;
#pragma unroll
    for (int k = 0; k < (1 << R); ++k)
      a[k] = t ^ ((k & 1) ? c0 : 0) ^ ((k & 2) ? c1 : 0) ^
             ((k & 4) ? c2 : 0) ^ ((k & 8) ? c3 : 0);
  }
};


// a stage on register bit log2(M): words k and k | M are partners
template <int M, int N, typename W>
__device__ __forceinline__ void register_stage(W (&v)[N],
                                               const unsigned (&m)[N],
                                               unsigned bit) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (k & M) continue;
    const W a = v[k], b = v[k | M];
    v[k] = (m[k] & bit) ? b : a;
    v[k | M] = (m[k | M] & bit) ? a : b;
  }
}

// Copies row b of this block's tile number seq (tile blockIdx.x + seq *
// gridDim.x) to staging tile `buf` (swizzled 4-byte planes, so that any
// layout reads it without bank conflicts), and with row 0 the tile's
// mask words.
template <typename W, int R>
__device__ __forceinline__ void prefetch(const W* x, const unsigned* mask,
                                         long long P, int tile, long long seq,
                                         long long b, int buf,
                                         unsigned* stage, unsigned* msk) {
  constexpr int kPlanes = sizeof(W) / sizeof(unsigned);
  const long long t = (blockIdx.x + seq * gridDim.x) * (long long)tile;
  // position q = threadIdx.x | k * blockDim.x (disjoint bits), so
  // swizzle(q) = swizzle(threadIdx.x) ^ swizzle(k * blockDim.x)
  const int sw = swizzle(threadIdx.x);
  unsigned* st = stage + buf * kPlanes * tile;
  const unsigned* xg =
      reinterpret_cast<const unsigned*>(x + b * P + t + threadIdx.x);
#pragma unroll
  for (int k = 0; k < (1 << R); ++k) {
    const int at = sw ^ swizzle(k * blockDim.x);
#pragma unroll
    for (int h = 0; h < kPlanes; ++h)
      cp_async<4>(st + h * tile + at, xg + kPlanes * k * blockDim.x + h);
  }
  if (b == 0) {
    unsigned* ms = msk + (seq & 1) * tile;
    const unsigned* mg = mask + t + threadIdx.x;
#pragma unroll
    for (int k = 0; k < (1 << R); ++k)
      cp_async<4>(ms + (sw ^ swizzle(k * blockDim.x)), mg + k * blockDim.x);
  }
  cp_async_commit();
}

// Persistent: block j runs the tiles j, j + grid, ... each for every
// batch row, while the next (tile, row) is copied in.  Shared memory:
// two staging, two mask and two exchange tiles (all swizzled, words as
// 4-byte planes), the layouts' thread columns.  lanes: the warp's
// active lanes (fewer than 32 below a 512-element tile).
template <typename W, int R>
__global__ void __launch_bounds__(kThreads)
butterfly_pass(const W* __restrict__ x, W* __restrict__ out,
               const unsigned* __restrict__ mask, long long P,
               long long batch, unsigned lanes, LocalSched sc) {
  constexpr int kPer = 1 << R;
  constexpr int kPlanes = sizeof(W) / sizeof(unsigned);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = sc.n, tile = 1 << n;
  const int l = n - R < kLaneBits ? n - R : kLaneBits;
  unsigned* stage = reinterpret_cast<unsigned*>(smem_raw);
  unsigned* msk = stage + 2 * kPlanes * tile;
  unsigned* xch = msk + 2 * tile;
  int* bases = reinterpret_cast<int*>(xch + 2 * kPlanes * tile);
  // this block's tiles: blockIdx.x, + gridDim.x, ... below P / tile
  const long long n_seq = ((P >> n) - 1 - blockIdx.x) / gridDim.x + 1;
  prefetch<W, R>(x, mask, P, tile, 0, 0, 0, stage, msk);
  // every warp's and lane's part of each layout's offsets (rows 0 ..
  // n_seg + 1) and of the store layout's positions (row n_seg + 2)
  const int out_row = sc.n_seg + 2;
  for (int e = threadIdx.x; e < (out_row + 1) * kBaseStride;
       e += blockDim.x) {
    const int s = e / kBaseStride, u = e % kBaseStride;
    const int* col = s == out_row ? sc.out_col : sc.col[s];
    const bool warp = u < kThreads / 32;
    const int id = warp ? u : u - kThreads / 32;
    const int lo = warp ? R + l : R, hi = warp ? n : R + l;
    int acc = 0;
    for (int i = lo; i < hi; ++i)
      if ((id >> (i - lo)) & 1) acc ^= col[i];
    bases[e] = acc;
  }
  int parity = 0, buf = 0;
  for (long long seq = 0, b = 0; seq < n_seq; buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();
    // the next item: the next row, or the next tile's row 0
    const long long next_b = b + 1 < batch ? b + 1 : 0;
    const long long next_seq = next_b ? seq : seq + 1;
    if (next_seq < n_seq)
      prefetch<W, R>(x, mask, P, tile, next_seq, next_b, buf ^ 1, stage,
                     msk);
    unsigned* ms = msk + (seq & 1) * tile;
    unsigned* st = stage + buf * kPlanes * tile;
    Addresses<R> at(bases, 0, sc.col[0]);
    W v[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) v[k] = Words<W>::get(st, at.a[k], tile);
    for (int s = 0; s <= sc.n_seg; ++s) {
      if (sc.change[s + 1]) {
        // re-layout; the two buffers alternate, so the exchange before
        // the last one finished reading this buffer before the last
        // one's barrier, and one barrier per exchange suffices
        unsigned* xb = xch + parity * kPlanes * tile;
        parity ^= 1;
#pragma unroll
        for (int k = 0; k < kPer; ++k) Words<W>::put(xb, at.a[k], tile, v[k]);
        __syncthreads();
        at = Addresses<R>(bases, s + 1, sc.col[s + 1]);
#pragma unroll
        for (int k = 0; k < kPer; ++k) v[k] = Words<W>::get(xb, at.a[k], tile);
      }
      if (s == sc.n_seg) break;
      unsigned m[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) m[k] = word_at(ms, at.a[k]);
      for (int j = s ? sc.seg_end[s - 1] : 0; j < sc.seg_end[s]; ++j) {
        const unsigned bit = 1u << j;
        const int i_slot = sc.slot[j];
        if (i_slot == 0) {
          register_stage<1>(v, m, bit);
        } else if (R > 1 && i_slot == 1) {
          register_stage<(R > 1 ? 2 : 1)>(v, m, bit);
        } else if (R > 2 && i_slot == 2) {
          register_stage<(R > 2 ? 4 : 1)>(v, m, bit);
        } else if (R > 3 && i_slot == 3) {
          register_stage<(R > 3 ? 8 : 1)>(v, m, bit);
        } else {
          const int lane_mask = 1 << (i_slot - R);
#pragma unroll
          for (int k = 0; k < kPer; ++k) {
            const W o = __shfl_xor_sync(lanes, v[k], lane_mask);
            if (m[k] & bit) v[k] = o;
          }
        }
      }
    }
    W* og = out + b * P + (blockIdx.x + seq * gridDim.x) * (long long)tile;
    const Addresses<R> to(bases, out_row, sc.out_col);
#pragma unroll
    for (int k = 0; k < kPer; ++k) og[to.a[k]] = v[k];
    seq = next_seq;
    b = next_b;
  }
}

// Parses and checks the host schedule: every layout a permutation of the
// tile's n position bits, every stage on a register or lane bit whose
// position is log2 of its distance.  Returns false on anything else.
bool parse_schedule(const int* in, int n, int n_stages, const int* dists,
                    LocalSched* sc) {
  const int r = n < kRegBits ? n : kRegBits;
  const int l = n - r < kLaneBits ? n - r : kLaneBits;
  sc->n = n;
  sc->n_seg = in[0];
  if (sc->n_seg < 1 || sc->n_seg > n_stages) return false;
  int pos[kLayouts][12];
  for (int s = 0; s < sc->n_seg + 2; ++s) {
    int seen = 0;
    sc->change[s] = 0;
    for (int i = 0; i < n; ++i) {
      const int b = in[1 + 2 * kMaxStages + 12 * s + i];
      if (b < 0 || b >= n || (seen >> b) & 1) return false;
      seen |= 1 << b;
      pos[s][i] = b;
      sc->col[s][i] = swizzle(1 << b) * (int)sizeof(unsigned);
      if (s == sc->n_seg + 1) sc->out_col[i] = 1 << b;
      if (s > 0 && b != pos[s - 1][i]) sc->change[s] = 1;
    }
  }
  int j = 0;
  for (int s = 0; s < sc->n_seg; ++s) {
    const int end = in[1 + s];
    if (end <= j || end > n_stages) return false;
    sc->seg_end[s] = end;
    for (; j < end; ++j) {
      const int i = in[1 + kMaxStages + j];
      if (i < 0 || i >= r + l || (1 << pos[s + 1][i]) != dists[j])
        return false;
      sc->slot[j] = i;
    }
  }
  return j == n_stages;
}

template <typename W, int R>
int launch_butterfly_r(const void* x, void* out, const void* mask,
                       long long P, long long batch, int tile,
                       const LocalSched& sc, cudaStream_t stream) {
  // staging, mask and exchange tiles, two of each
  const size_t tiles_bytes = 2 * (2 * sizeof(W) + sizeof(unsigned));
  const size_t smem = (size_t)tile * tiles_bytes +
                      (size_t)(sc.n_seg + 3) * kBaseStride * sizeof(int);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        butterfly_pass<W, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(kMaxTile * tiles_bytes +
              (kLayouts + 1) * kBaseStride * sizeof(int)));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  // persistent: as many blocks as fit on the card, at most one a tile
  const int threads = tile >> R;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, butterfly_pass<W, R>, threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long tiles = P / tile;
  const long long grid =
      tiles < (long long)sms * per_sm ? tiles : (long long)sms * per_sm;
  const unsigned lanes = threads < 32 ? (1u << threads) - 1 : 0xffffffffu;
  butterfly_pass<W, R><<<(unsigned)grid, threads, smem, stream>>>(
      static_cast<const W*>(x), static_cast<W*>(out),
      static_cast<const unsigned*>(mask), P, batch, lanes, sc);
  return (int)cudaGetLastError();
}

template <typename W>
int launch_butterfly(const void* x, void* out, const void* mask, long long P,
                     long long batch, int tile, const LocalSched& sc,
                     cudaStream_t stream) {
  if (sc.n == 1)
    return launch_butterfly_r<W, 1>(x, out, mask, P, batch, tile, sc, stream);
  if (sc.n == 2)
    return launch_butterfly_r<W, 2>(x, out, mask, P, batch, tile, sc, stream);
  if (sc.n == 3)
    return launch_butterfly_r<W, 3>(x, out, mask, P, batch, tile, sc, stream);
  return launch_butterfly_r<W, 4>(x, out, mask, P, batch, tile, sc, stream);
}

// ---- wide, wide2 -----------------------------------------------------------

__device__ __forceinline__ long long partner(long long i, long long D,
                                             bool swap) {
  return swap ? (i ^ D) : (i >= D ? i - D : 0);
}

template <typename T, bool kSwap>
__global__ void wide_pass(const T* __restrict__ x, T* __restrict__ out,
                          const signed char* __restrict__ mask, long long P,
                          int shift, long long D) {
  const T* xb = x + (long long)blockIdx.y * P;
  T* ob = out + (long long)blockIdx.y * P;
  const long long tmask = (1LL << shift) - 1;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < P; p += (long long)gridDim.x * blockDim.x) {
    long long src = p;
    if (mask[p] != 0)
      src = (partner(p >> shift, D, kSwap) << shift) | (p & tmask);
    ob[p] = xb[src];
  }
}

template <typename T, bool kSwap>
__global__ void wide2_pass(const T* __restrict__ x, T* __restrict__ out,
                           const signed char* __restrict__ mask, long long P,
                           int shift, long long D1, long long D2) {
  const T* xb = x + (long long)blockIdx.y * P;
  T* ob = out + (long long)blockIdx.y * P;
  const long long tmask = (1LL << shift) - 1;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < P; p += (long long)gridDim.x * blockDim.x) {
    const long long i = p >> shift, t = p & tmask;
    const signed char m = mask[p];
    long long blk;
    if (m & 2) {
      // stage 2 takes stage 1's result at the D2 partner tile, whose own
      // stage-1 bit decides between x there and x one more D1 away
      const long long at2 = partner(i, D2, kSwap);
      const bool m1_shift = (mask[(at2 << shift) | t] & 1) != 0;
      blk = m1_shift ? (kSwap ? (i ^ D1 ^ D2) : partner(i, D1 + D2, false))
                     : at2;
    } else {
      blk = (m & 1) ? partner(i, D1, kSwap) : i;
    }
    ob[p] = xb[(blk << shift) | t];
  }
}

template <typename T, bool kIsWindow>
int launch_staged(const void* x, void* out, const void* mask, long long P,
                  long long batch, int tile, int n_stages, const Dists& ds,
                  cudaStream_t stream) {
  const int elems = kIsWindow ? 2 * tile : tile;
  const size_t smem = (size_t)elems * sizeof(T);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        staged_pass<T, kIsWindow>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(kMaxTile * 2 * sizeof(T)));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int threads = elems >= kThreads ? kThreads : ((elems + 31) / 32) * 32;
  dim3 grid((unsigned)(P / tile), (unsigned)batch);
  staged_pass<T, kIsWindow><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out),
      static_cast<const unsigned*>(mask), P, tile, n_stages, ds);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(int kind, const void* x, void* out, const void* mask, long long P,
           long long batch, int tile, int shift, int n_stages,
           const Dists& ds, const LocalSched& sc, long long d1, long long d2,
           cudaStream_t stream) {
  if (kind == kLocal)
    return launch_butterfly<T>(x, out, mask, P, batch, tile, sc, stream);
  if (kind == kWindow)
    return launch_staged<T, true>(x, out, mask, P, batch, tile, n_stages, ds,
                                  stream);
  long long blocks = (P + kWideThreads - 1) / kWideThreads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  dim3 grid((unsigned)blocks, (unsigned)batch);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  const signed char* mt = static_cast<const signed char*>(mask);
  switch (kind) {
    case kWideSwap:
      wide_pass<T, true><<<grid, kWideThreads, 0, stream>>>(xt, ot, mt, P,
                                                            shift, d1);
      break;
    case kWideRoll:
      wide_pass<T, false><<<grid, kWideThreads, 0, stream>>>(xt, ot, mt, P,
                                                             shift, d1);
      break;
    case kWideSwap2:
      wide2_pass<T, true><<<grid, kWideThreads, 0, stream>>>(xt, ot, mt, P,
                                                             shift, d1, d2);
      break;
    case kWideRoll2:
      wide2_pass<T, false><<<grid, kWideThreads, 0, stream>>>(xt, ot, mt, P,
                                                              shift, d1, d2);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// kind: 0 local, 1 window, 2 wide_swap, 3 wide_roll, 4 wide_swap2,
// 5 wide_roll2.  elem_bytes: 4 or 8 (the words are moved, never read as
// numbers).  x, out: batch * P words; mask: P int32 words (local, window)
// or P int8 (wide).  dists: host array of n_stages element distances
// (local, window); d1, d2: block distances (wide).  sched (local only):
// host array of kSchedInts ints from plan_local_schedule — the segment
// count, 32 segment ends, 32 stage slot bits, then 34 layouts of 12
// position bits each (load, one per segment, store).  Returns the
// cudaError_t of the launch.
extern "C" int benes_pass(int kind, int elem_bytes, const void* x, void* out,
                          const void* mask, long long P, long long batch,
                          long long tile, int n_stages, const int* dists,
                          long long d1, long long d2, const int* sched,
                          void* stream) {
  if (P <= 0 || batch <= 0 || batch > 65535 || tile <= 0 ||
      (tile & (tile - 1)) || P % tile || tile > kMaxTile ||
      n_stages < 0 || n_stages > kMaxStages)
    return (int)cudaErrorInvalidValue;
  Dists ds = {};
  const int limit = kind == kWindow ? (int)(2 * tile) : (int)tile;
  for (int j = 0; j < n_stages; ++j) {
    if (dists[j] <= 0 || dists[j] >= limit) return (int)cudaErrorInvalidValue;
    ds.d[j] = dists[j];
  }
  int shift = 0;
  while ((1LL << shift) < tile) ++shift;
  LocalSched sc = {};
  if (kind == kLocal &&
      (tile < 2 || sched == nullptr ||
       !parse_schedule(sched, shift, n_stages, dists, &sc)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4)
    return launch<unsigned>(kind, x, out, mask, P, batch, (int)tile, shift,
                            n_stages, ds, sc, d1, d2, s);
  if (elem_bytes == 8)
    return launch<unsigned long long>(kind, x, out, mask, P, batch, (int)tile,
                                      shift, n_stages, ds, sc, d1, d2, s);
  return (int)cudaErrorInvalidValue;
}
