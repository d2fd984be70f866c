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
//  * window (window_walk_pass).  A window pass only moves data, so each
//    output has exactly one source, and the kernel finds it first: from
//    w = tile + (p mod tile), for the stages from last to first, w =
//    (w - d_j) mod 2*tile where bit j of the mask word at window position
//    w is set.  Then out[b, p] = x[b, g(w)] for every batch row b, g
//    mapping a window position to its global index.  That is the stage
//    loop read backwards, so it is exact on any mask plane and any list
//    of distances below 2*tile, tile 0 and the wrap inside the window
//    included.  Staging the window of x and running every stage over it
//    costs a trip through shared memory and two barriers per stage; here
//    the batch rows share one walk, each row costs one read of x at the
//    walks' ends (scattered inside the window, served by L2; staging each
//    row's window of x in shared memory instead measured slower, PERF.md)
//    and one coalesced write, and the mask words go to shared memory once
//    a tile: the blocks are persistent and walk consecutive tiles, so a
//    tile's words serve its own outputs and then the next tile's [prev]
//    half, and the next tile's come in by cp.async during this one's
//    walk.  (B4's fill walks the same way, seg_scan.cu.)
//  * wide and wide2.  One element a thread, with a dependent mask read
//    and a dependent source read, leaves too few bytes in flight, a
//    warp's sources fall in two (wide) or four (wide2) tiles, and each
//    source tile is read again as another tile's own.  So each thread
//    moves 16 bytes (a vector of N words; N = 1 below a 16-byte tile or
//    on unaligned pointers) of consecutive offsets, reads each x and mask
//    vector once, issues every load before it selects, and serves every
//    batch row from one mask read.  A wide pass is wide2's first stage
//    alone and runs on the same code as its one-stage instance
//    (wide_pass_swap: the pair {i, i^D}; wide_pass_roll: the chains of
//    tiles mod D, D clamped to the tile count), selecting wherever its
//    mask byte is non-zero, as the plain version does:
//    - swap kinds (wide2_swap_group): the tiles {i, i^D1, i^D2, i^D1^D2}
//      are closed under both stages, so a thread owns the same offsets
//      in all four (two when D1 == D2) and writes all of their outputs;
//    - roll kinds (wide2_roll_chain): output tile i reads tiles i, i-D1,
//      i-D2 and i-D1-D2 (clamped at tile 0), all on the chain of tiles
//      congruent to i mod g = gcd(D1, D2).  A thread walks kWide2Seg
//      steps of one chain with the last (D1 + D2)/g source vectors in
//      registers, after loading the segment's predecessors (tile 0's only
//      where a mask selects a clamped source), for D1 : D2 = 1 : 1, 1 : 2
//      or 2 : 1 (what the planners make) with g below the tile count;
//    - wide2_roll_gather, for the other rolls: one vector of outputs
//      a thread, its own and its D2 partner's mask vectors read up front,
//      then one load per element from the tile its bits select.

// Plain C interface, loaded with ctypes (flow_updating_tpu_torch/kernels).

#include <cuda_runtime.h>

#include <mutex>
#include <vector>

namespace {

constexpr int kMaxStages = 32;
constexpr int kThreads = 512;
constexpr long long kMaxTile = 4096;             // elements
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

// Persistent launches: as many blocks of `threads` as fit on the card
// with `smem` bytes of dynamic shared memory each, at most one a tile.
// The first launch of a shape on a device raises the kernel's
// shared-memory limit to `max_smem` and queries the SM count and the
// blocks per SM; later ones read them from this cache, so a launch makes
// no device query.  Kernels, tiles and schedules are few, so the cache
// stays small.
struct GridShape {
  int dev;
  const void* kernel;
  int threads;
  size_t smem;
  long long blocks;  // resident blocks on the card
};

int persistent_grid(const void* kernel, int threads, size_t smem,
                    size_t max_smem, long long tiles, unsigned* grid) {
  static std::mutex lock;
  static std::vector<GridShape> cache;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  long long blocks = 0;
  {
    std::lock_guard<std::mutex> hold(lock);
    for (const GridShape& c : cache)
      if (c.dev == dev && c.kernel == kernel && c.threads == threads &&
          c.smem == smem)
        blocks = c.blocks;
    if (blocks == 0) {
      int sms = 0, per_sm = 0;
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)max_smem);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                            threads, smem);
      if (err != cudaSuccess) return (int)err;
      if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
      blocks = (long long)sms * per_sm;
      cache.push_back({dev, kernel, threads, smem, blocks});
    }
  }
  *grid = (unsigned)(tiles < blocks ? tiles : blocks);
  return 0;
}

template <typename W, int R>
int launch_butterfly_r(const void* x, void* out, const void* mask,
                       long long P, long long batch, int tile,
                       const LocalSched& sc, cudaStream_t stream) {
  // staging, mask and exchange tiles, two of each
  const size_t tiles_bytes = 2 * (2 * sizeof(W) + sizeof(unsigned));
  const size_t smem = (size_t)tile * tiles_bytes +
                      (size_t)(sc.n_seg + 3) * kBaseStride * sizeof(int);
  const int threads = tile >> R;
  unsigned grid = 0;
  if (int err = persistent_grid(
          reinterpret_cast<const void*>(butterfly_pass<W, R>), threads, smem,
          kMaxTile * tiles_bytes + (kLayouts + 1) * kBaseStride * sizeof(int),
          P / tile, &grid))
    return err;
  const unsigned lanes = threads < 32 ? (1u << threads) - 1 : 0xffffffffu;
  butterfly_pass<W, R><<<grid, threads, smem, stream>>>(
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

// ---- window: window_walk_pass ---------------------------------------------

constexpr int kWalkThreads = 256;
constexpr int kWalkMinBlocks = 2;   // resident blocks per SM (register cap)
constexpr int kWalkPer = 16;        // outputs per thread: a 4,096-word tile
constexpr int kRing = 4;            // mask tiles in shared memory

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// Copies mask tile t (tile words) to `to`: 16-byte copies where the tile
// and the plane allow (vec16), else 4-byte ones.
__device__ __forceinline__ void fetch_tile(unsigned* to,
                                           const unsigned* mask, long long t,
                                           int tile, bool vec16) {
  const unsigned* from = mask + t * tile;
  if (vec16) {
    for (int q = 4 * threadIdx.x; q < tile; q += 4 * blockDim.x)
      cp_async<16>(to + q, from + q);
  } else {
    for (int q = threadIdx.x; q < tile; q += blockDim.x)
      cp_async<4>(to + q, from + q);
  }
}

// Persistent: block j walks the tiles [t0, t1) of an even split, in
// order, one output per thread and e (per <= kWalkPer).  The mask tiles
// sit in a ring of kRing tiles in shared memory, tile t0 + k in slot k
// mod kRing, so tile i's window [prev; own] is contiguous there (mod the
// ring): slot k - 1 holds tile i - 1 (tile 0 again when i = 0), which
// tile i - 1's walk used as its own half.  cp.async copies tiles i + 1
// and i + 2 in while tile i is walked and gathered; the gather reads x
// from device memory (L2 serves the window).  kWrap: a walk may wrap
// inside the window (sum(d) >= tile), so it runs in window positions mod
// 2 * tile; else in ring positions, where it stays inside the window and
// a move costs two fewer integer operations (measured faster on every
// float32 window pass of the k=160 plan, PERF.md).
template <typename W, bool kWrap>
__global__ void __launch_bounds__(kWalkThreads, kWalkMinBlocks)
window_walk_pass(const W* __restrict__ x, W* __restrict__ out,
                 const unsigned* __restrict__ mask, long long P,
                 long long batch, int log2_tile, int per, int n_stages,
                 Dists ds, bool vec16) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int sdist[kMaxStages];
  if (threadIdx.x == 0) {
    // constant indices: a runtime index into the parameter would make
    // every thread copy it to local memory
#pragma unroll
    for (int j = 0; j < kMaxStages; ++j) sdist[j] = ds.d[j];
  }
  const int tile = 1 << log2_tile;
  const int ring = kRing * tile - 1;  // ring positions mod kRing * tile
  const long long tiles = P >> log2_tile;
  const long long t0 = tiles * blockIdx.x / gridDim.x;
  const long long t1 = tiles * (blockIdx.x + 1) / gridDim.x;
  unsigned* sm = reinterpret_cast<unsigned*>(smem_raw);
  auto slot = [&](long long k) { return sm + (int)(k % kRing) * tile; };
  // group 0: tile t0 and the one before it; group 1: tile t0 + 1
  fetch_tile(slot(kRing - 1), mask, t0 > 0 ? t0 - 1 : 0, tile, vec16);
  fetch_tile(slot(0), mask, t0, tile, vec16);
  cp_async_commit();
  if (t0 + 1 < t1) fetch_tile(slot(1), mask, t0 + 1, tile, vec16);
  cp_async_commit();
  for (long long i = t0, k = 0; i < t1; ++i, ++k) {
    // slot k + 2 held tile i - 2, whose last reader (tile i - 1's walk)
    // passed the barrier after it
    if (i + 2 < t1) fetch_tile(slot(k + 2), mask, i + 2, tile, vec16);
    cp_async_commit();
    cp_async_wait<2>();  // tile i's group, and every one before it
    __syncthreads();
    // ring position of window position 0 (the prev half's first word)
    const int base = (int)((k + kRing - 1) % kRing) * tile;
    // each walk holds the mask word of its position and reads the next
    // one only where it moves (fewer shared-memory reads, and fewer
    // lanes to collide in a bank once small distances scatter them)
    int w[kWalkPer];  // kWrap: window position; else ring position
    unsigned word[kWalkPer];
#pragma unroll
    for (int e = 0; e < kWalkPer; ++e) {
      const int q = tile + threadIdx.x + e * blockDim.x;
      w[e] = kWrap ? q : (base + q) & ring;
      word[e] = e < per ? sm[(base + q) & ring] : 0u;
    }
    for (int j = n_stages - 1; j >= 0; --j) {
      const int d = sdist[j];
      const unsigned bit = 1u << j;
#pragma unroll
      for (int e = 0; e < kWalkPer; ++e) {
        if (!(word[e] & bit)) continue;
        if (kWrap) {
          w[e] = (w[e] - d) & (2 * tile - 1);
          word[e] = sm[(base + w[e]) & ring];
        } else {
          w[e] = (w[e] - d) & ring;
          word[e] = sm[w[e]];
        }
      }
    }
    __syncthreads();  // every walk is done with slot k - 1
    // global index of window position q: (i - 1) * tile + q, or, for
    // tile 0 (whose window repeats it), q mod tile
    const long long row0 = i > 0 ? (i - 1) * tile : 0;
    const int wrap0 = i > 0 ? 2 * tile - 1 : tile - 1;
#pragma unroll
    for (int e = 0; e < kWalkPer; ++e)
      if (!kWrap) w[e] = (w[e] - base) & ring;
    for (long long b = 0; b < batch; ++b) {
      const W* xb = x + b * P;
      W* ob = out + b * P + i * tile;
      W v[kWalkPer];
#pragma unroll
      for (int e = 0; e < kWalkPer; ++e)
        if (e < per) v[e] = xb[row0 + (w[e] & wrap0)];
#pragma unroll
      for (int e = 0; e < kWalkPer; ++e)
        if (e < per) ob[threadIdx.x + e * blockDim.x] = v[e];
    }
  }
}

template <typename W, bool kWrap>
int launch_window_as(const void* x, void* out, const void* mask, long long P,
                     long long batch, int tile, int n_stages, const Dists& ds,
                     cudaStream_t stream) {
  const int threads = tile < kWalkThreads ? tile : kWalkThreads;
  const size_t smem = kRing * (size_t)tile * sizeof(unsigned);
  const size_t max_smem = kRing * (size_t)kMaxTile * sizeof(unsigned);
  unsigned grid = 0;
  if (int err = persistent_grid(
          reinterpret_cast<const void*>(window_walk_pass<W, kWrap>), threads,
          smem, max_smem, P / tile, &grid))
    return err;
  int log2_tile = 0;
  while ((1 << log2_tile) < tile) ++log2_tile;
  const bool vec16 =
      tile % 4 == 0 && reinterpret_cast<size_t>(mask) % 16 == 0;
  window_walk_pass<W, kWrap><<<grid, threads, smem, stream>>>(
      static_cast<const W*>(x), static_cast<W*>(out),
      static_cast<const unsigned*>(mask), P, batch, log2_tile,
      tile / threads, n_stages, ds, vec16);
  return (int)cudaGetLastError();
}

template <typename W>
int launch_window(const void* x, void* out, const void* mask, long long P,
                  long long batch, int tile, int n_stages, const Dists& ds,
                  cudaStream_t stream) {
  long long sum = 0;
  for (int j = 0; j < n_stages; ++j) sum += ds.d[j];
  if (sum >= tile)
    return launch_window_as<W, true>(x, out, mask, P, batch, tile, n_stages,
                                     ds, stream);
  return launch_window_as<W, false>(x, out, mask, P, batch, tile, n_stages,
                                    ds, stream);
}

// ---- wide, wide2 -----------------------------------------------------------

// A thread's N consecutive words of one tile, moved as one load or store
// (16 bytes, or N * sizeof(W) below that), and their N mask bytes.
template <typename W, int N>
struct alignas(N * sizeof(W)) Vec {
  W w[N];
};

template <typename W, int N>
__device__ __forceinline__ Vec<W, N> load_vec(const W* p) {
  return *reinterpret_cast<const Vec<W, N>*>(p);
}

template <int N>
__device__ __forceinline__ unsigned load_bytes(const signed char* p) {
  if (N == 4) return *reinterpret_cast<const unsigned*>(p);
  if (N == 2) return *reinterpret_cast<const unsigned short*>(p);
  return *reinterpret_cast<const unsigned char*>(p);
}

// One output of a wide2 pass: m holds the own mask byte, m_at2 the D2
// partner's (both in their low bits); own, at1, at2 and at12 the words
// of the four source tiles at the output's offset.
template <typename W>
__device__ __forceinline__ W wide2_pick(unsigned m, unsigned m_at2, W own,
                                        W at1, W at2, W at12) {
  const W s1_own = (m & 1u) ? at1 : own;
  const W s1_shift = (m_at2 & 1u) ? at12 : at2;
  return (m & 2u) ? s1_shift : s1_own;
}

// One output vector.  kOne, a wide pass: word e takes at1 where byte e
// of m is non-zero (any value, as the plain version and the TPU kernel
// test it, not bit 0 alone); else wide2_pick on bits 0 and 1.
template <bool kOne, typename W, int N>
__device__ __forceinline__ Vec<W, N> pick_vec(unsigned m, unsigned m_at2,
                                              const Vec<W, N>& own,
                                              const Vec<W, N>& at1,
                                              const Vec<W, N>& at2,
                                              const Vec<W, N>& at12) {
  Vec<W, N> o;
#pragma unroll
  for (int e = 0; e < N; ++e)
    o.w[e] = kOne ? (((m >> (8 * e)) & 0xffu) ? at1.w[e] : own.w[e])
                  : wide2_pick(m >> (8 * e), m_at2 >> (8 * e), own.w[e],
                               at1.w[e], at2.w[e], at12.w[e]);
  return o;
}

// Thread t owns vector v = t mod (tile / N) of each tile of group t / (tile
// / N): the group's lowest tile is the group number with zero bits
// inserted at log2(D1) and log2(D2) (one bit when D1 == D2, kPair), its
// members i0 ^ (k & 1 ? D1 : 0) ^ (k & 2 ? D2 : 0).  kOne: the single
// stage of a wide pass (a pair, D1 = D2 = D).
template <typename W, int N, bool kPair, bool kOne>
__device__ __forceinline__ void swap_group(
    const W* __restrict__ x, W* __restrict__ out,
    const signed char* __restrict__ mask, long long P, long long batch,
    int log2_tile, int log2_vecs, int b1, int b2, long long total) {
  constexpr int G = kPair ? 2 : 4;
  constexpr int k2 = kPair ? 1 : 2;  // member of the D2 partner: k ^ k2
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const long long v = t & ((1LL << log2_vecs) - 1);
  long long i0 = t >> log2_vecs;
  const int lo_bit = b1 < b2 ? b1 : b2, hi_bit = b1 < b2 ? b2 : b1;
  i0 = ((i0 >> lo_bit) << (lo_bit + 1)) | (i0 & ((1LL << lo_bit) - 1));
  if (!kPair)
    i0 = ((i0 >> hi_bit) << (hi_bit + 1)) | (i0 & ((1LL << hi_bit) - 1));
  long long at[G];
  unsigned m[G];
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const long long c = i0 ^ ((k & 1) ? 1LL << b1 : 0) ^
                        ((k & 2) ? 1LL << b2 : 0);
    at[k] = (c << log2_tile) + v * N;
    m[k] = load_bytes<N>(mask + at[k]);
  }
  for (long long b = 0; b < batch; ++b) {
    const W* xb = x + b * P;
    W* ob = out + b * P;
    Vec<W, N> xv[G];
#pragma unroll
    for (int k = 0; k < G; ++k) xv[k] = load_vec<W, N>(xb + at[k]);
#pragma unroll
    for (int k = 0; k < G; ++k)
      *reinterpret_cast<Vec<W, N>*>(ob + at[k]) =
          pick_vec<kOne>(m[k], m[k ^ k2], xv[k], xv[k ^ 1], xv[k ^ k2],
                         xv[k ^ 1 ^ k2]);
  }
}

#define FU_SWAP_ARGS                                                       \
  const W* __restrict__ x, W* __restrict__ out,                            \
      const signed char* __restrict__ mask, long long P, long long batch,  \
      int log2_tile, int log2_vecs, int b1, int b2, long long total
#define FU_SWAP_CALL \
  x, out, mask, P, batch, log2_tile, log2_vecs, b1, b2, total

template <typename W, int N, bool kPair>
__global__ void __launch_bounds__(kWideThreads)
wide2_swap_group(FU_SWAP_ARGS) {
  swap_group<W, N, kPair, false>(FU_SWAP_CALL);
}

// A wide pass's swap: the pair {i, i ^ D}.
template <typename W, int N>
__global__ void __launch_bounds__(kWideThreads) wide_pass_swap(FU_SWAP_ARGS) {
  swap_group<W, N, true, true>(FU_SWAP_CALL);
}
#undef FU_SWAP_ARGS
#undef FU_SWAP_CALL

constexpr int kWide2Seg = 4;      // chain steps per thread, at most
// (D1 + D2) / gcd(D1, D2), at most: the pairs (1, 1), (1, 2) and (2, 1).
// The planners' distances are powers of two, and a roll plan's adjacent
// stages differ by a factor of two; other pairs take the gather form.
constexpr int kChainBudget = 3;
constexpr int kChainBlocks = 3;   // resident blocks per SM (register cap)
constexpr unsigned kLow = 0x01010101u;  // bit 0 of each mask byte

// Roll kinds with D1 = A * g, D2 = B * g (g at most the tile count; B = 0:
// the single stage of a wide pass, D = g): thread t owns vector v = t mod
// (tile / N) of chain r = (t / (tile / N)) mod g (the tiles r, r + g,
// r + 2g, ...) at the chain steps [s0, s0 + seg) of
// segment (t / (tile / N)) / g.  Chain step s < 0 stands for tile 0,
// where the roll clamps.  The x vectors of steps s0 - A - B .. s0 + seg -
// 1 and the mask vectors of steps s0 - B .. s0 + seg - 1 at steps >= 0
// are loaded before any is used, with compile-time register indices;
// tile 0's x, which every chain's first steps would read, only where a
// mask bit selects it.
template <typename W, int N, int A, int B>
__device__ __forceinline__ void roll_chain(
    const W* __restrict__ x, W* __restrict__ out,
    const signed char* __restrict__ mask, long long P, long long batch,
    int log2_tile, int log2_vecs, unsigned g, unsigned grid_tiles, int seg,
    long long total) {
  constexpr int H = A + B;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const long long v = t & ((1LL << log2_vecs) - 1);
  // tile counts fit 32 bits (the launch checks), whose divisions are
  // much cheaper than 64-bit ones
  const unsigned rest = (unsigned)(t >> log2_vecs);
  const unsigned r = rest % g;
  const int s0 = (int)(rest / g) * seg;
  const int len = (int)((grid_tiles - r + g - 1) / g);  // steps of chain r
  if (s0 >= len) return;
  const int cnt = len - s0 < seg ? len - s0 : seg;
  // offset of the vector at chain step s (tile 0 below step 0)
  auto at = [&](int s) {
    return ((long long)(s < 0 ? 0 : r + s * g) << log2_tile) + v * N;
  };
  unsigned m[B + kWide2Seg];
#pragma unroll
  for (int j = 0; j < B + kWide2Seg; ++j)
    m[j] = j < B + cnt && s0 - B + j >= 0
               ? load_bytes<N>(mask + at(s0 - B + j)) : 0u;
  // Tile 0's x where a selected source clamps.  Where the D2 partner
  // clamps, so does the D1 + D2 source, and stage 2 reads tile 0 whatever
  // the partner's stage-1 bit: its mask vector (0 above) is never needed.
  unsigned need0 = 0;
#pragma unroll
  for (int s = 0; s < kWide2Seg; ++s) {
    if (s >= cnt || s0 + s >= H) continue;
    if (B == 0) {  // one stage: any non-zero byte takes the D source
      need0 |= m[s];
      continue;
    }
    const unsigned b0 = m[B + s] & kLow, b1 = (m[B + s] >> 1) & kLow;
    const unsigned c0 = m[s] & kLow;
    if (s0 + s < A) need0 |= b0 & ~b1;   // the D1 source
    if (s0 + s < B) need0 |= b1 & ~c0;   // the D2 source
    need0 |= b1 & c0;                    // the D1 + D2 source
  }
  for (long long b = 0; b < batch; ++b) {
    const W* xb = x + b * P;
    W* ob = out + b * P;
    Vec<W, N> xv[H + kWide2Seg];
#pragma unroll
    for (int j = 0; j < H + kWide2Seg; ++j)
      if (j < H + cnt && s0 - H + j >= 0)
        xv[j] = load_vec<W, N>(xb + at(s0 - H + j));
    if (s0 < H) {
      const Vec<W, N> zero = need0 ? load_vec<W, N>(xb + at(-1))
                                   : Vec<W, N>{};
#pragma unroll
      for (int j = 0; j < H; ++j)
        if (s0 - H + j < 0) xv[j] = zero;
    }
#pragma unroll
    for (int s = 0; s < kWide2Seg; ++s)
      if (s < cnt)
        *reinterpret_cast<Vec<W, N>*>(ob + at(s0 + s)) =
            pick_vec<B == 0>(m[B + s], m[s], xv[H + s], xv[B + s],
                             xv[A + s], xv[s]);
  }
}

#define FU_CHAIN_ARGS                                                      \
  const W* __restrict__ x, W* __restrict__ out,                            \
      const signed char* __restrict__ mask, long long P, long long batch,  \
      int log2_tile, int log2_vecs, unsigned g, unsigned grid_tiles,       \
      int seg, long long total
#define FU_CHAIN_CALL                                                      \
  x, out, mask, P, batch, log2_tile, log2_vecs, g, grid_tiles, seg, total

template <typename W, int N, int A, int B>
__global__ void __launch_bounds__(kWideThreads, kChainBlocks)
wide2_roll_chain(FU_CHAIN_ARGS) {
  roll_chain<W, N, A, B>(FU_CHAIN_CALL);
}

// A wide pass's roll: chains of tiles mod D.
template <typename W, int N>
__global__ void __launch_bounds__(kWideThreads, kChainBlocks)
wide_pass_roll(FU_CHAIN_ARGS) {
  roll_chain<W, N, 1, 0>(FU_CHAIN_CALL);
}
#undef FU_CHAIN_ARGS
#undef FU_CHAIN_CALL

// Roll kinds whose chain window passes the budget: thread t owns vector
// t mod (tile / N) of tile t / (tile / N); its own and its D2 partner's
// mask vectors come first, then one load per word from the source tile
// its bits select, all issued before the store.
template <typename W, int N>
__global__ void __launch_bounds__(kWideThreads)
wide2_roll_gather(const W* __restrict__ x, W* __restrict__ out,
                  const signed char* __restrict__ mask, long long P,
                  long long batch, int log2_tile, int log2_vecs, long long D1,
                  long long D2, long long total) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const long long v = t & ((1LL << log2_vecs) - 1);
  const long long i = t >> log2_vecs;
  const long long at1 = i >= D1 ? i - D1 : 0;
  const long long at2 = i >= D2 ? i - D2 : 0;
  const long long at12 = i >= D1 + D2 ? i - D1 - D2 : 0;
  const long long off = (i << log2_tile) + v * N;
  const unsigned m = load_bytes<N>(mask + off);
  const unsigned m2 = load_bytes<N>(mask + (at2 << log2_tile) + v * N);
  long long src[N];
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const unsigned me = m >> (8 * e), m2e = m2 >> (8 * e);
    const long long blk =
        (me & 2u) ? ((m2e & 1u) ? at12 : at2) : ((me & 1u) ? at1 : i);
    src[e] = (blk << log2_tile) + v * N + e;
  }
  for (long long b = 0; b < batch; ++b) {
    const W* xb = x + b * P;
    Vec<W, N> o;
#pragma unroll
    for (int e = 0; e < N; ++e) o.w[e] = xb[src[e]];
    *reinterpret_cast<Vec<W, N>*>(out + b * P + off) = o;
  }
}

long long gcd(long long a, long long b) {
  while (b) {
    const long long t = a % b;
    a = b;
    b = t;
  }
  return a;
}

int launch_grid(long long total, unsigned* blocks) {
  const long long n = (total + kWideThreads - 1) / kWideThreads;
  if (n < 1 || n > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  *blocks = (unsigned)n;
  return 0;
}

template <typename W>
using SwapKernel = void (*)(const W*, W*, const signed char*, long long,
                            long long, int, int, int, int, long long);
template <typename W>
using ChainKernel = void (*)(const W*, W*, const signed char*, long long,
                             long long, int, int, unsigned, unsigned, int,
                             long long);

// g <= grid_tiles < 2^31 (launch_wide_n and the entry check)
template <typename W>
int launch_chain(ChainKernel<W> kernel, const W* x, W* out,
                 const signed char* mask, long long P, long long batch,
                 int log2_tile, int log2_vecs, long long g,
                 long long grid_tiles, cudaStream_t stream) {
  const long long len = (grid_tiles + g - 1) / g;   // the longest chain
  const int seg = len < kWide2Seg ? (int)len : kWide2Seg;
  const long long total = ((len + seg - 1) / seg) * g << log2_vecs;
  unsigned blocks = 0;
  if (int err = launch_grid(total, &blocks)) return err;
  kernel<<<blocks, kWideThreads, 0, stream>>>(
      x, out, mask, P, batch, log2_tile, log2_vecs, (unsigned)g,
      (unsigned)grid_tiles, seg, total);
  return (int)cudaGetLastError();
}

template <typename W, int N>
int launch_wide_n(int kind, const W* x, W* out, const signed char* mask,
                  long long P, long long batch, int log2_tile, long long d1,
                  long long d2, cudaStream_t stream) {
  const long long grid_tiles = P >> log2_tile;
  int log2_vecs = log2_tile;
  for (int n = N; n > 1; n >>= 1) --log2_vecs;
  unsigned blocks = 0;
  if (kind == kWideSwap || kind == kWideSwap2) {
    const bool one = kind == kWideSwap;
    int b1 = 0, b2 = 0;
    while ((1LL << b1) < d1) ++b1;
    while ((1LL << b2) < d2) ++b2;
    if (one) b2 = b1;
    const bool pair = b1 == b2;
    const long long total = (grid_tiles >> (pair ? 1 : 2)) << log2_vecs;
    if (int err = launch_grid(total, &blocks)) return err;
    const SwapKernel<W> kernel = one    ? wide_pass_swap<W, N>
                                 : pair ? wide2_swap_group<W, N, true>
                                        : wide2_swap_group<W, N, false>;
    kernel<<<blocks, kWideThreads, 0, stream>>>(
        x, out, mask, P, batch, log2_tile, log2_vecs, b1, b2, total);
    return (int)cudaGetLastError();
  }
  if (kind == kWideRoll)  // every tile past the tile count clamps to 0
    return launch_chain<W>(wide_pass_roll<W, N>, x, out, mask, P, batch,
                           log2_tile, log2_vecs,
                           d1 < grid_tiles ? d1 : grid_tiles, grid_tiles,
                           stream);
  const long long g = gcd(d1, d2), a = d1 / g, b = d2 / g;
  const bool chain = g < grid_tiles && grid_tiles < (1LL << 31);
#define FU_CHAIN(A, B)                                                       \
  if (chain && a == A && b == B)                                             \
    return launch_chain<W>(wide2_roll_chain<W, N, A, B>, x, out, mask, P,    \
                           batch, log2_tile, log2_vecs, g, grid_tiles,       \
                           stream);
  // every coprime (A, B) with A + B <= kChainBudget
  FU_CHAIN(1, 1) FU_CHAIN(1, 2) FU_CHAIN(2, 1)
#undef FU_CHAIN
  const long long total = grid_tiles << log2_vecs;
  if (int err = launch_grid(total, &blocks)) return err;
  wide2_roll_gather<W, N><<<blocks, kWideThreads, 0, stream>>>(
      x, out, mask, P, batch, log2_tile, log2_vecs, d1, d2, total);
  return (int)cudaGetLastError();
}

// 16-byte vectors where the tile and the pointers allow, else one word.
template <typename W>
int launch_wide(int kind, const void* x, void* out, const void* mask,
                long long P, long long batch, int tile, int log2_tile,
                long long d1, long long d2, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(W);
  const W* xt = static_cast<const W*>(x);
  W* ot = static_cast<W*>(out);
  const signed char* mt = static_cast<const signed char*>(mask);
  const bool aligned = reinterpret_cast<size_t>(x) % 16 == 0 &&
                       reinterpret_cast<size_t>(out) % 16 == 0 &&
                       reinterpret_cast<size_t>(mask) % kVec == 0;
  if (tile >= kVec && aligned)
    return launch_wide_n<W, kVec>(kind, xt, ot, mt, P, batch, log2_tile, d1,
                                  d2, stream);
  return launch_wide_n<W, 1>(kind, xt, ot, mt, P, batch, log2_tile, d1, d2,
                             stream);
}

template <typename T>
int launch(int kind, const void* x, void* out, const void* mask, long long P,
           long long batch, int tile, int shift, int n_stages,
           const Dists& ds, const LocalSched& sc, long long d1, long long d2,
           cudaStream_t stream) {
  if (kind == kLocal)
    return launch_butterfly<T>(x, out, mask, P, batch, tile, sc, stream);
  if (kind == kWindow)
    return launch_window<T>(x, out, mask, P, batch, tile, n_stages, ds,
                            stream);
  return launch_wide<T>(kind, x, out, mask, P, batch, tile, shift, d1, d2,
                        stream);
}

}  // namespace

// kind: 0 local, 1 window, 2 wide_swap, 3 wide_roll, 4 wide_swap2,
// 5 wide_roll2.  elem_bytes: 4 or 8 (the words are moved, never read as
// numbers).  x, out: batch * P words; mask: P int32 words (local, window)
// or P int8 (wide).  dists: host array of n_stages element distances
// (local, window); d1, d2: block distances (d1 for wide, both for wide2,
// each >= 1; swaps: powers of two whose partner tiles lie on the grid).  sched (local only):
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
  // wide, wide2: the partner tiles lie on the grid (a swap's i ^ D for
  // every i); a wide roll's chains count tiles in 32 bits
  const long long grid_tiles = P / tile;
  if (kind < kLocal || kind > kWideRoll2 ||
      (kind >= kWideSwap && d1 < 1) ||
      (kind >= kWideSwap2 && d2 < 1) ||
      (kind == kWideRoll && grid_tiles >= (1LL << 31)))
    return (int)cudaErrorInvalidValue;
  if ((kind == kWideSwap || kind == kWideSwap2) &&
      ((d1 & (d1 - 1)) || grid_tiles % (2 * d1)))
    return (int)cudaErrorInvalidValue;
  if (kind == kWideSwap2 && ((d2 & (d2 - 1)) || grid_tiles % (2 * d2)))
    return (int)cudaErrorInvalidValue;
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
