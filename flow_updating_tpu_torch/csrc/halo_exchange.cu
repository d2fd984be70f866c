// B6: the halo block pull and its fused ring-buffer merge.
//
// Replaces the TPU kernel flow_updating_tpu/ops/pallas_halo.py
// (_exchange_kernel, launched by remote_block_exchange and
// fused_exchange_merge).  The TPU kernel starts one remote DMA per shard
// offset, merges the intra-shard deliveries while the DMAs fly, and waits
// on its DMA semaphores.  Here all shards live in one process: a shard's
// "remote" block is a buffer of another shard, on this card or on a peer
// card, read by pointer.  One launch, on the receiving shard's stream:
//
//   block pull (the first `copy_blocks` thread blocks):
//     recv_b[j] = src_b[j] for every element j of every incoming block b;
//   merge (the remaining thread blocks, fused_exchange_merge only):
//     for each cell c = (d, e) of the (D, Eb) ring buffers
//       out_flow[c, f] = hit[c] ? pay_flow[e, f] : buf_flow[c, f]
//       out_est[c, f]  = hit[c] ? pay_est[e, f]  : buf_est[c, f]
//       out_valid[c]   = buf_valid[c] | hit[c]
//     over the nf feature lanes f.  The merge reads none of the incoming
//     blocks, so the two parts need no order inside the launch.
//
// What the TPU kernel showed through DMA semaphores this launch shows
// through stream order: the caller makes the receiving stream wait on each
// sender's payload event before the launch.  The kernel takes no flag and
// no block waits on another.  Payload blocks are never written after they
// are made (parallel/overlap.py).
//
// What bounds it on an H100: bytes.  Every incoming block is read once and
// written once; the merge reads hit (1 byte a cell), where a cell is hit
// its payload and elsewhere its ring-buffer values and flag, and writes
// three planes (ops/halo_exchange.halo_exchange_min_bytes).  There is no
// arithmetic: a select moves bits, so the merge works on raw 32- and
// 64-bit words and rounds nothing.  The design moves every byte in 16-byte
// accesses, with several in flight a thread (times measured on an H100
// 80GB HBM3 at 700 W by scripts/torch_b5_b6_variants.py, which also times
// the pack width, kPackBytes):
//
//   * merge: the unit of work is a pack of consecutive cells of one row d,
//     64 bytes of each value plane at nf = 1 (16 cells of float32, 8 of
//     float64).  At nf = 1 the 32 threads of a warp take 32 packs
//     together: a thread loads vectors 32 apart, so each load of the warp
//     covers 512 contiguous bytes, and the flags of each vector's cells
//     (4 or 2 bytes); a thread owning its pack's 64 contiguous bytes
//     measured 0.0645-0.0650 ms against 0.0577 (one-wave grid).  With nf > 1 a thread
//     owns its pack: one 16-byte (8-byte) load of `hit` and of
//     `buf_valid`, then nf chunks of 64 bytes whose lanes share a cell's
//     flag.  The selects run in registers and the stores are 16 bytes.
//     The column comes from the (row, pack) loops, with no division.  A
//     row whose pointers are not aligned to the access, and the cells
//     past a row's last whole pack, take a scalar path, so Eb need not be
//     a multiple of the pack and D * Eb need not be aligned.
//   * both planes are loaded, whatever the flags, so no value load waits
//     for a flag load.  A 32-byte sector holds 8 cells of float32: at
//     k6's hit share (30%) loading the payload only where a cell of the
//     vector is hit skips just the 0.7^8 = 6% of its sectors with no hit,
//     and it measured slower on the four-wave grid (0.0575 against
//     0.0561 ms in one call; loading both, 0.0559-0.0561 in three).
//   * pull: tiles of 256 threads times 8 vectors of 16 bytes, a thread
//     loading its 8 before it stores them (one vector a thread a trip
//     measured 0.0858 ms against 0.0577 on the one-wave grid: the pull's
//     few blocks waited on memory).  The host splits each incoming block into tiles
//     (a scalar head up to the first 16-byte boundary, a scalar tail) and
//     passes the running sum of tiles in the by-value table; a thread
//     block finds a tile's block by a binary search of that prefix.  A
//     block whose source and destination differ in their offset mod 16 is
//     copied element by element.
//   * grid: four times the blocks the card holds at once (SM count times
//     resident blocks, queried once per device), split between pull and
//     merge in proportion to their bytes, each part then trimmed so that
//     its threads run the same number of loop trips; with no merge (fast
//     pairwise, remote_block_exchange) every block pulls.  Blocks that
//     retire make room for others, which evens out the ends of the two
//     parts: 0.0559-0.0561 ms against 0.0577 with one block per resident
//     slot, in three calls.
//
// Plain C interface, loaded with ctypes (flow_updating_tpu_torch/kernels).

#include <cuda_runtime.h>
#include <cstdint>
#include <mutex>
#include <type_traits>
#include <vector>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 32;           // = ops/halo_exchange.MAX_BLOCKS
constexpr int kVec = 16;                 // bytes of one vector access
// bytes of each value plane that a merge thread moves per pack at nf = 1
constexpr int kPackBytes = 64;
// the grid holds kWaves times the blocks the card runs at once
constexpr int kWaves = 4;
// 16-byte vectors a pull thread copies a tile: all loaded, then stored
constexpr int kPullVecs = 8;

struct PullTable {
  const void* src[kMaxBlocks];
  void* dst[kMaxBlocks];
  long long count[kMaxBlocks];           // elements
  long long tile_end[kMaxBlocks];        // running sum of the tiles
  int head[kMaxBlocks];                  // elements before the 16-byte
                                         // body; -1: copied by element
  int k;
};

template <int SZ> struct Word;
template <> struct Word<4> { using type = unsigned; };
template <> struct Word<8> { using type = unsigned long long; };

// ---- pull ------------------------------------------------------------------

template <int SZ>
__device__ __forceinline__ void pull_tile(const PullTable& pull,
                                          long long t) {
  using W = typename Word<SZ>::type;
  constexpr int E = kVec / SZ;           // elements a vector
  constexpr int U = kPullVecs;
  int lo = 0, hi = pull.k - 1;           // the block of tile t
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (t < pull.tile_end[mid]) hi = mid; else lo = mid + 1;
  }
  const long long tb = t - (lo ? pull.tile_end[lo - 1] : 0);
  const W* src = static_cast<const W*>(pull.src[lo]);
  W* dst = static_cast<W*>(pull.dst[lo]);
  const long long n = pull.count[lo];
  const int head = pull.head[lo];
  if (head < 0) {                        // U * E elements a thread
    const long long base = tb * kThreads * U * E + threadIdx.x;
    W x[U * E];
#pragma unroll
    for (int j = 0; j < U * E; ++j) {
      const long long i = base + (long long)j * kThreads;
      if (i < n) x[j] = src[i];
    }
#pragma unroll
    for (int j = 0; j < U * E; ++j) {
      const long long i = base + (long long)j * kThreads;
      if (i < n) dst[i] = x[j];
    }
    return;
  }
  const long long nv = (n - head) / E;
  const long long base = tb * kThreads * U + threadIdx.x;
  const uint4* vs = reinterpret_cast<const uint4*>(src + head);
  uint4* vd = reinterpret_cast<uint4*>(dst + head);
  uint4 x[U];
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const long long iv = base + (long long)j * kThreads;
    if (iv < nv) x[j] = vs[iv];
  }
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const long long iv = base + (long long)j * kThreads;
    if (iv < nv) vd[iv] = x[j];
  }
  if (tb == 0) {                         // the head and the tail
    const int i = threadIdx.x;
    if (i < head) dst[i] = src[i];
    const long long j = head + nv * E + (i - E);
    if (i >= E && i < 2 * E && j < n) dst[j] = src[j];
  }
}

// ---- merge -----------------------------------------------------------------

struct MergeArgs {
  int D;
  long long Eb;
  int nf;
  const uint8_t* hit;
  const void* pay_flow;
  const void* pay_est;
  const void* buf_flow;
  const void* buf_est;
  const uint8_t* buf_valid;
  void* out_flow;
  void* out_est;
  uint8_t* out_valid;
};

// The PACK flag bytes of a pack (4 to 32), as 32-bit words.
template <int PACK>
struct Flags {
  unsigned w[(PACK + 3) / 4];
};

template <int PACK>
__device__ __forceinline__ Flags<PACK> load_flags(const uint8_t* p) {
  Flags<PACK> f;
  if constexpr (PACK >= 16) {
#pragma unroll
    for (int i = 0; i < PACK / 16; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[i];
      f.w[4 * i] = v.x;
      f.w[4 * i + 1] = v.y;
      f.w[4 * i + 2] = v.z;
      f.w[4 * i + 3] = v.w;
    }
  } else if constexpr (PACK == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    f.w[0] = v.x;
    f.w[1] = v.y;
  } else {
    f.w[0] = *reinterpret_cast<const unsigned*>(p);
  }
  return f;
}

template <int PACK>
__device__ __forceinline__ void store_flags(uint8_t* p, const Flags<PACK>& f) {
  if constexpr (PACK >= 16) {
#pragma unroll
    for (int i = 0; i < PACK / 16; ++i)
      reinterpret_cast<uint4*>(p)[i] = make_uint4(
          f.w[4 * i], f.w[4 * i + 1], f.w[4 * i + 2], f.w[4 * i + 3]);
  } else if constexpr (PACK == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(f.w[0], f.w[1]);
  } else {
    *reinterpret_cast<unsigned*>(p) = f.w[0];
  }
}

template <int PACK>
__device__ __forceinline__ bool flag_at(const Flags<PACK>& f, int cell) {
  return (f.w[cell >> 2] >> (8 * (cell & 3))) & 0xffu;
}

__device__ __forceinline__ uint4 select4(const uint4& p, const uint4& b,
                                         bool h0, bool h1, bool h2,
                                         bool h3) {
  return make_uint4(h0 ? p.x : b.x, h1 ? p.y : b.y, h2 ? p.z : b.z,
                    h3 ? p.w : b.w);
}

// The 16-byte vector `bytes` past `base`.
__device__ __forceinline__ const uint4* vec_at(const void* base,
                                               long long bytes) {
  return reinterpret_cast<const uint4*>(static_cast<const char*>(base) +
                                        bytes);
}

__device__ __forceinline__ uint4* vec_at(void* base, long long bytes) {
  return reinterpret_cast<uint4*>(static_cast<char*>(base) + bytes);
}

// One whole pack of row d at column e0, all pointers aligned.  NF1: nf is
// 1.  Each 16-byte vector holds 4 / (SZ / 4) elements; element i of the
// pack's value span belongs to cell i / nf.
template <int SZ, bool NF1>
__device__ __forceinline__ void merge_pack(const MergeArgs& a, long long c0,
                                           long long e0) {
  constexpr int PACK = kPackBytes / SZ;  // cells
  constexpr int VPC = kPackBytes / kVec; // vectors a chunk
  constexpr int WPE = SZ / 4;            // 32-bit words an element
  const int nf = NF1 ? 1 : a.nf;
  const Flags<PACK> h = load_flags<PACK>(a.hit + c0);
  Flags<PACK> v = load_flags<PACK>(a.buf_valid + c0);
#pragma unroll
  for (int i = 0; i < (PACK + 3) / 4; ++i) v.w[i] |= h.w[i];
  store_flags<PACK>(a.out_valid + c0, v);
  const long long po = e0 * nf * SZ;    // byte offsets of the pack
  const long long bo = c0 * nf * SZ;
  const uint4* pf = vec_at(a.pay_flow, po);
  const uint4* pe = vec_at(a.pay_est, po);
  const uint4* bf = vec_at(a.buf_flow, bo);
  const uint4* be = vec_at(a.buf_est, bo);
  uint4* of = vec_at(a.out_flow, bo);
  uint4* oe = vec_at(a.out_est, bo);
  for (int q = 0; q < nf; ++q) {
    bool hw[VPC][4];                     // the flag of each word
#pragma unroll
    for (int j = 0; j < VPC; ++j)
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int i = q * PACK + (j * 4 + w) / WPE;
        hw[j][w] = flag_at(h, NF1 ? i : i / nf);
      }
    uint4 xp[VPC], xb[VPC], yp[VPC], yb[VPC];
#pragma unroll
    for (int j = 0; j < VPC; ++j) {
      const int o = q * VPC + j;
      xp[j] = pf[o];
      yp[j] = pe[o];
      xb[j] = bf[o];
      yb[j] = be[o];
    }
#pragma unroll
    for (int j = 0; j < VPC; ++j) {
      const int o = q * VPC + j;
      of[o] = select4(xp[j], xb[j], hw[j][0], hw[j][1], hw[j][2], hw[j][3]);
      oe[o] = select4(yp[j], yb[j], hw[j][0], hw[j][1], hw[j][2], hw[j][3]);
    }
  }
}

// Scalar lanes: the 32 packs [pk0, pk0 + 32) of the row at
// cell r0, taken by the warp together.  Lane l takes vectors l, l + 32, ...
// of the chunk's 32 * VPC vectors of each plane (each warp load 512
// contiguous bytes) and the CPV flags of each vector's cells; packs at or
// past `whole` are left to the scalar path.
template <int SZ>
__device__ __forceinline__ void merge_warp(const MergeArgs& a, long long r0,
                                           long long pk0, long long whole,
                                           int lane) {
  constexpr int PACK = kPackBytes / SZ;  // cells a pack
  constexpr int VPC = kPackBytes / kVec; // vectors a pack
  constexpr int CPV = kVec / SZ;         // cells a vector
  constexpr int WPE = SZ / 4;            // 32-bit words an element
  using F = typename std::conditional<CPV == 4, unsigned,
                                      unsigned short>::type;
  const long long cell0 = r0 + pk0 * PACK, col0 = pk0 * PACK;
  bool ok[VPC];
  F fh[VPC], fv[VPC];
  uint4 xp[VPC], xb[VPC], yp[VPC], yb[VPC];
#pragma unroll
  for (int j = 0; j < VPC; ++j) {
    const int v = j * 32 + lane;
    ok[j] = pk0 + v / VPC < whole;
    if (!ok[j]) continue;
    const long long c = (long long)v * CPV;
    fh[j] = *reinterpret_cast<const F*>(a.hit + cell0 + c);
    fv[j] = *reinterpret_cast<const F*>(a.buf_valid + cell0 + c);
    xp[j] = *vec_at(a.pay_flow, (col0 + c) * SZ);
    yp[j] = *vec_at(a.pay_est, (col0 + c) * SZ);
    xb[j] = *vec_at(a.buf_flow, (cell0 + c) * SZ);
    yb[j] = *vec_at(a.buf_est, (cell0 + c) * SZ);
  }
#pragma unroll
  for (int j = 0; j < VPC; ++j) {
    if (!ok[j]) continue;
    const long long c = (long long)(j * 32 + lane) * CPV;
    *reinterpret_cast<F*>(a.out_valid + cell0 + c) = (F)(fv[j] | fh[j]);
    bool h[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) h[w] = (fh[j] >> (8 * (w / WPE))) & 0xffu;
    *vec_at(a.out_flow, (cell0 + c) * SZ) =
        select4(xp[j], xb[j], h[0], h[1], h[2], h[3]);
    *vec_at(a.out_est, (cell0 + c) * SZ) =
        select4(yp[j], yb[j], h[0], h[1], h[2], h[3]);
  }
}

// One cell, element by element (row tails and unaligned rows).
template <int SZ>
__device__ __forceinline__ void merge_cell(const MergeArgs& a, long long c,
                                           long long e) {
  using W = typename Word<SZ>::type;
  const uint8_t h = a.hit[c];
  a.out_valid[c] = a.buf_valid[c] | h;
  const int nf = a.nf;
  for (int f = 0; f < nf; ++f) {
    const long long o = c * nf + f, s = e * nf + f;
    static_cast<W*>(a.out_flow)[o] =
        h ? static_cast<const W*>(a.pay_flow)[s]
          : static_cast<const W*>(a.buf_flow)[o];
    static_cast<W*>(a.out_est)[o] =
        h ? static_cast<const W*>(a.pay_est)[s]
          : static_cast<const W*>(a.buf_est)[o];
  }
}

// Whether row d's packs may use the vector path.
template <int SZ>
__device__ __forceinline__ bool row_aligned(const MergeArgs& a, long long r0) {
  constexpr uintptr_t FA = kPackBytes / SZ - 1;  // flag pack alignment
  const uintptr_t flags = reinterpret_cast<uintptr_t>(a.hit + r0) |
                          reinterpret_cast<uintptr_t>(a.buf_valid + r0) |
                          reinterpret_cast<uintptr_t>(a.out_valid + r0);
  const long long vo = r0 * a.nf * SZ;
  const uintptr_t vals =
      reinterpret_cast<uintptr_t>(a.pay_flow) |
      reinterpret_cast<uintptr_t>(a.pay_est) |
      (reinterpret_cast<uintptr_t>(a.buf_flow) + vo) |
      (reinterpret_cast<uintptr_t>(a.buf_est) + vo) |
      (reinterpret_cast<uintptr_t>(a.out_flow) + vo) |
      (reinterpret_cast<uintptr_t>(a.out_est) + vo);
  return !(flags & FA) && !(vals & (kVec - 1));
}

template <int SZ, bool NF1>
__global__ void __launch_bounds__(kThreads)
exchange_kernel(PullTable pull, long long tiles, int copy_blocks,
                MergeArgs a) {
  if ((int)blockIdx.x < copy_blocks) {
    for (long long t = blockIdx.x; t < tiles; t += copy_blocks)
      pull_tile<SZ>(pull, t);
    return;
  }
  constexpr int PACK = kPackBytes / SZ;
  const long long npk = (a.Eb + PACK - 1) / PACK;
  const long long stride = (long long)(gridDim.x - copy_blocks) * kThreads;
  const long long first =
      (long long)(blockIdx.x - copy_blocks) * kThreads + threadIdx.x;
  for (int d = 0; d < a.D; ++d) {
    const long long r0 = (long long)d * a.Eb;
    const bool aligned = row_aligned<SZ>(a, r0);
    if (NF1) {
      const int lane = threadIdx.x & 31;
      const long long whole = aligned ? a.Eb / PACK : 0;
      for (long long pk = first; pk - lane < npk; pk += stride) {
        if (pk - lane < whole) merge_warp<SZ>(a, r0, pk - lane, whole, lane);
        if (pk < npk && pk >= whole) {
          const long long e0 = pk * PACK;
          const long long e1 = e0 + PACK < a.Eb ? e0 + PACK : a.Eb;
          for (long long e = e0; e < e1; ++e) merge_cell<SZ>(a, r0 + e, e);
        }
      }
      continue;
    }
    for (long long pk = first; pk < npk; pk += stride) {
      const long long e0 = pk * PACK;
      if (aligned && e0 + PACK <= a.Eb) {
        merge_pack<SZ, NF1>(a, r0 + e0, e0);
      } else {
        const long long e1 = e0 + PACK < a.Eb ? e0 + PACK : a.Eb;
        for (long long e = e0; e < e1; ++e) merge_cell<SZ>(a, r0 + e, e);
      }
    }
  }
}

// ---- launch ----------------------------------------------------------------

// Blocks of kThreads the card holds at once for `kernel`: SM count times
// resident blocks per SM, queried on the first launch on a device and
// cached, so later launches make no device query.
struct Resident {
  int dev;
  const void* kernel;
  long long blocks;
};

int resident_blocks(const void* kernel, long long* blocks) {
  static std::mutex lock;
  static std::vector<Resident> cache;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> hold(lock);
  for (const Resident& c : cache)
    if (c.dev == dev && c.kernel == kernel) {
      *blocks = c.blocks;
      return 0;
    }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *blocks = (long long)sms * per_sm * kWaves;
  cache.push_back({dev, kernel, *blocks});
  return 0;
}

// The fewest blocks that run `units` units in the loop trips `blocks`
// blocks would take (each thread block takes `per_block` units a trip).
long long trim(long long units, long long per_block, long long blocks) {
  if (units <= 0) return 0;
  if (blocks < 1) blocks = 1;
  const long long trips = (units + blocks * per_block - 1) /
                          (blocks * per_block);
  return (units + trips * per_block - 1) / (trips * per_block);
}

template <int SZ, bool NF1>
int launch(int k, const long long* src, const long long* dst,
           const long long* count, const MergeArgs& a, cudaStream_t stream) {
  constexpr int E = kVec / SZ;
  PullTable pull{};
  long long tiles = 0, pull_bytes = 0;
  for (int b = 0; b < k; ++b) {
    const long long n = count[b];
    const long long s_off = src[b] % kVec, d_off = dst[b] % kVec;
    const long long per = (long long)kThreads * kPullVecs;  // vectors
    long long t;
    if (s_off == d_off) {
      long long head = ((kVec - s_off) % kVec) / SZ;
      head = head < n ? head : n;
      const long long nv = (n - head) / E;
      pull.head[b] = (int)head;
      t = n ? (nv + per - 1) / per : 0;
      if (n && t == 0) t = 1;
    } else {
      pull.head[b] = -1;
      t = (n + per * E - 1) / (per * E);
    }
    pull.src[b] = reinterpret_cast<const void*>(src[b]);
    pull.dst[b] = reinterpret_cast<void*>(dst[b]);
    pull.count[b] = n;
    tiles += t;
    pull.tile_end[b] = tiles;
    pull_bytes += 2 * n * SZ;
  }
  pull.k = k;
  constexpr int PACK = kPackBytes / SZ;
  const long long npk = a.D ? (a.Eb + PACK - 1) / PACK : 0;
  const long long cells = (long long)a.D * a.Eb;
  const long long merge_bytes = cells * (3 + 6LL * a.nf * SZ);
  if (tiles == 0 && npk == 0) return 0;
  long long grid = 0;
  const void* fn = reinterpret_cast<const void*>(exchange_kernel<SZ, NF1>);
  if (int err = resident_blocks(fn, &grid)) return err;
  long long copy_blocks = 0, merge_blocks = 0;
  if (npk == 0) {
    copy_blocks = trim(tiles, 1, grid);
  } else if (tiles == 0) {
    merge_blocks = trim(npk, kThreads, grid);
  } else {
    long long share = (long long)((double)grid * pull_bytes /
                                  (double)(pull_bytes + merge_bytes) + 0.5);
    share = share < 1 ? 1 : share > grid - 1 ? grid - 1 : share;
    copy_blocks = trim(tiles, 1, share);
    merge_blocks = trim(npk, kThreads, grid - share);
  }
  exchange_kernel<SZ, NF1>
      <<<(unsigned)(copy_blocks + merge_blocks), kThreads, 0, stream>>>(
          pull, tiles, (int)copy_blocks, a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 float64.  src/dst/count: host arrays of k entries
// (device pointers of the sender blocks and receive blocks, and their
// lengths in elements).  cells = D * Eb, or 0 for the block pull alone.
extern "C" int halo_exchange(int dtype, int k, const long long* src,
                             const long long* dst, const long long* count,
                             long long cells, long long Eb, int nf,
                             const void* hit, const void* pay_flow,
                             const void* pay_est, const void* buf_flow,
                             const void* buf_est, const void* buf_valid,
                             void* out_flow, void* out_est, void* out_valid,
                             void* stream) {
  if (k < 0 || k > kMaxBlocks || Eb < 1 || nf < 1 || cells < 0 ||
      cells % Eb || cells / Eb > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  for (int b = 0; b < k; ++b)
    if (count[b] < 0) return (int)cudaErrorInvalidValue;
  MergeArgs a{(int)(cells / Eb), Eb, nf,
              static_cast<const uint8_t*>(hit), pay_flow, pay_est,
              buf_flow, buf_est, static_cast<const uint8_t*>(buf_valid),
              out_flow, out_est, static_cast<uint8_t*>(out_valid)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return nf == 1 ? launch<4, true>(k, src, dst, count, a, s)
                   : launch<4, false>(k, src, dst, count, a, s);
  if (dtype == 1)
    return nf == 1 ? launch<8, true>(k, src, dst, count, a, s)
                   : launch<8, false>(k, src, dst, count, a, s);
  return (int)cudaErrorInvalidValue;
}

// Let `device`'s kernels read `peer`'s memory (a sender shard on another
// card).  Already enabled is not an error.
extern "C" int halo_enable_peer(int device, int peer) {
  int prev = 0;
  cudaGetDevice(&prev);
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) {
    err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();
      err = cudaSuccess;
    }
  }
  cudaSetDevice(prev);
  return (int)err;
}
