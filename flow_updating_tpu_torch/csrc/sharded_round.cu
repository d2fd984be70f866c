// B5: the per-shard banded round, over one or two ranges of one shard's
// tile-rows, with the next round's fire folded into the merge.
//
// Replaces the TPU kernel flow_updating_tpu/ops/pallas_round.py
// (_sharded_round_kernel, launched by fused_sharded_round).  A shard owns L
// contiguous plan-order nodes; it reads avg through the window
// [recv_lo; avg; recv_hi] of L + 2H elements, where recv_lo holds the last H
// elements of the left neighbor shard's avg and recv_hi the first H of the
// right one.  Two modes:
//
//   fire (mode 0):  avg[p] = (value - S + A_prev) * inv
//   merge (mode 1): acc = acc + (bit_d(p) ? window[H + p + d] : 0)
//                     for each kept diagonal d, in plan order;
//                   'inline': rs = rs + window[rem(p, j)], j = 0 .. W-1
//                     (-1 = empty slot), acc = acc + rs;
//                   S' = -G - acc + deg * avg_prev
//                   G' = -S - deg * avg + A_prev,   A = acc,
//                   and the next round's fire
//                   avg_next = (value - S' + A) * inv.
//
// The TPU kernel fired and merged in one launch and started its remote
// copies in between.  Here a round's avg was written by the previous
// round's merges (the fire runs alone only where a state is made), so a
// shard-round is two launches: the interior rows, whose reads never leave
// the shard, while the halos are copied on a copy stream, and one launch
// whose grid covers both boundary ranges once the copies have landed.  No
// kernel waits on a flag written by another stream: the order between
// launches and copies is kept by stream events alone
// (parallel/banded_sharded.py).
//
// Bit-exactness with the plain version (ops/sharded_round.py) and with the
// single-device banded round needs the same operations in the same order:
// `acc + (bit ? v : 0)` for every diagonal, the remainder summed on its own
// and added last, the folded fire on the S' and A just computed (the values
// that are stored), and no contraction into an FMA — this file is compiled
// with -fmad=false.
//
// What bounds it on an H100: bytes.  One shard-round must read seven node
// planes (value, S, G, avg_prev, A_prev, inv, deg), the bit planes, the
// remainder table and the halos, and write four (S', G', A and the next
// avg); the folded round also reads this round's avg, about 1.09x the
// bound.  The design:
//
//   * a thread owns 16 bytes of every node plane (4 float32 or 2 float64
//     nodes, one vector load or store each) where every node pointer is
//     16-byte aligned and the launch still gives each SM a block at that
//     width (the interior), else one node (the boundary launch: four
//     times the threads waiting on memory side by side measured 2.1x
//     faster there);
//   * the bit-plane word of a node is loaded once per 32 diagonals, the
//     node planes and the first remainder slots first of all, and the
//     window reads of 8 diagonals (4 remainder slots) together, whatever
//     the mask bits (a kept diagonal never reaches past the window), then
//     added in order where the bit is set: a thread waits on memory about
//     twice, and not once per diagonal.  The boundary launch, two blocks
//     at path E's shapes, is bound by that latency;
//   * the window: a block whose nodes lie at least H from both ends of
//     the shard reads avg directly, any other block through the
//     three-way choice of window_at — decided once per block, not per
//     read.  Neighbor operands lie within the bandwidth and come from
//     L1/L2.  scripts/torch_b5_b6_variants.py times a shared-memory
//     window against this choice;
//   * the boundary launch's grid covers both boundary ranges: a block
//     belongs to the first range or the second by its index.
//
// avg_next may be the buffer that holds avg_prev (the two avg buffers
// alternate by round parity): a thread reads avg_prev of its nodes before
// it writes avg_next of the same nodes, and no thread reads another's.
//
// Plain C interface, loaded with ctypes (flow_updating_tpu_torch/kernels).

#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <utility>
#include <vector>

namespace {

constexpr int kThreads = 256;
constexpr long long kLane = 128;
constexpr int kWideBytes = 16; // bytes of each node plane a wide thread takes
constexpr int kDiags = 8;      // diagonals a thread reads at once (divides 32)
constexpr int kRems = 4;       // remainder slots a thread reads at once

// V nodes of T from p (V * sizeof(T) = 8 or 16 bytes, aligned, or one)
template <typename T, int V>
__device__ __forceinline__ void load(const T* p, T (&x)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    memcpy(x, &u, sizeof(u));
  } else if constexpr (V * sizeof(T) == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    memcpy(x, &u, sizeof(u));
  } else {
    x[0] = p[0];
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const T (&x)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    uint4 u;
    memcpy(&u, x, sizeof(u));
    *reinterpret_cast<uint4*>(p) = u;
  } else if constexpr (V * sizeof(T) == 8) {
    uint2 u;
    memcpy(&u, x, sizeof(u));
    *reinterpret_cast<uint2*>(p) = u;
  } else {
    p[0] = x[0];
  }
}

// V bit-plane words from p (aligned to 4 V bytes)
template <int V>
__device__ __forceinline__ void load_words(const uint32_t* p,
                                           uint32_t (&w)[V]) {
  if constexpr (V == 4) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
  } else if constexpr (V == 2) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x; w[1] = u.y;
  } else {
    w[0] = p[0];
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
sharded_fire_kernel(long long n, const T* __restrict__ value,
                    const T* __restrict__ S, const T* __restrict__ A_prev,
                    const T* __restrict__ inv, T* __restrict__ avg) {
  const long long p =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * V;
  if (p >= n) return;
  T x[V], s[V], a[V], iv[V], o[V];
  load(value + p, x);
  load(S + p, s);
  load(A_prev + p, a);
  load(inv + p, iv);
#pragma unroll
  for (int j = 0; j < V; ++j) o[j] = (x[j] - s[j] + a[j]) * iv[j];
  store(avg + p, o);
}

template <typename T>
struct MergeArgs {
  long long L, H;
  int n_off;
  const int* offsets;
  const uint32_t* planes;
  const T* S;
  const T* G;
  const T* avg_prev;       // may alias avg_next
  const T* A_prev;
  const T* deg;
  const T* avg;
  const T* lo;
  const T* hi;
  const int* rem_idx;
  int rem_w;
  const T* value;          // the folded fire
  const T* inv;
  T* S_out;
  T* G_out;
  T* A_out;
  T* avg_next;
};

// the element at window coordinate w of [recv_lo (H); own (L); recv_hi (H)];
// INSIDE: the block's reads all fall on own
template <typename T, bool INSIDE>
__device__ __forceinline__ T window_at(const MergeArgs<T>& a, long long w) {
  if (INSIDE || (w >= a.H && w < a.H + a.L)) return a.avg[w - a.H];
  if (w < a.H) return a.lo[w];
  return a.hi[w - a.H - a.L];
}

template <typename T, int V, bool INLINE, bool INSIDE>
__device__ __forceinline__ void merge_nodes(const MergeArgs<T>& a,
                                            long long p) {
  // the node planes first: their loads overlap the window's
  T s[V], g[V], ap[V], pa[V], dg[V], av[V], x[V], iv[V];
  load(a.S + p, s);
  load(a.G + p, g);
  load(a.avg_prev + p, ap);
  load(a.A_prev + p, pa);
  load(a.deg + p, dg);
  load(a.avg + p, av);
  load(a.value + p, x);
  load(a.inv + p, iv);
  // the first kRems remainder slots of each node, also ahead of the
  // window reads that depend on them
  int ridx[V][kRems];
  if (INLINE)
#pragma unroll
    for (int j = 0; j < V; ++j)
#pragma unroll
      for (int k = 0; k < kRems; ++k)
        ridx[j][k] = k < a.rem_w ? a.rem_idx[(p + j) * a.rem_w + k] : -1;
  T acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = T(0);
  // kDiags diagonals at a time: their window reads are issued together,
  // whatever the mask bits (every kept diagonal reaches at most H, so the
  // read stays in the window), then added in plan order where the bit is
  // set (a chunk never crosses a bit-plane word)
  uint32_t word[V];
  for (int g0 = 0; g0 < a.n_off; g0 += kDiags) {
    if ((g0 & 31) == 0)
      load_words<V>(a.planes + (long long)(g0 >> 5) * a.L + p, word);
    T v[kDiags][V];
#pragma unroll
    for (int k = 0; k < kDiags; ++k) {
      const int gk = g0 + k;
      if (gk < a.n_off) {
        const long long w0 = a.H + p + a.offsets[gk];
#pragma unroll
        for (int j = 0; j < V; ++j) v[k][j] = window_at<T, INSIDE>(a, w0 + j);
      }
    }
#pragma unroll
    for (int k = 0; k < kDiags; ++k) {
      const int gk = g0 + k;
      if (gk < a.n_off)
#pragma unroll
        for (int j = 0; j < V; ++j)
          acc[j] = acc[j] + (((word[j] >> (gk & 31)) & 1u) ? v[k][j] : T(0));
    }
  }
  if (INLINE) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int* row = a.rem_idx + (p + j) * a.rem_w;
      T rs = T(0);
      for (int c0 = 0; c0 < a.rem_w; c0 += kRems) {
        T v[kRems];
#pragma unroll
        for (int k = 0; k < kRems; ++k) {
          v[k] = T(0);
          const int w = c0 == 0 ? ridx[j][k]
                        : c0 + k < a.rem_w ? row[c0 + k] : -1;
          if (w >= 0) v[k] = window_at<T, INSIDE>(a, (long long)w);
        }
#pragma unroll
        for (int k = 0; k < kRems; ++k)
          if (c0 + k < a.rem_w) rs = rs + v[k];
      }
      acc[j] = acc[j] + rs;
    }
  }
  T s_out[V], g_out[V], nx[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    s_out[j] = -g[j] - acc[j] + dg[j] * ap[j];
    g_out[j] = -s[j] - dg[j] * av[j] + pa[j];
    nx[j] = (x[j] - s_out[j] + acc[j]) * iv[j];
  }
  store(a.S_out + p, s_out);
  store(a.G_out + p, g_out);
  store(a.A_out + p, acc);
  store(a.avg_next + p, nx);
}

// Ranges [begin[r], end[r]) of nodes; blocks [0, blocks0) take range 0,
// the others range 1.
struct Ranges {
  long long begin[2], end[2];
  long long blocks0;
};

template <typename T, int V, bool INLINE>
__global__ void __launch_bounds__(kThreads)
sharded_merge_kernel(Ranges rg, MergeArgs<T> a) {
  const int r = (long long)blockIdx.x < rg.blocks0 ? 0 : 1;
  const long long blk = (long long)blockIdx.x - (r ? rg.blocks0 : 0);
  const long long b0 = rg.begin[r] + blk * kThreads * V;
  const long long b1 =
      b0 + kThreads * V < rg.end[r] ? b0 + kThreads * V : rg.end[r];
  const long long p = b0 + (long long)threadIdx.x * V;
  if (p >= b1) return;
  if (b0 >= a.H && b1 + a.H <= a.L)
    merge_nodes<T, V, INLINE, true>(a, p);
  else
    merge_nodes<T, V, INLINE, false>(a, p);
}

bool aligned16(const void* const* ptrs, int n) {
  uintptr_t any = 0;
  for (int i = 0; i < n; ++i) any |= reinterpret_cast<uintptr_t>(ptrs[i]);
  return (any & 15) == 0;
}

// The card's SM count, queried on the first launch on a device and cached.
int sm_count(int* sms) {
  static std::mutex lock;
  static std::vector<std::pair<int, int>> cache;   // (device, SMs)
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> hold(lock);
  for (const auto& c : cache)
    if (c.first == dev) {
      *sms = c.second;
      return 0;
    }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  cache.emplace_back(dev, *sms);
  return 0;
}

template <typename T, int V>
int launch_merge(bool inl, const long long* begin, const long long* end,
                 const MergeArgs<T>& a, cudaStream_t stream) {
  const long long per = (long long)kThreads * V;
  Ranges rg{{begin[0], begin[1]}, {end[0], end[1]},
            (end[0] - begin[0] + per - 1) / per};
  const long long grid = rg.blocks0 + (end[1] - begin[1] + per - 1) / per;
  if (grid == 0) return 0;
  if (inl)
    sharded_merge_kernel<T, V, true><<<(unsigned)grid, kThreads, 0, stream>>>(
        rg, a);
  else
    sharded_merge_kernel<T, V, false><<<(unsigned)grid, kThreads, 0,
                                        stream>>>(rg, a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(int route, const long long* begin, const long long* end,
           int mode, long long L, long long H, int n_off, const void* offsets,
           const void* planes, const void* const* in, void* avg,
           const void* recv_lo, const void* recv_hi, const void* rem_idx,
           int rem_w, void* const* out, cudaStream_t stream) {
  constexpr int V = kWideBytes / sizeof(T);
  const T* value = static_cast<const T*>(in[0]);
  const T* S = static_cast<const T*>(in[1]);
  const T* A_prev = static_cast<const T*>(in[4]);
  const T* inv = static_cast<const T*>(in[5]);
  if (mode == 0) {
    const long long n = end[0] - begin[0];
    if (n == 0) return 0;
    const void* ptrs[5] = {value, S, A_prev, inv, avg};
    const long long b = begin[0];
    if (aligned16(ptrs, 5) && (b % V) == 0) {
      const unsigned blocks = (unsigned)((n / V + kThreads - 1) / kThreads);
      sharded_fire_kernel<T, V><<<blocks, kThreads, 0, stream>>>(
          n, value + b, S + b, A_prev + b, inv + b, static_cast<T*>(avg) + b);
    } else {
      const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
      sharded_fire_kernel<T, 1><<<blocks, kThreads, 0, stream>>>(
          n, value + b, S + b, A_prev + b, inv + b, static_cast<T*>(avg) + b);
    }
    return (int)cudaGetLastError();
  }
  if (mode != 1 || (route == 2 && (rem_idx == nullptr || rem_w <= 0)) ||
      (route != 0 && route != 2))
    return (int)cudaErrorInvalidValue;
  T* avg_next = static_cast<T*>(out[3]);
  if (avg_next == nullptr || value == nullptr || inv == nullptr)
    return (int)cudaErrorInvalidValue;
  MergeArgs<T> a{L, H, n_off,
                 static_cast<const int*>(offsets),
                 static_cast<const uint32_t*>(planes),
                 S, static_cast<const T*>(in[2]), static_cast<const T*>(in[3]),
                 A_prev, static_cast<const T*>(in[6]),
                 static_cast<const T*>(avg),
                 static_cast<const T*>(recv_lo),
                 static_cast<const T*>(recv_hi),
                 static_cast<const int*>(rem_idx), rem_w, value, inv,
                 static_cast<T*>(out[0]), static_cast<T*>(out[1]),
                 static_cast<T*>(out[2]), avg_next};
  const void* ptrs[13] = {a.S, a.G, a.avg_prev, a.A_prev, a.deg, a.avg,
                          a.S_out, a.G_out, a.A_out, a.planes, a.value,
                          a.inv, a.avg_next};
  // wide threads where the launch still gives every SM a block at that
  // width (the interior); one node a thread where it would not (the
  // boundary launch: more threads wait on memory side by side)
  int sms = 0;
  if (int err = sm_count(&sms)) return err;
  const long long nodes = (end[0] - begin[0]) + (end[1] - begin[1]);
  if (aligned16(ptrs, 13) &&
      nodes >= (long long)sms * kThreads * V)
    return launch_merge<T, V>(route == 2, begin, end, a, stream);
  return launch_merge<T, 1>(route == 2, begin, end, a, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = float64; route: 0 none, 2 inline; mode: 0 fire,
// 1 merge.  Tile-row ranges [row_begin, row_end) and [row_begin2,
// row_end2) of a shard of L elements (rows of 128; the second range may be
// empty, and the fire takes the first); H = halo elements per side.  Node
// arrays are (L,), planes (ceil(n_off / 32), L) uint32, rem_idx (L, rem_w)
// int32 window coordinates, recv_lo and recv_hi (H,).  Fire reads value,
// S, A_prev, inv and writes avg; merge reads S, G, avg_prev, A_prev, deg,
// avg, value, inv and the window and writes S_out, G_out, A_out and
// avg_next, the next round's fire from value, inv and what it wrote.
// Returns the cudaError_t of the launch.
extern "C" int sharded_round(int dtype, int route, long long row_begin,
                             long long row_end, long long row_begin2,
                             long long row_end2, int mode, long long L,
                             long long H, int n_off, const void* offsets,
                             const void* planes, const void* value,
                             const void* S, const void* G,
                             const void* avg_prev, const void* A_prev,
                             const void* inv, const void* deg, void* avg,
                             const void* recv_lo, const void* recv_hi,
                             const void* rem_idx, int rem_w, void* S_out,
                             void* G_out, void* A_out, void* avg_next,
                             void* stream) {
  const long long rb[2] = {row_begin, row_begin2};
  const long long re[2] = {row_end, row_end2};
  for (int r = 0; r < 2; ++r)
    if (rb[r] < 0 || re[r] < rb[r] || re[r] * kLane > L)
      return (int)cudaErrorInvalidValue;
  if (H < 0 || H > L || n_off < 0 || (mode == 0 && row_end2 > row_begin2))
    return (int)cudaErrorInvalidValue;
  const long long begin[2] = {rb[0] * kLane, rb[1] * kLane};
  const long long end[2] = {re[0] * kLane, re[1] * kLane};
  const void* in[7] = {value, S, G, avg_prev, A_prev, inv, deg};
  void* out[4] = {S_out, G_out, A_out, avg_next};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(route, begin, end, mode, L, H, n_off, offsets,
                         planes, in, avg, recv_lo, recv_hi, rem_idx, rem_w,
                         out, s);
  if (dtype == 1)
    return launch<double>(route, begin, end, mode, L, H, n_off, offsets,
                          planes, in, avg, recv_lo, recv_hi, rem_idx, rem_w,
                          out, s);
  return (int)cudaErrorInvalidValue;
}
