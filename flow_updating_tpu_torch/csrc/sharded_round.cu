// B5: the per-shard banded round, over a range of one shard's tile-rows.
//
// Replaces the TPU kernel flow_updating_tpu/ops/pallas_round.py
// (_sharded_round_kernel, launched by fused_sharded_round).  A shard owns L
// contiguous plan-order nodes; it reads avg through the window
// [recv_lo; avg; recv_hi] of L + 2H elements, where recv_lo holds the last H
// elements of the left neighbor shard's avg and recv_hi the first H of the
// right one.  One thread per node p of the range, in one of two modes:
//
//   fire (mode 0):  avg[p] = (value - S + A_prev) * inv
//   merge (mode 1): acc = acc + (bit_d(p) ? window[H + p + d] : 0)
//                     for each kept diagonal d, in plan order;
//                   'inline': rs = rs + window[rem(p, j)], j = 0 .. W-1
//                     (-1 = empty slot), acc = acc + rs;
//                   S' = -G - acc + deg * avg_prev
//                   G' = -S - deg * avg + A_prev,   A = acc.
//
// The TPU kernel did both in one launch and started its remote copies in
// between; on this card the caller launches fire, copies the halos on a
// copy stream, merges the interior rows (whose reads never leave the shard)
// and, once the copies have landed, the boundary rows — each row once.
// No kernel waits on a flag written by another stream: the order between
// launches and copies is kept by stream events alone.
//
// Bit-exactness with the plain version (ops/sharded_round.py) and with the
// single-device banded round needs the same operations in the same order:
// `acc + (bit ? v : 0)` for every diagonal, the remainder summed on its own
// and added last, and no contraction of `deg * avg_prev` into an FMA — this
// file is compiled with -fmad=false.
//
// What bounds it on an H100: bytes.  One shard-round must read seven node
// planes (value, S, G, avg_prev, A_prev, inv, deg), the bit planes, the
// remainder table and the halos, and write four (S', G', avg, A).  Neighbor
// operands lie within the bandwidth of p and come from L1/L2.  The merge
// reads the avg the fire wrote (one extra read and write of a node plane
// against a single fused pass); a shared-memory window tile is later work.
//
// Plain C interface, loaded with ctypes (flow_updating_tpu_torch/kernels).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kLane = 128;

template <typename T>
__global__ void sharded_fire_kernel(long long begin, long long end,
                                    const T* __restrict__ value,
                                    const T* __restrict__ S,
                                    const T* __restrict__ A_prev,
                                    const T* __restrict__ inv,
                                    T* __restrict__ avg) {
  long long p = begin + (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= end) return;
  avg[p] = (value[p] - S[p] + A_prev[p]) * inv[p];
}

// the element at window coordinate w of [recv_lo (H); own (L); recv_hi (H)]
template <typename T>
__device__ __forceinline__ T window_at(long long w, long long H, long long L,
                                       const T* __restrict__ lo,
                                       const T* __restrict__ own,
                                       const T* __restrict__ hi) {
  if (w < H) return lo[w];
  if (w < H + L) return own[w - H];
  return hi[w - H - L];
}

template <typename T, bool INLINE>
__global__ void sharded_merge_kernel(
    long long begin, long long end, long long L, long long H, int n_off,
    const int* __restrict__ offsets, const uint32_t* __restrict__ planes,
    const T* __restrict__ S, const T* __restrict__ G,
    const T* __restrict__ avg_prev, const T* __restrict__ A_prev,
    const T* __restrict__ deg, const T* __restrict__ avg,
    const T* __restrict__ recv_lo, const T* __restrict__ recv_hi,
    const int* __restrict__ rem_idx, int rem_w, T* __restrict__ S_out,
    T* __restrict__ G_out, T* __restrict__ A_out) {
  long long p = begin + (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= end) return;

  T acc = T(0);
  for (int g = 0; g < n_off; ++g) {
    uint32_t word = planes[(long long)(g >> 5) * L + p];
    T v = T(0);
    if ((word >> (g & 31)) & 1u)
      v = window_at(H + p + offsets[g], H, L, recv_lo, avg, recv_hi);
    acc = acc + v;
  }
  if (INLINE) {
    const int* row = rem_idx + p * rem_w;
    T rs = T(0);
    for (int j = 0; j < rem_w; ++j) {
      int w = row[j];
      T v = T(0);
      if (w >= 0) v = window_at((long long)w, H, L, recv_lo, avg, recv_hi);
      rs = rs + v;
    }
    acc = acc + rs;
  }

  T dg = deg[p];
  S_out[p] = -G[p] - acc + dg * avg_prev[p];
  G_out[p] = -S[p] - dg * avg[p] + A_prev[p];
  A_out[p] = acc;
}

template <typename T>
int launch(int route, long long begin, long long end, int mode, long long L,
           long long H, int n_off, const void* offsets, const void* planes,
           const void* const* in, void* avg, const void* recv_lo,
           const void* recv_hi, const void* rem_idx, int rem_w,
           void* const* out, cudaStream_t stream) {
  if (end == begin) return 0;
  unsigned blocks = (unsigned)((end - begin + kThreads - 1) / kThreads);
  const T* value = static_cast<const T*>(in[0]);
  const T* S = static_cast<const T*>(in[1]);
  const T* G = static_cast<const T*>(in[2]);
  const T* avg_prev = static_cast<const T*>(in[3]);
  const T* A_prev = static_cast<const T*>(in[4]);
  const T* inv = static_cast<const T*>(in[5]);
  const T* deg = static_cast<const T*>(in[6]);
  if (mode == 0) {
    sharded_fire_kernel<T><<<blocks, kThreads, 0, stream>>>(
        begin, end, value, S, A_prev, inv, static_cast<T*>(avg));
    return (int)cudaGetLastError();
  }
  if (mode != 1 || (route == 2 && (rem_idx == nullptr || rem_w <= 0)))
    return (int)cudaErrorInvalidValue;
  auto* o0 = static_cast<T*>(out[0]);
  auto* o1 = static_cast<T*>(out[1]);
  auto* o2 = static_cast<T*>(out[2]);
  const auto* off = static_cast<const int*>(offsets);
  const auto* pl = static_cast<const uint32_t*>(planes);
  const auto* a = static_cast<const T*>(avg);
  const auto* lo = static_cast<const T*>(recv_lo);
  const auto* hi = static_cast<const T*>(recv_hi);
  const auto* rem = static_cast<const int*>(rem_idx);
  if (route == 2)
    sharded_merge_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
        begin, end, L, H, n_off, off, pl, S, G, avg_prev, A_prev, deg, a, lo,
        hi, rem, rem_w, o0, o1, o2);
  else if (route == 0)
    sharded_merge_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
        begin, end, L, H, n_off, off, pl, S, G, avg_prev, A_prev, deg, a, lo,
        hi, nullptr, 0, o0, o1, o2);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float64; route: 0 none, 2 inline; mode: 0 fire,
// 1 merge.  Rows [row_begin, row_end) of a shard of L elements (tile-rows
// of 128); H = halo elements per side.  Node arrays are (L,), planes
// (ceil(n_off / 32), L) uint32, rem_idx (L, rem_w) int32 window coordinates,
// recv_lo and recv_hi (H,).  Fire reads value, S, A_prev, inv and writes
// avg; merge reads S, G, avg_prev, A_prev, deg, avg and the window and
// writes S_out, G_out, A_out.  Returns the cudaError_t of the launch.
extern "C" int sharded_round(int dtype, int route, long long row_begin,
                             long long row_end, int mode, long long L,
                             long long H, int n_off, const void* offsets,
                             const void* planes, const void* value,
                             const void* S, const void* G,
                             const void* avg_prev, const void* A_prev,
                             const void* inv, const void* deg, void* avg,
                             const void* recv_lo, const void* recv_hi,
                             const void* rem_idx, int rem_w, void* S_out,
                             void* G_out, void* A_out, void* stream) {
  if (row_begin < 0 || row_end < row_begin || row_end * kLane > L || H < 0 ||
      H > L || n_off < 0)
    return (int)cudaErrorInvalidValue;
  const void* in[7] = {value, S, G, avg_prev, A_prev, inv, deg};
  void* out[3] = {S_out, G_out, A_out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long begin = row_begin * kLane, end = row_end * kLane;
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
