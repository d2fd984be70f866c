// K2: one whole node-collapsed Flow-Updating round over a banded plan.
//
// Replaces the TPU kernel flow_updating_tpu/ops/pallas_round.py
// (_round_kernel, launched by fused_banded_round).  For every padded node
// p (and payload column b) one thread:
//
//   1. fires:     avg = (value - S + A_prev) * inv
//   2. delivers:  for each kept diagonal d, in plan order,
//                 acc = acc + (bit_d(p) ? avg[p + d] : 0)
//   3. remainder: 'inline' -> acc = acc + sum_j avg[rem(p, j)]
//                 'lanes'  -> acc = acc + a_rem[p]   (precomputed outside)
//   4. merges:    S' = -G - acc + deg * avg_prev
//                 G' = -S - deg * avg + A_prev
//
// and writes (S', G', avg, acc).  A neighbor's avg[p + d] is recomputed
// from value/S/A_prev/inv at p + d: the same elementwise arithmetic, hence
// bit-identical to the avg the neighbor computes for itself.  A band
// operand is read only when its bit is set; the planner sets a bit only
// for an edge, so every read stays inside [0, n) (the TPU kernel rolls
// circularly and never selects a wrapped lane; here nothing wraps).
//
// Bit-exactness with the unfused banded executor (plain PyTorch) needs the
// same operations in the same order and rounding: accumulation in plan
// order in the payload type, `acc + (bit ? v : 0)` performed for every
// diagonal, the 'lanes' addend added last, and no contraction of
// `deg * avg_prev` into an FMA — this file is compiled with -fmad=false.
// The 'inline' remainder sums each row left to right, an order the
// unfused executor does not share: it is exact on integer payloads only,
// as in the TPU kernel.
//
// What bounds it on an H100: bytes.  One round must read the five payload
// planes (value, S, G, avg_prev, A_prev), inv and deg, the bit planes and
// the remainder input, and write four payload planes.  Neighbor operands
// p + d lie within the plan's bandwidth of p, so they are served from L1/L2
// rather than re-read from HBM.  A shared-memory halo tile would remove
// the recomputation and is later work.
//
// Plain C interface, loaded with ctypes (flow_updating_tpu_torch/kernels).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ T fire(const T* __restrict__ value,
                                  const T* __restrict__ S,
                                  const T* __restrict__ A_prev,
                                  const T* __restrict__ inv, long long q,
                                  int D, int b) {
  long long i = q * D + b;
  return (value[i] - S[i] + A_prev[i]) * inv[q];
}

// ROUTE: 0 = no remainder, 1 = 'lanes' (a_rem input), 2 = 'inline'
template <typename T, int ROUTE>
__global__ void fused_round_kernel(
    long long P, int D, int n_off, const int* __restrict__ offsets,
    const uint32_t* __restrict__ planes, const T* __restrict__ value,
    const T* __restrict__ S, const T* __restrict__ G,
    const T* __restrict__ avg_prev, const T* __restrict__ A_prev,
    const T* __restrict__ inv, const T* __restrict__ deg,
    const T* __restrict__ a_rem, const int* __restrict__ rem_idx, int rem_w,
    long long tile, T* __restrict__ S_out, T* __restrict__ G_out,
    T* __restrict__ avg_out, T* __restrict__ A_out) {
  long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  int b = blockIdx.y;
  long long i = p * D + b;

  T avg = fire(value, S, A_prev, inv, p, D, b);

  T acc = T(0);
  for (int g = 0; g < n_off; ++g) {
    uint32_t word = planes[(long long)(g >> 5) * P + p];
    T v = T(0);
    if ((word >> (g & 31)) & 1u) v = fire(value, S, A_prev, inv, p + offsets[g], D, b);
    acc = acc + v;
  }

  if (ROUTE == 2) {
    // rem_idx holds window coordinates: offsets from the origin of the
    // [previous; own; next] tile window of p's tile, -1 for an empty slot
    long long origin = (p / tile - 1) * tile;
    const int* row = rem_idx + p * rem_w;
    T rs = T(0);
    for (int j = 0; j < rem_w; ++j) {
      int w = row[j];
      T v = T(0);
      if (w >= 0) v = fire(value, S, A_prev, inv, origin + w, D, b);
      rs = rs + v;
    }
    acc = acc + rs;
  }
  if (ROUTE == 1) acc = acc + a_rem[i];

  T dg = deg[p];
  S_out[i] = -G[i] - acc + dg * avg_prev[i];
  G_out[i] = -S[i] - dg * avg + A_prev[i];
  avg_out[i] = avg;
  A_out[i] = acc;
}

template <typename T, int ROUTE>
int launch_route(long long P, int D, int n_off, const void* offsets,
                 const void* planes, const void* const* in, const void* a_rem,
                 const void* rem_idx, int rem_w, long long tile,
                 void* const* out, cudaStream_t stream) {
  dim3 grid((unsigned)((P + kThreads - 1) / kThreads), (unsigned)D);
  fused_round_kernel<T, ROUTE><<<grid, kThreads, 0, stream>>>(
      P, D, n_off, static_cast<const int*>(offsets),
      static_cast<const uint32_t*>(planes), static_cast<const T*>(in[0]),
      static_cast<const T*>(in[1]), static_cast<const T*>(in[2]),
      static_cast<const T*>(in[3]), static_cast<const T*>(in[4]),
      static_cast<const T*>(in[5]), static_cast<const T*>(in[6]),
      static_cast<const T*>(a_rem), static_cast<const int*>(rem_idx), rem_w,
      tile, static_cast<T*>(out[0]), static_cast<T*>(out[1]),
      static_cast<T*>(out[2]), static_cast<T*>(out[3]));
  return (int)cudaGetLastError();
}

template <typename T>
int launch(int route, long long P, int D, int n_off, const void* offsets,
           const void* planes, const void* const* in, const void* a_rem,
           const void* rem_idx, int rem_w, long long tile, void* const* out,
           cudaStream_t stream) {
  if (P <= 0 || D <= 0) return 0;
  if (route == 0)
    return launch_route<T, 0>(P, D, n_off, offsets, planes, in, a_rem,
                              rem_idx, rem_w, tile, out, stream);
  if (route == 1)
    return launch_route<T, 1>(P, D, n_off, offsets, planes, in, a_rem,
                              rem_idx, rem_w, tile, out, stream);
  if (route == 2)
    return launch_route<T, 2>(P, D, n_off, offsets, planes, in, a_rem,
                              rem_idx, rem_w, tile, out, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = float64; route: 0 none, 1 lanes, 2 inline.
// Node arrays are (P, D) row-major (D = 1 for a scalar payload); inv and
// deg are (P,); planes is (ceil(n_off / 32), P) uint32; rem_idx is
// (P, rem_w) int32.  Returns the cudaError_t of the launch.
extern "C" int fused_round(int dtype, int route, long long P, int D,
                           int n_off, const void* offsets, const void* planes,
                           const void* value, const void* S, const void* G,
                           const void* avg_prev, const void* A_prev,
                           const void* inv, const void* deg,
                           const void* a_rem, const void* rem_idx, int rem_w,
                           long long tile, void* S_out, void* G_out,
                           void* avg_out, void* A_out, void* stream) {
  const void* in[7] = {value, S, G, avg_prev, A_prev, inv, deg};
  void* out[4] = {S_out, G_out, avg_out, A_out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(route, P, D, n_off, offsets, planes, in, a_rem,
                         rem_idx, rem_w, tile, out, s);
  if (dtype == 1)
    return launch<double>(route, P, D, n_off, offsets, planes, in, a_rem,
                          rem_idx, rem_w, tile, out, s);
  return (int)cudaErrorInvalidValue;
}
