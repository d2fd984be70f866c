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
// and does no arithmetic.  The local and window passes stage their tile
// (window: 2*tile elements) in shared memory and keep each thread's mask
// words and current values in registers, so a pass of up to 32 stages
// costs one trip through HBM and two __syncthreads() per stage.  The wide
// passes are coalesced elementwise kernels that read only the one source
// word each mask selects.  Offsets are 64-bit: batch * P passes 2^31 at
// the k=160 network with a batch.
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
           const Dists& ds, long long d1, long long d2, cudaStream_t stream) {
  if (kind == kLocal)
    return launch_staged<T, false>(x, out, mask, P, batch, tile, n_stages, ds,
                                   stream);
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
// (local, window); d1, d2: block distances (wide).  Returns the
// cudaError_t of the launch.
extern "C" int benes_pass(int kind, int elem_bytes, const void* x, void* out,
                          const void* mask, long long P, long long batch,
                          long long tile, int n_stages, const int* dists,
                          long long d1, long long d2, void* stream) {
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4)
    return launch<unsigned>(kind, x, out, mask, P, batch, (int)tile, shift,
                            n_stages, ds, d1, d2, s);
  if (elem_bytes == 8)
    return launch<unsigned long long>(kind, x, out, mask, P, batch, (int)tile,
                                      shift, n_stages, ds, d1, d2, s);
  return (int)cudaErrorInvalidValue;
}
