// K1: degree-bucketed ELL neighbor sum, out[r] = sum_j x[idx[r, j]].
//
// Replaces the TPU kernel flow_updating_tpu/ops/pallas_spmv.py
// (_spmv_bucket_kernel).  One launch covers one degree bucket: a dense
// (rows, width) int32 index matrix, row-major, whose entries lie in
// [0, zero_slot]; the index zero_slot (= len(x)) stands for a zero, so no
// padded copy concat(x, 0) is built per round.
//
// What bounds it on an H100: bytes.  Each row reads its `width` indices
// once (coalesced) and gathers `width` values of x; x itself is a few MB
// at a million nodes and stays in the 50 MB L2, so the index stream is
// the HBM traffic that matters.  Narrow buckets (most nodes of the
// fat-tree have degree 1) take one thread per row, wide buckets (the
// switches, width 160) one warp per row so the index reads of a row are
// one coalesced sweep.  Every row is summed in a fixed order (a thread:
// left to right; a warp: each lane left to right over its strided
// columns, then a fixed shuffle tree), so reruns are bit-reproducible.
//
// Plain C interface, loaded with ctypes (flow_updating_tpu_torch/kernels).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// buckets at least this wide take one warp per row
constexpr int kWarpRowWidth = 16;

template <typename T>
__global__ void spmv_ell_thread_rows(const T* __restrict__ x,
                                     const int* __restrict__ idx,
                                     T* __restrict__ out, long long rows,
                                     int width, long long zero_slot) {
  long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const int* row = idx + r * width;
  T acc = T(0);
  for (int j = 0; j < width; ++j) {
    long long c = __ldg(row + j);
    if (c < zero_slot) acc += __ldg(x + c);
  }
  out[r] = acc;
}

template <typename T>
__global__ void spmv_ell_warp_rows(const T* __restrict__ x,
                                   const int* __restrict__ idx,
                                   T* __restrict__ out, long long rows,
                                   int width, long long zero_slot) {
  long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  // r is uniform across the warp (blockDim is a multiple of 32), so the
  // whole warp leaves together and the shuffles below see all 32 lanes
  if (r >= rows) return;
  const int* row = idx + r * width;
  T acc = T(0);
  for (int j = lane; j < width; j += 32) {
    long long c = __ldg(row + j);
    if (c < zero_slot) acc += __ldg(x + c);
  }
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  if (lane == 0) out[r] = acc;
}

template <typename T>
int launch(const void* x, const int* idx, void* out, long long rows,
           int width, long long zero_slot, cudaStream_t stream) {
  if (rows <= 0) return 0;
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (width >= kWarpRowWidth) {
    long long blocks = (rows * 32 + kThreads - 1) / kThreads;
    spmv_ell_warp_rows<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
        xt, idx, ot, rows, width, zero_slot);
  } else {
    long long blocks = (rows + kThreads - 1) / kThreads;
    spmv_ell_thread_rows<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
        xt, idx, ot, rows, width, zero_slot);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  Returns the cudaError_t of the launch.
extern "C" int spmv_ell(int dtype, const void* x, const void* idx, void* out,
                        long long rows, int width, long long zero_slot,
                        void* stream) {
  const int* id = static_cast<const int*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, id, out, rows, width, zero_slot, s);
  if (dtype == 1) return launch<double>(x, id, out, rows, width, zero_slot, s);
  return (int)cudaErrorInvalidValue;
}
