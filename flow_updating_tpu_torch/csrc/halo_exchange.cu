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
//     recv_b[j] = src_b[j] for every element j of every incoming block b,
//     grid-stride, one element per thread; the k (source, destination,
//     length) triples are a table passed by value.
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
// written once; the merge reads hit (1 byte a cell), the two payload
// planes and the three ring-buffer planes once and writes three.  There is
// no arithmetic.  A simple grid-stride loop, one element (block pull) or
// one cell (merge) per thread; in-kernel `hit` (from lrev, the send mask,
// delay and t) and a fused frontier finish are later work.
//
// Plain C interface, loaded with ctypes (flow_updating_tpu_torch/kernels).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 32;           // = ops/halo_exchange.MAX_BLOCKS
constexpr long long kMaxGrid = 4096;     // thread blocks per part

struct PullTable {
  const void* src[kMaxBlocks];
  void* dst[kMaxBlocks];
  long long end[kMaxBlocks];             // running sum of the lengths
  int k;
};

template <typename T>
__global__ void exchange_kernel(PullTable pull, long long n_copy,
                                int copy_blocks, long long cells,
                                long long Eb, int nf,
                                const uint8_t* __restrict__ hit,
                                const T* __restrict__ pay_flow,
                                const T* __restrict__ pay_est,
                                const T* __restrict__ buf_flow,
                                const T* __restrict__ buf_est,
                                const uint8_t* __restrict__ buf_valid,
                                T* __restrict__ out_flow,
                                T* __restrict__ out_est,
                                uint8_t* __restrict__ out_valid) {
  if ((int)blockIdx.x < copy_blocks) {
    const long long stride = (long long)copy_blocks * blockDim.x;
    int b = 0;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n_copy; i += stride) {
      while (i >= pull.end[b]) ++b;      // i only grows: b never goes back
      const long long j = i - (b ? pull.end[b - 1] : 0);
      static_cast<T*>(pull.dst[b])[j] =
          static_cast<const T*>(pull.src[b])[j];
    }
    return;
  }
  const long long merge_blocks = (long long)gridDim.x - copy_blocks;
  const long long stride = merge_blocks * blockDim.x;
  for (long long c = ((long long)blockIdx.x - copy_blocks) * blockDim.x +
                     threadIdx.x;
       c < cells; c += stride) {
    const uint8_t h = hit[c];
    const long long e = c % Eb;
    for (int f = 0; f < nf; ++f) {
      const long long o = c * nf + f;
      out_flow[o] = h ? pay_flow[e * nf + f] : buf_flow[o];
      out_est[o] = h ? pay_est[e * nf + f] : buf_est[o];
    }
    out_valid[c] = buf_valid[c] | h;
  }
}

long long grid_for(long long n) {
  long long g = (n + kThreads - 1) / kThreads;
  return g < kMaxGrid ? g : kMaxGrid;
}

template <typename T>
cudaError_t launch(int k, const long long* src, const long long* dst,
                   const long long* count, long long cells, long long Eb,
                   int nf, const void* hit, const void* pay_flow,
                   const void* pay_est, const void* buf_flow,
                   const void* buf_est, const void* buf_valid,
                   void* out_flow, void* out_est, void* out_valid,
                   cudaStream_t stream) {
  PullTable pull{};
  long long n_copy = 0;
  for (int b = 0; b < k; ++b) {
    pull.src[b] = reinterpret_cast<const void*>(src[b]);
    pull.dst[b] = reinterpret_cast<void*>(dst[b]);
    n_copy += count[b];
    pull.end[b] = n_copy;
  }
  pull.k = k;
  const int copy_blocks = (int)grid_for(n_copy);
  const long long grid = copy_blocks + grid_for(cells);
  if (grid == 0) return cudaSuccess;
  exchange_kernel<T><<<(unsigned)grid, kThreads, 0, stream>>>(
      pull, n_copy, copy_blocks, cells, Eb, nf,
      static_cast<const uint8_t*>(hit), static_cast<const T*>(pay_flow),
      static_cast<const T*>(pay_est), static_cast<const T*>(buf_flow),
      static_cast<const T*>(buf_est), static_cast<const uint8_t*>(buf_valid),
      static_cast<T*>(out_flow), static_cast<T*>(out_est),
      static_cast<uint8_t*>(out_valid));
  return cudaGetLastError();
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
  if (k < 0 || k > kMaxBlocks || Eb < 1 || nf < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(k, src, dst, count, cells, Eb, nf, hit, pay_flow,
                        pay_est, buf_flow, buf_est, buf_valid, out_flow,
                        out_est, out_valid, s);
  else if (dtype == 1)
    err = launch<double>(k, src, dst, count, cells, Eb, nf, hit, pay_flow,
                         pay_est, buf_flow, buf_est, buf_valid, out_flow,
                         out_est, out_valid, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
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
