// B4: the segmented scan and the fill-forward passes of the edge kernel's
// segment networks.
//
// Replaces the TPU kernels of flow_updating_tpu/ops/pallas_fused.py:
// segscan_pass and fill_pass (both launched through _dist_window_call).
// Both run a list of stages at power-of-two distances d, ascending, over
// the network array x (batch rows of P values, sharing one int32 plane
// `dist` of P words: each edge's rank inside its CSR row, 0 on the
// padding), and derive every stage's mask from `dist` in the kernel:
//
//  * scan (sum, min, max):  x[p] = comb(x[p], dist[p] >= d ? x[p-d] : id)
//    — a segmented Hillis-Steele scan; id is 0 for sum and the type's
//    largest (min) or lowest (max) finite value, as the TPU kernel's;
//  * fill:                  x[p] = (dist[p] & d) ? x[p-d] : x[p]
//    — each run head's value copied over its run.
//
// One launch is one pass (ops/fused_passes.py, plan_dist_passes):
//
//  * window — up to 32 stages on the window [prev; own] of two tiles of
//    `tile` elements, prev = tile max(i - 1, 0), rolled circularly inside
//    the window (the TPU kernel's semantics, tile 0's window repeating
//    tile 0); the own half is written.  The own half is exact while the
//    stages' reach stays inside the window, which the planner's halo rule
//    guarantees, and dist[p] >= d implies p >= d, so no selected source
//    ever wraps;
//  * wide — one stage whose distance passes the window: an elementwise
//    select against x[(p - d) mod P].
//
// A stage always combines, even where its mask is off (a sum adds the
// identity 0), in the same stage order as the plain version, so a scan
// equals it bit for bit.  min and max follow torch.minimum/maximum on the
// card: a NaN operand wins, otherwise ::min / ::max.
//
// What bounds it on an H100: bytes.  A pass reads x and the dist plane
// once and writes x once.  Offsets are 64-bit.
//
//  * scan window pass (scan_chunk_pass).  A scan needs every stage's
//    values, not one source, so the stage loop stays, but only over what
//    can still reach the output.  Staging both whole tiles of x and dist
//    (64 KiB for float64) and running every stage over the whole window,
//    two barriers a stage, one block per (tile, batch row), cost 6.4x the
//    bytes' time.  Here a block owns a chunk of C = 1,024 outputs (the
//    tile, if smaller) and stages only the window positions [own - L,
//    own + C), L = sum(d) rounded up to whole packs: the halo below is
//    what the stages can carry into the chunk.  Stage j runs only over
//    [own - (d_{j+1} + ... + d_last), own + C), what the later stages
//    still read, between two shared-memory buffers in turn, so one
//    barrier a stage.  Once the stages were cheap in barriers and bytes,
//    they were bound by instructions (one value a thread and stage: the
//    loads, selects and index tests of each): so a thread holds packs of
//    16 bytes of consecutive positions (one value below a 16-byte tile or
//    on unaligned pointers) with their dist words in registers, and a
//    stage costs it one vector load from shared memory (two where d is
//    not a multiple of the pack; none where d is below it, the pack being
//    its own), the selects and combines, and one vector store.  The dist
//    words are read once for every batch row.  A thread holds as many
//    packs as its registers take (8 positions): 160 threads hold path
//    D's chunk and its halo.  Where L + C
//    passes 2,048 positions (never on a planned pass of the card's tile,
//    whose sum(d) stays below the tile) a block of up to 1,024 threads
//    owns a whole tile, and where the halo reaches round the window
//    (L + C >= 2 tile) it runs every stage over the whole window,
//    circularly, as the plain version does.
//  * fill window pass (fill_walk_pass).  The fill only moves data, so
//    each output has exactly one source, and the kernel finds it first:
//    from w = tile + (p mod tile), for the stages from last to first,
//    w = (w - d) mod 2*tile where dist at window position w has bit d.
//    Then out[b, p] = x[b, g(w)] for every batch row b, g mapping a
//    window position to its global index.  That is the stage loop read
//    backwards, so it is exact on any dist plane, tile 0 and the wrap
//    inside the window included.  Staging both tiles of x and dist and
//    running every stage over the whole window cost 5 words per output
//    and two barriers per stage; here a block of 256 threads owns 1,024
//    outputs, only the dist words their walks can reach (the chunk plus
//    sum(d) words below it) go to shared memory, the batch rows share
//    one walk, and each row costs one read of x (mostly run heads, which
//    L2 serves) and one write.  Small blocks keep many of them resident,
//    so one block's loads overlap another's walk.
//  * wide passes (seg_wide_pass) select elementwise against x[p - d].
//
// Plain C interface, loaded with ctypes (flow_updating_tpu_torch/kernels).

#include <cfloat>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxStages = 32;
constexpr long long kMaxTile = 4096;                     // elements
constexpr int kScanChunk = 1024;                         // outputs per block
constexpr int kScanPer = 8;      // window positions per thread, at most
constexpr int kScanThreads = 1024;                       // at most
constexpr int kWideThreads = 256;
constexpr int kFillThreads = 256;
constexpr int kFillPer = 4;                              // outputs per thread

enum Op { kSum = 0, kMin = 1, kMax = 2, kFill = 3 };

struct Dists {
  int d[kMaxStages];
};

template <typename T> struct Limits;
template <> struct Limits<float> {
  __device__ static float hi() { return FLT_MAX; }
  __device__ static float lo() { return -FLT_MAX; }
};
template <> struct Limits<double> {
  __device__ static double hi() { return DBL_MAX; }
  __device__ static double lo() { return -DBL_MAX; }
};
template <> struct Limits<int> {
  __device__ static int hi() { return INT_MAX; }
  __device__ static int lo() { return INT_MIN; }
};

template <typename T>
__device__ __forceinline__ bool is_nan(T v) { return v != v; }

template <typename T, int kOp>
__device__ __forceinline__ T identity() {
  if (kOp == kMin) return Limits<T>::hi();
  if (kOp == kMax) return Limits<T>::lo();
  return T(0);
}

// comb(a, b): a is the running value, b the taken one (torch argument
// order, which decides which NaN wins)
template <typename T, int kOp>
__device__ __forceinline__ T comb(T a, T b) {
  if (kOp == kSum) return a + b;
  if (is_nan(a)) return a;
  if (is_nan(b)) return b;
  return kOp == kMin ? ::min(a, b) : ::max(a, b);
}

// E consecutive values (16 bytes, or one value on unaligned pointers or
// below a 16-byte tile), moved as one load or store.
template <typename T, int E>
struct alignas(E * sizeof(T)) Pack {
  T v[E];
};

// One stage over this thread's packs, R = d mod E: element e of pack q
// takes position E q + e - d, element e - R of pack q - d / E (this
// thread's own pack where d < E, still in registers) or, for e < R,
// element E + e - R of the pack before it.  Pack indices wrap mod the
// span: only where a read can wrap (the whole window), or for elements
// below the stage's start, whose values no output reads.
template <int R, int kOp, typename T, int E, int K>
__device__ __forceinline__ void scan_stage(Pack<T, E> (&v)[K],
                                           const Pack<int, E> (&dv)[K],
                                           const Pack<T, E>* in,
                                           Pack<T, E>* to, int packs,
                                           int per, int lo, int d,
                                           bool last) {
  const int D = d / E;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int q = threadIdx.x + k * blockDim.x;
    if (k >= per || q >= packs || q < lo) continue;
    int qh = q - D;
    if (qh < 0) qh += packs;
    Pack<T, E> hi = v[k];
    if (D) hi = in[qh];
    Pack<T, E> below = hi;
    if (R) below = in[qh > 0 ? qh - 1 : packs - 1];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const T src = e >= R ? hi.v[(e - R) & (E - 1)]
                           : below.v[(E + e - R) & (E - 1)];
      // a stage always combines, with the identity where its mask is
      // off, as the plain version
      v[k].v[e] = comb<T, kOp>(v[k].v[e], dv[k].v[e] >= d
                                              ? src : identity<T, kOp>());
    }
    if (!last) to[q] = v[k];
  }
}

// The scan's window pass (see the header).  Block b owns the outputs
// [c0, c0 + chunk) of one tile and the `span` window positions ending at
// the chunk's end: local position p is window position (first + p) mod
// 2 * tile.  A thread holds packs q = threadIdx.x + k * blockDim.x of E
// positions (p = E q ...).  Stage j updates the packs from start[j] on,
// reading from the buffer the stage before wrote.
template <typename T, int kOp, int E>
__global__ void __launch_bounds__(kScanThreads)
scan_chunk_pass(const T* __restrict__ x, T* __restrict__ out,
                const int* __restrict__ dist, long long P, long long batch,
                int log2_tile, int chunk, int span, int per, int n_stages,
                Dists ds, Dists start) {
  constexpr int K = kScanPer / E;   // packs per thread, at most
  using V = Pack<T, E>;
  using I = Pack<int, E>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* buf = reinterpret_cast<V*>(smem_raw);  // two buffers of span values
  __shared__ int sdist[kMaxStages], sstart[kMaxStages];
  if (threadIdx.x == 0) {
    // constant indices: a runtime index into the parameter would make
    // every thread copy it to local memory
#pragma unroll
    for (int j = 0; j < kMaxStages; ++j) {
      sdist[j] = ds.d[j];
      sstart[j] = start.d[j];
    }
  }
  const int tile = 1 << log2_tile;
  const int packs = span / E;
  const long long c0 = (long long)blockIdx.x * chunk;
  const long long blk = c0 >> log2_tile;
  // window position of local 0 (the chunk's outputs are the last `chunk`
  // local positions), and the global index of window position w:
  // row0 + (w & wrap0), (blk - 1) * tile + w mod 2 * tile, or for tile 0,
  // whose window repeats it, w mod tile
  const int first = tile + (int)(c0 - blk * tile) + chunk - span;
  const long long row0 = blk > 0 ? (blk - 1) * tile : 0;
  const int wrap0 = blk > 0 ? 2 * tile - 1 : tile - 1;
  I dv[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int q = threadIdx.x + k * blockDim.x;
    if (k < per && q < packs)
      dv[k] = *reinterpret_cast<const I*>(
          dist + row0 + ((first + E * q) & wrap0));
  }
  const int lead = (span - chunk) / E;  // the first output pack
  for (long long b = 0; b < batch; ++b) {
    const T* xb = x + b * P;
    V v[K];
    // the row before may still read either buffer in its last stage
    if (b > 0) __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = threadIdx.x + k * blockDim.x;
      if (k < per && q < packs) {
        v[k] = *reinterpret_cast<const V*>(
            xb + row0 + ((first + E * q) & wrap0));
        buf[q] = v[k];
      }
    }
    __syncthreads();
    for (int j = 0; j < n_stages; ++j) {
      const int d = sdist[j], lo = sstart[j];
      const V* in = buf + (j & 1) * packs;
      V* to = buf + ((j + 1) & 1) * packs;
      const bool last = j + 1 == n_stages;
      switch (d & (E - 1)) {
        case 0:
          scan_stage<0, kOp>(v, dv, in, to, packs, per, lo, d, last);
          break;
        case 1:
          scan_stage<(E > 1 ? 1 : 0), kOp>(v, dv, in, to, packs, per, lo,
                                           d, last);
          break;
        case 2:
          scan_stage<(E > 2 ? 2 : 0), kOp>(v, dv, in, to, packs, per, lo,
                                           d, last);
          break;
        default:
          scan_stage<(E > 3 ? 3 : 0), kOp>(v, dv, in, to, packs, per, lo,
                                           d, last);
      }
      if (!last) __syncthreads();
    }
    V* ob = reinterpret_cast<V*>(out + b * P + c0);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = threadIdx.x + k * blockDim.x;
      if (k < per && q < packs && q >= lead) ob[q - lead] = v[k];
    }
  }
}

// The fill's window pass: each output's source found by walking the
// stages backwards (see the header).  A block owns a chunk of one tile's
// outputs and keeps in shared memory the dist words of the window
// positions its walks can reach: the chunk and the `reach` = sum(d)
// positions below it when that sum is below the tile (kWrap false: no
// walk then leaves the range or wraps), else the whole window [prev; own].
template <typename T, bool kWrap>
__global__ void __launch_bounds__(kFillThreads)
fill_walk_pass(const T* __restrict__ x, T* __restrict__ out,
               const int* __restrict__ dist, long long P, long long batch,
               int log2_tile, int chunk, int per, int n_stages, Dists ds,
               int reach) {
  extern __shared__ int sd[];
  __shared__ int sdist[kMaxStages];
  if (threadIdx.x == 0) {
    // constant indices: a runtime index into the parameter would make
    // every thread copy it to local memory
#pragma unroll
    for (int j = 0; j < kMaxStages; ++j) sdist[j] = ds.d[j];
  }
  const int tile = 1 << log2_tile;
  const long long c0 = (long long)blockIdx.x * chunk;
  const long long blk = c0 >> log2_tile;
  const long long prev = blk > 0 ? blk - 1 : 0;
  const int own = tile + (int)(c0 - blk * tile);  // window position of c0
  const int lo = kWrap ? 0 : own - reach;
  const int hi = kWrap ? 2 * tile : own + chunk;
  for (int q = lo + threadIdx.x; q < hi; q += blockDim.x)
    sd[q - lo] = dist[q < tile ? prev * tile + q : blk * tile + (q - tile)];
  __syncthreads();
  int w[kFillPer];  // window position - lo
#pragma unroll
  for (int k = 0; k < kFillPer; ++k)
    w[k] = own + threadIdx.x + k * blockDim.x - lo;
  for (int j = n_stages - 1; j >= 0; --j) {
    const int d = sdist[j];
#pragma unroll
    for (int k = 0; k < kFillPer; ++k) {
      if (k >= per || !(sd[w[k]] & d)) continue;
      w[k] = kWrap ? (w[k] - d) & (2 * tile - 1) : w[k] - d;
    }
  }
  long long src[kFillPer];
#pragma unroll
  for (int k = 0; k < kFillPer; ++k) {
    const int q = w[k] + lo;
    src[k] = q < tile ? prev * tile + q : blk * tile + (q - tile);
  }
  for (long long b = 0; b < batch; ++b) {
    const T* xb = x + b * P;
    T* ob = out + b * P + c0;
#pragma unroll
    for (int k = 0; k < kFillPer; ++k)
      if (k < per) ob[threadIdx.x + k * blockDim.x] = xb[src[k]];
  }
}

template <typename T, int kOp>
__global__ void seg_wide_pass(const T* __restrict__ x,
                              T* __restrict__ out,
                              const int* __restrict__ dist, long long P,
                              int d) {
  const T* xb = x + (long long)blockIdx.y * P;
  T* ob = out + (long long)blockIdx.y * P;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < P; p += (long long)gridDim.x * blockDim.x) {
    const long long src = p >= d ? p - d : p - d + P;
    const int dv = dist[p];
    const T cur = xb[p];
    // the source word is read only where the mask takes it
    if (kOp == kFill)
      ob[p] = (dv & d) ? xb[src] : cur;
    else
      ob[p] = comb<T, kOp>(cur, dv >= d ? xb[src] : identity<T, kOp>());
  }
}

template <typename T, int kOp>
int launch_wide(const T* x, T* out, const int* dist, long long P,
                long long batch, int d, cudaStream_t stream) {
  long long blocks = (P + kWideThreads - 1) / kWideThreads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  dim3 grid((unsigned)blocks, (unsigned)batch);
  seg_wide_pass<T, kOp><<<grid, kWideThreads, 0, stream>>>(x, out, dist, P,
                                                           d);
  return (int)cudaGetLastError();
}

// The scan's window pass: packs of E values (16 bytes where the tile and
// the pointers allow), then chunk, span (see scan_chunk_pass) and block
// size from the stages' reach, sum(d), rounded up to whole packs.
template <typename T, int kOp, int E>
int launch_scan(const T* x, T* out, const int* dist, long long P,
                long long batch, int tile, int n_stages, const Dists& ds,
                cudaStream_t stream) {
  long long reach = 0;
  for (int j = 0; j < n_stages; ++j) reach += ds.d[j];
  const long long lead = (reach + E - 1) / E * E;
  int chunk = tile < kScanChunk ? tile : kScanChunk;
  long long span = lead + chunk < 2 * tile ? lead + chunk : 2 * tile;
  if (span > 2 * kScanChunk) {
    chunk = tile;
    span = lead + tile < 2 * tile ? lead + tile : 2 * tile;
  }
  // every thread holds as many packs as its registers take (one pack a
  // thread measured 1.4-2.5x slower, scripts/torch_b4_variants.py)
  constexpr int K = kScanPer / E;
  const int packs = (int)(span / E);
  const int threads = (packs + K - 1) / K < kScanThreads
                          ? ((packs + K - 1) / K + 31) / 32 * 32
                          : kScanThreads;
  // stage j runs from local position (span - chunk) - (d_{j+1} + ... +
  // d_last) on, from the pack that holds it
  Dists start = {};
  long long later = 0;
  for (int j = n_stages - 1; j >= 0; --j) {
    const long long lo = span - chunk - later;
    start.d[j] = lo > 0 ? (int)(lo / E) : 0;
    later += ds.d[j];
  }
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        scan_chunk_pass<T, kOp, E>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(4 * kMaxTile * sizeof(T)));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  int log2_tile = 0;
  while ((1 << log2_tile) < tile) ++log2_tile;
  scan_chunk_pass<T, kOp, E>
      <<<(unsigned)(P / chunk), threads, 2 * (size_t)span * sizeof(T),
         stream>>>(x, out, dist, P, batch, log2_tile, chunk, (int)span,
                   (packs + threads - 1) / threads, n_stages, ds, start);
  return (int)cudaGetLastError();
}

template <typename T, int kOp>
int launch_op(const void* x, void* out, const int* dist, long long P,
              long long batch, int tile, int n_stages, const Dists& ds,
              bool wide, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (wide)
    return launch_wide<T, kOp>(xt, ot, dist, P, batch, ds.d[0], stream);
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<size_t>(x) % 16 == 0 &&
                       reinterpret_cast<size_t>(out) % 16 == 0 &&
                       reinterpret_cast<size_t>(dist) % 16 == 0;
  if (tile % kVec == 0 && aligned)
    return launch_scan<T, kOp, kVec>(xt, ot, dist, P, batch, tile, n_stages,
                                     ds, stream);
  return launch_scan<T, kOp, 1>(xt, ot, dist, P, batch, tile, n_stages, ds,
                                stream);
}

template <typename T>
int launch_fill(const void* x, void* out, const int* dist, long long P,
                long long batch, int tile, int n_stages, const Dists& ds,
                bool wide, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (wide)
    return launch_wide<T, kFill>(xt, ot, dist, P, batch, ds.d[0], stream);
  long long sum = 0;
  for (int j = 0; j < n_stages; ++j) sum += ds.d[j];
  const bool wrap = sum >= tile;
  const int chunk = tile < kFillThreads * kFillPer ? tile
                                                   : kFillThreads * kFillPer;
  const int threads = chunk < kFillThreads ? chunk : kFillThreads;
  int log2_tile = 0;
  while ((1 << log2_tile) < tile) ++log2_tile;
  const size_t smem = (wrap ? 2 * (size_t)tile : chunk + sum) * sizeof(int);
  const unsigned grid = (unsigned)(P / chunk);
  if (wrap)
    fill_walk_pass<T, true><<<grid, threads, smem, stream>>>(
        xt, ot, dist, P, batch, log2_tile, chunk, chunk / threads, n_stages,
        ds, 0);
  else
    fill_walk_pass<T, false><<<grid, threads, smem, stream>>>(
        xt, ot, dist, P, batch, log2_tile, chunk, chunk / threads, n_stages,
        ds, (int)sum);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(int op, const void* x, void* out, const int* dist, long long P,
           long long batch, int tile, int n_stages, const Dists& ds,
           bool wide, cudaStream_t stream) {
  switch (op) {
    case kSum:
      return launch_op<T, kSum>(x, out, dist, P, batch, tile, n_stages, ds,
                                wide, stream);
    case kMin:
      return launch_op<T, kMin>(x, out, dist, P, batch, tile, n_stages, ds,
                                wide, stream);
    case kMax:
      return launch_op<T, kMax>(x, out, dist, P, batch, tile, n_stages, ds,
                                wide, stream);
    case kFill:
      return launch_fill<T>(x, out, dist, P, batch, tile, n_stages, ds, wide,
                            stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// op: 0 scan-sum, 1 scan-min, 2 scan-max, 3 fill.  dtype: 0 float32,
// 1 float64, 2 int32.  x, out: batch * P values; dist: P int32 words.
// wide = 0: a window pass of n_stages (<= 32) stages at the host array
// dists (each < 2 * tile); wide = 1: one stage at dists[0] (< P).
// Returns the cudaError_t of the launch.
extern "C" int seg_scan(int op, int dtype, const void* x, void* out,
                        const void* dist, long long P, long long batch,
                        long long tile, int n_stages, const int* dists,
                        int wide, void* stream) {
  if (P <= 0 || batch <= 0 || batch > 65535 || tile <= 0 ||
      (tile & (tile - 1)) || P % tile || tile > kMaxTile || n_stages < 1 ||
      n_stages > kMaxStages || (wide && n_stages != 1))
    return (int)cudaErrorInvalidValue;
  Dists ds = {};
  const long long limit = wide ? P : 2 * tile;
  for (int j = 0; j < n_stages; ++j) {
    if (dists[j] <= 0 || dists[j] >= limit) return (int)cudaErrorInvalidValue;
    ds.d[j] = dists[j];
  }
  const int* dp = static_cast<const int*>(dist);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(op, x, out, dp, P, batch, (int)tile, n_stages, ds,
                         wide != 0, s);
  if (dtype == 1)
    return launch<double>(op, x, out, dp, P, batch, (int)tile, n_stages, ds,
                          wide != 0, s);
  if (dtype == 2)
    return launch<int>(op, x, out, dp, P, batch, (int)tile, n_stages, ds,
                       wide != 0, s);
  return (int)cudaErrorInvalidValue;
}
