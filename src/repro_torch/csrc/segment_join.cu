// Hopper (sm_90a) kernels for the relational engine's join and group-by
// cores: segment sum, stable radix rank, hash-table build and probe.
//
// Each exported function has a plain C interface (raw device pointers, an
// int64 row count and the caller's CUDA stream), launches on that stream,
// never synchronises and allocates nothing: the Python wrapper in
// repro_torch/kernels/segment_join/kernel.py allocates outputs and scratch
// with torch.empty / torch.zeros.  Every function returns cudaGetLastError()
// so a refused launch (too much shared memory, a bad grid) is reported at
// the call site instead of vanishing.
//
// The TPU versions (src/repro/kernels/segment_join/kernel.py) express every
// data-dependent scatter and gather as a one-hot masked matmul over VMEM
// tiles, because that is what the TPU's matrix unit runs well.  Hopper has
// no reason to: a table in device memory addressed directly, with atomics,
// does the same work in O(N) bytes and no arithmetic to speak of.  All four
// kernels are therefore bound by memory traffic, not by operations.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

inline int grid_for(long long n, int threads, int max_blocks) {
  long long blocks = (n + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > max_blocks) blocks = max_blocks;
  return static_cast<int>(blocks);
}

// ---------------------------------------------------------------------------
// segment_sum: sums[s] = sum of values[i] over rows with seg_ids[i] == s
//
// Replaces segment_join/kernel.py::segment_sum_pallas (one-hot matmul into a
// VMEM-resident [num_segments] accumulator, num_segments <= 4096 there).
// Bound: bytes -- reads 4 + 8 bytes per row, writes 8 bytes per segment.
// Design: each warp reads 32 consecutive rows per step (coalesced) and
// reduces runs of equal segment ids inside the warp with a segmented
// shuffle scan, so a sorted id stream (the group-by case) issues one
// float64 atomicAdd per run per 32 rows instead of one per row.  Ids outside
// [0, num_segments) are dropped, as jax.ops.segment_sum drops them.  The
// order of the atomics varies from run to run, so results agree with a
// sequential sum to rounding (counts, sums of 1.0, are exact).
// ---------------------------------------------------------------------------
__global__ void segment_sum_f64_kernel(const int32_t* __restrict__ seg,
                                       const double* __restrict__ vals,
                                       long long n, double* __restrict__ out,
                                       int num_segments) {
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x) >> 5;
  const long long num_warps =
      (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  const unsigned lower_and_me =
      (lane == 31) ? kFullMask : ((1u << (lane + 1)) - 1u);
  for (long long base = warp * 32; base < n; base += num_warps * 32) {
    const long long i = base + lane;
    int s = -1;
    double v = 0.0;
    if (i < n) {
      s = seg[i];
      v = vals[i];
      if (s < 0 || s >= num_segments) s = -1;
    }
    const int prev = __shfl_up_sync(kFullMask, s, 1);
    const int next = __shfl_down_sync(kFullMask, s, 1);
    const bool head = (lane == 0) || (s != prev);
    const bool tail = (lane == 31) || (s != next);
    const unsigned heads = __ballot_sync(kFullMask, head);
    const int start = 31 - __clz(heads & lower_and_me);
    for (int d = 1; d < 32; d <<= 1) {
      const double o = __shfl_up_sync(kFullMask, v, d);
      if (lane - d >= start) v += o;
    }
    if (tail && s >= 0) atomicAdd(&out[s], v);
  }
}

// ---------------------------------------------------------------------------
// radix_rank: stable rank of each row within its bucket + bucket histogram
//
// Replaces segment_join/kernel.py::radix_rank_pallas, whose sequential TPU
// grid carries the running per-bucket base from tile to tile.  Hopper's
// blocks run in no order, so the carry becomes an explicit scan:
//   1. per-tile histograms (shared-memory atomics; order is irrelevant for
//      counts), written row-major as hist[tile][bucket];
//   2. one thread per bucket walks the tiles in order and turns its column
//      into exclusive per-tile bases, leaving the total in counts[bucket];
//   3. one warp per tile walks its rows in order, 32 at a time: lanes with
//      the same bucket find each other with __match_any_sync, a lane's rank
//      is the base plus the number of lower lanes in its group, and the
//      group's lowest lane advances the base.  Walking in row order is what
//      makes the rank stable; atomics alone would not be.
// Ids outside [0, num_buckets) get rank 0 and are not counted (the padding
// contract of the TPU kernel).
// Bound: bytes -- the ids are read twice and the ranks written once; the
// tile histograms add 4 x tiles x buckets x 4 bytes of traffic (written,
// read and rewritten by the scan, read by the rank pass), which the
// tile size keeps near the size of the ids.  The per-tile base table lives
// in shared memory when it fits (dynamic shared memory, opted in above
// 48 KB), else the warp works on its row of the global histogram in place.
// ---------------------------------------------------------------------------
__global__ void radix_hist_kernel(const int32_t* __restrict__ ids, long long n,
                                  int num_buckets, int tile, int use_smem,
                                  int32_t* __restrict__ hist) {
  extern __shared__ int32_t sh[];
  const long long t = blockIdx.x;
  // each block owns its tile's row, so it zeroes the counts it adds into
  // (the caller's scratch is uninitialised)
  int32_t* h = use_smem ? sh : hist + t * num_buckets;
  for (int b = threadIdx.x; b < num_buckets; b += blockDim.x) h[b] = 0;
  __syncthreads();
  const long long lo = t * tile;
  long long hi = lo + tile;
  if (hi > n) hi = n;
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const int b = ids[i];
    if (b >= 0 && b < num_buckets) atomicAdd(&h[b], 1);
  }
  if (use_smem) {
    __syncthreads();
    int32_t* row = hist + t * num_buckets;
    for (int b = threadIdx.x; b < num_buckets; b += blockDim.x) row[b] = h[b];
  }
}

__global__ void radix_scan_kernel(int32_t* __restrict__ hist, int num_tiles,
                                  int num_buckets,
                                  int32_t* __restrict__ counts) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= num_buckets) return;
  int32_t running = 0;
  for (int t = 0; t < num_tiles; ++t) {
    int32_t* cell = hist + static_cast<long long>(t) * num_buckets + b;
    const int32_t v = *cell;
    *cell = running;
    running += v;
  }
  counts[b] = running;
}

__global__ void radix_rank_kernel(const int32_t* __restrict__ ids, long long n,
                                  int num_buckets, int tile, int use_smem,
                                  int32_t* __restrict__ hist,
                                  int32_t* __restrict__ rank) {
  extern __shared__ int32_t sh[];
  const long long t = blockIdx.x;
  const int lane = threadIdx.x;  // one warp per tile
  int32_t* row = hist + t * num_buckets;
  int32_t* h = use_smem ? sh : row;
  if (use_smem) {
    for (int b = lane; b < num_buckets; b += 32) h[b] = row[b];
    __syncwarp();
  }
  const unsigned lower = (1u << lane) - 1u;
  const long long lo = t * tile;
  long long hi = lo + tile;
  if (hi > n) hi = n;
  for (long long base = lo; base < hi; base += 32) {
    const long long i = base + lane;
    int b = -1;
    if (i < hi) {
      b = ids[i];
      if (b < 0 || b >= num_buckets) b = -1;
    }
    const unsigned peers = __match_any_sync(kFullMask, b);
    const int leader = __ffs(peers) - 1;
    int32_t start = 0;
    if (lane == leader && b >= 0) {
      start = h[b];
      h[b] = start + __popc(peers);
    }
    start = __shfl_sync(kFullMask, start, leader);
    __syncwarp();
    if (i < hi) rank[i] = (b >= 0) ? start + __popc(peers & lower) : 0;
  }
}

// ---------------------------------------------------------------------------
// join_table_build: cnt[c] = build rows with code c; inv[c] = largest
// brow + 1 (0 = empty slot); codes outside [0, domain_pad) are ignored.
//
// Replaces segment_join/kernel.py::join_table_build_pallas (2-D grid of row
// tiles x domain blocks, one-hot sums and maxima, with block skipping).
// Bound: bytes -- 8 bytes read per build row plus the table's atomics.
// Design: one thread per build row, atomicAdd for the count and atomicMax
// for the row id.  The caller zeroes both tables.  The max makes "the
// largest build row wins" deterministic whatever order the atomics land in.
// Radix-ordered input (the caller's radix_partition pass) clusters the
// atomics of neighbouring threads into a few cache lines.
// ---------------------------------------------------------------------------
__global__ void join_table_build_kernel(const int32_t* __restrict__ bk,
                                        const int32_t* __restrict__ brow,
                                        long long n, int32_t* __restrict__ cnt,
                                        int32_t* __restrict__ inv,
                                        int domain_pad) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const int c = bk[i];
    if (c >= 0 && c < domain_pad) {
      atomicAdd(&cnt[c], 1);
      atomicMax(&inv[c], brow[i] + 1);
    }
  }
}

// ---------------------------------------------------------------------------
// join_table_probe: per probe row (cnt[c], inv[c]); codes outside
// [0, domain_pad) gather 0.
//
// Replaces segment_join/kernel.py::join_table_probe_pallas (per-probe gather
// as a one-hot matmul over each domain block).
// Bound: bytes -- 4 bytes read and 8 written per probe row, plus the table
// lines the gathers touch.  Design: one thread per probe row, a bounds check
// and two gathers; radix-ordered probes keep neighbouring threads on
// neighbouring table lines.
// ---------------------------------------------------------------------------
__global__ void join_table_probe_kernel(const int32_t* __restrict__ pk,
                                        long long n,
                                        const int32_t* __restrict__ cnt,
                                        const int32_t* __restrict__ inv,
                                        int domain_pad,
                                        int32_t* __restrict__ cnt_p,
                                        int32_t* __restrict__ inv_p) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const int c = pk[i];
    int32_t a = 0, b = 0;
    if (c >= 0 && c < domain_pad) {
      a = cnt[c];
      b = inv[c];
    }
    cnt_p[i] = a;
    inv_p[i] = b;
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int repro_segment_sum_f64(const void* seg, const void* vals, long long n,
                          void* out, int num_segments, void* stream) {
  if (n > 0) {
    const int threads = 256;
    segment_sum_f64_kernel<<<grid_for(n, threads, 132 * 16), threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(seg), static_cast<const double*>(vals), n,
        static_cast<double*>(out), num_segments);
  }
  return static_cast<int>(cudaGetLastError());
}

// hist: [num_tiles * num_buckets] int32 scratch, uninitialised (every row is
// written by radix_hist_kernel); counts: [num_buckets].
int repro_radix_rank(const void* ids, long long n, int num_buckets, int tile,
                     void* hist, void* counts, void* rank, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_buckets <= 0 || tile <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int num_tiles = static_cast<int>((n + tile - 1) / tile);
  const size_t smem_bytes = static_cast<size_t>(num_buckets) * sizeof(int32_t);
  int max_optin = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const int use_smem = smem_bytes <= static_cast<size_t>(max_optin) ? 1 : 0;
  const size_t dyn = use_smem ? smem_bytes : 0;
  if (use_smem && dyn > 48 * 1024) {
    cudaFuncSetAttribute(radix_hist_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(dyn));
    cudaFuncSetAttribute(radix_rank_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(dyn));
  }
  if (num_tiles > 0) {
    radix_hist_kernel<<<num_tiles, 256, dyn, s>>>(
        static_cast<const int32_t*>(ids), n, num_buckets, tile, use_smem,
        static_cast<int32_t*>(hist));
  }
  radix_scan_kernel<<<(num_buckets + 255) / 256, 256, 0, s>>>(
      static_cast<int32_t*>(hist), num_tiles, num_buckets,
      static_cast<int32_t*>(counts));
  if (num_tiles > 0) {
    radix_rank_kernel<<<num_tiles, 32, dyn, s>>>(
        static_cast<const int32_t*>(ids), n, num_buckets, tile, use_smem,
        static_cast<int32_t*>(hist), static_cast<int32_t*>(rank));
  }
  return static_cast<int>(cudaGetLastError());
}

int repro_join_table_build(const void* bk, const void* brow, long long n,
                           void* cnt, void* inv, int domain_pad,
                           void* stream) {
  if (n > 0) {
    const int threads = 256;
    join_table_build_kernel<<<grid_for(n, threads, 132 * 32), threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(bk), static_cast<const int32_t*>(brow), n,
        static_cast<int32_t*>(cnt), static_cast<int32_t*>(inv), domain_pad);
  }
  return static_cast<int>(cudaGetLastError());
}

int repro_join_table_probe(const void* pk, long long n, const void* cnt,
                           const void* inv, int domain_pad, void* cnt_p,
                           void* inv_p, void* stream) {
  if (n > 0) {
    const int threads = 256;
    join_table_probe_kernel<<<grid_for(n, threads, 132 * 32), threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(pk), n, static_cast<const int32_t*>(cnt),
        static_cast<const int32_t*>(inv), domain_pad,
        static_cast<int32_t*>(cnt_p), static_cast<int32_t*>(inv_p));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
