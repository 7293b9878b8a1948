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

#include "radix_pass.cuh"

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
// blocks run in no order, and a per-tile histogram row of every bucket
// (16,385 at the join's probe) is larger than the tile's ids.  So the rank
// is read off a stable counting sort of (bucket id, position) by the 8-bit
// digits of the id, on the counted schedule of radix_pass.cuh:
// ceil(bits(B) / 8) passes for B buckets (2 at 16,385, 3 at 100,000), a
// number the host knows, each with a parallelism that does not fall as
// buckets grow.
//   1. per digit, tile_hist_kernel counts each 2,048-row tile's digits
//      (the first also counts the ids into the bucket histogram, counts,
//      with one atomic per warp and id while the warp's ids are equal) and
//      column_scan_kernel scans them over the tiles;
//   2. exclusive_scan_kernel turns counts into bucket offsets;
//   3. per digit, digit_pass_kernel scatters the (key, position) pairs; the
//      last writes rank[position] = dest - offset[bucket], dest being the
//      row's place in the sorted order.
// Ids outside [0, num_buckets) take the key num_buckets, above every live
// id, so they sort last and disturb no live rank; they get rank 0 and are
// not counted (the padding contract of the TPU kernel).
// Bound: bytes -- the ids are read once and the ranks written once; each
// digit adds a read of the keys for its counts and a read and write of the
// (key, position) pairs.
// ---------------------------------------------------------------------------
struct RankEnds {
  const int32_t* ids;
  uint32_t num_buckets;
  int32_t* counts;
  const int32_t* offsets;
  int32_t* rank;
  __device__ uint32_t first_key(long long i) const {
    const int b = ids[i];
    return (b >= 0 && static_cast<uint32_t>(b) < num_buckets)
               ? static_cast<uint32_t>(b) : num_buckets;
  }
  __device__ void visit(uint32_t key, int c) const {
    if (key < num_buckets) atomicAdd(&counts[key], c);
  }
  __device__ void last(int32_t dest, uint32_t key, int32_t p) const {
    rank[p] = key < num_buckets ? dest - offsets[key] : 0;
  }
  // every digit pass runs, so pass 0 always sorts
  __device__ void identity(long long) const {}
};

constexpr int kScanThreads = 1024;

// offsets = exclusive scan of counts[0, n), by one block
__global__ void __launch_bounds__(kScanThreads)
exclusive_scan_kernel(const int32_t* __restrict__ counts, int n,
                      int32_t* __restrict__ offsets) {
  radix::block_exclusive_scan<kScanThreads>(counts, offsets, n, 0);
}

inline int rank_digits(int num_buckets) {
  int bits = 0;  // bits of the largest key, num_buckets itself
  for (unsigned v = static_cast<unsigned>(num_buckets); v; v >>= 1) ++bits;
  return (bits + radix::kDigitBits - 1) / radix::kDigitBits;
}

// key and position buffers the passes need: none for one digit, one for
// two (the first pass writes it, the last reads it), else two
inline int rank_buffers(int digits) { return digits >= 3 ? 2 : digits - 1; }

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

// Bytes of scratch repro_radix_rank needs for n ids into num_buckets.
long long repro_radix_rank_scratch_bytes(long long n, int num_buckets) {
  if (n <= 0 || num_buckets <= 0) return 0;
  const size_t pair = radix::align_up(n * sizeof(uint32_t)) +
                      radix::align_up(n * sizeof(int32_t));
  return static_cast<long long>(
      radix::digit_counts_bytes() +
      radix::align_up(static_cast<size_t>(radix::tiles_for(n)) *
                      radix::kBuckets * sizeof(int32_t)) +
      radix::align_up(static_cast<size_t>(num_buckets) * sizeof(int32_t)) +
      rank_buffers(rank_digits(num_buckets)) * pair);
}

// rank: [n] int32, counts: [num_buckets] int32 (both written here);
// scratch: repro_radix_rank_scratch_bytes(n, num_buckets) bytes.
int repro_radix_rank(const void* ids, long long n, int num_buckets,
                     void* scratch, void* counts, void* rank, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_buckets <= 0 || n <= 0 || n > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int digits = rank_digits(num_buckets);
  const int tiles = static_cast<int>(radix::tiles_for(n));
  unsigned char* p = static_cast<unsigned char*>(scratch);
  radix::State st = {};
  st.digit_counts = reinterpret_cast<int32_t*>(p);
  p += radix::digit_counts_bytes();
  int32_t* tile_prefix = reinterpret_cast<int32_t*>(p);
  p += radix::align_up(static_cast<size_t>(tiles) * radix::kBuckets *
                       sizeof(int32_t));
  int32_t* offsets = reinterpret_cast<int32_t*>(p);
  p += radix::align_up(static_cast<size_t>(num_buckets) * sizeof(int32_t));
  radix::Buffers<uint32_t> buf = {{nullptr, nullptr}, {nullptr, nullptr}};
  for (int k = 2 - rank_buffers(digits); k < 2; ++k) {
    buf.keys[k] = reinterpret_cast<uint32_t*>(p);
    p += radix::align_up(n * sizeof(uint32_t));
    buf.pos[k] = reinterpret_cast<int32_t*>(p);
    p += radix::align_up(n * sizeof(int32_t));
  }
  cudaMemsetAsync(counts, 0, static_cast<size_t>(num_buckets) * sizeof(int32_t),
                  s);
  const RankEnds ends{static_cast<const int32_t*>(ids),
                      static_cast<uint32_t>(num_buckets),
                      static_cast<int32_t*>(counts), offsets,
                      static_cast<int32_t*>(rank)};
  for (int pass = 0; pass < digits; ++pass) {
    radix::tile_hist_kernel<uint32_t><<<tiles, radix::kThreads, 0, s>>>(
        ends, buf, n, pass, tiles, tile_prefix);
    radix::column_scan_kernel<<<radix::kBuckets, radix::kThreads, 0, s>>>(
        tile_prefix, tiles, st.digit_counts + pass * radix::kBuckets);
    if (pass == 0) {
      exclusive_scan_kernel<<<1, kScanThreads, 0, s>>>(
          static_cast<const int32_t*>(counts), num_buckets, offsets);
    }
    radix::digit_pass_kernel<uint32_t, RankEnds, false>
        <<<tiles, radix::kThreads, 0, s>>>(ends, buf, n, pass, digits, st,
                                           tile_prefix, tiles);
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
