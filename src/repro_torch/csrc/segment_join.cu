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
// kernels are therefore bound by memory traffic, not by operations, except
// the segment sum over a long segment: its adds in row order are one
// dependent chain.

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
// The reference's answer (jax.ops.segment_sum under x64, as the plain
// version's index_add_ on the CPU) is the sequential sum of each segment in
// ascending row order, starting from +0.0, and the kernel returns those
// bits: float addition cannot be reassociated, so every segment is one
// chain of dependent adds in row order, never a tree or atomics.  Ids
// outside [0, num_segments) are dropped, as jax.ops.segment_sum drops them.
//
// Design: segment_sum_runs_kernel needs each segment's rows to be one
// contiguous run (the GROUP BY's ids come out of a cumsum over sorted keys,
// and its caller says so).  Each warp takes kChunk consecutive 32-row
// tiles, loads all their ids into shared memory at once (one memory
// latency, not one a tile), finds the run heads of each tile with a ballot
// and owns the runs that start there:
//   * a run that ends inside the tile is summed by its head lane from the
//     warp's copy of the tile's values in shared memory, several runs at
//     once;
//   * the run that reaches past the tile is continued by the whole warp
//     (continue_run): it loads kLook tiles of ids and values (coalesced),
//     stages the values in shared memory and loads the next kLook tiles
//     while lane 0 adds the staged ones in row order.
// A tile whose rows all continue an earlier run reads its ids only.  Any
// other ids (the join aggregates') are first grouped stably by the digit
// passes of radix_rank (radix_pass.cuh, counted schedule), whose last pass
// writes each row's (id, value) to its place in segment order; the run
// kernel then sums the grouped copy.
// Bound: bytes -- reads 4 + 8 bytes per row, writes 8 bytes per segment
// (the grouping adds its digit passes).  The chain of one segment costs
// one float64 add latency per row, so a segment of m rows takes at least m
// times that latency, whatever the card's bandwidth: a skewed column (one
// segment holding half the rows) is bound by that chain, not by bytes.
// ---------------------------------------------------------------------------
constexpr int kSumThreads = 256;
constexpr int kSumWarps = kSumThreads / 32;
constexpr int kChunk = 16;  // consecutive 32-row tiles a warp scans
constexpr int kLook = 4;    // tiles of a long run staged at a time
constexpr int kBatch = 8;   // staged values loaded ahead of their adds

// acc + v[0] + v[1] + ... + v[count - 1], added in that order; the loads
// of the next kBatch values are issued before the adds of this batch, so
// the chain runs at the add's latency, not the load's
__device__ __forceinline__ double add_in_order(double acc, const double* v,
                                               int count) {
  double cur[kBatch], nxt[kBatch];
  int j = 0;
  if (count >= kBatch) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) cur[u] = v[u];
  }
  for (; j + kBatch <= count; j += kBatch) {
    if (j + 2 * kBatch <= count) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) nxt[u] = v[j + kBatch + u];
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) acc = acc + cur[u];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) cur[u] = nxt[u];
  }
  for (; j < count; ++j) acc = acc + v[j];
  return acc;
}

__device__ __forceinline__ int id_at(const int32_t* seg, long long i,
                                     long long n) {
  return i >= 0 && i < n ? seg[i] : -1;
}

// The run that starts at row `from` - 1 of segment `run` with the sum acc
// so far, continued by the whole warp from row `from` to its end: the warp
// stages kLook tiles of values in shared memory and loads the next kLook
// tiles while lane 0 adds the staged ones.  Returns the sum (on lane 0).
__device__ double continue_run(const int32_t* __restrict__ seg,
                               const double* __restrict__ vals, long long n,
                               long long from, int run, double acc,
                               double* sv, int lane) {
  int gs[kLook];
  double gv[kLook];
#pragma unroll
  for (int k = 0; k < kLook; ++k) {
    const long long r = from + 32 * k + lane;
    gs[k] = id_at(seg, r, n);
    gv[k] = r < n ? vals[r] : 0.0;
  }
  for (long long at = from;; at += 32 * kLook) {
    int count = 32 * kLook;  // rows of the group that continue the run
#pragma unroll
    for (int k = kLook - 1; k >= 0; --k) {
      const unsigned stop = __ballot_sync(kFullMask, gs[k] != run);
      if (stop) count = 32 * k + __ffs(stop) - 1;
    }
    __syncwarp();  // lane 0 has added the previous group
#pragma unroll
    for (int k = 0; k < kLook; ++k) sv[32 * k + lane] = gv[k];
    __syncwarp();
    const bool more = count == 32 * kLook;
    if (more) {
#pragma unroll
      for (int k = 0; k < kLook; ++k) {
        const long long r = at + 32 * (kLook + k) + lane;
        gs[k] = id_at(seg, r, n);
        gv[k] = r < n ? vals[r] : 0.0;
      }
    }
    if (lane == 0) acc = add_in_order(acc, sv, count);
    if (!more) break;
  }
  __syncwarp();
  return acc;
}

// (at most 80 registers: three blocks an SM, for the latency of the scan)
__global__ void __launch_bounds__(kSumThreads, 3)
segment_sum_runs_kernel(const int32_t* __restrict__ seg,
                        const double* __restrict__ vals, long long n,
                        double* __restrict__ out, int num_segments) {
  constexpr int kRows = 32 * kChunk;
  __shared__ double stage[kSumWarps][32 * kLook];
  // the chunk's ids and the id after it, loaded all at once
  __shared__ int ids[kSumWarps][kRows + 1];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  double* sv = stage[wid];
  int* sid = ids[wid];
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long first = warp * kRows;
  if (first >= n) return;
#pragma unroll
  for (int c = 0; c < kChunk; ++c)
    sid[32 * c + lane] = id_at(seg, first + 32 * c + lane, n);
  if (lane == 0) sid[kRows] = id_at(seg, first + kRows, n);
  const int before = id_at(seg, first - 1, n);  // the row before the chunk
  __syncwarp();
  for (int c = 0; c < kChunk; ++c) {
    const long long base = first + 32 * c;
    if (base >= n) break;
    const long long i = base + lane;
    const int j = 32 * c + lane;
    const bool row = i < n;
    const int s = sid[j];
    const int prev = j > 0 ? sid[j - 1] : before;
    const bool head = row && (i == 0 || prev != s);
    const bool tail = row && (i + 1 >= n || sid[j + 1] != s);
    const bool live = s >= 0 && s < num_segments;
    // a tile whose live rows all continue an earlier run has nothing to do
    const unsigned heads = __ballot_sync(kFullMask, head && live);
    if (heads != 0) {
      const unsigned tails = __ballot_sync(kFullMask, tail);
      sv[lane] = row ? vals[i] : 0.0;
      __syncwarp();
      // a head lane sums its run up to its tail, or to the tile's end when
      // the run reaches past the tile (at most one such run, the last)
      double acc = 0.0;
      bool reaches_past = false;
      if (head && live) {
        const unsigned rest = tails & ~((1u << lane) - 1u);
        const int end = rest ? __ffs(rest) - 1 : 31;
        for (int k = lane; k <= end; ++k) acc = acc + sv[k];
        if (rest) out[s] = acc;
        reaches_past = rest == 0;
      }
      const unsigned open = __ballot_sync(kFullMask, reaches_past);
      if (open != 0) {
        const int owner = __ffs(open) - 1;
        acc = __shfl_sync(kFullMask, acc, owner);
        const int run = __shfl_sync(kFullMask, s, owner);
        acc = continue_run(seg, vals, n, base + 32, run, acc, sv, lane);
        if (lane == 0) out[run] = acc;
      }
      __syncwarp();  // sv is rewritten by the next tile
    }
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

// The grouping before an ordered segment sum over unsorted ids: the same
// stable sort by segment id as radix_rank, whose last pass writes each
// row's id (-1 when out of range, so that the run kernel drops it) and
// value to the row's place in segment order.
struct GroupEnds {
  const int32_t* ids;
  uint32_t num_buckets;
  const double* vals;
  int32_t* grouped_ids;
  double* grouped_vals;
  __device__ uint32_t first_key(long long i) const {
    const int b = ids[i];
    return (b >= 0 && static_cast<uint32_t>(b) < num_buckets)
               ? static_cast<uint32_t>(b) : num_buckets;
  }
  __device__ void visit(uint32_t, int) const {}
  __device__ void last(int32_t dest, uint32_t key, int32_t p) const {
    grouped_ids[dest] = key < num_buckets ? static_cast<int32_t>(key) : -1;
    grouped_vals[dest] = vals[p];
  }
  __device__ void identity(long long) const {}
};

// The scratch of a counted sort of n keys below 2^bits(num_buckets):
// digit totals, the [256][tiles] tile prefixes, then (offsets when
// with_offsets) and the key and position buffers.
struct CountedScratch {
  radix::State st;
  int32_t* tile_prefix;
  int32_t* offsets;
  radix::Buffers<uint32_t> buf;
  size_t bytes;
};

inline CountedScratch carve_counted(unsigned char* base, long long n,
                                    int num_buckets, bool with_offsets) {
  CountedScratch c = {};
  const int digits = rank_digits(num_buckets);
  size_t off = 0;
  auto take = [&](size_t bytes) {
    unsigned char* at = base ? base + off : nullptr;
    off += radix::align_up(bytes);
    return at;
  };
  c.st.digit_counts = reinterpret_cast<int32_t*>(
      take(radix::digit_counts_bytes()));
  c.tile_prefix = reinterpret_cast<int32_t*>(
      take(static_cast<size_t>(radix::tiles_for(n)) * radix::kBuckets *
           sizeof(int32_t)));
  if (with_offsets) {
    c.offsets = reinterpret_cast<int32_t*>(
        take(static_cast<size_t>(num_buckets) * sizeof(int32_t)));
  }
  c.buf = {{nullptr, nullptr}, {nullptr, nullptr}};
  for (int k = 2 - rank_buffers(digits); k < 2; ++k) {
    c.buf.keys[k] = reinterpret_cast<uint32_t*>(take(n * sizeof(uint32_t)));
    c.buf.pos[k] = reinterpret_cast<int32_t*>(take(n * sizeof(int32_t)));
  }
  c.bytes = off;
  return c;
}

// Every digit pass of a counted sort; after pass 0's counts, offsets (when
// given) become the exclusive scan of counts[0, num_buckets).
template <typename Ends>
void counted_passes(const Ends& ends, const CountedScratch& c, long long n,
                    int num_buckets, const int32_t* counts, cudaStream_t s) {
  const int digits = rank_digits(num_buckets);
  const int tiles = static_cast<int>(radix::tiles_for(n));
  for (int pass = 0; pass < digits; ++pass) {
    radix::tile_hist_kernel<uint32_t><<<tiles, radix::kThreads, 0, s>>>(
        ends, c.buf, n, pass, tiles, c.tile_prefix);
    radix::column_scan_kernel<<<radix::kBuckets, radix::kThreads, 0, s>>>(
        c.tile_prefix, tiles, c.st.digit_counts + pass * radix::kBuckets);
    if (pass == 0 && c.offsets != nullptr) {
      exclusive_scan_kernel<<<1, kScanThreads, 0, s>>>(counts, num_buckets,
                                                       c.offsets);
    }
    radix::digit_pass_kernel<uint32_t, Ends, false>
        <<<tiles, radix::kThreads, 0, s>>>(ends, c.buf, n, pass, digits,
                                           c.st, c.tile_prefix, tiles);
  }
}

// ---------------------------------------------------------------------------
// join_table_build: cnt[c] = build rows with code c; inv[c] = largest
// brow + 1 (0 = empty slot); codes outside [0, domain_pad) are ignored.
//
// Replaces segment_join/kernel.py::join_table_build_pallas (2-D grid of row
// tiles x domain blocks, one-hot sums and maxima, with block skipping).
// Bound: bytes -- 8 bytes read per build row, the two tables written once.
// The caller zeroes both tables; the max makes "the largest build row wins"
// whatever order the atomics land in, and a count does not depend on it.
// Design: the build side often holds many rows of one code -- the fused
// join sends every padding row to the dead slot `domain` (28% of Q-a's
// 2,097,152 rows), and a skewed key does the same -- and atomics to one
// address serialise in L2.  So equal codes are folded before any atomic:
// a warp takes kBuildRows tiles of 32 consecutive rows at once (coalesced
// loads, lane l holding row l of each tile); each lane folds each run of
// equal codes among its rows into a count and a max; in round u a lane
// offers the run that ends at its row of tile u.  Where two neighbouring
// lanes offer one code, __match_any_sync groups the lanes that offer one
// code, __reduce_add_sync and __reduce_max_sync fold the group, and its
// leader issues one atomicAdd and one atomicMax; a round of distinct codes
// (a shuffle and a vote tell) skips the match, which costs more than the
// atomics it would save there, and each lane issues its pair.  A stretch of
// one code costs one atomic pair per 32 * kBuildRows rows; distinct codes
// cost one pair a row, as before, and each round's atomics fall on 32
// consecutive rows' slots, which radix order (the caller's
// radix_partition pass) keeps on a few neighbouring table sectors.
// ---------------------------------------------------------------------------
constexpr int kBuildThreads = 256;
constexpr int kBuildRows = 4;

__global__ void __launch_bounds__(kBuildThreads)
join_table_build_kernel(const int32_t* __restrict__ bk,
                        const int32_t* __restrict__ brow, long long n,
                        int32_t* __restrict__ cnt, int32_t* __restrict__ inv,
                        int domain_pad) {
  const int lane = threadIdx.x & 31;
  constexpr long long kSpan = 32 * kBuildRows;  // rows a warp takes at once
  const long long warps =
      static_cast<long long>(gridDim.x) * (kBuildThreads / 32);
  for (long long base = ((static_cast<long long>(blockIdx.x) * kBuildThreads +
                          threadIdx.x) >> 5) * kSpan;
       base < n; base += warps * kSpan) {
    int c[kBuildRows], r[kBuildRows];
#pragma unroll
    for (int u = 0; u < kBuildRows; ++u) {
      const long long i = base + u * 32 + lane;
      c[u] = i < n ? bk[i] : -1;  // past the end: ignored
      r[u] = i < n ? brow[i] : 0;
    }
    int run_n = 0, run_max = 0;
#pragma unroll
    for (int u = 0; u < kBuildRows; ++u) {
      ++run_n;
      run_max = max(run_max, r[u] + 1);
      // the lane's run ends here: its last row, or the next row's code
      // differs
      const bool ends =
          u + 1 == kBuildRows || c[u + 1 < kBuildRows ? u + 1 : u] != c[u];
      const bool live = ends && c[u] >= 0 && c[u] < domain_pad;
      const int key = live ? c[u] : -1;
      // two neighbouring lanes offering one code mark a stretch of it:
      // fold the warp's equal codes (the match is costly, so rounds of
      // distinct codes skip it; a duplicate it misses costs one atomic)
      const int other = __shfl_xor_sync(kFullMask, key, 1);  // every lane
      const bool pair = live && key == other;
      if (__any_sync(kFullMask, pair)) {
        const unsigned group = __match_any_sync(kFullMask, key);
        const int total = __reduce_add_sync(group, live ? run_n : 0);
        const int top = __reduce_max_sync(group, live ? run_max : 0);
        if (live && lane == __ffs(group) - 1) {
          atomicAdd(&cnt[key], total);
          atomicMax(&inv[key], top);
        }
      } else if (live) {
        atomicAdd(&cnt[key], run_n);
        atomicMax(&inv[key], run_max);
      }
      if (ends) {
        run_n = 0;
        run_max = 0;
      }
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

static int sum_grid(long long n) {
  const long long warps = (n + 32 * kChunk - 1) / (32 * kChunk);
  return static_cast<int>((warps + kSumWarps - 1) / kSumWarps);
}

// Bytes of scratch repro_segment_sum_f64 needs for ids that are not
// sorted: the grouping's sort and the grouped ids and values.
long long repro_segment_sum_f64_scratch_bytes(long long n, int num_segments) {
  if (n <= 0 || num_segments <= 0) return 0;
  const CountedScratch c = carve_counted(nullptr, n, num_segments, false);
  return static_cast<long long>(c.bytes + radix::align_up(n * sizeof(int32_t)) +
                                radix::align_up(n * sizeof(double)));
}

// out: [num_segments] float64, zeroed by the caller.  ids_sorted: the rows
// of each segment are contiguous (any order of the segments); else scratch
// holds repro_segment_sum_f64_scratch_bytes(n, num_segments) bytes.
int repro_segment_sum_f64(const void* seg, const void* vals, long long n,
                          void* out, int num_segments, int ids_sorted,
                          void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || num_segments <= 0) return static_cast<int>(cudaGetLastError());
  const int32_t* ids = static_cast<const int32_t*>(seg);
  const double* v = static_cast<const double*>(vals);
  if (!ids_sorted) {
    if (n > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    unsigned char* base = static_cast<unsigned char*>(scratch);
    const CountedScratch c = carve_counted(base, n, num_segments, false);
    int32_t* gids = reinterpret_cast<int32_t*>(base + c.bytes);
    double* gvals = reinterpret_cast<double*>(
        base + c.bytes + radix::align_up(n * sizeof(int32_t)));
    const GroupEnds ends{ids, static_cast<uint32_t>(num_segments), v, gids,
                         gvals};
    counted_passes(ends, c, n, num_segments, nullptr, s);
    ids = gids;
    v = gvals;
  }
  segment_sum_runs_kernel<<<sum_grid(n), kSumThreads, 0, s>>>(
      ids, v, n, static_cast<double*>(out), num_segments);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of scratch repro_radix_rank needs for n ids into num_buckets.
long long repro_radix_rank_scratch_bytes(long long n, int num_buckets) {
  if (n <= 0 || num_buckets <= 0) return 0;
  return static_cast<long long>(
      carve_counted(nullptr, n, num_buckets, true).bytes);
}

// rank: [n] int32, counts: [num_buckets] int32 (both written here);
// scratch: repro_radix_rank_scratch_bytes(n, num_buckets) bytes.
int repro_radix_rank(const void* ids, long long n, int num_buckets,
                     void* scratch, void* counts, void* rank, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_buckets <= 0 || n <= 0 || n > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const CountedScratch c = carve_counted(static_cast<unsigned char*>(scratch),
                                         n, num_buckets, true);
  cudaMemsetAsync(counts, 0, static_cast<size_t>(num_buckets) * sizeof(int32_t),
                  s);
  const RankEnds ends{static_cast<const int32_t*>(ids),
                      static_cast<uint32_t>(num_buckets),
                      static_cast<int32_t*>(counts), c.offsets,
                      static_cast<int32_t*>(rank)};
  counted_passes(ends, c, n, num_buckets, static_cast<int32_t*>(counts), s);
  return static_cast<int>(cudaGetLastError());
}

// cnt, inv: [domain_pad] int32 each, zeroed by the caller.
int repro_join_table_build(const void* bk, const void* brow, long long n,
                           void* cnt, void* inv, int domain_pad,
                           void* stream) {
  if (n > 0) {
    join_table_build_kernel<<<grid_for((n + kBuildRows - 1) / kBuildRows,
                                       kBuildThreads, 132 * 8),
                              kBuildThreads, 0,
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
