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
// the segment sum's chain route over a long segment: its adds in row order
// are one dependent chain.

#include <cstddef>

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
// ascending row order, starting from +0.0, and the kernels return those
// bits.  Ids outside [0, num_segments) are dropped, as jax.ops.segment_sum
// drops them.
//
// Design: two routes, chosen on the device per call, with no host sync.
//
//  * Exact (segment_sum_exact_kernel, every call).  If every value is a
//    multiple of 2^e and max|x| * n <= 2^(53+e) (and below 2^1024), every
//    partial sum of any segment, in any order, is a multiple of 2^e below
//    2^(53+e) in magnitude, so it is a float64 and every add is exact: the
//    result is the exact sum, the row-order chain's bits, whatever the
//    order.  The relational path's sums qualify: cents cast to float64,
//    counts of 0 and 1.  The kernel sums optimistically: each thread takes
//    8 consecutive rows, a segmented scan over head flags (in the thread,
//    then shuffles over the warp, then the block's 8 warps) gives every
//    run piece of a 2,048-row tile its sum, and the piece's last row adds
//    it into the zeroed output with one float64 atomicAdd (+0.0 plus an
//    exactly-zero sum stays +0.0, the chain's zero).  From the same read it
//    reduces the exponent of the lowest set bit of any nonzero value, the
//    largest exponent, whether any value is NaN or infinite, and whether
//    any id is below the one before it; the last block to finish decides
//    the route from them in exponent arithmetic (SumState::route).  A
//    block whose own rows already rule the exact route out adds nothing
//    (the chain will store every sum), so values that are not exact pay
//    the exact kernel's read and not its atomics.
//  * Chain (segment_sum_runs_kernel), when the sum is not exact in every
//    order.  It sums each segment as one chain of dependent adds in row
//    order and stores it over what the exact kernel added, which every
//    segment with a live row gets.  It needs each segment's rows to be one
//    contiguous run, which ids that never decrease give (the exact
//    kernel's check: no id below its predecessor).  Each warp takes kChunk
//    consecutive 32-row
//    tiles, loads all their ids into shared memory at once (one memory
//    latency, not one a tile), finds the run heads of each tile with a
//    ballot and owns the runs that start there:
//      - a run that ends inside the tile is summed by its head lane from
//        the warp's copy of the tile's values in shared memory, several
//        runs at once;
//      - the run that reaches past the tile is continued by the whole warp
//        (continue_run): it loads kLook tiles of ids and values
//        (coalesced), stages the values in shared memory and loads the
//        next kLook tiles while lane 0 adds the staged ones in row order.
//    A tile whose rows all continue an earlier run reads its ids only.
//    Other ids (unsorted, or contiguous segments in no order) are first
//    grouped stably by the digit passes of radix_rank (radix_pass.cuh,
//    counted schedule), whose last pass writes each row's (id, value) to
//    its place in segment order; the run kernel then sums the grouped
//    copy.  The host cannot know the route without waiting for the card,
//    so the grouping kernels and the run kernel are launched on every call
//    and return at once unless the route is theirs.
// Bound: bytes -- reads 4 + 8 bytes per row, writes 8 bytes per segment.
// The chain of one segment costs one float64 add latency per row, so on the
// chain route a segment of m rows takes at least m times that latency,
// whatever the card's bandwidth: a skewed column of non-integer values
// (one segment holding half the rows) is bound by that chain, not by
// bytes, and that is inherent to the row-order bits.
// ---------------------------------------------------------------------------

// The route state of one call, after the sums in the caller's zeroed
// allocation.  The key fields hold maxima, so that zero means "none yet".
struct SumState {
  unsigned int low_key;    // kExpBias - least exponent of a lowest set bit
  unsigned int top_key;    // kExpBias + largest floor(log2 |x|)
  unsigned int nonfinite;  // 1: some value is NaN or infinite
  unsigned int decreased;  // 1: some id is below the one before it
  unsigned int blocks_done;
  unsigned int route;      // kRouteExact, kRouteRuns or kRouteGrouped
};
constexpr int kExpBias = 1100;  // above 1074, below 2^31 - 2100
constexpr unsigned kRouteExact = 1, kRouteRuns = 2, kRouteGrouped = 3;

// The exponent statistics of one value: its lowest set bit's exponent and
// floor(log2 |x|) (subnormals included), or the non-finite flag.
__device__ __forceinline__ void value_stats(double x, unsigned& low_key,
                                            unsigned& top_key,
                                            unsigned& nonfinite) {
  const unsigned long long b =
      static_cast<unsigned long long>(__double_as_longlong(x));
  const int be = static_cast<int>((b >> 52) & 0x7ff);
  const unsigned long long m = b & ((1ull << 52) - 1);
  if (be == 0x7ff) {
    nonfinite = 1;
    return;
  }
  if (be == 0 && m == 0) return;  // +0.0 and -0.0 add nothing
  int low, top;
  if (be != 0) {
    low = be - 1075 + __ffsll(static_cast<long long>(m | (1ull << 52))) - 1;
    top = be - 1023;
  } else {
    low = -1074 + __ffsll(static_cast<long long>(m)) - 1;
    top = -1074 + 63 - __clzll(static_cast<long long>(m));
  }
  low_key = max(low_key, static_cast<unsigned>(kExpBias - low));
  top_key = max(top_key, static_cast<unsigned>(kExpBias + top));
}

// Whether statistics (complete, or of a subset of the values) allow the
// exact route: no value is non-finite and 2^(top + 1) * 2^ceil(log2 n) <=
// min(2^(53 + low), 2^1024) (no partial sum overflows; every value zero is
// exact too).  A subset's statistics fail only where the whole column's do.
__device__ __forceinline__ bool exact_ok(unsigned low_key, unsigned top_key,
                                         unsigned nonfinite, long long n) {
  if (nonfinite) return false;
  if (top_key == 0) return true;
  const int low = kExpBias - static_cast<int>(low_key);
  const int top = static_cast<int>(top_key) - kExpBias;
  const int log2n = n > 1 ? 64 - __clzll(n - 1) : 0;
  return log2n + top + 1 <= min(53 + low, 1024);
}

// The route of a call from its complete statistics: exact where it may be,
// else the runs of the ids as they come when no id decreases, else the
// grouped copy.
__device__ unsigned decide_route(unsigned low_key, unsigned top_key,
                                 unsigned nonfinite, unsigned decreased,
                                 long long n) {
  if (exact_ok(low_key, top_key, nonfinite, n)) return kRouteExact;
  return decreased ? kRouteGrouped : kRouteRuns;
}

constexpr int kExactThreads = 256;
constexpr int kExactWarps = kExactThreads / 32;
constexpr int kExactItems = 8;  // consecutive rows a thread owns
constexpr int kExactTile = kExactThreads * kExactItems;

// (flag, value) of a segmented scan: flag says a run head lies in the
// span, value is the sum from the span's last head (or its start) to its
// end; left then right
__device__ __forceinline__ void seg_combine(bool lf, double lv, bool& rf,
                                            double& rv) {
  if (!rf) rv = lv + rv;
  rf = rf || lf;
}

__device__ __forceinline__ int live_id(int s, int num_segments) {
  return s >= 0 && s < num_segments ? s : -1;
}

__global__ void __launch_bounds__(kExactThreads)
segment_sum_exact_kernel(const int32_t* __restrict__ seg,
                         const double* __restrict__ vals, long long n,
                         double* __restrict__ out, int num_segments,
                         int vec, SumState* st) {
  __shared__ bool warp_flag[kExactWarps];
  __shared__ double warp_val[kExactWarps];
  __shared__ unsigned red[4][kExactWarps];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  unsigned low_key = 0, top_key = 0, nonfinite = 0, decreased = 0;
  const long long tiles = (n + kExactTile - 1) / kExactTile;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long base = t * kExactTile;
    const long long r0 = base + static_cast<long long>(tid) * kExactItems;
    int id[kExactItems];
    double v[kExactItems];
    if (vec && base + kExactTile <= n) {
#pragma unroll
      for (int q = 0; q < kExactItems / 4; ++q) {
        const int4 a = *reinterpret_cast<const int4*>(seg + r0 + 4 * q);
        id[4 * q] = a.x;
        id[4 * q + 1] = a.y;
        id[4 * q + 2] = a.z;
        id[4 * q + 3] = a.w;
      }
#pragma unroll
      for (int q = 0; q < kExactItems / 2; ++q) {
        const double2 d = *reinterpret_cast<const double2*>(vals + r0 + 2 * q);
        v[2 * q] = d.x;
        v[2 * q + 1] = d.y;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kExactItems; ++k) {
        const long long r = r0 + k;
        id[k] = r < n ? seg[r] : -1;
        v[k] = r < n ? vals[r] : 0.0;
      }
    }
    // the id of the row before this thread's first (the previous tile's
    // last for the block's first thread: the decrease check spans tiles)
    int prev = __shfl_up_sync(kFullMask, id[kExactItems - 1], 1);
    if (lane == 0) prev = r0 > 0 && r0 - 1 < n ? seg[r0 - 1] : -1;
    int mid[kExactItems];  // the segment, -1 for a dropped row
    bool head[kExactItems];
#pragma unroll
    for (int k = 0; k < kExactItems; ++k) {
      const long long r = r0 + k;
      const int before = k ? id[k - 1] : prev;
      if (r < n) {
        if (r > 0 && id[k] < before) decreased = 1;
        value_stats(v[k], low_key, top_key, nonfinite);
      }
      mid[k] = r < n ? live_id(id[k], num_segments) : -1;
      head[k] = k ? mid[k] != mid[k - 1]
                  : tid == 0 || mid[0] != live_id(prev, num_segments);
    }
    // a run piece ends at the thread's last row when the next row heads a
    // run: the next lane's first row, or for lane 31 the next warp's
    const bool next_head =
        __shfl_down_sync(kFullMask, static_cast<int>(head[0]), 1) != 0;
    bool tail_last;
    if (lane < 31) {
      tail_last = next_head;
    } else {
      const long long r = r0 + kExactItems;
      tail_last = tid == kExactThreads - 1 || r >= n ||
                  live_id(seg[r], num_segments) != mid[kExactItems - 1];
    }
    // the thread's (flag, value), then an inclusive segmented scan over
    // the warp's lanes and an exclusive one over the block's warps
    bool f = false;
    double a = 0.0;
#pragma unroll
    for (int k = 0; k < kExactItems; ++k) {
      if (head[k]) {
        f = true;
        a = v[k];
      } else {
        a += v[k];
      }
    }
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const bool of = __shfl_up_sync(kFullMask, static_cast<int>(f), d) != 0;
      const double ov = __shfl_up_sync(kFullMask, a, d);
      if (lane >= d) seg_combine(of, ov, f, a);
    }
    if (lane == 31) {
      warp_flag[wid] = f;
      warp_val[wid] = a;
    }
    bool cf = __shfl_up_sync(kFullMask, static_cast<int>(f), 1) != 0;
    double cv = __shfl_up_sync(kFullMask, a, 1);
    if (lane == 0) {
      cf = false;
      cv = 0.0;
    }
    // the statistics of the block's rows so far: where they already rule
    // the exact route out, the chain stores every sum and the block adds
    // nothing (non-integer values pay the read, not the atomics)
    {
      const unsigned lk = __reduce_max_sync(kFullMask, low_key);
      const unsigned tk = __reduce_max_sync(kFullMask, top_key);
      const unsigned nf = __reduce_max_sync(kFullMask, nonfinite);
      if (lane == 0) {
        red[0][wid] = lk;
        red[1][wid] = tk;
        red[2][wid] = nf;
      }
    }
    __syncthreads();
    unsigned blk[3] = {0, 0, 0};
    for (int w = 0; w < kExactWarps; ++w)
      for (int q = 0; q < 3; ++q) blk[q] = max(blk[q], red[q][w]);
    if (!exact_ok(blk[0], blk[1], blk[2], n)) {
      __syncthreads();  // red is rewritten next tile
      continue;
    }
    bool wf = false;
    double wv = 0.0;
    for (int w = 0; w < wid; ++w) {
      bool rf = warp_flag[w];
      double rv = warp_val[w];
      seg_combine(wf, wv, rf, rv);
      wf = rf;
      wv = rv;
    }
    seg_combine(wf, wv, cf, cv);
    // cv is the sum of the run that reaches this thread's first row, up to
    // that row; each run piece's last row adds its sum into the output
    double run = cv;
#pragma unroll
    for (int k = 0; k < kExactItems; ++k) {
      run = head[k] ? v[k] : run + v[k];
      const bool tail = k + 1 < kExactItems ? head[k + 1] : tail_last;
      if (tail && mid[k] >= 0) atomicAdd(&out[mid[k]], run);
    }
    __syncthreads();  // warp_flag and warp_val are rewritten next tile
  }
  // the block's statistics, one atomic each; the last block decides
  low_key = __reduce_max_sync(kFullMask, low_key);
  top_key = __reduce_max_sync(kFullMask, top_key);
  nonfinite = __reduce_max_sync(kFullMask, nonfinite);
  decreased = __reduce_max_sync(kFullMask, decreased);
  if (lane == 0) {
    red[0][wid] = low_key;
    red[1][wid] = top_key;
    red[2][wid] = nonfinite;
    red[3][wid] = decreased;
  }
  __syncthreads();
  if (tid == 0) {
    unsigned r[4] = {0, 0, 0, 0};
    for (int w = 0; w < kExactWarps; ++w)
      for (int q = 0; q < 4; ++q) r[q] = max(r[q], red[q][w]);
    if (r[0]) atomicMax(&st->low_key, r[0]);
    if (r[1]) atomicMax(&st->top_key, r[1]);
    if (r[2]) atomicMax(&st->nonfinite, r[2]);
    if (r[3]) atomicMax(&st->decreased, r[3]);
    __threadfence();
    if (atomicAdd(&st->blocks_done, 1u) == gridDim.x - 1) {
      __threadfence();
      const volatile SumState* vs = st;
      st->route = decide_route(vs->low_key, vs->top_key, vs->nonfinite,
                               vs->decreased, n);
    }
  }
}

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

// The chain route: the runs of the ids as they come (kRouteRuns) or of
// their grouped copy (kRouteGrouped); returns at once on the exact route.
// (at most 80 registers: three blocks an SM, for the latency of the scan)
__global__ void __launch_bounds__(kSumThreads, 3)
segment_sum_runs_kernel(const int32_t* raw_seg, const double* raw_vals,
                        const int32_t* grouped_seg,
                        const double* grouped_vals, long long n,
                        double* __restrict__ out, int num_segments,
                        const SumState* st) {
  constexpr int kRows = 32 * kChunk;
  __shared__ double stage[kSumWarps][32 * kLook];
  // the chunk's ids and the id after it, loaded all at once
  __shared__ int ids[kSumWarps][kRows + 1];
  const unsigned route = st->route;
  if (route == kRouteExact) return;
  const bool raw = route == kRouteRuns;
  const int32_t* __restrict__ seg = raw ? raw_seg : grouped_seg;
  const double* __restrict__ vals = raw ? raw_vals : grouped_vals;
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
  __device__ bool skip() const { return false; }
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
// value to the row's place in segment order.  Every kernel of the sort
// returns at once unless the call's route is the grouped one.
struct GroupEnds {
  const int32_t* ids;
  uint32_t num_buckets;
  const double* vals;
  int32_t* grouped_ids;
  double* grouped_vals;
  const SumState* st;
  __device__ bool skip() const { return st->route != kRouteGrouped; }
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
        ends, c.tile_prefix, tiles, c.st.digit_counts + pass * radix::kBuckets);
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
// The table holds one (cnt, inv) pair of int32 per slot, so that a probe
// reads both in one 8-byte gather.
//
// Replaces segment_join/kernel.py::join_table_build_pallas (2-D grid of row
// tiles x domain blocks, one-hot sums and maxima, with block skipping).
// Bound: bytes -- 8 bytes read per build row, the table written once.
// The caller zeroes the table; the max makes "the largest build row wins"
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
                        int32_t* __restrict__ table, int domain_pad) {
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
          atomicAdd(&table[2 * key], total);
          atomicMax(&table[2 * key + 1], top);
        }
      } else if (live) {
        atomicAdd(&table[2 * key], run_n);
        atomicMax(&table[2 * key + 1], run_max);
      }
      if (ends) {
        run_n = 0;
        run_max = 0;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// join_table_probe: per probe row (cnt[c], inv[c] + bias); codes outside
// [0, domain_pad) gather (0, bias).
//
// Replaces segment_join/kernel.py::join_table_probe_pallas (per-probe gather
// as a one-hot matmul over each domain block, over probes radix-ordered by
// domain block so that each block meets its probes once).  Hopper needs no
// such order: a gather reads its slot directly, and the outputs do not
// depend on the order the probes run in.  So radix_hash_probe probes in the
// probe side's own row order and writes cnt_p and build_row = inv - 1 (bias
// -1) straight into row order, with no partition of the probe side and no
// gathers back.
// Bound: bytes -- 4 bytes read and 8 written per probe row, plus the table
// sectors the gathers touch.  Design: a thread takes 4 consecutive probes
// (one 16-byte load of codes where the pointer allows, two 16-byte
// stores), and each probe reads its slot's (cnt, inv) pair in one 8-byte
// gather when the table is the build's interleaved one (kPairs), or two
// 4-byte gathers from separate tables.
// ---------------------------------------------------------------------------
constexpr int kProbeThreads = 256;

template <bool kPairs>
__device__ __forceinline__ int2 probe_slot(const int32_t* __restrict__ cnt,
                                           const int32_t* __restrict__ inv,
                                           int c, int domain_pad, int bias) {
  if (c < 0 || c >= domain_pad) return make_int2(0, bias);
  if (kPairs) {
    const int2 e = __ldg(reinterpret_cast<const int2*>(cnt) + c);
    return make_int2(e.x, e.y + bias);
  }
  return make_int2(__ldg(cnt + c), __ldg(inv + c) + bias);
}

template <bool kPairs>
__global__ void __launch_bounds__(kProbeThreads)
join_table_probe_kernel(const int32_t* __restrict__ pk, long long n,
                        const int32_t* __restrict__ cnt,
                        const int32_t* __restrict__ inv, int domain_pad,
                        int bias, int vec, int32_t* __restrict__ cnt_p,
                        int32_t* __restrict__ inv_p) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t0 =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long quads = vec ? n / 4 : 0;
  for (long long q = t0; q < quads; q += stride) {
    const int4 c = reinterpret_cast<const int4*>(pk)[q];
    const int2 a = probe_slot<kPairs>(cnt, inv, c.x, domain_pad, bias);
    const int2 b = probe_slot<kPairs>(cnt, inv, c.y, domain_pad, bias);
    const int2 d = probe_slot<kPairs>(cnt, inv, c.z, domain_pad, bias);
    const int2 e = probe_slot<kPairs>(cnt, inv, c.w, domain_pad, bias);
    reinterpret_cast<int4*>(cnt_p)[q] = make_int4(a.x, b.x, d.x, e.x);
    reinterpret_cast<int4*>(inv_p)[q] = make_int4(a.y, b.y, d.y, e.y);
  }
  for (long long i = quads * 4 + t0; i < n; i += stride) {
    const int2 a = probe_slot<kPairs>(cnt, inv, pk[i], domain_pad, bias);
    cnt_p[i] = a.x;
    inv_p[i] = a.y;
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

// Bytes of scratch repro_segment_sum_f64 needs: the grouping's sort and
// the grouped ids and values (used when the route is the grouped one).
long long repro_segment_sum_f64_scratch_bytes(long long n, int num_segments) {
  if (n <= 0 || num_segments <= 0) return 0;
  const CountedScratch c = carve_counted(nullptr, n, num_segments, false);
  return static_cast<long long>(c.bytes + radix::align_up(n * sizeof(int32_t)) +
                                radix::align_up(n * sizeof(double)));
}

// Byte offset of SumState::route in the state after the sums.
long long repro_segment_sum_route_offset() {
  return static_cast<long long>(offsetof(SumState, route));
}

// Bytes of the state repro_segment_sum_f64 keeps after the sums.
long long repro_segment_sum_state_bytes() {
  return static_cast<long long>(sizeof(SumState));
}

// out: [num_segments] float64 followed by repro_segment_sum_state_bytes()
// of state, all zeroed by the caller; scratch holds
// repro_segment_sum_f64_scratch_bytes(n, num_segments) bytes.
int repro_segment_sum_f64(const void* seg, const void* vals, long long n,
                          void* out, int num_segments, void* scratch,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || num_segments <= 0) return static_cast<int>(cudaGetLastError());
  if (n > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int32_t* ids = static_cast<const int32_t*>(seg);
  const double* v = static_cast<const double*>(vals);
  double* sums = static_cast<double*>(out);
  SumState* st = reinterpret_cast<SumState*>(sums + num_segments);
  const int vec = (reinterpret_cast<uintptr_t>(ids) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0);
  // a block a tile up to 132 * 64 tiles: unsorted ids' atomics to random
  // addresses want many blocks in flight (134 us at 6,001,215 rows against
  // 162 us with 4 blocks an SM; sorted ids take 39-41 us either way)
  const long long tiles = (n + kExactTile - 1) / kExactTile;
  segment_sum_exact_kernel<<<grid_for(tiles, 1, 132 * 64), kExactThreads, 0,
                             s>>>(ids, v, n, sums, num_segments, vec, st);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  const CountedScratch c = carve_counted(base, n, num_segments, false);
  int32_t* gids = reinterpret_cast<int32_t*>(base + c.bytes);
  double* gvals = reinterpret_cast<double*>(
      base + c.bytes + radix::align_up(n * sizeof(int32_t)));
  const GroupEnds ends{ids, static_cast<uint32_t>(num_segments), v, gids,
                       gvals, st};
  counted_passes(ends, c, n, num_segments, nullptr, s);
  segment_sum_runs_kernel<<<sum_grid(n), kSumThreads, 0, s>>>(
      ids, v, gids, gvals, n, sums, num_segments, st);
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

// table: [domain_pad][2] int32 (cnt, inv) pairs, zeroed by the caller.
int repro_join_table_build(const void* bk, const void* brow, long long n,
                           void* table, int domain_pad, void* stream) {
  if (n > 0) {
    join_table_build_kernel<<<grid_for((n + kBuildRows - 1) / kBuildRows,
                                       kBuildThreads, 132 * 8),
                              kBuildThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(bk), static_cast<const int32_t*>(brow), n,
        static_cast<int32_t*>(table), domain_pad);
  }
  return static_cast<int>(cudaGetLastError());
}

// pairs: cnt points at the build's [domain_pad][2] table (inv unused);
// else cnt and inv are separate [domain_pad] tables.  inv_p gets inv + bias.
int repro_join_table_probe(const void* pk, long long n, const void* cnt,
                           const void* inv, int domain_pad, int pairs,
                           int bias, void* cnt_p, void* inv_p, void* stream) {
  if (n > 0) {
    const auto* codes = static_cast<const int32_t*>(pk);
    auto* out_c = static_cast<int32_t*>(cnt_p);
    auto* out_i = static_cast<int32_t*>(inv_p);
    const int vec = (reinterpret_cast<uintptr_t>(codes) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out_c) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out_i) % 16 == 0);
    const int grid = grid_for((n + 3) / 4, kProbeThreads, 132 * 16);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto* tc = static_cast<const int32_t*>(cnt);
    const auto* ti = static_cast<const int32_t*>(inv);
    if (pairs) {
      join_table_probe_kernel<true><<<grid, kProbeThreads, 0, s>>>(
          codes, n, tc, ti, domain_pad, bias, vec, out_c, out_i);
    } else {
      join_table_probe_kernel<false><<<grid, kProbeThreads, 0, s>>>(
          codes, n, tc, ti, domain_pad, bias, vec, out_c, out_i);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
