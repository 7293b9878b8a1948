// Hopper (sm_90a) kernel for the relational engine's multi-key sort: one
// stable LSD radix pass over one key column.
//
// Replaces src/repro/kernels/multikey_sort/kernel.py::bitonic_tile_sort_pallas
// and the XLA merge that multikey_sort/ops.py runs after it.  The TPU design
// sorts VMEM-sized tiles with a bitonic network and merges the runs in XLA,
// stable because the payload is the row's position.  Neither half suits
// Hopper: a block's shared memory is far smaller than VMEM, and a merge of
// runs is a second global pass anyway.  A stable LSD radix sort over the
// whole column computes the same order, (key, position) ascending, directly.
//
// One call of repro_radix_sort_pass sorts the rows of a permutation stably
// by one key column:
//   1. gather the column once through the current permutation (one random
//      read) into a contiguous buffer of order-preserving unsigned bits:
//      signed integers flip the sign bit; floats first turn -0.0 into +0.0
//      and every NaN into one quiet NaN (so that the order is torch.sort's
//      and jnp.argsort's: -0.0 == +0.0, NaN last), then flip every bit when
//      the sign is set, else only the sign bit; unsigned integers and bool
//      are taken as they are;
//   2. one stable pass per 8-bit digit, least significant first, carrying
//      (key bits, position) pairs:
//        a. per-tile 256-bucket histograms in shared memory, written
//           bucket-major as hist[bucket][tile];
//        b. one block per bucket scans its column in place (the position
//           of each tile's first row with that digit, counted within the
//           bucket) and writes the bucket's total, so 256 blocks share
//           the scan instead of one block walking all 256 x tiles cells;
//        c. the scatter: every block first turns the 256 totals into
//           bucket bases (a block scan); every warp of the tile block owns
//           a consecutive sub-chunk and its own 256 counters in shared
//           memory (1 KB), a prefix over the warps gives each warp its base
//           per bucket, and each warp walks its rows in order, 32 at a
//           time, ranking lanes with equal digits with __match_any_sync.
//           Walking in row order inside a warp, warps in order inside a
//           tile and tiles in order through the scan is what makes the
//           pass stable.
//      The last digit pass writes the int64 output permutation
//      (perm_out[dest] = perm_in[position]) instead of the pair buffers.
//
// Bound: bytes -- the key column is read once and the int64 permutation
// written once; every digit pass adds a read of the key bits for the
// histogram and a read and scattered write of the pairs, so an 8-byte key
// costs 8 passes.  The first version runs every digit; skipping digits that
// are constant over the column is the obvious later optimisation.
//
// The exported function has a plain C interface (raw device pointers, an
// int64 row count, the caller's stream), launches on that stream, never
// synchronises and allocates nothing: the wrapper in
// repro_torch/kernels/multikey_sort/kernel.py allocates the output and one
// scratch buffer of repro_radix_sort_scratch_bytes(n, elem_bytes) bytes.  It
// returns cudaGetLastError(), so a refused launch is reported at the call.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDigitBits = 8;
constexpr int kBuckets = 1 << kDigitBits;
constexpr int kThreads = 256;                  // one thread per bucket
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 2048;                    // rows per block
constexpr int kWarpRows = kTile / kWarps;      // a warp's sub-chunk
constexpr int kScanItems = 8;
constexpr unsigned kFullMask = 0xffffffffu;
static_assert(kThreads == kBuckets, "the warp prefix gives one bucket per thread");

enum KeyKind { kUnsigned = 0, kSigned = 1, kFloat = 2 };

__device__ __forceinline__ uint64_t load_raw(const void* col, long long r,
                                             int elem_bytes) {
  switch (elem_bytes) {
    case 1: return static_cast<const uint8_t*>(col)[r];
    case 2: return static_cast<const uint16_t*>(col)[r];
    case 4: return static_cast<const uint32_t*>(col)[r];
    default: return static_cast<const uint64_t*>(col)[r];
  }
}

// Order-preserving unsigned bits of one key of width 8 * elem_bytes.
// inf_bits is the dtype's +inf pattern (floats only): magnitudes above it
// are NaNs.
__device__ __forceinline__ uint64_t order_bits(uint64_t raw, int elem_bytes,
                                               int kind, uint64_t inf_bits) {
  const int w = elem_bytes * 8;
  const uint64_t sign = 1ull << (w - 1);
  const uint64_t mask = (w == 64) ? ~0ull : ((1ull << w) - 1ull);
  if (kind == kSigned) return raw ^ sign;
  if (kind == kFloat) {
    const uint64_t mag = raw & (sign - 1ull);
    if (mag == 0) raw = 0;                                  // -0.0 -> +0.0
    else if (mag > inf_bits) raw = inf_bits | (inf_bits >> 1);  // quiet NaN
    return (raw & sign) ? (~raw & mask) : (raw | sign);
  }
  return raw;
}

template <typename K>
__global__ void gather_bits_kernel(const void* __restrict__ col, int elem_bytes,
                                   int kind, uint64_t inf_bits,
                                   const int64_t* __restrict__ perm_in,
                                   long long n, K* __restrict__ keys,
                                   int32_t* __restrict__ pos) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const long long r = perm_in ? perm_in[i] : i;
    keys[i] = static_cast<K>(
        order_bits(load_raw(col, r, elem_bytes), elem_bytes, kind, inf_bits));
    pos[i] = static_cast<int32_t>(i);
  }
}

template <typename K>
__device__ __forceinline__ int digit_of(K key, int shift) {
  return static_cast<int>((key >> shift) & static_cast<K>(kBuckets - 1));
}

// a. hist[b * num_tiles + t] = rows of tile t whose digit is b
template <typename K>
__global__ void digit_hist_kernel(const K* __restrict__ keys, long long n,
                                  int shift, int num_tiles,
                                  int32_t* __restrict__ hist) {
  __shared__ int32_t counts[kBuckets];
  const int lane = threadIdx.x & 31;
  counts[threadIdx.x] = 0;
  __syncthreads();
  const long long lo = static_cast<long long>(blockIdx.x) * kTile;
  const long long hi = (lo + kTile < n) ? lo + kTile : n;
  for (long long base = lo + (threadIdx.x & ~31); base < hi;
       base += kThreads) {
    const long long i = base + lane;
    const int d = (i < hi) ? digit_of(keys[i], shift) : -1;
    // one shared atomic per distinct digit in the warp: a column whose
    // high bytes are constant would otherwise serialise 32 lanes on one
    // counter
    const unsigned peers = __match_any_sync(kFullMask, d);
    if (d >= 0 && lane == __ffs(peers) - 1) atomicAdd(&counts[d], __popc(peers));
  }
  __syncthreads();
  hist[static_cast<long long>(threadIdx.x) * num_tiles + blockIdx.x] =
      counts[threadIdx.x];
}

// b. block b: exclusive scan in place of hist[b][0, num_tiles), the
//    bucket's total into totals[b]
__global__ void column_scan_kernel(int32_t* __restrict__ hist, int num_tiles,
                                   int32_t* __restrict__ totals) {
  __shared__ int32_t warp_sums[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  int32_t* data = hist + static_cast<long long>(blockIdx.x) * num_tiles;
  int32_t carry = 0;
  for (int chunk = 0; chunk < num_tiles; chunk += kThreads * kScanItems) {
    const int mine = chunk + tid * kScanItems;
    int32_t v[kScanItems];
    int32_t sum = 0;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      v[k] = (mine + k < num_tiles) ? data[mine + k] : 0;
      sum += v[k];
    }
    int32_t incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t o = __shfl_up_sync(kFullMask, incl, d);
      if (lane >= d) incl += o;
    }
    if (lane == 31) warp_sums[wid] = incl;
    __syncthreads();
    int32_t run = carry + incl - sum;
    int32_t chunk_total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w < wid) run += warp_sums[w];
      chunk_total += warp_sums[w];
    }
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      if (mine + k < num_tiles) data[mine + k] = run;
      run += v[k];
    }
    carry += chunk_total;
    __syncthreads();  // warp_sums is rewritten by the next chunk
  }
  if (tid == 0) totals[blockIdx.x] = carry;
}

// c. stable scatter of one tile; hist holds the per-bucket scanned bases,
//    totals the bucket sizes
template <typename K>
__global__ void digit_scatter_kernel(const K* __restrict__ keys_in,
                                     const int32_t* __restrict__ pos_in,
                                     long long n, int shift, int num_tiles,
                                     const int32_t* __restrict__ hist,
                                     const int32_t* __restrict__ totals,
                                     K* __restrict__ keys_out,
                                     int32_t* __restrict__ pos_out, int last,
                                     const int64_t* __restrict__ perm_in,
                                     int64_t* __restrict__ perm_out) {
  __shared__ int32_t base[kWarps][kBuckets];
  __shared__ int32_t total_sums[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const unsigned lower = (1u << lane) - 1u;
  for (int b = lane; b < kBuckets; b += 32) base[wid][b] = 0;
  __syncwarp();
  // bucket tid's first output position: an exclusive scan of the totals
  const int32_t total = totals[tid];
  int32_t incl = total;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t o = __shfl_up_sync(kFullMask, incl, d);
    if (lane >= d) incl += o;
  }
  if (lane == 31) total_sums[wid] = incl;
  const long long tile_lo = static_cast<long long>(blockIdx.x) * kTile;
  const long long lo = tile_lo + static_cast<long long>(wid) * kWarpRows;
  long long hi = lo + kWarpRows;
  if (hi > n) hi = n;
  // per-warp digit counts of the warp's sub-chunk
  for (long long b0 = lo; b0 < hi; b0 += 32) {
    const long long i = b0 + lane;
    const int d = (i < hi) ? digit_of(keys_in[i], shift) : -1;
    const unsigned peers = __match_any_sync(kFullMask, d);
    if (d >= 0 && lane == __ffs(peers) - 1) base[wid][d] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // prefix over warps: thread b turns column b into per-warp bases
  {
    int32_t run = incl - total +
                  hist[static_cast<long long>(tid) * num_tiles + blockIdx.x];
    for (int w = 0; w < wid; ++w) run += total_sums[w];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int32_t c = base[w][tid];
      base[w][tid] = run;
      run += c;
    }
  }
  __syncthreads();
  for (long long b0 = lo; b0 < hi; b0 += 32) {
    const long long i = b0 + lane;
    const bool live = i < hi;
    K key = 0;
    int32_t p = 0;
    int d = -1;
    if (live) {
      key = keys_in[i];
      p = pos_in[i];
      d = digit_of(key, shift);
    }
    const unsigned peers = __match_any_sync(kFullMask, d);
    const int leader = __ffs(peers) - 1;
    const int32_t start = live ? base[wid][d] : 0;
    __syncwarp();
    if (live && lane == leader) base[wid][d] = start + __popc(peers);
    __syncwarp();
    if (live) {
      const int32_t dest = start + __popc(peers & lower);
      if (last) {
        perm_out[dest] = perm_in ? perm_in[p] : static_cast<int64_t>(p);
      } else {
        keys_out[dest] = key;
        pos_out[dest] = p;
      }
    }
  }
}

inline size_t align_up(size_t v) { return (v + 255) & ~static_cast<size_t>(255); }

inline long long tiles_for(long long n) { return (n + kTile - 1) / kTile; }

inline size_t key_bytes(int elem_bytes) { return elem_bytes > 4 ? 8 : 4; }

template <typename K>
int sort_pass(const void* col, int elem_bytes, int kind, uint64_t inf_bits,
              const int64_t* perm_in, long long n, int64_t* perm_out,
              unsigned char* scratch, cudaStream_t s) {
  const long long num_tiles = tiles_for(n);
  unsigned char* p = scratch;
  K* keys[2];
  int32_t* pos[2];
  for (int k = 0; k < 2; ++k) {
    keys[k] = reinterpret_cast<K*>(p);
    p += align_up(n * sizeof(K));
  }
  for (int k = 0; k < 2; ++k) {
    pos[k] = reinterpret_cast<int32_t*>(p);
    p += align_up(n * sizeof(int32_t));
  }
  int32_t* hist = reinterpret_cast<int32_t*>(p);
  p += align_up(static_cast<size_t>(num_tiles) * kBuckets * sizeof(int32_t));
  int32_t* totals = reinterpret_cast<int32_t*>(p);
  long long grid = (n + kThreads - 1) / kThreads;
  if (grid > 132 * 16) grid = 132 * 16;
  gather_bits_kernel<K><<<static_cast<int>(grid), kThreads, 0, s>>>(
      col, elem_bytes, kind, inf_bits, perm_in, n, keys[0], pos[0]);
  const int passes = elem_bytes;  // 8-bit digits
  for (int pass = 0; pass < passes; ++pass) {
    const int shift = pass * kDigitBits;
    const int src = pass & 1, dst = src ^ 1;
    const int last = pass == passes - 1;
    digit_hist_kernel<K><<<static_cast<int>(num_tiles), kThreads, 0, s>>>(
        keys[src], n, shift, static_cast<int>(num_tiles), hist);
    column_scan_kernel<<<kBuckets, kThreads, 0, s>>>(
        hist, static_cast<int>(num_tiles), totals);
    digit_scatter_kernel<K><<<static_cast<int>(num_tiles), kThreads, 0, s>>>(
        keys[src], pos[src], n, shift, static_cast<int>(num_tiles), hist,
        totals, keys[dst], pos[dst], last, perm_in, perm_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* repro_sort_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Bytes of scratch repro_radix_sort_pass needs for n rows of elem_bytes.
long long repro_radix_sort_scratch_bytes(long long n, int elem_bytes) {
  if (n <= 0) return 0;
  return static_cast<long long>(
      2 * align_up(n * key_bytes(elem_bytes)) +
      2 * align_up(n * sizeof(int32_t)) +
      align_up(static_cast<size_t>(tiles_for(n)) * kBuckets * sizeof(int32_t)) +
      align_up(kBuckets * sizeof(int32_t)));
}

// perm_out[k] = perm_in[j] (or j when perm_in is null), where j runs over
// [0, n) stably sorted by the key col[perm_in[j]].  elem_bytes is 1, 2, 4
// or 8; kind 0 unsigned or bool, 1 signed, 2 float (inf_bits its +inf
// pattern).  n must fit int32.
int repro_radix_sort_pass(const void* col, int elem_bytes, int kind,
                          unsigned long long inf_bits, const void* perm_in,
                          long long n, void* perm_out, void* scratch,
                          void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (n > 0x7fffffffLL || (elem_bytes != 1 && elem_bytes != 2 &&
                           elem_bytes != 4 && elem_bytes != 8) ||
      kind < kUnsigned || kind > kFloat) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* pin = static_cast<const int64_t*>(perm_in);
  int64_t* pout = static_cast<int64_t*>(perm_out);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  if (elem_bytes > 4) {
    return sort_pass<uint64_t>(col, elem_bytes, kind, inf_bits, pin, n, pout,
                               sc, s);
  }
  return sort_pass<uint32_t>(col, elem_bytes, kind, inf_bits, pin, n, pout,
                             sc, s);
}

}  // extern "C"
