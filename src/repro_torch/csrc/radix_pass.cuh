// Stable LSD counting sort by 8-bit digits for Hopper (sm_90a), shared by
// segment_join.cu (radix_rank) and multikey_sort.cu (radix_sort_pass).  The
// sort carries (key, position) pairs through the digits, least significant
// first; each includes this header and supplies a small struct ("ends")
// that says where the first pass reads its keys and what the last writes,
// and whether the sort is wanted at all (ends.skip(), read on the device as
// each kernel starts: a skipped sort costs one near-empty launch a kernel
// and no host sync).
//
// Every digit pass ranks 2,048-row tiles the same way (digit_pass_kernel):
// each warp of the tile's block counts the digits of its 256 consecutive
// rows in its own shared-memory counters, a prefix over the warps and over
// the digit values gives each warp its base per digit, and each warp walks
// its rows in order, 32 at a time, ranking the lanes with equal digits by
// one ballot per digit bit.  Tiles in order, warps in order inside a tile
// and lanes in order inside a warp make the pass stable.  A tile learns how
// many rows of each digit the earlier tiles hold in one of two ways:
//
//  * chained (one kernel per digit): the block takes the next tile from a
//    ticket counter, publishes its own count of each digit and reads the
//    earlier tiles' counts by decoupled look-back (the ticket order
//    guarantees every earlier tile's block is already running, so the wait
//    ends).  The digit's start comes from digit_count_kernel, which reads
//    the keys once and counts every digit, since counts do not depend on
//    the order of the rows.  With bit statistics from the same read, a pass
//    whose digit is the same in every key returns at once, and each running
//    pass finds its buffers and whether it is the last from them on the
//    device: a skipped digit costs one near-empty launch and no host sync.
//    radix_sort_pass runs this way.
//  * counted (three kernels per digit): tile_hist_kernel counts each tile's
//    digits into a digit-major [256][tiles] matrix, column_scan_kernel (one
//    block per digit value) turns each row into the earlier tiles' counts
//    and the digit's total, and the pass reads its tile's column.  No block
//    waits for another.  radix_rank runs this way: it sorts on every digit,
//    so skipping would save nothing.
//
// Bound: bytes.  Per digit the pass reads the keys and positions and writes
// them once (the last pass writes the caller's output instead).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace radix {

constexpr int kDigitBits = 8;
constexpr int kBuckets = 1 << kDigitBits;
constexpr int kThreads = 256;                  // one thread per digit value
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                      // rows per lane and tile
constexpr int kWarpRows = 32 * kItems;
constexpr int kTile = kWarps * kWarpRows;      // 2,048 rows per block
constexpr int kWindow = 4;                     // look-back words per load
constexpr int kCountItems = 8;                 // rows per lane and step
constexpr int kMaxDigits = 8;
constexpr int kCountBlocks = 132 * 4;          // digit_count_kernel's grid cap
constexpr int kScanItems = 8;
constexpr unsigned kFullMask = 0xffffffffu;
static_assert(kThreads == kBuckets, "one thread per digit value");

inline long long tiles_for(long long n) { return (n + kTile - 1) / kTile; }

inline size_t align_up(size_t v) {
  return (v + 255) & ~static_cast<size_t>(255);
}

inline int count_grid(long long n) {
  long long g = (n + kThreads * kCountItems - 1) / (kThreads * kCountItems);
  if (g > kCountBlocks) g = kCountBlocks;
  return static_cast<int>(g < 1 ? 1 : g);
}

// Device state of one sort.  digit_counts[p][d] is the number of keys whose
// digit p is d.  The chained passes also use the rest, zeroed
// (cudaMemsetAsync) before the first kernel: the look-back words hold
// (flag << 32 | count), flag 2(p+1) marking a tile's own count in pass p
// and 2(p+1)+1 its count including every earlier tile; anything lower is
// not yet published, so one zeroing serves every pass.
struct State {
  int32_t* digit_counts;          // [kMaxDigits][kBuckets]
  unsigned long long* bit_stats;  // [OR of keys, OR of complements]
  unsigned int* tickets;          // [kMaxDigits]
  unsigned int* ran;              // bit p: pass p ran
  unsigned long long* lookback;   // [tiles][kBuckets]
};

inline size_t digit_counts_bytes() {
  return align_up(kMaxDigits * kBuckets * sizeof(int32_t));
}

inline size_t tickets_offset() {
  return digit_counts_bytes() + align_up(2 * sizeof(unsigned long long));
}

// the byte offset of State::ran from the start of the state
inline size_t ran_offset() {
  return tickets_offset() + kMaxDigits * sizeof(unsigned int);
}

inline size_t lookback_offset() {
  return tickets_offset() + align_up((kMaxDigits + 1) * sizeof(unsigned int));
}

inline size_t state_bytes(long long n) {
  return lookback_offset() +
         align_up(static_cast<size_t>(tiles_for(n)) * kBuckets *
                  sizeof(unsigned long long));
}

inline State carve_state(unsigned char* p) {
  State s;
  s.digit_counts = reinterpret_cast<int32_t*>(p);
  s.bit_stats = reinterpret_cast<unsigned long long*>(p + digit_counts_bytes());
  s.tickets = reinterpret_cast<unsigned int*>(p + tickets_offset());
  s.ran = reinterpret_cast<unsigned int*>(p + ran_offset());
  s.lookback = reinterpret_cast<unsigned long long*>(p + lookback_offset());
  return s;
}

template <typename K>
struct Buffers {
  K* keys[2];
  int32_t* pos[2];
};

template <typename K>
__device__ __forceinline__ unsigned digit_of(K key, int shift) {
  return static_cast<unsigned>((key >> shift) & static_cast<K>(kBuckets - 1));
}

__device__ __forceinline__ unsigned long long or_over_warp(
    unsigned long long v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v |= __shfl_xor_sync(kFullMask, v, d);
  return v;
}

__device__ __forceinline__ unsigned long long load_word(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_word(unsigned long long* p,
                                           unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// This lane's share of a count of the warp's live values: the whole count
// on lane 0 when every live lane holds the same value (a sorted column, a
// constant byte), so that one atomic adds it, else 1 on each live lane.
__device__ __forceinline__ int warp_share(unsigned v, bool live, int lane) {
  const unsigned lo = __reduce_min_sync(kFullMask, live ? v : 0xffffffffu);
  const unsigned hi = __reduce_max_sync(kFullMask, live ? v : 0u);
  const int alive = __popc(__ballot_sync(kFullMask, live));
  if (lo != hi) return live ? 1 : 0;
  return lane == 0 ? alive : 0;
}

// The live lanes of the warp whose digit equals this lane's (0 for a lane
// that is not live), from one ballot per digit bit; a digit the whole warp
// shares takes two reductions and no ballots.
__device__ __forceinline__ unsigned digit_peers(unsigned d, bool live) {
  const unsigned alive = __ballot_sync(kFullMask, live);
  const unsigned lo = __reduce_min_sync(kFullMask, live ? d : kBuckets - 1u);
  const unsigned hi = __reduce_max_sync(kFullMask, live ? d : 0u);
  unsigned peers = alive;
  if (lo != hi) {
#pragma unroll
    for (int b = 0; b < kDigitBits; ++b) {
      const unsigned bit = (d >> b) & 1u;
      const unsigned m = __ballot_sync(kFullMask, bit);
      peers &= bit ? m : ~m;
    }
  }
  return live ? peers : 0u;
}

// out[i] = carry + in[0] + ... + in[i-1] for i < n, by one block of kT
// threads (in == out is allowed); returns carry + the sum of in.  Chunks of
// kT * kScanItems values go through shared memory, so that device memory
// is read and written with neighbouring threads on neighbouring values.
template <int kT>
__device__ int32_t block_exclusive_scan(const int32_t* in, int32_t* out,
                                        long long n, int32_t carry) {
  constexpr int kChunk = kT * kScanItems;
  __shared__ int32_t sh[kChunk + kChunk / 32];  // one pad word per 32
  __shared__ int32_t warp_sums[kT / 32];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  for (long long c0 = 0; c0 < n; c0 += kChunk) {
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const int i = k * kT + tid;
      sh[i + (i >> 5)] = c0 + i < n ? in[c0 + i] : 0;
    }
    __syncthreads();
    int32_t v[kScanItems];
    int32_t sum = 0;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const int i = tid * kScanItems + k;
      v[k] = sh[i + (i >> 5)];
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
    for (int w = 0; w < kT / 32; ++w) {
      if (w < wid) run += warp_sums[w];
      chunk_total += warp_sums[w];
    }
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const int i = tid * kScanItems + k;
      sh[i + (i >> 5)] = run;
      run += v[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const int i = k * kT + tid;
      if (c0 + i < n) out[c0 + i] = sh[i + (i >> 5)];
    }
    carry += chunk_total;
    __syncthreads();  // sh and warp_sums are rewritten by the next chunk
  }
  return carry;
}

// Which passes run: on the chained schedule the digits in which the keys
// differ (their bit statistics from digit_count_kernel), else every digit.
__device__ __forceinline__ unsigned running_digits(const State& st,
                                                   int num_digits,
                                                   bool chained) {
  if (!chained) return (1u << num_digits) - 1u;
  const unsigned long long varying = st.bit_stats[0] & st.bit_stats[1];
  unsigned mask = 0;
  for (int p = 0; p < num_digits; ++p)
    if (digit_of(varying, p * kDigitBits)) mask |= 1u << p;
  return mask;
}

// The warp's rows of a tile for the k-th running pass (k from 0), which
// reads the first keys through ends.first_key at k == 0, else buffer k & 1,
// and writes buffer (k + 1) & 1.
template <typename K, typename Ends>
__device__ __forceinline__ void load_rows(const Ends& ends,
                                          const Buffers<K>& buf, int k,
                                          long long lo, long long n, int lane,
                                          K (&key)[kItems],
                                          int32_t (&pos)[kItems]) {
  const K* keys_in = (k & 1) ? buf.keys[1] : buf.keys[0];
  const int32_t* pos_in = (k & 1) ? buf.pos[1] : buf.pos[0];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = lo + j * 32 + lane;
    key[j] = 0;
    pos[j] = 0;
    if (i < n) {
      key[j] = k == 0 ? ends.first_key(i) : keys_in[i];
      pos[j] = k == 0 ? static_cast<int32_t>(i) : pos_in[i];
    }
  }
}

// Chained schedule, step 1.  Src supplies key(i) (it may store the key as a
// side effect).  Counts every digit of every key and reduces the OR of the
// keys and of their complements.
template <typename K, typename Src>
__global__ void __launch_bounds__(kThreads)
digit_count_kernel(Src src, long long n, int num_digits, State st) {
  __shared__ int32_t hist[kMaxDigits * kBuckets];
  __shared__ unsigned long long red[2][kWarps];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  for (int b = tid; b < num_digits * kBuckets; b += kThreads) hist[b] = 0;
  __syncthreads();
  unsigned long long any = 0, any_not = 0;
  // each warp takes 32 x kCountItems consecutive rows a step, all loaded
  // before any is counted
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long base = (static_cast<long long>(blockIdx.x) * kWarps + wid) *
                        (32 * kCountItems);
       base < n; base += warps * 32 * kCountItems) {
    K key[kCountItems];
#pragma unroll
    for (int j = 0; j < kCountItems; ++j) {
      const long long i = base + j * 32 + lane;
      key[j] = i < n ? src.key(i) : K(0);
    }
#pragma unroll
    for (int j = 0; j < kCountItems; ++j) {
      const bool live = base + j * 32 + lane < n;
      if (live) {
        any |= static_cast<unsigned long long>(key[j]);
        any_not |= ~static_cast<unsigned long long>(key[j]);
      }
      for (int p = 0; p < num_digits; ++p) {
        const unsigned d = digit_of(key[j], p * kDigitBits);
        const int c = warp_share(d, live, lane);
        if (c) atomicAdd(&hist[p * kBuckets + d], c);
      }
    }
  }
  any = or_over_warp(any);
  any_not = or_over_warp(any_not);
  if (lane == 0) {
    red[0][wid] = any;
    red[1][wid] = any_not;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kWarps; ++w) {
      red[0][0] |= red[0][w];
      red[1][0] |= red[1][w];
    }
    atomicOr(&st.bit_stats[0], red[0][0]);
    atomicOr(&st.bit_stats[1], red[1][0]);
  }
  for (int b = tid; b < num_digits * kBuckets; b += kThreads)
    if (hist[b]) atomicAdd(&st.digit_counts[b], hist[b]);
}

// Counted schedule, step a: hist[d][t] = rows of tile t whose digit `pass`
// is d.  Pass 0 also calls ends.visit(key, c): c more rows hold key
// (radix_rank's bucket histogram, from the same read).  32-bit keys.
template <typename K, typename Ends>
__global__ void __launch_bounds__(kThreads)
tile_hist_kernel(Ends ends, Buffers<K> buf, long long n, int pass,
                 int num_tiles, int32_t* __restrict__ hist) {
  __shared__ int32_t cnt[kBuckets];
  if (ends.skip()) return;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  cnt[tid] = 0;
  __syncthreads();
  const long long t = blockIdx.x;
  const long long lo = t * kTile + static_cast<long long>(wid) * kWarpRows;
  K key[kItems];
  int32_t pos[kItems];
  load_rows(ends, buf, pass, lo, n, lane, key, pos);
  // lane 0 carries the count of a key that fills whole row groups until the
  // key changes: a sorted column adds each key once per warp, not once per
  // 32 rows (a bucket of millions of padding rows would otherwise queue
  // that many atomics on one counter)
  unsigned carry_key = 0;
  int carry = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool live = lo + j * 32 + lane < n;
    const unsigned d = digit_of(key[j], pass * kDigitBits);
    const int c = warp_share(d, live, lane);
    if (c) atomicAdd(&cnt[d], c);
    if (pass == 0) {
      const unsigned kv = static_cast<unsigned>(key[j]);
      const unsigned lo_k = __reduce_min_sync(kFullMask, live ? kv : ~0u);
      const unsigned hi_k = __reduce_max_sync(kFullMask, live ? kv : 0u);
      const int alive = __popc(__ballot_sync(kFullMask, live));
      if (lo_k == hi_k) {
        if (lane == 0) {
          if (carry && carry_key != kv) {
            ends.visit(carry_key, carry);
            carry = 0;
          }
          carry_key = kv;
          carry += alive;
        }
      } else if (live) {
        ends.visit(kv, 1);
      }
    }
  }
  if (carry) ends.visit(carry_key, carry);
  __syncthreads();
  hist[static_cast<long long>(tid) * num_tiles + t] = cnt[tid];
}

// Counted schedule, step b: block d turns hist[d][0, num_tiles) into the
// count of digit d in the tiles before each, in place, and writes the
// digit's total into digit_counts[d].
template <typename Ends>
__global__ void __launch_bounds__(kThreads)
column_scan_kernel(Ends ends, int32_t* __restrict__ hist, int num_tiles,
                   int32_t* __restrict__ digit_counts) {
  if (ends.skip()) return;
  int32_t* row = hist + static_cast<long long>(blockIdx.x) * num_tiles;
  const int32_t total = block_exclusive_scan<kThreads>(row, row, num_tiles, 0);
  if (threadIdx.x == 0) digit_counts[blockIdx.x] = total;
}

// One stable pass over digit `pass`, on the chained schedule (which runs
// only the digits in which the keys differ) or the counted one.  The last
// running pass calls ends.last(dest, key, position); when no digit runs,
// pass 0 calls ends.identity(i) for every row.  tile_prefix is the counted
// schedule's scanned [256][num_tiles] matrix.
template <typename K, typename Ends, bool kChained>
__global__ void __launch_bounds__(kThreads)
digit_pass_kernel(Ends ends, Buffers<K> buf, long long n, int pass,
                  int num_digits, State st,
                  const int32_t* __restrict__ tile_prefix, int num_tiles) {
  __shared__ int32_t cnt[kWarps][kBuckets];
  __shared__ int32_t warp_sums[kWarps];
  __shared__ unsigned int tile_sh;
  if (ends.skip()) return;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const unsigned mask = running_digits(st, num_digits, kChained);
  if (!((mask >> pass) & 1u)) {
    if (mask == 0 && pass == 0) {  // no digit differs: the order stands
      const long long stride = static_cast<long long>(gridDim.x) * kThreads;
      for (long long i = static_cast<long long>(blockIdx.x) * kThreads + tid;
           i < n; i += stride)
        ends.identity(i);
    }
    return;
  }
  const int k = __popc(mask & ((1u << pass) - 1u));
  const bool last = (mask >> (pass + 1)) == 0;
  const int shift = pass * kDigitBits;
  const int d = tid;  // this thread's digit value in the block-wide steps
  const int32_t total = st.digit_counts[pass * kBuckets + d];
  int32_t before = 0;  // rows of digit d in earlier tiles
  if (kChained) {
    if (tid == 0) {
      tile_sh = atomicAdd(&st.tickets[pass], 1u);
      if (tile_sh == 0) atomicOr(st.ran, 1u << pass);
    }
  } else {
    if (tid == 0) tile_sh = blockIdx.x;
    before = tile_prefix[static_cast<long long>(d) * num_tiles + blockIdx.x];
  }
  for (int b = lane; b < kBuckets; b += 32) cnt[wid][b] = 0;
  __syncthreads();
  const long long t = tile_sh;
  const long long lo = t * kTile + static_cast<long long>(wid) * kWarpRows;

  // the warp's rows, kept in registers for the scatter
  K key[kItems];
  int32_t pos[kItems];
  unsigned peers[kItems];
  load_rows(ends, buf, k, lo, n, lane, key, pos);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool live = lo + j * 32 + lane < n;
    const unsigned dj = digit_of(key[j], shift);
    peers[j] = digit_peers(dj, live);
    if (live && lane == __ffs(peers[j]) - 1) cnt[wid][dj] += __popc(peers[j]);
    __syncwarp();
  }
  __syncthreads();

  if (kChained) {
    // publish the tile's count of digit d, then read the earlier tiles'
    // counts of d by look-back, kWindow tiles a load
    int32_t agg = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) agg += cnt[w][d];
    const unsigned long long own = 2ull * (pass + 1), incl = own + 1;
    unsigned long long* word = st.lookback + t * kBuckets + d;
    store_word(word, ((t == 0 ? incl : own) << 32) |
                         static_cast<unsigned int>(agg));
    for (long long j = t - 1; j >= 0;) {
      unsigned long long w[kWindow];
#pragma unroll
      for (int q = 0; q < kWindow; ++q)  // before tile 0: an empty prefix
        w[q] = j - q >= 0 ? load_word(st.lookback + (j - q) * kBuckets + d)
                          : incl << 32;
      int q = 0;
      bool found = false;
      for (; q < kWindow; ++q) {
        const unsigned long long flag = w[q] >> 32;
        if (flag < own) break;  // tile j - q has not published yet
        before += static_cast<int32_t>(w[q] & 0xffffffffu);
        if (flag == incl) {
          found = true;
          break;
        }
      }
      if (found) break;
      j -= q;
    }
    if (t > 0)
      store_word(word,
                 (incl << 32) | static_cast<unsigned int>(before + agg));
  }

  // the digit's start: an exclusive scan of its totals over d
  int32_t scan = total;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int32_t o = __shfl_up_sync(kFullMask, scan, s);
    if (lane >= s) scan += o;
  }
  if (lane == 31) warp_sums[wid] = scan;
  __syncthreads();
  int32_t run = scan - total + before;
  for (int w = 0; w < wid; ++w) run += warp_sums[w];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {  // column d into per-warp bases
    const int32_t c = cnt[w][d];
    cnt[w][d] = run;
    run += c;
  }
  __syncthreads();

  K* keys_out = (k & 1) ? buf.keys[0] : buf.keys[1];
  int32_t* pos_out = (k & 1) ? buf.pos[0] : buf.pos[1];
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool live = peers[j] != 0;
    const unsigned dj = digit_of(key[j], shift);
    const int32_t start = live ? cnt[wid][dj] : 0;
    __syncwarp();
    if (live && lane == __ffs(peers[j]) - 1)
      cnt[wid][dj] = start + __popc(peers[j]);
    __syncwarp();
    if (live) {
      const int32_t dest = start + __popc(peers[j] & lower);
      if (last) {
        ends.last(dest, key[j], pos[j]);
      } else {
        keys_out[dest] = key[j];
        pos_out[dest] = pos[j];
      }
    }
  }
}

}  // namespace radix
