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
// by one key column, with the digit passes of radix_pass.cuh:
//   1. digit_count_kernel gathers the column once through the current
//      permutation (one random read) into a contiguous buffer of
//      order-preserving unsigned bits: signed integers flip the sign bit;
//      floats first turn -0.0 into +0.0 and every NaN into one quiet NaN
//      (so that the order is torch.sort's and jnp.argsort's: -0.0 == +0.0,
//      NaN last), then flip every bit when the sign is set, else only the
//      sign bit; unsigned integers and bool are taken as they are.  The
//      same read counts every 8-bit digit and reduces the OR of the bits
//      and of their complements: the bits in which the keys differ.
//   2. one digit_pass_kernel per digit of the key's width, on the chained
//      schedule of radix_pass.cuh.  A digit that
//      is the same in every key changes no order, so its pass returns at
//      once: Q-d's int64 o_custkey (1..150,000) runs 3 of its 8 passes,
//      o_orderdate (int32 days) 2 of 4.  The decision is taken on the
//      device, so the host never waits for it.  The last running pass
//      writes the int64 output permutation (perm_out[dest] =
//      perm_in[position]); a column whose keys are all equal gets
//      perm_out = perm_in (or the identity) from pass 0.
//
// Bound: bytes -- the key column is read once (through perm_in) and the
// int64 permutation written once; every running digit adds a read and a
// scattered write of the (key bits, position) pairs.
//
// The exported function has a plain C interface (raw device pointers, an
// int64 row count, the caller's stream), launches on that stream, never
// synchronises and allocates nothing: the wrapper in
// repro_torch/kernels/multikey_sort/kernel.py allocates the output and one
// scratch buffer of repro_radix_sort_scratch_bytes(n, elem_bytes) bytes.  It
// returns cudaGetLastError(), so a refused launch is reported at the call.

#include "radix_pass.cuh"

namespace {

using radix::Buffers;
using radix::State;
using radix::align_up;
using radix::kThreads;

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

// Step 1's source: the column through perm_in, mapped to order bits and
// stored into the first key buffer.
template <typename K>
struct GatherBits {
  const void* col;
  int elem_bytes, kind;
  uint64_t inf_bits;
  const int64_t* perm_in;
  K* keys;
  __device__ K key(long long i) const {
    const long long r = perm_in ? perm_in[i] : i;
    const K k = static_cast<K>(
        order_bits(load_raw(col, r, elem_bytes), elem_bytes, kind, inf_bits));
    keys[i] = k;
    return k;
  }
};

// Step 2's ends: the first pass reads the gathered bits, the last writes
// the permutation.
template <typename K>
struct PermEnds {
  const K* keys;
  const int64_t* perm_in;
  int64_t* perm_out;
  __device__ K first_key(long long i) const { return keys[i]; }
  __device__ void last(int32_t dest, K, int32_t p) const {
    perm_out[dest] = perm_in ? perm_in[p] : static_cast<int64_t>(p);
  }
  __device__ void identity(long long i) const {
    perm_out[i] = perm_in ? perm_in[i] : static_cast<int64_t>(i);
  }
  __device__ bool skip() const { return false; }
};

inline size_t key_bytes(int elem_bytes) { return elem_bytes > 4 ? 8 : 4; }

template <typename K>
int sort_pass(const void* col, int elem_bytes, int kind, uint64_t inf_bits,
              const int64_t* perm_in, long long n, int64_t* perm_out,
              unsigned char* scratch, cudaStream_t s) {
  const size_t state = radix::state_bytes(n);
  cudaMemsetAsync(scratch, 0, state, s);
  const State st = radix::carve_state(scratch);
  unsigned char* p = scratch + state;
  Buffers<K> buf;
  for (int k = 0; k < 2; ++k) {
    buf.keys[k] = reinterpret_cast<K*>(p);
    p += align_up(n * sizeof(K));
  }
  for (int k = 0; k < 2; ++k) {
    buf.pos[k] = reinterpret_cast<int32_t*>(p);
    p += align_up(n * sizeof(int32_t));
  }
  const int digits = elem_bytes;  // 8-bit digits
  radix::digit_count_kernel<K><<<radix::count_grid(n), kThreads, 0, s>>>(
      GatherBits<K>{col, elem_bytes, kind, inf_bits, perm_in, buf.keys[0]}, n,
      digits, st);
  const PermEnds<K> ends{buf.keys[0], perm_in, perm_out};
  const int tiles = static_cast<int>(radix::tiles_for(n));
  for (int pass = 0; pass < digits; ++pass) {
    radix::digit_pass_kernel<K, PermEnds<K>, true>
        <<<tiles, kThreads, 0, s>>>(ends, buf, n, pass, digits, st, nullptr,
                                    tiles);
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
  return static_cast<long long>(radix::state_bytes(n) +
                                2 * align_up(n * key_bytes(elem_bytes)) +
                                2 * align_up(n * sizeof(int32_t)));
}

// Byte offset in the scratch of the uint32 word whose bit p says that digit
// pass p ran (read back by tests and the smoke run after a call).
long long repro_radix_sort_ran_offset(void) {
  return static_cast<long long>(radix::ran_offset());
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
