// Hopper (sm_90a) kernels for the LM path's mixture-of-experts layer: the
// token -> (expert, slot) dispatch and the weighted combine back.
//
// Replace src/repro/kernels/moe_dispatch/kernel.py::dispatch_pallas and
// ::combine_pallas.  The TPU kernels build the one-hot [tokens, capacity]
// tile in VMEM from iota compares and feed it to the MXU: a dense matmul
// whose work is T * C * d multiply-adds per expert, almost all of them by
// zero.  Hopper gains nothing from that shape, so both kernels here address
// rows directly and do only the work the routing asks for.
//
// Dispatch, buf[e, c, :] = sum_t [eidx_t == e and slot_t == c] x[t, :]
// (assignments with e outside [0, E) or c outside [0, C) are dropped):
//   1. count: one thread per token adds one to its row's count (integer
//      atomics, so the counts are exact);
//   2. scan: one block turns the E * C counts into row starts;
//   3. place: one thread per token appends its index to its row's list (an
//      atomic cursor, so the order within a row is not fixed yet);
//   4. gather: one block per (e, c) row first sorts the row's token list
//      ascending (rows hold at most one token on the model path, where the
//      slot is the rank within the expert; duplicate slots are allowed by
//      the contract and sorted by one thread), then sums the listed x rows
//      in float32 in ascending t, and writes the row in x's dtype (zeros
//      for an empty row).  The sum's order is fixed, so the result is the
//      same on every run.
// Bound: bytes -- the routed x rows are read once and the whole [E, C, d]
// buffer is written once.
//
// Combine, y[t, :] = w_t * buf[eidx_t, slot_t, :], or 0 when the assignment
// is dropped: for one routing slot at most one expert matches, so the
// reference's sum over experts has one term.  w is cast to buf's dtype
// first (as kernel.py:92 does), the product is taken in float32 and written
// in buf's dtype.  Bound: bytes -- one buf row read and one y row written
// per token.
//
// The exported functions have a plain C interface (raw device pointers, the
// caller's stream), launch on that stream, never synchronise and allocate
// nothing: the dispatch wrapper hands over one int32 scratch buffer of
// repro_moe_dispatch_scratch_ints(T, E, C) entries.  They return
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// The assignment's row e * C + c, or -1 when it is dropped.
__device__ __forceinline__ long long row_of(const int32_t* eidx,
                                            const int32_t* slot, int t,
                                            int E, int C) {
  const int e = eidx[t], c = slot[t];
  if (e < 0 || e >= E || c < 0 || c >= C) return -1;
  return static_cast<long long>(e) * C + c;
}

__global__ void count_kernel(const int32_t* __restrict__ eidx,
                             const int32_t* __restrict__ slot, int T, int E,
                             int C, int32_t* __restrict__ counts) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const long long row = row_of(eidx, slot, t, E, C);
  if (row >= 0) atomicAdd(&counts[row], 1);
}

// Exclusive scan of counts[0, rows) into starts and cursor; one block.
__global__ void scan_kernel(const int32_t* __restrict__ counts, int rows,
                            int32_t* __restrict__ starts,
                            int32_t* __restrict__ cursor) {
  __shared__ int32_t warp_sums[kScanThreads / 32];
  __shared__ int32_t carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int base = 0; base < rows; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const int32_t v = i < rows ? counts[i] : 0;
    int32_t incl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int32_t n = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += n;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int32_t w = warp_sums[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int32_t n = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += n;
      }
      warp_sums[lane] = w;  // inclusive over warps
    }
    __syncthreads();
    const int32_t before = carry + (warp ? warp_sums[warp - 1] : 0) + incl - v;
    if (i < rows) {
      starts[i] = before;
      cursor[i] = before;
    }
    __syncthreads();
    if (threadIdx.x == kScanThreads - 1) carry = before + v;
    __syncthreads();
  }
}

__global__ void place_kernel(const int32_t* __restrict__ eidx,
                             const int32_t* __restrict__ slot, int T, int E,
                             int C, int32_t* __restrict__ cursor,
                             int32_t* __restrict__ list) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const long long row = row_of(eidx, slot, t, E, C);
  if (row >= 0) list[atomicAdd(&cursor[row], 1)] = t;
}

template <typename T>
__global__ void gather_kernel(const T* __restrict__ x, int d,
                              const int32_t* __restrict__ counts,
                              const int32_t* __restrict__ starts,
                              int32_t* __restrict__ list,
                              T* __restrict__ buf) {
  const long long row = blockIdx.x;
  const int n = counts[row];
  int32_t* mine = list + starts[row];
  if (n > 1) {
    if (threadIdx.x == 0) {  // insertion sort: rows hold few tokens
      for (int i = 1; i < n; ++i) {
        const int32_t key = mine[i];
        int j = i - 1;
        while (j >= 0 && mine[j] > key) {
          mine[j + 1] = mine[j];
          --j;
        }
        mine[j + 1] = key;
      }
    }
    __syncthreads();
  }
  T* out = buf + row * d;
  for (int col = threadIdx.x; col < d; col += blockDim.x) {
    float acc = 0.f;
    for (int i = 0; i < n; ++i)
      acc += to_f(x[static_cast<long long>(mine[i]) * d + col]);
    out[col] = from_f<T>(acc);
  }
}

template <typename T>
__global__ void combine_kernel(const T* __restrict__ buf, int E, int C, int d,
                               const int32_t* __restrict__ eidx,
                               const int32_t* __restrict__ slot,
                               const float* __restrict__ w,
                               T* __restrict__ y) {
  const int t = blockIdx.x;
  const long long row = row_of(eidx, slot, t, E, C);
  T* out = y + static_cast<long long>(t) * d;
  if (row < 0) {
    for (int col = threadIdx.x; col < d; col += blockDim.x)
      out[col] = from_f<T>(0.f);
    return;
  }
  const float wt = to_f(from_f<T>(w[t]));  // w in buf's dtype
  const T* src = buf + row * d;
  for (int col = threadIdx.x; col < d; col += blockDim.x)
    out[col] = from_f<T>(wt * to_f(src[col]));
}

template <typename T>
cudaError_t dispatch(const void* x, const int32_t* eidx, const int32_t* slot,
                     int T_, int d, int E, int C, void* buf, int32_t* scratch,
                     cudaStream_t st) {
  const long long rows = static_cast<long long>(E) * C;
  int32_t* counts = scratch;
  int32_t* starts = counts + rows;
  int32_t* cursor = starts + rows;
  int32_t* list = cursor + rows;
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int32_t) * rows, st);
  if (err != cudaSuccess) return err;
  const int tb = (T_ + kThreads - 1) / kThreads;
  if (T_ > 0) {
    count_kernel<<<tb, kThreads, 0, st>>>(eidx, slot, T_, E, C, counts);
  }
  scan_kernel<<<1, kScanThreads, 0, st>>>(counts, static_cast<int>(rows),
                                          starts, cursor);
  if (T_ > 0) {
    place_kernel<<<tb, kThreads, 0, st>>>(eidx, slot, T_, E, C, cursor, list);
  }
  gather_kernel<T><<<static_cast<unsigned>(rows), 128, 0, st>>>(
      static_cast<const T*>(x), d, counts, starts, list, static_cast<T*>(buf));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

long long repro_moe_dispatch_scratch_ints(long long T, long long E,
                                          long long C) {
  return 3 * E * C + (T > 0 ? T : 1);
}

// dtype: 0 = float32, 1 = bfloat16.  x [T, d]; eidx, slot [T] int32;
// buf [E, C, d] in x's dtype.
int repro_moe_dispatch(const void* x, const void* eidx, const void* slot,
                       int T, int d, int E, int C, int dtype, void* buf,
                       void* scratch, void* stream) {
  if (E < 1 || C < 1 || d < 1 || T < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* e = static_cast<const int32_t*>(eidx);
  const int32_t* s = static_cast<const int32_t*>(slot);
  int32_t* sc = static_cast<int32_t*>(scratch);
  cudaError_t err;
  if (dtype == 0) err = dispatch<float>(x, e, s, T, d, E, C, buf, sc, st);
  else if (dtype == 1) err = dispatch<__nv_bfloat16>(x, e, s, T, d, E, C, buf, sc, st);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// buf [E, C, d]; eidx, slot [T] int32; w [T] float32; y [T, d] in buf's
// dtype.
int repro_moe_combine(const void* buf, int E, int C, int d, const void* eidx,
                      const void* slot, const void* w, int T, int dtype,
                      void* y, void* stream) {
  if (E < 1 || C < 1 || d < 1 || T < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* e = static_cast<const int32_t*>(eidx);
  const int32_t* s = static_cast<const int32_t*>(slot);
  const float* wf = static_cast<const float*>(w);
  if (dtype == 0) {
    combine_kernel<float><<<T, 128, 0, st>>>(
        static_cast<const float*>(buf), E, C, d, e, s, wf, static_cast<float*>(y));
  } else if (dtype == 1) {
    combine_kernel<__nv_bfloat16><<<T, 128, 0, st>>>(
        static_cast<const __nv_bfloat16*>(buf), E, C, d, e, s, wf,
        static_cast<__nv_bfloat16*>(y));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* repro_moe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
