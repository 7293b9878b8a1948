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
// (assignments with e outside [0, E) or c outside [0, C) are dropped), each
// row summed in float32 in ascending t and written in x's dtype; with a
// running buffer prev it writes round(prev + round(sum)) instead, the
// rounding of the layer body's `buf + b` over two routing slots.  The
// routing columns are read as they come: int32 or int64, any element
// stride (the [T, k] routing's column views), so no conversion runs first.
// One warp owns one (e, c) row and finds its tokens:
//   * up to kScanTokens tokens (every decode step): the warp scans the
//     routing with one ballot per 32 tokens.  One launch, no workspace.
//   * more (the prefill): dispatch_count_kernel first adds one to the
//     row's count and records the token, in the row's pair (count, token)
//     of an int32 workspace whose counts are zero before the call; the
//     row kernel reads and re-zeroes its row's count.  Two launches, no
//     memset, no allocation.  A count and a token never share a place at
//     any E * C, so a token left by an earlier, smaller call is never read
//     as a count.
// A row with no token is zeros (prev + 0), a row with one token is that x
// row (0 + x), both moved 16 bytes a lane (a scalar tail when d is not a
// whole number of 16-byte vectors, or a row is not 16-byte aligned); a row
// with several tokens (duplicate slots: allowed by the contract, never
// made by the model, whose slot is the rank within the expert) sums them
// in ascending t, found by scanning the routing again.  No atomics touch
// the data, so the result is the same on every run.
// Bound: bytes -- the routed x rows are read once and the whole [E, C, d]
// buffer is written once (and read once with prev).
//
// Combine over all k routing slots in one launch,
//   y[t, :] = c_0 (+) c_1 (+) ... (+) c_{k-1},  c_j = w_tj * buf[e_tj, s_tj, :]
// (+) the float32 add rounded to buf's dtype, folded in j order: the layer
// body's `y = c if y is None else y + c` over the k slots.  Each c_j is
// rounded to buf's dtype, with w cast to buf's dtype first (as kernel.py:92
// does) and the product taken in float32; a dropped assignment (e outside
// [0, E) or s outside [0, C)) is +0.0, as the plain version's where() makes
// it.  For one slot at most one expert matches, so the reference's sum
// over experts has one term; k = 1 is the single-slot combine_pallas.
// Adds and products are __fadd_rn / __fmul_rn, never contracted into an FMA,
// so float32 has the plain composition's bits too.  The routing (expert
// ids int32 or int64, slots int32 or int64, weights float32) is read as
// the layer has it: [T, k] tensors or their column views at any element
// strides, so nothing is converted or copied first.
// Bound: bytes -- the k routed buf rows read and one y row written per
// token.  Design: a block of kCombineThreads threads owns one token's
// window of kCombineThreads * V columns (V = 16 bytes of buf's dtype), so
// a decode step of 4 tokens at d 4096 still spreads over 16 blocks; each
// thread reads the token's k (e, s, w) triples (the block's threads read
// the same words, one L1 line), then issues the k slots' 16-byte loads
// kGroup at a time before folding them, and stores 16 bytes.  Where d is
// not a whole number of vectors, or buf or y is not 16-byte aligned, each
// thread takes V scalar columns of the window instead (same arithmetic).
//
// The combine's routing-weight gradient (training's backward; the TPU side
// has none: the reference differentiates its one-hot einsums),
//   dw[t, j] = sum_d dy[t, d] * buf[e_tj, s_tj, d],  +0.0 when dropped,
// one warp per (t, j): the routing read through Route as the forward reads
// it, the dot product in float32 over 16-byte loads (scalar where d or a
// row is not aligned), a warp reduction, one store.  Bound: bytes -- dy
// read once per slot and the k gathered buf rows, against 2 d flops each.
//
// The exported functions have a plain C interface (raw device pointers, the
// caller's stream), launch on that stream, never synchronise and allocate
// nothing: the dispatch wrapper keeps the workspace of
// repro_moe_dispatch_workspace_ints(T, E, C) entries per device, stream
// and host thread.  They return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

constexpr int kRowThreads = 256;            // 8 warps, one row each
constexpr int kScanTokens = 256;            // the scan's largest T

// The routing's (expert, slot) columns: int32 or int64 entries addressed
// as base[t * ts + j * js], element strides over the tokens and over the k
// routing slots (the dispatch reads one slot, j = 0).
struct Route {
  const void* eidx;
  const void* slot;
  long long e_ts, e_js, s_ts, s_js;
  int e_is64, s_is64;
  int E, C;
  // the assignment's buf row e * C + c, or -1 when it is dropped
  __device__ __forceinline__ long long row(long long t, int j = 0) const {
    const long long ei = t * e_ts + j * e_js, si = t * s_ts + j * s_js;
    const long long e = e_is64 ? static_cast<const long long*>(eidx)[ei]
                               : static_cast<const int32_t*>(eidx)[ei];
    const long long c = s_is64 ? static_cast<const long long*>(slot)[si]
                               : static_cast<const int32_t*>(slot)[si];
    if (e < 0 || e >= E || c < 0 || c >= C) return -1;
    return e * C + c;
  }
};

// ws[2 row] counts the row's tokens, ws[2 row + 1] holds one of them (read
// only when the count is 1)
__global__ void dispatch_count_kernel(Route r, int T, int32_t* __restrict__ ws) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const long long row = r.row(t);
  if (row >= 0) {
    atomicAdd(&ws[2 * row], 1);
    ws[2 * row + 1] = t;
  }
}

// sum rounded to T, then (add) prev + that in float32, rounded again: one
// element of the output row
template <typename T>
__device__ __forceinline__ T finish(float sum, bool add, float prev) {
  const T r = from_f<T>(sum);
  return add ? from_f<T>(prev + to_f(r)) : r;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int w) {
  return w == 0 ? v.x : w == 1 ? v.y : w == 2 ? v.z : v.w;
}

// element k of a 16-byte vector of T, as float (k a constant after
// unrolling, so the vector stays in registers)
template <typename T> __device__ __forceinline__ float elem(const uint4& v, int k);
template <> __device__ __forceinline__ float elem<float>(const uint4& v, int k) {
  return __uint_as_float(word(v, k));
}
template <> __device__ __forceinline__ float elem<__nv_bfloat16>(const uint4& v,
                                                                 int k) {
  const uint32_t w = word(v, k >> 1);
  return __uint_as_float((k & 1) ? (w & 0xffff0000u) : (w << 16));
}

template <typename T> __device__ __forceinline__ uint32_t bits(T x);
template <> __device__ __forceinline__ uint32_t bits<float>(float x) {
  return __float_as_uint(x);
}
template <> __device__ __forceinline__ uint32_t bits<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat16_as_ushort(x);
}

constexpr int kUnroll = 4;  // 16-byte vectors in flight per lane

// out[0, d) = finish(0 + src) (src null: finish(0)), 16 bytes a lane where
// every row is 16-byte aligned
template <typename T>
__device__ void copy_row(const T* __restrict__ src, const T* prev, T* out,
                         int d, int lane) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kPer = V / 4;  // elements per 32-bit word
  const uintptr_t align = reinterpret_cast<uintptr_t>(out) |
                          reinterpret_cast<uintptr_t>(src) |
                          reinterpret_cast<uintptr_t>(prev);
  int done = 0;
  if ((align & 15) == 0) {
    const int nvec = d / V;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    const uint4* p4 = reinterpret_cast<const uint4*>(prev);
    uint4* o4 = reinterpret_cast<uint4*>(out);
    for (int v0 = 0; v0 < nvec; v0 += 32 * kUnroll) {
      uint4 a[kUnroll], b[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int vi = v0 + u * 32 + lane;
        a[u] = make_uint4(0, 0, 0, 0);
        b[u] = make_uint4(0, 0, 0, 0);
        if (vi < nvec) {
          if (src) a[u] = s4[vi];
          if (prev) b[u] = p4[vi];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int vi = v0 + u * 32 + lane;
        if (vi >= nvec) continue;
        uint32_t ow[4];
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          ow[w] = 0;
#pragma unroll
          for (int h = 0; h < kPer; ++h) {
            const int k = w * kPer + h;
            const T r = finish<T>(0.f + elem<T>(a[u], k), prev != nullptr,
                                  elem<T>(b[u], k));
            ow[w] |= bits<T>(r) << (32 / kPer * h);
          }
        }
        o4[vi] = make_uint4(ow[0], ow[1], ow[2], ow[3]);
      }
    }
    done = nvec * V;
  }
  for (int col = done + lane; col < d; col += 32)
    out[col] = finish<T>(0.f + (src ? to_f(src[col]) : 0.f), prev != nullptr,
                         prev ? to_f(prev[col]) : 0.f);
}

// Warp `row`'s output: the tokens of the row (n of them, the first at
// first when n == 1) summed in ascending t.
template <typename T>
__device__ void write_row(const T* __restrict__ x, int d, const Route& r,
                          int T_, long long row, int n, int first,
                          const T* prev_buf, T* buf, int lane) {
  T* out = buf + row * d;
  const T* prev = prev_buf ? prev_buf + row * d : nullptr;
  if (n <= 1) {
    copy_row<T>(n ? x + static_cast<long long>(first) * d : nullptr, prev,
                out, d, lane);
    return;
  }
  // several tokens: their sum in ascending t, kDupCols columns a lane at a
  // time, the tokens found by one ballot per 32 of them
  constexpr int kDupCols = 8;
  for (int col0 = 0; col0 < d; col0 += 32 * kDupCols) {
    float acc[kDupCols];
#pragma unroll
    for (int c = 0; c < kDupCols; ++c) acc[c] = 0.f;
    int seen = 0;
    for (int t0 = 0; t0 < T_ && seen < n; t0 += 32) {
      const int t = t0 + lane;
      unsigned m = __ballot_sync(0xffffffffu, t < T_ && r.row(t) == row);
      seen += __popc(m);
      while (m) {
        const T* xr = x + static_cast<long long>(t0 + __ffs(m) - 1) * d;
        m &= m - 1;
#pragma unroll
        for (int c = 0; c < kDupCols; ++c) {
          const int col = col0 + 32 * c + lane;
          if (col < d) acc[c] += to_f(xr[col]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kDupCols; ++c) {
      const int col = col0 + 32 * c + lane;
      if (col < d)
        out[col] = finish<T>(acc[c], prev != nullptr,
                             prev ? to_f(prev[col]) : 0.f);
    }
  }
}

// One warp per (e, c) row.  kScan: the warp finds the row's tokens in the
// routing; else it reads (and re-zeroes) the count and token
// dispatch_count_kernel left in the workspace.
template <typename T, bool kScan>
__global__ void __launch_bounds__(kRowThreads, 4)
dispatch_rows_kernel(const T* __restrict__ x, int d, Route r, int T_,
                     long long rows, int32_t* __restrict__ ws, const T* prev,
                     T* buf) {
  const int lane = threadIdx.x & 31;
  const long long warps =
      static_cast<long long>(gridDim.x) * (kRowThreads / 32);
  for (long long row = (static_cast<long long>(blockIdx.x) * kRowThreads +
                        threadIdx.x) >> 5;
       row < rows; row += warps) {
    int n = 0, first = 0;
    if (kScan) {
      for (int t0 = 0; t0 < T_; t0 += 32) {
        const int t = t0 + lane;
        const unsigned m =
            __ballot_sync(0xffffffffu, t < T_ && r.row(t) == row);
        if (m && n == 0) first = t0 + __ffs(m) - 1;
        n += __popc(m);
      }
    } else {
      if (lane == 0) {
        n = ws[2 * row];
        first = ws[2 * row + 1];
        ws[2 * row] = 0;  // the counts are zero again for the next call
      }
      n = __shfl_sync(0xffffffffu, n, 0);
      first = __shfl_sync(0xffffffffu, first, 0);
    }
    write_row<T>(x, d, r, T_, row, n, first, prev, buf, lane);
  }
}

constexpr int kCombineThreads = 128;
constexpr int kGroup = 4;  // slots whose loads are in flight together

template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// k slots of routing r, weights w[t * w_ts + j * w_js].  kVec: 16-byte
// loads and stores; else V scalar columns a thread, strided by the block's
// width.  grid.x = T * chunks, chunk = the token's window.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kCombineThreads)
combine_slots_kernel(const T* __restrict__ buf, int d, Route r, int k,
                     const float* __restrict__ w, long long w_ts,
                     long long w_js, int chunks, T* __restrict__ y) {
  constexpr int V = 16 / sizeof(T);
  const long long t = blockIdx.x / chunks;
  const int chunk = static_cast<int>(blockIdx.x - t * chunks);
  const int col0 = chunk * kCombineThreads * V;
  // kVec: this thread's vector starts at col; else its columns are
  // col0 + threadIdx.x + u * kCombineThreads
  const int col = col0 + threadIdx.x * V;
  if (kVec && col >= d) return;
  float acc[V];
  for (int j0 = 0; j0 < k; j0 += kGroup) {
    long long row[kGroup];
    float wt[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      row[g] = -1;
      wt[g] = 0.f;
      if (j0 + g < k) {
        row[g] = r.row(t, j0 + g);
        wt[g] = round_to<T>(w[t * w_ts + (j0 + g) * w_js]);  // buf's dtype
      }
    }
    float x[kGroup][V];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const T* src = buf + (row[g] < 0 ? 0 : row[g]) * d;
      if (kVec) {
        uint4 v = make_uint4(0, 0, 0, 0);
        if (row[g] >= 0) v = *reinterpret_cast<const uint4*>(src + col);
#pragma unroll
        for (int u = 0; u < V; ++u) x[g][u] = elem<T>(v, u);
      } else {
#pragma unroll
        for (int u = 0; u < V; ++u) {
          const int cu = col0 + threadIdx.x + u * kCombineThreads;
          x[g][u] = (row[g] >= 0 && cu < d) ? to_f(src[cu]) : 0.f;
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      if (j0 + g >= k) break;
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const float c =
            row[g] >= 0 ? round_to<T>(__fmul_rn(wt[g], x[g][u])) : 0.f;
        acc[u] = j0 + g == 0 ? c : round_to<T>(__fadd_rn(acc[u], c));
      }
    }
  }
  T* out = y + t * d;
  if (kVec) {
    uint32_t ow[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      ow[w] = 0;
#pragma unroll
      for (int h = 0; h < V / 4; ++h)
        ow[w] |= bits<T>(from_f<T>(acc[w * (V / 4) + h]))
                 << (32 / (V / 4) * h);
    }
    *reinterpret_cast<uint4*>(out + col) = make_uint4(ow[0], ow[1], ow[2],
                                                      ow[3]);
  } else {
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const int cu = col0 + threadIdx.x + u * kCombineThreads;
      if (cu < d) out[cu] = from_f<T>(acc[u]);
    }
  }
}

template <typename T>
cudaError_t combine_slots(const void* buf, int d, const Route& r, int k,
                          const float* w, long long w_ts, long long w_js,
                          long long T_, void* y, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const int chunks = (d + kCombineThreads * V - 1) / (kCombineThreads * V);
  const long long blocks = T_ * chunks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool vec = d % V == 0 && ((reinterpret_cast<uintptr_t>(buf) |
                                   reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  const T* b = static_cast<const T*>(buf);
  T* o = static_cast<T*>(y);
  if (vec)
    combine_slots_kernel<T, true><<<static_cast<int>(blocks), kCombineThreads,
                                    0, st>>>(b, d, r, k, w, w_ts, w_js,
                                             chunks, o);
  else
    combine_slots_kernel<T, false><<<static_cast<int>(blocks),
                                     kCombineThreads, 0, st>>>(
        b, d, r, k, w, w_ts, w_js, chunks, o);
  return cudaGetLastError();
}

// One warp per (t, j) of the T x k routing: dw[t k + j], float32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_weight_grad_kernel(const T* __restrict__ dy, const T* __restrict__ buf,
                           int d, Route r, int k, long long pairs,
                           float* __restrict__ dw) {
  constexpr int V = 16 / sizeof(T);
  const long long pair =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (pair >= pairs) return;
  const long long t = pair / k;
  const int j = static_cast<int>(pair - t * k);
  const long long row = r.row(t, j);
  float acc = 0.f;
  if (row >= 0) {
    const T* a = dy + t * d;
    const T* b = buf + row * d;
    int done = 0;
    if (d % V == 0 && ((reinterpret_cast<uintptr_t>(a) |
                        reinterpret_cast<uintptr_t>(b)) & 15) == 0) {
      const uint4* a4 = reinterpret_cast<const uint4*>(a);
      const uint4* b4 = reinterpret_cast<const uint4*>(b);
      for (int vi = lane; vi < d / V; vi += 32) {
        const uint4 x = a4[vi], y = b4[vi];
#pragma unroll
        for (int u = 0; u < V; ++u)
          acc = fmaf(elem<T>(x, u), elem<T>(y, u), acc);
      }
      done = d;
    }
    for (int c = done + lane; c < d; c += 32)
      acc = fmaf(to_f(a[c]), to_f(b[c]), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dw[pair] = acc;
}

template <typename T>
cudaError_t combine_weight_grad(const void* dy, const void* buf, int d,
                                const Route& r, int k, long long T_, float* dw,
                                cudaStream_t st) {
  const long long pairs = T_ * k;
  const long long blocks = (pairs + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  combine_weight_grad_kernel<T><<<static_cast<int>(blocks), kThreads, 0,
                                  st>>>(static_cast<const T*>(dy),
                                        static_cast<const T*>(buf), d, r, k,
                                        pairs, dw);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, int d, const Route& r, int T_,
                     const void* prev, void* buf, int32_t* workspace,
                     cudaStream_t st) {
  // a warp for every row, and registers for four blocks an SM: the rows'
  // loads and stores all in flight at once
  const long long rows = static_cast<long long>(r.E) * r.C;
  const long long blocks = (rows + kRowThreads / 32 - 1) / (kRowThreads / 32);
  const T* xs = static_cast<const T*>(x);
  const T* ps = static_cast<const T*>(prev);
  T* bs = static_cast<T*>(buf);
  if (T_ <= kScanTokens) {
    dispatch_rows_kernel<T, true><<<static_cast<int>(blocks), kRowThreads, 0,
                                    st>>>(xs, d, r, T_, rows, nullptr, ps,
                                          bs);
  } else {
    dispatch_count_kernel<<<(T_ + kThreads - 1) / kThreads, kThreads, 0,
                            st>>>(r, T_, workspace);
    dispatch_rows_kernel<T, false><<<static_cast<int>(blocks), kRowThreads,
                                     0, st>>>(xs, d, r, T_, rows, workspace,
                                              ps, bs);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// int32 entries of the workspace a dispatch of T tokens into E * C rows
// needs, a (count, token) pair a row: none when the row kernel scans the
// routing itself.
long long repro_moe_dispatch_workspace_ints(long long T, long long E,
                                            long long C) {
  return T <= kScanTokens ? 0 : 2 * E * C;
}

// dtype: 0 = float32, 1 = bfloat16.  x [T, d] contiguous; eidx, slot: T
// int32 (is64 = 0) or int64 (is64 = 1) entries at element strides; buf
// [E, C, d] in x's dtype; prev: null, or [E, C, d] added in (may be buf);
// workspace: repro_moe_dispatch_workspace_ints(T, E, C) int32 entries
// whose counts (the even entries) are zero, and are left zero; calls that
// share one must be ordered (one stream, one issuing thread).
int repro_moe_dispatch(const void* x, int T, int d, const void* eidx,
                       long long e_stride, int e_is64, const void* slot,
                       long long s_stride, int s_is64, int E, int C,
                       int dtype, const void* prev, void* buf,
                       void* workspace, void* stream) {
  if (E < 1 || C < 1 || d < 1 || T < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T > kScanTokens && workspace == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Route r{eidx, slot, e_stride, 0, s_stride, 0, e_is64, s_is64, E, C};
  int32_t* ws = static_cast<int32_t*>(workspace);
  cudaError_t err;
  if (dtype == 0) err = dispatch<float>(x, d, r, T, prev, buf, ws, st);
  else if (dtype == 1) err = dispatch<__nv_bfloat16>(x, d, r, T, prev, buf, ws, st);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// buf [E, C, d] contiguous; eidx, slot: [T, k] entries of int32 (is64 =
// 0) or int64 (is64 = 1) at element strides (*_ts over tokens, *_js over
// slots); w: [T, k] float32 at strides (w_ts, w_js); y [T, d] contiguous
// in buf's dtype.  k >= 1; E or C may be 0 (every assignment dropped).
int repro_moe_combine(const void* buf, int E, int C, int d, int k,
                      const void* eidx, long long e_ts, long long e_js,
                      int e_is64, const void* slot, long long s_ts,
                      long long s_js, int s_is64, const void* w,
                      long long w_ts, long long w_js, long long T, int dtype,
                      void* y, void* stream) {
  if (E < 0 || C < 0 || d < 1 || k < 1 || T < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Route r{eidx, slot, e_ts, e_js, s_ts, s_js, e_is64, s_is64, E, C};
  const float* wf = static_cast<const float*>(w);
  cudaError_t err;
  if (dtype == 0)
    err = combine_slots<float>(buf, d, r, k, wf, w_ts, w_js, T, y, st);
  else if (dtype == 1)
    err = combine_slots<__nv_bfloat16>(buf, d, r, k, wf, w_ts, w_js, T, y, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// dy [T, d] and buf [E, C, d] contiguous, one dtype (0 = float32, 1 =
// bfloat16); eidx, slot: [T, k] as repro_moe_combine reads them; dw [T, k]
// float32 contiguous.
int repro_moe_combine_weight_grad(const void* dy, const void* buf, int E,
                                  int C, int d, int k, const void* eidx,
                                  long long e_ts, long long e_js, int e_is64,
                                  const void* slot, long long s_ts,
                                  long long s_js, int s_is64, long long T,
                                  int dtype, float* dw, void* stream) {
  if (E < 0 || C < 0 || d < 1 || k < 1 || T < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Route r{eidx, slot, e_ts, e_js, s_ts, s_js, e_is64, s_is64, E, C};
  cudaError_t err;
  if (dtype == 0)
    err = combine_weight_grad<float>(dy, buf, d, r, k, T, dw, st);
  else if (dtype == 1)
    err = combine_weight_grad<__nv_bfloat16>(dy, buf, d, r, k, T, dw, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* repro_moe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
