// Hopper (sm_90a) kernels for the backward of the LM path's float32
// attention: given q, k, v, the forward's output O and row logsumexp L
// (csrc/flash_attention.cu writes it when asked), and dO, they compute dq,
// dk and dv of the forward's contract (causal, window, tanh soft-cap,
// scale, q_offset, Sq != Sk, GQA, D != Dv up to 256, strided views with a
// contiguous last dimension).
//
// The TPU side has no backward kernel: the reference trains through
// jax.grad of plain jnp (src/repro/models/attention.py::chunked_attention),
// which XLA differentiates.  On the card the port's forward is the hand
// kernel of csrc/flash_attention.cu (which replaces
// src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas), so
// its gradient is a kernel too.  This is the FA2 backward: P is recomputed
// from the saved L, never stored.
//   1. delta_kernel: delta_i = sum_d dO_id O_id, one warp a row.
//   2. dkdv_kernel: one block per (key tile of kBK keys, kv head, batch).
//      K and V of the tile stay in shared memory; the block walks the G
//      query heads of its group and, for each, the query tiles of kBQ rows
//      that can see the tile (causal: from the tile's first key on; window:
//      up to its last key + window), recomputes S = q k^T, P = exp(S' - L)
//      (S' the scaled, capped score), dP = dO v^T and dS = P (dP - delta)
//      (1 - tanh^2) scale, and adds P^T dO into dv and dS^T q into dk in
//      registers.  The GQA group's G heads are summed in the block, so no
//      atomics: the result is the same on every run.
//   3. dq_kernel: one block per (query tile, head, batch) walks the key
//      tiles its rows can see and adds dS k into dq in registers.
// A row with no visible key (window past every key) keeps the forward's
// convention, the mean of V over all Sk keys: the forward writes L = +inf
// for it, so P = 0 in both passes (dq = 0, no dk), and dkdv_kernel adds
// the rows' dO / Sk into every key's dv, which is the gradient of a mean.
// Such rows are the suffix i >= nokey_from, which the wrapper computes.
//
// Arithmetic: float32 FMAs on the CUDA cores (SIMT), tiles in shared
// memory, each thread a 4 x kBK/16 block of S and dP and a kBK/16 x kNB
// block of dk and dv (a 4 x kNB block of dq), rows and columns strided by
// 16 so that the reads of a warp fall on distinct banks or broadcast.
// Bound: operations -- five products of the visible (query, key) pairs
// (S, dP, dv, dk, dq; the forward has two), 2.5 times the forward's flops,
// at the tensor cores' 3xTF32 rate; this kernel recomputes S and dP in the
// dq pass (seven products) on the CUDA cores, so it runs well above that
// bound.  Shared memory: (2 kBK + 2 kBQ)(16 kNB + 1) + 2 kBQ (kBK + 1)
// floats, 165 KB at D = Dv = 128 (kBK 64), 210 KB at 256 (kBK 32).
//
// The exported function has a plain C interface (raw device pointers,
// element strides, the caller's stream), launches the three kernels on that
// stream, never synchronises and allocates nothing: the wrapper allocates
// delta [B, H, Sq] and the contiguous outputs.  It returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows a tile

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* g;      // dO
  const float* lse;    // [B, H, Sq]; +inf: no visible key
  float* delta;        // [B, H, Sq]
  float* dq;           // [B, Sq, H, D] contiguous
  float* dk;           // [B, Sk, KH, D] contiguous
  float* dv;           // [B, Sk, KH, Dv] contiguous
  int B, Sq, Sk, H, KH, D, Dv;
  long long qb, qs, qh;   // element strides (last dim contiguous)
  long long kb, ks, kh;
  long long vb, vs, vh;
  long long ob, os, oh;
  long long gb, gs, gh;
  int causal;
  int window;             // 0: none
  float cap;              // 0: none
  float scale;
  long long q_offset;
  long long nokey_from;   // rows >= this see no key (Sq: none do)
};

__global__ void __launch_bounds__(kThreads) delta_kernel(Params p) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<long long>(p.B) * p.H * p.Sq) return;
  const long long i = row % p.Sq;
  const long long bh = row / p.Sq;
  const long long h = bh % p.H, b = bh / p.H;
  const float* o = p.o + b * p.ob + i * p.os + h * p.oh;
  const float* g = p.g + b * p.gb + i * p.gs + h * p.gh;
  float s = 0.f;
  for (int c = lane; c < p.Dv; c += 32) s = fmaf(o[c], g[c], s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) p.delta[row] = s;
}

// rows [row0, row0 + nrows) of a matrix with row stride rs into shared
// memory of row stride ld, columns [0, width) and zeros up to wpad, and
// zero rows at or past row_end
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* base,
                                          long long rs, long long row0,
                                          long long row_end, int nrows,
                                          int width, int wpad) {
  for (int idx = threadIdx.x; idx < nrows * wpad; idx += kThreads) {
    const int r = idx / wpad, c = idx - r * wpad;
    const long long gr = row0 + r;
    dst[r * ld + c] = (gr < row_end && c < width) ? base[gr * rs + c] : 0.f;
  }
}

__device__ __forceinline__ bool visible(const Params& p, long long qpos,
                                        long long key) {
  if (key >= p.Sk) return false;
  if (p.causal && qpos < key) return false;
  if (p.window > 0 && qpos - key >= p.window) return false;
  return true;
}

// S and dP for rows tr + 16 a (a < 4) and keys tc + 16 c (c < kNKB) of the
// tiles in shared memory, then P and dS into Ps and Ss (row stride kBK +
// 1; Ps may be null).  rowv holds L then delta of the kBQ rows; row r is
// query i0 + r, valid below i_end; the tile's first key is k0.
template <int kBK, int kLD>
__device__ __forceinline__ void scores(const Params& p, const float* Qs,
                                       const float* Gs, const float* Ks,
                                       const float* Vs, const float* rowv,
                                       long long i0, long long i_end,
                                       long long k0, float* Ps, float* Ss) {
  constexpr int kNKB = kBK / 16;
  constexpr int kLDP = kBK + 1;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  float s[4][kNKB], dp[4][kNKB];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kNKB; ++c) s[a][c] = dp[a][c] = 0.f;
  for (int d = 0; d < p.D; ++d) {
    float qa[4], kc[kNKB];
#pragma unroll
    for (int a = 0; a < 4; ++a) qa[a] = Qs[(tr + 16 * a) * kLD + d];
#pragma unroll
    for (int c = 0; c < kNKB; ++c) kc[c] = Ks[(tc + 16 * c) * kLD + d];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < kNKB; ++c) s[a][c] = fmaf(qa[a], kc[c], s[a][c]);
  }
  for (int d = 0; d < p.Dv; ++d) {
    float ga[4], vc[kNKB];
#pragma unroll
    for (int a = 0; a < 4; ++a) ga[a] = Gs[(tr + 16 * a) * kLD + d];
#pragma unroll
    for (int c = 0; c < kNKB; ++c) vc[c] = Vs[(tc + 16 * c) * kLD + d];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < kNKB; ++c) dp[a][c] = fmaf(ga[a], vc[c], dp[a][c]);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = tr + 16 * a;
    const long long i = i0 + r;
    const long long qpos = p.q_offset + i;
    const float L = rowv[r], dl = rowv[kBQ + r];
#pragma unroll
    for (int c = 0; c < kNKB; ++c) {
      const int kc = tc + 16 * c;
      float x = s[a][c] * p.scale, dy = 1.f;
      if (p.cap > 0.f) {
        const float t = tanhf(x / p.cap);
        x = t * p.cap;
        dy = 1.f - t * t;
      }
      const bool ok = i < i_end && visible(p, qpos, k0 + kc);
      const float P = ok ? expf(x - L) : 0.f;  // L = +inf: P = 0
      if (Ps) Ps[r * kLDP + kc] = P;
      Ss[r * kLDP + kc] = P * (dp[a][c] - dl) * dy * p.scale;
    }
  }
}

// L and delta of rows [i0, i0 + kBQ) of head h into rowv: +inf and 0 past
// i_end
__device__ __forceinline__ void load_row_values(const Params& p, float* rowv,
                                                long long b, long long h,
                                                long long i0,
                                                long long i_end) {
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    const long long i = i0 + r;
    const long long at = (b * p.H + h) * p.Sq + i;
    rowv[r] = i < i_end ? p.lse[at] : INFINITY;
    rowv[kBQ + r] = i < i_end ? p.delta[at] : 0.f;
  }
}

template <int kBK, int kNB>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(Params p) {
  constexpr int kLD = 16 * kNB + 1;
  constexpr int kLDP = kBK + 1;
  constexpr int kNKB = kBK / 16;
  constexpr int kW = 16 * kNB;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kBK * kLD;
  float* Qs = Vs + kBK * kLD;
  float* Gs = Qs + kBQ * kLD;
  float* Ps = Gs + kBQ * kLD;
  float* Ss = Ps + kBQ * kLDP;
  float* rowv = Ss + kBQ * kLDP;

  const long long k0 = static_cast<long long>(blockIdx.x) * kBK;
  const int kvh = blockIdx.y;
  const long long b = blockIdx.z;
  const int G = p.H / p.KH;
  const long long k_end = k0 + kBK < p.Sk ? k0 + kBK : p.Sk;
  load_rows(Ks, kLD, p.k + b * p.kb + kvh * p.kh, p.ks, k0, p.Sk, kBK, p.D,
            kW);
  load_rows(Vs, kLD, p.v + b * p.vb + kvh * p.vh, p.vs, k0, p.Sk, kBK, p.Dv,
            kW);

  const int tk = threadIdx.x / 16, te = threadIdx.x % 16;
  float dk[kNKB][kNB], dv[kNKB][kNB];
#pragma unroll
  for (int a = 0; a < kNKB; ++a)
#pragma unroll
    for (int c = 0; c < kNB; ++c) dk[a][c] = dv[a][c] = 0.f;

  // the query rows that can see a key of [k0, k_end), short of the rows
  // that see none
  long long i_begin = 0, i_end = p.nokey_from;
  if (p.causal && k0 - p.q_offset > i_begin) i_begin = k0 - p.q_offset;
  if (p.window > 0 && k_end - 1 + p.window - p.q_offset < i_end)
    i_end = k_end - 1 + p.window - p.q_offset;
  if (i_end > p.Sq) i_end = p.Sq;

  for (int gi = 0; gi < G; ++gi) {
    const long long h = static_cast<long long>(kvh) * G + gi;
    for (long long i0 = i_begin; i0 < i_end; i0 += kBQ) {
      __syncthreads();  // the last tile's Qs, Gs, Ps, Ss are read
      load_rows(Qs, kLD, p.q + b * p.qb + h * p.qh, p.qs, i0, i_end, kBQ,
                p.D, kW);
      load_rows(Gs, kLD, p.g + b * p.gb + h * p.gh, p.gs, i0, i_end, kBQ,
                p.Dv, kW);
      load_row_values(p, rowv, b, h, i0, i_end);
      __syncthreads();
      scores<kBK, kLD>(p, Qs, Gs, Ks, Vs, rowv, i0, i_end, k0, Ps, Ss);
      __syncthreads();
      for (int r = 0; r < kBQ; ++r) {
        float pk[kNKB], sk[kNKB];
#pragma unroll
        for (int a = 0; a < kNKB; ++a) {
          pk[a] = Ps[r * kLDP + tk + 16 * a];
          sk[a] = Ss[r * kLDP + tk + 16 * a];
        }
#pragma unroll
        for (int c = 0; c < kNB; ++c) {
          const float go = Gs[r * kLD + te + 16 * c];
          const float qv = Qs[r * kLD + te + 16 * c];
#pragma unroll
          for (int a = 0; a < kNKB; ++a) {
            dv[a][c] = fmaf(pk[a], go, dv[a][c]);
            dk[a][c] = fmaf(sk[a], qv, dk[a][c]);
          }
        }
      }
    }
  }

  // rows that see no key: out = mean of V over all keys, so each key's dv
  // takes their dO / Sk
  if (p.nokey_from < p.Sq) {
    __syncthreads();
    float* u = Qs;  // [kW]
    for (int e = threadIdx.x; e < kW; e += kThreads) {
      float s = 0.f;
      if (e < p.Dv)
        for (int gi = 0; gi < G; ++gi) {
          const float* g = p.g + b * p.gb + (static_cast<long long>(kvh) * G + gi) * p.gh + e;
          for (long long i = p.nokey_from; i < p.Sq; ++i) s += g[i * p.gs];
        }
      u[e] = s / static_cast<float>(p.Sk);
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < kNKB; ++a)
#pragma unroll
      for (int c = 0; c < kNB; ++c) dv[a][c] += u[te + 16 * c];
  }

#pragma unroll
  for (int a = 0; a < kNKB; ++a) {
    const long long key = k0 + tk + 16 * a;
    if (key >= p.Sk) continue;
    float* dkr = p.dk + ((b * p.Sk + key) * p.KH + kvh) * p.D;
    float* dvr = p.dv + ((b * p.Sk + key) * p.KH + kvh) * p.Dv;
#pragma unroll
    for (int c = 0; c < kNB; ++c) {
      const int e = te + 16 * c;
      if (e < p.D) dkr[e] = dk[a][c];
      if (e < p.Dv) dvr[e] = dv[a][c];
    }
  }
}

template <int kBK, int kNB>
__global__ void __launch_bounds__(kThreads) dq_kernel(Params p) {
  constexpr int kLD = 16 * kNB + 1;
  constexpr int kLDP = kBK + 1;
  constexpr int kW = 16 * kNB;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Gs = Qs + kBQ * kLD;
  float* Ks = Gs + kBQ * kLD;
  float* Vs = Ks + kBK * kLD;
  float* Ss = Vs + kBK * kLD;
  float* rowv = Ss + kBQ * kLDP;

  const long long i0 = static_cast<long long>(blockIdx.x) * kBQ;
  const long long h = blockIdx.y, b = blockIdx.z;
  const int kvh = static_cast<int>(h / (p.H / p.KH));
  // rows past nokey_from have P = 0 everywhere: their dq is zero
  const long long i_end = p.nokey_from < p.Sq ? p.nokey_from : p.Sq;
  load_rows(Qs, kLD, p.q + b * p.qb + h * p.qh, p.qs, i0, i_end, kBQ, p.D,
            kW);
  load_rows(Gs, kLD, p.g + b * p.gb + h * p.gh, p.gs, i0, i_end, kBQ, p.Dv,
            kW);
  load_row_values(p, rowv, b, h, i0, i_end);

  const int tr = threadIdx.x / 16, te = threadIdx.x % 16;
  float dq[4][kNB];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kNB; ++c) dq[a][c] = 0.f;

  // the keys the block's rows can see
  const long long last = (i0 + kBQ < i_end ? i0 + kBQ : i_end) - 1;
  long long k_begin = 0, k_end = p.Sk;
  if (p.window > 0 && p.q_offset + i0 - p.window + 1 > 0)
    k_begin = p.q_offset + i0 - p.window + 1;
  if (p.causal && p.q_offset + last + 1 < k_end) k_end = p.q_offset + last + 1;
  if (last < i0) k_end = k_begin;  // no row with a key
  for (long long k0 = k_begin - k_begin % kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the last tile's Ks, Ss are read
    load_rows(Ks, kLD, p.k + b * p.kb + kvh * p.kh, p.ks, k0, p.Sk, kBK, p.D,
              kW);
    load_rows(Vs, kLD, p.v + b * p.vb + kvh * p.vh, p.vs, k0, p.Sk, kBK,
              p.Dv, kW);
    __syncthreads();
    scores<kBK, kLD>(p, Qs, Gs, Ks, Vs, rowv, i0, i_end, k0, nullptr, Ss);
    __syncthreads();
    for (int c0 = 0; c0 < kBK; ++c0) {
      float sa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) sa[a] = Ss[(tr + 16 * a) * kLDP + c0];
#pragma unroll
      for (int c = 0; c < kNB; ++c) {
        const float kv = Ks[c0 * kLD + te + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a) dq[a][c] = fmaf(sa[a], kv, dq[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const long long i = i0 + tr + 16 * a;
    if (i >= p.Sq) continue;
    float* dqr = p.dq + ((b * p.Sq + i) * p.H + h) * p.D;
#pragma unroll
    for (int c = 0; c < kNB; ++c) {
      const int e = te + 16 * c;
      if (e < p.D) dqr[e] = dq[a][c];
    }
  }
}

template <int kBK, int kNB>
cudaError_t launch(const Params& p, cudaStream_t st) {
  constexpr int kLD = 16 * kNB + 1;
  const size_t rows = 2 * kBQ;
  const size_t smem_kv = sizeof(float) *
      ((2 * kBK + 2 * kBQ) * static_cast<size_t>(kLD) +
       2 * kBQ * static_cast<size_t>(kBK + 1) + rows);
  const size_t smem_q = sizeof(float) *
      ((2 * kBK + 2 * kBQ) * static_cast<size_t>(kLD) +
       kBQ * static_cast<size_t>(kBK + 1) + rows);
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<kBK, kNB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_kv));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_kernel<kBK, kNB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_q));
  if (err != cudaSuccess) return err;
  const long long rows_all = static_cast<long long>(p.B) * p.H * p.Sq;
  delta_kernel<<<static_cast<unsigned>((rows_all * 32 + kThreads - 1) /
                                       kThreads),
                 kThreads, 0, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 gkv(static_cast<unsigned>((p.Sk + kBK - 1) / kBK), p.KH, p.B);
  dkdv_kernel<kBK, kNB><<<gkv, kThreads, smem_kv, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 gq(static_cast<unsigned>((p.Sq + kBQ - 1) / kBQ), p.H, p.B);
  dq_kernel<kBK, kNB><<<gq, kThreads, smem_q, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// float32 throughout.  q [B, Sq, H, D], k [B, Sk, KH, D], v [B, Sk, KH,
// Dv], o and dout [B, Sq, H, Dv] at element strides (last dim contiguous);
// lse and delta [B, H, Sq] contiguous; dq, dk, dv contiguous in the
// layouts of q, k, v.  nokey_from: the first query row that sees no key.
int repro_flash_attention_bwd(
    const float* q, const float* k, const float* v, const float* o,
    const float* dout, const float* lse, float* delta, float* dq, float* dk,
    float* dv, int B, int Sq, int Sk, int H, int KH, int D, int Dv,
    long long qb, long long qs, long long qh, long long kb, long long ks,
    long long kh, long long vb, long long vs, long long vh, long long ob,
    long long os, long long oh, long long gb, long long gs, long long gh,
    int causal, int window, float cap, float scale, long long q_offset,
    long long nokey_from, void* stream) {
  if (D < 1 || D > 256 || Dv < 1 || Dv > 256 || KH < 1 || H % KH != 0 ||
      Sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Sq == 0) return 0;
  const Params p{q,  k,  v,  o,  dout, lse, delta, dq, dk, dv, B,
                 Sq, Sk, H,  KH, D,   Dv,  qb,    qs, qh, kb, ks,
                 kh, vb, vs, vh, ob,  os,  oh,    gb, gs, gh, causal,
                 window, cap, scale, q_offset, nokey_from};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int width = D > Dv ? D : Dv;
  cudaError_t err;
  if (width <= 64) err = launch<64, 4>(p, st);
  else if (width <= 128) err = launch<64, 8>(p, st);
  else err = launch<32, 16>(p, st);
  return static_cast<int>(err);
}

const char* repro_flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
