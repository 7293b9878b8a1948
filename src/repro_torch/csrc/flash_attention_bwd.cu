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
//   2. dkdv_kernel: one block per (key tile of kBK keys, kv head, batch),
//      each warp 16 keys.  K and V of the tile stay float32 in shared
//      memory; the block walks the G query heads of its group and, for
//      each, the query tiles of kBQ rows that can see the tile (causal:
//      from the tile's first key on; window: up to its last key + window),
//      which stream through a 2-stage cp.async ring with their L and
//      delta.  Each warp takes S^T = K Q^T and dP^T = V dO^T as m16n8k8
//      accumulators with keys as rows, applies the mask, P^T = exp(S' - L)
//      (S' the scaled, capped score), dS^T = P^T (dP^T - delta) (1 -
//      tanh^2) scale on the fragments, and feeds them as the A operand of
//      dV += P^T dO and dK += dS^T Q without leaving registers.  The GQA
//      group's G heads are summed in the block, so no atomics: the result
//      is the same on every run.
//   3. dq_kernel: one block per (query tile of kM rows, head, batch), each
//      warp 16 rows, Q and dO in shared memory; the key tiles its rows can
//      see stream through the same ring; S = Q K^T and dP = dO V^T are
//      recomputed and dS feeds dQ += dS K from the accumulators.
// A row with no visible key (window past every key) keeps the forward's
// convention, the mean of V over all Sk keys: the forward writes L = +inf
// for it, so P = 0 in both passes (dq = 0, no dk), and dkdv_kernel adds
// the rows' dO / Sk into every key's dv, which is the gradient of a mean.
// Such rows are the suffix i >= nokey_from, which the wrapper computes.
//
// Arithmetic: every product (S, dP, dV, dK in the first pass; S, dP, dQ in
// the second) on the tensor cores, mma.sync.m16n8k8 TF32 in the 3xTF32
// split of csrc/tf32_mma.cuh, float32 accumulators.  The split truncates
// (split_rz: one integer instruction fewer a value than rounding; a
// product keeps about 20 bits).  S and dP keep the two cross terms in an
// accumulator of their own beside hi * hi, which breaks the chain of
// three products and lowers their error.  P = __expf(x - L).  Each tile's
// dV, dK or dQ product starts from zero and is added into the running sum
// in float32 (the tensor core truncates as it accumulates).  The k order
// of an m16n8k8 product is free: lane slot k = tig holds row 2 tig of an
// 8-row step and k = tig + 4 row 2 tig + 1, which is the accumulator's
// column order, so the P and dS fragments are the A operand as they are.
// Operands come from shared memory one float at a time; a row stride of
// 4 mod 8 floats puts both read patterns (row gid, column tig; row 2 tig,
// column gid) of a warp on 32 distinct banks.  mma.sync and not wgmma:
// wgmma takes TF32 operands from shared memory K-major only, and dV and dK
// reduce over query rows, so Q and dO (both halves of the split) would be
// staged transposed; mma.sync reads every fragment from registers.  What
// holds it back: a warp owns 16 keys (rows), since dk and dv take 128
// registers a thread at D = 128, so every fragment it reads is split for
// one m16n8k8 product set only; the splits, one shared-memory read a
// value, are most of its instructions.
// Bound: operations -- five products of the visible (query, key) pairs
// (S, dP, dv, dk, dq; the forward has two), 2.5 times the forward's flops,
// three TF32 products each at the tensor cores' TF32 rate; the dq pass
// recomputes S and dP, so this design does seven.  Widths: each block
// holds an 8 kNT-column chunk of dk and dv (of dq) in registers, kNT 8 or
// 16 by max(D, Dv); above 128 two chunks, one block each, which
// recompute S and dP.  Shared memory, ld = the chunks' width + 4 floats:
// dkdv (2 kBK + 4 kBQ) ld + 4 kBQ, dq (2 kM + 4 kBK) ld floats; 203 KB at
// D = Dv = 128 (kBK 128, kBQ 32; kM 128, kBK 32), 200 KB at 256 (kBK 64,
// kBQ 16; kM 64, kBK 16).  One block of 8 (4) warps an SM.
//
// The exported function has a plain C interface (raw device pointers,
// element strides, the caller's stream), launches the three kernels on that
// stream, never synchronises and allocates nothing: the wrapper allocates
// delta [B, H, Sq] and the contiguous outputs.  It returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

using namespace tf32;

constexpr int kDeltaThreads = 256;

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
  int vec16;              // every q, k, v, dO row 16-byte aligned
  int nchunk;             // column chunks of the outputs, one block each
  int ld;                 // row stride of the tiles in shared memory
};

__global__ void __launch_bounds__(kDeltaThreads) delta_kernel(Params p) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * kDeltaThreads + threadIdx.x) >> 5;
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

__device__ __forceinline__ bool visible(const Params& p, long long qpos,
                                        long long key) {
  if (key >= p.Sk) return false;
  if (p.causal && qpos < key) return false;
  if (p.window > 0 && qpos - key >= p.window) return false;
  return true;
}

// The score's scaled, capped value x and the cap's derivative dy (1
// without a cap), from the raw product s
__device__ __forceinline__ float scaled_score(const Params& p, float s,
                                              float& dy) {
  float x = s * p.scale;
  dy = 1.f;
  if (p.cap > 0.f) {
    const float t = tanhf(x / p.cap);
    x = t * p.cap;
    dy = 1.f - t * t;
  }
  return x;
}

// acc[n] += A B[:, 8 n + (0..7)] for n < kNT: A the 16 x 8 kNA fragments
// in (ah, al) (k-steps of 8 rows of B), B read from shared memory at
// b = &B[2 tig][gid] with row stride ld (the accumulator-order k slots:
// rows 2 tig and 2 tig + 1 of each step).  Each 8-column tile's product
// starts from zero and is added into acc in float32.
template <int kNA, int kNT>
__device__ __forceinline__ void product_into(float (&acc)[kNT][4],
                                             const uint32_t (&ah)[kNA][4],
                                             const uint32_t (&al)[kNA][4],
                                             const float* b, int ld) {
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kNA; ++j) {
      uint32_t bh[2], bl[2];
      split_rz(b[j * 8 * ld + n * 8], bh[0], bl[0]);
      split_rz(b[j * 8 * ld + ld + n * 8], bh[1], bl[1]);
      mma_3xtf32(t, ah[j], al[j], bh, bl);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += t[e];
  }
}

// c[n] = A B^T for the 16 rows of a at &A[gid][tig] and the 8 kNB rows of
// b at &B[gid][tig] (both row stride ld), reduced over width8 columns; the
// cross terms al bh + ah bl sum apart from ah bh
template <int kNB>
__device__ __forceinline__ void scores_tc(float (&c)[kNB][4], const float* a,
                                          const float* b, int ld,
                                          int width8) {
  float x[kNB][4];  // the cross terms, apart from hi * hi
#pragma unroll
  for (int n = 0; n < kNB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = x[n][e] = 0.f;
#pragma unroll 16
  for (int kk = 0; kk < width8; kk += 8) {
    uint32_t ah[4], al[4];
    split_rz(a[kk], ah[0], al[0]);               // row gid, column kk + tig
    split_rz(a[kk + 8 * ld], ah[1], al[1]);      // row gid + 8
    split_rz(a[kk + 4], ah[2], al[2]);           // column kk + tig + 4
    split_rz(a[kk + 8 * ld + 4], ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < kNB; ++n) {
      uint32_t bh[2], bl[2];
      split_rz(b[n * 8 * ld + kk], bh[0], bl[0]);
      split_rz(b[n * 8 * ld + kk + 4], bh[1], bl[1]);
      mma_tf32(x[n], al, bh);
      mma_tf32(x[n], ah, bl);
      mma_tf32(c[n], ah, bh);
    }
  }
#pragma unroll
  for (int n = 0; n < kNB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] += x[n][e];
}

// accumulator tiles c[j] (rows gid, gid + 8; columns 2 tig, 2 tig + 1) as
// the A operand of a product over those columns: slot k = tig takes
// column 2 tig, k = tig + 4 column 2 tig + 1
template <int kN>
__device__ __forceinline__ void as_a_operand(const float (&c)[kN][4],
                                             uint32_t (&h)[kN][4],
                                             uint32_t (&l)[kN][4]) {
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    split_rz(c[j][0], h[j][0], l[j][0]);  // row gid, column 2 tig
    split_rz(c[j][2], h[j][1], l[j][1]);  // row gid + 8, column 2 tig
    split_rz(c[j][1], h[j][2], l[j][2]);  // row gid, column 2 tig + 1
    split_rz(c[j][3], h[j][3], l[j][3]);  // row gid + 8, column 2 tig + 1
  }
}

// kWarps warps of 16 keys (kBK keys a block), query tiles of kBQ rows,
// an 8 kNT-column chunk of dk and dv
template <int kWarps, int kBQ, int kNT>
__global__ void __launch_bounds__(kWarps * 32, 1) dkdv_kernel(Params p) {
  constexpr int kThreads = kWarps * 32;
  constexpr int kBK = 16 * kWarps;
  constexpr int kNQ = kBQ / 8;
  constexpr int kCW = 8 * kNT;
  extern __shared__ float4 smem4[];
  const int ld = p.ld, W = p.ld - 4;
  float* Ks = reinterpret_cast<float*>(smem4);   // [kBK][ld]
  float* Vs = Ks + kBK * ld;                      // [kBK][ld]
  float* Qs = Vs + kBK * ld;                      // [2][kBQ][ld]
  float* Gs = Qs + 2 * kBQ * ld;                  // [2][kBQ][ld]
  float* Ls = Gs + 2 * kBQ * ld;                  // [2][kBQ]
  float* Ds = Ls + 2 * kBQ;                       // [2][kBQ]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int tile = blockIdx.x / p.nchunk;
  const int c0 = (blockIdx.x - tile * p.nchunk) * kCW;
  const long long k0 = static_cast<long long>(tile) * kBK;
  const int kvh = blockIdx.y;
  const long long b = blockIdx.z;
  const int G = p.H / p.KH;
  const bool vec16 = p.vec16 != 0;
  const int D8 = (p.D + 7) & ~7, Dv8 = (p.Dv + 7) & ~7;
  const int valid_k = p.Sk - k0 < kBK ? static_cast<int>(p.Sk - k0) : kBK;
  const long long k_end = k0 + valid_k;
  load_slab<kThreads>(Ks, ld, p.k + b * p.kb + kvh * p.kh + k0 * p.ks, p.ks,
                      kBK, valid_k, p.D, W, vec16);
  load_slab<kThreads>(Vs, ld, p.v + b * p.vb + kvh * p.vh + k0 * p.vs, p.vs,
                      kBK, valid_k, p.Dv, W, vec16);

  // the query rows that can see a key of [k0, k_end), short of the rows
  // that see none
  long long i_begin = 0, i_end = p.nokey_from;
  if (p.causal && k0 - p.q_offset > i_begin) i_begin = k0 - p.q_offset;
  if (p.window > 0 && k_end - 1 + p.window - p.q_offset < i_end)
    i_end = k_end - 1 + p.window - p.q_offset;
  if (i_end > p.Sq) i_end = p.Sq;
  const int nq = i_end > i_begin
                     ? static_cast<int>((i_end - i_begin + kBQ - 1) / kBQ)
                     : 0;
  const int T = G * nq;  // (head, query tile) steps, heads outer

  auto load_q = [&](int t, int stage) {
    const int gi = t / nq;
    const long long i0 = i_begin + static_cast<long long>(t - gi * nq) * kBQ;
    const long long h = static_cast<long long>(kvh) * G + gi;
    const int valid = i_end - i0 < kBQ ? static_cast<int>(i_end - i0) : kBQ;
    load_slab<kThreads>(Qs + stage * kBQ * ld, ld,
                        p.q + b * p.qb + h * p.qh + i0 * p.qs, p.qs, kBQ,
                        valid, p.D, W, vec16);
    load_slab<kThreads>(Gs + stage * kBQ * ld, ld,
                        p.g + b * p.gb + h * p.gh + i0 * p.gs, p.gs, kBQ,
                        valid, p.Dv, W, vec16);
    const long long at = (b * p.H + h) * p.Sq + i0;
    for (int r = threadIdx.x; r < kBQ; r += kThreads) {
      cp_async(Ls + stage * kBQ + r, p.lse + at + (r < valid ? r : 0),
               r < valid, false);
      cp_async(Ds + stage * kBQ + r, p.delta + at + (r < valid ? r : 0),
               r < valid, false);
    }
  };
  if (T > 0) load_q(0, 0);
  cp_async_commit();

  float dk[kNT][4], dv[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  // this warp's keys: kw + gid and kw + gid + 8
  const long long kw = k0 + warp * 16;
  const float* ka = Ks + (warp * 16 + gid) * ld + tig;
  const float* va = Vs + (warp * 16 + gid) * ld + tig;

  for (int t = 0; t < T; ++t) {
    const int stage = t & 1;
    if (t + 1 < T) {
      load_q(t + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int gi = t / nq;
    const long long i0 = i_begin + static_cast<long long>(t - gi * nq) * kBQ;
    const long long pos0 = p.q_offset + i0;  // the tile's first query
    const long long pos1 = pos0 + kBQ - 1;   // its last
    // a warp whose 16 keys no query of the tile sees adds nothing
    const bool skip = kw >= p.Sk || (p.causal && pos1 < kw) ||
                      (p.window > 0 && pos0 - (kw + 15) >= p.window);
    if (!skip) {
      const float* Qt = Qs + stage * kBQ * ld;
      const float* Gt = Gs + stage * kBQ * ld;
      const float* Lt = Ls + stage * kBQ;
      const float* Dt = Ds + stage * kBQ;
      float st[kNQ][4], dpt[kNQ][4];
      scores_tc<kNQ>(st, ka, Qt + gid * ld + tig, ld, D8);
      scores_tc<kNQ>(dpt, va, Gt + gid * ld + tig, ld, Dv8);
      // element e of tile n: key kw + gid + 8 (e / 2), query i0 + 8 n +
      // 2 tig + e % 2 (a tile every query of which sees every key of the
      // warp needs no mask)
      const bool unmasked = i0 + kBQ <= i_end && kw + 16 <= p.Sk &&
                            (!p.causal || pos0 >= kw + 15) &&
                            (p.window <= 0 || pos1 - kw < p.window);
#pragma unroll
      for (int n = 0; n < kNQ; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n * 8 + 2 * tig + (e & 1);
          float dy;
          const float x = scaled_score(p, st[n][e], dy);
          const bool ok =
              unmasked || (i0 + col < i_end &&
                           visible(p, pos0 + col, kw + gid + 8 * (e >> 1)));
          const float P = ok ? __expf(x - Lt[col]) : 0.f;
          st[n][e] = P;
          dpt[n][e] = P * (dpt[n][e] - Dt[col]) * dy * p.scale;
        }
      }
      uint32_t ah[kNQ][4], al[kNQ][4];
      if (c0 < p.Dv) {  // dV += P^T dO
        as_a_operand<kNQ>(st, ah, al);
        product_into<kNQ, kNT>(dv, ah, al, Gt + 2 * tig * ld + c0 + gid, ld);
      }
      if (c0 < p.D) {  // dK += dS^T Q
        as_a_operand<kNQ>(dpt, ah, al);
        product_into<kNQ, kNT>(dk, ah, al, Qt + 2 * tig * ld + c0 + gid, ld);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration
  }
  cp_async_wait<0>();

  // rows that see no key: out = mean of V over all keys, so each key's dv
  // takes their dO / Sk
  if (p.nokey_from < p.Sq && c0 < p.Dv) {
    __syncthreads();
    float* u = Qs;  // [kCW]
    for (int e = threadIdx.x; e < kCW; e += kThreads) {
      float s = 0.f;
      if (c0 + e < p.Dv)
        for (int gi = 0; gi < G; ++gi) {
          const float* g = p.g + b * p.gb +
                           (static_cast<long long>(kvh) * G + gi) * p.gh +
                           c0 + e;
          for (long long i = p.nokey_from; i < p.Sq; ++i) s += g[i * p.gs];
        }
      u[e] = s / static_cast<float>(p.Sk);
    }
    __syncthreads();
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dv[n][e] += u[n * 8 + 2 * tig + (e & 1)];
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long key = kw + gid + 8 * r;
    if (key >= p.Sk) continue;
    float* dkr = p.dk + ((b * p.Sk + key) * p.KH + kvh) * p.D;
    float* dvr = p.dv + ((b * p.Sk + key) * p.KH + kvh) * p.Dv;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + n * 8 + 2 * tig + e;
        if (col < p.D) dkr[col] = dk[n][2 * r + e];
        if (col < p.Dv) dvr[col] = dv[n][2 * r + e];
      }
    }
  }
}

// kWarps warps of 16 query rows (kM rows a block), key tiles of kBK keys,
// an 8 kNT-column chunk of dq
template <int kWarps, int kBK, int kNT>
__global__ void __launch_bounds__(kWarps * 32, 1) dq_kernel(Params p) {
  constexpr int kThreads = kWarps * 32;
  constexpr int kM = 16 * kWarps;
  constexpr int kNS = kBK / 8;
  constexpr int kCW = 8 * kNT;
  extern __shared__ float4 smem4[];
  const int ld = p.ld, W = p.ld - 4;
  float* Qs = reinterpret_cast<float*>(smem4);   // [kM][ld]
  float* Gs = Qs + kM * ld;                       // [kM][ld]
  float* Ks = Gs + kM * ld;                       // [2][kBK][ld]
  float* Vs = Ks + 2 * kBK * ld;                  // [2][kBK][ld]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int ntiles = gridDim.x / p.nchunk;
  int tile = blockIdx.x / p.nchunk;
  const int c0 = (blockIdx.x - tile * p.nchunk) * kCW;
  if (c0 >= p.D) return;  // a chunk past dq's columns (Dv > D)
  if (p.causal) tile = ntiles - 1 - tile;  // the longest blocks first
  const long long i0 = static_cast<long long>(tile) * kM;
  const long long h = blockIdx.y, b = blockIdx.z;
  const int kvh = static_cast<int>(h / (p.H / p.KH));
  const bool vec16 = p.vec16 != 0;
  const int D8 = (p.D + 7) & ~7, Dv8 = (p.Dv + 7) & ~7;
  // rows past nokey_from have P = 0 everywhere: their dq is zero
  const long long i_end = p.nokey_from < p.Sq ? p.nokey_from : p.Sq;
  const int valid = i_end - i0 <= 0 ? 0
                    : i_end - i0 < kM ? static_cast<int>(i_end - i0) : kM;
  load_slab<kThreads>(Qs, ld, p.q + b * p.qb + h * p.qh + i0 * p.qs, p.qs,
                      kM, valid, p.D, W, vec16);
  load_slab<kThreads>(Gs, ld, p.g + b * p.gb + h * p.gh + i0 * p.gs, p.gs,
                      kM, valid, p.Dv, W, vec16);

  // the keys the block's rows can see
  const long long last = i0 + valid - 1;
  long long k_begin = 0, k_end = p.Sk;
  if (p.window > 0 && p.q_offset + i0 - p.window + 1 > 0)
    k_begin = p.q_offset + i0 - p.window + 1;
  if (p.causal && p.q_offset + last + 1 < k_end) k_end = p.q_offset + last + 1;
  if (valid == 0) k_end = k_begin;  // no row with a key
  const int t_begin = static_cast<int>(k_begin / kBK);
  const int t_end =
      k_end > k_begin ? static_cast<int>((k_end + kBK - 1) / kBK) : t_begin;

  const float* kp = p.k + b * p.kb + kvh * p.kh;
  const float* vp = p.v + b * p.vb + kvh * p.vh;
  auto load_kv = [&](int t, int stage) {
    const long long k0 = static_cast<long long>(t) * kBK;
    const int vk = p.Sk - k0 < kBK ? static_cast<int>(p.Sk - k0) : kBK;
    load_slab<kThreads>(Ks + stage * kBK * ld, ld, kp + k0 * p.ks, p.ks, kBK,
                        vk, p.D, W, vec16);
    load_slab<kThreads>(Vs + stage * kBK * ld, ld, vp + k0 * p.vs, p.vs, kBK,
                        vk, p.Dv, W, vec16);
  };
  if (t_begin < t_end) load_kv(t_begin, 0);
  cp_async_commit();

  // this thread's rows: iw + gid and iw + gid + 8
  const long long iw = i0 + warp * 16;
  float L[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long i = iw + gid + 8 * r;
    const long long at = (b * p.H + h) * p.Sq + i;
    L[r] = i < i_end ? p.lse[at] : 0.f;
    dl[r] = i < i_end ? p.delta[at] : 0.f;
  }
  float dq[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  const float* qa = Qs + (warp * 16 + gid) * ld + tig;
  const float* ga = Gs + (warp * 16 + gid) * ld + tig;
  const long long pos0 = p.q_offset + iw, pos1 = pos0 + 15;

  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      load_kv(t + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const long long k0 = static_cast<long long>(t) * kBK;
    // a warp whose rows see no key of the tile adds nothing
    const bool skip = iw >= i_end || (p.causal && pos1 < k0) ||
                      (p.window > 0 && pos0 - (k0 + kBK - 1) >= p.window);
    if (!skip) {
      const float* Kt = Ks + stage * kBK * ld;
      const float* Vt = Vs + stage * kBK * ld;
      float s[kNS][4], dp[kNS][4];
      scores_tc<kNS>(s, qa, Kt + gid * ld + tig, ld, D8);
      scores_tc<kNS>(dp, ga, Vt + gid * ld + tig, ld, Dv8);
      // element e of tile n: row iw + gid + 8 (e / 2), key k0 + 8 n +
      // 2 tig + e % 2
      const bool unmasked = iw + 16 <= i_end && k0 + kBK <= p.Sk &&
                            (!p.causal || pos0 >= k0 + kBK - 1) &&
                            (p.window <= 0 || pos1 - k0 < p.window);
#pragma unroll
      for (int n = 0; n < kNS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float dy;
          const float x = scaled_score(p, s[n][e], dy);
          const bool ok =
              unmasked ||
              (iw + gid + 8 * r < i_end &&
               visible(p, pos0 + gid + 8 * r, k0 + n * 8 + 2 * tig + (e & 1)));
          const float P = ok ? __expf(x - L[r]) : 0.f;
          dp[n][e] = P * (dp[n][e] - dl[r]) * dy * p.scale;
        }
      }
      uint32_t ah[kNS][4], al[kNS][4];
      as_a_operand<kNS>(dp, ah, al);
      product_into<kNS, kNT>(dq, ah, al, Kt + 2 * tig * ld + c0 + gid, ld);
    }
    __syncthreads();  // this stage is refilled by the next iteration
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long i = iw + gid + 8 * r;
    if (i >= p.Sq) continue;
    float* dqr = p.dq + ((b * p.Sq + i) * p.H + h) * p.D;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + n * 8 + 2 * tig + e;
        if (col < p.D) dqr[col] = dq[n][2 * r + e];
      }
    }
  }
}

// dkdv: kWarpsKV warps (16 keys each), query tiles of kBQ rows; dq:
// kWarpsQ warps (16 rows each), key tiles of kBKq keys; column chunks of
// 8 kNT
template <int kWarpsKV, int kBQ, int kWarpsQ, int kBKq, int kNT>
cudaError_t launch(Params p, cudaStream_t st) {
  constexpr int kCW = 8 * kNT;
  constexpr int kBK = 16 * kWarpsKV;
  constexpr int kM = 16 * kWarpsQ;
  const int width = p.D > p.Dv ? p.D : p.Dv;
  p.nchunk = (width + kCW - 1) / kCW;
  p.ld = p.nchunk * kCW + 4;  // 4 mod 8: conflict-free fragment reads
  const size_t ld = static_cast<size_t>(p.ld);
  const size_t smem_kv = sizeof(float) * ((2 * kBK + 4 * kBQ) * ld + 4 * kBQ);
  const size_t smem_q = sizeof(float) * (2 * kM + 4 * kBKq) * ld;
  auto* kv_kernel = dkdv_kernel<kWarpsKV, kBQ, kNT>;
  auto* q_kernel = dq_kernel<kWarpsQ, kBKq, kNT>;
  cudaError_t err = cudaFuncSetAttribute(
      kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_kv));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(q_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_q));
  if (err != cudaSuccess) return err;
  const long long rows_all = static_cast<long long>(p.B) * p.H * p.Sq;
  delta_kernel<<<static_cast<unsigned>((rows_all * 32 + kDeltaThreads - 1) /
                                       kDeltaThreads),
                 kDeltaThreads, 0, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 gkv(static_cast<unsigned>((p.Sk + kBK - 1) / kBK * p.nchunk), p.KH,
           p.B);
  kv_kernel<<<gkv, kWarpsKV * 32, smem_kv, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 gq(static_cast<unsigned>((p.Sq + kM - 1) / kM * p.nchunk), p.H, p.B);
  q_kernel<<<gq, kWarpsQ * 32, smem_q, st>>>(p);
  return cudaGetLastError();
}

// 16-byte copies need every row of q, k, v and dO to start 16-byte aligned
bool aligned16(const Params& p) {
  const uintptr_t ptrs =
      reinterpret_cast<uintptr_t>(p.q) | reinterpret_cast<uintptr_t>(p.k) |
      reinterpret_cast<uintptr_t>(p.v) | reinterpret_cast<uintptr_t>(p.g);
  const long long strides = p.qb | p.qs | p.qh | p.kb | p.ks | p.kh | p.vb |
                            p.vs | p.vh | p.gb | p.gs | p.gh | p.D | p.Dv;
  return (ptrs & 15) == 0 && (strides & 3) == 0;
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
  Params p{q,  k,  v,  o,  dout, lse, delta, dq, dk, dv, B,
           Sq, Sk, H,  KH, D,   Dv,  qb,    qs, qh, kb, ks,
           kh, vb, vs, vh, ob,  os,  oh,    gb, gs, gh, causal,
           window, cap, scale, q_offset, nokey_from, 0, 1, 0};
  p.vec16 = aligned16(p) ? 1 : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int width = D > Dv ? D : Dv;
  cudaError_t err;
  if (width <= 64) err = launch<8, 32, 8, 32, 8>(p, st);
  else if (width <= 128) err = launch<8, 32, 8, 32, 16>(p, st);
  else err = launch<4, 16, 4, 16, 16>(p, st);
  return static_cast<int>(err);
}

const char* repro_flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
