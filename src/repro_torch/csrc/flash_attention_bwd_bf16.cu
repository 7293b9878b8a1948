// Hopper (sm_90a) kernels for the backward of the LM path's bfloat16
// attention: given bf16 q, k, v, the bf16 forward's output O and row
// logsumexp L (csrc/flash_attention_sm90.cu writes it through
// repro_flash_attention_sm90_lse), and dO, they compute dq, dk and dv of
// the forward's contract (causal, window, tanh soft-cap, scale, q_offset,
// Sq != Sk, GQA, D != Dv up to 256, strided views with a contiguous last
// dimension), each in bf16.
//
// The TPU side has no backward kernel: the reference trains through
// jax.grad of plain jnp (src/repro/models/attention.py::chunked_attention),
// which XLA differentiates in any dtype.  On the card the port's bf16
// forward is the hand kernel of csrc/flash_attention_sm90.cu (which
// replaces src/repro/kernels/flash_attention/kernel.py::
// flash_attention_pallas), so its gradient is a kernel too.  The structure
// is that of the float32 backward, csrc/flash_attention_bwd.cu (the FA2
// backward: P recomputed from the saved L, never stored):
//   1. delta_bf16_kernel: delta_i = sum_d dO_id O_id in float32, one warp a
//      row.
//   2. dkdv_bf16_kernel: one block per (key tile of kBK = 128 keys, kv
//      head, batch), each of its 8 warps 16 keys.  K and V of the tile stay
//      in shared memory; the block walks the G query heads of its group
//      and, for each, the query tiles of kTile rows that can see the tile,
//      which stream through a 2-stage cp.async ring with their L and delta.
//      Each warp takes S^T = K Q^T and dP^T = V dO^T as accumulators with
//      keys as rows, applies the mask, P^T = exp(S' - L) (S' the scaled,
//      capped score), dS^T = P^T (dP^T - delta) (1 - tanh^2) scale, and
//      feeds them as the A operand of dV += P^T dO and dK += dS^T Q
//      without leaving registers.  The GQA group's G heads are summed in
//      the block, so no atomics: the same bits on every run.
//   3. dq_bf16_kernel: one block per (query tile of kM = 128 rows, head,
//      batch), each warp 16 rows, Q and dO in shared memory; the key tiles
//      its rows can see stream through the same ring; S and dP are
//      recomputed and dS feeds dQ += dS K from the accumulators.
// A row with no visible key (window past every key) keeps the forward's
// convention, the mean of V over all Sk keys: the forward writes L = +inf
// for it, so P = 0 in both passes (dq = 0, no dk), and the dK/dV pass adds
// the rows' dO / Sk into every key's dv.  Such rows are the suffix
// i >= nokey_from, which the wrapper computes.
//
// Arithmetic: every product on the tensor cores as bf16
// mma.sync.m16n8k16 with float32 accumulators, no split (what replaces
// the 3xTF32 triple of csrc/tf32_mma.cuh).  P and dS are rounded to bf16
// only as operands of the dV, dK and dQ products, as the forward rounds P
// before its PV product; the scores, the softmax and every sum stay
// float32 until the one bf16 store of each gradient row.  P = __expf(x -
// L).  The accumulator of two neighbouring 8-column tiles is the A
// fragment of one k16 step (columns 2 tig, 2 tig + 1 and 8 + 2 tig, 9 + 2
// tig), so P^T and dS^T go from the score accumulators to the gradient
// products in registers.  The score products read both operands as pairs
// of neighbouring bf16 along the reduced axis (D), one 32-bit shared load
// each; the gradient products reduce over the streamed rows, so their B
// operand (dO, Q or K, row-major) is read transposed by ldmatrix .trans,
// four 8x8 matrices an instruction.  Tiles in shared memory have a row
// stride of ld = W + 8 bf16 (W the padded width, a multiple of 32), which
// puts both the 32-bit fragment reads and ldmatrix's eight 16-byte rows of
// a warp on distinct banks.
//
// Bound: operations -- five products of the visible (query, key) pairs
// (S, dP, dv, dk, dq; the forward has two), 2.5 times the forward's flops,
// at the tensor cores' bf16 rate; the dq pass recomputes S and dP, so this
// design does seven.  What holds it back: mma.sync, not wgmma (ROADMAP:
// wgmma and TMA with Q and dO staged transposed are a later step), and
// every operand fragment read from shared memory for each product.
// Widths: each block holds an 8 kNT-column chunk of dk and dv (of dq) in
// registers, kNT 8 up to 64 columns, else 16; above 128 two chunks, one
// block each, which recompute S and dP.  Shared memory: (2 * 128 + 4 *
// kTile) rows of ld bf16 (+ L and delta), 104 KB at D = Dv = 128, 198 KB
// at 256 (and at MLA's 192/128).  One block of 8 warps an SM.
//
// The exported function has a plain C interface (raw device pointers,
// element strides, the caller's stream), launches the three kernels on that
// stream, never synchronises and allocates nothing: the wrapper allocates
// delta [B, H, Sq] and the contiguous outputs.  Pointers and strides of
// q, k, v, O and dO must be 16-byte aligned (16-byte cp.async copies), D
// and Dv multiples of 16, as the bf16 forward requires.  It returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kDeltaThreads = 256;
constexpr int kWarps = 8;                 // both passes
constexpr int kThreads = kWarps * 32;
constexpr int kBK = 16 * kWarps;          // keys a dK/dV block
constexpr int kM = 16 * kWarps;           // query rows a dQ block
constexpr int kTile = 32;                 // streamed rows: queries or keys

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* o;
  const bf16* g;       // dO
  const float* lse;    // [B, H, Sq]; +inf: no visible key
  float* delta;        // [B, H, Sq]
  bf16* dq;            // [B, Sq, H, D] contiguous
  bf16* dk;            // [B, Sk, KH, D] contiguous
  bf16* dv;            // [B, Sk, KH, Dv] contiguous
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
  int nchunk;             // column chunks of the outputs, one block each
  int ld;                 // row stride of the tiles in shared memory
};

// ---------------------------------------------------------------------------
// PTX wrappers: cp.async, ldmatrix, mma.sync
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, zeros when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0));
}

// 4 bytes, zeros when !ok
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// four 8x8 bf16 matrices, transposed: lanes 8 i .. 8 i + 7 give the row
// addresses of matrix i, and lane l receives (rows 2 (l % 4), 2 (l % 4) + 1;
// column l / 4) of each
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c += a b: m16n8k16, bf16 operands, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two neighbouring bf16 of shared memory as one 32-bit fragment register
__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [0, kRows) of a [rows, width] bf16 slab with row stride gstride into
// shared memory of row stride ld, columns [0, wpad) (zeros past width),
// rows past valid_rows zero; 16-byte copies
template <int kRows>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* g,
                                          long long gstride, int valid_rows,
                                          int width, int wpad) {
  const int per_row = wpad / 8;
  for (int i = threadIdx.x; i < kRows * per_row; i += kThreads) {
    const int r = i / per_row, c = (i - r * per_row) * 8;
    const bool ok = r < valid_rows && c < width;
    cp_async16(dst + r * ld + c, ok ? g + r * gstride + c : g, ok);
  }
}

// ---------------------------------------------------------------------------
// The kernels
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kDeltaThreads)
delta_bf16_kernel(Params p) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * kDeltaThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<long long>(p.B) * p.H * p.Sq) return;
  const long long i = row % p.Sq;
  const long long bh = row / p.Sq;
  const long long h = bh % p.H, b = bh / p.H;
  const bf16* o = p.o + b * p.ob + i * p.os + h * p.oh;
  const bf16* g = p.g + b * p.gb + i * p.gs + h * p.gh;
  float s = 0.f;
  for (int c = 2 * lane; c < p.Dv; c += 64) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(o + c));
    const float2 d = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(g + c));
    s = fmaf(a.x, d.x, s);
    s = fmaf(a.y, d.y, s);
  }
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

// c[n] += A B^T for the 16 rows of A at a = &A[gid][2 tig] and the 8 kNB
// rows of B at b = &B[gid][2 tig] (both row-major bf16, row stride ld),
// reduced over width16 columns (a multiple of 16)
template <int kNB>
__device__ __forceinline__ void scores(float (&c)[kNB][4], const bf16* a,
                                       const bf16* b, int ld, int width16) {
#pragma unroll
  for (int n = 0; n < kNB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < width16; kk += 16) {
    uint32_t af[4];
    af[0] = ld32(a + kk);               // row gid, columns kk + 2 tig, + 1
    af[1] = ld32(a + 8 * ld + kk);      // row gid + 8
    af[2] = ld32(a + kk + 8);           // columns kk + 8 + 2 tig, + 1
    af[3] = ld32(a + 8 * ld + kk + 8);
#pragma unroll
    for (int n = 0; n < kNB; ++n)
      mma_bf16(c[n], af, ld32(b + n * 8 * ld + kk),
               ld32(b + n * 8 * ld + kk + 8));
  }
}

// accumulator tiles c[2 t], c[2 t + 1] (rows gid, gid + 8; columns 2 tig,
// 2 tig + 1 of each) as the A fragment of the t-th k16 step over those 16
// columns, rounded to bf16
template <int kN>
__device__ __forceinline__ void as_a_operand(const float (&c)[kN][4],
                                             uint32_t (&a)[kN / 2][4]) {
#pragma unroll
  for (int t = 0; t < kN / 2; ++t) {
    a[t][0] = pack_bf16(c[2 * t][0], c[2 * t][1]);
    a[t][1] = pack_bf16(c[2 * t][2], c[2 * t][3]);
    a[t][2] = pack_bf16(c[2 * t + 1][0], c[2 * t + 1][1]);
    a[t][3] = pack_bf16(c[2 * t + 1][2], c[2 * t + 1][3]);
  }
}

// acc[n] += A B[:, c0 + 8 n + (0..7)] for n < kNT: A the kNA k16 fragments
// (k-steps of 16 rows of B), B row-major bf16 in shared memory at b =
// &B[0][c0] (row stride ld), read transposed by ldmatrix
template <int kNA, int kNT>
__device__ __forceinline__ void product_into(float (&acc)[kNT][4],
                                             const uint32_t (&a)[kNA][4],
                                             const bf16* b, int ld) {
  const int lane = threadIdx.x & 31;
  // matrix lane / 8: rows + 8 of the k16 step for matrices 1 and 3, the
  // next 8 columns for 2 and 3
  const bf16* bl = b + ((lane & 7) + 8 * ((lane >> 3) & 1)) * ld +
                   8 * (lane >> 4);
#pragma unroll
  for (int t = 0; t < kNA; ++t)
#pragma unroll
    for (int j = 0; j < kNT / 2; ++j) {
      uint32_t r[4];
      ldsm_x4_trans(r, bl + 16 * t * ld + 16 * j);
      mma_bf16(acc[2 * j], a[t], r[0], r[1]);
      mma_bf16(acc[2 * j + 1], a[t], r[2], r[3]);
    }
}

// an 8 kNT-column chunk of dk and dv for the 128 keys of a block
template <int kNT>
__global__ void __launch_bounds__(kThreads, 1) dkdv_bf16_kernel(Params p) {
  constexpr int kNQ = kTile / 8;
  constexpr int kCW = 8 * kNT;
  extern __shared__ uint4 smem16[];
  const int ld = p.ld, W = p.ld - 8;
  bf16* Ks = reinterpret_cast<bf16*>(smem16);    // [kBK][ld]
  bf16* Vs = Ks + kBK * ld;                       // [kBK][ld]
  bf16* Qs = Vs + kBK * ld;                       // [2][kTile][ld]
  bf16* Gs = Qs + 2 * kTile * ld;                 // [2][kTile][ld]
  float* Ls = reinterpret_cast<float*>(Gs + 2 * kTile * ld);  // [2][kTile]
  float* Ds = Ls + 2 * kTile;                                 // [2][kTile]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int tile = blockIdx.x / p.nchunk;
  const int c0 = (blockIdx.x - tile * p.nchunk) * kCW;
  const long long k0 = static_cast<long long>(tile) * kBK;
  const int kvh = blockIdx.y;
  const long long b = blockIdx.z;
  const int G = p.H / p.KH;
  const int valid_k = p.Sk - k0 < kBK ? static_cast<int>(p.Sk - k0) : kBK;
  const long long k_end = k0 + valid_k;
  load_tile<kBK>(Ks, ld, p.k + b * p.kb + kvh * p.kh + k0 * p.ks, p.ks,
                 valid_k, p.D, W);
  load_tile<kBK>(Vs, ld, p.v + b * p.vb + kvh * p.vh + k0 * p.vs, p.vs,
                 valid_k, p.Dv, W);

  // the query rows that can see a key of [k0, k_end), short of the rows
  // that see none
  long long i_begin = 0, i_end = p.nokey_from;
  if (p.causal && k0 - p.q_offset > i_begin) i_begin = k0 - p.q_offset;
  if (p.window > 0 && k_end - 1 + p.window - p.q_offset < i_end)
    i_end = k_end - 1 + p.window - p.q_offset;
  if (i_end > p.Sq) i_end = p.Sq;
  const int nq = i_end > i_begin
                     ? static_cast<int>((i_end - i_begin + kTile - 1) / kTile)
                     : 0;
  const int T = G * nq;  // (head, query tile) steps, heads outer

  auto load_q = [&](int t, int stage) {
    const int gi = t / nq;
    const long long i0 = i_begin + static_cast<long long>(t - gi * nq) * kTile;
    const long long h = static_cast<long long>(kvh) * G + gi;
    const int valid = i_end - i0 < kTile ? static_cast<int>(i_end - i0)
                                         : kTile;
    load_tile<kTile>(Qs + stage * kTile * ld, ld,
                     p.q + b * p.qb + h * p.qh + i0 * p.qs, p.qs, valid, p.D,
                     W);
    load_tile<kTile>(Gs + stage * kTile * ld, ld,
                     p.g + b * p.gb + h * p.gh + i0 * p.gs, p.gs, valid, p.Dv,
                     W);
    const long long at = (b * p.H + h) * p.Sq + i0;
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      cp_async4(Ls + stage * kTile + r, p.lse + at + (r < valid ? r : 0),
                r < valid);
      cp_async4(Ds + stage * kTile + r, p.delta + at + (r < valid ? r : 0),
                r < valid);
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
  const bf16* ka = Ks + (warp * 16 + gid) * ld + 2 * tig;
  const bf16* va = Vs + (warp * 16 + gid) * ld + 2 * tig;

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
    const long long i0 = i_begin + static_cast<long long>(t - gi * nq) * kTile;
    const long long pos0 = p.q_offset + i0;  // the tile's first query
    const long long pos1 = pos0 + kTile - 1; // its last
    // a warp whose 16 keys no query of the tile sees adds nothing
    const bool skip = kw >= p.Sk || (p.causal && pos1 < kw) ||
                      (p.window > 0 && pos0 - (kw + 15) >= p.window);
    if (!skip) {
      const bf16* Qt = Qs + stage * kTile * ld;
      const bf16* Gt = Gs + stage * kTile * ld;
      const float* Lt = Ls + stage * kTile;
      const float* Dt = Ds + stage * kTile;
      float st[kNQ][4], dpt[kNQ][4];
      scores<kNQ>(st, ka, Qt + gid * ld + 2 * tig, ld, p.D);
      scores<kNQ>(dpt, va, Gt + gid * ld + 2 * tig, ld, p.Dv);
      // element e of tile n: key kw + gid + 8 (e / 2), query i0 + 8 n +
      // 2 tig + e % 2 (a tile every query of which sees every key of the
      // warp needs no mask)
      const bool unmasked = i0 + kTile <= i_end && kw + 16 <= p.Sk &&
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
      uint32_t a[kNQ / 2][4];
      if (c0 < p.Dv) {  // dV += P^T dO
        as_a_operand<kNQ>(st, a);
        product_into<kNQ / 2, kNT>(dv, a, Gt + c0, ld);
      }
      if (c0 < p.D) {  // dK += dS^T Q
        as_a_operand<kNQ>(dpt, a);
        product_into<kNQ / 2, kNT>(dk, a, Qt + c0, ld);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration
  }
  cp_async_wait<0>();

  // rows that see no key: out = mean of V over all keys, so each key's dv
  // takes their dO / Sk
  if (p.nokey_from < p.Sq && c0 < p.Dv) {
    __syncthreads();
    float* u = reinterpret_cast<float*>(Qs);  // [kCW]
    for (int e = threadIdx.x; e < kCW; e += kThreads) {
      float s = 0.f;
      if (c0 + e < p.Dv)
        for (int gi = 0; gi < G; ++gi) {
          const bf16* g = p.g + b * p.gb +
                          (static_cast<long long>(kvh) * G + gi) * p.gh +
                          c0 + e;
          for (long long i = p.nokey_from; i < p.Sq; ++i)
            s += __bfloat162float(g[i * p.gs]);
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
    bf16* dkr = p.dk + ((b * p.Sk + key) * p.KH + kvh) * p.D;
    bf16* dvr = p.dv + ((b * p.Sk + key) * p.KH + kvh) * p.Dv;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const int col = c0 + n * 8 + 2 * tig;  // even; D, Dv multiples of 16
      if (col < p.D)
        *reinterpret_cast<uint32_t*>(dkr + col) =
            pack_bf16(dk[n][2 * r], dk[n][2 * r + 1]);
      if (col < p.Dv)
        *reinterpret_cast<uint32_t*>(dvr + col) =
            pack_bf16(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

// an 8 kNT-column chunk of dq for the 128 query rows of a block
template <int kNT>
__global__ void __launch_bounds__(kThreads, 1) dq_bf16_kernel(Params p) {
  constexpr int kNS = kTile / 8;
  constexpr int kCW = 8 * kNT;
  extern __shared__ uint4 smem16[];
  const int ld = p.ld, W = p.ld - 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem16);    // [kM][ld]
  bf16* Gs = Qs + kM * ld;                        // [kM][ld]
  bf16* Ks = Gs + kM * ld;                        // [2][kTile][ld]
  bf16* Vs = Ks + 2 * kTile * ld;                 // [2][kTile][ld]

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
  // rows past nokey_from have P = 0 everywhere: their dq is zero
  const long long i_end = p.nokey_from < p.Sq ? p.nokey_from : p.Sq;
  const int valid = i_end - i0 <= 0 ? 0
                    : i_end - i0 < kM ? static_cast<int>(i_end - i0) : kM;
  load_tile<kM>(Qs, ld, p.q + b * p.qb + h * p.qh + i0 * p.qs, p.qs, valid,
                p.D, W);
  load_tile<kM>(Gs, ld, p.g + b * p.gb + h * p.gh + i0 * p.gs, p.gs, valid,
                p.Dv, W);

  // the keys the block's rows can see
  const long long last = i0 + valid - 1;
  long long k_begin = 0, k_end = p.Sk;
  if (p.window > 0 && p.q_offset + i0 - p.window + 1 > 0)
    k_begin = p.q_offset + i0 - p.window + 1;
  if (p.causal && p.q_offset + last + 1 < k_end) k_end = p.q_offset + last + 1;
  if (valid == 0) k_end = k_begin;  // no row with a key
  const int t_begin = static_cast<int>(k_begin / kTile);
  const int t_end =
      k_end > k_begin ? static_cast<int>((k_end + kTile - 1) / kTile)
                      : t_begin;

  const bf16* kp = p.k + b * p.kb + kvh * p.kh;
  const bf16* vp = p.v + b * p.vb + kvh * p.vh;
  auto load_kv = [&](int t, int stage) {
    const long long k0 = static_cast<long long>(t) * kTile;
    const int vk = p.Sk - k0 < kTile ? static_cast<int>(p.Sk - k0) : kTile;
    load_tile<kTile>(Ks + stage * kTile * ld, ld, kp + k0 * p.ks, p.ks, vk,
                     p.D, W);
    load_tile<kTile>(Vs + stage * kTile * ld, ld, vp + k0 * p.vs, p.vs, vk,
                     p.Dv, W);
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
  const bf16* qa = Qs + (warp * 16 + gid) * ld + 2 * tig;
  const bf16* ga = Gs + (warp * 16 + gid) * ld + 2 * tig;
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
    const long long k0 = static_cast<long long>(t) * kTile;
    // a warp whose rows see no key of the tile adds nothing
    const bool skip = iw >= i_end || (p.causal && pos1 < k0) ||
                      (p.window > 0 && pos0 - (k0 + kTile - 1) >= p.window);
    if (!skip) {
      const bf16* Kt = Ks + stage * kTile * ld;
      const bf16* Vt = Vs + stage * kTile * ld;
      float s[kNS][4], dp[kNS][4];
      scores<kNS>(s, qa, Kt + gid * ld + 2 * tig, ld, p.D);
      scores<kNS>(dp, ga, Vt + gid * ld + 2 * tig, ld, p.Dv);
      // element e of tile n: row iw + gid + 8 (e / 2), key k0 + 8 n +
      // 2 tig + e % 2
      const bool unmasked = iw + 16 <= i_end && k0 + kTile <= p.Sk &&
                            (!p.causal || pos0 >= k0 + kTile - 1) &&
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
      uint32_t a[kNS / 2][4];
      as_a_operand<kNS>(dp, a);
      product_into<kNS / 2, kNT>(dq, a, Kt + c0, ld);  // dQ += dS K
    }
    __syncthreads();  // this stage is refilled by the next iteration
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long i = iw + gid + 8 * r;
    if (i >= p.Sq) continue;
    bf16* dqr = p.dq + ((b * p.Sq + i) * p.H + h) * p.D;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const int col = c0 + n * 8 + 2 * tig;
      if (col < p.D)
        *reinterpret_cast<uint32_t*>(dqr + col) =
            pack_bf16(dq[n][2 * r], dq[n][2 * r + 1]);
    }
  }
}

// column chunks of 8 kNT
template <int kNT>
cudaError_t launch(Params p, cudaStream_t st) {
  constexpr int kCW = 8 * kNT;
  const int width = p.D > p.Dv ? p.D : p.Dv;
  p.nchunk = (width + kCW - 1) / kCW;
  p.ld = p.nchunk * kCW + 8;  // 8 mod 32: conflict-free fragment reads
  const size_t ld = static_cast<size_t>(p.ld);
  const size_t smem_kv =
      sizeof(bf16) * (2 * kBK + 4 * kTile) * ld + sizeof(float) * 4 * kTile;
  const size_t smem_q = sizeof(bf16) * (2 * kM + 4 * kTile) * ld;
  auto* kv_kernel = dkdv_bf16_kernel<kNT>;
  auto* q_kernel = dq_bf16_kernel<kNT>;
  cudaError_t err = cudaFuncSetAttribute(
      kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_kv));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(q_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_q));
  if (err != cudaSuccess) return err;
  const long long rows_all = static_cast<long long>(p.B) * p.H * p.Sq;
  delta_bf16_kernel<<<static_cast<unsigned>(
                          (rows_all * 32 + kDeltaThreads - 1) / kDeltaThreads),
                      kDeltaThreads, 0, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 gkv(static_cast<unsigned>((p.Sk + kBK - 1) / kBK * p.nchunk), p.KH,
           p.B);
  kv_kernel<<<gkv, kThreads, smem_kv, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 gq(static_cast<unsigned>((p.Sq + kM - 1) / kM * p.nchunk), p.H, p.B);
  q_kernel<<<gq, kThreads, smem_q, st>>>(p);
  return cudaGetLastError();
}

// every row of q, k, v, O and dO starts 16-byte aligned
bool aligned16(const Params& p) {
  const uintptr_t ptrs =
      reinterpret_cast<uintptr_t>(p.q) | reinterpret_cast<uintptr_t>(p.k) |
      reinterpret_cast<uintptr_t>(p.v) | reinterpret_cast<uintptr_t>(p.o) |
      reinterpret_cast<uintptr_t>(p.g);
  const long long strides = p.qb | p.qs | p.qh | p.kb | p.ks | p.kh | p.vb |
                            p.vs | p.vh | p.ob | p.os | p.oh | p.gb | p.gs |
                            p.gh;
  return (ptrs & 15) == 0 && (strides & 7) == 0;
}

}  // namespace

extern "C" {

// bf16 q [B, Sq, H, D], k [B, Sk, KH, D], v [B, Sk, KH, Dv], o and dout
// [B, Sq, H, Dv] at element strides (last dim contiguous, 16-byte aligned);
// lse and delta [B, H, Sq] float32 contiguous; dq, dk, dv bf16, contiguous
// in the layouts of q, k, v.  nokey_from: the first query row that sees no
// key.
int repro_flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int H, int KH, int D, int Dv,
    long long qb, long long qs, long long qh, long long kb, long long ks,
    long long kh, long long vb, long long vs, long long vh, long long ob,
    long long os, long long oh, long long gb, long long gs, long long gh,
    int causal, int window, float cap, float scale, long long q_offset,
    long long nokey_from, void* stream) {
  if (D < 16 || D > 256 || D % 16 || Dv < 16 || Dv > 256 || Dv % 16 ||
      KH < 1 || H % KH != 0 || Sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Sq == 0) return 0;
  Params p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
           static_cast<const bf16*>(v), static_cast<const bf16*>(o),
           static_cast<const bf16*>(dout), lse, delta,
           static_cast<bf16*>(dq), static_cast<bf16*>(dk),
           static_cast<bf16*>(dv), B, Sq, Sk, H, KH, D, Dv,
           qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh, gb, gs, gh,
           causal, window, cap, scale, q_offset, nokey_from, 1, 0};
  if (!aligned16(p)) return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int width = D > Dv ? D : Dv;
  const cudaError_t err = width <= 64 ? launch<8>(p, st) : launch<16>(p, st);
  return static_cast<int>(err);
}

const char* repro_flash_bwd_bf16_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
