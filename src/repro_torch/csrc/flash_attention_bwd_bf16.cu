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
// backward: P recomputed from the saved L, never stored), in two passes:
//   1. delta_bf16_kernel: delta_i = sum_d dO_id O_id in float32, one warp a
//      row.
//   2. dkdv_bf16_kernel: one block per (key tile of kBK = 128 keys, kv
//      head, batch).  K and V of the tile stay in shared memory; the block
//      walks the G query heads of its group and, for each, the query tiles
//      of BQ rows that can see the tile, which stream in with their L and
//      delta.  Each consumer warpgroup owns 64 keys: S^T = K Q^T and
//      dP^T = V dO^T are accumulators with keys as rows; it applies the
//      mask, P^T = exp(S' - L) (S' the scaled, capped score), dS^T = P^T
//      (dP^T - delta) (1 - tanh^2) scale, and feeds them as the A operand
//      of dV += P^T dO and dK += dS^T Q without leaving registers.  The GQA
//      group's G heads are summed in the block, so no atomics: the same
//      bits on every run.
//   3. dq_bf16_kernel: one block per (query tile of kBM = 128 rows, head,
//      batch), each consumer warpgroup 64 rows, Q and dO in shared memory;
//      the key tiles of kBN = 64 keys that its rows can see stream in; S
//      and dP are recomputed and dS feeds dQ += dS K from the accumulators.
//      With a causal mask the grid walks the query tiles backwards, so the
//      longest blocks start first (the dK/dV pass's longest, key tile 0,
//      come first in grid order).
// A row with no visible key (window past every key) keeps the forward's
// convention, the mean of V over all Sk keys: the forward writes L = +inf
// for it, so P = 0 in both passes (dq = 0, no dk), and the dK/dV pass adds
// the rows' dO / Sk into every key's dv.  Such rows are the suffix
// i >= nokey_from, which the wrapper computes.
//
// Bound: operations -- five products of the visible (query, key) pairs
// (S, dP, dv, dk, dq; the forward has two), 2.5 times the forward's flops,
// at the tensor cores' bf16 rate; the dq pass recomputes S and dP, so this
// design does seven (a one-pass dQ needs atomics, whose order changes the
// bits, or gigabytes of per-key-tile partials).  So every product runs on
// the tensor cores through wgmma, fed by TMA, on the forward's skeleton
// (csrc/sm90_wgmma.cuh holds the shared wrappers):
//   * three warpgroups a block.  Warpgroup 2 produces: one thread loads the
//     block's resident tiles once, then the streamed tiles into a ring of
//     up to four stages, each guarded by a "full" mbarrier (transaction
//     bytes) and an "empty" one (the 256 consumer threads); in the dK/dV
//     pass its next warp copies each stage's L and delta into shared
//     memory by cp.async (L's rows are not 16-byte aligned for a bulk
//     copy), each lane's arrival on the same "full" barrier waiting for its
//     copies, so that the warp never waits for their latency.  It gives its
//     registers away (setmaxnreg 24) to the consumers (240);
//   * every tile is 64 bf16 columns wide with the 128-byte swizzle; D and Dv
//     are multiples of 16 up to 256, TMA fills the columns past them, and
//     rows past Sq or Sk, with zeros;
//   * each product has the form of one of the forward's two: the score
//     products S^T = K Q^T, dP^T = V dO^T (dK/dV) and S = Q K^T, dP = dO
//     V^T (dQ) are wgmma_ss, both operands K-major, as the forward's Q K^T;
//     the gradient products dV += P^T dO, dK += dS^T Q and dQ += dS K are
//     wgmma_rs per 64 output columns, A from the score accumulator rounded
//     to bf16 (its 16 columns of a k16 step are the A fragment), B the
//     streamed row-major tile read MN-major through the descriptor's
//     transpose bit, as the forward reads V.  No transpose is written.
//   * Registers: a warpgroup's 64 x N float32 accumulator costs N / 2
//     registers a thread.  At D = Dv = 128, dK and dV take 128 and S^T,
//     dP^T over a 64-query tile 64: 192 of the consumers' 240.  At MLA's
//     D 192 / Dv 128 dK and dV take 160, so its instantiation streams
//     32-query tiles (wgmma m64n32k16 for S^T and dP^T, 32 registers):
//     192 again, and no score is recomputed.  Other widths above 128 cut
//     the outputs into chunks of two 64-column tiles of dK and of dV, one
//     block each, each recomputing S^T and dP^T (D = Dv = 256: two).  The
//     dQ pass holds all of dq (NQ tiles, up to 128 registers at D 256)
//     with 64-key tiles (64 registers of S and dP).
//   * Shared memory (227 KB a block): the dK/dV pass holds 128 x (D + Dv)
//     of K and V, the dQ pass 128 x (D + Dv) of Q and dO, and the ring as
//     many stages of 64 (dK/dV at MLA's widths: 32) x (D + Dv) as fit, up
//     to four: at D = Dv = 128 both passes 192 KB in four stages; at MLA's
//     widths 160 KB in four and 200 KB in three; at D = Dv = 256 one.
//   * Kept from the mma.sync design it replaces: causal and window tile
//     skipping (per block, then per warpgroup), the per-element mask only
//     on tiles that cross the diagonal, the window's edge, Sq or Sk, L and
//     delta read per column of S^T from shared memory, the GQA group summed
//     in one block in a fixed order.  The softmax's loops are templates
//     on the cap and the mask, chosen per tile outside the loop: as
//     predicated code in the loop they would cost every element a tanhf
//     and the mask's tests.
//     P = __expf(x - L).  P and dS are
//     rounded to bf16 only as operands of the dV, dK and dQ products, as
//     the forward rounds P before its PV product; the scores, the softmax
//     and every sum stay float32 until the one bf16 store of each gradient
//     row.
//   * Overlap inside a warpgroup: it issues S^T and dP^T as two wgmma
//     batches and computes P^T while dP^T runs, then issues dV += P^T dO
//     and computes dS^T while that runs, then dK += dS^T Q (the dQ pass: P
//     while dP runs, then dQ += dS K); across its two warpgroups one's
//     elementwise work overlaps the other's products.
//   * Instantiations: Phi's D = Dv = 128 and MLA's 192/128 have their own,
//     whose loops over the 64-column tiles are unrolled exactly; other
//     widths take general ones whose loops run to four tiles with a guard.
//
// The exported function has a plain C interface (raw device pointers,
// element strides, the caller's stream), launches the three kernels on that
// stream, never synchronises and allocates nothing: the wrapper allocates
// delta [B, H, Sq] and the contiguous outputs.  Pointers and strides of
// q, k, v, O and dO must be 16-byte aligned (TMA's rule), D and Dv
// multiples of 16, as the bf16 forward requires.  It returns
// cudaGetLastError(), or a negative code when a TMA descriptor cannot be
// built (repro_flash_bwd_bf16_error_string).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>
#include <stdlib.h>

#include "sm90_wgmma.cuh"

namespace {

using namespace sm90;

typedef __nv_bfloat16 bf16;

constexpr int kDeltaThreads = 256;
constexpr int kConsumerThreads = 256;     // warpgroups 0 and 1
constexpr int kThreads = 384;             // + the producer warpgroup
constexpr int kBK = 128;                  // keys a dK/dV block
constexpr int kBM = 128;                  // query rows a dQ block
constexpr int kBN = 64;                   // keys a streamed dQ-pass tile
constexpr int kTileBytes = 128;           // one 64-column bf16 row
constexpr int kMaxTiles = 4;              // 64-column tiles of D or Dv
constexpr int kMaxStages = 4;
constexpr int kSmemLimit = 232448;        // bytes a block can use

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
  int q_offset;
  int nokey_from;         // rows >= this see no key (Sq: none do)
  int nd, nv;             // D and Dv in 64-column tiles
  int nchunk;             // column chunks of dk and dv, one block each
  int stages;             // depth of the ring (1 to kMaxStages)
};

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

// 4 bytes from global to shared memory by cp.async, zeros when !ok
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// one arrival on the mbarrier once this thread's cp.async copies are done
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool visible(const Params& p, int qpos, int key) {
  if (key >= p.Sk) return false;
  if (p.causal && qpos < key) return false;
  if (p.window > 0 && qpos - key >= p.window) return false;
  return true;
}

// P = exp(x - L) of a raw score s (x its scaled, capped value; 0 where
// kMask and not ok), and into dfac the factor of dS besides P and dP -
// delta: the scale times the cap's derivative (1 - tanh^2).  kCap and kMask
// are template flags so that a tile without a cap or a mask runs neither
// (as predicated code they would cost every element).
template <bool kCap, bool kMask>
__device__ __forceinline__ float prob(const Params& p, float s, float L,
                                      bool ok, float& dfac) {
  float x = s * p.scale;
  dfac = p.scale;
  if (kCap) {
    const float t = tanhf(x / p.cap);
    x = t * p.cap;
    dfac = (1.f - t * t) * p.scale;
  }
  const float P = __expf(x - L);
  return kMask && !ok ? 0.f : P;
}

// c = A B^T over the 64-column tiles of the reduced axis, exactly NT of
// them, or with kAny the first n of kMaxTiles: A the warpgroup's 64 rows of
// a resident tile set (a, tiles a_stride bytes apart), B the rows of a
// streamed one (b, tiles b_stride bytes apart); a k16 step moves 32 bytes
// along the rows of its 64-column tile
template <int NT, bool kAny, int N>
__device__ __forceinline__ void scores(float (&c)[N], uint32_t a,
                                       uint32_t a_stride, uint32_t b,
                                       uint32_t b_stride, int n) {
#pragma unroll
  for (int t = 0; t < (kAny ? kMaxTiles : NT); ++t) {
    if (!kAny || t < n) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(c, smem_desc(a + t * a_stride + kk * 32, 1),
                 smem_desc(b + t * b_stride + kk * 32, 1), t > 0 || kk > 0);
    }
  }
}

// the accumulator's columns 16 t .. 16 t + 15, rounded to bf16, are the A
// fragment of the t-th k16 step of a product that reduces over them
template <int N>
__device__ __forceinline__ void as_a_operand(const float (&c)[N],
                                             uint32_t (&a)[N / 8][4]) {
#pragma unroll
  for (int t = 0; t < N / 8; ++t) {
    a[t][0] = pack_bf16(c[8 * t + 0], c[8 * t + 1]);
    a[t][1] = pack_bf16(c[8 * t + 2], c[8 * t + 3]);
    a[t][2] = pack_bf16(c[8 * t + 4], c[8 * t + 5]);
    a[t][3] = pack_bf16(c[8 * t + 6], c[8 * t + 7]);
  }
}

// acc += A B for the KS k16 steps of a (rows of B) and one 64-column tile
// of B at b, row-major, 16 rows (2048 bytes) a step, read MN-major
template <int KS>
__device__ __forceinline__ void product_into(float (&acc)[32],
                                             const uint32_t (&a)[KS][4],
                                             uint32_t b) {
#pragma unroll
  for (int t = 0; t < KS; ++t)
    wgmma_rs(acc, a[t], smem_desc(b + t * 16 * kTileBytes, 1024 >> 4));
}

// The dK/dV pass's P^T for a streamed tile: register j of st (key key0 +
// 8 ((j / 2) % 2), query column 8 (j / 4) + col0 + (j % 2) of the tile
// whose first row is i0) becomes P^T times dS's factor, and pa the bf16 A
// fragments of P^T; L holds the tile's logsumexp per column
template <bool kCap, bool kMask, int N>
__device__ __forceinline__ void probs_t(const Params& p, float (&st)[N],
                                        uint32_t (&pa)[N / 8][4],
                                        const float* L, int i0, int i_end,
                                        int pos0, int key0, int col0) {
#pragma unroll
  for (int u = 0; u < N / 8; ++u) {
    float pr[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int j = 8 * u + e;
      const int col = 8 * (j / 4) + col0 + (j % 2);
      const bool ok = !kMask ||
          (i0 + col < i_end &&
           visible(p, pos0 + col, key0 + 8 * ((j / 2) % 2)));
      float dfac;
      pr[e] = prob<kCap, kMask>(p, st[j], L[col], ok, dfac);
      st[j] = pr[e] * dfac;
    }
    pa[u][0] = pack_bf16(pr[0], pr[1]);
    pa[u][1] = pack_bf16(pr[2], pr[3]);
    pa[u][2] = pack_bf16(pr[4], pr[5]);
    pa[u][3] = pack_bf16(pr[6], pr[7]);
  }
}

// The dQ pass's P for a streamed tile: register j of sc (row row0 + 8 ((j /
// 2) % 2), key kt0 + 8 (j / 4) + col0 + (j % 2)) becomes P times dS's
// factor; L holds the thread's two rows' logsumexp
template <bool kCap, bool kMask, int N>
__device__ __forceinline__ void probs(const Params& p, float (&sc)[N],
                                      const float (&L)[2], int row0,
                                      int i_end, int kt0, int col0) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int r = (j / 2) % 2;
    const bool ok = !kMask ||
        (row0 + 8 * r < i_end &&
         visible(p, p.q_offset + row0 + 8 * r,
                 kt0 + 8 * (j / 4) + col0 + (j % 2)));
    float dfac;
    const float P = prob<kCap, kMask>(p, sc[j], L[r], ok, dfac);
    sc[j] = P * dfac;
  }
}

// The dK/dV pass for the 128 keys of a block, streaming BQ-row tiles of Q
// and dO.  Without kAny, D and Dv are exactly NK and NV 64-column tiles and
// the block holds all of dk and dv; with kAny, D and Dv take up to
// kMaxTiles tiles each, and chunk c of the block's column holds dk's tiles
// [NK c, NK c + NK) and dv's [NV c, NV c + NV).  Maps: tq, tg boxes of BQ
// rows; tk, tv of kBK rows.
template <int NK, int NV, int BQ, bool kAny>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tg, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kMaxStages];
  __shared__ float Ls[kMaxStages][BQ], Ds[kMaxStages][BQ];
  __shared__ float nokey[NV * 64];
  const int nd = kAny ? p.nd : NK, nv = kAny ? p.nv : NV;

  // swizzle atoms must start on 1024-byte boundaries
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_smem = base;                        // nd tiles of kBK rows
  const uint32_t v_smem = k_smem + nd * kBK * kTileBytes;
  const uint32_t ring = v_smem + nv * kBK * kTileBytes;
  const uint32_t q_bytes = nd * BQ * kTileBytes;
  const uint32_t stage_bytes = q_bytes + nv * BQ * kTileBytes;
  const uint32_t kv_bar = smem_addr(&bars[0]);
  const uint32_t full_bar = smem_addr(&bars[1]);                 // + 8 s
  const uint32_t empty_bar = smem_addr(&bars[1 + kMaxStages]);   // + 8 s

  const int tile = blockIdx.x / p.nchunk;
  const int chunk = blockIdx.x - tile * p.nchunk;
  const int kc = chunk * NK, vc = chunk * NV;   // first dk / dv tile held
  const int k0 = tile * kBK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = p.H / p.KH;
  const int k_end = k0 + kBK < p.Sk ? k0 + kBK : p.Sk;

  // the query rows that can see a key of [k0, k_end), short of the rows
  // that see none
  int i_begin = 0, i_end = p.nokey_from;
  if (p.causal && k0 - p.q_offset > i_begin) i_begin = k0 - p.q_offset;
  if (p.window > 0 && k_end - 1 + p.window - p.q_offset < i_end)
    i_end = k_end - 1 + p.window - p.q_offset;
  if (i_end > p.Sq) i_end = p.Sq;
  const int nq = i_end > i_begin ? (i_end - i_begin + BQ - 1) / BQ : 0;
  const int T = G * nq;  // (head, query tile) steps, heads outer

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < kMaxStages; ++s) {
      mbar_init(full_bar + 8 * s, 1 + 32);   // TMA + the L/delta warp
      mbar_init(empty_bar + 8 * s, kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    // ---- producer warpgroup ----
    regs_dealloc<24>();
    const int pt = threadIdx.x - kConsumerThreads;
    if (pt == 0) {
      // one thread starts every TMA load
      mbar_expect_tx(kv_bar, (nd + nv) * kBK * kTileBytes);
      for (int c = 0; c < nd; ++c)
        tma_load(k_smem + c * kBK * kTileBytes, &tk, kv_bar, c * 64, kvh, k0,
                 b);
      for (int c = 0; c < nv; ++c)
        tma_load(v_smem + c * kBK * kTileBytes, &tv, kv_bar, c * 64, kvh, k0,
                 b);
      for (int t = 0; t < T; ++t) {
        const int s = t % p.stages;
        // the stage's previous tile has been consumed (passes at once on
        // the first round)
        mbar_wait(empty_bar + 8 * s, ((t / p.stages) & 1) ^ 1);
        const int gi = t / nq;
        const int i0 = i_begin + (t - gi * nq) * BQ;
        const int h = kvh * G + gi;
        const uint32_t st = ring + s * stage_bytes;
        const uint32_t bar = full_bar + 8 * s;
        mbar_expect_tx(bar, stage_bytes);
        for (int c = 0; c < nd; ++c)
          tma_load(st + c * BQ * kTileBytes, &tq, bar, c * 64, h, i0, b);
        for (int c = 0; c < nv; ++c)
          tma_load(st + q_bytes + c * BQ * kTileBytes, &tg, bar, c * 64, h,
                   i0, b);
      }
    } else if (pt >= 32 && pt < 64) {
      // one warp copies each stage's L and delta (zeros past Sq) by
      // cp.async, whose completion each lane's arrival on the stage's
      // "full" barrier waits for: the warp goes on to the next stage
      // without waiting for the copies
      const int lane = pt - 32;
      for (int t = 0; t < T; ++t) {
        const int s = t % p.stages;
        mbar_wait(empty_bar + 8 * s, ((t / p.stages) & 1) ^ 1);
        const int gi = t / nq;
        const int i0 = i_begin + (t - gi * nq) * BQ;
        const long long at =
            (static_cast<long long>(b) * p.H + kvh * G + gi) * p.Sq + i0;
        for (int r = lane; r < BQ; r += 32) {
          const bool ok = i0 + r < p.Sq;
          cp_async4(&Ls[s][r], p.lse + (ok ? at + r : 0), ok);
          cp_async4(&Ds[s][r], p.delta + (ok ? at + r : 0), ok);
        }
        cp_async_arrive(full_bar + 8 * s);
      }
    }
    return;
  }

  // ---- consumer warpgroups 0 and 1: 64 keys each ----
  regs_alloc<240>();
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int col0 = 2 * (lane % 4);
  const int kw = k0 + wg * 64;                 // the warpgroup's keys
  const int key0 = kw + warp * 16 + lane / 4;  // and key0 + 8
  // register j of a score accumulator: key key0 + 8 ((j / 2) % 2), query
  // column 8 (j / 4) + col0 + (j % 2) of the tile

  float dk[NK][32], dv[NV][32];
#pragma unroll
  for (int c = 0; c < NK; ++c)
#pragma unroll
    for (int j = 0; j < 32; ++j) dk[c][j] = 0.f;
#pragma unroll
  for (int c = 0; c < NV; ++c)
#pragma unroll
    for (int j = 0; j < 32; ++j) dv[c][j] = 0.f;

  const uint32_t k_rows = k_smem + wg * 64 * kTileBytes;
  const uint32_t v_rows = v_smem + wg * 64 * kTileBytes;
  mbar_wait(kv_bar, 0);
  for (int t = 0; t < T; ++t) {
    const int s = t % p.stages;
    mbar_wait(full_bar + 8 * s, (t / p.stages) & 1);
    const int gi = t / nq;
    const int i0 = i_begin + (t - gi * nq) * BQ;
    const int pos0 = p.q_offset + i0;  // the tile's first query
    const int pos1 = pos0 + BQ - 1;    // its last
    // a warpgroup whose 64 keys no query of the tile sees adds nothing
    const bool skip = kw >= p.Sk || (p.causal && pos1 < kw) ||
                      (p.window > 0 && pos0 - (kw + 63) >= p.window);
    if (!skip) {
      const uint32_t qs = ring + s * stage_bytes;
      const uint32_t gs = qs + q_bytes;
      // S^T and dP^T as two batches: P^T is computed while dP^T runs
      float st[BQ / 2], dpt[BQ / 2];
      fence_operands(st);
      fence_operands(dpt);
      wgmma_fence();
      scores<NK, kAny>(st, k_rows, kBK * kTileBytes, qs, BQ * kTileBytes, nd);
      wgmma_commit();
      scores<NV, kAny>(dpt, v_rows, kBK * kTileBytes, gs, BQ * kTileBytes,
                       nv);
      wgmma_commit();
      wgmma_wait<1>();
      fence_operands(st);

      // a tile every query of which sees every key of the warpgroup needs
      // no mask
      const bool unmasked = i0 + BQ <= i_end && kw + 64 <= p.Sk &&
                            (!p.causal || pos0 >= kw + 63) &&
                            (p.window <= 0 || pos1 - kw < p.window);
      // P^T in bf16 as dV's A operand; st keeps P^T times dS's factor
      uint32_t pa[BQ / 16][4];
      const float* Lt = Ls[s];
      if (p.cap > 0.f) {
        if (unmasked)
          probs_t<true, false>(p, st, pa, Lt, i0, i_end, pos0, key0, col0);
        else
          probs_t<true, true>(p, st, pa, Lt, i0, i_end, pos0, key0, col0);
      } else {
        if (unmasked)
          probs_t<false, false>(p, st, pa, Lt, i0, i_end, pos0, key0, col0);
        else
          probs_t<false, true>(p, st, pa, Lt, i0, i_end, pos0, key0, col0);
      }

      // dV += P^T dO, which runs while dS^T is computed
#pragma unroll
      for (int c = 0; c < NV; ++c) fence_operands(dv[c]);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < NV; ++c)
        if (!kAny || vc + c < nv)
          product_into(dv[c], pa, gs + (vc + c) * BQ * kTileBytes);
      wgmma_commit();
      wgmma_wait<1>();   // dP^T is in
      fence_operands(dpt);
#pragma unroll
      for (int j = 0; j < BQ / 2; ++j)
        dpt[j] = st[j] * (dpt[j] - Ds[s][8 * (j / 4) + col0 + (j % 2)]);
      uint32_t da[BQ / 16][4];
      as_a_operand(dpt, da);

      // dK += dS^T Q
#pragma unroll
      for (int c = 0; c < NK; ++c) fence_operands(dk[c]);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < NK; ++c)
        if (!kAny || kc + c < nd)
          product_into(dk[c], da, qs + (kc + c) * BQ * kTileBytes);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < NV; ++c) fence_operands(dv[c]);
#pragma unroll
      for (int c = 0; c < NK; ++c) fence_operands(dk[c]);
    }
    mbar_arrive(empty_bar + 8 * s);
  }

  // rows that see no key: out = mean of V over all keys, so each key's dv
  // takes their dO / Sk
  if (p.nokey_from < p.Sq && vc < nv) {
    for (int e = threadIdx.x; e < NV * 64; e += kConsumerThreads) {
      const int col = vc * 64 + e;
      float sum = 0.f;
      if (col < p.Dv)
        for (int gi = 0; gi < G; ++gi) {
          const bf16* g = p.g + b * p.gb +
                          static_cast<long long>(kvh * G + gi) * p.gh + col;
          for (int i = p.nokey_from; i < p.Sq; ++i)
            sum += __bfloat162float(g[i * p.gs]);
        }
      nokey[e] = sum / static_cast<float>(p.Sk);
    }
    asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumerThreads) : "memory");
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int j = 0; j < 32; ++j)
        dv[c][j] += nokey[c * 64 + 8 * (j / 4) + col0 + (j % 2)];
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= p.Sk) continue;
    bf16* dkr = p.dk + ((static_cast<long long>(b) * p.Sk + key) * p.KH + kvh)
                       * p.D;
    bf16* dvr = p.dv + ((static_cast<long long>(b) * p.Sk + key) * p.KH + kvh)
                       * p.Dv;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
#pragma unroll
      for (int c = 0; c < NK; ++c) {
        const int col = (kc + c) * 64 + 8 * t + col0;  // even; D mult. of 16
        if (col < p.D)
          *reinterpret_cast<uint32_t*>(dkr + col) =
              pack_bf16(dk[c][4 * t + 2 * r], dk[c][4 * t + 2 * r + 1]);
      }
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const int col = (vc + c) * 64 + 8 * t + col0;
        if (col < p.Dv)
          *reinterpret_cast<uint32_t*>(dvr + col) =
              pack_bf16(dv[c][4 * t + 2 * r], dv[c][4 * t + 2 * r + 1]);
      }
    }
  }
}

// The dQ pass: all of dq for the 128 query rows of a block, streaming
// kBN-key tiles of K and V.  Without kAny, D and Dv are exactly NQ and NV
// 64-column tiles; with kAny, up to NQ and NV.  Maps: tq, tg boxes of kBM
// rows; tk, tv of kBN rows.
template <int NQ, int NV, bool kAny>
__global__ void __launch_bounds__(kThreads, 1)
dq_bf16_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tg, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kMaxStages];
  const int nd = kAny ? p.nd : NQ, nv = kAny ? p.nv : NV;

  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_smem = base;                        // nd tiles of kBM rows
  const uint32_t g_smem = q_smem + nd * kBM * kTileBytes;
  const uint32_t ring = g_smem + nv * kBM * kTileBytes;
  const uint32_t k_bytes = nd * kBN * kTileBytes;
  const uint32_t stage_bytes = k_bytes + nv * kBN * kTileBytes;
  const uint32_t qg_bar = smem_addr(&bars[0]);
  const uint32_t full_bar = smem_addr(&bars[1]);                 // + 8 s
  const uint32_t empty_bar = smem_addr(&bars[1 + kMaxStages]);   // + 8 s

  int tile = blockIdx.x;
  if (p.causal) tile = gridDim.x - 1 - tile;  // the longest blocks first
  const int i0 = tile * kBM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KH);
  // rows past nokey_from have P = 0 everywhere: their dq is zero
  const int i_end = p.nokey_from < p.Sq ? p.nokey_from : p.Sq;
  const int valid = i_end - i0 <= 0 ? 0 : i_end - i0 < kBM ? i_end - i0 : kBM;

  // the keys the block's rows can see
  const int last = i0 + valid - 1;
  int k_begin = 0, k_end = p.Sk;
  if (p.window > 0 && p.q_offset + i0 - p.window + 1 > 0)
    k_begin = p.q_offset + i0 - p.window + 1;
  if (p.causal && p.q_offset + last + 1 < k_end) k_end = p.q_offset + last + 1;
  if (valid == 0) k_end = k_begin;  // no row with a key
  const int t_begin = k_begin / kBN;
  const int n_tiles =
      k_end > k_begin ? (k_end + kBN - 1) / kBN - t_begin : 0;

  if (threadIdx.x == 0) {
    mbar_init(qg_bar, 1);
    for (int s = 0; s < kMaxStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    // ---- producer warpgroup: one thread starts every TMA load ----
    regs_dealloc<24>();
    if (threadIdx.x == kConsumerThreads && n_tiles > 0) {
      mbar_expect_tx(qg_bar, (nd + nv) * kBM * kTileBytes);
      for (int c = 0; c < nd; ++c)
        tma_load(q_smem + c * kBM * kTileBytes, &tq, qg_bar, c * 64, h, i0,
                 b);
      for (int c = 0; c < nv; ++c)
        tma_load(g_smem + c * kBM * kTileBytes, &tg, qg_bar, c * 64, h, i0,
                 b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % p.stages;
        mbar_wait(empty_bar + 8 * s, ((i / p.stages) & 1) ^ 1);
        const int kt0 = (t_begin + i) * kBN;
        const uint32_t st = ring + s * stage_bytes;
        const uint32_t bar = full_bar + 8 * s;
        mbar_expect_tx(bar, stage_bytes);
        for (int c = 0; c < nd; ++c)
          tma_load(st + c * kBN * kTileBytes, &tk, bar, c * 64, kvh, kt0, b);
        for (int c = 0; c < nv; ++c)
          tma_load(st + k_bytes + c * kBN * kTileBytes, &tv, bar, c * 64, kvh,
                   kt0, b);
      }
    }
    return;
  }

  // ---- consumer warpgroups 0 and 1: 64 query rows each ----
  regs_alloc<240>();
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int col0 = 2 * (lane % 4);
  const int iw = i0 + wg * 64;                  // the warpgroup's rows
  const int row0 = iw + warp * 16 + lane / 4;   // and row0 + 8
  const int pos0 = p.q_offset + iw, pos1 = pos0 + 63;
  // register j of a score accumulator: row row0 + 8 ((j / 2) % 2), key
  // 8 (j / 4) + col0 + (j % 2) of the tile
  float L[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + 8 * r;
    const long long at = (static_cast<long long>(b) * p.H + h) * p.Sq + i;
    L[r] = i < i_end ? p.lse[at] : 0.f;
    dl[r] = i < i_end ? p.delta[at] : 0.f;
  }
  float dq[NQ][32];
#pragma unroll
  for (int c = 0; c < NQ; ++c)
#pragma unroll
    for (int j = 0; j < 32; ++j) dq[c][j] = 0.f;

  const uint32_t q_rows = q_smem + wg * 64 * kTileBytes;
  const uint32_t g_rows = g_smem + wg * 64 * kTileBytes;
  if (n_tiles > 0) mbar_wait(qg_bar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % p.stages;
    mbar_wait(full_bar + 8 * s, (i / p.stages) & 1);
    const int kt0 = (t_begin + i) * kBN;
    // a warpgroup whose rows see no key of the tile adds nothing
    const bool skip = iw >= i_end || (p.causal && pos1 < kt0) ||
                      (p.window > 0 && pos0 - (kt0 + kBN - 1) >= p.window);
    if (!skip) {
      const uint32_t ks = ring + s * stage_bytes;
      const uint32_t vs = ks + k_bytes;
      // S and dP as two batches: P is computed while dP runs
      float sc[kBN / 2], dp[kBN / 2];
      fence_operands(sc);
      fence_operands(dp);
      wgmma_fence();
      scores<NQ, kAny>(sc, q_rows, kBM * kTileBytes, ks, kBN * kTileBytes,
                       nd);
      wgmma_commit();
      scores<NV, kAny>(dp, g_rows, kBM * kTileBytes, vs, kBN * kTileBytes,
                       nv);
      wgmma_commit();
      wgmma_wait<1>();
      fence_operands(sc);

      const bool unmasked = iw + 64 <= i_end && kt0 + kBN <= p.Sk &&
                            (!p.causal || pos0 >= kt0 + kBN - 1) &&
                            (p.window <= 0 || pos1 - kt0 < p.window);
      // sc keeps P times dS's factor, computed while dP runs
      if (p.cap > 0.f) {
        if (unmasked) probs<true, false>(p, sc, L, row0, i_end, kt0, col0);
        else probs<true, true>(p, sc, L, row0, i_end, kt0, col0);
      } else {
        if (unmasked) probs<false, false>(p, sc, L, row0, i_end, kt0, col0);
        else probs<false, true>(p, sc, L, row0, i_end, kt0, col0);
      }
      wgmma_wait_all();   // dP is in
      fence_operands(dp);
#pragma unroll
      for (int j = 0; j < kBN / 2; ++j)
        dp[j] = sc[j] * (dp[j] - dl[(j / 2) % 2]);
      uint32_t da[kBN / 16][4];
      as_a_operand(dp, da);

      // dQ += dS K
#pragma unroll
      for (int c = 0; c < NQ; ++c) fence_operands(dq[c]);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < NQ; ++c)
        if (!kAny || c < nd) product_into(dq[c], da, ks + c * kBN * kTileBytes);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < NQ; ++c) fence_operands(dq[c]);
    }
    mbar_arrive(empty_bar + 8 * s);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + 8 * r;
    if (i >= p.Sq) continue;
    bf16* dqr = p.dq + ((static_cast<long long>(b) * p.Sq + i) * p.H + h) * p.D;
#pragma unroll
    for (int c = 0; c < NQ; ++c)
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int col = c * 64 + 8 * t + col0;
        if (col < p.D)
          *reinterpret_cast<uint32_t*>(dqr + col) =
              pack_bf16(dq[c][4 * t + 2 * r], dq[c][4 * t + 2 * r + 1]);
      }
  }
}

// ---------------------------------------------------------------------------
// Host: TMA descriptors and the launches
// ---------------------------------------------------------------------------

// the four maps of a pass: q and dO in boxes of q_rows rows, k and v of
// k_rows
struct Maps {
  CUtensorMap q, k, v, g;
};

int make_maps(Maps* m, const Params& p, int q_rows, int k_rows) {
  int rc = make_map(&m->q, p.q, p.D, p.H, p.Sq, p.B, p.qh, p.qs, p.qb, q_rows);
  if (rc == 0)
    rc = make_map(&m->g, p.g, p.Dv, p.H, p.Sq, p.B, p.gh, p.gs, p.gb, q_rows);
  if (rc == 0)
    rc = make_map(&m->k, p.k, p.D, p.KH, p.Sk, p.B, p.kh, p.ks, p.kb, k_rows);
  if (rc == 0)
    rc = make_map(&m->v, p.v, p.Dv, p.KH, p.Sk, p.B, p.vh, p.vs, p.vb, k_rows);
  return rc;
}

// dynamic shared memory of a pass that holds `resident` rows and streams
// `streamed` rows a stage, each (nd + nv) tiles wide, with as many stages
// (up to kMaxStages) as fit beside the kernel's static shared memory
size_t ring_smem(const Params& p, int resident, int streamed,
                 size_t static_bytes, int* stages) {
  const size_t row = static_cast<size_t>(p.nd + p.nv) * kTileBytes;
  const size_t fixed = 1024 + resident * row;  // + the 1024-byte alignment
  int n = kMaxStages;
  while (n > 1 && fixed + n * streamed * row + static_bytes > kSmemLimit) --n;
  *stages = n;
  return fixed + n * streamed * row;
}

template <int NK, int NV, int BQ, bool kAny>
int launch_dkdv(Params p, cudaStream_t st) {
  Maps m;
  int rc = make_maps(&m, p, BQ, kBK);
  if (rc != 0) return rc;
  const int ck = (p.nd + NK - 1) / NK, cv = (p.nv + NV - 1) / NV;
  p.nchunk = ck > cv ? ck : cv;
  auto* kernel = dkdv_bf16_kernel<NK, NV, BQ, kAny>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = ring_smem(p, kBK, BQ, attr.sharedSizeBytes, &p.stages);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(static_cast<unsigned>((p.Sk + kBK - 1) / kBK * p.nchunk), p.KH,
            p.B);
  kernel<<<grid, kThreads, smem, st>>>(m.q, m.k, m.v, m.g, p);
  return static_cast<int>(cudaGetLastError());
}

template <int NQ, int NV, bool kAny>
int launch_dq(Params p, cudaStream_t st) {
  Maps m;
  int rc = make_maps(&m, p, kBM, kBN);
  if (rc != 0) return rc;
  auto* kernel = dq_bf16_kernel<NQ, NV, kAny>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = ring_smem(p, kBM, kBN, attr.sharedSizeBytes, &p.stages);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(static_cast<unsigned>((p.Sq + kBM - 1) / kBM), p.H, p.B);
  kernel<<<grid, kThreads, smem, st>>>(m.q, m.k, m.v, m.g, p);
  return static_cast<int>(cudaGetLastError());
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
      KH < 1 || H % KH != 0 || Sk < 1 ||
      llabs(q_offset) + Sq + Sk > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Sq == 0) return 0;
  Params p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
           static_cast<const bf16*>(v), static_cast<const bf16*>(o),
           static_cast<const bf16*>(dout), lse, delta,
           static_cast<bf16*>(dq), static_cast<bf16*>(dk),
           static_cast<bf16*>(dv), B, Sq, Sk, H, KH, D, Dv,
           qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh, gb, gs, gh,
           causal, window, cap, scale, static_cast<int>(q_offset),
           static_cast<int>(nokey_from), (D + 63) / 64, (Dv + 63) / 64, 1, 1};
  if (!aligned16(p)) return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rows_all = static_cast<long long>(B) * H * Sq;
  delta_bf16_kernel<<<static_cast<unsigned>(
                          (rows_all * 32 + kDeltaThreads - 1) / kDeltaThreads),
                      kDeltaThreads, 0, st>>>(p);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  // Phi's D = Dv = 128 and MLA's 192/128 have their own instantiations;
  // other widths take the general ones (dk and dv in chunks of two
  // 64-column tiles each)
  if (p.nd == 2 && p.nv == 2)
    rc = launch_dkdv<2, 2, 64, false>(p, st);
  else if (p.nd == 3 && p.nv == 2)
    rc = launch_dkdv<3, 2, 32, false>(p, st);
  else
    rc = launch_dkdv<2, 2, 64, true>(p, st);
  if (rc != 0) return rc;
  if (p.nd == 2 && p.nv == 2) return launch_dq<2, 2, false>(p, st);
  if (p.nd == 3 && p.nv == 2) return launch_dq<3, 2, false>(p, st);
  return launch_dq<4, 4, true>(p, st);
}

const char* repro_flash_bwd_bf16_error_string(int code) {
  return map_error_string(code);
}

}  // extern "C"
