// Hopper (sm_90a) flash attention for bfloat16 on the tensor cores: the
// prefill's attention, over the model layout [B, S, H, D].
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas
// together with the epilogue of flash_attention/ops.py (acc / max(l, 1e-30),
// cast to q's dtype), for bfloat16 q/k/v.  float32 inputs go to the 3xTF32
// kernel of csrc/flash_attention.cu; kernels/flash_attention/kernel.py picks
// the kernel by dtype.  The contract is the float32 kernel's: GQA reads kv head
// h / (H / KH); q_offset places query row i at position q_offset + i; the
// scale comes before the tanh soft-cap; masked scores are -1e30 (a row that
// sees no key averages V), keys past Sk are -inf (p = 0); P is rounded to
// bf16 before the PV product while l sums the unrounded P; the output is
// acc / max(l, 1e-30) in bf16.
//
// Bound: operations, 4 * B * H * Sq * Sk' * D flops (Sk' the visible keys)
// against the tensor cores' bf16 rate (989 TFLOP/s); the bytes (Q, K, V and O
// once) are far below it at the prefill's shapes.  So both products run on
// the tensor cores through wgmma, fed from shared memory by TMA:
//
//   * one CTA of three warpgroups per (128-query tile, head, batch); the
//     grid walks the q tiles backwards, so on a causal mask the longest
//     tiles start first and the tail is short;
//   * warpgroup 2 is the producer: one thread loads the Q tile once, then
//     K and V tiles of BN keys into a ring of kStages stages by TMA, each
//     stage guarded by a "full" mbarrier (transaction bytes) and an "empty"
//     one (the 256 consumer threads); it gives its registers away
//     (setmaxnreg) to the consumers;
//   * warpgroups 0 and 1 each own 64 query rows.  S = Q K^T is
//     wgmma.m64n{BN}k16 with both operands in shared memory, K-major, over
//     the k16 steps of D's 64-column tiles.  The online softmax runs on the
//     accumulator fragment: a thread holds two rows, each row's max is a
//     shuffle within the quad of 4 threads that share it; m stays in f32
//     and l is kept per thread and summed over the quad at the end.  P goes
//     to bf16 in registers, where the accumulator fragment of 16 columns is
//     the A fragment of one k16 step, and O += P V is wgmma.m64n64k16 per 64
//     columns of Dv with P from registers and V from shared memory through
//     the descriptor's transpose bit (V is MN-major there: no transpose is
//     written);
//   * every tile is 64 bf16 wide (128 bytes, one 128-byte swizzle atom) in
//     shared memory, as TMA's SWIZZLE_128B writes it and as the wgmma
//     descriptors' 128-byte swizzle layout reads it.  D and Dv are multiples
//     of 16 up to 256: TMA fills the columns past them with zeros, which
//     add exact zeros to S and fill O's columns that are not stored.  The
//     kernel is instantiated per (BN, D tiles, Dv tiles), so every loop over
//     a tile is unrolled and the wgmma batches hold no other instructions;
//   * tiles with no key visible to any row of the CTA are skipped unless
//     some row sees no key at all (that row's answer, the mean of V, needs
//     every tile): exact, as in the float32 kernel.  The per-element mask runs
//     only on tiles that cross the diagonal, the window's edge or Sk;
//   * the epilogue divides by l and stores bf16 pairs straight from the
//     fragment; rows past Sq and columns past Dv are not stored.  The
//     training path's instantiation (template flag kLse, entry
//     repro_flash_attention_sm90_lse) also stores each row's logsumexp
//     L = m + log(l), one float32 a row, in the units the float32 kernel
//     writes and csrc/flash_attention_bwd_bf16.cu reads: the natural log of
//     the scaled, capped scores (m is kept in those units; only the
//     exponentials go through exp2f), +inf for a row that sees no key.
//     The serving instantiation (kLse false) holds none of it.
//
// Shared memory: a 128 x D tile of Q, and per stage BN x D of K and BN x Dv
// of V, each padded to whole 64-column tiles: 161 KB at D = Dv = 128 (BN
// 128), 193 KB at D = Dv = 256 (BN 64).
//
// The PTX wrappers and the host's TMA descriptors (cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint so that the library needs no
// -lcuda) live in csrc/sm90_wgmma.cuh, shared with the bf16 backward; the
// descriptors are passed as __grid_constant__ parameters.  The exported
// function has a plain C interface (raw device pointers, element strides,
// the caller's stream), launches on that stream, never synchronises and
// allocates nothing; it returns cudaGetLastError(), or a negative code when
// a descriptor cannot be built.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_wgmma.cuh"

namespace {

using namespace sm90;

constexpr int kBM = 128;                   // query rows per CTA
constexpr int kStages = 2;                 // K/V ring depth
constexpr int kConsumerThreads = 256;      // warpgroups 0 and 1
constexpr int kThreads = 384;              // + the producer warpgroup
constexpr int kTileBytes = 128;            // one 64-column bf16 row
constexpr int kMaxD = 256;
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  void* out;
  int Sq, Sk, H, KH, D, Dv;
  long long ob, os, oh;   // element strides of out (last dim contiguous)
  int causal;
  int window;             // 0: none
  float cap;              // 0: none
  float scale;
  long long q_offset;
  float* lse;             // [B, H, Sq] float32 (the kLse instantiation)
};

__device__ __forceinline__ bool row_sees_a_key(long long qpos,
                                               const Params& p) {
  long long lo = 0, hi = p.Sk - 1;
  if (p.causal && qpos < hi) hi = qpos;
  if (p.window > 0 && qpos - p.window + 1 > lo) lo = qpos - p.window + 1;
  return lo <= hi;
}

// BN: keys per K/V tile (128, or 64 when D or Dv is above 128); ND, NV: D
// in 64-column tiles and Dv rounded up to whole 64-column tiles; kLse: also
// store each row's logsumexp.
template <int BN, int ND, int NV, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const Params p) {
  constexpr int kNV = NV / 64;             // 64-column tiles of V and O
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];

  // swizzle atoms must start on 1024-byte boundaries
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_smem = base;
  const uint32_t kv_smem = base + ND * kBM * kTileBytes;
  const uint32_t k_bytes = ND * BN * kTileBytes;
  const uint32_t stage_bytes = k_bytes + kNV * BN * kTileBytes;
  const uint32_t q_bar = smem_addr(&bars[0]);
  const uint32_t full_bar = smem_addr(&bars[1]);              // + 8 s
  const uint32_t empty_bar = smem_addr(&bars[1 + kStages]);   // + 8 s

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;  // longest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KH);

  // the key tiles that hold a key visible to some row of the CTA
  const long long pos_first = p.q_offset + q0;
  const long long pos_last = p.q_offset + min(q0 + kBM, p.Sq) - 1;
  long long k_begin = 0, k_end = p.Sk;
  if (row_sees_a_key(pos_first, p) && row_sees_a_key(pos_last, p)) {
    if (p.causal && pos_last + 1 < k_end) k_end = pos_last + 1;
    if (p.window > 0 && pos_first - p.window + 1 > 0)
      k_begin = pos_first - p.window + 1;
  }
  const int t_begin = static_cast<int>(k_begin / BN);
  const int n_tiles = static_cast<int>((k_end + BN - 1) / BN) - t_begin;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    // ---- producer warpgroup: one thread starts every TMA load ----
    regs_dealloc<24>();
    if (threadIdx.x == kConsumerThreads) {
      mbar_expect_tx(q_bar, ND * kBM * kTileBytes);
      for (int c = 0; c < ND; ++c)
        tma_load(q_smem + c * kBM * kTileBytes, &tq, q_bar, c * 64, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        // the stage's previous tile has been consumed (passes at once on
        // the first round)
        mbar_wait(empty_bar + 8 * s, ((i / kStages) & 1) ^ 1);
        const uint32_t st = kv_smem + s * stage_bytes;
        const uint32_t bar = full_bar + 8 * s;
        const int k0 = (t_begin + i) * BN;
        mbar_expect_tx(bar, stage_bytes);
        for (int c = 0; c < ND; ++c)
          tma_load(st + c * BN * kTileBytes, &tk, bar, c * 64, kvh, k0, b);
        for (int c = 0; c < kNV; ++c)
          tma_load(st + k_bytes + c * BN * kTileBytes, &tv, bar, c * 64, kvh,
                   k0, b);
      }
    }
  } else {
    // ---- consumer warpgroups 0 and 1: 64 query rows each ----
    regs_alloc<240>();
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int row0 = wg * 64 + warp * 16 + lane / 4;   // and row0 + 8
    const int col0 = 2 * (lane % 4);
    const long long qpos0 = p.q_offset + q0 + row0;
    const long long qpos1 = qpos0 + 8;

    float s[BN / 2];               // S, then P, for rows row0 / row0 + 8
    float o[kNV][32];              // O per 64 columns of Dv
    uint32_t pa[BN / 16][4];       // P in bf16, one A fragment per k16 step
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) s[j] = 0.f;
#pragma unroll
    for (int c = 0; c < kNV; ++c)
#pragma unroll
      for (int j = 0; j < 32; ++j) o[c][j] = 0.f;
    float m0 = kMasked, m1 = kMasked, l0 = 0.f, l1 = 0.f;

    const uint32_t q_rows = q_smem + wg * 64 * kTileBytes;
    mbar_wait(q_bar, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kStages;
      mbar_wait(full_bar + 8 * st, (i / kStages) & 1);
      const uint32_t ks = kv_smem + st * stage_bytes;
      const uint32_t vs = ks + k_bytes;

      // S = Q K^T over 4 ND k16 steps (the zero columns past D add exact
      // zeros); a step moves 32 bytes along the row of its 64-column tile
      fence_operands(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * ND; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        wgmma_ss(s, smem_desc(q_rows + (kk >> 2) * kBM * kTileBytes + off, 1),
                 smem_desc(ks + (kk >> 2) * BN * kTileBytes + off, 1), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_operands(s);

      // scale, soft-cap and mask; register j holds column
      // 8 (j / 4) + col0 + (j % 2) of row row0 + 8 ((j / 2) % 2)
      const int k0 = (t_begin + i) * BN;
      const long long k_last = k0 + BN - 1;
      bool all_visible = k_last < p.Sk;
      if (p.causal) all_visible = all_visible && k_last <= pos_first;
      if (p.window > 0) all_visible = all_visible && pos_last - k0 < p.window;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) {
        float x = s[j] * p.scale;
        if (p.cap > 0.f) x = tanhf(x / p.cap) * p.cap;
        const bool upper = (j / 2) % 2;
        if (!all_visible) {
          const long long kpos = k0 + 8 * (j / 4) + col0 + (j % 2);
          const long long qpos = upper ? qpos1 : qpos0;
          bool visible = true;
          if (p.causal) visible = qpos >= kpos;
          if (p.window > 0) visible = visible && (qpos - kpos) < p.window;
          if (!visible) x = kMasked;
          if (kpos >= p.Sk) x = -INFINITY;   // padding past the keys: p = 0
        }
        s[j] = x;
        if (upper) mx1 = fmaxf(mx1, x); else mx0 = fmaxf(mx0, x);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      // differences first: a masked score minus a masked max is exactly 0
      const float alpha0 = exp2f((m0 - mn0) * kLog2e);
      const float alpha1 = exp2f((m1 - mn1) * kLog2e);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) {
        const bool upper = (j / 2) % 2;
        const float pj = exp2f((s[j] - (upper ? mn1 : mn0)) * kLog2e);
        if (upper) sum1 += pj; else sum0 += pj;
        s[j] = pj;
      }
      l0 = l0 * alpha0 + sum0;   // this thread's share of the row sum
      l1 = l1 * alpha1 + sum1;
#pragma unroll
      for (int c = 0; c < kNV; ++c)
#pragma unroll
        for (int j = 0; j < 32; ++j) o[c][j] *= ((j / 2) % 2) ? alpha1 : alpha0;
      // the accumulator of columns 16 t .. 16 t + 15 is the A fragment of
      // the t-th k16 step of P V
#pragma unroll
      for (int t = 0; t < BN / 16; ++t) {
        pa[t][0] = pack_bf16(s[8 * t + 0], s[8 * t + 1]);
        pa[t][1] = pack_bf16(s[8 * t + 2], s[8 * t + 3]);
        pa[t][2] = pack_bf16(s[8 * t + 4], s[8 * t + 5]);
        pa[t][3] = pack_bf16(s[8 * t + 6], s[8 * t + 7]);
      }

      // O += P V: a k16 step is 16 rows (2048 bytes) of each V tile
#pragma unroll
      for (int c = 0; c < kNV; ++c) fence_operands(o[c]);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < BN / 16; ++t)
#pragma unroll
        for (int c = 0; c < kNV; ++c)
          wgmma_rs(o[c], pa[t],
                   smem_desc(vs + c * BN * kTileBytes + t * 16 * kTileBytes,
                             1024 >> 4));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < kNV; ++c) fence_operands(o[c]);
      mbar_arrive(empty_bar + 8 * st);
    }

    // epilogue: the row sums over the quad, then acc / max(l, 1e-30) in bf16
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) + b * p.ob +
                         h * p.oh;
    const int qi0 = q0 + row0, qi1 = qi0 + 8;
#pragma unroll
    for (int c = 0; c < kNV; ++c)
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int col = c * 64 + 8 * t + col0;
        if (col >= p.Dv) continue;
        if (qi0 < p.Sq)
          *reinterpret_cast<uint32_t*>(out + qi0 * p.os + col) =
              pack_bf16(o[c][4 * t + 0] / den0, o[c][4 * t + 1] / den0);
        if (qi1 < p.Sq)
          *reinterpret_cast<uint32_t*>(out + qi1 * p.os + col) =
              pack_bf16(o[c][4 * t + 2] / den1, o[c][4 * t + 3] / den1);
      }
    if constexpr (kLse) {
      // the quad's four lanes hold the same m and l; lane col0 == 0 stores
      if (col0 == 0) {
        float* lse = p.lse + (static_cast<long long>(b) * p.H + h) * p.Sq;
        if (qi0 < p.Sq) lse[qi0] = m0 == kMasked ? INFINITY : m0 + logf(l0);
        if (qi1 < p.Sq) lse[qi1] = m1 == kMasked ? INFINITY : m1 + logf(l1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host: the launch
// ---------------------------------------------------------------------------

// what the launch needs besides the kernel's parameters
struct Launch {
  const CUtensorMap* tq;
  const void* k;
  const void* v;
  int B;
  long long kb, ks, kh, vb, vs, vh;
  const Params* p;
  cudaStream_t stream;
};

template <int BN, int ND, int NV, bool kLse>
int launch_one(const Launch& a) {
  const Params& p = *a.p;
  CUtensorMap tk, tv;
  int rc = make_map(&tk, a.k, p.D, p.KH, p.Sk, a.B, a.kh, a.ks, a.kb, BN);
  if (rc == 0)
    rc = make_map(&tv, a.v, p.Dv, p.KH, p.Sk, a.B, a.vh, a.vs, a.vb, BN);
  if (rc != 0) return rc;
  const size_t smem = 1024 + static_cast<size_t>(kTileBytes) *
      (ND * kBM + kStages * (ND + NV / 64) * BN);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_sm90_kernel<BN, ND, NV, kLse>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.Sq + kBM - 1) / kBM, p.H, a.B);
  flash_attention_sm90_kernel<BN, ND, NV, kLse>
      <<<grid, kThreads, smem, a.stream>>>(*a.tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

// the serving instantiation, or the one that stores the logsumexp
template <int BN, int ND, int NV>
int launch(const Launch& a) {
  return a.p->lse != nullptr ? launch_one<BN, ND, NV, true>(a)
                             : launch_one<BN, ND, NV, false>(a);
}

// K/V tiles of 128 keys where D and Dv fit two 64-column tiles each, else
// of 64 keys (shared memory and the consumers' registers)
template <int ND>
int launch_nd(const Launch& a) {
  const int nv = (a.p->Dv + 63) / 64;
  if constexpr (ND <= 2) {
    if (nv == 1) return launch<128, ND, 64>(a);
    if (nv == 2) return launch<128, ND, 128>(a);
  } else {
    if (nv == 1) return launch<64, ND, 64>(a);
    if (nv == 2) return launch<64, ND, 128>(a);
  }
  return nv == 3 ? launch<64, ND, 192>(a) : launch<64, ND, 256>(a);
}

}  // namespace

extern "C" {

// bf16 q [B, Sq, H, D], k [B, Sk, KH, D], v [B, Sk, KH, Dv], out
// [B, Sq, H, Dv]; strides in elements, the last dimension of each
// contiguous, the pointers and the other strides 16-byte aligned; D and Dv
// multiples of 16 up to 256.  Returns 0, a cudaError_t, or a negative code
// when a TMA descriptor cannot be built (repro_flash_sm90_error_string).
// lse: null, or [B, H, Sq] float32 contiguous (repro_flash_attention_sm90_lse).
int repro_flash_attention_sm90_lse(const void* q, const void* k,
                                   const void* v, void* out, int B, int Sq,
                                   int Sk, int H, int KH, int D, int Dv,
                                   long long qb, long long qs, long long qh,
                                   long long kb, long long ks, long long kh,
                                   long long vb, long long vs, long long vh,
                                   long long ob, long long os, long long oh,
                                   int causal, int window, float cap,
                                   float scale, long long q_offset,
                                   float* lse, void* stream) {
  if (D < 16 || D > kMaxD || D % 16 || Dv < 16 || Dv > kMaxD || Dv % 16 ||
      KH < 1 || H % KH != 0 || Sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Sq == 0) return 0;
  Params p{out, Sq, Sk, H, KH, D, Dv, ob, os, oh, causal, window, cap, scale,
           q_offset, lse};
  CUtensorMap tq;
  int rc = make_map(&tq, q, D, H, Sq, B, qh, qs, qb, kBM);
  if (rc != 0) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Launch args{&tq, k, v, B, kb, ks, kh, vb, vs, vh, &p, st};
  switch ((D + 63) / 64) {
    case 1: return launch_nd<1>(args);
    case 2: return launch_nd<2>(args);
    case 3: return launch_nd<3>(args);
    default: return launch_nd<4>(args);
  }
}

int repro_flash_attention_sm90(const void* q, const void* k, const void* v,
                               void* out, int B, int Sq, int Sk, int H,
                               int KH, int D, int Dv, long long qb,
                               long long qs, long long qh, long long kb,
                               long long ks, long long kh, long long vb,
                               long long vs, long long vh, long long ob,
                               long long os, long long oh, int causal,
                               int window, float cap, float scale,
                               long long q_offset, void* stream) {
  return repro_flash_attention_sm90_lse(q, k, v, out, B, Sq, Sk, H, KH, D, Dv,
                                        qb, qs, qh, kb, ks, kh, vb, vs, vh,
                                        ob, os, oh, causal, window, cap, scale,
                                        q_offset, nullptr, stream);
}

const char* repro_flash_sm90_error_string(int code) {
  return map_error_string(code);
}

}  // extern "C"
