// Hopper (sm_90a) kernel for the LM path's attention in float32:
// online-softmax ("flash") attention over the model layout [B, S, H, D],
// with both products on the tensor cores in the 3xTF32 split.  bfloat16
// inputs (the prefill's) go to the wgmma kernel of
// csrc/flash_attention_sm90.cu.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas
// together with the epilogue of flash_attention/ops.py (acc / max(l, 1e-30),
// cast to q's dtype), and serves the port's chunked_attention on the card.
// The TPU design keeps one (batch, head, q-block) output tile resident in
// VMEM while a sequential grid axis streams K/V blocks through it, and
// leaves the (acc, m, l) carry in its outputs.  On Hopper blocks run in
// parallel and in no order, so the stream over K/V is a loop inside the
// block, the carry lives in registers, and the division happens before the
// one store of the output.
//
// Precision: the 3xTF32 split of csrc/tf32_mma.cuh (a = tf32(a) + rest,
// three m16n8k8 TF32 products a term, relative error near 2^-21), whose
// helpers this kernel shares with the backward (csrc/flash_attention_bwd.cu).
//
// Why mma.sync and not wgmma: wgmma takes TF32 operands from shared memory
// K-major only, so P V would need V transposed in shared memory (or P
// staged through it), and the split would need both halves of K and V
// there too, twice the tile; mma.sync takes every fragment from registers,
// so K and V stay float32 in shared memory as they arrive and each warp
// splits the fragments it reads, and P goes from the score fragments into
// the P V product without leaving registers.
//
// One block per (tile of kM rows, kv head, batch); a row is one (query
// position, query head) pair, the G = H / KH query heads that share the kv
// head side by side, so a K/V tile in shared memory serves all of them (GQA
// without a repeat in memory; a decode step's G heads fill rows of one
// tile).  Each warp owns 16 rows:
//   * the Q tile comes in once, by cp.async, and stays in shared memory as
//     float32 (split per k-step: D = 256 would take 256 registers a thread
//     as split fragments);
//   * K/V tiles of kBK keys stream through a 2-stage shared-memory ring by
//     cp.async (16 bytes a copy where every pointer and stride allows it,
//     else 4): the next tile loads while this one is used;
//   * S = Q K^T per warp as 16 x kBK accumulators; the online softmax
//     (scale, then the tanh soft-cap, then the mask: masked scores -1e30,
//     keys past Sk -inf so that they never count) on the fragments, with
//     each row's max and sum over the four lanes that hold it;
//   * P V takes P from the score fragments as the A operand: the k order of
//     an m16n8k8 product is free, so lane slot k = tig holds key 2 tig and
//     k = tig + 4 key 2 tig + 1, matching the accumulator layout, and V's
//     fragment is read in the same order.  Each tile's P V starts from zero
//     and is added into O in float32 (O = alpha O + P V): the tensor core
//     truncates as it accumulates, and a running O would lose a few ulps of
//     its own size per product;
//   * the output row is acc / max(l, 1e-30); when the caller asks (the
//     training path, whose backward in csrc/flash_attention_bwd.cu
//     recomputes P from it), each row's logsumexp m + log(l) in the
//     kernel's units (scaled, capped scores) goes to lse [B, H, Sq], +inf
//     for a row with no visible key (m still -1e30), which the backward
//     reads as "no key".
// Tiles that are masked for every row of the block are skipped (causal: past
// the block's last query; window: before its first key) unless some row of
// the block has no visible key at all: such a row's answer (the mean of V
// over every key, as in the reference) needs every tile.  Tiles that every
// row sees in full skip the mask.  Causal blocks start longest first.
//
// Bound: operations -- 4 * B * H * Sq * Sk' * D flops (Sk' the visible keys),
// three times over at the TF32 tensor-core rate (494.7 TFLOP/s), or once at
// the CUDA cores' float32 rate (67 TFLOP/s), whichever is less.  Shared
// memory: (kM + 2 kBK) (D8 + 8) + 2 kBK (Dv8' + 4) floats (D8 is D rounded
// up to 8, Dv8' Dv rounded up to 32, 64, 128 or 256): 202 KB at D = Dv =
// 128 (kM 128, kBK 64), 197 KB at 256 (kM 64, kBK 32); one block per SM.
//
// The exported function has a plain C interface (raw device pointers,
// element strides, the caller's stream), launches on that stream, never
// synchronises and allocates nothing; it returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

using namespace tf32;

constexpr int kMaxD = 256;
constexpr float kMasked = -1e30f;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* out;
  int B, Sq, Sk, H, KH, D, Dv;
  long long qb, qs, qh;   // element strides of q (last dim contiguous)
  long long kb, ks, kh;
  long long vb, vs, vh;
  long long ob, os, oh;
  int causal;
  int window;             // 0: none
  float cap;              // 0: none
  float scale;
  long long q_offset;
  int vec16;              // every q, k, v row 16-byte aligned
  float* lse;             // [B, H, Sq] or null
};

__device__ __forceinline__ bool row_sees_a_key(long long qpos, const Params& p) {
  long long lo = 0, hi = p.Sk - 1;
  if (p.causal && qpos < hi) hi = qpos;
  if (p.window > 0 && qpos - p.window + 1 > lo) lo = qpos - p.window + 1;
  return lo <= hi;
}

// Row strides of the tiles in shared memory, in floats.  Q and K rows are
// read as float2 pairs (d = kk + 2 tig and + 1) by the 8 x 4 lanes of a
// fragment: a stride of 8 or 24 mod 32 puts the 16 lanes of each half-warp
// on distinct banks.  V is read a float at a time from rows 2 tig and
// 2 tig + 1: a stride of 4 mod 8 does the same.
__host__ __device__ inline int q_stride(int d8) {
  return d8 % 16 == 8 ? d8 : d8 + 8;
}

// The V tile's columns: kDvTiles 8-column tiles, zero past Dv.
template <int kDvTiles>
__host__ __device__ constexpr int v_stride() { return 8 * kDvTiles + 4; }

// kWarps warps of 16 rows; kBK keys per tile; kDvTiles the 8-column tiles
// of the output a warp holds (Dv8 / 8 rounded up to a power of two, so that
// no tile of P V sits behind a branch and the products of different tiles
// interleave)
template <int kWarps, int kBK, int kDvTiles>
__global__ void __launch_bounds__(kWarps * 32)
flash_attention_kernel(Params p) {
  constexpr int kThreads = kWarps * 32;
  constexpr int kM = 16 * kWarps;
  constexpr int kSTiles = kBK / 8;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D8 = (p.D + 7) & ~7;
  const int ldq = q_stride(D8);
  constexpr int ldv = v_stride<kDvTiles>();
  const bool vec16 = p.vec16 != 0;
  float* Qs = smem;                           // [kM][ldq]
  float* Ks = Qs + kM * ldq;                  // [2][kBK][ldq]
  float* Vs = Ks + 2 * kBK * ldq;             // [2][kBK][ldv]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int G = p.H / p.KH;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const long long bx = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const long long rows = static_cast<long long>(p.Sq) * G;
  const long long f0 = bx * kM;

  // the Q tile: row r is query position (f0 + r) / G of head kvh G + (f0 +
  // r) % G
  {
    const int vec = vec16 ? 4 : 1;
    const int per_row = D8 / vec;
    for (int i = tid; i < kM * per_row; i += kThreads) {
      const int r = i / per_row, c = (i - r * per_row) * vec;
      const long long f = f0 + r;
      const bool ok = f < rows && c < p.D;
      const long long qi = f / G;
      const long long h = static_cast<long long>(kvh) * G + (f - qi * G);
      const float* src =
          ok ? p.q + b * p.qb + qi * p.qs + h * p.qh + c : p.q;
      cp_async(Qs + r * ldq + c, src, ok, vec16);
    }
  }

  // the tiles that hold a key visible to some row of the block
  const long long f_last = (f0 + kM < rows ? f0 + kM : rows) - 1;
  const long long pos_first = p.q_offset + f0 / G;
  const long long pos_last = p.q_offset + f_last / G;
  long long k_begin = 0, k_end = p.Sk;
  if (row_sees_a_key(pos_first, p) && row_sees_a_key(pos_last, p)) {
    if (p.causal && pos_last + 1 < k_end) k_end = pos_last + 1;
    if (p.window > 0 && pos_first - p.window + 1 > 0)
      k_begin = pos_first - p.window + 1;
  }
  const int t_begin = static_cast<int>(k_begin / kBK);
  const int t_end = static_cast<int>((k_end + kBK - 1) / kBK);

  const float* kp = p.k + b * p.kb + kvh * p.kh;
  const float* vp = p.v + b * p.vb + kvh * p.vh;
  auto load_kv = [&](int t, int stage) {
    const int k0 = t * kBK;
    const int valid = p.Sk - k0 < kBK ? p.Sk - k0 : kBK;
    load_slab<kThreads>(Ks + stage * kBK * ldq, ldq, kp + k0 * p.ks, p.ks,
                        kBK, valid, p.D, D8, vec16);
    load_slab<kThreads>(Vs + stage * kBK * ldv, ldv, vp + k0 * p.vs, p.vs,
                        kBK, valid, p.Dv, 8 * kDvTiles, vec16);
  };
  if (t_begin < t_end) load_kv(t_begin, 0);
  cp_async_commit();

  // this thread's two rows: gid and gid + 8 of its warp's 16
  long long qpos[2];
  bool valid_row[2];
  long long qi_row[2], h_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long f = f0 + warp * 16 + gid + 8 * r;
    valid_row[r] = f < rows;
    qi_row[r] = f / G;
    h_row[r] = static_cast<long long>(kvh) * G + (f - qi_row[r] * G);
    qpos[r] = p.q_offset + qi_row[r];
  }
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  float o[kDvTiles][4];
#pragma unroll
  for (int n = 0; n < kDvTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  const float* qa = Qs + (warp * 16 + gid) * ldq + 2 * tig;

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
    const float* Kt = Ks + stage * kBK * ldq;
    const float* Vt = Vs + stage * kBK * ldv;

    // S = Q K^T: 16 x kBK per warp
    float s[kSTiles][4];
#pragma unroll
    for (int n = 0; n < kSTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    // the k order inside a k-step is free: lane slot k = tig takes
    // d = kk + 2 tig and k = tig + 4 takes d = kk + 2 tig + 1, in Q and K
    // alike, so each fragment pair is one float2 load
    for (int kk = 0; kk < D8; kk += 8) {
      const float2 q0 = *reinterpret_cast<const float2*>(qa + kk);
      const float2 q1 = *reinterpret_cast<const float2*>(qa + kk + 8 * ldq);
      uint32_t ah[4], al[4];
      split(q0.x, ah[0], al[0]);
      split(q1.x, ah[1], al[1]);
      split(q0.y, ah[2], al[2]);
      split(q1.y, ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < kSTiles; ++n) {
        const float2 kv = *reinterpret_cast<const float2*>(
            Kt + (n * 8 + gid) * ldq + kk + 2 * tig);
        uint32_t bh[2], bl[2];
        split(kv.x, bh[0], bl[0]);
        split(kv.y, bh[1], bl[1]);
        mma_3xtf32(s[n], ah, al, bh, bl);
      }
    }

    // the online softmax on the fragments: element e of tile n is row
    // gid + 8 (e / 2), key k0 + 8 n + 2 tig + e % 2
    // (a tile every key of which every row of the block sees, and that
    // ends before Sk, needs no mask)
    const long long k0 = static_cast<long long>(t) * kBK;
    const bool unmasked = k0 + kBK <= p.Sk &&
                          (!p.causal || k0 + kBK - 1 <= pos_first) &&
                          (p.window <= 0 || pos_last - k0 < p.window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kSTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float x = s[n][e] * p.scale;
        if (p.cap > 0.f) x = tanhf(x / p.cap) * p.cap;
        if (!unmasked) {
          const long long kpos = k0 + n * 8 + 2 * tig + (e & 1);
          bool visible = true;
          if (p.causal) visible = visible && qpos[r] >= kpos;
          if (p.window > 0) visible = visible && (qpos[r] - kpos) < p.window;
          if (!visible) x = kMasked;
          if (kpos >= p.Sk) x = -INFINITY;  // padding past the keys: p = 0
        }
        s[n][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < kSTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        s[n][e] = expf(s[n][e] - m[r]);
        sum[r] += s[n][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * alpha[r] + sum[r];
    }
    // O = alpha O + P V.  Each 8-column tile of this P V starts from zero
    // and is added into O in float32 afterwards: the tensor core truncates
    // as it accumulates, so a running O taken through every K/V tile would
    // lose a few ulps of its own size per product (about 1e-5 at S 4096).
    // P's 8-key k-steps are S's 8-key tiles.
    uint32_t ph[kSTiles][4], pl[kSTiles][4];
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
      split(s[j][0], ph[j][0], pl[j][0]);  // row gid, key 2 tig
      split(s[j][2], ph[j][1], pl[j][1]);  // row gid + 8, key 2 tig
      split(s[j][1], ph[j][2], pl[j][2]);  // row gid, key 2 tig + 1
      split(s[j][3], ph[j][3], pl[j][3]);  // row gid + 8, key 2 tig + 1
    }
    const float* vr = Vt + 2 * tig * ldv + gid;
#pragma unroll
    for (int n = 0; n < kDvTiles; ++n) {
      float pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
        uint32_t bh[2], bl[2];
        split(vr[j * 8 * ldv + n * 8], bh[0], bl[0]);
        split(vr[j * 8 * ldv + n * 8 + ldv], bh[1], bl[1]);
        mma_3xtf32(pv, ph[j], pl[j], bh, bl);
      }
      o[n][0] = fmaf(o[n][0], alpha[0], pv[0]);
      o[n][1] = fmaf(o[n][1], alpha[0], pv[1]);
      o[n][2] = fmaf(o[n][2], alpha[1], pv[2]);
      o[n][3] = fmaf(o[n][3], alpha[1], pv[3]);
    }
    __syncthreads();  // this stage is refilled by the next iteration
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!valid_row[r]) continue;
    float* op = p.out + b * p.ob + qi_row[r] * p.os + h_row[r] * p.oh;
    const float den = fmaxf(l[r], 1e-30f);
    if (p.lse != nullptr && tig == 0)  // the four lanes of a row agree
      p.lse[(b * p.H + h_row[r]) * p.Sq + qi_row[r]] =
          m[r] == kMasked ? INFINITY : m[r] + logf(l[r]);
#pragma unroll
    for (int n = 0; n < kDvTiles; ++n) {
      const int col = n * 8 + 2 * tig;
      if (col < p.Dv) op[col] = o[n][2 * r] / den;
      if (col + 1 < p.Dv) op[col + 1] = o[n][2 * r + 1] / den;
    }
  }
}

template <int kWarps, int kBK, int kDvTiles>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int kM = 16 * kWarps;
  const int d8 = (p.D + 7) & ~7;
  const size_t smem = sizeof(float) *
      ((kM + 2 * kBK) * static_cast<size_t>(q_stride(d8)) +
       2 * kBK * static_cast<size_t>(v_stride<kDvTiles>()));
  auto* kernel = flash_attention_kernel<kWarps, kBK, kDvTiles>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(p.Sq) * (p.H / p.KH);
  dim3 grid(static_cast<unsigned>((rows + kM - 1) / kM), p.KH, p.B);
  kernel<<<grid, kWarps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

// 8 warps of 16 rows and 64-key tiles up to D, Dv 128; 4 warps and 32-key
// tiles above (the tiles' shared memory), Dv's tiles in powers of two
cudaError_t launch_for(const Params& p, cudaStream_t stream) {
  const int dvt = ((p.Dv + 7) & ~7) / 8;
  if (p.D <= 128 && p.Dv <= 128) {
    if (dvt <= 4) return launch<8, 64, 4>(p, stream);
    if (dvt <= 8) return launch<8, 64, 8>(p, stream);
    return launch<8, 64, 16>(p, stream);
  }
  if (dvt <= 4) return launch<4, 32, 4>(p, stream);
  if (dvt <= 8) return launch<4, 32, 8>(p, stream);
  if (dvt <= 16) return launch<4, 32, 16>(p, stream);
  return launch<4, 32, 32>(p, stream);
}

// 16-byte copies need every row of q, k and v to start 16-byte aligned
bool aligned16(const Params& p) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(p.q) |
                         reinterpret_cast<uintptr_t>(p.k) |
                         reinterpret_cast<uintptr_t>(p.v);
  const long long strides = p.qb | p.qs | p.qh | p.kb | p.ks | p.kh | p.vb |
                            p.vs | p.vh | p.D | p.Dv;
  return (ptrs & 15) == 0 && (strides & 3) == 0;
}

}  // namespace

extern "C" {

// float32 q, k, v and out.  Strides are in elements; the last dimension of
// every tensor is contiguous.  lse: null, or [B, H, Sq] float32 contiguous
// (repro_flash_attention_lse).
int repro_flash_attention_lse(const float* q, const float* k, const float* v,
                              float* out, int B, int Sq, int Sk, int H,
                              int KH, int D, int Dv, long long qb,
                              long long qs, long long qh, long long kb,
                              long long ks, long long kh, long long vb,
                              long long vs, long long vh, long long ob,
                              long long os, long long oh, int causal,
                              int window, float cap, float scale,
                              long long q_offset, float* lse, void* stream) {
  if (D < 1 || D > kMaxD || Dv < 1 || Dv > kMaxD || KH < 1 || H % KH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Sq == 0) return 0;
  Params p{q, k, v, out, B, Sq, Sk, H, KH, D, Dv, qb, qs, qh, kb, ks, kh,
           vb, vs, vh, ob, os, oh, causal, window, cap, scale, q_offset, 0,
           lse};
  p.vec16 = aligned16(p) ? 1 : 0;
  return static_cast<int>(launch_for(p, static_cast<cudaStream_t>(stream)));
}

int repro_flash_attention(const float* q, const float* k, const float* v,
                          float* out, int B, int Sq, int Sk, int H,
                          int KH, int D, int Dv, long long qb, long long qs,
                          long long qh, long long kb, long long ks,
                          long long kh, long long vb, long long vs,
                          long long vh, long long ob, long long os,
                          long long oh, int causal, int window, float cap,
                          float scale, long long q_offset, void* stream) {
  return repro_flash_attention_lse(q, k, v, out, B, Sq, Sk, H, KH, D, Dv, qb,
                                   qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh,
                                   causal, window, cap, scale, q_offset,
                                   nullptr, stream);
}

const char* repro_flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
