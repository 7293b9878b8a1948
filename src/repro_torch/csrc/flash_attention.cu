// Hopper (sm_90a) kernel for the LM path's attention in float32:
// online-softmax ("flash") attention over the model layout [B, S, H, D].
// bfloat16 inputs (the prefill's) go to the tensor-core kernel of
// csrc/flash_attention_sm90.cu; this one keeps float32 at the reference's
// float32 tolerance, which TF32 tensor cores would not hold.
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
// One block of 256 threads per (q tile of 32 rows, head, batch):
//   * the Q tile is read once into shared memory; GQA reads the K/V of kv
//     head h / G, with no repeat in memory;
//   * K/V tiles of 64 keys stream through shared memory;
//   * 8 threads own one query row: each computes 8 of the tile's 64 scores
//     (dot over D in float32), applies the scale, then the tanh soft-cap,
//     then the mask (masked scores are -1e30, keys past Sk are -inf so that
//     they never count); the row's max and sum are shuffles among the 8;
//   * running (m, l) per row and the row's Dv accumulators (Dv / 8 per
//     thread) stay in registers;
//   * the output row is acc / max(l, 1e-30).
// Tiles that are masked for every row of the block are skipped (causal: past
// the block's last query; window: before its first key) unless some row of
// the block has no visible key at all: such a row's answer (the mean of V
// over every key, as in the reference) needs every tile.  A skipped tile
// changes nothing: after a visible score, a fully masked tile has p = 0 and
// alpha = 1 exactly, and before one, its contributions are scaled by
// alpha = exp(-1e30 - m) = 0.
//
// Bound: operations -- 4 * B * H * Sq * Sk' * D flops (Sk' the visible keys)
// against the CUDA cores' float32 rate (67 TFLOP/s); bytes are Q, K, V and O
// once.  The products are float32 FMAs out of shared memory.  Shared memory:
// (32 (D+1) + 64 (D+1) + 64 Dv + 32 * 65) * 4 bytes, 172 KB at D = Dv = 256,
// set above 48 KB through cudaFuncAttributeMaxDynamicSharedMemorySize.
//
// The exported function has a plain C interface (raw device pointers,
// element strides, the caller's stream), launches on that stream, never
// synchronises and allocates nothing; it returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 32;                    // query rows per block
constexpr int kBK = 64;                    // keys per tile
constexpr int kThreads = 256;
constexpr int kLanes = kThreads / kBQ;     // threads per query row: 8
constexpr int kCols = kBK / kLanes;        // scores per thread per tile: 8
constexpr int kMaxD = 256;
constexpr float kMasked = -1e30f;
static_assert(kLanes == 8, "the row shuffles below assume 8 lanes per row");

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
};

__device__ __forceinline__ bool row_sees_a_key(long long qpos, const Params& p) {
  long long lo = 0, hi = p.Sk - 1;
  if (p.causal && qpos < hi) hi = qpos;
  if (p.window > 0 && qpos - p.window + 1 > lo) lo = qpos - p.window + 1;
  return lo <= hi;
}

// kDvLane: the most accumulators a thread holds (Dv / 8 rounded up): 16 for
// Dv <= 128, 32 for Dv <= 256.
template <int kDvLane>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(Params p) {
  extern __shared__ float smem[];
  const int D = p.D, Dv = p.Dv;
  const int ldq = D + 1;                  // padded rows: no bank conflicts
  float* Qs = smem;                       // [kBQ][D + 1]
  float* Ks = Qs + kBQ * ldq;             // [kBK][D + 1]
  float* Vs = Ks + kBK * ldq;             // [kBK][Dv]
  float* Ps = Vs + kBK * Dv;              // [kBQ][kBK + 1]

  const int tid = threadIdx.x;
  const int r = tid / kLanes;             // this thread's query row
  const int lane = tid % kLanes;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KH);

  const float* qp = p.q + b * p.qb + h * p.qh;
  const float* kp = p.k + b * p.kb + kvh * p.kh;
  const float* vp = p.v + b * p.vb + kvh * p.vh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int row = i / D, d = i % D;
    const int qi = q0 + row;
    Qs[row * ldq + d] = qi < p.Sq ? qp[qi * p.qs + d] : 0.f;
  }

  // the tiles that hold a key visible to some row of the block
  const int q_last = min(q0 + kBQ, p.Sq) - 1;
  const long long pos_first = p.q_offset + q0;
  const long long pos_last = p.q_offset + q_last;
  long long k_begin = 0, k_end = p.Sk;
  if (row_sees_a_key(pos_first, p) && row_sees_a_key(pos_last, p)) {
    if (p.causal && pos_last + 1 < k_end) k_end = pos_last + 1;
    if (p.window > 0 && pos_first - p.window + 1 > 0)
      k_begin = pos_first - p.window + 1;
  }
  const int t_begin = static_cast<int>(k_begin / kBK);
  const int t_end = static_cast<int>((k_end + kBK - 1) / kBK);

  const long long qpos = p.q_offset + q0 + r;
  float m = kMasked, l = 0.f;
  float acc[kDvLane];
#pragma unroll
  for (int i = 0; i < kDvLane; ++i) acc[i] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int row = i / D, d = i % D;
      const int kj = k0 + row;
      Ks[row * ldq + d] = kj < p.Sk ? kp[kj * p.ks + d] : 0.f;
    }
    for (int i = tid; i < kBK * Dv; i += kThreads) {
      const int row = i / Dv, d = i % Dv;
      const int kj = k0 + row;
      Vs[row * Dv + d] = kj < p.Sk ? vp[kj * p.vs + d] : 0.f;
    }
    __syncthreads();

    float s[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[j] = 0.f;
    const float* qrow = Qs + r * ldq;
    for (int d = 0; d < D; ++d) {
      const float qv = qrow[d];
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        s[j] = fmaf(qv, Ks[(lane + kLanes * j) * ldq + d], s[j]);
    }
    float row_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const long long kpos = k0 + lane + kLanes * j;
      float x = s[j] * p.scale;
      if (p.cap > 0.f) x = tanhf(x / p.cap) * p.cap;
      bool visible = true;
      if (p.causal) visible = visible && qpos >= kpos;
      if (p.window > 0) visible = visible && (qpos - kpos) < p.window;
      if (!visible) x = kMasked;
      if (kpos >= p.Sk) x = -INFINITY;   // padding past the keys: p = 0
      s[j] = x;
      row_max = fmaxf(row_max, x);
    }
#pragma unroll
    for (int off = 1; off < kLanes; off <<= 1)
      row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
    const float m_new = fmaxf(m, row_max);
    const float alpha = expf(m - m_new);
    float row_sum = 0.f;
    float* prow = Ps + r * (kBK + 1);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float pj = expf(s[j] - m_new);
      row_sum += pj;
      prow[lane + kLanes * j] = pj;
    }
#pragma unroll
    for (int off = 1; off < kLanes; off <<= 1)
      row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
    l = l * alpha + row_sum;
    m = m_new;
    __syncwarp();  // the row's 8 lanes share one warp

#pragma unroll
    for (int i = 0; i < kDvLane; ++i) acc[i] *= alpha;
    const int kn = min(kBK, p.Sk - k0);
    for (int c = 0; c < kn; ++c) {
      const float pc = prow[c];
      const float* vrow = Vs + c * Dv;
#pragma unroll
      for (int i = 0; i < kDvLane; ++i) {
        const int d = lane + kLanes * i;
        if (d < Dv) acc[i] = fmaf(pc, vrow[d], acc[i]);
      }
    }
  }

  const int qi = q0 + r;
  if (qi < p.Sq) {
    float* op = p.out + b * p.ob + qi * p.os + h * p.oh;
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < kDvLane; ++i) {
      const int d = lane + kLanes * i;
      if (d < Dv) op[d] = acc[i] / den;
    }
  }
}

template <int kDvLane>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(kBQ) * (p.D + 1) + static_cast<size_t>(kBK) * (p.D + 1) +
       static_cast<size_t>(kBK) * p.Dv + static_cast<size_t>(kBQ) * (kBK + 1));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<kDvLane>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dim3 grid((p.Sq + kBQ - 1) / kBQ, p.H, p.B);
  flash_attention_kernel<kDvLane><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// float32 q, k, v and out.  Strides are in elements; the last dimension of
// every tensor is contiguous.
int repro_flash_attention(const float* q, const float* k, const float* v,
                          float* out, int B, int Sq, int Sk, int H,
                          int KH, int D, int Dv, long long qb, long long qs,
                          long long qh, long long kb, long long ks,
                          long long kh, long long vb, long long vs,
                          long long vh, long long ob, long long os,
                          long long oh, int causal, int window, float cap,
                          float scale, long long q_offset, void* stream) {
  if (D < 1 || D > kMaxD || Dv < 1 || Dv > kMaxD || KH < 1 || H % KH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Sq == 0) return 0;
  Params p{q, k, v, out, B, Sq, Sk, H, KH, D, Dv, qb, qs, qh, kb, ks, kh,
           vb, vs, vh, ob, os, oh, causal, window, cap, scale, q_offset};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(Dv <= 128 ? launch<16>(p, st) : launch<32>(p, st));
}

const char* repro_flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
