// The 3xTF32 split on mma.sync.m16n8k8 and the cp.async tile loads that
// the float32 attention kernels share: csrc/flash_attention.cu (the
// forward) and csrc/flash_attention_bwd.cu (the backward) include it.
//
// Precision.  One TF32 product keeps 11 bits of each operand (relative
// error near 2^-11), far from the reference's float32 tolerance.  Each
// float32 operand a is split into a_hi = tf32(a) (rounded to nearest) and
// a_lo = a - a_hi, and a * b is taken as a_lo b_hi + a_hi b_lo + a_hi b_hi,
// three mma.sync.m16n8k8 TF32 products accumulated in float32 (the small
// terms first).  The tensor core reads a_lo's top 19 bits, so each product
// keeps about 21 bits (relative error near 2^-21, against float32's 2^-24).
// The tensor core truncates as it accumulates, so a sum taken through many
// products loses a few ulps of its own size per product: a kernel that
// sums over a long axis takes each tile's partial product from zero and
// adds it into its running sum in float32.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32 {

// a = hi + lo: hi is a rounded to TF32, to nearest with ties away from
// zero (as cvt.rna.tf32.f32 rounds a finite a), by adding half of the 13
// dropped bits and clearing them: integer instructions at the full rate,
// where the conversion runs on a slower pipe; lo keeps the rest, of which
// the tensor core reads the top 19 bits
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi));
}

// a = hi + lo with hi truncated to TF32 (its 13 low bits cleared): one
// integer instruction fewer than split, so one pipe less busy; lo = a - hi
// is exact and smaller than 2^-10 |a| (2^-11 after rounding), so a product
// keeps about 20 bits instead of 21.  The backward, whose loops are bound
// by the splits' integer instructions, takes it.
__device__ __forceinline__ void split_rz(float a, uint32_t& hi,
                                         uint32_t& lo) {
  hi = __float_as_uint(a) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32, the small terms first
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

// 16 bytes (or 4) from global to shared memory by cp.async, zeros when !ok
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool ok, bool vec16) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (vec16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(ok ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(ok ? 4 : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// rows [0, nrows) of a [rows, width] slab with row stride gstride into
// shared memory of row stride ld, widths padded to wpad with zeros and
// rows past valid_rows zero; 16-byte copies when vec16, else 4
template <int kThreads>
__device__ __forceinline__ void load_slab(float* dst, int ld, const float* g,
                                          long long gstride, int nrows,
                                          int valid_rows, int width,
                                          int wpad, bool vec16) {
  const int vec = vec16 ? 4 : 1;
  const int per_row = wpad / vec;
  for (int i = threadIdx.x; i < nrows * per_row; i += kThreads) {
    const int r = i / per_row, c = (i - r * per_row) * vec;
    const bool ok = r < valid_rows && c < width;
    cp_async(dst + r * ld + c, ok ? g + r * gstride + c : g, ok, vec16);
  }
}

}  // namespace tf32
