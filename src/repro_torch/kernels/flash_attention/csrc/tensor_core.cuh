// tensor_core.cuh: the warp-level tensor-core and asynchronous-copy
// primitives that flash_attention (K4) and ssd_scan (K5) share, as inline
// PTX for sm_80 and later (sm_90a here).
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16" and
// "mma.m16n8k8"); lane = 4 g + t, g = lane / 4, t = lane % 4:
//   bf16 m16n8k16  A (16 x 16, row): a0 (g, 2t..2t+1), a1 (g+8, 2t..),
//                                   a2 (g, 2t+8..), a3 (g+8, 2t+8..)
//                  B (16 x 8, col): b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g)
//   tf32 m16n8k8   A (16 x 8, row): a0 (g, t), a1 (g+8, t), a2 (g, t+4),
//                                   a3 (g+8, t+4)
//                  B (8 x 8, col):  b0 (k t, n g), b1 (k t+4, n g)
//   both           C (16 x 8, f32): c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t),
//                                   c3 (g+8, 2t+1)
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; zero-filled when
// !pred (src is then not read, but must be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [0, rows) x columns [0, cols) of a strided slice (row stride lds
// elements) into a [rows_pad][cols_pad] shared-memory tile with row stride
// ldd, zero elsewhere; NT threads, thread tid.  With vec (16-byte aligned
// rows, cols a multiple of 16 bytes) by cp.async, 16 bytes a copy, which the
// caller commits and waits for; else element by element.  cols_pad and ldd
// are multiples of 16 bytes.
template <int NT, typename E>
__device__ __forceinline__ void stage(E* dst, int ldd, const E* src,
                                      long long lds, int rows, int cols,
                                      int rows_pad, int cols_pad, bool vec,
                                      int tid) {
  constexpr int V = 16 / sizeof(E);
  const int cpr = cols_pad / V;
  for (int i = tid; i < rows_pad * cpr; i += NT) {
    const int r = i / cpr, c = (i % cpr) * V;
    E* dp = dst + r * ldd + c;
    const E* sp = src + r * lds + c;
    if (vec) {
      const bool ok = r < rows && c < cols;
      cp_async16(dp, ok ? sp : src, ok);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        dp[e] = (r < rows && c + e < cols) ? sp[e] : E(0.f);
    }
  }
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b, bf16 operands, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b, tf32 operands (float32 bit patterns rounded by to_tf32, or
// values that are exact in tf32, such as widened bf16), f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// float32 -> tf32, rounded to nearest (ties away), as a 32-bit pattern
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// a bf16 widened to float32 is exact in tf32: its bits, shifted
__device__ __forceinline__ uint32_t bf16_bits_as_tf32(__nv_bfloat16 x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(x)) << 16;
}

// two floats -> one register of two bf16 (lo in the low half), rounded
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace tc
