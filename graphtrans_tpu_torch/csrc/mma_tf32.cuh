// The 3xTF32 tensor-core pieces that the hand-written products share: the
// long-row attention kernels (attention_bwd.cuh, attention_fwd.cuh) and K10's
// GEMM (transformer_layer.cu); K1-bwd (gin_agg.cu) uses its cp.async
// copies. 16- and 4-byte cp.async copies into shared memory,
// TF32 rounding and the 3xTF32 split, mma.sync m16n8k8 on TF32 inputs with
// f32 sums, and its A and B fragments read from shared tiles of any strides.

#pragma once

#include <cuda_runtime.h>

namespace tc {

// 16 bytes from global to shared memory, asynchronously; zeros where !ok
// (src must still be a valid address).
__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}
// 4 bytes, as cp16 (cp.async.cg copies 16 bytes only, so this one is .ca).
__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}
// VEC (4 or 1) floats: cp16 or cp4.
template <int VEC>
__device__ __forceinline__ void cp_floats(float* dst, const float* src,
                                          bool ok) {
  if constexpr (VEC == 4)
    cp16(dst, src, ok);
  else
    cp4(dst, src, ok);
}
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// x rounded to TF32 (10 mantissa bits, to nearest, ties away), as bits.
__device__ __forceinline__ unsigned tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x = hi + lo, both TF32: the 3xTF32 split.
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}
// c += a b for one m16n8k8 tile, a row-major 16 x 8, b col-major 8 x 8, on
// TF32 inputs with f32 sums.
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment of a 16 x 8 tile at (m0, k0) of a matrix whose element (m, k)
// sits at p[m * rs + k * cs], split into TF32 hi and lo parts. lane =
// 4 g + t holds (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4).
__device__ __forceinline__ void frag_a(const float* p, int rs, int cs,
                                       int m0, int k0, unsigned (&hi)[4],
                                       unsigned (&lo)[4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* q = p + (m0 + g) * rs + (k0 + t) * cs;
  split(q[0], hi[0], lo[0]);
  split(q[8 * rs], hi[1], lo[1]);
  split(q[4 * cs], hi[2], lo[2]);
  split(q[8 * rs + 4 * cs], hi[3], lo[3]);
}
// B fragment of an 8 x 8 tile at (k0, n0), element (k, n) at p[k * rs + n *
// cs]: lane 4 g + t holds (t, g), (t + 4, g).
__device__ __forceinline__ void frag_b(const float* p, int rs, int cs,
                                       int k0, int n0, unsigned (&hi)[2],
                                       unsigned (&lo)[2]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* q = p + (k0 + t) * rs + (n0 + g) * cs;
  split(q[0], hi[0], lo[0]);
  split(q[4 * rs], hi[1], lo[1]);
}
// c += a b in 3xTF32: hi*hi + hi*lo + lo*hi (lo*lo, ~2^-22 of the product,
// is dropped), so the sums keep f32 accuracy.
__device__ __forceinline__ void mma3(float (&c)[4], const unsigned (&ah)[4],
                                     const unsigned (&al)[4],
                                     const unsigned (&bh)[2],
                                     const unsigned (&bl)[2]) {
  mma(c, al, bh);
  mma(c, ah, bl);
  mma(c, ah, bh);
}

// Closes the cp.async copies issued since the last commit into one group.
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace tc
