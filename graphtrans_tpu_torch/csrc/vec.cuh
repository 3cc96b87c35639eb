// VEC neighbouring floats a thread, as one 16-byte access (VEC 4, the
// address aligned to 16 bytes) or one 4-byte access (VEC 1): the loads and
// stores of K1 (gin_agg.cu) and K7-bwd (spmm.cu). The same for VEC
// neighbouring bf16 values (K1's bf16 instances), as one 8-byte or one
// 2-byte access, widened to float on the load and rounded to nearest even
// on the store, by the intrinsics (builds may define
// __CUDA_NO_BFLOAT16_CONVERSIONS__); and the asynchronous copies of VEC
// elements of either type into shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace vio {

template <int VEC>
struct Vec {
  float v[VEC];
};

template <int VEC>
__device__ __forceinline__ Vec<VEC> zero_vec() {
  Vec<VEC> r;
#pragma unroll
  for (int j = 0; j < VEC; ++j) r.v[j] = 0.f;
  return r;
}

// VEC floats at p (aligned to VEC floats), shared or global
template <int VEC>
__device__ __forceinline__ Vec<VEC> load_vec(const float* p) {
  Vec<VEC> r;
  if constexpr (VEC == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    r.v[0] = q.x, r.v[1] = q.y, r.v[2] = q.z, r.v[3] = q.w;
  } else {
    r.v[0] = *p;
  }
  return r;
}

// the same from global memory that no kernel writes meanwhile, through the
// read-only cache
template <int VEC>
__device__ __forceinline__ Vec<VEC> load_vec_ro(const float* p) {
  Vec<VEC> r;
  if constexpr (VEC == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    r.v[0] = q.x, r.v[1] = q.y, r.v[2] = q.z, r.v[3] = q.w;
  } else {
    r.v[0] = __ldg(p);
  }
  return r;
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const Vec<VEC>& r) {
  if constexpr (VEC == 4)
    *reinterpret_cast<float4*>(p) = make_float4(r.v[0], r.v[1], r.v[2], r.v[3]);
  else
    *p = r.v[0];
}

using bf16 = __nv_bfloat16;

// four bf16 (8 bytes, as one uint2) widened to float
__device__ __forceinline__ void widen4(uint2 q, float (&v)[4]) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&q.y));
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}

// VEC bf16 at p (aligned to VEC elements), shared or global, as floats
template <int VEC>
__device__ __forceinline__ Vec<VEC> load_vec(const bf16* p) {
  Vec<VEC> r;
  if constexpr (VEC == 4)
    widen4(*reinterpret_cast<const uint2*>(p), r.v);
  else
    r.v[0] = __bfloat162float(*p);
  return r;
}

template <int VEC>
__device__ __forceinline__ Vec<VEC> load_vec_ro(const bf16* p) {
  Vec<VEC> r;
  if constexpr (VEC == 4)
    widen4(__ldg(reinterpret_cast<const uint2*>(p)), r.v);
  else
    r.v[0] = __bfloat162float(__ldg(p));
  return r;
}

// VEC floats rounded to bf16 (nearest even) at p
template <int VEC>
__device__ __forceinline__ void store_vec(bf16* p, const Vec<VEC>& r) {
  if constexpr (VEC == 4) {
    __nv_bfloat162 a = __floats2bfloat162_rn(r.v[0], r.v[1]);
    __nv_bfloat162 b = __floats2bfloat162_rn(r.v[2], r.v[3]);
    uint2 q;
    q.x = *reinterpret_cast<unsigned*>(&a);
    q.y = *reinterpret_cast<unsigned*>(&b);
    *reinterpret_cast<uint2*>(p) = q;
  } else {
    *p = __float2bfloat16_rn(r.v[0]);
  }
}

// the element read back as a float (f32: itself)
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

// x rounded to E and back: a bf16 instance's rounding point (f32: x)
template <class E>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (sizeof(E) == 2)
    return __bfloat162float(__float2bfloat16_rn(x));
  else
    return x;
}

// VEC elements of E from global to shared memory, zeros where !ok (src
// must still be a valid address): cp.async of 16 or 4 bytes (f32), of 8
// bytes (bf16, VEC 4); two bytes (bf16, VEC 1) are below cp.async's
// least, so that copy is a plain load and store, which the thread that
// issued it reads back itself
template <int VEC>
__device__ __forceinline__ void cp_elems(float* dst, const float* src,
                                         bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (VEC == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 4 : 0));
}
template <int VEC>
__device__ __forceinline__ void cp_elems(bf16* dst, const bf16* src,
                                         bool ok) {
  if constexpr (VEC == 4) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 8 : 0));
  } else {
    *dst = ok ? *src : __float2bfloat16_rn(0.f);
  }
}

}  // namespace vio
