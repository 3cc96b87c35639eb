// VEC neighbouring floats a thread, as one 16-byte access (VEC 4, the
// address aligned to 16 bytes) or one 4-byte access (VEC 1): the loads and
// stores of K1 (gin_agg.cu) and K7-bwd (spmm.cu).

#pragma once

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

}  // namespace vio
