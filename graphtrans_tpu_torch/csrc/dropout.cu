// K11: byte-threshold dropout with the mask drawn in the kernel. Wrapper,
// plain version and design note: graphtrans_tpu_torch/ops/kernels/dropout.py.
//
// x is viewed as [R, C] over its last axis (C % 128 == 0), cut into
// programs of br rows as the JAX kernel's grid cuts it. Element (row, col)
// of program p = row / br is kept iff
// byte = hash((row % br)*C + col, seed + p) >> 24 >= t, and a survivor is
// scaled by 1/(1 - t/256): the JAX kernel's bytes in its interpret mode
// (graphtrans_tpu/ops/pallas/prng.py:random_bytes_u8). The backward is the
// same kernel on the cotangent. One thread per four elements (one 16-byte
// load and store; C % 4 == 0 keeps the four in one row), grid-stride.

#include <cuda_runtime.h>

#include "hash.cuh"

namespace {

__global__ void byte_dropout_kernel(const float4* __restrict__ x,
                                    float4* __restrict__ out, long n4, int C,
                                    int br, unsigned seed, unsigned t,
                                    float scale) {
  for (long v = blockIdx.x * (long)blockDim.x + threadIdx.x; v < n4;
       v += (long)gridDim.x * blockDim.x) {
    const long e = 4 * v;
    const long row = e / C;
    const unsigned col = (unsigned)(e - row * C);
    const unsigned s = seed + (unsigned)(row / br);
    const unsigned pos = (unsigned)(row % br) * (unsigned)C + col;
    float4 a = x[v];
    a.x = (prng::hash_bits(pos, s) >> 24) >= t ? a.x * scale : 0.f;
    a.y = (prng::hash_bits(pos + 1, s) >> 24) >= t ? a.y * scale : 0.f;
    a.z = (prng::hash_bits(pos + 2, s) >> 24) >= t ? a.z * scale : 0.f;
    a.w = (prng::hash_bits(pos + 3, s) >> 24) >= t ? a.w * scale : 0.f;
    out[v] = a;
  }
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out = dropout(x) for x [R, C] f32, C % 128 == 0, programs of br rows, the
// program seeds seed + p (int32 wrap-around), threshold t in [1, 255].
// Returns cudaGetLastError() after the launch.
extern "C" int byte_dropout_fwd(const float* x, float* out, long R, int C,
                                int br, int seed, int t, float scale,
                                cudaStream_t stream) {
  if (R <= 0 || C <= 0 || C % 128 || br <= 0 || t <= 0 || t >= 256)
    return cudaErrorInvalidValue;
  const long n4 = R * (long)C / 4;
  const int threads = 256;
  const long blocks = (n4 + threads - 1) / threads;
  const int grid = (int)(blocks < 132L * 32 ? blocks : 132L * 32);
  byte_dropout_kernel<<<grid, threads, 0, stream>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(out), n4,
      C, br, (unsigned)seed, (unsigned)t, scale);
  return cudaGetLastError();
}
