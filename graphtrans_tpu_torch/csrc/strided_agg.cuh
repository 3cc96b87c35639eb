// sum_rows: the deterministic second pass of K6-bwd's dw (dense_agg.cu),
// which adds the per-channel-slice partials of each edge slot in slice
// order. K6's forward and backward bodies are in dense_agg.cu, K1's in
// gin_agg.cu.

#pragma once

#include <cuda_runtime.h>

namespace strided {

// out[j] = sum_i in[i*m + j], i in order: the deterministic second pass
// that adds up per-block partials.
__global__ void sum_rows_kernel(const float* __restrict__ in,
                                float* __restrict__ out, int n, long m) {
  const long j = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  float s = 0.f;
  for (int i = 0; i < n; ++i) s += in[(long)i * m + j];
  out[j] = s;
}

inline cudaError_t sum_rows(const float* in, float* out, int n, long m,
                            cudaStream_t stream) {
  const int threads = 256;
  sum_rows_kernel<<<(unsigned)((m + threads - 1) / threads), threads, 0,
                    stream>>>(in, out, n, m);
  return cudaGetLastError();
}

}  // namespace strided
