// K12: the segment sum of precomputed edge messages over dst-sorted edges.
// Wrapper, plain version and design note:
// graphtrans_tpu_torch/ops/kernels/scatter_mxu.py.
//
// out[i] = sum_{e in [ptr[i], ptr[i+1])} msg[e], msg [E, d] f32, ptr [N+1]
// int32 from searchsorted over the sorted dst (edges whose dst lies
// outside [0, N) fall outside every row).
//
// A row's edges are cut into pieces of L; pptr [N+1] (from the wrapper)
// numbers them, row i owning pieces [pptr[i], pptr[i+1]) (one, empty, for
// a row without edges). Pass 1: one warp per piece sums its edges in
// order, lanes over the channels (CPL channels a lane in registers), G
// edges' loads in flight, into partial [P, d]. Pass 2: one warp per row
// sums its pieces in order. A long row (a batch's padding node holds tens
// of thousands of edges) so spreads over many warps, and every output
// still has one writer and a fixed order of terms: no atomics,
// deterministic. A row of at most L edges is one piece: its sum is the
// sequential one.

#include <cuda_runtime.h>

namespace {

constexpr int L = 128;  // edges per piece
constexpr int G = 4;    // edges whose rows load together

template <int CPL>
__global__ void piece_sum_kernel(const float* __restrict__ msg,
                                 const int* __restrict__ ptr,
                                 const int* __restrict__ pptr,
                                 float* __restrict__ partial, int N, long P,
                                 int d) {
  const long w = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= P || w >= pptr[N]) return;  // the whole warp leaves together
  int lo = 0, hi = N - 1;              // the row: last r with pptr[r] <= w
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (pptr[mid] <= w) lo = mid; else hi = mid - 1;
  }
  const int beg = ptr[lo] + (int)(w - pptr[lo]) * L;
  const int end = min(ptr[lo + 1], beg + L);
  float acc[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) acc[j] = 0.f;
  for (int e0 = beg; e0 < end; e0 += G) {
    float v[G][CPL];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const long e = e0 + u;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = lane + 32 * j;
        v[u][j] = (e < end && c < d) ? msg[e * d + c] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < G; ++u)
      if (e0 + u < end) {
#pragma unroll
        for (int j = 0; j < CPL; ++j) acc[j] += v[u][j];
      }
  }
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = lane + 32 * j;
    if (c < d) partial[w * d + c] = acc[j];
  }
}

template <int CPL>
__global__ void row_sum_kernel(const float* __restrict__ partial,
                               const int* __restrict__ pptr,
                               float* __restrict__ out, int N, int d) {
  const long row = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= N) return;
  float acc[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) acc[j] = 0.f;
  for (long k = pptr[row]; k < pptr[row + 1]; ++k) {
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = lane + 32 * j;
      if (c < d) acc[j] += partial[k * d + c];
    }
  }
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = lane + 32 * j;
    if (c < d) out[row * d + c] = acc[j];
  }
}

template <int CPL>
int launch(const float* msg, const int* ptr, const int* pptr, float* partial,
           float* out, int N, long P, int d, cudaStream_t stream) {
  const int threads = 256;  // 8 warps a block
  piece_sum_kernel<CPL><<<(unsigned)((P * 32 + threads - 1) / threads),
                          threads, 0, stream>>>(msg, ptr, pptr, partial, N,
                                                P, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  row_sum_kernel<CPL><<<(unsigned)(((long)N * 32 + threads - 1) / threads),
                        threads, 0, stream>>>(partial, pptr, out, N, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int segment_sum_piece_len() { return L; }

// out [N, d] = per-row sums of msg over the row pointer ptr [N+1]; pptr
// [N+1] numbers each row's pieces of L edges (at least one a row), partial
// [P, d] holds the pieces' sums, P >= pptr[N]. Returns cudaGetLastError()
// after the launches (0 = launched).
extern "C" int segment_sum_mxu(const float* msg, const int* ptr,
                               const int* pptr, float* partial, float* out,
                               int N, long P, int d, cudaStream_t stream) {
  if (N <= 0 || d <= 0 || d > 512) return cudaErrorInvalidValue;
  if (d <= 128)
    return launch<4>(msg, ptr, pptr, partial, out, N, P, d, stream);
  if (d <= 256)
    return launch<8>(msg, ptr, pptr, partial, out, N, P, d, stream);
  if (d <= 384)
    return launch<12>(msg, ptr, pptr, partial, out, N, P, d, stream);
  return launch<16>(msg, ptr, pptr, partial, out, N, P, d, stream);
}
