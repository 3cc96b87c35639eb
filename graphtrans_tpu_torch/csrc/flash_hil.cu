// K3: segment-masked attention over wide packed rows, streaming the keys
// in blocks with an online softmax. Wrapper, plain version and design
// note: graphtrans_tpu_torch/ops/kernels/flash_hil.py.
//
// qkv [R, W, 3d] (heads in lanes), seg [R, W] -> out [R, W, d]. Query i
// attends key j iff seg[i] == seg[j] >= 0; scale 1/sqrt(hd). One block per
// (row, head, block of BQ queries), one thread per query: q and the output
// accumulator (HD floats each) stay in registers. The keys stream through
// shared memory BK at a time (K_h, V_h and seg of the block). Segments of a
// packed row are contiguous, so a key block holds a key of the query
// block's segments only if its valid segment ids meet the query block's
// range [qmin, qmax]: blocks that cannot are skipped whole (one
// __syncthreads_or). Inside a block each query walks the keys in order and
// updates its running max m and denominator l; a query with no valid key
// (padding, or a segment without keys) writes exact zeros.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 128;  // queries a block (= threads)
constexpr int BK = 128;  // keys a shared-memory stage

template <int HD>
__global__ void __launch_bounds__(BQ)
flash_hil_fwd_kernel(const float* __restrict__ qkv,
                     const int* __restrict__ seg, float* __restrict__ out,
                     int W, int d, float scale) {
  __shared__ float ks[BK * HD];
  __shared__ float vs[BK * HD];
  __shared__ int ss[BK];
  __shared__ int qrange[2];

  const long r = blockIdx.x;
  const int h = blockIdx.y;
  const int i = blockIdx.z * BQ + threadIdx.x;
  const long d3 = 3L * d;
  const float* row = qkv + r * W * d3;
  const int* srow = seg + r * W;

  const int si = i < W ? srow[i] : -1;
  if (threadIdx.x == 0) {
    qrange[0] = 0x7fffffff;
    qrange[1] = -1;
  }
  __syncthreads();
  if (si >= 0) {
    atomicMin(&qrange[0], si);
    atomicMax(&qrange[1], si);
  }
  __syncthreads();
  const int qmin = qrange[0], qmax = qrange[1];

  float q[HD], o[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) o[c] = 0.f;
  if (si >= 0) {
    const float* qi = row + i * d3 + h * HD;
#pragma unroll
    for (int c = 0; c < HD; ++c) q[c] = qi[c] * scale;
  }
  float m = -INFINITY, l = 0.f;

  if (qmax >= 0) {  // the block holds a valid query
    for (int k0 = 0; k0 < W; k0 += BK) {
      const int j = k0 + threadIdx.x;  // BK == blockDim.x
      const int sj = j < W ? srow[j] : -1;
      const bool meets = sj >= qmin && sj <= qmax;
      if (!__syncthreads_or(meets)) continue;  // uniform: no key can match
      ss[threadIdx.x] = sj;
      for (int idx = threadIdx.x; idx < BK * HD; idx += BQ) {
        const int jj = idx / HD, c = idx % HD;
        const bool in = k0 + jj < W;
        const float* kr = row + (long)(k0 + jj) * d3 + h * HD + c;
        ks[idx] = in ? kr[d] : 0.f;
        vs[idx] = in ? kr[2 * d] : 0.f;
      }
      __syncthreads();
      if (si >= 0) {
        for (int jj = 0; jj < BK; ++jj) {
          if (ss[jj] != si) continue;
          const float* kj = ks + jj * HD;
          float s = 0.f;
#pragma unroll
          for (int c = 0; c < HD; ++c) s = fmaf(q[c], kj[c], s);
          if (s > m) {
            const float a = expf(m - s);  // 0 on the first key (m = -inf)
            l *= a;
#pragma unroll
            for (int c = 0; c < HD; ++c) o[c] *= a;
            m = s;
          }
          const float p = expf(s - m);
          l += p;
          const float* vj = vs + jj * HD;
#pragma unroll
          for (int c = 0; c < HD; ++c) o[c] = fmaf(p, vj[c], o[c]);
        }
      }
      __syncthreads();  // the stage is overwritten next
    }
  }
  if (i < W) {
    const float inv = 1.f / fmaxf(l, 1e-16f);
    float* oi = out + (r * W + i) * d + h * HD;
#pragma unroll
    for (int c = 0; c < HD; ++c) oi[c] = o[c] * inv;
  }
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Returns cudaGetLastError() after the launch (0 = launched). Heads of
// width 32 (d_model 128 with 4 heads, or 64 with 2).
extern "C" int flash_hil_fwd(const float* qkv, const int* seg, float* out,
                             int R, int W, int d, int H, cudaStream_t stream) {
  if (d != H * 32 || R <= 0 || W <= 0) return cudaErrorInvalidValue;
  dim3 grid(R, H, (W + BQ - 1) / BQ);
  flash_hil_fwd_kernel<32><<<grid, BQ, 0, stream>>>(qkv, seg, out, W, d,
                                                    1.f / sqrtf(32.f));
  return cudaGetLastError();
}
