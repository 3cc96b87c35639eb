// K2: segment-masked attention over packed rows (forward). Wrapper, plain
// version and design note: graphtrans_tpu_torch/ops/kernels/attention_packed.py.
//
// qkv [R, W, 3d] (heads in lanes), seg [R, W] -> out [R, W, d].
// Query i attends key j iff seg[i] == seg[j] >= 0. One block per (row,
// head), one thread per query; K_h, V_h and seg are staged in shared memory
// and read as broadcasts; q and the output stay in registers and the
// softmax runs online (running max and denominator) in one pass over keys.

#include <cuda_runtime.h>
#include <math.h>

namespace {

template <int HD>
__global__ void attention_seg_fwd_kernel(const float* __restrict__ qkv,
                                         const int* __restrict__ seg,
                                         float* __restrict__ out, int W, int d,
                                         float scale) {
  extern __shared__ float smem[];
  float* ks = smem;                                  // [W][HD]
  float* vs = ks + W * HD;                           // [W][HD]
  int* ss = reinterpret_cast<int*>(vs + W * HD);     // [W]

  const long r = blockIdx.x;
  const int h = blockIdx.y;
  const int i = threadIdx.x;  // blockDim.x == W
  const long d3 = 3L * d;
  const float* row = qkv + r * W * d3;

  for (int idx = i; idx < W * HD; idx += blockDim.x) {
    const int j = idx / HD, c = idx % HD;
    ks[idx] = row[j * d3 + d + h * HD + c];
    vs[idx] = row[j * d3 + 2 * d + h * HD + c];
  }
  ss[i] = seg[r * W + i];
  __syncthreads();

  const int si = ss[i];
  float o[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) o[c] = 0.f;
  if (si >= 0) {
    float q[HD];
    const float* qi = row + i * d3 + h * HD;
#pragma unroll
    for (int c = 0; c < HD; ++c) q[c] = qi[c] * scale;
    float m = -INFINITY, l = 0.f;
    for (int j = 0; j < W; ++j) {
      if (ss[j] != si) continue;
      const float* kj = ks + j * HD;
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
      const float* vj = vs + j * HD;
#pragma unroll
      for (int c = 0; c < HD; ++c) o[c] = fmaf(p, vj[c], o[c]);
    }
    const float inv = 1.f / fmaxf(l, 1e-16f);
#pragma unroll
    for (int c = 0; c < HD; ++c) o[c] *= inv;
  }
  float* oi = out + (r * W + i) * d + h * HD;
#pragma unroll
  for (int c = 0; c < HD; ++c) oi[c] = o[c];
}

template <int HD>
int launch(const float* qkv, const int* seg, float* out, int R, int W, int d,
           int H, cudaStream_t stream) {
  const size_t smem = (size_t)2 * W * HD * sizeof(float) + W * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      attention_seg_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(R, H);
  attention_seg_fwd_kernel<HD><<<grid, W, smem, stream>>>(
      qkv, seg, out, W, d, 1.f / sqrtf((float)HD));
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int attention_seg_fwd(const float* qkv, const int* seg, float* out,
                                 int R, int W, int d, int H,
                                 cudaStream_t stream) {
  if (d != H * 32) return cudaErrorInvalidValue;  // hd 32: d_model 128, 4 heads
  return launch<32>(qkv, seg, out, R, W, d, H, stream);
}
