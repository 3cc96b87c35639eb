// K1: GIN aggregation with the bond-embedding lookup inside the kernel
// (forward). Wrapper, plain version and design note:
// graphtrans_tpu_torch/ops/kernels/gin_agg.py.
//
//   out[g,s,c] = scale*x[g,s,c] + sum_{e: mask[g,e], dst[g,e]=s}
//                w[g,e] * relu(x[g,src[g,e],c] + sum_f T[attr[g,f,e], c])
//
// One block per (graph g, slice of CT channels); thread t owns channel
// c0+t. The graph's x slice, an accumulator and the bond table slice live
// in shared memory; each thread walks the graph's edges in order and adds
// into its own accumulator column, so no cell has two writers. src, dst and
// attr must be in range on every edge slot, masked ones included.

#include <cuda_runtime.h>

namespace {

constexpr int CT = 128;

__global__ void __launch_bounds__(CT)
gin_agg_fwd_kernel(const float* __restrict__ x, const int* __restrict__ src,
                   const int* __restrict__ dst, const bool* __restrict__ emask,
                   const int* __restrict__ attr, const float* __restrict__ tbl,
                   const float* __restrict__ w, const float* __restrict__ scale,
                   float* __restrict__ out, int Sm, int Em, int F, int V,
                   int d) {
  extern __shared__ float smem[];
  float* xs = smem;                 // [Sm][CT]
  float* acc = xs + Sm * CT;        // [Sm][CT]
  float* ts = acc + Sm * CT;        // [V][CT]
  int* es = reinterpret_cast<int*>(ts + V * CT);  // [Em] src
  int* ed = es + Em;                // [Em] dst, -1 = masked edge
  float* ew = reinterpret_cast<float*>(ed + Em);  // [Em] weight
  int* ea = reinterpret_cast<int*>(ew + Em);      // [F][Em] table rows

  const long g = blockIdx.x;
  const int c0 = blockIdx.y * CT;
  const int t = threadIdx.x;
  const bool live = c0 + t < d;
  const float* xg = x + g * Sm * d + c0 + t;

  for (int s = 0; s < Sm; ++s) {
    xs[s * CT + t] = live ? xg[(long)s * d] : 0.f;
    acc[s * CT + t] = 0.f;
  }
  for (int v = 0; v < V; ++v) ts[v * CT + t] = live ? tbl[(long)v * d + c0 + t] : 0.f;
  for (int e = t; e < Em; e += CT) {
    const long ge = g * Em + e;
    es[e] = src[ge];
    ed[e] = emask[ge] ? dst[ge] : -1;
    ew[e] = w ? w[ge] : 1.f;
    for (int f = 0; f < F; ++f) ea[f * Em + e] = attr[(g * F + f) * Em + e];
  }
  __syncthreads();
  if (!live) return;

  for (int e = 0; e < Em; ++e) {
    const int dd = ed[e];
    if (dd < 0) continue;
    float m = xs[es[e] * CT + t];
    for (int f = 0; f < F; ++f) m += ts[ea[f * Em + e] * CT + t];
    acc[dd * CT + t] += fmaxf(m, 0.f) * ew[e];
  }
  const float sc = scale ? *scale : 0.f;
  float* og = out + g * Sm * d + c0 + t;
  for (int s = 0; s < Sm; ++s) {
    float o = acc[s * CT + t];
    if (scale) o += sc * xs[s * CT + t];
    og[(long)s * d] = o;
  }
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int gin_agg_fwd(const float* x, const int* src, const int* dst,
                           const bool* emask, const int* attr,
                           const float* tbl, const float* w,
                           const float* scale, float* out, int G, int Sm,
                           int Em, int F, int V, int d, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * Sm + V) * CT * sizeof(float) +
                      (size_t)Em * (3 + F) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      gin_agg_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(G, (d + CT - 1) / CT);
  gin_agg_fwd_kernel<<<grid, CT, smem, stream>>>(x, src, dst, emask, attr,
                                                 tbl, w, scale, out, Sm, Em,
                                                 F, V, d);
  return cudaGetLastError();
}
