// K1: GIN aggregation with the bond-embedding lookup inside the kernel
// (forward and backward). Wrapper, plain version and design note:
// graphtrans_tpu_torch/ops/kernels/gin_agg.py.
//
//   out[g,s,c] = scale*x[g,s,c] + sum_{e: mask[g,e], dst[g,e]=s}
//                w[g,e] * relu(x[g,src[g,e],c] + sum_f T[attr[g,f,e], c])
//
// Forward: one block per (graph g, slice of CT channels); thread t owns
// channel c0+t. The graph's x slice, an accumulator and the bond table slice
// live in shared memory; each thread walks the graph's edges in order and
// adds into its own accumulator column, so no cell has two writers (the
// walk is strided_agg.cuh's, shared with K6). src, dst and attr must be in
// range on every edge slot, masked ones included.
//
// Backward: one block per (chunk of GPB graphs, channel slice) walks its
// graphs in order with the same per-channel ownership: dx of each graph is
// finished in shared memory and written once; dT and dscale accumulate in
// the block across its chunk and are written as per-chunk partials, which
// sum_rows then adds up in chunk order. dw (a sum over channels) is reduced
// across the block's warps per edge and written per channel slice, then
// summed over the slices. No atomics: every sum has a fixed order.

#include <cuda_runtime.h>

#include "strided_agg.cuh"

namespace {

using strided::CT;

// Channel t of edge e's bond embedding, T[attr_0] + T[attr_1] + ..., added
// in the plain version's order: the backward's relu mask must not flip on a
// rounding difference.
struct TableEmb {
  const float* ts;
  const int* ea;
  int Em, F, t;
  __device__ __forceinline__ float operator()(int e) const {
    float v = ts[ea[e] * CT + t];
    for (int f = 1; f < F; ++f) v += ts[ea[f * Em + e] * CT + t];
    return v;
  }
};

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

  strided::stage_fwd_rows(xs, acc, x + g * Sm * d + c0 + t, Sm, d, live, t);
  for (int v = 0; v < V; ++v) ts[v * CT + t] = live ? tbl[(long)v * d + c0 + t] : 0.f;
  // The table-row indices in a pass of their own: here (a block stages one
  // graph) that measured faster than one pass; the backward, which stages
  // graph after graph, takes them in stage_edges' pass.
  strided::stage_edges(src, dst, emask, w, g, Em, t, es, ed, ew, [](int) {});
  for (int e = t; e < Em; e += CT)
    for (int f = 0; f < F; ++f) ea[f * Em + e] = attr[(g * F + f) * Em + e];
  __syncthreads();
  if (!live) return;

  strided::walk_fwd<true, true>(xs, acc, es, ed, ew, Em, t,
                                TableEmb{ts, ea, Em, F, t});
  const float sc = scale ? *scale : 0.f;
  float* og = out + g * Sm * d + c0 + t;
  for (int s = 0; s < Sm; ++s) {
    float o = acc[s * CT + t];
    if (scale) o += sc * xs[s * CT + t];
    og[(long)s * d] = o;
  }
}

// dmsg[e] = gout[dst[e]] * w[e] * (pre[e] > 0) on valid edges, with
// pre = x[src] + sum_f T[attr_f]; dx = scale*gout + scatter of dmsg to src;
// dT[attr_f] += dmsg; dw[e] = sum_c gout[dst[e]] * relu(pre[e]);
// dscale = sum gout * x.
__global__ void __launch_bounds__(CT)
gin_agg_bwd_kernel(const float* __restrict__ x, const int* __restrict__ src,
                   const int* __restrict__ dst, const bool* __restrict__ emask,
                   const int* __restrict__ attr, const float* __restrict__ tbl,
                   const float* __restrict__ w, const float* __restrict__ scale,
                   const float* __restrict__ gout, float* __restrict__ dx,
                   float* __restrict__ dtbl_part, float* __restrict__ dw_part,
                   float* __restrict__ dsc_part, int G, int Sm, int Em, int F,
                   int V, int d, int gpb) {
  extern __shared__ float smem[];
  float* xs = smem;                 // [Sm][CT]
  float* gs = xs + Sm * CT;         // [Sm][CT] gout
  float* dxs = gs + Sm * CT;        // [Sm][CT] dx accumulator
  float* ts = dxs + Sm * CT;        // [V][CT]
  float* dts = ts + V * CT;         // [V][CT] dT accumulator (whole chunk)
  int* es = reinterpret_cast<int*>(dts + V * CT);  // [Em] src
  int* ed = es + Em;                // [Em] dst, -1 = masked edge
  float* ew = reinterpret_cast<float*>(ed + Em);   // [Em] weight
  int* ea = reinterpret_cast<int*>(ew + Em);       // [F][Em] table rows
  float* wsum = reinterpret_cast<float*>(ea + F * Em);  // [CT/32][Em]

  const int chunk = blockIdx.x;
  const int slice = blockIdx.y;
  const int c0 = slice * CT;
  const int t = threadIdx.x;
  const bool live = c0 + t < d;
  const float sc = scale ? *scale : 0.f;

  for (int v = 0; v < V; ++v) {
    ts[v * CT + t] = live ? tbl[(long)v * d + c0 + t] : 0.f;
    dts[v * CT + t] = 0.f;
  }
  auto add_dtbl = [&](int e, float dm) {
    for (int f = 0; f < F; ++f) dts[ea[f * Em + e] * CT + t] += dm;
  };
  float dsc = 0.f;
  const long g0 = (long)chunk * gpb;
  const long g1 = g0 + gpb < G ? g0 + gpb : (long)G;
  for (long g = g0; g < g1; ++g) {
    __syncthreads();  // the previous graph's edge lists and wsum are read
    const long base = g * Sm * d + c0 + t;
    strided::stage_bwd_rows(xs, gs, dxs, x, gout, base, Sm, d, live, t,
                            scale != nullptr, sc, dsc);
    strided::stage_edges(src, dst, emask, w, g, Em, t, es, ed, ew,
                         [&](int e) {
      for (int f = 0; f < F; ++f) ea[f * Em + e] = attr[(g * F + f) * Em + e];
    });
    __syncthreads();

    strided::walk_bwd<true, true, 1>(xs, gs, dxs, es, ed, ew, wsum,
                                     w != nullptr, Em, t,
                                     TableEmb{ts, ea, Em, F, t}, add_dtbl,
                                     [](int, float) {});
    if (live) {
      float* dg = dx + base;
      for (int s = 0; s < Sm; ++s) dg[(long)s * d] = dxs[s * CT + t];
    }
    if (w) {
      __syncthreads();
      strided::write_dw(wsum, dw_part, g, G, slice, Em, t);
    }
  }
  if (live) {
    for (int v = 0; v < V; ++v)
      dtbl_part[((long)chunk * V + v) * d + c0 + t] = dts[v * CT + t];
    if (scale) dsc_part[(long)chunk * d + c0 + t] = dsc;
  }
}

using strided::sum_rows;

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

// Scratch (allocated by the caller): dtbl_part [ceil(G/gpb), V, d];
// with w, dw_part [ceil(d/CT), G, Em]; with scale, dsc_part [ceil(G/gpb), d]
// and dsc_col [d]. Outputs dtbl [V, d], dw [G, Em], dscale [1].
extern "C" int gin_agg_bwd(const float* x, const int* src, const int* dst,
                           const bool* emask, const int* attr,
                           const float* tbl, const float* w,
                           const float* scale, const float* gout, float* dx,
                           float* dtbl, float* dw, float* dscale,
                           float* dtbl_part, float* dw_part, float* dsc_part,
                           float* dsc_col, int G, int Sm, int Em, int F, int V,
                           int d, int gpb, cudaStream_t stream) {
  const size_t smem = (size_t)(3 * Sm + 2 * V) * CT * sizeof(float) +
                      (size_t)Em * (3 + F) * sizeof(int) +
                      (w ? (size_t)(CT / 32) * Em * sizeof(float) : 0);
  cudaError_t err = cudaFuncSetAttribute(
      gin_agg_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int chunks = (G + gpb - 1) / gpb;
  const int slices = (d + CT - 1) / CT;
  dim3 grid(chunks, slices);
  gin_agg_bwd_kernel<<<grid, CT, smem, stream>>>(
      x, src, dst, emask, attr, tbl, w, scale, gout, dx, dtbl_part, dw_part,
      dsc_part, G, Sm, Em, F, V, d, gpb);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = sum_rows(dtbl_part, dtbl, chunks, (long)V * d, stream)))
    return err;
  if (w && (err = sum_rows(dw_part, dw, slices, (long)G * Em, stream)))
    return err;
  if (scale) {
    if ((err = sum_rows(dsc_part, dsc_col, chunks, d, stream))) return err;
    if ((err = sum_rows(dsc_col, dscale, d, 1, stream))) return err;
  }
  return cudaSuccess;
}
