// K6: strided gather -> (+emb, relu, *w) -> scatter-sum, forward and
// backward. Wrapper, plain version and design note:
// graphtrans_tpu_torch/ops/kernels/dense_agg.py.
//
//   out[g,s,c] = sum_{e: mask[g,e], dst[g,e]=s}
//                w[g,e] * relu(x[g,src[g,e],c] + emb[g,e,c])
//
// (relu and w optional, each a template flag.) K1's layout without the
// table lookup (strided_agg.cuh: one block per (graph g, slice of CT
// channels), thread t owning channel c0+t, edges walked in order into a
// shared accumulator, no atomics); here an edge's embedding is a load of
// emb, EU edges' loads issued before their adds. src and dst must be in
// [0, Sm) on every valid slot; a masked slot's emb is never read.
//
// Backward: the same blocks and ownership. dmsg = gout[dst] (*w, zero
// where pre <= 0 under relu) is written to demb per edge and channel (0 on
// masked slots) and added into a shared dx accumulator at src; the relu
// mask is recomputed from x and emb with the forward's one add. dw is
// reduced across the block's warps per edge, written per channel slice and
// the slices summed in order.

#include <cuda_runtime.h>

#include "strided_agg.cuh"

namespace {

using strided::CT;

template <bool RELU, bool HAS_W>
__global__ void __launch_bounds__(CT)
dense_agg_fwd_kernel(const float* __restrict__ x, const int* __restrict__ src,
                     const int* __restrict__ dst,
                     const bool* __restrict__ emask,
                     const float* __restrict__ emb,
                     const float* __restrict__ w, float* __restrict__ out,
                     int Sm, int Em, int d) {
  extern __shared__ float smem[];
  float* xs = smem;                 // [Sm][CT]
  float* acc = xs + Sm * CT;        // [Sm][CT]
  int* es = reinterpret_cast<int*>(acc + Sm * CT);  // [Em] src
  int* ed = es + Em;                // [Em] dst, -1 = masked edge
  float* ew = reinterpret_cast<float*>(ed + Em);    // [Em] weight

  const long g = blockIdx.x;
  const int c0 = blockIdx.y * CT;
  const int t = threadIdx.x;
  const bool live = c0 + t < d;

  strided::stage_fwd_rows(xs, acc, x + g * Sm * d + c0 + t, Sm, d, live, t);
  strided::stage_edges(src, dst, emask, w, g, Em, t, es, ed, ew,
                       [](int) {});
  __syncthreads();
  if (!live) return;

  const float* eg = emb + g * Em * d + c0 + t;
  strided::walk_fwd<RELU, HAS_W>(xs, acc, es, ed, ew, Em, t,
                                 [&](int e) { return eg[(long)e * d]; });
  float* og = out + g * Sm * d + c0 + t;
  for (int s = 0; s < Sm; ++s) og[(long)s * d] = acc[s * CT + t];
}

template <bool RELU, bool HAS_W>
__global__ void __launch_bounds__(CT)
dense_agg_bwd_kernel(const float* __restrict__ x, const int* __restrict__ src,
                     const int* __restrict__ dst,
                     const bool* __restrict__ emask,
                     const float* __restrict__ emb,
                     const float* __restrict__ w,
                     const float* __restrict__ gout, float* __restrict__ dx,
                     float* __restrict__ demb, float* __restrict__ dw_part,
                     int G, int Sm, int Em, int d) {
  extern __shared__ float smem[];
  float* xs = smem;                 // [Sm][CT]
  float* gs = xs + Sm * CT;         // [Sm][CT] gout
  float* dxs = gs + Sm * CT;        // [Sm][CT] dx accumulator
  int* es = reinterpret_cast<int*>(dxs + Sm * CT);  // [Em] src
  int* ed = es + Em;                // [Em] dst, -1 = masked edge
  float* ew = reinterpret_cast<float*>(ed + Em);    // [Em] weight
  float* wsum = ew + Em;            // [CT/32][Em] per-warp dw sums

  const long g = blockIdx.x;
  const int slice = blockIdx.y;
  const int c0 = slice * CT;
  const int t = threadIdx.x;
  const bool live = c0 + t < d;
  const long base = g * Sm * d + c0 + t;

  strided::stage_bwd_rows(xs, gs, dxs, x, gout, base, Sm, d, live, t);
  strided::stage_edges(src, dst, emask, w, g, Em, t, es, ed, ew,
                       [](int) {});
  __syncthreads();

  const long eoff = g * Em * d + c0 + t;
  strided::walk_bwd<RELU, HAS_W>(
      xs, gs, dxs, es, ed, ew, wsum, Em, t,
      [&](int e) { return live ? emb[eoff + (long)e * d] : 0.f; },
      [&](int e, float dm) {
        if (live) demb[eoff + (long)e * d] = dm;
      });
  if (live) {
    for (int s = 0; s < Sm; ++s) dx[base + (long)s * d] = dxs[s * CT + t];
  }
  if (HAS_W) {
    __syncthreads();
    strided::write_dw(wsum, dw_part, g, G, slice, Em, t);
  }
}

size_t fwd_smem(int Sm, int Em) {
  return (size_t)2 * Sm * CT * sizeof(float) + (size_t)3 * Em * sizeof(int);
}

size_t bwd_smem(int Sm, int Em) {
  return (size_t)3 * Sm * CT * sizeof(float) +
         (size_t)(3 + CT / 32) * Em * sizeof(float);
}

template <bool RELU, bool HAS_W>
cudaError_t launch_fwd(const float* x, const int* src, const int* dst,
                       const bool* emask, const float* emb, const float* w,
                       float* out, int G, int Sm, int Em, int d,
                       cudaStream_t stream) {
  const size_t smem = fwd_smem(Sm, Em);
  auto kernel = dense_agg_fwd_kernel<RELU, HAS_W>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(G, (d + CT - 1) / CT);
  kernel<<<grid, CT, smem, stream>>>(x, src, dst, emask, emb, w, out, Sm, Em,
                                     d);
  return cudaGetLastError();
}

template <bool RELU, bool HAS_W>
cudaError_t launch_bwd(const float* x, const int* src, const int* dst,
                       const bool* emask, const float* emb, const float* w,
                       const float* gout, float* dx, float* demb,
                       float* dw_part, int G, int Sm, int Em, int d,
                       cudaStream_t stream) {
  const size_t smem = bwd_smem(Sm, Em);
  auto kernel = dense_agg_bwd_kernel<RELU, HAS_W>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(G, (d + CT - 1) / CT);
  kernel<<<grid, CT, smem, stream>>>(x, src, dst, emask, emb, w, gout, dx,
                                     demb, dw_part, G, Sm, Em, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shared memory bytes a block needs (the wrapper checks the limit).
extern "C" long dense_agg_smem(int Sm, int Em, int backward) {
  return (long)(backward ? bwd_smem(Sm, Em) : fwd_smem(Sm, Em));
}

// Returns cudaGetLastError() after the launch (0 = launched). w may be
// null (no edge weight).
extern "C" int dense_agg_fwd(const float* x, const int* src, const int* dst,
                             const bool* emask, const float* emb,
                             const float* w, float* out, int G, int Sm,
                             int Em, int d, int relu, cudaStream_t stream) {
  if (relu)
    return w ? launch_fwd<true, true>(x, src, dst, emask, emb, w, out, G, Sm,
                                      Em, d, stream)
             : launch_fwd<true, false>(x, src, dst, emask, emb, w, out, G,
                                       Sm, Em, d, stream);
  return w ? launch_fwd<false, true>(x, src, dst, emask, emb, w, out, G, Sm,
                                     Em, d, stream)
           : launch_fwd<false, false>(x, src, dst, emask, emb, w, out, G, Sm,
                                      Em, d, stream);
}

// With w: dw_part [ceil(d/CT), G, Em] scratch (allocated by the caller;
// it may be dw itself when there is one slice) and dw [G, Em] out.
extern "C" int dense_agg_bwd(const float* x, const int* src, const int* dst,
                             const bool* emask, const float* emb,
                             const float* w, const float* gout, float* dx,
                             float* demb, float* dw, float* dw_part, int G,
                             int Sm, int Em, int d, int relu,
                             cudaStream_t stream) {
  cudaError_t err;
  if (relu)
    err = w ? launch_bwd<true, true>(x, src, dst, emask, emb, w, gout, dx,
                                     demb, dw_part, G, Sm, Em, d, stream)
            : launch_bwd<true, false>(x, src, dst, emask, emb, w, gout, dx,
                                      demb, dw_part, G, Sm, Em, d, stream);
  else
    err = w ? launch_bwd<false, true>(x, src, dst, emask, emb, w, gout, dx,
                                      demb, dw_part, G, Sm, Em, d, stream)
            : launch_bwd<false, false>(x, src, dst, emask, emb, w, gout, dx,
                                       demb, dw_part, G, Sm, Em, d, stream);
  if (err != cudaSuccess || !w || dw_part == dw) return err;
  return strided::sum_rows(dw_part, dw, (d + CT - 1) / CT, (long)G * Em,
                           stream);
}
