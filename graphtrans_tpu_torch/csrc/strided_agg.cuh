// The strided-layout message sum of K6's forward (dense_agg.cu; K1's
// forward and backward have their own bodies in gin_agg.cu, and K6's
// backward its own in dense_agg.cu):
//
//   out[g,s,c] = sum_{e: mask[g,e], dst[g,e]=s}
//                w[g,e] * relu(x[g,src[g,e],c] + emb_e[c])
//
// One block per (graph, slice of CT channels); thread t owns channel
// c0+t. The graph's x slice, an accumulator and its edge lists sit in
// shared memory, and each thread walks the edges in order, adding into its
// own column, so no cell has two writers and every sum has a fixed order.
// An edge's embedding comes from a policy (Emb: emb(e) is channel t of
// edge e's embedding; K6 loads emb), fetched a few edges ahead of its add;
// a masked slot fetches nothing. sum_rows adds K6-bwd's per-slice dw
// partials in order.

#pragma once

#include <cuda_runtime.h>

namespace strided {

constexpr int CT = 128;  // channels per block (= threads)
constexpr int EU = 8;    // edges whose embeddings are fetched together

// The forward's rows: channel t of one graph's x (col: row 0 of that
// channel of its [Sm, d] slice) into shared xs [Sm][CT] (0 on a channel
// past d) and the accumulator acc [Sm][CT] zeroed.
__device__ __forceinline__ void stage_fwd_rows(float* xs, float* acc,
                                               const float* col, int Sm,
                                               int d, bool live, int t) {
  for (int r = 0; r < Sm; ++r) {
    xs[r * CT + t] = live ? col[(long)r * d] : 0.f;
    acc[r * CT + t] = 0.f;
  }
}

// Graph g's edge lists into shared memory: es = src, ed = dst (-1 on a
// masked slot), ew = w (1 where w is null). more(e) stages a kernel's own
// per-edge lists in the same pass, so all of an edge's loads are in flight
// together.
template <class More>
__device__ __forceinline__ void stage_edges(const int* src, const int* dst,
                                            const bool* emask, const float* w,
                                            long g, int Em, int t, int* es,
                                            int* ed, float* ew, More more) {
  for (int e = t; e < Em; e += CT) {
    const long ge = g * Em + e;
    es[e] = src[ge];
    ed[e] = emask[ge] ? dst[ge] : -1;
    ew[e] = w ? w[ge] : 1.f;
    more(e);
  }
}

// The forward's walk: acc[dst] += w * relu(x[src] + emb(e)) over the valid
// edges in order (relu and w as the flags say).
template <bool RELU, bool HAS_W, class Emb>
__device__ __forceinline__ void walk_fwd(const float* xs, float* acc,
                                         const int* es, const int* ed,
                                         const float* ew, int Em, int t,
                                         Emb emb) {
  for (int e0 = 0; e0 < Em; e0 += EU) {
    float ev[EU];
#pragma unroll
    for (int k = 0; k < EU; ++k) {
      const int e = e0 + k;
      ev[k] = (e < Em && ed[e] >= 0) ? emb(e) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < EU; ++k) {
      const int e = e0 + k;
      if (e >= Em) break;
      const int dd = ed[e];
      if (dd < 0) continue;
      float m = xs[es[e] * CT + t] + ev[k];
      if (RELU) m = fmaxf(m, 0.f);
      if (HAS_W) m *= ew[e];
      acc[dd * CT + t] += m;
    }
  }
}

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
