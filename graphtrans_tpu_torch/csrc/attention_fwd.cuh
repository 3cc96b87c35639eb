// The streaming attention forward shared by K5 (flash_attention.cu) and K9
// (attention_smalls.cu): qkv [B, S, 3d] with heads in lanes -> out
// [B, S, d], and where a gradient is wanted the softmax statistics m and l
// ([B, S, H]) that the backward of attention_bwd.cuh reads.
//
// The mask is a pair of tags (policy Tags, as in attention_bwd.cuh): query
// i attends key j iff qtag(i) == ktag(j) >= 0. Scale 1/sqrt(hd); the
// output is normalised by max(l, 1e-16), so a query with no key writes
// exact zeros. One block per (row, head, BQ queries), one thread per
// query: q and the output accumulator (HD floats each) stay in registers.
// The keys stream through shared memory BK = 4096 / HD at a time (32 KB for
// K and V at every head width). A key tile none of whose keys any query of
// the block can attend is skipped whole (one __syncthreads_or): tags are
// non-decreasing along a row, so in a graph's row, whose valid keys are a
// prefix plus the CLS column, most tiles of a wide row are skipped, exactly,
// for any mask.
//
// Dropout (policy Keep: keep(b, h, H, S, i, j); torch semantics: l sums the
// undropped probabilities, a kept one is scaled by 1/(1-rate)) is drawn
// from the seed inside the loop; nothing is stored. DROP and STATS are
// compile-time, so the serving instance runs the loop without either.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "attention_bwd.cuh"

namespace attn {

constexpr int BQ = 128;  // queries a block of the forward (= threads)

template <int HD, bool DROP, bool STATS, class Tags, class Keep>
__device__ __forceinline__ void stream_fwd(const float* __restrict__ qkv,
                                           Tags tags, float* __restrict__ out,
                                           float* __restrict__ stat_m,
                                           float* __restrict__ stat_l, int S,
                                           int d, float scale, Keep dr) {
  constexpr int BK = 4096 / HD;  // keys a tile (<= BQ)
  __shared__ float4 ks4[BK * HD / 4];
  __shared__ float4 vs4[BK * HD / 4];
  __shared__ int ss[BK];
  __shared__ int qrange[2];
  const float* ks = reinterpret_cast<const float*>(ks4);
  const float* vs = reinterpret_cast<const float*>(vs4);

  const long b = blockIdx.x;
  const int h = blockIdx.y;
  const int t = threadIdx.x;
  const int i = blockIdx.z * BQ + t;
  const long d3 = 3L * d;
  const long base = b * S;
  const float* row = qkv + base * d3;

  const int si = i < S ? tags.qtag(base, i) : -1;
  int qmin, qmax;
  block_range(si, qrange, qmin, qmax);

  float q[HD], o[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) o[c] = 0.f;
  if (si >= 0) {
    const float* qi = row + i * d3 + h * HD;
#pragma unroll
    for (int c = 0; c < HD; ++c) q[c] = qi[c] * scale;
  }
  float m = -INFINITY, l = 0.f;

  if (qmax >= 0) {  // the block holds a query that can attend something
    for (int k0 = 0; k0 < S; k0 += BK) {
      const int j = k0 + t;
      const int sj = (t < BK && j < S) ? tags.ktag(base, j) : -1;
      const bool meets = sj >= qmin && sj <= qmax;  // qmin >= 0
      if (!__syncthreads_or(meets)) continue;  // uniform: no pair in the tile
      if (t < BK) ss[t] = sj;
      // K_h and V_h of the tile, 16 bytes a load (HD and d are multiples
      // of 32, so every row offset is 16-byte aligned)
      for (int idx = t; idx < BK * HD / 4; idx += BQ) {
        const int jj = idx / (HD / 4), c4 = idx % (HD / 4);
        float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
        if (k0 + jj < S) {
          const float* kr = row + (long)(k0 + jj) * d3 + d + h * HD;
          kv = reinterpret_cast<const float4*>(kr)[c4];
          vv = reinterpret_cast<const float4*>(kr + d)[c4];
        }
        ks4[idx] = kv;
        vs4[idx] = vv;
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
          if (DROP && !dr(b, h, gridDim.y, S, i, k0 + jj)) continue;
          const float* vj = vs + jj * HD;
#pragma unroll
          for (int c = 0; c < HD; ++c) o[c] = fmaf(p, vj[c], o[c]);
        }
      }
      __syncthreads();  // the tile is overwritten next
    }
  }
  if (i < S) {
    const float inv = (DROP ? dr.inv_keep : 1.f) / fmaxf(l, 1e-16f);
    float* oi = out + (base + i) * d + h * HD;
#pragma unroll
    for (int c = 0; c < HD; ++c) oi[c] = o[c] * inv;
    if (STATS) {
      const long at = (base + i) * gridDim.y + h;
      stat_m[at] = m;
      stat_l[at] = l;
    }
  }
}

}  // namespace attn
