// The streaming attention backward shared by K4-bwd (attention_packed.cu)
// and K5-bwd (flash_attention.cu): two kernels, dq (which also writes
// delta) and dk/dv, over qkv [B, S, 3d] with heads in lanes, from the
// forward's output and its softmax statistics m and l ([B, S, H]).
//
// The mask is a pair of tags (policy Tags): query i attends key j iff
// qtag(i) == ktag(j) >= 0. K5's are its segq and segk; K4's are the
// query's block and, for a valid key, the key's block (0 for block 0), so
// K4's key-padding, block-diagonal mask is the same test. Tags are
// non-decreasing along a row, so a tile of keys (queries) whose tags cannot
// meet the block's range is skipped whole. The dropout mask (policy Keep:
// members on and inv_keep, and keep(b, h, H, S, i, j)) is drawn again from
// the forward's seed; nothing is stored.
//
// A query (key) is handled by L = HD/32 threads, each holding 32 of its
// channels (channel c*L + part, so the L threads of a group read
// neighbouring banks), with the two dot products of a pair summed over the
// group by shuffles. That keeps q, dO and the dq sum (k, v, dk, dv) in 96
// (128) registers a thread at every head width. K and V (Q and dO) stream
// through 32 KB of shared memory 4096/HD tokens at a time. Every output
// cell has one writer: no atomics; a key no query attends writes zeros.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace attn {

constexpr int THREADS = 128;  // threads a block of both kernels

// Fills lo/hi with the min and max of the block's tags that are >= 0 (none:
// hi < 0). All threads of the block call it.
__device__ __forceinline__ void block_range(int tag, int* range, int& lo,
                                            int& hi) {
  if (threadIdx.x == 0) {
    range[0] = 0x7fffffff;
    range[1] = -1;
  }
  __syncthreads();
  if (tag >= 0) {
    atomicMin(&range[0], tag);
    atomicMax(&range[1], tag);
  }
  __syncthreads();
  lo = range[0];
  hi = range[1];
}

// The sum of v over the L neighbouring lanes of this thread's group; the L
// threads of a group take the same path, so only they synchronise.
template <int L>
__device__ __forceinline__ float group_sum(float v) {
  const unsigned lane = threadIdx.x & 31u;
  const unsigned mask = ((1u << L) - 1u) << (lane & ~(unsigned)(L - 1));
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o);
  return v;
}

// K5's tags: segq and segk [B, S] int32.
struct SegTags {
  const int* q;
  const int* k;
  __device__ int qtag(long base, int i) const { return q[base + i]; }
  __device__ int ktag(long base, int j) const { return k[base + j]; }
};

// K4's tags: valid [B, S] (torch's bool, one byte) and block (0: the row).
struct PadTags {
  const unsigned char* valid;
  int block;
  __device__ int qtag(long, int i) const { return block ? i / block : 0; }
  __device__ int ktag(long base, int j) const {
    return valid[base + j] ? (block ? j / block : 0) : -1;
  }
};

// dq = scale * sum_j ds_ij k_j with ds = p (dp_dropped - delta) and p from
// the saved m, l; delta_i = dO_i . O_i per head (written for dkv_kernel).
// One block per (row, head, 128/L queries).
template <int HD, class Tags, class Keep>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const float* __restrict__ qkv, Tags tags,
          const float* __restrict__ out, const float* __restrict__ gout,
          const float* __restrict__ stat_m, const float* __restrict__ stat_l,
          float* __restrict__ delta, float* __restrict__ dqkv, int S, int d,
          float scale, Keep keep) {
  constexpr int L = HD / 32;       // threads a query
  constexpr int QB = THREADS / L;  // queries a block
  constexpr int BK = 4096 / HD;    // keys a tile
  __shared__ float4 ks4[BK * HD / 4];
  __shared__ float4 vs4[BK * HD / 4];
  __shared__ int ss[BK];
  __shared__ int qrange[2];
  const float* ks = reinterpret_cast<const float*>(ks4);
  const float* vs = reinterpret_cast<const float*>(vs4);

  const long b = blockIdx.x;
  const int h = blockIdx.y;
  const int H = gridDim.y;
  const int t = threadIdx.x;
  const int part = t % L;
  const int i = blockIdx.z * QB + t / L;
  const long d3 = 3L * d;
  const long base = b * S;
  const float* row = qkv + base * d3;

  const int ti = i < S ? tags.qtag(base, i) : -1;
  int qmin, qmax;
  block_range(ti, qrange, qmin, qmax);

  float q[32], g[32], acc[32];
  float de = 0.f, m = 0.f, li = 0.f;
#pragma unroll
  for (int c = 0; c < 32; ++c) acc[c] = q[c] = g[c] = 0.f;
  if (ti >= 0) {
    const float* qi = row + i * d3 + h * HD + part;
    const float* gi = gout + (base + i) * d + h * HD + part;
    const float* oi = out + (base + i) * d + h * HD + part;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      q[c] = qi[c * L] * scale;
      g[c] = gi[c * L];
      de = fmaf(g[c], oi[c * L], de);
    }
    const long at = (base + i) * H + h;
    m = stat_m[at];
    li = 1.f / fmaxf(stat_l[at], 1e-16f);
  }
  de = group_sum<L>(de);
  if (i < S && part == 0) delta[(base + i) * H + h] = de;

  if (qmax >= 0) {  // the block holds a query that can attend something
    for (int k0 = 0; k0 < S; k0 += BK) {
      const int j = k0 + t;
      const int sj = (t < BK && j < S) ? tags.ktag(base, j) : -1;
      const bool meets = sj >= qmin && sj <= qmax;  // qmin >= 0
      if (!__syncthreads_or(meets)) continue;  // uniform: no pair in the tile
      if (t < BK) ss[t] = sj;
      for (int idx = t; idx < BK * HD / 4; idx += THREADS) {
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
      if (ti >= 0) {
        for (int jj = 0; jj < BK; ++jj) {
          if (ss[jj] != ti) continue;  // the same for the whole group
          const float* kj = ks + jj * HD + part;
          const float* vj = vs + jj * HD + part;
          float s = 0.f, dp = 0.f;
#pragma unroll
          for (int c = 0; c < 32; ++c) {
            s = fmaf(q[c], kj[c * L], s);
            dp = fmaf(g[c], vj[c * L], dp);
          }
          s = group_sum<L>(s);
          dp = group_sum<L>(dp);
          if (keep.on)
            dp = keep(b, h, H, S, i, k0 + jj) ? dp * keep.inv_keep : 0.f;
          const float ds = expf(s - m) * li * (dp - de);
#pragma unroll
          for (int c = 0; c < 32; ++c) acc[c] = fmaf(ds, kj[c * L], acc[c]);
        }
      }
      __syncthreads();  // the tile is overwritten next
    }
  }
  if (i < S) {
    float* dq = dqkv + (base + i) * d3 + h * HD + part;
#pragma unroll
    for (int c = 0; c < 32; ++c) dq[c * L] = acc[c] * scale;
  }
}

// dk_j = sum_i ds_ij (scale q_i), dv_j = sum_i p_dropped_ij dO_i over the
// queries that attend key j. One block per (row, head, 128/L keys); the
// queries (q * scale, dO, m, 1/l, delta, tags) stream through shared
// memory. A block with no valid key writes zeros without reading a query.
template <int HD, class Tags, class Keep>
__global__ void __launch_bounds__(THREADS)
dkv_kernel(const float* __restrict__ qkv, Tags tags,
           const float* __restrict__ gout, const float* __restrict__ stat_m,
           const float* __restrict__ stat_l, const float* __restrict__ delta,
           float* __restrict__ dqkv, int S, int d, float scale, Keep keep) {
  constexpr int L = HD / 32;       // threads a key
  constexpr int KB = THREADS / L;  // keys a block
  constexpr int TQ = 4096 / HD;    // queries a tile
  __shared__ float4 qs4[TQ * HD / 4];  // q * scale
  __shared__ float4 gs4[TQ * HD / 4];  // dO
  __shared__ float ms[TQ], lis[TQ], des[TQ];
  __shared__ int ss[TQ];
  __shared__ int krange[2];
  const float* qs = reinterpret_cast<const float*>(qs4);
  const float* gs = reinterpret_cast<const float*>(gs4);

  const long b = blockIdx.x;
  const int h = blockIdx.y;
  const int H = gridDim.y;
  const int t = threadIdx.x;
  const int part = t % L;
  const int j = blockIdx.z * KB + t / L;
  const long d3 = 3L * d;
  const long base = b * S;
  const float* row = qkv + base * d3;

  const int sj = j < S ? tags.ktag(base, j) : -1;
  int kmin, kmax;
  block_range(sj, krange, kmin, kmax);

  float k[32], v[32], dk[32], dv[32];
#pragma unroll
  for (int c = 0; c < 32; ++c) k[c] = v[c] = dk[c] = dv[c] = 0.f;
  if (sj >= 0) {
    const float* kj = row + j * d3 + d + h * HD + part;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      k[c] = kj[c * L];
      v[c] = kj[d + c * L];
    }
  }

  if (kmax >= 0) {  // the block holds a valid key
    for (int q0 = 0; q0 < S; q0 += TQ) {
      const int iq = q0 + t;
      const int si = (t < TQ && iq < S) ? tags.qtag(base, iq) : -1;
      const bool meets = si >= kmin && si <= kmax;  // kmin >= 0
      if (!__syncthreads_or(meets)) continue;  // uniform: no pair in the tile
      if (t < TQ) {
        ss[t] = si;
        if (si >= 0) {
          const long at = (base + iq) * H + h;
          ms[t] = stat_m[at];
          lis[t] = 1.f / fmaxf(stat_l[at], 1e-16f);
          des[t] = delta[at];
        } else {
          ms[t] = lis[t] = des[t] = 0.f;
        }
      }
      for (int idx = t; idx < TQ * HD / 4; idx += THREADS) {
        const int ii = idx / (HD / 4), c4 = idx % (HD / 4);
        float4 qv = make_float4(0.f, 0.f, 0.f, 0.f), gv = qv;
        if (q0 + ii < S) {
          qv = reinterpret_cast<const float4*>(
              row + (long)(q0 + ii) * d3 + h * HD)[c4];
          qv.x *= scale;
          qv.y *= scale;
          qv.z *= scale;
          qv.w *= scale;
          gv = reinterpret_cast<const float4*>(
              gout + (base + q0 + ii) * d + h * HD)[c4];
        }
        qs4[idx] = qv;
        gs4[idx] = gv;
      }
      __syncthreads();
      if (sj >= 0) {
        for (int ii = 0; ii < TQ; ++ii) {
          if (ss[ii] != sj) continue;  // the same for the whole group
          const float* qi = qs + ii * HD + part;
          const float* gi = gs + ii * HD + part;
          float s = 0.f, dp = 0.f;
#pragma unroll
          for (int c = 0; c < 32; ++c) {
            s = fmaf(qi[c * L], k[c], s);
            dp = fmaf(gi[c * L], v[c], dp);
          }
          s = group_sum<L>(s);
          dp = group_sum<L>(dp);
          const float p = expf(s - ms[ii]) * lis[ii];
          float pd = p;
          if (keep.on) {
            const bool kp = keep(b, h, H, S, q0 + ii, j);
            pd = kp ? p * keep.inv_keep : 0.f;
            dp = kp ? dp * keep.inv_keep : 0.f;
          }
          const float ds = p * (dp - des[ii]);
#pragma unroll
          for (int c = 0; c < 32; ++c) {
            dk[c] = fmaf(ds, qi[c * L], dk[c]);  // q * scale: d s / d k
            dv[c] = fmaf(pd, gi[c * L], dv[c]);
          }
        }
      }
      __syncthreads();  // the tile is overwritten next
    }
  }
  if (j < S) {
    float* dkj = dqkv + (base + j) * d3 + d + h * HD + part;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      dkj[c * L] = dk[c];
      dkj[d + c * L] = dv[c];
    }
  }
}

// Launches dq_kernel then dkv_kernel on one stream (delta passes between
// them). Returns cudaGetLastError() after each launch.
template <int HD, class Tags, class Keep>
cudaError_t launch_bwd(const float* qkv, Tags tags, const float* out,
                       const float* gout, const float* stat_m,
                       const float* stat_l, float* delta, float* dqkv, int B,
                       int S, int d, int H, Keep keep, cudaStream_t stream) {
  constexpr int L = HD / 32;
  const float scale = 1.f / sqrtf((float)HD);
  const int per = THREADS / L;  // queries (keys) a block
  dim3 grid(B, H, (S + per - 1) / per);
  dq_kernel<HD, Tags, Keep><<<grid, THREADS, 0, stream>>>(
      qkv, tags, out, gout, stat_m, stat_l, delta, dqkv, S, d, scale, keep);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv_kernel<HD, Tags, Keep><<<grid, THREADS, 0, stream>>>(
      qkv, tags, gout, stat_m, stat_l, delta, dqkv, S, d, scale, keep);
  return cudaGetLastError();
}

}  // namespace attn
