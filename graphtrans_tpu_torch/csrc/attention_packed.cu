// K2: segment-masked attention over packed rows, forward with attention
// dropout and backward; and K4: key-padding attention, optionally
// block-diagonal, forward with attention dropout and backward. Wrappers,
// plain versions and design notes:
// graphtrans_tpu_torch/ops/kernels/attention_packed.py.
//
// K2: qkv [R, W, 3d] (heads in lanes), seg [R, W] -> out [R, W, d].
// Query i attends key j iff seg[i] == seg[j] >= 0. K4: qkv [B, S, 3d],
// valid [B, S] -> out [B, S, d]; key j is attendable by query i iff
// valid[j] and, with block > 0, i / block == j / block.
//
// K2's forward: one block per (row, head), one thread per query. K_h, V_h
// and the row's seg are staged in shared memory and read as broadcasts; q
// and the output stay in registers and the softmax runs online (running
// max and denominator) in one pass over the keys of the query's segment.
// Dropout (torch semantics: normalise by the undropped denominator, then
// drop and scale by 1/(1-rate)) keeps (i, j) iff hash(pos, seed') <
// thresh, with pos = ((r % bt)*W + i)*sp + j and seed' = seed + (r /
// bt)*stride + h (stride H; H + 3 when K4's kernels run inside K10's
// layer, transformer_layer.cu): the counter hash of the JAX package's
// interpret mode, so forward, backward and the plain version draw the same
// mask from (seed, r, h, i, j) and nothing is stored.
//
// K4's forward has two instances, picked by the span width (a graph block,
// or the row at block 0) in the wrapper's dense_fwd_geometry: spans of up
// to 128 tokens (every K4 launch of the molecule paths: rows of 2 x 49 and
// 3 x 33) take attention_tile.cuh's whole-span forward (a span's Q, K and V
// staged once, the scores once into a shared tile by register-blocked
// micro-tiles, an exact two-pass softmax per query row, O = P_drop V / l;
// several spans a block where one is small); wider ones (block 0, rows of
// 129-384) the long-row forward of attention_fwd.cuh (K5's: keys gathered
// by rank, products on the tensor cores in 3xTF32) with K4's mask as its
// tags. Both draw K2's mask through the Dropout policy below (as K4's
// backward does) and, where a gradient is wanted, write m and l per (row,
// query, head) with attention_fwd.cuh's meaning. What they replace: one
// block per (row, head), a thread per query walking its block's keys with
// one hd-long dependent FMA chain per key and the whole row's K and V staged
// for every head (168 registers a thread at hd 64).
//
// K2's backward: Q_h, K_h, V_h and dO_h of the row in shared memory. Pass
// A, one thread per query: recompute the running max m_i and denominator
// l_i and delta_i = sum_j p_ij dp_ij in one online pass, then dq_i in a
// second pass. Pass B, one thread per key: dk_j and dv_j as sums over the
// queries of its segment, with m, 1/l and delta of every query from shared
// memory. Every output cell has one writer: no atomics.
//
// K4's backward runs on attention_tile.cuh, one fused kernel per span (a
// graph block, or the row at block 0): delta = dO.O, p, dp and ds of each
// pair once (one dropout draw), then dQ, dK and dV from the shared tiles.
// Spans of up to 64 tokens go whole to attention_dense_bwd_short_kernel;
// wider ones (block 0, rows of up to 384) to attention_dense_bwd_wide_kernel
// in 64-token tiles. The wrapper (dense_bwd_geometry) picks the instance,
// grid, threads and shared bytes; the entry checks them before launching.

#include <cuda_runtime.h>
#include <math.h>

#include "attention_fwd.cuh"
#include "attention_tile.cuh"
#include "hash.cuh"

namespace {

using prng::hash_bits;

struct Dropout {
  int on;            // 0: rate 0, the identity
  unsigned thresh;   // keep iff bits < thresh
  float inv_keep;    // 1 / (1 - rate)
  int seed;
  int bt;            // rows per TPU grid tile (mask tiling of the reference)
  int sp;            // W rounded up to 128
  int stride;        // seeds a tile: H (K2, K4), H + 3 (K10's layer)

  // keep (i, j) of a row whose tile seed is hseed = seed + (r / bt)*stride + h
  // and whose place in its tile is rowpos = r % bt (both hoisted out of
  // K2's loops)
  __device__ bool at(unsigned hseed, unsigned rowpos, int i, int j,
                     int W) const {
    const unsigned pos = (rowpos * W + i) * (unsigned)sp + j;
    return hash_bits(pos, hseed) < thresh;
  }

  // keep (r, h, i, j): the Keep policy of attention_tile.cuh (K4-bwd)
  __device__ bool operator()(long r, int h, int H, int W, int i,
                             int j) const {
    return at((unsigned)seed + (unsigned)(r / bt) * stride + h,
              (unsigned)(r % bt), i, j, W);
  }
};

constexpr int W_MAX = 384;  // widest row (K2: threads a block)

// K2's forward: one block per (row, head), one thread per query; a padding
// query (seg -1) attends nothing and writes zeros.
template <int HD>
__global__ void attention_seg_fwd_kernel(const float* __restrict__ qkv,
                                         const int* __restrict__ seg,
                                         float* __restrict__ out, int W,
                                         int d, float scale, Dropout dr) {
  extern __shared__ float smem[];
  float* ks = smem;                                  // [W][HD]
  float* vs = ks + W * HD;                           // [W][HD]
  int* ss = reinterpret_cast<int*>(vs + W * HD);     // [W]

  const long r = blockIdx.x;
  const int h = blockIdx.y;
  const int i = threadIdx.x;  // blockDim.x == W
  const long d3 = 3L * d;
  const float* row = qkv + r * W * d3;
  const unsigned hseed =
      (unsigned)dr.seed + (unsigned)(r / dr.bt) * dr.stride + (unsigned)h;
  const unsigned rowpos = (unsigned)(r % dr.bt);

  for (int idx = i; idx < W * HD; idx += blockDim.x) {
    const int j = idx / HD, c = idx % HD;
    ks[idx] = row[j * d3 + d + h * HD + c];
    vs[idx] = row[j * d3 + 2 * d + h * HD + c];
  }
  ss[i] = seg[r * W + i];
  __syncthreads();

  const int ti = ss[i];
  float o[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) o[c] = 0.f;
  if (ti >= 0) {
    float q[HD];
    const float* qi = row + i * d3 + h * HD;
#pragma unroll
    for (int c = 0; c < HD; ++c) q[c] = qi[c] * scale;
    float m = -INFINITY, l = 0.f;
    for (int j = 0; j < W; ++j) {
      if (ss[j] != ti) continue;
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
      if (dr.on && !dr.at(hseed, rowpos, i, j, W)) continue;
      const float* vj = vs + j * HD;
#pragma unroll
      for (int c = 0; c < HD; ++c) o[c] = fmaf(p, vj[c], o[c]);
    }
    const float inv = (dr.on ? dr.inv_keep : 1.f) / fmaxf(l, 1e-16f);
#pragma unroll
    for (int c = 0; c < HD; ++c) o[c] *= inv;
  }
  float* oi = out + (r * W + i) * d + h * HD;
#pragma unroll
  for (int c = 0; c < HD; ++c) oi[c] = o[c];
}

template <int HD>
__global__ void __launch_bounds__(384)
attention_seg_bwd_kernel(const float* __restrict__ qkv,
                         const int* __restrict__ seg,
                         const float* __restrict__ gout,
                         float* __restrict__ dqkv, int W, int d, float scale,
                         Dropout dr) {
  extern __shared__ float smem[];
  float* qs = smem;                                  // [W][HD]
  float* ks = qs + W * HD;                           // [W][HD]
  float* vs = ks + W * HD;                           // [W][HD]
  float* gs = vs + W * HD;                           // [W][HD] dO
  float* mrow = gs + W * HD;                         // [W] running max
  float* linv = mrow + W;                            // [W] 1 / denominator
  float* delta = linv + W;                           // [W] sum_j p dp
  int* ss = reinterpret_cast<int*>(delta + W);       // [W]

  const long r = blockIdx.x;
  const int h = blockIdx.y;
  const int t = threadIdx.x;  // blockDim.x == W
  const long d3 = 3L * d;
  const float* row = qkv + r * W * d3;
  const float* grow = gout + r * W * d;
  float* drow = dqkv + r * W * d3;
  const unsigned hseed =
      (unsigned)dr.seed + (unsigned)(r / dr.bt) * dr.stride + (unsigned)h;
  const unsigned rowpos = (unsigned)(r % dr.bt);

  for (int idx = t; idx < W * HD; idx += blockDim.x) {
    const int j = idx / HD, c = idx % HD;
    qs[idx] = row[j * d3 + h * HD + c];
    ks[idx] = row[j * d3 + d + h * HD + c];
    vs[idx] = row[j * d3 + 2 * d + h * HD + c];
    gs[idx] = grow[j * d + h * HD + c];
  }
  ss[t] = seg[r * W + t];
  __syncthreads();

  // pass A: thread t is query i
  {
    const int i = t, si = ss[i];
    float acc[HD];
#pragma unroll
    for (int c = 0; c < HD; ++c) acc[c] = 0.f;
    float m = 0.f, li = 0.f, de = 0.f;
    if (si >= 0) {
      float q[HD], g[HD];
#pragma unroll
      for (int c = 0; c < HD; ++c) {
        q[c] = qs[i * HD + c] * scale;
        g[c] = gs[i * HD + c];
      }
      float l = 0.f, a_dp = 0.f;
      m = -INFINITY;
      for (int j = 0; j < W; ++j) {
        if (ss[j] != si) continue;
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int c = 0; c < HD; ++c) {
          s = fmaf(q[c], ks[j * HD + c], s);
          dp = fmaf(g[c], vs[j * HD + c], dp);
        }
        if (dr.on) dp = dr.at(hseed, rowpos, i, j, W) ? dp * dr.inv_keep : 0.f;
        if (s > m) {
          const float a = expf(m - s);
          l *= a;
          a_dp *= a;
          m = s;
        }
        const float e = expf(s - m);
        l += e;
        a_dp = fmaf(e, dp, a_dp);
      }
      li = 1.f / fmaxf(l, 1e-16f);
      de = a_dp * li;
      for (int j = 0; j < W; ++j) {
        if (ss[j] != si) continue;
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int c = 0; c < HD; ++c) {
          s = fmaf(q[c], ks[j * HD + c], s);
          dp = fmaf(g[c], vs[j * HD + c], dp);
        }
        if (dr.on) dp = dr.at(hseed, rowpos, i, j, W) ? dp * dr.inv_keep : 0.f;
        const float ds = expf(s - m) * li * (dp - de);
#pragma unroll
        for (int c = 0; c < HD; ++c) acc[c] = fmaf(ds, ks[j * HD + c], acc[c]);
      }
    }
    mrow[i] = m;
    linv[i] = li;
    delta[i] = de;
    float* dq = drow + i * d3 + h * HD;
#pragma unroll
    for (int c = 0; c < HD; ++c) dq[c] = acc[c] * scale;
  }
  __syncthreads();

  // pass B: thread t is key j
  {
    const int j = t, sj = ss[j];
    float dk[HD], dv[HD];
#pragma unroll
    for (int c = 0; c < HD; ++c) dk[c] = dv[c] = 0.f;
    if (sj >= 0) {
      float k[HD], v[HD];
#pragma unroll
      for (int c = 0; c < HD; ++c) {
        k[c] = ks[j * HD + c];
        v[c] = vs[j * HD + c];
      }
      for (int i = 0; i < W; ++i) {
        if (ss[i] != sj) continue;
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int c = 0; c < HD; ++c) {
          s = fmaf(qs[i * HD + c] * scale, k[c], s);
          dp = fmaf(gs[i * HD + c], v[c], dp);
        }
        const float p = expf(s - mrow[i]) * linv[i];
        float pd = p;
        if (dr.on) {
          const bool kp = dr.at(hseed, rowpos, i, j, W);
          pd = kp ? p * dr.inv_keep : 0.f;
          dp = kp ? dp * dr.inv_keep : 0.f;
        }
        const float ds = p * (dp - delta[i]);
#pragma unroll
        for (int c = 0; c < HD; ++c) {
          dk[c] = fmaf(ds, qs[i * HD + c], dk[c]);
          dv[c] = fmaf(pd, gs[i * HD + c], dv[c]);
        }
      }
    }
    float* dkj = drow + j * d3 + d + h * HD;
    float* dvj = drow + j * d3 + 2 * d + h * HD;
#pragma unroll
    for (int c = 0; c < HD; ++c) {
      dkj[c] = dk[c] * scale;
      dvj[c] = dv[c];
    }
  }
}

// K4's backward: spans of up to tile::SHORT_MAX tokens, `group` a block.
template <int HD>
__global__ void __launch_bounds__(tile::THREADS)
attention_dense_bwd_short_kernel(
    const float* __restrict__ qkv, const unsigned char* __restrict__ valid,
    const float* __restrict__ out, const float* __restrict__ gout,
    const float* __restrict__ stat_m, const float* __restrict__ stat_l,
    float* __restrict__ dqkv, int B, int S, int d, int H, int block, int np,
    int group, float scale, Dropout dr) {
  tile::bwd_short<HD>(qkv, valid, out, gout, stat_m, stat_l, dqkv, B, S, d,
                      H, block, np, group, scale, dr);
}

// K4's backward: wider spans, one a block of tile::THREADS, 64-token tiles.
template <int HD>
__global__ void __launch_bounds__(tile::THREADS)
attention_dense_bwd_wide_kernel(
    const float* __restrict__ qkv, const unsigned char* __restrict__ valid,
    const float* __restrict__ out, const float* __restrict__ gout,
    const float* __restrict__ stat_m, const float* __restrict__ stat_l,
    float* __restrict__ dqkv, int S, int d, int H, int block, int npad,
    float scale, Dropout dr) {
  tile::bwd_wide<HD>(qkv, valid, out, gout, stat_m, stat_l, dqkv, S, d, H,
                     block, npad, scale, dr);
}

// K2's forward: K/V of the row (98 KB at hd 32, W 384) take dynamic shared
// memory past the 48 KB default, hence the attribute.
int launch_seg_fwd(const float* qkv, const int* seg, float* out, int R, int W,
                   int d, int H, Dropout dr, cudaStream_t stream) {
  constexpr int HD = 32;
  const size_t smem = (size_t)2 * W * HD * sizeof(float) + W * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      attention_seg_fwd_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(R, H);
  attention_seg_fwd_kernel<HD><<<grid, W, smem, stream>>>(
      qkv, seg, out, W, d, 1.f / sqrtf((float)HD), dr);
  return cudaGetLastError();
}

template <int HD>
int launch_bwd(const float* qkv, const int* seg, const float* gout,
               float* dqkv, int R, int W, int d, int H, Dropout dr,
               cudaStream_t stream) {
  const size_t smem =
      (size_t)4 * W * HD * sizeof(float) + 3 * W * sizeof(float) +
      W * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      attention_seg_bwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(R, H);
  attention_seg_bwd_kernel<HD><<<grid, W, smem, stream>>>(
      qkv, seg, gout, dqkv, W, d, 1.f / sqrtf((float)HD), dr);
  return cudaGetLastError();
}

using tile::Launch;

// K4's forward: spans of up to 128 tokens, `group` (row, span, head) a
// block.
template <int HD, bool DROP, bool STATS>
__global__ void __launch_bounds__(tile::THREADS)
attention_dense_fwd_tile_kernel(const float* __restrict__ qkv,
                                const unsigned char* __restrict__ valid,
                                float* __restrict__ out,
                                float* __restrict__ stat_m,
                                float* __restrict__ stat_l, int B, int S,
                                int d, int H, int block, int np, int group,
                                float scale, Dropout dr) {
  tile::fwd_short<HD, DROP, STATS>(qkv, valid, out, stat_m, stat_l, B, S, d,
                                   H, block, np, group, scale, dr);
}

// K4's forward: wider spans (block 0), one block per (row, head, 64
// queries).
template <int HD, bool DROP, bool STATS>
__global__ void __launch_bounds__(attn::LONG_FWD_THREADS,
                                  attn::long_fwd_blocks(HD))
attention_dense_fwd_long_kernel(const float* __restrict__ qkv,
                                attn::PadTags tags, float* __restrict__ out,
                                float* __restrict__ stat_m,
                                float* __restrict__ stat_l, int S, int d,
                                float scale, Dropout dr) {
  attn::long_fwd<HD, DROP, STATS>(qkv, tags, out, stat_m, stat_l, S, d, scale,
                                  dr);
}

// Launches K4's forward (instance 1 the tile kernel, 3 the long one) after
// checking the wrapper's dense_fwd_geometry against the spans of (S, block)
// and the card's limits; each kernel's shared-memory attribute is raised
// once, before its first launch.
template <int HD, bool DROP, bool STATS>
int launch_dense_fwd_instance(const float* qkv, const unsigned char* valid,
                              float* out, float* stat_m, float* stat_l, int B,
                              int S, int d, int H, int block, Dropout dr,
                              const Launch& L, cudaStream_t stream) {
  const tile::Spans sp = tile::spans_of(S, block);
  const float scale = 1.f / sqrtf((float)HD);
  if (L.instance == 1) {
    const int np = tile::round4(sp.width);
    const long problems = (long)B * sp.count * H;
    if (L.pad != np || np > 128 || L.group < 1 || L.threads < 32 ||
        L.threads > tile::THREADS || L.threads % 32 || L.gy != 1 ||
        L.gz != 1 || (long)L.gx != (problems + L.group - 1) / L.group ||
        L.smem != L.group * tile::fwd_floats(np, HD) * 4 ||
        L.smem > tile::SMEM_MAX)
      return cudaErrorInvalidValue;
    static const cudaError_t set = cudaFuncSetAttribute(
        attention_dense_fwd_tile_kernel<HD, DROP, STATS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, tile::SMEM_MAX);
    if (set != cudaSuccess) return set;
    attention_dense_fwd_tile_kernel<HD, DROP, STATS>
        <<<L.gx, L.threads, L.smem, stream>>>(qkv, valid, out, stat_m, stat_l,
                                              B, S, d, H, block, np, L.group,
                                              scale, dr);
    return cudaGetLastError();
  }
  if (L.instance == 3) {
    if (sp.width <= 128 || !attn::long_fwd_launch_ok(L, B, S, H, HD))
      return cudaErrorInvalidValue;
    static const cudaError_t set = cudaFuncSetAttribute(
        attention_dense_fwd_long_kernel<HD, DROP, STATS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        attn::long_fwd_bytes(HD));
    if (set != cudaSuccess) return set;
    attention_dense_fwd_long_kernel<HD, DROP, STATS>
        <<<dim3(L.gx, L.gy, L.gz), L.threads, L.smem, stream>>>(
            qkv, attn::PadTags{valid, block}, out, stat_m, stat_l, S, d,
            scale, dr);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

// The serving instance (no dropout, no statistics), the gradient instance
// without dropout, and the training one (dropout always saves statistics).
template <int HD>
int launch_dense_fwd(const float* qkv, const unsigned char* valid, float* out,
                     float* stat_m, float* stat_l, int B, int S, int d, int H,
                     int block, Dropout dr, const Launch& L,
                     cudaStream_t stream) {
  if (dr.on)
    return launch_dense_fwd_instance<HD, true, true>(
        qkv, valid, out, stat_m, stat_l, B, S, d, H, block, dr, L, stream);
  if (stat_m)
    return launch_dense_fwd_instance<HD, false, true>(
        qkv, valid, out, stat_m, stat_l, B, S, d, H, block, dr, L, stream);
  return launch_dense_fwd_instance<HD, false, false>(
      qkv, valid, out, stat_m, stat_l, B, S, d, H, block, dr, L, stream);
}

// Launches K4's backward at HD after checking the wrapper's geometry
// against the spans of (S, block) and the card's limits; the shared-memory
// attribute of each kernel is raised once, before its first launch.
template <int HD>
int launch_dense_bwd(const float* qkv, const unsigned char* valid,
                     const float* out, const float* gout, const float* stat_m,
                     const float* stat_l, float* dqkv, int B, int S, int d,
                     int H, int block, Dropout dr, Launch L,
                     cudaStream_t stream) {
  const tile::Spans sp = tile::spans_of(S, block);
  const long problems = (long)B * sp.count * H;
  const float scale = 1.f / sqrtf((float)HD);
  if (L.smem <= 0 || L.smem > tile::SMEM_MAX || L.group < 1 ||
      L.threads < 32 || L.threads > tile::THREADS || L.threads % 32 ||
      L.gy != 1 || L.gz != 1)
    return cudaErrorInvalidValue;
  if (L.instance == 1) {
    const int np = tile::round4(sp.width);
    if (sp.width > tile::SHORT_MAX || L.pad != np ||
        (long)L.gx != (problems + L.group - 1) / L.group ||
        L.smem != L.group * tile::bwd_short_floats(np, HD) * 4)
      return cudaErrorInvalidValue;
    static const cudaError_t set = cudaFuncSetAttribute(
        attention_dense_bwd_short_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, tile::SMEM_MAX);
    if (set != cudaSuccess) return set;
    attention_dense_bwd_short_kernel<HD><<<L.gx, L.threads, L.smem,
                                           stream>>>(
        qkv, valid, out, gout, stat_m, stat_l, dqkv, B, S, d, H, block, np,
        L.group, scale, dr);
    return cudaGetLastError();
  }
  if (L.instance == 2) {
    const int npad = (sp.width + tile::WIDE - 1) / tile::WIDE * tile::WIDE;
    if (sp.width > W_MAX || L.pad != tile::WIDE || L.group != 1 ||
        L.threads != tile::THREADS || (long)L.gx != problems ||
        L.smem != tile::bwd_wide_floats(npad, HD) * 4)
      return cudaErrorInvalidValue;
    static const cudaError_t set = cudaFuncSetAttribute(
        attention_dense_bwd_wide_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, tile::SMEM_MAX);
    if (set != cudaSuccess) return set;
    attention_dense_bwd_wide_kernel<HD><<<L.gx, L.threads, L.smem,
                                          stream>>>(
        qkv, valid, out, gout, stat_m, stat_l, dqkv, S, d, H, block, npad,
        scale, dr);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

Dropout make_dropout(int on, unsigned thresh, float inv_keep, int seed,
                     int bt, int sp, int stride) {
  Dropout dr;
  dr.on = on;
  dr.thresh = thresh;
  dr.inv_keep = inv_keep;
  dr.seed = seed;
  dr.bt = bt;
  dr.sp = sp;
  dr.stride = stride;
  return dr;
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Returns cudaGetLastError() after the launch (0 = launched). drop = 0 is
// attention without dropout; otherwise (thresh, inv_keep, seed, bt, sp)
// define the keep mask as above.
extern "C" int attention_seg_fwd(const float* qkv, const int* seg, float* out,
                                 int R, int W, int d, int H, int drop,
                                 unsigned thresh, float inv_keep, int seed,
                                 int bt, int sp, cudaStream_t stream) {
  if (d != H * 32 || W > W_MAX) return cudaErrorInvalidValue;  // hd 32
  return launch_seg_fwd(qkv, seg, out, R, W, d, H,
                        make_dropout(drop, thresh, inv_keep, seed, bt, sp, H),
                        stream);
}

// K4 forward: valid [B, S] one byte each (0/1: torch's bool), block 0 or
// the graphs' width in a graph-packed row; drop and the rest as K2's, with
// stride the seeds a tile of bt rows (H; H + 3 inside K10's layer).
// stat_m and stat_l ([B, S, H]) may be null without dropout: the
// statistics are then not written (serving). Heads of width 32 or 64;
// S <= 384. The launch (instance, pad, group, grid, threads, smem) is the
// wrapper's dense_fwd_geometry; one that does not match (S, block, hd) is
// refused.
extern "C" int attention_dense_fwd(const float* qkv,
                                   const unsigned char* valid, float* out,
                                   float* stat_m, float* stat_l, int B, int S,
                                   int d, int H, int block, int drop,
                                   unsigned thresh, float inv_keep, int seed,
                                   int bt, int sp, int stride, int instance,
                                   int pad, int group, int gx, int gy, int gz,
                                   int threads, int smem,
                                   cudaStream_t stream) {
  if (B <= 0 || S <= 0 || S > W_MAX || block < 0 || H <= 0 || d % H ||
      stride < H)
    return cudaErrorInvalidValue;
  if ((stat_m == nullptr) != (stat_l == nullptr)) return cudaErrorInvalidValue;
  if (drop && stat_m == nullptr) return cudaErrorInvalidValue;
  const Dropout dr = make_dropout(drop, thresh, inv_keep, seed, bt, sp, stride);
  const Launch L{instance, pad, group, gx, gy, gz, threads, smem};
  if (d == H * 32)
    return launch_dense_fwd<32>(qkv, valid, out, stat_m, stat_l, B, S, d, H,
                                block, dr, L, stream);
  if (d == H * 64)
    return launch_dense_fwd<64>(qkv, valid, out, stat_m, stat_l, B, S, d, H,
                                block, dr, L, stream);
  return cudaErrorInvalidValue;
}

// K4 backward: dqkv [B, S, 3d] for the cotangent gout [B, S, d] of
// attention_dense_fwd's out, from its saved m and l, with K2's dropout
// tiling (stride as the forward's). Heads of width 32 or 64; S <= 384. The
// launch (instance, pad, group, grid, threads, smem) is the wrapper's
// dense_bwd_geometry; one that does not match (S, block, hd) is refused.
extern "C" int attention_dense_bwd(const float* qkv,
                                   const unsigned char* valid,
                                   const float* out, const float* gout,
                                   const float* stat_m, const float* stat_l,
                                   float* dqkv, int B, int S, int d, int H,
                                   int block, int drop, unsigned thresh,
                                   float inv_keep, int seed, int bt, int sp,
                                   int stride, int instance, int pad,
                                   int group, int gx, int gy, int gz,
                                   int threads, int smem,
                                   cudaStream_t stream) {
  if (B <= 0 || S <= 0 || S > W_MAX || block < 0 || H <= 0 || d % H ||
      stride < H)
    return cudaErrorInvalidValue;
  const Dropout dr = make_dropout(drop, thresh, inv_keep, seed, bt, sp, stride);
  const Launch L{instance, pad, group, gx, gy, gz, threads, smem};
  if (d == H * 32)
    return launch_dense_bwd<32>(qkv, valid, out, gout, stat_m, stat_l, dqkv, B,
                                S, d, H, block, dr, L, stream);
  if (d == H * 64)
    return launch_dense_bwd<64>(qkv, valid, out, gout, stat_m, stat_l, dqkv, B,
                                S, d, H, block, dr, L, stream);
  return cudaErrorInvalidValue;
}

extern "C" int attention_seg_bwd(const float* qkv, const int* seg,
                                 const float* gout, float* dqkv, int R, int W,
                                 int d, int H, int drop, unsigned thresh,
                                 float inv_keep, int seed, int bt, int sp,
                                 cudaStream_t stream) {
  if (d != H * 32) return cudaErrorInvalidValue;
  return launch_bwd<32>(qkv, seg, gout, dqkv, R, W, d, H,
                        make_dropout(drop, thresh, inv_keep, seed, bt, sp, H),
                        stream);
}
