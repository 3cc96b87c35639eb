// The long-row attention backward: K5-bwd (flash_attention.cu), K9-bwd's
// long instance (attention_smalls.cu) and K3-bwd (flash_hil.cu), over qkv
// [B, S, 3d] with heads in lanes, from the forward's output and its softmax
// statistics m and l ([B, S, H], with attention_fwd.cuh's meaning). Also
// the mask policies, block_range and the staging and ranking pieces that
// the long forward (attention_fwd.cuh) shares; the 3xTF32 pieces are
// mma_tf32.cuh's.
//
// The mask is a pair of tags (policy Tags): query i attends key j iff
// qtag(i) == ktag(j) >= 0. K5's are its segq and segk, K3's its seg twice;
// K9's (and K4's) are the query's block and, for a valid key, the key's
// block (0 for block 0).
// The dropout mask (policy Keep: members on and inv_keep, and
// keep(b, h, H, S, i, j) with the row's own token indices) is drawn again
// from the forward's seed; nothing is stored.
//
// What it replaces. The streaming pair first written for K5: two kernels
// that gave a query (key) to hd/32 threads, spent one shared load per FMA
// and two shuffle reductions per pair, and walked whole 64-key tiles by
// position: a code2 row's valid keys are a prefix plus the CLS column, so
// the CLS tile held one key in 64 and about a third of the pair slots were
// padding. It ran at 10 % of its bound (23.24 ms at bench512 on the H100).
//
// The design: two kernels, as before, route (a). One kernel per (row, head)
// that walked the key chunks and kept dQ in device memory would compute each
// pair once, but a row's whole S x S work would then sit in one block: a
// graph of 1000 nodes, which code2's heavy tail holds, would take one block
// some 16 times the mean, and 2048 blocks give the card no slack for that
// tail. So the work is cut by tiles of T = 64 tokens:
//  - dq kernel, one block per (row, head, 64 queries): stages the tile's
//    Q and dO, writes delta_i = dO_i . O_i (for the dk/dv kernel), then
//    walks the row's keys whose tag meets the tile's tags, gathered 64 at a
//    time (a block-wide prefix count over the row's tags ranks them), and
//    keeps its dQ sums in registers;
//  - dk/dv kernel, one block per (row, head, chunk of 64 valid keys, the
//    z-th by rank): gathers its keys' K and V, walks the query tiles whose
//    tags can meet them, and keeps dK and dV in registers. Block z also
//    writes dk = dv = 0 for the padding keys among tokens [64z, 64z + 64).
// Gathering by rank fills the chunks: bench512's 62225 valid keys take
// 78208 chunk slots (80 %) where positional tiles took 110656 (56 %). The
// pair terms s = q.k and dp = dO.v are computed in both kernels: 7 hd
// multiply-adds a pair where a single pass would need 5. Every output cell
// has one writer: no atomics; the results are deterministic.
//
// A step is a 64 x 64 pair tile staged in shared memory with 16-byte
// cp.async copies (rows of hd + 4 floats; gathered rows by index, missing
// rows zero-filled). The products run on the tensor cores: s = q.k and
// dp = dO.v, then dQ += dS K (dq kernel) and dV += P_drop^T dO, dK +=
// dS^T Q (dk/dv kernel), each as mma.sync m16n8k8 TF32 tiles in 3xTF32
// (every operand split into a TF32 high part and a TF32 remainder, three
// products summed in f32), so the sums keep f32 accuracy; single-pass
// TF32 would not. A warp takes 16 rows x 32 keys of the pair tile (16 x
// hd/2 of a product). The pair's p comes from the forward's m and 1/l, its
// dropout bit from Keep, and dS (and P_drop) go through shared score tiles
// whose row stride keeps the fragment loads conflict-free where the tile
// is read (by rows in the dq kernel, by columns in the dk/dv kernel).
//
// Bound on the H100 at bench512 (512 rows of 1001, d 256, 4 heads of 64,
// ~122 valid keys a row, dropout 0.3): operations. 10 hd flops a pair of
// products, ~160 GFLOP, take 0.97 ms as 3xTF32 on the tensor cores (495
// TFLOP/s TF32), 2.41 ms at the f32 SIMT peak; the kernels execute 7 hd a
// pair over 80 % full chunks. Busy threads: every warp has a 16-row tile
// in every phase; at S 1001 the query tiles hold 1001 of 1024 rows (98
// %), at S 513 513 of 576 (89 %), and at bench512 the key chunks 80 % of
// their slots. Shared memory: the dq kernel takes 87 KB and the dk/dv
// kernel 106 KB at hd 64 (at most 128 registers a thread), so two blocks
// (16 warps) share an SM, and one block's copies overlap the other's
// arithmetic; at hd 128, 150 and 169 KB, one block. The old pair's
// positional tiles and one-load-per-FMA inner loop are gone; whole tiles
// whose tags cannot meet are still skipped, padding keys get dk = dv = 0
// and a query with no attendable key dq = 0.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "attention_tile.cuh"
#include "mma_tf32.cuh"

namespace attn {

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

// K5's tags: segq and segk [B, S] int32; K3's: its seg twice.
struct SegTags {
  const int* q;
  const int* k;
  __device__ int qtag(long base, int i) const { return q[base + i]; }
  __device__ int ktag(long base, int j) const { return k[base + j]; }
};

// K4's and K9's tags: valid [B, S] (torch's bool, one byte) and block (0:
// the row).
struct PadTags {
  const unsigned char* valid;
  int block;
  __device__ int qtag(long, int i) const { return block ? i / block : 0; }
  __device__ int ktag(long base, int j) const {
    return valid[base + j] ? (block ? j / block : 0) : -1;
  }
};

// ---- the long-row backward ----------------------------------------------

constexpr int LONG_THREADS = 256;  // threads a block of both kernels
constexpr int LONG_T = 64;         // queries a tile, keys a chunk
// floats a row of a score tile: the dq kernel reads dS by rows (stride
// = 4 mod 32 banks), the dk/dv kernel P_drop and dS by columns (8 mod 32)
constexpr int LONG_DQ_SLD = LONG_T + 4;
constexpr int LONG_DKV_SLD = LONG_T + 8;

// Shared bytes: four 64-row head tiles (Q, dO, K, V), the score tiles (dS;
// the dk/dv kernel also P_drop), per query m, 1/l, delta and tag, per key
// tag and token index, and the prefix count's scratch.
__host__ __device__ constexpr int long_dq_bytes(int hd) {
  return 4 * (4 * LONG_T * (hd + 4) + LONG_T * LONG_DQ_SLD + 6 * LONG_T + 16);
}
__host__ __device__ constexpr int long_dkv_bytes(int hd) {
  return 4 * (4 * LONG_T * (hd + 4) + 2 * LONG_T * LONG_DKV_SLD +
              6 * LONG_T + 16);
}
// blocks an SM for __launch_bounds__: two up to hd 64
__host__ __device__ constexpr int long_blocks(int hd) {
  return hd <= 64 ? 2 : 1;
}

namespace lr {

constexpr int T = LONG_T, NT = LONG_THREADS;

// cp.async staging and the 3xTF32 products (mma_tf32.cuh)
using tc::cp16;
using tc::cp_wait;
using tc::frag_a;
using tc::frag_b;
using tc::mma3;

// The shared tiles of a block.
template <int HD>
struct Tiles {
  static constexpr int LD = HD + 4;
  float *Q, *G, *K, *V, *dS, *Pd;  // Pd: the dk/dv kernel only
  float *m, *li, *de;              // per query of the tile
  int *qt, *kt, *kix;              // query tags; key tags, token indices
  int* scan;                       // NT / 32 + 1 ints
  int* range;                      // 2 ints
  int sld;                         // floats a row of dS (and Pd)

  __device__ explicit Tiles(float* s, bool pd) {
    sld = pd ? LONG_DKV_SLD : LONG_DQ_SLD;
    Q = s;
    G = Q + T * LD;
    K = G + T * LD;
    V = K + T * LD;
    dS = V + T * LD;
    Pd = pd ? dS + T * sld : nullptr;
    m = (pd ? Pd : dS) + T * sld;
    li = m + T;
    de = li + T;
    qt = reinterpret_cast<int*>(de + T);
    kt = qt + T;
    kix = kt + T;
    scan = kix + T;
    range = scan + NT / 32 + 1;
  }
};

// Rows [0, T) of N head slices into rows of HD + 4 floats, row r from the
// token row(r) (src[k] + row(r) * ld[k]), zeros for r >= n. All threads of
// the block take part.
template <int HD, int N, class Row>
__device__ __forceinline__ void stage(float* const (&dst)[N],
                                      const float* const (&src)[N],
                                      const long (&ld)[N], Row row, int n) {
  constexpr int C4 = HD / 4, LD = HD + 4;
  for (int idx = threadIdx.x; idx < T * C4; idx += blockDim.x) {
    const int r = idx / C4, c = idx % C4 * 4;
    const bool ok = r < n;
    const long tok = ok ? row(r) : 0;
#pragma unroll
    for (int k = 0; k < N; ++k)
      cp16(dst[k] + r * LD + c, src[k] + tok * ld[k] + c, ok);
  }
}

// The keys j < S that sel(j) accepts, ranked in token order: each of the
// block's nt threads counts its own contiguous segment of ceil(S / nt)
// tokens; returns the count before this thread's segment and sets total to
// the row's count. All threads call it; scan: nt / 32 + 1 ints of shared
// memory (nt a multiple of 32, at most 1024).
template <class Sel>
__device__ __forceinline__ int rank_keys(int S, Sel sel, int* scan,
                                         int& total) {
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int nt = blockDim.x, nw = nt / 32;
  const int seg = (S + nt - 1) / nt, j0 = min(S, t * seg);
  const int j1 = min(S, j0 + seg);
  int cnt = 0;
  for (int j = j0; j < j1; ++j) cnt += sel(j) ? 1 : 0;
  int inc = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += v;
  }
  __syncthreads();  // scan may still be read from an earlier call
  if (lane == 31) scan[w] = inc;
  __syncthreads();
  if (w == 0) {
    const int v = lane < nw ? scan[lane] : 0;
    int s = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += u;
    }
    if (lane < nw) scan[lane] = s - v;
    if (lane == nw - 1) scan[nw] = s;
  }
  __syncthreads();
  total = scan[nw];
  return scan[w] + inc - cnt;
}

// Writes the token indices of the accepted keys of ranks [r0, r0 + T) to
// kix (before: rank_keys's result for this thread).
template <class Sel>
__device__ __forceinline__ void list_keys(int S, Sel sel, int before, int r0,
                                          int* kix) {
  const int seg = (S + blockDim.x - 1) / blockDim.x;
  const int j0 = min(S, (int)threadIdx.x * seg);
  const int j1 = min(S, j0 + seg);
  int r = before;
  for (int j = j0; j < j1 && r < r0 + T; ++j)
    if (sel(j)) {
      if (r >= r0) kix[r - r0] = j;
      ++r;
    }
}

// The warps' tiles: warp w takes rows 16 (w % 4) .. + 16 of a 64-row
// tile, and columns (w / 4) * 32 of the pair tile's 64 keys, or (w / 4) *
// HD / 2 of a product's HD channels.
__device__ __forceinline__ int warp_m0() { return (threadIdx.x >> 5 & 3) * 16; }
__device__ __forceinline__ int warp_half() { return threadIdx.x >> 7; }

// The pair tile: s = q.k and dp = dO.v for the warp's 16 queries x 32 keys
// (four m16n8 tiles each, 3xTF32), then dS (and with PD, P_drop) into the
// score tiles, 0 where the pair does not meet. q0: the tile's first query
// token; queries with qt < 0 and keys with kt < 0 (padding rows) meet
// nothing.
template <int HD, bool PD, class Keep>
__device__ __forceinline__ void pair_tile(const Tiles<HD>& s, long b, int h,
                                          int H, int S, int q0, float scale,
                                          const Keep& keep) {
  constexpr int LD = HD + 4;
  const int m0 = warp_m0(), n0 = warp_half() * 32;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  float sc[4][4], dp[4][4];
  tile::zero(sc);
  tile::zero(dp);
#pragma unroll 2
  for (int k0 = 0; k0 < HD; k0 += 8) {
    unsigned ah[4], al[4], bh[2], bl[2];
    frag_a(s.Q, LD, 1, m0, k0, ah, al);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {  // B(k, n) = K[n][k]
      frag_b(s.K, 1, LD, k0, n0 + 8 * nt, bh, bl);
      mma3(sc[nt], ah, al, bh, bl);
    }
    frag_a(s.G, LD, 1, m0, k0, ah, al);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      frag_b(s.V, 1, LD, k0, n0 + 8 * nt, bh, bl);
      mma3(dp[nt], ah, al, bh, bl);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = m0 + g + 8 * r, qt = s.qt[i];
    const float m = s.m[i], li = s.li[i], de = s.de[i];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float pd[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = n0 + 8 * nt + 2 * t + e;
        pd[e] = ds[e] = 0.f;
        if (qt >= 0 && qt == s.kt[j]) {
          const bool kept = !keep.on || keep(b, h, H, S, q0 + i, s.kix[j]);
          tile::pair_grad(sc[nt][2 * r + e] * scale, dp[nt][2 * r + e], m, li,
                          de, kept, keep, pd[e], ds[e]);
        }
      }
      const int at = i * s.sld + n0 + 8 * nt + 2 * t;
      if constexpr (PD)
        *reinterpret_cast<float2*>(s.Pd + at) = make_float2(pd[0], pd[1]);
      *reinterpret_cast<float2*>(s.dS + at) = make_float2(ds[0], ds[1]);
    }
  }
}

// dq: one block per (row, head, T queries). Writes dq (scale * sum_j ds_ij
// k_j) for the tile's queries and delta_i = dO_i . O_i for the dk/dv
// kernel.
template <int HD, class Tags, class Keep>
__device__ __forceinline__ void long_dq(
    const float* __restrict__ qkv, Tags tags, const float* __restrict__ out,
    const float* __restrict__ gout, const float* __restrict__ stat_m,
    const float* __restrict__ stat_l, float* __restrict__ delta,
    float* __restrict__ dqkv, int S, int d, float scale, Keep keep) {
  constexpr int LD = HD + 4, NTC = HD / 16;  // n-tiles of a warp's channels
  extern __shared__ float4 smem4[];
  const Tiles<HD> s(reinterpret_cast<float*>(smem4), false);
  const long b = blockIdx.x;
  const int h = blockIdx.y, H = gridDim.y, t = threadIdx.x;
  const int q0 = blockIdx.z * T, nq = min(T, S - q0);
  const long d3 = 3L * d, base = b * S;
  const float* row = qkv + base * d3 + h * HD;

  {
    float* const dst[2] = {s.Q, s.G};
    const float* const src[2] = {row, gout + base * d + h * HD};
    const long ld[2] = {d3, d};
    stage<HD, 2>(dst, src, ld, [&](int r) { return (long)(q0 + r); }, nq);
  }
  int tag = -1;
  if (t < T) {
    float m = 0.f, li = 0.f;
    if (t < nq) {
      tag = tags.qtag(base, q0 + t);
      const long at = (base + q0 + t) * H + h;
      m = stat_m[at];
      li = 1.f / fmaxf(stat_l[at], 1e-16f);
    }
    s.qt[t] = tag;
    s.m[t] = m;
    s.li[t] = li;
  }
  int qmin, qmax;
  block_range(tag, s.range, qmin, qmax);
  cp_wait();
  __syncthreads();
  {  // delta: four threads a query, HD / 4 channels each
    const int r = t >> 2, part = t & 3;
    constexpr int CW = HD / 4;
    float de = 0.f;
    if (r < nq) {
      const float* o = out + (base + q0 + r) * d + h * HD + part * CW;
      const float* g = s.G + r * LD + part * CW;
#pragma unroll
      for (int c = 0; c < CW; c += 4)
        de = tile::dot4(tile::ld4(o + c), tile::ld4(g + c), de);
    }
    de += __shfl_xor_sync(0xffffffffu, de, 1);
    de += __shfl_xor_sync(0xffffffffu, de, 2);
    if (part == 0) {
      s.de[r] = de;
      if (r < nq) delta[(base + q0 + r) * H + h] = de;
    }
  }

  const int m0 = warp_m0(), c0 = warp_half() * (HD / 2);
  float acc[NTC][4];
#pragma unroll
  for (int nt = 0; nt < NTC; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  if (qmax >= 0) {  // the tile holds a query that can attend something
    auto sel = [&](int j) {
      const int k = tags.ktag(base, j);
      return k >= qmin && k <= qmax;  // qmin >= 0
    };
    int total;
    const int before = rank_keys(S, sel, s.scan, total);
    for (int r0 = 0; r0 < total; r0 += T) {
      const int nk = min(T, total - r0);
      list_keys(S, sel, before, r0, s.kix);
      __syncthreads();
      {
        float* const dst[2] = {s.K, s.V};
        const float* const src[2] = {row + d, row + 2 * d};
        const long ld[2] = {d3, d3};
        stage<HD, 2>(dst, src, ld, [&](int r) { return (long)s.kix[r]; },
                     nk);
      }
      if (t < T) s.kt[t] = t < nk ? tags.ktag(base, s.kix[t]) : -1;
      cp_wait();
      __syncthreads();
      pair_tile<HD, false>(s, b, h, H, S, q0, scale, keep);
      __syncthreads();
      // dQ += dS K over the chunk's keys (dS is 0 past nk, K rows zero)
      for (int k0 = 0; k0 < nk; k0 += 8) {
        unsigned ah[4], al[4], bh[2], bl[2];
        frag_a(s.dS, s.sld, 1, m0, k0, ah, al);
#pragma unroll
        for (int nt = 0; nt < NTC; ++nt) {  // B(k, n) = K[k][n]
          frag_b(s.K, LD, 1, k0, c0 + 8 * nt, bh, bl);
          mma3(acc[nt], ah, al, bh, bl);
        }
      }
      __syncthreads();  // kix, K, V and dS are overwritten next
    }
  }
  const int g = (t & 31) >> 2, tq = t & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = m0 + g + 8 * r;
    if (i >= nq) continue;
    float* o = dqkv + (base + q0 + i) * d3 + h * HD + c0 + 2 * tq;
#pragma unroll
    for (int nt = 0; nt < NTC; ++nt)
      *reinterpret_cast<float2*>(o + 8 * nt) = make_float2(
          acc[nt][2 * r] * scale, acc[nt][2 * r + 1] * scale);
  }
}

// dk, dv: one block per (row, head, z): the z-th chunk of T valid keys by
// rank, and the padding keys among tokens [zT, zT + T). dk_j = scale *
// sum_i ds_ij q_i, dv_j = sum_i p_dropped_ij dO_i; delta from the dq
// kernel.
template <int HD, class Tags, class Keep>
__device__ __forceinline__ void long_dkv(
    const float* __restrict__ qkv, Tags tags, const float* __restrict__ gout,
    const float* __restrict__ stat_m, const float* __restrict__ stat_l,
    const float* __restrict__ delta, float* __restrict__ dqkv, int S, int d,
    float scale, Keep keep) {
  constexpr int LD = HD + 4, C4 = HD / 4, NTC = HD / 16;
  extern __shared__ float4 smem4[];
  const Tiles<HD> s(reinterpret_cast<float*>(smem4), true);
  const long b = blockIdx.x;
  const int h = blockIdx.y, H = gridDim.y, t = threadIdx.x;
  const int z = blockIdx.z;
  const long d3 = 3L * d, base = b * S;
  const float* row = qkv + base * d3 + h * HD;
  float* drow = dqkv + base * d3 + h * HD;
  const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int idx = t; idx < T * C4; idx += NT) {  // padding keys of tile z
    const int j = z * T + idx / C4;
    if (j < S && tags.ktag(base, j) < 0) {
      float* o = drow + j * d3 + idx % C4 * 4;
      tile::st4(o + d, z4);
      tile::st4(o + 2 * d, z4);
    }
  }
  auto sel = [&](int j) { return tags.ktag(base, j) >= 0; };
  int total;
  const int before = rank_keys(S, sel, s.scan, total);
  const int r0 = z * T;
  if (r0 >= total) return;  // uniform: no chunk z
  const int nk = min(T, total - r0);
  list_keys(S, sel, before, r0, s.kix);
  __syncthreads();
  {
    float* const dst[2] = {s.K, s.V};
    const float* const src[2] = {row + d, row + 2 * d};
    const long ld[2] = {d3, d3};
    stage<HD, 2>(dst, src, ld, [&](int r) { return (long)s.kix[r]; }, nk);
  }
  int tag = -1;
  if (t < T) {
    tag = t < nk ? tags.ktag(base, s.kix[t]) : -1;
    s.kt[t] = tag;
  }
  int kmin, kmax;
  block_range(tag, s.range, kmin, kmax);  // kmax >= 0: nk > 0

  const int m0 = warp_m0(), c0 = warp_half() * (HD / 2);
  float dk[NTC][4], dv[NTC][4];
#pragma unroll
  for (int nt = 0; nt < NTC; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nt][e] = dv[nt][e] = 0.f;
  for (int q0 = 0; q0 < S; q0 += T) {
    const int nq = min(T, S - q0);
    int qt = -1;
    if (t < nq) qt = tags.qtag(base, q0 + t);
    if (!__syncthreads_or(qt >= kmin && qt <= kmax)) continue;  // uniform
    {
      float* const dst[2] = {s.Q, s.G};
      const float* const src[2] = {row, gout + base * d + h * HD};
      const long ld[2] = {d3, d};
      stage<HD, 2>(dst, src, ld, [&](int r) { return (long)(q0 + r); }, nq);
    }
    if (t < T) {
      float m = 0.f, li = 0.f, de = 0.f;
      if (t < nq) {
        const long at = (base + q0 + t) * H + h;
        m = stat_m[at];
        li = 1.f / fmaxf(stat_l[at], 1e-16f);
        de = delta[at];
      }
      s.qt[t] = t < nq ? qt : -1;
      s.m[t] = m;
      s.li[t] = li;
      s.de[t] = de;
    }
    cp_wait();
    __syncthreads();
    pair_tile<HD, true>(s, b, h, H, S, q0, scale, keep);
    __syncthreads();
    // dV += P_drop^T dO, dK += dS^T Q over the tile's queries (the scores
    // are 0 past nq, Q and dO rows zero)
    for (int k0 = 0; k0 < nq; k0 += 8) {
      unsigned ph[4], pl[4], sh[4], sl[4], bh[2], bl[2];
      frag_a(s.Pd, 1, s.sld, m0, k0, ph, pl);  // A(m, k) = Pd[k][m]
      frag_a(s.dS, 1, s.sld, m0, k0, sh, sl);
#pragma unroll
      for (int nt = 0; nt < NTC; ++nt) {  // B(k, n) = dO[k][n], Q[k][n]
        frag_b(s.G, LD, 1, k0, c0 + 8 * nt, bh, bl);
        mma3(dv[nt], ph, pl, bh, bl);
        frag_b(s.Q, LD, 1, k0, c0 + 8 * nt, bh, bl);
        mma3(dk[nt], sh, sl, bh, bl);
      }
    }
    // the next iteration's __syncthreads_or guards Q, G and the scores
  }
  const int g = (t & 31) >> 2, tq = t & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int jj = m0 + g + 8 * r;
    if (jj >= nk) continue;
    float* o = drow + (long)s.kix[jj] * d3 + c0 + 2 * tq;
#pragma unroll
    for (int nt = 0; nt < NTC; ++nt) {
      *reinterpret_cast<float2*>(o + d + 8 * nt) = make_float2(
          dk[nt][2 * r] * scale, dk[nt][2 * r + 1] * scale);
      *reinterpret_cast<float2*>(o + 2 * d + 8 * nt) =
          make_float2(dv[nt][2 * r], dv[nt][2 * r + 1]);
    }
  }
}

}  // namespace lr

// The two __global__ kernels of a caller (its own, with its own launch
// bounds) over lr::long_dq and lr::long_dkv.
template <class Tags, class Keep>
using LongDq = void (*)(const float*, Tags, const float*, const float*,
                        const float*, const float*, float*, float*, int, int,
                        float, Keep);
template <class Tags, class Keep>
using LongDkv = void (*)(const float*, Tags, const float*, const float*,
                         const float*, const float*, float*, int, int, float,
                         Keep);

// Launches dq, then dk/dv on one stream (delta [B, S, H] passes between
// them), raising their shared-memory limit once, before the first launch
// (one caller a Tags and Keep pair). Returns cudaGetLastError() after each
// launch.
template <int HD, class Tags, class Keep>
cudaError_t launch_long_bwd(LongDq<Tags, Keep> dq, LongDkv<Tags, Keep> dkv,
                            const float* qkv, Tags tags, const float* out,
                            const float* gout, const float* stat_m,
                            const float* stat_l, float* delta, float* dqkv,
                            int B, int S, int d, int H, Keep keep,
                            cudaStream_t stream) {
  static const cudaError_t set = [&] {
    cudaError_t e = cudaFuncSetAttribute(
        dq, cudaFuncAttributeMaxDynamicSharedMemorySize, long_dq_bytes(HD));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        dkv, cudaFuncAttributeMaxDynamicSharedMemorySize, long_dkv_bytes(HD));
  }();
  if (set != cudaSuccess) return set;
  const float scale = 1.f / sqrtf((float)HD);
  const dim3 grid(B, H, (S + LONG_T - 1) / LONG_T);
  dq<<<grid, LONG_THREADS, long_dq_bytes(HD), stream>>>(
      qkv, tags, out, gout, stat_m, stat_l, delta, dqkv, S, d, scale, keep);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv<<<grid, LONG_THREADS, long_dkv_bytes(HD), stream>>>(
      qkv, tags, gout, stat_m, stat_l, delta, dqkv, S, d, scale, keep);
  return cudaGetLastError();
}

// ---- the bf16 instances of the long-row pair ------------------------------
//
// What they compute: K2's long-row backward (rows of 129-384, code2's 384
// tier) and K3-bwd in bf16, with the rounding points of the JAX kernels in
// bf16 on the TPU (graphtrans_tpu/ops/pallas/attention_packed.py:
// _bwd_kernel; flash_hil.py:_dq_kernel, _dkv_kernel at Precision.DEFAULT,
// one bf16 MXU pass): p = exp(s - m) / l from the forward's m and l and dp
// = dO.v in float32 from the bf16 operands, dropped; dS = p (dp - delta) *
// scale and P_drop each rounded to bf16 before their products; dQ = dS K,
// dK = dS^T Q and dV = P_drop^T dO summed in float32 and rounded once.
// delta is K2's sum of the pairs' p dp (PAIRS, as the bf16 tile instance
// sums it) or K3's dO . O over the forward's rounded output. Padding tokens
// get exact zeros; every output cell has one writer, so there are no
// atomics and the bits repeat from run to run.
//
// What bounds them on the H100: at code2's bench512 the five products are
// ~10 GFLOP (0.010 ms on the bf16 tensor cores) and the bytes ~0.017 ms at
// 3.35 TB/s; what is left is instruction issue and latency: an exp and a
// dropout hash a pair in each kernel on the SM's scalar pipes, and the
// chains of products a key (query) tile. The first bf16 pair took 0.32 ms
// there, slower than SDPA's backward in bf16: its tiles were positional (a
// tile straddling two graphs took both graphs' partners pair by pair),
// every block ranked the row's tags from device memory and listed its
// partners again for every chunk, each chunk was gathered into one buffer
// behind two barriers, K2's dq kernel gathered its keys twice, and each
// pair took expf and the full hash.
//
// The design, the bf16 long forward's (attention_fwd.cuh: long_fwd16)
// applied to both kernels. A block of four warps per (row, head, tile
// slot) reads the row's tags into shared memory and finds its runs of one
// graph id (tile::find_runs; no host synchronisation). A row whose ids each form one run (ops/pack.py packs
// each graph and its CLS as one run) is cut by runs: the dq kernel cuts a
// run of n tokens into ceil(n / 64) query tiles, the dk/dv kernel into as
// many key tiles, and the row's Z = ceil(W / 64) + 1 slots take them in
// turn. A tile's partners are its run's tokens, a box of consecutive rows
// copied by 16-byte cp.async in chunks of 64 from the run's first token;
// every chunk but a run's last is whole and takes no mask. Each slot writes
// the zeros of its share of the row's padding tokens. A warp owns 16 rows
// of the tile whole: every product a bf16 mma.sync m16n8k16 with float32
// sums, operands by ldmatrix, and p and dS moved from the score
// accumulators into the next product's A fragment in registers. K2 (rows of
// at most 384) stages a tile's partners whole, each chunk its own cp.async
// group: the dq kernel's delta sweep takes chunk c as soon as it lands,
// and its dS and dQ sweep reads shared memory only, so each key is gathered
// once. K3's partners stream through a ring of BWD16_STAGES chunk buffers:
// chunk c's products run while chunks c + 1 and c + 2 load, one barrier a
// chunk. The dq kernel writes, per query, a record of four floats: m
// log2(e), 1 / (l (1 - rate)), delta (1 - rate) and the row's part of the
// dropout hash; the dk/dv kernel copies a chunk's records with its Q rows,
// into the 16 bytes of padding each staged row carries. exp(s - m) is one
// FFMA and the SFU's ex2, 1/l its reciprocal, the dropout's 1 / (1 - rate)
// rides in 1/l (a kept pair's P_drop is p itself and dS = p (dp - delta (1
// - rate)) scale), and the dropout hash of a pair is its query's part plus
// its key's (the mask policy's Split). K2's delta sweep keeps a thread's
// eight keep bits of a 16-key tile in the padding of the tile's staged K
// rows, so its dS sweep hashes nothing. A row where an id forms two
// runs (dq16_general, dkv16_general, out of line) keeps the positional
// tiles and the partners whose tag lies between the tile's least and
// greatest tag, listed by rank once a tile and masked pair by pair.

constexpr int LONG16_THREADS = 128;        // four warps, 16 rows each
constexpr int LONG16_HD = tile::SEG16_HD;  // heads of 32 (K2's, K3's)
constexpr int LONG16_LD = tile::SEG16_LD;  // bf16 a staged row
constexpr int BWD16_STAGES = 3;            // K3's ring: partner chunks
constexpr int BWD16_MISC = 16;             // ints of a block's scratch

// Partner rows a block stages: K2 (`whole`) a row's tokens rounded up to
// whole chunks, K3 its ring.
__host__ __device__ constexpr int bwd16_rows(int W, bool whole) {
  return whole ? (W + LONG_T - 1) / LONG_T * LONG_T : BWD16_STAGES * LONG_T;
}

// Shared bytes of a block of either kernel on rows of W tokens: the tile's
// own two 64-row slices and the partners' two as bf16 rows of LONG16_LD
// (a staged Q row carries its query's record in its padding); the row's
// tags and a -1 past them; its runs' first tokens and lengths (the
// partner list, in a row where an id forms two runs); the scratch. K2 at
// W 384 takes 76,356 bytes (three blocks an SM), K3 at W 1024 53,316.
__host__ __device__ constexpr int bwd16_bytes(int W, bool whole) {
  return (2 * LONG_T + 2 * bwd16_rows(W, whole)) * LONG16_LD * 2 +
         (3 * W + 1 + BWD16_MISC) * 4;
}

// A wrapper's launch of either kernel of the bf16 pair: a block of
// LONG16_THREADS per (row, head, tile slot), ceil(W / LONG_T) + 1 slots a
// row, as the bf16 long forward's.
__host__ inline bool bwd16_launch_ok(const tile::Launch& L, int B, int W,
                                     int H, bool whole) {
  return L.pad == LONG_T && L.group == 1 && L.gx == B && L.gy == H &&
         L.gz == (W + LONG_T - 1) / LONG_T + 1 &&
         L.threads == LONG16_THREADS && L.smem == bwd16_bytes(W, whole) &&
         L.smem <= tile::SMEM_MAX;
}

namespace lr {

using tc::cp_commit;
using tc::cp_wait_group;

template <bool B>
struct Bool {  // a compile-time flag as an argument
  static constexpr bool value = B;
};
template <int N>
struct Int {  // a compile-time int as an argument
  static constexpr int value = N;
};

// At most n cp.async groups still in flight (above 7: 7, which waits for
// more).
__device__ __forceinline__ void cp_wait_upto(int n) {
  switch (n) {
    case 0: cp_wait_group<0>(); break;
    case 1: cp_wait_group<1>(); break;
    case 2: cp_wait_group<2>(); break;
    case 3: cp_wait_group<3>(); break;
    case 4: cp_wait_group<4>(); break;
    case 5: cp_wait_group<5>(); break;
    case 6: cp_wait_group<6>(); break;
    default: cp_wait_group<7>(); break;
  }
}

constexpr float LOG2E = 1.4426950408889634f;

// 2^x: the SFU's ex2 (relative error below 2^-22; 2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// e^x for x = s - m, given s and ml = m log2(e): one FFMA and the SFU's
// ex2, as flash attention kernels take it, in place of expf's dozen
// instructions a pair.
__device__ __forceinline__ float exp_ml(float s, float ml) {
  return ex2(fmaf(s, LOG2E, -ml));
}

// 1 / x for x >= 1e-16 (the normalisers): the SFU's reciprocal, within an
// ulp, with no call into the division's slow path (whose register saves
// would spill)
__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A fragments of 16 rows (m0..) of a staged tile: channels 0-15, 16-31.
__device__ __forceinline__ void a_rows16(unsigned (&a)[2][4],
                                         const tile::bf16* X, int m0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
    tile::ldsm4(a[ks], X + (m0 + (lane & 15)) * LONG16_LD + 16 * ks +
                           8 * (lane >> 4));
}

// acc += A B over 16 staged rows (k0..) of B, 32 channels: A an m16k16
// fragment, B k-major rows (ldmatrix .trans).
__device__ __forceinline__ void times_rows16(float (&acc)[4][4],
                                             const unsigned (&a)[4],
                                             const tile::bf16* B, int k0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int cc = 0; cc < 2; ++cc) {
    unsigned r[4];
    tile::ldsm4t(r, B + (k0 + (lane & 15)) * LONG16_LD + 16 * cc +
                        8 * (lane >> 4));
    tile::mma16(acc[2 * cc], a, r[0], r[1]);
    tile::mma16(acc[2 * cc + 1], a, r[2], r[3]);
  }
}

// c = A B^T for 16 rows x 8 staged rows (n0..) of B, over 32 channels: A
// the m16k16 fragments of channels 0-15 and 16-31.
__device__ __forceinline__ void dots8(float (&c)[4], const unsigned (&a)[2][4],
                                      const tile::bf16* B, int n0) {
  const int lane = threadIdx.x & 31;
  unsigned r[4];
  tile::ldsm4(r, B + (n0 + (lane & 7)) * LONG16_LD + 8 * (lane >> 3));
  c[0] = c[1] = c[2] = c[3] = 0.f;
  tile::mma16(c, a[0], r[0], r[1]);
  tile::mma16(c, a[1], r[2], r[3]);
}

// The shared memory of a block of the bf16 pair.
struct Bwd16Tiles {
  tile::bf16 *X0, *X1;  // the tile's own rows: dq Q, dO; dk/dv K, V
  tile::bf16 *Y0, *Y1;  // the partners' rows: dq K, V; dk/dv Q (and its
                        // record), dO
  int* tg;              // the row's tags, tg[W] = -1
  int *s0, *len;        // runs: first token, length (s0: the partner list)
  int* misc;            // [0] runs; [2, 4) block_range; [4, ...) scan

  __device__ Bwd16Tiles(float4* s, int W, bool whole) {
    constexpr int R = LONG_T * LONG16_LD;
    const int pr = bwd16_rows(W, whole) * LONG16_LD;
    X0 = reinterpret_cast<tile::bf16*>(s);
    X1 = X0 + R;
    Y0 = X1 + R;
    Y1 = Y0 + pr;
    tg = reinterpret_cast<int*>(Y1 + pr);
    s0 = tg + W + 1;
    len = s0 + W;
    misc = len + W;
  }
};

// One (row, head)'s slices: qkv, out, gout and dqkv at the row's first
// token and the head's lanes; the forward's m and l at the row's first
// token (stride H); the records of the (row, head)'s tokens.
struct Bwd16Row {
  const tile::bf16 *qkv, *out, *gout;
  const float *m, *l;
  float4* rec;
  tile::bf16* dqkv;
  int d, H;

  __device__ Bwd16Row(const tile::bf16* qkv_, const tile::bf16* out_,
                      const tile::bf16* gout_, const float* m_,
                      const float* l_, float* rec_, tile::bf16* dqkv_, int W,
                      int d_)
      : d(d_), H(gridDim.y) {
    const long b = blockIdx.x, base = b * W;
    const int h = blockIdx.y, c = h * LONG16_HD;
    qkv = qkv_ + base * 3 * d + c;
    out = out_ ? out_ + base * d + c : nullptr;
    gout = gout_ + base * d + c;
    m = m_ ? m_ + base * H + h : nullptr;
    l = l_ ? l_ + base * H + h : nullptr;
    rec = reinterpret_cast<float4*>(rec_) + (b * H + h) * W;
    dqkv = dqkv_ + base * 3 * d + c;
  }
};

// dO . O over a row's 32 channels, lane q of a quad taking channels 8q ..
// 8q + 7 (the quad's sum by tile::quad_sum)
__device__ __forceinline__ float dot8(const tile::bf16* o,
                                      const tile::bf16* g) {
  const uint4 ov = *reinterpret_cast<const uint4*>(o);
  const uint4 gv = *reinterpret_cast<const uint4*>(g);
  const unsigned* o2 = reinterpret_cast<const unsigned*>(&ov);
  const unsigned* g2 = reinterpret_cast<const unsigned*>(&gv);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o2 + k));
    const float2 e =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g2 + k));
    s = fmaf(a.x, e.x, s);
    s = fmaf(a.y, e.y, s);
  }
  return s;
}

// One query tile of the dq kernel: queries q0 .. q0 + nq - 1 (nq <= 64),
// `total` keys, key r the token kix[r] (GEN, masked by the tags) or k0 + r
// (the tile's run: every pair meets). Writes the tile's dq rows and its
// queries' records (m log2(e), 1 / (l (1 - rate)), delta (1 - rate), the
// hash's row part). Every thread of the block calls it; a warp whose rows
// all lie past nq stages and waits, nothing more.
template <bool PAIRS, bool GEN, bool DROP, class Split>
__device__ __forceinline__ void dq16_tile(const Bwd16Tiles& s,
                                          const Bwd16Row& w, int q0, int nq,
                                          const int* kix, int k0, int total,
                                          float scale, const Split& kept,
                                          float inv_keep) {
  using tile::bf16;
  constexpr int LD = LONG16_LD, NTH = LONG16_THREADS, NS = BWD16_STAGES;
  const int t = threadIdx.x, lane = t & 31, m0 = (t >> 5) * 16;
  const int g = lane >> 2, q = lane & 3, d = w.d, d3 = 3 * d;
  const bool live = m0 < nq;  // uniform in the warp
  const int chunks = (total + T - 1) / T;
  const float sl = scale * LOG2E;  // s log2(e) from the unscaled q.k
  const float keep_rate = rcp(inv_keep);  // 1 - rate
  auto tok = [&](int r) -> int {
    if constexpr (GEN)
      return kix[r];
    else
      return k0 + r;
  };

  // the thread's two rows (m0 + g, m0 + g + 8): tag, m log2(e), 1/l times
  // the dropout's 1 / (1 - rate) (p below is then a kept pair's P_drop),
  // the hash's row part and, for K3, delta = dO . O times (1 - rate); 0
  // for a row without keys
  int tag[2] = {-1, -1};
  float ml[2] = {0.f, 0.f}, li[2] = {0.f, 0.f}, de[2] = {0.f, 0.f};
  unsigned at[2] = {0u, 0u};
  if (live) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = m0 + g + 8 * r, tk = q0 + i;
      if (i >= nq) continue;
      tag[r] = s.tg[tk];
      if (tag[r] >= 0) {  // a valid query attends itself: l >= 1
        ml[r] = w.m[(long)tk * w.H] * LOG2E;
        li[r] = rcp(fmaxf(w.l[(long)tk * w.H], 1e-16f)) * inv_keep;
        if constexpr (!PAIRS)
          de[r] = dot8(w.out + (long)tk * d + 8 * q,
                       w.gout + (long)tk * d + 8 * q);
      }
      if constexpr (DROP) at[r] = kept.at(tk);
    }
    if constexpr (!PAIRS) {
      tile::quad_sum(de);
      de[0] *= keep_rate;  // delta (1 - rate)
      de[1] *= keep_rate;
    }
  }

  auto stage_q = [&] {
    for (int idx = t; idx < T * 4; idx += NTH) {
      const int r = idx >> 2, c = (idx & 3) * 8;
      const bool ok = r < nq;
      const long tk = ok ? q0 + r : 0;
      tile::cp16(s.X0 + r * LD + c, w.qkv + tk * d3 + c, ok);
      tile::cp16(s.X1 + r * LD + c, w.gout + tk * d + c, ok);
    }
  };
  // keys r0 .. r0 + T - 1 (zeros from total on) into chunk buffer `slot`
  auto stage_keys = [&](int slot, int r0) {
    bf16* K = s.Y0 + slot * T * LD;
    bf16* V = s.Y1 + slot * T * LD;
    for (int idx = t; idx < T * 4; idx += NTH) {
      const int r = idx >> 2, c = (idx & 3) * 8;
      const bool ok = r0 + r < total;
      const long tk = ok ? tok(r0 + r) : 0;
      tile::cp16(K + r * LD + c, w.qkv + tk * d3 + d + c, ok);
      tile::cp16(V + r * LD + c, w.qkv + tk * d3 + 2 * d + c, ok);
    }
  };
  // The chunk in buffer `slot` (keys r0..): for each of its 16-key tiles k,
  // fn(k, K, p, dp) with p = exp(s - m) / (l (1 - rate)) (0 where the pair
  // does not meet) and dp = dO.v where the pair is kept, else 0; FULL: the
  // chunk is whole (no key masked). The keep bits: MODE 0 hashes each pair,
  // 1 also saves a thread's eight bits of a key tile in the padding of the
  // tile's staged K rows, 2 reads them back (K2's second sweep).
  auto chunk = [&](int slot, int r0, auto whole, auto mode, auto&& fn) {
    constexpr bool FULL = decltype(whole)::value;
    constexpr int MODE = decltype(mode)::value;
    bf16* K = s.Y0 + slot * T * LD;
    const bf16* V = s.Y1 + slot * T * LD;
    const int nk = FULL ? T : min(T, total - r0);
    const int nkt = FULL ? 4 : (nk + 15) >> 4;
    unsigned qa[2][4], ga[2][4];
    a_rows16(qa, s.X0, m0);  // reread a chunk: no registers held
    a_rows16(ga, s.X1, m0);
#pragma unroll 1
    for (int k = 0; k < 4; ++k) {
      if (k >= nkt) break;
      // the thread's byte of keep bits: rows 16 k + t / 16 of the tile's
      // K rows, past their channels
      unsigned char* kb = reinterpret_cast<unsigned char*>(
                              K + (16 * k + (t >> 4)) * LD + LONG16_HD) +
                          (t & 15);
      unsigned bits = 0u;
      if constexpr (DROP && MODE == 2) bits = *kb;
      float p[2][4], dp[2][4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int kk = 16 * k + 8 * hf;  // the half's first key
        dots8(p[hf], qa, K, kk);
        dots8(dp[hf], ga, V, kk);
        unsigned cj[2] = {0u, 0u};  // DROP: the keys' parts of the hash
        int kt[2] = {0, 0};         // GEN: the keys' tags
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int j = kk + 2 * q + cc;
          const bool in = FULL || j < nk;
          if constexpr (GEN) {
            const int tk = in ? kix[r0 + j] : 0;
            kt[cc] = in ? s.tg[tk] : -1;
            if constexpr (DROP && MODE != 2) cj[cc] = kept.col(tk);
          } else {
            kt[cc] = in;
            if constexpr (DROP && MODE != 2) cj[cc] = kept.col(k0 + r0 + j);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, cc = e & 1;
          bool meet;
          if constexpr (GEN)
            meet = tag[r] >= 0 && tag[r] == kt[cc];
          else
            meet = FULL || kt[cc];
          p[hf][e] = meet ? ex2(fmaf(p[hf][e], sl, -ml[r])) * li[r] : 0.f;
          if constexpr (DROP) {
            bool on;
            if constexpr (MODE == 2) {
              on = bits >> (4 * hf + e) & 1u;
            } else {
              on = kept.keeps(at[r] + cj[cc]);
              if constexpr (MODE == 1) bits |= (unsigned)on << (4 * hf + e);
            }
            dp[hf][e] = on ? dp[hf][e] : 0.f;
          }
        }
      }
      if constexpr (DROP && MODE == 1) *kb = (unsigned char)bits;
      fn(k, K, p, dp);
    }
  };
  // delta's sweep (PAIRS): the kept pairs' p dp (1 - rate), taken as p dp
  // here and scaled with the row's delta below
  auto sums = [&](int, const bf16*, const float(&p)[2][4],
                  const float(&dp)[2][4]) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        de[e >> 1] = fmaf(p[hf][e], dp[hf][e], de[e >> 1]);
  };
  // dQ += dS K over a 16-key tile, dS = p (dp - delta (1 - rate)) scale
  // (= p_undropped (dp_dropped - delta) scale) rounded to bf16 in the A
  // fragment
  float dq[4][4] = {};
  auto grads = [&](int k, const bf16* K, float(&p)[2][4],
                   const float(&dp)[2][4]) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[hf][e] = p[hf][e] * (dp[hf][e] - de[e >> 1]) * scale;
    unsigned a[4];
    tile::a_frag(a, p);
    times_rows16(dq, a, K, 16 * k);
  };
  // chunk c (keys c T..) in buffer `slot` through fn, the keep bits as
  // `mode` says
  auto run_chunk = [&](int slot, int c, auto mode, auto&& fn) {
    if (total - c * T >= T)
      chunk(slot, c * T, Bool<true>{}, mode, fn);
    else
      chunk(slot, c * T, Bool<false>{}, mode, fn);
  };

  if (chunks > 0) {
    stage_q();  // lands with the first chunk's group
    if constexpr (PAIRS) {
      // every key once: chunk c's K and V in group c
      for (int c = 0; c < chunks; ++c) {
        stage_keys(c, c * T);
        cp_commit();
      }
      for (int c = 0; c < chunks; ++c) {  // delta, saving the keep bits
        cp_wait_upto(chunks - 1 - c);     // chunk c (and Q, dO) landed
        __syncthreads();
        if (live) run_chunk(c, c, Int<1>{}, sums);
      }
      if (live) {
        tile::quad_sum(de);
        de[0] *= keep_rate;
        de[1] *= keep_rate;
#pragma unroll 1
        for (int c = 0; c < chunks; ++c) run_chunk(c, c, Int<2>{}, grads);
      }
    } else {
      // the ring: chunk c in buffer c % NS, loaded NS - 1 chunks ahead
#pragma unroll
      for (int c = 0; c < NS - 1; ++c) {
        if (c < chunks) stage_keys(c, c * T);
        cp_commit();
      }
      for (int c = 0; c < chunks; ++c) {
        cp_wait_group<NS - 2>();  // chunk c (and Q, dO) have landed
        __syncthreads();          // and buffer (c - 1) % NS is free
        if (c + NS - 1 < chunks)
          stage_keys((c + NS - 1) % NS, (c + NS - 1) * T);
        cp_commit();
        if (live) run_chunk(c % NS, c, Int<0>{}, grads);
      }
      cp_wait_group<0>();
    }
  }
  if (!live) return;
  tile::store_rows16(w.dqkv + (long)(q0 + m0) * d3, d3, dq, nq - m0);
  if (q == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (m0 + g + 8 * r < nq)
        w.rec[q0 + m0 + g + 8 * r] =
            make_float4(ml[r], li[r], de[r], __uint_as_float(at[r]));
}

// One key tile of the dk/dv kernel: keys k0 .. k0 + nk - 1 (nk <= 64),
// `total` queries, query r the token qix[r] (GEN, masked by the tags) or
// q0 + r (the tile's run). Writes the tile's dk and dv rows from the
// queries' records (dq16_tile's). Every thread of the block calls it.
template <bool PAIRS, bool GEN, bool DROP, class Split>
__device__ __forceinline__ void dkv16_tile(const Bwd16Tiles& s,
                                           const Bwd16Row& w, int k0, int nk,
                                           const int* qix, int q0, int total,
                                           float scale, const Split& kept) {
  using tile::bf16;
  constexpr int LD = LONG16_LD, NTH = LONG16_THREADS, NS = BWD16_STAGES;
  const int t = threadIdx.x, lane = t & 31, m0 = (t >> 5) * 16;
  const int g = lane >> 2, q = lane & 3, d = w.d, d3 = 3 * d;
  const bool live = m0 < nk;  // uniform in the warp
  const int chunks = (total + T - 1) / T;
  const float sl = scale * LOG2E;
  auto tok = [&](int r) -> int {
    if constexpr (GEN)
      return qix[r];
    else
      return q0 + r;
  };
  int ktag[2] = {0, 0};       // GEN: the thread's two keys' tags
  unsigned cj[2] = {0u, 0u};  // DROP: their parts of the hash
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = m0 + g + 8 * r;
    if constexpr (GEN) ktag[r] = j < nk ? s.tg[k0 + j] : -1;
    if constexpr (DROP) cj[r] = kept.col(k0 + j);
  }

  auto stage_k = [&] {
    for (int idx = t; idx < T * 4; idx += NTH) {
      const int r = idx >> 2, c = (idx & 3) * 8;
      const bool ok = r < nk;
      const long tk = ok ? k0 + r : 0;
      tile::cp16(s.X0 + r * LD + c, w.qkv + tk * d3 + d + c, ok);
      tile::cp16(s.X1 + r * LD + c, w.qkv + tk * d3 + 2 * d + c, ok);
    }
  };
  // queries r0 .. r0 + T - 1 (zeros from total on) into chunk buffer
  // `slot`: Q rows with the query's record in their padding, dO rows
  auto stage_part = [&](int slot, int r0) {
    bf16* Qd = s.Y0 + slot * T * LD;
    bf16* Gd = s.Y1 + slot * T * LD;
    for (int idx = t; idx < T * 4; idx += NTH) {
      const int r = idx >> 2, c = (idx & 3) * 8;
      const bool ok = r0 + r < total;
      const long tk = ok ? tok(r0 + r) : 0;
      tile::cp16(Qd + r * LD + c, w.qkv + tk * d3 + c, ok);
      tile::cp16(Gd + r * LD + c, w.gout + tk * d + c, ok);
      if (c == 0)
        tc::cp16(reinterpret_cast<float*>(Qd + r * LD + LONG16_HD),
                 reinterpret_cast<const float*>(w.rec + tk), ok);
    }
  };
  float dk[4][4] = {}, dv[4][4] = {};
  // The chunk in buffer `slot` (queries r0..): dV += P_drop^T dO and dK +=
  // dS^T Q over its 16-query tiles; a zero row (past the run) has a zero
  // record, so its p is 0; FULL: the chunk is whole.
  auto chunk = [&](int slot, int r0, auto whole) {
    constexpr bool FULL = decltype(whole)::value;
    const bf16* Qc = s.Y0 + slot * T * LD;
    const bf16* Gc = s.Y1 + slot * T * LD;
    const int nq = FULL ? T : min(T, total - r0);
    const int nqt = FULL ? 4 : (nq + 15) >> 4;
    unsigned ka[2][4], va[2][4];
    a_rows16(ka, s.X0, m0);  // reread a chunk: no registers held
    a_rows16(va, s.X1, m0);
#pragma unroll 1
    for (int it = 0; it < 4; ++it) {
      if (it >= nqt) break;
      float pd[2][4], ds[2][4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i0 = 16 * it + 8 * hf;
        float sc[4], tp[4];
        dots8(sc, ka, Qc, i0);  // s^T: keys x queries
        dots8(tp, va, Gc, i0);  // dp^T
        float4 rq[2];           // the two queries' records
        int qt[2] = {0, 0};     // GEN: their tags
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int i = i0 + 2 * q + cc;
          rq[cc] = *reinterpret_cast<const float4*>(Qc + i * LD + LONG16_HD);
          if constexpr (GEN) qt[cc] = FULL || i < nq ? s.tg[qix[r0 + i]] : -1;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, cc = e & 1;
          bool meet = true;
          if constexpr (GEN) meet = qt[cc] >= 0 && qt[cc] == ktag[r];
          const float p =
              meet ? ex2(fmaf(sc[e], sl, -rq[cc].x)) * rq[cc].y : 0.f;
          float pv = p, dpv = tp[e];  // p = p_undropped / (1 - rate)
          if constexpr (DROP) {
            const bool on = kept.keeps(__float_as_uint(rq[cc].w) + cj[r]);
            pv = on ? p : 0.f;
            dpv = on ? dpv : 0.f;
          }
          pd[hf][e] = pv;
          ds[hf][e] = p * (dpv - rq[cc].z) * scale;
        }
      }
      unsigned pa[4], sa[4];
      tile::a_frag(pa, pd);
      tile::a_frag(sa, ds);
      times_rows16(dv, pa, Gc, 16 * it);
      times_rows16(dk, sa, Qc, 16 * it);
    }
  };
  auto run_chunk = [&](int slot, int c) {
    if (total - c * T >= T)
      chunk(slot, c * T, Bool<true>{});
    else
      chunk(slot, c * T, Bool<false>{});
  };

  if (chunks > 0) {
    stage_k();  // lands with the first chunk's group
    if constexpr (PAIRS) {
      // every query once: chunk c in group c
      for (int c = 0; c < chunks; ++c) {
        stage_part(c, c * T);
        cp_commit();
      }
      for (int c = 0; c < chunks; ++c) {
        cp_wait_upto(chunks - 1 - c);  // chunk c (and K, V) landed
        __syncthreads();
        if (live) run_chunk(c, c);
      }
    } else {
#pragma unroll
      for (int c = 0; c < NS - 1; ++c) {
        if (c < chunks) stage_part(c, c * T);
        cp_commit();
      }
      for (int c = 0; c < chunks; ++c) {
        cp_wait_group<NS - 2>();  // chunk c (and K, V) have landed
        __syncthreads();          // and buffer (c - 1) % NS is free
        if (c + NS - 1 < chunks)
          stage_part((c + NS - 1) % NS, (c + NS - 1) * T);
        cp_commit();
        if (live) run_chunk(c % NS, c);
      }
      cp_wait_group<0>();
    }
  }
  if (!live) return;
  bf16* o = w.dqkv + (long)(k0 + m0) * d3;
  tile::store_rows16(o + d, d3, dk, nk - m0);
  tile::store_rows16(o + 2 * d, d3, dv, nk - m0);
}

// The positional tiles of a row where an id forms two runs (out of line,
// so that their registers do not weigh on the runs' tiles; they take only
// the kernel's arguments and find the rest again): slot z takes tiles z, z
// + Z, ...; a tile's partners are the tokens whose tag lies between its
// least and greatest tag, listed by rank once a tile into s0, masked pair
// by pair. total is 0 for a tile of padding only.
template <class Fn>
__device__ __forceinline__ void general_tiles(const Bwd16Tiles& s, int W,
                                              Fn&& fn) {
  const int t = threadIdx.x;
  for (int zt = blockIdx.z; zt * LONG_T < W; zt += gridDim.z) {
    const int r0 = zt * LONG_T, n = min(LONG_T, W - r0);
    __syncthreads();  // the previous tile's reads of the shared tiles
    int lo, hi;
    block_range(t < n ? s.tg[r0 + t] : -1, s.misc + 2, lo, hi);
    int total = 0;
    if (hi >= 0) {  // uniform: the tile holds a token that meets another
      auto sel = [&](int j) {
        const int k = s.tg[j];
        return k >= lo && k <= hi;  // lo >= 0
      };
      int r = rank_keys(W, sel, s.misc + 4, total);
      const int per = (W + LONG16_THREADS - 1) / LONG16_THREADS;
      const int j0 = min(W, t * per), j1 = min(W, j0 + per);
      for (int j = j0; j < j1; ++j)  // the partner list, once a tile
        if (sel(j)) s.s0[r++] = j;
      __syncthreads();
    }
    fn(r0, n, total);
  }
}

template <bool PAIRS, bool DROP, class Keep>
__device__ __noinline__ void dq16_general(
    const tile::bf16* __restrict__ qkv, const tile::bf16* __restrict__ out,
    const tile::bf16* __restrict__ gout, const float* __restrict__ stat_m,
    const float* __restrict__ stat_l, float* __restrict__ rec,
    tile::bf16* __restrict__ dqkv, int W, int d, float scale, Keep keep) {
  extern __shared__ float4 smem4[];
  const Bwd16Tiles s(smem4, W, PAIRS);
  const Bwd16Row w(qkv, out, gout, stat_m, stat_l, rec, dqkv, W, d);
  const auto kept = keep.split(blockIdx.x, blockIdx.y, gridDim.y, W);
  general_tiles(s, W, [&](int q0, int nq, int total) {
    dq16_tile<PAIRS, true, DROP>(s, w, q0, nq, s.s0, 0, total, scale, kept,
                                 keep.inv_keep);
  });
}

template <bool PAIRS, bool DROP, class Keep>
__device__ __noinline__ void dkv16_general(
    const tile::bf16* __restrict__ qkv, const tile::bf16* __restrict__ gout,
    float* __restrict__ rec, tile::bf16* __restrict__ dqkv, int W, int d,
    float scale, Keep keep) {
  extern __shared__ float4 smem4[];
  const Bwd16Tiles s(smem4, W, PAIRS);
  const Bwd16Row w(qkv, nullptr, gout, nullptr, nullptr, rec, dqkv, W, d);
  const auto kept = keep.split(blockIdx.x, blockIdx.y, gridDim.y, W);
  general_tiles(s, W, [&](int k0, int nk, int total) {
    dkv16_tile<PAIRS, true, DROP>(s, w, k0, nk, s.s0, 0, total, scale,
                                  kept);
  });
}

// The row's tags into shared memory and its runs: false where an id forms
// two runs. Every thread of the block calls it.
__device__ __forceinline__ bool bwd16_runs(const Bwd16Tiles& s,
                                           const int* __restrict__ seg,
                                           int W) {
  for (int i = threadIdx.x; i <= W; i += LONG16_THREADS)
    s.tg[i] = i < W ? seg[(long)blockIdx.x * W + i] : -1;
  return !tile::find_runs(s.tg, W, s.s0, s.len, s.misc);
}

// The runs' 64-token tiles of a row whose ids each form one run, this
// slot's in turn: fn(first token of the tile, its tokens, the run's first
// token, the run's length). Before, the slot's share of the row's padding
// tokens goes to zero(token).
template <class Zero, class Fn>
__device__ __forceinline__ void run_tiles(const Bwd16Tiles& s, int W,
                                          Zero&& zero, Fn&& fn) {
  const int t = threadIdx.x, z = blockIdx.z, Z = gridDim.z;
  {  // this slot's share of the row's padding tokens
    const int per = (W + Z - 1) / Z, p0 = min(W, z * per);
    const int p1 = min(W, p0 + per);
    for (int idx = t; idx < (p1 - p0) * 4; idx += LONG16_THREADS) {
      const int i = p0 + (idx >> 2);
      if (s.tg[i] < 0) zero(i, (idx & 3) * 8);
    }
  }
  const int runs = s.misc[0];
  for (int it = z;; it += Z) {
    int k = 0, first = 0;
    for (; k < runs; ++k) {
      const int n = (s.len[k] + LONG_T - 1) / LONG_T;
      if (it < first + n) break;
      first += n;
    }
    if (k == runs) break;
    const int k0 = s.s0[k], n = s.len[k], r0 = k0 + (it - first) * LONG_T;
    __syncthreads();  // the previous tile's reads of the shared tiles
    fn(r0, min(LONG_T, k0 + n - r0), k0, n);
  }
}

}  // namespace lr

// dq: one block of four warps per (row, head, tile slot) on rows of W
// tokens, seg [B, W] the graph ids: dq of every token (0 for padding) and
// the records rec [B, H, W, 4] the dk/dv kernel reads (m log2(e), 1/l,
// delta, the hash's row part). PAIRS: K2 (delta from the pairs, keys staged
// whole); else K3 (delta = dO . O, keys through the ring).
template <bool PAIRS, bool DROP, class Keep>
__device__ __forceinline__ void long_dq16(
    const tile::bf16* __restrict__ qkv, const int* __restrict__ seg,
    const tile::bf16* __restrict__ out, const tile::bf16* __restrict__ gout,
    const float* __restrict__ stat_m, const float* __restrict__ stat_l,
    float* __restrict__ rec, tile::bf16* __restrict__ dqkv, int W, int d,
    float scale, Keep keep) {
  using namespace lr;
  extern __shared__ float4 smem4[];
  const Bwd16Tiles s(smem4, W, PAIRS);
  if (!bwd16_runs(s, seg, W)) {  // an id in two runs
    dq16_general<PAIRS, DROP>(qkv, out, gout, stat_m, stat_l, rec, dqkv, W, d,
                              scale, keep);
    return;
  }
  const Bwd16Row w(qkv, out, gout, stat_m, stat_l, rec, dqkv, W, d);
  const auto kept = keep.split(blockIdx.x, blockIdx.y, gridDim.y, W);
  run_tiles(
      s, W,
      [&](int i, int c) {
        *reinterpret_cast<uint4*>(w.dqkv + (long)i * 3 * d + c) =
            make_uint4(0u, 0u, 0u, 0u);
      },
      [&](int q0, int nq, int k0, int n) {
        dq16_tile<PAIRS, false, DROP>(s, w, q0, nq, nullptr, k0, n, scale,
                                      kept, keep.inv_keep);
      });
}

// dk, dv: one block of four warps per (row, head, tile slot): dk and dv of
// every token (0 for padding) from the dq kernel's records.
template <bool PAIRS, bool DROP, class Keep>
__device__ __forceinline__ void long_dkv16(
    const tile::bf16* __restrict__ qkv, const int* __restrict__ seg,
    const tile::bf16* __restrict__ gout, float* __restrict__ rec,
    tile::bf16* __restrict__ dqkv, int W, int d, float scale, Keep keep) {
  using namespace lr;
  extern __shared__ float4 smem4[];
  const Bwd16Tiles s(smem4, W, PAIRS);
  if (!bwd16_runs(s, seg, W)) {
    dkv16_general<PAIRS, DROP>(qkv, gout, rec, dqkv, W, d, scale, keep);
    return;
  }
  const Bwd16Row w(qkv, nullptr, gout, nullptr, nullptr, rec, dqkv, W, d);
  const auto kept = keep.split(blockIdx.x, blockIdx.y, gridDim.y, W);
  run_tiles(
      s, W,
      [&](int i, int c) {
        tile::bf16* o = w.dqkv + (long)i * 3 * d + c;
        *reinterpret_cast<uint4*>(o + d) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(o + 2 * d) = make_uint4(0u, 0u, 0u, 0u);
      },
      [&](int k0, int nk, int r0, int n) {
        dkv16_tile<PAIRS, false, DROP>(s, w, k0, nk, nullptr, r0, n, scale,
                                       kept);
      });
}

// The two __global__ kernels of a caller's bf16 pair (its own, with its
// own launch bounds) over long_dq16 and long_dkv16.
template <class Keep>
using Dq16 = void (*)(const tile::bf16*, const int*, const tile::bf16*,
                      const tile::bf16*, const float*, const float*, float*,
                      tile::bf16*, int, int, float, Keep);
template <class Keep>
using Dkv16 = void (*)(const tile::bf16*, const int*, const tile::bf16*,
                       float*, tile::bf16*, int, int, float, Keep);

// Launches the bf16 dq kernel, then the dk/dv kernel, on one stream (the
// records rec [B, H, W, 4] pass between them), at the wrapper's launch L
// (checked by the caller with bwd16_launch_ok). Returns cudaGetLastError()
// after each.
template <class Keep>
cudaError_t launch_long_bwd16(Dq16<Keep> dq, Dkv16<Keep> dkv,
                              const tile::bf16* qkv, const int* seg,
                              const tile::bf16* out, const tile::bf16* gout,
                              const float* stat_m, const float* stat_l,
                              float* rec, tile::bf16* dqkv, int W, int d,
                              const tile::Launch& L, Keep keep,
                              cudaStream_t stream) {
  const float scale = 1.f / sqrtf((float)LONG16_HD);
  const dim3 grid(L.gx, L.gy, L.gz);
  dq<<<grid, L.threads, L.smem, stream>>>(qkv, seg, out, gout, stat_m, stat_l,
                                          rec, dqkv, W, d, scale, keep);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv<<<grid, L.threads, L.smem, stream>>>(qkv, seg, gout, rec, dqkv, W, d,
                                           scale, keep);
  return cudaGetLastError();
}

}  // namespace attn
