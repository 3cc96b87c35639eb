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
// bf16 on the TPU (graphtrans_tpu/ops/pallas/attention_packed.py:238-286;
// flash_hil.py:_dq_kernel, _dkv_kernel at Precision.DEFAULT, one bf16 MXU
// pass): p = exp(s - m) / l from the forward's m and l and dp = dO.v in
// float32 from the bf16 operands, dropped; dS = p (dp - delta) * scale and
// P_drop each rounded to bf16 before their products; dQ = dS K, dK = dS^T
// Q and dV = P_drop^T dO summed in float32 and rounded once. delta is K2's
// sum of the pairs' p dp (DELTA_PAIRS, as the bf16 tile instance sums it)
// or K3's dO . O over the forward's rounded output. Their Keep policy has,
// besides on and inv_keep, row(b, h, H, S): a functor (i, j) -> kept with
// the row's seed computed once a block (K2's Dropout::row, K3's).
//
// The design: the long f32 pair's cut (a dq kernel over 64-query tiles, a
// dk/dv kernel over chunks of 64 valid keys by rank, the other side
// gathered 64 rows at a time by rank, every output cell one writer) with
// the bf16 tile instance's products: bf16 rows staged by cp.async (rows of
// tile::SEG16_LD bf16: the eight rows an ldmatrix reads hit distinct
// banks), a warp owns 16 rows of the block's tile whole, every product a
// bf16 mma.sync m16n8k16 with float32 sums (one where the f32 pair does
// three), operands by ldmatrix (.trans for dS K, P_drop^T dO and dS^T Q),
// and p and dS moved from the score accumulators into the next product's
// A fragment in registers (two m16n8 accumulators are one m16k16 A
// fragment): no score tile in shared memory. The dq kernel with
// DELTA_PAIRS walks its keys twice (delta, then dS and dQ). A block takes
// LONG16_THREADS threads and long16_bytes() of shared memory (22,044
// bytes: under the 48 KB that needs no attribute), so registers, not
// shared memory, bound the blocks an SM.

constexpr int LONG16_THREADS = 128;        // four warps, 16 rows each
constexpr int LONG16_HD = tile::SEG16_HD;  // heads of 32 (K2's, K3's)
constexpr int LONG16_LD = tile::SEG16_LD;  // bf16 a staged row

// Shared bytes of a bf16 long kernel (the two of this pair and the
// forward, attention_fwd.cuh): four 64-row bf16 tiles (the block's own
// two, the walked two), per query m, 1/l and delta, per row two tags and a
// token index, the prefix count's scratch.
__host__ __device__ constexpr int long16_bytes() {
  return 4 * LONG_T * LONG16_LD * 2 + 6 * LONG_T * 4 +
         (LONG16_THREADS / 32 + 1 + 2) * 4;
}

// A wrapper's launch of a bf16 long kernel: a block of LONG16_THREADS per
// (row, head, 64 tokens), `smem` its shared bytes.
__host__ inline bool long16_launch_ok(const tile::Launch& L, int B, int S,
                                      int H, int smem) {
  return L.pad == LONG_T && L.group == 1 && L.gx == B && L.gy == H &&
         L.gz == (S + LONG_T - 1) / LONG_T && L.threads == LONG16_THREADS &&
         L.smem == smem;
}

namespace lr {

// The shared tiles of a bf16 long kernel: X0, X1 the block's own rows
// (dq: Q, dO; dk/dv: K, V; the forward: Q), Y0, Y1 the walked rows (dq
// and the forward: K, V; dk/dv: Q, dO); m, li, de per query (dq: its own; dk/dv: the walked tile's);
// otag, wtag the own and the walked rows' tags; kix the gathered rows'
// tokens.
struct Tiles16 {
  tile::bf16 *X0, *X1, *Y0, *Y1;
  float *m, *li, *de;
  int *otag, *wtag, *kix, *scan, *range;

  __device__ explicit Tiles16(float4* s) {
    constexpr int R = LONG_T * LONG16_LD;
    X0 = reinterpret_cast<tile::bf16*>(s);
    X1 = X0 + R;
    Y0 = X1 + R;
    Y1 = Y0 + R;
    m = reinterpret_cast<float*>(Y1 + R);
    li = m + LONG_T;
    de = li + LONG_T;
    otag = reinterpret_cast<int*>(de + LONG_T);
    wtag = otag + LONG_T;
    kix = wtag + LONG_T;
    scan = kix + LONG_T;
    range = scan + LONG16_THREADS / 32 + 1;
  }
};

// Rows [0, T) of two bf16 head slices into rows of LONG16_LD bf16, row r
// from the token row(r) (src[k] + row(r) * ld[k]; d1 may be null), zeros
// for r >= n: cp.async, all threads of the block.
template <class Row>
__device__ __forceinline__ void stage16(tile::bf16* d0, tile::bf16* d1,
                                        const tile::bf16* s0, long ld0,
                                        const tile::bf16* s1, long ld1,
                                        Row row, int n) {
  for (int idx = threadIdx.x; idx < T * 4; idx += blockDim.x) {
    const int r = idx >> 2, c = (idx & 3) * 8;
    const bool ok = r < n;
    const long tok = ok ? row(r) : 0;
    tile::cp16(d0 + r * LONG16_LD + c, s0 + tok * ld0 + c, ok);
    if (d1) tile::cp16(d1 + r * LONG16_LD + c, s1 + tok * ld1 + c, ok);
  }
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

// Rows g and g + 8 (lane 4g + q) of a 16 x 32 float32 accumulator,
// rounded to bf16, at p0 and p1 (where ok0, ok1): 16 bytes a lane.
__device__ __forceinline__ void store_pair16(tile::bf16* p0, tile::bf16* p1,
                                             const float (&acc)[4][4],
                                             bool ok0, bool ok1) {
  const int q = threadIdx.x & 3;
  unsigned lo[4], hi[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    lo[k] = tile::pack_bf16(acc[k][0], acc[k][1]);
    hi[k] = tile::pack_bf16(acc[k][2], acc[k][3]);
  }
  const uint4 a = tile::quad_row(lo), b = tile::quad_row(hi);
  if (ok0) *reinterpret_cast<uint4*>(p0 + 8 * q) = a;
  if (ok1) *reinterpret_cast<uint4*>(p1 + 8 * q) = b;
}

// dq: one block per (row, head, T queries), a warp 16 of them. Writes dq
// for the tile's queries and delta [B, S, H] (every query of the tile, 0
// for one without keys) for the dk/dv kernel.
template <bool DELTA_PAIRS, class Tags, class Keep>
__device__ __forceinline__ void long_dq16(
    const tile::bf16* __restrict__ qkv, Tags tags,
    const tile::bf16* __restrict__ out, const tile::bf16* __restrict__ gout,
    const float* __restrict__ stat_m, const float* __restrict__ stat_l,
    float* __restrict__ delta, tile::bf16* __restrict__ dqkv, int S, int d,
    float scale, Keep keep) {
  using tile::bf16;
  constexpr int HD = LONG16_HD;
  extern __shared__ float4 smem4[];
  const Tiles16 s(smem4);
  const long b = blockIdx.x;
  const int h = blockIdx.y, H = gridDim.y, t = threadIdx.x;
  const int q0 = blockIdx.z * T, nq = min(T, S - q0);
  const long d3 = 3L * d, base = b * S;
  const bf16* row = qkv + base * d3 + h * HD;
  const bf16* grow = gout + base * d + h * HD;
  stage16(s.X0, s.X1, row, d3, grow, d, [&](int r) { return (long)(q0 + r); },
          nq);
  int tag = -1;
  if (t < T) {
    float m = 0.f, li = 0.f;
    if (t < nq) tag = tags.qtag(base, q0 + t);
    if (tag >= 0) {  // a valid query attends itself: l > 0, m finite
      const long at = (base + q0 + t) * H + h;
      m = stat_m[at];
      li = 1.f / fmaxf(stat_l[at], 1e-16f);
    }
    s.otag[t] = tag;
    s.m[t] = m;
    s.li[t] = li;
  }
  if constexpr (!DELTA_PAIRS) {  // delta = dO . O, two threads a query
    const int r = t >> 1, part = t & 1;
    float de = 0.f;
    if (r < nq) {
      const long at = (base + q0 + r) * d + h * HD + 16 * part;
#pragma unroll
      for (int c = 0; c < 16; c += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(out + at + c);
        const uint4 gv = *reinterpret_cast<const uint4*>(gout + at + c);
        const unsigned* o2 = reinterpret_cast<const unsigned*>(&ov);
        const unsigned* g2 = reinterpret_cast<const unsigned*>(&gv);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 a = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(o2 + k));
          const float2 e = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(g2 + k));
          de = fmaf(a.x, e.x, de);
          de = fmaf(a.y, e.y, de);
        }
      }
    }
    de += __shfl_xor_sync(0xffffffffu, de, 1);
    if (part == 0 && r < T) {
      s.de[r] = de;
      if (r < nq) delta[(base + q0 + r) * H + h] = de;
    }
  }
  int qmin, qmax;
  block_range(tag, s.range, qmin, qmax);
  cp_wait();
  __syncthreads();

  const int lane = t & 31, m0 = (t >> 5) * 16, g = lane >> 2, q = lane & 3;
  unsigned qa[2][4], ga[2][4];
  a_rows16(qa, s.X0, m0);
  a_rows16(ga, s.X1, m0);
  const int tg[2] = {s.otag[m0 + g], s.otag[m0 + g + 8]};
  const float mr[2] = {s.m[m0 + g], s.m[m0 + g + 8]};
  const float lr_[2] = {s.li[m0 + g], s.li[m0 + g + 8]};
  float de[2] = {0.f, 0.f};
  if constexpr (!DELTA_PAIRS) {
    de[0] = s.de[m0 + g];
    de[1] = s.de[m0 + g + 8];
  }
  float dq[4][4] = {};
  if (qmax >= 0) {  // uniform: the tile holds a query that can attend
    auto sel = [&](int j) {
      const int k = tags.ktag(base, j);
      return k >= qmin && k <= qmax;  // qmin >= 0
    };
    int total;
    const int before = rank_keys(S, sel, s.scan, total);
    const int chunks = (total + T - 1) / T;
    const int steps = DELTA_PAIRS ? 2 * chunks : chunks;
    const auto kept = keep.row(b, h, H, S);  // the row's seed, once
    for (int st = 0; st < steps; ++st) {
      const bool sums = DELTA_PAIRS && st < chunks;  // delta's sweep
      const int r0 = (st < chunks ? st : st - chunks) * T;
      const int nk = min(T, total - r0), nkt = (nk + 15) >> 4;
      list_keys(S, sel, before, r0, s.kix);
      __syncthreads();
      stage16(s.Y0, s.Y1, row + d, d3, row + 2 * d, d3,
              [&](int r) { return (long)s.kix[r]; }, nk);
      if (t < T) s.wtag[t] = t < nk ? tags.ktag(base, s.kix[t]) : -1;
      cp_wait();
      __syncthreads();
      for (int kt = 0; kt < nkt; ++kt) {  // 16 keys a step
        float p[2][4], dp[2][4], unused[2] = {0.f, 0.f};
        tile::scores16(s.Y0, s.wtag, qa, 16 * kt, tg, scale, p, unused);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int kk = 16 * kt + 8 * hf;
          dots8(dp[hf], ga, s.Y1, kk);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const float x = expf(p[hf][e] - mr[r]) * lr_[r];  // exp(-inf) = 0
            p[hf][e] = x;
            if (keep.on)
              dp[hf][e] = (x != 0.f &&
                           kept(q0 + m0 + g + 8 * r,
                                s.kix[kk + 2 * q + (e & 1)]))
                              ? dp[hf][e] * keep.inv_keep
                              : 0.f;
          }
        }
        if (sums) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              de[e >> 1] = fmaf(p[hf][e], dp[hf][e], de[e >> 1]);
          continue;
        }
        float ds[2][4];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ds[hf][e] = p[hf][e] * (dp[hf][e] - de[e >> 1]) * scale;
        unsigned a[4];
        tile::a_frag(a, ds);
        times_rows16(dq, a, s.Y0, 16 * kt);
      }
      if (DELTA_PAIRS && st == chunks - 1) tile::quad_sum(de);
      __syncthreads();  // kix, the tags and Y are overwritten next
    }
  }
  if constexpr (DELTA_PAIRS)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (q == 0 && m0 + g + 8 * r < nq)
        delta[(base + q0 + m0 + g + 8 * r) * H + h] = de[r];
  tile::store_rows16(dqkv + (base + q0 + m0) * d3 + h * HD, d3, dq, nq - m0);
}

// dk, dv: one block per (row, head, z): the z-th chunk of T valid keys by
// rank, a warp 16 of them, and the padding keys among tokens [zT, zT + T)
// (exact zeros). dk_j = sum_i dS_ij q_i, dv_j = sum_i P_drop_ij dO_i over
// the query tiles whose tags can meet the chunk's; delta from the dq
// kernel.
template <class Tags, class Keep>
__device__ __forceinline__ void long_dkv16(
    const tile::bf16* __restrict__ qkv, Tags tags,
    const tile::bf16* __restrict__ gout, const float* __restrict__ stat_m,
    const float* __restrict__ stat_l, const float* __restrict__ delta,
    tile::bf16* __restrict__ dqkv, int S, int d, float scale, Keep keep) {
  using tile::bf16;
  constexpr int HD = LONG16_HD;
  extern __shared__ float4 smem4[];
  const Tiles16 s(smem4);
  const long b = blockIdx.x;
  const int h = blockIdx.y, H = gridDim.y, t = threadIdx.x;
  const int z = blockIdx.z;
  const long d3 = 3L * d, base = b * S;
  const bf16* row = qkv + base * d3 + h * HD;
  const bf16* grow = gout + base * d + h * HD;
  bf16* drow = dqkv + base * d3 + h * HD;

  const uint4 z4 = make_uint4(0u, 0u, 0u, 0u);
  for (int idx = t; idx < T * 4; idx += blockDim.x) {  // padding keys
    const int j = z * T + (idx >> 2), c = (idx & 3) * 8;
    if (j < S && tags.ktag(base, j) < 0) {
      *reinterpret_cast<uint4*>(drow + j * d3 + d + c) = z4;
      *reinterpret_cast<uint4*>(drow + j * d3 + 2 * d + c) = z4;
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
  stage16(s.X0, s.X1, row + d, d3, row + 2 * d, d3,
          [&](int r) { return (long)s.kix[r]; }, nk);
  int tag = -1;
  if (t < T) {
    tag = t < nk ? tags.ktag(base, s.kix[t]) : -1;
    s.otag[t] = tag;
  }
  int kmin, kmax;
  block_range(tag, s.range, kmin, kmax);  // kmax >= 0: nk > 0
  cp_wait();
  __syncthreads();

  const int lane = t & 31, m0 = (t >> 5) * 16, g = lane >> 2, q = lane & 3;
  unsigned ka[2][4], va[2][4];
  a_rows16(ka, s.X0, m0);
  a_rows16(va, s.X1, m0);
  const int ktg[2] = {s.otag[m0 + g], s.otag[m0 + g + 8]};
  const bool ok0 = m0 + g < nk, ok1 = m0 + g + 8 < nk;
  const int kj[2] = {ok0 ? s.kix[m0 + g] : 0, ok1 ? s.kix[m0 + g + 8] : 0};
  float dk[4][4] = {}, dv[4][4] = {};
  const auto kept = keep.row(b, h, H, S);  // the row's seed, once
  for (int q0 = 0; q0 < S; q0 += T) {
    const int nq = min(T, S - q0);
    int qt = -1;
    if (t < nq) qt = tags.qtag(base, q0 + t);
    if (!__syncthreads_or(qt >= kmin && qt <= kmax)) continue;  // uniform
    stage16(s.Y0, s.Y1, row, d3, grow, d,
            [&](int r) { return (long)(q0 + r); }, nq);
    if (t < T) {
      float m = 0.f, li = 0.f, de = 0.f;
      if (qt >= 0) {
        const long at = (base + q0 + t) * H + h;
        m = stat_m[at];
        li = 1.f / fmaxf(stat_l[at], 1e-16f);
        de = delta[at];
      }
      s.wtag[t] = qt;
      s.m[t] = m;
      s.li[t] = li;
      s.de[t] = de;
    }
    cp_wait();
    __syncthreads();
    const int nqt = (nq + 15) >> 4;
    for (int it = 0; it < nqt; ++it) {  // 16 queries a step
      float pd[2][4], ds[2][4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i0 = 16 * it + 8 * hf;
        float sc[4], tp[4];
        dots8(sc, ka, s.Y0, i0);  // s^T: keys x queries
        dots8(tp, va, s.Y1, i0);  // dp^T
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, i = i0 + 2 * q + (e & 1), ti = s.wtag[i];
          float pv = 0.f, dsv = 0.f;
          if (ti >= 0 && ti == ktg[r]) {
            const float p = expf(sc[e] * scale - s.m[i]) * s.li[i];
            float dpv = tp[e];
            pv = p;
            if (keep.on) {
              const bool on = kept(q0 + i, kj[r]);
              pv = on ? p * keep.inv_keep : 0.f;
              dpv = on ? dpv * keep.inv_keep : 0.f;
            }
            dsv = p * (dpv - s.de[i]) * scale;
          }
          pd[hf][e] = pv;
          ds[hf][e] = dsv;
        }
      }
      unsigned pa[4], sa[4];
      tile::a_frag(pa, pd);
      tile::a_frag(sa, ds);
      times_rows16(dv, pa, s.Y1, 16 * it);
      times_rows16(dk, sa, s.Y0, 16 * it);
    }
    // the next tile's __syncthreads_or guards Y and the per-query values
  }
  bf16* o0 = drow + (long)kj[0] * d3;
  bf16* o1 = drow + (long)kj[1] * d3;
  store_pair16(o0 + d, o1 + d, dk, ok0, ok1);
  store_pair16(o0 + 2 * d, o1 + 2 * d, dv, ok0, ok1);
}

}  // namespace lr

// The two __global__ kernels of a caller's bf16 pair (its own, with its
// own launch bounds) over lr::long_dq16 and lr::long_dkv16.
template <class Tags, class Keep>
using LongDq16 = void (*)(const tile::bf16*, Tags, const tile::bf16*,
                          const tile::bf16*, const float*, const float*,
                          float*, tile::bf16*, int, int, float, Keep);
template <class Tags, class Keep>
using LongDkv16 = void (*)(const tile::bf16*, Tags, const tile::bf16*,
                           const float*, const float*, const float*,
                           tile::bf16*, int, int, float, Keep);

// Launches the bf16 dq kernel, then the dk/dv kernel, on one stream (delta
// [B, S, H] passes between them). Returns cudaGetLastError() after each.
template <class Tags, class Keep>
cudaError_t launch_long_bwd16(LongDq16<Tags, Keep> dq,
                              LongDkv16<Tags, Keep> dkv,
                              const tile::bf16* qkv, Tags tags,
                              const tile::bf16* out, const tile::bf16* gout,
                              const float* stat_m, const float* stat_l,
                              float* delta, tile::bf16* dqkv, int B, int S,
                              int d, int H, Keep keep, cudaStream_t stream) {
  const float scale = 1.f / sqrtf((float)LONG16_HD);
  const dim3 grid(B, H, (S + LONG_T - 1) / LONG_T);
  dq<<<grid, LONG16_THREADS, long16_bytes(), stream>>>(
      qkv, tags, out, gout, stat_m, stat_l, delta, dqkv, S, d, scale, keep);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv<<<grid, LONG16_THREADS, long16_bytes(), stream>>>(
      qkv, tags, gout, stat_m, stat_l, delta, dqkv, S, d, scale, keep);
  return cudaGetLastError();
}

}  // namespace attn
