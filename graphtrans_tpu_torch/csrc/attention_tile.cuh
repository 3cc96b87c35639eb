// Attention over one whole attention block at a time: K4's forward and
// backward (attention_packed.cu), K9's forward on short spans and its
// backward up to 384 tokens (attention_smalls.cu), and K2's forward and
// backward on rows of up to 128 tokens (attention_packed.cu), over qkv
// [B, S, 3d] with heads in lanes.
//
// An attention block ("span") is the token range whose queries and keys
// meet under K4's mask: with block > 0 one graph block of a packed row,
// [g*block, min(S, (g+1)*block)); with block 0 the whole row. Key j of a
// span is attendable iff valid[j]; every query of the span attends the
// span's valid keys (a padding query too), and a span without a valid key
// gives zeros. A problem is one (row, span, head). K2's spans are the
// graph segments of a packed row (SegRuns, below).
//
// What it replaces. K4's backward ran the streaming pair of
// attention_bwd.cuh (K5's, built for rows of 1001): a dq kernel and a
// dk/dv kernel that each computed s = q.k, dp = dO.v and the dropout hash
// of every pair, passed delta through device memory, walked 128 key slots
// for a graph's 33 keys, and spent one shared load per FMA. K9's forward
// ran K5's streaming body with a thread a query: at rows of 33, 95 of a
// block's 128 threads only staged K and V, and the online softmax rescaled
// 64 accumulators whenever the running max rose.
//
// The design. A problem's Q, K, V (and dO for the backward) are staged in
// shared memory once, 16-byte loads, rows of hd + 4 floats (the padding
// moves neighbouring rows to other banks and keeps 16-byte alignment). The
// span is padded to np = 4 * ceil(n / 4) rows. Each (query, key) pair is
// evaluated once into a shared score tile by register-blocked micro-tiles:
// a thread owns 4 queries x 4 keys spread np / 4 apart, so one 16-byte
// load of a q (k) row feeds 16 FMAs of four pairs. The tile products
// (dV = P_drop^T dO, dK = dS^T Q, dQ = dS K, O = P_drop V) run on 4 x 4
// (row, channel) micro-tiles the same way. Every output cell has one
// writer: no atomics, and the results are deterministic. A CUDA block takes
// `group` problems where one would leave most of its threads idle (spans
// of up to 32 tokens); threads walk each phase's work items in turn.
// Sizes above 48 KB of dynamic shared memory are allowed per instance
// before its first launch.
//
// Busy threads (the wrappers' *_geometry functions pick np, group and
// threads). The pair phase, the largest: S = 33 (np 36, 81 micro-tiles on
// 96 threads) 84 %; S = 49 (np 52, 169 on 192) 88 %; S = 99 at block 33
// (three spans of 33, a block each) 84 %. The product phases: K4-bwd 100 %
// at S = 33 and 72 % at S = 49, K9 (softmax rows, then P V) 75 % and 54 %.
// The old K4-bwd did work in about 26 % of its loop iterations at S = 99,
// and the old K9 used 33 of a block's 128 threads at S = 33.
//
// The bound on the H100 is memory: q, k, v, dO, O in and dqkv out for the
// backward, ~1.06 GB (0.32 ms) at 4096 molecules (1366 rows of 99, d 256,
// hd 64), against ~11 GFLOP of pair and product work (0.17 ms of f32
// FMA); the forward ~0.15 ms. Shared memory limits residency instead: a
// problem of 33 tokens takes 51 KB (backward) or 35 KB (forward) at hd 64,
// so 4 (6) problems share an SM, and their staging overlaps the others'
// arithmetic.
//
// Wide spans (K4-bwd and K9-bwd, up to 384 tokens, hd 32 and 64): 64-token
// tiles. For each key tile (skipped whole, with dk = dv = 0, when it holds
// no valid key) the block walks the query tiles; dK and dV of the key tile
// stay in registers, and the span's dQ sums stay in shared memory (<= 384
// x 68 floats at hd 64), each cell updated by one thread.
//
// Dropout is a policy (Keep: members on and inv_keep, and
// keep(b, h, H, S, i, j) with i, j the row's own token indices), drawn
// once per pair from the caller's seed schedule; nothing is stored.
//
// The whole-span bodies (fwd_tile, bwd_tile) take their problems from a
// span source, a policy: FixedSpans for K4 and K9 (spans of one width,
// `group` problems a block), SegRuns for K2 (one block per (row, head),
// the row's graph segments, found by the block from seg itself).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma_tf32.cuh"
#include "vec.cuh"

namespace tile {

using vio::bf16;

constexpr int THREADS = 256;     // the most threads a block of any instance
constexpr int WIDE = 64;         // rows of a tile of the wide backward
constexpr int SHORT_MAX = 64;    // the longest span the short backward takes
constexpr int SMEM_MAX = 232448; // dynamic shared bytes a block may take

// A launch as a wrapper computed it (attention_packed.py:Geometry): the
// instance's code, the rows of a span's tile, the problems a block, the
// grid, the threads a block and its dynamic shared bytes. The C entries
// check it against the shapes before they launch.
struct Launch {
  int instance, pad, group, gx, gy, gz, threads, smem;
};

// the spans of a row: `count` of `width` tokens, the last maybe shorter
struct Spans {
  int width, count;
};

__host__ __device__ inline Spans spans_of(int S, int block) {
  Spans sp;
  sp.width = (block > 0 && block < S) ? block : S;
  sp.count = (S + sp.width - 1) / sp.width;
  return sp;
}

__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }

// Floats of shared memory per problem: the short backward (Q, K, V, dO;
// P_drop and dS; m, 1/l, delta and the key mask per row), the wide
// backward (four 64-row tiles, two score tiles, the span's dQ sums and
// statistics, a key tile's mask), the forward (Q, K, V; P; 1/l, mask).
__host__ __device__ inline int bwd_short_floats(int np, int hd) {
  return 4 * np * (hd + 4) + 2 * np * (np + 4) + 4 * np;
}
__host__ __device__ inline int bwd_wide_floats(int npad, int hd) {
  return 4 * WIDE * (hd + 4) + 2 * WIDE * (WIDE + 4) + npad * (hd + 4) +
         3 * npad + WIDE;
}
__host__ __device__ inline int fwd_floats(int np, int hd) {
  return 3 * np * (hd + 4) + np * (np + 4) + 2 * np;
}

// one (row, span, head); heads fastest, then spans, then rows
struct Problem {
  long b;  // row
  int h;   // head
  int s0;  // the span's first token
  int n;   // its tokens
};

__device__ __forceinline__ Problem problem_at(long p, int S, Spans sp,
                                              int H) {
  Problem q;
  q.h = (int)(p % H);
  const long rest = p / H;
  q.s0 = (int)(rest % sp.count) * sp.width;
  q.b = rest / sp.count;
  q.n = min(sp.width, S - q.s0);
  return q;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}
// four bf16 (8 bytes) as floats; four floats rounded to bf16 (nearest
// even): vec.cuh's accesses
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const vio::Vec<4> v = vio::load_vec<4>(p);
  return make_float4(v.v[0], v.v[1], v.v[2], v.v[3]);
}
__device__ __forceinline__ void st4(bf16* p, float4 v) {
  vio::store_vec(p, vio::Vec<4>{{v.x, v.y, v.z, v.w}});
}
__device__ __forceinline__ float round_bf16(float x) {
  return vio::round_to<bf16>(x);
}

// Rows [0, n) of N head slices (src[k]: row 0's first channel, ld[k]
// floats between rows) into rows of HD + 4 floats at dst[k]; rows
// n..rows-1 zero. A thread issues the loads of two of its indices for all N
// slices before it stores any, so 2N 16-byte loads are in flight.
template <int HD, int N>
__device__ __forceinline__ void stage(float* const (&dst)[N],
                                      const float* const (&src)[N],
                                      const long (&ld)[N], int n, int rows,
                                      int t, int nt) {
  constexpr int C4 = HD / 4;
  const int total = rows * C4;
  for (int idx = t; idx < total; idx += 2 * nt) {
    float4 v[2][N];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = idx + u * nt, r = i / C4, c = i % C4 * 4;
#pragma unroll
      for (int k = 0; k < N; ++k)
        v[u][k] = (i < total && r < n) ? ld4(src[k] + r * ld[k] + c)
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = idx + u * nt, r = i / C4, c = i % C4 * 4;
      if (i < total)
#pragma unroll
        for (int k = 0; k < N; ++k) st4(dst[k] + r * (HD + 4) + c, v[u][k]);
    }
  }
}

// The 4 x 4 micro-tile (ti, tj) of a pair tile whose rows lie nr apart:
// s[a][b] = A_(ti+a*nr) . B_(tj+b*nr) and, with DP, dp[a][b] =
// C_(ti+a*nr) . D_(tj+b*nr), over HD channels.
template <int HD, bool DP>
__device__ __forceinline__ void dots(const float* __restrict__ A,
                                     const float* __restrict__ Bm,
                                     const float* __restrict__ C,
                                     const float* __restrict__ D, int ti,
                                     int tj, int nr, float (&s)[4][4],
                                     float (&dp)[4][4]) {
  constexpr int LD = HD + 4;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) s[a][b] = dp[a][b] = 0.f;
#pragma unroll 2
  for (int c = 0; c < HD; c += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      x[a] = ld4(A + (ti + a * nr) * LD + c);
      if constexpr (DP) y[a] = ld4(C + (ti + a * nr) * LD + c);
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float4 k = ld4(Bm + (tj + b * nr) * LD + c);
#pragma unroll
      for (int a = 0; a < 4; ++a) s[a][b] = dot4(x[a], k, s[a][b]);
      if constexpr (DP) {
        const float4 v = ld4(D + (tj + b * nr) * LD + c);
#pragma unroll
        for (int a = 0; a < 4; ++a) dp[a][b] = dot4(y[a], v, dp[a][b]);
      }
    }
  }
}

// acc[a][e] += sum_{j < nk4} P[i0+a][j] M[j][c0+e]: rows i0..i0+3 of a
// score tile (sld floats a row) times a staged tile (dQ = dS K; O = P V).
template <int HD>
__device__ __forceinline__ void rows_times(const float* __restrict__ P,
                                           const float* __restrict__ M,
                                           int sld, int nk4, int i0, int c0,
                                           float (&acc)[4][4]) {
  constexpr int LD = HD + 4;
  for (int j = 0; j < nk4; j += 4) {
    float p[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float4 v = ld4(P + (i0 + a) * sld + j);
      p[a][0] = v.x;
      p[a][1] = v.y;
      p[a][2] = v.z;
      p[a][3] = v.w;
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float4 m = ld4(M + (j + b) * LD + c0);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        acc[a][0] = fmaf(p[a][b], m.x, acc[a][0]);
        acc[a][1] = fmaf(p[a][b], m.y, acc[a][1]);
        acc[a][2] = fmaf(p[a][b], m.z, acc[a][2]);
        acc[a][3] = fmaf(p[a][b], m.w, acc[a][3]);
      }
    }
  }
}

// dv[b][e] += sum_{i < nq} Pd[i][j0+b] dO[i][c0+e] and dk[b][e] += sum_i
// dS[i][j0+b] Q[i][c0+e]: keys j0..j0+3, channels c0..c0+3.
template <int HD>
__device__ __forceinline__ void keys_times(const float* __restrict__ Pd,
                                           const float* __restrict__ dS,
                                           const float* __restrict__ G,
                                           const float* __restrict__ Q,
                                           int sld, int nq, int j0, int c0,
                                           float (&dk)[4][4],
                                           float (&dv)[4][4]) {
  constexpr int LD = HD + 4;
  for (int i = 0; i < nq; ++i) {
    const float4 p = ld4(Pd + i * sld + j0), s = ld4(dS + i * sld + j0);
    const float4 g = ld4(G + i * LD + c0), q = ld4(Q + i * LD + c0);
    const float pv[4] = {p.x, p.y, p.z, p.w}, sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      dv[b][0] = fmaf(pv[b], g.x, dv[b][0]);
      dv[b][1] = fmaf(pv[b], g.y, dv[b][1]);
      dv[b][2] = fmaf(pv[b], g.z, dv[b][2]);
      dv[b][3] = fmaf(pv[b], g.w, dv[b][3]);
      dk[b][0] = fmaf(sv[b], q.x, dk[b][0]);
      dk[b][1] = fmaf(sv[b], q.y, dk[b][1]);
      dk[b][2] = fmaf(sv[b], q.z, dk[b][2]);
      dk[b][3] = fmaf(sv[b], q.w, dk[b][3]);
    }
  }
}

// p_ij, its dropped value and ds_ij of one pair (torch dropout: p from the
// forward's m and 1/l, dp and p kept and scaled by 1/(1-rate) or zeroed).
template <class Keep>
__device__ __forceinline__ void pair_grad(float s, float dp, float m,
                                          float li, float delta, bool kept,
                                          const Keep& keep, float& pd,
                                          float& ds) {
  const float p = expf(s - m) * li;
  pd = p;
  if (keep.on) {
    pd = kept ? p * keep.inv_keep : 0.f;
    dp = kept ? dp * keep.inv_keep : 0.f;
  }
  ds = p * (dp - delta);
}

__device__ __forceinline__ void zero(float (&a)[4][4]) {
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) a[x][y] = 0.f;
}

// ---- span sources --------------------------------------------------------
//
// A span source stages a block's problems in shared memory (load, all
// threads; the body's barrier follows; after_pairs and wait may bring the
// forward's V in once Q is no longer read) and says where their tiles lie:
//  - count(), problem(g): the block's problems; pad(g): np, the rows of
//    problem g's tiles (its n tokens rounded up to 4);
//  - Q(g), K(g), V(g) and, for the backward, G(g) (dO): row 0 of its
//    staged head slices, rows of HD + 4 floats; rows n..np-1 hold finite
//    values (zeros, or the next tokens' rows) that the mask keeps out;
//  - P(g) and, for the backward, D(g): its np x sld(g) score tiles;
//  - per query row i < n: inv(g)[i] (the forward's 1/l) or m(g)[i],
//    li(g)[i], de(g)[i] (the backward's m, 1/l and delta);
//  - mask(g): a functor, (i, j) -> query i may attend key j (i < n, j < np);
//  - pair_items(), pair_at(w, g, r): the pair phase's work items, nr^2 a
//    problem (nr = np / 4); row_items(c), row_at(c, w, g, r): a phase of
//    c * nr items a problem.

// K4's and K9's key mask: key j of the span is valid
struct KeyMask {
  const float* kv;
  __device__ bool operator()(int, int j) const { return kv[j] != 0.f; }
};

// K2's mask on a problem's tags: query i attends key j iff
// tag[i] == tag[j] >= 0
struct TagMask {
  const int* tg;
  __device__ bool operator()(int i, int j) const {
    return tg[j] >= 0 && tg[i] == tg[j];
  }
};

// K4 and K9: spans of one width (spans_of(S, block)), `group` (row, span,
// head) problems a block, each in its own region of per floats.
template <int HD, bool BWD>
struct FixedSpans {
  static constexpr int LD = HD + 4;
  const unsigned char* valid;
  const float* gout;    // the backward's cotangent, m and l
  const float* stat_m;
  const float* stat_l;
  float* smem;
  Spans sp;
  long p0;
  int S, H, np, nr, ng, per;

  __device__ FixedSpans(const unsigned char* valid_, const float* gout_,
                        const float* stat_m_, const float* stat_l_, int B,
                        int S_, int H_, int block, int np_, int group)
      : valid(valid_), gout(gout_), stat_m(stat_m_), stat_l(stat_l_),
        S(S_), H(H_), np(np_), nr(np_ / 4) {
    extern __shared__ float4 smem4[];
    smem = reinterpret_cast<float*>(smem4);
    per = BWD ? bwd_short_floats(np, HD) : fwd_floats(np, HD);
    sp = spans_of(S, block);
    p0 = (long)blockIdx.x * group;
    const long left = (long)B * sp.count * H - p0;
    ng = left < group ? (int)left : group;
  }

  __device__ int count() const { return ng; }
  __device__ Problem problem(int g) const {
    return problem_at(p0 + g, S, sp, H);
  }
  __device__ int pad(int) const { return np; }
  __device__ int sld(int) const { return np + 4; }
  __device__ float* Q(int g) const { return smem + g * per; }
  __device__ float* K(int g) const { return Q(g) + np * LD; }
  __device__ float* V(int g) const { return Q(g) + 2 * np * LD; }
  __device__ float* G(int g) const { return Q(g) + 3 * np * LD; }
  __device__ float* P(int g) const { return Q(g) + (BWD ? 4 : 3) * np * LD; }
  __device__ float* D(int g) const { return P(g) + np * (np + 4); }
  // per row: the forward's 1/l and key mask; the backward's m, 1/l,
  // delta and key mask
  __device__ float* rows(int g) const {
    return P(g) + (BWD ? 2 : 1) * np * (np + 4);
  }
  __device__ float* inv(int g) const { return rows(g); }
  __device__ float* m(int g) const { return rows(g); }
  __device__ float* li(int g) const { return rows(g) + np; }
  __device__ float* de(int g) const { return rows(g) + 2 * np; }
  __device__ KeyMask mask(int g) const {
    return KeyMask{rows(g) + (BWD ? 3 : 1) * np};
  }
  __device__ int pair_items() const { return ng * nr * nr; }
  __device__ void pair_at(int w, int& g, int& r) const {
    g = w / (nr * nr);
    r = w % (nr * nr);
  }
  __device__ void after_pairs(const float*, int) const {}
  __device__ void wait() const {}
  __device__ int row_items(int c) const { return ng * c * nr; }
  __device__ void row_at(int c, int w, int& g, int& r) const {
    g = w / (c * nr);
    r = w % (c * nr);
  }

  __device__ void load(const float* __restrict__ qkv, int d) {
    const int t = threadIdx.x, nt = blockDim.x;
    const long d3 = 3L * d;
    for (int g = 0; g < ng; ++g) {
      const Problem pr = problem(g);
      const long tok0 = pr.b * S + pr.s0;
      const float* row = qkv + tok0 * d3 + pr.h * HD;
      float* kv = rows(g) + (BWD ? 3 : 1) * np;
      if constexpr (BWD) {
        float* const dst[4] = {Q(g), K(g), V(g), G(g)};
        const float* const src[4] = {row, row + d, row + 2 * d,
                                     gout + tok0 * d + pr.h * HD};
        const long ld[4] = {d3, d3, d3, d};
        stage<HD, 4>(dst, src, ld, pr.n, np, t, nt);
        float* st = rows(g);
        for (int i = t; i < np; i += nt) {
          float mm = 0.f, l = 0.f, k = 0.f;
          if (i < pr.n) {
            const long at = (tok0 + i) * H + pr.h;
            mm = stat_m[at];
            l = 1.f / fmaxf(stat_l[at], 1e-16f);
            k = valid[tok0 + i] ? 1.f : 0.f;
          }
          st[i] = mm;
          st[np + i] = l;
          kv[i] = k;
        }
      } else {
        float* const dst[3] = {Q(g), K(g), V(g)};
        const float* const src[3] = {row, row + d, row + 2 * d};
        const long ld[3] = {d3, d3, d3};
        stage<HD, 3>(dst, src, ld, pr.n, np, t, nt);
        for (int j = t; j < np; j += nt)
          kv[j] = (j < pr.n && valid[tok0 + j]) ? 1.f : 0.f;
      }
    }
  }
};

// K2's blocks on rows of W <= SEG_W_MAX tokens: the rows staged (the
// row's W tokens, then zero rows), and the score tiles' floats. A
// segment's tile rows hold an odd number of float4 (seg_sld), so the
// softmax's four threads a row, eight rows a warp, read distinct banks. A
// segment of n tokens takes np x seg_sld(np) floats (np: n rounded up to
// 4); seg_score_floats is the most any split of W tokens into segments
// takes (a knapsack over the segment lengths, on the host: the launch
// passes it to the kernel).
constexpr int SEG_W_MAX = 128;
__host__ __device__ inline int seg_rows(int W) { return round4(W) + 4; }
__host__ __device__ inline int seg_sld(int np) { return 4 * ((np / 4 + 1) | 1); }
struct SegScoreTable {  // best[w]: the most floats w tokens can take
  int best[SEG_W_MAX + 1];
  SegScoreTable() {
    best[0] = 0;
    for (int w = 1; w <= SEG_W_MAX; ++w) {
      best[w] = 0;
      for (int n = 1; n <= w; ++n) {
        const int np = round4(n), v = best[w - n] + np * seg_sld(np);
        if (v > best[w]) best[w] = v;
      }
    }
  }
};
__host__ inline int seg_score_floats(int W) {
  static const SegScoreTable table;  // filled once, at the first launch
  return round4(table.best[W < SEG_W_MAX ? W : SEG_W_MAX]);
}
// 4-byte words of shared memory of a K2 tile block: the row's head
// slices (forward: Q, then V in its place, and K; backward: Q, K, V, dO),
// the score tiles (P; and dS), per token 1/l (m, 1/l, delta); then ints:
// per token its tag, per segment its first token, its length, the prefix
// counts of nr and nr^2 and its score tile's offset, and the block's
// counts. At W 128 the forward takes 110 KB (two blocks an SM), the
// backward 213 KB.
__host__ inline int seg_tile_words(int W, int hd, bool bwd) {
  const int R4 = seg_rows(W);
  return (bwd ? 4 : 2) * R4 * (hd + 4) + (bwd ? 2 : 1) * seg_score_floats(W) +
         (bwd ? 3 : 1) * R4 + R4 + 5 * (W + 1) + 4;
}

// K2: one block per (row, head) of a packed row of W tokens (blockIdx.x =
// row * H + head). Its problems are the row's runs of one graph id >= 0
// (ops/pack.py writes each graph and its CLS as one run), found by the
// block while its row's slices land (cp.async): warp 0 ranks the runs'
// first and last tokens with ballots, 32 tokens at a time; no host
// synchronisation. A row whose ids each form one
// run gives one problem a run, its padding tokens (seg -1) written as
// zeros here. A row in which some id forms two runs (the JAX kernel's mask
// allows it) takes the whole row as one problem under TagMask, which is
// K2's mask itself. The row's head slices are staged once, contiguous, so
// a run's tiles start at its first token's row. E is the type of qkv, the
// cotangent and the outputs: float (staged by cp.async), or bf16 (K2's
// bf16 instances: loaded, widened and stored as floats, so the tiles are
// the f32 instance's).
template <int HD, bool BWD, class E = float>
struct SegRuns {
  static constexpr int LD = HD + 4, C4 = HD / 4;
  const int* seg;
  const E* gout;         // backward: the cotangent, the forward's m and l
  const float* rd_m;
  const float* rd_l;
  float* wr_m;           // forward: m and l of padding tokens (or null)
  float* wr_l;
  E* zero_rows;          // out (forward) or dqkv (backward)
  float *Qr, *Pr, *tokf;
  int *tg, *s0, *len, *cnr, *cnr2, *off, *meta;
  long b;
  int h, H, W, R4, SC, ng;

  __device__ SegRuns(const int* seg_, const E* gout_, const float* rd_m_,
                     const float* rd_l_, float* wr_m_, float* wr_l_,
                     E* zero_rows_, int W_, int H_, int score)
      : seg(seg_), gout(gout_), rd_m(rd_m_), rd_l(rd_l_), wr_m(wr_m_),
        wr_l(wr_l_), zero_rows(zero_rows_), H(H_), W(W_), SC(score), ng(0) {
    extern __shared__ float4 smem4[];
    b = blockIdx.x / H;
    h = blockIdx.x % H;
    R4 = seg_rows(W);
    Qr = reinterpret_cast<float*>(smem4);
    Pr = Qr + (BWD ? 4 : 2) * R4 * LD;
    tokf = Pr + (BWD ? 2 : 1) * SC;
    tg = reinterpret_cast<int*>(tokf + (BWD ? 3 : 1) * R4);
    s0 = tg + R4;
    len = s0 + W + 1;
    cnr = len + W + 1;
    cnr2 = cnr + W + 1;
    off = cnr2 + W + 1;
    meta = off + W + 1;
  }

  __device__ int count() const { return ng; }
  __device__ Problem problem(int g) const { return Problem{b, h, s0[g], len[g]}; }
  __device__ int pad(int g) const { return 4 * (cnr[g + 1] - cnr[g]); }
  __device__ int sld(int g) const { return seg_sld(pad(g)); }
  __device__ float* Q(int g) const { return Qr + s0[g] * LD; }
  __device__ float* K(int g) const { return Q(g) + R4 * LD; }
  // the forward's V lands in Q's place once the scores are out
  __device__ float* V(int g) const { return Q(g) + (BWD ? 2 : 0) * R4 * LD; }
  __device__ float* G(int g) const { return Q(g) + 3 * R4 * LD; }
  __device__ float* P(int g) const { return Pr + off[g]; }
  __device__ float* D(int g) const { return P(g) + SC; }
  __device__ float* inv(int g) const { return tokf + s0[g]; }
  __device__ float* m(int g) const { return tokf + s0[g]; }
  __device__ float* li(int g) const { return tokf + R4 + s0[g]; }
  __device__ float* de(int g) const { return tokf + 2 * R4 + s0[g]; }
  __device__ TagMask mask(int g) const { return TagMask{tg + s0[g]}; }
  __device__ int pair_items() const { return cnr2[ng]; }
  __device__ void pair_at(int w, int& g, int& r) const {
    g = last_at_most(cnr2, w);
    r = w - cnr2[g];
  }
  __device__ int row_items(int c) const { return c * cnr[ng]; }
  __device__ void row_at(int c, int w, int& g, int& r) const {
    g = last_at_most(cnr, w / c);
    r = w - c * cnr[g];
  }
  // the last g < ng with pre[g] <= x (pre rises strictly: every problem
  // has a token)
  __device__ int last_at_most(const int* pre, int x) const {
    int lo = 0, hi = ng - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (pre[mid] <= x)
        lo = mid;
      else
        hi = mid - 1;
    }
    return lo;
  }

  // rows [0, R4) of N head slices (src[k]: token 0's first channel, ld[k]
  // elements between tokens) into rows of LD floats at dst[k], zeros past
  // W: 16-byte cp.async copies (float), or 8-byte loads widened to floats
  // (bf16)
  template <int N>
  __device__ void copy_rows(float* const (&dst)[N],
                            const E* const (&src)[N],
                            const long (&ld)[N]) const {
    for (int idx = threadIdx.x; idx < R4 * C4; idx += blockDim.x) {
      const int r = idx / C4, c = idx % C4 * 4;
      const long tok = r < W ? r : 0;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        if constexpr (sizeof(E) == 4)
          tc::cp16(dst[k] + r * LD + c, src[k] + tok * ld[k] + c, r < W);
        else
          st4(dst[k] + r * LD + c, r < W ? ld4(src[k] + tok * ld[k] + c)
                                         : make_float4(0.f, 0.f, 0.f, 0.f));
      }
    }
  }

  // the forward: V into Q's place (the pair phase is over), landing while
  // the softmax runs; wait() before the products
  __device__ void after_pairs(const E* __restrict__ qkv, int d) const {
    if constexpr (!BWD) {
      float* const dst[1] = {Qr};
      const E* const src[1] = {qkv + b * W * 3L * d + h * HD + 2 * d};
      const long ld[1] = {3L * d};
      copy_rows<1>(dst, src, ld);
    }
  }
  __device__ void wait() const { tc::cp_wait(); }

  __device__ void load(const E* __restrict__ qkv, int d) {
    const int t = threadIdx.x, nt = blockDim.x;
    const long d3 = 3L * d, base = b * W;
    {  // the row's head slices (the forward's Q and K; the backward's Q, K,
       // V and dO), landing while the runs are found
      const E* row = qkv + base * d3 + h * HD;
      if constexpr (BWD) {
        float* const dst[4] = {Qr, Qr + R4 * LD, Qr + 2 * R4 * LD,
                               Qr + 3 * R4 * LD};
        const E* const src[4] = {row, row + d, row + 2 * d,
                                 gout + base * d + h * HD};
        const long ld[4] = {d3, d3, d3, d};
        copy_rows<4>(dst, src, ld);
      } else {
        float* const dst[2] = {Qr, Qr + R4 * LD};
        const E* const src[2] = {row, row + d};
        const long ld[2] = {d3, d3};
        copy_rows<2>(dst, src, ld);
      }
    }
    for (int i = t; i < R4; i += nt) tg[i] = i < W ? seg[base + i] : -1;
    __syncthreads();
    if (t < 32) {  // s0[k]: run k's first token; len[k]: one past its last
      int ns = 0, ne = 0;
      const unsigned below = (1u << t) - 1u;
      for (int c = 0; c < W; c += 32) {
        const int i = c + t;
        const int v = i < W ? tg[i] : -1;
        const bool first = v >= 0 && (i == 0 || tg[i - 1] != v);
        const bool last = v >= 0 && tg[i + 1] != v;  // tg[W] = -1
        const unsigned bf = __ballot_sync(0xffffffffu, first);
        const unsigned bl = __ballot_sync(0xffffffffu, last);
        if (first) s0[ns + __popc(bf & below)] = i;
        if (last) len[ne + __popc(bl & below)] = i + 1;
        ns += __popc(bf);
        ne += __popc(bl);
      }
      if (t == 0) meta[0] = ns;
    }
    __syncthreads();
    const int runs = meta[0];
    bool twice = false;  // an id in two runs
    for (int k = t; k < runs; k += nt) {
      const int id = tg[s0[k]];
      for (int k2 = k + 1; k2 < runs; ++k2) twice |= tg[s0[k2]] == id;
      len[k] -= s0[k];
    }
    const bool general = __syncthreads_or(twice);
    if (t == 0) {
      const int n = general ? 1 : runs;
      if (general) {
        s0[0] = 0;
        len[0] = W;
      }
      int a = 0, q = 0, o = 0;
      for (int k = 0; k < n; ++k) {
        cnr[k] = a;
        cnr2[k] = q;
        off[k] = o;
        const int r = (len[k] + 3) >> 2;
        a += r;
        q += r * r;
        o += 4 * r * seg_sld(4 * r);
      }
      cnr[n] = a;
      cnr2[n] = q;
      meta[1] = n;
    }
    if constexpr (BWD) {
      for (int i = t; i < R4; i += nt) {
        float mm = 0.f, l = 0.f;
        if (i < W && tg[i] >= 0) {
          const long at = (base + i) * H + h;
          mm = rd_m[at];
          l = 1.f / fmaxf(rd_l[at], 1e-16f);
        }
        tokf[i] = mm;
        tokf[R4 + i] = l;
      }
    }
    if (!general) {  // padding tokens: in no problem
      const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int idx = t; idx < W * C4; idx += nt) {
        const int i = idx / C4, c = idx % C4 * 4;
        if (tg[i] >= 0) continue;
        if constexpr (BWD) {
          E* o = zero_rows + (base + i) * d3 + h * HD + c;
          st4(o, z4);
          st4(o + d, z4);
          st4(o + 2 * d, z4);
        } else {
          st4(zero_rows + (base + i) * d + h * HD + c, z4);
          if (wr_m && c == 0) {
            wr_m[(base + i) * H + h] = -INFINITY;
            wr_l[(base + i) * H + h] = 0.f;
          }
        }
      }
    }
    tc::cp_wait();
    __syncthreads();
    ng = meta[1];
  }
};

// ---- the forward on whole spans ----------------------------------------
//
// out for the span source's problems: the scores once into a shared tile,
// an exact two-pass softmax per query row (max, then the sum of undropped
// exp(s - m)), then O = P_drop V / l. STATS writes m (the max scaled
// score) and l [B, S, H] as attention_fwd.cuh defines them; a query with
// no attendable key writes zeros, m = -inf and l = 0.
template <int HD, bool DROP, bool STATS, class Src, class Keep>
__device__ __forceinline__ void fwd_tile(Src& src,
                                         const float* __restrict__ qkv,
                                         float* __restrict__ out,
                                         float* __restrict__ stat_m,
                                         float* __restrict__ stat_l, int S,
                                         int d, int H, float scale,
                                         const Keep& keep) {
  constexpr int C4 = HD / 4;
  const int t = threadIdx.x, nt = blockDim.x;
  src.load(qkv, d);
  __syncthreads();

  const int pairs = src.pair_items();
  for (int w = t; w < pairs; w += nt) {
    int g, r;
    src.pair_at(w, g, r);
    const int nr = src.pad(g) / 4, sld = src.sld(g);
    const int ti = r / nr, tj = r % nr;
    float s[4][4], unused[4][4];
    dots<HD, false>(src.Q(g), src.K(g), nullptr, nullptr, ti, tj, nr, s,
                    unused);
    const auto meets = src.mask(g);
    float* P = src.P(g);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int i = ti + a * nr, j = tj + b * nr;
        P[i * sld + j] = meets(i, j) ? s[a][b] * scale : -INFINITY;
      }
  }
  __syncthreads();
  src.after_pairs(qkv, d);

  // four threads a row (aligned lanes of one warp): max, then sum
  const int rows4 = src.row_items(16);
  for (int w = t; w < rows4; w += nt) {
    int g, r;
    src.row_at(16, w, g, r);
    const int np = src.pad(g), i = r / 4, part = r % 4;
    const unsigned quad = 0xFu << (threadIdx.x & 28u);
    const Problem pr = src.problem(g);
    float* P = src.P(g) + i * src.sld(g);
    float m = -INFINITY;
    for (int j = part; j < np; j += 4) m = fmaxf(m, P[j]);
    m = fmaxf(m, __shfl_xor_sync(quad, m, 1));
    m = fmaxf(m, __shfl_xor_sync(quad, m, 2));
    float l = 0.f;
    for (int j = part; j < np; j += 4) {
      float e = m == -INFINITY ? 0.f : expf(P[j] - m);
      l += e;
      if constexpr (DROP)
        if (e != 0.f && !keep(pr.b, pr.h, H, S, pr.s0 + i, pr.s0 + j))
          e = 0.f;
      P[j] = e;
    }
    l += __shfl_xor_sync(quad, l, 1);
    l += __shfl_xor_sync(quad, l, 2);
    if (part == 0 && i < pr.n) {
      src.inv(g)[i] = (DROP ? keep.inv_keep : 1.f) / fmaxf(l, 1e-16f);
      if (STATS) {
        const long at = (pr.b * S + pr.s0 + i) * H + pr.h;
        stat_m[at] = m;
        stat_l[at] = l;
      }
    }
  }
  src.wait();
  __syncthreads();

  const int prods = src.row_items(C4);
  for (int w = t; w < prods; w += nt) {
    int g, r;
    src.row_at(C4, w, g, r);
    const int i0 = r / C4 * 4, c0 = r % C4 * 4;
    const Problem pr = src.problem(g);
    float acc[4][4];
    zero(acc);
    rows_times<HD>(src.P(g), src.V(g), src.sld(g), round4(pr.n), i0, c0,
                   acc);
    float* o = out + (pr.b * S + pr.s0) * d + pr.h * HD + c0;
    const float* inv = src.inv(g);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      if (i0 + a >= pr.n) break;
      const float li = inv[i0 + a];
      st4(o + (i0 + a) * d, make_float4(acc[a][0] * li, acc[a][1] * li,
                                        acc[a][2] * li, acc[a][3] * li));
    }
  }
}

// ---- the backward on whole spans ---------------------------------------
//
// dqkv for the span source's problems from the forward's out, m and l
// ([B, S, H]) and the cotangent: delta = dO.O, then p, dp and ds of each
// pair once (one dropout draw) into the score tiles, then dK, dV by (key,
// channel) and dQ by (query, channel) micro-tiles.
template <int HD, class Src, class Keep>
__device__ __forceinline__ void bwd_tile(Src& src,
                                         const float* __restrict__ qkv,
                                         const float* __restrict__ out,
                                         float* __restrict__ dqkv, int S,
                                         int d, int H, float scale,
                                         const Keep& keep) {
  constexpr int LD = HD + 4, C4 = HD / 4;
  const int t = threadIdx.x, nt = blockDim.x;
  const long d3 = 3L * d;
  src.load(qkv, d);
  __syncthreads();
  // delta_i = dO_i . O_i: dO from the staged tile, O from memory
  const int rows = src.row_items(4);
  for (int w = t; w < rows; w += nt) {
    int g, i;
    src.row_at(4, w, g, i);
    const Problem pr = src.problem(g);
    if (i < pr.n) {
      const float* o = out + (pr.b * S + pr.s0 + i) * d + pr.h * HD;
      const float* gi = src.G(g) + i * LD;
      float de = 0.f;
#pragma unroll
      for (int c = 0; c < HD; c += 4) de = dot4(ld4(o + c), ld4(gi + c), de);
      src.de(g)[i] = de;
    }
  }
  __syncthreads();

  // each pair once: P_drop and dS into the score tiles
  const int pairs = src.pair_items();
  for (int w = t; w < pairs; w += nt) {
    int g, r;
    src.pair_at(w, g, r);
    const int nr = src.pad(g) / 4, sld = src.sld(g);
    const int ti = r / nr, tj = r % nr;
    const Problem pr = src.problem(g);
    const float* mr = src.m(g);
    const float* lr = src.li(g);
    const float* dr = src.de(g);
    const auto meets = src.mask(g);
    float s[4][4], dp[4][4];
    dots<HD, true>(src.Q(g), src.K(g), src.G(g), src.V(g), ti, tj, nr, s, dp);
    float* P = src.P(g);
    float* D = src.D(g);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ti + a * nr;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = tj + b * nr;
        float pd = 0.f, ds = 0.f;
        if (i < pr.n && meets(i, j)) {
          const bool kept =
              !keep.on || keep(pr.b, pr.h, H, S, pr.s0 + i, pr.s0 + j);
          pair_grad(s[a][b] * scale, dp[a][b], mr[i], lr[i], dr[i], kept,
                    keep, pd, ds);
        }
        P[i * sld + j] = pd;
        D[i * sld + j] = ds;
      }
    }
  }
  __syncthreads();

  // the products: dK, dV by (key, channel) and dQ by (query, channel)
  const int prods = src.row_items(2 * C4);
  for (int w = t; w < prods; w += nt) {
    int g, r;
    src.row_at(2 * C4, w, g, r);
    const int nr = src.pad(g) / 4, sld = src.sld(g), half = nr * C4;
    const Problem pr = src.problem(g);
    float* base = dqkv + (pr.b * S + pr.s0) * d3 + pr.h * HD;
    float acc[4][4], acc2[4][4];
    zero(acc);
    if (r < half) {
      const int j0 = r / C4 * 4, c0 = r % C4 * 4;
      zero(acc2);
      keys_times<HD>(src.P(g), src.D(g), src.G(g), src.Q(g), sld, pr.n, j0,
                     c0, acc, acc2);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (j0 + b >= pr.n) break;
        float* o = base + (j0 + b) * d3 + c0;
        st4(o + d, make_float4(acc[b][0] * scale, acc[b][1] * scale,
                               acc[b][2] * scale, acc[b][3] * scale));
        st4(o + 2 * d,
            make_float4(acc2[b][0], acc2[b][1], acc2[b][2], acc2[b][3]));
      }
    } else {
      const int i0 = (r - half) / C4 * 4, c0 = (r - half) % C4 * 4;
      rows_times<HD>(src.D(g), src.K(g), sld, round4(pr.n), i0, c0, acc);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        if (i0 + a >= pr.n) break;
        st4(base + (i0 + a) * d3 + c0,
            make_float4(acc[a][0] * scale, acc[a][1] * scale,
                        acc[a][2] * scale, acc[a][3] * scale));
      }
    }
  }
}

// ---- the bf16 bodies (K2's bf16 instances) ----------------------------
//
// The same phases on the same float tiles, staged from bf16, with the
// rounding points of the JAX kernel in bf16 (graphtrans_tpu/ops/pallas/
// attention_packed.py:152-206, :238-285). The products stay on the f32
// micro-tiles, fed from the bf16 values widened in shared memory: the
// work of a molecule row is a few small segments, whose pair and product
// phases are bound by the staging and the softmax's barriers, not by the
// FMAs (PERF.md section 6), so the tensor cores' m16n8k16 would buy little
// here and would put a second tile layout beside the f32 instance's.

// The forward: the scores once into the tile (as fwd_tile), an exact
// two-pass softmax per query row, then each probability normalised by the
// undropped sum, dropped and scaled, and rounded to bf16 once in the tile;
// O = P V summed in float32 and rounded once. m and l as fwd_tile's.
template <int HD, bool DROP, bool STATS, class Src, class Keep>
__device__ __forceinline__ void fwd_tile_bf16(Src& src,
                                              const bf16* __restrict__ qkv,
                                              bf16* __restrict__ out,
                                              float* __restrict__ stat_m,
                                              float* __restrict__ stat_l,
                                              int S, int d, int H,
                                              float scale, const Keep& keep) {
  constexpr int C4 = HD / 4;
  const int t = threadIdx.x, nt = blockDim.x;
  src.load(qkv, d);
  __syncthreads();

  const int pairs = src.pair_items();
  for (int w = t; w < pairs; w += nt) {
    int g, r;
    src.pair_at(w, g, r);
    const int nr = src.pad(g) / 4, sld = src.sld(g);
    const int ti = r / nr, tj = r % nr;
    float s[4][4], unused[4][4];
    dots<HD, false>(src.Q(g), src.K(g), nullptr, nullptr, ti, tj, nr, s,
                    unused);
    const auto meets = src.mask(g);
    float* P = src.P(g);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int i = ti + a * nr, j = tj + b * nr;
        P[i * sld + j] = meets(i, j) ? s[a][b] * scale : -INFINITY;
      }
  }
  __syncthreads();
  src.after_pairs(qkv, d);

  // four threads a row: max, the undropped sum, then p = e / l, dropped
  // and scaled, rounded to bf16
  const int rows4 = src.row_items(16);
  for (int w = t; w < rows4; w += nt) {
    int g, r;
    src.row_at(16, w, g, r);
    const int np = src.pad(g), i = r / 4, part = r % 4;
    const unsigned quad = 0xFu << (threadIdx.x & 28u);
    const Problem pr = src.problem(g);
    float* P = src.P(g) + i * src.sld(g);
    float m = -INFINITY;
    for (int j = part; j < np; j += 4) m = fmaxf(m, P[j]);
    m = fmaxf(m, __shfl_xor_sync(quad, m, 1));
    m = fmaxf(m, __shfl_xor_sync(quad, m, 2));
    float l = 0.f;
    for (int j = part; j < np; j += 4) {
      const float e = m == -INFINITY ? 0.f : expf(P[j] - m);
      l += e;
      P[j] = e;
    }
    l += __shfl_xor_sync(quad, l, 1);
    l += __shfl_xor_sync(quad, l, 2);
    const float den = fmaxf(l, 1e-16f);
    for (int j = part; j < np; j += 4) {
      float p = P[j] / den;
      if constexpr (DROP)
        p = (p != 0.f && keep(pr.b, pr.h, H, S, pr.s0 + i, pr.s0 + j))
                ? p * keep.inv_keep
                : 0.f;
      P[j] = round_bf16(p);
    }
    if (STATS && part == 0 && i < pr.n) {
      const long at = (pr.b * S + pr.s0 + i) * H + pr.h;
      stat_m[at] = m;
      stat_l[at] = l;
    }
  }
  src.wait();
  __syncthreads();

  const int prods = src.row_items(C4);
  for (int w = t; w < prods; w += nt) {
    int g, r;
    src.row_at(C4, w, g, r);
    const int i0 = r / C4 * 4, c0 = r % C4 * 4;
    const Problem pr = src.problem(g);
    float acc[4][4];
    zero(acc);
    rows_times<HD>(src.P(g), src.V(g), src.sld(g), round4(pr.n), i0, c0,
                   acc);
    bf16* o = out + (pr.b * S + pr.s0) * d + pr.h * HD + c0;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      if (i0 + a >= pr.n) break;
      st4(o + (i0 + a) * d,
          make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]));
    }
  }
}

// The backward from the forward's m and l: p and the dropped dp of each
// pair once (one dropout draw; a dropped pair's p keeps its sign bit set),
// delta_i = sum_j p_ij dp_ij over the row, as the JAX kernel forms it from
// the undropped p (not dO.O: the forward's O was rounded); then P_drop and
// dS = p (dp - delta) * scale each rounded to bf16 once in the tiles; dK
// = dS^T Q, dV = P_drop^T dO and dQ = dS K summed in float32, each rounded
// once.
template <int HD, class Src, class Keep>
__device__ __forceinline__ void bwd_tile_bf16(Src& src,
                                              const bf16* __restrict__ qkv,
                                              bf16* __restrict__ dqkv, int S,
                                              int d, int H, float scale,
                                              const Keep& keep) {
  constexpr int C4 = HD / 4;
  const int t = threadIdx.x, nt = blockDim.x;
  const long d3 = 3L * d;
  src.load(qkv, d);
  __syncthreads();

  const int pairs = src.pair_items();
  for (int w = t; w < pairs; w += nt) {
    int g, r;
    src.pair_at(w, g, r);
    const int nr = src.pad(g) / 4, sld = src.sld(g);
    const int ti = r / nr, tj = r % nr;
    const Problem pr = src.problem(g);
    const float* mr = src.m(g);
    const float* lr = src.li(g);
    const auto meets = src.mask(g);
    float s[4][4], dp[4][4];
    dots<HD, true>(src.Q(g), src.K(g), src.G(g), src.V(g), ti, tj, nr, s, dp);
    float* P = src.P(g);
    float* D = src.D(g);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ti + a * nr;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = tj + b * nr;
        float pv = 0.f, dv = 0.f;
        if (i < pr.n && meets(i, j)) {
          const bool kept =
              !keep.on || keep(pr.b, pr.h, H, S, pr.s0 + i, pr.s0 + j);
          const float p = expf(s[a][b] * scale - mr[i]) * lr[i];
          pv = kept ? p : -p;
          dv = kept ? (keep.on ? dp[a][b] * keep.inv_keep : dp[a][b]) : 0.f;
        }
        P[i * sld + j] = pv;
        D[i * sld + j] = dv;
      }
    }
  }
  __syncthreads();

  // delta of each query row: four threads a row
  const int rows4 = src.row_items(16);
  for (int w = t; w < rows4; w += nt) {
    int g, r;
    src.row_at(16, w, g, r);
    const int np = src.pad(g), i = r / 4, part = r % 4, sld = src.sld(g);
    const unsigned quad = 0xFu << (threadIdx.x & 28u);
    const float* P = src.P(g) + i * sld;
    const float* D = src.D(g) + i * sld;
    float de = 0.f;
    for (int j = part; j < np; j += 4) de = fmaf(fabsf(P[j]), D[j], de);
    de += __shfl_xor_sync(quad, de, 1);
    de += __shfl_xor_sync(quad, de, 2);
    if (part == 0 && i < src.problem(g).n) src.de(g)[i] = de;
  }
  __syncthreads();

  // P_drop and dS, rounded to bf16 in the tiles
  for (int w = t; w < pairs; w += nt) {
    int g, r;
    src.pair_at(w, g, r);
    const int nr = src.pad(g) / 4, sld = src.sld(g);
    const int ti = r / nr, tj = r % nr;
    const int n = src.problem(g).n;
    const float* dr = src.de(g);
    float* P = src.P(g);
    float* D = src.D(g);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ti + a * nr;
      const float de = i < n ? dr[i] : 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int at = i * sld + tj + b * nr;
        const float pv = P[at], p = fabsf(pv);
        const float pd = signbit(pv) ? 0.f : (keep.on ? p * keep.inv_keep : p);
        P[at] = round_bf16(pd);
        D[at] = round_bf16(p * (D[at] - de) * scale);
      }
    }
  }
  __syncthreads();

  // the products: dK, dV by (key, channel) and dQ by (query, channel)
  const int prods = src.row_items(2 * C4);
  for (int w = t; w < prods; w += nt) {
    int g, r;
    src.row_at(2 * C4, w, g, r);
    const int nr = src.pad(g) / 4, sld = src.sld(g), half = nr * C4;
    const Problem pr = src.problem(g);
    bf16* base = dqkv + (pr.b * S + pr.s0) * d3 + pr.h * HD;
    float acc[4][4], acc2[4][4];
    zero(acc);
    if (r < half) {
      const int j0 = r / C4 * 4, c0 = r % C4 * 4;
      zero(acc2);
      keys_times<HD>(src.P(g), src.D(g), src.G(g), src.Q(g), sld, pr.n, j0,
                     c0, acc, acc2);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (j0 + b >= pr.n) break;
        bf16* o = base + (j0 + b) * d3 + c0;
        st4(o + d, make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]));
        st4(o + 2 * d,
            make_float4(acc2[b][0], acc2[b][1], acc2[b][2], acc2[b][3]));
      }
    } else {
      const int i0 = (r - half) / C4 * 4, c0 = (r - half) % C4 * 4;
      rows_times<HD>(src.D(g), src.K(g), sld, round4(pr.n), i0, c0, acc);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        if (i0 + a >= pr.n) break;
        st4(base + (i0 + a) * d3 + c0,
            make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]));
      }
    }
  }
}

// K4's and K9's short backward: spans of up to SHORT_MAX tokens, `group`
// problems a block, np the span width rounded up to 4.
template <int HD, class Keep>
__device__ __forceinline__ void bwd_short(
    const float* __restrict__ qkv, const unsigned char* __restrict__ valid,
    const float* __restrict__ out, const float* __restrict__ gout,
    const float* __restrict__ stat_m, const float* __restrict__ stat_l,
    float* __restrict__ dqkv, int B, int S, int d, int H, int block, int np,
    int group, float scale, Keep keep) {
  FixedSpans<HD, true> src(valid, gout, stat_m, stat_l, B, S, H, block, np,
                           group);
  bwd_tile<HD>(src, qkv, out, dqkv, S, d, H, scale, keep);
}

// K4's and K9's forward on spans of up to 128 tokens, `group` a block.
template <int HD, bool DROP, bool STATS, class Keep>
__device__ __forceinline__ void fwd_short(
    const float* __restrict__ qkv, const unsigned char* __restrict__ valid,
    float* __restrict__ out, float* __restrict__ stat_m,
    float* __restrict__ stat_l, int B, int S, int d, int H, int block,
    int np, int group, float scale, Keep keep) {
  FixedSpans<HD, false> src(valid, nullptr, nullptr, nullptr, B, S, H, block,
                            np, group);
  fwd_tile<HD, DROP, STATS>(src, qkv, out, stat_m, stat_l, S, d, H, scale,
                            keep);
}

// ---- the wide backward: spans of up to 384 tokens, 64-token tiles ------
//
// One problem a block of THREADS threads; npad: the span width rounded up
// to WIDE.
template <int HD, class Keep>
__device__ __forceinline__ void bwd_wide(
    const float* __restrict__ qkv, const unsigned char* __restrict__ valid,
    const float* __restrict__ out, const float* __restrict__ gout,
    const float* __restrict__ stat_m, const float* __restrict__ stat_l,
    float* __restrict__ dqkv, int S, int d, int H, int block, int npad,
    float scale, Keep keep) {
  constexpr int LD = HD + 4, C4 = HD / 4, T = WIDE, NR = WIDE / 4;
  constexpr int SLD = WIDE + 4;
  constexpr int NKV = NR * C4;  // (key, channel) micro-tiles: dK and dV
  static_assert(NR * NR == THREADS && NKV <= THREADS, "one tile a thread");
  extern __shared__ float4 smem4[];
  float* const K = reinterpret_cast<float*>(smem4);
  float* const V = K + T * LD;
  float* const Q = V + T * LD;
  float* const G = Q + T * LD;
  float* const Pd = G + T * LD;
  float* const dS = Pd + T * SLD;
  float* const dQa = dS + T * SLD;   // [npad][LD]: the span's dQ sums
  float* const mq = dQa + npad * LD;  // per query: m, 1/l, delta
  float* const lq = mq + npad;
  float* const dl = lq + npad;
  float* const kv = dl + npad;        // per key of the tile: 0/1

  const int t = threadIdx.x, nt = blockDim.x;
  const Problem pr = problem_at(blockIdx.x, S, spans_of(S, block), H);
  const long d3 = 3L * d, tok0 = pr.b * S + pr.s0;
  const float* row = qkv + tok0 * d3 + pr.h * HD;
  const float* grow = gout + tok0 * d + pr.h * HD;
  float* drow = dqkv + tok0 * d3 + pr.h * HD;
  const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int i = t; i < npad; i += nt) {
    float m = 0.f, li = 0.f, de = 0.f;
    if (i < pr.n) {
      const long at = (tok0 + i) * H + pr.h;
      m = stat_m[at];
      li = 1.f / fmaxf(stat_l[at], 1e-16f);
      const float* o = out + (tok0 + i) * d + pr.h * HD;
      const float* g = grow + i * d;
#pragma unroll
      for (int c = 0; c < HD; c += 4) de = dot4(ld4(o + c), ld4(g + c), de);
    }
    mq[i] = m;
    lq[i] = li;
    dl[i] = de;
  }
  for (int idx = t; idx < npad * LD / 4; idx += nt) st4(dQa + 4 * idx, z4);

  const int j0 = t / C4 * 4, c0 = t % C4 * 4;  // this thread's dK, dV tile
  for (int k0 = 0; k0 < pr.n; k0 += T) {
    const int nk = min(T, pr.n - k0);
    {
      float* const dst[2] = {K, V};
      const float* const src[2] = {row + k0 * d3 + d, row + k0 * d3 + 2 * d};
      const long ld[2] = {d3, d3};
      stage<HD, 2>(dst, src, ld, nk, T, t, nt);
    }
    bool mine = false;
    if (t < T) {
      mine = t < nk && valid[tok0 + k0 + t];
      kv[t] = mine ? 1.f : 0.f;
    }
    if (!__syncthreads_or(mine)) {  // no valid key: dk = dv = 0
      for (int idx = t; idx < nk * C4; idx += nt) {
        float* o = drow + (k0 + idx / C4) * d3 + idx % C4 * 4;
        st4(o + d, z4);
        st4(o + 2 * d, z4);
      }
      continue;
    }
    float dk[4][4], dv[4][4];
    zero(dk);
    zero(dv);
    for (int q0 = 0; q0 < pr.n; q0 += T) {
      const int nq = min(T, pr.n - q0);
      {
        float* const dst[2] = {Q, G};
        const float* const src[2] = {row + q0 * d3, grow + q0 * d};
        const long ld[2] = {d3, d};
        stage<HD, 2>(dst, src, ld, nq, T, t, nt);
      }
      __syncthreads();
      {
        const int ti = t / NR, tj = t % NR;
        float s[4][4], dp[4][4];
        dots<HD, true>(Q, K, G, V, ti, tj, NR, s, dp);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = ti + a * NR;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int j = tj + b * NR;
            float pd = 0.f, ds = 0.f;
            if (i < nq && kv[j] != 0.f) {
              const bool kept = !keep.on || keep(pr.b, pr.h, H, S,
                                                 pr.s0 + q0 + i,
                                                 pr.s0 + k0 + j);
              pair_grad(s[a][b] * scale, dp[a][b], mq[q0 + i], lq[q0 + i],
                        dl[q0 + i], kept, keep, pd, ds);
            }
            Pd[i * SLD + j] = pd;
            dS[i * SLD + j] = ds;
          }
        }
      }
      __syncthreads();
      if (t < NKV) keys_times<HD>(Pd, dS, G, Q, SLD, nq, j0, c0, dk, dv);
      for (int w = t - NKV; w < NR * C4; w += nt) {
        if (w < 0) continue;
        const int i0 = w / C4 * 4, cq = w % C4 * 4;
        float acc[4][4];
        zero(acc);
        rows_times<HD>(dS, K, SLD, round4(nk), i0, cq, acc);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          float* q = dQa + (q0 + i0 + a) * LD + cq;
          const float4 v = ld4(q);
          st4(q, make_float4(v.x + acc[a][0], v.y + acc[a][1],
                             v.z + acc[a][2], v.w + acc[a][3]));
        }
      }
      __syncthreads();  // Q, G and the score tiles are overwritten next
    }
    if (t < NKV) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (j0 + b >= nk) break;
        float* o = drow + (k0 + j0 + b) * d3 + c0;
        st4(o + d, make_float4(dk[b][0] * scale, dk[b][1] * scale,
                               dk[b][2] * scale, dk[b][3] * scale));
        st4(o + 2 * d, make_float4(dv[b][0], dv[b][1], dv[b][2], dv[b][3]));
      }
    }
  }
  __syncthreads();
  for (int idx = t; idx < pr.n * C4; idx += nt) {
    const int i = idx / C4, c = idx % C4 * 4;
    const float4 v = ld4(dQa + i * LD + c);
    st4(drow + i * d3 + c,
        make_float4(v.x * scale, v.y * scale, v.z * scale, v.w * scale));
  }
}


}  // namespace tile
