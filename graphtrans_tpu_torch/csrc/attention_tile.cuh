// Attention over one whole attention block at a time: K4's backward
// (attention_packed.cu), and K9's forward on short spans and its backward
// up to 384 tokens (attention_smalls.cu), over qkv [B, S, 3d] with heads in
// lanes.
//
// An attention block ("span") is the token range whose queries and keys
// meet under K4's mask: with block > 0 one graph block of a packed row,
// [g*block, min(S, (g+1)*block)); with block 0 the whole row. Key j of a
// span is attendable iff valid[j]; every query of the span attends the
// span's valid keys (a padding query too), and a span without a valid key
// gives zeros. A problem is one (row, span, head).
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

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace tile {

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

// ---- the short backward: spans of up to SHORT_MAX tokens, whole --------
//
// dqkv for `group` problems a block from the forward's out, m and l
// ([B, S, H]) and the cotangent gout. np: the span width rounded up to 4.
template <int HD, class Keep>
__device__ __forceinline__ void bwd_short(
    const float* __restrict__ qkv, const unsigned char* __restrict__ valid,
    const float* __restrict__ out, const float* __restrict__ gout,
    const float* __restrict__ stat_m, const float* __restrict__ stat_l,
    float* __restrict__ dqkv, int B, int S, int d, int H, int block, int np,
    int group, float scale, Keep keep) {
  constexpr int LD = HD + 4, C4 = HD / 4;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int t = threadIdx.x, nt = blockDim.x;
  const int nr = np / 4, sld = np + 4, per = bwd_short_floats(np, HD);
  const Spans sp = spans_of(S, block);
  const long p0 = (long)blockIdx.x * group;
  const long left = (long)B * sp.count * H - p0;
  const int ng = left < group ? (int)left : group;  // problems of this block
  const long d3 = 3L * d;
  // a problem's shared tiles
  auto Qs = [&](int g) { return smem + g * per; };
  auto Ks = [&](int g) { return smem + g * per + np * LD; };
  auto Vs = [&](int g) { return smem + g * per + 2 * np * LD; };
  auto Gs = [&](int g) { return smem + g * per + 3 * np * LD; };
  auto Ps = [&](int g) { return smem + g * per + 4 * np * LD; };
  auto Ds = [&](int g) { return smem + g * per + 4 * np * LD + np * sld; };
  auto Ms = [&](int g) { return smem + g * per + 4 * np * LD + 2 * np * sld; };
  // per row: m, 1/l, delta, key mask (Ms(g) + 0, np, 2np, 3np)

  for (int g = 0; g < ng; ++g) {
    const Problem pr = problem_at(p0 + g, S, sp, H);
    const long tok0 = pr.b * S + pr.s0;
    const float* row = qkv + tok0 * d3 + pr.h * HD;
    float* const dst[4] = {Qs(g), Ks(g), Vs(g), Gs(g)};
    const float* const src[4] = {row, row + d, row + 2 * d,
                                 gout + tok0 * d + pr.h * HD};
    const long ld[4] = {d3, d3, d3, d};
    stage<HD, 4>(dst, src, ld, pr.n, np, t, nt);
    float* st = Ms(g);
    for (int i = t; i < np; i += nt) {
      float m = 0.f, li = 0.f, kv = 0.f;
      if (i < pr.n) {
        const long at = (tok0 + i) * H + pr.h;
        m = stat_m[at];
        li = 1.f / fmaxf(stat_l[at], 1e-16f);
        kv = valid[tok0 + i] ? 1.f : 0.f;
      }
      st[i] = m;
      st[np + i] = li;
      st[3 * np + i] = kv;
    }
  }
  __syncthreads();
  // delta_i = dO_i . O_i: dO from the staged tile, O from memory
  for (int w = t; w < ng * np; w += nt) {
    const int g = w / np, i = w % np;
    const Problem pr = problem_at(p0 + g, S, sp, H);
    float de = 0.f;
    if (i < pr.n) {
      const float* o = out + (pr.b * S + pr.s0 + i) * d + pr.h * HD;
      const float* gi = Gs(g) + i * LD;
#pragma unroll
      for (int c = 0; c < HD; c += 4) de = dot4(ld4(o + c), ld4(gi + c), de);
    }
    Ms(g)[2 * np + i] = de;
  }
  __syncthreads();

  // each pair once: P_drop and dS into the score tiles
  for (int w = t; w < ng * nr * nr; w += nt) {
    const int g = w / (nr * nr), ti = w % (nr * nr) / nr, tj = w % nr;
    const Problem pr = problem_at(p0 + g, S, sp, H);
    const float* st = Ms(g);
    float s[4][4], dp[4][4];
    dots<HD, true>(Qs(g), Ks(g), Gs(g), Vs(g), ti, tj, nr, s, dp);
    float* P = Ps(g);
    float* D = Ds(g);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ti + a * nr;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = tj + b * nr;
        float pd = 0.f, ds = 0.f;
        if (i < pr.n && st[3 * np + j] != 0.f) {
          const bool kept =
              !keep.on || keep(pr.b, pr.h, H, S, pr.s0 + i, pr.s0 + j);
          pair_grad(s[a][b] * scale, dp[a][b], st[i], st[np + i],
                    st[2 * np + i], kept, keep, pd, ds);
        }
        P[i * sld + j] = pd;
        D[i * sld + j] = ds;
      }
    }
  }
  __syncthreads();

  // the products: dK, dV by (key, channel) and dQ by (query, channel)
  const int half = nr * C4;
  for (int w = t; w < ng * 2 * half; w += nt) {
    const int g = w / (2 * half), r = w % (2 * half);
    const Problem pr = problem_at(p0 + g, S, sp, H);
    float* base = dqkv + (pr.b * S + pr.s0) * d3 + pr.h * HD;
    float acc[4][4], acc2[4][4];
    zero(acc);
    if (r < half) {
      const int j0 = r / C4 * 4, c0 = r % C4 * 4;
      zero(acc2);
      keys_times<HD>(Ps(g), Ds(g), Gs(g), Qs(g), sld, pr.n, j0, c0, acc,
                     acc2);
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
      rows_times<HD>(Ds(g), Ks(g), sld, round4(pr.n), i0, c0, acc);
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

// ---- the forward on short spans ----------------------------------------
//
// out for `group` problems a block: the scores once into a shared tile, an
// exact two-pass softmax per query row (max, then the sum of undropped
// exp(s - m)), then O = P_drop V / l. STATS writes m (the max scaled score)
// and l [B, S, H] as attention_fwd.cuh defines them; a query with no
// attendable key writes zeros, m = -inf and l = 0.
template <int HD, bool DROP, bool STATS, class Keep>
__device__ __forceinline__ void fwd_short(
    const float* __restrict__ qkv, const unsigned char* __restrict__ valid,
    float* __restrict__ out, float* __restrict__ stat_m,
    float* __restrict__ stat_l, int B, int S, int d, int H, int block,
    int np, int group, float scale, Keep keep) {
  constexpr int LD = HD + 4;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int t = threadIdx.x, nt = blockDim.x;
  const int nr = np / 4, sld = np + 4, per = fwd_floats(np, HD);
  const Spans sp = spans_of(S, block);
  const long p0 = (long)blockIdx.x * group;
  const long left = (long)B * sp.count * H - p0;
  const int ng = left < group ? (int)left : group;  // problems of this block
  const long d3 = 3L * d;
  auto Qs = [&](int g) { return smem + g * per; };
  auto Ks = [&](int g) { return smem + g * per + np * LD; };
  auto Vs = [&](int g) { return smem + g * per + 2 * np * LD; };
  auto Ps = [&](int g) { return smem + g * per + 3 * np * LD; };
  // per row: 1/l (times 1/(1-rate)), key mask
  auto Ls = [&](int g) { return smem + g * per + 3 * np * LD + np * sld; };

  for (int g = 0; g < ng; ++g) {
    const Problem pr = problem_at(p0 + g, S, sp, H);
    const long tok0 = pr.b * S + pr.s0;
    const float* row = qkv + tok0 * d3 + pr.h * HD;
    float* const dst[3] = {Qs(g), Ks(g), Vs(g)};
    const float* const src[3] = {row, row + d, row + 2 * d};
    const long ld[3] = {d3, d3, d3};
    stage<HD, 3>(dst, src, ld, pr.n, np, t, nt);
    for (int j = t; j < np; j += nt)
      Ls(g)[np + j] = (j < pr.n && valid[tok0 + j]) ? 1.f : 0.f;
  }
  __syncthreads();

  for (int w = t; w < ng * nr * nr; w += nt) {
    const int g = w / (nr * nr), ti = w % (nr * nr) / nr, tj = w % nr;
    float s[4][4], unused[4][4];
    dots<HD, false>(Qs(g), Ks(g), nullptr, nullptr, ti, tj, nr, s, unused);
    const float* kv = Ls(g) + np;
    float* P = Ps(g);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = tj + b * nr;
        P[(ti + a * nr) * sld + j] =
            kv[j] != 0.f ? s[a][b] * scale : -INFINITY;
      }
  }
  __syncthreads();

  // four threads a row (aligned lanes of one warp): max, then sum
  for (int w = t; w < ng * np * 4; w += nt) {
    const int g = w / (4 * np), i = w % (4 * np) / 4, part = w % 4;
    const unsigned quad = 0xFu << (threadIdx.x & 28u);
    const Problem pr = problem_at(p0 + g, S, sp, H);
    float* P = Ps(g) + i * sld;
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
    if (part == 0) {
      Ls(g)[i] = (DROP ? keep.inv_keep : 1.f) / fmaxf(l, 1e-16f);
      if (STATS && i < pr.n) {
        const long at = (pr.b * S + pr.s0 + i) * H + pr.h;
        stat_m[at] = m;
        stat_l[at] = l;
      }
    }
  }
  __syncthreads();

  constexpr int C4 = HD / 4;
  for (int w = t; w < ng * nr * C4; w += nt) {
    const int g = w / (nr * C4), r = w % (nr * C4);
    const int i0 = r / C4 * 4, c0 = r % C4 * 4;
    const Problem pr = problem_at(p0 + g, S, sp, H);
    float acc[4][4];
    zero(acc);
    rows_times<HD>(Ps(g), Vs(g), sld, round4(pr.n), i0, c0, acc);
    float* o = out + (pr.b * S + pr.s0) * d + pr.h * HD + c0;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      if (i0 + a >= pr.n) break;
      const float li = Ls(g)[i0 + a];
      st4(o + (i0 + a) * d, make_float4(acc[a][0] * li, acc[a][1] * li,
                                        acc[a][2] * li, acc[a][3] * li));
    }
  }
}

}  // namespace tile
