// The bf16 key-list attention: K4's and K5's bf16 instances (the bf16 step
// of the Transformer-only model), forward and backward, over qkv [B, S, 3d]
// with heads in lanes, heads of HD channels (a template parameter; the
// entries instantiate 64, the published configs' width, and refuse every
// other).
//
// The mask is a pair of tags (policy Tags, attention_bwd.cuh): query i
// attends key j iff qtag(i) == ktag(j) >= 0 (K4: PadTags, a query's block
// and a valid key's block; K5: SegTags, segq and segk). The row is cut
// into spans that no pair crosses: K4's graph blocks (block > 0) or the
// whole row. Dropout (policy Keep: on, inv_keep and split(b, h, H, S),
// whose at(i) + col(j) is the hash input of the pair of the row's tokens i
// and j, keeps(x) its bit: the row's seed made once a block, no division a
// pair) is drawn again from the seed in every kernel; nothing is stored.
//
// What they compute, with the rounding points of the JAX kernels in bf16 on
// the TPU (one bf16 MXU pass a product, float32 sums): q.k from the bf16
// operands in float32, scaled; m and l (the max scaled score and the sum of
// the undropped exp(s - m)) in float32. NORM (K4, graphtrans_tpu/ops/
// pallas/attention_packed.py:_probs_all, attn_bwd_math): the normalised p =
// exp(s - m) / l, dropped and rescaled, rounded to bf16 before P V; the
// backward's delta is summed from the pairs (sum_j p dp_drop), and dS = p
// (dp_drop - delta) scale is rounded. Otherwise (K5, flash_attention.py at
// precision None): the online softmax's unnormalised p = exp(s -
// m_running), dropped and rescaled, rounded before P V, the accumulator
// rescaled by exp(m_old - m_new) and normalised by 1/l in float32; the
// backward's delta is dO . O over the rounded output, dS = p (dp_drop -
// delta) is rounded and its products are scaled after their sums. P_drop
// is rounded before dV = P_drop^T dO; dQ, dK and dV are summed in float32
// and rounded once. A query with no key writes zeros (m = -inf, l = 0, dq
// = 0); a padding key gets dk = dv = 0.
//
// The design: the f32 long-row kernels' (attention_fwd.cuh: long_fwd;
// attention_bwd.cuh: long_dq, long_dkv) in bf16. A block of four warps per
// (row, head, tile of 64 tokens inside one span); a warp owns 16 rows of
// the tile whole. The forward and the dq kernel take a tile of queries and
// walk the span's keys whose tag meets one of the tile's query tags, ranked
// by a block-wide prefix count and gathered 64 at a time with their token
// indices (rank_keys, list_keys); the dk/dv kernel takes the z-th chunk of
// 64 valid keys of its span by rank and walks the span's query tiles whose
// tags can meet them, and also writes the zeros of the padding keys among
// its tile's tokens. Rows are staged as bf16 by 16-byte cp.async into rows
// of HD + 8 bf16 (so the eight rows an ldmatrix reads fall on distinct
// banks); every product is a bf16 mma.sync m16n8k16 with float32 sums,
// operands by ldmatrix, p and dS moved from the score accumulators into
// the next product's A fragment in registers. NORM's forward and dq kernel
// walk the keys twice (m and l, then P V; delta, then dS and dQ), staging a
// chunk again only where the tile has more than one. The backward of a span
// of up to 64 tokens (K4's graph blocks: the molecule paths) is one kernel,
// span_bwd16: the span's Q, dO, K and V staged once, its keys by position
// (a padding key's tag -1, so no ranking), the warps on its query rows
// (delta, dS, dQ), then after one barrier on its key rows (dK, dV); no
// delta passes through device memory. The dropout hash of a pair is its
// query's part plus its key's (the policy's Split, the row's seed made once
// a block): a division a pair, of the 64-bit row index, had taken the
// first K4 pair to 1.2x its f32 instance's time. Each output cell has one
// writer: no atomics, and the bits repeat from run to run.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_bwd.cuh"

namespace attn {

constexpr int LIST16_THREADS = 128;  // four warps, 16 rows each

// bf16 a staged row of hd channels
__host__ __device__ constexpr int list16_ld(int hd) { return hd + 8; }

// Shared bytes of a block: the forward's three 64-row tiles (Q, K, V), the
// backward's four (the tile's own two and its partners' two) and, per
// staged query, m log2(e), 1/l, delta and its part of the dropout hash;
// per staged query its tag, per partner key its tag and token; the prefix
// count's scratch and block_range's two ints.
__host__ __device__ constexpr int list16_bytes(int hd, bool bwd) {
  return (bwd ? 4 : 3) * LONG_T * list16_ld(hd) * 2 +
         (bwd ? 4 * LONG_T * 4 : 0) +
         (3 * LONG_T + LIST16_THREADS / 32 + 1 + 2 + 1) * 4;
}

// Tiles of a row of S tokens cut into spans of `span` tokens (the last
// may be shorter): ceil(span / 64) a span.
__host__ __device__ constexpr int list16_tiles(int S, int span) {
  return (S + span - 1) / span * ((span + LONG_T - 1) / LONG_T);
}

// The longest span the forward's instance 1 (the tile instance) and the
// backward's (the short one: span_bwd16, one kernel) take.
__host__ __device__ constexpr int list16_short_max(bool bwd) {
  return bwd ? LONG_T : 128;
}

// A wrapper's launch: instance 1 (spans of up to list16_short_max) or 3
// (wider), a block of LIST16_THREADS per (row, head, tile).
__host__ inline bool list16_launch_ok(const tile::Launch& L, int B, int S,
                                      int span, int H, int hd, bool bwd) {
  return L.instance == (span <= list16_short_max(bwd) ? 1 : 3) &&
         L.pad == LONG_T &&
         L.group == 1 && L.gx == B && L.gy == H &&
         L.gz == list16_tiles(S, span) && L.threads == LIST16_THREADS &&
         L.smem == list16_bytes(hd, bwd) && L.smem <= tile::SMEM_MAX;
}

namespace l16 {

using tile::bf16;
constexpr int T = LONG_T;
using lr::exp_ml;
using lr::LOG2E;
using lr::rcp;

// The block's shared memory.
template <int HD>
struct Tiles16 {
  static constexpr int LD = HD + 8;
  bf16 *X0, *X1;  // the tile's own rows: forward Q; dq Q, dO; dk/dv K, V
  bf16 *Y0, *Y1;  // the partners' rows: K, V; dk/dv Q, dO
  float *qml, *qli, *qde;  // per staged query: m log2(e), 1/l, delta
  unsigned* qat;           // and its part of the dropout hash
  int *qt, *kt, *kix;      // per staged query its tag; per key its tag, token
  int *scan, *range;

  __device__ Tiles16(float4* s, bool bwd) {
    constexpr int R = T * LD;
    X0 = reinterpret_cast<bf16*>(s);
    X1 = X0 + R;
    Y0 = X0 + (bwd ? 2 : 1) * R;
    Y1 = Y0 + R;
    qml = reinterpret_cast<float*>(Y1 + R);
    qli = qml + T;
    qde = qli + T;
    qat = reinterpret_cast<unsigned*>(qde + T);
    qt = bwd ? reinterpret_cast<int*>(qat + T) : reinterpret_cast<int*>(qml);
    kt = qt + T;
    kix = kt + T;
    scan = kix + T;
    range = scan + LIST16_THREADS / 32 + 1;
  }
};

// The block's tile: its span [s0, s1) and its tokens [r0, r0 + n) (n <= 0:
// a tile past a short last span).
struct SpanTile {
  int s0, s1, r0, n;
};
__device__ __forceinline__ SpanTile span_tile(int S, int span) {
  const int tps = (span + T - 1) / T, k = blockIdx.z / tps;
  SpanTile x;
  x.s0 = k * span;
  x.s1 = min(S, x.s0 + span);
  x.r0 = x.s0 + (blockIdx.z - k * tps) * T;
  x.n = min(T, x.s1 - x.r0);
  return x;
}

// Rows [0, T) of HD bf16 channels into rows of HD + 8, row r from token
// row(r) (src + row(r) * ld), zeros for r >= n. All threads take part.
template <int HD, class Row>
__device__ __forceinline__ void stage16(bf16* dst, const bf16* src, long ld,
                                        Row row, int n) {
  constexpr int LD = HD + 8, C = HD / 8;
  for (int idx = threadIdx.x; idx < T * C; idx += LIST16_THREADS) {
    const int r = idx / C, c = idx % C * 8;
    const bool ok = r < n;
    tile::cp16(dst + r * LD + c, src + (ok ? (long)row(r) : 0L) * ld + c, ok);
  }
}

// A fragments of 16 staged rows (m0..), HD / 16 of them.
template <int HD>
__device__ __forceinline__ void a_rows(unsigned (&a)[HD / 16][4],
                                       const bf16* X, int m0) {
  constexpr int LD = HD + 8;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks)
    tile::ldsm4(a[ks], X + (m0 + (lane & 15)) * LD + 16 * ks + 8 * (lane >> 4));
}

// c = A B^T for 16 rows x staged rows k0 .. k0 + 15 of B (c[hf]: rows k0 +
// 8 hf .., an m16n8 accumulator).
template <int HD>
__device__ __forceinline__ void dots16(const unsigned (&a)[HD / 16][4],
                                       const bf16* B, int k0,
                                       float (&c)[2][4]) {
  constexpr int LD = HD + 8;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    c[hf][0] = c[hf][1] = c[hf][2] = c[hf][3] = 0.f;
#pragma unroll
    for (int cg = 0; cg < HD / 32; ++cg) {
      unsigned r[4];
      tile::ldsm4(r, B + (k0 + 8 * hf + (lane & 7)) * LD + 32 * cg +
                         8 * (lane >> 3));
      tile::mma16(c[hf], a[2 * cg], r[0], r[1]);
      tile::mma16(c[hf], a[2 * cg + 1], r[2], r[3]);
    }
  }
}

// acc += A B over staged rows k0 .. k0 + 15 of B, HD channels: A an m16k16
// fragment, B k-major rows (ldmatrix .trans).
template <int HD>
__device__ __forceinline__ void times_rows(float (&acc)[HD / 8][4],
                                           const unsigned (&a)[4],
                                           const bf16* B, int k0) {
  constexpr int LD = HD + 8;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int cc = 0; cc < HD / 16; ++cc) {
    unsigned r[4];
    tile::ldsm4t(r, B + (k0 + (lane & 15)) * LD + 16 * cc + 8 * (lane >> 4));
    tile::mma16(acc[2 * cc], a, r[0], r[1]);
    tile::mma16(acc[2 * cc + 1], a, r[2], r[3]);
  }
}

// Rows g and g + 8 (lane 4g + q) of a 16 x HD float32 accumulator, scaled
// by f0 and f1, rounded to bf16, at p0 and p1 (null: not written).
template <int HD>
__device__ __forceinline__ void store_pair(bf16* p0, bf16* p1,
                                           const float (&acc)[HD / 8][4],
                                           float f0, float f1) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int cg = 0; cg < HD / 32; ++cg) {
    unsigned lo[4], hi[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float(&c)[4] = acc[4 * cg + k];
      lo[k] = tile::pack_bf16(c[0] * f0, c[1] * f0);
      hi[k] = tile::pack_bf16(c[2] * f1, c[3] * f1);
    }
    const uint4 a = tile::quad_row(lo), b = tile::quad_row(hi);
    if (p0) *reinterpret_cast<uint4*>(p0 + 32 * cg + 8 * q) = a;
    if (p1) *reinterpret_cast<uint4*>(p1 + 32 * cg + 8 * q) = b;
  }
}

// The forward: one block per (row, head, tile of up to 64 queries of a
// span). Writes out, and with STATS m and l [B, S, H], for the tile's
// queries.
template <int HD, bool NORM, bool DROP, bool STATS, class Tags, class Keep>
__device__ __forceinline__ void list_fwd16(const bf16* __restrict__ qkv,
                                           Tags tags, int span,
                                           bf16* __restrict__ out,
                                           float* __restrict__ stat_m,
                                           float* __restrict__ stat_l, int S,
                                           int d, float scale, Keep keep) {
  constexpr int KS = HD / 16, NC = HD / 8, PASSES = NORM ? 2 : 1;
  constexpr float M0 = -1e30f;  // the running max before the first key
  extern __shared__ float4 smem4[];
  const Tiles16<HD> s(smem4, false);
  const SpanTile x = span_tile(S, span);
  if (x.n <= 0) return;  // uniform
  const long b = blockIdx.x, base = b * S, d3 = 3L * d;
  const int h = blockIdx.y, H = gridDim.y, t = threadIdx.x;
  const bf16* row = qkv + base * d3 + h * HD;

  int tag = -1;
  if (t < T) {
    tag = t < x.n ? tags.qtag(base, x.r0 + t) : -1;
    s.qt[t] = tag;
  }
  stage16<HD>(s.X0, row, d3, [&](int r) { return x.r0 + r; }, x.n);
  int qmin, qmax;
  block_range(tag, s.range, qmin, qmax);
  const int nspan = x.s1 - x.s0;
  auto sel = [&](int jl) {
    const int k = tags.ktag(base, x.s0 + jl);
    return k >= qmin && k <= qmax;  // qmin >= 0
  };
  int total = 0, before = 0;
  if (qmax >= 0) before = lr::rank_keys(nspan, sel, s.scan, total);
  const int chunks = (total + T - 1) / T;
  tc::cp_wait();
  __syncthreads();  // Q has landed

  const int lane = t & 31, g = lane >> 2, q = lane & 3, m0 = (t >> 5) * 16;
  const bool live = m0 < x.n;  // uniform in the warp
  unsigned qa[KS][4];
  int rt[2] = {-1, -1};
  if (live) {
    a_rows<HD>(qa, s.X0, m0);
    rt[0] = s.qt[m0 + g];
    rt[1] = s.qt[m0 + g + 8];
  }
  float mx[2] = {M0, M0}, l[2] = {0.f, 0.f}, ml[2], inv[2] = {1.f, 1.f};
  const auto kept = keep.split(b, h, H, S);  // the row's seed, once
  unsigned at[2] = {0u, 0u};                 // DROP: the rows' hash parts
  if constexpr (DROP) {
    at[0] = kept.at(x.r0 + m0 + g);
    at[1] = kept.at(x.r0 + m0 + g + 8);
  }
  float o[NC][4];
#pragma unroll
  for (int nt = 0; nt < NC; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;

  for (int pass = 0; pass < PASSES; ++pass) {
    const bool last = pass == PASSES - 1;
    if (NORM && last) {
      inv[0] = rcp(fmaxf(l[0], 1e-16f));
      inv[1] = rcp(fmaxf(l[1], 1e-16f));
    }
    ml[0] = mx[0] * LOG2E;
    ml[1] = mx[1] * LOG2E;
    for (int c = 0; c < chunks; ++c) {
      const int nk = min(T, total - c * T);
      if (!(pass == 1 && chunks == 1)) {  // one chunk stays staged
        __syncthreads();  // the previous chunk's reads of kix, kt, K and V
        lr::list_keys(nspan, sel, before, c * T, s.kix);
        __syncthreads();
        auto tok = [&](int r) { return x.s0 + s.kix[r]; };
        stage16<HD>(s.Y0, row + d, d3, tok, nk);
        if (last || chunks == 1) stage16<HD>(s.Y1, row + 2 * d, d3, tok, nk);
        if (t < T) s.kt[t] = t < nk ? tags.ktag(base, tok(t)) : -1;
        tc::cp_wait();
        __syncthreads();
      }
      if (!live) continue;
      const int nkt = (nk + 15) >> 4;
      for (int k = 0; k < nkt; ++k) {
        float c2[2][4], cm[2] = {-INFINITY, -INFINITY};
        dots16<HD>(qa, s.Y0, 16 * k, c2);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kj = s.kt[16 * k + 8 * hf + 2 * q + (e & 1)];
            const int r = rt[e >> 1];
            c2[hf][e] = kj >= 0 && kj == r ? c2[hf][e] * scale : -INFINITY;
            cm[e >> 1] = fmaxf(cm[e >> 1], c2[hf][e]);
          }
        if (!(NORM && last)) {  // the online max and sum
          tile::quad_max(cm);
          float a[2], sum[2] = {0.f, 0.f};
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float mn = fmaxf(mx[r], cm[r]);  // finite: mx >= M0
            a[r] = exp_ml(mx[r] - mn, 0.f);  // exactly 1 where m stays
            mx[r] = mn;
            ml[r] = mn * LOG2E;
          }
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float p = exp_ml(c2[hf][e], ml[e >> 1]);  // 0: no pair
              c2[hf][e] = p;
              sum[e >> 1] += p;
            }
          tile::quad_sum(sum);
          l[0] = l[0] * a[0] + sum[0];
          l[1] = l[1] * a[1] + sum[1];
          if (NORM) continue;  // the first sweep: m and l only
#pragma unroll
          for (int nt = 0; nt < NC; ++nt) {
            o[nt][0] *= a[0];
            o[nt][1] *= a[0];
            o[nt][2] *= a[1];
            o[nt][3] *= a[1];
          }
        } else {  // NORM's second sweep: p from the final m and l
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              c2[hf][e] = exp_ml(c2[hf][e], ml[e >> 1]) * inv[e >> 1];
        }
        if constexpr (DROP) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float& p = c2[hf][e];
              const int j = x.s0 + s.kix[16 * k + 8 * hf + 2 * q + (e & 1)];
              p = p != 0.f && kept.keeps(at[e >> 1] + kept.col(j))
                      ? p * keep.inv_keep
                      : 0.f;
            }
        }
        unsigned pa[4];
        tile::a_frag(pa, c2);  // p rounded to bf16
        times_rows<HD>(o, pa, s.Y1, 16 * k);
      }
    }
  }
  if (!live) return;
  const float f0 = NORM ? 1.f : rcp(fmaxf(l[0], 1e-16f));
  const float f1 = NORM ? 1.f : rcp(fmaxf(l[1], 1e-16f));
  const int i0 = m0 + g, i1 = i0 + 8;
  bf16* o0 = out + (base + x.r0) * d + h * HD;
  store_pair<HD>(i0 < x.n ? o0 + (long)i0 * d : nullptr,
                 i1 < x.n ? o0 + (long)i1 * d : nullptr, o, f0, f1);
  if (STATS && q == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (m0 + g + 8 * r < x.n) {
        const long at = (base + x.r0 + m0 + g + 8 * r) * H + h;
        stat_m[at] = l[r] > 0.f ? mx[r] : -INFINITY;
        stat_l[at] = l[r];
      }
}

// dQ of a warp's 16 query rows over nk staged keys (K, V rows [0, nk),
// their tags kt; key r the token tok(r)): qa, ga the rows' Q and dO
// fragments, rt, rml, rli, de the rows' tags, m log2(e), 1/l and delta, at
// their parts of the dropout hash (kept: the row's Split). SWEEP (PAIRS'
// first sweep) only sums p dp_drop into dsum; otherwise dS = p (dp_drop -
// delta) pre, rounded, goes into acc += dS K.
template <int HD, bool SWEEP, bool DROP, class Split, class Tok>
__device__ __forceinline__ void dq_keys16(
    const bf16* K, const bf16* V, const int* kt, int nk, Tok tok,
    const unsigned (&qa)[HD / 16][4], const unsigned (&ga)[HD / 16][4],
    const unsigned (&at)[2], const int (&rt)[2], const float (&rml)[2],
    const float (&rli)[2], const float (&de)[2], float scale, float pre,
    const Split& kept, float inv_keep, float (&dsum)[2],
    float (&acc)[HD / 8][4]) {
  const int q = threadIdx.x & 3;
  const int nkt = (nk + 15) >> 4;
  for (int k = 0; k < nkt; ++k) {
    float sc[2][4], dp[2][4];
    dots16<HD>(qa, K, 16 * k, sc);
    dots16<HD>(ga, V, 16 * k, dp);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jr = 16 * k + 8 * hf + 2 * q + (e & 1), r = e >> 1;
        const int kj = kt[jr];
        const bool meets = kj >= 0 && kj == rt[r];
        bool keeps = true;
        if constexpr (DROP)
          keeps = meets && kept.keeps(at[r] + kept.col(tok(jr)));
        const float p =
            meets ? exp_ml(sc[hf][e] * scale, rml[r]) * rli[r] : 0.f;
        float dpd = dp[hf][e];
        if constexpr (DROP) dpd = keeps ? dpd * inv_keep : 0.f;
        if constexpr (SWEEP)
          dsum[r] += p * dpd;
        else
          sc[hf][e] = p * (dpd - de[r]) * pre;
      }
    if constexpr (!SWEEP) {
      unsigned sa[4];
      tile::a_frag(sa, sc);  // dS rounded to bf16
      times_rows<HD>(acc, sa, K, 16 * k);
    }
  }
}

// dK and dV of a warp's 16 key rows (staged at K and V from row m0, their
// tags kr, their parts of the dropout hash kc) over nq staged queries
// (Q, G rows [0, nq); per query its tag, m log2(e), 1/l, delta and part of
// the hash in s; kept: the row's Split): dV += P_drop^T dO and dK += dS^T
// Q, P_drop and dS (times pre) rounded. The rows' fragments are read
// again for each 16-query step, so that they do not hold registers beside
// the dK and dV sums.
template <int HD, bool DROP, class Split>
__device__ __forceinline__ void dkv_queries16(
    const Tiles16<HD>& s, const bf16* K, const bf16* V, int m0,
    const bf16* Q, const bf16* G, int nq, const int (&kr)[2],
    const unsigned (&kc)[2], float scale, float pre, const Split& kept,
    float inv_keep, float (&dk)[HD / 8][4], float (&dv)[HD / 8][4]) {
  const int q = threadIdx.x & 3;
  const int nqt = (nq + 15) >> 4;
  for (int k = 0; k < nqt; ++k) {
    float sc[2][4], dp[2][4];
    {
      unsigned a[HD / 16][4];
      a_rows<HD>(a, K, m0);
      dots16<HD>(a, Q, 16 * k, sc);  // s^T: keys x queries
      a_rows<HD>(a, V, m0);
      dots16<HD>(a, G, 16 * k, dp);  // dp^T
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jq = 16 * k + 8 * hf + 2 * q + (e & 1), r = e >> 1;
        const bool meets = kr[r] >= 0 && s.qt[jq] == kr[r];
        bool keeps = true;
        if constexpr (DROP) keeps = meets && kept.keeps(s.qat[jq] + kc[r]);
        const float p =
            meets ? exp_ml(sc[hf][e] * scale, s.qml[jq]) * s.qli[jq] : 0.f;
        float pd = p, dpd = dp[hf][e];
        if constexpr (DROP) {
          pd = keeps ? p * inv_keep : 0.f;
          dpd = keeps ? dpd * inv_keep : 0.f;
        }
        sc[hf][e] = pd;
        dp[hf][e] = p * (dpd - s.qde[jq]) * pre;
      }
    unsigned pa[4], sa[4];
    tile::a_frag(pa, sc);  // P_drop^T rounded to bf16
    tile::a_frag(sa, dp);  // dS^T
    times_rows<HD>(dv, pa, G, 16 * k);
    times_rows<HD>(dk, sa, Q, 16 * k);
  }
}

// Per staged query r < n of the tile at token r0 (t < T, one a thread):
// its tag, m log2(e) and 1/l into shared memory (zeros past n); returns
// the tag (-1 past n).
template <int HD, class Tags>
__device__ __forceinline__ int stage_query_rows(const Tiles16<HD>& s,
                                                Tags tags, long base, int r0,
                                                int n, int H, int h,
                                                const float* stat_m,
                                                const float* stat_l) {
  const int t = threadIdx.x;
  int tag = -1;
  if (t < T) {
    float mlv = 0.f, li = 0.f;
    if (t < n) {
      tag = tags.qtag(base, r0 + t);
      const long at = (base + r0 + t) * H + h;
      mlv = stat_m[at] * LOG2E;
      li = 1.f / fmaxf(stat_l[at], 1e-16f);
    }
    s.qt[t] = tag;
    s.qml[t] = mlv;
    s.qli[t] = li;
  }
  return tag;
}

// delta = dO . O of the n staged queries (dO at G, the forward's out from
// token r0) into s.qde, two threads a query; all threads call it.
template <int HD>
__device__ __forceinline__ void delta_rows(const Tiles16<HD>& s,
                                           const bf16* G, const bf16* out,
                                           long base, int r0, int n, int d,
                                           int h) {
  const int t = threadIdx.x, r = t >> 1, half = t & 1;
  float de = 0.f;
  if (r < n) {
    const bf16* o = out + (base + r0 + r) * d + h * HD + half * (HD / 2);
    const bf16* gg = G + r * (HD + 8) + half * (HD / 2);
#pragma unroll
    for (int c = 0; c < HD / 2; c += 8) de += lr::dot8(o + c, gg + c);
  }
  de += __shfl_xor_sync(0xffffffffu, de, 1);
  if (half == 0 && r < T) s.qde[r] = de;
}

// dq: one block per (row, head, tile of up to 64 queries of a span). Writes
// dq for the tile's queries and delta [B, S, H] for the dk/dv kernel
// (PAIRS: summed from the pairs; otherwise dO . O).
template <int HD, bool PAIRS, bool DROP, class Tags, class Keep>
__device__ __forceinline__ void list_dq16(
    const bf16* __restrict__ qkv, Tags tags, int span,
    const bf16* __restrict__ out, const bf16* __restrict__ gout,
    const float* __restrict__ stat_m, const float* __restrict__ stat_l,
    float* __restrict__ delta, bf16* __restrict__ dqkv, int S, int d,
    float scale, Keep keep) {
  constexpr int KS = HD / 16, NC = HD / 8, PASSES = PAIRS ? 2 : 1;
  extern __shared__ float4 smem4[];
  const Tiles16<HD> s(smem4, true);
  const SpanTile x = span_tile(S, span);
  if (x.n <= 0) return;  // uniform
  const long b = blockIdx.x, base = b * S, d3 = 3L * d;
  const int h = blockIdx.y, H = gridDim.y, t = threadIdx.x;
  const bf16* row = qkv + base * d3 + h * HD;
  const bf16* grow = gout + base * d + h * HD;

  const int tag = stage_query_rows<HD>(s, tags, base, x.r0, x.n, H, h,
                                       stat_m, stat_l);
  auto own = [&](int r) { return x.r0 + r; };
  stage16<HD>(s.X0, row, d3, own, x.n);
  stage16<HD>(s.X1, grow, d, own, x.n);
  int qmin, qmax;
  block_range(tag, s.range, qmin, qmax);
  const int nspan = x.s1 - x.s0;
  auto sel = [&](int jl) {
    const int k = tags.ktag(base, x.s0 + jl);
    return k >= qmin && k <= qmax;  // qmin >= 0
  };
  int total = 0, before = 0;
  if (qmax >= 0) before = lr::rank_keys(nspan, sel, s.scan, total);
  const int chunks = (total + T - 1) / T;
  tc::cp_wait();
  __syncthreads();  // Q and dO have landed
  if constexpr (!PAIRS) {
    delta_rows<HD>(s, s.X1, out, base, x.r0, x.n, d, h);
    __syncthreads();
    if (t < x.n) delta[(base + x.r0 + t) * H + h] = s.qde[t];
  }

  const int lane = t & 31, g = lane >> 2, q = lane & 3, m0 = (t >> 5) * 16;
  const bool live = m0 < x.n;
  unsigned qa[KS][4], ga[KS][4];
  int rt[2] = {-1, -1};
  float rml[2] = {0.f, 0.f}, rli[2] = {0.f, 0.f}, de[2] = {0.f, 0.f};
  if (live) {
    a_rows<HD>(qa, s.X0, m0);
    a_rows<HD>(ga, s.X1, m0);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = m0 + g + 8 * r;
      rt[r] = s.qt[i];
      rml[r] = s.qml[i];
      rli[r] = s.qli[i];
      if (!PAIRS) de[r] = s.qde[i];
    }
  }
  float acc[NC][4];
#pragma unroll
  for (int nt = 0; nt < NC; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  const float pre = PAIRS ? scale : 1.f;
  auto tok = [&](int r) { return x.s0 + s.kix[r]; };
  const auto kept = keep.split(b, h, H, S);  // the row's seed, once
  const unsigned at[2] = {DROP ? kept.at(x.r0 + m0 + g) : 0u,
                          DROP ? kept.at(x.r0 + m0 + g + 8) : 0u};

  for (int pass = 0; pass < PASSES; ++pass) {
    const bool last = pass == PASSES - 1;
    float dsum[2] = {0.f, 0.f};
    for (int c = 0; c < chunks; ++c) {
      const int nk = min(T, total - c * T);
      if (!(pass == 1 && chunks == 1)) {  // one chunk stays staged
        __syncthreads();
        lr::list_keys(nspan, sel, before, c * T, s.kix);
        __syncthreads();
        stage16<HD>(s.Y0, row + d, d3, tok, nk);
        stage16<HD>(s.Y1, row + 2 * d, d3, tok, nk);
        if (t < T) s.kt[t] = t < nk ? tags.ktag(base, tok(t)) : -1;
        tc::cp_wait();
        __syncthreads();
      }
      if (!live) continue;
      if (PAIRS && !last)  // delta's sweep
        dq_keys16<HD, true, DROP>(s.Y0, s.Y1, s.kt, nk, tok, qa, ga, at, rt,
                                  rml, rli, de, scale, pre, kept,
                                  keep.inv_keep, dsum, acc);
      else
        dq_keys16<HD, false, DROP>(s.Y0, s.Y1, s.kt, nk, tok, qa, ga, at, rt,
                                   rml, rli, de, scale, pre, kept,
                                   keep.inv_keep, dsum, acc);
    }
    if (PAIRS && !last) {
      tile::quad_sum(dsum);
      de[0] = dsum[0];
      de[1] = dsum[1];
      if (live && q == 0)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (m0 + g + 8 * r < x.n)
            delta[(base + x.r0 + m0 + g + 8 * r) * H + h] = de[r];
    }
  }
  if (!live) return;
  const int i0 = m0 + g, i1 = i0 + 8;
  bf16* o0 = dqkv + (base + x.r0) * d3 + h * HD;
  store_pair<HD>(i0 < x.n ? o0 + (long)i0 * d3 : nullptr,
                 i1 < x.n ? o0 + (long)i1 * d3 : nullptr, acc,
                 PAIRS ? 1.f : scale, PAIRS ? 1.f : scale);
}

// dk, dv: one block per (row, head, tile z of a span): the tile's z-th
// chunk of 64 valid keys of the span by rank, and the padding keys among
// the tile's tokens (zeros). delta from the dq kernel.
template <int HD, bool PAIRS, bool DROP, class Tags, class Keep>
__device__ __forceinline__ void list_dkv16(
    const bf16* __restrict__ qkv, Tags tags, int span,
    const bf16* __restrict__ gout, const float* __restrict__ stat_m,
    const float* __restrict__ stat_l, const float* __restrict__ delta,
    bf16* __restrict__ dqkv, int S, int d, float scale, Keep keep) {
  constexpr int NC = HD / 8, C = HD / 8;
  extern __shared__ float4 smem4[];
  const Tiles16<HD> s(smem4, true);
  const SpanTile x = span_tile(S, span);
  if (x.n <= 0) return;  // uniform
  const long b = blockIdx.x, base = b * S, d3 = 3L * d;
  const int h = blockIdx.y, H = gridDim.y, t = threadIdx.x;
  const bf16* row = qkv + base * d3 + h * HD;
  const bf16* grow = gout + base * d + h * HD;
  bf16* drow = dqkv + base * d3 + h * HD;

  for (int idx = t; idx < x.n * C; idx += LIST16_THREADS) {  // padding keys
    const int j = x.r0 + idx / C;
    if (tags.ktag(base, j) < 0) {
      bf16* o = drow + (long)j * d3 + idx % C * 8;
      *reinterpret_cast<uint4*>(o + d) = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(o + 2 * d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  const int nspan = x.s1 - x.s0;
  auto sel = [&](int jl) { return tags.ktag(base, x.s0 + jl) >= 0; };
  int total;
  const int before = lr::rank_keys(nspan, sel, s.scan, total);
  const int r0 = x.r0 - x.s0;  // the chunk's first rank
  if (r0 >= total) return;     // uniform: no chunk z
  const int nk = min(T, total - r0);
  lr::list_keys(nspan, sel, before, r0, s.kix);
  __syncthreads();
  auto tok = [&](int r) { return x.s0 + s.kix[r]; };
  stage16<HD>(s.X0, row + d, d3, tok, nk);
  stage16<HD>(s.X1, row + 2 * d, d3, tok, nk);
  int tag = -1;
  if (t < T) {
    tag = t < nk ? tags.ktag(base, tok(t)) : -1;
    s.kt[t] = tag;
  }
  int kmin, kmax;
  block_range(tag, s.range, kmin, kmax);  // kmax >= 0: nk > 0
  tc::cp_wait();
  __syncthreads();

  const int lane = t & 31, g = lane >> 2, m0 = (t >> 5) * 16;
  const bool live = m0 < nk;
  int kr[2] = {-1, -1};
  unsigned kc[2] = {0u, 0u};  // DROP: the keys' parts of the hash
  const auto kept = keep.split(b, h, H, S);  // the row's seed, once
  if (live) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      kr[r] = s.kt[m0 + g + 8 * r];
      if (DROP) kc[r] = kept.col(tok(min(m0 + g + 8 * r, nk - 1)));
    }
  }
  float dk[NC][4], dv[NC][4];
#pragma unroll
  for (int nt = 0; nt < NC; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nt][e] = dv[nt][e] = 0.f;
  const float pre = PAIRS ? scale : 1.f;

  for (int q0 = x.s0; q0 < x.s1; q0 += T) {
    const int nq = min(T, x.s1 - q0);
    const int qt = t < nq ? tags.qtag(base, q0 + t) : -1;
    if (!__syncthreads_or(qt >= kmin && qt <= kmax)) continue;  // uniform
    auto own = [&](int r) { return q0 + r; };
    stage16<HD>(s.Y0, row, d3, own, nq);
    stage16<HD>(s.Y1, grow, d, own, nq);
    stage_query_rows<HD>(s, tags, base, q0, nq, H, h, stat_m, stat_l);
    if (t < T) {
      s.qde[t] = t < nq ? delta[(base + q0 + t) * H + h] : 0.f;
      if (DROP) s.qat[t] = kept.at(q0 + t);
    }
    tc::cp_wait();
    __syncthreads();
    if (live)
      dkv_queries16<HD, DROP>(s, s.X0, s.X1, m0, s.Y0, s.Y1, nq, kr, kc,
                              scale, pre, kept, keep.inv_keep, dk, dv);
    // the next tile's __syncthreads_or guards Q, dO and the per-query rows
  }
  if (!live) return;
  const int j0 = m0 + g, j1 = j0 + 8;
  bf16* p0 = j0 < nk ? drow + (long)tok(j0) * d3 : nullptr;
  bf16* p1 = j1 < nk ? drow + (long)tok(j1) * d3 : nullptr;
  const float f = PAIRS ? 1.f : scale;
  store_pair<HD>(p0 ? p0 + d : nullptr, p1 ? p1 + d : nullptr, dk, f, f);
  store_pair<HD>(p0 ? p0 + 2 * d : nullptr, p1 ? p1 + 2 * d : nullptr, dv,
                 1.f, 1.f);
}

// The whole backward of spans of up to 64 tokens (K4's graph blocks) in one
// kernel, one block per (row, head, span): the span's Q, dO, K and V staged
// once, its keys by position (a padding key's tag -1), no ranking; the
// warps take the span's query rows (delta, then dS and dQ), then, after one
// barrier, its key rows (dK and dV; a padding key's rows zero).
template <int HD, bool PAIRS, bool DROP, class Tags, class Keep>
__device__ __forceinline__ void span_bwd16(
    const bf16* __restrict__ qkv, Tags tags, int span,
    const bf16* __restrict__ out, const bf16* __restrict__ gout,
    const float* __restrict__ stat_m, const float* __restrict__ stat_l,
    bf16* __restrict__ dqkv, int S, int d, float scale, Keep keep) {
  constexpr int KS = HD / 16, NC = HD / 8;
  extern __shared__ float4 smem4[];
  const Tiles16<HD> s(smem4, true);
  const SpanTile x = span_tile(S, span);  // x.r0 = x.s0, x.n <= 64
  if (x.n <= 0) return;  // uniform
  const long b = blockIdx.x, base = b * S, d3 = 3L * d;
  const int h = blockIdx.y, H = gridDim.y, t = threadIdx.x, n = x.n;
  const bf16* row = qkv + base * d3 + h * HD;
  bf16* drow = dqkv + base * d3 + h * HD + (long)x.s0 * d3;

  const auto kept = keep.split(b, h, H, S);  // the row's seed, once
  stage_query_rows<HD>(s, tags, base, x.s0, n, H, h, stat_m, stat_l);
  if (t < T) {
    s.kt[t] = t < n ? tags.ktag(base, x.s0 + t) : -1;
    if (DROP) s.qat[t] = kept.at(x.s0 + t);
  }
  auto own = [&](int r) { return x.s0 + r; };
  stage16<HD>(s.X0, row, d3, own, n);
  stage16<HD>(s.X1, gout + base * d + h * HD, d, own, n);
  stage16<HD>(s.Y0, row + d, d3, own, n);
  stage16<HD>(s.Y1, row + 2 * d, d3, own, n);
  tc::cp_wait();
  __syncthreads();
  if constexpr (!PAIRS) {
    delta_rows<HD>(s, s.X1, out, base, x.s0, n, d, h);
    __syncthreads();
  }

  const int lane = t & 31, g = lane >> 2, q = lane & 3, m0 = (t >> 5) * 16;
  const bool live = m0 < n;  // the warp's rows: queries, then keys
  const float pre = PAIRS ? scale : 1.f;
  auto tok = [&](int r) { return x.s0 + r; };
  const int i0 = m0 + g, i1 = i0 + 8;
  if (live) {
    unsigned qa[KS][4], ga[KS][4];
    a_rows<HD>(qa, s.X0, m0);
    a_rows<HD>(ga, s.X1, m0);
    int rt[2];
    float rml[2], rli[2], de[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = m0 + g + 8 * r;
      rt[r] = s.qt[i];
      rml[r] = s.qml[i];
      rli[r] = s.qli[i];
      de[r] = PAIRS ? 0.f : s.qde[i];
    }
    float acc[NC][4];
#pragma unroll
    for (int nt = 0; nt < NC; ++nt)
      acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    const unsigned at[2] = {DROP ? s.qat[i0] : 0u, DROP ? s.qat[i1] : 0u};
    if constexpr (PAIRS) {  // delta's sweep
      float dsum[2] = {0.f, 0.f};
      dq_keys16<HD, true, DROP>(s.Y0, s.Y1, s.kt, n, tok, qa, ga, at, rt,
                                rml, rli, de, scale, pre, kept,
                                keep.inv_keep, dsum, acc);
      tile::quad_sum(dsum);
      de[0] = dsum[0];
      de[1] = dsum[1];
      if (q == 0) {
        s.qde[i0] = de[0];
        s.qde[i1] = de[1];
      }
    }
    float unused[2];
    dq_keys16<HD, false, DROP>(s.Y0, s.Y1, s.kt, n, tok, qa, ga, at, rt,
                               rml, rli, de, scale, pre, kept, keep.inv_keep,
                               unused, acc);
    const float f = PAIRS ? 1.f : scale;
    store_pair<HD>(i0 < n ? drow + (long)i0 * d3 : nullptr,
                   i1 < n ? drow + (long)i1 * d3 : nullptr, acc, f, f);
  }
  __syncthreads();  // every query's delta
  if (!live) return;
  const int kr[2] = {s.kt[i0], s.kt[i1]};
  const unsigned kc[2] = {DROP ? kept.col(x.s0 + i0) : 0u,
                          DROP ? kept.col(x.s0 + i1) : 0u};
  float dk[NC][4], dv[NC][4];
#pragma unroll
  for (int nt = 0; nt < NC; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nt][e] = dv[nt][e] = 0.f;
  dkv_queries16<HD, DROP>(s, s.Y0, s.Y1, m0, s.X0, s.X1, n, kr, kc, scale,
                          pre, kept, keep.inv_keep, dk, dv);
  const float f = PAIRS ? 1.f : scale;
  bf16* p0 = i0 < n ? drow + (long)i0 * d3 : nullptr;
  bf16* p1 = i1 < n ? drow + (long)i1 * d3 : nullptr;
  store_pair<HD>(p0 ? p0 + d : nullptr, p1 ? p1 + d : nullptr, dk, f, f);
  store_pair<HD>(p0 ? p0 + 2 * d : nullptr, p1 ? p1 + 2 * d : nullptr, dv,
                 1.f, 1.f);
}

}  // namespace l16

// Launches dq, then dk/dv on one stream (delta [B, S, H] passes between
// them), after checking the wrapper's launch. Returns cudaGetLastError()
// after each launch.
template <class Dq, class Dkv, class Tags, class Keep>
cudaError_t launch_list_bwd16(Dq dq, Dkv dkv, const tile::bf16* qkv,
                              Tags tags, int span, const tile::bf16* out,
                              const tile::bf16* gout, const float* stat_m,
                              const float* stat_l, float* delta,
                              tile::bf16* dqkv, int S, int d, float scale,
                              Keep keep, const tile::Launch& L,
                              cudaStream_t stream) {
  const dim3 grid(L.gx, L.gy, L.gz);
  dq<<<grid, L.threads, L.smem, stream>>>(qkv, tags, span, out, gout, stat_m,
                                          stat_l, delta, dqkv, S, d, scale,
                                          keep);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv<<<grid, L.threads, L.smem, stream>>>(qkv, tags, span, gout, stat_m,
                                           stat_l, delta, dqkv, S, d, scale,
                                           keep);
  return cudaGetLastError();
}

}  // namespace attn
