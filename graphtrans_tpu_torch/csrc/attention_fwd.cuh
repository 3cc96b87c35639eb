// The long-row attention forward: K5 (flash_attention.cu), K9's long
// instance (attention_smalls.cu) and K4's wide spans (attention_packed.cu),
// over qkv [B, S, 3d] with heads in lanes -> out [B, S, d], and where a
// gradient is wanted the softmax statistics m and l ([B, S, H]) that the
// backward of attention_bwd.cuh reads.
//
// The mask is a pair of tags (policy Tags, as in attention_bwd.cuh): query
// i attends key j iff qtag(i) == ktag(j) >= 0. Scale 1/sqrt(hd); the
// output is normalised by max(l, 1e-16), so a query with no key writes
// exact zeros. m is the max scaled score of a query's keys and l the sum of
// their undropped exp(s - m); a query with no key gets m = -inf and l = 0.
// Dropout (policy Keep: members on and inv_keep, and keep(b, h, H, S, i, j)
// with the row's own token indices) is drawn from the seed inside the loop;
// nothing is stored. DROP and STATS are compile-time, so the serving
// instance runs the loop without either.
//
// What it replaces. The streaming body first written for K5: one thread a
// query (128 a block) with q and the output accumulator in registers, each
// key one hd-long dependent FMA chain, the accumulator rescaled whenever the
// running max rose, and 64-key positional tiles walked key by key even when
// they held one valid key (the CLS column's tile of a 1001-wide row). At
// code2's bench512 it took 5.47 ms against a 0.97 ms bound.
//
// The design: the long backward's pieces (attention_bwd.cuh). One block of
// four warps per (row, head, 64 queries). A block-wide prefix count over
// the row's tags ranks the keys whose tag meets one of the tile's query
// tags; they are gathered 64 at a time by rank, each with its token index
// (the dropout hash and the tags need the real j), K and V staged with
// 16-byte cp.async copies. Each warp owns 16 query rows whole, so a chunk
// needs no block barrier between its phases:
//  - S = Q K^T for its 16 rows x the chunk's 64 keys on the tensor cores
//    (mma.sync m16n8k8 in 3xTF32: every operand split into a TF32 high
//    part and a TF32 remainder, three products summed in f32, so the sums
//    keep f32 accuracy), scaled and masked (-inf where the pair does not
//    meet) in registers;
//  - the online softmax in registers, a row's values in the quad of lanes
//    that holds it (reduced with __shfl_xor): the chunk's max, the running
//    max m (a finite sentinel until the first key, so that a chunk with no
//    key for a row gives alpha = 1 and no NaN), alpha = exp(m_old -
//    m_new), l = alpha l + sum exp(s - m_new);
//  - P_drop through the warp's own 16-row tile in shared memory (the
//    product's A fragments lie elsewhere than its C fragments), then O =
//    alpha O + P_drop V on the tensor cores, O in registers.
// Up to hd 64 the block has one K/V buffer (69 KB at hd 64, 45 KB at hd
// 32), so three (four) blocks share an SM: the other blocks hide a chunk's
// gather. A second buffer, loading the next chunk during this one, would
// leave two; it measured slower at hd 32 and 64. At hd 128 one block fits
// an SM either way (183 KB with two buffers), so it has two.
// Bound on the H100 at bench512 (513 rows of 1001, d 256, 4 heads of 64,
// ~122 valid keys a row): operations, 4 hd flops a pair of products (~65
// GFLOP), 0.39 ms as 3xTF32 on the tensor cores, 0.97 ms at the f32 SIMT
// peak.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "attention_bwd.cuh"

namespace attn {

constexpr int LONG_FWD_THREADS = 128;    // four warps, 16 queries each
constexpr int LONG_FWD_SLD = LONG_T + 4;  // floats a row of a warp's P tile

// K/V buffers of the long forward: one up to hd 64, where a second would
// cost a block an SM; two at hd 128, where one block an SM fits either way
// and the next chunk loads while this one computes.
__host__ __device__ constexpr int long_fwd_bufs(int hd) {
  return hd <= 64 ? 1 : 2;
}

// Shared bytes of the long forward: the Q tile, the K/V buffers, each
// warp's 16-row P tile; per query tag, per buffered key tag and token
// index, and the prefix count's scratch.
__host__ __device__ constexpr int long_fwd_bytes(int hd) {
  return 4 * ((1 + 2 * long_fwd_bufs(hd)) * LONG_T * (hd + 4) +
              LONG_T * LONG_FWD_SLD + (1 + 2 * long_fwd_bufs(hd)) * LONG_T +
              8);
}

// blocks an SM for __launch_bounds__ (shared memory allows four at hd 32,
// three at hd 64, one at hd 128)
__host__ __device__ constexpr int long_fwd_blocks(int hd) {
  return hd <= 32 ? 4 : hd <= 64 ? 3 : 1;
}

// A wrapper's launch of the long forward is the one this file runs: a
// block of LONG_FWD_THREADS per (row, head, LONG_T queries).
__host__ inline bool long_fwd_launch_ok(const tile::Launch& L, int B, int S,
                                        int H, int hd) {
  return L.pad == LONG_T && L.group == 1 && L.gx == B && L.gy == H &&
         L.gz == (S + LONG_T - 1) / LONG_T && L.threads == LONG_FWD_THREADS &&
         L.smem == long_fwd_bytes(hd) && L.smem <= tile::SMEM_MAX;
}

namespace lr {

// cp.async groups: close the copies issued so far into one group; wait
// until at most N groups are still in flight.
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace lr

// The shared tiles of the long forward.
template <int HD>
struct FwdTiles {
  static constexpr int LD = HD + 4;
  float *Q, *K[2], *V[2], *P;  // P: 16 rows of LONG_FWD_SLD floats a warp
  int* qt;                     // per query: tag
  int *kt[2], *kix;            // per buffered key: tag; token index
  int* scan;                   // LONG_FWD_THREADS / 32 + 1 ints
  int* range;                  // 2 ints

  __device__ explicit FwdTiles(float* s) {
    constexpr int T = LONG_T, NB = long_fwd_bufs(HD);
    Q = s;
    K[0] = Q + T * LD;
    K[1] = K[0] + (NB - 1) * T * LD;
    V[0] = K[1] + T * LD;
    V[1] = V[0] + (NB - 1) * T * LD;
    P = V[1] + T * LD;
    qt = reinterpret_cast<int*>(P + T * LONG_FWD_SLD);
    kt[0] = qt + T;
    kt[1] = kt[0] + (NB - 1) * T;
    kix = kt[1] + T;
    scan = kix + NB * T;
    range = scan + LONG_FWD_THREADS / 32 + 1;
  }
};

// One block of four warps per (row, head, T queries): out, and with STATS
// m and l, for the tile's queries. Warp w owns queries 16 w .. 16 w + 15
// whole: their scores, softmax and O stay in its registers.
template <int HD, bool DROP, bool STATS, class Tags, class Keep>
__device__ __forceinline__ void long_fwd(const float* __restrict__ qkv,
                                         Tags tags, float* __restrict__ out,
                                         float* __restrict__ stat_m,
                                         float* __restrict__ stat_l, int S,
                                         int d, float scale, Keep keep) {
  using namespace lr;
  constexpr int LD = HD + 4, NTK = T / 8, NTC = HD / 8, SLD = LONG_FWD_SLD;
  constexpr float M0 = -1e30f;  // the running max before the first key
  extern __shared__ float4 smem4[];
  const FwdTiles<HD> s(reinterpret_cast<float*>(smem4));
  const long b = blockIdx.x;
  const int h = blockIdx.y, H = gridDim.y, t = threadIdx.x;
  const int q0 = blockIdx.z * T, nq = min(T, S - q0);
  const long d3 = 3L * d, base = b * S;
  const float* row = qkv + base * d3 + h * HD;

  int tag = -1;
  if (t < T) {
    tag = t < nq ? tags.qtag(base, q0 + t) : -1;
    s.qt[t] = tag;
  }
  int qmin, qmax;
  block_range(tag, s.range, qmin, qmax);

  // this thread's two rows of the warp's 16 (lane 4 g + tq: rows g, g + 8;
  // in a tile, columns 2 tq, 2 tq + 1 of each 8), their running max and
  // sum, alike in the quad that shares the rows
  const int m0 = (t >> 5) * 16, g = (t & 31) >> 2, tq = t & 3;
  const int i0 = m0 + g, i1 = i0 + 8;
  float* P = s.P + m0 * SLD;
  float m[2] = {M0, M0}, l[2] = {0.f, 0.f};
  float acc[NTC][4];
#pragma unroll
  for (int nt = 0; nt < NTC; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  if (qmax >= 0) {  // uniform: the tile holds a query that can attend
    {
      float* const dst[1] = {s.Q};
      const float* const src[1] = {row};
      const long ld[1] = {d3};
      stage<HD, 1>(dst, src, ld, [&](int r) { return (long)(q0 + r); }, nq);
    }
    auto sel = [&](int j) {
      const int k = tags.ktag(base, j);
      return k >= qmin && k <= qmax;  // qmin >= 0
    };
    int total;
    const int before = rank_keys(S, sel, s.scan, total);
    // chunk c's keys (ranks [c T, c T + T)) into buffer c % NB
    constexpr int NB = long_fwd_bufs(HD);
    auto fetch = [&](int c) {
      const int bf = c % NB, r0 = c * T, nk = min(T, total - r0);
      int* kix = s.kix + bf * T;
      list_keys(S, sel, before, r0, kix);
      __syncthreads();
      float* const dst[2] = {s.K[bf], s.V[bf]};
      const float* const src[2] = {row + d, row + 2 * d};
      const long ld[2] = {d3, d3};
      stage<HD, 2>(dst, src, ld, [&](int r) { return (long)kix[r]; }, nk);
      if (t < T) s.kt[bf][t] = t < nk ? tags.ktag(base, kix[t]) : -1;
    };
    const int chunks = (total + T - 1) / T;
    if (chunks > 0) fetch(0);
    cp_commit();
    const int qt0 = s.qt[i0], qt1 = s.qt[i1];
    for (int c = 0; c < chunks; ++c) {
      const int bf = c % NB, nk = min(T, total - c * T);
      if (NB == 2 && c + 1 < chunks) {
        fetch(c + 1);  // into the other buffer, free since chunk c - 1
        cp_commit();
        cp_wait_group<1>();  // Q and chunk c have landed
      } else {
        cp_wait_group<0>();
      }
      __syncthreads();
      const float* K = s.K[bf];
      const float* V = s.V[bf];
      const int* kt = s.kt[bf];
      const int* kix = s.kix + bf * T;
      // S = Q K^T for the warp's 16 queries x the chunk's 64 keys
      float sc[NTK][4];
#pragma unroll
      for (int nt = 0; nt < NTK; ++nt)
        sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll 2
      for (int k0 = 0; k0 < HD; k0 += 8) {
        unsigned ah[4], al[4], bh[2], bl[2];
        frag_a(s.Q, LD, 1, m0, k0, ah, al);
#pragma unroll
        for (int nt = 0; nt < NTK; ++nt) {  // B(k, n) = K[n][k]
          frag_b(K, 1, LD, k0, 8 * nt, bh, bl);
          mma3(sc[nt], ah, al, bh, bl);
        }
      }
      // the online softmax of rows i0 (e = 0, 1) and i1 (e = 2, 3):
      // scaled, -inf where the pair does not meet; the quad's max
      float cm[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < NTK; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 8 * nt + 2 * tq + (e & 1), qt = e < 2 ? qt0 : qt1;
          float& v = sc[nt][e];
          v = qt >= 0 && qt == kt[j] ? v * scale : -INFINITY;
          cm[e >> 1] = fmaxf(cm[e >> 1], v);
        }
      float a[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        cm[r] = fmaxf(cm[r], __shfl_xor_sync(0xffffffffu, cm[r], 1));
        cm[r] = fmaxf(cm[r], __shfl_xor_sync(0xffffffffu, cm[r], 2));
        const float mn = fmaxf(m[r], cm[r]);  // finite: m >= M0
        a[r] = expf(m[r] - mn);
        m[r] = mn;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < NTK; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = expf(sc[nt][e] - m[e >> 1]);  // 0 where no pair
          sum[e >> 1] += p;
          if constexpr (DROP)
            if (p != 0.f && !keep(b, h, H, S, q0 + (e < 2 ? i0 : i1),
                                  kix[8 * nt + 2 * tq + (e & 1)]))
              p = 0.f;
          sc[nt][e] = p;
        }
        // P_drop into the warp's tile, rows g and g + 8
        *reinterpret_cast<float2*>(P + g * SLD + 8 * nt + 2 * tq) =
            make_float2(sc[nt][0], sc[nt][1]);
        *reinterpret_cast<float2*>(P + (g + 8) * SLD + 8 * nt + 2 * tq) =
            make_float2(sc[nt][2], sc[nt][3]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = l[r] * a[r] + sum[r];
      }
#pragma unroll
      for (int nt = 0; nt < NTC; ++nt) {
        acc[nt][0] *= a[0];
        acc[nt][1] *= a[0];
        acc[nt][2] *= a[1];
        acc[nt][3] *= a[1];
      }
      __syncwarp();
      // O += P_drop V over the chunk's keys (P is 0 past nk, V rows zero)
      for (int k0 = 0; k0 < nk; k0 += 8) {
        unsigned ah[4], al[4], bh[2], bl[2];
        frag_a(P, SLD, 1, 0, k0, ah, al);
#pragma unroll
        for (int nt = 0; nt < NTC; ++nt) {  // B(k, n) = V[k][n]
          frag_b(V, LD, 1, k0, 8 * nt, bh, bl);
          mma3(acc[nt], ah, al, bh, bl);
        }
      }
      __syncthreads();  // buffer bf and the P tiles are overwritten next
      if (NB == 1 && c + 1 < chunks) {
        fetch(c + 1);
        cp_commit();
      }
    }
    cp_wait_group<0>();  // no chunk: Q's copies
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r ? i1 : i0;
    if (i >= nq) continue;
    const float li = (DROP ? keep.inv_keep : 1.f) / fmaxf(l[r], 1e-16f);
    float* o = out + (base + q0 + i) * d + h * HD + 2 * tq;
#pragma unroll
    for (int nt = 0; nt < NTC; ++nt)
      *reinterpret_cast<float2*>(o + 8 * nt) =
          make_float2(acc[nt][2 * r] * li, acc[nt][2 * r + 1] * li);
    if (STATS && tq == 0) {
      const long at = (base + q0 + i) * H + h;
      stat_m[at] = l[r] > 0.f ? m[r] : -INFINITY;
      stat_l[at] = l[r];
    }
  }
}


// ---- the bf16 instances of the long forward --------------------------------
//
// What they compute: K2's forward on rows of 129-384 tokens (code2's 384
// tier) and K3's forward in bf16, with the rounding points of the JAX
// kernels in bf16 on the TPU. Both take q.k from the bf16 operands summed in
// float32, then scaled, and keep m and l (the max scaled score, the sum of
// the undropped exp(s - m)) in float32. NORM (K2,
// graphtrans_tpu/ops/pallas/attention_packed.py:152-206): the normalised p
// = exp(s - m) / l, dropped and rescaled, rounded to bf16 once before P V,
// whose float32 sum is rounded once; the keys are walked twice (m and l,
// then P V). K3 (flash_hil.py:_fwd_kernel at Precision.DEFAULT, one bf16
// MXU pass): the online softmax's unnormalised p = exp(s - m_running),
// dropped and rescaled, rounded to bf16 before P V, the accumulator
// rescaled by alpha = exp(m_old - m_new) in float32 and normalised by 1/l
// in float32 at the end, then rounded once.
//
// The design: the long f32 forward's cut (a block per (row, head, 64
// queries), the keys whose tag meets one of the tile's ranked by a
// block-wide prefix count and gathered 64 at a time) with the bf16 tile
// instance's products: bf16 rows by cp.async, a warp owns 16 query rows
// whole (their scores for a chunk of 64 keys, 32 floats a thread, their
// softmax and O in registers), every product one bf16 mma.sync m16n8k16
// with float32 sums, p moved from the score accumulators into the A
// fragment of P V in registers. Shared memory as the bf16 long pair's
// (long16_bytes(), under 48 KB).

// One block of LONG16_THREADS per (row, head, T queries): out, and with
// STATS m and l [B, S, H] (m = -inf, l = 0 for a query with no key, whose
// output is exact zeros).
template <bool NORM, bool DROP, bool STATS, class Tags, class Keep>
__device__ __forceinline__ void long_fwd16(const tile::bf16* __restrict__ qkv,
                                           Tags tags,
                                           tile::bf16* __restrict__ out,
                                           float* __restrict__ stat_m,
                                           float* __restrict__ stat_l, int S,
                                           int d, float scale, Keep keep) {
  using namespace lr;
  using tile::bf16;
  constexpr int HD = LONG16_HD;
  constexpr float M0 = -1e30f;  // the running max before the first key
  extern __shared__ float4 smem4[];
  const Tiles16 s(smem4);
  const long b = blockIdx.x;
  const int h = blockIdx.y, H = gridDim.y, t = threadIdx.x;
  const int q0 = blockIdx.z * T, nq = min(T, S - q0);
  const long d3 = 3L * d, base = b * S;
  const bf16* row = qkv + base * d3 + h * HD;

  int tag = -1;
  if (t < T) {
    tag = t < nq ? tags.qtag(base, q0 + t) : -1;
    s.otag[t] = tag;
  }
  int qmin, qmax;
  block_range(tag, s.range, qmin, qmax);

  const int lane = t & 31, m0 = (t >> 5) * 16, g = lane >> 2, q = lane & 3;
  float mx[2] = {M0, M0}, l[2] = {0.f, 0.f};
  float o[4][4] = {};
  if (qmax >= 0) {  // uniform: the tile holds a query that can attend
    stage16(s.X0, nullptr, row, d3, row, d3,
            [&](int r) { return (long)(q0 + r); }, nq);
    const int tg[2] = {s.otag[m0 + g], s.otag[m0 + g + 8]};
    auto sel = [&](int j) {
      const int k = tags.ktag(base, j);
      return k >= qmin && k <= qmax;  // qmin >= 0
    };
    int total;
    const int before = rank_keys(S, sel, s.scan, total);
    const int chunks = (total + T - 1) / T;
    const int steps = NORM ? 2 * chunks : chunks;
    unsigned qa[2][4];
    float inv[2] = {0.f, 0.f};
    const auto kept = keep.row(b, h, H, S);  // the row's seed, once
    for (int st = 0; st < steps; ++st) {
      const bool pv = !NORM || st >= chunks;  // this sweep multiplies by V
      const int r0 = (st < chunks ? st : st - chunks) * T;
      const int nk = min(T, total - r0), nkt = (nk + 15) >> 4;
      list_keys(S, sel, before, r0, s.kix);
      __syncthreads();
      stage16(s.Y0, pv ? s.Y1 : nullptr, row + d, d3, row + 2 * d, d3,
              [&](int r) { return (long)s.kix[r]; }, nk);
      if (t < T) s.wtag[t] = t < nk ? tags.ktag(base, s.kix[t]) : -1;
      cp_wait();  // and Q's copies, with the first chunk
      __syncthreads();
      if (st == 0) a_rows16(qa, s.X0, m0);
      if (NORM && st == chunks) {  // m and l are whole: p's normaliser
        inv[0] = 1.f / fmaxf(l[0], 1e-16f);
        inv[1] = 1.f / fmaxf(l[1], 1e-16f);
      }
      float sc[4][2][4], cm[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        if (kt >= nkt) break;
        tile::scores16(s.Y0, s.wtag, qa, 16 * kt, tg, scale, sc[kt], cm);
      }
      float a[2] = {1.f, 1.f};
      if (!NORM || !pv) {  // the online max and sum
        tile::quad_max(cm);
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float mn = fmaxf(mx[r], cm[r]);  // finite: mx >= M0
          a[r] = expf(mx[r] - mn);
          mx[r] = mn;
        }
#pragma unroll
        for (int kt = 0; kt < 4; ++kt) {
          if (kt >= nkt) break;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float p = expf(sc[kt][hf][e] - mx[e >> 1]);  // 0: no pair
              sc[kt][hf][e] = p;
              sum[e >> 1] += p;
            }
        }
        tile::quad_sum(sum);
        l[0] = l[0] * a[0] + sum[0];
        l[1] = l[1] * a[1] + sum[1];
      }
      if (!pv) {
        __syncthreads();  // kix, the tags and Y are overwritten next
        continue;
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {  // K3: the accumulator follows m
        o[nt][0] *= a[0];
        o[nt][1] *= a[0];
        o[nt][2] *= a[1];
        o[nt][3] *= a[1];
      }
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {  // O += P V, p rounded to bf16
        if (kt >= nkt) break;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = sc[kt][hf][e];
            if constexpr (NORM)
              p = expf(p - mx[e >> 1]) * inv[e >> 1];
            if constexpr (DROP)
              p = (p != 0.f &&
                   kept(q0 + m0 + g + 8 * (e >> 1),
                        s.kix[16 * kt + 8 * hf + 2 * q + (e & 1)]))
                      ? p * keep.inv_keep
                      : 0.f;
            sc[kt][hf][e] = p;
          }
        unsigned pa[4];
        tile::a_frag(pa, sc[kt]);
        times_rows16(o, pa, s.Y1, 16 * kt);
      }
      __syncthreads();  // kix, the tags and Y are overwritten next
    }
    cp_wait();  // no chunk: Q's copies
    if constexpr (!NORM) {
      const float li[2] = {1.f / fmaxf(l[0], 1e-16f),
                           1.f / fmaxf(l[1], 1e-16f)};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        o[nt][0] *= li[0];
        o[nt][1] *= li[0];
        o[nt][2] *= li[1];
        o[nt][3] *= li[1];
      }
    }
  }
  tile::store_rows16(out + (base + q0 + m0) * d + h * HD, d, o, nq - m0);
  if (STATS && q == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (m0 + g + 8 * r < nq) {
        const long at = (base + q0 + m0 + g + 8 * r) * H + h;
        stat_m[at] = l[r] > 0.f ? mx[r] : -INFINITY;
        stat_l[at] = l[r];
      }
}

}  // namespace attn
