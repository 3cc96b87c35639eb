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
// in float32 at the end, then rounded once. A query with no key writes
// exact zeros, m = -inf and l = 0.
//
// What bounds them on the H100: at code2's bench512 the products are a few
// GFLOP (microseconds on the bf16 tensor cores) and the bytes a few MB
// (~10 us at 3.35 TB/s); what is left is instruction throughput and
// latency: an exp and a dropout hash of a dozen integer operations a pair
// on the SM's scalar pipes, and the chains of scores, row reductions by
// shuffles and P V a chunk. The first body took 0.14-0.16 ms there: it
// ranked a tile's keys by a block-wide prefix count, listed them again
// from device memory for every chunk of 64, waited for each chunk's
// gather in one buffer behind three barriers, staged both graphs' keys for
// a tile that straddled two, gathered K2's keys twice, and hashed each
// pair from scratch.
//
// The design. A block of four warps per (row, head, tile slot); a warp
// owns 16 query rows whole (their scores for a chunk of 64 keys, their
// softmax and O in registers; every product a bf16 mma.sync m16n8k16 with
// float32 sums, p moved from the score accumulators into the A fragment of
// P V). The block reads the row's tags into shared memory and finds its
// runs of one graph id (tile::find_runs, as K2's tile bodies do; no host
// synchronisation). A row whose ids each form one run (ops/pack.py packs
// each graph and its CLS as one run) is cut by runs: a run of n tokens into
// ceil(n / 64) query tiles, which the row's Z slots take in turn
// (slot z tiles z, z + Z, ...; Z is one more than the row's positional
// tiles, so a row of two runs still takes one tile a slot). A tile's keys
// are its run's tokens, a box of consecutive rows copied by 16-byte
// cp.async, and every pair of the tile meets: a whole chunk (all but a
// run's last) takes no mask and no bounds check. Each slot also writes the
// zeros of its share of the row's padding tokens. A row where some id forms
// two runs (fwd16_general, out of line) keeps the positional tiles and, as
// before, the keys whose tag lies between the tile's least and greatest
// query tag, masked pair by pair: their token indices by rank are listed
// once a tile in shared memory. K2's keys (rows of at most 384) are staged
// whole, each chunk of 64 of K its own cp.async group and V behind them:
// the first sweep (m and l) takes chunk c as soon as it has landed, one
// barrier a chunk; the second (P V, a 16-key tile at a time) reads shared
// memory only, with no barrier, so each key is gathered once. K3's
// keys stream through a ring of FWD16_STAGES chunk buffers: chunks c + 1
// and c + 2 load while chunk c's scores and P V run, one barrier a chunk.
// exp(s - m) is one FFMA and the SFU's ex2 (exp_ml); the dropout hash of a
// pair is its row's part plus its key's (the mask policy's Split), a key's
// part shared by a thread's two rows. Chunks start at the run's first
// token; K3's p is rounded against the running max, so its bits follow
// those starts. Residency: no spills; K2 takes up to 168 registers a
// thread (its shared memory allows three blocks an SM at W 384), K3 as
// many with dropout (three blocks) and 128 without (four).

constexpr int FWD16_STAGES = 3;  // K3's ring: chunk buffers of K and V
constexpr int FWD16_MISC = 16;   // ints of a block's scratch

// Key rows (K and V) a block stages: K2 (NORM) a row's keys whole, K3 its
// ring.
__host__ __device__ constexpr int fwd16_key_rows(int W, bool norm) {
  return norm ? (W + LONG_T - 1) / LONG_T * LONG_T : FWD16_STAGES * LONG_T;
}


// Shared bytes of a block on rows of W tokens: Q, K and V as bf16 rows of
// LONG16_LD; per staged key its tag; the row's tags and a -1 past them; its
// runs' first tokens and lengths (the key list, in a row where an id forms
// two runs); the scratch.
__host__ __device__ constexpr int fwd16_bytes(int W, bool norm) {
  return (LONG_T + 2 * fwd16_key_rows(W, norm)) * LONG16_LD * 2 +
         (fwd16_key_rows(W, norm) + 3 * W + 1 + FWD16_MISC) * 4;
}

// A wrapper's launch of the bf16 long forward: a block of LONG16_THREADS
// per (row, head, tile slot), ceil(W / LONG_T) + 1 slots a row.
__host__ inline bool fwd16_launch_ok(const tile::Launch& L, int B, int W,
                                     int H, bool norm) {
  return L.pad == LONG_T && L.group == 1 && L.gx == B && L.gy == H &&
         L.gz == (W + LONG_T - 1) / LONG_T + 1 &&
         L.threads == LONG16_THREADS && L.smem == fwd16_bytes(W, norm) &&
         L.smem <= tile::SMEM_MAX;
}

namespace lr {

template <bool B>
struct Bool {  // a compile-time flag as an argument
  static constexpr bool value = B;
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

// The shared memory of a block of the bf16 long forward.
struct Fwd16Tiles {
  tile::bf16 *Q, *K, *V;  // LONG_T query rows; the staged key rows
  int* ktag;              // per staged key row: its tag
  int* tg;                // the row's tags, tg[W] = -1
  int *s0, *len;          // runs: first token, length (s0: the key list)
  int* misc;              // [0] runs; [2, 4) block_range; [4, ...) scan

  __device__ Fwd16Tiles(float4* s, int W, bool norm) {
    const int kr = fwd16_key_rows(W, norm);
    Q = reinterpret_cast<tile::bf16*>(s);
    K = Q + LONG_T * LONG16_LD;
    V = K + kr * LONG16_LD;
    ktag = reinterpret_cast<int*>(V + kr * LONG16_LD);
    tg = ktag + kr;
    s0 = tg + W + 1;
    len = s0 + W;
    misc = len + W;
  }
};

constexpr float LOG2E = 1.4426950408889634f;

// e^x for x = s - m, given s and ml = m log2(e): one FFMA and the SFU's
// ex2 (relative error below 2^-22; e^-inf = 0), as flash attention
// kernels take it, in place of expf's dozen instructions a pair.
__device__ __forceinline__ float exp_ml(float s, float ml) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(fmaf(s, LOG2E, -ml)));
  return y;
}

// 1 / x for x >= 1e-16 (the normalisers): the SFU's reciprocal, within an
// ulp, with no call into the division's slow path (whose register saves
// would spill)
__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The scaled scores of one 16-key tile (keys k0..) of a staged chunk as
// tile::scores16 computes them, -inf for the keys from nk on (past the run;
// FULL: none, the chunk is whole): every other pair of a tile inside one
// run meets.
template <bool FULL>
__device__ __forceinline__ void run_scores16(const tile::bf16* K,
                                             const unsigned (&qa)[2][4],
                                             int k0, int nk, float scale,
                                             float (&c)[2][4],
                                             float (&mx)[2]) {
  const int lane = threadIdx.x & 31, q = lane & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int kk = k0 + 8 * hf;
    unsigned kb[4];
    tile::ldsm4(kb, K + (kk + (lane & 7)) * LONG16_LD + 8 * (lane >> 3));
    float(&a)[4] = c[hf];
    a[0] = a[1] = a[2] = a[3] = 0.f;
    tile::mma16(a, qa[0], kb[0], kb[1]);
    tile::mma16(a, qa[1], kb[2], kb[3]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      a[e] = FULL || kk + 2 * q + (e & 1) < nk ? a[e] * scale : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], a[e]);
    }
  }
}

// One query tile: queries q0 .. q0 + nq - 1, `total` keys, key r the token
// kix[r] under the tags (GEN) or k0 + r. Writes out, and with STATS m and
// l, of the tile's queries. Every thread of the block calls it; a warp
// whose rows all lie past nq stages and waits, nothing more.
template <bool NORM, bool GEN, bool DROP, bool STATS, class Split>
__device__ __forceinline__ void fwd16_tile(
    const Fwd16Tiles& s, const tile::bf16* __restrict__ row, int d,
    tile::bf16* __restrict__ out, float* __restrict__ stat_m,
    float* __restrict__ stat_l, int W, int q0, int nq, const int* kix,
    int k0, int total, float scale, const Split& kept, float inv_keep) {
  using tile::bf16;
  constexpr int LD = LONG16_LD, NTH = LONG16_THREADS, QB = LONG_T;
  constexpr int NS = FWD16_STAGES;
  constexpr float M0 = -1e30f;  // the running max before the first key
  const int t = threadIdx.x, lane = t & 31, m0 = (t >> 5) * 16;
  const int g = lane >> 2, q = lane & 3, d3 = 3 * d;  // offsets in a row
  const bool live = m0 < nq;  // uniform in the warp
  const int chunks = (total + T - 1) / T;
  auto tok = [&](int r) -> int {
    if constexpr (GEN)
      return kix[r];
    else
      return k0 + r;
  };
  int tag[2] = {0, 0};  // GEN: the rows' tags (-1 past nq)
  if constexpr (GEN) {
    tag[0] = m0 + g < nq ? s.tg[q0 + m0 + g] : -1;
    tag[1] = m0 + g + 8 < nq ? s.tg[q0 + m0 + g + 8] : -1;
  }
  float mx[2] = {M0, M0}, l[2] = {0.f, 0.f};
  float o[4][4] = {};
  unsigned qa[2][4];
  unsigned at[2] = {0u, 0u};  // DROP: the rows' parts of the mask's hash
  if constexpr (DROP) {
    at[0] = kept.at(q0 + m0 + g);
    at[1] = kept.at(q0 + m0 + g + 8);
  }

  // rows r0 .. r0 + rows - 1 of the tile's keys (zeros from total on): K
  // into Kd, V into Vd (either may be null), their tags into kt (GEN)
  auto stage_keys = [&](bf16* Kd, bf16* Vd, int* kt, int r0, int rows) {
    for (int idx = t; idx < rows * 4; idx += NTH) {
      const int r = idx >> 2, c = (idx & 3) * 8;
      const bool ok = r0 + r < total;
      const int tk = ok ? tok(r0 + r) : 0;
      if (Kd) tile::cp16(Kd + r * LD + c, row + d + tk * d3 + c, ok);
      if (Vd) tile::cp16(Vd + r * LD + c, row + 2 * d + tk * d3 + c, ok);
    }
    if constexpr (GEN)
      if (kt)
        for (int r = t; r < rows; r += NTH)
          kt[r] = r0 + r < total ? s.tg[tok(r0 + r)] : -1;
  };
  auto stage_q = [&] {
    for (int idx = t; idx < QB * 4; idx += NTH) {
      const int r = idx >> 2, c = (idx & 3) * 8;
      const bool ok = r < nq;
      tile::cp16(s.Q + r * LD + c, row + (ok ? q0 + r : 0) * d3 + c, ok);
    }
  };
  // the masked, scaled scores of the warp's rows and key tile k of a chunk
  // (nk keys at K; `full`: nk is the chunk's T); cm: their running row max
  auto score_tile = [&](const bf16* K, const int* kt, int k, int nk,
                        bool full, float (&c)[2][4], float (&cm)[2]) {
    if constexpr (GEN)
      tile::scores16(K, kt, qa, 16 * k, tag, scale, c, cm);
    else if (full)
      run_scores16<true>(K, qa, 16 * k, nk, scale, c, cm);
    else
      run_scores16<false>(K, qa, 16 * k, nk, scale, c, cm);
  };
  // a chunk's scores, its key tiles' in sc
  auto scores = [&](const bf16* K, const int* kt, int nk,
                    float (&sc)[4][2][4], float (&cm)[2]) {
    const int nkt = (nk + 15) >> 4;
    const bool full = nk == T;  // uniform: a whole chunk, no key to mask
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k >= nkt) break;
      score_tile(K, kt, k, nk, full, sc[k], cm);
    }
  };
  // the online max and sum over a chunk's scores: sc becomes exp(s - m),
  // a the rescale of what came before
  auto online = [&](float (&sc)[4][2][4], float (&cm)[2], int nkt,
                    float (&a)[2]) {
    tile::quad_max(cm);
    float sum[2] = {0.f, 0.f};
    float ml[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(mx[r], cm[r]);  // finite: mx >= M0
      ml[r] = mn * LOG2E;
      a[r] = exp_ml((mx[r] - mn), 0.f);  // exactly 1 where m stays
      mx[r] = mn;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k >= nkt) break;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp_ml(sc[k][hf][e], ml[e >> 1]);  // 0: no pair
          sc[k][hf][e] = p;
          sum[e >> 1] += p;
        }
    }
    tile::quad_sum(sum);
    l[0] = l[0] * a[0] + sum[0];
    l[1] = l[1] * a[1] + sum[1];
  };
  // O += P V over key tile k of a chunk whose keys start at r0 (rq = r0 +
  // 2 q): p (K2: exp(s - m) / l) dropped, rounded to bf16. The mask's hash
  // takes a key's part once for both of the thread's rows.
  auto pv_tile = [&](float (&c)[2][4], const bf16* V, int rq, int k,
                     const float (&inv)[2], const float (&ml)[2]) {
    unsigned cj[2][2] = {};  // DROP: [half][column] the keys' parts
    if constexpr (DROP) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int r = rq + 16 * k + 8 * hf + cc;
          cj[hf][cc] = kept.col(r < total ? tok(r) : 0);
        }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = c[hf][e];
        if constexpr (NORM) p = exp_ml(p, ml[e >> 1]) * inv[e >> 1];
        if constexpr (DROP)
          p = kept.keeps(at[e >> 1] + cj[hf][e & 1]) ? p * inv_keep : 0.f;
        c[hf][e] = p;
      }
    unsigned pa[4];
    tile::a_frag(pa, c);
    times_rows16(o, pa, V, 16 * k);
  };
  // rq: the first key of a chunk's thread columns, opaque to the compiler
  // so that it keeps no per-key sums alive across chunks
  auto key_base = [&](int r0) {
    int rq = r0 + 2 * q;
    asm volatile("" : "+r"(rq));
    return rq;
  };

  if (chunks > 0) {
    stage_q();  // lands with the first chunk's group
    if constexpr (NORM) {
      // every key once: chunk c's K in group c, then V in one group
      for (int c = 0; c < chunks; ++c) {
        stage_keys(s.K + c * T * LD, nullptr, s.ktag + c * T, c * T, T);
        cp_commit();
      }
      stage_keys(nullptr, s.V, nullptr, 0, chunks * T);
      cp_commit();
      for (int c = 0; c < chunks; ++c) {  // m and l
        cp_wait_upto(chunks - c);  // chunk c's K (and Q) have landed
        __syncthreads();
        if (!live) continue;
        a_rows16(qa, s.Q, m0);  // reread a chunk: no registers held
        const int nk = min(T, total - c * T);
        auto body = [&](auto whole) {  // whole: nk is T (no key masked)
          constexpr bool FULL = decltype(whole)::value;
          float sc[4][2][4], cm[2] = {-INFINITY, -INFINITY}, a[2];
          scores(s.K + c * T * LD, s.ktag + c * T, FULL ? T : nk, sc, cm);
          online(sc, cm, FULL ? 4 : (nk + 15) >> 4, a);
        };
        if (nk == T)
          body(Bool<true>{});
        else
          body(Bool<false>{});
      }
      cp_wait_group<0>();  // V
      __syncthreads();
      if (live) {  // P V, p normalised by the final m and l
        const float inv[2] = {rcp(fmaxf(l[0], 1e-16f)),
                              rcp(fmaxf(l[1], 1e-16f))};
        const float ml[2] = {mx[0] * LOG2E, mx[1] * LOG2E};
#pragma unroll 1
        for (int c = 0; c < chunks; ++c) {
          a_rows16(qa, s.Q, m0);
          const int nk = min(T, total - c * T), rq = key_base(c * T);
          const bf16* K = s.K + c * T * LD;
          const bf16* V = s.V + c * T * LD;
          auto body = [&](auto whole) {  // a key tile at a time: m, l known
            constexpr bool FULL = decltype(whole)::value;
            const int nkt = FULL ? 4 : (nk + 15) >> 4;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              if (k >= nkt) break;
              float sc[2][4], unused[2] = {0.f, 0.f};
              score_tile(K, s.ktag + c * T, k, nk, FULL, sc, unused);
              pv_tile(sc, V, rq, k, inv, ml);
            }
          };
          if (nk == T)
            body(Bool<true>{});
          else
            body(Bool<false>{});
        }
      }
    } else {
      // the ring: chunk c in slot c % NS, loaded NS - 1 chunks ahead
#pragma unroll
      for (int c = 0; c < NS - 1; ++c) {
        if (c < chunks)
          stage_keys(s.K + c * T * LD, s.V + c * T * LD, s.ktag + c * T,
                     c * T, T);
        cp_commit();
      }
      for (int c = 0; c < chunks; ++c) {
        cp_wait_group<NS - 2>();  // chunk c (and Q) have landed
        __syncthreads();          // and slot (c - 1) % NS is free
        if (c + NS - 1 < chunks) {
          const int sl = (c + NS - 1) % NS;
          stage_keys(s.K + sl * T * LD, s.V + sl * T * LD, s.ktag + sl * T,
                     (c + NS - 1) * T, T);
        }
        cp_commit();
        if (!live) continue;
        a_rows16(qa, s.Q, m0);  // reread a chunk: no registers held
        const int sl = c % NS, nk = min(T, total - c * T);
        const int rq = key_base(c * T);
        auto body = [&](auto whole) {  // whole: nk is T (no key masked)
          constexpr bool FULL = decltype(whole)::value;
          const int nkt = FULL ? 4 : (nk + 15) >> 4;
          float sc[4][2][4], cm[2] = {-INFINITY, -INFINITY}, a[2];
          scores(s.K + sl * T * LD, s.ktag + sl * T, FULL ? T : nk, sc, cm);
          online(sc, cm, nkt, a);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {  // the accumulator follows m
            o[nt][0] *= a[0];
            o[nt][1] *= a[0];
            o[nt][2] *= a[1];
            o[nt][3] *= a[1];
          }
          const float one[2] = {1.f, 1.f};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (k >= nkt) break;
            pv_tile(sc[k], s.V + sl * T * LD, rq, k, one, one);
          }
        };
        if (nk == T)
          body(Bool<true>{});
        else
          body(Bool<false>{});
      }
      cp_wait_group<0>();
      const float li[2] = {rcp(fmaxf(l[0], 1e-16f)),
                           rcp(fmaxf(l[1], 1e-16f))};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        o[nt][0] *= li[0];
        o[nt][1] *= li[0];
        o[nt][2] *= li[1];
        o[nt][3] *= li[1];
      }
    }
  }
  if (!live) return;
  // the tile's first row of the output, from the block's coordinates
  const long r0 = (long)blockIdx.x * W + q0 + m0;
  const int h = blockIdx.y, H = gridDim.y;
  tile::store_rows16(out + r0 * d + h * LONG16_HD, d, o, nq - m0);
  if (STATS && q == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (m0 + g + 8 * r < nq) {
        const long at = (r0 + g + 8 * r) * H + h;
        stat_m[at] = l[r] > 0.f ? mx[r] : -INFINITY;
        stat_l[at] = l[r];
      }
}

// A row where an id forms two runs, out of line so that its registers do
// not weigh on the runs' tiles (it takes only the kernel's arguments, and
// finds the rest again): slot z takes the positional tiles z, z + Z, ...; a
// tile's keys are those whose tag lies between its least and greatest
// query tag, listed by rank once, masked pair by pair.
template <bool NORM, bool DROP, bool STATS, class Keep>
__device__ __noinline__ void fwd16_general(const tile::bf16* __restrict__ qkv,
                                           tile::bf16* __restrict__ out,
                                           float* __restrict__ stat_m,
                                           float* __restrict__ stat_l, int W,
                                           int d, float scale, Keep keep) {
  constexpr int NTH = LONG16_THREADS, QB = LONG_T;
  extern __shared__ float4 smem4[];
  const Fwd16Tiles s(smem4, W, NORM);
  const int t = threadIdx.x, h = blockIdx.y;
  const tile::bf16* row =
      qkv + (long)blockIdx.x * W * 3 * d + h * LONG16_HD;
  const auto kept = keep.split(blockIdx.x, h, gridDim.y, W);
  for (int zt = blockIdx.z; zt * QB < W; zt += gridDim.z) {
    const int q0 = zt * QB, nq = min(QB, W - q0);
    __syncthreads();  // the previous tile's reads of the shared tiles
    int qmin, qmax;
    block_range(t < nq ? s.tg[q0 + t] : -1, s.misc + 2, qmin, qmax);
    int total = 0;
    if (qmax >= 0) {  // uniform: the tile holds a query that can attend
      auto sel = [&](int j) {
        const int k = s.tg[j];
        return k >= qmin && k <= qmax;  // qmin >= 0
      };
      int r = rank_keys(W, sel, s.misc + 4, total);
      const int per = (W + NTH - 1) / NTH, j0 = min(W, t * per);
      const int j1 = min(W, j0 + per);
      for (int j = j0; j < j1; ++j)  // the key list, once a tile
        if (sel(j)) s.s0[r++] = j;
      __syncthreads();
    }
    fwd16_tile<NORM, true, DROP, STATS>(s, row, d, out, stat_m, stat_l, W,
                                        q0, nq, s.s0, 0, total, scale, kept,
                                        keep.inv_keep);
  }
}

}  // namespace lr

// One block of four warps per (row, head, tile slot) on rows of W tokens,
// seg [B, W] the graph ids (the mask: seg[i] == seg[j] >= 0): out, and
// with STATS m and l [B, W, H] (m = -inf, l = 0 for a query with no key,
// whose output is exact zeros).
template <bool NORM, bool DROP, bool STATS, class Keep>
__device__ __forceinline__ void long_fwd16(const tile::bf16* __restrict__ qkv,
                                           const int* __restrict__ seg,
                                           tile::bf16* __restrict__ out,
                                           float* __restrict__ stat_m,
                                           float* __restrict__ stat_l, int W,
                                           int d, float scale, Keep keep) {
  using namespace lr;
  constexpr int NTH = LONG16_THREADS, QB = LONG_T;
  extern __shared__ float4 smem4[];
  const Fwd16Tiles s(smem4, W, NORM);
  const int t = threadIdx.x;
  for (int i = t; i <= W; i += NTH)
    s.tg[i] = i < W ? seg[(long)blockIdx.x * W + i] : -1;
  if (tile::find_runs(s.tg, W, s.s0, s.len, s.misc)) {  // an id in two runs
    fwd16_general<NORM, DROP, STATS>(qkv, out, stat_m, stat_l, W, d, scale,
                                     keep);
    return;
  }
  const long b = blockIdx.x, base = b * W;
  const int h = blockIdx.y, H = gridDim.y, z = blockIdx.z, Z = gridDim.z;
  const tile::bf16* row = qkv + base * 3 * d + h * LONG16_HD;
  const auto kept = keep.split(b, h, H, W);  // the row's seed, once
  {  // this slot's share of the row's padding tokens: zeros
    const int per = (W + Z - 1) / Z, p0 = min(W, z * per);
    const int p1 = min(W, p0 + per);
    for (int idx = t; idx < (p1 - p0) * 4; idx += NTH) {
      const int i = p0 + (idx >> 2), c = (idx & 3) * 8;
      if (s.tg[i] >= 0) continue;
      *reinterpret_cast<uint4*>(out + (base + i) * d + h * LONG16_HD + c) =
          make_uint4(0u, 0u, 0u, 0u);
      if (STATS && c == 0) {
        stat_m[(base + i) * H + h] = -INFINITY;
        stat_l[(base + i) * H + h] = 0.f;
      }
    }
  }
  const int runs = s.misc[0];
  for (int it = z;; it += Z) {  // the runs' tiles, this slot's in turn
    int k = 0, first = 0;
    for (; k < runs; ++k) {
      const int n = (s.len[k] + QB - 1) / QB;
      if (it < first + n) break;
      first += n;
    }
    if (k == runs) break;
    const int k0 = s.s0[k], n = s.len[k], q0 = k0 + (it - first) * QB;
    __syncthreads();  // the previous tile's reads of the shared tiles
    fwd16_tile<NORM, false, DROP, STATS>(s, row, d, out, stat_m, stat_l, W,
                                         q0, min(QB, k0 + n - q0), nullptr,
                                         k0, n, scale, kept, keep.inv_keep);
  }
}

}  // namespace attn
