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
// Dropout (torch semantics: normalise by the undropped denominator, then
// drop and scale by 1/(1-rate)) keeps (i, j) iff hash(pos, seed') <
// thresh, with pos = ((r % bt)*W + i)*sp + j and seed' = seed + (r /
// bt)*stride + h (stride H; H + 3 when K4's kernels run inside K10's
// layer, transformer_layer.cu): the counter hash of the JAX package's
// interpret mode, so forward, backward and the plain version draw the same
// mask from (seed, r, h, i, j) and nothing is stored. The Dropout policy
// below is the Keep of every body K2 and K4 run.
//
// K2 does the work of each graph once: one attention problem per (row,
// graph segment, head). Rows of up to 128 tokens (every molecule row,
// NCI1's, code2's 128 tier) take the whole-span bodies of
// attention_tile.cuh with SegRuns as the span source: one block of 256
// threads per (row, head) finds the row's segments from seg itself (no
// host synchronisation), stages the row's Q, K, V (and dO) once, and runs
// each segment as one problem: the scores once into a shared tile, an
// exact two-pass softmax and O = P_drop V / l (forward); delta = dO.O, p,
// dp and ds of each pair once with one dropout draw, then dQ, dK and dV
// (backward); all by register-blocked 4 x 4 micro-tiles, one writer a cell.
// A row in which one graph id forms two runs takes the whole row as one
// problem under K2's mask itself. Wider rows (129-384 tokens: code2's 384
// tier, graphs of 129-384 tokens) take the long-row forward of
// attention_fwd.cuh and the long-row pair of attention_bwd.cuh with seg
// as both tags (K3-bwd's SegTags), which take any seg. Where a gradient is
// wanted the forward writes m and l [R, W, H] (attention_fwd.cuh's
// meaning) and the backward reads them. The wrapper's seg_fwd_geometry and
// seg_bwd_geometry pick the instance by W; the entries check the launch.
// The bf16 instances (the bf16 step) have bodies of their own (launch:
// seg_bf16_geometry): rows of up to 128 attention_tile.cuh's fwd_seg16 and
// bwd_seg16 (bf16 rows in shared memory, a warp a 16-query tile of a
// segment, its scores in registers, every product on bf16 mma.sync); rows
// of 129-384 the bf16 long forward (attention_fwd.cuh: long_fwd16, query
// tiles inside one graph's run, the run's keys staged once for both
// sweeps, p normalised before it is rounded) and the bf16 long pair
// (attention_bwd.cuh: long_dq16, long_dkv16, query and key tiles inside
// one graph's run, a tile's partners staged once, delta summed from the
// pairs), as the JAX kernel in bf16.
// What it replaces: one block per (row, head) with one thread per query
// walking all W keys of the row, each key one hd-long dependent FMA chain,
// other graphs' keys skipped only after their tag was read, the whole
// row's K and V staged for every head; and a backward that recomputed m, l
// and delta and computed s = q.k and the dropout hash of every pair twice.
// Bound on the H100: memory (qkv, seg in, out back: 0.072 ms at 923 rows
// of 128, d 128; the backward 0.127 ms); about a fifth of a molecule
// row's W x W pairs share a segment.
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
// tags. Both draw K2's mask through the Dropout policy (as K4's
// backward does) and, where a gradient is wanted, write m and l per (row,
// query, head) with attention_fwd.cuh's meaning.
//
// K4's backward runs on attention_tile.cuh, one fused kernel per span (a
// graph block, or the row at block 0): delta = dO.O, p, dp and ds of each
// pair once (one dropout draw), then dQ, dK and dV from the shared tiles.
// Spans of up to 64 tokens go whole to attention_dense_bwd_short_kernel;
// wider ones (block 0, rows of up to 384) to attention_dense_bwd_wide_kernel
// in 64-token tiles. The wrapper (dense_bwd_geometry) picks the instance,
// grid, threads and shared bytes; the entry checks them before launching.
//
// K4's bf16 instances (the bf16 step of the Transformer-only model, heads
// of 64) run the bf16 key-list bodies of attention_list16.cuh with K4's
// mask as their tags and K2's rounding (NORM: p normalised before it is
// rounded, delta summed from the pairs): a block of four warps per (row,
// head, 64-token tile of a graph block, or of the row at block 0), the
// block's keys ranked and gathered 64 at a time, every product a bf16
// mma.sync. The launch is the wrapper's list16_geometry: the forward's
// instance 1 (the tile instance, spans of up to 128 tokens: the molecule
// paths' packed rows) and 3 (the long one, rows of 129-384 at block 0)
// run one body; the backward's instance 1 (the short one, spans of up to
// 64) runs the whole backward of a span in one kernel (span_bwd16, keys by
// position), its instance 3 the dq and dk/dv pair.

#include <cuda_runtime.h>
#include <math.h>

#include "attention_bwd.cuh"
#include "attention_fwd.cuh"
#include "attention_list16.cuh"
#include "attention_tile.cuh"
#include "hash.cuh"

namespace {

struct Dropout {
  int on;            // 0: rate 0, the identity
  unsigned thresh;   // keep iff bits < thresh
  float inv_keep;    // 1 / (1 - rate)
  int seed;
  int bt;            // rows per TPU grid tile (mask tiling of the reference)
  int sp;            // W rounded up to 128
  int stride;        // seeds a tile: H (K2, K4), H + 3 (K10's layer)

  // keep (r, h, i, j) of a row of W tokens: the Keep policy of the bodies
  __device__ bool operator()(long r, int h, int H, int W, int i,
                             int j) const {
    const unsigned hseed = (unsigned)seed + (unsigned)(r / bt) * stride + h;
    const unsigned pos = ((unsigned)(r % bt) * W + i) * (unsigned)sp + j;
    return prng::hash_bits(pos, hseed) < thresh;
  }

  // The same mask for one (row r, head h) with the seed and the row's
  // first position computed once (K2's bf16 bodies: a block a row and
  // head): row(r, h, W)(i, j) == (*this)(r, h, H, W, i, j).
  struct Row {
    unsigned hseed, base, sp, thresh;
    __device__ bool operator()(int i, int j) const {
      return prng::hash_bits((base + i) * sp + j, hseed) < thresh;
    }
  };
  __device__ Row row(long r, int h, int W) const {
    return Row{(unsigned)seed + (unsigned)(r / bt) * stride + h,
               (unsigned)(r % bt) * W, (unsigned)sp, thresh};
  }
  // the bf16 long bodies' form (their Keep also serves K3, whose mask
  // needs H; here the seeds' stride holds it)
  __device__ Row row(long r, int h, int, int W) const { return row(r, h, W); }
  // The bf16 long forward's form: the hash input of (i, j) split as a
  // query's part and a key's, x(i, j) = at(i) + col(j) (mod 2^32), so a
  // key's part serves both of a thread's rows; keeps(x) == Row(i, j).
  struct Split {
    unsigned hseed, base, sp, thresh;
    __device__ unsigned at(int i) const {
      return (base + i) * sp * prng::POS_MUL + hseed * prng::SEED_MUL;
    }
    __device__ unsigned col(int j) const { return j * prng::POS_MUL; }
    __device__ bool keeps(unsigned x) const { return prng::mix(x) < thresh; }
  };
  __device__ Split split(long r, int h, int, int W) const {
    // row's seed and base in 32 bits (r < 2^32): no 64-bit division, whose
    // call would spill the caller's registers
    const unsigned ru = (unsigned)r, b = (unsigned)bt;
    return Split{(unsigned)seed + ru / b * stride + h, ru % b * W,
                 (unsigned)sp, thresh};
  }
};

constexpr int W_MAX = 384;         // the widest row K2 and K4 take
constexpr int SEG_TILE_MAX = tile::SEG_W_MAX;  // K2: the tile kernels' rows
constexpr int SEG_FWD_THREADS = 256;  // K2's tile forward: two blocks an SM
constexpr int SEG_BWD_THREADS = 512;  // K2's tile backward: one block an SM

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


// ---- K2 ------------------------------------------------------------------

// K2's forward on rows of up to SEG_TILE_MAX tokens: one block per (row,
// head), the row's graph segments its problems.
template <int HD, bool DROP, bool STATS>
__global__ void __launch_bounds__(SEG_FWD_THREADS)
attention_seg_fwd_tile_kernel(const float* __restrict__ qkv,
                              const int* __restrict__ seg,
                              float* __restrict__ out,
                              float* __restrict__ stat_m,
                              float* __restrict__ stat_l, int W, int d, int H,
                              int score, float scale, Dropout dr) {
  tile::SegRuns<HD, false> src(seg, nullptr, nullptr, nullptr, stat_m, stat_l,
                               out, W, H, score);
  tile::fwd_tile<HD, DROP, STATS>(src, qkv, out, stat_m, stat_l, W, d, H,
                                  scale, dr);
}

// K2's forward on wider rows: one block per (row, head, 64 queries), seg
// as both tags.
template <int HD, bool DROP, bool STATS>
__global__ void __launch_bounds__(attn::LONG_FWD_THREADS,
                                  attn::long_fwd_blocks(HD))
attention_seg_fwd_long_kernel(const float* __restrict__ qkv,
                              attn::SegTags tags, float* __restrict__ out,
                              float* __restrict__ stat_m,
                              float* __restrict__ stat_l, int W, int d,
                              float scale, Dropout dr) {
  attn::long_fwd<HD, DROP, STATS>(qkv, tags, out, stat_m, stat_l, W, d, scale,
                                  dr);
}

// K2's backward on rows of up to SEG_TILE_MAX tokens: one block per (row,
// head).
template <int HD>
__global__ void __launch_bounds__(SEG_BWD_THREADS)
attention_seg_bwd_tile_kernel(const float* __restrict__ qkv,
                              const int* __restrict__ seg,
                              const float* __restrict__ out,
                              const float* __restrict__ gout,
                              const float* __restrict__ stat_m,
                              const float* __restrict__ stat_l,
                              float* __restrict__ dqkv, int W, int d, int H,
                              int score, float scale, Dropout dr) {
  tile::SegRuns<HD, true> src(seg, gout, stat_m, stat_l, nullptr, nullptr,
                              dqkv, W, H, score);
  tile::bwd_tile<HD>(src, qkv, out, dqkv, W, d, H, scale, dr);
}

// K2's bf16 instances, on rows of up to SEG_TILE_MAX tokens: a block of
// tile::SEG16_THREADS per (row, head), the bodies fwd_seg16 and bwd_seg16
// of attention_tile.cuh (a warp a 16-query tile, bf16 mma.sync). Registers
// for five blocks an SM forward (its shared memory allows six), four
// backward.
template <bool DROP, bool STATS>
__global__ void __launch_bounds__(tile::SEG16_THREADS, 5)
attention_seg_fwd_bf16_kernel(const tile::bf16* __restrict__ qkv,
                              const int* __restrict__ seg,
                              tile::bf16* __restrict__ out,
                              float* __restrict__ stat_m,
                              float* __restrict__ stat_l, int W, int d, int H,
                              float scale, Dropout dr) {
  tile::fwd_seg16<DROP, STATS>(seg, qkv, out, stat_m, stat_l, W, d, H, scale,
                               dr);
}

__global__ void __launch_bounds__(tile::SEG16_THREADS, 4)
attention_seg_bwd_bf16_kernel(const tile::bf16* __restrict__ qkv,
                              const int* __restrict__ seg,
                              const tile::bf16* __restrict__ gout,
                              const float* __restrict__ stat_m,
                              const float* __restrict__ stat_l,
                              tile::bf16* __restrict__ dqkv, int W, int d,
                              int H, float scale, Dropout dr) {
  tile::bwd_seg16(seg, qkv, gout, stat_m, stat_l, dqkv, W, d, H, scale, dr);
}

// K2's bf16 instances on wider rows (129-384, code2's 384 tier): the bf16
// long forward (attention_fwd.cuh: long_fwd16, a tile's keys staged whole
// and walked twice from shared memory, p normalised before it is rounded)
// and the bf16 long pair (attention_bwd.cuh: long_dq16 and long_dkv16 with
// PAIRS, delta summed from the pairs, tiles inside one graph's run, a
// tile's partners staged whole). Registers for three blocks an SM (their
// shared memory allows three at W 384; up to 168 registers a thread, so
// that nothing spills).
template <bool DROP, bool STATS>
__global__ void __launch_bounds__(attn::LONG16_THREADS, 3)
attention_seg_fwd_long_bf16_kernel(const tile::bf16* __restrict__ qkv,
                                   const int* __restrict__ seg,
                                   tile::bf16* __restrict__ out,
                                   float* __restrict__ stat_m,
                                   float* __restrict__ stat_l, int W, int d,
                                   float scale, Dropout dr) {
  attn::long_fwd16<true, DROP, STATS>(qkv, seg, out, stat_m, stat_l, W, d,
                                      scale, dr);
}

template <bool DROP>
__global__ void __launch_bounds__(attn::LONG16_THREADS, 3)
attention_seg_bwd_dq_bf16_kernel(const tile::bf16* __restrict__ qkv,
                                 const int* __restrict__ seg,
                                 const tile::bf16* __restrict__ out,
                                 const tile::bf16* __restrict__ gout,
                                 const float* __restrict__ stat_m,
                                 const float* __restrict__ stat_l,
                                 float* __restrict__ rec,
                                 tile::bf16* __restrict__ dqkv, int W, int d,
                                 float scale, Dropout dr) {
  attn::long_dq16<true, DROP>(qkv, seg, out, gout, stat_m, stat_l, rec, dqkv,
                              W, d, scale, dr);
}

template <bool DROP>
__global__ void __launch_bounds__(attn::LONG16_THREADS, 3)
attention_seg_bwd_dkv_bf16_kernel(const tile::bf16* __restrict__ qkv,
                                  const int* __restrict__ seg,
                                  const tile::bf16* __restrict__ gout,
                                  float* __restrict__ rec,
                                  tile::bf16* __restrict__ dqkv, int W, int d,
                                  float scale, Dropout dr) {
  attn::long_dkv16<true, DROP>(qkv, seg, gout, rec, dqkv, W, d, scale, dr);
}

// K2's backward on wider rows: the long-row pair (dq, then dk/dv).
template <int HD>
__global__ void __launch_bounds__(attn::LONG_THREADS, attn::long_blocks(HD))
attention_seg_bwd_dq_kernel(const float* __restrict__ qkv, attn::SegTags tags,
                            const float* __restrict__ out,
                            const float* __restrict__ gout,
                            const float* __restrict__ stat_m,
                            const float* __restrict__ stat_l,
                            float* __restrict__ delta,
                            float* __restrict__ dqkv, int W, int d,
                            float scale, Dropout dr) {
  attn::lr::long_dq<HD>(qkv, tags, out, gout, stat_m, stat_l, delta, dqkv, W,
                        d, scale, dr);
}

template <int HD>
__global__ void __launch_bounds__(attn::LONG_THREADS, attn::long_blocks(HD))
attention_seg_bwd_dkv_kernel(const float* __restrict__ qkv,
                             attn::SegTags tags,
                             const float* __restrict__ gout,
                             const float* __restrict__ stat_m,
                             const float* __restrict__ stat_l,
                             const float* __restrict__ delta,
                             float* __restrict__ dqkv, int W, int d,
                             float scale, Dropout dr) {
  attn::lr::long_dkv<HD>(qkv, tags, gout, stat_m, stat_l, delta, dqkv, W, d,
                         scale, dr);
}

// The tile instance's launch, as attention_packed.py:seg_fwd_geometry and
// seg_bwd_geometry compute it: a block per (row, head).
bool seg_tile_launch_ok(const Launch& L, int R, int W, int H, int hd,
                        bool bwd) {
  return W <= SEG_TILE_MAX && L.pad == tile::round4(W) && L.group == 1 &&
         (long)L.gx == (long)R * H && L.gy == 1 && L.gz == 1 &&
         L.threads == (bwd ? SEG_BWD_THREADS : SEG_FWD_THREADS) &&
         L.smem == tile::seg_tile_words(W, hd, bwd) * 4 &&
         L.smem <= tile::SMEM_MAX;
}

// Launches K2's forward (instance 1 the tile kernel, 3 the long one) after
// checking the wrapper's seg_fwd_geometry; each kernel's shared-memory
// attribute is raised once, before its first launch.
template <int HD, bool DROP, bool STATS>
int launch_seg_fwd(const float* qkv, const int* seg, float* out,
                   float* stat_m, float* stat_l, int R, int W, int d, int H,
                   Dropout dr, const Launch& L, cudaStream_t stream) {
  const float scale = 1.f / sqrtf((float)HD);
  if (L.instance == 1) {
    if (!seg_tile_launch_ok(L, R, W, H, HD, false))
      return cudaErrorInvalidValue;
    static const cudaError_t set = [] {  // two blocks an SM at W 128
      const auto k = attention_seg_fwd_tile_kernel<HD, DROP, STATS>;
      const cudaError_t e = cudaFuncSetAttribute(
          k, cudaFuncAttributeMaxDynamicSharedMemorySize, tile::SMEM_MAX);
      if (e != cudaSuccess) return e;
      return cudaFuncSetAttribute(
          k, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    }();
    if (set != cudaSuccess) return set;
    attention_seg_fwd_tile_kernel<HD, DROP, STATS>
        <<<L.gx, L.threads, L.smem, stream>>>(qkv, seg, out, stat_m, stat_l,
                                              W, d, H,
                                              tile::seg_score_floats(W),
                                              scale, dr);
    return cudaGetLastError();
  }
  if (L.instance == 3) {
    if (W <= SEG_TILE_MAX || !attn::long_fwd_launch_ok(L, R, W, H, HD))
      return cudaErrorInvalidValue;
    static const cudaError_t set = cudaFuncSetAttribute(
        attention_seg_fwd_long_kernel<HD, DROP, STATS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        attn::long_fwd_bytes(HD));
    if (set != cudaSuccess) return set;
    attention_seg_fwd_long_kernel<HD, DROP, STATS>
        <<<dim3(L.gx, L.gy, L.gz), L.threads, L.smem, stream>>>(
            qkv, attn::SegTags{seg, seg}, out, stat_m, stat_l, W, d, scale,
            dr);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

// Launches K2's backward (instance 1 the tile kernel, 3 the long pair,
// which passes delta [R, W, H] from its dq kernel to its dk/dv kernel)
// after checking the wrapper's seg_bwd_geometry.
template <int HD>
int launch_seg_bwd(const float* qkv, const int* seg, const float* out,
                   const float* gout, const float* stat_m,
                   const float* stat_l, float* delta, float* dqkv, int R,
                   int W, int d, int H, Dropout dr, const Launch& L,
                   cudaStream_t stream) {
  const float scale = 1.f / sqrtf((float)HD);
  if (L.instance == 1) {
    if (!seg_tile_launch_ok(L, R, W, H, HD, true))
      return cudaErrorInvalidValue;
    static const cudaError_t set = cudaFuncSetAttribute(
        attention_seg_bwd_tile_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, tile::SMEM_MAX);
    if (set != cudaSuccess) return set;
    attention_seg_bwd_tile_kernel<HD><<<L.gx, L.threads, L.smem, stream>>>(
        qkv, seg, out, gout, stat_m, stat_l, dqkv, W, d, H,
        tile::seg_score_floats(W), scale, dr);
    return cudaGetLastError();
  }
  if (L.instance == 3) {
    if (W <= SEG_TILE_MAX || delta == nullptr || L.pad != attn::LONG_T ||
        L.group != 1 || L.gx != R || L.gy != H ||
        L.gz != (W + attn::LONG_T - 1) / attn::LONG_T ||
        L.threads != attn::LONG_THREADS || L.smem != attn::long_dkv_bytes(HD))
      return cudaErrorInvalidValue;
    return attn::launch_long_bwd<HD>(
        attention_seg_bwd_dq_kernel<HD>, attention_seg_bwd_dkv_kernel<HD>,
        qkv, attn::SegTags{seg, seg}, out, gout, stat_m, stat_l, delta, dqkv,
        R, W, d, H, dr, stream);
  }
  return cudaErrorInvalidValue;
}

// The bf16 instances' launch, as attention_packed.py:seg_bf16_geometry
// computes it: code 1, the rows staged, a block of tile::SEG16_THREADS per
// (row, head), tile::seg16_bytes of shared memory.
bool seg16_launch_ok(const Launch& L, int R, int W, int H, bool bwd) {
  return W <= SEG_TILE_MAX && L.instance == 1 &&
         L.pad == tile::seg16_rows(W) && L.group == 1 &&
         (long)L.gx == (long)R * H && L.gy == 1 && L.gz == 1 &&
         L.threads == tile::SEG16_THREADS &&
         L.smem == tile::seg16_bytes(W, bwd) && L.smem <= tile::SMEM_MAX;
}

// Lets kernel k take up to `bytes` of dynamic shared memory, with the SM's
// carveout at its most shared (so that four blocks fit).
template <class Kernel>
cudaError_t allow_smem(Kernel k, int bytes) {
  const cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(k,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// Launches K2's bf16 forward or backward after checking the wrapper's
// seg_bf16_geometry (instance 1: rows of up to SEG_TILE_MAX on the tile
// bodies; 3: wider rows on the bf16 long bodies); the attributes of each
// kernel are set once, before its first launch.
template <bool DROP, bool STATS>
int launch_seg_fwd_bf16(const tile::bf16* qkv, const int* seg,
                        tile::bf16* out, float* stat_m, float* stat_l, int R,
                        int W, int d, int H, Dropout dr, const Launch& L,
                        cudaStream_t stream) {
  if (L.instance == 3) {
    if (W <= SEG_TILE_MAX || !attn::fwd16_launch_ok(L, R, W, H, true))
      return cudaErrorInvalidValue;
    const auto k = attention_seg_fwd_long_bf16_kernel<DROP, STATS>;
    static const cudaError_t set =
        allow_smem(k, attn::fwd16_bytes(W_MAX, true));
    if (set != cudaSuccess) return set;
    k<<<dim3(L.gx, L.gy, L.gz), L.threads, L.smem, stream>>>(
        qkv, seg, out, stat_m, stat_l, W, d, 1.f / sqrtf(32.f), dr);
    return cudaGetLastError();
  }
  if (!seg16_launch_ok(L, R, W, H, false)) return cudaErrorInvalidValue;
  const auto k = attention_seg_fwd_bf16_kernel<DROP, STATS>;
  static const cudaError_t set =
      allow_smem(k, tile::seg16_bytes(SEG_TILE_MAX, false));
  if (set != cudaSuccess) return set;
  k<<<L.gx, L.threads, L.smem, stream>>>(qkv, seg, out, stat_m, stat_l, W, d,
                                         H, 1.f / sqrtf(32.f), dr);
  return cudaGetLastError();
}

// The bf16 long pair on K2's rows of 129-384 (launch checked by the
// caller); the kernels' attributes are set once, before their first launch.
template <bool DROP>
int launch_seg_bwd_long16(const tile::bf16* qkv, const int* seg,
                          const tile::bf16* out, const tile::bf16* gout,
                          const float* stat_m, const float* stat_l,
                          float* rec, tile::bf16* dqkv, int W, int d,
                          Dropout dr, const Launch& L, cudaStream_t stream) {
  const auto dq = attention_seg_bwd_dq_bf16_kernel<DROP>;
  const auto dkv = attention_seg_bwd_dkv_bf16_kernel<DROP>;
  static const cudaError_t set = [&] {
    const cudaError_t e = allow_smem(dq, attn::bwd16_bytes(W_MAX, true));
    return e != cudaSuccess ? e
                            : allow_smem(dkv, attn::bwd16_bytes(W_MAX, true));
  }();
  if (set != cudaSuccess) return set;
  return attn::launch_long_bwd16<Dropout>(dq, dkv, qkv, seg, out, gout,
                                          stat_m, stat_l, rec, dqkv, W, d, L,
                                          dr, stream);
}

int launch_seg_bwd_bf16(const tile::bf16* qkv, const int* seg,
                        const tile::bf16* out, const tile::bf16* gout,
                        const float* stat_m, const float* stat_l,
                        float* delta, tile::bf16* dqkv, int R, int W, int d,
                        int H, Dropout dr, const Launch& L,
                        cudaStream_t stream) {
  if (L.instance == 3) {
    if (W <= SEG_TILE_MAX || delta == nullptr ||
        !attn::bwd16_launch_ok(L, R, W, H, true))
      return cudaErrorInvalidValue;
    return dr.on ? launch_seg_bwd_long16<true>(qkv, seg, out, gout, stat_m,
                                               stat_l, delta, dqkv, W, d, dr,
                                               L, stream)
                 : launch_seg_bwd_long16<false>(qkv, seg, out, gout, stat_m,
                                                stat_l, delta, dqkv, W, d, dr,
                                                L, stream);
  }
  if (!seg16_launch_ok(L, R, W, H, true)) return cudaErrorInvalidValue;
  static const cudaError_t set = allow_smem(
      attention_seg_bwd_bf16_kernel, tile::seg16_bytes(SEG_TILE_MAX, true));
  if (set != cudaSuccess) return set;
  attention_seg_bwd_bf16_kernel<<<L.gx, L.threads, L.smem, stream>>>(
      qkv, seg, gout, stat_m, stat_l, dqkv, W, d, H, 1.f / sqrtf(32.f), dr);
  return cudaGetLastError();
}

// ---- K4's bf16 instances -----------------------------------------------

constexpr int DENSE16_HD = 64;  // the head width K4's bf16 instances take

// Registers for four blocks an SM forward and three backward (up to 168 a
// thread, so that nothing spills; their shared memory allows seven and
// five).
template <bool DROP, bool STATS>
__global__ void __launch_bounds__(attn::LIST16_THREADS, 4)
attention_dense_fwd_bf16_kernel(const tile::bf16* __restrict__ qkv,
                                attn::PadTags tags, int span,
                                tile::bf16* __restrict__ out,
                                float* __restrict__ stat_m,
                                float* __restrict__ stat_l, int S, int d,
                                float scale, Dropout dr) {
  attn::l16::list_fwd16<DENSE16_HD, true, DROP, STATS>(
      qkv, tags, span, out, stat_m, stat_l, S, d, scale, dr);
}

template <bool DROP>
__global__ void __launch_bounds__(attn::LIST16_THREADS, 3)
attention_dense_bwd_dq_bf16_kernel(
    const tile::bf16* __restrict__ qkv, attn::PadTags tags, int span,
    const tile::bf16* __restrict__ out, const tile::bf16* __restrict__ gout,
    const float* __restrict__ stat_m, const float* __restrict__ stat_l,
    float* __restrict__ delta, tile::bf16* __restrict__ dqkv, int S, int d,
    float scale, Dropout dr) {
  attn::l16::list_dq16<DENSE16_HD, true, DROP>(qkv, tags, span, out, gout,
                                               stat_m, stat_l, delta, dqkv,
                                               S, d, scale, dr);
}

template <bool DROP>
__global__ void __launch_bounds__(attn::LIST16_THREADS, 3)
attention_dense_bwd_dkv_bf16_kernel(
    const tile::bf16* __restrict__ qkv, attn::PadTags tags, int span,
    const tile::bf16* __restrict__ gout, const float* __restrict__ stat_m,
    const float* __restrict__ stat_l, const float* __restrict__ delta,
    tile::bf16* __restrict__ dqkv, int S, int d, float scale, Dropout dr) {
  attn::l16::list_dkv16<DENSE16_HD, true, DROP>(qkv, tags, span, gout,
                                                stat_m, stat_l, delta, dqkv,
                                                S, d, scale, dr);
}

// K4-bwd's bf16 short instance: graph blocks of up to 64 tokens (the
// molecule paths' packed rows), the whole backward of a span in one block.
template <bool DROP>
__global__ void __launch_bounds__(attn::LIST16_THREADS, 3)
attention_dense_bwd_span_bf16_kernel(
    const tile::bf16* __restrict__ qkv, attn::PadTags tags, int span,
    const tile::bf16* __restrict__ out, const tile::bf16* __restrict__ gout,
    const float* __restrict__ stat_m, const float* __restrict__ stat_l,
    tile::bf16* __restrict__ dqkv, int S, int d, float scale, Dropout dr) {
  attn::l16::span_bwd16<DENSE16_HD, true, DROP>(
      qkv, tags, span, out, gout, stat_m, stat_l, dqkv, S, d, scale, dr);
}

// The span of K4's mask on rows of S tokens: the graph block, or the row.
int dense_span(int S, int block) { return block > 0 && block < S ? block : S; }

template <bool DROP, bool STATS>
int launch_dense_fwd_bf16(const tile::bf16* qkv, const unsigned char* valid,
                          tile::bf16* out, float* stat_m, float* stat_l, int B,
                          int S, int d, int H, int block, Dropout dr,
                          const Launch& L, cudaStream_t stream) {
  const int span = dense_span(S, block);
  if (!attn::list16_launch_ok(L, B, S, span, H, DENSE16_HD, false))
    return cudaErrorInvalidValue;
  const auto k = attention_dense_fwd_bf16_kernel<DROP, STATS>;
  static const cudaError_t set =
      allow_smem(k, attn::list16_bytes(DENSE16_HD, false));
  if (set != cudaSuccess) return set;
  k<<<dim3(L.gx, L.gy, L.gz), L.threads, L.smem, stream>>>(
      qkv, attn::PadTags{valid, block}, span, out, stat_m, stat_l, S, d,
      1.f / sqrtf((float)DENSE16_HD), dr);
  return cudaGetLastError();
}

template <bool DROP>
int launch_dense_bwd_bf16(const tile::bf16* qkv, const unsigned char* valid,
                          const tile::bf16* out, const tile::bf16* gout,
                          const float* stat_m, const float* stat_l,
                          float* delta, tile::bf16* dqkv, int B, int S, int d,
                          int H, int block, Dropout dr, const Launch& L,
                          cudaStream_t stream) {
  const int span = dense_span(S, block);
  if (!attn::list16_launch_ok(L, B, S, span, H, DENSE16_HD, true))
    return cudaErrorInvalidValue;
  const attn::PadTags tags{valid, block};
  const float scale = 1.f / sqrtf((float)DENSE16_HD);
  if (L.instance == 1) {  // spans of up to 64: one kernel
    const auto k = attention_dense_bwd_span_bf16_kernel<DROP>;
    static const cudaError_t set =
        allow_smem(k, attn::list16_bytes(DENSE16_HD, true));
    if (set != cudaSuccess) return set;
    k<<<dim3(L.gx, L.gy, L.gz), L.threads, L.smem, stream>>>(
        qkv, tags, span, out, gout, stat_m, stat_l, dqkv, S, d, scale, dr);
    return cudaGetLastError();
  }
  const auto dq = attention_dense_bwd_dq_bf16_kernel<DROP>;
  const auto dkv = attention_dense_bwd_dkv_bf16_kernel<DROP>;
  static const cudaError_t set = [&] {
    const cudaError_t e = allow_smem(dq, attn::list16_bytes(DENSE16_HD, true));
    return e != cudaSuccess
               ? e
               : allow_smem(dkv, attn::list16_bytes(DENSE16_HD, true));
  }();
  if (set != cudaSuccess) return set;
  return attn::launch_list_bwd16(dq, dkv, qkv, tags, span, out, gout, stat_m,
                                 stat_l, delta, dqkv, S, d, scale, dr, L,
                                 stream);
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

// K2 forward: seg [R, W] int32; heads of width 32; W <= 384. Returns
// cudaGetLastError() after the launch (0 = launched). drop = 0 is
// attention without dropout; otherwise (thresh, inv_keep, seed, bt, sp)
// define the keep mask as above (stride H). stat_m and stat_l ([R, W, H])
// may be null without dropout: the statistics are then not written
// (serving). The launch (instance, pad, group, grid, threads, smem) is the
// wrapper's seg_fwd_geometry; one that does not match (R, W, H) is refused.
extern "C" int attention_seg_fwd(const float* qkv, const int* seg, float* out,
                                 float* stat_m, float* stat_l, int R, int W,
                                 int d, int H, int drop, unsigned thresh,
                                 float inv_keep, int seed, int bt, int sp,
                                 int instance, int pad, int group, int gx,
                                 int gy, int gz, int threads, int smem,
                                 cudaStream_t stream) {
  if (R <= 0 || W <= 0 || W > W_MAX || H <= 0 || d != H * 32)
    return cudaErrorInvalidValue;
  if ((stat_m == nullptr) != (stat_l == nullptr)) return cudaErrorInvalidValue;
  if (drop && stat_m == nullptr) return cudaErrorInvalidValue;
  const Dropout dr = make_dropout(drop, thresh, inv_keep, seed, bt, sp, H);
  const Launch L{instance, pad, group, gx, gy, gz, threads, smem};
  if (dr.on)
    return launch_seg_fwd<32, true, true>(qkv, seg, out, stat_m, stat_l, R, W,
                                          d, H, dr, L, stream);
  if (stat_m)
    return launch_seg_fwd<32, false, true>(qkv, seg, out, stat_m, stat_l, R,
                                           W, d, H, dr, L, stream);
  return launch_seg_fwd<32, false, false>(qkv, seg, out, stat_m, stat_l, R, W,
                                          d, H, dr, L, stream);
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


// K4's bf16 instances (the bf16 step): qkv, out, gout and dqkv bf16, m and
// l float; heads of 64; the arguments as attention_dense_fwd's and
// attention_dense_bwd's, the backward with delta [B, S, H] as scratch
// (written by its dq kernel, read by its dk/dv kernel on the same stream).
// The launch is the wrapper's list16_geometry; one that does not match (B,
// S, block, H) is refused.
extern "C" int attention_dense_fwd_bf16(
    const tile::bf16* qkv, const unsigned char* valid, tile::bf16* out,
    float* stat_m, float* stat_l, int B, int S, int d, int H, int block,
    int drop, unsigned thresh, float inv_keep, int seed, int bt, int sp,
    int stride, int instance, int pad, int group, int gx, int gy, int gz,
    int threads, int smem, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || S > W_MAX || block < 0 || H <= 0 ||
      d != H * DENSE16_HD || stride < H)
    return cudaErrorInvalidValue;
  if ((stat_m == nullptr) != (stat_l == nullptr)) return cudaErrorInvalidValue;
  if (drop && stat_m == nullptr) return cudaErrorInvalidValue;
  const Dropout dr = make_dropout(drop, thresh, inv_keep, seed, bt, sp, stride);
  const Launch L{instance, pad, group, gx, gy, gz, threads, smem};
  if (dr.on)
    return launch_dense_fwd_bf16<true, true>(qkv, valid, out, stat_m, stat_l,
                                             B, S, d, H, block, dr, L, stream);
  if (stat_m)
    return launch_dense_fwd_bf16<false, true>(qkv, valid, out, stat_m, stat_l,
                                              B, S, d, H, block, dr, L,
                                              stream);
  return launch_dense_fwd_bf16<false, false>(qkv, valid, out, stat_m, stat_l,
                                             B, S, d, H, block, dr, L, stream);
}

extern "C" int attention_dense_bwd_bf16(
    const tile::bf16* qkv, const unsigned char* valid, const tile::bf16* out,
    const tile::bf16* gout, const float* stat_m, const float* stat_l,
    float* delta, tile::bf16* dqkv, int B, int S, int d, int H, int block,
    int drop, unsigned thresh, float inv_keep, int seed, int bt, int sp,
    int stride, int instance, int pad, int group, int gx, int gy, int gz,
    int threads, int smem, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || S > W_MAX || block < 0 || H <= 0 ||
      d != H * DENSE16_HD || stride < H || stat_m == nullptr ||
      stat_l == nullptr || delta == nullptr)
    return cudaErrorInvalidValue;
  const Dropout dr = make_dropout(drop, thresh, inv_keep, seed, bt, sp, stride);
  const Launch L{instance, pad, group, gx, gy, gz, threads, smem};
  return dr.on ? launch_dense_bwd_bf16<true>(qkv, valid, out, gout, stat_m,
                                             stat_l, delta, dqkv, B, S, d, H,
                                             block, dr, L, stream)
               : launch_dense_bwd_bf16<false>(qkv, valid, out, gout, stat_m,
                                              stat_l, delta, dqkv, B, S, d, H,
                                              block, dr, L, stream);
}

// K2 backward: dqkv [R, W, 3d] for the cotangent gout [R, W, d] of
// attention_seg_fwd's out, from its saved m and l, with K2's dropout
// (stride H). delta [R, W, H] is scratch for the long instance (written by
// its dq kernel, read by its dk/dv kernel on the same stream) and may be
// null for the tile instance. The launch is the wrapper's
// seg_bwd_geometry; one that does not match (R, W, H) is refused.
extern "C" int attention_seg_bwd(const float* qkv, const int* seg,
                                 const float* out, const float* gout,
                                 const float* stat_m, const float* stat_l,
                                 float* delta, float* dqkv, int R, int W,
                                 int d, int H, int drop, unsigned thresh,
                                 float inv_keep, int seed, int bt, int sp,
                                 int instance, int pad, int group, int gx,
                                 int gy, int gz, int threads, int smem,
                                 cudaStream_t stream) {
  if (R <= 0 || W <= 0 || W > W_MAX || H <= 0 || d != H * 32)
    return cudaErrorInvalidValue;
  const Dropout dr = make_dropout(drop, thresh, inv_keep, seed, bt, sp, H);
  const Launch L{instance, pad, group, gx, gy, gz, threads, smem};
  return launch_seg_bwd<32>(qkv, seg, out, gout, stat_m, stat_l, delta, dqkv,
                            R, W, d, H, dr, L, stream);
}

// K2's bf16 instances (the bf16 step): qkv, out, gout and dqkv bf16, m and
// l float; rows of up to 128 tokens take the tile instance, rows of
// 129-384 the long one (seg_bf16_geometry); the arguments as
// attention_seg_fwd's and attention_seg_bwd's (the backward reads no out:
// its delta is summed from the pairs; delta is the long pair's scratch,
// its records [R, H, W, 4] floats, null for the tile instance). A launch
// these cannot run is refused.
extern "C" int attention_seg_fwd_bf16(const tile::bf16* qkv, const int* seg,
                                      tile::bf16* out, float* stat_m,
                                      float* stat_l, int R, int W, int d,
                                      int H, int drop, unsigned thresh,
                                      float inv_keep, int seed, int bt,
                                      int sp, int instance, int pad,
                                      int group, int gx, int gy, int gz,
                                      int threads, int smem,
                                      cudaStream_t stream) {
  if (R <= 0 || W <= 0 || W > W_MAX || H <= 0 || d != H * 32)
    return cudaErrorInvalidValue;
  if ((stat_m == nullptr) != (stat_l == nullptr)) return cudaErrorInvalidValue;
  if (drop && stat_m == nullptr) return cudaErrorInvalidValue;
  const Dropout dr = make_dropout(drop, thresh, inv_keep, seed, bt, sp, H);
  const Launch L{instance, pad, group, gx, gy, gz, threads, smem};
  if (dr.on)
    return launch_seg_fwd_bf16<true, true>(qkv, seg, out, stat_m, stat_l, R, W,
                                           d, H, dr, L, stream);
  if (stat_m)
    return launch_seg_fwd_bf16<false, true>(qkv, seg, out, stat_m, stat_l, R, W,
                                            d, H, dr, L, stream);
  return launch_seg_fwd_bf16<false, false>(qkv, seg, out, stat_m, stat_l, R, W,
                                           d, H, dr, L, stream);
}

extern "C" int attention_seg_bwd_bf16(const tile::bf16* qkv, const int* seg,
                                      const tile::bf16* out,
                                      const tile::bf16* gout,
                                      const float* stat_m,
                                      const float* stat_l, float* delta,
                                      tile::bf16* dqkv, int R, int W, int d,
                                      int H, int drop, unsigned thresh,
                                      float inv_keep, int seed, int bt,
                                      int sp, int instance, int pad,
                                      int group, int gx, int gy, int gz,
                                      int threads, int smem,
                                      cudaStream_t stream) {
  if (R <= 0 || W <= 0 || W > W_MAX || H <= 0 || d != H * 32 ||
      stat_m == nullptr || stat_l == nullptr)
    return cudaErrorInvalidValue;
  const Dropout dr = make_dropout(drop, thresh, inv_keep, seed, bt, sp, H);
  const Launch L{instance, pad, group, gx, gy, gz, threads, smem};
  return launch_seg_bwd_bf16(qkv, seg, out, gout, stat_m, stat_l, delta, dqkv,
                             R, W, d, H, dr, L, stream);
}

// The residency of kernel k, which may take up to `most` shared bytes, at
// `smem` shared bytes a block: registers a thread, local memory a thread
// (spills), blocks an SM.
template <class Kernel>
int residency(Kernel k, int most, int smem, int* regs, int* local,
              int* blocks) {
  cudaError_t e = allow_smem(k, most);
  cudaFuncAttributes a;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, k);
  if (e != cudaSuccess) return e;
  *regs = a.numRegs;
  *local = (int)a.localSizeBytes;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, k, attn::LONG16_THREADS, smem);
}

// The residency of K2's bf16 long forward (its training launch, with
// dropout and statistics) at `smem` shared bytes a block.
extern "C" int attention_seg_fwd_long_bf16_residency(int smem, int* regs,
                                                     int* local,
                                                     int* blocks) {
  return residency(attention_seg_fwd_long_bf16_kernel<true, true>,
                   attn::fwd16_bytes(W_MAX, true), smem, regs, local, blocks);
}

// The residency of a kernel of K2's bf16 long pair at `smem` shared bytes a
// block: `which` 0 the dq kernel, 1 the dk/dv kernel, with dropout (the
// training launch); 2 and 3 the same without.
extern "C" int attention_seg_bwd_long_bf16_residency(int which, int smem,
                                                     int* regs, int* local,
                                                     int* blocks) {
  const int most = attn::bwd16_bytes(W_MAX, true);
  switch (which) {
    case 0:
      return residency(attention_seg_bwd_dq_bf16_kernel<true>, most, smem,
                       regs, local, blocks);
    case 1:
      return residency(attention_seg_bwd_dkv_bf16_kernel<true>, most, smem,
                       regs, local, blocks);
    case 2:
      return residency(attention_seg_bwd_dq_bf16_kernel<false>, most, smem,
                       regs, local, blocks);
    case 3:
      return residency(attention_seg_bwd_dkv_bf16_kernel<false>, most, smem,
                       regs, local, blocks);
  }
  return cudaErrorInvalidValue;
}

// The residency of a kernel of K4's bf16 instances (with dropout: the
// training launch) at `smem` shared bytes a block: `which` 0 the forward,
// 1 the dq kernel, 2 the dk/dv kernel, 3 the short backward's one kernel.
extern "C" int attention_dense_bf16_residency(int which, int smem, int* regs,
                                              int* local, int* blocks) {
  const int fb = attn::list16_bytes(DENSE16_HD, false);
  const int bb = attn::list16_bytes(DENSE16_HD, true);
  switch (which) {
    case 0:
      return residency(attention_dense_fwd_bf16_kernel<true, true>, fb, smem,
                       regs, local, blocks);
    case 1:
      return residency(attention_dense_bwd_dq_bf16_kernel<true>, bb, smem,
                       regs, local, blocks);
    case 2:
      return residency(attention_dense_bwd_dkv_bf16_kernel<true>, bb, smem,
                       regs, local, blocks);
    case 3:
      return residency(attention_dense_bwd_span_bf16_kernel<true>, bb, smem,
                       regs, local, blocks);
  }
  return cudaErrorInvalidValue;
}
