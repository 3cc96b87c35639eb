// K9: per-head attention with a key-padding mask and, with block > 0, a
// block-diagonal one, at any row width, with attention dropout; and its
// backward. Wrapper, plain version and design note:
// graphtrans_tpu_torch/ops/kernels/attention_smalls.py.
//
// qkv [B, S, 3d] (heads in lanes), valid [B, S] (torch's bool, one byte)
// -> out [B, S, d]. Key j is attendable by query i iff valid[j] and, with
// block > 0, i / block == j / block: K4's function (a padding query attends
// its block's valid keys; a query whose block has no valid key writes
// zeros), as the tags of attention_bwd.cuh's PadTags. The forward has two
// instances, picked by the span width (a graph block, or the row at block
// 0) in the wrapper's fwd_geometry: spans of up to 128 tokens (112 at hd
// 128, where shared memory runs out) take the whole-tile body of
// attention_tile.cuh (scores once, an exact two-pass softmax, O = P_drop V
// / l), wider ones the long-row body of attention_fwd.cuh (K5's: keys
// gathered by rank, products on the tensor cores in 3xTF32). The
// backward has three instances, picked by span width and head width in the
// wrapper's bwd_geometry, each reading either forward's m and l: spans of
// up to 64 tokens take attention_tile.cuh's short backward (whole spans,
// several a block), spans of up to 384 at hd 32 and 64 its wide one (64-token
// tiles, the span's dQ in shared memory), the rest (code2's rows of 513 and
// 1001; hd 128 above 64) the long-row pair of attention_bwd.cuh (K5's). Each
// instance is K9's own __global__ with K9's dropout schedule as the Keep
// policy.
//
// Dropout keeps (b, h, i, j) iff hash(pos, seed + p / ht) < thresh with
// p = b*H + h, ht = max(1, min(16, 4096 / S)) and pos = ((p % ht)*S + i)*S
// + j: the JAX kernel's per-program seeds over its tiles of ht (batch,
// head) pairs, hashed as its package's interpret mode hashes them. Forward,
// backward and the plain version draw the same mask; nothing is stored.
//
// The bf16 instances (the bf16 step of the Transformer-only model under
// --attn_backend smalls and packed_smalls, heads of 64) run the bf16
// key-list bodies of attention_list16.cuh, K4's bf16 instances' launch
// (list16_geometry: a block of four warps per (row, head, 64-token tile of
// a span), spans of up to 64 tokens backward in one kernel) with K9's
// rounding at precision DEFAULT (one bf16 MXU pass): p normalised, dropped
// and rounded before P V; the backward's delta summed from the pairs with
// the undropped p, dS = p (dp_drop - delta) rounded, and its products
// scaled after their sums. Every product is a bf16 mma.sync m16n8k16 with
// float32 sums; K9's mask under the split hash (SmallsKeep::Split).

#include <cuda_runtime.h>
#include <math.h>

#include "attention_bwd.cuh"
#include "attention_fwd.cuh"
#include "attention_list16.cuh"
#include "attention_tile.cuh"
#include "hash.cuh"

namespace {

using tile::Launch;

struct SmallsKeep {
  int on;            // 0: rate 0, the identity
  unsigned thresh;   // keep iff bits < thresh
  float inv_keep;    // 1 / (1 - rate)
  unsigned seed;
  unsigned ht;       // (batch, head) pairs a tile of the reference

  // keep (b, h, i, j); u32 arithmetic wraps as the reference's int32 does
  __device__ bool operator()(long b, int h, int H, int S, int i,
                             int j) const {
    const unsigned p = (unsigned)b * H + (unsigned)h;
    const unsigned pos = ((p % ht) * S + (unsigned)i) * S + (unsigned)j;
    return prng::hash_bits(pos, seed + p / ht) < thresh;
  }

  // The same mask with the hash input of (i, j) split as a query's part and
  // a key's, x(i, j) = at(i) + col(j) (mod 2^32), the (b, h) seed and tile
  // offset made once (the bf16 key-list bodies): keeps(at(i) + col(j)) ==
  // (*this)(b, h, H, S, i, j).
  struct Split {
    unsigned base, S, seeded, thresh;  // (p % ht) S S; (seed + p/ht) SEED_MUL
    __device__ unsigned at(unsigned i) const {  // i, j: tokens, >= 0
      return (base + i * S) * prng::POS_MUL + seeded;
    }
    __device__ unsigned col(unsigned j) const { return j * prng::POS_MUL; }
    __device__ bool keeps(unsigned x) const { return prng::mix(x) < thresh; }
  };
  __device__ Split split(long b, int h, int H, int S) const {
    const unsigned p = (unsigned)b * H + (unsigned)h, s = (unsigned)S;
    return Split{p % ht * s * s, s, (seed + p / ht) * prng::SEED_MUL, thresh};
  }
};

// Spans wider than the tile threshold (code2's rows of 513 and 1001): one
// block per (row, head, 64 queries).
template <int HD, bool DROP, bool STATS>
__global__ void __launch_bounds__(attn::LONG_FWD_THREADS,
                                  attn::long_fwd_blocks(HD))
attention_smalls_fwd_long_kernel(const float* __restrict__ qkv,
                                 attn::PadTags tags, float* __restrict__ out,
                                 float* __restrict__ stat_m,
                                 float* __restrict__ stat_l, int S, int d,
                                 float scale, SmallsKeep dr) {
  attn::long_fwd<HD, DROP, STATS>(qkv, tags, out, stat_m, stat_l, S, d, scale,
                                  dr);
}

// Spans of up to the tile threshold, `group` (row, span, head) a block.
template <int HD, bool DROP, bool STATS>
__global__ void __launch_bounds__(tile::THREADS)
attention_smalls_fwd_tile_kernel(const float* __restrict__ qkv,
                                 const unsigned char* __restrict__ valid,
                                 float* __restrict__ out,
                                 float* __restrict__ stat_m,
                                 float* __restrict__ stat_l, int B, int S,
                                 int d, int H, int block, int np, int group,
                                 float scale, SmallsKeep dr) {
  tile::fwd_short<HD, DROP, STATS>(qkv, valid, out, stat_m, stat_l, B, S, d,
                                   H, block, np, group, scale, dr);
}

// Checks the wrapper's launch (attention_smalls.py:fwd_geometry; forward
// instance 1 the tile body, 3 the long one; bwd_geometry's backward 1
// short, 2 wide, 3 long) against (B, S, H, block) and the card's limits,
// then launches the instance; each kernel's shared-memory attribute is
// raised once, before its first launch.
template <int HD, bool DROP, bool STATS>
int launch_instance(const float* qkv, const unsigned char* valid, float* out,
                    float* stat_m, float* stat_l, int B, int S, int d, int H,
                    int block, SmallsKeep dr, Launch L, cudaStream_t stream) {
  const float scale = 1.f / sqrtf((float)HD);
  if (L.instance == 1) {
    const tile::Spans sp = tile::spans_of(S, block);
    const int np = tile::round4(sp.width);
    const long problems = (long)B * sp.count * H;
    if (L.pad != np || np > 128 || L.group < 1 || L.threads < 32 ||
        L.threads > tile::THREADS || L.threads % 32 || L.gy != 1 ||
        L.gz != 1 || (long)L.gx != (problems + L.group - 1) / L.group ||
        L.smem != L.group * tile::fwd_floats(np, HD) * 4 ||
        L.smem > tile::SMEM_MAX)
      return cudaErrorInvalidValue;
    static const cudaError_t set = cudaFuncSetAttribute(
        attention_smalls_fwd_tile_kernel<HD, DROP, STATS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, tile::SMEM_MAX);
    if (set != cudaSuccess) return set;
    attention_smalls_fwd_tile_kernel<HD, DROP, STATS>
        <<<L.gx, L.threads, L.smem, stream>>>(qkv, valid, out, stat_m, stat_l,
                                              B, S, d, H, block, np, L.group,
                                              scale, dr);
    return cudaGetLastError();
  }
  if (L.instance == 3) {
    if (!attn::long_fwd_launch_ok(L, B, S, H, HD)) return cudaErrorInvalidValue;
    static const cudaError_t set = cudaFuncSetAttribute(
        attention_smalls_fwd_long_kernel<HD, DROP, STATS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        attn::long_fwd_bytes(HD));
    if (set != cudaSuccess) return set;
    attention_smalls_fwd_long_kernel<HD, DROP, STATS>
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
int launch_fwd(const float* qkv, const unsigned char* valid, float* out,
               float* stat_m, float* stat_l, int B, int S, int d, int H,
               int block, SmallsKeep dr, Launch L, cudaStream_t stream) {
  if (dr.on)
    return launch_instance<HD, true, true>(qkv, valid, out, stat_m, stat_l,
                                           B, S, d, H, block, dr, L, stream);
  if (stat_m)
    return launch_instance<HD, false, true>(qkv, valid, out, stat_m, stat_l,
                                            B, S, d, H, block, dr, L, stream);
  return launch_instance<HD, false, false>(qkv, valid, out, stat_m, stat_l,
                                           B, S, d, H, block, dr, L, stream);
}

// The backward's instances: spans of up to tile::SHORT_MAX tokens, `group`
// a block; wider spans of up to WIDE_MAX, one a block; and the long-row
// pair (dq, then dk/dv).
template <int HD>
__global__ void __launch_bounds__(tile::THREADS)
attention_smalls_bwd_short_kernel(
    const float* __restrict__ qkv, const unsigned char* __restrict__ valid,
    const float* __restrict__ out, const float* __restrict__ gout,
    const float* __restrict__ stat_m, const float* __restrict__ stat_l,
    float* __restrict__ dqkv, int B, int S, int d, int H, int block, int np,
    int group, float scale, SmallsKeep dr) {
  tile::bwd_short<HD>(qkv, valid, out, gout, stat_m, stat_l, dqkv, B, S, d,
                      H, block, np, group, scale, dr);
}

template <int HD>
__global__ void __launch_bounds__(tile::THREADS)
attention_smalls_bwd_wide_kernel(
    const float* __restrict__ qkv, const unsigned char* __restrict__ valid,
    const float* __restrict__ out, const float* __restrict__ gout,
    const float* __restrict__ stat_m, const float* __restrict__ stat_l,
    float* __restrict__ dqkv, int S, int d, int H, int block, int npad,
    float scale, SmallsKeep dr) {
  tile::bwd_wide<HD>(qkv, valid, out, gout, stat_m, stat_l, dqkv, S, d, H,
                     block, npad, scale, dr);
}

template <int HD>
__global__ void __launch_bounds__(attn::LONG_THREADS, attn::long_blocks(HD))
attention_smalls_bwd_dq_kernel(const float* __restrict__ qkv,
                               attn::PadTags tags,
                               const float* __restrict__ out,
                               const float* __restrict__ gout,
                               const float* __restrict__ stat_m,
                               const float* __restrict__ stat_l,
                               float* __restrict__ delta,
                               float* __restrict__ dqkv, int S, int d,
                               float scale, SmallsKeep dr) {
  attn::lr::long_dq<HD>(qkv, tags, out, gout, stat_m, stat_l, delta, dqkv, S,
                        d, scale, dr);
}

template <int HD>
__global__ void __launch_bounds__(attn::LONG_THREADS, attn::long_blocks(HD))
attention_smalls_bwd_dkv_kernel(const float* __restrict__ qkv,
                                attn::PadTags tags,
                                const float* __restrict__ gout,
                                const float* __restrict__ stat_m,
                                const float* __restrict__ stat_l,
                                const float* __restrict__ delta,
                                float* __restrict__ dqkv, int S, int d,
                                float scale, SmallsKeep dr) {
  attn::lr::long_dkv<HD>(qkv, tags, gout, stat_m, stat_l, delta, dqkv, S, d,
                         scale, dr);
}

constexpr int WIDE_MAX = 384;  // the widest span of the wide backward

// Checks the wrapper's bwd_geometry against (B, S, H, block, HD) and the
// card's limits, then launches the instance (1 short, 2 wide, 3 long); the
// tile kernels' shared-memory attribute is raised once, before their first
// launch. Only the long instance reads delta (scratch [B, S, H]).
template <int HD>
int launch_bwd(const float* qkv, const unsigned char* valid, const float* out,
               const float* gout, const float* stat_m, const float* stat_l,
               float* delta, float* dqkv, int B, int S, int d, int H,
               int block, SmallsKeep dr, Launch L, cudaStream_t stream) {
  const tile::Spans sp = tile::spans_of(S, block);
  const long problems = (long)B * sp.count * H;
  const float scale = 1.f / sqrtf((float)HD);
  if (L.instance == 1) {
    const int np = tile::round4(sp.width);
    if (sp.width > tile::SHORT_MAX || L.pad != np || L.group < 1 ||
        L.threads < 32 || L.threads > tile::THREADS || L.threads % 32 ||
        L.gy != 1 || L.gz != 1 ||
        (long)L.gx != (problems + L.group - 1) / L.group ||
        L.smem != L.group * tile::bwd_short_floats(np, HD) * 4 ||
        L.smem > tile::SMEM_MAX)
      return cudaErrorInvalidValue;
    static const cudaError_t set = cudaFuncSetAttribute(
        attention_smalls_bwd_short_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, tile::SMEM_MAX);
    if (set != cudaSuccess) return set;
    attention_smalls_bwd_short_kernel<HD><<<L.gx, L.threads, L.smem,
                                            stream>>>(
        qkv, valid, out, gout, stat_m, stat_l, dqkv, B, S, d, H, block, np,
        L.group, scale, dr);
    return cudaGetLastError();
  }
  if (L.instance == 2) {
    if constexpr (HD > 64) {
      return cudaErrorInvalidValue;  // bwd_wide's tiles fit no wider head
    } else {
      const int npad = (sp.width + tile::WIDE - 1) / tile::WIDE * tile::WIDE;
      if (sp.width <= tile::SHORT_MAX || sp.width > WIDE_MAX ||
          L.pad != tile::WIDE || L.group != 1 || L.threads != tile::THREADS ||
          L.gy != 1 || L.gz != 1 || (long)L.gx != problems ||
          L.smem != tile::bwd_wide_floats(npad, HD) * 4 ||
          L.smem > tile::SMEM_MAX)
        return cudaErrorInvalidValue;
      static const cudaError_t set = cudaFuncSetAttribute(
          attention_smalls_bwd_wide_kernel<HD>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, tile::SMEM_MAX);
      if (set != cudaSuccess) return set;
      attention_smalls_bwd_wide_kernel<HD><<<L.gx, L.threads, L.smem,
                                             stream>>>(
          qkv, valid, out, gout, stat_m, stat_l, dqkv, S, d, H, block, npad,
          scale, dr);
      return cudaGetLastError();
    }
  }
  if (L.instance == 3) {
    if (delta == nullptr || L.pad != attn::LONG_T || L.group != 1 ||
        L.gx != B || L.gy != H ||
        L.gz != (S + attn::LONG_T - 1) / attn::LONG_T ||
        L.threads != attn::LONG_THREADS || L.smem != attn::long_dkv_bytes(HD))
      return cudaErrorInvalidValue;
    return attn::launch_long_bwd<HD>(
        attention_smalls_bwd_dq_kernel<HD>,
        attention_smalls_bwd_dkv_kernel<HD>, qkv,
        attn::PadTags{valid, block}, out, gout, stat_m, stat_l, delta, dqkv,
        B, S, d, H, dr, stream);
  }
  return cudaErrorInvalidValue;
}

// ---- the bf16 instances ---------------------------------------------------

constexpr int HD16 = 64;  // the head width K9's bf16 instances take

// K9 in bf16 on the key-list bodies of attention_list16.cuh under K4's tags
// (PadTags) with K9's rounding: NORM forward (p normalised, dropped and
// rounded before P V); backward delta from the pairs, dS rounded before its
// products, which are scaled after their sums (PAIRS without PRE).
// Registers for four blocks an SM forward and three backward, as K4's.
template <bool DROP, bool STATS>
__global__ void __launch_bounds__(attn::LIST16_THREADS, 4)
attention_smalls_fwd_bf16_kernel(const tile::bf16* __restrict__ qkv,
                                 attn::PadTags tags, int span,
                                 tile::bf16* __restrict__ out,
                                 float* __restrict__ stat_m,
                                 float* __restrict__ stat_l, int S, int d,
                                 float scale, SmallsKeep dr) {
  attn::l16::list_fwd16<HD16, true, DROP, STATS>(qkv, tags, span, out, stat_m,
                                                 stat_l, S, d, scale, dr);
}

template <bool DROP>
__global__ void __launch_bounds__(attn::LIST16_THREADS, 3)
attention_smalls_bwd_dq_bf16_kernel(
    const tile::bf16* __restrict__ qkv, attn::PadTags tags, int span,
    const tile::bf16* __restrict__ out, const tile::bf16* __restrict__ gout,
    const float* __restrict__ stat_m, const float* __restrict__ stat_l,
    float* __restrict__ delta, tile::bf16* __restrict__ dqkv, int S, int d,
    float scale, SmallsKeep dr) {
  attn::l16::list_dq16<HD16, true, false, DROP>(qkv, tags, span, out, gout,
                                                stat_m, stat_l, delta, dqkv,
                                                S, d, scale, dr);
}

template <bool DROP>
__global__ void __launch_bounds__(attn::LIST16_THREADS, 3)
attention_smalls_bwd_dkv_bf16_kernel(
    const tile::bf16* __restrict__ qkv, attn::PadTags tags, int span,
    const tile::bf16* __restrict__ gout, const float* __restrict__ stat_m,
    const float* __restrict__ stat_l, const float* __restrict__ delta,
    tile::bf16* __restrict__ dqkv, int S, int d, float scale, SmallsKeep dr) {
  attn::l16::list_dkv16<HD16, true, false, DROP>(qkv, tags, span, gout,
                                                 stat_m, stat_l, delta, dqkv,
                                                 S, d, scale, dr);
}

// K9-bwd's bf16 short instance: spans of up to 64 tokens (the molecule
// paths' rows and graph blocks), the whole backward of a span in one block.
template <bool DROP>
__global__ void __launch_bounds__(attn::LIST16_THREADS, 3)
attention_smalls_bwd_span_bf16_kernel(
    const tile::bf16* __restrict__ qkv, attn::PadTags tags, int span,
    const tile::bf16* __restrict__ out, const tile::bf16* __restrict__ gout,
    const float* __restrict__ stat_m, const float* __restrict__ stat_l,
    tile::bf16* __restrict__ dqkv, int S, int d, float scale, SmallsKeep dr) {
  attn::l16::span_bwd16<HD16, true, false, DROP>(
      qkv, tags, span, out, gout, stat_m, stat_l, dqkv, S, d, scale, dr);
}

template <class Kernel>
cudaError_t allow_smem(Kernel k, int bytes) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// The span of K9's mask on rows of S tokens: the graph block, or the row.
int span_of(int S, int block) { return block > 0 && block < S ? block : S; }

template <bool DROP, bool STATS>
int launch_fwd_bf16(const tile::bf16* qkv, const unsigned char* valid,
                    tile::bf16* out, float* stat_m, float* stat_l, int B,
                    int S, int d, int H, int block, SmallsKeep dr,
                    const Launch& L, cudaStream_t stream) {
  const int span = span_of(S, block);
  if (!attn::list16_launch_ok(L, B, S, span, H, HD16, false))
    return cudaErrorInvalidValue;
  const auto k = attention_smalls_fwd_bf16_kernel<DROP, STATS>;
  static const cudaError_t set = allow_smem(k, attn::list16_bytes(HD16, false));
  if (set != cudaSuccess) return set;
  k<<<dim3(L.gx, L.gy, L.gz), L.threads, L.smem, stream>>>(
      qkv, attn::PadTags{valid, block}, span, out, stat_m, stat_l, S, d,
      1.f / sqrtf((float)HD16), dr);
  return cudaGetLastError();
}

// The wrapper's list16_geometry: instance 1 (spans of up to 64 tokens, one
// kernel) or 3 (the dq, then the dk/dv kernel; delta passes between them).
template <bool DROP>
int launch_bwd_bf16(const tile::bf16* qkv, const unsigned char* valid,
                    const tile::bf16* out, const tile::bf16* gout,
                    const float* stat_m, const float* stat_l, float* delta,
                    tile::bf16* dqkv, int B, int S, int d, int H, int block,
                    SmallsKeep dr, const Launch& L, cudaStream_t stream) {
  const int span = span_of(S, block);
  if (!attn::list16_launch_ok(L, B, S, span, H, HD16, true))
    return cudaErrorInvalidValue;
  const attn::PadTags tags{valid, block};
  const float scale = 1.f / sqrtf((float)HD16);
  const int bytes = attn::list16_bytes(HD16, true);
  if (L.instance == 1) {
    const auto k = attention_smalls_bwd_span_bf16_kernel<DROP>;
    static const cudaError_t set = allow_smem(k, bytes);
    if (set != cudaSuccess) return set;
    k<<<dim3(L.gx, L.gy, L.gz), L.threads, L.smem, stream>>>(
        qkv, tags, span, out, gout, stat_m, stat_l, dqkv, S, d, scale, dr);
    return cudaGetLastError();
  }
  if (delta == nullptr) return cudaErrorInvalidValue;
  const auto dq = attention_smalls_bwd_dq_bf16_kernel<DROP>;
  const auto dkv = attention_smalls_bwd_dkv_bf16_kernel<DROP>;
  static const cudaError_t set = [&] {
    const cudaError_t e = allow_smem(dq, bytes);
    return e != cudaSuccess ? e : allow_smem(dkv, bytes);
  }();
  if (set != cudaSuccess) return set;
  return attn::launch_list_bwd16(dq, dkv, qkv, tags, span, out, gout, stat_m,
                                 stat_l, delta, dqkv, S, d, scale, dr, L,
                                 stream);
}

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
      blocks, k, attn::LIST16_THREADS, smem);
}

SmallsKeep make_keep(int on, unsigned thresh, float inv_keep, int seed,
                     int S) {
  SmallsKeep dr;
  dr.on = on;
  dr.thresh = thresh;
  dr.inv_keep = inv_keep;
  dr.seed = (unsigned)seed;
  const int ht = 4096 / S;
  dr.ht = (unsigned)(ht < 1 ? 1 : (ht > 16 ? 16 : ht));
  return dr;
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Returns cudaGetLastError() after the launch (0 = launched). Heads of
// width 32, 64 or 128; any S. drop = 0 is attention without dropout;
// otherwise (thresh, inv_keep, seed) define the keep mask as above. stat_m
// and stat_l ([B, S, H]) may be null without dropout: the softmax
// statistics are then not written (serving). The launch (instance, pad,
// group, grid, threads, smem) is the wrapper's fwd_geometry; one that does
// not match the shapes is refused.
extern "C" int attention_smalls_fwd(const float* qkv,
                                    const unsigned char* valid, float* out,
                                    float* stat_m, float* stat_l, int B,
                                    int S, int d, int H, int block, int drop,
                                    unsigned thresh, float inv_keep, int seed,
                                    int instance, int pad, int group, int gx,
                                    int gy, int gz, int threads, int smem,
                                    cudaStream_t stream) {
  if (B <= 0 || S <= 0 || H <= 0 || d % H || block < 0)
    return cudaErrorInvalidValue;
  if ((stat_m == nullptr) != (stat_l == nullptr)) return cudaErrorInvalidValue;
  if (drop && stat_m == nullptr) return cudaErrorInvalidValue;
  const SmallsKeep dr = make_keep(drop, thresh, inv_keep, seed, S);
  const Launch L{instance, pad, group, gx, gy, gz, threads, smem};
  switch (d / H) {
    case 32:
      return launch_fwd<32>(qkv, valid, out, stat_m, stat_l, B, S, d, H,
                            block, dr, L, stream);
    case 64:
      return launch_fwd<64>(qkv, valid, out, stat_m, stat_l, B, S, d, H,
                            block, dr, L, stream);
    case 128:
      return launch_fwd<128>(qkv, valid, out, stat_m, stat_l, B, S, d, H,
                             block, dr, L, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// dqkv [B, S, 3d] for the cotangent gout [B, S, d] of attention_smalls_fwd's
// out, from its saved m and l. The launch (instance, pad, group, grid,
// threads, smem) is the wrapper's bwd_geometry; one that does not match the
// shapes is refused. delta [B, S, H] is scratch for the long instance
// (written by its dq kernel, read by its dk/dv kernel on the same stream)
// and may be null for the others.
extern "C" int attention_smalls_bwd(const float* qkv,
                                    const unsigned char* valid,
                                    const float* out, const float* gout,
                                    const float* stat_m, const float* stat_l,
                                    float* delta, float* dqkv, int B, int S,
                                    int d, int H, int block, int drop,
                                    unsigned thresh, float inv_keep, int seed,
                                    int instance, int pad, int group, int gx,
                                    int gy, int gz, int threads, int smem,
                                    cudaStream_t stream) {
  if (B <= 0 || S <= 0 || H <= 0 || d % H || block < 0)
    return cudaErrorInvalidValue;
  const SmallsKeep dr = make_keep(drop, thresh, inv_keep, seed, S);
  const Launch L{instance, pad, group, gx, gy, gz, threads, smem};
  switch (d / H) {
    case 32:
      return launch_bwd<32>(qkv, valid, out, gout, stat_m, stat_l, delta,
                            dqkv, B, S, d, H, block, dr, L, stream);
    case 64:
      return launch_bwd<64>(qkv, valid, out, gout, stat_m, stat_l, delta,
                            dqkv, B, S, d, H, block, dr, L, stream);
    case 128:
      return launch_bwd<128>(qkv, valid, out, gout, stat_m, stat_l, delta,
                             dqkv, B, S, d, H, block, dr, L, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// K9's bf16 instances (the bf16 step, heads of 64): qkv, out, gout and dqkv
// bf16, m, l and delta float; the arguments as attention_smalls_fwd's and
// attention_smalls_bwd's. The launch is the wrapper's list16_geometry (the
// forward's instance 1 for spans of up to 128 tokens, 3 above, one body;
// the backward's 1 for spans of up to 64, one kernel, 3 above, the pair,
// which needs delta); one that does not match is refused.
extern "C" int attention_smalls_fwd_bf16(
    const tile::bf16* qkv, const unsigned char* valid, tile::bf16* out,
    float* stat_m, float* stat_l, int B, int S, int d, int H, int block,
    int drop, unsigned thresh, float inv_keep, int seed, int instance,
    int pad, int group, int gx, int gy, int gz, int threads, int smem,
    cudaStream_t stream) {
  if (B <= 0 || S <= 0 || H <= 0 || d != H * HD16 || block < 0)
    return cudaErrorInvalidValue;
  if ((stat_m == nullptr) != (stat_l == nullptr)) return cudaErrorInvalidValue;
  if (drop && stat_m == nullptr) return cudaErrorInvalidValue;
  const SmallsKeep dr = make_keep(drop, thresh, inv_keep, seed, S);
  const Launch L{instance, pad, group, gx, gy, gz, threads, smem};
  if (dr.on)
    return launch_fwd_bf16<true, true>(qkv, valid, out, stat_m, stat_l, B, S,
                                       d, H, block, dr, L, stream);
  if (stat_m)
    return launch_fwd_bf16<false, true>(qkv, valid, out, stat_m, stat_l, B, S,
                                        d, H, block, dr, L, stream);
  return launch_fwd_bf16<false, false>(qkv, valid, out, stat_m, stat_l, B, S,
                                       d, H, block, dr, L, stream);
}

extern "C" int attention_smalls_bwd_bf16(
    const tile::bf16* qkv, const unsigned char* valid, const tile::bf16* out,
    const tile::bf16* gout, const float* stat_m, const float* stat_l,
    float* delta, tile::bf16* dqkv, int B, int S, int d, int H, int block,
    int drop, unsigned thresh, float inv_keep, int seed, int instance,
    int pad, int group, int gx, int gy, int gz, int threads, int smem,
    cudaStream_t stream) {
  if (B <= 0 || S <= 0 || H <= 0 || d != H * HD16 || block < 0 ||
      stat_m == nullptr || stat_l == nullptr)
    return cudaErrorInvalidValue;
  const SmallsKeep dr = make_keep(drop, thresh, inv_keep, seed, S);
  const Launch L{instance, pad, group, gx, gy, gz, threads, smem};
  return dr.on ? launch_bwd_bf16<true>(qkv, valid, out, gout, stat_m, stat_l,
                                       delta, dqkv, B, S, d, H, block, dr, L,
                                       stream)
               : launch_bwd_bf16<false>(qkv, valid, out, gout, stat_m, stat_l,
                                        delta, dqkv, B, S, d, H, block, dr, L,
                                        stream);
}

// The residency of a kernel of K9's bf16 instances (with dropout: the
// training launch) at `smem` shared bytes a block: `which` 0 the forward,
// 1 the dq kernel, 2 the dk/dv kernel, 3 the short backward.
extern "C" int attention_smalls_bf16_residency(int which, int smem, int* regs,
                                               int* local, int* blocks) {
  const int fb = attn::list16_bytes(HD16, false);
  const int bb = attn::list16_bytes(HD16, true);
  switch (which) {
    case 0:
      return residency(attention_smalls_fwd_bf16_kernel<true, true>, fb, smem,
                       regs, local, blocks);
    case 1:
      return residency(attention_smalls_bwd_dq_bf16_kernel<true>, bb, smem,
                       regs, local, blocks);
    case 2:
      return residency(attention_smalls_bwd_dkv_bf16_kernel<true>, bb, smem,
                       regs, local, blocks);
    case 3:
      return residency(attention_smalls_bwd_span_bf16_kernel<true>, bb, smem,
                       regs, local, blocks);
  }
  return cudaErrorInvalidValue;
}
