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

#include <cuda_runtime.h>
#include <math.h>

#include "attention_bwd.cuh"
#include "attention_fwd.cuh"
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
