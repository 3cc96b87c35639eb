// K5: attention over long unpacked rows with a key-padding or segment mask,
// walking the keys in gathered tiles with an online softmax, with attention
// dropout; and its backward. Wrapper, plain version and design note:
// graphtrans_tpu_torch/ops/kernels/flash_attention.py.
//
// qkv [B, S, 3d] (heads in lanes), segq, segk [B, S] int32 -> out [B, S, d].
// Query i attends key j iff segq[i] == segk[j] >= 0 (the key-padding form
// is segq = 0, segk = valid ? 0 : -1); scale 1/sqrt(hd); the output is
// normalised by max(l, 1e-16), so a query with no key writes exact zeros.
// The forward is the long-row body of attention_fwd.cuh (shared with K9's
// long instance and K4's wide spans) under K5's own kernel: one block of
// four warps per (row, head, 64 queries) walks only the keys whose tags
// meet its queries', gathered 64 at a time by rank and staged in shared
// memory with cp.async; each warp keeps 16 query rows whole in registers,
// S = Q K^T and O += P_drop V as 3xTF32 mma.sync on the tensor cores, the
// online softmax between them. The wrapper (attention_packed.py:
// long_fwd_geometry) computes the launch; the entry checks it before
// launching.
//
// Dropout (torch semantics: l sums the undropped probabilities; a kept one
// is scaled by 1/(1-rate)) keeps (b, h, i, j) iff hash(pos, s) < thresh
// with s = seed + ((b*H + h)*16384 + i/256)*1024 + j/256 and pos =
// (i%256)*256 + j%256: the JAX kernel's per-(q-block, k-block) seeds at its
// BQ = BK = 256, hashed as its interpret mode hashes them. Forward,
// backward and the plain version draw the same mask; nothing is stored.
// Where a gradient is wanted the forward also writes m and l per (row,
// query, head). The backward is the long-row pair of attention_bwd.cuh
// (a dq kernel over 64-query tiles, which also writes delta = dO . O; then
// a dk/dv kernel over chunks of 64 valid keys, both on 64 x 64 pair tiles
// in shared memory with their products as 3xTF32 mma.sync on the tensor
// cores) under K5's own kernels, with segq and segk as its tags.
//
// The bf16 instances (the bf16 step of the Transformer-only model, heads of
// 64) run the bf16 key-list bodies of attention_list16.cuh with segq and
// segk as their tags and the JAX kernel's rounding at precision None (one
// bf16 MXU pass): the online softmax's unnormalised p rounded before P V,
// delta = dO . O over the rounded output, dS rounded and its products
// scaled after their sums. A block of four warps per (row, head, 64
// queries) walks the keys whose tags meet its queries', gathered 64 at a
// time by rank; the backward's dk/dv kernel takes a chunk of 64 valid keys
// by rank. Every product is a bf16 mma.sync m16n8k16 with float32 sums.

#include <cuda_runtime.h>
#include <math.h>

#include "attention_bwd.cuh"
#include "attention_fwd.cuh"
#include "attention_list16.cuh"
#include "hash.cuh"

namespace {

constexpr int MASK_TILE = 256;  // the JAX kernel's BQ = BK, which seed its mask

struct Dropout {
  int on;            // 0: rate 0, the identity
  unsigned thresh;   // keep iff bits < thresh
  float inv_keep;    // 1 / (1 - rate)
  unsigned seed;

  // keep (b, h, i, j); u32 arithmetic wraps as the reference's int32 does
  __device__ bool operator()(long b, int h, int H, int, int i, int j) const {
    const unsigned bh = (unsigned)b * H + (unsigned)h;
    const unsigned s = seed + (bh * 16384u + (unsigned)(i / MASK_TILE)) *
                                  1024u +
                       (unsigned)(j / MASK_TILE);
    const unsigned pos = (unsigned)(i % MASK_TILE) * MASK_TILE +
                         (unsigned)(j % MASK_TILE);
    return prng::hash_bits(pos, s) < thresh;
  }

  // The same mask with the hash input of (i, j) split as a query's part and
  // a key's, x(i, j) = at(i) + col(j) (mod 2^32), the (b, h) seed made once
  // (the bf16 key-list bodies): keeps(at(i) + col(j)) == (*this)(b, h, H,
  // S, i, j).
  struct Split {
    unsigned base, thresh;  // seed + (b H + h) * 16384 * 1024
    __device__ unsigned at(unsigned i) const {  // i, j: tokens, >= 0
      return i % MASK_TILE * MASK_TILE * prng::POS_MUL +
             (base + i / MASK_TILE * 1024u) * prng::SEED_MUL;
    }
    __device__ unsigned col(unsigned j) const {
      return j % MASK_TILE * prng::POS_MUL + j / MASK_TILE * prng::SEED_MUL;
    }
    __device__ bool keeps(unsigned x) const { return prng::mix(x) < thresh; }
  };
  __device__ Split split(long b, int h, int H, int) const {
    const unsigned bh = (unsigned)b * H + (unsigned)h;
    return Split{seed + bh * 16384u * 1024u, thresh};
  }
};

// K5's own kernel over the long-row body of attention_fwd.cuh, with segq and
// segk as its tags. DROP and STATS are compile-time, so the serving launch
// (neither) runs the loop of a kernel without dropout and writes no
// statistics.
template <int HD, bool DROP, bool STATS>
__global__ void __launch_bounds__(attn::LONG_FWD_THREADS,
                                  attn::long_fwd_blocks(HD))
flash_attention_fwd_kernel(const float* __restrict__ qkv, attn::SegTags tags,
                           float* __restrict__ out, float* __restrict__ stat_m,
                           float* __restrict__ stat_l, int S, int d,
                           float scale, Dropout dr) {
  attn::long_fwd<HD, DROP, STATS>(qkv, tags, out, stat_m, stat_l, S, d, scale,
                                  dr);
}

// Checks the wrapper's launch (tile::Launch, instance 3: the long body)
// against (B, S, H, HD), then launches; the shared-memory attribute is
// raised once, before the instance's first launch.
template <int HD, bool DROP, bool STATS>
int launch_instance(const float* qkv, attn::SegTags tags, float* out,
                    float* stat_m, float* stat_l, int B, int S, int d, int H,
                    Dropout dr, const tile::Launch& L, cudaStream_t stream) {
  if (L.instance != 3 || !attn::long_fwd_launch_ok(L, B, S, H, HD))
    return cudaErrorInvalidValue;
  static const cudaError_t set = cudaFuncSetAttribute(
      flash_attention_fwd_kernel<HD, DROP, STATS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, attn::long_fwd_bytes(HD));
  if (set != cudaSuccess) return set;
  flash_attention_fwd_kernel<HD, DROP, STATS>
      <<<dim3(L.gx, L.gy, L.gz), L.threads, L.smem, stream>>>(
          qkv, tags, out, stat_m, stat_l, S, d, 1.f / sqrtf((float)HD), dr);
  return cudaGetLastError();
}

// The serving instance (no dropout, no statistics), the gradient instance
// without dropout, and the training one (dropout always saves statistics).
template <int HD>
int launch_fwd(const float* qkv, attn::SegTags tags, float* out,
               float* stat_m, float* stat_l, int B, int S, int d, int H,
               Dropout dr, const tile::Launch& L, cudaStream_t stream) {
  if (dr.on)
    return launch_instance<HD, true, true>(qkv, tags, out, stat_m, stat_l, B,
                                           S, d, H, dr, L, stream);
  if (stat_m)
    return launch_instance<HD, false, true>(qkv, tags, out, stat_m, stat_l, B,
                                            S, d, H, dr, L, stream);
  return launch_instance<HD, false, false>(qkv, tags, out, stat_m, stat_l, B,
                                           S, d, H, dr, L, stream);
}

// K5's backward kernels over the long-row bodies of attention_bwd.cuh.
template <int HD>
__global__ void __launch_bounds__(attn::LONG_THREADS, attn::long_blocks(HD))
flash_attention_bwd_dq_kernel(const float* __restrict__ qkv,
                              attn::SegTags tags, const float* __restrict__ out,
                              const float* __restrict__ gout,
                              const float* __restrict__ stat_m,
                              const float* __restrict__ stat_l,
                              float* __restrict__ delta,
                              float* __restrict__ dqkv, int S, int d,
                              float scale, Dropout dr) {
  attn::lr::long_dq<HD>(qkv, tags, out, gout, stat_m, stat_l, delta, dqkv, S,
                        d, scale, dr);
}

template <int HD>
__global__ void __launch_bounds__(attn::LONG_THREADS, attn::long_blocks(HD))
flash_attention_bwd_dkv_kernel(const float* __restrict__ qkv,
                               attn::SegTags tags,
                               const float* __restrict__ gout,
                               const float* __restrict__ stat_m,
                               const float* __restrict__ stat_l,
                               const float* __restrict__ delta,
                               float* __restrict__ dqkv, int S, int d,
                               float scale, Dropout dr) {
  attn::lr::long_dkv<HD>(qkv, tags, gout, stat_m, stat_l, delta, dqkv, S, d,
                         scale, dr);
}

template <int HD>
int launch_bwd(const float* qkv, attn::SegTags tags, const float* out,
               const float* gout, const float* stat_m, const float* stat_l,
               float* delta, float* dqkv, int B, int S, int d, int H,
               Dropout dr, cudaStream_t stream) {
  return attn::launch_long_bwd<HD>(
      flash_attention_bwd_dq_kernel<HD>, flash_attention_bwd_dkv_kernel<HD>,
      qkv, tags, out, gout, stat_m, stat_l, delta, dqkv, B, S, d, H, dr,
      stream);
}

// ---- the bf16 instances ---------------------------------------------------

constexpr int HD16 = 64;  // the head width the bf16 instances take

// Registers for four blocks an SM forward and three backward (up to 168 a
// thread, so that nothing spills; their shared memory allows seven and
// five).
template <bool DROP, bool STATS>
__global__ void __launch_bounds__(attn::LIST16_THREADS, 4)
flash_attention_fwd_bf16_kernel(const tile::bf16* __restrict__ qkv,
                                attn::SegTags tags, int span,
                                tile::bf16* __restrict__ out,
                                float* __restrict__ stat_m,
                                float* __restrict__ stat_l, int S, int d,
                                float scale, Dropout dr) {
  attn::l16::list_fwd16<HD16, false, DROP, STATS>(qkv, tags, span, out, stat_m,
                                                  stat_l, S, d, scale, dr);
}

template <bool DROP>
__global__ void __launch_bounds__(attn::LIST16_THREADS, 3)
flash_attention_bwd_dq_bf16_kernel(
    const tile::bf16* __restrict__ qkv, attn::SegTags tags, int span,
    const tile::bf16* __restrict__ out, const tile::bf16* __restrict__ gout,
    const float* __restrict__ stat_m, const float* __restrict__ stat_l,
    float* __restrict__ delta, tile::bf16* __restrict__ dqkv, int S, int d,
    float scale, Dropout dr) {
  attn::l16::list_dq16<HD16, false, DROP>(qkv, tags, span, out, gout, stat_m,
                                          stat_l, delta, dqkv, S, d, scale,
                                          dr);
}

template <bool DROP>
__global__ void __launch_bounds__(attn::LIST16_THREADS, 3)
flash_attention_bwd_dkv_bf16_kernel(
    const tile::bf16* __restrict__ qkv, attn::SegTags tags, int span,
    const tile::bf16* __restrict__ gout, const float* __restrict__ stat_m,
    const float* __restrict__ stat_l, const float* __restrict__ delta,
    tile::bf16* __restrict__ dqkv, int S, int d, float scale, Dropout dr) {
  attn::l16::list_dkv16<HD16, false, DROP>(qkv, tags, span, gout, stat_m,
                                           stat_l, delta, dqkv, S, d, scale,
                                           dr);
}

template <class Kernel>
cudaError_t allow_smem(Kernel k, int bytes) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <bool DROP, bool STATS>
int launch_fwd_bf16(const tile::bf16* qkv, attn::SegTags tags,
                    tile::bf16* out, float* stat_m, float* stat_l, int B,
                    int S, int d, int H, Dropout dr, const tile::Launch& L,
                    cudaStream_t stream) {
  if (!attn::list16_launch_ok(L, B, S, S, H, HD16, false))
    return cudaErrorInvalidValue;
  const auto k = flash_attention_fwd_bf16_kernel<DROP, STATS>;
  static const cudaError_t set =
      allow_smem(k, attn::list16_bytes(HD16, false));
  if (set != cudaSuccess) return set;
  k<<<dim3(L.gx, L.gy, L.gz), L.threads, L.smem, stream>>>(
      qkv, tags, S, out, stat_m, stat_l, S, d, 1.f / sqrtf((float)HD16), dr);
  return cudaGetLastError();
}

// The bf16 pair's launch over the whole row, computed here as the
// wrapper's list16_geometry computes it (a block per (row, head, 64
// tokens)).
template <bool DROP>
int launch_bwd_bf16(const tile::bf16* qkv, attn::SegTags tags,
                    const tile::bf16* out, const tile::bf16* gout,
                    const float* stat_m, const float* stat_l, float* delta,
                    tile::bf16* dqkv, int B, int S, int d, int H, Dropout dr,
                    cudaStream_t stream) {
  const int bytes = attn::list16_bytes(HD16, true);
  const tile::Launch L{3, attn::LONG_T, 1, B, H, attn::list16_tiles(S, S),
                       attn::LIST16_THREADS, bytes};
  const auto dq = flash_attention_bwd_dq_bf16_kernel<DROP>;
  const auto dkv = flash_attention_bwd_dkv_bf16_kernel<DROP>;
  static const cudaError_t set = [&] {
    const cudaError_t e = allow_smem(dq, bytes);
    return e != cudaSuccess ? e : allow_smem(dkv, bytes);
  }();
  if (set != cudaSuccess) return set;
  return attn::launch_list_bwd16(dq, dkv, qkv, tags, S, out, gout, stat_m,
                                 stat_l, delta, dqkv, S, d,
                                 1.f / sqrtf((float)HD16), dr, L, stream);
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

Dropout make_dropout(int on, unsigned thresh, float inv_keep, int seed) {
  Dropout dr;
  dr.on = on;
  dr.thresh = thresh;
  dr.inv_keep = inv_keep;
  dr.seed = (unsigned)seed;
  return dr;
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Returns cudaGetLastError() after the launch (0 = launched). Heads of
// width 32, 64 or 128. drop = 0 is attention without dropout; otherwise
// (thresh, inv_keep, seed) define the keep mask as above. stat_m and
// stat_l ([B, S, H]) may be null without dropout: the softmax statistics
// are then not written (serving). The launch (instance, pad, group, grid,
// threads, smem) is the wrapper's long_fwd_geometry; one that does not match
// the shapes is refused.
extern "C" int flash_attention_fwd(const float* qkv, const int* segq,
                                   const int* segk, float* out, float* stat_m,
                                   float* stat_l, int B, int S, int d, int H,
                                   int drop, unsigned thresh, float inv_keep,
                                   int seed, int instance, int pad, int group,
                                   int gx, int gy, int gz, int threads,
                                   int smem, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || H <= 0 || d % H) return cudaErrorInvalidValue;
  if ((stat_m == nullptr) != (stat_l == nullptr)) return cudaErrorInvalidValue;
  if (drop && stat_m == nullptr) return cudaErrorInvalidValue;
  const Dropout dr = make_dropout(drop, thresh, inv_keep, seed);
  const attn::SegTags tags{segq, segk};
  const tile::Launch L{instance, pad, group, gx, gy, gz, threads, smem};
  switch (d / H) {
    case 32:
      return launch_fwd<32>(qkv, tags, out, stat_m, stat_l, B, S, d, H, dr, L,
                            stream);
    case 64:
      return launch_fwd<64>(qkv, tags, out, stat_m, stat_l, B, S, d, H, dr, L,
                            stream);
    case 128:
      return launch_fwd<128>(qkv, tags, out, stat_m, stat_l, B, S, d, H, dr,
                             L, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// dqkv [B, S, 3d] for the cotangent gout [B, S, d] of flash_attention_fwd's
// out, from its saved m and l; delta [B, S, H] is scratch (written by the
// dq kernel, read by the dk/dv kernel on the same stream).
extern "C" int flash_attention_bwd(const float* qkv, const int* segq,
                                   const int* segk, const float* out,
                                   const float* gout, const float* stat_m,
                                   const float* stat_l, float* delta,
                                   float* dqkv, int B, int S, int d, int H,
                                   int drop, unsigned thresh, float inv_keep,
                                   int seed, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || H <= 0 || d % H) return cudaErrorInvalidValue;
  const Dropout dr = make_dropout(drop, thresh, inv_keep, seed);
  const attn::SegTags tags{segq, segk};
  switch (d / H) {
    case 32:
      return launch_bwd<32>(qkv, tags, out, gout, stat_m, stat_l, delta, dqkv,
                            B, S, d, H, dr, stream);
    case 64:
      return launch_bwd<64>(qkv, tags, out, gout, stat_m, stat_l, delta, dqkv,
                            B, S, d, H, dr, stream);
    case 128:
      return launch_bwd<128>(qkv, tags, out, gout, stat_m, stat_l, delta,
                             dqkv, B, S, d, H, dr, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// K5's bf16 instances (the bf16 step): qkv, out, gout and dqkv bf16, m, l
// and delta float; heads of 64; the arguments as flash_attention_fwd's and
// flash_attention_bwd's. The forward's launch is the wrapper's
// list16_geometry over the whole row; one that does not match is refused.
extern "C" int flash_attention_fwd_bf16(
    const tile::bf16* qkv, const int* segq, const int* segk, tile::bf16* out,
    float* stat_m, float* stat_l, int B, int S, int d, int H, int drop,
    unsigned thresh, float inv_keep, int seed, int instance, int pad,
    int group, int gx, int gy, int gz, int threads, int smem,
    cudaStream_t stream) {
  if (B <= 0 || S <= 0 || H <= 0 || d != H * HD16)
    return cudaErrorInvalidValue;
  if ((stat_m == nullptr) != (stat_l == nullptr)) return cudaErrorInvalidValue;
  if (drop && stat_m == nullptr) return cudaErrorInvalidValue;
  const Dropout dr = make_dropout(drop, thresh, inv_keep, seed);
  const attn::SegTags tags{segq, segk};
  const tile::Launch L{instance, pad, group, gx, gy, gz, threads, smem};
  if (dr.on)
    return launch_fwd_bf16<true, true>(qkv, tags, out, stat_m, stat_l, B, S,
                                       d, H, dr, L, stream);
  if (stat_m)
    return launch_fwd_bf16<false, true>(qkv, tags, out, stat_m, stat_l, B, S,
                                        d, H, dr, L, stream);
  return launch_fwd_bf16<false, false>(qkv, tags, out, stat_m, stat_l, B, S,
                                       d, H, dr, L, stream);
}

extern "C" int flash_attention_bwd_bf16(
    const tile::bf16* qkv, const int* segq, const int* segk,
    const tile::bf16* out, const tile::bf16* gout, const float* stat_m,
    const float* stat_l, float* delta, tile::bf16* dqkv, int B, int S, int d,
    int H, int drop, unsigned thresh, float inv_keep, int seed,
    cudaStream_t stream) {
  if (B <= 0 || S <= 0 || H <= 0 || d != H * HD16)
    return cudaErrorInvalidValue;
  const Dropout dr = make_dropout(drop, thresh, inv_keep, seed);
  const attn::SegTags tags{segq, segk};
  return dr.on ? launch_bwd_bf16<true>(qkv, tags, out, gout, stat_m, stat_l,
                                       delta, dqkv, B, S, d, H, dr, stream)
               : launch_bwd_bf16<false>(qkv, tags, out, gout, stat_m, stat_l,
                                        delta, dqkv, B, S, d, H, dr, stream);
}

// The residency of a kernel of K5's bf16 instances (with dropout: the
// training launch) at `smem` shared bytes a block: `which` 0 the forward,
// 1 the dq kernel, 2 the dk/dv kernel.
extern "C" int flash_attention_bf16_residency(int which, int smem, int* regs,
                                              int* local, int* blocks) {
  const int fb = attn::list16_bytes(HD16, false);
  const int bb = attn::list16_bytes(HD16, true);
  switch (which) {
    case 0:
      return residency(flash_attention_fwd_bf16_kernel<true, true>, fb, smem,
                       regs, local, blocks);
    case 1:
      return residency(flash_attention_bwd_dq_bf16_kernel<true>, bb, smem,
                       regs, local, blocks);
    case 2:
      return residency(flash_attention_bwd_dkv_bf16_kernel<true>, bb, smem,
                       regs, local, blocks);
  }
  return cudaErrorInvalidValue;
}
