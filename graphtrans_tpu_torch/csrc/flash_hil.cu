// K3: segment-masked attention over wide packed rows (code2's rows of 512
// and 1024 tokens), with attention dropout, and its backward. Wrapper,
// plain version and design note: graphtrans_tpu_torch/ops/kernels/flash_hil.py.
//
// qkv [R, W, 3d] (heads in lanes), seg [R, W] -> out [R, W, d]. Query i
// attends key j iff seg[i] == seg[j] >= 0; scale 1/sqrt(hd); a query with
// no key (padding) writes exact zeros.
//
// Dropout (torch semantics: l sums the undropped probabilities; a kept one
// is scaled by 1/(1-rate)) keeps (r, h, i, j) iff hash(pos, seed') <
// thresh with seed' = seed + ((r*H + h)*16384 + i/512)*1024 + j/128 and
// pos = (i%512)*128 + j%128: the JAX kernel's per-(q-block, k-block) seed
// schedule at its BQ=512, BK=128, with the counter hash of its interpret
// mode. Forward, backward and the plain version draw the same mask from
// (seed, r, h, i, j) through Dropout below; nothing is stored.
//
// Forward: the long-row forward of attention_fwd.cuh (K5's, K2's 384 tier's)
// under K3's own kernel, seg as both tag arrays (attn::SegTags{seg, seg})
// and Dropout as its Keep policy. One block of four warps per (row, head,
// 64 queries) ranks the keys whose segment meets one of its queries',
// gathers them 64 at a time, and runs the scores and P V as 3xTF32
// mma.sync on the tensor cores, each warp's 16 query rows whole in
// registers. Where a gradient is wanted (and with every dropout launch) it
// writes the softmax statistics m and l per (row, query, head): m the max
// scaled score, l the sum of the undropped exp(s - m), m = -inf and l = 0
// for a query without a key.
//
// Backward: the long-row pair of attention_bwd.cuh (the JAX package's
// _dq_kernel and _dkv_kernel), under K3's own kernels with the same tags
// and mask. A dq kernel over 64-query tiles (it also writes delta_i = dO_i
// . O_i) walks the keys whose segment meets one of its queries', gathered
// 64 at a time by rank; a dk/dv kernel over chunks of 64 valid keys by rank
// walks the query tiles whose segments can meet them. A tile or chunk may
// straddle segments: the pair mask separates them. It reads the forward's m
// and l. Every output cell has one writer: no atomics; padding tokens write
// exact zeros.
//
// bf16 (the bf16 step): the bf16 long forward and pair of attention_fwd.cuh
// and attention_bwd.cuh (long_fwd16 with the online softmax, query tiles
// inside one graph's run and its keys streamed through a ring of chunk
// buffers; long_dq16 with delta = dO . O, long_dkv16), rounding where the
// TPU's MXU rounds under the JAX kernel's Precision.DEFAULT: the
// unnormalised p, dS and P_drop.

#include <cuda_runtime.h>
#include <math.h>

#include "attention_fwd.cuh"
#include "hash.cuh"

namespace {

constexpr int MASK_BQ = 512;  // query rows of one mask seed (JAX kernel's BQ)
constexpr int MASK_BK = 128;  // key columns of one mask seed (its BK)

struct Dropout {
  int on;            // 0: rate 0, the identity
  unsigned thresh;   // keep iff bits < thresh
  float inv_keep;    // 1 / (1 - rate)
  unsigned seed;

  // the long bodies' Keep policy: keep (r, h, i, j) of a row of W tokens;
  // u32 arithmetic wraps as the reference's int32 does
  __device__ bool operator()(long r, int h, int H, int, int i, int j) const {
    const unsigned rh = (unsigned)r * (unsigned)H + (unsigned)h;
    const unsigned s = seed + (rh * 16384u + (unsigned)(i / MASK_BQ)) * 1024u +
                       (unsigned)(j / MASK_BK);
    const unsigned pos =
        (unsigned)(i % MASK_BQ) * MASK_BK + (unsigned)(j % MASK_BK);
    return prng::hash_bits(pos, s) < thresh;
  }

  // The same mask for one (row r, head h), its seed's row part computed
  // once (the bf16 long bodies): row(r, h, H, W)(i, j) == (*this)(r, h, H,
  // W, i, j).
  struct Row {
    unsigned base, thresh;  // seed + (r H + h) * 16384 * 1024
    __device__ bool operator()(int i, int j) const {
      const unsigned s = base + (unsigned)(i / MASK_BQ) * 1024u +
                         (unsigned)(j / MASK_BK);
      const unsigned pos =
          (unsigned)(i % MASK_BQ) * MASK_BK + (unsigned)(j % MASK_BK);
      return prng::hash_bits(pos, s) < thresh;
    }
  };
  __device__ Row row(long r, int h, int H, int) const {
    const unsigned rh = (unsigned)r * (unsigned)H + (unsigned)h;
    return Row{seed + rh * 16384u * 1024u, thresh};
  }
  // The bf16 long forward's form: the hash input of (i, j) split as a
  // query's part and a key's, x(i, j) = at(i) + col(j) (mod 2^32), so a
  // key's part serves both of a thread's rows; keeps(x) == Row(i, j).
  struct Split {
    unsigned base, thresh;
    __device__ unsigned at(unsigned i) const {  // i, j: tokens, >= 0
      return i % MASK_BQ * MASK_BK * prng::POS_MUL +
             (base + i / MASK_BQ * 1024u) * prng::SEED_MUL;
    }
    __device__ unsigned col(unsigned j) const {
      return j % MASK_BK * prng::POS_MUL + j / MASK_BK * prng::SEED_MUL;
    }
    __device__ bool keeps(unsigned x) const { return prng::mix(x) < thresh; }
  };
  __device__ Split split(long r, int h, int H, int W) const {
    const Row w = row(r, h, H, W);
    return Split{w.base, w.thresh};
  }
};

// K3's forward: the long-row forward, seg as both tags. DROP and STATS are
// compile-time, so the serving launch (neither) runs the loop without
// dropout and writes no statistics. Dropout is for training and always
// saves them (no DROP-only instance).
template <int HD, bool DROP, bool STATS>
__global__ void __launch_bounds__(attn::LONG_FWD_THREADS,
                                  attn::long_fwd_blocks(HD))
flash_hil_fwd_long_kernel(const float* __restrict__ qkv, attn::SegTags tags,
                          float* __restrict__ out, float* __restrict__ stat_m,
                          float* __restrict__ stat_l, int W, int d,
                          float scale, Dropout dr) {
  attn::long_fwd<HD, DROP, STATS>(qkv, tags, out, stat_m, stat_l, W, d, scale,
                                  dr);
}

// K3's backward kernels over the long-row bodies of attention_bwd.cuh.
template <int HD>
__global__ void __launch_bounds__(attn::LONG_THREADS, attn::long_blocks(HD))
flash_hil_bwd_dq_kernel(const float* __restrict__ qkv, attn::SegTags tags,
                        const float* __restrict__ out,
                        const float* __restrict__ gout,
                        const float* __restrict__ stat_m,
                        const float* __restrict__ stat_l,
                        float* __restrict__ delta, float* __restrict__ dqkv,
                        int W, int d, float scale, Dropout dr) {
  attn::lr::long_dq<HD>(qkv, tags, out, gout, stat_m, stat_l, delta, dqkv, W,
                        d, scale, dr);
}

template <int HD>
__global__ void __launch_bounds__(attn::LONG_THREADS, attn::long_blocks(HD))
flash_hil_bwd_dkv_kernel(const float* __restrict__ qkv, attn::SegTags tags,
                         const float* __restrict__ gout,
                         const float* __restrict__ stat_m,
                         const float* __restrict__ stat_l,
                         const float* __restrict__ delta,
                         float* __restrict__ dqkv, int W, int d, float scale,
                         Dropout dr) {
  attn::lr::long_dkv<HD>(qkv, tags, gout, stat_m, stat_l, delta, dqkv, W, d,
                         scale, dr);
}

// K3's bf16 instances (the bf16 step): the bf16 long forward
// (attention_fwd.cuh: long_fwd16, the online softmax's unnormalised p
// rounded before P V, as the TPU's MXU rounds it; query tiles of 64
// inside one graph's run, its keys through a ring of chunk buffers) and
// the bf16 long pair (attention_bwd.cuh: long_dq16 with delta = dO . O
// over the rounded output, as _bwd_rule forms it, and long_dkv16), seg as
// both tags. Registers for four blocks an SM, or three with dropout,
// whose hash needs more (so that nothing spills).
template <bool DROP, bool STATS>
__global__ void __launch_bounds__(attn::LONG16_THREADS, DROP ? 3 : 4)
flash_hil_fwd_bf16_kernel(const tile::bf16* __restrict__ qkv,
                          const int* __restrict__ seg,
                          tile::bf16* __restrict__ out,
                          float* __restrict__ stat_m,
                          float* __restrict__ stat_l, int W, int d,
                          float scale, Dropout dr) {
  attn::long_fwd16<false, DROP, STATS>(qkv, seg, out, stat_m, stat_l, W, d,
                                       scale, dr);
}

__global__ void __launch_bounds__(attn::LONG16_THREADS, 4)
flash_hil_bwd_dq_bf16_kernel(const tile::bf16* __restrict__ qkv,
                             attn::SegTags tags,
                             const tile::bf16* __restrict__ out,
                             const tile::bf16* __restrict__ gout,
                             const float* __restrict__ stat_m,
                             const float* __restrict__ stat_l,
                             float* __restrict__ delta,
                             tile::bf16* __restrict__ dqkv, int W, int d,
                             float scale, Dropout dr) {
  attn::lr::long_dq16<false>(qkv, tags, out, gout, stat_m, stat_l, delta,
                             dqkv, W, d, scale, dr);
}

__global__ void __launch_bounds__(attn::LONG16_THREADS, 4)
flash_hil_bwd_dkv_bf16_kernel(const tile::bf16* __restrict__ qkv,
                              attn::SegTags tags,
                              const tile::bf16* __restrict__ gout,
                              const float* __restrict__ stat_m,
                              const float* __restrict__ stat_l,
                              const float* __restrict__ delta,
                              tile::bf16* __restrict__ dqkv, int W, int d,
                              float scale, Dropout dr) {
  attn::lr::long_dkv16(qkv, tags, gout, stat_m, stat_l, delta, dqkv, W, d,
                       scale, dr);
}

// The bf16 forward's launch, as flash_hil.py:fwd_geometry gives it for
// bf16 (attention_packed.py:long16_fwd_geometry); the kernel may take up to
// tile::SMEM_MAX bytes of dynamic shared memory (its bytes grow with W),
// set once, before the first launch.
template <bool DROP, bool STATS>
int launch_fwd_bf16(const tile::bf16* qkv, const int* seg, tile::bf16* out,
                    float* stat_m, float* stat_l, int R, int W, int d, int H,
                    Dropout dr, const tile::Launch& L, cudaStream_t stream) {
  if (L.instance != 3 || !attn::fwd16_launch_ok(L, R, W, H, false))
    return cudaErrorInvalidValue;
  const auto k = flash_hil_fwd_bf16_kernel<DROP, STATS>;
  static const cudaError_t set = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, tile::SMEM_MAX);
  if (set != cudaSuccess) return set;
  k<<<dim3(L.gx, L.gy, L.gz), L.threads, L.smem, stream>>>(
      qkv, seg, out, stat_m, stat_l, W, d, 1.f / sqrtf(32.f), dr);
  return cudaGetLastError();
}

// Launches the forward after checking the wrapper's launch (flash_hil.py:
// fwd_geometry, the long forward's); the kernel's shared-memory attribute
// is raised once, before its first launch.
template <bool DROP, bool STATS>
int launch_fwd(const float* qkv, const int* seg, float* out, float* stat_m,
               float* stat_l, int R, int W, int d, int H, Dropout dr,
               const tile::Launch& L, cudaStream_t stream) {
  if (L.instance != 3 || !attn::long_fwd_launch_ok(L, R, W, H, 32))
    return cudaErrorInvalidValue;
  const auto kernel = flash_hil_fwd_long_kernel<32, DROP, STATS>;
  static const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      attn::long_fwd_bytes(32));
  if (set != cudaSuccess) return set;
  kernel<<<dim3(L.gx, L.gy, L.gz), L.threads, L.smem, stream>>>(
      qkv, attn::SegTags{seg, seg}, out, stat_m, stat_l, W, d,
      1.f / sqrtf(32.f), dr);
  return cudaGetLastError();
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
// width 32 (d_model 128 with 4 heads, or 64 with 2). drop = 0 is attention
// without dropout; otherwise (thresh, inv_keep, seed) define the keep mask
// as above. stat_m and stat_l ([R, W, H]) may be null without dropout:
// the softmax statistics are then not written (serving). The launch
// (instance, pad, group, grid, threads, smem) is the wrapper's
// fwd_geometry; one that does not match (R, W, H) is refused.
extern "C" int flash_hil_fwd(const float* qkv, const int* seg, float* out,
                             float* stat_m, float* stat_l, int R, int W,
                             int d, int H, int drop, unsigned thresh,
                             float inv_keep, int seed, int instance, int pad,
                             int group, int gx, int gy, int gz, int threads,
                             int smem, cudaStream_t stream) {
  if (d != H * 32 || R <= 0 || W <= 0) return cudaErrorInvalidValue;
  if ((stat_m == nullptr) != (stat_l == nullptr)) return cudaErrorInvalidValue;
  if (drop && stat_m == nullptr) return cudaErrorInvalidValue;
  const Dropout dr = make_dropout(drop, thresh, inv_keep, seed);
  const tile::Launch L{instance, pad, group, gx, gy, gz, threads, smem};
  if (drop)
    return launch_fwd<true, true>(qkv, seg, out, stat_m, stat_l, R, W, d, H,
                                  dr, L, stream);
  if (stat_m)
    return launch_fwd<false, true>(qkv, seg, out, stat_m, stat_l, R, W, d, H,
                                   dr, L, stream);
  return launch_fwd<false, false>(qkv, seg, out, stat_m, stat_l, R, W, d, H,
                                  dr, L, stream);
}

// dqkv [R, W, 3d] for the cotangent gout [R, W, d] of flash_hil_fwd's out,
// from its saved m and l; delta [R, W, H] is scratch (written by the dq
// kernel, read by the dk/dv kernel on the same stream).
extern "C" int flash_hil_bwd(const float* qkv, const int* seg, const float* out,
                             const float* gout, const float* stat_m,
                             const float* stat_l, float* delta, float* dqkv,
                             int R, int W, int d, int H, int drop,
                             unsigned thresh, float inv_keep, int seed,
                             cudaStream_t stream) {
  if (d != H * 32 || R <= 0 || W <= 0) return cudaErrorInvalidValue;
  const Dropout dr = make_dropout(drop, thresh, inv_keep, seed);
  return attn::launch_long_bwd<32>(flash_hil_bwd_dq_kernel<32>,
                                   flash_hil_bwd_dkv_kernel<32>, qkv,
                                   attn::SegTags{seg, seg}, out, gout, stat_m,
                                   stat_l, delta, dqkv, R, W, d, H, dr,
                                   stream);
}

// K3's bf16 instances (the bf16 step): qkv, out, gout and dqkv bf16, m and
// l float; the arguments as flash_hil_fwd's and flash_hil_bwd's. delta
// [R, W, H] is scratch, as flash_hil_bwd's.
extern "C" int flash_hil_fwd_bf16(const tile::bf16* qkv, const int* seg,
                                  tile::bf16* out, float* stat_m,
                                  float* stat_l, int R, int W, int d, int H,
                                  int drop, unsigned thresh, float inv_keep,
                                  int seed, int instance, int pad, int group,
                                  int gx, int gy, int gz, int threads,
                                  int smem, cudaStream_t stream) {
  if (d != H * 32 || R <= 0 || W <= 0) return cudaErrorInvalidValue;
  if ((stat_m == nullptr) != (stat_l == nullptr)) return cudaErrorInvalidValue;
  if (drop && stat_m == nullptr) return cudaErrorInvalidValue;
  const Dropout dr = make_dropout(drop, thresh, inv_keep, seed);
  const tile::Launch L{instance, pad, group, gx, gy, gz, threads, smem};
  if (drop)
    return launch_fwd_bf16<true, true>(qkv, seg, out, stat_m, stat_l, R, W, d,
                                       H, dr, L, stream);
  if (stat_m)
    return launch_fwd_bf16<false, true>(qkv, seg, out, stat_m, stat_l, R, W,
                                        d, H, dr, L, stream);
  return launch_fwd_bf16<false, false>(qkv, seg, out, stat_m, stat_l, R, W, d,
                                       H, dr, L, stream);
}

extern "C" int flash_hil_bwd_bf16(const tile::bf16* qkv, const int* seg,
                                  const tile::bf16* out,
                                  const tile::bf16* gout, const float* stat_m,
                                  const float* stat_l, float* delta,
                                  tile::bf16* dqkv, int R, int W, int d, int H,
                                  int drop, unsigned thresh, float inv_keep,
                                  int seed, cudaStream_t stream) {
  if (d != H * 32 || R <= 0 || W <= 0) return cudaErrorInvalidValue;
  const Dropout dr = make_dropout(drop, thresh, inv_keep, seed);
  return attn::launch_long_bwd16<attn::SegTags, Dropout>(
      flash_hil_bwd_dq_bf16_kernel, flash_hil_bwd_dkv_bf16_kernel, qkv,
      attn::SegTags{seg, seg}, out, gout, stat_m, stat_l, delta, dqkv, R, W, d,
      H, dr, stream);
}

// The residency of K3's bf16 forward (its training launch, with dropout
// and statistics) at `smem` shared bytes a block: registers a thread, local
// memory a thread (spills), blocks an SM.
extern "C" int flash_hil_fwd_bf16_residency(int smem, int* regs, int* local,
                                            int* blocks) {
  const auto k = flash_hil_fwd_bf16_kernel<true, true>;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, tile::SMEM_MAX);
  cudaFuncAttributes a;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, k);
  if (e != cudaSuccess) return e;
  *regs = a.numRegs;
  *local = (int)a.localSizeBytes;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, k, attn::LONG16_THREADS, smem);
}
