// K9: per-head attention with a key-padding mask and, with block > 0, a
// block-diagonal one, at any row width, with attention dropout; and its
// backward. Wrapper, plain version and design note:
// graphtrans_tpu_torch/ops/kernels/attention_smalls.py.
//
// qkv [B, S, 3d] (heads in lanes), valid [B, S] (torch's bool, one byte)
// -> out [B, S, d]. Key j is attendable by query i iff valid[j] and, with
// block > 0, i / block == j / block: K4's function (a padding query attends
// its block's valid keys; a query whose block has no valid key writes
// zeros), as the tags of attention_bwd.cuh's PadTags. The forward is the
// streaming body of attention_fwd.cuh (K5's) and the backward the streaming
// pair of attention_bwd.cuh (K4's and K5's), each under K9's own
// __global__ instances with K9's dropout schedule as the Keep policy.
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
#include "hash.cuh"

namespace {

using attn::BQ;

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

template <int HD, bool DROP, bool STATS>
__global__ void __launch_bounds__(BQ)
attention_smalls_fwd_kernel(const float* __restrict__ qkv,
                            const unsigned char* __restrict__ valid,
                            float* __restrict__ out,
                            float* __restrict__ stat_m,
                            float* __restrict__ stat_l, int S, int d,
                            int block, float scale, SmallsKeep dr) {
  attn::stream_fwd<HD, DROP, STATS>(qkv, attn::PadTags{valid, block}, out,
                                    stat_m, stat_l, S, d, scale, dr);
}

template <int HD, bool DROP, bool STATS>
int launch_instance(const float* qkv, const unsigned char* valid, float* out,
                    float* stat_m, float* stat_l, int B, int S, int d, int H,
                    int block, SmallsKeep dr, cudaStream_t stream) {
  dim3 grid(B, H, (S + BQ - 1) / BQ);
  attention_smalls_fwd_kernel<HD, DROP, STATS><<<grid, BQ, 0, stream>>>(
      qkv, valid, out, stat_m, stat_l, S, d, block, 1.f / sqrtf((float)HD),
      dr);
  return cudaGetLastError();
}

// The serving instance (no dropout, no statistics), the gradient instance
// without dropout, and the training one (dropout always saves statistics).
template <int HD>
int launch_fwd(const float* qkv, const unsigned char* valid, float* out,
               float* stat_m, float* stat_l, int B, int S, int d, int H,
               int block, SmallsKeep dr, cudaStream_t stream) {
  if (dr.on)
    return launch_instance<HD, true, true>(qkv, valid, out, stat_m, stat_l,
                                           B, S, d, H, block, dr, stream);
  if (stat_m)
    return launch_instance<HD, false, true>(qkv, valid, out, stat_m, stat_l,
                                            B, S, d, H, block, dr, stream);
  return launch_instance<HD, false, false>(qkv, valid, out, stat_m, stat_l,
                                           B, S, d, H, block, dr, stream);
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
// statistics are then not written (serving).
extern "C" int attention_smalls_fwd(const float* qkv,
                                    const unsigned char* valid, float* out,
                                    float* stat_m, float* stat_l, int B,
                                    int S, int d, int H, int block, int drop,
                                    unsigned thresh, float inv_keep, int seed,
                                    cudaStream_t stream) {
  if (B <= 0 || S <= 0 || H <= 0 || d % H || block < 0)
    return cudaErrorInvalidValue;
  if ((stat_m == nullptr) != (stat_l == nullptr)) return cudaErrorInvalidValue;
  if (drop && stat_m == nullptr) return cudaErrorInvalidValue;
  const SmallsKeep dr = make_keep(drop, thresh, inv_keep, seed, S);
  switch (d / H) {
    case 32:
      return launch_fwd<32>(qkv, valid, out, stat_m, stat_l, B, S, d, H,
                            block, dr, stream);
    case 64:
      return launch_fwd<64>(qkv, valid, out, stat_m, stat_l, B, S, d, H,
                            block, dr, stream);
    case 128:
      return launch_fwd<128>(qkv, valid, out, stat_m, stat_l, B, S, d, H,
                             block, dr, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// dqkv [B, S, 3d] for the cotangent gout [B, S, d] of attention_smalls_fwd's
// out, from its saved m and l; delta [B, S, H] is scratch (written by the
// dq kernel, read by the dk/dv kernel on the same stream).
extern "C" int attention_smalls_bwd(const float* qkv,
                                    const unsigned char* valid,
                                    const float* out, const float* gout,
                                    const float* stat_m, const float* stat_l,
                                    float* delta, float* dqkv, int B, int S,
                                    int d, int H, int block, int drop,
                                    unsigned thresh, float inv_keep, int seed,
                                    cudaStream_t stream) {
  if (B <= 0 || S <= 0 || H <= 0 || d % H || block < 0)
    return cudaErrorInvalidValue;
  const SmallsKeep dr = make_keep(drop, thresh, inv_keep, seed, S);
  const attn::PadTags tags{valid, block};
  switch (d / H) {
    case 32:
      return attn::launch_bwd<32>(qkv, tags, out, gout, stat_m, stat_l, delta,
                                  dqkv, B, S, d, H, dr, stream);
    case 64:
      return attn::launch_bwd<64>(qkv, tags, out, gout, stat_m, stat_l, delta,
                                  dqkv, B, S, d, H, dr, stream);
    case 128:
      return attn::launch_bwd<128>(qkv, tags, out, gout, stat_m, stat_l,
                                   delta, dqkv, B, S, d, H, dr, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
