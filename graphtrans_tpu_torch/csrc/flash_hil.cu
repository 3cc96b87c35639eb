// K3: segment-masked attention over wide packed rows, streaming the keys
// in blocks with an online softmax; attention dropout; and its backward.
// Wrapper, plain version and design note:
// graphtrans_tpu_torch/ops/kernels/flash_hil.py.
//
// qkv [R, W, 3d] (heads in lanes), seg [R, W] -> out [R, W, d]. Query i
// attends key j iff seg[i] == seg[j] >= 0; scale 1/sqrt(hd). One block per
// (row, head, block of BQ queries), one thread per query: q and the output
// accumulator (HD floats each) stay in registers. The keys stream through
// shared memory BK at a time (K_h, V_h and seg of the block). Segments of a
// packed row are contiguous, so a key block holds a key of the query
// block's segments only if its valid segment ids meet the query block's
// range [qmin, qmax]: blocks that cannot are skipped whole (one
// __syncthreads_or). Inside a block each query walks the keys in order and
// updates its running max m and denominator l; a query with no valid key
// (padding, or a segment without keys) writes exact zeros.
//
// Dropout (torch semantics: l sums the undropped probabilities; a kept one
// is scaled by 1/(1-rate)) keeps (r, h, i, j) iff hash(pos, seed') <
// thresh with seed' = seed + ((r*H + h)*16384 + i/512)*1024 + j/128 and
// pos = (i%512)*128 + j%128: the JAX kernel's per-(q-block, k-block) seed
// schedule at its BQ=512, BK=128, with the counter hash of its interpret
// mode. Forward, backward and the plain version draw the same mask from
// (seed, r, h, i, j); nothing is stored. Where a gradient is wanted the
// forward also writes m and l per (row, query, head).
//
// Backward: the long-row pair of attention_bwd.cuh (the JAX package's
// _dq_kernel and _dkv_kernel), under K3's own kernels with seg as both tag
// arrays (attn::SegTags{seg, seg}: the mask seg[i] == seg[j] >= 0) and the
// mask above as its Keep policy. A dq kernel over 64-query tiles (it also
// writes delta_i = dO_i . O_i) walks the keys whose segment meets one of
// its queries', gathered 64 at a time by rank; a dk/dv kernel over chunks
// of 64 valid keys by rank walks the query tiles whose segments can meet
// them. A tile or chunk may straddle segments: the pair mask separates
// them. The pair tiles' products run as 3xTF32 mma.sync on the tensor
// cores from cp.async-staged shared tiles. It reads the forward's m and l,
// which K3's forward writes with attention_fwd.cuh's meaning (m the max
// scaled score, l the sum of the undropped exp(s - m), m = -inf and l = 0
// for a query without a key). Every output cell has one writer: no
// atomics; padding tokens write exact zeros.

#include <cuda_runtime.h>
#include <math.h>

#include "attention_bwd.cuh"
#include "hash.cuh"

namespace {

constexpr int BQ = 128;       // queries a block (= threads)
constexpr int BK = 128;       // keys a shared-memory stage (= threads, dkv)
constexpr int MASK_BQ = 512;  // query rows of one mask seed (JAX kernel's BQ)
constexpr int MASK_BK = 128;  // key columns of one mask seed (its BK)

struct Dropout {
  int on;            // 0: rate 0, the identity
  unsigned thresh;   // keep iff bits < thresh
  float inv_keep;    // 1 / (1 - rate)
  unsigned seed;

  // the long backward's Keep policy: keep (r, h, i, j)
  __device__ bool operator()(long r, int h, int H, int, int i, int j) const;
};

// rh = r*H + h; u32 arithmetic wraps as the reference's int32 does
__device__ __forceinline__ bool keep(const Dropout& dr, unsigned rh, int i,
                                     int j) {
  const unsigned s =
      dr.seed + (rh * 16384u + (unsigned)(i / MASK_BQ)) * 1024u +
      (unsigned)(j / MASK_BK);
  const unsigned pos =
      (unsigned)(i % MASK_BQ) * MASK_BK + (unsigned)(j % MASK_BK);
  return prng::hash_bits(pos, s) < dr.thresh;
}

__device__ bool Dropout::operator()(long r, int h, int H, int, int i,
                                    int j) const {
  return keep(*this, (unsigned)r * (unsigned)H + (unsigned)h, i, j);
}

// Fills lo/hi with the min and max valid segment id of the block's tokens
// (sv < 0: none). All threads of the block call it.
__device__ __forceinline__ void block_range(int sv, int* range, int& lo,
                                            int& hi) {
  if (threadIdx.x == 0) {
    range[0] = 0x7fffffff;
    range[1] = -1;
  }
  __syncthreads();
  if (sv >= 0) {
    atomicMin(&range[0], sv);
    atomicMax(&range[1], sv);
  }
  __syncthreads();
  lo = range[0];
  hi = range[1];
}

// DROP and STATS are compile-time, so the serving launch (neither) runs
// the loop of a kernel without dropout and writes no statistics. Dropout
// is for training and always saves them (no DROP-only instance).
template <int HD, bool DROP, bool STATS>
__global__ void __launch_bounds__(BQ)
flash_hil_fwd_kernel(const float* __restrict__ qkv,
                     const int* __restrict__ seg, float* __restrict__ out,
                     float* __restrict__ stat_m, float* __restrict__ stat_l,
                     int W, int d, float scale, Dropout dr) {
  __shared__ float ks[BK * HD];
  __shared__ float vs[BK * HD];
  __shared__ int ss[BK];
  __shared__ int qrange[2];

  const long r = blockIdx.x;
  const int h = blockIdx.y;
  const int i = blockIdx.z * BQ + threadIdx.x;
  const long d3 = 3L * d;
  const float* row = qkv + r * W * d3;
  const int* srow = seg + r * W;
  const unsigned rh = (unsigned)r * gridDim.y + (unsigned)h;

  const int si = i < W ? srow[i] : -1;
  int qmin, qmax;
  block_range(si, qrange, qmin, qmax);

  float q[HD], o[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) o[c] = 0.f;
  if (si >= 0) {
    const float* qi = row + i * d3 + h * HD;
#pragma unroll
    for (int c = 0; c < HD; ++c) q[c] = qi[c] * scale;
  }
  float m = -INFINITY, l = 0.f;

  if (qmax >= 0) {  // the block holds a valid query
    for (int k0 = 0; k0 < W; k0 += BK) {
      const int j = k0 + threadIdx.x;  // BK == blockDim.x
      const int sj = j < W ? srow[j] : -1;
      const bool meets = sj >= qmin && sj <= qmax;
      if (!__syncthreads_or(meets)) continue;  // uniform: no key can match
      ss[threadIdx.x] = sj;
      for (int idx = threadIdx.x; idx < BK * HD; idx += BQ) {
        const int jj = idx / HD, c = idx % HD;
        const bool in = k0 + jj < W;
        const float* kr = row + (long)(k0 + jj) * d3 + h * HD + c;
        ks[idx] = in ? kr[d] : 0.f;
        vs[idx] = in ? kr[2 * d] : 0.f;
      }
      __syncthreads();
      if (si >= 0) {
        for (int jj = 0; jj < BK; ++jj) {
          if (ss[jj] != si) continue;
          const float* kj = ks + jj * HD;
          float s = 0.f;
#pragma unroll
          for (int c = 0; c < HD; ++c) s = fmaf(q[c], kj[c], s);
          if (s > m) {
            const float a = expf(m - s);  // 0 on the first key (m = -inf)
            l *= a;
#pragma unroll
            for (int c = 0; c < HD; ++c) o[c] *= a;
            m = s;
          }
          const float p = expf(s - m);
          l += p;
          if (DROP && !keep(dr, rh, i, k0 + jj)) continue;
          const float* vj = vs + jj * HD;
#pragma unroll
          for (int c = 0; c < HD; ++c) o[c] = fmaf(p, vj[c], o[c]);
        }
      }
      __syncthreads();  // the stage is overwritten next
    }
  }
  if (i < W) {
    const float inv = (DROP ? dr.inv_keep : 1.f) / fmaxf(l, 1e-16f);
    float* oi = out + (r * W + i) * d + h * HD;
#pragma unroll
    for (int c = 0; c < HD; ++c) oi[c] = o[c] * inv;
    if (STATS) {
      const long at = (r * W + i) * gridDim.y + h;
      stat_m[at] = m;
      stat_l[at] = l;
    }
  }
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

template <bool DROP, bool STATS>
int launch_fwd(const float* qkv, const int* seg, float* out, float* stat_m,
               float* stat_l, int R, int W, int d, int H, Dropout dr,
               cudaStream_t stream) {
  dim3 grid(R, H, (W + BQ - 1) / BQ);
  flash_hil_fwd_kernel<32, DROP, STATS><<<grid, BQ, 0, stream>>>(
      qkv, seg, out, stat_m, stat_l, W, d, 1.f / sqrtf(32.f), dr);
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
// the softmax statistics are then not written (serving).
extern "C" int flash_hil_fwd(const float* qkv, const int* seg, float* out,
                             float* stat_m, float* stat_l, int R, int W,
                             int d, int H, int drop, unsigned thresh,
                             float inv_keep, int seed, cudaStream_t stream) {
  if (d != H * 32 || R <= 0 || W <= 0) return cudaErrorInvalidValue;
  if ((stat_m == nullptr) != (stat_l == nullptr)) return cudaErrorInvalidValue;
  if (drop && stat_m == nullptr) return cudaErrorInvalidValue;
  const Dropout dr = make_dropout(drop, thresh, inv_keep, seed);
  if (drop)
    return launch_fwd<true, true>(qkv, seg, out, stat_m, stat_l, R, W, d, H,
                                  dr, stream);
  if (stat_m)
    return launch_fwd<false, true>(qkv, seg, out, stat_m, stat_l, R, W, d, H,
                                   dr, stream);
  return launch_fwd<false, false>(qkv, seg, out, stat_m, stat_l, R, W, d, H,
                                  dr, stream);
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
