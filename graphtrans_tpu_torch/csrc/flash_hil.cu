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
// Backward, two kernels (the JAX package's _dq_kernel and _dkv_kernel):
// dq: one block per (row, head, BQ queries), one thread per query; it
// computes delta_i = dO_i . O_i for its head (written for the dk/dv
// kernel), then streams the keys as the forward does and sums
// ds_ij k_j with ds = p (dp_dropped - delta) and p from the saved m, l.
// dk/dv: one block per (row, head, BK keys), one thread per key; the
// queries (Q_h, dO_h, m, 1/l, delta, seg) stream through shared memory BQ
// at a time, query blocks whose segments cannot meet the key block's are
// skipped, and each key sums ds_ij q_i and p_dropped_ij dO_i. Every output
// cell has one writer: no atomics; padding tokens write exact zeros.

#include <cuda_runtime.h>
#include <math.h>

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
};

// murmur-style finalizer of (position, seed): graphtrans_tpu/ops/pallas/
// prng.py:_hash_bits_u32, in u32 arithmetic
__device__ __forceinline__ unsigned hash_bits(unsigned pos, unsigned seed) {
  unsigned x = pos * 2654435761u + seed * 0x9E3779B9u;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x ^ (x >> 16);
}

// rh = r*H + h; u32 arithmetic wraps as the reference's int32 does
__device__ __forceinline__ bool keep(const Dropout& dr, unsigned rh, int i,
                                     int j) {
  const unsigned s =
      dr.seed + (rh * 16384u + (unsigned)(i / MASK_BQ)) * 1024u +
      (unsigned)(j / MASK_BK);
  const unsigned pos =
      (unsigned)(i % MASK_BQ) * MASK_BK + (unsigned)(j % MASK_BK);
  return hash_bits(pos, s) < dr.thresh;
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

template <int HD>
__global__ void __launch_bounds__(BQ)
flash_hil_dq_kernel(const float* __restrict__ qkv,
                    const int* __restrict__ seg,
                    const float* __restrict__ out,
                    const float* __restrict__ gout,
                    const float* __restrict__ stat_m,
                    const float* __restrict__ stat_l,
                    float* __restrict__ delta, float* __restrict__ dqkv,
                    int W, int d, float scale, Dropout dr) {
  __shared__ float ks[BK * HD];
  __shared__ float vs[BK * HD];
  __shared__ int ss[BK];
  __shared__ int qrange[2];

  const long r = blockIdx.x;
  const int h = blockIdx.y;
  const int H = gridDim.y;
  const int i = blockIdx.z * BQ + threadIdx.x;
  const long d3 = 3L * d;
  const float* row = qkv + r * W * d3;
  const int* srow = seg + r * W;
  const unsigned rh = (unsigned)r * H + (unsigned)h;

  const int si = i < W ? srow[i] : -1;
  int qmin, qmax;
  block_range(si, qrange, qmin, qmax);

  float q[HD], g[HD], acc[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) acc[c] = 0.f;
  float m = 0.f, li = 0.f, de = 0.f;
  if (si >= 0) {
    const float* qi = row + i * d3 + h * HD;
    const float* gi = gout + (r * W + i) * d + h * HD;
    const float* oi = out + (r * W + i) * d + h * HD;
#pragma unroll
    for (int c = 0; c < HD; ++c) {
      q[c] = qi[c] * scale;
      g[c] = gi[c];
      de = fmaf(g[c], oi[c], de);
    }
    m = stat_m[(r * W + i) * H + h];
    li = 1.f / fmaxf(stat_l[(r * W + i) * H + h], 1e-16f);
  }
  if (i < W) delta[(r * W + i) * H + h] = de;

  if (qmax >= 0) {
    for (int k0 = 0; k0 < W; k0 += BK) {
      const int j = k0 + threadIdx.x;
      const int sj = j < W ? srow[j] : -1;
      const bool meets = sj >= qmin && sj <= qmax;
      if (!__syncthreads_or(meets)) continue;
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
          const float* vj = vs + jj * HD;
          float s = 0.f, dp = 0.f;
#pragma unroll
          for (int c = 0; c < HD; ++c) {
            s = fmaf(q[c], kj[c], s);
            dp = fmaf(g[c], vj[c], dp);
          }
          if (dr.on) dp = keep(dr, rh, i, k0 + jj) ? dp * dr.inv_keep : 0.f;
          const float ds = expf(s - m) * li * (dp - de);
#pragma unroll
          for (int c = 0; c < HD; ++c) acc[c] = fmaf(ds, kj[c], acc[c]);
        }
      }
      __syncthreads();
    }
  }
  if (i < W) {
    float* dq = dqkv + (r * W + i) * d3 + h * HD;
#pragma unroll
    for (int c = 0; c < HD; ++c) dq[c] = acc[c] * scale;
  }
}

template <int HD>
__global__ void __launch_bounds__(BK)
flash_hil_dkv_kernel(const float* __restrict__ qkv,
                     const int* __restrict__ seg,
                     const float* __restrict__ gout,
                     const float* __restrict__ stat_m,
                     const float* __restrict__ stat_l,
                     const float* __restrict__ delta,
                     float* __restrict__ dqkv, int W, int d, float scale,
                     Dropout dr) {
  __shared__ float qs[BQ * HD];  // q * scale
  __shared__ float gs[BQ * HD];  // dO
  __shared__ float ms[BQ], lis[BQ], des[BQ];
  __shared__ int ss[BQ];
  __shared__ int krange[2];

  const long r = blockIdx.x;
  const int h = blockIdx.y;
  const int H = gridDim.y;
  const int t = threadIdx.x;
  const int j = blockIdx.z * BK + t;
  const long d3 = 3L * d;
  const float* row = qkv + r * W * d3;
  const int* srow = seg + r * W;
  const unsigned rh = (unsigned)r * H + (unsigned)h;

  const int sj = j < W ? srow[j] : -1;
  int kmin, kmax;
  block_range(sj, krange, kmin, kmax);

  float k[HD], v[HD], dk[HD], dv[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) dk[c] = dv[c] = 0.f;
  if (sj >= 0) {
    const float* kj = row + j * d3 + d + h * HD;
#pragma unroll
    for (int c = 0; c < HD; ++c) {
      k[c] = kj[c];
      v[c] = kj[d + c];
    }
  }

  if (kmax >= 0) {  // the block holds a valid key
    for (int q0 = 0; q0 < W; q0 += BQ) {
      const int i = q0 + t;  // BQ == blockDim.x
      const int si = i < W ? srow[i] : -1;
      const bool meets = si >= kmin && si <= kmax;
      if (!__syncthreads_or(meets)) continue;
      ss[t] = si;
      if (si >= 0) {
        const long at = (r * W + i) * H + h;
        ms[t] = stat_m[at];
        lis[t] = 1.f / fmaxf(stat_l[at], 1e-16f);
        des[t] = delta[at];
      } else {
        ms[t] = lis[t] = des[t] = 0.f;
      }
      for (int idx = t; idx < BQ * HD; idx += BK) {
        const int ii = idx / HD, c = idx % HD;
        const bool in = q0 + ii < W;
        qs[idx] = in ? row[(long)(q0 + ii) * d3 + h * HD + c] * scale : 0.f;
        gs[idx] = in ? gout[(r * W + q0 + ii) * d + h * HD + c] : 0.f;
      }
      __syncthreads();
      if (sj >= 0) {
        for (int ii = 0; ii < BQ; ++ii) {
          if (ss[ii] != sj) continue;
          const float* qi = qs + ii * HD;
          const float* gi = gs + ii * HD;
          float s = 0.f, dp = 0.f;
#pragma unroll
          for (int c = 0; c < HD; ++c) {
            s = fmaf(qi[c], k[c], s);
            dp = fmaf(gi[c], v[c], dp);
          }
          const float p = expf(s - ms[ii]) * lis[ii];
          float pd = p;
          if (dr.on) {
            const bool kp = keep(dr, rh, q0 + ii, j);
            pd = kp ? p * dr.inv_keep : 0.f;
            dp = kp ? dp * dr.inv_keep : 0.f;
          }
          const float ds = p * (dp - des[ii]);
#pragma unroll
          for (int c = 0; c < HD; ++c) {
            dk[c] = fmaf(ds, qi[c], dk[c]);  // q * scale: d s / d k
            dv[c] = fmaf(pd, gi[c], dv[c]);
          }
        }
      }
      __syncthreads();
    }
  }
  if (j < W) {
    float* dkj = dqkv + (r * W + j) * d3 + d + h * HD;
#pragma unroll
    for (int c = 0; c < HD; ++c) {
      dkj[c] = dk[c];
      dkj[d + c] = dv[c];
    }
  }
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
  const float scale = 1.f / sqrtf(32.f);
  dim3 qgrid(R, H, (W + BQ - 1) / BQ);
  flash_hil_dq_kernel<32><<<qgrid, BQ, 0, stream>>>(
      qkv, seg, out, gout, stat_m, stat_l, delta, dqkv, W, d, scale, dr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 kgrid(R, H, (W + BK - 1) / BK);
  flash_hil_dkv_kernel<32><<<kgrid, BK, 0, stream>>>(
      qkv, seg, gout, stat_m, stat_l, delta, dqkv, W, d, scale, dr);
  return cudaGetLastError();
}
