// K5: attention over long unpacked rows with a key-padding or segment mask,
// streaming the keys in tiles with an online softmax; forward. Wrapper,
// plain version and design note:
// graphtrans_tpu_torch/ops/kernels/flash_attention.py.
//
// qkv [B, S, 3d] (heads in lanes), segq, segk [B, S] int32 -> out [B, S, d].
// Query i attends key j iff segq[i] == segk[j] >= 0 (the key-padding form
// is segq = 0, segk = valid ? 0 : -1); scale 1/sqrt(hd); the output is
// normalised by max(l, 1e-16), so a query with no key writes exact zeros.
// One block per (row, head, BQ queries), one thread per query: q and the
// output accumulator (HD floats each) stay in registers. The keys stream
// through shared memory BK = 4096 / HD at a time (32 KB for K and V at
// every head width). A key tile none of whose keys any query of the block
// can attend is skipped whole (one __syncthreads_or): in a graph's row the
// valid keys are a prefix plus the CLS column, so at code2's mean graph
// size most tiles of a 1001-wide row are skipped, exactly, for any mask.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 128;  // queries a block (= threads)

// Fills lo/hi with the min and max of the block's tags that are >= 0 (none:
// hi < 0). All threads of the block call it.
__device__ __forceinline__ void block_range(int tag, int* range, int& lo,
                                            int& hi) {
  if (threadIdx.x == 0) {
    range[0] = 0x7fffffff;
    range[1] = -1;
  }
  __syncthreads();
  if (tag >= 0) {
    atomicMin(&range[0], tag);
    atomicMax(&range[1], tag);
  }
  __syncthreads();
  lo = range[0];
  hi = range[1];
}

template <int HD>
__global__ void __launch_bounds__(BQ)
flash_attention_fwd_kernel(const float* __restrict__ qkv,
                           const int* __restrict__ segq,
                           const int* __restrict__ segk,
                           float* __restrict__ out, int S, int d,
                           float scale) {
  constexpr int BK = 4096 / HD;  // keys a tile (<= BQ)
  __shared__ float4 ks4[BK * HD / 4];
  __shared__ float4 vs4[BK * HD / 4];
  __shared__ int ss[BK];
  __shared__ int qrange[2];
  const float* ks = reinterpret_cast<const float*>(ks4);
  const float* vs = reinterpret_cast<const float*>(vs4);

  const long b = blockIdx.x;
  const int h = blockIdx.y;
  const int t = threadIdx.x;
  const int i = blockIdx.z * BQ + t;
  const long d3 = 3L * d;
  const float* row = qkv + b * S * d3;
  const int* krow = segk + b * S;

  const int si = i < S ? segq[b * S + i] : -1;
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

  if (qmax >= 0) {  // the block holds a query that can attend something
    for (int k0 = 0; k0 < S; k0 += BK) {
      const int j = k0 + t;
      const int sj = (t < BK && j < S) ? krow[j] : -1;
      const bool meets = sj >= qmin && sj <= qmax;  // qmin >= 0
      if (!__syncthreads_or(meets)) continue;  // uniform: no pair in the tile
      if (t < BK) ss[t] = sj;
      // K_h and V_h of the tile, 16 bytes a load (HD and d are multiples
      // of 32, so every row offset is 16-byte aligned)
      for (int idx = t; idx < BK * HD / 4; idx += BQ) {
        const int jj = idx / (HD / 4), c4 = idx % (HD / 4);
        float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
        if (k0 + jj < S) {
          const float* kr = row + (long)(k0 + jj) * d3 + d + h * HD;
          kv = reinterpret_cast<const float4*>(kr)[c4];
          vv = reinterpret_cast<const float4*>(kr + d)[c4];
        }
        ks4[idx] = kv;
        vs4[idx] = vv;
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
          const float* vj = vs + jj * HD;
#pragma unroll
          for (int c = 0; c < HD; ++c) o[c] = fmaf(p, vj[c], o[c]);
        }
      }
      __syncthreads();  // the tile is overwritten next
    }
  }
  if (i < S) {
    const float inv = 1.f / fmaxf(l, 1e-16f);
    float* oi = out + (b * S + i) * d + h * HD;
#pragma unroll
    for (int c = 0; c < HD; ++c) oi[c] = o[c] * inv;
  }
}

template <int HD>
int launch_fwd(const float* qkv, const int* segq, const int* segk,
               float* out, int B, int S, int d, int H, cudaStream_t stream) {
  dim3 grid(B, H, (S + BQ - 1) / BQ);
  flash_attention_fwd_kernel<HD><<<grid, BQ, 0, stream>>>(
      qkv, segq, segk, out, S, d, 1.f / sqrtf((float)HD));
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Returns cudaGetLastError() after the launch (0 = launched). Heads of
// width 32, 64 or 128.
extern "C" int flash_attention_fwd(const float* qkv, const int* segq,
                                   const int* segk, float* out, int B, int S,
                                   int d, int H, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || H <= 0 || d % H) return cudaErrorInvalidValue;
  switch (d / H) {
    case 32:
      return launch_fwd<32>(qkv, segq, segk, out, B, S, d, H, stream);
    case 64:
      return launch_fwd<64>(qkv, segq, segk, out, B, S, d, H, stream);
    case 128:
      return launch_fwd<128>(qkv, segq, segk, out, B, S, d, H, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
