// K10: one post-norm transformer encoder layer on graph-packed rows, the
// products, LayerNorms, dropouts and residuals of its forward and backward.
// Wrapper, plain version and design note:
// graphtrans_tpu_torch/ops/kernels/transformer_layer.py, which chains these
// launches with K4's attention kernels (attention_packed.cu) between them.
//
// Three kinds of kernel, each launched by a C entry below:
// - layer_gemm: C = op(A) op(B) in f32 on a 128 x 128 tile a block, 8 deep,
//   256 threads of 8 x 8 outputs, the tiles double-buffered in shared memory
//   through registers. A is [M, K] or (transposed) [K, M]; B is [K, N] or
//   (transposed, nn.Linear's [out, in]) [N, K]. Its epilogue adds a bias,
//   takes relu, drops out, adds a residual, or masks by relu's derivative.
//   A weight gradient (A transposed, K = every row of the batch) splits K
//   over gridDim.z blocks that each write their own partial product; the
//   partials are summed in a fixed order (layer_sum): no atomics, so a run
//   gives the same bits every time.
// - layer_norm_fwd / layer_norm_bwd: a warp a row of d = 128 * V columns
//   (V float4s a lane), the reference's fast variance max(E[h^2] - mu^2, 0)
//   and eps. The backward also drops out its result for the next product
//   and sums, per block and then in a fixed order, the columns of the
//   scale's and bias's gradients and of the dropped result (a bias grad).
// - layer_colsum: per-block column sums of a [M, N] gradient (a bias grad),
//   summed in a fixed order by layer_sum.
//
// Dropout (K10's streams, graphtrans_tpu/ops/pallas/transformer_layer.py):
// element (m, c) of a [M, width] tensor whose rows are r*S + t keeps iff
// hash(((r % 8)*S + t)*width + c, seed + (r / 8)*stride) < thresh, where
// seed carries the stream's offset (H, H + 1, H + 2) and stride = H + 3.

#include <cuda_runtime.h>
#include <math.h>

#include "hash.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 8, THREADS = 256;
constexpr int TILE_ROWS = 8;  // packed rows a tile of the reference (BT)

struct Drop {
  int on;            // 0: rate 0, the identity
  unsigned thresh;   // keep iff bits < thresh
  float inv_keep;    // 1 / (1 - rate)
  unsigned seed;     // the layer's seed plus the stream's offset
  int S;             // tokens a packed row
  int stride;        // seeds a tile of TILE_ROWS rows: H + 3

  __device__ bool keep(long m, int c, int width) const {
    const long r = m / S;
    const unsigned t = (unsigned)(m - r * S);
    const unsigned pos =
        ((unsigned)(r % TILE_ROWS) * S + t) * (unsigned)width + c;
    return prng::hash_bits(pos, seed + (unsigned)(r / TILE_ROWS) * stride) <
           thresh;
  }
  __device__ float apply(float v, long m, int c, int width) const {
    return on ? (keep(m, c, width) ? v * inv_keep : 0.f) : v;
  }
};

enum Epi {
  EPI_NONE = 0,       // C = acc
  EPI_BIAS = 1,       // C = acc + bias
  EPI_BIAS_DROP_RES,  // C = res + drop(acc + bias)
  EPI_BIAS_RELU_DROP, // C = drop(relu(acc + bias))
  EPI_RES,            // C = acc + res
  EPI_DRELU,          // C = res > 0 ? acc / (1 - rate) : 0 (res: the dropped
                      // relu output; the scale only with dropout on)
};

template <int EPI>
__device__ __forceinline__ float epilogue(float acc, long m, int n, int N,
                                          const float* __restrict__ bias,
                                          const float* __restrict__ res,
                                          const Drop& dr) {
  if (EPI == EPI_BIAS) return acc + bias[n];
  if (EPI == EPI_BIAS_DROP_RES)
    return res[m * N + n] + dr.apply(acc + bias[n], m, n, N);
  if (EPI == EPI_BIAS_RELU_DROP)
    return dr.apply(fmaxf(acc + bias[n], 0.f), m, n, N);
  if (EPI == EPI_RES) return acc + res[m * N + n];
  if (EPI == EPI_DRELU)
    return res[m * N + n] > 0.f ? (dr.on ? acc * dr.inv_keep : acc) : 0.f;
  return acc;
}

// C [M, N] = sum over k in this block's split of A(i, k) B(k, j), with
// A(i, k) = AT ? A[k*M + i] : A[i*K + k] and B(k, j) = BT ? B[j*K + k] :
// B[k*N + j]; split z (blockIdx.z) covers k in [z*kchunk, (z+1)*kchunk)
// and writes C + z*M*N.
template <bool AT, bool BT, int EPI>
__global__ void __launch_bounds__(THREADS)
layer_gemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
                  float* __restrict__ C, int M, int N, int K, int kchunk,
                  const float* __restrict__ bias,
                  const float* __restrict__ res, Drop dr) {
  __shared__ float4 As4[2][BK][BM / 4];
  __shared__ float4 Bs4[2][BK][BN / 4];

  const int t = threadIdx.x;
  const long m0 = (long)blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * kchunk;
  const int kend = min(K, kbeg + kchunk);
  C += (long)blockIdx.z * M * N;

  // the four elements of the A and B tiles this thread loads
  const int a_i = AT ? (t & 31) * 4 : t >> 1;   // first row of the tile
  const int a_k = AT ? t >> 5 : (t & 1) * 4;    // first k of the tile
  const int b_j = BT ? t >> 1 : (t & 31) * 4;
  const int b_k = BT ? (t & 1) * 4 : t >> 5;
  float ra[4], rb[4];

  auto load = [&](int k0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long i = m0 + a_i + (AT ? q : 0);
      const int k = k0 + a_k + (AT ? 0 : q);
      ra[q] = (i < M && k < kend) ? (AT ? A[(long)k * M + i] : A[i * K + k])
                                  : 0.f;
      const int j = n0 + b_j + (BT ? 0 : q);
      const int kb = k0 + b_k + (BT ? q : 0);
      rb[q] = (j < N && kb < kend)
                  ? (BT ? B[(long)j * K + kb] : B[(long)kb * N + j])
                  : 0.f;
    }
  };
  auto store = [&](int buf) {
    float* As = reinterpret_cast<float*>(As4[buf]);
    float* Bs = reinterpret_cast<float*>(Bs4[buf]);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      As[(a_k + (AT ? 0 : q)) * BM + a_i + (AT ? q : 0)] = ra[q];
      Bs[(b_k + (BT ? q : 0)) * BN + b_j + (BT ? 0 : q)] = rb[q];
    }
  };

  const int tx = t & 15, ty = t >> 4;  // columns tx*4 (+64), rows ty*4 (+64)
  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;

  int buf = 0;
  if (kbeg < kend) {
    load(kbeg);
    store(0);
  }
  __syncthreads();
  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    const bool more = k0 + BK < kend;
    if (more) load(k0 + BK);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = As4[buf][k][ty], a1 = As4[buf][k][16 + ty];
      const float4 b0 = Bs4[buf][k][tx], b1 = Bs4[buf][k][16 + tx];
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
    if (more) store(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const long m = m0 + (a < 4 ? ty * 4 + a : 64 + ty * 4 + a - 4);
    if (m >= M) continue;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int n = n0 + (b < 4 ? tx * 4 + b : 64 + tx * 4 + b - 4);
      if (n < N)
        C[m * N + n] = epilogue<EPI>(acc[a][b], m, n, N, bias, res, dr);
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// y = xhat * scale + bias with xhat = (h - mu) * rsqrt(max(E[h^2] - mu^2, 0)
// + eps); a warp a row. xhat and iv are written where given (training).
template <int V>
__global__ void layer_norm_fwd_kernel(const float* __restrict__ h,
                                      const float* __restrict__ scale,
                                      const float* __restrict__ bias,
                                      float* __restrict__ y,
                                      float* __restrict__ xhat,
                                      float* __restrict__ iv, long M,
                                      float eps) {
  constexpr int D = 128 * V;
  const long row = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const float4* hr = reinterpret_cast<const float4*>(h + row * D);
  float4 v[V];
  float s = 0.f, sq = 0.f;
#pragma unroll
  for (int q = 0; q < V; ++q) {
    v[q] = hr[lane + 32 * q];
    s += (v[q].x + v[q].y) + (v[q].z + v[q].w);
    sq += (v[q].x * v[q].x + v[q].y * v[q].y) +
          (v[q].z * v[q].z + v[q].w * v[q].w);
  }
  s = warp_sum(s);
  sq = warp_sum(sq);
  const float mu = s / D;
  const float r = rsqrtf(fmaxf(sq / D - mu * mu, 0.f) + eps);
  const float4* sc = reinterpret_cast<const float4*>(scale);
  const float4* bi = reinterpret_cast<const float4*>(bias);
#pragma unroll
  for (int q = 0; q < V; ++q) {
    const int c4 = lane + 32 * q;
    const float4 a = sc[c4], b = bi[c4];
    float4 x;
    x.x = (v[q].x - mu) * r;
    x.y = (v[q].y - mu) * r;
    x.z = (v[q].z - mu) * r;
    x.w = (v[q].w - mu) * r;
    reinterpret_cast<float4*>(y + row * D)[c4] =
        make_float4(fmaf(x.x, a.x, b.x), fmaf(x.y, a.y, b.y),
                    fmaf(x.z, a.z, b.z), fmaf(x.w, a.w, b.w));
    if (xhat) reinterpret_cast<float4*>(xhat + row * D)[c4] = x;
  }
  if (iv && lane == 0) iv[row] = r;
}

constexpr int LN_WARPS = 8;  // warps a block of layer_norm_bwd_kernel

// dh = iv * (g - mean(g) - xhat * mean(g * xhat)) with g = dy * scale, and
// dd = drop(dh); per block the column sums of dy * xhat, dy and dd go to
// part[blockIdx.x][0..2][D]. A block takes rows [blockIdx.x * rows, ...),
// its warps in turn.
template <int V>
__global__ void __launch_bounds__(LN_WARPS * 32)
layer_norm_bwd_kernel(const float* __restrict__ dy,
                      const float* __restrict__ xhat,
                      const float* __restrict__ iv,
                      const float* __restrict__ scale,
                      float* __restrict__ dh, float* __restrict__ dd, long M,
                      int rows, Drop dr, float* __restrict__ part) {
  constexpr int D = 128 * V;
  extern __shared__ float red[];  // [LN_WARPS][3][D]
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long r0 = (long)blockIdx.x * rows;
  const long r1 = r0 + rows < M ? r0 + rows : M;
  float ps[4 * V], pb[4 * V], pd[4 * V], sc[4 * V];
#pragma unroll
  for (int q = 0; q < V; ++q) {
    const float4 a = reinterpret_cast<const float4*>(scale)[lane + 32 * q];
    sc[4 * q] = a.x;
    sc[4 * q + 1] = a.y;
    sc[4 * q + 2] = a.z;
    sc[4 * q + 3] = a.w;
  }
#pragma unroll
  for (int e = 0; e < 4 * V; ++e) ps[e] = pb[e] = pd[e] = 0.f;
  for (long m = r0 + w; m < r1; m += LN_WARPS) {
    float g[4 * V], x[4 * V];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const int c4 = lane + 32 * q;
      const float4 a = reinterpret_cast<const float4*>(dy + m * D)[c4];
      const float4 b = reinterpret_cast<const float4*>(xhat + m * D)[c4];
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ps[4 * q + e] = fmaf(av[e], bv[e], ps[4 * q + e]);
        pb[4 * q + e] += av[e];
        g[4 * q + e] = av[e] * sc[4 * q + e];
        x[4 * q + e] = bv[e];
        s1 += g[4 * q + e];
        s2 = fmaf(g[4 * q + e], bv[e], s2);
      }
    }
    s1 = warp_sum(s1) / D;
    s2 = warp_sum(s2) / D;
    const float r = iv[m];
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const int c4 = lane + 32 * q;
      float o[4], od[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[e] = r * (g[4 * q + e] - s1 - x[4 * q + e] * s2);
        od[e] = dr.apply(o[e], m, c4 * 4 + e, D);
        pd[4 * q + e] += od[e];
      }
      reinterpret_cast<float4*>(dh + m * D)[c4] =
          make_float4(o[0], o[1], o[2], o[3]);
      reinterpret_cast<float4*>(dd + m * D)[c4] =
          make_float4(od[0], od[1], od[2], od[3]);
    }
  }
#pragma unroll
  for (int q = 0; q < V; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = (lane + 32 * q) * 4 + e;
      red[(w * 3 + 0) * D + c] = ps[4 * q + e];
      red[(w * 3 + 1) * D + c] = pb[4 * q + e];
      red[(w * 3 + 2) * D + c] = pd[4 * q + e];
    }
  __syncthreads();
  for (int idx = threadIdx.x; idx < 3 * D; idx += blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < LN_WARPS; ++k) s += red[k * 3 * D + idx];
    part[(long)blockIdx.x * 3 * D + idx] = s;
  }
}

// part[blockIdx.y][n] = sum of x[m, n] over rows [blockIdx.y * rows, ...).
__global__ void layer_colsum_kernel(const float* __restrict__ x,
                                    float* __restrict__ part, long M, int N,
                                    int rows) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const long r0 = (long)blockIdx.y * rows;
  const long r1 = r0 + rows < M ? r0 + rows : M;
  float s = 0.f;
  for (long m = r0; m < r1; ++m) s += x[m * N + n];
  part[(long)blockIdx.y * N + n] = s;
}

// out[i] = sum over p in order of part[p*n + i].
__global__ void layer_sum_kernel(const float* __restrict__ part,
                                 float* __restrict__ out, int P, long n) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int p = 0; p < P; ++p) s += part[(long)p * n + i];
  out[i] = s;
}

template <bool AT, bool BT>
int launch_gemm(const float* A, const float* B, float* C, int M, int N, int K,
                int splits, int epi, const float* bias, const float* res,
                Drop dr, cudaStream_t stream) {
  const int kchunk = ((K + splits - 1) / splits + BK - 1) / BK * BK;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
#define LAUNCH(E)                                                           \
  layer_gemm_kernel<AT, BT, E><<<grid, THREADS, 0, stream>>>(              \
      A, B, C, M, N, K, kchunk, bias, res, dr)
  switch (epi) {
    case EPI_NONE: LAUNCH(EPI_NONE); break;
    case EPI_BIAS: LAUNCH(EPI_BIAS); break;
    case EPI_BIAS_DROP_RES: LAUNCH(EPI_BIAS_DROP_RES); break;
    case EPI_BIAS_RELU_DROP: LAUNCH(EPI_BIAS_RELU_DROP); break;
    case EPI_RES: LAUNCH(EPI_RES); break;
    case EPI_DRELU: LAUNCH(EPI_DRELU); break;
    default: return cudaErrorInvalidValue;
  }
#undef LAUNCH
  return cudaGetLastError();
}

Drop make_drop(int on, unsigned thresh, float inv_keep, int seed, int S,
               int stride) {
  Drop dr;
  dr.on = on;
  dr.thresh = thresh;
  dr.inv_keep = inv_keep;
  dr.seed = (unsigned)seed;
  dr.S = S;
  dr.stride = stride;
  return dr;
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// C = op(A) op(B) with the epilogue epi (enum Epi) over M x N outputs and a
// reduction of K; layout 0: A [M, K], B [N, K] (x W^T, nn.Linear's weight);
// 1: A [M, K], B [K, N] (dY W); 2: A [K, M], B [K, N] (dY^T X, a weight
// gradient) split over `splits` blocks of K, C then [splits, M, N] partials.
// (drop, thresh, inv_keep, seed, S, stride) define the epilogue's dropout.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int layer_gemm(const float* A, const float* B, float* C, int M,
                          int N, int K, int layout, int splits, int epi,
                          const float* bias, const float* res, int drop,
                          unsigned thresh, float inv_keep, int seed, int S,
                          int stride, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || splits <= 0 || (layout != 2 && splits > 1))
    return cudaErrorInvalidValue;
  const Drop dr = make_drop(drop, thresh, inv_keep, seed, S, stride);
  switch (layout) {
    case 0:
      return launch_gemm<false, true>(A, B, C, M, N, K, splits, epi, bias, res,
                                      dr, stream);
    case 1:
      return launch_gemm<false, false>(A, B, C, M, N, K, splits, epi, bias,
                                       res, dr, stream);
    case 2:
      return launch_gemm<true, false>(A, B, C, M, N, K, splits, epi, bias,
                                      res, dr, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// LayerNorm of h [M, d] rows (d = 128, 256, 384 or 512) into y; xhat [M, d]
// and iv [M] may be null (serving).
extern "C" int layer_norm_fwd(const float* h, const float* scale,
                              const float* bias, float* y, float* xhat,
                              float* iv, long M, int d, float eps,
                              cudaStream_t stream) {
  if (M <= 0 || (xhat == nullptr) != (iv == nullptr))
    return cudaErrorInvalidValue;
  const int threads = 256;
  const long blocks = (M * 32 + threads - 1) / threads;
  switch (d) {
#define CASE(V)                                                             \
  case 128 * V:                                                             \
    layer_norm_fwd_kernel<V><<<blocks, threads, 0, stream>>>(              \
        h, scale, bias, y, xhat, iv, M, eps);                               \
    break;
    CASE(1) CASE(2) CASE(3) CASE(4)
#undef CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// LayerNorm backward over `blocks` blocks of `rows` rows: dh, dd = drop(dh)
// ([M, d]), and out [3, d] = the column sums of dy * xhat, dy and dd (part
// [blocks, 3, d] is scratch, summed in order).
extern "C" int layer_norm_bwd(const float* dy, const float* xhat,
                              const float* iv, const float* scale, float* dh,
                              float* dd, float* part, float* out, long M,
                              int d, int blocks, int rows, int drop,
                              unsigned thresh, float inv_keep, int seed,
                              int S, int stride, cudaStream_t stream) {
  if (M <= 0 || blocks <= 0 || (long)blocks * rows < M)
    return cudaErrorInvalidValue;
  const Drop dr = make_drop(drop, thresh, inv_keep, seed, S, stride);
  const size_t smem = (size_t)LN_WARPS * 3 * d * sizeof(float);
  switch (d) {
#define CASE(V)                                                             \
  case 128 * V: {                                                           \
    cudaError_t err = cudaFuncSetAttribute(                                 \
        layer_norm_bwd_kernel<V>,                                           \
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);            \
    if (err != cudaSuccess) return err;                                     \
    layer_norm_bwd_kernel<V><<<blocks, LN_WARPS * 32, smem, stream>>>(      \
        dy, xhat, iv, scale, dh, dd, M, rows, dr, part);                    \
    break;                                                                  \
  }
    CASE(1) CASE(2) CASE(3) CASE(4)
#undef CASE
    default:
      return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  layer_sum_kernel<<<(3 * d + 255) / 256, 256, 0, stream>>>(part, out, blocks,
                                                           3L * d);
  return cudaGetLastError();
}

// out [N] = the column sums of x [M, N], over `blocks` blocks of `rows`
// rows (part [blocks, N] is scratch, summed in order).
extern "C" int layer_colsum(const float* x, float* part, float* out, long M,
                            int N, int blocks, int rows, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || blocks <= 0 || (long)blocks * rows < M)
    return cudaErrorInvalidValue;
  dim3 grid((N + 255) / 256, blocks);
  layer_colsum_kernel<<<grid, 256, 0, stream>>>(x, part, M, N, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  layer_sum_kernel<<<(N + 255) / 256, 256, 0, stream>>>(part, out, blocks, N);
  return cudaGetLastError();
}

// out [n] = the sum over P of part [P, n], in order (a split product's).
extern "C" int layer_sum(const float* part, float* out, int P, long n,
                         cudaStream_t stream) {
  if (P <= 0 || n <= 0) return cudaErrorInvalidValue;
  layer_sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(part, out,
                                                                    P, n);
  return cudaGetLastError();
}
