// K10: one post-norm transformer encoder layer on graph-packed rows, the
// products, LayerNorms, dropouts and residuals of its forward and backward.
// Wrapper, plain version and design note:
// graphtrans_tpu_torch/ops/kernels/transformer_layer.py, which chains these
// launches with K4's attention kernels (attention_packed.cu) between them.
//
// Three kinds of kernel, each launched by a C entry below:
// - layer_gemm: C = op(A) op(B) with f32 accuracy on the tensor cores. A is
//   [M, K] or (transposed) [K, M]; B is [K, N] or (transposed, nn.Linear's
//   [out, in]) [N, K]. Its epilogue adds a bias, takes relu, drops out, adds
//   a residual, or masks by relu's derivative. A weight gradient (A
//   transposed, K = every row of the batch) splits K over gridDim.z blocks
//   that each write their own partial product; the partials are summed in a
//   fixed order (layer_sum): no atomics, so a run gives the same bits every
//   time. What bounds it: operations. At 4096 molecules ([1366, 99, 256],
//   ff 512) the forward's four products are 141.8 GFLOP: 2.12 ms at the f32
//   SIMT peak (67 TFLOP/s), 0.86 ms as 3xTF32 at the TF32 tensor-core peak
//   (495 TFLOP/s, three passes). The design: a block of 4 warps takes a
//   128 x 64 tile of C, a warp 64 x 32 of it (4 x 4 m16n8 tiles, 64
//   accumulators a thread and 64 more for the current slice's sums); the
//   K dimension passes in slices of BK = 32 through a ring of 3 stages in
//   dynamic shared memory (90 KB at most, 30 KB a stage), filled by
//   16-byte cp.async copies (ragged rows and columns zero-filled) while the
//   block multiplies an earlier stage. Tiles are kept in the global layout,
//   their rows padded (40, 132 or 68 floats) so that the fragment loads of
//   a half-warp hit different banks. Each product is mma.sync m16n8k8 in
//   3xTF32 (mma_tf32.cuh: every operand split into a TF32 high part and a
//   TF32 remainder, three products summed in f32; single-pass TF32 would
//   lose f32 accuracy), and a slice's sums reach the accumulators through
//   f32 adds (the tensor cores' own adds truncate). Two blocks share an SM,
//   so one's barriers and epilogue overlap the other's products. What it
//   replaces: a 128 x 128 x 8 f32 SIMT tile, double-buffered through
//   registers, that took 5.2 of K10's 5.98 ms.
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
#include "mma_tf32.cuh"

namespace {

// layer_gemm: a BM x BN tile of C a block of THREADS, K in slices of BK
constexpr int BM = 128, BN = 64, BK = 32, THREADS = 128;
constexpr int STAGES = 3;      // the ring of shared stages of layer_gemm
constexpr int MIN_BLOCKS = 2;  // blocks an SM
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

// x = hi + lo, both TF32, rounded to nearest with ties away from zero (as
// cvt.rna rounds finite values, tc::split): hi by adding half a TF32 ulp to
// the bits and clearing the 13 below it, lo likewise from x - hi, exact in
// f32. Integer adds and masks take fewer instructions than cvt.rna.
__device__ __forceinline__ void split_rna(float x, unsigned& hi,
                                          unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// A stage of the ring: the A tile (128 rows), then the B tile (64). A tile
// whose rows run along k ([rows][BK + 8]: A [M, K] or B [N, K]) has a
// stride of 40 floats (8 mod 32 banks); one whose rows are k ([BK][cols +
// 4]: A [K, M] or B [K, N]) of 132 or 68 (4 mod 32). The fragment loads
// take k = 2q and 2q + 1 where the mma's k slots are q and q + 4 (both
// operands alike, so the sum over the eight k is unchanged): one 8-byte
// load a row where rows run along k. Either way the lanes of a half-warp
// hit different banks.
__host__ __device__ constexpr int ld_of(bool krows, int rows) {
  return krows ? rows + 4 : BK + 8;
}
__host__ __device__ constexpr int tile_floats(bool krows, int rows) {
  return krows ? BK * (rows + 4) : rows * (BK + 8);
}
__host__ __device__ constexpr int gemm_bytes(bool at, bool bt) {
  return STAGES * (tile_floats(at, BM) + tile_floats(!bt, BN)) * 4;
}

// Stages a ROWS x BK tile of P with 16-byte cp.async copies: with KROWS the
// BK rows k0.. of P [K, X] (columns x0..), else the rows x0.. of P [X, K]
// (k0..). Chunks outside [0, X) x [k0, kend) are zero-filled (X and, for
// rows along k, K are multiples of 4, so a chunk is wholly in or out).
template <bool KROWS, int ROWS>
__device__ __forceinline__ void stage_tile(float* dst,
                                           const float* __restrict__ P,
                                           long X, int K, long x0, int k0,
                                           int kend) {
  constexpr int LD = ld_of(KROWS, ROWS), CHUNKS = ROWS * BK / 4;
#pragma unroll
  for (int q = 0; q < CHUNKS / THREADS; ++q) {
    const int idx = threadIdx.x + q * THREADS;
    if (KROWS) {  // BK rows of ROWS / 4 chunks
      const int r = idx / (ROWS / 4), c = idx % (ROWS / 4) * 4;
      const bool ok = k0 + r < kend && x0 + c < X;
      tc::cp16(dst + r * LD + c, ok ? P + (long)(k0 + r) * X + x0 + c : P,
               ok);
    } else {      // ROWS rows of BK / 4 chunks
      const int r = idx >> 3, c = (idx & 7) * 4;
      const bool ok = x0 + r < X && k0 + c < kend;
      tc::cp16(dst + r * LD + c, ok ? P + (x0 + r) * (long)K + k0 + c : P,
               ok);
    }
  }
}

// C [M, N] = sum over k in this block's split of A(i, k) B(k, j), with
// A(i, k) = AT ? A[k*M + i] : A[i*K + k] and B(k, j) = BT ? B[j*K + k] :
// B[k*N + j]; split z (blockIdx.z) covers k in [z*kchunk, (z+1)*kchunk)
// and writes C + z*M*N. A block takes a BM x BN tile of C; warp w its
// 64 x 32 sub-tile at rows (w % 2) * 64, columns (w / 2) * 32, as 4 x 4
// m16n8 accumulator tiles. The BK-deep slices of A and B pass through a
// ring of STAGES shared stages: while the block multiplies one, the
// cp.async copies of the next STAGES - 1 are in flight, and the other
// block on the SM multiplies or writes its tile. Each product is 3xTF32
// (tc::mma3). A slice's twelve mma.sync sum into tiles of their own,
// which are then added to the accumulators with f32 adds: the tensor cores
// align and add their terms without rounding (toward zero), an error of up
// to an ulp of the running sum each mma that grows with K when every mma
// lands on the running sum (3 K / 8 of them) and stays at f32's level when
// only K / 32 rounded adds do.
template <bool AT, bool BT, int EPI>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
layer_gemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
                  float* __restrict__ C, int M, int N, int K, int kchunk,
                  const float* __restrict__ bias,
                  const float* __restrict__ res, Drop dr) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  constexpr int A_FLOATS = tile_floats(AT, BM);
  constexpr int STAGE = A_FLOATS + tile_floats(!BT, BN);
  constexpr int LDA = ld_of(AT, BM), LDB = ld_of(!BT, BN);

  const int t = threadIdx.x, w = t >> 5;
  const long m0 = (long)blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * kchunk;
  const int kend = min(K, kbeg + kchunk);
  const int nk = kbeg < kend ? (kend - kbeg + BK - 1) / BK : 0;
  C += (long)blockIdx.z * M * N;

  auto load = [&](int st, int kt) {
    float* s = smem + st * STAGE;
    const int k0 = kbeg + kt * BK;
    stage_tile<AT, BM>(s, A, M, K, m0, k0, kend);
    stage_tile<!BT, BN>(s + A_FLOATS, B, N, K, n0, k0, kend);
  };

  // lane 4 g + q: A(m, k) rows g and g + 8, B(k, n) column g, k = 2q and
  // 2q + 1 in the mma's k slots q and q + 4
  const int wm = (w & 1) * 64, wn = (w >> 1) * 32;
  const int g = (t & 31) >> 2, q = t & 3;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load(st, st);
    tc::cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    tc::cp_wait_group<STAGES - 2>();  // slice kt has landed
    __syncthreads();  // ... for every thread, and slice kt - 1 is consumed
    if (kt + STAGES - 1 < nk) load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    tc::cp_commit();
    const float* As = smem + (kt % STAGES) * STAGE;
    const float* Bs = As + A_FLOATS;
    float part[4][4][4];  // the slice's sums, added to acc in f32 at its end
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      unsigned bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // B(k, n): Bs[n][k] or Bs[k][n]
        const int n = wn + 8 * j + g;
        float2 v;
        if (BT) {
          v = *reinterpret_cast<const float2*>(Bs + n * LDB + kk + 2 * q);
        } else {
          v.x = Bs[(kk + 2 * q) * LDB + n];
          v.y = Bs[(kk + 2 * q + 1) * LDB + n];
        }
        split_rna(v.x, bh[j][0], bl[j][0]);
        split_rna(v.y, bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // A(m, k): As[k][m] or As[m][k]
        const int m = wm + 16 * i + g;
        float a[4];  // (m, 2q), (m + 8, 2q), (m, 2q + 1), (m + 8, 2q + 1)
        if (AT) {
          const float* p = As + (kk + 2 * q) * LDA + m;
          a[0] = p[0];
          a[1] = p[8];
          a[2] = p[LDA];
          a[3] = p[LDA + 8];
        } else {
          const float2 v0 =
              *reinterpret_cast<const float2*>(As + m * LDA + kk + 2 * q);
          const float2 v1 = *reinterpret_cast<const float2*>(
              As + (m + 8) * LDA + kk + 2 * q);
          a[0] = v0.x;
          a[1] = v1.x;
          a[2] = v0.y;
          a[3] = v1.y;
        }
        unsigned ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_rna(a[e], ah[e], al[e]);
#pragma unroll
        for (int j = 0; j < 4; ++j) tc::mma3(part[i][j], ah, al, bh[j], bl[j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }

  // lane 4 g + q holds (g, 2q), (g, 2q + 1), (g + 8, 2q), (g + 8, 2q + 1) of
  // each m16n8 tile of C; N % 4 == 0, so n < N implies n + 1 < N
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long m = m0 + wm + 16 * i + g + 8 * r;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + 8 * j + 2 * q;
        if (n >= N) continue;
        *reinterpret_cast<float2*>(C + m * N + n) = make_float2(
            epilogue<EPI>(acc[i][j][2 * r], m, n, N, bias, res, dr),
            epilogue<EPI>(acc[i][j][2 * r + 1], m, n + 1, N, bias, res, dr));
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

// One instance's launch; its shared-memory limit is raised once, before its
// first launch (two blocks an SM need the SM's whole shared carveout).
template <bool AT, bool BT, int EPI>
cudaError_t launch_epi(dim3 grid, const float* A, const float* B, float* C,
                       int M, int N, int K, int kchunk, const float* bias,
                       const float* res, Drop dr, cudaStream_t stream) {
  constexpr int smem = gemm_bytes(AT, BT);
  static const cudaError_t set = [] {
    cudaError_t e = cudaFuncSetAttribute(
        layer_gemm_kernel<AT, BT, EPI>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(layer_gemm_kernel<AT, BT, EPI>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
  }();
  if (set != cudaSuccess) return set;
  layer_gemm_kernel<AT, BT, EPI><<<grid, THREADS, smem, stream>>>(
      A, B, C, M, N, K, kchunk, bias, res, dr);
  return cudaGetLastError();
}

template <bool AT, bool BT>
int launch_gemm(const float* A, const float* B, float* C, int M, int N, int K,
                int splits, int epi, const float* bias, const float* res,
                Drop dr, cudaStream_t stream) {
  const int kchunk = ((K + splits - 1) / splits + BK - 1) / BK * BK;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
#define LAUNCH(E)                                                           \
  return launch_epi<AT, BT, E>(grid, A, B, C, M, N, K, kchunk, bias, res,  \
                               dr, stream)
  switch (epi) {
    case EPI_NONE: LAUNCH(EPI_NONE);
    case EPI_BIAS: LAUNCH(EPI_BIAS);
    case EPI_BIAS_DROP_RES: LAUNCH(EPI_BIAS_DROP_RES);
    case EPI_BIAS_RELU_DROP: LAUNCH(EPI_BIAS_RELU_DROP);
    case EPI_RES: LAUNCH(EPI_RES);
    case EPI_DRELU: LAUNCH(EPI_DRELU);
    default: return cudaErrorInvalidValue;
  }
#undef LAUNCH
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
  // 16-byte cp.async copies and float2 stores: every row of A, B, C and res
  // starts 16-byte aligned, and a row's contiguous length is a multiple of 4
  const auto aligned = [](const float* p) {
    return reinterpret_cast<unsigned long long>(p) % 16 == 0;
  };
  if (!aligned(A) || !aligned(B) || !aligned(C) || (res && !aligned(res)) ||
      N % 4 || (layout == 2 ? M % 4 : K % 4))
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
