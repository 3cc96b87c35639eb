// K7: the flat-layout message-passing sum over dst-sorted edges, and its
// backward (below spmm_kernel). Wrapper, plain version and design note:
// graphtrans_tpu_torch/ops/kernels/spmm.py.
//
// out[i] = sum_{e in [ptr[i], ptr[i+1])} w[e] * msg(x[src[e]], emb[e]),
// msg = relu(x + emb) or x + emb. x [N, d], emb [E, d] f32; src [E] and the
// CSR row pointer ptr [N+1] (from the dst-sorted edges) int32; w [E] f32
// with the edge mask folded in.
//
// One warp per destination row. The warp walks its row's edge range in
// order, 32 * GROUPS edges at a time: each lane loads the src and weight of
// GROUPS edges at once (all in flight together), then per group of 32 a
// ballot keeps the edges of nonzero weight, and the warp visits them one
// by one with the lanes striding over the channels (CPL channels a lane in
// registers, coalesced 128-byte row reads of x[src] and emb). Every output
// row has one writer and a fixed order of terms: no atomics,
// deterministic. Masked edges (weight 0: the padding tail of a batch, tens
// of thousands on the padding node's row) cost one wide load step per 256.

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int GROUPS = 8;  // 32-edge groups whose src and weight load at once

template <int CPL>
__global__ void spmm_kernel(const float* __restrict__ x,
                            const float* __restrict__ emb,
                            const int* __restrict__ src,
                            const int* __restrict__ ptr,
                            const float* __restrict__ w,
                            float* __restrict__ out, int N, int d, int relu) {
  const long row = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= N) return;  // the whole warp leaves together
  const int beg = ptr[row], end = ptr[row + 1];
  for (int c0 = 0; c0 < d; c0 += 32 * CPL) {
    float acc[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) acc[j] = 0.f;
    for (int e0 = beg; e0 < end; e0 += 32 * GROUPS) {
      float we[GROUPS];
      int se[GROUPS];
#pragma unroll
      for (int u = 0; u < GROUPS; ++u) {
        const int e = e0 + 32 * u + lane;
        we[u] = e < end ? w[e] : 0.f;
        se[u] = e < end ? src[e] : 0;
      }
#pragma unroll
      for (int u = 0; u < GROUPS; ++u) {
        unsigned live = __ballot_sync(FULL, we[u] != 0.f);
        while (live) {
          const int k = __ffs(live) - 1;
          live &= live - 1;
          const float wk = __shfl_sync(FULL, we[u], k);
          const long sk = __shfl_sync(FULL, se[u], k);
          const float* xr = x + sk * d;
          const float* er = emb + (long)(e0 + 32 * u + k) * d;
#pragma unroll
          for (int j = 0; j < CPL; ++j) {
            const int c = c0 + lane + 32 * j;
            if (c < d) {
              float m = xr[c] + er[c];
              if (relu) m = fmaxf(m, 0.f);
              acc[j] += __fmul_rn(m, wk);  // rounded product, as the plain version
            }
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = c0 + lane + 32 * j;
      if (c < d) out[row * d + c] = acc[j];
    }
  }
}

// Backward: with a_e = x[src_e] + emb_e and g = dOut,
//   gate_e = w_e * 1[a_e > 0] * g[dst_e]   (relu_add; w_e * g[dst_e] for add),
//   d_emb[e] = gate_e,   dx[s] = sum_{src_e = s} gate_e.
// Warps [0, N) are source rows: warp s walks its edges in src-major order
// (perm, sptr: a stable sort of the valid edges by src, from the wrapper),
// holds x[s] and the dx accumulators in registers, and writes d_emb of its
// edges of nonzero weight (one writer each) and dx[s] (one writer, a fixed
// order). Warps [N, N + ceil(E/32)) each take 32 edge slots and write the
// zero d_emb rows of those of weight 0 (the masked padding tail and any
// edge the weight kills): no source row's warp walks them. No atomics.
template <int CPL>
__global__ void spmm_bwd_kernel(const float* __restrict__ x,
                                const float* __restrict__ emb,
                                const int* __restrict__ dst,
                                const int* __restrict__ perm,
                                const int* __restrict__ sptr,
                                const float* __restrict__ w,
                                const float* __restrict__ g,
                                float* __restrict__ dx,
                                float* __restrict__ demb, int N, int E, int d,
                                int relu) {
  const long warp = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= N) {  // edge-slot warps: zero rows for edges of weight 0
    const long e0 = (warp - N) * 32;
    if (e0 >= E) return;
    const long e = e0 + lane;
    unsigned dead = __ballot_sync(FULL, e < E && w[e] == 0.f);
    while (dead) {
      const int k = __ffs(dead) - 1;
      dead &= dead - 1;
      float* row = demb + (e0 + k) * d;
      for (int c = lane; c < d; c += 32) row[c] = 0.f;
    }
    return;
  }
  const long s = warp;
  const int beg = sptr[s], end = sptr[s + 1];
  for (int c0 = 0; c0 < d; c0 += 32 * CPL) {
    float xs[CPL], acc[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = c0 + lane + 32 * j;
      xs[j] = (c < d && beg < end) ? x[s * d + c] : 0.f;
      acc[j] = 0.f;
    }
    for (int k0 = beg; k0 < end; k0 += 32 * GROUPS) {
      int pe[GROUPS], de[GROUPS];
      float we[GROUPS];
#pragma unroll
      for (int u = 0; u < GROUPS; ++u) {
        const int k = k0 + 32 * u + lane;
        pe[u] = k < end ? perm[k] : 0;
      }
#pragma unroll
      for (int u = 0; u < GROUPS; ++u) {
        const bool in = k0 + 32 * u + lane < end;
        we[u] = in ? w[pe[u]] : 0.f;
        de[u] = in ? dst[pe[u]] : 0;
      }
#pragma unroll
      for (int u = 0; u < GROUPS; ++u) {
        unsigned live = __ballot_sync(FULL, we[u] != 0.f);
        while (live) {
          const int k = __ffs(live) - 1;
          live &= live - 1;
          const float wk = __shfl_sync(FULL, we[u], k);
          const long ek = __shfl_sync(FULL, pe[u], k);
          const long dk = __shfl_sync(FULL, de[u], k);
          const float* er = emb + ek * d;
          const float* gr = g + dk * d;
          float* out = demb + ek * d;
#pragma unroll
          for (int j = 0; j < CPL; ++j) {
            const int c = c0 + lane + 32 * j;
            if (c < d) {
              float gate = __fmul_rn(gr[c], wk);  // as autograd rounds it
              if (relu && !(xs[j] + er[c] > 0.f)) gate = 0.f;
              out[c] = gate;
              acc[j] += gate;
            }
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = c0 + lane + 32 * j;
      if (c < d) dx[s * d + c] = acc[j];
    }
  }
}

template <int CPL>
int launch(const float* x, const float* emb, const int* src, const int* ptr,
           const float* w, float* out, int N, int d, int relu,
           cudaStream_t stream) {
  const int threads = 256;  // 8 rows a block
  const long blocks = ((long)N * 32 + threads - 1) / threads;
  spmm_kernel<CPL><<<(unsigned)blocks, threads, 0, stream>>>(
      x, emb, src, ptr, w, out, N, d, relu);
  return cudaGetLastError();
}

template <int CPL>
int launch_bwd(const float* x, const float* emb, const int* dst,
               const int* perm, const int* sptr, const float* w,
               const float* g, float* dx, float* demb, int N, int E, int d,
               int relu, cudaStream_t stream) {
  const int threads = 256;  // 8 warps a block
  const long warps = (long)N + (E + 31) / 32;
  const long blocks = (warps * 32 + threads - 1) / threads;
  spmm_bwd_kernel<CPL><<<(unsigned)blocks, threads, 0, stream>>>(
      x, emb, dst, perm, sptr, w, g, dx, demb, N, E, d, relu);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Returns cudaGetLastError() after the launch (0 = launched). relu = 1 for
// the relu_add message, 0 for add.
extern "C" int spmm_fwd(const float* x, const float* emb, const int* src,
                        const int* ptr, const float* w, float* out, int N,
                        int d, int relu, cudaStream_t stream) {
  if (N <= 0 || d <= 0) return cudaErrorInvalidValue;
  if (d <= 128) return launch<4>(x, emb, src, ptr, w, out, N, d, relu, stream);
  if (d <= 256) return launch<8>(x, emb, src, ptr, w, out, N, d, relu, stream);
  if (d <= 384)
    return launch<12>(x, emb, src, ptr, w, out, N, d, relu, stream);
  return launch<16>(x, emb, src, ptr, w, out, N, d, relu, stream);
}

// dx [N, d] and d_emb [E, d] for the cotangent g [N, d] of spmm_fwd's out.
// perm [E] lists the edges of each source row s at [sptr[s], sptr[s+1]),
// in a fixed order; edges in no row must have weight 0.
extern "C" int spmm_bwd(const float* x, const float* emb, const int* dst,
                        const int* perm, const int* sptr, const float* w,
                        const float* g, float* dx, float* demb, int N, int E,
                        int d, int relu, cudaStream_t stream) {
  if (N <= 0 || d <= 0 || E < 0) return cudaErrorInvalidValue;
  if (d <= 128)
    return launch_bwd<4>(x, emb, dst, perm, sptr, w, g, dx, demb, N, E, d,
                         relu, stream);
  if (d <= 256)
    return launch_bwd<8>(x, emb, dst, perm, sptr, w, g, dx, demb, N, E, d,
                         relu, stream);
  if (d <= 384)
    return launch_bwd<12>(x, emb, dst, perm, sptr, w, g, dx, demb, N, E, d,
                          relu, stream);
  return launch_bwd<16>(x, emb, dst, perm, sptr, w, g, dx, demb, N, E, d,
                        relu, stream);
}
