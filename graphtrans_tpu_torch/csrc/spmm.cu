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

#include "vec.cuh"

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
// The valid edges, in src-major order (perm, sptr: a stable sort by src,
// from the wrapper), are cut into runs of whole source rows (rptr, the
// wrapper's edge_runs: about RUN_COST units of work each, an edge counting
// EDGE_COST and a row one). Warps [0, nruns) each walk one run: the lanes
// load the src, dst and weight of 32 edges at once (through perm), then
// the warp takes U edges at a time, shuffles their indices to every lane
// and issues the g[dst], emb[e] and x[src] rows of all U before it uses
// any (VEC floats a load, VPL loads a lane a row), so U edges' rows are in
// flight together. It writes each edge's d_emb row (edges of nonzero
// weight), sums dx of the current row in registers in perm order, and
// writes a row's dx once when the walk passes it (zero for a row with no
// edge). Warps [nruns, nruns + ceil(E/32)) each take 32 edge slots and
// write the zero d_emb rows of those of weight 0 (the masked padding tail
// and any edge the weight kills): no run walks them. The weight is folded
// here (mask * ew), so the wrapper launches nothing before the kernel.
// Grid y: slices of 32 * VEC * VPL channels. One writer per output cell, a
// fixed order of terms (the parent design's: the same bits), no atomics.
using vio::load_vec;
using vio::store_vec;
using vio::Vec;

constexpr int BWD_THREADS = 256;  // 8 warps a block
constexpr int BWD_MAX_VPL = 4;    // loads a lane a row (spmm.py:bwd_launch)

template <int VEC, int VPL>
__global__ void __launch_bounds__(BWD_THREADS, 2)  // two blocks an SM
spmm_bwd_kernel(const float* __restrict__ x, const float* __restrict__ emb,
                const int* __restrict__ src, const int* __restrict__ dst,
                const int* __restrict__ perm, const int* __restrict__ sptr,
                const int* __restrict__ rptr, const bool* __restrict__ emask,
                const float* __restrict__ ew, const float* __restrict__ g,
                float* __restrict__ dx,
                float* __restrict__ demb, int E, int d, int nruns, int relu) {
  using V = Vec<VEC>;
  constexpr int U = VEC * VPL <= 8 ? 4 : 2;  // edges whose rows load together
  const long warp = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  int col[VPL];  // this lane's channels: col[j] .. col[j] + VEC - 1
  bool has[VPL];  // VEC divides d: all of them or none
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    col[j] = blockIdx.y * 32 * VEC * VPL + (lane + 32 * j) * VEC;
    has[j] = col[j] < d;
  }
  V zero;
#pragma unroll
  for (int i = 0; i < VEC; ++i) zero.v[i] = 0.f;

  if (warp >= nruns) {  // edge-slot warps: zero rows for edges of weight 0
    const long e0 = (warp - nruns) * 32;
    if (e0 >= E) return;
    const long e = e0 + lane;
    unsigned dead = __ballot_sync(
        FULL, e < E && (!emask[e] || (ew && ew[e] == 0.f)));
    while (dead) {
      const int k = __ffs(dead) - 1;
      dead &= dead - 1;
      float* row = demb + (e0 + k) * d;
#pragma unroll
      for (int j = 0; j < VPL; ++j)
        if (has[j]) store_vec(row + col[j], zero);
    }
    return;
  }
  const int r_lo = rptr[warp], r_hi = rptr[warp + 1];
  if (r_lo >= r_hi) return;
  const int k_lo = sptr[r_lo], k_hi = sptr[r_hi];

  V acc[VPL];  // dx of row `row`, the first row not yet written
#pragma unroll
  for (int j = 0; j < VPL; ++j) acc[j] = zero;
  int row = r_lo;
  auto write_to = [&](int s) {  // write dx of the rows before s
    for (; row < s; ++row) {
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        if (has[j]) store_vec(dx + (long)row * d + col[j], acc[j]);
        acc[j] = zero;
      }
    }
  };

  for (int k0 = k_lo; k0 < k_hi; k0 += 32) {
    const int k = k0 + lane;
    int pe = 0, ps = 0, pd = 0;
    float pw = 0.f;
    if (k < k_hi) {
      pe = perm[k];
      ps = src[pe];
      pd = dst[pe];
      pw = ew ? ew[pe] : 1.f;  // perm holds valid edges only
    }
    const int n = min(32, k_hi - k0);
    for (int i0 = 0; i0 < n; i0 += U) {
      V gv[U][VPL], ev[U][VPL], xv[U][VPL];
      long eu[U];
      int su[U];
      float wu[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {  // every edge's rows in flight first
        const int i = (i0 + u) & 31;
        eu[u] = __shfl_sync(FULL, pe, i);
        su[u] = __shfl_sync(FULL, ps, i);
        const long du = __shfl_sync(FULL, pd, i);
        wu[u] = i0 + u < n ? __shfl_sync(FULL, pw, i) : 0.f;
#pragma unroll
        for (int j = 0; j < VPL; ++j) {
          const bool ld = has[j] && wu[u] != 0.f;
          gv[u][j] = ld ? load_vec<VEC>(g + du * d + col[j]) : zero;
          ev[u][j] = ld ? load_vec<VEC>(emb + eu[u] * d + col[j]) : zero;
          xv[u][j] = ld ? load_vec<VEC>(x + (long)su[u] * d + col[j]) : zero;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {  // then their sums, in perm order
        if (i0 + u >= n) break;
        write_to(su[u]);
        if (wu[u] == 0.f) continue;  // its zero d_emb row is a slot warp's
#pragma unroll
        for (int j = 0; j < VPL; ++j) {
          if (!has[j]) continue;
          V gate;
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            gate.v[i] = __fmul_rn(gv[u][j].v[i], wu[u]);  // as autograd rounds it
            if (relu && !(xv[u][j].v[i] + ev[u][j].v[i] > 0.f)) gate.v[i] = 0.f;
            acc[j].v[i] += gate.v[i];
          }
          store_vec(demb + eu[u] * d + col[j], gate);
        }
      }
    }
  }
  write_to(r_hi);
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

struct BwdArgs {
  const float *x, *emb;
  const int *src, *dst, *perm, *sptr, *rptr;
  const bool* emask;
  const float *ew, *g;
  float *dx, *demb;
  int E, d, nruns, relu, slices;
};

template <int VEC, int VPL>
int launch_bwd(const BwdArgs& A, cudaStream_t stream) {
  const long warps = (long)A.nruns + (A.E + 31) / 32;
  const long blocks = (warps * 32 + BWD_THREADS - 1) / BWD_THREADS;
  spmm_bwd_kernel<VEC, VPL><<<dim3((unsigned)blocks, A.slices), BWD_THREADS,
                              0, stream>>>(A.x, A.emb, A.src, A.dst, A.perm,
                                           A.sptr, A.rptr, A.emask, A.ew, A.g,
                                           A.dx, A.demb, A.E, A.d, A.nruns,
                                           A.relu);
  return cudaGetLastError();
}

template <int VEC>
int launch_bwd_vpl(const BwdArgs& A, int vpl, cudaStream_t stream) {
  switch (vpl) {
    case 1: return launch_bwd<VEC, 1>(A, stream);
    case 2: return launch_bwd<VEC, 2>(A, stream);
    case 3: return launch_bwd<VEC, 3>(A, stream);
    default: return launch_bwd<VEC, 4>(A, stream);
  }
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

// dx [N, d] and d_emb [E, d] for the cotangent g [N, d] of spmm_fwd's out,
// whose weight was emask * ew (ew [E] may be null: 1), folded here as
// spmm_fwd's wrapper folds it. perm [E] lists the valid edges of each
// source row s at [sptr[s], sptr[s+1]), in a fixed order. rptr [nruns + 1]
// cuts the rows [0, N) into runs (rptr[0] = 0, rptr[nruns] = N,
// non-decreasing). The launch (vec, vpl, slices) is the wrapper's
// bwd_launch: slices of 32 * vec * vpl channels covering d once, vec
// dividing d and every row pointer aligned to vec floats; another is
// refused.
extern "C" int spmm_bwd(const float* x, const float* emb, const int* src,
                        const int* dst, const int* perm, const int* sptr,
                        const int* rptr, const bool* emask, const float* ew,
                        const float* g, float* dx, float* demb, int N, int E,
                        int d, int nruns, int relu, int vec, int vpl,
                        int slices, cudaStream_t stream) {
  if (N <= 0 || d <= 0 || E < 0 || nruns < 1) return cudaErrorInvalidValue;
  if (!(vec == 1 || vec == 4) || d % vec || vpl < 1 || vpl > BWD_MAX_VPL)
    return cudaErrorInvalidValue;
  const long width = 32L * vec * vpl;
  if (slices < 1 || slices * width < d || (slices - 1) * width >= d)
    return cudaErrorInvalidValue;
  const unsigned long align = 4ul * vec;
  if (((unsigned long)x | (unsigned long)emb | (unsigned long)g |
       (unsigned long)dx | (unsigned long)demb) % align)
    return cudaErrorInvalidValue;
  const BwdArgs A{x,     emb, src, dst, perm, sptr, rptr,  emask, ew,
                  g,     dx,  demb, E,  d,    nruns, relu, slices};
  return vec == 4 ? launch_bwd_vpl<4>(A, vpl, stream)
                  : launch_bwd_vpl<1>(A, vpl, stream);
}
