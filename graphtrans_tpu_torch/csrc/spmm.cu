// K7: the flat-layout message-passing sum over dst-sorted edges, and its
// backward (below spmm_fwd_kernel). Wrapper, plain version and design note:
// graphtrans_tpu_torch/ops/kernels/spmm.py. K8's forward
// (ops/kernels/block_spmm.py) runs on the same forward body
// (blocked_fwd_kernel).
//
// out[i] = sum_{e: dst[e] = i} w[e] * msg(x[src[e]], emb[e]),
// msg = relu(x + emb) or x + emb, w = emask * ew (ew [E] may be null: 1).
// x [N, d], emb [E, d] f32, or bf16 in the bf16 instances (spmm_fwd_bf16,
// spmm_bwd_bf16: the same walks, float32 sums, rows rounded once); src,
// dst [E] int32, dst sorted.
//
// Forward: the destination rows are cut into runs (rptr: the batch's
// DstOrder, made once and shared by every layer; edge_runs of dptr, the
// live edges before each row, so a run holds about RUN_COST units of work,
// a live edge EDGE_COST and a row one). A warp walks a run's edges in
// batch order, from ptr[first row] (row i's edges lie at [ptr[i],
// ptr[i+1]): dst is sorted): its lanes load the mask, src, dst and weight
// of 32 edges at once, then the warp takes U edges at a time, shuffles
// their indices to every lane and issues the x[src] and emb rows of all U
// before it adds any (VEC floats a load, VPL loads a lane a row). It sums
// the current row in registers in edge order, skipping masked edges and
// edges of weight 0 (their rows are not loaded), each product rounded
// before its add as the plain version rounds it, and writes each row once
// when the walk passes it (zero for a row with no live edge). The walk
// ends at the run's last live edge (it counts them down from dptr): the
// padding tail (tens of thousands of masked edges on the padding node's
// row) is never walked. The weight is folded here, so the wrapper
// launches nothing before the kernel. Grid y: slices of 32 * VEC * VPL
// channels. One writer per output cell, no atomics.
//
// K8's forward (blocked_fwd_kernel) walks the same way over the positions
// of a SlotOrder (block_spmm.py): the real slots of the dst-major block
// plan grouped by major row, in slot order within each row, every
// position live. Position k holds the edge src[k] -> dst[k]; its emb row
// and weight are those of its slot, slot[k]. A row's terms are added in
// slot order. K8's dx (blocked_dx_kernel, below the backward) walks a
// SlotOrder of the src-major plan as the backward walks its runs.
#include <cuda_runtime.h>

#include "vec.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;

using vio::bf16;
using vio::load_vec;
using vio::store_vec;
using vio::Vec;

constexpr int RUN_THREADS = 256;  // 8 warps a block
constexpr int MAX_VPL = 4;        // loads a lane a row (spmm.py:bwd_launch)

// The forward's walk, one warp a run. SLOTS: the edges are the positions
// of a SlotOrder (every one live, emb and ew indexed by slot[k]); else the
// batch's edges (emask, emb and ew indexed by the edge). E: the element
// type of x, emb and out (float, or bf16: widened on the load, the sums in
// float32, each row rounded once on its store).
template <int VEC, int VPL, bool SLOTS, class E>
__device__ __forceinline__ void fwd_walk(
    const E* __restrict__ x, const E* __restrict__ emb,
    const int* __restrict__ src, const int* __restrict__ dst,
    const bool* __restrict__ emask, const int* __restrict__ slot,
    const int* __restrict__ ptr, const int* __restrict__ dptr,
    const int* __restrict__ rptr, const float* __restrict__ ew,
    E* __restrict__ out, int d, int nruns, int relu) {
  using V = Vec<VEC>;
  constexpr int U = VEC * VPL <= 8 ? 4 : 2;  // edges whose rows load together
  const long warp = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= nruns) return;
  int col[VPL];  // this lane's channels: col[j] .. col[j] + VEC - 1
  bool has[VPL];  // VEC divides d: all of them or none
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    col[j] = blockIdx.y * 32 * VEC * VPL + (lane + 32 * j) * VEC;
    has[j] = col[j] < d;
  }
  const V zero = vio::zero_vec<VEC>();
  const int r_lo = rptr[warp], r_hi = rptr[warp + 1];
  if (r_lo >= r_hi) return;
  const int e_hi = ptr[r_hi];
  int left = dptr[r_hi] - dptr[r_lo];  // live edges not yet reached

  V acc[VPL];  // out of row `row`, the first row not yet written
#pragma unroll
  for (int j = 0; j < VPL; ++j) acc[j] = zero;
  int row = r_lo;
  auto write_to = [&](int r) {  // write the rows before r
    for (; row < r; ++row) {
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        if (has[j]) store_vec(out + (long)row * d + col[j], acc[j]);
        acc[j] = zero;
      }
    }
  };

  for (int e0 = ptr[r_lo]; e0 < e_hi && left > 0; e0 += 32) {
    const int e = e0 + lane;
    const bool live = e < e_hi && (SLOTS || emask[e]);
    const unsigned lv = __ballot_sync(FULL, live);
    if (!lv) continue;  // masked edges only
    left -= __popc(lv);
    int ps = 0, pd = 0, pe = e;
    float pw = 0.f;  // masked: weight 0
    if (live) {
      ps = src[e];
      pd = dst[e];
      if (SLOTS) pe = slot[e];
      pw = ew ? ew[pe] : 1.f;
    }
    const int n = 32 - __clz(lv);  // past the chunk's last live edge
    for (int i0 = 0; i0 < n; i0 += U) {
      V xv[U][VPL], ev[U][VPL];
      int du[U];
      float wu[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {  // every edge's rows in flight first
        const int i = (i0 + u) & 31;
        const long eu = SLOTS ? __shfl_sync(FULL, pe, i) : e0 + i;
        const long su = __shfl_sync(FULL, ps, i);
        du[u] = __shfl_sync(FULL, pd, i);
        wu[u] = i0 + u < n ? __shfl_sync(FULL, pw, i) : 0.f;
#pragma unroll
        for (int j = 0; j < VPL; ++j) {
          const bool ld = has[j] && wu[u] != 0.f;
          xv[u][j] = ld ? load_vec<VEC>(x + su * d + col[j]) : zero;
          ev[u][j] = ld ? load_vec<VEC>(emb + eu * d + col[j]) : zero;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {  // then their sums, in edge order
        if (i0 + u >= n) break;
        if (wu[u] == 0.f) continue;  // masked or weight 0: not loaded
        write_to(du[u]);
#pragma unroll
        for (int j = 0; j < VPL; ++j) {
          if (!has[j]) continue;
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            float m = xv[u][j].v[i] + ev[u][j].v[i];
            if (relu) m = fmaxf(m, 0.f);
            acc[j].v[i] += __fmul_rn(m, wu[u]);  // rounded, as the plain
                                                 // version rounds it
          }
        }
      }
    }
  }
  write_to(r_hi);
}

template <int VEC, int VPL, class E>
__global__ void __launch_bounds__(RUN_THREADS)
spmm_fwd_kernel(const E* __restrict__ x, const E* __restrict__ emb,
                const int* __restrict__ src, const int* __restrict__ dst,
                const bool* __restrict__ emask, const int* __restrict__ ptr,
                const int* __restrict__ dptr, const int* __restrict__ rptr,
                const float* __restrict__ ew, E* __restrict__ out, int d,
                int nruns, int relu) {
  fwd_walk<VEC, VPL, false>(x, emb, src, dst, emask, nullptr, ptr, dptr,
                            rptr, ew, out, d, nruns, relu);
}

// K8's forward: every position live, so the live positions before a row
// are its row pointer (dptr = ptr).
template <int VEC, int VPL>
__global__ void __launch_bounds__(RUN_THREADS)
blocked_fwd_kernel(const float* __restrict__ x, const float* __restrict__ emb,
                   const int* __restrict__ src, const int* __restrict__ dst,
                   const int* __restrict__ slot, const int* __restrict__ ptr,
                   const int* __restrict__ rptr, const float* __restrict__ ew,
                   float* __restrict__ out, int d, int nruns, int relu) {
  fwd_walk<VEC, VPL, true>(x, emb, src, dst, nullptr, slot, ptr, ptr, rptr,
                           ew, out, d, nruns, relu);
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

// El: the element type of x, emb, g, dx and d_emb (float, or bf16:
// widened on the load, dx summed in float32 and rounded once a row, each
// d_emb row rounded once).
template <int VEC, int VPL, class El>
__global__ void __launch_bounds__(RUN_THREADS, 2)  // two blocks an SM
spmm_bwd_kernel(const El* __restrict__ x, const El* __restrict__ emb,
                const int* __restrict__ src, const int* __restrict__ dst,
                const int* __restrict__ perm, const int* __restrict__ sptr,
                const int* __restrict__ rptr, const bool* __restrict__ emask,
                const float* __restrict__ ew, const El* __restrict__ g,
                El* __restrict__ dx,
                El* __restrict__ demb, int E, int d, int nruns, int relu) {
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
      El* row = demb + (e0 + k) * d;
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

// K8-dx: dx[s] = sum over the real slots of the src-major block plan whose
// major row is s of w * 1[x[s] + emb > 0] * g[dst] (relu_add; w * g[dst]
// for add), walked over the positions of a SlotOrder of that plan
// (block_spmm.py): row s's positions at [ptr[s], ptr[s+1]), in slot order,
// every position live, position k the edge major[k] (its src) -> minor[k]
// (its dst), whose emb row and weight are read at slot[k] (the dst-major
// plan's slot of the same edge where the order maps its slots, so that
// emb and w are the dst-major copies). The source rows are cut into runs
// (rptr, edge_runs of ptr), a warp a run, as the backward above: 32
// positions' records a step, then the g[dst] and emb rows of U positions
// in flight before any is used, and x of a row loaded once, with the rows
// of its first position. dx of the current row is summed in registers in
// slot order, each product rounded before its add, as the plain version
// and the parent's shared sums have it, and written once (zero for a row
// no real slot leaves). No d_emb: K8's d_emb is its own kernel
// (block_spmm.cu). Under add, neither x nor emb is read.
template <int VEC, int VPL>
__global__ void __launch_bounds__(RUN_THREADS, 2)  // two blocks an SM
blocked_dx_kernel(const float* __restrict__ x, const float* __restrict__ emb,
                  const int* __restrict__ minor,
                  const int* __restrict__ major,
                  const int* __restrict__ slot, const int* __restrict__ ptr,
                  const int* __restrict__ rptr, const float* __restrict__ ew,
                  const float* __restrict__ g, float* __restrict__ dx, int d,
                  int nruns, int relu) {
  using V = Vec<VEC>;
  constexpr int U = VEC * VPL <= 8 ? 4 : 2;  // positions whose rows load
                                             // together
  const long warp = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= nruns) return;
  int col[VPL];  // this lane's channels: col[j] .. col[j] + VEC - 1
  bool has[VPL];  // VEC divides d: all of them or none
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    col[j] = blockIdx.y * 32 * VEC * VPL + (lane + 32 * j) * VEC;
    has[j] = col[j] < d;
  }
  const V zero = vio::zero_vec<VEC>();
  const int r_lo = rptr[warp], r_hi = rptr[warp + 1];
  if (r_lo >= r_hi) return;
  const int k_lo = ptr[r_lo], k_hi = ptr[r_hi];

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
  V xc[VPL];  // x of row xrow (relu_add)
#pragma unroll
  for (int j = 0; j < VPL; ++j) xc[j] = zero;
  int xrow = -1;

  for (int k0 = k_lo; k0 < k_hi; k0 += 32) {
    const int k = k0 + lane;
    int pe = 0, pm = 0, pr = 0;
    float pw = 0.f;
    if (k < k_hi) {
      pe = slot[k];
      pm = minor[k];
      pr = major[k];
      pw = ew ? ew[pe] : 1.f;
    }
    const int n = min(32, k_hi - k0);
    for (int i0 = 0; i0 < n; i0 += U) {
      V gv[U][VPL], ev[U][VPL], xv[U][VPL];
      int ru[U];
      float wu[U];
      int prev = xrow;  // the row whose x the position before u reads
#pragma unroll
      for (int u = 0; u < U; ++u) {  // every position's rows in flight first
        const int i = (i0 + u) & 31;
        const long eu = __shfl_sync(FULL, pe, i);
        const long mu = __shfl_sync(FULL, pm, i);
        ru[u] = __shfl_sync(FULL, pr, i);
        wu[u] = __shfl_sync(FULL, pw, i);
        const bool in = i0 + u < n;
        const bool nx = relu && in && ru[u] != prev;  // a row's first: its x
        if (in) prev = ru[u];
#pragma unroll
        for (int j = 0; j < VPL; ++j) {
          const bool ld = has[j] && in;
          gv[u][j] = ld ? load_vec<VEC>(g + mu * d + col[j]) : zero;
          ev[u][j] = ld && relu ? load_vec<VEC>(emb + eu * d + col[j]) : zero;
          xv[u][j] = has[j] && nx
                         ? load_vec<VEC>(x + (long)ru[u] * d + col[j])
                         : zero;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {  // then their sums, in slot order
        if (i0 + u >= n) break;
        write_to(ru[u]);
        if (relu && ru[u] != xrow) {  // the same test as the loads'
          xrow = ru[u];
#pragma unroll
          for (int j = 0; j < VPL; ++j) xc[j] = xv[u][j];
        }
#pragma unroll
        for (int j = 0; j < VPL; ++j) {
          if (!has[j]) continue;
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            float m = __fmul_rn(gv[u][j].v[i], wu[u]);  // as autograd rounds
            if (relu && !(xc[j].v[i] + ev[u][j].v[i] > 0.f)) m = 0.f;
            acc[j].v[i] += m;
          }
        }
      }
    }
  }
  write_to(r_hi);
}

template <class E>
struct FwdArgs {
  const E *x, *emb;
  const int *src, *dst;
  const bool* emask;  // K7's; null for K8
  const int* slot;    // K8's (float only); null for K7
  const int *ptr, *dptr, *rptr;
  const float* ew;
  E* out;
  int d, nruns, relu, slices;
};

template <int VEC, int VPL, class E>
int launch_fwd(const FwdArgs<E>& A, cudaStream_t stream) {
  const long blocks = ((long)A.nruns * 32 + RUN_THREADS - 1) / RUN_THREADS;
  const dim3 grid((unsigned)blocks, A.slices);
  if constexpr (sizeof(E) == 4) {
    if (A.slot) {
      blocked_fwd_kernel<VEC, VPL><<<grid, RUN_THREADS, 0, stream>>>(
          A.x, A.emb, A.src, A.dst, A.slot, A.ptr, A.rptr, A.ew, A.out, A.d,
          A.nruns, A.relu);
      return cudaGetLastError();
    }
  }
  spmm_fwd_kernel<VEC, VPL, E><<<grid, RUN_THREADS, 0, stream>>>(
      A.x, A.emb, A.src, A.dst, A.emask, A.ptr, A.dptr, A.rptr, A.ew, A.out,
      A.d, A.nruns, A.relu);
  return cudaGetLastError();
}

template <int VEC, class E>
int launch_fwd_vpl(const FwdArgs<E>& A, int vpl, cudaStream_t stream) {
  switch (vpl) {
    case 1: return launch_fwd<VEC, 1>(A, stream);
    case 2: return launch_fwd<VEC, 2>(A, stream);
    case 3: return launch_fwd<VEC, 3>(A, stream);
    default: return launch_fwd<VEC, 4>(A, stream);
  }
}

// (vec, vpl, slices) as spmm.py:bwd_launch gives them for width d: slices
// of 32 * vec * vpl channels covering d once, vec dividing d
bool launch_ok(int d, int vec, int vpl, int slices) {
  if (!(vec == 1 || vec == 4) || d % vec || vpl < 1 || vpl > MAX_VPL)
    return false;
  const long width = 32L * vec * vpl;
  return slices >= 1 && slices * width >= d && (slices - 1) * width < d;
}

template <class El>
struct BwdArgs {
  const El *x, *emb;
  const int *src, *dst, *perm, *sptr, *rptr;
  const bool* emask;
  const float* ew;
  const El* g;
  El *dx, *demb;
  int E, d, nruns, relu, slices;
};

template <int VEC, int VPL, class El>
int launch_bwd(const BwdArgs<El>& A, cudaStream_t stream) {
  const long warps = (long)A.nruns + (A.E + 31) / 32;
  const long blocks = (warps * 32 + RUN_THREADS - 1) / RUN_THREADS;
  spmm_bwd_kernel<VEC, VPL, El><<<dim3((unsigned)blocks, A.slices),
                                  RUN_THREADS, 0, stream>>>(
      A.x, A.emb, A.src, A.dst, A.perm, A.sptr, A.rptr, A.emask, A.ew, A.g,
      A.dx, A.demb, A.E, A.d, A.nruns, A.relu);
  return cudaGetLastError();
}

template <int VEC, class El>
int launch_bwd_vpl(const BwdArgs<El>& A, int vpl, cudaStream_t stream) {
  switch (vpl) {
    case 1: return launch_bwd<VEC, 1>(A, stream);
    case 2: return launch_bwd<VEC, 2>(A, stream);
    case 3: return launch_bwd<VEC, 3>(A, stream);
    default: return launch_bwd<VEC, 4>(A, stream);
  }
}

struct DxArgs {
  const float *x, *emb;
  const int *minor, *major, *slot, *ptr, *rptr;
  const float *ew, *g;
  float* dx;
  int d, nruns, relu, slices;
};

template <int VEC, int VPL>
int launch_dx(const DxArgs& A, cudaStream_t stream) {
  const long blocks = ((long)A.nruns * 32 + RUN_THREADS - 1) / RUN_THREADS;
  blocked_dx_kernel<VEC, VPL><<<dim3((unsigned)blocks, A.slices),
                                RUN_THREADS, 0, stream>>>(
      A.x, A.emb, A.minor, A.major, A.slot, A.ptr, A.rptr, A.ew, A.g, A.dx,
      A.d, A.nruns, A.relu);
  return cudaGetLastError();
}

template <int VEC>
int launch_dx_vpl(const DxArgs& A, int vpl, cudaStream_t stream) {
  switch (vpl) {
    case 1: return launch_dx<VEC, 1>(A, stream);
    case 2: return launch_dx<VEC, 2>(A, stream);
    case 3: return launch_dx<VEC, 3>(A, stream);
    default: return launch_dx<VEC, 4>(A, stream);
  }
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out [N, d] over the edges of weight emask * ew (ew [E] may be null: 1):
// row i's edges lie at [ptr[i], ptr[i+1]) (dst sorted), dptr [N + 1]
// counts the live (emask) edges before each row, and rptr [nruns + 1] cuts
// the rows [0, N) into runs (rptr[0] = 0, rptr[nruns] = N,
// non-decreasing). relu = 1 for the relu_add message, 0 for add. The
// launch (vec, vpl, slices) is the wrapper's bwd_launch, every row pointer
// aligned to vec floats; another is refused. Returns cudaGetLastError()
// after the launch (0 = launched).
template <class E>
int spmm_fwd_entry(const E* x, const E* emb, const int* src, const int* dst,
                   const bool* emask, const int* ptr, const int* dptr,
                   const int* rptr, const float* ew, E* out, int N, int d,
                   int nruns, int relu, int vec, int vpl, int slices,
                   cudaStream_t stream) {
  if (N <= 0 || d <= 0 || nruns < 1 || !launch_ok(d, vec, vpl, slices))
    return cudaErrorInvalidValue;
  if (((unsigned long)x | (unsigned long)emb | (unsigned long)out) %
      (sizeof(E) * vec))
    return cudaErrorInvalidValue;
  const FwdArgs<E> A{x,    emb,  src, dst, emask, nullptr, ptr,
                     dptr, rptr, ew,  out, d,     nruns,   relu, slices};
  return vec == 4 ? launch_fwd_vpl<4>(A, vpl, stream)
                  : launch_fwd_vpl<1>(A, vpl, stream);
}

extern "C" int spmm_fwd(const float* x, const float* emb, const int* src,
                        const int* dst, const bool* emask, const int* ptr,
                        const int* dptr, const int* rptr, const float* ew,
                        float* out, int N, int d, int nruns, int relu,
                        int vec, int vpl, int slices, cudaStream_t stream) {
  return spmm_fwd_entry(x, emb, src, dst, emask, ptr, dptr, rptr, ew, out, N,
                        d, nruns, relu, vec, vpl, slices, stream);
}

// K7's bf16 instance (the bf16 step): x, emb and out bf16, the weight
// float32 (ew [E] may be null: 1); the sums in float32, each row rounded
// once (graphtrans_tpu/ops/pallas/spmm.py:156-164); the arguments and the
// launch as spmm_fwd's, the pointers aligned to vec bf16.
extern "C" int spmm_fwd_bf16(const bf16* x, const bf16* emb, const int* src,
                             const int* dst, const bool* emask,
                             const int* ptr, const int* dptr, const int* rptr,
                             const float* ew, bf16* out, int N, int d,
                             int nruns, int relu, int vec, int vpl,
                             int slices, cudaStream_t stream) {
  return spmm_fwd_entry(x, emb, src, dst, emask, ptr, dptr, rptr, ew, out, N,
                        d, nruns, relu, vec, vpl, slices, stream);
}

// K8's forward: out [N, d] over the positions of a SlotOrder. Position k
// is the edge src[k] -> dst[k] of slot slot[k], whose emb row [C*EB, d]
// and weight w [C*EB] (may be null: 1) it reads; row i's positions lie at
// [ptr[i], ptr[i+1]), and rptr [nruns + 1] cuts the rows [0, N) into runs
// as spmm_fwd's. relu and the launch (vec, vpl, slices) as spmm_fwd's.
extern "C" int blocked_fwd(const float* x, const float* emb, const int* src,
                           const int* dst, const int* slot, const int* ptr,
                           const int* rptr, const float* w, float* out, int N,
                           int d, int nruns, int relu, int vec, int vpl,
                           int slices, cudaStream_t stream) {
  if (N <= 0 || d <= 0 || nruns < 1 || !slot ||
      !launch_ok(d, vec, vpl, slices))
    return cudaErrorInvalidValue;
  if (((unsigned long)x | (unsigned long)emb | (unsigned long)out) %
      (4ul * vec))
    return cudaErrorInvalidValue;
  const FwdArgs<float> A{x,   emb,  src, dst, nullptr, slot,  ptr,
                         ptr, rptr, w,   out, d,       nruns, relu, slices};
  return vec == 4 ? launch_fwd_vpl<4>(A, vpl, stream)
                  : launch_fwd_vpl<1>(A, vpl, stream);
}

// dx [N, d] and d_emb [E, d] for the cotangent g [N, d] of spmm_fwd's out,
// whose weight was emask * ew (ew [E] may be null: 1), folded here as
// spmm_fwd folds it. perm [E] lists the valid edges of each
// source row s at [sptr[s], sptr[s+1]), in a fixed order. rptr [nruns + 1]
// cuts the rows [0, N) into runs (rptr[0] = 0, rptr[nruns] = N,
// non-decreasing). The launch (vec, vpl, slices) is the wrapper's
// bwd_launch: slices of 32 * vec * vpl channels covering d once, vec
// dividing d and every row pointer aligned to vec floats; another is
// refused.
template <class El>
int spmm_bwd_entry(const El* x, const El* emb, const int* src, const int* dst,
                   const int* perm, const int* sptr, const int* rptr,
                   const bool* emask, const float* ew, const El* g, El* dx,
                   El* demb, int N, int E, int d, int nruns, int relu,
                   int vec, int vpl, int slices, cudaStream_t stream) {
  if (N <= 0 || d <= 0 || E < 0 || nruns < 1 ||
      !launch_ok(d, vec, vpl, slices))
    return cudaErrorInvalidValue;
  const unsigned long align = sizeof(El) * vec;
  if (((unsigned long)x | (unsigned long)emb | (unsigned long)g |
       (unsigned long)dx | (unsigned long)demb) % align)
    return cudaErrorInvalidValue;
  const BwdArgs<El> A{x,  emb,  src, dst, perm,  sptr, rptr,  emask, ew,
                      g,  dx,   demb, E,  d,     nruns, relu, slices};
  return vec == 4 ? launch_bwd_vpl<4>(A, vpl, stream)
                  : launch_bwd_vpl<1>(A, vpl, stream);
}

extern "C" int spmm_bwd(const float* x, const float* emb, const int* src,
                        const int* dst, const int* perm, const int* sptr,
                        const int* rptr, const bool* emask, const float* ew,
                        const float* g, float* dx, float* demb, int N, int E,
                        int d, int nruns, int relu, int vec, int vpl,
                        int slices, cudaStream_t stream) {
  return spmm_bwd_entry(x, emb, src, dst, perm, sptr, rptr, emask, ew, g, dx,
                        demb, N, E, d, nruns, relu, vec, vpl, slices, stream);
}

// K7-bwd's bf16 instance (the bf16 step): x, emb, g, dx and d_emb bf16,
// the weight float32; dx summed in float32 over a source row's edges and
// rounded once, each d_emb row rounded once; the arguments and the launch
// as spmm_bwd's, the pointers aligned to vec bf16.
extern "C" int spmm_bwd_bf16(const bf16* x, const bf16* emb, const int* src,
                             const int* dst, const int* perm,
                             const int* sptr, const int* rptr,
                             const bool* emask, const float* ew,
                             const bf16* g, bf16* dx, bf16* demb, int N,
                             int E, int d, int nruns, int relu, int vec,
                             int vpl, int slices, cudaStream_t stream) {
  return spmm_bwd_entry(x, emb, src, dst, perm, sptr, rptr, emask, ew, g, dx,
                        demb, N, E, d, nruns, relu, vec, vpl, slices, stream);
}

// K8's dx [N, d] for the cotangent g [N, d] of its forward, over the
// positions of a SlotOrder of the src-major plan: position k is the edge
// major[k] -> minor[k] whose emb row [*, d] and weight w (may be null: 1)
// are read at slot[k]; row s's positions lie at [ptr[s], ptr[s+1]), and
// rptr [nruns + 1] cuts the rows [0, N) into runs as spmm_bwd's. relu and
// the launch (vec, vpl, slices) as spmm_fwd's.
extern "C" int blocked_dx(const float* x, const float* emb, const int* minor,
                          const int* major, const int* slot, const int* ptr,
                          const int* rptr, const float* w, const float* g,
                          float* dx, int N, int d, int nruns, int relu,
                          int vec, int vpl, int slices, cudaStream_t stream) {
  if (N <= 0 || d <= 0 || nruns < 1 || !slot ||
      !launch_ok(d, vec, vpl, slices))
    return cudaErrorInvalidValue;
  if (((unsigned long)x | (unsigned long)emb | (unsigned long)g |
       (unsigned long)dx) % (4ul * vec))
    return cudaErrorInvalidValue;
  const DxArgs A{x,  emb, minor, major, slot, ptr,  rptr,
                 w,  g,   dx,    d,     nruns, relu, slices};
  return vec == 4 ? launch_dx_vpl<4>(A, vpl, stream)
                  : launch_dx_vpl<1>(A, vpl, stream);
}
