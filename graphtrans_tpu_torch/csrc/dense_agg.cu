// K6: strided gather -> (+emb, relu, *w) -> scatter-sum, forward and
// backward. Wrapper, plain version and design note:
// graphtrans_tpu_torch/ops/kernels/dense_agg.py.
//
//   out[g,s,c] = sum_{e: mask[g,e], dst[g,e]=s}
//                w[g,e] * relu(x[g,src[g,e],c] + emb[g,e,c])
//
// (relu and w optional, each a template flag.) Forward: K1's earlier
// layout without the table lookup (strided_agg.cuh: one block per (graph
// g, slice of CT channels), thread t owning channel c0+t, edges walked in
// order into a shared accumulator, no atomics); here an edge's embedding
// is a load of emb, EU edges' loads issued before their adds. src and dst
// must be in [0, Sm) on every valid slot; a masked slot's emb is never
// read.
//
// Backward (K6-bwd): one warp per (graph, slice of 32 * VEC * VPL
// channels), the grid from dense_agg.py:bwd_geometry. The warp sorts its
// graph's valid slots by (src, slot) in shared memory, once for all of its
// channels, then walks them as K7-bwd walks its runs: its lanes take 32
// records at once, and it issues the gout[dst], emb and x[src] rows of U
// edges (VEC floats a load, VPL loads a lane a row) before it uses any.
// dmsg = gout[dst] (*w, rounded; zero where pre = x[src] + emb <= 0 under
// relu) is summed into dx of the current row in registers, in slot order,
// as the plain version sums it, and each
// row of dx is written once (zero for a row no valid edge leaves). Where
// autograd asks for them (the FULL instance), dmsg is written to demb (0
// on masked slots) and dw = sum_c gout[dst] * relu(pre) is reduced over
// the warp's lanes per edge, written per channel slice, the slices summed
// in order; the dx-only instance does neither.

#include <cuda_runtime.h>

#include "strided_agg.cuh"
#include "vec.cuh"

namespace {

using strided::CT;
using vio::load_vec;
using vio::store_vec;
using vio::Vec;
using vio::zero_vec;

template <bool RELU, bool HAS_W>
__global__ void __launch_bounds__(CT)
dense_agg_fwd_kernel(const float* __restrict__ x, const int* __restrict__ src,
                     const int* __restrict__ dst,
                     const bool* __restrict__ emask,
                     const float* __restrict__ emb,
                     const float* __restrict__ w, float* __restrict__ out,
                     int Sm, int Em, int d) {
  extern __shared__ float smem[];
  float* xs = smem;                 // [Sm][CT]
  float* acc = xs + Sm * CT;        // [Sm][CT]
  int* es = reinterpret_cast<int*>(acc + Sm * CT);  // [Em] src
  int* ed = es + Em;                // [Em] dst, -1 = masked edge
  float* ew = reinterpret_cast<float*>(ed + Em);    // [Em] weight

  const long g = blockIdx.x;
  const int c0 = blockIdx.y * CT;
  const int t = threadIdx.x;
  const bool live = c0 + t < d;

  strided::stage_fwd_rows(xs, acc, x + g * Sm * d + c0 + t, Sm, d, live, t);
  strided::stage_edges(src, dst, emask, w, g, Em, t, es, ed, ew,
                       [](int) {});
  __syncthreads();
  if (!live) return;

  const float* eg = emb + g * Em * d + c0 + t;
  strided::walk_fwd<RELU, HAS_W>(xs, acc, es, ed, ew, Em, t,
                                 [&](int e) { return eg[(long)e * d]; });
  float* og = out + g * Sm * d + c0 + t;
  for (int s = 0; s < Sm; ++s) og[(long)s * d] = acc[s * CT + t];
}

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int BWD_WARPS = 8;  // warps a block at most (dense_agg.py)
constexpr int MAX_VPL = 4;    // loads a lane a row
constexpr int SMEM_MAX = 232448;

// Shared bytes of a backward block (dense_agg.py:bwd_smem): per warp and
// edge slot the compacted key (src << 16 | slot) of a valid slot, its
// sorted key, dst and weight.
long bwd_smem(int Em, int warps) { return 16L * Em * warps; }

// One warp per (graph, channel slice); lane l owns channels col[j] ..
// col[j] + VEC - 1 of every row. The valid slots' keys src << 16 | slot
// (unique, so a rank among them sorts by (src, slot)) are compacted in
// slot order, each ranked against the others, and its record (sorted key,
// dst, w) placed at its rank. FULL: demb (if not null) and dw_out (if not
// null, [slices, G, Em]) are written too.
template <int VEC, int VPL, bool RELU, bool FULL>
__global__ void __launch_bounds__(32 * BWD_WARPS)
dense_agg_bwd_kernel(const float* __restrict__ x, const int* __restrict__ src,
                     const int* __restrict__ dst,
                     const bool* __restrict__ emask,
                     const float* __restrict__ emb,
                     const float* __restrict__ w,
                     const float* __restrict__ gout, float* __restrict__ dx,
                     float* __restrict__ demb, float* __restrict__ dw_out,
                     int G, int Sm, int Em, int d) {
  using V = Vec<VEC>;
  constexpr int U = VEC * VPL <= 8 ? 4 : 2;  // edges whose rows load together
  extern __shared__ float smem[];  // the forward's name and type
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const long g = (long)blockIdx.x * (blockDim.x >> 5) + wib;
  if (g >= G) return;
  // this warp's [Em] valid keys in slot order, then sorted keys, dst, w
  int* const ckey = reinterpret_cast<int*>(smem) + 4L * Em * wib;
  int* const skey = ckey + Em;             // [Em] sorted keys
  int* const sdst = skey + Em;             // [Em] their dst
  float* const sw = reinterpret_cast<float*>(sdst + Em);  // [Em] their w
  int col[VPL];
  bool has[VPL];  // VEC divides d: all of a vector's channels or none
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    col[j] = blockIdx.y * 32 * VEC * VPL + (lane + 32 * j) * VEC;
    has[j] = col[j] < d;
  }
  const V zero = zero_vec<VEC>();
  const long ge0 = g * Em;

  // the valid slots' keys, compacted in slot order
  int nv = 0;
  for (int e0 = 0; e0 < Em; e0 += 32) {
    const int e = e0 + lane;
    const bool valid = e < Em && emask[ge0 + e];
    const unsigned vb = __ballot_sync(FULL_MASK, valid);
    if (valid)
      ckey[nv + __popc(vb & ((1u << lane) - 1))] = src[ge0 + e] << 16 | e;
    nv += __popc(vb);
  }
  __syncwarp();
  // each one's rank among them places its record
  for (int i = lane; i < nv; i += 32) {
    const int k = ckey[i];
    const long ge = ge0 + (k & 0xffff);
    const int dv = dst[ge];  // loaded before the rank, used after
    const float wv = w ? w[ge] : 1.f;
    int p = 0;
    for (int j = 0; j < nv; ++j) p += ckey[j] < k;
    skey[p] = k;
    sdst[p] = dv;
    sw[p] = wv;
  }
  __syncwarp();

  const float* const xg = x + g * Sm * d;
  const float* const gg = gout + g * Sm * d;
  const float* const eg = emb + ge0 * d;
  float* const dxg = dx + g * Sm * d;
  V acc[VPL];  // dx of row `row`, the first row not yet written
#pragma unroll
  for (int j = 0; j < VPL; ++j) acc[j] = zero;
  int row = 0;
  auto write_to = [&](int s) {  // write dx of the rows before s
    for (; row < s; ++row) {
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        if (has[j]) store_vec(dxg + (long)row * d + col[j], acc[j]);
        acc[j] = zero;
      }
    }
  };

  for (int k0 = 0; k0 < nv; k0 += 32) {
    const int k = k0 + lane;
    int pk = 0, pd = 0;
    float pw = 0.f;
    if (k < nv) {
      pk = skey[k];
      pd = sdst[k];
      pw = sw[k];
    }
    const int n = min(32, nv - k0);
    for (int i0 = 0; i0 < n; i0 += U) {
      V gv[U][VPL], ev[U][VPL], xv[U][VPL];
      int su[U], eu[U];
      float wu[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {  // every edge's rows in flight first
        const int i = (i0 + u) & 31;
        const int ku = __shfl_sync(FULL_MASK, pk, i);
        const long du = __shfl_sync(FULL_MASK, pd, i);
        wu[u] = __shfl_sync(FULL_MASK, pw, i);
        su[u] = ku >> 16;
        eu[u] = ku & 0xffff;
        const bool in = i0 + u < n;
#pragma unroll
        for (int j = 0; j < VPL; ++j) {
          const bool ld = has[j] && in;
          gv[u][j] = ld ? load_vec<VEC>(gg + du * d + col[j]) : zero;
          ev[u][j] = ld ? load_vec<VEC>(eg + (long)eu[u] * d + col[j]) : zero;
          xv[u][j] = ld ? load_vec<VEC>(xg + (long)su[u] * d + col[j]) : zero;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {  // then their sums, in (src, slot) order
        if (i0 + u >= n) break;
        write_to(su[u]);
        float part = 0.f;  // FULL: this lane's share of the edge's dw
#pragma unroll
        for (int j = 0; j < VPL; ++j) {
          if (!has[j]) continue;
          V dm;
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            const float pre = xv[u][j].v[i] + ev[u][j].v[i];
            const float gm = gv[u][j].v[i];
            dm.v[i] = __fmul_rn(gm, wu[u]);  // rounded, not fused into
            if (RELU && !(pre > 0.f)) dm.v[i] = 0.f;  // the add below
            acc[j].v[i] += dm.v[i];
            if (FULL) part += gm * (RELU ? fmaxf(pre, 0.f) : pre);
          }
          if (FULL && demb) store_vec(demb + (ge0 + eu[u]) * d + col[j], dm);
        }
        if (FULL && dw_out) {  // a uniform branch: dw_out is the same for all
          for (int o = 16; o > 0; o >>= 1)
            part += __shfl_xor_sync(FULL_MASK, part, o);
          if (lane == 0) dw_out[((long)blockIdx.y * G + g) * Em + eu[u]] = part;
        }
      }
    }
  }
  write_to(Sm);

  if (FULL) {  // the masked slots: zero demb rows, zero dw
    for (int e0 = 0; e0 < Em; e0 += 32) {
      const int e = e0 + lane;
      const bool masked = e < Em && !emask[ge0 + e];
      if (masked && dw_out) dw_out[((long)blockIdx.y * G + g) * Em + e] = 0.f;
      unsigned dead = demb ? __ballot_sync(FULL_MASK, masked) : 0u;
      while (dead) {
        const int q = __ffs(dead) - 1;
        dead &= dead - 1;
        float* const rowp = demb + (ge0 + e0 + q) * d;
#pragma unroll
        for (int j = 0; j < VPL; ++j)
          if (has[j]) store_vec(rowp + col[j], zero);
      }
    }
  }
}

size_t fwd_smem(int Sm, int Em) {
  return (size_t)2 * Sm * CT * sizeof(float) + (size_t)3 * Em * sizeof(int);
}

template <bool RELU, bool HAS_W>
cudaError_t launch_fwd(const float* x, const int* src, const int* dst,
                       const bool* emask, const float* emb, const float* w,
                       float* out, int G, int Sm, int Em, int d,
                       cudaStream_t stream) {
  const size_t smem = fwd_smem(Sm, Em);
  auto kernel = dense_agg_fwd_kernel<RELU, HAS_W>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(G, (d + CT - 1) / CT);
  kernel<<<grid, CT, smem, stream>>>(x, src, dst, emask, emb, w, out, Sm, Em,
                                     d);
  return cudaGetLastError();
}

struct BwdArgs {
  const float* x;
  const int *src, *dst;
  const bool* emask;
  const float *emb, *w, *gout;
  float *dx, *demb, *dw_out;
  int G, Sm, Em, d, slices, warps, smem;
};

template <int VEC, int VPL, bool RELU, bool FULL>
cudaError_t launch_bwd(const BwdArgs& A, cudaStream_t stream) {
  const auto kernel = dense_agg_bwd_kernel<VEC, VPL, RELU, FULL>;
  if (A.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, A.smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((A.G + A.warps - 1) / A.warps, A.slices);
  kernel<<<grid, 32 * A.warps, A.smem, stream>>>(
      A.x, A.src, A.dst, A.emask, A.emb, A.w, A.gout, A.dx, A.demb, A.dw_out,
      A.G, A.Sm, A.Em, A.d);
  return cudaGetLastError();
}

template <int VEC, int VPL>
cudaError_t launch_bwd_flags(const BwdArgs& A, bool relu, bool full,
                             cudaStream_t stream) {
  if (relu)
    return full ? launch_bwd<VEC, VPL, true, true>(A, stream)
                : launch_bwd<VEC, VPL, true, false>(A, stream);
  return full ? launch_bwd<VEC, VPL, false, true>(A, stream)
              : launch_bwd<VEC, VPL, false, false>(A, stream);
}

template <int VEC>
cudaError_t launch_bwd_vpl(const BwdArgs& A, int vpl, bool relu, bool full,
                           cudaStream_t stream) {
  switch (vpl) {
    case 1: return launch_bwd_flags<VEC, 1>(A, relu, full, stream);
    case 2: return launch_bwd_flags<VEC, 2>(A, relu, full, stream);
    case 3: return launch_bwd_flags<VEC, 3>(A, relu, full, stream);
    default: return launch_bwd_flags<VEC, 4>(A, relu, full, stream);
  }
}

// The wrapper's launch (dense_agg.py:bwd_geometry): slices of 32 * vec *
// vpl channels covering d once, vec dividing d; a key of src << 16 | slot;
// the shared bytes it names.
bool bwd_launch_ok(int Sm, int Em, int d, int vec, int vpl, int slices,
                   int warps, int smem) {
  if (!(vec == 1 || vec == 4) || d % vec || vpl < 1 || vpl > MAX_VPL)
    return false;
  const long width = 32L * vec * vpl;
  if (slices < 1 || slices * width < d || (slices - 1) * width >= d)
    return false;
  if (Sm > 32767 || Em > 65536 || warps < 1 || warps > BWD_WARPS)
    return false;
  return smem <= SMEM_MAX && smem == bwd_smem(Em, warps);
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shared memory bytes a forward block needs (the wrapper checks the limit).
extern "C" long dense_agg_smem(int Sm, int Em) {
  return (long)fwd_smem(Sm, Em);
}

// Returns cudaGetLastError() after the launch (0 = launched). w may be
// null (no edge weight).
extern "C" int dense_agg_fwd(const float* x, const int* src, const int* dst,
                             const bool* emask, const float* emb,
                             const float* w, float* out, int G, int Sm,
                             int Em, int d, int relu, cudaStream_t stream) {
  if (relu)
    return w ? launch_fwd<true, true>(x, src, dst, emask, emb, w, out, G, Sm,
                                      Em, d, stream)
             : launch_fwd<true, false>(x, src, dst, emask, emb, w, out, G,
                                       Sm, Em, d, stream);
  return w ? launch_fwd<false, true>(x, src, dst, emask, emb, w, out, G, Sm,
                                     Em, d, stream)
           : launch_fwd<false, false>(x, src, dst, emask, emb, w, out, G, Sm,
                                      Em, d, stream);
}

// dx [G, Sm, d] for the cotangent gout of dense_agg_fwd's out, and where
// not null demb [G, Em, d] (0 on masked slots) and, with w, dw [G, Em];
// dw_part [slices, G, Em] is the caller's scratch where slices > 1 (with
// one slice dw is written directly). The launch (vec, vpl, slices, warps,
// smem) is the wrapper's bwd_geometry; another is refused, as are
// pointers not aligned to vec floats.
extern "C" int dense_agg_bwd(const float* x, const int* src, const int* dst,
                             const bool* emask, const float* emb,
                             const float* w, const float* gout, float* dx,
                             float* demb, float* dw, float* dw_part, int G,
                             int Sm, int Em, int d, int relu, int vec,
                             int vpl, int slices, int warps, int smem,
                             cudaStream_t stream) {
  if (G <= 0 || Sm <= 0 || Em < 0 || d <= 0 ||
      !bwd_launch_ok(Sm, Em, d, vec, vpl, slices, warps, smem))
    return cudaErrorInvalidValue;
  if (dw && (!w || (slices > 1 && !dw_part))) return cudaErrorInvalidValue;
  const unsigned long align = 4ul * vec;
  if (((unsigned long)x | (unsigned long)emb | (unsigned long)gout |
       (unsigned long)dx | (unsigned long)demb) % align)
    return cudaErrorInvalidValue;
  float* const dw_out = slices > 1 ? dw_part : dw;
  const BwdArgs A{x,  src,   dst, emask, emb,    w,     gout, dx,   demb,
                  dw ? dw_out : nullptr, G,     Sm,   Em,   d,    slices,
                  warps, smem};
  const bool full = demb || dw;
  const cudaError_t err =
      vec == 4 ? launch_bwd_vpl<4>(A, vpl, relu, full, stream)
               : launch_bwd_vpl<1>(A, vpl, relu, full, stream);
  if (err != cudaSuccess || !dw || slices == 1) return err;
  return strided::sum_rows(dw_part, dw, slices, (long)G * Em, stream);
}
