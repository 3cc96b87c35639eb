// K6: strided gather -> (+emb, relu, *w) -> scatter-sum, forward and
// backward. Wrapper, plain version and design note:
// graphtrans_tpu_torch/ops/kernels/dense_agg.py.
//
//   out[g,s,c] = sum_{e: mask[g,e], dst[g,e]=s}
//                w[g,e] * relu(x[g,src[g,e],c] + emb[g,e,c])
//
// (relu optional, a template flag; w may be null: 1; emb may be null: all
// zero, so that NCI1's edge embeddings need no [G, Em, d] tensor.) src and
// dst must be in [0, Sm) on every valid slot; a masked slot is never read.
//
// Both directions: one warp per (graph, slice of 32 * VEC * VPL channels),
// the grid from dense_agg.py's fwd_geometry / bwd_geometry; lane l owns
// channels col[j] .. col[j] + VEC - 1 of every row. The warp sorts its
// graph's valid slots in shared memory, once for all of its channels
// (sort_slots), then walks them as K7 walks its runs: its lanes take 32
// records at once, and it issues the rows of U edges (VEC floats a load,
// VPL loads a lane a row) before it uses any. Each output row is summed in
// registers in slot order and written once, zero for a row that no valid
// edge reaches: one writer a cell, no atomics, no barrier.
//
// Forward: slots sorted by (dst, slot); the x[src] and emb rows of U edges
// in flight (the emb-less instance loads no emb); relu(x[src] + emb) times
// w, the product rounded before its add (__fmul_rn) as the plain version
// rounds it, summed into out of the current row.
//
// Backward (K6-bwd): slots sorted by (src, slot); the gout[dst], emb (none
// where emb is null) and x[src] rows of U edges in flight. dmsg = gout[dst]
// (*w, rounded; zero where pre = x[src] + emb <= 0 under relu) is summed
// into dx of the current row. Where autograd asks for them (the FULL
// instance), dmsg is written to demb (0 on masked slots) and dw = sum_c
// gout[dst] * relu(pre) is reduced over the warp's lanes per edge, written
// per channel slice, the slices summed in order; the dx-only instance
// does neither.

#include <cuda_runtime.h>

#include "strided_agg.cuh"
#include "vec.cuh"

namespace {

using vio::load_vec;
using vio::store_vec;
using vio::Vec;
using vio::zero_vec;

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int WARPS = 8;    // warps a block at most (dense_agg.py)
constexpr int MAX_VPL = 4;  // loads a lane a row
constexpr int SMEM_MAX = 232448;

// Shared bytes of a block of either direction (dense_agg.py:warp_smem): per
// warp and edge slot the compacted key of a valid slot, its sorted key, the
// other endpoint and the weight.
long warp_smem(int Em, int warps) { return 16L * Em * warps; }

// The valid slots of one graph (slots [ge0, ge0 + Em) of the edge lists)
// sorted by (major, slot) into this warp's shared lists: skey[k] = major <<
// 16 | slot, sminor[k] the slot's other endpoint, sw[k] its weight (1 where
// w is null); ckey [Em] is scratch. The keys (unique, so a rank among them
// sorts) are compacted in slot order with ballots, each ranked against the
// others and its record placed at its rank. Returns their count.
__device__ __forceinline__ int sort_slots(
    const int* __restrict__ major, const int* __restrict__ minor,
    const bool* __restrict__ emask, const float* __restrict__ w, long ge0,
    int Em, int lane, int* ckey, int* skey, int* sminor, float* sw) {
  int nv = 0;
#pragma unroll 4
  for (int e0 = 0; e0 < Em; e0 += 32) {
    const int e = e0 + lane;
    const bool in = e < Em;
    // a masked slot's index is read too (not its rows), so that the loads
    // of several steps can be in flight together
    const int key = in ? major[ge0 + e] << 16 | e : 0;
    const bool valid = in && emask[ge0 + e];
    const unsigned vb = __ballot_sync(FULL_MASK, valid);
    if (valid) ckey[nv + __popc(vb & ((1u << lane) - 1))] = key;
    nv += __popc(vb);
  }
  __syncwarp();
  for (int i = lane; i < nv; i += 32) {
    const int k = ckey[i];
    const long ge = ge0 + (k & 0xffff);
    const int mv = minor[ge];  // loaded before the rank, used after
    const float wv = w ? w[ge] : 1.f;
    int p = 0;
    for (int j = 0; j < nv; ++j) p += ckey[j] < k;
    skey[p] = k;
    sminor[p] = mv;
    sw[p] = wv;
  }
  __syncwarp();
  return nv;
}

// The forward: out of graph g, slice blockIdx.y. EMB: emb [G, Em, d] is
// read; else the embeddings are zero and nothing of emb is loaded.
template <int VEC, int VPL, bool RELU, bool EMB>
__global__ void __launch_bounds__(32 * WARPS)
dense_agg_fwd_kernel(const float* __restrict__ x, const int* __restrict__ src,
                     const int* __restrict__ dst,
                     const bool* __restrict__ emask,
                     const float* __restrict__ emb,
                     const float* __restrict__ w, float* __restrict__ out,
                     int G, int Sm, int Em, int d) {
  using V = Vec<VEC>;
  // edges whose rows load together: 16 where a lane's share of a row is
  // one float (the split launch of small batches), else the backward's
  constexpr int U = VEC * VPL == 1 ? 16 : VEC * VPL <= 8 ? 4 : 2;
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const long g = (long)blockIdx.x * (blockDim.x >> 5) + wib;
  if (g >= G) return;
  // this warp's [Em] valid keys in slot order, then sorted keys, src, w
  int* const ckey = reinterpret_cast<int*>(smem) + 4L * Em * wib;
  int* const skey = ckey + Em;
  int* const ssrc = skey + Em;
  float* const sw = reinterpret_cast<float*>(ssrc + Em);
  int col[VPL];
  bool has[VPL];  // VEC divides d: all of a vector's channels or none
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    col[j] = blockIdx.y * 32 * VEC * VPL + (lane + 32 * j) * VEC;
    has[j] = col[j] < d;
  }
  const V zero = zero_vec<VEC>();
  const long ge0 = g * Em;
  const int nv =
      sort_slots(dst, src, emask, w, ge0, Em, lane, ckey, skey, ssrc, sw);

  const float* const xg = x + g * Sm * d;
  const float* const eg = EMB ? emb + ge0 * d : nullptr;
  float* const og = out + g * Sm * d;
  V acc[VPL];  // out of row `row`, the first row not yet written
#pragma unroll
  for (int j = 0; j < VPL; ++j) acc[j] = zero;
  int row = 0;
  auto write_to = [&](int s) {  // write the rows before s
    for (; row < s; ++row) {
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        if (has[j]) store_vec(og + (long)row * d + col[j], acc[j]);
        acc[j] = zero;
      }
    }
  };

  for (int k0 = 0; k0 < nv; k0 += 32) {
    const int k = k0 + lane;
    int pk = 0, ps = 0;
    float pw = 0.f;
    if (k < nv) {
      pk = skey[k];
      ps = ssrc[k];
      pw = sw[k];
    }
    const int n = min(32, nv - k0);
    for (int i0 = 0; i0 < n; i0 += U) {
      V xv[U][VPL], ev[U][VPL];
      int du[U];
      float wu[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {  // every edge's rows in flight first
        const int i = (i0 + u) & 31;
        const int ku = __shfl_sync(FULL_MASK, pk, i);
        const long su = __shfl_sync(FULL_MASK, ps, i);
        wu[u] = __shfl_sync(FULL_MASK, pw, i);
        du[u] = ku >> 16;
        const long eu = ku & 0xffff;
        const bool in = i0 + u < n;
#pragma unroll
        for (int j = 0; j < VPL; ++j) {
          const bool ld = has[j] && in;
          xv[u][j] = ld ? load_vec<VEC>(xg + su * d + col[j]) : zero;
          if constexpr (EMB)
            ev[u][j] = ld ? load_vec<VEC>(eg + eu * d + col[j]) : zero;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {  // then their sums, in (dst, slot) order
        if (i0 + u >= n) break;
        write_to(du[u]);
#pragma unroll
        for (int j = 0; j < VPL; ++j) {
          if (!has[j]) continue;
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            float m = xv[u][j].v[i];
            if constexpr (EMB) m += ev[u][j].v[i];
            if (RELU) m = fmaxf(m, 0.f);
            acc[j].v[i] += __fmul_rn(m, wu[u]);  // rounded, as the plain
                                                 // version rounds it
          }
        }
      }
    }
  }
  write_to(Sm);
}

// The backward: dx of graph g, slice blockIdx.y. FULL: demb (if not null)
// and dw_out (if not null, [slices, G, Em]) are written too. emb may be
// null (zero embeddings): nothing of it is loaded.
template <int VEC, int VPL, bool RELU, bool FULL>
__global__ void __launch_bounds__(32 * WARPS)
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
  const int nv =
      sort_slots(src, dst, emask, w, ge0, Em, lane, ckey, skey, sdst, sw);

  const float* const xg = x + g * Sm * d;
  const float* const gg = gout + g * Sm * d;
  const float* const eg = emb ? emb + ge0 * d : nullptr;
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
          ev[u][j] = ld && eg ? load_vec<VEC>(eg + (long)eu[u] * d + col[j])
                              : zero;
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

// One launch of either direction, as the wrapper's geometry gives it: out
// is the forward's output or the backward's dx.
struct Args {
  const float* x;
  const int *src, *dst;
  const bool* emask;
  const float *emb, *w, *gout;
  float *out, *demb, *dw_out;
  int G, Sm, Em, d, relu, full, slices, warps, smem;
};

template <class... P, class... A>
cudaError_t launch(void (*kernel)(P...), const Args& L, cudaStream_t stream,
                   A... args) {
  if (L.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((L.G + L.warps - 1) / L.warps, L.slices);
  kernel<<<grid, 32 * L.warps, L.smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int VEC, int VPL>
struct Fwd {
  template <bool RELU, bool EMB>
  static cudaError_t go(const Args& A, cudaStream_t s) {
    return launch(dense_agg_fwd_kernel<VEC, VPL, RELU, EMB>, A, s, A.x, A.src,
                  A.dst, A.emask, A.emb, A.w, A.out, A.G, A.Sm, A.Em, A.d);
  }
  static cudaError_t run(const Args& A, cudaStream_t s) {
    if (A.relu) return A.emb ? go<true, true>(A, s) : go<true, false>(A, s);
    return A.emb ? go<false, true>(A, s) : go<false, false>(A, s);
  }
};

template <int VEC, int VPL>
struct Bwd {
  template <bool RELU, bool FULL>
  static cudaError_t go(const Args& A, cudaStream_t s) {
    return launch(dense_agg_bwd_kernel<VEC, VPL, RELU, FULL>, A, s, A.x,
                  A.src, A.dst, A.emask, A.emb, A.w, A.gout, A.out, A.demb,
                  A.dw_out, A.G, A.Sm, A.Em, A.d);
  }
  static cudaError_t run(const Args& A, cudaStream_t s) {
    if (A.relu) return A.full ? go<true, true>(A, s) : go<true, false>(A, s);
    return A.full ? go<false, true>(A, s) : go<false, false>(A, s);
  }
};

// L<vec, vpl>::run for the launch's (vec, vpl)
template <template <int, int> class L>
cudaError_t by_width(const Args& A, int vec, int vpl, cudaStream_t s) {
  if (vec == 4) {
    switch (vpl) {
      case 1: return L<4, 1>::run(A, s);
      case 2: return L<4, 2>::run(A, s);
      case 3: return L<4, 3>::run(A, s);
      default: return L<4, 4>::run(A, s);
    }
  }
  switch (vpl) {
    case 1: return L<1, 1>::run(A, s);
    case 2: return L<1, 2>::run(A, s);
    case 3: return L<1, 3>::run(A, s);
    default: return L<1, 4>::run(A, s);
  }
}

// The wrapper's launch (dense_agg.py:fwd_geometry, bwd_geometry): slices of
// 32 * vec * vpl channels covering d once, vec dividing d; a key of major
// << 16 | slot; the shared bytes it names.
bool launch_ok(int G, int Sm, int Em, int d, int vec, int vpl, int slices,
               int warps, int smem) {
  if (G <= 0 || Sm <= 0 || Em < 0 || d <= 0) return false;
  if (!(vec == 1 || vec == 4) || d % vec || vpl < 1 || vpl > MAX_VPL)
    return false;
  const long width = 32L * vec * vpl;
  if (slices < 1 || slices * width < d || (slices - 1) * width >= d)
    return false;
  if (Sm > 32767 || Em > 65536 || warps < 1 || warps > WARPS) return false;
  return smem <= SMEM_MAX && smem == warp_smem(Em, warps);
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out [G, Sm, d]; emb [G, Em, d] may be null (zero embeddings), w [G, Em]
// null (1). The launch (vec, vpl, slices, warps, smem) is the wrapper's
// fwd_geometry; another is refused, as are pointers not aligned to vec
// floats. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int dense_agg_fwd(const float* x, const int* src, const int* dst,
                             const bool* emask, const float* emb,
                             const float* w, float* out, int G, int Sm,
                             int Em, int d, int relu, int vec, int vpl,
                             int slices, int warps, int smem,
                             cudaStream_t stream) {
  if (!launch_ok(G, Sm, Em, d, vec, vpl, slices, warps, smem))
    return cudaErrorInvalidValue;
  if (((unsigned long)x | (unsigned long)emb | (unsigned long)out) %
      (4ul * vec))
    return cudaErrorInvalidValue;
  const Args A{x,  src, dst, emask, emb, w,      nullptr, out,   nullptr,
               nullptr, G,   Sm,    Em,  d, relu, 0,       slices, warps,
               smem};
  return by_width<Fwd>(A, vec, vpl, stream);
}

// dx [G, Sm, d] for the cotangent gout of dense_agg_fwd's out, and where
// not null demb [G, Em, d] (0 on masked slots) and, with w, dw [G, Em];
// dw_part [slices, G, Em] is the caller's scratch where slices > 1 (with
// one slice dw is written directly). emb may be null (zero embeddings; no
// demb then). The launch (vec, vpl, slices, warps, smem) is the wrapper's
// bwd_geometry; another is refused, as are pointers not aligned to vec
// floats.
extern "C" int dense_agg_bwd(const float* x, const int* src, const int* dst,
                             const bool* emask, const float* emb,
                             const float* w, const float* gout, float* dx,
                             float* demb, float* dw, float* dw_part, int G,
                             int Sm, int Em, int d, int relu, int vec,
                             int vpl, int slices, int warps, int smem,
                             cudaStream_t stream) {
  if (!launch_ok(G, Sm, Em, d, vec, vpl, slices, warps, smem))
    return cudaErrorInvalidValue;
  if ((dw && (!w || (slices > 1 && !dw_part))) || (demb && !emb))
    return cudaErrorInvalidValue;
  const unsigned long align = 4ul * vec;
  if (((unsigned long)x | (unsigned long)emb | (unsigned long)gout |
       (unsigned long)dx | (unsigned long)demb) % align)
    return cudaErrorInvalidValue;
  float* const dw_out = slices > 1 ? dw_part : dw;
  const Args A{x,     src,   dst, emask, emb,  w,      gout,
               dx,    demb,  dw ? dw_out : nullptr,    G,
               Sm,    Em,    d,   relu,  demb || dw, slices,
               warps, smem};
  const cudaError_t err = by_width<Bwd>(A, vec, vpl, stream);
  if (err != cudaSuccess || !dw || slices == 1) return err;
  return strided::sum_rows(dw_part, dw, slices, (long)G * Em, stream);
}
