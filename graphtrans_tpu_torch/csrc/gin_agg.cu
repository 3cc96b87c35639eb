// K1: GIN aggregation with the bond-embedding lookup inside the kernel
// (forward and backward). Wrapper, plain version and design note:
// graphtrans_tpu_torch/ops/kernels/gin_agg.py.
//
//   out[g,s,c] = scale*x[g,s,c] + sum_{e: mask[g,e], dst[g,e]=s}
//                w[g,e] * relu(x[g,src[g,e],c] + sum_f T[attr[g,f,e], c])
//
// Forward (below): one block per (chunk of graphs, slice of channels; one
// slice of all d at the throughput batches), the grid sized to the card by
// gin_agg.py:fwd_geometry under the same rules as the backward's. Each
// thread owns VEC neighbouring channels (16-byte accesses where d % 4 ==
// 0). A graph's x slice lands in shared memory by cp.async, issued when
// the walk of the graph before ends, so it lands while the graph's edges
// are sorted. The valid edges are sorted by (dst, slot) in shared
// memory once for all of d, masked slots dropped, so each output row is
// summed in registers in the parent design's order and written once with
// scale*x added. src, dst and attr must be in range on every edge slot,
// masked ones included.
//
// Backward (K1-bwd, below): one block per (chunk of graphs, slice of
// channels; one slice of all d at the throughput batches), the grid sized
// to the card by gin_agg.py:bwd_geometry. Each thread owns VEC neighbouring
// channels (16-byte accesses where d % 4 == 0). A graph's gout rows (and
// its x, where a block walks one graph) land by cp.async while its edge
// lists load; where a block walks a chunk of graphs, x streams through a
// ring of XRING rows ahead of the walk. The valid
// edges are sorted by source row in shared memory, so dx of a row is
// summed in registers and written once. dT and dscale accumulate in the
// block across its chunk and leave as per-block partials that a second
// kernel adds in a fixed order with the whole card; dw (a sum over
// channels) is reduced across the block's warps per edge. No atomics:
// every sum has a fixed order, and a run gives the same bits every time.
//
// bf16 instances (the bf16 step): x, T, w, gout, out and dx are bf16, read
// and written VEC elements at a time (8-byte accesses at VEC 4, so d =
// 300, 600 bytes a row, keeps the f32 instance's lanes), staged in shared
// memory as bf16 (half the f32 instance's bytes); every sum is float32.
// They round where the JAX kernel rounds in bf16 (graphtrans_tpu/ops/
// pallas/gin_agg.py:126-166, :169-222): a message relu(x_src + sum T) * w
// once before its destination sum, out once; dmsg (gout * w, relu and
// mask applied) once before the dx and dT sums, dx once; dT and dw leave
// the cross-block sums rounded once; dscale stays float32.

#include <cuda_runtime.h>

#include "mma_tf32.cuh"
#include "vec.cuh"

namespace {

using vio::bf16;
using vio::cp_elems;
using vio::round_to;
using vio::to_float;

constexpr int SMEM_MAX = 232448;      // dynamic shared bytes a block may take

using vio::load_vec;
using vio::load_vec_ro;
using vio::store_vec;
using vio::Vec;
using vio::zero_vec;

// ---- the forward ----------------------------------------------------------

constexpr int MAX_THREADS = 256;  // threads a block, either way (gin_agg.py)
constexpr int FWD_EU = 4;         // edges whose loads a thread issues together

// bytes of n elements of `esize` bytes, rounded up to whole words
__host__ __device__ inline long words_of(long n, int esize) {
  return (n * esize + 3) / 4 * 4;
}

// Shared bytes of a forward block (gin_agg.py:fwd_smem): one graph's x
// slice [Sm][sc] in the instance's element type (esize bytes), then per
// edge slot its sorted record (src | dst << 16, the F table rows, with w
// the weight) and its sort key.
__host__ __device__ inline long fwd_smem(int Sm, int Em, int F, int sc,
                                         bool has_w, int esize) {
  return words_of((long)Sm * sc, esize) +
         4L * Em * (2 + F + (has_w ? 1 : 0));
}

// One block per (chunk of gpb graphs, slice of sc channels); thread t owns
// channels c0 + VEC t .. + VEC - 1 of every row, so no cell has two writers,
// and reads its own columns of the x buffer only (no barrier guards them).
// Per graph: the keys dst * Em + slot of the valid slots, then each valid
// slot's rank among them (a stable sort by (dst, slot)) places its record,
// read from global memory, in a sorted list; the walk visits the records in
// order, so the edges of each row come together in slot order (the order in
// which the parent design added them into a shared accumulator), FWD_EU
// records' table rows and x rows loaded before their adds. A row is closed
// when the walk passes it: out = acc (+ scale * x), written once from
// registers. The next graph's x is issued when this walk ends and lands
// while its edges are sorted. NF = F for 1 to 4 table rows an edge, 0 for
// any F. E: float, or bf16 (a message rounded before its sum, out once).
template <class E, int VEC, bool HAS_W, int NF>
__global__ void __launch_bounds__(MAX_THREADS)
gin_agg_fwd_kernel(const E* __restrict__ x, const int* __restrict__ src,
                   const int* __restrict__ dst, const bool* __restrict__ emask,
                   const int* __restrict__ attr, const E* __restrict__ tbl,
                   const E* __restrict__ w, const float* __restrict__ scale,
                   E* __restrict__ out, int G, int Sm, int Em, int Fr, int d,
                   int gpb, int sc) {
  using VecT = Vec<VEC>;
  const int F = NF ? NF : Fr;
  const int R = 1 + F + (HAS_W ? 1 : 0);  // ints a record
  extern __shared__ int4 smem4[];
  E* const xbuf = reinterpret_cast<E*>(smem4);  // [Sm][sc]
  int* const rec = reinterpret_cast<int*>(
      reinterpret_cast<char*>(smem4) + words_of((long)Sm * sc, sizeof(E)));
  int* const key = rec + (long)Em * R;  // [Em]; INT_MAX on a masked slot

  const int t = threadIdx.x, T = blockDim.x;
  const int cl = t * VEC;               // this thread's first column
  const int c = blockIdx.y * sc + cl;   // and channel
  const bool own = cl < sc;             // lanes past the slice hold none
  const bool live = own && c < d;       // VEC divides d: all or none
  const int cc = live ? c : 0;          // an address for the zero copies
  const int ccl = own ? cl : 0;         // a column for the discarded loads
  const long g0 = (long)blockIdx.x * gpb;
  const long g1 = g0 + gpb < G ? g0 + gpb : (long)G;
  const float scv = scale ? *scale : 0.f;
  const E* const tblc = tbl + cc;       // its table column

  // graph g's x slice, this thread's channels, into the buffer: one group
  auto stage_x = [&](long g) {
    if (own) {
      const E* xg = x + g * Sm * d + cc;
      for (int r = 0; r < Sm; ++r)
        cp_elems<VEC>(xbuf + r * sc + cl, xg + (long)r * d, live);
    }
    tc::cp_commit();
  };
  stage_x(g0);

  for (long g = g0; g < g1; ++g) {
    __syncthreads();  // every thread is done with g - 1's records

    // the valid slots' keys, then each one's rank places its record
    int nv = 0;
    for (int e0 = 0; e0 < Em; e0 += T) {
      const int e = e0 + t;
      bool valid = false;
      if (e < Em) {
        const long ge = g * Em + e;
        valid = emask[ge];
        key[e] = valid ? dst[ge] * Em + e : 0x7fffffff;
      }
      nv += __syncthreads_count(valid);
    }
    for (int e = t; e < Em; e += T) {
      const int k = key[e];
      if (k == 0x7fffffff) continue;
      const long ge = g * Em + e;
      const int sv = src[ge];  // loaded before the rank, used after
      int av[NF ? NF : 1];
      if constexpr (NF > 0) {
#pragma unroll
        for (int f = 0; f < NF; ++f) av[f] = attr[(g * NF + f) * Em + e];
      }
      const float wv = HAS_W ? to_float(w[ge]) : 0.f;
      int p = 0;
#pragma unroll 8
      for (int j = 0; j < Em; ++j) p += key[j] < k;
      int* r = rec + (long)p * R;
      r[0] = (int)((unsigned)sv | (unsigned)(k / Em) << 16);
      if constexpr (NF > 0) {
#pragma unroll
        for (int f = 0; f < NF; ++f) r[1 + f] = av[f];
      } else {
        for (int f = 0; f < F; ++f) r[1 + f] = attr[(g * F + f) * Em + e];
      }
      if (HAS_W) r[1 + F] = __float_as_int(wv);
    }
    __syncthreads();
    tc::cp_wait_group<0>();  // graph g's x (this thread's own copies)

    const E* const xs = xbuf + ccl;
    E* const og = out + g * Sm * d + cc;
    VecT acc = zero_vec<VEC>();
    int row = 0;
    auto close_to = [&](int s) {  // write the rows before s
      for (; row < s; ++row) {
        VecT o = acc;
        if (scale) {
          const VecT xr = load_vec<VEC>(xs + row * sc);
#pragma unroll
          for (int j = 0; j < VEC; ++j) o.v[j] += scv * xr.v[j];
        }
        if (live) store_vec(og + (long)row * d, o);
        acc = zero_vec<VEC>();
      }
    };

    // the walk. Every lane loads (a lane past the slice at column 0, its
    // sums discarded), so a warp takes no branch on its lanes.
    for (int k0 = 0; k0 < nv; k0 += FWD_EU) {
      VecT ev[FWD_EU], xv[FWD_EU];
      int du[FWD_EU];
      float wu[FWD_EU];
#pragma unroll
      for (int u = 0; u < FWD_EU; ++u) {
        const int k = k0 + u < nv ? k0 + u : nv - 1;
        const int* rk = rec + (long)k * R;
        const int sd = rk[0];
        du[u] = (int)((unsigned)sd >> 16);
        wu[u] = HAS_W ? __int_as_float(rk[1 + F]) : 1.f;
        ev[u] = load_vec_ro<VEC>(tblc + (long)rk[1] * d);  // the parent's
        for (int f = 1; f < F; ++f) {                    // order: T[a0] +
          const VecT q = load_vec_ro<VEC>(tblc + (long)rk[1 + f] * d);
#pragma unroll                                             // T[a1] + ...
          for (int j = 0; j < VEC; ++j) ev[u].v[j] += q.v[j];
        }
        xv[u] = load_vec<VEC>(xs + (sd & 0xffff) * sc);
      }
#pragma unroll
      for (int u = 0; u < FWD_EU; ++u) {
        if (k0 + u >= nv) break;
        close_to(du[u]);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          float m = xv[u].v[j] + ev[u].v[j];
          m = fmaxf(m, 0.f);
          if (HAS_W) m *= wu[u];
          acc.v[j] += round_to<E>(m);
        }
      }
    }
    close_to(Sm);
    if (g + 1 < g1) stage_x(g + 1);  // its x, after the walk
  }
}

// The wrapper's launch (gin_agg.py:fwd_geometry): slices of sc channels
// covering d once (VEC dividing d and sc), a warp's lanes all in the slice
// but the last warp's, the shared bytes it names.
bool fwd_launch_ok(int Sm, int Em, int F, int V, int d, bool has_w, int vec,
                   int gpb, int slices, int sc, int threads, int smem,
                   int esize) {
  if (!(vec == 1 || vec == 4) || d % vec || sc <= 0 || sc % vec) return false;
  if (slices < 1 || (long)slices * sc < d || (long)(slices - 1) * sc >= d)
    return false;
  const int lanes = sc / vec;
  if (threads % 32 || threads > MAX_THREADS || lanes > threads ||
      lanes <= threads - 32)
    return false;
  if (gpb < 1 || F < 1 || V < 1 || Sm > 65536 || (long)Sm * Em >= 0x7fffffff)
    return false;
  return smem <= SMEM_MAX && smem == fwd_smem(Sm, Em, F, sc, has_w, esize);
}

template <class E>
struct FwdArgs {
  const E* x;
  const int *src, *dst;
  const bool* emask;
  const int* attr;
  const E *tbl, *w;
  const float* scale;
  E* out;
  int G, Sm, Em, F, d, gpb, slices, sc, threads, smem;
};

template <class E, int VEC, bool HAS_W, int NF>
cudaError_t launch_fwd_main(const FwdArgs<E>& A, cudaStream_t stream) {
  const auto kernel = gin_agg_fwd_kernel<E, VEC, HAS_W, NF>;
  static const cudaError_t set = [&] {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
  }();
  if (set != cudaSuccess) return set;
  kernel<<<dim3((A.G + A.gpb - 1) / A.gpb, A.slices), A.threads, A.smem,
           stream>>>(A.x, A.src, A.dst, A.emask, A.attr, A.tbl, A.w, A.scale,
                     A.out, A.G, A.Sm, A.Em, A.F, A.d, A.gpb, A.sc);
  return cudaGetLastError();
}

template <class E, int VEC, bool HAS_W>
cudaError_t launch_fwd_f(const FwdArgs<E>& A, cudaStream_t stream) {
  switch (A.F) {
    case 1: return launch_fwd_main<E, VEC, HAS_W, 1>(A, stream);
    case 2: return launch_fwd_main<E, VEC, HAS_W, 2>(A, stream);
    case 3: return launch_fwd_main<E, VEC, HAS_W, 3>(A, stream);
    case 4: return launch_fwd_main<E, VEC, HAS_W, 4>(A, stream);
    default: return launch_fwd_main<E, VEC, HAS_W, 0>(A, stream);
  }
}

// ---- the backward ---------------------------------------------------------
//
// dmsg[e] = gout[dst[e]] * w[e] * (pre[e] > 0) on valid edges, with
// pre = x[src] + sum_f T[attr_f]; dx = scale*gout + scatter of dmsg to src;
// dT[attr_f] += dmsg; dw[e] = sum_c gout[dst[e]] * relu(pre[e]);
// dscale = sum gout * x.

constexpr int BWD_MAX_THREADS = 256;  // threads a block (gin_agg.py)
constexpr int BWD_MAX_F = 4;          // table rows an edge sums
constexpr int XRING = 8;              // rows of x in flight in a ring
constexpr int TAIL_THREADS = 256;     // the cross-block sums' block
constexpr int TAIL_COLS = 32;         // dT columns a tail block adds
constexpr int TAIL_GROUPS = TAIL_THREADS / TAIL_COLS;

// Shared bytes of a backward block (gin_agg.py:bwd_smem): the sorted edge
// records [Em][8] ints (src, dst, the F table rows, w); one graph's gout
// slice [Sm][sc], xr rows of x [xr][sc] (the slice, or a ring of XRING),
// both in the instance's element type (esize bytes), and the bond table's
// gradient [V][sc] in float (bf16: before gout, so it keeps 16-byte
// alignment); per edge slot the staged lists (src, dst, F table rows, sort
// key) and the slot's sorted position; with w the staged weights and the
// per-warp dw sums [threads/32][Em]; 32 floats of scratch.
__host__ __device__ inline long bwd_smem(int Sm, int Em, int F, int V, int sc,
                                         int threads, bool has_w, int xr,
                                         int esize) {
  long words = 8L * Em + (long)V * sc + (long)Em * (F + 4) + 32;
  if (has_w) words += (long)Em * (1 + threads / 32);
  return 4 * words + words_of((long)(Sm + xr) * sc, esize);
}

// One block per (chunk of gpb graphs, slice of sc channels); thread t owns
// channels c0 + VEC t .. + VEC - 1 of every row, so no cell has two writers,
// and reads its own columns of the shared rows only (no barrier guards
// them). A graph's gout slice lands by cp.async while its edge lists are
// loaded (the other blocks on the SM walk meanwhile); its valid edges are
// sorted by (src, slot) in shared memory (each slot's rank among the keys
// src * Em + slot) into records of eight ints, so the walk visits the rows
// in order and a row's edges in slot order: x is read once a row, and dx
// of a row is summed in registers from scale*gout in the order of the
// forward's scatter and written once. Where a block walks one graph (a
// small batch) x lands whole with gout (xr = Sm); where it walks a chunk,
// x streams through a ring of XRING rows that cp.async keeps in flight
// ahead of the walk (xr = XRING), so a block holds gout and a few rows of
// x and three blocks share an SM at the bench batch. Per edge, a lane
// loads the record and gout[dst] from shared memory and the table rows
// through the read-only cache; every lane loads, so a warp takes no
// branch on its lanes.
// dT: each of the NF table-row features keeps the run of its last row's
// sum in registers, added into the block's shared [V][sc] when the row
// changes (consecutive edges share bond types); dscale per thread. Both
// leave as per-block partials for the tail kernel after the chunk; dw is
// reduced over the block's warps per edge and written per channel slice. The relu decision uses the forward's sum: pre
// = x[src] + (T[attr_0] + T[attr_1] + ...), in that order. E: float, or
// bf16 (dmsg rounded before the dx and dT sums, dx once).
template <class E, int VEC, bool HAS_W, int NF>
__global__ void __launch_bounds__(BWD_MAX_THREADS)
gin_agg_bwd_kernel(const E* __restrict__ x, const int* __restrict__ src,
                   const int* __restrict__ dst, const bool* __restrict__ emask,
                   const int* __restrict__ attr, const E* __restrict__ tbl,
                   const E* __restrict__ w, const float* __restrict__ scale,
                   const E* __restrict__ gout, E* __restrict__ dx,
                   float* __restrict__ dtbl_part, float* __restrict__ dw_out,
                   float* __restrict__ dsc_part, int G, int Sm, int Em, int V,
                   int d, int gpb, int sc, int xr) {
  using VecT = Vec<VEC>;
  constexpr bool F32 = sizeof(E) == 4;
  extern __shared__ int4 smem4[];
  int4* const rec = smem4;               // [Em][2]: sorted edge records
  // f32: gout, x, dT; bf16: dT, gout, x
  float* const dt16 = reinterpret_cast<float*>(rec + 2 * Em);
  E* const gsm = F32 ? reinterpret_cast<E*>(rec + 2 * Em)
                     : reinterpret_cast<E*>(dt16 + V * sc);  // [Sm][sc]
  E* const xbuf = gsm + (long)Sm * sc;   // [xr][sc] rows of x
  float* const dts = F32 ? reinterpret_cast<float*>(xbuf + xr * sc) : dt16;
  char* const after =
      F32 ? reinterpret_cast<char*>(dts + V * sc)
          : reinterpret_cast<char*>(gsm) + words_of((long)(Sm + xr) * sc, 2);
  int* const rs = reinterpret_cast<int*>(after);  // staged src
  int* const rd = rs + Em;        // dst
  int* const ra = rd + Em;        // [NF][Em] table rows
  int* const key = ra + NF * Em;  // src * Em + slot; INT_MAX on a masked slot
  int* const pos = key + Em;      // a slot's sorted position, -1 if masked
  float* const rw = reinterpret_cast<float*>(pos + Em);  // with w: staged w
  float* const wsum = rw + (HAS_W ? Em : 0);             // [warps][Em]
  float* const red = wsum + (HAS_W ? (blockDim.x / 32) * Em : 0);  // [32]

  const int t = threadIdx.x, T = blockDim.x, warps = T / 32;
  const int cl = t * VEC;                 // this thread's first column
  const int c = blockIdx.y * sc + cl;     // and channel
  const bool own = cl < sc;               // lanes past the slice hold none
  const bool live = own && c < d;         // VEC divides d: all or none
  const int cc = live ? c : 0;            // an address for the zero copies
  const long chunk = blockIdx.x;
  const long g0 = chunk * gpb;
  const long g1 = g0 + gpb < G ? g0 + gpb : (long)G;
  const float scv = scale ? *scale : 0.f;
  const int ccl = own ? cl : 0;           // a column for the discarded loads
  const E* const gs = gsm + ccl;          // this thread's columns
  E* const xs = xbuf + ccl;
  const bool ring = xr < Sm;
  const E* const tblc = tbl + cc;         // its table column (V*d < 2^31)

  if (own)
    for (int v = 0; v < V; ++v) store_vec(dts + v * sc + cl, zero_vec<VEC>());
  // dT's runs: per feature the table row of the run and its sum
  int crow[NF];
  VecT cacc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    crow[f] = -1;
    cacc[f] = zero_vec<VEC>();
  }
  auto flush = [&](int f) {
    if (own && crow[f] >= 0) {
      float* p = dts + crow[f] * sc + cl;
      VecT q = load_vec<VEC>(p);
#pragma unroll
      for (int j = 0; j < VEC; ++j) q.v[j] += cacc[f].v[j];
      store_vec(p, q);
    }
  };

  float dsc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) dsc[j] = 0.f;
  for (long g = g0; g < g1; ++g) {
    __syncthreads();  // every thread is done with g - 1's lists
    const E* const xg = x + g * Sm * d + cc;
    if (own) {  // graph g's gout (and x if it fits), this thread's channels
      const E* gg = gout + g * Sm * d + cc;
      for (int r = 0; r < Sm; ++r) {
        cp_elems<VEC>(gsm + r * sc + cl, gg + (long)r * d, live);
        if (!ring) cp_elems<VEC>(xs + r * sc, xg + (long)r * d, live);
      }
    }
    tc::cp_commit();
    // row r of graph g's x into the ring: a group a row, empty past the last
    auto stage_x = [&](int r) {
      if (own && r < Sm)
        cp_elems<VEC>(xs + (r % XRING) * sc, xg + (long)r * d, live);
      tc::cp_commit();
    };

    // graph g's edge lists, then the valid slots sorted by (src, slot)
    int nv = 0;
    for (int e0 = 0; e0 < Em; e0 += T) {
      const int e = e0 + t;
      bool valid = false;
      if (e < Em) {
        const long ge = g * Em + e;
        const int sv = src[ge];
        valid = emask[ge];
        rs[e] = sv;
        rd[e] = dst[ge];
#pragma unroll
        for (int f = 0; f < NF; ++f)
          ra[f * Em + e] = attr[(g * NF + f) * Em + e];
        if (HAS_W) rw[e] = to_float(w[ge]);
        key[e] = valid ? sv * Em + e : 0x7fffffff;
      }
      nv += __syncthreads_count(valid);
    }
    for (int e = t; e < Em; e += T) {
      const int k = key[e];
      int p = -1;
      if (k != 0x7fffffff) {
        p = 0;
#pragma unroll 8
        for (int j = 0; j < Em; ++j) p += key[j] < k;
        int r8[8] = {rs[e], rd[e], 0, 0, 0, 0, 0, 0};
#pragma unroll
        for (int f = 0; f < NF; ++f) r8[2 + f] = ra[f * Em + e];
        if (HAS_W) r8[6] = __float_as_int(rw[e]);
        rec[2 * p] = make_int4(r8[0], r8[1], r8[2], r8[3]);
        rec[2 * p + 1] = make_int4(r8[4], r8[5], r8[6], r8[7]);
      }
      pos[e] = p;
    }
    __syncthreads();
    tc::cp_wait_group<0>();  // graph g's gout (and x)
    if (ring)
      for (int r = 0; r < XRING; ++r) stage_x(r);

    E* const dxg = dx + g * Sm * d + c;
    VecT acc, xv;
    auto open_row = [&](int r) {
      if (ring)  // row r's x, the oldest group in flight
        tc::cp_wait_group<XRING - 1>();
      xv = load_vec<VEC>(xs + (ring ? r % XRING : r) * sc);
      const VecT gv = load_vec<VEC>(gs + r * sc);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        acc.v[j] = scale ? scv * gv.v[j] : 0.f;
        if (scale && own) dsc[j] = fmaf(gv.v[j], xv.v[j], dsc[j]);
      }
    };
    auto close_row = [&](int r) {
      if (live) store_vec(dxg + (long)r * d, acc);
      if (ring) stage_x(r + XRING);  // into row r's slot: x is in registers
    };

    // the walk: row by row, a row's edges in slot order. Every lane loads
    // (a lane past the slice at channel 0, its sums discarded), so a warp
    // takes no branch on its lanes.
    int row = 0;
    open_row(0);
    for (int k = 0; k < nv; ++k) {
      const int4 r0 = rec[2 * k];
      const int4 r1 =
          (NF > 2 || HAS_W) ? rec[2 * k + 1] : make_int4(0, 0, 0, 0);
      const int a[4] = {r0.z, r0.w, r1.x, r1.y};
      VecT emb = load_vec_ro<VEC>(tblc + a[0] * d);  // the forward's order:
#pragma unroll                                    // T[a0] + T[a1] + ...
      for (int f = 1; f < NF; ++f) {
        const VecT q = load_vec_ro<VEC>(tblc + a[f] * d);
#pragma unroll
        for (int j = 0; j < VEC; ++j) emb.v[j] += q.v[j];
      }
      const VecT gm = load_vec<VEC>(gs + r0.y * sc);
      while (row < r0.x) {  // then xv holds x[src]
        close_row(row);
        open_row(++row);
      }
      const float we = HAS_W ? __int_as_float(r1.z) : 1.f;
      VecT dm;
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float pre = xv.v[j] + emb.v[j];
        const float m = HAS_W ? gm.v[j] * we : gm.v[j];
        dm.v[j] = pre > 0.f ? round_to<E>(m) : 0.f;
        acc.v[j] += dm.v[j];
        if (HAS_W) part += own ? gm.v[j] * fmaxf(pre, 0.f) : 0.f;
      }
      // dT[attr_f] += dmsg: into the feature's run, or a new run
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        if (a[f] == crow[f]) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) cacc[f].v[j] += dm.v[j];
        } else {
          flush(f);
          crow[f] = a[f];
          cacc[f] = dm;
        }
      }
      if (HAS_W) {
        for (int o = 16; o > 0; o >>= 1)
          part += __shfl_down_sync(0xffffffffu, part, o);
        if ((t & 31) == 0) wsum[(t >> 5) * Em + k] = part;
      }
    }
    close_row(row);
    while (++row < Sm) {
      open_row(row);
      close_row(row);
    }
    if (ring) tc::cp_wait_group<0>();  // the ring's last (empty) groups
    if (HAS_W) {  // each slot's dw over the slice: its warps' sums in order
      __syncthreads();
      for (int e = t; e < Em; e += T) {
        const int p = pos[e];
        float v = 0.f;
        if (p >= 0)
          for (int i = 0; i < warps; ++i) v += wsum[i * Em + p];
        dw_out[((long)blockIdx.y * G + g) * Em + e] = v;
      }
    }
  }
#pragma unroll
  for (int f = 0; f < NF; ++f) flush(f);

  if (live)
    for (int v = 0; v < V; ++v)
      store_vec(dtbl_part + (chunk * V + v) * d + c,
                load_vec<VEC>(dts + v * sc + cl));
  if (scale) {  // the block's dscale: each warp's tree, then warps in order
    float p = 0.f;
#pragma unroll
    for (int j = 0; j < VEC; ++j) p += dsc[j];
    for (int o = 16; o > 0; o >>= 1) p += __shfl_down_sync(0xffffffffu, p, o);
    if ((t & 31) == 0) red[t >> 5] = p;
    __syncthreads();
    if (t == 0) {
      float s = 0.f;
      for (int i = 0; i < warps; ++i) s += red[i];
      dsc_part[chunk * gridDim.y + blockIdx.y] = s;
    }
  }
}

// The cross-block sums of the backward, each in a fixed order (no atomics):
// blocks [0, bt) add the P chunks' dT partials [P, m], TAIL_COLS columns a
// block, each column's rows split over TAIL_GROUPS threads whose sums are
// added in group order; blocks [bt, bt + bw) add the n channel slices' dw
// partials [n, mw] in slice order, one element a thread; with dscale, the
// last block adds the Q blocks' partials, a tree over the block. dT and
// dw are written in E (bf16: each float32 sum rounded once).
template <class E>
__global__ void __launch_bounds__(TAIL_THREADS)
gin_agg_bwd_sum_kernel(const float* __restrict__ dtp, E* __restrict__ dt,
                       int P, int m, const float* __restrict__ dwp,
                       E* __restrict__ dw, int n, long mw,
                       const float* __restrict__ dsp, float* __restrict__ ds,
                       int Q, int bt, int bw) {
  __shared__ float part[TAIL_THREADS];
  const int t = threadIdx.x;
  int b = blockIdx.x;
  if (b < bt) {
    const int col = b * TAIL_COLS + t % TAIL_COLS, grp = t / TAIL_COLS;
    float s = 0.f;
    if (col < m)
      for (int i = grp; i < P; i += TAIL_GROUPS) s += dtp[(long)i * m + col];
    part[t] = s;
    __syncthreads();
    if (grp == 0 && col < m) {
      float v = part[t];
      for (int k = 1; k < TAIL_GROUPS; ++k) v += part[k * TAIL_COLS + t];
      if constexpr (sizeof(E) == 4)
        dt[col] = v;
      else
        dt[col] = __float2bfloat16_rn(v);
    }
    return;
  }
  b -= bt;
  if (b < bw) {
    const long j = (long)b * TAIL_THREADS + t;
    if (j < mw) {
      float v = dwp[j];
      for (int i = 1; i < n; ++i) v += dwp[i * mw + j];
      if constexpr (sizeof(E) == 4)
        dw[j] = v;
      else
        dw[j] = __float2bfloat16_rn(v);
    }
    return;
  }
  float s = 0.f;
  for (int i = t; i < Q; i += TAIL_THREADS) s += dsp[i];
  part[t] = s;
  __syncthreads();
  for (int o = TAIL_THREADS / 2; o > 0; o >>= 1) {
    if (t < o) part[t] += part[t + o];
    __syncthreads();
  }
  if (t == 0) *ds = part[0];
}

// The wrapper's launch (gin_agg.py:bwd_geometry) covers every channel once
// with slices of sc channels (VEC dividing d and sc), a warp's lanes all
// in the slice but the last warp's, and needs the shared bytes it names.
bool bwd_launch_ok(int Sm, int Em, int F, int V, int d, bool has_w, int vec,
                   int gpb, int slices, int sc, int threads, int smem,
                   int xr, int esize) {
  if (!(vec == 1 || vec == 4) || d % vec || sc <= 0 || sc % vec) return false;
  if (slices < 1 || (long)slices * sc < d || (long)(slices - 1) * sc >= d)
    return false;
  const int lanes = sc / vec;
  if (threads % 32 || threads > BWD_MAX_THREADS || lanes > threads ||
      lanes <= threads - 32)
    return false;
  if (gpb < 1 || F < 1 || F > BWD_MAX_F || (long)V * d > 0x7fffffff)
    return false;
  if (!(xr == Sm || (xr == XRING && Sm > XRING))) return false;
  return smem <= SMEM_MAX &&
         smem == bwd_smem(Sm, Em, F, V, sc, threads, has_w, xr, esize);
}

template <class E>
struct BwdArgs {
  const E* x;
  const int *src, *dst;
  const bool* emask;
  const int* attr;
  const E *tbl, *w;
  const float* scale;
  const E* gout;
  E* dx;
  float *dtbl_part, *dw_out, *dsc_part;
  int G, Sm, Em, V, d, gpb, slices, sc, threads, smem, xr;
};

template <class E, int VEC, bool HAS_W, int NF>
cudaError_t launch_bwd_main(const BwdArgs<E>& A, cudaStream_t stream) {
  const auto kernel = gin_agg_bwd_kernel<E, VEC, HAS_W, NF>;
  static const cudaError_t set = [&] {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
  }();
  if (set != cudaSuccess) return set;
  kernel<<<dim3((A.G + A.gpb - 1) / A.gpb, A.slices), A.threads, A.smem,
           stream>>>(A.x, A.src, A.dst, A.emask, A.attr, A.tbl, A.w, A.scale,
                     A.gout, A.dx, A.dtbl_part, A.dw_out, A.dsc_part, A.G,
                     A.Sm, A.Em, A.V, A.d, A.gpb, A.sc, A.xr);
  return cudaGetLastError();
}

template <class E, int VEC, bool HAS_W>
cudaError_t launch_bwd_f(const BwdArgs<E>& A, int F, cudaStream_t stream) {
  switch (F) {
    case 1: return launch_bwd_main<E, VEC, HAS_W, 1>(A, stream);
    case 2: return launch_bwd_main<E, VEC, HAS_W, 2>(A, stream);
    case 3: return launch_bwd_main<E, VEC, HAS_W, 3>(A, stream);
    default: return launch_bwd_main<E, VEC, HAS_W, 4>(A, stream);
  }
}

// The forward of either instance (the C entries below).
template <class E>
int fwd_entry(const E* x, const int* src, const int* dst, const bool* emask,
              const int* attr, const E* tbl, const E* w, const float* scale,
              E* out, int G, int Sm, int Em, int F, int V, int d, int vec,
              int gpb, int slices, int sc, int threads, int smem,
              cudaStream_t stream) {
  constexpr int ES = sizeof(E);
  if (G <= 0 || Sm <= 0 || Em < 0 || d <= 0 ||
      !fwd_launch_ok(Sm, Em, F, V, d, w != nullptr, vec, gpb, slices, sc,
                     threads, smem, ES))
    return cudaErrorInvalidValue;
  const unsigned long align = (unsigned long)ES * vec;
  if (((unsigned long)x | (unsigned long)tbl | (unsigned long)out) % align)
    return cudaErrorInvalidValue;
  const FwdArgs<E> A{x,  src, dst, emask, attr,   tbl, w,       scale, out, G,
                     Sm, Em,  F,   d,     gpb,    slices, sc, threads, smem};
  return vec == 4 ? (w ? launch_fwd_f<E, 4, true>(A, stream)
                       : launch_fwd_f<E, 4, false>(A, stream))
                  : (w ? launch_fwd_f<E, 1, true>(A, stream)
                       : launch_fwd_f<E, 1, false>(A, stream));
}

// The backward of either instance: the main kernel, then the cross-block
// sums. dw goes through dw_part (float) whenever the main kernel cannot
// write it: with slices > 1, or in bf16.
template <class E>
int bwd_entry(const E* x, const int* src, const int* dst, const bool* emask,
              const int* attr, const E* tbl, const E* w, const float* scale,
              const E* gout, E* dx, E* dtbl, E* dw, float* dscale,
              float* dtbl_part, float* dw_part, float* dsc_part, int G,
              int Sm, int Em, int F, int V, int d, int vec, int gpb,
              int slices, int sc, int threads, int smem, int xr,
              cudaStream_t stream) {
  constexpr int ES = sizeof(E);
  if (G <= 0 || Sm <= 0 || Em < 0 || V < 0 || d <= 0 ||
      !bwd_launch_ok(Sm, Em, F, V, d, w != nullptr, vec, gpb, slices, sc,
                     threads, smem, xr, ES))
    return cudaErrorInvalidValue;
  const unsigned long align = (unsigned long)ES * vec;
  if (((unsigned long)x | (unsigned long)tbl | (unsigned long)gout |
       (unsigned long)dx | (unsigned long)dtbl_part) % align)
    return cudaErrorInvalidValue;
  const bool direct = ES == 4 && slices == 1;  // dw written by the kernel
  float* dw_out = direct ? reinterpret_cast<float*>(dw) : dw_part;
  if (w && dw_out == nullptr) return cudaErrorInvalidValue;
  const int chunks = (G + gpb - 1) / gpb;
  const BwdArgs<E> A{x,  src,       dst,    emask,    attr, tbl,    w,
                     scale, gout, dx, dtbl_part, dw_out, dsc_part, G, Sm,
                     Em, V,    d,  gpb,       slices, sc,       threads, smem,
                     xr};
  const cudaError_t err =
      vec == 4 ? (w ? launch_bwd_f<E, 4, true>(A, F, stream)
                    : launch_bwd_f<E, 4, false>(A, F, stream))
               : (w ? launch_bwd_f<E, 1, true>(A, F, stream)
                    : launch_bwd_f<E, 1, false>(A, F, stream));
  if (err != cudaSuccess) return err;
  const int m = V * d;
  const int bt = (m + TAIL_COLS - 1) / TAIL_COLS;
  const long mw = (long)G * Em;
  const int bw =
      w && !direct ? (int)((mw + TAIL_THREADS - 1) / TAIL_THREADS) : 0;
  const int blocks = bt + bw + (scale ? 1 : 0);
  if (blocks == 0) return cudaSuccess;
  gin_agg_bwd_sum_kernel<E><<<blocks, TAIL_THREADS, 0, stream>>>(
      dtbl_part, dtbl, chunks, m, dw_part, dw, slices, mw, dsc_part, dscale,
      chunks * slices, bt, bw);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Returns cudaGetLastError() after the launch (0 = launched). The launch
// (vec, gpb, slices, sc, threads, smem) is the wrapper's
// fwd_geometry; one that does not cover (G, d), or whose pointers are not
// aligned to vec elements, is refused. gin_agg_fwd_bf16: x, tbl, w and out
// bf16 (scale float).
extern "C" int gin_agg_fwd(const float* x, const int* src, const int* dst,
                           const bool* emask, const int* attr,
                           const float* tbl, const float* w,
                           const float* scale, float* out, int G, int Sm,
                           int Em, int F, int V, int d, int vec, int gpb,
                           int slices, int sc, int threads, int smem,
                           cudaStream_t stream) {
  return fwd_entry<float>(x, src, dst, emask, attr, tbl, w, scale, out, G, Sm,
                          Em, F, V, d, vec, gpb, slices, sc, threads, smem,
                          stream);
}

extern "C" int gin_agg_fwd_bf16(const bf16* x, const int* src, const int* dst,
                                const bool* emask, const int* attr,
                                const bf16* tbl, const bf16* w,
                                const float* scale, bf16* out, int G, int Sm,
                                int Em, int F, int V, int d, int vec, int gpb,
                                int slices, int sc, int threads, int smem,
                                cudaStream_t stream) {
  return fwd_entry<bf16>(x, src, dst, emask, attr, tbl, w, scale, out, G, Sm,
                         Em, F, V, d, vec, gpb, slices, sc, threads, smem,
                         stream);
}

// The backward: the main kernel, then the cross-block sums. Scratch
// (allocated by the caller): dtbl_part [ceil(G/gpb), V, d]; with scale,
// dsc_part [ceil(G/gpb) * slices]; with w and slices > 1 (bf16: with w),
// dw_part [slices, G, Em] (else dw itself is written). Outputs dx, dtbl
// [V, d], dw [G, Em] in the instance's type, dscale [1] float. The launch
// (vec, gpb, slices, sc, threads, smem, xr) is the wrapper's bwd_geometry;
// one that does not cover (G, d), or whose pointers are not aligned to vec
// elements, is refused.
extern "C" int gin_agg_bwd(const float* x, const int* src, const int* dst,
                           const bool* emask, const int* attr,
                           const float* tbl, const float* w,
                           const float* scale, const float* gout, float* dx,
                           float* dtbl, float* dw, float* dscale,
                           float* dtbl_part, float* dw_part, float* dsc_part,
                           int G, int Sm, int Em, int F, int V, int d, int vec,
                           int gpb, int slices, int sc, int threads, int smem,
                           int xr, cudaStream_t stream) {
  return bwd_entry<float>(x, src, dst, emask, attr, tbl, w, scale, gout, dx,
                          dtbl, dw, dscale, dtbl_part, dw_part, dsc_part, G,
                          Sm, Em, F, V, d, vec, gpb, slices, sc, threads,
                          smem, xr, stream);
}

extern "C" int gin_agg_bwd_bf16(const bf16* x, const int* src, const int* dst,
                                const bool* emask, const int* attr,
                                const bf16* tbl, const bf16* w,
                                const float* scale, const bf16* gout,
                                bf16* dx, bf16* dtbl, bf16* dw, float* dscale,
                                float* dtbl_part, float* dw_part,
                                float* dsc_part, int G, int Sm, int Em, int F,
                                int V, int d, int vec, int gpb, int slices,
                                int sc, int threads, int smem, int xr,
                                cudaStream_t stream) {
  return bwd_entry<bf16>(x, src, dst, emask, attr, tbl, w, scale, gout, dx,
                         dtbl, dw, dscale, dtbl_part, dw_part, dsc_part, G,
                         Sm, Em, F, V, d, vec, gpb, slices, sc, threads, smem,
                         xr, stream);
}
