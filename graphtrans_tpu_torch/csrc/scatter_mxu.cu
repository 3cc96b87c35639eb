// K12: the segment sum of precomputed edge messages over dst-sorted edges.
// Wrapper, plain version and design note:
// graphtrans_tpu_torch/ops/kernels/scatter_mxu.py.
//
// out[i] = sum_{e: dst[e] = i} msg[e], msg [E, d] f32 (d % 128 == 0, d <=
// 512), dst [E] int32 sorted ascending; edges whose dst lies outside
// [0, N) count nowhere, and a row without edges is zero.
//
// One launch, nothing before it. The work is cut as a merge path: the
// edges and the N row ends, merged in order (row r ends after its last
// edge; an edge's place is e + its row, dst < 0 counting as row 0 and
// dst >= N as row N), make N + E items, and warp w takes items [w, w+1) *
// SPAN, so an edge costs what a row does and a long row spreads over many
// warps. A warp finds its two ends by a search over dst (32 probes a step)
// and moves an end that falls inside a row to that row's end when the row
// ends within 32 edges, so only rows longer than that are cut. It walks its
// edges in order, lanes over the channels (a float4 each, d / 128 a lane),
// U edges' rows loaded before any of them is added (their addresses wait
// for no dst: an out-of-range edge's row loads and is not added), sums
// each row in registers from 0 in edge order (the sequential sum's bits),
// and writes every row whose end it holds, zeros for a row without edges.
// A row cut between warps leaves pieces: the warp where it begins writes
// its part to tail[w], each later warp its part to head[w] (MID where the
// warp lies wholly inside the row). Every block counts a ticket when its
// warps are done (after __threadfence), and the block that takes the last
// one joins each cut row in warp order: tail[o] + head[o+1] + ... by one
// warp, or, past 32 pieces (a padding node's row), by the whole block as
// tail[o] + S_0 + ... + S_7, S_k the in-order sum of the k-th of 8 equal
// ranges of the pieces. One writer per output row, a fixed order of
// terms, no atomics on out: two calls give the same bits. The ticket is a counter of the
// caller's stream (the wrapper keeps one a stream, zeroed once) that the
// last block sets back to 0 for the stream's next call.

#include <cuda_runtime.h>

#include "vec.cuh"

namespace {

using vio::Vec;

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;  // 8 warps a block
constexpr int WARPS = THREADS / 32;
constexpr int SPAN = 128;     // merge-path items (edges and row ends) a warp
constexpr int HEAD = 1;       // head[w]: the first row's part, begun before w
constexpr int TAIL = 2;       // tail[w]: the last row's part, begun in w,
                              // goes on
constexpr int MID = 4;        // head[w]: w lies inside one row, which goes on

// dst[e]'s row on the merge path: dst < 0 before row 0, dst >= N after all
__device__ __forceinline__ long row_of(const int* dst, long e, int N) {
  const int v = dst[e];
  return v < 0 ? 0 : (v >= N ? N : (long)v);
}

// The merge-path coordinates (rows ended, edges taken) after the first k[t]
// items, t = 0, 1, each moved past the end of a row that it cuts when that
// row ends within 32 edges; cut[t] says it still cuts a row (rows[t]).
__device__ void find_ends(const int* __restrict__ dst, long E, int N,
                          const long k[2], long rows[2], long edges[2],
                          bool cut[2], int lane) {
  long lo[2], hi[2];  // edges[t]: first e in [lo, hi), e + row >= k; else hi
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    lo[t] = max(0L, k[t] - N);
    hi[t] = min(k[t], E);
  }
  while (lo[0] < hi[0] || lo[1] < hi[1]) {
    long q[2], step[2];
    bool hit[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {  // both searches' probes in flight together
      const long n = hi[t] - lo[t];
      step[t] = n > 32 ? (n + 31) / 32 : 1;
      q[t] = min(lo[t] + step[t] * (lane + 1), hi[t]) - 1;  // segment's last
      hit[t] = n > 0 && q[t] >= lo[t] + step[t] * lane &&
               q[t] + row_of(dst, q[t], N) >= k[t];
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      if (lo[t] >= hi[t]) continue;
      const unsigned b = __ballot_sync(FULL, hit[t]);
      if (b == 0) {
        lo[t] = hi[t];  // none: hi
      } else {
        const int f = __ffs(b) - 1;
        const long qf = __shfl_sync(FULL, q[t], f);
        if (step[t] == 1) {
          lo[t] = hi[t] = qf;  // the first hit
        } else {
          lo[t] += step[t] * f;
          hi[t] = qf;  // qf hits: the answer lies in [lo, qf]
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    long e = hi[t], r = k[t] - hi[t];
    bool c = r < N && e > 0 && row_of(dst, e - 1, N) == r;
    if (c) {  // does row r end within the next 32 edges?
      const long x = e + lane;
      const unsigned b =
          __ballot_sync(FULL, x >= E || row_of(dst, x, N) != r);
      if (b) {
        e += __ffs(b) - 1;
        r += 1;
        c = false;
      }
    }
    rows[t] = r;
    edges[t] = e;
    cut[t] = c;
  }
}

template <int VPL>
__device__ __forceinline__ void store_row(float* p, const Vec<4> (&v)[VPL],
                                          int lane) {
#pragma unroll
  for (int j = 0; j < VPL; ++j) vio::store_vec(p + (lane + 32 * j) * 4, v[j]);
}

template <int VPL>
__device__ __forceinline__ void load_row_cg(const float* p, Vec<4> (&v)[VPL],
                                            int lane) {
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const float4 q =
        __ldcg(reinterpret_cast<const float4*>(p + (lane + 32 * j) * 4));
    v[j].v[0] = q.x, v[j].v[1] = q.y, v[j].v[2] = q.z, v[j].v[3] = q.w;
  }
}

template <int VPL>
__device__ __forceinline__ void add_row(Vec<4> (&acc)[VPL],
                                        const Vec<4> (&v)[VPL]) {
#pragma unroll
  for (int j = 0; j < VPL; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j].v[i] += v[j].v[i];
}

// acc += head[j] for j in [lo, hi), in order, B pieces' loads in flight
template <int VPL>
__device__ __forceinline__ void add_pieces(Vec<4> (&acc)[VPL],
                                           const float* __restrict__ head,
                                           long lo, long hi, int d, int lane) {
  constexpr int B = 16 / VPL;
  for (long p0 = lo; p0 < hi; p0 += B) {
    Vec<4> v[B][VPL];
#pragma unroll
    for (int u = 0; u < B; ++u)
      if (p0 + u < hi) load_row_cg<VPL>(head + (p0 + u) * d, v[u], lane);
#pragma unroll
    for (int u = 0; u < B; ++u)
      if (p0 + u < hi) add_row<VPL>(acc, v[u]);
  }
}

// The last block: each row cut between warps, summed in warp order. Warp
// o (TAIL) began the row; pieces head[o+1 .. end] follow, all MID but the
// last. The block scans the flags a window of WINDOW warps at a time. A
// chain of at most 32 pieces is summed by the warp that finds its owner,
// tail[o] + head[o+1] + ... ; a longer one (a padding node's row) goes on
// the window's list and is summed by the block: warp k sums the k-th of
// WARPS equal ranges of its pieces in order, and the row is tail[o] + S_0
// + ... + S_{WARPS-1}.
template <int VPL>
__device__ void join_pieces(const float* __restrict__ head,
                            const float* __restrict__ tail,
                            const int* __restrict__ flags,
                            const int* __restrict__ trow,
                            float* __restrict__ out, long nwarps, int d,
                            int lane, int wib) {
  constexpr int WINDOW = WARPS * 256;  // flags a window, 8 a lane
  constexpr int MAX_LONG = 64;  // a long chain's owner is followed by 32 or
                                // more MID pieces: at most 63 in a window
  __shared__ long longs[MAX_LONG];  // the window's owners of long chains
  __shared__ int nlong;
  __shared__ long end_at;
  __shared__ Vec<4> part[WARPS][VPL][32];  // each warp's range sum
  for (long c0 = 0; c0 < nwarps; c0 += WINDOW) {
    if (threadIdx.x == 0) nlong = 0;
    __syncthreads();
    const long base = c0 + (long)wib * 256;
    int f[8];  // flags of base + 32 q + lane, all loaded at once
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const long w = base + 32 * q + lane;
      f[q] = w < nwarps ? __ldcg(flags + w) : 0;
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      unsigned owners = __ballot_sync(FULL, f[q] & TAIL);
      while (owners) {
        const long o = base + 32 * q + __ffs(owners) - 1;
        owners &= owners - 1;
        const long x = o + 1 + lane;
        const int fx = x < nwarps ? __ldcg(flags + x) : 0;
        const unsigned ends = __ballot_sync(FULL, !(fx & MID));
        if (!ends) {  // more than 32 pieces: the block's, below
          if (lane == 0) longs[atomicAdd(&nlong, 1)] = o;
          continue;
        }
        Vec<4> acc[VPL];
        load_row_cg<VPL>(tail + o * d, acc, lane);
        add_pieces<VPL>(acc, head, o + 1, o + 1 + __ffs(ends), d, lane);
        store_row<VPL>(out + (long)__ldcg(trow + o) * d, acc, lane);
      }
    }
    __syncthreads();
    for (int i = 0; i < nlong; ++i) {  // each long chain, by the whole block
      const long o = longs[i];
      if (threadIdx.x == 0) end_at = nwarps;
      long s = o + 33;  // the first THREADS pieces from s that hold its last
      auto ends_at = [&](long x) {
        return x >= nwarps || !(__ldcg(flags + x) & MID);
      };
      while (!__syncthreads_or(ends_at(s + threadIdx.x))) s += THREADS;
      if (s + threadIdx.x < nwarps && ends_at(s + threadIdx.x))
        atomicMin(reinterpret_cast<unsigned long long*>(&end_at),
                  (unsigned long long)(s + threadIdx.x));
      __syncthreads();
      const long P = end_at - o;  // pieces o+1 .. end_at
      Vec<4> acc[VPL];
#pragma unroll
      for (int j = 0; j < VPL; ++j) acc[j] = vio::zero_vec<4>();
      const long lo = o + 1 + P * wib / WARPS;
      const long hi = o + 1 + P * (wib + 1) / WARPS;
      if (lo < hi) {
        load_row_cg<VPL>(head + lo * d, acc, lane);  // from the range's first
        add_pieces<VPL>(acc, head, lo + 1, hi, d, lane);
      }
#pragma unroll
      for (int j = 0; j < VPL; ++j) part[wib][j][lane] = acc[j];
      __syncthreads();
      if (wib == 0) {
        load_row_cg<VPL>(tail + o * d, acc, lane);
        for (int k = 0; k < WARPS; ++k) {
          if (P * k / WARPS == P * (k + 1) / WARPS) continue;
#pragma unroll
          for (int j = 0; j < VPL; ++j)
#pragma unroll
            for (int t = 0; t < 4; ++t) acc[j].v[t] += part[k][j][lane].v[t];
        }
        store_row<VPL>(out + (long)__ldcg(trow + o) * d, acc, lane);
      }
      __syncthreads();
    }
    __syncthreads();  // every thread past the list before the next window
  }
}

template <int VPL>
__global__ void __launch_bounds__(THREADS)
segment_sum_kernel(const float* __restrict__ msg, const int* __restrict__ dst,
                   float* __restrict__ out, float* __restrict__ head,
                   float* __restrict__ tail, int* __restrict__ flags,
                   int* __restrict__ trow, unsigned* __restrict__ ticket,
                   int N, long E, int d, long nwarps) {
  constexpr int U = 8 / VPL;  // edges whose rows load together
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const long w = (long)blockIdx.x * WARPS + wib;
  if (w < nwarps) {
    const long items = (long)N + E;
    const long k[2] = {w * SPAN, min((w + 1) * SPAN, items)};
    long rows[2], edges[2];
    bool cut[2];
    find_ends(dst, E, N, k, rows, edges, cut, lane);
    const long i0 = rows[0], i1 = rows[1], j1 = edges[1];
    const bool has_head = cut[0];
    Vec<4> acc[VPL];
#pragma unroll
    for (int j = 0; j < VPL; ++j) acc[j] = vio::zero_vec<4>();
    long cur = i0;  // the row being summed
    auto finish_to = [&](long r) {  // write the rows before r
      for (; cur < r; ++cur) {
        store_row<VPL>((has_head && cur == i0 ? head + w * d : out + cur * d),
                       acc, lane);
#pragma unroll
        for (int j = 0; j < VPL; ++j) acc[j] = vio::zero_vec<4>();
      }
    };
    for (long e0 = edges[0]; e0 < j1; e0 += 32) {
      const long e = e0 + lane;
      long r = 0;
      bool ok = false;
      if (e < j1) {  // lane i: edge e0 + i's row
        const int x = dst[e];
        r = x < 0 ? 0 : (x >= N ? N : (long)x);
        ok = x >= 0 && x < N;
      }
      const int n = (int)min(32L, j1 - e0);
      for (int i0 = 0; i0 < n; i0 += U) {
        Vec<4> v[U][VPL];
#pragma unroll
        for (int u = 0; u < U; ++u)  // every edge's row in flight first; a
#pragma unroll                       // row's address waits for no dst
          for (int j = 0; j < VPL; ++j)
            v[u][j] = i0 + u < n ? vio::load_vec<4>(msg + (e0 + i0 + u) * d +
                                                    (lane + 32 * j) * 4)
                                 : vio::zero_vec<4>();
#pragma unroll
        for (int u = 0; u < U; ++u) {  // then their sums, in edge order
          if (i0 + u >= n) break;
          finish_to(__shfl_sync(FULL, r, i0 + u));
          if (__shfl_sync(FULL, ok, i0 + u)) add_row<VPL>(acc, v[u]);
        }
      }
    }
    finish_to(i1);
    int f = has_head ? HEAD : 0;
    if (cut[1]) {  // row i1 goes on into warp w + 1
      if (has_head && i0 == i1) {
        store_row<VPL>(head + w * d, acc, lane);
        f |= MID;
      } else {
        store_row<VPL>(tail + w * d, acc, lane);
        f |= TAIL;
      }
    }
    if (lane == 0) {
      flags[w] = f;
      trow[w] = (int)i1;
    }
  }
  __shared__ bool last;
  __threadfence();  // pieces and flags before the ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    if (last) *ticket = 0;  // for the stream's next call
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  join_pieces<VPL>(head, tail, flags, trow, out, nwarps, d, lane, wib);
}

template <int VPL>
int launch(const float* msg, const int* dst, float* out, float* scratch,
           unsigned* ticket, int N, long E, int d, cudaStream_t stream) {
  const long nwarps = ((long)N + E + SPAN - 1) / SPAN;
  float* head = scratch;
  float* tail = head + nwarps * d;
  int* flags = reinterpret_cast<int*>(tail + nwarps * d);
  int* trow = flags + nwarps;
  const long blocks = (nwarps + WARPS - 1) / WARPS;
  segment_sum_kernel<VPL><<<(unsigned)blocks, THREADS, 0, stream>>>(
      msg, dst, out, head, tail, flags, trow, ticket, N, E, d, nwarps);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Merge-path items a warp; the scratch holds (2 * d + 2) floats a warp, for
// ceil((N + E) / span) warps.
extern "C" int segment_sum_span() { return SPAN; }

// out [N, d] = per-row sums of msg [E, d] over the sorted int32 dst [E].
// msg, out and scratch 16-byte aligned; d a multiple of 128 up to 512.
// ticket: an unsigned counter that is 0 and that no other call uses while
// this one runs (one a stream); the launch leaves it 0. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int segment_sum_mxu(const float* msg, const int* dst, float* out,
                               float* scratch, unsigned* ticket, int N,
                               long E, int d, cudaStream_t stream) {
  if (N <= 0 || E < 0 || d <= 0 || d > 512 || d % 128)
    return cudaErrorInvalidValue;
  if (((unsigned long)msg | (unsigned long)out | (unsigned long)scratch) % 16)
    return cudaErrorInvalidValue;
  switch (d / 128) {
    case 1: return launch<1>(msg, dst, out, scratch, ticket, N, E, d, stream);
    case 2: return launch<2>(msg, dst, out, scratch, ticket, N, E, d, stream);
    case 3: return launch<3>(msg, dst, out, scratch, ticket, N, E, d, stream);
    default:
      return launch<4>(msg, dst, out, scratch, ticket, N, E, d, stream);
  }
}
