// K8's backward, d_emb and dx, over the blocked-CSR chunk plans. Wrapper,
// plain versions and design note: graphtrans_tpu_torch/ops/kernels/
// block_spmm.py. K8's forward runs on K7's forward body (spmm.cu:
// blocked_fwd_kernel) over the batch's SlotOrder.
//
// A plan cuts the node axis into blocks of NB rows and lists C chunks of
// EB edge slots, grouped by major block (blk_out ascending): slot (c, s)
// is an edge from minor row blk_in[c]*NB + loc_in[c,s] to major row
// blk_out[c]*NB + loc_out[c,s], real where mask[c,s] > 0. The wrapper
// gives run[b] = the first chunk of major block b (run[nblk] = C) and
// live[c] = the count of real slots of chunk c.
//
// walk (dx with the src-major plan; the DX = false instance, a forward
// over the dst-major plan, is not launched): one
// block per (major block, slice of CT channels), one thread per channel,
// the block's NB x CT sums in shared memory. The block first lists the
// chunks of its run that hold a real slot (CT chunk counts at a time, so
// the pad chunks at the tail of the last block's run cost one load step
// per CT), then for each such chunk lists its real slots in slot order
// (warp ballots) with their rows and weights in shared memory, and walks
// them U at a time with all U rows' loads in flight. Each thread owns its
// column of the sums: no atomics, and the terms of a row add up in slot
// order.
//   dx:      dx[maj]  += w * g[min] * 1[x[maj] + emb[slot] > 0]   (relu),
//            with the src-major plan (major = src, minor = dst).
// demb (dst-major plan): one warp per slot, lanes over channels,
//   d_emb[slot] = w * g[maj] * 1[x[min] + emb[slot] > 0], and 0 on the
//   slots that are not real.

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int NB = 128;  // node rows per block
constexpr int EB = 512;  // edge slots per chunk
constexpr int CT = 128;  // channels (threads) per block of the walk
constexpr int WARPS = CT / 32;
constexpr int U = 8;     // slots whose loads are in flight together
constexpr int ACC_BYTES = NB * CT * sizeof(float);

template <bool DX, bool RELU, bool HAS_W>
__global__ void __launch_bounds__(CT)
block_walk(const float* __restrict__ gat, const float* __restrict__ xmaj,
           const float* __restrict__ emb, const int* __restrict__ blk_in,
           const int* __restrict__ loc_out, const int* __restrict__ loc_in,
           const float* __restrict__ mask, const float* __restrict__ w,
           const int* __restrict__ run, const int* __restrict__ live,
           float* __restrict__ out, int d) {
  extern __shared__ float acc[];  // [NB][CT]
  __shared__ int s_chunk[CT];
  __shared__ int s_slot[EB], s_lin[EB], s_lout[EB];
  __shared__ float s_w[EB];
  __shared__ int s_cnt[EB / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.x;
  const int ch = blockIdx.y * CT + t;
  const bool on = ch < d;
  const unsigned below = (1u << lane) - 1;
#pragma unroll 8
  for (int r = 0; r < NB; ++r) acc[r * CT + t] = 0.f;
  const int c_beg = run[b], c_end = run[b + 1];
  for (int w0 = c_beg; w0 < c_end; w0 += CT) {
    // the chunks of this window that hold a real slot, in order
    const int cw = w0 + t;
    const bool has = cw < c_end && live[cw] > 0;
    const unsigned hb = __ballot_sync(FULL, has);
    if (lane == 0) s_cnt[warp] = __popc(hb);
    __syncthreads();
    int n_ch = 0, at = 0;
    for (int k = 0; k < WARPS; ++k) {
      at += k < warp ? s_cnt[k] : 0;
      n_ch += s_cnt[k];
    }
    if (has) s_chunk[at + __popc(hb & below)] = cw;
    __syncthreads();
    for (int k = 0; k < n_ch; ++k) {
      const int c = s_chunk[k];
      const long base = (long)c * EB;
      // the chunk's real slots in slot order: slot q*32 + lane, q = the
      // 32-slot group, q = g*WARPS + warp
      unsigned bits[EB / CT];
#pragma unroll
      for (int g = 0; g < EB / CT; ++g) {
        bits[g] = __ballot_sync(FULL, mask[base + g * CT + t] > 0.f);
        if (lane == 0) s_cnt[g * WARPS + warp] = __popc(bits[g]);
      }
      __syncthreads();
      int n = 0;
#pragma unroll
      for (int g = 0; g < EB / CT; ++g) {
        const int q = g * WARPS + warp;
        int pos = 0;
        for (int j = 0; j < q; ++j) pos += s_cnt[j];
        if (bits[g] >> lane & 1u) {
          const int s = g * CT + t;
          pos += __popc(bits[g] & below);
          s_slot[pos] = s;
          s_lin[pos] = loc_in[base + s];
          s_lout[pos] = loc_out[base + s];
          s_w[pos] = HAS_W ? w[base + s] : 1.f;
        }
      }
      for (int j = 0; j < EB / 32; ++j) n += s_cnt[j];
      __syncthreads();
      const long in0 = (long)blk_in[c] * NB;
      const long maj0 = (long)b * NB;
      for (int i0 = 0; i0 < n; i0 += U) {
        float gv[U], ev[U], xv[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = i0 + u;
          gv[u] = ev[u] = xv[u] = 0.f;
          if (i < n && on) {
            gv[u] = gat[(in0 + s_lin[i]) * d + ch];
            if (!DX || RELU) ev[u] = emb[(base + s_slot[i]) * d + ch];
            if (DX && RELU) xv[u] = xmaj[(maj0 + s_lout[i]) * d + ch];
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = i0 + u;
          if (i < n) {
            float m;
            if (!DX) {
              m = gv[u] + ev[u];
              if (RELU) m = fmaxf(m, 0.f);
              if (HAS_W) m = __fmul_rn(m, s_w[i]);  // as the plain version
            } else {
              m = HAS_W ? __fmul_rn(gv[u], s_w[i]) : gv[u];
              if (RELU && !(xv[u] + ev[u] > 0.f)) m = 0.f;
            }
            acc[s_lout[i] * CT + t] += m;
          }
        }
      }
      __syncthreads();  // the slot lists are rewritten by the next chunk
    }
  }
  if (on) {
    float* o = out + (long)b * NB * d + ch;
#pragma unroll 8
    for (int r = 0; r < NB; ++r) o[(long)r * d] = acc[r * CT + t];
  }
}

template <bool RELU, bool HAS_W>
__global__ void __launch_bounds__(256)
block_demb(const float* __restrict__ x, const float* __restrict__ g,
           const float* __restrict__ emb, const int* __restrict__ blk_out,
           const int* __restrict__ blk_in, const int* __restrict__ loc_out,
           const int* __restrict__ loc_in, const float* __restrict__ mask,
           const float* __restrict__ w, float* __restrict__ demb, long slots,
           int d) {
  const long e = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (e >= slots) return;
  float* row = demb + e * d;
  if (!(mask[e] > 0.f)) {
    for (int c = lane; c < d; c += 32) row[c] = 0.f;
    return;
  }
  const long chunk = e / EB;
  const float* gr = g + ((long)blk_out[chunk] * NB + loc_out[e]) * d;
  const float* xr = x + ((long)blk_in[chunk] * NB + loc_in[e]) * d;
  const float* er = emb + e * d;
  const float wv = HAS_W ? w[e] : 1.f;
  for (int c = lane; c < d; c += 32) {
    float v = HAS_W ? __fmul_rn(gr[c], wv) : gr[c];
    if (RELU && !(xr[c] + er[c] > 0.f)) v = 0.f;
    row[c] = v;
  }
}

template <bool DX, bool RELU, bool HAS_W>
int launch_walk(const float* gat, const float* xmaj, const float* emb,
                const int* blk_in, const int* loc_out, const int* loc_in,
                const float* mask, const float* w, const int* run,
                const int* live, float* out, int nblk, int d,
                cudaStream_t stream) {
  auto kernel = block_walk<DX, RELU, HAS_W>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ACC_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(nblk, (d + CT - 1) / CT);
  kernel<<<grid, CT, ACC_BYTES, stream>>>(gat, xmaj, emb, blk_in, loc_out,
                                          loc_in, mask, w, run, live, out, d);
  return cudaGetLastError();
}

template <bool DX>
int walk(const float* gat, const float* xmaj, const float* emb,
         const int* blk_in, const int* loc_out, const int* loc_in,
         const float* mask, const float* w, const int* run, const int* live,
         float* out, int nblk, int d, int relu, cudaStream_t stream) {
  if (relu)
    return w ? launch_walk<DX, true, true>(gat, xmaj, emb, blk_in, loc_out,
                                           loc_in, mask, w, run, live, out,
                                           nblk, d, stream)
             : launch_walk<DX, true, false>(gat, xmaj, emb, blk_in, loc_out,
                                            loc_in, mask, w, run, live, out,
                                            nblk, d, stream);
  return w ? launch_walk<DX, false, true>(gat, xmaj, emb, blk_in, loc_out,
                                          loc_in, mask, w, run, live, out,
                                          nblk, d, stream)
           : launch_walk<DX, false, false>(gat, xmaj, emb, blk_in, loc_out,
                                           loc_in, mask, w, run, live, out,
                                           nblk, d, stream);
}

template <bool RELU, bool HAS_W>
int launch_demb(const float* x, const float* g, const float* emb,
                const int* blk_out, const int* blk_in, const int* loc_out,
                const int* loc_in, const float* mask, const float* w,
                float* demb, long slots, int d, cudaStream_t stream) {
  const int threads = 256;  // 8 slots a block
  const long blocks = (slots * 32 + threads - 1) / threads;
  block_demb<RELU, HAS_W><<<(unsigned)blocks, threads, 0, stream>>>(
      x, g, emb, blk_out, blk_in, loc_out, loc_in, mask, w, demb, slots, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dx [nblk*NB, d] for the cotangent g of K8's forward, over the
// src-major plan and its emb copy (x read at the major, src, rows).
extern "C" int block_spmm_dx(const float* x, const float* g,
                             const float* emb, const int* blk_in,
                             const int* loc_out, const int* loc_in,
                             const float* mask, const float* w,
                             const int* run, const int* live, float* dx,
                             int nblk, int d, int relu, cudaStream_t stream) {
  if (nblk <= 0 || d <= 0) return cudaErrorInvalidValue;
  return walk<true>(g, x, emb, blk_in, loc_out, loc_in, mask, w, run, live,
                    dx, nblk, d, relu, stream);
}

// d_emb [C*EB, d] (0 on slots that are not real) for the cotangent g of
// K8's forward, over the dst-major plan.
extern "C" int block_spmm_demb(const float* x, const float* g,
                               const float* emb, const int* blk_out,
                               const int* blk_in, const int* loc_out,
                               const int* loc_in, const float* mask,
                               const float* w, float* demb, int C, int d,
                               int relu, cudaStream_t stream) {
  if (C <= 0 || d <= 0) return cudaErrorInvalidValue;
  const long slots = (long)C * EB;
  if (relu)
    return w ? launch_demb<true, true>(x, g, emb, blk_out, blk_in, loc_out,
                                       loc_in, mask, w, demb, slots, d,
                                       stream)
             : launch_demb<true, false>(x, g, emb, blk_out, blk_in, loc_out,
                                        loc_in, mask, w, demb, slots, d,
                                        stream);
  return w ? launch_demb<false, true>(x, g, emb, blk_out, blk_in, loc_out,
                                      loc_in, mask, w, demb, slots, d, stream)
           : launch_demb<false, false>(x, g, emb, blk_out, blk_in, loc_out,
                                       loc_in, mask, w, demb, slots, d,
                                       stream);
}
