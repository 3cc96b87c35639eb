// K8's d_emb over the blocked-CSR chunk plans. Wrapper, plain versions and
// design note: graphtrans_tpu_torch/ops/kernels/block_spmm.py. K8's
// forward and its dx run on K7's bodies in spmm.cu (blocked_fwd_kernel,
// blocked_dx_kernel), each over a SlotOrder of its plan.
//
// A plan cuts the node axis into blocks of NB rows and lists C chunks of
// EB edge slots, grouped by major block: slot (c, s) is an edge from minor
// row blk_in[c]*NB + loc_in[c,s] to major row blk_out[c]*NB +
// loc_out[c,s], real where mask[c,s] > 0.
//
// demb (dst-major plan): one warp per slot, lanes over channels,
//   d_emb[slot] = w * g[maj] * 1[x[min] + emb[slot] > 0], and 0 on the
//   slots that are not real.

#include <cuda_runtime.h>

namespace {

constexpr int NB = 128;  // node rows per block
constexpr int EB = 512;  // edge slots per chunk

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
