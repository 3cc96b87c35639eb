// The counter hash that the kernels draw their dropout masks from: the
// JAX package's interpret-mode stand-in for the TPU PRNG
// (graphtrans_tpu/ops/pallas/prng.py:_hash_bits_u32), in u32 arithmetic.

#pragma once

namespace prng {

// murmur-style finalizer of (position, seed)
__device__ __forceinline__ unsigned hash_bits(unsigned pos, unsigned seed) {
  unsigned x = pos * 2654435761u + seed * 0x9E3779B9u;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x ^ (x >> 16);
}

}  // namespace prng
