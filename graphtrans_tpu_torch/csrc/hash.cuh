// The counter hash that the kernels draw their dropout masks from: the
// JAX package's interpret-mode stand-in for the TPU PRNG
// (graphtrans_tpu/ops/pallas/prng.py:_hash_bits_u32), in u32 arithmetic.

#pragma once

namespace prng {

constexpr unsigned POS_MUL = 2654435761u, SEED_MUL = 0x9E3779B9u;

// the finalizer's rounds on x = pos POS_MUL + seed SEED_MUL
__device__ __forceinline__ unsigned mix(unsigned x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x ^ (x >> 16);
}

// murmur-style finalizer of (position, seed)
__device__ __forceinline__ unsigned hash_bits(unsigned pos, unsigned seed) {
  return mix(pos * POS_MUL + seed * SEED_MUL);
}

}  // namespace prng
