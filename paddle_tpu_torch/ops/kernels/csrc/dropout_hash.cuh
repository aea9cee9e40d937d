// The keep bits of the port's two dropouts: the attention dropout's,
// shared by the flash-attention forward and backward kernels, and the
// dropout op's (csrc/dropout_mask.cu).
//
// The same counter hash (a murmur3-finalizer mix) as the JAX package's
// `_dropout_keep` (paddle_tpu/ops/pallas/flash_attention.py:62), so the
// mask is bit-identical to the Pallas kernels and to the port's plain
// version: every element (head g = b*H + h plus the launch's offset,
// query qpos, key kpos) draws its bit from the uint32 seed alone.  All arithmetic is uint32 with
// wraparound; the keep threshold is 24-bit (`_keep_threshold`, :80).

#pragma once

#include <stdint.h>

__device__ __forceinline__ bool dropout_keep(uint32_t seed, uint32_t g,
                                             uint32_t qpos, uint32_t kpos,
                                             uint32_t threshold) {
  uint32_t h = (qpos * 0x9E3779B1u) ^ (kpos * 0x85EBCA77u) ^
               (g * 0xC2B2AE3Du) ^ seed;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return (h >> 8) < threshold;
}

// The dropout op's keep bit (csrc/dropout_mask.cu), the device twin of
// the plain `hash_keep` (ops/kernels/dropout.py): element i of the
// flattened tensor keeps where the murmur3 finalizer of
// (i * 0x9E3779B1) ^ seed has its top 24 bits below the threshold.
__device__ __forceinline__ bool dropout_op_keep(uint32_t seed, uint32_t i,
                                                uint32_t threshold) {
  uint32_t h = (i * 0x9E3779B1u) ^ seed;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return (h >> 8) < threshold;
}
