// jax.random's threefry2x32 for Hopper (sm_90a) kernels: the hash, the
// float32 uniform made from its bits, and the counter of an element of a
// draw.  Included by threefry.cu (the round's draws, draw_kernel),
// probe.cu (the probe tick's draws, made inline in lanes_slots_kernel) and
// round_table.cu (the round program's table: fold_in, split and randint of
// the round's keys), so that every kernel of the port draws the same bits
// as jax.random.
//
// Under jax_threefry_partitionable (the reference's configuration) a draw
// of any shape under one key hashes, for its element of flat index i (row
// r, column c of a [rows, n] draw: i = r * n + c), the counter pair (0, i),
// and the element's 32 random bits are the two output words XORed.  A draw
// of R rows that takes a key a row (uniform rows, edge drops) counts 0 ..
// n - 1 in each row.  Counters stay below 2**32, so the high word is 0, as
// jax's iota gives it at these sizes.  A uniform float32 in [0, 1) puts the
// top 23 bits under the exponent of 1.0f and subtracts 1.0f: exact IEEE
// arithmetic (compiled without --use_fast_math), as jax computes it.

#pragma once

#include <cstdint>

namespace threefry {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// threefry2x32's two output words.
struct Words {
  uint32_t x0, x1;
};

// threefry2x32 of the counter (0, c) under (k0, k1): both output words (a
// fold_in's or a split's new key).
__device__ __forceinline__ Words hash2(uint32_t k0, uint32_t k1,
                                       uint32_t c) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = k0;
  uint32_t x1 = c + k1;
#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r) ^ x0;
#define TF_FOUR(a, b, c_, d) TF_ROUND(a) TF_ROUND(b) TF_ROUND(c_) TF_ROUND(d)
  TF_FOUR(13, 15, 26, 6)
  x0 += k1;
  x1 += k2 + 1u;
  TF_FOUR(17, 29, 16, 24)
  x0 += k2;
  x1 += k0 + 2u;
  TF_FOUR(13, 15, 26, 6)
  x0 += k0;
  x1 += k1 + 3u;
  TF_FOUR(17, 29, 16, 24)
  x0 += k1;
  x1 += k2 + 4u;
  TF_FOUR(13, 15, 26, 6)
  x0 += k2;
  x1 += k0 + 5u;
#undef TF_FOUR
#undef TF_ROUND
  return Words{x0, x1};
}

// threefry2x32 of the counter (0, c) under (k0, k1): bits1 ^ bits2.
__device__ __forceinline__ uint32_t hash(uint32_t k0, uint32_t k1,
                                         uint32_t c) {
  const Words w = hash2(k0, k1, c);
  return w.x0 ^ w.x1;
}

// jax.random.uniform's float32 from 32 bits.
__device__ __forceinline__ float unit_float(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// The counter of element (r, c) of a [rows, n] draw under one key.
__device__ __forceinline__ uint32_t counter(uint64_t r, uint64_t c,
                                            uint64_t n) {
  return static_cast<uint32_t>(r * n + c);
}

// uniform(key)[counter], the key as the round's table holds it: two int32
// words, the uint32 bit patterns.
__device__ __forceinline__ float uniform_at(const int32_t* key,
                                            uint32_t ctr) {
  return unit_float(hash(static_cast<uint32_t>(key[0]),
                         static_cast<uint32_t>(key[1]), ctr));
}

// uniform(key)[counter] < p for a float32 p, without the hash where the
// outcome is certain (p <= 0: never; p >= 1: always, a uniform lying in
// [0, 1)): the same bit as the draw.
__device__ __forceinline__ bool below_at(const int32_t* key, uint32_t ctr,
                                         float p) {
  if (!(p > 0.0f)) return false;
  if (p >= 1.0f) return true;
  return uniform_at(key, ctr) < p;
}

}  // namespace threefry
