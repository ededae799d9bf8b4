// The SWIM round's random draws, for Hopper (sm_90a): one kernel body, a
// mode per entry point, and its C entry points.
//
// Replaces the jax.random draws that XLA fuses inside the reference's jitted
// round (no Pallas source): the nemesis drop legs of
// consul_tpu/gossip/kernel.py (`_nem_leg_drop` and the push/pull legs) and
// consul_tpu/ops/feistel.py's `randint`.  (The probe tick's uniforms, the
// direct and indirect probes' losses and the partition and
// degraded-observer legs, were draws of this kernel too; since the probe
// tick became probe.cu, its lanes_slots kernel makes them inline, from the
// same hash: threefry.cuh.)  Before this,
// the port computed each draw as ~180 int64 torch operations
// (consul_tpu_torch/prng.py: `random_bits_ref`, `uniform_ref`,
// `uniform_rows_ref`, `randint_ref`, `edge_drops_ref`, which stay beside the
// wrappers as the plain versions).  Every entry point is bit-identical to
// them and to jax.random.
//
// What it computes.  jax's partitionable threefry2x32 (20 rounds; the hash,
// the float and the counter layout are threefry.cuh's, shared with
// probe.cu): element i of a draw of any shape hashes the counter (0, i), i
// its flat index, under the key (k0, k1), and its 32 random bits are the
// two output words XORed.  A uniform float32 in [0, 1) puts the top 23 bits
// under the exponent of 1.0f and subtracts 1.0f; `below` compares that float with a float32 p;
// randint draws two bit streams under split(key)'s two keys and reduces
// them by jax.random.randint's span and multiplier in u32 arithmetic; the
// edge drops are a nemesis partition's whole drop mask, per leg f and
// destination d: the sender d - shift_f is in the other group and the leg's
// uniform is below its direction's probability.  A draw of R rows (uniform
// rows, edge drops) takes row r's key for row r, counters 0..n-1 each.
// Counters stay below 2**32 (n <= 2**32, checked), so the high counter word
// is 0, as jax's iota gives it at these sizes.  Everything is exact IEEE
// and integer arithmetic: compiled without --use_fast_math, the float is
// made by a bit cast and one exact subtraction, and `<` is exact.
//
// Bound: operations.  A hash is 20 rounds of add, rotate and xor plus five
// key injections, ~90 integer instructions an element (counted from the
// SASS by consul_tpu_torch/sass_count.py), at 67e12 / 4 32-bit operations a
// second on an H100 SXM; an element writes 1-8 bytes.  At the 1M paths'
// shapes (200,000 to 3,000,000 elements) that is ~1-15 us, near a launch's
// own cost, so the smaller launches are bound by the launch: the point of
// the kernel is one launch a draw where the torch version made ~180.
//
// Design.  Keys come by value in the kernel's parameters (the host holds
// them as uint32[2]): no copy to the device, no synchronisation.  The
// round's own draws (the `_dev` entry points) read their keys, and the edge
// drops their shifts, from device memory instead: a row of the round's
// argument table (consul_tpu_torch/gossip/round_args.py), so that one
// captured launch serves every round of a replayed CUDA graph.  A 2-D
// grid: blockIdx.y is the row, and the threads of a row stride over its
// columns, one element a step, 32-bit rotates as funnel shifts; stores are
// coalesced (neighbouring threads, neighbouring elements).  The edge drops
// read the group vector at d and at d - shift (two coalesced loads) and skip
// the hash where the outcome is certain: a same-group edge, or a direction
// whose probability is 0 or at least 1 (a uniform lies in [0, 1)).

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "threefry.cuh"

namespace threefry {

constexpr int kThreads = 256;
constexpr int kMaxRows = 16;     // keys of one launch (legs, rows)
constexpr int kMaxBlocks = 1056;  // 8 a multiprocessor of the 132
constexpr uint64_t kMaxCounters = 1ULL << 32;

enum Mode : int {
  kBits = 0,      // u32 bits as int64 (the value)
  kUniform = 1,   // float32 in [0, 1)
  kBelow = 2,     // bool: uniform < p
  kRandint = 3,   // int32 in [minval, minval + span)
  kEdgeDrops = 4  // bool [rows, n]: the partition's drop mask
};

struct Args {
  uint32_t k0[kMaxRows], k1[kMaxRows];  // row r's key; randint: rows 0, 1
  int64_t shift[kMaxRows];              // edge drops: leg r's shift in [0, n)
  const uint32_t* dkeys;  // nullptr, or row r's key at dkeys[2r], [2r + 1]
  const int32_t* dshift;  // nullptr, or edge drops: leg r's shift, any int
  void* out;
  const int32_t* grp;  // edge drops: group of each node, int32 [n]
  uint64_t n;          // elements a row
  float p, p_ab, p_ba;
  int32_t minval;
  uint32_t span, mult;
};

template <int M>
__global__ void __launch_bounds__(kThreads) draw_kernel(const Args a) {
  const int r = blockIdx.y;
  const uint32_t k0 = a.dkeys ? a.dkeys[2 * r] : a.k0[r];
  const uint32_t k1 = a.dkeys ? a.dkeys[2 * r + 1] : a.k1[r];
  int64_t shift = 0;
  if constexpr (M == kEdgeDrops) {
    const int64_t n = static_cast<int64_t>(a.n);
    shift = a.dshift ? static_cast<int64_t>(a.dshift[r]) % n : a.shift[r];
    if (shift < 0) shift += n;
  }
  const uint64_t row = static_cast<uint64_t>(r) * a.n;
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
#pragma unroll 1
  for (uint64_t c = static_cast<uint64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
       c < a.n; c += stride) {
    const uint32_t ctr = static_cast<uint32_t>(c);
    if constexpr (M == kBits) {
      static_cast<int64_t*>(a.out)[row + c] = hash(k0, k1, ctr);
    } else if constexpr (M == kUniform) {
      static_cast<float*>(a.out)[row + c] = unit_float(hash(k0, k1, ctr));
    } else if constexpr (M == kBelow) {
      static_cast<uint8_t*>(a.out)[row + c] =
          unit_float(hash(k0, k1, ctr)) < a.p;
    } else if constexpr (M == kRandint) {
      const uint32_t hi = hash(a.k0[0], a.k1[0], ctr);
      const uint32_t lo = hash(a.k0[1], a.k1[1], ctr);
      const uint32_t off = (hi % a.span) * a.mult + lo % a.span;
      static_cast<int32_t*>(a.out)[c] = static_cast<int32_t>(
          static_cast<uint32_t>(a.minval) + off % a.span);
    } else {  // kEdgeDrops
      int64_t s = static_cast<int64_t>(c) - shift;
      if (s < 0) s += static_cast<int64_t>(a.n);
      const int32_t g_src = a.grp[s];
      const float p = g_src == 0 ? a.p_ab : a.p_ba;
      bool drop = false;
      if (g_src != a.grp[c] && p > 0.0f) {
        drop = p >= 1.0f || unit_float(hash(k0, k1, ctr)) < p;
      }
      static_cast<uint8_t*>(a.out)[row + c] = drop;
    }
  }
}

template <int M>
int launch(const Args& a, int rows, cudaStream_t stream) {
  if (a.n == 0 || a.n > kMaxCounters || rows < 1 || rows > kMaxRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint64_t want = (a.n + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned>(want < kMaxBlocks ? want : kMaxBlocks),
                  static_cast<unsigned>(rows));
  draw_kernel<M><<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

Args keyed(const uint32_t* keys, int rows, uint64_t n, void* out) {
  Args a;
  std::memset(&a, 0, sizeof(a));
  for (int r = 0; r < rows && r < kMaxRows; ++r) {
    a.k0[r] = keys[2 * r];
    a.k1[r] = keys[2 * r + 1];
  }
  a.n = n;
  a.out = out;
  return a;
}

}  // namespace threefry

using threefry::Args;

// out[n] int64 = the u32 bits of key (k0, k1), values in [0, 2**32).  Every
// entry point launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments it does not take (n = 0, n > 2**32, rows outside [1, 16]).
extern "C" int threefry_bits(uint32_t k0, uint32_t k1, uint64_t n, void* out,
                             void* stream) {
  const uint32_t keys[2] = {k0, k1};
  return threefry::launch<threefry::kBits>(
      threefry::keyed(keys, 1, n, out), 1, static_cast<cudaStream_t>(stream));
}

// out[rows, n] float32: row r the uniforms of key (keys[2r], keys[2r + 1]).
extern "C" int threefry_uniform(const uint32_t* keys, int rows, uint64_t n,
                                void* out, void* stream) {
  if (rows < 1 || rows > threefry::kMaxRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return threefry::launch<threefry::kUniform>(
      threefry::keyed(keys, rows, n, out), rows,
      static_cast<cudaStream_t>(stream));
}

// out[n] bool: uniform(key, n) < p.
extern "C" int threefry_below(uint32_t k0, uint32_t k1, uint64_t n, float p,
                              void* out, void* stream) {
  const uint32_t keys[2] = {k0, k1};
  Args a = threefry::keyed(keys, 1, n, out);
  a.p = p;
  return threefry::launch<threefry::kBelow>(a, 1,
                                            static_cast<cudaStream_t>(stream));
}

// out[n] int32: jax.random.randint from the two bit streams of split(key)'s
// keys (hi0, hi1) and (lo0, lo1); span >= 1 and mult as _randint_span gives.
extern "C" int threefry_randint(uint32_t hi0, uint32_t hi1, uint32_t lo0,
                                uint32_t lo1, uint64_t n, int32_t minval,
                                uint32_t span, uint32_t mult, void* out,
                                void* stream) {
  if (span == 0) return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t keys[4] = {hi0, hi1, lo0, lo1};
  Args a = threefry::keyed(keys, 2, n, out);
  a.minval = minval;
  a.span = span;
  a.mult = mult;
  return threefry::launch<threefry::kRandint>(
      a, 1, static_cast<cudaStream_t>(stream));
}

// out[rows, n] bool: leg r drops its delivery into destination d where the
// sender (d - shifts[r]) mod n is in another group than d (grp: int32 [n])
// and uniform(key r)[d] < p, p = p_ab from group 0, p_ba from the other.
extern "C" int threefry_edge_drops(const uint32_t* keys,
                                   const int64_t* shifts, int rows,
                                   uint64_t n, const void* grp, float p_ab,
                                   float p_ba, void* out, void* stream) {
  if (rows < 1 || rows > threefry::kMaxRows || n == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a = threefry::keyed(keys, rows, n, out);
  for (int r = 0; r < rows; ++r) {
    const int64_t s = shifts[r] % static_cast<int64_t>(n);
    a.shift[r] = s < 0 ? s + static_cast<int64_t>(n) : s;
  }
  a.grp = static_cast<const int32_t*>(grp);
  a.p_ab = p_ab;
  a.p_ba = p_ba;
  return threefry::launch<threefry::kEdgeDrops>(
      a, rows, static_cast<cudaStream_t>(stream));
}

// The round's draws with keys (and shifts) in device memory: as
// threefry_uniform, threefry_below and threefry_edge_drops, but row r's key
// is the u32 pair dkeys[2r], dkeys[2r + 1] and leg r's shift the int32
// dshifts[r] (any value; reduced mod n in the kernel), read when the kernel
// runs.
extern "C" int threefry_uniform_dev(const void* dkeys, int rows, uint64_t n,
                                    void* out, void* stream) {
  if (rows < 1 || rows > threefry::kMaxRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a = threefry::keyed(nullptr, 0, n, out);
  a.dkeys = static_cast<const uint32_t*>(dkeys);
  return threefry::launch<threefry::kUniform>(
      a, rows, static_cast<cudaStream_t>(stream));
}

extern "C" int threefry_below_dev(const void* dkey, uint64_t n, float p,
                                  void* out, void* stream) {
  Args a = threefry::keyed(nullptr, 0, n, out);
  a.dkeys = static_cast<const uint32_t*>(dkey);
  a.p = p;
  return threefry::launch<threefry::kBelow>(a, 1,
                                            static_cast<cudaStream_t>(stream));
}

extern "C" int threefry_edge_drops_dev(const void* dkeys,
                                       const void* dshifts, int rows,
                                       uint64_t n, const void* grp,
                                       float p_ab, float p_ba, void* out,
                                       void* stream) {
  if (rows < 1 || rows > threefry::kMaxRows || n == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a = threefry::keyed(nullptr, 0, n, out);
  a.dkeys = static_cast<const uint32_t*>(dkeys);
  a.dshift = static_cast<const int32_t*>(dshifts);
  a.grp = static_cast<const int32_t*>(grp);
  a.p_ab = p_ab;
  a.p_ba = p_ba;
  return threefry::launch<threefry::kEdgeDrops>(
      a, rows, static_cast<cudaStream_t>(stream));
}

extern "C" const char* threefry_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
