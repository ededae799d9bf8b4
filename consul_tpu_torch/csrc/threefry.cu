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
// the kernel is one launch a draw where the torch version made ~180.  The
// edge drops hash only their uncertain edges, so where no probability lies
// strictly between 0 and 1 (partition_heal's halves at 1) they are bound
// by bytes: a byte written an edge and the int32 group vector read once,
// 7 MB at [3, 1M], ~2.1 us at 3.35 TB/s.
//
// Design.  Keys come by value in the kernel's parameters (the host holds
// them as uint32[2]): no copy to the device, no synchronisation.  The
// round's own draws (the `_dev` entry points) read their keys, and the edge
// drops their shifts, from device memory instead: a row of the round's
// argument table (consul_tpu_torch/gossip/round_args.py), so that one
// captured launch serves every round of a replayed CUDA graph.  The draws
// but the edge drops: a 2-D grid, blockIdx.y the row, the threads of a row
// striding over its columns, one element a step, 32-bit rotates as funnel
// shifts; stores are coalesced (neighbouring threads, neighbouring
// elements).
//
// The edge drops, the only draw a round makes (a nemesis partition's mask,
// every leg in one launch), are bytes, and most of their outcomes are
// certain: a same-group edge never drops, a direction whose probability is
// 0 never, one at 1 always (a uniform lies in [0, 1)).  The first design
// stored a byte a thread, one element a loop step (its loads waited one
// after another), and hashed wherever any lane of a warp needed a hash.
// Now, on a row of 1M (the wide form), a block takes a span of kSpan
// destinations of one leg (blockIdx.y): each thread loads the groups of
// its kWide destinations and of their senders first (elements e = thread +
// kEdgeThreads * j, so every load is coalesced whatever the shift, all of
// them in flight at once), then writes the certain outcomes into the
// span's bytes in shared memory.  The uncertain edges (cross-group,
// 0 < p < 1) go into one list for the block (a warp's prefix sum, one
// shared atomic a warp), which all its threads then hash, an edge a
// thread, counter = the destination, each bit written back into the
// span's bytes; a launch whose probabilities are all certain runs an
// instance without the list and hashes nothing.  Then a thread stores 16
// consecutive destinations as one 16-byte store: the span starts on the
// row's own 16-byte boundary (a row of n bytes starts anywhere), and the
// destinations outside the row, its head and tail, go byte by byte.  A
// short row (16,001: the wide form's few blocks would each wait on a long
// list) is latency: there a thread takes one destination, hashes it if
// uncertain and stores its byte (the narrow form).  What holds the wide
// form back on an H100 (tools/draw_stages.py): at [3, 1M] the launch and
// the chain of each block's loads, shared-memory pass and stores, with
// the blocks of one leg a wave, not the bytes.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "threefry.cuh"

namespace threefry {

constexpr int kThreads = 256;
constexpr int kMaxRows = 16;     // keys of one launch (legs, rows)
constexpr int kMaxBlocks = 1056;  // 8 a multiprocessor of the 132
constexpr int kEdgeThreads = 128;            // edge drops: a block's threads,
constexpr int kWide = 16;                    // wide: destinations a thread,
constexpr int kSpan = kWide * kEdgeThreads;  // and a block's span
constexpr int kFill = 132;  // edge drops: wide from a block an SM (legs x spans)
// A wide span's uncertain edge in the list: its element and direction.
static_assert(kSpan <= 32768, "a list entry holds 16 bits");
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
  int wide;            // edge drops: a block a span of a leg
  float p, p_ab, p_ba;
  int32_t minval;
  uint32_t span, mult;
};

// A 16-byte access at p, which must be 16-byte aligned: the card faults
// otherwise, and the host build of this file (its tests) traps.
__device__ __forceinline__ uint4* at16(uint8_t* p) {
#ifndef __CUDA_ARCH__
  if ((reinterpret_cast<uintptr_t>(p) & 15u) != 0u) __builtin_trap();
#endif
  return reinterpret_cast<uint4*>(p);
}

// Row r's key and, for the edge drops, its shift in [0, n).
__device__ __forceinline__ void row_key(const Args& a, int r, uint32_t& k0,
                                        uint32_t& k1) {
  k0 = a.dkeys ? a.dkeys[2 * r] : a.k0[r];
  k1 = a.dkeys ? a.dkeys[2 * r + 1] : a.k1[r];
}

__device__ __forceinline__ int64_t row_shift(const Args& a, int r) {
  const int64_t n = static_cast<int64_t>(a.n);
  if (a.dshift == nullptr) return a.shift[r];
  const int64_t raw = a.dshift[r];
  // A shift within (-n, n), as the round's table holds, needs no division.
  if (raw > -n && raw < n) return raw < 0 ? raw + n : raw;
  const int64_t shift = raw % n;
  return shift < 0 ? shift + n : shift;
}

// What the edge drops' launch decides once: the probabilities' outcomes.
struct Edges {
  float p_ab, p_ba;
  bool drop_ab, drop_ba;  // a certain direction: every cross edge drops
  bool hashes;            // some direction is drawn: 0 < p < 1
};

__device__ __forceinline__ Edges edges(const Args& a) {
  Edges x;
  x.p_ab = a.p_ab;
  x.p_ba = a.p_ba;
  x.drop_ab = x.p_ab >= 1.0f;
  x.drop_ba = x.p_ba >= 1.0f;
  x.hashes = (x.p_ab > 0.0f && x.p_ab < 1.0f) ||
             (x.p_ba > 0.0f && x.p_ba < 1.0f);
  return x;
}

// The groups of a thread's kWide destinations d0 + kEdgeThreads * j (0
// outside the row; Full: none is) and of their senders on a leg of shift
// `shift`, which run on by one a destination and wrap at n once at most.
template <bool Full>
__device__ __forceinline__ void load_groups(const Args& a, int64_t d0,
                                            int32_t (&g)[kWide]) {
  const int64_t lo = -d0, hi = static_cast<int64_t>(a.n) - d0;
#pragma unroll
  for (int j = 0; j < kWide; ++j) {
    const int at = j * kEdgeThreads;
    g[j] = Full || (at >= lo && at < hi) ? a.grp[d0 + at] : 0;
  }
}

template <bool Full>
__device__ __forceinline__ void load_senders(const Args& a, int64_t d0,
                                             int64_t shift,
                                             int32_t (&g)[kWide]) {
  const int64_t n = static_cast<int64_t>(a.n);
  int64_t s0 = d0 - shift;
  if (s0 < 0) s0 += n;
  const int64_t left = n - s0;  // element j wraps from j * kEdgeThreads >= left
  const int wrap = left > kSpan ? kSpan : static_cast<int>(left);
  const int32_t* src = a.grp + s0;
  const int32_t* src_wrapped = a.grp + (s0 - n);
  const int64_t lo = -d0, hi = n - d0;
#pragma unroll
  for (int j = 0; j < kWide; ++j) {
    const int at = j * kEdgeThreads;
    g[j] = Full || (at >= lo && at < hi)
               ? (at < wrap ? src : src_wrapped)[at]
               : 0;
  }
}

// The wide form (rows of 1M): a block a span of kSpan destinations of leg
// blockIdx.y (the design above).  Each thread loads the groups of its
// kWide destinations first + thread + kEdgeThreads * j and of their
// senders (every load in flight at once, coalesced whatever the shift) and
// writes the certain outcomes into s_out.  Hashes (some probability drawn):
// it lists its uncertain edges in s_list, at its place in the block's list
// (a warp's prefix sum and one shared atomic a warp), and the block's
// threads hash the list together, an edge a thread at a time.  Then the
// span is stored: s_out starts on the row's own 16-byte boundary, so a
// thread stores its 16 bytes as one unit but at the row's head and tail.
template <bool Hashes>
__device__ void edge_drops_wide(const Args& a, const Edges& x) {
  __shared__ __align__(16) uint8_t s_out[kSpan];
  __shared__ uint16_t s_list[Hashes ? kSpan : 1];  // element | !from0 << 15
  __shared__ int s_count;
  const int64_t n = static_cast<int64_t>(a.n);
  const int r = static_cast<int>(blockIdx.y);
  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  uint8_t* row = static_cast<uint8_t*>(a.out) + static_cast<int64_t>(r) * n;
  const int off = -static_cast<int>(reinterpret_cast<uintptr_t>(row) & 15u);
  const int64_t spans = (n + 15 + kSpan - 1) / kSpan;
  const int64_t shift = row_shift(a, r);
  uint32_t k0, k1;
  row_key(a, r, k0, k1);
#pragma unroll 1
  for (int64_t sp = blockIdx.x; sp < spans; sp += gridDim.x) {
    const int64_t first = sp * kSpan + off;  // the span's first destination
    const int64_t d0 = first + tid;
    __syncthreads();  // the span before is hashed and stored
    if (Hashes && tid == 0) s_count = 0;
    int32_t g_dst[kWide], g_src[kWide];
    if (first >= 0 && first + kSpan <= n) {
      load_groups<true>(a, d0, g_dst);
      load_senders<true>(a, d0, shift, g_src);
    } else {
      load_groups<false>(a, d0, g_dst);
      load_senders<false>(a, d0, shift, g_src);
    }
    // The certain outcomes; bit j of unc an uncertain edge, bit 16 + j one
    // from a group other than 0 (under p_ba).
    uint32_t unc = 0u;
#pragma unroll
    for (int j = 0; j < kWide; ++j) {
      const bool from0 = g_src[j] == 0;
      const bool cross = g_src[j] != g_dst[j];
      if (Hashes) {
        const float p = from0 ? x.p_ab : x.p_ba;
        if (cross && p > 0.0f && p < 1.0f) {
          unc |= (1u << j) | (static_cast<uint32_t>(!from0) << (16 + j));
          continue;
        }
      }
      s_out[tid + j * kEdgeThreads] =
          cross && (from0 ? x.drop_ab : x.drop_ba);
    }
    if (Hashes) {
      __syncthreads();  // s_count is 0
      const int mine = __popc(unc & 0xFFFFu);
      int below = mine;  // the warp's prefix sum, this lane's included
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xFFFFFFFFu, below, o);
        if (lane >= o) below += v;
      }
      int at = 0;
      if (lane == 31) at = atomicAdd(&s_count, below);
      at = __shfl_sync(0xFFFFFFFFu, at, 31) + below - mine;
      for (uint32_t m = unc & 0xFFFFu; m != 0u; m &= m - 1u) {
        const int j = __ffs(static_cast<int>(m)) - 1;
        s_list[at++] = static_cast<uint16_t>(
            (tid + j * kEdgeThreads) | ((unc >> (16 + j)) & 1u) << 15);
      }
      __syncthreads();
      const int count = s_count;
#pragma unroll 4
      for (int i = tid; i < count; i += kEdgeThreads) {
        const unsigned v = s_list[i];
        const int e = static_cast<int>(v & 0x7FFFu);
        const float p = v >> 15 ? x.p_ba : x.p_ab;
        s_out[e] = unit_float(hash(k0, k1, static_cast<uint32_t>(first + e))) <
                   p;
      }
    }
    __syncthreads();
    // 16 consecutive destinations a thread: one 16-byte store, or bytes
    // at the row's head and tail.
    for (int e0 = 16 * tid; e0 < kSpan; e0 += 16 * kEdgeThreads) {
      const int64_t f0 = first + e0;
      if (f0 >= 0 && f0 + 16 <= n) {
        *at16(row + f0) = *reinterpret_cast<const uint4*>(s_out + e0);
      } else {
        for (int i = 0; i < 16; ++i) {
          if (f0 + i >= 0 && f0 + i < n) row[f0 + i] = s_out[e0 + i];
        }
      }
    }
  }
}

// The narrow form (short rows, where a launch is latency): a thread a
// destination of leg blockIdx.y, its groups loaded, its hash where its
// outcome is uncertain, its byte stored.
__device__ void edge_drops_narrow(const Args& a, const Edges& x) {
  const int64_t n = static_cast<int64_t>(a.n);
  const int r = static_cast<int>(blockIdx.y);
  uint8_t* row = static_cast<uint8_t*>(a.out) + static_cast<int64_t>(r) * n;
  const int64_t shift = row_shift(a, r);
  uint32_t k0, k1;
  row_key(a, r, k0, k1);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kEdgeThreads;
#pragma unroll 1
  for (int64_t d = static_cast<int64_t>(blockIdx.x) * kEdgeThreads + threadIdx.x;
       d < n; d += stride) {
    int64_t s = d - shift;
    if (s < 0) s += n;
    const int32_t g_src = a.grp[s], g_dst = a.grp[d];
    const bool from0 = g_src == 0;
    const bool cross = g_src != g_dst;
    const float p = from0 ? x.p_ab : x.p_ba;
    bool drop = cross && (from0 ? x.drop_ab : x.drop_ba);
    if (cross && p > 0.0f && p < 1.0f) {
      drop = unit_float(hash(k0, k1, static_cast<uint32_t>(d))) < p;
    }
    row[d] = drop;
  }
}

template <int M>
__global__ void __launch_bounds__(kThreads) draw_kernel(const Args a) {
  if constexpr (M == kEdgeDrops) {
    const Edges x = edges(a);
    if (!a.wide) {
      edge_drops_narrow(a, x);
    } else if (x.hashes) {
      edge_drops_wide<true>(a, x);
    } else {
      edge_drops_wide<false>(a, x);
    }
  } else {
    const int r = blockIdx.y;
    uint32_t k0, k1;
    row_key(a, r, k0, k1);
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
      } else {  // kRandint
        const uint32_t hi = hash(a.k0[0], a.k1[0], ctr);
        const uint32_t lo = hash(a.k0[1], a.k1[1], ctr);
        const uint32_t off = (hi % a.span) * a.mult + lo % a.span;
        static_cast<int32_t*>(a.out)[c] = static_cast<int32_t>(
            static_cast<uint32_t>(a.minval) + off % a.span);
      }
    }
  }
}

template <int M>
int launch(Args a, int rows, cudaStream_t stream) {
  if (a.n == 0 || a.n > kMaxCounters || rows < 1 || rows > kMaxRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if constexpr (M == kEdgeDrops) {
    // Wide where the legs' spans give every multiprocessor a block: a
    // block a span; else a thread a destination.  A leg a row of blocks.
    const uint64_t spans = (a.n + 15 + kSpan - 1) / kSpan;
    a.wide = spans * rows >= kFill;
    const uint64_t want =
        a.wide ? spans : (a.n + kEdgeThreads - 1) / kEdgeThreads;
    const dim3 grid(
        static_cast<unsigned>(want < kMaxBlocks ? want : kMaxBlocks),
        static_cast<unsigned>(rows));
    draw_kernel<kEdgeDrops><<<grid, kEdgeThreads, 0, stream>>>(a);
  } else {
    const uint64_t want = (a.n + kThreads - 1) / kThreads;
    const dim3 grid(
        static_cast<unsigned>(want < kMaxBlocks ? want : kMaxBlocks),
        static_cast<unsigned>(rows));
    draw_kernel<M><<<grid, kThreads, 0, stream>>>(a);
  }
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
