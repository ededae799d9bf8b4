// The user-event flood of one gossip round, for Hopper (sm_90a): the whole
// event round on the [E, N] slot matrix in one launch.
//
// It replaces the XLA step consul_tpu/gossip/events.py:100-170
// (`event_round`, jitted; no Pallas source), whose scan the port replays as
// a CUDA graph (consul_tpu_torch/gossip/program.py, EventProgram).  It is
// bit-identical to the plain torch version beside its wrapper
// (consul_tpu_torch/gossip/events.py: event_flood_ref).
//
// What it computes.  has[e, i] is one byte per (event slot, node): bit 7
// seen, bits 3-0 the age in rounds.  For each slot e and node c, with the
// round's F gossip shifts o_f (sender c - o_f mod N):
//   new_seen = OR_f alive[c - o_f] & seen(has[e, c - o_f])
//                   & age(has[e, c - o_f]) < budget, all & alive[c];
// on a push/pull round also, for both partner shifts +-pp, alive[c] &
// alive[c -+ pp] & seen(has[e, c -+ pp]), with no budget.  fresh =
// new_seen & !seen(has[e, c]); the byte becomes 0x80 where fresh, else
// 0x80 | min(age + 1, 15) where seen, else stays; a slot whose TTL ran out
// (used[e] and rnd - start[e] > ttl, int32 arithmetic) is cleared and
// freed (used = 0, origin = -1).  n_seen[e] += the fresh bytes of row e
// (mod 2**32), and the Lamport witness wit[c] = max over e of (fresh ?
// ltime[e] : 0) moves node_ltime[c] to max(node_ltime[c], wit) + 1 where
// wit > 0.  The fresh count and the witness are taken before the slot GC,
// as in the reference.
//
// Bound: bytes.  One pass must read has and write it (2 E N bytes), read
// alive (N) and read and write node_ltime (8 N): at E = 32, N = 250,000
// 18.25 MB, 0.0054 ms at 3.35 TB/s; at [64, 1M] 137 MB, 0.041 ms.  It also
// counts, per slot, the live nodes holding the event after the round, the
// numerator of the round's coverage, so the caller's coverage needs no
// second pass over has.
//
// Design.  A thread owns one 32-bit word: four neighbouring columns
// c0 .. c0 + 3, and loops over the E slots, so that the witness max over
// slots stays in its registers and node_ltime is read and written once.
// Once per thread: each leg's four source columns (c0 + k - o_f, reduced
// mod N) and the 0x01-per-byte masks of its live senders and of the
// receivers.  Per slot: every pin byte of every leg is loaded (the same
// columns of the slot's row, no arithmetic but the row's base) before any
// is used, and the current word in one load where rows are word-aligned;
// neighbouring threads read neighbouring bytes, so a warp's loads of a
// leg fall in one or two 128-byte lines.  The rule then runs on the four
// bytes of a word at once (seen bits, an age < budget compare by a borrow
// into bit 4, a saturating age increment).  The slots' Lamport times and
// GC flags sit in shared memory, loaded once per block, and so do the
// block's per-slot counts: a warp sums its fresh bytes (and its live
// holders) with __reduce_add_sync into them, and the block adds them to
// n_seen with one unsigned atomicAdd per slot (the int32 count wraps as
// the reference's does).  What costs: a first design (a shifted word per
// leg where the window allowed, the counts added per warp in device
// memory, the slot registers loaded per slot) ran at a tenth of the
// bound (0.0573 ms at [32, 250,000], NVIDIA H100 80GB HBM3, 700.00 W,
// chip_smoke.py); the remaining gap is the instructions a byte costs and
// the per-slot loop of each thread, which a later design could split
// across threads.
//
// Arguments from device memory.  The round and its shifts are read, as the
// event row [rnd, o_0 .. o_F-1, pp_o, -pp_o] (int32, any shift value,
// reduced mod N), from device memory when the kernel runs: a row of the
// call's event table (consul_tpu_torch/gossip/round_args.py), so that one
// captured launch serves every round.  Push/pull is a by-value flag: it is
// fixed per captured variant.

#include <cuda_runtime.h>

#include <cstdint>

namespace evflood {

constexpr int kMaxFanout = 8;
constexpr int kMaxSlots = 3072;  // 16 bytes of shared memory a slot
constexpr int kThreads = 256;
constexpr int kMinBlocks = 2;    // at most 128 registers a thread
constexpr uint32_t kLsb = 0x01010101u;
constexpr uint32_t kSeenBits = 0x80808080u;
constexpr uint32_t kAgeBits = 0x0F0F0F0Fu;

struct Args {
  const uint8_t* has;         // u8 [E, N]
  const uint8_t* alive;       // [N] bool
  const uint8_t* used;        // [E] bool
  const int32_t* ltime;       // [E]
  const int32_t* origin;      // [E]
  const int32_t* start;       // [E] the slot's start round
  const int32_t* node_ltime;  // [N]
  uint8_t* out_has;           // u8 [E, N]
  uint8_t* out_used;          // [E] bool
  int32_t* out_origin;        // [E]
  int32_t* out_node_ltime;    // [N] (may be node_ltime itself)
  uint32_t* n_seen;           // [E], holding the counts before the round
  uint32_t* held;             // [E] zeros, or nullptr: alive holders after
  const int32_t* dargs;       // [rnd, o_0 .. o_F-1, pp_o, -pp_o]
  int E, N;
  int budget;                 // clamped into [0, 16]
  int ttl;
  bool pushpull;
  bool words_ok;              // N % 4 == 0 and has, out_has 4-byte aligned
};

// Four column indices of a row: (g + k) mod N for k = 0 .. 3.
struct Cols {
  int c[4];
};

__device__ __forceinline__ Cols columns(int g, int N) {
  Cols out;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int i = g + k;
    while (i >= N) i -= N;
    out.c[k] = i;
  }
  return out;
}

// A word with byte k holding row[cols.c[k]], for k < n (0 above).
__device__ __forceinline__ uint32_t gather(const uint8_t* row,
                                           const Cols& cols, int n) {
  uint32_t w = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (k < n) w |= static_cast<uint32_t>(__ldg(row + cols.c[k])) << (8 * k);
  }
  return w;
}

// 0x01 per byte of `pin` that is seen with an age below `budget` (budget
// in [0, 16]: bit 4 of (age | 16) - budget is clear iff age < budget; no
// byte borrows from its neighbour).
__device__ __forceinline__ uint32_t live_pins(uint32_t pin, uint32_t bud) {
  const uint32_t y = ((pin & kAgeBits) | 0x10101010u) - bud;
  return (pin >> 7) & ~(y >> 4) & kLsb;
}

// Whether slot e's TTL has run out at round rnd (int32 arithmetic).
__device__ __forceinline__ bool slot_done(const Args& a, int rnd, int e) {
  return __ldg(a.used + e) != 0 &&
         static_cast<int32_t>(static_cast<uint32_t>(rnd) -
                              static_cast<uint32_t>(__ldg(a.start + e))) >
             a.ttl;
}

template <int F>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flood_kernel(const __grid_constant__ Args a) {
  const int t = static_cast<int>(blockIdx.x) * kThreads +
                static_cast<int>(threadIdx.x);
  const int N = a.N;
  const int c0 = t * 4;
  const int n_cols = c0 < N ? min(4, N - c0) : 0;
  const int rnd = __ldg(a.dargs);

  // The slots' Lamport times and GC flags, and the block's fresh counts,
  // in shared memory: a slot's registers are then no load in the loop.
  extern __shared__ uint32_t flood_smem[];
  int32_t* s_lt = reinterpret_cast<int32_t*>(flood_smem);
  uint32_t* s_done = flood_smem + a.E;
  uint32_t* s_cnt = flood_smem + 2 * a.E;
  uint32_t* s_held = flood_smem + 3 * a.E;
  for (int e = static_cast<int>(threadIdx.x); e < a.E; e += kThreads) {
    s_lt[e] = __ldg(a.ltime + e);
    s_done[e] = slot_done(a, rnd, e) ? 1u : 0u;
    s_cnt[e] = 0;
    s_held[e] = 0;
  }
  __syncthreads();

  // Each leg's four source columns (reduced mod N once, so a slot's loads
  // need no arithmetic but the row's base) and its live-sender masks (with
  // the receivers), once for all slots.
  constexpr int kLegs = F + 2;
  const int legs = a.pushpull ? F + 2 : F;
  Cols idx[kLegs];
  uint32_t ok[kLegs];
  const Cols own = columns(c0, N);
  const uint32_t rx = n_cols ? gather(a.alive, own, n_cols) & kLsb : 0u;
#pragma unroll
  for (int f = 0; f < kLegs; ++f) {
    idx[f] = own;
    ok[f] = 0;
    if (f < legs && n_cols) {
      int o = __ldg(a.dargs + 1 + f) % N;
      if (o < 0) o += N;
      int s = c0 - o;
      if (s < 0) s += N;
      idx[f] = columns(s, N);
      ok[f] = rx & gather(a.alive, idx[f], n_cols) & kLsb;
    }
  }
  const uint32_t bud = static_cast<uint32_t>(a.budget) * kLsb;
  const bool word_cur = a.words_ok && n_cols == 4;

  int wit[4] = {0, 0, 0, 0};
  const unsigned lane = threadIdx.x & 31u;
  // Not unrolled: one iteration is one slot.
#pragma unroll 1
  for (int e = 0; e < a.E; ++e) {
    uint32_t fresh = 0;
    uint32_t kept = 0;  // 0x01 per byte seen after the round at a live node
    if (n_cols) {
      const uint8_t* row = a.has + static_cast<size_t>(e) * N;
      // Every load of the slot first (no branch between them), then the
      // rule on the four bytes.
      uint32_t pin[kLegs];
#pragma unroll
      for (int f = 0; f < kLegs; ++f) {
        pin[f] = f < legs ? gather(row, idx[f], n_cols) : 0u;
      }
      const uint32_t cur =
          word_cur ? __ldg(reinterpret_cast<const uint32_t*>(row + c0))
                   : gather(row, own, n_cols);
      const uint32_t seen = (cur >> 7) & kLsb;
      uint32_t ns = 0;
#pragma unroll
      for (int f = 0; f < F; ++f) ns |= live_pins(pin[f], bud) & ok[f];
      // The push/pull legs (ok is 0 off a push/pull round): no budget.
      ns |= (pin[F] >> 7) & ok[F];
      ns |= (pin[F + 1] >> 7) & ok[F + 1];
      fresh = ns & ~seen;
      // Ages: +1, saturating at 15, on the seen bytes.
      const uint32_t age = cur & kAgeBits;
      const uint32_t inc = age + kLsb;
      const uint32_t aged_age = inc - ((inc >> 4) & kLsb);
      const uint32_t seen_m = seen * 0xFFu;
      const uint32_t aged = (seen_m & (kSeenBits | aged_age)) | (~seen_m & cur);
      const uint32_t fresh_m = fresh * 0xFFu;
      uint32_t out = (fresh_m & kSeenBits) | (~fresh_m & aged);
      if (s_done[e]) out = 0;
      kept = (out >> 7) & rx;
      uint8_t* orow = a.out_has + static_cast<size_t>(e) * N;
      if (word_cur) {
        *reinterpret_cast<uint32_t*>(orow + c0) = out;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (k < n_cols) orow[c0 + k] = static_cast<uint8_t>(out >> (8 * k));
        }
      }
      if (fresh) {
        const int lt = s_lt[e];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if ((fresh >> (8 * k)) & 1u) wit[k] = max(wit[k], lt);
        }
      }
    }
    const unsigned total =
        __reduce_add_sync(0xFFFFFFFFu, static_cast<unsigned>(__popc(fresh)));
    if (lane == 0 && total) atomicAdd(s_cnt + e, total);
    if (a.held != nullptr) {
      const unsigned h =
          __reduce_add_sync(0xFFFFFFFFu, static_cast<unsigned>(__popc(kept)));
      if (lane == 0 && h) atomicAdd(s_held + e, h);
    }
  }

#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (k < n_cols) {
      const int nl = __ldg(a.node_ltime + c0 + k);
      a.out_node_ltime[c0 + k] =
          wit[k] > 0 ? static_cast<int32_t>(
                           static_cast<uint32_t>(max(nl, wit[k])) + 1u)
                     : nl;
    }
  }
  // The block's counts, one atomic per slot (they wrap mod 2**32).
  __syncthreads();
  for (int e = static_cast<int>(threadIdx.x); e < a.E; e += kThreads) {
    if (s_cnt[e]) atomicAdd(a.n_seen + e, s_cnt[e]);
    if (s_held[e]) atomicAdd(a.held + e, s_held[e]);
  }
  // The slot GC of the small [E] registers.
  if (t < a.E) {
    a.out_used[t] = (__ldg(a.used + t) != 0 && !s_done[t]) ? 1 : 0;
    a.out_origin[t] = s_done[t] ? -1 : __ldg(a.origin + t);
  }
}

template <int F>
int launch_f(const Args& a, int blocks, cudaStream_t stream) {
  const size_t smem = 16 * static_cast<size_t>(a.E);
  flood_kernel<F><<<blocks, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

inline bool aligned4(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 3) == 0;
}

}  // namespace evflood

// One event round of has[E, N] (see the top of this file).  alive: one
// byte per node (a torch bool tensor); used: one byte per slot; ltime,
// origin, start: int32 [E]; node_ltime: int32 [N]; out_*: the new has,
// used, origin and node_ltime (out_node_ltime may be node_ltime);
// n_seen: uint32 [E] holding the counts before the round, added to in
// place; held: nullptr, or uint32 [E] of zeros that receives each slot's
// alive holders after the round (the coverage's numerator); dargs:
// int32 [rnd, o_0 .. o_fanout-1, pp_o,
// -pp_o] in device memory, read when the kernel runs; fanout in [1, 8];
// budget the spread budget (ages below it are sent), ttl the slots' TTL,
// pushpull nonzero on a push/pull round.  Launches on `stream`, does not
// synchronise, returns cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for arguments it does not take).
extern "C" int event_flood(const void* has, const void* alive,
                           const void* used, const void* ltime,
                           const void* origin, const void* start,
                           const void* node_ltime, void* out_has,
                           void* out_used, void* out_origin,
                           void* out_node_ltime, void* n_seen,
                           void* held, int E, int N, int fanout,
                           const void* dargs, int budget, int ttl,
                           int pushpull, void* stream) {
  using namespace evflood;
  if (has == nullptr || dargs == nullptr || E < 1 ||
      E > kMaxSlots || N < 1 || N > 2147483639 || fanout < 1 ||
      fanout > kMaxFanout) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{};
  a.has = static_cast<const uint8_t*>(has);
  a.alive = static_cast<const uint8_t*>(alive);
  a.used = static_cast<const uint8_t*>(used);
  a.ltime = static_cast<const int32_t*>(ltime);
  a.origin = static_cast<const int32_t*>(origin);
  a.start = static_cast<const int32_t*>(start);
  a.node_ltime = static_cast<const int32_t*>(node_ltime);
  a.out_has = static_cast<uint8_t*>(out_has);
  a.out_used = static_cast<uint8_t*>(out_used);
  a.out_origin = static_cast<int32_t*>(out_origin);
  a.out_node_ltime = static_cast<int32_t*>(out_node_ltime);
  a.n_seen = static_cast<uint32_t*>(n_seen);
  a.held = static_cast<uint32_t*>(held);
  a.dargs = static_cast<const int32_t*>(dargs);
  a.E = E;
  a.N = N;
  a.budget = budget < 0 ? 0 : (budget > 16 ? 16 : budget);
  a.ttl = ttl;
  a.pushpull = pushpull != 0;
  a.words_ok = N % 4 == 0 && aligned4(has) && aligned4(out_has);
  const long long words = (static_cast<long long>(N) + 3) / 4;
  const long long threads = words > E ? words : E;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fanout) {
    case 1: return launch_f<1>(a, blocks, s);
    case 2: return launch_f<2>(a, blocks, s);
    case 3: return launch_f<3>(a, blocks, s);
    case 4: return launch_f<4>(a, blocks, s);
    case 5: return launch_f<5>(a, blocks, s);
    case 6: return launch_f<6>(a, blocks, s);
    case 7: return launch_f<7>(a, blocks, s);
    default: return launch_f<8>(a, blocks, s);
  }
}

extern "C" const char* event_flood_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
