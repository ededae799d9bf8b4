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
// as in the reference.  It also counts, per slot, the live nodes holding
// the event after the round (the numerator of the round's coverage), so
// the caller's coverage needs no second pass over has.
//
// Bound.  One pass must read has and write it (2 E N bytes), read alive
// (N) and read and write node_ltime (8 N): at E = 32, N = 250,000 18.25
// MB, 0.0054 ms at 3.35 TB/s; at [64, 1M] 137 MB, 0.041 ms.  Its integer
// operations, counted by hand from the rule (chip_smoke.py _flood_bound:
// 8 F + 24 a word), are of the same order; chip_smoke.py takes the larger.
//
// Work split.  A block of 4 warps owns a tile of kTile = 512 columns and a
// slot group (blockIdx.x, blockIdx.y); every warp covers the whole tile,
// and the warps split the group's slots (warp w takes slots w, w + 4, ..),
// so the slots of a tile run in parallel.  A lane owns kWords = 4 words of
// the tile, interleaved with the other lanes' (word k of lane l covers the
// columns 128 k + 4 l .. + 3), so that each load of a warp reads 128
// neighbouring bytes.  The launcher makes one slot group (all E slots, at
// most kMaxRows), and cuts a short row's slots into groups, down to a slot
// a warp, until the grid has a block per SM (the WAN pool's 12 nodes).
// Groups of rows that fit L2 at [64, 1M] measured slower than one group:
// each block pays its set-up and its arrival, and those outweighed the
// reads from device memory they saved.
//
// Per lane, once for all its slots: each leg's window start (its pins for
// word k are the columns c_k - o_f .. + 3 mod N of the slot's row) and the
// 0x01-per-byte masks of its live senders and receivers.  Per slot, the
// word path (N % 4 == 0 and 4-byte aligned buffers: every row the main
// paths run): the current words; each leg's window as the lane's aligned
// words at s & ~3 (+ 128 k, mod N) and the word after each, which is the
// right neighbour lane's same word (lane 31: lane 0's next word, or the
// word after the warp's last, which it loads itself), joined with funnel
// shifts.  So a warp loads each word of a window once, a window that
// wraps at N costs no more, and all of a slot's loads are issued before
// any is used.  A warp whose words all lie in the row unwrapped takes a
// loop with no wrap arithmetic.  Then the rule on each word (seen bits, an
// age < budget compare by a borrow into bit 4, a saturating age
// increment), each leg folded into new_seen as it is joined, and the
// stores.  The byte path (N % 4 != 0 or a buffer not 4-byte aligned; the
// whole launch takes one path) gathers the bytes one by one.
//
// The counts.  The warp that runs a slot sums its fresh bytes (and its
// live holders) with __reduce_add_sync into the block's counts in shared
// memory; after its slots the block adds each count to the scratch with
// one unsigned atomicAdd, into one of kStripes copies chosen by the tile,
// so that the grid's adds to one slot spread over as many lines of L2.
// The witness.  A lane keeps the max of its slots per column in registers
// and takes it into the block's witness in shared memory (atomicMax from
// 0: the reference's 0 where not fresh).  With one slot group the block
// finishes node_ltime for its tile (the clocks read at its start).  With
// several, it takes the max into the scratch's [N] witness (atomicMax
// where positive), and the last block of a column tile to arrive (a
// per-tile counter, added to with release semantics; the last acquires)
// finishes node_ltime and zeroes the tile's scratch.  The block that
// finishes a tile then arrives at a grid counter; the last to arrive sums
// the stripes into n_seen and the live holders, does the slot GC of used
// and origin, and zeroes the counts.  So the scratch is all zero between
// launches (the wrapper makes it zero once), and a round is one launch
// with no memset.
//
// Arguments from device memory.  The round and its shifts are read, as the
// event row [rnd, o_0 .. o_F-1, pp_o, -pp_o] (int32, any shift value,
// reduced mod N), from device memory when the kernel runs: a row of the
// call's event table (consul_tpu_torch/gossip/round_args.py), so that one
// captured launch serves every round.  Push/pull is a by-value flag: it is
// fixed per captured variant, and picks the kernel's instance.

#include <cuda_runtime.h>

#include <cstdint>

namespace evflood {

constexpr int kMaxFanout = 8;
constexpr int kMaxSlots = 3072;
constexpr int kWords = 4;                // 32-bit words per lane
constexpr int kCols = 4 * kWords;        // columns per lane
constexpr int kStride = 128;             // columns from a lane's word to the next
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32 * kCols;        // columns per block (every warp)
constexpr int kMaxRows = 256;            // slots of a slot group
constexpr int kStripes = 32;             // copies of each slot's counts
// Blocks an SM holds at once: 128 registers a thread, or 170 with the
// push/pull legs (which spill at 128); and the H100's SMs, the fewest
// blocks a grid should have.
constexpr int kMinBlocks = 512 / kThreads;
constexpr int kMinBlocksPP = 384 / kThreads;
constexpr int kSMs = 132;
constexpr uint32_t kLsb = 0x01010101u;
constexpr uint32_t kSeenBits = 0x80808080u;
constexpr uint32_t kAgeBits = 0x0F0F0F0Fu;

struct Args {
  const uint8_t* used;        // [E] bool
  const int32_t* ltime;       // [E]
  const int32_t* origin;      // [E]
  const int32_t* start;       // [E] the slot's start round
  const int32_t* node_ltime;  // [N]
  const uint32_t* n_seen;     // [E] the counts before the round
  uint8_t* out_used;          // [E] bool
  int32_t* out_origin;        // [E]
  int32_t* out_node_ltime;    // [N] (may be node_ltime itself)
  uint32_t* out_n_seen;       // [E] (may be n_seen itself)
  uint32_t* held;             // [E], or nullptr: alive holders after
  uint32_t* scratch;          // scratch_words(E, N), zero between launches
  const int32_t* dargs;       // [rnd, o_0 .. o_F-1, pp_o, -pp_o]
  int E, N;
  int tiles;                  // column tiles, ceil(N / kTile)
  int rows;                   // slots per slot group
  int groups;                 // slot groups, ceil(E / rows)
  int budget;                 // clamped into [0, 16]
  int ttl;
  bool words_ok;  // N % 4 == 0 and has, out_has, alive 4-byte aligned
};

// The scratch, in 32-bit words: the witness [N], the tiles' arrival
// counters [tiles], the fresh counts and the live holders [kStripes, E]
// each, the grid's arrival counter.
__host__ __device__ inline long long scratch_words(long long E, long long N) {
  return N + (N + kTile - 1) / kTile + 2 * kStripes * E + 1;
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

// The bytes p[(s + k) mod N], k < n (0 above), as a word (s in [0, N),
// n <= N).
__device__ __forceinline__ uint32_t gather4(const uint8_t* __restrict__ p,
                                            int s, int n, int N) {
  uint32_t b[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t i = static_cast<uint32_t>(s) + static_cast<uint32_t>(k);
    if (i >= static_cast<uint32_t>(N)) i -= static_cast<uint32_t>(N);
    b[k] = k < n ? static_cast<uint32_t>(__ldg(p + i)) : 0u;
  }
  return b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24;
}

// (s + kStride k) mod N for s in [0, N): the start of a lane's word k (a
// row of kTile columns or more wraps a lane's words at most once; no sum
// here passes 2**31 - 1).
__device__ __forceinline__ int word_start(int s, int k, int N) {
  if (N >= kTile) {
    const int room = N - kStride * k;
    return s >= room ? s - room : s + kStride * k;
  }
  return (s + kStride * k) % N;
}

// Adds one to a counter in device memory at GPU scope with release
// semantics (what the block wrote before its __syncthreads is visible to
// whoever acquires the new value) and returns the old value; and the
// acquire that the last to arrive makes before it reads the others'.
__device__ __forceinline__ unsigned add_release(unsigned* counter) {
#ifdef __CUDA_ARCH__
  unsigned old;
  asm volatile("atom.add.release.gpu.u32 %0, [%1], 1;"
               : "=r"(old) : "l"(counter) : "memory");
  return old;
#else
  return __atomic_fetch_add(counter, 1u, __ATOMIC_RELEASE);
#endif
}

__device__ __forceinline__ void fence_acquire() {
#ifdef __CUDA_ARCH__
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
#else
  __atomic_thread_fence(__ATOMIC_ACQUIRE);
#endif
}

// node_ltime after the witness w: max(nl, w) + 1 where w > 0 (uint32
// wrap), else nl.
__device__ __forceinline__ int32_t witnessed(int32_t nl, int32_t w) {
  return w > 0 ? static_cast<int32_t>(static_cast<uint32_t>(max(nl, w)) + 1u)
               : nl;
}

// What a lane keeps across its slots.  Its word k covers the columns c0
// + kStride k .. + 3 (c0 = the tile's first column + 4 lane, mod N for a
// lane past the row's end, which stands in for its columns there so that
// its words are its left neighbour's right neighbours).  Each leg's window
// start (the word path: its aligned word at word 0, the shift its next
// word is joined at, where lane 31 reads the word after its last), the
// sender and receiver masks (0x01 a live byte), the witness per column.
template <int L>
struct Lane {
  uint32_t c0u;   // c0 before the wrap (c0u >= N: past the row's end)
  int c0;
  bool fast;      // the warp's words all lie in the row, unwrapped
  int src[L];
  uint32_t sh[L];
  int edge[L];
  uint32_t ok[L][kWords];
  uint32_t rx[kWords];
  uint32_t bud;
  int wit[kCols];
};

// A slot's Lamport time and whether its TTL ran out, read once a block.
struct Slot {
  int lt;
  int done;
};

// The columns of word k of a lane that lie in the row (0 to 4).
template <int L>
__device__ __forceinline__ int word_cols(const Lane<L>& l, int k, int N) {
  const uint32_t c = l.c0u + kStride * k;
  const uint32_t n = static_cast<uint32_t>(N);
  return c >= n ? 0 : (n - c >= 4u ? 4 : static_cast<int>(n - c));
}

// The word path's offset of word k from an aligned start s in [0, N)
// (kFast: the words lie in the row unwrapped).
template <bool kFast>
__device__ __forceinline__ int word_off(int s, int k, int N) {
  return kFast ? s + kStride * k : word_start(s, k, N);
}

// Leg windows on the word path: x[k] is the lane's aligned word k of the
// window, edge the word after its last one (lane 31's, read by itself);
// the word after x[k] is the right neighbour lane's x[k] (lane 31's: lane
// 0's x[k + 1], or edge), joined with a funnel shift.
__device__ __forceinline__ void join_window(const uint32_t (&x)[kWords],
                                            uint32_t edge, uint32_t sh,
                                            bool lane31,
                                            uint32_t (&pin)[kWords]) {
  const int next = (static_cast<int>(threadIdx.x) + 1) & 31;
  uint32_t r[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) r[k] = __shfl_sync(0xFFFFFFFFu, x[k], next);
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const uint32_t hi =
        lane31 ? (k + 1 < kWords ? r[k + 1 < kWords ? k + 1 : 0] : edge) : r[k];
    pin[k] = __funnelshift_r(x[k], hi, sh);
  }
}

// The rule, split so that a leg's pins are folded in as soon as they are
// joined.  Leg f's contribution to new_seen (0x01 a byte): seen pins with
// an age below the budget, or, for the push/pull partner legs (f >= F),
// seen pins with no budget; gated by ok, its live senders and receivers.
template <int F>
__device__ __forceinline__ uint32_t leg_bits(int f, uint32_t pin, uint32_t ok,
                                             uint32_t bud) {
  return (f < F ? live_pins(pin, bud) : (pin >> 7) & kLsb) & ok;
}

// The new byte of each column of a word from its current byte and its
// new_seen bits, and its fresh flags (0x01 a byte).
__device__ __forceinline__ uint32_t finish(uint32_t cur, uint32_t ns,
                                           bool done, uint32_t& fresh) {
  const uint32_t seen = (cur >> 7) & kLsb;
  fresh = ns & ~seen;
  // Ages: +1, saturating at 15, on the seen bytes.
  const uint32_t age = cur & kAgeBits;
  const uint32_t inc = age + kLsb;
  const uint32_t aged_age = inc - ((inc >> 4) & kLsb);
  const uint32_t seen_m = seen * 0xFFu;
  const uint32_t aged = (seen_m & (kSeenBits | aged_age)) | (~seen_m & cur);
  const uint32_t fresh_m = fresh * 0xFFu;
  const uint32_t out = (fresh_m & kSeenBits) | (~fresh_m & aged);
  return done ? 0u : out;
}

// What one slot of a lane leaves besides its words: the witness (max(wit,
// lt) on the fresh columns: a column's witness starts at 0, so a slot of
// lt <= 0 leaves it; the fresh byte broadcast to a mask) and the lane's
// counts of fresh bytes and live holders (bytes of 0 or 1 summed over the
// words, then across the word by a multiply).
template <int L>
__device__ __forceinline__ void tally(Lane<L>& l, const uint32_t (&out)[kWords],
                                      const uint32_t (&fresh)[kWords], int lt,
                                      unsigned& n_fresh, unsigned& n_kept) {
  uint32_t f = 0u, h = 0u;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    f += fresh[k];
    h += (out[k] >> 7) & l.rx[k];
  }
  n_fresh = (f * kLsb) >> 24;
  n_kept = (h * kLsb) >> 24;
  if (lt > 0) {
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      if (fresh[k]) {
        const uint32_t m = fresh[k] * 0xFFu;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int w = static_cast<int>(__byte_perm(m, 0u, 0x1111u * b)) & lt;
          l.wit[4 * k + b] = max(l.wit[4 * k + b], w);
        }
      }
    }
  }
}

// One slot of a lane on the word path (kFast: the warp's words need no
// wrap at N and all lie in the row): every load of the slot first, then
// the shuffles, the rule and the stores.  Returns the new words and the
// fresh flags.
template <int F, bool PP, bool kFast>
__device__ __forceinline__ void word_slot(const uint8_t* __restrict__ row,
                                          uint8_t* __restrict__ orow,
                                          const Lane<PP ? F + 2 : F>& l,
                                          bool done, int N,
                                          uint32_t (&out)[kWords],
                                          uint32_t (&fresh)[kWords]) {
  constexpr int L = PP ? F + 2 : F;
  const bool lane31 = (threadIdx.x & 31u) == 31u;
  uint32_t cur[kWords];
  uint32_t x[L][kWords];
  uint32_t edge[L];
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    cur[k] = __ldg(reinterpret_cast<const uint32_t*>(
        row + word_off<kFast>(l.c0, k, N)));
  }
#pragma unroll
  for (int f = 0; f < L; ++f) {
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      x[f][k] = __ldg(reinterpret_cast<const uint32_t*>(
          row + word_off<kFast>(l.src[f], k, N)));
    }
    edge[f] = lane31 && l.sh[f]
                  ? __ldg(reinterpret_cast<const uint32_t*>(row + l.edge[f]))
                  : 0u;
  }
  uint32_t ns[kWords] = {};
#pragma unroll
  for (int f = 0; f < L; ++f) {
    uint32_t pin[kWords];
    join_window(x[f], edge[f], l.sh[f], lane31, pin);
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      ns[k] |= leg_bits<F>(f, pin[k], l.ok[f][k], l.bud);
    }
  }
#pragma unroll
  for (int k = 0; k < kWords; ++k) out[k] = finish(cur[k], ns[k], done, fresh[k]);
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    if (kFast || word_cols(l, k, N)) {
      *reinterpret_cast<uint32_t*>(orow + kStride * k) = out[k];
    }
  }
}

// One slot of a lane on the byte path.
template <int F, bool PP>
__device__ __forceinline__ void byte_slot(const uint8_t* __restrict__ row,
                                          uint8_t* __restrict__ orow,
                                          const Lane<PP ? F + 2 : F>& l,
                                          bool done, int N,
                                          uint32_t (&out)[kWords],
                                          uint32_t (&fresh)[kWords]) {
  constexpr int L = PP ? F + 2 : F;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const int n = word_cols(l, k, N);
    const uint32_t cur = n ? gather4(row, word_start(l.c0, k, N), n, N) : 0u;
    uint32_t ns = 0u;
#pragma unroll
    for (int f = 0; f < L; ++f) {
      const uint32_t pin =
          n ? gather4(row, word_start(l.src[f], k, N), n, N) : 0u;
      ns |= leg_bits<F>(f, pin, l.ok[f][k], l.bud);
    }
    out[k] = finish(cur, ns, done, fresh[k]);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (b < n) orow[kStride * k + b] = static_cast<uint8_t>(out[k] >> (8 * b));
    }
  }
}

enum Path { kBytePath, kWordWrap, kWordFast };

// A warp's slots of the block's group (slot warp, warp + kWarps, ..) on
// one path: each slot's words, then its witness and counts, the counts
// summed over the warp into the block's.
template <int F, bool PP, int kPath>
__device__ __forceinline__ void run_slots(
    const uint8_t* __restrict__ has, uint8_t* __restrict__ out_has,
    Lane<PP ? F + 2 : F>& l, const Slot* s_slot, uint32_t* s_cnt,
    uint32_t* s_hcnt, size_t row0, int rows, int warp, bool held, int N) {
#pragma unroll 1
  for (int i = warp; i < rows; i += kWarps) {
    const size_t roff = row0 + static_cast<size_t>(i) * N;
    const Slot sl = s_slot[i];
    uint32_t out[kWords], fresh[kWords];
    if (kPath == kBytePath) {
      byte_slot<F, PP>(has + roff, out_has + roff + l.c0, l, sl.done, N, out,
                       fresh);
    } else {
      word_slot<F, PP, kPath == kWordFast>(has + roff, out_has + roff + l.c0,
                                           l, sl.done, N, out, fresh);
    }
    unsigned n_fresh, n_kept;
    tally(l, out, fresh, sl.lt, n_fresh, n_kept);
    n_fresh = __reduce_add_sync(0xFFFFFFFFu, n_fresh);
    n_kept = held ? __reduce_add_sync(0xFFFFFFFFu, n_kept) : 0u;
    if ((threadIdx.x & 31u) == 0) {
      s_cnt[i] = n_fresh;
      s_hcnt[i] = n_kept;
    }
  }
}

template <int F, bool PP>
__global__ void __launch_bounds__(kThreads, PP ? kMinBlocksPP : kMinBlocks)
flood_kernel(const uint8_t* __restrict__ has, const uint8_t* __restrict__ alive,
             uint8_t* __restrict__ out_has, const __grid_constant__ Args a) {
  constexpr int L = PP ? F + 2 : F;
  const int N = a.N;
  const int tile = static_cast<int>(blockIdx.x);
  const int t = static_cast<int>(threadIdx.x);
  const int warp = t >> 5;
  const int lane = t & 31;
  const bool lane31 = lane == 31;
  const int rnd = __ldg(a.dargs);
  const int e0 = static_cast<int>(blockIdx.y) * a.rows;
  const int rows = min(a.rows, a.E - e0);
  const bool held = a.held != nullptr;
  uint32_t* wit_g = a.scratch;
  uint32_t* arrive = a.scratch + N;
  uint32_t* cnt = arrive + a.tiles;
  uint32_t* hcnt = cnt + kStripes * a.E;
  uint32_t* grid_arrive = hcnt + kStripes * a.E;

  // The group's slots, their counts (each slot's from the one warp that
  // runs it), and the tile's witness.
  __shared__ Slot s_slot[kMaxRows];
  __shared__ uint32_t s_cnt[kMaxRows];
  __shared__ uint32_t s_hcnt[kMaxRows];
  __shared__ int s_wit[kTile];
  __shared__ int s_last;
  for (int i = t; i < rows; i += kThreads) {
    s_slot[i].lt = __ldg(a.ltime + e0 + i);
    s_slot[i].done = slot_done(a, rnd, e0 + i);
  }
  for (int i = t; i < kTile; i += kThreads) s_wit[i] = 0;
  // The tile's clocks, read now so that the finish waits on no load (one
  // slot group: this block finishes them).
  const long long base = static_cast<long long>(tile) * kTile;
  int32_t nl[kTile / kThreads];
#pragma unroll
  for (int j = 0; j < kTile / kThreads; ++j) {
    const long long c = base + t + j * kThreads;
    nl[j] = a.groups == 1 && c < N ? a.node_ltime[c] : 0;
  }

  Lane<L> l;
  // Below 2**32: tile kTile < N + kTile.
  l.c0u = static_cast<uint32_t>(tile) * kTile + 4 * lane;
  l.c0 = static_cast<int>(l.c0u < static_cast<uint32_t>(N)
                              ? l.c0u
                              : l.c0u % static_cast<uint32_t>(N));
  l.bud = static_cast<uint32_t>(a.budget) * kLsb;
#pragma unroll
  for (int c = 0; c < kCols; ++c) l.wit[c] = 0;
#pragma unroll
  for (int f = 0; f < L; ++f) {
    int o = __ldg(a.dargs + 1 + f) % N;
    if (o < 0) o += N;
    int s = l.c0 - o;
    if (s < 0) s += N;
    l.src[f] = s;
  }
  const bool words = a.words_ok;
  if (words) {
    // The receivers, then each leg's live senders, as the slots' words.
    bool whole = l.c0u + kStride * (kWords - 1) < static_cast<uint32_t>(N);
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      l.rx[k] = word_cols(l, k, N)
                    ? __ldg(reinterpret_cast<const uint32_t*>(
                          alive + word_off<false>(l.c0, k, N))) & kLsb
                    : 0u;
    }
#pragma unroll
    for (int f = 0; f < L; ++f) {
      l.sh[f] = 8u * static_cast<uint32_t>(l.src[f] & 3);
      l.src[f] &= ~3;
      whole = whole && l.src[f] < N - kStride * (kWords - 1);
      l.edge[f] = (word_start(l.src[f], kWords - 1, N) + 4) % N;
      uint32_t x[kWords], pin[kWords];
#pragma unroll
      for (int k = 0; k < kWords; ++k) {
        x[k] = __ldg(reinterpret_cast<const uint32_t*>(
            alive + word_off<false>(l.src[f], k, N)));
      }
      const uint32_t edge =
          __ldg(reinterpret_cast<const uint32_t*>(alive + l.edge[f]));
      join_window(x, edge, l.sh[f], lane31, pin);
#pragma unroll
      for (int k = 0; k < kWords; ++k) l.ok[f][k] = pin[k] & l.rx[k];
    }
    l.fast = __all_sync(0xFFFFFFFFu, whole);
  } else {
    l.fast = false;
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const int n = word_cols(l, k, N);
      l.rx[k] = n ? gather4(alive, word_start(l.c0, k, N), n, N) & kLsb : 0u;
    }
#pragma unroll
    for (int f = 0; f < L; ++f) {
      l.sh[f] = 0u;
      l.edge[f] = 0;
#pragma unroll
      for (int k = 0; k < kWords; ++k) {
        const int n = word_cols(l, k, N);
        l.ok[f][k] =
            n ? gather4(alive, word_start(l.src[f], k, N), n, N) & l.rx[k]
              : 0u;
      }
    }
  }
  __syncthreads();

  // The slots, a slot an iteration of the warp, in one loop per path
  // (the word path's fast loop is what consul_tpu_torch/sass_count.py
  // --flood counts).
  const size_t row0 = static_cast<size_t>(e0) * static_cast<size_t>(N);
  if (!words) {
    run_slots<F, PP, kBytePath>(has, out_has, l, s_slot, s_cnt, s_hcnt, row0,
                                rows, warp, held, N);
  } else if (l.fast) {
    run_slots<F, PP, kWordFast>(has, out_has, l, s_slot, s_cnt, s_hcnt, row0,
                                rows, warp, held, N);
  } else {
    run_slots<F, PP, kWordWrap>(has, out_has, l, s_slot, s_cnt, s_hcnt, row0,
                                rows, warp, held, N);
  }

  // The lane's witness into the tile's (a lane past the row's end has
  // none).
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (l.wit[4 * k + b] > 0) {
        atomicMax(&s_wit[kStride * k + 4 * lane + b], l.wit[4 * k + b]);
      }
    }
  }
  __syncthreads();
  // The block's counts, one atomic a slot into the tile's stripe (they
  // wrap mod 2**32).
  const int stripe = (tile % kStripes) * a.E + e0;
  for (int i = t; i < rows; i += kThreads) {
    if (s_cnt[i]) atomicAdd(cnt + stripe + i, s_cnt[i]);
    if (held && s_hcnt[i]) atomicAdd(hcnt + stripe + i, s_hcnt[i]);
  }
  if (a.groups == 1) {
#pragma unroll
    for (int j = 0; j < kTile / kThreads; ++j) {
      const int lc = t + j * kThreads;
      if (base + lc < N) {
        a.out_node_ltime[base + lc] = witnessed(nl[j], s_wit[lc]);
      }
    }
  } else {
    for (int lc = t; lc < kTile; lc += kThreads) {
      if (base + lc < N && s_wit[lc] > 0) {
        atomicMax(reinterpret_cast<int*>(wit_g) + base + lc, s_wit[lc]);
      }
    }
    // Arrive at the tile (release: the block's counts and witness first);
    // its last slot group acquires every group's and finishes node_ltime.
    __syncthreads();
    if (t == 0) {
      s_last = add_release(arrive + tile) ==
               static_cast<unsigned>(a.groups - 1);
      if (s_last) fence_acquire();
    }
    __syncthreads();
    if (!s_last) return;
    for (int lc = t; lc < kTile; lc += kThreads) {
      if (base + lc < N) {
        const int c = static_cast<int>(base + lc);
        const int w = static_cast<int>(__ldcg(wit_g + c));
        wit_g[c] = 0u;
        a.out_node_ltime[c] = witnessed(a.node_ltime[c], w);
      }
    }
    if (t == 0) arrive[tile] = 0u;
  }

  // One block a tile arrives at the grid (release: with what it acquired
  // from its tile's other groups); the grid's last sums the stripes into
  // the counts and does the slot GC of the [E] registers.
  __syncthreads();
  if (t == 0) {
    s_last = add_release(grid_arrive) == static_cast<unsigned>(a.tiles - 1);
    if (s_last) fence_acquire();
  }
  __syncthreads();
  if (!s_last) return;
  for (int e = t; e < a.E; e += kThreads) {
    // Every stripe's counts loaded before any is used or zeroed.
    uint32_t cs[kStripes], hs[kStripes];
#pragma unroll
    for (int s = 0; s < kStripes; ++s) {
      cs[s] = __ldcg(cnt + s * a.E + e);
      hs[s] = held ? __ldcg(hcnt + s * a.E + e) : 0u;
    }
    uint32_t c = 0;
    uint32_t h = 0;
#pragma unroll
    for (int s = 0; s < kStripes; ++s) {
      c += cs[s];
      h += hs[s];
      cnt[s * a.E + e] = 0u;
      if (held) hcnt[s * a.E + e] = 0u;
    }
    a.out_n_seen[e] = a.n_seen[e] + c;  // wraps mod 2**32
    if (held) a.held[e] = h;
    const bool done = slot_done(a, rnd, e);
    a.out_used[e] = (__ldg(a.used + e) != 0 && !done) ? 1 : 0;
    a.out_origin[e] = done ? -1 : __ldg(a.origin + e);
  }
  if (t == 0) *grid_arrive = 0u;
}

template <int F>
int launch_f(const uint8_t* has, const uint8_t* alive, uint8_t* out_has,
             const Args& a, bool pushpull, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(a.tiles),
                  static_cast<unsigned>(a.groups));
  if (pushpull) {
    flood_kernel<F, true><<<grid, kThreads, 0, stream>>>(has, alive, out_has, a);
  } else {
    flood_kernel<F, false><<<grid, kThreads, 0, stream>>>(has, alive, out_has, a);
  }
  return static_cast<int>(cudaGetLastError());
}

inline bool aligned(const void* p, uintptr_t n) {
  return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0;
}

// Slots per slot group: all E (one group: no witness crosses blocks), at
// most kMaxRows, halved while the grid has fewer blocks than the card has
// SMs (a short row: the WAN pool's 12 nodes), but not below a slot a warp.
inline int pick_group_rows(int E, int tiles) {
  int rows = E < kMaxRows ? E : kMaxRows;
#ifdef EVFLOOD_HOST_GROUP_ROWS
  // The host build of the tests sets the groups itself (0: the rule).
  if (EVFLOOD_HOST_GROUP_ROWS > 0) {
    return EVFLOOD_HOST_GROUP_ROWS < rows ? EVFLOOD_HOST_GROUP_ROWS : rows;
  }
#endif
  while (rows > kWarps &&
         static_cast<long long>(tiles) * ((E + rows - 1) / rows) < kSMs) {
    rows = (rows + 1) / 2;
  }
  return rows;
}

}  // namespace evflood

// The scratch words event_flood needs at [E, N] (uint32, zero before the
// first launch; every launch leaves it zero).
extern "C" long long event_flood_scratch_words(int E, int N) {
  return evflood::scratch_words(E, N);
}

// One event round of has[E, N] (see the top of this file).  alive: one
// byte per node (a torch bool tensor); used: one byte per slot; ltime,
// origin, start: int32 [E]; node_ltime: int32 [N]; n_seen: uint32 [E],
// the counts before the round; out_*: the new has, used, origin,
// node_ltime and n_seen (out_has must not overlap has; out_node_ltime may
// be node_ltime and out_n_seen n_seen); held: nullptr, or uint32 [E] that
// receives each slot's alive holders after the round (the coverage's
// numerator); scratch: event_flood_scratch_words(E, N) uint32 words, 4-byte
// aligned, zero (and left zero; one launch at a time may use it); dargs:
// int32 [rnd, o_0 .. o_fanout-1, pp_o, -pp_o] in device memory, read when
// the kernel runs; fanout in [1, 8]; budget the spread budget (ages below
// it are sent), ttl the slots' TTL, pushpull nonzero on a push/pull round.
// Launches on `stream`, does not synchronise, returns cudaGetLastError()
// after the launch (or cudaErrorInvalidValue for arguments it does not
// take).
extern "C" int event_flood(const void* has, const void* alive,
                           const void* used, const void* ltime,
                           const void* origin, const void* start,
                           const void* node_ltime, const void* n_seen,
                           void* out_has, void* out_used, void* out_origin,
                           void* out_node_ltime, void* out_n_seen,
                           void* held, void* scratch, int E, int N,
                           int fanout, const void* dargs, int budget,
                           int ttl, int pushpull, void* stream) {
  using namespace evflood;
  const void* need[] = {has, alive, used, ltime, origin, start, node_ltime,
                        n_seen, out_has, out_used, out_origin,
                        out_node_ltime, out_n_seen, scratch, dargs};
  for (const void* p : need) {
    if (p == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (E < 1 || E > kMaxSlots || N < 1 || N > 2147483639 || fanout < 1 ||
      fanout > kMaxFanout || !aligned(scratch, 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{};
  a.used = static_cast<const uint8_t*>(used);
  a.ltime = static_cast<const int32_t*>(ltime);
  a.origin = static_cast<const int32_t*>(origin);
  a.start = static_cast<const int32_t*>(start);
  a.node_ltime = static_cast<const int32_t*>(node_ltime);
  a.n_seen = static_cast<const uint32_t*>(n_seen);
  a.out_used = static_cast<uint8_t*>(out_used);
  a.out_origin = static_cast<int32_t*>(out_origin);
  a.out_node_ltime = static_cast<int32_t*>(out_node_ltime);
  a.out_n_seen = static_cast<uint32_t*>(out_n_seen);
  a.held = static_cast<uint32_t*>(held);
  a.scratch = static_cast<uint32_t*>(scratch);
  a.dargs = static_cast<const int32_t*>(dargs);
  a.E = E;
  a.N = N;
  a.tiles = static_cast<int>((static_cast<long long>(N) + kTile - 1) / kTile);
  a.rows = pick_group_rows(E, a.tiles);
  a.groups = (E + a.rows - 1) / a.rows;
  a.budget = budget < 0 ? 0 : (budget > 16 ? 16 : budget);
  a.ttl = ttl;
  a.words_ok = N % 4 == 0 && aligned(has, 4) && aligned(out_has, 4) &&
               aligned(alive, 4);
  const auto* h = static_cast<const uint8_t*>(has);
  const auto* al = static_cast<const uint8_t*>(alive);
  auto* oh = static_cast<uint8_t*>(out_has);
  const bool pp = pushpull != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fanout) {
    case 1: return launch_f<1>(h, al, oh, a, pp, s);
    case 2: return launch_f<2>(h, al, oh, a, pp, s);
    case 3: return launch_f<3>(h, al, oh, a, pp, s);
    case 4: return launch_f<4>(h, al, oh, a, pp, s);
    case 5: return launch_f<5>(h, al, oh, a, pp, s);
    case 6: return launch_f<6>(h, al, oh, a, pp, s);
    case 7: return launch_f<7>(h, al, oh, a, pp, s);
    default: return launch_f<8>(h, al, oh, a, pp, s);
  }
}

extern "C" const char* event_flood_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
