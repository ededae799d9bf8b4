// The round program's argument table on the card, for Hopper (sm_90a): one
// kernel, table_kernel, and its C entry points.
//
// Replaces the host's build of a call's table (consul_tpu_torch/gossip/
// round_args.py: `build`, `build_events`, `build_pools`, numpy threefry over
// every round of a call, then one pinned copy to the card), which stands in
// for what the reference derives inside its jitted scan from the traced
// round counter (consul_tpu/gossip/kernel.py:1783, lax.scan's body: fold_in
// of the round, the sub-keys, the gossip shifts, the probe targets, the
// push/pull partner, the prober block).  Those host functions stay as the
// plain version; every word this kernel writes equals theirs.
//
// What it computes.  A launch fills the rows of up to kMaxJobs tables, one
// job a pool: row k of a job is round rnd0 + k, in the round's layout
// (round_args.layout: the round, the F gossip shifts, the prober block's
// first id, the flight-ring slot, the 1 + K probe targets, the push/pull
// shift and its negation, then every key as two words) or the event
// round's (round_args.event_layout: the round, the F shifts, the partner
// shift and its negation).  Keys are jax's partitionable threefry2x32
// (threefry.cuh): fold_in(k, d) and split(k)[d] both hash the counter
// (0, d) under k and keep both words; randint(k, (count,), 1, N) hashes
// counter i under split(k)'s two keys and reduces the two 32-bit streams by
// jax.random.randint's span and multiplier (computed on the host) in u32
// arithmetic.  A job may also get the round's variant code a row
// (kernel.Variant: push/pull, in the nemesis window, the prober block on
// the degraded observers, the flapping nodes down; the schedule's scalars
// by value, kernel.round_variant's rule), and may have the program's loop
// counters reset: its rounds left (the chunk's rows) and its row counter
// (0), written by the first thread of the job's first block.
//
// Bound: latency.  A round row hashes 3F + 2K + 26 times (41 at F = 3,
// K = 3), an event row 2F + 9 times; a hash is ~90 dependent integer
// instructions (20 rounds of add, rotate and xor and five key injections;
// threefry.cu's SASS counts 51 on the busiest unit).  512 rows of the 1M
// path are ~2e6 integer operations, ~0.1 us at 67e12 / 4 a second, and 60
// KB of writes: the work bound is far below a launch.  What a launch waits
// for is its longest chain of dependent hashes.  One thread a row (the
// first design) ran a row's 41 hashes in series: 0.006-0.008 ms a launch
// on an H100 SXM.
//
// Design.  A row's hashes are only five levels deep: the round's key; its
// five sub-keys (k1 and fold(key, 2..5)); the keys of the next level (k1's
// four folds, the randints' hi / lo keys, the legs' and the push/pull legs'
// keys); the probe randint's hi / lo keys with the gossip and partner
// elements and k_h's four folds; the probe elements.  So a row gets a
// group of lanes (a power of two from 8 to a warp, the widest level's
// items; kThreads / lanes rows a block), and each level's independent
// items go to the group's lanes, looping where F or K outnumber them.  An
// item is one key (a fold) or one randint element, whose two hashes (hi and
// lo) run on one lane side by side; every lane hashes the round key itself
// (level 0) and the keys a level needs reach its lanes by __shfl_sync from
// the lanes that made them, which are each lane's first item.  A lane
// stores what its items make.  The row's scalars and variant code (a few
// integer divisions, one of them 64-bit) are a warp of their own, a lane a
// row of the block, so that they run beside the hashes and not before
// them; the counters are the first thread's.  The critical path is five
// hash latencies and four shuffles a row.

#include <cuda_runtime.h>

#include <cstdint>

#include "threefry.cuh"

namespace round_table {

constexpr int kMaxJobs = 16;       // tables a launch fills
constexpr int kThreads = 128;      // a block's hashing threads: a row's
                                   // lanes each, 128 / lanes rows
constexpr int kBlock = kThreads + 32;  // and a warp for the rows' scalars
constexpr int kMaxRows = 1 << 20;  // rows a job
constexpr int kMaxFanout = 64;     // F, and K

// The variant rule's scalars (kernel.round_variant), by value.
struct Rule {
  int pushpull_every;  // 0: no push/pull round
  int nem;             // a nemesis schedule is given
  int start, stop;     // its fault window [start, stop)
  int degraded;        // the degraded observers [obs_lo, obs_hi)
  int obs_lo, obs_hi;
  int flap;            // the flapping nodes: up flap_up rounds a period
  int flap_period, flap_up;
};

// One table (gossip/round_table.py's _Job mirrors this layout).
struct Job {
  int32_t* table;     // [rows, width], row k for round rnd0 + k
  int32_t* variant;   // [rows]: each round's variant code (nullptr: none)
  int32_t* left;      // the loop's rounds left, set to rows (nullptr: none)
  long long* step;    // the program's row counter, set to 0 (nullptr)
  uint32_t key[2];    // the pool's base key
  int rnd0;
  int events;         // 0: the round's layout; 1: the event round's
  int fanout;         // F
  int helpers;        // K (the round's layout)
  int width;          // words a row: the layout's
  int probe_every;    // rounds a prober cycle
  int block;          // probers a round, B = ceil(N / probe_every)
  uint32_t span;      // randint(1, N)'s span and multiplier
  uint32_t mult;
  long long cursor;   // the flight ring's cursor at rnd0
  int ring;           // its rows (1: no ring)
  Rule rule;
};

struct Args {
  Job job[kMaxJobs];
  int jobs;
  int rows;
};

using threefry::Words;

__device__ __forceinline__ Words fold(Words k, uint32_t d) {
  return threefry::hash2(k.x0, k.x1, d);
}

__device__ __forceinline__ void put_key(int32_t* row, int at, Words k) {
  row[at] = static_cast<int32_t>(k.x0);
  row[at + 1] = static_cast<int32_t>(k.x1);
}

// Lane `src` of the caller's group of `width` lanes: its key.
__device__ __forceinline__ Words shfl(Words k, int src, int width) {
  const unsigned long long v =
      (static_cast<unsigned long long>(k.x1) << 32) | k.x0;
  const unsigned long long r = __shfl_sync(0xFFFFFFFFu, v, src, width);
  return Words{static_cast<uint32_t>(r), static_cast<uint32_t>(r >> 32)};
}

// An item's two hashes, side by side on one lane: threefry2x32 of counter
// cp under p and of cq under q (a key's fold and the next, or a randint
// element's hi and lo hashes).
struct Pair {
  Words x, y;
};

__device__ __forceinline__ Pair hash_pair(Words p, uint32_t cp, Words q,
                                          uint32_t cq) {
  return Pair{threefry::hash2(p.x0, p.x1, cp),
              threefry::hash2(q.x0, q.x1, cq)};
}

// A randint(k, (count,), 1, N) element from its pair (split(k)'s keys hi
// and lo, each hashing the element's counter): the two 32-bit draws
// reduced by jax.random.randint's span and multiplier in u32 arithmetic.
__device__ __forceinline__ int32_t randint_of(Pair h, uint32_t span,
                                              uint32_t mult) {
  const uint32_t hi = h.x.x0 ^ h.x.x1, lo = h.y.x0 ^ h.y.x1;
  const uint32_t off = (hi % span) * mult + lo % span;
  return static_cast<int32_t>(1u + off % span);
}

// The column offsets of the round's layout (round_args.layout).
struct Columns {
  int blk, flight, probe, pp, k_dl, k_hl, k_nem, k_legs, k_pp, width;
};

__host__ __device__ __forceinline__ Columns columns(int F, int K) {
  Columns c;
  c.blk = 1 + F;
  c.flight = c.blk + 1;
  c.probe = c.blk + 2;
  c.pp = c.probe + 1 + K;
  c.k_dl = c.pp + 2;
  c.k_hl = c.k_dl + 2;
  c.k_nem = c.k_dl + 4;
  c.k_legs = c.k_nem + 8;
  c.k_pp = c.k_legs + 2 * F;
  c.width = c.k_pp + 4;
  return c;
}

__host__ __device__ __forceinline__ int layout_width(int events, int F,
                                                     int K) {
  return events ? 3 + F : columns(F, K).width;
}

// The lanes of a row, as a power of two: 8 to a warp, at least the widest
// level's items (a round row's levels hold 5, 8 + F, 6 + F and 1 + K, an
// event row's 2, 1 + F and 1).
__host__ __device__ __forceinline__ int row_lanes_log2(int events, int F,
                                                       int K) {
  const int widest = events ? 1 + F : (8 + F > 1 + K ? 8 + F : 1 + K);
  return widest <= 8 ? 3 : widest <= 16 ? 4 : 5;
}

// Row k of a round table (round_args._fill), on lane `lane` of its group
// of G: every lane of the group calls this (the shuffles need them all);
// only a live row stores.
__device__ void round_row(const Job& j, int rnd, int32_t* row, int lane,
                          int G, bool live) {
  const int F = j.fanout, K = j.helpers;
  const Columns c = columns(F, K);
  const uint32_t span = j.span, mult = j.mult;
  // Level 0, on every lane: the round's key.
  const Words key = fold(Words{j.key[0], j.key[1]},
                         static_cast<uint32_t>(rnd));
  // Level 1: lane q < 5 folds in q + 1 (k1, the gossip targets' key, the
  // push/pull partner's, the legs', the push/pull legs').
  Words a = fold(key, static_cast<uint32_t>(lane + 1)), b = a;
  const Words k1 = shfl(a, 0, G), k_tg = shfl(a, 1, G), k_pt = shfl(a, 2, G),
              k_legs = shfl(a, 3, G), k_pp = shfl(a, 4, G);
  // Level 2, item i: fold(k1, i) for i < 4 (the probe randint's key, k_dl,
  // k_h, k_hl); the gossip (4) and partner (5) randints' hi and lo keys;
  // the push/pull legs' two keys (6, 7); the legs' F keys (8 + f).  Every
  // item is a key and its neighbour, so the lanes do not diverge.
  for (int i = lane; i < 8 + F; i += G) {
    Words p = k1;
    uint32_t d = static_cast<uint32_t>(i);
    if (i == 4) p = k_tg;
    if (i == 5) p = k_pt;
    if (i == 4 || i == 5) d = 0u;
    if (i == 6 || i == 7) p = k_pp, d = static_cast<uint32_t>(i - 6);
    if (i >= 8) p = k_legs, d = static_cast<uint32_t>(i - 8);
    const Pair h = hash_pair(p, d, p, d + 1u);
    if (i == lane) a = h.x, b = h.y;
    if (!live) continue;
    if (i == 1) put_key(row, c.k_dl, h.x);
    if (i == 3) put_key(row, c.k_hl, h.x);
    if (i == 6 || i == 7) put_key(row, c.k_pp + 2 * (i - 6), h.x);
    if (i >= 8) put_key(row, c.k_legs + 2 * (i - 8), h.x);
  }
  const Words k_pr = shfl(a, 0, G), k_h = shfl(a, 2, G);
  const Words g_hi = shfl(a, 4, G), g_lo = shfl(b, 4, G);
  const Words p_hi = shfl(a, 5, G), p_lo = shfl(b, 5, G);
  // Level 3, item i: k_h's four folds (i < 4); the probe randint's hi and
  // lo keys (4); the partner's element (5); the F gossip elements (6 + f).
  // A key item hashes (key, d) and (key, d + 1), an element (hi, e) and
  // (lo, e): one pair of hashes either way.
  for (int i = lane; i < 6 + F; i += G) {
    Words p = g_hi, q = g_lo;
    uint32_t d = static_cast<uint32_t>(i - 6), e = d;
    if (i < 5) {
      p = q = i < 4 ? k_h : k_pr;
      d = i < 4 ? static_cast<uint32_t>(i) : 0u;
      e = d + 1u;
    }
    if (i == 5) p = p_hi, q = p_lo, d = e = 0u;
    const Pair h = hash_pair(p, d, q, e);
    if (i == lane) a = h.x, b = h.y;
    if (!live) continue;
    if (i < 4) put_key(row, c.k_nem + 2 * i, h.x);
    if (i == 5) {
      const int32_t v = randint_of(h, span, mult);
      row[c.pp] = v;
      row[c.pp + 1] = -v;
    }
    if (i >= 6) row[1 + i - 6] = randint_of(h, span, mult);
  }
  const Words r_hi = shfl(a, 4, G), r_lo = shfl(b, 4, G);
  // Level 4: the 1 + K probe targets.
  for (int i = lane; i < 1 + K; i += G) {
    const uint32_t e = static_cast<uint32_t>(i);
    const int32_t v = randint_of(hash_pair(r_hi, e, r_lo, e), span, mult);
    if (live) row[c.probe + i] = v;
  }
}

// Row k of an event table (round_args._fill_events), on lane `lane` of its
// group of G, as round_row.
__device__ void event_row(const Job& j, int rnd, int32_t* row, int lane,
                          int G, bool live) {
  const int F = j.fanout;
  const uint32_t span = j.span, mult = j.mult;
  // Level 0, on every lane: the event round's key.
  const Words key = fold(fold(Words{j.key[0], j.key[1]}, 7u),
                         static_cast<uint32_t>(rnd));
  // Level 1: the gossip randint's hi and lo keys (lane 0), the partner
  // randint's key (lane 1).
  const uint32_t d1 = lane == 0 ? 0u : 9u;
  const Pair k = hash_pair(key, d1, key, d1 + 1u);
  Words a = k.x, b = k.y;
  const Words e_hi = shfl(a, 0, G), e_lo = shfl(b, 0, G),
              k9 = shfl(a, 1, G);
  // Level 2: the partner randint's hi and lo keys (0), the F gossip
  // elements (1 + f).
  for (int i = lane; i < 1 + F; i += G) {
    const bool keys = i == 0;
    const uint32_t e = static_cast<uint32_t>(i - 1);
    const Pair h = hash_pair(keys ? k9 : e_hi, keys ? 0u : e,
                             keys ? k9 : e_lo, keys ? 1u : e);
    if (i == lane) a = h.x, b = h.y;
    if (live && i > 0) row[i] = randint_of(h, span, mult);
  }
  const Words p_hi = shfl(a, 0, G), p_lo = shfl(b, 0, G);
  // Level 3: the partner's element.
  if (live && lane == 0) {
    const int32_t v = randint_of(hash_pair(p_hi, 0u, p_lo, 0u), span, mult);
    row[1 + F] = v;
    row[2 + F] = -v;
  }
}

// The round's variant code (kernel.Variant.code): bit 0 push/pull, 1 in
// the fault window, 2 the prober block on the degraded observers, 3 the
// flapping nodes down.  rnd is below 2**31 (the host checks), so every
// division is a 32-bit one.
__device__ __forceinline__ int variant_code(const Rule& v, int probe_every,
                                            int block, int rnd) {
  int code = 0;
  if (v.pushpull_every > 0 &&
      rnd % v.pushpull_every == v.pushpull_every - 1) {
    code |= 1;
  }
  if (!v.nem || rnd < v.start || rnd >= v.stop) return code;
  code |= 2;
  const long long blk =
      static_cast<long long>(rnd % probe_every) * block;
  if (v.degraded && blk < v.obs_hi && blk + block > v.obs_lo) code |= 4;
  if (v.flap && (rnd - v.start) % v.flap_period >= v.flap_up) code |= 8;
  return code;
}

// blockIdx.y: the job.  The first kThreads threads hash, a group of
// 2**row_lanes_log2 lanes a row, kThreads / lanes rows a block; the last
// warp stores the block's rows' scalars and variant codes, a lane a row,
// while the others hash (their divisions take no part in the hashes'
// chain).  A block past the job's rows leaves at once; the groups of a
// block that holds a row run whole (their shuffles take every lane).
__global__ void __launch_bounds__(kBlock) table_kernel(const Args a) {
  const Job& j = a.job[blockIdx.y];
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    if (j.left != nullptr) *j.left = a.rows;
    if (j.step != nullptr) *j.step = 0;
  }
  const int lg = row_lanes_log2(j.events, j.fanout, j.helpers);
  const int first = static_cast<int>(blockIdx.x) * (kThreads >> lg);
  if (first >= a.rows) return;
  const int t = static_cast<int>(threadIdx.x);
  if (t >= kThreads) {
    const int k = first + t - kThreads;
    if (t - kThreads >= (kThreads >> lg) || k >= a.rows) return;
    const int rnd = j.rnd0 + k;
    int32_t* row = j.table + static_cast<long long>(k) * j.width;
    row[0] = rnd;
    if (!j.events) {
      const Columns c = columns(j.fanout, j.helpers);
      row[c.blk] = static_cast<int32_t>(
          static_cast<long long>(rnd % j.probe_every) * j.block);
      const long long slot = (j.cursor + k) % j.ring;
      row[c.flight] = static_cast<int32_t>(slot < 0 ? slot + j.ring : slot);
    }
    if (j.variant != nullptr) {
      j.variant[k] = variant_code(j.rule, j.probe_every, j.block, rnd);
    }
    return;
  }
  const int k = first + (t >> lg);
  const int lane = t & ((1 << lg) - 1);
  const bool live = k < a.rows;
  const int rnd = j.rnd0 + k;
  int32_t* row = j.table + static_cast<long long>(k) * j.width;
  if (j.events) {
    event_row(j, rnd, row, lane, 1 << lg, live);
  } else {
    round_row(j, rnd, row, lane, 1 << lg, live);
  }
}

inline bool valid(const Job& j, int rows) {
  if (j.table == nullptr || j.fanout < 1 || j.fanout > kMaxFanout) {
    return false;
  }
  if (!j.events && (j.helpers < 0 || j.helpers > kMaxFanout)) return false;
  if (j.width != layout_width(j.events, j.fanout, j.helpers)) return false;
  if (j.probe_every < 1 || j.block < 1 || j.span < 1 || j.ring < 1) {
    return false;
  }
  if (j.rnd0 < 0 || static_cast<long long>(j.rnd0) + rows - 1 > 2147483647LL) {
    return false;
  }
  const Rule& v = j.rule;
  if (v.pushpull_every < 0 || (v.nem && v.flap && v.flap_period < 1)) {
    return false;
  }
  return true;
}

}  // namespace round_table

// Fills the rows 0 .. rows - 1 of every job's table (a round_table::Args,
// copied into the launch's parameters), its variant column where given,
// and sets its loop counters where given; with rows = 0 only the counters.
// One launch on `stream`; returns the CUDA error (invalid value for a job
// the kernel cannot fill).
extern "C" int round_table_fill(const void* args, void* stream) {
  using namespace round_table;
  if (args == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Args& a = *static_cast<const Args*>(args);
  if (a.jobs < 1 || a.jobs > kMaxJobs || a.rows < 0 || a.rows > kMaxRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int q = 0; q < a.jobs; ++q) {
    if (!valid(a.job[q], a.rows)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  // The grid takes the widest job's rows a block; a block past a job's rows
  // leaves.  512 rows of 16 jobs at F = K = 3 (16 lanes a row) are 1,024
  // blocks of 160 threads: one wave.
  int lg = 3;
  for (int q = 0; q < a.jobs; ++q) {
    const Job& j = a.job[q];
    const int g = row_lanes_log2(j.events, j.fanout, j.helpers);
    lg = g > lg ? g : lg;
  }
  const int per = kThreads >> lg;
  const dim3 grid((a.rows + per - 1) / per + (a.rows == 0), a.jobs);
  table_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* round_table_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
