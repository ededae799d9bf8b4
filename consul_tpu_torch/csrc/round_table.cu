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
// Bound: operations.  A round row hashes 3F + 2K + 26 times (41 at F = 3,
// K = 3), an event row 2F + 9 times; a hash is ~90 integer instructions
// (20 rounds of add, rotate and xor and five key injections, the count
// threefry.cu's SASS gives).  512 rows of the 1M path are ~2e6 integer
// operations, ~0.1 us at 67e12 / 4 a second, and 60 KB of writes: far below
// a launch, so this kernel is at a launch's floor.  One thread a row is
// enough: a row's stores are its own, strided by the row's width.

#include <cuda_runtime.h>

#include <cstdint>

#include "threefry.cuh"

namespace round_table {

constexpr int kMaxJobs = 16;       // tables a launch fills
constexpr int kThreads = 128;      // rows a block
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

// randint(k, (count,), 1, N) into out[0 .. count).
__device__ __forceinline__ void randint(Words k, int count, uint32_t span,
                                        uint32_t mult, int32_t* out) {
  const Words hi = fold(k, 0u), lo = fold(k, 1u);
  for (int i = 0; i < count; ++i) {
    const uint32_t h = threefry::hash(hi.x0, hi.x1, static_cast<uint32_t>(i));
    const uint32_t l = threefry::hash(lo.x0, lo.x1, static_cast<uint32_t>(i));
    const uint32_t off = (h % span) * mult + l % span;
    out[i] = static_cast<int32_t>(1u + off % span);
  }
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

// Row k of a round table (round_args._fill).
__device__ void round_row(const Job& j, int k, long long rnd, int32_t* row) {
  const int F = j.fanout, K = j.helpers;
  const Columns c = columns(F, K);
  const Words key = fold(Words{j.key[0], j.key[1]},
                         static_cast<uint32_t>(rnd));
  const Words k1 = fold(key, 1u);
  row[0] = static_cast<int32_t>(rnd);
  randint(fold(key, 2u), F, j.span, j.mult, row + 1);
  row[c.blk] = static_cast<int32_t>((rnd % j.probe_every) * j.block);
  long long slot = (j.cursor + k) % j.ring;
  row[c.flight] = static_cast<int32_t>(slot < 0 ? slot + j.ring : slot);
  randint(fold(k1, 0u), 1 + K, j.span, j.mult, row + c.probe);
  randint(fold(key, 3u), 1, j.span, j.mult, row + c.pp);
  row[c.pp + 1] = -row[c.pp];
  put_key(row, c.k_dl, fold(k1, 1u));
  put_key(row, c.k_hl, fold(k1, 3u));
  const Words k_h = fold(k1, 2u);
  for (int q = 0; q < 4; ++q) {
    put_key(row, c.k_nem + 2 * q, fold(k_h, static_cast<uint32_t>(q)));
  }
  const Words k_nem = fold(key, 4u);
  for (int f = 0; f < F; ++f) {
    put_key(row, c.k_legs + 2 * f, fold(k_nem, static_cast<uint32_t>(f)));
  }
  const Words k_pp = fold(key, 5u);
  for (int q = 0; q < 2; ++q) {
    put_key(row, c.k_pp + 2 * q, fold(k_pp, static_cast<uint32_t>(q)));
  }
}

// Row k of an event table (round_args._fill_events).
__device__ void event_row(const Job& j, long long rnd, int32_t* row) {
  const int F = j.fanout;
  const Words key = fold(fold(Words{j.key[0], j.key[1]}, 7u),
                         static_cast<uint32_t>(rnd));
  row[0] = static_cast<int32_t>(rnd);
  randint(key, F, j.span, j.mult, row + 1);
  randint(fold(key, 9u), 1, j.span, j.mult, row + 1 + F);
  row[2 + F] = -row[1 + F];
}

// The round's variant code (kernel.Variant.code): bit 0 push/pull, 1 in
// the fault window, 2 the prober block on the degraded observers, 3 the
// flapping nodes down.
__device__ __forceinline__ int variant_code(const Rule& v, int probe_every,
                                            int block, long long rnd) {
  int code = 0;
  if (v.pushpull_every > 0 &&
      rnd % v.pushpull_every == v.pushpull_every - 1) {
    code |= 1;
  }
  if (!v.nem || rnd < v.start || rnd >= v.stop) return code;
  code |= 2;
  const long long blk = (rnd % probe_every) * block;
  if (v.degraded && blk < v.obs_hi && blk + block > v.obs_lo) code |= 4;
  if (v.flap && (rnd - v.start) % v.flap_period >= v.flap_up) code |= 8;
  return code;
}

// blockIdx.y: the job; a thread a row.
__global__ void __launch_bounds__(kThreads) table_kernel(const Args a) {
  const Job& j = a.job[blockIdx.y];
  const int k = static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x);
  if (k == 0) {
    if (j.left != nullptr) *j.left = a.rows;
    if (j.step != nullptr) *j.step = 0;
  }
  if (k >= a.rows) return;
  const long long rnd = static_cast<long long>(j.rnd0) + k;
  int32_t* row = j.table + static_cast<long long>(k) * j.width;
  if (j.events) {
    event_row(j, rnd, row);
  } else {
    round_row(j, k, rnd, row);
  }
  if (j.variant != nullptr) {
    j.variant[k] = variant_code(j.rule, j.probe_every, j.block, rnd);
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
  const dim3 grid((a.rows + kThreads - 1) / kThreads + (a.rows == 0),
                  a.jobs);
  table_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* round_table_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
