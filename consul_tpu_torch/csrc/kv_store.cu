// The two device steps of the port's device-resident state store, for
// Hopper (sm_90a), behind a plain C interface
// (consul_tpu_torch/state/device_store.py: wrappers kv_apply and
// watch_match, plain versions apply_ref and match_ref).
//
// All u32 fields (fingerprints, indexes, digest, flags, the full count)
// travel in int32 tensors holding the same bits and are read as uint32
// here: the index gate of the matcher is an unsigned compare, every index
// wraps mod 2^32 as the reference's uint32 arrays do, and window distances
// are taken on masked u32 starts.
//
// kv_apply replaces the XLA scan consul_tpu/state/device_store.py::
// _build_apply (its `step`): one committed batch of ops applied, in batch
// order, to an open-addressed key-hash table.  The table is [capacity, 8]
// 32-bit words, one 32-byte row per slot: state (0 empty, 1 live, 2
// tombstone), fp1, fp2, modify, create, digest, flags, a zero pad word.
// An op is one [8]-word row: opc (0 set, 1 del, anything else a pad that
// only reads), h1, h2, index, digest, flags, two zero words.
//
// Bound of kv_apply: bytes.  An op reads its six fields (24 bytes), the
// state and fingerprints of its window's slots (12 bytes a slot) and the
// modify index where it finds its key, and writes 5 bytes of verdicts and
// the words it changes: under 1 MB for 4,096 ops, a fraction of a
// microsecond at 3.35 TB/s (chip_smoke.py's _store_bound counts a batch
// exactly).  What held it back in PR 7: one warp walked the whole batch in
// order, one L2 round trip, eight shuffles, two ballots and a warp barrier
// an op (279 ns an op on an H100), while 131 SMs sat idle.  Yet most ops
// of a batch touch disjoint windows.
//
// The design: independent blocks over stretches of the ring, each running
// its ops in levels.  Op j depends on an earlier op i when their probe
// windows [h1 & mask, +probe) meet on the ring of `capacity` slots and at
// least one of the two is a set or a delete (both count as writers,
// whatever the data; two readers never depend on each other).
// - Window starts fall into hash buckets of 2^bucket_log2 >= probe slots
//   (the ring's buckets mod `buckets`, twice the ops): a window reaches
//   only its own bucket and the two beside it, so no dependence crosses a
//   bucket that holds no op's start.  Every block reads every op's start,
//   marks the buckets that hold one, and cuts the ring at the first empty
//   bucket at or after each of gridDim.x evenly spaced points: block k
//   takes the ops between its two cuts, and no op of another block depends
//   on them.  So the blocks never wait for one another, and a launch is
//   one kernel with no order among its blocks.
// - A block takes its ops in batch order (a ballot compaction a warp).
//   Consecutive readers at one start form a run: nothing runs between
//   them and they write nothing, so the first (the head) stands for the
//   run and the others take its level.
// - Levels of the heads, by warp 0, 32 heads at a time: a pass over the
//   heads before them (their levels are final), then a mask of the lanes
//   each lane depends on and, in order, a shuffle of the level of each
//   lane some lane depends on.  An op's level is 1 + the largest level of
//   the ops it depends on, so the ops of one level touch disjoint
//   writable slots.
// - The levels in order, a thread an op: the op's fields from shared
//   memory, its window's 16-byte slot heads (state, fp1, fp2, modify)
//   loaded at once, the first match and the first empty slot found in
//   order (jnp.argmax of an all-false mask is 0: slot 0 of the window),
//   then existed / old_index, the seven written fields, the kept create
//   and flags, as the reference's step.  A __syncthreads() between two
//   levels makes one level's stores visible to the next one's loads.
// - `full` is a sum: a block adds its count once, atomically, u32 wrap.
// A block with more than kLocalMax heads or kMaxLevels levels (the
// extreme: 4,096 writes to one key), a table under two windows (every
// pair of windows meets) and a single op: warp 0 walks the ops in order,
// one at a time, lane j < probe loading slot h1 + j, two ballots and
// __ffs for the first match and empty slot, __syncwarp() between ops, as
// the kernel of PR 7 did.  The same kernel on the same exact path, not
// the plain version.  Batches over kApplyChunk ops: a launch a chunk, in
// order on the stream.
//
// watch_match replaces consul_tpu/state/device_store.py::_build_match:
// the standing watch set evaluated against the batch's mutation events,
// ORed over the events and packed into 32-bit words.  A KV event fires a
// KEY or PREFIX watch whose length is at most the event path's and whose
// hashes equal the path's prefix hashes at that length (column clip(len,
// 0, lmax) of the event's [lmax + 1] row); a TABLE event fires a TABLE
// watch with the same hashes; either only for a live watch (kind >= 0)
// and an event index above the watch's min index (unsigned).
//
// Bound of watch_match: operations, a chain of compares and an OR per
// (watch, event) pair in the branch the event's kind selects (5 for a KV
// event, 4 for a TABLE event; chip_smoke.py's _match_bound), against ~21
// bytes read or written per watch.  What held it back in PR 7: a thread a
// watch over all B events made 5-7 loads through __ldg a pair and
// evaluated both kinds' conditions, and at W = 65,536 the launch filled a
// quarter of the card.
//
// The design: a block takes a tile of 1,024 watches, four a thread in
// registers (each warp's ballot over one of them is one packed word), and
// a range of the events, staged through shared memory in chunks of up to
// 64: the event rows and the chunk's slice of the prefix hashes, the two
// hashes of a column interleaved so that one 64-bit shared load serves a
// (watch, KV event) pair, each watch's column kept as a byte offset.  Each
// warp ballots the chunk's kinds into a KV mask and a TABLE mask and runs
// two loops over their set bits, without a branch a pair: the KV loop (two
// events an iteration) makes the length compare, the two hash compares and
// the unsigned index compare against each of its four watches; the TABLE
// loop the two hash compares and the index compare.  Pad events are in
// neither.  Every pair of the event's branch is evaluated, whatever fired
// before.  Where there are fewer watch tiles than the card holds blocks
// (W = 65,536: 64 tiles), the events are split over blockIdx.y, each warp
// ORs its nonzero words into `packed` with atomicOr (zeroed first by a
// memset in the same stream), and a short second launch derives the fired
// bytes from `packed`.  An lmax whose chunk of one event does not fit in
// 48 KB of shared memory reads the prefix hashes from global memory
// instead.  Blocks of one launch share nothing but `packed`'s atomics.
//
// Each entry point launches on `stream`, does not synchronise, allocates
// nothing, and returns cudaGetLastError() after its launches;
// kv_store_error() names a code.

#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

// The dynamic shared memory of both kernels.
extern __shared__ __align__(16) unsigned char kv_smem[];

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kSlotCols = 8;   // state fp1 fp2 modify create digest flags pad
constexpr int kOpCols = 8;     // opc h1 h2 index digest flags pad pad
constexpr int kWarp = 32;

constexpr uint32_t kSlotEmpty = 0;
constexpr uint32_t kSlotLive = 1;
constexpr uint32_t kSlotTomb = 2;
constexpr int kOpSet = 0;
constexpr int kOpDel = 1;
constexpr int kEvKv = 0;
constexpr int kEvTable = 1;
constexpr int kKindTable = 2;

// kv_apply.
constexpr int kApplyChunk = 4096;   // ops a launch (the bridge's max_batch)
constexpr int kApplyThreads = 256;
constexpr int kApplyBlocks = 128;   // blocks a launch, at most
constexpr int kOpsPerBlock = 32;    // ops a block on average, at least
constexpr int kMaxBuckets = 8192;   // hash buckets of window starts
constexpr int kLocalMax = 256;      // run heads a block schedules, at most
constexpr int kMaxLevels = 32;      // levels a block runs, at most
constexpr int kWindowLoads = 16;    // window slots a thread loads at once

// watch_match.
constexpr int kMatchThreads = 256;
constexpr int kMatchPer = 4;        // watches a thread
constexpr int kMatchTile = kMatchThreads * kMatchPer;
constexpr int kEvChunk = 64;        // events staged at once
constexpr int kMinEvents = 16;      // events a block at least, when split
constexpr int kMatchBlocks = 132 * 8;  // blocks the card holds at once
constexpr int kMatchSmemWords = 48 * 1024 / 4;
constexpr int kFiredThreads = 256;

struct ApplyArgs {
  uint32_t* tab;          // [capacity, kSlotCols]
  uint32_t* full;         // [1]
  const uint32_t* ops;    // [n_ops, kOpCols]
  uint8_t* existed;       // [n_ops]
  uint32_t* old_index;    // [n_ops]
  int* stats;             // [8] or null (kv_apply's comment)
  int c0;                 // the chunk's first op
  int n;                  // the chunk's ops
  uint32_t cap_mask;
  int probe;
  int bucket_log2;        // a bucket's slots: probe rounded up to a 2^k
  int buckets;            // hash buckets: a power of two
  int walk;               // block 0 walks the chunk in order
};

// The apply kernel's dynamic shared memory for a chunk of n ops.
struct ApplySmem {
  uint32_t* key;       // [n] the block's ops' window starts << 1 | writer
  uint32_t* field;     // [6][n] their opc, h1, h2, index, digest, flags
  uint32_t* occupied;  // [buckets / 32 + 1] bit b: some op's bucket is b
  uint32_t* hkey;      // [kLocalMax] the run heads' keys
  uint16_t* bucket;    // [n] each op's hash bucket
  uint16_t* lop;       // [n] the block's ops (chunk indexes), batch order
  uint16_t* lev;       // [n] their levels (their heads' ranks first)
  uint16_t* hlev;      // [kLocalMax] the heads' levels

  __host__ __device__ static size_t bytes(int n, int buckets) {
    return static_cast<size_t>(n) * (4 + 6 * 4 + 2 + 2 + 2) +
           4 * (static_cast<size_t>(buckets) / 32 + 1) + kLocalMax * (4 + 2);
  }
  __device__ ApplySmem(unsigned char* p, int n, int buckets) {
    key = reinterpret_cast<uint32_t*>(p);
    field = key + n;
    occupied = field + 6 * static_cast<size_t>(n);
    hkey = occupied + buckets / 32 + 1;
    bucket = reinterpret_cast<uint16_t*>(hkey + kLocalMax);
    lop = bucket + n;
    lev = lop + n;
    hlev = lev + n;
  }
};

__device__ __forceinline__ bool is_writer(int opc) {
  return opc == kOpSet || opc == kOpDel;
}

// Whether ops with keys ki and kj (window start << 1 | writer) depend on
// one another: one of the two writes and their windows meet on the ring.
__device__ __forceinline__ uint32_t depends(uint32_t ki, uint32_t kj,
                                           uint32_t mask, uint32_t probe) {
  const uint32_t si = ki >> 1, sj = kj >> 1;
  return (ki | kj) & 1u &
         (static_cast<uint32_t>(((si - sj) & mask) < probe) |
          static_cast<uint32_t>(((sj - si) & mask) < probe));
}

// An op's six fields: opc, h1, h2, index, digest, flags.
struct Op {
  uint32_t f[6];
};

__device__ __forceinline__ Op load_op(const uint32_t* ops, int i) {
  const uint32_t* row = ops + static_cast<size_t>(i) * kOpCols;
  Op op;
#pragma unroll
  for (int c = 0; c < 6; ++c) op.f[c] = __ldg(row + c);
  return op;
}

// One op's decision and writes in the warp walk, given its window as
// loaded by the warp's lanes (lane r < probe holds slot (h1 + r) & mask;
// the others are out of the window and ballot false).  Every lane calls
// this together; lane 0 writes.
__device__ __forceinline__ void apply_op(const ApplyArgs& a, int i,
                                         const Op& op, bool in_window,
                                         uint32_t st, uint32_t fp1,
                                         uint32_t fp2, uint32_t modify,
                                         uint32_t& n_full) {
  const int opc = static_cast<int>(op.f[0]);
  const uint32_t h1 = op.f[1], h2 = op.f[2];
  const unsigned match = __ballot_sync(
      kFullMask, in_window && st != kSlotEmpty && fp1 == h1 && fp2 == h2);
  const unsigned empty =
      __ballot_sync(kFullMask, in_window && st == kSlotEmpty);
  // jnp.argmax of an all-false mask is 0: lane 0 stands in.
  const int first = match ? __ffs(match) - 1 : 0;
  const int t = match ? first : (empty ? __ffs(empty) - 1 : 0);
  const uint32_t st_first = __shfl_sync(kFullMask, st, first);
  const uint32_t modify_first = __shfl_sync(kFullMask, modify, first);
  if ((threadIdx.x & (kWarp - 1)) == 0) {
    const bool any_match = match != 0;
    const bool window_ok = any_match || empty != 0;
    const bool existed = any_match && st_first == kSlotLive;
    const bool is_set = opc == kOpSet;
    const bool is_del = opc == kOpDel;
    a.existed[i] = existed ? 1 : 0;
    a.old_index[i] = existed ? modify_first : 0u;
    if ((is_set && window_ok) || (is_del && existed)) {
      uint32_t* row =
          a.tab + static_cast<size_t>((h1 + t) & a.cap_mask) * kSlotCols;
      const uint32_t index = op.f[3];
      row[0] = is_set ? kSlotLive : kSlotTomb;
      row[1] = h1;
      row[2] = h2;
      row[3] = index;
      // A live key keeps its create index; an empty or tombstoned slot is
      // created at this index.  A delete keeps the flags.
      if (is_set && !existed) row[4] = index;
      row[5] = is_set ? op.f[4] : 0u;
      if (is_set) row[6] = op.f[5];
    }
    if (is_set && !window_ok) ++n_full;
  }
}

// Ops c0 + list[0, n) (list null: c0 + [0, n)) in order by warp 0 (lane j
// < probe loads slot h1 + j; the next 32 ops' fields are loaded ahead, one
// a lane, and passed by __shfl_sync; __syncwarp() orders an op's stores
// before the next op's loads).
__device__ void walk_in_order(const ApplyArgs& a, const uint16_t* list,
                              int n, uint32_t& n_full) {
  const int lane = static_cast<int>(threadIdx.x);
  const bool in_window = lane < a.probe;
  for (int base = 0; base < n; base += kWarp) {
    const int mine_i = base + lane < n
                           ? a.c0 + (list ? list[base + lane] : base + lane)
                           : 0;
    Op mine{};
    if (base + lane < n) mine = load_op(a.ops, mine_i);
    const int todo = min(kWarp, n - base);
    for (int k = 0; k < todo; ++k) {
      Op op;
#pragma unroll
      for (int c = 0; c < 6; ++c) op.f[c] = __shfl_sync(kFullMask, mine.f[c], k);
      const int i = __shfl_sync(kFullMask, mine_i, k);
      const uint32_t h1 = op.f[1];
      uint32_t st = kSlotEmpty, fp1 = 0, fp2 = 0, modify = 0;
      if (in_window) {
        const uint32_t* row =
            a.tab + static_cast<size_t>((h1 + lane) & a.cap_mask) * kSlotCols;
        st = row[0];
        fp1 = row[1];
        fp2 = row[2];
        modify = row[3];
      }
      apply_op(a, i, op, in_window, st, fp1, fp2, modify, n_full);
      __syncwarp();
    }
  }
}

// The block's op j (batch op c0 + sm.lop[j]) by one thread, alone, its
// fields from shared memory: kWindowLoads slots' 16-byte heads (state,
// fp1, fp2, modify) loaded at once, the first match and the first empty
// slot found in order, then the decision and the writes of apply_op.
__device__ void run_op(const ApplyArgs& a, const uint32_t* field, int n,
                       int j, int i, uint32_t& n_full) {
  const int opc = static_cast<int>(field[j]);
  const uint32_t h1 = field[n + j], h2 = field[2 * n + j];
  const bool is_set = opc == kOpSet;
  const bool is_del = opc == kOpDel;
  int first_match = -1, first_empty = -1;
  uint32_t st_match = 0, modify_match = 0;
  for (int r0 = 0; r0 < a.probe; r0 += kWindowLoads) {
    uint4 head[kWindowLoads];
#pragma unroll
    for (int q = 0; q < kWindowLoads; ++q)
      if (r0 + q < a.probe)
        head[q] = *reinterpret_cast<const uint4*>(
            a.tab + static_cast<size_t>((h1 + r0 + q) & a.cap_mask) *
                        kSlotCols);
#pragma unroll
    for (int q = 0; q < kWindowLoads; ++q) {
      if (r0 + q >= a.probe) break;
      const bool empty = head[q].x == kSlotEmpty;
      if (first_empty < 0 && empty) first_empty = r0 + q;
      if (first_match < 0 && !empty && head[q].y == h1 && head[q].z == h2) {
        first_match = r0 + q;
        st_match = head[q].x;
        modify_match = head[q].w;
      }
    }
  }
  // jnp.argmax of an all-false mask is 0: slot 0 of the window.
  const bool any_match = first_match >= 0;
  const bool window_ok = any_match || first_empty >= 0;
  const bool existed = any_match && st_match == kSlotLive;
  const int t = any_match ? first_match : (first_empty >= 0 ? first_empty : 0);
  a.existed[i] = existed ? 1 : 0;
  a.old_index[i] = existed ? modify_match : 0u;
  if ((is_set && window_ok) || (is_del && existed)) {
    uint32_t* row =
        a.tab + static_cast<size_t>((h1 + t) & a.cap_mask) * kSlotCols;
    const uint32_t index = field[3 * n + j];
    row[0] = is_set ? kSlotLive : kSlotTomb;
    row[1] = h1;
    row[2] = h2;
    row[3] = index;
    // A live key keeps its create index; an empty or tombstoned slot is
    // created at this index.  A delete keeps the flags.
    if (is_set && !existed) row[4] = index;
    row[5] = is_set ? field[4 * n + j] : 0u;
    if (is_set) row[6] = field[5 * n + j];
  }
  if (is_set && !window_ok) ++n_full;
}

// Thread 0 adds the clock since the last lap to phase `phase` of
// clocks[0, 4) (clocks[4] holds the last lap's clock).
__device__ __forceinline__ void lap(long long* clocks, int phase) {
  if (threadIdx.x == 0) {
    const long long now = clock64();
    clocks[phase] += now - clocks[4];
    clocks[4] = now;
  }
}

// The first bucket at or after x (0 <= x <= buckets) that no op's window
// starts in, or `buckets`: warp 0's ballots over the occupancy words.
__device__ int first_empty(const uint32_t* occupied, int buckets, int x) {
  const int lane = static_cast<int>(threadIdx.x) & (kWarp - 1);
  const int words = (buckets + 31) / 32;
  const uint32_t last = buckets % 32 ? (1u << (buckets % 32)) - 1 : ~0u;
  for (int w0 = x / 32; w0 < words; w0 += kWarp) {
    const int w = w0 + lane;
    uint32_t free_bits = 0;
    if (w < words) {
      free_bits = ~occupied[w];
      if (w == words - 1) free_bits &= last;
      if (w == x / 32) free_bits &= ~0u << (x % 32);
    }
    const unsigned any = __ballot_sync(kFullMask, free_bits != 0);
    if (any) {
      const int l = __ffs(any) - 1;
      const uint32_t bits = __shfl_sync(kFullMask, free_bits, l);
      return (w0 + l) * 32 + __ffs(bits) - 1;
    }
  }
  return buckets;
}

// A block of a kv_apply launch: one stretch of the ring of window starts,
// cut where a bucket holds no op's start (a bucket is at least a probe
// wide, so no window reaches across an empty one), so the blocks' ops
// never depend on one another's.  The block takes its ops in batch order;
// consecutive readers at one start form a run, whose first op (the head)
// stands for it (nothing runs between them, and they write nothing); the
// heads' levels come 32 at a time, by a pass over the heads before them
// and a shuffle pass within their warp; then the levels run in order, a
// thread an op, a __syncthreads() between two levels.  A block with more
// than kLocalMax heads or kMaxLevels levels walks its ops in order.
__global__ void __launch_bounds__(kApplyThreads) apply_kernel(ApplyArgs a) {
  __shared__ uint32_t tot[kWarp];  // a count a warp
  __shared__ int s_lo, s_hi, s_first, s_depth;
  __shared__ uint32_t s_full;
  __shared__ long long clocks[5];
  const int tid = static_cast<int>(threadIdx.x);
  const int T = static_cast<int>(blockDim.x);
  const int lane = tid & (kWarp - 1);
  const int n = a.n, M = a.buckets;
  const int K = static_cast<int>(gridDim.x), k = static_cast<int>(blockIdx.x);
  const ApplySmem sm(kv_smem, n, M);
  uint32_t n_full = 0;
  int m = 0, heads = 0, walked = 0;
  if (tid == 0) {
    s_full = 0;
    s_depth = 0;
    for (int c = 0; c < 4; ++c) clocks[c] = 0;
    clocks[4] = clock64();
  }
  if (a.walk) {
    if (tid < kWarp) walk_in_order(a, nullptr, n, n_full);
    m = walked = n;
  } else {
    // Every op's bucket, and which buckets hold one.
    for (int w = tid; w <= M / 32; w += T) sm.occupied[w] = 0;
    __syncthreads();
    for (int i = tid; i < n; i += T) {
      const uint32_t h1 = __ldg(a.ops + static_cast<size_t>(a.c0 + i) * kOpCols
                                + 1);
      const uint32_t b = ((h1 & a.cap_mask) >> a.bucket_log2) & (M - 1);
      sm.bucket[i] = static_cast<uint16_t>(b);
      atomicOr(sm.occupied + b / 32, 1u << (b % 32));
    }
    __syncthreads();
    // This block's stretch, in positions p = b, or b + M below the first
    // empty bucket: [lo, hi).  No empty bucket at all: block 0 takes all.
    if (tid < kWarp) {
      const int first = first_empty(sm.occupied, M, 0);
      int lo, hi;
      if (first == M) {
        lo = 0;
        hi = k == 0 ? 2 * M : 0;
      } else {
        const auto cut = [&](int j) {
          if (j == 0) return first;
          if (j == K) return M + first;
          const int c = first_empty(sm.occupied, M, j * (M / K));
          return c == M ? M + first : c;
        };
        lo = cut(k);
        hi = cut(k + 1);
      }
      if (tid == 0) {
        s_lo = lo;
        s_hi = hi;
        s_first = first;
      }
    }
    __syncthreads();
    lap(clocks, 0);
    // Its ops in batch order, with their keys: each warp a segment of the
    // chunk, counted, then written at its offset by ballots.
    const int lo = s_lo, hi = s_hi, first = s_first;
    const int warps = T / kWarp, warp = tid / kWarp;
    const unsigned below = (1u << lane) - 1u;
    const auto own = [&](int i) {
      const int b = sm.bucket[i];
      const int pos = b >= first ? b : b + M;
      return pos >= lo && pos < hi;
    };
    int seg = (n + warps - 1) / warps;
    int seg_lo = min(n, warp * seg), seg_hi = min(n, seg_lo + seg);
    int count = 0;
    for (int base = seg_lo; base < seg_hi; base += kWarp)
      count += __popc(__ballot_sync(kFullMask,
                                    base + lane < seg_hi && own(base + lane)));
    if (lane == 0) tot[warp] = count;
    __syncthreads();
    int at = 0;
    for (int w = 0; w < warps; ++w) {
      at += w < warp ? static_cast<int>(tot[w]) : 0;
      m += static_cast<int>(tot[w]);
    }
    for (int base = seg_lo; base < seg_hi; base += kWarp) {
      const int i = base + lane;
      const bool mine = i < seg_hi && own(i);
      const unsigned bits = __ballot_sync(kFullMask, mine);
      if (mine) {
        const int j = at + __popc(bits & below);
        const Op op = load_op(a.ops, a.c0 + i);
        sm.lop[j] = static_cast<uint16_t>(i);
        sm.key[j] = ((op.f[1] & a.cap_mask) << 1) |
                    (is_writer(static_cast<int>(op.f[0])) ? 1u : 0u);
#pragma unroll
        for (int c = 0; c < 6; ++c) sm.field[c * n + j] = op.f[c];
      }
      at += __popc(bits);
    }
    __syncthreads();
    // Run heads: a follower is a reader after a reader at its start.  An
    // op's head's rank is the count of heads up to it, less one: parked
    // in lev.  Counted and written as above.
    const auto is_head = [&](int j) {
      return j == 0 || (sm.key[j] & 1u) || sm.key[j] != sm.key[j - 1];
    };
    seg = (m + warps - 1) / warps;
    seg_lo = min(m, warp * seg);
    seg_hi = min(m, seg_lo + seg);
    count = 0;
    for (int base = seg_lo; base < seg_hi; base += kWarp)
      count += __popc(__ballot_sync(
          kFullMask, base + lane < seg_hi && is_head(base + lane)));
    __syncthreads();  // every warp has read the first counts
    if (lane == 0) tot[warp] = count;
    __syncthreads();
    at = 0;
    for (int w = 0; w < warps; ++w) {
      at += w < warp ? static_cast<int>(tot[w]) : 0;
      heads += static_cast<int>(tot[w]);
    }
    for (int base = seg_lo; base < seg_hi; base += kWarp) {
      const int j = base + lane;
      const bool head = j < seg_hi && is_head(j);
      const unsigned bits = __ballot_sync(kFullMask, head);
      if (j < seg_hi) {
        const int rank = at + __popc(bits & (below | (1u << lane))) - 1;
        sm.lev[j] = static_cast<uint16_t>(rank);
        if (head && rank < kLocalMax) sm.hkey[rank] = sm.key[j];
      }
      at += __popc(bits);
    }
    __syncthreads();
    lap(clocks, 1);
    bool walk = heads > kLocalMax;
    if (!walk) {
      // The heads' levels, a warp's 32 at a time, by warp 0: the heads
      // before the 32 (their levels are final), then within them, the
      // lanes some lane depends on in order.
      if (tid < kWarp) {
        const uint32_t probe = static_cast<uint32_t>(a.probe);
        int depth = 0;
        for (int c0 = 0; c0 < heads; c0 += kWarp) {
          const int t = c0 + lane;
          const uint32_t act = t < heads;
          const uint32_t kt = act ? sm.hkey[t] : 0;
          int lv = 1;
          for (int i = 0; i < c0; ++i)
            if (act & depends(sm.hkey[i], kt, a.cap_mask, probe))
              lv = max(lv, sm.hlev[i] + 1);
          uint32_t deps = 0;
          for (int s = 0; s < kWarp; ++s) {
            const uint32_t ks = __shfl_sync(kFullMask, kt, s);
            deps |= (act & static_cast<uint32_t>(s < lane) &
                     depends(ks, kt, a.cap_mask, probe)) << s;
          }
          uint32_t cols = deps;
          for (int d = kWarp / 2; d > 0; d /= 2)
            cols |= __shfl_xor_sync(kFullMask, cols, d);
          while (cols) {
            const int s = __ffs(cols) - 1;
            cols &= cols - 1;
            const int v = __shfl_sync(kFullMask, lv, s);
            if ((deps >> s) & 1u) lv = max(lv, v + 1);
          }
          if (act) sm.hlev[t] = static_cast<uint16_t>(lv);
          depth = max(depth, act ? lv : 0);
          __syncwarp();
        }
        for (int d = kWarp / 2; d > 0; d /= 2)
          depth = max(depth, __shfl_xor_sync(kFullMask, depth, d));
        if (tid == 0) s_depth = depth;
      }
      __syncthreads();
      walk = s_depth > kMaxLevels;
    }
    lap(clocks, 2);
    if (walk) {
      if (tid < kWarp) walk_in_order(a, sm.lop, m, n_full);
      walked = m;
    } else {
      for (int j = tid; j < m; j += T) sm.lev[j] = sm.hlev[sm.lev[j]];
      __syncthreads();
      for (int lv = 1; lv <= s_depth; ++lv) {
        for (int j = tid; j < m; j += T)
          if (sm.lev[j] == lv)
            run_op(a, sm.field, n, j, a.c0 + sm.lop[j], n_full);
        __syncthreads();
      }
    }
  }
  if (n_full) atomicAdd(&s_full, n_full);
  __syncthreads();
  lap(clocks, 3);
  if (tid == 0) {
    if (s_full) atomicAdd(a.full, s_full);
    if (a.stats) {
      atomicMax(a.stats, walked ? 0 : s_depth);
      atomicAdd(a.stats + 1, walked);
      atomicAdd(a.stats + 2, walked ? 1 : 0);
      atomicAdd(a.stats + 3, m ? 1 : 0);
      for (int c = 0; c < 4; ++c)
        atomicAdd(a.stats + 4 + c,
                  static_cast<int>(min(clocks[c], 0x7fffffffLL)));
    }
  }
}

struct MatchArgs {
  const uint32_t* watches;  // [5, n_w]: kind (-1 pad), h1, h2, len, min
  const uint32_t* events;   // [5, n_ev]: kind, len, index, th1, th2
  const uint32_t* hp;       // [2, n_ev, lmax + 1]: prefix hashes
  uint8_t* fired;           // [n_w]
  uint32_t* packed;         // [n_w / 32]
  unsigned long long* stats;  // [3] or null (watch_match's comment)
  int n_w;
  int n_ev;
  int lmax;
  int ev_per_block;         // events of one blockIdx.y
  int ev_chunk;             // events staged at once
  int staged;               // prefix hashes in shared memory
};

// A thread's four watches; bit r of hit_kv / hit_tab is watch r's.  `at`
// is the watch's column of the prefix hashes: a byte offset into a row
// when the rows are staged, else the column index.
struct Watches {
  uint32_t h1[kMatchPer], h2[kMatchPer], min_index[kMatchPer];
  int len[kMatchPer], at[kMatchPer];
  uint32_t hit_kv, hit_tab;
};

// The chunk's events [c0, c0 + ne) against the thread's watches: a KV
// loop and a TABLE loop over the set bits of the warp's kind ballots,
// each pair's compares ANDed without a branch.  Returns the pairs a
// watch ran (the chunk's KV and TABLE events).
template <bool kStaged>
__device__ int match_chunk(const MatchArgs& a, const uint32_t* ev,
                           const uint2* hp_s, int c0, int ne, Watches& w) {
  const int lane = static_cast<int>(threadIdx.x) & (kWarp - 1);
  const int L1 = a.lmax + 1;
  const uint32_t* e_len = ev + ne;
  const uint32_t* e_index = ev + 2 * ne;
  const uint32_t* e_th1 = ev + 3 * ne;
  const uint32_t* e_th2 = ev + 4 * ne;
  int pairs = 0;
  for (int g0 = 0; g0 < ne; g0 += kWarp) {
    const int kind = g0 + lane < ne ? static_cast<int>(ev[g0 + lane]) : -1;
    unsigned kv = __ballot_sync(kFullMask, kind == kEvKv);
    unsigned tab = __ballot_sync(kFullMask, kind == kEvTable);
    pairs += __popc(kv) + __popc(tab);
    // Two KV events an iteration (the second the first again when the
    // count is odd: an OR of the same pair twice).
    while (kv) {
      const int e0 = g0 + __ffs(kv) - 1;
      kv &= kv - 1;
      const int e1 = kv ? g0 + __ffs(kv) - 1 : e0;
      kv &= kv - 1;
      const int len0 = static_cast<int>(e_len[e0]);
      const int len1 = static_cast<int>(e_len[e1]);
      const uint32_t index0 = e_index[e0], index1 = e_index[e1];
      uint32_t hit = 0;
#pragma unroll
      for (int r = 0; r < kMatchPer; ++r) {
        uint32_t x0, y0, x1, y1;
        if (kStaged) {
          const uint2 v0 = *reinterpret_cast<const uint2*>(
              reinterpret_cast<const char*>(hp_s + e0 * L1) + w.at[r]);
          const uint2 v1 = *reinterpret_cast<const uint2*>(
              reinterpret_cast<const char*>(hp_s + e1 * L1) + w.at[r]);
          x0 = v0.x;
          y0 = v0.y;
          x1 = v1.x;
          y1 = v1.y;
        } else {
          const size_t col0 = static_cast<size_t>(c0 + e0) * L1 + w.at[r];
          const size_t col1 = static_cast<size_t>(c0 + e1) * L1 + w.at[r];
          const size_t half = static_cast<size_t>(a.n_ev) * L1;
          x0 = __ldg(a.hp + col0);
          y0 = __ldg(a.hp + half + col0);
          x1 = __ldg(a.hp + col1);
          y1 = __ldg(a.hp + half + col1);
        }
        hit |= static_cast<uint32_t>(
                   ((w.len[r] <= len0) & (x0 == w.h1[r]) & (y0 == w.h2[r]) &
                    (index0 > w.min_index[r])) |
                   ((w.len[r] <= len1) & (x1 == w.h1[r]) & (y1 == w.h2[r]) &
                    (index1 > w.min_index[r])))
               << r;
      }
      w.hit_kv |= hit;
    }
    while (tab) {
      const int e = g0 + __ffs(tab) - 1;
      tab &= tab - 1;
      const uint32_t th1 = e_th1[e], th2 = e_th2[e], index = e_index[e];
      uint32_t hit = 0;
#pragma unroll
      for (int r = 0; r < kMatchPer; ++r)
        hit |= static_cast<uint32_t>((th1 == w.h1[r]) & (th2 == w.h2[r]) &
                                     (index > w.min_index[r])) << r;
      w.hit_tab |= hit;
    }
  }
  return pairs;
}

__global__ void __launch_bounds__(kMatchThreads) match_kernel(MatchArgs a) {
  const int tid = static_cast<int>(threadIdx.x);
  const int T = static_cast<int>(blockDim.x);
  const int lane = tid & (kWarp - 1);
  const int warp = tid / kWarp;
  const int L1 = a.lmax + 1;
  const int E = a.ev_chunk;
  // The staged prefix hashes first (8-byte aligned), then the event rows.
  uint2* hp_s = reinterpret_cast<uint2*>(kv_smem);
  uint32_t* ev_s = reinterpret_cast<uint32_t*>(
      kv_smem + (a.staged ? sizeof(uint2) * E * L1 : 0));
  const int tiles = (a.n_w + kMatchTile - 1) / kMatchTile;
  const int e_lo = static_cast<int>(blockIdx.y) * a.ev_per_block;
  const int e_hi = min(a.n_ev, e_lo + a.ev_per_block);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int w0 = tile * kMatchTile + warp * kWarp * kMatchPer + lane;
    Watches w;
    w.hit_kv = w.hit_tab = 0;
    uint32_t kv_ok = 0, tab_ok = 0;
#pragma unroll
    for (int r = 0; r < kMatchPer; ++r) {
      const int i = w0 + r * kWarp;
      const bool valid = i < a.n_w;
      const int kind = valid ? static_cast<int>(a.watches[i]) : -1;
      w.h1[r] = valid ? a.watches[a.n_w + i] : 0;
      w.h2[r] = valid ? a.watches[2 * a.n_w + i] : 0;
      w.len[r] = valid ? static_cast<int>(a.watches[3 * a.n_w + i]) : 0;
      w.min_index[r] = valid ? a.watches[4 * a.n_w + i] : 0;
      // The column: a byte offset into a staged row, else an index.
      w.at[r] = min(max(w.len[r], 0), a.lmax) *
                (a.staged ? static_cast<int>(sizeof(uint2)) : 1);
      asm volatile("" : "+r"(w.at[r]));  // kept, not recomputed per event
      kv_ok |= static_cast<uint32_t>(kind >= 0 && kind != kKindTable) << r;
      tab_ok |= static_cast<uint32_t>(kind == kKindTable) << r;
    }
    long long pairs = 0, staging = 0, matching = 0;
    for (int c0 = e_lo; c0 < e_hi; c0 += E) {
      const int ne = min(E, e_hi - c0);
      __syncthreads();  // the previous chunk's readers are done
      const long long t0 = clock64();
      for (int i = tid; i < 5 * ne; i += T) {
        const int row = i / ne, e = i - row * ne;
        ev_s[i] = a.events[row * a.n_ev + c0 + e];
      }
      if (a.staged) {
        const uint32_t* hp1 = a.hp + static_cast<size_t>(c0) * L1;
        const uint32_t* hp2 = hp1 + static_cast<size_t>(a.n_ev) * L1;
#pragma unroll 4
        for (int i = tid; i < ne * L1; i += T)
          hp_s[i] = make_uint2(__ldg(hp1 + i), __ldg(hp2 + i));
      }
      __syncthreads();
      const long long t1 = clock64();
      pairs += a.staged ? match_chunk<true>(a, ev_s, hp_s, c0, ne, w)
                        : match_chunk<false>(a, ev_s, hp_s, c0, ne, w);
      staging += t1 - t0;
      matching += clock64() - t1;
    }
    if (a.stats && lane == 0 && w0 < a.n_w) {
      atomicAdd(a.stats, static_cast<unsigned long long>(
                             pairs * min(kWarp * kMatchPer, a.n_w - w0)));
      if (tid == 0) {
        atomicAdd(a.stats + 1, static_cast<unsigned long long>(staging));
        atomicAdd(a.stats + 2, static_cast<unsigned long long>(matching));
      }
    }
#pragma unroll
    const uint32_t fired_bits = (kv_ok & w.hit_kv) | (tab_ok & w.hit_tab);
    for (int r = 0; r < kMatchPer; ++r) {
      const int i = w0 + r * kWarp;
      const bool fired = (fired_bits >> r) & 1u;
      const unsigned word = __ballot_sync(kFullMask, fired);
      if (i >= a.n_w) continue;  // a whole warp: n_w is a multiple of 32
      if (gridDim.y == 1) {
        a.fired[i] = fired ? 1 : 0;
        if (lane == 0) a.packed[i / kWarp] = word;
      } else if (lane == 0 && word) {
        atomicOr(a.packed + i / kWarp, word);
      }
    }
  }
}

struct FiredArgs {
  const uint32_t* packed;  // [n_w / 32]
  uint8_t* fired;          // [n_w]
  int n_w;
};

// The fired bytes from the packed words (events split over blocks).
__global__ void __launch_bounds__(kFiredThreads) fired_kernel(FiredArgs f) {
  const int w = static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x);
  if (w < f.n_w) f.fired[w] = (f.packed[w / kWarp] >> (w % kWarp)) & 1u;
}

// Devices on which apply_kernel may take its largest shared memory.
std::atomic<unsigned> apply_smem_set{0};

}  // namespace

// One padded op batch applied to the table in place, with the result of
// applying the ops in order: `tab` int32 [capacity, 8] (capacity a power
// of two >= probe), `full` int32 [1], `ops` int32 [n_ops, 8]; writes
// `existed` (bool [n_ops]) and `old_index` (int32 [n_ops]).  1 <= probe
// <= 32.  A launch a chunk of kApplyChunk ops, in order on `stream`.
// `stats` (int32 [8], or null; zeroed by the caller): the most levels a
// block ran, the ops walked in order, the blocks that walked, the blocks
// that held ops, and the blocks' thread-0 clock cycles summed by phase:
// buckets and cuts, the block's ops and run heads, the heads' levels, the
// run (levels or walk).
extern "C" int kv_apply(void* tab, void* full, const void* ops, int n_ops,
                        int capacity, int probe, void* existed,
                        void* old_index, void* stats, cudaStream_t stream) {
  if (n_ops <= 0) return 0;
  if (probe < 1 || probe > kWarp || capacity < probe ||
      (capacity & (capacity - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int width = 1, width_log2 = 0;
  while (width < probe) {
    width <<= 1;
    ++width_log2;
  }
  const size_t most = ApplySmem::bytes(kApplyChunk, kMaxBuckets);
  if (most > 48 * 1024) {
    int dev = 0;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    if (!(apply_smem_set.load() & (1u << (dev & 31)))) {
      rc = cudaFuncSetAttribute(apply_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(most));
      if (rc != cudaSuccess) return static_cast<int>(rc);
      apply_smem_set.fetch_or(1u << (dev & 31));
    }
  }
  for (int c0 = 0; c0 < n_ops; c0 += kApplyChunk) {
    const int n = n_ops - c0 < kApplyChunk ? n_ops - c0 : kApplyChunk;
    // Buckets: twice the ops, as many as the ring has at most.
    int buckets = 1;
    while (buckets < 2 * n && buckets < kMaxBuckets &&
           buckets < capacity / width)
      buckets <<= 1;
    // Below two windows every pair of windows meets; one op needs no
    // schedule: block 0 walks.
    const int walk = capacity < 2 * probe || n == 1;
    int blocks = n / kOpsPerBlock;
    if (blocks > kApplyBlocks) blocks = kApplyBlocks;
    if (blocks > buckets / 4) blocks = buckets / 4;
    if (blocks < 1 || walk) blocks = 1;
    const int threads = walk ? kWarp : kApplyThreads;
    const size_t smem = walk ? 0 : ApplySmem::bytes(n, buckets);
    ApplyArgs a{static_cast<uint32_t*>(tab), static_cast<uint32_t*>(full),
                static_cast<const uint32_t*>(ops),
                static_cast<uint8_t*>(existed),
                static_cast<uint32_t*>(old_index), static_cast<int*>(stats),
                c0, n, static_cast<uint32_t>(capacity - 1), probe,
                width_log2, buckets, walk};
    apply_kernel<<<blocks, threads, smem, stream>>>(a);
    const cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  return 0;
}

// The watch set `watches` int32 [5, n_w] (n_w a power of two >= 32)
// against the events `events` int32 [5, n_ev] and their prefix hashes
// `hp` int32 [2, n_ev, lmax + 1]; writes `fired` (bool [n_w]) and
// `packed` (int32 [n_w / 32]).  `stats` (int64 [3], or null) gains the
// (watch, event) pairs the launch evaluated, and the clock cycles thread
// 0 of each block spent staging event chunks and matching them.
extern "C" int watch_match(const void* watches, int n_w, const void* events,
                           const void* hp, int n_ev, int lmax, void* fired,
                           void* packed, void* stats, cudaStream_t stream) {
  if (n_w < kWarp || (n_w & (n_w - 1)) != 0 || n_ev < 0 || lmax < 0 ||
      lmax >= (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = n_w / kMatchPer < kWarp ? kWarp
                      : n_w / kMatchPer > kMatchThreads ? kMatchThreads
                                                        : n_w / kMatchPer;
  const int tiles = (n_w + kMatchTile - 1) / kMatchTile;
  // Fewer tiles than the card holds blocks: split the events.
  int split = 1;
  if (tiles < kMatchBlocks && n_ev > kMinEvents) {
    split = (kMatchBlocks + tiles - 1) / tiles;
    const int most = (n_ev + kMinEvents - 1) / kMinEvents;
    if (split > most) split = most;
  }
  const int per_block = n_ev == 0 ? 0 : (n_ev + split - 1) / split;
  if (per_block > 0) split = (n_ev + per_block - 1) / per_block;
  const int L1 = lmax + 1;
  int chunk = kMatchSmemWords / (2 * L1 + 5);
  const int staged = chunk >= 1;
  if (chunk > kEvChunk || !staged) chunk = kEvChunk;
  const size_t smem =
      sizeof(uint32_t) * (static_cast<size_t>(staged ? 2 * L1 : 0) + 5) *
      chunk;
  MatchArgs a{static_cast<const uint32_t*>(watches),
              static_cast<const uint32_t*>(events),
              static_cast<const uint32_t*>(hp), static_cast<uint8_t*>(fired),
              static_cast<uint32_t*>(packed),
              static_cast<unsigned long long*>(stats), n_w, n_ev, lmax,
              per_block, chunk, staged};
  const dim3 grid(tiles < kMatchBlocks ? tiles : kMatchBlocks, split);
  if (split > 1) {
    const cudaError_t rc = cudaMemsetAsync(
        packed, 0, sizeof(uint32_t) * (n_w / kWarp), stream);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  match_kernel<<<grid, threads, smem, stream>>>(a);
  if (split > 1) {
    const cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
    const FiredArgs f{a.packed, a.fired, n_w};
    const int blocks = (n_w + kFiredThreads - 1) / kFiredThreads;
    fired_kernel<<<blocks, kFiredThreads, 0, stream>>>(f);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kv_store_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
