// The round's probe tick, for Hopper (sm_90a): direct probe -> indirect
// probes -> suspicion initiation for the round's prober block, as two
// kernels and their C entry points.
//
// Replaces one stretch of the reference's jitted round that XLA fuses (no
// Pallas source): consul_tpu/gossip/kernel.py:519-822, `_probe_tick`, its
// draws (jax.random.uniform under the round's probe keys) included.  Before
// this the port ran it as ~184 torch launches a round, one of them a launch
// of threefry.cu; each kernel here is bit-identical to the plain torch
// versions beside its wrapper (consul_tpu_torch/gossip/probe.py:
// probe_lanes_ref followed by probe_slots_ref; finish.py's wipe_rows_ref
// of the rearmed rows followed by probe_marks_ref), which are the port's
// former expressions cut at these kernels' boundaries.
//
// The round's order, two launches:
//   1. lanes_slots_kernel: the lanes, then the slot step in the last block
//      to arrive.
//      The lanes: B = ceil(N / probe_every) prober lanes, prober id pid =
//      blk + lane (ids >= N are padding lanes, which initiate nothing), a
//      thread a lane, blocks striding over chunks of kThreads lanes.  A
//      lane reads the round's row (the round, the block, the probe
//      offsets, the keys) from device memory, and: the prober's liveness
//      from mf (member ? fail_round : -1), its target (pid + o_t) mod N,
//      the direct probe's loss (a draw under k_dl), the nemesis legs (the
//      partition group in closed form: the top bit of the product with
//      2654435761, or id >= N / 2; draws under the four nemesis keys), the
//      K helpers (draws under k_hl at element lane * K + j), Lifeguard's
//      LHM and streak, read and written in place at pid, and, for a lane
//      that would initiate, its target's slot and the belief byte at (that
//      slot, the prober's column) through the shard table.  Out: a flag a
//      lane (it initiates); the segment minima of the needy targets over
//      kk = min(S, N, B) segments of GB = ceil(B / kk) lanes (by warp,
//      then in shared memory over the chunk's segments, then one
//      atomicMin a segment the chunk touches); the four probe
//      statistics and the needy count, summed over the block's whole
//      stride in registers, by warp, and in shared memory, then one atomic
//      a nonzero count a block (the acks missed and the indirect
//      escalations are the same lanes: one count serves both).
//      The arrival: each block, its flags, minima and counts written,
//      adds one to a counter in the scratch (atom.add.release.gpu); the
//      last to arrive (fence.acq_rel.gpu) runs the slot step with the
//      block's kThreads threads, in chunks of kThreads slots: the lanes
//      that initiate against a live slot's subject (the lane of subject x
//      is (x - blk - o_t) mod N) grow its suspicion count, or re-arm a
//      REFUTED or JOIN slot as a suspicion (a rearm flag a slot out, for
//      the wipe); then the candidates (the segment minima) take the free
//      slots in ascending slot order (each one's rank among the candidates,
//      by ballots, with the ranks' base carried from chunk to chunk), and
//      slot_of_node points at them; drops count the needy targets left
//      unserved; the stats are written, and the minima, counts and
//      arrival counter set back.  Chunks, not a block of S threads: a
//      1024-thread block would hold the lanes to one block an SM (a wave
//      of 135,168 lanes against 202,752 at kMinBlocks), and S may pass
//      1,024 (below); the main path's S = 64 is one chunk.  Up to
//      kMaxSlots slots every block
//      reads slot_node and slot_phase into shared memory before its
//      lanes (no launch writes them before the slot step), so the last
//      block's slot step starts with one round of loads: the flags, the
//      first chunk's minima and the counts together.
//   2. rearm_marks_kernel: the rearmed rows zeroed and each initiator's
//      own belief byte marked (SUSPECT, fresh age, the byte's
//      confirmation count kept) at its target's slot after the
//      allocation, where the byte is at most SUSPECT after the wipe.
//      Ownership, with no arrival: every byte written has one writer
//      thread.  A column of the prober block ([blk, blk + B), below N) is
//      its lane's, in every row: the lane's thread marks its byte (its
//      target's row), and once the block knows the rearmed rows writes
//      the column in each of them whole, the mark where that row is its
//      target's, else 0 (a wiped byte is 0, and the mark rule makes 0
//      kFreshSuspect, 0 being at most SUSPECT); so its own mark in a
//      rearmed row is overwritten by the same thread, in order.  Every
//      other column of a rearmed row is zeroed by the thread whose 16-byte
//      unit holds it.  So "wipe, then mark" needs no order between
//      threads, and the rearmed rows' marks no loads beyond the marks'
//      own.  (Slower on an H100: the thread that wipes a unit writing the
//      marks of its columns, which puts a chain of flag and slot loads on
//      the wipe; the listing before the marks, which puts its round trip
//      on theirs.)  Warp 0 of every block lists the rearmed rows (four ballots
//      of 32 rearm flags a round: at S = 64 one round trip) while warps
//      1-7 take the marks, a word of 4 flags a thread (the flags start at
//      a word of the scratch), its initiators' slot loads issued together,
//      then their byte loads, then the stores; shards and columns by
//      32-bit arithmetic (N < 2**30).  A barrier; with no rearmed row the
//      block is done.  Else the marks' threads write their columns of the
//      rearmed rows, and the blocks, from the last down, stride over items
//      of a listed row and a span of 256 units of one shard, a unit a
//      thread (finish.cu's wipe_kernel: units at the row's own 16-byte
//      address boundaries, a head and a tail unit byte by byte, so every
//      shard width takes 16-byte stores, L % 16 != 0 included), skipping
//      the lanes' columns.
// The reference's order holds: the belief byte of step 1 is read before
// the wipe, the slot of step 2 after the allocation.
//
// The grid of step 1: at most one wave, the blocks an SM that the
// occupancy query gives at kThreads (the launch bounds ask for
// kMinBlocks: 6 x 132 x 256 lanes cover the 1M main path's B = 200,000
// in one chunk a block) times the SMs, and no more blocks than chunks.
// Nothing waits on the arrival (the last block alone goes on), so the
// grid's size is for speed only.  The arrival (the release, one atomic a
// block on one word) and the slot step after it (a round of reads at L2,
// the ballots, the candidates' incarnations) are latency, not bytes:
// `python3 -m consul_tpu_torch.probe_stages` times this kernel cut after
// each stage.
//
// Bound.  The lanes read mf at up to 2 + K points (the prober, the
// target, the helpers asked), slot_of_node and a belief byte where the
// lane would initiate, and write one flag: at most ~26 bytes a lane at K
// = 3, 5.2 MB at B = 200,000, ~1.6 us at 3.35 TB/s; the 1M churn path's
// data needs ~9 a lane (1,800,000 bytes).  The slot step reads slot_node,
// slot_phase, a flag a live slot, the kk minima and the counts, writes the
// rearm flags, the stats, drops, the minima and counts set back and the
// registers it changes: ~1,000 bytes at S = 64.  A draw is ~52 issue
// slots of the busiest unit (sass_count.py --threefry), and a lane draws
// only where the draw decides something (the direct loss of a live,
// probed target; a helper's legs only for a prober whose direct probe
// failed; a probability of 0 or 1 draws nothing), so the main path's data
// needs few: the bytes bound it, and a launch costs more than either.
// Step 2 reads a flag a lane, an initiator's slot and its byte, writes the
// marks, and writes the rearmed rows whole:
// the main path's no-rearm round ~200,000 bytes, 0.00006 ms at 3.35
// TB/s, each rearmed row N bytes more (0.0003 ms at N = 1M).  Its grid is
// at most one wave of kRearmBlocksPerSM blocks an SM, fixed at capture
// (fewer where the flags' words and the S rows' spans are fewer); a
// round with no rearmed row pays a launch and the marks' chain of loads
// (flag, slot, byte), the listing running beside it.  The design keeps the probe tick to two launches (the point:
// ~184 before) and reads everything once.
//
// Past kMaxSlots (1,024) slots.  The reference provisions more itself
// (crossval.loss_sized_slots: 8,192 at n = 1M and 5 % loss; a nemesis
// run next_pow2(n), since a partition opens up to n / 2 suspicion
// episodes at once), so a launch of more slots takes each kernel's wide
// instance, chosen on the host by S:
//   - lanes_slots_wide_kernel stages no slot registers (slot_node and
//     slot_phase would be 128 KB at S = 16,384: past the 48 KB static
//     limit, one block an SM); the last block's slot step reads them from
//     memory at L2 (__ldcg), slot s's by the one thread that then writes
//     them.  Its free slots by rank (s_free, 4 KB at 1,024) go to S more
//     words of the caller's scratch, written in the first pass over the
//     slots and read in the second, by the one block, between barriers,
//     then set back to 0 (the scratch is the same after every round).
//     The ranks' base is carried from chunk to chunk as before.
//   - rearm_marks_wide_kernel lists and writes the rearmed rows in chunks
//     of kMaxSlots (under partition_heal at S = n thousands of rows can
//     re-arm in one round), each chunk as one listing is, the owners the
//     same.
// The lanes themselves take any S: a lane reads one slot id and one byte.
//
// Capture.  No launch reads the host or needs a memset: the row is read
// from device memory, and the scratch (the caller's, one per round
// program) holds the minima at N and the counts and the arrival counter
// at 0 between rounds, set back by the slot step; the flags are written
// whole by every lanes_slots launch.  So the two launches run inside
// the round program's captured graphs as they are.  One scratch serves
// one round at a time.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "threefry.cuh"

namespace probe {

constexpr int kMaxShards = 64;
// Slots lanes_slots_kernel stages in shared memory (the registers and
// the free list) and rearm_marks_kernel lists at once; a launch of more
// takes the wide kernels.
constexpr int kMaxSlots = 1024;
// Slots a launch takes: slot ids, the rearm chunks' items and the
// scratch's words stay far inside an int.
constexpr int kSlotCeiling = 1 << 24;
constexpr int kMaxHelpers = 64;
constexpr int kThreads = 256;     // a block; a chunk of lanes or of slots
constexpr int kMinBlocks = 6;     // blocks an SM the launch bounds ask for
// The rearm_marks grid at most: kRearmBlocksPerSM blocks an SM.
constexpr int kRearmBlocksPerSM = 4;
constexpr int kCols = 16;         // a unit: 16 columns of a shard row
constexpr int kListBallots = 4;   // ballots a round of the rows' listing
constexpr int kMarkThreads = kThreads - 32;  // a block's marks: warps 1 on
// The scratch: kk int32 minima, then kCounts int32 counts (the last used
// the arrival counter), then B flag bytes.
constexpr int kCounts = 8;
enum Count { kProbes = 0, kMissed, kIndirect, kSuspicions, kNeedy,
             kArrive = kCounts - 1 };
enum Phase { kFree = 0, kSuspect = 1, kDeadPhase = 2, kRefuted = 3,
             kJoin = 4 };
enum Partition { kNoPartition = 0, kHash = 1, kHalves = 2 };
// The belief byte: msg:2 | conf:2 | age:4 (gossip/belief.py).
constexpr uint32_t kMsgShift = 6;
constexpr uint32_t kMsgSuspect = 1;
constexpr uint32_t kMsgDead = 2;
constexpr uint32_t kConfBits = 0x30u;
constexpr uint32_t kFreshSuspect = 0x4Fu;  // SUSPECT, conf 0, age fresh

// The pointer table's entries (probe.py's _PTRS order).
enum Ptr {
  kRnd = 0, kBlk, kProbe, kKdl, kKhl, kKnem, kMf, kSlotOfNode, kLhm,
  kStreak, kSlotNode, kSlotPhase, kSlotInc, kSlotStart, kSlotNsusp,
  kSlotDead, kIncarnation, kDrops, kRearm, kStats, kScratch, kNumPtrs
};
// The integer arguments (probe.py's _INTS order).
enum Int {
  iN = 0, iB, iS, iK, iPart, iDegraded, iObsLo, iObsHi, iLhmMax, kNumInts
};
// The float32 probabilities (probe.py's _FLOATS order).
enum Float { fDl = 0, fIl, fOne, fTwo, fObs, kNumFloats };

// Everything a launch needs, by value (about 750 bytes of the 4 KB
// parameter block) as a __grid_constant__.
struct Args {
  uint8_t* heard[kMaxShards];  // ndev shards, u8 [S, L] each
  const int32_t* rnd;          // the round's row: the round
  const int32_t* blk;          //   the prober block's first id
  const int32_t* probe;        //   [1 + K] offsets: target, helpers
  const int32_t* k_dl;         //   keys, two words each
  const int32_t* k_hl;
  const int32_t* k_nem;        //   [4][2]: k_np, k_no, k_nip, k_nio
  const int32_t* mf;           // [N] member ? fail_round : -1
  int32_t* slot_of_node;       // [N]
  int32_t* lhm;                // [N] or null (no Lifeguard registers)
  int32_t* streak;             // [N] or null
  int32_t* slot_node;          // [S] each
  int32_t* slot_phase;
  int32_t* slot_inc;
  int32_t* slot_start;
  int32_t* slot_nsusp;
  int32_t* slot_dead;
  const int32_t* incarnation;  // [N]
  int32_t* drops;              // [1]
  uint8_t* rearm;              // [S]: the slot step's out, the wipe's in
  int32_t* stats;              // [4] out
  int32_t* minima;             // scratch: [kk]
  int32_t* counts;             //   [kCounts]
  uint8_t* flags;              //   [B]
  int32_t* free_slots;         //   [S] past kMaxSlots, else null
  int N, B, S, K, L, ndev, kk, GB;
  int part, degraded, obs_lo, obs_hi, lhm_max;
  float p_dl, p_il, p_one, p_two, p_obs;
};

__device__ __forceinline__ int64_t mod(int64_t a, int64_t n) {
  const int64_t r = a % n;
  return r < 0 ? r + n : r;
}

// Adds one to the arrival counter at GPU scope with release semantics and
// returns the old value; and the acquire the last block to arrive makes
// before it reads the others' flags, minima and counts (finish.cu's and
// observe.cu's pair).
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

// The partition group of node `id` (nemesis.group_of).
__device__ __forceinline__ int group(int64_t id, const Args& a) {
  if (a.part == kHash) {
    return static_cast<int>(
        static_cast<uint32_t>(static_cast<uint64_t>(id) * 2654435761ull) >>
        31);
  }
  return id >= a.N / 2 ? 1 : 0;
}

// The belief byte at (row, global column c), through the shard table.
__device__ __forceinline__ uint8_t* byte_at(const Args& a, int row,
                                            int64_t c) {
  const int i = static_cast<int>(c / a.L);
  return a.heard[i] + static_cast<size_t>(row) * a.L + (c - int64_t(i) * a.L);
}

// Whether a prober whose direct probe of a live member failed is rescued
// by one of its K helpers (any helper's relay succeeds), at lane `l`.
__device__ __forceinline__ bool rescued_by_helpers(const Args& a, int l,
                                                   int64_t pid, int32_t rnd,
                                                   int g_p, int g_t,
                                                   bool deg) {
  for (int j = 0; j < a.K; ++j) {
    const uint32_t ctr = threefry::counter(l, j, a.K);
    const int64_t h = mod(pid + a.probe[1 + j], a.N);
    if (!(__ldg(a.mf + h) > rnd)) continue;
    // hu >= p_indirect_fail_alive: the complement of below.
    if (threefry::below_at(a.k_hl, ctr, a.p_il)) continue;
    if (a.part != kNoPartition) {
      const int g_h = group(h, a);
      const int cross = (g_p != g_h) + (g_h != g_t);
      if (a.p_one >= 1.0f) {
        if (cross != 0) continue;
      } else if (a.p_one > 0.0f && cross > 0) {
        const float p = cross == 1 ? a.p_one : a.p_two;
        if (threefry::below_at(a.k_nem + 4, ctr, p)) continue;
      }
    }
    if (deg && threefry::below_at(a.k_nem + 6, ctr, a.p_obs)) continue;
    return true;
  }
  return false;
}

// What a lane did: a valid prober probed a target (ok), its direct probe
// of a member failed (missed), it initiates (init), against a target with
// no slot (need).
struct Lane {
  bool ok, missed, init, need;
  int32_t tgt;
};

// Lane `l` of the tick (any l; past B it does nothing): its flag, and
// LHM and streak in place.
__device__ __forceinline__ Lane lane(const Args& a, int l) {
  Lane r{false, false, false, false, 0};
  if (l >= a.B) return r;
  const int32_t rnd = __ldg(a.rnd);
  const int64_t N = a.N;
  const int64_t pid = static_cast<int64_t>(__ldg(a.blk)) + l;
  const bool pvalid = pid < N;
  r.ok = pvalid && __ldg(a.mf + mod(pid, N)) > rnd;
  bool member = false, rescued = false, init = false;
  int32_t s_t = -1;
  int64_t tgt = 0;
  if (r.ok) {
    tgt = mod(pid + __ldg(a.probe), N);
    const int32_t mf_t = __ldg(a.mf + tgt);
    member = mf_t >= 0;
    const bool alive = mf_t > rnd;
    int g_p = 0, g_t = 0;
    bool deg = false, lost = !alive;
    if (a.part != kNoPartition) {
      g_p = group(pid, a);
      g_t = group(tgt, a);
      lost = lost || (g_p != g_t &&
                      threefry::below_at(a.k_nem, l, a.p_one));
    }
    if (a.degraded) {
      deg = pid >= a.obs_lo && pid < a.obs_hi;
      lost = lost || (deg && threefry::below_at(a.k_nem + 2, l, a.p_obs));
    }
    lost = lost || threefry::below_at(a.k_dl, l, a.p_dl);
    r.missed = member && lost;
    // The helpers decide only for a prober whose direct probe failed
    // (and rescue only a live target).
    if (r.missed && alive && a.K > 0) {
      rescued = rescued_by_helpers(a, l, pid, rnd, g_p, g_t, deg);
    }
    init = r.missed && !rescued;
  }
  if (a.lhm != nullptr && pvalid) {
    // Lifeguard: suspect only after more consecutive direct misses
    // than the prober's LHM; LHM up on a miss the helpers contradict,
    // down on a clean probe.
    const int32_t lhm_b = a.lhm[pid], streak_b = a.streak[pid];
    const int32_t streak_new =
        r.missed ? min(streak_b + 1, a.lhm_max + 1) : 0;
    init = init && streak_new > lhm_b;
    const int32_t lhm_new =
        max(0, min(a.lhm_max, lhm_b + int(r.missed && rescued) -
                                  int(r.ok && member && !r.missed)));
    a.lhm[pid] = lhm_new;
    a.streak[pid] = streak_new;
  }
  // Only a lane that would initiate reads its target's slot (the
  // reference's order of the tests, which commute, changed so).
  if (init) {
    s_t = a.slot_of_node[tgt];
    if (s_t >= 0) {
      // Don't re-suspect a target this prober already believes dead.
      const uint32_t cur = *byte_at(a, min(s_t, a.S - 1), pid);
      if ((cur >> kMsgShift) == kMsgDead) init = false;
    }
  }
  r.init = init;
  r.need = init && s_t < 0;
  r.tgt = static_cast<int32_t>(tgt);
  a.flags[l] = init ? 1 : 0;
  return r;
}

// The needy targets' minima of chunk `c` (lanes c * kThreads on, lane `l`
// this thread's) into the kk segments of GB lanes, for a chunk with a
// needy lane (every thread takes part): a warp whose lanes lie in at most
// two segments takes each one's minimum by __reduce_min_sync (GB >= 32:
// every warp), a straddling warp's needy lanes go one by one; into the
// chunk's segments in shared memory, then one atomicMin a segment the
// chunk touches.  So a round's many needy lanes (a partition's crossed
// probes) contend on the kk words by chunk, not by lane.
__device__ __forceinline__ void segment_minima(const Args& a, int c, int l,
                                               bool need, int32_t tgt) {
  __shared__ int32_t s_min[kThreads];  // the chunk's segments, from seg0
  const int t = static_cast<int>(threadIdx.x);
  const int seg0 = c * kThreads / a.GB;
  s_min[t] = a.N;
  __syncthreads();
  const int seg = l / a.GB - seg0;
  const int w0 = (l - (t & 31)) / a.GB - seg0;  // the warp's first
  if (__ballot_sync(0xFFFFFFFFu, need) != 0) {
    if ((l - (t & 31) + 31) / a.GB - seg0 - w0 <= 1) {
      const int lo = __reduce_min_sync(
          0xFFFFFFFFu, need && seg == w0 ? tgt : a.N);
      const int hi = __reduce_min_sync(
          0xFFFFFFFFu, need && seg != w0 ? tgt : a.N);
      if ((t & 31) == 0) {
        if (lo < a.N) atomicMin(s_min + w0, lo);
        if (hi < a.N) atomicMin(s_min + w0 + 1, hi);
      }
    } else if (need) {
      atomicMin(s_min + seg, tgt);
    }
  }
  __syncthreads();
  if (s_min[t] < a.N) atomicMin(a.minima + seg0 + t, s_min[t]);
}

// The exclusive rank of this thread's `pred` among the block's threads
// (warp ballots, then the warps' totals) and, in *total, their count.
__device__ __forceinline__ int block_rank(bool pred, int* s_warp,
                                          int* total) {
  const int t = static_cast<int>(threadIdx.x);
  const int lane = t & 31, w = t >> 5;
  const unsigned m = __ballot_sync(0xFFFFFFFFu, pred);
  if (lane == 0) s_warp[w] = __popc(m);
  __syncthreads();
  int base = 0, sum = 0;
  for (int i = 0; i < kThreads / 32; ++i) {
    const int c = s_warp[i];
    if (i < w) base += c;
    sum += c;
  }
  __syncthreads();
  *total = sum;
  return base + __popc(m & ((1u << lane) - 1u));
}

// The flag of the lane that initiates against slot s's subject, if it is
// live (at most one a subject: the round's targets are distinct); 0 if
// none.  `first`: the lane of subject x is (x - first) mod N.
__device__ __forceinline__ int32_t slot_flag(const Args& a,
                                             const int32_t* s_node, int s,
                                             int64_t first) {
  const int32_t node = s_node[s];
  if (node < 0) return 0;
  const int64_t i_s = mod(static_cast<int64_t>(min(node, a.N - 1)) - first,
                          a.N);
  return i_s < a.B ? __ldcg(a.flags + i_s) : 0;
}

// The slot step, by the last block to arrive, from the slot registers
// every block read (s_node, s_phase), the round's row (rnd; `first`, blk
// + o_t), and the grid's flags, minima and counts (read at L2: other
// blocks wrote them in this launch).
__device__ __forceinline__ void slot_step(const Args& a,
                                          const int32_t* s_node,
                                          const int32_t* s_phase,
                                          int32_t rnd, int64_t first) {
  __shared__ int s_free[kMaxSlots];  // the free slots by rank
  __shared__ int s_warp[kThreads / 32];
  const int t = static_cast<int>(threadIdx.x);
  // One round of loads: the first chunk's flags and candidates, the
  // counts and drops.
  const int32_t add0 = t < a.S ? slot_flag(a, s_node, t, first) : 0;
  const int32_t cand0 = t < a.kk ? __ldcg(a.minima + t) : a.N;
  int32_t c[kNeedy + 1];
  uint32_t drops = 0u;
  if (t == 0) {
    for (int k = 0; k <= kNeedy; ++k) c[k] = __ldcg(a.counts + k);
    drops = static_cast<uint32_t>(*a.drops);
  }
  // The absorbs and rearms, and the free slots in ascending order.
  int n_free = 0;
  for (int s0 = 0; s0 < a.S; s0 += kThreads) {
    const int s = s0 + t;
    bool valid = false;
    if (s < a.S) {
      const int32_t node = s_node[s];
      valid = node >= 0;
      const int32_t node_c = min(max(node, 0), a.N - 1);
      const int32_t add = s0 == 0 ? add0 : slot_flag(a, s_node, s, first);
      bool rearm = false;
      if (add > 0) {
        const int32_t phase = s_phase[s];
        if (phase == kSuspect) {
          a.slot_nsusp[s] += add;  // an existing episode absorbs it
        } else if (phase == kRefuted || phase == kJoin) {
          // Re-arm as a suspicion at the bumped incarnation.
          rearm = true;
          a.slot_phase[s] = kSuspect;
          a.slot_inc[s] = __ldg(a.incarnation + node_c);
          a.slot_start[s] = rnd;
          a.slot_nsusp[s] = add;
          a.slot_dead[s] = -1;
        }
      }
      a.rearm[s] = rearm ? 1 : 0;
    }
    int n;
    const bool free = s < a.S && !valid;
    const int rank = block_rank(free, s_warp, &n);
    if (free) s_free[n_free + rank] = s;
    n_free += n;
  }
  // The candidates (the segment minima; N: none) take the free slots in
  // rank order; the minima go back to N.
  int n_dom = 0;
  for (int k0 = 0; k0 < a.kk; k0 += kThreads) {
    const int k = k0 + t;
    int32_t cand = k0 == 0 ? cand0 : a.N;
    if (k < a.kk) {
      if (k0 > 0) cand = __ldcg(a.minima + k);
      a.minima[k] = a.N;
    }
    int n;
    const bool in_dom = cand < a.N;
    const int rank = n_dom + block_rank(in_dom, s_warp, &n);
    if (in_dom && rank < n_free) {
      const int slot = s_free[rank];
      const int32_t c = min(max(cand, 0), a.N - 1);
      a.slot_node[slot] = c;
      a.slot_phase[slot] = kSuspect;
      a.slot_inc[slot] = __ldg(a.incarnation + c);
      a.slot_start[slot] = rnd;
      a.slot_nsusp[slot] = 1;  // one initiator a distinct target
      a.slot_dead[slot] = -1;
      a.slot_of_node[c] = slot;
    }
    n_dom += n;
  }
  if (t == 0) {
    const int served = min(n_dom, n_free);
    for (int k = 0; k <= kNeedy; ++k) a.counts[k] = 0;
    // drops wraps mod 2**32, as the reference's counter does.
    *a.drops = static_cast<int32_t>(
        drops + static_cast<uint32_t>(c[kNeedy] - served));
    a.stats[kProbes] = c[kProbes];
    a.stats[kMissed] = c[kMissed];
    a.stats[kIndirect] = c[kMissed];
    a.stats[kSuspicions] = c[kSuspicions];
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
lanes_slots_kernel(const __grid_constant__ Args a) {
  __shared__ int32_t s_node[kMaxSlots];
  __shared__ int32_t s_phase[kMaxSlots];
  __shared__ int s_sum[4];
  __shared__ int s_last;
  const int t = static_cast<int>(threadIdx.x);
  const int32_t rnd = __ldg(a.rnd);
  const int64_t first = static_cast<int64_t>(__ldg(a.blk)) + __ldg(a.probe);
  for (int s = t; s < a.S; s += kThreads) {
    s_node[s] = a.slot_node[s];
    s_phase[s] = a.slot_phase[s];
  }
  if (t < 4) s_sum[t] = 0;
  // The lanes, chunk by chunk; the block's counts in registers.
  unsigned n_ok = 0u, n_missed = 0u, n_init = 0u, n_need = 0u;
  const int chunks = (a.B + kThreads - 1) / kThreads;
  for (int c = static_cast<int>(blockIdx.x); c < chunks;
       c += static_cast<int>(gridDim.x)) {
    const int l = c * kThreads + t;
    const Lane r = lane(a, l);
    n_ok += r.ok;
    n_missed += r.missed;
    n_init += r.init;
    n_need += r.need;
    if (__syncthreads_or(r.need)) segment_minima(a, c, l, r.need, r.tgt);
  }
  // The block's counts, one atomic each that is not 0.
  n_ok = __reduce_add_sync(0xFFFFFFFFu, n_ok);
  n_missed = __reduce_add_sync(0xFFFFFFFFu, n_missed);
  n_init = __reduce_add_sync(0xFFFFFFFFu, n_init);
  n_need = __reduce_add_sync(0xFFFFFFFFu, n_need);
  if ((t & 31) == 0) {
    if (n_ok) atomicAdd(s_sum + 0, static_cast<int>(n_ok));
    if (n_missed) atomicAdd(s_sum + 1, static_cast<int>(n_missed));
    if (n_init) atomicAdd(s_sum + 2, static_cast<int>(n_init));
    if (n_need) atomicAdd(s_sum + 3, static_cast<int>(n_need));
  }
  __syncthreads();
  if (t == 0) {
    if (s_sum[0]) atomicAdd(a.counts + kProbes, s_sum[0]);
    if (s_sum[1]) atomicAdd(a.counts + kMissed, s_sum[1]);
    if (s_sum[2]) atomicAdd(a.counts + kSuspicions, s_sum[2]);
    if (s_sum[3]) atomicAdd(a.counts + kNeedy, s_sum[3]);
  }
  // Arrive; the last block runs the slot step.
  unsigned* arrive = reinterpret_cast<unsigned*>(a.counts + kArrive);
  __syncthreads();
  if (t == 0) {
    s_last = add_release(arrive) == gridDim.x - 1u;
    if (s_last) fence_acquire();
  }
  __syncthreads();
  if (!s_last) return;
  slot_step(a, s_node, s_phase, rnd, first);
  if (t == 0) *arrive = 0u;
}

// slot_flag's rule on a slot's subject `node` (the wide slot step's, which
// reads it from memory).
__device__ __forceinline__ int32_t slot_flag_of(const Args& a, int32_t node,
                                                int64_t first) {
  if (node < 0) return 0;
  const int64_t i_s = mod(static_cast<int64_t>(min(node, a.N - 1)) - first,
                          a.N);
  return i_s < a.B ? __ldcg(a.flags + i_s) : 0;
}

// The wide form (S > kMaxSlots): lanes_slots_kernel's lanes as they are,
// the slot registers read in the slot step from memory at L2 and not
// staged (128 KB at S = 16,384: past the 48 KB static limit, one block an
// SM), the free slots by rank in the scratch's [S] words (a.free_slots)
// and set back to 0 after their reads, by the one block, between
// barriers.
__device__ __forceinline__ void slot_step_wide(const Args& a, int32_t rnd,
                                               int64_t first) {
  __shared__ int s_warp[kThreads / 32];
  int* const free_at = a.free_slots;
  const int t = static_cast<int>(threadIdx.x);
  const int32_t* const node = a.slot_node;
  // One round of loads: the first chunk's flags and candidates, the
  // counts and drops.  The launch writes no register before this, and a
  // slot's are read only by the thread that then writes them.
  const int32_t add0 = slot_flag_of(a, __ldcg(node + t), first);
  const int32_t cand0 = t < a.kk ? __ldcg(a.minima + t) : a.N;
  int32_t c[kNeedy + 1];
  uint32_t drops = 0u;
  if (t == 0) {
    for (int k = 0; k <= kNeedy; ++k) c[k] = __ldcg(a.counts + k);
    drops = static_cast<uint32_t>(*a.drops);
  }
  // The absorbs and rearms, and the free slots in ascending order.
  int n_free = 0;
  for (int s0 = 0; s0 < a.S; s0 += kThreads) {
    const int s = s0 + t;
    bool valid = false;
    if (s < a.S) {
      const int32_t nd = __ldcg(node + s);
      valid = nd >= 0;
      const int32_t node_c = min(max(nd, 0), a.N - 1);
      const int32_t add = s0 == 0 ? add0 : slot_flag_of(a, nd, first);
      bool rearm = false;
      if (add > 0) {
        const int32_t phase = __ldcg(a.slot_phase + s);
        if (phase == kSuspect) {
          a.slot_nsusp[s] += add;
        } else if (phase == kRefuted || phase == kJoin) {
          rearm = true;
          a.slot_phase[s] = kSuspect;
          a.slot_inc[s] = __ldg(a.incarnation + node_c);
          a.slot_start[s] = rnd;
          a.slot_nsusp[s] = add;
          a.slot_dead[s] = -1;
        }
      }
      a.rearm[s] = rearm ? 1 : 0;
    }
    int n;
    const bool free = s < a.S && !valid;
    const int rank = block_rank(free, s_warp, &n);
    if (free) free_at[n_free + rank] = s;
    n_free += n;
  }
  // The candidates take the free slots in rank order; the minima go back
  // to N.
  int n_dom = 0;
  for (int k0 = 0; k0 < a.kk; k0 += kThreads) {
    const int k = k0 + t;
    int32_t cand = k0 == 0 ? cand0 : a.N;
    if (k < a.kk) {
      if (k0 > 0) cand = __ldcg(a.minima + k);
      a.minima[k] = a.N;
    }
    int n;
    const bool in_dom = cand < a.N;
    const int rank = n_dom + block_rank(in_dom, s_warp, &n);
    if (in_dom && rank < n_free) {
      const int slot = free_at[rank];
      const int32_t cn = min(max(cand, 0), a.N - 1);
      a.slot_node[slot] = cn;
      a.slot_phase[slot] = kSuspect;
      a.slot_inc[slot] = __ldg(a.incarnation + cn);
      a.slot_start[slot] = rnd;
      a.slot_nsusp[slot] = 1;
      a.slot_dead[slot] = -1;
      a.slot_of_node[cn] = slot;
    }
    n_dom += n;
  }
  // The free slots' words back to 0, as every round leaves the scratch.
  __syncthreads();
  for (int k = t; k < n_free; k += kThreads) free_at[k] = 0;
  if (t == 0) {
    const int served = min(n_dom, n_free);
    for (int k = 0; k <= kNeedy; ++k) a.counts[k] = 0;
    *a.drops = static_cast<int32_t>(
        drops + static_cast<uint32_t>(c[kNeedy] - served));
    a.stats[kProbes] = c[kProbes];
    a.stats[kMissed] = c[kMissed];
    a.stats[kIndirect] = c[kMissed];
    a.stats[kSuspicions] = c[kSuspicions];
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
lanes_slots_wide_kernel(const __grid_constant__ Args a) {
  __shared__ int s_sum[4];
  __shared__ int s_last;
  const int t = static_cast<int>(threadIdx.x);
  const int32_t rnd = __ldg(a.rnd);
  const int64_t first = static_cast<int64_t>(__ldg(a.blk)) + __ldg(a.probe);
  if (t < 4) s_sum[t] = 0;
  // The lanes as lanes_slots_kernel runs them.
  unsigned n_ok = 0u, n_missed = 0u, n_init = 0u, n_need = 0u;
  const int chunks = (a.B + kThreads - 1) / kThreads;
  for (int c = static_cast<int>(blockIdx.x); c < chunks;
       c += static_cast<int>(gridDim.x)) {
    const int l = c * kThreads + t;
    const Lane r = lane(a, l);
    n_ok += r.ok;
    n_missed += r.missed;
    n_init += r.init;
    n_need += r.need;
    if (__syncthreads_or(r.need)) segment_minima(a, c, l, r.need, r.tgt);
  }
  n_ok = __reduce_add_sync(0xFFFFFFFFu, n_ok);
  n_missed = __reduce_add_sync(0xFFFFFFFFu, n_missed);
  n_init = __reduce_add_sync(0xFFFFFFFFu, n_init);
  n_need = __reduce_add_sync(0xFFFFFFFFu, n_need);
  if ((t & 31) == 0) {
    if (n_ok) atomicAdd(s_sum + 0, static_cast<int>(n_ok));
    if (n_missed) atomicAdd(s_sum + 1, static_cast<int>(n_missed));
    if (n_init) atomicAdd(s_sum + 2, static_cast<int>(n_init));
    if (n_need) atomicAdd(s_sum + 3, static_cast<int>(n_need));
  }
  __syncthreads();
  if (t == 0) {
    if (s_sum[0]) atomicAdd(a.counts + kProbes, s_sum[0]);
    if (s_sum[1]) atomicAdd(a.counts + kMissed, s_sum[1]);
    if (s_sum[2]) atomicAdd(a.counts + kSuspicions, s_sum[2]);
    if (s_sum[3]) atomicAdd(a.counts + kNeedy, s_sum[3]);
  }
  unsigned* arrive = reinterpret_cast<unsigned*>(a.counts + kArrive);
  __syncthreads();
  if (t == 0) {
    s_last = add_release(arrive) == gridDim.x - 1u;
    if (s_last) fence_acquire();
  }
  __syncthreads();
  if (!s_last) return;
  slot_step_wide(a, rnd, first);
  if (t == 0) *arrive = 0u;
}

// The rearm wipe and the marks (rearm_marks_kernel, step 2 at the top of
// this file): a lane's column is its thread's in every row, every other
// byte of a rearmed row the thread's that zeroes its unit.

// A 16-byte access to the matrix at p, which must be 16-byte aligned: the
// card faults otherwise, and the host build of this file (its tests) traps.
__device__ __forceinline__ uint4* at16(uint8_t* p) {
#ifndef __CUDA_ARCH__
  if ((reinterpret_cast<uintptr_t>(p) & 15u) != 0u) __builtin_trap();
#endif
  return reinterpret_cast<uint4*>(p);
}

// The first aligned column of the shard row starting at `row`: unit u of
// the row covers columns [a - 16 + 16 u, a + 16 u) (finish.cu's units).
__device__ __forceinline__ int phase_of(const uint8_t* row) {
  return static_cast<int>((0u - reinterpret_cast<uintptr_t>(row)) & 15u);
}

// Word q of the flags: lanes 4 q to 4 q + 3 (the flags start at a word of
// the scratch; bytes past B are masked off).  For each lane, the column of
// its prober in its shard (shard and local column, by 32-bit arithmetic:
// N < 2**30) and the row it marks: its target's slot, clamped to S - 1,
// or -1 where it marks nothing.  The word's slot loads are issued
// together.
struct Word {
  int32_t row[4];
  int shard[4];
  int col[4];
};

__device__ __forceinline__ Word word_of(const Args& a, int q, uint32_t w,
                                        int blk, int o_t) {
  if (4 * q + 4 > a.B) w &= (1u << (8 * (a.B - 4 * q))) - 1u;
  Word x;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // An initiating lane is a valid prober: its column is blk + l < N.
    const int c = blk + 4 * q + k;
    x.shard[k] = c / a.L;
    x.col[k] = c - x.shard[k] * a.L;
    x.row[k] = -1;
    if ((w >> (8 * k)) & 0xFFu) {
      int tgt = c + o_t;  // o_t in [0, N)
      if (tgt >= a.N) tgt -= a.N;
      const int32_t s2 = __ldg(a.slot_of_node + tgt);
      x.row[k] = s2 < 0 ? -1 : min(s2, a.S - 1);
    }
  }
  return x;
}

__device__ __forceinline__ uint8_t* at(const Args& a, const Word& x, int k,
                                       int row) {
  return a.heard[x.shard[k]] + static_cast<size_t>(row) * a.L + x.col[k];
}

// The marks of a word's lanes: each byte loaded, then the stores.  A byte
// of a rearmed row is marked here too, and rewritten by the same thread
// once the rearmed rows are known (lanes_in_rearmed).
__device__ __forceinline__ void mark_word(const Args& a, const Word& x) {
  uint32_t cur[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) cur[k] = x.row[k] >= 0 ? *at(a, x, k, x.row[k]) : 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (x.row[k] >= 0 && (cur[k] >> kMsgShift) <= kMsgSuspect) {
      *at(a, x, k, x.row[k]) =
          static_cast<uint8_t>(kFreshSuspect | (cur[k] & kConfBits));
    }
  }
}

// A word's lanes' columns (those below hi, N or the block's end) in the
// listed rearmed rows: the mark where the lane's row is that row, else 0.
__device__ __forceinline__ void lanes_in_rearmed(const Args& a, int q,
                                                 const Word& x,
                                                 const int* rows, int n,
                                                 int blk, int hi) {
  for (int j = 0; j < n; ++j) {
    const int r = rows[j];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (blk + 4 * q + k < hi) {
        *at(a, x, k, r) = x.row[k] == r ? static_cast<uint8_t>(kFreshSuspect)
                                        : uint8_t{0};
      }
    }
  }
}

// The unit of a rearmed row at shard i (its first column c0, of the
// shard row at `row`) zeroed but for the lanes' columns [blk, hi), which
// their owners write: one 16-byte store for a unit wholly in the row and
// outside them, else byte by byte.
__device__ __forceinline__ void wipe_unit(const Args& a, uint8_t* row, int i,
                                          int c0, int blk, int hi) {
  const int g0 = i * a.L + c0;
  if (c0 >= 0 && c0 <= a.L - kCols && (g0 + kCols <= blk || g0 >= hi)) {
    *at16(row + c0) = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  for (int k = 0; k < kCols; ++k) {
    const int g = g0 + k;
    if (c0 + k >= 0 && c0 + k < a.L && (g < blk || g >= hi)) row[c0 + k] = 0;
  }
}

// Warp 0 lists the rearmed rows of [lo, hi) (hi - lo <= kMaxSlots) in
// s_rows, in order, kListBallots ballots of 32 flags a round (at S = 64
// one round trip), the same list in every block; their count in *s_n.
__device__ __forceinline__ void list_rearmed(const Args& a, int* s_rows,
                                             int* s_n, int lo, int hi) {
  const int t = static_cast<int>(threadIdx.x);
  int n = 0;
  for (int r0 = lo; r0 < hi; r0 += 32 * kListBallots) {
    uint32_t f[kListBallots];
#pragma unroll
    for (int k = 0; k < kListBallots; ++k) {
      const int r = r0 + 32 * k + t;
      f[k] = r < hi ? __ldg(a.rearm + r) : 0u;
    }
#pragma unroll
    for (int k = 0; k < kListBallots; ++k) {
      const int r = r0 + 32 * k + t;
      const unsigned m = __ballot_sync(0xFFFFFFFFu, f[k] != 0u);
      if (f[k] != 0u) s_rows[n + __popc(m & ((1u << t) - 1u))] = r;
      n += __popc(m);
    }
  }
  if (t == 0) *s_n = n;
}

// The n_rows listed rearmed rows written: the lanes' columns [blk, hi) by
// their owners (a thread's words from q0 on, q0's word x0 as loaded, the
// rows of a later word loaded again), and every other column by the
// blocks over items of a listed row and a span of kThreads units of one
// shard, a unit a thread, items in row order from the last block down
// (the first blocks hold the marks).
__device__ __forceinline__ void write_rearmed(const Args& a, const int* rows,
                                              int n_rows, int q0,
                                              const Word& x0, int words,
                                              int stride, int blk, int o_t,
                                              int hi) {
  const int t = static_cast<int>(threadIdx.x);
  const uint32_t* flags = reinterpret_cast<const uint32_t*>(a.flags);
  if (q0 < words) {
    lanes_in_rearmed(a, q0, x0, rows, n_rows, blk, hi);
    for (int q = q0 + stride; q < words; q += stride) {
      lanes_in_rearmed(a, q, word_of(a, q, __ldg(flags + q), blk, o_t),
                       rows, n_rows, blk, hi);
    }
  }
  const int units = (a.L + kCols - 1) / kCols + 1;
  const int spans = (units + kThreads - 1) / kThreads;
  const int per_row = a.ndev * spans;
  for (int x = static_cast<int>(gridDim.x - 1 - blockIdx.x);
       x < per_row * n_rows; x += static_cast<int>(gridDim.x)) {
    const int j = x / per_row;
    const int i = (x - j * per_row) / spans;
    const int u = (x - j * per_row - i * spans) * kThreads + t;
    if (u >= units) continue;
    uint8_t* row = a.heard[i] + static_cast<size_t>(rows[j]) * a.L;
    const int c0 = phase_of(row) - kCols + kCols * u;
    if (c0 > -kCols && c0 < a.L) wipe_unit(a, row, i, c0, blk, hi);
  }
}

// kWide: S > kMaxSlots, the rearmed rows listed and written in chunks
// of kMaxSlots (a partition's heal can rearm thousands of rows at S =
// n).  Each chunk's rows are written by the same owners as in one
// listing, so every byte keeps its one writer thread, and a lane's own
// mark is still overwritten by its thread, after it.
template <bool kWide>
__device__ __forceinline__ void rearm_marks(const Args& a) {
  __shared__ int s_rows[kMaxSlots];  // the rearmed rows, in order
  __shared__ int s_n;
  const int t = static_cast<int>(threadIdx.x);
  const int blk = __ldg(a.blk);
  const int o_t = (__ldg(a.probe) % a.N + a.N) % a.N;
  const int hi = blk + a.B < a.N ? blk + a.B : a.N;
  // Warps 1 on take the marks, a word of 4 flags a thread, the first
  // word's flags loaded before anything else; warp 0 lists the rearmed
  // rows meanwhile (the wide form's first chunk).
  const int words = (a.B + 3) / 4;
  const int stride = static_cast<int>(gridDim.x) * kMarkThreads;
  const int q0 = t < 32 ? words
                        : static_cast<int>(blockIdx.x) * kMarkThreads + t - 32;
  const uint32_t* flags = reinterpret_cast<const uint32_t*>(a.flags);
  Word x0;
  if (q0 < words) {
    x0 = word_of(a, q0, __ldg(flags + q0), blk, o_t);
    mark_word(a, x0);
    for (int q = q0 + stride; q < words; q += stride) {
      mark_word(a, word_of(a, q, __ldg(flags + q), blk, o_t));
    }
  }
  if (!kWide) {
    if (t < 32) list_rearmed(a, s_rows, &s_n, 0, a.S);
    __syncthreads();
    const int n_rows = s_n;
    if (n_rows == 0) return;
    write_rearmed(a, s_rows, n_rows, q0, x0, words, stride, blk, o_t, hi);
    return;
  }
  for (int r0 = 0; r0 < a.S; r0 += kMaxSlots) {
    const int r1 = a.S - r0 < kMaxSlots ? a.S : r0 + kMaxSlots;
    if (t < 32) list_rearmed(a, s_rows, &s_n, r0, r1);
    __syncthreads();
    const int n_rows = s_n;
    if (n_rows != 0) {
      write_rearmed(a, s_rows, n_rows, q0, x0, words, stride, blk, o_t, hi);
    }
    __syncthreads();  // the next chunk lists over s_rows
  }
}

__global__ void __launch_bounds__(kThreads, kRearmBlocksPerSM)
rearm_marks_kernel(const __grid_constant__ Args a) {
  rearm_marks<false>(a);
}

__global__ void __launch_bounds__(kThreads, kRearmBlocksPerSM)
rearm_marks_wide_kernel(const __grid_constant__ Args a) {
  rearm_marks<true>(a);
}

// The launch's Args from the entry points' tables; false for arguments
// the kernels do not take.
inline bool setup(Args& a, void* const* shards, int ndev,
                  void* const* ptrs, const int* ints, const float* floats) {
  if (shards == nullptr || ptrs == nullptr || ints == nullptr ||
      floats == nullptr || ndev < 1 || ndev > kMaxShards) {
    return false;
  }
  const int N = ints[iN], B = ints[iB], S = ints[iS], K = ints[iK];
  if (N < 1 || N >= (1 << 30) || N % ndev != 0 || B < 1 || B > N ||
      S < 1 || S > kSlotCeiling || K < 0 || K > kMaxHelpers ||
      static_cast<int64_t>(B) * (K > 0 ? K : 1) >= (int64_t(1) << 32)) {
    return false;
  }
  for (int j = 0; j < ndev; ++j) {
    if (shards[j] == nullptr) return false;
    a.heard[j] = static_cast<uint8_t*>(shards[j]);
  }
  for (int k = 0; k < kNumPtrs; ++k) {
    // Null allowed: the Lifeguard registers (both or neither), and the
    // slot step's outputs outside the slot step.
    if (ptrs[k] == nullptr && k != kLhm && k != kStreak && k != kRearm &&
        k != kStats) {
      return false;
    }
  }
  if ((ptrs[kLhm] == nullptr) != (ptrs[kStreak] == nullptr)) return false;
  a.rnd = static_cast<const int32_t*>(ptrs[kRnd]);
  a.blk = static_cast<const int32_t*>(ptrs[kBlk]);
  a.probe = static_cast<const int32_t*>(ptrs[kProbe]);
  a.k_dl = static_cast<const int32_t*>(ptrs[kKdl]);
  a.k_hl = static_cast<const int32_t*>(ptrs[kKhl]);
  a.k_nem = static_cast<const int32_t*>(ptrs[kKnem]);
  a.mf = static_cast<const int32_t*>(ptrs[kMf]);
  a.slot_of_node = static_cast<int32_t*>(ptrs[kSlotOfNode]);
  a.lhm = static_cast<int32_t*>(ptrs[kLhm]);
  a.streak = static_cast<int32_t*>(ptrs[kStreak]);
  a.slot_node = static_cast<int32_t*>(ptrs[kSlotNode]);
  a.slot_phase = static_cast<int32_t*>(ptrs[kSlotPhase]);
  a.slot_inc = static_cast<int32_t*>(ptrs[kSlotInc]);
  a.slot_start = static_cast<int32_t*>(ptrs[kSlotStart]);
  a.slot_nsusp = static_cast<int32_t*>(ptrs[kSlotNsusp]);
  a.slot_dead = static_cast<int32_t*>(ptrs[kSlotDead]);
  a.incarnation = static_cast<const int32_t*>(ptrs[kIncarnation]);
  a.drops = static_cast<int32_t*>(ptrs[kDrops]);
  a.rearm = static_cast<uint8_t*>(ptrs[kRearm]);
  a.stats = static_cast<int32_t*>(ptrs[kStats]);
  a.N = N;
  a.B = B;
  a.S = S;
  a.K = K;
  a.ndev = ndev;
  a.L = N / ndev;
  a.kk = min(S, B);  // B <= N
  a.GB = (B + a.kk - 1) / a.kk;
  int32_t* scratch = static_cast<int32_t*>(ptrs[kScratch]);
  a.minima = scratch;
  a.counts = scratch + a.kk;
  a.flags = reinterpret_cast<uint8_t*>(scratch + a.kk + kCounts);
  a.free_slots = S > kMaxSlots ? scratch + a.kk + kCounts + (B + 3) / 4
                                  : nullptr;
  a.part = ints[iPart];
  a.degraded = ints[iDegraded];
  a.obs_lo = ints[iObsLo];
  a.obs_hi = ints[iObsHi];
  a.lhm_max = ints[iLhmMax];
  a.p_dl = floats[fDl];
  a.p_il = floats[fIl];
  a.p_one = floats[fOne];
  a.p_two = floats[fTwo];
  a.p_obs = floats[fObs];
  return a.part >= kNoPartition && a.part <= kHalves;
}

inline int lane_blocks(const Args& a) {
  return (a.B + kThreads - 1) / kThreads;
}

// The lanes_slots grid: one block a chunk, at most one wave of the
// blocks an SM the occupancy query gives on the current device for
// lanes_slots_kernel (the wide instance stages nothing in shared memory,
// so as many of its blocks fit an SM at least; it takes the same grid).
inline cudaError_t lanes_slots_grid(const Args& a, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, lanes_slots_kernel, kThreads, 0);
  }
  if (e != cudaSuccess) return e;
  if (sms < 1 || per_sm < 1) return cudaErrorInvalidConfiguration;
  const int chunks = lane_blocks(a);
  *blocks = chunks < sms * per_sm ? chunks : sms * per_sm;
  return cudaSuccess;
}

// The rearm_marks grid: the most items either half of the launch can
// have (a word of 4 flags a thread; a rearmed row's spans of kThreads units
// on every shard, S rows at most), at most one wave of kRearmBlocksPerSM
// blocks an SM (or what the occupancy query gives, if fewer).  Fixed at
// capture: the blocks find the rearmed rows inside it.
inline cudaError_t rearm_marks_grid(const Args& a, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rearm_marks_kernel, kThreads, 0);
  }
  if (e != cudaSuccess) return e;
  if (sms < 1 || per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long words = (a.B + 3) / 4;
  const long long units = (a.L + kCols - 1) / kCols + 1;
  const long long spans = (units + kThreads - 1) / kThreads;
  const long long most = std::max((words + kMarkThreads - 1) / kMarkThreads,
                                  spans * a.ndev * a.S);
  const long long wave =
      static_cast<long long>(sms) * std::min(per_sm, kRearmBlocksPerSM);
  *blocks = static_cast<int>(std::min(most, wave));
  return cudaSuccess;
}

}  // namespace probe

// The blocks of a probe_lanes_slots launch at B lanes on the current
// device (the occupancy query's wave, or fewer), or a negative CUDA error.
extern "C" int probe_lanes_slots_blocks(int B) {
  probe::Args a{};
  a.B = B;
  int blocks = 0;
  const cudaError_t e = probe::lanes_slots_grid(a, &blocks);
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
}

// The blocks of a probe_rearm_marks launch at (B, S, N, ndev) on the
// current device, or a negative CUDA error.
extern "C" int probe_rearm_marks_blocks(int B, int S, int N, int ndev) {
  probe::Args a{};
  a.B = B;
  a.S = S;
  a.ndev = ndev;
  a.L = ndev > 0 ? N / ndev : 0;
  int blocks = 0;
  const cudaError_t e = probe::rearm_marks_grid(a, &blocks);
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
}

// The scratch's int32 words at (S, B): kk = min(S, B) minima (N between
// rounds), the counts and the arrival counter (0 between rounds), B flag
// bytes; past kMaxSlots slots, S words more (the wide slot step's free
// slots, written before they are read in each launch).
extern "C" long long probe_scratch_words(int S, int B) {
  const int kk = S < B ? S : B;
  return static_cast<long long>(kk) + probe::kCounts + (B + 3) / 4 +
         (S > probe::kMaxSlots ? S : 0);
}

// The two launches of the top of this file.  Each takes the same
// arguments: `shards`, ndev pointers to the u8 [S, N / ndev] column shards
// of heard; `ptrs`, the probe::Ptr table (the round's row fields, the
// vectors, the outputs and the scratch; kLhm and kStreak both null without
// the Lifeguard registers); `ints`, the probe::Int table; `floats`, the
// float32 probabilities.  kRearm (u8 [S]) is probe_lanes_slots' output
// and probe_rearm_marks' input; kStats (int32 [4]) may be null for
// probe_rearm_marks.  Each launches on
// `stream`, does not synchronise, and returns cudaGetLastError() after the
// launch (or cudaErrorInvalidValue for arguments it does not take, or the
// occupancy query's error).
extern "C" int probe_lanes_slots(void* const* shards, int ndev,
                                 void* const* ptrs, const int* ints,
                                 const float* floats, void* stream) {
  using namespace probe;
  Args a{};
  if (!setup(a, shards, ndev, ptrs, ints, floats) || a.rearm == nullptr ||
      a.stats == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int blocks = 0;
  const cudaError_t e = lanes_slots_grid(a, &blocks);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (a.S > kMaxSlots) {
    lanes_slots_wide_kernel<<<blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(a);
  } else {
    lanes_slots_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_rearm_marks(void* const* shards, int ndev,
                                 void* const* ptrs, const int* ints,
                                 const float* floats, void* stream) {
  using namespace probe;
  Args a{};
  if (!setup(a, shards, ndev, ptrs, ints, floats) || a.rearm == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int blocks = 0;
  const cudaError_t e = rearm_marks_grid(a, &blocks);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (a.S > kMaxSlots) {
    rearm_marks_wide_kernel<<<blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(a);
  } else {
    rearm_marks_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* probe_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
