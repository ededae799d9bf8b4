// The round's probe tick, for Hopper (sm_90a): direct probe -> indirect
// probes -> suspicion initiation for the round's prober block, as three
// kernels and their C entry points.
//
// Replaces one stretch of the reference's jitted round that XLA fuses (no
// Pallas source): consul_tpu/gossip/kernel.py:519-822, `_probe_tick`, its
// draws (jax.random.uniform under the round's probe keys) included.  Before
// this the port ran it as ~184 torch launches a round, one of them a launch
// of threefry.cu; each kernel here is bit-identical to the plain torch
// version beside its wrapper (consul_tpu_torch/gossip/probe.py:
// probe_lanes_ref, probe_slots_ref, probe_marks_ref), which are the port's
// former expressions cut at these kernels' boundaries.
//
// The round's order, four launches (the third is finish.cu's wipe_rows):
//   1. lanes_kernel, a thread a prober lane, B = ceil(N / probe_every)
//      lanes, prober id pid = blk + lane (ids >= N are padding lanes, which
//      initiate nothing).  It reads the round's row (the round, the block,
//      the probe offsets, the keys) from device memory, and per lane: the
//      prober's liveness from mf (member ? fail_round : -1), its target
//      (pid + o_t) mod N, the direct probe's loss (a draw under k_dl), the
//      nemesis legs (the partition group in closed form: the top bit of
//      the product with 2654435761, or id >= N / 2; draws under the four
//      nemesis keys), the K helpers (draws under k_hl at element
//      lane * K + j), Lifeguard's LHM and streak, read and written in
//      place at pid, and, for a lane that would initiate, its target's
//      slot and the belief byte at (that slot, the prober's column)
//      through the shard table.  Out: a flag a lane (it initiates), the
//      segment minima of the needy targets over kk = min(S, N, B)
//      segments of GB = ceil(B / kk) lanes (by warp, then by block, then
//      one atomicMin a segment a block), and the four probe statistics
//      and the needy count (a block count each, one atomicAdd a block).
//   2. slots_kernel, one block, a thread a slot: the lanes that initiate
//      against a live slot's subject (the lane of subject x is (x - blk -
//      o_t) mod N) grow its suspicion count, or re-arm a REFUTED or JOIN
//      slot as a suspicion (a rearm flag a slot out, for the wipe); then
//      the candidates (the segment minima) take the free slots in
//      ascending slot order (the rank of each among the candidates, by
//      ballots), and slot_of_node points at them; drops count the needy
//      targets left unserved.  It resets the minima and counts.
//   3. wipe_rows (finish.cu) zeroes the rearmed rows.
//   4. marks_kernel, a thread a lane: an initiating lane reads its
//      target's slot after the allocation and marks its own belief byte
//      (SUSPECT, fresh age, the byte's confirmation count kept) where the
//      byte is at most SUSPECT after the wipe.  Lanes' columns are
//      distinct, so the marks are plain stores.
// The reference's order holds: the belief byte of step 1 is read before
// the wipe, the slot of step 4 after the allocation.
//
// Bound.  The lanes read mf at up to 2 + K points (the prober, the
// target, the helpers asked), slot_of_node and a belief byte where the
// lane would initiate, and write one flag: at most ~26 bytes a lane at K
// = 3, 5.2 MB at B = 200,000, ~1.6 us at 3.35 TB/s; the 1M churn path's
// data needs ~9 a lane.  A draw is ~52 issue slots of the busiest
// unit (sass_count.py --threefry), and a lane draws only where the draw
// decides something (the direct loss of a live, probed target; a helper's
// legs only for a prober whose direct probe failed; a probability of 0 or
// 1 draws nothing), so the main path's data needs few: the bytes bound it,
// and a launch costs more than either.  The slot step is S-sized; the
// marks read a flag a lane.  The design keeps the probe tick to four
// launches (the point: ~184 before) and reads everything once.
//
// Capture.  No launch reads the host or needs a memset: the row is read
// from device memory, and the scratch (the caller's, one per round
// program) holds the minima at N and the counts at 0 between rounds, set
// back by the slot step; the flags are written whole by every lanes
// launch.  So the four launches run inside the round program's captured
// graphs as they are.  One scratch serves one round at a time.

#include <cuda_runtime.h>

#include <cstdint>

#include "threefry.cuh"

namespace probe {

constexpr int kMaxShards = 64;
constexpr int kMaxSlots = 1024;   // slots: a thread each in one block
constexpr int kMaxHelpers = 64;
constexpr int kThreads = 256;
// The scratch: kk int32 minima, then kCounts int32 counts, then B flag
// bytes.
constexpr int kCounts = 8;
enum Count { kProbes = 0, kMissed, kIndirect, kSuspicions, kNeedy };
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
  uint8_t* rearm;              // [S] out
  int32_t* stats;              // [4] out
  int32_t* minima;             // scratch: [kk]
  int32_t* counts;             //   [kCounts]
  uint8_t* flags;              //   [B]
  int N, B, S, K, L, ndev, kk, GB, slot_threads;
  int part, degraded, obs_lo, obs_hi, lhm_max;
  float p_dl, p_il, p_one, p_two, p_obs;
};

__device__ __forceinline__ int64_t mod(int64_t a, int64_t n) {
  const int64_t r = a % n;
  return r < 0 ? r + n : r;
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

// The needy targets' minima into the kk segments of GB lanes, for a
// block with a needy lane (every thread takes part): a warp whose lanes
// lie in at most two segments takes each one's minimum by
// __reduce_min_sync (GB >= 32: every warp), a straddling warp's needy
// lanes go one by one; into the block's segments in shared memory, then
// one atomicMin a segment the block touches.  So a round's many needy
// lanes (a partition's crossed probes) contend on the kk words by
// block, not by lane.
__device__ __forceinline__ void segment_minima(const Args& a, int l,
                                               bool need, int32_t tgt) {
  __shared__ int32_t s_min[kThreads];  // the block's segments, from seg0
  const int t = static_cast<int>(threadIdx.x);
  const int seg0 = static_cast<int>(blockIdx.x) * kThreads / a.GB;
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

__global__ void __launch_bounds__(kThreads)
lanes_kernel(const __grid_constant__ Args a) {
  const int l = static_cast<int>(blockIdx.x) * kThreads +
                static_cast<int>(threadIdx.x);
  bool ok = false, missed = false, init = false, need = false;
  int64_t tgt = 0;
  if (l < a.B) {
    const int32_t rnd = __ldg(a.rnd);
    const int64_t N = a.N;
    const int64_t pid = static_cast<int64_t>(__ldg(a.blk)) + l;
    const bool pvalid = pid < N;
    ok = pvalid && __ldg(a.mf + mod(pid, N)) > rnd;
    bool member = false, rescued = false;
    int32_t s_t = -1;
    if (ok) {
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
      missed = member && lost;
      // The helpers decide only for a prober whose direct probe failed
      // (and rescue only a live target).
      if (missed && alive && a.K > 0) {
        rescued = rescued_by_helpers(a, l, pid, rnd, g_p, g_t, deg);
      }
      init = missed && !rescued;
    }
    if (a.lhm != nullptr && pvalid) {
      // Lifeguard: suspect only after more consecutive direct misses
      // than the prober's LHM; LHM up on a miss the helpers contradict,
      // down on a clean probe.
      const int32_t lhm_b = a.lhm[pid], streak_b = a.streak[pid];
      const int32_t streak_new =
          missed ? min(streak_b + 1, a.lhm_max + 1) : 0;
      init = init && streak_new > lhm_b;
      const int32_t lhm_new =
          max(0, min(a.lhm_max, lhm_b + int(missed && rescued) -
                                    int(ok && member && !missed)));
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
    need = init && s_t < 0;
    a.flags[l] = init ? 1 : 0;
  }
  // The block's counts, one atomic each (every thread takes part).
  const int n_ok = __syncthreads_count(ok);
  const int n_missed = __syncthreads_count(missed);
  const int n_init = __syncthreads_count(init);
  const int n_need = __syncthreads_count(need);
  if (threadIdx.x == 0) {
    if (n_ok) atomicAdd(a.counts + kProbes, n_ok);
    if (n_missed) {
      // A failed direct probe of a member escalates to the helpers: the
      // acks missed and the indirect escalations are the same lanes.
      atomicAdd(a.counts + kMissed, n_missed);
      atomicAdd(a.counts + kIndirect, n_missed);
    }
    if (n_init) atomicAdd(a.counts + kSuspicions, n_init);
    if (n_need) atomicAdd(a.counts + kNeedy, n_need);
  }
  if (n_need) segment_minima(a, l, need, static_cast<int32_t>(tgt));
}
// The exclusive rank of this thread's `pred` among the block's threads
// (warp ballots, then the warps' totals) and, in *total, their count.
__device__ __forceinline__ int block_rank(bool pred, int nthreads,
                                          int* s_warp, int* total) {
  const int t = static_cast<int>(threadIdx.x);
  const int lane = t & 31, w = t >> 5;
  const unsigned m = __ballot_sync(0xFFFFFFFFu, pred);
  if (lane == 0) s_warp[w] = __popc(m);
  __syncthreads();
  int base = 0, sum = 0;
  for (int i = 0; i < nthreads / 32; ++i) {
    const int c = s_warp[i];
    if (i < w) base += c;
    sum += c;
  }
  __syncthreads();
  *total = sum;
  return base + __popc(m & ((1u << lane) - 1u));
}

__global__ void __launch_bounds__(kMaxSlots)
slots_kernel(const __grid_constant__ Args a) {
  __shared__ int s_free[kMaxSlots];  // the free slots by rank
  __shared__ int s_warp[kMaxSlots / 32];
  const int t = static_cast<int>(threadIdx.x);
  const int32_t rnd = __ldg(a.rnd);
  const int64_t N = a.N;
  bool valid = false;
  if (t < a.S) {
    // A lane that initiates against a live slot's subject: at most one a
    // subject (the round's targets are distinct).
    const int32_t node = a.slot_node[t];
    valid = node >= 0;
    const int32_t node_c = min(max(node, 0), a.N - 1);
    const int64_t i_s = mod(static_cast<int64_t>(node_c) - __ldg(a.blk) -
                                __ldg(a.probe),
                            N);
    const int32_t add = valid && i_s < a.B ? a.flags[i_s] : 0;
    const int32_t phase = a.slot_phase[t];
    bool rearm = false;
    if (add > 0) {
      if (phase == kSuspect) {
        a.slot_nsusp[t] += add;  // an existing episode absorbs it
      } else if (phase == kRefuted || phase == kJoin) {
        // Re-arm as a suspicion at the bumped incarnation.
        rearm = true;
        a.slot_phase[t] = kSuspect;
        a.slot_inc[t] = __ldg(a.incarnation + node_c);
        a.slot_start[t] = rnd;
        a.slot_nsusp[t] = add;
        a.slot_dead[t] = -1;
      }
    }
    a.rearm[t] = rearm ? 1 : 0;
  }
  // The free slots in ascending order.
  int n_free;
  const bool free = t < a.S && !valid;
  const int rank_free = block_rank(free, a.slot_threads, s_warp, &n_free);
  if (free) s_free[rank_free] = t;
  // The candidates (the segment minima; N: none), ranked; the scratch
  // goes back to N.
  int32_t cand = a.N;
  if (t < a.kk) {
    cand = a.minima[t];
    a.minima[t] = a.N;
  }
  int n_dom;
  const bool in_dom = t < a.kk && cand < a.N;
  const int rank = block_rank(in_dom, a.slot_threads, s_warp, &n_dom);
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
  if (t == 0) {
    const int served = min(n_dom, n_free);
    // drops wraps mod 2**32, as the reference's counter does.
    *a.drops = static_cast<int32_t>(
        static_cast<uint32_t>(*a.drops) +
        static_cast<uint32_t>(a.counts[kNeedy] - served));
    for (int k = 0; k < 4; ++k) a.stats[k] = a.counts[k];
    for (int k = 0; k < kCounts; ++k) a.counts[k] = 0;
  }
}

__global__ void __launch_bounds__(kThreads)
marks_kernel(const __grid_constant__ Args a) {
  const int l = static_cast<int>(blockIdx.x) * kThreads +
                static_cast<int>(threadIdx.x);
  if (l >= a.B || a.flags[l] == 0) return;
  // An initiating lane is a valid prober: its column is pid.
  const int64_t pid = static_cast<int64_t>(__ldg(a.blk)) + l;
  const int32_t s2 = a.slot_of_node[mod(pid + __ldg(a.probe), a.N)];
  if (s2 < 0) return;
  uint8_t* p = byte_at(a, min(s2, a.S - 1), pid);
  const uint32_t cur = *p;
  if ((cur >> kMsgShift) <= kMsgSuspect) {
    *p = static_cast<uint8_t>(kFreshSuspect | (cur & kConfBits));
  }
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
      S < 1 || S > kMaxSlots || K < 0 || K > kMaxHelpers ||
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
  a.slot_threads = (S + 31) / 32 * 32;
  int32_t* scratch = static_cast<int32_t*>(ptrs[kScratch]);
  a.minima = scratch;
  a.counts = scratch + a.kk;
  a.flags = reinterpret_cast<uint8_t*>(scratch + a.kk + kCounts);
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

}  // namespace probe

// The scratch's int32 words at (S, B): kk = min(S, B) minima (N between
// rounds), the counts (0 between rounds), B flag bytes.
extern "C" long long probe_scratch_words(int S, int B) {
  const int kk = S < B ? S : B;
  return static_cast<long long>(kk) + probe::kCounts + (B + 3) / 4;
}

// The three launches of the top of this file.  Each takes the same
// arguments: `shards`, ndev pointers to the u8 [S, N / ndev] column shards
// of heard; `ptrs`, the probe::Ptr table (the round's row fields, the
// vectors, the outputs and the scratch; kLhm and kStreak both null without
// the Lifeguard registers); `ints`, the probe::Int table; `floats`, the
// float32 probabilities.  kRearm and kStats (the slot step's outputs: u8
// [S] and int32 [4]) may be null outside probe_slots.  Each launches on
// `stream`, does not synchronise,
// and returns cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for arguments it does not take).
extern "C" int probe_lanes(void* const* shards, int ndev, void* const* ptrs,
                           const int* ints, const float* floats,
                           void* stream) {
  using namespace probe;
  Args a{};
  if (!setup(a, shards, ndev, ptrs, ints, floats)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  lanes_kernel<<<lane_blocks(a), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_slots(void* const* shards, int ndev, void* const* ptrs,
                           const int* ints, const float* floats,
                           void* stream) {
  using namespace probe;
  Args a{};
  if (!setup(a, shards, ndev, ptrs, ints, floats) || a.rearm == nullptr ||
      a.stats == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  slots_kernel<<<1, a.slot_threads, 0,
                 static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_marks(void* const* shards, int ndev, void* const* ptrs,
                           const int* ints, const float* floats,
                           void* stream) {
  using namespace probe;
  Args a{};
  if (!setup(a, shards, ndev, ptrs, ints, floats)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  marks_kernel<<<lane_blocks(a), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* probe_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
