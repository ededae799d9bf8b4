// The finish step's slot logic, for Hopper (sm_90a): refutation, the timer
// mask, verdicts, detection statistics, the slot GC decision, the hist
// banks' adds and the register writes, as three one-block kernels and their
// C entry points.
//
// Replaces one stretch of the reference's jitted round that XLA fuses (no
// Pallas source): consul_tpu/gossip/kernel.py:1461-1672, `_finish_round`,
// everything in it but the belief-matrix passes (the refutation byte and
// the timer fire, the GC wipe: csrc/finish.cu) and the spread's count
// (csrc/observe.cu).  Before this the port ran it as ~113 torch launches a
// round over [H] vectors; each kernel here is bit-identical to the plain
// torch version beside its wrapper (consul_tpu_torch/gossip/
// finish_slots.py: finish_decide_ref, finish_settle_ref,
// finish_record_ref), the port's former expressions cut at these kernels'
// boundaries.
//
// The rows.  The step works on H rows, row h the slot idx[h] (distinct slot
// ids, H <= S): the full tail passes every slot, the hot tier its
// live ones padded with free ones.  Registers are read and written at
// idx[h]; the belief rows (heard_sub: ndev column shards, u8 [H, L] each)
// by h.  node_c = clamp(slot_node, 0, N - 1), as the reference scatters
// and gathers at it: a flag that is false drops the scatter, so a padding
// row (slot_node -1, phase FREE) changes nothing, and no row is skipped for
// its node.
//
// The round's order, six launches (the second, fifth and sixth are not
// here):
//   1. decide_kernel, a thread a row: where the round refutes, the row's
//      own byte heard_sub[h, node_c] (on the shard that owns the column,
//      through the shard table) and the refutation test; a refuting row
//      bumps incarnation[node_c] (an atomic: rows may share node_c),
//      becomes REFUTED at dead round rnd, and with the Lifeguard registers
//      bumps lhm[node_c], clamped at lhm_max; n_refuted grows by the
//      block's count.  Out: the fire pass's inputs, a 4-bit timer mask a
//      row (bit c: the timer of a SUSPECT slot has run out at confirmation
//      count c, from the timeout table and conf_cap[idx[h]], after the
//      refutation) and the refutation's column and byte (0: none).
//      A programmatic dependent launch (cudaLaunchKernelEx with
//      cudaLaunchAttributeProgrammaticStreamSerialization; `programmatic`
//      below): it may start
//      while the kernel before it runs, once that kernel triggers
//      (dissem_tail.cu's tail triggers griddepcontrol.launch_dependents
//      as it starts) or its blocks have ended, and griddepcontrol.wait
//      (cudaGridDependencySynchronize) then waits for that kernel to end
//      with its writes visible.  Its loads come in three rounds of
//      independent loads (the round and idx[h]; the slot's node, phase,
//      start and conf_cap; the subject's alive and member flags), all
//      before the wait; only the own byte and every write come after it.
//      The refutation and the timer mask come from registers, the bumps
//      are fire-and-forget atomics.  The launch's contract: the kernel
//      launched just before it on the stream writes none of its inputs
//      but the belief rows.  The round keeps it: decide follows the tail
//      (fused_dissem, fused_merge, or on the hot path the tail on the
//      gathered rows) or a push/pull round's last take, each writing only
//      heard_sub, with no kernel between (the step's tensors are made
//      with torch.empty), and every other input was written before that
//      kernel began (the slot registers by the probe tick; alive,
//      member, conf_cap, LHM, idx and the round's row earlier in the
//      round), and a launch that is not programmatic starts only after
//      the kernel before it has ended.  A caller whose kernel before may
//      write decide's other inputs synchronises first.  Loading first
//      makes the tail -> decide pair about 0.002 ms shorter than waiting
//      first on an H100 (tools/torch_pair_ab.py, PERF.md).  In the round
//      program the capture keeps the programmatic edge inside its
//      segment graph, the child graph and the IF node's body
//      (chip_smoke.py --phase finish_slots reads the joined graph's
//      edges).
//   2. fire_timers (finish.cu): the refutation byte, the fire, fired [H];
//      it triggers griddepcontrol.launch_dependents as it starts.
//   3. settle_kernel: where fired, the slot becomes DEAD (its dead round
//      rnd where it had none: a new verdict); a new verdict counts as a
//      detection (its subject failed by rnd; the rounds since added) or a
//      false dead; the GC decision (the verdict spread for two budgets and
//      8 rounds, or the slot's TTL ran out).  Out: the expired flags a
//      row (the wipe's), the row's marks (detected, new verdict, a dead
//      subject dropped) and with the hist banks the spread's want mask and
//      verdict message (observe.cu's count).  A programmatic dependent
//      launch as decide's, behind the fire: its loads in three rounds of
//      independent loads (the round and idx[h]; the slot's node, phase,
//      dead round and start; the subject's fail round), all before
//      griddepcontrol.wait; only fired and every write after it.  The
//      launch's contract: the kernel launched just before it writes none
//      of its inputs but fired.  The round keeps it: settle follows the
//      fire with no kernel between (the outputs are made with
//      torch.empty), the fire writes only the belief rows, the refutation
//      byte, fired and its scratch, and decide, which writes slot_phase
//      and slot_dead, ended before the fire began (the fire is a plain
//      launch).  A caller whose kernel before settle may write settle's
//      other inputs synchronises first.
//   4. heard_counts (observe.cu), only with the hist banks: the members
//      holding each expiring row's verdict, before the drop and the wipe;
//      it triggers griddepcontrol.launch_dependents as it starts.
//   5. record_kernel: with the hist banks, the four adds (detect, dwell,
//      refute and the spread's bit length of its holders), each value
//      clipped into the top bucket, duplicates summed in shared memory and
//      one global add a touched bucket; a dead subject's member flag
//      dropped; an expired slot's slot_of_node entry, node, phase and dead
//      round reset.  With the banks (the holders given) a programmatic
//      dependent launch as decide's, behind the spread's count: it zeroes
//      its buckets and makes its loads in three rounds of independent loads
//      (the row's slot id, marks, expired and spread flags, refutation byte
//      and the round; the slot's node and start; the subject's fail round)
//      before griddepcontrol.wait; only the holders and every write come
//      after it, and so the member drop comes after the count has read
//      member.  The launch's contract: the kernel launched just before it
//      writes none of its inputs but the holders.  The round keeps it:
//      record follows the count with no kernel between (the holders are a
//      row of the count's output), the count writes only its output and
//      its scratch, and every other input was written before the count
//      began (by settle, decide, the probe tick).  Without the banks record
//      follows settle, which writes its marks and flags: there it is a
//      plain launch, which starts after settle has ended.
//   6. wipe_rows (finish.cu): the expired rows zeroed.
// The reference's order holds: the own byte is read after the tail and
// push/pull and before the fire, the mask is built after the refutation,
// and member and the matrix are read by the count before the drop and the
// wipe.
//
// Wrap.  The four counters and the banks wrap mod 2**32 as the reference's
// int32 sums do: every add is unsigned, every difference of rounds is taken
// mod 2**32 as an int32 one.
//
// Bound.  A row reads five registers and a few [N] entries and writes a
// few bytes: at S = 64 about 3 KB a launch, under a microsecond at
// 3.35 TB/s; a launch costs more.  The design's point is three launches
// where the port made ~113, and for each of the three, a chain of
// dependent loads and a launch that overlap the kernel before (the tail,
// the fire, the spread's count).
//
// Capture.  No launch reads the host or needs a memset: the round is read
// from its row in device memory, the statics (the budget, the TTL, the
// timeout table, lhm_max) are launch arguments that no round changes, and
// every output is written whole for its H rows.  So the launches run
// inside the round program's captured graphs as they are.
//
// Wide S.  Up to kMaxRows (1,024) rows a thread takes a row, in a block of
// H threads rounded up to a warp, as above.  Past it (the reference's own
// provisioning: crossval.loss_sized_slots gives 8,192 slots at n = 1M and
// 5 % loss, a nemesis run up to next_pow2(n)) the host picks each
// kernel's wide instance (decide_wide_kernel, settle_wide_kernel,
// record_wide_kernel): one block of kMaxRows threads, thread t the rows
// t, t + kMaxRows, ...  The launch contract holds as it is: the first
// row's loads before griddepcontrol.wait, the later rows' loads and every
// write after it (no row reads another row's slot, and the kernel before
// has ended by then).  __syncthreads_count becomes a count a thread summed
// over the block in shared memory; record's shared buckets are unchanged.
// At H = 16,384 a thread walks 16 rows, a chain of loads each; the rows
// are the slots' registers, ~50 bytes a row, so a launch moves ~0.8 MB.

#include <cuda_runtime.h>

#include <cstdint>

namespace finish_slots {

constexpr int kMaxShards = 64;
constexpr int kMaxRows = 1024;     // a block's threads: a row each, or
                                   // (the wide form) several
// Slots (and rows) a launch takes: slot ids and row numbers stay far
// inside an int, and the step's [H] outputs inside one allocation.
constexpr int kMaxSlots = 1 << 24;
constexpr int kMaxBuckets = 256;   // the largest bank (LATENCY_BUCKETS)
enum Phase { kFree = 0, kSuspect = 1, kDeadPhase = 2, kRefuted = 3,
             kJoin = 4 };
// The belief byte: msg:2 | conf:2 | age:4 (gossip/belief.py).
constexpr uint32_t kMsgShift = 6;
constexpr int32_t kMsgSuspect = 1;
constexpr int32_t kMsgDead = 2;
constexpr int32_t kMsgRefute = 3;
constexpr uint8_t kRefuteByte = 0xC0;  // REFUTE, conf 0, age 0
// A row's marks (settle_kernel's, for record_kernel).
enum Mark { kDetected = 1, kNewVerdict = 2, kDropped = 4 };
enum Bank { kDetect = 0, kDwell, kRefute, kSpread, kBanks };

// The pointer table's entries (finish_slots.py's _PTRS order).
enum Ptr {
  kRnd = 0, kIdx, kSlotNode, kSlotPhase, kSlotStart, kSlotDead, kConfCap,
  kAlive, kMember, kFail, kSlotOfNode, kIncarnation, kLhm, kNDetected,
  kSumDetect, kNFalseDead, kNRefuted, kOkMask, kRefCol, kRefByte, kFired,
  kExpired, kMarks, kSpreadWant, kVerdict, kNHold, kHistDetect, kHistDwell,
  kHistRefute, kHistSpread, kNumPtrs
};
// The integer arguments (finish_slots.py's _INTS order).
enum Int {
  iN = 0, iH, iS, iRefute, iBudget, iTtl, iLhmMax, iTbl0, iTbl1, iTbl2,
  iTbl3, iLatBuckets, iSpreadBuckets, kNumInts
};

// Everything a launch needs, by value (about 800 bytes of the 4 KB
// parameter block) as a __grid_constant__.
struct Args {
  const uint8_t* heard[kMaxShards];  // ndev shards, u8 [H, L] each
  const int32_t* rnd;          // the round's row: the round
  const int32_t* idx;          // [H] distinct slot ids
  int32_t* slot_node;          // [S] each
  int32_t* slot_phase;
  const int32_t* slot_start;
  int32_t* slot_dead;
  const int32_t* conf_cap;     // [S]
  const uint8_t* alive;        // [N] bool
  uint8_t* member;             // [N] bool
  const int32_t* fail;         // [N] fail_round
  int32_t* slot_of_node;       // [N]
  int32_t* incarnation;        // [N]
  int32_t* lhm;                // [N] or null (no Lifeguard registers)
  int32_t* n_detected;         // [1] each
  int32_t* sum_detect;
  int32_t* n_false_dead;
  int32_t* n_refuted;
  uint8_t* ok_mask;            // [H] decide's outputs
  int32_t* ref_col;            //   (null without the refutation)
  uint8_t* ref_byte;
  const uint8_t* fired;        // [H] fire_timers'
  uint8_t* expired;            // [H] settle's outputs
  uint8_t* marks;
  uint8_t* spread_want;        //   (null without the hist banks)
  int32_t* verdict;
  const int32_t* n_hold;       // [H] heard_counts' hold row
  int32_t* hist[kBanks];       // the banks, or all null
  int N, H, S, L, ndev, threads, refute, budget, ttl, lhm_max;
  int tbl[4];                  // the timeout table at conf 0..3
  int buckets[kBanks];
};

__device__ __forceinline__ int32_t sub32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ void add32(int32_t* p, uint32_t v) {
  *p = static_cast<int32_t>(static_cast<uint32_t>(*p) + v);
}

__device__ __forceinline__ int32_t clamp_node(int32_t node, int N) {
  return min(max(node, 0), N - 1);
}

// The belief byte at (row, global column c), through the shard table.
__device__ __forceinline__ uint32_t byte_at(const Args& a, int row,
                                            int32_t c) {
  const int i = c / a.L;
  return a.heard[i][static_cast<size_t>(row) * a.L + (c - i * a.L)];
}

// Waits for the kernel before this one on the stream (the grid this
// launch depends on programmatically) to complete and its writes to be
// visible: griddepcontrol.wait (cudaGridDependencySynchronize).  At once
// where that kernel has ended, and where the launch was not programmatic.
__device__ __forceinline__ void wait_for_primary() {
#ifdef __CUDA_ARCH__
  asm volatile("griddepcontrol.wait;" ::: "memory");
#endif
}

__global__ void __launch_bounds__(kMaxRows)
decide_kernel(const __grid_constant__ Args a) {
  const int h = static_cast<int>(threadIdx.x);
  // Every load but the own byte, before the wait, in three rounds of
  // independent loads: the round and the slot id; the slot's registers;
  // the subject's flags.  The kernel before this one writes none of them
  // (the launch's contract, finish_decide below).
  bool live = false;  // a row of the H
  int s = 0;
  int32_t rnd = 0, node = -1, node_c = 0, phase = kFree, start = 0, cc = 0;
  bool alive = false, member = false;
  if (h < a.H) {
    live = true;
    rnd = __ldg(a.rnd);
    s = __ldg(a.idx + h);
    node = a.slot_node[s];
    phase = a.slot_phase[s];
    start = __ldg(a.slot_start + s);
    cc = max(__ldg(a.conf_cap + s), 0);  // in [0, max_conf]
    node_c = clamp_node(node, a.N);
    if (a.refute) {
      alive = __ldg(a.alive + node_c) != 0;
      member = a.member[node_c] != 0;
    }
  }
  // The kernel before's output (the own byte), and every write, after
  // the wait.
  wait_for_primary();
  bool refute_now = false;
  if (live) {
    if (a.refute) {
      // A live subject that hears of its own suspicion refutes it.
      const int32_t own = static_cast<int32_t>(byte_at(a, h, node_c) >>
                                               kMsgShift);
      refute_now = (phase == kSuspect || phase == kDeadPhase) && node >= 0 &&
                   alive && member &&
                   (own == kMsgSuspect || own == kMsgDead);
      if (refute_now) {
        atomicAdd(a.incarnation + node_c, 1);
        phase = kRefuted;
        a.slot_phase[s] = kRefuted;
        a.slot_dead[s] = rnd;
        if (a.lhm != nullptr) {
          // Lifeguard: the refuter's own LHM rises, clamped.
          atomicAdd(a.lhm + node_c, 1);
          atomicMin(a.lhm + node_c, a.lhm_max);
        }
      }
      a.ref_col[h] = node_c;
      a.ref_byte[h] = refute_now ? kRefuteByte : 0;
    }
    // The timer mask: bit c where a SUSPECT slot's timer has run out at
    // confirmation count c (the table at min(c, conf_cap)).
    uint32_t ok = 0;
    if (phase == kSuspect) {
      const int32_t elapsed = sub32(rnd, start);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (elapsed >= a.tbl[min(c, cc)]) ok |= 1u << c;
      }
    }
    a.ok_mask[h] = static_cast<uint8_t>(ok);
  }
  const int n = __syncthreads_count(refute_now);
  if (threadIdx.x == 0 && n != 0) add32(a.n_refuted, n);
}

__global__ void __launch_bounds__(kMaxRows)
settle_kernel(const __grid_constant__ Args a) {
  __shared__ uint32_t s_rounds;  // the detections' rounds, summed
  const int h = static_cast<int>(threadIdx.x);
  if (h == 0) s_rounds = 0u;
  // Every load but fired, before the wait, in three rounds of independent
  // loads: the round and the slot id; the slot's registers; the subject's
  // fail round.  The kernel before this one (the fire) writes none of them
  // (the launch's contract, finish_settle below).
  const bool live = h < a.H;
  int s = 0;
  int32_t rnd = 0, node_c = 0, phase = kFree, dead = -1, start = 0;
  int32_t fail_c = 0;
  if (live) {
    rnd = __ldg(a.rnd);
    s = __ldg(a.idx + h);
    node_c = clamp_node(a.slot_node[s], a.N);
    phase = a.slot_phase[s];
    dead = a.slot_dead[s];
    start = __ldg(a.slot_start + s);
    fail_c = __ldg(a.fail + node_c);
  }
  // The kernel before's output (fired), and every write, after the wait.
  wait_for_primary();
  __syncthreads();  // s_rounds zeroed
  bool detected = false, false_dead = false;
  if (live) {
    const bool fired = a.fired[h] != 0;
    // Fired on any shard: dead declared, a new verdict where none was.
    const bool new_verdict = fired && dead < 0;
    if (fired) {
      phase = kDeadPhase;
      if (new_verdict) dead = rnd;
      a.slot_phase[s] = phase;
      a.slot_dead[s] = dead;
    }
    // Detection statistics at declaration time.
    detected = new_verdict && fail_c <= rnd;
    false_dead = new_verdict && !(fail_c <= rnd);
    if (detected) {
      atomicAdd(&s_rounds, static_cast<uint32_t>(sub32(rnd, fail_c)));
    }
    // Episode GC: the verdict has spread, or the slot's TTL ran out.
    const bool verdict_done =
        (phase == kDeadPhase || phase == kRefuted || phase == kJoin) &&
        dead >= 0 && sub32(rnd, dead) > 2 * a.budget + 8;
    const bool expired =
        phase > kFree && (sub32(rnd, start) > a.ttl || verdict_done);
    const bool dropped = expired && phase == kDeadPhase;
    a.expired[h] = expired ? 1 : 0;
    a.marks[h] = static_cast<uint8_t>((detected ? kDetected : 0) |
                                      (new_verdict ? kNewVerdict : 0) |
                                      (dropped ? kDropped : 0));
    if (a.spread_want != nullptr) {
      a.spread_want[h] = expired && dead >= 0 ? 1 : 0;
      a.verdict[h] = phase == kDeadPhase ? kMsgDead : kMsgRefute;
    }
  }
  const int n_det = __syncthreads_count(detected);
  const int n_false = __syncthreads_count(false_dead);
  if (threadIdx.x == 0) {
    if (n_det != 0) {
      add32(a.n_detected, n_det);
      add32(a.sum_detect, s_rounds);
    }
    if (n_false != 0) add32(a.n_false_dead, n_false);
  }
}

// The bit length of a count (0 for 0 or less): its spread bucket.
__device__ __forceinline__ int32_t bit_length(int32_t n) {
  return n > 0 ? 32 - __clz(n) : 0;
}

__device__ __forceinline__ void bucket(uint32_t* bank, int B, int32_t v) {
  atomicAdd(bank + min(max(v, 0), B - 1), 1u);
}

__global__ void __launch_bounds__(kMaxRows)
record_kernel(const __grid_constant__ Args a) {
  __shared__ uint32_t s_bank[kBanks][kMaxBuckets];
  const int h = static_cast<int>(threadIdx.x);
  const bool hist = a.hist[kDetect] != nullptr;
  if (hist) {
    for (int k = 0; k < kBanks; ++k) {
      for (int b = h; b < a.buckets[k]; b += a.threads) s_bank[k][b] = 0u;
    }
  }
  // Every load but the holders, before the wait, in three rounds of
  // independent loads: the row's slot id, flags and marks (and the round);
  // the slot's registers; the subject's fail round.  The kernel before
  // this one writes none of them (the launch's contract, finish_record
  // below).
  const bool live = h < a.H;
  int s = 0;
  int32_t node_c = 0, rnd = 0, start = 0, fail_c = 0;
  uint32_t m = 0;
  bool expired = false, refute_now = false, spread = false;
  if (live) {
    s = a.idx[h];
    m = a.marks[h];
    expired = a.expired[h] != 0;
    if (hist) {
      rnd = __ldg(a.rnd);
      refute_now = a.ref_byte != nullptr && a.ref_byte[h] != 0;
      spread = a.spread_want[h] != 0;
      start = a.slot_start[s];
    }
    node_c = clamp_node(a.slot_node[s], a.N);
    if (hist) fail_c = __ldg(a.fail + node_c);
  }
  // The kernel before's output (the holders), and every write, after the
  // wait: that kernel reads member, which a dropped subject's flag clears.
  wait_for_primary();
  if (hist) __syncthreads();  // the banks' buckets zeroed
  if (live) {
    if (hist) {
      const int32_t dwell = sub32(rnd, start);
      if (m & kDetected) {
        bucket(s_bank[kDetect], a.buckets[kDetect], sub32(rnd, fail_c));
      }
      if ((m & kNewVerdict) || refute_now) {
        bucket(s_bank[kDwell], a.buckets[kDwell], dwell);
      }
      if (refute_now) bucket(s_bank[kRefute], a.buckets[kRefute], dwell);
      if (spread) {
        bucket(s_bank[kSpread], a.buckets[kSpread],
               bit_length(a.n_hold[h]));
      }
    }
    if (m & kDropped) a.member[node_c] = 0;
    if (expired) {
      a.slot_of_node[node_c] = -1;
      a.slot_node[s] = -1;
      a.slot_phase[s] = kFree;
      a.slot_dead[s] = -1;
    }
  }
  if (hist) {
    __syncthreads();
    for (int k = 0; k < kBanks; ++k) {
      for (int b = h; b < a.buckets[k]; b += a.threads) {
        if (s_bank[k][b] != 0u) add32(a.hist[k] + b, s_bank[k][b]);
      }
    }
  }
}


// The wide forms (H > kMaxRows): a block of kMaxRows threads, thread t
// the rows t, t + kMaxRows, ...  The first row's loads come before the
// wait, the others' after it (each row reads and writes only its own
// slot's registers, so the rows' order does not matter); the counts are
// summed by thread, then over the block.  The kernels above stay as they
// were for H <= kMaxRows.

// A block's sum of one count a thread: every thread's v added to *s,
// which was zeroed before the block's last barrier; every thread gets the
// sum.
__device__ __forceinline__ uint32_t block_sum(uint32_t* s, uint32_t v) {
  if (v != 0u) atomicAdd(s, v);
  __syncthreads();
  return *s;
}

// decide_kernel's loads of row h, before the wait.
struct DecideIn {
  int s;
  int32_t rnd, node, node_c, phase, start, cc;
  bool alive, member;
};

__device__ __forceinline__ DecideIn decide_load(const Args& a, int h) {
  DecideIn r;
  r.rnd = __ldg(a.rnd);
  r.s = __ldg(a.idx + h);
  r.node = a.slot_node[r.s];
  r.phase = a.slot_phase[r.s];
  r.start = __ldg(a.slot_start + r.s);
  r.cc = max(__ldg(a.conf_cap + r.s), 0);  // in [0, max_conf]
  r.node_c = clamp_node(r.node, a.N);
  r.alive = r.member = false;
  if (a.refute) {
    r.alive = __ldg(a.alive + r.node_c) != 0;
    r.member = a.member[r.node_c] != 0;
  }
  return r;
}

// decide_kernel's work on row h after the wait; whether the row refutes.
__device__ __forceinline__ bool decide_row(const Args& a, int h,
                                           DecideIn r) {
  bool refute_now = false;
  if (a.refute) {
    const int32_t own = static_cast<int32_t>(byte_at(a, h, r.node_c) >>
                                             kMsgShift);
    refute_now = (r.phase == kSuspect || r.phase == kDeadPhase) &&
                 r.node >= 0 && r.alive && r.member &&
                 (own == kMsgSuspect || own == kMsgDead);
    if (refute_now) {
      atomicAdd(a.incarnation + r.node_c, 1);
      r.phase = kRefuted;
      a.slot_phase[r.s] = kRefuted;
      a.slot_dead[r.s] = r.rnd;
      if (a.lhm != nullptr) {
        atomicAdd(a.lhm + r.node_c, 1);
        atomicMin(a.lhm + r.node_c, a.lhm_max);
      }
    }
    a.ref_col[h] = r.node_c;
    a.ref_byte[h] = refute_now ? kRefuteByte : 0;
  }
  uint32_t ok = 0;
  if (r.phase == kSuspect) {
    const int32_t elapsed = sub32(r.rnd, r.start);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (elapsed >= a.tbl[min(c, r.cc)]) ok |= 1u << c;
    }
  }
  a.ok_mask[h] = static_cast<uint8_t>(ok);
  return refute_now;
}

__global__ void __launch_bounds__(kMaxRows)
decide_wide_kernel(const __grid_constant__ Args a) {
  __shared__ uint32_t s_n;  // the refutations
  const int t = static_cast<int>(threadIdx.x);
  const DecideIn r = decide_load(a, t);  // H > kMaxRows: a row each
  if (t == 0) s_n = 0u;
  wait_for_primary();
  uint32_t n = decide_row(a, t, r);
  for (int h = t + kMaxRows; h < a.H; h += kMaxRows) {
    n += decide_row(a, h, decide_load(a, h));
  }
  __syncthreads();  // s_n zeroed
  const uint32_t sum = block_sum(&s_n, n);
  if (t == 0 && sum != 0u) add32(a.n_refuted, sum);
}

// settle_kernel's loads of row h, before the wait.
struct SettleIn {
  int s;
  int32_t rnd, node_c, phase, dead, start, fail_c;
};

__device__ __forceinline__ SettleIn settle_load(const Args& a, int h) {
  SettleIn r;
  r.rnd = __ldg(a.rnd);
  r.s = __ldg(a.idx + h);
  r.node_c = clamp_node(a.slot_node[r.s], a.N);
  r.phase = a.slot_phase[r.s];
  r.dead = a.slot_dead[r.s];
  r.start = __ldg(a.slot_start + r.s);
  r.fail_c = __ldg(a.fail + r.node_c);
  return r;
}

// settle_kernel's work on row h after the wait: bit 0 of the result a
// detection, bit 1 a false dead; the detection's rounds into *rounds.
__device__ __forceinline__ uint32_t settle_row(const Args& a, int h,
                                               SettleIn r,
                                               uint32_t* rounds) {
  const bool fired = a.fired[h] != 0;
  const bool new_verdict = fired && r.dead < 0;
  if (fired) {
    r.phase = kDeadPhase;
    if (new_verdict) r.dead = r.rnd;
    a.slot_phase[r.s] = r.phase;
    a.slot_dead[r.s] = r.dead;
  }
  const bool detected = new_verdict && r.fail_c <= r.rnd;
  const bool false_dead = new_verdict && !(r.fail_c <= r.rnd);
  if (detected) {
    atomicAdd(rounds, static_cast<uint32_t>(sub32(r.rnd, r.fail_c)));
  }
  const bool verdict_done =
      (r.phase == kDeadPhase || r.phase == kRefuted || r.phase == kJoin) &&
      r.dead >= 0 && sub32(r.rnd, r.dead) > 2 * a.budget + 8;
  const bool expired =
      r.phase > kFree && (sub32(r.rnd, r.start) > a.ttl || verdict_done);
  const bool dropped = expired && r.phase == kDeadPhase;
  a.expired[h] = expired ? 1 : 0;
  a.marks[h] = static_cast<uint8_t>((detected ? kDetected : 0) |
                                    (new_verdict ? kNewVerdict : 0) |
                                    (dropped ? kDropped : 0));
  if (a.spread_want != nullptr) {
    a.spread_want[h] = expired && r.dead >= 0 ? 1 : 0;
    a.verdict[h] = r.phase == kDeadPhase ? kMsgDead : kMsgRefute;
  }
  return (detected ? 1u : 0u) | (false_dead ? 2u : 0u);
}

__global__ void __launch_bounds__(kMaxRows)
settle_wide_kernel(const __grid_constant__ Args a) {
  __shared__ uint32_t s_rounds;  // the detections' rounds, summed
  __shared__ uint32_t s_n[2];    // the detections, the false dead
  const int t = static_cast<int>(threadIdx.x);
  if (t == 0) s_rounds = s_n[0] = s_n[1] = 0u;
  const SettleIn r = settle_load(a, t);  // H > kMaxRows: a row each
  wait_for_primary();
  __syncthreads();  // the sums zeroed
  const uint32_t v = settle_row(a, t, r, &s_rounds);
  uint32_t det = v & 1u, fd = v >> 1;
  for (int h = t + kMaxRows; h < a.H; h += kMaxRows) {
    const uint32_t w = settle_row(a, h, settle_load(a, h), &s_rounds);
    det += w & 1u;
    fd += w >> 1;
  }
  if (det != 0u) atomicAdd(s_n, det);
  const uint32_t n_false = block_sum(s_n + 1, fd);
  if (t == 0) {
    if (s_n[0] != 0u) {
      add32(a.n_detected, s_n[0]);
      add32(a.sum_detect, s_rounds);
    }
    if (n_false != 0u) add32(a.n_false_dead, n_false);
  }
}

// record_kernel's loads of row h, before the wait.
struct RecordIn {
  int s;
  int32_t node_c, rnd, start, fail_c;
  uint32_t m;
  bool expired, refute_now, spread;
};

__device__ __forceinline__ RecordIn record_load(const Args& a, int h,
                                                bool hist) {
  RecordIn r;
  r.s = a.idx[h];
  r.m = a.marks[h];
  r.expired = a.expired[h] != 0;
  r.rnd = r.start = r.fail_c = 0;
  r.refute_now = r.spread = false;
  if (hist) {
    r.rnd = __ldg(a.rnd);
    r.refute_now = a.ref_byte != nullptr && a.ref_byte[h] != 0;
    r.spread = a.spread_want[h] != 0;
    r.start = a.slot_start[r.s];
  }
  r.node_c = clamp_node(a.slot_node[r.s], a.N);
  if (hist) r.fail_c = __ldg(a.fail + r.node_c);
  return r;
}

// record_kernel's work on row h after the wait (the banks' buckets in
// shared memory).
__device__ __forceinline__ void record_row(
    const Args& a, int h, const RecordIn& r, bool hist,
    uint32_t (*s_bank)[kMaxBuckets]) {
  if (hist) {
    const int32_t dwell = sub32(r.rnd, r.start);
    if (r.m & kDetected) {
      bucket(s_bank[kDetect], a.buckets[kDetect], sub32(r.rnd, r.fail_c));
    }
    if ((r.m & kNewVerdict) || r.refute_now) {
      bucket(s_bank[kDwell], a.buckets[kDwell], dwell);
    }
    if (r.refute_now) bucket(s_bank[kRefute], a.buckets[kRefute], dwell);
    if (r.spread) {
      bucket(s_bank[kSpread], a.buckets[kSpread], bit_length(a.n_hold[h]));
    }
  }
  if (r.m & kDropped) a.member[r.node_c] = 0;
  if (r.expired) {
    a.slot_of_node[r.node_c] = -1;
    a.slot_node[r.s] = -1;
    a.slot_phase[r.s] = kFree;
    a.slot_dead[r.s] = -1;
  }
}

__global__ void __launch_bounds__(kMaxRows)
record_wide_kernel(const __grid_constant__ Args a) {
  __shared__ uint32_t s_bank[kBanks][kMaxBuckets];
  const int t = static_cast<int>(threadIdx.x);
  const bool hist = a.hist[kDetect] != nullptr;
  if (hist) {
    for (int k = 0; k < kBanks; ++k) {
      for (int b = t; b < a.buckets[k]; b += a.threads) s_bank[k][b] = 0u;
    }
  }
  const RecordIn r = record_load(a, t, hist);  // H > kMaxRows: a row each
  // The holders and every write after the wait: the kernel before reads
  // member, which a dropped subject's flag clears.
  wait_for_primary();
  if (hist) __syncthreads();  // the banks' buckets zeroed
  record_row(a, t, r, hist, s_bank);
  for (int h = t + kMaxRows; h < a.H; h += kMaxRows) {
    record_row(a, h, record_load(a, h, hist), hist, s_bank);
  }
  if (hist) {
    __syncthreads();
    for (int k = 0; k < kBanks; ++k) {
      for (int b = t; b < a.buckets[k]; b += a.threads) {
        if (s_bank[k][b] != 0u) add32(a.hist[k] + b, s_bank[k][b]);
      }
    }
  }
}

// The launch's Args from the entry points' tables; false for arguments
// the kernels do not take.
inline bool setup(Args& a, void* const* shards, int ndev, void* const* ptrs,
                  const int* ints) {
  if (shards == nullptr || ptrs == nullptr || ints == nullptr || ndev < 1 ||
      ndev > kMaxShards) {
    return false;
  }
  const int N = ints[iN], H = ints[iH], S = ints[iS];
  if (N < 1 || N % ndev != 0 || S < 1 || S > kMaxSlots || H < 1 || H > S) {
    return false;
  }
  for (int j = 0; j < ndev; ++j) {
    if (shards[j] == nullptr) return false;
    a.heard[j] = static_cast<const uint8_t*>(shards[j]);
  }
  // Always needed: the row, the registers, the [N] vectors, the counters.
  for (int k = kRnd; k <= kNRefuted; ++k) {
    if (ptrs[k] == nullptr && k != kLhm) return false;
  }
  a.rnd = static_cast<const int32_t*>(ptrs[kRnd]);
  a.idx = static_cast<const int32_t*>(ptrs[kIdx]);
  a.slot_node = static_cast<int32_t*>(ptrs[kSlotNode]);
  a.slot_phase = static_cast<int32_t*>(ptrs[kSlotPhase]);
  a.slot_start = static_cast<const int32_t*>(ptrs[kSlotStart]);
  a.slot_dead = static_cast<int32_t*>(ptrs[kSlotDead]);
  a.conf_cap = static_cast<const int32_t*>(ptrs[kConfCap]);
  a.alive = static_cast<const uint8_t*>(ptrs[kAlive]);
  a.member = static_cast<uint8_t*>(ptrs[kMember]);
  a.fail = static_cast<const int32_t*>(ptrs[kFail]);
  a.slot_of_node = static_cast<int32_t*>(ptrs[kSlotOfNode]);
  a.incarnation = static_cast<int32_t*>(ptrs[kIncarnation]);
  a.lhm = static_cast<int32_t*>(ptrs[kLhm]);
  a.n_detected = static_cast<int32_t*>(ptrs[kNDetected]);
  a.sum_detect = static_cast<int32_t*>(ptrs[kSumDetect]);
  a.n_false_dead = static_cast<int32_t*>(ptrs[kNFalseDead]);
  a.n_refuted = static_cast<int32_t*>(ptrs[kNRefuted]);
  a.ok_mask = static_cast<uint8_t*>(ptrs[kOkMask]);
  a.ref_col = static_cast<int32_t*>(ptrs[kRefCol]);
  a.ref_byte = static_cast<uint8_t*>(ptrs[kRefByte]);
  a.fired = static_cast<const uint8_t*>(ptrs[kFired]);
  a.expired = static_cast<uint8_t*>(ptrs[kExpired]);
  a.marks = static_cast<uint8_t*>(ptrs[kMarks]);
  a.spread_want = static_cast<uint8_t*>(ptrs[kSpreadWant]);
  a.verdict = static_cast<int32_t*>(ptrs[kVerdict]);
  a.n_hold = static_cast<const int32_t*>(ptrs[kNHold]);
  for (int k = 0; k < kBanks; ++k) {
    a.hist[k] = static_cast<int32_t*>(ptrs[kHistDetect + k]);
  }
  a.N = N;
  a.H = H;
  a.S = S;
  a.ndev = ndev;
  a.L = N / ndev;
  a.threads = H > kMaxRows ? kMaxRows : (H + 31) / 32 * 32;
  a.refute = ints[iRefute];
  a.budget = ints[iBudget];
  a.ttl = ints[iTtl];
  a.lhm_max = ints[iLhmMax];
  for (int c = 0; c < 4; ++c) a.tbl[c] = ints[iTbl0 + c];
  a.buckets[kDetect] = a.buckets[kDwell] = a.buckets[kRefute] =
      ints[iLatBuckets];
  a.buckets[kSpread] = ints[iSpreadBuckets];
  // The refutation's outputs come together; the banks, the spread's mask,
  // verdict and holders come together, and need the refutation's byte
  // where the round refutes.
  if ((a.ref_col == nullptr) != (a.ref_byte == nullptr)) return false;
  const bool hist = a.hist[0] != nullptr;
  for (int k = 1; k < kBanks; ++k) {
    if ((a.hist[k] != nullptr) != hist) return false;
  }
  if (hist) {
    for (int k = 0; k < kBanks; ++k) {
      if (a.buckets[k] < 1 || a.buckets[k] > kMaxBuckets) return false;
    }
  }
  return true;
}

// One block of `kernel` as a programmatic dependent launch
// (cudaLaunchKernelEx with programmatic stream serialization): it may
// start while the kernel before it on the stream runs, once that one
// triggers griddepcontrol.launch_dependents or its blocks have ended, and
// griddepcontrol.wait waits for that kernel.  Returns the launch's error.
inline int programmatic(void (*kernel)(Args), const Args& a, void* stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1);
  cfg.blockDim = dim3(static_cast<unsigned>(a.threads));
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace finish_slots

// The three launches of the top of this file, one block each.  Each takes
// the same arguments: `shards`, ndev pointers to the u8 [H, N / ndev]
// column shards of heard_sub (the rows of idx); `ptrs`, the
// finish_slots::Ptr table (the round's row, idx, the registers, the [N]
// vectors, the four counters, the steps' outputs and inputs, the banks;
// kLhm null without the Lifeguard registers); `ints`, the
// finish_slots::Int table.  finish_decide needs kOkMask, and kRefCol and
// kRefByte where the round refutes (ints[iRefute] != 0); finish_settle
// kFired, kExpired and kMarks, and with the banks kSpreadWant and kVerdict;
// finish_record kExpired and kMarks, and with the banks (kHistDetect ..
// kHistSpread, all or none) kSpreadWant and kNHold; given kNHold it is a
// programmatic dependent launch, whose kernel before (the spread's count)
// may write none of its inputs but kNHold.  finish_settle is a
// programmatic dependent launch, whose kernel before (the fire) may write
// none of its inputs but kFired.  Each launches on
// `stream`, does not synchronise, and returns cudaGetLastError() after the
// launch (or cudaErrorInvalidValue for arguments it does not take).
extern "C" int finish_decide(void* const* shards, int ndev,
                             void* const* ptrs, const int* ints,
                             void* stream) {
  using namespace finish_slots;
  Args a{};
  if (!setup(a, shards, ndev, ptrs, ints) || a.ok_mask == nullptr ||
      (a.refute != 0 && a.ref_col == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Makes its loads but the own byte before it waits for the kernel
  // before it, which must write none of decide's inputs but the belief
  // rows (the top of this file).
  return programmatic(a.H > kMaxRows ? decide_wide_kernel : decide_kernel, a,
                      stream);
}

extern "C" int finish_settle(void* const* shards, int ndev,
                             void* const* ptrs, const int* ints,
                             void* stream) {
  using namespace finish_slots;
  Args a{};
  if (!setup(a, shards, ndev, ptrs, ints) || a.fired == nullptr ||
      a.expired == nullptr || a.marks == nullptr ||
      (a.hist[0] != nullptr &&
       (a.spread_want == nullptr || a.verdict == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Makes its loads but fired before it waits for the kernel before it
  // (the fire), which must write none of settle's inputs but fired (the
  // top of this file).
  return programmatic(a.H > kMaxRows ? settle_wide_kernel : settle_kernel, a,
                      stream);
}

extern "C" int finish_record(void* const* shards, int ndev,
                             void* const* ptrs, const int* ints,
                             void* stream) {
  using namespace finish_slots;
  Args a{};
  if (!setup(a, shards, ndev, ptrs, ints) || a.expired == nullptr ||
      a.marks == nullptr ||
      (a.hist[0] != nullptr &&
       (a.spread_want == nullptr || a.n_hold == nullptr ||
        (a.refute != 0 && a.ref_byte == nullptr)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.n_hold == nullptr) {
    if (a.H > kMaxRows) {
      record_wide_kernel<<<1, a.threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(a);
    } else {
      record_kernel<<<1, a.threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
    }
    return static_cast<int>(cudaGetLastError());
  }
  // With the holders, the launch right after the spread's count: a
  // programmatic dependent launch, which makes its loads but the holders
  // before it waits for that kernel (the top of this file).
  return programmatic(a.H > kMaxRows ? record_wide_kernel : record_kernel, a,
                      stream);
}

extern "C" const char* finish_slots_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
