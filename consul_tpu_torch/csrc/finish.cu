// The round's belief-matrix passes outside the dissemination tail, for
// Hopper (sm_90a): the suspicion timers' fire pass and the row wipes, in
// place, one launch each for every column shard, reading and writing only
// the rows that need it.
//
// They replace XLA steps of the reference's jitted round (no Pallas
// source), consul_tpu/gossip/kernel.py:
//   - fire_timers: the finish step's refutation write (:1529, the
//     `.at[hrows, node_c].max(refute_val)`) and its timer fire,
//     :1548-1565 (SUSPECT bytes whose slot's timer ran out at their
//     confirmation count become DEAD; `slot_fired`, the OR of a row);
//   - wipe_rows: the rows zeroed at slot GC (:1629), at the probe tick's
//     rearm (:734) and at the join tick's stale clear (:478).
// Each is bit-identical to the plain torch version beside its wrapper
// (consul_tpu_torch/gossip/finish.py: fire_timers_ref, wipe_rows_ref).
//
// The matrix.  heard is R rows of belief bytes (msg:2 | conf:2 | age:4;
// consul_tpu_torch/gossip/kernel.py) as ndev column shards, each a
// contiguous u8 [R, L] buffer (N = ndev L; one matrix is the table of
// one).  Both kernels write it in place.
//
// fire_timers.  Per row r a 4-bit mask ok[r]: bit c is set where the
// row's timer has run out for a byte of confirmation count c (the round
// folds its timeout table into it; 0 unless the slot is SUSPECT).  Where
// col[r] / rb[r] are given (the refutation), the byte at (r, col[r]) first
// becomes max(byte, rb[r]).  Then a byte fires where its message is
// SUSPECT (1), rx[column] != 0 and bit conf of ok[r] is set: it becomes
// DEAD with conf 0 and age 0 (0x80).  fired[r] (one byte, 0 or 1) is 1
// where any byte of the row fired, on any shard.
//
// wipe_rows.  Every byte of each row r with flag[r] != 0 becomes 0.
//
// Bound.  Only rows that can change are touched: a row whose ok is 0
// cannot fire (a fire needs an ok bit), so it is not read (its refutation
// byte, where it has one, is one byte read and written); an unflagged row
// is not wiped, and a wipe reads nothing of the matrix.  So the least
// bytes are the live rows read and written (a fired row's bytes mostly
// change), rx read once, the per-row arguments; for a wipe the flagged
// rows written.  A round with no live row pays a launch.  The rule is one
// table lookup a byte, 9 integer instructions a 32-bit word of four bytes
// counted by hand in issue slots (chip_smoke.py finish_ops_per_word): at
// 67e12 / 4 ops/s under the bytes' time at 3.35 TB/s, so the bytes bound
// it.
//
// Work split.  The grid is at most one wave, kBlocksPerSM blocks of
// kThreads on each of the H100's 132 SMs (fewer where the matrix has less
// work at its most), fixed at capture; the blocks find the work inside it.
//   - The live rows.  Every block lists the rows whose argument is nonzero
//     in shared memory, in row order, the same list in every block: warp 0
//     ballots 32 row arguments at a time, the loads of four ballots issued
//     together (at R = 64 one round trip, one barrier); the fire packs each
//     listed row's ok mask and refutation in the same round trip (a
//     listing by every warp, with a prefix of their counts and three
//     barriers, made every launch slower on the card).  The list is each
//     block's own rather than one the kernel before writes
//     (decide_kernel's ok_mask, lanes_slots_kernel's rearm, settle_kernel's
//     expired): a launch with no live row costs the fire about 0.0022 ms
//     and the wipe 0.0017 on an H100 (chip_smoke.py --phase finish), and
//     the kernels keep no contract with another kernel's outputs.
//   - Units.  A shard's row is cut into 16-byte units at its own 16-byte
//     address boundaries: unit u of the row covers columns [a - 16 + 16 u,
//     a + 16 u) where a is the row's first aligned column (a head unit u = 0
//     and a tail unit clipped to the row, both read and written a byte at
//     a time; every other unit one 16-byte access).  So every row of every
//     shard width takes 16-byte accesses whatever L % 16, and alignment
//     the caller's buffers do not give is handled the same way.
//   - Items.  A fire's span is kSpan units of one shard (kUnits a thread,
//     kThreads apart), the same unit numbers in every row; its item is a
//     span and a group of the listed rows, G groups, as many as fill the
//     grid and at most one a row, so a few live rows still spread over the
//     card and many let a block walk several rows over one span.  A
//     thread loads the next row's units before it fires the current one's.
//     A wipe's item is one row and a span of kThreads units (a unit a
//     thread), in row order.  Blocks stride over items.  No unit needs a
//     division: an item's shard, span and rows are found once, a unit's
//     columns from the thread's index.
//   - rx.  The fire stages a span's rx in shared memory once an item, as
//     no-rx bytes (0x08 where rx is 0: the bit the rule's lookup reads),
//     with the item's first row's loads in flight.  A row reads its unit's
//     16 bytes there at its own phase against rx: one 16-byte read where
//     the phases agree, else the two aligned 16-byte words around them and
//     funnel shifts, one code path for each word offset (the phase is the
//     row's, so the path is the warp's; 16-byte reads a thread at a
//     16-byte stride share no bank).
//   - A row whose units of this thread are all whole takes a path with no
//     test a unit but the refutation's.
//   - Writes: the fire writes only the 4-byte words (bytes, in a head or
//     tail unit) that change; the wipe writes the units of its rows.
//
// fired without a memset, and no arrival over more than one wave.  A
// thread that fires a byte marks its listed row in shared memory; the
// block adds its marks into a caller's scratch (one word a row, atomicOr)
// and arrives at a counter after them (release); the last of the blocks
// that had an item (at most the grid, one wave) to arrive (acquire) writes
// fired[0, R) from the scratch and zeroes the scratch and the counter.
// With no live row no block arrives: block 0 writes fired zero.  So the
// scratch is zero between launches (its owner makes it zero once,
// observe.cu's scratch serves: a launch uses its first R + 1 words), fired
// needs no memset, and a launch reads nothing from the host: it runs
// inside the round program's captured graphs.  One scratch serves one
// launch at a time.  (Having the decision kernel zero fired would spare
// the arrival but tie the fire to that kernel's outputs.)
//
// Past kMaxRows (2,048) rows.  A block's listing, its refutation columns
// and its marks are kMaxRows entries of shared memory (about 26 KB with
// the staged rx, under the 48 KB static limit and four blocks an SM);
// growing them with R would break both at the reference's own slot
// provisioning (8,192 at n = 1M and 5 % loss, 16,384 for a nemesis run at
// n = 10,000).  So a launch of more rows goes to fire_wide_kernel /
// wipe_wide_kernel, which walk the rows in chunks of kMaxRows: each chunk
// listed, cut into items (a span times a row group of the chunk's listed
// rows) and fired or wiped as a launch of that many rows is, the fire's
// marks added into the scratch at their rows.  The listing packs a row
// less its chunk's first, so bits 0-10 still hold it.  Every block of the
// grid arrives once after the last chunk (a block may have items in one
// chunk and none in another), and the last writes fired.  The narrow
// kernels are unchanged, and the host picks by R.

#include <cuda_runtime.h>

#include <cstdint>

namespace finish {

constexpr int kMaxShards = 64;
constexpr int kMaxRows = 2048;     // rows a block lists at once
// Rows a launch takes: past kMaxRows the wide kernels list and fire them
// kMaxRows at a time; row numbers and the scratch's words stay far inside
// an int.
constexpr int kMaxSlots = 1 << 24;
constexpr int kThreads = 256;      // a block
constexpr int kCols = 16;          // a unit: columns of one shard row
constexpr int kWords = kCols / 4;
constexpr int kUnits = 2;          // units a thread fires of each row
constexpr int kSpan = kThreads * kUnits;  // units a fire's span
constexpr int kWipeSpan = kThreads;       // a wipe's: a unit a thread
constexpr int kListBallots = 4;           // ballots a round of the listing
// The grid at most: one wave of kBlocksPerSM blocks on each of the H100's
// 132 SMs.
constexpr int kBlocksPerSM = 4;
constexpr int kMaxBlocks = 132 * kBlocksPerSM;
constexpr uint32_t kNib = 0x0F0F0F0Fu;  // the low nibble of each byte

// Everything a launch needs, passed by value (about 560 bytes of the 4 KB
// parameter block) as a __grid_constant__.
struct Args {
  uint8_t* in[kMaxShards];  // the ndev shards, u8 [R, L] each, in place
  const uint8_t* sel;       // [R]: ok (fire) or flag (wipe)
  const uint8_t* rx;        // [N], one byte (0/1) per global column (fire)
  const int32_t* col;       // [R] global column of the refutation, or null
  const uint8_t* rb;        // [R] its byte (0: none)
  uint8_t* fired;           // [R] (fire)
  uint32_t* scratch;        // >= R + 1 words, zero between launches (fire)
  int R, L, ndev;
  int units;      // units a shard row at most: L / 16 rounded up, + 1
  int spans;      // spans a shard: units / (kSpan or kWipeSpan) rounded up
};

// Adds one to a counter in device memory at GPU scope with release
// semantics and returns the old value; and the acquire the last block to
// arrive makes before it reads the others' marks (observe.cu's pair).
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

// Lets the launch that depends on this one programmatically start
// (griddepcontrol.launch_dependents); nothing where none follows.
__device__ __forceinline__ void trigger_dependents() {
#ifdef __CUDA_ARCH__
  asm volatile("griddepcontrol.launch_dependents;");
#endif
}

// A mark that several threads of a block may set at once (each writes 1).
__device__ __forceinline__ void mark(uint8_t* p) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<volatile uint8_t*>(p) = 1;
#else
  __atomic_store_n(p, static_cast<uint8_t>(1), __ATOMIC_RELAXED);
#endif
}

// PTX prmt in its default mode: result byte i is byte (c's nibble i & 7)
// of the eight bytes {b, a} (a's first), or, where the nibble's bit 3 is
// set, that byte's top bit copied over all eight bits.
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t c) {
#ifdef __CUDA_ARCH__
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
#else
  const uint64_t v = static_cast<uint64_t>(b) << 32 | a;
  uint32_t d = 0u;
  for (int i = 0; i < 4; ++i) {
    const uint32_t n = (c >> (4 * i)) & 15u;
    uint32_t x = static_cast<uint32_t>(v >> (8 * (n & 7u))) & 0xFFu;
    if (n & 8u) x = (x & 0x80u) != 0u ? 0xFFu : 0u;
    d |= x << (8 * i);
  }
  return d;
#endif
}

// The 32 bits of {hi, lo} from bit sh (0 <= sh < 32) on.
__device__ __forceinline__ uint32_t funnel(uint32_t lo, uint32_t hi, int sh) {
#ifdef __CUDA_ARCH__
  return __funnelshift_r(lo, hi, static_cast<unsigned>(sh));
#else
  return static_cast<uint32_t>((static_cast<uint64_t>(hi) << 32 | lo) >> sh);
#endif
}

// A block's list of the rows whose argument sel[r] is nonzero, in row
// order, and how many (the same in every block).  For the fire each entry
// is the row's arguments packed (pack_row), for the wipe the row.
struct Listing {
  uint32_t rows[kMaxRows];
  int n;
};

// A row's fire arguments packed: the row (bits 0-10), its ok mask
// (12-15), its refutation byte (16-23) and the refutation's shard + 1
// (24-30; 0: none); and the refutation's column in that shard (lc).
__device__ __forceinline__ uint32_t pack_row(const Args& a, int r,
                                             uint32_t ok, uint32_t rb, int c,
                                             int& lc) {
  uint32_t v = static_cast<uint32_t>(r) | (ok & 15u) << 12;
  lc = 0;
  if (rb != 0u && c >= 0 && c / a.L < a.ndev) {
    const int i = c / a.L;
    lc = c - i * a.L;
    v |= rb << 16 | static_cast<uint32_t>(i + 1) << 24;
  }
  return v;
}

// Warp 0 lists the rows [lo, hi) (hi - lo <= kMaxRows), kListBallots
// ballots of 32 row arguments a round, their loads (with the fire's
// refutation arguments) issued together: at R = 64 one round trip; one
// barrier for the block.  Each entry holds its row less lo.  Returns how
// many rows are listed.
template <bool kFire>
__device__ __forceinline__ int list_rows(const Args& a, Listing& s,
                                         int* ref_col, int lo, int hi) {
  const int lane = static_cast<int>(threadIdx.x);
  if (lane < 32) {
    int n = 0;
    for (int r0 = lo; r0 < hi; r0 += 32 * kListBallots) {
      uint32_t ok[kListBallots], rb[kListBallots];
      int col[kListBallots];
#pragma unroll
      for (int q = 0; q < kListBallots; ++q) {
        const int r = r0 + 32 * q + lane;
        ok[q] = 0u;
        rb[q] = 0u;
        col[q] = -1;
        if (r < hi) {
          ok[q] = __ldg(a.sel + r);
          if (kFire && a.col != nullptr) {
            rb[q] = __ldg(a.rb + r);
            col[q] = __ldg(a.col + r);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kListBallots; ++q) {
        const int r = r0 + 32 * q + lane;
        const unsigned m = __ballot_sync(0xFFFFFFFFu, ok[q] != 0u);
        if (ok[q] != 0u) {
          const int j = n + __popc(m & ((1u << lane) - 1u));
          if (kFire) {
            s.rows[j] = pack_row(a, r - lo, ok[q], rb[q], col[q], ref_col[j]);
          } else {
            s.rows[j] = static_cast<uint32_t>(r - lo);
          }
        }
        n += __popc(m);
      }
    }
    if (lane == 0) s.n = n;
  }
  __syncthreads();
  return s.n;
}

// The launch's cut into items: spans x groups of the n_live listed rows.
struct Split {
  int spans;   // spans over all shards
  int groups;  // row groups
  int items;
};

__device__ __forceinline__ Split split(const Args& a, int n_live,
                                       bool row_items) {
  Split p;
  p.spans = a.ndev * a.spans;
  const int fill = static_cast<int>(gridDim.x) / p.spans;
  p.groups = row_items || fill >= n_live ? n_live : (fill < 1 ? 1 : fill);
  p.items = p.spans * p.groups;
  return p;
}

// Item x: its shard, its span there and its listed rows [jlo, jhi).
struct Item {
  int i, s, jlo, jhi;
};

__device__ __forceinline__ Item item_of(const Args& a, const Split& p, int x,
                                        int n_live) {
  const int g = x / p.spans;
  const int sp = x - g * p.spans;
  Item it;
  it.i = sp / a.spans;
  it.s = sp - it.i * a.spans;
  // g < groups <= n_live <= kMaxRows, so the products fit an int.
  it.jlo = g * n_live / p.groups;
  it.jhi = (g + 1) * n_live / p.groups;
  return it;
}

// The first aligned column of the shard row starting at `row`: unit u of
// the row covers columns [a - 16 + 16 u, a + 16 u), so unit 0 starts
// before the row and every unit at a 16-byte address boundary.
__device__ __forceinline__ int phase(const uint8_t* row) {
  return static_cast<int>((0u - reinterpret_cast<uintptr_t>(row)) & 15u);
}

// A 16-byte access to the matrix at p, which must be 16-byte aligned: the
// card faults otherwise, and the host build of this file (its tests) traps.
__device__ __forceinline__ uint4* at16(uint8_t* p) {
#ifndef __CUDA_ARCH__
  if ((reinterpret_cast<uintptr_t>(p) & 15u) != 0u) __builtin_trap();
#endif
  return reinterpret_cast<uint4*>(p);
}

// A unit lies wholly in its row (one 16-byte access), in part (a head or
// tail, byte by byte) or not at all.
__device__ __forceinline__ bool whole(int c0, int L) {
  return c0 >= 0 && c0 <= L - kCols;
}

__device__ __forceinline__ bool touches(int c0, int L) {
  return c0 > -kCols && c0 < L;
}

// The unit at p (first column c0 of a row of L bytes) as four words, the
// bytes outside the row 0.
__device__ __forceinline__ void load_unit(const uint8_t* p, int c0, int L,
                                          uint32_t w[kWords]) {
  if (whole(c0, L)) {
    const uint4 v = *at16(const_cast<uint8_t*>(p));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    return;
  }
#pragma unroll
  for (int k = 0; k < kWords; ++k) w[k] = 0u;
  if (!touches(c0, L)) return;
  for (int k = 0; k < kCols; ++k) {
    if (c0 + k >= 0 && c0 + k < L) {
      w[k / 4] |= static_cast<uint32_t>(p[k]) << (8 * (k % 4));
    }
  }
}

// Writes back the words of a unit that differ from what was read (in a
// head or tail unit, the bytes of the row that differ).
__device__ __forceinline__ void store_changed(uint8_t* p, int c0, int L,
                                              const uint32_t was[kWords],
                                              const uint32_t now[kWords]) {
  if (whole(c0, L)) {
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      if (now[k] != was[k]) reinterpret_cast<uint32_t*>(p)[k] = now[k];
    }
    return;
  }
  for (int k = 0; k < kCols; ++k) {
    const uint32_t b = (now[k / 4] >> (8 * (k % 4))) & 0xFFu;
    if (b != ((was[k / 4] >> (8 * (k % 4))) & 0xFFu) && c0 + k >= 0 &&
        c0 + k < L) {
      p[k] = static_cast<uint8_t>(b);
    }
  }
}

// The 16 staged bytes at byte offset `off` of the span's rx, as four
// words, by path P: 0 where off % 16 == 0 (one 16-byte read), else 1 + the
// word offset (off % 16) / 4: the two aligned 16-byte words around them
// and funnel shifts.  Every path reads 16 bytes a thread at a 16-byte
// stride, so no two threads of a quarter warp share a bank.
template <int P>
__device__ __forceinline__ void rx_path(const uint4* s, int off,
                                        uint32_t w[kWords]) {
  const uint4 lo = s[off >> 4];
  if (P == 0) {
    w[0] = lo.x; w[1] = lo.y; w[2] = lo.z; w[3] = lo.w;
    return;
  }
  const uint4 hi = s[(off >> 4) + 1];
  const uint32_t x[2 * kWords] = {lo.x, lo.y, lo.z, lo.w,
                                  hi.x, hi.y, hi.z, hi.w};
  const int sh = 8 * (off & 3);
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    w[k] = funnel(x[P - 1 + k], x[P + k], sh);
  }
}

// The rx path of a row: `off` mod 16 is its phase against rx's, the same
// for every thread of the row, so the choice is the warp's.
__device__ __forceinline__ int rx_path_of(int off) {
  return (off & 15) == 0 ? 0 : 1 + ((off & 15) >> 2);
}

__device__ __forceinline__ void rx_at(const uint4* s, int off,
                                      uint32_t w[kWords]) {
  switch (rx_path_of(off)) {
    case 0: rx_path<0>(s, off, w); break;
    case 1: rx_path<1>(s, off, w); break;
    case 2: rx_path<2>(s, off, w); break;
    case 3: rx_path<3>(s, off, w); break;
    default: rx_path<4>(s, off, w); break;
  }
}

// The row's fire table: byte c is 0x7F where bit c of its ok mask is set
// (a SUSPECT byte of confirmation count c fires), else 0.
__device__ __forceinline__ uint32_t fire_table(uint32_t ok) {
  return ((ok * 0x00204081u) & 0x01010101u) * 0x7Fu;
}

// The fire rule on four bytes by one table lookup: each byte's top nibble
// (message, confirmation count), its bit 3 also set where the column
// takes no message (no_rx: 0x08 there, else 0), selects a byte of {table,
// 0}: index 4 + c (SUSPECT, count c) the table's byte c; 0-3 (message 0)
// a zero; with bit 3 set (DEAD, REFUTE or no rx) the top bit of a byte
// that has none, so 0.  fm gets 0x7F in each byte that fires, and those
// become 0x80 (DEAD, conf 0, age 0).  Returns the new word.
__device__ __forceinline__ uint32_t fire_word(uint32_t w, uint32_t no_rx,
                                              uint32_t table, uint32_t& fm) {
  const uint32_t x = ((w >> 4) | no_rx) & kNib;  // a nibble a byte
  const uint32_t y = x | (x >> 4);  // bytes 0 and 2: nibbles 0-1 and 2-3
  fm = prmt(0u, table, prmt(y, 0u, 0x0020u));
  return (w | fm << 1) & ~fm;
}

// A thread's kUnits units of one row (its first at column c00, the
// others kThreads units apart), loaded.
struct RowUnits {
  uint32_t w[kUnits][kWords];
};

__device__ __forceinline__ void load_row(const Args& a, const uint8_t* row,
                                         int u0, RowUnits& b) {
  const int c00 = phase(row) - kCols + kCols * u0;
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const int c0 = c00 + kCols * kThreads * k;
    if (u0 + kThreads * k < a.units) load_unit(row + c0, c0, a.L, b.w[k]);
  }
}

// The refutation's max of byte e (0-15) of a unit and rb, the word chosen
// by compile-time indices so that `now` stays in registers.
__device__ __forceinline__ void refute_unit(uint32_t now[kWords], int e,
                                            uint32_t rb) {
  const int sh = 8 * (e & 3);
#pragma unroll
  for (int q = 0; q < kWords; ++q) {
    if (q == e >> 2 && ((now[q] >> sh) & 0xFFu) < rb) {
      now[q] = (now[q] & ~(0xFFu << sh)) | (rb << sh);
    }
  }
}

// The refutation and the fire on the four words of a unit (was: as
// loaded); returns the fire marks (fm of each word ORed).
__device__ __forceinline__ uint32_t fire_unit(const uint32_t was[kWords],
                                              const uint32_t no_rx[kWords],
                                              uint32_t table, int e,
                                              uint32_t rb,
                                              uint32_t now[kWords]) {
#pragma unroll
  for (int q = 0; q < kWords; ++q) now[q] = was[q];
  if (static_cast<unsigned>(e) < static_cast<unsigned>(kCols)) {
    refute_unit(now, e, rb);  // the refutation first
  }
  uint32_t any = 0u;
#pragma unroll
  for (int q = 0; q < kWords; ++q) {
    uint32_t fm;
    now[q] = fire_word(now[q], no_rx[q], table, fm);
    any |= fm;
  }
  return any;
}

// A row whose kUnits units of this thread are all whole, its rx by path
// P: no test a unit but the refutation's.
template <int P>
__device__ __forceinline__ uint32_t fire_whole(uint8_t* row, int c00, int off,
                                               int rk, uint32_t rb,
                                               uint32_t table,
                                               const uint4* rxs,
                                               const RowUnits& b) {
  uint32_t any = 0u;
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    uint32_t no_rx[kWords], now[kWords];
    rx_path<P>(rxs, off + kCols * kThreads * k, no_rx);
    any |= fire_unit(b.w[k], no_rx, table, rk - kCols * kThreads * k, rb,
                     now);
    uint32_t* p = reinterpret_cast<uint32_t*>(
        at16(row + c00 + kCols * kThreads * k));
#pragma unroll
    for (int q = 0; q < kWords; ++q) {
      if (now[q] != b.w[k][q]) p[q] = now[q];
    }
  }
  return any;
}

// The refutation and the fire on a thread's units of listed row j (v its
// packed arguments), loaded in b; writes back what changed.  Returns
// nonzero where a byte fired.
__device__ __forceinline__ uint32_t fire_row(const Args& a, const Item& it,
                                             uint8_t* row, uint32_t v,
                                             int ref_lc, int u0, int delta,
                                             const uint4* rxs,
                                             const RowUnits& b) {
  const int a0 = phase(row);
  const int c00 = a0 - kCols + kCols * u0;
  const uint32_t table = fire_table((v >> 12) & 15u);
  const uint32_t rb = (v >> 16) & 0xFFu;
  // The refutation's column from unit 0's first (outside every unit where
  // the row has none on this shard).
  const int rk = static_cast<int>(v >> 24) == it.i + 1 ? ref_lc - c00 : -1;
  // Unit 0's rx sits at smem byte delta + c00 - (16 kSpan s - 16).
  const int off = delta + a0 + kCols * static_cast<int>(threadIdx.x);
  if (c00 >= 0 && c00 <= a.L - kCols - kCols * kThreads * (kUnits - 1)) {
    switch (rx_path_of(off)) {
      case 0: return fire_whole<0>(row, c00, off, rk, rb, table, rxs, b);
      case 1: return fire_whole<1>(row, c00, off, rk, rb, table, rxs, b);
      case 2: return fire_whole<2>(row, c00, off, rk, rb, table, rxs, b);
      case 3: return fire_whole<3>(row, c00, off, rk, rb, table, rxs, b);
      default: return fire_whole<4>(row, c00, off, rk, rb, table, rxs, b);
    }
  }
  // A head or tail unit, or units past the row's end.
  uint32_t any = 0u;
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const int c0 = c00 + kCols * kThreads * k;
    if (u0 + kThreads * k >= a.units || !touches(c0, a.L)) continue;
    uint32_t no_rx[kWords], now[kWords];
    rx_at(rxs, off + kCols * kThreads * k, no_rx);
    any |= fire_unit(b.w[k], no_rx, table, rk - kCols * kThreads * k, rb,
                     now);
    store_changed(row + c0, c0, a.L, b.w[k], now);
  }
  return any;
}

// The fire on one item: its first row's units loaded, its span's rx
// staged, then its rows in turn, each row's units loaded before the row
// before it fires.  Marks the rows that fired in `marks`.  The listed
// rows count from row row0 (the wide form's chunk; else 0).
__device__ __forceinline__ void fire_item(const Args& a, const Item& it,
                                          int row0, const uint32_t* rows,
                                          const int* ref_col, uint8_t* marks,
                                          uint4* s_rx) {
  const int t = static_cast<int>(threadIdx.x);
  const int u0 = it.s * kSpan + t;
  const size_t L = static_cast<size_t>(a.L);
  uint8_t* const shard = a.in[it.i] + static_cast<size_t>(row0) * L;
  RowUnits cur, next;
  load_row(a, shard + (rows[it.jlo] & 0x7FFu) * L, u0, cur);

  // The span's rx as no_rx bytes (0x08 where rx is 0): the aligned 16-byte
  // words from column 16 kSpan s - 16 on (what any row's units of the span
  // reach) that hold a column of the shard, zero elsewhere; smem byte
  // delta + c - (16 kSpan s - 16) holds column c's.
  const uintptr_t rx_lo = reinterpret_cast<uintptr_t>(a.rx) + it.i * L;
  const uintptr_t rx_hi = rx_lo + L;
  const uintptr_t from =
      rx_lo + static_cast<uintptr_t>(kCols) * kSpan * it.s - kCols;
  const int delta = static_cast<int>(from & 15u);
  const uintptr_t w0 = from - delta;
  for (int k = t; k < kSpan + 2; k += kThreads) {
    const uintptr_t w = w0 + static_cast<uintptr_t>(kCols) * k;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (w + kCols > rx_lo && w < rx_hi) {
      v = __ldg(reinterpret_cast<const uint4*>(w));
      v.x = (~v.x & 0x01010101u) << 3;
      v.y = (~v.y & 0x01010101u) << 3;
      v.z = (~v.z & 0x01010101u) << 3;
      v.w = (~v.w & 0x01010101u) << 3;
    }
    s_rx[k] = v;
  }
  __syncthreads();

  const uint4* rxs = s_rx;
  for (int j = it.jlo; j < it.jhi; j += 2) {
    const uint32_t v = rows[j];
    if (j + 1 < it.jhi) {
      load_row(a, shard + (rows[j + 1] & 0x7FFu) * L, u0, next);
    }
    if (fire_row(a, it, shard + (v & 0x7FFu) * L, v, ref_col[j], u0, delta,
                 rxs, cur) != 0u) {
      mark(&marks[j]);
    }
    if (j + 1 >= it.jhi) break;
    const uint32_t v1 = rows[j + 1];
    if (j + 2 < it.jhi) {
      load_row(a, shard + (rows[j + 2] & 0x7FFu) * L, u0, cur);
    }
    if (fire_row(a, it, shard + (v1 & 0x7FFu) * L, v1, ref_col[j + 1], u0,
                 delta, rxs, next) != 0u) {
      mark(&marks[j + 1]);
    }
  }
  __syncthreads();  // the next item stages over s_rx
}

// The refutation byte of a row that is not listed: one byte, by one
// thread of the grid.  (A listed row's is applied in its unit, before the
// fire test.)
__device__ __forceinline__ void refute_unlisted(const Args& a) {
  const int t = static_cast<int>(threadIdx.x);
  const int b = static_cast<int>(blockIdx.x);
  for (int row = b * kThreads + t; row < a.R;
       row += static_cast<int>(gridDim.x) * kThreads) {
    const uint8_t rb = __ldg(a.rb + row);
    const int c = __ldg(a.col + row);
    if (rb == 0 || __ldg(a.sel + row) != 0 || c < 0 || c / a.L >= a.ndev) {
      continue;
    }
    const int i = c / a.L;
    uint8_t* p = a.in[i] + static_cast<size_t>(row) * a.L + (c - i * a.L);
    if (*p < rb) *p = rb;
  }
}

// The block's marks of the n_live rows listed from row0 into the scratch.
__device__ __forceinline__ void flush_marks(const Args& a, int row0,
                                            const Listing& s_list,
                                            const uint8_t* s_marks,
                                            int n_live) {
  for (int j = static_cast<int>(threadIdx.x); j < n_live; j += kThreads) {
    if (s_marks[j] != 0) {
      atomicOr(a.scratch + row0 + (s_list.rows[j] & 0x7FFu), 1u);
    }
  }
}

// Arrive at the scratch's counter after `working` blocks' marks; the last
// to arrive writes fired and zeroes the scratch and the counter.
__device__ __forceinline__ void arrive_and_write(const Args& a, int working,
                                                 int* s_last) {
  const int t = static_cast<int>(threadIdx.x);
  uint32_t* arrive = a.scratch + a.R;
  __syncthreads();
  if (t == 0) {
    *s_last = add_release(arrive) == static_cast<unsigned>(working - 1);
    if (*s_last) fence_acquire();
  }
  __syncthreads();
  if (!*s_last) return;
  for (int e = t; e < a.R; e += kThreads) {
    const uint32_t v = __ldcg(a.scratch + e);
    a.scratch[e] = 0u;
    a.fired[e] = v != 0u ? 1 : 0;
  }
  if (t == 0) *arrive = 0u;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
fire_kernel(const __grid_constant__ Args a) {
  __shared__ Listing s_list;
  __shared__ int s_ref_col[kMaxRows];
  __shared__ uint8_t s_marks[kMaxRows];
  __shared__ uint4 s_rx[kSpan + 2];
  __shared__ int s_last;
  const int t = static_cast<int>(threadIdx.x);
  const int b = static_cast<int>(blockIdx.x);
  // The launch after this one (the round's settle) may start: it loads
  // what the fire does not write, then waits for the fire to end.
  trigger_dependents();
  const int n_live = list_rows<true>(a, s_list, s_ref_col, 0, a.R);
  if (a.col != nullptr) refute_unlisted(a);
  if (n_live == 0) {
    if (b == 0) {
      for (int e = t; e < a.R; e += kThreads) a.fired[e] = 0;
    }
    return;
  }
  const Split p = split(a, n_live, false);
  if (b >= p.items) return;

  for (int j = t; j < n_live; j += kThreads) s_marks[j] = 0;
  __syncthreads();
  for (int x = b; x < p.items; x += static_cast<int>(gridDim.x)) {
    fire_item(a, item_of(a, p, x, n_live), 0, s_list.rows, s_ref_col,
              s_marks, s_rx);
  }

  // The block's marks into the scratch, then arrive; the last of the
  // blocks that had an item writes fired and zeroes the scratch.
  flush_marks(a, 0, s_list, s_marks, n_live);
  arrive_and_write(a, p.items < static_cast<int>(gridDim.x)
                          ? p.items : static_cast<int>(gridDim.x),
                   &s_last);
}

// The fire at R > kMaxRows: the rows in chunks of kMaxRows, each listed,
// cut into items and fired as a launch of kMaxRows rows is, its marks
// added into the scratch at their rows; then every block of the grid
// arrives (a block may have had items in one chunk and none in another),
// and the last writes fired.
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
fire_wide_kernel(const __grid_constant__ Args a) {
  __shared__ Listing s_list;
  __shared__ int s_ref_col[kMaxRows];
  __shared__ uint8_t s_marks[kMaxRows];
  __shared__ uint4 s_rx[kSpan + 2];
  __shared__ int s_last;
  const int t = static_cast<int>(threadIdx.x);
  const int b = static_cast<int>(blockIdx.x);
  trigger_dependents();
  if (a.col != nullptr) refute_unlisted(a);
  for (int row0 = 0; row0 < a.R; row0 += kMaxRows) {
    const int hi = a.R - row0 < kMaxRows ? a.R : row0 + kMaxRows;
    const int n_live = list_rows<true>(a, s_list, s_ref_col, row0, hi);
    const Split p = split(a, n_live, false);
    if (n_live != 0 && b < p.items) {
      for (int j = t; j < n_live; j += kThreads) s_marks[j] = 0;
      __syncthreads();
      for (int x = b; x < p.items; x += static_cast<int>(gridDim.x)) {
        fire_item(a, item_of(a, p, x, n_live), row0, s_list.rows, s_ref_col,
                  s_marks, s_rx);
      }
      flush_marks(a, row0, s_list, s_marks, n_live);
    }
    __syncthreads();  // the next chunk lists over s_list and s_marks
  }
  arrive_and_write(a, static_cast<int>(gridDim.x), &s_last);
}

// A wipe's items over the n_live rows listed from row0.
__device__ __forceinline__ void wipe_listed(const Args& a, int row0,
                                            const Listing& s_list,
                                            int n_live) {
  const Split p = split(a, n_live, true);
  const size_t L = static_cast<size_t>(a.L);
  for (int x = static_cast<int>(blockIdx.x); x < p.items;
       x += static_cast<int>(gridDim.x)) {
    const Item it = item_of(a, p, x, n_live);
    const int u = it.s * kWipeSpan + static_cast<int>(threadIdx.x);
    if (u >= a.units) continue;
    for (int j = it.jlo; j < it.jhi; ++j) {
      uint8_t* row = a.in[it.i] + (row0 + s_list.rows[j]) * L;
      const int c0 = phase(row) - kCols + kCols * u;
      if (whole(c0, a.L)) {
        *at16(row + c0) = make_uint4(0u, 0u, 0u, 0u);
      } else if (touches(c0, a.L)) {
        for (int q = 0; q < kCols; ++q) {
          if (c0 + q >= 0 && c0 + q < a.L) row[c0 + q] = 0;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
wipe_kernel(const __grid_constant__ Args a) {
  __shared__ Listing s_list;
  const int n_live = list_rows<false>(a, s_list, nullptr, 0, a.R);
  if (n_live == 0) return;
  wipe_listed(a, 0, s_list, n_live);
}

// The wipe at R > kMaxRows: the rows in chunks of kMaxRows, each listed
// and wiped as a launch of kMaxRows rows is.
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
wipe_wide_kernel(const __grid_constant__ Args a) {
  __shared__ Listing s_list;
  for (int row0 = 0; row0 < a.R; row0 += kMaxRows) {
    const int hi = a.R - row0 < kMaxRows ? a.R : row0 + kMaxRows;
    const int n_live = list_rows<false>(a, s_list, nullptr, row0, hi);
    if (n_live != 0) wipe_listed(a, row0, s_list, n_live);
    __syncthreads();  // the next chunk lists over s_list
  }
}

// The shared part of both launchers: the shard table and the geometry,
// and the grid (one block an item at most, so a small matrix takes fewer
// than a wave); false for arguments the kernels do not take.
inline bool setup(Args& a, int& blocks, void* const* shards, int ndev, int R,
                  int L, const void* sel, int span) {
  if (shards == nullptr || sel == nullptr || R < 1 || R > kMaxSlots ||
      L < 1 || ndev < 1 || ndev > kMaxShards ||
      static_cast<long long>(ndev) * L >= (1LL << 31) - kCols) {
    return false;
  }
  for (int j = 0; j < ndev; ++j) {
    if (shards[j] == nullptr) return false;
    a.in[j] = static_cast<uint8_t*>(shards[j]);
  }
  a.sel = static_cast<const uint8_t*>(sel);
  a.R = R;
  a.L = L;
  a.ndev = ndev;
  a.units = (L + kCols - 1) / kCols + 1;
  a.spans = (a.units + span - 1) / span;
  const long long most = static_cast<long long>(ndev) * a.spans * R;
  blocks = static_cast<int>(most < kMaxBlocks ? most : kMaxBlocks);
  return true;
}

inline bool aligned(const void* p, uintptr_t n) {
  return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0;
}

}  // namespace finish

// The scratch words fire_timers needs at R rows (uint32, zero before the
// first launch; every launch leaves it zero).
extern "C" long long fire_timers_scratch_words(int R) {
  return static_cast<long long>(R) + 1;
}

// The fire pass of the top of this file on heard, given as ndev shard
// pointers to u8 [R, L] (R <= 2**24, N = ndev * L < 2**31 - 16), in place;
// rx: one byte per global column; ok: one byte per row (its low 4 bits);
// col (int32 [R], global columns in [0, N)) and rb (one byte per row):
// the refutation, both or neither null; fired: one byte per row, written
// whole; scratch: at least fire_timers_scratch_words(R) uint32 words,
// 4-byte aligned, zero (and left zero; one launch at a time may use it).
// Any alignment of the shards and rx.  Each block triggers
// griddepcontrol.launch_dependents as it starts, so a programmatic
// dependent launch behind it (the round's settle, finish_slots.cu) may
// start then.  Launches on `stream`, does not synchronise, returns
// cudaGetLastError() after the launch (or cudaErrorInvalidValue for
// arguments it does not take).
extern "C" int fire_timers(void* const* shards, int ndev, const void* rx,
                           const void* ok, const void* col, const void* rb,
                           void* fired, void* scratch, int R, int L,
                           void* stream) {
  using namespace finish;
  Args a{};
  int blocks = 0;
  if (rx == nullptr || fired == nullptr || scratch == nullptr ||
      !aligned(scratch, 4) || (col == nullptr) != (rb == nullptr) ||
      !setup(a, blocks, shards, ndev, R, L, ok, kSpan)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.rx = static_cast<const uint8_t*>(rx);
  a.col = static_cast<const int32_t*>(col);
  a.rb = static_cast<const uint8_t*>(rb);
  a.fired = static_cast<uint8_t*>(fired);
  a.scratch = static_cast<uint32_t*>(scratch);
  if (R > kMaxRows) {
    fire_wide_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  } else {
    fire_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// Zeroes, in place, the rows r of heard (ndev shard pointers to u8 [R, L],
// as fire_timers takes them) whose flag byte is nonzero; reads no byte of
// heard.  Launches on `stream`, does not synchronise, returns
// cudaGetLastError() (or cudaErrorInvalidValue).
extern "C" int wipe_rows(void* const* shards, int ndev, const void* flags,
                         int R, int L, void* stream) {
  using namespace finish;
  Args a{};
  int blocks = 0;
  if (!setup(a, blocks, shards, ndev, R, L, flags, kWipeSpan)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (R > kMaxRows) {
    wipe_wide_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  } else {
    wipe_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* finish_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
