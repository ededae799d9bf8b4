// The round's observers on the belief matrix, for Hopper (sm_90a): masked
// per-row counts over heard[R, N], one launch for all column shards,
// reading only the rows that are wanted.
//
// It replaces three XLA reductions of the reference's jitted round (no
// Pallas source), each of which read the [S, N] matrix on its own:
//   - the flight row's dissemination bytes, consul_tpu/gossip/kernel.py:
//     1088-1094 (`_tx_bytes`: the live rumors of the round's final heard);
//   - the hist banks' spread, :1606-1625 (members still holding the
//     slot's verdict message at slot GC, on the pre-GC rows);
//   - the trace's holders, :1762-1771 (members holding DEAD and REFUTE
//     after the round).
// It is bit-identical to the plain torch version beside its wrapper
// (consul_tpu_torch/gossip/observe.py: heard_counts_ref).
//
// What it computes.  heard is R rows of belief bytes (msg:2 | conf:2 |
// age:4; consul_tpu_torch/gossip/kernel.py), as ndev column shards, each
// a contiguous u8 [R, L] buffer (N = ndev L; the single-device matrix is
// the table of one).  member is one byte (0 or 1) per global column.  A
// launch counts, for each row r it reads (every row, or where want[r] !=
// 0), the counts of its form, and writes 0 in every other count:
//   - without a verdict (the final matrix's form: the trace's holders and
//     the flight row's rumors):
//       out[0, r] = #columns with msg == DEAD (2) and member;
//       out[1, r] = #columns with msg == REFUTE (3) and member;
//       out[2, r] = #columns with msg > 0 and age < budget (no member mask);
//   - with a verdict (the spread's form):
//       out[3, r] = #columns with msg == verdict[r] and member (0 for a
//                   verdict outside 0..3: such a row is not read).
// int32, exact: a count is at most N.
//
// Bound.  One pass must read the rows it counts and member, and write
// out: at [64, 1M] 65 MB, 0.0194 ms at 3.35 TB/s.  The rule's integer
// operations, counted by hand in instruction slots (chip_smoke.py
// observe_ops_per_word: a 32-bit word of four bytes) and from the SASS
// (python3 -m consul_tpu_torch.sass_count --observe), run at 67e12 / 4
// ops/s; chip_smoke.py takes the larger term.  A launch that reads no row
// (the spread's launch in a round where no slot is recycled) costs a
// launch.
//
// Work split, as csrc/finish.cu's fire pass.  The grid is at most one
// wave: the blocks an SM the occupancy query gives (kBlocksPerSM at most)
// on each SM, fewer where the matrix has less work at its most; fixed at
// capture, and the blocks find the work inside it.
//   - The rows.  Warp 0 of every block lists the rows it reads in shared
//     memory, in row order, by ballots of 32 rows (the loads of four
//     ballots issued together: at R = 64 one round trip, one barrier), the
//     same list in every block; the spread's form packs each listed row's
//     verdict beside it.
//   - Units.  A shard's row is cut into 16-byte units at its own 16-byte
//     address boundaries: unit u covers columns [a - 16 + 16 u, a + 16 u)
//     where a is the row's first aligned column (the head unit u = 0 and a
//     tail unit clipped to the row are loaded a byte at a time, zero
//     outside the row; every other unit is one 16-byte load).  So every
//     row of every shard width takes 16-byte loads whatever L % 16.
//   - Items.  A span is kSpan units of one shard (kUnits a thread,
//     kThreads apart), the same unit numbers in every row; an item is a
//     span and a group of the listed rows, G groups, as many as fill the
//     grid and at most one a row, so one wanted row still spreads over the
//     card and many let a block walk several rows over one span.  Blocks
//     stride over items; a thread loads the next row's units before it
//     counts the current one's.  (Of 1, 2 and 4 units a thread and blocks
//     of 128 to 1,024 threads, this measured fastest on an H100:
//     tools/observe_stages.py.)
//   - member.  An item stages its span's member bytes in shared memory
//     once, with the item's first row's loads in flight (bytes outside the
//     shard zero), so member comes from memory once a span a row group.  A
//     row reads its unit's 16 member bytes there at its own phase: one
//     16-byte read where the phases agree, else the two aligned 16-byte
//     words around them and funnel shifts (the phase is the row's, so the
//     path is the block's).
//
// The rule, four bytes at a time (belief_merge.cuh's masks): with the
// word w shifted right by 6 and by 7, bit 0 of each byte holds the
// message's low and high bit; a member byte (0 or 1) masks everything but
// bit 0.  DEAD is hi & ~lo & member, REFUTE hi & lo & member; a live rumor
// is (hi | lo) & ~(bit 4 of ((age | 16) - budget)), clear iff age < budget
// with no borrow between bytes for a budget in [0, 16] (the launcher
// clamps it there: the same test for any budget); a holder is
// ~((lo ^ v0) | (hi ^ v1)) & member for the verdict's bits v1 v0.  A
// thread adds a row's flags over its units as bytes (at most 8 a byte) and
// sums across the bytes with one multiply.
//
// The counts.  A row's counts are summed over each warp
// (__reduce_add_sync) and added into the block's counts of its listed rows
// in shared memory; at the end the block adds each nonzero count to the
// caller's scratch with one atomicAdd, and arrives at a counter there after
// them (release).  Only the blocks that had an item arrive (at most the
// grid, one wave); the last of them (acquire) copies the scratch into out,
// zeroes it and the counter.  With no row to read no block arrives: block
// 0 writes out zero.  So the scratch is zero between launches (its owner
// makes it zero once; csrc/finish.cu's fire pass shares it, using its
// first R + 1 words), out needs no memset, and a launch reads nothing from
// the host: it runs inside the round program's captured graphs.  One
// scratch serves one launch at a time; a scratch made for more rows serves
// fewer (its words past the launch's stay 0).
//
// The spread's form triggers griddepcontrol.launch_dependents as it
// starts: the round's record_kernel (csrc/finish_slots.cu), a programmatic
// dependent launch, may then start under this launch's tail and make its
// loads; it waits for this launch to end before it reads the holders or
// writes member.
//
// Past kMaxRows (1,024) rows.  A block's listing and counts are kMaxRows
// entries of shared memory (about 21 KB with the staged member in the
// final matrix's form, under the 48 KB static limit at four blocks an SM);
// they do not grow with R.  A launch of more rows (the reference's own
// provisioning: 8,192 slots at n = 1M and 5 % loss) goes to
// counts_wide_kernel, in both forms: it lists a chunk of kMaxRows rows,
// counts its items, and flushes the chunk's counts with one atomic a
// count a block, chunk after chunk; every block of the grid then arrives
// once and the last writes out.  The spread's form keeps its trigger at
// the start, which record_kernel relies on.  The narrow kernels are
// unchanged, and the host picks by R.

#include <cuda_runtime.h>

#include <cstdint>

#include "belief_merge.cuh"

namespace observe {

constexpr int kMaxShards = 64;
// Rows a block lists at once (the round's slots up to 1,024); a launch of
// more rows takes them kMaxRows at a time (counts_wide_kernel).
constexpr int kMaxRows = 1024;
// Rows a launch takes: the scratch's kCounts R + 1 words and every row
// number stay far inside an int.
constexpr int kMaxSlots = 1 << 24;
constexpr int kCounts = 4;        // out's rows: dead, refute, live, hold
constexpr int kThreads = 256;     // a block
constexpr int kCols = 16;         // a unit: columns of one shard row
constexpr int kWords = kCols / 4;
constexpr int kUnits = 2;         // units a thread counts of each row
constexpr int kSpan = kThreads * kUnits;  // units a span
constexpr int kListBallots = 4;   // ballots a round of the listing
// The grid at most: one wave of kBlocksPerSM blocks on each SM (or what
// the occupancy query gives, if fewer).
constexpr int kBlocksPerSM = 4;

// Everything a launch needs, passed by value (about 600 bytes of the 4 KB
// parameter block) as a __grid_constant__.
struct Args {
  const uint8_t* in[kMaxShards];  // the ndev shards, u8 [R, L] each
  const uint8_t* member;          // [N], one byte (0/1) per global column
  const int32_t* verdict;         // [R] (the spread's form), or nullptr
  const uint8_t* want;            // [R], or nullptr: every row read
  int32_t* out;                   // [kCounts, R]
  uint32_t* scratch;              // >= scratch_words(R), zero between launches
  int R, L, ndev;
  int units;      // units a shard row at most: L / 16 rounded up, + 1
  int spans;      // spans a shard: units / kSpan rounded up
  uint32_t age_w;  // 16 - the budget clamped into [0, 16], times kLsb
};

// The scratch, in 32-bit words: the counts [kCounts, R], then the
// arrival counter.
__host__ __device__ inline long long scratch_words(long long R) {
  return kCounts * R + 1;
}

// The counts a form makes: the final matrix's three, the spread's one;
// and out's row of its first.
template <bool kHold>
struct Form {
  static constexpr int kNum = kHold ? 1 : 3;
  static constexpr int kFirst = kHold ? 3 : 0;
};

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

// Lets the launch that depends on this one programmatically start
// (griddepcontrol.launch_dependents); nothing where none follows.
__device__ __forceinline__ void trigger_dependents() {
#ifdef __CUDA_ARCH__
  asm volatile("griddepcontrol.launch_dependents;");
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

// A block's list of the rows it reads, in row order, and how many (the
// same in every block): each entry the row (bits 0-9) and, in the
// spread's form, its verdict (bits 12-13).
struct Listing {
  uint32_t rows[kMaxRows];
  int n;
};

// Warp 0 lists the rows [lo, hi) (hi - lo <= kMaxRows), kListBallots
// ballots of 32 rows a round, their want and verdict loads issued
// together: at R = 64 one round trip; one barrier for the block.  Each
// entry holds its row less lo.  Returns how many rows are listed.
template <bool kHold>
__device__ __forceinline__ int list_rows(const Args& a, Listing& s, int lo,
                                         int hi) {
  const int lane = static_cast<int>(threadIdx.x);
  if (lane < 32) {
    int n = 0;
    for (int r0 = lo; r0 < hi; r0 += 32 * kListBallots) {
      bool take[kListBallots];
      int v[kListBallots];
#pragma unroll
      for (int q = 0; q < kListBallots; ++q) {
        const int r = r0 + 32 * q + lane;
        take[q] = r < hi && (a.want == nullptr || __ldg(a.want + r) != 0);
        v[q] = kHold && r < hi ? __ldg(a.verdict + r) : 0;
      }
#pragma unroll
      for (int q = 0; q < kListBallots; ++q) {
        const int r = r0 + 32 * q + lane;
        // A verdict outside 0..3 holds no byte: its row is not read.
        const bool on = take[q] && (!kHold || (v[q] >= 0 && v[q] <= 3));
        const unsigned m = __ballot_sync(0xFFFFFFFFu, on);
        if (on) {
          s.rows[n + __popc(m & ((1u << lane) - 1u))] =
              static_cast<uint32_t>(r - lo) |
              (kHold ? static_cast<uint32_t>(v[q]) << 12 : 0u);
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

__device__ __forceinline__ Split split(const Args& a, int n_live) {
  Split p;
  p.spans = a.ndev * a.spans;
  const int fill = static_cast<int>(gridDim.x) / p.spans;
  p.groups = fill >= n_live ? n_live : (fill < 1 ? 1 : fill);
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
// the row covers columns [a - 16 + 16 u, a + 16 u).
__device__ __forceinline__ int phase(const uint8_t* row) {
  return static_cast<int>((0u - reinterpret_cast<uintptr_t>(row)) & 15u);
}

// A 16-byte load from the matrix at p, which must be 16-byte aligned: the
// card faults otherwise, and the host build of this file (its tests) traps.
__device__ __forceinline__ const uint4* at16(const uint8_t* p) {
#ifndef __CUDA_ARCH__
  if ((reinterpret_cast<uintptr_t>(p) & 15u) != 0u) __builtin_trap();
#endif
  return reinterpret_cast<const uint4*>(p);
}

// The unit at p (first column c0 of a row of L bytes) as four words, the
// bytes outside the row 0: one 16-byte load where the unit lies wholly in
// the row, else byte loads.
__device__ __forceinline__ void load_unit(const uint8_t* p, int c0, int L,
                                          uint32_t w[kWords]) {
  if (c0 >= 0 && c0 <= L - kCols) {
    const uint4 v = __ldg(at16(p));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    return;
  }
#pragma unroll
  for (int k = 0; k < kWords; ++k) w[k] = 0u;
  if (c0 <= -kCols || c0 >= L) return;
  for (int k = 0; k < kCols; ++k) {
    if (c0 + k >= 0 && c0 + k < L) {
      w[k / 4] |= static_cast<uint32_t>(__ldg(p + k)) << (8 * (k % 4));
    }
  }
}

// A thread's kUnits units of one row (its first unit u0, the others
// kThreads units apart), loaded; a unit past the row's last is zero.
struct RowUnits {
  uint32_t w[kUnits][kWords];
};

__device__ __forceinline__ void load_row(const Args& a, const uint8_t* row,
                                         int u0, RowUnits& b) {
  const int c00 = phase(row) - kCols + kCols * u0;
  if (c00 >= 0 && c00 <= a.L - kCols - kCols * kThreads * (kUnits - 1)) {
    // Every unit whole: kUnits 16-byte loads, no test a unit.
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      const uint4 v = __ldg(at16(row + c00 + kCols * kThreads * k));
      b.w[k][0] = v.x; b.w[k][1] = v.y; b.w[k][2] = v.z; b.w[k][3] = v.w;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const int c0 = c00 + kCols * kThreads * k;
    if (u0 + kThreads * k < a.units) {
      load_unit(row + c0, c0, a.L, b.w[k]);
    } else {
#pragma unroll
      for (int q = 0; q < kWords; ++q) b.w[k][q] = 0u;
    }
  }
}

// The 16 staged member bytes at byte offset `off` of the span's, as four
// words, by path P: 0 where off % 16 == 0 (one 16-byte read), else 1 + the
// word offset (off % 16) / 4: the two aligned 16-byte words around them
// and funnel shifts.
template <int P>
__device__ __forceinline__ void member_at(const uint4* s, int off,
                                          uint32_t m[kWords]) {
  const uint4 lo = s[off >> 4];
  if (P == 0) {
    m[0] = lo.x; m[1] = lo.y; m[2] = lo.z; m[3] = lo.w;
    return;
  }
  const uint4 hi = s[(off >> 4) + 1];
  const uint32_t x[2 * kWords] = {lo.x, lo.y, lo.z, lo.w,
                                  hi.x, hi.y, hi.z, hi.w};
  const int sh = 8 * (off & 3);
#pragma unroll
  for (int k = 0; k < kWords; ++k) m[k] = funnel(x[P - 1 + k], x[P + k], sh);
}

__device__ __forceinline__ int member_path(int off) {
  return (off & 15) == 0 ? 0 : 1 + ((off & 15) >> 2);
}

// A row's counts over a thread's units, member by path P: the flags added
// as bytes into acc (at most kUnits * kWords a byte).  vw: the verdict
// times kLsb (the spread's form).
template <bool kHold, int P>
__device__ __forceinline__ void count_units(const RowUnits& b,
                                            const uint4* s_mem, int off,
                                            uint32_t vw, uint32_t age_w,
                                            uint32_t acc[Form<kHold>::kNum]) {
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    uint32_t m[kWords];
    member_at<P>(s_mem, off + kCols * kThreads * k, m);
#pragma unroll
    for (int q = 0; q < kWords; ++q) {
      const uint32_t w = b.w[k][q];
      const uint32_t lo = w >> 6, hi = w >> 7;  // bit 0 of each byte
      if (kHold) {
        const uint32_t x = lo ^ vw;
        acc[0] += ~(x | (x >> 1)) & m[q];
      } else {
        acc[0] += hi & ~lo & m[q];
        acc[1] += hi & lo & m[q];
        // Bit 4 of age + 16 - budget is set iff age >= budget.
        const uint32_t old = (w & kLow4) + age_w;
        acc[2] += (hi | lo) & ~(old >> 4) & kLsb;
      }
    }
  }
}

// Listed row j (entry v) of the item, loaded in b: its counts summed over
// the thread's units, the warp, then added into the block's s_cnt.
template <bool kHold>
__device__ __forceinline__ void count_row(const Args& a, const uint8_t* row,
                                          uint32_t v, int j, int delta,
                                          const uint4* s_mem,
                                          const RowUnits& b,
                                          uint32_t* s_cnt) {
  constexpr int kNum = Form<kHold>::kNum;
  // Unit 0's member bytes sit at smem byte delta + c00 - (16 kSpan s - 16).
  const int off = delta + phase(row) + kCols * static_cast<int>(threadIdx.x);
  const uint32_t vw = ((v >> 12) & 3u) * kLsb;
  uint32_t acc[kNum] = {};
  switch (member_path(off)) {
    case 0: count_units<kHold, 0>(b, s_mem, off, vw, a.age_w, acc); break;
    case 1: count_units<kHold, 1>(b, s_mem, off, vw, a.age_w, acc); break;
    case 2: count_units<kHold, 2>(b, s_mem, off, vw, a.age_w, acc); break;
    case 3: count_units<kHold, 3>(b, s_mem, off, vw, a.age_w, acc); break;
    default: count_units<kHold, 4>(b, s_mem, off, vw, a.age_w, acc); break;
  }
  const bool lane0 = (threadIdx.x & 31u) == 0u;
#pragma unroll
  for (int c = 0; c < kNum; ++c) {
    const uint32_t n = __reduce_add_sync(0xFFFFFFFFu, (acc[c] * kLsb) >> 24);
    if (lane0 && n != 0u) atomicAdd(&s_cnt[j * kNum + c], n);
  }
}

// The 16-byte word at address w of member with its bytes outside [lo, hi)
// zeroed.
__device__ __forceinline__ uint4 member_word(uintptr_t w, uintptr_t lo,
                                             uintptr_t hi) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (w + kCols <= lo || w >= hi) return v;
  v = __ldg(reinterpret_cast<const uint4*>(w));
  if (w < lo || w + kCols > hi) {
    uint32_t x[kWords] = {v.x, v.y, v.z, v.w};
    for (int e = 0; e < kCols; ++e) {
      if (w + e < lo || w + e >= hi) x[e / 4] &= ~(0xFFu << (8 * (e % 4)));
    }
    v = make_uint4(x[0], x[1], x[2], x[3]);
  }
  return v;
}

// The counts of one item: its first row's units loaded, its span's member
// staged, then its rows in turn, each row's units loaded before the row
// before it is counted.  The listed rows count from row row0 (the wide
// form's chunk; else 0).
template <bool kHold>
__device__ __forceinline__ void count_item(const Args& a, const Item& it,
                                           int row0, const uint32_t* rows,
                                           uint32_t* s_cnt, uint4* s_mem) {
  const int t = static_cast<int>(threadIdx.x);
  const int u0 = it.s * kSpan + t;
  const size_t L = static_cast<size_t>(a.L);
  const uint8_t* const shard = a.in[it.i] + static_cast<size_t>(row0) * L;
  RowUnits cur, next;
  load_row(a, shard + (rows[it.jlo] & 0x3FFu) * L, u0, cur);

  // The span's member bytes: the aligned 16-byte words from column
  // 16 kSpan s - 16 on (what any row's units of the span reach), the bytes
  // outside the shard zero; smem byte delta + c - (16 kSpan s - 16) holds
  // column c's.
  const uintptr_t m_lo = reinterpret_cast<uintptr_t>(a.member) + it.i * L;
  const uintptr_t from =
      m_lo + static_cast<uintptr_t>(kCols) * kSpan * it.s - kCols;
  const int delta = static_cast<int>(from & 15u);
  const uintptr_t w0 = from - delta;
  for (int k = t; k < kSpan + 2; k += kThreads) {
    s_mem[k] = member_word(w0 + static_cast<uintptr_t>(kCols) * k, m_lo,
                           m_lo + L);
  }
  __syncthreads();

  for (int j = it.jlo; j < it.jhi; j += 2) {
    if (j + 1 < it.jhi) {
      load_row(a, shard + (rows[j + 1] & 0x3FFu) * L, u0, next);
    }
    count_row<kHold>(a, shard + (rows[j] & 0x3FFu) * L, rows[j], j, delta,
                     s_mem, cur, s_cnt);
    if (j + 1 >= it.jhi) break;
    if (j + 2 < it.jhi) {
      load_row(a, shard + (rows[j + 2] & 0x3FFu) * L, u0, cur);
    }
    count_row<kHold>(a, shard + (rows[j + 1] & 0x3FFu) * L, rows[j + 1],
                     j + 1, delta, s_mem, next, s_cnt);
  }
  __syncthreads();  // the next item stages over s_mem
}

// The block's counts of the n_live rows listed from row0 into the
// scratch, one atomicAdd a nonzero count.
template <bool kHold>
__device__ __forceinline__ void flush_counts(const Args& a, int row0,
                                             const Listing& s_list,
                                             const uint32_t* s_cnt,
                                             int n_live) {
  constexpr int kNum = Form<kHold>::kNum;
  constexpr int kFirst = Form<kHold>::kFirst;
  for (int e = static_cast<int>(threadIdx.x); e < n_live * kNum;
       e += kThreads) {
    const int j = e / kNum;
    const int c = e - j * kNum;
    if (s_cnt[e] != 0u) {
      atomicAdd(a.scratch + static_cast<size_t>(kFirst + c) * a.R + row0 +
                    (s_list.rows[j] & 0x3FFu),
                s_cnt[e]);
    }
  }
}

// Arrive at the scratch's counter after `working` blocks' counts; the
// last to arrive copies the scratch into out and zeroes it and the
// counter.
template <bool kHold>
__device__ __forceinline__ void arrive_and_write(const Args& a, int working,
                                                 int* s_last) {
  constexpr int kNum = Form<kHold>::kNum;
  constexpr int kFirst = Form<kHold>::kFirst;
  const int t = static_cast<int>(threadIdx.x);
  uint32_t* arrive = a.scratch + static_cast<size_t>(kCounts) * a.R;
  __syncthreads();
  if (t == 0) {
    *s_last = add_release(arrive) == static_cast<unsigned>(working - 1);
    if (*s_last) fence_acquire();
  }
  __syncthreads();
  if (!*s_last) return;
  for (int e = t; e < kCounts * a.R; e += kThreads) {
    const int c = e / a.R;
    uint32_t v = 0u;
    if (c >= kFirst && c < kFirst + kNum) {
      v = __ldcg(a.scratch + e);
      if (v != 0u) a.scratch[e] = 0u;
    }
    a.out[e] = static_cast<int32_t>(v);
  }
  if (t == 0) *arrive = 0u;
}

// kHold: the spread's form (a verdict), else the final matrix's.  An
// instance each, so that a profile tells the two uses of a round apart by
// name.
template <bool kHold>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
counts_kernel(const __grid_constant__ Args a) {
  constexpr int kNum = Form<kHold>::kNum;
  __shared__ Listing s_list;
  __shared__ uint32_t s_cnt[kMaxRows * kNum];
  __shared__ uint4 s_mem[kSpan + 2];
  __shared__ int s_last;
  if (kHold) trigger_dependents();
  const int t = static_cast<int>(threadIdx.x);
  const int b = static_cast<int>(blockIdx.x);
  const int n_live = list_rows<kHold>(a, s_list, 0, a.R);
  if (n_live == 0) {
    if (b == 0) {
      for (int e = t; e < kCounts * a.R; e += kThreads) a.out[e] = 0;
    }
    return;
  }
  const Split p = split(a, n_live);
  if (b >= p.items) return;

  for (int e = t; e < n_live * kNum; e += kThreads) s_cnt[e] = 0u;
  __syncthreads();
  for (int x = b; x < p.items; x += static_cast<int>(gridDim.x)) {
    count_item<kHold>(a, item_of(a, p, x, n_live), 0, s_list.rows, s_cnt,
                      s_mem);
  }

  // The block's counts into the scratch, then arrive; the last of the
  // blocks that had an item writes out and zeroes the scratch.
  flush_counts<kHold>(a, 0, s_list, s_cnt, n_live);
  arrive_and_write<kHold>(a, p.items < static_cast<int>(gridDim.x)
                                 ? p.items : static_cast<int>(gridDim.x),
                          &s_last);
}

// The counts at R > kMaxRows: the rows in chunks of kMaxRows, each listed,
// cut into items and counted as a launch of kMaxRows rows is, its counts
// flushed into the scratch at their rows with one atomic a count a block;
// then every block of the grid arrives (a block may have had items in one
// chunk and none in another), and the last writes out.  kHold as
// counts_kernel's, the trigger as early.
template <bool kHold>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
counts_wide_kernel(const __grid_constant__ Args a) {
  constexpr int kNum = Form<kHold>::kNum;
  __shared__ Listing s_list;
  __shared__ uint32_t s_cnt[kMaxRows * kNum];
  __shared__ uint4 s_mem[kSpan + 2];
  __shared__ int s_last;
  if (kHold) trigger_dependents();
  const int t = static_cast<int>(threadIdx.x);
  const int b = static_cast<int>(blockIdx.x);
  for (int row0 = 0; row0 < a.R; row0 += kMaxRows) {
    const int hi = a.R - row0 < kMaxRows ? a.R : row0 + kMaxRows;
    const int n_live = list_rows<kHold>(a, s_list, row0, hi);
    const Split p = split(a, n_live);
    if (n_live != 0 && b < p.items) {
      for (int e = t; e < n_live * kNum; e += kThreads) s_cnt[e] = 0u;
      __syncthreads();
      for (int x = b; x < p.items; x += static_cast<int>(gridDim.x)) {
        count_item<kHold>(a, item_of(a, p, x, n_live), row0, s_list.rows,
                          s_cnt, s_mem);
      }
      flush_counts<kHold>(a, row0, s_list, s_cnt, n_live);
    }
    __syncthreads();  // the next chunk lists over s_list and s_cnt
  }
  arrive_and_write<kHold>(a, static_cast<int>(gridDim.x), &s_last);
}

// The grid of a launch of form kHold: one block an item at most (the
// most items: every row listed, a group a row), at most one wave of the
// blocks an SM the occupancy query gives (kBlocksPerSM at most) on the
// current device.
template <bool kHold>
inline cudaError_t grid_of(const Args& a, int* blocks) {
  void (*kernel)(Args) = a.R > kMaxRows ? counts_wide_kernel<kHold>
                                        : counts_kernel<kHold>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, 0);
  }
  if (e != cudaSuccess) return e;
  if (sms < 1 || per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long most = static_cast<long long>(a.ndev) * a.spans * a.R;
  const long long wave =
      static_cast<long long>(sms) * (per_sm < kBlocksPerSM ? per_sm
                                                           : kBlocksPerSM);
  *blocks = static_cast<int>(most < wave ? most : wave);
  return cudaSuccess;
}

// The launch's geometry; false for one the kernel does not take.
inline bool geometry(Args& a, int ndev, int R, int L) {
  if (R < 1 || R > kMaxSlots || L < 1 || ndev < 1 || ndev > kMaxShards ||
      static_cast<long long>(ndev) * L >= (1LL << 31) - kCols) {
    return false;
  }
  a.R = R;
  a.L = L;
  a.ndev = ndev;
  a.units = (L + kCols - 1) / kCols + 1;
  a.spans = (a.units + kSpan - 1) / kSpan;
  return true;
}

inline bool aligned(const void* p, uintptr_t n) {
  return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0;
}

}  // namespace observe

// The scratch words heard_counts needs at R rows (uint32, zero before the
// first launch; every launch leaves it zero).
extern "C" long long heard_counts_scratch_words(int R) {
  return observe::scratch_words(R);
}

// The blocks of a heard_counts launch at (R, L, ndev) in the form `hold`
// (a verdict given) on the current device, or a negative CUDA error (or
// -cudaErrorInvalidValue for a geometry it does not take).
extern "C" int heard_counts_blocks(int R, int L, int ndev, int hold) {
  using namespace observe;
  Args a{};
  if (!geometry(a, ndev, R, L)) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  int blocks = 0;
  const cudaError_t e = hold ? grid_of<true>(a, &blocks)
                             : grid_of<false>(a, &blocks);
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
}

// out[4, R] = the counts of the top of this file over heard, given as
// ndev shard pointers to u8 [R, L] (R <= 2**24, N = ndev * L < 2**31 - 16,
// any alignment); member: one byte per global column; verdict: int32 [R]
// (the spread's form) or nullptr (the final matrix's); want: one byte per
// row or nullptr (every row); out: int32 [4, R], written whole; scratch: at
// least heard_counts_scratch_words(R) uint32 words, 4-byte aligned, zero
// (and left zero; one launch at a time may use it); budget: ages below it
// count as live.  Launches on `stream`, does not synchronise, returns
// cudaGetLastError() after the launch (or cudaErrorInvalidValue for
// arguments it does not take, or the occupancy query's error).
extern "C" int heard_counts(const void* const* shards, int ndev,
                            const void* member, const void* verdict,
                            const void* want, void* out, void* scratch,
                            int R, int L, int budget, void* stream) {
  using namespace observe;
  Args a{};
  if (shards == nullptr || member == nullptr || out == nullptr ||
      scratch == nullptr || !aligned(scratch, 4) ||
      !geometry(a, ndev, R, L)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int j = 0; j < ndev; ++j) {
    if (shards[j] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    a.in[j] = static_cast<const uint8_t*>(shards[j]);
  }
  a.member = static_cast<const uint8_t*>(member);
  a.verdict = static_cast<const int32_t*>(verdict);
  a.want = static_cast<const uint8_t*>(want);
  a.out = static_cast<int32_t*>(out);
  a.scratch = static_cast<uint32_t*>(scratch);
  const int b = budget < 0 ? 0 : (budget > 16 ? 16 : budget);
  a.age_w = static_cast<uint32_t>(16 - b) * kLsb;
  int blocks = 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.verdict != nullptr) {
    const cudaError_t e = grid_of<true>(a, &blocks);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (R > kMaxRows) {
      counts_wide_kernel<true><<<blocks, kThreads, 0, s>>>(a);
    } else {
      counts_kernel<true><<<blocks, kThreads, 0, s>>>(a);
    }
  } else {
    const cudaError_t e = grid_of<false>(a, &blocks);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (R > kMaxRows) {
      counts_wide_kernel<false><<<blocks, kThreads, 0, s>>>(a);
    } else {
      counts_kernel<false><<<blocks, kThreads, 0, s>>>(a);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* observe_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
