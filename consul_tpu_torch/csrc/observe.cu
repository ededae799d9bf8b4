// The round's observers on the belief matrix, for Hopper (sm_90a): masked
// per-row counts over heard[R, N], every count in one read, one launch
// for all column shards.
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
// the table of one).  member is one byte (0 or 1) per global column.  For
// each row r it reads (every row, or where want[r] != 0):
//   out[0, r] = #columns with msg == DEAD (2) and member;
//   out[1, r] = #columns with msg == REFUTE (3) and member;
//   out[2, r] = #columns with msg > 0 and age < budget (no member mask);
//   out[3, r] = #columns with msg == verdict[r] and member (0 without a
//               verdict, or for a verdict outside 0..3);
// and 0 in every count of a row it does not read.  int32, exact: a count
// is at most N.
//
// Bound.  One pass must read the rows it counts and member, and write
// out: at [64, 1M] 65 MB, 0.0194 ms at 3.35 TB/s.  Its integer
// operations, counted by hand from the rule below in instruction slots
// (chip_smoke.py observe_ops_per_word: 17 a 32-bit word of four bytes),
// take 0.0162 ms there at 67e12 / 4 ops/s; chip_smoke.py takes the
// larger, the bytes.  A launch
// whose want rows are all 0 reads no row (the spread's launch in a round
// where no slot is recycled): its time is the launch's.
//
// Work split.  A thread takes units of kCols = 16 columns of one shard
// (four words) and the kRows rows of its block's row group (blockIdx.y);
// the grid's threads stride over the units of all shards, so neighbouring
// threads read neighbouring 16 bytes.  A unit's member bytes are loaded
// once for its rows, and every row's words are loaded before any is
// counted.  The path is the launch's: 16-byte loads where L % 16 == 0 and
// every buffer is 16-byte aligned, 4-byte loads where L % 4 == 0 and they
// are 4-byte aligned, and byte loads otherwise (the bytes packed into
// words, zero past the row's end: a zero byte with a zero member byte
// adds to no count).
//
// The rule, four bytes at a time (belief_merge.cuh's masks): the message
// field's two bits as 0x01-per-byte flags hi and lo; DEAD is hi & ~lo,
// REFUTE hi & lo, a message hi | lo; the age test is bit 4 of ((age | 16)
// - budget), clear iff age < budget, with no borrow between bytes for a
// budget in [0, 16] (the launcher clamps it there: the same test for any
// budget); equality with the verdict is msg ^ (verdict * kLsb) == 0 in a
// byte.  The flags of a unit's four words are added as bytes (each at
// most 4) and summed across the bytes with one multiply.
//
// The counts.  A thread keeps kRows x 4 counts in registers; at the end
// each is summed over its warp (__reduce_add_sync), the warps' sums meet
// in shared memory, and the block adds each nonzero count to the scratch
// with one atomicAdd.  Integer sums are exact in any order.  The last
// block to arrive (a grid counter in the scratch, added to with release
// semantics; the last acquires) copies the scratch into out, zeroes it
// and the counter: so the scratch is zero between launches (its owner
// makes it zero once), out needs no memset, and a use is one launch that
// reads nothing from the host: it runs inside the round program's
// captured graphs.  One scratch serves one launch at a time; a scratch
// made for more rows serves fewer (its words past the launch's stay 0).

#include <cuda_runtime.h>

#include <cstdint>

#include "belief_merge.cuh"

namespace observe {

constexpr int kMaxShards = 64;
constexpr int kCounts = 4;         // dead, refute, live, hold
constexpr int kThreads = 256;
constexpr int kCols = 16;          // a unit: columns of one shard
constexpr int kWords = kCols / 4;
constexpr int kRows = 4;           // rows of a row group (blockIdx.y)
// Blocks the launcher aims at: 8 of 256 threads on each of the H100's 132
// SMs; a small matrix takes fewer (a thread a unit at least).
constexpr int kFillBlocks = 132 * 8;
constexpr uint32_t kAge16 = 0x10101010u;  // bit 4 of each byte

enum Path { kBytes = 0, kWords4 = 1, kWords16 = 2 };

// Everything a launch needs, passed by value (about 600 bytes of the 4 KB
// parameter block) as a __grid_constant__.
struct Args {
  const uint8_t* in[kMaxShards];  // the ndev shards, u8 [R, L] each
  const uint8_t* member;          // [N], one byte (0/1) per global column
  const int32_t* verdict;         // [R], or nullptr: no holders counted
  const uint8_t* want;            // [R], or nullptr: every row read
  int32_t* out;                   // [kCounts, R]
  uint32_t* scratch;              // >= scratch_words(R), zero between launches
  int R, L, ndev;
  int units;      // units a shard, ceil(L / kCols)
  int blocks;     // blocks along x
  int groups;     // row groups, ceil(R / kRows)
  uint32_t budget_w;  // the budget clamped into [0, 16], times kLsb
  int path;
};

// The scratch, in 32-bit words: the counts [kCounts, R], then the grid's
// arrival counter.
__host__ __device__ inline long long scratch_words(long long R) {
  return kCounts * R + 1;
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

// The n (<= kCols) bytes at p as four words, zero past n, by the launch's
// path: one 16-byte load (n == kCols there), n / 4 aligned words, or
// bytes.
__device__ __forceinline__ void load_unit(const uint8_t* p, int n, int path,
                                          uint32_t w[kWords]) {
  if (path == kWords16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    return;
  }
  if (path == kWords4) {
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      w[k] = 4 * k < n ? __ldg(reinterpret_cast<const uint32_t*>(p) + k)
                       : 0u;
    }
    return;
  }
  uint32_t b[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    b[k] = k < n ? static_cast<uint32_t>(__ldg(p + k)) : 0u;
  }
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    w[k] = b[4 * k] | b[4 * k + 1] << 8 | b[4 * k + 2] << 16 |
           b[4 * k + 3] << 24;
  }
}

// One row's counts over a unit: the flags of its four words added as
// bytes (at most 4 a byte), then summed across the bytes.  m: the member
// bytes; vw: the verdict times kLsb; hm: all ones where holders are
// counted, else 0.
__device__ __forceinline__ void count_unit(const uint32_t w[kWords],
                                           const uint32_t m[kWords],
                                           uint32_t vw, uint32_t hm,
                                           uint32_t budget_w,
                                           uint32_t cnt[kCounts]) {
  uint32_t acc[kCounts] = {};
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const uint32_t msg = (w[k] >> 6) & kLow2;
    const uint32_t hi = (msg >> 1) & kLsb;
    const uint32_t lo = msg & kLsb;
    const uint32_t mk = m[k];
    acc[0] += hi & ~lo & mk;
    acc[1] += hi & lo & mk;
    const uint32_t young = ((w[k] & kLow4) | kAge16) - budget_w;
    acc[2] += (hi | lo) & ~(young >> 4) & kLsb;
    const uint32_t x = msg ^ vw;
    acc[3] += ~(x | (x >> 1)) & kLsb & mk & hm;
  }
#pragma unroll
  for (int c = 0; c < kCounts; ++c) cnt[c] += (acc[c] * kLsb) >> 24;
}

// kWanted: the launch has a want mask (the spread's form).  An instance
// each, so that a profile tells the two uses of a round apart by name.
template <bool kWanted>
__global__ void __launch_bounds__(kThreads)
counts_kernel(const __grid_constant__ Args a) {
  const int t = static_cast<int>(threadIdx.x);
  const int r0 = static_cast<int>(blockIdx.y) * kRows;

  // The group's rows: read or not, and each one's verdict word.
  bool take[kRows];
  uint32_t vw[kRows], hm[kRows];
  bool any = false;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int r = r0 + j;
    take[j] = r < a.R && (!kWanted || __ldg(a.want + r) != 0);
    const int v = take[j] && a.verdict != nullptr ? __ldg(a.verdict + r)
                                                  : -1;
    const bool on = v >= 0 && v <= 3;
    hm[j] = on ? ~0u : 0u;
    vw[j] = on ? static_cast<uint32_t>(v) * kLsb : 0u;
    any = any || take[j];
  }

  uint32_t cnt[kRows][kCounts] = {};
  if (any) {
    const int total = a.ndev * a.units;
    const int stride = a.blocks * kThreads;
    for (int u = static_cast<int>(blockIdx.x) * kThreads + t; u < total;
         u += stride) {
      const int i = u / a.units;
      const int c0 = (u - i * a.units) * kCols;
      const int n = min(kCols, a.L - c0);
      uint32_t m[kWords];
      load_unit(a.member + static_cast<size_t>(i) * a.L + c0, n, a.path, m);
      uint32_t w[kRows][kWords];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (take[j]) {
          load_unit(a.in[i] + static_cast<size_t>(r0 + j) * a.L + c0, n,
                    a.path, w[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (take[j]) count_unit(w[j], m, vw[j], hm[j], a.budget_w, cnt[j]);
      }
    }
  }

  // The block's counts: warp sums, met in shared memory, one atomic each
  // into the scratch.
  __shared__ uint32_t s_cnt[kRows * kCounts];
  __shared__ int s_last;
  if (t < kRows * kCounts) s_cnt[t] = 0u;
  __syncthreads();
  const int lane = t & 31;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
#pragma unroll
    for (int c = 0; c < kCounts; ++c) {
      const uint32_t v = __reduce_add_sync(0xFFFFFFFFu, cnt[j][c]);
      if (lane == 0 && v != 0u) atomicAdd(&s_cnt[j * kCounts + c], v);
    }
  }
  __syncthreads();
  if (t < kRows * kCounts) {
    const int j = t / kCounts;
    const int c = t % kCounts;
    if (r0 + j < a.R && s_cnt[t] != 0u) {
      atomicAdd(a.scratch + static_cast<size_t>(c) * a.R + r0 + j,
                s_cnt[t]);
    }
  }

  // Arrive at the grid (release: the block's counts first); the last
  // block acquires every block's, writes out and zeroes the scratch.
  uint32_t* arrive = a.scratch + static_cast<size_t>(kCounts) * a.R;
  __syncthreads();
  if (t == 0) {
    s_last = add_release(arrive) ==
             static_cast<unsigned>(a.blocks * a.groups - 1);
    if (s_last) fence_acquire();
  }
  __syncthreads();
  if (!s_last) return;
  for (int e = t; e < kCounts * a.R; e += kThreads) {
    const uint32_t v = __ldcg(a.scratch + e);
    a.scratch[e] = 0u;
    a.out[e] = static_cast<int32_t>(v);
  }
  if (t == 0) *arrive = 0u;
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

// out[4, R] = the counts of the top of this file over heard, given as
// ndev shard pointers to u8 [R, L] (N = ndev * L < 2**31 - 16); member:
// one byte per global column; verdict: int32 [R] or nullptr; want: one
// byte per row or nullptr (every row); out: int32 [4, R], written whole;
// scratch: at least heard_counts_scratch_words(R) uint32 words, 4-byte
// aligned, zero (and left zero; one launch at a time may use it); budget: ages
// below it count as live.  Launches on `stream`, does not synchronise,
// returns cudaGetLastError() after the launch (or cudaErrorInvalidValue
// for arguments it does not take).
extern "C" int heard_counts(const void* const* shards, int ndev,
                            const void* member, const void* verdict,
                            const void* want, void* out, void* scratch,
                            int R, int L, int budget, void* stream) {
  using namespace observe;
  if (shards == nullptr || member == nullptr || out == nullptr ||
      scratch == nullptr || !aligned(scratch, 4) || R < 1 ||
      R > 65535 * kRows || L < 1 || ndev < 1 || ndev > kMaxShards ||
      static_cast<long long>(ndev) * L >= (1LL << 31) - kCols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{};
  bool w4 = L % 4 == 0 && aligned(member, 4);
  bool w16 = L % kCols == 0 && aligned(member, 16);
  for (int j = 0; j < ndev; ++j) {
    if (shards[j] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    a.in[j] = static_cast<const uint8_t*>(shards[j]);
    w4 = w4 && aligned(shards[j], 4);
    w16 = w16 && aligned(shards[j], 16);
  }
  a.member = static_cast<const uint8_t*>(member);
  a.verdict = static_cast<const int32_t*>(verdict);
  a.want = static_cast<const uint8_t*>(want);
  a.out = static_cast<int32_t*>(out);
  a.scratch = static_cast<uint32_t*>(scratch);
  a.R = R;
  a.L = L;
  a.ndev = ndev;
  a.units = (L + kCols - 1) / kCols;
  a.groups = (R + kRows - 1) / kRows;
  const long long need = (static_cast<long long>(ndev) * a.units +
                          kThreads - 1) / kThreads;
  const long long fill = (kFillBlocks + a.groups - 1) / a.groups;
  a.blocks = static_cast<int>(need < fill ? need : fill);
  const int b = budget < 0 ? 0 : (budget > 16 ? 16 : budget);
  a.budget_w = static_cast<uint32_t>(b) * kLsb;
  a.path = w16 ? kWords16 : (w4 ? kWords4 : kBytes);
  const dim3 grid(static_cast<unsigned>(a.blocks),
                  static_cast<unsigned>(a.groups));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.want != nullptr) {
    counts_kernel<true><<<grid, kThreads, 0, s>>>(a);
  } else {
    counts_kernel<false><<<grid, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* observe_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
