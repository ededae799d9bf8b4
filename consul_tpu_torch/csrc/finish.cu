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
// rows written.  A round with no live row pays a launch: every block
// reads the R row arguments and leaves.  The rule is 17 integer
// instructions a 32-bit word of four bytes, counted by hand in issue slots
// (chip_smoke.py finish_ops_per_word): at 67e12 / 4 ops/s under the
// bytes' time at 3.35 TB/s, so the bytes bound it.
//
// Work split.  Every block first lists the rows to touch in shared memory
// (warp 0, 32 row arguments a ballot, in row order, the same list in
// every block), then the grid's threads stride over (listed row, unit)
// pairs, a unit being kCols = 16 columns of one shard, neighbouring
// threads on neighbouring units of a row.  The path is the launch's, as
// observe.cu's: 16-byte accesses where L % 16 == 0 and every buffer is
// 16-byte aligned, 4-byte ones where L % 4 == 0 and they are 4-byte
// aligned, and bytes otherwise (a ragged unit's bytes past the row's end
// are neither read nor written).  The fire writes only the words (bytes,
// on the byte path) that change.
//
// fired without a memset.  A thread that fires a byte marks its listed
// row in shared memory; the block adds its marks into a caller's scratch
// (one word a row, atomicOr) and arrives at a grid counter after them
// (release); the last block to arrive (acquire) writes fired[0, R) from
// the scratch and zeroes the scratch and the counter.  So the scratch is
// zero between launches (its owner makes it zero once, observe.cu's
// scratch serves: a launch uses its first R + 1 words), fired needs no
// memset, and a launch reads nothing from the host: it runs inside the
// round program's captured graphs.  One scratch serves one launch at a
// time.

#include <cuda_runtime.h>

#include <cstdint>

#include "belief_merge.cuh"

namespace finish {

constexpr int kMaxShards = 64;
constexpr int kMaxRows = 2048;     // rows a launch takes (the listed rows)
constexpr int kThreads = 256;
constexpr int kCols = 16;          // a unit: columns of one shard
constexpr int kWords = kCols / 4;
// Blocks the launcher aims at: 8 of 256 threads on each of the H100's 132
// SMs; a small matrix takes fewer (a thread a unit of every row at least).
constexpr int kFillBlocks = 132 * 8;
constexpr uint32_t kDead = 0x80u;  // DEAD, conf 0, age 0
constexpr uint32_t kBit4 = 0x10101010u;  // bit 4 of each byte

enum Path { kBytes = 0, kWords4 = 1, kWords16 = 2 };

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
  int units;      // units a shard, ceil(L / kCols)
  int blocks;
  int path;
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

// A mark that several threads of a block may set at once (each writes 1).
__device__ __forceinline__ void mark(uint32_t* p) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<volatile uint32_t*>(p) = 1u;
#else
  __atomic_store_n(p, 1u, __ATOMIC_RELAXED);
#endif
}

// The rows whose argument sel[r] is nonzero, in row order, into list[];
// returns how many.  Warp 0 builds it, 32 rows a ballot; every block
// builds the same list.
__device__ __forceinline__ int list_rows(const uint8_t* sel, int R,
                                         uint16_t* list, int* s_n) {
  const int t = static_cast<int>(threadIdx.x);
  if (t < 32) {
    int n = 0;
    for (int r0 = 0; r0 < R; r0 += 32) {
      const int r = r0 + t;
      const bool on = r < R && __ldg(sel + r) != 0;
      const unsigned m = __ballot_sync(0xFFFFFFFFu, on);
      if (on) {
        list[n + __popc(m & ((1u << t) - 1u))] = static_cast<uint16_t>(r);
      }
      n += __popc(m);
    }
    if (t == 0) *s_n = n;
  }
  __syncthreads();
  return *s_n;
}

// The n (<= kCols) bytes at p as four words, zero past n, by the launch's
// path (observe.cu's load_unit).
__device__ __forceinline__ void load_unit(const uint8_t* p, int n, int path,
                                          uint32_t w[kWords]) {
  if (path == kWords16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    return;
  }
  if (path == kWords4) {
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      w[k] = 4 * k < n ? reinterpret_cast<const uint32_t*>(p)[k] : 0u;
    }
    return;
  }
  uint32_t b[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    b[k] = k < n ? static_cast<uint32_t>(p[k]) : 0u;
  }
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    w[k] = b[4 * k] | b[4 * k + 1] << 8 | b[4 * k + 2] << 16 |
           b[4 * k + 3] << 24;
  }
}

// The rx bytes of a unit (read-only for the whole launch).
__device__ __forceinline__ void load_rx(const uint8_t* p, int n, int path,
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

// Writes back the words of a unit that differ from what was read: a word
// at a time on the word paths, a byte at a time (the n of the unit) on
// the byte path.
__device__ __forceinline__ void store_changed(uint8_t* p, int n, int path,
                                              const uint32_t was[kWords],
                                              const uint32_t now[kWords]) {
  if (path != kBytes) {
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      if (now[k] != was[k] && 4 * k < n) {
        reinterpret_cast<uint32_t*>(p)[k] = now[k];
      }
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const uint32_t a = (was[k / 4] >> (8 * (k % 4))) & 0xFFu;
    const uint32_t b = (now[k / 4] >> (8 * (k % 4))) & 0xFFu;
    if (a != b && k < n) p[k] = static_cast<uint8_t>(b);
  }
}

// The fire rule on four bytes, each test at bit 4 of its byte (where conf
// bit 0 sits; w >> 1, >> 2 and >> 3 bring conf bit 1 and the message's
// two bits there, from the same byte): a byte whose message is SUSPECT
// (01), whose column takes messages (rx4: bit 4 set) and whose
// confirmation count c has bit c of the row's ok set (kc[c]: kBit4 where
// set, else 0) becomes kDead.  Returns the new word; fired_w gets bit 4
// in each byte that fired.
__device__ __forceinline__ uint32_t fire_word(uint32_t w, uint32_t rx4,
                                              const uint32_t kc[4],
                                              uint32_t& fired_w) {
  const uint32_t a = w >> 1;             // conf bit 1 at bit 4
  const uint32_t ok = (kc[0] & ~a & ~w) | (kc[1] & ~a & w) |
                      (kc[2] & a & ~w) | (kc[3] & a & w);
  const uint32_t f = ok & (w >> 2) & ~(w >> 3) & rx4;
  fired_w = f;
  const uint32_t fm = (f >> 4) * 0xFFu;  // 0xFF in each byte that fired
  return (w & ~fm) | (kDead * kLsb & fm);
}

__global__ void __launch_bounds__(kThreads)
fire_kernel(const __grid_constant__ Args a) {
  __shared__ uint16_t s_list[kMaxRows];
  __shared__ uint32_t s_fired[kMaxRows];
  __shared__ int s_n;
  __shared__ int s_last;
  const int t = static_cast<int>(threadIdx.x);
  const int n_live = list_rows(a.sel, a.R, s_list, &s_n);
  for (int j = t; j < n_live; j += kThreads) s_fired[j] = 0u;
  __syncthreads();

  const long long gtid =
      static_cast<long long>(blockIdx.x) * kThreads + t;
  const long long gstride = static_cast<long long>(a.blocks) * kThreads;

  // The refutation byte of a row that is not listed: one byte, by one
  // thread of the grid.  (A listed row's is applied in its unit below,
  // before the fire test.)
  if (a.col != nullptr) {
    for (long long row = gtid; row < a.R; row += gstride) {
      const uint8_t b = __ldg(a.rb + row);
      if (b == 0 || __ldg(a.sel + row) != 0) continue;
      const int c = __ldg(a.col + row);
      const int i = c / a.L;
      uint8_t* p = a.in[i] + row * a.L + (c - i * a.L);
      if (*p < b) *p = b;
    }
  }

  const int per_row = a.ndev * a.units;
  const long long total = static_cast<long long>(n_live) * per_row;
  int j_cur = -1;
  int r = 0, ref_i = -1, ref_u = -1, ref_k = 0;
  uint32_t kc[4] = {}, rb = 0u;
  for (long long x = gtid; x < total; x += gstride) {
    const int j = static_cast<int>(x / per_row);
    const int u = static_cast<int>(x - static_cast<long long>(j) * per_row);
    if (j != j_cur) {
      j_cur = j;
      r = s_list[j];
      const uint32_t ok = __ldg(a.sel + r);
#pragma unroll
      for (int c = 0; c < 4; ++c) kc[c] = ((ok >> c) & 1u) * kBit4;
      ref_i = -1;
      if (a.col != nullptr) {
        rb = __ldg(a.rb + r);
        if (rb != 0u) {
          const int c = __ldg(a.col + r);
          ref_i = c / a.L;
          const int lc = c - ref_i * a.L;
          ref_u = lc / kCols;
          ref_k = lc - ref_u * kCols;
        }
      }
    }
    const int i = u / a.units;
    const int un = u - i * a.units;
    const int c0 = un * kCols;
    const int n = min(kCols, a.L - c0);
    uint8_t* p = a.in[i] + static_cast<size_t>(r) * a.L + c0;
    uint32_t was[kWords], rxw[kWords], now[kWords];
    load_unit(p, n, a.path, was);
    load_rx(a.rx + static_cast<size_t>(i) * a.L + c0, n, a.path, rxw);
#pragma unroll
    for (int k = 0; k < kWords; ++k) now[k] = was[k];
    if (i == ref_i && un == ref_u) {
      // The refutation first: max of the byte and rb.
      const int w = ref_k / 4, s = 8 * (ref_k % 4);
      const uint32_t b = (now[w] >> s) & 0xFFu;
      if (b < rb) now[w] = (now[w] & ~(0xFFu << s)) | (rb << s);
    }
    uint32_t any = 0u;
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      uint32_t f;
      now[k] = fire_word(now[k], rxw[k] << 4, kc, f);
      any |= f;
    }
    store_changed(p, n, a.path, was, now);
    if (any != 0u) mark(&s_fired[j]);
  }

  // The block's marks into the scratch, then arrive at the grid; the
  // last block writes fired and zeroes the scratch.
  __syncthreads();
  for (int j = t; j < n_live; j += kThreads) {
    if (s_fired[j] != 0u) atomicOr(a.scratch + s_list[j], 1u);
  }
  uint32_t* arrive = a.scratch + a.R;
  __syncthreads();
  if (t == 0) {
    s_last = add_release(arrive) == static_cast<unsigned>(a.blocks - 1);
    if (s_last) fence_acquire();
  }
  __syncthreads();
  if (!s_last) return;
  for (int e = t; e < a.R; e += kThreads) {
    const uint32_t v = __ldcg(a.scratch + e);
    a.scratch[e] = 0u;
    a.fired[e] = v != 0u ? 1 : 0;
  }
  if (t == 0) *arrive = 0u;
}

__global__ void __launch_bounds__(kThreads)
wipe_kernel(const __grid_constant__ Args a) {
  __shared__ uint16_t s_list[kMaxRows];
  __shared__ int s_n;
  const int n_live = list_rows(a.sel, a.R, s_list, &s_n);
  const int per_row = a.ndev * a.units;
  const long long total = static_cast<long long>(n_live) * per_row;
  const long long gstride = static_cast<long long>(a.blocks) * kThreads;
  for (long long x = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       x < total; x += gstride) {
    const int j = static_cast<int>(x / per_row);
    const int u = static_cast<int>(x - static_cast<long long>(j) * per_row);
    const int i = u / a.units;
    const int c0 = (u - i * a.units) * kCols;
    const int n = min(kCols, a.L - c0);
    uint8_t* p = a.in[i] + static_cast<size_t>(s_list[j]) * a.L + c0;
    if (a.path == kWords16) {
      *reinterpret_cast<uint4*>(p) = make_uint4(0u, 0u, 0u, 0u);
    } else if (a.path == kWords4) {
#pragma unroll
      for (int k = 0; k < kWords; ++k) {
        if (4 * k < n) reinterpret_cast<uint32_t*>(p)[k] = 0u;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        if (k < n) p[k] = 0;
      }
    }
  }
}

inline bool aligned(const void* p, uintptr_t n) {
  return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0;
}

// The shared part of both launchers: the shard table, the path and the
// grid; false for arguments the kernels do not take.
inline bool setup(Args& a, void* const* shards, int ndev, int R, int L,
                  const void* sel, const void* rx) {
  if (shards == nullptr || sel == nullptr || R < 1 || R > kMaxRows ||
      L < 1 || ndev < 1 || ndev > kMaxShards ||
      static_cast<long long>(ndev) * L >= (1LL << 31) - kCols) {
    return false;
  }
  bool w4 = L % 4 == 0 && (rx == nullptr || aligned(rx, 4));
  bool w16 = L % kCols == 0 && (rx == nullptr || aligned(rx, 16));
  for (int j = 0; j < ndev; ++j) {
    if (shards[j] == nullptr) return false;
    a.in[j] = static_cast<uint8_t*>(shards[j]);
    w4 = w4 && aligned(shards[j], 4);
    w16 = w16 && aligned(shards[j], 16);
  }
  a.sel = static_cast<const uint8_t*>(sel);
  a.R = R;
  a.L = L;
  a.ndev = ndev;
  a.units = (L + kCols - 1) / kCols;
  const long long need =
      (static_cast<long long>(R) * ndev * a.units + kThreads - 1) / kThreads;
  a.blocks = static_cast<int>(need < kFillBlocks ? need : kFillBlocks);
  a.path = w16 ? kWords16 : (w4 ? kWords4 : kBytes);
  return true;
}

}  // namespace finish

// The scratch words fire_timers needs at R rows (uint32, zero before the
// first launch; every launch leaves it zero).
extern "C" long long fire_timers_scratch_words(int R) {
  return static_cast<long long>(R) + 1;
}

// The fire pass of the top of this file on heard, given as ndev shard
// pointers to u8 [R, L] (R <= 2048, N = ndev * L < 2**31 - 16), in place;
// rx: one byte per global column; ok: one byte per row (its low 4 bits);
// col (int32 [R], global columns in [0, N)) and rb (one byte per row):
// the refutation, both or neither null; fired: one byte per row, written
// whole; scratch: at least fire_timers_scratch_words(R) uint32 words,
// 4-byte aligned, zero (and left zero; one launch at a time may use it).
// Launches on `stream`, does not synchronise, returns cudaGetLastError()
// after the launch (or cudaErrorInvalidValue for arguments it does not
// take).
extern "C" int fire_timers(void* const* shards, int ndev, const void* rx,
                           const void* ok, const void* col, const void* rb,
                           void* fired, void* scratch, int R, int L,
                           void* stream) {
  using namespace finish;
  Args a{};
  if (rx == nullptr || fired == nullptr || scratch == nullptr ||
      !aligned(scratch, 4) || (col == nullptr) != (rb == nullptr) ||
      !setup(a, shards, ndev, R, L, ok, rx)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.rx = static_cast<const uint8_t*>(rx);
  a.col = static_cast<const int32_t*>(col);
  a.rb = static_cast<const uint8_t*>(rb);
  a.fired = static_cast<uint8_t*>(fired);
  a.scratch = static_cast<uint32_t*>(scratch);
  fire_kernel<<<a.blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
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
  if (!setup(a, shards, ndev, R, L, flags, nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  wipe_kernel<<<a.blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* finish_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
