// The dense dissemination tail of one SWIM round, for Hopper (sm_90a):
// one kernel body over a table of column shards, and its two C entry
// points.
//
// fused_dissem, the single-device round (a table of one shard, L = N),
// replaces the TPU kernel consul_tpu/gossip/fused.py::_fused_single (its
// Pallas body `kern`, with `_age_u8`, `_merge`, and the sender-liveness
// masks that `_src_masks` feeds it).  fused_merge, the sharded round (all
// ndev shards in one launch), replaces consul_tpu/gossip/fused.py::
// _fused_sharded (its gridless Pallas body, one shard per device)
// together with the halo hop that fed it its pins (`_roll_sharded`).
// Both are bit-identical to the plain torch versions beside their
// wrappers (consul_tpu_torch/gossip/fused.py: disseminate_ref, and
// merge_shards_ref, the reference's composition of _roll_sharded, the
// rolled sender masks and merge_ref per shard).
//
// What it computes.  The belief matrix heard[S, N] is held as ndev column
// shards, each a contiguous u8 [S, L] buffer, L = N / ndev.  For every
// slot row s and column c of shard i (global column gc = i * L + c), and
// each gossip leg f with shift o_f, the pin is heard[s, g] at g = (gc -
// o_f) mod N: shard g / L, local column g mod L, read straight from that
// shard.  The pin counts if its sender is alive (mf[g] > rnd) and its age
// is below the budget; the rule (belief_merge.cuh) ages the current byte,
// takes the priority-max of the live messages, counts the SUSPECTs, and
// where the receiver rx[gc] takes messages applies the upgrade or the
// Lifeguard confirmation bump capped at cap[s].  The byte goes to out[i,
// s, c], a fresh buffer (pins read neighbouring columns, so an in-place
// write would race).  The TPU kernel cut each pin out of two block windows
// chosen by scalar prefetch, because Mosaic could not copy at an
// arbitrary offset; the earlier sharded port copied each leg's pins into
// a rolled buffer first (24 copies per round of 1M nodes on 8 shards).
// Here a thread loads the aligned words around column g and joins them
// with funnel shifts, from whichever shard holds them.
//
// Bound: operations.  At S = 64, N = 1,000,000, F = 3 the function must
// read the 64 MB matrix and write 64 MB, plus 5 MB of [N] vectors (mf,
// rx): 0.040 ms at 3.35 TB/s.  The per-byte rule is 86 integer operations
// at fanout 3.  The first design spent one byte per 32-bit lane and sat
// at the integer unit's rate (0.322 ms).  This one runs the rule on four
// bytes per word, so the operations term is counted per word from the
// SASS of the row loop (consul_tpu_torch/sass_count.py): per execution unit
// (the integer ALU, and the FMA unit that runs IMAD), one alignment way
// of the loop, at each unit's 32-bit rate (67e12 / 4 per second on an
// H100 SXM); the busier unit sets the term.  At fanout 3 the integer ALU
// runs 62 instructions per word (LOP3, SHF, IADD3, PRMT, ...) and the FMA
// unit 12.25, so the term is 0.059 ms at [64, 1M].  On an H100 80GB HBM3
// at 700 W both entry points take about 0.11-0.12 ms there, a bit over
// half of the bound (chip_smoke.py; PERF.md keeps the measurements).
// What remains between the kernel and its bound is not attributed yet:
// no hardware profiler runs on that machine.
//
// Work split.  A thread takes kCols = 16 contiguous columns of one shard
// (four 32-bit words) and the rows of one row group (at most kRows; fewer
// when S is small, so that the grid still fills the card).  blockIdx.x
// runs over (shard, column tile), fastest, so the blocks of one row group
// run together and its rows stay in the 50 MB L2 while their pins are
// read: device memory sees about one read and one write of the matrix.
// Per thread and leg, once for all its rows: where the leg's window of 16
// pins starts, and the sender-liveness masks of its 16 columns (one byte
// each in a 32-bit word), read with 16-byte loads of mf (a lane reading
// its 16 entries one by one touches 16 cache lines per warp load; the
// setup then cost about a fifth of the kernel).
//
// The word path, nearly every thread: per row, the current 16 bytes in
// one 16-byte load where the row is 16-byte aligned (four 4-byte loads
// where it is only 4-byte aligned), each leg's window as five aligned
// 4-byte loads joined by funnel shifts, the word rule on four words, and
// one 16-byte store.
//
// The edge path, per byte (age_byte/take_pin/merge_byte): a thread with
// a leg whose window wraps at N or crosses a shard edge, the ragged end of
// a row (L % 16 != 0), and every thread when L % 4 != 0 or a buffer is not
// 4-byte aligned (words_ok, checked by the launcher from the pointers it
// is given).  It gathers its bytes with independent 1-byte loads, all in
// flight at once, so such a thread costs one memory latency per row, not
// one per byte.
//
// A launch covers the shards [i0, i1) of the table; one card passes the
// whole range.  The range leaves room for one launch per card when the
// shards live on several cards (the table then holds peer pointers).

#include <cuda_runtime.h>

#include <cstdint>

#include "belief_merge.cuh"

namespace dissem_tail {

constexpr int kMaxFanout = 8;
constexpr int kMaxShards = 64;
constexpr int kCols = 16;  // columns per thread: four 32-bit words
constexpr int kWords = kCols / 4;
constexpr int kRows = 8;   // most rows per row group (blockIdx.y)
constexpr int kThreads = 256;
// At most 80 registers a thread, so that three blocks share an SM.
constexpr int kMinBlocks = 3;
// Threads that keep every SM full (132 SMs x 2048): the launcher makes
// row groups smaller until the grid has that many, down to one row.
constexpr long long kFillThreads = 132LL * 2048;

// Everything a launch needs, passed by value in the kernel's parameter
// block (about 620 bytes of its 4 KB).  The kernel takes it as a
// __grid_constant__, so indexing the shard table by a runtime index reads
// the parameter space and makes no per-thread copy.
struct Args {
  const uint8_t* in[kMaxShards];  // the ndev input shards, u8 [S, L] each
  uint8_t* out;                   // u8 [ndev, S, L]: out[i] is shard i's
  const int32_t* mf;              // [N]: a sender is alive if mf > rnd
  const uint8_t* rx;              // [N] bool: the receiver takes messages
  const int32_t* cap;             // [S] confirmation caps, >= 0
  int o[kMaxFanout];              // circulant shifts, each in [0, N)
  int S, L, ndev;
  int i0;          // first shard this launch writes
  int tiles;       // column tiles per shard
  int rows;        // rows per row group, <= kRows
  int rnd, budget;
  bool words_ok;   // L % 4 == 0 and every buffer 4-byte aligned
};

// One byte of a word array: byte k % 4 of word k / 4.
__device__ __forceinline__ int byte_of(const uint32_t* w, int k) {
  return static_cast<int>((w[k / 4] >> (8 * (k % 4))) & 0xFFu);
}

// Flags 4w..4w+3 of `bits`, one per byte at bit 0 (the four bits spread
// by one multiply: x + x << 7 + x << 14 + x << 21, no carries).
__device__ __forceinline__ uint32_t byte_flags(uint32_t bits, int w) {
  return (((bits >> (4 * w)) & 0xFu) * 0x00204081u) & kLsb;
}

// Bit k: the sender of column g + k (mod N) is alive, for k < n_cols
// (bits past n_cols are don't-cares).  A lane's 16 entries of mf span 64
// bytes: five aligned 16-byte loads cover them where they do not wrap, 16
// single loads where they do (or mf is not 16-byte aligned).
__device__ __forceinline__ uint32_t sender_flags(const Args& a, int g, int N,
                                                 int n_cols) {
  uint32_t bits = 0;
  const int gq = g & ~3;
  if (gq + 20 <= N && (reinterpret_cast<uintptr_t>(a.mf) & 15) == 0) {
    const int4* q = reinterpret_cast<const int4*>(a.mf + gq);
#pragma unroll
    for (int v = 0; v < 5; ++v) {
      const int4 x = __ldg(q + v);
      bits |= ((x.x > a.rnd ? 1u : 0u) | (x.y > a.rnd ? 2u : 0u) |
               (x.z > a.rnd ? 4u : 0u) | (x.w > a.rnd ? 8u : 0u)) << (4 * v);
    }
    return bits >> (g & 3);
  }
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    int gk = g + k;
    if (gk >= N) gk -= N;
    bits |= (k < n_cols && __ldg(a.mf + gk) > a.rnd ? 1u : 0u) << k;
  }
  return bits;
}

// 0xFF per byte whose receiver takes messages, columns gc0 .. gc0 + 15:
// rx's bool bytes (0 or 1) times 0xFF, four to a load where aligned.
__device__ __forceinline__ void receiver_masks(const Args& a, int gc0,
                                               int n_cols,
                                               uint32_t rxw[kWords]) {
  const uint8_t* r = a.rx + gc0;
  if (n_cols == kCols && (reinterpret_cast<uintptr_t>(r) & 3) == 0) {
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      rxw[w] = __ldg(reinterpret_cast<const uint32_t*>(r) + w) * 0xFFu;
    }
    return;
  }
  uint32_t bits = 0;
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    bits |= (k < n_cols && __ldg(r + k) ? 1u : 0u) << k;
  }
#pragma unroll
  for (int w = 0; w < kWords; ++w) rxw[w] = byte_flags(bits, w) * 0xFFu;
}

// The edge path for one row: the thread's n_cols columns, byte by byte.
// Leg f's first split[f] pins start at src0[f], the rest at src1[f] (both
// at row 0); every byte is loaded before any is used, packed four to a
// word to spare registers.
template <int F>
__device__ __forceinline__ void edge_row(const Args& a, int s, int i, int c0,
                                         int n_cols, const uint8_t* src0[F],
                                         const uint8_t* src1[F],
                                         const int split[F],
                                         const uint32_t live[F][kWords],
                                         const uint32_t rxw[kWords]) {
  const size_t roff = static_cast<size_t>(s) * a.L;
  const uint8_t* cur_p = a.in[i] + roff + c0;
  uint8_t* out_p = a.out + (static_cast<size_t>(i) * a.S + s) * a.L + c0;
  const int cp = cap_clamp(__ldg(a.cap + s));
  uint32_t cur[kWords] = {};
  uint32_t pin[F][kWords] = {};
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    if (k >= n_cols) break;
    const int sh = 8 * (k % 4);
    cur[k / 4] |= static_cast<uint32_t>(__ldg(cur_p + k)) << sh;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const uint8_t* p = k < split[f] ? src0[f] + roff + k
                                      : src1[f] + roff + (k - split[f]);
      pin[f][k / 4] |= static_cast<uint32_t>(__ldg(p)) << sh;
    }
  }
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    if (k >= n_cols) break;
    int in_msg = 0;
    int n_sus = 0;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      take_pin(age_byte(byte_of(pin[f], k)), byte_of(live[f], k) != 0,
               a.budget, in_msg, n_sus);
    }
    out_p[k] = merge_byte(age_byte(byte_of(cur, k)), in_msg, n_sus,
                          byte_of(rxw, k) != 0, cp);
  }
}

template <int F>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
tail_kernel(const __grid_constant__ Args a) {
  const int i = a.i0 + static_cast<int>(blockIdx.x) / a.tiles;
  const int tile = static_cast<int>(blockIdx.x) % a.tiles;
  const int c0 = (tile * kThreads + static_cast<int>(threadIdx.x)) * kCols;
  if (c0 >= a.L) return;
  const int N = a.ndev * a.L;
  const int n_cols = min(kCols, a.L - c0);
  const int gc0 = i * a.L + c0;
  const int s_begin = static_cast<int>(blockIdx.y) * a.rows;
  const int s_end = min(s_begin + a.rows, a.S);

  // Per leg: the window's first pin is global column g0, i.e. local column
  // lc of shard j; its first `split` bytes lie in shard j, the rest at the
  // start of shard j + 1 (mod ndev: shard 0 after the wrap at N).  Its
  // sender masks: 0x03 per live byte.  The receivers: 0xFF per byte.
  int g0[F];
  int lc[F];
  int split[F];
  uint32_t live[F][kWords];
  bool words = a.words_ok && n_cols == kCols;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    int g = gc0 - a.o[f];
    if (g < 0) g += N;
    g0[f] = g;
    const int j = g / a.L;
    lc[f] = g - j * a.L;
    split[f] = min(kCols, a.L - lc[f]);
    words = words && split[f] == kCols;
    const uint32_t bits = sender_flags(a, g, N, n_cols);
#pragma unroll
    for (int w = 0; w < kWords; ++w) live[f][w] = byte_flags(bits, w) * 3u;
  }
  uint32_t rxw[kWords];
  receiver_masks(a, gc0, n_cols, rxw);

  if (!words) {
    const uint8_t* src0[F];
    const uint8_t* src1[F];
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const int j = g0[f] / a.L;
      src0[f] = a.in[j] + lc[f];
      src1[f] = a.in[j + 1 == a.ndev ? 0 : j + 1];
    }
    for (int s = s_begin; s < s_end; ++s) {
      edge_row<F>(a, s, i, c0, n_cols, src0, src1, split, live, rxw);
    }
    return;
  }

  // The word path.  Each leg's source: row 0 of its shard at the window's
  // first aligned word, and the funnel shift that realigns it.
  const uint8_t* src[F];
  uint32_t shift[F];
#pragma unroll
  for (int f = 0; f < F; ++f) {
    src[f] = a.in[g0[f] / a.L] + (lc[f] & ~3);
    shift[f] = 8u * static_cast<uint32_t>(lc[f] & 3);
  }
  const uint32_t budget_w = static_cast<uint32_t>(a.budget) * kLsb;

  // Not unrolled: one iteration is one row of four words, which is what
  // consul_tpu_torch/sass_count.py counts.
#pragma unroll 1
  for (int s = s_begin; s < s_end; ++s) {
    const size_t roff = static_cast<size_t>(s) * a.L;
    const uint8_t* cur_p = a.in[i] + roff + c0;
    uint8_t* out_p = a.out + (static_cast<size_t>(i) * a.S + s) * a.L + c0;
    const uint32_t cap_w = static_cast<uint32_t>(cap_clamp(__ldg(a.cap + s)))
                           * kLsb;
    uint32_t cur[kWords];
    if ((reinterpret_cast<uintptr_t>(cur_p) & 15) == 0) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(cur_p));
      cur[0] = v.x; cur[1] = v.y; cur[2] = v.z; cur[3] = v.w;
    } else {
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        cur[w] = __ldg(reinterpret_cast<const uint32_t*>(cur_p) + w);
      }
    }

    PinWords acc[kWords];
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const uint32_t* pw = reinterpret_cast<const uint32_t*>(src[f] + roff);
      uint32_t win[kWords + 1];
#pragma unroll
      for (int w = 0; w < kWords; ++w) win[w] = __ldg(pw + w);
      // The fifth word only when the window is not word-aligned: then it
      // still lies inside the shard's row (L % 4 == 0).
      win[kWords] = shift[f] ? __ldg(pw + kWords) : 0u;
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        take_pin_word(__funnelshift_r(win[w], win[w + 1], shift[f]),
                      live[f][w], budget_w, acc[w]);
      }
    }

    uint32_t res[kWords];
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      res[w] = merge_word(cur[w], acc[w], rxw[w], cap_w);
    }
    if ((reinterpret_cast<uintptr_t>(out_p) & 15) == 0) {
      *reinterpret_cast<uint4*>(out_p) = make_uint4(res[0], res[1], res[2],
                                                    res[3]);
    } else {
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        reinterpret_cast<uint32_t*>(out_p)[w] = res[w];
      }
    }
  }
}

template <int F>
int launch_f(const Args& a, int n_shards, cudaStream_t stream) {
  const dim3 grid(n_shards * a.tiles, (a.S + a.rows - 1) / a.rows);
  tail_kernel<F><<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

inline bool aligned4(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 3) == 0;
}

// Validates, fills in the derived fields and launches shards [i0, i1) of
// the table.  `in` holds ndev shard pointers; offsets are reduced mod N.
inline int launch(const void* const* in, int ndev, void* out,
                  const void* mf, const void* rx, const void* cap, int S,
                  int L, int fanout, const int* offsets, int rnd, int budget,
                  int i0, int i1, cudaStream_t stream) {
  if (S <= 0 || L <= 0 || ndev < 1 || ndev > kMaxShards || fanout < 1 ||
      fanout > kMaxFanout || budget < 1 || budget > 14 || i0 < 0 ||
      i1 > ndev || i0 >= i1 ||
      static_cast<long long>(ndev) * L >= (1LL << 31) - kCols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{};
  const long long N = static_cast<long long>(ndev) * L;
  bool ok = L % 4 == 0 && aligned4(out);
  for (int j = 0; j < ndev; ++j) {
    a.in[j] = static_cast<const uint8_t*>(in[j]);
    ok = ok && aligned4(in[j]);
  }
  for (int f = 0; f < fanout; ++f) {
    const long long o = offsets[f] % N;
    a.o[f] = static_cast<int>(o < 0 ? o + N : o);
  }
  a.out = static_cast<uint8_t*>(out);
  a.mf = static_cast<const int32_t*>(mf);
  a.rx = static_cast<const uint8_t*>(rx);
  a.cap = static_cast<const int32_t*>(cap);
  a.S = S;
  a.L = L;
  a.ndev = ndev;
  a.i0 = i0;
  a.tiles = (L + kThreads * kCols - 1) / (kThreads * kCols);
  const int n = i1 - i0;
  const long long per_group = static_cast<long long>(n) * a.tiles * kThreads;
  const long long groups = (kFillThreads + per_group - 1) / per_group;
  const long long rows = (S + groups - 1) / groups;
  a.rows = static_cast<int>(rows < 1 ? 1 : (rows > kRows ? kRows : rows));
  a.rnd = rnd;
  a.budget = budget;
  a.words_ok = ok;
  switch (fanout) {
    case 1: return launch_f<1>(a, n, stream);
    case 2: return launch_f<2>(a, n, stream);
    case 3: return launch_f<3>(a, n, stream);
    case 4: return launch_f<4>(a, n, stream);
    case 5: return launch_f<5>(a, n, stream);
    case 6: return launch_f<6>(a, n, stream);
    case 7: return launch_f<7>(a, n, stream);
    default: return launch_f<8>(a, n, stream);
  }
}

}  // namespace dissem_tail

// out[S, N] = the round's dissemination of heard[S, N].  mf: int32 [N];
// rx: one byte per column (a torch bool tensor); cap: int32 [S], >= 0;
// offsets: `fanout` host ints; budget in [1, 14].  Launches on `stream`,
// does not synchronise, returns cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for arguments it does not take).
extern "C" int fused_dissem(const void* heard, void* out, const void* mf,
                            const void* rx, const void* cap, int S, int N,
                            int fanout, const int* offsets, int rnd,
                            int budget, void* stream) {
  const void* table[1] = {heard};
  return dissem_tail::launch(table, 1, out, mf, rx, cap, S, N, fanout,
                             offsets, rnd, budget, 0, 1,
                             static_cast<cudaStream_t>(stream));
}

// out[i] = the merge of shard i for i in [i0, i1).  shards: ndev pointers
// to u8 [S, L]; out: u8 [ndev, S, L]; mf: int32 [N]; rx: one byte per
// global column; cap: int32 [S], >= 0; offsets: `fanout` host ints;
// budget in [1, 14]; ndev <= 64 and N = ndev * L below 2**31.  Launches on
// `stream`, does not synchronise, returns cudaGetLastError() after the
// launch (or cudaErrorInvalidValue for arguments it does not take).
extern "C" int fused_merge(const void* const* shards, int ndev, void* out,
                           const void* mf, const void* rx, const void* cap,
                           int S, int L, int fanout, const int* offsets,
                           int rnd, int budget, int i0, int i1,
                           void* stream) {
  return dissem_tail::launch(shards, ndev, out, mf, rx, cap, S, L, fanout,
                             offsets, rnd, budget, i0, i1,
                             static_cast<cudaStream_t>(stream));
}

extern "C" const char* dissem_tail_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
