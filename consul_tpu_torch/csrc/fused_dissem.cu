// The dense dissemination tail of one SWIM round, for Hopper (sm_90a).
//
// Replaces the TPU kernel consul_tpu/gossip/fused.py::_fused_single (its
// Pallas body `kern`, with `_age_u8`, `_merge`, and the sender-liveness
// masks that `_src_masks` feeds it).  For every slot row s and observer
// column c of the belief matrix heard[S, N] (u8, row-major):
//   1. age the current byte: the fresh sentinel 0xF becomes 0, real ages
//      saturate at 14, message-free bytes stay as they are;
//   2. for each gossip leg f, take the pin heard[s, (c - o_f) mod N] and
//      age it;
//   3. the pin is live if its age is below the spread budget and its
//      sender is alive: mf[(c - o_f) mod N] > rnd;
//   4. take the priority-max of the incoming message and count the
//      incoming SUSPECTs;
//   5. if the receiver rx[c] is set, apply the upgrade, or the Lifeguard
//      confirmation bump capped at cap[s];
//   6. reset the age on an upgrade or when the confirmation count rises;
//   7. write the byte into `out`, a fresh buffer: pins read neighbouring
//      columns, so an in-place write would race.
// The result is bit-identical to consul_tpu/gossip/kernel.py::
// _disseminate_swar and to the plain torch version beside the wrapper
// (consul_tpu_torch/gossip/fused.py::disseminate_ref).
//
// The TPU kernel cut each pin out of two block windows chosen by scalar
// prefetch, because Mosaic could not copy at an arbitrary offset.  Here a
// thread loads column (c - o_f) mod N directly.
//
// Bound: operations.  At S = 64, N = 1,000,000 the function must read
// the 64 MB matrix and write 64 MB, plus about 5 MB of [N] vectors (mf,
// rx): ~133 MB, 0.040 ms at 3.35 TB/s.  The per-byte rule is 86 integer
// operations at fanout 3; packed four bytes to a 32-bit word they take
// 0.082 ms at the CUDA cores' INT32 rate (67e12 / 4 ops/s), so the
// operations, not memory, bound it.  This kernel spends them one byte
// per 32-bit lane and measured 0.322 ms, a share of 0.255 of that bound
// (about 4x; PERF.md, chip_smoke.py on an H100 80GB HBM3 at 700 W).
// Four bytes to a 32-bit word (the reference's SWAR form) is the lever.
// The per-byte rule lives in belief_merge.cuh, shared with fused_merge.cu.
//
// Design (simple and right first).  A block owns a tile of
// kThreads * kCols columns and the kRows rows of one row group; thread t
// takes columns t, t + kThreads, ... of the tile.  Threads run along N,
// so for each row and column step a warp loads 32 consecutive bytes —
// one sector — of the current row or of a pin at one shift: the loads
// coalesce.  A thread reads mf and rx for its columns once and reuses
// them over its rows.  blockIdx.x (column tiles) varies fastest, so the
// blocks of one row group run together and its kRows rows (8 MB at
// N = 1M) stay in the 50 MB L2 while their pins are read: the pin loads
// mostly hit L2, and device memory sees about one read and one write of
// the matrix.
// Left for a later PR: 16-byte vector loads and stores, staging the row
// group in shared memory, TMA.

#include <cuda_runtime.h>

#include <cstdint>

#include "belief_merge.cuh"

namespace {

constexpr int kMaxFanout = 8;
constexpr int kCols = 4;     // columns per thread, kThreads apart
constexpr int kRows = 8;     // rows per row group (blockIdx.y)
constexpr int kThreads = 256;

struct Offsets {
  int o[kMaxFanout];         // circulant shifts, each in [0, N)
};

template <int F>
__global__ void __launch_bounds__(kThreads)
fused_dissem_kernel(const uint8_t* __restrict__ heard,
                    uint8_t* __restrict__ out,
                    const int32_t* __restrict__ mf,
                    const uint8_t* __restrict__ rx,
                    const int32_t* __restrict__ cap,
                    int S, int N, Offsets offs, int rnd, int budget) {
  const long long tile =
      static_cast<long long>(blockIdx.x) * kThreads * kCols;
  if (tile + threadIdx.x >= N) return;

  // Per column: the F sender columns, whether each sender is alive, and
  // whether the receiver takes messages.  Read once, used for all rows.
  int col[kCols];
  int src[F][kCols];
  bool src_live[F][kCols];
  bool rxm[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const long long c = tile + j * kThreads + threadIdx.x;
    col[j] = c < N ? static_cast<int>(c) : -1;
    const int cc = col[j] < 0 ? 0 : col[j];  // a safe column to load
    rxm[j] = rx[cc] != 0;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      int sc = cc - offs.o[f];
      if (sc < 0) sc += N;
      src[f][j] = sc;
      src_live[f][j] = mf[sc] > rnd;
    }
  }

  const int s_end = min(static_cast<int>(blockIdx.y) * kRows + kRows, S);
  for (int s = blockIdx.y * kRows; s < s_end; ++s) {
    const uint8_t* row = heard + static_cast<size_t>(s) * N;
    uint8_t* orow = out + static_cast<size_t>(s) * N;
    const int cp = cap[s];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      if (col[j] < 0) break;
      int in_msg = 0;
      int n_sus = 0;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        take_pin(age_byte(row[src[f][j]]), src_live[f][j], budget, in_msg,
                 n_sus);
      }
      const int c = col[j];
      orow[c] = merge_byte(age_byte(row[c]), in_msg, n_sus, rxm[j], cp);
    }
  }
}

template <int F>
int launch(const uint8_t* heard, uint8_t* out, const int32_t* mf,
           const uint8_t* rx, const int32_t* cap, int S, int N,
           const Offsets& offs, int rnd, int budget, cudaStream_t stream) {
  const dim3 grid((N + kThreads * kCols - 1) / (kThreads * kCols),
                  (S + kRows - 1) / kRows);
  fused_dissem_kernel<F><<<grid, kThreads, 0, stream>>>(
      heard, out, mf, rx, cap, S, N, offs, rnd, budget);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out[S, N] = the round's dissemination of heard[S, N].  mf: int32 [N];
// rx: one byte per column (a torch bool tensor); cap: int32 [S];
// offsets: `fanout` host ints.  Launches on `stream`, does not
// synchronise, returns cudaGetLastError() after the launch.
extern "C" int fused_dissem(const void* heard, void* out, const void* mf,
                            const void* rx, const void* cap, int S, int N,
                            int fanout, const int* offsets, int rnd,
                            int budget, void* stream) {
  if (S <= 0 || N <= 0 || fanout < 1 || fanout > kMaxFanout) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Offsets offs{};
  for (int f = 0; f < fanout; ++f) {
    const int o = offsets[f] % N;
    offs.o[f] = o < 0 ? o + N : o;
  }
  const auto* h = static_cast<const uint8_t*>(heard);
  auto* o = static_cast<uint8_t*>(out);
  const auto* m = static_cast<const int32_t*>(mf);
  const auto* r = static_cast<const uint8_t*>(rx);
  const auto* c = static_cast<const int32_t*>(cap);
  auto st = static_cast<cudaStream_t>(stream);
  switch (fanout) {
    case 1: return launch<1>(h, o, m, r, c, S, N, offs, rnd, budget, st);
    case 2: return launch<2>(h, o, m, r, c, S, N, offs, rnd, budget, st);
    case 3: return launch<3>(h, o, m, r, c, S, N, offs, rnd, budget, st);
    case 4: return launch<4>(h, o, m, r, c, S, N, offs, rnd, budget, st);
    case 5: return launch<5>(h, o, m, r, c, S, N, offs, rnd, budget, st);
    case 6: return launch<6>(h, o, m, r, c, S, N, offs, rnd, budget, st);
    case 7: return launch<7>(h, o, m, r, c, S, N, offs, rnd, budget, st);
    default: return launch<8>(h, o, m, r, c, S, N, offs, rnd, budget, st);
  }
}

extern "C" const char* fused_dissem_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
