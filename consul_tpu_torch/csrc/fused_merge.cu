// One shard's dissemination merge in the sharded SWIM round, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel consul_tpu/gossip/fused.py::_fused_sharded (its
// gridless Pallas body `kern`, with `_age_u8` and `_merge`).  In the
// sharded round the belief matrix heard[S, N] is split into column shards
// of L = N / ndev observers; a pin crosses shard boundaries, so the halo
// hop (consul_tpu_torch/gossip/kernel.py::_roll_sharded) first rolls each
// gossip leg's pins into pins[F, S, L], aligned with the shard.  For
// every slot row s and local column c of the shard (u8, row-major):
//   1. age the current byte cur[s, c] and each pin pins[f, s, c];
//   2. a pin is live if its age is below the spread budget and its
//      sender is alive: src[f, c] != 0;
//   3. take the priority-max of the live pins' messages and count the
//      SUSPECTs among them;
//   4. if the receiver rx[c] is set, apply the upgrade, or the Lifeguard
//      confirmation bump capped at cap[s];
//   5. reset the age on an upgrade or when the confirmation count rises;
//   6. write the byte into `out`, a fresh buffer.
// Steps 1-5 are belief_merge.cuh, the rule fused_dissem.cu applies too.
// The result is bit-identical to the plain torch version beside the
// wrapper (consul_tpu_torch/gossip/fused.py::merge_ref).
//
// Bound: bytes.  At S = 64, L = 125,000 (1M nodes on 8 shards), F = 3, the
// function must read cur and the three pins and write out, 5 * S * L
// bytes, plus src, rx and cap: 40,500,256 B, 0.0121 ms at 3.35 TB/s.  The
// per-byte rule's 86 integer operations per byte, packed four bytes to a
// 32-bit word, take 0.0103 ms at the CUDA cores' INT32 rate (67e12 / 4
// ops/s).  This kernel keeps one byte per 32-bit lane, about 688 M
// integer operations a launch, so like fused_dissem.cu it should sit near
// the ALU's time (~0.04 ms), not the bytes'.
//
// Design (simple and right first).  All operands share the [S, L] index,
// so one thread takes one belief byte of the flat S * L index (row
// idx / L, column idx % L): a warp reads 32 consecutive bytes of cur, of
// each pin plane and of out — the loads and the store coalesce.  src and
// rx are read per column and cap per row; they are small and stay in L1
// and L2.  Left for a later PR: four bytes per 32-bit word (SWAR, or
// CUDA's per-byte SIMD intrinsics), 16-byte vector loads, and reading
// the pins straight from the neighbouring shards instead of from the
// rolled buffer.

#include <cuda_runtime.h>

#include <cstdint>

#include "belief_merge.cuh"

namespace {

constexpr int kMaxFanout = 8;
constexpr int kThreads = 256;

template <int F>
__global__ void __launch_bounds__(kThreads)
fused_merge_kernel(const uint8_t* __restrict__ cur,
                   const uint8_t* __restrict__ pins,
                   const uint8_t* __restrict__ src,
                   const uint8_t* __restrict__ rx,
                   const int32_t* __restrict__ cap,
                   uint8_t* __restrict__ out, int L, int total, int budget) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (i >= total) return;
  const int idx = static_cast<int>(i);
  const int s = idx / L;
  const int c = idx - s * L;
  int in_msg = 0;
  int n_sus = 0;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    take_pin(age_byte(pins[static_cast<size_t>(f) * total + idx]),
             src[static_cast<size_t>(f) * L + c] != 0, budget, in_msg, n_sus);
  }
  out[idx] = merge_byte(age_byte(cur[idx]), in_msg, n_sus, rx[c] != 0,
                        cap[s]);
}

template <int F>
int launch(const uint8_t* cur, const uint8_t* pins, const uint8_t* src,
           const uint8_t* rx, const int32_t* cap, uint8_t* out, int L,
           int total, int budget, cudaStream_t stream) {
  const int blocks = static_cast<int>(
      (static_cast<long long>(total) + kThreads - 1) / kThreads);
  fused_merge_kernel<F><<<blocks, kThreads, 0, stream>>>(
      cur, pins, src, rx, cap, out, L, total, budget);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out[S, L] = the merge of one shard.  cur: u8 [S, L]; pins: u8 [F, S, L];
// src: one byte per (leg, column), [F, L] (a torch bool tensor); rx: one
// byte per column, [L]; cap: int32 [S].  S * L must be below 2**31.
// Launches on `stream`, does not synchronise, returns cudaGetLastError()
// after the launch.
extern "C" int fused_merge(const void* cur, const void* pins, const void* src,
                           const void* rx, const void* cap, void* out, int S,
                           int L, int fanout, int budget, void* stream) {
  if (S <= 0 || L <= 0 || fanout < 1 || fanout > kMaxFanout ||
      static_cast<long long>(S) * L >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int total = S * L;
  const auto* c = static_cast<const uint8_t*>(cur);
  const auto* p = static_cast<const uint8_t*>(pins);
  const auto* sr = static_cast<const uint8_t*>(src);
  const auto* r = static_cast<const uint8_t*>(rx);
  const auto* cp = static_cast<const int32_t*>(cap);
  auto* o = static_cast<uint8_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (fanout) {
    case 1: return launch<1>(c, p, sr, r, cp, o, L, total, budget, st);
    case 2: return launch<2>(c, p, sr, r, cp, o, L, total, budget, st);
    case 3: return launch<3>(c, p, sr, r, cp, o, L, total, budget, st);
    case 4: return launch<4>(c, p, sr, r, cp, o, L, total, budget, st);
    case 5: return launch<5>(c, p, sr, r, cp, o, L, total, budget, st);
    case 6: return launch<6>(c, p, sr, r, cp, o, L, total, budget, st);
    case 7: return launch<7>(c, p, sr, r, cp, o, L, total, budget, st);
    default: return launch<8>(c, p, sr, r, cp, o, L, total, budget, st);
  }
}

extern "C" const char* fused_merge_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
