"""A stand-in ``cuda_runtime.h`` for compiling the port's kernel sources
with the host's C++ compiler, whose launches run every lane of a block.

The block's lanes are fibers (``ucontext``) on the test's one thread: a
lane runs until it meets a barrier (its warp's, in ``__shfl_sync``,
``__shfl_up_sync``, ``__ballot_sync`` and ``__syncwarp``, or the block's, in
``__syncthreads``), then the next lane that can go on runs; a barrier opens
when the last of its lanes arrives, and a launch whose lanes wait at a
barrier that the others have passed aborts.  Blocks run one after
another.  Unlike host threads at a barrier, a switch costs no wake-up, so
a launch's time grows with its barriers and lanes, not with the load on
the machine.  ``__shared__`` arrays are the kernel's statics, one a build:
two builds loaded in one process need ``-fno-gnu-unique``.

A test writes ``CUDA_STUB`` as ``cuda_runtime.h`` beside the source, puts
``host_launch(kernel, grid, dim3(threads), args...)`` in place of the
source's ``kernel<<<grid, threads, 0, stream>>>(args...)`` and compiles
with ``-std=c++17``.
"""

CUDA_STUB = r"""
#pragma once
#include <ucontext.h>

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline dim3 blockIdx, threadIdx, blockDim, gridDim;
struct alignas(16) uint4 {  // 16-byte aligned, as CUDA's
  uint32_t x, y, z, w;
};
inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, uint32_t sh) {
  return static_cast<uint32_t>(
      (((static_cast<uint64_t>(hi) << 32) | lo) << (sh & 31)) >> 32);
}
inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __ffs(int v) { return __builtin_ffs(v); }
// The lanes run one at a time: an atomic is a plain update.
template <class T> inline T atomicAdd(T* p, T v) {
  const T old = *p;
  *p = old + v;
  return old;
}
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t e) {
  return e ? "invalid argument" : "no error";
}

// The lanes of a block as fibers.
struct HostBarrier {
  unsigned n = 0, arrived = 0, gen = 0;
};
struct HostLane {
  ucontext_t uc;
  std::unique_ptr<char[]> stack;
  HostBarrier* wait = nullptr;
  unsigned gen = 0;
  bool done = false;
};
constexpr size_t kHostStack = 64 * 1024;
inline ucontext_t host_sched;
inline std::vector<HostLane>* host_lanes = nullptr;
inline unsigned host_cur = 0;
inline HostBarrier host_block;
inline std::vector<HostBarrier> host_warps;
// A warp's exchange slots, two sets used in turn (by the barrier's
// generation), so that a lane can write the next exchange's slot while
// another still reads this one's.
inline std::vector<uint64_t> host_slots;
inline std::function<void()> host_body;

inline void host_arrive(HostBarrier& b) {
  if (++b.arrived == b.n) {
    b.arrived = 0;
    ++b.gen;
    return;
  }
  HostLane& me = (*host_lanes)[host_cur];
  me.wait = &b;
  me.gen = b.gen;
  swapcontext(&me.uc, &host_sched);
}
// Every lane of the caller's warp puts v; returns the warp's 32 values.
inline const uint64_t* host_exchange(uint64_t v) {
  const unsigned t = threadIdx.x, w = t / 32;
  HostBarrier& b = host_warps[w];
  uint64_t* slots =
      host_slots.data() + ((b.gen & 1u) * host_warps.size() + w) * 32;
  slots[t & 31u] = v;
  host_arrive(b);
  return slots;
}
template <class T>
inline T __shfl_sync(unsigned, T v, int src, int width = 32) {
  const unsigned lane = threadIdx.x & 31u;
  const uint64_t* all = host_exchange(static_cast<uint64_t>(v));
  return static_cast<T>(all[(lane & ~(width - 1u)) + (src & (width - 1))]);
}
template <class T>
inline T __shfl_up_sync(unsigned, T v, unsigned delta) {
  const unsigned lane = threadIdx.x & 31u;
  const uint64_t* all = host_exchange(static_cast<uint64_t>(v));
  return lane >= delta ? static_cast<T>(all[lane - delta]) : v;
}
inline unsigned __ballot_sync(unsigned, int pred) {
  const uint64_t* all = host_exchange(pred ? 1u : 0u);
  unsigned m = 0;
  for (unsigned i = 0; i < 32; ++i) m |= (all[i] ? 1u : 0u) << i;
  return m;
}
inline void __syncwarp(unsigned = 0xFFFFFFFFu) {
  host_arrive(host_warps[threadIdx.x / 32]);
}
inline void __syncthreads() { host_arrive(host_block); }
inline void host_entry() {
  host_body();
  (*host_lanes)[host_cur].done = true;
}
// A launch: blocks one after another (x fastest), each block's lanes as
// fibers until every one has returned.
template <class K, class... A>
void host_launch(K kernel, dim3 grid, dim3 block, const A&... args) {
  const unsigned n = block.x;
  if (n == 0 || n % 32 != 0) std::abort();
  gridDim = grid;
  blockDim = block;
  std::vector<HostLane> lanes(n);
  for (HostLane& l : lanes) l.stack.reset(new char[kHostStack]);
  host_lanes = &lanes;
  host_warps.assign(n / 32, HostBarrier{32, 0, 0});
  host_slots.assign(2 * n, 0);
  host_block = HostBarrier{n, 0, 0};
  host_body = [&] { kernel(args...); };
  for (unsigned by = 0; by < grid.y; ++by) {
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      blockIdx = dim3(bx, by);
      for (HostLane& l : lanes) {
        getcontext(&l.uc);
        l.uc.uc_stack.ss_sp = l.stack.get();
        l.uc.uc_stack.ss_size = kHostStack;
        l.uc.uc_link = &host_sched;
        makecontext(&l.uc, host_entry, 0);
        l.done = false;
        l.wait = nullptr;
      }
      unsigned left = n;
      while (left > 0) {
        bool ran = false;
        for (unsigned i = 0; i < n; ++i) {
          HostLane& l = lanes[i];
          if (l.done || (l.wait != nullptr && l.wait->gen == l.gen)) continue;
          l.wait = nullptr;
          host_cur = i;
          threadIdx = dim3(i);
          swapcontext(&host_sched, &l.uc);
          ran = true;
          left -= l.done ? 1u : 0u;
        }
        if (!ran) std::abort();  // lanes wait at a barrier the rest passed
      }
    }
  }
  host_lanes = nullptr;
}
"""
