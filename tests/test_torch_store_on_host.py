"""The device store's Hopper kernels on the CPU: ``csrc/kv_store.cu``
(both entry points, ``kv_apply`` and ``watch_match``, and all three
kernels) compiled by the host's C++ compiler against a small stand-in for
the CUDA runtime in which a launch runs its blocks one after another and
each block as ``blockDim.x`` host threads at once: the warp intrinsics
(``__ballot_sync``, ``__shfl_sync``, ``__shfl_xor_sync``, ``__syncwarp``)
meet at a barrier of the warp's 32 threads, ``__syncthreads`` at a
barrier of the block's, ``__shared__`` is storage of the block (safe: the
blocks run one after another), and the atomics are the compiler's
``__atomic`` builtins.

This checks the kernels' own logic before any card does.  ``kv_apply``:
the buckets of window starts and the cuts of the ring between blocks,
each block's ops in batch order, the run heads, the levels, the walk in
order that long chains and crowded stretches take, the window's ballots
and the all-false argmax, the in-place writes and their order against
later loads, the full count and the pad rows.  ``watch_match``: the staged event chunks, the KV and TABLE
loops over the kind ballots, the unsigned index gate, the events split
over blocks with ``atomicOr`` into ``packed`` and the fired bytes derived
from it, and the prefix hashes read from global memory where a chunk
does not fit.  Each launch is held against the plain torch versions
(``apply_ref``, ``match_ref``) on seeded inputs, and the schedule's own
counts (levels, sweeps, chunks walked in order; pairs evaluated) against
what each layout must give.  Needs ``g++``; builds into the test's
temporary directory.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from consul_tpu_torch import _build
from consul_tpu_torch.state import device_store as tds

# What the kernels use of the CUDA runtime and device built-ins, on the
# host: a block is blockDim.x threads, a warp 32 of them.
CUDA_STUB = r"""
#pragma once
#include <algorithm>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
#define __shared__ static
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint2 {
  uint32_t x, y;
};
static inline uint2 make_uint2(uint32_t x, uint32_t y) { return uint2{x, y}; }
struct alignas(16) uint4 {
  uint32_t x, y, z, w;
};
// Internal linkage throughout: another host build of a kernel in the same
// process (tests/test_torch_tail_on_host.py) defines these names too.
static thread_local dim3 threadIdx, blockIdx;
static dim3 blockDim, gridDim;
template <class T> static inline T __ldg(const T* p) { return *p; }
static inline int __ffs(unsigned x) {
  return __builtin_ffs(static_cast<int>(x));
}
static inline int __popc(unsigned x) { return __builtin_popcount(x); }
static inline long long clock64() {
  return std::chrono::steady_clock::now().time_since_epoch().count();
}
// A barrier of n threads: a generation count under a mutex.
struct HostBarrier {
  std::mutex m;
  std::condition_variable cv;
  unsigned n = 32, arrived = 0, generation = 0;
  void sync() {
    std::unique_lock<std::mutex> lock(m);
    const unsigned gen = generation;
    if (++arrived == n) {
      arrived = 0;
      ++generation;
      cv.notify_all();
    } else {
      cv.wait(lock, [&] { return generation != gen; });
    }
  }
};
struct HostWarp {
  HostBarrier bar;
  uint32_t slot[32];
};
static thread_local HostWarp* host_warp;
static HostBarrier* host_block;
static inline unsigned lane_id() { return threadIdx.x & 31u; }
static inline unsigned __ballot_sync(unsigned, int pred) {
  host_warp->slot[lane_id()] = pred ? 1u : 0u;
  host_warp->bar.sync();
  unsigned r = 0;
  for (unsigned i = 0; i < 32; ++i) r |= host_warp->slot[i] << i;
  host_warp->bar.sync();
  return r;
}
template <class T> static inline T __shfl_sync(unsigned, T v, int src) {
  uint32_t bits;
  std::memcpy(&bits, &v, sizeof(bits));
  host_warp->slot[lane_id()] = bits;
  host_warp->bar.sync();
  bits = host_warp->slot[src & 31];
  host_warp->bar.sync();
  T out;
  std::memcpy(&out, &bits, sizeof(out));
  return out;
}
template <class T> static inline T __shfl_xor_sync(unsigned, T v, int m) {
  return __shfl_sync(0xffffffffu, v, static_cast<int>(lane_id()) ^ m);
}
static inline void __syncwarp(unsigned = 0xffffffffu) {
  host_warp->bar.sync();
}
static inline void __syncthreads() { host_block->sync(); }
template <class T> static inline T atomicAdd(T* p, T v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
template <class T> static inline T atomicMax(T* p, T v) {
  T old = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (old < v &&
         !__atomic_compare_exchange_n(p, &old, v, false, __ATOMIC_SEQ_CST,
                                      __ATOMIC_SEQ_CST)) {
  }
  return old;
}
static inline unsigned atomicOr(unsigned* p, unsigned v) {
  return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST);
}
// A launch: blocks one after another, each block's threads at once (the
// same host threads for every block, meeting at the block barrier between
// two blocks).
static constexpr size_t kHostSharedBytes = 1 << 18;
template <class K, class A>
static void host_launch(K kernel, dim3 grid, dim3 block, size_t smem,
                        const A& args) {
  if (smem > kHostSharedBytes || block.x % 32 != 0) std::abort();
  blockDim = block;
  gridDim = grid;
  HostBarrier bar;
  bar.n = block.x;
  host_block = &bar;
  std::unique_ptr<HostWarp[]> warps(new HostWarp[block.x / 32]);
  std::vector<std::thread> threads;
  for (unsigned t = 0; t < block.x; ++t)
    threads.emplace_back([=, &warps] {
      threadIdx = dim3(t);
      host_warp = &warps[t / 32];
      for (unsigned by = 0; by < grid.y; ++by)
        for (unsigned bx = 0; bx < grid.x; ++bx) {
          blockIdx = dim3(bx, by);
          kernel(args);
          host_block->sync();
        }
    });
  for (auto& th : threads) th.join();
}
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
static inline cudaError_t cudaGetLastError() { return cudaSuccess; }
static inline const char* cudaGetErrorString(cudaError_t) { return "error"; }
static inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
template <class F>
static inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
static inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n,
                                          cudaStream_t) {
  std::memset(p, v, n);
  return cudaSuccess;
}
"""

# Text of the source -> its host form: the dynamic shared memory as one
# static buffer, each launch as host_launch.
HOST_FORMS = {
    "extern __shared__ __align__(16) unsigned char kv_smem[];":
        "alignas(16) static unsigned char kv_smem[kHostSharedBytes];",
    "apply_kernel<<<blocks, threads, smem, stream>>>(a);":
        "host_launch(apply_kernel, dim3(blocks), dim3(threads), smem, a);",
    "match_kernel<<<grid, threads, smem, stream>>>(a);":
        "host_launch(match_kernel, grid, dim3(threads), smem, a);",
    "fired_kernel<<<blocks, kFiredThreads, 0, stream>>>(f);":
        "host_launch(fired_kernel, dim3(blocks), dim3(kFiredThreads), 0, f);",
}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernels for the host")
    d = tmp_path_factory.mktemp("store_on_host")
    (d / "cuda_runtime.h").write_text(CUDA_STUB)
    body = (_build.CSRC / "kv_store.cu").read_text()
    for text, host in HOST_FORMS.items():
        assert body.count(text) == 1, text
        body = body.replace(text, host)
    src = d / "kv_store.cpp"
    src.write_text(body)
    so = d / "libkv_store.so"
    r = subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC",
                        "-pthread", "-Wno-unknown-pragmas", f"-I{d}", "-o",
                        str(so), str(src)],
                       capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr
    out = ctypes.CDLL(str(so))
    for name in ("kv_apply", "watch_match"):
        fn = getattr(out, name)
        fn.argtypes, fn.restype = tds._ARGTYPES[name], ctypes.c_int
    return out


def _u32(rng, n):
    return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


def _ops(rng, capacity, batch, n_keys, start, layout="mixed"):
    """One op batch, indexes from ``start``.  ``mixed``: sets, deletes and
    pad rows over a clustered key pool (key 0 has fingerprints (0, 0),
    which pad rows match).  ``one_key``: sets and deletes of one key.
    ``trailing_pads``: the ops of a 2,049-op chunk over keys spread over
    the table, padded with 2,047 pad rows at the end as the bridge pads
    it.  ``key0_pads``: a third of the ops on key (0, 0), pads among them.
    ``wrap``: every window starts in the last 24 or the first 8 slots.
    ``spread``: sets and deletes of keys spread over the table, repeated
    within the batch, as the store's batches are.
    ``chain``: one set a window start, 8 slots apart in batch order, so
    each op's window meets the one before: as many levels as ops."""
    if layout == "mixed":
        span = max(capacity // 8, 2)
        h1 = ((rng.integers(0, 2**32, n_keys, dtype=np.uint64)
               & np.uint64(2**32 - capacity))
              | rng.integers(0, span, n_keys).astype(np.uint64)
              ).astype(np.uint32)
    elif layout == "wrap":
        low = np.asarray(list(range(capacity - 24, capacity)) + list(range(8)),
                         np.uint64)
        h1 = ((_u32(rng, n_keys).astype(np.uint64)
               & np.uint64(2**32 - capacity))
              | rng.choice(low, n_keys)).astype(np.uint32)
    else:
        h1 = _u32(rng, n_keys)
    h2 = _u32(rng, n_keys)
    h1[0] = h2[0] = 0
    weights = {"mixed": [1, 1, 1, 1], "key0_pads": [1, 1, 1, 1],
               "wrap": [2, 2, 1, 1], "spread": [2, 2, 1, 0],
               "trailing_pads": [2, 2, 1, 0], "one_key": [2, 2, 1, 0],
               "chain": [1, 0, 0, 0]}[layout]
    opc = rng.choice(np.repeat(np.asarray([tds.OP_SET, tds.OP_SET, tds.OP_DEL,
                                           tds.OP_PAD], np.int32), weights),
                     batch)
    if layout == "one_key":
        k = np.ones(batch, np.int64)
    elif layout == "chain":
        k = np.arange(batch)
        h1[:batch] = (np.arange(batch) * 8 + int(h1[1])) % 2**32
    elif layout == "key0_pads":
        k = np.where(rng.random(batch) < 1 / 3, 0,
                     rng.integers(0, n_keys, batch))
    else:
        k = rng.integers(0, n_keys, batch)
    if layout == "trailing_pads":
        opc[batch - 2047:] = tds.OP_PAD
    idx = ((start + np.arange(batch)) % 2**32).astype(np.uint32)
    dig = _u32(rng, batch)
    flg = _u32(rng, batch)
    pad = opc == tds.OP_PAD
    h1k, h2k = np.where(pad, 0, h1[k]), np.where(pad, 0, h2[k])
    return torch.from_numpy(tds._pack_ops(opc, h1k, h2k, idx, dig, flg))


# What each layout must make the kernel do (its stats: the most levels a
# block ran, the ops walked in order, the blocks that walked, the blocks
# that held ops): walk every op in order (one key: one block holds all
# 4,096, over kLocalMax run heads; a chain: one block, 200 levels deep),
# or run every op in levels, more than one deep.
_WALKED = {"one_key": True, "chain": True, "trailing_pads": False,
           "spread": False}


def _as_before(*args):
    """A case from before the layouts and kinds, under its old id."""
    return pytest.param(*args, id="-".join(str(a) for a in args[:-1]))


@pytest.mark.parametrize("capacity, probe, n_keys, batch, start, layout", [
    # exhausted windows, full > 0
    _as_before(64, 16, 120, 70, 2**31 - 30, "mixed"),
    _as_before(256, 16, 100, 33, 2**32 - 10, "mixed"),  # indexes past 2**32
    _as_before(32, 32, 40, 40, 5, "mixed"),  # the whole table is the window
    _as_before(512, 1, 300, 64, 2**31, "mixed"),
    _as_before(128, 5, 60, 1, 9, "mixed"),
    (65536, 16, 2, 4096, 2**31 - 100, "one_key"),
    (65536, 16, 3000, 4096, 2**32 - 2000, "trailing_pads"),
    (256, 16, 40, 200, 77, "key0_pads"),
    (1024, 16, 200, 300, 2**31, "wrap"),
    (32, 32, 60, 300, 11, "mixed"),  # capacity == probe == 32
    (4096, 16, 200, 200, 5, "chain"),  # past the sweep limit
    (65536, 16, 3000, 4096, 2**31 - 5000, "spread"),
    (8192, 32, 500, 256, 3, "spread"),  # probe 32
    (4096, 1, 900, 1000, 2**32 - 400, "spread"),  # probe 1
    (65536, 16, 3000, 5000, 2**31 - 7, "spread")])  # two chunks
def test_kv_apply_body_matches_plain(lib, capacity, probe, n_keys, batch,
                                     start, layout):
    rng = np.random.default_rng(capacity + probe + batch)
    tab = (torch.zeros((capacity, tds.SLOT_COLS), dtype=torch.int32),
           torch.zeros((), dtype=torch.int32))
    host = (tab[0].clone(), tab[1].clone())
    for b in range(4 if batch <= 1024 else 1):
        ops = _ops(rng, capacity, batch, n_keys, start + b * batch, layout)
        tab, (want_e, want_o) = tds.apply_ref(tab, ops, probe)
        existed = torch.empty(batch, dtype=torch.bool)
        old = torch.empty(batch, dtype=torch.int32)
        stats = torch.zeros(8, dtype=torch.int32)
        rc = lib.kv_apply(host[0].data_ptr(), host[1].data_ptr(),
                          ops.data_ptr(), batch, capacity, probe,
                          existed.data_ptr(), old.data_ptr(),
                          stats.data_ptr(), None)
        assert rc == 0
        assert torch.equal(existed, want_e), b
        assert torch.equal(old, want_o), b
        assert torch.equal(host[0], tab[0]), b
        assert int(host[1]) == int(tab[1]), b
        levels, walked_ops, walked, blocks = stats.tolist()[:4]
        assert 1 <= blocks <= 128 * -(-batch // 4096)
        if capacity < 2 * probe or batch == 1:
            assert walked_ops == batch and levels == 0, stats
        if layout in _WALKED:
            assert (walked_ops == batch) == _WALKED[layout], stats
            assert _WALKED[layout] or (walked_ops == 0 and levels >= 2), stats
    if capacity == 64:
        assert int(tab[1]) > 0


def test_kv_apply_refuses_bad_shapes(lib):
    buf = torch.zeros(64 * 8, dtype=torch.int32)
    for capacity, probe in ((48, 16), (64, 33), (64, 0), (8, 16)):
        assert lib.kv_apply(buf.data_ptr(), buf.data_ptr(), buf.data_ptr(),
                            1, capacity, probe, buf.data_ptr(),
                            buf.data_ptr(), None, None) != 0


def _watch_inputs(rng, W, B, lmax, kinds="random"):
    """Random watch and event rows whose hashes collide often (small hash
    alphabet), kinds including pads and tables (``every_warp``: all four
    watch kinds, the three live ones and the pad, in every warp of 32),
    lengths around lmax, indexes and min indexes on both sides of
    2**31."""
    alphabet = rng.integers(0, 2**32, 4, dtype=np.uint64).astype(np.uint32)
    near = np.asarray([0, 1, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 1],
                      np.uint32)
    if kinds == "every_warp":
        kind = rng.permuted(np.tile(np.asarray([-1, 0, 1, 2], np.int32),
                                    W // 4).reshape(-1, 32), axis=1).ravel()
    else:
        kind = rng.choice(np.asarray([-1, 0, 1, 2], np.int32), W)
    w_len = rng.integers(-2, lmax + 3, W).astype(np.int32)
    watches = tds._pack_rows(kind, rng.choice(alphabet, W),
                             rng.choice(alphabet, W), w_len,
                             rng.choice(near, W))
    e_kind = rng.choice(np.asarray([-1, 0, 0, 1], np.int32), B)
    events = tds._pack_rows(e_kind, rng.integers(-1, lmax + 90, B)
                            .astype(np.int32), rng.choice(near, B),
                            rng.choice(alphabet, B), rng.choice(alphabet, B))
    hp = rng.choice(alphabet, (2, B, lmax + 1)).view(np.int32)
    return (torch.from_numpy(watches), torch.from_numpy(events),
            torch.from_numpy(np.ascontiguousarray(hp)))


@pytest.mark.parametrize("W, B, lmax, kinds", [
    _as_before(32, 1, 0, "random"), _as_before(64, 7, 4, "random"),
    _as_before(512, 16, 8, "random"),
    _as_before(256, 33, 64, "random"),
    (4096, 256, 64, "every_warp"),
    (1024, 100, 64, "random"),    # 7 blocks of 15 events
    (64, 33, 1000, "random"),     # chunks of 6 events
    (128, 12, 1000, "random"),    # one block, two chunks
    (32, 3, 7000, "random")])     # hashes from global memory
def test_watch_match_body_matches_plain(lib, W, B, lmax, kinds):
    rng = np.random.default_rng(W + B + lmax)
    watches, events, hp = _watch_inputs(rng, W, B, lmax, kinds)
    want_f, want_p = tds.match_ref(watches, events, hp, lmax)
    assert want_f.any() and not want_f.all()
    fired = torch.empty(W, dtype=torch.bool)
    packed = torch.full((W // 32,), -1, dtype=torch.int32)
    stats = torch.zeros(3, dtype=torch.int64)
    rc = lib.watch_match(watches.data_ptr(), W, events.data_ptr(),
                         hp.data_ptr(), B, lmax, fired.data_ptr(),
                         packed.data_ptr(), stats.data_ptr(), None)
    assert rc == 0
    assert torch.equal(fired, want_f)
    assert torch.equal(packed, want_p)
    live = int(((events[0] == tds.EV_KV) | (events[0] == tds.EV_TABLE)).sum())
    assert int(stats[0]) == W * live


def test_watch_match_refuses_bad_shapes(lib):
    buf = torch.zeros(1024, dtype=torch.int32)
    for W in (0, 16, 48, 100):
        assert lib.watch_match(buf.data_ptr(), W, buf.data_ptr(),
                               buf.data_ptr(), 1, 4, buf.data_ptr(),
                               buf.data_ptr(), None, None) != 0
