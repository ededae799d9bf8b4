"""The event flood's Hopper kernel on the CPU: ``csrc/event_flood.cu``
compiled by the host's C++ compiler against a small stand-in for the CUDA
runtime in which a launch runs its blocks one after another and each block
as ``blockDim.x`` host threads at once: the warp sum
(``__reduce_add_sync``) meets at a barrier of the warp's 32 threads, and
``atomicAdd`` is the compiler's ``__atomic`` builtin.

This checks the kernel's own logic before any card does: the word path
and the byte path (N % 4 != 0, windows that wrap at N), every byte value,
ages at and across the budget, push/pull rounds and not, slots past their
TTL, an alive mask with holes, shifts off by +-N, the warp sums and their
wrap mod 2**32, the Lamport witness at the int32 edge.  Each launch is
held against the plain torch version (``events.event_flood_ref``) in
every output: has, slot_used, origin, node_ltime, n_seen and the live
holders' counts.  Needs
``g++``; builds into the test's temporary directory.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from consul_tpu_torch import _build
from consul_tpu_torch.gossip import events as te

I32_MAX = 2**31 - 1

# What the kernel uses of the CUDA runtime and device built-ins, on the
# host: a block is blockDim.x threads, a warp 32 of them.
CUDA_STUB = r"""
#pragma once
#include <algorithm>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>
using std::max;
using std::min;
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __grid_constant__
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
static thread_local dim3 threadIdx, blockIdx;
template <class T> static inline T __ldg(const T* p) { return *p; }
static inline int __popc(unsigned x) { return __builtin_popcount(x); }
static inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi,
                                       uint32_t sh) {
  return static_cast<uint32_t>(((static_cast<uint64_t>(hi) << 32) | lo)
                               >> (sh & 31));
}
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
static inline unsigned __reduce_add_sync(unsigned, unsigned v) {
  host_warp->slot[threadIdx.x & 31u] = v;
  host_warp->bar.sync();
  unsigned r = 0;
  for (unsigned i = 0; i < 32; ++i) r += host_warp->slot[i];
  host_warp->bar.sync();
  return r;
}
static inline void __syncthreads() { host_block->sync(); }
template <class T> static inline T atomicAdd(T* p, T v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
// A launch: blocks one after another, each block's threads at once.
template <class K, class A>
static void host_launch(K kernel, dim3 grid, dim3 block, const A& args) {
  if (block.x % 32 != 0) std::abort();
  HostBarrier bar;
  bar.n = block.x;
  host_block = &bar;
  std::unique_ptr<HostWarp[]> warps(new HostWarp[block.x / 32]);
  std::vector<std::thread> threads;
  for (unsigned t = 0; t < block.x; ++t)
    threads.emplace_back([=, &warps] {
      threadIdx = dim3(t);
      host_warp = &warps[t / 32];
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        blockIdx = dim3(bx);
        kernel(args);
        host_block->sync();
      }
    });
  for (auto& th : threads) th.join();
}
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
static inline cudaError_t cudaGetLastError() { return cudaSuccess; }
static inline const char* cudaGetErrorString(cudaError_t) { return "error"; }
"""

# Text of the source -> its host form: the dynamic shared memory as one
# static buffer (the blocks run one after another), the launch as
# host_launch.
HOST_FORMS = {
    "extern __shared__ uint32_t flood_smem[];":
        "alignas(16) static uint32_t flood_smem[3 * kMaxSlots];",
    "flood_kernel<F><<<blocks, kThreads, smem, stream>>>(a);":
        "host_launch(flood_kernel<F>, dim3(blocks), dim3(kThreads), a);",
}


@pytest.fixture(scope="module")
def flood_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel for the host")
    d = tmp_path_factory.mktemp("flood_on_host")
    (d / "cuda_runtime.h").write_text(CUDA_STUB)
    body = (_build.CSRC / "event_flood.cu").read_text()
    for text, host in HOST_FORMS.items():
        assert body.count(text) == 1, text
        body = body.replace(text, host)
    src = d / "event_flood.cpp"
    src.write_text(body)
    so = d / "libevent_flood.so"
    r = subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC",
                        "-pthread", f"-I{d}", "-o", str(so), str(src)],
                       capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr
    lib = ctypes.CDLL(str(so))
    fn = lib.event_flood
    fn.argtypes, fn.restype = te._ARGTYPES, ctypes.c_int
    return fn


def flood_inputs(E, N, seed, rnd=500, ttl=40):
    """Every byte value (a third of the bytes; the rest seen-or-not with
    every age), senders alive with holes, slots used or free with start
    rounds on both sides of the TTL, Lamport times and clocks up to the
    int32 edge, counts next to the 2**32 wrap."""
    rng = np.random.default_rng(seed)
    has = np.where(rng.random((E, N)) < 0.35,
                   rng.integers(0, 256, (E, N)),
                   (rng.random((E, N)) < 0.4) * 0x80
                   + rng.integers(0, 16, (E, N))).astype(np.uint8)
    alive = rng.random(N) < 0.8
    used = rng.random(E) < 0.8
    start = (rnd - ttl + rng.integers(-2, 3, E)).astype(np.int32)
    ltime = rng.choice(np.asarray([-5, 0, 1, 7, 1000, I32_MAX], np.int32),
                       E)
    origin = rng.integers(-1, N, E).astype(np.int32)
    node_ltime = rng.choice(np.asarray([-3, 0, 2, 999, I32_MAX - 1,
                                        I32_MAX], np.int32), N)
    n_seen = rng.choice(np.asarray([0, 5, I32_MAX - 2, -1, -2**31],
                                   np.int32), E)
    return [torch.from_numpy(a) for a in (has, alive, used, ltime, origin,
                                          start, node_ltime, n_seen)]


def event_row(rnd, offs, pp):
    return torch.tensor([rnd, *offs, pp, -pp], dtype=torch.int32)


def _run(fn, ins, row, budget, ttl, pushpull, held=True):
    has, alive, used, ltime, origin, start, node_ltime, n_seen = ins
    E, N = has.shape
    out = te.Flood(has=torch.empty_like(has),
                   slot_used=torch.empty_like(used),
                   origin=torch.empty_like(origin),
                   node_ltime=torch.empty_like(node_ltime),
                   n_seen=n_seen.clone(), alive_seen=torch.zeros_like(n_seen))
    rc = fn(has.data_ptr(), alive.data_ptr(), used.data_ptr(),
            ltime.data_ptr(), origin.data_ptr(), start.data_ptr(),
            node_ltime.data_ptr(), out.has.data_ptr(),
            out.slot_used.data_ptr(), out.origin.data_ptr(),
            out.node_ltime.data_ptr(), out.n_seen.data_ptr(),
            out.alive_seen.data_ptr() if held else None, E, N,
            row.shape[0] - 3, row.data_ptr(), budget, ttl, int(pushpull),
            None)
    assert rc == 0
    return out


def _assert_flood_equal(got, want, ctx):
    for f in te.Flood._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and torch.equal(a, b), (ctx, f)


def _offsets(N, F, rng):
    """Shifts 1 and N - 1 first, then every residue mod 4 and random
    ones."""
    base = [1, N - 1, 2, 3, 4, 5] + rng.integers(1, N, 6).tolist()
    return [base[i % len(base)] % N or 1 for i in range(F)]


# (E, N, fanout): the word path at widths % 16 of 0, 4, 8, 12; rows that
# are not word-aligned (odd N, N % 4 = 2); the WAN pool (12 nodes, fanout
# 4); fewer nodes than a word; more slots than a block's threads.
SHAPES = [(8, 4096, 3), (5, 1028, 3), (16, 1001, 3), (7, 4098, 3),
          (32, 12, 4), (4, 3, 1), (300, 40, 2), (3, 2052, 8)]


@pytest.mark.parametrize("E, N, F", SHAPES)
def test_flood_matches_plain(flood_lib, E, N, F):
    rng = np.random.default_rng(E * 1000 + N)
    ttl = 40
    ins = flood_inputs(E, N, seed=E + N, ttl=ttl)
    for k, (budget, pushpull) in enumerate([(3, False), (3, True),
                                            (1, False), (14, True),
                                            (0, True), (16, False)]):
        offs = _offsets(N, F, rng) if k == 0 else \
            rng.integers(1, max(N, 2), F).tolist()
        pp = int(rng.integers(1, max(N, 2)))
        row = event_row(500, offs, pp)
        want = te.event_flood_ref(*ins, row, budget, ttl, pushpull)
        got = _run(flood_lib, ins, row, budget, ttl, pushpull)
        _assert_flood_equal(got, want, (E, N, budget, pushpull, offs))


@pytest.mark.parametrize("E, N, F", [(8, 4096, 3), (16, 1001, 3)])
def test_flood_reduces_shifts_mod_n(flood_lib, E, N, F):
    """Shifts off by +N and -N (and a push/pull partner off by -N) give
    the plain version's result for the shifts in [1, N)."""
    rng = np.random.default_rng(N)
    ins = flood_inputs(E, N, seed=N)
    offs = _offsets(N, F, rng)
    pp = int(rng.integers(1, N))
    want = te.event_flood_ref(*ins, event_row(9, offs, pp), 5, 7, True)
    for raw, rpp in (([o - N for o in offs], pp - N),
                     ([o + N for o in offs], pp + N)):
        row = event_row(9, raw, rpp)
        _assert_flood_equal(_run(flood_lib, ins, row, 5, 7, True), want, raw)
        _assert_flood_equal(te.event_flood_ref(*ins, row, 5, 7, True),
                            want, raw)


def test_flood_counts_wrap_and_stay_exact(flood_lib):
    """A row where every column is fresh: the warp sums add N per slot,
    wrapping past 2**31 - 1 as the int32 sum does; the witness moves every
    clock."""
    E, N = 4, 1024
    has = torch.zeros((E, N), dtype=torch.uint8)
    has[:, ::2] = 0x80
    alive = torch.ones(N, dtype=torch.bool)
    used = torch.ones(E, dtype=torch.bool)
    ltime = torch.tensor([3, I32_MAX, 0, 9], dtype=torch.int32)
    origin = torch.arange(E, dtype=torch.int32)
    start = torch.zeros(E, dtype=torch.int32)
    node_ltime = torch.full((N,), 5, dtype=torch.int32)
    n_seen = torch.tensor([I32_MAX - 100, -1, 0, -2**31],
                          dtype=torch.int32)
    ins = [has, alive, used, ltime, origin, start, node_ltime, n_seen]
    row = event_row(1, [1, 3], 7)
    want = te.event_flood_ref(*ins, row, 3, 100, False)
    got = _run(flood_lib, ins, row, 3, 100, False)
    _assert_flood_equal(got, want, "wrap")
    assert int(want.n_seen[0]) < 0  # wrapped
    assert int(want.node_ltime[1]) == -2**31  # max(5, I32_MAX) + 1 wraps


def test_flood_over_many_seeds(flood_lib):
    """Fresh inputs, shifts and partners over many seeds at one shape,
    each with and without push/pull."""
    E, N = 8, 2048
    for seed in range(12):
        rng = np.random.default_rng(1000 + seed)
        ins = flood_inputs(E, N, seed=1000 + seed)
        row = event_row(500, rng.integers(1, N, 3).tolist(),
                        int(rng.integers(1, N)))
        for pushpull in (False, True):
            want = te.event_flood_ref(*ins, row, 4, 40, pushpull)
            _assert_flood_equal(_run(flood_lib, ins, row, 4, 40, pushpull),
                                want, (seed, pushpull))
    # Without the live holders' counts (a null pointer) the rest is the
    # same and the counts' buffer is left alone.
    got = _run(flood_lib, ins, row, 4, 40, True, held=False)
    _assert_flood_equal(got._replace(alive_seen=want.alive_seen), want,
                        "no counts")
    assert int(got.alive_seen.abs().sum()) == 0


def test_flood_refuses_what_it_does_not_take(flood_lib):
    ins = flood_inputs(4, 64, seed=1)
    row = event_row(1, [1] * 9, 2)
    args = [t.data_ptr() for t in ins[:7]] + [None] * 5
    for E, N, F, r in ((0, 64, 3, row), (4, 0, 3, row), (4, 64, 0, row),
                       (4, 64, 9, row), (4, 64, 3, None), (3073, 64, 3, row)):
        assert flood_lib(*args, None, E, N, F, None if r is None
                         else r.data_ptr(), 3, 40, 0, None) != 0
