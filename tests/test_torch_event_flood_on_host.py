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
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __grid_constant__
// A block's shared memory: one static per kernel, the blocks run one
// after another.
#define __shared__ static
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint4 {
  uint32_t x, y, z, w;
};
static inline uint4 make_uint4(uint32_t x, uint32_t y, uint32_t z,
                               uint32_t w) {
  return uint4{x, y, z, w};
}
struct int4 {
  int x, y, z, w;
};
static inline int4 make_int4(int x, int y, int z, int w) {
  return int4{x, y, z, w};
}
static thread_local dim3 threadIdx, blockIdx;
template <class T> static inline T __ldg(const T* p) { return *p; }
template <class T> static inline T __ldcg(const T* p) {
  return __atomic_load_n(p, __ATOMIC_SEQ_CST);
}
static inline uint4 __ldg(const uint4* p) { return *p; }
static inline void __threadfence() {
  __atomic_thread_fence(__ATOMIC_SEQ_CST);
}
static inline int __popc(unsigned x) { return __builtin_popcount(x); }
static inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  const uint64_t v = (static_cast<uint64_t>(y) << 32) | x;
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i) {
    r |= static_cast<uint32_t>((v >> (8 * ((s >> (4 * i)) & 7))) & 0xFF)
         << (8 * i);
  }
  return r;
}
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
static inline uint32_t __shfl_down_sync(unsigned, uint32_t v,
                                        unsigned delta) {
  const unsigned lane = threadIdx.x & 31u;
  host_warp->slot[lane] = v;
  host_warp->bar.sync();
  const uint32_t r = lane + delta < 32 ? host_warp->slot[lane + delta] : v;
  host_warp->bar.sync();
  return r;
}
static inline uint32_t __shfl_sync(unsigned, uint32_t v, int src) {
  const unsigned lane = threadIdx.x & 31u;
  host_warp->slot[lane] = v;
  host_warp->bar.sync();
  const uint32_t r = host_warp->slot[src & 31];
  host_warp->bar.sync();
  return r;
}
static inline int __all_sync(unsigned, int v) {
  return static_cast<int>(__reduce_add_sync(0xFFFFFFFFu, v ? 1u : 0u) == 32);
}
static inline void __syncthreads() { host_block->sync(); }
template <class T> static inline T atomicAdd(T* p, T v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
static inline int atomicMax(int* p, int v) {
  int old = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (old < v && !__atomic_compare_exchange_n(
                        p, &old, v, false, __ATOMIC_SEQ_CST,
                        __ATOMIC_SEQ_CST)) {
  }
  return old;
}
// A launch: blocks one after another (x fastest), each block's threads
// at once.  `order` > 1 runs the slot groups (y) of each column tile
// last-first, so that a tile's witness is finished by another group than
// the last one in y.
static int host_order = 1;
template <class K, class... A>
static void host_launch(K kernel, dim3 grid, dim3 block, const A&... args) {
  if (block.x % 32 != 0) std::abort();
  HostBarrier bar;
  bar.n = block.x;
  host_block = &bar;
  std::unique_ptr<HostWarp[]> warps(new HostWarp[block.x / 32]);
  std::vector<std::thread> threads;
  for (unsigned t = 0; t < block.x; ++t)
    threads.emplace_back([=, &warps, &args...] {
      threadIdx = dim3(t);
      host_warp = &warps[t / 32];
      for (unsigned k = 0; k < grid.y; ++k) {
        const unsigned by = host_order > 1 ? grid.y - 1 - k : k;
        for (unsigned bx = 0; bx < grid.x; ++bx) {
          blockIdx = dim3(bx, by);
          kernel(args...);
          host_block->sync();
        }
      }
    });
  for (auto& th : threads) th.join();
}
extern "C" void event_flood_host_order(int order) { host_order = order; }
// The slots of a slot group, set by a test (0: the launcher's rule); the
// source's EVFLOOD_HOST_GROUP_ROWS names it in this build.
static int host_group_rows = 0;
extern "C" void event_flood_host_group_rows(int rows) {
  host_group_rows = rows;
}
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
static inline cudaError_t cudaGetLastError() { return cudaSuccess; }
static inline const char* cudaGetErrorString(cudaError_t) { return "error"; }
"""

# Text of the source -> its host form: the launch as host_launch.
HOST_FORMS = {
    f"flood_kernel<F, {pp}><<<grid, kThreads, 0, stream>>>(has, alive, "
    f"out_has, a);":
        f"host_launch(flood_kernel<F, {pp}>, grid, dim3(kThreads), has, "
        f"alive, out_has, a);"
    for pp in ("true", "false")
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
                        "-pthread", "-DEVFLOOD_HOST_GROUP_ROWS=host_group_rows",
                        f"-I{d}", "-o", str(so), str(src)],
                       capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr
    lib = ctypes.CDLL(str(so))
    fn = lib.event_flood
    fn.argtypes, fn.restype = te._ARGTYPES, ctypes.c_int
    lib.event_flood_scratch_words.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.event_flood_scratch_words.restype = ctypes.c_longlong
    lib.event_flood_host_order.argtypes = [ctypes.c_int]
    lib.event_flood_host_group_rows.argtypes = [ctypes.c_int]
    fn.lib = lib
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


def _run(fn, ins, row, budget, ttl, pushpull, held=True, group_rows=None,
         scratch=None):
    """One launch through the C entry point, as the wrapper packs it, into
    new outputs (the live holders' buffer zero), in the launcher's slot
    groups unless ``group_rows`` sets the slots of a group (0: the
    launcher's rule).  The scratch must be left zero."""
    has, alive, used, ltime, origin, start, node_ltime, n_seen = ins
    E, N = has.shape
    fn.lib.event_flood_host_group_rows(group_rows or 0)
    out = te.Flood(has=torch.empty_like(has),
                   slot_used=torch.empty_like(used),
                   origin=torch.empty_like(origin),
                   node_ltime=torch.empty_like(node_ltime),
                   n_seen=torch.empty_like(n_seen),
                   alive_seen=torch.zeros_like(n_seen))
    if scratch is None:
        scratch = te.flood_scratch(E, N, "cpu")
    assert fn.lib.event_flood_scratch_words(E, N) == scratch.numel()
    rc = fn(has.data_ptr(), alive.data_ptr(), used.data_ptr(),
            ltime.data_ptr(), origin.data_ptr(), start.data_ptr(),
            node_ltime.data_ptr(), n_seen.data_ptr(), out.has.data_ptr(),
            out.slot_used.data_ptr(), out.origin.data_ptr(),
            out.node_ltime.data_ptr(), out.n_seen.data_ptr(),
            out.alive_seen.data_ptr() if held else None,
            scratch.data_ptr(), E, N, row.shape[0] - 3, row.data_ptr(),
            budget, ttl, int(pushpull), None)
    fn.lib.event_flood_host_group_rows(0)
    assert rc == 0
    assert int(scratch.abs().sum()) == 0, "the scratch was not left zero"
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


# (E, N, fanout): the word path (N % 4 == 0) at N % 1024 of 0, 16, 4 and
# 8, and at fanout 8; the byte path at odd N and N % 4 = 2; the WAN pool
# (12 nodes, fanout 4); fewer nodes than a word; more slots than a block's
# threads.
SHAPES = [(8, 4096, 3), (5, 1040, 3), (3, 2064, 8), (5, 1028, 3),
          (16, 1001, 3), (7, 4098, 3), (32, 12, 4), (4, 3, 1), (300, 40, 2),
          (3, 2052, 8)]


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
    """Each argument out of range, or a pointer missing, refuses the
    launch with every other argument valid (which alone launches)."""
    ins = flood_inputs(4, 64, seed=1)
    row = event_row(1, [1] * 9, 2)
    outs = [torch.empty_like(t) for t in (ins[0], ins[2], ins[4], ins[6],
                                          ins[7], ins[7])]
    scratch = te.flood_scratch(3073, 64, "cpu")
    ptrs = [t.data_ptr() for t in ins + outs] + [scratch.data_ptr()]

    def call(ptrs=ptrs, E=4, N=64, F=3, r=row.data_ptr()):
        return flood_lib(*ptrs, E, N, F, r, 3, 40, 0, None)

    assert call() == 0
    for kw in ({"E": 0}, {"N": 0}, {"F": 0}, {"F": 9}, {"r": None},
               {"E": 3073}, {"N": 2**31 - 8}):
        assert call(**kw) != 0, kw
    for i in range(len(ptrs)):
        if i != 13:  # the live holders' counts may be null
            assert call(ptrs=ptrs[:i] + [None] + ptrs[i + 1:]) != 0, i
    assert call(ptrs=ptrs[:14] + [scratch.data_ptr() + 2]) != 0


@pytest.fixture
def reversed_groups(flood_lib):
    """Launches run each column tile's slot groups last-first."""
    flood_lib.lib.event_flood_host_order(2)
    yield
    flood_lib.lib.event_flood_host_order(1)


# (E, N, F, group_rows; 0 the launcher's rule): one slot; slot counts that
# are no multiple of a group or of the block's 8 warps (13 over groups of
# 8, 3 and 5); every slot the kernel takes (in groups of 256, the most a
# group holds: a block runs on the host in about a tenth of a second); 96
# slots of a short row; the WAN pool's [32, 12] under the launcher's rule,
# in one group and in groups of 8; odd N [64, 16,001] in groups of 32 and
# 64; groups of 3 slots over 16 column tiles.
GROUP_CASES = [(1, 1000, 3, 0), (13, 700, 2, 8), (13, 700, 2, 3),
               (13, 2060, 3, 5), (3072, 40, 3, 256), (96, 40, 3, 0),
               (32, 12, 4, 0), (32, 12, 4, 32), (32, 12, 4, 8),
               (64, 16_001, 3, 32), (64, 16_001, 3, 64), (24, 2048, 3, 3)]


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("E, N, F, group_rows", GROUP_CASES)
def test_flood_slot_groups_match_plain(flood_lib, E, N, F, group_rows,
                                       order):
    """Every output against the plain version however the slots are split
    into groups and in whichever order the groups of a tile arrive, with
    windows that wrap at N (shifts 1 and N - 1), push/pull off and on."""
    flood_lib.lib.event_flood_host_order(order)
    try:
        rng = np.random.default_rng(E * 7 + N + group_rows)
        ins = flood_inputs(E, N, seed=E + N + group_rows)
        for k, (budget, pushpull) in enumerate([(3, False), (14, True)]):
            offs = _offsets(N, F, rng) if k == 0 else \
                rng.integers(1, N, F).tolist()
            row = event_row(500, offs, int(rng.integers(1, N)))
            want = te.event_flood_ref(*ins, row, budget, 40, pushpull)
            got = _run(flood_lib, ins, row, budget, 40, pushpull,
                       group_rows=group_rows)
            _assert_flood_equal(got, want, (E, N, group_rows, order, k))
    finally:
        flood_lib.lib.event_flood_host_order(1)


def _witness_case():
    """24 slots over 1,500 columns (3 column tiles of 512), every node
    alive, one shift of 1: column c takes slot e's event where has[e, c -
    1] is seen and has[e, c] is not.  Column 100 takes slots 2, 13 and 22
    (warps 2, 5 and 6 of one group; groups 0, 1 and 2 of 8), the largest
    Lamport time in slot 22, from a
    clock of 5; column 1100 (another tile) the largest in slot 2, from a
    clock at 2**31 - 2; column 300 only slots of times 0 and -5; column
    301 slot 13 alone, from the clock 2**31 - 1, past which it wraps."""
    E, N = 24, 1500
    has = torch.zeros((E, N), dtype=torch.uint8)
    ltime = torch.zeros(E, dtype=torch.int32)
    node_ltime = torch.full((N,), 9, dtype=torch.int32)
    for e, lt in ((2, 1000), (13, 70), (22, I32_MAX)):
        has[e, 99] = 0x80
        ltime[e] = lt
    for e in (2, 13):
        has[e, 1099] = 0x80
    has[22, 1099] = 0x80 | 14   # too old to be sent
    has[5, 299], ltime[5] = 0x80, 0
    has[6, 299], ltime[6] = 0x80, -5
    has[13, 300] = 0x80
    node_ltime[100], node_ltime[1100] = 5, I32_MAX - 1
    node_ltime[301] = I32_MAX
    ins = [has, torch.ones(N, dtype=torch.bool), torch.ones(E, dtype=torch.bool),
           ltime, torch.arange(E, dtype=torch.int32),
           torch.zeros(E, dtype=torch.int32), node_ltime,
           torch.zeros(E, dtype=torch.int32)]
    return ins, event_row(3, [1], 7)


@pytest.mark.parametrize("group_rows", [0, 8, 24, 3, 1])
def test_flood_witness_crosses_slot_groups(flood_lib, group_rows,
                                           reversed_groups):
    """The witness max of a column over slots of other slot groups,
    finished by whichever group of the tile arrives last, at the int32
    edge."""
    ins, row = _witness_case()
    want = te.event_flood_ref(*ins, row, 3, 100, False)
    got = _run(flood_lib, ins, row, 3, 100, False, group_rows=group_rows)
    _assert_flood_equal(got, want, group_rows)
    nl = got.node_ltime
    assert int(nl[100]) == -2**31            # max(5, 2**31 - 1) + 1 wraps
    assert int(nl[1100]) == I32_MAX          # max(2**31 - 2, 1000) + 1
    assert int(nl[300]) == 9                 # witness 0: unchanged
    assert int(nl[301]) == -2**31
    assert int(nl[99]) == 9 and int(nl[0]) == 9


def test_flood_scratch_serves_many_launches(flood_lib):
    """One scratch through launches of other shapes' groups and of the
    same shape: each launch leaves it zero, so the next sees no count or
    witness of the last."""
    E, N = 16, 1100
    scratch = te.flood_scratch(E, N, "cpu")
    rng = np.random.default_rng(5)
    for k, group_rows in enumerate([0, 8, 16, 3, 0]):
        ins = flood_inputs(E, N, seed=70 + k)
        row = event_row(500, rng.integers(1, N, 3).tolist(),
                        int(rng.integers(1, N)))
        want = te.event_flood_ref(*ins, row, 4, 40, k % 2 == 1)
        got = _run(flood_lib, ins, row, 4, 40, k % 2 == 1,
                   group_rows=group_rows, scratch=scratch)
        _assert_flood_equal(got, want, group_rows)


@pytest.mark.parametrize("pushpull", [False, True])
def test_flood_word_path_every_window_residue(flood_lib, pushpull):
    """The word path's windows at every column offset mod 16 (every byte
    shift a lane's word is joined with its neighbour's at), with the
    partner legs at two more."""
    E, N = 6, 2048
    ins = flood_inputs(E, N, seed=31)
    for lo in (0, 8):
        offs = [32 * (k + 1) + lo + k for k in range(8)]
        row = event_row(500, offs, 64 + lo + 3)
        want = te.event_flood_ref(*ins, row, 5, 40, pushpull)
        _assert_flood_equal(_run(flood_lib, ins, row, 5, 40, pushpull),
                            want, (lo, pushpull))
