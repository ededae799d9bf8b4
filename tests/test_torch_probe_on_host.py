"""The probe tick's Hopper kernels on the CPU: ``csrc/probe.cu`` (with the
shared ``csrc/threefry.cuh``) compiled by the host's C++ compiler against
a small stand-in for the CUDA runtime in which a launch runs its blocks
one after another (or last-first) and each block as ``blockDim.x`` host
threads at once: a warp's ballot, minimum and sum meet at a barrier of
its 32 threads, ``__syncthreads``, ``__syncthreads_count`` and
``__syncthreads_or`` at a barrier of the block, the atomics and the
arrival's release and acquire are the compiler's ``__atomic`` builtins,
and the occupancy query gives the grid the test asks for (one SM).

Each launch goes through the port's own wrappers
(``probe.probe_lanes_slots``, ``probe_rearm_marks``: their checks, the
pointer table, the integers and probabilities as the card gets them, the
launch counters) and the tick's launches are held, field for field after
each, against the plain versions (``probe_lanes_ref`` then
``probe_slots_ref``; the wipe's ``finish.wipe_rows_ref`` then
``probe_marks_ref``) on the cases of tests/test_torch_probe.py (every
variant: aligned and unaligned N, K 0 and 3, the partition legs by hash
and by halves at 0 < p < 1 and 1, degraded observers, LHM threaded, a
one-lane block, drops, 2 and 8 shards), a block of 300 lanes, one of
2,000 in 8 segments and 600 slots (the slot step's chunks), each on a
grid of one block (every chunk of lanes by one block), of two and of a
block a chunk, in block order and last-first (so the block that runs
the slot step is the last, or block 0); the scratch left as the next
round needs it.  The wipe and the marks alone (``REARM_CASES``): rearmed
rows that hold marks beside marks in rows that are not rearmed, none and
every row rearmed, 8 shards of 250 and of 31 columns (L % 16 != 0) at
odd byte offsets, flags at an odd word of the scratch, a block past N;
16-byte accesses trap the host build where misaligned.  Needs ``g++``;
builds into the test's temporary directory.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from consul_tpu_torch import _build
from consul_tpu_torch.gossip import finish, probe, round_args
from consul_tpu_torch.gossip import kernel as tk
from consul_tpu_torch.gossip import nemesis as t_nem
from consul_tpu_torch.gossip.params import SwimParams as TParams
from tests.test_torch_probe import CASES, RND, case_state

# What the kernels use of the CUDA runtime and device built-ins, on the
# host: a block is blockDim.x threads, a warp 32 of them.
CUDA_STUB = r"""
#pragma once
#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
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
#define __grid_constant__
// A block's shared memory: one static per function, the blocks run one
// after another.
#define __shared__ static
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
static thread_local dim3 threadIdx, blockIdx;
static dim3 gridDim;
struct uint4 {
  uint32_t x, y, z, w;
};
static inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c,
                               uint32_t d) {
  return uint4{a, b, c, d};
}
template <class T> static inline T __ldg(const T* p) { return *p; }
static inline int __popc(unsigned x) { return __builtin_popcount(x); }
static inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi,
                                       uint32_t sh) {
  return static_cast<uint32_t>(
      (((static_cast<uint64_t>(hi) << 32) | lo) << (sh & 31)) >> 32);
}
static inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
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
static std::atomic<int> host_count{0};
static inline unsigned __ballot_sync(unsigned, int pred) {
  host_warp->slot[threadIdx.x & 31u] = pred ? 1u : 0u;
  host_warp->bar.sync();
  unsigned m = 0;
  for (unsigned i = 0; i < 32; ++i) m |= host_warp->slot[i] << i;
  host_warp->bar.sync();
  return m;
}
static inline unsigned __reduce_add_sync(unsigned, unsigned v) {
  host_warp->slot[threadIdx.x & 31u] = v;
  host_warp->bar.sync();
  unsigned m = 0;
  for (unsigned i = 0; i < 32; ++i) m += host_warp->slot[i];
  host_warp->bar.sync();
  return m;
}
static inline int __reduce_min_sync(unsigned, int v) {
  host_warp->slot[threadIdx.x & 31u] = static_cast<uint32_t>(v);
  host_warp->bar.sync();
  int m = static_cast<int>(host_warp->slot[0]);
  for (unsigned i = 1; i < 32; ++i)
    m = std::min(m, static_cast<int>(host_warp->slot[i]));
  host_warp->bar.sync();
  return m;
}
static inline void __syncthreads() { host_block->sync(); }
static inline int __syncthreads_count(int pred) {
  if (pred) host_count.fetch_add(1);
  host_block->sync();
  const int v = host_count.load();
  host_block->sync();
  if (threadIdx.x == 0) host_count.store(0);
  host_block->sync();
  return v;
}
static inline int __syncthreads_or(int pred) {
  return __syncthreads_count(pred) != 0;
}
template <class T> static inline T __ldcg(const T* p) {
  return __atomic_load_n(p, __ATOMIC_RELAXED);
}
static inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
static inline int atomicMin(int* p, int v) {
  int old = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (v < old && !__atomic_compare_exchange_n(
                        p, &old, v, false, __ATOMIC_SEQ_CST,
                        __ATOMIC_SEQ_CST)) {
  }
  return old;
}
// A launch: blocks one after another, each block's threads at once;
// `host_reverse` runs them last-first.
static int host_reverse = 0;
template <class K, class... A>
static void host_launch(K kernel, dim3 grid, dim3 block, const A&... args) {
  if (block.x % 32 != 0) std::abort();
  gridDim = grid;
  HostBarrier bar;
  bar.n = block.x;
  host_block = &bar;
  std::unique_ptr<HostWarp[]> warps(new HostWarp[block.x / 32]);
  std::vector<std::thread> threads;
  const unsigned blocks = grid.x;
  for (unsigned t = 0; t < block.x; ++t)
    threads.emplace_back([=, &warps, &args...] {
      threadIdx = dim3(t);
      host_warp = &warps[t / 32];
      for (unsigned k = 0; k < blocks; ++k) {
        blockIdx = dim3(host_reverse ? blocks - 1 - k : k);
        kernel(args...);
        host_block->sync();
      }
    });
  for (auto& th : threads) th.join();
}
extern "C" void probe_host_reverse(int on) { host_reverse = on; }
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1,
                   cudaErrorInvalidConfiguration = 9 };
static inline cudaError_t cudaGetLastError() { return cudaSuccess; }
// One SM, on which `host_blocks` blocks fit: the grid the test asks for.
static int host_blocks = 1;
extern "C" void probe_host_blocks(int n) { host_blocks = n; }
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
static inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
static inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr,
                                                 int) {
  *v = 1;
  return cudaSuccess;
}
template <class K>
static inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* n, K, int, size_t) {
  *n = host_blocks;
  return cudaSuccess;
}
static inline const char* cudaGetErrorString(cudaError_t e) {
  return e ? "invalid argument" : "no error";
}
"""

# A launch in the source -> its host form.
LAUNCH = re.compile(r"(\w+_kernel)<<<(.+?), (\S+?), 0,\s*"
                    r"static_cast<cudaStream_t>\(stream\)>>>\(a\);")

# Beyond tests/test_torch_probe.py's cases: a block of 300 lanes, two
# chunks of lanes, every leg and the Lifeguard registers; 2,000 lanes in
# 8 segments of 250 (a warp's needy minima reduced before its atomics,
# one warp and each chunk across two segments); 600 slots, 400 of them
# free, and 600 segments of 5 lanes (the slot step's three chunks of
# slots and of candidates, the candidates more than the free slots).
HOST_CASES = dict(CASES, two_blocks=(
    1500, 32, 5, 3, 0.1, dict(part_kind="hash", p_ab=0.6, p_ba=0.2,
                              obs_lo=100, obs_hi=1400, p_obs_miss=0.3,
                              lhm_max=3), True, 1, 10),
    warp_minima=(2000, 8, 1, 3, 0.1, None, False, 1, 4),
    wide_slots=(3000, 600, 1, 3, 0.1, None, False, 1, 400),
    # Around the narrow kernels' 1,024 staged slots (the reference
    # provisions more itself: crossval.loss_sized_slots,
    # run_nemesis_config): 1,024 (the last narrow launch), then the wide
    # kernels at 1,025, 2,048 and a ragged 3,001 (the slot step's
    # registers from memory and its free slots in the scratch, the
    # rearmed rows listed in chunks), free slots and candidates over
    # several chunks of 1,024, every leg and LHM at 1,025.
    slots_1024=(4000, 1024, 1, 3, 0.1, None, False, 1, 600),
    slots_1025=(4000, 1025, 1, 3, 0.1, dict(
        part_kind="hash", p_ab=0.6, p_ba=0.2, obs_lo=100, obs_hi=3000,
        p_obs_miss=0.3, lhm_max=3), True, 2, 700),
    slots_2048=(6000, 2048, 1, 3, 0.1, None, False, 1, 1200),
    slots_3001=(8000, 3001, 1, 3, 0.1, None, False, 2, 1800))
# Grids of the merged launch: one block, two, and a block a chunk.
GRIDS = (1, 2, 1 << 20)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernels for the host")
    d = tmp_path_factory.mktemp("probe_on_host")
    (d / "cuda_runtime.h").write_text(CUDA_STUB)
    body, n = LAUNCH.subn(r"host_launch(\1, dim3(\2), dim3(\3), a);",
                          (_build.CSRC / "probe.cu").read_text())
    assert n == 4, n  # each kernel's narrow and wide instance
    src = d / "probe.cpp"
    src.write_text(body)
    so = d / "libprobe.so"
    r = subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC",
                        "-pthread", f"-I{d}", f"-I{_build.CSRC}", "-o",
                        str(so), str(src)],
                       capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr
    lib = ctypes.CDLL(str(so))
    for name in probe.ENTRY_POINTS:
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = probe._ARGTYPES, ctypes.c_int
    lib.probe_error.argtypes = [ctypes.c_int]
    lib.probe_error.restype = ctypes.c_char_p
    lib.probe_scratch_words.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.probe_scratch_words.restype = ctypes.c_longlong
    lib.probe_rearm_marks_blocks.argtypes = [ctypes.c_int] * 4
    lib.probe_rearm_marks_blocks.restype = ctypes.c_int
    lib.probe_host_reverse.argtypes = [ctypes.c_int]
    lib.probe_host_blocks.argtypes = [ctypes.c_int]
    return lib


@pytest.fixture
def on_host(lib, monkeypatch):
    """The wrappers' launches go to the host build (stream None), and
    their CPU tensors pass the card check."""
    def launch(fn, err, name, dev, *args):
        rc = fn(*args, None)
        assert rc == 0, err(rc)
    fns = tuple(getattr(lib, name) for name in probe.ENTRY_POINTS)
    monkeypatch.setattr(probe, "_lib", lambda: (fns, lib.probe_error))
    monkeypatch.setattr(_build, "launch", launch)
    monkeypatch.setattr(probe, "require_cuda", lambda name, t: None)
    return lib


def _case(name):
    n, S, pe, K, loss, nem_f, lhm, ndev, free = HOST_CASES[name]
    p = TParams(n=n, slots=S, probe_every=pe, indirect_k=K, loss_rate=loss)
    nem = None if nem_f is None else t_nem.NemesisParams(
        scenario="probe", start=0, stop=10_000, **nem_f)
    seed = 7 + n + S
    tbl = round_args.build(p, np.asarray([0, seed], np.uint32), RND, 1)
    ra = round_args.row_args(round_args.layout(p.fanout, p.indirect_k),
                             torch.from_numpy(tbl[0]))
    st, mf, ns = case_state(p, int(ra.blk), int(ra.probe[0]), seed, free,
                            nem_f["lhm_max"] if lhm else 0)
    cfg = probe.config(p, tk.round_variant(p, nem, RND), nem)
    return p, cfg, ra, st, mf, ns, ndev


def _tick(p, cfg, ra, st, mf, ns, ndev) -> probe.Tick:
    """A fresh copy of the case's tensors as the round gives them."""
    heard = torch.from_numpy(st["heard"].copy())
    if ndev > 1:
        L = p.n // ndev
        heard = tuple(heard[:, i * L:(i + 1) * L].clone()
                      for i in range(ndev))
    return probe.Tick(
        heard, ra, torch.from_numpy(mf.copy()),
        torch.from_numpy(st["slot_of_node"].copy()),
        None if ns is None else tk.NemState(
            *(torch.from_numpy(x.copy()) for x in ns)),
        tuple(torch.from_numpy(st[f].copy()) for f in (
            "slot_node", "slot_phase", "slot_inc", "slot_start",
            "slot_nsusp", "slot_dead_round")),
        torch.from_numpy(st["incarnation"].copy()),
        torch.tensor(int(st["drops"]), dtype=torch.int32),
        probe.scratch(p, "cpu"))


def _leaves(t: probe.Tick) -> list:
    heard = t.heard if isinstance(t.heard, tuple) else (t.heard,)
    return [*heard, t.slot_of_node, *(t.nem_state or ()), *t.slots,
            t.drops, t.sp]


def _same(a: probe.Tick, b: probe.Tick, what: str) -> None:
    for i, (x, y) in enumerate(zip(_leaves(a), _leaves(b))):
        assert torch.equal(x, y), f"{what}: leaf {i} differs"


@pytest.mark.parametrize("name", sorted(HOST_CASES))
def test_kernels_match_plain(on_host, name):
    p, cfg, ra, st, mf, ns, ndev = _case(name)
    assert on_host.probe_scratch_words(p.slots, cfg.B) \
        == probe.scratch_words(p.slots, cfg.B)
    for grid in GRIDS:
        for reverse in (False, True):
            got, want = _tick(p, cfg, ra, st, mf, ns, ndev), \
                _tick(p, cfg, ra, st, mf, ns, ndev)
            on_host.probe_host_blocks(grid)
            on_host.probe_host_reverse(int(reverse))
            what = f"{name} grid {grid} reverse {reverse}"
            n0 = (probe.lanes_slots_launches, probe.rearm_marks_launches)
            try:
                rearm, stats = probe.probe_lanes_slots(cfg, got)
                probe.probe_lanes_ref(cfg, want.ra, want.mf, want.heard,
                                      want.slot_of_node, want.nem_state,
                                      want.sp)
                rearm_w, stats_w = probe.probe_slots_ref(
                    cfg, want.ra, want.slots, want.slot_of_node,
                    want.incarnation, want.drops, want.sp)
                _same(got, want, f"{what} lanes_slots")
                assert torch.equal(rearm, rearm_w), what
                assert torch.equal(stats, stats_w), what
                probe.probe_rearm_marks(cfg, got, rearm)
                finish.wipe_rows_ref(want.heard, rearm_w)
                probe.probe_marks_ref(cfg, want.ra, want.heard,
                                      want.slot_of_node, want.sp)
                _same(got, want, f"{what} rearm_marks")
            finally:
                on_host.probe_host_reverse(0)
                on_host.probe_host_blocks(1)
            assert (probe.lanes_slots_launches,
                    probe.rearm_marks_launches) == tuple(x + 1 for x in n0)
            # The minima at N, the counts and the arrival counter at 0.
            minima, counts, _ = probe._views(cfg, got.sp)
            assert bool((minima == p.n).all()) and not bool(counts.any())
            assert int(stats[3]) > 0, name  # initiators


def test_launch_shapes_name_the_variant(on_host):
    p, cfg, ra, st, mf, ns, ndev = _case("sharded_8")
    probe.launch_shapes.clear()
    t = _tick(p, cfg, ra, st, mf, ns, ndev)
    rearm, _ = probe.probe_lanes_slots(cfg, t)
    probe.probe_rearm_marks(cfg, t, rearm)
    assert probe.launch_shapes == {
        (k, cfg.B, p.slots, p.n, p.n // 8, 8, (2, True, 3, True))
        for k in ("probe_lanes_slots", "probe_rearm_marks")}


def test_refused_arguments(on_host):
    """The wrapper refuses what the kernels do not take; the C entry
    points refuse a table they cannot run."""
    p, cfg, ra, st, mf, ns, ndev = _case("aligned_k3")
    t = _tick(p, cfg, ra, st, mf, ns, ndev)
    with pytest.raises(ValueError, match="scratch"):
        probe.probe_lanes_slots(cfg, t._replace(sp=t.sp[:-1]))
    with pytest.raises(ValueError, match=f"S <= {probe.MAX_SLOTS}"):
        probe.probe_lanes_slots(cfg._replace(S=probe.MAX_SLOTS + 1), t)
    with pytest.raises(ValueError, match="slot register"):
        probe.probe_lanes_slots(cfg, t._replace(slots=t.slots[:5] + (
            t.slots[5].to(torch.int64),)))
    ptrs = (ctypes.c_void_p * 21)(*([t.sp.data_ptr()] * 21))
    ints = (ctypes.c_int * 9)(p.n, p.n + 1, p.slots, 3, 0, 0, 0, 0, 0)
    floats = (ctypes.c_float * 5)()
    table = (ctypes.c_void_p * 1)(t.heard.data_ptr())
    assert on_host.probe_lanes_slots(table, 1, ptrs, ints, floats,
                                     None) != 0
    assert on_host.probe_rearm_marks(table, 1, ptrs, ints, floats,
                                     None) != 0
    with pytest.raises(ValueError, match="rearm"):
        probe.probe_rearm_marks(cfg, t, torch.zeros(p.slots + 1,
                                                    dtype=torch.bool))
    ptrs[18] = None  # no rearm flags: neither launch takes that
    ints[1] = cfg.B
    assert on_host.probe_lanes_slots(table, 1, ptrs, ints, floats,
                                     None) != 0
    assert on_host.probe_rearm_marks(table, 1, ptrs, ints, floats,
                                     None) != 0
    ptrs[18] = t.sp.data_ptr()
    ptrs[19] = None  # no stats: only the lanes and slots launch needs them
    ints[1] = cfg.B
    assert on_host.probe_lanes_slots(table, 1, ptrs, ints, floats,
                                     None) != 0
    # A device on which no block of the kernel fits.
    ptrs[19] = t.sp.data_ptr()
    on_host.probe_host_blocks(0)
    try:
        assert on_host.probe_lanes_slots(table, 1, ptrs, ints, floats,
                                         None) != 0
        assert on_host.probe_lanes_slots_blocks(1000) < 0
        assert on_host.probe_rearm_marks_blocks(1000, 8, 1000, 1) < 0
        # The grid: the wave, or a block a chunk of 256 lanes.
        on_host.probe_host_blocks(3)
        assert [on_host.probe_lanes_slots_blocks(b)
                for b in (1, 256, 257, 1000)] == [1, 1, 2, 3]
        # The wipe and marks: the wave (at most 4 blocks an SM), or the
        # most items a half of the launch has.
        assert [on_host.probe_rearm_marks_blocks(16, S, 16, 1)
                for S in (1, 2, 64)] == [1, 2, 3]
        on_host.probe_host_blocks(8)
        assert on_host.probe_rearm_marks_blocks(1000, 64, 1000, 1) == 4
    finally:
        on_host.probe_host_blocks(1)


# The wipe and the marks alone: name -> (N, S, probe_every, shards, the
# prober block's first id, byte offset of each shard's buffer, rearmed
# rows: "some", "none" or "all").  At S = 5 the flags start at byte 52 of
# the scratch (kk = 5: not 16-byte aligned); a block past N holds padding
# lanes.
REARM_CASES = {
    "rearmed_rows_hold_marks": (2000, 16, 5, 1, 800, 0, "some"),
    "no_row_rearmed": (2000, 16, 5, 1, 800, 0, "none"),
    "every_row_rearmed": (2000, 16, 5, 1, 400, 0, "all"),
    "shards_l250_odd_offsets": (2000, 5, 4, 8, 500, 3, "some"),
    "shards_l31": (248, 8, 2, 8, 124, 5, "some"),
    "block_past_n": (243, 8, 3, 1, 200, 0, "some"),
    # Past the 1,024 rows one listing takes: the rearmed rows listed and
    # written in chunks.
    "wide_rows_hold_marks": (6000, 2100, 2, 2, 1000, 3, "some"),
    "wide_every_row_rearmed": (3000, 3001, 3, 1, 0, 0, "all"),
}


def _rearm_tick(name, seed):
    """A tick's tensors after its slot step, for the wipe and the marks
    alone: a flag on about a third of the valid lanes, their targets'
    slots live (every row), the rearmed rows among those initiators'
    targets (so they hold marks), every byte value in the matrix."""
    n, S, pe, ndev, blk, off, which = REARM_CASES[name]
    p = TParams(n=n, slots=S, probe_every=pe)
    cfg = probe.config(p, tk.round_variant(p, None, RND))
    rng = np.random.default_rng(seed)
    B, N, L = cfg.B, n, n // ndev
    o_t = int(rng.integers(1, N))
    ra = round_args.custom(p, RND, probe=[o_t] + [1] * p.indirect_k,
                           blk=blk)
    pid = blk + np.arange(B)
    init = (pid < N) & (rng.random(B) < 0.35)
    son = np.where(rng.random(N) < 0.8, rng.integers(0, S, N),
                   -1).astype(np.int32)
    tgt_rows = np.unique(son[(pid[init] + o_t) % N])
    tgt_rows = tgt_rows[tgt_rows >= 0]
    rearm = np.zeros(S, bool)
    if which == "all":
        rearm[:] = True
    elif which == "some":
        rearm[rng.permutation(tgt_rows)[:max(1, len(tgt_rows) // 3)]] = True
    heard = rng.integers(0, 256, (S, N)).astype(np.uint8)

    def shard(a):
        buf = torch.zeros(a.size + off, dtype=torch.uint8)
        h = buf[off:].view(a.shape)
        h.copy_(torch.from_numpy(a))
        return h

    shards = tuple(shard(heard[:, i * L:(i + 1) * L].copy())
                   for i in range(ndev))
    sp = probe.scratch(p, "cpu")
    probe._views(cfg, sp)[2].copy_(torch.from_numpy(init.astype(np.uint8)))
    i32 = dict(dtype=torch.int32)
    t = probe.Tick(
        shards if ndev > 1 else shards[0], ra,
        torch.full((N,), 10**6, **i32), torch.from_numpy(son), None,
        tuple(torch.zeros(S, **i32) for _ in range(6)), torch.zeros(N, **i32),
        torch.zeros((), **i32), sp)
    rows = (pid[init] + o_t) % N
    marked = son[rows]
    in_rearmed = int(rearm[marked[marked >= 0]].sum())
    return cfg, t, torch.from_numpy(rearm), in_rearmed, int(
        (marked >= 0).sum()) - in_rearmed


def _tick_clone(t):
    heard = (tuple(h.clone() for h in t.heard)
             if isinstance(t.heard, tuple) else t.heard.clone())
    return t._replace(heard=heard, sp=t.sp.clone())


@pytest.mark.parametrize("name", sorted(REARM_CASES))
def test_rearm_marks_match_plain(on_host, name):
    """The merged wipe and marks against the plain wipe then marks, byte
    for byte in every shard, on every grid in both block orders; the case
    holds what its name says."""
    which = REARM_CASES[name][-1]
    for seed in range(3):
        cfg, t0, rearm, in_rearmed, elsewhere = _rearm_tick(name, seed)
        assert elsewhere > 0 or which == "all", (name, seed)
        assert (in_rearmed > 0) == (which != "none"), (name, seed)
        want = _tick_clone(t0)
        finish.wipe_rows_ref(want.heard, rearm)
        probe.probe_marks_ref(cfg, want.ra, want.heard, want.slot_of_node,
                              want.sp)
        for grid in GRIDS:
            for reverse in (False, True):
                got = _tick_clone(t0)
                on_host.probe_host_blocks(grid)
                on_host.probe_host_reverse(int(reverse))
                n0 = probe.rearm_marks_launches
                try:
                    probe.probe_rearm_marks(cfg, got, rearm)
                finally:
                    on_host.probe_host_reverse(0)
                    on_host.probe_host_blocks(1)
                assert probe.rearm_marks_launches == n0 + 1
                _same(got, want, f"{name} seed {seed} grid {grid} "
                                 f"reverse {reverse}")
