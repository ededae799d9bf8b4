"""The observers' Hopper kernel on the CPU: ``csrc/observe.cu`` compiled
by the host's C++ compiler against a small stand-in for the CUDA runtime
in which a launch runs its blocks one after another and each block as
``blockDim.x`` host threads at once: the warp sum (``__reduce_add_sync``)
meets at a barrier of the warp's 32 threads, ``__syncthreads`` at a
barrier of the block, and ``atomicAdd`` is the compiler's ``__atomic``
builtin.

This checks the kernel's own logic before any card does: the 16-byte,
4-byte and byte paths (N % 16, N % 4 and odd N), N shorter than a unit,
2 and 8 column shards with L % 16 == 2, every byte value, rows all zero
and all DEAD, member holes, ages at ``budget - 1`` and ``budget``,
``want`` all false and mixed, verdicts inside and outside 0..3, the last
block's copy and the scratch left zero.  Each launch is held int for int
against the plain version (``observe.heard_counts_ref``).  Needs
``g++``; builds into the test's temporary directory.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from consul_tpu_torch import _build
from consul_tpu_torch.gossip import observe

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
static thread_local dim3 threadIdx, blockIdx;
template <class T> static inline T __ldg(const T* p) { return *p; }
template <class T> static inline T __ldcg(const T* p) {
  return __atomic_load_n(p, __ATOMIC_SEQ_CST);
}
static inline uint4 __ldg(const uint4* p) { return *p; }
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
// A launch: blocks one after another (x fastest), each block's threads
// at once; `host_reverse` runs them last-first, so that another block
// than the last in grid order arrives last.
static int host_reverse = 0;
template <class K, class... A>
static void host_launch(K kernel, dim3 grid, dim3 block, const A&... args) {
  if (block.x % 32 != 0) std::abort();
  HostBarrier bar;
  bar.n = block.x;
  host_block = &bar;
  std::unique_ptr<HostWarp[]> warps(new HostWarp[block.x / 32]);
  std::vector<std::thread> threads;
  const unsigned blocks = grid.x * grid.y;
  for (unsigned t = 0; t < block.x; ++t)
    threads.emplace_back([=, &warps, &args...] {
      threadIdx = dim3(t);
      host_warp = &warps[t / 32];
      for (unsigned k = 0; k < blocks; ++k) {
        const unsigned b = host_reverse ? blocks - 1 - k : k;
        blockIdx = dim3(b % grid.x, b / grid.x);
        kernel(args...);
        host_block->sync();
      }
    });
  for (auto& th : threads) th.join();
}
extern "C" void observe_host_reverse(int on) { host_reverse = on; }
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
static inline cudaError_t cudaGetLastError() { return cudaSuccess; }
static inline const char* cudaGetErrorString(cudaError_t) { return "error"; }
"""

# Text of the source -> its host form: the launch as host_launch.
HOST_FORMS = {
    f"counts_kernel<{w}><<<grid, kThreads, 0, s>>>(a);":
        f"host_launch(counts_kernel<{w}>, grid, dim3(kThreads), a);"
    for w in ("true", "false")
}


@pytest.fixture(scope="module")
def counts_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel for the host")
    d = tmp_path_factory.mktemp("observe_on_host")
    (d / "cuda_runtime.h").write_text(CUDA_STUB)
    body = (_build.CSRC / "observe.cu").read_text()
    for text, host in HOST_FORMS.items():
        assert body.count(text) == 1, text
        body = body.replace(text, host)
    src = d / "observe.cpp"
    src.write_text(body)
    so = d / "libobserve.so"
    r = subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC",
                        "-pthread", f"-I{_build.CSRC}", f"-I{d}", "-o",
                        str(so), str(src)],
                       capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr
    lib = ctypes.CDLL(str(so))
    fn = lib.heard_counts
    fn.argtypes, fn.restype = observe._ARGTYPES, ctypes.c_int
    lib.heard_counts_scratch_words.argtypes = [ctypes.c_int]
    lib.heard_counts_scratch_words.restype = ctypes.c_longlong
    lib.observe_host_reverse.argtypes = [ctypes.c_int]
    fn.lib = lib
    return fn


def _run(fn, shards, member, budget, verdict=None, want=None,
         reverse=False, scratch=None):
    """One launch through the C entry point, as the wrapper packs it, into
    a new output filled with garbage (the kernel writes it whole); the
    scratch must be left zero."""
    R, L = shards[0].shape
    out = torch.full((len(observe.COUNTS), R), -7, dtype=torch.int32)
    if scratch is None:
        scratch = torch.zeros(observe.scratch_words(R), dtype=torch.int32)
    assert fn.lib.heard_counts_scratch_words(R) <= scratch.numel()
    table = observe._array(len(shards))(*(h.data_ptr() for h in shards))
    fn.lib.observe_host_reverse(int(reverse))
    rc = fn(table, len(shards), member.data_ptr(),
            None if verdict is None else verdict.data_ptr(),
            None if want is None else want.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), R, L, budget, None)
    fn.lib.observe_host_reverse(0)
    assert rc == 0
    assert int(scratch.abs().sum()) == 0, "the scratch was not left zero"
    return out


def _inputs(R, N, seed, member_holes=0.3):
    """Every byte value (a third of the bytes); the rest with every
    message and every age; a row of zeros and a row all DEAD; member with
    holes; verdicts DEAD and REFUTE, and 0, 1 and out of range."""
    rng = np.random.default_rng(seed)
    heard = np.where(rng.random((R, N)) < 0.35,
                     rng.integers(0, 256, (R, N)),
                     rng.integers(0, 4, (R, N)) << 6
                     | rng.integers(0, 16, (R, N))).astype(np.uint8)
    if R > 2:
        heard[1] = 0
        heard[2] = (2 << 6) | rng.integers(0, 16, N)
    member = rng.random(N) >= member_holes
    verdict = rng.choice(np.asarray([2, 3, 2, 3, 0, 1, -1, 4, 258],
                                    np.int32), R)
    return (torch.from_numpy(heard), torch.from_numpy(member),
            torch.from_numpy(verdict))


def _split(x, ndev):
    L = x.shape[1] // ndev
    return tuple(x[:, i * L:(i + 1) * L].contiguous() for i in range(ndev))


def _check(fn, heard, member, budget, verdict, want, ndev=1, **kw):
    shards = _split(heard, ndev)
    got = _run(fn, shards, member, budget, verdict, want, **kw)
    ref = observe.heard_counts_ref(shards, member, budget, verdict, want)
    # And the sharded plain version equals the single one.
    assert torch.equal(ref, observe.heard_counts_ref(heard, member, budget,
                                                     verdict, want))
    assert torch.equal(got, ref), (ndev, budget, got - ref)
    return got


# (R, N, ndev): the 16-byte path (N % 16 == 0), the 4-byte path (N % 16
# == 4, 8 and 12), the byte path (odd N, N % 4 == 2), N shorter than a
# unit, rows not a multiple of the row group, more units than a block
# has threads (a thread strides), 2 and 8 shards with L % 16 == 2 (the
# byte path across shards), 8 shards with L % 16 == 8 (1M's shape), the
# hot tier's 8 rows.
SHAPES = [(8, 4096, 1), (5, 1028, 1), (6, 1032, 1), (3, 1036, 1),
          (7, 1001, 1), (4, 1030, 1), (3, 5, 1), (9, 12, 1),
          (2, 16 * 256 * 3 + 16, 1), (6, 2 * 146, 2), (5, 8 * 18, 8),
          (4, 8 * 24, 8), (8, 4096 + 8, 2)]


@pytest.mark.parametrize("R, N, ndev", SHAPES)
def test_counts_match_plain(counts_lib, R, N, ndev):
    heard, member, verdict = _inputs(R, N, seed=R * 100 + N)
    got = {budget: _check(counts_lib, heard, member, budget, verdict, None,
                          ndev)
           for budget in (1, 3, 14, 0, 16, 20, -2)}
    assert int(got[3][observe.DEAD].sum()) > 0
    assert int(got[3][observe.LIVE].sum()) > 0
    assert int(got[3][observe.HOLD].sum()) > 0
    assert int(got[-2][observe.LIVE].sum()) == 0


@pytest.mark.parametrize("R, N, ndev", [(8, 4096, 1), (7, 1001, 1),
                                        (6, 2 * 146, 2), (5, 8 * 18, 8)])
def test_want_masks_rows(counts_lib, R, N, ndev):
    """``want`` all false (nothing read, every count 0), all true and
    mixed, with and without a verdict; a block that is not last in grid
    order arriving last."""
    heard, member, verdict = _inputs(R, N, seed=R + N)
    rng = np.random.default_rng(N)
    wants = [torch.zeros(R, dtype=torch.bool), torch.ones(R, dtype=torch.bool),
             torch.from_numpy(rng.random(R) < 0.5)]
    for k, want in enumerate(wants):
        for v in (verdict, None):
            got = _check(counts_lib, heard, member, 3, v, want, ndev,
                         reverse=bool(k % 2))
            assert not got[:, ~want].any()
    assert not _check(counts_lib, heard, member, 3, verdict, wants[0],
                      ndev).any()


def test_ages_at_the_budget(counts_lib):
    """Each message with every age, against budgets 1 .. 16: an age below
    the budget counts as live, an age at it does not."""
    ages = np.arange(16, dtype=np.uint8)
    row = ((np.arange(4, dtype=np.uint8)[:, None] << 6) | ages).reshape(-1)
    heard = torch.from_numpy(np.tile(row, (4, 3)))  # [4, 192]
    member = torch.ones(heard.shape[1], dtype=torch.bool)
    verdict = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    for budget in range(0, 17):
        got = _check(counts_lib, heard, member, budget, verdict, None)
        assert got[observe.LIVE].tolist() == [3 * 3 * budget] * 4
        assert got[observe.HOLD].tolist() == [3 * 16] * 4


def test_scratch_serves_many_launches(counts_lib):
    """One scratch through launches of different inputs (left zero by
    each), as the round's launches share it."""
    scratch = torch.zeros(observe.scratch_words(6), dtype=torch.int32)
    for seed in range(4):
        heard, member, verdict = _inputs(6, 1040, seed)
        got = _run(counts_lib, (heard,), member, 3, verdict,
                   scratch=scratch)
        assert torch.equal(got, observe.heard_counts_ref(heard, member, 3,
                                                         verdict))


def test_scratch_for_more_rows_serves_fewer(counts_lib):
    """A scratch made for S rows serves launches of fewer rows and of S,
    in any order, left zero by each: the round's one scratch serves its
    hot tier's gathered rows and its final matrix's."""
    scratch = torch.zeros(observe.scratch_words(8), dtype=torch.int32)
    for seed, R in enumerate((3, 8, 1, 8, 5)):
        heard, member, verdict = _inputs(R, 1040, seed)
        want = torch.from_numpy(np.arange(R) % 2 == 0)
        got = _run(counts_lib, (heard,), member, 4, verdict, want,
                   reverse=bool(seed % 2), scratch=scratch)
        assert torch.equal(got, observe.heard_counts_ref(
            heard, member, 4, verdict, want)), R


def test_counts_refuse_what_they_do_not_take(counts_lib):
    heard, member, _ = _inputs(4, 64, 0)
    out = torch.empty((4, 4), dtype=torch.int32)
    scratch = torch.zeros(observe.scratch_words(4), dtype=torch.int32)
    table = observe._array(1)(heard.data_ptr())
    ok = dict(ndev=1, member=member.data_ptr(), out=out.data_ptr(),
              scratch=scratch.data_ptr(), R=4, L=64)
    bad = [dict(ndev=0), dict(ndev=65), dict(member=None), dict(out=None),
           dict(scratch=None), dict(scratch=scratch.data_ptr() + 2),
           dict(R=0), dict(L=0), dict(ndev=64, L=2**31 // 64)]
    for change in bad:
        a = dict(ok, **change)
        rc = counts_lib(table, a["ndev"], a["member"], None, None, a["out"],
                        a["scratch"], a["R"], a["L"], 3, None)
        assert rc != 0, change
    assert counts_lib(table, 1, member.data_ptr(), None, None,
                      out.data_ptr(), scratch.data_ptr(), 4, 64, 3,
                      None) == 0
