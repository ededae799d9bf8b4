"""The finish step's Hopper kernels on the CPU: ``csrc/finish.cu``
(``fire_timers`` and ``wipe_rows``) compiled by the host's C++ compiler
against a small stand-in for the CUDA runtime in which a launch runs its
blocks one after another (or last-first) and each block as ``blockDim.x``
host threads at once: a warp's ballot meets at a barrier of its 32
threads, ``__syncthreads`` at a barrier of the block, and the atomics are
the compiler's ``__atomic`` builtins.

This checks the kernels' own logic before any card does: the 16-byte,
4-byte and byte paths (N % 16, N % 4 and odd N), N shorter than a unit,
2 and 8 column shards with L % 16 == 2, every confirmation count against
every bit of the row's timer mask, ``ok_mask`` 0 on every row and mixed,
``rx_ok`` holes, the refutation's byte on a listed and an unlisted row and
on both sides of a shard boundary, ``fired`` set from one shard only, the
last block's copy and the scratch left zero; and the wipe of no row,
every row and the last row.  Each launch is held byte for byte against
the plain versions (``finish.fire_timers_ref``, ``finish.wipe_rows_ref``).
Needs ``g++``; builds into the test's temporary directory.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from consul_tpu_torch import _build
from consul_tpu_torch.gossip import finish

# What the kernels use of the CUDA runtime and device built-ins, on the
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
static inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c,
                               uint32_t d) {
  return uint4{a, b, c, d};
}
static thread_local dim3 threadIdx, blockIdx;
template <class T> static inline T __ldg(const T* p) { return *p; }
template <class T> static inline T __ldcg(const T* p) {
  return __atomic_load_n(p, __ATOMIC_SEQ_CST);
}
static inline uint4 __ldg(const uint4* p) { return *p; }
static inline int __popc(unsigned x) { return __builtin_popcount(x); }
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
static inline unsigned __ballot_sync(unsigned, int pred) {
  host_warp->slot[threadIdx.x & 31u] = pred ? 1u : 0u;
  host_warp->bar.sync();
  unsigned m = 0;
  for (unsigned i = 0; i < 32; ++i) m |= host_warp->slot[i] << i;
  host_warp->bar.sync();
  return m;
}
static inline void __syncthreads() { host_block->sync(); }
template <class T> static inline T atomicOr(T* p, T v) {
  return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST);
}
// A launch: blocks one after another, each block's threads at once;
// `host_reverse` runs them last-first, so that another block than the
// last in grid order arrives last.
static int host_reverse = 0;
template <class K, class... A>
static void host_launch(K kernel, dim3 grid, dim3 block, const A&... args) {
  if (block.x % 32 != 0) std::abort();
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
extern "C" void finish_host_reverse(int on) { host_reverse = on; }
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
static inline cudaError_t cudaGetLastError() { return cudaSuccess; }
static inline const char* cudaGetErrorString(cudaError_t) { return "error"; }
"""

# Text of the source -> its host form: the launches as host_launch.
HOST_FORMS = {
    f"{k}<<<a.blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(\n"
    f"      a);": f"host_launch({k}, dim3(a.blocks), dim3(kThreads), a);"
    for k in ("fire_kernel", "wipe_kernel")
}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernels for the host")
    d = tmp_path_factory.mktemp("finish_on_host")
    (d / "cuda_runtime.h").write_text(CUDA_STUB)
    body = (_build.CSRC / "finish.cu").read_text()
    for text, host in HOST_FORMS.items():
        assert body.count(text) == 1, text
        body = body.replace(text, host)
    src = d / "finish.cpp"
    src.write_text(body)
    so = d / "libfinish.so"
    r = subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC",
                        "-pthread", f"-I{_build.CSRC}", f"-I{d}", "-o",
                        str(so), str(src)],
                       capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr
    lib = ctypes.CDLL(str(so))
    lib.fire_timers.argtypes = finish._FIRE_ARGTYPES
    lib.fire_timers.restype = ctypes.c_int
    lib.wipe_rows.argtypes = finish._WIPE_ARGTYPES
    lib.wipe_rows.restype = ctypes.c_int
    lib.fire_timers_scratch_words.argtypes = [ctypes.c_int]
    lib.fire_timers_scratch_words.restype = ctypes.c_longlong
    lib.finish_host_reverse.argtypes = [ctypes.c_int]
    return lib


def _split(x, ndev):
    L = x.shape[1] // ndev
    return tuple(x[:, i * L:(i + 1) * L].clone() for i in range(ndev))


def _fire_host(lib, shards, rx, ok, refute=None, reverse=False,
               scratch=None):
    """One launch through the C entry point, as the wrapper packs it, on
    the shards in place; ``fired`` starts as garbage (the kernel writes it
    whole) and the scratch must be left zero."""
    R, L = shards[0].shape
    fired = torch.full((R,), 7, dtype=torch.uint8)
    if scratch is None:
        scratch = torch.zeros(finish.scratch_words(R), dtype=torch.int32)
    assert lib.fire_timers_scratch_words(R) <= scratch.numel()
    table = finish._array(len(shards))(*(h.data_ptr() for h in shards))
    col, rb = (None, None) if refute is None else (refute[0].data_ptr(),
                                                   refute[1].data_ptr())
    lib.finish_host_reverse(int(reverse))
    rc = lib.fire_timers(table, len(shards), rx.data_ptr(), ok.data_ptr(),
                         col, rb, fired.data_ptr(), scratch.data_ptr(), R, L,
                         None)
    lib.finish_host_reverse(0)
    assert rc == 0
    assert int(scratch.abs().sum()) == 0, "the scratch was not left zero"
    assert set(fired.unique().tolist()) <= {0, 1}
    return fired.bool()


def _check_fire(lib, heard, rx, ok, refute=None, ndev=1, **kw):
    """The kernel on the shards of ``heard`` against the plain version on
    the shards and on the whole matrix: every byte and ``fired``."""
    got = _split(heard, ndev)
    fired = _fire_host(lib, got, rx, ok, refute, **kw)
    ref = _split(heard, ndev)
    ref_fired = finish.fire_timers_ref(ref, rx, ok, refute)
    whole = heard.clone()
    assert torch.equal(finish.fire_timers_ref(whole, rx, ok, refute),
                       ref_fired)
    assert torch.equal(torch.cat(ref, dim=1), whole)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert torch.equal(a, b), (ndev, i, torch.nonzero(a != b)[:4])
    assert torch.equal(fired, ref_fired), (fired, ref_fired)
    return torch.cat(got, dim=1), fired


def _inputs(R, N, seed, rx_holes=0.2, live=0.5):
    """Bytes of every message, conf and age (a third of them any byte
    value); rx with holes; a timer mask a row, 0 on about half the rows
    but the first;
    a refutation on a few rows, listed and unlisted."""
    rng = np.random.default_rng(seed)
    heard = np.where(rng.random((R, N)) < 0.35,
                     rng.integers(0, 256, (R, N)),
                     rng.integers(0, 4, (R, N)) << 6
                     | rng.integers(0, 4, (R, N)) << 4
                     | rng.integers(0, 16, (R, N))).astype(np.uint8)
    rx = rng.random(N) >= rx_holes
    ok = np.where(rng.random(R) < live, rng.integers(1, 16, R), 0)
    ok[0] = 15  # a live row in every shape
    col = rng.integers(0, N, R).astype(np.int32)
    rb = np.where(rng.random(R) < 0.4, 0xC0, 0).astype(np.uint8)
    return (torch.from_numpy(heard), torch.from_numpy(rx),
            torch.from_numpy(ok.astype(np.uint8)),
            (torch.from_numpy(col), torch.from_numpy(rb)))


# (R, N, ndev): the 16-byte path (N % 16 == 0), the 4-byte path (N % 16
# == 4), the byte path (odd N, N % 4 == 2), N shorter than a unit, more
# units than a block has threads (a thread strides), 2 and 8 shards with
# L % 16 == 2 (the byte path across shards), 8 shards with L % 16 == 8
# (1M's shape), the hot tier's 8 rows.
SHAPES = [(8, 4096, 1), (5, 1028, 1), (7, 1001, 1), (4, 1030, 1),
          (3, 5, 1), (9, 12, 1), (2, 16 * 256 * 3 + 16, 1), (6, 2 * 146, 2),
          (5, 8 * 18, 8), (4, 8 * 24, 8), (8, 4096 + 8, 2)]


@pytest.mark.parametrize("R, N, ndev", SHAPES)
def test_fire_matches_plain(lib, R, N, ndev):
    heard, rx, ok, refute = _inputs(R, N, seed=R * 100 + N)
    out, fired = _check_fire(lib, heard, rx, ok, refute, ndev)
    _check_fire(lib, heard, rx, ok, None, ndev, reverse=True)
    # Not vacuous: bytes fired, refutations landed, unlisted rows unread.
    assert int(fired.sum()) > 0
    assert (out != heard).any()
    assert torch.equal(out[ok == 0][:, :], _refuted(heard, refute)[ok == 0])


def _refuted(heard, refute):
    h = heard.clone()
    rows = torch.arange(h.shape[0])
    col, rb = refute
    h[rows, col.long()] = torch.maximum(h[rows, col.long()], rb)
    return h


@pytest.mark.parametrize("ndev", [1, 2, 8])
def test_every_conf_against_every_timer_bit(lib, ndev):
    """A row for each timer mask 0 .. 15, each holding every (message,
    conf, age) byte, with the columns' rx on and off: a byte fires exactly
    where it is SUSPECT, its column takes messages and its conf's bit is
    set."""
    cells = np.asarray([(m << 6) | (c << 4) | a for m in range(4)
                        for c in range(4) for a in range(16)], np.uint8)
    row = np.concatenate([cells, cells])            # rx on, then off
    N = len(row) * ndev                             # 512 a shard
    heard = torch.from_numpy(np.tile(np.tile(row, ndev), (16, 1)))
    rx = torch.from_numpy(np.tile(np.repeat([True, False], len(cells)),
                                  ndev))
    ok = torch.arange(16, dtype=torch.uint8)
    out, fired = _check_fire(lib, heard, rx, ok, None, ndev)
    conf = (heard >> 4) & 3
    want = (((heard >> 6) == 1) & rx[None, :]
            & (((ok[:, None] >> conf) & 1) == 1))
    assert torch.equal(out, torch.where(want, torch.tensor(0x80, dtype=torch.uint8),
                                        heard))
    assert fired.tolist() == [False] + [True] * 15
    assert N == heard.shape[1]


def test_no_row_live_reads_nothing(lib):
    """ok 0 on every row: no byte changes but the unlisted rows'
    refutation bytes, and no row fires."""
    heard, rx, _, refute = _inputs(6, 1040, seed=3)
    ok = torch.zeros(6, dtype=torch.uint8)
    out, fired = _check_fire(lib, heard, rx, ok, refute, 1)
    assert not fired.any()
    assert torch.equal(out, _refuted(heard, refute))
    out, fired = _check_fire(lib, heard, rx, ok, None, 2)
    assert not fired.any() and torch.equal(out, heard)


@pytest.mark.parametrize("ndev", [2, 8])
def test_refutation_on_the_shard_boundary(lib, ndev):
    """The refutation's column at the last column of a shard and the first
    of the next, on listed and unlisted rows: the max lands on the owning
    shard alone, before the fire test."""
    L = 146
    N = ndev * L
    R = 6
    heard = torch.full((R, N), (1 << 6) | (2 << 4), dtype=torch.uint8)
    rx = torch.ones(N, dtype=torch.bool)
    ok = torch.tensor([0b0100, 0, 0b0100, 0, 0b0100, 0], dtype=torch.uint8)
    col = torch.tensor([L - 1, L, L, L - 1, N - 1, 0], dtype=torch.int32)
    rb = torch.full((R,), 0xC0, dtype=torch.uint8)
    out, fired = _check_fire(lib, heard, rx, ok, (col, rb), ndev)
    rows = torch.arange(R)
    assert (out[rows, col.long()] == 0xC0).all()
    assert fired.tolist() == [True, False, True, False, True, False]
    # A refuted byte does not fire; its neighbours do.
    assert int((out[0] == 0x80).sum()) == N - 1


def test_fired_from_one_shard(lib):
    """Only shard 5 of 8 holds a SUSPECT byte that fires: the row's fired
    is the OR across shards; the row whose fire is held back by rx is
    not."""
    ndev, L, R = 8, 18, 3
    N = ndev * L
    heard = torch.zeros((R, N), dtype=torch.uint8)
    heard[0, 5 * L + 17] = 1 << 6
    heard[1, 2 * L] = 1 << 6
    heard[2, 7 * L + 3] = 2 << 6
    rx = torch.ones(N, dtype=torch.bool)
    rx[2 * L] = False
    ok = torch.full((R,), 1, dtype=torch.uint8)
    out, fired = _check_fire(lib, heard, rx, ok, None, ndev)
    assert fired.tolist() == [True, False, False]
    assert int(out[0, 5 * L + 17]) == 0x80


def test_scratch_serves_many_launches(lib):
    """One scratch (an observers' scratch of more rows serves) through
    launches of different inputs and row counts, left zero by each."""
    scratch = torch.zeros(4 * 8 + 1, dtype=torch.int32)
    for seed, R in enumerate((3, 8, 1, 8, 5)):
        heard, rx, ok, refute = _inputs(R, 1040, seed)
        _check_fire(lib, heard, rx, ok, refute, 1, scratch=scratch,
                    reverse=bool(seed % 2))


def _check_wipe(lib, heard, flags, ndev):
    got = _split(heard, ndev)
    table = finish._array(ndev)(*(h.data_ptr() for h in got))
    R, L = got[0].shape
    assert lib.wipe_rows(table, ndev, flags.data_ptr(), R, L, None) == 0
    ref = _split(heard, ndev)
    finish.wipe_rows_ref(ref, flags)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    out = torch.cat(got, dim=1)
    assert not out[flags].any() and torch.equal(out[~flags], heard[~flags])
    return out


@pytest.mark.parametrize("R, N, ndev", SHAPES)
def test_wipe_matches_plain(lib, R, N, ndev):
    """No row, every row, the last row and a mix flagged."""
    heard = _inputs(R, N, seed=R + N)[0] | 1  # no zero row to begin with
    rng = np.random.default_rng(N)
    last = torch.zeros(R, dtype=torch.bool)
    last[-1] = True
    for flags in (torch.zeros(R, dtype=torch.bool),
                  torch.ones(R, dtype=torch.bool), last,
                  torch.from_numpy(rng.random(R) < 0.5)):
        _check_wipe(lib, heard, flags, ndev)


def test_kernels_refuse_what_they_do_not_take(lib):
    heard, rx, ok, (col, rb) = _inputs(4, 64, 0)
    fired = torch.empty(4, dtype=torch.uint8)
    scratch = torch.zeros(finish.scratch_words(4), dtype=torch.int32)
    table = finish._array(1)(heard.data_ptr())
    okargs = dict(ndev=1, rx=rx.data_ptr(), ok=ok.data_ptr(), col=None,
                  rb=None, fired=fired.data_ptr(), scratch=scratch.data_ptr(),
                  R=4, L=64)
    bad = [dict(ndev=0), dict(ndev=65), dict(rx=None), dict(ok=None),
           dict(fired=None), dict(scratch=None),
           dict(scratch=scratch.data_ptr() + 2), dict(col=col.data_ptr()),
           dict(rb=rb.data_ptr()), dict(R=0), dict(R=finish.MAX_ROWS + 1),
           dict(L=0), dict(ndev=64, L=2**31 // 64)]
    for change in bad:
        a = dict(okargs, **change)
        rc = lib.fire_timers(table, a["ndev"], a["rx"], a["ok"], a["col"],
                             a["rb"], a["fired"], a["scratch"], a["R"],
                             a["L"], None)
        assert rc != 0, change
    a = okargs
    assert lib.fire_timers(table, 1, a["rx"], a["ok"], col.data_ptr(),
                           rb.data_ptr(), a["fired"], a["scratch"], 4, 64,
                           None) == 0
    for R, L, flags in ((0, 64, ok), (4, 0, ok), (finish.MAX_ROWS + 1, 64, ok),
                        (4, 64, None)):
        assert lib.wipe_rows(table, 1, None if flags is None
                             else flags.data_ptr(), R, L, None) != 0
    assert lib.wipe_rows(table, 1, ok.data_ptr(), 4, 64, None) == 0
