"""The finish step's Hopper kernels on the CPU: ``csrc/finish.cu``
(``fire_timers`` and ``wipe_rows``) compiled by the host's C++ compiler
against a small stand-in for the CUDA runtime in which a launch runs its
blocks one after another (or last-first) and each block as ``blockDim.x``
host threads at once: a warp's ballot meets at a barrier of its 32
threads, ``__syncthreads`` at a barrier of the block, and the atomics are
the compiler's ``__atomic`` builtins.

This checks the kernels' own logic before any card does: rows at every
phase mod 16 (L % 16 in 0, 2, 4, 8 and 15, odd N, N shorter than a unit,
shards and ``rx_ok`` at any byte offset), so head, body and tail units
and every realignment of rx; 1, 2 and 8 column shards, the sharded main
path's 8 x 125,000 and a multi-DC pool's 8 x 31,250 among them; every
confirmation count against every bit of the row's timer mask,
``ok_mask`` 0 on every row, on one, on all and mixed, R up to 2,048;
``rx_ok`` holes; the refutation's byte on a listed and an unlisted row and
on both sides of a shard boundary; ``fired`` set from one shard only; the
last block's copy and the scratch left zero over repeated launches on
one buffer set; the same results from one block, a few and the whole
grid; and the wipe of no row, every row and the last row.  Most cases
run the source with a small block and grid (32 host threads, at most 6
blocks, so small shapes cross spans and blocks stride over items), a
few at the card's (256 threads, at most 528 blocks).  Each launch is
held byte for byte against the plain versions
(``finish.fire_timers_ref``, ``finish.wipe_rows_ref``).  Needs ``g++``;
builds into the test's temporary directory.
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
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <memory>
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
struct alignas(16) uint4 {  // 16-byte aligned, as CUDA's
  uint32_t x, y, z, w;
};
static inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c,
                               uint32_t d) {
  return uint4{a, b, c, d};
}
static thread_local dim3 threadIdx, blockIdx, gridDim;
template <class T> static inline T __ldg(const T* p) { return *p; }
template <class T> static inline T __ldcg(const T* p) {
  return __atomic_load_n(p, __ATOMIC_SEQ_CST);
}
static inline uint4 __ldg(const uint4* p) { return *p; }
static inline int __popc(unsigned x) { return __builtin_popcount(x); }
// A barrier of n host threads; a waiting thread yields its core to those
// still on their way.
struct HostBarrier {
  std::atomic<unsigned> arrived{0}, generation{0};
  unsigned n = 32;
  void sync() {
    const unsigned gen = generation.load(std::memory_order_acquire);
    if (arrived.fetch_add(1, std::memory_order_acq_rel) + 1 == n) {
      arrived.store(0, std::memory_order_relaxed);
      generation.fetch_add(1, std::memory_order_acq_rel);
    } else {
      while (generation.load(std::memory_order_acquire) == gen) {
        std::this_thread::yield();
      }
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
// last in grid order arrives last; `host_grid`, where nonzero, replaces
// the launcher's grid (the kernels read theirs from gridDim).
static int host_reverse = 0;
static unsigned host_grid = 0;
template <class K, class... A>
static void host_launch(K kernel, dim3 grid, dim3 block, const A&... args) {
  if (block.x % 32 != 0) std::abort();
  if (host_grid != 0) grid.x = host_grid;
  HostBarrier bar;
  bar.n = block.x;
  host_block = &bar;
  std::unique_ptr<HostWarp[]> warps(new HostWarp[block.x / 32]);
  std::vector<std::thread> threads;
  const unsigned blocks = grid.x;
  for (unsigned t = 0; t < block.x; ++t)
    threads.emplace_back([=, &warps, &args...] {
      threadIdx = dim3(t);
      gridDim = grid;
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
extern "C" void finish_host_grid(unsigned blocks) { host_grid = blocks; }
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
static inline cudaError_t cudaGetLastError() { return cudaSuccess; }
static inline const char* cudaGetErrorString(cudaError_t) { return "error"; }
"""

# Text of the source -> its host form: the launches as host_launch.
HOST_FORMS = {
    f"{k}<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);":
    f"host_launch({k}, dim3(blocks), dim3(kThreads), a);"
    for k in ("fire_kernel", "wipe_kernel", "fire_wide_kernel",
              "wipe_wide_kernel")
}
# The card's block and grid, and the small ones most cases run with on
# the host (a block is that many host threads, the blocks run one after
# another): the same code over 1,024-column spans (a block of one warp,
# two units a thread) and at most 6 blocks, so that small shapes cross
# spans and blocks stride over items.
BLOCK_TEXT = "constexpr int kThreads = 256;"
GRID_TEXT = "constexpr int kMaxBlocks = 132 * kBlocksPerSM;"
CARD, SMALL = (256, 528), (32, 6)


def _host_lib(d, threads, blocks):
    (d / "cuda_runtime.h").write_text(CUDA_STUB)
    body = (_build.CSRC / "finish.cu").read_text()
    forms = dict(HOST_FORMS)
    forms[BLOCK_TEXT] = f"constexpr int kThreads = {threads};"
    forms[GRID_TEXT] = f"constexpr int kMaxBlocks = {blocks};"
    for text, host in forms.items():
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
    lib.finish_host_grid.argtypes = [ctypes.c_uint]
    return lib


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """The kernels at the small block and grid."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernels for the host")
    return _host_lib(tmp_path_factory.mktemp("finish_on_host"), *SMALL)


@pytest.fixture(scope="module")
def lib_card(tmp_path_factory):
    """The kernels at the card's block and grid, as the source has them."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernels for the host")
    return _host_lib(tmp_path_factory.mktemp("finish_on_card_grid"), *CARD)


def _split(x, ndev, offsets=None):
    """The ``ndev`` column shards of ``x``, new tensors; with ``offsets``,
    each an [R, L] view that starts that many bytes into a buffer of its
    own (so its rows sit at other phases mod 16)."""
    L = x.shape[1] // ndev
    if offsets is None:
        return tuple(x[:, i * L:(i + 1) * L].clone() for i in range(ndev))
    out = []
    for i in range(ndev):
        o = offsets[i % len(offsets)]
        buf = torch.full((x.shape[0] * L + o + 16,), 0xA5, dtype=torch.uint8)
        view = buf[o:o + x.shape[0] * L].view(x.shape[0], L)
        view.copy_(x[:, i * L:(i + 1) * L])
        out.append(view)
    return tuple(out)


def _shifted(v, o):
    """``v`` (1-D) as a view ``o`` bytes into a buffer of its own."""
    buf = torch.zeros(v.numel() + o + 16, dtype=v.dtype)
    out = buf[o:o + v.numel()]
    out.copy_(v)
    return out


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


def _check_fire(lib, heard, rx, ok, refute=None, ndev=1, offsets=None,
                **kw):
    """The kernel on the shards of ``heard`` (at ``offsets``, as
    ``_split`` places them) against the plain version on the shards and
    on the whole matrix: every byte and ``fired``."""
    got = _split(heard, ndev, offsets)
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


# (R, N, ndev): N % 16 == 0, N % 16 == 4, odd N (N % 4 == 2), N shorter
# than a unit, more units than a span (a block walks several), 2 and 8
# shards with L % 16 == 2, 8 shards with L % 16 == 8 (1M's shape), the hot
# tier's 8 rows.
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


def _check_wipe(lib, heard, flags, ndev, offsets=None):
    got = _split(heard, ndev, offsets)
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


# Shard widths by L % 16 (0, 2, 4, 8, 15), each over more than one span of
# the small block (64 units).
PHASE_WIDTHS = {0: 2096, 2: 2114, 4: 2068, 8: 2168, 15: 2079}
# Byte offsets of the shards' buffers and of rx: aligned, and off by odd
# and even amounts.
OFFSETS = (0, 3, 8, 13, 6, 1, 15, 10)


@pytest.mark.parametrize("ndev", [1, 2, 8])
@pytest.mark.parametrize("rem", sorted(PHASE_WIDTHS))
def test_every_row_phase(lib, rem, ndev):
    """Rows at every phase mod 16 (L % 16 moves each row's, the offsets
    each shard's), rx at another: the fire with and without the
    refutation and with one row live, and the wipe, byte for byte."""
    L = PHASE_WIDTHS[rem]
    assert L % 16 == rem
    R = 7
    heard, rx, ok, refute = _inputs(R, ndev * L, seed=100 * rem + ndev,
                                    live=0.7)
    for offs, rx_off in ((None, 0), (OFFSETS, 5), (OFFSETS[3:], 12)):
        x = _shifted(rx, rx_off)
        out, fired = _check_fire(lib, heard, x, ok, refute, ndev, offs)
        assert int(fired.sum()) > 0 and (out != heard).any()
        one = torch.zeros_like(ok)
        one[3] = 15
        _check_fire(lib, heard, x, one, None, ndev, offs, reverse=True)
        flags = ok != 0
        _check_wipe(lib, heard | 1, flags, ndev, offs)


@pytest.mark.parametrize("L", [31_250, 125_000])
def test_main_path_shard_widths(lib, L):
    """8 shards of 125,000 (the sharded 1M round, L % 16 == 8) and of
    31,250 (a multi-DC pool's, L % 16 == 2) at a few rows, offsets
    included: every row live, two rows live, the wipe."""
    R, ndev = 3, 8
    heard, rx, ok, refute = _inputs(R, ndev * L, seed=L, live=1.0)
    _check_fire(lib, heard, rx, ok, refute, ndev)
    two = ok.clone()
    two[1] = 0
    _check_fire(lib, heard, _shifted(rx, 9), two, refute, ndev, OFFSETS)
    _check_wipe(lib, heard | 1, two != 0, ndev, OFFSETS)


@pytest.mark.parametrize("live", ["none", "one", "all", "all_2048",
                                  "mixed_2048"])
def test_live_row_counts(lib, live):
    """No row, one row (the last), every row, and R = 2,048 (the most a
    launch takes) with every row and about half the rows live."""
    R = 2048 if live.endswith("2048") else 9
    ndev, L = 2, 45
    heard, rx, ok, refute = _inputs(R, ndev * L, seed=R + len(live),
                                    live=0.5)
    if live == "none":
        ok = torch.zeros_like(ok)
    elif live == "one":
        ok = torch.zeros_like(ok)
        ok[-1] = 9
    elif live.startswith("all"):
        ok = torch.where(ok == 0, 1, ok).to(torch.uint8)
    out, fired = _check_fire(lib, heard, rx, ok, refute, ndev, OFFSETS)
    assert bool(fired.any()) == (live != "none")
    flags = ok != 0
    _check_wipe(lib, heard | 1, flags, ndev, OFFSETS)


@pytest.mark.parametrize("R", [1024, 1025, 2048, 3001, 4097])
@pytest.mark.parametrize("live", ["none", "mixed", "late"])
def test_rows_past_one_listing(lib, R, live):
    """Past 2,048 rows (the slots the reference provisions itself) the
    wide kernels list, fire and wipe the rows 2,048 at a time: no row
    live, about half, and only rows past the first listing (so blocks
    that had items in no chunk still arrive); the refutation on listed
    and unlisted rows of every chunk; on two blocks, last-first; byte
    for byte against the plain versions, the scratch left zero.  R from
    1,024 (one listing) to 4,097 (three, the last of one row)."""
    ndev, L = 2, 45
    heard, rx, ok, refute = _inputs(R, ndev * L, seed=R + len(live),
                                    live=0.5)
    if live == "none":
        ok = torch.zeros_like(ok)
    elif live == "late":
        ok[:min(R - 64, finish.BLOCK_ROWS)] = 0
        ok[-64:] = 15
    lib.finish_host_grid(2)
    try:
        out, fired = _check_fire(lib, heard, rx, ok, refute, ndev, OFFSETS,
                                 reverse=True)
        _check_wipe(lib, heard | 1, ok != 0, ndev, OFFSETS)
    finally:
        lib.finish_host_grid(0)
    assert bool(fired.any()) == (live != "none")
    # Refutations landed in the last rows too, listed or not.
    assert torch.equal(out[-50:][ok[-50:] == 0],
                       _refuted(heard, refute)[-50:][ok[-50:] == 0])


@pytest.mark.parametrize("blocks", [1, 2, 5, 0])
def test_any_block_count(lib, blocks):
    """The same inputs on one block, two, five and the launcher's grid:
    every result byte-identical to the plain version (and so to each
    other), the scratch left zero, whichever block arrives last."""
    heard, rx, ok, refute = _inputs(6, 4 * 530, seed=11, live=0.6)
    lib.finish_host_grid(blocks)
    try:
        for rev in (False, True):
            _check_fire(lib, heard, rx, ok, refute, 4, OFFSETS, reverse=rev)
        _check_wipe(lib, heard | 1, ok != 0, 4, OFFSETS)
    finally:
        lib.finish_host_grid(0)


def test_repeated_launches_on_one_buffer_set(lib):
    """One set of shards, rx, scratch and ``fired`` through a sequence of
    fires (different live rows, one with none) and wipes in place, as the
    round runs them: after each launch every byte equals the plain
    version's run of the same sequence, ``fired`` is written whole and
    the scratch is zero."""
    R, ndev, L = 8, 3, 300
    heard, rx, _, refute = _inputs(R, ndev * L, seed=5)
    got = _split(heard, ndev, OFFSETS)
    want = _split(heard, ndev)
    scratch = torch.zeros(finish.scratch_words(R), dtype=torch.int32)
    fired = torch.full((R,), 7, dtype=torch.uint8)
    table = finish._array(ndev)(*(h.data_ptr() for h in got))
    rng = np.random.default_rng(6)
    for step in range(8):
        ok = torch.from_numpy(np.where(rng.random(R) < 0.4,
                                       rng.integers(1, 16, R), 0)
                              .astype(np.uint8))
        if step == 3:
            ok.zero_()
        ref = refute if step % 2 else None
        col, rb = (None, None) if ref is None else (ref[0].data_ptr(),
                                                    ref[1].data_ptr())
        assert lib.fire_timers(table, ndev, rx.data_ptr(), ok.data_ptr(),
                               col, rb, fired.data_ptr(), scratch.data_ptr(),
                               R, L, None) == 0
        want_fired = finish.fire_timers_ref(want, rx, ok, ref)
        assert torch.equal(fired.bool(), want_fired), step
        assert set(fired.unique().tolist()) <= {0, 1}
        assert int(scratch.abs().sum()) == 0
        flags = torch.from_numpy(rng.random(R) < 0.25)
        assert lib.wipe_rows(table, ndev, flags.data_ptr(), R, L, None) == 0
        finish.wipe_rows_ref(want, flags)
        for a, b in zip(got, want):
            assert torch.equal(a, b), step


@pytest.mark.parametrize("R, L, ndev", [(3, 16_400, 1), (2, 16_395, 2)])
def test_card_block_and_grid(lib_card, R, L, ndev):
    """The source's own block (256 threads, spans of 8,192 columns) and
    grid: shard rows over two spans at odd phases, the fire with the
    refutation and the wipe."""
    heard, rx, ok, refute = _inputs(R, ndev * L, seed=L, live=1.0)
    out, fired = _check_fire(lib_card, heard, _shifted(rx, 3), ok, refute,
                             ndev, OFFSETS[1:])
    assert int(fired.sum()) > 0
    _check_wipe(lib_card, heard | 1, ok != 0, ndev, OFFSETS[1:])
