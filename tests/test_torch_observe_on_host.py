"""The observers' Hopper kernel on the CPU: ``csrc/observe.cu`` compiled
by the host's C++ compiler against a small stand-in for the CUDA runtime
in which a launch runs its blocks one after another (or last-first) and
each block as ``blockDim.x`` host threads at once: a warp's ballot and
sum (``__ballot_sync``, ``__reduce_add_sync``) meet at a barrier of its
32 threads, ``__syncthreads`` at a barrier of the block, the atomics are
the compiler's ``__atomic`` builtins, and the occupancy query gives the
SMs and blocks an SM that a test sets.

This checks the kernel's own logic before any card does: both forms (the
final matrix's dead, refute and live counts; the spread's holders), rows
at every phase mod 16 (N % 16 of 0, 1, 2, 4, 8 and 12, odd N, N shorter
than a unit, shards and ``member`` at byte offsets), so head, body and
tail units and every realignment of ``member``; 1, 2 and 8 column shards
with L % 16 of 1, 2 and 8; every byte value, rows all zero and all DEAD,
member holes, ages at ``budget - 1`` and ``budget``; ``want`` all false,
all true, mixed, one row and three; verdicts inside and outside 0..3;
grids of one block, a few, and more blocks than items; the last block's
copy, no arrival where no row is read, and the scratch left zero, also
when the fire pass (``csrc/finish.cu``) shares it.  Most cases run the
source with a block of one warp (so small shapes cross spans and blocks
stride over items), a few at the card's 256 threads.  Each launch is held
int for int against the plain version (``observe.heard_counts_ref``).
Needs ``g++``; builds into the test's temporary directory.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from consul_tpu_torch import _build
from consul_tpu_torch.gossip import finish, observe

# What the kernels use of the CUDA runtime and device built-ins, on the
# host: a block is blockDim.x threads, a warp 32 of them.
CUDA_STUB = r"""
#pragma once
#include <algorithm>
#include <atomic>
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
// A barrier of n host threads: a waiting thread yields its core a while,
// then sleeps, so that a busy machine runs those still on their way.
struct HostBarrier {
  std::mutex m;
  std::condition_variable cv;
  std::atomic<unsigned> arrived{0}, generation{0};
  unsigned n = 32;
  void sync() {
    const unsigned gen = generation.load(std::memory_order_acquire);
    if (arrived.fetch_add(1, std::memory_order_acq_rel) + 1 == n) {
      arrived.store(0, std::memory_order_relaxed);
      {
        std::lock_guard<std::mutex> lock(m);
        generation.fetch_add(1, std::memory_order_acq_rel);
      }
      cv.notify_all();
      return;
    }
    for (int i = 0; i < 64; ++i) {
      if (generation.load(std::memory_order_acquire) != gen) return;
      std::this_thread::yield();
    }
    std::unique_lock<std::mutex> lock(m);
    cv.wait(lock, [&] {
      return generation.load(std::memory_order_acquire) != gen;
    });
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
// The grid's arrivals at the counter (add_release), and the device the
// occupancy query describes: host_sms SMs of host_per_sm blocks each.
static std::atomic<int> host_arrivals{0};
static int host_sms = 3, host_per_sm = 2;
extern "C" void host_reverse_blocks(int on) { host_reverse = on; }
extern "C" void host_device(int sms, int per_sm) {
  host_sms = sms;
  host_per_sm = per_sm;
}
extern "C" int host_arrivals_since(int reset) {
  const int n = host_arrivals.load();
  if (reset) host_arrivals.store(0);
  return n;
}
typedef void* cudaStream_t;
enum cudaError_t {
  cudaSuccess = 0, cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9
};
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
static inline cudaError_t cudaGetLastError() { return cudaSuccess; }
static inline const char* cudaGetErrorString(cudaError_t) { return "error"; }
static inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
static inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr,
                                                 int) {
  *v = host_sms;
  return cudaSuccess;
}
template <class K>
static inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* n, K, int, size_t) {
  *n = host_per_sm;
  return cudaSuccess;
}
"""

# Text of the sources -> their host forms: the launches as host_launch,
# and the arrival counted.
ARRIVE = "return __atomic_fetch_add(counter, 1u, __ATOMIC_RELEASE);"
COUNTED = "host_arrivals.fetch_add(1);\n  " + ARRIVE
OBSERVE_FORMS = {
    f"{k}<{w}><<<blocks, kThreads, 0, s>>>(a);":
        f"host_launch({k}<{w}>, dim3(blocks), dim3(kThreads), a);"
    for w in ("true", "false") for k in ("counts_kernel", "counts_wide_kernel")
}
FINISH_FORMS = {
    f"{k}<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);":
    f"host_launch({k}, dim3(blocks), dim3(kThreads), a);"
    for k in ("fire_kernel", "wipe_kernel", "fire_wide_kernel",
              "wipe_wide_kernel")
}
BLOCK_TEXT = "constexpr int kThreads = 256;"
# The card's block, and the small one most cases run with on the host (a
# block is that many host threads, the blocks run one after another): the
# same code over 1,024-column spans.
CARD, SMALL = 256, 32
UNITS = 2  # kUnits: a span is UNITS units of each thread of a block


def _compile(d, name, forms, threads):
    (d / "cuda_runtime.h").write_text(CUDA_STUB)
    body = (_build.CSRC / f"{name}.cu").read_text()
    forms = dict(forms, **{ARRIVE: COUNTED,
                           BLOCK_TEXT: f"constexpr int kThreads = {threads};"})
    for text, host in forms.items():
        assert body.count(text) == 1, text
        body = body.replace(text, host)
    src = d / f"{name}.cpp"
    src.write_text(body)
    so = d / f"lib{name}.so"
    # -fno-gnu-unique: the kernel templates' shared arrays (static locals)
    # stay each library's own when two builds are loaded at once.
    r = subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC",
                        "-fno-gnu-unique", "-pthread", f"-I{_build.CSRC}",
                        f"-I{d}", "-o", str(so), str(src)],
                       capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr
    lib = ctypes.CDLL(str(so))
    lib.host_reverse_blocks.argtypes = [ctypes.c_int]
    lib.host_device.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.host_arrivals_since.argtypes = [ctypes.c_int]
    lib.host_arrivals_since.restype = ctypes.c_int
    return lib


def _observe_lib(d, threads):
    lib = _compile(d, "observe", OBSERVE_FORMS, threads)
    fn = lib.heard_counts
    fn.argtypes, fn.restype = observe._ARGTYPES, ctypes.c_int
    lib.heard_counts_scratch_words.argtypes = [ctypes.c_int]
    lib.heard_counts_scratch_words.restype = ctypes.c_longlong
    lib.heard_counts_blocks.argtypes = [ctypes.c_int] * 4
    lib.heard_counts_blocks.restype = ctypes.c_int
    fn.lib = lib
    return fn


@pytest.fixture(scope="module")
def counts_lib(tmp_path_factory):
    """The kernel with a block of one warp."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel for the host")
    return _observe_lib(tmp_path_factory.mktemp("observe_on_host"), SMALL)


@pytest.fixture(scope="module")
def counts_card(tmp_path_factory):
    """The kernel at the card's block, as the source has it."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel for the host")
    return _observe_lib(tmp_path_factory.mktemp("observe_card_block"), CARD)


def _run(fn, shards, member, budget, verdict=None, want=None,
         reverse=False, scratch=None, device=(3, 2)):
    """One launch through the C entry point, as the wrapper packs it, into
    a new output filled with garbage (the kernel writes it whole), on a
    device of ``device`` = (SMs, blocks an SM); the scratch must be left
    zero.  Returns the counts and the blocks that arrived."""
    R, L = shards[0].shape
    out = torch.full((len(observe.COUNTS), R), -7, dtype=torch.int32)
    if scratch is None:
        scratch = torch.zeros(observe.scratch_words(R), dtype=torch.int32)
    assert fn.lib.heard_counts_scratch_words(R) <= scratch.numel()
    table = observe._array(len(shards))(*(h.data_ptr() for h in shards))
    fn.lib.host_reverse_blocks(int(reverse))
    fn.lib.host_device(*device)
    fn.lib.host_arrivals_since(1)
    rc = fn(table, len(shards), member.data_ptr(),
            None if verdict is None else verdict.data_ptr(),
            None if want is None else want.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), R, L, budget, None)
    fn.lib.host_reverse_blocks(0)
    fn.lib.host_device(3, 2)
    assert rc == 0
    assert int(scratch.abs().sum()) == 0, "the scratch was not left zero"
    return out, fn.lib.host_arrivals_since(1)


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


def _split(x, ndev, offsets=None):
    """The ``ndev`` column shards of ``x``, new tensors; with ``offsets``,
    each an [R, L] view that starts that many bytes into a buffer of its
    own (so its rows sit at other phases mod 16)."""
    L = x.shape[1] // ndev
    if offsets is None:
        return tuple(x[:, i * L:(i + 1) * L].contiguous()
                     for i in range(ndev))
    out = []
    for i in range(ndev):
        o = offsets[i % len(offsets)]
        buf = torch.full((x.shape[0] * L + o + 16,), 0xA5, dtype=torch.uint8)
        view = buf[o:o + x.shape[0] * L].view(x.shape[0], L)
        view.copy_(x[:, i * L:(i + 1) * L])
        out.append(view)
    return tuple(out)


def _shifted(v, o):
    """``v`` (1-D) as a view ``o`` bytes into a buffer of its own, the
    bytes around it 1 (a member byte outside the vector must count for
    nothing)."""
    buf = torch.ones(v.numel() + o + 16, dtype=v.dtype)
    out = buf[o:o + v.numel()]
    out.copy_(v)
    return out


def _check(fn, heard, member, budget, verdict, want, ndev=1, offsets=None,
           member_offset=None, **kw):
    shards = _split(heard, ndev, offsets)
    mem = member if member_offset is None else _shifted(member,
                                                        member_offset)
    got, arrived = _run(fn, shards, mem, budget, verdict, want, **kw)
    ref = observe.heard_counts_ref(shards, member, budget, verdict, want)
    # And the sharded plain version equals the single one.
    assert torch.equal(ref, observe.heard_counts_ref(heard, member, budget,
                                                     verdict, want))
    assert torch.equal(got, ref), (ndev, budget, got - ref)
    return got, arrived


# (R, N, ndev): N % 16 of 0, 4, 8, 12 and 2, odd N, N shorter than a
# unit, more units than a span, 2 and 8 shards with L % 16 == 2 (a
# multi-DC pool's 8 x 31,250), 8 shards with L % 16 == 8 (1M's 8 x
# 125,000), the hot tier's 8 rows.
SHAPES = [(8, 4096, 1), (5, 1028, 1), (6, 1032, 1), (3, 1036, 1),
          (7, 1001, 1), (4, 1030, 1), (3, 5, 1), (9, 12, 1),
          (2, 16 * 256 * 3 + 16, 1), (6, 2 * 146, 2), (5, 8 * 18, 8),
          (4, 8 * 24, 8), (8, 4096 + 8, 2)]


@pytest.mark.parametrize("R, N, ndev", SHAPES)
def test_counts_match_plain(counts_lib, R, N, ndev):
    """Both forms over budgets from below 0 to above 16, every count held
    against the plain version."""
    heard, member, verdict = _inputs(R, N, seed=R * 100 + N)
    got = {budget: _check(counts_lib, heard, member, budget, None, None,
                          ndev)[0]
           for budget in (1, 3, 14, 0, 16, 20, -2)}
    held = _check(counts_lib, heard, member, 3, verdict, None, ndev)[0]
    assert int(got[3][observe.DEAD].sum()) > 0
    assert int(got[3][observe.LIVE].sum()) > 0
    assert not got[3][observe.HOLD].any()
    assert int(held[observe.HOLD].sum()) > 0
    assert not held[:observe.HOLD].any()
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
            got, _ = _check(counts_lib, heard, member, 3, v, want, ndev,
                            reverse=bool(k % 2))
            assert not got[:, ~want].any()
    assert not _check(counts_lib, heard, member, 3, verdict, wants[0],
                      ndev)[0].any()


@pytest.mark.parametrize("rows", [(5,), (0, 6, 63)])
@pytest.mark.parametrize("ndev", [1, 2, 8])
def test_few_wanted_rows_spread_over_the_grid(counts_lib, rows, ndev):
    """The spread's form as the round launches it, one and three wanted
    rows of 64, and the final matrix's form on those rows: each row over
    every span of every shard, blocks striding over items on a grid of 12
    and on one of 80 (more blocks than items)."""
    R, N = 64, 8 * (16 * 70 + 2)
    heard, member, verdict = _inputs(R, N, seed=len(rows) * 10 + ndev)
    verdict = torch.full((R,), 2, dtype=torch.int32)
    verdict[list(rows)[1:]] = 3
    want = torch.zeros(R, dtype=torch.bool)
    want[list(rows)] = True
    for device in ((6, 2), (20, 4)):
        for v in (verdict, None):
            got, arrived = _check(counts_lib, heard, member, 6, v, want,
                                  ndev, device=device)
            units = -(-(N // ndev) // 16) + 1
            items = ndev * -(-units // (UNITS * SMALL)) * len(rows)
            assert 0 < arrived <= min(items, device[0] * device[1])
            assert bool((got.sum(dim=0) > 0)[want].all())


@pytest.mark.parametrize("R", [1024, 1025, 2048, 3001])
def test_rows_past_one_listing(counts_lib, R):
    """Past 1,024 rows (the slots the reference provisions itself) the
    wide kernel lists and counts the rows 1,024 at a time, in both forms:
    every row and about half the rows wanted on one block, and only rows
    past the first listing on two blocks, in both block orders (a block
    with items in no chunk still arrives: every block of the grid does);
    every count against the plain version, the scratch left zero.  R
    from 1,024 (the narrow kernel's last) to a ragged 3,001 (three
    listings)."""
    ndev, N = 2, 2 * 146
    heard, member, verdict = _inputs(R, N, seed=R)
    rng = np.random.default_rng(R)
    half = torch.from_numpy(rng.random(R) < 0.5)
    late = torch.zeros(R, dtype=torch.bool)
    late[min(R - 40, observe.BLOCK_ROWS):] = True
    for v, want, device, reverse in ((None, None, (1, 1), False),
                                     (verdict, half, (1, 1), False),
                                     (verdict, late, (2, 1), True),
                                     (None, late, (2, 1), False)):
        got, arrived = _check(counts_lib, heard, member, 6, v, want, ndev,
                              device=device, reverse=reverse)
        counts_lib.lib.host_device(*device)
        blocks = counts_lib.lib.heard_counts_blocks(R, N // ndev, ndev,
                                                    int(v is not None))
        counts_lib.lib.host_device(3, 2)
        wide = R > observe.BLOCK_ROWS
        assert (arrived == blocks) if wide else 0 < arrived <= blocks
        assert int(got.sum()) > 0
        if want is not None:
            assert not got[:, ~want].any()


@pytest.mark.parametrize("hold", [False, True])
def test_no_wanted_row_writes_zeros_without_arrival(counts_lib, hold):
    """A launch that reads no row (``want`` all false, or in the spread's
    form every wanted row's verdict outside 0..3): ``out`` written zero,
    no block arrives, the scratch untouched."""
    R, N = 6, 1040
    heard, member, verdict = _inputs(R, N, seed=3)
    v = verdict if hold else None
    for want in (torch.zeros(R, dtype=torch.bool), None):
        if want is None:
            if not hold:
                continue
            v = torch.tensor([-1, 4, 258, -7, 5, 99], dtype=torch.int32)
        got, arrived = _check(counts_lib, heard, member, 3, v, want,
                              device=(4, 3))
        assert not got.any()
        assert arrived == 0


@pytest.mark.parametrize("L, offsets", [(16 * 70 + 1, (0, 3)),
                                        (16 * 70 + 2, (5, 0, 11)),
                                        (16 * 70 + 8, (8, 1)),
                                        (16 * 64, (1, 15))])
@pytest.mark.parametrize("ndev", [1, 2, 8])
def test_row_phases(counts_lib, L, offsets, ndev):
    """Rows at every phase mod 16 (L % 16 of 1, 2, 8 and 0, the shards at
    byte offsets of their buffers) against ``member`` at other offsets:
    every realignment of the staged member bytes, head and tail units
    loaded a byte at a time; a member byte outside the vector (1 in its
    buffer) counts for nothing, with verdict 0 too."""
    R = 7
    heard, member, verdict = _inputs(R, L * ndev, seed=L + ndev)
    verdict[0] = 0
    for mo in (0, 7):
        for v in (None, verdict):
            _check(counts_lib, heard, member, 5, v, None, ndev, offsets,
                   member_offset=mo)


@pytest.mark.parametrize("device", [(1, 1), (1, 2), (2, 3), (50, 4)])
def test_grids_of_every_size(counts_lib, device):
    """One block, a few (blocks striding over items), and more blocks than
    the launch has items (the idle ones neither count nor arrive): the
    same counts."""
    R, N, ndev = 9, 2 * (16 * 150 + 2), 2
    heard, member, verdict = _inputs(R, N, seed=sum(device))
    want = torch.from_numpy(np.arange(R) % 3 != 1)
    blocks = device[0] * device[1]
    for v, w in ((None, None), (verdict, want), (None, want)):
        _, arrived = _check(counts_lib, heard, member, 4, v, w, ndev,
                            device=device, reverse=blocks > 2)
        assert 0 < arrived <= blocks


def test_grid_is_one_wave(counts_lib):
    """The launcher's grid: the most items the launch can have (every row
    a group, every span of every shard), at most one wave of the blocks
    an SM the occupancy query gives, never more than 4 an SM."""
    lib = counts_lib.lib
    spans = -(-(-(-1_000_000 // 16) + 1) // (SMALL * UNITS))
    for (sms, per), want in (((132, 4), 528), ((132, 8), 528),
                             ((132, 2), 264), ((114, 3), 342)):
        lib.host_device(sms, per)
        for hold in (0, 1):
            assert lib.heard_counts_blocks(64, 1_000_000, 1, hold) == want
            assert lib.heard_counts_blocks(1, 40, 1, hold) == 1
            assert lib.heard_counts_blocks(3, 40, 8, hold) == min(24, want)
    lib.host_device(1000, 4)
    assert lib.heard_counts_blocks(2, 1_000_000, 1, 0) == 2 * spans
    lib.host_device(3, 2)
    assert lib.heard_counts_blocks(0, 40, 1, 0) < 0
    # Past 1,024 rows the wide kernel, on the same wave; past the launch's
    # ceiling, refused.
    assert lib.heard_counts_blocks(1025, 40, 1, 0) == 6
    assert lib.heard_counts_blocks(observe.MAX_ROWS, 40, 1, 1) == 6
    assert lib.heard_counts_blocks(observe.MAX_ROWS + 1, 40, 1, 0) < 0


@pytest.mark.parametrize("R, N, ndev", [(64, 2 * 4096 + 32, 2),
                                        (8, 8 * 3127, 8)])
def test_card_block_matches_plain(counts_card, R, N, ndev):
    """The source's own block of 256 threads (8 warps meeting in shared
    memory), both forms and a spread with holes, on a grid of 12 and of
    one."""
    heard, member, verdict = _inputs(R, N, seed=R + ndev)
    want = torch.from_numpy(np.arange(R) % 5 == 2)
    for device in ((6, 2), (1, 1)):
        for v, w in ((None, None), (verdict, want)):
            _check(counts_card, heard, member, 6, v, w, ndev,
                   offsets=(0, 9), device=device)


def test_ages_at_the_budget(counts_lib):
    """Each message with every age, against budgets 1 .. 16: an age below
    the budget counts as live, an age at it does not; every verdict's
    holders."""
    ages = np.arange(16, dtype=np.uint8)
    row = ((np.arange(4, dtype=np.uint8)[:, None] << 6) | ages).reshape(-1)
    heard = torch.from_numpy(np.tile(row, (4, 3)))  # [4, 192]
    member = torch.ones(heard.shape[1], dtype=torch.bool)
    verdict = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    for budget in range(0, 17):
        got, _ = _check(counts_lib, heard, member, budget, None, None)
        assert got[observe.LIVE].tolist() == [3 * 3 * budget] * 4
    got, _ = _check(counts_lib, heard, member, 3, verdict, None)
    assert got[observe.HOLD].tolist() == [3 * 16] * 4


def test_scratch_serves_many_launches(counts_lib):
    """One scratch through launches of different inputs and both forms
    (left zero by each), as the round's launches share it."""
    scratch = torch.zeros(observe.scratch_words(6), dtype=torch.int32)
    for seed in range(4):
        heard, member, verdict = _inputs(6, 1040, seed)
        v = verdict if seed % 2 else None
        got, _ = _run(counts_lib, (heard,), member, 3, v, scratch=scratch)
        assert torch.equal(got, observe.heard_counts_ref(heard, member, 3,
                                                         v))


def test_scratch_for_more_rows_serves_fewer(counts_lib):
    """A scratch made for S rows serves launches of fewer rows and of S,
    in any order, left zero by each: the round's one scratch serves its
    hot tier's gathered rows and its final matrix's."""
    scratch = torch.zeros(observe.scratch_words(8), dtype=torch.int32)
    for seed, R in enumerate((3, 8, 1, 8, 5)):
        heard, member, verdict = _inputs(R, 1040, seed)
        want = torch.from_numpy(np.arange(R) % 2 == 0)
        for v in (verdict, None):
            got, _ = _run(counts_lib, (heard,), member, 4, v, want,
                          reverse=bool(seed % 2), scratch=scratch)
            assert torch.equal(got, observe.heard_counts_ref(
                heard, member, 4, v, want)), R


def test_scratch_shared_with_the_fire(counts_lib, tmp_path_factory):
    """The round's one scratch through the fire pass (``csrc/finish.cu``,
    its first R + 1 words) and both counts' forms in turn, as a round
    launches them: each result held against its plain version, the
    scratch zero after each."""
    lib = _compile(tmp_path_factory.mktemp("finish_shares"), "finish",
                   FINISH_FORMS, SMALL)
    lib.fire_timers.argtypes = finish._FIRE_ARGTYPES
    lib.fire_timers.restype = ctypes.c_int
    R, N = 8, 2 * (16 * 80 + 2)
    scratch = torch.zeros(observe.scratch_words(R), dtype=torch.int32)
    assert finish.scratch_words(R) <= scratch.numel()
    rng = np.random.default_rng(5)
    for seed in range(3):
        heard, member, verdict = _inputs(R, N, seed)
        heard[:, ::3] = 0x40  # SUSPECT bytes to fire
        shards = _split(heard, 2)
        ok = torch.from_numpy(rng.integers(0, 16, R).astype(np.uint8))
        rx = torch.from_numpy(rng.random(N) < 0.7)
        want_sh = tuple(s.clone() for s in shards)
        fired_w = finish.fire_timers_ref(want_sh, rx, ok, None)
        fired = torch.full((R,), 7, dtype=torch.uint8)
        table = finish._array(2)(*(h.data_ptr() for h in shards))
        assert lib.fire_timers(table, 2, rx.data_ptr(), ok.data_ptr(), None,
                               None, fired.data_ptr(), scratch.data_ptr(),
                               R, N // 2, None) == 0
        assert int(scratch.abs().sum()) == 0
        assert torch.equal(fired.bool(), fired_w)
        assert all(torch.equal(a, b) for a, b in zip(shards, want_sh))
        want = torch.from_numpy(np.arange(R) % 3 == seed)
        for v, w in ((verdict, want), (None, None)):
            got, _ = _run(counts_lib, shards, member, 6, v, w,
                          scratch=scratch)
            assert torch.equal(got, observe.heard_counts_ref(
                shards, member, 6, v, w))


def test_counts_refuse_what_they_do_not_take(counts_lib):
    heard, member, _ = _inputs(4, 64, 0)
    out = torch.empty((4, 4), dtype=torch.int32)
    scratch = torch.zeros(observe.scratch_words(4), dtype=torch.int32)
    table = observe._array(1)(heard.data_ptr())
    ok = dict(ndev=1, member=member.data_ptr(), out=out.data_ptr(),
              scratch=scratch.data_ptr(), R=4, L=64)
    bad = [dict(ndev=0), dict(ndev=65), dict(member=None), dict(out=None),
           dict(scratch=None), dict(scratch=scratch.data_ptr() + 2),
           dict(R=0), dict(R=observe.MAX_ROWS + 1), dict(L=0),
           dict(ndev=64, L=2**31 // 64)]
    for change in bad:
        a = dict(ok, **change)
        rc = counts_lib(table, a["ndev"], a["member"], None, None, a["out"],
                        a["scratch"], a["R"], a["L"], 3, None)
        assert rc != 0, change
    assert counts_lib(table, 1, member.data_ptr(), None, None,
                      out.data_ptr(), scratch.data_ptr(), 4, 64, 3,
                      None) == 0


SASS_SAMPLE = """
        Function : _ZN7observe13counts_kernelILb1EEEvNS_4ArgsE
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDG.E.128 R4, desc[UR4][R2.64] ;
        /*0020*/                   ISETP.NE.AND P0, PT, R8, RZ, PT ;
        /*0030*/               @P0 BRA 0x0070 ;
        /*0040*/                   LOP3.LUT R5, R4, R6, RZ, 0x3c, !PT ;
        /*0050*/                   IADD3 R9, R9, R5, RZ ;
        /*0060*/                   BRA 0x00b0 ;
        /*0070*/                   SHF.R.W.U32 R5, R4, 0x8, R6 ;
        /*0080*/                   SHF.R.W.U32 R7, R4, 0x8, R6 ;
        /*0090*/                   LOP3.LUT R5, R5, R7, RZ, 0x3c, !PT ;
        /*00a0*/                   IADD3 R9, R9, R5, RZ ;
        /*00b0*/                   IMAD R9, R9, 0x1010101, RZ ;
        /*00c0*/                   REDUX.SUM UR4, R9 ;
        /*00d0*/                   ISETP.GE.AND P1, PT, R6, R10, PT ;
        /*00e0*/              @!P1 BRA 0x0010 ;
        /*00f0*/                   EXIT ;
        Function : _ZN7observe13counts_kernelILb0EEEvNS_4ArgsE
        /*0000*/                   EXIT ;
"""


def test_sass_count_takes_the_cheapest_row_path():
    """``sass_count.py --observe``: the row loop is found by its warp sum
    and 16-byte load; of its two ways (a realignment's funnel shifts or
    none) the cheaper is counted, a row per warp sum in the spread's
    form, 8 words a row; a way with more 16-byte loads comes first."""
    from consul_tpu_torch import sass_count
    got = sass_count.observe_counts(SASS_SAMPLE, "spread")
    assert got["loop"] == ["0x10", "0xe0"]
    assert got["instructions_in_loop"] == 14
    assert got["instructions_on_path"] == 10
    assert got["rows_per_iteration"] == 1
    assert got["words_per_iteration"] == 8
    # ISETP x2, LOP3, IADD3 on the ALU; IMAD on the FMA unit.
    assert (got["integer_alu"], got["fma"], got["flexible"]) == (4, 1, 0)
    assert got["busiest_unit_per_word"] == 0.5
    with pytest.raises(RuntimeError, match="no loop"):
        sass_count.observe_counts(SASS_SAMPLE, "final")
    # A way that loads the next row's units whole is taken over one that
    # skips the load, however cheaper.
    loads = SASS_SAMPLE.replace(
        "SHF.R.W.U32 R7, R4, 0x8, R6 ;", "LDG.E.128 R12, desc[UR4][R2.64] ;")
    got = sass_count.observe_counts(loads, "spread")
    assert got["instructions_on_path"] == 11
    assert (got["integer_alu"], got["fma"], got["memory"]) == (5, 1, 2)
