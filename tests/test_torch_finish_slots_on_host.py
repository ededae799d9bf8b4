"""The finish step's Hopper kernels on the CPU: ``csrc/finish_slots.cu``
compiled by the host's C++ compiler against a small stand-in for the CUDA
runtime in which a launch runs its one block as ``blockDim.x`` host threads
at once: ``__syncthreads`` and ``__syncthreads_count`` meet at a barrier of
the block, and the atomics (global and shared) are the compiler's
``__atomic`` builtins.

Each launch goes through the port's own wrappers
(``finish_slots.finish_decide``, ``finish_settle``, ``finish_record``:
their checks, the pointer table and the integers as the card gets them,
the launch counters) and the step is held, field for field after each
launch, against the plain versions (``finish_decide_ref``,
``finish_settle_ref``, ``finish_record_ref``; between them the fire's and
the spread count's plain versions, ``finish.fire_timers_ref`` and
``observe.heard_counts_ref``) on the cases of
tests/test_torch_finish_slots.py (full and hot ``idx`` with padding rows,
1, 2 and 8 shards, the hist banks, LHM and the refutation on and off,
every row firing, every row expiring, shared buckets and counters near
2**31) and on 200 rows (seven warps: the block counts and the shared
buckets across warps).  Decide's and settle's launches, and record's with
the holders, go through ``cudaLaunchKernelEx`` as programmatic dependent
launches (counted); at ``griddepcontrol.wait`` the block meets and a
test's hook checks that nothing was written before it and writes what the
kernel before would have (settle's ``fired``, record's holders).  Needs
``g++``; builds into the test's temporary directory.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from consul_tpu_torch import _build
from consul_tpu_torch.gossip import finish, finish_slots, observe
from consul_tpu_torch.gossip import kernel as tk
from consul_tpu_torch.gossip import nemesis as t_nem
from tests.test_torch_finish_slots import (CASES, LHM_MAX, RND, _derived,
                                           _params, case_state)

# What the kernels use of the CUDA runtime and device built-ins, on the
# host: a block is blockDim.x threads.
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
// A block's shared memory: one static per function (one block a launch).
#define __shared__ static
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
static thread_local dim3 threadIdx, blockIdx;
template <class T> static inline T __ldg(const T* p) { return *p; }
static inline int __clz(int x) {
  return x == 0 ? 32 : __builtin_clz(static_cast<unsigned>(x));
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
static HostBarrier* host_block;
static std::atomic<int> host_count{0};
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
static inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
static inline unsigned atomicAdd(unsigned* p, unsigned v) {
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
// A launch: its blocks one after another, each block's threads at once.
template <class K, class... A>
static void host_launch(K kernel, dim3 grid, dim3 block, const A&... args) {
  if (block.x % 32 != 0) std::abort();
  HostBarrier bar;
  bar.n = block.x;
  host_block = &bar;
  std::vector<std::thread> threads;
  const unsigned blocks = grid.x;
  for (unsigned t = 0; t < block.x; ++t)
    threads.emplace_back([=, &args...] {
      threadIdx = dim3(t);
      for (unsigned k = 0; k < blocks; ++k) {
        blockIdx = dim3(k);
        kernel(args...);
        host_block->sync();
      }
    });
  for (auto& th : threads) th.join();
}
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
static inline cudaError_t cudaGetLastError() { return cudaSuccess; }
static inline const char* cudaGetErrorString(cudaError_t e) {
  return e ? "invalid argument" : "no error";
}
// cudaLaunchKernelEx with its launch attributes: the launch runs as any
// other; a programmatic one (griddepcontrol is the card's alone) counted.
enum cudaLaunchAttributeID {
  cudaLaunchAttributeProgrammaticStreamSerialization = 5
};
union cudaLaunchAttributeValue {
  int programmaticStreamSerializationAllowed;
};
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  cudaLaunchAttributeValue val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
static int host_programmatic = 0;
extern "C" int finish_slots_host_programmatic() { return host_programmatic; }
template <class K, class... A>
static cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* c, K kernel,
                                      const A&... args) {
  for (unsigned i = 0; i < c->numAttrs; ++i) {
    if (c->attrs[i].id ==
            cudaLaunchAttributeProgrammaticStreamSerialization &&
        c->attrs[i].val.programmaticStreamSerializationAllowed) {
      ++host_programmatic;
    }
  }
  host_launch(kernel, c->gridDim, c->blockDim, args...);
  return cudaSuccess;
}
// griddepcontrol.wait: the block meets, thread 0 calls the hook a test set
// (it checks what the kernel wrote before the wait and writes what the
// kernel before would have), and the block goes on.
typedef void (*host_wait_fn)(void);
static host_wait_fn host_wait_hook = nullptr;
extern "C" void finish_slots_host_wait_hook(host_wait_fn f) {
  host_wait_hook = f;
}
static inline void host_griddep_wait() {
  host_block->sync();
  if (threadIdx.x == 0 && host_wait_hook != nullptr) host_wait_hook();
  host_block->sync();
}
"""
# The wait's host form.
WAIT = 'asm volatile("griddepcontrol.wait;" ::: "memory");\n#endif'
HOST_WAIT = ('asm volatile("griddepcontrol.wait;" ::: "memory");\n#else\n'
             '  host_griddep_wait();\n#endif')
WAIT_HOOK = ctypes.CFUNCTYPE(None)

# A launch in the source -> its host form.
LAUNCH = re.compile(r"(\w+_kernel)<<<(.+?), (\S+?), 0,\s*"
                    r"static_cast<cudaStream_t>\(stream\)>>>\(a\);")

# Beyond tests/test_torch_finish_slots.py's cases: 200 rows, seven warps,
# everything threaded; and the slot counts around the one-block form's
# 1,024 rows (the reference provisions more: crossval.loss_sized_slots,
# run_nemesis_config), where the wide kernels' threads take rows t,
# t + 1,024, ...: 1,024 (the last narrow launch), 1,025, 2,048 and a
# ragged 3,001, full and hot (1,500 of 3,001 slots' rows), 1 and 2
# shards, with and without the banks and LHM.
HOST_CASES = dict(
    CASES, wide=(640, 200, None, 2, True, True, True, "mixed"),
    slots_1024=(2100, 1024, None, 1, True, True, True, "mixed"),
    slots_1025=(2100, 1025, None, 2, True, True, True, "mixed"),
    slots_2048=(4200, 2048, None, 1, False, False, True, "mixed"),
    slots_3001=(6002, 3001, None, 2, True, True, True, "mixed"),
    slots_3001_hot=(6002, 3001, 1500, 1, True, False, True, "mixed"))
WIDE = ("slots_1025", "slots_3001", "slots_3001_hot")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernels for the host")
    d = tmp_path_factory.mktemp("finish_slots_on_host")
    (d / "cuda_runtime.h").write_text(CUDA_STUB)
    body, n = LAUNCH.subn(r"host_launch(\1, dim3(\2), dim3(\3), a);",
                          (_build.CSRC / "finish_slots.cu").read_text())
    assert n == 2, n  # record's two instances without the holders;
    # decide, settle, and record given them, launch through
    # cudaLaunchKernelEx
    assert body.count(WAIT) == 1
    body = body.replace(WAIT, HOST_WAIT)
    src = d / "finish_slots.cpp"
    src.write_text(body)
    so = d / "libfinish_slots.so"
    r = subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC",
                        "-pthread", f"-I{d}", "-o", str(so), str(src)],
                       capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr
    lib = ctypes.CDLL(str(so))
    for name in finish_slots.ENTRY_POINTS:
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = finish_slots._ARGTYPES, ctypes.c_int
    lib.finish_slots_error.argtypes = [ctypes.c_int]
    lib.finish_slots_error.restype = ctypes.c_char_p
    lib.finish_slots_host_programmatic.restype = ctypes.c_int
    lib.finish_slots_host_wait_hook.argtypes = [WAIT_HOOK]
    return lib


@pytest.fixture
def on_host(lib, monkeypatch):
    """The wrappers' launches go to the host build (stream None), and
    their CPU tensors pass the card check."""
    def launch(fn, err, name, dev, *args):
        rc = fn(*args, None)
        assert rc == 0, err(rc)
    fns = tuple(getattr(lib, name) for name in finish_slots.ENTRY_POINTS)
    monkeypatch.setattr(finish_slots, "_lib",
                        lambda: (fns, lib.finish_slots_error))
    monkeypatch.setattr(_build, "launch", launch)
    monkeypatch.setattr(finish_slots, "require_cuda", lambda name, t: None)
    return lib


def _case(name):
    spec = HOST_CASES[name]
    n, S, _, _, _, lhm, refute, _ = spec
    c = case_state(name, 11 + len(name), spec)
    p = _params(name, "torch") if name in CASES else \
        tk.SwimParams(n=n, slots=S, refute=refute)
    alive, rx_ok, cc, idx = _derived(p, c["st"], c["fail"], c["idx"])
    nem = (t_nem.NemesisParams(scenario="probe", start=0, stop=10_000,
                               lhm_max=LHM_MAX) if lhm else None)
    return p, spec, c, finish_slots.config(p, nem), (alive, rx_ok, cc, idx)


def _step(p, spec, c, derived) -> finish_slots.Step:
    """Fresh copies of the case's tensors as the round gives them."""
    n, _, hot, ndev, has_hist, lhm, _, _ = spec
    alive, _, cc, idx = derived
    st = {f: torch.from_numpy(np.array(v)) for f, v in c["st"].items()}
    heard = st["heard"]
    if hot is not None:
        heard = heard[torch.from_numpy(idx).long()]
    if ndev > 1:
        L = n // ndev
        heard = tuple(heard[:, i * L:(i + 1) * L].clone()
                      for i in range(ndev))
    hist = (tk.HistBank(**{f: torch.from_numpy(v.copy())
                           for f, v in c["hist"].items()})
            if has_hist else None)
    return finish_slots.Step(
        heard, torch.tensor(RND, dtype=torch.int32),
        torch.from_numpy(idx.copy()),
        (st["slot_node"], st["slot_phase"], st["slot_start"],
         st["slot_dead_round"]), torch.from_numpy(cc.copy()),
        torch.from_numpy(alive.copy()), st["member"],
        torch.from_numpy(c["fail"].copy()), st["slot_of_node"],
        st["incarnation"], (st["n_detected"], st["sum_detect_rounds"],
                            st["n_false_dead"], st["n_refuted"]),
        torch.from_numpy(c["ns"][0].copy()) if lhm else None, hist)


def _leaves(t: finish_slots.Step) -> list:
    heard = t.heard if isinstance(t.heard, tuple) else (t.heard,)
    return [*heard, *t.slots, t.member, t.slot_of_node, t.incarnation,
            *t.stats, *([] if t.lhm is None else [t.lhm]),
            *(t.hist or ())]


def _same(a, b, what: str) -> None:
    for i, (x, y) in enumerate(zip(a, b)):
        assert x is None and y is None or torch.equal(x, y), \
            f"{what}: leaf {i} differs"


@pytest.mark.parametrize("name", sorted(HOST_CASES))
def test_kernels_match_plain(on_host, name):
    p, spec, c, cfg, derived = _case(name)
    rx = torch.from_numpy(derived[1])
    got, want = _step(p, spec, c, derived), _step(p, spec, c, derived)
    n0 = (finish_slots.decide_launches, finish_slots.settle_launches,
          finish_slots.record_launches)

    dec = finish_slots.finish_decide(cfg, got)
    dec_w = finish_slots.finish_decide_ref(cfg, want)
    _same(_leaves(got), _leaves(want), f"{name} decide")
    _same([dec.ok_mask, *(dec.refute or ())],
          [dec_w.ok_mask, *(dec_w.refute or ())], f"{name} decide's out")

    fired = finish.fire_timers_ref(got.heard, rx, dec.ok_mask, dec.refute)
    fired_w = finish.fire_timers_ref(want.heard, rx, dec_w.ok_mask,
                                     dec_w.refute)
    st = finish_slots.finish_settle(cfg, got, fired)
    st_w = finish_slots.finish_settle_ref(cfg, want, fired_w)
    _same(_leaves(got), _leaves(want), f"{name} settle")
    _same(list(st), list(st_w), f"{name} settle's out")

    n_hold = n_hold_w = None
    if got.hist is not None:
        n_hold = observe.heard_counts_ref(
            got.heard, got.member, cfg.budget, st.verdict,
            st.spread)[observe.HOLD]
        n_hold_w = observe.heard_counts_ref(
            want.heard, want.member, cfg.budget, st_w.verdict,
            st_w.spread)[observe.HOLD]
    finish_slots.finish_record(cfg, got, dec, st, n_hold)
    finish_slots.finish_record_ref(cfg, want, dec_w, st_w, n_hold_w)
    _same(_leaves(got), _leaves(want), f"{name} record")
    assert (finish_slots.decide_launches, finish_slots.settle_launches,
            finish_slots.record_launches) == tuple(x + 1 for x in n0)
    # The step did something: rows fired or expired.
    assert bool(fired.any()) or bool(st.expired.any()), name


def test_launch_shapes_name_the_variant(on_host):
    p, spec, c, cfg, derived = _case("sharded_8_hot")
    finish_slots.launch_shapes.clear()
    t = _step(p, spec, c, derived)
    n0 = on_host.finish_slots_host_programmatic()
    finish_slots.finish_decide(cfg, t)
    assert finish_slots.launch_shapes == {
        ("finish_decide", 10, 16, 640, 80, 8, (True, False, True))}
    # Decide is a programmatic dependent launch, the others are not.
    assert on_host.finish_slots_host_programmatic() == n0 + 1


@pytest.mark.parametrize("name", ["full_mixed", "sharded_8_hot", "wide"])
def test_decide_after_tail_matches_plain(on_host, name):
    """Decide on rows whose own bytes only the write just before it made
    SUSPECT (as the tail's merge does in the round; before it, no row
    refutes) against its plain version, every field; rows refute; a
    programmatic launch."""
    p, spec, c, cfg, derived = _case(name)
    got, want = _step(p, spec, c, derived), _step(p, spec, c, derived)

    def own_bytes(t, value):
        shards = t.heard if isinstance(t.heard, tuple) else (t.heard,)
        L = shards[0].shape[1]
        node_c = t.slots[0][t.idx.long()].clamp(0, cfg.N - 1)
        for h, col in enumerate(node_c.tolist()):
            shards[col // L][h, col % L] = value

    before = _step(p, spec, c, derived)
    own_bytes(before, 0)
    assert int(finish_slots.finish_decide_ref(cfg, before).refute[1]
               .count_nonzero()) == 0
    for t in (got, want):
        own_bytes(t, 0x40)  # SUSPECT, conf 0, age 0
    n0 = on_host.finish_slots_host_programmatic()
    dec = finish_slots.finish_decide(cfg, got)
    dec_w = finish_slots.finish_decide_ref(cfg, want)
    assert on_host.finish_slots_host_programmatic() == n0 + 1
    _same(_leaves(got), _leaves(want), f"{name} decide")
    _same([dec.ok_mask, *(dec.refute or ())],
          [dec_w.ok_mask, *(dec_w.refute or ())], f"{name} decide's out")
    assert int(dec.refute[1].count_nonzero()) > 0, name


def test_refused_arguments(on_host):
    """The wrappers refuse what the kernels do not take; the C entry
    points refuse a table they cannot run."""
    p, spec, c, cfg, derived = _case("full_mixed")
    t = _step(p, spec, c, derived)
    with pytest.raises(ValueError, match="H <= S"):
        finish_slots.finish_decide(
            cfg._replace(S=finish_slots.MAX_ROWS + 1), t)
    with pytest.raises(ValueError, match="slot register"):
        finish_slots.finish_decide(cfg, t._replace(slots=t.slots[:3] + (
            t.slots[3].to(torch.int64),)))
    with pytest.raises(ValueError, match="fired"):
        finish_slots.finish_settle(cfg, t, torch.zeros(3, dtype=torch.bool))
    with pytest.raises(ValueError, match="n_hold"):
        finish_slots.finish_record(cfg, t, *[None] * 2)
    ptrs = (ctypes.c_void_p * 30)(*([t.idx.data_ptr()] * 30))
    ints = (ctypes.c_int * 13)(p.n, p.slots, p.slots, 1, 4, 300, 3, 1, 1,
                               1, 1, 256, 32)
    table = (ctypes.c_void_p * 1)(t.heard.data_ptr())
    ints[1] = p.slots + 1  # H > S
    assert on_host.finish_decide(table, 1, ptrs, ints, None) != 0
    ints[1] = p.slots
    ptrs[18] = None  # the refutation's column without its byte
    assert on_host.finish_decide(table, 1, ptrs, ints, None) != 0
    ptrs[18] = ptrs[17]
    ptrs[27] = None  # one bank missing
    assert on_host.finish_record(table, 1, ptrs, ints, None) != 0


def _settled(name, on_host):
    """A case's step up to the spread's count, through the kernels (the
    fire by its plain version), on one copy of its tensors and through
    the plain versions on another: ``(cfg, got, want, (dec, st),
    (dec_w, st_w))``."""
    p, spec, c, cfg, derived = _case(name)
    rx = torch.from_numpy(derived[1])
    got, want = _step(p, spec, c, derived), _step(p, spec, c, derived)
    dec = finish_slots.finish_decide(cfg, got)
    dec_w = finish_slots.finish_decide_ref(cfg, want)
    fired = finish.fire_timers_ref(got.heard, rx, dec.ok_mask, dec.refute)
    fired_w = finish.fire_timers_ref(want.heard, rx, dec_w.ok_mask,
                                     dec_w.refute)
    st = finish_slots.finish_settle(cfg, got, fired)
    st_w = finish_slots.finish_settle_ref(cfg, want, fired_w)
    return cfg, got, want, (dec, st), (dec_w, st_w)


@pytest.mark.parametrize("name", ["full_mixed", "sharded_2",
                                  "all_expire", "wide", *WIDE])
def test_record_behind_the_count_waits(on_host, name):
    """Record with the holders: a programmatic dependent launch that
    writes nothing before its wait and reads the holders only after it.
    At the wait (``host_griddep_wait``) every tensor of the step still
    equals its value before the launch (so a dropped subject's member flag
    is still what the count read), and only then are the holders written,
    as the count's end would make them visible: ``n_hold`` holds garbage
    until then.  The result equals the plain versions' field for field;
    the case drops subjects and counts spread rows."""
    cfg, got, want, (dec, st), (dec_w, st_w) = _settled(name, on_host)
    assert got.hist is not None
    n_hold_w = observe.heard_counts_ref(want.heard, want.member, cfg.budget,
                                        st_w.verdict, st_w.spread)[
                                            observe.HOLD]
    n_hold_true = observe.heard_counts_ref(got.heard, got.member,
                                           cfg.budget, st.verdict,
                                           st.spread)[observe.HOLD]
    n_hold = torch.full_like(n_hold_true, 0x7FFFFFFF)
    before = [x.clone() for x in _leaves(got)]
    member_before = got.member.clone()
    seen = []

    def at_wait():
        seen.append(all(torch.equal(x, y)
                        for x, y in zip(_leaves(got), before)))
        n_hold.copy_(n_hold_true)

    hook = WAIT_HOOK(at_wait)
    on_host.finish_slots_host_wait_hook(hook)
    n0 = on_host.finish_slots_host_programmatic()
    try:
        finish_slots.finish_record(cfg, got, dec, st, n_hold)
    finally:
        on_host.finish_slots_host_wait_hook(WAIT_HOOK())
    assert on_host.finish_slots_host_programmatic() == n0 + 1
    assert seen == [True], "record wrote before its wait"
    finish_slots.finish_record_ref(cfg, want, dec_w, st_w, n_hold_w)
    _same(_leaves(got), _leaves(want), f"{name} record")
    assert bool((st.marks & finish_slots.DROPPED).any()), name
    assert bool(st.spread.any()), name
    assert bool((member_before & ~got.member).any()), name


@pytest.mark.parametrize("name", ["full_bare", "sharded_8_bare"])
def test_record_without_the_banks_is_a_plain_launch(on_host, name):
    """Without the hist banks record follows settle, which writes its
    inputs: a plain launch, equal to the plain version."""
    cfg, got, want, (dec, st), (dec_w, st_w) = _settled(name, on_host)
    assert got.hist is None
    n0 = on_host.finish_slots_host_programmatic()
    finish_slots.finish_record(cfg, got, dec, st)
    assert on_host.finish_slots_host_programmatic() == n0
    finish_slots.finish_record_ref(cfg, want, dec_w, st_w)
    _same(_leaves(got), _leaves(want), f"{name} record")


@pytest.mark.parametrize("name", ["full_mixed", "sharded_8_hot", "all_fire",
                                  "wide", *WIDE])
def test_settle_behind_the_fire_waits(on_host, name, monkeypatch):
    """Settle: a programmatic dependent launch that writes nothing before
    its wait and reads ``fired`` only after it.  At the wait
    (``host_griddep_wait``) every tensor of the step and every output of
    settle still hold their values from before the launch, and only then
    is ``fired`` written, as the fire's end would make it visible: until
    then it holds the opposite of each row's verdict, so a settle that read
    it early would give other verdicts.  The result equals the plain
    version's field for field; rows fire."""
    p, spec, c, cfg, derived = _case(name)
    rx = torch.from_numpy(derived[1])
    got, want = _step(p, spec, c, derived), _step(p, spec, c, derived)
    dec = finish_slots.finish_decide(cfg, got)
    dec_w = finish_slots.finish_decide_ref(cfg, want)
    fired_true = finish.fire_timers_ref(got.heard, rx, dec.ok_mask,
                                        dec.refute)
    fired_w = finish.fire_timers_ref(want.heard, rx, dec_w.ok_mask,
                                     dec_w.refute)
    assert bool(fired_true.any()), name
    fired = ~fired_true
    before = [x.clone() for x in _leaves(got)]
    outputs = []
    launch = finish_slots._launch

    def marked(which, cfg_, t, dec_=None, st=None, **kw):
        # Settle's outputs hold a marker until it writes them.
        for x in st or ():
            if x is not None:
                x.fill_(True if x.dtype == torch.bool else 0x5A)
                outputs.append((x, x.clone()))
        return launch(which, cfg_, t, dec_, st, **kw)

    seen = []

    def at_wait():
        seen.append(all(torch.equal(x, y)
                        for x, y in zip(_leaves(got), before))
                    and all(torch.equal(x, y) for x, y in outputs))
        fired.copy_(fired_true)

    monkeypatch.setattr(finish_slots, "_launch", marked)
    hook = WAIT_HOOK(at_wait)
    on_host.finish_slots_host_wait_hook(hook)
    n0 = on_host.finish_slots_host_programmatic()
    try:
        st = finish_slots.finish_settle(cfg, got, fired)
    finally:
        on_host.finish_slots_host_wait_hook(WAIT_HOOK())
    assert on_host.finish_slots_host_programmatic() == n0 + 1
    assert seen == [True], "settle wrote before its wait"
    assert len(outputs) == (4 if got.hist is not None else 2)
    st_w = finish_slots.finish_settle_ref(cfg, want, fired_w)
    _same(_leaves(got), _leaves(want), f"{name} settle")
    _same(list(st), list(st_w), f"{name} settle's out")
