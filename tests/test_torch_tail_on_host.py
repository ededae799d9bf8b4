"""The Hopper kernel on the CPU: ``csrc/dissem_tail.cu`` (its body and
both entry points, ``fused_dissem`` and ``fused_merge``) compiled by the
host's C++ compiler against a small stand-in for the CUDA runtime, which
runs the grid one thread at a time.

This checks the kernels' own indexing before any card does: the shard
table, pins read across shard edges and around the wrap at N, the funnel
shifts of every byte offset, 16-byte and 4-byte row alignment, the ragged
row end and the byte path, each with and without a drop operand (16-byte
aligned and not), and the round and shifts read from device memory as
``[rnd, o_0 ..]`` (shifts outside [0, N) reduced).  Each launch is held byte for byte against the
plain torch versions (``disseminate_ref``, ``merge_shards_ref``).  Needs
``g++``; builds into the test's temporary directory.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from consul_tpu_torch import _build
from consul_tpu_torch.gossip import fused
from consul_tpu_torch.gossip import kernel as tk
from consul_tpu_torch.gossip.params import SwimParams

NEVER = 2**31 - 1

# What the kernels use of the CUDA runtime and device built-ins, on the
# host: a launch runs its threads one at a time.
CUDA_STUB = r"""
#pragma once
#include <algorithm>
#include <cstdint>
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
inline dim3 blockIdx, threadIdx;
struct uint4 { uint32_t x, y, z, w; };
struct int4 { int32_t x, y, z, w; };
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return {a, b, c, d};
}
template <class T> inline T __ldg(const T* p) { return *p; }
inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, uint32_t sh) {
  return static_cast<uint32_t>(((static_cast<uint64_t>(hi) << 32) | lo)
                               >> (sh & 31));
}
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "error"; }
"""

LAUNCH = "tail_kernel<F><<<grid, kThreads, 0, stream>>>(a);"
SERIAL = ("for (unsigned by = 0; by < grid.y; ++by)"
          " for (unsigned bx = 0; bx < grid.x; ++bx)"
          " for (unsigned t = 0; t < kThreads; ++t) {"
          " blockIdx = dim3(bx, by); threadIdx = dim3(t);"
          " tail_kernel<F>(a); }")


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernels for the host")
    d = tmp_path_factory.mktemp("tail_on_host")
    (d / "cuda_runtime.h").write_text(CUDA_STUB)
    body = (_build.CSRC / "dissem_tail.cu").read_text()
    assert body.count(LAUNCH) == 1
    src = d / "dissem_tail.cpp"
    src.write_text(body.replace(LAUNCH, SERIAL))
    so = d / "libdissem_tail.so"
    r = subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC",
                        f"-I{d}", f"-I{_build.CSRC}", "-o", str(so),
                        str(src)],
                       capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr
    lib = ctypes.CDLL(str(so))
    out = {}
    for name in ("fused_dissem", "fused_merge"):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = fused._ARGTYPES[name], ctypes.c_int
        out[name] = fn
    return out


def _inputs(S, N, seed):
    """Every belief byte value, senders dead/alive/non-member, receivers
    on and off, caps 0..3."""
    rng = np.random.default_rng(seed)
    heard = rng.integers(0, 256, (S, N)).astype(np.uint8)
    mf = rng.choice(np.asarray([-1, 10, 200, NEVER], np.int32), (N,))
    rx = rng.random(N) < 0.9
    cap = rng.integers(0, 4, (S,)).astype(np.int32)
    return heard, mf, rx, cap


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _args(rnd, legs):
    """``(rnd, offs)`` in one ``[rnd, o_0 .. o_F-1]`` buffer, as the
    round's table row holds them; the kernel reads from ``rnd``'s
    address."""
    return fused.tail_args(rnd, legs, "cpu")


def _drops(F, N, seed):
    """No drop operand, a u8 [F, N] one (about half its bytes set, to
    any nonzero value) and the same one byte into a larger buffer (not
    16-byte aligned: the single loads)."""
    rng = np.random.default_rng(seed)
    d = (rng.random((F, N)) < 0.5) * rng.integers(1, 256, (F, N))
    drop = torch.from_numpy(d.astype(np.uint8))
    back = torch.zeros(F * N + 1, dtype=torch.uint8)
    back[1:] = drop.reshape(-1)
    return [None, drop, back[1:].view(F, N)]


def _offsets(N, L, seed):
    """1, N - 1, every residue mod 16 near the start, a few above L (the
    pin comes from a shard further on) and random ones."""
    rng = np.random.default_rng(seed)
    return ([1, N - 1] + list(range(2, 18)) + [L + 3, 2 * L - 5]
            + rng.integers(1, N, 6).tolist())


@pytest.mark.parametrize("S, N", [(16, 4096), (7, 4099), (5, 1000),
                                  (4, 24), (9, 160)])
def test_fused_dissem_body_matches_plain(libs, S, N):
    """Every residue of the shift mod 16, the wrap at N, ragged widths;
    mf 16-byte aligned (vector loads) and not (single loads)."""
    heard, mf, rx, cap = (torch.from_numpy(a) for a in _inputs(S, N, N))
    mf_odd = torch.zeros(N + 1, dtype=torch.int32)
    mf_odd[1:] = mf
    offs = [o % N or 1 for o in _offsets(N, N // 2, S)]
    p = SwimParams(n=N, slots=S)
    for k in range(0, len(offs), 3):
        legs = offs[k:k + 3]
        rnd, o = _args(50, legs)
        for drop in _drops(len(legs), N, k):
            ref = fused.disseminate_ref(p, rnd, o, heard, mf, rx, cap, drop)
            for m in (mf, mf_odd[1:]) if drop is None else (mf,):
                out = torch.empty_like(heard)
                rc = libs["fused_dissem"](_ptr(heard), _ptr(out), _ptr(m),
                                          _ptr(rx), _ptr(cap), _ptr(drop),
                                          S, N, len(legs), _ptr(rnd),
                                          p.spread_budget_rounds, None)
                assert rc == 0
                assert torch.equal(out, ref), (legs, drop is None)


@pytest.mark.parametrize("ndev, L", [(1, 2048), (2, 1024), (4, 512),
                                     (8, 256), (8, 1000), (3, 1001)])
def test_fused_merge_body_matches_plain(libs, ndev, L):
    """All shards in one launch against the plain composition, with
    offsets above L; also through shard views that are not 4-byte
    aligned (the byte path throughout)."""
    S, N = 6, ndev * L
    heard, mf, rx, cap = (torch.from_numpy(a)
                          for a in _inputs(S, N, ndev * 7 + L))
    sc = tk._ShardCtx(ndev, L)
    shards = tuple(h.contiguous() for h in heard.split(L, dim=1))
    # The same shards one byte into a larger buffer each.
    backing = [torch.zeros(S * L + 1, dtype=torch.uint8) for _ in shards]
    for b, h in zip(backing, shards):
        b[1:] = h.reshape(-1)
    odd = tuple(b[1:].view(S, L) for b in backing)
    p = SwimParams(n=N, slots=S)
    offs = _offsets(N, L, ndev)
    for k in range(0, len(offs), 3):
        legs = [o % N or 1 for o in offs[k:k + 3]]
        rnd, o = _args(50, legs)
        for drop in _drops(len(legs), N, k):
            ref = fused.merge_shards_ref(p, rnd, o, shards, mf, rx, cap, sc,
                                         drop)
            for table in (shards, odd):
                out = torch.empty((ndev, S, L), dtype=torch.uint8)
                ptrs = (ctypes.c_void_p * ndev)(*(h.data_ptr()
                                                  for h in table))
                rc = libs["fused_merge"](ptrs, ndev, _ptr(out), _ptr(mf),
                                         _ptr(rx), _ptr(cap), _ptr(drop), S,
                                         L, len(legs), _ptr(rnd),
                                         p.spread_budget_rounds, 0, ndev,
                                         None)
                assert rc == 0
                for i in range(ndev):
                    assert torch.equal(out[i], ref[i]), (legs, i,
                                                         drop is None)


def test_fused_merge_body_shard_range(libs):
    """A launch over shards [i0, i1) writes those shards and no other."""
    S, ndev, L = 4, 4, 64
    N = ndev * L
    heard, mf, rx, cap = (torch.from_numpy(a) for a in _inputs(S, N, 5))
    shards = tuple(h.contiguous() for h in heard.split(L, dim=1))
    p = SwimParams(n=N, slots=S)
    rnd, o = _args(50, [5, L + 7, N - 3])
    ref = fused.merge_shards_ref(p, rnd, o, shards, mf, rx, cap,
                                 tk._ShardCtx(ndev, L))
    out = torch.full((ndev, S, L), 0xAB, dtype=torch.uint8)
    ptrs = (ctypes.c_void_p * ndev)(*(h.data_ptr() for h in shards))
    rc = libs["fused_merge"](ptrs, ndev, _ptr(out), _ptr(mf), _ptr(rx),
                             _ptr(cap), None, S, L, 3, _ptr(rnd),
                             p.spread_budget_rounds, 1, 3, None)
    assert rc == 0
    for i in range(ndev):
        if 1 <= i < 3:
            assert torch.equal(out[i], ref[i]), i
        else:
            assert bool((out[i] == 0xAB).all()), i


@pytest.mark.parametrize("S, N", [(7, 4099), (9, 160), (16, 4096)])
def test_fused_dissem_reduces_shifts_mod_n(libs, S, N):
    """Shifts read from memory off by +-N give the bytes of the shifts in
    [1, N), in the kernel and in the plain version."""
    heard, mf, rx, cap = (torch.from_numpy(a) for a in _inputs(S, N, N + 1))
    p = SwimParams(n=N, slots=S)
    offs = [o % N or 1 for o in _offsets(N, N // 2, S)]
    for k in range(0, len(offs), 3):
        legs = offs[k:k + 3]
        for drop in _drops(len(legs), N, k)[:2]:
            ref = fused.disseminate_ref(p, *_args(77, legs), heard, mf, rx,
                                        cap, drop)
            for raw in ([o + N for o in legs], [o - N for o in legs]):
                rnd, o = _args(77, raw)
                out = torch.empty_like(heard)
                rc = libs["fused_dissem"](
                    _ptr(heard), _ptr(out), _ptr(mf), _ptr(rx), _ptr(cap),
                    _ptr(drop), S, N, len(legs), _ptr(rnd),
                    p.spread_budget_rounds, None)
                assert rc == 0
                assert torch.equal(out, ref), (legs, raw)
                assert torch.equal(fused.disseminate_ref(
                    p, rnd, o, heard, mf, rx, cap, drop), ref)


@pytest.mark.parametrize("ndev, L", [(2, 1024), (8, 256), (3, 1001)])
def test_fused_merge_reduces_shifts_mod_n(libs, ndev, L):
    S, N = 5, ndev * L
    heard, mf, rx, cap = (torch.from_numpy(a)
                          for a in _inputs(S, N, ndev + L))
    sc = tk._ShardCtx(ndev, L)
    shards = tuple(h.contiguous() for h in heard.split(L, dim=1))
    p = SwimParams(n=N, slots=S)
    offs = _offsets(N, L, ndev + 1)
    for k in range(0, len(offs), 3):
        legs = [o % N or 1 for o in offs[k:k + 3]]
        for drop in _drops(len(legs), N, k)[:2]:
            ref = fused.merge_shards_ref(p, *_args(77, legs), shards, mf, rx,
                                         cap, sc, drop)
            rnd, o = _args(77, [o - N for o in legs])
            out = torch.empty((ndev, S, L), dtype=torch.uint8)
            ptrs = (ctypes.c_void_p * ndev)(*(h.data_ptr() for h in shards))
            rc = libs["fused_merge"](ptrs, ndev, _ptr(out), _ptr(mf),
                                     _ptr(rx), _ptr(cap), _ptr(drop), S, L,
                                     len(legs), _ptr(rnd),
                                     p.spread_budget_rounds, 0, ndev, None)
            assert rc == 0
            plain = fused.merge_shards_ref(p, rnd, o, shards, mf, rx, cap,
                                           sc, drop)
            for i in range(ndev):
                assert torch.equal(out[i], ref[i]), (legs, i)
                assert torch.equal(plain[i], ref[i]), (legs, i)


def test_device_args_must_lie_back_to_back():
    """The wrappers take the round and its shifts only as one device
    ``[rnd, o_0 ..]`` buffer (the kernel reads them from one address)."""
    rnd, offs = fused.tail_args(5, [1, 2, 3], "cpu")
    assert fused._device_args(rnd, offs, rnd.device) == rnd.data_ptr()
    with pytest.raises(ValueError, match="back to back"):
        fused._device_args(5, [1, 2, 3], rnd.device)
    with pytest.raises(ValueError, match="back to back"):
        fused._device_args(rnd, offs[1:], rnd.device)
    with pytest.raises(ValueError, match="back to back"):
        fused._device_args(7, offs, rnd.device)


@pytest.mark.parametrize("bad", ["fanout", "budget", "range", "ndev",
                                 "args"])
def test_entry_points_refuse_what_they_do_not_take(libs, bad):
    S, L, ndev = 2, 16, 2
    buf = torch.zeros((ndev, S, L), dtype=torch.uint8)
    mf = torch.zeros(ndev * L, dtype=torch.int32)
    rx = torch.ones(ndev * L, dtype=torch.bool)
    cap = torch.zeros(S, dtype=torch.int32)
    args = torch.ones(10, dtype=torch.int32)
    kw = dict(fanout=1, budget=3, i0=0, i1=ndev, ndev=ndev,
              args=_ptr(args))
    kw[bad] = {"fanout": 9, "budget": 15, "range": ndev + 1, "ndev": 65,
               "args": None}[bad]
    if bad == "range":
        kw["i1"] = kw.pop("range")
    ptrs = (ctypes.c_void_p * 65)(*([buf[0].data_ptr()] * 65))
    rc = libs["fused_merge"](ptrs, kw["ndev"], _ptr(buf), _ptr(mf), _ptr(rx),
                             _ptr(cap), None, S, L, kw["fanout"], kw["args"],
                             kw["budget"], kw["i0"], kw["i1"], None)
    assert rc != 0


SASS_SAMPLE = """
        Function : _ZN11dissem_tail11tail_kernelILi3EEEvNS_4ArgsE
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LOP3.LUT R2, R3, 0xf0f0f0f, RZ, 0xc0, !PT ;
        /*0018*/                   LOP3.LUT R2, R3, 0xf0f0f0f, RZ, 0xc0, !PT ;
        /*001c*/                   LOP3.LUT R2, R3, 0xf0f0f0f, RZ, 0xc0, !PT ;
        /*0020*/                   BRA 0x0000 ;
        /*0030*/                   LOP3.LUT P0, RZ, R8, 0xf, RZ, 0xc0, !PT ;
        /*0038*/               @P0 LDG.E.128 R4, desc[UR4][R2.64] ;
        /*003c*/              @!P0 LDG.E R4, desc[UR4][R2.64] ;
        /*0040*/              @!P0 LDG.E R5, desc[UR4][R2.64+0x4] ;
        /*0044*/              @!P0 IADD3 R9, R2, 0x4, RZ ;
        /*0048*/                   LOP3.LUT R2, R3, 0xf0f0f0f, RZ, 0xc0, !PT ;
        /*0050*/                   IADD3 R5, R2, 0x1010101, RZ ;
        /*0054*/                   IMAD.IADD R5, R2, 0x1, R7 ;
        /*0058*/                   VIADD R6, R6, 0x1 ;
        /*0060*/                   LOP3.LUT R6, R5, R7, RZ, 0xc0, !PT ;
        /*0068*/                   ISETP.GE.AND P1, PT, R6, R10, PT ;
        /*0070*/              @!P1 BRA 0x0030 ;
        /*0080*/                   EXIT ;
        Function : _ZN11dissem_tail11tail_kernelILi1EEEvNS_4ArgsE
        /*0000*/                   EXIT ;
"""


def test_sass_count_takes_the_word_loop():
    """The row loop is found by its 16-byte load; one alignment way is
    counted (the other's guarded instructions are left out); IMAD goes to
    the FMA unit, VIADD to the less busy unit."""
    from consul_tpu_torch import sass_count
    got = sass_count.row_loop_counts(SASS_SAMPLE, 3)
    assert got["loop"] == ["0x30", "0x70"]
    assert got["instructions_in_loop"] == 12
    assert got["guarded_in_loop"] == 5
    assert got["predicates"]["P0"] is True
    # LOP3 x3, IADD3, ISETP on the ALU; IMAD on the FMA unit; one VIADD.
    assert (got["integer_alu"], got["fma"], got["flexible"]) == (5, 1, 1)
    assert got["busiest_unit"] == 5
    assert got["memory"] == 1
    assert got["integer_alu_per_word"] == 1.25
    assert got["busiest_unit_per_word"] == 1.25
