"""The draws' Hopper kernel on the CPU: ``csrc/threefry.cu`` (its body and
every entry point, with the hash of ``csrc/threefry.cuh``) compiled by the
host's C++ compiler against a small stand-in for the CUDA runtime, which
runs the grid one thread at a time.

Each launch goes through the port's own wrappers (``prng._bits_into``,
``_uniform_into``, ``_below_into``, ``_randint_into``, ``_edge_drops_into``:
the key words, the sub-keys, span and multiplier, the row keys and the
legs' shifts as the card gets them) and is held bit for bit (tolerance 0)
against the plain torch versions (``random_bits_ref``, ``uniform_ref``,
``uniform_rows_ref``, ``randint_ref``, ``below_ref``, ``edge_drops_ref``)
and against ``jax.random`` on the CPU.  Lengths of 1, odd lengths, lengths
that are not a multiple of the block, one past the grid's cap (threads that
stride), ``[B, 3]``, keys with the high bit set.  Needs ``g++``; builds into
the test's temporary directory.
"""

import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consul_tpu_torch import _build, prng

CUDA_STUB = r"""
#pragma once
#include <cstdint>
#include <cstring>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline dim3 blockIdx, threadIdx, blockDim, gridDim;
inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, uint32_t sh) {
  return static_cast<uint32_t>(
      (((static_cast<uint64_t>(hi) << 32) | lo) << (sh & 31)) >> 32);
}
inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t e) {
  return e ? "invalid argument" : "no error";
}
"""

LAUNCH = "draw_kernel<M><<<grid, kThreads, 0, stream>>>(a);"
SERIAL = ("(void)stream; gridDim = grid; blockDim = dim3(kThreads);"
          " for (unsigned by = 0; by < grid.y; ++by)"
          " for (unsigned bx = 0; bx < grid.x; ++bx)"
          " for (unsigned t = 0; t < kThreads; ++t) {"
          " blockIdx = dim3(bx, by); threadIdx = dim3(t);"
          " draw_kernel<M>(a); }")

# Keys: the round's (fold_in chains of small seeds), and raw key words
# with the high bit set in one or both.
KEYS = [prng.key(0), prng.fold_in(prng.key(7), 2),
        np.asarray([0x80000000, 1], np.uint32),
        np.asarray([0xFFFFFFFF, 0xDEADBEEF], np.uint32)]
SHAPES = [(1,), (7,), (255,), (257,), (4099,), (48, 3), (1001, 3)]
# One past the grid's cap of 1,056 blocks of 256: threads stride.
STRIDED = 1056 * 256 + 3


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel for the host")
    d = tmp_path_factory.mktemp("threefry_on_host")
    (d / "cuda_runtime.h").write_text(CUDA_STUB)
    body = (_build.CSRC / "threefry.cu").read_text()
    assert body.count(LAUNCH) == 1
    src = d / "threefry.cpp"
    src.write_text(body.replace(LAUNCH, SERIAL))
    so = d / "libthreefry.so"
    r = subprocess.run(["g++", "-std=c++17", "-O2", "-shared", "-fPIC",
                        f"-I{d}", f"-I{_build.CSRC}", "-o", str(so),
                        str(src)],
                       capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr
    return ctypes.CDLL(str(so))


def _typed(lib, name):
    fn, err = getattr(lib, name), lib.threefry_error
    fn.argtypes, fn.restype = prng._ARGTYPES[name], ctypes.c_int
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    return fn, err


@pytest.fixture
def on_host(lib, monkeypatch):
    """The wrappers' launches go to the host build, stream None."""
    def launch(fn, err, name, dev, *args):
        rc = fn(*args, None)
        assert rc == 0, err(rc)
    monkeypatch.setattr(prng, "_lib", lambda name: _typed(lib, name))
    monkeypatch.setattr(_build, "launch", launch)
    return lib


def _jkey(k):
    return jax.random.wrap_key_data(jnp.asarray(k, jnp.uint32))


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize
    width = {1: np.uint8, 4: np.uint32, 8: np.uint64}[a.dtype.itemsize]
    return np.array_equal(a.view(width), b.view(width))


@pytest.mark.parametrize("shape", SHAPES)
def test_bits(on_host, shape):
    for k in KEYS:
        out = torch.empty(shape, dtype=torch.int64)
        prng._bits_into(out, k)
        want = np.asarray(jax.random.bits(_jkey(k), shape, jnp.uint32))
        assert torch.equal(out, prng.random_bits_ref(k, shape, "cpu"))
        assert torch.equal(out, prng.random_bits_tensor(k, shape, "cpu"))
        assert np.array_equal(out.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("shape", SHAPES + [(STRIDED,)])
def test_uniform(on_host, shape):
    for k in KEYS if shape != (STRIDED,) else KEYS[1:2]:
        out = torch.empty(shape, dtype=torch.float32)
        prng._uniform_into(out, [k])
        assert _same_bits(out, prng.uniform_ref(k, shape, "cpu"))
        assert _same_bits(out, jax.random.uniform(_jkey(k), shape))


@pytest.mark.parametrize("rows", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [1, 7, 4099])
def test_uniform_rows(on_host, rows, n):
    keys = [prng.fold_in(KEYS[3], f) for f in range(rows - 1)] + [KEYS[2]]
    out = torch.empty((rows, n), dtype=torch.float32)
    prng._uniform_into(out, keys)
    assert _same_bits(out, prng.uniform_rows_ref(keys, n, "cpu"))
    for r, k in enumerate(keys):
        assert _same_bits(out[r], jax.random.uniform(_jkey(k), (n,))), r


@pytest.mark.parametrize("p", [0.0, 2.0**-24, 0.5, 1.0 - 2.0**-24, 1.0,
                               0.010000000000000009])
@pytest.mark.parametrize("shape", [(1,), (4099,), (1001, 3)])
def test_below(on_host, shape, p):
    for k in KEYS:
        out = torch.empty(shape, dtype=torch.bool)
        prng._below_into(out, k, p)
        assert torch.equal(out, prng.below_ref(k, shape, p, "cpu"))
        want = np.asarray(jax.random.uniform(_jkey(k), shape) < p)
        assert np.array_equal(out.numpy(), want)


@pytest.mark.parametrize("lo, hi", [(0, 1), (1, 3), (1, 1000),
                                    (1, 1_000_000), (-500, 499),
                                    (-2**31, 2**31 - 1), (5, 2)])
@pytest.mark.parametrize("shape", [(1,), (7,), (4099,), (48, 3)])
def test_randint(on_host, shape, lo, hi):
    """Spans 1, 2, 999 and 999,999, a negative minval, the whole int32
    range and an empty span (maxval <= minval gives minval)."""
    for k in KEYS:
        out = torch.empty(shape, dtype=torch.int32)
        prng._randint_into(out, k, lo, hi)
        assert torch.equal(out, prng.randint_ref(k, shape, lo, hi, "cpu"))
        want = np.asarray(jax.random.randint(_jkey(k), shape, lo, hi,
                                             jnp.int32))
        assert np.array_equal(out.numpy(), want)


def _groups(kind, n, seed):
    ids = np.arange(n, dtype=np.int64)
    if kind == "hash":
        g = ((ids * 2654435761) & 0xFFFFFFFF) >> 31
    elif kind == "half":
        g = ids >= n // 2
    else:
        g = np.random.default_rng(seed).random(n) < 0.3
    return torch.from_numpy(g.astype(np.int32))


@pytest.mark.parametrize("p_ab, p_ba", [(1.0, 1.0), (0.0, 0.0), (1.0, 0.0),
                                        (0.0, 1.0), (0.6, 0.3), (0.6, 1.0),
                                        (0.0, 0.45)])
@pytest.mark.parametrize("kind, n", [("hash", 4099), ("half", 1000),
                                     ("random", 257), ("half", 1)])
def test_edge_drops(on_host, kind, n, p_ab, p_ba):
    """Both certain-outcome directions, certain and drawn directions
    mixed, shifts above n, negative and zero; 1 to 3 legs."""
    grp = _groups(kind, n, n)
    keys = [prng.fold_in(KEYS[1], f) for f in range(3)]
    for shifts in ([1], [n - 1, -(n // 3)], [0, n + 5, 2 * n - 1]):
        legs = keys[:len(shifts)]
        out = torch.empty((len(shifts), n), dtype=torch.bool)
        prng._edge_drops_into(out, legs, grp, shifts, p_ab, p_ba)
        ref = prng.edge_drops_ref(legs, grp, shifts, p_ab, p_ba)
        assert torch.equal(out, ref), shifts


def _dev_keys(keys):
    """Row keys as a table row holds them: int32 words, [rows, 2]."""
    return torch.from_numpy(np.asarray(keys, np.uint32).reshape(-1, 2)
                            .view(np.int32).copy())


@pytest.mark.parametrize("shape", [(1,), (257,), (1001, 3)])
def test_device_keys_match_by_value(on_host, shape):
    """Keys read from memory (the round's table row) give the by-value
    launch's bits: uniform, uniform rows, below."""
    for k in KEYS:
        a, b = (torch.empty(shape, dtype=torch.float32) for _ in range(2))
        prng._uniform_into(a, [k])
        prng._uniform_into(b, _dev_keys([k]))
        assert _same_bits(a, b)
        c, d = (torch.empty(shape, dtype=torch.bool) for _ in range(2))
        prng._below_into(c, k, 0.3)
        prng._below_into(d, _dev_keys([k])[0], 0.3)
        assert torch.equal(c, d)
        assert torch.equal(d, prng.below_ref(_dev_keys([k])[0], shape, 0.3,
                                             "cpu"))
    rows = [prng.fold_in(KEYS[3], f) for f in range(3)]
    a, b = (torch.empty((3, shape[0]), dtype=torch.float32) for _ in range(2))
    prng._uniform_into(a, rows)
    prng._uniform_into(b, _dev_keys(rows))
    assert _same_bits(a, b)
    assert _same_bits(b, prng.uniform_rows_ref(_dev_keys(rows), shape[0],
                                               "cpu"))


@pytest.mark.parametrize("p_ab, p_ba", [(1.0, 1.0), (0.6, 0.3), (0.0, 0.45)])
@pytest.mark.parametrize("kind, n", [("hash", 4099), ("half", 1000)])
def test_edge_drops_device_keys_and_shifts(on_host, kind, n, p_ab, p_ba):
    """Keys and shifts read from memory (any int32 shift, reduced mod n in
    the kernel) give the by-value launch's mask, and the plain version
    takes the same tensors."""
    grp = _groups(kind, n, n)
    keys = [prng.fold_in(KEYS[1], f) for f in range(3)]
    for shifts in ([1], [n - 1, -(n // 3)], [5, n + 5, -(2 * n) + 7]):
        legs = keys[:len(shifts)]
        want = torch.empty((len(shifts), n), dtype=torch.bool)
        prng._edge_drops_into(want, legs, grp, shifts, p_ab, p_ba)
        got = torch.empty_like(want)
        d_shifts = torch.tensor(shifts, dtype=torch.int32)
        prng._edge_drops_into(got, _dev_keys(legs), grp, d_shifts, p_ab,
                              p_ba)
        assert torch.equal(got, want), shifts
        assert torch.equal(prng.edge_drops_ref(_dev_keys(legs), grp,
                                               d_shifts, p_ab, p_ba), want)


def test_launches_counted(on_host):
    """One count and one recorded shape a launch; an edge-drops launch
    also records the group vector it was given."""
    n0 = prng.launches
    prng._uniform_into(torch.empty((5,)), [KEYS[0]])
    prng._below_into(torch.empty((5,), dtype=torch.bool), KEYS[0], 0.5)
    grp = _groups("half", 6, 0)
    prng._edge_drops_into(torch.empty((2, 6), dtype=torch.bool),
                          KEYS[:2], grp, [1, -1], 0.5, 1.0)
    assert prng.launches == n0 + 3
    assert ("uniform", (5,), 1) in prng.launch_shapes
    assert ("below", (5,), 0.5) in prng.launch_shapes
    assert ("edge_drops", (2, 6), 0.5, 1.0, id(grp)) in prng.launch_shapes
    assert prng.launch_groups[id(grp)] is grp


@pytest.mark.parametrize("bad", ["rows0", "rows17", "n0", "n_big", "span0"])
def test_entry_points_refuse_what_they_do_not_take(lib, bad):
    keys = (ctypes.c_uint32 * 34)(*([1] * 34))
    shifts = (ctypes.c_int64 * 17)(*([1] * 17))
    out = torch.empty(64, dtype=torch.int64)
    if bad == "span0":
        fn, _ = _typed(lib, "threefry_randint")
        assert fn(1, 2, 3, 4, 8, 0, 0, 0, out.data_ptr(), None) != 0
        return
    rows = {"rows0": 0, "rows17": 17}.get(bad, 1)
    n = {"n0": 0, "n_big": 2**32 + 1}.get(bad, 8)
    up, _ = _typed(lib, "threefry_uniform")
    ed, _ = _typed(lib, "threefry_edge_drops")
    assert up(keys, rows, n, out.data_ptr(), None) != 0
    assert ed(keys, shifts, rows, n, out.data_ptr(), 0.5, 0.5,
              out.data_ptr(), None) != 0


@pytest.mark.parametrize("call", ["bits", "uniform", "rows", "randint",
                                  "below"])
def test_wrappers_raise_for_a_missing_card(call, monkeypatch):
    """Asked for a CUDA device where there is none, a draw raises; it
    never takes the plain version."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(prng, "random_bits_ref", None)
    monkeypatch.setattr(prng, "uniform_ref", None)
    monkeypatch.setattr(prng, "uniform_rows_ref", None)
    monkeypatch.setattr(prng, "randint_ref", None)
    monkeypatch.setattr(prng, "below_ref", None)
    k = KEYS[0]
    draw = {"bits": lambda: prng.random_bits_tensor(k, (4,), "cuda"),
            "uniform": lambda: prng.uniform_tensor(k, (4,), "cuda"),
            "rows": lambda: prng.uniform_rows([k, k], 4, "cuda"),
            "randint": lambda: prng.randint_tensor(k, (4,), 0, 9, "cuda"),
            "below": lambda: prng.below(k, (4,), 0.5, "cuda")}[call]
    with pytest.raises(RuntimeError, match="CUDA card"):
        draw()


@pytest.mark.parametrize("call", ["uniform", "rows", "below"])
def test_wrappers_refuse_counters_past_2_32(call):
    k = KEYS[0]
    draw = {"uniform": lambda: prng.uniform_tensor(k, (2**16, 2**16 + 1),
                                                   "cpu"),
            "rows": lambda: prng.uniform_rows([k], 2**32 + 1, "cpu"),
            "below": lambda: prng.below(k, (2**33,), 0.5, "cpu")}[call]
    with pytest.raises(ValueError, match="2\\*\\*32"):
        draw()


SASS_SAMPLE = """
        Function : _ZN8threefry11draw_kernelILi1EEEvNS_4ArgsE
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   ISETP.GE.U32.AND P0, PT, R0, UR4, PT ;
        /*0020*/               @P0 EXIT ;
        /*0030*/                   IADD3 R5, R0, UR6, RZ ;
        /*0040*/                   SHF.L.W.U32.HI R6, R5, 0xd, R5 ;
        /*0050*/                   LOP3.LUT R6, R6, R7, RZ, 0x3c, !PT ;
        /*0060*/                   IMAD.IADD R7, R7, 0x1, R6 ;
        /*0070*/                   FADD R8, R6, -1 ;
        /*0080*/                   STG.E desc[UR4][R2.64], R8 ;
        /*0090*/                   VIADD R0, R0, UR8 ;
        /*00a0*/                   ISETP.GE.U32.AND P0, PT, R0, UR4, PT ;
        /*00b0*/              @!P0 BRA 0x0030 ;
        /*00c0*/                   EXIT ;
        Function : _ZN8threefry11draw_kernelILi2EEEvNS_4ArgsE
        /*0000*/                   EXIT ;
"""


def test_sass_count_takes_the_draw_loop():
    """The grid-stride loop of draw_kernel<mode> is one element; IMAD goes
    to the FMA unit, VIADD to the less busy unit, FADD to neither."""
    from consul_tpu_torch import sass_count
    got = sass_count.draw_loop_counts(SASS_SAMPLE, 1)
    assert got["loop"] == ["0x30", "0xb0"]
    assert got["instructions_per_element"] == 9
    # IADD3, SHF, LOP3, ISETP on the ALU; IMAD on the FMA unit; one VIADD.
    assert (got["integer_alu"], got["fma"], got["flexible"]) == (4, 1, 1)
    assert got["busiest_unit_per_element"] == 4
    with pytest.raises(RuntimeError):
        sass_count.draw_loop_counts(SASS_SAMPLE, 2)
