"""The draws' Hopper kernel on the CPU: ``csrc/threefry.cu`` (its body and
every entry point, with the hash of ``csrc/threefry.cuh``) compiled by the
host's C++ compiler against a stand-in for the CUDA runtime
(``tests/torch_host_lanes.py``).  The draws but the edge drops run the
grid one thread at a time; the edge drops' launch runs each block's lanes
as fibers that meet at the warp's barrier in ``__ballot_sync`` and
``__syncwarp`` and at the block's in ``__syncthreads``, as the kernel's
compaction of uncertain edges and its staged spans need.

Each launch goes through the port's own wrappers (``prng._bits_into``,
``_uniform_into``, ``_below_into``, ``_randint_into``, ``_edge_drops_into``:
the key words, the sub-keys, span and multiplier, the row keys and the
legs' shifts as the card gets them) and is held bit for bit (tolerance 0)
against the plain torch versions (``random_bits_ref``, ``uniform_ref``,
``uniform_rows_ref``, ``randint_ref``, ``below_ref``, ``edge_drops_ref``)
and against ``jax.random`` on the CPU.  Lengths of 1, odd lengths, lengths
that are not a multiple of the block, one past the grid's cap (threads that
stride), ``[B, 3]``, keys with the high bit set.  The edge drops also at
lengths of 1, 15, 17, 4,099 and 16,001 (rows at every 16-byte phase),
probabilities 0, 2**-24, 0.6, 1 - 2**-24 and 1, a warp holding 0, 1, 31,
32 and 33 uncertain edges, and a second build with 64 threads a block and
a grid of at most 3 blocks (spans that stride).  Needs ``g++``; builds
into the test's temporary directory.
"""

import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_host_lanes import CUDA_STUB

from consul_tpu_torch import _build, prng

LAUNCH = "draw_kernel<M><<<grid, kThreads, 0, stream>>>(a);"
SERIAL = ("(void)stream; gridDim = grid; blockDim = dim3(kThreads);"
          " for (unsigned by = 0; by < grid.y; ++by)"
          " for (unsigned bx = 0; bx < grid.x; ++bx)"
          " for (unsigned t = 0; t < kThreads; ++t) {"
          " blockIdx = dim3(bx, by); threadIdx = dim3(t);"
          " draw_kernel<M>(a); }")
EDGES = "draw_kernel<kEdgeDrops><<<grid, kEdgeThreads, 0, stream>>>(a);"
EDGES_HOST = ("(void)stream; host_launch(draw_kernel<kEdgeDrops>, grid,"
              " dim3(kEdgeThreads), a);")
# The card's build (short rows take the narrow form, a thread a
# destination); the card's block always in the wide form (a block a span
# of 2,048 destinations of a leg); a narrow block: 64 threads (two warps,
# spans of 1,024) in a grid of at most 3 blocks, wide from 4 spans.
FILL = "constexpr int kFill = 132;"
BUILDS = {"card": {},
          "wide": {FILL: "constexpr int kFill = 1;"},
          "narrow": {"constexpr int kEdgeThreads = 128;":
                     "constexpr int kEdgeThreads = 64;",
                     "constexpr int kMaxBlocks = 1056;":
                     "constexpr int kMaxBlocks = 3;",
                     FILL: "constexpr int kFill = 4;"}}

# Keys: the round's (fold_in chains of small seeds), and raw key words
# with the high bit set in one or both.
KEYS = [prng.key(0), prng.fold_in(prng.key(7), 2),
        np.asarray([0x80000000, 1], np.uint32),
        np.asarray([0xFFFFFFFF, 0xDEADBEEF], np.uint32)]
SHAPES = [(1,), (7,), (255,), (257,), (4099,), (48, 3), (1001, 3)]
# One past the grid's cap of 1,056 blocks of 256: threads stride.
STRIDED = 1056 * 256 + 3


def _host_lib(d, name, edits):
    """``threefry.cu`` built for the host in ``d`` with ``edits`` (source
    text -> replacement) made."""
    (d / "cuda_runtime.h").write_text(CUDA_STUB)
    body = (_build.CSRC / "threefry.cu").read_text()
    for text, host in {LAUNCH: SERIAL, EDGES: EDGES_HOST, **edits}.items():
        assert body.count(text) == 1, text
        body = body.replace(text, host)
    src = d / f"{name}.cpp"
    src.write_text(body)
    so = d / f"lib{name}.so"
    # -fno-gnu-unique: the builds' shared arrays (statics here) stay apart.
    r = subprocess.run(["g++", "-std=c++17", "-O2", "-shared", "-fPIC",
                        "-fno-gnu-unique", f"-I{d}", f"-I{_build.CSRC}",
                        "-o", str(so), str(src)],
                       capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    """The host builds by name, each built on first use."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel for the host")
    made = {}

    def get(name):
        if name not in made:
            made[name] = _host_lib(
                tmp_path_factory.mktemp(f"threefry_{name}"),
                f"threefry_{name}", BUILDS[name])
        return made[name]
    return get


@pytest.fixture(scope="module")
def lib(builds):
    return builds("card")


def _typed(lib, name):
    fn, err = getattr(lib, name), lib.threefry_error
    fn.argtypes, fn.restype = prng._ARGTYPES[name], ctypes.c_int
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    return fn, err


@pytest.fixture
def on_host(lib, monkeypatch):
    """The wrappers' launches go to the host build, stream None."""
    return _route(lib, monkeypatch)


def _route(lib, monkeypatch):
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


# Both directions' probabilities: certain (0, 1), drawn, the drawn ones
# nearest the certain (2**-24, 1 - 2**-24), asym_loss's (0.6, 0).
EDGE_P = [(1.0, 1.0), (0.0, 0.0), (1.0, 0.0), (0.0, 1.0), (0.6, 0.3),
          (0.6, 1.0), (0.0, 0.45), (2.0**-24, 1.0 - 2.0**-24),
          (1.0 - 2.0**-24, 2.0**-24), (0.6, 0.0)]


@pytest.mark.parametrize("p_ab, p_ba", EDGE_P)
@pytest.mark.parametrize("kind, n", [("hash", 4099), ("half", 1000),
                                     ("random", 257), ("half", 1),
                                     ("hash", 15), ("half", 17),
                                     ("random", 16_001)])
def test_edge_drops(on_host, kind, n, p_ab, p_ba):
    """Both certain-outcome directions, certain and drawn directions
    mixed, shifts above n, negative and zero; 1 to 3 legs; rows shorter
    than a 16-byte store and rows at every 16-byte phase."""
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


@pytest.mark.parametrize("p_ab, p_ba", [(1.0, 1.0), (0.6, 0.3), (0.0, 0.45),
                                        (2.0**-24, 1.0 - 2.0**-24)])
@pytest.mark.parametrize("kind, n", [("hash", 4099), ("half", 1000),
                                     ("hash", 17), ("random", 16_001)])
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


@pytest.mark.parametrize("build", ["card", "wide", "narrow"])
@pytest.mark.parametrize("count", [0, 1, 31, 32, 33, 64, 65, 128, 129, 257])
def test_edge_drops_uncertain_runs(builds, monkeypatch, build, count):
    """``count`` uncertain edges on consecutive destinations from 0 (a
    warp's lanes holding 0, 1, 31, 32 and 33 of them; the block's list of
    them one past a round of 64, 128 and 256 threads): group 1 there, 0
    elsewhere, along shift 512 at p_ab 0.6, so that the edges from those
    nodes (p_ba 0) are certain; a second leg's row starts 3 bytes past a
    16-byte boundary.  Equal to the plain version, which draws as many
    uniforms."""
    _route(builds(build), monkeypatch)
    n = 4099
    grp = torch.zeros(n, dtype=torch.int32)
    grp[:count] = 1
    keys = [prng.fold_in(KEYS[2], f) for f in range(2)]
    out = torch.empty((2, n), dtype=torch.bool)
    prng._edge_drops_into(out, keys, grp, [512, 512], 0.6, 0.0)
    want = prng.edge_drops_ref(keys, grp, [512, 512], 0.6, 0.0)
    assert torch.equal(out, want)
    uncertain = (torch.roll(grp, 512) == 0) & (grp != 0)
    assert int(uncertain.sum()) == count
    assert not bool((out & ~uncertain).any())


@pytest.mark.parametrize("p_ab, p_ba", [(1.0, 1.0), (0.6, 0.3), (0.6, 0.0),
                                        (2.0**-24, 1.0 - 2.0**-24)])
@pytest.mark.parametrize("kind, n", [("hash", 4099), ("random", 16_001),
                                     ("half", 17)])
@pytest.mark.parametrize("build", ["wide", "narrow"])
def test_edge_drops_other_blocks(builds, monkeypatch, build, kind, n, p_ab,
                                 p_ba):
    """The wide form (a block a span of a leg: 2,048 destinations, or
    1,024 in two warps), and in the narrow build a grid of at most 3 blocks
    whose blocks stride over a row's spans (16 of them at 16,001, the
    narrow form's threads over 17 destinations); 1 to 3 legs, and 4, 7 and
    16 below 16,001, host and device shifts."""
    _route(builds(build), monkeypatch)
    grp = _groups(kind, n, n + 1)
    keys = [prng.fold_in(KEYS[3], f) for f in range(16)]
    # 1 to 3 legs, and 4, 7 and 16 but on the longest rows.
    more = [[(97 * f + 1) * (-1) ** f for f in range(legs)]
            for legs in (4, 7, 16) if n < 16_001]
    for shifts in ([n - 1], [7, -(n // 2)], [0, n + 9, -(2 * n) + 5],
                   *more):
        legs = keys[:len(shifts)]
        want = prng.edge_drops_ref(legs, grp, shifts, p_ab, p_ba)
        out = torch.empty_like(want)
        prng._edge_drops_into(out, legs, grp, shifts, p_ab, p_ba)
        assert torch.equal(out, want), shifts
        got = torch.empty_like(want)
        prng._edge_drops_into(got, _dev_keys(legs), grp,
                              torch.tensor(shifts, dtype=torch.int32),
                              p_ab, p_ba)
        assert torch.equal(got, want), shifts


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
