"""The round program's table kernel on the CPU: ``csrc/round_table.cu``
(with the hash of ``csrc/threefry.cuh``) compiled by the host's C++
compiler against a stand-in for the CUDA runtime
(``tests/torch_host_lanes.py``) whose launches run each block's lanes as
fibers that meet at the warp's barrier in every ``__shfl_sync``, so a row's
group of lanes hands its keys from level to level as on the card.

Each launch goes through the port's own argument packing
(``round_table._launch``: the jobs as ``round_table::Job``, the keys' words,
randint's span and multiplier, the variant rule's scalars) and is held
word for word (tolerance 0) against the plain versions: every column of
``round_args.build`` (the round's layout, with flight-ring cursors),
``build_events`` and ``build_pools`` (P pools in one launch), under
``lan_profile`` and ``wan_profile`` parameters and fanouts and helpers of
1, 3 and 64 (8 to 32 lanes a row, levels wider than the group), 0 to 512
rows (groups and blocks partly filled), the first round at 0, 149 and
2**31 - 512, several keys, jobs of different widths in one launch; the
variant column against ``kernel.round_variant`` per row (and its host
mirror ``kernel.variant_codes``) on every nemesis catalog schedule; the
loop counters the launch resets.  Needs ``g++``; builds once into the
module's temporary directory.
"""

import ctypes
import dataclasses
import shutil
import subprocess

import numpy as np
import pytest
import torch
from torch_host_lanes import CUDA_STUB

from consul_tpu_torch import _build, prng
from consul_tpu_torch.gossip import kernel as tk
from consul_tpu_torch.gossip import nemesis, probe, round_args, round_table
from consul_tpu_torch.gossip.params import lan_profile, wan_profile

LAUNCH = ("table_kernel<<<grid, kBlock, 0, "
          "static_cast<cudaStream_t>(stream)>>>(a);")
HOST = "(void)stream; host_launch(table_kernel, grid, dim3(kBlock), a);"

KEYS = [prng.key(0), prng.fold_in(prng.key(7), 2),
        np.asarray([0x80000000, 1], np.uint32),
        np.asarray([0xFFFFFFFF, 0xDEADBEEF], np.uint32)]
PARAMS = {"lan_1000": lan_profile(1000), "lan_1m": lan_profile(1_000_000),
          "wan_48": wan_profile(48),
          # One lane's items a level and the group's widest: a row's 8 and
          # 32 lanes, and levels of 72 and 65 items over 32 lanes.
          "f1_k1": dataclasses.replace(lan_profile(1000), fanout=1,
                                       indirect_k=1),
          "f64_k64": dataclasses.replace(lan_profile(5000), fanout=64,
                                         indirect_k=64)}
# Rows: one, a group's worth and one either side at 16 lanes (two rows a
# warp), a chunk; 0 resets only the counters.
STEPS = [0, 1, 30, 31, 32, 33, 512]
RND0 = (0, 149, 2**31 - 512)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel for the host")
    d = tmp_path_factory.mktemp("round_table_on_host")
    (d / "cuda_runtime.h").write_text(CUDA_STUB)
    body = (_build.CSRC / "round_table.cu").read_text()
    assert body.count(LAUNCH) == 1
    src = d / "round_table.cpp"
    src.write_text(body.replace(LAUNCH, HOST))
    so = d / "libround_table.so"
    r = subprocess.run(["g++", "-std=c++17", "-O2", "-shared", "-fPIC",
                        f"-I{d}", f"-I{_build.CSRC}", "-o", str(so),
                        str(src)],
                       capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr
    return ctypes.CDLL(str(so))


@pytest.fixture
def on_host(lib, monkeypatch):
    """The wrapper's launches go to the host build, stream None."""
    fn, err = lib.round_table_fill, lib.round_table_error
    fn.argtypes = [ctypes.POINTER(round_table._Args), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p

    def launch(fn, err, name, dev, *args):
        rc = fn(*args, None)
        if rc != 0:
            raise RuntimeError(f"{name} launch failed: {err(rc).decode()}")

    monkeypatch.setattr(round_table, "_lib", lambda: (fn, err))
    monkeypatch.setattr(_build, "launch", launch)
    return lib


def _round_job(p, key, rnd0, rows, **kw):
    lay = round_args.layout(p.fanout, p.indirect_k)
    return round_table.Job(p, key, rnd0, torch.full(
        (rows + 3, lay.width), -7, dtype=torch.int32), **kw)


def _event_job(p, key, rnd0, rows):
    width = round_args.event_layout(p.fanout).width
    return round_table.Job(p, key, rnd0, torch.full((rows + 3, width), -7,
                                                    dtype=torch.int32),
                           events=True)


@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("rnd0", RND0)
@pytest.mark.parametrize("name", list(PARAMS))
def test_round_rows_match_build(on_host, name, rnd0, steps):
    """Every column of the round's layout, rows past the chunk untouched,
    with the flight ring's cursor anywhere in a ring of 256 and without a
    ring."""
    p = PARAMS[name]
    for i, key in enumerate(KEYS):
        cursor, ring = (0, 1) if i == 0 else (37 * i + steps, 256)
        j = _round_job(p, key, rnd0, steps, cursor=cursor, ring=ring)
        round_table._launch([j], steps)
        want = round_args.build(p, key, rnd0, steps, cursor, ring)
        assert np.array_equal(j.table[:steps].numpy(), want), (name, i)
        assert bool((j.table[steps:] == -7).all())


@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("rnd0", RND0)
@pytest.mark.parametrize("name", list(PARAMS))
def test_event_rows_match_build_events(on_host, name, rnd0, steps):
    p = PARAMS[name]
    for key in KEYS:
        j = _event_job(p, key, rnd0, steps)
        round_table._launch([j], steps)
        want = round_args.build_events(p, key, rnd0, steps)
        assert np.array_equal(j.table[:steps].numpy(), want), name


@pytest.mark.parametrize("events", [False, True])
@pytest.mark.parametrize("steps", [1, 30])
def test_pools_in_one_launch_match_build_pools(on_host, events, steps):
    """P pools of one parameter set, each its key and first round, in one
    launch (and 18 pools in two: a launch takes 16), against
    ``build_pools``'s one vectorised pass."""
    p = PARAMS["lan_1000"]
    for P in (3, 18):
        keys = np.stack([prng.fold_in(prng.key(11), d) for d in range(P)])
        rnd0s = [(41 * d) % 200 for d in range(P)]
        make = _event_job if events else _round_job
        jobs = [make(p, keys[d], rnd0s[d], steps) for d in range(P)]
        launches = round_table.launches
        round_table._launch(jobs, steps)
        assert round_table.launches - launches == -(-P // 16)
        want = round_args.build_pools(p, keys, rnd0s, steps, events=events)
        for d, j in enumerate(jobs):
            assert np.array_equal(j.table[:steps].numpy(), want[d]), d


@pytest.mark.parametrize("mix", [("lan_1000", "wan_48"),
                                 ("f64_k64", "f1_k1"), ("f1_k1", "lan_1m")])
def test_a_launch_mixes_layouts_and_sets_the_counters(on_host, mix):
    """The multi-DC call's launch: LAN round and event tables and the WAN
    pool's in one (and pools of other widths, 8, 16 and 32 lanes a row in
    one grid); each program's rounds left set to the rows and its row
    counter to 0, and with no row only those."""
    lan, wan = PARAMS[mix[0]], PARAMS[mix[1]]
    key = prng.key(3)
    lefts = [torch.full((1,), -1, dtype=torch.int32) for _ in range(4)]
    steps = [torch.full((1,), 99, dtype=torch.int64) for _ in range(4)]
    for rows in (7, 33, 0):
        jobs = [_round_job(lan, key, 5, rows)._replace(left=lefts[0],
                                                       step=steps[0]),
                _event_job(lan, key, 6, rows)._replace(step=steps[1]),
                _round_job(wan, key, 7, rows)._replace(left=lefts[2],
                                                       step=steps[2]),
                _event_job(wan, key, 8, rows)._replace(step=steps[3])]
        round_table._launch(jobs, rows)
        assert [int(t) for t in lefts] == [rows, -1, rows, -1]
        assert [int(t) for t in steps] == [0] * 4
        for j in jobs:
            build = round_args.build_events if j.events else round_args.build
            assert np.array_equal(j.table[:rows].numpy(),
                                  build(j.p, key, j.rnd0, rows))
            assert bool((j.table[rows:] == -7).all())
        for t in steps:
            t.fill_(99)


@pytest.mark.parametrize("name", sorted(nemesis.CATALOG))
def test_variant_column_matches_round_variant(on_host, name):
    """Every catalog schedule at 16,000 nodes (and push/pull every 150
    rounds), over the rounds around its window and at the int32 edge: the
    kernel's column, the host mirror and ``round_variant`` agree row for
    row, and the column meets every variant the schedule makes."""
    p = lan_profile(16_000)
    sc = nemesis.build(name, 16_000)
    seen = set()
    for rnd0, steps in ((0, 512), (300, 30), (2**31 - 512, 512)):
        j = _round_job(p, KEYS[1], rnd0, steps)._replace(
            variant=torch.full((steps + 2,), -1, dtype=torch.int32),
            nem=sc.nem)
        round_table._launch([j], steps)
        want = [tk.variant_code(tk.round_variant(p, sc.nem, rnd0 + k))
                for k in range(steps)]
        assert j.variant[:steps].tolist() == want, (name, rnd0)
        assert tk.variant_codes(p, sc.nem, rnd0, steps).tolist() == want
        assert j.variant[steps:].tolist() == [-1, -1]
        seen |= set(want)
    assert {tk.variant_code(tk.variant_of(c)) for c in seen} == seen
    assert any(c & 2 for c in seen) and any(c & 1 for c in seen), seen


@pytest.mark.parametrize("edge", [0, 1, -1])
def test_variant_column_at_the_degraded_blocks_edges(on_host, edge):
    """Schedules whose degraded range starts and ends on a prober block's
    edge (and one id inside or outside it), with a flapping square wave
    of odd period and push/pull every 7 rounds: the kernel's column and
    the host mirror equal ``round_variant`` on every row."""
    p = lan_profile(16_000, pushpull_every=7)
    B = probe.block_size(p)
    nem = nemesis.NemesisParams(
        scenario="edges", start=5, stop=300, obs_lo=B + edge,
        obs_hi=3 * B + edge, p_obs_miss=0.5, flap_lo=10, flap_hi=20,
        flap_period=7, flap_up=3)
    assert nem.has_degraded and nem.has_flap and p.probe_every > 3
    j = _round_job(p, KEYS[0], 0, 320)._replace(
        variant=torch.zeros(320, dtype=torch.int32), nem=nem)
    round_table._launch([j], 320)
    want = [tk.variant_code(tk.round_variant(p, nem, k)) for k in range(320)]
    assert j.variant.tolist() == want
    assert tk.variant_codes(p, nem, 0, 320).tolist() == want
    assert len(set(want)) >= 8


def test_variant_codes_round_trip():
    for code in range(tk.VARIANT_CODES):
        assert tk.variant_code(tk.variant_of(code)) == code


def test_fill_on_cpu_is_the_plain_version():
    """``fill`` on CPU tensors runs ``fill_ref`` (no kernel launch): the
    host twin's rows, ``variant_codes``, the counters."""
    p = PARAMS["lan_1000"]
    sc = nemesis.build("flapping", 1000)
    left = torch.zeros(1, dtype=torch.int32)
    step = torch.ones(1, dtype=torch.int64)
    j = _round_job(p, KEYS[2], 20, 30, cursor=5, ring=8)._replace(
        variant=torch.zeros(30, dtype=torch.int32), nem=sc.nem, left=left,
        step=step)
    launches = round_table.launches
    round_table.fill([j], 30)
    assert round_table.launches == launches
    assert np.array_equal(j.table[:30].numpy(),
                          round_args.build(p, KEYS[2], 20, 30, 5, 8))
    assert j.variant.tolist() == tk.variant_codes(p, sc.nem, 20, 30).tolist()
    assert int(left) == 30 and int(step) == 0


def test_bad_jobs_are_refused(on_host):
    p = PARAMS["lan_1000"]
    j = _round_job(p, KEYS[0], 0, 4)
    with pytest.raises(ValueError, match="rows of"):
        round_table._launch([j._replace(table=j.table[:, :-1].contiguous())],
                            4)
    with pytest.raises(OverflowError):
        round_table._launch([j._replace(rnd0=2**31 - 3)], 4)
