"""The port stands alone: no module of consul_tpu_torch and not
chip_smoke.py imports JAX or the JAX package; the copies it keeps match
the originals; its entry points refuse to fall back to the CPU."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401 — the reference side of the copy checks
import numpy as np
import pytest
import torch

import consul_tpu.obs.flight as j_flight
import consul_tpu.obs.hist as j_hist
from consul_tpu.gossip import kernel as jk
from consul_tpu.gossip import nemesis as j_nem
from consul_tpu.gossip import params as j_params
from consul_tpu.ops import divisibility as j_div
from consul_tpu_torch.gossip import fused
from consul_tpu_torch.gossip import kernel as tk
from consul_tpu_torch.gossip import nemesis as t_nem
from consul_tpu_torch.gossip import params as t_params
from consul_tpu_torch.obs import constants
from consul_tpu_torch.ops import divisibility as t_div

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(str(p.relative_to(REPO)) for p in
                    (REPO / "consul_tpu_torch").rglob("*.py")) + ["chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("rel", PORT_FILES)
def test_no_jax_or_reference_import(rel):
    for mod in _imported_modules(REPO / rel):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "consul_tpu"), f"{rel}: {mod}"


def test_copied_constants_match():
    assert constants.FLIGHT_COLS == j_flight.FLIGHT_COLS
    assert constants.N_COLS == j_flight.N_COLS
    assert constants.LATENCY_BUCKETS == j_hist.LATENCY_BUCKETS
    assert constants.SPREAD_BUCKETS == j_hist.SPREAD_BUCKETS
    for name in ("MSG_NONE", "MSG_SUSPECT", "MSG_DEAD", "MSG_REFUTE",
                 "PHASE_FREE", "PHASE_SUSPECT", "PHASE_DEAD",
                 "PHASE_REFUTED", "PHASE_JOIN", "NEVER", "_MSG_SHIFT",
                 "_CONF_SHIFT", "_CONF_MASK", "_AGE_MASK", "_AGE_FRESH"):
        assert getattr(tk, name) == getattr(jk, name), name


_DERIVED = ("log_n", "suspicion_min_rounds", "suspicion_max_rounds",
            "transmit_limit", "spread_budget_rounds", "event_ttl_rounds",
            "slot_ttl_rounds", "p_direct_fail_alive", "p_indirect_fail_alive")


@pytest.mark.parametrize("profile", ["SwimParams", "lan_profile",
                                     "wan_profile"])
@pytest.mark.parametrize("n", [2, 240, 4096, 1_000_000])
def test_params_copy_matches(profile, n):
    for kw in (dict(), dict(slots=64, loss_rate=0.1, max_confirmations=5),
               dict(pushpull_every=0, hot_slots=3, dissem="fused")):
        a = getattr(j_params, profile)(n=n, **kw)
        b = getattr(t_params, profile)(n=n, **kw)
        for f in a.__dataclass_fields__:
            assert getattr(a, f) == getattr(b, f), f
        assert set(a.__dataclass_fields__) == set(b.__dataclass_fields__)
        for prop in _DERIVED:
            assert getattr(a, prop) == getattr(b, prop), prop
        assert np.array_equal(a.timeout_table(), b.timeout_table())


def test_divisibility_copy_matches():
    for n, d in ((24, 7), (24, 4), (5, 0), (1_000_000, 3)):
        assert j_div.divides(n, d) == t_div.divides(n, d)
        errs = []
        for mod in (j_div, t_div):
            try:
                mod.require_divisible(n, d, what="n", by="fused_nb")
                errs.append(None)
            except ValueError as e:
                errs.append(str(e))
        assert errs[0] == errs[1]


def test_nemesis_copy_matches():
    """The catalog copy builds the reference's scenarios (and its group
    bits, its errors) at every size, and its code is the original's
    statement for statement: only docstrings differ."""
    def code(mod):
        tree = ast.parse(Path(mod.__file__).read_text())
        for node in ast.walk(tree):
            body = getattr(node, "body", None)
            if (isinstance(body, list) and body
                    and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:]
        return ast.dump(tree)

    assert code(t_nem) == code(j_nem)
    assert t_nem.names() == j_nem.names()
    assert int(t_nem.NEVER) == int(j_nem.NEVER)
    for n in (2, 160, 320, 4096, 1_000_000):
        for name in j_nem.names():
            a, b = j_nem.build(name, n), t_nem.build(name, n)
            assert a.name == b.name and a.steps == b.steps
            assert a.description == b.description
            assert a.nem == j_nem.NemesisParams(**vars(b.nem))
            for prop in ("has_partition", "has_flap", "has_degraded",
                         "needs_state", "needs_join", "p_roundtrip"):
                assert getattr(a.nem, prop) == getattr(b.nem, prop), prop
            assert np.array_equal(a.fail_round, b.fail_round)
            assert (a.join_round is None) == (b.join_round is None)
            if a.join_round is not None:
                assert np.array_equal(a.join_round, b.join_round)
            for kind in ("contig", "hash"):
                nem = j_nem.NemesisParams(part_kind=kind)
                assert np.array_equal(
                    j_nem.group_of(nem, n),
                    t_nem.group_of(t_nem.NemesisParams(part_kind=kind), n))
    with pytest.raises(ValueError) as a:
        j_nem.build("bogus", 8)
    with pytest.raises(ValueError) as b:
        t_nem.build("bogus", 8)
    assert str(a.value) == str(b.value)



def test_refmodel_copy_matches():
    """The oracle's copy is the original statement for statement: only
    docstrings differ, and the two imports name the port's package."""
    from consul_tpu.gossip import refmodel as j_ref
    from consul_tpu_torch.gossip import refmodel as t_ref

    def code(mod, package):
        tree = ast.parse(Path(mod.__file__).read_text())
        for node in ast.walk(tree):
            body = getattr(node, "body", None)
            if (isinstance(body, list) and body
                    and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:]
        imports = [node for node in ast.walk(tree)
                   if isinstance(node, ast.ImportFrom)
                   and node.module.startswith(package + ".")]
        assert [i.module for i in imports] == [f"{package}.gossip.nemesis",
                                               f"{package}.gossip.params"]
        for node in imports:
            node.module = "PKG" + node.module[len(package):]
        return ast.dump(tree)

    assert code(t_ref, "consul_tpu_torch") == code(j_ref, "consul_tpu")


def _tensors(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, tuple):
        return [t for x in out for t in _tensors(x)]
    return []


# The cross-validation entry points return host values (latencies, counts,
# report rows): for them the CPU call only has to run.
_HOST_RESULT = ("kernel_event_latencies", "kernel_nemesis_stats",
                "kernel_event_curve", "run_config", "run_nemesis_config",
                "run_join_config", "run_event_config")


@pytest.mark.parametrize("entry", ["init_state", "init_flight", "init_hist",
                                   "init_nem_state", "swim_round",
                                   "run_rounds", "shard_state",
                                   "swim_round_sharded",
                                   "run_rounds_sharded", "init_multidc",
                                   "init_multidc_hist", "multidc_round",
                                   "run_multidc_rounds", *_HOST_RESULT])
def test_default_device_is_the_card(entry):
    """device=None means CUDA: without a card every entry point raises
    instead of running on the CPU; device="cpu" is the way there."""
    from consul_tpu_torch.gossip import crossval as tc
    from consul_tpu_torch.gossip import multidc as tm
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = t_params.SwimParams(n=20, slots=4)
    fail = np.full(20, tk.NEVER, np.int32)
    mp = tm.make_params(2, 20, event_slots=2, slots=4)
    lan_fail = np.full((2, 20), tk.NEVER, np.int32)
    wan_fail = np.full((6,), tk.NEVER, np.int32)
    calls = {
        "init_state": lambda **kw: tk.init_state(p, **kw),
        "init_flight": lambda **kw: tk.init_flight(8, **kw),
        "init_hist": lambda **kw: tk.init_hist(**kw),
        "init_nem_state": lambda **kw: tk.init_nem_state(20, **kw),
        "swim_round": lambda **kw: tk.swim_round(
            tk.init_state(p, device="cpu"), np.zeros(2, np.uint32), fail,
            p, **kw),
        "run_rounds": lambda **kw: tk.run_rounds(
            tk.init_state(p, device="cpu"), np.zeros(2, np.uint32), fail,
            p, 2, **kw),
        "shard_state": lambda **kw: tk.shard_state(
            tk.init_state(p, device="cpu"), 2, **kw),
        "swim_round_sharded": lambda **kw: tk.swim_round_sharded(
            tk.init_state(p, device="cpu"), np.zeros(2, np.uint32), fail,
            p, ndev=2, **kw),
        "run_rounds_sharded": lambda **kw: tk.run_rounds_sharded(
            tk.init_state(p, device="cpu"), np.zeros(2, np.uint32), fail,
            p, 2, ndev=2, **kw),
        "init_multidc": lambda **kw: tm.init_multidc(mp, **kw),
        "init_multidc_hist": lambda **kw: tm.init_multidc_hist(mp, **kw),
        "multidc_round": lambda **kw: tm.multidc_round(
            tm.init_multidc(mp, device="cpu"), np.zeros(2, np.uint32),
            lan_fail, wan_fail, mp, **kw),
        "run_multidc_rounds": lambda **kw: tm.run_multidc_rounds(
            tm.init_multidc(mp, device="cpu"), np.zeros(2, np.uint32),
            lan_fail, wan_fail, mp, 2, **kw),
        "kernel_event_latencies": lambda **kw: tc.kernel_event_latencies(
            p, {3: 1}, 4, 0, **kw),
        "kernel_nemesis_stats": lambda **kw: tc.kernel_nemesis_stats(
            p, t_nem.build("block_kill", 20), 4, 0, **kw),
        "kernel_event_curve": lambda **kw: tc.kernel_event_curve(p, 4, 0,
                                                                 **kw),
        "run_config": lambda **kw: tc.run_config(20, 1, 1, oracle=False,
                                                 **kw),
        "run_nemesis_config": lambda **kw: tc.run_nemesis_config(
            "block_kill", 20, 1, steps=4, **kw),
        "run_join_config": lambda **kw: tc.run_join_config(20, 1, 1, 1,
                                                           **kw),
        "run_event_config": lambda **kw: tc.run_event_config(20, 1, **kw),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    out = calls[entry](device="cpu")
    if entry in _HOST_RESULT:
        assert out is not None
        return
    first = out[0] if entry.startswith("run_") else out
    tensors = _tensors(first)
    assert tensors and all(t.device.type == "cpu" for t in tensors)


def test_wrapper_never_falls_back():
    """The kernel wrappers refuse anything but a CUDA tensor, and the
    tail routes a non-CPU tensor only to a kernel."""
    S, N = 4, 16
    heard = torch.zeros((S, N), dtype=torch.uint8)
    mf = torch.zeros(N, dtype=torch.int32)
    rx = torch.ones(N, dtype=torch.bool)
    cap = torch.zeros(S, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused.fused_dissem(heard, [1, 2, 3], mf, rx, cap, 5, 3)
    p = t_params.SwimParams(n=N, slots=S)
    meta = [t.to("meta") for t in (heard, mf, rx, cap)]
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused.disseminate(p, 5, [1, 2, 3], *meta)
    before = fused.launches
    fused.disseminate(p, 5, [1, 2, 3], heard, mf, rx, cap)
    assert fused.launches == before  # the CPU path launches nothing
    # With a partition's drop operand: the same.
    drop = torch.ones((3, N), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused.fused_dissem(heard, [1, 2, 3], mf, rx, cap, 5, 3, drop)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused.disseminate(p, 5, [1, 2, 3], *meta, drop=drop.to("meta"))
    fused.disseminate(p, 5, [1, 2, 3], heard, mf, rx, cap, drop=drop)
    assert fused.launches == before and fused.drop_launches == 0

    # Kernel 2, fused_merge, and the sharded tail that routes to it.
    sc = tk._ShardCtx(2, N // 2)
    shards = tuple(h.contiguous() for h in heard.split(N // 2, dim=1))
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused.fused_merge(shards, [1, 2, 3], mf, rx, cap, 5, 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused.disseminate(p, 5, [1, 2, 3],
                          tuple(h.to("meta") for h in shards), *meta[1:],
                          sc=sc)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused.fused_merge(shards, [1, 2, 3], mf, rx, cap, 5, 3, drop)
    before = fused.merge_launches
    out = fused.disseminate(p, 5, [1, 2, 3], shards, mf, rx, cap, sc=sc)
    assert len(out) == 2 and fused.merge_launches == before
    out = fused.disseminate(p, 5, [1, 2, 3], shards, mf, rx, cap, sc=sc,
                            drop=drop)
    assert len(out) == 2 and fused.merge_launches == before


def test_import_builds_nothing(tmp_path):
    """Importing the port compiles no kernel, neither fused_dissem's nor
    fused_merge's (the build runs at the first launch on a card)."""
    code = ("import consul_tpu_torch.gossip.fused as f, "
            "consul_tpu_torch.gossip.kernel, consul_tpu_torch._build as b; "
            "assert f._lib.cache_info().currsize == 0 and not b.build_logs; "
            "print(b._libs)")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=tmp_path, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "{}"


def test_library_hash_covers_headers(tmp_path, monkeypatch):
    """An edit to the rule's header under csrc/ changes the kernels'
    library path, so a stale library is never loaded; so does an edit to
    the kernel's source, and an unchanged tree keeps its path."""
    from consul_tpu_torch import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build.library_path("dissem_tail")
    assert _build.library_path("dissem_tail") == before
    header = csrc / "belief_merge.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = _build.library_path("dissem_tail")
    assert after != before
    src = csrc / "dissem_tail.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build.library_path("dissem_tail") not in (before, after)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_card_or_repo(tmp_path, alone):
    """Without a card, or copied away from the package, chip_smoke.py
    exits non-zero and prints no result line."""
    if torch.cuda.is_available() and not alone:
        pytest.skip("a card is present")
    script = REPO / "chip_smoke.py"
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = tmp_path / "chip_smoke.py"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, str(script)], capture_output=True,
                       text=True, env=env, cwd=script.parent, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


# -- the gossip plane's copies ---------------------------------------------

def test_plane_constants_match():
    from consul_tpu.gossip import plane as jp
    from consul_tpu_torch.gossip import plane as tp
    for name in ("EV_JOIN", "EV_LEAVE", "EV_FAILED", "EV_UPDATE", "EV_USER",
                 "STEPS_PER_TICK", "FLIGHT_DRAIN_EVERY", "TUNED_FIELDS",
                 "_TUNED_AUTO"):
        assert getattr(tp, name) == getattr(jp, name), name
    j_fields = jp.PlaneConfig.__dataclass_fields__
    t_fields = dict(tp.PlaneConfig.__dataclass_fields__)
    assert t_fields.pop("device").default is None
    assert list(j_fields) == list(t_fields)
    j_cfg, t_cfg = jp.PlaneConfig(), tp.PlaneConfig()
    for f in j_fields:
        assert getattr(j_cfg, f) == getattr(t_cfg, f), f
    assert list(jp.PlaneNode.__dataclass_fields__) == list(
        tp.PlaneNode.__dataclass_fields__)
    rng = np.random.default_rng(3)
    for tags in (None, {}, {"role": "node", "dc": "dc1"}):
        key = __import__("base64").b64encode(rng.bytes(16)).decode()
        args = (key, "n1", "10.0.0.1", 8301, 1_700_000_000, rng.bytes(8),
                tags)
        assert tp.registration_proof(*args) == jp.registration_proof(*args)


def test_knob_registry_matches_for_the_plane():
    from consul_tpu.gossip import plane as jp
    from consul_tpu.obs import tuner as jt
    from consul_tpu_torch.obs import tuner as tt
    assert set(tt.KNOBS) == set(jp.TUNED_FIELDS)
    assert tt.DISSEM_CHOICES == jt.DISSEM_CHOICES
    for name, knob in tt.KNOBS.items():
        ref = jt.KNOBS[name]
        assert (knob.default, knob.kind, knob.target, knob.choices) == (
            ref.default, ref.kind, ref.target, ref.choices), name


def test_tuner_resolution_order(tmp_path, monkeypatch):
    """explicit > a verdict for this fingerprint > default; a verdict
    settled for another backend is not applied."""
    from consul_tpu_torch.obs import tuner as tt
    monkeypatch.setenv("CONSUL_TPU_AUTOTUNE_DIR", str(tmp_path))
    names = ["hot_slots", "shard_devices", "unroll"]
    res = tt.resolve(names, {"unroll": 2}, platform="cuda", device_count=1)
    assert res.value("hot_slots") == 0 and res.value("shard_devices") == 1
    assert res.rows["hot_slots"]["reason"] == "no verdict for this knob"
    assert res.rows["unroll"]["source"] == "flag" and res.value("unroll") == 2
    verdict = {"format": tt.VERDICT_FORMAT,
               "fingerprint": tt.fingerprint("cuda", 1),
               "knobs": {"hot_slots": {"value": 8, "source": "evidence",
                                       "evidence": ["x"], "reason": "r"}}}
    assert tt.save_verdict(verdict)
    res = tt.resolve(names, {}, platform="cuda", device_count=1)
    assert res.value("hot_slots") == 8
    assert res.rows["hot_slots"]["source"] == "verdict"
    res = tt.resolve(names, {}, platform="cuda", device_count=4)
    assert res.value("hot_slots") == 0
    assert res.rows["hot_slots"]["reason"] == \
        "verdict settled for another backend"
    assert res.wire()["fingerprint"]["device_count"] == 4


class _Registry:
    def __init__(self):
        self.calls = []

    def incr_counter(self, key, n=1.0):
        self.calls.append(("c", key, n))

    def set_gauge(self, key, v):
        self.calls.append(("g", key, v))


def test_recorders_match_on_the_same_ingest():
    from consul_tpu.obs import journey as jj
    from consul_tpu.obs import raftstats as jr
    from consul_tpu.obs import slo as js
    from consul_tpu_torch.obs import flight as tf
    from consul_tpu_torch.obs import hist as th
    from consul_tpu_torch.obs import journey as tj
    from consul_tpu_torch.obs import raftstats as tr
    from consul_tpu_torch.obs import slo as ts

    rng = np.random.default_rng(5)
    reg_j, reg_t = _Registry(), _Registry()
    fj = j_flight.FlightRecorder(metrics=reg_j)
    ft = tf.FlightRecorder(metrics=reg_t)
    hj, ht = j_hist.HistRecorder(), th.HistRecorder()
    sj, st = js.SloTracker(9), ts.SloTracker(9)
    bj, bt = js.SloBoard(9), ts.SloBoard(9)
    banks = {"detect": np.zeros(256, np.int64), "dwell": np.zeros(256, np.int64),
             "refute": np.zeros(256, np.int64), "spread": np.zeros(32, np.int64)}
    cursor = 0
    for step in range(6):
        # Ring of 16 rows; some drains overflow it.
        cursor += int(rng.integers(1, 24))
        rows = rng.integers(0, 50, (16, constants.N_COLS)).astype(np.int32)
        assert fj.ingest(rows, cursor) == ft.ingest(rows, cursor)
        for name in banks:
            banks[name] += rng.integers(0, 3, banks[name].shape)
        # The device banks are int32 and wrap: drain their 32-bit view.
        view = {k: ((v + (2**31 - 20 if step > 3 else 0)) % 2**32)
                .astype(np.uint32).view(np.int32) for k, v in banks.items()}
        dj, dt = hj.ingest(view, scenario="s1" if step % 2 else None), \
            ht.ingest(view, scenario="s1" if step % 2 else None)
        assert all(np.array_equal(dj[k], dt[k]) for k in dj)
        assert sj.observe(dj["detect"]) == st.observe(dt["detect"])
        assert bj.observe("s1", dj["detect"]) == bt.observe("s1", dt["detect"])
    assert fj.wire(limit=40) == ft.wire(limit=40)
    assert reg_j.calls == reg_t.calls
    assert hj.families() == ht.families()
    assert hj.summary() == ht.summary() and hj.summary("s1") == ht.summary("s1")
    assert hj.scenarios() == ht.scenarios()
    assert sj.snapshot() == st.snapshot() and bj.snapshot() == bt.snapshot()
    lj = jr.LatencyHist("x", "h")
    lt = tr.LatencyHist("x", "h")
    for ms in rng.exponential(40.0, 200):
        lj.observe(float(ms))
        lt.observe(float(ms))
    assert tr.MS_EDGES == jr.MS_EDGES
    assert lj.family() == lt.family() and lj.wire() == lt.wire()
    yj, yt = jj.JourneyStats(budget=250.0), tj.JourneyStats(budget=250.0)
    assert tj.STAGES == jj.STAGES
    for ms in rng.exponential(30.0, 50):
        for s in ("detect", "drain"):
            yj.stage_observe(s, float(ms))
            yt.stage_observe(s, float(ms))
    assert yj.families() == yt.families()
    assert yj.stage_sums() == yt.stage_sums()


def test_gossipd_options_match_the_reference_cli():
    from consul_tpu.cli.main import build_parser as j_parser
    from consul_tpu_torch.gossipd import build_parser as t_parser

    def options(parser):
        return {o: (a.dest, a.default, a.type, a.choices)
                for a in parser._actions for o in a.option_strings
                if o not in ("-h", "--help")}

    sub = next(a for a in j_parser()._actions
               if isinstance(a, __import__("argparse")._SubParsersAction))
    ref, port = options(sub.choices["gossipd"]), options(t_parser())
    assert set(port) - set(ref) == {"-device", "--device"}
    assert {o: port[o] for o in ref} == ref


def test_gossipd_refuses_unknown_nemesis(capsys):
    """``-nemesis`` takes the catalog's names only: anything else exits 1
    before the plane starts, with the reference CLI's message."""
    from consul_tpu_torch.gossipd import main
    assert main(["-nemesis", "bogus", "--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert err.strip() == ("Unknown nemesis scenario 'bogus'; catalog: "
                           + ", ".join(j_nem.names()))


def test_keyring_parse_matches(tmp_path):
    import base64
    import json

    from consul_tpu.agent.keyring import Keyring
    from consul_tpu_torch import keyring as tkr
    good = [base64.b64encode(b"0123456789abcdef").decode(),
            base64.b64encode(b"fedcba9876543210").decode()]
    files = {"good": good, "empty": [], "short": ["YWJj"],
             "not_b64": ["###"], "not_list": {"k": 1}}
    for name, keys in files.items():
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(keys))
        outcome = []
        for load in (lambda: Keyring(path=str(path)).list_keys(),
                     lambda: tkr.list_keys(str(path))):
            try:
                outcome.append(load())
            except ValueError as e:
                outcome.append(str(e).replace(str(path), "<path>"))
        assert outcome[0] == outcome[1], name


def test_devstats_carries_no_tpu_figure():
    """The port's roofline is the H100 SXM's memory rate over the port's
    own two passes, not the reference's TPU figures."""
    from consul_tpu_torch.obs import devstats
    src = Path(devstats.__file__).read_text()
    assert "185" not in src and not hasattr(devstats, "EFFECTIVE_HBM_GBPS")
    assert devstats.HBM_GBPS == 3350.0
    assert devstats.dense_bytes_per_round(64, 1_000_000) == 128e6
    assert devstats.device_rows("cpu") == []


def test_plane_start_needs_the_card():
    """GossipPlane(PlaneConfig()) runs on the card: without one, start
    raises instead of serving from the CPU."""
    import asyncio

    from consul_tpu_torch.gossip.plane import GossipPlane, PlaneConfig
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    plane = GossipPlane(PlaneConfig(bind_port=0, capacity=8))
    loop = asyncio.new_event_loop()
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            loop.run_until_complete(plane.start())
        assert plane._server is None and plane._state is None
    finally:
        loop.close()
