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
from consul_tpu.gossip import params as j_params
from consul_tpu.ops import divisibility as j_div
from consul_tpu_torch.gossip import fused
from consul_tpu_torch.gossip import kernel as tk
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


@pytest.mark.parametrize("entry", ["init_state", "init_flight", "init_hist",
                                   "swim_round", "run_rounds"])
def test_default_device_is_the_card(entry):
    """device=None means CUDA: without a card every entry point raises
    instead of running on the CPU; device="cpu" is the way there."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = t_params.SwimParams(n=16, slots=4)
    fail = np.full(16, tk.NEVER, np.int32)
    calls = {
        "init_state": lambda **kw: tk.init_state(p, **kw),
        "init_flight": lambda **kw: tk.init_flight(8, **kw),
        "init_hist": lambda **kw: tk.init_hist(**kw),
        "swim_round": lambda **kw: tk.swim_round(
            tk.init_state(p, device="cpu"), np.zeros(2, np.uint32), fail,
            p, **kw),
        "run_rounds": lambda **kw: tk.run_rounds(
            tk.init_state(p, device="cpu"), np.zeros(2, np.uint32), fail,
            p, 2, **kw),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    out = calls[entry](device="cpu")
    first = out[0] if entry == "run_rounds" else out
    assert all(t.device.type == "cpu" for t in first)


def test_wrapper_never_falls_back():
    """The kernel wrapper refuses anything but a CUDA tensor, and the
    tail routes a non-CPU tensor only to the kernel."""
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


def test_import_builds_nothing(tmp_path):
    """Importing the port compiles no kernel (the build runs at the first
    launch on a card)."""
    code = ("import consul_tpu_torch.gossip.fused, consul_tpu_torch._build "
            "as b; print(b._libs)")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=tmp_path, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "{}"


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
