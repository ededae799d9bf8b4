"""Where the time of ``csrc/probe.cu``'s merged lanes-and-slots launch
goes: the kernel built as it is and cut after each of its stages, each
cut timed on the 1M main path's data, on ``partition_heal``'s window and
on the WAN pool's two lanes (``chip_smoke.py``'s probe inputs), in turns
(the cuts in order, then in reverse):

    python3 -m consul_tpu_torch.probe_stages

The cuts, each a copy of ``csrc/probe.cu`` with one statement inserted
(built with the port's nvcc flags into ``build/probe_stages/``):
``lanes`` returns after the lanes (flags, LHM, the minima); ``counts``
also adds the block's counts, then returns before the arrival;
``arrival`` also arrives, and the last block returns before the slot
step (it sets the counter back); ``merged`` is the kernel as it is.  Only
``merged`` computes the tick; the cuts are for timing alone, through the
wrapper ``probe.probe_lanes_slots`` (CUDA-graph replays,
``chip_smoke.graph_ms``).  Prints nvidia-smi's name and power limit,
ptxas's registers and spills of each build, the grid, then one JSON
line of times (ms a launch).  Needs a card.
"""

import ctypes
import importlib.util
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from consul_tpu_torch import _build
from consul_tpu_torch.gossip import probe

REPO = Path(__file__).resolve().parents[1]
OUT = _build.BUILD_DIR / "probe_stages"
# Each cut: (a statement of probe.cu, what takes its place).
_ARRIVE = "  // Arrive; the last block runs the slot step.\n"
_COUNTS = "  // The block's counts, one atomic each that is not 0.\n"
_SLOT = "  slot_step(a, s_node, s_phase, rnd, first);\n"
CUTS = {
    "lanes": (_COUNTS, "  return;\n" + _COUNTS),
    "counts": (_ARRIVE, "  return;\n" + _ARRIVE),
    "arrival": (_SLOT, ""),
    "merged": None,
}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _source(cut) -> str:
    src = (_build.CSRC / "probe.cu").read_text()
    if cut is None:
        return src
    old, new = cut
    if src.count(old) != 1:
        raise RuntimeError(f"probe.cu no longer holds {old.strip()!r}")
    return src.replace(old, new)


def _build_cut(name: str):
    """The cut's library, built, and what ptxas said of its merged
    kernel (stack and spills, registers)."""
    OUT.mkdir(parents=True, exist_ok=True)
    cu = OUT / f"{name}.cu"
    cu.write_text(_source(CUTS[name]))
    so = OUT / f"libprobe_{name}.so"
    r = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS,
                        f"-I{_build.CSRC}", "-o", str(so), str(cu)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for the cut {name}: {r.stderr}")
    lines = (r.stdout + r.stderr).splitlines()
    at = next(i for i, ln in enumerate(lines) if "lanes_slots_kernel" in ln
              and "Compiling" in ln)
    return name, so, [ln.strip() for ln in lines[at + 2:at + 4]]


def _entry_points(so: Path):
    lib = ctypes.CDLL(str(so))
    fns = tuple(getattr(lib, n) for n in probe.ENTRY_POINTS)
    for fn in fns:
        fn.argtypes, fn.restype = probe._ARGTYPES, ctypes.c_int
    lib.probe_error.argtypes = [ctypes.c_int]
    lib.probe_error.restype = ctypes.c_char_p
    return fns, lib.probe_error


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_stages: needs a CUDA device", file=sys.stderr)
        return 2
    cs = _chip_smoke()
    cs.card()
    with ThreadPoolExecutor(len(CUTS)) as pool:
        built = list(pool.map(_build_cut, CUTS))
    libs = {}
    for name, so, log in built:
        print(f"{name}: {' | '.join(log)}", flush=True)
        libs[name] = _entry_points(so)
    p = cs._probe_params("1m")[0]
    inputs = {key: cs._probe_main_inputs(p, 1, partition=part)
              for key, part in (("1m/1", False),
                                ("1m_partition_heal/1", True))}
    inputs["wan"] = cs._probe_inputs(*cs._probe_params("wan"), 7)
    print(json.dumps({"blocks": {k: probe.lanes_slots_blocks(cfg.B)
                                 for k, (cfg, _) in inputs.items()}}),
          flush=True)
    times = {k: {c: [] for c in CUTS} for k in inputs}
    lib0 = probe._lib
    try:
        for order in (list(CUTS), list(CUTS)[::-1]):
            for cut in order:
                probe._lib = lambda cut=cut: libs[cut]
                for key, (cfg, t) in inputs.items():
                    tk = cs._tick_copy(t)
                    times[key][cut].append(cs.graph_ms(
                        lambda: probe.probe_lanes_slots(cfg, tk)))
    finally:
        probe._lib = lib0
    print(json.dumps({"ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
