"""What bounds the observers' kernel (``csrc/observe.cu``) on the card:
the kernel built as it is and in variants, each timed at the smoke's
shapes in every form the round launches it.

    python3 tools/observe_stages.py

Each variant is the source with its text changed, built with the port's
own nvcc flags into ``build/observe_stages/<variant>/`` and called
through the same C entry point as the port's wrapper:

- ``kernel``: the source as it is (held against the plain version);
- ``rule_cut``: the counting rule cut to one operation a word (the loads,
  the staged member bytes, the listing and the end kept);
- ``end_cut``: the blocks stop after their items (no counts added to the
  scratch, no arrival, ``out`` not written);
- ``both_cut``: both cuts;
- the design's constants changed: ``units_1`` and ``units_4`` (units a
  thread), ``threads_128`` (8 blocks an SM), ``threads_512`` (2),
  ``threads_1024`` (1), ``blocks_3`` (3 blocks of 256 an SM).

A cut variant computes wrong counts and is timed only.  Times from
CUDA-graph replays of 20 launches (``chip_smoke.graph_ms``), two passes
over the variants in turn.  Prints the card's name and power limit, each
variant's ptxas line (registers, spills), then one JSON line: shape ->
variant -> form -> the two times.  Needs a card and nvcc.  Not part of
the port.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from consul_tpu_torch import _build  # noqa: E402
from consul_tpu_torch.gossip import observe  # noqa: E402

RULE = "      const uint32_t w = b.w[k][q];"
END = ("  // The block's counts into the scratch, then arrive; the last of "
       "the")
CONSTANTS = {
    "units_1": {"constexpr int kUnits = 2;": "constexpr int kUnits = 1;"},
    "units_4": {"constexpr int kUnits = 2;": "constexpr int kUnits = 4;"},
    "threads_128": {"constexpr int kThreads = 256;":
                    "constexpr int kThreads = 128;",
                    "constexpr int kBlocksPerSM = 4;":
                    "constexpr int kBlocksPerSM = 8;"},
    "threads_512": {"constexpr int kThreads = 256;":
                    "constexpr int kThreads = 512;",
                    "constexpr int kBlocksPerSM = 4;":
                    "constexpr int kBlocksPerSM = 2;"},
    "threads_1024": {"constexpr int kThreads = 256;":
                     "constexpr int kThreads = 1024;",
                     "constexpr int kUnits = 2;": "constexpr int kUnits = 1;",
                     "constexpr int kBlocksPerSM = 4;":
                     "constexpr int kBlocksPerSM = 1;"},
    "blocks_3": {"constexpr int kBlocksPerSM = 4;":
                 "constexpr int kBlocksPerSM = 3;"},
}
CUTS = {"rule_cut": {RULE: RULE + "\n      if (true) { acc[0] += w ^ m[q]; "
                                  "continue; }"},
        "end_cut": {END: "  if (blockIdx.x < gridDim.x) return;\n" + END}}
CUTS["both_cut"] = {**CUTS["rule_cut"], **CUTS["end_cut"]}
VARIANTS = {"kernel": {}, **CUTS, **CONSTANTS}
SHAPES = ((64, 1_000_000, 1), (64, 1_000_000, 8), (32, 250_000, 1),
          (64, 250_000, 8), (8, 1_000_000, 1), (64, 16_001, 1))
OUT = ROOT / "build" / "observe_stages"


def build(name: str):
    """The variant's library and what ptxas said."""
    body = (_build.CSRC / "observe.cu").read_text()
    for text, new in VARIANTS[name].items():
        if body.count(text) != 1:
            raise RuntimeError(f"{name}: {text!r} not found once")
        body = body.replace(text, new)
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "observe.cu").write_text(body)
    so = d / "libobserve.so"
    r = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS,
                        f"-I{_build.CSRC}", "-o", str(so),
                        str(d / "observe.cu")],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{r.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.heard_counts.argtypes = observe._ARGTYPES
    lib.heard_counts.restype = ctypes.c_int
    ptxas = [ln.strip() for ln in (r.stdout + r.stderr).splitlines()
             if "registers" in ln or "spill" in ln]
    return lib, ptxas


def launcher(lib, arg, member, budget, verdict, want, scratch):
    """One launch of the variant's ``heard_counts`` as a function of
    none, into an output of its own."""
    shards = observe._shards(arg)
    R, L = shards[0].shape
    table = observe._array(len(shards))(*(h.data_ptr() for h in shards))
    out = torch.empty((len(observe.COUNTS), R), dtype=torch.int32,
                      device="cuda")
    args = (table, len(shards), member.data_ptr(),
            None if verdict is None else verdict.data_ptr(),
            None if want is None else want.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), R, L, budget)

    def call():
        rc = lib.heard_counts(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"heard_counts refused: {rc}")
        return out

    return call


def main() -> int:
    if not torch.cuda.is_available():
        print("observe_stages: no CUDA device", file=sys.stderr)
        return 1
    print(cs.card(), flush=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
    for name, (_, ptxas) in built.items():
        print(name, " | ".join(ptxas), flush=True)
    res = {}
    for R, N, ndev in SHAPES:
        arg, member, verdict, want = cs._observe_inputs(R, N, ndev, 3)
        none = torch.zeros_like(want)
        forms = cs._observe_forms(R, N, verdict, want, none)
        scratch = observe.counts_scratch(R, "cuda")
        row = res[f"{R}x{N}" + (f"/{ndev}" if ndev > 1 else "")] = {}
        for _ in range(2):
            for name, (lib, _) in built.items():
                for form, (v, w, _) in forms.items():
                    call = launcher(lib, arg, member, cs.OBSERVE_BUDGET, v,
                                    w, scratch)
                    got = call()
                    torch.cuda.synchronize()
                    if name not in CUTS and not torch.equal(
                            got, observe.heard_counts_ref(
                                arg, member, cs.OBSERVE_BUDGET, v, w)):
                        raise AssertionError(f"{name} != plain at {R}x{N}"
                                             f"/{ndev} {form or 'final'}")
                    row.setdefault(name, {}).setdefault(
                        form.lstrip("_") or "final", []).append(
                            cs.graph_ms(call))
        del arg, member, verdict, want, none
    print(cs.card(), flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
