"""What bounds the round's two threefry kernels on the card: the edge drops
of ``csrc/threefry.cu`` (``draw_kernel``'s edge-drops mode) and
``csrc/round_table.cu``'s ``table_kernel``, each built as it is and in
variants and timed at the smoke's shapes.

    python3 tools/draw_stages.py

Each variant is the source with its text changed, built with the port's
own nvcc flags into ``build/draw_stages/<variant>/`` and called through
the port's own wrappers (``prng._edge_drops_into`` with the keys and
shifts in device memory, ``round_table.fill``), pointed at the variant's
library:

- ``kernel``: the source as it is (held against the plain version);
- ``empty``: the kernel returns at once (a launch in a graph);
- edge drops: ``wide`` and ``narrow`` (the wide form, a block a span of
  every leg, or the narrow one, a thread a destination, at every length),
  ``hash_cut`` (the hash of an uncertain edge replaced by one operation),
  ``store_cut`` (no byte of the row stored), ``sender_cut`` (the senders'
  groups not loaded); the wide form's shape changed: ``blocks_5``
  (registers capped for 5 blocks an SM), blocks of ``threads_64`` and
  ``threads_256``, ``wide_8`` (8 destinations a thread), ``no_hash`` (no
  hash compiled in; wrong where a probability is drawn);
- the table: ``rows_cut`` (the rows' hashes cut: the scalars and the
  variant code only), ``lanes_32`` (a warp a row), ``one_level``
  (the shuffles cut: each lane goes on with its own keys, the chain of
  five hashes without the hand-offs).

A cut variant computes wrong outputs and is timed only.  Times from
CUDA-graph replays of 20 launches (``chip_smoke.graph_ms``), two passes
over the variants in turn.  Prints the card's name and power limit, each
variant's ptxas lines (registers, spills), then one JSON line: kernel ->
shape -> variant -> the two times.  Needs a card and nvcc.  Not part of
the port.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from consul_tpu_torch import _build, prng  # noqa: E402
from consul_tpu_torch.gossip import round_table  # noqa: E402

EDGE_ENTRY = ("template <int M>\n__global__ void __launch_bounds__(kThreads) "
              "draw_kernel(const Args a) {\n")
EDGE = {
    "kernel": {},
    "empty": {EDGE_ENTRY + "  if constexpr (M == kEdgeDrops) {\n":
              EDGE_ENTRY + "  if constexpr (M == kEdgeDrops) {\n"
              "    if (a.n > 0) return;\n"},
    "wide": {"constexpr int kFill = 132;": "constexpr int kFill = 1;"},
    "narrow": {"constexpr int kFill = 132;":
               "constexpr int kFill = 1 << 30;"},
    "hash_cut": {"s_out[e] = unit_float(hash(k0, k1, static_cast<uint32_t>"
                 "(first + e))) <\n                   p;":
                 "s_out[e] = ((first + e) & 1) && p > 0.0f;",
                 "drop = unit_float(hash(k0, k1, static_cast<uint32_t>(d))) "
                 "< p;": "drop = ((d ^ k0) & 1u) && p > 0.0f;"},
    "store_cut": {"      const int64_t f0 = first + e0;":
                  "      const int64_t f0 = -(int64_t{1} << 40);",
                  "    row[d] = drop;": "    if (n == 0) row[d] = drop;"},
    "sender_cut": {"    g[j] = Full || (at >= lo && at < hi)\n"
                   "               ? (at < wrap ? src : src_wrapped)[at]\n"
                   "               : 0;":
                   "    g[j] = (at >> 8) & static_cast<int>(shift & 1);",
                   "const int32_t g_src = a.grp[s], g_dst = a.grp[d];":
                   "const int32_t g_src = static_cast<int32_t>(s & 1), "
                   "g_dst = a.grp[d];"},
    # The wide form's shape: registers capped for 5 blocks an SM; blocks
    # of 64 and 256 threads; 8 destinations a thread; no hash compiled in
    # (wrong where a probability is drawn).
    "blocks_5": {EDGE_ENTRY: EDGE_ENTRY.replace("__launch_bounds__(kThreads)",
                                                "__launch_bounds__(kThreads, "
                                                "5)")},
    "threads_64": {"constexpr int kEdgeThreads = 128;":
                   "constexpr int kEdgeThreads = 64;"},
    "threads_256": {"constexpr int kEdgeThreads = 128;":
                    "constexpr int kEdgeThreads = 256;"},
    "wide_8": {"constexpr int kWide = 16; ": "constexpr int kWide = 8; "},
    "no_hash": {"  x.hashes = (x.p_ab > 0.0f && x.p_ab < 1.0f) ||\n"
                "             (x.p_ba > 0.0f && x.p_ba < 1.0f);":
                "  x.hashes = false;"},
}
TABLE_ENTRY = "  if (j.events) {\n    event_row("
TABLE = {
    "kernel": {},
    "empty": {"  const Job& j = a.job[blockIdx.y];\n  if (blockIdx.x":
              "  if (a.rows >= 0) return;\n"
              "  const Job& j = a.job[blockIdx.y];\n  if (blockIdx.x"},
    "rows_cut": {TABLE_ENTRY: "  if (a.rows > 0) return;\n" + TABLE_ENTRY},
    "lanes_32": {"  return widest <= 8 ? 3 : widest <= 16 ? 4 : 5;":
                 "  return widest > 0 ? 5 : 5;"},
    "one_level": {"__device__ __forceinline__ Words shfl(Words k, int src, "
                  "int width) {\n":
                  "__device__ __forceinline__ Words shfl(Words k, int src, "
                  "int width) {\n  if (width > 0) return k;\n"},
}
# Edge drops: (legs, n, groups, p_ab, p_ba), the smoke's shapes.
EDGE_SHAPES = ((3, 1_000_000, "half", 1.0, 1.0),
               (3, 1_000_000, "hash", 0.6, 0.0),
               (2, 1_000_000, "hash", 0.6, 0.0),
               (3, 16_001, "hash", 0.3, 0.45),
               (1, 1_000_000, "half", 1.0, 1.0))
TABLE_ROWS = (512, 30, 1)
OUT = ROOT / "build" / "draw_stages"


def build(source: str, name: str, edits: dict):
    """The variant's library and what ptxas said."""
    body = (_build.CSRC / f"{source}.cu").read_text()
    for text, new in edits.items():
        if body.count(text) != 1:
            raise RuntimeError(f"{source} {name}: {text!r} not found once")
        body = body.replace(text, new)
    d = OUT / f"{source}_{name}"
    d.mkdir(parents=True, exist_ok=True)
    (d / f"{source}.cu").write_text(body)
    so = d / f"lib{source}.so"
    r = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS,
                        f"-I{_build.CSRC}", "-o", str(so),
                        str(d / f"{source}.cu")],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source} {name}:\n{r.stderr}")
    ptxas = [ln.strip() for ln in (r.stdout + r.stderr).splitlines()
             if "registers" in ln or "spill" in ln]
    return ctypes.CDLL(str(so)), ptxas


@contextlib.contextmanager
def routed(source: str, lib):
    """The port's wrapper of ``source`` launches ``lib``'s entry points."""
    if source == "threefry":
        @functools.lru_cache(maxsize=None)
        def typed(name):
            fn, err = getattr(lib, name), lib.threefry_error
            fn.argtypes, fn.restype = prng._ARGTYPES[name], ctypes.c_int
            err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
            return fn, err
        old, prng._lib = prng._lib, typed
        try:
            yield
        finally:
            prng._lib = old
        return

    @functools.lru_cache(maxsize=None)
    def table():
        fn, err = lib.round_table_fill, lib.round_table_error
        fn.argtypes = [ctypes.POINTER(round_table._Args), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        return fn, err
    old, round_table._lib = round_table._lib, table
    try:
        yield
    finally:
        round_table._lib = old


def edge_calls(legs, n, groups, p_ab, p_ba):
    """The edge drops' launch at the shape (keys and shifts in device
    memory, as the round's), its plain version."""
    k = cs._draw_keys(7, 1)[0]
    keys = [prng.fold_in(k, f) for f in range(legs)]
    spec = dict(shape=(legs, n), groups=groups, p_ab=p_ab, p_ba=p_ba)
    _, grp, shifts, p_ab, p_ba = cs._edge_args(spec, keys, k)
    dk = cs._device_words(keys)
    ds = torch.tensor([int(o) for o in shifts], dtype=torch.int32,
                      device="cuda")
    out = torch.empty((legs, n), dtype=torch.bool, device="cuda")

    def call():
        prng._edge_drops_into(out, dk, grp, ds, p_ab, p_ba)
        return out
    return call, lambda: prng.edge_drops_ref(keys, grp, shifts, p_ab, p_ba)


def table_calls(rows):
    """The table's launch at 1M's parameters and its check."""
    p = cs._table_params()["lan_1m"]
    j = cs._table_job(p, prng.key(5), 1000, rows, False, cursor=17, ring=256)
    return (functools.partial(round_table.fill, [j], rows),
            lambda: cs._table_held(j, rows) == 0)


def main() -> int:
    if not torch.cuda.is_available():
        print("draw_stages: no CUDA device", file=sys.stderr)
        return 1
    print(cs.card(), flush=True)
    jobs = ([("threefry", name, e) for name, e in EDGE.items()]
            + [("round_table", name, e) for name, e in TABLE.items()])
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip([(s, n) for s, n, _ in jobs],
                         pool.map(lambda j: build(*j), jobs)))
    for (source, name), (_, ptxas) in built.items():
        print(source, name, " | ".join(ptxas), flush=True)
    res = {"edge_drops": {}, "table": {}}
    for shape in EDGE_SHAPES:
        call, plain = edge_calls(*shape)
        want = plain()
        row = res["edge_drops"]["/".join(map(str, shape))] = {}
        for _ in range(2):
            for name in EDGE:
                with routed("threefry", built["threefry", name][0]):
                    got = call()
                    torch.cuda.synchronize()
                    if name in ("kernel", "wide", "narrow", "blocks_5",
                                "threads_64", "threads_256", "wide_8") \
                            and not torch.equal(got, want):
                        raise AssertionError(f"{name} != plain at {shape}")
                    row.setdefault(name, []).append(cs.graph_ms(call))
    for rows in TABLE_ROWS:
        call, held = table_calls(rows)
        row = res["table"][str(rows)] = {}
        for _ in range(2):
            for name in TABLE:
                with routed("round_table", built["round_table", name][0]):
                    call()
                    torch.cuda.synchronize()
                    if name in ("kernel", "lanes_32") and not held():
                        raise AssertionError(f"{name} != plain at {rows}")
                    row.setdefault(name, []).append(cs.graph_ms(call))
    print(cs.card(), flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
