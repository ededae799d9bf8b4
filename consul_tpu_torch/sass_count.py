"""Count the instructions the card runs per belief word in the dissemination
tail's kernel, per slot word in the event flood's kernel, per element in
the draws' kernel and per lane in the probe tick's lanes_slots kernel, from
their SASS, per execution unit.

    python -m consul_tpu_torch.sass_count [--fanout 3]
    python -m consul_tpu_torch.sass_count --flood [--fanout 3]
    python -m consul_tpu_torch.sass_count --threefry
    python -m consul_tpu_torch.sass_count --probe
    python -m consul_tpu_torch.sass_count --observe

Builds ``csrc/dissem_tail.cu``, disassembles it with the toolkit's
``cuobjdump -sass``, takes the kernel instantiated for ``--fanout``, and
finds its word path's row loop: of the loops (a backward branch and its
target) that hold a 16-byte load (the current row's ``LDG.E.128``), the
one with the most ``LOP3`` instructions.  One iteration of that loop is
one row of a thread's four 32-bit words (the loop is kept rolled,
``#pragma unroll 1``).

The loop holds both ways of the current row's alignment (a 16-byte load
and store, or four 4-byte ones) as predicated instructions, and only one
way runs.  So each guard predicate is given a value, and an instruction
counts only where its guard holds; of all such settings the count takes
the one whose busiest unit has the fewest instructions, the least a row
can run.  The instructions are counted per execution unit: the integer ALU
(``LOP3``, ``SHF``, ``IADD3``, ``PRMT``, ``ISETP``, ...), and the FMA
unit, which runs the integer multiply-adds (``IMAD``, ``IMUL``).  Both
run 16 lanes a cycle per SM sub-partition on Hopper, so each has the
32-bit integer rate.  ``VIADD`` and ``VIADDMNMX``, whose unit is not
documented, go to whichever unit is less busy (``flexible``).  The
busiest unit's count per word sets the kernel's operations bound.

``--flood`` builds ``csrc/event_flood.cu`` instead and counts the word
path's slot loop of ``flood_kernel<fanout, false>`` (a round without
push/pull) the same way: the innermost loop with a shuffle (``SHFL``, how
a lane gets its neighbour's word of a window), one iteration one slot of
a lane's four words (its byte path is a loop of its own, without a
shuffle).  The count describes the kernel; the flood's operations bound
is counted from its rule instead (``chip_smoke.py``'s ``_flood_bound``).

``--threefry`` builds ``csrc/threefry.cu`` instead and counts, for each
of its element-wise modes (``draw_kernel<mode>``), the grid-stride loop:
one iteration is one element of the draw.  Every instruction of the loop
counts once.  The edge drops' mode has no such loop (a block takes a span
for every leg and hashes only the uncertain edges, 32 at a time a warp):
an edge it hashes is counted as a uniform's element, a hash and its
float.

``--probe`` builds ``csrc/probe.cu`` and counts its two kernels:
``probe::lanes_slots_kernel``, a thread a lane and, in the last block to
arrive, the slot step, and ``probe::rearm_marks_kernel``, the rearmed
rows' wipe and the marks: every instruction of a function once, per unit.
A lane runs a part of them (the draws only where they decide something,
the Lifeguard registers only when threaded, the slot step in one block),
so the count is what the most a lane can run costs, not what the main
path's lanes run; the draws' operations are counted per hash instead
(``--threefry``'s uniform loop; ``chip_smoke.py``'s ``_probe_bound``).

``--observe`` builds ``csrc/observe.cu`` and counts, for each form of
``observe::counts_kernel`` (the final matrix's, ``<false>``, and the
spread's, ``<true>``), its row loop: the smallest loop with a warp sum
(``REDUX``, a row's counts summed over the warp) and a 16-byte load.  The
loop holds every way a row can go (the member bytes' five realignments,
whole units or a head or tail unit loaded a byte at a time, the next
row's loads or none), so it is cut into basic blocks and the count takes
the path through them from the loop's head to its backward branch with
the most 16-byte loads (the next row's units loaded whole) and, of those,
the fewest integer instructions (an inner loop's blocks once; a guarded
instruction counts as run): what a row of whole units at the aligned
member path runs.  The rows an iteration covers are its warp sums over
the form's counts a row (3 or 1), each row a thread's 8 words.

Prints the loop's instructions, then the counts as one JSON line.
Needs nvcc and cuobjdump (the card's machine has both), not a card.
"""

from __future__ import annotations

import argparse
import itertools
import json
import re
import shutil
import subprocess
from collections import Counter
from pathlib import Path

# Opcodes (before the first '.') by the unit that runs them.
INT_ALU = {"LOP3", "LOP", "IADD3", "IADD", "SHF", "SHL", "SHR", "ISETP",
           "SEL", "PRMT", "LEA", "IMNMX", "VIMNMX", "VIMNMX3", "IABS",
           "BMSK", "SGXT", "ICMP", "VABSDIFF", "VABSDIFF4", "PLOP3"}
FMA = {"IMAD", "IMUL", "IMADSP", "IDP"}
FLEXIBLE = {"VIADD", "VIADDMNMX"}
MEMORY = {"LDG", "STG", "LD", "ST", "LDS", "STS", "LDC", "ULDC", "LDL",
          "STL"}
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@(!?)(U?P[T0-9]+)\s+)?"
                   r"([A-Z][A-Z0-9_]*)(\.[A-Z0-9_.]+)?\s*([^;]*);")


def cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    from consul_tpu_torch._build import nvcc
    cand = Path(nvcc()).parent / "cuobjdump"
    if cand.exists():
        return str(cand)
    raise RuntimeError("cuobjdump not found beside nvcc")


def _functions(sass: str) -> dict[str, list[tuple]]:
    """function name -> [(address, opcode, guard, text)]; guard is None
    or (predicate register, wanted value)."""
    out: dict[str, list] = {}
    cur = None
    for line in sass.splitlines():
        if "Function : " in line:
            cur = line.split("Function : ", 1)[1].strip()
            out[cur] = []
            continue
        m = _INSN.search(line)
        if cur is not None and m:
            guard = None
            if m.group(3) and m.group(3) not in ("PT", "UPT"):
                guard = (m.group(3), m.group(2) != "!")
            text = f"{m.group(4)}{m.group(5) or ''} {m.group(6)}".strip()
            out[cur].append((int(m.group(1), 16), m.group(4), guard, text))
    return out


def disassemble(name: str = "dissem_tail") -> str:
    """The SASS of the built ``csrc/<name>.cu`` library."""
    from consul_tpu_torch import _build
    so = _build.build(name)
    r = subprocess.run([cuobjdump(), "-sass", str(so)], capture_output=True,
                       text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {r.stderr}")
    return r.stdout


def _function(sass: str, pattern: str, what: str):
    """The one function of ``sass`` whose name holds ``pattern``."""
    funcs = {k: v for k, v in _functions(sass).items() if pattern in k}
    if len(funcs) != 1:
        raise RuntimeError(f"expected one {what}, found {sorted(funcs)}")
    (name, insns), = funcs.items()
    return name, insns


def _loops(insns) -> list:
    """Every loop of a function: the instructions from a backward branch's
    target to the branch."""
    out = []
    for addr, op, _, text in insns:
        t = re.search(r"0x([0-9a-f]+)", text)
        if op == "BRA" and t and int(t.group(1), 16) < addr:
            target = int(t.group(1), 16)
            out.append([x for x in insns if target <= x[0] <= addr])
    return out


# What marks each kernel's row loop, the 32-bit words one iteration
# covers, and the rest of the instance's mangled template arguments after
# the fanout (the flood's: push/pull false).
LOOP_MARK = {"tail_kernel": (("LDG", ".128"), 4, ""),
             "flood_kernel": (("SHFL", ""), 4, "Lb0E")}


def _row_loop(sass: str, fanout: int, kernel: str = "tail_kernel"):
    rest = LOOP_MARK[kernel][2]
    name, insns = _function(sass, f"{kernel}ILi{fanout}E{rest}",
                            f"{kernel}<{fanout}>")
    (op, suffix), _, _ = LOOP_MARK[kernel]
    rows = [span for span in _loops(insns)
            if any(x[1] == op and suffix in x[3] for x in span)]
    if not rows:
        raise RuntimeError(f"no loop with {op}{suffix} found in {name}")
    if kernel == "flood_kernel":
        # The slot loop is the innermost such loop: a warp sum's fallback
        # (after BRA.DIV) branches back into it from the end of the
        # function, which also looks like a loop around it.
        return name, min(rows, key=len)
    return name, max(rows, key=lambda span: sum(x[1] == "LOP3"
                                                for x in span))


def _units(ops: Counter) -> dict:
    alu = sum(v for k, v in ops.items() if k in INT_ALU)
    fma = sum(v for k, v in ops.items() if k in FMA)
    flex = sum(v for k, v in ops.items() if k in FLEXIBLE)
    # The flexible ones fill the less busy unit first.
    busiest = max(alu, fma, (alu + fma + flex + 1) // 2)
    return {"integer_alu": alu, "fma": fma, "flexible": flex,
            "busiest_unit": busiest}


def row_loop_counts(sass: str, fanout: int = 3,
                    kernel: str = "tail_kernel") -> dict:
    """The word path's row loop of ``kernel<fanout>`` in ``sass``
    (``tail_kernel`` of ``csrc/dissem_tail.cu`` or ``flood_kernel`` of
    ``csrc/event_flood.cu``): its instructions per execution unit, total
    and per word, for the setting of its guard predicates that leaves the
    busiest unit the fewest."""
    name, span = _row_loop(sass, fanout, kernel)
    preds = sorted({g[0] for _, _, g, _ in span if g is not None})
    if len(preds) > 12:
        raise RuntimeError(f"{len(preds)} guard predicates in the loop")
    best = None
    for values in itertools.product((False, True), repeat=len(preds)):
        setting = dict(zip(preds, values))
        ops = Counter(op for _, op, g, _ in span
                      if g is None or setting[g[0]] == g[1])
        units = _units(ops)
        key = (units["busiest_unit"], sum(ops.values()))
        if best is None or key < best[0]:
            best = (key, setting, ops, units)
    _, setting, ops, units = best
    n_mem = sum(v for k, v in ops.items() if k in MEMORY)
    n_run = sum(ops.values())
    words = LOOP_MARK[kernel][1]
    return {"function": name, "fanout": fanout,
            "loop": [hex(span[0][0]), hex(span[-1][0])],
            "instructions_in_loop": len(span),
            "guarded_in_loop": sum(g is not None for _, _, g, _ in span),
            "predicates": dict(setting),
            "instructions": n_run, **units, "memory": n_mem,
            "words_per_iteration": words,
            "integer_alu_per_word": units["integer_alu"] / words,
            "fma_per_word": units["fma"] / words,
            "flexible_per_word": units["flexible"] / words,
            "busiest_unit_per_word": units["busiest_unit"] / words,
            "instructions_per_word": n_run / words,
            "by_opcode": dict(ops.most_common())}


# draw_kernel<mode> of csrc/threefry.cu with a grid-stride loop, by the
# wrappers' names.
DRAW_MODES = {"bits": 0, "uniform": 1, "below": 2, "randint": 3}


def _draw_loop(sass: str, mode: int):
    name, insns = _function(sass, f"draw_kernelILi{mode}E",
                            f"draw_kernel<{mode}>")
    loops = _loops(insns)
    if not loops:
        raise RuntimeError(f"no loop found in {name}")
    return name, max(loops, key=len)


def draw_loop_counts(sass: str, mode: int) -> dict:
    """The grid-stride loop of ``draw_kernel<mode>`` in ``sass`` (one
    iteration, one element): its instructions per execution unit, each
    instruction of the loop counted once."""
    name, span = _draw_loop(sass, mode)
    ops = Counter(op for _, op, _, _ in span)
    units = _units(ops)
    return {"function": name, "mode": mode,
            "loop": [hex(span[0][0]), hex(span[-1][0])],
            "instructions_per_element": len(span), **units,
            "busiest_unit_per_element": units["busiest_unit"],
            "memory": sum(v for k, v in ops.items() if k in MEMORY),
            "by_opcode": dict(ops.most_common())}


def threefry_counts(sass: str) -> dict:
    """``draw_loop_counts`` of every mode of ``csrc/threefry.cu``."""
    return {name: draw_loop_counts(sass, mode)
            for name, mode in DRAW_MODES.items()}


PROBE_KERNELS = ("lanes_slots_kernel", "rearm_marks_kernel")


def probe_counts(sass: str, kernel: str = "lanes_slots_kernel") -> dict:
    """``probe::<kernel>`` of ``csrc/probe.cu`` in ``sass`` (one of
    ``PROBE_KERNELS``): its instructions per execution unit, each
    instruction of the function counted once (``--probe`` in the module
    docstring)."""
    name, insns = _function(sass, kernel, f"probe::{kernel}")
    ops = Counter(op for _, op, _, _ in insns)
    units = _units(ops)
    return {"function": name, "instructions": len(insns), **units,
            "memory": sum(v for k, v in ops.items() if k in MEMORY),
            "by_opcode": dict(ops.most_common())}


# observe::counts_kernel<hold> by form: its mangled template argument, the
# counts a row (warp sums), the 32-bit words a row of a thread.
OBSERVE_FORMS = {"final": ("counts_kernelILb0E", 3),
                 "spread": ("counts_kernelILb1E", 1)}
OBSERVE_WORDS_PER_ROW = 8  # kUnits (2) units of four words
_ENDS = {"BRA", "BRX", "JMP", "JMX", "EXIT", "RET", "BREAK"}


def _observe_loop(sass: str, form: str):
    pattern, _ = OBSERVE_FORMS[form]
    name, insns = _function(sass, pattern, f"counts_kernel ({form})")
    rows = [span for span in _loops(insns)
            if any(x[1] == "REDUX" for x in span)
            and any(x[1] == "LDG" and ".128" in x[3] for x in span)]
    if not rows:
        raise RuntimeError(f"no loop with REDUX and LDG.128 in {name}")
    return name, min(rows, key=len)


def _cheapest_path(span) -> list:
    """The instructions of the path through ``span`` (a loop: its head
    first, its backward branch last) from the head to the backward branch
    with the most 16-byte loads and, of those, the fewest integer
    instructions: basic blocks joined by their fall-throughs and forward
    branches inside the span."""
    addrs = [x[0] for x in span]
    lead = {addrs[0]}
    for i, (addr, op, _, text) in enumerate(span):
        t = re.search(r"0x([0-9a-f]+)", text)
        if op in _ENDS or (t and op.startswith("BR")):
            if i + 1 < len(span):
                lead.add(addrs[i + 1])
            if t and int(t.group(1), 16) in addrs:
                lead.add(int(t.group(1), 16))
    blocks, cur = [], []
    for x in span:
        if x[0] in lead and cur:
            blocks.append(cur)
            cur = []
        cur.append(x)
    blocks.append(cur)
    start = {b[0][0]: k for k, b in enumerate(blocks)}

    def cost(block):
        # The most 16-byte loads first (the next row's whole units loaded,
        # as in a row's steady state), then the fewest integer
        # instructions.
        return (-sum(x[1] == "LDG" and ".128" in x[3] for x in block),
                sum(x[1] in INT_ALU or x[1] in FMA or x[1] in FLEXIBLE
                    for x in block))

    def add(c, d):
        return (c[0] + d[0], c[1] + d[1])

    best: list = [None] * len(blocks)
    best[0] = (cost(blocks[0]), [0])
    for k, b in enumerate(blocks):
        if best[k] is None:
            continue
        addr, op, guard, text = b[-1]
        succ = []
        t = re.search(r"0x([0-9a-f]+)", text)
        if t and op.startswith("BR") and int(t.group(1), 16) in start:
            tgt = start[int(t.group(1), 16)]
            if tgt > k:
                succ.append(tgt)
        if op not in _ENDS or guard is not None:
            if k + 1 < len(blocks):
                succ.append(k + 1)
        for n in succ:
            c = add(best[k][0], cost(blocks[n]))
            if best[n] is None or c < best[n][0]:
                best[n] = (c, best[k][1] + [n])
    end = len(blocks) - 1
    if best[end] is None:
        raise RuntimeError("no path reaches the loop's backward branch")
    return [x for k in best[end][1] for x in blocks[k]]


def observe_counts(sass: str, form: str) -> dict:
    """The row loop of ``counts_kernel`` in ``form`` (``final`` or
    ``spread``) in ``sass``: the cheapest path's instructions per
    execution unit, per iteration and per 32-bit word (``--observe`` in
    the module docstring)."""
    name, span = _observe_loop(sass, form)
    path = _cheapest_path(span)
    ops = Counter(op for _, op, _, _ in path)
    units = _units(ops)
    rows = ops.get("REDUX", 0) / OBSERVE_FORMS[form][1]
    if rows < 1 or rows != int(rows):
        raise RuntimeError(f"{ops.get('REDUX', 0)} warp sums on the path "
                           f"of {name}")
    words = int(rows) * OBSERVE_WORDS_PER_ROW
    return {"function": name, "form": form,
            "loop": [hex(span[0][0]), hex(span[-1][0])],
            "instructions_in_loop": len(span),
            "instructions_on_path": len(path), "rows_per_iteration": rows,
            "words_per_iteration": words, **units,
            "memory": sum(v for k, v in ops.items() if k in MEMORY),
            "integer_alu_per_word": units["integer_alu"] / words,
            "fma_per_word": units["fma"] / words,
            "flexible_per_word": units["flexible"] / words,
            "busiest_unit_per_word": units["busiest_unit"] / words,
            "instructions_per_word": len(path) / words,
            "by_opcode": dict(ops.most_common())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fanout", type=int, default=3)
    ap.add_argument("--threefry", action="store_true",
                    help="count the draws' kernel, per mode")
    ap.add_argument("--flood", action="store_true",
                    help="count the event flood's slot loop")
    ap.add_argument("--probe", action="store_true",
                    help="count the probe tick's two kernels")
    ap.add_argument("--observe", action="store_true",
                    help="count the observers' kernel's row loops")
    args = ap.parse_args(argv)
    if args.observe:
        sass = disassemble("observe")
        out = {}
        for form in OBSERVE_FORMS:
            path = _cheapest_path(_observe_loop(sass, form)[1])
            for addr, _, guard, text in path:
                g = "" if guard is None else \
                    f"@{'' if guard[1] else '!'}{guard[0]} "
                print(f"{form} {addr:05x}  {g}{text}")
            out[form] = observe_counts(sass, form)
        print(json.dumps(out), flush=True)
        return 0
    if args.probe:
        sass = disassemble("probe")
        for kernel in PROBE_KERNELS:
            for addr, _, guard, text in _function(sass, kernel, kernel)[1]:
                g = "" if guard is None else \
                    f"@{'' if guard[1] else '!'}{guard[0]} "
                print(f"{addr:05x}  {g}{text}")
        print(json.dumps({k: probe_counts(sass, k) for k in PROBE_KERNELS}),
              flush=True)
        return 0
    if args.threefry:
        sass = disassemble("threefry")
        for addr, _, _, text in _draw_loop(sass, DRAW_MODES["uniform"])[1]:
            print(f"{addr:05x}  {text}")
        print(json.dumps(threefry_counts(sass)), flush=True)
        return 0
    name, kernel = (("event_flood", "flood_kernel") if args.flood
                    else ("dissem_tail", "tail_kernel"))
    sass = disassemble(name)
    for addr, _, guard, text in _row_loop(sass, args.fanout, kernel)[1]:
        g = "" if guard is None else f"@{'' if guard[1] else '!'}{guard[0]} "
        print(f"{addr:05x}  {g}{text}")
    print(json.dumps(row_loop_counts(sass, args.fanout, kernel)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
