"""Count the instructions the card runs per belief word in the dissemination
tail's kernel, from its SASS, per execution unit.

    python -m consul_tpu_torch.sass_count [--fanout 3]

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


def disassemble() -> str:
    """The SASS of the built ``dissem_tail`` library."""
    from consul_tpu_torch import _build
    so = _build.build("dissem_tail")
    r = subprocess.run([cuobjdump(), "-sass", str(so)], capture_output=True,
                       text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {r.stderr}")
    return r.stdout


def _row_loop(sass: str, fanout: int):
    funcs = {k: v for k, v in _functions(sass).items()
             if f"tail_kernelILi{fanout}E" in k}
    if len(funcs) != 1:
        raise RuntimeError(f"expected one tail_kernel<{fanout}>, found "
                           f"{sorted(funcs)}")
    (name, insns), = funcs.items()
    best = None
    for addr, op, _, text in insns:
        t = re.search(r"0x([0-9a-f]+)", text)
        if op != "BRA" or not t or int(t.group(1), 16) >= addr:
            continue
        target = int(t.group(1), 16)
        span = [x for x in insns if target <= x[0] <= addr]
        if not any(x[1] == "LDG" and ".128" in x[3] for x in span):
            continue
        n_lop3 = sum(x[1] == "LOP3" for x in span)
        if best is None or n_lop3 > best[0]:
            best = (n_lop3, span)
    if best is None:
        raise RuntimeError(f"no loop with a 16-byte load found in {name}")
    return name, best[1]


def _units(ops: Counter) -> dict:
    alu = sum(v for k, v in ops.items() if k in INT_ALU)
    fma = sum(v for k, v in ops.items() if k in FMA)
    flex = sum(v for k, v in ops.items() if k in FLEXIBLE)
    # The flexible ones fill the less busy unit first.
    busiest = max(alu, fma, (alu + fma + flex + 1) // 2)
    return {"integer_alu": alu, "fma": fma, "flexible": flex,
            "busiest_unit": busiest}


def row_loop_counts(sass: str, fanout: int = 3) -> dict:
    """The word path's row loop of ``tail_kernel<fanout>`` in ``sass``:
    its instructions per execution unit, total and per word, for the setting
    of its guard predicates that leaves the busiest unit the fewest."""
    name, span = _row_loop(sass, fanout)
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
    return {"function": name, "fanout": fanout,
            "loop": [hex(span[0][0]), hex(span[-1][0])],
            "instructions_in_loop": len(span),
            "guarded_in_loop": sum(g is not None for _, _, g, _ in span),
            "predicates": dict(setting),
            "instructions": n_run, **units, "memory": n_mem,
            "words_per_iteration": 4,
            "integer_alu_per_word": units["integer_alu"] / 4,
            "fma_per_word": units["fma"] / 4,
            "flexible_per_word": units["flexible"] / 4,
            "busiest_unit_per_word": units["busiest_unit"] / 4,
            "instructions_per_word": n_run / 4,
            "by_opcode": dict(ops.most_common())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fanout", type=int, default=3)
    args = ap.parse_args(argv)
    sass = disassemble()
    for addr, _, guard, text in _row_loop(sass, args.fanout)[1]:
        g = "" if guard is None else f"@{'' if guard[1] else '!'}{guard[0]} "
        print(f"{addr:05x}  {g}{text}")
    print(json.dumps(row_loop_counts(sass, args.fanout)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
