"""Count the SASS instructions on the hot paths of the port's kernels.

Run from the repository root on a machine with the CUDA toolkit:

    python3 -m tsu_tpu_torch.tools.sass_count [--sass FILE ...] [--out DIR] [--ptxas]
        [--lib NAME ...]

With no ``--sass`` it builds the four kernel libraries, or those ``--lib``
names (``ops/_build.py``),
and disassembles them with ``cuobjdump -sass``; ``--sass`` reads such dumps
instead. For every kernel function it prints its instruction count and, for
each innermost loop (a backward branch and the code it jumps over), the
address range, the instructions in the range, and the longest path through
one iteration of the body: the most instructions a thread can issue from the
loop head to the backward branch, every basic block counted once and the
back edge left out. Beside each count is the part that issues to the int32
pipe (IMAD, IADD3, LOP3, SHF, LEA, ISETP, SEL, PRMT and the other integer
opcodes; uniform-datapath U* instructions, loads, stores, conversions and
control are not counted there). A loop-free kernel reports its longest path
from entry to exit (the unguarded branch to itself that pads the end of
every kernel is no loop). The bond kernels (K4, K5) walk a strip of rows, a
row of a thread's four sites at a time: for them the longest path is also
given per row and its int32 part per site, from the innermost loop (weight
planes) or, where the template argument TR of the mangled name fixes the
strip at TR rows and the row loop is unrolled (codes), from the whole
kernel over TR rows, its set-up included. The half-sweep kernel (K3) walks
the same strips and is reported the same way; its per-site path should hold
no MUFU (exp, reciprocal) and no CALL (the slow path of a division): each
loop reports the MUFU and CALL instructions in it, and a kernel with a
barrier (K3 computes its threshold table before one) the MUFU and CALL
instructions reachable from the barrier by branches and fall-through, its
strip. For the resident kernel (K6, K7)
each loop's int32 part is also given per site: its hot loop is one lane's
eight sites (two Philox groups) in one half-step, so that figure is the
int32 instructions per site per sweep.

These are static counts of the compiled code: the longest path is the path
a thread takes when every optional step runs (a whole group of four sites,
every branch of the site loop), so an instruction-per-site figure derived
from them is an estimate of the work the card issues, not a measurement.
``--out DIR`` writes the dumps there. ``--ptxas`` compiles each source once
more with ``-Xptxas -v`` and prints every kernel's registers, stack frame
and spill bytes as ptxas reports them.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

_FUNC = re.compile(r"Function : (\S+)")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);")
_TARGET = re.compile(r"0x([0-9a-f]+)")
_INT_OPS = ("IMAD", "IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "LEA", "ISETP",
            "IMNMX", "IABS", "SEL", "PRMT", "VIADD", "VIMNMX", "BMSK", "SGXT", "BREV", "FLO",
            "POPC", "ICMP", "ISCADD", "IDP", "IMUL")
LIBRARIES = ("checkerboard_fused", "checkerboard_bonds", "checkerboard_resident",
             "checkerboard_halfsweep")
# K4, K5 and K3 (by a part of their names) walk a strip of rows, a row of a
# thread's four sites at a time; an iteration of K6/K7's item loop updates a
# lane's eight sites (a byte of a word, two Philox groups) once in a sweep.
STRIP_KERNELS, SITES_PER_ROW = ("bond_halfsweep", "halfsweep_kernel"), 4
RESIDENT_KERNEL, RESIDENT_SITES = "resident_kernel", 8
_FIXED_ROWS = re.compile(r"Li(\d+)EEEv")     # the last template argument, int TR


def fixed_rows(name: str) -> int:
    """The strip height TR fixed by a strip kernel's mangled name (its row
    loop unrolled), or 0."""
    m = _FIXED_ROWS.search(name)
    return int(m.group(1)) if m else 0


def is_strip(name: str) -> bool:
    """True for a kernel that walks a strip of rows, four sites a row."""
    return any(k in name for k in STRIP_KERNELS)


def is_special(op: str) -> bool:
    """True for a MUFU (exp, reciprocal, ...) or a CALL instruction."""
    return op.startswith(("MUFU", "CALL"))


def reachable(ins: list, start: int) -> list:
    """The instructions reachable from address ``start`` by branches
    (either way) and fall-through; a CALL is not followed."""
    index = {x[0]: i for i, x in enumerate(ins)}
    seen, todo = set(), [index[start]]
    while todo:
        i = todo.pop()
        if i in seen or i >= len(ins):
            continue
        seen.add(i)
        a, pred, op, args = ins[i]
        t = _target(op, args)
        if t is not None and t in index:
            todo.append(index[t])
        if pred or args.startswith(("P", "!P")) or op.startswith("BRA.DIV") or not (
                op.startswith("BRA") or op in ("EXIT", "RET")):
            todo.append(i + 1)
    return [ins[i] for i in sorted(seen)]


def is_int32(op: str) -> bool:
    """True for an opcode that issues to the int32 pipe."""
    return op.split(".")[0] in _INT_OPS


def parse(text: str) -> dict:
    """{function: [(address, predicated, opcode, operands), ...]} of a
    cuobjdump -sass listing."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), bool(m.group(2)), m.group(3), m.group(4)))
    return funcs


def _target(op: str, args: str):
    if not op.startswith("BRA"):
        return None
    found = _TARGET.findall(args)
    return int(found[-1], 16) if found else None


def longest_path(ins: list, lo: int, hi: int) -> tuple:
    """(instructions, int32 instructions) on the longest path from address lo
    to address hi (inclusive) through forward edges only."""
    body = [x for x in ins if lo <= x[0] <= hi]
    index = {x[0]: i for i, x in enumerate(body)}
    best = [None] * (len(body) + 1)       # best[i]: longest path from body[i] to the end
    best[len(body)] = (0, 0)
    for i in range(len(body) - 1, -1, -1):
        a, pred, op, args = body[i]
        own = (1, int(is_int32(op)))
        t = _target(op, args)
        nexts = []
        # A branch with a guard (@P) or a predicate operand, and BRA.DIV,
        # may fall through; a bare BRA, EXIT or RET does not.
        falls = pred or args.startswith(("P", "!P")) or op.startswith("BRA.DIV") or not (
            op.startswith("BRA") or op in ("EXIT", "RET"))
        if t is not None and t > a and t in index:
            nexts.append(best[index[t]])
        elif t is not None and t > hi:
            nexts.append((0, 0))          # leaves the range: the path ends here
        if falls:
            nexts.append(best[i + 1])
        tail = max(nexts) if nexts else (0, 0)
        best[i] = (own[0] + tail[0], own[1] + tail[1])
    return best[0] if body else (0, 0)


def _collective_return(ins: list, i: int) -> bool:
    """True where the branch ins[i] ends the out-of-line fallback of a
    shuffle that found its warp diverged (BRA.DIV jumps there; it runs
    WARPSYNC.COLLECTIVE, the shuffle and ENDCOLLECTIVE, and branches back):
    a return, not a loop."""
    for a, pred, op, args in reversed(ins[:i]):
        if op.startswith("ENDCOLLECTIVE"):
            return True
        if op.startswith(("BRA", "EXIT", "RET")):
            return False
    return False


def loops(ins: list) -> list:
    """Innermost loops as (head, branch address): backward branches whose
    range holds no other backward branch (the returns of a shuffle's
    divergent fallback are no loops)."""
    back = [(t, a) for i, (a, pred, op, args) in enumerate(ins)
            if (t := _target(op, args)) is not None and (t < a or t == a and pred)
            and not _collective_return(ins, i)]
    return [(h, b) for h, b in back
            if not any(h <= h2 and b2 <= b and (h2, b2) != (h, b) for h2, b2 in back)]


def report(funcs: dict) -> dict:
    out = {}
    for name, ins in funcs.items():
        if not ins:
            continue
        entry = {"instructions": len(ins),
                 "int32": sum(is_int32(x[2]) for x in ins), "loops": [],
                 "mufu_or_call_in_loops": []}
        for head, branch in loops(ins):
            entry["mufu_or_call_in_loops"].append(
                sum(head <= x[0] <= branch and is_special(x[2]) for x in ins))
            n, n_int = longest_path(ins, head, branch)
            loop = {"range": [hex(head), hex(branch)],
                    "instructions": sum(head <= x[0] <= branch for x in ins),
                    "longest_path": n, "longest_path_int32": n_int}
            if is_strip(name):
                loop["int32_per_site"] = n_int / SITES_PER_ROW
            elif RESIDENT_KERNEL in name:
                loop["int32_per_site"] = n_int / RESIDENT_SITES
            entry["loops"].append(loop)
        if not entry["loops"]:
            entry["longest_path"], entry["longest_path_int32"] = longest_path(
                ins, ins[0][0], ins[-1][0])
            if is_strip(name) and (rows := fixed_rows(name)):
                entry["rows"] = rows
                entry["int32_per_site"] = entry["longest_path_int32"] / (rows * SITES_PER_ROW)
        barrier = next((x[0] for x in ins if x[2].startswith("BAR")), None)
        if barrier is not None:
            entry["mufu_or_call_after_barrier"] = sum(
                is_special(x[2]) for x in reachable(ins, barrier))
        out[name] = entry
    return out


def dump_libraries(out_dir=None, libraries=LIBRARIES) -> dict:
    """Build the kernel libraries and disassemble them: {library: text}."""
    from tsu_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    dumps = {}
    for lib in libraries:
        path = _build.library_path(lib, (f"{lib}.cu",))
        dumps[lib] = subprocess.run([tool, "-sass", str(path)], check=True, capture_output=True,
                                    text=True).stdout
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            Path(out_dir, f"sass_{lib}.txt").write_text(dumps[lib])
    return dumps


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_PTXAS_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def ptxas_report(text: str) -> dict:
    """{kernel: {registers, stack, spill_stores, spill_loads}} from the
    output of ``nvcc -Xptxas -v``."""
    out, name = {}, None
    for line in text.splitlines():
        if m := _PTXAS_ENTRY.search(line):
            name = m.group(1)
            out[name] = {}
        elif name and (m := _PTXAS_SPILL.search(line)):
            out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        elif name and (m := _PTXAS_REGS.search(line)):
            out[name]["registers"] = int(m.group(1))
    return out


def ptxas_libraries(libraries=LIBRARIES) -> dict:
    """Compile every kernel source with -Xptxas -v: {library: report}."""
    from tsu_tpu_torch.ops import _build

    out = {}
    for lib in libraries:
        with tempfile.TemporaryDirectory() as tmp:
            proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                                   str(Path(tmp, "lib.so")), str(_build._CSRC / f"{lib}.cu")],
                                  check=True, capture_output=True, text=True)
        out[lib] = ptxas_report(proc.stderr)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sass", nargs="*", help="cuobjdump -sass listings to read")
    ap.add_argument("--out", help="directory for the listings")
    ap.add_argument("--ptxas", action="store_true",
                    help="also print registers and spills from nvcc -Xptxas -v")
    ap.add_argument("--lib", nargs="*", choices=LIBRARIES, default=list(LIBRARIES),
                    help="the libraries to build (default: all)")
    args = ap.parse_args(argv)
    dumps = ({Path(p).stem: Path(p).read_text() for p in args.sass} if args.sass
             else dump_libraries(args.out, args.lib))
    for lib, text in dumps.items():
        for name, r in report(parse(text)).items():
            print(f"{lib} {name}: {r['instructions']} instructions ({r['int32']} int32)")
            if "longest_path" in r:
                rows = (f"; {r['rows']} rows unrolled: {r['longest_path'] / r['rows']:.1f} "
                        f"per row, {r['int32_per_site']:.2f} int32 per site" if "rows" in r else "")
                print(f"    no loop; longest path {r['longest_path']} "
                      f"({r['longest_path_int32']} int32){rows}")
            if "mufu_or_call_after_barrier" in r:
                print(f"    {r['mufu_or_call_after_barrier']} MUFU or CALL reachable after the "
                      "barrier")
            for lp, special in zip(r["loops"], r["mufu_or_call_in_loops"]):
                per_row = (f"{' per row,' if is_strip(name) else ','} "
                           f"{lp['int32_per_site']:.2f} int32 per site"
                           if "int32_per_site" in lp else "")
                print(f"    loop {lp['range'][0]}-{lp['range'][1]}: {lp['instructions']} "
                      f"instructions, longest path {lp['longest_path']} "
                      f"({lp['longest_path_int32']} int32){per_row}; "
                      f"{special} MUFU or CALL")
    if args.ptxas:
        for lib, kernels in ptxas_libraries(args.lib).items():
            for name, r in kernels.items():
                print(f"ptxas {lib} {name}: {r.get('registers')} registers, {r.get('stack', 0)} B "
                      f"stack, {r.get('spill_stores', 0)} B spill stores, "
                      f"{r.get('spill_loads', 0)} B spill loads")
    return 0


if __name__ == "__main__":
    sys.exit(main())
