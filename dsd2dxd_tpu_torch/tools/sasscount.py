"""Static SASS instruction counts of the port's kernels.

Builds the kernel library (``kernels.build``), disassembles it with the
CUDA toolkit's ``cuobjdump -sass`` and prints, for every kernel whose
name contains ``--match``, its instructions in all and by class: 32-bit
integer multiplies (IMAD*), three-input logic (LOP3), integer adds
(IADD3), f32 products and sums (FMUL, FADD, FFMA: the kernels must have no
FFMA in their sums), shared-memory, global and local (stack) loads and
stores; and the Philox rounds' own instructions: PHILOX_MUL, the
multiplies by the two Philox constants, and XOR, the LOP3s that are two-
or three-input xors.
The counts are of the code, not of a run: a loop body counts once.

    python -m dsd2dxd_tpu_torch.tools.sasscount [--match finish_kernel]

K2 "from z" finishes four samples per thread in straight-line code, so one
Philox4x32-10 call is a quarter of ``finish_kernel<24,1>``'s PHILOX_MUL and
XOR; with its dither it is the difference between that kernel (TPDF) and
``finish_kernel<24,0>`` (NONE) over the four samples
(``philox_per_sample``; the compiler arranges the rest of the two kernels
differently, so this is within a few instructions).

It needs nvcc and cuobjdump (no card) and has no CPU mode.
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

from dsd2dxd_tpu_torch import kernels

CLASSES = ("IMAD", "LOP3", "IADD3", "FMUL", "FADD", "FFMA", "LDS", "STS",
           "LDG", "STG", "LDL", "STL", "BAR", "PHILOX_MUL", "XOR")
# 0xD2511F53 and 0xCD9E8D57 as cuobjdump prints them (negative immediates)
_PHILOX_CONSTANTS = ("0x2daee0ad", "0x326172a9")
_XOR_LUTS = (", 0x96,", ", 0x3c,")  # a ^ b ^ c and a ^ b
_INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\d+\s+)?([A-Z][A-Z0-9_]*)")
_FUNC = re.compile(r"Function : (\S+)")
_NAME = re.compile(r"_Z(\d+)")


def demangled(mangled: str) -> str:
    """'kernel<template ints>' of an Itanium-mangled kernel name."""
    m = _NAME.match(mangled)
    if not m:
        return mangled
    n = int(m.group(1))
    base = mangled[m.end():m.end() + n]
    return f"{base}<{','.join(re.findall(r'L[ib](\d+)E', mangled))}>"


def count_sass(text: str) -> dict:
    """{kernel: Counter of opcode -> instructions, with "all"} from the
    output of ``cuobjdump -sass``."""
    out: dict = {}
    cur = None
    for ln in text.splitlines():
        m = _FUNC.search(ln)
        if m:
            cur = out.setdefault(demangled(m.group(1)), Counter())
            continue
        m = _INSTR.search(ln)
        if m and cur is not None:
            cur["all"] += 1
            cur[m.group(1)] += 1
            if any(k in ln for k in _PHILOX_CONSTANTS):
                cur["PHILOX_MUL"] += 1
            if m.group(1) == "LOP3" and any(k in ln for k in _XOR_LUTS):
                cur["XOR"] += 1
    return out


def philox_per_sample(counts: dict) -> float:
    """Instructions of one Philox call and its dither in K2 "from z"."""
    return (counts["finish_kernel<24,1>"]["all"]
            - counts["finish_kernel<24,0>"]["all"]) / 4


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="sasscount", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--match", default="finish",
                    help="print the kernels whose name contains this")
    args = ap.parse_args(argv)
    nvcc = Path(kernels.find_nvcc())
    tool = nvcc.with_name("cuobjdump")
    if not tool.is_file():
        found = shutil.which("cuobjdump")
        if not found:
            raise RuntimeError("cuobjdump not found beside nvcc or on PATH")
        tool = Path(found)
    res = subprocess.run([str(tool), "-sass", str(kernels.build())],
                         capture_output=True, text=True, check=True)
    counts = count_sass(res.stdout)
    for name in sorted(counts):
        if args.match not in name:
            continue
        c = counts[name]
        parts = [f"{pre} {sum(v for op, v in c.items() if op.startswith(pre))}"
                 for pre in CLASSES]
        print(f"{name}: {c['all']} instructions; " + ", ".join(parts))
    if "finish_kernel<24,1>" in counts and "finish_kernel<24,0>" in counts:
        t = counts["finish_kernel<24,1>"]
        print(f"one Philox4x32-10 call in finish_kernel<24,1>: "
              f"{t['PHILOX_MUL'] / 4:.2f} multiplies by its constants, "
              f"{t['XOR'] / 4:.2f} xors; with its dither (<24,1> - <24,0>, "
              f"per sample): {philox_per_sample(counts):.1f} instructions")
    return counts


if __name__ == "__main__":
    main()
    sys.exit(0)
