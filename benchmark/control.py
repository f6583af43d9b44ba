"""The control of a cell's check, at the cell's own size: the plain
reference put in the program's place, computed in TF32 with the
configuration's epilogue, compared as a run compares the program's
output, for the tracks a run with that seed keeps.

    python -m benchmark.control --workload CELL --seeds 1,2,3

prints one JSON line per seed with the control's numbers beside the
cell's limits; every seed's must fail them. Runs on cuda:0.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark import harness, inputs
from benchmark.reference import check, decimate


def control_numbers(cell: harness.Cell, seed: int, device) -> dict:
    work, cfg = cell.work, cell.config
    prog = inputs.make_program(seed, cfg["dsd_hz"], cfg["channels"],
                               work["tracks_s"], work["segment_s"])
    chain = decimate.load_chain(cfg["chain"]["table"])
    errs = check.Errors()
    for i in sorted(harness.kept_tracks(work, seed)):
        planes = torch.from_numpy(prog.planes(i)).to(device)
        frames = chain.frames(planes.shape[1] * 8)
        errs.merge(check.compare(
            chain, planes, frames,
            check.control_block(chain, planes, cfg["bit_depth"],
                                cfg["dither"], seed=seed),
            gain=10.0 ** (cfg["level_db"] / 20.0)))
    lim = work["limits"]
    return {"seed": seed, "err_max_lsb": errs.max_abs,
            "err_rms_lsb": errs.rms, "compared": errs.n,
            "fails": not (harness.within(errs.max_abs, lim["err_max_lsb"])
                          and harness.within(errs.rms, lim["err_rms_lsb"])),
            "limits": lim}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    a = p.parse_args(argv)
    cell = harness.load_cell(a.workload)
    ok = True
    for s in (int(x) for x in a.seeds.split(",")):
        row = control_numbers(cell, s, torch.device("cuda"))
        ok &= row["fails"]
        print(json.dumps(row), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
