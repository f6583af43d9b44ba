"""The control of the check: the plain reference in the program's place,
computed in TF32 (the precision below the configurations' float32), has
to come out not correct -- here at a test's size on the CPU, and on the
card at each cell's own size on three seeds."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import control, harness, inputs
from benchmark.reference import check, decimate

from .conftest import ROOT

CELLS = ["dsd64-352k8-s24-tpdf.album-dsf", "dsd256-384k-f32-fpd.album-dsf"]


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.parametrize("config", ["dsd64-352k8-s24-tpdf",
                                    "dsd256-384k-f32-fpd"])
def test_control_fails_at_a_test_size(config):
    cfg = json.loads((ROOT / "configs" / f"{config}.json").read_text())
    prog = inputs.make_program(31, cfg["dsd_hz"], 2, [0.02], 0.005)
    chain = decimate.load_chain(cfg["chain"]["table"])
    planes = torch.from_numpy(prog.planes(0))
    frames = chain.frames(planes.shape[1] * 8)
    e = check.compare(chain, planes, frames, check.control_block(
        chain, planes, cfg["bit_depth"], cfg["dither"]), block=4000)
    limits = [harness.load_cell(c).work["limits"] for c in CELLS
              if c.startswith(config)]
    for lim in limits:
        assert not (harness.within(e.max_abs, lim["err_max_lsb"])
                    and harness.within(e.rms, lim["err_rms_lsb"]))
    # the same blocks in float64 are the reference itself
    f64 = check.compare(chain, planes, frames, lambda a, b: (
        decimate.output_block(chain, planes, a, b) * check.LSB24), block=4000)
    assert f64.max_abs == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size_on_the_card(cell):
    needs_card()
    c = harness.load_cell(cell)
    for seed in (2**31 + 301, 2**31 + 302, 2**31 + 303):
        row = control.control_numbers(c, seed, torch.device("cuda"))
        assert row["fails"], row


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_of_each_cell_is_correct_on_the_card(cell, capsys):
    needs_card()
    # long enough for the first lap, which holds the compared tracks
    rc = harness.main(["--workload", cell, "--seed", str(2**31 + 401),
                       "--seconds", "20", "--trace", "0"])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
