"""The config 3 cell (DSD128 .dsf -> 20-bit 88.2k FLAC with NJAD): a tiny
run on the CPU reads correct; a FLAC fault planted in the port's
writer, the reference in TF32 (the control) and a program that rounds
to 20 bits without NJAD each read not correct; on the card the control
fails at the cell's own size, and a short run is correct."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchmark import control, harness, inputs
from benchmark.reference import check, decimate

from .test_benchmark_faults import run_cell
from .test_benchmark_flac import Planted

CELL = "dsd128-88k2-s20-njad.album-flac"


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def limits() -> dict:
    return harness.load_cell(CELL).work["limits"]


def fails(max_abs: float, rms: float) -> bool:
    lim = limits()
    return not (harness.within(max_abs, lim["err_max_lsb"])
                and harness.within(rms, lim["err_rms_lsb"]))


def test_the_cell_reads_correct(tiny, capsys):
    line = run_cell(CELL, tiny, capsys, seconds=8)
    assert line["correct"] is True, line["check"]
    assert line["failed"] == 0 and line["attempted"] >= 5


def test_the_traced_cell_reads_its_spans(tiny, capsys):
    line = run_cell(CELL, tiny, capsys, trace=1, seconds=8)
    assert line["correct"] is True, line["check"]
    for name in ("njad_ms_per_audio_s", "flac_ms_per_audio_s"):
        assert line["metrics"][name]["value"] > 0
    assert "kernel_roofline_pct" not in line["metrics"]


@pytest.mark.parametrize("fault", ["flip", "truncate", "rate"])
def test_a_planted_flac_fault_reads_not_correct(fault, tiny, capsys,
                                                monkeypatch):
    from dsd2dxd_tpu_torch.containers import flac

    init = flac.FlacWriter.__init__

    def planted(self, f, *args, **kwargs):
        init(self, Planted(f, fault), *args, **kwargs)

    monkeypatch.setattr(flac.FlacWriter, "__init__", planted)
    line = run_cell(CELL, tiny, capsys, seconds=6)
    assert line["correct"] is False
    assert line["check"]["tracks_bad"]["value"] == line["attempted"]


def test_rounding_without_njad_reads_not_correct(tiny, capsys, monkeypatch):
    """20 bits, but rounded to nearest in NJAD's place: within the
    largest error, below the RMS band."""
    from dsd2dxd_tpu_torch.native import loader

    def rounded(self, state, samples, bits):
        top = float(1 << (bits - 1))
        v = np.round(np.asarray(samples, np.float64) * top)
        return np.clip(v, -top, top - 1).astype(np.int32)

    monkeypatch.setattr(loader.NativeLib, "njad_quantize", rounded)
    line = run_cell(CELL, tiny, capsys, seconds=8)
    assert line["correct"] is False
    assert line["check"]["tracks_bad"]["value"] == 0
    rms = line["check"]["err_rms_lsb"]
    assert rms["value"] < rms["limit"][0]


def test_the_control_fails_at_a_test_size():
    cfg = harness.load_cell(CELL).config
    prog = inputs.make_program(31, cfg["dsd_hz"], 2, [0.1], 0.01)
    chain = decimate.load_chain(cfg["chain"]["table"])
    planes = torch.from_numpy(prog.planes(0))
    frames = chain.frames(planes.shape[1] * 8)
    e = check.compare(chain, planes, frames, check.control_block(
        chain, planes, cfg["bit_depth"], cfg["dither"]), block=2000)
    assert fails(e.max_abs, e.rms), (e.max_abs, e.rms)


@pytest.mark.cuda
def test_the_control_fails_at_the_cells_size_on_the_card():
    needs_card()
    c = harness.load_cell(CELL)
    for seed in (2**31 + 301, 2**31 + 302, 2**31 + 303):
        row = control.control_numbers(c, seed, torch.device("cuda"))
        assert row["fails"], row


@pytest.mark.cuda
def test_a_short_run_is_correct_on_the_card(capsys):
    needs_card()
    # long enough for the first lap, which holds the compared tracks
    rc = harness.main(["--workload", CELL, "--seed", str(2**31 + 401),
                       "--seconds", "20", "--trace", "0"])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
