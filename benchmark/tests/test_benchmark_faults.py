"""A run of each cell, on the CPU at a tiny size, with the timed path
broken underneath the harness: `correct` comes out false for each fault
the cell can have, and true without one. One chip, so no exchange
between chips can be left out."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import harness

from .conftest import FLAC_CELL

# the raw pipe's workload is not a cell of BENCHMARK.json (PERF.md): the
# tiny copy lists it, so that the stdin entry stays tested; nor is the
# tests' own FLAC cell (tests/flac/), which holds the FLAC reader
CELLS = ["dsd64-352k8-s24-tpdf.album-dsf", "dsd64-352k8-s24-tpdf.raw-pipe",
         "dsd256-384k-f32-fpd.album-dsf", "dsd64-352k8-s24-tpdf.library-batch",
         FLAC_CELL]


def break_step(monkeypatch, fault: str) -> None:
    """Wrap every step the engine builds with `fault`: "state" returns the
    state it was given (the stream's halo never advances), "half" leaves
    the second half of each tile's frames out (zero bytes), "alter" adds
    2^15 to one sample of each tile where the step produces it."""
    from dsd2dxd_tpu_torch.pipeline import engine

    built = engine._cached_step

    def cached_step(*args, **kwargs):
        step, make_state = built(*args, **kwargs)

        def broken(x, state, key, n_valid):
            out, peak, new_state = step(x, state, key, n_valid)
            if fault == "state":
                return out, peak, state
            out = out.clone()
            if fault == "half":
                out[out.numel() // 2:] = 0
            else:
                i = (out.numel() // 3) // 12 * 12 + 2  # a sample's top byte
                out[i] = (int(out[i]) + 128) % 256
            return out, peak, new_state

        return broken, make_state

    monkeypatch.setattr(engine, "_cached_step", cached_step)


def run_cell(cell: str, root, capsys, trace: int = 0,
             seconds: float = 3) -> dict:
    rc = harness.main(["--workload", cell, "--seed", str(2**31 + 99),
                       "--seconds", str(seconds), "--trace", str(trace)],
                      device="cpu", root=root)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, trace, tiny, capsys):
    # a window long enough for the first lap on a loaded CPU: it holds
    # the compared tracks
    line = run_cell(cell, tiny, capsys, trace, seconds=6)
    assert line["correct"] is True
    assert line["failed"] == 0 and line["attempted"] >= 3
    assert list(line)[-1] == "check"
    assert "device_idle_pct" in line["metrics"] if trace else \
        "audio_xrt" in line["metrics"]


@pytest.mark.parametrize("fault", ["state", "half", "alter"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(cell, fault, tiny, capsys,
                                          monkeypatch):
    torch.manual_seed(0)
    break_step(monkeypatch, fault)
    # the sound runs' window: long enough for the first lap on a loaded
    # CPU, so that the compared tracks are in it
    line = run_cell(cell, tiny, capsys, seconds=6)
    assert line["correct"] is False
    assert line["check"]["err_max_lsb"]["value"] > \
        line["check"]["err_max_lsb"]["limit"]
