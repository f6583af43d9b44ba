"""The plain reference against the port's own conversion on the CPU, at
a tiny size: both configurations, from a .dsf and from raw DSD on stdin
through the CLI."""

from __future__ import annotations

import io
import json
import sys

import numpy as np
import pytest
import torch

from benchmark import inputs
from benchmark.reference import check, containers, decimate

from .conftest import ROOT

CASES = [("dsd64-352k8-s24-tpdf", "w"), ("dsd256-384k-f32-fpd", "c"),
         ("dsd64-352k8-s24-tpdf", "S")]


def convert(cfg, out, tmp_path, prog):
    from dsd2dxd_tpu_torch.cli.dsd2dxd import run

    argv = [*cfg["argv"], "-o", out, "-q"]
    if out != "S":
        prog.write_dsf(0, tmp_path / "t.dsf")
        assert run([*argv, "-p", str(tmp_path), str(tmp_path / "t.dsf")],
                   device="cpu") == 0
        ext = {"w": "wav", "c": "aifc"}[out]
        return (tmp_path / f"t.{ext}").read_bytes()
    raw = containers.interleaved(prog.planes(0)).tobytes()
    saved = sys.stdin, sys.stdout
    sink = io.BytesIO()
    sys.stdin = io.TextIOWrapper(io.BytesIO(raw))
    sys.stdout = io.TextIOWrapper(sink, write_through=True)
    try:
        assert run([*argv, "-f", "I", "-e", "M", "-"], device="cpu") == 0
        sys.stdout.flush()
        return sink.getvalue()
    finally:
        sys.stdin, sys.stdout = saved


@pytest.mark.parametrize("config,out", CASES)
def test_reference_holds_the_port(config, out, tmp_path, monkeypatch):
    from dsd2dxd_tpu_torch.pipeline import engine

    monkeypatch.setattr(engine, "_DEFAULT_TILE_TARGET", 8 * 1024)
    cfg = json.loads((ROOT / "configs" / f"{config}.json").read_text())
    prog = inputs.make_program(77, cfg["dsd_hz"], 2, [0.03], 0.005)
    data = convert(cfg, out, tmp_path, prog)
    ext = {"w": "wav", "c": "aifc", "S": "pcm"}[out]
    lay = containers.parse(ext, data[:4096], 2, cfg["output_rate"],
                           cfg["bit_depth"])
    chain = decimate.load_chain(cfg["chain"]["table"])
    planes = torch.from_numpy(prog.planes(0))
    frames = chain.frames(planes.shape[1] * 8)
    assert (lay.channels, lay.rate) == (2, cfg["output_rate"])
    assert len(data) == lay.offset + frames * lay.frame_bytes
    payload = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    e = check.compare(chain, planes, frames, check.program_block(
        payload, lay, cfg["bit_depth"]), block=3000)
    assert e.n == 2 * frames
    # the float32 cascade's error and, at 24 bit, TPDF's 1 LSB and the
    # rounding's half
    assert e.max_abs < 3.0
    if cfg["bit_depth"] == 24:
        assert 0.45 < e.rms < 0.65
    else:
        assert e.rms < 0.4
