"""The drain thread's sink spans (``utils/trace.py``): a traced CPU
conversion of config 3 (DSD128 .dsf -> 20-bit 88.2k FLAC, NJAD) records
``dsd2dxd.drain.njad`` and ``dsd2dxd.drain.flac``, each inside a
``dsd2dxd.drain.write`` on the drain thread; a conversion without NJAD
records no NJAD span, one without FLAC no FLAC span; the benchmark's
readers of both read them; ``Converter.stats`` counts their seconds and
the FLAC bytes."""

import json
from pathlib import Path

import numpy as np
import pytest

import dsd2dxd_tpu_torch.pipeline.engine as tengine
from benchmark import harness, tracing
from dsd2dxd_tpu_torch import Converter
from dsd2dxd_tpu_torch.formats.dsd_types import (
    DitherType,
    DsdRate,
    Endianness,
    FilterType,
    FmtType,
    OutputType,
)
from dsd2dxd_tpu_torch.formats.dsf import write_dsf
from dsd2dxd_tpu_torch.utils import trace

NJAD, FLAC, WRITE = ("dsd2dxd.drain.njad", "dsd2dxd.drain.flac",
                     "dsd2dxd.drain.write")
FLAC_HEADER = 42  # fLaC and STREAMINFO: no tag, so no other metadata


@pytest.fixture
def dsd128(tmp_path) -> Path:
    rng = np.random.default_rng(20)
    path = tmp_path / "in" / "t.dsf"
    path.parent.mkdir()
    write_dsf(path, rng.integers(0, 256, (2, 60000), dtype=np.uint8),
              5_644_800)
    return path


def convert(src: Path, out_dir: Path, output: OutputType, bits: int,
            dither: DitherType) -> Converter:
    conv = Converter.from_container(
        bit_depth=bits, output=output, level_db=0.0, output_rate=88200,
        out_dir=out_dir, dither=dither, filt=FilterType.EQUIRIPPLE,
        append_rate=False, base_dir=src.parent, input_path=src,
        device="cpu")
    conv.do_conversion()
    return conv


def host_spans(prof_dir: Path) -> list:
    path, = sorted(prof_dir.glob("*.pt.trace.json"))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X" and e.get("name", "").startswith("dsd2dxd.")]


def inside(e: dict, outer: list) -> bool:
    return any(o["tid"] == e["tid"] and o["ts"] <= e["ts"]
               and e["ts"] + e["dur"] <= o["ts"] + o["dur"] for o in outer)


@pytest.mark.parametrize("output, dither, spans", [
    (OutputType.FLAC, DitherType.NJAD, {NJAD, FLAC}),
    (OutputType.FLAC, DitherType.TPDF, {FLAC}),
    (OutputType.WAV, DitherType.NJAD, {NJAD}),
    (OutputType.WAV, DitherType.TPDF, set()),
    (OutputType.AIFC, DitherType.TPDF, set()),
])
def test_sink_spans_nest_in_the_drains_write(dsd128, tmp_path, monkeypatch,
                                             output, dither, spans):
    monkeypatch.setattr(tengine, "_DEFAULT_TILE_TARGET", 8 * 1024)
    prof_dir = tmp_path / "prof"
    monkeypatch.setenv(trace.ENV, str(prof_dir))
    conv = convert(dsd128, tmp_path / "out", output, 20, dither)
    events = host_spans(prof_dir)
    names = {e["name"] for e in events}
    assert names & {NJAD, FLAC} == spans
    writes = [e for e in events if e["name"] == WRITE]
    main_tid, = {e["tid"] for e in events if e["name"] == "dsd2dxd.read"}
    tiles = conv.stats["tiles"]
    assert tiles > 2 and len(writes) == tiles
    for name in spans:
        mine = [e for e in events if e["name"] == name]
        assert len(mine) == tiles  # one a tile: finalize's after the stream
        assert all(inside(e, writes) for e in mine)
        assert main_tid not in {e["tid"] for e in mine}

    # the benchmark's readers, as a --trace 1 run reads them
    s = tracing.summarise(prof_dir)
    s.audio_s = conv.stats["audio_s"]
    got = {name: harness.reader(name)(s) for name in (
        "njad_ms_per_audio_s", "flac_ms_per_audio_s", "write_ms_per_audio_s")}
    for name, span in (("njad_ms_per_audio_s", NJAD),
                       ("flac_ms_per_audio_s", FLAC)):
        if span in spans:
            assert got[name] == pytest.approx(
                sum(e["dur"] for e in events if e["name"] == span) / 1e3
                / conv.stats["audio_s"])
            assert 0 < got[name] < got["write_ms_per_audio_s"]
        else:
            assert got[name] is None

    # the counters beside write_s
    stats = conv.stats
    assert (stats["njad_s"] > 0) == (NJAD in spans)
    assert stats["njad_s"] < stats["write_s"]
    if output is OutputType.FLAC:
        assert 0 < stats["flac_s"]
        assert stats["flac_bytes"] == (conv.output_path().stat().st_size
                                       - FLAC_HEADER)
    else:
        assert stats["flac_s"] == 0.0 and stats["flac_bytes"] == 0


def test_an_untraced_run_counts_the_same(dsd128, tmp_path, monkeypatch):
    monkeypatch.setattr(tengine, "_DEFAULT_TILE_TARGET", 8 * 1024)
    monkeypatch.delenv(trace.ENV, raising=False)
    conv = convert(dsd128, tmp_path / "out", OutputType.FLAC, 20,
                   DitherType.NJAD)
    assert conv.stats["njad_s"] > 0 and conv.stats["flac_s"] > 0
    assert conv.stats["flac_bytes"] == (conv.output_path().stat().st_size
                                        - FLAC_HEADER)
    # a level check runs no sink: its counters are zero
    level = Converter.new_level_check(
        88200, dsd128, FmtType.PLANAR, Endianness.MSB_FIRST, 2, 4096,
        DsdRate.DSD128, device="cpu")
    level.check_level()
    assert (level.stats["njad_s"], level.stats["flac_s"],
            level.stats["flac_bytes"]) == (0.0, 0.0, 0)
