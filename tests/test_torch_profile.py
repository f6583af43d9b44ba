"""The port's profiler hook (DSD2DXD_PROFILE_DIR, utils/trace.py) on the
CPU: one Chrome trace per stream with the named host spans of the reader
and the drain thread, on the streaming and the sharded route, the output
bytes those of an untraced run; the read split into its planes and its
bit reversal; no profiler without the variable; concurrent streams and a
traced CLI batch in one shared session; a session the hook did not open;
a cancelled stream."""

import json
import logging
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import dsd2dxd_tpu_torch.cli.dsd2dxd as tcli
import dsd2dxd_tpu_torch.pipeline.engine as tengine
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
from dsd2dxd_tpu_torch.utils.errors import CancelledError, ConfigError
from dsd2dxd_tpu_torch.utils.logging import get_logger

SPANS = ("dsd2dxd.stream", "dsd2dxd.setup", "dsd2dxd.read",
         "dsd2dxd.stage", "dsd2dxd.wait_drain", "dsd2dxd.drain.write",
         "dsd2dxd.finish")


@pytest.fixture
def small_tiles(monkeypatch):
    monkeypatch.setattr(tengine, "_DEFAULT_TILE_TARGET", 16 * 1024)


def _convert(src: Path, out_dir: Path, rate: int = 352800, **kw):
    conv = Converter.from_container(
        bit_depth=24, output=OutputType.WAV, level_db=-1.0,
        output_rate=rate, out_dir=out_dir, dither=DitherType.TPDF,
        filt=FilterType.EQUIRIPPLE, append_rate=False, base_dir=src.parent,
        input_path=src, device="cpu")
    conv.do_conversion(**kw)
    return conv


def _traces(prof_dir: Path) -> list:
    return sorted(prof_dir.glob("*.pt.trace.json"))


def _events(path: Path) -> list:
    """The trace's dsd2dxd.* host spans, in the order it lists them."""
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X"
            and e.get("name", "").startswith("dsd2dxd.")]


def _spans(path: Path) -> dict:
    """{span name: [tid of each occurrence]} of the trace's dsd2dxd.*
    host spans."""
    spans: dict = {}
    for e in _events(path):
        spans.setdefault(e["name"], []).append(e["tid"])
    return spans


@pytest.mark.parametrize("rate", [352800, 96000])
def test_trace_per_stream_holds_both_threads_spans(tone_dsd64_stereo_dsf,
                                                   tmp_path, small_tiles,
                                                   monkeypatch, rate):
    """One trace for one stream, named after its file; every span of the
    loop in it, drain.write on the drain thread; the output bytes those
    of an untraced run."""
    plain = _convert(tone_dsd64_stereo_dsf, tmp_path / "plain", rate)
    prof_dir = tmp_path / "prof"  # the hook creates it
    monkeypatch.setenv(trace.ENV, str(prof_dir))
    traced = _convert(tone_dsd64_stereo_dsf, tmp_path / "traced", rate)
    assert (traced.output_path().read_bytes()
            == plain.output_path().read_bytes())
    path, = _traces(prof_dir)
    assert path.name.startswith(f"{tone_dsd64_stereo_dsf.name}_")
    spans = _spans(path)
    assert set(SPANS) <= set(spans)
    assert len(spans["dsd2dxd.stream"]) == 1
    assert len(spans["dsd2dxd.read"]) == traced.stats["tiles"] + 1  # EOF
    assert len(spans["dsd2dxd.stage"]) == traced.stats["tiles"]
    main_tid, = set(spans["dsd2dxd.read"])
    assert spans["dsd2dxd.stream"] == [main_tid]
    assert main_tid not in spans["dsd2dxd.drain.write"]


def test_unset_makes_no_profiler(tone_dsd64_stereo_dsf, tmp_path, small_tiles,
                                 monkeypatch):
    """Without the variable no profiler object is made, no span opens and
    nothing but the output is written."""
    monkeypatch.delenv(trace.ENV, raising=False)

    def refuse(*a, **k):
        raise AssertionError("a profiler was made")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.chdir(tmp_path)
    conv = _convert(tone_dsd64_stereo_dsf, tmp_path / "out")
    assert conv.stats["tiles"] > 2
    assert [p for p in tmp_path.rglob("*") if p.is_file()] == [
        conv.output_path()]


def test_concurrent_streams_one_trace(tone_dsd64_stereo_dsf, tmp_path,
                                      small_tiles, monkeypatch):
    """Two streams on two threads, both inside their loop at once: both
    record into the one shared session, which writes one trace with each
    stream's spans on its own thread; no warning is logged, both outputs
    are those of untraced runs and nothing raises."""
    want = [_convert(tone_dsd64_stereo_dsf, tmp_path / f"plain{i}")
            .output_path().read_bytes() for i in range(2)]
    prof_dir = tmp_path / "prof"
    monkeypatch.setenv(trace.ENV, str(prof_dir))
    both_in = threading.Barrier(2, timeout=60)
    warnings: list = []
    handler = logging.Handler()
    handler.emit = lambda r: warnings.append(r.getMessage())
    log = get_logger()
    log.addHandler(handler)
    level = log.level
    log.setLevel(logging.INFO)
    got, errors = [None, None], []

    def job(i):
        waited = []

        def progress(_update):
            if not waited:  # the first tile: wait until both streams run
                waited.append(True)
                both_in.wait()

        try:
            got[i] = _convert(tone_dsd64_stereo_dsf, tmp_path / f"t{i}",
                              progress=progress).output_path().read_bytes()
        except BaseException as e:  # noqa: BLE001 - asserted below
            errors.append(e)

    threads = [threading.Thread(target=job, args=(i,)) for i in range(2)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert got == want
    path, = _traces(prof_dir)
    spans = _spans(path)
    assert len(spans["dsd2dxd.stream"]) == 2
    assert len(set(spans["dsd2dxd.stream"])) == 2  # one per thread
    assert set(spans["dsd2dxd.stream"]) == set(spans["dsd2dxd.read"])
    assert len(spans["dsd2dxd.drain.write"]) >= 2
    assert [w for w in warnings if trace.ENV in w] == []
    assert trace._holders == 0 and not trace._open


@pytest.mark.parametrize("run", range(3))
def test_traced_cli_batch_one_trace(tmp_path, small_tiles, monkeypatch, run):
    """The CLI's -R batch on 4 workers with the variable set: it exits 0,
    its outputs are those of an untraced batch byte for byte, and it
    writes exactly one trace, which holds every file's stream on the
    workers' threads."""
    lib = tmp_path / "lib"
    lib.mkdir()
    rng = np.random.default_rng(run)
    for i in range(6):
        write_dsf(lib / f"t{i}.dsf",
                  rng.integers(0, 256, (2, 20000 + 3000 * i), dtype=np.uint8),
                  2_822_400)
    monkeypatch.setattr(tcli, "worker_count", lambda: 4)

    def batch(out_dir: Path) -> dict:
        out_dir.mkdir()
        rc = tcli.run(["-R", "-q", "-o", "w", "-p", str(out_dir), str(lib)],
                      device="cpu")
        assert rc == 0
        return {p.relative_to(out_dir): p.read_bytes()
                for p in out_dir.rglob("*.wav")}

    plain = batch(tmp_path / "plain")
    assert len(plain) == 6
    prof_dir = tmp_path / "prof"
    monkeypatch.setenv(trace.ENV, str(prof_dir))
    assert batch(tmp_path / "traced") == plain
    path, = _traces(prof_dir)
    assert path.name.startswith("batch_")
    spans = _spans(path)
    assert len(spans["dsd2dxd.stream"]) == 6
    assert len(set(spans["dsd2dxd.stream"])) >= 2
    assert trace._holders == 0 and not trace._open


@pytest.mark.parametrize("route", ["dsf", "raw-msb", "sharded"])
def test_read_split_per_tile(tone_dsd64_stereo_dsf, tmp_path, small_tiles,
                             monkeypatch, route):
    """Each read of the source opens one dsd2dxd.read.planes and, for an
    LSB-first stream (every .dsf), one dsd2dxd.read.bitrev, both inside
    its dsd2dxd.read on the reader's thread; an MSB-first stream has no
    bitrev span; the sharded route has both."""
    if route == "sharded":
        monkeypatch.setattr(tengine, "stream_devices",
                            lambda: [torch.device("cpu")] * 4)
    prof_dir = tmp_path / "prof"
    monkeypatch.setenv(trace.ENV, str(prof_dir))
    if route == "raw-msb":  # interleaved stereo, 40000 bytes per channel
        src = tmp_path / "in.dsd"
        src.write_bytes(np.random.default_rng(7).integers(
            0, 256, 80000, dtype=np.uint8).tobytes())
        conv = Converter.new(
            bit_depth=24, output=OutputType.WAV, level_db=0.0,
            output_rate=352800, out_dir=tmp_path / "out",
            dither=DitherType.TPDF, fmt=FmtType.INTERLEAVED,
            endian=Endianness.MSB_FIRST, input_rate=DsdRate.DSD64,
            block_size=4096, channels=2, filt=FilterType.EQUIRIPPLE,
            append_rate=False, base_dir=tmp_path, input_path=src,
            device="cpu")
        conv.do_conversion()
    else:
        conv = _convert(tone_dsd64_stereo_dsf, tmp_path / "out")
    path, = _traces(prof_dir)
    events = _events(path)
    reads = [e for e in events if e["name"] == "dsd2dxd.read"]
    planes = [e for e in events if e["name"] == "dsd2dxd.read.planes"]
    bitrev = [e for e in events if e["name"] == "dsd2dxd.read.bitrev"]

    def inside(e, outer):
        return (e["tid"] == outer["tid"] and outer["ts"] <= e["ts"]
                and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"])

    tiles = conv.stats["tiles"]
    if route == "sharded":
        assert conv.stats["devices"] == ["cpu"] * 4
        assert planes and len(bitrev) == len(planes)
    else:
        # one read per tile and the one that finds the end
        assert len(reads) == tiles + 1 and len(planes) == tiles
        assert len(bitrev) == (0 if route == "raw-msb" else tiles)
    for e in planes + bitrev:
        assert any(inside(e, r) for r in reads), e
    reader_tid = {r["tid"] for r in reads}
    assert {e["tid"] for e in planes + bitrev} <= reader_tid
    assert len(reader_tid) == 1


def test_foreign_session_opens_none(tone_dsd64_stereo_dsf, tmp_path,
                                    small_tiles, monkeypatch):
    """A profiler session the hook did not open is running: the stream
    converts as untraced, writes no trace, records no dsd2dxd span in that
    session and logs the fact once."""
    plain = _convert(tone_dsd64_stereo_dsf, tmp_path / "plain")
    monkeypatch.setattr(trace, "_foreign_noted", False)
    prof_dir = tmp_path / "prof"
    monkeypatch.setenv(trace.ENV, str(prof_dir))
    warnings: list = []
    handler = logging.Handler()
    handler.emit = lambda r: warnings.append(r.getMessage())
    log = get_logger()
    log.addHandler(handler)
    level = log.level
    log.setLevel(logging.INFO)
    try:
        with torch.profiler.profile() as foreign:
            outs = [_convert(tone_dsd64_stereo_dsf, tmp_path / f"t{i}")
                    .output_path().read_bytes() for i in range(2)]
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
    assert outs == [plain.output_path().read_bytes()] * 2
    assert _traces(prof_dir) == []
    assert not [e for e in foreign.events()
                if e.name.startswith("dsd2dxd.")]
    assert len([w for w in warnings if trace.ENV in w]) == 1
    assert trace._holders == 0 and not trace._open
    # the foreign session over, the next stream is traced
    _convert(tone_dsd64_stereo_dsf, tmp_path / "after")
    assert len(_traces(prof_dir)) == 1


def test_sharded_route_traced(tone_dsd64_stereo_dsf, tmp_path, small_tiles,
                              monkeypatch):
    """DSD2DXD_SHARD_STREAM's route over four CPU entries: one trace with
    the same span names, the output that of the streaming route."""
    plain = _convert(tone_dsd64_stereo_dsf, tmp_path / "plain")
    monkeypatch.setattr(tengine, "stream_devices",
                        lambda: [torch.device("cpu")] * 4)
    prof_dir = tmp_path / "prof"
    monkeypatch.setenv(trace.ENV, str(prof_dir))
    conv = _convert(tone_dsd64_stereo_dsf, tmp_path / "sharded")
    assert conv.stats["devices"] == ["cpu"] * 4
    assert conv.output_path().read_bytes() == plain.output_path().read_bytes()
    path, = _traces(prof_dir)
    spans = _spans(path)
    assert {"dsd2dxd.stream", "dsd2dxd.setup", "dsd2dxd.read",
            "dsd2dxd.stage", "dsd2dxd.drain.write"} <= set(spans)
    assert not set(spans["dsd2dxd.drain.write"]) & set(spans["dsd2dxd.read"])


def test_cancelled_stream_writes_its_trace(tone_dsd64_stereo_dsf, tmp_path,
                                           small_tiles, monkeypatch):
    prof_dir = tmp_path / "prof"
    monkeypatch.setenv(trace.ENV, str(prof_dir))
    calls = []

    def cancel():
        calls.append(1)
        return len(calls) > 2  # after two tiles

    with pytest.raises(CancelledError):
        _convert(tone_dsd64_stereo_dsf, tmp_path / "out", cancel=cancel)
    path, = _traces(prof_dir)
    spans = _spans(path)
    assert len(spans["dsd2dxd.stage"]) == 2 and "dsd2dxd.finish" in spans
    # the session is free again: the next stream is traced
    _convert(tone_dsd64_stereo_dsf, tmp_path / "out")
    assert len(_traces(prof_dir)) == 2


def test_profiler_without_all_threads_refuses(tone_dsd64_stereo_dsf,
                                              tmp_path, small_tiles,
                                              monkeypatch):
    """A torch whose profiler cannot record every thread would trace the
    reader alone: the hook refuses with a ConfigError that says so."""
    def old_config(**kw):
        raise TypeError(f"unexpected keywords {sorted(kw)}")

    monkeypatch.setattr(torch._C._profiler, "_ExperimentalConfig", old_config)
    monkeypatch.setenv(trace.ENV, str(tmp_path / "prof"))
    with pytest.raises(ConfigError, match="profile_all_threads"):
        _convert(tone_dsd64_stereo_dsf, tmp_path / "out")
    assert trace._holders == 0 and not trace._open
    # nothing is held: with the config back, the next stream is traced
    monkeypatch.undo()
    monkeypatch.setattr(tengine, "_DEFAULT_TILE_TARGET", 16 * 1024)
    monkeypatch.setenv(trace.ENV, str(tmp_path / "prof"))
    _convert(tone_dsd64_stereo_dsf, tmp_path / "out2")
    assert len(_traces(tmp_path / "prof")) == 1
