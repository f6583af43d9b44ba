"""The port's profiler hook (DSD2DXD_PROFILE_DIR, utils/trace.py) on the
CPU: one Chrome trace per stream with the named host spans of the reader
and the drain thread, on the streaming and the sharded route, the output
bytes those of an untraced run; no profiler without the variable;
concurrent streams; a cancelled stream."""

import json
import logging
import threading
from pathlib import Path

import pytest
import torch

import dsd2dxd_tpu_torch.pipeline.engine as tengine
from dsd2dxd_tpu_torch import Converter
from dsd2dxd_tpu_torch.formats.dsd_types import (
    DitherType,
    FilterType,
    OutputType,
)
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


def _spans(path: Path) -> dict:
    """{span name: [tid of each occurrence]} of the trace's dsd2dxd.*
    host spans."""
    events = json.loads(path.read_text())["traceEvents"]
    spans: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("name", "").startswith("dsd2dxd."):
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
    """Two streams on two threads, both inside their loop at once: one
    writes the trace, the other converts untraced with one warning; both
    outputs are those of untraced runs and nothing raises."""
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
    assert "dsd2dxd.drain.write" in _spans(path)
    note, = [w for w in warnings if trace.ENV in w]
    assert tone_dsd64_stereo_dsf.name in note


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
    assert not trace._SESSION.locked()
