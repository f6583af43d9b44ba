"""The read split's readers (``read_planes_ms_per_audio_s``,
``read_bitrev_ms_per_audio_s``) and the idle time under the read's two
halves, on a synthetic trace."""

from __future__ import annotations

import pytest

from benchmark import harness

from .test_benchmark_tracing import trace, x


def split_trace(tmp_path):
    """One stream of two tiles: each read is its planes, then its bit
    reversal, then a little of the read's own; one kernel runs between
    the reads."""
    return trace(tmp_path, [
        x("dsd2dxd.stream", 0, 1000),
        x("dsd2dxd.read", 0, 400), x("dsd2dxd.read.planes", 0, 250),
        x("dsd2dxd.read.bitrev", 250, 140),
        x("k(int)", 400, 100, tid=9, cat="kernel"),
        x("dsd2dxd.read", 500, 400), x("dsd2dxd.read.planes", 500, 230),
        x("dsd2dxd.read.bitrev", 730, 160),
        x("dsd2dxd.drain.write", 420, 50, tid=2)])


def test_the_halves_per_audio_second(tmp_path):
    s = split_trace(tmp_path)
    planes = harness.reader("read_planes_ms_per_audio_s")
    bitrev = harness.reader("read_bitrev_ms_per_audio_s")
    assert planes(s) is None and bitrev(s) is None  # no audio
    s.audio_s = 0.01
    assert planes(s) == pytest.approx(0.48 / 0.01)
    assert bitrev(s) == pytest.approx(0.30 / 0.01)
    whole = harness.reader("read_ms_per_audio_s")(s)
    assert whole == pytest.approx(0.8 / 0.01)
    assert 0.9 * whole <= planes(s) + bitrev(s) <= whole


def test_each_idle_gap_goes_whole_to_the_half_at_its_middle(tmp_path):
    """The card idles from 0 to 400 and from 500 to 1000: the first gap's
    middle (200) lies in the first tile's planes, the second's (750) in
    the second tile's bit reversal. Each gap goes whole to that span."""
    s = split_trace(tmp_path)
    assert s.idle_by_span == {"dsd2dxd.read.planes": 400,
                              "dsd2dxd.read.bitrev": 500}
    gaps = dict(s.breakdown()["idle_gaps"])
    assert gaps == {"dsd2dxd.read.bitrev": 500e-6,
                    "dsd2dxd.read.planes": 400e-6}


def test_a_program_without_the_split_reads_nothing(tmp_path):
    """A trace of a program that opens no read.planes or read.bitrev span
    (the parent's): both readers return None and the whole read still
    reads."""
    s = trace(tmp_path, [x("dsd2dxd.stream", 0, 1000),
                         x("dsd2dxd.read", 0, 600)])
    s.audio_s = 0.01
    assert harness.reader("read_planes_ms_per_audio_s")(s) is None
    assert harness.reader("read_bitrev_ms_per_audio_s")(s) is None
    assert harness.reader("read_ms_per_audio_s")(s) == pytest.approx(60.0)


def test_an_msb_first_stream_has_no_bitrev(tmp_path):
    s = trace(tmp_path, [x("dsd2dxd.stream", 0, 1000),
                         x("dsd2dxd.read", 0, 600),
                         x("dsd2dxd.read.planes", 0, 590)])
    s.audio_s = 0.01
    assert harness.reader("read_planes_ms_per_audio_s")(s) == pytest.approx(
        59.0)
    assert harness.reader("read_bitrev_ms_per_audio_s")(s) is None
