"""audio_xrt and track_s_p95 on a synthetic window."""

from __future__ import annotations

import pytest

from benchmark import stats


def test_audio_xrt_is_all_the_work_over_all_the_time():
    audio = [165, 210, 255, 300, 345, 390]
    assert stats.audio_xrt(audio, 8.325) == pytest.approx(200.0)
    # a stall in one track lowers the rate by all the time it took
    assert stats.audio_xrt(audio, 8.325 + 10.0) == pytest.approx(
        1665 / 18.325)


def test_track_s_p95_with_one_long_stall():
    walls = [1.0] * 19 + [11.0]  # 20 tracks, one stalled 10 s
    # the 95th percentile lies between the 19th and 20th order statistic
    assert stats.track_s_p95(walls) == pytest.approx(1.0 + 0.05 * 10.0)
    assert stats.track_s_p95([2.5]) == 2.5
    walls = [0.5 + 0.01 * k for k in range(100)]
    assert stats.track_s_p95(walls) == pytest.approx(0.5 + 0.01 * 94.05)


def test_track_wall_p95_s_reads_the_traced_walls():
    from benchmark import harness, tracing

    read = harness.reader("track_wall_p95_s")
    assert read(tracing.Summary()) is None
    assert read(tracing.Summary(walls=[])) is None
    walls = [1.0] * 19 + [11.0]
    assert read(tracing.Summary(walls=walls)) == stats.track_s_p95(walls)
