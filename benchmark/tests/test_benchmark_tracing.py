"""The trace reading and the per-layer readers on a synthetic trace."""

from __future__ import annotations

import json

import pytest

from benchmark import harness, tracing, work


def trace(tmp_path, events):
    (tmp_path / "s_1.1.pt.trace.json").write_text(
        json.dumps({"traceEvents": events}))
    return tracing.summarise(tmp_path)


def x(name, ts, dur, tid=1, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid}


def test_streams_at_once_share_the_card(tmp_path):
    s = trace(tmp_path, [
        x("dsd2dxd.stream", 0, 100), x("dsd2dxd.stream", 50, 100, tid=2),
        x("dsd2dxd.read", 0, 40), x("k(int)", 40, 20, tid=9, cat="kernel"),
        x("Memcpy HtoD (Pinned -> Device)", 200, 5, tid=9,
          cat="gpu_memcpy")])
    assert s.stream_us == 150 and s.busy_us == 20
    assert s.idle_by_span == {"dsd2dxd.read": 40, "dsd2dxd.stream": 90}
    assert s.device_us == {"k": 20, "Memcpy HtoD (Pinned -> Device)": 5}
    assert harness.reader("device_idle_pct")(s) == pytest.approx(
        100 * (1 - 20 / 150))
    assert s.breakdown()["idle_gaps"][0] == ["dsd2dxd.stream", 90e-6]


def test_per_audio_second_readers_and_the_roofline(tmp_path):
    s = trace(tmp_path, [
        x("dsd2dxd.stream", 0, 1e6), x("dsd2dxd.read", 0, 5e5),
        x("dsd2dxd.stage.fill", 5e5, 1e3), x("dsd2dxd.stage.enqueue", 6e5, 1e3),
        x("dsd2dxd.drain.write", 0, 2e5, tid=2),
        x("fused_decim_kernel(DecimParams)", 1e5, 1e4, tid=9, cat="kernel")])
    assert harness.reader("read_ms_per_audio_s")(s) is None  # no audio
    s.audio_s = 100.0
    s.work = (1.0, 67e12 * 1e-4, 0.0)  # 0.1 ms of f32 per audio-s
    assert harness.reader("read_ms_per_audio_s")(s) == pytest.approx(5.0)
    assert harness.reader("stage_ms_per_audio_s")(s) == pytest.approx(0.02)
    assert harness.reader("write_ms_per_audio_s")(s) == pytest.approx(2.0)
    # 10 ms of bound over 10 ms of kernels
    assert harness.reader("kernel_roofline_pct")(s) == pytest.approx(100.0)
    assert work.bound_s(s.work)[1] == "f32"
