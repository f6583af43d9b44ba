"""The input generator is deterministic by seed, its sizes do not depend
on the seed, and what it writes the port reads back bit for bit."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import inputs
from benchmark.reference import decimate


def program(seed):
    return inputs.make_program(seed, 2822400, 2, [0.1, 0.25], 0.02)


def test_same_seed_same_inputs_other_seed_other_content():
    a, b, c = program(2**31 + 11), program(2**31 + 11), program(5)
    for s, t in zip(a.segments, b.segments):
        assert np.array_equal(s, t)
    assert a.tracks == b.tracks
    assert [x.shape for x in a.segments] == [x.shape for x in c.segments]
    assert [a.track_bytes(i) for i in range(2)] == \
        [c.track_bytes(i) for i in range(2)] == [35280, 88200]
    assert not np.array_equal(a.segments[0], c.segments[0])


def test_a_checkout_without_the_build_builds_it_once(tmp_path, monkeypatch):
    # the segments' four threads all ask for the modulator first
    monkeypatch.setattr(inputs, "BUILD", tmp_path / "_build")
    monkeypatch.setattr(inputs, "_lib", None)
    a = inputs.make_program(3, 2822400, 2, [0.05], 0.01)
    assert [p.name for p in (tmp_path / "_build").iterdir()] == [
        inputs._build().name]
    assert np.array_equal(a.planes(0), program_at(3).planes(0))


def program_at(seed):
    return inputs.make_program(seed, 2822400, 2, [0.05], 0.01)


def test_program_peaks_at_or_below_minus_6_dbfs():
    p = program(3)
    chain = decimate.load_chain("E_1_352800_2f5459aa57.npz")
    planes = torch.from_numpy(p.planes(1))
    y = decimate.output_block(chain, planes, 500, chain.frames(
        planes.shape[1] * 8))
    assert float(y.abs().max()) < 0.56


def read_all(src) -> np.ndarray:
    parts = []
    while (x := src.read(4096)) is not None:
        parts.append(x)
    return np.concatenate(parts, axis=1)


def test_dsf_and_raw_read_back_by_the_port(tmp_path):
    from dsd2dxd_tpu_torch.formats.dsd_types import DsdRate, Endianness, FmtType
    from dsd2dxd_tpu_torch.formats.dsf import open_dsf
    from dsd2dxd_tpu_torch.formats.source import open_raw_file

    p = program(9)
    p.write_dsf(1, tmp_path / "t.dsf")
    src, meta = open_dsf(tmp_path / "t.dsf")
    got = read_all(src)
    assert meta.sample_count == p.track_bytes(1) * 8
    assert np.array_equal(got, p.planes(1))
    offsets = p.write_raw_pool(tmp_path / "pool")
    pool = (tmp_path / "pool").read_bytes()
    raw = b"".join(pool[offsets[s]:offsets[s] + 2 * n] for s, n in p.tracks[1])
    (tmp_path / "t.dsd").write_bytes(raw)
    src = open_raw_file(tmp_path / "t.dsd", 2, DsdRate.DSD64,
                        FmtType.INTERLEAVED, Endianness.MSB_FIRST, 4096)
    got = read_all(src)
    assert np.array_equal(got, p.planes(1))
