"""The port's host tools (dsd2dxd_tpu_torch/tools: compare_reference,
flacbench, njadbench, hostbudget) on the CPU, against the JAX package's
tools (tools/*.py at the repository root) on the same inputs.

Tolerances: compare_pair's dict equal to the JAX tool's on the same pair;
the FLAC payload and the NJAD samples byte-equal across the two packages'
native libraries; the port's and the JAX Converter's output of one .dsf
`dither-equiv` at 24-bit TPDF (RMS <= 0.8 LSB) and within 5 LSB at NJAD
(`-d N`). hostbudget's timings are not asserted: they depend on the host.
"""

import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from dsd2dxd_tpu.formats import dsd_types as jtypes
from dsd2dxd_tpu.native import lib as jnative
from dsd2dxd_tpu.pipeline import engine as jengine
import dsd2dxd_tpu_torch.pipeline.engine as tengine
from dsd2dxd_tpu_torch import Converter as TConverter
from dsd2dxd_tpu_torch.containers.aiff import AiffWriter
from dsd2dxd_tpu_torch.containers.flac import FlacWriter
from dsd2dxd_tpu_torch.containers.wav import WavWriter
from dsd2dxd_tpu_torch.filters.design import get_chain
from dsd2dxd_tpu_torch.formats.dsd_types import (
    DitherType,
    FilterType,
    OutputType,
)
from dsd2dxd_tpu_torch.native.loader import load
from dsd2dxd_tpu_torch.tools import compare_reference as cr
from dsd2dxd_tpu_torch.tools import flacbench, hostbudget, njadbench
from dsd2dxd_tpu_torch.utils.errors import ConfigError

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import compare_reference as jcr  # noqa: E402
import flacbench as jflacbench  # noqa: E402
import hostbudget as jhostbudget  # noqa: E402

SMALL_TILE = 64 * 1024  # the port's tile target per channel at DSD64


def _convert(cls, src: Path, out_dir: Path, **kw) -> Path:
    """One file through `cls`: the port's Converter on the CPU, or the JAX
    Converter (its enums from the JAX package)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    args = dict(bit_depth=24, output=OutputType.WAV, level_db=0.0,
                output_rate=352800, out_dir=out_dir, dither=DitherType.TPDF,
                filt=FilterType.EQUIRIPPLE, append_rate=False,
                base_dir=src.parent, input_path=src)
    args.update(kw)
    if cls is jengine.Converter:
        args = {k: getattr(jtypes, type(v).__name__)[v.name]
                if isinstance(v, (DitherType, FilterType, OutputType)) else v
                for k, v in args.items()}
    else:
        args["device"] = "cpu"
    conv = cls.from_container(**args)
    conv.do_conversion()
    return conv.output_path()


@pytest.fixture(scope="module")
def two_takes(tmp_path_factory, tone_dsd64_stereo_dsf):
    """The port's output of one file under two dither seeds."""
    outs = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tengine, "_DEFAULT_TILE_TARGET", SMALL_TILE)
        for seed in ("", "take2"):
            mp.setenv("DSD2DXD_SEED", seed)
            outs.append(_convert(
                TConverter, tone_dsd64_stereo_dsf,
                tmp_path_factory.mktemp(f"take_{seed or 'a'}")))
    return outs


# -- compare_reference: the JAX tool's four cases on the port ---------------

def test_self_diff_bitexact(two_takes):
    r = cr.compare_pair(two_takes[0], two_takes[0], raw=None, channels=2,
                        bits_override=None, max_shift=16)
    assert r["verdict"] == "bitexact"
    assert r["offset"] == 0 and r["max_lsb"] == 0.0


def test_seed_diff_is_dither_equivalent(two_takes):
    """Two seeds: two independent TPDF realizations, each an error of
    variance 2/12 (dither) + 1/12 (rounding) LSB^2, so the difference has
    an RMS near sqrt(0.5) = 0.71 LSB, inside the 0.8 LSB gate."""
    r = cr.compare_pair(two_takes[0], two_takes[1], raw=None, channels=2,
                        bits_override=None, max_shift=16)
    assert r["verdict"] == "dither-equiv" and r["offset"] == 0
    assert 0.3 < r["rms_lsb"] <= 0.8


def _write_wav(path: Path, x: np.ndarray, bits: int = 24,
               rate: int = 352800) -> Path:
    with open(path, "wb") as f:
        w = WavWriter(f, x.shape[1], rate, bits)
        w.write(x)
        w.finalize()
    return path


def test_alignment_recovers_known_shift(tmp_path):
    """`ref` starts 63 frames into the stream, so `ours` leads and must
    align at offset +63 and come out bitexact."""
    rng = np.random.default_rng(3)
    x = (rng.normal(0, 0.2, size=(30000, 2)) * (1 << 23)).astype(np.int32)
    a = _write_wav(tmp_path / "a.wav", x[63:])
    b = _write_wav(tmp_path / "b.wav", x)
    r = cr.compare_pair(a, b, raw=None, channels=2, bits_override=None,
                        max_shift=128)
    assert r["offset"] == 63
    assert r["verdict"] == "bitexact"


def _s24le(v: np.ndarray) -> bytes:
    u = (v.astype(np.int64) & 0xFFFFFF).astype(np.uint32)
    return np.stack([u & 0xFF, (u >> 8) & 0xFF, (u >> 16) & 0xFF],
                    axis=-1).astype(np.uint8).tobytes()


@pytest.mark.parametrize("fmt", ["s24le", "f32le", "aifc"])
def test_raw_and_float_paths(tmp_path, fmt):
    """A raw s24le, a raw f32le and an AIFC f32 file against themselves:
    bitexact; the AIFC floats against the 24-bit WAV of the integers they
    round to, in the int side's LSB units: within half an LSB."""
    x = np.sin(2 * np.pi * np.arange(20000) / 50.0) * 0.4
    xi = np.round(x * (1 << 23)).astype(np.int64)
    path = tmp_path / f"a.{fmt}"
    if fmt == "s24le":
        path.write_bytes(_s24le(xi))
        kw = dict(raw="s24le", channels=1)
    elif fmt == "f32le":
        path.write_bytes(x.astype("<f4").tobytes())
        kw = dict(raw="f32le", channels=1)
    else:
        with open(path, "wb") as f:
            w = AiffWriter(f, 1, 352800, 32, aifc=True)
            w.write(x.astype(np.float32)[:, None])
            w.finalize()
        kw = dict(raw=None, channels=1)
    r = cr.compare_pair(path, path, bits_override=None, max_shift=4, **kw)
    assert r["verdict"] == "bitexact" and r["offset"] == 0
    if fmt == "aifc":
        ints = _write_wav(tmp_path / "i.wav", xi.astype(np.int32)[:, None])
        r = cr.compare_pair(ints, path, bits_override=None, max_shift=4,
                            **kw)
        assert r["bits"] == 24 and r["offset"] == 0
        assert r["verdict"] == "dither-equiv" and r["max_lsb"] <= 0.5


# -- compare_reference against the JAX original --------------------------------

def _pair_files(tmp_path: Path, kind: str):
    """Two files of one container made from a seed: `b` is `a` with a few
    LSB of noise and 5 frames of lead. -> (a, b, raw, channels)."""
    rng = np.random.default_rng(11)
    n = 24000
    t = np.arange(n + 5)
    x = 0.4 * np.sin(2 * np.pi * t / 97.0)[:, None] * np.ones((1, 2))
    x[:, 1] *= 0.7
    noise = rng.integers(-2, 3, size=x.shape)
    paths = []
    for name, lead in (("a", 5), ("b", 0)):
        y = x[lead:lead + n]
        bits = {"flac20": 20, "aiff16": 16}.get(kind, 24)
        yi = np.round(y * (1 << (bits - 1))).astype(np.int64)
        if name == "b":
            yi = yi + noise[:n]
        yi = yi.astype(np.int32)
        yf = (y + noise[:n] * 2.0 ** -23).astype(np.float32)
        p = tmp_path / f"{name}.{kind}"
        if kind in ("wav24", "flac20", "aiff16", "aifc_f32"):
            with open(p, "wb") as f:
                if kind == "wav24":
                    w = WavWriter(f, 2, 352800, 24)
                elif kind == "flac20":
                    w = FlacWriter(f, 2, 88200, 20)
                elif kind == "aiff16":
                    w = AiffWriter(f, 2, 44100, 16)
                else:
                    w = AiffWriter(f, 2, 192000, 32, aifc=True)
                w.write(yf if kind == "aifc_f32" else yi)
                w.finalize()
        elif kind == "raw_s24le":
            p.write_bytes(_s24le(yi.reshape(-1)))
        else:
            p.write_bytes(yf.astype("<f4").tobytes())
        paths.append(p)
    raw = {"raw_s24le": "s24le", "raw_f32le": "f32le"}.get(kind)
    return paths[0], paths[1], raw, 2


@pytest.mark.parametrize("kind", ["wav24", "aiff16", "aifc_f32", "flac20",
                                  "raw_s24le", "raw_f32le"])
@pytest.mark.parametrize("bits", [None, 24])
def test_compare_pair_equals_the_jax_tool(tmp_path, kind, bits):
    a, b, raw, ch = _pair_files(tmp_path, kind)
    for ref, ours in ((a, b), (a, a)):
        got = cr.compare_pair(ref, ours, raw, ch, bits, 16)
        want = jcr.compare_pair(ref, ours, raw, ch, bits, 16)
        assert got == want
    assert got["verdict"] == "bitexact"
    assert cr.compare_pair(a, b, raw, ch, bits, 16)["offset"] == 5


def test_compare_main_exit_code_and_float_vs_int(tmp_path, capsys):
    """main: 0 for a bitexact pair, 1 once a pair DIFFERS, as the JAX
    tool; a float file against a 24-bit one in the int side's units."""
    a = _pair_files(tmp_path, "wav24")[0]
    assert cr.main([str(a), str(a), "--max-shift", "8"]) == \
        jcr.main([str(a), str(a), "--max-shift", "8"]) == 0
    x = np.random.default_rng(2).normal(0, 0.1, (20000, 2))
    ints = _write_wav(tmp_path / "i.wav",
                      np.round(x * (1 << 23)).astype(np.int32))
    f = tmp_path / "f.aifc"
    with open(f, "wb") as fh:
        w = AiffWriter(fh, 2, 352800, 32, aifc=True)
        w.write(x.astype(np.float32))
        w.finalize()
    got = cr.compare_pair(ints, f, None, 2, None, 16)
    assert got == jcr.compare_pair(ints, f, None, 2, None, 16)
    assert got["bits"] == 24 and got["offset"] == 0
    assert got["verdict"] == "dither-equiv" and got["max_lsb"] <= 0.5
    louder = tmp_path / "louder.wav"
    x = np.random.default_rng(1).integers(-1 << 20, 1 << 20, (20000, 2),
                                          dtype=np.int32)
    _write_wav(louder, x)
    assert cr.main([str(a), str(louder), "--max-shift", "8"]) == 1
    assert "DIFFERS" in capsys.readouterr().out


def test_compare_refuses_a_foreign_file(tmp_path):
    p = tmp_path / "x.wav"
    p.write_bytes(b"RIFX" + bytes(40))
    with pytest.raises(ValueError):
        cr.load(p, None, 2)


# -- the port held against the JAX package ---------------------------------

@pytest.mark.parametrize("dither,limit", [(DitherType.TPDF, None),
                                          (DitherType.NJAD, 5)])
def test_port_output_against_jax_converter(tone_dsd64_stereo_dsf, tmp_path,
                                           monkeypatch, dither, limit):
    """The JAX Converter's and the port's 24-bit output of one .dsf: at
    TPDF two different noise streams, `dither-equiv`; at NJAD (`-d N`)
    within 5 LSB (the kernels' undithered parity bound)."""
    monkeypatch.setattr(tengine, "_DEFAULT_TILE_TARGET", SMALL_TILE)
    src = tone_dsd64_stereo_dsf
    ours = _convert(TConverter, src, tmp_path / "port", dither=dither)
    ref = _convert(jengine.Converter, src, tmp_path / "jax", dither=dither)
    r = cr.compare_pair(ref, ours, None, 2, None, 16)
    assert r["offset"] == 0 and r["frames"] == 176400
    if limit is None:
        assert r["verdict"] == "dither-equiv" and 0.3 < r["rms_lsb"] <= 0.8
    else:
        assert r["verdict"] in ("bitexact", "dither-equiv")
        assert r["max_lsb"] <= limit


# -- flacbench ---------------------------------------------------------------

@pytest.mark.parametrize("kind", flacbench.KINDS)
def test_flacbench_material_equals_jax(kind):
    a = flacbench.material(kind, 5000, 352800, np.random.default_rng(0))
    b = jflacbench.material(kind, 5000, 352800, np.random.default_rng(0))
    assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)


@pytest.mark.parametrize("rate,bps", [(352800, 24), (88200, 20)])
def test_flacbench_encode_equals_jax(rate, bps):
    """The same payload bytes from the port's g++ build of flac.cc and the
    JAX package's native library, on 0.25 s of music."""
    assert jnative is not None
    x = flacbench.material("music", rate // 4, rate,
                           np.random.default_rng(0)) >> (24 - bps)
    got = flacbench.encode(load(), x, rate, bps)
    assert len(got) > 0
    assert got == jflacbench.encode(jnative, x, rate, bps)


def test_flacbench_main_runs(capsys):
    assert flacbench.main(["--seconds", "0.05", "--reps", "1"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0].strip() for ln in lines] == list(flacbench.KINDS)


# -- njadbench ---------------------------------------------------------------

@pytest.mark.parametrize("variant", njadbench.VARIANTS)
def test_njadbench_equals_jax_native(variant, monkeypatch):
    x = njadbench.material(0.1)
    _dt, got = njadbench.run(load(), x, variant)
    if variant == "ladder":
        monkeypatch.setenv("DSDKIT_NJAD_DIGIT", "ladder")
    else:
        monkeypatch.delenv("DSDKIT_NJAD_DIGIT", raising=False)
    st = jnative.njad_new(2)
    try:
        want = jnative.njad_quantize(st, x, njadbench.BITS)
    finally:
        jnative.njad_free(st)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    f = np.floor(x.astype(np.float64) * 2.0 ** (njadbench.BITS - 1))
    assert ((got == f) | (got == f + 1)).all()


def test_njadbench_gate_raises_before_any_time(monkeypatch, capsys):
    real = njadbench.run

    def forged(native, x, variant):
        dt, out = real(native, x, variant)
        if variant == "ladder":
            out = out.copy()
            out[3, 1] += 1
        return dt, out

    monkeypatch.setattr(njadbench, "run", forged)
    with pytest.raises(RuntimeError, match="disagree on 1 of"):
        njadbench.main(["--seconds", "0.05", "--pairs", "1"])
    assert capsys.readouterr().out == ""


def test_njadbench_main_runs(capsys):
    assert njadbench.main(["--seconds", "0.05", "--pairs", "1"]) == 0
    out = capsys.readouterr().out
    assert "div" in out and "ladder speedup" in out
    assert "DSDKIT_NJAD_DIGIT" not in os.environ


# -- hostbudget --------------------------------------------------------------

def test_hostbudget_music_equals_jax():
    for n, rate, bits in ((3000, 88200, 20), (5000, 352800, 24)):
        a = hostbudget._music(n, rate, bits, np.random.default_rng(0))
        b = jhostbudget._music(n, rate, bits, np.random.default_rng(0))
        assert a.dtype == np.int32 and np.array_equal(a, b)


@pytest.fixture
def small_tile(monkeypatch):
    """The engine's tile target at 16 KiB per channel at DSD64."""
    monkeypatch.setattr(tengine, "_DEFAULT_TILE_TARGET", 16 * 1024)


@pytest.fixture(scope="module")
def budget_cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tengine, "_DEFAULT_TILE_TARGET", 16 * 1024)
        return hostbudget.budget(0.05, 1, torch.device("cpu"))


def test_hostbudget_stage_set(budget_cpu):
    out = budget_cpu
    assert tuple(out["stages"]) == hostbudget.SHARED_STAGES == (
        "njad", "flac88", "flac352", "frames24")
    assert out["on_card"] == ["pack24"]
    assert set(out["configs"]) == {"config 1", "config 2", "config 3",
                                   "config 4", "config 5"}
    tile_stages = {s for c in out["configs"].values()
                   for s in c.get("stages", ())}
    # stage_pinned needs CUDA: left out on the CPU
    assert tile_stages == {"read_planar", "read_interleaved", "bitrev",
                           "write"}
    assert set(out["configs"]["config 2"]["stages"]) == {"read_interleaved",
                                                         "write"}
    for name in ("config 1", "config 4"):
        assert set(out["configs"][name]["stages"]) == {"read_planar",
                                                       "bitrev", "write"}
    assert {n: set(r) for n, r in out["stages"].items()} == {
        "njad": {"xrt", "t1_over_t2"}, "flac88": {"xrt", "t1_over_t2"},
        "flac352": {"xrt", "t1_over_t2"}, "frames24": {"xrt"}}
    assert out["device"] == "cpu" and out["card"] is None


def test_hostbudget_tiles_are_the_engines(budget_cpu):
    """Each config's tile is `_tile_bytes_for` of its chain at the
    engine's tile target scaled by the input rate, its audio seconds bits
    over rate."""
    for name, cfg in hostbudget.TILE_CONFIGS.items():
        c = budget_cpu["configs"][name]
        chain = get_chain(FilterType.EQUIRIPPLE, cfg.rate, cfg.out_hz)
        tile = tengine._tile_bytes_for(chain, 16 * 1024 * int(cfg.rate))
        assert c["tile_bytes"] == tile >= 16 * 1024 * int(cfg.rate)
        assert c["audio_s"] == tile * 8 / cfg.rate.hz
        frames = round(c["audio_s"] * cfg.out_hz)
        assert c["wire_bytes"] == frames * 2 * (4 if cfg.bit_depth == 32
                                                 else 3)


@pytest.mark.parametrize("config", sorted(hostbudget.TILE_CONFIGS))
def test_hostbudget_every_runner_runs_on_cpu(config, tmp_path, small_tile):
    cfg = hostbudget.TILE_CONFIGS[config]
    rng = np.random.default_rng(0)
    runners = dict(hostbudget.stage_runners(0.05, rng))
    runners.update(hostbudget.tile_runners(cfg, tmp_path,
                                           torch.device("cpu"), rng))
    assert set(runners) == (set(hostbudget.SHARED_STAGES) | set(cfg.reader)
                            | {"write"}) - {"stage_pinned"}
    for name, run in runners.items():
        dt = run()
        assert isinstance(dt, float) and dt > 0, name
    written = (tmp_path / f"out.{cfg.container}").read_bytes()
    assert len(written) >= hostbudget.tile_shape(cfg)[2]


def test_hostbudget_ceiling_arithmetic(budget_cpu):
    assert hostbudget.ceiling([1000.0]) == 1000.0
    assert hostbudget.ceiling([100.0, 100.0]) == 50.0
    assert abs(hostbudget.ceiling([200.0, 300.0, 600.0]) - 100.0) < 1e-12
    for name, cfg in hostbudget.TILE_CONFIGS.items():
        c = budget_cpu["configs"][name]
        want = 1 / sum(1 / c["stages"][s] for s in cfg.reader
                       if s in c["stages"])
        assert abs(c["reader"] - want) <= 1e-9 * want
        w = c["stages"]["write"]  # 1 / (1 / w): w up to rounding
        assert abs(c["drain"] - w) <= 1e-12 * w
    st = budget_cpu["stages"]
    c3 = budget_cpu["configs"]["config 3"]["drain"]
    assert abs(c3 - 1 / (1 / st["njad"]["xrt"] + 1 / st["flac88"]["xrt"])) \
        <= 1e-9 * c3


def test_hostbudget_writes_nothing_by_default(tmp_path, monkeypatch, capsys,
                                              small_tile):
    """No --json: nothing in the working directory, the repository's
    HOSTBUDGET.* untouched, no work directory left behind."""
    before = {p.name: p.read_bytes() for p in ROOT.glob("HOSTBUDGET.*")}
    tmp_before = set(Path(tempfile.gettempdir()).glob("hostbudget_*"))
    monkeypatch.chdir(tmp_path)
    argv = ["--device", "cpu", "--seconds", "0.05", "--pairs", "1"]
    assert hostbudget.main(argv) == 0
    out = capsys.readouterr().out
    assert "stage_pinned     left out: pinned memory needs CUDA" in out
    assert "pack24" in out and "reader thread ceiling" in out
    assert list(tmp_path.iterdir()) == []
    assert {p.name: p.read_bytes() for p in ROOT.glob("HOSTBUDGET.*")} == before
    assert set(Path(tempfile.gettempdir()).glob("hostbudget_*")) == tmp_before
    table = tmp_path / "t.json"
    assert hostbudget.main(argv + ["--json", str(table)]) == 0
    assert list(tmp_path.iterdir()) == [table]
    out = json.loads(table.read_text())
    assert out["cores"] == os.cpu_count() and out["page_cache"] == "warm"


def test_hostbudget_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigError, match="no CUDA device"):
        hostbudget.main(["--seconds", "0.05", "--pairs", "1"])
