"""The port's float-output consumers on the CPU -- the level check and
`dsd_levels`, NJAD dither, FLAC output (dsd2dxd_tpu_torch/pipeline/engine.py,
cli/dsd_levels.py, native/, containers/flac.py) -- against the JAX package
on inputs made from a seed.

Tolerances: the peak within 1e-4 relative of the JAX `check_level`, and
equal to max |x| of the port's own f32 output; the native NJAD bit-equal
to the JAX library; NJAD end to end equal to the port's native NJAD of its
own f32 output, and within 2e-6 x 2^(b-1) + 1 LSB of the JAX Converter
(each sample is the floor or the ceiling of x 2^(b-1), and the two
packages' floats differ by at most 2e-6); FLAC decoding to the port's own
WAV samples exactly, and at NONE within 5 LSB of the JAX Converter's FLAC."""

import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from dsd2dxd_tpu.cli import dsd_levels as jlevels
from dsd2dxd_tpu.formats import dsd_types as jtypes
from dsd2dxd_tpu.formats.dsf import write_dsf as jwrite_dsf
from dsd2dxd_tpu.formats.flac_decode import decode_flac
from dsd2dxd_tpu.formats.id3 import Id3Frame, Id3Tag
from dsd2dxd_tpu.native import lib as jnative
from dsd2dxd_tpu.ops.dsm import synth_tone_dsd
from dsd2dxd_tpu.pipeline import engine as jengine
import dsd2dxd_tpu_torch.pipeline.engine as tengine
from dsd2dxd_tpu_torch import Converter as TConverter
from dsd2dxd_tpu_torch.cli import dsd_levels as tlevels
from dsd2dxd_tpu_torch.cli.dsd2dxd import run as trun
from dsd2dxd_tpu_torch.formats.dsd_types import (
    DitherType,
    DsdRate,
    Endianness,
    FilterType,
    FmtType,
    OutputType,
)
from dsd2dxd_tpu_torch.native import loader
from dsd2dxd_tpu_torch.utils.errors import ConfigError

ROOT = Path(__file__).resolve().parent.parent
HEAD_SKIP = 128  # frames at 352.8k: zero-primed JAX path vs idle-primed port
FLOAT_TOL = 2e-6


def _skip(rate: int) -> int:
    return HEAD_SKIP * rate // 352800


@pytest.fixture
def small_tiles(monkeypatch):
    """Several tiles per fixture and a partial final one: 16 KiB/ch at
    the 44.1k rates, 16 KiB/ch of whole band blocks at the 48k rates."""
    from dsd2dxd_tpu_torch.ops import rational

    monkeypatch.setattr(tengine, "_DEFAULT_TILE_TARGET", 16 * 1024)
    tile_bytes_for = tengine._tile_bytes_for

    def tile_bytes(chain, target):
        if rational.rational_head_len(chain) is None:
            return tile_bytes_for(chain, target)
        unit = rational.rational_plan(chain).unit_bits
        return -(-16 * 1024 * 8 // unit) * unit // 8

    monkeypatch.setattr(tengine, "_tile_bytes_for", tile_bytes)


@pytest.fixture(scope="module")
def tone_dsd128_dsf(tmp_path_factory) -> Path:
    """1 kHz stereo DSD128, 0.3 s (BASELINE config 3's input rate)."""
    path = tmp_path_factory.mktemp("dsd128") / "tone128.dsf"
    planes = synth_tone_dsd(1000.0, 0.3, 5_644_800, amplitude=0.5,
                            channels=2)
    jwrite_dsf(path, planes, 5_644_800, lsb_first=True)
    return path


def _tag_with_apic() -> bytes:
    img = b"\xff\xd8\xff\xe0" + bytes(range(256)) * 3  # a small "JPEG"
    apic = b"\x00image/jpeg\x00\x03cover\x00" + img
    return Id3Tag(frames=[Id3Frame.text_frame("TIT2", "Tone"),
                          Id3Frame.text_frame("TPE1", "Artist"),
                          Id3Frame.text_frame("TALB", "Album"),
                          Id3Frame("APIC", apic)]).to_bytes()


def _convert(cls, src: Path, out_dir: Path, **kw):
    """One file through `cls` (the port's Converter on the CPU when given
    device=...; the JAX Converter with jtypes enums otherwise)."""
    out_dir.mkdir(exist_ok=True)
    args = dict(bit_depth=24, output=OutputType.WAV, level_db=0.0,
                output_rate=352800, out_dir=out_dir, dither=DitherType.NONE,
                filt=FilterType.EQUIRIPPLE, append_rate=False,
                base_dir=src.parent, input_path=src)
    args.update(kw)
    if cls is jengine.Converter:
        args = {k: getattr(jtypes, type(v).__name__)[v.name]
                if isinstance(v, (DitherType, FilterType, OutputType)) else v
                for k, v in args.items()}
    conv = cls.from_container(**args)
    conv.do_conversion()
    return conv.output_path()


def _port(src, out_dir, **kw):
    return _convert(TConverter, src, out_dir, device="cpu", **kw)


def _wav_samples(path: Path, bits: int) -> np.ndarray:
    """(frames, 2) samples of a WAV: int64 at 16/20/24 bit (20: the value,
    shifted back down), f32 at 32."""
    data = path.read_bytes()
    off = data.index(b"data") + 8
    raw = data[off:]
    if bits == 32:
        return np.frombuffer(raw, dtype="<f4").reshape(-1, 2)
    if bits == 16:
        return np.frombuffer(raw, dtype="<i2").astype(np.int64).reshape(-1, 2)
    b = np.frombuffer(raw[:len(raw) // 3 * 3], dtype=np.uint8).reshape(
        -1, 3).astype(np.int64)
    v = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
    v = np.where(v >= 1 << 23, v - (1 << 24), v)
    return (v >> 4 if bits == 20 else v).reshape(-1, 2)


def _jax_level(src: Path, rate: int) -> float:
    return jengine.Converter.new_level_check(
        rate, src, jtypes.FmtType.PLANAR, jtypes.Endianness.MSB_FIRST, 2,
        4096, jtypes.DsdRate.DSD64).check_level()


def _port_level(src: Path, rate: int) -> float:
    return TConverter.new_level_check(
        rate, src, FmtType.PLANAR, Endianness.MSB_FIRST, 2, 4096,
        DsdRate.DSD64, device="cpu").check_level()


# -- the level check --------------------------------------------------------

@pytest.mark.parametrize("rate", [352800, 96000])
def test_level_check_matches_jax_and_float_output(tone_dsd64_stereo_dsf,
                                                  tmp_path, small_tiles,
                                                  rate):
    """The port's check_level against the JAX check_level on a 44.1k
    chain (K1 at f32 NONE) and a 48k chain (K1e -> K2t), with small tiles
    and a partial final one: the peak within 1e-4 relative, and equal to
    max |x| of the port's own `-b 32 -d X` output of the file, whose
    largest sample lies past the zero-primed head of the JAX CPU path."""
    src = tone_dsd64_stereo_dsf
    conv = TConverter.new_level_check(
        rate, src, FmtType.PLANAR, Endianness.MSB_FIRST, 2, 4096,
        DsdRate.DSD64, device="cpu")
    t_db = conv.check_level()
    assert conv.stats["tiles"] > 2 and conv.output_path() is None
    assert conv.source.info.data_bytes_per_channel % conv.stats["tile_bytes"]
    j_db = _jax_level(src, rate)
    assert abs(10 ** (t_db / 20) / 10 ** (j_db / 20) - 1) <= 1e-4
    x = _wav_samples(_port(src, tmp_path, bit_depth=32, output_rate=rate), 32)
    assert x.shape == (rate // 2, 2)
    peak = TConverter.new_level_check(
        rate, src, FmtType.PLANAR, Endianness.MSB_FIRST, 2, 4096,
        DsdRate.DSD64, device="cpu")._run(None, None, None, False)
    assert peak == float(np.abs(x).max()) and t_db == 20 * np.log10(peak)
    assert int(np.abs(x).max(axis=1).argmax()) > _skip(rate)


def _second_tone(tmp_path: Path) -> Path:
    src = tmp_path / "quiet.dsf"
    planes = synth_tone_dsd(1000.0, 0.2, 2_822_400, amplitude=0.25,
                            channels=2)
    jwrite_dsf(src, planes, 2_822_400, lsb_first=True)
    return src


def test_dsd_levels_cli_matches_jax(tone_dsd64_stereo_dsf, tmp_path,
                                    small_tiles, capsys):
    """`dsd_levels` on two files: the same per-file and "Highest peak
    level" lines as the JAX CLI, exit code 0."""
    files = [str(tone_dsd64_stereo_dsf), str(_second_tone(tmp_path))]
    lines = []
    for run in (lambda a: tlevels.run(a, device="cpu"), jlevels.run):
        capsys.readouterr()
        assert run(["-q", "-r", "96000", *files]) == 0
        lines.append(sorted(ln for ln in capsys.readouterr().err.splitlines()
                            if "peak level" in ln))
    assert lines[0] == lines[1]
    assert len(lines[0]) == 3 and lines[0][0].startswith("Highest peak level")


def test_dsd_levels_cli_exit_codes(tmp_path, capsys):
    """No input: the usage error, 2; a missing input: 1 -- as the JAX CLI."""
    for run in (lambda a: tlevels.run(a, device="cpu"), jlevels.run):
        with pytest.raises(SystemExit) as e:
            run(["-q"])
        assert e.value.code == 2
        assert run(["-q", str(tmp_path / "missing.dsf")]) == 1


# -- NJAD --------------------------------------------------------------------

@pytest.mark.parametrize("threads", ["1", "4"])
@pytest.mark.parametrize("bits", [16, 20, 24])
@pytest.mark.parametrize("channels", [1, 2, 6])
def test_native_njad_bit_equal_to_jax(monkeypatch, channels, bits, threads):
    """The port's library (its own g++ build of the copied njad.cc) on the
    same random f32 frames as the JAX library, three calls on one state:
    bit-equal, each sample the floor or the ceiling of x 2^(b-1)."""
    monkeypatch.setenv("DSDKIT_NJAD_THREADS", threads)
    rng = np.random.default_rng(channels * 100 + bits)
    x = np.concatenate([
        1e-4 * rng.standard_normal((3000, channels)),
        0.9 * np.sin(np.arange(9000)[:, None] / (7.3 + np.arange(channels))),
        rng.uniform(-1, 1, (6000, channels)),
    ]).astype(np.float32)
    tnative = loader.load()
    ts, js = tnative.njad_new(channels), jnative.njad_new(channels)
    try:
        for part in np.split(x, [5000, 11000]):
            t = tnative.njad_quantize(ts, part, bits)
            np.testing.assert_array_equal(t, jnative.njad_quantize(js, part,
                                                                   bits))
            f = np.floor(part.astype(np.float64) * 2.0 ** (bits - 1))
            lim = 1 << (bits - 1)
            assert np.all((t == np.clip(f, -lim, lim - 1))
                          | (t == np.clip(f + 1, -lim, lim - 1)))
    finally:
        tnative.njad_free(ts)
        jnative.njad_free(js)


def test_native_njad_rejects_bad_channels():
    tnative = loader.load()
    for n in (0, 17):
        with pytest.raises(ConfigError):
            tnative.njad_new(n)
    st = tnative.njad_new(2)
    try:
        with pytest.raises(ConfigError):
            tnative.njad_quantize(st, np.zeros((8, 3), np.float32), 24)
    finally:
        tnative.njad_free(st)


def test_njad_end_to_end(tone_dsd128_dsf, tmp_path, small_tiles,
                         capsysbinary):
    """DSD128 -> 20-bit 88.2k WAV with NJAD: equal to the port's native
    NJAD of its own `-b 32 -d X` output of the file; within the float
    tolerance x 2^19 + 1 LSB of the JAX Converter past its head; and the
    same samples through stdout (`-o s`)."""
    src = tone_dsd128_dsf
    kw = dict(bit_depth=20, output_rate=88200, dither=DitherType.NJAD)
    t = _wav_samples(_port(src, tmp_path / "t", **kw), 20)
    f = _wav_samples(_port(src, tmp_path / "f", bit_depth=32,
                           output_rate=88200), 32)
    tnative = loader.load()
    st = tnative.njad_new(2)
    ref = tnative.njad_quantize(st, f, 20)
    tnative.njad_free(st)
    np.testing.assert_array_equal(t, ref)
    assert t.shape == (int(0.3 * 88200), 2) and np.abs(t).max() > 1 << 17
    j = _wav_samples(_convert(jengine.Converter, src, tmp_path / "j", **kw),
                     20)
    s = _skip(88200)
    assert np.abs(t[s:] - j[s:]).max() <= FLOAT_TOL * 2 ** 19 + 1
    capsysbinary.readouterr()
    assert trun(["-b", "20", "-d", "N", "-r", "88200", "-o", "s", "-q",
                 str(src)], device="cpu") == 0
    raw = capsysbinary.readouterr().out
    wav = (tmp_path / "t" / "tone128.wav").read_bytes()
    assert raw == wav[44:]


def test_failed_sink_finalizes_the_header(tone_dsd128_dsf, tmp_path,
                                          small_tiles, monkeypatch):
    """A sink that fails mid-file stops the conversion with the error and
    leaves a well-formed file: the WAV's sizes are those of the frames
    written before it."""
    from dsd2dxd_tpu_torch.native.loader import NativeLib

    calls = []
    real = NativeLib.njad_quantize

    def failing(self, state, samples, bits):
        calls.append(len(samples))
        if len(calls) == 3:
            raise OSError("disk full")
        return real(self, state, samples, bits)

    monkeypatch.setattr(NativeLib, "njad_quantize", failing)
    with pytest.raises(OSError, match="disk full"):
        _port(tone_dsd128_dsf, tmp_path, bit_depth=24, output_rate=88200,
              dither=DitherType.NJAD)
    data = (tmp_path / "tone128.wav").read_bytes()
    n = sum(calls[:2]) * 2 * 3
    assert len(data) == 44 + n
    assert struct.unpack("<I", data[40:44])[0] == n
    assert struct.unpack("<I", data[4:8])[0] == 36 + n


# -- FLAC --------------------------------------------------------------------

def _flac_blocks(data: bytes) -> list:
    """(type, body) of each metadata block of a FLAC stream."""
    assert data[:4] == b"fLaC"
    out, i = [], 4
    while True:
        head = data[i]
        n = int.from_bytes(data[i + 1:i + 4], "big")
        out.append((head & 0x7F, data[i + 4:i + 4 + n]))
        i += 4 + n
        if head & 0x80:
            return out


@pytest.mark.parametrize("bits", [16, 20, 24])
def test_flac_decodes_to_the_wav_samples(tone_dsd64_stereo_dsf, tmp_path,
                                         small_tiles, bits):
    """16/20/24-bit TPDF FLAC through K1's integer words: the JAX decoder
    reads it with a good MD5, sample for sample the port's own WAV payload
    of the same file (same seed, same noise; 20-bit: >> 4)."""
    src = tone_dsd64_stereo_dsf
    kw = dict(bit_depth=bits, dither=DitherType.TPDF, output_rate=176400)
    flac = _port(src, tmp_path / "f", output=OutputType.FLAC, **kw)
    wav = _wav_samples(_port(src, tmp_path / "w", **kw), bits)
    st = decode_flac(flac.read_bytes())
    assert st.md5_ok
    assert (st.sample_rate, st.channels, st.bits_per_sample,
            st.total_samples) == (176400, 2, bits, 88200)
    np.testing.assert_array_equal(st.samples, wav)


def test_flac_matches_jax_converter(tone_dsd64_stereo_dsf, tmp_path,
                                    small_tiles):
    """24-bit NONE FLAC within 5 LSB of the JAX Converter's past the
    head, and, from a source with an ID3 tag carrying an APIC picture,
    the VORBIS_COMMENT and PICTURE blocks byte-equal to the JAX
    writer's."""
    src = tmp_path / "tagged.dsf"
    planes = synth_tone_dsd(1000.0, 0.25, 2_822_400, amplitude=0.5,
                            channels=2)
    jwrite_dsf(src, planes, 2_822_400, lsb_first=True, id3=_tag_with_apic())
    kw = dict(output=OutputType.FLAC)
    t = _port(src, tmp_path / "t", **kw).read_bytes()
    j = _convert(jengine.Converter, src, tmp_path / "j", **kw).read_bytes()
    tb, jb = _flac_blocks(t), _flac_blocks(j)
    assert [b[0] for b in tb] == [b[0] for b in jb] == [0, 4, 6]
    assert tb[1:] == jb[1:]
    ts, js = decode_flac(t), decode_flac(j)
    assert ts.md5_ok and js.md5_ok
    assert ts.comments == js.comments and ts.pictures == js.pictures
    assert ts.samples.shape == js.samples.shape == (88200, 2)
    assert np.abs(ts.samples[HEAD_SKIP:].astype(np.int64)
                  - js.samples[HEAD_SKIP:]).max() <= 5


def test_cli_config3_flac(tone_dsd128_dsf, tmp_path, small_tiles):
    """BASELINE config 3 through the CLI: `-b 20 -d N -o F -r 88200` on a
    DSD128 .dsf; its samples are the NJAD WAV's."""
    out = tmp_path / "out"
    out.mkdir()
    assert trun(["-b", "20", "-d", "N", "-o", "F", "-r", "88200", "-q",
                 "-p", str(out), str(tone_dsd128_dsf)], device="cpu") == 0
    st = decode_flac((out / "tone128.flac").read_bytes())
    assert st.md5_ok
    assert (st.sample_rate, st.channels, st.bits_per_sample,
            st.total_samples) == (88200, 2, 20, int(0.3 * 88200))
    wav = _wav_samples(_port(tone_dsd128_dsf, tmp_path / "w", bit_depth=20,
                             output_rate=88200, dither=DitherType.NJAD), 20)
    np.testing.assert_array_equal(st.samples, wav)
    spec = np.abs(np.fft.rfft(st.samples[2000:, 0].astype(np.float64)))
    freqs = np.fft.rfftfreq(len(st.samples) - 2000, 1 / 88200)
    assert abs(freqs[np.argmax(spec)] - 1000.0) < 10.0


def test_flac_48k(tone_dsd64_stereo_dsf, tmp_path, small_tiles):
    """A 96k FLAC (K1e -> K2t at 24-bit TPDF) decodes to the WAV's
    samples."""
    src = tone_dsd64_stereo_dsf
    kw = dict(output_rate=96000, dither=DitherType.TPDF)
    st = decode_flac(_port(src, tmp_path / "f", output=OutputType.FLAC,
                           **kw).read_bytes())
    assert st.md5_ok and st.sample_rate == 96000
    np.testing.assert_array_equal(
        st.samples, _wav_samples(_port(src, tmp_path / "w", **kw), 24))


def test_int_frames_rebuilds_k1_words():
    """K1's little-endian wire words back to (frames, C) int32: 16-bit,
    24-bit and 20-bit (the value << 4 on the wire, unshifted here)."""
    rng = np.random.default_rng(5)
    for bits in (16, 20, 24):
        lim = 1 << (bits - 1)
        v = rng.integers(-lim, lim, (300, 3)).astype(np.int32)
        v[0] = [-lim, lim - 1, 0]
        if bits == 16:
            wire = v.astype("<i2").view(np.uint8).reshape(-1)
        else:
            w = (v << 4) if bits == 20 else v
            wire = w.astype("<i4").view(np.uint8).reshape(-1, 4)[:, :3]
            wire = np.ascontiguousarray(wire).reshape(-1)
        got = tengine.int_frames(wire, bits, 3)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, v)


# -- the host library's build ---------------------------------------------------

def test_failed_build_raises_config_error(tmp_path, monkeypatch):
    """A g++ failure raises ConfigError carrying the compiler's output;
    nothing falls back."""
    src = tmp_path / "src"
    src.mkdir()
    for name in loader.SOURCES:
        (src / name).write_text("this is not C++;\n")
    monkeypatch.setattr(loader, "SRC", src)
    monkeypatch.setattr(loader, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(ConfigError, match="not C\\+\\+|error"):
        loader.build()
    assert not list((tmp_path / "build").iterdir())


def test_import_runs_no_compiler():
    """Importing every module of the port runs no compiler (the host
    library builds at first use, not at import)."""
    probe = (
        "import importlib, pkgutil, subprocess\n"
        "class Refuse(subprocess.Popen):\n"
        "    def __init__(self, cmd, *a, **k):\n"
        "        if any(c in str(cmd) for c in ('g++', 'nvcc')):\n"
        "            raise AssertionError(f'a compiler at import: {cmd}')\n"
        "        super().__init__(cmd, *a, **k)\n"
        "subprocess.Popen = Refuse\n"
        "import dsd2dxd_tpu_torch\n"
        "from dsd2dxd_tpu_torch.native import loader\n"
        "for m in pkgutil.walk_packages(dsd2dxd_tpu_torch.__path__,\n"
        "                               'dsd2dxd_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert loader._lib is None\n")
    res = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
