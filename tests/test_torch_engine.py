"""The port's engine and CLI on the CPU (dsd2dxd_tpu_torch/pipeline,
dsd2dxd_tpu_torch/cli) against the JAX engine, plus the configurations
both refuse."""

import enum
import io
import sys
import types
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from dsd2dxd_tpu.formats import dsd_types as jtypes
from dsd2dxd_tpu.pipeline import engine as jengine
from dsd2dxd_tpu.utils.errors import ConfigError as JConfigError
import dsd2dxd_tpu_torch.pipeline.engine as tengine
from dsd2dxd_tpu_torch import Converter as TConverter
from dsd2dxd_tpu_torch.cli.dsd2dxd import run as trun
from dsd2dxd_tpu_torch.formats.dsd_types import (
    DitherType,
    DsdRate,
    Endianness,
    FilterType,
    FmtType,
    OutputType,
)
from dsd2dxd_tpu_torch.utils.device import resolve_device
from dsd2dxd_tpu_torch.utils.errors import ConfigError

HEAD_SKIP = 128  # zero-primed JAX phase path vs idle-primed port


def _jax_enums(kw: dict) -> dict:
    """The port's enums as the JAX package's members of the same name."""
    return {k: getattr(jtypes, type(v).__name__)[v.name]
            if isinstance(v, enum.Enum) else v for k, v in kw.items()}


class JConverter:
    """The JAX Converter, called with the port's enums (keywords only)."""

    @staticmethod
    def from_container(**kw):
        return jengine.Converter.from_container(**_jax_enums(kw))

    @staticmethod
    def new(**kw):
        return jengine.Converter.new(**_jax_enums(kw))


@pytest.fixture
def small_tiles(monkeypatch):
    # several tiles per fixture, so the streamed state and n_valid count
    monkeypatch.setattr(tengine, "_DEFAULT_TILE_TARGET", 16 * 1024)


def _convert(cls, src, out_dir, output=OutputType.WAV, dither=DitherType.NONE,
             level=-1.0, **kw):
    conv = cls.from_container(
        bit_depth=24, output=output, level_db=level, output_rate=352800,
        out_dir=out_dir, dither=dither, filt=FilterType.EQUIRIPPLE,
        append_rate=False, base_dir=src.parent, input_path=src, **kw)
    conv.do_conversion()
    return conv


def _payload(path: Path, big_endian: bool):
    data = path.read_bytes()
    tag = b"SSND" if big_endian else b"data"
    i = data.index(tag)
    body_off = i + 8 + (8 if big_endian else 0)
    header = data[:body_off]
    b = np.frombuffer(data[body_off:], dtype=np.uint8)
    b = b[:len(b) // 3 * 3].reshape(-1, 3).astype(np.int64)
    if big_endian:
        b = b[:, ::-1]
    v = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
    return header, np.where(v >= 1 << 23, v - (1 << 24), v).reshape(-1, 2)


@pytest.mark.parametrize("output,ext,be", [(OutputType.WAV, "wav", False),
                                           (OutputType.AIFF, "aif", True)])
def test_slice_matches_jax_converter(tone_dsd64_stereo_dsf, tmp_path,
                                     small_tiles, output, ext, be):
    t_dir, j_dir = tmp_path / "t", tmp_path / "j"
    t_dir.mkdir()
    j_dir.mkdir()
    tconv = _convert(TConverter, tone_dsd64_stereo_dsf, t_dir, output,
                     device="cpu")
    jconv = _convert(JConverter, tone_dsd64_stereo_dsf, j_dir, output)
    assert tconv.stats["tiles"] > 2
    t_path, j_path = tconv.output_path(), jconv.output_path()
    assert t_path.name == j_path.name and t_path.suffix == f".{ext}"
    th, tv = _payload(t_path, be)
    jh, jv = _payload(j_path, be)
    assert th == jh  # headers byte-identical
    assert tv.shape == jv.shape == (176400, 2)
    assert np.abs(tv[HEAD_SKIP:] - jv[HEAD_SKIP:]).max() <= 5
    if not be:
        with wave.open(str(t_path)) as w:
            assert (w.getnchannels(), w.getsampwidth(), w.getframerate(),
                    w.getnframes()) == (2, 3, 352800, 176400)


def test_tiling_does_not_change_output(tone_dsd64_stereo_dsf, tmp_path,
                                       monkeypatch):
    """TPDF output is a function of the stream and the file seed only:
    tile keys are per tile, so compare two runs at one tile size, and
    NONE output across tile sizes."""
    outs = []
    for i, target in enumerate((16 * 1024, 64 * 1024)):
        monkeypatch.setattr(tengine, "_DEFAULT_TILE_TARGET", target)
        d = tmp_path / str(i)
        d.mkdir()
        conv = _convert(TConverter, tone_dsd64_stereo_dsf, d, device="cpu")
        outs.append(conv.output_path().read_bytes())
    assert outs[0] == outs[1]
    a = tmp_path / "a"
    b = tmp_path / "b"
    a.mkdir()
    b.mkdir()
    ca = _convert(TConverter, tone_dsd64_stereo_dsf, a,
                  dither=DitherType.TPDF, device="cpu")
    cb = _convert(TConverter, tone_dsd64_stereo_dsf, b,
                  dither=DitherType.TPDF, device="cpu")
    assert ca.output_path().read_bytes() == cb.output_path().read_bytes()
    assert ca.output_path().read_bytes() != outs[1]


def test_cli_writes_wav(tone_dsd64_stereo_dsf, tmp_path, small_tiles):
    out = tmp_path / "out"
    out.mkdir()
    rc = trun(["-o", "w", "-d", "X", "-l=-1", "-q", "-p", str(out),
               str(tone_dsd64_stereo_dsf)], device="cpu")
    assert rc == 0
    wav = out / (tone_dsd64_stereo_dsf.stem + ".wav")
    ref = tmp_path / "ref"
    ref.mkdir()
    conv = _convert(TConverter, tone_dsd64_stereo_dsf, ref, device="cpu")
    assert wav.read_bytes() == conv.output_path().read_bytes()
    # spectral sanity: the 1 kHz tone survives
    _h, v = _payload(wav, False)
    spec = np.abs(np.fft.rfft(v[HEAD_SKIP:, 0].astype(np.float64)))
    freqs = np.fft.rfftfreq(len(v) - HEAD_SKIP, 1 / 352800)
    assert abs(freqs[np.argmax(spec)] - 1000.0) < 5.0


def test_cli_without_cuda_fails_cleanly(tone_dsd64_stereo_dsf, tmp_path,
                                        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert trun(["-o", "w", "-q", "-p", str(tmp_path),
                 str(tone_dsd64_stereo_dsf)]) == 1
    assert not list(tmp_path.iterdir())


def test_device_none_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigError):
        resolve_device(None)
    with pytest.raises(ConfigError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("kw", [
    # FLAC and NJAD at every integer depth, dither, word-lane chain and
    # 48k-family rate convert; at 32 bit both refuse, as in the JAX engine
    dict(bit_depth=16, output=OutputType.FLAC),
    dict(bit_depth=20, dither=DitherType.NJAD),
    dict(bit_depth=32, dither=DitherType.NJAD, output_rate=192000),
    dict(bit_depth=32, output=OutputType.FLAC, dither=DitherType.FPD,
         output_rate=384000),
    dict(dither=DitherType.NJAD),
    dict(output=OutputType.FLAC), dict(output_rate=176400,
                                      output=OutputType.FLAC),
    dict(output_rate=96000, output=OutputType.FLAC),
], ids=["16bit", "20bit", "32bit", "FPD", "NJAD", "FLAC", "G2", "48k"])
def test_flac_njad_configs_convert_or_refuse(tone_dsd64_stereo_dsf, tmp_path,
                                             request, kw):
    args = dict(bit_depth=24, output=OutputType.WAV, level_db=0.0,
                output_rate=352800, out_dir=tmp_path,
                dither=DitherType.TPDF, filt=FilterType.EQUIRIPPLE,
                append_rate=False, base_dir=tone_dsd64_stereo_dsf.parent,
                input_path=tone_dsd64_stereo_dsf, device="cpu")
    args.update(kw)
    if args["bit_depth"] == 32:
        msg = ("FLAC output supports integer depths only"
               if args["output"] is OutputType.FLAC
               else "NJAD dither quantizes to integer depths")
        with pytest.raises(ConfigError, match=msg):
            TConverter.from_container(**args)
        with pytest.raises(JConfigError, match=msg):
            JConverter.from_container(**{k: v for k, v in args.items()
                                         if k != "device"})
        return
    _small_tiles_for(request, args["output_rate"])
    conv = TConverter.from_container(**args)
    conv.do_conversion()
    data = conv.output_path().read_bytes()
    rate, bits = args["output_rate"], args["bit_depth"]
    if args["output"] is OutputType.FLAC:
        from dsd2dxd_tpu.formats.flac_decode import decode_flac

        st = decode_flac(data)
        assert st.md5_ok and (st.sample_rate, st.bits_per_sample) == (rate,
                                                                      bits)
        pcm = st.samples
    else:
        assert data[:4] == b"RIFF" and len(data) == 44 + rate // 2 * 2 * 3
        pcm = _s24(data[44:]) >> (4 if bits == 20 else 0)
    assert pcm.shape == (rate // 2, 2)
    assert np.abs(pcm).max() > 1 << (bits - 3)


def test_level_check_on_stdin(tone_dsd64_stereo_dsf, small_tiles,
                              monkeypatch):
    """The level check of raw interleaved DSD on stdin (no input path)
    gives the .dsf's peak."""
    _stdin(monkeypatch, _raw_interleaved(tone_dsd64_stereo_dsf))
    db = TConverter.new_level_check(352800, None, FmtType.INTERLEAVED,
                                    Endianness.MSB_FIRST, 2, 4096,
                                    DsdRate.DSD64, device="cpu").check_level()
    ref = TConverter.new_level_check(352800, tone_dsd64_stereo_dsf,
                                     FmtType.PLANAR, Endianness.MSB_FIRST, 2,
                                     4096, DsdRate.DSD64,
                                     device="cpu").check_level()
    assert np.isfinite(db) and -12.0 < db < 0.0 and db == ref


@pytest.mark.parametrize("rate", [96000, 192000])
def test_48k_flac_njad_and_level_check_convert(tone_dsd64_stereo_dsf,
                                               tmp_path, request, rate):
    """At the 48k-family rates FLAC and NJAD convert (the same frame count
    as the WAV) and the level check gives a finite dBFS."""
    _small_tiles_for(request, rate)
    args = dict(bit_depth=24, output=OutputType.WAV, level_db=0.0,
                output_rate=rate, dither=DitherType.TPDF,
                filt=FilterType.EQUIRIPPLE, append_rate=False,
                base_dir=tone_dsd64_stereo_dsf.parent,
                input_path=tone_dsd64_stereo_dsf, device="cpu")
    for name, kw in (("flac", dict(output=OutputType.FLAC)),
                     ("njad", dict(dither=DitherType.NJAD))):
        (tmp_path / name).mkdir()
        conv = TConverter.from_container(**{**args, **kw,
                                            "out_dir": tmp_path / name})
        conv.do_conversion()
        assert conv.stats["audio_s"] == 0.5
        assert conv.output_path().stat().st_size > rate // 2 * 2 * 3 // 4
    db = TConverter.new_level_check(rate, tone_dsd64_stereo_dsf,
                                    FmtType.PLANAR, Endianness.MSB_FIRST, 2,
                                    4096, DsdRate.DSD64,
                                    device="cpu").check_level()
    assert np.isfinite(db) and -12.0 < db < 0.0


def test_stdout_raw_equals_wav_payload(tone_dsd64_stereo_dsf, tmp_path,
                                       small_tiles, capsysbinary):
    """-o S writes the same little-endian wire bytes as the WAV payload."""
    assert trun(["-o", "s", "-d", "X", "-l=-1", "-q",
                 str(tone_dsd64_stereo_dsf)],
                device="cpu") == 0
    raw = capsysbinary.readouterr().out
    conv = _convert(TConverter, tone_dsd64_stereo_dsf, tmp_path, device="cpu")
    wav = conv.output_path().read_bytes()
    assert len(raw) == 176400 * 2 * 3
    assert wav[44:] == raw


# -- the rest of the 44.1k family: ÷16..÷128, 16/20/32-bit -------------------

def _stdin(monkeypatch, data: bytes) -> None:
    monkeypatch.setattr(sys, "stdin",
                        types.SimpleNamespace(buffer=io.BytesIO(data)))


def _raw_interleaved(dsf: Path) -> bytes:
    """The .dsf's stereo stream as raw interleaved MSB-first DSD (what
    BASELINE config 2 pipes in)."""
    src = tengine.open_container(dsf)
    parts = []
    while (p := src.read(1 << 16)) is not None:
        parts.append(p)
    return np.concatenate(parts, axis=1).T.tobytes()


def _stdin_convert(cls, monkeypatch, capsysbinary, data, rate, bits,
                   **kw) -> bytes:
    _stdin(monkeypatch, data)
    conv = cls.new(bit_depth=bits, output=OutputType.STDOUT, level_db=-1.0,
                   output_rate=rate, out_dir=None, dither=DitherType.NONE,
                   fmt=FmtType.INTERLEAVED, endian=Endianness.MSB_FIRST,
                   input_rate=DsdRate.DSD64, block_size=4096, channels=2,
                   filt=FilterType.EQUIRIPPLE, append_rate=False,
                   base_dir=Path.cwd(), input_path=None, **kw)
    capsysbinary.readouterr()
    conv.do_conversion()
    return capsysbinary.readouterr().out


def _s24(raw: bytes, big_endian=False) -> np.ndarray:
    b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3).astype(np.int64)
    if big_endian:
        b = b[:, ::-1]
    v = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
    return np.where(v >= 1 << 23, v - (1 << 24), v).reshape(-1, 2)


def test_raw_stdin_div16_matches_jax_converter(tone_dsd64_stereo_dsf,
                                               small_tiles, monkeypatch,
                                               capsysbinary):
    """BASELINE config 2's path: raw interleaved DSD64 on stdin -> s24le
    176.4 kHz on stdout (a ÷16 chain, K1b), against the JAX Converter."""
    data = _raw_interleaved(tone_dsd64_stereo_dsf)
    t = _stdin_convert(TConverter, monkeypatch, capsysbinary, data, 176400,
                       24, device="cpu")
    j = _stdin_convert(JConverter, monkeypatch, capsysbinary, data, 176400,
                       24)
    assert len(t) == len(j) == 88200 * 2 * 3
    tv, jv = _s24(t), _s24(j)
    assert np.abs(tv[HEAD_SKIP:] - jv[HEAD_SKIP:]).max() <= 5
    assert np.abs(tv).max() > 1 << 21


def test_cli_stdin_config2(tone_dsd64_stereo_dsf, small_tiles, monkeypatch,
                           capsysbinary):
    """`dsd2dxd-torch -f I -r 176400 < in.dsd > out.raw` through the CLI's
    stdin entry equals the Converter's stream at TPDF (same file seed)."""
    data = _raw_interleaved(tone_dsd64_stereo_dsf)
    _stdin(monkeypatch, data)
    capsysbinary.readouterr()
    assert trun(["-f", "I", "-r", "176400", "-q"], device="cpu") == 0
    raw = capsysbinary.readouterr().out
    assert len(raw) == 88200 * 2 * 3
    ref = _stdin_convert(TConverter, monkeypatch, capsysbinary, data, 176400,
                         24, device="cpu")
    v, r = _s24(raw), _s24(ref)
    # TPDF against NONE, at -0 dB against -1 dB: the tone, 1 kHz
    spec = np.abs(np.fft.rfft(v[HEAD_SKIP:, 1].astype(np.float64)))
    freqs = np.fft.rfftfreq(len(v) - HEAD_SKIP, 1 / 176400)
    assert abs(freqs[np.argmax(spec)] - 1000.0) < 5.0
    gain = 10 ** (1 / 20)
    assert np.abs(v[HEAD_SKIP:] - r[HEAD_SKIP:] * gain).max() <= 3


@pytest.mark.parametrize("bits,output,rate,dither", [
    (20, OutputType.WAV, 88200, DitherType.NONE),      # ÷32
    (32, OutputType.AIFC, 176400, DitherType.FPD),     # ÷16, big-endian f32
    (16, OutputType.AIFF, 88200, DitherType.NONE),     # ÷32, big-endian s16
], ids=["20bit-wav", "32bit-aifc", "16bit-aiff"])
def test_files_match_jax_converter(tone_dsd64_stereo_dsf, tmp_path,
                                   small_tiles, bits, output, rate, dither):
    """16/20-bit and 32-bit float files against the JAX Converter:
    headers byte-identical, samples within 5 LSB (float: 2e-6, which
    the FPD ulp noise of either side stays far below)."""
    t_dir, j_dir = tmp_path / "t", tmp_path / "j"
    t_dir.mkdir()
    j_dir.mkdir()
    convs = []
    for cls, d, kw in ((TConverter, t_dir, dict(device="cpu")),
                       (JConverter, j_dir, {})):
        conv = cls.from_container(
            bit_depth=bits, output=output, level_db=-1.0, output_rate=rate,
            out_dir=d, dither=dither, filt=FilterType.EQUIRIPPLE,
            append_rate=False, base_dir=tone_dsd64_stereo_dsf.parent,
            input_path=tone_dsd64_stereo_dsf, **kw)
        conv.do_conversion()
        convs.append(conv.output_path().read_bytes())
    t, j = convs
    be = output is not OutputType.WAV
    tag = b"SSND" if be else b"data"
    off = t.index(tag) + 8 + (8 if be else 0)
    assert t[:off] == j[:off] and len(t) == len(j)
    n = int(0.5 * rate)
    if bits == 32:
        dt = ">f4" if be else "<f4"
        tv = np.frombuffer(t[off:], dtype=dt).reshape(-1, 2)
        jv = np.frombuffer(j[off:], dtype=dt).reshape(-1, 2)
        tol = 2e-6
    elif bits == 16:
        dt = ">i2" if be else "<i2"
        tv = np.frombuffer(t[off:], dtype=dt).astype(np.int64).reshape(-1, 2)
        jv = np.frombuffer(j[off:], dtype=dt).astype(np.int64).reshape(-1, 2)
        tol = 5
    else:
        assert all(b & 0x0F == 0 for b in t[off::3])  # 20 bits on top
        tv, jv = _s24(t[off:], be) >> 4, _s24(j[off:], be) >> 4
        tol = 5
    assert tv.shape == jv.shape == (n, 2)
    skip = HEAD_SKIP // (352800 // rate)
    assert np.abs(tv[skip:] - jv[skip:]).max() <= tol
    assert np.abs(tv).max() > 0.25 * (1 if bits == 32 else 1 << (bits - 1))


# -- the 48k family: ÷2^m head, ×160/147 tail ---------------------------------

@pytest.fixture
def small_48k_tiles(monkeypatch):
    """16 KiB/ch tiles of whole band blocks only (147 R_head bits, not
    also whole kernel blocks), so a 0.5 s fixture spans many tiles."""
    from dsd2dxd_tpu_torch.ops import rational

    def tile_bytes(chain, _target):
        unit = rational.rational_plan(chain).unit_bits
        return -(-16 * 1024 * 8 // unit) * unit // 8

    monkeypatch.setattr(tengine, "_tile_bytes_for", tile_bytes)

@pytest.mark.parametrize("bits,output,rate,dither", [
    (24, OutputType.WAV, 96000, DitherType.NONE),      # ÷32 head
    (32, OutputType.AIFC, 192000, DitherType.FPD),     # ÷16 head, BE f32
    (16, OutputType.AIFF, 384000, DitherType.NONE),    # ÷8 head, BE s16
], ids=["24bit-wav-96k", "32bit-aifc-192k", "16bit-aiff-384k"])
def test_48k_files_match_jax_converter(tone_dsd64_stereo_dsf, tmp_path,
                                       small_48k_tiles, bits, output, rate,
                                       dither):
    """48k-family files against the JAX Converter (its CPU phase path,
    zero-primed): headers byte-identical, the same length, samples within
    5 LSB (float: 2e-6) past the first 5 ms, where the idle-primed head
    and the zero-primed one differ."""
    t_dir, j_dir = tmp_path / "t", tmp_path / "j"
    t_dir.mkdir()
    j_dir.mkdir()
    convs = []
    for cls, d, kw in ((TConverter, t_dir, dict(device="cpu")),
                       (JConverter, j_dir, {})):
        conv = cls.from_container(
            bit_depth=bits, output=output, level_db=-1.0, output_rate=rate,
            out_dir=d, dither=dither, filt=FilterType.EQUIRIPPLE,
            append_rate=False, base_dir=tone_dsd64_stereo_dsf.parent,
            input_path=tone_dsd64_stereo_dsf, **kw)
        conv.do_conversion()
        convs.append(conv)
    assert convs[0].stats["tiles"] > 2
    t, j = (c.output_path().read_bytes() for c in convs)
    be = output is not OutputType.WAV
    tag = b"SSND" if be else b"data"
    off = t.index(tag) + 8 + (8 if be else 0)
    assert t[:off] == j[:off] and len(t) == len(j)
    if bits == 32:
        assert t[:off].find(b"fl32") > 0
        dt = ">f4"
        tv = np.frombuffer(t[off:], dtype=dt).reshape(-1, 2)
        jv = np.frombuffer(j[off:], dtype=dt).reshape(-1, 2)
        tol = 2e-6
    elif bits == 16:
        tv = np.frombuffer(t[off:], dtype=">i2").astype(np.int64).reshape(-1, 2)
        jv = np.frombuffer(j[off:], dtype=">i2").astype(np.int64).reshape(-1, 2)
        tol = 5
    else:
        tv, jv = _s24(t[off:], be), _s24(j[off:], be)
        tol = 5
    assert tv.shape == jv.shape == (rate // 2, 2)
    skip = rate // 200
    assert np.abs(tv[skip:] - jv[skip:]).max() <= tol
    assert np.abs(tv).max() > 0.25 * (1 if bits == 32 else 1 << (bits - 1))


def test_cli_48k_float_aifc(tone_dsd64_stereo_dsf, tmp_path,
                            small_48k_tiles):
    """BASELINE config 4's command, `-b 32 -o C -r 192000`: an AIFC of
    32-bit floats (FPD by default) with the 1 kHz tone, equal past the
    noise to the Converter's undithered run."""
    out = tmp_path / "out"
    out.mkdir()
    assert trun(["-b", "32", "-o", "C", "-r", "192000", "-q", "-p",
                 str(out), str(tone_dsd64_stereo_dsf)], device="cpu") == 0
    aifc = out / (tone_dsd64_stereo_dsf.stem + ".aifc")
    data = aifc.read_bytes()
    assert data[8:12] == b"AIFC" and b"fl32" in data[:200]
    off = data.index(b"SSND") + 16
    v = np.frombuffer(data[off:], dtype=">f4").reshape(-1, 2)
    assert v.shape == (96000, 2)
    ref = tmp_path / "ref"
    ref.mkdir()
    conv = TConverter.from_container(
        bit_depth=32, output=OutputType.AIFC, level_db=0.0,
        output_rate=192000, out_dir=ref, dither=DitherType.NONE,
        filt=FilterType.EQUIRIPPLE, append_rate=False,
        base_dir=tone_dsd64_stereo_dsf.parent,
        input_path=tone_dsd64_stereo_dsf, device="cpu")
    conv.do_conversion()
    r = np.frombuffer(conv.output_path().read_bytes()[off:],
                      dtype=">f4").reshape(-1, 2)
    assert 0 < np.abs(v - r).max() <= 2.0 ** -22  # FPD: within one ulp
    spec = np.abs(np.fft.rfft(v[960:, 0].astype(np.float64)))
    freqs = np.fft.rfftfreq(len(v) - 960, 1 / 192000)
    assert abs(freqs[np.argmax(spec)] - 1000.0) < 5.0


# -- .dff containers, raw planar LSB-first files, a batch on worker threads ---

def _planes(dsf: Path) -> np.ndarray:
    """The .dsf's (2, n) stream bytes, MSB-first."""
    return np.frombuffer(_raw_interleaved(dsf), dtype=np.uint8).reshape(
        -1, 2).T.copy()


def _both_wavs(make, tmp_path, rate):
    """The 24-bit NONE WAV of the port's Converter (on the CPU) and of the
    JAX Converter, each built by make(cls, out_dir, **device): headers
    equal, the same length, samples within 5 LSB past the first 5 ms
    (idle-primed against zero-primed)."""
    outs = []
    for cls, name, kw in ((TConverter, "t", dict(device="cpu")),
                          (JConverter, "j", {})):
        d = tmp_path / name
        d.mkdir()
        conv = make(cls, d, **kw)
        conv.do_conversion()
        outs.append(conv.output_path().read_bytes())
    t, j = outs
    assert t[:44] == j[:44] and len(t) == len(j)
    tv, jv = _s24(t[44:]), _s24(j[44:])
    skip = rate // 200
    assert np.abs(tv[skip:] - jv[skip:]).max() <= 5
    assert np.abs(tv).max() > 1 << 21
    return tv


def _small_tiles_for(request, rate):
    request.getfixturevalue("small_tiles" if rate % 44100 == 0
                            else "small_48k_tiles")


@pytest.mark.parametrize("rate", [352800, 96000])
def test_dff_file_matches_jax_converter(tone_dsd64_stereo_dsf, tmp_path,
                                        request, rate):
    """A .dff container (interleaved MSB-first bytes) through the port's
    Converter against the JAX Converter, at 352.8k (÷8) and at 96k (the
    ÷32 head and the ×160/147 step)."""
    from dsd2dxd_tpu_torch.formats.dff import write_dff

    _small_tiles_for(request, rate)
    src = tmp_path / "tone.dff"
    write_dff(src, _planes(tone_dsd64_stereo_dsf), 2_822_400)

    def make(cls, d, **kw):
        return cls.from_container(
            bit_depth=24, output=OutputType.WAV, level_db=-1.0,
            output_rate=rate, out_dir=d, dither=DitherType.NONE,
            filt=FilterType.EQUIRIPPLE, append_rate=False, base_dir=tmp_path,
            input_path=src, **kw)

    tv = _both_wavs(make, tmp_path, rate)
    assert tv.shape == (rate // 2, 2)


def test_raw_planar_lsb_file_matches_jax_converter(tone_dsd64_stereo_dsf,
                                                   tmp_path, small_tiles):
    """A raw .dsd file of planar 4096-byte blocks with LSB-first bits
    (`-f P -e L`) through the port's Converter against the JAX one."""
    planes = _planes(tone_dsd64_stereo_dsf)
    planes = planes[:, :planes.shape[1] // 4096 * 4096]
    rev = np.array([int(f"{b:08b}"[::-1], 2) for b in range(256)], np.uint8)
    src = tmp_path / "tone.dsd"
    src.write_bytes(rev[planes].reshape(2, -1, 4096).transpose(1, 0, 2)
                    .tobytes())

    def make(cls, d, **kw):
        return cls.new(
            bit_depth=24, output=OutputType.WAV, level_db=-1.0,
            output_rate=352800, out_dir=d, dither=DitherType.NONE,
            fmt=FmtType.PLANAR, endian=Endianness.LSB_FIRST,
            input_rate=DsdRate.DSD64, block_size=4096, channels=2,
            filt=FilterType.EQUIRIPPLE, append_rate=False, base_dir=tmp_path,
            input_path=src, **kw)

    tv = _both_wavs(make, tmp_path, 352800)
    assert tv.shape == (planes.shape[1], 2)


@pytest.mark.parametrize("rate", [352800, 96000])
def test_cli_batch_on_two_worker_threads(tone_dsd64_stereo_dsf, tmp_path,
                                         request, monkeypatch, rate):
    """Three short files converted as one batch by two worker threads on
    one device (they share the cached step) come out byte-equal to the
    same files converted one at a time, at TPDF (a file's noise depends
    on the file alone)."""
    import dsd2dxd_tpu_torch.cli.dsd2dxd as tcli
    from dsd2dxd_tpu_torch.formats.dsf import write_dsf

    _small_tiles_for(request, rate)
    planes = _planes(tone_dsd64_stereo_dsf)
    n = planes.shape[1]
    srcs = []
    for i, (a, b) in enumerate(((0, n // 3), (n // 5, n // 2), (n // 2, n))):
        srcs.append(tmp_path / f"part{i}.dsf")
        write_dsf(srcs[-1], planes[:, a:b], 2_822_400, lsb_first=True)
    batch, single = tmp_path / "batch", tmp_path / "single"
    batch.mkdir()
    single.mkdir()
    args = ["-o", "w", "-r", str(rate), "-q"]
    monkeypatch.setattr(tcli, "worker_count", lambda: 2)
    assert tcli.run(args + ["-p", str(batch)] + [str(s) for s in srcs],
                    device="cpu") == 0
    monkeypatch.setattr(tcli, "worker_count", lambda: 1)
    for s in srcs:
        assert tcli.run(args + ["-p", str(single), str(s)],
                        device="cpu") == 0
    for s in srcs:  # -p mirrors the inputs' tree under the output directory
        a, = (f.read_bytes() for f in batch.rglob(f"{s.stem}.wav"))
        b, = (f.read_bytes() for f in single.rglob(f"{s.stem}.wav"))
        assert len(a) > 44 + 6 * rate // 10 and a == b


def test_tagged_dff_to_aiff_matches_jax_converter(tone_dsd64_stereo_dsf,
                                                  tmp_path, small_tiles):
    """A .dff with an ID3 tag -> 24-bit AIFF at 88.2k, `-d N` (the path of
    the JAX suite's test_engine_aiff_24bit_with_id3, on a synthesized
    file): the port's AIFF against the JAX Converter's. FORM, COMM, the
    `ID3 ` chunk (the tag's bytes) and SSND's header byte for byte, the
    same length; the PCM within 5 LSB past the first 5 ms, as every file
    held against the JAX Converter (the port's cascade is idle-primed,
    the JAX phase path zero-primed, and they sum in another order)."""
    from dsd2dxd_tpu_torch.formats.dff import write_dff
    from dsd2dxd_tpu_torch.formats.id3 import Id3Frame, Id3Tag, parse_id3

    tag = Id3Tag(frames=[Id3Frame.text_frame("TIT2", "1kHz Test Tone DSD64"),
                         Id3Frame.text_frame("TALB", "album")]).to_bytes()
    src = tmp_path / "in" / "tone.dff"
    src.parent.mkdir()
    write_dff(src, _planes(tone_dsd64_stereo_dsf), 2_822_400, id3=tag)
    outs = []
    for cls, name, kw in ((TConverter, "t", dict(device="cpu")),
                          (JConverter, "j", {})):
        conv = cls.from_container(
            bit_depth=24, output=OutputType.AIFF, level_db=0.0,
            output_rate=88200, out_dir=tmp_path / name,
            dither=DitherType.NONE, filt=FilterType.EQUIRIPPLE,
            append_rate=False, base_dir=src.parent, input_path=src, **kw)
        conv.do_conversion()
        assert conv.output_path().suffix == ".aif"
        outs.append(conv.output_path().read_bytes())
    t, j = outs
    off = t.index(b"ID3 ")
    size = int.from_bytes(t[off + 4:off + 8], "big")
    assert t[off + 8:off + 8 + size] == tag
    assert parse_id3(t[off + 8:off + 8 + size]).get_text("TIT2") \
        == "1kHz Test Tone DSD64"
    body = t.index(b"SSND") + 16
    assert t[:body] == j[:body]
    assert len(t) == len(j)
    tv = _payload(tmp_path / "t" / "tone.aif", True)[1]
    jv = _payload(tmp_path / "j" / "tone.aif", True)[1]
    assert tv.shape == (88200 // 2, 2)
    skip = 88200 // 200
    assert np.abs(tv[skip:] - jv[skip:]).max() <= 5
    assert np.abs(tv).max() > 1 << 21


def test_trace_line_has_the_dsd_input_rate(tone_dsd64_stereo_dsf, tmp_path,
                                           small_tiles):
    """The per-stream TRACE line carries the JAX engine's "MiB/s DSD in"
    beside the real-time factor: the stream's input bytes over its
    wall."""
    import logging
    import re

    from dsd2dxd_tpu_torch.utils.logging import TRACE, get_logger

    lines: list = []
    handler = logging.Handler()
    handler.emit = lambda r: lines.append(r.getMessage())
    log = get_logger()
    level = log.level
    log.addHandler(handler)
    log.setLevel(TRACE)
    try:
        conv = _convert(TConverter, tone_dsd64_stereo_dsf, tmp_path,
                        device="cpu")
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
    line, = [ln for ln in lines if "real-time" in ln]
    m = re.fullmatch(r"(\S+): ([\d.]+)s audio in ([\d.]+)s \((\d+)x "
                     r"real-time, ([\d.]+) MiB/s DSD in, \d+ reads for "
                     r"\d+ tiles, on cpu\)", line)
    assert m and m[1] == tone_dsd64_stereo_dsf.name
    info = conv.source.info
    rate = (info.data_bytes_per_channel * info.channels
            / conv.stats["elapsed_s"] / 2**20)
    assert m[5] == f"{rate:.1f}"
