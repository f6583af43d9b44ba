"""The port's own host layers (dsd2dxd_tpu_torch/formats, containers,
filters, native, cli) against the JAX package's modules they were copied
from, on the CPU: the filter tables bit for bit for every cached chain, the
readers on the same bytes, the writers byte for byte (FLAC too), the NJAD
and FLAC C++ sources byte for byte, the FLAC decoder, the ID3 parser, the
output paths and the CLI parser."""

import dataclasses
import enum
import filecmp
import io
import logging
from pathlib import Path

import numpy as np
import pytest

from dsd2dxd_tpu.cli import dsd2dxd as jcli
from dsd2dxd_tpu.containers import aiff as jaiff
from dsd2dxd_tpu.containers import flac as jflac
from dsd2dxd_tpu.containers import wav as jwav
from dsd2dxd_tpu.filters import design as jdesign
from dsd2dxd_tpu.formats import dff as jdff
from dsd2dxd_tpu.formats import discover as jdiscover
from dsd2dxd_tpu.formats import dsd_types as jtypes
from dsd2dxd_tpu.formats import dsf as jdsf
from dsd2dxd_tpu.formats import flac_decode as jflac_decode
from dsd2dxd_tpu.formats import id3 as jid3
from dsd2dxd_tpu.formats import source as jsource
from dsd2dxd_tpu_torch.cli import dsd2dxd as tcli
from dsd2dxd_tpu_torch.containers import aiff as taiff
from dsd2dxd_tpu_torch.containers import flac as tflac
from dsd2dxd_tpu_torch.containers import wav as twav
from dsd2dxd_tpu_torch.filters import design as tdesign
from dsd2dxd_tpu_torch.formats import dff as tdff
from dsd2dxd_tpu_torch.formats import discover as tdiscover
from dsd2dxd_tpu_torch.formats import dsd_types as ttypes
from dsd2dxd_tpu_torch.formats import dsf as tdsf
from dsd2dxd_tpu_torch.formats import flac_decode as tflac_decode
from dsd2dxd_tpu_torch.formats import id3 as tid3
from dsd2dxd_tpu_torch.formats import source as tsource

T_CACHE = Path(tdesign.__file__).parent / "cache"
J_CACHE = Path(jdesign.__file__).parent / "cache"
CACHED = sorted(p.name for p in T_CACHE.glob("*.npz"))


def _plain(v):
    """A value with every enum as (class name, member name), every
    dataclass as a dict, so the two packages' objects compare."""
    if isinstance(v, enum.Enum):
        return (type(v).__name__, v.name)
    if dataclasses.is_dataclass(v):
        return {f.name: _plain(getattr(v, f.name))
                for f in dataclasses.fields(v)}
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_plain(x) for x in v)
    return v


def _planes(seed, channels=2, n=10000):
    return np.random.default_rng(seed).integers(0, 256, (channels, n),
                                                dtype=np.uint8)


def _read_all(src):
    parts = []
    while (p := src.read(3000)) is not None:
        parts.append(p)
    return np.concatenate(parts, axis=1)


# -- the filter tables -------------------------------------------------------------

def test_cache_is_a_byte_copy():
    """All 29 designed tables (the 20 pure ÷2^k chains and the 9 48k
    chains), byte for byte under the same names (the design version is
    in the key)."""
    assert len(CACHED) == 29
    assert CACHED == sorted(p.name for p in J_CACHE.glob("*.npz"))
    for name in CACHED:
        assert filecmp.cmp(T_CACHE / name, J_CACHE / name, shallow=False)
    assert tdesign._DESIGN_VERSION == jdesign._DESIGN_VERSION == 5


@pytest.mark.parametrize("name", CACHED)
def test_get_chain_bit_equal(name):
    """Equal taps (bits and dtype), L and M from each package's get_chain,
    for a chain whose table both caches hold (neither designs anew)."""
    filt, rate, out, _ = name[:-4].split("_")
    tkey = (ttypes.FilterType(filt), ttypes.DsdRate(int(rate)), int(out))
    jkey = (jtypes.FilterType(filt), jtypes.DsdRate(int(rate)), int(out))
    assert tdesign._cache_key(*tkey) + ".npz" == name
    assert jdesign._cache_key(*jkey) + ".npz" == name
    tc, jc = tdesign.get_chain(*tkey), jdesign.get_chain(*jkey)
    assert len(tc) == len(jc) > 0
    for a, b in zip(tc, jc):
        assert (a.L, a.M) == (b.L, b.M)
        assert a.taps.dtype == b.taps.dtype
        np.testing.assert_array_equal(a.taps.view(np.uint8),
                                      b.taps.view(np.uint8))
    assert tdesign.chain_ratio(tc) == jdesign.chain_ratio(jc)


# -- the readers ---------------------------------------------------------------

@pytest.mark.parametrize("lsb_first", [True, False], ids=["lsb", "msb"])
def test_open_dsf_equal(tmp_path, lsb_first):
    planes = _planes(1)
    tag = jid3.Id3Tag(frames=[jid3.Id3Frame.text_frame("TIT2", "tone")])
    jpath, tpath = tmp_path / "j.dsf", tmp_path / "t.dsf"
    jdsf.write_dsf(jpath, planes, 2822400, lsb_first=lsb_first,
                   id3=tag.to_bytes())
    tdsf.write_dsf(tpath, planes, 2822400, lsb_first=lsb_first,
                   id3=tag.to_bytes())
    assert jpath.read_bytes() == tpath.read_bytes()
    jsrc, jmeta = jdsf.open_dsf(jpath)
    tsrc, tmeta = tdsf.open_dsf(jpath)
    assert _plain(tmeta) == _plain(jmeta)
    assert _plain(tsrc.info) == _plain(jsrc.info)
    got = _read_all(tsrc)
    np.testing.assert_array_equal(got, _read_all(jsrc))
    np.testing.assert_array_equal(got, planes)


def test_open_dff_equal(tmp_path):
    planes = _planes(2)
    tag = jid3.Id3Tag(frames=[jid3.Id3Frame.text_frame("TALB", "album")])
    jpath, tpath = tmp_path / "j.dff", tmp_path / "t.dff"
    jdff.write_dff(jpath, planes, 5644800, id3=tag.to_bytes())
    tdff.write_dff(tpath, planes, 5644800, id3=tag.to_bytes())
    assert jpath.read_bytes() == tpath.read_bytes()
    jsrc, jmeta = jdff.open_dff(jpath)
    tsrc, tmeta = tdff.open_dff(jpath)
    assert _plain(tmeta) == _plain(jmeta)
    assert _plain(tsrc.info) == _plain(jsrc.info)
    got = _read_all(tsrc)
    np.testing.assert_array_equal(got, _read_all(jsrc))
    np.testing.assert_array_equal(got, planes)


@pytest.mark.parametrize("fmt,endian", [("I", "M"), ("P", "L")])
def test_raw_source_equal(fmt, endian):
    data = _planes(3, 1, 3 * 4096 * 2)[0].tobytes()
    srcs = []
    for types, source in ((jtypes, jsource), (ttypes, tsource)):
        srcs.append(source.raw_source(
            io.BytesIO(data), 2, types.DsdRate.DSD64,
            types.FmtType.from_char(fmt), types.Endianness.from_char(endian),
            4096))
    jsrc, tsrc = srcs
    assert _plain(tsrc.info) == _plain(jsrc.info)
    np.testing.assert_array_equal(_read_all(tsrc), _read_all(jsrc))


# -- the writers ---------------------------------------------------------------

@pytest.mark.parametrize("kind,bits", [("wav", 16), ("wav", 20), ("wav", 24),
                                       ("wav", 32), ("aiff", 16),
                                       ("aiff", 24), ("aifc", 32)])
@pytest.mark.parametrize("with_id3", [False, True], ids=["plain", "id3"])
def test_writers_byte_identical(kind, bits, with_id3):
    rng = np.random.default_rng(4)
    if bits == 32:
        samples = rng.uniform(-1, 1, (500, 2)).astype(np.float32)
    else:
        lim = 1 << (bits - 1)
        samples = rng.integers(-lim, lim, (500, 2)).astype(np.int32)
    id3 = (jid3.Id3Tag(frames=[jid3.Id3Frame.text_frame("TIT2", "t")])
           .to_bytes() if with_id3 else None)
    outs = []
    for wav, aiff in ((jwav, jaiff), (twav, taiff)):
        f = io.BytesIO()
        if kind == "wav":
            w = wav.WavWriter(f, 2, 352800, bits, id3=id3)
        else:
            w = aiff.AiffWriter(f, 2, 352800, bits, aifc=kind == "aifc",
                                id3=id3)
        w.write(samples[:200])
        w.write(samples[200:])
        w.finalize()
        outs.append(f.getvalue())
    assert outs[0] == outs[1]
    assert len(outs[0]) > 500 * 2 * (bits // 8)


@pytest.mark.parametrize("name", ["njad.cc", "flac.cc", "dsdkit.cc"])
def test_native_sources_are_byte_copies(name):
    """The port's NJAD, FLAC and modulator C++ are the JAX package's,
    byte for byte (the port builds its own library from them)."""
    from dsd2dxd_tpu_torch.native import loader

    assert name in loader.SOURCES
    jsrc = Path(jcli.__file__).parent.parent / "native" / "src" / name
    assert filecmp.cmp(loader.SRC / name, jsrc, shallow=False)


@pytest.mark.parametrize("bits", [16, 20, 24])
def test_flac_writer_and_decoder_equal(bits):
    """The port's FlacWriter (on its own library) writes the JAX writer's
    bytes for the same int32 frames and ID3 tag (TIT2, TALB, an APIC), in
    three writes; the port's decoder reads them as the JAX decoder does."""
    rng = np.random.default_rng(bits)
    lim = 1 << (bits - 1)
    t = np.arange(20000)[:, None]
    samples = (0.5 * lim * np.sin(t / (9.1 + np.arange(2)))
               + rng.integers(-64, 64, (20000, 2))).astype(np.int32)
    tag = jid3.Id3Tag(frames=[
        jid3.Id3Frame.text_frame("TIT2", "Tone"),
        jid3.Id3Frame.text_frame("TALB", "Album é"),
        jid3.Id3Frame("APIC", b"\x00image/png\x00\x03\x00" + b"\x89PNG" * 9),
    ]).to_bytes()
    outs = []
    for flac in (jflac, tflac):
        f = io.BytesIO()
        w = flac.FlacWriter(f, 2, 176400, bits, id3=tag)
        for part in np.split(samples, [7000, 15000]):
            w.write(part)
        w.finalize()
        outs.append(f.getvalue())
    assert outs[0] == outs[1]
    j = jflac_decode.decode_flac(outs[0])
    t_ = tflac_decode.decode_flac(outs[0])
    assert _plain({k: v for k, v in vars(t_).items() if k != "samples"}) \
        == _plain({k: v for k, v in vars(j).items() if k != "samples"})
    assert t_.md5_ok and t_.pictures and t_.comments
    np.testing.assert_array_equal(t_.samples, j.samples)
    np.testing.assert_array_equal(t_.samples, samples)


# -- ID3, output paths, the CLI parser -------------------------------------------

def test_parse_id3_equal():
    tag = jid3.Id3Tag(version=(4, 0), frames=[
        jid3.Id3Frame.text_frame("TIT2", "Tone"),
        jid3.Id3Frame.text_frame("TALB", "Album é"),
        jid3.Id3Frame("TPE1", b"\x01" + "Artist".encode("utf-16")),
        jid3.Id3Frame("APIC", b"\x00image/png\x00\x03\x00" + b"\x89PNG"),
    ])
    blob = tag.to_bytes()
    for b in (blob, blob[:len(blob) - 5], b"", b"ID3\x03\x00\x00garbage"):
        assert _plain(tid3.parse_id3(b)) == _plain(jid3.parse_id3(b))
    t, j = tid3.parse_id3(blob), jid3.parse_id3(blob)
    t.append_to_album(" [352800]")
    j.append_to_album(" [352800]")
    assert t.to_bytes() == j.to_bytes()


@pytest.mark.parametrize("case", [
    dict(input_path=None, out_dir=None, output="W", rate=352800, app=False),
    dict(input_path="a/b/t.dsf", out_dir="out", output="A", rate=88200,
         app=True),
    dict(input_path="a/t.dff", out_dir=None, output="C", rate=192000,
         app=False),
    dict(input_path="x/y/t.dsd", out_dir="out", output="F", rate=96000,
         app=True),
])
def test_build_output_path_equal(tmp_path, case):
    inp = None if case["input_path"] is None else tmp_path / case["input_path"]
    out = None if case["out_dir"] is None else tmp_path / case["out_dir"]
    paths = [disc.build_output_path(inp, tmp_path, out,
                                    types.OutputType.from_char(case["output"]),
                                    case["rate"], case["app"])
             for disc, types in ((jdiscover, jtypes), (tdiscover, ttypes))]
    assert paths[0] == paths[1]


@pytest.mark.parametrize("argv", [
    [],
    ["-o", "w", "-p", "out", "a.dsf", "b.dff"],
    ["-f", "I", "-r", "176400", "-q"],
    ["-b", "32", "-o", "C", "-r", "192000", "-d", "F", "-l=-3", "-a", "-R",
     "-v", "dir"],
    ["-c", "1", "-e", "L", "-s", "2048", "-i", "4", "-t", "C", "-"],
])
def test_build_parser_same_namespace(argv):
    assert vars(tcli.build_parser().parse_args(argv)) == vars(
        jcli.build_parser().parse_args(argv))


def test_parse_enums_and_expand_inputs_equal(tmp_path):
    (tmp_path / "d").mkdir()
    for n in ("d/a.dsf", "d/b.dff", "c.dsd", "note.txt"):
        (tmp_path / n).write_bytes(b"")
    log = logging.getLogger("test_torch_host")
    for argv in (["-b", "32", str(tmp_path / "d")],
                 ["-d", "R", "-o", "a", "-R", str(tmp_path), "-",
                  str(tmp_path / "no*such")]):
        ta = tcli.build_parser().parse_args(argv)
        ja = jcli.build_parser().parse_args(argv)
        assert _plain(tcli.parse_enums(ta)) == _plain(jcli.parse_enums(ja))
        assert tcli.expand_inputs(ta.inputs, ta.recurse, log) == \
            jcli.expand_inputs(ja.inputs, ja.recurse, log)
    assert tcli.worker_count() == jcli.worker_count()
