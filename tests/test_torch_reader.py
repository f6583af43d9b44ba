"""The port's .dsf reader (``formats/source.py`` over
``native/src/dsfread.cc``) against the JAX package's numpy reader, on
the CPU: the same arrays read for read, over block sizes, channel
counts, tiles that are not whole blocks, truncated and short data, a
sample count that ends inside a byte, ID3 after the data and an LSB-first
interleaved raw stream; the native bit reversal against ``reverse_bits``;
the reader's counters in ``Converter.stats``."""

import io
import logging
import re

import numpy as np
import pytest

from dsd2dxd_tpu.formats import dsd_types as jtypes
from dsd2dxd_tpu.formats import dsf as jdsf
from dsd2dxd_tpu.formats import id3 as jid3
from dsd2dxd_tpu.formats import source as jsource
from dsd2dxd_tpu_torch.formats import dsd_types as ttypes
from dsd2dxd_tpu_torch.formats import dsf as tdsf
from dsd2dxd_tpu_torch.formats import source as tsource
from dsd2dxd_tpu_torch.native import loader
from dsd2dxd_tpu_torch.pipeline import engine as tengine
from dsd2dxd_tpu_torch.utils.errors import ConfigError
from dsd2dxd_tpu_torch.utils.logging import TRACE, get_logger


def _bytes(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


def _reads(src, tile: int) -> list:
    """Every array `src.read(tile)` returns, copied, until None."""
    out = []
    while (p := src.read(tile)) is not None:
        out.append(p.copy())
    return out


def _assert_same_reads(j: list, t: list) -> None:
    assert len(t) == len(j)
    for a, b in zip(j, t):
        assert b.dtype == np.uint8 and b.flags.c_contiguous
        np.testing.assert_array_equal(b, a)


# -- .dsf files, both packages' open_dsf --------------------------------------

@pytest.mark.parametrize("tile_blocks", [2.0, 1.37], ids=["whole", "part"])
@pytest.mark.parametrize("block_size", [1, 4096, 8192])
@pytest.mark.parametrize("channels", [1, 2, 6])
def test_dsf_reads_equal(tmp_path, channels, block_size, tile_blocks):
    """LSB-first .dsf with an ID3 chunk after the data: every read equal
    to the JAX reader's, tiles of whole blocks and tiles that end inside
    a block (the block's tail carried to the next read); the data's
    last block is short, so the file pads it."""
    n = int(3.5 * block_size) + 5 if block_size > 1 else 1234
    planes = np.frombuffer(_bytes(channels, channels * n),
                           np.uint8).reshape(channels, n)
    tag = jid3.Id3Tag(frames=[jid3.Id3Frame.text_frame("TIT2", "t")])
    path = tmp_path / "t.dsf"
    jdsf.write_dsf(path, planes, 2822400, block_size=block_size,
                   id3=tag.to_bytes())
    tile = max(1, int(tile_blocks * block_size)) if block_size > 1 else (
        500 if tile_blocks == 2.0 else 333)
    jsrc, _ = jdsf.open_dsf(path)
    tsrc, _ = tdsf.open_dsf(path)
    try:
        got = _reads(tsrc, tile)
        _assert_same_reads(_reads(jsrc, tile), got)
    finally:
        jsrc._stream.close()
        tsrc._stream.close()
    np.testing.assert_array_equal(np.concatenate(got, axis=1), planes)
    assert tsrc.read_tiles == len(got)


def test_truncated_dsf_file_equal(tmp_path):
    """A .dsf cut inside its last super-block (the header still declares
    the whole data): the short block is padded with 0x69 in file order
    before the bit reversal, as the JAX reader does."""
    planes = np.frombuffer(_bytes(7, 2 * 5 * 4096), np.uint8).reshape(2, -1)
    path = tmp_path / "t.dsf"
    jdsf.write_dsf(path, planes, 2822400)
    data = path.read_bytes()
    cut = tmp_path / "cut.dsf"
    cut.write_bytes(data[:len(data) - 4096 - 1000])
    jsrc, _ = jdsf.open_dsf(cut)
    tsrc, _ = tdsf.open_dsf(cut)
    try:
        got = _reads(tsrc, 3 * 4096)
        _assert_same_reads(_reads(jsrc, 3 * 4096), got)
    finally:
        jsrc._stream.close()
        tsrc._stream.close()
    tail = np.concatenate(got, axis=1)[:, -4096:]
    assert (tail[1, -1000:] == tsource.reverse_bits(
        np.full(1000, 0x69, np.uint8))).all()


# -- DsdSource over a byte stream, both packages ------------------------------

# id -> (fmt, endianness, channels, block_size, payload bytes in the
#        stream, data_length, sample_count, tile)
EDGES = {
    # the data chunk ends inside a super-block; ID3 bytes follow it
    "short-data-chunk": ("P", "L", 2, 4096, 3 * 8192 + 3000,
                         3 * 8192 + 3000, None, 5000),
    # the stream ends before data_length: the last block is cut
    "truncated-block": ("P", "L", 2, 4096, 2 * 8192 + 777, 4 * 8192,
                        None, 4096),
    # sample_count ends inside a byte: the last byte is kept, the file's
    # zero pad after it trimmed
    "sample-count-mid-byte": ("P", "L", 6, 4096, 6 * 4096,
                              6 * 4096, 8 * 3001 - 3, 1024),
    "sample-count-msb": ("P", "M", 1, 8192, 8192, 8192, 8 * 5000 - 5, 700),
    # raw planar from a pipe: no length, until EOF
    "raw-planar-eof": ("P", "L", 2, 4096, 5 * 8192 + 100, None, None, 6000),
    "interleaved-lsb": ("I", "L", 2, 1, 40001, None, None, 4096),
    "interleaved-lsb-6ch": ("I", "L", 6, 1, 6 * 3000 + 5, 6 * 3000 + 5,
                            None, 1000),
    "interleaved-msb": ("I", "M", 2, 1, 30000, 30000, None, 7000),
    # `-f P -s 0` on the command line: nothing to read
    "raw-planar-block-size-0": ("P", "L", 2, 0, 8192, None, None, 4096),
}


@pytest.mark.parametrize("case", sorted(EDGES))
def test_stream_reads_equal(case):
    fmt, endian, channels, bs, n, length, samples, tile = EDGES[case]
    data = _bytes(len(case), n) + b"ID3\x04\x00\x00\x00\x00\x00\x10" * 4
    reads = []
    for types, source in ((jtypes, jsource), (ttypes, tsource)):
        info = source.DsdStreamInfo(
            channels=channels, rate=types.DsdRate.DSD64,
            fmt=types.FmtType.from_char(fmt),
            endianness=types.Endianness.from_char(endian),
            block_size=bs, sample_count=samples)
        stream = io.BytesIO(data if length is not None else data[:n])
        reads.append(_reads(source.DsdSource(stream, info, length), tile))
    _assert_same_reads(*reads)
    assert bool(reads[1]) == (bs > 0)


def test_reads_are_fresh_arrays():
    """Each read returns an array of its own: a later read (the reused
    file buffer, a carried block tail) leaves an earlier one as it was,
    which the sharded route relies on."""
    info = tsource.DsdStreamInfo(
        channels=2, rate=ttypes.DsdRate.DSD64, fmt=ttypes.FmtType.PLANAR,
        endianness=ttypes.Endianness.LSB_FIRST, block_size=4096)
    src = tsource.DsdSource(io.BytesIO(_bytes(3, 6 * 8192)), info)
    first = src.read(5000)
    kept = first.copy()
    rest = []
    while (p := src.read(5000)) is not None:
        assert not np.shares_memory(p, src._buf)
        rest.append(p)
    assert not any(np.shares_memory(first, r) for r in rest)
    np.testing.assert_array_equal(first, kept)


# -- the native passes ----------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 255, 256, 4099])
@pytest.mark.parametrize("offset", [0, 3])
def test_native_bitrev_equals_reverse_bits(n, offset):
    """In place, equal to the numpy table on every byte value (256 and
    more bytes count through them all), at lengths that are not a
    multiple of 8 and from an address that is not word-aligned."""
    buf = np.arange(n + offset, dtype=np.int64).astype(np.uint8)
    buf[offset:] ^= np.frombuffer(_bytes(n, n), np.uint8) * (n > 256)
    a = buf[offset:]
    want = tsource.reverse_bits(a)
    loader.load_reader().bitrev(a)
    np.testing.assert_array_equal(a, want)
    if n >= 256:
        assert len(np.unique(want)) == 256


@pytest.mark.parametrize("blocks,col,ncols", [(3, 0, 3 * 16), (3, 5, 40),
                                              (1, 2, 1), (0, 4, 0)])
def test_native_planes_equals_reshape(blocks, col, ncols):
    """``planes`` writes the first `ncols` columns of `blocks`
    super-blocks from column `col` on, and leaves the columns before it."""
    c, bs = 3, 16
    raw = np.frombuffer(_bytes(blocks, max(1, blocks) * c * bs), np.uint8)
    out = np.full((c, col + ncols), 7, np.uint8)
    loader.load_reader().planes(raw, blocks, bs, out, col)
    want = raw[:blocks * c * bs].reshape(blocks, c, bs).transpose(
        1, 0, 2).reshape(c, -1)[:, :ncols]
    np.testing.assert_array_equal(out[:, col:], want)
    assert (out[:, :col] == 7).all()


def test_native_planes_refuses_short_input():
    """The sizes are checked before a pointer reaches the C++."""
    out = np.empty((2, 100), np.uint8)
    with pytest.raises(ValueError):
        loader.load_reader().planes(np.zeros(2 * 50, np.uint8), 1, 64, out, 0)
    with pytest.raises(ValueError):
        loader.load_reader().bitrev(out[:, ::2])


def test_failed_reader_build_raises_config_error(tmp_path, monkeypatch):
    """The reader library is built apart from the NJAD/FLAC library and,
    like it, raises ConfigError with the compiler's output; nothing falls
    back to numpy."""
    assert set(loader.READER_SOURCES).isdisjoint(loader.SOURCES)
    src = tmp_path / "src"
    src.mkdir()
    for name in loader.READER_SOURCES:
        (src / name).write_text("this is not C++;\n")
    monkeypatch.setattr(loader, "SRC", src)
    monkeypatch.setattr(loader, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(ConfigError, match="reader.*\n.*error"):
        loader.build_reader()
    assert not list((tmp_path / "build").iterdir())


# -- the counters ----------------------------------------------------------------

def test_one_file_read_per_tile(tmp_path, monkeypatch):
    """A .dsf whose tiles are whole blocks through the CPU route: one
    stream read per tile, both counters in ``Converter.stats`` and in
    the stream's TRACE line."""
    monkeypatch.setattr(tengine, "_DEFAULT_TILE_TARGET", 16 * 1024)
    planes = np.frombuffer(_bytes(11, 2 * 200_000), np.uint8).reshape(2, -1)
    path = tmp_path / "t.dsf"
    tdsf.write_dsf(path, planes, 2822400)
    lines: list = []
    handler = logging.Handler()
    handler.emit = lambda r: lines.append(r.getMessage())
    log = get_logger()
    level = log.level
    log.addHandler(handler)
    log.setLevel(TRACE)
    try:
        conv = tengine.Converter.from_container(
            bit_depth=24, output=ttypes.OutputType.WAV, level_db=-1.0,
            output_rate=352800, out_dir=tmp_path / "out",
            dither=ttypes.DitherType.NONE,
            filt=ttypes.FilterType.EQUIRIPPLE, append_rate=False,
            base_dir=tmp_path, input_path=path, device="cpu")
        conv.do_conversion()
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
    st = conv.stats
    assert st["tile_bytes"] % 4096 == 0 and st["tiles"] > 2
    assert st["read_calls"] == st["read_tiles"] == st["tiles"]
    line, = [ln for ln in lines if "real-time" in ln]
    m = re.search(r", (\d+) reads for (\d+) tiles, on cpu\)$", line)
    assert m and (int(m[1]), int(m[2])) == (st["read_calls"],
                                             st["read_tiles"])
