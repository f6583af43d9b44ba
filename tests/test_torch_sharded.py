"""The port's multi-device conversion on the CPU (dsd2dxd_tpu_torch/parallel,
utils/device.py's batch_devices and stream_devices, the CLI's round-robin,
the engine's sharded route) against the port's own streaming step and the
JAX package's sharded functions on the conftest's virtual CPU mesh."""

import enum
import os
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from dsd2dxd_tpu.filters.design import get_chain as jget_chain
from dsd2dxd_tpu.formats import dsd_types as jtypes
from dsd2dxd_tpu.ops.resample import StepConfig as JStepConfig
from dsd2dxd_tpu.parallel import sharded as jsharded
from dsd2dxd_tpu.pipeline import engine as jengine
import dsd2dxd_tpu_torch.cli.dsd2dxd as tcli
import dsd2dxd_tpu_torch.pipeline.engine as tengine
from dsd2dxd_tpu_torch import Converter as TConverter
from dsd2dxd_tpu_torch.filters.design import chain_ratio, get_chain
from dsd2dxd_tpu_torch.formats.dsd_types import (
    DitherType,
    DsdRate,
    Endianness,
    FilterType,
    FmtType,
    OutputType,
)
from dsd2dxd_tpu_torch.ops import rational
from dsd2dxd_tpu_torch.ops.resample import StepConfig
from dsd2dxd_tpu_torch.parallel import sharded
from dsd2dxd_tpu_torch.tools import shardcheck
from dsd2dxd_tpu_torch.utils import device as tdevice
from dsd2dxd_tpu_torch.utils.errors import ConfigError

E = FilterType.EQUIRIPPLE
HEAD_SKIP = 128  # zero-primed JAX phase path vs idle-primed port (at 352.8k)
CPU4 = [torch.device("cpu")] * 4
# every chain get_chain caches
CHAINS = ([(E, r, o) for r in (DsdRate.DSD64, DsdRate.DSD128, DsdRate.DSD256)
           for o in (88200, 176400, 352800, 705600, 96000, 192000, 384000)
           if (r, o) != (DsdRate.DSD64, 705600)]
          + [(E, DsdRate.DSD512, 352800), (FilterType.DSD2PCM, DsdRate.DSD64,
                                           352800)]
          + [(FilterType.XLD, DsdRate.DSD64, o) for o in (88200, 176400,
                                                          352800)]
          + [(FilterType.CHEBYSHEV, DsdRate.DSD128, o)
             for o in (88200, 176400, 352800)])
DIV8 = (E, DsdRate.DSD64, 352800)
DIV32 = (E, DsdRate.DSD64, 88200)
R96K = (E, DsdRate.DSD64, 96000)


def _jax(v):
    """A port enum as the JAX package's member of the same name."""
    return getattr(jtypes, type(v).__name__)[v.name] \
        if isinstance(v, enum.Enum) else v


def _jchain(key):
    return jget_chain(*map(_jax, key))


def _jcfg(cfg: StepConfig) -> JStepConfig:
    return JStepConfig(channels=cfg.channels, tile_bytes=cfg.tile_bytes,
                       bit_depth=cfg.bit_depth, dither=_jax(cfg.dither),
                       level_db=cfg.level_db)


def _mesh(n=4):
    return Mesh(np.array(jax.devices()[:n]), ("tile",))


def _reader(planes, first_short=True):
    """read(n) over (C, B) planes; the first read is short (a carry across
    a macro-chunk that was not filled in one read)."""
    pos = [0]

    def read(n):
        if pos[0] >= planes.shape[1]:
            return None
        take = n // 2 if (first_short and pos[0] == 0) else n
        b = planes[:, pos[0]:pos[0] + take]
        pos[0] += b.shape[1]
        return b

    return read


def _frames(wire: np.ndarray, bits: int, c: int = 2) -> np.ndarray:
    """Little-endian wire bytes -> (frames, C) float32 or int32 samples
    (20-bit shifted back down, as the JAX sink's samples are)."""
    if bits == 32:
        return wire.view("<f4").reshape(-1, c)
    return tengine.int_frames(wire, bits, c)


def _test_tile(key, target=4096) -> int:
    """A small tile: the engine's at `target` bytes (÷2^k), whole band
    blocks of the tail only (48k: 4 x 147 R_head bits), so a short
    stream spans several macro-chunks."""
    chain = get_chain(*key)
    if rational.rational_head_len(chain) is None:
        return tengine._tile_bytes_for(chain, target)
    return 4 * rational.rational_plan(chain).unit_bits // 8


# -- 1. the host helpers are the JAX package's ---------------------------------

@pytest.mark.parametrize("key", CHAINS,
                         ids=lambda k: f"{k[0].name}-{k[1].name}-{k[2]}")
def test_halo_helpers_equal_jax(key):
    chain, jchain = get_chain(*key), _jchain(key)
    assert sharded.chain_halo_bits(chain) == jsharded.chain_halo_bits(jchain)
    assert sharded.halo_bytes_for(chain) == jsharded.halo_bytes_for(jchain)


@pytest.mark.parametrize("n_tiles,tile,halo,total", [
    (4, 1024, 35, 3000), (3, 588, 2560, 1764), (2, 4096, 128, 9000)])
def test_split_overlap_save_equals_jax(n_tiles, tile, halo, total):
    planes = np.random.default_rng(total).integers(0, 256, (2, total),
                                                   dtype=np.uint8)
    got = sharded.split_overlap_save(planes, n_tiles, tile, halo)
    want = jsharded.split_overlap_save(planes, n_tiles, tile, halo)
    assert got.dtype == want.dtype and np.array_equal(got, want)


# -- 2. the chunked route against the port's own streaming step ----------------

EPILOGUES_2 = [(24, DitherType.TPDF), (16, DitherType.RECTANGULAR),
               (20, DitherType.NONE), (32, DitherType.NONE),
               (32, DitherType.FPD)]


@pytest.mark.parametrize("key", [DIV8, DIV32, R96K],
                         ids=["div8", "div32", "96k"])
@pytest.mark.parametrize("bits,dither", EPILOGUES_2,
                         ids=[f"{b}-{d.name}" for b, d in EPILOGUES_2])
def test_chunked_equals_streaming_step(key, bits, dither):
    """convert_stream_tiled_chunked over 4 CPU entries: every tile's wire
    bytes and peak equal to the streaming step's, at every dither; the
    stream ends inside the second macro-chunk, and max_bits inside its
    last byte; progress rises to 100."""
    chain = get_chain(*key)
    tile = _test_tile(key)
    cfg = StepConfig(channels=2, tile_bytes=tile, bit_depth=bits,
                     dither=dither, level_db=-1.0)
    total = 5 * tile + tile // 2
    planes = shardcheck.tone(key[1].hz, total)
    max_bits = total * 8 - 5
    ws, ps = shardcheck.streaming_tiles(planes, key, cfg, "cpu", seed=99,
                                        max_bits=max_bits)
    got, st, updates = [], {}, []
    peak = sharded.convert_stream_tiled_chunked(
        _reader(planes), chain, cfg, CPU4, lambda w: got.append(w.copy()),
        99, progress=updates.append, total_bytes=total, max_bits=max_bits,
        stats=st)
    assert st["tiles"] == len(ws) == 6
    assert len(got) == 6 and all(np.array_equal(a, b)
                                 for a, b in zip(got, ws))
    assert st["tile_peaks"] == ps and peak == max(ps)
    assert sum(w.size for w in got) == int(max_bits * chain_ratio(chain)) \
        * 2 * (4 if bits == 32 else 2 if bits == 16 else 3)
    pcts = [u.percent for u in updates]
    assert pcts == sorted(pcts) and pcts[-1] == 100.0 and len(pcts) == 2


def test_chunked_level_check_and_cancel():
    """write None (the level check): the peak alone, equal to the
    streaming peak; a cancel before the first chunk raises."""
    from dsd2dxd_tpu_torch.utils.errors import CancelledError

    key = DIV8
    chain = get_chain(*key)
    cfg = StepConfig(channels=2, tile_bytes=_test_tile(key), bit_depth=32,
                     dither=DitherType.NONE, level_db=0.0)
    planes = shardcheck.tone(key[1].hz, 7 * cfg.tile_bytes + 100)
    _ws, ps = shardcheck.streaming_tiles(planes, key, cfg, "cpu")
    assert sharded.convert_stream_tiled_chunked(
        _reader(planes), chain, cfg, CPU4, None) == max(ps)
    with pytest.raises(CancelledError):
        sharded.convert_stream_tiled_chunked(
            _reader(planes), chain, cfg, CPU4, None, cancel=lambda: True)


# -- 3. the chunked route against the JAX sharded functions --------------------

def _jax_chunked(planes, key, cfg):
    got = []
    peak = jsharded.convert_stream_tiled_chunked(
        _reader(planes, first_short=False), _jchain(key), _jcfg(cfg),
        _mesh(), lambda t: got.append(np.asarray(t).copy()))
    return np.concatenate(got), float(peak)


def _within_parity(got, want, bits, skip):
    n = min(len(got), len(want))
    assert len(got) == len(want)
    d = np.abs(got[skip:n].astype(np.float64)
               - want[skip:n].astype(np.float64)).max()
    assert d <= (2e-6 if bits == 32 else 5), d


@pytest.mark.parametrize("key", [DIV8, R96K], ids=["div8", "96k"])
@pytest.mark.parametrize("bits", [32, 24])
def test_chunked_within_parity_of_jax(key, bits):
    """The port on 4 CPU entries against the JAX chunked converter on a
    4-device CPU mesh (its phase body), NONE dither: f32 within 2e-6,
    24-bit within 5 LSB past the JAX path's priming, peak within 1e-4."""
    tile = _test_tile(key, 8192)
    cfg = StepConfig(channels=2, tile_bytes=tile, bit_depth=bits,
                     dither=DitherType.NONE, level_db=-1.0)
    planes = shardcheck.tone(key[1].hz, 6 * tile + 1000)
    got = []
    peak = sharded.convert_stream_tiled_chunked(
        _reader(planes), get_chain(*key), cfg, CPU4,
        lambda w: got.append(w.copy()))
    want, jpeak = _jax_chunked(planes, key, cfg)
    _within_parity(_frames(np.concatenate(got), bits), want, bits,
                   HEAD_SKIP * key[2] // 352800)
    assert abs(peak - jpeak) < 1e-4


# -- 4. one dispatch ------------------------------------------------------------

@pytest.mark.parametrize("key", [DIV8, R96K], ids=["div8", "96k"])
def test_convert_stream_tiled_within_parity_of_jax(key, small_tiles_48k):
    """convert_stream_tiled (one tile per entry) against the JAX
    one-dispatch converter, f32 NONE: the limits of test 3, the same
    length."""
    cfg = StepConfig(channels=2, tile_bytes=0, bit_depth=32,
                     dither=DitherType.NONE, level_db=-1.0)
    planes = shardcheck.tone(key[1].hz, 20000)
    wire, peak = sharded.convert_stream_tiled(planes, get_chain(*key), cfg,
                                              CPU4)
    want, jpeak = jsharded.convert_stream_tiled(planes, _jchain(key),
                                                _jcfg(cfg), _mesh())
    _within_parity(_frames(wire, 32), np.asarray(want), 32,
                   HEAD_SKIP * key[2] // 352800)
    assert abs(peak - jpeak) < 1e-4


@pytest.fixture
def small_tiles_48k(monkeypatch):
    """The engine's tile, but of whole band blocks only at 48k (the
    kernel's block unit would make one 294 KiB tile of a short stream)."""
    tile_bytes_for = tengine._tile_bytes_for

    def tile_bytes(chain, target):
        if rational.rational_head_len(chain) is None:
            return tile_bytes_for(chain, target)
        unit = rational.rational_plan(chain).unit_bits
        return -(-target * 8 // unit) * unit // 8

    monkeypatch.setattr(tengine, "_tile_bytes_for", tile_bytes)


# -- 5. make_sharded_convert ----------------------------------------------------

@pytest.mark.parametrize("key", [DIV8, R96K], ids=["div8", "96k"])
def test_make_sharded_convert_matches_jax(key):
    """The same random (B=2, T=2, C, halo + tile) tiles through the JAX
    2D-mesh converter and the port's over a 2 x 2 grid of CPU entries, f32
    NONE: equal shapes, samples within 2e-6, peak within 1e-4."""
    chain, jchain = get_chain(*key), _jchain(key)
    tile = (2048 if rational.rational_head_len(chain) is None
            else jsharded._chain_unit_bytes(jchain))
    cfg = StepConfig(channels=2, tile_bytes=tile, bit_depth=32,
                     dither=DitherType.NONE, level_db=0.0)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                ("stream", "tile"))
    jfn, jhalo = jsharded.make_sharded_convert(jchain, _jcfg(cfg), mesh)
    fn, halo = sharded.make_sharded_convert(chain, cfg, CPU4, 2, 2)
    assert halo == jhalo
    x = np.random.default_rng(5).integers(0, 256, (2, 2, 2, halo + tile),
                                          dtype=np.uint8)
    n_keep = int(tile * 8 * chain_ratio(chain))
    valids = np.full((2, 2), n_keep, dtype=np.int32)
    keys = jax.random.split(jax.random.PRNGKey(0), 4).reshape(2, 2, -1)
    want, jpeak = jfn(x, keys, valids)
    got, peak = fn(x, np.arange(4).reshape(2, 2), valids)
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape == (2, 2, n_keep, 2)
    assert np.abs(got.numpy() - want).max() <= 2e-6
    assert abs(peak - float(jpeak)) < 1e-4


def test_make_sharded_convert_refuses_a_bad_grid():
    chain = get_chain(*DIV8)
    cfg = StepConfig(channels=2, tile_bytes=2048, bit_depth=24,
                     dither=DitherType.TPDF, level_db=0.0)
    with pytest.raises(ValueError):
        sharded.make_sharded_convert(chain, cfg, CPU4, 3, 2)
    fn, halo = sharded.make_sharded_convert(chain, cfg, CPU4, 2, 2)
    with pytest.raises(ValueError):
        fn(np.zeros((3, 2, 2, halo + 2048), np.uint8), np.zeros((3, 2)),
           np.zeros((3, 2)))


# -- 6. the engine's route ------------------------------------------------------

@pytest.fixture
def shard_over_cpu(monkeypatch):
    """DSD2DXD_SHARD_STREAM=1, and stream_devices as on a 4-card machine
    but with CPU devices."""
    def four_cpus():
        return CPU4 if os.environ.get("DSD2DXD_SHARD_STREAM") == "1" else None

    tile_bytes_for = tengine._tile_bytes_for

    def tile_bytes(chain, target):
        # 16 KiB/ch, of whole band blocks only at 48k, so that a 48k
        # stream spans several tiles (and warm passes) too
        if rational.rational_head_len(chain) is None:
            return tile_bytes_for(chain, target)
        unit = rational.rational_plan(chain).unit_bits
        return -(-16 * 1024 * 8 // unit) * unit // 8

    monkeypatch.setattr(tengine, "stream_devices", four_cpus)
    monkeypatch.setattr(tengine, "_DEFAULT_TILE_TARGET", 16 * 1024)
    monkeypatch.setattr(tengine, "_tile_bytes_for", tile_bytes)
    return monkeypatch


def _engine_convert(src, out_dir, **kw):
    out_dir.mkdir(exist_ok=True)
    args = dict(bit_depth=24, output=OutputType.WAV, level_db=-1.0,
                output_rate=352800, out_dir=out_dir, dither=DitherType.TPDF,
                filt=E, append_rate=False, base_dir=src.parent,
                input_path=src, device="cpu")
    args.update(kw)
    conv = TConverter.from_container(**args)
    updates = []
    conv.do_conversion(progress=updates.append)
    assert updates[-1].percent == 100.0
    return conv


@pytest.mark.parametrize("kw", [
    dict(),
    dict(output=OutputType.AIFF, dither=DitherType.NONE),
    dict(bit_depth=20, dither=DitherType.NJAD, output=OutputType.FLAC,
         output_rate=88200),
], ids=["wav-tpdf", "aiff", "flac-njad-20bit"])
def test_engine_sharded_route_byte_equal(tone_dsd64_stereo_dsf, tmp_path,
                                         shard_over_cpu, kw):
    shard_over_cpu.delenv("DSD2DXD_SHARD_STREAM", raising=False)
    a = _engine_convert(tone_dsd64_stereo_dsf, tmp_path / "a", **kw)
    shard_over_cpu.setenv("DSD2DXD_SHARD_STREAM", "1")
    b = _engine_convert(tone_dsd64_stereo_dsf, tmp_path / "b", **kw)
    assert a.stats["devices"] == ["cpu"] and b.stats["devices"] == ["cpu"] * 4
    assert a.stats["tiles"] == b.stats["tiles"] > 4
    assert a.output_path().read_bytes() == b.output_path().read_bytes()


@pytest.mark.parametrize("rate", [352800, 96000])
def test_engine_sharded_level_check(tone_dsd64_stereo_dsf, shard_over_cpu,
                                    rate):
    """The sharded level check gives the streaming dBFS exactly, and the
    JAX engine's sharded level check (8-device CPU mesh) within 1e-4 dB."""
    def port():
        return TConverter.new_level_check(
            rate, tone_dsd64_stereo_dsf, FmtType.PLANAR,
            Endianness.MSB_FIRST, 2, 4096, DsdRate.DSD64,
            device="cpu").check_level()

    shard_over_cpu.delenv("DSD2DXD_SHARD_STREAM", raising=False)
    streaming = port()
    shard_over_cpu.setenv("DSD2DXD_SHARD_STREAM", "1")
    assert port() == streaming
    jdb = jengine.Converter.new_level_check(
        rate, tone_dsd64_stereo_dsf, jtypes.FmtType.PLANAR,
        jtypes.Endianness.MSB_FIRST, 2, 4096,
        jtypes.DsdRate.DSD64).check_level()
    assert abs(streaming - jdb) < 1e-4


# -- 7. the device lists ---------------------------------------------------------

def test_stream_devices_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.delenv("DSD2DXD_SHARD_STREAM", raising=False)
    assert tdevice.stream_devices() is None
    monkeypatch.setenv("DSD2DXD_SHARD_STREAM", "0")
    assert tdevice.stream_devices() is None
    monkeypatch.setenv("DSD2DXD_SHARD_STREAM", "1")
    assert tdevice.stream_devices() == [torch.device("cuda", 0),
                                        torch.device("cuda", 1)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tdevice.stream_devices() is None


def test_batch_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigError):
        tdevice.batch_devices()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert tdevice.batch_devices() == [torch.device("cuda", i)
                                       for i in range(3)]


# -- 8. the CLI's round-robin -----------------------------------------------------

def test_cli_round_robin(tone_dsd64_stereo_dsf, tmp_path, monkeypatch):
    """Three files over two devices: file i gets device i % 2, at least
    two workers though worker_count says one, the outputs byte-equal to
    a one-device run."""
    monkeypatch.setattr(tengine, "_DEFAULT_TILE_TARGET", 64 * 1024)
    src = tmp_path / "in"
    src.mkdir()
    data = tone_dsd64_stereo_dsf.read_bytes()
    files = [src / f"t{i}.dsf" for i in range(3)]
    for f in files:
        f.write_bytes(data)
    devs = [torch.device("cpu"), torch.device("cpu")]
    assert devs[0] is not devs[1]
    seen, workers = [], []
    convert_file = tcli.convert_file
    lock = threading.Lock()

    def recording(path, *a, device=None, **k):
        with lock:
            seen.append((Path(path).name, device))
        return convert_file(path, *a, device=device, **k)

    class Pool(tcli.ThreadPoolExecutor):
        def __init__(self, max_workers):
            workers.append(max_workers)
            super().__init__(max_workers=max_workers)

    monkeypatch.setattr(tcli, "convert_file", recording)
    monkeypatch.setattr(tcli, "batch_devices", lambda: devs)
    monkeypatch.setattr(tcli, "worker_count", lambda: 1)
    monkeypatch.setattr(tcli, "ThreadPoolExecutor", Pool)
    out_rr, out_one = tmp_path / "rr", tmp_path / "one"
    out_rr.mkdir()
    out_one.mkdir()
    argv = ["-o", "w", "-q", *map(str, files)]
    assert tcli.run(["-p", str(out_rr), *argv]) == 0
    assert workers == [2]
    assert sorted(seen, key=lambda s: s[0]) == [
        (f.name, devs[i % 2]) for i, f in enumerate(files)]
    assert all(d is devs[i % 2] for i, (_n, d) in enumerate(
        sorted(seen, key=lambda s: s[0])))
    seen.clear()
    assert tcli.run(["-p", str(out_one), *argv], device="cpu") == 0
    assert [d for _n, d in seen] == ["cpu"] * 3
    for f in files:
        a = out_rr / src.name / f"{f.stem}.wav"
        b = out_one / src.name / f"{f.stem}.wav"
        assert a.read_bytes() == b.read_bytes()


def test_shardcheck_entry_point_on_cpu(capsys):
    """tools/shardcheck.py through its entry point, plain versions on two
    CPU entries: every tile equal, exit 0, no times printed."""
    assert shardcheck.main(["--devices", "cpu,cpu", "--tile-kib", "16",
                            "--cells", "DSD64:352800,DSD64:96000"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and all("DIFFERS" not in ln and "ms" not in ln
                                 for ln in out)
