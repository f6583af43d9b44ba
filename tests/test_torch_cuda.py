"""Tests of the port that need an NVIDIA card (marker `cuda`); they skip
where CUDA is not available. This file imports nothing of jax or of the
JAX package, so on a machine without them it runs on its own:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q
"""

import numpy as np
import pytest
import torch

from dsd2dxd_tpu_torch import Converter
from dsd2dxd_tpu_torch.filters.design import get_chain
from dsd2dxd_tpu_torch.formats.dsd_types import (
    DitherType,
    DsdRate,
    FilterType,
    OutputType,
)
from dsd2dxd_tpu_torch.ops import fused, philox, rational
from dsd2dxd_tpu_torch.ops.resample import StepConfig
from dsd2dxd_tpu_torch.tools import dmabench, floorstrip

pytestmark = pytest.mark.cuda

CELLS = {
    "E": (FilterType.EQUIRIPPLE, DsdRate.DSD64, 352800),
    "X": (FilterType.XLD, DsdRate.DSD64, 352800),
    "D": (FilterType.DSD2PCM, DsdRate.DSD64, 352800),
    "E128": (FilterType.EQUIRIPPLE, DsdRate.DSD128, 705600),
}
# one chain per class beyond ÷8
DEEP = {
    "div16": (FilterType.EQUIRIPPLE, DsdRate.DSD64, 176400),
    "div32": (FilterType.EQUIRIPPLE, DsdRate.DSD64, 88200),
    "div64": (FilterType.EQUIRIPPLE, DsdRate.DSD128, 88200),
    "div128": (FilterType.EQUIRIPPLE, DsdRate.DSD256, 88200),
}
EPILOGUES = [(bits, dither) for bits in (16, 20, 24)
             for dither in (DitherType.NONE, DitherType.TPDF,
                            DitherType.RECTANGULAR)] + [
    (32, DitherType.NONE), (32, DitherType.FPD)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _decode(wire: torch.Tensor, bit_depth: int = 24) -> np.ndarray:
    """Little-endian wire bytes -> int64 samples (16/20/24 bit, 20-bit
    shifted back down) or float64 (32-bit float)."""
    b = wire.cpu().numpy()
    if bit_depth == 32:
        return b.view("<f4").astype(np.float64)
    if bit_depth == 16:
        return b.view("<i2").astype(np.int64)
    b = b.reshape(-1, 3).astype(np.int64)
    v = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
    v = np.where(v >= 1 << 23, v - (1 << 24), v)
    return v >> 4 if bit_depth == 20 else v


def _ragged(chain, tile):
    """`tile` cut down to whole output frames of the chain."""
    fb = fused.decimation(chain) // 8
    return tile // fb * fb


def _check_against_plain(dev, chain, tile, epilogues, seed=12, channels=2):
    """Kernel against its plain version on the same card inputs, two
    streamed tiles per epilogue: NONE within 5 LSB, TPDF/RECT with the
    same key within 1 LSB, f32 NONE and FPD bit-equal, peak within 1e-4,
    the launch counted."""
    rng = np.random.default_rng(seed)
    taps = [torch.tensor(np.asarray(s.taps, dtype=np.float32), device=dev)
            for s in chain]
    for bits, dither in epilogues:
        cfg = StepConfig(channels=channels, tile_bytes=tile, bit_depth=bits,
                         dither=dither, level_db=-1.5)
        step = fused.make_fused_step(chain, cfg, dev)
        h = fused.init_fused_halo(chain, channels, dev)
        for t in range(2):
            x = torch.from_numpy(rng.integers(0, 256, (channels, tile),
                                              dtype=np.uint8)).to(dev)
            key = philox.tile_key(99, t)
            before = fused.KERNEL_LAUNCHES
            wk, pk, hk = step(x, h, key)
            assert fused.KERNEL_LAUNCHES == before + 1
            wr, pr, hr = fused.fused_decim_reference(x, h, key, taps, chain,
                                                     cfg)
            torch.cuda.synchronize()
            if bits == 32:
                assert torch.equal(wk, wr), (bits, dither)
            else:
                d = np.abs(_decode(wk, bits) - _decode(wr, bits))
                assert d.max() <= (5 if dither is DitherType.NONE else 1)
            assert abs(float(pk) - float(pr)) <= 1e-4
            assert torch.equal(hk, hr)
            h = hk


@pytest.mark.parametrize("cell", list(CELLS))
@pytest.mark.parametrize("tile", [1 << 20, 3000])  # 3000: ragged last block
def test_kernel_matches_plain_on_card(cuda_device, cell, tile):
    """K1a against its plain version: 24-bit NONE and TPDF."""
    _check_against_plain(cuda_device, get_chain(*CELLS[cell]), tile,
                         [(24, DitherType.NONE), (24, DitherType.TPDF)])


@pytest.mark.parametrize("cell", list(DEEP))
@pytest.mark.parametrize("tile", [1 << 20, 3000])
def test_every_epilogue_matches_plain_on_card(cuda_device, cell, tile):
    """K1b/K1c/K1d: one chain per class x every epilogue."""
    chain = get_chain(*DEEP[cell])
    _check_against_plain(cuda_device, chain, _ragged(chain, tile), EPILOGUES)


@pytest.mark.parametrize("cell", ["E", "div64"])
@pytest.mark.parametrize("channels", [1, 3, 6])
def test_kernel_channel_counts_on_card(cuda_device, cell, channels):
    """K1 at 1, 3 and 6 channels (the channel is the grid's y) on the ÷8
    and the ÷64 chain: 24-bit NONE and TPDF, f32 FPD, against its plain
    version, the last block ragged."""
    chain = get_chain(*{**CELLS, **DEEP}[cell])
    _check_against_plain(cuda_device, chain, _ragged(chain, (1 << 18) + 3000),
                         [(24, DitherType.NONE), (24, DitherType.TPDF),
                          (32, DitherType.FPD)], channels=channels)


@pytest.mark.parametrize("cell,block_out", [
    ("E", 37), ("D", 45), ("D", 512), ("div16", 101), ("div32", 63),
    ("div64", 129), ("div64", 200), ("div128", 77)])
def test_kernel_at_odd_block_out_bit_equal_on_card(cuda_device, cell,
                                                   block_out):
    """K1 at a block_out of its own (ragged blocks; D: the single ÷8
    stage of 96 taps, stage 0's table route straight into the epilogue)
    against its plain version at f32 NONE, bit-equal, two streamed
    tiles, one ragged in its last block."""
    chain = get_chain(*{**CELLS, **DEEP}[cell])
    fb = fused.decimation(chain) // 8
    tile = block_out * fb * 7 // 2 // fb * fb
    cfg = StepConfig(channels=2, tile_bytes=tile, bit_depth=32,
                     dither=DitherType.NONE, level_db=-1.5)
    taps = [torch.tensor(np.asarray(s.taps, dtype=np.float32),
                         device=cuda_device) for s in chain]
    coefs = fused.kernel_coefs(chain, cuda_device)
    rng = np.random.default_rng(37)
    h = fused.init_fused_halo(chain, 2, cuda_device)
    for _ in range(2):
        x = torch.from_numpy(rng.integers(0, 256, (2, tile),
                                          dtype=np.uint8)).to(cuda_device)
        wk, pk, hk = fused.fused_decim_cuda(x, h, 3, coefs, chain, cfg,
                                            block_out=block_out)
        wr, pr, _hr = fused.fused_decim_reference(x, h, 3, taps, chain, cfg)
        torch.cuda.synchronize()
        assert torch.equal(wk, wr)
        assert float(pk) == float(pr)
        h = hk


@pytest.mark.parametrize("scale", [0.0, 0.5])
def test_kernel_generic_tap_counts_on_card(cuda_device, scale):
    """synth_chain(0.5) has tap counts (8, 8, 10, 8, 8, 28) outside the
    kernel's compiled cases, so its stages take the generic loops; (0.0)
    the 2-tap case. Bit-equal to the plain cascade at gain 1 (K1e's
    planar mode)."""
    from dsd2dxd_tpu_torch.tools import synth_chain

    chain = synth_chain(scale)
    taps = [torch.tensor(np.asarray(s.taps, dtype=np.float32),
                         device=cuda_device) for s in chain]
    coefs = fused.kernel_coefs(chain, cuda_device)
    rng = np.random.default_rng(38)
    x = torch.from_numpy(rng.integers(0, 256, (2, 8 * 1000),
                                      dtype=np.uint8)).to(cuda_device)
    h = torch.from_numpy(rng.integers(
        0, 256, (2, fused.chain_halo_bytes(chain)),
        dtype=np.uint8)).to(cuda_device)
    yk = fused.fused_head_cuda(x, h, coefs, chain)
    yr = fused.fused_decim_cascade(x, h, taps, chain, 1.0)
    torch.cuda.synchronize()
    assert torch.equal(yk, yr)


def test_kernel_occupancy_on_card(cuda_device):
    """K1 at ÷64 and ÷128 keeps at least 24 warps resident per SM, with
    no local memory (no spills, no stack)."""
    for cell in ("div64", "div128"):
        occ = fused.kernel_occupancy(get_chain(*DEEP[cell]))
        assert occ["warps_per_sm"] >= 24, (cell, occ)
        assert occ["local_bytes"] == 0, (cell, occ)


def test_mode_counts_on_card(cuda_device):
    chain = get_chain(*DEEP["div64"])
    cfg = StepConfig(channels=2, tile_bytes=8192, bit_depth=20,
                     dither=DitherType.TPDF, level_db=0.0)
    step = fused.make_fused_step(chain, cfg, cuda_device)
    x = torch.full((2, 8192), 0x69, dtype=torch.uint8, device=cuda_device)
    before = dict(fused.MODE_LAUNCHES)
    step(x, fused.init_fused_halo(chain, 2, cuda_device), 1)
    after = fused.MODE_LAUNCHES
    assert {k: after[k] - before[k] for k in after} == {
        "K1a": 0, "K1b": 0, "K1c": 1, "K1d": 1, "K1e": 0, "K2": 0, "K2t": 0}
    chain = get_chain(FilterType.EQUIRIPPLE, DsdRate.DSD64, 384000)
    rp = rational.rational_plan(chain)
    cfg = StepConfig(channels=2, tile_bytes=rp.unit_bits // 8 * 8,
                     bit_depth=24, dither=DitherType.TPDF, level_db=0.0)
    x = torch.full((2, cfg.tile_bytes), 0x69, dtype=torch.uint8,
                   device=cuda_device)
    before = dict(fused.MODE_LAUNCHES)
    wire, _p, _s = rational.make_rational_step(chain, cfg, cuda_device)(
        x, rational.init_rational_state(chain, 2, cuda_device), 1)
    z = torch.zeros(2, 1000, device=cuda_device)
    fused.finish_cuda(z, 1.0, 1, cfg)
    assert wire.numel() == 8 * 160 * 2 * 3
    assert {k: after[k] - before[k] for k in after} == {
        "K1a": 0, "K1b": 0, "K1c": 0, "K1d": 0, "K1e": 1, "K2": 1, "K2t": 1}


@pytest.mark.parametrize("cell", ["E", "div16", "div128"])
def test_partial_tile_peak_masked_on_card(cuda_device, cell):
    """A full-scale burst that ends mid-tile, shorter than the filter's
    delay, then the idle pad: the kernel's peak covers the first n_valid
    frames only, as the plain version's, and the pad's frames ring far
    higher."""
    chain = get_chain(*{**CELLS, **DEEP}[cell])
    fb = fused.decimation(chain) // 8
    tile = 512 * fb * 4
    n_valid = 512 * 3 - 100
    x = np.full((2, tile), fused.IDLE_BYTE, dtype=np.uint8)
    x[:, (n_valid - 8) * fb:n_valid * fb] = 0xFF
    x = torch.from_numpy(x).to(cuda_device)
    taps = [torch.tensor(np.asarray(s.taps, dtype=np.float32),
                         device=cuda_device) for s in chain]
    cfg = StepConfig(channels=2, tile_bytes=tile, bit_depth=24,
                     dither=DitherType.TPDF, level_db=0.0)
    step = fused.make_fused_step(chain, cfg, cuda_device)
    h = fused.init_fused_halo(chain, 2, cuda_device)
    _w, pk, _h = step(x, h, 3, n_valid)
    y = fused.fused_decim_cascade(x, h, taps, chain, 1.0)
    torch.cuda.synchronize()
    assert abs(float(pk) - float(y[:, :n_valid].abs().max())) <= 1e-6
    assert float(y.abs().max()) > float(pk) + 0.5


@pytest.mark.parametrize("bits", [16, 20, 24, 32])
def test_big_endian_bytes_on_card(cuda_device, bits):
    chain = get_chain(*DEEP["div16"] if bits != 24 else CELLS["E"])
    dither = DitherType.FPD if bits == 32 else DitherType.TPDF
    cfg = StepConfig(channels=2, tile_bytes=8192, bit_depth=bits,
                     dither=dither, level_db=0.0)
    le = fused.make_fused_step(chain, cfg, cuda_device)
    be = fused.make_fused_step(chain, cfg, cuda_device, big_endian=True)
    x = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (2, 8192), dtype=np.uint8)).to(cuda_device)
    h = fused.init_fused_halo(chain, 2, cuda_device)
    bps = {16: 2, 20: 3, 24: 3, 32: 4}[bits]
    a = le(x, h, 5)[0].reshape(-1, bps)
    b = be(x, h, 5)[0].reshape(-1, bps)
    assert torch.equal(a, b.flip(1))


def _engine_equal(cuda_device, tmp_path, monkeypatch, rate, output_rate,
                  bit_depth, dither, output=OutputType.WAV):
    """The streamed CUDA pipeline (pinned buffers, copy and compute
    streams, drain thread) writes the same file as the CPU loop."""
    import dsd2dxd_tpu_torch.pipeline.engine as engine
    from dsd2dxd_tpu_torch.formats.dsf import write_dsf

    monkeypatch.setattr(engine, "_DEFAULT_TILE_TARGET", 32 * 1024)
    src = tmp_path / "noise.dsf"
    planes = np.random.default_rng(34).integers(
        0, 256, (2, rate.hz // 16), dtype=np.uint8)  # 0.5 s
    write_dsf(src, planes, rate.hz, lsb_first=True)
    outs = {}
    for dev in ("cpu", cuda_device):
        d = tmp_path / str(dev).replace(":", "")
        d.mkdir()
        conv = Converter.from_container(
            bit_depth=bit_depth, output=output, level_db=-1.0,
            output_rate=output_rate, out_dir=d, dither=dither,
            filt=FilterType.EQUIRIPPLE, append_rate=False, base_dir=tmp_path,
            input_path=src, device=dev)
        before = fused.KERNEL_LAUNCHES
        conv.do_conversion()
        launched = fused.KERNEL_LAUNCHES - before
        assert launched == (conv.stats["tiles"] if dev != "cpu" else 0)
        outs[str(dev)] = conv.output_path().read_bytes()
    return outs.values()


def test_engine_on_card_equals_cpu(cuda_device, tmp_path, monkeypatch):
    a, b = _engine_equal(cuda_device, tmp_path, monkeypatch, DsdRate.DSD64,
                         352800, 24, DitherType.TPDF)
    assert len(a) == len(b)
    head = 44
    da = _decode(torch.frombuffer(bytearray(a[head:]), dtype=torch.uint8))
    db = _decode(torch.frombuffer(bytearray(b[head:]), dtype=torch.uint8))
    assert a[:head] == b[:head]
    assert np.abs(da - db).max() <= 1


def test_engine_on_card_equals_cpu_deep_20bit(cuda_device, tmp_path,
                                              monkeypatch):
    a, b = _engine_equal(cuda_device, tmp_path, monkeypatch, DsdRate.DSD128,
                         88200, 20, DitherType.TPDF)
    assert len(a) == len(b)
    head = 44
    da = _decode(torch.frombuffer(bytearray(a[head:]), dtype=torch.uint8), 20)
    db = _decode(torch.frombuffer(bytearray(b[head:]), dtype=torch.uint8), 20)
    assert a[:head] == b[:head]
    assert np.abs(da - db).max() <= 1


# -- the 48k family: K1e (planar f32 head), K2 (finish) in its two modes ------

CHAINS_48K = [(FilterType.EQUIRIPPLE, rate, out)
              for rate in (DsdRate.DSD64, DsdRate.DSD128, DsdRate.DSD256)
              for out in (96000, 192000, 384000)]


@pytest.mark.parametrize("key", CHAINS_48K,
                         ids=lambda k: f"{k[1].name}-{k[2] // 1000}k")
def test_head_kernel_bit_equal_on_card(cuda_device, key):
    """K1e against fused_decim_cascade(gain=1), two streamed tiles, one
    ragged in its last block: bit-equal; one K1e launch each."""
    _check_head(cuda_device, key, 2)


@pytest.mark.parametrize("channels", [1, 3, 6])
def test_head_kernel_channel_counts_on_card(cuda_device, channels):
    """K1e at 1, 3 and 6 channels on DSD64 -> 192k's ÷16 head."""
    _check_head(cuda_device, CHAINS_48K[1], channels)


def _check_head(cuda_device, key, channels):
    chain = get_chain(*key)
    rp = rational.rational_plan(chain)
    head = chain[:rp.n_head]
    taps = [torch.tensor(np.asarray(s.taps, dtype=np.float32),
                         device=cuda_device) for s in head]
    coefs = fused.kernel_coefs(head, cuda_device)
    tile = rp.unit_bits // 8 * 3
    rng = np.random.default_rng(31)
    h = fused.init_fused_halo(head, channels, cuda_device)
    for _ in range(2):
        x = torch.from_numpy(rng.integers(0, 256, (channels, tile),
                                          dtype=np.uint8)).to(cuda_device)
        before = fused.MODE_LAUNCHES["K1e"]
        yk = fused.fused_head_cuda(x, h, coefs, head)
        assert fused.MODE_LAUNCHES["K1e"] == before + 1
        yr = fused.fused_decim_cascade(x, h, taps, head, 1.0)
        torch.cuda.synchronize()
        assert torch.equal(yk, yr)
        h = x[:, tile - h.shape[1]:].contiguous()


@pytest.mark.parametrize("bits,dither", [
    (b, d) for b in (16, 20, 24)
    for d in (DitherType.NONE, DitherType.TPDF, DitherType.RECTANGULAR)]
    + [(32, DitherType.NONE), (32, DitherType.FPD)])
@pytest.mark.parametrize("big_endian", [False, True], ids=["LE", "BE"])
def test_finish_kernel_matches_plain_on_card(cuda_device, bits, dither,
                                             big_endian):
    """K2 against finish_reference on the same f32 samples (some beyond
    full scale): integer NONE within 5 LSB, dithered within 1 LSB, f32
    NONE bit-equal, FPD within 1 ulp of the plain result; the peak of the
    first n_valid frames equal."""
    z = torch.from_numpy(np.random.default_rng(32).uniform(
        -1.2, 1.2, (2, 100003)).astype(np.float32)).to(cuda_device)
    cfg = StepConfig(channels=2, tile_bytes=8, bit_depth=bits, dither=dither,
                     level_db=-1.5)
    gain = fused._gain32(cfg)
    key = philox.tile_key(5, 2)
    before = fused.MODE_LAUNCHES["K2"]
    wk, pk = fused.finish_cuda(z, gain, key, cfg, big_endian, 90000)
    assert fused.MODE_LAUNCHES["K2"] == before + 1
    wr, pr = fused.finish_reference(z, gain, key, cfg, big_endian, 90000)
    torch.cuda.synchronize()
    assert float(pk) == float(pr)
    if big_endian:
        bps = {16: 2, 20: 3, 24: 3, 32: 4}[bits]
        wk, wr = (w.reshape(-1, bps).flip(1).reshape(-1) for w in (wk, wr))
    if bits == 32 and dither is DitherType.NONE:
        assert torch.equal(wk, wr)
        return
    a, b = _decode(wk, bits), _decode(wr, bits)
    if bits == 32:
        ulp = np.spacing(np.abs(b).astype(np.float32)).astype(np.float64)
        assert np.all(np.abs(a - b) <= ulp)
    else:
        assert np.abs(a - b).max() <= (5 if dither is DitherType.NONE else 1)


@pytest.mark.parametrize("channels,n", [(1, 70001), (3, 2 * 1024 + 513), (6, 2 * 512 + 1),
                                        (13, 256 * 2 + 5)])
def test_finish_kernel_channel_counts_on_card(cuda_device, channels, n):
    """K2 "from z" at other channel counts (13: runs of 256 frames, so
    that two staged runs fit shared memory) and odd lengths: bit-equal to
    finish_reference at 24-bit TPDF and f32 FPD in both byte orders, peak
    equal."""
    z = torch.from_numpy(np.random.default_rng(39).uniform(
        -1.2, 1.2, (channels, n)).astype(np.float32)).to(cuda_device)
    for bits, dither in ((24, DitherType.TPDF), (32, DitherType.FPD)):
        cfg = StepConfig(channels=channels, tile_bytes=8, bit_depth=bits,
                         dither=dither, level_db=-1.5)
        gain = fused._gain32(cfg)
        for be in (False, True):
            wk, pk = fused.finish_cuda(z, gain, 11, cfg, be, n - 7)
            wr, pr = fused.finish_reference(z, gain, 11, cfg, be, n - 7)
            torch.cuda.synchronize()
            assert torch.equal(wk, wr), (bits, be)
            assert float(pk) == float(pr)


def _tail_against_plain(dev, rp, channels, blocks, cfg, big_endian, seed):
    """K2 "from the head's samples" against rational_tail_reference then
    finish_reference on two streamed tiles, the first with a non-zero
    history, n_valid inside a run: wire bytes and peak equal; one K2t
    launch each."""
    table = rational.kernel_table(rp, dev)
    gain = fused._gain32(cfg)
    rng = np.random.default_rng(seed)
    hist = torch.from_numpy(rng.uniform(-1, 1, (channels, 147)).astype(
        np.float32)).to(dev)
    n_valid = 160 * blocks - 250
    for t in range(2):
        y = rng.uniform(-1.1, 1.1, (channels, 147 * blocks)).astype(
            np.float32)
        y[:, -147:] *= 3.0  # the loudest frames lie past n_valid
        y = torch.from_numpy(y).to(dev)
        key = philox.tile_key(46, t)
        before = dict(fused.MODE_LAUNCHES)
        wk, pk = rational.finish_tail_cuda(y, hist, table, rp, gain, key, cfg,
                                           big_endian, n_valid)
        assert fused.MODE_LAUNCHES["K2t"] == before["K2t"] + 1
        assert fused.MODE_LAUNCHES["K2"] == before["K2"]
        z, hist = rational.rational_tail_reference(y, hist, rp)
        wr, pr = fused.finish_reference(z, gain, key, cfg, big_endian,
                                        n_valid)
        torch.cuda.synchronize()
        assert torch.equal(wk, wr)
        assert float(pk) == float(pr)
        if t == 0:
            assert float(pr) < float((z * gain).abs().max())


@pytest.mark.parametrize("bits,dither", EPILOGUES)
@pytest.mark.parametrize("big_endian", [False, True], ids=["LE", "BE"])
def test_finish_tail_kernel_matches_plain_on_card(cuda_device, bits, dither,
                                                  big_endian):
    """The fused mode on the three tails (T = 19, 18, 16), stereo, 203
    band blocks (a ragged last run of 3): bit-equal to its plain version
    at every epilogue, dithered ones included (the same sums in the same
    order, the same Philox counter and key)."""
    for out in (96000, 192000, 384000):
        rp = rational.rational_plan(get_chain(FilterType.EQUIRIPPLE,
                                              DsdRate.DSD64, out))
        cfg = StepConfig(channels=2, tile_bytes=8, bit_depth=bits,
                         dither=dither, level_db=-1.5)
        _tail_against_plain(cuda_device, rp, 2, 203, cfg, big_endian, out)


@pytest.mark.parametrize("channels,blocks", [(1, 9), (1, 1), (3, 14), (6, 5)])
def test_finish_tail_kernel_channel_counts_on_card(cuda_device, channels,
                                                   blocks):
    """The fused mode at other channel counts (mono runs half a block of
    threads; 3 and 6 loop over their items; odd row lengths leave y's
    rows off 16-byte boundaries), 24-bit TPDF and f32 FPD."""
    rp = rational.rational_plan(get_chain(FilterType.EQUIRIPPLE,
                                          DsdRate.DSD128, 192000))
    for bits, dither in ((24, DitherType.TPDF), (32, DitherType.FPD)):
        cfg = StepConfig(channels=channels, tile_bytes=8, bit_depth=bits,
                         dither=dither, level_db=-1.5)
        _tail_against_plain(cuda_device, rp, channels, blocks, cfg, False, 47)


def test_rational_step_on_card_equals_plain(cuda_device):
    """The whole step (K1e, then K2 "from the head's samples") against
    its plain path on the card, three streamed tiles, 24-bit TPDF: wire
    bytes and peak equal, the same state."""
    chain = get_chain(FilterType.EQUIRIPPLE, DsdRate.DSD64, 192000)
    rp = rational.rational_plan(chain)
    tile = rp.unit_bits // 8 * 4
    cfg = StepConfig(channels=2, tile_bytes=tile, bit_depth=24,
                     dither=DitherType.TPDF, level_db=-1.5)
    step = rational.make_rational_step(chain, cfg, cuda_device)
    head = chain[:rp.n_head]
    taps = [torch.tensor(np.asarray(s.taps, dtype=np.float32),
                         device=cuda_device) for s in head]
    state = rational.init_rational_state(chain, 2, cuda_device)
    rng = np.random.default_rng(33)
    for t in range(3):
        x = torch.from_numpy(rng.integers(0, 256, (2, tile),
                                          dtype=np.uint8)).to(cuda_device)
        key = philox.tile_key(1, t)
        wk, pk, new = step(x, state, key)
        y = fused.fused_decim_cascade(x, state[0], taps, head, 1.0)
        z, hist = rational.rational_tail_reference(y, state[1], rp)
        wr, pr = fused.finish_reference(z, fused._gain32(cfg), key, cfg)
        torch.cuda.synchronize()
        assert torch.equal(wk, wr)
        assert float(pk) == float(pr)
        assert torch.equal(new[1], hist)
        state = new


@pytest.mark.parametrize("rate,out,bits,dither,output", [
    (DsdRate.DSD64, 96000, 24, DitherType.TPDF, OutputType.WAV),
    (DsdRate.DSD256, 192000, 32, DitherType.FPD, OutputType.AIFC),
], ids=["96k-24bit", "config4-192k-f32"])
def test_engine_48k_on_card_equals_cpu(cuda_device, tmp_path, monkeypatch,
                                       rate, out, bits, dither, output):
    """The card and the CPU sum every tap in the same order (K1e and its
    cascade, K2's band sums and rational_tail_reference) and draw the
    same Philox noise, so the two files are equal byte for byte, 24-bit
    TPDF and f32 FPD alike."""
    a, b = _engine_equal(cuda_device, tmp_path, monkeypatch, rate, out,
                         bits, dither, output)
    assert a == b


# -- the float-output consumers: NJAD, FLAC, the level check -----------------

@pytest.mark.parametrize("rate,out,bits,dither,output", [
    (DsdRate.DSD128, 88200, 20, DitherType.NJAD, OutputType.FLAC),
    (DsdRate.DSD64, 352800, 16, DitherType.NJAD, OutputType.AIFF),
    (DsdRate.DSD64, 96000, 24, DitherType.TPDF, OutputType.FLAC),
], ids=["config3-njad-flac", "njad-aiff", "96k-flac"])
def test_engine_njad_flac_on_card_equals_cpu(cuda_device, tmp_path,
                                             monkeypatch, rate, out, bits,
                                             dither, output):
    """NJAD requantizes K1's f32 output, which the card computes bit-equal
    to the CPU, and a 48k FLAC takes the card's and the CPU's equal wire
    words: the files are equal byte for byte."""
    a, b = _engine_equal(cuda_device, tmp_path, monkeypatch, rate, out,
                         bits, dither, output)
    assert a == b


@pytest.mark.parametrize("out", [352800, 96000])
def test_level_check_on_card_equals_cpu(cuda_device, tmp_path, monkeypatch,
                                        out):
    """The level check on the card (only the peaks come back) gives the
    CPU's dBFS exactly."""
    import dsd2dxd_tpu_torch.pipeline.engine as engine
    from dsd2dxd_tpu_torch.formats.dsd_types import Endianness, FmtType
    from dsd2dxd_tpu_torch.formats.dsf import write_dsf

    monkeypatch.setattr(engine, "_DEFAULT_TILE_TARGET", 32 * 1024)
    src = tmp_path / "noise.dsf"
    write_dsf(src, np.random.default_rng(35).integers(
        0, 256, (2, 2_822_400 // 16), dtype=np.uint8), 2_822_400)
    dbs = []
    for dev in ("cpu", cuda_device):
        conv = Converter.new_level_check(out, src, FmtType.PLANAR,
                                         Endianness.MSB_FIRST, 2, 4096,
                                         DsdRate.DSD64, device=dev)
        dbs.append(conv.check_level())
        # several tiles at 352.8k; the 48k tile is whole band blocks
        assert conv.stats["tiles"] >= (2 if out == 352800 else 1)
    assert dbs[0] == dbs[1] and np.isfinite(dbs[0])


# -- the floor probes: P1 (dmabench) and P2 (floorstrip) ---------------------

@pytest.mark.parametrize("block,halo", dmabench.k1_blocks())
def test_dma_probe_matches_plain_on_card(cuda_device, block, halo):
    """Every P1 mode against its plain version, exact (noflush: the last
    block's values); one launch each."""
    g = dmabench.geometry(block, halo)
    n = 37
    x = torch.from_numpy(np.random.default_rng(35).integers(
        0, 2 ** 32, (2, g.halo_words + n * g.block_words),
        dtype=np.uint32).view(np.int32)).to(cuda_device)
    xr = dmabench.relayout(x, g, n)
    for mode in dmabench.KERNEL_MODES:
        src = xr if mode in ("contig", "bspec") else x
        before = dmabench.LAUNCHES[mode]
        k = dmabench.dma_probe(src, mode, g, 2, n)
        assert dmabench.LAUNCHES[mode] == before + 1
        r = dmabench.dma_probe_reference(src, mode, g, 2, n)
        torch.cuda.synchronize()
        assert k.shape == r.shape and torch.equal(k, r), mode


@pytest.mark.parametrize("block_out", [None, 100])
@pytest.mark.parametrize("chain_name", list(floorstrip.CHAINS))
def test_probe_step_matches_plain_on_card(cuda_device, chain_name,
                                          block_out):
    """Every P2 rung kernel against its plain version on a ragged tile
    with a random halo, on both ladders' chains: dma, unpack, cas0a, cas0
    and quant NONE bit-equal (peaks too), quant TPDF within 1 LSB and
    >= 99.9 % identical; one launch each."""
    chain, cfg, bo = floorstrip.probe_config(0, block_out, chain_name)
    fb = fused.decimation(chain) // 8
    tile = cfg.tile_bytes * 7 // 2 // fb * fb
    rng = np.random.default_rng(36)
    x = torch.from_numpy(rng.integers(0, 256, (2, tile),
                                      dtype=np.uint8)).to(cuda_device)
    halo = torch.from_numpy(rng.integers(
        0, 256, (2, fused.chain_halo_bytes(chain)),
        dtype=np.uint8)).to(cuda_device)
    taps = [torch.tensor(np.asarray(s.taps, dtype=np.float32),
                         device=cuda_device) for s in chain]
    key = philox.tile_key(3, 1)
    n_valid = tile // fb - 9
    for rung in floorstrip.KERNEL_RUNGS:
        for dither in floorstrip.QUANT_DITHERS:
            if rung != "quant" and dither is not DitherType.TPDF:
                continue
            c = StepConfig(channels=2, tile_bytes=tile, bit_depth=24,
                           dither=dither, level_db=0.0)
            name = floorstrip.kernel_name(rung, dither)
            before = floorstrip.LAUNCHES[name]
            ko, kp = floorstrip.make_probe_step(chain, c, rung, cuda_device,
                                                bo)(x, halo, key, n_valid)
            assert floorstrip.LAUNCHES[name] == before + 1
            ro, rp = floorstrip.probe_step_reference(x, halo, taps, chain,
                                                     c, rung, bo, key,
                                                     n_valid)
            torch.cuda.synchronize()
            if name == "quant TPDF":
                d = (ko.long() - ro.long()).abs()
                assert int(d.max()) <= 1
                assert float((d == 0).double().mean()) >= 0.999
            else:
                assert torch.equal(ko, ro), name
            assert (kp is None) == (rp is None), name
            if kp is not None:
                assert float(kp) == float(rp), name


def test_k1_ptxas_line_held(cuda_device):
    """K1's registers, spill bytes and stack bytes in the build log
    (kept beside the library) are those chip_smoke.py requires, and the
    log holds P1's 6 and P2's 6 probe kernels."""
    import sys
    from pathlib import Path

    from dsd2dxd_tpu_torch import kernels

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    kernels.load()
    entries = chip_smoke.ptxas_entries(kernels.BUILD_LOG)
    k1 = [e[1:] for e in entries if e[0] == "fused_decim_kernel<>"]
    assert k1 == [chip_smoke.K1_PTXAS]
    assert len([e for e in entries
                if e[0].startswith("probe_step_kernel")]) == 6
    assert len([e for e in entries
                if e[0].startswith("dma_probe_kernel")]) == 6


# -- several devices: the sharded route, the device check ----------------------

@pytest.mark.parametrize("out_hz", [352800, 96000], ids=["div8", "96k"])
def test_sharded_on_one_card_twice_equals_streaming(cuda_device, out_hz):
    """parallel/sharded over [cuda:0, cuda:0] (two staging rings on one
    card): every tile's wire bytes and peak equal to the streaming step's
    at 24-bit TPDF and f32 FPD; one K1 (K1e + K2t) launch per tile, and
    one K1e warm launch per 48k tile after the first, in each of
    check_cell's passes: one per epilogue and one more at 24-bit TPDF that
    times both routes."""
    from dsd2dxd_tpu_torch.tools import shardcheck

    devs = [cuda_device, cuda_device]
    chain = get_chain(FilterType.EQUIRIPPLE, DsdRate.DSD64, out_hz)
    fused.reset_launch_counts()
    res = shardcheck.check_cell(DsdRate.DSD64, out_hz, devs, 2, 256)
    assert res["equal"], res
    n = res["tiles"]
    passes = len(shardcheck.EPILOGUES) + 1
    if rational.rational_head_len(chain) is None:
        assert fused.KERNEL_LAUNCHES == passes * 2 * n  # 2 routes: 6n
    else:
        assert fused.MODE_LAUNCHES["K2t"] == passes * 2 * n
        assert fused.MODE_LAUNCHES["K1e"] == passes * (2 * n + n - 1)


# -- the driver entry points: entry.py, tools/bench.py --------------------------

def test_entry_step_on_card_against_plain(cuda_device):
    """entry()'s flagship step on the card (K1a) against entry("cpu")'s
    plain step on the same bytes and key: within 1 LSB, >= 99.9 %
    identical, peak within 1e-4, one K1a launch."""
    from dsd2dxd_tpu_torch.entry import entry

    step, (x, halo, key) = entry()
    assert x.device == cuda_device
    fused.reset_launch_counts()
    wire, peak, _ = step(x, halo, key)
    assert fused.MODE_LAUNCHES["K1a"] == fused.KERNEL_LAUNCHES == 1
    pstep, (px, phalo, pkey) = entry(device="cpu")
    pwire, ppeak, _ = pstep(px, phalo, pkey)
    d = _decode(wire) - _decode(pwire)
    assert np.abs(d).max() <= 1
    assert float((d == 0).mean()) >= 0.999
    assert abs(float(peak) - float(ppeak)) < 1e-4


def test_dryrun_multichip_on_one_card(cuda_device, capsys):
    """dryrun_multichip(4) over cuda:0 x 4 (one card): its checks hold,
    and its tiles launched the kernels."""
    from dsd2dxd_tpu_torch.entry import dryrun_multichip

    fused.reset_launch_counts()
    dryrun_multichip(4)
    assert capsys.readouterr().out.startswith(
        "dryrun_multichip OK over 4 entries (cuda:0, cuda:0")
    assert fused.MODE_LAUNCHES["K1a"] > 0 and fused.MODE_LAUNCHES["K2t"] > 0


@pytest.mark.parametrize("mode", ["device", "e2e"])
def test_bench_step_modes_on_card(cuda_device, mode):
    """tools/bench.py's device and e2e loops at 2 tiles of 1 MiB/ch: a
    positive time, one K1a launch per tile of every run."""
    from dsd2dxd_tpu_torch.tools import bench

    fn = bench.device_step if mode == "device" else bench.e2e_step
    fused.reset_launch_counts()
    res = fn(cuda_device, n_tiles=2, tile_bytes=1 << 20)
    assert res["seconds"] > 0
    # round_robin runs a rep again where its enqueue outlasted its sleep
    if mode == "device":
        assert res["runs"] >= bench.DEVICE_REPS + 2
    else:
        assert res["runs"] == bench.E2E_REPS + 1
    assert fused.MODE_LAUNCHES["K1a"] == 2 * res["runs"]


def test_lightspeed_measure_on_card(cuda_device, capsys):
    """tools/lightspeed.py --measure on a 44.1k and a 48k cell, through
    the engine's steps (K1a; K1e + K2t): a share of the chain-only bound
    in (0, 100 %], the path's kernels launched."""
    from dsd2dxd_tpu_torch.tools import lightspeed

    out = lightspeed.main(["--measure", "--reps", "3", "--cells",
                           "DSD64:352800,DSD64:192000"])
    rows = out["rows"]
    assert [r["cell"] for r in rows] == ["DSD64->352800", "DSD64->192000"]
    for r in rows:
        assert 0 < r["share_bound"] <= 1, r
    assert rows[0]["device"]["launches"].get("K1a", 0) > 0
    assert {"K1e", "K2t"} <= set(rows[1]["device"]["launches"])


def test_launch_refuses_another_device_index(cuda_device):
    """The C entry refuses a device index other than its tensors' (here
    device_count(), which no card has), and the launch is not counted."""
    chain = get_chain(*CELLS["E"])
    cfg = StepConfig(channels=2, tile_bytes=4096, bit_depth=24,
                     dither=DitherType.NONE, level_db=0.0)
    x = torch.zeros((2, 4096), dtype=torch.uint8, device=cuda_device)
    halo = fused.init_fused_halo(chain, 2, cuda_device)
    coefs = fused.kernel_coefs(chain, cuda_device)
    out = torch.empty(4096 * 2 * 3, dtype=torch.uint8, device=cuda_device)
    params = fused._kernel_params(chain, cfg, halo.shape[1], 0, False, 4096)
    before = fused.KERNEL_LAUNCHES
    with pytest.raises(RuntimeError, match="CUDA error 101"):
        fused._launch_decim(x, halo, coefs, out, None, params, ("K1a",),
                            device_index=torch.cuda.device_count())
    assert fused.KERNEL_LAUNCHES == before
    fused._launch_decim(x, halo, coefs, out, None, params, ("K1a",))
    assert fused.KERNEL_LAUNCHES == before + 1


def _cards(n_min: int = 2) -> list:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < n_min:
        pytest.skip(f"needs {n_min} or more cards, this machine has {n}")
    return [torch.device("cuda", i) for i in range(n)]


@pytest.mark.parametrize("out_hz", [352800, 96000], ids=["div8", "96k"])
def test_sharded_over_every_card_equals_streaming(out_hz):
    """parallel/sharded over every card (two or more): byte-equal to the
    streaming step on card 0, tile by tile, at 24-bit TPDF and f32 FPD."""
    from dsd2dxd_tpu_torch.tools import shardcheck

    res = shardcheck.check_cell(DsdRate.DSD64, out_hz, _cards(), 2, 256)
    assert res["equal"], res


def test_cli_round_robin_over_every_card(tmp_path, monkeypatch):
    """A batch of one more file than cards: file i converts on card i mod
    n, every output byte-equal to the same file converted on card 0
    alone."""
    import dsd2dxd_tpu_torch.cli.dsd2dxd as cli
    from dsd2dxd_tpu_torch.formats.dsf import write_dsf
    from dsd2dxd_tpu_torch.pipeline import engine

    cards = _cards()
    monkeypatch.setattr(engine, "_DEFAULT_TILE_TARGET", 256 * 1024)
    rng = np.random.default_rng(8)
    src = tmp_path / "in"
    src.mkdir()
    files = [src / f"t{i}.dsf" for i in range(len(cards) + 1)]
    for f in files:
        write_dsf(f, rng.integers(0, 256, (2, 600_000), dtype=np.uint8),
                  2_822_400)
    seen = {}
    convert_file = cli.convert_file

    def recording(path, *a, device=None, **k):
        conv = convert_file(path, *a, device=device, **k)
        seen[path.name] = conv.stats["device"]
        return conv

    monkeypatch.setattr(cli, "convert_file", recording)
    out_rr, out_one = tmp_path / "rr", tmp_path / "one"
    out_rr.mkdir()
    out_one.mkdir()
    args = ["-o", "w", "-q", *map(str, files)]
    assert cli.run(["-p", str(out_rr), *args]) == 0
    assert seen == {f.name: str(cards[i % len(cards)])
                    for i, f in enumerate(files)}
    assert cli.run(["-p", str(out_one), *args], device="cuda:0") == 0
    for f in files:
        assert ((out_rr / "in" / f"{f.stem}.wav").read_bytes()
                == (out_one / "in" / f"{f.stem}.wav").read_bytes())


@pytest.mark.parametrize("out_hz,bits,output", [
    (352800, 24, OutputType.WAV), (96000, 24, OutputType.WAV),
    (192000, 32, OutputType.AIFC)], ids=["div8", "96k", "192k-f32"])
def test_engine_sharded_over_every_card(tmp_path, monkeypatch, out_hz, bits,
                                        output):
    """DSD2DXD_SHARD_STREAM=1 with two or more cards (stream_devices
    unpatched): the engine spreads the stream over every card, and the
    file is byte-equal to the streaming conversion's."""
    from dsd2dxd_tpu_torch.formats.dsf import write_dsf
    from dsd2dxd_tpu_torch.pipeline import engine

    cards = _cards()
    monkeypatch.setattr(engine, "_DEFAULT_TILE_TARGET", 256 * 1024)
    src = tmp_path / "t.dsf"
    rng = np.random.default_rng(9)
    write_dsf(src, rng.integers(0, 256, (2, 3_000_001), dtype=np.uint8),
              2_822_400)
    outs, stats = [], []
    for shard in ("0", "1"):
        monkeypatch.setenv("DSD2DXD_SHARD_STREAM", shard)
        d = tmp_path / shard
        d.mkdir()
        conv = Converter.from_container(
            bit_depth=bits, output=output, level_db=-1.0, output_rate=out_hz,
            out_dir=d, dither=DitherType.TPDF if bits < 32 else DitherType.FPD,
            filt=FilterType.EQUIRIPPLE, append_rate=False, base_dir=tmp_path,
            input_path=src)
        conv.do_conversion()
        outs.append(conv.output_path().read_bytes())
        stats.append(conv.stats)
    assert stats[0]["devices"] == ["cuda:0"]
    assert stats[1]["devices"] == [str(c) for c in cards]
    assert stats[1]["tiles"] == stats[0]["tiles"] >= len(cards)
    assert outs[0] == outs[1]
