"""Tests of the port that need an NVIDIA card (marker `cuda`); they skip
where CUDA is not available. This file imports no jax, so on a machine
without jax it runs on its own:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q
"""

import numpy as np
import pytest
import torch

from dsd2dxd_tpu.filters.design import get_chain
from dsd2dxd_tpu.formats.dsd_types import (
    DitherType,
    DsdRate,
    FilterType,
    OutputType,
)
from dsd2dxd_tpu_torch import Converter
from dsd2dxd_tpu_torch.ops import fused, philox
from dsd2dxd_tpu_torch.ops.resample import StepConfig

pytestmark = pytest.mark.cuda

CELLS = {
    "E": (FilterType.EQUIRIPPLE, DsdRate.DSD64, 352800),
    "X": (FilterType.XLD, DsdRate.DSD64, 352800),
    "D": (FilterType.DSD2PCM, DsdRate.DSD64, 352800),
    "E128": (FilterType.EQUIRIPPLE, DsdRate.DSD128, 705600),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _decode(wire: torch.Tensor) -> np.ndarray:
    b = wire.cpu().numpy().reshape(-1, 3).astype(np.int64)
    v = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
    return np.where(v >= 1 << 23, v - (1 << 24), v)


@pytest.mark.parametrize("cell", list(CELLS))
@pytest.mark.parametrize("tile", [1 << 20, 3000])  # 3000: ragged last block
def test_kernel_matches_plain_on_card(cuda_device, cell, tile):
    """K1a against its plain version on the same card inputs: NONE
    within 5 LSB, TPDF with the same key within 1 LSB, peak within 1e-4,
    and the launch counted."""
    chain = get_chain(*CELLS[cell])
    rng = np.random.default_rng(12)
    taps = [torch.tensor(np.asarray(s.taps, dtype=np.float32),
                         device=cuda_device) for s in chain]
    for dither in (DitherType.NONE, DitherType.TPDF):
        cfg = StepConfig(channels=2, tile_bytes=tile, bit_depth=24,
                         dither=dither, level_db=-1.5)
        step = fused.make_fused_step(chain, cfg, cuda_device)
        h = fused.init_fused_halo(chain, 2, cuda_device)
        for t in range(2):
            x = torch.from_numpy(rng.integers(0, 256, (2, tile),
                                              dtype=np.uint8)).to(cuda_device)
            key = philox.tile_key(99, t)
            before = fused.KERNEL_LAUNCHES
            wk, pk, hk = step(x, h, key)
            assert fused.KERNEL_LAUNCHES == before + 1
            wr, pr, hr = fused.fused_div8_reference(x, h, key, taps, chain,
                                                    cfg)
            torch.cuda.synchronize()
            d = np.abs(_decode(wk) - _decode(wr))
            assert d.max() <= (5 if dither is DitherType.NONE else 1)
            assert abs(float(pk) - float(pr)) <= 1e-4
            assert torch.equal(hk, hr)
            h = hk


def test_big_endian_bytes_on_card(cuda_device):
    chain = get_chain(*CELLS["E"])
    cfg = StepConfig(channels=2, tile_bytes=8192, bit_depth=24,
                     dither=DitherType.TPDF, level_db=0.0)
    le = fused.make_fused_step(chain, cfg, cuda_device)
    be = fused.make_fused_step(chain, cfg, cuda_device, big_endian=True)
    x = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (2, 8192), dtype=np.uint8)).to(cuda_device)
    h = fused.init_fused_halo(chain, 2, cuda_device)
    a = le(x, h, 5)[0].reshape(-1, 3)
    b = be(x, h, 5)[0].reshape(-1, 3)
    assert torch.equal(a, b.flip(1))


def test_engine_on_card_equals_cpu(cuda_device, tmp_path, monkeypatch):
    """The streamed CUDA pipeline (pinned buffers, copy and compute
    streams, drain thread) writes the same file as the CPU loop."""
    import dsd2dxd_tpu_torch.pipeline.engine as engine
    from dsd2dxd_tpu.formats.dsf import write_dsf
    from dsd2dxd_tpu.ops.dsm import synth_tone_dsd

    monkeypatch.setattr(engine, "_DEFAULT_TILE_TARGET", 32 * 1024)
    src = tmp_path / "tone.dsf"
    write_dsf(src, synth_tone_dsd(1000.0, 0.5, 2_822_400, channels=2),
              2_822_400, lsb_first=True)
    outs = {}
    for dev in ("cpu", cuda_device):
        d = tmp_path / str(dev).replace(":", "")
        d.mkdir()
        conv = Converter.from_container(
            bit_depth=24, output=OutputType.WAV, level_db=-1.0,
            output_rate=352800, out_dir=d, dither=DitherType.TPDF,
            filt=FilterType.EQUIRIPPLE, append_rate=False, base_dir=tmp_path,
            input_path=src, device=dev)
        before = fused.KERNEL_LAUNCHES
        conv.do_conversion()
        launched = fused.KERNEL_LAUNCHES - before
        assert launched == (conv.stats["tiles"] if dev != "cpu" else 0)
        outs[str(dev)] = conv.output_path().read_bytes()
    a, b = outs.values()
    assert len(a) == len(b)
    head = 44
    da = _decode(torch.frombuffer(bytearray(a[head:]), dtype=torch.uint8))
    db = _decode(torch.frombuffer(bytearray(b[head:]), dtype=torch.uint8))
    assert a[:head] == b[:head]
    assert np.abs(da - db).max() <= 1
