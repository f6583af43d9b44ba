"""Config 3 end to end against the benchmark's plain references: a seeded
DSD128 .dsf through ``Converter.from_container`` at ``-i 2 -r 88200 -b
20 -t E -d N -o F``. The float frames the NJAD sink receives lie within
the float32 cascade's error of the float64 reference
(``benchmark/reference/decimate.py``); the FLAC decodes
(``benchmark/reference/containers.py``) to exactly the plain NJAD
(``benchmark/reference/njad.py``) of those frames; the stream has
floor(N / 64) frames for N bits per channel. On the CPU 0.5 s; marked
``cuda``, 10 s on the card (skips without one). This file imports
nothing of jax, so on the card it runs alone:

    python -m pytest tests/test_torch_config3.py --noconftest -m cuda -q
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import dsd2dxd_tpu_torch.pipeline.engine as tengine
from benchmark import inputs
from benchmark.reference import containers, decimate
from benchmark.reference.njad import Njad
from dsd2dxd_tpu_torch import Converter
from dsd2dxd_tpu_torch.formats.dsd_types import DitherType, FilterType, OutputType
from dsd2dxd_tpu_torch.native import loader

DSD128_HZ = 5_644_800
TABLE = "E_2_88200_a8ffb4162b.npz"  # the ÷64 chain of filter E
LSB24 = float(1 << 23)
# the float32 cascade against the float64 reference, in LSB of 2^-23:
# the plain path reads 0.90 here, the card's cell at most 0.7 past NJAD's
# 16; the cascade in TF32 reads thousands
CASCADE_LSB = 4.0


def config3(track_s: float, seed: int, tmp_path: Path, device: str,
            monkeypatch) -> tuple:
    """(the seeded track's MSB-first planes, the float frames the NJAD
    sink received in order, the FLAC output's bytes)."""
    prog = inputs.make_program(seed, DSD128_HZ, 2, [track_s], 0.25)
    src = tmp_path / "in" / "t.dsf"
    src.parent.mkdir()
    prog.write_dsf(0, src)
    received = []
    quantize = loader.NativeLib.njad_quantize

    def capture(self, state, samples, bits):
        received.append(np.array(samples, dtype=np.float32))
        return quantize(self, state, samples, bits)

    monkeypatch.setattr(loader.NativeLib, "njad_quantize", capture)
    conv = Converter.from_container(
        bit_depth=20, output=OutputType.FLAC, level_db=0.0,
        output_rate=88200, out_dir=tmp_path / "out", dither=DitherType.NJAD,
        filt=FilterType.EQUIRIPPLE, append_rate=False, base_dir=src.parent,
        input_path=src, device=device)
    conv.do_conversion()
    return (prog.planes(0), np.concatenate(received),
            conv.output_path().read_bytes())


def check(planes: np.ndarray, received: np.ndarray, flac: bytes,
          device: str) -> None:
    chain = decimate.load_chain(TABLE)
    n_bits = planes.shape[1] * 8
    frames = n_bits // 64
    assert chain.frames(n_bits) == frames
    lay = containers.parse_flac(flac[:4096])
    assert (lay.channels, lay.rate, lay.bits) == (2, 88200, 20)
    got = containers.flac_samples(flac, 2, frames)  # (C, frames), or raises
    assert received.shape == (frames, 2)

    dev = torch.device(device)
    ref = decimate.output_block(chain, torch.from_numpy(planes).to(dev), 0,
                                frames)
    err = (torch.from_numpy(received.T).to(dev, torch.float64) - ref) * LSB24
    assert float(err.abs().max()) <= CASCADE_LSB

    want = Njad(2).quantize(torch.from_numpy(received), 20).numpy()
    np.testing.assert_array_equal(got, want.T)


def test_config3_against_the_references_on_the_cpu(tmp_path, monkeypatch):
    # several tiles, so that the cascade's halo and NJAD's state cross
    # tile edges
    monkeypatch.setattr(tengine, "_DEFAULT_TILE_TARGET", 64 * 1024)
    planes, received, flac = config3(0.5, 2**31 + 3, tmp_path, "cpu",
                                     monkeypatch)
    assert received.shape[0] == 44100
    check(planes, received, flac, "cpu")


@pytest.mark.cuda
def test_config3_against_the_references_on_the_card(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    planes, received, flac = config3(10.0, 2**31 + 5, tmp_path, "cuda:0",
                                     monkeypatch)
    check(planes, received, flac, "cuda")
