"""The port's delta-sigma modulator and test-signal synthesis
(dsd2dxd_tpu_torch/ops/dsm.py, native/src/dsdkit.cc) against the JAX
package's ops/dsm.py: bit for bit."""

import numpy as np
import pytest

from dsd2dxd_tpu.ops import dsm as jdsm
from dsd2dxd_tpu_torch.native import loader
from dsd2dxd_tpu_torch.ops import dsm


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("n", [1, 999, 20000])
def test_dsm2_bits_equal_jax(native, n):
    x = 0.6 * np.sin(np.arange(n) * 0.013) + 0.05 * np.random.default_rng(
        n).standard_normal(n)
    got = dsm.dsm2_bits(x, native=native)
    assert got.dtype == np.uint8 and got.shape == (n,)
    assert np.array_equal(got, jdsm.dsm2_bits(x))


def test_native_and_python_loops_agree():
    x = np.random.default_rng(3).uniform(-0.7, 0.7, 50000)
    assert np.array_equal(dsm.dsm2_bits(x), dsm.dsm2_bits(x, native=False))
    assert np.array_equal(loader.load().dsm2_bits(x),
                          dsm.dsm2_bits(x, native=False))


@pytest.mark.parametrize("n_bits", [8, 13, 1])
def test_bits_to_bytes_msb_equal_jax(n_bits):
    bits = np.random.default_rng(n_bits).integers(0, 2, n_bits,
                                                  dtype=np.uint8)
    assert np.array_equal(dsm.bits_to_bytes_msb(bits),
                          jdsm.bits_to_bytes_msb(bits))


@pytest.mark.parametrize("channels,phase", [(1, 0.0), (2, 0.5)])
def test_synth_tone_dsd_equal_jax(channels, phase):
    args = (1000.0, 0.01, 2_822_400)
    kw = dict(amplitude=0.5, channels=channels, phase_per_ch=phase)
    got = dsm.synth_tone_dsd(*args, **kw)
    assert got.shape == (channels, 3528)
    assert np.array_equal(got, jdsm.synth_tone_dsd(*args, **kw))


def test_synth_pink_noise_dsd_equal_jax():
    kw = dict(amplitude=0.25, channels=2, seed=7)
    got = dsm.synth_pink_noise_dsd(0.005, 2_822_400, **kw)
    assert np.array_equal(got, jdsm.synth_pink_noise_dsd(0.005, 2_822_400,
                                                         **kw))


@pytest.mark.parametrize("n_bytes,toggle", [(4096, 2048), (64, 0)])
def test_synth_impulse_dsd_equal_jax(n_bytes, toggle):
    got = dsm.synth_impulse_dsd(n_bytes, toggle)
    assert np.array_equal(got, jdsm.synth_impulse_dsd(n_bytes, toggle))
