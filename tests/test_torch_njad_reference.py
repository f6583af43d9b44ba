"""The port's NJAD requantizer (``native/src/njad.cc`` through
``native/loader.py``) against the benchmark's plain reference
(``benchmark/reference/njad.py``): the same integers, exactly, on seeded
float frames at 16, 20 and 24 bits, mono and stereo, with runs of
digital silence, values past full scale, and one stream fed in several
calls."""

import numpy as np
import pytest
import torch

from benchmark.reference.njad import Njad, leading_digit
from dsd2dxd_tpu_torch.native.loader import load

FRAMES = 5000  # past njad.cc's 4096, where a stereo call runs a thread per channel


def frames(kind: str, channels: int, bits: int) -> np.ndarray:
    """(FRAMES, C) float32 full-scale samples of one kind, seeded by the
    depth and the channels."""
    rng = np.random.default_rng([bits, channels])
    t = np.arange(FRAMES)
    x = np.stack([0.4 * np.sin(t * 0.011 * (c + 1) + rng.uniform(0, 6))
                  + 0.05 * rng.standard_normal(FRAMES)
                  for c in range(channels)], 1)
    if kind == "silence":
        # digital silence, and a signal within an LSB of it (a candidate
        # of 0 or -1), between stretches of signal
        x[500:1500] = 0.0
        x[2000:2600] = rng.uniform(-3e-7, 3e-7, (600, channels))
        x[3000:4500] = 0.0
    elif kind == "quiet":
        # a few LSB from a fresh state, where the histogram is small:
        # after 1 and 3, the candidates 0 and 1 of 0.5 tie exactly
        x = rng.integers(-6, 7, (FRAMES, channels)) + rng.uniform(
            0, 1, (FRAMES, channels))
        x[:3] = np.array([1.5, 3.5, 0.5])[:, None]
        x /= float(1 << (bits - 1))
    elif kind == "clip":
        x *= 3.0  # past full scale on both sides
        x[100:130] = 1.0
        x[130:160] = -1.0
    return np.ascontiguousarray(x, dtype=np.float32)


@pytest.mark.parametrize("kind", ["signal", "silence", "quiet", "clip",
                                  "calls"])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("bits", [16, 20, 24])
def test_the_ports_njad_is_the_reference(bits, channels, kind):
    lib = load()
    x = frames("signal" if kind == "calls" else kind, channels, bits)
    # one stream in several calls: the state carries over between them
    cuts = [0, 300, 301, 4900, FRAMES] if kind == "calls" else [0, FRAMES]
    state = lib.njad_new(channels)
    try:
        got = np.concatenate([lib.njad_quantize(state, x[a:b], bits)
                              for a, b in zip(cuts, cuts[1:])])
    finally:
        lib.njad_free(state)
    ref = Njad(channels)
    want = np.concatenate([ref.quantize(torch.from_numpy(x[a:b]), bits)
                           .numpy() for a, b in zip(cuts, cuts[1:])])
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # the choice is the floor or the ceil, clipped to the depth
    v = np.floor(x.astype(np.float64) * 2.0 ** (bits - 1))
    top = 1 << (bits - 1)
    assert set(np.unique(want - np.clip(v, -top, top - 1))) <= {0, 1}
    if kind == "clip":
        assert want.max() == top - 1 and want.min() == -top


@pytest.mark.parametrize("v, d", [(0, 0), (1, 1), (-1, 1), (9, 9), (10, 1),
                                  (-199, 1), (999, 9), (1000, 1),
                                  (-524288, 5), (8388607, 8)])
def test_leading_digit(v, d):
    assert leading_digit(v) == d
