"""The port's conv-style reference path (dsd2dxd_tpu_torch/ops/resample.py)
against the JAX make_step and the scipy upfirdn oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsd2dxd_tpu.filters.design import get_chain as jget_chain
from dsd2dxd_tpu.formats import dsd_types as jtypes
from dsd2dxd_tpu.ops import resample as jres
from dsd2dxd_tpu_torch.filters.design import get_chain
from dsd2dxd_tpu_torch.formats.dsd_types import DitherType, DsdRate, FilterType
from dsd2dxd_tpu_torch.ops import resample as tres

E64 = (FilterType.EQUIRIPPLE, DsdRate.DSD64, 352800)
D64 = (FilterType.DSD2PCM, DsdRate.DSD64, 352800)
TILE = 4096


def _jchain(key):
    """The JAX package's chain for a port (filter, rate, out) key."""
    return jget_chain(jtypes.FilterType[key[0].name],
                      jtypes.DsdRate[key[1].name], key[2])


def _tiles(seed, n, channels=2, tile=TILE):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(channels, tile), dtype=np.uint8)
            for _ in range(n)]


def test_unpack_bits_equals_jax():
    x = _tiles(1, 1, tile=64)[0]
    mine = tres.unpack_bits(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(mine, np.asarray(jres.unpack_bits(x)))


@pytest.mark.parametrize("key", [E64, D64], ids=["E", "D"])
def test_make_step_f32_matches_jax_and_upfirdn(key):
    chain = get_chain(*key)
    cfg_t = tres.StepConfig(channels=2, tile_bytes=TILE, bit_depth=32,
                            dither=DitherType.NONE, level_db=-1.5)
    cfg_j = jres.StepConfig(channels=2, tile_bytes=TILE, bit_depth=32,
                            dither=jtypes.DitherType.NONE, level_db=-1.5)
    tstep = tres.make_step(chain, cfg_t)
    jstep = jres.make_step(_jchain(key), cfg_j)
    h_t = tres.init_hists(chain, 2)
    h_j = jres.init_hists(_jchain(key), 2)
    outs = []
    xs = _tiles(2, 3)
    for t, x in enumerate(xs):
        ot, pt, h_t = tstep(torch.from_numpy(x), h_t)
        oj, pj, h_j = jstep(x, h_j, jax.random.PRNGKey(t))
        ot, oj = ot.numpy(), np.asarray(oj)
        assert ot.shape == oj.shape and ot.dtype == np.float32
        assert np.max(np.abs(ot - oj)) <= 2e-6
        assert abs(float(pt) - float(pj)) <= 1e-4
        outs.append(ot)
    # the streamed tiles equal upfirdn over the whole stream
    bits = np.concatenate([np.unpackbits(x, axis=1) for x in xs],
                          axis=1).astype(np.float64) * 2 - 1
    ref = bits
    for s in chain:
        ref = tres.upfirdn_reference(np.asarray(s.taps, np.float64), ref,
                                     s.L, s.M)
    ref = ref * 10 ** (-1.5 / 20)
    assert np.max(np.abs(np.concatenate(outs) - ref.T)) <= 2e-6


def test_make_step_int24_matches_jax():
    chain = get_chain(*E64)
    cfg_t = tres.StepConfig(channels=2, tile_bytes=TILE, bit_depth=24,
                            dither=DitherType.NONE, level_db=-1.5)
    cfg_j = jres.StepConfig(channels=2, tile_bytes=TILE, bit_depth=24,
                            dither=jtypes.DitherType.NONE, level_db=-1.5)
    tstep = tres.make_step(chain, cfg_t)
    jstep = jres.make_step(_jchain(E64), cfg_j)
    h_t = tres.init_hists(chain, 2)
    h_j = jres.init_hists(_jchain(E64), 2)
    for t, x in enumerate(_tiles(3, 2)):
        ot, _, h_t = tstep(torch.from_numpy(x), h_t)
        oj, _, h_j = jstep(x, h_j, jax.random.PRNGKey(t))
        assert ot.dtype == torch.int32
        d = np.abs(ot.numpy().astype(np.int64) - np.asarray(oj).astype(np.int64))
        assert d.max() <= 5


def test_rational_stage_matches_upfirdn():
    """An L>1 stage (the ×160/147 family stage) over two streamed tiles."""
    stage = get_chain(FilterType.EQUIRIPPLE, DsdRate.DSD64, 96000)[-1]
    assert stage.L > 1
    rng = np.random.default_rng(4)
    n = 147 * 4
    xs = [rng.standard_normal((2, n)).astype(np.float32) for _ in range(2)]
    taps = torch.tensor(np.asarray(stage.taps), dtype=torch.float32)
    hist = tres.init_hists([stage], 2)[0]
    outs = []
    for x in xs:
        y, hist = tres.stage_apply_streaming(torch.from_numpy(x), hist,
                                             stage, taps)
        outs.append(y.numpy())
    ref = tres.upfirdn_reference(np.asarray(stage.taps, np.float64),
                                 np.concatenate(xs, axis=1).astype(np.float64),
                                 stage.L, stage.M)
    assert np.max(np.abs(np.concatenate(outs, axis=1) - ref)) <= 2e-6


def test_quantize_rounds_half_to_even_like_jnp():
    scale = 2.0 ** 23
    vals = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 2.0 ** 23 + 7, -(2.0 ** 23) - 9,
                     3.49, -3.51], dtype=np.float64) / scale
    x = vals.astype(np.float32)
    mine = tres.quantize_int(torch.from_numpy(x), 24, None).numpy()
    ref = np.asarray(jres.quantize_int(jnp.asarray(x), 24, None))
    np.testing.assert_array_equal(mine, ref)


def test_tpdf_dither_statistics_and_reproducible():
    chain = get_chain(*E64)
    cfg_f = tres.StepConfig(channels=2, tile_bytes=TILE, bit_depth=32,
                            dither=DitherType.NONE, level_db=-6.0)
    cfg_d = tres.StepConfig(channels=2, tile_bytes=TILE, bit_depth=24,
                            dither=DitherType.TPDF, level_db=-6.0)
    x = torch.from_numpy(_tiles(5, 1)[0])
    yf, _, _ = tres.make_step(chain, cfg_f)(x, tres.init_hists(chain, 2))
    dstep = tres.make_step(chain, cfg_d)
    q1, _, _ = dstep(x, tres.init_hists(chain, 2), torch.Generator().manual_seed(7))
    q2, _, _ = dstep(x, tres.init_hists(chain, 2), torch.Generator().manual_seed(7))
    q3, _, _ = dstep(x, tres.init_hists(chain, 2), torch.Generator().manual_seed(8))
    assert torch.equal(q1, q2)
    assert not torch.equal(q1, q3)
    f = yf.numpy().astype(np.float64) * 2 ** 23
    e = q1.numpy().astype(np.float64) - f
    e = e[np.abs(f) < 2 ** 23 - 4]
    assert 0.45 < float(np.sqrt(np.mean(e ** 2))) < 0.55
    assert abs(float(np.mean(e))) < 0.05  # 8k samples: 3 sigma of 0.5/sqrt(N)
