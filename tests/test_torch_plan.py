"""The port's numpy planning (dsd2dxd_tpu_torch/ops/plan.py) against the
JAX package's ops/phase.py, term by term."""

import numpy as np
import pytest
import torch

from dsd2dxd_tpu.filters.design import get_chain as jget_chain
from dsd2dxd_tpu.formats import dsd_types as jtypes
from dsd2dxd_tpu.ops import phase as jphase
from dsd2dxd_tpu_torch.filters.design import get_chain
from dsd2dxd_tpu_torch.formats.dsd_types import DsdRate, FilterType
from dsd2dxd_tpu_torch.ops import plan as tplan

DIV8_CHAINS = [
    (FilterType.EQUIRIPPLE, DsdRate.DSD64, 352800),
    (FilterType.XLD, DsdRate.DSD64, 352800),
    (FilterType.DSD2PCM, DsdRate.DSD64, 352800),
]
OTHER_CHAINS = [
    (FilterType.EQUIRIPPLE, DsdRate.DSD64, 176400),   # ÷16
    (FilterType.EQUIRIPPLE, DsdRate.DSD128, 88200),   # ÷64, rephased
    (FilterType.EQUIRIPPLE, DsdRate.DSD64, 96000),    # 48k family
]



def _jchain(key):
    """The JAX package's chain for a port (filter, rate, out) key."""
    return jget_chain(jtypes.FilterType[key[0].name],
                      jtypes.DsdRate[key[1].name], key[2])


@pytest.mark.parametrize("key", DIV8_CHAINS + OTHER_CHAINS,
                         ids=lambda k: f"{k[0].name}-{k[1].name}-{k[2]}")
def test_plans_equal_jax_term_by_term(key):
    chain = get_chain(*key)
    mine = tplan.build_chain_plans(chain)
    ref = jphase.build_chain_plans(_jchain(key))
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        assert (a.L, a.M, a.p_in, a.p_out, a.lane_stride, a.hist_lanes,
                a.rephase) == (b.L, b.M, b.p_in, b.p_out, b.lane_stride,
                               b.hist_lanes, b.rephase)
        assert a.delta_i == b.delta_i
        assert len(a.terms) == len(b.terms)
        for ta, tb in zip(a.terms, b.terms):
            assert [(t.coef, t.r_in, t.base) for t in ta] == \
                [(t.coef, t.r_in, t.base) for t in tb]
    assert tplan.chain_tile_unit_bits(mine) == jphase.chain_tile_unit_bits(ref)


class _Expr:
    """Records the association of a sum."""

    def __init__(self, s):
        self.s = s

    def __add__(self, other):
        return _Expr(f"({self.s}+{other.s})")


def test_tree_sum_association_equals_jax():
    for n in range(1, 257):
        items = [_Expr(f"c{i}") for i in range(n)]
        assert tplan.tree_sum(iter(items)).s == jphase.tree_sum(items).s, n
    with pytest.raises(ValueError):
        tplan.tree_sum([])


def test_tree_sum_values_bit_equal_on_f32():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 16, 18, 56, 58, 96):
        parts = [rng.standard_normal(64).astype(np.float32) for _ in range(n)]
        ref = jphase.tree_sum(parts)
        mine = tplan.tree_sum(torch.from_numpy(p) for p in parts)
        np.testing.assert_array_equal(mine.numpy(), ref)


@pytest.mark.parametrize("key", DIV8_CHAINS,
                         ids=lambda k: f"{k[0].name}-{k[1].name}-{k[2]}")
def test_params_from_chain(key):
    chain = get_chain(*key)
    params = tplan.params_from_chain(chain)
    for p, s, pl in zip(params, chain,
                        jphase.build_chain_plans(_jchain(key))):
        assert p.taps.dtype == torch.float32
        np.testing.assert_array_equal(p.taps.numpy(),
                                      np.asarray(s.taps, dtype=np.float32))
        assert (p.L, p.M) == (s.L, s.M)
        assert p.plan.hist_lanes == pl.hist_lanes


def test_state_from_jax():
    halo = np.full((2, 128), 0x69, dtype=np.uint8)
    halo[1, 5] = 3
    st = tplan.state_from_jax(halo)
    assert st.dtype == torch.uint8 and tuple(st.shape) == (2, 128)
    assert int(st[1, 5]) == 3
    halo[1, 5] = 7  # the port owns its copy
    assert int(st[1, 5]) == 3
    # G=2/4 word lanes: the little-endian bytes of each word, in order
    words = np.array([[0x0201, 0x0403], [0x1211, 0x1413]], dtype=np.uint16)
    assert tplan.state_from_jax(words).tolist() == [[1, 2, 3, 4],
                                                    [0x11, 0x12, 0x13, 0x14]]
    words32 = np.array([[0x04030201]], dtype=">u4")  # any byte order in
    assert tplan.state_from_jax(words32).tolist() == [[1, 2, 3, 4]]
    with pytest.raises(ValueError):
        tplan.state_from_jax(np.zeros((2, 128), dtype=np.int16))
    with pytest.raises(ValueError):
        tplan.state_from_jax(np.zeros((2, 128), dtype=np.uint64))
    with pytest.raises(ValueError):
        tplan.state_from_jax(np.zeros(128, dtype=np.uint8))
