"""The fused ÷8 step of the port (dsd2dxd_tpu_torch/ops/fused.py) against
the JAX fused Pallas step, run in interpret mode on the CPU as
tests/test_fused.py runs it; plus the Philox generator, the dither
statistics, and the CUDA kernel's block layout (emulated here; the
kernel itself runs on the card in tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsd2dxd_tpu.filters.design import get_chain
from dsd2dxd_tpu.formats.dsd_types import DitherType, DsdRate, FilterType
from dsd2dxd_tpu.ops import fused as jfused
from dsd2dxd_tpu.ops.resample import StepConfig as JStepConfig
from dsd2dxd_tpu.pipeline.transfer import interleave_planes_numpy
from dsd2dxd_tpu.utils.errors import ConfigError
from dsd2dxd_tpu_torch.ops import fused as tfused
from dsd2dxd_tpu_torch.ops import philox
from dsd2dxd_tpu_torch.ops.plan import state_from_jax, tree_sum
from dsd2dxd_tpu_torch.ops.resample import StepConfig

E64 = (FilterType.EQUIRIPPLE, DsdRate.DSD64, 352800)
X64 = (FilterType.XLD, DsdRate.DSD64, 352800)
D64 = (FilterType.DSD2PCM, DsdRate.DSD64, 352800)
E128 = (FilterType.EQUIRIPPLE, DsdRate.DSD128, 705600)
TILE = 16384 * 2   # two JAX grid blocks, as tests/test_fused.py
LEVEL = -1.5


def _tiles(seed, n, channels=2, tile=TILE):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(channels, tile), dtype=np.uint8)
            for _ in range(n)]


def _taps(chain):
    return [torch.tensor(np.asarray(s.taps, dtype=np.float32)) for s in chain]


def _decode24(wire: bytes, big_endian=False) -> np.ndarray:
    b = np.frombuffer(wire, dtype=np.uint8).reshape(-1, 3).astype(np.int64)
    if big_endian:
        b = b[:, ::-1]
    v = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
    return np.where(v >= 1 << 23, v - (1 << 24), v)


def _cfg(tile=TILE, dither=DitherType.NONE, level=LEVEL, channels=2):
    return StepConfig(channels=channels, tile_bytes=tile, bit_depth=24,
                      dither=dither, level_db=level)


@pytest.mark.parametrize("key", [E64, X64, D64], ids=["E", "X", "D"])
def test_plain_cascade_matches_jax_fused_float(key):
    """Both idle-primed: no head skip. Three tiles, state carried."""
    chain = get_chain(*key)
    jcfg = JStepConfig(channels=2, tile_bytes=TILE, bit_depth=32,
                       dither=DitherType.NONE, level_db=LEVEL)
    jstep, halo_bytes = jfused.make_fused_step(chain, jcfg, interpret=True)
    assert halo_bytes == tfused.chain_halo_bytes(chain)
    h_j = jnp.asarray(jfused.init_fused_halo(chain, 2))
    h_t = tfused.init_fused_halo(chain, 2)
    np.testing.assert_array_equal(h_t.numpy(), np.asarray(h_j))
    gain = tfused._gain32(_cfg())
    for t, x in enumerate(_tiles(5, 3)):
        oj, pj, h_j = jstep(x, h_j, t)
        y = tfused.fused_div8_cascade(torch.from_numpy(x), h_t, _taps(chain),
                                      chain, gain)
        h_t = torch.from_numpy(x[:, -halo_bytes:].copy())
        assert np.max(np.abs(y.numpy().T - np.asarray(oj))) <= 2e-6
        assert abs(float(y.abs().max()) - float(pj)) <= 1e-4
        np.testing.assert_array_equal(h_t.numpy(), np.asarray(h_j))


def test_fused_24bit_matches_jax_planes_and_state_handover():
    """24-bit NONE against JAX emit="planes" + the host interleaver, both
    byte orders; then JAX tile 0 -> state_from_jax -> port tile 1."""
    chain = get_chain(*E64)
    jcfg = JStepConfig(channels=2, tile_bytes=TILE, bit_depth=24,
                       dither=DitherType.NONE, level_db=LEVEL)
    jstep, halo_bytes, layout = jfused.make_fused_step(
        chain, jcfg, interpret=True, emit="planes")
    steps = {be: tfused.make_fused_step(chain, _cfg(), "cpu", big_endian=be)
             for be in (False, True)}
    x0, x1 = _tiles(6, 2)
    h_j = jnp.asarray(jfused.init_fused_halo(chain, 2))
    planes, pj, h_j = jstep(x0, h_j, 0)
    for be, step in steps.items():
        wire, pt, h_t = step(torch.from_numpy(x0),
                             tfused.init_fused_halo(chain, 2), 0)
        ref = interleave_planes_numpy(np.asarray(planes), layout, TILE, be)
        assert len(ref) == wire.numel() == TILE * 2 * 3
        d = np.abs(_decode24(wire.numpy().tobytes(), be) - _decode24(ref, be))
        assert d.max() <= 5
        assert abs(float(pt) - float(pj)) <= 1e-4
    # hand the JAX state to the port for tile 1 (the JAX step donates it)
    state = state_from_jax(np.asarray(h_j))
    planes1, pj1, _ = jstep(x1, h_j, 1)
    wire1, pt1, _ = steps[False](torch.from_numpy(x1), state, 1)
    ref1 = interleave_planes_numpy(np.asarray(planes1), layout, TILE, False)
    assert np.abs(_decode24(wire1.numpy().tobytes())
                  - _decode24(ref1)).max() <= 5
    assert abs(float(pt1) - float(pj1)) <= 1e-4


def test_streaming_equals_one_long_tile():
    """Overlap-save in the byte domain: two tiles with the carried halo
    give the same bytes as one tile of twice the length."""
    chain = get_chain(*E64)
    x = np.concatenate(_tiles(7, 2, tile=4096), axis=1)
    long_step = tfused.make_fused_step(chain, _cfg(8192), "cpu")
    short_step = tfused.make_fused_step(chain, _cfg(4096), "cpu")
    whole, pk, _ = long_step(torch.from_numpy(x),
                             tfused.init_fused_halo(chain, 2), 0)
    h = tfused.init_fused_halo(chain, 2)
    a, pa, h = short_step(torch.from_numpy(x[:, :4096].copy()), h, 0)
    b, pb, h = short_step(torch.from_numpy(x[:, 4096:].copy()), h, 0)
    assert torch.equal(torch.cat([a, b]), whole)
    assert float(max(pa, pb)) == float(pk)


def _emulate_kernel_cascade(x, halo, chain, gain, block_out):
    """The CUDA kernel's blocking, in torch: each (block, channel) loads
    only the bytes `block_layout` names and runs the stages on its own
    buffers. Must equal the plain cascade bit for bit."""
    c, t = x.shape
    lay = tfused.block_layout(chain, halo.shape[1], block_out)
    window = torch.cat([halo, x], dim=1)
    idle = torch.full((c, lay.n_load_bytes + block_out), tfused.IDLE_BYTE,
                      dtype=torch.uint8)
    window = torch.cat([window, idle], dim=1)  # reads past the end: idle
    taps = _taps(chain)
    y = torch.empty(c, t)
    for m0 in range(0, t, block_out):
        wb = m0 + lay.byte_off
        v = tfused.unpack_bits(window[:, wb:wb + lay.n_load_bytes])
        v = v[:, lay.bit_off:]
        for tp, n, m, o in zip(taps, lay.n_taps, lay.decim, lay.out_len):
            assert v.shape[1] >= (o - 1) * m + n
            hk = tp.tolist()
            v = tree_sum(v[:, n - 1 - k:n - 1 - k + (o - 1) * m + 1:m] * hk[k]
                         for k in range(n))
        n_keep = min(block_out, t - m0)
        y[:, m0:m0 + n_keep] = v[:, :n_keep] * gain if gain != 1.0 \
            else v[:, :n_keep]
    return y


@pytest.mark.parametrize("key,tile,block_out", [
    (E64, 4096, tfused.BLOCK_OUT),
    (X64, 3000, 512),   # ragged last block
    (D64, 2048, 300),
    (E128, 1500, 700),
])
def test_kernel_block_layout_emulated(key, tile, block_out):
    chain = get_chain(*key)
    x = torch.from_numpy(_tiles(8, 1, tile=tile)[0])
    halo = torch.from_numpy(_tiles(9, 1, tile=tfused.chain_halo_bytes(chain))[0])
    gain = tfused._gain32(_cfg())
    ref = tfused.fused_div8_cascade(x, halo, _taps(chain), chain, gain)
    emu = _emulate_kernel_cascade(x, halo, chain, gain, block_out)
    assert torch.equal(ref, emu)


@pytest.mark.parametrize("key", [E64, X64, D64, E128],
                         ids=["E", "X", "D", "E128"])
def test_kernel_params_fit_shared_memory(key):
    chain = get_chain(*key)
    lay = tfused.block_layout(chain, 128, tfused.BLOCK_OUT)
    p = tfused._kernel_params(chain, _cfg(tile=4096), 128, 0x1234_5678_9ABC_DEF0,
                              False)
    assert p.byte_off == lay.byte_off >= 0
    assert (p.key0, p.key1) == (0x9ABCDEF0, 0x12345678)
    assert p.buf_a == p.n_taps_total == sum(s.n_taps for s in chain)
    for s, n_in in enumerate(lay.in_len):
        if s == 0:
            room = p.buf_b - p.buf_a
            assert room >= lay.n_load_bytes * 8 >= lay.bit_off + n_in
        elif s % 2:
            assert p.smem_bytes // 4 - p.buf_b >= n_in
        else:
            assert p.buf_b - p.buf_a >= n_in
    assert p.smem_bytes <= 227 * 1024
    assert lay.out_len[-1] == tfused.BLOCK_OUT


# -- Philox and dither ------------------------------------------------------

def _t(v):
    return torch.tensor([v], dtype=torch.int64)


def test_philox_known_answers():
    """Random123's kat_vectors for philox4x32-10."""
    out = philox.philox4x32(_t(0), _t(0), _t(0), _t(0), 0)
    assert [int(v) for v in out] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C,
                                     0x9B00DBD8]
    out = philox.philox4x32(_t(0x243F6A88), _t(0x85A308D3), _t(0x13198A2E),
                            _t(0x03707344), (0x299F31D0 << 32) | 0xA4093822)
    assert [int(v) for v in out] == [0xD16CFE09, 0x94FDCCEB, 0x5001E420,
                                     0x24126EA1]


def test_tile_key_mixes_all_bits():
    keys = {philox.tile_key(s, t) for s in (0, 1, 1 << 40) for t in range(4)}
    assert len(keys) == 12
    assert all(0 <= k < 1 << 64 for k in keys)
    assert philox.tile_key(5, 1) == philox.tile_key(5, 1)
    # seeds differing only above bit 31 still give different keys
    assert philox.tile_key(1, 0) != philox.tile_key(1 | (1 << 33), 0)


def test_uniforms_exact_and_in_range():
    u0, u1 = philox.uniforms(4096, 2, philox.tile_key(3, 0))
    for u in (u0, u1):
        assert u.dtype == torch.float32
        assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
        k = (u.double() * 2 ** 24)
        assert torch.equal(k, torch.round(k))  # multiples of 2**-24


@pytest.mark.parametrize("dither,lo,hi", [
    (DitherType.TPDF, 0.45, 0.55),
    # rect + rounding: var 1/12 + 1/12 -> RMS 0.408
    (DitherType.RECTANGULAR, 0.38, 0.44),
])
def test_dither_statistics_and_reproducible(dither, lo, hi):
    """Error against the undithered f32 * 2**23: TPDF RMS 0.45-0.55 LSB,
    mean below 0.01 LSB; the same key draws the same noise, another
    tile's key other noise."""
    chain = get_chain(*E64)
    tile = 16384
    x = torch.from_numpy(_tiles(10, 1, tile=tile)[0])
    halo = tfused.init_fused_halo(chain, 2)
    cfg = _cfg(tile=tile, dither=dither, level=-6.0)
    step = tfused.make_fused_step(chain, cfg, "cpu")
    k0, k1 = philox.tile_key(42, 0), philox.tile_key(42, 1)
    w0, _, _ = step(x, halo, k0)
    w0b, _, _ = step(x, halo, k0)
    w1, _, _ = step(x, halo, k1)
    assert torch.equal(w0, w0b)
    assert not torch.equal(w0, w1)
    f = tfused.fused_div8_cascade(x, halo, _taps(chain), chain,
                                  tfused._gain32(cfg)).numpy().T.reshape(-1)
    f = f.astype(np.float64) * 2 ** 23
    errs = []
    for w in (w0, w1):
        e = _decode24(w.numpy().tobytes()) - f
        errs.append(e[np.abs(f) < 2 ** 23 - 4])
    e = np.concatenate(errs)
    assert e.size > 60000
    rms = float(np.sqrt(np.mean(e ** 2)))
    assert lo < rms < hi
    assert abs(float(np.mean(e))) < 0.01


# -- the wrapper -------------------------------------------------------------

def test_wrapper_cpu_runs_plain_and_counts_no_launch():
    chain = get_chain(*E64)
    step = tfused.make_fused_step(chain, _cfg(4096), "cpu")
    halo_bytes = tfused.chain_halo_bytes(chain)
    before = tfused.KERNEL_LAUNCHES
    x = torch.from_numpy(_tiles(11, 1, tile=4096)[0])
    halo = tfused.init_fused_halo(chain, 2)
    wire, peak, new_halo = step(x, halo, 0)
    ref = tfused.fused_div8_reference(x, halo, 0, _taps(chain), chain,
                                      _cfg(4096))
    assert torch.equal(wire, ref[0]) and float(peak) == float(ref[1])
    assert torch.equal(new_halo, x[:, -halo_bytes:])
    assert tfused.KERNEL_LAUNCHES == before
    with pytest.raises(ValueError):
        step(x[:, :2048].contiguous(), halo, 0)
    with pytest.raises(ValueError):
        step(x.to(torch.int16), halo, 0)


@pytest.mark.parametrize("bad", [
    dict(bit_depth=16), dict(bit_depth=32), dict(dither=DitherType.FPD),
    dict(dither=DitherType.NJAD), dict(tile_bytes=64),
])
def test_unported_step_configs_raise(bad):
    chain = get_chain(*E64)
    kw = dict(channels=2, tile_bytes=4096, bit_depth=24,
              dither=DitherType.TPDF, level_db=0.0)
    kw.update(bad)
    with pytest.raises(ConfigError):
        tfused.make_fused_step(chain, StepConfig(**kw), "cpu")


@pytest.mark.parametrize("key", [
    (FilterType.EQUIRIPPLE, DsdRate.DSD64, 176400),
    (FilterType.EQUIRIPPLE, DsdRate.DSD64, 96000),
])
def test_chains_beyond_div8_raise(key):
    chain = get_chain(*key)
    assert tfused.fused_plan(chain) is None
    with pytest.raises(ConfigError):
        tfused.make_fused_step(chain, _cfg(4096), "cpu")
