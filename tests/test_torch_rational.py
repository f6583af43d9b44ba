"""The port's 48k-family step (dsd2dxd_tpu_torch/ops/rational.py and the
K1e/K2 wrappers in ops/fused.py) on the CPU, against the JAX package: the
×160/147 band, its table by phase and its tail (the plain version of the
finish kernel's fused mode, a torch emulation of that kernel's block
route, and the dense matmul), the finish (JAX ``make_finish_planes`` in
interpret mode and ``finish_tile``), the whole step against the JAX
``make_fused_rational_step`` in interpret mode, the state handover, the
dither statistics, the masked peak, the TF32 guard and the build digest.
The kernels themselves run on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsd2dxd_tpu.filters.design import get_chain as jget_chain
from dsd2dxd_tpu.formats import dsd_types as jtypes
from dsd2dxd_tpu.ops import fused as jfused
from dsd2dxd_tpu.ops import phase as jphase
from dsd2dxd_tpu.ops.resample import StepConfig as JStepConfig
from dsd2dxd_tpu.pipeline.transfer import interleave_planes
from dsd2dxd_tpu_torch import kernels
from dsd2dxd_tpu_torch.filters.design import chain_ratio, get_chain
from dsd2dxd_tpu_torch.formats.dsd_types import DitherType, DsdRate, FilterType
from dsd2dxd_tpu_torch.ops import fused as tfused
from dsd2dxd_tpu_torch.ops import philox
from dsd2dxd_tpu_torch.ops import rational as trational
from dsd2dxd_tpu_torch.ops.plan import state_from_jax, tree_sum
from dsd2dxd_tpu_torch.ops.resample import StepConfig
from dsd2dxd_tpu_torch.pipeline import engine as tengine
from dsd2dxd_tpu_torch.utils.errors import ConfigError

E = FilterType.EQUIRIPPLE
CHAINS_48K = [(E, rate, out)
              for rate in (DsdRate.DSD64, DsdRate.DSD128, DsdRate.DSD256)
              for out in (96000, 192000, 384000)]
E64_384 = (E, DsdRate.DSD64, 384000)
TILE = 18816    # 128 band blocks of E DSD64 -> 384k (÷8 head): 20480 frames
LEVEL = -1.5


def _id(k):
    return f"{k[1].name}-{k[2] // 1000}k"


def _cfg(bits=24, dither=DitherType.NONE, tile=TILE, level=LEVEL):
    return StepConfig(channels=2, tile_bytes=tile, bit_depth=bits,
                      dither=dither, level_db=level)


def _jcfg(bits=24, dither=DitherType.NONE, tile=TILE, level=LEVEL):
    return JStepConfig(channels=2, tile_bytes=tile, bit_depth=bits,
                       dither=jtypes.DitherType[dither.name], level_db=level)


def _jchain(key):
    """The JAX package's chain for a port (filter, rate, out) key."""
    return jget_chain(jtypes.FilterType[key[0].name],
                      jtypes.DsdRate[key[1].name], key[2])


def _tiles(seed, n, tile=TILE):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (2, tile), dtype=np.uint8) for _ in range(n)]


def _decode(wire: torch.Tensor, bits: int, big_endian=False) -> np.ndarray:
    """Wire bytes -> (n, 2) int64 samples at the depth (20-bit shifted
    down) or float64 for 32-bit float."""
    b = wire.numpy()
    if bits == 32:
        return b.view(">f4" if big_endian else "<f4").astype(
            np.float64).reshape(-1, 2)
    if bits == 16:
        return b.view(">i2" if big_endian else "<i2").astype(
            np.int64).reshape(-1, 2)
    b = b.reshape(-1, 3).astype(np.int64)
    if big_endian:
        b = b[:, ::-1]
    v = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
    v = np.where(v >= 1 << 23, v - (1 << 24), v).reshape(-1, 2)
    return v >> 4 if bits == 20 else v


# -- (a) the plan -------------------------------------------------------------

@pytest.mark.parametrize("key", CHAINS_48K, ids=_id)
def test_band_equals_jax(key):
    """The ×160/147 band and nhist equal the JAX plan_banded_natural's,
    and every 48k chain is a ÷2^k head the kernel runs plus that stage."""
    chain, jchain = get_chain(*key), _jchain(key)
    rp = trational.rational_plan(chain)
    band, nhist = jphase.plan_banded_natural(
        jphase.build_plan(jchain[-1], p_in=1))
    np.testing.assert_array_equal(rp.band, band)
    assert rp.nhist == nhist and rp.band.dtype == np.float32
    assert (chain[-1].L, chain[-1].M) == (160, 147)
    assert (rp.p_in, rp.p_out) == (147, 160)
    assert rp.n_head == jfused.fused_rational_plan(jchain) == len(chain) - 1
    assert rp.r_head * key[2] * 147 // 160 == key[1].hz
    head = chain[:rp.n_head]
    assert tfused.chain_halo_bytes(head) == jfused.chain_halo_bytes(
        jchain[:rp.n_head])
    # the engine's tile: whole band blocks and whole kernel blocks
    tile = tengine._tile_bytes_for(chain, 1 << 20)
    assert tile * 8 % rp.unit_bits == 0 and rp.unit_bits == 147 * rp.r_head
    assert tile * 8 // rp.r_head % tfused.block_out_for(head) == 0
    assert (tile * 8 * chain_ratio(chain)).denominator == 1


def test_non_rational_chains_have_no_rational_plan():
    assert trational.rational_head_len(
        get_chain(E, DsdRate.DSD64, 352800)) is None
    with pytest.raises(ConfigError):
        trational.rational_plan(get_chain(E, DsdRate.DSD64, 176400))


# -- (b) the tail ---------------------------------------------------------------

@pytest.mark.parametrize("key", [(E, DsdRate.DSD64, out)
                                 for out in (96000, 192000, 384000)], ids=_id)
def test_rational_tail_matches_jax(key):
    """rational_tail against JAX stage_apply_rational_natural on random
    f32, three streamed tiles with the history carried: within 1e-6
    (both fp32, summed in another order), histories equal."""
    rp = trational.rational_plan(get_chain(*key))
    plan = jphase.build_plan(_jchain(key)[-1], p_in=1)
    band_t = torch.from_numpy(rp.band.T.copy())
    rng = np.random.default_rng(21)
    h_j = jphase.init_phase_hists((plan,), 2)[0]
    h_t = torch.zeros(2, rp.p_in)
    for _ in range(3):
        y = rng.uniform(-1.0, 1.0, (2, 147 * 40)).astype(np.float32)
        zj, h_j = jphase.stage_apply_rational_natural(
            jnp.asarray(y), h_j, plan, jnp.asarray(rp.band), rp.nhist)
        zt, h_t = trational.rational_tail(torch.from_numpy(y), h_t, band_t,
                                          rp.nhist)
        assert zt.shape == (2, 160 * 40)
        assert np.abs(zt.numpy() - np.asarray(zj)).max() <= 1e-6
        np.testing.assert_array_equal(h_t.numpy(), np.asarray(h_j)[:, :, 0])


def test_rational_tail_against_float64_oracle():
    """The tail over one long tile equals the f64 polyphase filter of the
    same band, zero-primed: within 2e-6 of full scale (chip_smoke.py holds
    the card's matmul to the same limit)."""
    chain = get_chain(E, DsdRate.DSD64, 192000)
    rp = trational.rational_plan(chain)
    y = np.random.default_rng(22).uniform(-1, 1, (2, 147 * 64))
    z, _ = trational.rational_tail(torch.from_numpy(y.astype(np.float32)),
                                   torch.zeros(2, rp.p_in),
                                   torch.from_numpy(rp.band.T.copy()),
                                   rp.nhist)
    yp = np.concatenate([np.zeros((2, rp.nhist)), y.astype(np.float32)],
                        axis=1)
    win = np.lib.stride_tricks.sliding_window_view(
        yp, rp.p_in + rp.nhist, axis=1)[:, ::rp.p_in]
    oracle = (win @ rp.band.T.astype(np.float64)).reshape(2, -1)
    assert np.abs(z.numpy() - oracle).max() < 2e-6


def _tail_oracle(y, hist, band, nhist):
    """The band over the history and the samples in float64 numpy."""
    p = hist.shape[1]
    yp = np.concatenate([hist[:, p - nhist:], y], axis=1).astype(np.float64)
    win = np.lib.stride_tricks.sliding_window_view(
        yp, p + nhist, axis=1)[:, ::p]
    return (win @ band.T.astype(np.float64)).reshape(y.shape[0], -1)


@pytest.mark.parametrize("key", CHAINS_48K, ids=_id)
def test_tail_table_holds_the_band(key):
    """The table by phase: T the widest row of the band (16 at 384k, 18
    at 192k, 19 at 96k), every row's T entries inside the band, the
    entries past a shorter row zero, and every nonzero of the band in
    the table exactly once (the table scattered back is the band). On
    the card the rows have an odd stride, zero-padded."""
    rp = trational.rational_plan(get_chain(*key))
    offs, coefs = rp.table
    width = rp.band.shape[1]
    n_taps = {96000: 19, 192000: 18, 384000: 16}[key[2]]
    assert coefs.shape == (160, n_taps) and coefs.dtype == np.float32
    assert offs.shape == (160,) and offs.dtype == np.int32
    assert width == 147 + rp.nhist and rp.nhist == n_taps - 1
    assert offs.min() >= 0 and offs.max() + n_taps <= width
    back = np.zeros_like(rp.band)
    for rho, o in enumerate(offs):
        back[rho, o:o + n_taps] = coefs[rho]
        row = np.flatnonzero(rp.band[rho])
        assert o <= row[0] and row[-1] < o + n_taps
        assert n_taps - 1 <= len(row) <= n_taps
    np.testing.assert_array_equal(back, rp.band)
    assert np.count_nonzero(coefs) == np.count_nonzero(rp.band)
    table = trational.kernel_table(rp)
    assert table.n_taps == n_taps and table.stride % 2 == 1
    assert table.stride in (n_taps, n_taps + 1)
    rows = table.coefs.numpy().reshape(160, table.stride)
    np.testing.assert_array_equal(rows[:, :n_taps], coefs)
    assert not rows[:, n_taps:].any()
    np.testing.assert_array_equal(table.offs.numpy(), offs)
    assert trational.tail_window_stride(rp.nhist) % 4 == 0
    assert (trational.tail_window_stride(rp.nhist)
            >= rp.nhist + 147 * trational.TAIL_BLOCKS)


def test_kernel_table_refuses_other_tap_counts():
    """K2 has an unrolled case for the cached chains' 16, 18 and 19
    entries per phase and no other: a band whose widest row has 17 (the
    96k band with each row's first one or two entries removed) gets no
    table for the card, while the plain version sums it all the same."""
    import dataclasses

    rp = trational.rational_plan(get_chain(FilterType.EQUIRIPPLE,
                                           DsdRate.DSD64, 96000))
    band = rp.band.copy()
    for row in band:
        nz = np.flatnonzero(row)
        row[nz[:len(nz) - 17]] = 0.0
    rp17 = dataclasses.replace(rp, band=band)
    assert rp17.table[1].shape == (160, 17)
    with pytest.raises(ConfigError, match="16, 18, 19"):
        trational.kernel_table(rp17)
    y = torch.from_numpy(np.random.default_rng(5).uniform(
        -1, 1, (2, 147 * 3)).astype(np.float32))
    z, _hist = trational.rational_tail_reference(y, torch.zeros(2, 147), rp17)
    want = _tail_oracle(y.numpy(), np.zeros((2, 147)), band, rp.nhist)
    np.testing.assert_allclose(z.numpy(), want, atol=2e-6)


@pytest.mark.parametrize("key", CHAINS_48K, ids=_id)
def test_tail_reference_matches_jax_oracle_and_matmul(key):
    """rational_tail_reference (T-tap tree sums per phase) on three
    streamed tiles with the history carried: within 2e-6 of JAX
    stage_apply_rational_natural, of the float64 oracle and of
    rational_tail (the dense matmul); all fp32 sums of the same 15-19
    products in other orders. Histories equal."""
    rp = trational.rational_plan(get_chain(*key))
    plan = jphase.build_plan(_jchain(key)[-1], p_in=1)
    band_t = torch.from_numpy(rp.band.T.copy())
    rng = np.random.default_rng(41)
    h_j = jphase.init_phase_hists((plan,), 2)[0]
    h_t = torch.zeros(2, rp.p_in)
    for _ in range(3):
        y = rng.uniform(-1.0, 1.0, (2, 147 * 13)).astype(np.float32)
        zj, h_j = jphase.stage_apply_rational_natural(
            jnp.asarray(y), h_j, plan, jnp.asarray(rp.band), rp.nhist)
        zo = _tail_oracle(y, h_t.numpy(), rp.band, rp.nhist)
        zm, h_m = trational.rational_tail(torch.from_numpy(y), h_t, band_t,
                                          rp.nhist)
        zt, h_t = trational.rational_tail_reference(torch.from_numpy(y), h_t,
                                                    rp)
        assert zt.shape == (2, 160 * 13) and zt.dtype == torch.float32
        assert np.abs(zt.numpy() - np.asarray(zj)).max() <= 2e-6
        assert np.abs(zt.numpy() - zo).max() <= 2e-6
        assert float((zt - zm).abs().max()) <= 2e-6
        assert torch.equal(h_t, h_m)
        np.testing.assert_array_equal(h_t.numpy(), np.asarray(h_j)[:, :, 0])
    with pytest.raises(ValueError):
        trational.rational_tail_reference(torch.zeros(2, 148), h_t, rp)


def _emulate_tail_kernel(y, hist, rp, gain, key, cfg, big_endian, n_valid):
    """The finish kernel's fused mode, block by block, in torch: a run of
    TAIL_BLOCKS band blocks loads its window (the run's samples from slot
    `pad` on, the nhist samples before them from y or, at the tile's
    start, from the history), item (c, rho) sums phase rho of every band
    block of the run from the table, the words go to the run's staging
    buffer at ((160 b + rho) C + c) bps in wire order, and the run's
    160 nb C bps bytes are flushed. Returns (wire bytes, peak)."""
    offs, coefs = rp.table
    n_taps = coefs.shape[1]
    c, n = y.shape
    blocks = n // 147
    nb_run = trational.TAIL_BLOCKS
    bps = {16: 2, 20: 3, 24: 3, 32: 4}[cfg.bit_depth]
    pad = -(-rp.nhist // 4) * 4
    stride = trational.tail_window_stride(rp.nhist)
    h = torch.from_numpy(coefs)
    base = torch.from_numpy(offs.astype(np.int64)) + (pad - rp.nhist)
    idx = base[None, :] + 147 * torch.arange(nb_run)[:, None]  # (B, 160)
    z = torch.full((c, 160 * blocks), float("nan"))
    n_runs = -(-blocks // nb_run)
    for r in range(n_runs):
        nb = min(nb_run, blocks - r * nb_run)
        s0 = 147 * nb_run * r
        win = torch.zeros(c, stride)  # past the run's samples: never used
        win[:, pad:pad + 147 * nb] = y[:, s0:s0 + 147 * nb]
        for i in range(rp.nhist):
            s = s0 - rp.nhist + i
            win[:, pad - rp.nhist + i] = (y[:, s] if s >= 0
                                          else hist[:, 147 + s])
        v = tree_sum(win[:, idx + t] * h[:, t] for t in range(n_taps))
        z[:, 640 * r:640 * r + 160 * nb] = v[:, :nb].reshape(c, -1)
    yv = z * gain
    words = tfused.epilogue_words(yv, key, cfg).numpy().astype(np.int64)
    out = np.zeros(160 * blocks * c * bps, dtype=np.uint8)
    for r in range(n_runs):
        nb = min(nb_run, blocks - r * nb_run)
        stage = np.zeros(640 * c * bps, dtype=np.uint8)
        for ch in range(c):
            for b in range(nb):
                w = words[ch, 640 * r + 160 * b:640 * r + 160 * (b + 1)]
                w = w & 0xFFFFFFFF
                if big_endian:  # byte-swap, then down to the low bps bytes
                    w = (((w & 0xFF) << 24) | ((w & 0xFF00) << 8)
                         | ((w >> 8) & 0xFF00) | (w >> 24)) >> (32 - 8 * bps)
                at = ((160 * b + np.arange(160)) * c + ch) * bps
                for k in range(bps):
                    stage[at + k] = (w >> (8 * k)) & 0xFF
        nbytes = 160 * nb * c * bps
        out[640 * r * c * bps:640 * r * c * bps + nbytes] = stage[:nbytes]
    return torch.from_numpy(out), tfused.masked_peak(yv, n_valid)


@pytest.mark.parametrize("big_endian", [False, True], ids=["LE", "BE"])
@pytest.mark.parametrize("bits,dither,out_hz,blocks", [
    (16, DitherType.TPDF, 96000, 9),      # 2 bytes; a ragged last run of 1
    (20, DitherType.NONE, 192000, 6),     # 3 bytes, << 4; ragged run of 2
    (24, DitherType.RECTANGULAR, 384000, 8),   # whole runs only
    (32, DitherType.FPD, 96000, 3),       # 4 bytes; one run, shorter
])
def test_tail_kernel_block_route_equals_plain(bits, dither, out_hz, blocks,
                                              big_endian):
    """The emulated block route of the finish kernel's fused mode is
    bit-equal to its plain version (rational_tail_reference, then
    finish_reference) on two streamed tiles: the first takes its window
    from a non-zero history, later runs from the samples before them; the
    peak is masked inside a run."""
    rp = trational.rational_plan(get_chain(E, DsdRate.DSD64, out_hz))
    cfg = _cfg(bits, dither)
    gain = tfused._gain32(cfg)
    rng = np.random.default_rng(44)
    hist = torch.from_numpy(rng.uniform(-1, 1, (2, 147)).astype(np.float32))
    n_valid = 160 * blocks - 250
    for t in range(2):
        y = torch.from_numpy(rng.uniform(-1.1, 1.1, (2, 147 * blocks)
                                         ).astype(np.float32))
        y[:, -147:] *= 3.0  # the loudest frames lie past n_valid
        key = philox.tile_key(45, t)
        z, new_hist = trational.rational_tail_reference(y, hist, rp)
        wr, pr = tfused.finish_reference(z, gain, key, cfg, big_endian,
                                         n_valid)
        we, pe = _emulate_tail_kernel(y, hist, rp, gain, key, cfg,
                                      big_endian, n_valid)
        assert torch.equal(we, wr)
        assert float(pe) == float(pr)
        if t == 0:
            assert float(pr) < float((z * gain).abs().max())
        hist = new_hist


def test_tf32_is_refused(monkeypatch):
    trational.check_fp32_matmul()  # the default: full fp32
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with pytest.raises(ConfigError, match="fp32"):
            trational.check_fp32_matmul()
    finally:
        torch.set_float32_matmul_precision(prev)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True,
                        raising=False)
    with pytest.raises(ConfigError, match="fp32"):
        trational.check_fp32_matmul()


# -- (c) the finish ------------------------------------------------------------

def _final_samples(seed, n=2048):
    """(2, n) f32 final-rate samples, some beyond full scale (clipped)."""
    z = np.random.default_rng(seed).uniform(-1.2, 1.2, (2, n))
    return z.astype(np.float32)


@pytest.mark.parametrize("bits", [16, 24])
def test_finish_bit_equal_to_jax_finish_planes(bits):
    """finish_reference at NONE dither against the JAX Pallas finish
    (make_finish_planes, interpret mode) through the host interleaver:
    wire bytes equal in both byte orders, peaks equal."""
    z = _final_samples(23)
    fin, layout = jfused.make_finish_planes(_jcfg(bits), z.shape[1],
                                            interpret=True)
    planes, pj = fin(jnp.asarray(z), 0)
    gain = tfused._gain32(_cfg(bits))
    for be in (False, True):
        wire, pt = tfused.finish_reference(torch.from_numpy(z), gain, 5,
                                           _cfg(bits), be)
        ref = interleave_planes(np.asarray(planes), layout, z.shape[1], be)
        assert wire.numpy().tobytes() == ref
        assert float(pt) == float(pj)


def test_finish_f32_bit_equal_to_jax_finish_tile():
    """32-bit NONE: the JAX XLA finish (phase.finish_tile) and the port's
    give the same f32 bits and peak; a partial tile's peak covers the
    first n_valid frames."""
    z = _final_samples(24)
    cfg = _cfg(32)
    out, pj = jphase.finish_tile(jnp.asarray(z), _jcfg(32),
                                 jax.random.PRNGKey(0),
                                 10.0 ** (LEVEL / 20.0))
    wire, pt = tfused.finish_reference(torch.from_numpy(z),
                                       tfused._gain32(cfg), 5, cfg)
    np.testing.assert_array_equal(wire.numpy().view("<f4").reshape(-1, 2),
                                  np.asarray(out))
    assert float(pt) == float(pj)
    _w, pn = tfused.finish_reference(torch.from_numpy(z), 1.0, 5, cfg,
                                     n_valid=100)
    assert float(pn) == float(np.abs(z[:, :100]).max())


# -- (d), (e) the whole step against the JAX step, and the state handover -----

@pytest.fixture(scope="module")
def jax_rational_runs():
    """The JAX rational step (interpret mode, frames out) over three
    random tiles of E DSD64 -> 384k at level -1.5 dB, f32 and 24-bit
    NONE: outputs, peaks and the state after each tile, as numpy."""
    chain = _jchain(E64_384)
    g = jfused.fused_plan(chain[:-1])[1]
    xs = _tiles(25, 3)
    runs = {}
    for bits in (32, 24):
        jstep, halo_bytes = jfused.make_fused_rational_step(
            chain, _jcfg(bits), block_bytes=2688, interpret=True)
        assert halo_bytes == tfused.chain_halo_bytes(
            get_chain(*E64_384)[:-1])
        halo, hist = jfused.init_fused_rational_state(chain, 2)
        state = (jnp.asarray(halo), hist)
        outs, peaks, states = [], [], []
        for t, x in enumerate(xs):
            o, p, state = jstep(jfused.prep_input(x, g), state, t)
            outs.append(np.asarray(o))
            peaks.append(float(p))
            states.append((np.asarray(state[0]), np.asarray(state[1])))
        runs[bits] = (outs, peaks, states)
    return xs, runs


@pytest.mark.parametrize("bits,tol", [(32, 2e-6), (24, 3)])
def test_step_matches_jax_rational_step(jax_rational_runs, bits, tol):
    """The port's CPU step against the JAX step, both idle-primed with a
    zero tail history (so no head is skipped): f32 within 2e-6, 24-bit
    NONE within 3 LSB (the two tails sum their 162 products in other
    orders, as tests/test_fused.py allows the JAX paths), peaks within
    1e-6, the state equal to the JAX state after every tile."""
    chain = get_chain(*E64_384)
    xs, runs = jax_rational_runs
    outs, peaks, states = runs[bits]
    step = trational.make_rational_step(chain, _cfg(bits), "cpu")
    state = trational.init_rational_state(chain, 2)
    j0 = state_from_jax(jfused.init_fused_rational_state(_jchain(E64_384),
                                                         2))
    assert torch.equal(j0[0], state[0]) and torch.equal(j0[1], state[1])
    for t, x in enumerate(xs):
        wire, peak, state = step(torch.from_numpy(x), state, t)
        got = _decode(wire, bits)
        assert got.shape == outs[t].shape == (20480, 2)
        assert np.abs(got - outs[t]).max() <= tol
        assert abs(float(peak) - peaks[t]) <= 1e-6
        js = state_from_jax(states[t])
        assert torch.equal(js[0], state[0])
        assert float((js[1] - state[1]).abs().max()) <= 1e-6


def test_jax_state_hands_over(jax_rational_runs):
    """The JAX state after tile 1, through state_from_jax, continues in
    the port with JAX's tile-2 output."""
    chain = get_chain(*E64_384)
    xs, runs = jax_rational_runs
    outs, peaks, states = runs[32]
    state = state_from_jax(states[1])
    assert state[0].dtype == torch.uint8 and state[1].shape == (2, 147)
    step = trational.make_rational_step(chain, _cfg(32), "cpu")
    wire, peak, _ = step(torch.from_numpy(xs[2]), state, 2)
    assert np.abs(_decode(wire, 32) - outs[2]).max() <= 2e-6
    assert abs(float(peak) - peaks[2]) <= 1e-6


def test_streaming_equals_one_long_tile():
    """Two tiles with the carried (halo, history) give the same samples
    as one tile of twice the length (f32 NONE: the head is bit-equal,
    the tail within 1e-6 as matmuls of two shapes)."""
    chain = get_chain(*E64_384)
    x = np.concatenate(_tiles(26, 2, tile=1176), axis=1)
    long_step = trational.make_rational_step(chain, _cfg(32, tile=2352),
                                             "cpu")
    short = trational.make_rational_step(chain, _cfg(32, tile=1176), "cpu")
    whole, pk, _ = long_step(torch.from_numpy(x),
                             trational.init_rational_state(chain, 2), 0)
    s = trational.init_rational_state(chain, 2)
    a, pa, s = short(torch.from_numpy(x[:, :1176].copy()), s, 0)
    b, pb, s = short(torch.from_numpy(x[:, 1176:].copy()), s, 0)
    assert np.abs(_decode(torch.cat([a, b]), 32)
                  - _decode(whole, 32)).max() <= 1e-6
    assert abs(max(float(pa), float(pb)) - float(pk)) <= 1e-6


# -- (f) dither statistics on the rational plain path -------------------------

def _undithered(chain, x, state, level=-6.0):
    """The step's f32 samples without dither, and the state after."""
    step = trational.make_rational_step(
        chain, _cfg(32, tile=x.shape[1], level=level), "cpu")
    wire, _p, new = step(torch.from_numpy(x), state, 0)
    return _decode(wire, 32).reshape(-1), new


@pytest.mark.parametrize("dither,lo,hi", [
    (DitherType.TPDF, 0.45, 0.55),
    (DitherType.RECTANGULAR, 0.38, 0.44),
])
def test_int_dither_statistics(dither, lo, hi):
    """24-bit TPDF/RECT on the rational step: error against the
    undithered f32 * 2^23 with RMS in the limits, mean below 0.01 LSB;
    the same key draws the same noise, another tile's key other noise."""
    chain = get_chain(*E64_384)
    tile = 4 * TILE
    x = _tiles(27, 1, tile=tile)[0]
    state = trational.init_rational_state(chain, 2)
    f, _ = _undithered(chain, x, state)
    step = trational.make_rational_step(
        chain, _cfg(24, dither, tile=tile, level=-6.0), "cpu")
    k0, k1 = philox.tile_key(42, 0), philox.tile_key(42, 1)
    w0, _, _ = step(torch.from_numpy(x), state, k0)
    assert torch.equal(w0, step(torch.from_numpy(x), state, k0)[0])
    w1, _, _ = step(torch.from_numpy(x), state, k1)
    assert not torch.equal(w0, w1)
    f = f * 2.0 ** 23
    errs = [(_decode(w, 24).reshape(-1) - f)[np.abs(f) < 2 ** 23 - 4]
            for w in (w0, w1)]
    e = np.concatenate(errs)
    assert e.size > 300000
    rms = float(np.sqrt(np.mean(e ** 2)))
    assert lo < rms < hi
    assert abs(float(e.mean())) < 0.01


def test_fpd_statistics():
    """32-bit FPD on the rational step: every sample within 1 ulp of the
    undithered one, error mean below 0.01 ulp, a quarter of the samples
    moved; the key decides the noise."""
    chain = get_chain(*E64_384)
    tile = 4 * TILE
    x = _tiles(28, 1, tile=tile)[0]
    state = trational.init_rational_state(chain, 2)
    y, _ = _undithered(chain, x, state)
    step = trational.make_rational_step(
        chain, _cfg(32, DitherType.FPD, tile=tile, level=-6.0), "cpu")
    k0, k1 = philox.tile_key(43, 0), philox.tile_key(43, 1)
    w0 = step(torch.from_numpy(x), state, k0)[0]
    w1 = step(torch.from_numpy(x), state, k1)[0]
    assert not torch.equal(w0, w1)
    ulp = np.spacing(np.abs(y).astype(np.float32)).astype(np.float64)
    e = np.concatenate([(_decode(w, 32).reshape(-1) - y) / ulp
                        for w in (w0, w1)])
    assert np.all(np.abs(e) <= 1.0)
    assert abs(float(e.mean())) < 0.01
    assert 0.2 < np.mean(e != 0) < 0.3


# -- the step's contract ---------------------------------------------------------

def test_partial_tile_peak_masked():
    """A burst ends mid-tile and the idle pad follows: the final samples
    past n_valid ring, but the peak covers the first n_valid only."""
    chain = get_chain(E, DsdRate.DSD64, 192000)
    rp = trational.rational_plan(chain)
    tile = rp.unit_bits // 8 * 8                 # 8 band blocks
    x = np.full((2, tile), tfused.IDLE_BYTE, dtype=np.uint8)
    n_out = int(tile * 8 * chain_ratio(chain))
    n_valid = n_out - 200
    end = n_valid * 147 // 160 * 2               # head frames of 2 bytes
    x[:, end - 16:end] = 0xFF
    state = trational.init_rational_state(chain, 2)
    step = trational.make_rational_step(
        chain, _cfg(32, tile=tile, level=0.0), "cpu")
    wire, masked, _ = step(torch.from_numpy(x), state, 0, n_valid)
    _w, whole, _ = step(torch.from_numpy(x), state, 0)
    z = np.abs(_decode(wire, 32))
    assert float(masked) == z[:n_valid].max()
    assert float(whole) == z.max() > float(masked) + 0.1
    assert float(step(torch.from_numpy(x), state, 0, 0)[1]) == 0.0


def test_wrapper_cpu_runs_plain_and_counts_no_launch():
    chain = get_chain(*E64_384)
    step = trational.make_rational_step(chain, _cfg(24, DitherType.TPDF),
                                        "cpu")
    state = trational.init_rational_state(chain, 2)
    before = dict(tfused.MODE_LAUNCHES), tfused.KERNEL_LAUNCHES
    x = torch.from_numpy(_tiles(29, 1)[0])
    wire, peak, (halo, hist) = step(x, state, 7)
    assert wire.numel() == 20480 * 2 * 3 and 0 < float(peak)
    assert torch.equal(halo, x[:, -tfused.chain_halo_bytes(chain[:-1]):])
    assert hist.shape == (2, 147) and hist.dtype == torch.float32
    assert (dict(tfused.MODE_LAUNCHES), tfused.KERNEL_LAUNCHES) == before
    with pytest.raises(ValueError):
        step(x[:, :1176].contiguous(), state, 0)
    with pytest.raises(ValueError):
        step(x, (state[0], state[1].double()), 0)


@pytest.mark.parametrize("bad", [
    dict(bit_depth=16, dither=DitherType.FPD), dict(dither=DitherType.NJAD),
    dict(bit_depth=32, dither=DitherType.TPDF),
    dict(tile_bytes=TILE + 1),    # not whole band blocks
    dict(bit_depth=12),
])
def test_unported_step_configs_raise(bad):
    kw = dict(channels=2, tile_bytes=TILE, bit_depth=24,
              dither=DitherType.TPDF, level_db=0.0)
    kw.update(bad)
    with pytest.raises(ConfigError):
        trational.make_rational_step(get_chain(*E64_384), StepConfig(**kw),
                                     "cpu")


@pytest.mark.parametrize("bits,dither", [
    (16, DitherType.RECTANGULAR), (20, DitherType.TPDF),
    (24, DitherType.NONE), (32, DitherType.FPD)])
def test_step_covers_every_epilogue(bits, dither):
    """Each epilogue runs on a ÷128-head chain (DSD256 -> 96k), emits
    n_base * 160 / 147 frames of its width, and big endian is the byte
    reverse of little endian."""
    chain = get_chain(E, DsdRate.DSD256, 96000)
    tile = trational.rational_plan(chain).unit_bits // 8 * 2
    cfg = _cfg(bits, dither, tile=tile)
    x = torch.from_numpy(_tiles(30, 1, tile=tile)[0])
    state = trational.init_rational_state(chain, 2)
    wire, peak, _ = trational.make_rational_step(chain, cfg, "cpu")(
        x, state, 9)
    bps = {16: 2, 20: 3, 24: 3, 32: 4}[bits]
    assert wire.numel() == tile * 8 // 128 * 160 // 147 * 2 * bps
    be = trational.make_rational_step(chain, cfg, "cpu", big_endian=True)
    assert torch.equal(be(x, state, 9)[0].reshape(-1, bps),
                       wire.reshape(-1, bps).flip(1))
    assert 0.0 < float(peak)


# -- the build digest ------------------------------------------------------------

def test_digest_covers_every_csrc_file(tmp_path):
    """An edit to a header alone (csrc/epilogue.cuh, which both kernels
    include, as they do csrc/tree_sum.cuh) changes the library's name, so
    no stale build is loaded."""
    assert set(kernels.SOURCES) == {"fused_decim.cu", "finish.cu",
                                   "probes.cu"}
    assert sorted(f.name for f in kernels.CSRC.glob("*.cuh")) == [
        "device_check.cuh", "epilogue.cuh", "tree_sum.cuh"]
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    before = kernels._digest(csrc)
    assert before == kernels._digest()
    with open(csrc / "epilogue.cuh", "a") as f:
        f.write("\n// edited\n")
    assert kernels._digest(csrc) != before
    (csrc / "epilogue.cuh").unlink()
    assert kernels._digest(csrc) not in (before, kernels._digest())
