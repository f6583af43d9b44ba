"""The fused decimation step of the port (dsd2dxd_tpu_torch/ops/fused.py)
against the JAX fused Pallas step, run in interpret mode on the CPU as
tests/test_fused.py runs it, and against the JAX phase path; plus the
Philox generator, the dither statistics, the epilogues, the masked peak,
and the CUDA kernel's block layout (emulated here; the kernel itself runs
on the card in tests/test_torch_cuda.py)."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsd2dxd_tpu.containers.pack import pack_int
from dsd2dxd_tpu.filters.design import get_chain as jget_chain
from dsd2dxd_tpu.formats import dsd_types as jtypes
from dsd2dxd_tpu.ops import fused as jfused
from dsd2dxd_tpu.ops.phase import (
    build_chain_plans,
    init_phase_hists,
    make_phase_step,
)
from dsd2dxd_tpu.ops.resample import StepConfig as JStepConfig
from dsd2dxd_tpu.ops.resample import quantize_int as jquantize_int
from dsd2dxd_tpu.pipeline.transfer import interleave_planes_numpy
from dsd2dxd_tpu_torch import kernels
from dsd2dxd_tpu_torch.filters.design import chain_ratio, get_chain
from dsd2dxd_tpu_torch.formats.dsd_types import DitherType, DsdRate, FilterType
from dsd2dxd_tpu_torch.ops import fused as tfused
from dsd2dxd_tpu_torch.ops import philox, rational
from dsd2dxd_tpu_torch.ops.plan import state_from_jax, tree_sum
from dsd2dxd_tpu_torch.ops.resample import StepConfig
from dsd2dxd_tpu_torch.utils.errors import ConfigError

E64 = (FilterType.EQUIRIPPLE, DsdRate.DSD64, 352800)
X64 = (FilterType.XLD, DsdRate.DSD64, 352800)
D64 = (FilterType.DSD2PCM, DsdRate.DSD64, 352800)
E128 = (FilterType.EQUIRIPPLE, DsdRate.DSD128, 705600)
E64_176 = (FilterType.EQUIRIPPLE, DsdRate.DSD64, 176400)    # ÷16, G=2
E64_88 = (FilterType.EQUIRIPPLE, DsdRate.DSD64, 88200)      # ÷32, G=4
X64_88 = (FilterType.XLD, DsdRate.DSD64, 88200)             # ÷32
E128_88 = (FilterType.EQUIRIPPLE, DsdRate.DSD128, 88200)    # ÷64, à-trous
C128_88 = (FilterType.CHEBYSHEV, DsdRate.DSD128, 88200)     # ÷64
E256_88 = (FilterType.EQUIRIPPLE, DsdRate.DSD256, 88200)    # ÷128
E512_352 = (FilterType.EQUIRIPPLE, DsdRate.DSD512, 352800)  # ÷64
TILE = 16384 * 2   # two JAX grid blocks, as tests/test_fused.py
LEVEL = -1.5


def _jchain(key):
    """The JAX package's chain for a port (filter, rate, out) key: the
    JAX side of every comparison runs on its own tables and enums."""
    return jget_chain(jtypes.FilterType[key[0].name],
                      jtypes.DsdRate[key[1].name], key[2])


def _all_decimation_chains():
    """Every pure-decimation chain get_chain returns (all 20)."""
    keys = []
    for filt, rate, out in itertools.product(
            FilterType, DsdRate, (88200, 176400, 352800, 705600, 1411200)):
        try:
            chain = get_chain(filt, rate, out)
        except Exception:
            continue
        if all(s.L == 1 for s in chain):
            keys.append((filt, rate, out))
    return keys


ALL_CHAINS = _all_decimation_chains()


def _key_id(k):
    return f"{k[0].name[0]}-{k[1].name}-{k[2]}"


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


def _cfg(tile=TILE, dither=DitherType.NONE, level=LEVEL, channels=2,
         bit_depth=24):
    return StepConfig(channels=channels, tile_bytes=tile,
                      bit_depth=bit_depth, dither=dither, level_db=level)


def _decode(wire: torch.Tensor, bit_depth: int, big_endian=False):
    """(T*C*bps,) wire bytes -> int64 samples at the depth (20-bit
    shifted back down) or float64 for 32-bit float."""
    b = wire.numpy()
    if bit_depth == 32:
        return b.view(">f4" if big_endian else "<f4").astype(np.float64)
    if bit_depth == 16:
        return b.view(">i2" if big_endian else "<i2").astype(np.int64)
    v = _decode24(b.tobytes(), big_endian)
    return v >> 4 if bit_depth == 20 else v


@pytest.mark.parametrize("key,channels", [
    pytest.param(E64, 2, id="E"), pytest.param(X64, 2, id="X"),
    pytest.param(D64, 2, id="D"), pytest.param(E64, 1, id="E-mono"),
    pytest.param(E64, 3, id="E-3ch"), pytest.param(E64, 6, id="E-6ch")])
def test_plain_cascade_matches_jax_fused_float(key, channels):
    """Both idle-primed: no head skip. Three tiles, state carried; the
    ÷8 chain at 1, 3 and 6 channels too (DSF carries 1-6; K1 takes the
    channel from the grid)."""
    chain, jchain = get_chain(*key), _jchain(key)
    jcfg = JStepConfig(channels=channels, tile_bytes=TILE, bit_depth=32,
                       dither=jtypes.DitherType.NONE, level_db=LEVEL)
    jstep, halo_bytes = jfused.make_fused_step(jchain, jcfg, interpret=True)
    assert halo_bytes == tfused.chain_halo_bytes(chain)
    h_j = jnp.asarray(jfused.init_fused_halo(jchain, channels))
    h_t = tfused.init_fused_halo(chain, channels)
    np.testing.assert_array_equal(h_t.numpy(), np.asarray(h_j))
    gain = tfused._gain32(_cfg(channels=channels))
    for t, x in enumerate(_tiles(5, 3, channels)):
        oj, pj, h_j = jstep(x, h_j, t)
        y = tfused.fused_decim_cascade(torch.from_numpy(x), h_t, _taps(chain),
                                       chain, gain)
        h_t = torch.from_numpy(x[:, -halo_bytes:].copy())
        assert np.max(np.abs(y.numpy().T - np.asarray(oj))) <= 2e-6
        assert abs(float(y.abs().max()) - float(pj)) <= 1e-4
        np.testing.assert_array_equal(h_t.numpy(), np.asarray(h_j))


def test_fused_24bit_matches_jax_planes_and_state_handover():
    """24-bit NONE against JAX emit="planes" + the host interleaver, both
    byte orders; then JAX tile 0 -> state_from_jax -> port tile 1."""
    chain, jchain = get_chain(*E64), _jchain(E64)
    jcfg = JStepConfig(channels=2, tile_bytes=TILE, bit_depth=24,
                       dither=jtypes.DitherType.NONE, level_db=LEVEL)
    jstep, halo_bytes, layout = jfused.make_fused_step(
        jchain, jcfg, interpret=True, emit="planes")
    steps = {be: tfused.make_fused_step(chain, _cfg(), "cpu", big_endian=be)
             for be in (False, True)}
    x0, x1 = _tiles(6, 2)
    h_j = jnp.asarray(jfused.init_fused_halo(jchain, 2))
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
    """K1's block route in torch, as the kernel takes it: each (block,
    channel) copies the bytes `kernel_layout` names as big-endian words
    (from up to 15 bytes early when the window lies inside the tile, as
    the kernel's 16-byte copy does from an aligned address: here an offset
    that varies by block), stage 0 reads each output's bits through a
    funnel shift and its tap groups through `stage0_tables`, summed
    pairwise, and each ÷2 stage computes its n_out outputs. Must equal the
    plain cascade bit for bit."""
    c, t = x.shape
    hb = halo.shape[1]
    lay = tfused.kernel_layout(chain, hb, block_out)
    fb, n_load, q = lay.frame_bytes, lay.n_load_bytes, lay.n_groups
    t_out = t // fb
    idle = torch.full((c, n_load + block_out * fb + 32), tfused.IDLE_BYTE,
                      dtype=torch.uint8)
    window = torch.cat([torch.zeros((c, 16), dtype=torch.uint8), halo, x,
                        idle], dim=1)  # 16 bytes before the halo: unread
    taps = _taps(chain)
    tables = tfused.stage0_tables(taps[0])
    assert tables.shape == (q, 16)
    y = torch.empty(c, t_out)
    for blk, m0 in enumerate(range(0, t_out, block_out)):
        wb0 = m0 * fb + lay.byte_off
        inside = wb0 >= hb and wb0 + n_load <= hb + t
        s = (3 + 5 * blk) % 16 if inside else 0
        raw = window[:, 16 + wb0 - s:16 + wb0 - s + s + n_load + 3]
        raw = raw[:, :(raw.shape[1] // 4) * 4].to(torch.int64)
        words = ((raw[:, 0::4] << 24) | (raw[:, 1::4] << 16)
                 | (raw[:, 2::4] << 8) | raw[:, 3::4])
        words = torch.cat([words, torch.zeros((c, 4), dtype=torch.int64)],
                          dim=1)
        pos = 8 * s + lay.bit_off + lay.decim[0] * torch.arange(lay.n_out[0])
        chunks = []
        for ci in range(-(-4 * q // 32)):
            p = pos + 32 * ci
            sh = p & 31
            chunks.append(((words[:, p >> 5] << sh)
                           | (words[:, (p >> 5) + 1] >> (32 - sh)))
                          & 0xFFFFFFFF)
        v = tree_sum(
            tables[g][(chunks[(q - 1 - g) >> 3]
                       >> (28 - 4 * ((q - 1 - g) & 7))) & 15]
            for g in range(q))
        for s_i in range(1, len(chain)):
            n, o = lay.n_taps[s_i], lay.n_out[s_i]
            assert v.shape[1] == lay.n_out[s_i - 1] >= 2 * (o - 1) + n
            hk = taps[s_i].tolist()
            v = tree_sum(v[:, n - 1 - k:n - 1 - k + 2 * (o - 1) + 1:2] * hk[k]
                         for k in range(n))
        n_keep = min(block_out, t_out - m0)
        y[:, m0:m0 + n_keep] = v[:, :n_keep] * gain if gain != 1.0 \
            else v[:, :n_keep]
    return y


CHAINS_48K = [(FilterType.EQUIRIPPLE, rate, out)
              for rate in (DsdRate.DSD64, DsdRate.DSD128, DsdRate.DSD256)
              for out in (96000, 192000, 384000)]


def _head(key):
    """The chain K1 runs for a key: the whole chain, or a 48k chain's
    ÷2^k head."""
    chain = get_chain(*key)
    n = rational.rational_head_len(chain)
    return chain if n is None else chain[:n]


def _more_layout_cases():
    """Every other chain of the 20 at its kernel block, two and a half
    blocks per tile (ragged last block); three at a block of their own;
    the 9 48k heads at their block and at an odd one."""
    cases = []
    for key in ALL_CHAINS:
        if key in (E64, X64, D64, E128):
            continue
        chain = get_chain(*key)
        r = tfused.decimation(chain)
        bo = tfused.block_out_for(chain)
        cases.append(pytest.param(key, bo * r // 8 * 5 // 2, bo,
                                  id=f"{_key_id(key)}-block"))
    for key, tile, bo in [(E64_176, 1000, 37), (E256_88, 2048, 40),
                          (C128_88, 1536, 9)]:
        cases.append(pytest.param(key, tile, bo, id=f"{_key_id(key)}-{bo}"))
    for key, tile, bo in [(D64, 3001, 45), (E256_88, 4096, 101),
                          (E512_352, 2560, 77)]:
        cases.append(pytest.param(key, tile, bo, id=f"{_key_id(key)}-{bo}"))
    for key in CHAINS_48K:
        head = _head(key)
        r = tfused.decimation(head)
        bo = tfused.block_out_for(head)
        cases.append(pytest.param(key, bo * r // 8 * 5 // 2, bo,
                                  id=f"{_key_id(key)}-head-block"))
        cases.append(pytest.param(key, 129 * r // 8 * 3, 129,
                                  id=f"{_key_id(key)}-head-129"))
    return cases


@pytest.mark.parametrize("key,tile,block_out", [
    (E64, 4096, 512),
    (X64, 3000, 512),   # ragged last block
    (D64, 2048, 300),
    (E128, 1500, 700),
    *_more_layout_cases(),
])
def test_kernel_block_layout_emulated(key, tile, block_out):
    chain = _head(key)
    x = torch.from_numpy(_tiles(8, 1, tile=tile)[0])
    halo = torch.from_numpy(_tiles(9, 1, tile=tfused.chain_halo_bytes(chain))[0])
    gain = tfused._gain32(_cfg())
    ref = tfused.fused_decim_cascade(x, halo, _taps(chain), chain, gain)
    emu = _emulate_kernel_cascade(x, halo, chain, gain, block_out)
    assert torch.equal(ref, emu)


@pytest.mark.parametrize(
    "key", [E64, X64, D64, E128,
            *(k for k in ALL_CHAINS if k not in (E64, X64, D64, E128))],
    ids=["E", "X", "D", "E128",
         *(_key_id(k) for k in ALL_CHAINS if k not in (E64, X64, D64, E128))])
def test_kernel_params_fit_shared_memory(key):
    """K1's DecimParams at the chain's block: the coefficients' region,
    the window words and buffers A and B follow each other 16-byte aligned;
    the window holds stage 0's bits with room for the 16-byte copy and
    the funnel shift's next word; every stage's inputs were computed
    by the stage before, each buffer holds the outputs it takes and the
    float4 reads past them; at most 227 KB of shared memory."""
    chain = get_chain(*key)
    halo = tfused.chain_halo_bytes(chain)
    lay = tfused.kernel_layout(chain, halo, tfused.block_out_for(chain))
    p = tfused._kernel_params(chain, _cfg(tile=4096), halo,
                              0x1234_5678_9ABC_DEF0, False, 100)
    assert p.byte_off == lay.byte_off >= 0
    assert p.frame_bytes * 8 == tfused.decimation(chain)
    assert p.tile_frames == 4096 // p.frame_bytes and p.n_valid == 100
    assert (p.key0, p.key1) == (0x9ABCDEF0, 0x12345678)
    q = p.n_groups
    assert q == -(-chain[0].n_taps // 4) and p.decim0 == chain[0].M
    assert p.n_coefs == tfused.kernel_coefs(chain).numel() == 16 * q + sum(
        -(-s.n_taps // 4) * 4 for s in chain[1:])
    assert p.win == p.n_coefs + 16 and p.buf_a == p.win + lay.win_words
    assert p.buf_b == p.buf_a + lay.a_len
    assert p.smem_bytes == lay.smem_bytes == 4 * (p.buf_b + lay.b_len)
    assert all(v % 4 == 0 for v in (p.win, p.buf_a, p.buf_b, *lay.half))
    end0 = lay.bit_off + chain[0].M * (lay.n_out[0] - 1) + 4 * q
    assert 8 * lay.n_load_bytes >= end0 > 8 * (lay.n_load_bytes - 1)
    assert 4 * lay.win_words >= -(-(15 + lay.n_load_bytes) // 16) * 16 + 4
    assert lay.n_out[0] % tfused.S0_VEC == 0
    bufs = (lay.a_len, lay.b_len)
    for s in range(1, len(chain)):
        n, o = chain[s].n_taps, lay.n_out[s]
        assert chain[s].M == 2 and o % kernels.VEC == 0
        assert lay.n_out[s - 1] >= 2 * (o - 1) + n
        assert lay.half[s] >= -(-lay.n_out[s - 1] // 2)
        assert lay.half[s] >= 4 * (o // kernels.VEC - 1
                                   + (kernels.VEC - 1 + (n - 1) // 2) // 4 + 1)
        assert bufs[(s - 1) % 2] >= 2 * lay.half[s]
        assert (p.n_taps[s], p.tap_off[s], p.n_out[s], p.half[s]) == (
            n, lay.tap_off[s], o, lay.half[s])
        # the stage's f32 taps among the coefficients
        coefs = tfused.kernel_coefs(chain)
        assert torch.equal(coefs[p.tap_off[s]:p.tap_off[s] + n],
                           torch.tensor(np.asarray(chain[s].taps,
                                                   dtype=np.float32)))
        assert p.tap_off[s] % 4 == 0
    assert bufs[(len(chain) - 1) % 2] >= lay.n_out[-1] >= p.block_out
    assert p.smem_bytes <= 227 * 1024  # an H100 block's shared memory
    assert p.block_out == tfused.block_out_for(chain)
    assert p.n_stages == len(chain) <= kernels.MAX_STAGES


def _synth(scale):
    from dsd2dxd_tpu_torch.tools import synth_chain
    return synth_chain(scale)


PAD_CHAINS = ([pytest.param(lambda k=k: get_chain(*k), id=_key_id(k))
               for k in ALL_CHAINS]
              + [pytest.param(lambda k=k: _head(k), id=f"{_key_id(k)}-head")
                 for k in CHAINS_48K]
              + [pytest.param(lambda: _synth(0.0), id="synth0"),
                 pytest.param(lambda: _synth(1.0), id="synth1")])


@pytest.mark.parametrize("make_chain", PAD_CHAINS)
def test_zero_padded_taps_keep_the_tree_sum(make_chain):
    """Every stage: the pairwise tap sum over the taps zero-padded to a
    multiple of 4 has the bits of the sum over the taps, on ±1 inputs
    (stage 0's) and on f32 ones, whatever the inputs at the padded taps."""
    rng = np.random.default_rng(50)
    for st in make_chain():
        h = torch.tensor(np.asarray(st.taps, dtype=np.float32))
        n = h.numel()
        hp = torch.cat([h, h.new_zeros(-n % 4)])
        for x in (torch.from_numpy(rng.choice(
                      np.float32([-1.0, 1.0]), (256, hp.numel()))),
                  torch.from_numpy(rng.standard_normal(
                      (256, hp.numel())).astype(np.float32))):
            ref = tree_sum(x[:, k] * h[k] for k in range(n))
            got = tree_sum(x[:, k] * hp[k] for k in range(hp.numel()))
            assert torch.equal(ref.view(torch.int32), got.view(torch.int32))


@pytest.mark.parametrize("make_chain", PAD_CHAINS)
def test_stage0_tables_are_subtree_sums(make_chain):
    """Entry v of group g is the pairwise sum of h[4g + i] * (±1 by bit i
    of v) over the zero-padded taps, for all 16 sign patterns, in f32;
    and the kernel's coefficients start with these tables."""
    chain = make_chain()
    h = np.asarray(chain[0].taps, dtype=np.float32)
    hp = np.concatenate([h, np.zeros(-h.size % 4, np.float32)])
    tab = tfused.stage0_tables(torch.from_numpy(h))
    assert tab.dtype == torch.float32 and tab.shape == (hp.size // 4, 16)
    for g in range(hp.size // 4):
        for v in range(16):
            prods = [np.float32(hp[4 * g + i]) * np.float32(
                1.0 if v >> i & 1 else -1.0) for i in range(4)]
            want = np.float32(tree_sum(prods))
            assert tab[g, v].numpy().view(np.int32) == want.view(np.int32)
    coefs = tfused.kernel_coefs(chain)
    assert torch.equal(coefs[:tab.numel()], tab.reshape(-1))


def test_float_stage_beyond_div2_raises():
    """K1's stages after the first are ÷2: a chain with a ÷4 second stage
    is refused, on the CPU as on the card."""
    from dsd2dxd_tpu_torch.filters.design import Stage

    first = get_chain(*E64)[0]
    chain = (first, Stage(taps=np.hanning(12)[1:-1] / 5.0, L=1, M=4))
    assert tfused.decimation(chain) == 8
    with pytest.raises(ConfigError):
        tfused.make_fused_step(chain, _cfg(4096), "cpu")


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
    f = tfused.fused_decim_cascade(x, halo, _taps(chain), chain,
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
    ref = tfused.fused_decim_reference(x, halo, 0, _taps(chain), chain,
                                       _cfg(4096))
    assert torch.equal(wire, ref[0]) and float(peak) == float(ref[1])
    assert torch.equal(new_halo, x[:, -halo_bytes:])
    assert tfused.KERNEL_LAUNCHES == before
    with pytest.raises(ValueError):
        step(x[:, :2048].contiguous(), halo, 0)
    with pytest.raises(ValueError):
        step(x.to(torch.int16), halo, 0)


@pytest.mark.parametrize("bad", [
    # FPD is float-only, TPDF integer-only; NJAD is a host requantizer
    dict(bit_depth=16, dither=DitherType.FPD), dict(bit_depth=32),
    dict(dither=DitherType.FPD), dict(dither=DitherType.NJAD),
    dict(tile_bytes=64),
])
def test_unported_step_configs_raise(bad):
    chain = get_chain(*E64)
    kw = dict(channels=2, tile_bytes=4096, bit_depth=24,
              dither=DitherType.TPDF, level_db=0.0)
    kw.update(bad)
    with pytest.raises(ConfigError):
        tfused.make_fused_step(chain, StepConfig(**kw), "cpu")


@pytest.mark.parametrize("key", [
    (FilterType.EQUIRIPPLE, DsdRate.DSD128, 192000),
    (FilterType.EQUIRIPPLE, DsdRate.DSD64, 96000),
])
def test_chains_beyond_div8_raise(key):
    """The 48k family's rational chains stay outside the kernel."""
    chain = get_chain(*key)
    assert tfused.decimation(chain) is None
    with pytest.raises(ConfigError):
        tfused.make_fused_step(chain, _cfg(4096), "cpu")


# -- every pure ÷2^k chain: K1b, K1c, K1d ------------------------------------

@pytest.mark.parametrize("key", ALL_CHAINS, ids=_key_id)
def test_halo_equals_jax(key):
    """The port's state is the JAX kernel's halo, byte for byte in size,
    for all 20 chains (so a JAX state hands over)."""
    chain = get_chain(*key)
    assert tfused.decimation(chain) is not None
    jchain = _jchain(key)
    assert tfused.chain_halo_bytes(chain) == jfused.chain_halo_bytes(jchain)
    init = state_from_jax(jfused.init_fused_halo(jchain, 2))
    assert torch.equal(init, tfused.init_fused_halo(chain, 2))


@pytest.mark.parametrize("key", [E64_176, E64_88, X64_88, E128_88, E256_88,
                                 E512_352, C128_88], ids=_key_id)
def test_plain_cascade_matches_jax_phase_path(key):
    """The plain cascade against the JAX phase path (XLA, no Pallas) in
    f32: within 2e-6 after tile 0's warm-up (idle-primed against
    zero-primed histories), peaks within 1e-4."""
    chain = get_chain(*key)
    jcfg = JStepConfig(channels=2, tile_bytes=TILE, bit_depth=32,
                       dither=jtypes.DitherType.NONE, level_db=LEVEL)
    jchain = _jchain(key)
    pstep = make_phase_step(jchain, jcfg)
    h_p = init_phase_hists(build_chain_plans(jchain), 2)
    halo_bytes = tfused.chain_halo_bytes(chain)
    h_t = tfused.init_fused_halo(chain, 2)
    gain = tfused._gain32(_cfg())
    skip = int(halo_bytes * 8 * chain_ratio(chain)) + 1
    for t, x in enumerate(_tiles(13, 3)):
        op, pp, h_p = pstep(x, h_p, jax.random.PRNGKey(t))
        y = tfused.fused_decim_cascade(torch.from_numpy(x), h_t,
                                       _taps(chain), chain, gain)
        h_t = torch.from_numpy(x[:, -halo_bytes:].copy())
        op = np.asarray(op)
        assert y.shape == (2, op.shape[0])
        s = skip if t == 0 else 0
        assert np.max(np.abs(y.numpy().T[s:] - op[s:])) <= 2e-6
        if t > 0:
            assert abs(float(y.abs().max()) - float(pp)) <= 1e-4


@pytest.mark.parametrize("key", [E64_176, E128_88], ids=["G2", "atrous"])
def test_port_matches_jax_fused_kernel_and_state_handover(key):
    """The port's step against the JAX Pallas kernel in interpret mode,
    for a word-lane (G=2) chain and an à-trous (÷64) chain: 24-bit NONE
    within 5 LSB, 32-bit within 2e-6, peaks within 1e-4, equal halos;
    then JAX tile 0 -> state_from_jax on the u16/u32 halo -> port tile 1."""
    chain, jchain = get_chain(*key), _jchain(key)
    g = jfused.fused_plan(jchain)[1]
    x0, x1, x2 = _tiles(14, 3)
    for bits, tol in ((24, 5), (32, 2e-6)):
        jcfg = JStepConfig(channels=2, tile_bytes=TILE, bit_depth=bits,
                           dither=jtypes.DitherType.NONE, level_db=LEVEL)
        jstep, halo_bytes = jfused.make_fused_step(jchain, jcfg,
                                                   interpret=True)
        assert halo_bytes == tfused.chain_halo_bytes(chain)
        step = tfused.make_fused_step(chain, _cfg(bit_depth=bits), "cpu")
        h_j = jnp.asarray(jfused.init_fused_halo(jchain, 2))
        h_t = tfused.init_fused_halo(chain, 2)
        for x in (x0, x1):
            oj, pj, h_j = jstep(jfused.prep_input(x, g), h_j, 0)
            wire, pt, h_t = step(torch.from_numpy(x), h_t, 0)
            d = np.abs(_decode(wire, bits) - np.asarray(oj).reshape(-1))
            assert d.max() <= tol
            assert abs(float(pt) - float(pj)) <= 1e-4
            assert torch.equal(state_from_jax(np.asarray(h_j)), h_t)
        # hand the JAX state over for tile 2
        state = state_from_jax(np.asarray(h_j))
        oj2, pj2, _ = jstep(jfused.prep_input(x2, g), h_j, 0)
        wire2, pt2, _ = step(torch.from_numpy(x2), state, 0)
        assert np.abs(_decode(wire2, bits)
                      - np.asarray(oj2).reshape(-1)).max() <= tol
        assert abs(float(pt2) - float(pj2)) <= 1e-4


@pytest.mark.parametrize("bits", [16, 20])
@pytest.mark.parametrize("big_endian", [False, True], ids=["LE", "BE"])
def test_int_epilogue_bit_equal_to_jax_quantize_and_pack(bits, big_endian):
    """16- and 20-bit NONE: the port's epilogue equals the JAX
    quantize_int followed by containers/pack.pack_int, byte for byte, on
    the same f32 samples (some driven into the clip)."""
    chain = get_chain(*E64_176)
    x = torch.from_numpy(_tiles(15, 1, tile=8192)[0])
    y = tfused.fused_decim_cascade(x, tfused.init_fused_halo(chain, 2),
                                   _taps(chain), chain, 1.0) * 3.0
    assert float(y.abs().max()) > 1.0
    wire, _ = tfused.decim_epilogue(y, 0, _cfg(tile=8192, bit_depth=bits),
                                    big_endian)
    q = np.asarray(jquantize_int(jnp.asarray(y.numpy()), bits, None))
    assert wire.numpy().tobytes() == pack_int(q.T, bits, big_endian)


def test_fpd_statistics_and_reproducible():
    """32-bit FPD: every sample within 1 ulp of the undithered y, the
    error's mean near 0 ulp, noise in most samples; the same key draws
    the same noise, another tile's key other noise. (Rounding moves a
    sample by one ulp where |tpdf| > 1/2: a quarter of them.)"""
    chain = get_chain(*E64_88)
    tile = 32768
    x = torch.from_numpy(_tiles(16, 1, tile=tile)[0])
    halo = tfused.init_fused_halo(chain, 2)
    step = tfused.make_fused_step(
        chain, _cfg(tile=tile, bit_depth=32, dither=DitherType.FPD), "cpu")
    plain = tfused.make_fused_step(chain, _cfg(tile=tile, bit_depth=32),
                                   "cpu")
    y = _decode(plain(x, halo, 0)[0], 32)
    k0, k1 = philox.tile_key(42, 0), philox.tile_key(42, 1)
    w0 = step(x, halo, k0)[0]
    assert torch.equal(w0, step(x, halo, k0)[0])
    w1 = step(x, halo, k1)[0]
    assert not torch.equal(w0, w1)
    ulp = np.spacing(np.abs(y).astype(np.float32)).astype(np.float64)
    errs = []
    for w in (w0, w1):
        e = (_decode(w, 32) - y) / ulp
        assert np.all(np.abs(e) <= 1.0)
        errs.append(e)
    e = np.concatenate(errs)
    assert e.size == 2 * 2 * tile // 4
    assert abs(float(e.mean())) < 0.01
    assert 0.2 < np.mean(e != 0) < 0.3


@pytest.mark.parametrize("key", [E64, E64_176, E256_88], ids=_key_id)
def test_partial_tile_peak_masked_to_valid_frames(key):
    """A full-scale burst ends mid-tile, shorter than the filter's
    delay, and the idle pad follows: the fixed tile's frames past n_valid
    ring up to full scale, but the peak is max |y[:n_valid]| of the
    plain cascade. A full tile's peak is unchanged by n_valid."""
    chain = get_chain(*key)
    fb = tfused.decimation(chain) // 8
    tile = 512 * fb * 4
    n_valid = 512 * 3 - 100
    x = np.full((2, tile), tfused.IDLE_BYTE, dtype=np.uint8)
    x[:, (n_valid - 8) * fb:n_valid * fb] = 0xFF
    x = torch.from_numpy(x)
    halo = tfused.init_fused_halo(chain, 2)
    step = tfused.make_fused_step(
        chain, _cfg(tile=tile, level=0.0, dither=DitherType.TPDF), "cpu")
    y = tfused.fused_decim_cascade(x, halo, _taps(chain), chain, 1.0)
    _w, masked, _h = step(x, halo, 1, n_valid)
    _w, whole, _h = step(x, halo, 1)
    assert float(masked) == float(y[:, :n_valid].abs().max())
    assert float(whole) == float(y.abs().max()) > float(masked) + 0.5
    full = torch.from_numpy(_tiles(17, 1, tile=tile)[0])
    assert float(step(full, halo, 1, tile // fb)[1]) == float(
        step(full, halo, 1)[1])
    assert float(step(x, halo, 1, 0)[1]) == 0.0


@pytest.mark.parametrize("bits,dither", [
    (16, DitherType.NONE), (16, DitherType.TPDF), (16, DitherType.RECTANGULAR),
    (20, DitherType.NONE), (20, DitherType.TPDF), (24, DitherType.RECTANGULAR),
    (32, DitherType.NONE), (32, DitherType.FPD)])
def test_step_covers_every_epilogue(bits, dither):
    """Each epilogue builds on a ÷128 chain and emits T_out frames of its
    width; 20-bit samples keep their low 4 bits zero; big endian is the
    byte reverse of little endian."""
    chain = get_chain(*E256_88)
    tile = 4096
    cfg = _cfg(tile=tile, bit_depth=bits, dither=dither)
    x = torch.from_numpy(_tiles(18, 1, tile=tile)[0])
    halo = tfused.init_fused_halo(chain, 2)
    wire, peak, _ = tfused.make_fused_step(chain, cfg, "cpu")(x, halo, 9)
    bps = {16: 2, 20: 3, 24: 3, 32: 4}[bits]
    assert wire.numel() == tile // 16 * 2 * bps
    be = tfused.make_fused_step(chain, cfg, "cpu", big_endian=True)
    assert torch.equal(be(x, halo, 9)[0].reshape(-1, bps),
                       wire.reshape(-1, bps).flip(1))
    if bits == 20:
        assert np.all(wire.numpy().reshape(-1, 3)[:, 0] & 0x0F == 0)
    assert 0.0 < float(peak) < 1.0


@pytest.mark.parametrize("key,bits,modes", [
    (E64, 24, ("K1a",)), (E64, 16, ("K1d",)), (E64_176, 24, ("K1b",)),
    (E64_88, 32, ("K1b", "K1d")), (E128_88, 20, ("K1c", "K1d")),
    (E256_88, 24, ("K1c",))])
def test_kernel_modes(key, bits, modes):
    assert tfused.kernel_modes(get_chain(*key), bits) == modes
