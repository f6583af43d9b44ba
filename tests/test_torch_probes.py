"""The floor probes of the port (dsd2dxd_tpu_torch/tools: P1 dmabench,
P2 floorstrip) on the CPU: their plain versions against the JAX tools'
Pallas probes in interpret mode (tools/dmabench.py::_probe,
tools/floorstrip.py::_probe_step), at the smallest block those take; and
the port-side pieces the card path relies on. The kernels themselves run
on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(1, str(ROOT))

import chip_smoke  # noqa: E402
import dmabench as jdmabench  # noqa: E402
import floorprof as jfloorprof  # noqa: E402
import floorstrip as jfloorstrip  # noqa: E402

from dsd2dxd_tpu.formats import dsd_types as jtypes  # noqa: E402
from dsd2dxd_tpu.ops import fused as jfused  # noqa: E402
from dsd2dxd_tpu.ops.resample import StepConfig as JStepConfig  # noqa: E402
from dsd2dxd_tpu_torch.formats.dsd_types import DitherType  # noqa: E402
from dsd2dxd_tpu_torch.ops import fused  # noqa: E402
from dsd2dxd_tpu_torch.ops.plan import state_from_jax, tree_sum  # noqa: E402
from dsd2dxd_tpu_torch.ops.resample import StepConfig  # noqa: E402
from dsd2dxd_tpu_torch.tools import dmabench, floorstrip, synth_chain  # noqa: E402
from dsd2dxd_tpu_torch.utils.errors import ConfigError  # noqa: E402

BLOCK = 16384     # bytes per grid step: the smallest the JAX probes take
GROUPS = 4        # the JAX P1's u32 words
TILE = 2 * BLOCK  # two grid steps, as the JAX tools' --check


def _taps(chain, device="cpu"):
    return [torch.tensor(np.asarray(s.taps, dtype=np.float32), device=device)
            for s in chain]


# -- P1: dmabench ---------------------------------------------------------------

@pytest.fixture(scope="module")
def p1_jax():
    """Every JAX P1 mode in interpret mode on one staged u32 input."""
    block_lanes, _b, k_sub, c_pad, _r, n_blocks = jdmabench._geometry(
        BLOCK, GROUPS, TILE)
    rel, lanes8 = jdmabench._make_relayout(block_lanes, n_blocks, c_pad)
    xp = np.random.default_rng(40).integers(
        0, 2 ** 32, (c_pad, jdmabench.HALO + TILE // GROUPS), dtype=np.uint32)
    xrep = rel(jnp.asarray(xp))
    outs = {}
    for mode in jdmabench.MODES:
        step, _meta = jdmabench._probe(BLOCK, GROUPS, TILE, mode,
                                       interpret=True)
        src = xrep if mode in ("contig", "bspec") else xp
        outs[mode] = np.asarray(step(src))
    g = dmabench.Geometry(block_words=block_lanes,
                          halo_words=jdmabench.HALO, k_sub=k_sub,
                          row_words=lanes8)
    return xp, g, c_pad, n_blocks, lanes8, outs


@pytest.mark.parametrize("mode", [m for m in dmabench.MODES
                                  if m != "relayout"])
def test_p1_mode_equals_jax_row0(p1_jax, mode):
    """The plain version with the JAX probe's geometry equals row 0 of
    the JAX output exactly (noflush: the last block's values, what the
    TPU's pinned output block leaves)."""
    xp, g, rows, n_blocks, _l8, outs = p1_jax
    x = torch.from_numpy(xp.view(np.int32))
    src = (dmabench.relayout(x, g, n_blocks) if mode in ("contig", "bspec")
           else x)
    got = dmabench.dma_probe(src, mode, g, rows, n_blocks)
    np.testing.assert_array_equal(got.numpy()[0], outs[mode][0])


@pytest.mark.parametrize("block,halo", dmabench.k1_blocks())
def test_p1_noflush_is_the_last_blocks_values(block, halo):
    """noflush has no output stream: at K1's blocks its (rows, k_sub)
    block is the last block's values of each row, which dma streams as
    its last block (the JAX probe's row 0 is held in
    test_p1_mode_equals_jax_row0)."""
    g = dmabench.geometry(block, halo)
    n = 4
    x = torch.from_numpy(np.random.default_rng(47).integers(
        0, 2 ** 32, (2, g.halo_words + n * g.block_words),
        dtype=np.uint32).view(np.int32))
    got = dmabench.dma_probe(x, "noflush", g, 2, n)
    assert got.shape == (2, g.k_sub)
    dma = dmabench.dma_probe(x, "dma", g, 2, n)
    assert torch.equal(got, dma[:, (n - 1) * g.k_sub:])
    end = g.halo_words + n * g.block_words
    assert torch.equal(got, x[:, end - g.k_sub:end].to(torch.float32))


def test_p1_relayout_equals_jax(p1_jax):
    """relayout equals the JAX XLA pass with its 8-row padding removed."""
    xp, g, rows, n_blocks, lanes8, outs = p1_jax
    got = dmabench.relayout(torch.from_numpy(xp.view(np.int32)), g, n_blocks)
    ref = outs["relayout"].reshape(n_blocks, 8 * lanes8)[:, :rows * g.win]
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref)


def test_p1_contig_is_dma_at_the_cards_geometry():
    """With one channel's window per slab row (the card's geometry),
    contig and bspec store what dma stores."""
    g = dmabench.geometry(2048, 496)
    n = 5
    x = torch.from_numpy(np.random.default_rng(41).integers(
        0, 2 ** 32, (2, g.halo_words + n * g.block_words),
        dtype=np.uint32).view(np.int32))
    xr = dmabench.relayout(x, g, n)
    dma = dmabench.dma_probe(x, "dma", g, 2, n)
    assert dma.shape == (2, n * g.k_sub)
    for mode in ("contig", "bspec"):
        assert torch.equal(dmabench.dma_probe(xr, mode, g, 2, n), dma)
    assert torch.equal(dmabench.dma_probe(x, "noflush", g, 2, n),
                       dma.reshape(2, n, g.k_sub)[:, -1])


@pytest.mark.parametrize("block,halo", [(512, 48), (2048, 496)])
@pytest.mark.parametrize("mode", ["noop", "noflush", "dma", "halo0",
                                  "contig", "bspec"])
def test_p1_library_call_is_the_plain_version(mode, block, halo):
    """The one PyTorch call the card times beside each P1 mode computes
    that mode's function at the card's geometry; noflush has none."""
    g = dmabench.geometry(block, halo)
    n = 6
    x = torch.from_numpy(np.random.default_rng(45).integers(
        0, 2 ** 32, (2, g.halo_words + n * g.block_words),
        dtype=np.uint32).view(np.int32))
    src = (dmabench.relayout(x, g, n) if mode in ("contig", "bspec")
           else x)
    lib = chip_smoke.p1_library_call(src, mode, g, 2, n)
    if mode == "noflush":
        assert lib is None
    else:
        assert torch.equal(lib, dmabench.dma_probe_reference(src, mode, g, 2,
                                                             n))


def test_p1_wrapper_cpu_counts_no_launch_and_checks_shapes():
    g = dmabench.geometry(512, 48)
    x = torch.zeros((2, g.halo_words + 3 * g.block_words), dtype=torch.int32)
    before = dict(dmabench.LAUNCHES)
    dmabench.dma_probe(x, "dma", g, 2, 3)
    assert dmabench.LAUNCHES == before
    with pytest.raises(ValueError):
        dmabench.dma_probe(x[:, 1:].contiguous(), "dma", g, 2, 3)
    with pytest.raises(ValueError):
        dmabench.dma_probe(x.to(torch.int64), "dma", g, 2, 3)
    with pytest.raises(ValueError):
        dmabench.dma_probe(x, "relayout", g, 2, 3)


def test_p1_k1_blocks():
    """K1's blocks (block_out x frame bytes over the 20 pure chains: 2560
    B at ÷64, 2048 B at the other depths) and one 4x larger, each with
    K1's largest overlap at that block (its window beyond the block's own
    bytes, rounded up to 16)."""
    assert dmabench.k1_blocks() == [(2048, 528), (2560, 384), (10240, 528)]
    g = dmabench.geometry(2048, 496)
    assert (g.block_words, g.halo_words, g.k_sub, g.load_words) == (
        512, 124, 512, 636)
    n = 8
    assert dmabench.bound_bytes("dma", g, 2, n) == 4 * 2 * (124 + 8 * 512
                                                            + 8 * 512)
    assert dmabench.moved_bytes("noop", g, 2, n) == 4 * 2 * 8 * 512


# -- P2: floorstrip --------------------------------------------------------------

@pytest.mark.parametrize("scale", [0.0, 0.25, 0.5, 1.0])
def test_synth_chain_equals_floorprof(scale):
    mine, ref = synth_chain(scale), jfloorprof.synth_chain(scale)
    assert len(mine) == len(ref) == 6
    for a, b in zip(mine, ref):
        assert (a.L, a.M) == (b.L, b.M)
        assert a.taps.dtype == b.taps.dtype
        np.testing.assert_array_equal(a.taps, b.taps)


def _undo_jax_layout(out, n_blocks):
    """The JAX probe's (r_rows, n_blocks * k_sub) output as (C, T_out):
    phase 0 of the à-trous tail kept (fused._take_phase0), the
    sublane_batch row order (fused.sublane_batch) undone."""
    chain = jfloorprof.synth_chain(0.0)
    _n_head, g, r_tail = jfused.fused_plan(chain)
    block_lanes = BLOCK // g
    batch = jfused.sublane_batch(2, block_lanes, r_tail)
    k2 = block_lanes // batch // r_tail
    o = np.asarray(jfused._take_phase0(jnp.asarray(out), r_tail))
    return o.reshape(batch, 2, n_blocks, k2).transpose(1, 2, 0, 3).reshape(
        2, -1)


@pytest.fixture(scope="module")
def p2_inputs():
    """Two grid blocks of random DSD bytes and a random JAX halo (u32
    words), the same bytes for both packages."""
    chain = jfloorprof.synth_chain(0.0)
    rng = np.random.default_rng(42)
    x = rng.integers(0, 256, (2, TILE), dtype=np.uint8)
    halo = jfused.init_fused_halo(chain, 2)
    halo = rng.integers(0, 2 ** 32, halo.shape, dtype=np.uint32)
    return x, halo


def _jax_rung(p2_inputs, rung):
    x, halo = p2_inputs
    chain = jfloorprof.synth_chain(0.0)
    cfg = JStepConfig(channels=2, tile_bytes=TILE, bit_depth=24,
                      dither=jtypes.DitherType.NONE, level_db=0.0)
    step, halo_bytes = jfloorstrip._probe_step(chain, cfg, BLOCK, rung,
                                               interpret=True)
    out, peak, _new = step(jfused.prep_input(x, 4), jnp.asarray(halo), 0)
    return _undo_jax_layout(np.asarray(out), TILE // BLOCK), float(peak), \
        halo_bytes


def _port_rung(p2_inputs, rung):
    x, halo = p2_inputs
    chain = synth_chain(0.0)
    cfg = StepConfig(channels=2, tile_bytes=TILE, bit_depth=24,
                     dither=DitherType.NONE, level_db=0.0)
    step = floorstrip.make_probe_step(chain, cfg, rung, "cpu")
    out, peak = step(torch.from_numpy(x), state_from_jax(halo), 0)
    return out.numpy(), float(peak)


def test_p2_cas0_matches_jax(p2_inputs):
    """cas0 (the real cascade, f32 at gain 1, the peak): within 1e-6 of
    the JAX probe after its layout is undone, the same halo size."""
    ref, rpeak, halo_bytes = _jax_rung(p2_inputs, "cas0")
    assert halo_bytes == fused.chain_halo_bytes(synth_chain(0.0))
    got, peak = _port_rung(p2_inputs, "cas0")
    assert got.shape == ref.shape == (2, TILE * 8 // 64)
    assert np.abs(got - ref).max() <= 1e-6
    assert abs(peak - rpeak) <= 1e-6


def test_p2_quant_matches_jax(p2_inputs):
    """quant at NONE dither (interpret mode has no on-core PRNG): the
    int32 samples within 1 LSB of the JAX probe's, peaks within 1e-6."""
    ref, rpeak, _h = _jax_rung(p2_inputs, "quant")
    got, peak = _port_rung(p2_inputs, "quant")
    assert got.dtype == np.int32 and got.shape == ref.shape
    assert np.abs(got.astype(np.int64) - ref.astype(np.int64)).max() <= 1
    assert abs(peak - rpeak) <= 1e-6


def _chain(key):
    from dsd2dxd_tpu_torch.filters.design import get_chain
    from dsd2dxd_tpu_torch.formats.dsd_types import DsdRate, FilterType

    if key == "synth":
        return synth_chain(0.0)
    return get_chain(*{"E64": (FilterType.EQUIRIPPLE, DsdRate.DSD64, 352800),
                       "E256": (FilterType.EQUIRIPPLE, DsdRate.DSD256,
                                88200)}[key])


def _rung_inputs(key, block_out=None, seed=43, blocks=5 / 2):
    """A tile of `blocks` kernel blocks (ragged last block) of random
    bytes and a random halo for chain `key`: (chain, x, halo, block_out,
    t_out)."""
    chain = _chain(key)
    fb = fused.decimation(chain) // 8
    bo = block_out or fused.block_out_for(chain)
    tile = int(bo * fb * blocks) // fb * fb
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(0, 256, (2, tile), dtype=np.uint8))
    halo = torch.from_numpy(rng.integers(
        0, 256, (2, fused.chain_halo_bytes(chain)), dtype=np.uint8))
    return chain, x, halo, bo, tile // fb


@pytest.mark.parametrize("key,block_out", [
    ("synth", None), ("synth", 100), ("E64", None), ("E256", None)])
def test_p2_block_cascade_at_the_stages_strides_is_the_cascade(key,
                                                                block_out):
    """The rungs' plain versions run each block's window as K1 copies it
    (big-endian words from the 16-byte chunk of its first byte), through
    stage 0's tables and the ÷2 stages, block by block; read exactly
    (no aligned words) that is the plain cascade, bit for bit, so only
    the aligned reads differ in cas0a."""
    chain, x, halo, bo, t_out = _rung_inputs(key, block_out)
    lay = fused.kernel_layout(chain, halo.shape[1], bo)
    y = floorstrip.block_body(x, halo, _taps(chain), lay,
                              -(-t_out // bo))[:, :t_out]
    assert torch.equal(y, fused.fused_decim_cascade(x, halo, _taps(chain),
                                                    chain, 1.0))


def test_p2_rungs_on_the_cpu():
    """Each rung's plain version on a ragged tile of synth_chain(0.0) at
    K1's block: dma the block's first window bytes, unpack stage 0's
    output j of each block, cas0a a wrong cascade of the real shape, cas0
    the cascade and its peak, quant the 24-bit epilogue's int32 words at
    NONE and at TPDF with cas0's peak; no launch counted."""
    chain, cfg, bo = floorstrip.probe_config(0, None)
    tile = cfg.tile_bytes * 7 // 2 // 8 * 8
    cfg = StepConfig(channels=2, tile_bytes=tile, bit_depth=24,
                     dither=DitherType.TPDF, level_db=0.0)
    rng = np.random.default_rng(44)
    x = torch.from_numpy(rng.integers(0, 256, (2, tile), dtype=np.uint8))
    halo = fused.init_fused_halo(chain, 2)
    lay = fused.kernel_layout(chain, halo.shape[1], bo)
    before = dict(floorstrip.LAUNCHES)
    outs = {r: floorstrip.make_probe_step(chain, cfg, r, "cpu")(x, halo, 9)
            for r in floorstrip.KERNEL_RUNGS}
    none_cfg = StepConfig(channels=2, tile_bytes=tile, bit_depth=24,
                          dither=DitherType.NONE, level_db=0.0)
    qn, qnpk = floorstrip.make_probe_step(chain, none_cfg, "quant",
                                          "cpu")(x, halo, 9)
    assert floorstrip.LAUNCHES == before
    t_out = tile // 8
    window = torch.cat([halo, x], dim=1)
    first = window[:, lay.byte_off:lay.byte_off + bo].to(torch.float32)
    assert torch.equal(outs["dma"][0][:, :bo], first)
    for r in ("dma", "unpack", "cas0a"):
        assert outs[r][1] is None
        assert outs[r][0].shape == (2, t_out)
    y, pk = outs["cas0"]
    assert torch.equal(y, fused.fused_decim_cascade(x, halo, _taps(chain),
                                                    chain, 1.0))
    u = outs["unpack"][0]
    assert torch.isfinite(u).all() and float(u.abs().max()) <= 1.0 + 1e-6
    assert not torch.equal(y, outs["cas0a"][0])
    assert torch.isfinite(outs["cas0a"][0]).all()
    assert float(pk) == float(y.abs().max())
    q, qpk = outs["quant"]
    assert q.dtype == qn.dtype == torch.int32
    assert float(qpk) == float(qnpk) == float(pk)
    assert torch.equal(qn, torch.round(y.double() * 2 ** 23).to(torch.int32))
    e = q.double() - y.double() * 2 ** 23
    assert e.abs().max() <= 1.5 and 0.3 < float(e.pow(2).mean().sqrt()) < 0.7
    with pytest.raises(ValueError):
        floorstrip.make_probe_step(chain, cfg, "fan", "cpu")
    rect = StepConfig(channels=2, tile_bytes=tile, bit_depth=24,
                      dither=DitherType.RECTANGULAR, level_db=0.0)
    with pytest.raises(ConfigError):
        floorstrip.make_probe_step(chain, rect, "quant", "cpu")


def _tile_stage0(x, halo, taps, chain):
    """Stage 0 of the plain cascade over the whole tile (the same window
    and products as fused_decim_cascade, stopped after its first stage):
    (C, out_len[0]) f32, output i reading bits M0 i .. M0 i + N0 - 1."""
    t_out = x.shape[1] * 8 // fused.decimation(chain)
    lay = fused.block_layout(chain, halo.shape[1], t_out)
    window = torch.cat([halo, x], dim=1)[:, lay.byte_off:]
    v = fused.unpack_bits(window)[:, lay.bit_off:]
    n, m, o = lay.n_taps[0], lay.decim[0], lay.out_len[0]
    hk = taps[0].tolist()
    return tree_sum(v[:, n - 1 - k:n - 1 - k + (o - 1) * m + 1:m] * hk[k]
                    for k in range(n))


def _np_words(x, halo, lay, blk):
    """The window words of block `blk` as K1's copy leaves them, in
    numpy (a 16-byte aligned tile): (words (C, n) uint64, base (C,))."""
    xa, ha = x.numpy(), halo.numpy()
    c, t = xa.shape
    h = ha.shape[1]
    n_win = 4 * lay.win_words
    wb0 = blk * lay.block_out * lay.frame_bytes + lay.byte_off
    flat = np.concatenate([xa.reshape(-1),
                           np.full(n_win, fused.IDLE_BYTE, np.uint8)])
    words, base = [], []
    for ch in range(c):
        if wb0 >= h and wb0 + lay.n_load_bytes <= h + t:
            off = ch * t + wb0 - h
            s = off % 16
            raw = flat[off - s:off - s + n_win]
        else:
            s = 0
            win = np.concatenate([ha[ch], xa[ch],
                                  np.full(n_win, fused.IDLE_BYTE, np.uint8)])
            raw = win[wb0:wb0 + n_win]
        words.append(raw.reshape(-1, 4).astype(np.uint64)
                     @ np.array([1 << 24, 1 << 16, 1 << 8, 1], np.uint64))
        base.append(8 * s + lay.bit_off)
    return np.stack(words), np.array(base)


def _np_tree(vals):
    """plan.tree_sum's association over a list of f32 arrays."""
    vals = list(vals)
    while len(vals) > 1:
        nxt = [(vals[i] + vals[i + 1]).astype(np.float32)
               for i in range(0, len(vals) - 1, 2)]
        if len(vals) % 2:
            nxt.append(vals[-1])
        vals = nxt
    return vals[0]


def _np_cas0a(x, halo, taps, chain, bo, t_out):
    """cas0a in numpy: per block, every stage-0 read of 32 window bits
    rounded down to the word that holds its first bit (as the kernel's
    path for the chain reads: two chunks per four outputs at ÷2 with an
    unrolled group count, one per 8 groups with another, one per group
    else), tables of 4-tap subtree sums, then the ÷2 stages (rounded to
    float4 only at tap counts the kernel loops over)."""
    lay = fused.kernel_layout(chain, halo.shape[1], bo)
    tables = fused.stage0_tables(taps[0]).numpy()
    q, m0 = lay.n_groups, lay.decim[0]
    hs = [t.numpy() for t in taps]
    out = np.zeros((x.shape[0], -(-t_out // bo) * bo), np.float32)
    for blk in range(-(-t_out // bo)):
        words, base = _np_words(x, halo, lay, blk)
        j = np.arange(lay.n_out[0])
        if q in floorstrip.STAGE0_CASES and q <= 6 and m0 == 2:
            pos = base[:, None] + 8 * (j // 4) + 2 * (j % 2)
            w = np.take_along_axis(words, pos >> 5, axis=1)
            nibs = [(w >> np.uint64(4 * (7 - (q - 1 - g + (j // 2) % 2))))
                    & np.uint64(15) for g in range(q)]
        else:
            pos = base[:, None] + m0 * j
            nibs = []
            for g in range(q):
                r = q - 1 - g
                if q in floorstrip.STAGE0_CASES:
                    p, sel = pos + 32 * (r >> 3), r & 7
                else:
                    p, sel = pos + 4 * r, 0
                w = np.take_along_axis(words, p >> 5, axis=1)
                nibs.append((w >> np.uint64(4 * (7 - sel))) & np.uint64(15))
        v = _np_tree(tables[g][nibs[g].astype(np.int64)] for g in range(q))
        for s in range(1, len(chain)):
            n, o = lay.n_taps[s], lay.n_out[s]
            jj = np.arange(o)
            prods = []
            for k in range(n):
                d = n - 1 - k
                e = jj + d // 2
                if n not in floorstrip.FIR2_CASES:
                    e = e & ~3
                prods.append((v[:, 2 * e + d % 2] * hs[s][k])
                             .astype(np.float32))
            v = _np_tree(prods)
        out[:, blk * bo:(blk + 1) * bo] = v[:, :bo]
    return out[:, :t_out]


def _np_philox(ctr0, ctr1, key):
    """Philox4x32-10 words 0 and 1 of counter (ctr0, ctr1, 0, 0) in
    numpy uint64 (each 32x32 product whole)."""
    m32 = np.uint64(0xFFFFFFFF)
    c = [ctr0.astype(np.uint64), ctr1.astype(np.uint64),
         np.zeros_like(ctr0, np.uint64), np.zeros_like(ctr0, np.uint64)]
    k0, k1 = key & 0xFFFFFFFF, key >> 32
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & 0xFFFFFFFF, (k1 + 0xBB67AE85) \
                & 0xFFFFFFFF
        p0 = c[0] * np.uint64(0xD2511F53)
        p1 = c[2] * np.uint64(0xCD9E8D57)
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ np.uint64(k0), p1 & m32,
             (p0 >> np.uint64(32)) ^ c[3] ^ np.uint64(k1), p0 & m32]
    return c[0], c[1]


@pytest.mark.parametrize("key", ["synth", "E64"])
@pytest.mark.parametrize("rung", ["unpack", "cas0a", "quant NONE",
                                  "quant TPDF"])
def test_p2_rung_plain_equals_an_independent_computation(rung, key):
    """Each rung whose plain version is its own: unpack equals stage 0 of
    the whole tile's cascade at each block's outputs (frame m0 + j: output
    m0 R / M0 + j); cas0a equals the rounded-down reads computed in
    numpy; quant equals rint(y 2^23 (+ TPDF noise of a numpy Philox)),
    clipped, on the cascade's y. Bit for bit, on a ragged tile."""
    chain, x, halo, bo, t_out = _rung_inputs(key, seed=46)
    taps = _taps(chain)
    name, _sp, dither = rung.partition(" ")
    cfg = StepConfig(channels=2, tile_bytes=x.shape[1], bit_depth=24,
                     dither=DitherType[dither or "NONE"], level_db=0.0)
    key_t = 0x0123456789ABCDEF
    got, _pk = floorstrip.make_probe_step(chain, cfg, name, "cpu")(
        x, halo, key_t)
    if name == "unpack":
        r_m0 = fused.decimation(chain) // chain[0].M
        m = np.arange(t_out)
        idx = torch.from_numpy((m // bo) * bo * r_m0 + m % bo)
        ref = _tile_stage0(x, halo, taps, chain)[:, idx]
        assert torch.equal(got, ref)
    elif name == "cas0a":
        np.testing.assert_array_equal(got.numpy(),
                                      _np_cas0a(x, halo, taps, chain, bo,
                                                t_out))
        assert not torch.equal(got, fused.fused_decim_cascade(
            x, halo, taps, chain, 1.0))
    else:
        y = fused.fused_decim_cascade(x, halo, taps, chain, 1.0).numpy()
        v = (y * np.float32(2 ** 23)).astype(np.float32)
        if dither == "TPDF":
            f = np.broadcast_to(np.arange(t_out), y.shape)
            ch = np.broadcast_to(np.arange(2)[:, None], y.shape)
            w0, w1 = _np_philox(f, ch, key_t)
            u0 = (w0 >> np.uint64(8)).astype(np.float32) * np.float32(2 ** -24)
            u1 = (w1 >> np.uint64(8)).astype(np.float32) * np.float32(2 ** -24)
            v = (v + ((u0 + u1).astype(np.float32) - np.float32(1))
                 .astype(np.float32)).astype(np.float32)
        ref = np.clip(np.rint(v), -2 ** 23, 2 ** 23 - 1).astype(np.int32)
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("switch,want", [
    ("n_groups", floorstrip.STAGE0_CASES),
    ("n_taps[s]", floorstrip.FIR2_CASES)])
def test_p2_unrolled_counts_are_the_bodys(switch, want):
    """cas0a's plain version follows the kernel's paths, so its lists of
    unrolled counts are those of decim_body.cuh's two switches."""
    import re

    src = (ROOT / "dsd2dxd_tpu_torch" / "csrc" / "decim_body.cuh").read_text()
    body = src[src.index(f"switch (p.{switch})"):]
    body = body[:body.index("default:")]
    found = re.findall(r"case (\d+)|FIR2_CASE\((\d+)\)", body)
    got = tuple(int(a or b) for a, b in found)
    assert got == want


# -- the entry points ------------------------------------------------------------

@pytest.mark.parametrize("tool", [dmabench, floorstrip],
                         ids=["dmabench", "floorstrip"])
def test_tools_run_plain_on_cpu_and_refuse_without_a_card(tool, monkeypatch,
                                                          capsys):
    res = tool.main(["--device", "cpu"])
    assert "cpu" in res
    assert "no times" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigError):
        tool.main([])


def test_blocksweep_needs_a_card(monkeypatch):
    """The block_out sweep times K1 on the card: it refuses the CPU, and
    without a card it raises."""
    from dsd2dxd_tpu_torch.filters.design import get_chain
    from dsd2dxd_tpu_torch.tools import blocksweep

    with pytest.raises(ConfigError):
        blocksweep.main(["--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigError):
        blocksweep.main([])
    for depth, key in blocksweep.CHAINS.items():
        assert fused.decimation(get_chain(*key)) == depth


def test_finishsweep_needs_a_card(monkeypatch):
    """The frames-per-run sweep times K2 "from z" on the card: it refuses
    the CPU, and without a card it raises. The run length in use is one of
    its candidates, and a wide file halves it until two staged runs fit."""
    from dsd2dxd_tpu_torch.formats.dsd_types import DitherType
    from dsd2dxd_tpu_torch.ops.resample import StepConfig
    from dsd2dxd_tpu_torch.tools import finishsweep

    with pytest.raises(ConfigError):
        finishsweep.main(["--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigError):
        finishsweep.main([])
    assert fused.FINISH_RUN_FRAMES in finishsweep.FRAMES
    assert finishsweep.fastest({512: {"24N": 0.06, "24T": 0.09},
                                1024: {"24N": 0.05, "24T": 0.09},
                                2048: {"24N": 0.06, "24T": 0.08}}) == 2048
    assert finishsweep.fastest({64: {"24N": 0.05}, 128: {"24N": 0.07}}) == 64
    cfg = StepConfig(channels=2, tile_bytes=8, bit_depth=24,
                     dither=DitherType.TPDF, level_db=0.0)
    for channels, run_frames, want in ((2, None, 2048), (2, 64, 64),
                                       (3, None, 1024), (6, None, 512),
                                       (13, None, 256), (320, None, 16)):
        p = fused.finish_params(1000, channels, 1.0, 7, cfg, False, 900,
                                run_frames)
        assert (p.run_frames, p.n_frames, p.n_valid) == (want, 1000, 900)
        assert 2 * p.run_frames * channels * 4 <= 40 * 1024
    with pytest.raises(ConfigError):
        fused.finish_params(1000, 321, 1.0, 7, cfg, False, None)


class _FakeClock:
    """perf_counter that moves only when a timed fn enqueues."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _FakeEvent:
    def __init__(self, enable_timing=False):
        pass

    def record(self):
        pass

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return 1.0


@pytest.mark.parametrize("slow,want_sleeps", [
    ((), [4_000_000, 4_000_000]),
    ((3,), [4_000_000, 4_000_000, 8_000_000]),
    ((2, 3), [4_000_000, 8_000_000, 8_000_000]),
])
def test_round_robin_reruns_a_starved_rep(monkeypatch, slow, want_sleeps):
    """The hold: a warm enqueue of 1 ms sleeps 4e6 cycles (2 ms at 2
    GHz). A rep whose enqueue outlasts its sleep is run again with the
    sleep doubled and only the held run's time is kept; the doubled sleep
    stays for later reps, and a rep starved past HOLD_TRIES raises."""
    import dsd2dxd_tpu_torch.tools as tools

    clock = _FakeClock()
    calls = []
    # run 0 is the warm-up, run 1 the enqueue measure, runs 2.. the reps
    enqueue_s = {c: 3e-3 if c in slow else 1e-3 for c in range(10)}

    def fn():
        calls.append(len(calls))
        clock.t += enqueue_s.get(len(calls) - 1, 1e-3)

    sleeps = []
    monkeypatch.setattr(tools.time, "perf_counter", clock)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "_sleep", sleeps.append)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    times = tools.round_robin({"a": fn}, reps=2)
    assert times == {"a": [1.0, 1.0]}
    assert sleeps == want_sleeps
    assert len(calls) == 2 + len(sleeps)

    enqueue_s.update({c: 1.0 for c in range(2, 10)})
    calls.clear()
    with pytest.raises(RuntimeError, match="outlasted"):
        tools.round_robin({"a": fn}, reps=1)


def test_sasscount_counts_by_kernel():
    """tools/sasscount.py on a cut of cuobjdump's output: instructions per
    kernel by opcode (predicated ones too, hex lines not), the kernels'
    names demangled, and one Philox call as the TPDF kernel's excess over
    the undithered one's per sample."""
    from dsd2dxd_tpu_torch.tools import sasscount

    def fn(name, ops):
        lines = [f"\t\tFunction : {name}", "\t.headerflags\t@\"EF_CUDA_SM90\""]
        for i, op in enumerate(ops):
            lines.append(f"        /*{16 * i:04x}*/                   {op} ;"
                         f"   /* 0x000000ff00007a02 */")
            lines.append("                                             "
                         "          /* 0x000fe20000000f00 */")
        return "\n".join(lines)

    none = "_Z13finish_kernelILi24ELi0EEvPKfPhPf12FinishParams"
    tpdf = "_Z13finish_kernelILi24ELi1EEvPKfPhPf12FinishParams"
    body = ["LDG.E.EF.128 R8, desc[UR30][R8.64]", "FMUL R9, R9, UR47",
            "@!P0 BRA 0xb30", "STS.U8 [R3], R2"]
    philox = ["IMAD.WIDE.U32 R14, R28, -0x2daee0ad, RZ",
              "LOP3.LUT R18, R23, UR22, R14, 0x96, !PT",
              "@P1 IMAD.HI.U32 R15, R15, -0x2daee0ad, RZ",
              "I2FP.F32.U32 R32, R32"] * 10
    counts = sasscount.count_sass(fn(none, body) + "\n" + fn(tpdf,
                                                            body + philox))
    assert set(counts) == {"finish_kernel<24,0>", "finish_kernel<24,1>"}
    assert counts["finish_kernel<24,0>"]["all"] == 4
    assert counts["finish_kernel<24,0>"]["BRA"] == 1
    t = counts["finish_kernel<24,1>"]
    assert (t["all"], t["IMAD"], t["LOP3"], t["LDG"], t["STS"]) == (
        44, 20, 10, 1, 1)
    assert (t["PHILOX_MUL"], t["XOR"]) == (20, 10)
    assert counts["finish_kernel<24,0>"]["PHILOX_MUL"] == 0
    assert sasscount.philox_per_sample(counts) == 10.0
    assert sasscount.demangled("main") == "main"
