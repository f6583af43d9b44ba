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
from dsd2dxd_tpu_torch.ops.plan import state_from_jax  # noqa: E402
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
    the JAX output exactly (noflush: the last block's, the one the TPU's
    sequential grid leaves in the shared output block)."""
    xp, g, rows, n_blocks, _l8, outs = p1_jax
    x = torch.from_numpy(xp.view(np.int32))
    src = (dmabench.relayout(x, g, n_blocks) if mode in ("contig", "bspec")
           else x)
    got = dmabench.dma_probe(src, mode, g, rows, n_blocks)
    if mode == "noflush":
        assert got.shape == (rows, n_blocks, g.k_sub)
        got = got[:, -1]
    np.testing.assert_array_equal(got.numpy()[0], outs[mode][0])


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
                       dma.reshape(2, n, g.k_sub))


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


@pytest.mark.parametrize("key,block_out", [
    ("synth", None), ("synth", 100), ("E64", None), ("E256", None)])
def test_p2_block_cascade_at_the_stages_strides_is_the_cascade(key,
                                                                block_out):
    """cas0a's plain version runs each block's window through the cascade
    as the kernel does; at the stages' own strides it is the plain
    cascade, bit for bit, so only the stride-1 reads differ in cas0a."""
    from dsd2dxd_tpu_torch.filters.design import get_chain
    from dsd2dxd_tpu_torch.formats.dsd_types import DsdRate, FilterType

    chain = {"synth": synth_chain(0.0),
             "E64": get_chain(FilterType.EQUIRIPPLE, DsdRate.DSD64, 352800),
             "E256": get_chain(FilterType.EQUIRIPPLE, DsdRate.DSD256,
                               88200)}[key]
    fb = fused.decimation(chain) // 8
    bo = block_out or fused.block_out_for(chain)
    tile = bo * fb * 5 // 2 // fb * fb
    rng = np.random.default_rng(43)
    x = torch.from_numpy(rng.integers(0, 256, (2, tile), dtype=np.uint8))
    halo = torch.from_numpy(rng.integers(
        0, 256, (2, fused.chain_halo_bytes(chain)), dtype=np.uint8))
    lay = fused.block_layout(chain, halo.shape[1], bo)
    t_out = tile // fb
    y = floorstrip.block_cascade(x, halo, _taps(chain), lay,
                                 -(-t_out // bo), stride1=False)[:, :t_out]
    assert torch.equal(y, fused.fused_decim_cascade(x, halo, _taps(chain),
                                                    chain, 1.0))


def test_p2_rungs_on_the_cpu():
    """Each rung's plain version: dma the block's first bytes, unpack the
    ±1 sums of every block_out-th sample, cas0a a wrong cascade of the
    real shape, quant the TPDF epilogue's int32 words."""
    chain, cfg, bo = floorstrip.probe_config(0, None)
    tile = 3 * cfg.tile_bytes
    cfg = StepConfig(channels=2, tile_bytes=tile, bit_depth=24,
                     dither=DitherType.TPDF, level_db=0.0)
    rng = np.random.default_rng(44)
    x = torch.from_numpy(rng.integers(0, 256, (2, tile), dtype=np.uint8))
    halo = fused.init_fused_halo(chain, 2)
    lay = fused.block_layout(chain, halo.shape[1], bo)
    outs = {r: floorstrip.make_probe_step(chain, cfg, r, "cpu")(x, halo, 9)
            for r in floorstrip.KERNEL_RUNGS}
    t_out = tile // 8
    window = torch.cat([halo, x], dim=1)
    first = window[:, lay.byte_off:lay.byte_off + bo].to(torch.float32)
    assert torch.equal(outs["dma"][0][:, :bo], first)
    assert outs["dma"][1] is None and outs["unpack"][1] is None
    bits = fused.unpack_bits(window[:, lay.byte_off:lay.byte_off + 8 * bo])
    sums = bits.reshape(2, 64, bo).sum(dim=1)  # samples j, j + bo, ...
    assert torch.equal(outs["unpack"][0][:, :bo], sums)
    y, pk = outs["cas0"]
    assert y.shape == outs["cas0a"][0].shape == (2, t_out)
    assert not torch.equal(y, outs["cas0a"][0])
    assert float(pk) == float(y.abs().max())
    q, qpk = outs["quant"]
    assert q.dtype == torch.int32 and float(qpk) == float(pk)
    e = q.double() - y.double() * 2 ** 23
    assert e.abs().max() <= 1.5 and 0.3 < float(e.pow(2).mean().sqrt()) < 0.7
    before = dict(floorstrip.LAUNCHES)
    floorstrip.make_probe_step(chain, cfg, "cas0", "cpu")(x, halo, 9)
    assert floorstrip.LAUNCHES == before
    with pytest.raises(ValueError):
        floorstrip.make_probe_step(chain, cfg, "fan", "cpu")


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
