"""The port's speed-of-light model (dsd2dxd_tpu_torch/tools/lightspeed.py)
on the CPU, against the JAX package's tools/lightspeed.py.

Held against the JAX tool: the cells and their order, the rational flag
of each cell, and the multiply-adds per 16 KiB/ch of input -- equal at
the JAX tool's three decimals where its plan has no à-trous tail
(``fused_plan(chain)[2] == 1``; the head alone on a 48k cell), strictly
lower where it has one (the port decimates every stage, the TPU's tail
ran undecimated). Held on the port's own count: the bounds' order, the
term that wins, the input scaling with the DSD rate, the seven per-tile
bounds of PERF.md's kernel table (chip_smoke.py's timing rows) to three
significant figures, the CPU run's 22 rows without a time, and no CPU
fallback for --measure and --calibrate.
"""

import contextlib
import io
import math
import sys
from pathlib import Path

import pytest

from dsd2dxd_tpu.filters.design import get_chain as jget_chain
from dsd2dxd_tpu.formats.dsd_types import FilterType as JFilterType
from dsd2dxd_tpu.ops import fused as jfused
from dsd2dxd_tpu_torch.filters.design import get_chain
from dsd2dxd_tpu_torch.formats.dsd_types import DitherType, DsdRate, FilterType
from dsd2dxd_tpu_torch.ops import fused, rational
from dsd2dxd_tpu_torch.pipeline import engine
from dsd2dxd_tpu_torch.tools import lightspeed
from dsd2dxd_tpu_torch.utils.errors import ConfigError

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

import lightspeed as jlightspeed  # noqa: E402

CELLS = [(rate, hz) for rate, outs in lightspeed.CELLS for hz in outs]
IDS = [f"{rate.name}->{hz}" for rate, hz in CELLS]
E = FilterType.EQUIRIPPLE
TILE = 16 * 1024 * 1024
# PERF.md's "bound ms" per 16 MiB/ch stereo tile (K1e, K2, K2t: DSD64 ->
# 192k's 16.08 MiB/ch tile), chip_smoke.py's timing rows
PER_TILE_BOUNDS = {"K1a": 0.160, "K1b": 0.168, "K1c": 0.149, "÷128": 0.147,
                   "K1e": 0.168, "K2": 0.0383, "K2t": 0.0366}
K1_ROWS = {"K1a": (DsdRate.DSD64, 352800), "K1b": (DsdRate.DSD64, 176400),
           "K1c": (DsdRate.DSD128, 88200), "÷128": (DsdRate.DSD256, 88200)}

_JAX_MODELS: dict = {}


def _jax_model(rate, hz):
    if (rate, hz) not in _JAX_MODELS:
        jrate = jlightspeed.DsdRate[rate.name]
        _JAX_MODELS[(rate, hz)] = jlightspeed.cell_model(jrate, hz)
    return _JAX_MODELS[(rate, hz)]


def _jax_r_tail(rate, hz) -> int:
    chain = list(jget_chain(JFilterType.EQUIRIPPLE,
                            jlightspeed.DsdRate[rate.name], hz))
    plan = jfused.fused_plan(chain)
    if plan is None:
        plan = jfused.fused_plan(chain[:jfused.fused_rational_plan(chain)])
    return plan[2]


@pytest.mark.parametrize("i", range(len(CELLS)), ids=IDS)
def test_cells_are_the_jax_tools(i):
    jcells = [(r.name, hz) for r, outs in jlightspeed.CELLS for hz in outs]
    assert len(jcells) == len(CELLS) == 22
    rate, hz = CELLS[i]
    assert (rate.name, hz) == jcells[i]


@pytest.mark.parametrize("rate,hz", CELLS, ids=IDS)
def test_rational_flag_is_the_jax_tools(rate, hz):
    assert (lightspeed.cell_model(rate, hz)["rational"]
            is _jax_model(rate, hz)["rational"])


@pytest.mark.parametrize("rate,hz", CELLS, ids=IDS)
def test_multiply_adds_against_the_jax_count(rate, hz):
    """Equal without an à-trous tail, strictly lower with one."""
    port = lightspeed.cell_model(rate, hz)["macs16_M"]
    jax = _jax_model(rate, hz)["el16_nohalo_M"]
    if _jax_r_tail(rate, hz) == 1:
        assert port == jax
    else:
        assert port < jax


@pytest.mark.parametrize("rate,hz", CELLS, ids=IDS)
def test_bounds_ordered_and_named(rate, hz):
    m = lightspeed.cell_model(rate, hz)
    assert m["xrt_hbm"] >= m["xrt_bound"] >= m["xrt_floor_nofma"] > 0
    assert m["xrt_model"] > 0 and 0 < m["floor_share"] < 1
    terms = lightspeed.bound_terms((m["bytes"], m["f32_ops"], m["int_ops"]))
    assert m["bound_by"] == max(terms, key=terms.get)
    assert math.isclose(1 / m["xrt_bound"], max(terms.values()))
    assert math.isclose(1 / m["xrt_hbm"], terms["bytes"])


@pytest.mark.parametrize("rate,hz", CELLS, ids=IDS)
def test_cell_heads_run_the_calibrated_path(rate, hz):
    """Every cell's ÷2^k head runs K1's unrolled cases, as the model's
    fitted points do, at a depth its class calibrates."""
    _chain, head, _n_taps = lightspeed.cell_chain(rate, hz)
    assert fused.unrolled(head)
    depth = fused.decimation(head).bit_length() - 1
    assert depth in lightspeed.CAL_DEPTHS[lightspeed.k1_class(head)]


@pytest.mark.parametrize("out_hz", [352800])
def test_input_bytes_scale_with_the_dsd_rate(out_hz):
    """DSD512 -> 352.8k reads 8x DSD64 -> 352.8k's input and writes the
    same output bytes."""
    b64 = lightspeed.cell_work(DsdRate.DSD64, out_hz)[0]
    b512 = lightspeed.cell_work(DsdRate.DSD512, out_hz)[0]
    in64, in512 = DsdRate.DSD64.hz // 8, DsdRate.DSD512.hz // 8
    assert in512 == 8 * in64
    assert b64 - in64 == b512 - in512 == out_hz * 3


def _per_tile_work(row):
    if row in K1_ROWS:
        chain = get_chain(E, *K1_ROWS[row])
        frames = TILE * 8 // fused.decimation(chain)
        return lightspeed.k1_work(chain, frames, 2, 24, DitherType.TPDF,
                                  fused.chain_halo_bytes(chain))
    chain = get_chain(E, DsdRate.DSD64, 192000)
    rp = rational.rational_plan(chain)
    head = chain[:rp.n_head]
    tile = engine._tile_bytes_for(chain, TILE)
    n_base = tile * 8 // rp.r_head
    n_out = n_base * 160 // 147
    if row == "K1e":
        return lightspeed.k1_work(head, n_base, 2, None,
                                  halo_bytes=fused.chain_halo_bytes(head))
    if row == "K2":
        return lightspeed.k2t_work(n_out, 0, 2, 24, DitherType.TPDF,
                                   in_values=n_out)
    table = rational.kernel_table(rp)
    return lightspeed.k2t_work(n_out, table.n_taps, 2, 24, DitherType.TPDF,
                               in_values=n_base + rp.p_in,
                               table_bytes=(table.coefs.numel()
                                            + table.offs.numel()) * 4)


@pytest.mark.parametrize("row", list(PER_TILE_BOUNDS))
def test_per_tile_bounds_reproduced(row):
    ms, _by = lightspeed.bound_ms(_per_tile_work(row))
    assert float(f"{ms:.3g}") == PER_TILE_BOUNDS[row], ms


def test_cpu_run_prints_22_rows_and_no_time():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = lightspeed.main(["--device", "cpu"])
    text = buf.getvalue()
    table = [ln for ln in text.splitlines()
             if ln.split() and ln.split()[0] in
             {lightspeed.cell_label(r) for r in out["rows"]}]
    assert len(out["rows"]) == len(table) == 22
    assert all(r["measured"] is None and "plain" in r for r in out["rows"])
    assert text.count("(no time)") == 22
    assert " ms" not in text and "µs" not in text and "most headroom" not in text


@pytest.mark.parametrize("argv", [["--measure"], ["--calibrate"],
                                  ["--device", "cpu", "--measure"],
                                  ["--device", "cpu", "--calibrate"]])
def test_timed_modes_have_no_cpu_fallback(argv, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(ConfigError):
        lightspeed.main(argv)
