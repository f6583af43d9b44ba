"""Speed-of-light model of every rate-matrix cell on one NVIDIA H100, and
the card's device rate matrix.

Counterpart of the JAX package's ``tools/lightspeed.py``. For each of the
22 cells (DSD rate -> PCM rate, SURVEY.md §2.5, in the JAX tool's order:
``formats/dsd_types.valid_output_rates``), at 24-bit TPDF, stereo, the
Equiripple bank, it counts the cell's work from its chain alone, the same
whatever kernel implements it (``cell_work``, per audio-second and
channel):

  bytes        the DSD stream read once (rate.hz / 8) and the wire bytes
               written once (out_hz x bytes per sample)
  f32 ops      one product and one sum per tap of each directly
               decimated stage output (``cascade_flops``), then 4 per
               output sample for K1's epilogue; on a 48k cell the ÷2^k
               head so, then 2 T per x160/147 output (T: the band's
               entries per phase, ``rational_plan``) and 5 per output
               sample for K2t's epilogue
  int ops      ``PHILOX_INT_OPS`` per output sample when dithered

The same count per kernel (``k1_work``, ``k2t_work``) adds what a kernel
moves beyond the cell's input and output: the halo, the band's table, the
48k head's f32 samples. ``cell_work`` is their sum with those at 0;
``chip_smoke.py``'s per-tile bounds and ``floorstrip``'s floors take the
same functions. Unlike the JAX tool's, the count decimates every stage
(the TPU's à-trous tail ran undecimated): on the ÷64 and ÷128 heads it is
lower than the JAX ``el16_nohalo_M``, elsewhere equal.

Bounds, in seconds per audio-second (stereo) as audio-seconds per second
(xRT):

  xrt_hbm          the bytes alone over 3.35 TB/s
  xrt_fir          the f32 operations alone over 67 TFLOP/s
  xrt_bound        the largest of the bytes', the f32 operations' and the
                   integer operations' (PEAK_INT32_OPS) times; bound_by
                   names the one that wins
  xrt_floor_nofma  the same with the f32 term doubled: K1 and K2 are
                   bit-equal to plain versions that round each product,
                   so a product and its sum are two instructions
  xrt_model        the card's calibrated model: per class of K1 (÷8-÷32;
                   ÷64 and ÷128) a floor in µs per 16 KiB/ch of input plus
                   a slope in µs per M multiply-adds of the (head) chain,
                   and on a 48k cell K2t's time per output value
                   (``K1_CAL``, ``K2T_S_PER_OUT``); floor_share is the
                   floor's part of it

``--calibrate`` fits those constants on the card: the engine's step
(``ops/fused.make_fused_step``) on ``tools.synth_chain(scale, n)`` at
each scale of ``CAL_SCALES`` and each depth of ``CAL_DEPTHS``, at 24-bit
NONE and TPDF; least squares per class over the points whose every
stage K1 unrolls (``fused.unrolled``: scales 0 and 1; every cell's chain
is unrolled, and the other scales' tap counts run K1's generic loops,
kept as a record); K2t's time per output value from DSD64 -> 192k's step
minus its K1e head. ``--measure`` times every cell
through the step the engine builds (``pipeline/engine._cached_step``: K1,
or K1e + K2t) at the engine's tile (``engine._tile_bytes_for`` at 4 MiB/ch
times the DSD multiple). Both stage random tiles until their input
exceeds twice the card's L2 and time them with ``tools.round_robin``
(CUDA events, the stream held while a run is enqueued, the median of the
repetitions); they raise ConfigError without a card, and a kernel that
does not build or launch fails the run.

    python -m dsd2dxd_tpu_torch.tools.lightspeed [--json PATH]
    python -m dsd2dxd_tpu_torch.tools.lightspeed --calibrate --measure
        [--reps 7] [--cells DSD64:352800,DSD64:192000] [--json PATH]
    python -m dsd2dxd_tpu_torch.tools.lightspeed --device cpu

Without ``--measure`` it prints the model columns. ``--device cpu`` also
runs each cell's plain version at one tile of the smallest size the
engine's tile rule allows and prints no time. ``--json PATH`` writes the
constants, any fits and every row.

Not ported: the JAX tool's ``_measured`` (the TPU's BENCH records) and its
TPU terms (xrt_floor, xrt_vpu, the block and halo redundancy).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from dsd2dxd_tpu_torch.containers.pack import bytes_per_sample
from dsd2dxd_tpu_torch.filters.design import Stage, get_chain
from dsd2dxd_tpu_torch.formats.dsd_types import (
    DitherType,
    DsdRate,
    FilterType,
    valid_output_rates,
)
from dsd2dxd_tpu_torch.ops import fused, philox, rational
from dsd2dxd_tpu_torch.ops.resample import StepConfig
from dsd2dxd_tpu_torch.pipeline import engine
from dsd2dxd_tpu_torch.tools import (
    PEAK_BYTES_PER_S,
    PEAK_F32_FLOPS,
    PEAK_INT32_OPS,
    PHILOX_INT_OPS,
    round_robin,
    synth_chain,
)
from dsd2dxd_tpu_torch.utils.device import card_label, resolve_device
from dsd2dxd_tpu_torch.utils.errors import ConfigError

CELLS = [(rate, list(valid_output_rates(rate)))
         for rate in (DsdRate.DSD64, DsdRate.DSD128, DsdRate.DSD256,
                      DsdRate.DSD512)]
CHANNELS = 2
BIT_DEPTH = 24
DITHER = DitherType.TPDF
K1_EPILOGUE_OPS = 4   # gain, dither sum, round, clip per output sample
K2_EPILOGUE_OPS = 5   # gain, scale, dither sum, round, clip
L2_BYTES = 50 * 1024 * 1024  # an H100 SXM's L2, where torch does not say
SEED = 14

# ---- the card's model (``--calibrate``) -------------------------------------
# (floor µs per 16 KiB/ch of input, slope µs per M multiply-adds per 16
# KiB/ch) of K1 per class, and K2t's seconds per output value. Fitted by
# `python -m dsd2dxd_tpu_torch.tools.lightspeed --calibrate --measure` on
# an NVIDIA H100 80GB HBM3, 700.00 W (utils/device.card_label()),
# 2026-10-17, 8 MiB/ch tiles, 7 repetitions: 12 and 8 unrolled points.
# Largest residuals: ÷8-÷32 0.075 µs, 24.2 % of ÷8 scale 0 TPDF (NONE and
# TPDF are pooled, and Philox's cost per output sample is four times
# larger per input byte at ÷8 than at ÷32); ÷64-÷128 0.044 µs, 9.6 % of ÷64
# scale 1 NONE. K2t: DSD64 -> 192k's step 0.3070 ms minus its K1e head
# 0.2097 ms per 8.04 MiB/ch tile.
K1_CLASSES = ("÷8-÷32", "÷64-÷128")
K1_CAL = {"÷8-÷32": (0.2116, 0.0979), "÷64-÷128": (0.1712, 0.1366)}
K2T_S_PER_OUT = 1.0602e-11
CAL_SCALES = (0.0, 0.25, 0.5, 1.0)
CAL_DEPTHS = {"÷8-÷32": (3, 4, 5), "÷64-÷128": (6, 7)}
CAL_DITHERS = (DitherType.NONE, DitherType.TPDF)
CAL_TILE_TARGET = 8 * 1024 * 1024  # bytes per channel (the engine's DSD128)


# ---- the work ----------------------------------------------------------------
def cascade_flops(chain: Sequence[Stage],
                  n_stages: Optional[int] = None) -> int:
    """f32 operations per output frame and channel of a ÷R cascade's
    first n_stages stages (all for None): each stage's outputs per frame
    times its taps, one product and one sum each."""
    r, cum, macs = 1, 1, 0
    for s in chain:
        r *= s.M
    for s in chain[:n_stages]:
        cum *= s.M
        macs += s.n_taps * (r // cum)
    return 2 * macs


def macs_16k(chain: Sequence[Stage]) -> float:
    """M multiply-adds per 16 KiB of input per channel of a ÷R cascade."""
    return cascade_flops(chain) // 2 * (16384 * 8 // fused.decimation(chain)) / 1e6


def _philox_ops(dither: DitherType) -> int:
    return 0 if dither is DitherType.NONE else PHILOX_INT_OPS


def k1_work(chain: Sequence[Stage], frames: int, channels: int = CHANNELS,
            bit_depth: Optional[int] = BIT_DEPTH,
            dither: DitherType = DITHER, halo_bytes: int = 0,
            out_bytes: Optional[int] = None) -> tuple[int, int, int]:
    """(bytes, f32 operations, 32-bit integer operations) of K1 on
    `frames` output frames per channel of a ÷R chain: the input (frames R
    / 8 bytes and `halo_bytes` per channel) read once, each output value
    (`out_bytes`: the wire's bytes per sample by default) written once;
    the cascade and, with a bit depth, the epilogue and one Philox call
    per sample when dithered. bit_depth None is K1e, the planar head of a
    48k chain: f32 out (4 bytes; 0 where the tail takes its samples on
    chip, as ``cell_work`` counts it) and no epilogue."""
    n = channels * frames
    nbytes = channels * (frames * fused.decimation(chain) // 8 + halo_bytes)
    if bit_depth is None:
        return (nbytes + n * (4 if out_bytes is None else out_bytes),
                cascade_flops(chain) * n, 0)
    return (nbytes + n * (bytes_per_sample(bit_depth) if out_bytes is None
                          else out_bytes),
            (cascade_flops(chain) + K1_EPILOGUE_OPS) * n,
            _philox_ops(dither) * n)


def k2t_work(n_out: int, n_taps: int, channels: int = CHANNELS,
             bit_depth: Optional[int] = BIT_DEPTH,
             dither: DitherType = DITHER, in_values: int = 0,
             table_bytes: int = 0) -> tuple[int, int, int]:
    """(bytes, f32 operations, 32-bit integer operations) of K2t on n_out
    final frames per channel: `in_values` f32 values per channel read
    (the head's samples and the history; 0 where they come on chip) and
    `table_bytes` once, the wire bytes written once; 2 n_taps + 5 f32
    operations per sample and one Philox call when dithered. n_taps 0
    with in_values n_out is K2 "from z"; bit_depth None the x160/147 tail
    alone (f32 out, no epilogue)."""
    n = channels * n_out
    nbytes = channels * in_values * 4 + table_bytes
    if bit_depth is None:
        return nbytes + n * 4, 2 * n_taps * n, 0
    return (nbytes + n * bytes_per_sample(bit_depth),
            (2 * n_taps + K2_EPILOGUE_OPS) * n, _philox_ops(dither) * n)


def bound_terms(work, fma: bool = True) -> dict:
    """{"bytes", "f32", "int"}: the seconds of each part of `work` at the
    card's peaks; the f32 term doubled without FMA."""
    nbytes, flops, int_ops = work
    return {"bytes": nbytes / PEAK_BYTES_PER_S,
            "f32": (1 if fma else 2) * flops / PEAK_F32_FLOPS,
            "int": int_ops / PEAK_INT32_OPS}


def bound_s(work, fma: bool = True) -> tuple[float, str]:
    """(seconds, the term that wins: "bytes", "f32" or "int")."""
    terms = bound_terms(work, fma)
    by = max(terms, key=terms.get)
    return terms[by], by


def bound_ms(work, fma: bool = True) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time of `work` on the
    card (each input read once, each output written once; the terms
    overlap)."""
    s, by = bound_s(work, fma)
    return s * 1e3, "bytes" if by == "bytes" else "operations"


def cell_chain(rate: DsdRate, out_hz: int):
    """(chain, head, n_taps) of a cell: its Equiripple chain, the ÷2^k part
    K1 runs, and T, the x160/147 band's entries per phase (0 on a 44.1k
    cell)."""
    chain = get_chain(FilterType.EQUIRIPPLE, rate, out_hz)
    n_head = rational.rational_head_len(chain)
    if n_head is None:
        return chain, chain, 0
    return chain, chain[:n_head], rational.rational_plan(chain).table[1].shape[1]


def cell_work(rate: DsdRate, out_hz: int, bit_depth: int = BIT_DEPTH,
              dither: DitherType = DITHER) -> tuple[int, int, int]:
    """The cell's (bytes, f32 operations, integer operations) per
    audio-second and channel, from its chain alone."""
    _chain, head, n_taps = cell_chain(rate, out_hz)
    frames = rate.hz // fused.decimation(head)
    if not n_taps:
        return k1_work(head, frames, 1, bit_depth, dither)
    w1 = k1_work(head, frames, 1, None, out_bytes=0)
    w2 = k2t_work(out_hz, n_taps, 1, bit_depth, dither)
    return tuple(a + b for a, b in zip(w1, w2))


def k1_class(head: Sequence[Stage]) -> str:
    return K1_CLASSES[fused.decimation(head) > 32]


def cell_model(rate: DsdRate, out_hz: int, cal: Optional[dict] = None,
               k2t_s: Optional[float] = None) -> dict:
    """Bounds and the calibrated model of one cell, stereo, 24-bit TPDF;
    every xrt_* in audio-seconds per second."""
    cal = K1_CAL if cal is None else cal
    k2t_s = K2T_S_PER_OUT if k2t_s is None else k2t_s
    _chain, head, n_taps = cell_chain(rate, out_hz)
    work = tuple(CHANNELS * v for v in cell_work(rate, out_hz))
    terms = bound_terms(work)
    t_bound, by = bound_s(work)
    t_nofma, _ = bound_s(work, fma=False)
    floor_us, slope_us = cal[k1_class(head)]
    per_16k = rate.hz / 8 / 16384
    t_floor = per_16k * floor_us * 1e-6
    t_model = (t_floor + per_16k * slope_us * macs_16k(head) * 1e-6
               + (out_hz * CHANNELS * k2t_s if n_taps else 0.0))
    return {"cell": f"{rate.name}->{out_hz}", "rational": bool(n_taps),
            "decimation": fused.decimation(head), "n_taps": n_taps,
            "k1_class": k1_class(head),
            "macs16_M": round(macs_16k(head), 3),
            "bytes": work[0], "f32_ops": work[1], "int_ops": work[2],
            "xrt_hbm": 1.0 / terms["bytes"],
            "xrt_fir": 1.0 / terms["f32"],
            "xrt_bound": 1.0 / t_bound, "bound_by": by,
            "xrt_floor_nofma": 1.0 / t_nofma,
            "xrt_model": 1.0 / t_model,
            "floor_share": t_floor / t_model}


def cell_label(row: dict) -> str:
    rate, hz = row["cell"].split("->")
    return f"{rate}->{int(hz) / 1000:g}k"


# ---- the card ------------------------------------------------------------------
def staged_tiles(dev: torch.device, tile: int, gen: torch.Generator):
    """Random (CHANNELS, tile) uint8 tiles on the card, enough that their
    bytes exceed twice its L2: views of one buffer, freed together."""
    l2 = getattr(torch.cuda.get_device_properties(dev), "L2_cache_size",
                 0) or L2_BYTES
    n = max(2, 2 * l2 // (CHANNELS * tile) + 1)
    flat = torch.randint(0, 256, (n * CHANNELS * tile,), dtype=torch.uint8,
                         device=dev, generator=gen)
    return [flat[i * CHANNELS * tile:(i + 1) * CHANNELS * tile].view(
        CHANNELS, tile) for i in range(n)]


def _tile_run(step, xs, state0):
    """fn() that runs `step` over the staged tiles, its state carried from
    tile to tile as the engine carries it."""
    keys = [philox.tile_key(SEED, i) for i in range(len(xs))]

    def run():
        state = state0
        for x, k in zip(xs, keys):
            state = step(x, state, k)[2]

    return run


def _launched(before: dict) -> dict:
    return {k: v - before[k] for k, v in fused.MODE_LAUNCHES.items()
            if v > before[k]}


def _fit(points: list) -> dict:
    """Least squares us16 = floor + slope x macs16 over a class's points
    whose every stage K1 unrolls (every cell's are; the others run its
    generic loops and are kept as a record), and its largest residual."""
    fit = [p for p in points if p["unrolled"]]
    x = np.array([p["macs16_M"] for p in fit])
    y = np.array([p["us16"] for p in fit])
    (floor, slope), *_ = np.linalg.lstsq(
        np.stack([np.ones_like(x), x], axis=1), y, rcond=None)
    resid = y - (floor + slope * x)
    i = int(np.argmax(np.abs(resid)))
    return {"floor_us": float(floor), "slope_us": float(slope),
            "points": points, "n_fit": len(fit),
            "max_resid_us": float(abs(resid[i])),
            "max_resid_pct": float(abs(resid[i]) / y[i] * 100),
            "max_resid_at": fit[i]["name"]}


def calibrate(dev: torch.device, reps: int, gen: torch.Generator) -> dict:
    """Fit K1_CAL and K2T_S_PER_OUT on the card (see the module's text)."""
    fits = {}
    for cls, depths in CAL_DEPTHS.items():
        points = []
        for depth in depths:
            chains = {s: synth_chain(s, depth) for s in CAL_SCALES}
            tiles = {s: engine._tile_bytes_for(c, CAL_TILE_TARGET)
                     for s, c in chains.items()}
            flat = staged_tiles(dev, max(tiles.values()), gen)
            fns, meta = {}, {}
            for s, chain in chains.items():
                t = tiles[s]
                xs = [x.reshape(-1)[:CHANNELS * t].view(CHANNELS, t)
                      for x in flat]
                for d in CAL_DITHERS:
                    cfg = StepConfig(channels=CHANNELS, tile_bytes=t,
                                     bit_depth=BIT_DEPTH, dither=d,
                                     level_db=0.0)
                    name = f"÷{fused.decimation(chain)} scale {s} {d.name}"
                    fns[name] = _tile_run(
                        fused.make_fused_step(chain, cfg, dev), xs,
                        fused.init_fused_halo(chain, CHANNELS, dev))
                    meta[name] = (chain, t, len(xs))
            times = round_robin(fns, reps)
            for name, (chain, t, n) in meta.items():
                ms = statistics.median(times[name]) / n
                points.append({"name": name, "tile": t,
                               "unrolled": fused.unrolled(chain),
                               "macs16_M": macs_16k(chain),
                               "ms_per_tile": ms,
                               "us16": ms * 1e3 / (t / 16384)})
            del flat, fns
        fits[cls] = _fit(points)
    # K2t: DSD64 -> 192k's step minus its K1e head, per output value
    key = (FilterType.EQUIRIPPLE, DsdRate.DSD64, 192000)
    chain, head, _n_taps = cell_chain(DsdRate.DSD64, 192000)
    tile = engine._tile_bytes_for(chain, CAL_TILE_TARGET)
    cfg = StepConfig(channels=CHANNELS, tile_bytes=tile, bit_depth=BIT_DEPTH,
                     dither=DITHER, level_db=0.0)
    step, make_state = engine._cached_step(key, cfg, dev)
    run_head = fused.make_head(head, dev)
    xs = staged_tiles(dev, tile, gen)
    halo = make_state()[0]

    def heads():
        for x in xs:
            run_head(x, halo)

    times = round_robin({"step": _tile_run(step, xs, make_state()),
                         "head": heads}, reps)
    step_ms, head_ms = (statistics.median(times[k]) / len(xs)
                        for k in ("step", "head"))
    n_out = tile * 8 // fused.decimation(head) * 160 // 147
    fits["K2t"] = {"s_per_out": (step_ms - head_ms) * 1e-3 / (n_out * CHANNELS),
                   "step_ms": step_ms, "head_ms": head_ms, "tile": tile}
    return fits


def measure_cell(rate: DsdRate, out_hz: int, dev: torch.device, reps: int,
                 gen: torch.Generator) -> dict:
    """The device xRT of one cell through the engine's step at the
    engine's tile, 24-bit TPDF, level 0 dB, stereo."""
    key = (FilterType.EQUIRIPPLE, rate, out_hz)
    chain, head, n_taps = cell_chain(rate, out_hz)
    tile = engine._tile_bytes_for(
        chain, engine._DEFAULT_TILE_TARGET * (rate.hz // DsdRate.DSD64.hz))
    cfg = StepConfig(channels=CHANNELS, tile_bytes=tile, bit_depth=BIT_DEPTH,
                     dither=DITHER, level_db=0.0)
    step, make_state = engine._cached_step(key, cfg, dev)
    before = dict(fused.MODE_LAUNCHES)
    xs = staged_tiles(dev, tile, gen)
    wire, peak, _ = step(xs[0], make_state(), 0)
    n_out = tile * 8 // fused.decimation(head)
    if n_taps:
        n_out = n_out * 160 // 147
    if (wire.numel() != n_out * CHANNELS * bytes_per_sample(BIT_DEPTH)
            or not bool(torch.isfinite(peak))):
        raise RuntimeError(f"{rate.name}->{out_hz}: {wire.numel()} wire "
                           f"bytes, peak {float(peak)}")
    ms = round_robin({"cell": _tile_run(step, xs, make_state())}, reps)["cell"]
    launches = _launched(before)
    want = ("K1e", "K2t") if n_taps else fused.kernel_modes(head, BIT_DEPTH)
    if not all(launches.get(m, 0) > 0 for m in want):
        raise RuntimeError(f"{rate.name}->{out_hz}: launches {launches}, "
                           f"want {want}")
    med = statistics.median(ms) / len(xs)
    audio = tile * 8 / rate.hz
    return {"xrt": audio / (med * 1e-3), "ms_per_tile": med, "tile": tile,
            "tiles": len(xs), "audio_s_per_tile": audio,
            "ms_runs": [m / len(xs) for m in ms], "launches": launches}


def plain_cell(rate: DsdRate, out_hz: int) -> str:
    """The cell's plain version on the CPU at its smallest engine tile:
    a line on its output, no time."""
    key = (FilterType.EQUIRIPPLE, rate, out_hz)
    chain = get_chain(*key)
    tile = engine._tile_bytes_for(chain, 1)
    cfg = StepConfig(channels=CHANNELS, tile_bytes=tile, bit_depth=BIT_DEPTH,
                     dither=DITHER, level_db=0.0)
    cpu = torch.device("cpu")
    step, make_state = engine._cached_step(key, cfg, cpu)
    x = torch.randint(0, 256, (CHANNELS, tile), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(SEED))
    wire, peak, _ = step(x, make_state(), 0)
    return (f"{tile} B/ch tile -> {wire.numel()} wire bytes, peak "
            f"{float(peak):.6f}")


# ---- the report -----------------------------------------------------------------
def _parse_cells(text: Optional[str]) -> list:
    if not text:
        return [(rate, hz) for rate, outs in CELLS for hz in outs]
    cells = []
    for item in text.split(","):
        name, _, hz = item.partition(":")
        try:
            rate, hz = DsdRate[name], int(hz)
        except (KeyError, ValueError):
            raise ConfigError(f"--cells wants RATE:HZ items (DSD64:352800), "
                              f"got {item!r}") from None
        if hz not in valid_output_rates(rate):
            raise ConfigError(f"{name}:{hz} is not a cell of the rate matrix")
        cells.append((rate, hz))
    return cells


def _fmt(v, spec=".0f") -> str:
    return "-" if v is None else format(v, spec)


def print_table(rows: list) -> None:
    print(f"{'cell':>15} {'measured xRT':>12} {'xrt_model':>9} "
          f"{'% model':>7} {'xrt_bound (by)':>18} {'of bound':>8} "
          f"{'floor_nofma':>11} {'xrt_hbm':>9}")
    for r in rows:
        m = r.get("measured")
        print(f"{cell_label(r):>15} {_fmt(m):>12} {r['xrt_model']:>9.0f} "
              f"{_fmt(m and 100 * m / r['xrt_model'], '.1f'):>7} "
              f"{r['xrt_bound']:>10.0f} ({r['bound_by']:>5}) "
              f"{_fmt(m and 100 * r['share_bound'], '.1f'):>8} "
              f"{r['xrt_floor_nofma']:>11.0f} {r['xrt_hbm']:>9.0f}")


def main(argv=None) -> dict:
    """Returns {"card", "constants", "fits" (with --calibrate), "rows"}."""
    ap = argparse.ArgumentParser(
        prog="lightspeed", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--measure", action="store_true",
                    help="time every cell on the card (the device rate matrix)")
    ap.add_argument("--calibrate", action="store_true",
                    help="fit the model's constants on the card")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--cells", default=None,
                    help="RATE:HZ,... to measure (default: all 22)")
    ap.add_argument("--device", default=None,
                    help="cuda device for --measure and --calibrate (default: "
                         "the first card); 'cpu' runs each cell's plain "
                         "version at a tiny tile, untimed")
    ap.add_argument("--json", type=Path, default=None,
                    help="also write the constants, fits and rows as JSON")
    args = ap.parse_args(argv)
    cells = _parse_cells(args.cells)
    timed = args.measure or args.calibrate
    dev = resolve_device(args.device) if timed or args.device else None
    if timed and dev.type != "cuda":
        raise ConfigError("--measure and --calibrate time the card: no CPU "
                          "fallback (--device cpu runs the plain versions, "
                          "untimed)")
    label = card_label().splitlines()[0] if timed else None
    gen = torch.Generator(device=dev).manual_seed(SEED) if timed else None
    t0 = time.perf_counter()
    out = {"card": label, "constants": {
        "peak_bytes_per_s": PEAK_BYTES_PER_S, "peak_f32_flops": PEAK_F32_FLOPS,
        "peak_int32_ops": PEAK_INT32_OPS, "philox_int_ops": PHILOX_INT_OPS,
        "k1_cal": K1_CAL, "k2t_s_per_out": K2T_S_PER_OUT}}
    if args.calibrate:
        fits = calibrate(dev, args.reps, gen)
        out["fits"] = fits
        for cls in K1_CLASSES:
            f = fits[cls]
            print(f"calibrate {cls}: floor {f['floor_us']:.4f} µs per 16 "
                  f"KiB/ch, slope {f['slope_us']:.4f} µs per M multiply-adds "
                  f"({f['n_fit']} of {len(f['points'])} points; committed "
                  f"{K1_CAL[cls][0]}, {K1_CAL[cls][1]}); largest residual "
                  f"{f['max_resid_us']:.4f} µs ({f['max_resid_pct']:.1f} % "
                  f"of its point, {f['max_resid_at']}) [{label}]")
            for unrolled in (True, False):
                print(f"  {'fitted' if unrolled else 'generic loops, not fitted'}"
                      f" (µs per 16 KiB/ch at M multiply-adds): " + ", ".join(
                          f"{p['name']} {p['us16']:.4f} at {p['macs16_M']:.3f}"
                          for p in f["points"] if p["unrolled"] is unrolled))
        k = fits["K2t"]
        print(f"calibrate K2t: {k['s_per_out']:.4e} s per output value "
              f"(DSD64->192k step {k['step_ms']:.4f} - K1e head "
              f"{k['head_ms']:.4f} ms per {k['tile']} B/ch tile; committed "
              f"{K2T_S_PER_OUT:.4e}) [{label}]")
    rows = []
    for rate, hz in cells:
        row = cell_model(rate, hz)
        row["measured"] = None
        if args.measure:
            meas = measure_cell(rate, hz, dev, args.reps, gen)
            row.update(measured=meas["xrt"], device=meas,
                       share_bound=meas["xrt"] / row["xrt_bound"],
                       share_floor_nofma=meas["xrt"] / row["xrt_floor_nofma"],
                       pct_model=100 * meas["xrt"] / row["xrt_model"])
        elif dev is not None and dev.type == "cpu":
            row["plain"] = plain_cell(rate, hz)
            print(f"  plain {cell_label(row)}: {row['plain']} (no time)")
        rows.append(row)
    out["rows"] = rows
    print_table(rows)
    if args.measure:
        ranked = sorted(rows, key=lambda r: r["share_floor_nofma"])
        print("most headroom (lowest measured / no-FMA floor): " + ", ".join(
            f"{cell_label(r)} {100 * r['share_floor_nofma']:.1f} %"
            for r in ranked[:4]))
    if timed:
        print(f"lightspeed: {time.perf_counter() - t0:.1f} s on the card "
              f"[{label}]")
    if args.json:
        args.json.write_text(json.dumps(out, indent=1, default=str))
        print(f"wrote {args.json}")
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
