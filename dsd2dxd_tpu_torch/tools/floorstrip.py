"""P2: a ladder of the fused kernel (K1) cut short, on the card.

Counterpart of the JAX package's ``tools/floorstrip.py`` (its Pallas probe
``_probe_step`` and its main). Each rung is K1's own body
(``csrc/decim_body.cuh``, ``decim_body<RUNG>``) on K1's ``DecimParams``
(``ops/fused.py::_kernel_params``) and K1's launch, stopped at a later
point (``csrc/probes.cu``, ``probe_step_kernel``), so the increment from
one rung to the next is one part of K1's time:

  dma     the coefficients' copy and K1's packed window copy (16-byte
          loads of the aligned span); store the block's first window bytes
          as f32, the cheapest store that depends on them
  fan     no counterpart: the TPU ladder's sublane fan-in of sub-blocks.
          K1's blocks are independent windows with no fan-in; the
          printout keeps the row
  unpack  + stage 0 through the exact 4-tap tables. K1 has no separate
          unpack (the tables turn bits into products): frame m0 + j stores
          the block's stage-0 output j
  cas0a   + the ÷2 stages, with every stage-0 read of 32 window bits taken
          as the aligned word that holds its first bit (no funnel shift),
          and the generic ÷2 loop's reads rounded down to their float4;
          numerically wrong on purpose, so cas0 - cas0a is the share of
          the funnel shifts
  cas0    + the real cascade and the peak over the first n_valid frames;
          planar f32 at gain 1 (K1e's output)
  quant   + K1's 24-bit epilogue (dither, rint, clip) as int32, at NONE
          and at TPDF: their gap is the Philox share
  full    K1 itself, ``ops/fused.make_fused_step`` (wire bytes)

The plain versions (``probe_step_reference``): dma the window bytes;
unpack and cas0a run each block's window as the kernel copies it (an
aligned tile, so each block's 16-byte alignment follows from its offset)
through stage 0's tables and the ÷2 stages, block by block; cas0 and
quant are ``fused_decim_cascade`` and ``epilogue_words``.

    python -m dsd2dxd_tpu_torch.tools.floorstrip [--chain synth|config1]
        [--block-out N] [--tile-mib 16] [--reps 8]
    python -m dsd2dxd_tpu_torch.tools.floorstrip --device cpu

``synth`` is ``synth_chain(0.0)`` (six ÷2 stages of 2 taps, the DSD512 ->
352.8k structure at the scale-0 taps: the tap-independent floor), as the
TPU tool runs it; ``config1`` is BASELINE config 1's chain, ``get_chain(E,
DSD64, 352800)`` (÷8). The tile is 24-bit TPDF, level 0, two channels, at
K1's block_out. Per rung it prints ms per tile (median over the
repetitions of ``STAGED_TILES`` staged tiles), the increment over the
rung before, its floor and its share of it. The floor is the largest of
the bytes (tile and halo in once, the rung's output out once) over 3.35
TB/s, the cascade's f32 operations over 67 TFLOP/s times two (bit-equality
forbids FMA, so a product and its sum are two instructions) and, at TPDF,
18 integer operations per Philox call over 16.75 TOP/s.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import statistics
import sys
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from dsd2dxd_tpu_torch import kernels
from dsd2dxd_tpu_torch.containers.pack import bytes_per_sample
from dsd2dxd_tpu_torch.filters.design import Stage, get_chain
from dsd2dxd_tpu_torch.formats.dsd_types import DitherType, DsdRate, FilterType
from dsd2dxd_tpu_torch.ops import fused, philox
from dsd2dxd_tpu_torch.ops.plan import tree_sum
from dsd2dxd_tpu_torch.ops.resample import StepConfig
from dsd2dxd_tpu_torch.tools import (
    PEAK_BYTES_PER_S,
    PEAK_F32_FLOPS,
    PEAK_INT32_OPS,
    PHILOX_INT_OPS,
    STAGED_TILES,
    round_robin,
    synth_chain,
)
from dsd2dxd_tpu_torch.utils.device import card_label, resolve_device
from dsd2dxd_tpu_torch.utils.errors import ConfigError

KERNEL_RUNGS = ("dma", "unpack", "cas0a", "cas0", "quant")
_CODE = {r: i for i, r in enumerate(KERNEL_RUNGS)}
QUANT_DITHERS = (DitherType.NONE, DitherType.TPDF)
# one per kernel instantiation; the ladder's rows (the JAX tool's, quant
# at both dithers) add fan and full
KERNELS = ("dma", "unpack", "cas0a", "cas0", "quant NONE", "quant TPDF")
LADDER = ("dma", "fan", "unpack", "cas0a", "cas0", "quant NONE",
          "quant TPDF", "full")
CHAINS = {"synth": lambda: synth_chain(0.0),
          "config1": lambda: get_chain(FilterType.EQUIRIPPLE, DsdRate.DSD64,
                                       352800)}
CHANNELS = 2
# the counts decim_body.cuh's switches unroll: stage-0 groups of 4 taps,
# and the ÷2 stages' taps (others take the generic loops)
STAGE0_CASES = (1, 4, 5, 6, 24)
FIR2_CASES = (2, 16, 18, 22, 48, 56, 58, 72, 78)
_NO_PEAK = ("dma", "unpack", "cas0a")
_CHUNK_BLOCKS = 512  # blocks the plain versions take at once

# Kernel launches per kernel (incremented right after each successful
# launch, and nowhere else); `full` counts as K1 in fused.MODE_LAUNCHES.
LAUNCHES = {k: 0 for k in KERNELS}
_launch_lock = threading.Lock()


def reset_launch_counts() -> None:
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def kernel_name(rung: str, dither: DitherType) -> str:
    """The kernel a rung launches: the rung, or quant at its dither."""
    return f"quant {dither.name}" if rung == "quant" else rung


def _check_rung(rung: str, cfg: StepConfig) -> None:
    if rung not in KERNEL_RUNGS:
        raise ValueError(f"no probe kernel for rung {rung!r}")
    if rung == "quant" and cfg.dither not in QUANT_DITHERS:
        raise ConfigError(f"the quant rung runs at NONE or TPDF, not "
                          f"{cfg.dither}")


def _windows(x_u8: torch.Tensor, halo: torch.Tensor,
             lay: fused.KernelLayout, n_blocks: int,
             n_bytes: int) -> torch.Tensor:
    """(C, n_blocks, n_bytes) u8: each block's window bytes from
    m0 * frame_bytes + byte_off on (halo ++ tile, the DSD idle byte past
    the end)."""
    c = x_u8.shape[0]
    pad = torch.full((c, n_bytes + lay.block_out * lay.frame_bytes),
                     fused.IDLE_BYTE, dtype=torch.uint8, device=x_u8.device)
    window = torch.cat([halo, x_u8, pad], dim=1)
    start = (torch.arange(n_blocks, device=x_u8.device)
             * (lay.block_out * lay.frame_bytes) + lay.byte_off)
    return window[:, start.unsqueeze(1) + torch.arange(n_bytes,
                                                       device=x_u8.device)]


def block_words(x_u8: torch.Tensor, halo: torch.Tensor,
                lay: fused.KernelLayout, blocks: torch.Tensor):
    """The shared-memory window words of `blocks` as K1 copies them, for
    a 16-byte aligned tile: (words (C, nb, win_words) int64 big-endian,
    base (C, nb) the word bit where stage 0's first output starts). A
    block inside the tile copies the 16-byte chunks that cover its bytes
    (base = 8 * its offset in the first chunk + bit_off); a block that
    reaches into the halo or past the tile takes its bytes from its first
    on (base = bit_off)."""
    c, t = x_u8.shape
    h = halo.shape[1]
    dev = x_u8.device
    n_win = 4 * lay.win_words
    wb0 = blocks * (lay.block_out * lay.frame_bytes) + lay.byte_off
    inside = (wb0 >= h) & (wb0 + lay.n_load_bytes <= h + t)
    flat_off = (torch.arange(c, device=dev).unsqueeze(1) * t
                + (wb0 - h).unsqueeze(0))  # (C, nb)
    s = torch.where(inside.unsqueeze(0), flat_off % 16,
                    torch.zeros_like(flat_off))
    k = torch.arange(n_win, device=dev)
    flat = torch.cat([x_u8.reshape(-1),
                      torch.full((n_win,), fused.IDLE_BYTE,
                                 dtype=torch.uint8, device=dev)])
    from_tile = flat[(flat_off - s).clamp(min=0).unsqueeze(-1) + k]
    pad = torch.full((c, n_win), fused.IDLE_BYTE, dtype=torch.uint8,
                     device=dev)
    window = torch.cat([halo, x_u8, pad], dim=1)
    from_window = window[:, wb0.unsqueeze(-1) + k]
    raw = torch.where(inside.view(1, -1, 1), from_tile,
                      from_window).to(torch.int64)
    words = ((raw[..., 0::4] << 24) | (raw[..., 1::4] << 16)
             | (raw[..., 2::4] << 8) | raw[..., 3::4])
    return words, 8 * s + lay.bit_off


def _chunk32(words: torch.Tensor, pos: torch.Tensor,
             aligned: bool) -> torch.Tensor:
    """The 32 window bits from bit pos on (aligned: the word that holds
    bit pos), gathered per block along the last axis."""
    w = pos >> 5
    hi = torch.gather(words, -1, w)
    if aligned:
        return hi
    lo = torch.gather(words, -1, w + 1)
    sh = pos & 31
    return ((hi << sh) | (lo >> (32 - sh))) & 0xFFFFFFFF


def block_stage0(words: torch.Tensor, base: torch.Tensor,
                 lay: fused.KernelLayout, tables: torch.Tensor,
                 aligned: bool = False) -> torch.Tensor:
    """K1's stage 0 for each block: (C, nb, n_out[0]) f32, output j the
    pairwise sum over groups g of tables[g][nibble], the nibble at window
    bit base + decim[0] j + 4 (q - 1 - g). With `aligned` (cas0a) each read
    of 32 bits takes the aligned word that holds its first bit, as the
    kernel's path for the chain reads it: four outputs from two chunks
    at ÷2 with an unrolled group count, one chunk per 8 groups with
    another unrolled count, one chunk per group otherwise."""
    q, m0 = lay.n_groups, lay.decim[0]
    c, nb = base.shape
    j = torch.arange(lay.n_out[0], device=base.device)
    shape = (c, nb, lay.n_out[0])
    if aligned and q in STAGE0_CASES and q <= 6 and m0 == 2:
        # stage0_quad: outputs 4t + i from chunks at pos and pos + 2
        pos = base.unsqueeze(-1) + 8 * (j // 4) + 2 * (j % 2)
        shift = (j // 2) % 2  # outputs 4t + 2, 4t + 3: one nibble on
        chunk = _chunk32(words, pos.expand(shape), True)
        nib = [(chunk >> (28 - 4 * (q - 1 - g + shift))) & 15
               for g in range(q)]
    else:
        pos = base.unsqueeze(-1) + m0 * j
        nib = []
        for g in range(q):
            r = q - 1 - g
            if not aligned:
                p, sel = pos + 4 * r, 0
            elif q in STAGE0_CASES:
                p, sel = pos + 32 * (r >> 3), r & 7
            else:
                p, sel = pos + 4 * r, 0
            chunk = _chunk32(words, p.expand(shape), aligned)
            nib.append((chunk >> (28 - 4 * sel)) & 15)
    return tree_sum(tables[g][nib[g]] for g in range(q))


def block_stages(v: torch.Tensor, taps: Sequence[torch.Tensor],
                 lay: fused.KernelLayout,
                 aligned: bool = False) -> torch.Tensor:
    """K1's ÷2 stages on each block's stage-0 outputs v (C, nb, n_out[0]):
    stage s output j is the pairwise sum over taps k of h[k] * x[2j + d],
    d = N - 1 - k; with `aligned` (cas0a) the generic loop's reads (tap
    counts outside FIR2_CASES) take element 2 * ((j + d // 2) & ~3) +
    d % 2 instead. Returns the last stage's (C, nb, n_out[-1])."""
    for s in range(1, len(lay.n_taps)):
        n, o = lay.n_taps[s], lay.n_out[s]
        j = torch.arange(o, device=v.device)
        rounded = aligned and n not in FIR2_CASES
        hk = taps[s].tolist()
        idx = [(2 * ((j + (d >> 1)) & ~3) + (d & 1)) if rounded
               else 2 * j + d for d in (n - 1 - k for k in range(n))]
        v = tree_sum(v[..., idx[k]] * hk[k] for k in range(n))
    return v


def block_body(x_u8, halo, taps, lay: fused.KernelLayout, n_blocks: int,
               stages: bool = True, aligned: bool = False) -> torch.Tensor:
    """K1's body block by block, as the kernel runs it: stage 0 (and,
    with `stages`, the ÷2 stages) on each block's copied window; each
    block's first block_out outputs, (C, n_blocks * block_out) f32."""
    c = x_u8.shape[0]
    tables = fused.stage0_tables(taps[0]).to(x_u8.device)
    parts = []
    for b0 in range(0, n_blocks, _CHUNK_BLOCKS):
        blocks = torch.arange(b0, min(n_blocks, b0 + _CHUNK_BLOCKS),
                              device=x_u8.device)
        words, base = block_words(x_u8, halo, lay, blocks)
        v = block_stage0(words, base, lay, tables, aligned)
        if stages:
            v = block_stages(v, taps, lay, aligned)
        parts.append(v[..., :lay.block_out])
    return torch.cat(parts, dim=1).reshape(c, -1)


def probe_step_reference(x_u8: torch.Tensor, halo: torch.Tensor,
                         taps: Sequence[torch.Tensor],
                         chain: Sequence[Stage], cfg: StepConfig, rung: str,
                         block_out: Optional[int] = None, tile_key: int = 0,
                         n_valid: Optional[int] = None):
    """Plain version of a rung on the (C, T) tile bytes and (C, H) halo:
    (out, peak). out is (C, T_out) f32, int32 for quant (24-bit words at
    cfg's dither); peak the 0-d f32 max |y| over the first n_valid frames
    for cas0 and quant, None for the others."""
    _check_rung(rung, cfg)
    lay = fused.kernel_layout(chain, halo.shape[1],
                              block_out or fused.block_out_for(chain))
    c, t = x_u8.shape
    t_out = t // lay.frame_bytes
    n_blocks = -(-t_out // lay.block_out)
    if rung == "dma":
        w = _windows(x_u8, halo, lay, n_blocks, lay.block_out)
        return w.to(torch.float32).reshape(c, -1)[:, :t_out], None
    if rung in ("unpack", "cas0a"):
        y = block_body(x_u8, halo, taps, lay, n_blocks,
                       stages=rung == "cas0a", aligned=rung == "cas0a")
        return y[:, :t_out], None
    y = fused.fused_decim_cascade(x_u8, halo, taps, chain, 1.0)
    peak = fused.masked_peak(y, n_valid)
    if rung == "quant":
        q = fused.epilogue_words(y, tile_key,
                                 dataclasses.replace(cfg, bit_depth=24))
        return q, peak
    return y, peak


def probe_step_cuda(x_u8: torch.Tensor, halo: torch.Tensor,
                    coefs: torch.Tensor, chain: Sequence[Stage],
                    cfg: StepConfig, rung: str,
                    block_out: Optional[int] = None, tile_key: int = 0,
                    n_valid: Optional[int] = None):
    """Launch a rung's kernel on the current stream of x's device, with
    the chain's ``fused.kernel_coefs`` there; same contract as
    ``probe_step_reference``. Raises if the launch fails."""
    _check_rung(rung, cfg)
    if x_u8.data_ptr() % 16:
        raise ValueError("the rungs want a 16-byte aligned tile (cas0a's "
                         "aligned words follow from the tile's address)")
    c, t = x_u8.shape
    t_out = t * 8 // fused.decimation(chain)
    n = t_out if n_valid is None else max(0, min(int(n_valid), t_out))
    out = torch.empty((c, t_out), device=x_u8.device,
                      dtype=torch.int32 if rung == "quant" else torch.float32)
    peak = torch.zeros(1, dtype=torch.float32, device=x_u8.device)
    p = fused._kernel_params(chain, cfg, halo.shape[1], tile_key, False, n,
                             block_out=block_out)
    p.gain, p.apply_gain = 1.0, 0
    fused.check_coefs(coefs, p, x_u8.device)
    lib = kernels.load()
    with kernels.launch_device(x_u8.device) as (stream, dev):
        rc = lib.dsd2dxd_probe_step(halo.data_ptr(), x_u8.data_ptr(),
                                    coefs.data_ptr(), out.data_ptr(),
                                    peak.data_ptr(), _CODE[rung],
                                    ctypes.byref(p), stream, dev)
    if rc != 0:
        raise RuntimeError(f"probe step ({rung}) launch failed: CUDA error "
                           f"{rc}")
    with _launch_lock:
        LAUNCHES[kernel_name(rung, cfg.dither)] += 1
    return out, (None if rung in _NO_PEAK else peak[0])


def make_probe_step(chain: Sequence[Stage], cfg: StepConfig, rung: str,
                    device, block_out: Optional[int] = None):
    """step(x_u8, halo, tile_key, n_valid=None) for a rung: (out, peak),
    or for full the production step's (wire bytes, peak, new halo). A
    CUDA tensor launches the kernel (or raises); a CPU tensor runs the
    plain version."""
    chain = tuple(chain)
    fused.check_step_config(chain, cfg)
    if rung == "full":
        return fused.make_fused_step(chain, cfg, device, block_out=block_out)
    _check_rung(rung, cfg)
    device = torch.device(device)
    taps = [torch.tensor(np.asarray(s.taps, dtype=np.float32), device=device)
            for s in chain]
    coefs = fused.kernel_coefs(chain, device)

    def step(x_u8, halo, tile_key, n_valid=None):
        if x_u8.is_cuda:
            return probe_step_cuda(x_u8, halo, coefs, chain, cfg, rung,
                                   block_out, tile_key, n_valid)
        if x_u8.device.type == "cpu":
            return probe_step_reference(x_u8, halo, taps, chain, cfg, rung,
                                        block_out, tile_key, n_valid)
        raise ValueError(f"no probe step on {x_u8.device}")

    return step


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


def rung_work(row: str, chain: Sequence[Stage], tile_bytes: int,
              channels: int) -> tuple[int, int, int]:
    """(bytes, f32 operations, integer operations) of a ladder row on one
    tile: the tile and halo in once and the row's output out once (f32 or
    int32, full's 24-bit wire bytes); the cascade's products and sums
    (unpack: stage 0's), plus 4 per sample for the epilogue; at TPDF one
    Philox call per sample."""
    frames = channels * tile_bytes * 8 // fused.decimation(chain)
    nbytes = (channels * (tile_bytes + fused.chain_halo_bytes(chain))
              + frames * (bytes_per_sample(24) if row == "full" else 4))
    flops = {"dma": 0, "fan": 0,
             "unpack": cascade_flops(chain, 1) * frames}.get(
        row, cascade_flops(chain) * frames)
    if row.startswith("quant") or row == "full":
        flops += 4 * frames
    int_ops = PHILOX_INT_OPS * frames if row in ("quant TPDF", "full") else 0
    return nbytes, flops, int_ops


def floor_ms(work: tuple[int, int, int]) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time of `work` on the
    card, the f32 operations at half the FMA rate (no FMA)."""
    nbytes, flops, int_ops = work
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    to = max(2 * flops / PEAK_F32_FLOPS, int_ops / PEAK_INT32_OPS) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def probe_config(tile_mib: float, block_out: Optional[int] = None,
                 chain_name: str = "synth"):
    """(chain, cfg, block_out) of a ladder: the named chain at 24-bit
    TPDF, level 0, two channels, K1's block_out (or `block_out`), a tile
    of whole blocks near tile_mib."""
    chain = CHAINS[chain_name]()
    bo = block_out or fused.block_out_for(chain)
    unit = bo * fused.decimation(chain) // 8
    tile = max(1, int(tile_mib * 1024 * 1024) // unit) * unit
    cfg = StepConfig(channels=CHANNELS, tile_bytes=tile, bit_depth=24,
                     dither=DitherType.TPDF, level_db=0.0)
    return chain, cfg, bo


def _row_step(row, chain, cfg, dev, bo):
    if row == "quant NONE":
        return make_probe_step(chain, dataclasses.replace(
            cfg, dither=DitherType.NONE), "quant", dev, bo)
    return make_probe_step(chain, cfg, row.split()[0], dev, bo)


def main(argv=None) -> dict:
    """Run the ladder; returns {"chain", "tile", "block_out", "ms" {row:
    [per-tile ms per rep]}, "med_ms" {row: ms}, "floor" {row: (ms, by)}}
    over the rows of LADDER but fan."""
    ap = argparse.ArgumentParser(prog="floorstrip", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--chain", choices=sorted(CHAINS), default="synth")
    ap.add_argument("--block-out", type=int, default=None,
                    help="output frames per CUDA block (default: K1's)")
    ap.add_argument("--tile-mib", type=float, default=16)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cuda device (default: the first card); 'cpu' "
                         "runs the plain versions at a tiny size, untimed")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)  # None: the card, or raise
    rows = [r for r in LADDER if r != "fan"]
    rng = np.random.default_rng(0)
    if dev.type == "cpu":
        chain, cfg, bo = probe_config(0, args.block_out, args.chain)
        cfg = dataclasses.replace(cfg, tile_bytes=cfg.tile_bytes * 2)
        x = torch.from_numpy(rng.integers(0, 256, (CHANNELS, cfg.tile_bytes),
                                          dtype=np.uint8))
        halo = fused.init_fused_halo(chain, CHANNELS)
        shapes = {}
        for r in rows:
            out = _row_step(r, chain, cfg, dev, bo)(x, halo, 1)[0]
            shapes[r] = tuple(out.shape)
            print(f"  {r:10s} plain version on the CPU: out "
                  f"{tuple(out.shape)} {out.dtype} sum "
                  f"{float(out.double().sum()):.6g} (no times)")
        return {"cpu": shapes}
    chain, cfg, bo = probe_config(args.tile_mib, args.block_out, args.chain)
    tile = cfg.tile_bytes
    xs = [torch.from_numpy(rng.integers(0, 256, (CHANNELS, tile),
                                        dtype=np.uint8)).to(dev)
          for _ in range(STAGED_TILES)]
    halo = fused.init_fused_halo(chain, CHANNELS, dev)
    keys = [philox.tile_key(13, i) for i in range(STAGED_TILES)]
    steps = {r: _row_step(r, chain, cfg, dev, bo) for r in rows}

    def run(r):
        return lambda: [steps[r](x, halo, k) for x, k in zip(xs, keys)]

    times = round_robin({r: run(r) for r in rows}, args.reps)
    med = {r: statistics.median(times[r]) / STAGED_TILES for r in rows}
    floor = {r: floor_ms(rung_work(r, chain, tile, CHANNELS)) for r in rows}
    full_max = max(times["full"]) / STAGED_TILES
    print(f"{args.chain} (÷{fused.decimation(chain)}, taps "
          f"{[s.n_taps for s in chain]}), block_out={bo}, tile={tile} B/ch x "
          f"{CHANNELS}, {STAGED_TILES} staged tiles, reps={args.reps}, ms "
          f"per tile (full's reps {min(times['full']) / STAGED_TILES:.4f}-"
          f"{full_max:.4f}) [{card_label().splitlines()[0]}]")
    prev = 0.0
    for r in LADDER:
        if r == "fan":
            print("  fan         no counterpart (K1's blocks are independent "
                  "windows: no sublane fan-in)")
            continue
        f_ms, by = floor[r]
        over = ("  OVER full's slowest rep"
                if r != "full" and med[r] > full_max else "")
        print(f"  {r:10s} {med[r]:8.4f} ms  ({med[r] - prev:+8.4f})  floor "
              f"{f_ms:.4f} ms by {by}, {f_ms / med[r] * 100:5.1f} %{over}")
        prev = med[r]
    print("increments: dma = the coefficients' and the packed window's "
          "copy; unpack-dma = stage 0 through the tables; cas0a-unpack = "
          "the ÷2 stages (stage 0 reading aligned words); cas0-cas0a = "
          "stage 0's funnel shifts, and the peak; quant NONE-cas0 = rint, "
          "clip, int32 store; quant TPDF-quant NONE = Philox; full-quant "
          "TPDF = the wire bytes against an int32 store.")
    return {"chain": args.chain, "tile": tile, "block_out": bo, "ms": times,
            "med_ms": med, "floor": floor}


if __name__ == "__main__":
    main()
    sys.exit(0)
