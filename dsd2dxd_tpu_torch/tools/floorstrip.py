"""P2: a ladder of the fused kernel (K1) cut short, on the card.

Counterpart of the JAX package's ``tools/floorstrip.py`` (its Pallas probe
``_probe_step`` and its main), on ``synth_chain(0.0)``: six ÷2 stages of
2 taps, the DSD512 -> 352.8k structure, at 24-bit TPDF. Each rung is one
body, K1's as it was before its redesign for Hopper (byte loads, the
window unpacked to ±1 f32 in shared memory, one FIR routine for every
stage; ``probe_params``, ``PROBE_BLOCK_BITS``), stopped at a later point
(``csrc/probes.cu``, ``probe_step_kernel``), so the increment from one
rung to the next is one part of its time; ``full`` is the redesigned K1,
so quant beside full is the old body beside the new one in one run:

  dma     load the block's window (K1's byte loads) to shared memory; store
          the block's first bytes as f32, the cheapest dependent store
  fan     no counterpart: the TPU ladder's sublane fan-in of sub-blocks.
          K1's blocks are independent windows with no fan-in (word lanes
          were dropped when the 44.1k family was ported); the printout
          keeps the row
  unpack  + K1's unpack of the bits to ±1 f32 in shared memory, consumed
          by an aligned sum (frame m0 + j of a block: the sum of its
          samples j, j + block_out, ..., R of them; a warp reads 32
          consecutive floats, so the consume adds no bank conflict)
  cas0a   + the whole cascade with every output j reading its input from
          j on instead of M j: a warp reads 32 consecutive floats, one per
          shared-memory bank, where the real stride-2 reads are 2-way bank
          conflicts; numerically wrong on purpose, so cas0 - cas0a is the
          cost of those conflicts
  cas0    + the real cascade and the peak over the first n_valid frames;
          planar f32 out at gain 1 (K1e's output)
  quant   + K1's epilogue at 24 bit (dither, rint, clip), int32 out
  full    the production step, ``ops/fused.make_fused_step`` (wire bytes),
          at the ladder's block_out

``probe_step_reference`` is the plain version of every rung but full
(cas0 and quant reuse ``fused_decim_cascade`` and ``epilogue_words``;
cas0a runs each block's window through ``block_cascade`` at stride 1).

    python -m dsd2dxd_tpu_torch.tools.floorstrip [--block-out N]
        [--tile-mib 16] [--reps 8]
    python -m dsd2dxd_tpu_torch.tools.floorstrip --device cpu

It prints µs per 16 KiB of per-channel input, the increment over the rung
before and the multiple of DSD512 real time, as the TPU tool does, over
``STAGED_TILES`` tiles staged on the card. A JAX
state hands over through ``ops/plan.state_from_jax``; the taps come from
``synth_chain`` in each package.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import sys
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from dsd2dxd_tpu_torch import kernels
from dsd2dxd_tpu_torch.filters.design import Stage
from dsd2dxd_tpu_torch.formats.dsd_types import DitherType
from dsd2dxd_tpu_torch.ops import fused, philox
from dsd2dxd_tpu_torch.ops.plan import tree_sum
from dsd2dxd_tpu_torch.ops.resample import StepConfig, unpack_bits
from dsd2dxd_tpu_torch.tools import (
    DSD512_HZ,
    STAGED_TILES,
    round_robin,
    synth_chain,
)
from dsd2dxd_tpu_torch.utils.device import card_label, resolve_device

RUNGS = ("dma", "fan", "unpack", "cas0a", "cas0", "quant", "full")
KERNEL_RUNGS = ("dma", "unpack", "cas0a", "cas0", "quant")
_CODE = {r: i for i, r in enumerate(KERNEL_RUNGS)}
CHANNELS = 2

# Kernel launches per rung (incremented right after each successful
# launch, and nowhere else); `full` counts as K1 in fused.MODE_LAUNCHES.
LAUNCHES = {r: 0 for r in KERNEL_RUNGS}
_launch_lock = threading.Lock()


def reset_launch_counts() -> None:
    with _launch_lock:
        for r in LAUNCHES:
            LAUNCHES[r] = 0


PROBE_BLOCK_BITS = 1 << 14  # block_out * R of the rungs beyond ÷32


def probe_block_out(chain: Sequence[Stage]) -> int:
    """The rungs' output frames per block: 512 down to ÷32, then
    PROBE_BLOCK_BITS // R (256 at ÷64), so the unpacked window fits in
    shared memory."""
    return min(512, PROBE_BLOCK_BITS // fused.decimation(chain))


def _smem(lay: fused.BlockLayout) -> tuple[int, int, int]:
    """(buf_a, buf_b, smem_bytes): taps, then buffer A (stage 0's whole
    bytes unpacked and the inputs of stages 2, 4, ...), then buffer B
    (stages 1, 3, ...), in f32 slots of the rung's dynamic shared
    memory."""
    n_taps_total = sum(lay.n_taps)
    in_len = lay.in_len
    a_len = max([lay.n_load_bytes * 8] + list(in_len[2::2]))
    b_len = max([0] + list(in_len[1::2]))
    return (n_taps_total, n_taps_total + a_len,
            4 * (n_taps_total + a_len + b_len))


def probe_params(chain, cfg: StepConfig, halo_bytes: int, tile_key: int,
                 n_valid: int, block_out: int) -> kernels.ProbeParams:
    """The rungs' ProbeParams: ``fused.block_layout`` at `block_out`,
    every rung at gain 1, K1's epilogue fields."""
    lay = fused.block_layout(chain, halo_bytes, block_out)
    p = kernels.ProbeParams()
    p.n_stages = len(chain)
    p.channels = cfg.channels
    p.tile_bytes = cfg.tile_bytes
    p.tile_frames = cfg.tile_bytes // lay.frame_bytes
    p.frame_bytes = lay.frame_bytes
    p.n_valid = n_valid
    p.halo_bytes = halo_bytes
    p.block_out = lay.block_out
    p.byte_off = lay.byte_off
    p.bit_off = lay.bit_off
    p.n_load_bytes = lay.n_load_bytes
    p.n_taps_total = sum(lay.n_taps)
    p.buf_a, p.buf_b, p.smem_bytes = _smem(lay)
    off = 0
    for s in range(len(chain)):
        p.n_taps[s] = lay.n_taps[s]
        p.decim[s] = lay.decim[s]
        p.tap_off[s] = off
        p.out_len[s] = lay.out_len[s]
        off += lay.n_taps[s]
    p.gain = 1.0
    p.apply_gain = 0
    p.bit_depth = cfg.bit_depth
    p.dither = fused._DITHER_CODE[cfg.dither]
    p.key0 = tile_key & 0xFFFFFFFF
    p.key1 = (tile_key >> 32) & 0xFFFFFFFF
    return p


def _windows(x_u8: torch.Tensor, halo: torch.Tensor,
             lay: fused.BlockLayout, n_blocks: int) -> torch.Tensor:
    """(C, n_blocks, n_load_bytes) u8: the bytes each kernel block loads
    (halo ++ tile, the DSD idle byte past the end)."""
    c = x_u8.shape[0]
    pad = torch.full((c, lay.n_load_bytes + lay.block_out * lay.frame_bytes),
                     fused.IDLE_BYTE, dtype=torch.uint8, device=x_u8.device)
    window = torch.cat([halo, x_u8, pad], dim=1)
    start = (torch.arange(n_blocks, device=x_u8.device)
             * (lay.block_out * lay.frame_bytes) + lay.byte_off)
    idx = start.unsqueeze(1) + torch.arange(lay.n_load_bytes,
                                            device=x_u8.device)
    return window[:, idx]


def block_cascade(x_u8, halo, taps, lay: fused.BlockLayout, n_blocks: int,
                  stride1: bool = True) -> torch.Tensor:
    """The cascade block by block, each from its own window, as the
    kernel runs it: cas0a's, where output j of every stage reads its input
    from j on (stride1); with the stages' own strides it is the plain
    cascade. Returns (C, n_blocks * block_out) f32."""
    c = x_u8.shape[0]
    w = _windows(x_u8, halo, lay, n_blocks)
    v = unpack_bits(w.reshape(c, -1)).reshape(c, n_blocks, -1)[
        ..., lay.bit_off:]
    for tp, n, m, o in zip(taps, lay.n_taps, lay.decim, lay.out_len):
        hk = tp.tolist()
        base = (1 if stride1 else m) * torch.arange(o, device=x_u8.device)
        v = tree_sum(v[..., base + (n - 1 - k)] * hk[k] for k in range(n))
    return v.reshape(c, -1)


def probe_step_reference(x_u8: torch.Tensor, halo: torch.Tensor,
                         taps: Sequence[torch.Tensor],
                         chain: Sequence[Stage], cfg: StepConfig, rung: str,
                         block_out: Optional[int] = None, tile_key: int = 0,
                         n_valid: Optional[int] = None):
    """Plain version of a rung on the (C, T) tile bytes and (C, H) halo:
    (out, peak). out is (C, T_out) f32, int32 for quant; peak the 0-d f32
    max |y| over the first n_valid frames for the cascade rungs, None for
    dma and unpack."""
    if rung not in KERNEL_RUNGS:
        raise ValueError(f"no probe kernel for rung {rung!r}")
    bo = block_out or probe_block_out(chain)
    lay = fused.block_layout(chain, halo.shape[1], bo)
    c, t = x_u8.shape
    t_out = t // lay.frame_bytes
    n_blocks = -(-t_out // bo)
    if rung == "dma":
        w = _windows(x_u8, halo, lay, n_blocks)[..., :bo]
        return w.to(torch.float32).reshape(c, -1)[:, :t_out], None
    if rung == "unpack":
        fb = lay.frame_bytes
        w = _windows(x_u8, halo, lay, n_blocks)[..., :bo * fb]
        v = unpack_bits(w.reshape(c, -1)).reshape(c, n_blocks, 8 * fb, bo)
        return v.sum(dim=2).reshape(c, -1)[:, :t_out], None
    if rung == "cas0a":
        y = block_cascade(x_u8, halo, taps, lay, n_blocks)[:, :t_out]
    else:
        y = fused.fused_decim_cascade(x_u8, halo, taps, chain, 1.0)
    peak = fused.masked_peak(y, n_valid)
    if rung == "quant":
        return fused.epilogue_words(y, tile_key, cfg), peak
    return y, peak


def probe_step_cuda(x_u8: torch.Tensor, halo: torch.Tensor,
                    taps_flat: torch.Tensor, chain: Sequence[Stage],
                    cfg: StepConfig, rung: str,
                    block_out: Optional[int] = None, tile_key: int = 0,
                    n_valid: Optional[int] = None):
    """Launch a rung's kernel on the current stream; same contract as
    ``probe_step_reference``. Raises if the launch fails."""
    if rung not in KERNEL_RUNGS:
        raise ValueError(f"no probe kernel for rung {rung!r}")
    c, t = x_u8.shape
    t_out = t * 8 // fused.decimation(chain)
    n = t_out if n_valid is None else max(0, min(int(n_valid), t_out))
    out = torch.empty((c, t_out), device=x_u8.device,
                      dtype=torch.int32 if rung == "quant" else torch.float32)
    peak = torch.zeros(1, dtype=torch.float32, device=x_u8.device)
    p = probe_params(chain, cfg, halo.shape[1], tile_key, n,
                     block_out or probe_block_out(chain))
    lib = kernels.load()
    stream = torch.cuda.current_stream(x_u8.device).cuda_stream
    rc = lib.dsd2dxd_probe_step(halo.data_ptr(), x_u8.data_ptr(),
                                taps_flat.data_ptr(), out.data_ptr(),
                                peak.data_ptr(), _CODE[rung], ctypes.byref(p),
                                stream)
    if rc != 0:
        raise RuntimeError(f"probe step ({rung}) launch failed: CUDA error "
                           f"{rc}")
    with _launch_lock:
        LAUNCHES[rung] += 1
    return out, (None if rung in ("dma", "unpack") else peak[0])


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
    if rung not in KERNEL_RUNGS:
        raise ValueError(f"no rung {rung!r} on the card")
    device = torch.device(device)
    taps = [torch.tensor(np.asarray(s.taps, dtype=np.float32), device=device)
            for s in chain]
    taps_flat = torch.cat(taps)

    def step(x_u8, halo, tile_key, n_valid=None):
        if x_u8.is_cuda:
            return probe_step_cuda(x_u8, halo, taps_flat, chain, cfg, rung,
                                   block_out, tile_key, n_valid)
        if x_u8.device.type == "cpu":
            return probe_step_reference(x_u8, halo, taps, chain, cfg, rung,
                                        block_out, tile_key, n_valid)
        raise ValueError(f"no probe step on {x_u8.device}")

    return step


def probe_config(tile_mib: float, block_out: Optional[int] = None):
    """(chain, cfg, block_out) of the ladder: synth_chain(0.0) at 24-bit
    TPDF, level 0, two channels, a tile of whole blocks near tile_mib."""
    chain = synth_chain(0.0)
    bo = block_out or probe_block_out(chain)
    unit = bo * fused.decimation(chain) // 8
    tile = max(1, int(tile_mib * 1024 * 1024) // unit) * unit
    cfg = StepConfig(channels=CHANNELS, tile_bytes=tile, bit_depth=24,
                     dither=DitherType.TPDF, level_db=0.0)
    return chain, cfg, bo


def main(argv=None) -> dict:
    """Run the ladder; returns {"tile", "block_out", "ms" {rung: [per-tile
    ms per rep]}, "med_ms" {rung: ms}}."""
    ap = argparse.ArgumentParser(prog="floorstrip", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--block-out", type=int, default=None,
                    help="output frames per CUDA block (default: K1's)")
    ap.add_argument("--tile-mib", type=float, default=16)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cuda device (default: the first card); 'cpu' "
                         "runs the plain versions at a tiny size, untimed")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)  # None: the card, or raise
    rungs = [r for r in RUNGS if r != "fan"]
    rng = np.random.default_rng(0)
    if dev.type == "cpu":
        chain, cfg, bo = probe_config(0, args.block_out)
        cfg = StepConfig(channels=CHANNELS, tile_bytes=cfg.tile_bytes * 2,
                         bit_depth=24, dither=DitherType.TPDF, level_db=0.0)
        x = torch.from_numpy(rng.integers(0, 256, (CHANNELS, cfg.tile_bytes),
                                          dtype=np.uint8))
        halo = fused.init_fused_halo(chain, CHANNELS)
        shapes = {}
        for r in rungs:
            out = make_probe_step(chain, cfg, r, dev, bo)(x, halo, 1)[0]
            shapes[r] = tuple(out.shape)
            print(f"  {r:7s} plain version on the CPU: out "
                  f"{tuple(out.shape)} {out.dtype} sum "
                  f"{float(out.double().sum()):.6g} (no times)")
        return {"cpu": shapes}
    chain, cfg, bo = probe_config(args.tile_mib, args.block_out)
    tile = cfg.tile_bytes
    xs = [torch.from_numpy(rng.integers(0, 256, (CHANNELS, tile),
                                        dtype=np.uint8)).to(dev)
          for _ in range(STAGED_TILES)]
    halo = fused.init_fused_halo(chain, CHANNELS, dev)
    keys = [philox.tile_key(13, i) for i in range(STAGED_TILES)]
    steps = {r: make_probe_step(chain, cfg, r, dev, bo) for r in rungs}

    def run(r):
        return lambda: [steps[r](x, halo, k) for x, k in zip(xs, keys)]

    times = round_robin({r: run(r) for r in rungs}, args.reps)
    med = {r: statistics.median(times[r]) / STAGED_TILES for r in rungs}
    n16 = tile / 16384
    print(f"synth_chain(0.0) (÷{fused.decimation(chain)}, taps "
          f"{[s.n_taps for s in chain]}), block_out={bo}, tile={tile} B/ch x "
          f"{CHANNELS}, {STAGED_TILES} staged tiles, reps={args.reps} "
          f"(us per 16 KiB of per-channel input) [{card_label().splitlines()[0]}]")
    prev = 0.0
    for r in RUNGS:
        if r == "fan":
            print("  fan      no counterpart (K1's blocks are independent "
                  "windows: no sublane fan-in)")
            continue
        us = med[r] * 1e3 / n16
        xrt = tile * 8 / DSD512_HZ / (med[r] * 1e-3)
        print(f"  {r:7s} {us:8.4f} us/16KiB  ({us - prev:+8.4f})  "
              f"[{xrt:8.0f}x DSD512RT]")
        prev = us
    print("increments (the rungs are K1's body before its redesign): "
          "unpack-dma = the unpack to ±1 f32 and an aligned sum; "
          "cas0a-unpack = the cascade with conflict-free stride-1 reads; "
          "cas0-cas0a = the real stride-2 reads' bank conflicts; "
          "quant-cas0 = dither + quantize (int32 store); full-quant = the "
          "redesigned K1 (packed window, stage 0 through tap tables, "
          "unrolled ÷2 stages, wire bytes) against the old body.")
    return {"tile": tile, "block_out": bo, "chain": chain, "cfg": cfg,
            "ms": times, "med_ms": med}


if __name__ == "__main__":
    main()
    sys.exit(0)
