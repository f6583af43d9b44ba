"""K1's block size on the card: a sweep of ``block_out``.

For each depth and each candidate ``block_out``, K1
(``ops/fused.make_fused_step`` at that ``block_out``) at 24-bit TPDF per
16 MiB/ch stereo tile, timed with CUDA events over ``STAGED_TILES`` staged
tiles (``round_robin``: every candidate warmed, then one run of each in
turn per repetition; medians), beside the block's shared memory, its
resident warps per SM and the share of its window that other blocks read
too (the filter context, read again by every block). A smaller block
raises the warps per SM and reads more context; ``fused.block_out_for``
takes the best per depth.

    python -m dsd2dxd_tpu_torch.tools.blocksweep [--depths 8,16,32,64,128]
        [--blocks 64,96,128,...] [--reps 5]

It times the card and has no CPU mode.
"""

from __future__ import annotations

import argparse
import statistics
import sys

import numpy as np
import torch

from dsd2dxd_tpu_torch.filters.design import get_chain
from dsd2dxd_tpu_torch.formats.dsd_types import DitherType, DsdRate, FilterType
from dsd2dxd_tpu_torch.ops import fused, philox
from dsd2dxd_tpu_torch.ops.resample import StepConfig
from dsd2dxd_tpu_torch.tools import STAGED_TILES, round_robin
from dsd2dxd_tpu_torch.utils.device import card_label, resolve_device
from dsd2dxd_tpu_torch.utils.errors import ConfigError

E = FilterType.EQUIRIPPLE
# the Equiripple chain of each depth the smoke times
CHAINS = {8: (E, DsdRate.DSD64, 352800), 16: (E, DsdRate.DSD64, 176400),
          32: (E, DsdRate.DSD64, 88200), 64: (E, DsdRate.DSD128, 88200),
          128: (E, DsdRate.DSD256, 88200)}
BLOCKS = (64, 96, 128, 160, 192, 224, 256, 320, 384, 512, 768, 1024, 1536,
          2048)
MAX_SMEM = 226 * 1024  # a block's 227 KB less the static shared memory


def main(argv=None) -> dict:
    """Run the sweep; returns {depth: {block_out: {"ms", "smem_bytes",
    "warps_per_sm", "context"}}}."""
    ap = argparse.ArgumentParser(prog="blocksweep", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--depths", default="8,16,32,64,128")
    ap.add_argument("--blocks", default=",".join(map(str, BLOCKS)))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="cuda device (default: the first card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)  # None: the card, or raise
    if dev.type != "cuda":
        raise ConfigError("blocksweep times K1 on the card; it has no CPU "
                          "mode")
    tile = 16 * 1024 * 1024
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.integers(0, 256, (2, tile), dtype=np.uint8)
                           ).to(dev) for _ in range(STAGED_TILES)]
    keys = [philox.tile_key(15, i) for i in range(STAGED_TILES)]
    cfg = StepConfig(channels=2, tile_bytes=tile, bit_depth=24,
                     dither=DitherType.TPDF, level_db=0.0)
    label = card_label().splitlines()[0]
    res: dict = {}
    for depth in (int(d) for d in args.depths.split(",")):
        chain = get_chain(*CHAINS[depth])
        halo = fused.init_fused_halo(chain, 2, dev)
        fb = depth // 8
        blocks = [b for b in (int(b) for b in args.blocks.split(","))
                  if fused.kernel_layout(chain, halo.shape[1], b).smem_bytes
                  <= MAX_SMEM]
        steps = {b: fused.make_fused_step(chain, cfg, dev, block_out=b)
                 for b in blocks}
        times = round_robin(
            {b: (lambda s=s: [s(x, halo, k) for x, k in zip(xs, keys)])
             for b, s in steps.items()}, args.reps)
        res[depth] = {}
        print(f"÷{depth} {'E'} {CHAINS[depth][1].name}->"
              f"{CHAINS[depth][2] / 1000:g}k, 24-bit TPDF, {tile} B/ch x 2, "
              f"{STAGED_TILES} staged tiles, reps={args.reps} [{label}]")
        for b in blocks:
            occ = fused.kernel_occupancy(chain, b)
            lay = fused.kernel_layout(chain, halo.shape[1], b)
            row = {"ms": statistics.median(times[b]) / STAGED_TILES,
                   "smem_bytes": occ["smem_bytes"],
                   "warps_per_sm": occ["warps_per_sm"],
                   "context": 1.0 - b * fb / lay.n_load_bytes}
            res[depth][b] = row
            print(f"  block_out {b:4d}: {row['ms']:.4f} ms/tile  "
                  f"{row['smem_bytes'] / 1024:6.1f} KB  "
                  f"{row['warps_per_sm']:2d} warps/SM  context "
                  f"{row['context'] * 100:4.1f} %")
        best = min(res[depth], key=lambda b: res[depth][b]["ms"])
        print(f"  best: block_out {best} ({res[depth][best]['ms']:.4f} ms; "
              f"block_out_for: {fused.block_out_for(chain)})")
    return res


if __name__ == "__main__":
    main()
    sys.exit(0)
