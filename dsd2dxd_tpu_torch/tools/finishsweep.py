"""K2 "from z" on the card: a sweep of its frames per run.

For each candidate run length (``ops/fused.finish_cuda`` at that
``run_frames``) the finish of one 16.08 MiB/ch stereo tile of DSD64 ->
192k (2 x 9 175 040 final samples) at 24-bit NONE, 24-bit TPDF, 16-bit
TPDF and f32 FPD, timed with CUDA events over ``STAGED_TILES`` staged
tiles (``round_robin``: every candidate warmed, then one run of each in
turn per repetition; medians). A shorter run leaves threads of the
256-thread block without an item (below 512 frames for stereo); a longer
one gives each thread several items between two barriers and stages more
shared memory (two runs of 32-bit samples must fit 48 KB: 2048 frames for
stereo). The sweep prints the candidate with the least time summed over
the four epilogues beside ``fused.FINISH_RUN_FRAMES``, the one in use.

    python -m dsd2dxd_tpu_torch.tools.finishsweep [--frames 64,128,...]
        [--reps 5]

It times the card and has no CPU mode.
"""

from __future__ import annotations

import argparse
import statistics
import sys

import torch

from dsd2dxd_tpu_torch.formats.dsd_types import DitherType
from dsd2dxd_tpu_torch.ops import fused, philox
from dsd2dxd_tpu_torch.ops.resample import StepConfig
from dsd2dxd_tpu_torch.tools import STAGED_TILES, round_robin
from dsd2dxd_tpu_torch.utils.device import card_label, resolve_device
from dsd2dxd_tpu_torch.utils.errors import ConfigError

FRAMES = (64, 128, 256, 512, 1024, 2048)
N_FRAMES = 160 * 57344  # the 16.08 MiB/ch tile of DSD64 -> 192k
EPILOGUES = ((24, DitherType.NONE), (24, DitherType.TPDF),
             (16, DitherType.TPDF), (32, DitherType.FPD))


def fastest(res: dict) -> int:
    """The run length of `res` ({run_frames: {epilogue: ms}}) with the
    least time summed over its epilogues (the longer one of a tie)."""
    return min(sorted(res, reverse=True), key=lambda f: sum(res[f].values()))


def main(argv=None) -> dict:
    """Run the sweep; returns {run_frames: {"24N" ...: ms per tile}}."""
    ap = argparse.ArgumentParser(prog="finishsweep", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", default=",".join(map(str, FRAMES)))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="cuda device (default: the first card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)  # None: the card, or raise
    if dev.type != "cuda":
        raise ConfigError("finishsweep times K2 on the card; it has no CPU "
                          "mode")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    zs = [torch.rand(2, N_FRAMES, device=dev, generator=gen) * 2.0 - 1.0
          for _ in range(STAGED_TILES)]
    keys = [philox.tile_key(16, i) for i in range(STAGED_TILES)]
    frames = [int(f) for f in args.frames.split(",")]
    print(f"K2 'from z', 2 x {N_FRAMES} samples, {STAGED_TILES} staged "
          f"tiles, reps={args.reps} [{card_label().splitlines()[0]}]")
    res: dict = {f: {} for f in frames}
    for bits, dither in EPILOGUES:
        cfg = StepConfig(channels=2, tile_bytes=8, bit_depth=bits,
                         dither=dither, level_db=0.0)
        tag = f"{bits}{dither.name[0]}"
        times = round_robin(
            {f: (lambda f=f: [fused.finish_cuda(z, 1.0, k, cfg, run_frames=f)
                              for z, k in zip(zs, keys)])
             for f in frames}, args.reps)
        for f in frames:
            res[f][tag] = statistics.median(times[f]) / STAGED_TILES
    for f in frames:
        print(f"  run_frames {f:5d}: " + "  ".join(
            f"{tag} {ms:.4f} ms" for tag, ms in res[f].items()))
    print(f"  fastest over the four: {fastest(res)}; in use "
          f"(fused.FINISH_RUN_FRAMES): {fused.FINISH_RUN_FRAMES}")
    return res


if __name__ == "__main__":
    main()
    sys.exit(0)
