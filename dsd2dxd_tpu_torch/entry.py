"""Driver entry points of the port: the flagship step with example
arguments, and a dry run of the sharded route.

Counterpart of ``__graft_entry__.py`` at the repository root.

- ``entry(device=None)`` returns the flagship per-tile convert step
  (DSD64 stereo -> 24-bit 352.8 kHz, Equiripple bank, TPDF dither: the
  BASELINE config-1 path) with example arguments, ``(step, (x, halo,
  tile_key))``: ``ops/fused.make_fused_step`` (K1a on a card, its plain
  version on the CPU) and a 64 KiB/ch tile of ``default_rng(0)`` bytes on
  the device. ``step(*args)`` returns (wire bytes, peak, new halo).
- ``dryrun_multichip(n, device=None)`` runs the sharded route
  (``parallel/sharded.py``) over n device entries: n times `device` when
  one is named (the tests' "cpu"), else the cards in turn, cycled where
  there are fewer than n (cuda:0 n times on one card). For the ÷8 flagship chain and DSD64 -> 96k, at
  24-bit TPDF and at f32 NONE, on the smallest tile (``_smallest_tile``):
  random tiles through ``make_sharded_convert`` on a (streams x tiles) grid
  (shape, finite peak), and one tone stream over every entry through
  ``convert_stream_tiled_chunked`` against the streaming step tile by tile
  (``tools/shardcheck.py``): equal wire bytes and peaks.

Cut: the JAX dry run's fused-versus-phase body checks (ROADMAP "Cuts":
``_resolve_body``; the port has one body per device type), its virtual
CPU mesh and platform pins, and its dithered geometry-mismatch check: the
port's sharded route keys each tile as the streaming engine does, so its
bytes equal the streaming step's at every dither and are compared so.
"""

from __future__ import annotations

import numpy as np
import torch

from dsd2dxd_tpu_torch.filters.design import chain_ratio, get_chain
from dsd2dxd_tpu_torch.formats.dsd_types import DitherType, DsdRate, FilterType
from dsd2dxd_tpu_torch.ops import fused, rational
from dsd2dxd_tpu_torch.ops.philox import tile_key
from dsd2dxd_tpu_torch.ops.resample import StepConfig
from dsd2dxd_tpu_torch.utils.device import batch_devices, resolve_device

DRYRUN_EPILOGUES = ((24, DitherType.TPDF), (32, DitherType.NONE))
DRYRUN_RATES = (352800, 96000)  # the ÷8 flagship and a 48k chain


def _flagship():
    chain = get_chain(FilterType.EQUIRIPPLE, DsdRate.DSD64, 352800)
    cfg = StepConfig(channels=2, tile_bytes=65536, bit_depth=24,
                     dither=DitherType.TPDF, level_db=0.0)
    return chain, cfg


def entry(device=None):
    """(step, example_args) for the flagship convert step on `device`
    (None: the card)."""
    device = resolve_device(device)
    chain, cfg = _flagship()
    step = fused.make_fused_step(chain, cfg, device)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, size=(cfg.channels, cfg.tile_bytes),
                     dtype=np.uint8)
    halo = fused.init_fused_halo(chain, cfg.channels, device)
    return step, (torch.from_numpy(x).to(device), halo, tile_key(0, 0))


def _entries(n: int, device=None) -> list[torch.device]:
    if device is not None:
        return [resolve_device(device)] * n
    cards = batch_devices()  # raises without a card
    return [cards[i % len(cards)] for i in range(n)]


def _smallest_tile(chain, device: torch.device) -> int:
    """The smallest tile of `chain` the step takes on `device`: the
    engine's on a card (whole blocks of the kernel: 294 KiB/ch at DSD64 ->
    96k); on the CPU, whose plain versions have no blocks, one band unit
    of a 48k chain's ×160/147 stage (588 bytes/ch there)."""
    from dsd2dxd_tpu_torch.pipeline import engine

    if device.type == "cpu" and rational.rational_head_len(chain) is not None:
        return rational.rational_plan(chain).unit_bits // 8
    return engine._tile_bytes_for(chain, 1)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """The sharded route over `n_devices` entries against the streaming
    step; raises AssertionError on a mismatch."""
    from dsd2dxd_tpu_torch.parallel import sharded
    from dsd2dxd_tpu_torch.tools import shardcheck

    devices = _entries(n_devices, device)
    n_streams = 2 if n_devices % 2 == 0 else 1
    n_tiles = n_devices // n_streams
    rng = np.random.default_rng(0)
    report = []
    for out_hz in DRYRUN_RATES:
        key = (FilterType.EQUIRIPPLE, DsdRate.DSD64, out_hz)
        chain = get_chain(*key)
        tile = _smallest_tile(chain, devices[0])
        n_keep = int(tile * 8 * chain_ratio(chain))
        # one stream over every entry, its last tile partial
        planes = shardcheck.tone(DsdRate.DSD64.hz,
                                 (n_devices - 1) * tile + tile // 3)
        for bits, dither in DRYRUN_EPILOGUES:
            cfg = StepConfig(channels=2, tile_bytes=tile, bit_depth=bits,
                             dither=dither, level_db=0.0)
            name = f"DSD64 -> {out_hz} {bits}-bit {dither.name}"
            # ---- the (streams x tiles) grid of random tiles ----
            fn, halo = sharded.make_sharded_convert(chain, cfg, devices,
                                                    n_streams, n_tiles)
            x = rng.integers(0, 256, (n_streams, n_tiles, 2, halo + tile),
                             dtype=np.uint8)
            keys = np.arange(n_devices).reshape(n_streams, n_tiles)
            valids = np.full((n_streams, n_tiles), n_keep)
            out, peak = fn(x, keys, valids)
            want = (n_streams, n_tiles, n_keep, 2)
            _check(tuple(out.shape) == want,
                   f"{name}: grid output {tuple(out.shape)}, want {want}")
            _check(bool(np.isfinite(peak)) and peak > 0,
                   f"{name}: grid peak {peak}")
            # ---- one stream over every entry vs the streaming step ----
            ws, ps = shardcheck.streaming_tiles(planes, key, cfg, devices[0])
            wt, pt = shardcheck.sharded_tiles(planes, chain, cfg, devices)
            _check(len(ws) == len(wt) == n_devices,
                   f"{name}: {len(wt)} sharded tiles, {len(ws)} streaming, "
                   f"want {n_devices}")
            _check(all(np.array_equal(a, b) for a, b in zip(ws, wt)),
                   f"{name}: sharded wire bytes differ from streaming")
            _check(ps == pt and all(np.isfinite(ps)),
                   f"{name}: peaks {pt} differ from streaming {ps}")
            report.append(f"{name}: grid {want}, {len(wt)} tiles equal")
    print(f"dryrun_multichip OK over {n_devices} entries "
          f"({', '.join(map(str, devices))}), grid {n_streams}x{n_tiles}: "
          + "; ".join(report))
