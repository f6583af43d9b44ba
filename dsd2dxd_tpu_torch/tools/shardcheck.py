"""The sharded route against the streaming step, tile by tile.

Counterpart of ``tools/shardcheck.py`` at the repository root (a check of
the JAX package's sharded body on a one-device mesh). For each of its six
cells -- DSD64 -> 352.8k and 88.2k, DSD128 and DSD256 -> 352.8k, DSD64 ->
96k and DSD128 -> 192k -- on a list of devices (repeats allowed: a list
that repeats cuda:0 runs the whole sharded machinery on one card): a
stereo 1 kHz tone of ``--tiles`` engine tiles per list entry, the last
tile partial, with a sample count that ends inside its last byte, is
converted at 24-bit TPDF and at f32 FPD

- by the streaming step (``streaming_tiles``: the engine's step tile by
  tile on the first device, its state carried, its keys and valid-frame
  counts), and
- by ``parallel/sharded.convert_stream_tiled_chunked`` over the devices,

and each tile's wire bytes and peak must be equal. Then both routes are
timed once more at 24-bit TPDF (warm: the step, the bodies and the pinned
rings already allocated) with CUDA events, each from the host's planes to
the host's wire bytes.

    python -m dsd2dxd_tpu_torch.tools.shardcheck [--devices cuda:0,cuda:0]
        [--cells DSD64:352800,...] [--tiles 2] [--tile-kib 4096]

The default devices are every card, or cuda:0 twice on a one-card
machine; without a card it raises. ``--devices cpu,cpu`` runs the plain
versions (use a small ``--tile-kib``) and prints no times. Exits 1 if a
tile differs.
"""

from __future__ import annotations

import argparse
import sys
from functools import lru_cache

import numpy as np
import torch

from dsd2dxd_tpu_torch.containers.pack import bytes_per_sample
from dsd2dxd_tpu_torch.filters.design import chain_ratio, get_chain
from dsd2dxd_tpu_torch.formats.dsd_types import DitherType, DsdRate, FilterType
from dsd2dxd_tpu_torch.ops.dsm import synth_tone_dsd
from dsd2dxd_tpu_torch.ops.philox import tile_key
from dsd2dxd_tpu_torch.ops.resample import StepConfig
from dsd2dxd_tpu_torch.parallel import sharded
from dsd2dxd_tpu_torch.pipeline import engine
from dsd2dxd_tpu_torch.utils.device import batch_devices, card_label

CELLS = [("DSD64", 352800), ("DSD64", 88200), ("DSD128", 352800),
         ("DSD256", 352800), ("DSD64", 96000), ("DSD128", 192000)]
EPILOGUES = [(24, DitherType.TPDF), (32, DitherType.FPD)]
SEED = sharded.DEFAULT_SEED


@lru_cache(maxsize=None)
def _period(rate_hz: int) -> np.ndarray:
    """0.1 s (100 periods) of the 1 kHz tone, stereo, modulated once."""
    return synth_tone_dsd(1000.0, 0.1, rate_hz, amplitude=0.5, channels=2)


def tone(rate_hz: int, n_bytes: int) -> np.ndarray:
    """(2, n_bytes) of the tone: one modulated 0.1 s, tiled."""
    one = _period(rate_hz)
    return np.tile(one, (1, -(-n_bytes // one.shape[1])))[:, :n_bytes]


def streaming_tiles(planes: np.ndarray, chain_key, cfg: StepConfig,
                    device, seed: int = SEED, max_bits=None):
    """The streaming engine's step for `chain_key` (filter, DSD rate,
    output Hz) over (C, B) planes, tile by tile with its state carried:
    (each tile's valid wire bytes, each tile's peak)."""
    c, total = planes.shape
    tile, ratio = cfg.tile_bytes, chain_ratio(get_chain(*chain_key))
    step, make_state = engine._cached_step(tuple(chain_key), cfg,
                                           torch.device(device))
    state = make_state()
    frame_bytes = c * bytes_per_sample(cfg.bit_depth)
    wires, peaks = [], []
    valid_bits = emitted = 0
    for t in range(-(-total // tile)):
        x = planes[:, t * tile:(t + 1) * tile]
        valid_bits += x.shape[1] * 8
        if max_bits is not None:
            valid_bits = min(valid_bits, max_bits)
        if x.shape[1] < tile:
            x = np.concatenate([x, np.full((c, tile - x.shape[1]), 0x69,
                                           np.uint8)], axis=1)
        n_total = int(valid_bits * ratio)
        n_valid, emitted = n_total - emitted, n_total
        wire, peak, state = step(
            torch.from_numpy(np.ascontiguousarray(x)).to(device), state,
            tile_key(seed, t), n_valid)
        wires.append(wire[:n_valid * frame_bytes].cpu().numpy())
        peaks.append(float(peak))
    return wires, peaks


def sharded_tiles(planes: np.ndarray, chain, cfg: StepConfig, devices,
                  seed: int = SEED, max_bits=None):
    """``convert_stream_tiled_chunked`` over (C, B) planes: (each tile's
    written bytes, each tile's peak)."""
    pos = [0]

    def read(n):
        if pos[0] >= planes.shape[1]:
            return None
        b = planes[:, pos[0]:pos[0] + n]
        pos[0] += b.shape[1]
        return b

    wires: list = []
    st: dict = {}
    sharded.convert_stream_tiled_chunked(
        read, chain, cfg, devices, lambda w: wires.append(w.copy()), seed,
        max_bits=max_bits, stats=st)
    return wires, st["tile_peaks"]


def _timed(fn, device) -> tuple[float, object]:
    """(ms between two CUDA events around fn(), its result); None ms on
    the CPU."""
    if device.type != "cuda":
        return None, fn()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    ev0.record()
    res = fn()
    ev1.record()
    torch.cuda.synchronize()
    return ev0.elapsed_time(ev1), res


def check_cell(rate: DsdRate, out_hz: int, devices, tiles: int,
               tile_kib: int) -> dict:
    """One cell: both epilogues compared tile by tile, then both routes
    timed at 24-bit TPDF, warm."""
    chain_key = (FilterType.EQUIRIPPLE, rate, out_hz)
    chain = get_chain(*chain_key)
    tile = engine._tile_bytes_for(chain, tile_kib * 1024 * int(rate))
    n_bytes = (len(devices) * tiles - 1) * tile + tile // 3
    planes = tone(rate.hz, n_bytes)
    max_bits = n_bytes * 8 - 3  # the last byte's last 3 bits are padding
    res = {"tile": tile, "tiles": -(-n_bytes // tile),
           "audio_s": max_bits / rate.hz, "equal": True}
    for bits, dither in EPILOGUES:
        cfg = StepConfig(channels=2, tile_bytes=tile, bit_depth=bits,
                         dither=dither, level_db=-1.0)

        def stream(cfg=cfg):
            return streaming_tiles(planes, chain_key, cfg, devices[0],
                                   max_bits=max_bits)

        def shard(cfg=cfg):
            return sharded_tiles(planes, chain, cfg, devices,
                                 max_bits=max_bits)

        (ws, ps), (wt, pt) = stream(), shard()
        same = (len(ws) == len(wt) and ps == pt
                and all(np.array_equal(a, b) for a, b in zip(ws, wt)))
        res["equal"] &= same
        res[f"{bits}-bit {dither.name}"] = same
        if bits == 24:
            res["streaming_ms"] = _timed(stream, devices[0])[0]
            res["sharded_ms"] = _timed(shard, devices[0])[0]
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="shardcheck", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--devices", default=None,
                    help="comma-separated devices, repeats allowed "
                         "(default: every card, or cuda:0 twice)")
    ap.add_argument("--cells", default=None,
                    help="RATE:OUT_HZ,... (default: the six cells)")
    ap.add_argument("--tiles", type=int, default=2,
                    help="engine tiles per device entry")
    ap.add_argument("--tile-kib", type=int, default=4096,
                    help="tile target per channel at DSD64, scaled by the "
                         "input rate as the engine scales it")
    args = ap.parse_args(argv)
    if args.devices:
        devices = [torch.device(d) for d in args.devices.split(",")]
    else:
        devices = batch_devices()  # raises without a card
        if len(devices) < 2:
            devices = devices * 2
    cells = ([(DsdRate[r], int(o)) for r, o in
              (c.split(":") for c in args.cells.split(","))]
             if args.cells else [(DsdRate[r], o) for r, o in CELLS])
    label = (card_label().splitlines()[0] if devices[0].type == "cuda"
             else "cpu")
    ok = True
    for rate, out_hz in cells:
        r = check_cell(rate, out_hz, devices, args.tiles, args.tile_kib)
        ok &= r["equal"]
        times = ""
        if r["streaming_ms"] is not None:
            times = (f"; 24-bit TPDF streaming {r['streaming_ms']:.1f} ms "
                     f"({r['audio_s'] / r['streaming_ms'] * 1e3:.1f} "
                     f"audio-s/s), sharded {r['sharded_ms']:.1f} ms "
                     f"({r['audio_s'] / r['sharded_ms'] * 1e3:.1f} "
                     f"audio-s/s)")
        verdict = ", ".join(f"{e} {'equal' if r[e] else 'DIFFERS'}"
                            for e in (f"{b}-bit {d.name}"
                                      for b, d in EPILOGUES))
        print(f"[shardcheck] {rate.name} -> {out_hz}: {r['tiles']} tiles of "
              f"{r['tile']} B/ch over {len(devices)} entries "
              f"({', '.join(map(str, devices))}): {verdict}{times}; "
              f"[{label}]", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
