"""Host-stage budget of the port, per BASELINE config.

Counterpart of ``tools/hostbudget.py`` at the repository root. The card's
kernels run far faster than real time, so a conversion's ceiling is set
by the host: the reader thread (read, bit-normalise, copy into the pinned
slot) and the drain thread (write, or the NJAD and FLAC sink). This times
each host stage at the shape its BASELINE config feeds it, with the JAX
tool's protocol -- the median of 2 x pairs reps, and an interleaved
median-of-pairs for the threads 1-against-2 A/Bs -- and prints each
stage's audio-seconds per second (xRT) and each thread's ceiling, 1 /
sum(1 / xRT) over its serial stages.

Stages kept from the JAX tool, same inputs (``_music``, seed 0), at
``--seconds`` of audio:

  njad      native/src/njad.cc requantizer, 20-bit @ 88.2k (config 3),
            DSDKIT_NJAD_THREADS 1 vs 2
  flac88    native/src/flac.cc encode, 20-bit @ 88.2k (config 3),
            DSDKIT_FLAC_THREADS 1 vs 2
  flac352   the same at 24-bit @ 352.8k (config 5), threads 1 vs 2
  frames24  ``engine.int_frames(wire, 24, 2)`` @ 352.8k: the FLAC input
            rebuild (config 5; the JAX tool's deplane24)

On the card, not timed: pack24 (K1 writes the s24 wire bytes itself).

The engine loop's per-tile host stages (``pipeline/engine.py``:
``Converter._run``, ``_Staging.run``, ``_drain``), each on one engine tile
of the config's chain (``engine._tile_bytes_for`` at the engine's tile
target, scaled by the input rate as the engine scales it),
for config 1 (DSD64 .dsf -> 24-bit 352.8k WAV), config 2 (raw interleaved
DSD64, MSB first -> s24le 176.4k) and config 4 (DSD256 .dsf -> f32 AIFC
192k):

  read_planar       ``DsdSource._read_planar`` over a .dsf on disk written
                    by ``formats/dsf.write_dsf`` (configs 1, 4): one
                    ``readinto`` of the tile's blocks and the C++
                    de-interleave (``native/src/dsfread.cc``)
  read_interleaved  ``DsdSource._read_interleaved`` from a raw file (config
                    2; the CLI reads a pipe)
  bitrev            the reader's C++ bit reversal, in place on the tile
                    (the .dsf paths: LSB first)
  stage_pinned      the copy into a pinned slot, as ``_Staging.run`` does
                    it (needs CUDA: left out under ``--device cpu``)
  write             the writer's ``write_packed`` (WAV, AIFC) or the raw
                    file's ``write`` (s24le) of one tile's valid wire bytes

Input files are read once before timing, so every read comes from the
page cache. Reader thread: read, bitrev, stage_pinned; drain thread:
write (configs 1, 2, 4), njad + flac88 (config 3), frames24 + flac352
(config 5).

    python -m dsd2dxd_tpu_torch.tools.hostbudget [--seconds 4] [--pairs 5]
        [--device cpu] [--json PATH]

Without ``--device`` it resolves the card (``utils/device.resolve_device``)
and raises without one. ``--json PATH`` writes the table to PATH; nothing
is written otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from dsd2dxd_tpu_torch.containers.aiff import AiffWriter
from dsd2dxd_tpu_torch.containers.pack import bytes_per_sample
from dsd2dxd_tpu_torch.containers.wav import WavWriter
from dsd2dxd_tpu_torch.filters.design import chain_ratio, get_chain
from dsd2dxd_tpu_torch.formats.dsd_types import (
    DsdRate,
    Endianness,
    FilterType,
    FmtType,
)
from dsd2dxd_tpu_torch.formats.dsf import open_dsf, write_dsf
from dsd2dxd_tpu_torch.formats.source import open_raw_file
from dsd2dxd_tpu_torch.native.loader import load, load_reader
from dsd2dxd_tpu_torch.pipeline import engine
from dsd2dxd_tpu_torch.pipeline.engine import int_frames
from dsd2dxd_tpu_torch.utils.device import card_label, resolve_device

# a runner returns the seconds of its timed section
Runner = Callable[[], float]

SHARED_STAGES = ("njad", "flac88", "flac352", "frames24")
ON_CARD = ("pack24",)
THREADS_ENV = {"njad": "DSDKIT_NJAD_THREADS", "flac88": "DSDKIT_FLAC_THREADS",
               "flac352": "DSDKIT_FLAC_THREADS"}


@dataclass(frozen=True)
class TileConfig:
    """One BASELINE config's reader and writer shape."""

    text: str
    rate: DsdRate
    out_hz: int
    bit_depth: int
    container: str  # "dsf" in: "wav" or "aifc" out; "raw" in: s24le out

    @property
    def reader(self) -> tuple[str, ...]:
        if self.container == "raw":  # MSB first: no bit reversal
            return ("read_interleaved", "stage_pinned")
        return ("read_planar", "bitrev", "stage_pinned")


TILE_CONFIGS = {
    "config 1": TileConfig("DSD64 .dsf -> 24-bit 352.8k WAV",
                           DsdRate.DSD64, 352800, 24, "wav"),
    "config 2": TileConfig("raw interleaved DSD64 from a file (the CLI "
                           "reads a pipe) -> s24le 176.4k",
                           DsdRate.DSD64, 176400, 24, "raw"),
    "config 4": TileConfig("DSD256 .dsf -> f32 AIFC 192k",
                           DsdRate.DSD256, 192000, 32, "aifc"),
}
# the drain thread's serial stages where they are not `write`
SINK_CONFIGS = {"config 3": ("njad", "flac88"),
                "config 5": ("frames24", "flac352")}


def _music(n: int, rate: int, bits: int, rng) -> np.ndarray:
    """Pink-ish stereo int32 at `bits` — the material FLAC compression
    decisions are hardest on (tools/flacbench.py)."""
    w = rng.standard_normal(n + 1024)
    k = np.exp(-np.arange(256) / 48.0)
    x = np.convolve(w, k / k.sum(), mode="same")[:n]
    x = 0.3 * x / np.abs(x).max()
    s = np.round(x * (2 ** (bits - 1) - 1)).astype(np.int32)
    return np.stack([s, np.roll(s, 7)], axis=1)


def _timed(fn: Callable[[], object]) -> Runner:
    def run() -> float:
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    return run


def _median_pairs(fa: Runner, fb: Runner, pairs: int):
    """Interleaved A,B reps; returns (median_a, median_b, median ratio
    a/b per pair)."""
    ta, tb = [], []
    for _ in range(pairs):
        ta.append(fa())
        tb.append(fb())
    ratios = [a / b for a, b in zip(ta, tb)]
    return (statistics.median(ta), statistics.median(tb),
            statistics.median(ratios))


def ceiling(xrts) -> float:
    """A thread's audio-s/s over serial stages of the given xRTs."""
    return 1.0 / sum(1.0 / x for x in xrts)


def stage_runners(secs: float, rng) -> dict[str, Runner]:
    """name -> runner of each shared stage at `secs` of audio. The arrays
    are drawn from `rng` in the JAX tool's order, so njad, flac88 and
    flac352 encode the same samples."""
    native = load()
    n88 = int(secs * 88200)
    xf = (_music(n88, 88200, 20, rng).astype(np.float32)
          / float(1 << 19)).astype(np.float32)

    def run_njad():
        st = native.njad_new(2)
        try:
            native.njad_quantize(st, xf, 20)
        finally:
            native.njad_free(st)

    def flac_encode(x, rate, bps):
        enc = native.flac_new(rate, 2, bps, 8192)
        try:
            native.flac_feed(enc, x)
            native.flac_drain(enc)
            native.flac_finish(enc)
            native.flac_drain(enc)
        finally:
            native.flac_free(enc)

    x88 = _music(n88, 88200, 20, rng)
    n352 = int(secs * 352800)
    x352 = _music(n352, 352800, 24, rng)
    wire = rng.integers(0, 256, size=n352 * 2 * 3, dtype=np.uint8)
    return {
        "njad": _timed(run_njad),
        "flac88": _timed(lambda: flac_encode(x88, 88200, 20)),
        "flac352": _timed(lambda: flac_encode(x352, 352800, 24)),
        "frames24": _timed(lambda: int_frames(wire, 24, 2)),
    }


def tile_shape(cfg: TileConfig):
    """(tile bytes per channel, audio seconds, valid wire bytes) of one
    engine tile of `cfg`'s chain."""
    chain = get_chain(FilterType.EQUIRIPPLE, cfg.rate, cfg.out_hz)
    tile = engine._tile_bytes_for(
        chain, engine._DEFAULT_TILE_TARGET * int(cfg.rate))
    frames = int(tile * 8 * chain_ratio(chain))
    return tile, tile * 8 / cfg.rate.hz, frames * 2 * bytes_per_sample(
        cfg.bit_depth)


def tile_runners(cfg: TileConfig, workdir: Path, device: torch.device,
                 rng) -> dict[str, Runner]:
    """name -> runner of each of `cfg`'s per-tile host stages on one
    stereo engine tile; its input file is written under `workdir` and
    read once, so the timed reads come from the page cache."""
    tile, _audio, wire_bytes = tile_shape(cfg)
    planes = rng.integers(0, 256, size=(2, tile), dtype=np.uint8)
    runners: dict[str, Runner] = {}
    src_path = workdir / ("in.dsd" if cfg.container == "raw" else "in.dsf")
    if cfg.container == "raw":
        src_path.write_bytes(planes.T.tobytes())

        def read_interleaved() -> float:
            src = open_raw_file(src_path, 2, cfg.rate, FmtType.INTERLEAVED,
                                Endianness.MSB_FIRST, 1)
            try:
                t0 = time.perf_counter()
                src._read_interleaved(tile)
                return time.perf_counter() - t0
            finally:
                src._stream.close()

        runners["read_interleaved"] = read_interleaved
    else:
        write_dsf(src_path, planes, cfg.rate.hz)

        def read_planar() -> float:
            src, _meta = open_dsf(src_path)
            try:
                t0 = time.perf_counter()
                src._read_planar(tile)
                return time.perf_counter() - t0
            finally:
                src._stream.close()

        runners["read_planar"] = read_planar
        runners["bitrev"] = _timed(lambda: load_reader().bitrev(planes))
    src_path.read_bytes()  # warm the page cache
    load_reader()  # the reader library's build is no rep's
    if device.type == "cuda":
        pinned = torch.empty((2, tile), dtype=torch.uint8, pin_memory=True)

        def stage() -> None:
            pinned.numpy()[...] = planes

        runners["stage_pinned"] = _timed(stage)
    payload = rng.integers(0, 256, size=wire_bytes, dtype=np.uint8)
    out_path = workdir / f"out.{cfg.container}"

    def write() -> float:
        with open(out_path, "wb") as f:
            if cfg.container == "raw":
                sink = f.write
            else:
                writer = (WavWriter(f, 2, cfg.out_hz, cfg.bit_depth)
                          if cfg.container == "wav" else
                          AiffWriter(f, 2, cfg.out_hz, cfg.bit_depth,
                                     aifc=True))
                sink = writer.write_packed
            t0 = time.perf_counter()
            sink(payload)
            return time.perf_counter() - t0

    runners["write"] = write
    return runners


def measure(fn: Runner, audio_s: float, pairs: int,
            threads_env: Optional[str] = None) -> dict:
    """Median xRT over pairs*2 reps; with `threads_env`, an interleaved
    threads=1-vs-2 A/B and the xRT at 1 thread."""
    if threads_env is None:
        return {"xrt": audio_s / statistics.median(
            fn() for _ in range(pairs * 2))}

    def with_threads(n):
        def run():
            os.environ[threads_env] = str(n)
            try:
                return fn()
            finally:
                os.environ.pop(threads_env, None)
        return run

    t1, _t2, ratio = _median_pairs(with_threads(1), with_threads(2), pairs)
    return {"xrt": audio_s / t1, "t1_over_t2": ratio}


def budget(secs: float, pairs: int, device: torch.device) -> dict:
    """Every stage's xRT and each config's thread ceilings."""
    rng = np.random.default_rng(0)
    stages = {name: measure(fn, secs, pairs, THREADS_ENV.get(name))
              for name, fn in stage_runners(secs, rng).items()}
    configs = {}
    workdir = Path(tempfile.mkdtemp(prefix="hostbudget_"))
    try:
        for name, cfg in TILE_CONFIGS.items():
            tile, audio_s, wire_bytes = tile_shape(cfg)
            runs = tile_runners(cfg, workdir, device, rng)
            xrt = {st: measure(fn, audio_s, pairs)["xrt"]
                   for st, fn in runs.items()}
            configs[name] = {
                "text": cfg.text, "tile_bytes": tile, "audio_s": audio_s,
                "wire_bytes": wire_bytes, "stages": xrt,
                "reader": ceiling(xrt[s] for s in cfg.reader if s in xrt),
                "drain": ceiling([xrt["write"]])}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for name, sink in SINK_CONFIGS.items():
        configs[name] = {"drain": ceiling(stages[s]["xrt"] for s in sink),
                         "sink": list(sink)}
    return {"seconds": secs, "pairs": pairs,
            "cores": os.cpu_count(), "device": str(device),
            "card": card_label() if device.type == "cuda" else None,
            "page_cache": "warm", "stages": stages, "configs": configs,
            "on_card": list(ON_CARD)}


def report(out: dict) -> None:
    where = out["card"] or "no card"
    print(f"host stages, {out['cores']} cores, {out['device']} [{where}]; "
          f"median of {2 * out['pairs']} reps (A/Bs: {out['pairs']} "
          f"interleaved pairs); xRT = audio-s per s")
    for name, row in out["stages"].items():
        ab = (f"   threads1/threads2 = {row['t1_over_t2']:.3f}"
              if "t1_over_t2" in row else "")
        print(f"  {name:<16} {row['xrt']:10.1f}x{ab}")
    for name in ON_CARD:
        print(f"  {name:<16} on the card (K1 writes the wire bytes): "
              f"not timed")
    for name, c in out["configs"].items():
        if "stages" not in c:
            print(f"{name}: drain thread ({' + '.join(c['sink'])}) "
                  f"{c['drain']:.1f}x")
            continue
        print(f"{name} ({c['text']}): one tile of {c['tile_bytes']} B/ch = "
              f"{c['audio_s']:.3f} audio-s, {c['wire_bytes']} wire bytes; "
              f"input read once first (page cache warm)")
        for st, x in c["stages"].items():
            print(f"  {st:<16} {x:10.1f}x")
        if "stage_pinned" not in c["stages"]:
            print("  stage_pinned     left out: pinned memory needs CUDA")
        print(f"  reader thread ceiling {c['reader']:.1f}x, drain thread "
              f"ceiling {c['drain']:.1f}x")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="hostbudget", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seconds", type=float, default=4.0,
                    help="audio seconds of the njad, flac and frames24 "
                         "inputs")
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="cpu leaves out stage_pinned (default: the card)")
    ap.add_argument("--json", type=Path, default=None,
                    help="write the table to this file")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = budget(args.seconds, args.pairs, device)
    report(out)
    if args.json is not None:
        args.json.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
