"""A cell's inputs, made from ``--seed``: a seeded music-like program
(a few tones and pink noise, peaking at or below -6 dBFS) modulated to
DSD in a pool of segments, and tracks of fixed lengths laid end to end
from those segments in a seeded order.

The modulator is the benchmark's own copy of the second-order
delta-sigma loop (``native/dsdkit.cc``), built with g++ into
``benchmark/_build/`` at first use (a fixed path in the checkout, so
later runs find it). The program is synthesised at 1/8 of the DSD rate
and held for 8 (or more) samples before the modulator: its content is
audio, and every seed gives the same sizes.

Every segment is a whole number of DSF blocks (4096 bytes per channel),
so a track's DSF payload is its segments' payloads one after the other,
with only the last block padded.
"""

from __future__ import annotations

import ctypes
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from benchmark import native
from benchmark.reference import containers

ROOT = Path(__file__).resolve().parent
NATIVE = ROOT / "native" / "dsdkit.cc"
BUILD = ROOT / "_build"
PEAK = 0.5  # -6 dBFS
PROGRAM_RATE_DIV = 8  # the program's rate: the DSD rate over this
SEGMENTS = 8  # the pool's segments, every cell's
_lib = None
_lock = threading.Lock()  # the segments' threads build it once


def modulator():
    """The built modulator: dsdkit_dsm2_bits(double* x, uint8* bits, n)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _load(_build())
        return _lib


def _build() -> Path:
    return native.build(NATIVE, BUILD, "libbenchdsm")


def _load(so: Path):
    lib = ctypes.CDLL(str(so))
    lib.dsdkit_dsm2_bits.argtypes = [
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ctypes.c_size_t]
    lib.dsdkit_dsm2_bits.restype = None
    return lib


def _program(rng: np.random.Generator, n: int, rate: float,
             channels: int) -> np.ndarray:
    """(C, n) float64 at `rate`: three tones and pink noise per channel,
    scaled to peak at PEAK."""
    t = np.arange(n) / rate
    out = np.empty((channels, n))
    for c in range(channels):
        x = np.zeros(n)
        for _ in range(3):
            f = float(np.exp(rng.uniform(np.log(30.0), np.log(18000.0))))
            x += rng.uniform(0.1, 0.3) * np.sin(
                2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
        spec = np.fft.rfft(rng.standard_normal(n))
        f = np.fft.rfftfreq(n, 1.0 / rate)
        spec *= 1.0 / np.sqrt(np.maximum(f, 20.0))
        spec[f > 20000.0] = 0.0
        pink = np.fft.irfft(spec, n)
        x += 0.15 * pink / np.sqrt(np.mean(pink * pink))
        out[c] = x * (PEAK / np.max(np.abs(x)))
    return out


def _segment(seed: int, index: int, n_bytes: int, dsd_hz: int,
             channels: int) -> np.ndarray:
    """(C, n_bytes) MSB-first DSD bytes of segment `index`."""
    rng = np.random.default_rng([seed & (2**63 - 1), index])
    n_bits = n_bytes * 8
    x = _program(rng, n_bits // PROGRAM_RATE_DIV, dsd_hz / PROGRAM_RATE_DIV,
                 channels)
    lib = modulator()
    planes = np.empty((channels, n_bytes), dtype=np.uint8)
    bits = np.empty(n_bits, dtype=np.uint8)
    for c in range(channels):
        lib.dsdkit_dsm2_bits(np.repeat(x[c], PROGRAM_RATE_DIV), bits, n_bits)
        planes[c] = np.packbits(bits)
    return planes


@dataclass
class Program:
    """The segment pool and the tracks of a cell for one seed.

    ``tracks[i]`` is a list of (segment, bytes per channel) pieces, every
    piece but the last a whole segment."""

    dsd_hz: int
    channels: int
    segments: list
    tracks: list
    _dsf: dict = field(default_factory=dict)  # segment -> DSF payload

    def track_bytes(self, i: int) -> int:
        return sum(n for _s, n in self.tracks[i])

    def planes(self, i: int) -> np.ndarray:
        """(C, bytes) MSB-first planes of track i."""
        return np.concatenate([self.segments[s][:, :n]
                               for s, n in self.tracks[i]], axis=1)

    def write_dsf(self, i: int, path: Path) -> None:
        """Track i as a DSF file (LSB-first, planar 4096-byte blocks), on
        disk before this returns."""
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        try:
            _write_all(fd, containers.dsf_header(
                self.channels, self.dsd_hz, self.track_bytes(i)))
            blk = containers.DSF_BLOCK
            for s, n in self.tracks[i]:
                q, r = divmod(n, blk)
                if s not in self._dsf:
                    self._dsf[s] = containers.dsf_blocks(self.segments[s])
                _write_all(fd, self._dsf[s][:q * blk * self.channels])
                if r:
                    _write_all(fd, containers.dsf_last_block(
                        self.segments[s][:, q * blk:n]))
            os.fsync(fd)
        finally:
            os.close(fd)

    def write_raw_pool(self, path: Path) -> list:
        """Every segment, interleaved MSB-first, one after another in one
        file; returns each segment's byte offset in it."""
        offsets, pos = [], 0
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        try:
            for seg in self.segments:
                data = containers.interleaved(seg)
                _write_all(fd, data)
                offsets.append(pos)
                pos += data.size
            os.fsync(fd)
        finally:
            os.close(fd)
        return offsets


def _write_all(fd: int, data) -> None:
    view = memoryview(np.ascontiguousarray(data)).cast("B")
    while view:
        view = view[os.write(fd, view):]


def make_program(seed: int, dsd_hz: int, channels: int,
                 track_seconds: list, segment_s: float) -> Program:
    """The pool of SEGMENTS segments of about `segment_s` seconds (a
    whole number of DSF blocks) and tracks of exactly `track_seconds`,
    each from a seeded start in a seeded order of the pool."""
    segments = SEGMENTS
    blk = containers.DSF_BLOCK
    seg_bytes = max(1, round(segment_s * dsd_hz / 8 / blk)) * blk
    with ThreadPoolExecutor(max_workers=4) as pool:
        segs = list(pool.map(
            lambda k: _segment(seed, k, seg_bytes, dsd_hz, channels),
            range(segments)))
    rng = np.random.default_rng([seed & (2**63 - 1), 1 << 20])
    order = rng.permutation(segments)
    tracks = []
    for secs in track_seconds:
        n = round(secs * dsd_hz / 8)
        pos = int(rng.integers(segments))
        pieces = []
        while n > 0:
            take = min(n, seg_bytes)
            pieces.append((int(order[pos % segments]), take))
            pos += 1
            n -= take
        tracks.append(pieces)
    return Program(dsd_hz, channels, segs, tracks)
