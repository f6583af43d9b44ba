"""Unified blockwise DSD sources.

Replaces the reference's ``dsd-reader`` crate (SURVEY.md §2.2): a common
interface over .dsf (planar blocks), .dff (byte-interleaved) and raw
streams, normalizing everything to **per-channel byte planes in MSB-first
bit order** — the canonical layout the device kernels consume.

The reader sets the pace of a .dsf conversion on the card, so a read
fetches the tile's bytes with one ``readinto`` into a buffer the source
reuses, and ``native/src/dsfread.cc`` de-interleaves a planar run of
blocks and bit-reverses an LSB-first tile in place: one C++ call each,
outside the interpreter lock, in place of per-block Python and a numpy
table gather.
"""

from __future__ import annotations

import io
from dataclasses import dataclass
from typing import BinaryIO, Optional

import numpy as np

from dsd2dxd_tpu_torch.formats.dsd_types import DsdRate, Endianness, FmtType
from dsd2dxd_tpu_torch.native.loader import load_reader
from dsd2dxd_tpu_torch.utils.trace import span

# 256-entry bit-reversal table: LSB-first byte -> MSB-first byte.
_BITREV = np.array(
    [int(f"{b:08b}"[::-1], 2) for b in range(256)], dtype=np.uint8
)


def reverse_bits(data: np.ndarray) -> np.ndarray:
    """Reverse the bit order within each byte (LSB-first <-> MSB-first).
    The reader does it in place in C++; this copy serves ``write_dsf``."""
    return _BITREV[data]


@dataclass
class DsdStreamInfo:
    """Stream parameters, either from container metadata or CLI flags.

    Container metadata overrides CLI flags in the engine
    (reference README.md:102-106).
    """

    channels: int
    rate: DsdRate
    fmt: FmtType
    endianness: Endianness
    block_size: int  # bytes per channel per block (planar); 1 for interleaved
    # Total DSD samples (bits) per channel, None when unknown (stdin/raw).
    sample_count: Optional[int] = None
    id3: Optional[bytes] = None  # raw ID3v2 tag bytes if present

    @property
    def data_bytes_per_channel(self) -> Optional[int]:
        if self.sample_count is None:
            return None
        return (self.sample_count + 7) // 8

    @property
    def duration_seconds(self) -> Optional[float]:
        if self.sample_count is None:
            return None
        return self.sample_count / self.rate.hz


class DsdSource:
    """Blockwise reader producing canonical (channels, n_bytes) uint8 planes,
    MSB-first bit order.

    ``read(n_bytes_per_ch)`` returns a fresh array with up to
    ``n_bytes_per_ch`` columns (less at EOF), or None at end of stream.
    ``read_calls`` counts the stream reads made, ``read_tiles`` the arrays
    returned.
    """

    def __init__(self, stream: BinaryIO, info: DsdStreamInfo,
                 data_length: Optional[int] = None):
        """``data_length``: total DSD payload bytes available in ``stream``
        (all channels combined), or None to read until EOF."""
        self._stream = stream
        self.info = info
        self._remaining = data_length
        # Per-channel bytes already handed out (for sample-count trimming).
        self._out_bytes = 0
        self._pending: Optional[np.ndarray] = None  # leftover planar block tail
        self._buf = np.empty(0, dtype=np.uint8)  # file bytes, reused
        self.read_calls = 0
        self.read_tiles = 0

    # -- internal helpers ---------------------------------------------------

    def _read_raw(self, n: int) -> np.ndarray:
        """Up to `n` payload bytes (fewer at the payload's end), read into
        the reused buffer, which holds at least `n`: a view of it, valid
        until the next read."""
        if self._buf.size < n:
            self._buf = np.empty(n, dtype=np.uint8)
        if self._remaining is not None:
            n = min(n, self._remaining)
        view = memoryview(self._buf)
        got = 0
        while got < n:
            k = self._stream.readinto(view[got:n])
            self.read_calls += 1
            if not k:
                break
            got += k
        if self._remaining is not None:
            self._remaining -= got
        return self._buf[:got]

    def _normalize(self, planes: np.ndarray) -> np.ndarray:
        if self.info.endianness is Endianness.LSB_FIRST:
            with span("dsd2dxd.read.bitrev"):
                load_reader().bitrev(planes)
        return planes

    # -- public -------------------------------------------------------------

    def read(self, n_bytes_per_ch: int) -> Optional[np.ndarray]:
        limit = self.info.data_bytes_per_channel
        if limit is not None and self._out_bytes >= limit:
            return None
        if limit is not None:
            n_bytes_per_ch = min(n_bytes_per_ch, limit - self._out_bytes)

        with span("dsd2dxd.read.planes"):
            if self.info.fmt is FmtType.INTERLEAVED:
                planes = self._read_interleaved(n_bytes_per_ch)
            else:
                planes = self._read_planar(n_bytes_per_ch)
        if planes is None or planes.shape[1] == 0:
            return None
        self._out_bytes += planes.shape[1]
        self.read_tiles += 1
        return self._normalize(planes)

    def _read_interleaved(self, n_per_ch: int) -> Optional[np.ndarray]:
        c = self.info.channels
        raw = self._read_raw(n_per_ch * c)
        n = raw.size // c * c  # drop trailing partial frame
        if n == 0:
            return None
        return raw[:n].reshape(-1, c).T.copy()

    def _read_planar(self, n_per_ch: int) -> Optional[np.ndarray]:
        c = self.info.channels
        bs = self.info.block_size
        if bs < 1:  # a raw stream's block size from the command line
            return None
        pending = self._pending
        take = 0 if pending is None else min(n_per_ch, pending.shape[1])
        need = n_per_ch - take
        # the run of whole blocks that covers the rest, in one read
        raw = self._read_raw(-(-need // bs) * bs * c if need > 0 else 0)
        blocks = -(-raw.size // (bs * c))
        if raw.size < blocks * bs * c:
            # Short/truncated final super-block: pad with the DSD
            # idle pattern, NOT zeros — 0x00 bits are full-scale
            # negative DC, and when a truncated file's header still
            # declares the full sample count the pad falls INSIDE
            # the valid range, so zero-pad fabricated a loud DC
            # thump that inflated peaks (engine tile padding already
            # used idle for the same reason).
            self._buf[raw.size:blocks * bs * c] = 0x69
            raw = self._buf[:blocks * bs * c]
        cols = min(blocks * bs, need)
        if take + cols == 0:
            return None
        out = np.empty((c, take + cols), dtype=np.uint8)
        if take:
            out[:, :take] = pending[:, :take]
            self._pending = (
                pending[:, take:] if take < pending.shape[1] else None
            )
        load_reader().planes(raw, blocks, bs, out, take)
        if cols < blocks * bs:
            last = raw[(blocks - 1) * bs * c:].reshape(c, bs)
            self._pending = last[:, cols - (blocks - 1) * bs:].copy()
        return out


def raw_source(stream: BinaryIO, channels: int, rate: DsdRate, fmt: FmtType,
               endianness: Endianness, block_size: int,
               data_length: Optional[int] = None,
               sample_count: Optional[int] = None) -> DsdSource:
    """Source over a raw DSD bitstream (stdin or a .dsd file), with all
    parameters supplied by the caller (reference: src/main.rs:325-343 —
    ``Rdsd2Pcm::new`` takes explicit fmt/endian/rate/block-size/channels)."""
    if fmt is FmtType.INTERLEAVED:
        block_size = 1
    info = DsdStreamInfo(
        channels=channels, rate=rate, fmt=fmt, endianness=endianness,
        block_size=block_size, sample_count=sample_count,
    )
    return DsdSource(stream, info, data_length=data_length)


def open_raw_file(path, channels: int, rate: DsdRate, fmt: FmtType,
                  endianness: Endianness, block_size: int) -> DsdSource:
    import os

    f = open(path, "rb")
    size = os.fstat(f.fileno()).st_size
    # For raw files we know the payload size; derive the per-channel sample
    # count so progress is exact.
    per_ch = size // channels
    return raw_source(
        f, channels, rate, fmt, endianness, block_size,
        data_length=size, sample_count=per_ch * 8,
    )
