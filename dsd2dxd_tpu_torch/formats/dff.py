"""DFF (DSDIFF) container parsing and writing.

Replaces the reference's ``dff-meta`` crate (SURVEY.md §2.2). Byte layout
verified against the reference fixture id3_test/dff/1kHz_stereo_i.dff
(SURVEY.md §4.2):

    Big-endian IFF: 'FRM8' u64be size 'DSD ' then chunks, each
    4-char id + u64be size + data (padded to even):
      'FVER': u32be version (0x01050000)
      'PROP' ('SND ' form): subchunks 'FS  ' (u32be rate),
          'CHNL' (u16be count + 4-byte channel IDs),
          'CMPR' (4cc + pascal string — must be 'DSD ' / uncompressed)
      'DSD ': byte-interleaved sample data
      'ID3 ': optional ID3v2 tag

    DSD data in DFF is always MSB-first, byte-interleaved.

Tolerance requirements from the fixtures: the FRM8 size field can be
inconsistent with the actual file size, and a trailing 'ID3 ' chunk's
declared size can overrun EOF — parse to EOF, never trust declared sizes
past the end of the file.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import BinaryIO, Optional

from dsd2dxd_tpu_torch.formats.dsd_types import DsdRate, Endianness, FmtType
from dsd2dxd_tpu_torch.formats.source import DsdSource, DsdStreamInfo
from dsd2dxd_tpu_torch.utils.errors import FormatError


@dataclass
class DffMetadata:
    channels: int
    channel_ids: tuple[str, ...]
    sample_rate: int
    data_offset: int
    data_size: int            # payload bytes (all channels)
    id3: Optional[bytes]
    version: int

    @property
    def rate(self) -> DsdRate:
        return DsdRate.from_hz(self.sample_rate)

    @property
    def sample_count(self) -> int:
        """DSD samples (bits) per channel."""
        return self.data_size // self.channels * 8


def _read_chunk_header(f: BinaryIO) -> Optional[tuple[bytes, int]]:
    hdr = f.read(12)
    if len(hdr) < 12:
        return None
    cid = hdr[:4]
    (size,) = struct.unpack(">Q", hdr[4:12])
    return cid, size


def parse_dff(f: BinaryIO) -> DffMetadata:
    head = f.read(16)
    if len(head) < 16 or head[:4] != b"FRM8" or head[12:16] != b"DSD ":
        raise FormatError("Not a DFF file (missing FRM8/DSD form)")

    try:
        real_size = os.fstat(f.fileno()).st_size
    except (OSError, AttributeError):
        real_size = None

    sample_rate = None
    channels = None
    channel_ids: tuple[str, ...] = ()
    version = 0
    data_offset = None
    data_size = 0
    id3: Optional[bytes] = None

    while True:
        pos = f.tell()
        hdr = _read_chunk_header(f)
        if hdr is None:
            break
        cid, size = hdr
        # Clamp lying sizes to what is actually present. For unseekable
        # or non-stat-able streams, still bound metadata-chunk reads: a
        # fuzzed u64 size near 2^64 overflows f.read()'s ssize_t (and
        # would otherwise try to materialize it); PROP/ID3 chunks are
        # small, so a generous cap only bites on garbage.
        if real_size is not None:
            size = min(size, max(0, real_size - (pos + 12)))
        elif cid != b"DSD ":
            size = min(size, 1 << 28)
        if cid == b"FVER":
            (version,) = struct.unpack(">I", f.read(4)[:4].ljust(4, b"\0"))
            f.seek(pos + 12 + size + (size & 1))
        elif cid == b"PROP":
            payload = f.read(size)
            if payload[:4] != b"SND ":
                raise FormatError("DFF: PROP form is not 'SND '")
            off = 4
            while off + 12 <= len(payload):
                scid = payload[off:off + 4]
                (ssize,) = struct.unpack(">Q", payload[off + 4:off + 12])
                sdata = payload[off + 12:off + 12 + ssize]
                # sub-chunks can be cut by the same EOF truncation the
                # top-level clamp tolerates: degrade, don't struct.error
                if scid == b"FS  " and len(sdata) >= 4:
                    (sample_rate,) = struct.unpack(">I", sdata[:4])
                elif scid == b"CHNL" and len(sdata) >= 2:
                    (channels,) = struct.unpack(">H", sdata[:2])
                    if channels < 1:
                        raise FormatError("DFF: CHNL declares 0 channels")
                    ids = []
                    for i in range(channels):
                        s = sdata[2 + 4 * i:6 + 4 * i]
                        ids.append(s.decode("ascii", "replace"))
                    channel_ids = tuple(ids)
                elif scid == b"CMPR":
                    if sdata[:4] != b"DSD ":
                        raise FormatError(
                            f"DFF: compressed DSD ({sdata[:4]!r}) is not supported"
                        )
                off += 12 + ssize + (ssize & 1)
            f.seek(pos + 12 + size + (size & 1))
        elif cid == b"DSD ":
            data_offset = pos + 12
            data_size = size
            f.seek(pos + 12 + size + (size & 1))
        elif cid == b"ID3 ":
            blob = f.read(size)
            if blob[:3] == b"ID3":
                id3 = blob
            f.seek(pos + 12 + size + (size & 1))
        else:
            f.seek(pos + 12 + size + (size & 1))

    if sample_rate is None or channels is None:
        raise FormatError("DFF: missing FS/CHNL properties")
    if data_offset is None:
        raise FormatError("DFF: missing 'DSD ' data chunk")
    # Whole frames only.
    data_size -= data_size % channels
    return DffMetadata(
        channels=channels, channel_ids=channel_ids, sample_rate=sample_rate,
        data_offset=data_offset, data_size=data_size, id3=id3, version=version,
    )


def open_dff(path) -> tuple[DsdSource, DffMetadata]:
    f = open(path, "rb")
    try:
        meta = parse_dff(f)
        f.seek(meta.data_offset)
    except Exception:
        f.close()
        raise
    info = DsdStreamInfo(
        channels=meta.channels,
        rate=meta.rate,
        fmt=FmtType.INTERLEAVED,
        endianness=Endianness.MSB_FIRST,
        block_size=1,
        sample_count=meta.sample_count,
        id3=meta.id3,
    )
    return DsdSource(f, info, data_length=meta.data_size), meta


# ---------------------------------------------------------------------------
# Writing (fixture synthesis)
# ---------------------------------------------------------------------------

_DFF_CH_IDS = {
    1: (b"C   ",),
    2: (b"SLFT", b"SRGT"),
}


def write_dff(path, planes, sample_rate: int, *, id3: Optional[bytes] = None) -> None:
    """Write a DFF file from (channels, n_bytes) MSB-first byte planes."""
    import numpy as np

    planes = np.asarray(planes, dtype=np.uint8)
    ch, nbytes = planes.shape
    data = planes.T.reshape(-1).tobytes()  # byte-interleave

    ch_ids = _DFF_CH_IDS.get(ch, tuple(f"C{i:03d}".encode() for i in range(ch)))
    chnl = struct.pack(">H", ch) + b"".join(ch_ids)
    cmpr = b"DSD " + bytes([14]) + b"not compressed" + b"\0"
    prop_body = (
        b"SND "
        + b"FS  " + struct.pack(">Q", 4) + struct.pack(">I", sample_rate)
        + b"CHNL" + struct.pack(">Q", len(chnl)) + chnl
        + b"CMPR" + struct.pack(">Q", len(cmpr)) + cmpr
    )

    def chunk(cid: bytes, body: bytes) -> bytes:
        pad = b"\0" if len(body) & 1 else b""
        return cid + struct.pack(">Q", len(body)) + body + pad

    body = (
        chunk(b"FVER", struct.pack(">I", 0x01050000))
        + chunk(b"PROP", prop_body)
        + chunk(b"DSD ", data)
    )
    if id3:
        body += chunk(b"ID3 ", id3)
    with open(path, "wb") as f:
        f.write(b"FRM8" + struct.pack(">Q", len(body) + 4) + b"DSD ")
        f.write(body)
