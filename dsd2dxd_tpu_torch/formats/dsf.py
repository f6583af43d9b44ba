"""DSF container parsing and writing.

Replaces the reference's ``dsf-meta`` crate (SURVEY.md §2.2). Byte layout
verified against the reference fixtures (SURVEY.md §4.2, e.g.
test/1kHz_mono_p.dsf):

    'DSD ' chunk (28 B): magic, u64le chunk size (28), u64le total file
        size, u64le metadata (ID3v2) pointer — 0 if absent.
    'fmt ' chunk (52 B): magic, u64le chunk size (52), u32 version (1),
        u32 format id (0 = DSD raw), u32 channel type, u32 channel count,
        u32 sampling frequency, u32 bits-per-sample (1 = LSB-first,
        8 = MSB-first), u64 sample count per channel (in bits), u32 block
        size per channel (4096), u32 reserved.
    'data' chunk: magic, u64le chunk size (12 + payload), payload of
        channel-planar blocks (block_size bytes per channel per block).

Tolerance requirements come from the broken fixtures
(id3_test/1kHz_mono_brokenid3.dsf): the file-size field and the metadata
pointer may be inconsistent with the real file size — never trust them
blindly (SURVEY.md §4.2).
"""

from __future__ import annotations

import io
import os
import struct
from dataclasses import dataclass
from typing import BinaryIO, Optional

from dsd2dxd_tpu_torch.formats.dsd_types import DsdRate, Endianness, FmtType
from dsd2dxd_tpu_torch.formats.source import DsdSource, DsdStreamInfo
from dsd2dxd_tpu_torch.utils.errors import FormatError

DSF_HEADER_LEN = 28
FMT_CHUNK_LEN = 52


@dataclass
class DsfMetadata:
    channels: int
    channel_type: int
    sample_rate: int
    bits_per_sample: int      # 1 = LSB-first, 8 = MSB-first
    sample_count: int         # per channel, in bits
    block_size: int           # bytes per channel per block
    data_offset: int          # file offset of the DSD payload
    data_size: int            # payload bytes (all channels)
    metadata_offset: int      # ID3v2 pointer; 0 if absent
    file_size: int            # as declared (may lie)

    @property
    def endianness(self) -> Endianness:
        return Endianness.LSB_FIRST if self.bits_per_sample == 1 else Endianness.MSB_FIRST

    @property
    def rate(self) -> DsdRate:
        return DsdRate.from_hz(self.sample_rate)


def parse_dsf_header(f: BinaryIO) -> DsfMetadata:
    head = f.read(DSF_HEADER_LEN)
    if len(head) < DSF_HEADER_LEN or head[:4] != b"DSD ":
        raise FormatError("Not a DSF file (missing 'DSD ' chunk)")
    _, file_size, meta_ptr = struct.unpack("<QQQ", head[4:28])

    fmt = f.read(FMT_CHUNK_LEN)
    if len(fmt) < FMT_CHUNK_LEN or fmt[:4] != b"fmt ":
        raise FormatError("DSF: missing 'fmt ' chunk")
    (fmt_size, version, format_id, ch_type, ch_num, fs, bits,
     sample_count, block_size, _reserved) = struct.unpack("<QIIIIIIQII", fmt[4:52])
    if format_id != 0:
        raise FormatError(f"DSF: unsupported format id {format_id} (only raw DSD)")
    if bits not in (1, 8):
        raise FormatError(f"DSF: invalid bits-per-sample {bits}")
    if ch_num < 1:
        raise FormatError("DSF: zero channels")
    if not 1 <= block_size <= (1 << 20):
        # spec value is 4096; 0 would loop reading empty super-blocks
        # into a silent empty output, and a lying huge value would make
        # the reader allocate block_size*channels at once
        raise FormatError(f"DSF: implausible block size {block_size}")

    data_hdr = f.read(12)
    if len(data_hdr) < 12 or data_hdr[:4] != b"data":
        raise FormatError("DSF: missing 'data' chunk")
    (data_chunk_size,) = struct.unpack("<Q", data_hdr[4:12])
    data_offset = DSF_HEADER_LEN + FMT_CHUNK_LEN + 12
    data_size = max(0, data_chunk_size - 12)

    # Defend against lying size fields (broken fixture: declared file size
    # exceeds the real one) by clamping to the actual file size when seekable.
    try:
        real = os.fstat(f.fileno()).st_size
        data_size = min(data_size, max(0, real - data_offset))
    except (OSError, AttributeError, io.UnsupportedOperation):
        pass

    return DsfMetadata(
        channels=ch_num, channel_type=ch_type, sample_rate=fs,
        bits_per_sample=bits, sample_count=sample_count, block_size=block_size,
        data_offset=data_offset, data_size=data_size,
        metadata_offset=meta_ptr, file_size=file_size,
    )


def read_dsf_id3(f: BinaryIO, meta: DsfMetadata) -> Optional[bytes]:
    """Read the raw ID3v2 tag the metadata pointer addresses.

    Tolerates truncated tags: returns whatever bytes exist
    (broken fixture: declared ID3 size overruns EOF — SURVEY.md §4.2)."""
    if meta.metadata_offset == 0:
        return None
    try:
        f.seek(meta.metadata_offset)
        head = f.read(10)
        if len(head) < 10 or head[:3] != b"ID3":
            return None
        # bounded read: the pointer is untrusted (it can point into the
        # audio data of a multi-GiB file — an unbounded f.read() here
        # materialized nearly the whole file before the prefix check);
        # read only what the syncsafe tag header declares, tolerating
        # truncation (broken fixture, SURVEY.md §4.2)
        declared = ((head[6] & 0x7F) << 21 | (head[7] & 0x7F) << 14
                    | (head[8] & 0x7F) << 7 | (head[9] & 0x7F))
        footer = 10 if head[5] & 0x10 else 0
        blob = head + f.read(declared + footer)
    except OSError:
        return None
    return blob


def open_dsf(path) -> tuple[DsdSource, DsfMetadata]:
    f = open(path, "rb")
    try:
        meta = parse_dsf_header(f)
        id3 = read_dsf_id3(f, meta)
        f.seek(meta.data_offset)
    except Exception:
        f.close()
        raise
    info = DsdStreamInfo(
        channels=meta.channels,
        rate=meta.rate,
        fmt=FmtType.PLANAR,
        endianness=meta.endianness,
        block_size=meta.block_size,
        sample_count=meta.sample_count,
        id3=id3,
    )
    return DsdSource(f, info, data_length=meta.data_size), meta


# ---------------------------------------------------------------------------
# Writing (used for synthesizing test fixtures and by any future PCM->DSD path)
# ---------------------------------------------------------------------------

def write_dsf(path, planes, sample_rate: int, *, lsb_first: bool = True,
              block_size: int = 4096, id3: Optional[bytes] = None) -> None:
    """Write a DSF file from per-channel byte planes (channels, n_bytes),
    MSB-first bit order in memory (converted on write if lsb_first)."""
    import numpy as np

    from dsd2dxd_tpu_torch.formats.source import reverse_bits

    planes = np.asarray(planes, dtype=np.uint8)
    if planes.ndim != 2:
        raise ValueError("planes must be (channels, n_bytes)")
    ch, nbytes = planes.shape
    if lsb_first:
        planes = reverse_bits(planes)
    sample_count = nbytes * 8
    nblocks = (nbytes + block_size - 1) // block_size
    padded = np.zeros((ch, nblocks * block_size), dtype=np.uint8)
    padded[:, :nbytes] = planes
    # planar per block: block of ch0, block of ch1, ... for each super-block
    data = (
        padded.reshape(ch, nblocks, block_size)
        .transpose(1, 0, 2)
        .tobytes()
    )
    data_chunk_size = 12 + len(data)
    file_size = DSF_HEADER_LEN + FMT_CHUNK_LEN + data_chunk_size + (len(id3) if id3 else 0)
    meta_ptr = DSF_HEADER_LEN + FMT_CHUNK_LEN + data_chunk_size if id3 else 0
    ch_type = {1: 1, 2: 2}.get(ch, ch)

    with open(path, "wb") as f:
        f.write(b"DSD " + struct.pack("<QQQ", DSF_HEADER_LEN, file_size, meta_ptr))
        f.write(b"fmt " + struct.pack(
            "<QIIIIIIQII", FMT_CHUNK_LEN, 1, 0, ch_type, ch, sample_rate,
            1 if lsb_first else 8, sample_count, block_size, 0))
        f.write(b"data" + struct.pack("<Q", data_chunk_size))
        f.write(data)
        if id3:
            f.write(id3)
