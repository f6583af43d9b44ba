"""Plain readers of what a conversion writes, and plain writers of what it
reads, by the published layouts:

- WAV (RIFF, little-endian): ``fmt `` chunk (tag 1 PCM or 3 IEEE float,
  channels, rate, bits), then ``data``;
- AIFF-C (IFF, big-endian): ``COMM`` (channels, frames, bits, the rate as
  an 80-bit float, compression ``fl32`` or ``NONE``), then ``SSND`` (offset,
  block size, samples);
- raw s24le / f32le frames on stdout;
- FLAC: the ``fLaC`` marker, STREAMINFO (block sizes, rate, channels, bits
  per sample, total samples), then frames; decoded by the C++ reader
  ``native/flac.h`` (``flac_samples``), written from the format (RFC
  9639) and sharing nothing with the port's encoder;
- DSF input: the ``DSD ``, ``fmt `` and ``data`` chunks, LSB-first bits in
  planar blocks of 4096 bytes per channel, the last block zero-padded;
- raw DSD input: MSB-first bytes, interleaved by channel.

A writer that cannot seek (a pipe) leaves the size fields as it first
wrote them, so the frames are read by the count the caller expects (a
FLAC stream's STREAMINFO total and MD5 stay 0: its frames are counted
from the stream itself).
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass

import numpy as np
import torch

DSF_BLOCK = 4096
BITREV = np.array([int(f"{b:08b}"[::-1], 2) for b in range(256)],
                  dtype=np.uint8)


@dataclass(frozen=True)
class Layout:
    """Where a conversion's samples are: the payload's byte offset, its
    channels, rate and sample type (``s16``/``s24``/``f32``, or ``flac``
    with its bits per sample), byte order, and whether an odd payload is
    padded to an even size (a chunk)."""

    offset: int
    channels: int
    rate: int
    sample: str
    big_endian: bool
    padded: bool = True
    bits: int = 0  # a FLAC stream's bits per sample

    @property
    def frame_bytes(self) -> int:
        return self.channels * {"s16": 2, "s24": 3, "f32": 4}[self.sample]


def _ext80(b: bytes) -> float:
    exp, mant = struct.unpack(">HQ", b)
    sign = -1.0 if exp & 0x8000 else 1.0
    exp &= 0x7FFF
    return 0.0 if exp == 0 and mant == 0 else sign * math.ldexp(
        mant, exp - 16383 - 63)


def parse_wav(head: bytes) -> Layout:
    if head[:4] != b"RIFF" or head[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE stream")
    pos, fmt = 12, None
    while pos + 8 <= len(head):
        cid, size = head[pos:pos + 4], struct.unpack("<I", head[pos + 4:pos + 8])[0]
        if cid == b"fmt ":
            tag, ch, rate, _br, _ba, bits = struct.unpack(
                "<HHIIHH", head[pos + 8:pos + 24])
            fmt = (tag, ch, rate, bits)
        elif cid == b"data":
            if fmt is None:
                raise ValueError("WAV data before its fmt chunk")
            tag, ch, rate, bits = fmt
            sample = {(1, 16): "s16", (1, 24): "s24", (3, 32): "f32"}.get(
                (tag, bits))
            if sample is None:
                raise ValueError(f"WAV format tag {tag} at {bits} bits")
            return Layout(pos + 8, ch, rate, sample, False)
        pos += 8 + size + (size & 1)
    raise ValueError("no WAV data chunk in the header bytes")


def parse_aifc(head: bytes) -> Layout:
    if head[:4] != b"FORM" or head[8:12] not in (b"AIFC", b"AIFF"):
        raise ValueError("not an IFF/AIFF stream")
    pos, comm = 12, None
    while pos + 8 <= len(head):
        cid, size = head[pos:pos + 4], struct.unpack(">I", head[pos + 4:pos + 8])[0]
        body = head[pos + 8:pos + 8 + size]
        if cid == b"COMM":
            ch, _frames, bits = struct.unpack(">hIh", body[:8])
            rate = _ext80(body[8:18])
            ctype = body[18:22] if head[8:12] == b"AIFC" else b"NONE"
            comm = (ch, int(rate), bits, ctype)
        elif cid == b"SSND":
            if comm is None:
                raise ValueError("AIFF SSND before its COMM chunk")
            ch, rate, bits, ctype = comm
            sample = {(b"fl32", 32): "f32", (b"NONE", 24): "s24",
                      (b"NONE", 16): "s16"}.get((ctype, bits))
            if sample is None:
                raise ValueError(f"AIFF compression {ctype!r} at {bits} bits")
            offset = struct.unpack(">I", body[:4])[0]
            return Layout(pos + 16 + offset, ch, rate, sample, True)
        pos += 8 + size + (size & 1)
    raise ValueError("no AIFF SSND chunk in the header bytes")


def raw_layout(channels: int, rate: int, bit_depth: int) -> Layout:
    """stdout's raw little-endian frames."""
    return Layout(0, channels, rate,
                  {16: "s16", 20: "s24", 24: "s24", 32: "f32"}[bit_depth],
                  False, False)


def parse_flac(head: bytes) -> Layout:
    """STREAMINFO, and the first frame's offset past every metadata
    block."""
    if head[:4] != b"fLaC":
        raise ValueError("not a FLAC stream")
    pos, info = 4, None
    while True:
        if pos + 4 > len(head):
            raise ValueError("FLAC metadata longer than the header bytes")
        last, kind = head[pos] & 0x80, head[pos] & 0x7F
        size = int.from_bytes(head[pos + 1:pos + 4], "big")
        if (kind == 0) != (info is None) or (kind == 0 and size != 34):
            raise ValueError("FLAC STREAMINFO missing or not first")
        if kind == 0:
            b = int.from_bytes(head[pos + 14:pos + 22], "big")
            info = (b >> 44, ((b >> 41) & 7) + 1, ((b >> 36) & 31) + 1)
        pos += 4 + size
        if last:
            break
    rate, ch, bits = info
    return Layout(pos, ch, rate, "flac", True, False, bits)


# the output extensions, as the CLI names them, that parse() reads
EXTENSIONS = ("wav", "aifc", "pcm", "flac")


def parse(extension: str, head: bytes, channels: int, rate: int,
          bit_depth: int) -> Layout:
    """The layout of a conversion's output, by the extension the CLI
    gives it: ``wav``, ``aifc``, ``pcm`` (stdout's raw frames) or
    ``flac``."""
    if extension == "wav":
        return parse_wav(head)
    if extension == "aifc":
        return parse_aifc(head)
    if extension == "pcm":
        return raw_layout(channels, rate, bit_depth)
    if extension == "flac":
        return parse_flac(head)
    raise ValueError(f"no reader of .{extension} output")


def samples(payload: torch.Tensor, layout: Layout) -> torch.Tensor:
    """(C, frames) samples of a (frames * frame_bytes,) uint8 payload:
    integers as int32 (16 or 24 significant bits), floats as float32."""
    width = {"s16": 2, "s24": 3, "f32": 4}[layout.sample]
    b = payload.reshape(-1, width).to(torch.int32)
    if layout.big_endian:
        b = b.flip(1)
    word = b[:, 0]
    for i in range(1, width):
        word = word | (b[:, i] << (8 * i))
    if layout.sample == "f32":
        out = word.view(torch.float32)
    else:
        shift = 32 - 8 * width
        out = (word << shift) >> shift  # sign-extend
    return out.reshape(-1, layout.channels).T


def flac_samples(data, channels: int, frames: int) -> np.ndarray:
    """(C, frames) int32 samples of a whole FLAC stream, decoded by the C++
    reader; ValueError where the stream is not a sound FLAC stream of
    `channels` channels and exactly `frames` samples per channel (every
    frame's header CRC-8 and CRC-16 checked, frames in sequence)."""
    from benchmark import native

    out = np.zeros((channels, frames + 1), dtype=np.int32)
    n, err, at, frame = native.flac_decode(
        np.frombuffer(data, dtype=np.uint8), out)
    if n < 0:
        raise ValueError(f"FLAC: {err} at byte {at} (frame {frame})")
    if n != frames:
        raise ValueError(f"FLAC: {n} samples per channel, {frames} expected")
    return out[:, :frames]


# ---- inputs ----------------------------------------------------------------

def dsf_header(channels: int, rate_hz: int, n_bytes: int) -> bytes:
    """The DSF chunks before the payload of a track of n_bytes bytes per
    channel (LSB-first, 4096-byte blocks, no metadata)."""
    n_blocks = -(-n_bytes // DSF_BLOCK)
    data_chunk = 12 + n_blocks * DSF_BLOCK * channels
    ch_type = {1: 1, 2: 2}.get(channels, channels)
    return (b"DSD " + struct.pack("<QQQ", 28, 28 + 52 + data_chunk, 0)
            + b"fmt " + struct.pack("<QIIIIIIQII", 52, 1, 0, ch_type, channels,
                                    rate_hz, 1, n_bytes * 8, DSF_BLOCK, 0)
            + b"data" + struct.pack("<Q", data_chunk))


def dsf_blocks(planes_msb: np.ndarray) -> np.ndarray:
    """(C, n) MSB-first planes, n a whole number of blocks, as DSF's
    planar payload: blocks of 4096 LSB-first bytes, channel after channel."""
    c, n = planes_msb.shape
    return np.ascontiguousarray(
        BITREV[planes_msb].reshape(c, n // DSF_BLOCK, DSF_BLOCK)
        .transpose(1, 0, 2)).reshape(-1)


def dsf_last_block(planes_msb: np.ndarray) -> np.ndarray:
    """One block per channel of the (C, r) MSB-first planes, r below a
    block: LSB-first, zero-padded."""
    c, r = planes_msb.shape
    out = np.zeros((c, DSF_BLOCK), dtype=np.uint8)
    out[:, :r] = BITREV[planes_msb]
    return out.reshape(-1)


def interleaved(planes_msb: np.ndarray) -> np.ndarray:
    """(C, n) planes as raw interleaved MSB-first bytes."""
    return np.ascontiguousarray(planes_msb.T).reshape(-1)
