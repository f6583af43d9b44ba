"""Streaming WAV writer (PCM int and IEEE float), with ID3 chunk support.

Replaces the reference's WAV output path (OutputType::Wav,
reference src/main.rs:207-214). Little-endian RIFF; int output uses
format tag 1 (PCM), 32-bit float uses tag 3 (IEEE_FLOAT). 20-bit output
is carried in a 24-bit container (see containers/pack.py). ID3v2 tags are
embedded as an 'id3 ' chunk, which is how common taggers store ID3 in WAV.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Optional

import numpy as np

from dsd2dxd_tpu_torch.containers.pack import bytes_per_sample, pack


class WavWriter:
    def __init__(self, f: BinaryIO, channels: int, sample_rate: int,
                 bit_depth: int, id3: Optional[bytes] = None):
        self.f = f
        self.channels = channels
        self.sample_rate = sample_rate
        self.bit_depth = bit_depth
        self._id3 = id3
        self._data_bytes = 0
        self._bps = bytes_per_sample(bit_depth)
        self._write_header(0)

    @property
    def container_bits(self) -> int:
        return 24 if self.bit_depth == 20 else self.bit_depth

    def _write_header(self, data_size: int) -> None:
        ch, sr = self.channels, self.sample_rate
        bits = self.container_bits
        block_align = ch * self._bps
        byte_rate = sr * block_align
        fmt_tag = 3 if self.bit_depth == 32 else 1
        id3_chunk = b""
        if self._id3:
            body = self._id3
            pad = b"\x00" if len(body) & 1 else b""
            id3_chunk = b"id3 " + struct.pack("<I", len(body)) + body + pad
        fact_chunk = b""
        if fmt_tag != 1:
            # the RIFF spec requires a fact chunk (dwSampleLength =
            # frames per channel) for every non-PCM format tag; strict
            # readers reject or misreport float WAVs without it
            frames = data_size // block_align if block_align else 0
            fact_chunk = b"fact" + struct.pack("<II", 4,
                                               min(frames, 0xFFFFFFFF))
        riff_size = (4 + (8 + 16) + len(fact_chunk) + len(id3_chunk)
                     + (8 + data_size) + (data_size & 1))
        if riff_size > 0xFFFFFFFF:
            # RIFF sizes are 32-bit; a >4 GiB conversion must not crash
            # at finalize (the audio is already on disk). Clamp and warn
            # — players read the data to EOF when the size field is
            # maxed, which is the common convention for oversized WAV.
            from dsd2dxd_tpu_torch.utils.logging import get_logger

            get_logger().warning(
                "WAV output exceeds the 4 GiB RIFF limit; size fields "
                "clamped (readers will use EOF)")
            riff_size = 0xFFFFFFFF
            data_size = min(data_size, 0xFFFFFFFF)
        self.f.write(b"RIFF" + struct.pack("<I", riff_size) + b"WAVE")
        self.f.write(b"fmt " + struct.pack(
            "<IHHIIHH", 16, fmt_tag, ch, sr, byte_rate, block_align, bits))
        if fact_chunk:
            self.f.write(fact_chunk)
        if id3_chunk:
            self.f.write(id3_chunk)
        self.f.write(b"data" + struct.pack("<I", data_size))

    def write(self, samples: np.ndarray) -> None:
        """samples: (frames, channels) int32 (quantized) or float32."""
        payload = pack(samples, self.bit_depth, big_endian=False)
        self.f.write(payload)
        self._data_bytes += len(payload)

    def write_packed(self, payload: bytes) -> None:
        self.f.write(payload)
        self._data_bytes += len(payload)

    def finalize(self) -> None:
        if self._data_bytes & 1:
            self.f.write(b"\x00")
        if self.f.seekable():
            self.f.seek(0)
            self._write_header(self._data_bytes)
        self.f.flush()
