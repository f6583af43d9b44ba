"""Streaming AIFF / AIFF-C writers, with ID3 chunk support.

Replaces the reference's AIFF (OutputType::Aiff) and AIFC
(OutputType::Aifc) output paths (reference src/main.rs:207-214).

AIFF: big-endian IFF 'FORM'/'AIFF' with COMM + SSND; integer samples are
big-endian two's complement. AIFF-C ('AIFC') carries 32-bit float as
compression type 'fl32' (the reference's -o C float path,
build_test_stereo_flt.sh). ID3 goes in an 'ID3 ' chunk (the convention
the id3 crate and common taggers use for AIFF).
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Optional

import numpy as np

from dsd2dxd_tpu_torch.containers.pack import bytes_per_sample, pack


def _extended80(x: float) -> bytes:
    """Encode a float as 80-bit IEEE 754 extended (AIFF sample rate field)."""
    if x == 0:
        return b"\x00" * 10
    import math

    sign = 0
    if x < 0:
        sign = 0x8000
        x = -x
    m, e = math.frexp(x)  # x = m * 2**e, m in [0.5, 1)
    exponent = e + 16382
    mantissa = int(m * (1 << 64))
    return struct.pack(">HQ", sign | exponent, mantissa)


class AiffWriter:
    """AIFF (int PCM) or AIFC ('fl32' float) writer."""

    def __init__(self, f: BinaryIO, channels: int, sample_rate: int,
                 bit_depth: int, *, aifc: bool = False,
                 id3: Optional[bytes] = None):
        if bit_depth == 32 and not aifc:
            raise ValueError("32-bit float requires AIFC output")
        self.f = f
        self.channels = channels
        self.sample_rate = sample_rate
        self.bit_depth = bit_depth
        self.aifc = aifc
        self._id3 = id3
        self._bps = bytes_per_sample(bit_depth)
        self._data_bytes = 0
        self._write_header(0)

    @property
    def container_bits(self) -> int:
        return 24 if self.bit_depth == 20 else self.bit_depth

    def _chunks(self, data_size: int) -> bytes:
        ch = self.channels
        if data_size > 0xFFFFFFFF - 16:
            # IFF sizes (FORM total, SSND, COMM numSampleFrames) are
            # 32-bit; a >4 GiB conversion must not crash at finalize
            # (the audio is already on disk). Clamp and warn — readers
            # fall back to EOF for maxed size fields.
            from dsd2dxd_tpu_torch.utils.logging import get_logger

            get_logger().warning(
                "AIFF output exceeds the 4 GiB IFF limit; size fields "
                "clamped (readers will use EOF)")
            data_size = 0xFFFFFFFF - 16
        frames = data_size // (self._bps * ch) if ch else 0
        body = b""
        if self.aifc:
            body += b"FVER" + struct.pack(">I", 4) + struct.pack(">I", 0xA2805140)
        comm = struct.pack(">hIh", ch, frames, self.container_bits)
        comm += _extended80(float(self.sample_rate))
        if self.aifc:
            if self.bit_depth == 32:
                ctype, cname = b"fl32", b"32-bit floating point"
            else:
                ctype, cname = b"NONE", b"not compressed"
            pname = bytes([len(cname)]) + cname
            if len(pname) & 1:
                pname += b"\x00"
            comm += ctype + pname
        body += b"COMM" + struct.pack(">I", len(comm)) + comm
        if self._id3:
            tag = self._id3
            body += b"ID3 " + struct.pack(">I", len(tag)) + tag
            if len(tag) & 1:
                body += b"\x00"
        ssnd_size = 8 + data_size
        body += b"SSND" + struct.pack(">I", ssnd_size) + struct.pack(">II", 0, 0)
        return body

    def _write_header(self, data_size: int) -> None:
        body = self._chunks(data_size)
        form_type = b"AIFC" if self.aifc else b"AIFF"
        total = min(4 + len(body) + data_size + (data_size & 1), 0xFFFFFFFF)
        self.f.write(b"FORM" + struct.pack(">I", total) + form_type)
        self.f.write(body)
        self._header_len = 8 + 4 + len(body)

    def write(self, samples: np.ndarray) -> None:
        """samples: (frames, channels) int32 (quantized) or float32."""
        payload = pack(samples, self.bit_depth, big_endian=True)
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
