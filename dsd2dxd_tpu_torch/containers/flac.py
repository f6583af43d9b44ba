"""Streaming FLAC writer (OutputType::Flac — reference src/main.rs:207-214),
a copy of ``dsd2dxd_tpu/containers/flac.py`` on the port's own host
library, ID3 parser and errors.

The encode hot path lives in the native C++ library
(native/src/flac.cc — fixed + LPC prediction, Rice coding, MD5); this
module handles container assembly: the fLaC marker, STREAMINFO (patched
at finalize with total samples / frame-size stats / MD5), and a
VORBIS_COMMENT metadata block mapped from the source's ID3v2 tag
(reference copies tags "where possible", README.md:7).

Bit depths: 16/20/24 integer. FLAC has no float concept; the engine
rejects 32-bit float + FLAC up front (reference does the same —
SURVEY.md §2.2 FLAC row).
"""

from __future__ import annotations

import struct
import time
from typing import BinaryIO, Optional

import numpy as np

from dsd2dxd_tpu_torch.utils.errors import ConfigError
from dsd2dxd_tpu_torch.utils.trace import span


def _picture_body(pic) -> bytes:
    """FLAC PICTURE metadata body (type 6) from a decoded APIC frame.
    Width/height/depth/colors are 0 = unknown (we don't parse image
    headers; players read them from the image itself)."""
    mime = pic.mime.encode("ascii", "replace")
    desc = pic.description.encode("utf-8")
    body = struct.pack(">I", pic.pic_type)
    body += struct.pack(">I", len(mime)) + mime
    body += struct.pack(">I", len(desc)) + desc
    body += struct.pack(">IIII", 0, 0, 0, 0)
    body += struct.pack(">I", len(pic.data)) + pic.data
    return body


def _picture_block(body: bytes, is_last: bool) -> bytes:
    header = bytes([(0x80 if is_last else 0) | 6]) + len(body).to_bytes(3, "big")
    return header + body


def _vorbis_comment_block(comments: list[tuple[str, str]], is_last: bool) -> bytes:
    vendor = b"dsd2dxd_tpu"
    body = struct.pack("<I", len(vendor)) + vendor
    body += struct.pack("<I", len(comments))
    for key, value in comments:
        entry = f"{key}={value}".encode("utf-8")
        body += struct.pack("<I", len(entry)) + entry
    header = bytes([(0x80 if is_last else 0) | 4]) + len(body).to_bytes(3, "big")
    return header + body


class FlacWriter:
    # 8192-sample frames: interleaved A/B on tone/pink/mix/quiet/noise
    # at 24/352.8k measured never-larger output (tone −3%, mix −1.6%)
    # and +0.7-4.7% encode speed vs libFLAC's 4096 — per-frame overhead
    # halves while rice partitions (po<=6 -> 128 samples each) stay
    # adaptive. All our FLAC rates are >48 kHz, where the streamable
    # subset allows block sizes up to 16384 (16384 itself lost on tone:
    # +1.3% size).
    def __init__(self, f: BinaryIO, channels: int, sample_rate: int,
                 bit_depth: int, id3: Optional[bytes] = None,
                 block_size: int = 8192):
        if bit_depth not in (16, 20, 24):
            raise ConfigError(
                f"FLAC output supports 16/20/24-bit, not {bit_depth}")
        from dsd2dxd_tpu_torch.native.loader import load

        # built at first use; a failed g++ build raises ConfigError
        self._native = native = load()
        self.f = f
        self.channels = channels
        self.sample_rate = sample_rate
        self.bit_depth = bit_depth
        self._comments, self._pictures = self._map_id3(id3)
        # the encoder's seconds (flac_feed, flac_finish and their drains)
        # and the encoded frames' bytes written, metadata left out
        self.encode_s = 0.0
        self.bytes_written = 0
        self._enc = native.flac_new(sample_rate, channels, bit_depth,
                                    block_size)
        self._write_header()

    @staticmethod
    def _map_id3(id3: Optional[bytes]):
        if not id3:
            return [], []
        from dsd2dxd_tpu_torch.formats.id3 import (
            apic_pictures,
            id3_to_vorbis_comments,
            parse_id3,
        )

        tag = parse_id3(id3)
        if tag is None:
            return [], []
        return id3_to_vorbis_comments(tag), apic_pictures(tag)

    def _write_header(self) -> None:
        # FLAC metadata blocks carry a 24-bit length: a picture whose
        # block body exceeds 2^24-1 bytes physically cannot be stored —
        # drop it with a warning instead of crashing the conversion
        # (the audio matters more than oversized artwork).
        keep = []
        for pic in self._pictures:
            # measure the ENCODED body — a multi-byte (e.g. CJK) UTF-8
            # description can overflow the limit even when the Python
            # str lengths look small
            body = _picture_body(pic)
            if len(body) > 0xFFFFFF:
                from dsd2dxd_tpu_torch.utils.logging import get_logger

                get_logger().warning(
                    f"FLAC: embedded picture ({len(pic.data)} bytes) "
                    "exceeds the 16 MiB metadata-block limit; dropped")
            else:
                keep.append(body)
        self._pictures = keep
        extras = int(bool(self._comments)) + len(self._pictures)
        header = self._native.flac_header(self._enc, is_last=extras == 0)
        self.f.write(header)
        if self._comments:
            extras -= 1
            self.f.write(_vorbis_comment_block(self._comments,
                                               is_last=extras == 0))
        for body in self._pictures:
            extras -= 1
            self.f.write(_picture_block(body, is_last=extras == 0))
        self._header_len = 42

    def write(self, samples: np.ndarray) -> None:
        """samples: (frames, channels) int32, already quantized. 20-bit
        samples are the native 20-bit values (NOT shifted into 24-bit
        containers — FLAC carries bits-per-sample natively). The encode
        runs in the span ``dsd2dxd.drain.flac``."""
        self._write_encoded(self._native.flac_feed, samples)

    def _write_encoded(self, encode, *args) -> None:
        """encode(handle, *args), then its finished frames drained and
        written; the encode and the drain are timed and spanned."""
        with span("dsd2dxd.drain.flac"):
            t0 = time.perf_counter()
            encode(self._enc, *args)
            data = self._native.flac_drain(self._enc)
            self.encode_s += time.perf_counter() - t0
        if data:
            self.f.write(data)
            self.bytes_written += len(data)

    def finalize(self) -> None:
        try:
            self._write_encoded(self._native.flac_finish)
            if self.f.seekable():
                self.f.seek(0)
                header = self._native.flac_header(
                    self._enc,
                    is_last=not (self._comments or self._pictures))
                self.f.write(header)
            self.f.flush()
        finally:
            # free even when a write throws (disk full): the handle owns
            # the output buffer AND the persistent encode worker pool
            self.close()

    def close(self) -> None:
        """Idempotent: release the native encoder without touching the
        stream — the abort path for errors before/instead of finalize()."""
        if self._enc is not None:
            self._native.flac_free(self._enc)
            self._enc = None

    def __del__(self):  # safety net for library embedders
        try:
            self.close()
        except Exception:
            pass
