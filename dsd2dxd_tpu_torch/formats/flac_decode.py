"""Pure-Python FLAC decoder — the verification oracle for the native
encoder (a copy of ``dsd2dxd_tpu/formats/flac_decode.py``, so the port's
checks decode FLAC without the JAX package; nothing on the conversion
path uses it).

Supports what the encoder emits: fixed-blocksize streams, CONSTANT /
VERBATIM / FIXED / LPC subframes, partitioned Rice residuals (4- and
5-bit params incl. escapes), stereo decorrelation modes, CRC-8/CRC-16
verification, and the STREAMINFO MD5 check.
"""

from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass, field

import numpy as np


class BitReader:
    def __init__(self, data: bytes, pos_bytes: int = 0):
        self.data = data
        self.pos = pos_bytes * 8  # bit position

    def u(self, bits: int) -> int:
        v = 0
        p = self.pos
        d = self.data
        for _ in range(bits):
            v = (v << 1) | ((d[p >> 3] >> (7 - (p & 7))) & 1)
            p += 1
        self.pos = p
        return v

    def s(self, bits: int) -> int:
        v = self.u(bits)
        if v >= 1 << (bits - 1):
            v -= 1 << bits
        return v

    def unary(self) -> int:
        n = 0
        p = self.pos
        d = self.data
        while not (d[p >> 3] >> (7 - (p & 7))) & 1:
            n += 1
            p += 1
        self.pos = p + 1
        return n

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def byte_pos(self) -> int:
        return self.pos >> 3


@dataclass
class FlacStream:
    sample_rate: int
    channels: int
    bits_per_sample: int
    total_samples: int
    md5: bytes
    min_block: int
    max_block: int
    comments: dict = field(default_factory=dict)
    pictures: list = field(default_factory=list)  # (type, mime, desc, data)
    samples: np.ndarray = None  # (frames, channels) int32
    md5_ok: bool = False


def _rice_residual(br: BitReader, block_size: int, pred_order: int) -> list[int]:
    method = br.u(2)
    if method > 1:
        raise ValueError("unknown residual coding method")
    pbits = 5 if method else 4
    escbits = 31 if method else 15
    po = br.u(4)
    parts = 1 << po
    res: list[int] = []
    for p in range(parts):
        cnt = block_size // parts - (pred_order if p == 0 else 0)
        k = br.u(pbits)
        if k == escbits:
            raw_bits = br.u(5)
            for _ in range(cnt):
                res.append(br.s(raw_bits) if raw_bits else 0)
        else:
            for _ in range(cnt):
                q = br.unary()
                u = (q << k) | (br.u(k) if k else 0)
                res.append((u >> 1) ^ -(u & 1))  # un-zigzag
    return res


_FIXED_COEF = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


def _decode_subframe(br: BitReader, block_size: int, bps: int) -> np.ndarray:
    if br.u(1):
        raise ValueError("subframe padding bit set")
    ftype = br.u(6)
    wasted = 0
    if br.u(1):
        wasted = 1 + br.unary()
        bps -= wasted
    if ftype == 0:  # CONSTANT
        out = np.full(block_size, br.s(bps), dtype=np.int64)
    elif ftype == 1:  # VERBATIM
        out = np.array([br.s(bps) for _ in range(block_size)], dtype=np.int64)
    elif 8 <= ftype <= 12:  # FIXED
        order = ftype - 8
        warm = [br.s(bps) for _ in range(order)]
        res = _rice_residual(br, block_size, order)
        out = np.empty(block_size, dtype=np.int64)
        out[:order] = warm
        coef = _FIXED_COEF[order]
        for i in range(order, block_size):
            pred = sum(c * out[i - 1 - j] for j, c in enumerate(coef))
            out[i] = res[i - order] + pred
    elif ftype >= 32:  # LPC
        order = (ftype & 0x1F) + 1
        warm = [br.s(bps) for _ in range(order)]
        precision = br.u(4) + 1
        if precision == 16:
            raise ValueError("invalid LPC precision")
        shift = br.u(5)
        coef = [br.s(precision) for _ in range(order)]
        res = _rice_residual(br, block_size, order)
        out = np.empty(block_size, dtype=np.int64)
        out[:order] = warm
        for i in range(order, block_size):
            pred = 0
            for j in range(order):
                pred += coef[j] * int(out[i - 1 - j])
            out[i] = res[i - order] + (pred >> shift)
    else:
        raise ValueError(f"reserved subframe type {ftype}")
    if wasted:
        out = out << wasted
    return out


_BLOCK_SIZES = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
                8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
                13: 8192, 14: 16384, 15: 32768}
_RATES = {1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000, 6: 22050,
          7: 24000, 8: 32000, 9: 44100, 10: 48000, 11: 96000}
_SIZES = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}


def _crc8(d: bytes) -> int:
    c = 0
    for byte in d:
        c ^= byte
        for _ in range(8):
            c = ((c << 1) ^ 0x07) & 0xFF if c & 0x80 else (c << 1) & 0xFF
    return c


def _crc16(d: bytes) -> int:
    c = 0
    for byte in d:
        c ^= byte << 8
        for _ in range(8):
            c = ((c << 1) ^ 0x8005) & 0xFFFF if c & 0x8000 else (c << 1) & 0xFFFF
    return c


def _read_utf8(br: BitReader) -> int:
    first = br.u(8)
    if first < 0x80:
        return first
    n = 0
    mask = 0x40
    while first & mask:
        n += 1
        mask >>= 1
    val = first & (mask - 1)
    for _ in range(n):
        cont = br.u(8)
        if cont & 0xC0 != 0x80:
            raise ValueError("bad UTF-8 coded number")
        val = (val << 6) | (cont & 0x3F)
    return val


def _meta_u32(body: bytes, off: int, endian: str, block: str) -> int:
    """Bounds-checked u32 field read inside a metadata block body."""
    if off + 4 > len(body):
        raise ValueError(f"truncated {block} metadata block")
    return struct.unpack(endian + "I", body[off:off + 4])[0]


def decode_flac(data: bytes, check_crc: bool = True) -> FlacStream:
    if data[:4] != b"fLaC":
        raise ValueError("not a FLAC stream")
    pos = 4
    info = None
    comments: dict = {}
    pictures: list = []
    while True:
        hdr = data[pos:pos + 4]
        last = bool(hdr[0] & 0x80)
        btype = hdr[0] & 0x7F
        size = int.from_bytes(hdr[1:4], "big")
        body = data[pos + 4:pos + 4 + size]
        if btype == 0:  # STREAMINFO
            min_block, max_block = struct.unpack(">HH", body[0:4])
            packed = int.from_bytes(body[10:18], "big")
            rate = packed >> 44
            channels = ((packed >> 41) & 0x7) + 1
            bps = ((packed >> 36) & 0x1F) + 1
            total = packed & 0xFFFFFFFFF
            md5 = body[18:34]
            info = FlacStream(rate, channels, bps, total, md5,
                              min_block, max_block)
        elif btype == 4:  # VORBIS_COMMENT
            # bounds-checked reads: a truncated or lying block must raise
            # the decoder's ValueError contract, not struct.error
            off = 0
            vlen = _meta_u32(body, off, "<", "VORBIS_COMMENT")
            off += 4 + vlen
            n = _meta_u32(body, off, "<", "VORBIS_COMMENT")
            off += 4
            for _ in range(n):
                elen = _meta_u32(body, off, "<", "VORBIS_COMMENT")
                off += 4
                if off + elen > len(body):
                    raise ValueError("truncated VORBIS_COMMENT entry")
                k, _, v = body[off:off + elen].decode("utf-8").partition("=")
                comments[k.upper()] = v
                off += elen
        elif btype == 6:  # PICTURE
            off = 0
            ptype = _meta_u32(body, off, ">", "PICTURE"); off += 4
            mlen = _meta_u32(body, off, ">", "PICTURE"); off += 4
            if off + mlen > len(body):
                raise ValueError("PICTURE mime length exceeds block")
            mime = body[off:off + mlen].decode("ascii", "replace"); off += mlen
            dlen = _meta_u32(body, off, ">", "PICTURE"); off += 4
            if off + dlen > len(body):
                raise ValueError("PICTURE description length exceeds block")
            desc = body[off:off + dlen].decode("utf-8", "replace"); off += dlen
            off += 16  # width/height/depth/colors
            ilen = _meta_u32(body, off, ">", "PICTURE"); off += 4
            if off + ilen > len(body):
                raise ValueError("PICTURE image length exceeds block")
            pictures.append((ptype, mime, desc, body[off:off + ilen]))
        pos += 4 + size
        if last:
            break
    if info is None:
        raise ValueError("missing STREAMINFO")
    info.comments = comments
    info.pictures = pictures

    frames = []
    expect_index = 0
    decoded = 0  # running count: sum-per-iteration made the oracle O(n^2)
    while pos < len(data) and info.total_samples > decoded:
        br = BitReader(data, pos)
        if br.u(14) != 0x3FFE:
            raise ValueError(f"lost frame sync at byte {pos}")
        br.u(1)  # reserved
        br.u(1)  # blocking strategy
        bs_code = br.u(4)
        rate_code = br.u(4)
        assign = br.u(4)
        size_code = br.u(3)
        br.u(1)
        index = _read_utf8(br)
        if index != expect_index:
            raise ValueError(f"frame index {index} != {expect_index}")
        expect_index += 1
        if bs_code == 6:
            bs = br.u(8) + 1
        elif bs_code == 7:
            bs = br.u(16) + 1
        else:
            bs = _BLOCK_SIZES[bs_code]
        if rate_code == 12:
            br.u(8)
        elif rate_code in (13, 14):
            br.u(16)
        hdr_end = br.byte_pos()
        crc8_val = br.u(8)
        if check_crc and _crc8(data[pos:hdr_end]) != crc8_val:
            raise ValueError(f"frame {index}: header CRC-8 mismatch")
        bps = _SIZES[size_code] if size_code else info.bits_per_sample
        rate = _RATES.get(rate_code, info.sample_rate)
        assert rate == info.sample_rate

        if assign < 8:
            chans = [np.asarray(_decode_subframe(br, bs, bps))
                     for _ in range(assign + 1)]
        elif assign == 8:   # left/side
            left = _decode_subframe(br, bs, bps)
            side = _decode_subframe(br, bs, bps + 1)
            chans = [left, left - side]
        elif assign == 9:   # right/side
            side = _decode_subframe(br, bs, bps + 1)
            right = _decode_subframe(br, bs, bps)
            chans = [right + side, right]
        elif assign == 10:  # mid/side: mid=(l+r)>>1, side=l-r
            mid = _decode_subframe(br, bs, bps)
            side = _decode_subframe(br, bs, bps + 1)
            mid2 = (mid << 1) | (side & 1)
            left = (mid2 + side) >> 1
            right = (mid2 - side) >> 1
            chans = [left, right]
        else:
            raise ValueError(f"reserved channel assignment {assign}")
        br.align()
        frame_end = br.byte_pos()
        crc16_val = br.u(16)
        if check_crc and _crc16(data[pos:frame_end]) != crc16_val:
            raise ValueError(f"frame {index}: CRC-16 mismatch")
        pos = br.byte_pos()
        frames.append(np.stack(chans, axis=1))
        decoded += frames[-1].shape[0]

    samples = (np.concatenate(frames, axis=0) if frames
               else np.zeros((0, info.channels), dtype=np.int64))
    samples = samples[:info.total_samples]
    info.samples = samples.astype(np.int32)

    # MD5 over little-endian raw samples, ceil(bps/8) bytes each
    nbytes = (info.bits_per_sample + 7) // 8
    flat = info.samples.reshape(-1).astype("<i4").view(np.uint8).reshape(-1, 4)
    raw = flat[:, :nbytes].tobytes()
    info.md5_ok = hashlib.md5(raw).digest() == info.md5
    return info
