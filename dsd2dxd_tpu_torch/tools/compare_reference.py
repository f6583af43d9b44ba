"""Tolerance comparison of outputs against a reference binary's outputs.

Counterpart of ``tools/compare_reference.py`` at the repository root, copied
whole, with the same verdicts, thresholds and exit code. Two changes: a
FLAC input is decoded by the port's own ``formats/flac_decode.decode_flac``
(so the tool runs where there is no jax), and a file that is not WAV or
AIFF/AIFC raises ValueError where the original asserted (an assert
vanishes under ``python -O``).

    python -m dsd2dxd_tpu_torch.tools.compare_reference REF_DIR OURS_DIR
    python -m dsd2dxd_tpu_torch.tools.compare_reference ref.wav ours.wav --bits 24
    python -m dsd2dxd_tpu_torch.tools.compare_reference a.raw b.raw --raw s24le --channels 2

Pairs files by relative path/stem, decodes WAV / AIFF / AIFC / FLAC /
raw PCM, aligns the two streams (searches a small lead/lag window — the
two implementations' filters have different group delays), and reports
per-file deltas in LSBs at the output bit depth:

    name  frames  offset  max_lsb  rms_lsb  verdict

Verdict thresholds: `bitexact` (max == 0), `dither-equiv` (rms <= 0.8
LSB: within TPDF dither energy — outputs differing only by dither
realization land here), else `DIFFERS`. Exit code 0 unless any pair
DIFFERS (or cannot be aligned).

The port's FLAC decoder is pure Python: a long high-rate FLAC takes
minutes. Self-diff smoke (tests/test_torch_tools.py): two runs of the
port's converter with different seeds must land `dither-equiv`; the same
file against itself must be `bitexact`.
"""

from __future__ import annotations

import argparse
import struct
import sys
from pathlib import Path

import numpy as np


def _read_wav(data: bytes):
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    payload = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4:pos + 8])
        body = data[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            tag, ch, rate = struct.unpack("<HHI", body[0:8])
            bits = struct.unpack("<H", body[14:16])[0]
            fmt = (tag, ch, rate, bits)
        elif cid == b"data":
            payload = body
        pos += 8 + size + (size & 1)
    tag, ch, rate, bits = fmt
    x = _decode_pcm(payload, bits, big_endian=False,
                    is_float=(tag == 3))
    return x.reshape(-1, ch), rate, bits if tag != 3 else 32


def _read_aiff(data: bytes):
    if data[:4] != b"FORM" or data[8:12] not in (b"AIFF", b"AIFC"):
        raise ValueError("not a FORM/AIFF or AIFC file")
    pos = 12
    ch = bits = None
    rate = 0
    payload = None
    is_float = False
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        (size,) = struct.unpack(">I", data[pos + 4:pos + 8])
        body = data[pos + 8:pos + 8 + size]
        if cid == b"COMM":
            ch, _nf, bits = struct.unpack(">HIH", body[0:8])
            exp = struct.unpack(">H", body[8:10])[0]
            mant = int.from_bytes(body[10:18], "big")
            rate = int(mant / (1 << 63) * 2 ** (exp - 16383)) if mant else 0
            if len(body) >= 22 and body[18:22] in (b"fl32", b"FL32"):
                is_float = True
        elif cid == b"SSND":
            payload = body[8:]  # offset+blocksize header
        pos += 8 + size + (size & 1)
    x = _decode_pcm(payload, bits, big_endian=True, is_float=is_float)
    return x.reshape(-1, ch), rate, 32 if is_float else bits


def _decode_pcm(payload: bytes, bits: int, big_endian: bool,
                is_float: bool) -> np.ndarray:
    if is_float:
        dt = ">f4" if big_endian else "<f4"
        return np.frombuffer(payload, dtype=dt).astype(np.float64)
    if bits == 16:
        dt = ">i2" if big_endian else "<i2"
        return np.frombuffer(payload, dtype=dt).astype(np.int64)
    if bits in (20, 24):
        b = np.frombuffer(payload, dtype=np.uint8)
        b = b[:len(b) - len(b) % 3].reshape(-1, 3)
        if big_endian:
            b = b[:, ::-1]
        v = (b[:, 0].astype(np.int64) | (b[:, 1].astype(np.int64) << 8)
             | (b[:, 2].astype(np.int64) << 16))
        v = np.where(v >= 1 << 23, v - (1 << 24), v)
        if bits == 20:
            v >>= 4  # 20-in-24 rides shifted left (containers/pack.py)
        return v
    if bits == 32:
        dt = ">i4" if big_endian else "<i4"
        return np.frombuffer(payload, dtype=dt).astype(np.int64)
    raise ValueError(f"unsupported bit depth {bits}")


_RAW_FMTS = {
    "s16le": (16, False, False), "s24le": (24, False, False),
    "s16be": (16, True, False), "s24be": (24, True, False),
    "f32le": (32, False, True),
}


def load(path: Path, raw: str | None, channels: int):
    """-> (samples (frames, ch) int64-or-float64, rate, bits)."""
    data = path.read_bytes()
    if raw:
        bits, be, is_f = _RAW_FMTS[raw]
        x = _decode_pcm(data, bits, be, is_f)
        return x.reshape(-1, channels), 0, 32 if is_f else bits
    if data[:4] == b"RIFF":
        return _read_wav(data)
    if data[:4] == b"FORM":
        return _read_aiff(data)
    if data[:4] == b"fLaC":
        from dsd2dxd_tpu_torch.formats.flac_decode import decode_flac

        st = decode_flac(data)
        return (st.samples.astype(np.int64), st.sample_rate,
                st.bits_per_sample)
    raise ValueError(f"{path}: unknown container (pass --raw for raw PCM)")


def align(a: np.ndarray, b: np.ndarray, max_shift: int):
    """Best lag of b relative to a (b[i+lag] ~ a[i]) by cross-correlation
    of channel 0 over a window; returns (lag, overlapping trimmed pair)."""
    n = min(len(a), len(b), 1 << 18)
    if n == 0:
        return 0, a[:0], b[:0]
    wa = a[:n, 0].astype(np.float64)
    wb = b[:n, 0].astype(np.float64)
    wa -= wa.mean()
    wb -= wb.mean()
    best_lag, best = 0, -np.inf
    for lag in range(-max_shift, max_shift + 1):
        if lag >= 0:
            c = float(np.dot(wa[:n - lag], wb[lag:n]))
        else:
            c = float(np.dot(wa[-lag:n], wb[:n + lag]))
        if c > best:
            best, best_lag = c, lag
    lag = best_lag
    if lag >= 0:
        m = min(len(a), len(b) - lag)
        return lag, a[:m], b[lag:lag + m]
    m = min(len(a) + lag, len(b))
    return lag, a[-lag:-lag + m], b[:m]


def compare_pair(ref: Path, ours: Path, raw: str | None, channels: int,
                 bits_override: int | None, max_shift: int):
    ra, rate_a, bits_a = load(ref, raw, channels)
    rb, rate_b, bits_b = load(ours, raw, channels)
    if rate_a and rate_b and rate_a != rate_b:
        return dict(name=ours.name, verdict="DIFFERS",
                    note=f"rate {rate_a} vs {rate_b}")
    if ra.shape[1] != rb.shape[1]:
        return dict(name=ours.name, verdict="DIFFERS",
                    note=f"channels {ra.shape[1]} vs {rb.shape[1]}")
    # Normalize BOTH sides into one LSB unit: --bits when given, else
    # the int side's depth for float-vs-int, else the deeper depth.
    # Float full scale 1.0 -> 2^(bits-1); an int in n-bit LSBs scales
    # by 2^(bits-n). (A float side compared against 16-bit int in
    # 24-bit units would be 256x off — the old code hardcoded 2^23.)
    if ra.dtype.kind == "f" and rb.dtype.kind == "f":
        bits = bits_override or 24
    elif ra.dtype.kind == "f":
        bits = bits_override or bits_b
    elif rb.dtype.kind == "f":
        bits = bits_override or bits_a
    else:
        bits = bits_override or max(bits_a, bits_b)

    def to_unit(x, nbits):
        if x.dtype.kind == "f":
            return x.astype(np.float64) * float(1 << (bits - 1))
        return x.astype(np.float64) * (2.0 ** (bits - nbits))

    a, b = to_unit(ra, bits_a), to_unit(rb, bits_b)
    lag, a, b = align(a, b, max_shift)
    if len(a) == 0:
        return dict(name=ours.name, verdict="DIFFERS", note="no overlap")
    # trim filter warmup/taildown: both converters ring in/out differently
    skip = min(len(a) // 8, 4096)
    d = (a - b)[skip:len(a) - skip if len(a) - skip > skip else len(a)]
    if d.size == 0:
        d = a - b
    max_lsb = float(np.abs(d).max())
    rms_lsb = float(np.sqrt(np.mean(d ** 2)))
    if max_lsb == 0.0:
        verdict = "bitexact"
    elif rms_lsb <= 0.8:
        verdict = "dither-equiv"
    else:
        verdict = "DIFFERS"
    return dict(name=ours.name, frames=len(a), offset=lag, bits=bits,
                max_lsb=max_lsb, rms_lsb=rms_lsb, verdict=verdict)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="compare_reference",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("reference", type=Path,
                    help="reference output file or directory")
    ap.add_argument("ours", type=Path, help="our output file or directory")
    ap.add_argument("--raw", choices=sorted(_RAW_FMTS),
                    help="inputs are headerless PCM in this format")
    ap.add_argument("--channels", type=int, default=2,
                    help="channel count for --raw inputs")
    ap.add_argument("--bits", type=int, default=None,
                    help="override LSB unit (e.g. 24 when comparing float "
                         "against int output)")
    ap.add_argument("--max-shift", type=int, default=8192,
                    help="alignment search window in frames (group-delay "
                         "differences between filter designs)")
    args = ap.parse_args(argv)

    if args.reference.is_dir():
        exts = ("*.wav", "*.aif", "*.aiff", "*.flac", "*.raw", "*.pcm")
        pairs = []
        for ref in sorted(p for e in exts for p in args.reference.rglob(e)):
            rel = ref.relative_to(args.reference)
            cand = args.ours / rel
            if not cand.exists():
                matches = list(args.ours.rglob(ref.stem + ".*"))
                cand = matches[0] if matches else None
            if cand:
                pairs.append((ref, cand))
            else:
                print(f"SKIP {rel}: no counterpart under {args.ours}")
    else:
        pairs = [(args.reference, args.ours)]

    failed = False
    print(f"{'name':<40} {'frames':>9} {'offset':>7} "
          f"{'max_lsb':>9} {'rms_lsb':>9}  verdict")
    for ref, ours in pairs:
        r = compare_pair(ref, ours, args.raw, args.channels, args.bits,
                         args.max_shift)
        if "note" in r:
            print(f"{r['name']:<40} {'-':>9} {'-':>7} {'-':>9} {'-':>9}  "
                  f"{r['verdict']} ({r['note']})")
        else:
            print(f"{r['name']:<40} {r['frames']:>9} {r['offset']:>7} "
                  f"{r['max_lsb']:>9.2f} {r['rms_lsb']:>9.3f}  {r['verdict']}")
        failed |= r["verdict"] == "DIFFERS"
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
