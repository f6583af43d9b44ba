"""The reference's FLAC reader: the port's encoder's streams and streams
built here by hand, one per kind of subframe, channel assignment and
header coding, decode to their samples, every one equal; the drain's
frame count agrees; a stream with a fault planted in it reads as not
sound, and so does a run of the test's FLAC cell with such a fault."""

from __future__ import annotations

import io

import numpy as np
import pytest

from benchmark import native
from benchmark.reference import containers

from .conftest import FLAC_CELL
from .test_benchmark_faults import run_cell

def flac_count(data: bytes, piece: int = 1 << 20) -> tuple:
    """The I/O child's count of a FLAC stream, fed in pieces of `piece`
    bytes: (frames, samples, bad frames, stray bytes)."""
    return native.flac_scan(np.frombuffer(data, dtype=np.uint8), piece)


# ---- the port's encoder ------------------------------------------------------


class Pipe(io.RawIOBase):
    """A stream that cannot seek, as a FIFO: the writer leaves STREAMINFO's
    total and MD5 at 0."""

    def __init__(self):
        self.buf = bytearray()

    def writable(self):
        return True

    def write(self, b):
        self.buf += b
        return len(b)

    def seekable(self):
        return False


def program(bits: int, channels: int, n: int, seed: int = 1) -> np.ndarray:
    """(n, C) int32 at `bits`: tones and noise, a constant stretch, a
    silent one, full scale at both ends and the two channels alike for a
    while (the encoder's side channels)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    top = 1 << (bits - 1)
    x = np.stack([np.sin(t * 0.003 * (c + 1)) * (top * 0.7)
                  + rng.integers(-300, 300, n) for c in range(channels)], 1)
    x = np.clip(x, -top, top - 1).astype(np.int32)
    x[9000:21000] = 5
    x[30000:31000] = 0
    x[40000:40100] = top - 1
    x[40100:40200] = -top
    if channels == 2:
        x[50000:70000, 1] = x[50000:70000, 0] + 3
    return x


def encode(x: np.ndarray, bits: int, rate: int = 88200,
           seekable: bool = True) -> bytes:
    from dsd2dxd_tpu_torch.containers.flac import FlacWriter

    f = io.BytesIO() if seekable else Pipe()
    w = FlacWriter(f, x.shape[1], rate, bits)
    for a in range(0, len(x), 11000):
        w.write(np.ascontiguousarray(x[a:a + 11000]))
    w.finalize()
    return bytes(f.getvalue() if seekable else f.buf)


@pytest.mark.parametrize("seekable", [True, False])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("bits", [16, 20, 24])
def test_the_ports_streams_decode_to_their_input(bits, channels, seekable):
    x = program(bits, channels, 80001)
    data = encode(x, bits, seekable=seekable)
    lay = containers.parse_flac(data[:4096])
    assert (lay.rate, lay.channels, lay.bits) == (88200, channels, bits)
    assert np.array_equal(containers.flac_samples(data, channels, len(x)),
                          x.T)
    frames = -(-len(x) // 8192)
    for piece in (1, 7, 4096, 1 << 20):
        assert flac_count(data, piece) == (frames, len(x), 0, 0)


# ---- streams built by hand -----------------------------------------------------


def crc8(data: bytes) -> int:
    c = 0
    for b in data:
        c ^= b
        for _ in range(8):
            c = ((c << 1) ^ 0x07 if c & 0x80 else c << 1) & 0xFF
    return c


def crc16(data: bytes) -> int:
    c = 0
    for b in data:
        c ^= b << 8
        for _ in range(8):
            c = ((c << 1) ^ 0x8005 if c & 0x8000 else c << 1) & 0xFFFF
    return c


class Bits:
    def __init__(self):
        self.s: list = []

    def put(self, v: int, n: int) -> None:
        self.s.append(format(v & ((1 << n) - 1), f"0{n}b") if n else "")

    def unary(self, q: int) -> None:
        self.s.append("0" * q + "1")

    def bytes(self) -> bytes:
        s = "".join(self.s)
        s += "0" * (-len(s) % 8)
        return int(s, 2).to_bytes(len(s) // 8, "big") if s else b""


FIXED = [[], [1], [2, -1], [3, -3, 1], [4, -6, 4, -1]]


def predict(x: list, coefs: list, shift: int) -> list:
    """Residuals of x under an order-len(coefs) predictor."""
    p = len(coefs)
    return [x[i] - (sum(c * x[i - 1 - j] for j, c in enumerate(coefs))
                    >> shift) for i in range(p, len(x))]


def residual(w: Bits, res: list, order: int, block: int, spec: dict):
    """Rice partitions: spec["method"] 0 (4-bit parameters) or 1 (5-bit),
    spec["porder"], spec["k"] a parameter per partition, or None for the
    escape with raw samples of spec["raw"] bits."""
    method, porder = spec.get("method", 0), spec.get("porder", 0)
    w.put(method, 2)
    w.put(porder, 4)
    psize = block >> porder
    i = 0
    for part in range(1 << porder):
        n = psize - (order if part == 0 else 0)
        k = spec["k"][part % len(spec["k"])]
        if k is None:
            w.put(15 if method == 0 else 31, 4 + method)
            w.put(spec["raw"], 5)
            for v in res[i:i + n]:
                w.put(v, spec["raw"])
        else:
            w.put(k, 4 + method)
            for v in res[i:i + n]:
                u = -2 * v - 1 if v < 0 else 2 * v
                w.unary(u >> k)
                w.put(u & ((1 << k) - 1), k)
        i += n


def subframe(w: Bits, x: list, bps: int, kind, spec: dict):
    """One subframe of the samples x at bps bits: kind "constant",
    "verbatim", ("fixed", order) or ("lpc", coefs, shift, precision);
    spec["wasted"] low bits that every sample lacks."""
    wasted = spec.get("wasted", 0)
    x = [v >> wasted for v in x]
    bps -= wasted
    w.put(0, 1)
    code = {"constant": 0, "verbatim": 1}.get(kind) if isinstance(
        kind, str) else (8 + kind[1] if kind[0] == "fixed"
                         else 31 + len(kind[1]))
    w.put(code, 6)
    if wasted:
        w.put(1, 1)
        w.unary(wasted - 1)
    else:
        w.put(0, 1)
    if kind == "constant":
        w.put(x[0], bps)
    elif kind == "verbatim":
        for v in x:
            w.put(v, bps)
    elif kind[0] == "fixed":
        order = kind[1]
        for v in x[:order]:
            w.put(v, bps)
        residual(w, predict(x, FIXED[order], 0), order, len(x), spec)
    else:
        _, coefs, shift, precision = kind
        for v in x[:len(coefs)]:
            w.put(v, bps)
        w.put(precision - 1, 4)
        w.put(shift, 5)
        for c in coefs:
            w.put(c, precision)
        residual(w, predict(x, coefs, shift), len(coefs), len(x), spec)


def utf8(v: int) -> bytes:
    if v < 0x80:
        return bytes([v])
    n = 2
    while v >= 1 << (5 * n + 1):
        n += 1
    out = []
    for _ in range(n - 1):
        out.append(0x80 | (v & 0x3F))
        v >>= 6
    lead = (0xFF << (8 - n)) & 0xFF
    return bytes([lead | v]) + bytes(reversed(out))


BLOCK_CODES = {192: 1, 576: 2, 1152: 3, 2304: 4, 4608: 5, 256: 8, 512: 9,
               1024: 10, 2048: 11, 4096: 12, 8192: 13, 16384: 14}
RATE_CODES = {88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5, 22050: 6,
              24000: 7, 32000: 8, 44100: 9, 48000: 10, 96000: 11}
SIZE_CODES = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}


def frame(number: int, chans: list, bits: int, rate: int, assign: int,
          kinds: list, spec: dict, variable: bool = False,
          block_coding: str = "table", rate_coding: str = "table",
          size_coding: str = "table") -> bytes:
    """One frame of the (C, block) samples `chans`: assign 0-7 independent,
    8 left/side, 9 side/right, 10 mid/side."""
    block = len(chans[0])
    extra = b""
    if block_coding == "table":
        bs = BLOCK_CODES[block]
    elif block_coding == "8bit":
        bs, extra = 6, bytes([block - 1])
    else:
        bs, extra = 7, (block - 1).to_bytes(2, "big")
    if rate_coding == "table":
        sr = RATE_CODES[rate]
    elif rate_coding == "streaminfo":
        sr = 0
    elif rate_coding == "khz":
        sr, extra = 12, extra + bytes([rate // 1000])
    elif rate_coding == "hz":
        sr, extra = 13, extra + rate.to_bytes(2, "big")
    else:
        sr, extra = 14, extra + (rate // 10).to_bytes(2, "big")
    ss = 0 if size_coding == "streaminfo" else SIZE_CODES[bits]
    head = bytes([0xFF, 0xF8 | int(variable), bs << 4 | sr,
                  assign << 4 | ss << 1]) + utf8(number) + extra
    head += bytes([crc8(head)])
    a, b = (chans + [None])[:2]
    if assign == 8:
        subs = [(a, bits), ([x - y for x, y in zip(a, b)], bits + 1)]
    elif assign == 9:
        subs = [([x - y for x, y in zip(a, b)], bits + 1), (b, bits)]
    elif assign == 10:
        subs = [([(x + y) >> 1 for x, y in zip(a, b)], bits),
                ([x - y for x, y in zip(a, b)], bits + 1)]
    else:
        subs = [(c, bits) for c in chans]
    w = Bits()
    for (x, bps), kind in zip(subs, kinds):
        subframe(w, x, bps, kind, spec)
    body = head + w.bytes()
    return body + crc16(body).to_bytes(2, "big")


def streaminfo(block: int, rate: int, channels: int, bits: int,
               total: int) -> bytes:
    v = (rate << 44) | ((channels - 1) << 41) | ((bits - 1) << 36) | total
    body = (block.to_bytes(2, "big") * 2 + bytes(6) + v.to_bytes(8, "big")
            + bytes(16))
    return b"fLaC" + bytes([0x80]) + len(body).to_bytes(3, "big") + body


def signal(n: int, bits: int, seed: int, channels: int = 2) -> list:
    rng = np.random.default_rng(seed)
    top = 1 << (bits - 1)
    t = np.arange(n)
    return [[int(v) for v in np.clip(
        np.round(np.sin(t * 0.05 * (c + 1)) * top * 0.6
                 + rng.integers(-40, 40, n)), -top, top - 1)]
            for c in range(channels)]


# each case: (bits, rate, block, the frames' (assign, kinds, spec,
# codings)); the stream's channels follow from assign
CASES = {
    "mono-every-subframe": (16, 44100, 1152, 1, [
        (0, ["constant"], {}, {}),
        (0, ["verbatim"], {}, {}),
        (0, [("fixed", 0)], {"k": [9]}, {}),
        (0, [("fixed", 1)], {"k": [7], "porder": 2}, {}),
        (0, [("fixed", 2)], {"k": [6, 8], "porder": 3}, {}),
        (0, [("fixed", 3)], {"k": [8], "method": 1}, {}),
        (0, [("fixed", 4)], {"k": [10, None], "porder": 1, "raw": 17}, {}),
        (0, [("lpc", [3, -2], 1, 5)], {"k": [9]}, {}),
        (0, [("lpc", [1200, -700, 250, 40, -9, 3, 1, -1], 9, 12)],
         {"k": [None], "method": 1, "raw": 20}, {}),
        (0, [("fixed", 2)], {"k": [4], "wasted": 3}, {}),
        (0, ["verbatim"], {"wasted": 1},
         {"block": 100, "block_coding": "8bit"}),
    ]),
    "stereo-24-every-assignment": (24, 96000, 4608, 2, [
        (1, ["verbatim", ("fixed", 2)], {"k": [13]}, {}),
        (8, [("fixed", 1), ("fixed", 2)], {"k": [14]}, {}),
        (9, [("lpc", [2, -1], 0, 4), "verbatim"], {"k": [15], "method": 1},
         {}),
        (10, [("fixed", 2), ("lpc", [5, -3, 1], 2, 6)],
         {"k": [12, 16], "method": 1, "porder": 2}, {}),
        (10, ["constant", "constant"], {},
         {"block": 4000, "block_coding": "16bit"}),
    ]),
    "stereo-20-header-codings": (20, 88200, 256, 2, [
        (8, [("fixed", 1), "verbatim"], {"k": [11]},
         {"block_coding": "8bit", "rate_coding": "streaminfo"}),
        (9, ["verbatim", ("fixed", 1)], {"k": [11]},
         {"block_coding": "16bit", "size_coding": "streaminfo"}),
        (10, [("fixed", 3), ("fixed", 0)], {"k": [11]},
         {"rate_coding": "hz10"}),
        (1, ["verbatim", "verbatim"], {}, {}),
    ]),
    "many-short-frames": (12, 32000, 16, 1, [
        (0, ["verbatim"], {}, {"block_coding": "8bit", "rate_coding": "khz"}),
    ] * 140),
    "variable-blocks": (16, 48000, 300, 1, [
        (0, [("fixed", 2)], {"k": [6]}, {"block": 300, "variable": True,
                                         "block_coding": "16bit"}),
        (0, ["verbatim"], {}, {"block": 100, "variable": True,
                               "block_coding": "8bit"}),
        (0, [("fixed", 1)], {"k": [6]}, {"block": 256, "variable": True}),
    ]),
}


def build(case: str) -> tuple[bytes, np.ndarray]:
    bits, rate, block, channels, frames = CASES[case]
    out, pos, chans = [], 0, [[] for _ in range(channels)]
    for k, (assign, kinds, spec, codings) in enumerate(frames):
        n = codings.get("block", block)
        variable = codings.get("variable", False)
        x = signal(n, bits, 100 + k, channels)
        if any(k == "constant" for k in kinds):
            x = [[c[0]] * n for c in x]
        wasted = spec.get("wasted", 0)
        x = [[(v >> wasted) << wasted for v in c] for c in x]
        out.append(frame(pos if variable else k, x, bits, rate, assign, kinds,
                         spec, variable,
                         **{k: v for k, v in codings.items()
                            if k.endswith("coding")}))
        for c in range(channels):
            chans[c] += x[c]
        pos += n
    return (streaminfo(block, rate, channels, bits, pos) + b"".join(out),
            np.array(chans, dtype=np.int32))


@pytest.mark.parametrize("case", sorted(CASES))
def test_hand_built_streams_decode(case):
    data, want = build(case)
    lay = containers.parse_flac(data)
    assert lay.bits == CASES[case][0] and lay.channels == want.shape[0]
    got = containers.flac_samples(data, want.shape[0], want.shape[1])
    assert np.array_equal(got, want)
    n_frames = len(CASES[case][4])
    assert flac_count(data, 5) == (n_frames, want.shape[1], 0, 0)


# ---- faults planted in a stream ----------------------------------------------


def sound_stream():
    x = program(20, 2, 60000)
    return encode(x, 20, seekable=False), x


@pytest.mark.parametrize("at", [0.1, 0.5, 0.93])
def test_a_flipped_bit_reads_not_sound(at):
    data, x = sound_stream()
    bad = bytearray(data)
    i = 42 + int((len(data) - 42) * at)
    bad[i] ^= 0x10
    with pytest.raises(ValueError, match="FLAC"):
        containers.flac_samples(bytes(bad), 2, len(x))
    frames, samples, n_bad, stray = flac_count(bytes(bad))
    assert n_bad + stray > 0 and samples < len(x)


@pytest.mark.parametrize("cut", [1, 2, 3000, 50000])
def test_a_truncated_stream_reads_not_sound(cut):
    data, x = sound_stream()
    with pytest.raises(ValueError, match="FLAC"):
        containers.flac_samples(data[:-cut], 2, len(x))
    assert flac_count(data[:-cut])[1] < len(x)


def test_a_streaminfo_with_the_wrong_rate_reads_not_sound():
    data, x = sound_stream()
    bad = bytearray(data)
    v = int.from_bytes(bad[18:26], "big")
    v = (v & ((1 << 44) - 1)) | (96000 << 44)
    bad[18:26] = v.to_bytes(8, "big")
    assert containers.parse_flac(bytes(bad)).rate == 96000
    with pytest.raises(ValueError, match="disagrees with STREAMINFO"):
        containers.flac_samples(bytes(bad), 2, len(x))
    assert flac_count(bytes(bad))[:2] == (0, 0)


def test_a_stream_with_too_many_or_too_few_samples_reads_not_sound():
    data, x = sound_stream()
    with pytest.raises(ValueError, match="expected"):
        containers.flac_samples(data, 2, len(x) - 1)
    with pytest.raises(ValueError, match="expected"):
        containers.flac_samples(data, 2, len(x) + 1)


# ---- the test's FLAC cell end to end, on the CPU ----------------------------


def test_the_flac_cell_reads_correct(tiny, capsys):
    # the first lap holds the compared tracks: on a loaded CPU, the FLAC
    # encoder's set-up per track makes a lap take seconds
    line = run_cell(FLAC_CELL, tiny, capsys, seconds=12)
    assert line["correct"] is True, line["check"]
    assert line["failed"] == 0 and line["attempted"] >= 6


class Planted:
    """The output stream of the port's FLAC writer with a fault: "flip" a
    bit in the frames, "truncate" the last frames, "rate" STREAMINFO's
    rate changed."""

    def __init__(self, f, fault: str):
        self.f, self.fault, self.n = f, fault, 0

    def write(self, b):
        b = bytes(b)
        if self.fault == "rate" and self.n == 0:
            v = int.from_bytes(b[18:26], "big")
            v = (v & ((1 << 44) - 1)) | (48000 << 44)
            b = b[:18] + v.to_bytes(8, "big") + b[26:]
        elif self.fault == "flip" and self.n > 0 and len(b) > 64:
            b = b[:40] + bytes([b[40] ^ 0x04]) + b[41:]
        self.n += 1
        if self.fault == "truncate" and self.n > 1:
            return len(b)
        return self.f.write(b)

    def __getattr__(self, name):
        return getattr(self.f, name)


@pytest.mark.parametrize("fault", ["flip", "truncate", "rate"])
def test_a_planted_flac_fault_reads_not_correct(fault, tiny, capsys,
                                                monkeypatch):
    from dsd2dxd_tpu_torch.containers import flac

    init = flac.FlacWriter.__init__

    def planted(self, f, *args, **kwargs):
        init(self, Planted(f, fault), *args, **kwargs)

    monkeypatch.setattr(flac.FlacWriter, "__init__", planted)
    line = run_cell(FLAC_CELL, tiny, capsys, seconds=6)
    assert line["correct"] is False
    assert line["check"]["tracks_bad"]["value"] == line["attempted"]
