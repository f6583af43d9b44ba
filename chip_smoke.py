#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (dsd2dxd_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, one line each (kernel-vs-plain
one line per chain); any failed check exits non-zero:

1. env: Python, torch and CUDA versions, nvcc, the card (nvidia-smi).
2. build: compiles the fused decimation kernel (K1a-K1d) from csrc/ with
   nvcc.
3. kernel vs plain, two channels, three streamed tiles of the size the
   engine gives each input rate (4 MiB/ch at DSD64 ... 32 MiB/ch at
   DSD512), level -1.5 dB, the plain PyTorch version on the same inputs:
   - K1a's chains (E, X, D at DSD64 -> 352.8k, E at DSD128 -> 705.6k) at
     24-bit NONE and TPDF;
   - one or more chains per deeper class: ÷16 (E DSD64 -> 176.4k), ÷32
     (E and X DSD64 -> 88.2k), ÷64 (E and C DSD128 -> 88.2k, E DSD512 ->
     352.8k), ÷128 (E DSD256 -> 88.2k), each at 16, 20 and 24 bit with
     NONE and TPDF and at 32-bit float with NONE and FPD; RECT at 16, 20
     and 24 bit on the ÷16 chain.
   Limits: integer NONE within 5 LSB; TPDF/RECT with the same key within
   1 LSB and >= 99.9 % identical; TPDF error against the undithered
   y * 2^(b-1) with RMS 0.45-0.55 LSB (RECT 0.38-0.44), mean below
   0.01 LSB and other noise in every tile; peak within 1e-4; f32 NONE
   bit-equal; FPD within 1 ulp of y, error mean below 0.01 ulp, other
   noise in every tile.
   Then a partial final tile: a burst that ends at n_valid, the idle pad
   after it; the kernel's peak is the plain cascade's max over the first
   n_valid frames.
4. e2e, BASELINE config 1: a three-minute DSD64 stereo 1 kHz tone .dsf
   through the port's CLI to a 24-bit 352.8 kHz TPDF WAV; checks the WAV
   header, the frame count, the 1 kHz spectral peak and that the kernel
   (K1a) ran once per tile.
5. e2e, BASELINE config 2: the same three minutes as raw interleaved
   DSD64 (127 MB) on the CLI's stdin with `-f I -r 176400`, raw s24le on
   stdout; checks 180 x 176400 frames, the 1 kHz peak on both channels
   and one ÷16 launch (K1b) per tile.
6. e2e, deep chain: a three-minute DSD128 stereo .dsf (254 MB) to a
   20-bit 88.2 kHz TPDF WAV (÷64, config 3's chain and depth); checks the
   header, the frame count, the zero low 4 bits of every sample, the
   1 kHz peak and one K1c+K1d launch per tile.
7. timing: kernel and plain version per 16 MiB/ch stereo tile, CUDA
   events over 8 staged tiles, plain-kernel-kernel-plain, for K1a (÷8),
   ÷16, ÷64 and ÷128 at 24-bit TPDF and ÷64 at 20-bit TPDF (K1d).

Then the card's name and power limit, one JSON line on the kernels
(launches from the e2e phase that drives each mode; max_abs_err in LSB
of the output depth, absolute for f32), and the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import io
import json
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import wave
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DSD64_HZ = 2_822_400
SECONDS = 180
TOL_NONE_LSB = 5
TOL_DITHER_LSB = 1


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def phase(name: str, text: str) -> None:
    print(f"[{name}] {text}", flush=True)


# -- test signal: DSD tone files, written without the JAX package ------------

def dsm_tone(freq: float, n: int, rate: int, amplitude: float = 0.5):
    """MSB-first DSD bytes of a sine through a 2nd-order delta-sigma
    modulator (the same loop as the JAX package's ops/dsm.py)."""
    import numpy as np

    x = (amplitude * np.sin(2 * np.pi * freq * np.arange(n) / rate)).tolist()
    bits = bytearray(n)
    s1 = s2 = 0.0
    for i, v in enumerate(x):
        y = 1.0 if s2 >= 0.0 else -1.0
        bits[i] = y > 0
        s1 += 0.5 * (v - y)
        s2 += 0.5 * (s1 - y)
    return np.packbits(np.frombuffer(bytes(bits), dtype=np.uint8))


def tone_planes(rate: int, seconds: int):
    """(2, seconds * rate / 8) stereo 1 kHz tone: 0.1 s (100 periods)
    modulated once per channel and tiled seamlessly."""
    import numpy as np

    one = np.stack([dsm_tone(1000.0, rate // 10, rate) for _ in range(2)])
    return np.tile(one, (1, seconds * 10))


def write_dsf(path: Path, planes, rate: int, block: int = 4096) -> None:
    """A stereo DSF (Sony's format: LSB-first bits, 4096-byte blocks per
    channel), as dsd2dxd_tpu.formats.dsf.write_dsf writes it."""
    import numpy as np

    rev = np.array([int(f"{b:08b}"[::-1], 2) for b in range(256)], np.uint8)
    ch, nbytes = planes.shape
    nblocks = -(-nbytes // block)
    padded = np.zeros((ch, nblocks * block), dtype=np.uint8)
    padded[:, :nbytes] = rev[planes]
    data = padded.reshape(ch, nblocks, block).transpose(1, 0, 2).tobytes()
    with open(path, "wb") as f:
        f.write(b"DSD " + struct.pack("<QQQ", 28, 28 + 52 + 12 + len(data), 0))
        f.write(b"fmt " + struct.pack("<QIIIIIIQII", 52, 1, 0, ch, ch, rate,
                                      1, nbytes * 8, block, 0))
        f.write(b"data" + struct.pack("<Q", 12 + len(data)))
        f.write(data)


def fft_peak_hz(pcm, rate: int):
    """Frequency of the spectral peak of each channel of (n, C) samples."""
    import numpy as np

    spec = np.abs(np.fft.rfft(pcm.astype(np.float64), axis=0))
    return np.fft.rfftfreq(pcm.shape[0], 1 / rate)[spec.argmax(axis=0)]


def s24(raw, shift: int = 0):
    """Little-endian 24-bit samples -> int64, arithmetic-shifted right."""
    import numpy as np

    b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3).astype(np.int64)
    v = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
    return np.where(v >= 1 << 23, v - (1 << 24), v) >> shift


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a card")
    if not (ROOT / "dsd2dxd_tpu_torch" / "csrc").is_dir():
        fail(f"no dsd2dxd_tpu_torch package beside {Path(__file__).name}: "
             f"run it from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from dsd2dxd_tpu_torch import DitherType, DsdRate, FilterType, kernels
    from dsd2dxd_tpu_torch.cli.dsd2dxd import run as cli_run
    from dsd2dxd_tpu_torch.ops import fused, philox
    from dsd2dxd_tpu_torch.ops.plan import get_chain
    from dsd2dxd_tpu_torch.ops.resample import StepConfig
    from dsd2dxd_tpu_torch.pipeline import engine
    from dsd2dxd_tpu_torch.utils.device import card_label, toolchain_probe

    dev = torch.device("cuda", 0)
    label = card_label().splitlines()[0]
    E, X, C = FilterType.EQUIRIPPLE, FilterType.XLD, FilterType.CHEBYSHEV

    # 1. env ------------------------------------------------------------------
    probe = toolchain_probe()
    nvcc = kernels.find_nvcc()
    nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True,
                              text=True, timeout=120).stdout.strip()
    nvcc_ver = nvcc_ver.splitlines()[-1] if nvcc_ver else "?"
    phase("env", f"python {probe['python']} torch {probe['torch']} cuda "
          f"{probe['torch_cuda']} devices {probe['device_count']} nvcc "
          f"{nvcc} ({nvcc_ver}) triton {probe['triton']} card [{label}]")

    # 2. build ----------------------------------------------------------------
    t0 = time.perf_counter()
    kernels.load()
    build_s = time.perf_counter() - t0
    ptxas = sorted({ln.strip() for ln in kernels.BUILD_LOG.splitlines()
                    if "registers" in ln or "spill" in ln})
    phase("build", f"{build_s:.1f} s for {', '.join(kernels.SOURCES)} "
          f"(sm_90a, 11 epilogue instantiations); ptxas: "
          f"{' | '.join(ptxas) or 'cached'}")

    def decode(wire, bits):
        """Little-endian wire bytes on the card -> int64 samples at the
        depth (20-bit shifted back down) or f32."""
        if bits == 32:
            return wire.view(torch.float32)
        if bits == 16:
            return wire.view(torch.int16).to(torch.int64)
        b = wire.reshape(-1, 3).to(torch.int64)
        v = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        v = v - (v >= (1 << 23)).to(torch.int64) * (1 << 24)
        return v >> 4 if bits == 20 else v

    def engine_tile(chain, rate):
        return engine._tile_bytes_for(
            chain, engine._DEFAULT_TILE_TARGET * int(rate))

    # 3. kernel vs plain -----------------------------------------------------
    N, T, R, F = (DitherType.NONE, DitherType.TPDF, DitherType.RECTANGULAR,
                  DitherType.FPD)
    k1a_epilogues = [(24, N), (24, T)]
    all_epilogues = [(16, N), (16, T), (20, N), (20, T), (24, N), (24, T),
                     (32, N), (32, F)]
    cells = [
        ("E DSD64->352.8k", (E, DsdRate.DSD64, 352800), k1a_epilogues),
        ("X DSD64->352.8k", (X, DsdRate.DSD64, 352800), k1a_epilogues),
        ("D DSD64->352.8k", (FilterType.DSD2PCM, DsdRate.DSD64, 352800),
         k1a_epilogues),
        ("E DSD128->705.6k", (E, DsdRate.DSD128, 705600), k1a_epilogues),
        ("E DSD64->176.4k", (E, DsdRate.DSD64, 176400),
         all_epilogues + [(16, R), (20, R), (24, R)]),
        ("E DSD64->88.2k", (E, DsdRate.DSD64, 88200), all_epilogues),
        ("X DSD64->88.2k", (X, DsdRate.DSD64, 88200), all_epilogues),
        ("E DSD128->88.2k", (E, DsdRate.DSD128, 88200), all_epilogues),
        ("C DSD128->88.2k", (C, DsdRate.DSD128, 88200), all_epilogues),
        ("E DSD512->352.8k", (E, DsdRate.DSD512, 352800), all_epilogues),
        ("E DSD256->88.2k", (E, DsdRate.DSD256, 88200), all_epilogues),
    ]
    max_err = {"K1a": 0.0, "K1b": 0.0, "K1c": 0.0, "K1d": 0.0}
    rng = np.random.default_rng(2026)
    for name, key, epilogues in cells:
        chain = get_chain(*key)
        r = fused.decimation(chain)
        tile = engine_tile(chain, key[1])
        taps = [torch.tensor(np.asarray(s.taps, dtype=np.float32), device=dev)
                for s in chain]
        xs = [torch.from_numpy(rng.integers(0, 256, (2, tile), dtype=np.uint8)
                               ).to(dev) for _ in range(3)]
        steps = {ep: fused.make_fused_step(
            chain, StepConfig(channels=2, tile_bytes=tile, bit_depth=ep[0],
                              dither=ep[1], level_db=-1.5), dev)
            for ep in epilogues}
        gain = fused._gain32(StepConfig(channels=2, tile_bytes=tile,
                                        bit_depth=24, dither=N,
                                        level_db=-1.5))
        st = {ep: dict(diff=0.0, same=0, n=0, dpk=0.0, errs=[], noise=[])
              for ep in epilogues}
        h = fused.init_fused_halo(chain, 2, dev)
        for t, x in enumerate(xs):
            k64 = philox.tile_key(7, t)
            y = fused.fused_decim_cascade(x, h, taps, chain, gain)
            yf = y.T.reshape(-1)
            for (bits, dither), step in steps.items():
                s = st[(bits, dither)]
                cfg = StepConfig(channels=2, tile_bytes=tile, bit_depth=bits,
                                 dither=dither, level_db=-1.5)
                wk, pk, hk = step(x, h, k64)
                wr, pr = fused.decim_epilogue(y, k64, cfg)
                torch.cuda.synchronize()
                check(torch.equal(hk, x[:, tile - h.shape[1]:]),
                      f"{name}: new halo differs")
                qk, qr = decode(wk, bits), decode(wr, bits)
                s["diff"] = max(s["diff"], float((qk.double() - qr.double())
                                                 .abs().max()))
                s["same"] += int((qk == qr).sum())
                s["n"] += qk.numel()
                s["dpk"] = max(s["dpk"], abs(float(pk) - float(pr)))
                if dither is N:
                    continue
                if bits == 32:
                    ulp = ((yf.view(torch.int32) & 0x7F800000)
                           .view(torch.float32).double() * 2.0 ** -23)
                    live = ulp > 0
                    e = (qk.double() - yf.double())[live] / ulp[live]
                    check(bool((qk.double() - yf.double())[~live].eq(0).all()),
                          f"{name} FPD: dither on a zero or denormal sample")
                    check(float(e.abs().max()) <= 1.0,
                          f"{name} FPD: a sample moved more than 1 ulp")
                else:
                    f = yf.double() * float(1 << (bits - 1))
                    e = qk.double() - f
                    e = e[f.abs() < (1 << (bits - 1)) - 4]
                s["errs"].append(e)
                s["noise"].append(e[: 1 << 16].cpu())
            h = x[:, tile - h.shape[1]:].contiguous()
        parts = []
        for (bits, dither), s in st.items():
            tag = f"{bits}{'f' if bits == 32 else ''}{dither.name[0]}"
            frac = s["same"] / s["n"]
            modes = fused.kernel_modes(chain, bits)
            for m in modes:
                max_err[m] = max(max_err[m], s["diff"])
            if bits == 32:
                check(dither is F or s["diff"] == 0.0,
                      f"{name} {tag}: f32 NONE not bit-equal ({s['diff']})")
                check(s["diff"] <= 2 ** -22,
                      f"{name} {tag}: kernel vs plain {s['diff']}")
            elif dither is N:
                check(s["diff"] <= TOL_NONE_LSB,
                      f"{name} {tag}: kernel vs plain {s['diff']} LSB")
            else:
                check(s["diff"] <= TOL_DITHER_LSB,
                      f"{name} {tag}: kernel vs plain {s['diff']} LSB")
            check(dither is N or frac >= 0.999,
                  f"{name} {tag}: only {frac:.5f} identical")
            check(s["dpk"] <= 1e-4, f"{name} {tag}: peak differs by {s['dpk']}")
            text = f"{tag} d{s['diff']:g} {frac * 100:.3f}%"
            if dither is not N:
                e = torch.cat(s["errs"])
                rms = float(e.pow(2).mean().sqrt())
                mean = float(e.mean())
                lo, hi = ((0.38, 0.44) if dither is R
                          else (0.0, 1.0) if dither is F else (0.45, 0.55))
                if dither is not F:
                    check(lo < rms < hi, f"{name} {tag}: error RMS {rms}")
                check(abs(mean) < 0.01, f"{name} {tag}: error mean {mean}")
                nz = s["noise"]
                check(not torch.equal(nz[0], nz[1])
                      and not torch.equal(nz[1], nz[2]),
                      f"{name} {tag}: tiles share noise")
                text += f" rms {rms:.4f} mean {mean:+.5f}"
            parts.append(text)
        phase("kernel-vs-plain",
              f"{name} (÷{r}, {tile} B/ch tiles, block_out "
              f"{fused.block_out_for(chain)}): " + "; ".join(parts))

    # partial final tile: the peak leaves the idle pad's ringing out
    chain = get_chain(E, DsdRate.DSD64, 176400)
    tile = engine_tile(chain, DsdRate.DSD64)
    fb = fused.decimation(chain) // 8
    n_valid = tile // fb - 1000
    x = torch.full((2, tile), fused.IDLE_BYTE, dtype=torch.uint8, device=dev)
    x[:, (n_valid - 8) * fb:n_valid * fb] = 0xFF
    taps = [torch.tensor(np.asarray(s.taps, dtype=np.float32), device=dev)
            for s in chain]
    h = fused.init_fused_halo(chain, 2, dev)
    cfg = StepConfig(channels=2, tile_bytes=tile, bit_depth=24, dither=T,
                     level_db=0.0)
    _w, pk, _h = fused.make_fused_step(chain, cfg, dev)(x, h, 5, n_valid)
    y = fused.fused_decim_cascade(x, h, taps, chain, 1.0)
    torch.cuda.synchronize()
    masked, whole = float(y[:, :n_valid].abs().max()), float(y.abs().max())
    check(abs(float(pk) - masked) <= 1e-4,
          f"partial tile: kernel peak {float(pk)} vs valid-prefix {masked}")
    check(whole > float(pk) + 0.5, "partial tile: the pad did not ring")
    phase("kernel-vs-plain", f"partial final tile (÷16, n_valid {n_valid} of "
          f"{tile // fb} frames): kernel peak {float(pk):.6g} = plain "
          f"valid-prefix peak {masked:.6g}; whole fixed tile {whole:.6g}")

    tmp = Path(tempfile.mkdtemp(prefix="dsd2dxd_smoke_"))
    launches = {}
    try:
        planes64 = tone_planes(DSD64_HZ, SECONDS)
        n64 = planes64.shape[1]

        # 4. e2e, config 1 -----------------------------------------------------
        chain = get_chain(E, DsdRate.DSD64, 352800)
        src = tmp / "tone_dsd64_180s.dsf"
        write_dsf(src, planes64, DSD64_HZ)
        out_dir = tmp / "out"
        out_dir.mkdir()
        tile_bytes = engine_tile(chain, DsdRate.DSD64)
        n_tiles = -(-n64 // tile_bytes)
        fused.reset_launch_counts()
        t0 = time.perf_counter()
        rc = cli_run(["-o", "w", "-q", "-p", str(out_dir), str(src)])
        wall = time.perf_counter() - t0
        launches["K1a"] = fused.MODE_LAUNCHES["K1a"]
        check(rc == 0, f"CLI exited {rc}")
        check(launches["K1a"] == fused.KERNEL_LAUNCHES == n_tiles,
              f"K1a launched {launches['K1a']} times for {n_tiles} tiles")
        wav_path = out_dir / "tone_dsd64_180s.wav"
        with wave.open(str(wav_path)) as w:
            params = (w.getnchannels(), w.getsampwidth(), w.getframerate(),
                      w.getnframes())
            check(params == (2, 3, 352800, SECONDS * 352800),
                  f"WAV params {params}")
            w.setpos(SECONDS // 2 * 352800)
            pcm = s24(w.readframes(352800)).reshape(-1, 2)
        check(np.abs(pcm).max() > 1 << 20, "output is silent")
        peak_hz = fft_peak_hz(pcm, 352800)
        check(np.all(np.abs(peak_hz - 1000.0) < 2.0), f"FFT peak at {peak_hz} Hz")
        phase("e2e", f"config 1: CLI {SECONDS} s DSD64 stereo .dsf "
              f"({src.stat().st_size / 1e6:.1f} MB) -> 24-bit 352.8k TPDF WAV "
              f"({wav_path.stat().st_size / 1e6:.1f} MB) in {wall:.2f} s = "
              f"{SECONDS / wall:.1f} audio-s/s; {n_tiles} tiles of "
              f"{tile_bytes} B/ch, {launches['K1a']} K1a launches; FFT peak "
              f"{peak_hz.tolist()} Hz; card [{label}]")
        src.unlink()
        wav_path.unlink()

        # 5. e2e, config 2: raw interleaved DSD64 on stdin -> s24le on stdout
        chain = get_chain(E, DsdRate.DSD64, 176400)
        raw_in = tmp / "tone_dsd64_180s.dsd"
        raw_in.write_bytes(planes64.T.tobytes())
        raw_out = tmp / "out_176400.raw"
        tile_bytes = engine_tile(chain, DsdRate.DSD64)
        n_tiles = -(-n64 // tile_bytes)
        fused.reset_launch_counts()
        with open(raw_in, "rb") as fin, open(raw_out, "wb") as fout:
            saved = sys.stdin, sys.stdout
            sys.stdin, sys.stdout = io.TextIOWrapper(fin), io.TextIOWrapper(fout)
            try:
                t0 = time.perf_counter()
                rc = cli_run(["-f", "I", "-r", "176400", "-q"])
                sys.stdout.flush()
                wall = time.perf_counter() - t0
            finally:
                sys.stdin, sys.stdout = saved
        launches["K1b"] = fused.MODE_LAUNCHES["K1b"]
        check(rc == 0, f"CLI exited {rc}")
        check(launches["K1b"] == fused.KERNEL_LAUNCHES == n_tiles,
              f"K1b launched {launches['K1b']} times for {n_tiles} tiles")
        size = raw_out.stat().st_size
        check(size == SECONDS * 176400 * 2 * 3,
              f"stdout carried {size} bytes, not {SECONDS} x 176400 frames")
        with open(raw_out, "rb") as f:
            f.seek(SECONDS // 2 * 176400 * 6)
            pcm = s24(f.read(176400 * 6)).reshape(-1, 2)
        check(np.abs(pcm).max() > 1 << 20, "output is silent")
        peak_hz = fft_peak_hz(pcm, 176400)
        check(np.all(np.abs(peak_hz - 1000.0) < 2.0), f"FFT peak at {peak_hz} Hz")
        phase("e2e", f"config 2: CLI stdin `-f I -r 176400`, {SECONDS} s raw "
              f"interleaved DSD64 ({raw_in.stat().st_size / 1e6:.1f} MB) -> "
              f"s24le 176.4k on stdout ({size / 1e6:.1f} MB, "
              f"{size // 6} frames) in {wall:.2f} s = "
              f"{SECONDS / wall:.1f} audio-s/s; {n_tiles} tiles of "
              f"{tile_bytes} B/ch, {launches['K1b']} K1b launches; FFT peak "
              f"{peak_hz.tolist()} Hz; card [{label}]")
        raw_in.unlink()
        raw_out.unlink()
        del planes64

        # 6. e2e, deep chain: DSD128 .dsf -> 20-bit 88.2k TPDF WAV (÷64)
        hz128 = 2 * DSD64_HZ
        chain = get_chain(E, DsdRate.DSD128, 88200)
        planes128 = tone_planes(hz128, SECONDS)
        n128 = planes128.shape[1]
        src = tmp / "tone_dsd128_180s.dsf"
        write_dsf(src, planes128, hz128)
        del planes128
        tile_bytes = engine_tile(chain, DsdRate.DSD128)
        n_tiles = -(-n128 // tile_bytes)
        fused.reset_launch_counts()
        t0 = time.perf_counter()
        rc = cli_run(["-o", "w", "-b", "20", "-r", "88200", "-q", "-p",
                      str(out_dir), str(src)])
        wall = time.perf_counter() - t0
        launches["K1c"] = fused.MODE_LAUNCHES["K1c"]
        launches["K1d"] = fused.MODE_LAUNCHES["K1d"]
        check(rc == 0, f"CLI exited {rc}")
        check(launches["K1c"] == launches["K1d"] == fused.KERNEL_LAUNCHES
              == n_tiles, f"K1c/K1d launched {launches['K1c']}/"
              f"{launches['K1d']} times for {n_tiles} tiles")
        wav_path = out_dir / "tone_dsd128_180s.wav"
        with wave.open(str(wav_path)) as w:
            params = (w.getnchannels(), w.getsampwidth(), w.getframerate(),
                      w.getnframes())
            check(params == (2, 3, 88200, SECONDS * 88200),
                  f"WAV params {params}")
            data = w.readframes(w.getnframes())
        low = np.frombuffer(data, dtype=np.uint8)[0::3]
        check(not np.any(low & 0x0F), "20-bit samples with low bits set")
        mid = SECONDS // 2 * 88200 * 6
        pcm = s24(data[mid:mid + 88200 * 6], 4).reshape(-1, 2)
        check(np.abs(pcm).max() > 1 << 16, "output is silent")
        peak_hz = fft_peak_hz(pcm, 88200)
        check(np.all(np.abs(peak_hz - 1000.0) < 2.0), f"FFT peak at {peak_hz} Hz")
        phase("e2e", f"deep: CLI {SECONDS} s DSD128 stereo .dsf "
              f"({src.stat().st_size / 1e6:.1f} MB) -> 20-bit 88.2k TPDF WAV "
              f"({wav_path.stat().st_size / 1e6:.1f} MB, low 4 bits zero) in "
              f"{wall:.2f} s = {SECONDS / wall:.1f} audio-s/s; {n_tiles} "
              f"tiles of {tile_bytes} B/ch, {launches['K1c']} K1c+K1d "
              f"launches; FFT peak {peak_hz.tolist()} Hz; card [{label}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 7. timing at bench.py's tile --------------------------------------------
    tile = 16 * 1024 * 1024
    xs = [torch.from_numpy(rng.integers(0, 256, (2, tile), dtype=np.uint8)
                           ).to(dev) for _ in range(8)]

    def per_tile_ms(fn, chain) -> float:
        h = fused.init_fused_halo(chain, 2, dev)
        fn(xs[0], h, 0)  # warm
        torch.cuda.synchronize()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        for i, x in enumerate(xs):
            _w, _p, h = fn(x, h, philox.tile_key(11, i))
        ev1.record()
        torch.cuda.synchronize()
        return ev0.elapsed_time(ev1) / len(xs)

    timed = {}
    for mode, name, key, bits in [
            ("K1a", "÷8 E DSD64->352.8k 24-bit", (E, DsdRate.DSD64, 352800), 24),
            ("K1b", "÷16 E DSD64->176.4k 24-bit", (E, DsdRate.DSD64, 176400), 24),
            ("K1c", "÷64 E DSD128->88.2k 24-bit", (E, DsdRate.DSD128, 88200), 24),
            ("÷128", "÷128 E DSD256->88.2k 24-bit", (E, DsdRate.DSD256, 88200), 24),
            ("K1d", "÷64 E DSD128->88.2k 20-bit", (E, DsdRate.DSD128, 88200), 20)]:
        chain = get_chain(*key)
        cfg = StepConfig(channels=2, tile_bytes=tile, bit_depth=bits,
                         dither=T, level_db=0.0)
        step = fused.make_fused_step(chain, cfg, dev)
        taps = [torch.tensor(np.asarray(s.taps, dtype=np.float32), device=dev)
                for s in chain]

        def plain(x, h, k, _chain=chain, _cfg=cfg, _taps=taps):
            return fused.fused_decim_reference(x, h, k, _taps, _chain, _cfg)

        runs = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            runs[which].append(per_tile_ms(plain if which == "plain"
                                           else step, chain))
        k_ms = sum(runs["kernel"]) / 2
        p_ms = sum(runs["plain"]) / 2
        timed[mode] = (k_ms, p_ms)
        audio = tile * 8 / key[1].hz
        phase("timing", f"{name} TPDF, 16 MiB/ch stereo tile ({audio:.2f} s "
              f"audio): kernel {k_ms:.3f} ms ({audio / k_ms * 1e3:.0f} "
              f"audio-s/s, runs {runs['kernel']}), plain {p_ms:.3f} ms "
              f"({audio / p_ms * 1e3:.0f} audio-s/s, runs {runs['plain']}); "
              f"card [{label}]")

    check("jax" not in sys.modules, "jax was loaded")
    check(all(launches[m] > 0 for m in ("K1a", "K1b", "K1c", "K1d")),
          f"a kernel mode was not launched on its path: {launches}")
    source = "dsd2dxd_tpu_torch/csrc/fused_decim.cu"
    rows = [("K1a", "fused_decim (K1a: G=1 ÷8, 24-bit)",
             "dsd2dxd_tpu/ops/fused.py:287 (_build_kernel, G=1, 24-bit)"),
            ("K1b", "fused_decim (K1b: ÷16/÷32 word lanes)",
             "dsd2dxd_tpu/ops/fused.py:287 (_build_kernel, G=2/4 word lanes)"),
            ("K1c", "fused_decim (K1c: ÷64/÷128 à-trous tail)",
             "dsd2dxd_tpu/ops/fused.py:287 (_build_kernel, à-trous tail)"),
            ("K1d", "fused_decim (K1d: 16/20-bit, f32/FPD epilogues)",
             "dsd2dxd_tpu/ops/fused.py:287 (_build_kernel, epilogues)")]
    print(label)
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source, "replaces": rep,
        "launches": launches[m], "max_abs_err": max_err[m],
        "ms": timed[m][0], "plain_ms": timed[m][1]} for m, name, rep in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
