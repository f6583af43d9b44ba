#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (dsd2dxd_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, one line each (kernel-vs-plain
one line per chain); any failed check exits non-zero:

1. env: Python, torch and CUDA versions, nvcc, the card (nvidia-smi).
2. build: compiles csrc/fused_decim.cu (K1a-K1e), csrc/finish.cu (K2) and
   csrc/probes.cu (P1, P2) with one nvcc each, started together, and
   links them; prints every kernel's registers, spills and stack frame.
   Then K1 at each mode's chain and block: shared memory per block,
   resident blocks and warps per SM (cudaOccupancyMaxActiveBlocksPer
   Multiprocessor), registers and local bytes per thread
   (cudaFuncGetAttributes); ÷64 and ÷128 must keep 24 warps per SM.
3. kernel vs plain (K1a-K1d), two channels, three streamed tiles of the
   size the engine gives each input rate (4 MiB/ch at DSD64 ... 32 MiB/ch
   at DSD512), level -1.5 dB, the plain PyTorch version on the same inputs:
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
4. the 48k family, all 9 chains (E DSD64/128/256 -> 96k/192k/384k), two
   channels, three streamed tiles at the engine's tile:
   - K1e vs plain: the planar f32 head against fused_decim_cascade at
     gain 1, bit-equal;
   - tail precision: rational_tail (fp32 torch.matmul) on the heads' real
     output against a float64 numpy oracle of the same band, below 2e-6;
   - K2 vs plain on the tail's output, DSD64 -> 192k and DSD256 -> 96k at
     16/20/24-bit NONE/TPDF/RECT and f32 NONE/FPD, with the limits of 3;
   - the whole step (K1e, tail, K2 through make_rational_step) against its
     plain path: all 9 at 24-bit TPDF, 3 at f32 FPD, the same limits;
   - a partial final tile on DSD64 -> 192k: the peak is the plain
     valid-prefix peak.
5. e2e, BASELINE config 1: a three-minute DSD64 stereo 1 kHz tone .dsf
   through the port's CLI to a 24-bit 352.8 kHz TPDF WAV; checks the WAV
   header, the frame count, the 1 kHz spectral peak and that the kernel
   (K1a) ran once per tile.
6. e2e, integer 48k: the same .dsf to a 24-bit 96 kHz TPDF WAV (÷32 head,
   3008-tap tail); the same checks, one K1e and one K2 launch per tile.
7. e2e, BASELINE config 2: the same three minutes as raw interleaved
   DSD64 (127 MB) on the CLI's stdin with `-f I -r 176400`, raw s24le on
   stdout; checks 180 x 176400 frames, the 1 kHz peak on both channels
   and one ÷16 launch (K1b) per tile.
8. e2e, deep chain: a three-minute DSD128 stereo .dsf (254 MB) to a
   20-bit 88.2 kHz TPDF WAV (÷64, config 3's chain and depth); checks the
   header, the frame count, the zero low 4 bits of every sample, the
   1 kHz peak and one K1c+K1d launch per tile.
9. e2e, BASELINE config 4: a one-minute DSD256 stereo .dsf (169 MB)
   through the CLI with `-b 32 -o C -r 192000` (FPD by default); checks
   the AIFC `fl32` header, 60 x 192000 frames, the 1 kHz peak on both
   channels and one K1e and one K2 launch per tile. Then the same .dsf
   to a 24-bit 88.2 kHz TPDF WAV (÷128, K1c's deepest chain): the
   header, the frame count, the 1 kHz peak and one K1c launch per tile.
10. probes: the floor probes of K1 (dsd2dxd_tpu_torch/tools). Every P1
    mode (dmabench: noop, noflush, dma, halo0, contig, bspec) at each of
    K1's blocks against its plain version on 2 staged 16 MiB/ch stereo
    tiles, exact (noflush: each element of its shared output block is
    some block's); every P2 rung (floorstrip on synth_chain(0.0): dma,
    unpack, cas0a, cas0, quant, and full: K1 itself at the ladder's
    block_out) on 2 staged 16 MiB/ch tiles, dma, unpack, cas0a and cas0
    bit-equal, quant and full at TPDF with K1's limits. The one PyTorch
    call that computes each P1 mode where there is one (noop: a repeat of
    an arange; dma, halo0: a slice and a cast; contig, bspec: a view, a
    transpose and a cast) is held equal to the plain version, then timed
    beside it. Then both tools through their entry points at 16 MiB/ch
    stereo, 8 staged tiles (268 MB, more than the 50 MB L2), with their
    launch counts read around each run.
11. timing: kernel and plain version per 16 MiB/ch stereo tile, CUDA
    events over 8 staged tiles, plain-kernel-kernel-plain, for K1a (÷8),
    ÷16, ÷64 and ÷128 at 24-bit TPDF and ÷64 at 20-bit TPDF (K1d); for
    the 48k family, one 16.08 MiB/ch tile (the engine's unit-aligned
    tile) of DSD64 -> 192k and of DSD256 -> 96k: K1e against the plain
    head, the tail alone, K2 against the plain finish (24-bit TPDF and
    f32 FPD), and the whole step against its plain path.

Each phase line ends with the seconds since the start. At the end it
checks that neither jax nor any module of the JAX package (dsd2dxd_tpu)
was loaded. Then the card's name and power limit, one JSON line on the
kernels (K1's ÷128 chain a row of its own; launches from the e2e phase
or tool run that drives each;
max_abs_err in LSB of the output depth, absolute for f32; bound_ms the
larger of the bytes over 3.35 TB/s and the f32 operations over 67
TFLOP/s, from this run's inputs; library_ms the one PyTorch call of the
same function where there is one, P1's noop, dma, halo0, contig and bspec,
else null), and the last line {"ok": true,
"device": {...}}.
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
SECONDS_CONFIG4 = 60  # DSD256: 169 MB of .dsf for a minute
T_START = time.perf_counter()
TOL_NONE_LSB = 5
TOL_DITHER_LSB = 1
# an H100 SXM's published peaks: HBM3 bytes/s, f32 FLOP/s outside the
# tensor cores (the least time for a kernel's work: bound())
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def phase(name: str, text: str) -> None:
    print(f"[{name}] {text} (+{time.perf_counter() - T_START:.1f} s)",
          flush=True)


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


def read_aifc_f32(path: Path):
    """(channels, frames, sample size, compression type, (frames, C) f32
    samples) of an AIFC file of big-endian 32-bit floats."""
    import numpy as np

    data = path.read_bytes()
    check(data[:4] == b"FORM" and data[8:12] == b"AIFC",
          f"{path.name}: not an AIFC file")
    comm, ssnd, i = None, None, 12
    while i + 8 <= len(data):
        cid, size = data[i:i + 4], struct.unpack(">I", data[i + 4:i + 8])[0]
        if cid == b"COMM":
            comm = data[i + 8:i + 8 + size]
        elif cid == b"SSND":
            off = struct.unpack(">I", data[i + 8:i + 12])[0]
            ssnd = data[i + 16 + off:i + 8 + size]
        i += 8 + size + (size & 1)
    check(comm is not None and ssnd is not None,
          f"{path.name}: no COMM or SSND chunk")
    ch, frames, bits = struct.unpack(">hIh", comm[:8])
    pcm = np.frombuffer(ssnd, dtype=">f4").reshape(-1, ch)
    return ch, frames, bits, comm[18:22], pcm


def s24(raw, shift: int = 0):
    """Little-endian 24-bit samples -> int64, arithmetic-shifted right."""
    import numpy as np

    b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3).astype(np.int64)
    v = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
    return np.where(v >= 1 << 23, v - (1 << 24), v) >> shift


def bound(nbytes: float, flops: float):
    """(ms, "bytes" or "operations"): the least time the card could take
    to move `nbytes` (each input read once, each output written once) and
    do `flops` f32 operations."""
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    tf = flops / PEAK_F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def p1_library_call(x, mode: str, g, rows: int, n_blocks: int):
    """The one PyTorch call that computes P1's `mode` at the card's
    geometry (k_sub = B, H <= B: block i of row c stores words
    iB + H .. iB + H + B of its window, or of its slab row), or None where
    there is none: noflush's output is whichever block wrote each element
    last. Timed beside the kernel; the port never calls it."""
    import torch

    h, b = g.halo_words, g.block_words
    if mode == "noop":
        return torch.arange(g.k_sub, dtype=torch.float32,
                            device=x.device).repeat(rows, n_blocks)
    if mode == "dma":
        return x[:, h:].float()
    if mode == "halo0":
        return x[:, :n_blocks * b].float()
    if mode in ("contig", "bspec"):
        return x.view(n_blocks, rows, g.win)[:, :, h:].transpose(
            0, 1).float().reshape(rows, n_blocks * b)
    return None


def fir_flops(chain, frames: int, channels: int) -> int:
    """f32 operations of a ÷R cascade for `frames` output frames per
    channel: every stage's outputs per final frame times its taps, one
    product and one sum each."""
    r, cum, macs = 1, 1, 0
    for s in chain:
        r *= s.M
    for s in chain:
        cum *= s.M
        macs += s.n_taps * (r // cum)
    return 2 * macs * frames * channels


def ptxas_summary(log: str) -> str:
    """'kernel<template ints>: N regs, S spill, F stack' for every entry
    ptxas compiled, from nvcc's -Xptxas -v output."""
    import re

    out, name, stack = [], None, "?"
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(_Z(\d+)\w+)'", ln)
        if m:
            mangled, n = m.group(1), int(m.group(2))
            base = mangled[2 + len(m.group(2)):2 + len(m.group(2)) + n]
            args = re.findall(r"L[ib](\d+)E", mangled)
            name = f"{base}<{','.join(args)}>"
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      ln)
        if m and name:
            stack, spill = m.group(1), m.group(2)
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out.append(f"{name}: {m.group(1)} regs, {spill} spill, "
                       f"{stack} stack")
            name = None
    return "; ".join(out)


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
    from dsd2dxd_tpu_torch.ops import fused, philox, rational
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
    phase("build", f"{build_s:.1f} s for {', '.join(kernels.SOURCES)} "
          f"(one nvcc each, in parallel; sm_90a; fused_decim: one kernel, "
          f"its 11 epilogues and the K1e planar head chosen per launch, "
          f"finish: 11, probes: 6 P1 modes + 7 P2 rungs); ptxas: "
          f"{ptxas_summary(kernels.BUILD_LOG) or 'cached'}")
    occ_text = []
    for mode, key in (("K1a ÷8", (E, DsdRate.DSD64, 352800)),
                      ("K1b ÷16", (E, DsdRate.DSD64, 176400)),
                      ("K1b ÷32", (E, DsdRate.DSD64, 88200)),
                      ("K1c/K1d ÷64", (E, DsdRate.DSD128, 88200)),
                      ("K1c ÷128", (E, DsdRate.DSD256, 88200)),
                      ("K1e ÷16 head", (E, DsdRate.DSD64, 192000)),
                      ("K1e ÷128 head", (E, DsdRate.DSD256, 96000))):
        chain = get_chain(*key)
        head = chain[:rational.rational_plan(chain).n_head] \
            if "K1e" in mode else chain
        o = fused.kernel_occupancy(head)
        if mode in ("K1c/K1d ÷64", "K1c ÷128"):
            check(o["warps_per_sm"] >= 24,
                  f"K1 {mode}: {o['warps_per_sm']} warps per SM")
        occ_text.append(
            f"{mode} block_out {fused.block_out_for(head)}: "
            f"{o['smem_bytes'] / 1024:.1f} KB smem/block, "
            f"{o['blocks_per_sm']} blocks = {o['warps_per_sm']} warps/SM, "
            f"{o['regs']} regs, {o['local_bytes']} B local")
    phase("occupancy", "K1: " + "; ".join(occ_text))

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
    def new_stats():
        return dict(diff=0.0, same=0, n=0, dpk=0.0, errs=[], noise=[])

    def tile_stats(s, name, wk, pk, wr, pr, yf, bits, dither):
        """Fold one tile's kernel (wk, pk) against plain (wr, pr) wire
        bytes and peak into s; yf: the undithered gain-scaled samples,
        frame-interleaved."""
        qk, qr = decode(wk, bits), decode(wr, bits)
        s["diff"] = max(s["diff"], float((qk.double() - qr.double())
                                         .abs().max()))
        s["same"] += int((qk == qr).sum())
        s["n"] += qk.numel()
        s["dpk"] = max(s["dpk"], abs(float(pk) - float(pr)))
        if dither is N:
            return
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

    def verdict(name, bits, dither, s) -> str:
        """Check the limits on one epilogue's stats; its summary."""
        tag = f"{bits}{'f' if bits == 32 else ''}{dither.name[0]}"
        frac = s["same"] / s["n"]
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
            check(all(not torch.equal(a, b) for a, b in zip(nz, nz[1:])),
                  f"{name} {tag}: tiles share noise")
            text += f" rms {rms:.4f} mean {mean:+.5f}"
        return text

    max_err = {m: 0.0 for m in [*fused.MODE_LAUNCHES, "÷128"]}
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
        st = {ep: new_stats() for ep in epilogues}
        h = fused.init_fused_halo(chain, 2, dev)
        for t, x in enumerate(xs):
            k64 = philox.tile_key(7, t)
            y = fused.fused_decim_cascade(x, h, taps, chain, gain)
            yf = y.T.reshape(-1)
            for (bits, dither), step in steps.items():
                cfg = StepConfig(channels=2, tile_bytes=tile, bit_depth=bits,
                                 dither=dither, level_db=-1.5)
                wk, pk, hk = step(x, h, k64)
                wr, pr = fused.decim_epilogue(y, k64, cfg)
                torch.cuda.synchronize()
                check(torch.equal(hk, x[:, tile - h.shape[1]:]),
                      f"{name}: new halo differs")
                tile_stats(st[(bits, dither)], name, wk, pk, wr, pr, yf,
                           bits, dither)
            h = x[:, tile - h.shape[1]:].contiguous()
        parts = []
        for (bits, dither), s in st.items():
            for m in fused.kernel_modes(chain, bits) + (
                    ("÷128",) if r == 128 else ()):
                max_err[m] = max(max_err[m], s["diff"])
            parts.append(verdict(name, bits, dither, s))
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

    # 4. the 48k family: K1e, the tail, K2, the whole step ---------------------
    def tail_oracle(y, hist, band, nhist):
        """The ×160/147 band over the history and the head samples, in
        float64 numpy: (C, n * p_out / p_in)."""
        p = hist.shape[1]
        yp = np.concatenate([hist[:, p - nhist:], y], axis=1
                            ).astype(np.float64)
        win = np.lib.stride_tricks.sliding_window_view(
            yp, p + nhist, axis=1)[:, ::p]
        return (win @ band.T.astype(np.float64)).reshape(y.shape[0], -1)

    k2_chains = ("E DSD64->192k", "E DSD256->96k")
    fpd_chains = ("E DSD64->384k", "E DSD128->192k", "E DSD256->192k")
    k2_epilogues = [(16, N), (16, T), (16, R), (20, N), (20, T), (20, R),
                    (24, N), (24, T), (24, R), (32, N), (32, F)]
    tail_err = 0.0
    for rate in (DsdRate.DSD64, DsdRate.DSD128, DsdRate.DSD256):
        for out in (96000, 192000, 384000):
            name = f"E {rate.name}->{out // 1000}k"
            chain = get_chain(E, rate, out)
            rp = rational.rational_plan(chain)
            head = chain[:rp.n_head]
            tile = engine_tile(chain, rate)
            taps = [torch.tensor(np.asarray(s.taps, dtype=np.float32),
                                 device=dev) for s in head]
            coefs = fused.kernel_coefs(head, dev)
            band_t = torch.from_numpy(rp.band.T.copy()).to(dev)
            cfg0 = StepConfig(channels=2, tile_bytes=tile, bit_depth=24,
                              dither=T, level_db=-1.5)
            gain = fused._gain32(cfg0)
            step_eps = [(24, T)] + ([(32, F)] if name in fpd_chains else [])
            fin_eps = k2_epilogues if name in k2_chains else []
            steps = {ep: rational.make_rational_step(chain, StepConfig(
                channels=2, tile_bytes=tile, bit_depth=ep[0], dither=ep[1],
                level_db=-1.5), dev) for ep in step_eps}
            st_step = {ep: new_stats() for ep in step_eps}
            st_fin = {ep: new_stats() for ep in fin_eps}
            states = {ep: rational.init_rational_state(chain, 2, dev)
                      for ep in step_eps}
            halo, hist = rational.init_rational_state(chain, 2, dev)
            head_eq, err = True, 0.0
            for t in range(3):
                x = torch.from_numpy(rng.integers(0, 256, (2, tile),
                                                  dtype=np.uint8)).to(dev)
                k64 = philox.tile_key(8, t)
                yk = fused.fused_head_cuda(x, halo, coefs, head)
                yp = fused.fused_decim_cascade(x, halo, taps, head, 1.0)
                torch.cuda.synchronize()
                head_eq = head_eq and torch.equal(yk, yp)
                max_err["K1e"] = max(max_err["K1e"],
                                     float((yk - yp).abs().max()))
                z, new_hist = rational.rational_tail(yp, hist, band_t,
                                                     rp.nhist)
                if t == 1:
                    zo = tail_oracle(yk.cpu().numpy(), hist.cpu().numpy(),
                                     rp.band, rp.nhist)
                    err = float(np.abs(z.cpu().numpy() - zo).max())
                zf = (z * gain).T.reshape(-1)
                for (bits, dither) in fin_eps:
                    cfg = StepConfig(channels=2, tile_bytes=tile,
                                     bit_depth=bits, dither=dither,
                                     level_db=-1.5)
                    wk, pk = fused.finish_cuda(z, gain, k64, cfg)
                    wr, pr = fused.finish_reference(z, gain, k64, cfg)
                    torch.cuda.synchronize()
                    tile_stats(st_fin[(bits, dither)], f"{name} K2", wk, pk,
                               wr, pr, zf, bits, dither)
                for (bits, dither), step in steps.items():
                    cfg = StepConfig(channels=2, tile_bytes=tile,
                                     bit_depth=bits, dither=dither,
                                     level_db=-1.5)
                    wk, pk, states[(bits, dither)] = step(
                        x, states[(bits, dither)], k64)
                    wr, pr = fused.finish_reference(z, gain, k64, cfg)
                    torch.cuda.synchronize()
                    check(torch.equal(states[(bits, dither)][0],
                                      x[:, tile - halo.shape[1]:])
                          and torch.equal(states[(bits, dither)][1],
                                          new_hist),
                          f"{name}: the step's new state differs")
                    tile_stats(st_step[(bits, dither)], f"{name} step", wk,
                               pk, wr, pr, zf, bits, dither)
                halo, hist = x[:, tile - halo.shape[1]:].contiguous(), new_hist
            check(head_eq, f"{name}: K1e is not bit-equal to the plain head")
            check(err < 2e-6, f"{name}: tail {err} from the f64 oracle")
            tail_err = max(tail_err, err)
            n_base = tile * 8 // rp.r_head
            phase("K1e-vs-plain", f"{name} (÷{rp.r_head} head, {tile} B/ch "
                  f"tiles, {n_base} head frames/ch): bit-equal on 3 tiles; "
                  f"tail vs f64 oracle {err:.3g} (band {rp.band.shape}, "
                  f"nhist {rp.nhist})")
            if fin_eps:
                parts = [verdict(f"{name} K2", b, d, st_fin[(b, d)])
                         for b, d in fin_eps]
                max_err["K2"] = max([max_err["K2"]] + [
                    st_fin[ep]["diff"] for ep in fin_eps])
                phase("K2-vs-plain", f"{name} ({n_base * 160 // 147} final "
                      f"frames/ch): " + "; ".join(parts))
            parts = [verdict(f"{name} step", b, d, st_step[(b, d)])
                     for b, d in step_eps]
            phase("step-vs-plain", f"{name} (K1e + tail + K2 against the "
                  f"plain head, tail and finish): " + "; ".join(parts))

    # partial final tile on a 48k chain: the peak of the valid prefix
    chain = get_chain(E, DsdRate.DSD64, 192000)
    rp = rational.rational_plan(chain)
    tile = engine_tile(chain, DsdRate.DSD64)
    n_out = tile * 8 // rp.r_head * 160 // 147
    n_valid = n_out - 1000
    end = n_valid * 147 // 160 * rp.r_head // 8
    x = torch.full((2, tile), fused.IDLE_BYTE, dtype=torch.uint8, device=dev)
    x[:, end - 16:end] = 0xFF
    cfg = StepConfig(channels=2, tile_bytes=tile, bit_depth=24, dither=T,
                     level_db=0.0)
    state = rational.init_rational_state(chain, 2, dev)
    _w, pk, _s = rational.make_rational_step(chain, cfg, dev)(
        x, state, 5, n_valid)
    head = chain[:rp.n_head]
    taps = [torch.tensor(np.asarray(s.taps, dtype=np.float32), device=dev)
            for s in head]
    z, _h = rational.rational_tail(
        fused.fused_decim_cascade(x, state[0], taps, head, 1.0), state[1],
        torch.from_numpy(rp.band.T.copy()).to(dev), rp.nhist)
    torch.cuda.synchronize()
    masked, whole = float(z[:, :n_valid].abs().max()), float(z.abs().max())
    check(abs(float(pk) - masked) <= 1e-6,
          f"48k partial tile: kernel peak {float(pk)} vs valid-prefix "
          f"{masked}")
    check(whole > float(pk) + 0.1, "48k partial tile: the pad did not ring")
    phase("K2-vs-plain", f"partial final tile (DSD64->192k, n_valid "
          f"{n_valid} of {n_out} frames): step peak {float(pk):.6g} = plain "
          f"valid-prefix peak {masked:.6g}; whole fixed tile {whole:.6g}")

    tmp = Path(tempfile.mkdtemp(prefix="dsd2dxd_smoke_"))
    launches = {}
    try:
        planes64 = tone_planes(DSD64_HZ, SECONDS)
        n64 = planes64.shape[1]

        # 5. e2e, config 1 -----------------------------------------------------
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
        wav_path.unlink()

        # 6. e2e, integer 48k: the same .dsf -> 24-bit 96 kHz TPDF WAV -----
        chain = get_chain(E, DsdRate.DSD64, 96000)
        tile_bytes = engine_tile(chain, DsdRate.DSD64)
        n_tiles = -(-n64 // tile_bytes)
        fused.reset_launch_counts()
        t0 = time.perf_counter()
        rc = cli_run(["-o", "w", "-r", "96000", "-q", "-p", str(out_dir),
                      str(src)])
        wall = time.perf_counter() - t0
        k1e, k2 = fused.MODE_LAUNCHES["K1e"], fused.MODE_LAUNCHES["K2"]
        check(rc == 0, f"CLI exited {rc}")
        check(k1e == k2 == fused.KERNEL_LAUNCHES == n_tiles,
              f"K1e/K2 launched {k1e}/{k2} times for {n_tiles} tiles")
        wav_path = out_dir / "tone_dsd64_180s.wav"
        with wave.open(str(wav_path)) as w:
            params = (w.getnchannels(), w.getsampwidth(), w.getframerate(),
                      w.getnframes())
            check(params == (2, 3, 96000, SECONDS * 96000),
                  f"WAV params {params}")
            w.setpos(SECONDS // 2 * 96000)
            pcm = s24(w.readframes(96000)).reshape(-1, 2)
        check(np.abs(pcm).max() > 1 << 20, "output is silent")
        peak_hz = fft_peak_hz(pcm, 96000)
        check(np.all(np.abs(peak_hz - 1000.0) < 2.0), f"FFT peak at {peak_hz} Hz")
        phase("e2e", f"integer 48k: CLI {SECONDS} s DSD64 stereo .dsf -> "
              f"24-bit 96k TPDF WAV ({wav_path.stat().st_size / 1e6:.1f} MB) "
              f"in {wall:.2f} s = {SECONDS / wall:.1f} audio-s/s; {n_tiles} "
              f"tiles of {tile_bytes} B/ch, {k1e} K1e + {k2} K2 launches; "
              f"FFT peak {peak_hz.tolist()} Hz; card [{label}]")
        src.unlink()
        wav_path.unlink()

        # 7. e2e, config 2: raw interleaved DSD64 on stdin -> s24le on stdout
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

        # 8. e2e, deep chain: DSD128 .dsf -> 20-bit 88.2k TPDF WAV (÷64)
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
        src.unlink()
        wav_path.unlink()

        # 9. e2e, config 4: DSD256 .dsf -> 32-bit float AIFC at 192 kHz ----
        hz256 = 4 * DSD64_HZ
        sec = SECONDS_CONFIG4
        chain = get_chain(E, DsdRate.DSD256, 192000)
        planes256 = tone_planes(hz256, sec)
        n256 = planes256.shape[1]
        src = tmp / "tone_dsd256_60s.dsf"
        write_dsf(src, planes256, hz256)
        del planes256
        tile_bytes = engine_tile(chain, DsdRate.DSD256)
        n_tiles = -(-n256 // tile_bytes)
        fused.reset_launch_counts()
        t0 = time.perf_counter()
        rc = cli_run(["-b", "32", "-o", "C", "-r", "192000", "-q", "-p",
                      str(out_dir), str(src)])
        wall = time.perf_counter() - t0
        launches["K1e"] = fused.MODE_LAUNCHES["K1e"]
        launches["K2"] = fused.MODE_LAUNCHES["K2"]
        check(rc == 0, f"CLI exited {rc}")
        check(launches["K1e"] == launches["K2"] == fused.KERNEL_LAUNCHES
              == n_tiles, f"K1e/K2 launched {launches['K1e']}/"
              f"{launches['K2']} times for {n_tiles} tiles")
        aifc_path = out_dir / "tone_dsd256_60s.aifc"
        ch, frames, bits, ctype, pcm = read_aifc_f32(aifc_path)
        check((ch, frames, bits, ctype) == (2, sec * 192000, 32, b"fl32"),
              f"AIFC COMM {(ch, frames, bits, ctype)}")
        check(pcm.shape == (sec * 192000, 2), f"AIFC payload {pcm.shape}")
        mid = pcm[sec // 2 * 192000:(sec // 2 + 1) * 192000]
        check(bool(np.isfinite(pcm).all()), "non-finite float samples")
        check(np.abs(mid).max() > 0.25, "output is silent")
        peak_hz = fft_peak_hz(mid, 192000)
        check(np.all(np.abs(peak_hz - 1000.0) < 2.0), f"FFT peak at {peak_hz} Hz")
        phase("e2e", f"config 4: CLI `-b 32 -o C -r 192000`, {sec} s DSD256 "
              f"stereo .dsf ({src.stat().st_size / 1e6:.1f} MB) -> f32 FPD "
              f"AIFC ({aifc_path.stat().st_size / 1e6:.1f} MB, fl32, "
              f"{frames} frames) in {wall:.2f} s = {sec / wall:.1f} "
              f"audio-s/s; {n_tiles} tiles of {tile_bytes} B/ch, "
              f"{launches['K1e']} K1e + {launches['K2']} K2 launches; FFT "
              f"peak {peak_hz.tolist()} Hz; card [{label}]")
        aifc_path.unlink()

        # 9b. e2e, ÷128: the same DSD256 .dsf -> 24-bit 88.2 kHz TPDF WAV -
        chain = get_chain(E, DsdRate.DSD256, 88200)
        tile_bytes = engine_tile(chain, DsdRate.DSD256)
        n_tiles = -(-n256 // tile_bytes)
        fused.reset_launch_counts()
        t0 = time.perf_counter()
        rc = cli_run(["-o", "w", "-r", "88200", "-q", "-p", str(out_dir),
                      str(src)])
        wall = time.perf_counter() - t0
        launches["÷128"] = fused.MODE_LAUNCHES["K1c"]
        check(rc == 0, f"CLI exited {rc}")
        check(launches["÷128"] == fused.KERNEL_LAUNCHES == n_tiles,
              f"K1c (÷128) launched {launches['÷128']} times for {n_tiles} "
              f"tiles")
        wav_path = out_dir / "tone_dsd256_60s.wav"
        with wave.open(str(wav_path)) as w:
            params = (w.getnchannels(), w.getsampwidth(), w.getframerate(),
                      w.getnframes())
            check(params == (2, 3, 88200, sec * 88200), f"WAV params {params}")
            w.setpos(sec // 2 * 88200)
            pcm = s24(w.readframes(88200)).reshape(-1, 2)
        check(np.abs(pcm).max() > 1 << 20, "output is silent")
        peak_hz = fft_peak_hz(pcm, 88200)
        check(np.all(np.abs(peak_hz - 1000.0) < 2.0), f"FFT peak at {peak_hz} Hz")
        phase("e2e", f"÷128: CLI {sec} s DSD256 stereo .dsf -> 24-bit 88.2k "
              f"TPDF WAV ({wav_path.stat().st_size / 1e6:.1f} MB) in "
              f"{wall:.2f} s = {sec / wall:.1f} audio-s/s; {n_tiles} tiles "
              f"of {tile_bytes} B/ch, {launches['÷128']} K1c launches; FFT "
              f"peak {peak_hz.tolist()} Hz; card [{label}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 10. probes: P1 (dmabench) and P2 (floorstrip) ---------------------------
    from dsd2dxd_tpu_torch.tools import dmabench, floorstrip

    def ev_ms(fn, n) -> float:
        """Mean ms of fn(i), i < n, between two CUDA events (warmed)."""
        fn(0)
        torch.cuda.synchronize()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        for i in range(n):
            fn(i)
        ev1.record()
        torch.cuda.synchronize()
        return ev0.elapsed_time(ev1) / n

    tile16 = 16 * 1024 * 1024
    blocks = dmabench.k1_blocks()
    p1_err = {m: 0.0 for m in dmabench.KERNEL_MODES}
    for bb, hb in blocks:
        g = dmabench.geometry(bb, hb)
        n = tile16 // bb
        for _t in range(2):
            x = torch.from_numpy(rng.integers(
                0, 2 ** 32, (2, g.halo_words + n * g.block_words),
                dtype=np.uint32).view(np.int32)).to(dev)
            xr = dmabench.relayout(x, g, n)
            for mode in dmabench.KERNEL_MODES:
                src = xr if mode in ("contig", "bspec") else x
                k = dmabench.dma_probe_cuda(src, mode, g, 2, n)
                r = dmabench.dma_probe_reference(src, mode, g, 2, n)
                torch.cuda.synchronize()
                if mode == "noflush":
                    ok = bool((k.unsqueeze(1) == r).any(dim=1).all())
                    err = 0.0 if ok else float("inf")
                else:
                    ok = k.shape == r.shape and torch.equal(k, r)
                    err = (float((k - r).abs().max())
                           if k.shape == r.shape else float("inf"))
                check(ok, f"P1 {mode} at block {bb} B: kernel differs from "
                      f"its plain version ({err})")
                p1_err[mode] = max(p1_err[mode], err)
                lib = p1_library_call(src, mode, g, 2, n)
                check(lib is None or torch.equal(lib, r),
                      f"P1 {mode} at block {bb} B: the library call differs "
                      f"from the plain version")
            del x, xr, k, r, lib
    phase("probes", f"P1 vs plain: {len(dmabench.KERNEL_MODES)} modes x "
          f"K1's blocks {blocks} (B/ch, halo B), 2 tiles of 16 MiB/ch "
          f"stereo each: exact (noflush: every element of the shared block "
          f"is some block's); the library calls of noop, dma, halo0, "
          f"contig and bspec equal the plain version")

    chain_p, cfg_p, bo_p = floorstrip.probe_config(16)
    taps_p = [torch.tensor(np.asarray(s.taps, dtype=np.float32), device=dev)
              for s in chain_p]
    flat_p = torch.cat(taps_p)
    halo_p = fused.init_fused_halo(chain_p, 2, dev)
    p2_err = {r: 0.0 for r in floorstrip.KERNEL_RUNGS}
    q_errs, xs_p = [], []
    full_p = floorstrip.make_probe_step(chain_p, cfg_p, "full", dev, bo_p)
    full_st = new_stats()
    for t in range(2):
        x = torch.from_numpy(rng.integers(0, 256, (2, cfg_p.tile_bytes),
                                          dtype=np.uint8)).to(dev)
        xs_p.append(x)
        key = philox.tile_key(14, t)
        y = None
        for rung in floorstrip.KERNEL_RUNGS:
            ko, kp = floorstrip.probe_step_cuda(x, halo_p, flat_p, chain_p,
                                                cfg_p, rung, bo_p, key)
            ro, rp = floorstrip.probe_step_reference(x, halo_p, taps_p,
                                                     chain_p, cfg_p, rung,
                                                     bo_p, key)
            torch.cuda.synchronize()
            d = (ko.double() - ro.double()).abs()
            err = float(d.max())
            p2_err[rung] = max(p2_err[rung], err)
            if rung == "cas0":
                y = ro
            if rung == "quant":
                same = float((d == 0).double().mean())
                check(err <= TOL_DITHER_LSB and same >= 0.999,
                      f"P2 quant: {err} LSB, {same:.5f} identical")
                f = y.double() * 2.0 ** 23
                e = ko.double() - f
                q_errs.append(e[f.abs() < 2 ** 23 - 4])
            else:
                check(err == 0.0, f"P2 {rung}: kernel differs from its "
                      f"plain version by {err}")
            if kp is not None:
                check(float(kp) == float(rp), f"P2 {rung}: peak {float(kp)} "
                      f"vs {float(rp)}")
            del ko, ro, d
        wk, pk, hk = full_p(x, halo_p, key)
        wr, pr, _hr = fused.fused_decim_reference(x, halo_p, key, taps_p,
                                                  chain_p, cfg_p)
        torch.cuda.synchronize()
        check(torch.equal(hk, x[:, x.shape[1] - halo_p.shape[1]:]),
              "P2 full: new halo differs")
        tile_stats(full_st, "P2 full", wk, pk, wr, pr, y.T.reshape(-1), 24,
                   T)
        del wk, wr
        halo_p = x[:, x.shape[1] - halo_p.shape[1]:].contiguous()
    full_text = verdict("P2 full", 24, T, full_st)
    e = torch.cat(q_errs)
    q_rms, q_mean = float(e.pow(2).mean().sqrt()), float(e.mean())
    check(0.45 < q_rms < 0.55 and abs(q_mean) < 0.01,
          f"P2 quant TPDF error RMS {q_rms}, mean {q_mean}")
    del e, q_errs, y
    phase("probes", f"P2 vs plain on synth_chain(0.0) (÷64, block_out "
          f"{bo_p}), 2 tiles of {cfg_p.tile_bytes} B/ch stereo: dma, unpack, "
          f"cas0a, cas0 bit-equal (peaks too); quant 24-bit TPDF max "
          f"{p2_err['quant']:g} LSB, error RMS {q_rms:.4f} mean "
          f"{q_mean:+.5f}; full (K1 at block_out {bo_p}) vs "
          f"fused_decim_reference {full_text}")

    # the plain versions' times, per 16 MiB/ch stereo tile
    g2048 = dmabench.geometry(2048, dict(blocks)[2048])
    n2048 = tile16 // 2048
    xs1 = [torch.from_numpy(rng.integers(
        0, 2 ** 32, (2, g2048.halo_words + n2048 * g2048.block_words),
        dtype=np.uint32).view(np.int32)).to(dev) for _ in range(2)]
    xr1 = [dmabench.relayout(x, g2048, n2048) for x in xs1]
    p1_plain = {m: ev_ms(lambda i, m=m: dmabench.dma_probe_reference(
        xr1[i] if m in ("contig", "bspec") else xs1[i], m, g2048, 2, n2048),
        2) for m in dmabench.KERNEL_MODES}
    p1_lib = {m: ev_ms(lambda i, m=m: p1_library_call(
        xr1[i] if m in ("contig", "bspec") else xs1[i], m, g2048, 2, n2048),
        2) for m in ("noop", "dma", "halo0", "contig", "bspec")}
    del xs1, xr1
    p2_plain = {r: ev_ms(lambda i, r=r: floorstrip.probe_step_reference(
        xs_p[i], halo_p, taps_p, chain_p, cfg_p, r, bo_p, 7), 2)
        for r in floorstrip.KERNEL_RUNGS}
    del xs_p
    torch.cuda.empty_cache()

    # both tools through their entry points, the launch counts around each
    dmabench.reset_launch_counts()
    fused.reset_launch_counts()
    p1 = dmabench.main(["--tile-mib", "16", "--reps", "8"])
    p1_launches = dict(dmabench.LAUNCHES)
    check(all(p1_launches[m] > 0 for m in dmabench.KERNEL_MODES)
          and fused.KERNEL_LAUNCHES == 0,
          f"P1 modes not launched by dmabench: {p1_launches}")
    floorstrip.reset_launch_counts()
    fused.reset_launch_counts()
    p2 = floorstrip.main(["--tile-mib", "16", "--reps", "8"])
    p2_launches = dict(floorstrip.LAUNCHES)
    p2_full = fused.KERNEL_LAUNCHES
    check(all(p2_launches[r] > 0 for r in floorstrip.KERNEL_RUNGS)
          and p2_full > 0,
          f"P2 rungs not launched by floorstrip: {p2_launches}, full "
          f"{p2_full}")
    torch.cuda.empty_cache()
    p1_ms = {m: round(v, 4) for m, v in p1_plain.items()}
    p2_ms = {r: round(v, 4) for r, v in p2_plain.items()}
    phase("probes", f"timed through the entry points: dmabench launches "
          f"{p1_launches}; floorstrip launches {p2_launches} + {p2_full} K1 "
          f"(full); plain ms per 16 MiB/ch stereo tile: P1 at block 2048 B "
          f"{p1_ms}, P2 {p2_ms}; P1's library calls at block 2048 B "
          f"{ {m: round(v, 4) for m, v in p1_lib.items()} }; card [{label}]")

    probe_rows = []
    g = p1[2048]["geometry"]
    for m in dmabench.KERNEL_MODES:
        b_ms, b_by = bound(
            dmabench.bound_bytes(m, g, 2, p1[2048]["n_blocks"]), 0)
        probe_rows.append({
            "name": f"P1 dma_probe ({m}; block 2048 B/ch, halo "
                    f"{g.halo_words * 4} B)",
            "route": "cuda", "source": "dsd2dxd_tpu_torch/csrc/probes.cu",
            "replaces": "tools/dmabench.py:96 (_probe, pallas_call :181)",
            "launches": p1_launches[m], "max_abs_err": p1_err[m],
            "ms": p1[2048]["med_ms"][m], "plain_ms": p1_plain[m],
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": p1_lib.get(m)})
    t_out = p2["tile"] * 8 // fused.decimation(chain_p)
    h_p = fused.chain_halo_bytes(chain_p)
    for r in floorstrip.KERNEL_RUNGS:
        nbytes = 2 * (p2["tile"] + h_p) + 2 * t_out * 4
        flops = {"dma": 0, "unpack": 2 * t_out * 64,
                 "quant": fir_flops(chain_p, t_out, 2) + 4 * 2 * t_out}.get(
            r, fir_flops(chain_p, t_out, 2))
        b_ms, b_by = bound(nbytes, flops)
        probe_rows.append({
            "name": f"P2 probe_step ({r}; synth_chain(0.0), block_out "
                    f"{p2['block_out']})",
            "route": "cuda", "source": "dsd2dxd_tpu_torch/csrc/probes.cu",
            "replaces": "tools/floorstrip.py:46 (_probe_step, "
                        "pallas_call :226)",
            "launches": p2_launches[r], "max_abs_err": p2_err[r],
            "ms": p2["med_ms"][r], "plain_ms": p2_plain[r],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})

    # 11. timing at bench.py's tile -------------------------------------------
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

    timed, bounds = {}, {}
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
        frames = tile * 8 // fused.decimation(chain)
        bounds[mode] = bound(
            2 * (tile + fused.chain_halo_bytes(chain))
            + 2 * frames * (2 if bits == 16 else 3),
            fir_flops(chain, frames, 2) + 4 * 2 * frames)
        audio = tile * 8 / key[1].hz
        phase("timing", f"{name} TPDF, 16 MiB/ch stereo tile ({audio:.2f} s "
              f"audio): kernel {k_ms:.3f} ms ({audio / k_ms * 1e3:.0f} "
              f"audio-s/s, runs {runs['kernel']}), plain {p_ms:.3f} ms "
              f"({audio / p_ms * 1e3:.0f} audio-s/s, runs {runs['plain']}); "
              f"card [{label}]")

    del xs

    # the 48k family: K1e, the tail and K2 alone, and the whole step
    def alternate(plain_fn, kernel_fn, n):
        """(kernel ms, plain ms, runs): plain, kernel, kernel, plain."""
        runs = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            runs[which].append(ev_ms(plain_fn if which == "plain"
                                     else kernel_fn, n))
        return (sum(runs["kernel"]) / 2, sum(runs["plain"]) / 2, runs)

    for name, key in (("DSD64->192k", (E, DsdRate.DSD64, 192000)),
                      ("DSD256->96k", (E, DsdRate.DSD256, 96000))):
        chain = get_chain(*key)
        rp = rational.rational_plan(chain)
        head = chain[:rp.n_head]
        tile = engine._tile_bytes_for(chain, 16 * 1024 * 1024)
        n = 8
        xs = [torch.from_numpy(rng.integers(0, 256, (2, tile),
                                            dtype=np.uint8)).to(dev)
              for _ in range(n)]
        taps = [torch.tensor(np.asarray(s.taps, dtype=np.float32),
                             device=dev) for s in head]
        coefs = fused.kernel_coefs(head, dev)
        band_t = torch.from_numpy(rp.band.T.copy()).to(dev)
        halo, hist = rational.init_rational_state(chain, 2, dev)
        ys = [fused.fused_head_cuda(x, halo, coefs, head) for x in xs]
        zs = [rational.rational_tail(y, hist, band_t, rp.nhist)[0]
              for y in ys]
        keys = [philox.tile_key(12, i) for i in range(n)]
        head_k, head_p, head_runs = alternate(
            lambda i: fused.fused_decim_cascade(xs[i], halo, taps, head, 1.0),
            lambda i: fused.fused_head_cuda(xs[i], halo, coefs, head), n)
        tail_ms = (ev_ms(lambda i: rational.rational_tail(
            ys[i], hist, band_t, rp.nhist), n) + ev_ms(
            lambda i: rational.rational_tail(ys[i], hist, band_t, rp.nhist),
            n)) / 2
        fin = {}
        for bits, dither in ((24, T), (32, F)):
            cfg = StepConfig(channels=2, tile_bytes=tile, bit_depth=bits,
                             dither=dither, level_db=0.0)
            fin[bits] = alternate(
                lambda i, c=cfg: fused.finish_reference(zs[i], 1.0, keys[i], c),
                lambda i, c=cfg: fused.finish_cuda(zs[i], 1.0, keys[i], c), n)
        cfg = StepConfig(channels=2, tile_bytes=tile, bit_depth=24,
                         dither=T, level_db=0.0)
        step = rational.make_rational_step(chain, cfg, dev)

        def plain_step(i, _cfg=cfg):
            y = fused.fused_decim_cascade(xs[i], halo, taps, head, 1.0)
            z, _h = rational.rational_tail(y, hist, band_t, rp.nhist)
            return fused.finish_reference(z, 1.0, keys[i], _cfg)

        step_k, step_p, step_runs = alternate(
            plain_step, lambda i: step(xs[i], (halo, hist), keys[i]), n)
        audio = tile * 8 / key[1].hz
        n_base = tile * 8 // rp.r_head
        n_out = n_base * 160 // 147
        if key[1] is DsdRate.DSD64:
            timed["K1e"] = (head_k, head_p)
            timed["K2"] = fin[24][:2]
            bounds["K1e"] = bound(
                2 * (tile + fused.chain_halo_bytes(head)) + 2 * n_base * 4,
                fir_flops(head, n_base, 2))
            bounds["K2"] = bound(2 * n_out * (4 + 3), 5 * 2 * n_out)
        phase("timing", f"48k {name}, {tile} B/ch stereo tile ({audio:.2f} s "
              f"audio, ÷{rp.r_head} head, {n_out} final frames/ch): K1e "
              f"{head_k:.3f} ms (runs {head_runs['kernel']}) vs plain head "
              f"{head_p:.3f} ms (runs {head_runs['plain']}); tail "
              f"(torch.matmul) {tail_ms:.3f} ms; K2 24-bit TPDF "
              f"{fin[24][0]:.3f} ms vs plain finish {fin[24][1]:.3f} ms; K2 "
              f"f32 FPD {fin[32][0]:.3f} ms vs plain {fin[32][1]:.3f} ms; "
              f"whole step 24-bit TPDF {step_k:.3f} ms "
              f"({audio / step_k * 1e3:.0f} audio-s/s, runs "
              f"{step_runs['kernel']}) vs plain path {step_p:.3f} ms; "
              f"card [{label}]")
        del xs, ys, zs

    check("jax" not in sys.modules, "jax was loaded")
    jax_pkg = sorted(m for m in sys.modules if m.split(".")[0] == "dsd2dxd_tpu")
    check(not jax_pkg, f"modules of the JAX package were loaded: {jax_pkg}")
    check(all(launches[m] > 0 for m in ("K1a", "K1b", "K1c", "K1d", "K1e",
                                        "K2", "÷128")),
          f"a kernel mode was not launched on its path: {launches}")
    k1 = "dsd2dxd_tpu_torch/csrc/fused_decim.cu"
    rows = [("K1a", "fused_decim (K1a: G=1 ÷8, 24-bit)", k1,
             "dsd2dxd_tpu/ops/fused.py:287 (_build_kernel, G=1, 24-bit)"),
            ("K1b", "fused_decim (K1b: ÷16/÷32 word lanes)", k1,
             "dsd2dxd_tpu/ops/fused.py:287 (_build_kernel, G=2/4 word lanes)"),
            ("K1c", "fused_decim (K1c: ÷64/÷128 à-trous tail; ÷64 E "
             "DSD128->88.2k)", k1,
             "dsd2dxd_tpu/ops/fused.py:287 (_build_kernel, à-trous tail)"),
            ("÷128", "fused_decim (K1c at ÷128: E DSD256->88.2k)", k1,
             "dsd2dxd_tpu/ops/fused.py:287 (_build_kernel, à-trous tail)"),
            ("K1d", "fused_decim (K1d: 16/20-bit, f32/FPD epilogues)", k1,
             "dsd2dxd_tpu/ops/fused.py:287 (_build_kernel, epilogues)"),
            ("K1e", "fused_decim (K1e: planar f32 head of the 48k chains)",
             k1, "dsd2dxd_tpu/ops/fused.py:1219 (make_fused_rational_step "
             "head: _build_kernel at bit_depth 32, no dither, level 0)"),
            ("K2", "finish (K2: gain, peak, dither, quantize, wire bytes)",
             "dsd2dxd_tpu_torch/csrc/finish.cu",
             "dsd2dxd_tpu/ops/fused.py:1019 (make_finish_planes, "
             "pallas_call :1120)")]
    print(label)
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": src_file, "replaces": rep,
        "launches": launches[m], "max_abs_err": max_err[m],
        "ms": timed[m][0], "plain_ms": timed[m][1],
        "bound_ms": bounds[m][0], "bound_by": bounds[m][1],
        # no one PyTorch call unpacks, cascades, dithers and packs
        "library_ms": None}
        for m, name, src_file, rep in rows] + probe_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
