#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (dsd2dxd_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, one line each (kernel-vs-plain
one line per chain); any failed check exits non-zero:

1. env: Python, torch and CUDA versions, nvcc, the card (nvidia-smi).
2. build: compiles csrc/fused_decim.cu (K1a-K1e), csrc/finish.cu (K2, both
   modes) and csrc/probes.cu (P1, P2) with one nvcc each, started
   together, and links them; prints every kernel's registers, spills and
   stack frame; K2's kernels must have no spill and no stack frame, K1's
   line must be K1_PTXAS (its body, csrc/decim_body.cuh, is shared with
   P2's rungs), and the log must hold P1's 6 and P2's 6 kernels. SASS
   (tools/sasscount.py): P1 noflush keeps dma's global loads; the
   probes' and K1's local loads and stores are printed. Then
   the host library of NJAD, FLAC and the modulator (native/src, g++),
   timed; the tone files' modulator (ops/dsm.py, native) against the
   loop written out here, on 0.1 s of the DSD64 tone: equal.
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
   Then ÷8 (E DSD64 -> 352.8k) and ÷64 (E DSD128 -> 88.2k) at 1, 3 and 6
   channels (K1 takes the channel from the grid's y), 24-bit NONE and
   TPDF and f32 FPD, with the same limits. Then a partial final tile: a
   burst that ends at n_valid, the idle pad after it; the kernel's peak
   is the plain cascade's max over the first n_valid frames.
4. the 48k family, all 9 chains (E DSD64/128/256 -> 96k/192k/384k), two
   channels, three streamed tiles at the engine's tile:
   - K1e vs plain: the planar f32 head against fused_decim_cascade at
     gain 1, bit-equal;
   - tail precision: rational_tail_reference (the plain version of K2's
     band sums) and rational_tail (the dense fp32 torch.matmul, the
     tail's library call) on the heads' real output against a float64
     numpy oracle of the same band, below 2e-6;
   - K2 "from z" vs plain on the tail's output, DSD64 -> 192k and DSD256
     -> 96k at 16/20/24-bit NONE/TPDF/RECT and f32 NONE/FPD, with the
     limits of 3;
   - K2 "from the head's samples" (K2t) vs rational_tail_reference then
     finish_reference: the same 11 epilogues on those two chains, 24-bit
     NONE/TPDF and f32 NONE/FPD on the other seven; wire bytes and peak
     equal, and the limits of 3;
   - the whole step (K1e, K2t through make_rational_step) against its
     plain path: all 9 at 24-bit TPDF, 3 at f32 FPD, wire bytes and peak
     equal;
   - K1e at 1, 3 and 6 channels on DSD64 -> 192k's head, bit-equal;
   - a partial final tile on DSD64 -> 192k: the step's wire bytes are the
     plain path's and its peak is the plain valid-prefix peak.
5. e2e, BASELINE config 1: a three-minute DSD64 stereo 1 kHz tone .dsf
   through the port's CLI to a 24-bit 352.8 kHz TPDF WAV; checks the WAV
   header, the frame count, the 1 kHz spectral peak and that the kernel
   (K1a) ran once per tile.
5b. e2e, mono: a one-minute DSD64 mono .dsf through config 1's flags:
   the header (one channel), the frame count, the 1 kHz peak, one K1a
   launch per tile; then 5 s at `-d N` in mono and in stereo (the same
   tone on both channels): the mono samples are both stereo channels'.
6. e2e, integer 48k: the same .dsf to a 24-bit 96 kHz TPDF WAV (÷32 head,
   3008-tap tail); the same checks, one K1e and one K2t launch per tile
   and no K2 "from z" launch.
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
   channels and one K1e and one K2t launch per tile. Then the same .dsf
   to a 24-bit 88.2 kHz TPDF WAV (÷128, K1c's deepest chain): the
   header, the frame count, the 1 kHz peak and one K1c launch per tile.
10. e2e, the level check: `dsd_levels` through its run() on phase 5's
    .dsf at -r 352800 (one K1 launch at f32 NONE per tile) and -r 96000
    (one K1e and one K2t per tile); the printed lines in the JAX format,
    and the dBFS exactly 20 log10 of max |x| of the same file converted
    with `-b 32 -d X -o w` (the same kernels at f32 NONE, level 0).
11. e2e, BASELINE config 3: phase 8's .dsf with `-b 20 -d N -o F -r
    88200`: STREAMINFO (88200 Hz, 2 ch, 20 bit, 180 x 88200 frames), the
    MD5 that of the port's host NJAD run over the f32 output of `-b 32 -d
    X -r 88200` (3-byte LE unshifted samples; each the floor or ceil of
    x 2^19), the 1 kHz peak, one K1c launch (f32 NONE) per tile.
12. e2e, BASELINE config 5: a folder of two subfolders with four tagged
    stereo .dsf (TIT2, TPE1, TALB, an APIC JPEG): DSD64 60 s, DSD128,
    DSD256 and DSD512 30 s each, through one CLI run `-R -o F -p OUT`
    (24-bit TPDF at 352.8k) on the CLI's worker threads (at least 2):
    the tree mirrored, STREAMINFO, TITLE/ARTIST/ALBUM in VORBIS_COMMENT,
    the APIC bytes as PICTURE, the MD5 that of the same file's `-o w`
    payload, the 1 kHz peak, and the ÷8/÷16/÷32/÷64 launches summed over
    the files' tiles. Then a 5 s DSD128 .dsf to 20-bit 88.2k TPDF FLAC
    (K1d), decoded in full by formats/flac_decode.py: MD5 good, sample for
    sample the WAV payload >> 4.
12b. sharded: DSD2DXD_SHARD_STREAM=1 with the engine's stream_devices
    patched to cuda:0 x 4 (and, with two or more cards, unpatched over
    every card), through the CLI: phase 5's .dsf -> 24-bit 352.8k TPDF
    WAV (K1a), the same .dsf -> 24-bit 96k (K1e + K2t, warm passes),
    config 4's DSD256 .dsf -> f32 FPD AIFC, config 3's DSD128 .dsf ->
    20-bit NJAD FLAC and `dsd_levels -r 96000`: each file's sha256 that of
    the streaming phase's file, the dBFS phase 10's, one K1 (or K1e + K2t)
    launch per tile and one K1e warm launch per 48k tile after the first;
    audio-s/s of both routes. Then the CLI's round-robin: batch_devices();
    with two or more cards config 5's batch over all of them (every MD5
    phase 12's), with one card a line that says it needs a second. A K1
    launch that expects device index device_count() must raise (CUDA
    error 101). make_sharded_convert on random B=2 x T=2 tiles at 24-bit
    TPDF over cuda:0 x 4 (÷8 and 96k) against the same function's plain
    bodies on the CPU: within 1 LSB, >= 99.9 % identical, peak within
    1e-4.
12c. host-tools: the port's host tools (dsd2dxd_tpu_torch/tools) through
    their entry points, about 30 s: hostbudget --seconds 2 --pairs 3 (every
    stage, stage_pinned too; configs 1, 2 and 4's reader and drain thread
    ceilings beside this run's e2e audio-s/s of the same config, configs 3
    and 5's drain ceilings); flacbench --seconds 2 --reps 2 (tone, music,
    quiet); njadbench --seconds 2 --pairs 3 (its div/ladder gate raises on
    any difference); compare_reference on the card's outputs: config 1's
    WAV (converted again, its sha256 phase 5's) against itself bitexact at
    offset 0, config 1 under DSD2DXD_SEED "" and "take2" dither-equiv with
    an RMS of 0.3-0.8 LSB (one K1a launch per tile each), a 5 s DSD64 .dsf
    at `-b 24 -d N` on the card against Converter(device="cpu") (the plain
    versions) within 5 LSB at offset 0 (main's exit code 0), and phase
    12's 5 s FLAC against its WAV bitexact (the port's decoder).
12d. profile: DSD2DXD_PROFILE_DIR (the engine's torch.profiler hook,
    dsd2dxd_tpu_torch/utils/trace.py) through the CLI, about 25 s: config
    1, config 2 and config 4, each 3 runs untraced and 3 traced in turn.
    Per config: the median and range of audio-s/s of both kinds and their
    ratio (the hook's cost); from each trace the device's busy share of
    the stream's wall (dsd2dxd.stream's length): the union of the kernel
    events' intervals, then of kernels, copies and sets; each host span's
    summed ms (setup, read, stage and its wait_slot / fill / enqueue,
    wait_drain, finish; the drain thread's drain.wait_copy and
    drain.write) and the share of the stream's thread that no span
    covers. Checks: one trace file per traced stream and none untraced;
    every traced output's sha256 the untraced one's; one K1 (config 4:
    one K1e and one K2t) kernel event per tile under the kernel's name;
    drain.write on another thread than read. Then two streams at once
    (config 1's .dsf and a link to it in one CLI call, on its worker
    threads), untraced and traced: exit 0, one trace holding both
    streams, every output's sha256 the untraced call's. Then one traced
    sharded run of config 1 (DSD2DXD_SHARD_STREAM=1 over cuda:0 x 4), the
    same split and checks. Fails, saying so, where torch's profiler cannot
    record every thread (profile_all_threads).
12e. bench: `python -m dsd2dxd_tpu_torch.tools.bench` (the port of
    bench.py) in a subprocess per mode, about 60 s: the device step
    (8 staged 16 MiB/ch tiles, CUDA events), --e2e (upload, step and
    download per tile) and --config 1-5 (BASELINE configs 1-5 on
    bench.py's fixtures, 8-24 s each, through the Converter and the CLI).
    Each must print exactly one JSON line on stdout with bench.py's
    metric name (the e2e one without `_tunnel`) and a positive xRT, and
    launch its path's kernels (the step modes K1a 8 times per run, no
    other); config 4's DSD512 -> 352.8k output must be an f32 AIFC of 8 x
    352800 frames with its tone at 1 kHz. The lines are printed as they
    come. Then entry()'s flagship step (one K1a launch) against
    entry("cpu")'s plain step: within 1 LSB, >= 99.9 % identical, peak
    within 1e-4; and dryrun_multichip(4) over cuda:0 x 4 (the ÷8 and 96k
    chains at 24-bit TPDF and f32 NONE: the grid's shapes, finite peaks,
    the stream's bytes equal to the streaming step's).
13. probes: the floor probes of K1 (dsd2dxd_tpu_torch/tools). Every P1
    mode (dmabench: noop, noflush, dma, halo0, contig, bspec; all but
    bspec copy their window with K1's 16-byte copy) at each of K1's
    blocks against its plain version on 2 staged 16 MiB/ch stereo tiles,
    exact (noflush: the last block's values). Every P2 rung kernel
    (floorstrip: K1's body cut short: dma, unpack, cas0a, cas0, quant at
    NONE and TPDF) on both ladders' chains, synth_chain(0.0) and config
    1's ÷8 chain, at K1's block_out, a random halo and n_valid 9 short,
    2 tiles of 16 MiB/ch: bit-equal (peaks too) but quant TPDF, within 1
    LSB and >= 99.9 % identical with K1's TPDF error limits; full (K1
    itself) against fused_decim_reference with K1's limits. The one
    PyTorch call that computes each P1 mode where there is one (noop: a
    repeat of an arange; dma, halo0: a slice and a cast; contig, bspec: a
    view, a transpose and a cast) is held equal to the plain version, then
    timed beside it. Then both tools through their entry points at 16
    MiB/ch stereo, 8 staged tiles (268 MB, more than the 50 MB L2), the
    stream held by a sleep kernel while each run is enqueued, with their
    launch counts read around each run: P1 noflush must not be slower
    than dma at any block; the P2 ladder on both chains, each row
    with its increment, its floor (bytes, 2 x f32 operations: no FMA, and
    Philox at TPDF) and its share, rows slower than full's slowest rep
    marked; and tools/finishsweep.py through its entry point at 512 and
    2048 frames per run, which is what launches K2 "from z" (no
    conversion does, since the step takes K2t).
14. timing: kernel and plain version per 16 MiB/ch stereo tile, CUDA
    events over 8 staged tiles, plain-kernel-kernel-plain, for K1a (÷8),
    ÷16, ÷64 and ÷128 at 24-bit TPDF and ÷64 at 20-bit TPDF (K1d); for
    the 48k family, one 16.08 MiB/ch tile (the engine's unit-aligned
    tile) of DSD64 -> 192k and of DSD256 -> 96k: K1e against the plain
    head; rational_tail (the matmul) alone; K2 "from z" against the plain
    finish at 24-bit NONE, 24-bit and 16-bit TPDF and f32 FPD; K2t against
    its plain version at 24-bit NONE and TPDF and f32 FPD; the route the
    step does not take (matmul, then K2 "from z") beside K2t, and the
    smoke fails if that route is the faster; and the whole step against
    its plain path.
15. lightspeed: ``python -m dsd2dxd_tpu_torch.tools.lightspeed --calibrate
    --measure`` in this process (budget 90 s): the model's fits on
    synth_chain ladders with their largest residuals, then all 22 cells
    of the rate matrix through the engine's own steps (K1a-K1c, K1e +
    K2t) at the engine's tile, 24-bit TPDF, one row each: measured xRT,
    the model, the chain-only bound and its share, the no-FMA floor, the
    HBM ceiling. Fails on a missing cell, a share of the bound above 100
    % (a miscounted term) or a cell the timing phase also times
    (DSD64->352.8k, ->176.4k, ->192k, DSD128->88.2k, DSD256->88.2k,
    ->96k) more than 25 % from its xRT there.

Each phase line ends with the seconds since the start. At the end it
checks that neither jax nor any module of the JAX package (dsd2dxd_tpu)
was loaded. Then the card's name and power limit, one JSON line on the
kernels (K1's ÷128 chain a row of its own; launches from the e2e phase
or tool run that drives each, named in the row's launches_from: K2 "from
z", P1 and P2 are launched by their tools' timing loops and by no
conversion; launches_sharded those of the sharded phase over cuda:0 x 4;
launches_bench those of the bench phase's subprocesses, warm runs included;
launches_lightspeed those of the lightspeed phase (÷128: its ÷128 cell's);
max_abs_err in LSB of the output depth, absolute for f32; bound_ms the
largest of the bytes over 3.35 TB/s, the f32 operations over 67 TFLOP/s
and, for the dithered epilogues, the Philox calls' 18 multiplies (or
their 18 xors: the two kinds run on separate pipes) over 16.7 TOP/s,
from this run's inputs (tools/lightspeed.py's k1_work, k2t_work and
bound_ms); library_ms the one PyTorch call
of the same function where there is one -- P1's noop, dma, halo0, contig
and bspec; for K2t the matmul that computes its tail -- else null), and
the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import io
import json
import math
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import wave
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DSD64_HZ = 2_822_400
SECONDS = 180
SECONDS_CONFIG4 = 60  # DSD256: 169 MB of .dsf for a minute
T_START = time.perf_counter()
TOL_NONE_LSB = 5
TOL_DITHER_LSB = 1
# K1's ptxas line (fused_decim_kernel: registers, spill bytes, stack
# bytes): 64 registers (4 blocks of 256 threads per SM), no local memory
K1_PTXAS = (64, 0, 0)


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

def sine(freq: float, n: int, rate: int, amplitude: float = 0.5):
    import numpy as np

    return amplitude * np.sin(2 * np.pi * freq * np.arange(n) / rate)


def dsm_tone(freq: float, n: int, rate: int, amplitude: float = 0.5):
    """MSB-first DSD bytes of a sine through the port's 2nd-order
    delta-sigma modulator (ops/dsm.py, its native loop)."""
    import numpy as np

    from dsd2dxd_tpu_torch.ops.dsm import dsm2_bits

    return np.packbits(dsm2_bits(sine(freq, n, rate, amplitude)))


def dsm_tone_inline(freq: float, n: int, rate: int, amplitude: float = 0.5):
    """The same bytes from the loop written out here, apart from the
    port: the reference that the smoke holds ops/dsm.py's against."""
    import numpy as np

    bits = bytearray(n)
    s1 = s2 = 0.0
    for i, v in enumerate(sine(freq, n, rate, amplitude).tolist()):
        y = 1.0 if s2 >= 0.0 else -1.0
        bits[i] = y > 0
        s1 += 0.5 * (v - y)
        s2 += 0.5 * (s1 - y)
    return np.packbits(np.frombuffer(bytes(bits), dtype=np.uint8))


@functools.lru_cache(maxsize=None)
def tone_period(rate: int):
    """0.1 s (100 periods) of the 1 kHz tone at `rate`, modulated once."""
    return dsm_tone(1000.0, rate // 10, rate)


def sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def tone_planes(rate: int, seconds: float):
    """(2, seconds * rate / 8) stereo 1 kHz tone: 0.1 s (100 periods)
    modulated once (both channels alike) and tiled seamlessly."""
    import numpy as np

    one = np.stack([tone_period(rate)] * 2)
    return np.tile(one, (1, round(seconds * 10)))


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


def wav_payload(path: Path) -> memoryview:
    """The data chunk of a RIFF WAV, walking the chunks (an 'id3 ' chunk
    may come before it)."""
    data = path.read_bytes()
    check(data[:4] == b"RIFF" and data[8:12] == b"WAVE",
          f"{path.name}: not a WAV file")
    i = 12
    while i + 8 <= len(data):
        cid, size = data[i:i + 4], struct.unpack("<I", data[i + 4:i + 8])[0]
        if cid == b"data":
            return memoryview(data)[i + 8:i + 8 + size]
        i += 8 + size + (size & 1)
    fail(f"{path.name}: no data chunk")


def flac_meta(path: Path):
    """((rate, channels, bits, frames, md5), VORBIS_COMMENT entries,
    PICTURE data) from a FLAC file's metadata blocks."""
    with open(path, "rb") as f:
        data = f.read(1 << 20)
    check(data[:4] == b"fLaC", f"{path.name}: not a FLAC stream")
    info, comments, pictures, i = None, {}, [], 4
    while True:
        head, n = data[i], int.from_bytes(data[i + 1:i + 4], "big")
        body = data[i + 4:i + 4 + n]
        if head & 0x7F == 0:
            rate = int.from_bytes(body[10:13], "big") >> 4
            bits = (((body[12] & 1) << 4) | (body[13] >> 4)) + 1
            frames = (((body[13] & 0x0F) << 32)
                      | int.from_bytes(body[14:18], "big"))
            info = (rate, ((body[12] >> 1) & 7) + 1, bits, frames,
                    body[18:34])
        elif head & 0x7F == 4:
            j = 4 + struct.unpack("<I", body[:4])[0]
            for _ in range(struct.unpack("<I", body[j:j + 4])[0]):
                m = struct.unpack("<I", body[j + 4:j + 8])[0]
                key, _, val = body[j + 8:j + 8 + m].decode().partition("=")
                comments[key.upper()] = val
                j += 4 + m
        elif head & 0x7F == 6:
            j = 4
            for _ in range(2):  # MIME type, description
                j += 4 + struct.unpack(">I", body[j:j + 4])[0]
            j += 16  # width, height, depth, colours
            m = struct.unpack(">I", body[j:j + 4])[0]
            pictures.append(body[j + 4:j + 4 + m])
        i += 4 + n
        if head & 0x80:
            return info, comments, pictures


def p1_library_call(x, mode: str, g, rows: int, n_blocks: int):
    """The one PyTorch call that computes P1's `mode` at the card's
    geometry (k_sub = B, H <= B: block i of row c stores words
    iB + H .. iB + H + B of its window, or of its slab row), or None where
    there is none: noflush's output, the last block's values, is one slice
    of one block, which no call computes from the stream the probe copies.
    Timed beside the kernel; the port never calls it."""
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


def ptxas_entries(log: str) -> list:
    """(kernel<template ints>, registers, spill bytes, stack bytes) for
    every entry ptxas compiled, from nvcc's -Xptxas -v output."""
    import re

    out, name, stack = [], None, "0"
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
            out.append((name, int(m.group(1)), int(spill), int(stack)))
            name = None
    return out


def host_tools(tmp: Path, src64: Path, n1: int, out_dir: Path,
               config1_sha: str, e2e: dict, label: str) -> None:
    """Phase 12c: hostbudget, flacbench, njadbench and compare_reference
    (dsd2dxd_tpu_torch/tools) through their entry points. `src64` is
    config 1's .dsf (`n1` engine tiles), `config1_sha` its streaming WAV's
    sha256, `out_dir` holds the FLAC decode phase's 5 s FLAC and WAV,
    `e2e` the audio-s/s of configs 1, 2 and 4 measured in this run."""
    from dsd2dxd_tpu_torch import (
        Converter,
        DitherType,
        FilterType,
        OutputType,
    )
    from dsd2dxd_tpu_torch.cli.dsd2dxd import run as cli_run
    from dsd2dxd_tpu_torch.ops import fused
    from dsd2dxd_tpu_torch.tools import (
        compare_reference,
        flacbench,
        hostbudget,
        njadbench,
    )

    t_phase = time.perf_counter()
    # hostbudget: every stage, stage_pinned too, and configs 1, 2 and 4's
    # thread ceilings beside this run's e2e audio-s/s
    hb_json = tmp / "hostbudget.json"
    rc = hostbudget.main(["--seconds", "2", "--pairs", "3", "--json",
                          str(hb_json)])
    hb = json.loads(hb_json.read_text())
    check(rc == 0 and set(hb["stages"]) == set(hostbudget.SHARED_STAGES),
          f"hostbudget exited {rc}, stages {sorted(hb['stages'])}")
    hb_text = [", ".join(f"{n} {r['xrt']:.1f}x" + (
        f" (threads1/threads2 {r['t1_over_t2']:.3f})" if "t1_over_t2" in r
        else "") for n, r in hb["stages"].items())]
    for name, audio_per_s in e2e.items():
        c = hb["configs"][name]
        want = set(hostbudget.TILE_CONFIGS[name].reader) | {"write"}
        check(set(c["stages"]) == want,
              f"hostbudget {name}: stages {sorted(c['stages'])}, not "
              f"{sorted(want)}")
        hb_text.append(
            f"{name} ({c['tile_bytes']} B/ch tile, {c['audio_s']:.3f} "
            f"audio-s): " + ", ".join(f"{s} {x:.1f}x"
                                      for s, x in c["stages"].items())
            + f"; reader ceiling {c['reader']:.1f}x, drain ceiling "
            f"{c['drain']:.1f}x; e2e {audio_per_s:.1f} audio-s/s (reader "
            f"ceiling / e2e = {c['reader'] / audio_per_s:.2f})")
    for name in hostbudget.SINK_CONFIGS:
        c = hb["configs"][name]
        hb_text.append(f"{name} drain ceiling ({' + '.join(c['sink'])}) "
                       f"{c['drain']:.1f}x")
    phase("host-tools", f"hostbudget --seconds 2 --pairs 3 ({hb['cores']} "
          f"cores, page cache warm): " + "; ".join(hb_text)
          + f"; card [{label}]")

    # flacbench and njadbench: the host library's FLAC encoder and the
    # NJAD digit A/B, whose gate raises before any time is printed
    bench_text = []
    for tool, argv in ((flacbench, ["--seconds", "2", "--reps", "2"]),
                       (njadbench, ["--seconds", "2", "--pairs", "3"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = tool.main(argv)
        lines = [ln.strip() for ln in buf.getvalue().splitlines()]
        check(rc == 0 and len(lines) == 3,
              f"{tool.__name__} exited {rc}: {lines}")
        bench_text.append(f"{tool.__name__.rsplit('.', 1)[1]} "
                          f"{' '.join(argv)}: " + "; ".join(lines))
    phase("host-tools", " | ".join(bench_text))

    # compare_reference on the card's outputs
    cmp_dir = tmp / "cmp"
    wavs = {}
    t_conv = time.perf_counter()
    saved = os.environ.get("DSD2DXD_SEED")
    try:
        for seed in ("", "take2"):
            d = cmp_dir / (seed or "unset")
            d.mkdir(parents=True)
            os.environ["DSD2DXD_SEED"] = seed
            fused.reset_launch_counts()
            rc = cli_run(["-o", "w", "-q", "-p", str(d), str(src64)])
            k1a = fused.MODE_LAUNCHES["K1a"]
            check(rc == 0 and k1a == n1, f"compare: config 1 with "
                  f"DSD2DXD_SEED={seed!r}: CLI exited {rc}, {k1a} K1a "
                  f"launches for {n1} tiles")
            wavs[seed] = d / src64.with_suffix(".wav").name
    finally:
        if saved is None:
            os.environ.pop("DSD2DXD_SEED", None)
        else:
            os.environ["DSD2DXD_SEED"] = saved
    conv_s = time.perf_counter() - t_conv
    # the sha256 and the two comparisons of 381 MB WAVs run on threads
    # (hashlib and numpy's array passes release the interpreter lock)
    # while this thread runs the parity conversions and the FLAC decode
    t_cmp = time.perf_counter()
    pair_of = functools.partial(compare_reference.compare_pair, raw=None,
                                channels=2, bits_override=None, max_shift=16)
    results = {}
    pool = ThreadPoolExecutor(max_workers=3)
    try:
        f_sha = pool.submit(sha256, wavs[""])
        f_self = pool.submit(pair_of, wavs[""], wavs[""])
        f_seed = pool.submit(pair_of, wavs[""], wavs["take2"])

        # the parity contract: 5 s at `-b 24 -d N`, the card's kernels
        # against their plain versions (Converter on the CPU), max 5 LSB
        src5 = cmp_dir / "tone_dsd64_5s.dsf"
        write_dsf(src5, tone_planes(DSD64_HZ, 5), DSD64_HZ)
        card_dir, cpu_dir = cmp_dir / "card", cmp_dir / "cpu"
        card_dir.mkdir()
        fused.reset_launch_counts()
        rc = cli_run(["-b", "24", "-d", "N", "-o", "w", "-q", "-p",
                      str(card_dir), str(src5)])
        k1d = fused.MODE_LAUNCHES["K1d"]
        check(rc == 0 and k1d == fused.KERNEL_LAUNCHES == 1,
              f"compare: `-b 24 -d N` on the card exited {rc}, {k1d} K1d "
              f"of {fused.KERNEL_LAUNCHES} launches")
        Converter.from_container(
            bit_depth=24, output=OutputType.WAV, level_db=0.0,
            output_rate=352800, out_dir=cpu_dir, dither=DitherType.NJAD,
            filt=FilterType.EQUIRIPPLE, append_rate=False,
            base_dir=cmp_dir, input_path=src5, device="cpu").do_conversion()
        pair = [str(card_dir / "tone_dsd64_5s.wav"),
                str(cpu_dir / "tone_dsd64_5s.wav")]
        parity = pair_of(*map(Path, pair))
        with contextlib.redirect_stdout(io.StringIO()):
            rc = compare_reference.main([*pair, "--max-shift", "16"])
        check(rc == 0 and parity["offset"] == 0
              and parity["max_lsb"] <= TOL_NONE_LSB,
              f"compare: `-b 24 -d N` on the card against the plain "
              f"versions: main exited {rc}, {parity}")

        # the FLAC decode phase's 5 s FLAC against its WAV, through the
        # port's decoder
        flac = pair_of(out_dir / "tone_dsd128_5s.wav",
                       out_dir / "tone_dsd128_5s.flac")
        check(flac["verdict"] == "bitexact",
              f"compare: 5 s FLAC vs its WAV: {flac}")

        check(f_sha.result() == config1_sha,
              "compare: config 1 again is not the e2e phase's WAV")
        r = results["config 1 vs itself"] = f_self.result()
        check(r["verdict"] == "bitexact" and r["offset"] == 0,
              f"compare: config 1's WAV against itself: {r}")
        r = results["DSD2DXD_SEED '' vs 'take2'"] = f_seed.result()
        check(r["verdict"] == "dither-equiv" and r["offset"] == 0
              and 0.3 <= r["rms_lsb"] <= 0.8,
              f"compare: config 1 under two seeds: {r}")
    finally:
        pool.shutdown(wait=True)
    results["-b 24 -d N card vs plain"] = parity
    results["5 s FLAC vs WAV"] = flac
    for path in wavs.values():
        path.unlink()
    phase("host-tools", "compare_reference: " + "; ".join(
        f"{k} {r['verdict']} (offset {r['offset']}, {r['frames']} frames, "
        f"max {r['max_lsb']:g} LSB, rms {r['rms_lsb']:.3f} LSB at "
        f"{r['bits']} bit)" for k, r in results.items())
        + f"; config 1 converted twice in {conv_s:.1f} s, the comparisons "
        f"(the 5 s conversions and the FLAC decode among them) "
        f"{time.perf_counter() - t_cmp:.1f} s. Phase wall "
        f"{time.perf_counter() - t_phase:.1f} s; card [{label}]")


CONFIG2_ARGV = ["-f", "I", "-r", "176400", "-q"]
SPAN = "dsd2dxd."  # the engine's host spans (dsd2dxd_tpu_torch/utils/trace.py)


def cli_stdin(cli_run, argv: list, src: Path, dst: Path):
    """The CLI with `src` on its stdin and `dst` as its stdout: (exit
    code, wall seconds)."""
    with open(src, "rb") as fin, open(dst, "wb") as fout:
        saved = sys.stdin, sys.stdout
        sys.stdin, sys.stdout = io.TextIOWrapper(fin), io.TextIOWrapper(fout)
        try:
            t0 = time.perf_counter()
            rc = cli_run(argv)
            sys.stdout.flush()
            return rc, time.perf_counter() - t0
        finally:
            sys.stdin, sys.stdout = saved


def busy_us(events: list, t0: float, t1: float) -> float:
    """Microseconds of [t0, t1) covered by the union of the events'
    intervals."""
    spans = sorted((max(e["ts"], t0), min(e["ts"] + e["dur"], t1))
                   for e in events)
    total, end = 0.0, t0
    for a, b in spans:
        a = max(a, end)
        if b > a:
            total += b - a
            end = b
    return total


def trace_split(path: Path) -> dict:
    """One stream's Chrome trace (DSD2DXD_PROFILE_DIR): the stream's wall
    (``dsd2dxd.stream``), the device's busy share of it (the union of the
    kernels' intervals, and of kernels, copies and sets), each host span's
    summed ms and threads, the share of the stream's thread that no other
    span covers, and the kernel events counted by name."""
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    host = [e for e in events if e.get("cat") == "user_annotation"
            and e["name"].startswith(SPAN)]
    stream = [e for e in host if e["name"] == SPAN + "stream"]
    check(len(stream) == 1, f"{path.name}: {len(stream)} stream spans")
    st = stream[0]
    t0, t1, wall = st["ts"], st["ts"] + st["dur"], st["dur"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    spans, tids = {}, {}
    for e in host:
        if e is not st:
            name = e["name"][len(SPAN):]
            spans[name] = spans.get(name, 0.0) + e["dur"] / 1e3
            tids.setdefault(name, set()).add(e["tid"])
    names = {}
    for e in kernels:
        for k in ("fused_decim_kernel", "finish_tail_kernel",
                  "finish_kernel"):
            if k in e["name"]:
                names[k] = names.get(k, 0) + 1
                break
    covered = busy_us([e for e in host if e is not st
                       and e["tid"] == st["tid"]], t0, t1)
    return {"wall_ms": wall / 1e3, "busy_k": busy_us(kernels, t0, t1) / wall,
            "busy_all": busy_us(device, t0, t1) / wall, "spans": spans,
            "tids": tids, "uncovered": 1.0 - covered / wall,
            "kernels": names, "n_kernel_events": len(kernels)}


def profile_phase(tmp: Path, cases: list, shard_devs: list,
                  label: str) -> None:
    """Phase 12d: DSD2DXD_PROFILE_DIR through the CLI. Each case (name,
    argv, stdin file or None, output file, audio s, kernel events wanted
    per name, the untraced output's sha256 or None) runs 6 times, untraced
    and traced in turn; every traced run writes one trace, with the
    wanted kernel events under their own names, drain.write on another
    thread than read, and the untraced output. Then the first case with
    a second stream beside it (one CLI call, its worker threads),
    untraced and traced: exit 0, one trace with both streams, the same
    outputs; and one sharded run of the first case over `shard_devs`."""
    import statistics

    import torch

    from dsd2dxd_tpu_torch.cli.dsd2dxd import run as cli_run
    from dsd2dxd_tpu_torch.pipeline import engine
    from dsd2dxd_tpu_torch.utils import trace
    from dsd2dxd_tpu_torch.utils.errors import ConfigError

    t_phase = time.perf_counter()
    try:  # the CLI's -q would swallow the engine's refusal
        trace.all_threads_config()
    except ConfigError as e:
        fail(f"profile: {e}")
    prof_dir = tmp / "prof"
    env = trace.ENV
    saved = os.environ.pop(env, None)

    def run(argv, stdin, out_path, traced, want_sha, kernels):
        """One CLI run: (wall s, trace split or None, output sha256)."""
        if traced:
            os.environ[env] = str(prof_dir)
        before = set(prof_dir.glob("*.pt.trace.json"))
        try:
            if stdin is None:
                t0 = time.perf_counter()
                rc = cli_run(argv)
                wall = time.perf_counter() - t0
            else:
                rc, wall = cli_stdin(cli_run, argv, stdin, out_path)
        finally:
            os.environ.pop(env, None)
        check(rc == 0, f"profile: CLI {argv} exited {rc}")
        new = set(prof_dir.glob("*.pt.trace.json")) - before
        check(len(new) == (1 if traced else 0),
              f"profile: {len(new)} trace files for one "
              f"{'traced' if traced else 'untraced'} stream")
        digest = sha256(out_path) if traced or want_sha is None else None
        out_path.unlink()
        check(digest is None or want_sha is None or digest == want_sha,
              f"profile: the traced output of {argv} is not the untraced "
              f"one")
        if not traced:
            return wall, None, digest
        split = trace_split(new.pop())
        check(split["kernels"] == kernels,
              f"profile: the trace holds kernel events {split['kernels']} "
              f"(of {split['n_kernel_events']}), want {kernels}")
        write_t, read_t = split["tids"].get("drain.write", set()), \
            split["tids"].get("read", set())
        check(write_t and read_t and not write_t & read_t,
              f"profile: drain.write on threads {write_t}, read on "
              f"{read_t}: the drain thread is not in the trace")
        return wall, split, digest

    def pct(v: list) -> str:
        return f"{min(v) * 100:.2f}-{max(v) * 100:.2f}"

    def split_text(splits: list) -> str:
        med = statistics.median
        names = sorted({n for s in splits for n in s["spans"]})
        return (f"stream {med(s['wall_ms'] for s in splits):.1f} ms; "
                f"device busy: kernels {pct([s['busy_k'] for s in splits])} "
                f"%, kernels + copies + sets "
                f"{pct([s['busy_all'] for s in splits])} %; host spans "
                f"(median ms): " + ", ".join(
                    f"{n} {med(s['spans'].get(n, 0.0) for s in splits):.1f}"
                    for n in names)
                + f"; the stream's thread uncovered "
                f"{pct([s['uncovered'] for s in splits])} %")

    try:
        for name, argv, stdin, out_path, sec, kernels, want_sha in cases:
            rates = {False: [], True: []}
            splits = []
            for i in range(6):
                traced = i % 2 == 1
                wall, split, digest = run(argv, stdin, out_path, traced,
                                          want_sha, kernels)
                want_sha = want_sha or digest
                rates[traced].append(sec / wall)
                if split is not None:
                    splits.append(split)
            med = {t: statistics.median(r) for t, r in rates.items()}
            phase("profile", f"{name}: audio-s/s untraced {med[False]:.1f} "
                  f"({min(rates[False]):.1f}-{max(rates[False]):.1f}), "
                  f"traced {med[True]:.1f} ({min(rates[True]):.1f}-"
                  f"{max(rates[True]):.1f}), traced / untraced "
                  f"{med[True] / med[False]:.3f}; from the 3 traces: "
                  + split_text(splits) + f"; kernel events {kernels} per "
                  f"trace; sha256 of every traced output the untraced "
                  f"one's; card [{label}]")

        # two streams at once on the CLI's worker threads, untraced and
        # traced: the batch's one shared session writes one trace with
        # both streams; nothing raises and no output changes
        name, argv, stdin, out_path, sec, kernels, want_sha = cases[0]
        src = Path(argv[-1])
        twin = src.with_name(f"{src.stem}_twin{src.suffix}")
        os.link(src, twin)
        pair_dir = tmp / "pair"  # -p mirrors the two inputs' folder there
        pair_dir.mkdir()
        i = argv.index("-p")
        pair_argv = argv[:i + 1] + [str(pair_dir)] + argv[i + 2:] + [
            str(twin)]
        shas = []
        for traced in (False, True):
            before = set(prof_dir.glob("*.pt.trace.json"))
            if traced:
                os.environ[env] = str(prof_dir)
            try:
                rc = cli_run(pair_argv)
            finally:
                os.environ.pop(env, None)
            check(rc == 0, f"profile: two streams at once exited {rc}")
            outs = sorted(pair_dir.rglob("*" + out_path.suffix))
            check([o.name for o in outs] == [src.stem + out_path.suffix,
                                             twin.stem + out_path.suffix],
                  f"profile: two streams at once wrote {outs}")
            shas.append([sha256(o) for o in outs])
            for o in outs:
                o.unlink()
        twin.unlink()
        new = set(prof_dir.glob("*.pt.trace.json")) - before
        check(shas[0] == shas[1] and shas[0][0] == want_sha,
              f"profile: two streams at once, traced outputs {shas[1]}, "
              f"untraced {shas[0]}, {name} alone {want_sha}")
        check(len(new) == 1, f"profile: two streams at once wrote "
              f"{len(new)} traces")
        streams = []
        for path in new:
            events = json.loads(path.read_text())["traceEvents"]
            streams.append(sum(1 for e in events
                               if e.get("cat") == "user_annotation"
                               and e.get("name") == SPAN + "stream"))
        check(streams == [2], f"profile: the trace of two streams holds "
              f"{streams} stream spans")
        phase("profile", f"two streams at once ({name}'s .dsf and a link "
              f"to it in one CLI call, on its worker threads): exit 0 "
              f"untraced and traced, {len(new)} trace(s) holding "
              f"{streams} dsd2dxd.stream span(s), both outputs' sha256 "
              f"those of the untraced call; card [{label}]")

        # one sharded run of the first case over the patched device list
        real = engine.stream_devices
        engine.stream_devices = lambda: shard_devs
        os.environ["DSD2DXD_SHARD_STREAM"] = "1"
        try:
            wall, split, _d = run(argv, stdin, out_path, True, want_sha,
                                  kernels)
        finally:
            engine.stream_devices = real
            del os.environ["DSD2DXD_SHARD_STREAM"]
        phase("profile", f"sharded {name} (DSD2DXD_SHARD_STREAM=1 over "
              f"{', '.join(str(d) for d in shard_devs)}): {sec / wall:.1f} "
              f"audio-s/s traced; " + split_text([split])
              + f"; sha256 the streaming output's. torch "
              f"{torch.__version__}. Phase wall "
              f"{time.perf_counter() - t_phase:.1f} s; card [{label}]")
    finally:
        if saved is not None:
            os.environ[env] = saved


# tools/bench.py's modes, in the order they run, and the kernel modes
# each launches: config 1 ÷8 24-bit; 2 ÷16; 3 ÷64 at f32 (NJAD); 4 DSD256
# -> 384k (K1e + K2t) and DSD512 -> 352.8k (÷64 f32); 5 ÷8 and DSD128 ÷16
BENCH_MODES = [("device", [], {"K1a"}), ("e2e", ["--e2e"], {"K1a"}),
               ("config 1", ["--config", "1"], {"K1a"}),
               ("config 2", ["--config", "2"], {"K1b"}),
               ("config 3", ["--config", "3"], {"K1c", "K1d"}),
               ("config 4", ["--config", "4"], {"K1e", "K2t", "K1c", "K1d"}),
               ("config 5", ["--config", "5"], {"K1a", "K1b"})]


def bench_phase(label: str) -> dict:
    """Phase 12e: ``python -m dsd2dxd_tpu_torch.tools.bench`` in a
    subprocess per mode (the device step, --e2e, --config 1-5): one JSON
    line each on stdout, bench.py's metric name, a positive xRT, the
    launches of each mode's kernels (the step modes: K1a 8 times per run);
    config 4's DSD512 -> 352.8k output an f32 AIFC with its tone at 1 kHz.
    Then entry()'s flagship step on the card against entry("cpu")'s plain
    step, and dryrun_multichip(4) over cuda:0 x 4. Returns the launches of
    the bench's subprocesses by mode."""
    import numpy as np
    import torch

    from dsd2dxd_tpu_torch.entry import dryrun_multichip, entry
    from dsd2dxd_tpu_torch.ops import fused
    from dsd2dxd_tpu_torch.tools import bench

    t_phase = time.perf_counter()
    launches: dict = {}
    with tempfile.TemporaryDirectory(prefix="dsd2dxd_smoke_bench_") as tmp:
        tmp = Path(tmp)
        # each subprocess imports torch anew; where its installation holds
        # no bytecode, the first one's compiled modules serve the others
        env = dict(os.environ, PYTHONPYCACHEPREFIX=str(tmp / "pycache"))
        for name, mode, want_modes in BENCH_MODES:
            config = int(mode[1]) if mode[:1] == ["--config"] else None
            out_dir = tmp / name.replace(" ", "")
            argv = [sys.executable, "-m", "dsd2dxd_tpu_torch.tools.bench",
                    *mode, "--out", str(out_dir)]
            t0 = time.perf_counter()
            res = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True,
                                 text=True, timeout=300)
            wall = time.perf_counter() - t0
            check(res.returncode == 0, f"bench {name} exited "
                  f"{res.returncode}: {res.stderr[-3000:]}")
            out = res.stdout.splitlines()
            check(len(out) == 1, f"bench {name} printed {len(out)} lines "
                  f"on stdout, want one: {out[:5]}")
            line = json.loads(out[0])
            value = line.get("value")
            check(line.get("metric") == bench.metric_name(
                      mode == ["--e2e"], config)
                  and line.get("unit") == "x_realtime"
                  and isinstance(value, (int, float)) and value > 0
                  # vs_baseline is rounded from the unrounded xRT, as
                  # bench.py's, so it may sit one step off value / 1000
                  and abs(line.get("vs_baseline", -1.0) - value / 1000.0)
                  <= 0.0006,
                  f"bench {name}: {line}")
            got = line["launches"]
            check(set(got) == want_modes,
                  f"bench {name} launched {got}, want modes {want_modes}")
            if config is None:
                check(got == {"K1a": bench.N_TILES * line["runs"]},
                      f"bench {name}: {got} in {line['runs']} runs, want "
                      f"{bench.N_TILES} K1a launches per run")
            if config == 4:
                ch, frames, bits, ctype, pcm = read_aifc_f32(
                    out_dir / "w2" / "bench512.aifc")
                check((ch, frames, bits, ctype) == (2, 8 * 352800, 32,
                                                    b"fl32"),
                      f"config 4's DSD512 AIFC COMM "
                      f"{(ch, frames, bits, ctype)}")
                mid = pcm[4 * 352800:5 * 352800]
                check(bool(np.isfinite(pcm).all())
                      and np.abs(mid).max() > 0.25,
                      "config 4's DSD512 output is silent or not finite")
                peak512 = fft_peak_hz(mid, 352800)
                check(np.all(np.abs(peak512 - 1000.0) < 2.0),
                      f"config 4's DSD512 FFT peak at {peak512} Hz")
            for k, v in got.items():
                launches[k] = launches.get(k, 0) + v
            print(out[0], flush=True)
            phase("bench", f"{name}: {line['metric']} = {value} "
                  f"(vs_baseline {line['vs_baseline']}), {line['runs']} runs, "
                  f"launches {got}; subprocess {wall:.1f} s"
                  + (f"; DSD512 -> 352.8k f32 AIFC {frames} frames, FFT "
                     f"peak {peak512.tolist()} Hz" if config == 4 else "")
                  + f"; card [{label}]")

    # entry(): the flagship step on the card against its plain version
    step, (x, halo, key) = entry()
    fused.reset_launch_counts()
    wire, peak, _ = step(x, halo, key)
    torch.cuda.synchronize()
    k1a = fused.MODE_LAUNCHES["K1a"]
    check(k1a == fused.KERNEL_LAUNCHES == 1, f"entry(): {k1a} K1a launches")
    pstep, pargs = entry(device="cpu")
    pwire, ppeak, _ = pstep(*pargs)
    d = s24(wire.cpu().numpy()) - s24(pwire.numpy())
    same = float((d == 0).mean())
    check(np.abs(d).max() <= TOL_DITHER_LSB and same >= 0.999
          and abs(float(peak) - float(ppeak)) < 1e-4,
          f"entry(): kernel vs plain max {np.abs(d).max()} LSB, {same:.5f} "
          f"identical, peak {float(peak)} vs {float(ppeak)}")
    # dryrun_multichip(4): the sharded route over cuda:0 x 4
    fused.reset_launch_counts()
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        dryrun_multichip(4)
    dry = dict(fused.MODE_LAUNCHES)
    check(buf.getvalue().startswith("dryrun_multichip OK over 4 entries")
          and dry["K1a"] > 0 and dry["K2t"] > 0,
          f"dryrun_multichip(4): {buf.getvalue()!r}, launches {dry}")
    phase("bench", f"entry(): K1a on the flagship's 64 KiB/ch tile vs plain "
          f"max {np.abs(d).max()} LSB, {same:.5f} identical, peak "
          f"{float(peak):.6f}; {buf.getvalue().strip()}; its launches "
          f"{ {k: v for k, v in dry.items() if v} }; bench "
          f"launches {launches}; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s; card [{label}]")
    return launches


LIGHTSPEED_BUDGET_S = 90
# the timing phase's cells (24-bit TPDF; the 48k ones as whole steps)
TIMING_CELLS = ("DSD64->352800", "DSD64->176400", "DSD128->88200",
                "DSD256->88200", "DSD64->192000", "DSD256->96000")
TIMING_XRT_TOL = 0.25


def lightspeed_phase(timing_xrt: dict, label: str) -> dict:
    """Phase 15: ``lightspeed --calibrate --measure`` in this process: the
    fits and the 22-row table on earlier lines; fails on a missing cell,
    a share of the bound above 100 %, or a timing-phase cell (`timing_xrt`,
    {"DSD64->352800": xRT, ...}) more than 25 % from the timing phase's
    xRT.
    Returns the phase's launches by kernel row (÷128: the K1c launches of
    the measured ÷128 cell)."""
    from dsd2dxd_tpu_torch.ops import fused
    from dsd2dxd_tpu_torch.tools import lightspeed

    t_phase = time.perf_counter()
    fused.reset_launch_counts()
    out = lightspeed.main(["--calibrate", "--measure"])
    launches = dict(fused.MODE_LAUNCHES)
    rows = {r["cell"]: r for r in out["rows"]}
    want = {f"{rate.name}->{hz}" for rate, outs in lightspeed.CELLS
            for hz in outs}
    check(len(want) == 22 and set(rows) == want,
          f"lightspeed measured {sorted(rows)}, want the 22 cells")
    over = {c: r["share_bound"] for c, r in rows.items()
            if not 0 < r["share_bound"] <= 1}
    check(not over, f"lightspeed: a share of the bound outside (0, 100 %] "
          f"is a miscounted term: {over}")
    launches["÷128"] = sum(r["device"]["launches"].get("K1c", 0)
                           for r in rows.values()
                           if r["decimation"] == 128 and not r["rational"])
    check(all(launches[m] > 0 for m in ("K1a", "K1b", "K1c", "÷128", "K1e",
                                        "K2t")),
          f"lightspeed: a kernel of the path was not launched: {launches}")
    agree = []
    for cell in TIMING_CELLS:
        got, ref = rows[cell]["measured"], timing_xrt[cell]
        agree.append(f"{cell} {got:.0f} vs {ref:.0f} ({got / ref:.3f})")
        check(abs(got / ref - 1) <= TIMING_XRT_TOL,
              f"lightspeed {cell}: {got:.0f} xRT at the engine's tile, the "
              f"timing phase {ref:.0f} at 16 MiB/ch: more than "
              f"{TIMING_XRT_TOL:.0%} apart")
    fits = out["fits"]
    wall = time.perf_counter() - t_phase
    phase("lightspeed", f"22 cells through the engine's steps at its tile, "
          f"24-bit TPDF: share of the bound "
          f"{min(r['share_bound'] for r in rows.values()):.1%}-"
          f"{max(r['share_bound'] for r in rows.values()):.1%}; against the "
          f"timing phase (xRT here vs there): {'; '.join(agree)}; fits' "
          f"largest residuals " + ", ".join(
              f"{c} {fits[c]['max_resid_pct']:.1f} %"
              for c in lightspeed.K1_CLASSES)
          + f"; launches { {k: v for k, v in launches.items() if v} }; "
          f"phase wall {wall:.1f} s (budget {LIGHTSPEED_BUDGET_S} s); "
          f"card [{label}]")
    return launches


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
    from dsd2dxd_tpu_torch.native import loader as host_loader
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
    # the NJAD/FLAC host library (g++), built here so that no e2e phase's
    # wall holds its build
    t0 = time.perf_counter()
    host_loader.load()
    host_s = time.perf_counter() - t0
    check(np.array_equal(tone_period(DSD64_HZ),
                         dsm_tone_inline(1000.0, DSD64_HZ // 10, DSD64_HZ)),
          "ops/dsm.py's modulator differs from the inline loop on 0.1 s of "
          "the DSD64 tone")
    entries = ptxas_entries(kernels.BUILD_LOG)
    k2_entries = [e for e in entries if e[0].startswith("finish")]
    check(len(k2_entries) == 14,
          f"want K2's 11 + 3 kernels in the build log (it is kept beside a "
          f"library built earlier), got {k2_entries}")
    check(all(e[2] == 0 and e[3] == 0 for e in k2_entries),
          f"a K2 kernel spills or keeps a stack frame: {k2_entries}")
    k1_entries = [e[1:] for e in entries if e[0] == "fused_decim_kernel<>"]
    check(k1_entries == [K1_PTXAS],
          f"K1's ptxas line (registers, spill bytes, stack bytes) is "
          f"{k1_entries}, not {K1_PTXAS}")
    p1_entries = [e for e in entries if e[0].startswith("dma_probe_kernel")]
    p2_entries = [e for e in entries if e[0].startswith("probe_step_kernel")]
    check(len(p1_entries) == 6 and len(p2_entries) == 6,
          f"want P1's 6 modes and P2's 6 rung kernels in the build log, got "
          f"{p1_entries} and {p2_entries}")
    ptxas_text = "; ".join(f"{n}: {r} regs, {sp} spill, {st} stack"
                           for n, r, sp, st in entries)
    # the probes' code: noflush keeps dma's loads (its one store is behind
    # a run-time condition), and the rungs' local memory beside K1's
    from dsd2dxd_tpu_torch.tools import sasscount

    with contextlib.redirect_stdout(io.StringIO()):
        sass = sasscount.main(["--match", "probe"])
    nf, dm = sass["dma_probe_kernel<1>"], sass["dma_probe_kernel<2>"]
    check(nf["LDG"] > 0 and nf["LDG"] == dm["LDG"],
          f"P1 noflush lost its loads: LDG {nf['LDG']}, dma's {dm['LDG']}")
    sass_text = "; ".join(
        f"{n}: {c['all']} instructions, LDG {c['LDG']}, STG {c['STG']}, "
        f"LDL {c['LDL']}, STL {c['STL']}"
        for n, c in sorted(sass.items())
        if n.startswith(("fused_decim", "probe_step", "dma_probe")))
    phase("build", f"{build_s:.1f} s for {', '.join(kernels.SOURCES)} "
          f"(one nvcc each, in parallel; sm_90a; fused_decim: one kernel, "
          f"its 11 epilogues and the K1e planar head chosen per launch, "
          f"finish: 11 epilogues 'from z' + the fused mode at 16, 18 and "
          f"19 taps per phase, its epilogue chosen per launch, probes: 6 P1 "
          f"modes + 6 P2 rung kernels on K1's body: dma, unpack, cas0a, "
          f"cas0, quant NONE, quant TPDF); K1 {K1_PTXAS[0]} registers, "
          f"{K1_PTXAS[1]} spill, {K1_PTXAS[2]} stack; ptxas"
          f"{'' if kernels.BUILD_SECONDS else ' (of the earlier build)'}: "
          f"{ptxas_text}; g++ of native/src/njad.cc, flac.cc and dsdkit.cc "
          f"(the host library of NJAD, FLAC and the modulator) {host_s:.1f} "
          f"s; the tones' modulator (ops/dsm.py, native) equal to the "
          f"inline loop on 0.1 s of DSD64; SASS (tools/sasscount.py): "
          f"{sass_text}")
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
    # K1 takes the channel from the grid's y: ÷8 and ÷64 at 1, 3 and 6
    # channels (DSF carries 1-6)
    cells = [(*cell, 2) for cell in cells] + [
        (f"{name} {ch}ch", key, [(24, N), (24, T), (32, F)], ch)
        for ch in (1, 3, 6)
        for name, key in (("E DSD64->352.8k", (E, DsdRate.DSD64, 352800)),
                          ("E DSD128->88.2k", (E, DsdRate.DSD128, 88200)))]
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
    for name, key, epilogues, ch in cells:
        chain = get_chain(*key)
        r = fused.decimation(chain)
        tile = engine_tile(chain, key[1])
        taps = [torch.tensor(np.asarray(s.taps, dtype=np.float32), device=dev)
                for s in chain]
        xs = [torch.from_numpy(rng.integers(0, 256, (ch, tile),
                                            dtype=np.uint8)).to(dev)
              for _ in range(3)]
        steps = {ep: fused.make_fused_step(
            chain, StepConfig(channels=ch, tile_bytes=tile, bit_depth=ep[0],
                              dither=ep[1], level_db=-1.5), dev)
            for ep in epilogues}
        gain = fused._gain32(StepConfig(channels=ch, tile_bytes=tile,
                                        bit_depth=24, dither=N,
                                        level_db=-1.5))
        st = {ep: new_stats() for ep in epilogues}
        h = fused.init_fused_halo(chain, ch, dev)
        for t, x in enumerate(xs):
            k64 = philox.tile_key(7, t)
            y = fused.fused_decim_cascade(x, h, taps, chain, gain)
            yf = y.T.reshape(-1)
            for (bits, dither), step in steps.items():
                cfg = StepConfig(channels=ch, tile_bytes=tile, bit_depth=bits,
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
              f"{name} (÷{r}, {ch} channels, {tile} B/ch tiles, block_out "
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

    # 4. the 48k family: K1e, the tail, K2's two modes, the whole step ---------
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
    k2t_epilogues = [(24, N), (24, T), (32, N), (32, F)]  # the other chains
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
            table = rational.kernel_table(rp, dev)
            cfg0 = StepConfig(channels=2, tile_bytes=tile, bit_depth=24,
                              dither=T, level_db=-1.5)
            gain = fused._gain32(cfg0)
            step_eps = [(24, T)] + ([(32, F)] if name in fpd_chains else [])
            fin_eps = k2_epilogues if name in k2_chains else []
            tail_eps = k2_epilogues if name in k2_chains else k2t_epilogues
            steps = {ep: rational.make_rational_step(chain, StepConfig(
                channels=2, tile_bytes=tile, bit_depth=ep[0], dither=ep[1],
                level_db=-1.5), dev) for ep in step_eps}
            st_step = {ep: new_stats() for ep in step_eps}
            st_fin = {ep: new_stats() for ep in fin_eps}
            st_tail = {ep: new_stats() for ep in tail_eps}
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
                z, new_hist = rational.rational_tail_reference(yp, hist, rp)
                if t == 1:
                    zo = tail_oracle(yk.cpu().numpy(), hist.cpu().numpy(),
                                     rp.band, rp.nhist)
                    err = float(np.abs(z.cpu().numpy() - zo).max())
                    zm, hm = rational.rational_tail(yp, hist, band_t,
                                                    rp.nhist)
                    err_mm = float(np.abs(zm.cpu().numpy() - zo).max())
                    check(torch.equal(hm, new_hist),
                          f"{name}: the two tails' histories differ")
                    del zm, zo
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
                for (bits, dither) in tail_eps:
                    cfg = StepConfig(channels=2, tile_bytes=tile,
                                     bit_depth=bits, dither=dither,
                                     level_db=-1.5)
                    wk, pk = rational.finish_tail_cuda(yk, hist, table, rp,
                                                       gain, k64, cfg)
                    wr, pr = fused.finish_reference(z, gain, k64, cfg)
                    torch.cuda.synchronize()
                    check(torch.equal(wk, wr) and float(pk) == float(pr),
                          f"{name} K2t {bits}-bit {dither.name}: not equal "
                          f"to its plain version (peaks {float(pk)}, "
                          f"{float(pr)})")
                    tile_stats(st_tail[(bits, dither)], f"{name} K2t", wk,
                               pk, wr, pr, zf, bits, dither)
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
                    check(torch.equal(wk, wr) and float(pk) == float(pr),
                          f"{name} step {bits}-bit {dither.name}: not equal "
                          f"to its plain path")
                    tile_stats(st_step[(bits, dither)], f"{name} step", wk,
                               pk, wr, pr, zf, bits, dither)
                halo, hist = x[:, tile - halo.shape[1]:].contiguous(), new_hist
            check(head_eq, f"{name}: K1e is not bit-equal to the plain head")
            check(err < 2e-6 and err_mm < 2e-6,
                  f"{name}: tail {err} (matmul {err_mm}) from the f64 oracle")
            n_base = tile * 8 // rp.r_head
            phase("K1e-vs-plain", f"{name} (÷{rp.r_head} head, {tile} B/ch "
                  f"tiles, {n_base} head frames/ch): bit-equal on 3 tiles; "
                  f"tail vs f64 oracle: plain tree sums {err:.3g}, matmul "
                  f"{err_mm:.3g} (band {rp.band.shape}, nhist {rp.nhist}, "
                  f"{table.n_taps} taps per phase)")
            if fin_eps:
                parts = [verdict(f"{name} K2", b, d, st_fin[(b, d)])
                         for b, d in fin_eps]
                max_err["K2"] = max([max_err["K2"]] + [
                    st_fin[ep]["diff"] for ep in fin_eps])
                phase("K2-vs-plain", f"{name} ({n_base * 160 // 147} final "
                      f"frames/ch): " + "; ".join(parts))
            parts = [verdict(f"{name} K2t", b, d, st_tail[(b, d)])
                     for b, d in tail_eps]
            max_err["K2t"] = max([max_err["K2t"]] + [
                st_tail[ep]["diff"] for ep in tail_eps])
            phase("K2t-vs-plain", f"{name} (head samples -> wire bytes, "
                  f"{n_base // 147} band blocks/ch; wire bytes and peak "
                  f"equal to rational_tail_reference + finish_reference): "
                  + "; ".join(parts))
            parts = [verdict(f"{name} step", b, d, st_step[(b, d)])
                     for b, d in step_eps]
            phase("step-vs-plain", f"{name} (K1e + K2t against the plain "
                  f"head, tail and finish; wire bytes and peak equal): "
                  + "; ".join(parts))

    # K1e at 1, 3 and 6 channels: DSD64 -> 192k's ÷16 head, bit-equal
    chain = get_chain(E, DsdRate.DSD64, 192000)
    head = chain[:rational.rational_plan(chain).n_head]
    tile = engine_tile(chain, DsdRate.DSD64)
    taps = [torch.tensor(np.asarray(s.taps, dtype=np.float32), device=dev)
            for s in head]
    coefs = fused.kernel_coefs(head, dev)
    for ch in (1, 3, 6):
        halo = fused.init_fused_halo(head, ch, dev)
        for t in range(3):
            x = torch.from_numpy(rng.integers(0, 256, (ch, tile),
                                              dtype=np.uint8)).to(dev)
            yk = fused.fused_head_cuda(x, halo, coefs, head)
            yp = fused.fused_decim_cascade(x, halo, taps, head, 1.0)
            torch.cuda.synchronize()
            check(torch.equal(yk, yp), f"K1e at {ch} channels, tile {t}: "
                  f"not bit-equal to the plain head "
                  f"({float((yk - yp).abs().max())})")
            halo = x[:, tile - halo.shape[1]:].contiguous()
    phase("K1e-vs-plain", f"E DSD64->192k's ÷{fused.decimation(head)} head "
          f"at 1, 3 and 6 channels ({tile} B/ch tiles): bit-equal on 3 "
          f"tiles each")

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
    wk, pk, _s = rational.make_rational_step(chain, cfg, dev)(
        x, state, 5, n_valid)
    head = chain[:rp.n_head]
    taps = [torch.tensor(np.asarray(s.taps, dtype=np.float32), device=dev)
            for s in head]
    z, _h = rational.rational_tail_reference(
        fused.fused_decim_cascade(x, state[0], taps, head, 1.0), state[1],
        rp)
    wr, _p = fused.finish_reference(z, 1.0, 5, cfg, n_valid=n_valid)
    torch.cuda.synchronize()
    masked, whole = float(z[:, :n_valid].abs().max()), float(z.abs().max())
    check(torch.equal(wk, wr) and float(pk) == masked,
          f"48k partial tile: kernel peak {float(pk)} vs valid-prefix "
          f"{masked}, or other wire bytes")
    check(whole > float(pk) + 0.1, "48k partial tile: the pad did not ring")
    phase("K2t-vs-plain", f"partial final tile (DSD64->192k, n_valid "
          f"{n_valid} of {n_out} frames): step peak {float(pk):.6g} = plain "
          f"valid-prefix peak {masked:.6g}; whole fixed tile {whole:.6g}")

    tmp = Path(tempfile.mkdtemp(prefix="dsd2dxd_smoke_"))
    launches = {}
    # the streaming phases' files (sha256), walls and dBFS, for the
    # sharded phase
    stream_sha, stream_wall, stream_db = {}, {}, {}
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
        stream_sha["config 1"] = sha256(wav_path)
        stream_wall["config 1"] = wall
        wav_path.unlink()

        # 5b. e2e, mono: config 1's chain on a one-minute mono .dsf; then
        # 5 s at `-d N` mono against the same tone in stereo (the kernel's
        # channel is the grid's y: both channels of the stereo file and
        # the mono file's one must be the same samples)
        sec = 60
        src_m = tmp / "tone_dsd64_mono_60s.dsf"
        write_dsf(src_m, planes64[:1, :sec * DSD64_HZ // 8], DSD64_HZ)
        n_tiles = -(-(sec * DSD64_HZ // 8) // tile_bytes)
        fused.reset_launch_counts()
        t0 = time.perf_counter()
        rc = cli_run(["-o", "w", "-q", "-p", str(out_dir), str(src_m)])
        wall = time.perf_counter() - t0
        k1a = fused.MODE_LAUNCHES["K1a"]
        check(rc == 0, f"mono: CLI exited {rc}")
        check(k1a == fused.KERNEL_LAUNCHES == n_tiles,
              f"mono: K1a launched {k1a} times for {n_tiles} tiles")
        wav_m = out_dir / src_m.with_suffix(".wav").name
        with wave.open(str(wav_m)) as w:
            params = (w.getnchannels(), w.getsampwidth(), w.getframerate(),
                      w.getnframes())
            check(params == (1, 3, 352800, sec * 352800),
                  f"mono WAV params {params}")
            w.setpos(sec // 2 * 352800)
            pcm = s24(w.readframes(352800)).reshape(-1, 1)
        check(np.abs(pcm).max() > 1 << 20, "mono output is silent")
        peak_hz = fft_peak_hz(pcm, 352800)
        check(np.all(np.abs(peak_hz - 1000.0) < 2.0),
              f"mono FFT peak at {peak_hz} Hz")
        wav_m.unlink()
        pair = {}
        for ch in (1, 2):
            src5 = tmp / f"tone_dsd64_{ch}ch_5s.dsf"
            write_dsf(src5, planes64[:ch, :5 * DSD64_HZ // 8], DSD64_HZ)
            rc = cli_run(["-d", "N", "-o", "w", "-q", "-p", str(out_dir),
                          str(src5)])
            check(rc == 0, f"mono pair: CLI exited {rc}")
            out5 = out_dir / src5.with_suffix(".wav").name
            pair[ch] = s24(bytes(wav_payload(out5))).reshape(-1, ch)
            out5.unlink()
            src5.unlink()
        check(pair[1].shape == (5 * 352800, 1)
              and np.array_equal(pair[1][:, 0], pair[2][:, 0])
              and np.array_equal(pair[2][:, 0], pair[2][:, 1]),
              "mono `-d N`: not the samples of either stereo channel")
        phase("e2e", f"mono: CLI {sec} s DSD64 mono .dsf -> 24-bit 352.8k "
              f"TPDF WAV in {wall:.2f} s = {sec / wall:.1f} audio-s/s; "
              f"{n_tiles} tiles of {tile_bytes} B/ch, {k1a} K1a launches; "
              f"FFT peak {peak_hz.tolist()} Hz; 5 s at `-d N`: the mono "
              f"file's samples those of both stereo channels; card "
              f"[{label}]")
        src_m.unlink()

        # 6. e2e, integer 48k: the same .dsf -> 24-bit 96 kHz TPDF WAV -----
        chain = get_chain(E, DsdRate.DSD64, 96000)
        tile_bytes = engine_tile(chain, DsdRate.DSD64)
        n_tiles = -(-n64 // tile_bytes)
        fused.reset_launch_counts()
        t0 = time.perf_counter()
        rc = cli_run(["-o", "w", "-r", "96000", "-q", "-p", str(out_dir),
                      str(src)])
        wall = time.perf_counter() - t0
        k1e, k2 = fused.MODE_LAUNCHES["K1e"], fused.MODE_LAUNCHES["K2t"]
        check(rc == 0, f"CLI exited {rc}")
        check(k1e == k2 == fused.KERNEL_LAUNCHES == n_tiles
              and fused.MODE_LAUNCHES["K2"] == 0,
              f"K1e/K2t launched {k1e}/{k2} times for {n_tiles} tiles, K2 "
              f"'from z' {fused.MODE_LAUNCHES['K2']}")
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
              f"tiles of {tile_bytes} B/ch, {k1e} K1e + {k2} K2t launches; "
              f"FFT peak {peak_hz.tolist()} Hz; card [{label}]")
        src64 = src  # the level and sharded phases read it again
        stream_sha["96k"] = sha256(wav_path)
        stream_wall["96k"] = wall
        wav_path.unlink()

        # 7. e2e, config 2: raw interleaved DSD64 on stdin -> s24le on stdout
        chain = get_chain(E, DsdRate.DSD64, 176400)
        raw_in = tmp / "tone_dsd64_180s.dsd"
        raw_in.write_bytes(planes64.T.tobytes())
        raw_out = tmp / "out_176400.raw"
        tile_bytes = engine_tile(chain, DsdRate.DSD64)
        n_tiles = -(-n64 // tile_bytes)
        fused.reset_launch_counts()
        rc, wall = cli_stdin(cli_run, CONFIG2_ARGV, raw_in, raw_out)
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
        stream_wall["config 2"] = wall  # beside the host-tools ceilings
        raw_out.unlink()  # raw_in: the profile phase reads it again
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
        src128 = src  # config 3 and the sharded phase read it again
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
        launches["K2t"] = fused.MODE_LAUNCHES["K2t"]
        check(rc == 0, f"CLI exited {rc}")
        check(launches["K1e"] == launches["K2t"] == fused.KERNEL_LAUNCHES
              == n_tiles and fused.MODE_LAUNCHES["K2"] == 0,
              f"K1e/K2t launched {launches['K1e']}/{launches['K2t']} times "
              f"for {n_tiles} tiles, K2 'from z' "
              f"{fused.MODE_LAUNCHES['K2']}")
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
              f"{launches['K1e']} K1e + {launches['K2t']} K2t launches; FFT "
              f"peak {peak_hz.tolist()} Hz; card [{label}]")
        stream_sha["config 4"] = sha256(aifc_path)
        stream_wall["config 4"] = wall
        src256 = src  # the sharded phase reads it again
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

        # 10-12 read the Converter behind each CLI run: its stats (tiles,
        # the drain thread's seconds in its sink) and its dBFS
        from dsd2dxd_tpu_torch.cli import dsd_levels
        from dsd2dxd_tpu_torch.cli.dsd2dxd import worker_count
        from dsd2dxd_tpu_torch.formats.dsf import write_dsf as write_tagged
        from dsd2dxd_tpu_torch.formats.flac_decode import decode_flac
        from dsd2dxd_tpu_torch.formats.id3 import Id3Frame, Id3Tag

        runs = []  # (file name, dBFS or None, stats) of each Converter run
        check_level = engine.Converter.check_level
        do_conversion = engine.Converter.do_conversion

        def recorded_level(self, *a, **k):
            db = check_level(self, *a, **k)
            runs.append((self.file_name(), db, self.stats))
            return db

        def recorded_conversion(self, *a, **k):
            do_conversion(self, *a, **k)
            runs.append((self.file_name(), None, self.stats))

        engine.Converter.check_level = recorded_level
        engine.Converter.do_conversion = recorded_conversion

        def launched():
            return {m: n for m, n in fused.MODE_LAUNCHES.items() if n}

        # 10. e2e, the level check: dsd_levels on phase 5's .dsf ---------
        for rate in (352800, 96000):
            chain = get_chain(E, DsdRate.DSD64, rate)
            tile_bytes = engine_tile(chain, DsdRate.DSD64)
            n_tiles = -(-n64 // tile_bytes)
            runs.clear()
            fused.reset_launch_counts()
            err = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(err):
                rc = dsd_levels.run(["-q", "-r", str(rate), str(src64)])
            wall = time.perf_counter() - t0
            modes, k1 = launched(), fused.KERNEL_LAUNCHES
            check(rc == 0, f"dsd_levels exited {rc}: {err.getvalue()}")
            (_name, db, _stats), = runs
            lines = [ln for ln in err.getvalue().splitlines()
                     if "peak level" in ln]
            want = [f"{src64.name}: peak level = {db:.1f} dBFS",
                    f"Highest peak level: {db:.1f} dBFS"]
            check(lines == want, f"dsd_levels printed {lines}, not {want}")
            want_modes = ({"K1d": n_tiles} if rate == 352800
                          else {"K1e": n_tiles, "K2t": n_tiles})
            check(modes == want_modes and k1 == n_tiles,
                  f"level at {rate}: launches {modes}, K1 {k1} for "
                  f"{n_tiles} tiles")
            rc = cli_run(["-b", "32", "-d", "X", "-o", "w", "-r", str(rate),
                          "-q", "-p", str(out_dir), str(src64)])
            check(rc == 0, f"CLI exited {rc}")
            wav_path = out_dir / "tone_dsd64_180s.wav"
            x = np.frombuffer(wav_payload(wav_path), dtype="<f4")
            check(x.size == SECONDS * rate * 2, f"f32 WAV of {x.size} samples")
            xmax = float(np.abs(x).max())
            frame = int(np.abs(x).argmax()) // 2
            check(db == 20.0 * math.log10(xmax),
                  f"level at {rate}: {db!r} dBFS is not max |x| {xmax!r} of "
                  f"the f32 output")
            del x
            wav_path.unlink()
            phase("e2e", f"level: dsd_levels `-r {rate}` on the {SECONDS} s "
                  f"DSD64 .dsf: {lines[0]!r} in {wall:.2f} s = "
                  f"{SECONDS / wall:.1f} audio-s/s; {n_tiles} tiles of "
                  f"{tile_bytes} B/ch, launches {modes}; the peak "
                  f"{10 ** (db / 20):.9g} is max |x| {xmax!r} of `-b 32 -d X "
                  f"-o w` (frame {frame}); card [{label}]")
            stream_db[rate], stream_wall[f"level {rate}"] = db, wall

        # 11. e2e, BASELINE config 3: phase 8's .dsf -> 20-bit NJAD FLAC ---
        chain = get_chain(E, DsdRate.DSD128, 88200)
        tile_bytes = engine_tile(chain, DsdRate.DSD128)
        n_tiles = -(-n128 // tile_bytes)
        runs.clear()
        fused.reset_launch_counts()
        t0 = time.perf_counter()
        rc = cli_run(["-b", "20", "-d", "N", "-o", "F", "-r", "88200", "-q",
                      "-p", str(out_dir), str(src128)])
        wall = time.perf_counter() - t0
        modes, k1 = launched(), fused.KERNEL_LAUNCHES
        check(rc == 0, f"CLI exited {rc}")
        (_name, _db, stats), = runs
        check(modes == {"K1c": n_tiles, "K1d": n_tiles} and k1 == n_tiles,
              f"config 3: launches {modes}, K1 {k1} for {n_tiles} tiles")
        flac_path = out_dir / "tone_dsd128_180s.flac"
        info, _c, _p = flac_meta(flac_path)
        check(info[:4] == (88200, 2, 20, SECONDS * 88200),
              f"config 3: STREAMINFO {info[:4]}")
        rc = cli_run(["-b", "32", "-d", "X", "-o", "w", "-r", "88200", "-q",
                      "-p", str(out_dir), str(src128)])
        check(rc == 0, f"CLI exited {rc}")
        wav_path = out_dir / "tone_dsd128_180s.wav"
        x = np.frombuffer(wav_payload(wav_path), dtype="<f4").reshape(-1, 2)
        host = host_loader.load()
        state = host.njad_new(2)
        try:
            t0 = time.perf_counter()
            v = host.njad_quantize(state, x, 20)
            njad_s = time.perf_counter() - t0
        finally:
            host.njad_free(state)
        f = np.floor(x.astype(np.float64) * 2.0 ** 19)
        check(bool(((v == f) | (v == f + 1)).all()),
              "config 3: an NJAD sample is neither floor nor ceil of x 2^19")
        del f, x
        md5 = hashlib.md5(np.ascontiguousarray(
            v.astype("<i4").view(np.uint8).reshape(-1, 4)[:, :3])).digest()
        check(md5 == info[4], "config 3: the FLAC's MD5 is not that of the "
              "host NJAD of the f32 output")
        pcm = v[SECONDS // 2 * 88200:(SECONDS // 2 + 1) * 88200]
        check(np.abs(pcm).max() > 1 << 16, "output is silent")
        peak_hz = fft_peak_hz(pcm, 88200)
        check(np.all(np.abs(peak_hz - 1000.0) < 2.0),
              f"FFT peak at {peak_hz} Hz")
        del v, pcm
        phase("e2e", f"config 3: CLI `-b 20 -d N -o F -r 88200`, {SECONDS} s "
              f"DSD128 stereo .dsf -> 20-bit NJAD FLAC "
              f"({flac_path.stat().st_size / 1e6:.1f} MB; STREAMINFO "
              f"{info[:4]}; its MD5 that of the host NJAD of `-b 32 -d X`'s "
              f"f32 samples, each the floor or ceil of x 2^19) in "
              f"{wall:.2f} s = {SECONDS / wall:.1f} audio-s/s; {n_tiles} "
              f"tiles of {tile_bytes} B/ch, launches {modes}; drain thread "
              f"in its sink (NJAD, FLAC encode, write) {stats['write_s']:.2f}"
              f" s; host NJAD alone over the stream {njad_s:.2f} s = "
              f"{SECONDS / njad_s:.0f}x real time; FFT peak "
              f"{peak_hz.tolist()} Hz; card [{label}]")
        stream_sha["config 3"] = sha256(flac_path)
        stream_wall["config 3"] = wall
        for path in (wav_path, flac_path):
            path.unlink()

        # 12. e2e, BASELINE config 5: a recursive batch -> 24-bit FLAC ----
        album = tmp / "album"
        jpeg = (b"\xff\xd8\xff\xe0\x00\x10JFIF\x00" + bytes(range(256)) * 8
                + b"\xff\xd9")
        batch = [("disc1/a_dsd64.dsf", DsdRate.DSD64, 60, "K1a"),
                 ("disc1/b_dsd128.dsf", DsdRate.DSD128, 30, "K1b"),
                 ("disc2/c_dsd256.dsf", DsdRate.DSD256, 30, "K1b"),
                 ("disc2/d_dsd512.dsf", DsdRate.DSD512, 30, "K1c")]
        want_modes, audio5 = {}, 0
        for rel, rate, sec, mode in batch:
            path = album / rel
            path.parent.mkdir(parents=True, exist_ok=True)
            tag = Id3Tag(frames=[
                Id3Frame.text_frame("TIT2", path.stem),
                Id3Frame.text_frame("TPE1", "Smoke Artist"),
                Id3Frame.text_frame("TALB", "Smoke Album"),
                Id3Frame("APIC", b"\x00image/jpeg\x00\x03cover\x00" + jpeg)])
            planes = tone_planes(rate.hz, sec)
            write_tagged(path, planes, rate.hz, id3=tag.to_bytes())
            tile = engine_tile(get_chain(E, rate, 352800), rate)
            want_modes[mode] = (want_modes.get(mode, 0)
                                - (-planes.shape[1] // tile))
            audio5 += sec
            del planes
        out5, wav5 = tmp / "out5", tmp / "wav5"
        out5.mkdir()
        wav5.mkdir()
        workers = min(worker_count(), len(batch))
        check(workers >= 2, f"config 5: the CLI runs {workers} worker")
        runs.clear()
        fused.reset_launch_counts()
        t0 = time.perf_counter()
        rc = cli_run(["-R", "-o", "F", "-q", "-p", str(out5), str(album)])
        wall = time.perf_counter() - t0
        modes = launched()
        check(rc == 0, f"CLI exited {rc}")
        check(modes == want_modes and len(runs) == len(batch),
              f"config 5: launches {modes}, want {want_modes}; "
              f"{len(runs)} conversions")
        flac_runs = {name: st for name, _db, st in runs}
        rc = cli_run(["-R", "-o", "w", "-q", "-p", str(wav5), str(album)])
        check(rc == 0, f"CLI exited {rc}")
        parts, md5_5 = [], {}
        for rel, rate, sec, mode in batch:
            fpath = out5 / "album" / Path(rel).with_suffix(".flac")
            check(fpath.is_file(), f"config 5: no {fpath.relative_to(out5)}"
                  f" (tree: {sorted(str(q.relative_to(out5)) for q in out5.rglob('*'))})")
            info, comments, pictures = flac_meta(fpath)
            check(info[:4] == (352800, 2, 24, sec * 352800),
                  f"config 5 {rel}: STREAMINFO {info[:4]}")
            check((comments.get("TITLE"), comments.get("ARTIST"),
                   comments.get("ALBUM")) == (Path(rel).stem, "Smoke Artist",
                                             "Smoke Album"),
                  f"config 5 {rel}: VORBIS_COMMENT {comments}")
            check(pictures == [jpeg], f"config 5 {rel}: PICTURE blocks "
                  f"{[len(q) for q in pictures]} bytes")
            payload = wav_payload(wav5 / "album" / Path(rel).with_suffix(".wav"))
            check(hashlib.md5(payload).digest() == info[4],
                  f"config 5 {rel}: the FLAC's MD5 is not the WAV payload's")
            md5_5[rel] = info[4]
            mid = sec // 2 * 352800 * 6
            pcm = s24(payload[mid:mid + 352800 * 6]).reshape(-1, 2)
            peak_hz = fft_peak_hz(pcm, 352800)
            check(np.abs(pcm).max() > 1 << 20
                  and np.all(np.abs(peak_hz - 1000.0) < 2.0),
                  f"config 5 {rel}: FFT peak at {peak_hz} Hz")
            st = flac_runs[Path(rel).name]
            parts.append(f"{rel} ({rate.name} ÷{rate.hz // 352800}, {sec} s, "
                         f"{st['tiles']} tiles of {st['tile_bytes']} B/ch, "
                         f"{fpath.stat().st_size / 1e6:.1f} MB, FLAC encode "
                         f"and write on the drain thread {st['write_s']:.2f} "
                         f"s = {sec / st['write_s']:.0f}x real time, the "
                         f"stream's wall {st['elapsed_s']:.2f} s)")
            del payload
        phase("e2e", f"config 5: CLI `-R -o F -p OUT album/`, {len(batch)} "
              f"tagged stereo .dsf in two folders -> 24-bit 352.8k TPDF FLAC "
              f"on {workers} worker threads, {audio5} s of audio in "
              f"{wall:.2f} s = {audio5 / wall:.1f} audio-s/s; launches "
              f"{modes}; tree mirrored, STREAMINFO, TITLE/ARTIST/ALBUM and "
              f"the APIC bytes as PICTURE, MD5 = md5 of the file's `-o w` "
              f"payload, FFT peak at 1 kHz on each: " + "; ".join(parts)
              + f"; card [{label}]")
        shutil.rmtree(out5)
        shutil.rmtree(wav5)

        # the full decode of one short FLAC: 20-bit TPDF (K1d) -----------
        src = tmp / "tone_dsd128_5s.dsf"
        write_dsf(src, tone_planes(hz128, 5), hz128)
        chain = get_chain(E, DsdRate.DSD128, 88200)
        n_tiles = -(-5 * hz128 // 8 // engine_tile(chain, DsdRate.DSD128))
        fused.reset_launch_counts()
        t0 = time.perf_counter()
        rc = cli_run(["-b", "20", "-o", "F", "-r", "88200", "-q", "-p",
                      str(out_dir), str(src)])
        wall = time.perf_counter() - t0
        modes = launched()
        check(rc == 0 and modes == {"K1c": n_tiles, "K1d": n_tiles},
              f"CLI exited {rc}; launches {modes} for {n_tiles} tiles")
        rc = cli_run(["-b", "20", "-o", "w", "-r", "88200", "-q", "-p",
                      str(out_dir), str(src)])
        check(rc == 0, f"CLI exited {rc}")
        flac_path = out_dir / "tone_dsd128_5s.flac"
        t0 = time.perf_counter()
        st = decode_flac(flac_path.read_bytes())
        dec_s = time.perf_counter() - t0
        ref = s24(wav_payload(out_dir / "tone_dsd128_5s.wav"), 4).reshape(-1, 2)
        check(st.md5_ok and (st.sample_rate, st.bits_per_sample) == (88200, 20)
              and st.samples.shape == (5 * 88200, 2)
              and np.array_equal(st.samples, ref),
              f"5 s FLAC: md5_ok {st.md5_ok}, {st.samples.shape}, not the "
              f"WAV's samples >> 4")
        phase("e2e", f"FLAC decode: CLI `-b 20 -o F -r 88200` (TPDF), 5 s "
              f"DSD128 .dsf in {wall:.2f} s = {5 / wall:.1f} audio-s/s, "
              f"{n_tiles} tile(s), launches {modes}; decoded in "
              f"full by formats/flac_decode.py in {dec_s:.1f} s: MD5 good, "
              f"sample for sample the WAV payload >> 4; card [{label}]")

        # 12b. sharded: one stream in overlap-save tiles over a device list,
        # the CLI's round-robin over the cards, the C entries' device check
        from dsd2dxd_tpu_torch.filters.design import chain_ratio
        from dsd2dxd_tpu_torch.parallel import sharded
        from dsd2dxd_tpu_torch.utils.device import batch_devices

        n_cards = torch.cuda.device_count()
        lists = [("cuda:0 x 4", [dev] * 4)]
        if n_cards >= 2:
            lists.append((f"every card ({n_cards}, unpatched)", None))
        chain96 = get_chain(E, DsdRate.DSD64, 96000)
        chain192 = get_chain(E, DsdRate.DSD256, 192000)
        chain882 = get_chain(E, DsdRate.DSD128, 88200)
        n1 = -(-n64 // engine_tile(get_chain(E, DsdRate.DSD64, 352800),
                                  DsdRate.DSD64))
        n96 = -(-n64 // engine_tile(chain96, DsdRate.DSD64))
        n4 = -(-n256 // engine_tile(chain192, DsdRate.DSD256))
        n3 = -(-n128 // engine_tile(chain882, DsdRate.DSD128))
        # (name, CLI argv, output file, audio s, the launches it must make:
        # one K1, or K1e + K2t, per tile, and one K1e warm pass per 48k
        # tile after the first)
        shard_runs = [
            ("config 1", ["-o", "w", "-q", "-p", str(out_dir), str(src64)],
             out_dir / "tone_dsd64_180s.wav", SECONDS, {"K1a": n1}),
            ("96k", ["-o", "w", "-r", "96000", "-q", "-p", str(out_dir),
                     str(src64)],
             out_dir / "tone_dsd64_180s.wav", SECONDS,
             {"K1e": 2 * n96 - 1, "K2t": n96}),
            ("config 4", ["-b", "32", "-o", "C", "-r", "192000", "-q", "-p",
                          str(out_dir), str(src256)],
             out_dir / "tone_dsd256_60s.aifc", SECONDS_CONFIG4,
             {"K1e": 2 * n4 - 1, "K2t": n4}),
            ("config 3", ["-b", "20", "-d", "N", "-o", "F", "-r", "88200",
                          "-q", "-p", str(out_dir), str(src128)],
             out_dir / "tone_dsd128_180s.flac", SECONDS,
             {"K1c": n3, "K1d": n3})]
        real_stream_devices = engine.stream_devices
        sharded_launches = {}
        os.environ["DSD2DXD_SHARD_STREAM"] = "1"
        t_phase = time.perf_counter()
        try:
            for list_name, devs in lists:
                engine.stream_devices = (real_stream_devices if devs is None
                                         else lambda d=devs: d)
                want_devs = [str(d) for d in (devs or engine.stream_devices())]
                parts = []
                for name, argv, out_path, sec, want in shard_runs:
                    runs.clear()
                    fused.reset_launch_counts()
                    t0 = time.perf_counter()
                    rc = cli_run(argv)
                    wall = time.perf_counter() - t0
                    modes = launched()
                    check(rc == 0, f"sharded {name}: CLI exited {rc}")
                    (_n, _db, st_run), = runs
                    check(st_run["devices"] == want_devs,
                          f"sharded {name}: ran on {st_run['devices']}, not "
                          f"{want_devs}")
                    check(modes == want, f"sharded {name} over {list_name}: "
                          f"launches {modes}, want {want}")
                    digest = sha256(out_path)
                    check(digest == stream_sha[name],
                          f"sharded {name} over {list_name}: sha256 "
                          f"{digest} is not the streaming file's "
                          f"{stream_sha[name]}")
                    out_path.unlink()
                    if devs is not None:
                        for m, k in modes.items():
                            sharded_launches[m] = (sharded_launches.get(m, 0)
                                                   + k)
                    parts.append(
                        f"{name} {sec / wall:.1f} audio-s/s (streaming "
                        f"{sec / stream_wall[name]:.1f}), {st_run['tiles']} "
                        f"tiles, launches {modes}")
                runs.clear()
                fused.reset_launch_counts()
                err = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stderr(err):
                    rc = dsd_levels.run(["-q", "-r", "96000", str(src64)])
                wall = time.perf_counter() - t0
                modes = launched()
                check(rc == 0, f"sharded dsd_levels exited {rc}: "
                      f"{err.getvalue()}")
                (_n, db, _st), = runs
                check(db == stream_db[96000],
                      f"sharded level at 96k: {db!r} dBFS, streaming "
                      f"{stream_db[96000]!r}")
                check(modes == {"K1e": 2 * n96 - 1, "K2t": n96},
                      f"sharded level at 96k: launches {modes}")
                if devs is not None:
                    for m, k in modes.items():
                        sharded_launches[m] = sharded_launches.get(m, 0) + k
                parts.append(f"dsd_levels -r 96000 {db:.4f} dBFS = "
                             f"streaming, {SECONDS / wall:.1f} audio-s/s "
                             f"(streaming "
                             f"{SECONDS / stream_wall['level 96000']:.1f}), "
                             f"launches {modes}")
                phase("sharded", f"DSD2DXD_SHARD_STREAM=1 over {list_name} "
                      f"({', '.join(want_devs)}), through the CLI: each "
                      f"file's sha256 that of the streaming phase's: "
                      + "; ".join(parts) + f"; card [{label}]")
        finally:
            engine.stream_devices = real_stream_devices
            del os.environ["DSD2DXD_SHARD_STREAM"]
        src128.unlink()

        # round-robin: config 5's batch over every card
        cards = batch_devices()
        if n_cards >= 2:
            out_rr = tmp / "out_rr"
            out_rr.mkdir()
            runs.clear()
            t0 = time.perf_counter()
            rc = cli_run(["-R", "-o", "F", "-q", "-p", str(out_rr),
                          str(album)])
            wall = time.perf_counter() - t0
            check(rc == 0, f"round-robin: CLI exited {rc}")
            used = sorted({st_run["device"] for _n, _db, st_run in runs})
            check(used == sorted(str(d) for d in cards[:len(batch)]),
                  f"round-robin: files ran on {used}")
            for rel, *_ in batch:
                info, _c, _p = flac_meta(
                    out_rr / "album" / Path(rel).with_suffix(".flac"))
                check(info[4] == md5_5[rel], f"round-robin {rel}: MD5 "
                      f"differs from phase 12's")
            rr_text = (f"config 5's {len(batch)} files over {used} in "
                       f"{wall:.2f} s = {audio5 / wall:.1f} audio-s/s, every "
                       f"STREAMINFO MD5 phase 12's")
        else:
            rr_text = ("the cross-card run of config 5's batch needs a "
                       "second card: not run on this machine")
        shutil.rmtree(album)

        # the C entries refuse a device index other than their tensors'
        chain = get_chain(E, DsdRate.DSD64, 352800)
        cfg = StepConfig(channels=2, tile_bytes=4096, bit_depth=24,
                         dither=DitherType.NONE, level_db=0.0)
        xq = torch.zeros((2, 4096), dtype=torch.uint8, device=dev)
        hq = fused.init_fused_halo(chain, 2, dev)
        oq = torch.empty(4096 * 2 * 3, dtype=torch.uint8, device=dev)
        pq = fused._kernel_params(chain, cfg, hq.shape[1], 0, False, 4096)
        before = fused.KERNEL_LAUNCHES
        try:
            fused._launch_decim(xq, hq, fused.kernel_coefs(chain, dev), oq,
                                None, pq, ("K1a",), device_index=n_cards)
            fail(f"a K1 launch expecting device {n_cards} ran on {dev}")
        except RuntimeError as e:
            refused = str(e)
        check("CUDA error 101" in refused and fused.KERNEL_LAUNCHES == before,
              f"device check: {refused}")

        # make_sharded_convert on random B=2, T=2 tiles against the plain
        # versions of the same tiles (the CPU's bodies)
        msc, rng_s = [], np.random.default_rng(88)
        for key in ((E, DsdRate.DSD64, 352800), (E, DsdRate.DSD64, 96000)):
            chain = get_chain(*key)
            tile = (8192 if rational.rational_head_len(chain) is None
                    else 4 * rational.rational_plan(chain).unit_bits // 8)
            cfg = StepConfig(channels=2, tile_bytes=tile, bit_depth=24,
                             dither=DitherType.TPDF, level_db=-1.0)
            fn, halo = sharded.make_sharded_convert(chain, cfg, [dev] * 4,
                                                    2, 2)
            fn_cpu, _ = sharded.make_sharded_convert(
                chain, cfg, [torch.device("cpu")] * 4, 2, 2)
            x = rng_s.integers(0, 256, (2, 2, 2, halo + tile),
                               dtype=np.uint8)
            keys = np.array([[philox.tile_key(7, 2 * b + t) for t in range(2)]
                             for b in range(2)], dtype=np.uint64)
            n_keep = int(tile * 8 * chain_ratio(chain))
            valids = np.array([[n_keep, n_keep], [n_keep, n_keep // 3]])
            fused.reset_launch_counts()
            got, pk = fn(x, keys, valids)
            k1 = fused.KERNEL_LAUNCHES
            want, pk_cpu = fn_cpu(x, keys, valids)
            d = (got.long() - want.long()).abs()
            same = float((d == 0).double().mean())
            check(tuple(got.shape) == (2, 2, n_keep, 2)
                  and int(d.max()) <= TOL_DITHER_LSB and same >= 0.999
                  and abs(pk - pk_cpu) < 1e-4 and k1 >= 4,
                  f"make_sharded_convert {key}: max diff {int(d.max())} LSB, "
                  f"{same:.5f} identical, peaks {pk} / {pk_cpu}, {k1} K1 "
                  f"launches")
            msc.append(f"{key[2] // 1000}k {int(d.max())} LSB max, "
                       f"{100 * same:.3f} % identical, {k1} K1 launches")
        phase("sharded", f"round-robin: batch_devices() = "
              f"{[str(d) for d in cards]}; {rr_text}. Device check: a K1 "
              f"launch expecting device {n_cards} raised ({refused}). "
              f"make_sharded_convert, B=2 x T=2 random tiles at 24-bit TPDF "
              f"over cuda:0 x 4 against the plain bodies: "
              + "; ".join(msc) + f". Phase wall "
              f"{time.perf_counter() - t_phase:.1f} s; card [{label}]")
        engine.Converter.check_level = check_level
        engine.Converter.do_conversion = do_conversion

        # 12c. host-tools: the port's host tools through their entry points
        host_tools(tmp, src64, n1, out_dir, stream_sha["config 1"], {
            "config 1": SECONDS / stream_wall["config 1"],
            "config 2": SECONDS / stream_wall["config 2"],
            "config 4": SECONDS_CONFIG4 / stream_wall["config 4"]}, label)

        # 12d. profile: DSD2DXD_PROFILE_DIR's traces of configs 1, 2 and 4
        # and of one sharded run
        n2 = -(-n64 // engine_tile(get_chain(E, DsdRate.DSD64, 176400),
                                  DsdRate.DSD64))
        profile_phase(tmp, [
            ("config 1", ["-o", "w", "-q", "-p", str(out_dir), str(src64)],
             None, out_dir / "tone_dsd64_180s.wav", SECONDS,
             {"fused_decim_kernel": n1}, stream_sha["config 1"]),
            ("config 2", CONFIG2_ARGV, raw_in, tmp / "out_176400.raw",
             SECONDS, {"fused_decim_kernel": n2}, None),
            ("config 4", ["-b", "32", "-o", "C", "-r", "192000", "-q", "-p",
                          str(out_dir), str(src256)],
             None, out_dir / "tone_dsd256_60s.aifc", SECONDS_CONFIG4,
             {"fused_decim_kernel": n4, "finish_tail_kernel": n4},
             stream_sha["config 4"])], [dev] * 4, label)
        for path in (src64, src256, raw_in):
            path.unlink()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 12e. bench: tools/bench.py's modes, entry() and dryrun_multichip(4)
    bench_launches = bench_phase(label)

    # 13. probes: P1 (dmabench) and P2 (floorstrip) ---------------------------
    from dsd2dxd_tpu_torch import tools
    from dsd2dxd_tpu_torch.tools import dmabench, floorstrip
    from dsd2dxd_tpu_torch.tools.lightspeed import bound_ms, k1_work, k2t_work

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
          f"stereo each: exact (noflush: the last block's values); the "
          f"library calls of noop, dma, halo0, contig and bspec equal the "
          f"plain version")

    # P2: every rung against its plain version on both ladders' chains
    p2_err, p2_plain, p2_in = {}, {}, {}
    for cname in floorstrip.CHAINS:
        chain_p, cfg_p, bo_p = floorstrip.probe_config(16, None, cname)
        taps_p = [torch.tensor(np.asarray(s.taps, dtype=np.float32),
                               device=dev) for s in chain_p]
        halo_p = torch.from_numpy(rng.integers(
            0, 256, (2, fused.chain_halo_bytes(chain_p)),
            dtype=np.uint8)).to(dev)
        cfgs = {d: dataclasses.replace(cfg_p, dither=d)
                for d in floorstrip.QUANT_DITHERS}
        steps = {floorstrip.kernel_name(r, d): (r, cfgs[d],
                 floorstrip.make_probe_step(chain_p, cfgs[d], r, dev, bo_p))
                 for r in floorstrip.KERNEL_RUNGS
                 for d in floorstrip.QUANT_DITHERS
                 if r == "quant" or d is T}
        full_p = floorstrip.make_probe_step(chain_p, cfg_p, "full", dev, bo_p)
        full_st = new_stats()
        xs_p, q_errs, y = [], [], None
        for t in range(2):
            x = torch.from_numpy(rng.integers(0, 256, (2, cfg_p.tile_bytes),
                                              dtype=np.uint8)).to(dev)
            xs_p.append(x)
            key = philox.tile_key(14, t)
            n_valid = cfg_p.tile_bytes * 8 // fused.decimation(chain_p) - 9
            for kname, (rung, cfg_k, step_k) in steps.items():
                ko, kp = step_k(x, halo_p, key, n_valid)
                ro, rp = floorstrip.probe_step_reference(
                    x, halo_p, taps_p, chain_p, cfg_k, rung, bo_p, key,
                    n_valid)
                torch.cuda.synchronize()
                d = (ko.double() - ro.double()).abs()
                err = float(d.max())
                p2_err[(cname, kname)] = max(p2_err.get((cname, kname), 0.0),
                                             err)
                if kname == "cas0":
                    y = ro
                if kname == "quant TPDF":
                    same = float((d == 0).double().mean())
                    check(err <= TOL_DITHER_LSB and same >= 0.999,
                          f"P2 {cname} quant TPDF: {err} LSB, {same:.5f} "
                          f"identical")
                    f = y.double() * 2.0 ** 23
                    e = ko.double() - f
                    q_errs.append(e[f.abs() < 2 ** 23 - 4])
                else:
                    check(err == 0.0, f"P2 {cname} {kname}: kernel differs "
                          f"from its plain version by {err}")
                check((kp is None) == (rp is None)
                      and (kp is None or float(kp) == float(rp)),
                      f"P2 {cname} {kname}: peak {kp} vs {rp}")
                del ko, ro, d
            wk, pk, hk = full_p(x, halo_p, key)
            wr, pr, _hr = fused.fused_decim_reference(x, halo_p, key, taps_p,
                                                      chain_p, cfg_p)
            torch.cuda.synchronize()
            check(torch.equal(hk, x[:, x.shape[1] - halo_p.shape[1]:]),
                  f"P2 {cname} full: new halo differs")
            tile_stats(full_st, f"P2 {cname} full", wk, pk, wr, pr,
                       y.T.reshape(-1), 24, T)
            del wk, wr
        full_text = verdict(f"P2 {cname} full", 24, T, full_st)
        e = torch.cat(q_errs)
        q_rms, q_mean = float(e.pow(2).mean().sqrt()), float(e.mean())
        check(0.45 < q_rms < 0.55 and abs(q_mean) < 0.01,
              f"P2 {cname} quant TPDF error RMS {q_rms}, mean {q_mean}")
        del e, q_errs, y
        phase("probes", f"P2 vs plain on {cname} (÷"
              f"{fused.decimation(chain_p)}, taps "
              f"{[s.n_taps for s in chain_p]}, K1's block_out {bo_p}), 2 "
              f"tiles of {cfg_p.tile_bytes} B/ch stereo, a random halo, "
              f"n_valid 9 short: dma, unpack, cas0a, cas0, quant NONE "
              f"bit-equal (peaks too); quant 24-bit TPDF max "
              f"{p2_err[(cname, 'quant TPDF')]:g} LSB, error RMS "
              f"{q_rms:.4f} mean {q_mean:+.5f}; full (K1) vs "
              f"fused_decim_reference {full_text}")
        # the plain versions' times, per tile
        for kname, (rung, cfg_k, _s) in steps.items():
            p2_plain[(cname, kname)] = ev_ms(
                lambda i, r=rung, c=cfg_k: floorstrip.probe_step_reference(
                    xs_p[i], halo_p, taps_p, chain_p, c, r, bo_p, 7), 2)
        p2_in[cname] = (chain_p, cfg_p.tile_bytes)
        del xs_p
        torch.cuda.empty_cache()

    # the P1 plain versions' times, per 16 MiB/ch stereo tile
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
    torch.cuda.empty_cache()

    # both tools through their entry points, the launch counts around each
    dmabench.reset_launch_counts()
    fused.reset_launch_counts()
    p1 = dmabench.main(["--tile-mib", "16", "--reps", "8"])
    p1_launches = dict(dmabench.LAUNCHES)
    check(all(p1_launches[m] > 0 for m in dmabench.KERNEL_MODES)
          and fused.KERNEL_LAUNCHES == 0,
          f"P1 modes not launched by dmabench: {p1_launches}")
    for bb in p1:
        nf, dm = p1[bb]["med_ms"]["noflush"], p1[bb]["med_ms"]["dma"]
        check(nf <= dm, f"P1 at block {bb} B: noflush {nf:.4f} ms is slower "
              f"than dma {dm:.4f} ms (it is dma's copy without its output "
              f"stream)")
    phase("probes", "P1 noflush <= dma at every block: " + ", ".join(
        f"{bb} B {p1[bb]['med_ms']['noflush']:.4f} <= "
        f"{p1[bb]['med_ms']['dma']:.4f} ms" for bb in p1)
        + f"; card [{label}]")
    p2, p2_launches, p2_full = {}, {}, {}
    for cname in floorstrip.CHAINS:
        floorstrip.reset_launch_counts()
        fused.reset_launch_counts()
        p2[cname] = floorstrip.main(["--chain", cname, "--tile-mib", "16",
                                     "--reps", "8"])
        p2_launches[cname] = dict(floorstrip.LAUNCHES)
        p2_full[cname] = fused.KERNEL_LAUNCHES
        check(all(v > 0 for v in p2_launches[cname].values())
              and p2_full[cname] > 0,
              f"P2 kernels not launched by floorstrip on {cname}: "
              f"{p2_launches[cname]}, full {p2_full[cname]}")
        res = p2[cname]
        full_max = max(res["ms"]["full"]) / tools.STAGED_TILES
        rows_txt, prev = [], 0.0
        for r, ms in res["med_ms"].items():
            f_ms = res["floor"][r][0]
            rows_txt.append(
                f"{r} {ms:.4f} ms ({ms - prev:+.4f}; floor {f_ms:.4f} by "
                f"{res['floor'][r][1]}, {f_ms / ms * 100:.1f} %"
                + (", over full's slowest rep" if r != "full"
                   and ms > full_max else "") + ")")
            prev = ms
        phase("probes", f"P2 ladder on {cname} through floorstrip's entry "
              f"point, ms per {res['tile']} B/ch stereo tile (8 reps of 8 "
              f"staged tiles; full's reps "
              f"{min(res['ms']['full']) / tools.STAGED_TILES:.4f}-"
              f"{full_max:.4f}): " + "; ".join(rows_txt)
              + f"; launches {p2_launches[cname]} + {p2_full[cname]} K1 "
              f"(full); card [{label}]")
    torch.cuda.empty_cache()
    p1_ms = {m: round(v, 4) for m, v in p1_plain.items()}
    p2_ms = {f"{c} {k}": round(v, 4) for (c, k), v in p2_plain.items()}
    phase("probes", f"timed through the entry points: dmabench launches "
          f"{p1_launches}; plain ms per tile: P1 at block 2048 B {p1_ms}, "
          f"P2 {p2_ms}; P1's library calls at block 2048 B "
          f"{ {m: round(v, 4) for m, v in p1_lib.items()} }; card [{label}]")

    # K2 "from z" through its tool's entry point: no conversion launches it
    # since the step takes K2t
    from dsd2dxd_tpu_torch.tools import finishsweep

    fused.reset_launch_counts()
    sweep = finishsweep.main(["--frames", "512,2048", "--reps", "2"])
    launches["K2"] = fused.MODE_LAUNCHES["K2"]
    check(launches["K2"] > 0 and fused.MODE_LAUNCHES["K2t"] == 0
          and fused.KERNEL_LAUNCHES == 0,
          f"finishsweep launched K2 'from z' {launches['K2']} times, K2t "
          f"{fused.MODE_LAUNCHES['K2t']}, K1 {fused.KERNEL_LAUNCHES}")
    torch.cuda.empty_cache()
    phase("probes", f"finishsweep through its entry point: {launches['K2']} "
          f"K2 'from z' launches; ms per tile at 512 / 2048 frames per run "
          f"(fastest of the two: {finishsweep.fastest(sweep)}, in use: "
          f"{fused.FINISH_RUN_FRAMES}): "
          + ", ".join(f"{tag} {sweep[512][tag]:.4f} / {sweep[2048][tag]:.4f}"
                      for tag in sweep[512]) + f"; card [{label}]")

    probe_rows = []
    g = p1[2048]["geometry"]
    for m in dmabench.KERNEL_MODES:
        b_ms, b_by = bound_ms(
            (dmabench.bound_bytes(m, g, 2, p1[2048]["n_blocks"]), 0, 0))
        probe_rows.append({
            "name": f"P1 dma_probe ({m}; block 2048 B/ch, halo "
                    f"{g.halo_words * 4} B)",
            "route": "cuda", "source": "dsd2dxd_tpu_torch/csrc/probes.cu",
            "replaces": "tools/dmabench.py:96 (_probe, pallas_call :181)",
            "launches": p1_launches[m],
            "launches_from": "tools/dmabench.py (no conversion launches it)",
            "max_abs_err": p1_err[m],
            "ms": p1[2048]["med_ms"][m], "plain_ms": p1_plain[m],
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": p1_lib.get(m)})
    for cname, (chain_p, tile_p) in p2_in.items():
        for kname in floorstrip.KERNELS:
            b_ms, b_by = bound_ms(floorstrip.rung_work(kname, chain_p,
                                                        tile_p, 2))
            probe_rows.append({
                "name": f"P2 probe_step ({kname}; {cname}, block_out "
                        f"{p2[cname]['block_out']}; K1's body cut short)",
                "route": "cuda",
                "source": "dsd2dxd_tpu_torch/csrc/probes.cu + "
                          "csrc/decim_body.cuh",
                "replaces": "tools/floorstrip.py:46 (_probe_step, "
                            "pallas_call :226)",
                "launches": p2_launches[cname][kname],
                "launches_from": "tools/floorstrip.py (no conversion "
                                 "launches it)",
                "max_abs_err": p2_err[(cname, kname)],
                "ms": p2[cname]["med_ms"][kname],
                "plain_ms": p2_plain[(cname, kname)],
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})

    # 14. timing at bench.py's tile -------------------------------------------
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

    timed, bounds, library_ms = {}, {}, {}
    # the timing phase's xRT per 24-bit TPDF cell, for the lightspeed phase
    timing_xrt = {}
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
        if bits == 24:
            timing_xrt[f"{key[1].name}->{key[2]}"] = (
                tile * 8 / key[1].hz / k_ms * 1e3)
        frames = tile * 8 // fused.decimation(chain)
        bounds[mode] = bound_ms(k1_work(chain, frames, 2, bits, T,
                                        fused.chain_halo_bytes(chain)))
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
        table = rational.kernel_table(rp, dev)
        halo, hist = rational.init_rational_state(chain, 2, dev)
        ys = [fused.fused_head_cuda(x, halo, coefs, head) for x in xs]
        zs = [rational.rational_tail(y, hist, band_t, rp.nhist)[0]
              for y in ys]
        keys = [philox.tile_key(12, i) for i in range(n)]
        head_k, head_p, head_runs = alternate(
            lambda i: fused.fused_decim_cascade(xs[i], halo, taps, head, 1.0),
            lambda i: fused.fused_head_cuda(xs[i], halo, coefs, head), n)

        def matmul_tail(i):
            return rational.rational_tail(ys[i], hist, band_t, rp.nhist)

        tail_ms = (ev_ms(matmul_tail, n) + ev_ms(matmul_tail, n)) / 2
        fin, fused_t, route = {}, {}, {}
        for bits, dither in ((24, N), (24, T), (32, F)):
            cfg = StepConfig(channels=2, tile_bytes=tile, bit_depth=bits,
                             dither=dither, level_db=0.0)
            ep = (bits, dither)
            fin[ep] = alternate(
                lambda i, c=cfg: fused.finish_reference(zs[i], 1.0, keys[i], c),
                lambda i, c=cfg: fused.finish_cuda(zs[i], 1.0, keys[i], c), n)

            def plain_tail(i, c=cfg):
                z, _h = rational.rational_tail_reference(ys[i], hist, rp)
                return fused.finish_reference(z, 1.0, keys[i], c)

            def matmul_route(i, c=cfg):
                z, _h = rational.rational_tail(ys[i], hist, band_t, rp.nhist)
                return fused.finish_cuda(z, 1.0, keys[i], c)

            def fused_route(i, c=cfg):
                return rational.finish_tail_cuda(ys[i], hist, table, rp, 1.0,
                                                 keys[i], c)

            fused_t[ep] = alternate(plain_tail, fused_route, n)
            # the two routes from the head's samples to the wire bytes, in
            # turns: matmul + K2 "from z", K2t, K2t, matmul + K2 "from z"
            route[ep] = alternate(matmul_route, fused_route, n)
            check(route[ep][0] < route[ep][1],
                  f"48k {name} {bits}-bit {dither.name}: the fused mode "
                  f"({route[ep][0]:.3f} ms) is not faster than matmul + K2 "
                  f"'from z' ({route[ep][1]:.3f} ms), yet the step takes it")
        # fewer bytes, the same Philox calls: which of the two bounds holds
        cfg = StepConfig(channels=2, tile_bytes=tile, bit_depth=16,
                         dither=T, level_db=0.0)
        fin[(16, T)] = alternate(
            lambda i, c=cfg: fused.finish_reference(zs[i], 1.0, keys[i], c),
            lambda i, c=cfg: fused.finish_cuda(zs[i], 1.0, keys[i], c), n)
        cfg = StepConfig(channels=2, tile_bytes=tile, bit_depth=24,
                         dither=T, level_db=0.0)
        step = rational.make_rational_step(chain, cfg, dev)

        def plain_step(i, _cfg=cfg):
            y = fused.fused_decim_cascade(xs[i], halo, taps, head, 1.0)
            z, _h = rational.rational_tail_reference(y, hist, rp)
            return fused.finish_reference(z, 1.0, keys[i], _cfg)

        step_k, step_p, step_runs = alternate(
            plain_step, lambda i: step(xs[i], (halo, hist), keys[i]), n)
        audio = tile * 8 / key[1].hz
        timing_xrt[f"{key[1].name}->{key[2]}"] = audio / step_k * 1e3
        n_base = tile * 8 // rp.r_head
        n_out = n_base * 160 // 147
        n_taps = table.n_taps
        # K2 "from z" reads the tail's samples (T = 0); K2t the head's, its
        # history and its table (lightspeed.k2t_work)
        b_none, b_tpdf, b_fpd, b_16 = (
            bound_ms(k2t_work(n_out, 0, 2, bits, dither, in_values=n_out))
            for bits, dither in ((24, N), (24, T), (32, F), (16, T)))
        table_bytes = (table.coefs.numel() + table.offs.numel()) * 4
        bt_none, bt_tpdf, bt_fpd = (
            bound_ms(k2t_work(n_out, n_taps, 2, bits, dither,
                              in_values=n_base + rp.p_in,
                              table_bytes=table_bytes))
            for bits, dither in ((24, N), (24, T), (32, F)))
        # the tail alone: the dense product's 147 + nhist entries per
        # phase, or the band's T
        b_tail_dense, b_tail_need = (
            bound_ms(k2t_work(n_out, taps_n, 2, None, in_values=n_base))
            for taps_n in (rp.band.shape[1], n_taps))
        if key[1] is DsdRate.DSD64:
            timed["K1e"] = (head_k, head_p)
            timed["K2"] = fin[(24, T)][:2]
            timed["K2t"] = fused_t[(24, T)][:2]
            library_ms["K2t"] = tail_ms
            bounds["K1e"] = bound_ms(k1_work(
                head, n_base, 2, None,
                halo_bytes=fused.chain_halo_bytes(head)))
            bounds["K2"] = b_tpdf
            bounds["K2t"] = bt_tpdf

        def fmt(t, b):
            return (f"{t[0]:.4f} ms (runs {[round(v, 4) for v in t[2]['kernel']]}"
                    f", bound {b[0]:.4f} by {b[1]}, {b[0] / t[0] * 100:.1f} %) "
                    f"vs plain {t[1]:.3f} ms")

        phase("timing", f"48k {name}, {tile} B/ch stereo tile ({audio:.2f} s "
              f"audio, ÷{rp.r_head} head, {n_out} final frames/ch, {n_taps} "
              f"taps per phase): K1e {head_k:.3f} ms (runs "
              f"{head_runs['kernel']}) vs plain head {head_p:.3f} ms (runs "
              f"{head_runs['plain']}); tail as one torch.matmul (the "
              f"library call) {tail_ms:.4f} ms (bound {b_tail_dense[0]:.4f} "
              f"by {b_tail_dense[1]} for the dense product, "
              f"{b_tail_need[0]:.4f} by {b_tail_need[1]} for the band's "
              f"entries); K2 'from z' 24-bit NONE {fmt(fin[(24, N)], b_none)}"
              f", 24-bit TPDF {fmt(fin[(24, T)], b_tpdf)}, 16-bit TPDF "
              f"{fmt(fin[(16, T)], b_16)}, f32 FPD "
              f"{fmt(fin[(32, F)], b_fpd)}; K2t 24-bit NONE "
              f"{fmt(fused_t[(24, N)], bt_none)}, 24-bit TPDF "
              f"{fmt(fused_t[(24, T)], bt_tpdf)}, f32 FPD "
              f"{fmt(fused_t[(32, F)], bt_fpd)}; head samples -> wire bytes "
              f"by K2t against matmul + K2 'from z', in turns: 24-bit NONE "
              f"{route[(24, N)][0]:.4f} vs {route[(24, N)][1]:.4f} ms, 24-bit "
              f"TPDF {route[(24, T)][0]:.4f} vs {route[(24, T)][1]:.4f}, f32 "
              f"FPD {route[(32, F)][0]:.4f} vs {route[(32, F)][1]:.4f}; "
              f"whole step 24-bit TPDF {step_k:.3f} ms "
              f"({audio / step_k * 1e3:.0f} audio-s/s, runs "
              f"{step_runs['kernel']}) vs plain path {step_p:.3f} ms; "
              f"card [{label}]")
        del xs, ys, zs

    # 15. lightspeed: the device rate matrix of all 22 cells -----------------
    ls_launches = lightspeed_phase(timing_xrt, label)

    check("jax" not in sys.modules, "jax was loaded")
    jax_pkg = sorted(m for m in sys.modules if m.split(".")[0] == "dsd2dxd_tpu")
    check(not jax_pkg, f"modules of the JAX package were loaded: {jax_pkg}")
    check(all(launches[m] > 0 for m in ("K1a", "K1b", "K1c", "K1d", "K1e",
                                        "K2", "K2t", "÷128")),
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
            ("K2", "finish (K2 'from z': gain, peak, dither, quantize, wire "
             "bytes; 24-bit TPDF; the step takes K2t, so no conversion "
             "launches it: its launches are the finishsweep tool's timing "
             "loop, not a workload's)",
             "dsd2dxd_tpu_torch/csrc/finish.cu",
             "dsd2dxd_tpu/ops/fused.py:1019 (make_finish_planes, "
             "pallas_call :1120)"),
            ("K2t", "finish (K2t 'from the head's samples': the ×160/147 "
             "band out of shared memory, then K2's finish; 24-bit TPDF; "
             "library_ms: the tail alone as one torch.matmul)",
             "dsd2dxd_tpu_torch/csrc/finish.cu",
             "dsd2dxd_tpu/ops/fused.py:1019 (make_finish_planes, "
             "pallas_call :1120) with the XLA tail "
             "dsd2dxd_tpu/ops/phase.py (stage_apply_rational_natural)")]
    print(label)
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": src_file, "replaces": rep,
        "launches": launches[m],
        "launches_from": ("tools/finishsweep.py, a timing loop (0 launches "
                          "on the conversions)" if m == "K2"
                          else "the e2e conversions through the CLI"
                          + (f"; the sharded phase (DSD2DXD_SHARD_STREAM=1 "
                             f"over cuda:0 x 4): {sharded_launches[m]}"
                             if m in sharded_launches else "")),
        "launches_sharded": sharded_launches.get(m, 0),
        "launches_bench": bench_launches.get(m, 0),
        "launches_lightspeed": ls_launches.get(m, 0),
        "max_abs_err": max_err[m],
        "ms": timed[m][0], "plain_ms": timed[m][1],
        "bound_ms": bounds[m][0], "bound_by": bounds[m][1],
        # no one PyTorch call unpacks, cascades, dithers and packs
        "library_ms": library_ms.get(m)}
        for m, name, src_file, rep in rows] + probe_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
