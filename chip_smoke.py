#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (dsd2dxd_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, one line each; any failed check
exits non-zero:

1. env: Python, torch and CUDA versions, nvcc, the card (nvidia-smi).
2. build: compiles the fused ÷8 kernel (K1a) from csrc/ with nvcc.
3. kernel vs plain: E, X, D at DSD64 -> 352.8k and E at DSD128 -> 705.6k,
   two channels, three streamed tiles of the size the engine gives each
   (4 MiB/ch at DSD64, 8 MiB/ch at DSD128), level -1.5 dB. NONE dither
   within 5 LSB of the plain PyTorch version, peak within 1e-4; TPDF with
   the same key within 1 LSB and >= 99.9 % identical; TPDF error against the
   undithered f32 * 2^23 with RMS 0.45-0.55 LSB, mean below 0.01 LSB, and
   other noise in every tile.
4. end to end: a three-minute DSD64 stereo 1 kHz tone .dsf through the
   port's CLI to a 24-bit 352.8 kHz TPDF WAV at the production tile;
   checks the WAV header, the frame count, the 1 kHz spectral peak and
   that the kernel ran once per tile.
5. timing: kernel and plain version per 16 MiB/ch stereo tile, CUDA
   events over 8 staged tiles, as audio-seconds per second.

Then the card's name and power limit, one JSON line on the kernels, and
the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

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
TOL_NONE_LSB = 5
TOL_TPDF_LSB = 1


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def phase(name: str, text: str) -> None:
    print(f"[{name}] {text}", flush=True)


# -- test signal: a DSD64 tone .dsf, written without the JAX package ---------

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
    ptxas = [ln.strip() for ln in kernels.BUILD_LOG.splitlines()
             if "registers" in ln or "spill" in ln]
    phase("build", f"{build_s:.1f} s for {', '.join(kernels.SOURCES)} "
          f"(sm_90a); ptxas: {' | '.join(ptxas) or 'cached'}")

    def decode(wire):
        b = wire.reshape(-1, 3).to(torch.int64)
        v = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        return v - (v >= (1 << 23)).to(torch.int64) * (1 << 24)

    # 3. kernel vs plain -----------------------------------------------------
    rng = np.random.default_rng(2026)
    cells = [("E DSD64->352.8k", (FilterType.EQUIRIPPLE, DsdRate.DSD64, 352800)),
             ("X DSD64->352.8k", (FilterType.XLD, DsdRate.DSD64, 352800)),
             ("D DSD64->352.8k", (FilterType.DSD2PCM, DsdRate.DSD64, 352800)),
             ("E DSD128->705.6k", (FilterType.EQUIRIPPLE, DsdRate.DSD128, 705600))]
    max_err_lsb = 0
    for name, key in cells:
        chain = get_chain(*key)
        # the tile the engine hands the kernel for this input rate
        tile = engine._tile_bytes_for(
            chain, engine._DEFAULT_TILE_TARGET * int(key[1]))
        taps = [torch.tensor(np.asarray(s.taps, dtype=np.float32), device=dev)
                for s in chain]
        xs = [torch.from_numpy(rng.integers(0, 256, (2, tile), dtype=np.uint8)
                               ).to(dev) for _ in range(3)]
        stats = {}
        for dither in (DitherType.NONE, DitherType.TPDF):
            cfg = StepConfig(channels=2, tile_bytes=tile, bit_depth=24,
                             dither=dither, level_db=-1.5)
            step = fused.make_fused_step(chain, cfg, dev)
            gain = fused._gain32(cfg)
            h = fused.init_fused_halo(chain, 2, dev)
            errs, noise, diff, same, n_tot, dpk = [], [], 0, 0, 0, 0.0
            for t, x in enumerate(xs):
                k64 = philox.tile_key(7, t)
                wk, pk, hk = step(x, h, k64)
                wr, pr, hr = fused.fused_div8_reference(x, h, k64, taps,
                                                        chain, cfg)
                torch.cuda.synchronize()
                qk, qr = decode(wk), decode(wr)
                diff = max(diff, int((qk - qr).abs().max()))
                same += int((qk == qr).sum())
                n_tot += qk.numel()
                dpk = max(dpk, abs(float(pk) - float(pr)))
                check(torch.equal(hk, hr), f"{name}: new halo differs")
                if dither is DitherType.TPDF:
                    f = fused.fused_div8_cascade(x, h, taps, chain, gain)
                    f = f.T.reshape(-1).double() * (1 << 23)
                    e = qk.double() - f
                    noise.append(e[: 1 << 16].cpu())
                    errs.append(e[f.abs() < (1 << 23) - 4].cpu())
                h = hk
            stats[dither] = (diff, same / n_tot, dpk)
            if dither is DitherType.NONE:
                max_err_lsb = max(max_err_lsb, diff)
                check(diff <= TOL_NONE_LSB,
                      f"{name} NONE: kernel vs plain {diff} LSB > {TOL_NONE_LSB}")
            else:
                check(diff <= TOL_TPDF_LSB,
                      f"{name} TPDF: kernel vs plain {diff} LSB > {TOL_TPDF_LSB}")
                check(same / n_tot >= 0.999,
                      f"{name} TPDF: only {same / n_tot:.5f} identical")
                e = torch.cat(errs)
                rms = float(e.pow(2).mean().sqrt())
                mean = float(e.mean())
                check(0.45 < rms < 0.55, f"{name} TPDF: error RMS {rms} LSB")
                check(abs(mean) < 0.01, f"{name} TPDF: error mean {mean} LSB")
                check(not torch.equal(noise[0], noise[1])
                      and not torch.equal(noise[1], noise[2]),
                      f"{name} TPDF: tiles share noise")
            check(dpk <= 1e-4, f"{name} {dither.name}: peak differs by {dpk}")
        n_d, n_t = stats[DitherType.NONE], stats[DitherType.TPDF]
        phase("kernel-vs-plain",
              f"{name} ({tile} B/ch tiles): NONE max {n_d[0]} LSB "
              f"({n_d[1] * 100:.4f}% identical, "
              f"peak d {n_d[2]:.2e}); TPDF max {n_t[0]} LSB "
              f"({n_t[1] * 100:.4f}% identical), err RMS {rms:.4f} LSB, "
              f"mean {mean:+.5f} LSB")

    # 4. end to end through the CLI -------------------------------------------
    seconds = 180
    chain = get_chain(FilterType.EQUIRIPPLE, DsdRate.DSD64, 352800)
    tmp = Path(tempfile.mkdtemp(prefix="dsd2dxd_smoke_"))
    try:
        n = DSD64_HZ // 10  # 0.1 s = 100 periods of 1 kHz, tiled seamlessly
        one = np.stack([dsm_tone(1000.0, n, DSD64_HZ) for _ in range(2)])
        planes = np.tile(one, (1, seconds * 10))
        src = tmp / "tone_dsd64_180s.dsf"
        write_dsf(src, planes, DSD64_HZ)
        out_dir = tmp / "out"
        out_dir.mkdir()
        tile_bytes = engine._tile_bytes_for(chain, engine._DEFAULT_TILE_TARGET)
        n_tiles = -(-planes.shape[1] // tile_bytes)
        fused.KERNEL_LAUNCHES = 0
        t0 = time.perf_counter()
        rc = cli_run(["-o", "w", "-q", "-p", str(out_dir), str(src)])
        wall = time.perf_counter() - t0
        launches = fused.KERNEL_LAUNCHES
        check(rc == 0, f"CLI exited {rc}")
        check(launches == n_tiles,
              f"kernel launched {launches} times for {n_tiles} tiles")
        wav_path = out_dir / "tone_dsd64_180s.wav"
        with wave.open(str(wav_path)) as w:
            params = (w.getnchannels(), w.getsampwidth(), w.getframerate(),
                      w.getnframes())
            check(params == (2, 3, 352800, seconds * 352800),
                  f"WAV params {params}")
            w.setpos(90 * 352800)
            raw = np.frombuffer(w.readframes(352800), dtype=np.uint8)
        wav_mb = wav_path.stat().st_size / 1e6
        pcm = decode(torch.from_numpy(raw.copy())).numpy().reshape(-1, 2)
        check(np.all(np.isfinite(pcm)) and np.abs(pcm).max() > 1 << 20,
              "output is silent")
        spec = np.abs(np.fft.rfft(pcm.astype(np.float64), axis=0))
        peak_hz = np.fft.rfftfreq(pcm.shape[0], 1 / 352800)[spec.argmax(axis=0)]
        check(np.all(np.abs(peak_hz - 1000.0) < 2.0), f"FFT peak at {peak_hz} Hz")
        rate = seconds / wall
        phase("e2e", f"CLI {seconds} s DSD64 stereo ({src.stat().st_size / 1e6:.1f}"
              f" MB) -> 24-bit 352.8k TPDF WAV ({wav_mb:.1f} MB) in {wall:.2f} s "
              f"= {rate:.1f} audio-s/s; {n_tiles} tiles of {tile_bytes} B/ch, "
              f"{launches} kernel launches; FFT peak {peak_hz.tolist()} Hz; "
              f"card [{label}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 5. timing at bench.py's tile --------------------------------------------
    tile = 16 * 1024 * 1024
    cfg = StepConfig(channels=2, tile_bytes=tile, bit_depth=24,
                     dither=DitherType.TPDF, level_db=0.0)
    step = fused.make_fused_step(chain, cfg, dev)
    taps = [torch.tensor(np.asarray(s.taps, dtype=np.float32), device=dev)
            for s in chain]
    xs = [torch.from_numpy(rng.integers(0, 256, (2, tile), dtype=np.uint8)
                           ).to(dev) for _ in range(8)]

    def plain(x, h, k):
        return fused.fused_div8_reference(x, h, k, taps, chain, cfg)

    def per_tile_ms(fn) -> float:
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

    runs = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        runs[which].append(per_tile_ms(plain if which == "plain" else step))
    k_ms = sum(runs["kernel"]) / 2
    p_ms = sum(runs["plain"]) / 2
    audio_per_tile = tile * 8 / DSD64_HZ
    phase("timing", f"16 MiB/ch stereo tile ({audio_per_tile:.2f} s audio): "
          f"kernel {k_ms:.3f} ms ({audio_per_tile / k_ms * 1e3:.0f} audio-s/s, "
          f"runs {runs['kernel']}), plain {p_ms:.3f} ms "
          f"({audio_per_tile / p_ms * 1e3:.0f} audio-s/s, runs {runs['plain']}); "
          f"card [{label}]")

    check("jax" not in sys.modules, "jax was loaded")
    print(label)
    print(json.dumps({"kernels": [{
        "name": "fused_div8 (K1a)", "route": "cuda",
        "source": "dsd2dxd_tpu_torch/csrc/fused_div8.cu",
        "replaces": "dsd2dxd_tpu/ops/fused.py:287",
        "launches": launches, "max_abs_err": max_err_lsb,
        "ms": k_ms, "plain_ms": p_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
