"""PCM -> DSD delta-sigma modulation (test-signal synthesis).

The port's copy of ``dsd2dxd_tpu/ops/dsm.py``, byte for byte but for its
imports and ``dsm2_bits``'s dispatch: the native loop is the port's own
g++ build of ``native/src/dsdkit.cc`` (``native/loader.py``), and, as
everywhere in the port, nothing falls back to the Python loop when that
build fails (it raises ConfigError); ``native=False`` asks for the
Python loop by name.

The reference ships 1 kHz tone / pink-noise / impulse DSD fixtures but
six of them are stripped from the snapshot (.MISSING_LARGE_BLOBS,
SURVEY.md §4.2); this modulator synthesizes equivalents (and provides a
general PCM->DSD path the reference does not have).

A 2nd-order CIFB delta-sigma modulator at the DSD rate: in-band SNR at
OSR=64 is ~90 dB — ample for the tone/spectral oracles in tests/. The
inner loop is sequential by nature (quantizer feedback), so it runs on
host; a C fast path is used when the native extension is built.
"""

from __future__ import annotations

import numpy as np


def dsm2_bits(x: np.ndarray, native: bool = True) -> np.ndarray:
    """Modulate a PCM signal (float, |x| <= ~0.7 recommended, at the DSD
    sample rate) into DSD bits {0, 1} (1 = +1 pulse).

    2nd-order delta-sigma (Boser-Wooley), sequential host loop: the
    native one (``native/src/dsdkit.cc``), or with ``native=False`` the
    Python one, bit for bit the same.
    """
    if native:
        from dsd2dxd_tpu_torch.native.loader import load

        return load().dsm2_bits(np.asarray(x, dtype=np.float64))
    x = np.asarray(x, dtype=np.float64)
    s1 = 0.0
    s2 = 0.0
    out = []
    append = out.append
    for v in x.tolist():
        y = 1.0 if s2 >= 0.0 else -1.0
        append(1 if y > 0 else 0)
        s1 += 0.5 * (v - y)
        s2 += 0.5 * (s1 - y)
    return np.array(out, dtype=np.uint8)


def bits_to_bytes_msb(bits: np.ndarray) -> np.ndarray:
    """Pack {0,1} bits into bytes, MSB-first (canonical DSD byte order)."""
    bits = np.asarray(bits, dtype=np.uint8)
    pad = (-len(bits)) % 8
    if pad:
        # Pad with alternating idle pattern to stay DC-free.
        idle = np.tile(np.array([1, 0], dtype=np.uint8), pad // 2 + 1)[:pad]
        bits = np.concatenate([bits, idle])
    return np.packbits(bits)


def synth_tone_dsd(freq_hz: float, seconds: float, dsd_rate_hz: int,
                   amplitude: float = 0.5, channels: int = 1,
                   phase_per_ch: float = 0.0) -> np.ndarray:
    """Synthesize a sine-tone DSD stream.

    Returns (channels, n_bytes) uint8 planes, MSB-first.
    """
    n = int(round(seconds * dsd_rate_hz))
    n -= n % 8
    t = np.arange(n, dtype=np.float64) / dsd_rate_hz
    planes = []
    for c in range(channels):
        x = amplitude * np.sin(2 * np.pi * freq_hz * t + c * phase_per_ch)
        planes.append(bits_to_bytes_msb(dsm2_bits(x)))
    return np.stack(planes)


def synth_pink_noise_dsd(seconds: float, dsd_rate_hz: int,
                         amplitude: float = 0.25, channels: int = 1,
                         seed: int = 0) -> np.ndarray:
    """Pink-noise DSD stream (for spectral/aliasing validation,
    mirroring test/pinknoise_*.dsf)."""
    n = int(round(seconds * dsd_rate_hz))
    n -= n % 8
    rng = np.random.default_rng(seed)
    planes = []
    for c in range(channels):
        white = rng.standard_normal(n)
        spec = np.fft.rfft(white)
        freqs = np.fft.rfftfreq(n, d=1.0 / dsd_rate_hz)
        with np.errstate(divide="ignore"):
            shaping = 1.0 / np.sqrt(np.maximum(freqs, 1.0))
        shaping[0] = 0.0
        pink = np.fft.irfft(spec * shaping, n)
        pink *= amplitude / np.max(np.abs(pink))
        planes.append(bits_to_bytes_msb(dsm2_bits(pink)))
    return np.stack(planes)


def synth_impulse_dsd(n_bytes: int = 4096, toggle_byte: int = 2048) -> np.ndarray:
    """Single-bit impulse in a DSD idle pattern: all 0xAA (alternating +1/-1)
    with one flipped bit — the impulse-response extraction fixture
    (mirrors test/impulse_mono_toggle.dsd, SURVEY.md §4.2)."""
    data = np.full(n_bytes, 0xAA, dtype=np.uint8)
    data[toggle_byte] = 0xAB
    return data[None, :]
