"""FIR design for the decimation / resampling chains.

The reference's four filter banks (E/X/D/C) live in the absent
``rdsd2pcm`` submodule; their exact coefficients are unrecoverable from
the snapshot (SURVEY.md §0, §7.3 item 1). Per the survey's mitigation
plan, every bank here is **designed fresh with scipy** to the contract the
reference documents (reference README.md:252-254):

- linear phase, symmetric, **even tap count** (type-II lowpass: forced
  zero at Nyquist);
- flat to 20-22 kHz, gentle rolloff after;
- transition band edging slightly past the *output* Nyquist (aliasing
  folds only into the ultrasonic region);
- minimal taps, a little aliasing permitted.

Chains are multi-stage (the reference uses cascaded FIRs for the 48k
multiples, README.md:230; we cascade everywhere because on TPU each stage
is one strided convolution and early cheap stages cut the tap budget by
orders of magnitude):

- 44.1k-multiple targets (pure 2^r decimation, SURVEY.md §2.5): a chain
  of cheap half-rate decimators, then one final "quality" /2 stage whose
  response defines the bank's character.
- 48k-multiple targets: the SAME pure-2^r chain down to the 44.1k-family
  rate with the matching exponent (base = out*147/160, e.g. 96k -> 88.2k),
  then one fixed x160/147 family-conversion polyphase stage on the small
  PCM output. The head is therefore fused-kernel eligible end to end
  (ops/fused.py) and carries the bank's character; the conversion stage
  is transparent (its transition sits entirely above the head's) and its
  stopband kills every image that could fold back into the audio band.

All design happens in float64; results are cached on disk under
``filters/cache`` keyed by a content hash of the design parameters.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from fractions import Fraction
from functools import lru_cache
from pathlib import Path

import numpy as np

from dsd2dxd_tpu_torch.formats.dsd_types import (
    DsdRate,
    FilterType,
    check_filter_choice,
)

_CACHE_DIR = Path(__file__).parent / "cache"
_DESIGN_VERSION = 5  # bump to invalidate every cached table


@dataclass(frozen=True)
class Stage:
    """One polyphase resampling stage: upsample by L, FIR, downsample by M.

    ``taps`` follow scipy.signal.upfirdn conventions (applied to the
    L-upsampled stream, already scaled by L to preserve gain).
    """

    taps: np.ndarray
    L: int
    M: int

    @property
    def n_taps(self) -> int:
        return int(self.taps.shape[0])

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Stage(L={self.L}, M={self.M}, taps={self.n_taps})"


# ---------------------------------------------------------------------------
# Tap-count estimation and primitive designs
# ---------------------------------------------------------------------------


def _estimate_taps(delta_f: float, att_db: float, ripple_db: float = 1e-3) -> int:
    """Bellanger's estimate, delta_f = transition width / sample rate."""
    dp = (10 ** (ripple_db / 20.0) - 1.0) / (10 ** (ripple_db / 20.0) + 1.0)
    ds = 10 ** (-att_db / 20.0)
    n = int(np.ceil(2.0 / 3.0 * np.log10(1.0 / (10.0 * dp * ds)) / delta_f))
    return max(n, 8)


class FilterDesignError(RuntimeError):
    """A bank/stage spec could not be met by the growth loop — raised
    instead of caching a best-effort design (the cache is permanent)."""


def _signal():
    """scipy.signal, imported at the first design rather than with the
    module: a chain read from the table cache needs none, and the import
    is seconds of a process's start-up."""
    from scipy import signal

    return signal


def _even(n: int) -> int:
    return n + (n & 1)


def _remez_lowpass(n_taps: int, fs: float, pass_hz: float, stop_hz: float,
                   att_db: float, ripple_db: float = 1e-3) -> np.ndarray:
    """Equiripple lowpass; falls back to a Kaiser-window design when remez
    fails to converge (long filters)."""
    dp = (10 ** (ripple_db / 20.0) - 1.0) / (10 ** (ripple_db / 20.0) + 1.0)
    ds = 10 ** (-att_db / 20.0)
    n_taps = _even(n_taps)
    try:
        taps = _signal().remez(
            n_taps,
            [0.0, pass_hz, stop_hz, fs / 2.0],
            [1.0, 0.0],
            weight=[1.0 / dp, 1.0 / ds],
            fs=fs,
            maxiter=60,
        )
        if not np.all(np.isfinite(taps)):
            raise ValueError("remez produced non-finite taps")
        return taps
    except Exception:
        return _kaiser_lowpass(n_taps, fs, pass_hz, stop_hz, att_db)


def _measure(taps: np.ndarray, fs: float, pass_hz: float,
             stop_hz: float) -> tuple[float, float]:
    """(passband deviation dB, stopband attenuation dB) on a dense grid."""
    wp = np.linspace(0.0, pass_hz, 256) / (fs / 2.0) * np.pi
    ws = np.linspace(stop_hz, fs / 2.0, 1024) / (fs / 2.0) * np.pi
    _, hp = _signal().freqz(taps, worN=wp)
    _, hs = _signal().freqz(taps, worN=ws)
    dev = float(np.max(np.abs(20.0 * np.log10(np.abs(hp) + 1e-300))))
    att = float(-np.max(20.0 * np.log10(np.abs(hs) + 1e-300)))
    return dev, att


def _verified_lowpass(fs: float, pass_hz: float, stop_hz: float,
                      att_db: float, ripple_db: float = 1e-3) -> np.ndarray:
    """Design to SPEC, not to an estimate: start at the Bellanger estimate
    and grow the tap count until the measured stopband attenuation and
    passband ripple meet the target (the estimate is badly off for the
    very narrowband cheap stages at DSD rates)."""
    n = _even(_estimate_taps((stop_hz - pass_hz) / fs, att_db, ripple_db))
    dev = att = float("nan")
    for _ in range(24):
        taps = _remez_lowpass(n, fs, pass_hz, stop_hz, att_db, ripple_db)
        dev, att = _measure(taps, fs, pass_hz, stop_hz)
        if att >= att_db - 1.0 and dev <= max(ripple_db * 3.0, 1e-3):
            return taps
        n = _even(max(n + 2, int(n * 1.25)))
    # A spec miss must be LOUD: get_chain caches designs to disk, so a
    # silently-returned best effort would ship an alias-leaking filter
    # permanently.
    raise FilterDesignError(
        f"lowpass spec unmet after growth to {n} taps: measured "
        f"{att:.1f} dB stop / {dev:.2e} dB ripple vs target "
        f"{att_db:.0f} dB / {ripple_db:.0e} (fs={fs:.0f}, "
        f"pass={pass_hz:.0f}, stop={stop_hz:.0f})")


def _kaiser_lowpass(n_taps: int, fs: float, pass_hz: float, stop_hz: float,
                    att_db: float) -> np.ndarray:
    beta = _signal().kaiser_beta(att_db)
    cutoff = (pass_hz + stop_hz) / 2.0
    return _signal().firwin(
        _even(n_taps), cutoff, window=("kaiser", beta), fs=fs, scale=True
    )


def _cheap_decimator(fs_in: float, m: int, protect_hz: float,
                     att_db: float) -> Stage:
    """A /m pre-stage that only needs to keep [0, protect_hz] alias-free.

    Content between protect_hz and the new Nyquist passes (or aliases into
    ultrasonics) and is dealt with by later stages — this is what keeps
    early stages at the multi-MHz DSD rate down to a handful of taps.
    """
    fs_out = fs_in / m
    stop_hz = fs_out - protect_hz  # first alias edge folding onto protect band
    if stop_hz <= protect_hz:
        raise ValueError(
            f"cheap stage /{m} at {fs_in} Hz cannot protect {protect_hz} Hz"
        )
    taps = _verified_lowpass(fs_in, protect_hz, stop_hz, att_db)
    return Stage(taps=taps, L=1, M=m)


def _quality_stage(filt: FilterType, fs_in: float, out_hz: int,
                   L: int, M: int) -> Stage:
    """The final stage: transition behavior here IS the bank's character.

    Passband flat to >=21 kHz (more when the output Nyquist allows),
    stopband starting slightly past the output Nyquist
    (reference README.md:252-254 contract; see module docstring).
    """
    nyq = out_hz / 2.0
    fs_virtual = fs_in * L
    if filt is FilterType.EQUIRIPPLE:
        # Default bank: flat to min(0.25*nyq floor of 21 kHz), 120 dB stop.
        pass_hz = max(21_000.0, 0.45 * nyq)
        stop_hz = 1.05 * nyq
        att = 120.0
        ripple = 1e-4
    elif filt is FilterType.XLD:
        # XLD-style: tighter transition, very flat top, strong attenuation.
        pass_hz = max(21_500.0, 0.465 * nyq)
        stop_hz = 1.01 * nyq
        att = 135.0
        ripple = 5e-5
    elif filt is FilterType.CHEBYSHEV:
        # "Natural sound with slight rolloff" (reference README.md:232):
        # Dolph-Chebyshev window design — monotone gentle rolloff, constant
        # stopband level.
        pass_hz = max(20_000.0, 0.40 * nyq)
        stop_hz = 1.05 * nyq
        cutoff = 0.80 * nyq
        n = _even(_estimate_taps((stop_hz - pass_hz) / fs_virtual, 110.0))
        att_meas = float("nan")
        for _ in range(24):
            taps = _signal().firwin(
                n, cutoff, window=("chebwin", 112.0), fs=fs_virtual, scale=True
            )
            _, att_meas = _measure(taps, fs_virtual, pass_hz, stop_hz)
            if att_meas >= 105.0:
                return Stage(taps=taps * L, L=L, M=M)
            n = _even(max(n + 2, int(n * 1.25)))
        raise FilterDesignError(
            f"C-bank spec unmet after growth to {n} taps: "
            f"{att_meas:.1f} dB stop vs 105 dB target "
            f"(fs={fs_virtual:.0f}, stop={stop_hz:.0f})")
    else:
        raise ValueError(f"no quality stage for {filt}")
    taps = _verified_lowpass(fs_virtual, pass_hz, stop_hz, att, ripple)
    return Stage(taps=taps * L, L=L, M=M)


def _dsd2pcm_stage(fs_in: float) -> Stage:
    """The `D` bank: a short single-stage /8 decimator in the spirit of
    Sebastian Gesemann's original dsd2pcm (reference LICENSE.txt lineage;
    README.md:242): one symmetric FIR of ~96 taps at the DSD64 rate,
    gentle response, audible-band flat, deliberately leaky transition.
    """
    out_hz = fs_in / 8.0
    nyq = out_hz / 2.0
    taps = _kaiser_lowpass(96, fs_in, 0.35 * nyq, 1.30 * nyq, 75.0)
    return Stage(taps=taps, L=1, M=8)


# ---------------------------------------------------------------------------
# Chain construction
# ---------------------------------------------------------------------------

_DSD64_HZ = 2_822_400


def _chain_44k(filt: FilterType, in_hz: int, out_hz: int) -> list[Stage]:
    r = in_hz // out_hz
    assert r * out_hz == in_hz and (r & (r - 1)) == 0
    protect = 0.55 * out_hz / 2.0
    stages: list[Stage] = []
    fs = float(in_hz)
    while fs > 2.0 * out_hz:
        stages.append(_cheap_decimator(fs, 2, protect, 125.0))
        fs /= 2.0
    stages.append(_quality_stage(filt, fs, out_hz, L=1, M=2))
    return stages


def _family_stage(base_hz: int, out_hz: int) -> Stage:
    """The x160/147 44.1k->48k family conversion stage (44100*160/147 =
    48000), applied AFTER the bank's own chain has decimated to
    base = out*147/160.

    Spec: pass everything the head can emit — the head's quality stage
    transitions out at 1.05*base_nyq — and stop at (out_hz - 20 kHz), the
    lowest frequency whose post-/147 fold can land inside the audio band
    (images of head-transition content at k*base +- f land >= out-20k for
    every k >= 1 that matters; see tests/test_filters.py alias oracle,
    which verifies the full cascade numerically). The transition is wide
    (≈0.5..0.85 of base), so the filter stays short (~2-3k taps, ~15 per
    output phase) despite the 160x virtual rate.
    """
    fs_virtual = float(base_hz) * 160.0
    pass_hz = 0.525 * base_hz  # = 1.05 * base Nyquist
    stop_hz = float(out_hz - 20_000)
    taps = _verified_lowpass(fs_virtual, pass_hz, stop_hz, 125.0)
    return Stage(taps=taps * 160.0, L=160, M=147)


def _chain_48k(filt: FilterType, in_hz: int, out_hz: int) -> list[Stage]:
    # in = 44.1k*64 * 2^p ; out = 48k * 2^q. Plan: the bank's own pure
    # /2^r chain down to base = out*147/160 (the 44.1k-family rate with
    # the same exponent — this part runs the fused single-pass kernel),
    # then the fixed x160/147 family-conversion stage on the PCM output.
    base_hz = out_hz * 147 // 160
    assert base_hz * 160 == out_hz * 147
    stages = _chain_44k(filt, in_hz, base_hz)
    stages.append(_family_stage(base_hz, out_hz))
    return stages


def _design_chain(filt: FilterType, in_rate: DsdRate, out_hz: int) -> list[Stage]:
    check_filter_choice(filt, in_rate, out_hz)
    in_hz = in_rate.hz
    if filt is FilterType.DSD2PCM:
        return [_dsd2pcm_stage(float(in_hz))]
    if out_hz % 44100 == 0:
        return _chain_44k(filt, in_hz, out_hz)
    return _chain_48k(filt, in_hz, out_hz)


# ---------------------------------------------------------------------------
# Disk cache
# ---------------------------------------------------------------------------


def _cache_key(filt: FilterType, in_rate: DsdRate, out_hz: int) -> str:
    ident = f"v{_DESIGN_VERSION}:{filt.value}:{int(in_rate)}:{out_hz}"
    return f"{filt.value}_{int(in_rate)}_{out_hz}_" + hashlib.sha256(
        ident.encode()
    ).hexdigest()[:10]


@lru_cache(maxsize=None)
def get_chain(filt: FilterType, in_rate: DsdRate, out_hz: int) -> tuple[Stage, ...]:
    """The resampling chain for (filter bank, input rate, output rate),
    designed on first use and cached on disk + in memory."""
    key = _cache_key(filt, in_rate, out_hz)
    path = _CACHE_DIR / f"{key}.npz"
    if path.exists():
        with np.load(path) as z:
            n = int(z["n_stages"])
            return tuple(
                Stage(taps=z[f"taps{i}"], L=int(z[f"L{i}"]), M=int(z[f"M{i}"]))
                for i in range(n)
            )
    chain = _design_chain(filt, in_rate, out_hz)
    _CACHE_DIR.mkdir(exist_ok=True)
    payload = {"n_stages": np.int64(len(chain))}
    for i, s in enumerate(chain):
        payload[f"taps{i}"] = s.taps
        payload[f"L{i}"] = np.int64(s.L)
        payload[f"M{i}"] = np.int64(s.M)
    # per-process tmp name: two processes designing the same chain
    # concurrently must not interleave writes into one tmp file (the
    # winner's rename would publish a truncated archive)
    tmp = path.with_name(f"{key}.{os.getpid()}.tmp.npz")
    np.savez(tmp, **payload)
    tmp.replace(path)
    return tuple(chain)


def chain_ratio(chain: tuple[Stage, ...]) -> Fraction:
    """Overall output/input sample-rate ratio of a chain."""
    r = Fraction(1)
    for s in chain:
        r *= Fraction(s.L, s.M)
    return r


def chain_input_multiple(chain: tuple[Stage, ...]) -> int:
    """Smallest tile length (in input samples) that keeps every stage's
    output length integral — prod(M_i) works because each stage's L_i
    carries through (see ops/resample streaming)."""
    m = 1
    for s in chain:
        m *= s.M
    return m
