"""Single-core throughput profile of the host FLAC encoder.

Counterpart of ``tools/flacbench.py`` at the repository root (``material``,
``encode``, ``orders_ab`` and ``main`` copied), on the port's g++ build of
``native/src/flac.cc`` (``native/loader.load``: it builds the library or
raises ConfigError, so a missing library is an error, not an exit code).

Measures xRT on synthetic material spanning the encoder's decision
space (tone = fixed predictors win, filtered noise = LPC, near-silence
= constant/verbatim edges), at the rates the engine feeds it (the
encoder runs on the engine's drain thread and must keep pace with the
card's output).

    python -m dsd2dxd_tpu_torch.tools.flacbench [--seconds 8] [--rate 352800]
    python -m dsd2dxd_tpu_torch.tools.flacbench --orders 8,12,16   # LPC-cap A/B

The --orders mode re-runs the per-block-order-selection trade
(DSDKIT_FLAC_ORDER, read by ``native/src/flac.cc``) with interleaved reps
and median-of-pairs, so clock drift hits every cap of a pair alike.
Host-only: it needs no card.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from dsd2dxd_tpu_torch.native.loader import load

KINDS = ("tone", "music", "quiet")


def material(kind: str, n: int, rate: int, rng) -> np.ndarray:
    t = np.arange(n) / rate
    if kind == "tone":
        x = 0.5 * np.sin(2 * np.pi * 1000.0 * t)
    elif kind == "music":  # pink-ish: integrated white, HF-damped
        w = rng.standard_normal(n + 1024)
        k = np.exp(-np.arange(256) / 48.0)
        x = np.convolve(w, k / k.sum(), mode="same")[:n]
        x = 0.3 * x / np.abs(x).max()
    elif kind == "quiet":
        x = 1e-4 * rng.standard_normal(n)
    else:
        raise ValueError(kind)
    s = np.round(x * (2 ** 23 - 1)).astype(np.int32)
    return np.stack([s, np.roll(s, 7)], axis=1)  # stereo, decorrelated a bit


def encode(native, x: np.ndarray, rate: int, bps: int = 24,
           block: int = 8192, feed: int = 65536) -> bytes:
    enc = native.flac_new(rate, x.shape[1], bps, block)
    out = []
    for off in range(0, x.shape[0], feed):
        native.flac_feed(enc, x[off:off + feed])
        out.append(native.flac_drain(enc))
    native.flac_finish(enc)
    out.append(native.flac_drain(enc))
    native.flac_free(enc)
    return b"".join(out)


def orders_ab(native, orders, seconds: float, rate: int, reps: int) -> None:
    """Interleaved A/B of LPC order caps on 'music' material (the case
    where higher orders pay): per rep, every cap encodes back-to-back,
    and the reported xRT is the per-cap median — clock wander hits all
    caps of a pair equally."""
    rng = np.random.default_rng(0)
    n = int(seconds * rate)
    x = material("music", n, rate, rng)
    raw = x.shape[0] * x.shape[1] * 3
    sizes, times = {}, {o: [] for o in orders}
    try:
        for o in orders:  # warm + size
            os.environ["DSDKIT_FLAC_ORDER"] = str(o)
            sizes[o] = len(encode(native, x, rate))
        for _ in range(reps):
            for o in orders:
                os.environ["DSDKIT_FLAC_ORDER"] = str(o)
                t0 = time.perf_counter()
                encode(native, x, rate)
                times[o].append(time.perf_counter() - t0)
    finally:
        os.environ.pop("DSDKIT_FLAC_ORDER", None)
    base_size = sizes[orders[0]]
    for o in orders:
        med = sorted(times[o])[reps // 2]
        # speed ratio from PER-REP pairs (same rep = same clock state),
        # then the median of those ratios — ratioing two independent
        # medians would let clock wander land on different reps for the
        # two caps and not cancel
        pair = sorted(times[orders[0]][r] / times[o][r]
                      for r in range(reps))[reps // 2]
        print(f"  cap {o:>2}: {seconds / med:6.1f}x RT  "
              f"ratio={sizes[o] / raw:.4f}  "
              f"vs cap {orders[0]}: speed {pair:5.2f}x  "
              f"size {sizes[o] / base_size:.4f}x")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="flacbench", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--rate", type=int, default=352800)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--orders", type=str, default=None,
                    help="comma-separated LPC caps to A/B (e.g. 8,12,16)")
    args = ap.parse_args(argv)

    native = load()
    if args.orders:
        orders_ab(native, [int(o) for o in args.orders.split(",")],
                  args.seconds, args.rate, max(5, args.reps))
        return 0
    rng = np.random.default_rng(0)
    n = int(args.seconds * args.rate)
    for kind in KINDS:
        x = material(kind, n, args.rate, rng)
        payload = encode(native, x, args.rate)  # warm
        best = float("inf")
        for _ in range(args.reps):
            t0 = time.perf_counter()
            encode(native, x, args.rate)
            best = min(best, time.perf_counter() - t0)
        raw = x.shape[0] * x.shape[1] * 3
        print(f"  {kind:<6}: {args.seconds / best:6.1f}x RT  "
              f"({raw / best / 1e6:6.1f} MB/s raw)  "
              f"ratio={len(payload) / raw:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
