"""Interleaved A/B of the NJAD digit-pair variants (host-side).

Counterpart of ``tools/njadbench.py`` at the repository root, on the
port's g++ build of ``native/src/njad.cc`` (``native/loader.load``).
digit_pair via integer DIVIDE (one 64-bit div per sample, a dependency
chain of 25-40 cycles) vs the threshold LADDER (eight independent
compare-adds). Both are compiled into the library and selected per
quantize call by DSDKIT_NJAD_DIGIT (``njad.cc:157``), so one process can
alternate them in (A,B) pairs with a median-of-pairs ratio, which clock
drift hits alike.

Before any time is printed the two variants must give the same samples;
if they do not, the tool raises (an explicit check, where the original
asserted: an assert vanishes under ``python -O``). Host-only: it needs no
card.

    python -m dsd2dxd_tpu_torch.tools.njadbench [--seconds 4] [--pairs 7]
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

import numpy as np

from dsd2dxd_tpu_torch.native.loader import load

RATE = 88200  # config 3's output rate
BITS = 20  # and depth
VARIANTS = ("div", "ladder")


def material(seconds: float) -> np.ndarray:
    """Pink-ish stereo float32 at 88.2k, full scale 0.3 -- the config-3
    shape, no silence memo (the JAX tool's array)."""
    rng = np.random.default_rng(0)
    n = int(seconds * RATE)
    w = rng.standard_normal(n + 1024)
    k = np.exp(-np.arange(256) / 48.0)
    x = np.convolve(w, k / k.sum(), mode="same")[:n]
    x = (0.3 * x / np.abs(x).max()).astype(np.float32)
    return np.stack([x, np.roll(x, 7)], axis=1)


def run(native, x: np.ndarray, variant: str):
    """One quantize of `x` at 20 bit with a fresh state under `variant`:
    (seconds, int32 samples). DSDKIT_NJAD_DIGIT is left as it was."""
    saved = os.environ.get("DSDKIT_NJAD_DIGIT")
    if variant == "ladder":
        os.environ["DSDKIT_NJAD_DIGIT"] = "ladder"
    else:
        os.environ.pop("DSDKIT_NJAD_DIGIT", None)
    st = native.njad_new(x.shape[1])
    try:
        t0 = time.perf_counter()
        out = native.njad_quantize(st, x, BITS)
        dt = time.perf_counter() - t0
    finally:
        native.njad_free(st)
        if saved is None:
            os.environ.pop("DSDKIT_NJAD_DIGIT", None)
        else:
            os.environ["DSDKIT_NJAD_DIGIT"] = saved
    return dt, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="njadbench", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--pairs", type=int, default=7)
    args = ap.parse_args(argv)

    native = load()
    x = material(args.seconds)
    # warm + bit-identity gate before timing anything
    _, a = run(native, x, "div")
    _, b = run(native, x, "ladder")
    if not np.array_equal(a, b):
        n = int(np.count_nonzero(a != b))
        raise RuntimeError(f"NJAD digit variants disagree on {n} of "
                           f"{a.size} samples: no time is valid")

    tdiv, tthr = [], []
    for _ in range(args.pairs):
        tdiv.append(run(native, x, "div")[0])
        tthr.append(run(native, x, "ladder")[0])
    ratios = [d / t for d, t in zip(tdiv, tthr)]
    xd = args.seconds / statistics.median(tdiv)
    xt = args.seconds / statistics.median(tthr)
    print(f"div    : {xd:8.1f}x RT  (median of {args.pairs}; "
          f"{a.size} samples equal to ladder's)")
    print(f"ladder : {xt:8.1f}x RT")
    print(f"ladder speedup (median of per-pair ratios): "
          f"{statistics.median(ratios):.3f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
