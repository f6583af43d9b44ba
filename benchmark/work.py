"""The least time the card could take for a chain's work, counted from the
chain alone, whatever kernel implements it: a frozen copy of the
arithmetic of the port's speed-of-light model (``k1_work``, ``k2t_work``,
``cell_work``, ``bound_s``) and of the peaks it uses, so that no change
to the program moves this yardstick.

Per audio-second and channel:

  bytes     the DSD stream read once (rate / 8) and each output sample's
            bytes written once;
  f32 ops   one product and one sum per tap of each directly decimated
            stage output of the ÷2^k head, then 4 per output sample for
            the epilogue; on a 48k chain the head so, then 2 T per
            ×160/147 output (T: the band's entries per phase) and 5 per
            output sample for its epilogue;
  int ops   18 per output sample when dithered (one Philox4x32-10 call).

The peaks are an H100 SXM's published ones: 3.35 TB/s of HBM3, 67
TFLOP/s of float32 outside the tensor cores (an FMA counted as two), and
a quarter of that in 32-bit integer operations (64 INT32 lanes beside
128 FP32 lanes per SM).
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_INT32_OPS = PEAK_F32_FLOPS / 4
PHILOX_INT_OPS = 18
K1_EPILOGUE_OPS = 4
K2_EPILOGUE_OPS = 5


def bytes_per_sample(bit_depth: int) -> int:
    return {16: 2, 20: 3, 24: 3, 32: 4}[bit_depth]


def cascade_flops(decims: list, taps: list) -> int:
    """f32 operations per output frame and channel of a ÷2^k cascade."""
    r, cum, macs = 1, 1, 0
    for m in decims:
        r *= m
    for m, n in zip(decims, taps):
        cum *= m
        macs += n * (r // cum)
    return 2 * macs


def chain_work(chain: dict, dsd_hz: int, out_hz: int, bit_depth: int,
               dithered: bool) -> tuple[int, int, int]:
    """(bytes, f32 operations, integer operations) per audio-second and
    channel of a configuration's chain: ``chain`` as a configuration file
    states it, {"head": [[M, taps], ...], "tail_taps_per_phase": T}."""
    decims = [m for m, _n in chain["head"]]
    taps = [n for _m, n in chain["head"]]
    r = 1
    for m in decims:
        r *= m
    frames = dsd_hz // r
    philox = PHILOX_INT_OPS if dithered else 0
    t = chain.get("tail_taps_per_phase", 0)
    head_flops = cascade_flops(decims, taps) * frames
    if not t:
        return (frames * r // 8 + frames * bytes_per_sample(bit_depth),
                head_flops + K1_EPILOGUE_OPS * frames, philox * frames)
    return (frames * r // 8 + out_hz * bytes_per_sample(bit_depth),
            head_flops + (2 * t + K2_EPILOGUE_OPS) * out_hz, philox * out_hz)


def bound_s(work: tuple) -> tuple[float, str]:
    """(seconds, the term that bounds them: "bytes", "f32" or "int") of
    `work` at the peaks; the terms overlap, so the largest one wins."""
    nbytes, flops, int_ops = work
    terms = {"bytes": nbytes / PEAK_BYTES_PER_S,
             "f32": flops / PEAK_F32_FLOPS,
             "int": int_ops / PEAK_INT32_OPS}
    by = max(terms, key=terms.get)
    return terms[by], by
