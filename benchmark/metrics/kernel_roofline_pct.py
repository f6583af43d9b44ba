"""The conversion kernels' share of their roofline: the least time the
card could take for the traced audio seconds' work, counted from the
configuration's chain alone (``benchmark/work.py``), over the summed time
of every kernel in the traces. Every kernel counts, by design: the
conversion's own (K1a; K1e and K2t) and the small copy and fill kernels
that PyTorch launches beside them, so that no kernel leaves the sum by a
new name or a move out of the fused ones. The term that bounds it
(bytes, f32 or integer operations) goes to the harness's log."""

from benchmark import work


def read(s):
    if not s.kernel_us or not s.audio_s or s.work is None:
        return None
    seconds, _by = work.bound_s(tuple(x * s.audio_s for x in s.work))
    return 100.0 * seconds / (s.kernel_us / 1e6)
