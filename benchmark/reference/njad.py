"""The plain reference of NJAD ("Not Just Another Dither", ``-d N``): float
samples in, integers at `bits` out, written from the requantizer's
description alone, in plain Python over ``torch`` tensors.

Each channel keeps a histogram of the leading decimal digits (1-9) of
the integers it has emitted. Sample x (full scale +-1) becomes
v = x * 2^(bits - 1), and the output is floor(v) or floor(v) + 1,
whichever leaves the histogram closer to Benford's law, the share
log10(1 + 1/d) for digit d (to 15 digits, below); a tie takes the floor.
Zero has no leading digit and leaves the histogram as it is. After each
count the histogram halves once its total passes 1024, so it keeps
adapting. The chosen integer is clipped to [-2^(bits - 1),
2^(bits - 1) - 1]. Channels never interact, and the state carries over
from one call to the next.

"Closer" is the L1 distance of the shares, sum_d |c_d / T - b_d|, with
the candidate's digit counted. Where both candidates have a digit, the
distances share their total T + 1 and all but the two candidates'
terms, so the choice is decided by those terms alone: with
e = c_d - b_d (T + 1), the candidate whose |e + 1| - |e| (that is,
clamp(2 e + 1, -1, 1)) is the smaller. This reference decides so, and
takes the full distance only where a candidate is zero (v in [-1, 1)),
because that is the arithmetic whose rounding the requantizer's output
follows: near a tie the two forms can round apart by an ulp. Nothing
else departs from the description; the requantizer's digit ladder, its
memo for runs of silence and its thread per channel change no output.
"""

from __future__ import annotations

import torch

# Benford's shares log10(1 + 1/d), d = 1 .. 9, to the 15 significant
# digits the requantizer states them in: at an exact tie of the two
# distances (a histogram of 1 and 3, say) the last digit decides
BENFORD = [0.0, 0.301029995663981, 0.176091259055681, 0.124938736608300,
           0.096910013008056, 0.079181246047625, 0.066946789630613,
           0.057991946977687, 0.051152522447381, 0.045757490560675]
DECAY_ABOVE = 1024.0


def leading_digit(v: int) -> int:
    """The leading decimal digit of |v|, 0 for 0."""
    return int(str(abs(v))[0]) if v else 0


class Njad:
    """One stream's NJAD state: a digit histogram per channel."""

    def __init__(self, channels: int):
        self.counts = [[0.0] * 10 for _ in range(channels)]
        self.total = [0.0] * channels

    def _distance(self, c: int, d: int) -> float:
        """The histogram of channel c, with digit d counted (none for 0),
        from Benford's shares."""
        total = self.total[c] + (1.0 if d > 0 else 0.0)
        if total <= 0.0:
            return 0.0
        s = 0.0
        for i in range(1, 10):
            n = self.counts[c][i] + (1.0 if i == d else 0.0)
            s += abs(n / total - BENFORD[i])
        return s

    def _take_ceil(self, c: int, dlo: int, dhi: int) -> bool:
        if dlo > 0 and dhi > 0:
            t1 = self.total[c] + 1.0
            g = [max(-1.0, min(1.0, 2.0 * (self.counts[c][d]
                                            - BENFORD[d] * t1) + 1.0))
                 for d in (dlo, dhi)]
            return g[0] > g[1]
        return self._distance(c, dlo) > self._distance(c, dhi)

    def quantize(self, x: torch.Tensor, bits: int) -> torch.Tensor:
        """(frames, C) float32 samples -> (frames, C) int32 at `bits`."""
        v = x.to(torch.float64) * float(1 << (bits - 1))
        lo = torch.floor(v).to(torch.int64)
        top = 1 << (bits - 1)
        out = torch.empty(lo.shape, dtype=torch.int64)
        for c in range(lo.shape[1]):
            col = lo[:, c].tolist()
            res = []
            for ilo in col:
                dlo, dhi = leading_digit(ilo), leading_digit(ilo + 1)
                up = self._take_ceil(c, dlo, dhi)
                d = dhi if up else dlo
                if d > 0:
                    self.counts[c][d] += 1.0
                    self.total[c] += 1.0
                    if self.total[c] > DECAY_ABOVE:
                        for k in range(1, 10):
                            self.counts[c][k] *= 0.5
                        self.total[c] *= 0.5
                res.append(min(max(ilo + up, -top), top - 1))
            out[:, c] = torch.tensor(res, dtype=torch.int64)
        return out.to(torch.int32)
