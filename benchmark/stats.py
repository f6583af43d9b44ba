"""The numbers of a window from its tracks: ``audio_xrt`` end to end, the
tracks' walls' 95th percentile per layer (``metrics/track_wall_p95_s``)."""

from __future__ import annotations

import statistics


def audio_xrt(audio_s: list, window_s: float) -> float:
    """Audio seconds of every track converted in the window over the
    window's wall: all the work over all the time."""
    return sum(audio_s) / window_s


def track_s_p95(walls: list) -> float:
    """95th percentile of the tracks' walls, each from its call to its
    closed output, by linear interpolation between the order statistics
    (``statistics.quantiles``' inclusive method); one track is its own."""
    if len(walls) == 1:
        return float(walls[0])
    return float(statistics.quantiles(walls, n=100, method="inclusive")[94])
