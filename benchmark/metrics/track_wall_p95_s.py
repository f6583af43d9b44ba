"""95th percentile of the traced window's track walls, each from its call
to its closed output (``stats.track_s_p95``): the host clock's tail of
one track, which the album cell reports per layer since its runs spread
too widely for an end-to-end bound (PERF.md)."""

from benchmark import stats


def read(s):
    if not s.walls:
        return None
    return stats.track_s_p95(s.walls)
