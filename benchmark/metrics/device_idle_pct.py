"""Share of the traced streams' ``dsd2dxd.stream`` time in which no
kernel, copy or set ran on the card (the union of their intervals)."""


def read(s):
    if not s.stream_us:
        return None
    return 100.0 * (1.0 - s.busy_us / s.stream_us)
