"""Milliseconds the host's NJAD requantizer (``native/src/njad.cc``, on
the drain thread) takes per audio-second: the port's
``dsd2dxd.drain.njad`` spans over the traced streams' audio seconds. A
program without the span reads nothing."""


def read(s):
    ms = s.span_ms.get("dsd2dxd.drain.njad")
    if ms is None or not s.audio_s:
        return None
    return ms / s.audio_s
