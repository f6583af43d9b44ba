"""Milliseconds the FLAC encoder (``native/src/flac.cc`` through
``containers/flac.py``, on the drain thread) takes per audio-second: the
port's ``dsd2dxd.drain.flac`` spans over the traced streams' audio
seconds. A program without the span reads nothing."""


def read(s):
    ms = s.span_ms.get("dsd2dxd.drain.flac")
    if ms is None or not s.audio_s:
        return None
    return ms / s.audio_s
