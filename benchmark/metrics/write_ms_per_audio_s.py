"""Milliseconds the writer on the drain thread (``containers/wav.py``,
``aiff.py``, stdout) takes per audio-second: the ``dsd2dxd.drain.write``
spans over the traced streams' audio seconds."""


def read(s):
    ms = s.span_ms.get("dsd2dxd.drain.write")
    if ms is None or not s.audio_s:
        return None
    return ms / s.audio_s
