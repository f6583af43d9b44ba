"""Milliseconds the source reader (``formats/source.py``, and the DSF
parse in ``formats/dsf.py``) takes per audio-second: the port's
``dsd2dxd.read`` spans over the traced streams' audio seconds."""


def read(s):
    ms = s.span_ms.get("dsd2dxd.read")
    if ms is None or not s.audio_s:
        return None
    return ms / s.audio_s
