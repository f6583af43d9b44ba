"""Milliseconds the source reader takes per audio-second to read the
file's bytes into per-channel planes (``formats/source.py``: the reads,
the DSF block loop or the interleaved reshape, the concatenation): the
port's ``dsd2dxd.read.planes`` spans, inside ``dsd2dxd.read``, over the
traced streams' audio seconds."""


def read(s):
    ms = s.span_ms.get("dsd2dxd.read.planes")
    if ms is None or not s.audio_s:
        return None
    return ms / s.audio_s
