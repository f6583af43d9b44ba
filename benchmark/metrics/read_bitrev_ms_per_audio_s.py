"""Milliseconds the source reader takes per audio-second to reverse the
bit order of an LSB-first stream, every .dsf (``formats/source.py``'s
``reverse_bits``): the port's ``dsd2dxd.read.bitrev`` spans, inside
``dsd2dxd.read``, over the traced streams' audio seconds."""


def read(s):
    ms = s.span_ms.get("dsd2dxd.read.bitrev")
    if ms is None or not s.audio_s:
        return None
    return ms / s.audio_s
