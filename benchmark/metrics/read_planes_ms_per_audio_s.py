"""Milliseconds the source reader takes per audio-second to read the
file's bytes into per-channel planes (``formats/source.py``'s
``_read_planar``: one ``readinto`` of a tile's blocks into a reused
buffer, then the C++ ``dsfread_planes`` de-interleave into a fresh array;
or ``_read_interleaved``'s reshape): the port's ``dsd2dxd.read.planes``
spans, inside ``dsd2dxd.read``, over the traced streams' audio seconds."""


def read(s):
    ms = s.span_ms.get("dsd2dxd.read.planes")
    if ms is None or not s.audio_s:
        return None
    return ms / s.audio_s
