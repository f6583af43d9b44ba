"""Milliseconds the engine's staging (``pipeline/engine.py::_Staging``)
takes per audio-second: the ``dsd2dxd.stage.wait_slot``, ``.fill`` and
``.enqueue`` spans over the traced streams' audio seconds."""

PARTS = ("dsd2dxd.stage.wait_slot", "dsd2dxd.stage.fill",
         "dsd2dxd.stage.enqueue")


def read(s):
    if not s.audio_s or not any(p in s.span_ms for p in PARTS):
        return None
    return sum(s.span_ms.get(p, 0.0) for p in PARTS) / s.audio_s
