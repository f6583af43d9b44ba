"""dsd2dxd_tpu_torch -- the PyTorch/CUDA port of dsd2dxd_tpu.

The JAX package ``dsd2dxd_tpu`` stays the reference. This package runs its
44.1k family (every pure ÷2^k chain, DSD64 -> 352.8 kHz down to DSD256 ->
88.2 kHz) and its 48k family (a ÷2^k head and the ×160/147 stage, DSD64/128/
256 -> 96/192/384 kHz), at 16/20/24 bit and 32-bit float, on an NVIDIA card:
host code in PyTorch, the fused decimation kernel and the finish kernel
written by hand in CUDA (``csrc/fused_decim.cu``, ``csrc/finish.cu``;
the floor probes of ``tools/`` in ``csrc/probes.cu``), into WAV, AIFF,
AIFC, FLAC or raw PCM, with NJAD dither and the level check (``dsd_levels``)
besides. Its host layers (``formats/``, ``containers/``, ``filters/`` with
the designed tables, ``utils/``, the CLI parser and progress bars, and the
NJAD and FLAC C++ under ``native/``) are its own copies of the JAX
package's: it imports nothing of ``dsd2dxd_tpu`` and never loads jax.
"""

from dsd2dxd_tpu_torch.formats.dsd_types import (
    ONE_HUNDRED_PERCENT,
    DitherType,
    DsdFileFormat,
    DsdRate,
    Endianness,
    FilterType,
    FmtType,
    OutputType,
    ProgressUpdate,
)
from dsd2dxd_tpu_torch.pipeline.engine import Converter

__version__ = "0.1.0"

__all__ = [
    "DitherType",
    "DsdFileFormat",
    "DsdRate",
    "Endianness",
    "FilterType",
    "FmtType",
    "OutputType",
    "ProgressUpdate",
    "ONE_HUNDRED_PERCENT",
    "Converter",
]
