"""PCM sample packing: int32/float32 arrays -> wire bytes.

This is the host byte path (SURVEY.md §2.3 item 3), a copy of
``dsd2dxd_tpu/containers/pack.py``. The port's kernels write wire bytes
themselves (``csrc/epilogue.cuh``), so its engine only calls
``bytes_per_sample`` and the writers' ``write_packed``; the numpy
packers serve callers that hold samples on the host.

Conventions:
- 16/24-bit: two's complement little-endian (WAV) or big-endian (AIFF).
- 20-bit: rides in a 24-bit container with the 20 significant bits at the
  top (value << 4), matching the reference's "20-bit in 24-bit container"
  behavior (reference README.md:11-12; build_test_mono.sh plays 20-bit
  output as s24le).
- 32-bit float: IEEE-754, LE (WAV) or BE (AIFC 'fl32').
"""

from __future__ import annotations

import numpy as np


def pack_int(samples: np.ndarray, bit_depth: int, big_endian: bool = False) -> bytes:
    """Pack int32 samples (already quantized/clipped to the target depth,
    interleaved frame-major) into bytes.

    bit_depth 16 -> 2 bytes/sample; 20 and 24 -> 3 bytes/sample.
    """
    x = np.ascontiguousarray(samples, dtype=np.int32)
    if bit_depth == 16:
        dt = ">i2" if big_endian else "<i2"
        return x.astype(dt).tobytes()
    if bit_depth in (20, 24):
        if bit_depth == 20:
            x = x << 4  # 20 significant bits at the top of the 24-bit word
        b = x.astype("<i4").view(np.uint8).reshape(-1, 4)
        if big_endian:
            out = b[:, 2::-1]  # bytes 2,1,0 -> big-endian 24-bit
        else:
            out = b[:, :3]
        return np.ascontiguousarray(out).tobytes()
    raise ValueError(f"Unsupported integer bit depth: {bit_depth}")


def pack_float(samples: np.ndarray, big_endian: bool = False) -> bytes:
    dt = ">f4" if big_endian else "<f4"
    return np.ascontiguousarray(samples, dtype=np.float32).astype(dt).tobytes()


def pack(samples: np.ndarray, bit_depth: int, big_endian: bool = False) -> bytes:
    """Dispatch on bit depth: 16/20/24 integer, 32 float."""
    if bit_depth == 32:
        return pack_float(samples, big_endian)
    return pack_int(samples, bit_depth, big_endian)


def bytes_per_sample(bit_depth: int) -> int:
    return {16: 2, 20: 3, 24: 3, 32: 4}[bit_depth]
