"""Philox4x32-10 dither noise in torch integer ops.

The counterpart of the TPU kernel's on-core PRNG (``_uniform01``,
``dsd2dxd_tpu/ops/fused.py:281``). The TPU's bits cannot be reproduced on
another device, so the port uses a counter-based generator that the CUDA
kernel (``csrc/fused_decim.cu``) implements line for line: on the card the
kernel and this plain version draw identical noise.

- Key: the two 32-bit halves of ``tile_key(file_seed, tile_idx)``, a
  splitmix64 mix of all bits of both (the JAX package folds its seed into
  31 bits, ``sharded.py:_fused_seeds``; this does not).
- Counter: (frame, channel, 0, 0), frame counted within the tile.
- Uniforms: ``(x >> 8) * 2**-24`` in [0, 1), exact in f32.
  TPDF = (u0 + u1) - 1, RECT = u0 - 0.5, in LSB units; FPD = TPDF in
  units of the sample's ulp.

All arithmetic is on int64 tensors holding 32-bit values; the 32x32-bit
products are split into 16-bit halves so that no intermediate leaves
int64's range (signed overflow is not relied on).
"""

from __future__ import annotations

import torch

_M0 = 0xD2511F53
_M1 = 0xCD9E8D57
_W0 = 0x9E3779B9
_W1 = 0xBB67AE85
_MASK32 = 0xFFFFFFFF
_MASK64 = (1 << 64) - 1


def splitmix64(x: int) -> int:
    """One splitmix64 output for state ``x`` (Steele, Lea, Flood 2014)."""
    z = (x + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def tile_key(file_seed: int, tile_idx: int) -> int:
    """64-bit Philox key of one tile: every bit of the file seed and the
    tile index reaches every bit of the key."""
    return splitmix64(splitmix64(file_seed & _MASK64) ^ (tile_idx & _MASK64))


def _mulhilo(a: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of a * m for a in [0, 2**32) (int64), m a
    32-bit constant, without int64 overflow."""
    p_lo = a * (m & 0xFFFF)            # < 2**48
    p_hi = a * (m >> 16)               # < 2**48
    s = p_lo + ((p_hi & 0xFFFF) << 16)  # < 2**49
    lo = s & _MASK32
    hi = ((s >> 32) + (p_hi >> 16)) & _MASK32
    return hi, lo


def philox4x32(c0, c1, c2, c3, key: int, rounds: int = 10):
    """Philox4x32-R on int64 tensors of 32-bit counters; ``key`` is the
    64-bit key (low word k0). Returns the four 32-bit output words."""
    k0 = key & _MASK32
    k1 = (key >> 32) & _MASK32
    for r in range(rounds):
        if r:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniforms(n_frames: int, channels: int, key: int, device=None):
    """(u0, u1): two (channels, n_frames) f32 uniforms in [0, 1) from
    counter (frame, channel, 0, 0)."""
    f = torch.arange(n_frames, dtype=torch.int64, device=device)
    c = torch.arange(channels, dtype=torch.int64, device=device)
    c0 = f.unsqueeze(0).expand(channels, n_frames)
    c1 = c.unsqueeze(1).expand(channels, n_frames)
    zero = torch.zeros_like(c0)
    x0, x1, _x2, _x3 = philox4x32(c0, c1, zero, zero, key)
    scale = 2.0 ** -24
    return ((x0 >> 8).to(torch.float32) * scale,
            (x1 >> 8).to(torch.float32) * scale)
