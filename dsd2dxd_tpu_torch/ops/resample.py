"""Plain conv-style DSP in torch: the port's CPU oracle.

Counterpart of ``dsd2dxd_tpu/ops/resample.py`` (``unpack_bits``,
``stage_apply_streaming``, ``quantize_int``, ``make_step``): every stage
is one ``conv1d`` over the zero-stuffed stream with its history carried
between tiles (upfirdn semantics), followed by level, peak, dither and
round-half-to-even quantization. Dither comes from a ``torch.Generator``
(the JAX package uses threefry keys; the two never share bits, so tests
compare with NONE dither or by statistics).

Everything runs in full f32. On a card, cuDNN convolves in TF32 unless
told otherwise -- about three decimal digits, far above the 24-bit
dither floor -- so ``stage_apply_streaming`` switches TF32 off before
it convolves a CUDA tensor.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from dsd2dxd_tpu_torch.filters.design import Stage
from dsd2dxd_tpu_torch.formats.dsd_types import DitherType


@dataclass(frozen=True)
class StepConfig:
    """Static configuration of one convert step (same fields as
    ``dsd2dxd_tpu.ops.resample.StepConfig``)."""

    channels: int
    tile_bytes: int          # DSD bytes per channel per tile
    bit_depth: int           # 16/20/24 int, 32 float
    dither: DitherType
    level_db: float
    dtype: str = "float32"   # accumulation dtype ("float32"/"float64")

    @property
    def tile_bits(self) -> int:
        return self.tile_bytes * 8


_SHIFTS = torch.arange(7, -1, -1, dtype=torch.uint8)


def unpack_bits(x_u8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(C, B) uint8, MSB-first -> (C, 8B) ±1 samples."""
    bits = (x_u8.unsqueeze(-1) >> _SHIFTS.to(x_u8.device)) & 1
    c, b = x_u8.shape
    return bits.reshape(c, b * 8).to(dtype) * 2 - 1


def stage_history_len(stage: Stage) -> int:
    """History carried between tiles, in stage-input samples."""
    return -(-(stage.n_taps - 1) // stage.L)


def full_fp32() -> None:
    """Pin full f32 for convolutions and matmuls on a card."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def stage_apply_streaming(x: torch.Tensor, hist: torch.Tensor, stage: Stage,
                          taps: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One stage on a tile of S input samples with carried history.

    y[j] = sum_k h[k] v[jM - k] over the L-upsampled global stream v, so
    the concatenated tile outputs equal
    ``scipy.signal.upfirdn(h, stream, L, M)[:len(stream)*L//M]``.
    Returns (y of length S*L//M, new history).
    """
    if x.is_cuda:
        full_fp32()
    L, M, n = stage.L, stage.M, stage.n_taps
    h = hist.shape[1]
    c, s = x.shape
    if (s * L) % M != 0:
        raise ValueError(f"tile of {s} samples not aligned to L={L}/M={M}")
    n_out = s * L // M
    xin = torch.cat([hist, x], dim=1)
    if L > 1:
        v = torch.zeros(c, xin.shape[1] * L, dtype=x.dtype, device=x.device)
        v[:, ::L] = xin
    else:
        v = xin
    # out[j] = sum_t w[t] v[start + jM + t] with w = flip(h) and
    # start = hL - (n-1): v index hL + jM - k for tap k = n-1-t
    start = h * L - (n - 1)
    w = torch.flip(taps.to(x.dtype), [0]).reshape(1, 1, n)
    y = F.conv1d(v[:, start:].unsqueeze(1), w, stride=M)[:, 0, :n_out]
    new_hist = xin[:, xin.shape[1] - h:]
    return y, new_hist


def upfirdn_reference(taps: np.ndarray, x: np.ndarray, L: int, M: int) -> np.ndarray:
    """Host float64 oracle (scipy.signal.upfirdn truncated to
    len(x)*L//M outputs)."""
    from scipy.signal import upfirdn

    full = upfirdn(taps, x, up=L, down=M, axis=-1)
    return full[..., :x.shape[-1] * L // M]


def _dither_noise(kind: DitherType, gen: Optional[torch.Generator], shape,
                  dtype, device) -> Optional[torch.Tensor]:
    """Dither in LSB units: TPDF ±1 LSB triangular, RECT ±0.5 LSB."""
    if kind is DitherType.TPDF:
        u = torch.rand((2, *shape), generator=gen, dtype=dtype, device=device)
        return u[0] + u[1] - 1.0
    if kind is DitherType.RECTANGULAR:
        return torch.rand(shape, generator=gen, dtype=dtype,
                          device=device) - 0.5
    return None


def quantize_int(x: torch.Tensor, bit_depth: int,
                 dither: Optional[torch.Tensor]) -> torch.Tensor:
    """Float (±1 full scale) -> int32 at bit_depth, round half to even
    (``torch.round``, as ``jnp.round``), clipped."""
    scale = float(1 << (bit_depth - 1))
    y = x * scale
    if dither is not None:
        y = y + dither
    return torch.clamp(torch.round(y), -scale, scale - 1.0).to(torch.int32)


def init_hists(chain: Sequence[Stage], channels: int, dtype=torch.float32,
               device=None):
    return tuple(torch.zeros(channels, stage_history_len(s), dtype=dtype,
                             device=device) for s in chain)


def make_step(chain: Sequence[Stage], cfg: StepConfig):
    """step(x_u8 (C, tile_bytes), hists, gen) -> (pcm (n_out, C), peak,
    new_hists). pcm is int32 for int depths, f32 for 32-bit output; peak
    is max |level-scaled f32| of the tile. ``gen`` is the
    ``torch.Generator`` the dither draws from (unused without dither)."""
    if cfg.bit_depth == 32 and cfg.dither not in (DitherType.NONE,):
        raise ValueError(f"no {cfg.dither} path for float output here")
    dtype = getattr(torch, cfg.dtype)
    chain = tuple(chain)
    taps = tuple(torch.tensor(np.asarray(s.taps), dtype=dtype) for s in chain)
    gain = 10.0 ** (cfg.level_db / 20.0)

    def step(x_u8, hists, gen=None):
        x = unpack_bits(x_u8, dtype=dtype)
        new_hists = []
        for stage, t, h in zip(chain, taps, hists):
            x, h = stage_apply_streaming(x, h, stage, t.to(x.device))
            new_hists.append(h)
        if gain != 1.0:
            x = x * gain
        peak = torch.max(torch.abs(x)).to(torch.float32)
        if cfg.bit_depth == 32:
            out = x.to(torch.float32)
        else:
            noise = _dither_noise(cfg.dither, gen, x.shape, x.dtype, x.device)
            out = quantize_int(x, cfg.bit_depth, noise)
        return out.T, peak, tuple(new_hists)

    return step
