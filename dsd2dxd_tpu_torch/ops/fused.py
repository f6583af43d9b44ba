"""The fused ÷8 step (K1a): raw DSD bytes -> 24-bit wire bytes in one pass.

Counterpart of ``dsd2dxd_tpu/ops/fused.py`` for the main path: the G=1,
no-tail, ``emit="planes"`` form of ``_build_kernel`` that
``make_fused_step`` builds. The CUDA kernel is ``csrc/fused_div8.cu``;
``fused_div8_reference`` below is its plain PyTorch version.

Semantics carried over from the JAX kernel:

- streaming state is the last ``chain_halo_bytes`` raw bytes of input per
  channel (overlap-save in the byte domain), primed with the DSD idle
  byte 0x69 (fused.py:22-26), so no head of the stream is skipped;
- stage s computes y[j] = sum_k h[k] v[M j - k] with the products summed
  pairwise in tap order (``plan.tree_sum``);
- the peak is max |gain * y| over the whole fixed tile, real channels only;
- round half to even, clip to [-2^23, 2^23 - 1].

Dropped: the TPU's blocked ``PlaneLayout``, sublane batching and word
groups. Both versions write frame-interleaved wire bytes directly, little
endian for WAV and raw output, big endian for AIFF/AIFC. Dither is
Philox4x32-10 (``ops/philox.py``), not the TPU's on-core bits.
"""

from __future__ import annotations

import ctypes
import math
import threading
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from dsd2dxd_tpu.filters.design import Stage
from dsd2dxd_tpu.formats.dsd_types import DitherType
from dsd2dxd_tpu.utils.errors import ConfigError
from dsd2dxd_tpu_torch import kernels
from dsd2dxd_tpu_torch.ops import philox
from dsd2dxd_tpu_torch.ops.plan import (
    build_chain_plans,
    params_from_chain,
    tree_sum,
)
from dsd2dxd_tpu_torch.ops.resample import StepConfig, unpack_bits

IDLE_BYTE = 0x69  # DSD silence (alternating ±1)
BLOCK_OUT = 512   # output frames per CUDA block
BIT_DEPTH = 24
_SCALE = float(1 << (BIT_DEPTH - 1))
_DITHER_CODE = {DitherType.NONE: 0, DitherType.TPDF: 1,
                DitherType.RECTANGULAR: 2}

# Kernel launches (incremented right after each successful launch, and
# nowhere else): a run shows it went through the kernel by reading this.
KERNEL_LAUNCHES = 0
_launch_lock = threading.Lock()


def fused_plan(chain: Sequence[Stage]):
    """(n_head, groups, r_tail) = (len(chain), 1, 1) when the port's
    kernel runs `chain` in one pass -- a pure ÷8 cascade of L=1 stages,
    every stage stride-1 in the phase plan -- else None. (The JAX
    ``fused_plan`` also covers G=2/4 word lanes and à-trous tails; the
    port does not yet.)"""
    if not chain or any(s.L != 1 for s in chain):
        return None
    if math.prod(s.M for s in chain) != 8:
        return None
    plans = build_chain_plans(chain, p0=8)
    if not all(p.rephase == 1 and p.lane_stride == 1 for p in plans):
        return None
    return (len(chain), 1, 1)


def chain_halo_bytes(chain: Sequence[Stage]) -> int:
    """Streaming-state bytes per channel, as the JAX ``_fused_layout``
    sizes it for a G=1 no-tail chain: the summed stage history in bytes,
    rounded up to 128."""
    if fused_plan(chain) is None:
        raise ValueError("chain not eligible for the fused ÷8 kernel")
    hist = sum(p.hist_lanes for p in build_chain_plans(chain, p0=8))
    return -(-hist // 128) * 128


def init_fused_halo(chain: Sequence[Stage], channels: int,
                    device=None) -> torch.Tensor:
    """Initial streaming state: (C, halo_bytes) idle bytes."""
    return torch.full((channels, chain_halo_bytes(chain)), IDLE_BYTE,
                      dtype=torch.uint8, device=device)


def context_bits(chain: Sequence[Stage]) -> int:
    """Input bits before output frame m's first bit that the cascade
    reads (277 for the Equiripple DSD64 chain)."""
    off = 0
    for s in reversed(chain):
        off = s.M * off - (s.n_taps - 1)
    return -off


@dataclass(frozen=True)
class BlockLayout:
    """Where one group of `block_out` consecutive output frames finds
    its input, for the kernel (one CUDA block per group and channel) and
    for the plain version (one group spanning the tile).

    Frame m0 of the group reads window bytes from m0 + byte_off on
    (window = halo ++ tile), its stage-0 samples starting at bit bit_off
    of the first byte; stage s emits out_len[s] samples, sample j
    reading its input buffer from M_s j to M_s j + N_s - 1.
    """

    block_out: int
    byte_off: int
    bit_off: int
    n_load_bytes: int
    n_taps: tuple[int, ...]
    decim: tuple[int, ...]
    out_len: tuple[int, ...]

    @property
    def in_len(self) -> tuple[int, ...]:
        return tuple((o - 1) * m + n for o, m, n in
                     zip(self.out_len, self.decim, self.n_taps))


def block_layout(chain: Sequence[Stage], halo_bytes: int,
                 block_out: int) -> BlockLayout:
    out_len = [block_out]
    for s in reversed(chain[1:]):
        out_len.insert(0, (out_len[0] - 1) * s.M + s.n_taps)
    in_len0 = (out_len[0] - 1) * chain[0].M + chain[0].n_taps
    off0 = -context_bits(chain)
    byte0, bit_off = divmod(off0, 8)  # floor division: byte0 < 0
    if halo_bytes + byte0 < 0:
        raise ValueError(f"halo of {halo_bytes} bytes is shorter than the "
                         f"chain's {-off0}-bit context")
    return BlockLayout(block_out=block_out, byte_off=halo_bytes + byte0,
                       bit_off=bit_off,
                       n_load_bytes=-(-(bit_off + in_len0) // 8),
                       n_taps=tuple(s.n_taps for s in chain),
                       decim=tuple(s.M for s in chain),
                       out_len=tuple(out_len))


def fused_div8_cascade(x_u8: torch.Tensor, halo: torch.Tensor,
                       taps: Sequence[torch.Tensor], chain: Sequence[Stage],
                       gain: float) -> torch.Tensor:
    """Plain cascade: (C, T) f32 samples gain * y for the tile's T
    output frames, from the (C, H) halo and (C, T) tile bytes."""
    c, t = x_u8.shape
    lay = block_layout(chain, halo.shape[1], t)
    window = torch.cat([halo, x_u8], dim=1)[:, lay.byte_off:]
    v = unpack_bits(window)[:, lay.bit_off:]
    for tp, n, m, o in zip(taps, lay.n_taps, lay.decim, lay.out_len):
        hk = tp.tolist()
        # products in tap order: h[k] * v[M j + n - 1 - k]
        v = tree_sum(
            v[:, n - 1 - k:n - 1 - k + (o - 1) * m + 1:m] * hk[k]
            for k in range(n))
    if gain != 1.0:
        v = v * gain
    return v


def _wire_bytes(q: torch.Tensor, big_endian: bool) -> torch.Tensor:
    """(C, T) int32 -> (T*C*3,) frame-interleaved 24-bit bytes."""
    parts = [q & 0xFF, (q >> 8) & 0xFF, (q >> 16) & 0xFF]
    if big_endian:
        parts.reverse()
    return torch.stack(parts, dim=-1).to(torch.uint8).transpose(0, 1).reshape(-1)


def fused_div8_reference(x_u8: torch.Tensor, halo: torch.Tensor,
                         tile_key: int, taps: Sequence[torch.Tensor],
                         chain: Sequence[Stage], cfg: StepConfig,
                         big_endian: bool = False):
    """Plain PyTorch version of the K1a kernel, on any device.

    Returns (wire bytes (T*C*3,) uint8, peak f32 0-d, new halo)."""
    gain = _gain32(cfg)
    y = fused_div8_cascade(x_u8, halo, taps, chain, gain)
    peak = torch.max(torch.abs(y))
    v = y * _SCALE
    if cfg.dither is not DitherType.NONE:
        c, t = y.shape
        u0, u1 = philox.uniforms(t, c, tile_key, device=y.device)
        v = v + ((u0 + u1) - 1.0 if cfg.dither is DitherType.TPDF
                 else u0 - 0.5)
    q = torch.clamp(torch.round(v), -_SCALE, _SCALE - 1.0).to(torch.int32)
    new_halo = x_u8[:, x_u8.shape[1] - halo.shape[1]:].clone()
    return _wire_bytes(q, big_endian), peak, new_halo


def _gain32(cfg: StepConfig) -> float:
    """The level gain as the f32 the kernel multiplies by."""
    return float(np.float32(10.0 ** (cfg.level_db / 20.0)))


def check_step_config(chain: Sequence[Stage], cfg: StepConfig) -> None:
    """Raise ConfigError for what K1a does not cover."""
    if fused_plan(chain) is None:
        raise ConfigError("the fused ÷8 kernel covers pure ÷8 chains only")
    if cfg.bit_depth != BIT_DEPTH:
        raise ConfigError(f"the fused ÷8 kernel emits 24-bit output, not "
                          f"{cfg.bit_depth}-bit")
    if cfg.dither not in _DITHER_CODE:
        raise ConfigError(f"the fused ÷8 kernel has no {cfg.dither} path")
    if any(s.n_taps > 255 for s in chain) or len(chain) > kernels.MAX_STAGES:
        raise ConfigError(f"chain exceeds the kernel's {kernels.MAX_STAGES} "
                          f"stages of < 256 taps")
    if cfg.tile_bytes < chain_halo_bytes(chain):
        raise ConfigError(f"tile of {cfg.tile_bytes} bytes is shorter "
                          f"than the {chain_halo_bytes(chain)}-byte halo")


def _kernel_params(chain, cfg: StepConfig, halo_bytes: int, tile_key: int,
                   big_endian: bool) -> kernels.Div8Params:
    lay = block_layout(chain, halo_bytes, BLOCK_OUT)
    n_taps_total = sum(lay.n_taps)
    # stage-s inputs: s even -> buffer A (stage 0 holds whole bytes), odd -> B
    in_len = lay.in_len
    a_len = max([lay.n_load_bytes * 8] + list(in_len[2::2]))
    b_len = max([0] + list(in_len[1::2]))
    p = kernels.Div8Params()
    p.n_stages = len(chain)
    p.channels = cfg.channels
    p.tile_frames = cfg.tile_bytes
    p.halo_bytes = halo_bytes
    p.block_out = lay.block_out
    p.byte_off = lay.byte_off
    p.bit_off = lay.bit_off
    p.n_load_bytes = lay.n_load_bytes
    p.n_taps_total = n_taps_total
    p.buf_a = n_taps_total
    p.buf_b = n_taps_total + a_len
    p.smem_bytes = 4 * (n_taps_total + a_len + b_len)
    off = 0
    for s in range(len(chain)):
        p.n_taps[s] = lay.n_taps[s]
        p.decim[s] = lay.decim[s]
        p.tap_off[s] = off
        p.out_len[s] = lay.out_len[s]
        off += lay.n_taps[s]
    gain = _gain32(cfg)
    p.gain = gain
    p.apply_gain = int(gain != 1.0)
    p.scale = _SCALE
    p.dither = _DITHER_CODE[cfg.dither]
    p.key0 = tile_key & 0xFFFFFFFF
    p.key1 = (tile_key >> 32) & 0xFFFFFFFF
    p.big_endian = int(big_endian)
    return p


def fused_div8_cuda(x_u8: torch.Tensor, halo: torch.Tensor, tile_key: int,
                    taps_flat: torch.Tensor, chain: Sequence[Stage],
                    cfg: StepConfig, big_endian: bool = False):
    """Launch K1a on the current stream. Same contract as
    ``fused_div8_reference``; raises if the launch fails."""
    global KERNEL_LAUNCHES
    lib = kernels.load()
    c, t = x_u8.shape
    out = torch.empty(t * c * 3, dtype=torch.uint8, device=x_u8.device)
    peak = torch.zeros(1, dtype=torch.float32, device=x_u8.device)
    params = _kernel_params(chain, cfg, halo.shape[1], tile_key, big_endian)
    stream = torch.cuda.current_stream(x_u8.device).cuda_stream
    rc = lib.dsd2dxd_fused_div8(halo.data_ptr(),
                                x_u8.data_ptr(), taps_flat.data_ptr(),
                                out.data_ptr(), peak.data_ptr(),
                                ctypes.byref(params), stream)
    if rc != 0:
        raise RuntimeError(f"fused_div8 launch failed: CUDA error {rc}")
    with _launch_lock:
        KERNEL_LAUNCHES += 1
    new_halo = x_u8[:, t - halo.shape[1]:].clone()
    return out, peak[0], new_halo


def make_fused_step(chain: Sequence[Stage], cfg: StepConfig, device,
                    big_endian: bool = False):
    """The fused ÷8 step for `chain` and `cfg` (24-bit, TPDF/RECT/NONE).

    step(x_u8 (C, tile) uint8, halo (C, halo_bytes) uint8, tile_key) ->
        (wire bytes (tile*C*3,) uint8, peak f32 0-d, new halo)

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
    plain version. Nothing else is accepted, and nothing falls back.
    """
    chain = tuple(chain)
    check_step_config(chain, cfg)
    halo_bytes = chain_halo_bytes(chain)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    taps = [p.taps.to(device) for p in params_from_chain(chain)]
    taps_flat = torch.cat(taps)

    def step(x_u8: torch.Tensor, halo: torch.Tensor, tile_key: int):
        if (x_u8.dtype != torch.uint8 or halo.dtype != torch.uint8
                or tuple(x_u8.shape) != (cfg.channels, cfg.tile_bytes)
                or tuple(halo.shape) != (cfg.channels, halo_bytes)
                or not (x_u8.is_contiguous() and halo.is_contiguous())
                or x_u8.device != halo.device):
            raise ValueError(
                f"want contiguous uint8 x {(cfg.channels, cfg.tile_bytes)} "
                f"and halo {(cfg.channels, halo_bytes)} on one device, got "
                f"{x_u8.dtype}{tuple(x_u8.shape)}@{x_u8.device} and "
                f"{halo.dtype}{tuple(halo.shape)}@{halo.device}")
        if x_u8.device != device:
            raise ValueError(f"step built for {device}, got {x_u8.device}")
        if x_u8.is_cuda:
            return fused_div8_cuda(x_u8, halo, tile_key, taps_flat, chain,
                                   cfg, big_endian)
        if x_u8.device.type == "cpu":
            return fused_div8_reference(x_u8, halo, tile_key, taps, chain,
                                        cfg, big_endian)
        raise ConfigError(f"no fused ÷8 path on {x_u8.device}")

    return step
