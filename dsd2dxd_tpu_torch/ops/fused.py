"""The fused decimation step (K1a-K1d): raw DSD bytes -> PCM wire bytes in
one pass, for every pure ÷2^k chain; and the two kernels of the 48k-family
step (K1e, the float head, and K2, the finish), whose step is
``ops/rational.py``.

Counterpart of ``dsd2dxd_tpu/ops/fused.py`` for the forms of
``_build_kernel`` that ``make_fused_step`` builds for pure-decimation
chains: G=1 (K1a), G=2/4 word lanes (K1b), the ÷64/÷128 à-trous tail
(K1c), the 16/20-bit and f32/FPD epilogues (K1d), and the float head of
``make_fused_rational_step`` (K1e); and of ``make_finish_planes`` (K2).
The CUDA kernels are ``csrc/fused_decim.cu`` and ``csrc/finish.cu``;
``fused_decim_reference``, ``fused_decim_cascade`` and
``finish_reference`` below are their plain PyTorch versions.

Semantics carried over from the JAX kernel:

- streaming state is the last ``chain_halo_bytes`` raw bytes of input per
  channel (overlap-save in the byte domain), primed with the DSD idle
  byte 0x69 (fused.py:22-26), so no head of the stream is skipped. The
  halo has the JAX kernel's size (halo lanes x G bytes), so a JAX state
  hands over (``plan.state_from_jax``);
- stage s computes y[j] = sum_k h[k] v[M j - k] with the products summed
  pairwise in tap order (``plan.tree_sum``). Every stage is decimated
  directly: output frame m is the à-trous tail's phase-0 lane, from the
  same products;
- the peak is max |gain * y| over the tile's first ``n_valid`` frames,
  real channels only. (The JAX kernel takes it over the whole fixed tile,
  so a partial final tile counts the filter's ringing into the idle pad;
  the port does not inherit that.)
- integer output: round half to even, clip to the depth; 20-bit is then
  shifted << 4 into a 24-bit container (``containers/pack.py``);
- 32-bit float: y as is, or with FPD y + tpdf * ulp, the ulp taken from
  the exponent bits (fused.py:490-506).

Dropped: the TPU's blocked ``PlaneLayout``, sublane batching, word lanes
and the undecimated tail with its phase-0 extraction. Both versions write
frame-interleaved wire bytes directly, little endian for WAV and raw
output, big endian for AIFF/AIFC. Dither is Philox4x32-10
(``ops/philox.py``), not the TPU's on-core bits.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import threading
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from dsd2dxd_tpu_torch.containers.pack import bytes_per_sample
from dsd2dxd_tpu_torch.filters.design import Stage
from dsd2dxd_tpu_torch.formats.dsd_types import DitherType
from dsd2dxd_tpu_torch.utils.errors import ConfigError
from dsd2dxd_tpu_torch import kernels
from dsd2dxd_tpu_torch.ops import philox
from dsd2dxd_tpu_torch.ops.plan import (
    build_chain_plans,
    params_from_chain,
    tree_sum,
)
from dsd2dxd_tpu_torch.ops.resample import StepConfig, unpack_bits

IDLE_BYTE = 0x69  # DSD silence (alternating ±1)
# K1's output frames per CUDA block at each depth R: the fastest of
# tools/blocksweep.py among the blocks that keep 24 warps resident per SM
# (PERF.md); other depths keep a block's input at BLOCK_BITS bits
BLOCK_OUT = {8: 2048, 16: 1024, 32: 512, 64: 320, 128: 128}
BLOCK_BITS = 1 << 14
S0_VEC = 4            # K1: outputs per thread of stage 0
GROUP = 4             # K1: stage-0 taps per table
_DITHER_CODE = {DitherType.NONE: 0, DitherType.TPDF: 1,
                DitherType.RECTANGULAR: 2, DitherType.FPD: 3}
_INT_DITHERS = (DitherType.NONE, DitherType.TPDF, DitherType.RECTANGULAR)
_FLOAT_DITHERS = (DitherType.NONE, DitherType.FPD)

# Kernel launches (incremented right after each successful launch, and
# nowhere else): a run shows it went through the kernel by reading these.
# MODE_LAUNCHES counts each launch under the TPU-kernel modes it ports
# (``kernel_modes``; K2: the finish "from z", K2t: the finish "from the
# head's samples", ``ops/rational.py::finish_tail_cuda``).
KERNEL_LAUNCHES = 0  # fused_decim launches (K1a-K1e)
MODE_LAUNCHES = {"K1a": 0, "K1b": 0, "K1c": 0, "K1d": 0, "K1e": 0, "K2": 0,
                 "K2t": 0}
_launch_lock = threading.Lock()


def reset_launch_counts() -> None:
    global KERNEL_LAUNCHES
    with _launch_lock:
        KERNEL_LAUNCHES = 0
        for k in MODE_LAUNCHES:
            MODE_LAUNCHES[k] = 0


def decimation(chain: Sequence[Stage]) -> Optional[int]:
    """R when the port's kernel runs `chain` in one pass -- a pure ÷R
    cascade of L=1 stages, R a power of two >= 8, at most
    ``kernels.MAX_STAGES`` stages of < 256 taps -- else None. That is
    every chain the JAX ``fused_plan`` covers without a rational stage."""
    if not chain or any(s.L != 1 for s in chain):
        return None
    r = math.prod(s.M for s in chain)
    if r < 8 or r & (r - 1):
        return None
    if len(chain) > kernels.MAX_STAGES or any(s.n_taps > 255 for s in chain):
        return None
    return r


def kernel_modes(chain: Sequence[Stage], bit_depth: int) -> tuple[str, ...]:
    """The TPU-kernel rows a launch for `chain` at `bit_depth` ports:
    K1a (÷8 at 24 bit), K1b (÷16, ÷32), K1c (÷64 and deeper), and K1d
    for every epilogue other than 24 bit."""
    r = decimation(chain)
    modes = []
    if r == 8:
        if bit_depth == 24:
            modes.append("K1a")
    else:
        modes.append("K1b" if r <= 32 else "K1c")
    if bit_depth != 24:
        modes.append("K1d")
    return tuple(modes)


def block_out_for(chain: Sequence[Stage]) -> int:
    """Output frames per CUDA block of K1 (``BLOCK_OUT``)."""
    r = decimation(chain)
    return BLOCK_OUT.get(r, BLOCK_BITS // r)


def chain_halo_bytes(chain: Sequence[Stage]) -> int:
    """Streaming-state bytes per channel, sized as the JAX
    ``_fused_layout`` sizes the halo of the same chain: the head's stage
    history in G-byte lanes (p0 = 8G, G = min(R/8, 4)) plus the à-trous
    tail's dilated context, rounded up to 128 lanes, times G."""
    r = decimation(chain)
    if r is None:
        raise ValueError("chain not eligible for the fused kernel")
    g = min(r // 8, 4)
    cum, n_head = 1, 0
    while cum < 8 * g:
        cum *= chain[n_head].M
        n_head += 1
    hist = sum(p.hist_lanes
               for p in build_chain_plans(chain[:n_head], p0=8 * g))
    tail_ctx, dil = 0, 1
    for s in chain[n_head:]:
        tail_ctx += (s.n_taps - 1) * dil
        dil *= s.M
    return -(-(hist + tail_ctx) // 128) * 128 * g


def init_fused_halo(chain: Sequence[Stage], channels: int,
                    device=None) -> torch.Tensor:
    """Initial streaming state: (C, halo_bytes) idle bytes."""
    return torch.full((channels, chain_halo_bytes(chain)), IDLE_BYTE,
                      dtype=torch.uint8, device=device)


def context_bits(chain: Sequence[Stage]) -> int:
    """Input bits before output frame m's newest bit that the cascade
    reads (277 for Equiripple DSD64 -> 352.8k, ÷8; 4079 for Equiripple
    DSD256 -> 88.2k, ÷128)."""
    off = 0
    for s in reversed(chain):
        off = s.M * off - (s.n_taps - 1)
    return -off


@dataclass(frozen=True)
class BlockLayout:
    """Where one group of `block_out` consecutive output frames finds
    its input, for the plain version (one group spanning the tile; K1's
    own blocks are ``KernelLayout``).

    Frame m0 of the group reads window bytes from m0 * frame_bytes +
    byte_off on (window = halo ++ tile), its stage-0 samples starting at
    bit bit_off of the first byte; stage s emits out_len[s] samples,
    sample j reading its input buffer from M_s j to M_s j + N_s - 1.
    """

    block_out: int
    frame_bytes: int
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
    return BlockLayout(block_out=block_out,
                       frame_bytes=math.prod(s.M for s in chain) // 8,
                       byte_off=halo_bytes + byte0, bit_off=bit_off,
                       n_load_bytes=-(-(bit_off + in_len0) // 8),
                       n_taps=tuple(s.n_taps for s in chain),
                       decim=tuple(s.M for s in chain),
                       out_len=tuple(out_len))


def fused_decim_cascade(x_u8: torch.Tensor, halo: torch.Tensor,
                        taps: Sequence[torch.Tensor], chain: Sequence[Stage],
                        gain: float) -> torch.Tensor:
    """Plain cascade: (C, T_out) f32 samples gain * y for the tile's
    T_out = T * 8 / R output frames, from the (C, H) halo and (C, T)
    tile bytes."""
    t = x_u8.shape[1]
    lay = block_layout(chain, halo.shape[1],
                       t * 8 // math.prod(s.M for s in chain))
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


def _wire_bytes(q: torch.Tensor, bps: int, big_endian: bool) -> torch.Tensor:
    """(C, T) int32 words -> (T*C*bps,) frame-interleaved wire bytes,
    the low `bps` bytes of each word."""
    parts = [(q >> (8 * i)) & 0xFF for i in range(bps)]
    if big_endian:
        parts.reverse()
    return torch.stack(parts, dim=-1).to(torch.uint8).transpose(0, 1).reshape(-1)


def epilogue_words(y: torch.Tensor, tile_key: int,
                   cfg: StepConfig) -> torch.Tensor:
    """The (C, T_out) int32 words of the epilogue on the f32 samples
    gain * y: the quantized sample (20-bit shifted << 4) at 16/20/24
    bit, the f32 bits (with FPD's ulp noise) at 32. Dither counter
    (frame, channel) under `tile_key`."""
    c, t = y.shape
    if cfg.dither is not DitherType.NONE:
        u0, u1 = philox.uniforms(t, c, tile_key, device=y.device)
    if cfg.bit_depth == 32:
        v = y
        if cfg.dither is DitherType.FPD:
            ulp = (y.view(torch.int32) & 0x7F800000).view(torch.float32)
            v = y + ((u0 + u1) - 1.0) * (ulp * 2.0 ** -23)
        return v.view(torch.int32)
    scale = float(1 << (cfg.bit_depth - 1))
    v = y * scale
    if cfg.dither is DitherType.TPDF:
        v = v + ((u0 + u1) - 1.0)
    elif cfg.dither is DitherType.RECTANGULAR:
        v = v + (u0 - 0.5)
    q = torch.clamp(torch.round(v), -scale, scale - 1.0).to(torch.int32)
    if cfg.bit_depth == 20:
        q = q * 16  # 20 significant bits at the top of 24
    return q


def decim_epilogue(y: torch.Tensor, tile_key: int, cfg: StepConfig,
                   big_endian: bool = False, n_valid: Optional[int] = None):
    """Plain version of the kernel's epilogue on the (C, T_out) f32
    samples gain * y: returns (wire bytes (T_out*C*bps,) uint8, peak f32
    0-d over the first n_valid frames; all frames for None)."""
    q = epilogue_words(y, tile_key, cfg)
    return (_wire_bytes(q, bytes_per_sample(cfg.bit_depth), big_endian),
            masked_peak(y, n_valid))


def masked_peak(y: torch.Tensor, n_valid: Optional[int] = None):
    """max |y| over the first n_valid frames of (C, T) y (all for None;
    0 for none), as a 0-d f32."""
    t = y.shape[1]
    n = t if n_valid is None else max(0, min(int(n_valid), t))
    return (y[:, :n].abs().amax() if n
            else torch.zeros((), dtype=torch.float32, device=y.device))


def finish_reference(z: torch.Tensor, gain: float, tile_key: int,
                     cfg: StepConfig, big_endian: bool = False,
                     n_valid: Optional[int] = None):
    """Plain version of K2 on the (C, n) f32 final-rate samples z: the
    epilogue of gain * z (gain the f32 the kernel multiplies by), with
    the same Philox counter (frame, channel) under the tile's key.

    This is the finish of the JAX rational step (``phase.finish_tile``:
    level gain and peak on the final samples, then dither and quantize;
    the Pallas ``make_finish_planes`` for 16/20/24 bit). Its noise is the
    port's Philox, not the TPU's bits or threefry; FPD takes the ulp from
    the exponent bits, as K1 does, where ``resample.dither_float32`` takes
    2^(floor(log2|y|) - 23): the two are equal for every normal f32, and
    this one leaves zeros and denormals undithered."""
    return decim_epilogue(z * gain, tile_key, cfg, big_endian, n_valid)


def fused_decim_reference(x_u8: torch.Tensor, halo: torch.Tensor,
                          tile_key: int, taps: Sequence[torch.Tensor],
                          chain: Sequence[Stage], cfg: StepConfig,
                          big_endian: bool = False,
                          n_valid: Optional[int] = None):
    """Plain PyTorch version of the kernel, on any device.

    Returns (wire bytes (T_out*C*bps,) uint8, peak f32 0-d, new halo)."""
    y = fused_decim_cascade(x_u8, halo, taps, chain, _gain32(cfg))
    wire, peak = decim_epilogue(y, tile_key, cfg, big_endian, n_valid)
    new_halo = x_u8[:, x_u8.shape[1] - halo.shape[1]:].clone()
    return wire, peak, new_halo


def _gain32(cfg: StepConfig) -> float:
    """The level gain as the f32 the kernel multiplies by."""
    return float(np.float32(10.0 ** (cfg.level_db / 20.0)))


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def _chunks(n_taps: int) -> int:
    """float4 chunks of each polyphase half a K1 thread reads for its
    kernels.VEC outputs of a ÷2 stage of n_taps taps."""
    return (kernels.VEC - 1 + (n_taps - 1) // 2) // 4 + 1


@dataclass(frozen=True)
class KernelLayout:
    """One CUDA block of K1 (``csrc/fused_decim.cu``): `block_out` output
    frames of one channel, from its own window of packed bits.

    The block of frame m0 copies window bytes m0 * frame_bytes + byte_off
    on (n_load_bytes of them; window = halo ++ tile) to shared memory as
    big-endian u32 words, bits MSB-first. Stage 0's taps are zero-padded
    to 4 * n_groups; its output j reads the 4 * n_groups bits from bit
    bit_off + decim[0] * j of that span on, tap k the (4 n_groups - 1 -
    k)-th, a group of 4 taps through a 16-entry table of its subtree sums
    (``stage0_tables``). Stage s computes n_out[s] outputs (a whole number
    of per-thread vectors: S0_VEC at stage 0, kernels.VEC after; the last
    stage's are block_out and then some). Stage s >= 1 is ÷2 and reads its
    input x in two polyphase halves of half[s] floats each (x[2i], then
    x[2i+1]), which stage s - 1 writes; the last stage writes its outputs
    in order. Shared memory (f32 slots): the coefficients (n_coefs
    floats: the tables, then each later stage's taps padded to 4, from
    the first 64-byte boundary of a region 16 floats longer), the window
    words, buffer A (the outputs of stages 0, 2, ...) and buffer B
    (stages 1, 3, ...).
    """

    block_out: int
    frame_bytes: int
    byte_off: int
    bit_off: int
    n_load_bytes: int
    n_groups: int
    n_taps: tuple[int, ...]
    decim: tuple[int, ...]
    n_out: tuple[int, ...]
    half: tuple[int, ...]  # 0 at stage 0
    n_coefs: int
    win_words: int
    a_len: int
    b_len: int

    @property
    def out_floats(self) -> tuple[int, ...]:
        """Floats each stage's output takes in its buffer."""
        return tuple(2 * h for h in self.half[1:]) + (self.n_out[-1],)

    @property
    def tap_off(self) -> tuple[int, ...]:
        """Offset of each stage's taps among the coefficients (stage 0:
        its tables, at 0)."""
        offs, off = [0], 16 * self.n_groups
        for n in self.n_taps[1:]:
            offs.append(off)
            off += _up(n, 4)
        return tuple(offs)

    @property
    def win(self) -> int:
        """f32 offset of the window words (after the coefficients'
        region)."""
        return self.n_coefs + 16

    @property
    def smem_bytes(self) -> int:
        return 4 * (self.win + self.win_words + self.a_len + self.b_len)


def kernel_layout(chain: Sequence[Stage], halo_bytes: int,
                  block_out: int) -> KernelLayout:
    n_taps = tuple(s.n_taps for s in chain)
    decim = tuple(s.M for s in chain)
    last = len(chain) - 1
    vec = kernels.VEC
    n_out = [_up(block_out, vec if last else S0_VEC)]
    for s in range(last, 0, -1):
        need = (n_out[0] - 1) * decim[s] + n_taps[s]
        n_out.insert(0, _up(need, vec if s > 1 else S0_VEC))
    half = [0]
    for s in range(1, last + 1):
        read = 4 * (n_out[s] // vec - 1 + _chunks(n_taps[s]))
        half.append(_up(max(-(-n_out[s - 1] // 2), read), 4))
    n_groups = -(-n_taps[0] // GROUP)
    off0 = -context_bits(chain) - (GROUP * n_groups - n_taps[0])
    byte0, bit_off = divmod(off0, 8)  # floor division: byte0 < 0
    if halo_bytes + byte0 < 0:
        raise ValueError(f"halo of {halo_bytes} bytes is shorter than the "
                         f"chain's {-off0}-bit context")
    n_load = -(-(bit_off + decim[0] * (n_out[0] - 1) + GROUP * n_groups) // 8)
    lay = KernelLayout(
        block_out=block_out, frame_bytes=math.prod(decim) // 8,
        byte_off=halo_bytes + byte0, bit_off=bit_off, n_load_bytes=n_load,
        n_groups=n_groups, n_taps=n_taps, decim=decim, n_out=tuple(n_out),
        half=tuple(half),
        n_coefs=16 * n_groups + sum(_up(n, 4) for n in n_taps[1:]),
        # the copy starts up to 15 bytes early (16-byte loads), and a
        # stage-0 read takes the word after the last it needs
        win_words=4 * (-(-(15 + n_load) // 16) + 1), a_len=0, b_len=0)
    outs = lay.out_floats
    return dataclasses.replace(lay, a_len=max(outs[0::2]),
                               b_len=max([0] + list(outs[1::2])))


def stage0_tables(taps0: torch.Tensor) -> torch.Tensor:
    """(n_groups, 16) f32 tables of stage 0: entry v of group g is the
    pairwise subtree sum (h0 + h1) + (h2 + h3) of the products
    h_i = h[4g + i] * (+1 if bit i of v else -1), the taps zero-padded
    to a multiple of 4. The products are exact, so the entry is the tree
    sum of those four products, and a stage-0 output is the tree sum of
    its groups' entries (``plan.tree_sum`` over the padded taps)."""
    h = taps0.detach().to("cpu", torch.float32)
    q = -(-h.numel() // GROUP)
    h = torch.cat([h, h.new_zeros(GROUP * q - h.numel())]).view(q, 1, GROUP)
    bits = (torch.arange(16).view(16, 1) >> torch.arange(GROUP)) & 1
    p = h * torch.where(bits == 1, 1.0, -1.0)  # (q, 16, 4)
    return (p[..., 0] + p[..., 1]) + (p[..., 2] + p[..., 3])


def kernel_coefs(chain: Sequence[Stage], device=None) -> torch.Tensor:
    """K1's coefficients, as ``KernelLayout`` places them: stage 0's
    tables, then each later stage's f32 taps zero-padded to 4."""
    taps = [p.taps for p in params_from_chain(chain)]
    parts = [stage0_tables(taps[0]).reshape(-1)]
    for t in taps[1:]:
        parts.append(torch.cat([t, t.new_zeros(_up(t.numel(), 4)
                                               - t.numel())]))
    return torch.cat(parts).to(device)


def check_epilogue(cfg: StepConfig) -> None:
    """Raise ConfigError for an epilogue K1 and K2 do not have."""
    if cfg.bit_depth not in (16, 20, 24, 32):
        raise ConfigError(f"no {cfg.bit_depth}-bit output")
    allowed = _FLOAT_DITHERS if cfg.bit_depth == 32 else _INT_DITHERS
    if cfg.dither not in allowed:
        raise ConfigError(f"the kernels have no {cfg.dither} path at "
                          f"{cfg.bit_depth} bit")


def check_step_config(chain: Sequence[Stage], cfg: StepConfig) -> None:
    """Raise ConfigError for what the kernel does not cover."""
    r = decimation(chain)
    if r is None:
        raise ConfigError(f"the fused kernel covers pure ÷2^k chains (L=1, "
                          f"÷8 and deeper, <= {kernels.MAX_STAGES} stages "
                          f"of < 256 taps) only")
    if any(s.M != 2 for s in chain[1:]):
        raise ConfigError("the fused kernel's stages after the first are "
                          "÷2 only")
    check_epilogue(cfg)
    halo = chain_halo_bytes(chain)
    if cfg.tile_bytes < halo:
        raise ConfigError(f"tile of {cfg.tile_bytes} bytes is shorter "
                          f"than the {halo}-byte halo")
    if cfg.tile_bytes % (r // 8):
        raise ConfigError(f"tile of {cfg.tile_bytes} bytes is not whole "
                          f"frames of {r // 8} bytes")


def _kernel_params(chain, cfg: StepConfig, halo_bytes: int, tile_key: int,
                   big_endian: bool, n_valid: int, planar: bool = False,
                   block_out: Optional[int] = None) -> kernels.DecimParams:
    """The kernel's DecimParams; `block_out` overrides block_out_for."""
    lay = kernel_layout(chain, halo_bytes, block_out or block_out_for(chain))
    p = kernels.DecimParams()
    p.n_stages = len(chain)
    p.channels = cfg.channels
    p.tile_bytes = cfg.tile_bytes
    p.tile_frames = cfg.tile_bytes // lay.frame_bytes
    p.frame_bytes = lay.frame_bytes
    p.n_valid = n_valid
    p.halo_bytes = halo_bytes
    p.block_out = lay.block_out
    p.byte_off = lay.byte_off
    p.bit_off = lay.bit_off
    p.n_load_bytes = lay.n_load_bytes
    p.n_groups = lay.n_groups
    p.decim0 = lay.decim[0]
    p.n_coefs = lay.n_coefs
    p.win = lay.win
    p.buf_a = p.win + lay.win_words
    p.buf_b = p.buf_a + lay.a_len
    p.smem_bytes = lay.smem_bytes
    for s, off in enumerate(lay.tap_off):
        p.n_taps[s] = lay.n_taps[s]
        p.tap_off[s] = off
        p.n_out[s] = lay.n_out[s]
        p.half[s] = lay.half[s]
    gain = _gain32(cfg)
    p.gain = gain
    p.apply_gain = int(gain != 1.0)
    p.bit_depth = cfg.bit_depth
    p.dither = _DITHER_CODE[cfg.dither]
    p.key0 = tile_key & 0xFFFFFFFF
    p.key1 = (tile_key >> 32) & 0xFFFFFFFF
    p.big_endian = int(big_endian)
    p.planar = int(planar)
    return p


def check_coefs(coefs: torch.Tensor, params: kernels.DecimParams,
                device: torch.device) -> None:
    """Raise ValueError unless `coefs` are the launch's f32 coefficients
    (``kernel_coefs``), contiguous and 16-byte aligned on `device`."""
    if (coefs.dtype != torch.float32 or coefs.numel() != params.n_coefs
            or not coefs.is_contiguous() or coefs.data_ptr() % 16
            or coefs.device != device):
        raise ValueError(f"want the chain's {params.n_coefs} f32 "
                         f"coefficients (kernel_coefs), contiguous and "
                         f"16-byte aligned on {device}, got "
                         f"{coefs.dtype}{tuple(coefs.shape)}@{coefs.device}")


def _launch_decim(x_u8: torch.Tensor, halo: torch.Tensor,
                  coefs: torch.Tensor, out: torch.Tensor,
                  peak: Optional[torch.Tensor], params: kernels.DecimParams,
                  modes: Sequence[str],
                  device_index: Optional[int] = None) -> None:
    """Launch fused_decim on the current stream of x's device, made the
    current device; raise if the launch fails, else count it under
    `modes`. `device_index` overrides the index the C entry expects (a
    check of its refusal: any other index than x's raises)."""
    global KERNEL_LAUNCHES
    check_coefs(coefs, params, x_u8.device)
    lib = kernels.load()
    with kernels.launch_device(x_u8.device) as (stream, dev):
        rc = lib.dsd2dxd_fused_decim(
            halo.data_ptr(), x_u8.data_ptr(), coefs.data_ptr(),
            out.data_ptr(), None if peak is None else peak.data_ptr(),
            ctypes.byref(params), stream,
            dev if device_index is None else device_index)
    if rc != 0:
        raise RuntimeError(f"fused_decim ({'+'.join(modes)}) launch failed: "
                           f"CUDA error {rc}")
    with _launch_lock:
        KERNEL_LAUNCHES += 1
        for mode in modes:
            MODE_LAUNCHES[mode] += 1


def fused_decim_cuda(x_u8: torch.Tensor, halo: torch.Tensor, tile_key: int,
                     coefs: torch.Tensor, chain: Sequence[Stage],
                     cfg: StepConfig, big_endian: bool = False,
                     n_valid: Optional[int] = None,
                     block_out: Optional[int] = None):
    """Launch the kernel on the current stream of x's device, with the
    chain's ``kernel_coefs`` on the card. Same contract as
    ``fused_decim_reference``; raises if the launch fails."""
    c, t = x_u8.shape
    t_out = t * 8 // decimation(chain)
    n = t_out if n_valid is None else max(0, min(int(n_valid), t_out))
    out = torch.empty(t_out * c * bytes_per_sample(cfg.bit_depth),
                      dtype=torch.uint8, device=x_u8.device)
    peak = torch.zeros(1, dtype=torch.float32, device=x_u8.device)
    params = _kernel_params(chain, cfg, halo.shape[1], tile_key, big_endian,
                            n, block_out=block_out)
    _launch_decim(x_u8, halo, coefs, out, peak, params,
                  kernel_modes(chain, cfg.bit_depth))
    new_halo = x_u8[:, t - halo.shape[1]:].clone()
    return out, peak[0], new_halo


def fused_head_cuda(x_u8: torch.Tensor, halo: torch.Tensor,
                    coefs: torch.Tensor,
                    chain: Sequence[Stage]) -> torch.Tensor:
    """K1e: launch the kernel in its planar mode on the current stream,
    with the chain's ``kernel_coefs`` on the card: (C, T_out) f32, the
    gain-1 undithered cascade output of the tile (no peak). Same result
    as ``fused_decim_cascade(x_u8, halo, taps, chain, 1.0)``; raises if
    the launch fails."""
    c, t = x_u8.shape
    t_out = t * 8 // decimation(chain)
    out = torch.empty((c, t_out), dtype=torch.float32, device=x_u8.device)
    cfg = StepConfig(channels=c, tile_bytes=t, bit_depth=32,
                     dither=DitherType.NONE, level_db=0.0)
    params = _kernel_params(chain, cfg, halo.shape[1], 0, False, t_out,
                            planar=True)
    _launch_decim(x_u8, halo, coefs, out, None, params, ("K1e",))
    return out


def make_head(chain: Sequence[Stage], device):
    """The float head of the 48k step, on `device`:

    head(x_u8 (C, T) uint8, halo (C, H) uint8) -> (C, T_out) f32, the
    gain-1 undithered cascade of the tile. A CUDA tensor launches K1e
    (``fused_head_cuda``, or raises); a CPU tensor runs
    ``fused_decim_cascade``."""
    chain = tuple(chain)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    taps = [p.taps.to(device) for p in params_from_chain(chain)]
    coefs = kernel_coefs(chain, device)

    def head(x_u8: torch.Tensor, halo: torch.Tensor) -> torch.Tensor:
        if x_u8.device != device:
            raise ValueError(f"head built for {device}, got {x_u8.device}")
        if x_u8.is_cuda:
            return fused_head_cuda(x_u8, halo, coefs, chain)
        if x_u8.device.type == "cpu":
            return fused_decim_cascade(x_u8, halo, taps, chain, 1.0)
        raise ConfigError(f"no head path on {x_u8.device}")

    return head


def kernel_occupancy(chain: Sequence[Stage],
                     block_out: Optional[int] = None) -> dict:
    """K1 on the current card at `chain`'s layout: shared memory per
    block, resident blocks and warps per SM (cudaOccupancyMaxActiveBlocks
    PerMultiprocessor), registers per thread and local (stack) bytes per
    thread (cudaFuncGetAttributes)."""
    lay = kernel_layout(chain, chain_halo_bytes(chain),
                        block_out or block_out_for(chain))
    res = (ctypes.c_int * 4)()
    device = torch.device("cuda", torch.cuda.current_device())
    lib = kernels.load()
    with kernels.launch_device(device) as (_stream, dev):
        rc = lib.dsd2dxd_fused_decim_attrs(lay.smem_bytes, res, dev)
    if rc != 0:
        raise RuntimeError(f"fused_decim attributes: CUDA error {rc}")
    return {"smem_bytes": lay.smem_bytes, "blocks_per_sm": res[0],
            "warps_per_sm": res[0] * res[1] // 32, "regs": res[2],
            "local_bytes": res[3]}


# K2 "from z": frames per run (a power of two >= 16; the fastest of
# tools/finishsweep.py: for stereo four items per thread and a barrier
# every 4096 samples), halved for wide files until the two staged runs of
# 32-bit samples fit 40 KB of the 48 KB of shared memory a block has
# without asking (the kernel keeps a few static bytes too)
FINISH_RUN_FRAMES = 2048
_FINISH_STAGE_BYTES = 40 * 1024


def finish_params(n: int, channels: int, gain: float, tile_key: int,
                  cfg: StepConfig, big_endian: bool, n_valid: Optional[int],
                  run_frames: Optional[int] = None) -> kernels.FinishParams:
    """K2's FinishParams for (channels, n) final frames: the epilogue
    fields both modes read, and the run of mode "from z" (`run_frames`
    overrides FINISH_RUN_FRAMES)."""
    p = kernels.FinishParams()
    p.n_frames = n
    p.n_valid = n if n_valid is None else max(0, min(int(n_valid), n))
    p.channels = channels
    p.gain = gain
    p.bit_depth = cfg.bit_depth
    p.dither = _DITHER_CODE[cfg.dither]
    p.key0 = tile_key & 0xFFFFFFFF
    p.key1 = (tile_key >> 32) & 0xFFFFFFFF
    p.big_endian = int(big_endian)
    p.run_frames = run_frames or FINISH_RUN_FRAMES
    while (p.run_frames >= 16
           and 8 * channels * p.run_frames > _FINISH_STAGE_BYTES):
        p.run_frames //= 2
    if p.run_frames < 16:
        raise ConfigError(f"the finish kernel stages at most "
                          f"{_FINISH_STAGE_BYTES // 128} channels")
    return p


def count_launch(*modes: str) -> None:
    """Count one launch under each of `modes` (``MODE_LAUNCHES``)."""
    with _launch_lock:
        for mode in modes:
            MODE_LAUNCHES[mode] += 1


def finish_cuda(z: torch.Tensor, gain: float, tile_key: int,
                cfg: StepConfig, big_endian: bool = False,
                n_valid: Optional[int] = None,
                run_frames: Optional[int] = None):
    """K2 "from z": launch the finish kernel on the current stream. Same
    contract as ``finish_reference``: (wire bytes (n*C*bps,) uint8, peak
    f32 0-d); raises if the launch fails. `run_frames` overrides the
    kernel's frames per run (a power of two >= 16)."""
    lib = kernels.load()
    if z.dtype != torch.float32 or z.dim() != 2 or not z.is_contiguous():
        raise ValueError(f"want contiguous (C, n) f32, got {z.dtype} "
                         f"{tuple(z.shape)}")
    c, n = z.shape
    out = torch.empty(n * c * bytes_per_sample(cfg.bit_depth),
                      dtype=torch.uint8, device=z.device)
    peak = torch.zeros(1, dtype=torch.float32, device=z.device)
    p = finish_params(n, c, gain, tile_key, cfg, big_endian, n_valid,
                      run_frames)
    with kernels.launch_device(z.device) as (stream, dev):
        rc = lib.dsd2dxd_finish(z.data_ptr(), out.data_ptr(),
                                peak.data_ptr(), ctypes.byref(p), stream, dev)
    if rc != 0:
        raise RuntimeError(f"finish (K2) launch failed: CUDA error {rc}")
    count_launch("K2")
    return out, peak[0]


def make_fused_step(chain: Sequence[Stage], cfg: StepConfig, device,
                    big_endian: bool = False,
                    block_out: Optional[int] = None):
    """The fused step for `chain` and `cfg`: 16/20/24-bit with
    TPDF/RECT/NONE, or 32-bit float with NONE/FPD. `block_out` overrides
    the kernel's output frames per block (``block_out_for``).

    step(x_u8 (C, tile) uint8, halo (C, halo_bytes) uint8, tile_key,
         n_valid=None) -> (wire bytes (T_out*C*bps,) uint8, peak f32 0-d,
         new halo)

    ``n_valid`` bounds the frames the peak covers (all for None). A CUDA
    tensor launches the kernel (or raises); a CPU tensor runs the plain
    version. Nothing else is accepted, and nothing falls back.
    """
    chain = tuple(chain)
    check_step_config(chain, cfg)
    halo_bytes = chain_halo_bytes(chain)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    taps = [p.taps.to(device) for p in params_from_chain(chain)]
    coefs = kernel_coefs(chain, device)

    def step(x_u8: torch.Tensor, halo: torch.Tensor, tile_key: int,
             n_valid: Optional[int] = None):
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
            return fused_decim_cuda(x_u8, halo, tile_key, coefs, chain,
                                    cfg, big_endian, n_valid, block_out)
        if x_u8.device.type == "cpu":
            return fused_decim_reference(x_u8, halo, tile_key, taps, chain,
                                         cfg, big_endian, n_valid)
        raise ConfigError(f"no fused decimation path on {x_u8.device}")

    return step
