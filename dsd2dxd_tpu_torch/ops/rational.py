"""The 48k-family step: raw DSD bytes -> PCM wire bytes at 96/192/384 kHz.

Counterpart of ``dsd2dxd_tpu/ops/fused.py::make_fused_rational_step`` (with
``fused_rational_plan`` and ``init_fused_rational_state``) and of the
rational half of ``dsd2dxd_tpu/ops/phase.py`` (``init_phase_hists`` for the
one rational plan, ``stage_apply_rational_natural``). Every 48k-family
chain is a pure ÷2^m head down to base = out * 147 / 160 (the 44.1k chain
at that rate) and one ×160/147 stage (``filters/design._chain_48k``).
Per tile:

1. head: K1e (``fused.fused_head_cuda``), the fused decimation kernel in
   its planar f32 mode, at gain 1 with no dither -> (C, n_base) f32;
2. tail: the ×160/147 stage as one banded fp32 ``torch.matmul``
   (``rational_tail``), as the JAX package leaves it to XLA outside any
   kernel -> (C, n_out) f32, n_out = n_base * 160 / 147;
3. finish: K2 (``fused.finish_cuda``): level gain, the peak over the first
   n_valid final frames, dither, quantization and the wire bytes.

The level gain, the peak and the dither act on the final samples; the head
draws no noise, so its Philox stream and K2's cannot collide (the JAX
argument of ``make_finish_planes``). The streaming state is (the head's
halo bytes, primed with the DSD idle byte as ``fused.init_fused_halo``;
the tail's history, the last p_in = 147 head samples, primed with zeros
as the JAX ``init_phase_hists``). A CUDA tensor launches K1e and K2 or
raises; a CPU tensor runs their plain versions (``fused_decim_cascade``
and ``finish_reference``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from dsd2dxd_tpu_torch.filters.design import Stage
from dsd2dxd_tpu_torch.formats.dsd_types import DitherType
from dsd2dxd_tpu_torch.utils.errors import ConfigError
from dsd2dxd_tpu_torch.ops import fused
from dsd2dxd_tpu_torch.ops.plan import (
    build_plan,
    params_from_chain,
    plan_banded_natural,
)
from dsd2dxd_tpu_torch.ops.resample import StepConfig


def rational_head_len(chain: Sequence[Stage]) -> Optional[int]:
    """n_head when `chain` is a head the fused kernel runs (a pure ÷2^k
    chain) followed by ONE rational (L > 1) stage -- the shape of every
    48k-family chain -- else None (JAX ``fused_rational_plan``)."""
    if len(chain) < 2 or chain[-1].L == 1:
        return None
    head = tuple(chain[:-1])
    return len(head) if fused.decimation(head) is not None else None


@dataclass(frozen=True)
class RationalPlan:
    """The static shape of a 48k-family step: the head's length and
    decimation, and the tail's band (``plan.plan_banded_natural``)."""

    n_head: int
    r_head: int        # ÷R of the head
    p_in: int          # input samples per band block (147)
    band: np.ndarray   # (p_out, p_in + nhist) f32
    nhist: int

    @property
    def p_out(self) -> int:
        return self.band.shape[0]

    @property
    def unit_bits(self) -> int:
        """Input bits per band block: a tile is a whole number of them."""
        return self.p_in * self.r_head


def rational_plan(chain: Sequence[Stage]) -> RationalPlan:
    n_head = rational_head_len(chain)
    if n_head is None:
        raise ConfigError("not a 48k-family chain: want a pure ÷2^k head "
                          "the fused kernel runs and one rational stage")
    plan = build_plan(chain[-1], p_in=1)
    banded = plan_banded_natural(plan)
    if banded is None:
        raise ConfigError("the rational stage is not band-shaped")
    band, nhist = banded
    return RationalPlan(n_head=n_head,
                        r_head=fused.decimation(chain[:n_head]),
                        p_in=plan.p_in,
                        band=band, nhist=nhist)


def init_rational_state(chain: Sequence[Stage], channels: int, device=None):
    """Initial streaming state: (idle-byte head halo (C, halo_bytes)
    uint8, zero tail history (C, p_in) f32)."""
    rp = rational_plan(chain)
    return (fused.init_fused_halo(chain[:rp.n_head], channels, device),
            torch.zeros(channels, rp.p_in, dtype=torch.float32,
                        device=device))


def check_fp32_matmul() -> None:
    """Refuse to run the tail's matmul in TF32: it keeps ~10 mantissa
    bits, about 10^3 LSB of error at 24 bit (``phase.py`` measured the
    same for the TPU's bf16 passes). The port does not change the
    process-wide setting behind its caller's back."""
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise ConfigError(
            "the ×160/147 tail needs full fp32 matmuls: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')")


def rational_tail(y: torch.Tensor, hist: torch.Tensor, band_t: torch.Tensor,
                  nhist: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ×160/147 stage on (C, n) head samples in natural order, n a
    multiple of p_in, with the (C, p_in) history of the previous tile.

    Output block k is window k -- the last nhist samples before block k
    of the input, then its p_in samples -- times the band:
    z[c, k, :] = w[c, k, :] @ band_t, band_t the (p_in + nhist, p_out)
    transposed band. One fp32 ``torch.matmul`` (on a card: refused in
    TF32, ``check_fp32_matmul``). Returns ((C, n * p_out / p_in) f32,
    new history = the last p_in head samples)."""
    c, n = y.shape
    p = hist.shape[1]
    if n % p:
        raise ValueError(f"{n} head samples are not whole blocks of {p}")
    if y.is_cuda:
        check_fp32_matmul()
    k = n // p
    yr = y.reshape(c, k, p)
    prev = torch.cat([hist[:, None, p - nhist:], yr[:, :-1, p - nhist:]],
                     dim=1)
    w = torch.cat([prev, yr], dim=2)  # (C, K, nhist + p_in)
    z = torch.matmul(w, band_t)       # (C, K, p_out)
    return z.reshape(c, -1), yr[:, -1, :].clone()


def make_rational_step(chain: Sequence[Stage], cfg: StepConfig, device,
                       big_endian: bool = False):
    """The 48k-family step for `chain` and `cfg` (16/20/24-bit with
    TPDF/RECT/NONE, or 32-bit float with NONE/FPD).

    step(x_u8 (C, tile) uint8, (halo (C, halo_bytes) uint8, hist (C, p_in)
         f32), tile_key, n_valid=None) -> (wire bytes (n_out*C*bps,)
         uint8, peak f32 0-d, (new halo, new hist))

    ``n_valid`` bounds the final frames the peak covers (all for None). A
    CUDA tensor launches K1e and K2 (or raises); a CPU tensor runs their
    plain versions. Nothing falls back.
    """
    chain = tuple(chain)
    rp = rational_plan(chain)
    head = chain[:rp.n_head]
    fused.check_epilogue(cfg)
    fused.check_step_config(head, dataclasses.replace(
        cfg, bit_depth=32, dither=DitherType.NONE, level_db=0.0))
    if cfg.tile_bits % rp.unit_bits:
        raise ConfigError(f"tile of {cfg.tile_bytes} bytes is not whole "
                          f"blocks of {rp.unit_bits} input bits (the "
                          f"rational stage's {rp.p_in} base samples)")
    halo_bytes = fused.chain_halo_bytes(head)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    taps = [p.taps.to(device) for p in params_from_chain(head)]
    taps_flat = torch.cat(taps)
    band_t = torch.from_numpy(rp.band.T.copy()).to(device)
    gain = fused._gain32(cfg)
    hist_shape = (cfg.channels, rp.p_in)

    def step(x_u8: torch.Tensor, state, tile_key: int,
             n_valid: Optional[int] = None):
        halo, hist = state
        if (x_u8.dtype != torch.uint8 or halo.dtype != torch.uint8
                or hist.dtype != torch.float32
                or tuple(x_u8.shape) != (cfg.channels, cfg.tile_bytes)
                or tuple(halo.shape) != (cfg.channels, halo_bytes)
                or tuple(hist.shape) != hist_shape
                or not (x_u8.is_contiguous() and halo.is_contiguous())
                or not (x_u8.device == halo.device == hist.device)):
            raise ValueError(
                f"want contiguous uint8 x {(cfg.channels, cfg.tile_bytes)}, "
                f"halo {(cfg.channels, halo_bytes)} and f32 hist "
                f"{hist_shape} on one device, got "
                f"{x_u8.dtype}{tuple(x_u8.shape)}@{x_u8.device}, "
                f"{halo.dtype}{tuple(halo.shape)}@{halo.device} and "
                f"{hist.dtype}{tuple(hist.shape)}@{hist.device}")
        if x_u8.device != device:
            raise ValueError(f"step built for {device}, got {x_u8.device}")
        if x_u8.is_cuda:
            y = fused.fused_head_cuda(x_u8, halo, taps_flat, head)
            z, new_hist = rational_tail(y, hist, band_t, rp.nhist)
            wire, peak = fused.finish_cuda(z, gain, tile_key, cfg,
                                           big_endian, n_valid)
        elif x_u8.device.type == "cpu":
            y = fused.fused_decim_cascade(x_u8, halo, taps, head, 1.0)
            z, new_hist = rational_tail(y, hist, band_t, rp.nhist)
            wire, peak = fused.finish_reference(z, gain, tile_key, cfg,
                                                big_endian, n_valid)
        else:
            raise ConfigError(f"no 48k-family path on {x_u8.device}")
        new_halo = x_u8[:, cfg.tile_bytes - halo_bytes:].clone()
        return wire, peak, (new_halo, new_hist)

    return step
