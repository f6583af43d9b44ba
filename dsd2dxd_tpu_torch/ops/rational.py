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
2. tail and finish: K2 "from the head's samples" (``finish_tail_cuda``,
   ``csrc/finish.cu``): the ×160/147 stage out of shared memory -- every
   final sample the sum of its phase's T band entries (``tail_table``) in
   ``plan.tree_sum`` order -- then level gain, the peak over the first
   n_valid final frames, dither, quantization and the wire bytes, n_out =
   n_base * 160 / 147 frames. The (C, n_out) f32 samples between the two
   are never written.

The plain version of 2 is ``rational_tail_reference`` (the same T-tap
tree sums as gathers) then ``fused.finish_reference``; the kernel is
bit-equal to it. ``rational_tail`` computes the same stage as one dense
banded fp32 ``torch.matmul``, as the JAX package leaves it to XLA: the
step does not call it; it stays as the tail's library call, which
``chip_smoke.py`` times beside the kernel and the tests hold the plain
version against (its sums run in another order: within 2e-6).

The level gain, the peak and the dither act on the final samples; the head
draws no noise, so its Philox stream and K2's cannot collide (the JAX
argument of ``make_finish_planes``). The streaming state is (the head's
halo bytes, primed with the DSD idle byte as ``fused.init_fused_halo``;
the tail's history, the last p_in = 147 head samples, primed with zeros
as the JAX ``init_phase_hists``). A CUDA tensor launches K1e and K2 or
raises; a CPU tensor runs their plain versions (``fused_decim_cascade``,
``rational_tail_reference`` and ``finish_reference``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass
from functools import cached_property
from typing import Optional, Sequence

import numpy as np
import torch

from dsd2dxd_tpu_torch.filters.design import Stage
from dsd2dxd_tpu_torch.formats.dsd_types import DitherType
from dsd2dxd_tpu_torch.containers.pack import bytes_per_sample
from dsd2dxd_tpu_torch.utils.errors import ConfigError
from dsd2dxd_tpu_torch import kernels
from dsd2dxd_tpu_torch.ops import fused
from dsd2dxd_tpu_torch.ops.plan import (
    build_plan,
    plan_banded_natural,
    tree_sum,
)
from dsd2dxd_tpu_torch.ops.resample import StepConfig

TAIL_BLOCKS = 4     # band blocks per run of K2; TAIL_B in csrc/finish.cu
TAIL_TAPS = (16, 18, 19)  # entries per phase K2 has a case for, there too
_TAIL_MAX_SMEM = 227 * 1024 - 256  # a block's dynamic shared memory there


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

    @cached_property
    def table(self) -> tuple[np.ndarray, np.ndarray]:
        """``tail_table`` of the band."""
        return tail_table(self.band)


def tail_table(band: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The band by output phase: (offs (p_out,) int32, coefs (p_out, T)
    f32), coefs[rho] = band[rho, offs[rho]:offs[rho] + T] with T the
    largest span from a row's first nonzero to its last (16, 18 or 19
    for the cached chains). offs[rho] is the row's first nonzero, moved
    down where the T entries would pass the band's end; the other
    entries of a shorter row are the band's zeros, so every nonzero of
    the band is in the table exactly once."""
    nz = band != 0
    if not nz.any(axis=1).all():
        raise ConfigError("a phase of the band has no entry")
    width = band.shape[1]
    first = nz.argmax(axis=1)
    last = width - 1 - nz[:, ::-1].argmax(axis=1)
    n_taps = int((last - first + 1).max())
    offs = np.minimum(first, width - n_taps).astype(np.int32)
    coefs = np.stack([band[rho, o:o + n_taps] for rho, o in enumerate(offs)])
    return offs, np.ascontiguousarray(coefs, dtype=np.float32)


# rational_plan's plans by their chain's stages (L, M, taps): a stream asks
# for its plan three times (the tile, the step, the state)
_PLANS: dict = {}


def rational_plan(chain: Sequence[Stage]) -> RationalPlan:
    """The chain's plan, built once per process."""
    key = tuple((s.L, s.M, np.asarray(s.taps).tobytes()) for s in chain)
    rp = _PLANS.get(key)
    if rp is None:
        rp = _PLANS.setdefault(key, _build_rational_plan(chain))
    return rp


def _build_rational_plan(chain: Sequence[Stage]) -> RationalPlan:
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


def rational_tail_reference(y: torch.Tensor, hist: torch.Tensor,
                            rp: RationalPlan
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the tail inside K2 "from the head's samples":
    the ×160/147 stage on (C, n) head samples, as ``rational_tail``, but
    every output the sum of its phase's T table entries times the window
    from offs[rho] on, the products added in ``plan.tree_sum`` order --
    T gathers of (C, K, 160), the kernel's arithmetic exactly. Returns
    ((C, n * p_out / p_in) f32, new history)."""
    c, n = y.shape
    p = hist.shape[1]
    if n % p:
        raise ValueError(f"{n} head samples are not whole blocks of {p}")
    offs, coefs = rp.table
    idx = torch.from_numpy(offs.astype(np.int64)).to(y.device)
    h = torch.from_numpy(coefs).to(y.device)
    w = torch.cat([hist[:, p - rp.nhist:], y], dim=1).unfold(
        1, p + rp.nhist, p)  # (C, K, nhist + p_in), a view
    z = tree_sum(w.index_select(2, idx + t) * h[:, t]
                 for t in range(h.shape[1]))
    return z.reshape(c, -1), y[:, n - p:].clone()


@dataclass(frozen=True)
class TailTable:
    """``tail_table`` on the card as K2 reads it: rows of `stride` floats
    (odd, so that a warp's 32 phases fall in 32 banks of shared memory),
    zero-padded."""

    coefs: torch.Tensor  # (p_out * stride,) f32
    offs: torch.Tensor   # (p_out,) int32
    n_taps: int
    stride: int


def kernel_table(rp: RationalPlan, device=None) -> TailTable:
    offs, coefs = rp.table
    n_taps = coefs.shape[1]
    if n_taps not in TAIL_TAPS:
        raise ConfigError(f"the finish kernel takes {TAIL_TAPS} band entries "
                          f"per phase (the cached 48k chains'), not {n_taps}")
    stride = n_taps | 1
    padded = np.zeros((coefs.shape[0], stride), dtype=np.float32)
    padded[:, :n_taps] = coefs
    return TailTable(coefs=torch.from_numpy(padded.reshape(-1)).to(device),
                     offs=torch.from_numpy(offs).to(device),
                     n_taps=n_taps, stride=stride)


def tail_window_stride(nhist: int) -> int:
    """Floats per channel of K2's window of a run: nhist rounded up to 4,
    so that the run's own samples land 16-byte aligned, then the
    TAIL_BLOCKS band blocks."""
    return -(-nhist // 4) * 4 + 147 * TAIL_BLOCKS


def finish_tail_cuda(y: torch.Tensor, hist: torch.Tensor, table: TailTable,
                     rp: RationalPlan, gain: float, tile_key: int,
                     cfg: StepConfig, big_endian: bool = False,
                     n_valid: Optional[int] = None):
    """K2 "from the head's samples": launch the finish kernel's fused
    mode on the current stream, on the (C, n) f32 head samples, n whole
    band blocks, and the (C, p_in) history. Same result as
    ``rational_tail_reference`` then ``fused.finish_reference``: (wire
    bytes (n_out*C*bps,) uint8, peak f32 0-d over the first n_valid of
    the n_out = n * p_out / p_in final frames); raises if the launch
    fails."""
    lib = kernels.load()
    p_in, p_out = rp.p_in, rp.p_out
    if (p_in, p_out) != (147, 160):
        raise ConfigError(f"the finish kernel runs the ×160/147 stage, not "
                          f"×{p_out}/{p_in}")
    if (y.dtype != torch.float32 or y.dim() != 2 or not y.is_contiguous()
            or y.shape[1] % p_in or y.shape[1] == 0
            or hist.dtype != torch.float32 or not hist.is_contiguous()
            or tuple(hist.shape) != (y.shape[0], p_in)
            or not (y.device == hist.device == table.coefs.device
                    == table.offs.device)):
        raise ValueError(
            f"want contiguous f32 y (C, whole blocks of {p_in}) and hist "
            f"(C, {p_in}) on the table's device, got {y.dtype}"
            f"{tuple(y.shape)}@{y.device} and {hist.dtype}"
            f"{tuple(hist.shape)}@{hist.device}")
    c, n = y.shape
    bps = bytes_per_sample(cfg.bit_depth)
    n_blocks = n // p_in
    n_out = n_blocks * p_out
    p = fused.finish_params(n_out, c, gain, tile_key, cfg, big_endian,
                            n_valid)
    p.n_blocks = n_blocks
    p.nhist = rp.nhist
    p.n_taps = table.n_taps
    p.coef_stride = table.stride
    p.win_stride = tail_window_stride(rp.nhist)
    p.smem_bytes = (4 * (-(-p_out * table.stride // 4) * 4 + p_out
                         + 2 * c * p.win_stride)
                    + p_out * TAIL_BLOCKS * c * bps)
    if p.smem_bytes > _TAIL_MAX_SMEM:
        raise ConfigError(f"{c} channels need {p.smem_bytes} bytes of shared "
                          f"memory per block of the finish kernel; it has "
                          f"{_TAIL_MAX_SMEM}")
    out = torch.empty(n_out * c * bps, dtype=torch.uint8, device=y.device)
    peak = torch.zeros(1, dtype=torch.float32, device=y.device)
    with kernels.launch_device(y.device) as (stream, dev):
        rc = lib.dsd2dxd_finish_tail(
            y.data_ptr(), hist.data_ptr(), table.coefs.data_ptr(),
            table.offs.data_ptr(), out.data_ptr(), peak.data_ptr(),
            ctypes.byref(p), stream, dev)
    if rc != 0:
        raise RuntimeError(f"finish (K2t) launch failed: CUDA error {rc}")
    fused.count_launch("K2t")
    return out, peak[0]


def make_rational_step(chain: Sequence[Stage], cfg: StepConfig, device,
                       big_endian: bool = False):
    """The 48k-family step for `chain` and `cfg` (16/20/24-bit with
    TPDF/RECT/NONE, or 32-bit float with NONE/FPD).

    step(x_u8 (C, tile) uint8, (halo (C, halo_bytes) uint8, hist (C, p_in)
         f32), tile_key, n_valid=None) -> (wire bytes (n_out*C*bps,)
         uint8, peak f32 0-d, (new halo, new hist))

    ``n_valid`` bounds the final frames the peak covers (all for None). A
    CUDA tensor launches K1e and K2 "from the head's samples" (or raises);
    a CPU tensor runs their plain versions. Nothing falls back.
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
    run_head = fused.make_head(head, device)
    table = kernel_table(rp, device) if device.type == "cuda" else None
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
        y = run_head(x_u8, halo)  # K1e on a card, plain on the CPU
        if x_u8.is_cuda:
            wire, peak = finish_tail_cuda(y, hist, table, rp, gain,
                                          tile_key, cfg, big_endian, n_valid)
            new_hist = y[:, y.shape[1] - rp.p_in:].clone()
        else:
            z, new_hist = rational_tail_reference(y, hist, rp)
            wire, peak = fused.finish_reference(z, gain, tile_key, cfg,
                                                big_endian, n_valid)
        new_halo = x_u8[:, cfg.tile_bytes - halo_bytes:].clone()
        return wire, peak, (new_halo, new_hist)

    return step
