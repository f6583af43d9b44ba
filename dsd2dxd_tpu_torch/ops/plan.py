"""Static planning for the decimation cascades, in numpy (no jax).

The counterpart of the planning half of ``dsd2dxd_tpu/ops/phase.py``
(``PhaseTerm``, ``PhasePlan``, ``build_plan``, ``build_chain_plans``,
``tree_sum``, ``chain_tile_unit_bits``, ``plan_banded_natural``). That
module imports jax at load, so the port carries its own copy;
``tests/test_torch_plan.py`` and ``tests/test_torch_rational.py`` hold the
two term by term.

``params_from_chain`` hands the filter taps to the port as f32 tensors
(the ``filters/design.get_chain`` tables, byte copies of the JAX
package's), and
``state_from_jax`` takes a JAX fused state (a halo, or a 48k chain's halo
and tail history) as the port's streaming state.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from fractions import Fraction
from typing import Iterable, Sequence

import numpy as np
import torch

# the chains are the port's copy of the JAX package's tables (the same
# cached .npz files); get_chain is re-exported for the port's callers
from dsd2dxd_tpu_torch.filters.design import Stage, get_chain  # noqa: F401


@dataclass(frozen=True)
class PhaseTerm:
    coef: float
    r_in: int    # input phase row
    base: int    # lane offset (relative to the tile start; negative = history)


@dataclass(frozen=True)
class PhasePlan:
    """Static slicing plan for one stage in phase-major layout (see
    ``dsd2dxd_tpu/ops/phase.py:PhasePlan``)."""

    L: int
    M: int
    p_in: int
    p_out: int
    lane_stride: int
    terms: tuple[tuple[PhaseTerm, ...], ...]  # per output phase
    hist_lanes: int
    rephase: int = 1

    @property
    def delta_i(self) -> int:
        return self.M * self.p_out // self.L


def build_plan(stage: Stage, p_in: int) -> PhasePlan:
    L, M = stage.L, stage.M
    h = np.asarray(stage.taps, dtype=np.float64)
    p_out = L * p_in // math.gcd(M, L * p_in)
    delta_i = M * p_out // L
    s = delta_i // p_in
    rephase_factor = 1
    if s > 1:
        # widen the input phase count so the stage is stride-1
        rephase_factor = s
        p_in = p_in * s
        p_out = L * p_in // math.gcd(M, L * p_in)
        s = 1
    terms: list[tuple[PhaseTerm, ...]] = []
    min_base = 0
    for rho in range(p_out):
        tl = []
        for k in range(len(h)):
            if (M * rho - k) % L != 0:
                continue
            i_off = (M * rho - k) // L
            r = i_off % p_in
            base = (i_off - r) // p_in
            tl.append(PhaseTerm(float(h[k]), r, base))
            min_base = min(min_base, base)
        terms.append(tuple(tl))
    return PhasePlan(L=L, M=M, p_in=p_in, p_out=p_out, lane_stride=s,
                     terms=tuple(terms), hist_lanes=-min_base,
                     rephase=rephase_factor)


def build_chain_plans(chain: Sequence[Stage], p0: int = 8) -> tuple[PhasePlan, ...]:
    plans = []
    p = p0
    for stage in chain:
        plan = build_plan(stage, p)
        plans.append(plan)
        p = plan.p_out
    return tuple(plans)


def tree_sum(contribs: Iterable):
    """Pairwise sum in the association of ``phase.tree_sum`` (adjacent
    pairs level by level, an odd last element carried up), computed as a
    binary counter: at most log2(N)+1 partial sums are alive at once, so
    the plain cascade never holds all N products of a stage. For N items
    the result is S_a + (S_b + (... + S_z)) over the power-of-two blocks
    of N's binary digits, largest first -- the same expression the level
    loop builds (tests/test_torch_plan.py checks every N up to 256). The
    CUDA kernel sums its taps the same way."""
    acc: list = []  # acc[lv]: pending block of 2**lv items, or None
    n = 0
    for v in contribs:
        lv = 0
        while n >> lv & 1:
            v = acc[lv] + v
            acc[lv] = None
            lv += 1
        if lv == len(acc):
            acc.append(v)
        else:
            acc[lv] = v
        n += 1
    if n == 0:
        raise ValueError("tree_sum of nothing")
    out = None
    for lv in range(len(acc)):
        if n >> lv & 1:
            out = acc[lv] if out is None else acc[lv] + out
    return out


def chain_tile_unit_bits(plans: Sequence[PhasePlan]) -> int:
    """Smallest tile length (input bits) that keeps every stage's lane
    counts integral."""
    unit = 8
    to_input = Fraction(1)
    for p in plans:
        f = math.lcm(p.p_in, p.delta_i) * to_input
        unit = math.lcm(unit, f.numerator)
        to_input *= Fraction(p.M, p.L)
    return unit


def plan_banded_natural(plan: PhasePlan):
    """Natural-layout band of an upsampling rational stage (the ×160/147
    tail of every 48k-family chain), as ``phase.plan_banded_natural``.

    Output block k (p_out samples) reads exactly the p_in + nhist
    consecutive input samples p_in k - nhist ... p_in k + p_in - 1, so the
    stage is one (C, K, U) @ (U, p_out) product with U = p_in + nhist.
    Returns (band (p_out, U) f32 ndarray, nhist), or None when the plan
    is not band-shaped (a decimating stage, a band wider than one block,
    or a phase with gaps)."""
    p = plan.p_in
    offs_all = []
    for terms in plan.terms:
        offs = sorted(t.base * p + t.r_in for t in terms)
        if any(b - a != 1 for a, b in zip(offs, offs[1:])):
            return None
        offs_all.append(offs)
    omin = min(o[0] for o in offs_all)
    omax = max(o[-1] for o in offs_all)
    nhist = -omin
    if nhist <= 0 or nhist > p or omax >= p or plan.hist_lanes != 1:
        return None
    band = np.zeros((plan.p_out, p + nhist), dtype=np.float32)
    for rho, terms in enumerate(plan.terms):
        for t in terms:
            band[rho, t.base * p + t.r_in + nhist] += t.coef
    return band, nhist


@dataclass(frozen=True)
class StageParams:
    """One stage as the port runs it: f32 taps (upfirdn convention) and
    its phase plan (the term table the JAX kernel unrolls)."""

    taps: torch.Tensor
    L: int
    M: int
    plan: PhasePlan


def params_from_chain(chain: Sequence[Stage], p0: int = 8) -> tuple[StageParams, ...]:
    plans = build_chain_plans(chain, p0)
    return tuple(
        StageParams(taps=torch.tensor(np.asarray(s.taps, dtype=np.float32)),
                    L=s.L, M=s.M, plan=p)
        for s, p in zip(chain, plans))


def state_from_jax(state):
    """A JAX fused state as the port's streaming state.

    A pure ÷2^k chain's JAX step keeps (C, halo_lanes) words of G stream
    bytes -- uint8, uint16 or uint32 for G = 1, 2, 4, as
    ``init_fused_halo`` makes them -- which are the little-endian view of
    the last halo_lanes * G input bytes; the port keeps those bytes,
    (C, halo_lanes * G) uint8. A 48k-family chain's JAX step keeps
    (halo words, tail history (C, p_in, 1) f32); the port keeps (halo
    bytes, history (C, p_in) f32), the last p_in head samples."""
    if isinstance(state, tuple):
        halo, hist = state
        h = np.asarray(hist, dtype=np.float32)
        if h.ndim != 3 or h.shape[2] != 1:
            raise ValueError(f"want a (C, p_in, 1) tail history, got "
                             f"{h.shape}")
        return state_from_jax(halo), torch.from_numpy(h[:, :, 0].copy())
    a = np.asarray(state)
    if a.ndim != 2 or a.dtype.kind != "u" or a.dtype.itemsize not in (1, 2, 4):
        raise ValueError(f"want a (C, halo_lanes) uint8/16/32 halo, got "
                         f"{a.shape} {a.dtype}")
    le = np.ascontiguousarray(a, dtype=a.dtype.newbyteorder("<"))
    return torch.from_numpy(le.view(np.uint8).copy())
