"""The plain reference of a conversion: DSD bits in, PCM samples out, in
float64, written from the chain's published structure alone.

A chain is a list of stages ``(taps, L, M)`` read from a frozen table
under ``tables/`` (byte copies of the designed filter tables). Every
stage is the upfirdn of its taps: stage output j is

    y[j] = sum_k taps[k] * v[M j - k],   v the stage input upsampled by L,

so the newest input a ÷2^k head's output frame m reads is DSD bit m R
(R the head's decimation), and the ×160/147 stage's output j reads head
sample floor(147 j / 160) and the ones before it. Before the stream the
DSD input is the idle pattern (bytes 0x69), and the ×160/147 stage's
history is zero. A stream of N bits per channel gives
floor(N * prod(L) / prod(M)) frames.

Everything here is plain ``torch`` on any device, computed in blocks of
output frames so that a long track fits; the precision is the caller's
(float64 for the reference, ``tf32`` for the control: the operands of
every product rounded to TF32's 10-bit mantissa, sums in float32).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from fractions import Fraction
from pathlib import Path

import numpy as np
import torch

IDLE_BYTE = 0x69
TABLES = Path(__file__).resolve().parent / "tables"


@dataclass(frozen=True)
class Chain:
    """A chain's stages: taps (float64), L and M of each."""

    taps: tuple[np.ndarray, ...]
    L: tuple[int, ...]
    M: tuple[int, ...]

    @property
    def n_head(self) -> int:
        """Stages of the ÷2^k head (those with L == 1 before a rational
        stage, or all of them)."""
        return len(self.L) - 1 if self.L[-1] > 1 else len(self.L)

    @property
    def head_decimation(self) -> int:
        return math.prod(self.M[:self.n_head])

    @property
    def ratio(self) -> Fraction:
        r = Fraction(1)
        for lv, mv in zip(self.L, self.M):
            r *= Fraction(lv, mv)
        return r

    def frames(self, n_bits: int) -> int:
        """Output frames of a stream of n_bits bits per channel."""
        return int(n_bits * self.ratio)


def load_chain(table: str) -> Chain:
    """The chain of a frozen table file (``tables/<name>.npz``)."""
    with np.load(TABLES / table) as z:
        n = int(z["n_stages"])
        return Chain(taps=tuple(np.asarray(z[f"taps{i}"], np.float64)
                                for i in range(n)),
                     L=tuple(int(z[f"L{i}"]) for i in range(n)),
                     M=tuple(int(z[f"M{i}"]) for i in range(n)))


def head_context(chain: Chain) -> int:
    """Bits before an output frame's newest bit that the head reads."""
    ctx = 0
    for taps, m in zip(reversed(chain.taps[:chain.n_head]),
                       reversed(chain.M[:chain.n_head])):
        ctx = m * ctx + len(taps) - 1
    return ctx


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to TF32: 10 mantissa bits, to nearest even."""
    b = x.contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    b = (b + 0xFFF + lsb) & ~0x1FFF
    return b.view(torch.float32)


def _bits(planes: torch.Tensor, first: int, n: int, dtype) -> torch.Tensor:
    """(C, n) ±1 samples of bits first .. first + n - 1 of the MSB-first
    (C, bytes) planes; bits outside the planes are the idle pattern."""
    b0 = first // 8  # floor: negative before the stream
    b1 = -(-(first + n) // 8)
    c, size = planes.shape
    lead, trail = max(0, -b0), max(0, b1 - max(b0, size))
    body = planes[:, max(b0, 0):b1]
    if lead or trail:
        # the idle pattern before the stream, as after its end (where the
        # program pads its last tile)
        pad = [torch.full((c, k), IDLE_BYTE, dtype=torch.uint8,
                          device=planes.device) for k in (lead, trail)]
        body = torch.cat([pad[0], body, pad[1]], dim=1)
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=planes.device)
    v = ((body.unsqueeze(-1) >> shifts) & 1).reshape(c, -1)
    off = first - 8 * b0
    return v[:, off:off + n].to(dtype) * 2 - 1


def _fir(v: torch.Tensor, taps: torch.Tensor, m: int, precision: str):
    """Valid polyphase FIR: out[j] = sum_k taps[k] v[m j + n - 1 - k]."""
    n = taps.shape[0]
    o = (v.shape[1] - n) // m + 1
    if precision == "tf32":
        v, taps = tf32(v), tf32(taps)
    acc = torch.zeros(v.shape[0], o, dtype=v.dtype, device=v.device)
    for k in range(n):
        s = n - 1 - k
        acc += v[:, s:s + (o - 1) * m + 1:m] * taps[k]
    return acc


def head_block(chain: Chain, planes: torch.Tensor, a: int, b: int,
               precision: str = "float64") -> torch.Tensor:
    """(C, b - a) head samples a .. b - 1; frames before 0 are zero."""
    dtype = torch.float64 if precision == "float64" else torch.float32
    c = planes.shape[0]
    out = torch.zeros(c, b - a, dtype=dtype, device=planes.device)
    a0 = max(a, 0)
    if b <= a0:
        return out
    r = chain.head_decimation
    ctx = head_context(chain)
    v = _bits(planes, a0 * r - ctx, (b - 1 - a0) * r + ctx + 1, dtype)
    for taps, m in zip(chain.taps[:chain.n_head], chain.M[:chain.n_head]):
        v = _fir(v, torch.as_tensor(taps, dtype=dtype, device=v.device), m,
                 precision)
    out[:, a0 - a:] = v
    return out


def tail_block(chain: Chain, planes: torch.Tensor, a: int, b: int,
               precision: str = "float64") -> torch.Tensor:
    """(C, b - a) outputs a .. b - 1 of the rational stage over the head:
    z[j] = sum_t h[rho_j + L t] head[floor(M j / L) - t], rho_j = M j
    mod L, h zero past its end."""
    taps, lv, mv = chain.taps[-1], chain.L[-1], chain.M[-1]
    dtype = torch.float64 if precision == "float64" else torch.float32
    dev = planes.device
    n_t = -(-len(taps) // lv)
    h = np.zeros(n_t * lv)
    h[:len(taps)] = taps
    h = torch.as_tensor(h.reshape(n_t, lv).T.copy(), dtype=dtype,
                        device=dev)  # (L, n_t): h[rho + L t]
    j = torch.arange(a, b, dtype=torch.int64, device=dev)
    base = (j * mv) // lv
    rho = (j * mv) % lv
    first = (a * mv) // lv - (n_t - 1)
    last = ((b - 1) * mv) // lv
    y = head_block(chain, planes, first, last + 1, precision)
    if precision == "tf32":
        y, h = tf32(y), tf32(h)
    acc = torch.zeros(planes.shape[0], b - a, dtype=dtype, device=dev)
    for t in range(n_t):
        acc += y[:, base - t - first] * h[rho, t]
    return acc


def output_block(chain: Chain, planes: torch.Tensor, a: int, b: int,
                 gain: float = 1.0, precision: str = "float64"):
    """(C, b - a) output frames a .. b - 1 of the whole chain, times the
    level's gain."""
    if chain.n_head == len(chain.L):
        y = head_block(chain, planes, a, b, precision)
    else:
        y = tail_block(chain, planes, a, b, precision)
    return y * gain if gain != 1.0 else y
