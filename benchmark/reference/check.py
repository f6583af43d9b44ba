"""The comparison that decides ``correct``: a conversion's output samples
against the plain reference's, in blocks of frames.

Each output sample's error is taken in LSB of 24-bit full scale (2^-23),
for integer and float output alike: e = out - 2^23 * ref, ref the float64
reference sample. The numbers are the largest |e| and the root mean
square of e over every compared sample. The program's dither is its own
(its generator and keys are not the reference's business): TPDF adds at
most 1 LSB before rounding, so a sound 24-bit output stays within 1.5 LSB
plus its float32 arithmetic, with an RMS near 0.5; float output's FPD adds
at most an ulp of the sample.

The control puts the reference itself in the program's place, computed in
TF32 (``decimate.tf32``: the precision below the float32 the
configurations state), with its own TPDF or FPD dither.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable

import torch

from benchmark.reference import containers, decimate

LSB24 = float(1 << 23)


@dataclass
class Errors:
    """Running error statistics over compared samples."""

    max_abs: float = 0.0
    sum_sq: float = 0.0
    n: int = 0
    worst: list = field(default_factory=list)  # (|e|, frame, channel)

    def add(self, e: torch.Tensor, first_frame: int) -> None:
        if e.numel() == 0:
            return
        a = e.abs()
        m = float(a.max())
        if m > self.max_abs:
            self.max_abs = m
            flat = int(a.argmax())
            self.worst = [m, first_frame + flat % e.shape[1],
                          flat // e.shape[1]]
        self.sum_sq += float((e * e).sum())
        self.n += e.numel()

    def merge(self, other: "Errors") -> None:
        if other.max_abs > self.max_abs:
            self.max_abs, self.worst = other.max_abs, other.worst
        self.sum_sq += other.sum_sq
        self.n += other.n

    @property
    def rms(self) -> float:
        return math.sqrt(self.sum_sq / self.n) if self.n else float("nan")


def compare(chain: decimate.Chain, planes: torch.Tensor, frames: int,
            out_block: Callable[[int, int], torch.Tensor],
            gain: float = 1.0, block: int = 1 << 21) -> Errors:
    """Errors of out_block(a, b) -- the (C, b - a) samples under test, in
    units of full scale times 2^23 for integers (their raw value at 24
    bit) or full scale for floats -- against the reference's."""
    errs = Errors()
    for a in range(0, frames, block):
        b = min(frames, a + block)
        ref = decimate.output_block(chain, planes, a, b, gain) * LSB24
        errs.add(out_block(a, b).to(torch.float64) - ref, a)
    return errs


def program_block(payload: torch.Tensor, layout: containers.Layout,
                  bit_depth: int) -> Callable[[int, int], torch.Tensor]:
    """out_block over a conversion's output bytes: frames a .. b - 1 in
    the units ``compare`` takes."""
    fb = layout.frame_bytes
    scale = LSB24 if layout.sample == "f32" else float(
        1 << (24 - min(bit_depth, 24)))

    def block(a: int, b: int) -> torch.Tensor:
        raw = payload[layout.offset + a * fb:layout.offset + b * fb]
        s = containers.samples(raw, layout).to(torch.float64)
        return s * scale

    return block


def samples_block(samples: torch.Tensor,
                  bits: int) -> Callable[[int, int], torch.Tensor]:
    """out_block over decoded (C, frames) integer samples of `bits` bits
    (a FLAC stream's), scaled to ``compare``'s 2^-23 LSB."""
    scale = float(1 << (24 - min(bits, 24)))

    def block(a: int, b: int) -> torch.Tensor:
        return samples[:, a:b].to(torch.float64) * scale

    return block


def epilogue(y: torch.Tensor, bit_depth: int, dither: str,
             gen: torch.Generator) -> torch.Tensor:
    """What a program emits for the (C, n) float32 samples y: float32
    (with FPD's ulp noise) at 32 bit, else the rounded and clipped integer
    (with TPDF's ±1 LSB) as int32 -- the configuration's epilogue, with
    this module's own noise."""
    noise = None
    if dither in ("T", "F"):
        u = torch.rand((2, *y.shape), generator=gen, dtype=torch.float32,
                       device=y.device)
        noise = u[0] + u[1] - 1.0
    if bit_depth == 32:
        if noise is None:
            return y
        ulp = (y.view(torch.int32) & 0x7F800000).view(torch.float32)
        return y + noise * (ulp * 2.0 ** -23)
    scale = float(1 << (bit_depth - 1))
    v = y * scale + (noise if noise is not None else 0.0)
    return torch.clamp(torch.round(v), -scale, scale - 1.0).to(torch.int32)


def control_block(chain: decimate.Chain, planes: torch.Tensor,
                  bit_depth: int, dither: str, gain: float = 1.0,
                  seed: int = 0) -> Callable[[int, int], torch.Tensor]:
    """out_block of the control: the reference in TF32 with the
    configuration's epilogue, in ``compare``'s units."""
    gen = torch.Generator(device=planes.device)
    gen.manual_seed(seed)

    def block(a: int, b: int) -> torch.Tensor:
        y = decimate.output_block(chain, planes, a, b, gain, "tf32")
        q = epilogue(y.to(torch.float32), bit_depth, dither, gen)
        if bit_depth == 32:
            return q.to(torch.float64) * LSB24
        return q.to(torch.float64) * float(1 << (24 - bit_depth))

    return block
