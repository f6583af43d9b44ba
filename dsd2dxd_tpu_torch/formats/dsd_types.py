"""Core enums and value types for the conversion engine.

These mirror the public enum surface of the reference engine crate
``rdsd2pcm`` as reconstructed from its call sites
(reference: src/main.rs:27-31, 165-214; src/bin/dsd_levels/main.rs:19-22),
with one deliberate extension: ``DitherType.NJAD`` ("Not Just Another
Dither", Airwindows lineage — reference README.md:74 uses ``-d N`` even
though reference v2.7.0 only accepts T/R/F/X).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from pathlib import Path


class DitherType(enum.Enum):
    """Dither applied before requantization (reference: src/main.rs:171-181)."""

    TPDF = "T"          # triangular PDF, +/-1 LSB
    RECTANGULAR = "R"   # uniform, +/-0.5 LSB
    FPD = "F"           # "Dither Float" for 32-bit float output (README.md:236)
    NJAD = "N"          # Not Just Another Dither (noise-shaped; README.md:74)
    NONE = "X"

    @classmethod
    def from_char(cls, c: str) -> "DitherType":
        """Strict parse: unknown char is a hard error (reference src/main.rs:176-180)."""
        try:
            return _DITHER_BY_CHAR[c.upper()]
        except KeyError:
            raise ValueError(
                f"Invalid dither type: {c} (expected T, R, F, N, or X)"
            ) from None


_DITHER_BY_CHAR = {d.value: d for d in DitherType}


class FmtType(enum.Enum):
    """Raw DSD channel layout (reference: src/main.rs:183-191)."""

    INTERLEAVED = "I"   # channel bytes alternate (as in .dff)
    PLANAR = "P"        # per-channel blocks (as in .dsf)

    @classmethod
    def from_char(cls, c: str) -> "FmtType":
        """Strict parse: unknown char is a hard error (reference src/main.rs:187-190)."""
        try:
            return {"I": cls.INTERLEAVED, "P": cls.PLANAR}[c.upper()]
        except KeyError:
            raise ValueError(f"Invalid format type: {c} (expected I or P)") from None


class Endianness(enum.Enum):
    """Bit order within each DSD byte (reference: src/main.rs:193-197)."""

    LSB_FIRST = "L"     # .dsf with bits_per_sample == 1
    MSB_FIRST = "M"     # .dff; .dsf with bits_per_sample == 8

    @classmethod
    def from_char(cls, c: str) -> "Endianness":
        """Lenient parse: unknown char falls back to MSB-first
        (reference src/main.rs:196)."""
        return cls.LSB_FIRST if c.upper() == "L" else cls.MSB_FIRST


class FilterType(enum.Enum):
    """Decimation filter bank (reference: src/main.rs:199-205; README.md:128-134)."""

    EQUIRIPPLE = "E"    # default; all inputs/outputs
    XLD = "X"           # DSD64 only; 88.2k/176.4k/352.8k only
    DSD2PCM = "D"       # DSD64 only; 352.8k only (Gesemann lineage)
    CHEBYSHEV = "C"     # DSD128 only; 88.2k/176.4k/352.8k only

    @classmethod
    def from_char(cls, c: str) -> "FilterType":
        """Lenient parse: unknown char falls back to Equiripple
        (reference src/main.rs:204)."""
        return {
            "E": cls.EQUIRIPPLE,
            "X": cls.XLD,
            "D": cls.DSD2PCM,
            "C": cls.CHEBYSHEV,
        }.get(c.upper(), cls.EQUIRIPPLE)


class OutputType(enum.Enum):
    """Output container (reference: src/main.rs:207-214)."""

    STDOUT = "S"
    AIFF = "A"
    AIFC = "C"
    WAV = "W"
    FLAC = "F"

    @classmethod
    def from_char(cls, c: str) -> "OutputType":
        """Lenient parse: unknown char falls back to stdout
        (reference src/main.rs:213)."""
        return {
            "S": cls.STDOUT,
            "A": cls.AIFF,
            "C": cls.AIFC,
            "W": cls.WAV,
            "F": cls.FLAC,
        }.get(c.upper(), cls.STDOUT)

    @property
    def extension(self) -> str:
        return {
            OutputType.STDOUT: "pcm",
            OutputType.AIFF: "aif",
            OutputType.AIFC: "aifc",
            OutputType.WAV: "wav",
            OutputType.FLAC: "flac",
        }[self]


DSD64_RATE = 2_822_400  # Hz — 64x 44.1 kHz


class DsdRate(enum.IntEnum):
    """Input DSD rate multiplier (reference: src/main.rs:94-96 — 1/2/4/8)."""

    DSD64 = 1
    DSD128 = 2
    DSD256 = 4
    DSD512 = 8

    @property
    def hz(self) -> int:
        return DSD64_RATE * int(self)

    @classmethod
    def from_multiplier(cls, m: int) -> "DsdRate":
        try:
            return cls(m)
        except ValueError:
            raise ValueError(
                f"Invalid input DSD rate multiplier: {m} (expected 1, 2, 4, or 8)"
            ) from None

    @classmethod
    def from_hz(cls, hz: int) -> "DsdRate":
        if hz % DSD64_RATE != 0:
            raise ValueError(f"Not a DSD sample rate: {hz} Hz")
        return cls.from_multiplier(hz // DSD64_RATE)


class DsdFileFormat(enum.Enum):
    """Input file classification by extension (reference: src/main.rs:361,
    README.md:109-112: .dsf/.dff are containers, .dsd is a raw bitstream)."""

    DSF = "dsf"
    DFF = "dff"
    RAW = "dsd"

    @classmethod
    def from_path(cls, path: Path | str) -> "DsdFileFormat":
        ext = Path(path).suffix.lower().lstrip(".")
        return {"dsf": cls.DSF, "dff": cls.DFF}.get(ext, cls.RAW)

    def is_container(self) -> bool:
        return self in (DsdFileFormat.DSF, DsdFileFormat.DFF)


# Valid extensions recognised during directory expansion
# (reference README.md:109-112).
DSD_EXTENSIONS = (".dsf", ".dff", ".dsd")


ONE_HUNDRED_PERCENT: float = 100.0
"""Progress terminal value (reference: src/main.rs:418)."""


@dataclass(frozen=True)
class ProgressUpdate:
    """Progress tick sent from the engine to UI code
    (reference: src/main.rs:397-423)."""

    percent: float


# ---------------------------------------------------------------------------
# Output-rate validity (reference: src/main.rs:85-96; README.md:145-155;
# SURVEY.md §2.5 rate matrix).
# ---------------------------------------------------------------------------

_VALID_OUT_RATES = {
    DsdRate.DSD64: (88200, 96000, 176400, 192000, 352800, 384000),
    DsdRate.DSD128: (88200, 96000, 176400, 192000, 352800, 384000, 705600),
    DsdRate.DSD256: (88200, 96000, 176400, 192000, 352800, 384000, 705600, 1411200),
    DsdRate.DSD512: (352800,),
}


def valid_output_rates(in_rate: DsdRate) -> tuple[int, ...]:
    return _VALID_OUT_RATES[in_rate]


def check_rate_pair(in_rate: DsdRate, out_rate: int) -> None:
    if out_rate not in _VALID_OUT_RATES[in_rate]:
        raise ValueError(
            f"Output rate {out_rate} Hz is not supported for {in_rate.name} input "
            f"(valid: {', '.join(str(r) for r in _VALID_OUT_RATES[in_rate])})"
        )


# Filter-bank availability (reference: src/main.rs:62-68; README.md:128-134).
def check_filter_choice(filt: FilterType, in_rate: DsdRate, out_rate: int) -> None:
    if filt is FilterType.XLD:
        if in_rate is not DsdRate.DSD64 or out_rate not in (88200, 176400, 352800):
            raise ValueError(
                "XLD filters are only available with DSD64 input and "
                "88200/176400/352800 output rates"
            )
    elif filt is FilterType.DSD2PCM:
        if in_rate is not DsdRate.DSD64 or out_rate != 352800:
            raise ValueError(
                "The original dsd2pcm filter is only available with DSD64 input "
                "and 352800 output rate"
            )
    elif filt is FilterType.CHEBYSHEV:
        if in_rate is not DsdRate.DSD128 or out_rate not in (88200, 176400, 352800):
            raise ValueError(
                "Chebyshev filters are only available with DSD128 input and "
                "88200/176400/352800 output rates"
            )
    check_rate_pair(in_rate, out_rate)
