"""Input discovery and output-path layout.

Mirrors the reference's path handling: ``find_dsd_files`` expands
directories to ``.dsf/.dff/.dsd`` files (reference: src/main.rs:275,
README.md:109-112 — recursion only with -R), and ``build_output_path``
mirrors the input tree under ``-p`` relative to the common ancestor
(reference: src/main.rs:262-273; README.md:115-119).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Sequence

from dsd2dxd_tpu_torch.formats.dsd_types import DSD_EXTENSIONS, OutputType


def _is_dsd_file(p: Path) -> bool:
    return p.suffix.lower() in DSD_EXTENSIONS


def find_dsd_files(paths: Sequence[Path | str], recurse: bool) -> list[Path]:
    """Expand directories into DSD files; keep explicit files as-is.

    The reference only expands directories when -R is given
    (README.md:109-112: "Without -R, directories are not traversed;
    provide explicit file paths if you don't want recursion") — so
    without -R a directory argument is SKIPPED with a warning, not
    expanded one level.
    """
    out: list[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            if recurse:
                for root, dirs, files in os.walk(p):
                    dirs.sort()
                    for name in sorted(files):
                        q = Path(root) / name
                        if _is_dsd_file(q):
                            out.append(q)
            else:
                from dsd2dxd_tpu_torch.utils.logging import get_logger

                get_logger().warning(
                    f"Skipping directory \"{p}\" (directories are only "
                    "traversed with -R/--recurse)")
        else:
            out.append(p)
    return out


def common_ancestor(paths: Sequence[Path]) -> Optional[Path]:
    """Deepest common directory of all inputs (reference uses the
    ``common-path`` crate — src/main.rs:264-273)."""
    if not paths:
        return None
    parts = [p.parent.parts if p.is_file() or p.suffix else p.parts for p in paths]
    common: list[str] = []
    for segs in zip(*parts):
        if all(s == segs[0] for s in segs):
            common.append(segs[0])
        else:
            break
    if not common:
        return None
    return Path(*common)


def compute_base_dir(inputs: Sequence[Path]) -> Path:
    """base_dir = parent of a single input (file OR directory — the
    reference takes paths[0].parent() unconditionally), else the PARENT
    of the common path prefix of all inputs (src/main.rs:262-273:
    common_path_all(paths).parent()). Earlier versions returned a
    single directory itself / the common prefix without .parent(),
    shifting the -p mirrored tree up one level vs the reference."""
    if len(inputs) == 1:
        return inputs[0].parent
    anc = common_ancestor(list(inputs))
    return anc.parent if anc is not None else Path("/")


def rate_suffix(output_rate: int) -> str:
    """Abbreviated rate suffix for -a/--append: _96K, _88_2K, _1411_2K
    (reference: src/main.rs:120-124; README.md:171-173)."""
    khz = output_rate / 1000.0
    if khz == int(khz):
        return f"_{int(khz)}K"
    txt = f"{khz:.1f}".replace(".", "_")
    return f"_{txt}K"


def build_output_path(
    input_path: Optional[Path],
    base_dir: Path,
    out_dir: Optional[Path],
    output: OutputType,
    output_rate: int,
    append_rate: bool,
) -> Path:
    """Output file path for one conversion.

    - stdin (input_path None) -> ``output.<ext>`` in out_dir or cwd
      (reference: src/main.rs:101-103; run_all_tests.sh:11)
    - with -p: mirror the input tree relative to base_dir under out_dir,
      creating subdirectories as needed (reference README.md:115-119)
    - without -p: same directory as the input file.
    """
    ext = output.extension
    if input_path is None:
        stem = "output"
        parent = out_dir if out_dir is not None else Path.cwd()
    else:
        input_path = Path(input_path)
        stem = input_path.stem
        if out_dir is not None:
            try:
                rel = input_path.parent.resolve().relative_to(Path(base_dir).resolve())
            except ValueError:
                rel = Path(".")
            parent = Path(out_dir) / rel
        else:
            parent = input_path.parent
    if append_rate:
        stem += rate_suffix(output_rate)
    return parent / f"{stem}.{ext}"


_ARTWORK_EXTENSIONS = (".jpg", ".jpeg", ".png", ".gif", ".bmp", ".webp")


def copy_artwork(input_path: Path, dest_dir: Path) -> list[Path]:
    """Copy image files sitting beside the input into the output directory
    (reference: src/main.rs:43-46 — 'Artwork files will be copied to the
    output directories')."""
    import shutil

    copied = []
    src_dir = Path(input_path).parent
    if not src_dir.is_dir() or src_dir.resolve() == dest_dir.resolve():
        return copied
    for p in sorted(src_dir.iterdir()):
        if p.is_file() and p.suffix.lower() in _ARTWORK_EXTENSIONS:
            dest = dest_dir / p.name
            if not dest.exists():
                dest_dir.mkdir(parents=True, exist_ok=True)
                shutil.copy2(p, dest)
                copied.append(dest)
    return copied
