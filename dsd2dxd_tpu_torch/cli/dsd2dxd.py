"""``dsd2dxd-torch``: the transcoder CLI on the CUDA devices.

Same flags as ``dsd2dxd_tpu/cli/dsd2dxd.py``, whose ``build_parser``,
``expand_inputs``, ``parse_enums``, ``worker_count`` and round-robin of a
batch over the devices (``batch_devices``: file i on device i mod n, at
least one worker per device) are copied here (its platform switch,
``apply_platform_env``, is JAX's and is not), driving the port's
``Converter``:

    python -m dsd2dxd_tpu_torch.cli.dsd2dxd -o w -p OUT track.dsf
    python -m dsd2dxd_tpu_torch.cli.dsd2dxd -R -o F -p OUT album/

With DSD2DXD_SHARD_STREAM=1 and two or more cards, each file's stream is
instead cut into overlap-save tiles over every card
(``parallel/sharded.py``).

A refused configuration (FLAC or NJAD at 32 bit, a rate the filter bank
does not reach) exits 1 with a ConfigError, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from dsd2dxd_tpu_torch.cli.progress import MultiProgress, ProgressAwareHandler
from dsd2dxd_tpu_torch.formats.discover import (
    compute_base_dir,
    copy_artwork,
    find_dsd_files,
)
from dsd2dxd_tpu_torch.formats.dsd_types import (
    DitherType,
    DsdFileFormat,
    DsdRate,
    Endianness,
    FilterType,
    FmtType,
    OutputType,
)
from dsd2dxd_tpu_torch.pipeline.engine import Converter
from dsd2dxd_tpu_torch.utils.device import batch_devices
from dsd2dxd_tpu_torch.utils.errors import Dsd2DxdError
from dsd2dxd_tpu_torch.utils.logging import init_logging
from dsd2dxd_tpu_torch.utils.trace import stream_trace


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dsd2dxd",
        description="Convert DSD (.dsf/.dff/raw) to PCM/DXD "
                    "(WAV/AIFF/AIFC/FLAC/stdout), on an NVIDIA card.",
    )
    from dsd2dxd_tpu_torch import __version__

    p.add_argument("inputs", nargs="*", metavar="infile/folder(s)|-",
                   help="input files/folders; '-' or none reads stdin")
    # clap derives --version from the crate version (reference
    # src/main.rs:41 #[command(version)])
    p.add_argument("-V", "--version", action="version",
                   version=f"%(prog)s {__version__}")
    p.add_argument("-p", "--path", default=None, metavar="DIR",
                   help="output directory (must exist; subdirectories are "
                        "created; artwork is copied)")
    p.add_argument("-c", "--channels", type=int, default=2,
                   help="channel count for raw input (default 2)")
    p.add_argument("-f", "--fmt", default="I", metavar="I|P",
                   help="raw layout: interleaved or planar (default I)")
    p.add_argument("-b", "--bitdepth", type=int, default=24,
                   choices=(16, 20, 24, 32),
                   help="output bit depth; 32 is float (default 24)")
    p.add_argument("-t", "--filttype", default="E", metavar="E|X|D|C",
                   help="filter bank (default E; X/D: DSD64 only, "
                        "C: DSD128 only)")
    p.add_argument("-e", "--endianness", default="M", metavar="M|L",
                   help="DSD bit order for raw input (default M)")
    p.add_argument("-s", "--bs", type=int, default=4096,
                   help="DSD block size bytes/channel for raw input "
                        "(default 4096)")
    p.add_argument("-d", "--dither", default=None, metavar="T|R|F|N|X",
                   help="dither type (default F for 32-bit else T)")
    p.add_argument("-r", "--rate", type=int, default=352800,
                   help="output sample rate Hz (default 352800)")
    p.add_argument("-i", "--inrate", type=int, default=1, choices=(1, 2, 4, 8),
                   help="input DSD rate: 1=DSD64 2=DSD128 4=DSD256 8=DSD512")
    p.add_argument("-o", "--output", default="S", metavar="S|A|C|W|F",
                   help="output: Stdout/Aiff/aifC/Wav/Flac (default S)")
    p.add_argument("-l", "--level", type=float, default=0.0,
                   help="gain adjust in dB (use --level=-3 for negatives)")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="trace-level logging")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="silence all logging")
    p.add_argument("-a", "--append", action="store_true",
                   help="append _<RATE>K to filenames and ' [RATE]' to the "
                        "album tag")
    p.add_argument("-R", "--recurse", action="store_true",
                   help="recurse directories for .dsf/.dff/.dsd")
    return p


def _looks_like_glob(s: str) -> bool:
    return any(ch in s for ch in "*?[")


def expand_inputs(raw_inputs: list[str], recurse: bool, log):
    """Reference input pipeline (src/main.rs:216-277): sort+dedup, take
    stdin out, warn+skip unexpanded globs, canonicalize, compute base_dir,
    expand directories."""
    inputs = sorted(dict.fromkeys(raw_inputs))
    use_stdin = not inputs or "-" in inputs
    inputs = [s for s in inputs if s != "-"]
    paths = []
    for s in inputs:
        pth = Path(s)
        if not pth.exists():
            if _looks_like_glob(s):
                log.warning(f"Skipping unexpanded glob pattern: {s}")
                continue
            # the reference's canonicalize()? aborts the whole run on a
            # nonexistent path (src/main.rs:256-260)
            raise Dsd2DxdError(f"Input does not exist: {s}")
        paths.append(pth.resolve())
    base_dir = compute_base_dir(paths) if paths else Path.cwd()
    files = find_dsd_files(paths, recurse) if paths else []
    return use_stdin, files, base_dir


def parse_enums(args) -> dict:
    dither_char = args.dither
    if dither_char is None:
        dither_char = "F" if args.bitdepth == 32 else "T"
    return dict(
        dither=DitherType.from_char(dither_char),      # strict
        fmt=FmtType.from_char(args.fmt),               # strict
        endian=Endianness.from_char(args.endianness),  # lenient
        filt=FilterType.from_char(args.filttype),      # lenient
        output=OutputType.from_char(args.output),      # lenient
        input_rate=DsdRate.from_multiplier(args.inrate),
    )


def worker_count() -> int:
    """Host-side worker threads feeding the device queue (the reference
    uses available_parallelism()/2 Rayon workers — src/main.rs:148-149)."""
    return max((os.cpu_count() or 2) // 2, 1)


def convert_stdin(args, enums, base_dir: Path, device=None) -> None:
    """Single-threaded stdin conversion, run before the batch."""
    conv = Converter.new(
        bit_depth=args.bitdepth, output=enums["output"], level_db=args.level,
        output_rate=args.rate,
        out_dir=Path(args.path) if args.path else None,
        dither=enums["dither"], fmt=enums["fmt"], endian=enums["endian"],
        input_rate=enums["input_rate"], block_size=args.bs,
        channels=args.channels, filt=enums["filt"],
        append_rate=args.append, base_dir=base_dir, input_path=None,
        device=device)
    conv.do_conversion()


def convert_file(path: Path, args, enums, base_dir: Path,
                 bars: MultiProgress, cancel: threading.Event,
                 device=None) -> Converter:
    """One file on one worker thread."""
    out_dir = Path(args.path) if args.path else None
    common = dict(bit_depth=args.bitdepth, output=enums["output"],
                  level_db=args.level, output_rate=args.rate,
                  out_dir=out_dir, dither=enums["dither"],
                  filt=enums["filt"], append_rate=args.append,
                  base_dir=base_dir, device=device)
    if DsdFileFormat.from_path(path).is_container():
        conv = Converter.from_container(input_path=path, **common)
    else:
        conv = Converter.new(input_path=path, fmt=enums["fmt"],
                             endian=enums["endian"],
                             input_rate=enums["input_rate"],
                             block_size=args.bs, channels=args.channels,
                             **common)
    show_bar = enums["output"] is not OutputType.STDOUT
    bar = bars.add(conv.file_name()) if show_bar else None
    try:
        conv.do_conversion(
            cancel=cancel.is_set,
            progress=(lambda u: bar.update(u.percent)) if bar else None)
    finally:
        if bar is not None:
            bar.finish()
    out_path = conv.output_path()
    if out_path is not None:
        copy_artwork(path, out_path.parent)
    return conv


def convert_files(files: list, args, enums, base_dir: Path,
                  bars: MultiProgress, device=None) -> None:
    """The batch of files on the worker pool, fail-fast: the first error
    cancels the files not yet started and is raised."""
    writes_stdout = enums["output"] is OutputType.STDOUT
    cancel = threading.Event()
    errors: list[BaseException] = []
    # raw PCM to stdout must not interleave across files
    workers = 1 if writes_stdout else min(worker_count(), len(files))
    # file-level data parallelism: round-robin the batch over the
    # devices, one pipeline per device, with enough workers to
    # feed every device; with one device nothing changes
    devices = [device] if device is not None else batch_devices()
    if len(devices) > 1 and len(files) > 1 and not writes_stdout:
        workers = min(max(workers, len(devices)), len(files))
    else:
        devices = [device]

    def job(item) -> None:
        idx, path = item
        if cancel.is_set():
            return
        try:
            convert_file(path, args, enums, base_dir, bars, cancel,
                         device=devices[idx % len(devices)])
        except BaseException as e:  # noqa: BLE001 - fail-fast batch
            errors.append(e)
            cancel.set()

    with ThreadPoolExecutor(max_workers=workers) as pool:
        list(pool.map(job, enumerate(files)))
    if errors:
        raise errors[0]


def run(argv=None, device=None) -> int:
    """CLI body; returns the exit code. A named `device` runs every input
    there (the tests' "cpu"); None spreads a batch of files over
    ``batch_devices()`` and runs stdin on cuda:0."""
    args = build_parser().parse_args(argv)
    log = init_logging(verbose=args.verbose, quiet=args.quiet)
    t_start = time.monotonic()
    try:
        enums = parse_enums(args)
    except ValueError as e:
        log.error(str(e))
        return 1
    if args.path is not None and not Path(args.path).is_dir():
        log.error(f"Output directory does not exist: {args.path}")
        return 1
    try:
        use_stdin, files, base_dir = expand_inputs(args.inputs,
                                                   args.recurse, log)
    except Dsd2DxdError as e:
        log.error(str(e))
        return 1
    writes_stdout = enums["output"] is OutputType.STDOUT
    bars = MultiProgress(enabled=(sys.stderr.isatty() and not use_stdin
                                  and not writes_stdout))
    for h in log.handlers:
        ProgressAwareHandler(bars).wrap(h)

    n_inputs = 0
    try:
        # traced, the batch holds one profiler session from stdin to the
        # pool's last file: one trace with every worker's spans
        with stream_trace("batch"):
            if use_stdin:
                convert_stdin(args, enums, base_dir, device)
                n_inputs += 1
            if files:
                convert_files(files, args, enums, base_dir, bars, device)
                n_inputs += len(files)
        if n_inputs == 0:
            log.warning("No DSD inputs found")
    except Exception as e:  # noqa: BLE001 - every failure is [ERROR] + exit 1
        bars.close()
        log.error(str(e) if isinstance(e, (Dsd2DxdError, ValueError,
                                           OSError))
                  else f"{type(e).__name__}: {e}")
        return 1
    finally:
        bars.close()
    elapsed = int(time.monotonic() - t_start)
    hh, rem = divmod(elapsed, 3600)
    mm, ss = divmod(rem, 60)
    log.info(f"Processed {n_inputs} inputs in {hh:02d}:{mm:02d}:{ss:02d}")
    return 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()
