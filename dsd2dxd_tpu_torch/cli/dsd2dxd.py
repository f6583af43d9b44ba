"""``dsd2dxd-torch``: the transcoder CLI on one CUDA device.

Same flags as ``dsd2dxd_tpu/cli/dsd2dxd.py`` (whose ``build_parser``,
``expand_inputs``, ``parse_enums`` and ``copy_artwork`` it reuses; none
of them loads jax), driving the port's ``Converter``:

    python -m dsd2dxd_tpu_torch.cli.dsd2dxd -o w -p OUT track.dsf

Configurations the port does not cover yet exit 1 with a ConfigError
that names the ROADMAP item bringing them.
"""

from __future__ import annotations

import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from dsd2dxd_tpu.cli.dsd2dxd import (
    build_parser,
    expand_inputs,
    parse_enums,
    worker_count,
)
from dsd2dxd_tpu.cli.progress import MultiProgress, ProgressAwareHandler
from dsd2dxd_tpu.formats.discover import copy_artwork
from dsd2dxd_tpu.formats.dsd_types import DsdFileFormat, OutputType
from dsd2dxd_tpu.utils.errors import Dsd2DxdError
from dsd2dxd_tpu.utils.logging import init_logging
from dsd2dxd_tpu_torch.pipeline.engine import Converter


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


def run(argv=None, device=None) -> int:
    """CLI body; returns the exit code. `device` defaults to cuda:0."""
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
        if use_stdin:
            convert_stdin(args, enums, base_dir, device)
            n_inputs += 1
        if files:
            cancel = threading.Event()
            errors: list[BaseException] = []
            # raw PCM to stdout must not interleave across files
            workers = 1 if writes_stdout else min(worker_count(), len(files))

            def job(path) -> None:
                if cancel.is_set():
                    return
                try:
                    convert_file(path, args, enums, base_dir, bars, cancel,
                                 device=device)
                except BaseException as e:  # noqa: BLE001 - fail-fast batch
                    errors.append(e)
                    cancel.set()

            with ThreadPoolExecutor(max_workers=workers) as pool:
                list(pool.map(job, files))
            if errors:
                raise errors[0]
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
