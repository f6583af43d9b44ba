"""``dsd_levels`` — peak-level analyzer for DSD streams.

Mirrors the reference's second binary (reference
src/bin/dsd_levels/main.rs): the dsd2dxd input surface minus
output/dither/filter/bitdepth/level flags, reporting per-file
"<name>: peak level = X.X dBFS" and a global "Highest peak level"
(dsd_levels/main.rs:198-202, 259-264). The reported peak runs the real
conversion chain at the chosen output rate (README.md:185-187), NaN
peaks are excluded from the maximum (dsd_levels/main.rs:186-196).

A copy of ``dsd2dxd_tpu/cli/dsd_levels.py`` on the port's ``Converter``
(one CUDA device; ``run(argv, device)`` as in the port's dsd2dxd CLI):

    python -m dsd2dxd_tpu_torch.cli.dsd_levels -r 96000 track.dsf
"""

from __future__ import annotations

import argparse
import math
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from dsd2dxd_tpu_torch.cli.dsd2dxd import expand_inputs, worker_count
from dsd2dxd_tpu_torch.cli.progress import MultiProgress, ProgressAwareHandler
from dsd2dxd_tpu_torch.formats.dsd_types import DsdRate, Endianness, FmtType
from dsd2dxd_tpu_torch.pipeline.engine import Converter
from dsd2dxd_tpu_torch.utils.errors import Dsd2DxdError
from dsd2dxd_tpu_torch.utils.logging import init_logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dsd_levels",
        description="Report peak levels of DSD files (at the output rate "
                    "a conversion would use).")
    # unlike dsd2dxd (stdin assumed when no inputs), the reference's
    # dsd_levels REQUIRES at least one input (dsd_levels/main.rs:34
    # #[arg(required = true)]; clap usage error, exit 2 — argparse
    # matches); explicit "-" still reads stdin
    p.add_argument("inputs", nargs="+", metavar="infile/folder(s)|-")
    # reference dsd_levels derives --version too (dsd_levels/main.rs:27-31
    # #[command(version)])
    from dsd2dxd_tpu_torch import __version__

    p.add_argument("-V", "--version", action="version",
                   version=f"%(prog)s {__version__}")
    p.add_argument("-c", "--channels", type=int, default=2)
    p.add_argument("-f", "--fmt", default="I", metavar="I|P")
    p.add_argument("-e", "--endianness", default="M", metavar="M|L")
    p.add_argument("-s", "--bs", type=int, default=4096)
    p.add_argument("-i", "--inrate", type=int, default=1, choices=(1, 2, 4, 8))
    p.add_argument("-r", "--rate", type=int, default=352800,
                   help="output rate the peak is measured at (default 352800)")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("-R", "--recurse", action="store_true")
    return p


def run(argv=None, device=None) -> int:
    """CLI body; returns the exit code. `device` defaults to cuda:0."""
    args = build_parser().parse_args(argv)
    log = init_logging(verbose=args.verbose, quiet=args.quiet)
    fmt = FmtType.from_char(args.fmt)
    endian = Endianness.from_char(args.endianness)
    input_rate = DsdRate.from_multiplier(args.inrate)

    try:
        use_stdin, files, _base = expand_inputs(args.inputs, args.recurse,
                                                log)
    except Dsd2DxdError as e:
        log.error(str(e))
        return 1
    bars = MultiProgress(enabled=sys.stderr.isatty() and not use_stdin)
    for h in log.handlers:
        ProgressAwareHandler(bars).wrap(h)

    levels: dict[str, float] = {}
    lock = threading.Lock()
    t_start = time.monotonic()

    def check(path, name: str) -> None:
        conv = Converter.new_level_check(
            output_rate=args.rate, input_path=path, fmt=fmt, endian=endian,
            channels=args.channels, block_size=args.bs, input_rate=input_rate,
            device=device)
        bar = bars.add(name, prefix="[Analyzing]") if path is not None else None
        try:
            db = conv.check_level(
                progress=(lambda u: bar.update(u.percent)) if bar else None)
        finally:
            if bar is not None:
                bar.finish()
        with lock:
            # key by full path: identical basenames in different dirs
            # (disc1/track01.dsf, disc2/track01.dsf) must not overwrite
            # each other's peak in the global max / processed count
            levels[str(path) if path is not None else name] = db
        with bars.log_guard():
            print(f"{name}: peak level = {db:.1f} dBFS", file=sys.stderr)

    try:
        if use_stdin:
            check(None, "stdin")
        if files:
            cancel = threading.Event()
            errors: list[BaseException] = []

            def job(path: Path) -> None:
                if cancel.is_set():
                    return
                try:
                    check(path, path.name)
                except BaseException as e:  # noqa: BLE001
                    errors.append(e)
                    cancel.set()

            with ThreadPoolExecutor(max_workers=min(worker_count(),
                                                    len(files))) as pool:
                list(pool.map(job, files))
            if errors:
                raise errors[0]
    except Exception as e:  # noqa: BLE001 - the CLI contract maps EVERY
        # conversion failure to a red [ERROR] + exit 1 (utils/errors.py);
        # parser/writer edge cases can surface struct.error,
        # ZeroDivisionError, etc., and a raw traceback breaks that and
        # leaves progress bars unclosed
        bars.close()
        log.error(str(e) if isinstance(e, (Dsd2DxdError, ValueError,
                                           OSError))
                  else f"{type(e).__name__}: {e}")
        return 1
    finally:
        bars.close()

    finite = {k: v for k, v in levels.items() if not math.isnan(v)}
    if finite:
        highest = max(finite.values())
        print(f"Highest peak level: {highest:.1f} dBFS", file=sys.stderr)
    elapsed = int(time.monotonic() - t_start)
    hh, rem = divmod(elapsed, 3600)
    mm, ss = divmod(rem, 60)
    log.info(f"Processed {len(levels)} inputs in {hh:02d}:{mm:02d}:{ss:02d}")
    return 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()
