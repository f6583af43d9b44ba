"""``album``: ``Converter.from_container(...).do_conversion()`` on each
.dsf track of an album, one after another, lap after lap. Each lap links
the tracks under new paths, so no two conversions share a path, nor the
dither key the port derives from it."""

from __future__ import annotations

import os
import time
from pathlib import Path

CLI_ARGS: list = []
STREAMS_AT_ONCE = False


def make_inputs(run) -> None:
    run.write_dsf()


def units_per_lap(run) -> int:
    return len(run.cell.work["tracks_s"])


def unit(run, lap: int, i: int, keep: bool) -> list:
    from dsd2dxd_tpu_torch.pipeline.engine import Converter

    d = run.tmp / f"lap{lap:04d}"
    d.mkdir(exist_ok=True)
    src = d / Path(run.in_name(i)).name
    os.link(run.tmp / "in" / run.in_name(i), src)
    out_dir = run.tmp / "out" / d.name
    t = run.new_track(i, out_dir / f"{src.stem}.{run.ext}", keep)
    a, e = run.args, run.enums
    t0 = time.perf_counter()
    try:
        Converter.from_container(
            bit_depth=a.bitdepth, output=e["output"], level_db=a.level,
            output_rate=a.rate, out_dir=out_dir, dither=e["dither"],
            filt=e["filt"], append_rate=a.append, base_dir=d,
            input_path=src, device=run.device).do_conversion()
    except Exception as err:  # noqa: BLE001 - a failed track counts
        t.error = f"{type(err).__name__}: {err}"
    t.wall = time.perf_counter() - t0
    run.release(t.out)
    return [t]


def warm(run) -> None:
    (t,) = unit(run, 0, run.warm_index, False)
    if t.error:
        raise RuntimeError(f"the warm conversion failed: {t.error}")
