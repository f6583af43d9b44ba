"""``stdin``: the CLI's ``convert_stdin``, one raw track after another,
with a FIFO that the I/O child feeds as its stdin and a FIFO that it
drains as its stdout (``cat track.dsd | dsd2dxd - | consumer``)."""

from __future__ import annotations

import io
import os
import sys
import time

CLI_ARGS = ["-"]
STREAMS_AT_ONCE = False


def make_inputs(run) -> None:
    run.write_raw_pool()


def units_per_lap(run) -> int:
    return len(run.cell.work["tracks_s"])


def unit(run, lap: int, i: int, keep: bool) -> list:
    from dsd2dxd_tpu_torch.cli.dsd2dxd import convert_stdin

    d = run.tmp / "out" / f"lap{lap:04d}"
    t = run.new_track(i, d / f"t{i + 1:02d}.out", keep)
    fin = d / f"t{i + 1:02d}.in"
    os.mkfifo(fin)
    c = run.cell.config["channels"]
    pieces = [[run.pool_offsets[s], n * c] for s, n in run.program.tracks[i]]
    run.pump.send(op="feed", path=str(fin), pieces=pieces)
    saved = sys.stdin, sys.stdout
    with open(fin, "rb") as f_in, open(t.out, "wb") as f_out:
        sys.stdin, sys.stdout = io.TextIOWrapper(f_in), io.TextIOWrapper(f_out)
        t0 = time.perf_counter()
        try:
            convert_stdin(run.args, run.enums, run.tmp, run.device)
            sys.stdout.flush()
            f_out.close()
        except Exception as err:  # noqa: BLE001 - a failed track counts
            t.error = f"{type(err).__name__}: {err}"
        finally:
            t.wall = time.perf_counter() - t0
            sys.stdin, sys.stdout = saved
    return [t]


def warm(run) -> None:
    (t,) = unit(run, 0, run.warm_index, False)
    if t.error:
        raise RuntimeError(f"the warm conversion failed: {t.error}")
