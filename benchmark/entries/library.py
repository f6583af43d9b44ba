"""``library``: the CLI's ``run(["-R", "-q", "-p", OUT, folder])`` on a
folder of .dsf tracks (those from ``subfolder_from`` on in a subfolder),
batch after batch, on the CLI's own worker pool. Every file of a batch
gets the batch's wall: ``run`` gives no per-file wall."""

from __future__ import annotations

import os
import time

CLI_ARGS: list = []
STREAMS_AT_ONCE = True


def make_inputs(run) -> None:
    run.write_dsf()


def units_per_lap(run) -> int:
    return 1


def batch(run, folder, indices, keep: bool) -> list:
    from dsd2dxd_tpu_torch.cli.dsd2dxd import run as cli_run

    tracks = []
    for i in indices:
        src = folder / run.in_name(i)
        src.parent.mkdir(parents=True, exist_ok=True)
        os.link(run.tmp / "in" / run.in_name(i), src)
        rel = src.relative_to(run.tmp).with_suffix(f".{run.ext}")
        tracks.append(run.new_track(i, run.tmp / "out" / rel,
                                    keep and i in run.keep))
    argv = [*run.cli_argv(), "-R", "-q", "-p", str(run.tmp / "out"),
            str(folder)]
    t0 = time.perf_counter()
    try:
        rc = cli_run(argv, device=run.device)
        err = "" if rc == 0 else f"the CLI's run exited {rc}"
    except Exception as e:  # noqa: BLE001 - a failed batch counts
        err = f"{type(e).__name__}: {e}"
    wall = time.perf_counter() - t0
    for t in tracks:
        t.wall, t.error = wall, err
        run.release(t.out)
    return tracks


def unit(run, lap: int, i: int, keep: bool) -> list:
    return batch(run, run.tmp / f"lib{lap:04d}",
                 range(len(run.cell.work["tracks_s"])), keep)


def warm(run) -> None:
    (t,) = batch(run, run.tmp / "warmlib", [run.warm_index], False)
    if t.error:
        raise RuntimeError(f"the warm batch failed: {t.error}")
