"""One run of one cell: set up, warm, convert for ``--seconds``, check the
outputs against the plain reference, print one result line.

A cell is ``workloads/<cell>.json``: its configuration (``configs/``),
its traffic (the entry it drives, its track lengths and segment length,
the CLI flags it adds) and the limits of its check. The metrics a cell
reports are those of ``BENCHMARK.json`` that name it (or name no cells).
Each is found by its name: the entry, one of the port's own, in
``entries/<entry>.py``; a per-layer metric's reader in
``metrics/<name>.py``.

Each lap or batch links the album's files under new paths (so no two
conversions share a path, nor the dither key the port derives from it),
and every output is a FIFO that the I/O child (``pump.py``) drains: no
output reaches a regular file. What a run writes to disk is its inputs
(the cell's tracks as .dsf, or the raw segment pool) and, traced, the
port's traces, all in one directory under TMPDIR that the run removes.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
BANNED = ("jax", "jaxlib", "flax", "dsd2dxd_tpu")
PROFILE_ENV = "DSD2DXD_PROFILE_DIR"
WARM_S = 12.0  # the warm conversion's audio: about one engine tile
HEADER_ROOM = 4096  # a kept output's bytes before its frames, at most
KEEP = 2  # tracks of the first lap that the check compares


def process_age() -> float:
    """Seconds since this process started (Linux: its start time in
    clock ticks since boot against CLOCK_BOOTTIME)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    work: dict      # workloads/<name>.json
    config: dict    # configs/<work["config"]>.json
    e2e: list       # end-to-end metric names it reports
    per_layer: dict  # per-layer metric names it reports, and their units
    chips: int = 1


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` as its files and BENCHMARK.json state it."""
    work = load_json(root / "workloads" / f"{name}.json")
    config = load_json(root / "configs" / f"{work['config']}.json")
    bench = load_json(root.parent / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"{name} is not a cell of BENCHMARK.json")

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    return Cell(name, work, config,
                [m["name"] for m in bench["end_to_end"] if mine(m)],
                {m["name"]: m["unit"] for m in bench["per_layer"] if mine(m)},
                int(entry["chips"]))


def module(kind: str, name: str, root: Path = ROOT):
    """``<kind>/<name>.py`` of the benchmark at `root`, loaded."""
    path = root / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind}/{name}.py under {root}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, root: Path = ROOT):
    """``metrics/<name>.py``'s read function."""
    return module("metrics", name, root).read


def entry(name: str, root: Path = ROOT):
    """``entries/<name>.py``: the port's entry a cell drives."""
    return module("entries", name, root)


class Pump:
    """The I/O child (``python -m benchmark.pump``)."""

    def __init__(self):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "benchmark.pump"], cwd=CHECKOUT,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE)

    def send(self, **msg) -> None:
        self.proc.stdin.write(json.dumps(msg).encode() + b"\n")
        self.proc.stdin.flush()

    def reply(self) -> dict:
        return json.loads(self.proc.stdout.readline())

    def results(self) -> dict:
        self.send(op="results")
        return {int(k): v for k, v in self.reply().items()}

    def drain(self, k: int, path: Path, slot, flac: bool) -> None:
        """Have the child drain FIFO `path` (keeping it whole into `slot`,
        counting its FLAC frames with `flac`); returns once the child has
        the FIFO open, so a writer never waits on it."""
        self.send(op="drain", id=k, path=str(path), slot=slot, flac=flac)
        opened = self.reply()["open"]
        if opened < 0:
            raise OSError(-opened, f"the I/O child cannot open {path}")

    def fetch(self, k: int) -> bytes:
        self.send(op="send", id=k)
        n = self.reply()["bytes"]
        return self.proc.stdout.read(n)

    def close(self) -> None:
        if self.proc.poll() is None:
            try:
                self.send(op="quit")
                self.proc.wait(timeout=30)
            except (OSError, subprocess.TimeoutExpired):
                self.proc.kill()
                self.proc.wait()


def kept_tracks(work: dict, seed: int) -> list:
    """The album's tracks whose first conversion the check compares: the
    longest, and KEEP - 1 others drawn from the seed."""
    import numpy as np

    lengths = work["tracks_s"]
    longest = max(range(len(lengths)), key=lambda i: lengths[i])
    others = [i for i in range(len(lengths)) if i != longest]
    rng = np.random.default_rng([seed & (2**63 - 1), 2 << 20])
    return sorted({longest, *(int(i) for i in rng.choice(
        others, size=min(len(others), KEEP - 1),
        replace=False))})


@dataclass
class Track:
    """One conversion's output in the window."""

    index: int          # the album's track
    out: Path           # its FIFO
    audio_s: float
    frames: int
    keep: bool
    wall: float = 0.0
    error: str = ""
    id: int = 0


@dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    tmp: Path
    pump: Pump
    entry: object = None  # entries/<entry>.py
    program: object = None
    chain: object = None
    args: object = None
    enums: dict = field(default_factory=dict)
    tracks: list = field(default_factory=list)
    pool_offsets: list = field(default_factory=list)
    keep: list = field(default_factory=list)
    n_ids: int = 0

    # -- set-up --------------------------------------------------------------
    @property
    def ext(self) -> str:
        """The output file's extension, as the CLI names it."""
        return self.enums["output"].extension

    @property
    def warm_index(self) -> int:
        """The warm track's index, after the album's."""
        return len(self.cell.work["tracks_s"])

    def cli_argv(self) -> list:
        return [*self.cell.config["argv"], *self.cell.work.get("argv", [])]

    def make_inputs(self) -> None:
        """The program, the chain, the kept tracks' room in the I/O child,
        and the entry's input files."""
        from benchmark import inputs
        from benchmark.reference import decimate

        cfg, work = self.cell.config, self.cell.work
        self.program = inputs.make_program(
            self.seed, cfg["dsd_hz"], cfg["channels"],
            [*work["tracks_s"], WARM_S],
            work["segment_s"])
        self.chain = decimate.load_chain(cfg["chain"]["table"])
        self.keep = kept_tracks(work, self.seed)
        fb = cfg["channels"] * (4 if cfg["bit_depth"] == 32 else 3
                                if cfg["bit_depth"] > 16 else 2)
        for i in self.keep:
            n = self.chain.frames(self.program.track_bytes(i) * 8)
            self.pump.send(op="reserve", slot=i, bytes=n * fb + HEADER_ROOM)
        (self.tmp / "in").mkdir()
        self.entry.make_inputs(self)

    def write_dsf(self) -> None:
        """Every track, and the warm one, as a .dsf under in/."""
        for i in range(self.warm_index + 1):
            path = self.tmp / "in" / self.in_name(i)
            path.parent.mkdir(exist_ok=True)
            self.program.write_dsf(i, path)

    def write_raw_pool(self) -> None:
        """The segment pool, raw, for the I/O child to feed from."""
        self.pool_offsets = self.program.write_raw_pool(self.tmp / "pool")
        self.pump.send(op="pool", path=str(self.tmp / "pool"))

    def in_name(self, i: int) -> str:
        if i == self.warm_index:
            return "warm.dsf"
        sub = self.cell.work.get("subfolder_from")
        name = f"t{i + 1:02d}.dsf"
        return f"sub/{name}" if sub is not None and i >= sub else name

    def parse_cli(self):
        from benchmark.reference import containers
        from dsd2dxd_tpu_torch.cli.dsd2dxd import build_parser, parse_enums

        args = build_parser().parse_args([*self.cli_argv(),
                                          *self.entry.CLI_ARGS])
        enums = parse_enums(args)
        ext = enums["output"].extension
        if ext not in containers.EXTENSIONS:
            raise ValueError(f"the reference reads no .{ext} output "
                             f"(reference/containers.py reads "
                             f"{', '.join(containers.EXTENSIONS)})")
        self.args, self.enums = args, enums

    # -- one unit of work ------------------------------------------------------
    def new_track(self, i: int, out: Path, keep: bool) -> Track:
        """Track i's output FIFO at `out`, drained by the I/O child (kept
        whole where `keep`)."""
        self.n_ids += 1
        n_bits = self.program.track_bytes(i) * 8
        t = Track(i, out, n_bits / self.cell.config["dsd_hz"],
                  self.chain.frames(n_bits), keep, id=self.n_ids)
        out.parent.mkdir(parents=True, exist_ok=True)
        os.mkfifo(out)
        self.pump.drain(t.id, out, i if keep else None, self.ext == "flac")
        return t

    @staticmethod
    def release(path: Path) -> None:
        """End a drain whose FIFO the conversion never opened (or has
        closed): open its write end without blocking and close it."""
        try:
            os.close(os.open(path, os.O_WRONLY | os.O_NONBLOCK))
        except OSError:
            pass

    # -- the phases --------------------------------------------------------------
    def profiled_window(self, trace_dir: Path) -> float:
        """The window under one profiler session of the harness's own, on
        this thread, written to `trace_dir`: for an entry that runs streams
        at once, where the port's hook would start a session per stream on
        each worker thread (a run of that crashed the process; PERF.md)."""
        import torch

        from benchmark.tracing import WINDOW

        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device is None:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW):
                window_s = self.window()
        trace_dir.mkdir()
        prof.export_chrome_trace(str(trace_dir / "window.pt.trace.json"))
        return window_s

    def window(self) -> float:
        """Units back to back until `seconds` have passed; the one in
        flight then finishes and counts. Returns the window's wall."""
        per_lap = self.entry.units_per_lap(self)
        t_w0 = time.perf_counter()
        t_end = t_w0
        k = 0
        while True:
            lap, i = divmod(k, per_lap)
            lap += 1  # lap 0 is the warm-up's
            self.tracks += self.entry.unit(self, lap, i, lap == 1 and (
                per_lap == 1 or i in self.keep))
            k += 1
            t_end = time.perf_counter()
            if t_end - t_w0 >= self.seconds:
                return t_end - t_w0


def check_outputs(run: Run, results: dict) -> tuple[list, dict]:
    """Per track: a fault or "" (a raised call, a drain that timed out, a
    missing or extra byte -- for FLAC, a missing or extra sample or a
    frame that fails its CRC -- or a header that is not the
    configuration's); and the check's numbers over the kept tracks
    against the reference."""
    import torch

    from benchmark.reference import check, containers

    cfg = run.cell.config
    faults = []
    layouts = {}
    for t in run.tracks:
        res = results.get(t.id, {"bytes": -1, "head": "", "status": 0,
                                 "flac": None})
        got = res["bytes"]
        fault = t.error
        if not fault and res["status"]:
            fault = f"drain: {os.strerror(-res['status'])}"
        if not fault:
            try:
                lay = containers.parse(run.ext, bytes.fromhex(res["head"]),
                                       cfg["channels"], cfg["output_rate"],
                                       cfg["bit_depth"])
                if (lay.channels, lay.rate) != (cfg["channels"],
                                                cfg["output_rate"]):
                    fault = f"header: {lay}"
                elif lay.sample == "flac":
                    fault = flac_fault(lay, res["flac"], t.frames,
                                       cfg["bit_depth"])
                else:
                    data = t.frames * lay.frame_bytes
                    # WAV and AIFF pad an odd payload to an even size
                    want = lay.offset + data + (data & 1 if lay.padded
                                                else 0)
                    if got != want:
                        fault = f"{got} bytes, {want} expected"
                layouts[t.id] = lay
            except ValueError as e:
                fault = f"header: {e}"
        faults.append(fault)
    for p in (run.tmp / "out").rglob("*"):
        if p.is_file():  # an output that reached a regular file
            faults.append(f"regular file {p.name}")
            p.unlink()
    errs = check.Errors()
    dev = run.device if run.device is not None else "cuda"
    sound = {t.index: (k, t) for k, (t, fault) in enumerate(
        zip(run.tracks, faults)) if t.keep and not fault}
    compared = []
    for k, t in sound.values():
        i = t.index
        data = run.pump.fetch(t.id)
        lay = layouts[t.id]
        if lay.sample == "flac":
            try:
                decoded = containers.flac_samples(data, lay.channels,
                                                  t.frames)
            except ValueError as e:
                faults[k] = str(e)
                continue
            out = check.samples_block(torch.from_numpy(decoded).to(dev),
                                      lay.bits)
        else:
            payload = torch.frombuffer(bytearray(data),
                                       dtype=torch.uint8).to(dev)
            out = check.program_block(payload, lay, cfg["bit_depth"])
        del data
        planes = torch.from_numpy(run.program.planes(i)).to(dev)
        errs.merge(check.compare(
            run.chain, planes, t.frames, out,
            gain=10.0 ** (cfg["level_db"] / 20.0)))
        compared.append(i)
        del out, planes
    # nothing compared: no number, and the run is not correct
    return faults, {"err_max_lsb": errs.max_abs if errs.n else None,
                    "err_rms_lsb": errs.rms if errs.n else None,
                    "compared": errs.n, "worst": errs.worst,
                    "tracks": [i + 1 for i in sorted(compared)]}


def flac_fault(lay, counted: list, frames: int, bit_depth: int) -> str:
    """A FLAC track's fault, or "": its bits per sample, and its frames as
    the I/O child counted them while the stream passed: the block sizes
    of the frames whose header CRC-8 and CRC-16 check must sum to the
    track's frames, with no frame bad and no byte outside a frame."""
    n_frames, samples, bad, stray = counted
    if lay.bits != bit_depth:
        return f"header: {lay.bits} bits per sample"
    if bad or stray:
        return f"FLAC: {bad} bad frames, {stray} stray bytes"
    if samples != frames:
        return (f"FLAC: {samples} samples in {n_frames} frames, {frames} "
                f"expected")
    return ""


def within(value, limit) -> bool:
    """value <= limit, or lo <= value <= hi for a [lo, hi] limit; no
    value is never within."""
    if value is None:
        return False
    if isinstance(limit, list):
        return limit[0] <= value <= limit[1]
    return value <= limit


def main(argv=None, device=None, root: Path = ROOT) -> int:
    """A run of a cell; returns the exit code. `device` None is the
    benchmark's own run (cuda:0, and it refuses to run without the cards
    the cell asks for); a named device (the tests' "cpu") skips that."""
    p = argparse.ArgumentParser(prog="python -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    cell = load_cell(a.workload, root)

    import torch

    if device is None and (not torch.cuda.is_available()
                           or torch.cuda.device_count() < cell.chips):
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    ent = entry(cell.work["entry"], root)
    tmp = Path(tempfile.mkdtemp(prefix="dsd2dxd-bench-"))
    pump = Pump()
    run = Run(cell, a.seed, a.seconds, bool(a.trace), device, tmp, pump, ent)
    saved_env = os.environ.pop(PROFILE_ENV, None)
    try:
        run.parse_cli()
        run.make_inputs()
        # streams at once are traced by the harness, one at a time by the
        # port's hook; the profiler's first start belongs to set-up
        own_trace = run.trace and run.entry.STREAMS_AT_ONCE
        if run.trace and not own_trace:
            os.environ[PROFILE_ENV] = str(tmp / "warmtrace")
        run.entry.warm(run)
        if own_trace:
            with torch.profiler.profile():
                pass
        elif run.trace:
            os.environ[PROFILE_ENV] = str(tmp / "traces")
        if device is None:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup_s = process_age()
        window_s = (run.profiled_window(tmp / "traces") if own_trace
                    else run.window())
        os.environ.pop(PROFILE_ENV, None)
        results = pump.results()
        peak = (torch.cuda.max_memory_allocated()
                if device is None else 0)
        if device is None:
            torch.cuda.empty_cache()
        faults, numbers = check_outputs(run, results)
        summary = None
        if run.trace:
            from benchmark import tracing, work

            summary = tracing.summarise(tmp / "traces")
            summary.walls = [t.wall for t in run.tracks]
            if not own_trace:
                summary.audio_s = sum(t.audio_s for t in run.tracks)
            cfg = cell.config
            summary.work = tuple(cfg["channels"] * x for x in work.chain_work(
                cfg["chain"], cfg["dsd_hz"], cfg["output_rate"],
                cfg["bit_depth"], cfg["dither"] != "N"))
    finally:
        os.environ.pop(PROFILE_ENV, None)
        if saved_env is not None:
            os.environ[PROFILE_ENV] = saved_env
        pump.close()
        shutil.rmtree(tmp, ignore_errors=True)

    bad = [f for f in faults if f]
    from benchmark import stats

    metrics = {}
    if not run.trace:
        values = {"audio_xrt": (stats.audio_xrt([t.audio_s for t in run.tracks],
                                                window_s), "audio-s/s"),
                  "setup_s": (setup_s, "s")}
        metrics = {k: {"value": values[k][0], "unit": values[k][1]}
                   for k in cell.e2e if k in values}
    else:
        for name, unit in cell.per_layer.items():
            v = reader(name, root)(summary)
            if v is not None:
                metrics[name] = {"value": v, "unit": unit}
        if "kernel_roofline_pct" in metrics:
            from benchmark import work

            _s, by = work.bound_s(summary.work)
            print(f"kernel_roofline_pct: bound by {by}", file=sys.stderr)

    limits = cell.work["limits"]
    check = {"tracks_bad": {"value": len(bad), "limit": limits["tracks_bad"]},
             "err_max_lsb": {"value": numbers["err_max_lsb"],
                             "limit": limits["err_max_lsb"]},
             "err_rms_lsb": {"value": numbers["err_rms_lsb"],
                             "limit": limits["err_rms_lsb"]}}
    correct = all(within(v["value"], v["limit"]) for v in check.values())
    dev_info = {"platform": "gpu" if device is None else str(device),
                "kind": (torch.cuda.get_device_name(0) if device is None
                         else str(device)),
                "count": cell.chips, "memory_peak_bytes": peak}
    if run.trace:
        dev_info["busy_s"] = summary.busy_us / 1e6
        dev_info["window_s"] = summary.stream_us / 1e6

    found = sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))
    if found:
        print(f"benchmark: modules of JAX or the JAX package were loaded: "
              f"{found}", file=sys.stderr)
        return 3

    for f in bad[:10]:
        print(f"fault: {f}", file=sys.stderr)
    print("tracks (index, audio s, wall s): " + " ".join(
        f"{t.index + 1}:{t.audio_s:g}:{t.wall:.3f}" for t in run.tracks),
        file=sys.stderr)
    print(f"compared {numbers['compared']} samples of tracks "
          f"{numbers['tracks']}; worst "
          f"(|e|, frame, channel) {numbers['worst']}", file=sys.stderr)
    for k, v in check.items():
        print(f"{k} {v['value']} limit {v['limit']}", file=sys.stderr)
    line = {"correct": correct, "attempted": len(run.tracks),
            "failed": len(bad), "metrics": metrics, "device": dev_info}
    if run.trace:
        line["breakdown"] = summary.breakdown()
    line["check"] = check
    sys.stdout.write(json.dumps(line) + "\n")
    sys.stdout.flush()
    return 0
