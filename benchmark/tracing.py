"""Reading the program's own traces: the Chrome traces that
``DSD2DXD_PROFILE_DIR`` makes the port write, one per traced stream.

From each trace the harness takes the host spans the port opens
(``dsd2dxd.*``, category ``user_annotation``) and the card's activity
(categories ``kernel``, ``gpu_memcpy``, ``gpu_memset``), and sums them
over every trace of the window into a ``Summary`` that the per-layer
readers (``metrics/``) take their numbers from.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from pathlib import Path

SPAN = "dsd2dxd."
WINDOW = "benchmark.window"  # the harness's own span around a window
# a trace's traced time: the port's streams, or the harness's window where
# it traces streams at once itself
SPANS = (SPAN + "stream", WINDOW)
DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")


def union_us(intervals: list, t0: float, t1: float) -> list:
    """The union of (start, end) intervals clipped to [t0, t1), merged and
    sorted."""
    out: list = []
    for a, b in sorted((max(a, t0), min(b, t1)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


@dataclass
class Summary:
    """What the traces of a window hold, summed over them. The traced time
    is the union of each trace's ``dsd2dxd.stream`` (or the harness's
    window) spans; the card is busy where any kernel, copy or set ran in
    it.

    ``audio_s`` is the audio the traced streams converted, or None where
    the harness cannot tell which streams were traced (streams at once)."""

    stream_us: float = 0.0
    busy_us: float = 0.0
    span_ms: dict = field(default_factory=dict)
    device_us: dict = field(default_factory=dict)  # by event name
    kernel_us: float = 0.0
    idle_by_span: dict = field(default_factory=dict)
    audio_s: float | None = None
    work: tuple | None = None  # the chain's (bytes, f32, int) per audio-s
    walls: list | None = None  # each track's wall, call to closed output

    def add(self, path: Path) -> None:
        events = [e for e in json.loads(path.read_text())["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
        host = [e for e in events if e.get("cat") == "user_annotation"
                and (str(e.get("name", "")).startswith(SPAN)
                     or e.get("name") in SPANS)]
        device = [e for e in events if e.get("cat") in DEVICE]
        for e in host:
            if e["name"] not in SPANS:
                self.span_ms[e["name"]] = (self.span_ms.get(e["name"], 0.0)
                                           + e["dur"] / 1e3)
        for e in device:
            name = short(e["name"])
            self.device_us[name] = self.device_us.get(name, 0.0) + e["dur"]
            if e["cat"] == "kernel":
                self.kernel_us += e["dur"]
        streams = [e for e in host if e["name"] in SPANS]
        tids = {e["tid"] for e in streams}
        threads = [e for e in host if e["tid"] in tids
                   and e["name"] not in SPANS]
        on_card = [(e["ts"], e["ts"] + e["dur"]) for e in device]
        # streams at once (the CLI's batch) share the card: the union of
        # their spans is the traced time
        for t0, t1 in union_us([(e["ts"], e["ts"] + e["dur"])
                                for e in streams], -math.inf, math.inf):
            self.stream_us += t1 - t0
            busy = union_us(on_card, t0, t1)
            self.busy_us += sum(b - a for a, b in busy)
            edges = [t0] + [x for iv in busy for x in iv] + [t1]
            for a, b in zip(edges[::2], edges[1::2]):
                if b > a:
                    name = _innermost(threads, (a + b) / 2,
                                      streams[0]["name"])
                    self.idle_by_span[name] = (self.idle_by_span.get(name, 0.0)
                                               + (b - a))

    def breakdown(self) -> dict:
        """The contract's optional ``breakdown``: the device operations
        that took most time and the idle time by the host span open on
        the stream's thread, ten of each, in seconds."""
        ops = sorted(self.device_us.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v / 1e6] for k, v in ops],
                "idle_gaps": [[k, v / 1e6] for k, v in gaps]}


def short(name: str) -> str:
    """A device operation's name, a kernel's without its argument list,
    at most 100 characters."""
    if not name.startswith(("Memcpy", "Memset")):
        name = name.split("(", 1)[0]
    return name[:100]


def _innermost(spans: list, t: float, outer: str) -> str:
    """The shortest span covering time t, or `outer`, the traced time's
    own span."""
    best = None
    for e in spans:
        if e["ts"] <= t < e["ts"] + e["dur"] and (
                best is None or e["dur"] < best["dur"]):
            best = e
    return best["name"] if best is not None else outer


def summarise(trace_dir: Path) -> Summary:
    s = Summary()
    for p in sorted(trace_dir.glob("*.pt.trace.json")):
        s.add(p)
    return s
