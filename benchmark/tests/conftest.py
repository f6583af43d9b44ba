"""Shared fixtures of the benchmark's tests: a copy of the benchmark's
files (and BENCHMARK.json) whose cells are cut to a size the CPU's plain
path converts in seconds, and the port's engine on small tiles."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REPO = ROOT.parent


FLAC_CELL = "dsd64-352k8-s20-njad.album-flac"


def tiny_copy(dst: Path, test_cells=()) -> Path:
    """dst/benchmark, dst/BENCHMARK.json: every cell's tracks cut to one to
    three engine tiles (8 KiB per channel at DSD64, 10-38 ms; the 48k
    chain's least tile at DSD256, 0.21 s, for 0.25-0.45 s), short
    segments; a workload file that BENCHMARK.json does not list (the raw
    pipe's, kept for a later PR) is listed in the copy, so that its entry
    stays tested. `test_cells` names cells of the tests' own (a workload
    and its configuration under tests/flac/) to add to the copy."""
    shutil.copytree(ROOT, dst / "benchmark",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for name in test_cells:
        config = name.split(".")[0]
        shutil.copy(ROOT / "tests" / "flac" / f"{name}.json",
                    dst / "benchmark" / "workloads")
        shutil.copy(ROOT / "tests" / "flac" / f"{config}.json",
                    dst / "benchmark" / "configs")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    listed = {w["name"] for w in bench["workloads"]}
    for p in (dst / "benchmark" / "workloads").glob("*.json"):
        w = json.loads(p.read_text())
        if p.stem not in listed:  # a workload kept out of BENCHMARK.json
            bench["workloads"].append({
                "name": p.stem, "config": w["config"],
                "traffic": w["traffic"], "chips": 1, "why": "unlisted"})
        dsd64 = w["config"].startswith("dsd64")
        w["tracks_s"] = [round(0.01 + 0.004 * k if dsd64 else 0.25 + 0.1 * k,
                               3) for k in range(len(w["tracks_s"]))]
        w["segment_s"] = 0.02 if dsd64 else 0.005
        p.write_text(json.dumps(w))
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst / "benchmark"


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """The tiny copy's benchmark folder, the engine's tiles at 8 KiB, a
    short warm track."""
    from benchmark import harness
    from dsd2dxd_tpu_torch.pipeline import engine

    monkeypatch.setattr(engine, "_DEFAULT_TILE_TARGET", 8 * 1024)
    monkeypatch.setattr(harness, "WARM_S", 0.05)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    return tiny_copy(tmp_path / "copy", [FLAC_CELL])
