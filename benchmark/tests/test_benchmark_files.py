"""BENCHMARK.json and the files it names: every cell, configuration and
metric parses, they agree, and a cell added as a file is found."""

from __future__ import annotations

import hashlib
import json
import re
import shutil

import pytest

from benchmark import harness
from benchmark.reference import containers, decimate

from .conftest import REPO, ROOT

ENTRY = ("CLI_ARGS", "STREAMS_AT_ONCE", "make_inputs", "units_per_lap",
         "unit", "warm")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_benchmark_json_keeps_to_the_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    assert len(b["command"]) <= 32
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
    names = [w["name"] for w in b["workloads"]]
    assert len(set(names)) == len(names)
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    for c in b["configs"]:
        assert (REPO / c["file"]).is_file()
        assert c["source"].startswith("https://github.com/clone206/dsd2dxd")
        assert json.loads((REPO / c["file"]).read_text())["source"] == \
            c["source"]
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_cell_configuration_and_metric_parses():
    b = bench()
    configs = {c["name"]: c for c in b["configs"]}
    for w in b["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.work["config"] == w["config"]
        assert cell.work["traffic"] == w["traffic"]
        mod = harness.entry(cell.work["entry"])
        assert all(hasattr(mod, k) for k in ENTRY)
        assert not {"segments", "keep"} & set(cell.work)
        assert set(cell.work["limits"]) == {"tracks_bad", "err_max_lsb",
                                            "err_rms_lsb"}
        assert "audio_xrt" in cell.e2e and "setup_s" in cell.e2e
        assert cell.per_layer
        cfg = cell.config
        assert REPO / configs[cfg["name"]]["file"] == (
            ROOT / "configs" / f"{cfg['name']}.json")
        chain = decimate.load_chain(cfg["chain"]["table"])
        assert [[m, len(t)] for m, t in zip(chain.M[:chain.n_head],
                                            chain.taps)] == cfg["chain"]["head"]
        assert chain.frames(cfg["dsd_hz"]) == cfg["output_rate"]
    for m in b["per_layer"]:
        assert callable(harness.reader(m["name"]))
    assert {p.stem for p in (ROOT / "metrics").glob("*.py")} - {"__init__"} \
        == {m["name"] for m in b["per_layer"]}


def test_every_workload_file_parses_listed_or_not():
    listed = {w["name"] for w in bench()["workloads"]}
    files = sorted((ROOT / "workloads").glob("*.json"))
    assert listed <= {p.stem for p in files}
    for p in files:
        w = json.loads(p.read_text())
        assert p.stem == f"{w['config']}.{w['traffic']}"
        assert (ROOT / "configs" / f"{w['config']}.json").is_file()
        mod = harness.entry(w["entry"])
        assert all(hasattr(mod, k) for k in ENTRY)
        assert set(w["limits"]) == {"tracks_bad", "err_max_lsb",
                                    "err_rms_lsb"}


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts and "_build" not in p.parts}


def test_a_cell_added_as_a_file_is_found(tmp_path):
    root = tmp_path / "benchmark"
    shutil.copytree(ROOT, root, ignore=shutil.ignore_patterns(
        "_build", "__pycache__"))
    before = _digests(root)
    w = json.loads((root / "workloads" /
                    "dsd64-352k8-s24-tpdf.album-dsf.json").read_text())
    w["tracks_s"] = [60, 90]
    (root / "workloads" / "dsd64-352k8-s24-tpdf.album-short.json").write_text(
        json.dumps(w))
    b = bench()
    b["workloads"].append({"name": "dsd64-352k8-s24-tpdf.album-short",
                           "config": "dsd64-352k8-s24-tpdf",
                           "traffic": "album-short", "chips": 1,
                           "why": "a test's cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = harness.load_cell("dsd64-352k8-s24-tpdf.album-short", root)
    assert cell.work["tracks_s"] == [60, 90]
    assert cell.e2e == ["audio_xrt", "setup_s"]
    assert cell.per_layer == {"device_idle_pct": "%"}
    after = _digests(root)
    added = set(after) - set(before)
    assert [str(p) for p in added] == [
        "workloads/dsd64-352k8-s24-tpdf.album-short.json"]
    assert all(after[p] == before[p] for p in before)


def test_an_entry_added_as_a_file_is_found(tmp_path):
    root = tmp_path / "benchmark"
    shutil.copytree(ROOT, root, ignore=shutil.ignore_patterns(
        "_build", "__pycache__"))
    (root / "entries" / "levels.py").write_text(
        "CLI_ARGS = []\nSTREAMS_AT_ONCE = False\n")
    assert harness.entry("levels", root).STREAMS_AT_ONCE is False
    with pytest.raises(KeyError):
        harness.entry("nowhere", root)


def test_an_output_the_reference_cannot_read_is_refused():
    cell = harness.load_cell("dsd64-352k8-s24-tpdf.album-dsf")
    cell.work = {**cell.work, "argv": ["-o", "a"]}
    run = harness.Run(cell, 1, 1.0, False, "cpu", ROOT, None,
                      harness.entry("album"))
    with pytest.raises(ValueError, match="aif"):
        run.parse_cli()
    with pytest.raises(ValueError, match="aif"):
        containers.parse("aif", b"FORM", 2, 352800, 24)
    for out, ext in (("w", "wav"), ("F", "flac")):
        run.cell.work["argv"] = ["-o", out]
        run.parse_cli()
        assert run.ext == ext and ext in containers.EXTENSIONS
