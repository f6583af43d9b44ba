"""The port's driver entry points on the CPU: ``tools/bench.py`` against
``bench.py`` and ``entry.py`` against ``__graft_entry__.py`` (both at the
repository root, loaded by path).

Tolerances: metric names and fixture bytes equal; every bench mode at
``--device cpu`` prints exactly one JSON line with a null value (no CPU
time under a metric name); without a card the null line and exit 1. The
flagship step against the JAX entry's on the same bytes: peak within 1e-4,
and past the first 128 frames (the JAX phase path is zero-primed, the
port idle-primed with 0x69) the 24-bit samples dither-equivalent by
compare_reference's limit, RMS <= 0.8 LSB (independent TPDF noise on both
sides, about 0.71 LSB).
"""

import ast
import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from dsd2dxd_tpu.formats import dff as jdff
from dsd2dxd_tpu.formats import dsf as jdsf
from dsd2dxd_tpu.formats.id3 import Id3Frame as JId3Frame
from dsd2dxd_tpu.formats.id3 import Id3Tag as JId3Tag
from dsd2dxd_tpu.ops.dsm import synth_tone_dsd as jsynth_tone_dsd
from dsd2dxd_tpu_torch import entry as tentry
from dsd2dxd_tpu_torch.pipeline.engine import int_frames
from dsd2dxd_tpu_torch.tools import bench

ROOT = Path(__file__).resolve().parent.parent
MODES = [[], ["--e2e"]] + [["--config", str(n)] for n in range(1, 6)]
MODE_IDS = ["device", "e2e"] + [f"config{n}" for n in range(1, 6)]
HEAD_SKIP = 128  # zero-primed JAX phase path vs idle-primed port
DITHER_EQUIV_RMS_LSB = 0.8  # compare_reference's dither-equiv limit


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(capsys) -> list[dict]:
    out = capsys.readouterr().out.splitlines()
    return [json.loads(ln) for ln in out]


# -- bench.py's definitions ---------------------------------------------------

def _step_metric_names(source: str) -> set[str]:
    """The device-step metric names bench.py builds: "xrt_..." + ("a" if
    e2e else "b")."""
    names = set()
    for node in ast.walk(ast.parse(source)):
        if (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add)
                and isinstance(node.left, ast.Constant)
                and str(node.left.value).startswith("xrt_")
                and isinstance(node.right, ast.IfExp)):
            names |= {node.left.value + node.right.body.value,
                      node.left.value + node.right.orelse.value}
    return names


def test_metric_names_equal_bench_py():
    """_CFG_METRICS as they are; the device and e2e names with bench.py's
    _e2e_tunnel suffix as _e2e."""
    path = ROOT / "bench.py"
    jbench = _load("_jax_bench", path)
    assert bench.CFG_METRICS == jbench._CFG_METRICS
    names = _step_metric_names(path.read_text())
    assert names == {"xrt_dsd64_stereo_to_352k8_24bit_device",
                     "xrt_dsd64_stereo_to_352k8_24bit_e2e_tunnel"}
    assert {n.replace("_e2e_tunnel", "_e2e") for n in names} == {
        bench.METRIC_DEVICE, bench.METRIC_E2E}
    assert [bench.metric_name(config=n) for n in range(1, 6)] == [
        jbench._CFG_METRICS[n] for n in range(1, 6)]


@pytest.mark.parametrize("n", range(1, 6), ids=[f"config{n}"
                                                  for n in range(1, 6)])
def test_fixture_bytes_equal_jax(n, tmp_path):
    """Each config's input files, at 1 s, byte-equal to the JAX package's
    synth_tone_dsd + write_dsf / write_dff of the same tiled tone (raw:
    the planes byte-interleaved), bench.py's tag on the tagged ones."""
    seconds = 1.0
    paths = bench.fixtures(n, seconds, tmp_path / "port")
    jtag = JId3Tag(frames=[JId3Frame.text_frame("TIT2", "1kHz Test Tone"),
                           JId3Frame.text_frame("TPE1", "bench"),
                           JId3Frame.text_frame("TALB", "Bench Tones")]
                   ).to_bytes()
    assert bench.bench_tag() == jtag
    assert len(paths) == len(bench.CONFIG_FIXTURES[n])
    for path, f in zip(paths, bench.CONFIG_FIXTURES[n]):
        planes = jsynth_tone_dsd(1000.0, 1.0, f.rate_hz, amplitude=0.5,
                                 channels=2)
        want = tmp_path / "jax" / f.name
        want.parent.mkdir(parents=True, exist_ok=True)
        id3 = jtag if f.tagged else None
        if path.suffix == ".dsf":
            jdsf.write_dsf(want, planes, f.rate_hz, lsb_first=True, id3=id3)
        elif path.suffix == ".dff":
            jdff.write_dff(want, planes, f.rate_hz, id3=id3)
        else:
            inter = np.empty((planes.shape[1] * 2,), dtype=np.uint8)
            inter[0::2], inter[1::2] = planes[0], planes[1]
            want.write_bytes(inter.tobytes())
        assert path.read_bytes() == want.read_bytes(), f.name
        assert bench.tone_seconds(f.rate_hz, seconds) == 1.0


def test_tone_planes_tile_one_period(tmp_path):
    """bench.py's lengths: one second modulated, tiled to round(seconds);
    a length under a second is modulated whole."""
    one = bench.tone_planes(2_822_400, 1.0, tmp_path)
    three = bench.tone_planes(2_822_400, 3.0, tmp_path)
    assert one.shape == (2, 352800)
    assert np.array_equal(three, np.tile(one, (1, 3)))
    short = bench.tone_planes(2_822_400, 0.25, tmp_path)
    assert short.shape == (2, 88200)
    assert bench.tone_seconds(2_822_400, 24.0) == 24.0
    assert bench.tone_seconds(2_822_400, 0.25) == 0.25


# -- the modes on the CPU -----------------------------------------------------

@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_mode_on_cpu_prints_one_null_line(mode, tmp_path, monkeypatch,
                                          capsys):
    """Each mode at --device cpu runs the plain versions at the tiny size
    and prints exactly one JSON line: its metric, a null value and a note;
    config 5 writes its 3 FLACs."""
    monkeypatch.setattr(bench, "CACHE", tmp_path / "cache")
    out = tmp_path / "out"
    assert bench.main(mode + ["--device", "cpu", "--out", str(out)]) == 0
    lines = _lines(capsys)
    config = int(mode[1]) if mode[:1] == ["--config"] else None
    assert len(lines) == 1
    line = lines[0]
    assert line["metric"] == bench.metric_name("--e2e" in mode, config)
    assert line["value"] is None and line["vs_baseline"] is None
    assert line["unit"] == "x_realtime" and "cpu" in line["note"]
    assert line["launches"] == {}  # nothing launched on the CPU
    assert line["runs"] == (1 if config is None else 2)
    if config == 5:
        for sub in ("w", "w2"):
            flacs = sorted(p.name for p in (out / sub).rglob("*.flac"))
            assert flacs == ["a64.flac", "b64.flac", "c128.flac"]
    if config == 4:
        assert sorted(p.name for p in (out / "w2").iterdir()) == [
            "bench256.aifc", "bench512.aifc"]


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_no_card_prints_null_line_and_fails(mode, monkeypatch, capsys):
    """Without a card and without --device cpu: the null line under the
    same metric name, exit 1, nothing run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench, "config_n", None)
    monkeypatch.setattr(bench, "device_step", None)
    monkeypatch.setattr(bench, "e2e_step", None)
    assert bench.main(mode) == 1
    lines = _lines(capsys)
    config = int(mode[1]) if mode[:1] == ["--config"] else None
    assert len(lines) == 1
    assert lines[0]["metric"] == bench.metric_name("--e2e" in mode, config)
    assert lines[0]["value"] is None and "no measurement" in lines[0]["note"]


def test_device_step_on_cpu_sizes():
    """The default mode's bookkeeping at a tiny size: audio seconds of n
    tiles of DSD64, one run, no time."""
    res = bench.device_step("cpu", n_tiles=3, tile_bytes=2048)
    assert res == {"audio_s": 3 * 2048 * 8 / 2_822_400, "seconds": None,
                   "runs": 1}


# -- entry.py against __graft_entry__.py --------------------------------------

def test_entry_step_against_graft_entry():
    """The flagship step on the CPU against the JAX entry's step on the
    same bytes: the configuration, the input, the peak within 1e-4 and the
    samples dither-equivalent past the warm-up."""
    jentry = _load("_jax_graft_entry", ROOT / "__graft_entry__.py")
    jfn, (jx, jhists, jkey) = jentry.entry()
    step, (x, halo, key) = tentry.entry(device="cpu")
    jchain, jcfg = jentry._flagship()
    chain, cfg = tentry._flagship()
    assert (cfg.channels, cfg.tile_bytes, cfg.bit_depth, cfg.dither.name,
            cfg.level_db) == (jcfg.channels, jcfg.tile_bytes, jcfg.bit_depth,
                              jcfg.dither.name, jcfg.level_db)
    assert [s.n_taps for s in chain] == [s.n_taps for s in jchain]
    assert x.device.type == "cpu" and np.array_equal(x.numpy(), jx)
    wire, peak, new_halo = step(x, halo, key)
    jout, jpeak, _ = jax.jit(jfn)(jx, jhists, jkey)  # as a driver runs it
    got = int_frames(wire.numpy(), 24, 2).astype(np.int64)
    want = np.asarray(jout).astype(np.int64)
    assert got.shape == want.shape == (65536, 2)
    assert abs(float(peak) - float(jpeak)) < 1e-4
    d = (got - want)[HEAD_SKIP:]
    assert np.sqrt(np.mean(d.astype(np.float64) ** 2)) <= DITHER_EQUIV_RMS_LSB
    assert tuple(new_halo.shape) == tuple(halo.shape)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_cpu(n, capsys):
    """dryrun_multichip over n CPU entries: both chains, both epilogues,
    the grid's shape and the stream equal to the streaming step."""
    tentry.dryrun_multichip(n, device="cpu")
    out = capsys.readouterr().out
    assert out.startswith(f"dryrun_multichip OK over {n} entries")
    assert out.count("tiles equal") == 4


def test_dryrun_entries():
    """A named device is repeated n times; without one, the cards (none
    here: it raises)."""
    assert tentry._entries(3, "cpu") == [torch.device("cpu")] * 3
    if not torch.cuda.is_available():
        from dsd2dxd_tpu_torch.utils.errors import ConfigError

        with pytest.raises(ConfigError):
            tentry._entries(2)
