"""The port stands alone: a fresh interpreter imports every module of
dsd2dxd_tpu_torch, converts a CPU tile of each family, runs the CLI on a
small .dsf and the driver entry points (entry.py, tools/bench.py's device
and e2e loops) at a tiny size, and neither jax nor any module of the JAX
package (dsd2dxd_tpu) is loaded; no source file of the port, nor chip_smoke.py,
imports either."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "dsd2dxd_tpu_torch"

_PROBE = r"""
import importlib, pkgutil, sys, tempfile
from pathlib import Path


class _Refuse:
    # a meta-path finder that makes any import of jax or of the JAX
    # package fail where it happens
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in ("jax", "jaxlib", "dsd2dxd_tpu"):
            raise ImportError(f"the port imported {name}")
        return None


sys.meta_path.insert(0, _Refuse())
import numpy as np, torch
import dsd2dxd_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dsd2dxd_tpu_torch.__path__,
                                                 "dsd2dxd_tpu_torch.")]
for n in names:
    importlib.import_module(n)
assert {"dsd2dxd_tpu_torch.parallel.sharded", "dsd2dxd_tpu_torch.ops.dsm",
        "dsd2dxd_tpu_torch.tools.shardcheck",
        "dsd2dxd_tpu_torch.tools.compare_reference",
        "dsd2dxd_tpu_torch.tools.flacbench",
        "dsd2dxd_tpu_torch.tools.njadbench",
        "dsd2dxd_tpu_torch.tools.hostbudget",
        "dsd2dxd_tpu_torch.tools.bench",
        "dsd2dxd_tpu_torch.tools.lightspeed",
        "dsd2dxd_tpu_torch.entry"} <= set(names)
from dsd2dxd_tpu_torch import DitherType, DsdRate, FilterType
from dsd2dxd_tpu_torch.cli.dsd2dxd import run
from dsd2dxd_tpu_torch.formats.dsf import write_dsf
from dsd2dxd_tpu_torch.ops import fused, rational
from dsd2dxd_tpu_torch.ops.plan import get_chain
from dsd2dxd_tpu_torch.ops.resample import StepConfig
rng = np.random.default_rng(0)
chain = get_chain(FilterType.EQUIRIPPLE, DsdRate.DSD64, 352800)
cfg = StepConfig(channels=2, tile_bytes=1024, bit_depth=24,
                 dither=DitherType.TPDF, level_db=0.0)
step = fused.make_fused_step(chain, cfg, "cpu")
x = torch.from_numpy(rng.integers(0, 256, (2, 1024), dtype=np.uint8))
wire, peak, halo = step(x, fused.init_fused_halo(chain, 2), 1)
assert wire.numel() == 1024 * 2 * 3 and float(peak) > 0
chain = get_chain(FilterType.EQUIRIPPLE, DsdRate.DSD64, 192000)
cfg = StepConfig(channels=2, tile_bytes=2352, bit_depth=32,
                 dither=DitherType.FPD, level_db=0.0)
x = torch.from_numpy(rng.integers(0, 256, (2, 2352), dtype=np.uint8))
wire, peak, state = rational.make_rational_step(chain, cfg, "cpu")(
    x, rational.init_rational_state(chain, 2), 1)
assert wire.numel() == 1280 * 2 * 4 and float(peak) > 0
from dsd2dxd_tpu_torch.ops.dsm import synth_tone_dsd
from dsd2dxd_tpu_torch.parallel.sharded import convert_stream_tiled
planes = synth_tone_dsd(1000.0, 0.01, 2822400, channels=2)
wire, peak = convert_stream_tiled(planes, chain, cfg, ["cpu"] * 2)
assert wire.size == 1920 * 2 * 4 and peak > 0  # 0.01 s at 192 kHz, f32
d = Path(tempfile.mkdtemp())
write_dsf(d / "t.dsf", rng.integers(0, 256, (2, 40000), dtype=np.uint8),
          2822400)
(d / "out").mkdir()
assert run(["-o", "w", "-q", "-p", str(d / "out"), str(d / "t.dsf")],
           device="cpu") == 0
assert (d / "out" / "t.wav").stat().st_size == 44 + 40000 * 2 * 3
import contextlib, io
from dsd2dxd_tpu_torch.entry import dryrun_multichip, entry
from dsd2dxd_tpu_torch.tools import bench
step, args = entry("cpu")
wire, peak, halo = step(*args)
assert wire.numel() == 65536 * 2 * 3 and float(peak) > 0
assert bench.device_step("cpu", n_tiles=2, tile_bytes=2048)["runs"] == 1
assert bench.e2e_step("cpu", n_tiles=2, tile_bytes=2048)["runs"] == 1
with contextlib.redirect_stdout(io.StringIO()):
    dryrun_multichip(2, "cpu")
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "dsd2dxd_tpu"))
assert not loaded, loaded
print(len(names))
"""

# `python -m TOOL --help` with the same refusing finder in place
_HELP = r"""
import runpy, sys


class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "dsd2dxd_tpu"):
            raise ImportError(f"the port imported {name}")
        return None


sys.meta_path.insert(0, _Refuse())
sys.argv = [sys.argv[1], "--help"]
runpy.run_module(sys.argv[0], run_name="__main__")
"""

TOOLS = ("compare_reference", "flacbench", "njadbench", "hostbudget",
         "bench", "lightspeed")

_JAX_PACKAGE_IMPORT = re.compile(
    r"^\s*(import\s+dsd2dxd_tpu\b(?!_)|from\s+dsd2dxd_tpu(\.|\s+import\b))",
    re.M)


def _sources():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 30
    return files


def test_port_path_never_loads_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 46  # every module was imported


@pytest.mark.parametrize("tool", TOOLS)
def test_host_tool_help_without_jax(tool):
    """The host tools', the bench's and lightspeed's entry points start
    with jax and the JAX package refused."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    name = f"dsd2dxd_tpu_torch.tools.{tool}"
    res = subprocess.run([sys.executable, "-c", _HELP, name], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith(f"usage: {tool}"), res.stdout


def test_no_jax_import_in_sources():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax[\s.])", re.M)
    for f in _sources():
        assert not pat.search(f.read_text()), f


def test_no_jax_package_import_in_sources():
    """No `import dsd2dxd_tpu` or `from dsd2dxd_tpu.` (the JAX package;
    `dsd2dxd_tpu_torch` is the port) in the port or chip_smoke.py."""
    for f in _sources():
        hits = [m.group(0).strip()
                for m in _JAX_PACKAGE_IMPORT.finditer(f.read_text())]
        assert not hits, (f, hits)


def test_jax_package_import_pattern():
    for line in ("import dsd2dxd_tpu", "from dsd2dxd_tpu.ops import fused",
                 "    from dsd2dxd_tpu import Converter",
                 "import dsd2dxd_tpu.formats.dsf as d"):
        assert _JAX_PACKAGE_IMPORT.search(line), line
    for line in ("import dsd2dxd_tpu_torch", "from dsd2dxd_tpu_torch.ops "
                 "import fused", "# dsd2dxd_tpu.ops.fused is the reference"):
        assert not _JAX_PACKAGE_IMPORT.search(line), line
