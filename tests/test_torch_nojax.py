"""The port never loads jax: a fresh interpreter imports every module of
dsd2dxd_tpu_torch and runs one CPU step, and no source file imports it."""

import os
import re
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent / "dsd2dxd_tpu_torch"

_PROBE = r"""
import importlib, pkgutil, sys
import numpy as np, torch
import dsd2dxd_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dsd2dxd_tpu_torch.__path__,
                                                 "dsd2dxd_tpu_torch.")]
for n in names:
    importlib.import_module(n)
from dsd2dxd_tpu.filters.design import get_chain
from dsd2dxd_tpu.formats.dsd_types import DitherType, DsdRate, FilterType
from dsd2dxd_tpu_torch.ops import fused
from dsd2dxd_tpu_torch.ops.resample import StepConfig
chain = get_chain(FilterType.EQUIRIPPLE, DsdRate.DSD64, 352800)
cfg = StepConfig(channels=2, tile_bytes=1024, bit_depth=24,
                 dither=DitherType.TPDF, level_db=0.0)
step = fused.make_fused_step(chain, cfg, "cpu")
x = torch.from_numpy(np.random.default_rng(0).integers(
    0, 256, (2, 1024), dtype=np.uint8))
wire, peak, halo = step(x, fused.init_fused_halo(chain, 2), 1)
assert wire.numel() == 1024 * 2 * 3 and float(peak) > 0
from dsd2dxd_tpu_torch.ops import rational
chain = get_chain(FilterType.EQUIRIPPLE, DsdRate.DSD64, 192000)
cfg = StepConfig(channels=2, tile_bytes=2352, bit_depth=32,
                 dither=DitherType.FPD, level_db=0.0)
x = torch.from_numpy(np.random.default_rng(0).integers(
    0, 256, (2, 2352), dtype=np.uint8))
wire, peak, state = rational.make_rational_step(chain, cfg, "cpu")(
    x, rational.init_rational_state(chain, 2), 1)
assert wire.numel() == 1280 * 2 * 4 and float(peak) > 0
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
print(len(names))
"""


def test_port_path_never_loads_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(PKG.parent) + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=PKG.parent,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 10  # every module was imported


def test_no_jax_import_in_sources():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax[\s.])", re.M)
    files = list(PKG.rglob("*.py"))
    assert len(files) >= 10
    for f in files:
        assert not pat.search(f.read_text()), f
