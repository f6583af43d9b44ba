"""The frozen roofline arithmetic gives the bounds of the port's
speed-of-light model (``tools/lightspeed.py``)."""

from __future__ import annotations

import json

from benchmark import work

from .conftest import ROOT


def bound_xrt(config: str, bit_depth: int, dithered: bool):
    cfg = json.loads((ROOT / "configs" / f"{config}.json").read_text())
    w = work.chain_work(cfg["chain"], cfg["dsd_hz"], cfg["output_rate"],
                        bit_depth, dithered)
    s, by = work.bound_s(tuple(cfg["channels"] * x for x in w))
    return 1.0 / s, by


def test_bounds_at_24_bit_tpdf_are_the_models():
    x, by = bound_xrt("dsd64-352k8-s24-tpdf", 24, True)
    assert round(x) == 296733 and by == "f32"
    x, by = bound_xrt("dsd256-384k-f32-fpd", 24, True)
    assert round(x) == 73937 and by == "f32"


def test_the_configurations_own_epilogues():
    assert round(bound_xrt("dsd64-352k8-s24-tpdf", 24, True)[0]) == 296733
    x, by = bound_xrt("dsd256-384k-f32-fpd", 32, True)
    assert round(x) == 73937 and by == "f32"  # FPD's 4 bytes do not bound
