"""The benchmark of dsd2dxd_tpu_torch on an NVIDIA H100: ``python -m
benchmark.run`` (``harness.py``), its cells (``workloads/``),
configurations (``configs/``), per-layer readers (``metrics/``), the
input generator (``inputs.py``), the I/O child (``pump.py``) and the
plain reference (``reference/``)."""
