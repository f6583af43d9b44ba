"""Device selection and the toolchain probe for the port.

Counterpart of ``dsd2dxd_tpu/utils/device.py`` (``batch_devices``,
``stream_mesh`` as ``stream_devices``). There is no implicit fallback:
``device=None`` means the first CUDA device, and without one it raises.
The CPU runs only when a caller asks for it by name (the tests). Not
ported: ``apply_platform_env`` and ``enable_compile_cache``, settings of
JAX and XLA.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import torch

from dsd2dxd_tpu_torch.utils.errors import ConfigError


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda:0``; anything else as given. Raises ConfigError
    for a CUDA device that is not there."""
    if device is None:
        if not torch.cuda.is_available():
            raise ConfigError("no CUDA device: pass device='cpu' to run the "
                              "plain PyTorch path explicitly")
        return torch.device("cuda", 0)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise ConfigError(f"{dev} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise ConfigError(f"{dev} requested but only "
                              f"{torch.cuda.device_count()} CUDA devices")
    return dev


def batch_devices() -> list[torch.device]:
    """Devices for file-level data parallelism: the CLI round-robins a
    batch of files over them, one pipeline per device (the reference's
    one file per thread, src/main.rs:279-297). Every CUDA device; raises
    ConfigError where there is none, as ``resolve_device`` does."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        raise ConfigError("no CUDA device: pass device='cpu' to run the "
                          "plain PyTorch path explicitly")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def stream_devices() -> list[torch.device] | None:
    """The devices that ONE stream's overlap-save tiles are spread over
    (``parallel/sharded.py``): every CUDA device when
    DSD2DXD_SHARD_STREAM=1 and there are at least two, else None. Opt-in,
    as in the JAX package: file-level parallelism is the better default
    for a batch; tile sharding is for one long file."""
    if os.environ.get("DSD2DXD_SHARD_STREAM") != "1":
        return None
    n = torch.cuda.device_count()
    if n < 2:
        return None
    return [torch.device("cuda", i) for i in range(n)]


def card_label() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them
    (``name, power.limit`` per card, one line each)."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        raise RuntimeError("nvidia-smi not found")
    res = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip()


def toolchain_probe() -> dict:
    """Versions and tools the port's kernels depend on."""
    from dsd2dxd_tpu_torch.kernels import find_nvcc

    try:
        nvcc = find_nvcc()
    except RuntimeError:
        nvcc = None
    try:
        import triton  # noqa: F401
        has_triton = True
    except ImportError:
        has_triton = False
    return {
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "cuda_available": torch.cuda.is_available(),
        "device_count": torch.cuda.device_count(),
        "nvcc": nvcc,
        "triton": has_triton,
    }
