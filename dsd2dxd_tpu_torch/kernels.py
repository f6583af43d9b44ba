"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with its own ``nvcc`` for ``sm_90a`` (all started
together), and the objects link into one shared library with a plain C
interface, which ``ctypes`` loads. The library lands in
``dsd2dxd_tpu_torch/_build/`` (gitignored), named by a hash of every file
under ``csrc/`` (headers included) and the flags, and is built at first
use -- never at import, so the package imports where there is no CUDA
toolkit. A failed build raises; nothing falls back to the plain PyTorch
versions.

Each C entry returns ``cudaGetLastError()`` after its launch, and the
Python wrapper raises when that is not 0: a refused launch never runs,
and a later ``synchronize`` would not report it. Each entry also takes
the index of its tensors' device and returns ``cudaErrorInvalidDevice``
(101) when the calling thread's current device is another
(``csrc/device_check.cuh``); the wrappers make that device current
(``launch_device``) before they call.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("fused_decim.cu", "finish.cu", "probes.cu")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

MAX_STAGES = 8  # must equal MAX_STAGES in csrc/decim_body.cuh
VEC = 4         # must equal VEC in csrc/decim_body.cuh

_EPILOGUE_FIELDS = [
    ("gain", ctypes.c_float),
    ("apply_gain", ctypes.c_int),
    ("bit_depth", ctypes.c_int),
    ("dither", ctypes.c_int),
    ("key0", ctypes.c_uint32),
    ("key1", ctypes.c_uint32),
    ("big_endian", ctypes.c_int),
    ("planar", ctypes.c_int),
]


class DecimParams(ctypes.Structure):
    """Mirror of ``struct DecimParams`` in csrc/decim_body.cuh, K1's (and
    the P2 rungs') block geometry (``ops/fused.py::KernelLayout``) and
    epilogue (all fields 4
    bytes wide, so natural alignment matches the C layout; the loader
    also compares sizeof on both sides)."""

    _fields_ = [
        ("n_stages", ctypes.c_int),
        ("channels", ctypes.c_int),
        ("tile_bytes", ctypes.c_int),
        ("tile_frames", ctypes.c_int),
        ("frame_bytes", ctypes.c_int),
        ("n_valid", ctypes.c_int),
        ("halo_bytes", ctypes.c_int),
        ("block_out", ctypes.c_int),
        ("byte_off", ctypes.c_int),
        ("bit_off", ctypes.c_int),
        ("n_load_bytes", ctypes.c_int),
        ("n_groups", ctypes.c_int),
        ("decim0", ctypes.c_int),
        ("n_coefs", ctypes.c_int),
        ("win", ctypes.c_int),
        ("buf_a", ctypes.c_int),
        ("buf_b", ctypes.c_int),
        ("smem_bytes", ctypes.c_int),
        ("n_taps", ctypes.c_int * MAX_STAGES),
        ("tap_off", ctypes.c_int * MAX_STAGES),
        ("n_out", ctypes.c_int * MAX_STAGES),
        ("half", ctypes.c_int * MAX_STAGES),
        *_EPILOGUE_FIELDS,
    ]


class FinishParams(ctypes.Structure):
    """Mirror of ``struct FinishParams`` in csrc/finish.cu, K2's two
    modes: "from z" reads run_frames, "from the head's samples" the
    fields from n_blocks on (two 8-byte fields first, then an even number
    of 4-byte ones: no padding on either side; the loader compares
    sizeof)."""

    _fields_ = [
        ("n_frames", ctypes.c_longlong),
        ("n_valid", ctypes.c_longlong),
        ("channels", ctypes.c_int),
        ("gain", ctypes.c_float),
        ("bit_depth", ctypes.c_int),
        ("dither", ctypes.c_int),
        ("key0", ctypes.c_uint32),
        ("key1", ctypes.c_uint32),
        ("big_endian", ctypes.c_int),
        ("run_frames", ctypes.c_int),
        ("n_blocks", ctypes.c_int),
        ("nhist", ctypes.c_int),
        ("n_taps", ctypes.c_int),
        ("coef_stride", ctypes.c_int),
        ("win_stride", ctypes.c_int),
        ("smem_bytes", ctypes.c_int),
    ]


class DmaParams(ctypes.Structure):
    """Mirror of ``struct DmaParams`` in csrc/probes.cu (one 8-byte field
    first, then 4-byte ones: no padding on either side; the loader
    compares sizeof)."""

    _fields_ = [
        ("in_row_words", ctypes.c_longlong),
        ("rows", ctypes.c_int),
        ("n_blocks", ctypes.c_int),
        ("block_words", ctypes.c_int),
        ("halo_words", ctypes.c_int),
        ("k_sub", ctypes.c_int),
        ("row_words", ctypes.c_int),
        ("slab_words", ctypes.c_int),
        ("smem_bytes", ctypes.c_int),
    ]


_lock = threading.Lock()
_lib = None
BUILD_LOG = ""         # nvcc's output (ptxas register/smem report), kept
                       # beside the library for the loads that find it built
BUILD_SECONDS = None   # wall time of the last build, None if cached


@contextlib.contextmanager
def launch_device(device: torch.device):
    """Make the CUDA `device` (a tensor's) current for a launch; yields
    (the handle of its current stream, its index) for the C entry, which
    refuses any other current device."""
    with torch.cuda.device(device):
        yield torch.cuda.current_stream(device).cuda_stream, device.index


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _digest(csrc: Path = CSRC) -> str:
    """Hash of the flags and of every file under `csrc` (sources and the
    headers they include), so an edit to a header alone rebuilds."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(q for q in csrc.rglob("*") if q.is_file()):
        h.update(f.relative_to(csrc).as_posix().encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (if this exact build is not there yet) and
    return the library path. Raises RuntimeError on a failed build."""
    global BUILD_LOG, BUILD_SECONDS
    lib_path = BUILD_DIR / f"libdsd2dxd_torch_{_digest()}.so"
    log_path = lib_path.with_suffix(".log")
    if lib_path.exists():
        BUILD_LOG = log_path.read_text() if log_path.exists() else ""
        return lib_path
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib_path.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(name).stem}.o" for name in SOURCES]
    tmp = BUILD_DIR / f"{tag}.tmp"
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o),
                                   str(CSRC / name)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for name, o in zip(SOURCES, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        BUILD_LOG = "".join(logs)
        bad = [(name, proc.returncode)
               for name, proc in zip(SOURCES, procs) if proc.returncode]
        if not bad:
            res = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o",
                                  str(tmp), *map(str, objs)],
                                 capture_output=True, text=True)
            BUILD_LOG += res.stdout + res.stderr
            if res.returncode:
                bad = [("link", res.returncode)]
        BUILD_SECONDS = time.perf_counter() - t0
        if bad:
            raise RuntimeError(f"nvcc failed {bad}:\n{BUILD_LOG}")
        log_path.write_text(BUILD_LOG)
        os.replace(tmp, lib_path)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return lib_path


def load() -> ctypes.CDLL:
    """The bound kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.dsd2dxd_decim_params_size.argtypes = []
        lib.dsd2dxd_decim_params_size.restype = ctypes.c_int
        if lib.dsd2dxd_decim_params_size() != ctypes.sizeof(DecimParams):
            raise RuntimeError("DecimParams layout differs between "
                               "kernels.py and csrc/decim_body.cuh")
        lib.dsd2dxd_fused_decim.argtypes = [
            ctypes.c_void_p,  # halo (C, H) u8
            ctypes.c_void_p,  # x (C, T) u8
            ctypes.c_void_p,  # coefs f32 (fused.kernel_coefs)
            ctypes.c_void_p,  # out (T_out*C*bytes_per_sample,) u8
            ctypes.c_void_p,  # peak f32[1], zeroed
            ctypes.POINTER(DecimParams),
            ctypes.c_void_p,  # cudaStream_t
            ctypes.c_int,     # device index of the tensors (check_device)
        ]
        lib.dsd2dxd_fused_decim.restype = ctypes.c_int
        lib.dsd2dxd_fused_decim_attrs.argtypes = [
            ctypes.c_int,                     # dynamic shared memory bytes
            ctypes.POINTER(ctypes.c_int),     # out: blocks/SM, threads, regs, local
            ctypes.c_int,                     # device index
        ]
        lib.dsd2dxd_fused_decim_attrs.restype = ctypes.c_int
        lib.dsd2dxd_finish_params_size.argtypes = []
        lib.dsd2dxd_finish_params_size.restype = ctypes.c_int
        if lib.dsd2dxd_finish_params_size() != ctypes.sizeof(FinishParams):
            raise RuntimeError("FinishParams layout differs between "
                               "kernels.py and csrc/finish.cu")
        lib.dsd2dxd_finish.argtypes = [
            ctypes.c_void_p,  # z (C, n_frames) f32
            ctypes.c_void_p,  # out (n_frames*C*bytes_per_sample,) u8
            ctypes.c_void_p,  # peak f32[1], zeroed
            ctypes.POINTER(FinishParams),
            ctypes.c_void_p,  # cudaStream_t
            ctypes.c_int,     # device index
        ]
        lib.dsd2dxd_finish.restype = ctypes.c_int
        lib.dsd2dxd_finish_tail.argtypes = [
            ctypes.c_void_p,  # y (C, 147 n_blocks) f32
            ctypes.c_void_p,  # hist (C, 147) f32
            ctypes.c_void_p,  # coefs (160, coef_stride) f32
            ctypes.c_void_p,  # offs (160,) i32
            ctypes.c_void_p,  # out (160 n_blocks*C*bytes_per_sample,) u8
            ctypes.c_void_p,  # peak f32[1], zeroed
            ctypes.POINTER(FinishParams),
            ctypes.c_void_p,  # cudaStream_t
            ctypes.c_int,     # device index
        ]
        lib.dsd2dxd_finish_tail.restype = ctypes.c_int
        lib.dsd2dxd_dma_params_size.argtypes = []
        lib.dsd2dxd_dma_params_size.restype = ctypes.c_int
        if lib.dsd2dxd_dma_params_size() != ctypes.sizeof(DmaParams):
            raise RuntimeError("DmaParams layout differs between "
                               "kernels.py and csrc/probes.cu")
        lib.dsd2dxd_dma_probe.argtypes = [
            ctypes.c_void_p,  # x u32 words
            ctypes.c_void_p,  # out f32
            ctypes.c_int,     # mode
            ctypes.POINTER(DmaParams),
            ctypes.c_void_p,  # cudaStream_t
            ctypes.c_int,     # device index
        ]
        lib.dsd2dxd_dma_probe.restype = ctypes.c_int
        lib.dsd2dxd_probe_step.argtypes = [
            ctypes.c_void_p,  # halo (C, H) u8
            ctypes.c_void_p,  # x (C, T) u8
            ctypes.c_void_p,  # coefs f32 (fused.kernel_coefs)
            ctypes.c_void_p,  # out (C, T_out) f32 or i32
            ctypes.c_void_p,  # peak f32[1], zeroed
            ctypes.c_int,     # rung
            ctypes.POINTER(DecimParams),
            ctypes.c_void_p,  # cudaStream_t
            ctypes.c_int,     # device index
        ]
        lib.dsd2dxd_probe_step.restype = ctypes.c_int
        _lib = lib
        return lib
