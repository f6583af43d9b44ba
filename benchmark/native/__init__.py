"""The benchmark's own C++ (built by g++ into ``benchmark/_build/`` at
first use, a fixed path in the checkout, so later runs find it):

- ``dsdkit.cc``: the modulator that makes the inputs (``inputs.py``);
- ``drain.cc``: the sink that drains each output FIFO (``pump.py``);
- ``flacread.cc``: the reference's FLAC decoder (``reference/
  containers.py``), on ``flac.h``, which the drain's frame count shares.

None of it links anything of the port."""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import threading
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
BUILD = HERE.parent / "_build"
_libs: dict = {}
_lock = threading.Lock()


def build(source: Path, build_dir: Path, prefix: str) -> Path:
    """`source` built into build_dir/<prefix>_<digest>.so once; the digest
    covers the source and the headers it includes, so an edit builds
    anew."""
    text = source.read_bytes()
    h = hashlib.sha256(text)
    for hdr in re.findall(rb'^#include "([^"]+)"', text, re.M):
        h.update((source.parent / hdr.decode()).read_bytes())
    so = build_dir / f"{prefix}_{h.hexdigest()[:16]}.so"
    if not so.exists():
        build_dir.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        res = subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o",
                              str(tmp), str(source)],
                             capture_output=True, text=True)
        if res.returncode:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed on {source}:\n{res.stderr}")
        os.replace(tmp, so)
    return so


I64P = ctypes.POINTER(ctypes.c_int64)
U8P = ctypes.c_void_p


def _declare(name: str, lib) -> None:
    if name == "drain":
        lib.bench_open.argtypes = [ctypes.c_char_p]
        lib.bench_open.restype = ctypes.c_int
        lib.bench_drain.argtypes = [ctypes.c_int, U8P, ctypes.c_int64, U8P,
                                    ctypes.c_int64, ctypes.c_int,
                                    ctypes.c_double, I64P]
        lib.bench_drain.restype = None
    elif name == "flacread":
        lib.benchflac_decode.argtypes = [U8P, ctypes.c_int64, U8P,
                                         ctypes.c_int64, ctypes.c_int, I64P]
        lib.benchflac_decode.restype = ctypes.c_int64
        lib.benchflac_error.argtypes = [ctypes.c_int]
        lib.benchflac_error.restype = ctypes.c_char_p
        lib.benchflac_scan.argtypes = [U8P, ctypes.c_int64, ctypes.c_int64,
                                       I64P]
        lib.benchflac_scan.restype = None


def load(name: str):
    """``<name>.cc`` built and loaded, its functions declared."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build(HERE / f"{name}.cc", BUILD,
                                        f"libbench{name}")))
            _declare(name, lib)
            _libs[name] = lib
        return _libs[name]


def flac_decode(src: np.ndarray, out: np.ndarray) -> tuple:
    """Decode the uint8 FLAC stream `src` into the (C, cap) int32 `out`:
    (samples per channel or a negative error, the error's name, the byte
    offset and the frame where decoding stopped)."""
    lib = load("flacread")
    info = (ctypes.c_int64 * 2)()
    n = lib.benchflac_decode(src.ctypes.data, src.size, out.ctypes.data,
                             out.shape[1], out.shape[0], info)
    return n, lib.benchflac_error(min(n, 0)).decode(), info[1], info[0]


def flac_scan(src: np.ndarray, piece: int) -> tuple:
    """(frames, samples, bad frames, stray bytes) of the uint8 FLAC stream
    `src`, fed to the drain's counter in pieces of `piece` bytes."""
    res = (ctypes.c_int64 * 4)()
    load("flacread").benchflac_scan(src.ctypes.data, src.size, piece, res)
    return tuple(res)
