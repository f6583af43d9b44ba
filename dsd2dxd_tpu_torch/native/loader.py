"""Build and bind the port's two host C++ libraries.

- The host library: NJAD dither, the FLAC encoder and the delta-sigma
  modulator of the test signals (``native/src/njad.cc``, ``flac.cc``,
  ``dsdkit.cc``, byte copies of the JAX package's sources), cut from
  ``dsd2dxd_tpu/native/loader.py`` to the NJAD, FLAC and
  ``dsdkit_dsm2_bits`` entry points.
- The reader library (``native/src/dsfread.cc``, the port's own): the
  .dsf reader's de-interleave and bit reversal, built apart so a
  conversion that needs neither NJAD nor FLAC compiles one small file.

Each is built with g++ at first use -- never at import -- into
``dsd2dxd_tpu_torch/_build/`` (gitignored), named by a hash of its
sources and the flags, compiled to a temporary file that is then renamed
(a concurrent process never loads a half-written library). A failed
build raises ConfigError with the compiler's output; nothing falls back
to numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from dsd2dxd_tpu_torch.utils.errors import ConfigError

_PKG = Path(__file__).resolve().parent
SRC = _PKG / "src"
BUILD_DIR = _PKG.parent / "_build"
SOURCES = ("njad.cc", "flac.cc", "dsdkit.cc")
READER_SOURCES = ("dsfread.cc",)
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
             "-fvisibility=hidden")

_lock = threading.Lock()
_lib = None
_reader = None


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for name in sources:
        h.update(name.encode())
        h.update((SRC / name).read_bytes())
    return h.hexdigest()[:16]


def _build(stem: str, sources, what: str) -> Path:
    """Compile `sources` into lib`stem`_<hash>.so (if this exact build is
    not there yet) and return its path; `what` names the library in the
    errors."""
    lib_path = BUILD_DIR / f"lib{stem}_{_digest(sources)}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".so.tmp{os.getpid()}")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), *(str(SRC / s) for s in sources)]
    try:
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise ConfigError(f"g++ could not run ({e}): {what} needs "
                              f"it") from e
        if res.returncode:
            raise ConfigError(f"g++ failed ({res.returncode}) building "
                              f"{what}:\n{res.stderr}")
        tmp.replace(lib_path)
    finally:
        tmp.unlink(missing_ok=True)
    return lib_path


def build() -> Path:
    """The host library's path, compiled if needed."""
    return _build("dsd2dxd_torch_host", SOURCES,
                  "the NJAD/FLAC/modulator host library")


def build_reader() -> Path:
    """The reader library's path, compiled if needed."""
    return _build("dsd2dxd_torch_dsfread", READER_SOURCES,
                  "the .dsf reader library")


class NativeLib:
    """Typed wrapper over the C ABI of njad.cc, flac.cc and dsdkit.cc."""

    def __init__(self, dll: ctypes.CDLL):
        self._dll = dll
        d = dll
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")

        d.dsdkit_dsm2_bits.argtypes = [f64p, u8p, ctypes.c_size_t]
        d.dsdkit_dsm2_bits.restype = None

        d.dsdkit_flac_new.argtypes = [ctypes.c_uint32] * 4
        d.dsdkit_flac_new.restype = ctypes.c_void_p
        d.dsdkit_flac_feed.argtypes = [ctypes.c_void_p, i32p, ctypes.c_size_t]
        d.dsdkit_flac_feed.restype = None
        d.dsdkit_flac_finish.argtypes = [ctypes.c_void_p]
        d.dsdkit_flac_finish.restype = None
        d.dsdkit_flac_pending.argtypes = [ctypes.c_void_p]
        d.dsdkit_flac_pending.restype = ctypes.c_size_t
        d.dsdkit_flac_drain.argtypes = [ctypes.c_void_p, u8p, ctypes.c_size_t]
        d.dsdkit_flac_drain.restype = ctypes.c_size_t
        d.dsdkit_flac_header.argtypes = [ctypes.c_void_p, u8p, ctypes.c_int]
        d.dsdkit_flac_header.restype = None
        d.dsdkit_flac_free.argtypes = [ctypes.c_void_p]
        d.dsdkit_flac_free.restype = None

        d.dsdkit_njad_new.argtypes = [ctypes.c_uint32]
        d.dsdkit_njad_new.restype = ctypes.c_void_p
        d.dsdkit_njad_quantize.argtypes = [
            ctypes.c_void_p, f32p, i32p, ctypes.c_size_t,
            ctypes.c_uint32, ctypes.c_int]
        d.dsdkit_njad_quantize.restype = ctypes.c_int
        d.dsdkit_njad_free.argtypes = [ctypes.c_void_p]
        d.dsdkit_njad_free.restype = None

    def dsm2_bits(self, x: np.ndarray) -> np.ndarray:
        """The 2nd-order delta-sigma modulator (``ops/dsm.py``) over
        float64 samples: DSD bits {0, 1}."""
        x = np.ascontiguousarray(x, dtype=np.float64)
        out = np.empty(x.shape[0], dtype=np.uint8)
        self._dll.dsdkit_dsm2_bits(x, out, x.shape[0])
        return out

    # -- FLAC encoder handle -------------------------------------------------

    def flac_new(self, rate: int, channels: int, bps: int,
                 block_size: int = 4096) -> int:
        enc = self._dll.dsdkit_flac_new(rate, channels, bps, block_size)
        if not enc:
            raise ConfigError(
                f"FLAC encoder rejects rate={rate} channels={channels} "
                f"bps={bps} block_size={block_size} (bps 4-24, <=8 "
                f"channels, block 16-32768)")
        return enc

    def flac_feed(self, enc: int, samples: np.ndarray) -> None:
        """samples: (frames, channels) int32, interleaved in memory."""
        samples = np.ascontiguousarray(samples, dtype=np.int32)
        self._dll.dsdkit_flac_feed(enc, samples.reshape(-1),
                                   samples.shape[0])

    def flac_finish(self, enc: int) -> None:
        self._dll.dsdkit_flac_finish(enc)

    def flac_drain(self, enc: int) -> bytes:
        n = self._dll.dsdkit_flac_pending(enc)
        if n == 0:
            return b""
        out = np.empty(n, dtype=np.uint8)
        got = self._dll.dsdkit_flac_drain(enc, out, n)
        return out[:got].tobytes()

    def flac_header(self, enc: int, is_last: bool) -> bytes:
        out = np.empty(42, dtype=np.uint8)
        self._dll.dsdkit_flac_header(enc, out, 1 if is_last else 0)
        return out.tobytes()

    def flac_free(self, enc: int) -> None:
        self._dll.dsdkit_flac_free(enc)

    # -- NJAD requantizer ----------------------------------------------------

    def njad_new(self, channels: int) -> int:
        state = self._dll.dsdkit_njad_new(channels)
        if not state:
            raise ConfigError(
                f"NJAD dither supports 1-16 channels, got {channels}")
        return state

    def njad_quantize(self, state: int, samples: np.ndarray,
                      bits: int) -> np.ndarray:
        """samples: (frames, channels) float32 full-scale ±1 -> int32."""
        samples = np.ascontiguousarray(samples, dtype=np.float32)
        frames, channels = samples.shape
        out = np.empty((frames, channels), dtype=np.int32)
        rc = self._dll.dsdkit_njad_quantize(state, samples, out, frames,
                                             channels, bits)
        if rc != 0:
            raise ConfigError(
                f"NJAD quantize: {channels} channels / {bits} bits does "
                "not match the handle (per-channel Benford state must "
                "not alias)")
        return out

    def njad_free(self, state: int) -> None:
        self._dll.dsdkit_njad_free(state)


def load() -> NativeLib:
    """The bound host library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = NativeLib(ctypes.CDLL(str(build())))
        return _lib


class ReaderLib:
    """Typed wrapper over the C ABI of dsfread.cc. Both calls take
    pointers, so each checks the sizes it passes first."""

    def __init__(self, dll: ctypes.CDLL):
        self._dll = dll
        size = ctypes.c_size_t
        dll.dsfread_planes.argtypes = [ctypes.c_void_p, size, size, size,
                                       ctypes.c_void_p, size, size]
        dll.dsfread_planes.restype = None
        dll.dsfread_bitrev.argtypes = [ctypes.c_void_p, size]
        dll.dsfread_bitrev.restype = None

    def planes(self, raw: np.ndarray, blocks: int, block_size: int,
               out: np.ndarray, col: int) -> None:
        """De-interleave the `blocks` planar super-blocks at the start of
        `raw` (file order: per block, one run of `block_size` bytes per
        channel) into ``out[:, col:]``, a (channels, n) C-contiguous
        uint8 array whose columns from `col` on the blocks cover."""
        channels, width = out.shape
        ncols = width - col
        if not (raw.dtype == out.dtype == np.uint8
                and raw.flags.c_contiguous and out.flags.c_contiguous
                and raw.size >= blocks * channels * block_size
                and 0 <= col <= width and ncols <= blocks * block_size):
            raise ValueError(
                f"dsfread_planes: {blocks} blocks of {channels} x "
                f"{block_size} bytes in {raw.size} do not fill columns "
                f"{col}:{width} of a {out.dtype} array")
        self._dll.dsfread_planes(raw.ctypes.data, blocks, channels,
                                 block_size, out.ctypes.data + col, width,
                                 ncols)

    def bitrev(self, a: np.ndarray) -> None:
        """Reverse the bit order within each byte of `a`, in place
        (LSB-first <-> MSB-first); equal to ``source.reverse_bits``."""
        if a.dtype != np.uint8 or not a.flags.c_contiguous:
            raise ValueError("dsfread_bitrev needs a C-contiguous uint8 "
                             "array")
        self._dll.dsfread_bitrev(a.ctypes.data, a.size)


def load_reader() -> ReaderLib:
    """The bound reader library, built on first use."""
    global _reader
    with _lock:
        if _reader is None:
            _reader = ReaderLib(ctypes.CDLL(str(build_reader())))
        return _reader
