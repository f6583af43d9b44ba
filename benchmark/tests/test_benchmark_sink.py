"""The I/O child's drain (``native/drain.cc`` behind ``pump.py``): it
counts every byte of a stream of any length, keeps the head and a kept
stream whole, ends cleanly where the writer dies partway or never comes,
and counts a FLAC stream's frames as it passes."""

from __future__ import annotations

import errno
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from benchmark import harness, native, pump

from .test_benchmark_flac import encode, program


@pytest.fixture
def child():
    p = harness.Pump()
    try:
        yield p
    finally:
        p.close()


def write_fifo(path, data: bytes) -> threading.Thread:
    def run():
        fd = os.open(path, os.O_WRONLY)
        try:
            view = memoryview(data)
            while view:
                view = view[os.write(fd, view):]
        finally:
            os.close(fd)

    t = threading.Thread(target=run)
    t.start()
    return t


def stream(n: int) -> bytes:
    return np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()


@pytest.mark.parametrize("keep", [False, True])
def test_every_byte_is_counted_and_the_kept_bytes_are_the_written(
        child, tmp_path, keep):
    sizes = [0, 1, 1234567, (1 << 20) + 1]
    for k, n in enumerate(sizes):
        if keep:
            child.send(op="reserve", slot=k, bytes=n + 4096)
        os.mkfifo(tmp_path / f"o{k}")
    writers = []
    for k, n in enumerate(sizes):
        child.drain(k, tmp_path / f"o{k}", k if keep else None, False)
        writers.append(write_fifo(tmp_path / f"o{k}", stream(n)))
    for t in writers:
        t.join(timeout=60)
        assert not t.is_alive()
    res = child.results()
    for k, n in enumerate(sizes):
        data = stream(n)
        assert res[k]["bytes"] == n and res[k]["status"] == 0
        assert bytes.fromhex(res[k]["head"]) == data[:pump.HEAD]
        assert res[k]["flac"] is None
        if keep:
            assert child.fetch(k) == data


def test_a_stream_longer_than_its_slot_is_counted_whole(child, tmp_path):
    data = stream(3 << 20)
    child.send(op="reserve", slot=0, bytes=1 << 20)
    os.mkfifo(tmp_path / "o")
    child.drain(1, tmp_path / "o", 0, False)
    write_fifo(tmp_path / "o", data).join(timeout=60)
    assert child.results()[1]["bytes"] == len(data)
    assert child.fetch(1) == data[:1 << 20]


WRITE_AND_DIE = """
import os, signal, sys
fd = os.open(sys.argv[1], os.O_WRONLY)
os.write(fd, b"x" * int(sys.argv[2]))
os.kill(os.getpid(), signal.SIGKILL)
"""


def test_a_writer_that_dies_partway_ends_the_drain(child, tmp_path):
    os.mkfifo(tmp_path / "o")
    child.drain(1, tmp_path / "o", None, False)
    p = subprocess.run([sys.executable, "-c", WRITE_AND_DIE,
                        str(tmp_path / "o"), "70001"], timeout=60)
    assert p.returncode < 0
    res = child.results()[1]
    assert res["bytes"] == 70001 and res["status"] == 0


def test_a_fifo_that_nobody_opens_ends_at_its_limit(tmp_path):
    os.mkfifo(tmp_path / "o")
    fd = native.load("drain").bench_open(str(tmp_path / "o").encode())
    assert fd >= 0
    t0 = time.monotonic()
    res = pump.drain(fd, None, False, 0.5)
    assert 0.5 <= time.monotonic() - t0 < 10
    assert res["bytes"] == 0 and res["status"] == -errno.ETIMEDOUT


def test_a_released_fifo_ends_with_nothing_written(child, tmp_path):
    os.mkfifo(tmp_path / "o")
    child.drain(1, tmp_path / "o", None, False)
    harness.Run.release(tmp_path / "o")
    res = child.results()[1]
    assert res["bytes"] == 0 and res["status"] == 0 and res["head"] == ""


def test_a_flac_stream_is_counted_as_it_passes(child, tmp_path):
    x = program(20, 2, 100000)
    data = encode(x, 20, seekable=False)
    bad = bytearray(data)
    bad[len(data) // 2] ^= 1
    child.send(op="reserve", slot=0, bytes=len(data))
    for k in (0, 1, 2):
        os.mkfifo(tmp_path / f"o{k}")
    child.drain(0, tmp_path / "o0", None, True)
    child.drain(1, tmp_path / "o1", 0, True)
    child.drain(2, tmp_path / "o2", None, True)
    for t in (write_fifo(tmp_path / "o0", data),
              write_fifo(tmp_path / "o1", data),
              write_fifo(tmp_path / "o2", bytes(bad))):
        t.join(timeout=60)
    res = child.results()
    frames = -(-len(x) // 8192)
    assert res[0]["flac"] == res[1]["flac"] == [frames, len(x), 0, 0]
    assert res[2]["flac"][2] >= 1 and res[2]["flac"][1] < len(x)
    assert res[1]["bytes"] == len(data) and child.fetch(1) == data
