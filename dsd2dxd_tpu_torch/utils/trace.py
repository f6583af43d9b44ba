"""The engine's profiler hook: with DSD2DXD_PROFILE_DIR set, each stream
is traced by ``torch.profiler`` into one Chrome trace in that directory.

Counterpart of the JAX engine's ``jax.profiler.trace(prof_dir)`` around a
stream (``dsd2dxd_tpu/pipeline/engine.py``). The trace records CPU
activity always and the card's kernels, copies and sets when the stream's
device is a CUDA device, on every thread of the process (the drain thread
too), with the host spans ``span`` opens under fixed ``dsd2dxd.`` names:

- ``dsd2dxd.stream``: the whole stream; its length is the stream's wall;
- ``dsd2dxd.setup``: the step, its state and the staging ring, up to the
  first read;
- ``dsd2dxd.read``: the source's read of a tile (and its idle pad);
- ``dsd2dxd.stage``: a tile's dispatch; on a card split into
  ``dsd2dxd.stage.wait_slot`` (the pinned slot's last upload),
  ``dsd2dxd.stage.fill`` (the copy into it) and ``dsd2dxd.stage.enqueue``;
- ``dsd2dxd.wait_drain``: the reader's waits on the drain thread;
- ``dsd2dxd.drain.wait_copy`` and ``dsd2dxd.drain.write``, on the drain
  thread: the wait for a tile's copy back, and its write;
- ``dsd2dxd.finish``: from the end of the loop to the return.

Both routes (the streaming loop and ``parallel/sharded.py``) use these
names for the same roles.

One profiling session can be open in a process. A stream that starts
while another stream's trace is open converts untraced (its activity
shows in the open trace, which records every thread) and logs one
warning naming its file; it never waits and never fails for it. The JAX
engine raises there instead (``jax.profiler`` refuses a second trace).
"""

from __future__ import annotations

import contextlib
import os
import threading

import torch

from dsd2dxd_tpu_torch.utils.errors import ConfigError
from dsd2dxd_tpu_torch.utils.logging import get_logger

ENV = "DSD2DXD_PROFILE_DIR"

_SESSION = threading.Lock()  # held by the stream whose trace is open
_open = False  # a trace is open: spans record


def span(name: str):
    """A named host span (``torch.profiler.record_function``) while a
    trace is open; otherwise a ``nullcontext``, so an untraced run pays
    nothing."""
    return (torch.profiler.record_function(name) if _open
            else contextlib.nullcontext())


def stream_trace(name: str, device: torch.device):
    """The context a stream runs in: a trace of it when DSD2DXD_PROFILE_DIR
    is set, written on exit (also when the stream raises) as
    ``<name>_<pid>.<ns>.pt.trace.json``; otherwise a ``nullcontext`` and
    no profiler object."""
    prof_dir = os.environ.get(ENV)
    if not prof_dir:
        return contextlib.nullcontext()
    return _traced(prof_dir, name, device)


def all_threads_config():
    """The profiler's experimental config that records every thread of the
    process; ConfigError where this torch cannot (the trace would hold the
    reader thread alone)."""
    try:
        return torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except TypeError as e:
        raise ConfigError(
            f"{ENV} needs torch.profiler's profile_all_threads (the drain "
            f"thread's spans), which torch {torch.__version__} lacks: "
            f"{e}") from e


@contextlib.contextmanager
def _traced(prof_dir: str, name: str, device: torch.device):
    global _open
    if not _SESSION.acquire(blocking=False):
        get_logger().warning(
            f"{ENV}: {name} is not traced (another stream's trace is open; "
            f"its activity shows there)")
        yield
        return
    try:
        config = all_threads_config()
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(
                activities=activities, experimental_config=config,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(
                    prof_dir, worker_name=f"{name}_{os.getpid()}")):
            _open = True
            try:
                yield
            finally:
                _open = False
    finally:
        _SESSION.release()
