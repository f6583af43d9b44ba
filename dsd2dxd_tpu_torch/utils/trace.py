"""The engine's profiler hook: with DSD2DXD_PROFILE_DIR set, the streams of
a process record into one ``torch.profiler`` session, written as one
Chrome trace in that directory when its last stream ends.

Counterpart of the JAX engine's ``jax.profiler.trace(prof_dir)`` around a
stream (``dsd2dxd_tpu/pipeline/engine.py``). The trace records CPU
activity always and, where CUDA is available, the card's kernels, copies
and sets, on every thread of the process (the drain threads and the CLI's
workers too), with the host spans ``span`` opens under fixed ``dsd2dxd.``
names:

- ``dsd2dxd.stream``: the whole stream; its length is the stream's wall;
- ``dsd2dxd.setup``: the step, its state and the staging ring, up to the
  first read;
- ``dsd2dxd.read``: the source's read of a tile (and its idle pad), split
  into ``dsd2dxd.read.planes`` (the file's bytes into per-channel planes:
  the reads, the DSF block loop or the interleaved reshape, the
  concatenation) and ``dsd2dxd.read.bitrev`` (the bit reversal of an
  LSB-first stream; an MSB-first stream has none);
- ``dsd2dxd.stage``: a tile's dispatch; on a card split into
  ``dsd2dxd.stage.wait_slot`` (the pinned slot's last upload),
  ``dsd2dxd.stage.fill`` (the copy into it) and ``dsd2dxd.stage.enqueue``;
- ``dsd2dxd.wait_drain``: the reader's waits on the drain thread;
- ``dsd2dxd.drain.wait_copy`` and ``dsd2dxd.drain.write``, on the drain
  thread: the wait for a tile's copy back, and its write; inside the
  write, ``dsd2dxd.drain.njad`` (the host's NJAD requantizer, ``-d N``)
  and ``dsd2dxd.drain.flac`` (the FLAC encoder's encode of the tile, and
  of the last frames at ``finalize``, which runs after the stream's
  spans), only in conversions that run them;
- ``dsd2dxd.finish``: from the end of the loop to the return.

Both routes (the streaming loop and ``parallel/sharded.py``) use these
names for the same roles.

The session is shared and counted: the first holder (``stream_trace``) to
enter opens it, holders that enter while it is open join it, and the last
to leave stops it and writes the trace, named after the first holder,
``<name>_<pid>.<ns>.pt.trace.json``. A stream alone writes one trace; the
CLI holds the session around a whole batch, so the batch writes one trace
with every worker's spans on its own thread. Every holder's spans end
before it leaves, so none is live when the session stops. Where a
profiler session that this hook did not open is running, the hook opens
none, records no span and says so once in the log.
"""

from __future__ import annotations

import contextlib
import os
import threading

import torch

from dsd2dxd_tpu_torch.utils.errors import ConfigError
from dsd2dxd_tpu_torch.utils.logging import get_logger

ENV = "DSD2DXD_PROFILE_DIR"

_LOCK = threading.Lock()  # the session's start and stop, and the fields below
_holders = 0  # holders inside the session (or inside a foreign one)
_prof = None  # the open session, or None
_open = False  # spans record: set after the start, cleared before the stop
_foreign_noted = False  # the log has said that a foreign session runs


def span(name: str):
    """A named host span (``torch.profiler.record_function``) while the
    session is open; otherwise a ``nullcontext``, so an untraced run pays
    nothing."""
    return (torch.profiler.record_function(name) if _open
            else contextlib.nullcontext())


def stream_trace(name: str):
    """The context a stream (or a CLI batch) runs in: a hold on the shared
    session when DSD2DXD_PROFILE_DIR is set, released on exit (also when
    the body raises); otherwise a ``nullcontext`` and no profiler
    object."""
    prof_dir = os.environ.get(ENV)
    if not prof_dir:
        return contextlib.nullcontext()
    return _held(prof_dir, name)


def all_threads_config():
    """The profiler's experimental config that records every thread of the
    process; ConfigError where this torch cannot (the trace would hold the
    opening thread alone)."""
    try:
        return torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except TypeError as e:
        raise ConfigError(
            f"{ENV} needs torch.profiler's profile_all_threads (the drain "
            f"thread's spans), which torch {torch.__version__} lacks: "
            f"{e}") from e


@contextlib.contextmanager
def _held(prof_dir: str, name: str):
    global _holders, _prof, _open, _foreign_noted
    with _LOCK:
        if _holders == 0:
            if getattr(torch.autograd.profiler, "_is_profiler_enabled",
                       False):
                if not _foreign_noted:
                    _foreign_noted = True
                    get_logger().warning(
                        f"{ENV}: a profiler session this hook did not open "
                        f"is running; no trace is written and no "
                        f"dsd2dxd span is recorded while it runs")
            else:
                activities = [torch.profiler.ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(
                    activities=activities,
                    experimental_config=all_threads_config(),
                    on_trace_ready=torch.profiler.tensorboard_trace_handler(
                        prof_dir, worker_name=f"{name}_{os.getpid()}"))
                prof.start()
                _prof = prof
                _open = True
        _holders += 1
    try:
        yield
    finally:
        with _LOCK:
            _holders -= 1
            if _holders == 0 and _prof is not None:
                _open = False
                prof, _prof = _prof, None
                prof.stop()  # writes the trace
