"""The harness's I/O child: it drains every output a conversion writes
into a FIFO and feeds raw DSD into the FIFOs a conversion reads as its
stdin, so that no output reaches a regular file and the conversion's
process spends nothing on either end of its pipes.

A drain runs in C++ (``native/drain.cc``) on a thread of its own, with
no interpreter on its path: what it does not keep goes from the pipe to
/dev/null by splice, never copied into this process, and it counts every
byte; a FLAC stream is read and its frames counted as it passes.

Commands come as JSON lines on stdin; replies go as JSON lines on
stdout, a kept output's bytes right after its reply line:

    {"op": "pool", "path": P}                 load the raw segment pool
    {"op": "reserve", "slot": S, "bytes": N}
        allocate (and touch) N bytes to keep one output in, before the
        window, so that keeping it costs the window no page faults
    {"op": "drain", "id": K, "path": P, "slot": S or null, "flac": bool}
        open FIFO P's read end, reply {"open": 0 or -errno}, then drain
        it to its end: count its bytes, keep its first HEAD bytes and,
        into slot S, all of it; with "flac", count its FLAC frames. The
        drain ends where no writer comes, or no byte, for LIMIT_S seconds
    {"op": "feed", "path": P, "pieces": [[offset, length], ...]}
        write those slices of the pool into FIFO P, then close it
    {"op": "results"}   wait for every thread; reply {"K": result}, a
        result {"bytes": n, "head": hex, "status": 0 or -errno, "flac":
        [frames, samples, bad frames, stray bytes] or null}
    {"op": "send", "id": K}   reply {"bytes": n}, then the bytes kept
    {"op": "quit"}
"""

from __future__ import annotations

import ctypes
import fcntl
import json
import sys
import threading

from benchmark import native

HEAD = 4096
CHUNK = 1 << 20
F_SETPIPE_SZ = 1031
LIMIT_S = 120.0  # a drain's wait for its writer, and for each next byte


def widen(fd: int) -> None:
    """Give the pipe a 1 MiB buffer where the system allows it."""
    try:
        fcntl.fcntl(fd, F_SETPIPE_SZ, CHUNK)
    except OSError:
        pass


def drain(fd: int, into: bytearray | None, flac: bool,
          limit_s: float = LIMIT_S) -> dict:
    """Drain fd (``bench_open``'s) to its end; with `into`, the stream is
    read straight into it (what does not fit is counted, not kept)."""
    lib = native.load("drain")
    head = bytearray(HEAD)
    res = (ctypes.c_int64 * 8)()
    keep = (ctypes.c_uint8 * len(into)).from_buffer(into) if into else None
    lib.bench_drain(fd, ctypes.addressof(
        (ctypes.c_uint8 * HEAD).from_buffer(head)), HEAD,
        ctypes.addressof(keep) if keep is not None else None,
        len(into) if into else 0, int(flac), limit_s, res)
    total, n_head, kept, status = res[0], res[1], res[2], res[3]
    return {"bytes": total, "head": head[:n_head].hex(), "status": status,
            "kept": kept, "flac": list(res[4:8]) if flac else None}


def feed(path: str, pool: memoryview, pieces: list) -> None:
    """Write the pieces into FIFO `path`; a conversion that stops reading
    (it failed) ends the feed."""
    try:
        with open(path, "wb", buffering=0) as f:
            widen(f.fileno())
            for off, length in pieces:
                view = pool[off:off + length]
                while view:
                    view = view[f.write(view):]
    except BrokenPipeError:
        pass


def serve(cmd_in, out) -> None:
    pool = memoryview(b"")
    threads: list[threading.Thread] = []
    results: dict = {}
    kept: dict = {}
    slots: dict = {}

    def reply(msg: dict) -> None:
        out.write(json.dumps(msg).encode() + b"\n")
        out.flush()

    def run_drain(k: int, fd: int, slot, flac: bool) -> None:
        into = slots.get(slot)
        r = drain(fd, into, flac)
        if into is not None:
            kept[k] = memoryview(into)[:r["kept"]]
        del r["kept"]
        results[k] = r

    for line in cmd_in:
        msg = json.loads(line)
        op = msg["op"]
        if op == "pool":
            with open(msg["path"], "rb") as f:
                pool = memoryview(f.read())
        elif op == "reserve":
            slots[msg["slot"]] = bytearray(msg["bytes"])
        elif op == "drain":
            fd = native.load("drain").bench_open(msg["path"].encode())
            reply({"open": min(fd, 0)})
            if fd < 0:
                results[msg["id"]] = {"bytes": 0, "head": "", "status": fd,
                                      "flac": None}
                continue
            t = threading.Thread(target=run_drain, args=(
                msg["id"], fd, msg.get("slot"), bool(msg.get("flac"))),
                daemon=True)
            t.start()
            threads.append(t)
        elif op == "feed":
            t = threading.Thread(target=feed, args=(
                msg["path"], pool, msg["pieces"]), daemon=True)
            t.start()
            threads.append(t)
        elif op == "results":
            for t in threads:
                t.join()
            threads.clear()
            reply(results)
        elif op == "send":
            data = kept.pop(msg["id"], b"")
            out.write(json.dumps({"bytes": len(data)}).encode() + b"\n")
            out.write(data)
            out.flush()
        elif op == "quit":
            break


def main() -> None:
    serve(sys.stdin.buffer, sys.stdout.buffer)


if __name__ == "__main__":
    main()
