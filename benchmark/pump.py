"""The harness's I/O child: it drains every output a conversion writes
into a FIFO and feeds raw DSD into the FIFOs a conversion reads as its
stdin, so that no output reaches a regular file and the conversion's
process spends nothing on either end of its pipes.

Commands come as JSON lines on stdin; replies go as JSON lines on
stdout, a kept output's bytes right after its reply line:

    {"op": "pool", "path": P}                 load the raw segment pool
    {"op": "reserve", "slot": S, "bytes": N}
        allocate (and touch) N bytes to keep one output in, before the
        window, so that keeping it costs the window no page faults
    {"op": "drain", "id": K, "path": P, "slot": S or null}
        read FIFO P to its end in a thread; count its bytes, keep its
        first HEAD bytes and, into slot S, all of it
    {"op": "feed", "path": P, "pieces": [[offset, length], ...]}
        write those slices of the pool into FIFO P, then close it
    {"op": "results"}   wait for every thread; reply {"K": [bytes, head hex]}
    {"op": "send", "id": K}   reply {"bytes": n}, then the bytes kept
    {"op": "quit"}
"""

from __future__ import annotations

import fcntl
import json
import sys
import threading

HEAD = 4096
CHUNK = 1 << 20
F_SETPIPE_SZ = 1031


def widen(fd: int) -> None:
    """Give the pipe a 1 MiB buffer where the system allows it."""
    try:
        fcntl.fcntl(fd, F_SETPIPE_SZ, CHUNK)
    except OSError:
        pass


def drain(path: str, into: bytearray | None) -> tuple[int, bytes]:
    """(bytes read, the first HEAD bytes); with `into`, the stream is read
    straight into it (what does not fit is counted, not kept)."""
    scratch = memoryview(bytearray(CHUNK))
    keep = memoryview(into) if into is not None else None
    head = bytearray()
    total = 0
    with open(path, "rb", buffering=0) as f:
        widen(f.fileno())
        while True:
            if keep is not None and total < len(keep):
                view = keep[total:total + CHUNK]
            else:
                view = scratch
            n = f.readinto(view)
            if not n:
                break
            if len(head) < HEAD:
                head += view[:min(n, HEAD - len(head))]
            total += n
    return total, bytes(head)


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

    def run_drain(k: int, path: str, slot) -> None:
        try:
            into = slots.get(slot)
            total, head = drain(path, into)
            results[k] = [total, head.hex()]
            if into is not None:
                kept[k] = memoryview(into)[:min(total, len(into))]
        except OSError as e:
            results[k] = [-1, str(e)]

    for line in cmd_in:
        msg = json.loads(line)
        op = msg["op"]
        if op == "pool":
            with open(msg["path"], "rb") as f:
                pool = memoryview(f.read())
        elif op == "reserve":
            slots[msg["slot"]] = bytearray(msg["bytes"])
        elif op == "drain":
            t = threading.Thread(target=run_drain, args=(
                msg["id"], msg["path"], msg.get("slot")), daemon=True)
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
            out.write(json.dumps(results).encode() + b"\n")
            out.flush()
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
