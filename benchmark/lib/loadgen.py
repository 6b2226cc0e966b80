"""Paced streaming clients, run in a process of their own.

    python -m benchmark.lib.loadgen      (from the checkout's root)

Reads one JSON line on stdin (server address, the sessions, the period,
the window), connects every session, prints "ready", then waits for a line
"go <t0>" giving the window's start on the system's monotonic clock, which
every process shares.  Session s sends block i when it is due, at
t0 + offset_s + i·period, keeping one request outstanding as an audio
client does: a late reply sends the next block at once, still timed from
its due time.  Blocks due at or after the window's close are not sent;
replies outstanding then are awaited up to `drain_s` more.  Then every
session is closed and the results go to stdout as one .npz: per session
the due, send and arrival times of its blocks (NaN where no reply came)
and, for the sessions in `keep_audio`, the audio it received.
"""

from __future__ import annotations

import heapq
import io
import json
import selectors
import socket
import sys
import time

import numpy as np

from benchmark.lib import traffic, wire

SPIN_S = 1.5e-3  # the last stretch before a send is spun, not slept (epoll waits in ms)


class _Client:
    def __init__(self, session: traffic.Session, sock: socket.socket, keep: bool):
        self.session = session
        self.sock = sock
        self.keep = keep
        self.next = 0  # next block to send
        self.outstanding = False
        self.buf = bytearray()
        self.due, self.sent, self.arrived, self.audio = [], [], [], []
        self.broken = False


def run(cfg: dict, stdin, stdout) -> None:
    period, block = cfg["period_s"], cfg["block_size"]
    sample_rate, needs_audio = cfg["sample_rate"], cfg["needs_audio"]
    glide_s, seconds, drain_s = cfg["glide_s"], cfg["seconds"], cfg["drain_s"]
    keep = set(cfg["keep_audio"])
    reply = wire.response_bytes(block)
    clients = []
    for d in cfg["sessions"]:
        s = traffic.Session(**d)
        sock, (sr, bs, audio_flag) = wire.connect(cfg["host"], cfg["port"])
        if (sr, bs, audio_flag) != (sample_rate, block, needs_audio):
            raise ConnectionError(f"hello {sr, bs, audio_flag} is not the cell's")
        sock.setblocking(False)
        clients.append(_Client(s, sock, s.index in keep))
    stdout.write("ready\n")
    stdout.flush()
    t0 = float(stdin.readline().split()[1])
    t_end = t0 + seconds
    sel = selectors.DefaultSelector()
    heap = []
    for c in clients:
        sel.register(c.sock, selectors.EVENT_READ, c)
        heapq.heappush(heap, (t0 + c.session.offset_s, c.session.index, c))

    def send(c, now):
        due = t0 + c.session.offset_s + c.next * period
        payload = wire.request(*traffic.block(c.session, c.next, block, sample_rate, glide_s,
                                              needs_audio))
        c.sock.setblocking(True)
        try:
            c.sock.sendall(payload)
        except OSError:
            c.broken = True
            return
        finally:
            c.sock.setblocking(False)
        c.due.append(due)
        c.sent.append(now)
        c.arrived.append(float("nan"))
        c.outstanding = True
        c.next += 1

    def schedule(c):
        due = t0 + c.session.offset_s + c.next * period
        if due < t_end and not c.broken:
            heapq.heappush(heap, (due, c.session.index, c))

    deadline = t_end + drain_s
    while True:
        now = time.monotonic()
        while heap and heap[0][0] <= now:
            _, _, c = heapq.heappop(heap)
            send(c, now)
            now = time.monotonic()
        if not heap and (now >= deadline or not any(c.outstanding for c in clients)):
            break
        wait = (heap[0][0] if heap else deadline) - now
        timeout = 0.0 if wait < SPIN_S else max(0.0, wait - SPIN_S)
        for key, _ in sel.select(timeout):
            c = key.data
            try:
                chunk = c.sock.recv(reply - len(c.buf))
            except BlockingIOError:
                continue
            except OSError:
                chunk = b""
            if not chunk:
                sel.unregister(c.sock)
                c.broken, c.outstanding = True, False
                continue
            c.buf += chunk
            if len(c.buf) == reply:
                c.arrived[-1] = time.monotonic()
                audio = wire.parse_response(bytes(c.buf), block)
                if c.keep:
                    c.audio.append(audio)
                c.buf.clear()
                c.outstanding = False
                schedule(c)
    for c in clients:
        c.sock.setblocking(True)
        wire.close(c.sock)
    out = {}
    for c in clients:
        i = c.session.index
        out[f"due_{i}"] = np.asarray(c.due, np.float64)
        out[f"sent_{i}"] = np.asarray(c.sent, np.float64)
        out[f"arrived_{i}"] = np.asarray(c.arrived, np.float64)
        if c.keep:
            out[f"audio_{i}"] = (np.stack(c.audio) if c.audio else np.zeros((0, block), np.float32))
    buf = io.BytesIO()
    np.savez(buf, **out)
    stdout.buffer.write(buf.getvalue())
    stdout.flush()


if __name__ == "__main__":
    run(json.loads(sys.stdin.readline()), sys.stdin, sys.stdout)
