"""Realtime streaming server: remote clients drive a GPU-hosted model.

Port of ddsp_pytorch_tpu/serve.py for both model families and both modes.
The wire protocol is the same, byte for byte (little-endian):

  hello:    server → client: magic b'DDSP', uint32 sample_rate,
            uint32 block_size, uint32 flags (bit 0: the session also
            streams input audio — mfcc-autoencoder bundles)
  request:  client → server: uint32 n (samples, multiple of block_size),
            n float32 pitch, n float32 loudness[, n float32 audio when flags
            bit 0 is set]
  response: server → client: uint32 n, n float32 audio
  n == 0 from the client closes the session; the server answers a request
  whose n is not a block multiple, or is over MAX_REQUEST_SAMPLES, with
  n = 0 and closes it.

Autoencoder sessions (flags bit 0): the server runs a causal MFCC extractor
per connection (streaming/mfcc.py StreamingMFCC) over the client's audio
and answers with ONE block of output latency — the first response leads
with a silent block — because MFCC frame 0's reflect pad needs one sample
beyond block 0 (streaming.AutoencoderStreamSession).

voices = 1: one thread per connection, each with its own StreamState (GRU
carry, oscillator phase, and the state of a noise generator seeded with a
per-session counter); all share one StreamingSynth, and a lock serializes
the device dispatch only, not the device→host pull.  voices = V > 1: the
VoicePool mode (streaming/pool.py): sessions own slots of one batch-V
state, and a dispatcher thread coalesces their pending requests into
single batched dispatches; noise comes from the pool's one generator, and
a connection beyond V is closed before the hello.

Run:  python -m ddsp_pytorch_tpu_torch.serve --bundle pretrained/ddsp_violin_bundle [--voices 64]
"""

from __future__ import annotations

import os
import queue
import socket
import struct
import threading
from typing import Optional

import numpy as np

MAGIC = b"DDSP"
# Largest request accepted (samples): 10 s at 192 kHz.  It bounds the buffer
# a client can make the server allocate per request.
MAX_REQUEST_SAMPLES = 1_920_000
# A pooled session's longest wait for its batched dispatch (s).  A dispatch
# takes milliseconds once _warmup has run its shapes; the bound only keeps a
# session from hanging on a dispatcher that has died.
DISPATCH_TIMEOUT_S = 30.0


def _recv_exact(conn: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


class _Pending:
    """A session's pooled request waiting for its dispatch (serve.py:59-85).

    Slot-release handshake: a session that gives up on a request (wait
    timeout, connection teardown) must NOT release its pool slot while the
    request can still be dispatched — the dispatcher would advance a
    re-acquired slot with the dead session's controls.  `lock` guards one
    exchange: the session sets `cancelled` if `done` is not yet set, handing
    the release to the dispatcher; the dispatcher sets `done` when it has
    finished (or skipped) the item and releases the slot iff it saw
    `cancelled`."""

    __slots__ = ("slot", "f0", "loud", "mfcc", "event", "audio", "error",
                 "lock", "done", "cancelled")

    def __init__(self, slot, f0, loud, mfcc=None):
        self.slot = slot
        self.f0 = f0
        self.loud = loud
        self.mfcc = mfcc
        self.event = threading.Event()
        self.audio = None
        self.error = None
        self.lock = threading.Lock()
        self.done = False
        self.cancelled = False


class StreamServer:
    """voices = 1 (default): one StreamState per connection, each request
    its own batch-1 dispatch.  voices = V > 1: the VoicePool mode, sessions
    own slots of one batch-V state and a dispatcher thread coalesces their
    requests into batched dispatches (module docstring)."""

    def __init__(
        self,
        bundle_dir: str,
        host: str = "127.0.0.1",
        port: int = 0,
        voices: int = 1,
        device="cuda",
        noise_deterministic: bool = False,
    ):
        from ddsp_pytorch_tpu_torch.config import Config
        from ddsp_pytorch_tpu_torch.export import make_streaming_synth

        voices = int(voices)
        if voices < 1:
            raise ValueError(f"voices must be at least 1, got {voices}")
        self._bundle_dir = bundle_dir
        cfg = Config.from_yaml(os.path.join(bundle_dir, "config.yaml"))
        self._needs_audio = cfg.model.name == "mfcc-autoencoder"
        self._n_mfcc = cfg.preprocess.n_mfcc
        self._synth = make_streaming_synth(
            bundle_dir, batch=voices, device=device, noise_deterministic=noise_deterministic
        )
        self.sample_rate = self._synth.sample_rate
        self.block_size = self._synth.block_size

        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(8)
        self.address = self._sock.getsockname()
        self._stop = threading.Event()
        self._threads = []
        self._conns = set()  # live session sockets (closed by stop())
        self._lock = threading.Lock()  # serializes the voices = 1 dispatch
        self._session_seed = 0
        self._acceptor = None

        self._pool = None
        self._dispatcher = None
        if voices > 1:
            from ddsp_pytorch_tpu_torch.streaming.pool import VoicePool

            self._pool = VoicePool(self._synth)
            self._queue = queue.Queue()
            self._warmup()
            self._dispatcher = threading.Thread(target=self._dispatch_loop, daemon=True)
            self._dispatcher.start()

    def _warmup(self) -> None:
        """Run the pooled step at the wire's shapes before accepting
        connections (serve.py:148-170), so no session waits on first-use
        work (cuBLAS handles, cuFFT plans, the kernels' build) inside a
        request.  Decoder sessions dispatch one frame a block (F = 1);
        autoencoder sessions also dispatch F = 2 once, at block 1, which
        releases MFCC frames 0 and 1 together."""
        slot = self._pool.acquire()
        try:
            for f in (1, 2) if self._needs_audio else (1,):
                f0 = np.full((f, 1), 100.0, np.float32)
                loud = np.zeros((f, 1), np.float32)
                req = (f0, loud)
                if self._needs_audio:
                    req = (f0, loud, np.zeros((f, self._n_mfcc), np.float32))
                self._pool.step({slot: req})
        finally:
            self._pool.release(slot)

    # ------------------------------------------------------------ session
    def _pool_wait(self, pending: _Pending, inflight: list) -> np.ndarray:
        """Enqueue a pooled request and wait for its batched dispatch.

        `inflight` is the session's one-element cell: it holds the pending
        while the dispatcher may still touch it, so the session's teardown
        can hand the slot's release over (_Pending)."""
        inflight[0] = pending
        self._queue.put(pending)
        if not pending.event.wait(timeout=DISPATCH_TIMEOUT_S):
            raise TimeoutError("pooled dispatch timed out")
        if pending.error is not None:
            raise RuntimeError(f"pooled dispatch failed: {pending.error!r}")
        inflight[0] = None
        return pending.audio

    def _locked_step(self, state, f0, loud, mfcc=None):
        """One batch-1 dispatch under the lock; the device→host pull of its
        audio runs unlocked, so concurrent sessions overlap their pulls."""
        with self._lock:
            audio, state = self._synth.step_stateless(state, f0, loud, mfcc_frames=mfcc)
        return audio[0].cpu().numpy(), state

    def _serve_conn(self, conn: socket.socket) -> None:
        slot = None
        inflight = [None]  # the in-flight _Pending (slot-release handshake)
        try:
            if self._pool is not None:
                slot = self._pool.acquire()
                if slot is None:  # pool full: close without a hello
                    return
            conn.sendall(MAGIC + struct.pack("<III", self.sample_rate, self.block_size,
                                             1 if self._needs_audio else 0))
            if self._pool is None:
                with self._lock:
                    # a distinct seed per session: concurrent streams must
                    # not share one noise stream.  A pool's noise is the
                    # pool's (streaming/pool.py).
                    seed = self._session_seed
                    self._session_seed += 1
            session = state = None
            if self._needs_audio:
                from ddsp_pytorch_tpu_torch.export import make_streaming_mfcc
                from ddsp_pytorch_tpu_torch.streaming import AutoencoderStreamSession

                if self._pool is None:
                    cell = [self._synth.fresh_state(seed=seed)]

                    def step_fn(f0, loud, mfcc):
                        audio, cell[0] = self._locked_step(cell[0], f0[None], loud[None], mfcc[None])
                        return audio

                else:
                    def step_fn(f0, loud, mfcc):
                        return self._pool_wait(_Pending(slot, f0, loud, mfcc), inflight)

                session = AutoencoderStreamSession(
                    self._synth, make_streaming_mfcc(self._bundle_dir), step_fn=step_fn
                )
            elif self._pool is None:
                state = self._synth.fresh_state(seed=seed)
            n_ch = 3 if self._needs_audio else 2
            while not self._stop.is_set():
                head = _recv_exact(conn, 4)
                if head is None:
                    return
                (n,) = struct.unpack("<I", head)
                if n == 0:
                    return
                if n % self.block_size != 0 or n > MAX_REQUEST_SAMPLES:
                    # n is a raw uint32 off the wire: refuse before
                    # allocating or receiving its payload
                    conn.sendall(struct.pack("<I", 0))
                    return
                payload = _recv_exact(conn, 4 * n_ch * n)
                if payload is None:
                    return
                data = np.frombuffer(payload, np.float32)
                pitch, loud = data[:n], data[n : 2 * n]
                try:
                    if session is not None:
                        audio = session.step_samples(pitch, loud, data[2 * n :])
                    elif self._pool is not None:
                        audio = self._pool_wait(
                            _Pending(slot, pitch[:: self.block_size, None],
                                     loud[:: self.block_size, None]),
                            inflight,
                        )
                    else:
                        audio, state = self._locked_step(
                            state, pitch[None, :: self.block_size, None],
                            loud[None, :: self.block_size, None],
                        )
                except (TimeoutError, RuntimeError):
                    # a pooled dispatch failed or timed out: close the
                    # session (the handshake below keeps the slot safe
                    # until the dispatcher is done with it)
                    if self._pool is None:
                        raise
                    return
                conn.sendall(struct.pack("<I", n) + audio.astype(np.float32).tobytes())
        finally:
            if slot is not None:
                release = True
                pending = inflight[0]
                if pending is not None:
                    with pending.lock:
                        if not pending.done:
                            # the dispatcher still owns the request: it
                            # releases the slot when it is done with it
                            pending.cancelled = True
                            release = False
                if release:
                    self._pool.release(slot)
            self._conns.discard(conn)
            conn.close()

    def _finish(self, item: _Pending, audio=None, error=None) -> None:
        """Complete a pooled request: publish the result, wake the session,
        and release its slot iff the session abandoned it (the dispatcher's
        half of the _Pending handshake)."""
        item.audio = audio
        item.error = error
        with item.lock:
            item.done = True
            release = item.cancelled
        item.event.set()
        if release:
            self._pool.release(item.slot)

    def _dispatch_loop(self) -> None:
        """Coalesce pending pooled requests into batched dispatches
        (serve.py:337-393).  Each round: wait for one request, drain what
        else is queued, group by frame count (one dispatch a group), answer
        every session.  A second request of one slot in a round (a
        pipelining client) waits for the next round."""
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            while True:
                try:
                    batch.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            groups, deferred = {}, []
            for item in batch:
                with item.lock:
                    cancelled = item.cancelled
                if cancelled:  # the session left before its dispatch: never step it
                    self._finish(item, error=ConnectionError("session cancelled"))
                    continue
                group = groups.setdefault(item.f0.shape[0], {})
                if item.slot in group:
                    deferred.append(item)
                else:
                    group[item.slot] = item
            for item in deferred:
                self._queue.put(item)
            for items in groups.values():
                requests = {
                    s: (it.f0, it.loud) if it.mfcc is None else (it.f0, it.loud, it.mfcc)
                    for s, it in items.items()
                }
                try:
                    outs = self._pool.step(requests)
                except Exception as e:  # a boundary that must keep serving: hand it to the sessions
                    for it in items.values():
                        self._finish(it, error=e)
                    continue
                for s, it in items.items():
                    self._finish(it, audio=outs[s])

    # ------------------------------------------------------------ control
    def serve_forever(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            self._conns.add(conn)
            t = threading.Thread(target=self._serve_conn, args=(conn,), daemon=True)
            t.start()
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    def start(self) -> None:
        self._acceptor = threading.Thread(target=self.serve_forever, daemon=True)
        self._acceptor.start()

    def stop(self) -> None:
        self._stop.set()
        # shutdown wakes the acceptor blocked in accept(); close alone does
        # not on Linux, and the acceptor would outlive the server
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        # unblock sessions parked in recv(): _stop is only checked between
        # requests
        for conn in list(self._conns):
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=2)
        if self._acceptor is not None:
            self._acceptor.join(timeout=2)
        if self._dispatcher is not None:
            self._dispatcher.join(timeout=2)


class StreamClient:
    """Minimal client for the protocol above."""

    def __init__(self, host: str, port: int):
        self._sock = socket.create_connection((host, port))
        hello = _recv_exact(self._sock, 4 + 12)
        if hello is None or hello[:4] != MAGIC:
            self._sock.close()
            raise ConnectionError("bad server hello")
        self.sample_rate, self.block_size, flags = struct.unpack("<III", hello[4:])
        self.needs_audio = bool(flags & 1)

    def render(self, pitch: np.ndarray, loudness: np.ndarray,
               audio: Optional[np.ndarray] = None) -> np.ndarray:
        """(n,) sample-rate pitch and loudness (and, in an autoencoder
        session, n samples of input audio) → (n,) audio."""
        pitch = np.ascontiguousarray(pitch, np.float32)
        loudness = np.ascontiguousarray(loudness, np.float32)
        n = len(pitch)
        if len(loudness) != n:
            raise ValueError("pitch and loudness must have the same length")
        payload = pitch.tobytes() + loudness.tobytes()
        if self.needs_audio:
            if audio is None or len(audio) != n:
                raise ValueError("autoencoder session: pass n samples of input audio")
            payload += np.ascontiguousarray(audio, np.float32).tobytes()
        elif audio is not None:
            raise ValueError("this session takes no input audio (a decoder bundle)")
        self._sock.sendall(struct.pack("<I", n) + payload)
        head = _recv_exact(self._sock, 4)
        if head is None:
            raise ConnectionError("server closed the session")
        (m,) = struct.unpack("<I", head)
        if m != n:
            raise ValueError(f"server rejected request (n={n} % block != 0?)")
        payload = _recv_exact(self._sock, 4 * n)
        if payload is None:
            raise ConnectionError("server closed the session")
        return np.frombuffer(payload, np.float32).copy()

    def close(self) -> None:
        try:
            self._sock.sendall(struct.pack("<I", 0))
        except OSError:
            pass
        self._sock.close()


def main():
    import argparse

    p = argparse.ArgumentParser(description="Serve an exported bundle for realtime streaming.")
    p.add_argument("--bundle", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7770)
    p.add_argument("--voices", type=int, default=1,
                   help=">1: the VoicePool mode, up to N concurrent sessions batched "
                        "into single device dispatches")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args()

    server = StreamServer(args.bundle, args.host, args.port, voices=args.voices,
                          device=args.device)
    print(
        f"serving {args.bundle} on {server.address} "
        f"(sr={server.sample_rate}, block={server.block_size}, voices={args.voices}, "
        f"device={args.device})"
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
