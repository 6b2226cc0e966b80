"""Realtime streaming server: remote clients drive a GPU-hosted model.

Port of ddsp_pytorch_tpu/serve.py for decoder bundles with voices=1.  The
wire protocol is the same, byte for byte (little-endian):

  hello:    server → client: magic b'DDSP', uint32 sample_rate,
            uint32 block_size, uint32 flags (bit 0: session also streams
            input audio — mfcc-autoencoder bundles, not ported yet, so 0)
  request:  client → server: uint32 n (samples, multiple of block_size),
            n float32 pitch, n float32 loudness
  response: server → client: uint32 n, n float32 audio
  n == 0 from the client closes the session; the server answers a request
  whose n is not a block multiple, or is over MAX_REQUEST_SAMPLES, with
  n = 0 and closes it.

One thread per connection.  Each connection holds its own StreamState
(GRU carry, oscillator phase, noise generator seeded with a per-session
counter); all share one StreamingSynth, and a lock serializes the device
dispatch.

Run:  python -m ddsp_pytorch_tpu_torch.serve --bundle pretrained/ddsp_violin_bundle
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Optional

import numpy as np

MAGIC = b"DDSP"
# Largest request accepted (samples): 10 s at 192 kHz.  It bounds the buffer
# a client can make the server allocate per request.
MAX_REQUEST_SAMPLES = 1_920_000


def _recv_exact(conn: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


class StreamServer:
    """Serve one bundle: one StreamState per connection, each request its
    own batch-1 dispatch.  voices > 1 (the JAX package's VoicePool mode) is
    not ported yet."""

    def __init__(
        self,
        bundle_dir: str,
        host: str = "127.0.0.1",
        port: int = 0,
        voices: int = 1,
        device="cuda",
        noise_deterministic: bool = False,
    ):
        if voices != 1:
            raise NotImplementedError(
                "voices > 1 needs the VoicePool, not ported yet (see ROADMAP.md §1)"
            )
        from ddsp_pytorch_tpu_torch.export import make_streaming_synth

        self._synth = make_streaming_synth(
            bundle_dir, batch=1, device=device, noise_deterministic=noise_deterministic
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
        self._lock = threading.Lock()  # serializes device dispatch
        self._session_seed = 0
        self._acceptor = None

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            conn.sendall(MAGIC + struct.pack("<III", self.sample_rate, self.block_size, 0))
            with self._lock:
                # distinct seed per session: concurrent streams must not
                # share one noise stream
                seed = self._session_seed
                self._session_seed += 1
                state = self._synth.fresh_state(seed=seed)
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
                payload = _recv_exact(conn, 8 * n)
                if payload is None:
                    return
                data = np.frombuffer(payload, np.float32)
                f0 = data[None, : n : self.block_size, None]
                loud = data[None, n :: self.block_size, None]
                with self._lock:
                    audio_dev, state = self._synth.step_stateless(state, f0, loud)
                audio = audio_dev[0].cpu().numpy()
                conn.sendall(struct.pack("<I", n) + audio.astype(np.float32).tobytes())
        finally:
            self._conns.discard(conn)
            conn.close()

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

    def render(self, pitch: np.ndarray, loudness: np.ndarray) -> np.ndarray:
        """(n,) sample-rate pitch and loudness → (n,) audio."""
        if self.needs_audio:
            raise NotImplementedError("autoencoder sessions are not ported yet")
        pitch = np.ascontiguousarray(pitch, np.float32)
        loudness = np.ascontiguousarray(loudness, np.float32)
        n = len(pitch)
        if len(loudness) != n:
            raise ValueError("pitch and loudness must have the same length")
        self._sock.sendall(struct.pack("<I", n) + pitch.tobytes() + loudness.tobytes())
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
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args()

    server = StreamServer(args.bundle, args.host, args.port, device=args.device)
    print(
        f"serving {args.bundle} on {server.address} "
        f"(sr={server.sample_rate}, block={server.block_size}, device={args.device})"
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
