"""The streaming server's wire protocol, the benchmark's own copy.

Little-endian, as the server documents it:
  hello     server → client: b'DDSP', uint32 sample_rate, uint32 block_size,
            uint32 flags (bit 0: the session also sends input audio)
  request   client → server: uint32 n, n float32 pitch, n float32 loudness
            [, n float32 audio]
  response  server → client: uint32 n, n float32 audio (n = 0: refused)
  n = 0 from the client ends the session.
"""

from __future__ import annotations

import socket
import struct
from typing import Optional

import numpy as np

MAGIC = b"DDSP"
HELLO_BYTES = 16


def recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


def parse_hello(data: Optional[bytes]):
    """(sample_rate, block_size, needs_audio) of a hello, or raise."""
    if data is None or len(data) != HELLO_BYTES or data[:4] != MAGIC:
        raise ConnectionError("bad server hello")
    sample_rate, block_size, flags = struct.unpack("<III", data[4:])
    return sample_rate, block_size, bool(flags & 1)


def connect(host: str, port: int, timeout: float = 30.0):
    """A connected session socket (TCP_NODELAY) and its hello."""
    sock = socket.create_connection((host, port), timeout=timeout)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    try:
        hello = parse_hello(recv_exact(sock, HELLO_BYTES))
    except (OSError, ConnectionError):
        sock.close()
        raise
    return sock, hello


def request(pitch: np.ndarray, loudness: np.ndarray, audio: Optional[np.ndarray] = None) -> bytes:
    parts = [struct.pack("<I", len(pitch)), np.ascontiguousarray(pitch, "<f4").tobytes(),
             np.ascontiguousarray(loudness, "<f4").tobytes()]
    if audio is not None:
        parts.append(np.ascontiguousarray(audio, "<f4").tobytes())
    return b"".join(parts)


def response_bytes(n: int) -> int:
    """Bytes of a complete response to an n-sample request."""
    return 4 + 4 * n


def parse_response(data: bytes, n: int) -> np.ndarray:
    (m,) = struct.unpack("<I", data[:4])
    if m != n or len(data) != response_bytes(n):
        raise ValueError(f"server answered {m} samples to a request of {n}")
    return np.frombuffer(data[4:], "<f4").astype(np.float32)


def close(sock: socket.socket) -> None:
    try:
        sock.sendall(struct.pack("<I", 0))
    except OSError:
        pass
    sock.close()
