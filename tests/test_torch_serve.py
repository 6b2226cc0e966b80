"""The port's StreamServer on the CPU, on the committed violin bundle: the
checks of tests/test_serve.py:10-54 (protocol roundtrip, per-connection
state, independent noise, bad input) plus deterministic sessions."""

import os
import socket
import struct

import numpy as np
import pytest

from ddsp_pytorch_tpu_torch.serve import MAGIC, StreamClient, StreamServer

BUNDLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "pretrained", "ddsp_violin_bundle")
BLOCK = 512


@pytest.fixture(scope="module")
def server():
    srv = StreamServer(BUNDLE, port=0, device="cpu")
    srv.start()
    yield srv
    srv.stop()


def _controls(n_blocks):
    n = n_blocks * BLOCK
    return np.full(n, 440.0, np.float32), np.full(n, -7.5, np.float32)


def test_roundtrip_state_and_independent_noise(server):
    host, port = server.address
    client = StreamClient(host, port)
    assert (client.sample_rate, client.block_size) == (48000, BLOCK)
    assert not client.needs_audio
    pitch, loud = _controls(4)
    a1 = client.render(pitch, loud)
    a2 = client.render(pitch, loud)
    assert a1.shape == (4 * BLOCK,) and np.all(np.isfinite(a1))
    assert float(np.abs(a1).max()) > 1e-3
    assert not np.allclose(a1, a2)  # phase and GRU carried across requests
    client2 = StreamClient(host, port)
    b1 = client2.render(pitch, loud)
    np.testing.assert_allclose(b1, a1, atol=1e-2)  # fresh phase
    assert not np.array_equal(b1, a1)  # per-session noise stream
    client.close()
    client2.close()


def test_bad_request_size_rejected(server):
    client = StreamClient(*server.address)
    with pytest.raises(ValueError):
        client.render(np.zeros(100, np.float32), np.zeros(100, np.float32))
    client.close()


def test_oversized_request_rejected(server):
    s = socket.create_connection(server.address)
    assert s.recv(16)[:4] == MAGIC
    s.sendall(struct.pack("<I", (3_000_000 // BLOCK) * BLOCK))
    assert struct.unpack("<I", s.recv(4))[0] == 0
    s.close()


def test_deterministic_sessions_repeat():
    srv = StreamServer(BUNDLE, port=0, device="cpu", noise_deterministic=True)
    srv.start()
    try:
        pitch, loud = _controls(1)
        c1 = StreamClient(*srv.address)
        first = c1.render(pitch, loud)
        c2 = StreamClient(*srv.address)
        np.testing.assert_array_equal(c2.render(pitch, loud), first)
        c1.close()
        c2.close()
    finally:
        srv.stop()


def test_voice_pool_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        StreamServer(BUNDLE, port=0, voices=2, device="cpu")
