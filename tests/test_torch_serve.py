"""The port's StreamServer on the CPU, on the committed violin bundles: the
checks of tests/test_serve.py:10-54 (protocol roundtrip, per-connection
state, independent noise, bad input) plus deterministic sessions, then the
VoicePool mode and autoencoder sessions (tests/test_serve.py:57-340)."""

import os
import socket
import struct
import time

import numpy as np
import pytest
import torch

from ddsp_pytorch_tpu_torch.serve import MAGIC, StreamClient, StreamServer

BUNDLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "pretrained", "ddsp_violin_bundle")
BLOCK = 512


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (the suite's workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.mark.parametrize("voices", [1, 2])
def test_stop_ends_every_server_thread(voices):
    """stop() ends the acceptor (blocked in accept()), the session threads
    and the pool's dispatcher: no thread of the server outlives it."""
    srv = StreamServer(BUNDLE, port=0, voices=voices, device="cpu", noise_deterministic=True)
    srv.start()
    c = StreamClient(*srv.address)
    c.render(*_controls(1))
    c.close()
    t0 = time.perf_counter()
    srv.stop()
    threads = [srv._acceptor, *srv._threads] + ([srv._dispatcher] if srv._dispatcher is not None else [])
    assert not [t for t in threads if t.is_alive()]
    assert time.perf_counter() - t0 < 2.0  # no join ran into its timeout


def test_voice_pool_not_ported():
    """The VoicePool mode is ported (voices > 1, tests below); what is still
    refused is a server with no voice at all."""
    with pytest.raises(ValueError, match="voices"):
        StreamServer(BUNDLE, port=0, voices=0, device="cpu")


# ------------------------------------------------------- the VoicePool mode
# Mirrors tests/test_serve.py:57-340 on the committed bundles.  Pooled and
# unpooled sessions are compared with deterministic noise at 1e-5 (the same
# arithmetic at batch V and 1, as tests/test_torch_voice_pool.py); with
# noise on, sessions agree up to the quiet noise branch (1e-2, as
# tests/test_serve.py:99).

AE_BUNDLE = os.path.join(os.path.dirname(BUNDLE), "ddsp_violin_ae_bundle")
POOL_ATOL = 1e-5


def _run_clients(address, n_clients, fn):
    """Run fn(client) for n_clients concurrent clients; returns the list of
    their results in order."""
    import threading

    results = {}

    def run(i):
        c = StreamClient(*address)
        try:
            results[i] = fn(c)
        finally:
            c.close()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert sorted(results) == list(range(n_clients)), "a client did not finish"
    return [results[i] for i in range(n_clients)]


def test_stream_server_voice_pool():
    """voices = 2: two concurrent sessions share the batched dispatch; a
    third is closed before the hello; a released slot serves a newcomer
    with fresh state."""
    srv = StreamServer(BUNDLE, port=0, voices=2, device="cpu")
    srv.start()
    try:
        pitch, loud = _controls(2)
        a, b = _run_clients(srv.address, 2, lambda c: [c.render(pitch, loud) for _ in range(3)])
        for blk in a + b:
            assert blk.shape == (2 * BLOCK,) and np.all(np.isfinite(blk))
        np.testing.assert_allclose(a[0], b[0], atol=1e-2)  # fresh slots, pool noise
        assert not np.allclose(a[0], a[1])  # phase carried across requests
        c1, c2 = StreamClient(*srv.address), StreamClient(*srv.address)
        with pytest.raises(ConnectionError, match="hello"):
            StreamClient(*srv.address)
        c2.close()
        c3 = None
        for _ in range(50):  # the server releases the slot after close()
            try:
                c3 = StreamClient(*srv.address)
                break
            except ConnectionError:
                time.sleep(0.1)
        assert c3 is not None, "slot never freed after close()"
        np.testing.assert_allclose(c3.render(pitch, loud), b[0], atol=1e-2)
        c1.close()
        c3.close()
    finally:
        srv.stop()


@pytest.mark.parametrize("bundle", [BUNDLE, AE_BUNDLE], ids=["decoder", "autoencoder"])
def test_pooled_sessions_equal_unpooled(bundle):
    """With deterministic noise, each of 3 concurrent pooled sessions
    streams what a voices = 1 session streams for the same input (for the
    autoencoder: one block late, its first block silent)."""
    n = 2 * BLOCK
    t = np.arange(4 * n) / 48000
    audio_in = (0.4 * np.sin(2 * np.pi * 247.0 * t)).astype(np.float32)
    pitch, loud = np.full(n, 247.0, np.float32), np.full(n, -7.0, np.float32)

    def stream(c):
        assert c.needs_audio == (bundle == AE_BUNDLE)
        extra = (lambda k: (audio_in[k * n:(k + 1) * n],)) if c.needs_audio else (lambda k: ())
        return np.concatenate([c.render(pitch, loud, *extra(k)) for k in range(4)])

    outs = {}
    for voices in (1, 3):
        srv = StreamServer(bundle, port=0, voices=voices, device="cpu", noise_deterministic=True)
        srv.start()
        try:
            outs[voices] = _run_clients(srv.address, voices, stream)
        finally:
            srv.stop()
    want = outs[1][0]
    assert float(np.abs(want).max()) > 1e-3
    if bundle == AE_BUNDLE:
        np.testing.assert_array_equal(want[:BLOCK], 0.0)
    for got in outs[3]:
        np.testing.assert_allclose(got, want, atol=POOL_ATOL)


def test_stream_server_autoencoder_equals_the_library_session():
    """An autoencoder session over the wire equals make_stream_session fed
    the same blocks (the server's per-connection extractor and one block of
    latency), and a decoder-style request without audio is refused by the
    client."""
    from ddsp_pytorch_tpu_torch.export import make_stream_session

    srv = StreamServer(AE_BUNDLE, port=0, device="cpu", noise_deterministic=True)
    srv.start()
    try:
        c = StreamClient(*srv.address)
        assert c.needs_audio and (c.sample_rate, c.block_size) == (48000, BLOCK)
        lib = make_stream_session(AE_BUNDLE, device="cpu", noise_deterministic=True)
        t = np.arange(3 * BLOCK) / 48000
        audio_in = (0.3 * np.sin(2 * np.pi * 330.0 * t)).astype(np.float32)
        pitch, loud = np.full(BLOCK, 330.0, np.float32), np.full(BLOCK, -7.0, np.float32)
        for k in range(3):
            x = audio_in[k * BLOCK:(k + 1) * BLOCK]
            np.testing.assert_array_equal(c.render(pitch, loud, x), lib.step_samples(pitch, loud, x))
        with pytest.raises(ValueError, match="input audio"):
            c.render(pitch, loud)
        c.close()
    finally:
        srv.stop()


def test_pool_slot_release_handshake_on_cancelled_pending():
    """A pooled request abandoned by its session is never dispatched into a
    released-and-reacquired slot: the dispatcher skips it without stepping
    the pool and releases the slot itself (serve.py _Pending)."""
    from ddsp_pytorch_tpu_torch.serve import _Pending

    srv = StreamServer(BUNDLE, port=0, voices=2, device="cpu")
    srv.start()
    try:
        slot = srv._pool.acquire()
        pending = _Pending(slot, np.full((4, 1), 220.0, np.float32), np.zeros((4, 1), np.float32))
        with pending.lock:
            assert not pending.done
            pending.cancelled = True
        state_before = srv._pool._state
        srv._queue.put(pending)
        assert pending.event.wait(10), "dispatcher never finished the item"
        assert isinstance(pending.error, ConnectionError) and pending.audio is None
        assert srv._pool._state is state_before  # the pool was never stepped with it
        s1, s2 = srv._pool.acquire(), srv._pool.acquire()
        assert s1 is not None and s2 is not None and s1 != s2
        assert srv._pool.acquire() is None  # exactly V slots: no double release
        srv._pool.release(s1)
        srv._pool.release(s2)
    finally:
        srv.stop()


def test_oversized_request_rejected_by_pooled_server():
    srv = StreamServer(BUNDLE, port=0, voices=2, device="cpu")
    srv.start()
    try:
        s = socket.create_connection(srv.address)
        assert s.recv(16)[:4] == MAGIC
        s.sendall(struct.pack("<I", (3_000_000 // BLOCK) * BLOCK))
        assert struct.unpack("<I", s.recv(4))[0] == 0
        s.close()
    finally:
        srv.stop()
