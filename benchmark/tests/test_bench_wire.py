"""The benchmark's copy of the wire protocol against the port's
StreamServer on the CPU: its bytes are the port client's, its replies
parse to the port client's audio, and a refused request reads as refused."""

import os
import socket
import struct

import numpy as np
import pytest
import torch

from benchmark.lib import traffic, wire
from benchmark.lib.weights import make_weights, write_bundle
from benchmark.tests.tiny import tiny_cfg


@pytest.fixture(scope="module", params=["single-inst-decoder", "mfcc-autoencoder"])
def server(request, tmp_path_factory):
    from ddsp_pytorch_tpu_torch.serve import StreamServer

    cfg = tiny_cfg(request.param)
    bundle = write_bundle(cfg, make_weights(cfg, 1, torch.device("cpu")), -30.0, 8.0,
                          str(tmp_path_factory.mktemp("b") / "bundle"))
    srv = StreamServer(bundle, device="cpu", noise_deterministic=True)
    srv.start()
    yield srv, cfg
    srv.stop()


def test_request_bytes_are_the_port_clients(server):
    from ddsp_pytorch_tpu_torch.serve import StreamClient

    srv, cfg = server
    needs_audio = cfg["model"]["name"] == "mfcc-autoencoder"
    s = traffic.sessions(5, 1, 0.016)[0]
    blk = traffic.block(s, 3, 256, 16000, 64.0, needs_audio)
    client = StreamClient(*srv.address)
    # the port client's bytes, captured on a socket pair
    a, b = socket.socketpair()
    client._sock, keep = a, client._sock
    b.sendall(struct.pack("<I", 256) + np.zeros(256, "<f4").tobytes())
    client.render(*blk)
    port_bytes = b.recv(1 << 20)
    a.close(), b.close()
    client._sock = keep
    client.close()
    assert wire.request(*blk) == port_bytes


def test_replies_match_the_port_client_and_refusals_read_as_refused(server):
    from ddsp_pytorch_tpu_torch.serve import StreamClient

    srv, cfg = server
    needs_audio = cfg["model"]["name"] == "mfcc-autoencoder"
    s = traffic.sessions(6, 1, 0.016)[0]
    blocks = [traffic.block(s, i, 256, 16000, 64.0, needs_audio) for i in range(4)]
    port = StreamClient(*srv.address)
    want = [port.render(*blk) for blk in blocks]
    port.close()
    sock, hello = wire.connect(*srv.address)
    assert hello == (16000, 256, needs_audio)
    got = []
    for blk in blocks:
        sock.sendall(wire.request(*blk))
        got.append(wire.parse_response(wire.recv_exact(sock, wire.response_bytes(256)), 256))
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    sock.sendall(struct.pack("<I", 100) + np.zeros(200 + (100 if needs_audio else 0), "<f4").tobytes())
    refusal = wire.recv_exact(sock, 4)
    assert struct.unpack("<I", refusal) == (0,)
    with pytest.raises(ValueError):
        wire.parse_response(refusal + np.zeros(256, "<f4").tobytes(), 256)
    sock.close()
