"""Port serving daemon (nelegan_tpu_torch.cli.serve) on the CPU: protocol,
dynamic batching, parity with the single-utterance path, and wire
compatibility with the JAX package's client."""
import socket
import struct
import threading

import numpy as np
import pytest
import torch

from nelegan_tpu_torch import pipeline
from nelegan_tpu_torch.cli.serve import (MAGIC, VERSION, EnhanceServer,
                                         _send_f32, enhance_remote)
from nelegan_tpu_torch.models.generator import Generator


@pytest.fixture(scope="module")
def speech(goldens):
    g = goldens("features")
    return g["clean"].astype(np.float32), g["noise"].astype(np.float32)


@pytest.fixture(scope="module")
def server():
    torch.manual_seed(0)
    srv = EnhanceServer(Generator(hidden=32, n_blocks=3), batch_size=4,
                        max_wait_ms=50.0, device="cpu")
    ready = threading.Event()
    t = threading.Thread(target=srv.serve, args=("127.0.0.1", 0, ready),
                         daemon=True)
    t.start()
    assert ready.wait(timeout=60), "server did not come up"
    yield srv
    srv.stop()
    t.join(timeout=10)
    assert not t.is_alive()


def test_serve_matches_enhance_utterance(server, speech):
    clean, noise = speech
    got = enhance_remote(*server.address, clean, noise, timeout=120.0)
    assert got.shape == (256 * (clean.size // 256),)
    with torch.no_grad():
        want = pipeline.enhance_utterance(server.generator, clean, noise,
                                          device="cpu").numpy()
    assert want.shape == got.shape
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    assert abs(float(np.sqrt(np.mean(got.astype(np.float64) ** 2))) - 0.03) \
        < 1e-6


def test_serve_batches_concurrent_requests(server, speech):
    clean, noise = speech
    scales = [0.8, 0.9, 1.0, 1.1]
    before = dict(server.stats)
    results = [None] * len(scales)

    def one(i):
        results[i] = enhance_remote(*server.address, clean * scales[i],
                                    noise, timeout=120.0)

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(scales))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert all(r is not None and r.size == 256 * (clean.size // 256)
               for r in results)
    served = server.stats["requests"] - before["requests"]
    batches = server.stats["batches"] - before["batches"]
    assert served == len(scales)
    assert batches < len(scales)   # one 50 ms window coalesces them
    assert np.abs(results[0] - results[3]).max() > 0


def test_serve_rejects_bad_magic(server):
    with socket.create_connection(server.address, timeout=30) as s:
        s.sendall(b"XXXX\x01")
        (code,) = struct.unpack("<I", s.recv(4))
        assert code == 0xFFFFFFFF


def test_serve_rejects_empty_signal(server):
    with socket.create_connection(server.address, timeout=30) as s:
        s.sendall(MAGIC + struct.pack("<B", VERSION))
        _send_f32(s, np.zeros(0, np.float32))
        _send_f32(s, np.zeros(16, np.float32))
        (code,) = struct.unpack("<I", s.recv(4))
        assert code == 0xFFFFFFFF


def test_jax_client_talks_to_port_server(server, speech):
    """The JAX package's client gets the same reply as the port's client:
    the wire protocol is the same byte for byte."""
    from nelegan_tpu.cli.serve import enhance_remote as jax_enhance_remote
    clean, noise = speech
    a = jax_enhance_remote(*server.address, clean[:9000], noise[:9000],
                           timeout=120.0)
    b = enhance_remote(*server.address, clean[:9000], noise[:9000],
                       timeout=120.0)
    assert a.shape == (256 * (9000 // 256),)
    np.testing.assert_array_equal(a, b)
