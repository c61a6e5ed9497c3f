"""The port's HTTP client (indextts_tpu_torch/client.py) against the port's
server (runtime/server.py) with a stub engine, on the CPU, as
tests/test_server.py::test_tts_client_blocking_and_stream holds the JAX
client to the JAX server: /tts writes a WAV, /tts/stream writes s16le PCM
with a first byte before the end; `main` in one-shot and --test modes.
The server holds one slot (max_concurrency 1) and answers 429 while it is
taken; a stream releases it only after its last chunk went out, so a test
waits for the slot to be free (`wait_idle`) before the next request."""

import asyncio
import contextlib
import socket
import threading
import time

import numpy as np
import pytest


def stub_engine(text="", **kw):
    sr = 22050
    t = np.linspace(0, 0.2, int(sr * 0.2), endpoint=False)
    return {"audio": (0.1 * np.sin(2 * np.pi * 440 * t)).astype(np.float32),
            "sampling_rate": sr}


def stub_stream(text="", **kw):
    for _ in range(3):
        time.sleep(0.02)
        yield np.zeros(1024, np.float32)


@contextlib.contextmanager
def stub_server(cache_dir, max_concurrency: int = 1):
    """The port's TTSServer over the stub engine on localhost, on an event
    loop in a thread: yields (url, server)."""
    from indextts_tpu_torch.runtime.server import ServerSettings, TTSServer

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    settings = ServerSettings(host="127.0.0.1", port=port, max_concurrency=max_concurrency,
                              cache_dir=str(cache_dir))
    srv = TTSServer(stub_engine, settings, stream_fn=stub_stream)
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    fut = asyncio.run_coroutine_threadsafe(srv.serve(), loop)
    t0 = time.time()
    while not srv.ready:
        assert not fut.done() and time.time() - t0 < 30
        time.sleep(0.02)
    try:
        yield f"http://127.0.0.1:{port}", srv
    finally:
        fut.cancel()
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=10)
        assert not thread.is_alive()
        srv.pool.shutdown(wait=True)


def wait_idle(srv, timeout: float = 10.0) -> None:
    """Wait until no request holds one of the server's slots (the condition
    under which it answers 429), failing after `timeout` seconds. A stream's
    handler writes its last chunk before it lets its slot go, as the JAX
    server's does, so a client can see the end of a stream while the slot
    is still held."""
    t0 = time.time()
    while srv.sem.locked():
        assert time.time() - t0 < timeout, "the server's slot stayed taken"
        time.sleep(0.005)


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    with stub_server(tmp_path_factory.mktemp("cache")) as served:
        yield served


@pytest.fixture(scope="module")
def url(server):
    return server[0]


def test_tts_client_blocking_and_stream(url, tmp_path):
    from indextts_tpu_torch.client import TTSClient

    c = TTSClient(url)
    assert c.healthz() and c.readyz()
    out = c.tts("client blocking test", out_path=str(tmp_path / "b.wav"))
    data = (tmp_path / "b.wav").read_bytes()
    assert data[:4] == b"RIFF" and out["bytes"] == len(data)
    s = c.tts_stream("client stream test", out_path=str(tmp_path / "s.pcm"))
    # 3 chunks of 1024 float zeros -> 3 x 2048 s16le bytes
    assert s["bytes"] == 3 * 2048 == len((tmp_path / "s.pcm").read_bytes())
    assert 0 < s["ttfb_s"] <= s["wall_s"]
    assert not TTSClient("http://127.0.0.1:9").healthz()


def test_client_main(server, tmp_path, capsys):
    from indextts_tpu_torch import client

    url, srv = server
    client.main(["--url", url, "--stream", "-o", str(tmp_path / "m.pcm"), "hello"])
    assert (tmp_path / "m.pcm").stat().st_size == 3 * 2048
    # the stream's slot may still be held after its last chunk arrived
    wait_idle(srv)
    with pytest.raises(SystemExit) as exc:
        client.main(["--url", url, "--test", "-o", str(tmp_path / "m.wav"), "hello"])
    assert exc.value.code == 0
    assert "health: ok" in capsys.readouterr().out
    assert (tmp_path / "m.wav").read_bytes()[:4] == b"RIFF"
