"""The port's sequential tail overlap and streaming, on the CPU.

* The pipelined route (segment k's tail beside segment k+1's decode) gives
  the inline route's bits, through infer() and infer_generator(); the
  stream is infer()'s audio and one trailing silence
  (tests/test_engine_e2e.py:341).
* A decode error in the producer raises in the caller; a generator closed
  after its first chunk returns while a tail still runs, and the tails not
  started never run.
* The keyed generator equals infer(); infer_generator_continuous equals
  the sequential generator.
* fallback_segments(quick=) splits as the JAX server does.
* POST /tts/stream answers 200 with chunked PCM equal to /tts's, and a
  client that leaves mid-stream strands no thread and blocks no request.
"""

import dataclasses
import http.client
import io
import json
import logging
import socket
import threading
import time
import wave

import numpy as np
import pytest
import torch

from indextts_tpu_torch.weights import from_jax_params
from torch_parity import parity_config, parity_params, speech_like, to_port_config

torch.set_num_threads(2)

SR = 22050


def _segments(seed, lens=(5, 7, 4)):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, 50, n) for n in lens]


@pytest.fixture(scope="module")
def engine():
    """The tiny config, sampling (seeded), one beam."""
    from indextts_tpu_torch.runtime.engine import IndexTTS2Engine

    cfg = parity_config(do_sample=True)
    pcfg = to_port_config(cfg)
    return IndexTTS2Engine(pcfg, from_jax_params(parity_params(cfg, seed=1), pcfg),
                           device="cpu")


def _overlap(engine, on: bool):
    rt = dataclasses.replace(engine.cfg.runtime, seq_tail_overlap=on)
    return dataclasses.replace(engine.cfg, runtime=rt)


@pytest.fixture
def prompt():
    return speech_like(np.random.default_rng(3), 1.0, 16000), 16000


def test_pipelined_route_is_bit_equal_to_inline(engine, prompt, monkeypatch):
    """Three segments, one seed: the pipelined route (on unless
    seq_tail_overlap is off or TARS_STAGE_SYNC=1) and the inline route give
    the same audio and chunks."""
    segs = _segments(11)
    calls = []
    pipelined = engine._pipelined_segments

    def counted(*a, **k):
        calls.append(1)
        yield from pipelined(*a, **k)

    monkeypatch.setattr(engine, "_pipelined_segments", counted)
    monkeypatch.delenv("TARS_STAGE_SYNC", raising=False)
    assert engine._seq_tail_overlap_enabled(3) and not engine._seq_tail_overlap_enabled(1)
    piped = engine.infer(prompt, segs, seed=6, interval_silence=100)
    gen_piped = list(engine.infer_generator(prompt, segs, seed=6, interval_silence=100))
    assert len(calls) == 2
    monkeypatch.setenv("TARS_STAGE_SYNC", "1")
    assert not engine._seq_tail_overlap_enabled(3)
    monkeypatch.delenv("TARS_STAGE_SYNC")
    monkeypatch.setattr(engine, "cfg", _overlap(engine, False))
    assert not engine._seq_tail_overlap_enabled(3)
    inline = engine.infer(prompt, segs, seed=6, interval_silence=100)
    gen_inline = list(engine.infer_generator(prompt, segs, seed=6, interval_silence=100))
    assert len(calls) == 2
    np.testing.assert_array_equal(piped["audio"], inline["audio"])
    assert len(gen_piped) == len(gen_inline) == 6
    for a, b in zip(gen_piped, gen_inline):
        np.testing.assert_array_equal(a, b)
    n_sil = int(SR * 100 / 1000)
    stream = np.concatenate(gen_inline)
    np.testing.assert_array_equal(stream[:-n_sil], piped["audio"])
    assert not stream[-n_sil:].any()
    assert [r.codes_len for r in piped["stats"]] == [r.codes_len for r in inline["stats"]]
    assert len(piped["stats"]) == 3


def test_decode_error_in_the_producer_raises(engine, prompt, monkeypatch):
    """tests/test_engine_e2e.py:376: the error reaches the caller of
    infer() and of infer_generator(), on the pipelined route."""
    monkeypatch.delenv("TARS_STAGE_SYNC", raising=False)

    def boom(*a, **k):
        raise RuntimeError("decode exploded")

    monkeypatch.setattr(engine, "_decode_segment_codes", boom)
    with pytest.raises(RuntimeError, match="decode exploded"):
        engine.infer(prompt, _segments(1, (5, 6)), seed=0)
    with pytest.raises(RuntimeError, match="decode exploded"):
        list(engine.infer_generator(prompt, _segments(1, (5, 6)), seed=0))


def test_tail_error_raises_in_the_caller(engine, prompt, monkeypatch):
    monkeypatch.delenv("TARS_STAGE_SYNC", raising=False)

    def boom(*a, **k):
        raise RuntimeError("tail exploded")

    monkeypatch.setattr(engine, "_finish_from_codes", boom)
    with pytest.raises(RuntimeError, match="tail exploded"):
        engine.infer(prompt, _segments(2, (5, 6)), seed=0)


def test_keyed_generator_matches_infer(engine, tmp_path):
    """tests/test_engine_e2e.py:393: a path prompt, one seed: the
    generator's chunks joined are infer()'s audio; the generator fills the
    caches that infer() then reuses."""
    from indextts_tpu_torch.utils import audio as audio_utils

    path = str(tmp_path / "spk_gen.wav")
    audio_utils.save_wav(path, speech_like(np.random.default_rng(12), 1.0, 16000), 16000)
    segs = _segments(13, (5, 6))
    engine._emoconds_cache.clear()
    engine._cond_kv_cache.clear()
    got = np.concatenate(list(engine.infer_generator(path, segs, seed=12,
                                                     interval_silence=0)))
    assert len(engine._emoconds_cache) == len(engine._cond_kv_cache) == 1
    want = engine.infer(path, segs, seed=12, interval_silence=0)["audio"]
    assert len(engine._emoconds_cache) == 1
    np.testing.assert_array_equal(got, want)


def test_closed_generator_does_not_wait_for_a_running_tail(engine, prompt, monkeypatch):
    """The second segment's tail blocks (up to 30 s); the consumer takes
    the first chunk, waits for that tail to start and closes the stream:
    close returns within 3 s, the decode thread ends, and the third
    segment's tail, not started, never runs."""
    monkeypatch.delenv("TARS_STAGE_SYNC", raising=False)
    finish = engine._finish_from_codes
    started, release, tails = threading.Event(), threading.Event(), []

    def slow_finish(*args):
        tails.append(1)
        if len(tails) == 2:
            started.set()
            release.wait(timeout=30)
        return finish(*args)

    monkeypatch.setattr(engine, "_finish_from_codes", slow_finish)
    gen = engine.infer_generator(prompt, _segments(14), seed=1, interval_silence=0)
    try:
        first = next(gen)
        assert first.size and started.wait(timeout=30)
        t0 = time.perf_counter()
        gen.close()
        closed_in = time.perf_counter() - t0
    finally:
        release.set()
    assert closed_in < 3.0, closed_in
    deadline = time.time() + 30
    while any(th.name == "tars-seq-decode" for th in threading.enumerate()):
        assert time.time() < deadline
        time.sleep(0.05)
    time.sleep(0.5)
    assert len(tails) == 2


def test_generator_continuous_matches_sequential(prompt):
    """tests/test_batcher.py:289, greedy: the chunks through a
    ContinuousService equal the sequential generator's."""
    from indextts_tpu_torch.runtime.batcher import ContinuousService
    from indextts_tpu_torch.runtime.engine import IndexTTS2Engine

    cfg = parity_config()
    pcfg = to_port_config(cfg)
    eng = IndexTTS2Engine(pcfg, from_jax_params(parity_params(cfg, seed=1), pcfg),
                          device="cpu")
    segs = _segments(70, (5, 6))
    want = list(eng.infer_generator(prompt, segs, seed=5))
    svc = ContinuousService(eng, n_slots=2, text_bucket=16, max_new=24, chunk_steps=4)
    try:
        got = list(eng.infer_generator_continuous(svc, prompt, segs, seed=5))
    finally:
        svc.shutdown()
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _jax_stream_segments(monkeypatch, cfg, calls):
    """Run the JAX server's main() with a stand-in engine and server, and
    return the segments its synth_stream hands to infer_generator for each
    (text, quick_streaming_tokens) of `calls` (its `_fallback_segments`,
    indextts_tpu/serve.py:190-209)."""
    import jax

    import indextts_tpu.config as jconfig
    import indextts_tpu.runtime.engine as jengine
    import indextts_tpu.runtime.server as jserver
    import indextts_tpu.utils.obs as obs
    from indextts_tpu import serve as jserve

    seen, made = [], {}

    class Engine:
        def __init__(self, c, params):
            self.cfg, self.tokenizer = c, None

        def infer_generator(self, spk, seg_ids, **kw):
            seen.append([np.asarray(s).tolist() for s in seg_ids])
            yield from ()

    class Server:
        def __init__(self, fn, settings, stream_fn=None):
            made["stream"] = stream_fn

        def run(self):
            pass

    class Shutdown:
        def install(self):
            pass

    for var in ("TARS_REFERENCE_AUDIO", "TARS_QUICK_STREAMING", "TARS_CONTINUOUS_SLOTS",
                "TARS_MAX_CONCURRENCY"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("TARS_NUM_BEAMS", "1")
    monkeypatch.setenv("TARS_PRECOMPILE", "0")
    monkeypatch.setattr(jconfig, "load_config", lambda path=None: cfg)
    monkeypatch.setattr(jengine, "IndexTTS2Engine", Engine)
    monkeypatch.setattr(jengine, "random_params", lambda c, seed=0: {})
    monkeypatch.setattr(jserver, "TTSServer", Server)
    monkeypatch.setattr(obs, "GracefulShutdown", Shutdown)
    # a logger of its own: the JAX main's writes no log file
    monkeypatch.setattr(obs, "_LOGGER", logging.getLogger("indextts_tpu.stream_test"))
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)
    jserve.main([])
    for text, quick in calls:
        list(made["stream"](text=text, spk_audio="spk.wav", quick_streaming_tokens=quick))
    return seen


def test_fallback_segments_match_the_jax_server(monkeypatch):
    """The default config (120 ids a segment): 200 bytes with quick 40 give
    segments of 40/120/40; other quick values, short and empty texts and
    the tiny config's cap of 32 ids split as the JAX server splits them."""
    from indextts_tpu.config import IndexTTS2Config

    from indextts_tpu_torch.serve import fallback_segments

    texts = ["", "hi", "The port answers this request on the card. " * 5]
    calls = [(tx, q) for tx in texts for q in (0, 7, 40, 500)]
    for cfg in (IndexTTS2Config(), parity_config()):
        want = _jax_stream_segments(monkeypatch, cfg, calls)
        got = [[s.tolist() for s in fallback_segments(
            tx, cfg.gpt.number_text_tokens, cfg.runtime.max_text_tokens_per_segment,
            cfg.gpt.max_text_tokens, quick=q)] for tx, q in calls]
        assert got == want
    lens = [len(s) for s in fallback_segments(texts[2], 12000, 120, 600, quick=40)]
    assert lens == [40, 120, 40]


def test_infer_text_passes_quick_streaming_tokens(engine, prompt, monkeypatch):
    """infer_text hands quick_streaming_tokens to the tokenizer's
    split_segments, as the JAX engine's does."""
    seen = {}

    class Tokenizer:
        def tokenize(self, text):
            return list(text)

        def split_segments(self, pieces, max_seg, quick_streaming_tokens=0):
            seen["quick"] = quick_streaming_tokens
            return [pieces[:4]]

        def convert_tokens_to_ids(self, toks):
            return [2 + ord(c) % 40 for c in toks]

    monkeypatch.setattr(engine, "tokenizer", Tokenizer())
    engine.infer_text(prompt, "quick streaming", seed=1, quick_streaming_tokens=7)
    assert seen["quick"] == 7


def test_synth_stream_reads_quick_streaming(monkeypatch):
    """TARS_QUICK_STREAMING sizes the first segments; the payload's
    quick_streaming_tokens overrides it."""
    from indextts_tpu_torch import serve

    seen = []

    class Engine:
        cfg, tokenizer = to_port_config(parity_config()), None

        def infer_generator(self, spk, seg_ids, **kw):
            seen.append([len(s) for s in seg_ids])
            yield from ()

    monkeypatch.setenv("TARS_QUICK_STREAMING", "5")
    stream = serve.make_synth_stream(Engine(), "spk.wav")
    list(stream(text="x" * 40))
    list(stream(text="x" * 40, quick_streaming_tokens=0))
    assert seen == [[5, 32, 3], [32, 8]]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Served:
    """serve.build on the CPU (tiny config), its server on an event loop
    in a thread."""

    def __init__(self, tmp_path, monkeypatch):
        import asyncio

        from indextts_tpu_torch import serve
        from indextts_tpu_torch.utils import audio as audio_utils

        monkeypatch.setenv("TARS_CACHE_DIR", str(tmp_path / "cache"))
        monkeypatch.delenv("TARS_STAGE_SYNC", raising=False)
        wav_path = str(tmp_path / "spk.wav")
        audio_utils.save_wav(wav_path, speech_like(np.random.default_rng(1), 1.0, 16000),
                             16000)
        self.port = _free_port()
        self.server, self.engine = serve.build(
            ["--host", "127.0.0.1", "--port", str(self.port), "--device", "cpu",
             "--reference-audio", wav_path], cfg=to_port_config(parity_config()))
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.fut = asyncio.run_coroutine_threadsafe(self.server.serve(), self.loop)
        t0 = time.time()
        while not self.server.ready:
            assert not self.fut.done() and time.time() - t0 < 30
            time.sleep(0.02)

    def post(self, path, payload):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=300)
        conn.request("POST", path, body=json.dumps(payload),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        out = (r.status, r.getheader("Transfer-Encoding"), r.read())
        conn.close()
        return out

    def close(self):
        self.fut.cancel()
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)
        self.loop.close()
        self.server.pool.shutdown(wait=True)


def stream_equals_tts(served, payload):
    """POST /tts and /tts/stream of `payload`: both 200; the stream chunked
    s16le PCM, the WAV's samples then 200 ms of silence."""
    status, _, body = served.post("/tts", payload)
    assert status == 200, body[:200]
    with wave.open(io.BytesIO(body)) as w:
        assert (w.getnchannels(), w.getsampwidth(), w.getframerate()) == (1, 2, SR)
        wav = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    status, encoding, pcm = served.post("/tts/stream", payload)
    assert status == 200 and encoding == "chunked", pcm[:200]
    pcm = np.frombuffer(pcm, np.int16)
    n_sil = int(SR * 200 / 1000)
    assert wav.size and np.abs(wav).max() > 0
    np.testing.assert_array_equal(pcm[:-n_sil], wav)
    assert not pcm[-n_sil:].any()


def _tts_after_busy(served, payload, seconds: float = 60.0):
    """POST /tts until it is not refused as busy (429), for up to `seconds`."""
    deadline = time.time() + seconds
    while True:
        status, _, body = served.post("/tts", payload)
        if status != 429 or time.time() > deadline:
            return status, body
        time.sleep(0.1)


def _seq_threads():
    return [th.name for th in threading.enumerate() if th.name.startswith("tars-seq")]


def test_tts_stream_answers_pcm_and_survives_a_disconnect(tmp_path, monkeypatch):
    """Sequential mode: a 3-segment text (tail overlap on) through /tts and
    /tts/stream; then a client that reads the first chunk of a 7-segment
    stream and leaves. The server notices at its next write and abandons
    the stream: a later /tts answers 200 within 60 s, and no decode or tail
    thread of the stream is left."""
    served = _Served(tmp_path, monkeypatch)
    try:
        assert served.server.service is None and served.server.settings.enable_streaming
        text = "The port streams this text in three segments, one by one."
        stream_equals_tts(served, {"text": text, "seed": 3})
        with socket.create_connection(("127.0.0.1", served.port), timeout=60) as s:
            body = json.dumps({"text": text * 4, "seed": 4}).encode()
            s.sendall(b"POST /tts/stream HTTP/1.1\r\nHost: x\r\nContent-Type: "
                      b"application/json\r\nContent-Length: "
                      + str(len(body)).encode() + b"\r\n\r\n" + body)
            got = b""
            while b"\r\n\r\n" not in got or len(got.split(b"\r\n\r\n", 1)[1]) < 64:
                chunk = s.recv(4096)
                assert chunk
                got += chunk
            assert got.startswith(b"HTTP/1.1 200")
        status, body = _tts_after_busy(served, {"text": "after the disconnect", "seed": 5})
        assert status == 200, body[:200]
        deadline = time.time() + 30
        while _seq_threads():
            assert time.time() < deadline, _seq_threads()
            time.sleep(0.05)
    finally:
        served.close()
