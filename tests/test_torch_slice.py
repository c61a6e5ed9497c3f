"""The port's /tts path as a whole, on the CPU.

* The JAX engine and the port's engine, both `precise_shapes=True`, run one
  request from the same parameters, speaker audio, text ids and CFM noise,
  greedy with one beam: equal codes, then mel and waveform within a stated
  tolerance.
* One POST /tts through the port's serve entry point and its copy of
  TTSServer.
* The port imports nothing of JAX, flax or the JAX package.
* Entry points default to the card and raise without one unless the caller
  asks for the CPU.
"""

import ast
import asyncio
import http.client
import io
import json
import socket
import threading
import time
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from indextts_tpu_torch.weights import from_jax_params
from torch_parity import parity_config, parity_params, speech_like, to_port_config

ROOT = Path(__file__).resolve().parent.parent


def _capture_codes(engine, into):
    orig = engine._finish_from_codes

    def spy(spk, emovec, text_ids, codes, *rest):
        into.append(np.asarray(codes).copy())
        return orig(spk, emovec, text_ids, codes, *rest)

    engine._finish_from_codes = spy


def test_slice_matches_jax_engine(monkeypatch):
    """Codes equal; mel within 1e-4 of its largest value (float32 through
    ~40 layers of conditioning, GPT latent and two CFM steps, summed in
    another order); waveform within 1e-3 of its peak, PCM16 quantization
    included (one step is 3e-5)."""
    from indextts_tpu.runtime.engine import IndexTTS2Engine as JaxEngine

    from indextts_tpu_torch.runtime.engine import IndexTTS2Engine

    monkeypatch.setenv("INDEXTTS_NATIVE_DSP", "0")
    cfg = parity_config()
    jp = parity_params(cfg, seed=1)
    pcfg = to_port_config(cfg)
    je = JaxEngine(cfg, jp, precise_shapes=True)
    pe = IndexTTS2Engine(pcfg, from_jax_params(jp, pcfg), device="cpu", precise_shapes=True)
    rng = np.random.default_rng(0)
    prompt = speech_like(rng, 1.2, 16000)
    text = rng.integers(2, 50, 9)
    noises = {}
    noise_rng = np.random.default_rng(5)

    def noise(shape):
        if shape not in noises:
            noises[shape] = noise_rng.standard_normal(shape).astype(np.float32)
        return noises[shape]

    out, codes = {}, {}
    for name, eng in (("jax", je), ("port", pe)):
        eng._noise_hook = noise
        eng._mel_taps = []
        codes[name] = []
        _capture_codes(eng, codes[name])
        res = eng.infer((prompt, 16000), [text], seed=0, num_beams=1, do_sample=False)
        out[name] = (eng._mel_taps[0], res["audio"])
    assert len(codes["jax"][0]) > 2
    np.testing.assert_array_equal(codes["port"][0], codes["jax"][0])
    (jm, jw), (pm, pw) = out["jax"], out["port"]
    assert pm.shape == jm.shape and pw.shape == jw.shape
    assert np.abs(pm - jm).max() <= 1e-4 * np.abs(jm).max()
    assert 0 < np.abs(jw).max() < 1.0  # off the clip, or the check says nothing
    assert np.abs(pw - jw).max() <= 1e-3 * np.abs(jw).max()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_one_tts_request(tmp_path, monkeypatch):
    """serve.build (device="cpu", the tiny config) boots the copied
    TTSServer with the port's engine; one POST /tts answers a mono 16-bit
    WAV at 22.05 kHz."""
    from indextts_tpu_torch import serve
    from indextts_tpu_torch.utils import audio as audio_utils

    monkeypatch.setenv("TARS_CACHE_DIR", str(tmp_path / "cache"))
    wav_path = str(tmp_path / "spk.wav")
    audio_utils.save_wav(wav_path, speech_like(np.random.default_rng(1), 1.0, 16000), 16000)
    port = _free_port()
    server, engine = serve.build(
        ["--host", "127.0.0.1", "--port", str(port), "--device", "cpu",
         "--reference-audio", wav_path], cfg=to_port_config(parity_config()))
    assert engine.device.type == "cpu" and engine.cfg.runtime.num_beams == 1
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    fut = asyncio.run_coroutine_threadsafe(server.serve(), loop)
    try:
        t0 = time.time()
        while not server.ready:
            assert not fut.done() and time.time() - t0 < 30
            time.sleep(0.02)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("POST", "/tts", body=json.dumps({"text": "hello there", "seed": 3}),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        body = r.read()
        conn.close()
    finally:
        fut.cancel()
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=10)
        server.pool.shutdown(wait=True)
    assert r.status == 200, body[:200]
    with wave.open(io.BytesIO(body)) as w:
        assert (w.getnchannels(), w.getsampwidth(), w.getframerate()) == (1, 2, 22050)
        assert w.getnframes() > 0


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_no_jax():
    """No module of the port, and not chip_smoke.py, imports jax, flax or
    the JAX package (not even one of its JAX-free modules)."""
    files = sorted((ROOT / "indextts_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "indextts_tpu")]
    assert not bad, bad


def test_entry_points_default_to_cuda(monkeypatch):
    """Without a card, every entry point raises unless given device="cpu";
    with it, they run on the CPU."""
    from indextts_tpu_torch import serve
    from indextts_tpu_torch.runtime.engine import IndexTTS2Engine, random_params
    from indextts_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = to_port_config(parity_config())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        random_params(cfg, seed=0)
    params = random_params(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        IndexTTS2Engine(cfg, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.build(["--port", "0"], cfg=cfg)
    assert IndexTTS2Engine(cfg, params, device="cpu").device == torch.device("cpu")


def test_unported_routes_raise():
    """The bfloat16 s2mel and vocoder routes, which raised before the port
    had them, now build: a bfloat16 s2mel_dtype stores the s2mel's float
    weights in bfloat16; a bfloat16 voc_dtype the vocoder's, beside its
    float32 sibling; every other model stays float32."""
    import dataclasses

    from indextts_tpu_torch.runtime.engine import IndexTTS2Engine, random_params

    cfg = to_port_config(parity_config())
    params = random_params(cfg, seed=0, device="cpu")

    def float_dtypes(module):
        return {p.dtype for p in module.state_dict().values() if p.is_floating_point()}

    for name, fields in (("s2mel", {"s2mel_dtype": "bfloat16"}),
                         ("bigvgan", {"voc_dtype": "bfloat16"})):
        bf = dataclasses.replace(cfg, runtime=dataclasses.replace(cfg.runtime, **fields))
        eng = IndexTTS2Engine(bf, params, device="cpu")
        assert float_dtypes(getattr(eng, name)) == {torch.bfloat16}
        others = [n for n in ("gpt", "s2mel", "bigvgan", "repcodec", "campplus", "w2vbert")
                  if n != name]
        assert all(float_dtypes(getattr(eng, n)) == {torch.float32} for n in others)
        assert float_dtypes(eng.bigvgan_f32) == {torch.float32}
        assert (eng.bigvgan_f32 is eng.bigvgan) == (name != "bigvgan")


def test_uniform_fill_matches_jax_fill_range():
    """random_params makes the tree that from_jax_params makes of the JAX
    package's random_params (its U[0.01, 0.05) fill, values carried over
    unchanged): the same names, shapes and dtypes. Its values are each
    module's seeded initialization instead: finite, the same for the same
    seed, other for another."""
    from indextts_tpu.runtime.engine import random_params as jax_random_params

    from indextts_tpu_torch.runtime.engine import random_params

    cfg = parity_config()
    pcfg = to_port_config(cfg)
    want = from_jax_params(jax_random_params(cfg, seed=0), pcfg)
    jax_leaves = [v for sd in want.values() for v in sd.values() if v.is_floating_point()]
    assert min(float(v.min()) for v in jax_leaves) >= np.float32(0.01)
    assert max(float(v.max()) for v in jax_leaves) < np.float32(0.05)
    p = random_params(pcfg, seed=4, device="cpu")
    assert sorted(p) == sorted(want)
    for name, sd in p.items():
        assert sorted(sd) == sorted(want[name]), name
        for k, v in sd.items():
            assert (v.shape, v.dtype) == (want[name][k].shape, want[name][k].dtype), k
            assert torch.isfinite(v).all() if v.is_floating_point() else True, k
    again = random_params(pcfg, seed=4, device="cpu")["gpt"]
    other = random_params(pcfg, seed=5, device="cpu")["gpt"]
    assert all(torch.equal(p["gpt"][k], again[k]) for k in again)
    assert not all(torch.equal(p["gpt"][k], other[k]) for k in other)
