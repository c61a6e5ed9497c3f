"""The port's emotion controls against the JAX engine's, on the CPU.

The parity config (greedy, one beam), seeded numpy emotion banks of the
config's shapes (sum(emo_num) rows of the GPT's width, and of 192 for the
speaker rows), `device="cpu"`:

* `_emovec_from_matrix` within 1e-6 of the JAX engine's (float32 sums of 8
  rows in another order); `normalize_emo_vec` equal.
* `infer(..., emo_vector=v)`: greedy codes token-exact with the JAX engine
  (both precise_shapes, the same CFM noise), the mel within 1e-4 and the
  waveform within 1e-3 of their peaks as in tests/test_torch_slice.py, the
  waveform also within one PCM16 step (1 / 32767): both sides round it to
  PCM16, and at a peak of a few thousandths one float32 difference at a
  rounding edge is a step larger than 1e-3 of the peak.
* Keys: two vectors on one speaker path give two keys and the codes of the
  unkeyed route; use_random gives no key, rows of the banks, and one draw
  for one seed.
* `infer_continuous` with a vector gives the sequential route's audio.
* `infer_text(use_emo_text=True)` with a tiny Qwen3 attached to both
  engines: the same vector and codes; ValueError without one; POST /tts
  with use_emo_text answers 400 without one.
* The CLI writes a WAV with --emo-vector.
"""

import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indextts_tpu_torch.weights import from_jax_params
from test_torch_qwen import TINY, jax_tiny
from test_torch_stream import _Served
from torch_parity import parity_config, parity_params, speech_like, to_port_config

VECTORS = [[0.0, 0.0, 0.6, 0.0, 0.0, 0.0, 0.0, 0.0],
           [0.3, 0.0, 0.0, 0.0, 0.0, 0.4, 0.0, 0.2]]


def banks(cfg, seed: int = 11):
    rng = np.random.default_rng(seed)
    n = sum(cfg.emo_num)
    return (rng.standard_normal((n, cfg.gpt.model_dim)).astype(np.float32) * 0.5,
            rng.standard_normal((n, 192)).astype(np.float32))


class Tokenizer:
    """A stand-in for the BPE tokenizer: characters as ids, one segment."""

    def tokenize(self, text):
        return list(text)

    def split_segments(self, pieces, max_seg, quick_streaming_tokens=0):
        return [pieces[:max_seg]]

    def convert_tokens_to_ids(self, toks):
        return [2 + ord(c) % 40 for c in toks]


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) on parity_params(seed=1) and the same
    banks, precise shapes, a stand-in tokenizer each."""
    from indextts_tpu.runtime.engine import IndexTTS2Engine as JaxEngine

    from indextts_tpu_torch.runtime.engine import IndexTTS2Engine

    cfg = parity_config()
    jp = parity_params(cfg, seed=1)
    pcfg = to_port_config(cfg)
    emo_m, spk_m = banks(cfg)
    je = JaxEngine(cfg, jp, emo_matrix=emo_m, spk_matrix=spk_m, precise_shapes=True,
                   tokenizer=Tokenizer())
    pe = IndexTTS2Engine(pcfg, from_jax_params(jp, pcfg), device="cpu", precise_shapes=True,
                         emo_matrix=emo_m, spk_matrix=spk_m, tokenizer=Tokenizer())
    return je, pe


@pytest.fixture(scope="module")
def prompt():
    return speech_like(np.random.default_rng(0), 1.2, 16000), 16000


def _spy(engine):
    """Record each segment's codes and emovec at the tail; returns the list."""
    seen = []
    orig = type(engine)._finish_from_codes

    def spy(spk, emovec, text_ids, codes, *rest):
        seen.append((np.asarray(codes).copy(), np.array(emovec)))
        return orig(engine, spk, emovec, text_ids, codes, *rest)

    engine._finish_from_codes = spy
    return seen


def _run(engine, fn, noise_seed: int = 5):
    """fn(engine) with the CFM noise from `noise_seed` and the mel tapped:
    (result, [(codes, emovec)], mels)."""
    noises, rng = {}, np.random.default_rng(noise_seed)

    def noise(shape):
        if shape not in noises:
            noises[shape] = rng.standard_normal(shape).astype(np.float32)
        return noises[shape]

    engine._noise_hook, engine._mel_taps = noise, []
    seen = _spy(engine)
    try:
        return fn(engine), seen, engine._mel_taps
    finally:
        engine.__dict__.pop("_finish_from_codes", None)
        engine._noise_hook, engine._mel_taps = None, None


@pytest.mark.parametrize("vector", VECTORS)
def test_emovec_from_matrix_matches_jax(engines, vector):
    je, pe = engines
    style = np.random.default_rng(3).standard_normal((1, 192)).astype(np.float32)
    want = je._emovec_from_matrix(vector, jnp.asarray(style), False)
    got = pe._emovec_from_matrix(vector, torch.from_numpy(style), False)
    assert got.shape == (1, pe.cfg.gpt.model_dim) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("vector,bias", [([0.2] * 8, True), ([0.1, 0, 0, 0, 0, 0, 0, 0.3], True),
                                         ([1.0, 0.5, 0, 0, 0, 0, 0, 0], False),
                                         ([0.05] * 8, False)])
def test_normalize_emo_vec_matches_jax(vector, bias):
    from indextts_tpu.runtime.engine import IndexTTS2Engine as JaxEngine

    from indextts_tpu_torch.runtime.engine import IndexTTS2Engine

    assert (IndexTTS2Engine.normalize_emo_vec(vector, bias)
            == JaxEngine.normalize_emo_vec(vector, bias))


@pytest.mark.parametrize("vector", VECTORS)
def test_emo_vector_request_matches_jax(engines, prompt, vector):
    """One segment with an emo_vector: the same codes; the emovec the tail
    gets (the blended one) within 1e-5 of its largest value; mel within
    1e-4 of its largest value, waveform within 1e-3 of its peak plus one
    PCM16 step."""
    text = np.random.default_rng(2).integers(2, 50, 9)
    out = {name: _run(eng, lambda e: e.infer(prompt, [text], emo_vector=vector, seed=0))
           for name, eng in zip(("jax", "port"), engines)}
    (jr, jseen, jmel), (pr, pseen, pmel) = out["jax"], out["port"]
    assert len(jseen[0][0]) > 2
    np.testing.assert_array_equal(pseen[0][0], jseen[0][0])
    je_vec, pe_vec = jseen[0][1], pseen[0][1]
    assert np.abs(pe_vec - je_vec).max() <= 1e-5 * np.abs(je_vec).max()
    assert np.abs(pmel[0] - jmel[0]).max() <= 1e-4 * np.abs(jmel[0]).max()
    jw, pw = jr["audio"], pr["audio"]
    assert pw.shape == jw.shape and 0 < np.abs(jw).max() < 1.0
    assert np.abs(pw - jw).max() <= 1e-3 * np.abs(jw).max() + 1 / 32767


def _codes(engine, *args, **kw):
    seen = _spy(engine)
    try:
        engine.infer(*args, **kw)
    finally:
        engine.__dict__.pop("_finish_from_codes", None)
    return [c for c, _ in seen]


def test_two_vectors_on_one_path_take_two_keys(engines, prompt, tmp_path):
    """Each vector on a speaker path is its own key (its conds and prefix
    KV cached apart), and gives the codes of the unkeyed (audio, sr) route;
    the two vectors' codes differ, so a shared key would show."""
    from indextts_tpu_torch.utils import audio as audio_utils

    _, pe = engines
    path = str(tmp_path / "spk.wav")
    audio_utils.save_wav(path, *prompt)
    text = np.random.default_rng(4).integers(2, 50, 8)
    pe._emoconds_cache.clear()
    pe._cond_kv_cache.clear()
    keyed = [_codes(pe, path, [text], emo_vector=v, seed=1) for v in VECTORS]
    again = [_codes(pe, path, [text], emo_vector=v, seed=1) for v in VECTORS]
    unkeyed = [_codes(pe, audio_utils.load_wav(path), [text], emo_vector=v, seed=1)
               for v in VECTORS]
    assert set(pe._emoconds_cache) == {(path, "", 1.0, tuple(v)) for v in VECTORS}
    if pe.decoder.supports_cond_kv:
        assert set(pe._cond_kv_cache) == set(pe._emoconds_cache)
    for k, a, u in zip(keyed, again, unkeyed):
        np.testing.assert_array_equal(k[0], u[0])
        np.testing.assert_array_equal(a[0], u[0])
    assert not np.array_equal(keyed[0][0], keyed[1][0])
    # a vector overrides the emotion prompt, and its alpha
    key = pe._conditioning(path, path, 0.4, VECTORS[0])[3]
    assert key == (path, "", 1.0, tuple(VECTORS[0]))


def test_use_random_draws_rows_without_a_key(engines, prompt, tmp_path):
    """use_random: a one-hot vector gives a row of its bank; one seed, one
    draw; a speaker path takes no key."""
    from indextts_tpu_torch.utils import audio as audio_utils

    _, pe = engines
    style = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 192)).astype(np.float32))
    for k in range(len(pe.cfg.emo_num)):
        onehot = [0.0] * 8
        onehot[k] = 1.0
        draws = {tuple(pe._emovec_from_matrix(onehot, style, True, seed=s)[0].numpy())
                 for s in range(12)}
        bank = {tuple(r) for r in pe.emo_matrix[k].numpy()}
        assert draws <= bank and (len(draws) > 1 or len(bank) == 1)
    a = pe._emovec_from_matrix(VECTORS[1], style, True, seed=3)
    b = pe._emovec_from_matrix(VECTORS[1], style, True, seed=3)
    assert torch.equal(a, b)
    path = str(tmp_path / "spk.wav")
    audio_utils.save_wav(path, *prompt)
    assert pe._conditioning(path, None, 1.0, VECTORS[1], use_random=True)[3] is None
    pe._emoconds_cache.clear()
    text = np.random.default_rng(6).integers(2, 50, 7)
    first = _codes(pe, path, [text], emo_vector=VECTORS[1], use_random=True, seed=2)
    assert not pe._emoconds_cache
    np.testing.assert_array_equal(
        _codes(pe, path, [text], emo_vector=VECTORS[1], use_random=True, seed=2)[0], first[0])


def test_continuous_route_takes_the_vector(engines, prompt):
    """infer_continuous and infer_generator_continuous with a vector give the
    sequential infer's audio with the same seeds, to the bit."""
    from indextts_tpu_torch.runtime.batcher import ContinuousService

    _, pe = engines
    segs = [np.random.default_rng(k).integers(2, 50, 5 + 2 * k) for k in range(2)]
    want = pe.infer(prompt, segs, emo_vector=VECTORS[1], seed=5)["audio"]
    svc = ContinuousService(pe, n_slots=2, text_bucket=12, max_new=24, chunk_steps=4)
    try:
        got = pe.infer_continuous(svc, prompt, segs, emo_vector=VECTORS[1], seed=5)["audio"]
        streamed = list(pe.infer_generator_continuous(svc, prompt, segs, emo_vector=VECTORS[1],
                                                      seed=5))
    finally:
        svc.shutdown()
    assert got.shape == want.shape and np.array_equal(got, want)
    # each segment, then its silence: the last silence is not in infer's audio
    assert len(streamed) == 4 and np.array_equal(np.concatenate(streamed[:-1]), want)


def _tiny_qwen_pair():
    """QwenEmotion over the tiny Qwen3 in each package, the same weights,
    encode and decode: the response names each emotion with a score read
    from the generated tokens, so the vector follows the model."""
    from indextts_tpu.models.qwen3 import greedy_generate as jax_greedy
    from indextts_tpu.runtime import qwen_emo as jax_qe

    from indextts_tpu_torch.runtime import qwen_emo

    jm, params, pm = jax_tiny(0)

    def encode(system, user):
        return [b % TINY.vocab_size for b in (system + "|" + user).encode()]

    def decode(ids):
        return "{" + ", ".join(f'"{k}": {ids[i] % 7 / 10}' for i, k in
                               enumerate(qwen_emo.DESIRED_ORDER)) + "}"

    def jax_fn(system, user):
        out = jax_greedy(jm, params, np.asarray(encode(system, user)), 12, -1)
        return decode(jax_qe.strip_thinking([int(t) for t in out]))

    port = qwen_emo.QwenEmotion(qwen_emo.make_generate_fn(pm, encode, decode, -1, 12))
    return jax_qe.QwenEmotion(jax_fn), port


def test_infer_text_with_emo_text_matches_jax(engines, prompt):
    """use_emo_text with a tiny Qwen attached: the same vector (scaled by
    alpha 0.7 and cut to 4 decimals), the same codes; without a Qwen a
    ValueError."""
    je, pe = engines
    jq, pq = _tiny_qwen_pair()
    vec = pq.vector("a bright morning")
    assert vec == jq.vector("a bright morning") and len(set(vec)) > 1
    text = "hello there, bright morning"
    try:
        je.qwen_emo, pe.qwen_emo = jq, pq
        seen = {}
        for name, eng in (("jax", je), ("port", pe)):
            calls = []
            orig = type(eng).infer

            def infer(spk, segs, *a, _orig=orig, _eng=eng, _calls=calls, **kw):
                _calls.append(kw["emo_vector"])
                return _orig(_eng, spk, segs, *a, **kw)

            eng.infer = infer
            try:
                _, codes, _ = _run(eng, lambda e: e.infer_text(
                    prompt, text, use_emo_text=True, emo_text="a bright morning",
                    emo_alpha=0.7, seed=0))
            finally:
                eng.__dict__.pop("infer", None)
            seen[name] = (calls[0], codes[0][0])
        assert seen["port"][0] == seen["jax"][0] == [int(x * 0.7 * 10000) / 10000 for x in vec]
        np.testing.assert_array_equal(seen["port"][1], seen["jax"][1])
    finally:
        je.qwen_emo = pe.qwen_emo = None
    with pytest.raises(ValueError, match="qwen_emo"):
        pe.infer_text(prompt, text, use_emo_text=True)


def test_tts_with_emo_text_needs_a_qwen(tmp_path, monkeypatch):
    """POST /tts with use_emo_text: 400 while no Qwen is attached (the
    stream, as the JAX server's, has sent its 200 before the error and
    ends without audio); with one, the WAV of the vector it reads."""
    monkeypatch.setenv("TARS_WARMUP", "0")
    monkeypatch.setenv("TARS_PRECOMPILE", "0")
    served = _Served(tmp_path, monkeypatch)
    try:
        payload = {"text": "hello there", "seed": 3, "use_emo_text": True}
        status, _, body = served.post("/tts", payload)
        assert status == 400 and b"no Qwen emotion model" in body, (status, body[:200])
        assert served.post("/tts/stream", payload)[::2] == (200, b"")
        _, pq = _tiny_qwen_pair()
        served.engine.qwen_emo = pq
        status, _, body = served.post("/tts", payload)
        assert status == 200, body[:200]
        status, _, want = served.post("/tts", {"text": "hello there", "seed": 3,
                                               "emo_vector": pq.vector("hello there")})
        assert status == 200 and body == want
    finally:
        served.close()


def test_cli_writes_a_wav_with_an_emo_vector(tmp_path, prompt, monkeypatch):
    """--emo-vector goes through normalize_emo_vec into infer; the WAV holds
    the audio; --model-dir raises."""
    from indextts_tpu_torch import cli
    from indextts_tpu_torch.runtime.engine import IndexTTS2Engine
    from indextts_tpu_torch.utils import audio as audio_utils

    voice, out_path = str(tmp_path / "voice.wav"), str(tmp_path / "out.wav")
    audio_utils.save_wav(voice, *prompt)
    seen = []
    infer = IndexTTS2Engine.infer

    def spy(self, *a, **kw):
        seen.append(kw["emo_vector"])
        return infer(self, *a, **kw)

    monkeypatch.setattr(IndexTTS2Engine, "infer", spy)
    out = cli.main(["hello", "-v", voice, "-o", out_path, "--emo-vector",
                    "0,0,1,0,0,0,0.5,0", "--seed", "1", "--device", "cpu"],
                   cfg=to_port_config(parity_config()))
    assert seen == [IndexTTS2Engine.normalize_emo_vec([0, 0, 1, 0, 0, 0, 0.5, 0])]
    with wave.open(out_path) as w:
        assert (w.getnchannels(), w.getsampwidth(), w.getframerate()) == (1, 2, 22050)
        assert w.getnframes() == len(out["audio"]) > 0
    with pytest.raises(NotImplementedError):
        cli.main(["hello", "-v", voice, "--model-dir", str(tmp_path), "--device", "cpu"],
                 cfg=to_port_config(parity_config()))
