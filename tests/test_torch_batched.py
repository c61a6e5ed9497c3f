"""The port's batched-segments route against the JAX engine's, on the CPU.

`infer(..., batched=True)` decodes every segment of a request in one loop of
B rows, then runs one latent pass, one CFM solve and one vocoder call over
the B rows (JAX `synthesize_segments_batched`). Both engines at their
default buckets on parity_params(seed=1), greedy with one beam, segments of
5, 8 and 3 tokens (those of tests/test_engine_e2e.py's batched test), the
same seeded emotion banks:

* Codes: each row token-exact with the JAX engine's (a spy on each
  decoder's `generate`), and with the port's sequential decode of that
  segment alone (float, and W8 and W4 with the int8 KV cache).
* The whole waveform (float32 vocoder output, device_pcm16 off) within
  1e-3 of its peak; the CFM noise of the asked shape from one seeded numpy
  draw on both sides (the port's `_noise_hook`; `jax.random.normal`
  swapped for that one call on the JAX side). With the PCM16 clip on the
  card's place (device_pcm16, the default), the port's waveform is its
  float one within one PCM16 step (1 / 32767).
* Each stage on the same B-row inputs: the latent pass within 1e-5 of its
  largest value (JAX `_latent_program`), the s2mel stage within 1e-4 of the
  mel's (JAX `_s2mel_program`, one noise), the vocoder within 1e-4 of its
  peak and its PCM16 output within one step (JAX `_vocoder_program`,
  `_vocoder_pcm16_program`), the tolerances of tests/test_torch_slice.py,
  tests/test_torch_tail_buckets.py and tests/test_torch_models.py.
* One segment with batched=True takes the sequential route, as JAX does.
* A row that stops at once (a stop-only row of one code) and the
  emo_vector route run batched, against the JAX engine.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indextts_tpu_torch.runtime.engine import EmotionConditioning, next_bucket
from indextts_tpu_torch.weights import from_jax_params
from torch_parity import n, parity_config, parity_params, speech_like, to_port_config

VECTOR = [0.3, 0.0, 0.0, 0.0, 0.0, 0.4, 0.0, 0.2]


def _segments():
    rng = np.random.default_rng(3)
    return [rng.integers(2, 50, k) for k in (5, 8, 3)]


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine, the port with the PCM16 clip): device_pcm16
    off but for the last, seeded emotion banks on all three."""
    from indextts_tpu.runtime.engine import IndexTTS2Engine as JaxEngine

    from indextts_tpu_torch.runtime.engine import IndexTTS2Engine

    cfg = parity_config(device_pcm16=False)
    jp = parity_params(cfg, seed=1)
    rng = np.random.default_rng(11)
    rows = sum(cfg.emo_num)
    banks = dict(emo_matrix=0.5 * rng.standard_normal((rows, cfg.gpt.model_dim)).astype(
        np.float32), spk_matrix=rng.standard_normal((rows, 192)).astype(np.float32))

    def port(**rt):
        pcfg = to_port_config(dataclasses.replace(
            cfg, runtime=dataclasses.replace(cfg.runtime, **rt)))
        return IndexTTS2Engine(pcfg, from_jax_params(jp, pcfg), device="cpu", **banks)

    return JaxEngine(cfg, jp, **banks), port(), port(device_pcm16=True)


@pytest.fixture(scope="module")
def prompt():
    return speech_like(np.random.default_rng(0), 1.2, 16000), 16000


def _draw():
    """A CFM noise source: one seeded draw per shape, the same for every
    engine that asks."""
    noises, rng = {}, np.random.default_rng(5)

    def draw(shape):
        shape = tuple(int(s) for s in shape)
        if shape not in noises:
            noises[shape] = rng.standard_normal(shape).astype(np.float32)
        return noises[shape]

    return draw


def _spy(engine, edit=None):
    """Record each decode's rows (codes trimmed at their lengths), after
    `edit(codes, lengths)` when given; returns the list."""
    seen = []
    orig = type(engine.decoder).generate

    def generate(*args, **kw):
        res = orig(engine.decoder, *args, **kw)
        if edit is not None:
            res = edit(res)
        codes, lens = n(res.codes), n(res.lengths)
        seen.append([codes[b, :int(lens[b])] for b in range(len(lens))])
        return res

    engine.decoder.generate = generate
    return seen


def _batched(engine, prompt, monkeypatch, draw, edit=None, **kw):
    """infer(batched=True) of the three segments with the noise from
    `draw`: (result, the decodes' rows)."""
    seen = _spy(engine, edit)
    try:
        if type(engine).__module__.startswith("indextts_tpu_torch"):
            engine._noise_hook = draw
            return engine.infer(prompt, _segments(), seed=3, batched=True, **kw), seen
        with monkeypatch.context() as m:
            m.setattr(jax.random, "normal",
                      lambda key, shape, dtype=jnp.float32: jnp.asarray(draw(shape), dtype))
            return engine.infer(prompt, _segments(), seed=3, batched=True, **kw), seen
    finally:
        del engine.decoder.generate


def _same_audio(got, want, tol=1e-3):
    """The waveforms agree within `tol` of the reference's peak, which is
    off the clip (else the check says nothing)."""
    got, want = got["audio"], want["audio"]
    peak = np.abs(want).max()
    assert got.shape == want.shape and 0 < peak < 1.0
    assert np.abs(got - want).max() <= tol * peak


def test_batched_matches_jax(engines, prompt, monkeypatch):
    """One decode of 3 rows on each side, the same codes row by row; the
    waveform within 1e-3 of its peak; "stats" empty and each stage's seconds
    under the JAX names."""
    je, pe, _ = engines
    draw = _draw()
    jr, jseen = _batched(je, prompt, monkeypatch, draw)
    pr, pseen = _batched(pe, prompt, monkeypatch, draw)
    assert len(jseen) == len(pseen) == 1 and len(pseen[0]) == 3
    for p, j in zip(pseen[0], jseen[0]):
        np.testing.assert_array_equal(p, j)
    assert len({len(r) for r in pseen[0]}) > 1  # rows of unequal lengths
    _same_audio(pr, jr)
    assert pr["stats"] == [] and jr["stats"] == []
    assert list(pe._last_batched_stats) == list(je._last_batched_stats) == [
        "decode", "host_trim", "latent", "s2mel", "vocoder"]


QUANT = {"float": {}, "w8": dict(gpt_quantize=True, head_quant=True, kv_quant=True),
         "w4": dict(gpt_quantize=True, head_quant=True, kv_quant=True, gpt_wbits=4)}


@pytest.mark.parametrize("route", list(QUANT))
def test_batched_rows_match_sequential_decode(engines, prompt, monkeypatch, route):
    """Each batched row's codes are the port's own sequential decode of that
    segment alone, on the float route and on the W8 and W4 routes with the
    int8 KV cache: the rows' pad holes and masks, and the activations'
    per-row int8 scales, change nothing."""
    from indextts_tpu_torch.runtime.engine import IndexTTS2Engine

    pe = engines[1]
    if QUANT[route]:
        cfg = parity_config(**QUANT[route])
        pcfg = to_port_config(cfg)
        pe = IndexTTS2Engine(pcfg, from_jax_params(parity_params(cfg, seed=1), pcfg),
                             device="cpu")
    _, batched = _batched(pe, prompt, monkeypatch, _draw())
    seen = _spy(pe)
    try:
        for seg in _segments():
            pe.infer(prompt, [seg], seed=0)
    finally:
        del pe.decoder.generate
    assert len(seen) == 3
    for row, alone in zip(batched[0], seen):
        np.testing.assert_array_equal(row, alone[0])


def test_pcm16_route_within_one_step(engines, prompt, monkeypatch):
    """With device_pcm16 the batched waveform is the float one clipped to
    PCM16 on the card: within one step (1 / 32767)."""
    _, pe, pe16 = engines
    draw = _draw()
    want, _ = _batched(pe, prompt, monkeypatch, draw)
    got, _ = _batched(pe16, prompt, monkeypatch, draw)
    assert got["audio"].shape == want["audio"].shape
    assert np.abs(got["audio"] - want["audio"]).max() <= 1 / 32767


def test_one_segment_takes_the_sequential_route(engines, prompt):
    """batched=True with one segment gives the sequential route's audio and
    its stats (JAX: `batched and len(segments) > 1`); a direct call with
    one segment is `synthesize_segment`."""
    _, pe, _ = engines
    seg = _segments()[1]
    pe._noise_hook = None
    want = pe.infer(prompt, [seg], seed=4)
    got = pe.infer(prompt, [seg], seed=4, batched=True)
    np.testing.assert_array_equal(got["audio"], want["audio"])
    assert len(got["stats"]) == 1
    spk = pe.prepare_speaker(*prompt)
    emo = EmotionConditioning(spk.spk_cond_emb, spk.cond_len)
    one = pe.synthesize_segments_batched(spk, emo, [seg], seed=4)
    np.testing.assert_array_equal(one[0], pe.synthesize_segment(spk, emo, seg, seed=4).wav)


def test_stop_only_row_and_emo_vector(engines, prompt, monkeypatch):
    """Row 1's decode replaced on both sides by a stop at once: it becomes a
    stop-only row of one code (one frame), the others as before; and the
    emo_vector route batched. Each against the JAX engine: codes equal,
    waveform within 1e-3 of its peak and as long as its rows' frames."""
    je, pe, _ = engines
    stop = pe.cfg.gpt.stop_mel_token

    def stop_at_once(res):
        codes, lens = res.codes, res.lengths
        if isinstance(codes, torch.Tensor):
            codes, lens = codes.clone(), lens.clone()
            codes[1], lens[1] = stop, 1
        else:
            codes, lens = codes.at[1].set(stop), lens.at[1].set(1)
        return type(res)(codes=codes, lengths=lens)

    sil = int(pe.cfg.runtime.sampling_rate * 0.2)
    for edit, kw in ((stop_at_once, {}), (None, {"emo_vector": VECTOR})):
        draw = _draw()
        jr, jseen = _batched(je, prompt, monkeypatch, draw, edit, **kw)
        pr, pseen = _batched(pe, prompt, monkeypatch, draw, edit, **kw)
        for p, j in zip(pseen[0], jseen[0]):
            np.testing.assert_array_equal(p, j)
        _same_audio(pr, jr)
        # each row's waveform: int(code_len * 1.72) frames, code_len at least 1
        code_lens = [max(int(np.argmax(np.append(r, stop) == stop)), 1) for r in pseen[0]]
        frames = [int(c * 1.72) for c in code_lens]
        assert len(pr["audio"]) == sum(frames) * pe.cfg.vocoder.total_upsample + 2 * sil
    assert code_lens[1] > 1  # the emo_vector route's row 1 decodes


def test_stages_match_jax(engines, prompt):
    """The latent pass, the s2mel stage and the vocoder over 3 rows (codes
    of 23, 64 and 1, unequal texts), each fed the same inputs on both
    sides."""
    je, pe, pe16 = engines
    B, stop = 3, pe.cfg.gpt.stop_mel_token
    spk = pe.prepare_speaker(*prompt)
    emovec, _ = pe.segment_conds(spk, EmotionConditioning(spk.spk_cond_emb, spk.cond_len))
    segs = _segments()
    rng = np.random.default_rng(7)
    code_lens = [23, 64, 1]
    rows = [rng.integers(0, pe.cfg.gpt.start_mel_token, c) for c in code_lens]
    latent, codes_t = pe._latent_rows(spk, emovec, segs, rows, code_lens)
    assert latent.shape[:2] == codes_t.shape == (B, 64)
    assert (n(codes_t)[2, 1:] == stop).all()
    # the texts' 64-bucket, capped at max_text_tokens (32 at this size)
    lat_text = np.zeros((B, min(64, pe.cfg.gpt.max_text_tokens)), np.int32)
    for b, s in enumerate(segs):
        lat_text[b, :len(s)] = s
    want = np.asarray(je._latent_program(
        je.p_gpt, jnp.repeat(n(spk.spk_latents), B, 0), lat_text,
        np.asarray([len(s) for s in segs]), n(codes_t).astype(np.int32),
        np.asarray(code_lens), jnp.repeat(n(emovec), B, 0)))
    for b, c in enumerate(code_lens):
        err = np.abs(n(latent)[b, :c] - want[b, :c]).max()
        assert err <= 1e-5 * np.abs(want[b, :c]).max()

    target = next_bucket(int(64 * 1.72), 128, 128)
    total = spk.ref_mel_len + target
    noise = np.random.default_rng(9).standard_normal((B, 80, total)).astype(np.float32)
    vc = pe._s2mel_mel(spk, latent, codes_t, code_lens, target, torch.as_tensor(noise))
    jvc = np.asarray(je._s2mel_program(
        je.p_s2mel, je.p_repcodec, n(latent), n(codes_t).astype(np.int32),
        np.asarray(code_lens), n(spk.prompt_condition), n(spk.ref_mel),
        np.asarray(spk.ref_mel_len), n(spk.style), noise, target_len=target,
        total_len=total))
    assert vc.shape == jvc.shape == (B, 80, total)
    assert np.abs(n(vc) - jvc).max() <= 1e-4 * np.abs(jvc).max()

    mel = np.array(jvc[:, :, spk.ref_mel_len:])
    jwav = np.asarray(je._vocoder_program(je.p_bigvgan, jnp.asarray(mel)))
    with torch.inference_mode():
        wav = n(pe.vocoder_runner.vocode(torch.as_tensor(mel)))
        pcm = n(pe16.vocoder_runner.vocode(torch.as_tensor(mel)))
    assert wav.shape == jwav.shape == (B, target * pe.cfg.vocoder.total_upsample)
    assert 0 < np.abs(jwav).max() < 1.0
    assert np.abs(wav - jwav).max() <= 1e-4 * np.abs(jwav).max()
    jpcm = np.asarray(je._vocoder_pcm16_program(je.p_bigvgan, jnp.asarray(mel)))
    assert np.abs(pcm.astype(np.int32) - jpcm).max() <= 1
