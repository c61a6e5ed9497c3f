"""The port's bucketed cascade tail (`precise_shapes=False`, the default) on
the CPU, where the latent pass, the CFM solve and the vocoder run eagerly
(on the card each replays a captured graph: tests/test_torch_cuda.py).

* The port and the JAX engine at their defaults, from the same parameters,
  speaker audio, text ids and CFM noise hook, greedy with one beam: the
  whole waveforms, the tail that the vocoder's receptive field reaches into
  the bucket's padding included, within 1e-3 of the JAX peak (the
  precise-mode bound of tests/test_torch_slice.py).
* The latent pass at its buckets (codes and text padded to multiples of 64,
  the text capped at max_text_tokens) against the exact-shape pass, on the
  valid rows: within 1e-5 of the largest value (float32 sums over other
  widths).
* The stop token that pads the codes past a codebook that does not hold it
  reaches no row of the s2mel stage's output.
* `precompile`'s grid against the JAX engine's: the shapes its programs are
  called with, recorded on the instance, and the job count.
* `serve.build` starts the background precompile under TARS_PRECOMPILE, as
  the JAX server does.
"""

import dataclasses

import numpy as np
import pytest
import torch

from indextts_tpu_torch.runtime.engine import EmotionConditioning, next_bucket
from test_torch_s2mel_graph import _inputs, _port, _request
from test_torch_slice import _free_port
from torch_parity import parity_config, parity_params, speech_like, to_port_config


@pytest.fixture(scope="module")
def setup():
    cfg = parity_config()
    return cfg, parity_params(cfg, seed=1)


def _noise():
    """A CFM noise hook: one seeded draw per shape, the same for every
    engine that asks."""
    noises, rng = {}, np.random.default_rng(5)

    def noise(shape):
        if shape not in noises:
            noises[shape] = rng.standard_normal(shape).astype(np.float32)
        return noises[shape]

    return noise


def test_default_route_waveform_matches_jax(setup):
    """Both engines at their default: the JAX engine pads the exact-length
    mel to the s2mel bucket with log(1e-5), vocodes the bucket and cuts the
    waveform; the port must give the same waveform to its last sample."""
    from indextts_tpu.runtime.engine import IndexTTS2Engine as JaxEngine

    cfg, jp = setup
    noise = _noise()
    jc, jm, jw, _ = _request(JaxEngine(cfg, jp), 0, noise)
    pc, pm, pw, _ = _request(_port(cfg, jp), 0, noise)
    np.testing.assert_array_equal(pc, jc)
    assert jm.shape[2] % 128  # the vocoder ran on padding
    assert pw.shape == jw.shape
    peak = np.abs(jw).max()
    assert 0 < peak < 1.0  # off the clip, or the check says nothing
    assert np.abs(pw - jw).max() <= 1e-3 * peak


def _speaker(eng):
    spk = eng.prepare_speaker(_inputs()[0], 16000)
    emovec, _ = eng.segment_conds(spk, EmotionConditioning(spk.spk_cond_emb, spk.cond_len))
    return spk, emovec


@pytest.mark.parametrize("n,code_len", [(9, 23), (9, 64), (32, 1)])
def test_latent_pass_buckets_match_exact(setup, n, code_len):
    """The bucketed latent pass's first code_len rows are the exact-shape
    pass's: the padding is masked."""
    cfg, jp = setup
    eng = _port(cfg, jp)
    spk, emovec = _speaker(eng)
    rng = np.random.default_rng(n + code_len)
    text = rng.integers(2, 50, n)
    codes = rng.integers(0, cfg.gpt.start_mel_token, code_len)
    latent, codes_t = eng._latent_pass(spk, emovec, text, codes, code_len)
    assert latent.shape[1] == codes_t.shape[1] == next_bucket(code_len, 64, 64)
    assert (codes_t[0, code_len:] == cfg.gpt.stop_mel_token).all()
    with torch.inference_mode():
        want = eng.gpt.forward_latent(
            spk.spk_latents, torch.as_tensor(text[None]), torch.tensor([n]),
            torch.as_tensor(codes[None]), torch.tensor([code_len]), emovec)
    err = (latent[:, :code_len] - want).abs().max()
    assert err <= 1e-5 * want.abs().max()


def test_code_padding_past_the_codebook():
    """With a codebook that ends before the stop token (as at full width:
    8192 codes, stop 8193), the stage still runs, and its mel is the one
    that padding with code 0 gives: no padded row is read."""
    from indextts_tpu_torch.runtime.engine import IndexTTS2Engine, random_params

    pcfg = to_port_config(parity_config())
    stop = pcfg.gpt.stop_mel_token
    pcfg = dataclasses.replace(pcfg, semantic_codec=dataclasses.replace(
        pcfg.semantic_codec, codebook_size=stop - 1))
    eng = IndexTTS2Engine(pcfg, random_params(pcfg, seed=0, device="cpu"), device="cpu")
    spk, emovec = _speaker(eng)
    code_len = 23
    codes = np.random.default_rng(0).integers(0, stop - 1, code_len)
    latent, codes_t = eng._latent_pass(spk, emovec, np.arange(2, 11), codes, code_len)
    target = next_bucket(int(code_len * 1.72), 128, 128)
    noise = torch.randn((1, 80, spk.ref_mel_len + target),
                        generator=torch.Generator().manual_seed(0))
    zero_pad = codes_t.clone()
    zero_pad[:, code_len:] = 0
    got, want = (eng._s2mel_mel(spk, latent, c, code_len, target, noise)
                 for c in (codes_t, zero_pad))
    assert torch.equal(got, want) and torch.isfinite(got).all()


def test_precompile_grid_matches_jax(setup):
    """The JAX engine's precompile with its programs wrapped on the instance
    to record the shapes they are called with (and to return nothing): the
    port's grid gives the same (latent text width, code width) pairs, (code
    bucket, solve width, code length) triples, vocoder widths and decode
    buckets, and the port's precompile the same job count."""
    from indextts_tpu.runtime.engine import IndexTTS2Engine as JaxEngine
    from indextts_tpu.runtime.engine import SpeakerConditioning as JaxSpeaker

    from indextts_tpu_torch.runtime.engine import SpeakerConditioning, precompile_grid

    cfg, jp = setup
    je = JaxEngine(cfg, jp)
    seen = {"latent": [], "s2mel": [], "vocoder": [], "decode": []}

    def record(name, shape_of):
        def program(*args, **kw):
            seen[name].append(shape_of(*args, **kw))
        return program

    je._emovec_program = je._build_conds_program = lambda *a, **kw: None
    je._latent_program = record("latent", lambda p, lat, text, tl, codes, cl, ev: (
        text.shape[1], codes.shape[1]))
    je._s2mel_program = record("s2mel", lambda p, pr, lat, codes, cl, *rest, target_len,
                               total_len: (codes.shape[1], total_len, int(cl[0])))
    je._vocoder_f32_program = je._vocoder_pcm16_f32_program = record(
        "vocoder", lambda p, mel: mel.shape[2])
    je.decoder.generate = record("decode", lambda p, conds, ids, *rest, **kw: ids.shape[1] - 2)
    ref, D = 37, cfg.gpt.model_dim
    z = np.zeros
    jspk = JaxSpeaker(z((1, 20, 1024), np.float32), 20, z((1, 192), np.float32),
                      z((1, ref, 512), np.float32), z((1, 80, ref), np.float32), ref,
                      z((1, 32, D), np.float32))
    pe = _port(cfg, jp)
    pspk = SpeakerConditioning(*(torch.as_tensor(a) if isinstance(a, np.ndarray) else a
                                 for a in dataclasses.astuple(jspk)))
    code_lens = [5, 40, 70, 75, 130]
    for kw in (dict(text_buckets=[16, 48], code_lens=code_lens, decode_variants="none"),
               dict(code_lens=code_lens, decode_variants="raw")):
        for v in seen.values():
            v.clear()
        n_jax = je.precompile(jspk, workers=1, **kw)
        grid = precompile_grid(cfg.gpt.max_text_tokens, cfg.runtime.max_text_tokens_per_segment,
                               kw.get("text_buckets"), code_lens=code_lens)
        assert seen["latent"] == grid.latent
        assert seen["s2mel"] == [(cb, ref + tb, cl) for cb, tb, cl in grid.s2mel]
        assert seen["vocoder"] == grid.vocoder
        decode = seen["decode"]
        assert decode == ([] if kw["decode_variants"] == "none" else grid.text_buckets)
        assert pe.precompile(pspk, **kw) == n_jax
    assert grid.s2mel == [(64, 128, 5), (128, 128, 70), (128, 256, 75), (192, 256, 130)]
    assert grid.text_buckets == [16, 32] and grid.latent[0] == (32, 64)


def test_serve_starts_precompile(tmp_path, monkeypatch):
    """serve.build with a default prompt starts the background precompile
    (TARS_PRECOMPILE, default on): its future gives the engine's job count
    over TARS_PRECOMPILE_CODES codes, without decode in continuous mode;
    TARS_PRECOMPILE=0 starts none."""
    from indextts_tpu_torch import serve
    from indextts_tpu_torch.runtime.engine import precompile_grid
    from indextts_tpu_torch.utils import audio as audio_utils

    monkeypatch.setenv("TARS_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setenv("TARS_WARMUP", "0")
    monkeypatch.delenv("TARS_PRECOMPILE", raising=False)
    monkeypatch.setenv("TARS_PRECOMPILE_CODES", "130")
    wav_path = str(tmp_path / "spk.wav")
    audio_utils.save_wav(wav_path, speech_like(np.random.default_rng(1), 1.0, 16000), 16000)
    argv = ["--host", "127.0.0.1", "--port", str(_free_port()), "--device", "cpu",
            "--reference-audio", wav_path]
    server, engine = serve.build(argv, cfg=to_port_config(parity_config()))
    rt = engine.cfg.runtime
    grid = precompile_grid(engine.cfg.gpt.max_text_tokens, rt.max_text_tokens_per_segment,
                           max_code_len=130)
    tail = len(grid.latent) + len(grid.s2mel) + len(grid.vocoder)
    assert server.precompiled.result(timeout=120)[0] == len(grid.text_buckets) + tail
    monkeypatch.setenv("TARS_MAX_CONCURRENCY", "4")
    server, _ = serve.build(argv, engine=engine)
    try:
        assert server.service is not None
        assert server.precompiled.result(timeout=120)[0] == tail
    finally:
        server.service.shutdown()
    monkeypatch.setenv("TARS_PRECOMPILE", "0")
    monkeypatch.delenv("TARS_MAX_CONCURRENCY")
    server, _ = serve.build(argv, engine=engine)
    assert server.precompiled is None
