"""The port's models against the JAX package, one model at a time.

Same numpy parameters (tests/torch_parity.py) and the same numpy inputs go
through the JAX engine's own programs (`precise_shapes=True`, CPU, XLA
paths) and through the port's modules on the CPU. Tolerances are relative
to the largest reference value: float32 on both sides, summed in another
order by XLA and by PyTorch's CPU kernels, so a few ulps per reduction
grow with depth; each test states its bound.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from indextts_tpu_torch.weights import from_jax_params
from torch_parity import (
    n,
    parity_config,
    parity_params,
    speech_like,
    t,
    to_port_config,
)


def assert_rel(got, want, rel, what=""):
    got, want = n(got), n(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= rel * scale, f"{what}: max|err| {err:.3g} > {rel} x {scale:.3g}"


@pytest.fixture(scope="module")
def pair():
    from indextts_tpu.runtime.engine import IndexTTS2Engine as JaxEngine

    from indextts_tpu_torch.runtime.engine import IndexTTS2Engine

    cfg = parity_config()
    jp = parity_params(cfg)
    pcfg = to_port_config(cfg)
    je = JaxEngine(cfg, jp, precise_shapes=True)
    pe = IndexTTS2Engine(pcfg, from_jax_params(jp, pcfg), device="cpu")
    return cfg, je, pe


@pytest.fixture(scope="module")
def cond_emb(pair):
    """w2v-BERT features of a 1-s prompt, from the JAX package."""
    from indextts_tpu.frontend import features as jfeat

    _, je, _ = pair
    audio = speech_like(np.random.default_rng(0), 1.0, 16000)
    f, m = jfeat.seamless_features(audio)
    h = je._w2v_program(je.p_w2vbert, jnp.asarray(f), jnp.asarray(m),
                        je.semantic_mean, je.semantic_std)
    return audio, np.asarray(h), int(m.sum())


def test_features_copy_matches(pair):
    """The port's copy of the numpy frontend gives the same features."""
    from indextts_tpu.frontend import features as jfeat

    from indextts_tpu_torch.frontend import features as pfeat

    audio = speech_like(np.random.default_rng(1), 0.7, 16000)
    (jf, jm), (pf, pm) = jfeat.seamless_features(audio), pfeat.seamless_features(audio)
    np.testing.assert_array_equal(pm, jm)
    np.testing.assert_allclose(pf, jf, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(pfeat.campplus_fbank(audio), jfeat.campplus_fbank(audio),
                               rtol=1e-5, atol=1e-4)


def test_w2vbert_matches(pair, cond_emb):
    """Two conformer layers of w2v-BERT 2.0 plus the semantic normalization:
    1e-4 of the largest feature."""
    _, _, pe = pair
    audio, want, length = cond_emb
    with torch.inference_mode():
        got, got_len = pe._w2v(audio)
    assert got_len == length
    assert_rel(got, want, 1e-4, "w2v-BERT")


def test_repcodec_codes_exact(pair, cond_emb):
    """RepCodec quantize: code ids exact; embeddings and vq2emb 1e-5."""
    _, je, pe = pair
    h = cond_emb[1]
    jcodes, jemb = je._quantize_program(je.p_repcodec, jnp.asarray(h))
    with torch.inference_mode():
        codes, emb = pe.repcodec.quantize(t(h))
        back = pe.repcodec.vq2emb(t(np.asarray(jcodes), torch.long))
    np.testing.assert_array_equal(n(codes), np.asarray(jcodes))
    assert_rel(emb, jemb, 1e-5, "quantized embedding")
    assert_rel(back, jemb, 1e-5, "vq2emb")


def test_campplus_matches(pair, cond_emb):
    """CAMPPlus style vector over the kaldi fbank: 1e-4 (52 TDNN layers)."""
    from indextts_tpu.frontend import features as jfeat

    _, je, pe = pair
    fb = jfeat.campplus_fbank(cond_emb[0])
    fb = (fb - fb.mean(axis=0, keepdims=True))[None]
    want = je._campplus_program(je.p_campplus, jnp.asarray(fb))
    with torch.inference_mode():
        got = pe.campplus(t(fb))
    assert_rel(got, want, 1e-4, "CAMPPlus")


def test_mel_matches(pair):
    """22.05 kHz 80-band log-mel: 1e-5 of the largest |log-mel|."""
    from indextts_tpu.ops import mel as jmel

    from indextts_tpu_torch.ops import mel as pmel

    cfg, _, _ = pair
    y = speech_like(np.random.default_rng(2), 0.5, 22050)[None]
    want = jmel.mel_spectrogram(jnp.asarray(y), cfg.s2mel.mel)
    got = pmel.mel_spectrogram(t(y), to_port_config(cfg.s2mel.mel))
    assert got.shape[-1] == pmel.mel_frame_count(y.shape[1], cfg.s2mel.mel)
    assert_rel(got, want, 1e-5, "mel")


def _lens_batch(rng, lens, T, D=1024):
    x = rng.standard_normal((len(lens), T, D)).astype(np.float32)
    return x, np.asarray(lens, np.int32)


def test_conformer_and_perceiver_match(pair):
    """Speaker and emotion conditioning encoders on a padded batch: the
    conformer output on valid frames, its mask, the perceiver latents, the
    emotion vector and the conds latent, 1e-4."""
    _, je, pe = pair
    x, lens = _lens_batch(np.random.default_rng(3), [40, 23], 40)
    jenc, jmask = jax.jit(lambda p, a, b: je.gpt.apply(
        {"params": p}, a, b, method=lambda m, a, b: m.conditioning_encoder(a, b)))(
        je.p_gpt, jnp.asarray(x), jnp.asarray(lens))
    jlat = je._conds_program(je.p_gpt, jnp.asarray(x), jnp.asarray(lens))
    jemo = je._emovec_program(je.p_gpt, jnp.asarray(x[:1]), jnp.asarray(x[1:]),
                              jnp.asarray(lens[:1]), jnp.asarray(lens[1:]), jnp.float32(0.6))
    jconds = je._build_conds_program(je.p_gpt, jlat[:1], jemo)
    g = pe.gpt
    with torch.inference_mode():
        enc, mask = g.conditioning_encoder(t(x), t(lens, torch.long))
        lat = g.get_conditioning(t(x), t(lens, torch.long))
        emo = g.merge_emovec(t(x[:1]), t(x[1:]), t(lens[:1], torch.long),
                             t(lens[1:], torch.long), 0.6)
        conds = g.build_conds_latent(lat[:1], emo)
    np.testing.assert_array_equal(n(mask), np.asarray(jmask))
    m = np.asarray(jmask)[..., None]
    assert_rel(n(enc) * m, np.asarray(jenc) * m, 1e-4, "conformer")
    assert_rel(lat, jlat, 1e-4, "perceiver latents")
    assert_rel(emo, jemo, 1e-4, "merged emovec")
    assert_rel(conds, jconds, 1e-4, "conds latent")


def test_gpt_prefill_logits_and_latent_match(pair):
    """GPT2Core + UnifiedVoice on a right-aligned, left-padded prompt:
    last-position mel logits after prefill, and the teacher-forced latent
    pass (forward_latent), 1e-4."""
    cfg, je, pe = pair
    rng = np.random.default_rng(4)
    D = cfg.gpt.model_dim
    conds = rng.standard_normal((1, 34, D)).astype(np.float32)
    text = rng.integers(2, 50, 9)
    ids, pos, valid = je.decoder.build_text_prompt_arrays(text[None], np.array([9]), 13)
    pids, ppos, pvalid = pe.decoder.build_text_prompt_arrays(text[None], np.array([9]), 13)
    np.testing.assert_array_equal(pids, ids)
    np.testing.assert_array_equal(pvalid, valid)

    def jprefill(m, c, i, ps, v):
        emb = jnp.concatenate([c, m.embed_text_prompt(i, ps, v), m.embed_mel_start(1)], axis=1)
        mask = jnp.concatenate([jnp.ones((1, 34), bool), v, jnp.ones((1, 1), bool)], axis=1)
        hidden = m.gpt_prefill(emb, mask)[0]
        return m.mel_logits_from_hidden(hidden[:, -1])

    want = jax.jit(lambda p, *a: je.gpt.apply({"params": p}, *a, method=jprefill))(
        je.p_gpt, jnp.asarray(conds), jnp.asarray(ids), jnp.asarray(pos), jnp.asarray(valid))
    from indextts_tpu_torch.runtime.decode import cache_cap

    with torch.inference_mode():
        st = pe.decoder.prefill(t(conds), t(pids), t(ppos), t(pvalid), max_new=4)
    S = int(st.start)
    assert S == 34 + 13 + 2 + 1
    assert st.caches[0].shape == (cfg.gpt.layers, 1, cfg.gpt.heads, cache_cap(S, 4),
                                  D // cfg.gpt.heads)
    assert_rel(st.logits, want, 1e-4, "prefill logits")

    spk = rng.standard_normal((1, 32, D)).astype(np.float32)
    emovec = rng.standard_normal((1, D)).astype(np.float32)
    codes = rng.integers(0, 34, (1, 12))
    jl = je._latent_program(je.p_gpt, jnp.asarray(spk), jnp.asarray(text[None]),
                            jnp.asarray([9]), jnp.asarray(codes), jnp.asarray([10]),
                            jnp.asarray(emovec))
    with torch.inference_mode():
        pl = pe.gpt.forward_latent(t(spk), t(text[None], torch.long), t([9]),
                                   t(codes, torch.long), t([10]), t(emovec))
    assert_rel(pl, jl, 1e-4, "forward_latent")


def _s2mel_inputs(cfg, rng, B=2, T=48, lens=(48, 31)):
    c = cfg.s2mel
    return dict(
        x=rng.standard_normal((B, c.dit.in_channels, T)).astype(np.float32),
        prompt_x=rng.standard_normal((B, c.dit.in_channels, T)).astype(np.float32),
        x_lens=np.asarray(lens, np.int32),
        t=np.asarray([0.3, 0.75][:B], np.float32),
        style=rng.standard_normal((B, c.dit.style_dim)).astype(np.float32),
        cond=rng.standard_normal((B, T, c.length_regulator.channels)).astype(np.float32),
    )


def test_dit_velocity_matches(pair):
    """DiT + WaveNet velocity (RoPE, AdaLN, SwiGLU, uvit skips, the
    reflect-pad quirk) on a batch with one partial key mask, 1e-4."""
    from indextts_tpu.models.s2mel import S2Mel as JS2Mel

    cfg, je, pe = pair
    a = _s2mel_inputs(cfg, np.random.default_rng(5))
    want = jax.jit(lambda p, *v: je.s2mel.apply({"params": p}, *v, method=JS2Mel.velocity))(
        je.p_s2mel, *(jnp.asarray(v) for v in a.values()))
    with torch.inference_mode():
        got = pe.s2mel.velocity(*(t(v) for v in a.values()))
    assert_rel(got, want, 1e-4, "DiT velocity")


def test_regulator_and_gpt_layer_match(pair):
    """InterpolateRegulator (nearest grid over valid input frames, masked
    GroupNorm) and the gpt_layer projection, 1e-5."""
    from indextts_tpu.runtime.s2mel_infer import length_regulate, project_gpt_latent

    from indextts_tpu_torch.runtime import s2mel_infer

    cfg, je, pe = pair
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 12, cfg.s2mel.length_regulator.in_channels)).astype(np.float32)
    ylens, xlens = np.array([20, 13], np.int32), np.array([12, 7], np.int32)
    p = {"params": je.p_s2mel}
    want = length_regulate(je.s2mel, p, jnp.asarray(x), jnp.asarray(ylens), 24,
                           jnp.asarray(xlens))
    got = s2mel_infer.length_regulate(pe.s2mel, t(x), t(ylens, torch.long), 24,
                                      t(xlens, torch.long))
    assert_rel(got, want, 1e-5, "regulator")
    lat = rng.standard_normal((1, 10, cfg.gpt.model_dim)).astype(np.float32)
    assert_rel(s2mel_infer.project_gpt_latent(pe.s2mel, t(lat)),
               project_gpt_latent(je.s2mel, p, jnp.asarray(lat)), 1e-5, "gpt_layer")


def test_cfm_inference_matches(pair):
    """Euler solve with CFG stacked to 2B and injected noise, 4 steps, 1e-4."""
    from indextts_tpu.runtime.s2mel_infer import cfm_inference as jcfm

    from indextts_tpu_torch.runtime.s2mel_infer import cfm_inference

    cfg, je, pe = pair
    rng = np.random.default_rng(7)
    a = _s2mel_inputs(cfg, rng, B=1, T=40, lens=(37,))
    prompt_x = a["prompt_x"].copy()
    prompt_x[:, :, 15:] = 0.0
    noise = rng.standard_normal(a["x"].shape).astype(np.float32)
    want = jcfm(je.s2mel, {"params": je.p_s2mel}, jnp.asarray(a["cond"]),
                jnp.asarray(a["x_lens"]), jnp.asarray(prompt_x), jnp.asarray(15),
                jnp.asarray(a["style"]), jnp.asarray(noise), n_steps=4, cfg_rate=0.7)
    got = cfm_inference(pe.s2mel, t(a["cond"]), t(a["x_lens"], torch.long), t(prompt_x),
                        15, t(a["style"]), t(noise), n_steps=4, cfg_rate=0.7)
    assert_rel(got, want, 1e-4, "CFM")


# resblocks of differing dilations (and kernel sizes), which run one at a
# time on both sides
DIFFERING = dict(resblock_kernel_sizes=(3, 5, 3), resblock_dilation_sizes=((1, 3), (1, 2),
                                                                            (2, 5)))


def _differing_vocoders():
    """JAX BigVGAN and the port's on the same converted weights, at the tiny
    vocoder with DIFFERING resblocks: (JAX apply fn, port model)."""
    import dataclasses

    from indextts_tpu.models.bigvgan import BigVGAN as JBigVGAN

    from indextts_tpu_torch.runtime.engine import load_model

    cfg = parity_config()
    cfg = dataclasses.replace(cfg, vocoder=dataclasses.replace(cfg.vocoder, **DIFFERING))
    pcfg = to_port_config(cfg)
    jp = parity_params(cfg)
    jm = JBigVGAN(cfg.vocoder)
    model = load_model("bigvgan", pcfg, from_jax_params(jp, pcfg)["bigvgan"], "cpu")
    assert not model.lockstep
    return lambda mel: jm.apply({"params": jp["bigvgan"]}, mel), model


@pytest.mark.parametrize("resblocks", ["release", "differing"])
def test_bigvgan_matches(pair, resblocks):
    """BigVGAN v2 (AMPBlock1, ConvTranspose trim, conv_post clip) with the
    waveform off the clip (tests/torch_parity.py): the tiny config's
    resblocks in lockstep (one wide activation), and resblocks of
    differing dilations one at a time, against the JAX BigVGAN; and, on
    the first, on-device PCM16. Waveform 1e-4 of its peak; PCM16 within one
    step."""
    from indextts_tpu_torch.models.bigvgan import to_pcm16

    _, je, pe = pair
    mel = np.random.default_rng(8).standard_normal((1, 80, 12)).astype(np.float32)
    if resblocks == "differing":
        jfn, model = _differing_vocoders()
        want = np.asarray(jfn(jnp.asarray(mel)))
    else:
        model = pe.bigvgan
        want = np.asarray(je._vocoder_program(je.p_bigvgan, jnp.asarray(mel)))
    assert 0 < np.abs(want).max() < 1.0
    with torch.inference_mode():
        got = model(t(mel))
    assert_rel(got, want, 1e-4, "BigVGAN")
    if resblocks == "release":
        jpcm = np.asarray(je._vocoder_pcm16_program(je.p_bigvgan, jnp.asarray(mel)))
        assert np.abs(n(to_pcm16(got)).astype(np.int32) - jpcm).max() <= 1


def test_bigvgan_runs_each_stage_in_lockstep(pair):
    """Every stage runs its resblocks through one wide activation per conv:
    2 per dilation per stage plus the post activation (BigVGAN v2 at full
    width: 6 x 3 x 2 + 1 = 37). Resblocks whose dilations differ run one at
    a time: 2 activations per dilation per resblock per stage, each over
    one resblock's channels (6 x 3 x 3 x 2 + 1 = 109 at full width)."""
    from indextts_tpu_torch.config import BigVGANConfig
    from indextts_tpu_torch.models.bigvgan import BigVGAN
    from indextts_tpu_torch.ops import snake

    cfg, _, pe = pair
    voc = cfg.vocoder
    before = snake.counter.launches
    calls = []
    orig = snake.anti_alias_snake_plain

    def spy(x, a, b, logscale=True):
        calls.append(x.shape[1])
        return orig(x, a, b, logscale)

    _, differing = _differing_vocoders()
    snake.anti_alias_snake_plain = spy
    try:
        with torch.inference_mode():
            pe.bigvgan(torch.zeros((1, 80, 4)))
            n_lockstep = len(calls)
            differing(torch.zeros((1, 80, 4)))
    finally:
        snake.anti_alias_snake_plain = orig
    assert snake.counter.launches == before  # no kernel launch on the CPU
    n_dil = len(voc.resblock_dilation_sizes[0])
    assert n_lockstep == len(voc.upsample_rates) * n_dil * 2 + 1
    G = len(voc.resblock_kernel_sizes)
    assert calls[0] == G * voc.upsample_initial_channel // 2
    dils = DIFFERING["resblock_dilation_sizes"]
    assert len(calls) - n_lockstep == len(voc.upsample_rates) * sum(map(len, dils)) * 2 + 1
    assert calls[n_lockstep] == voc.upsample_initial_channel // 2
    full = BigVGANConfig()
    assert len(full.upsample_rates) * len(full.resblock_dilation_sizes[0]) * 2 + 1 == 37
    with torch.device("meta"):
        assert BigVGAN(full).lockstep
        assert not BigVGAN(BigVGANConfig(resblock_dilation_sizes=((1, 3, 5), (1, 2, 4),
                                                                  (2, 3, 6)))).lockstep
