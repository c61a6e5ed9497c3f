"""The port's IndexTTS v1 family (UnifiedVoice v1, ECAPA-TDNN, BigVGAN v1, the
DVAE and IndexTTSV1Engine) against the JAX package's, on the CPU.

The same numpy inputs go through the JAX function and the port at the tiny
configs of tests/test_engine_v1.py (GPT_TINY, VOC_TINY). Weights: the
port's own random_params_v1 (PyTorch's initialization, positive BatchNorm
statistics), read into the JAX trees by the JAX converters and carried back
by weights.py, so both sides hold the same float32 values. The port runs
its kernels' plain versions (CPU tensors); the JAX side's Pallas kernels
run in interpret mode.

Tolerances: the v1 mel, ECAPA, BigVGAN v1, get_conditioning and
forward_latent within 1e-5 (float32 sums in another order); greedy decode
token-exact in float32, and on the W8 + int8 KV + int8 head route on a
weights' seed whose greedy path has no near tie; sampled decode held to the
JAX warper chain's distribution (the kept logits within 1e-5, every draw
among the kept tokens, 600 draws within 0.12 in total variation);
converters to the bit; `infer_fast` the same codes and the waveform within
1e-4 (device_pcm16 off) or one PCM16 step (on).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from indextts_tpu_torch import weights
from indextts_tpu_torch.models.bigvgan_v1 import BigVGANv1Config
from test_engine_v1 import GPT_TINY, VOC_TINY
from torch_parity import n, t, to_port_config

PCFG = to_port_config(GPT_TINY)
PVOC = BigVGANv1Config(**dataclasses.asdict(VOC_TINY))


def np_sd(sd):
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def with_text_head(sd, cfg, seed: int = 3):
    """A GPT state dict with the seeded text_head the reference carries."""
    g = torch.Generator().manual_seed(seed)
    v = cfg.number_text_tokens + 1
    return dict(sd, **{"text_head.weight": torch.randn(v, cfg.model_dim, generator=g),
                       "text_head.bias": torch.randn(v, generator=g)})


def jax_trees(gcfg, seed: int):
    """(JAX v1 GPT tree, JAX BigVGANv1 tree, the port's state dicts) of the
    port's random_params_v1(seed) at (gcfg, VOC_TINY)."""
    from indextts_tpu.runtime import torch_convert as jtc

    from indextts_tpu_torch.runtime.engine_v1 import random_params_v1

    sds = random_params_v1(to_port_config(gcfg), PVOC, seed=seed, device="cpu")
    jg = jtc.convert_unified_voice_v1(np_sd(with_text_head(sds["gpt"], gcfg)), gcfg)
    jv = jtc.convert_bigvgan_v1(np_sd(sds["bigvgan"]), VOC_TINY)
    return jg, jv, {"gpt": weights.unified_voice_v1_sd(jg, to_port_config(gcfg)),
                    "bigvgan": weights.bigvgan_v1_sd(jv, PVOC)}


@pytest.fixture(scope="module")
def trees():
    return jax_trees(GPT_TINY, seed=0)


@pytest.fixture(scope="module")
def port_gpt(trees):
    from indextts_tpu_torch.models.unified_voice_v1 import UnifiedVoiceV1

    m = UnifiedVoiceV1(PCFG)
    m.load_state_dict(trees[2]["gpt"])
    return m.eval().requires_grad_(False)


# ---------------------------------------------------------------------------
# the v1 mel and the reflect pad
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,pad", [(10, 3), (3, 4), (2, 5), (1, 2), (5, 12)])
def test_reflect_pad_matches_jnp(T, pad):
    """reflect_pad equals jnp.pad(mode="reflect"), also where the pad
    reaches past the input, where F.pad raises."""
    from indextts_tpu_torch.models.layers import reflect_pad

    x = np.random.default_rng(T).standard_normal((2, 3, T)).astype(np.float32)
    want = np.asarray(jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), (pad, pad)), mode="reflect"))
    np.testing.assert_array_equal(n(reflect_pad(t(x), pad)), want)


@pytest.mark.parametrize("samples", [24000, 4097, 300])
def test_mel_spectrogram_v1_matches_jax(samples):
    """The 100-bin 24 kHz conditioning mel (HTK, no norm, power 1, log clip
    1e-7), within 1e-5; 300 samples is shorter than the centre pad."""
    from indextts_tpu.config import MelConfig as JMel
    from indextts_tpu.ops.mel import mel_spectrogram_v1 as jmel

    from indextts_tpu_torch.config import MelConfig
    from indextts_tpu_torch.ops.mel import mel_spectrogram_v1

    kw = dict(sample_rate=24000, n_fft=1024, hop_length=256, win_length=1024, n_mels=100)
    rng = np.random.default_rng(samples)
    y = (0.3 * rng.standard_normal((2, samples))).astype(np.float32)
    y[1, : samples // 3] = 0.0  # silent frames reach the clip
    want = np.asarray(jmel(jnp.asarray(y), JMel(**kw)))
    got = n(mel_spectrogram_v1(t(y), MelConfig(**kw)))
    assert got.shape == want.shape == (2, 100, samples // 256 + 1)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# ECAPA-TDNN, BigVGAN v1
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("frames", [37, 3])
def test_ecapa_matches_jax(trees, frames):
    """The speaker embedding (B, 1, 16) within 1e-5; at 3 frames every
    dilated convolution's reflect pad (up to 4) reaches past the input."""
    from indextts_tpu.models.ecapa import ECAPA_TDNN as JECAPA

    from indextts_tpu_torch.models.ecapa import ECAPA_TDNN

    c = VOC_TINY
    kw = dict(lin_neurons=c.speaker_embedding_dim, channels=c.ecapa_channels,
              attention_channels=c.ecapa_attention_channels,
              res2net_scale=c.ecapa_res2net_scale, se_channels=c.ecapa_se_channels)
    jt = trees[1]["speaker_encoder"]
    m = ECAPA_TDNN(c.num_mels, **kw)
    m.load_state_dict(weights.ecapa_sd(jt))
    x = np.random.default_rng(frames).standard_normal((2, frames, 100)).astype(np.float32)
    want = np.asarray(JECAPA(c.num_mels, **kw).apply({"params": jt}, jnp.asarray(x)))
    with torch.no_grad():
        got = n(m.eval()(t(x)))
    assert got.shape == want.shape == (2, 1, c.speaker_embedding_dim)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("T", [1, 2, 5, 8])
def test_feat_upsample_is_the_jax_formula(T):
    """F.interpolate(linear, x4, align_corners=False) equals the JAX
    module's explicit formula, edges included (bigvgan_v1.py:66-73)."""
    x = np.random.default_rng(T).standard_normal((2, T, 3)).astype(np.float32)
    pos = (np.arange(4 * T) + 0.5) / 4.0 - 0.5
    lo = np.clip(np.floor(pos).astype(np.int64), 0, T - 1)
    hi = np.clip(lo + 1, 0, T - 1)
    w = np.clip(pos - lo, 0.0, 1.0)[None, :, None].astype(np.float32)
    want = x[:, lo] * (1 - w) + x[:, hi] * w
    got = torch.nn.functional.interpolate(t(x).transpose(1, 2), scale_factor=4,
                                          mode="linear", align_corners=False).transpose(1, 2)
    np.testing.assert_allclose(n(got), want, atol=1e-6)


def test_bigvgan_v1_matches_jax(trees):
    """latents (2, 7, 64) (odd T, upsampled 4x) and a 30-frame reference
    mel -> (2, 7168), within 1e-5; the stages run in lockstep only where
    the dilations agree (VOC_TINY has one resblock a stage)."""
    from indextts_tpu.models.bigvgan_v1 import BigVGANv1 as JV

    from indextts_tpu_torch.models.bigvgan_v1 import BigVGANv1

    m = BigVGANv1(PVOC)
    m.load_state_dict(trees[2]["bigvgan"])
    rng = np.random.default_rng(1)
    lat = rng.standard_normal((2, 7, 64)).astype(np.float32)
    ref = rng.standard_normal((2, 30, 100)).astype(np.float32)
    want = np.asarray(JV(VOC_TINY).apply({"params": trees[1]}, jnp.asarray(lat),
                                         jnp.asarray(ref)))
    with torch.no_grad():
        got = n(m.eval()(t(lat), t(ref)))
    assert got.shape == want.shape == (2, 7 * 4 * 256)
    assert 1e-3 < np.abs(want).max() < 0.99
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_bigvgan_v1_release_config_runs_k2_in_lockstep():
    """The release config's three resblocks share (1, 3, 5): 6 stages x 3
    dilations x 2 + 1 = 37 K2 calls a vocoder call, as in v2."""
    from indextts_tpu_torch.models import bigvgan as bv
    from indextts_tpu_torch.models.bigvgan_v1 import BigVGANv1

    cfg = dataclasses.replace(BigVGANv1Config(), gpt_dim=16, upsample_initial_channel=64,
                              speaker_embedding_dim=8, ecapa_channels=(8, 8, 8, 8, 24),
                              ecapa_attention_channels=4, ecapa_se_channels=4)
    m = BigVGANv1(cfg).eval()
    assert m.lockstep
    calls = []
    real = bv.anti_alias_snake

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    bv.anti_alias_snake = spy
    try:
        with torch.no_grad():
            out = m(torch.randn(1, 2, 16), torch.randn(1, 12, 100))
    finally:
        bv.anti_alias_snake = real
    assert len(calls) == 37 and out.shape == (1, 2 * 4 * 256)
    assert calls[0][1] == 3 * 32  # three groups of 32 channels in one call


# ---------------------------------------------------------------------------
# UnifiedVoice v1
# ---------------------------------------------------------------------------


def test_conditioning_and_latent_match_jax(trees, port_gpt):
    """get_conditioning (B, 32, D) and forward_latent (wav lengths in
    samples, text and codes past their lengths replaced by stop tokens)
    within 1e-5."""
    from indextts_tpu.models.unified_voice_v1 import UnifiedVoiceV1 as JUV

    rng = np.random.default_rng(2)
    mel = rng.standard_normal((2, 45, 100)).astype(np.float32)
    ml = np.array([45, 30])
    jm, p = JUV(GPT_TINY), {"params": trees[0]}
    want = np.asarray(jm.apply(p, jnp.asarray(mel), jnp.asarray(ml),
                               method=JUV.get_conditioning))
    with torch.no_grad():
        got = n(port_gpt.get_conditioning(t(mel), t(ml)))
    assert got.shape == want.shape == (2, 32, 64)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)

    text = rng.integers(2, 50, (2, 6))
    codes = rng.integers(0, 34, (2, 9))
    args = (mel, ml, text, np.array([6, 4]), codes, np.array([9 * 1024, 5 * 1024 - 100]))
    want = np.asarray(jm.apply(p, *(jnp.asarray(a) for a in args),
                               method=JUV.forward_latent))
    with torch.no_grad():
        got = n(port_gpt.forward_latent(*(t(a) for a in args)))
    assert got.shape == want.shape == (2, 9, 64)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def three_rows(rng):
    """Three texts of unequal length, right-aligned at the longest."""
    lens = np.array([7, 4, 10])
    text = np.zeros((3, 10), np.int64)
    for b, L in enumerate(lens):
        text[b, :L] = rng.integers(2, 50, L)
    return text, lens


def test_greedy_decode_token_exact(trees, port_gpt):
    """Greedy decode of 3 rows of unequal text over 32 conditioning
    positions: the same codes and lengths as JAX GPTDecoder over
    UnifiedVoiceV1, in float32."""
    from indextts_tpu.models.unified_voice_v1 import UnifiedVoiceV1 as JUV
    from indextts_tpu.runtime.decode import GPTDecoder as JDecoder
    from indextts_tpu.runtime.decode import SamplingConfig as JSampling

    from indextts_tpu_torch.runtime.decode import GPTDecoder, SamplingConfig

    rng = np.random.default_rng(4)
    conds = rng.standard_normal((3, 32, 64)).astype(np.float32)
    text, lens = three_rows(rng)
    jdec = JDecoder(JUV(GPT_TINY), GPT_TINY, JSampling(do_sample=False))
    want = jdec.generate({"params": trees[0]}, jnp.asarray(conds),
                         *(jnp.asarray(a) for a in jdec.build_text_prompt_arrays(text, lens, 10)),
                         jax.random.PRNGKey(0), max_new=20, temperature=1.0,
                         repetition_penalty=10.0)
    pdec = GPTDecoder(port_gpt, PCFG, SamplingConfig(do_sample=False))
    got = pdec.generate(t(conds), *(t(a) for a in pdec.build_text_prompt_arrays(text, lens, 10)),
                        None, max_new=20, temperature=1.0, repetition_penalty_value=10.0)
    assert len(set(np.asarray(want.codes).ravel().tolist())) > 6
    np.testing.assert_array_equal(n(got.codes), np.asarray(want.codes))
    np.testing.assert_array_equal(n(got.lengths), np.asarray(want.lengths))


def test_keyed_prefix_decode_over_32_positions(port_gpt):
    """The conditioning prefix's KV (cond_prefill of a (1, 32, D) conds)
    serves generate(cond_kv=...) at v1's width: the same greedy codes as
    the whole prompt's prefill."""
    from indextts_tpu_torch.runtime.decode import GPTDecoder, SamplingConfig

    rng = np.random.default_rng(6)
    conds = t(rng.standard_normal((1, 32, 64)).astype(np.float32))
    pdec = GPTDecoder(port_gpt, PCFG, SamplingConfig(do_sample=False))
    arrays = [t(a) for a in pdec.build_text_prompt_arrays(rng.integers(2, 50, (1, 6)),
                                                          np.array([6]), 6)]
    whole = pdec.generate(conds, *arrays, None, max_new=16)
    keyed = pdec.generate(conds, *arrays, None, max_new=16, cond_kv=pdec.cond_prefill(conds))
    assert pdec.cond_prefill(conds)[0].shape[3] == 32
    np.testing.assert_array_equal(n(keyed.codes), n(whole.codes))


def test_sampled_decode_follows_the_jax_warpers(trees, port_gpt, monkeypatch):
    """v1's sampling (temperature 1.0, top_p 0.8, top_k 30, penalty 10.0):
    the prompt's warped logits equal the JAX chain's within 1e-5, and 600
    first draws from the captured-step's generator land on the kept tokens
    with frequencies within 0.12 in total variation of the JAX softmax."""
    from indextts_tpu.models.unified_voice_v1 import UnifiedVoiceV1 as JUV
    from indextts_tpu.runtime import decode as jdecode

    from indextts_tpu_torch.runtime import decode as pdecode

    rng = np.random.default_rng(8)
    conds = rng.standard_normal((1, 32, 64)).astype(np.float32)
    text = rng.integers(2, 50, (1, 6))
    pdec = pdecode.GPTDecoder(port_gpt, PCFG, pdecode.SamplingConfig())
    ids, pos, valid = pdec.build_text_prompt_arrays(text, np.array([6]), 6)

    def prompt_logits(m, c, i, p, v):
        x = jnp.concatenate([c, m.embed_text_prompt(i, p, v), m.embed_mel_start(1)], axis=1)
        hidden, _ = m.gpt_prefill(x, jnp.ones(x.shape[:2], bool))
        return m.mel_logits_from_hidden(hidden[:, -1])

    jl = JUV(GPT_TINY).apply({"params": trees[0]}, jnp.asarray(conds), jnp.asarray(ids),
                             jnp.asarray(pos), jnp.asarray(valid), method=prompt_logits)
    penal = np.zeros((1, GPT_TINY.number_mel_codes), bool)
    penal[:, [1, GPT_TINY.start_mel_token]] = True
    seen = {}

    def categorical(key, vals, axis=-1):
        seen["vals"] = np.asarray(vals)
        return jnp.argmax(vals, axis=axis)

    monkeypatch.setattr(jdecode.jax.random, "categorical", categorical)
    jtok = jdecode._apply_top_k_top_p_sample(
        jdecode._repetition_penalty(jl, jnp.asarray(penal), 10.0), jax.random.PRNGKey(0),
        jnp.float32(1.0), jnp.float32(0.8), 30)
    with torch.inference_mode():
        st = pdec.prefill(t(conds), t(ids), t(pos), t(valid), max_new=4)
        pl = pdecode.repetition_penalty(st.logits.clone(), t(penal), 10.0)
    vals, idx = pdecode.warp_top_k_top_p(pl, 1.0, 0.8, 30)
    np.testing.assert_allclose(n(vals), seen["vals"], atol=1e-5, rtol=1e-5)
    assert int(n(idx)[0, n(vals)[0].argmax()]) == int(jtok[0])

    kept = n(idx)[0][seen["vals"][0] > -1e8]
    p = np.asarray(jax.nn.softmax(jnp.asarray(seen["vals"][0])))
    want = dict(zip(n(idx)[0].tolist(), p.tolist()))
    B = 600
    res = pdec.generate(t(conds).expand(B, -1, -1).contiguous(),
                        *(t(a).expand(B, -1) for a in (ids, pos, valid)), 5, max_new=1,
                        temperature=1.0, top_p=0.8, repetition_penalty_value=10.0)
    first = n(res.codes)[:, 0]
    assert set(first.tolist()) <= set(kept.tolist()) and len(kept) > 2
    freq = {k: float(np.mean(first == k)) for k in kept.tolist()}
    tv = 0.5 * sum(abs(freq[k] - want[k]) for k in kept.tolist())
    assert tv < 0.12, (tv, freq, want)


def w8_config(model_dim: int = 256, heads: int = 4):
    """A v1 GPT wide enough to open K4's, K5's and K6's gates (Dh 64)."""
    return dataclasses.replace(GPT_TINY, model_dim=model_dim, heads=heads)


def test_w8_greedy_decode_token_exact_with_jax_kernels():
    """W8A8 blocks, an int8 KV cache and the int8 head, greedy, 3 rows: the
    JAX decoder over UnifiedVoiceV1(quantize_gpt, kv_quant, head_quant,
    gemv_impl="pallas", attn_impl="pallas_q8") with its Pallas kernels in
    interpret mode, the port's over the same quantized tree with
    gemv_impl "pallas" through its kernels' plain versions: equal codes and
    lengths. int8 rounding turns float32 noise into flips at a near tie;
    the weights' seed (7; 0, 1, 3 and 6 agree too) is one whose greedy
    path has none."""
    from indextts_tpu.models.unified_voice_v1 import UnifiedVoiceV1 as JUV
    from indextts_tpu.runtime.decode import GPTDecoder as JDecoder
    from indextts_tpu.runtime.decode import SamplingConfig as JSampling
    from indextts_tpu.runtime.torch_convert import quantize_gpt_tree

    from indextts_tpu_torch.runtime.decode import GPTDecoder, SamplingConfig
    from indextts_tpu_torch.runtime.engine_v1 import v1_model

    gcfg = w8_config()
    jg, _, _ = jax_trees(gcfg, seed=7)
    qtree = quantize_gpt_tree(jg, head=True)
    jm = JUV(gcfg, quantize_gpt=True, kv_quant=True, head_quant=True, gemv_impl="pallas",
             attn_impl="pallas_q8", pallas_interpret=True)
    jdec = JDecoder(jm, gcfg, JSampling(do_sample=False))
    jdec.BLKQ = 32
    pm = v1_model("gpt", to_port_config(gcfg), PVOC, quantize=True, head_quant=True,
                  gemv=True)
    pm.load_state_dict(weights.unified_voice_v1_sd(qtree, to_port_config(gcfg)))
    pdec = GPTDecoder(pm.eval().requires_grad_(False), to_port_config(gcfg),
                      SamplingConfig(do_sample=False), kv_int8=True, attn_impl="pallas_q8")
    rng = np.random.default_rng(10)
    conds = rng.standard_normal((3, 32, gcfg.model_dim)).astype(np.float32)
    text, lens = three_rows(rng)
    want = jdec.generate({"params": qtree}, jnp.asarray(conds),
                         *(jnp.asarray(a) for a in jdec.build_text_prompt_arrays(text, lens, 10)),
                         jax.random.PRNGKey(0), max_new=12, repetition_penalty=10.0)
    got = pdec.generate(t(conds), *(t(a) for a in pdec.build_text_prompt_arrays(text, lens, 10)),
                        None, max_new=12, repetition_penalty_value=10.0)
    assert pm.gpt.h[0].attn.c_attn.weight_q.dtype == torch.int8
    assert len(set(np.asarray(want.codes).ravel().tolist())) > 6
    np.testing.assert_array_equal(n(got.codes), np.asarray(want.codes))
    np.testing.assert_array_equal(n(got.lengths), np.asarray(want.lengths))


# ---------------------------------------------------------------------------
# DVAE, bucket_segments
# ---------------------------------------------------------------------------


def test_dvae_codebook_indices_match_jax():
    """encode_latents within 1e-5 and get_codebook_indices equal, at a small
    DVAEConfig, from the port's state dict through the JAX converter."""
    from indextts_tpu.models.dvae import DVAE as JDVAE
    from indextts_tpu.models.dvae import DVAEConfig as JCfg
    from indextts_tpu.runtime import torch_convert as jtc

    from indextts_tpu_torch.models.dvae import DVAE, DVAEConfig

    kw = dict(num_tokens=64, codebook_dim=16, hidden_dim=8, num_resnet_blocks=2)
    torch.manual_seed(0)
    m = DVAE(DVAEConfig(**kw)).eval()
    mel = np.random.default_rng(3).standard_normal((2, 40, 100)).astype(np.float32)
    with torch.no_grad():  # the codebook at the latents' scale: many nearest codes
        m.codebook.embed.mul_(float(m.encode_latents(t(mel)).std()))
    jt = jtc.convert_dvae(np_sd(m.state_dict()), JCfg(**kw))
    m.load_state_dict(weights.dvae_sd(jt, DVAEConfig(**kw)))
    jm, p = JDVAE(JCfg(**kw)), {"params": jt}
    with torch.no_grad():
        np.testing.assert_allclose(
            n(m.encode_latents(t(mel))),
            np.asarray(jm.apply(p, jnp.asarray(mel), method=JDVAE.encode_latents)),
            atol=1e-5, rtol=1e-5)
        got = n(m.get_codebook_indices(t(mel)))
        emb = n(m.embed_code(torch.as_tensor(got)))
    want = np.asarray(jm.apply(p, jnp.asarray(mel), method=JDVAE.get_codebook_indices))
    assert got.shape == want.shape == (2, 10) and len(set(want.ravel().tolist())) > 4
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        emb, np.asarray(jm.apply(p, jnp.asarray(want), method=JDVAE.embed_code)))


@pytest.mark.parametrize("size", [1, 2, 4])
def test_bucket_segments_matches_jax(size):
    from indextts_tpu.runtime.engine_v1 import bucket_segments as jbucket

    from indextts_tpu_torch.runtime.engine_v1 import bucket_segments

    rng = np.random.default_rng(size)
    for _ in range(20):
        lens = rng.integers(1, 12, rng.integers(1, 11)).tolist()
        assert bucket_segments(lens, size) == jbucket(lens, size)


# ---------------------------------------------------------------------------
# converters: reference state dicts -> the port's, to the bit
# ---------------------------------------------------------------------------


def assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(n(got[k]), n(want[k]), err_msg=k)


@pytest.mark.parametrize("quantized", [False, True])
def test_convert_unified_voice_v1_to_the_bit(trees, quantized):
    """A port v1 GPT state dict (text_head included, as the reference's:
    read and dropped) through the port's convert_unified_voice_v1 equals
    weights' unified_voice_v1_sd of the JAX converter's tree, to the bit
    (a missing key raises, naming the file); quantized,
    the port's quantize_gpt_state_dict of it equals the JAX
    quantize_gpt_tree(head=True) carried over."""
    from indextts_tpu.runtime import torch_convert as jtc

    from indextts_tpu_torch.runtime import torch_convert as ptc
    from indextts_tpu_torch.runtime.engine_v1 import random_params_v1

    sd = np_sd(with_text_head(random_params_v1(PCFG, PVOC, seed=1, device="cpu")["gpt"],
                              GPT_TINY))
    tree = jtc.convert_unified_voice_v1(sd, GPT_TINY)
    got = ptc.convert_unified_voice_v1(sd, PCFG, "gpt.pth")
    if quantized:
        got = weights.quantize_gpt_state_dict(got, head=True)
        tree = jtc.quantize_gpt_tree(tree, head=True)
    assert_same(got, weights.unified_voice_v1_sd(tree, PCFG))
    with pytest.raises(KeyError, match="gpt.pth.*final_norm.bias"):
        ptc.convert_unified_voice_v1({k: v for k, v in sd.items() if k != "final_norm.bias"},
                                     PCFG, "gpt.pth")


def test_convert_bigvgan_v1_to_the_bit():
    """A port BigVGAN v1 state dict with conv_pre, an upsampling layer, a
    resblock convolution and conv_post as weight-norm pairs (the others
    folded, as a checkpoint after remove_weight_norm) through the port's
    convert_bigvgan_v1 equals bigvgan_v1_sd of the JAX converter's tree,
    to the bit; its ECAPA alone through convert_ecapa equals ecapa_sd."""
    from indextts_tpu.runtime import torch_convert as jtc

    from indextts_tpu_torch.runtime import torch_convert as ptc
    from indextts_tpu_torch.runtime.engine_v1 import random_params_v1

    sd = np_sd(random_params_v1(PCFG, PVOC, seed=2, device="cpu")["bigvgan"])
    rng = np.random.default_rng(0)
    for layer in ("conv_pre", "ups.1.0", "resblocks.2.convs2.1", "conv_post"):
        v = sd.pop(f"{layer}.weight")
        sd[f"{layer}.weight_v"] = v * 1.5
        sd[f"{layer}.weight_g"] = rng.uniform(0.5, 1.5, (v.shape[0],) + (1,) * (v.ndim - 1)
                                              ).astype(np.float32)
    tree = jtc.convert_bigvgan_v1(sd, VOC_TINY)
    assert_same(ptc.convert_bigvgan_v1(sd, PVOC, "bigvgan.pt"),
                weights.bigvgan_v1_sd(tree, PVOC))
    c = VOC_TINY
    ecapa = ptc.convert_ecapa(
        sd, "bigvgan.pt", "speaker_encoder.", input_size=c.num_mels,
        lin_neurons=c.speaker_embedding_dim, channels=c.ecapa_channels,
        attention_channels=c.ecapa_attention_channels, se_channels=c.ecapa_se_channels)
    assert_same(ecapa, weights.ecapa_sd(jtc.convert_ecapa(sd, "speaker_encoder.")))


def test_convert_dvae_to_the_bit():
    from indextts_tpu.models.dvae import DVAEConfig as JCfg
    from indextts_tpu.runtime import torch_convert as jtc

    from indextts_tpu_torch.models.dvae import DVAE, DVAEConfig
    from indextts_tpu_torch.runtime import torch_convert as ptc

    kw = dict(num_tokens=32, codebook_dim=8, hidden_dim=8, num_resnet_blocks=2)
    torch.manual_seed(1)
    sd = np_sd(DVAE(DVAEConfig(**kw)).state_dict())
    assert_same(ptc.convert_dvae(sd, DVAEConfig(**kw), "dvae.pth"),
                weights.dvae_sd(jtc.convert_dvae(sd, JCfg(**kw)), DVAEConfig(**kw)))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def test_random_params_v1_positive_batchnorm_statistics():
    from indextts_tpu_torch.runtime.engine_v1 import random_params_v1

    a = random_params_v1(PCFG, PVOC, seed=4, device="cpu")
    b = random_params_v1(PCFG, PVOC, seed=4, device="cpu")
    var = [v for k, v in a["bigvgan"].items() if k.endswith("running_var")]
    assert var and all(bool((v >= 0.5).all()) for v in var)
    assert all(torch.equal(a[m][k], b[m][k]) for m in a for k in a[m])


def _spy_codes(engine, out, jax_side: bool):
    gen = engine.decoder.generate

    def spy(*a, **k):
        res = gen(*a, **k)
        out.append(np.asarray(res.codes) if jax_side else n(res.codes))
        return res

    engine.decoder.generate = spy


@pytest.mark.parametrize("pcm16", [False, True])
def test_infer_fast_matches_jax_engine(trees, pcm16):
    """infer_fast of 3 segments (one bucket of 3 rows), both decoders
    greedy: the same codes, the waveform within 1e-4 (float) or one PCM16
    step (device_pcm16), the silences and 24 kHz as JAX's."""
    from indextts_tpu.runtime.decode import GPTDecoder as JDecoder
    from indextts_tpu.runtime.decode import SamplingConfig as JSampling
    from indextts_tpu.runtime.engine_v1 import IndexTTSV1Engine as JEngine

    from indextts_tpu_torch.runtime.decode import SamplingConfig
    from indextts_tpu_torch.runtime.engine_v1 import IndexTTSV1Engine

    jg, jv, sds = trees
    je = JEngine(GPT_TINY, VOC_TINY, {"gpt": jg, "bigvgan": jv}, device_pcm16=pcm16)
    je.decoder = JDecoder(je.gpt, GPT_TINY, JSampling(do_sample=False))
    pe = IndexTTSV1Engine(PCFG, PVOC, sds, device_pcm16=pcm16, device="cpu")
    pe.decoder.sampling = SamplingConfig(do_sample=False)
    rng = np.random.default_rng(12)
    prompt = (0.1 * rng.standard_normal(16000)).astype(np.float32)
    segs = [rng.integers(2, 50, 5), rng.integers(2, 50, 8), rng.integers(2, 50, 3)]
    codes = {"jax": [], "port": []}
    _spy_codes(je, codes["jax"], True)
    _spy_codes(pe, codes["port"], False)
    want = je.infer_fast((prompt, 16000), segs, max_mel_tokens=12, seed=0)
    got = pe.infer_fast((prompt, 16000), segs, max_mel_tokens=12, seed=0)
    assert len(codes["port"]) == 1 and codes["port"][0].shape[0] == 3
    np.testing.assert_array_equal(codes["port"][0], codes["jax"][0])
    assert got["sampling_rate"] == want["sampling_rate"] == 24000
    assert got["audio"].shape == want["audio"].shape
    assert 1e-3 < np.abs(want["audio"]).max() < 0.99
    tol = 1.0 / 32767 + 1e-6 if pcm16 else 1e-4
    assert np.abs(got["audio"] - want["audio"]).max() <= tol
    assert set(pe.last_stats) == {"conditioning", "decode", "host_trim", "latent", "vocoder"}


def test_infer_fast_quantized_engine_runs_w8(trees):
    """quantize_gpt, kv_quant and head_quant on the port's engine: the
    float weights quantized at construction (int8 blocks and head), an int8
    cache, finite audio at 24 kHz and codes inside the vocabulary; two
    buckets at bucket_max_size 2, the second seeded seed + its first
    segment's index."""
    from indextts_tpu_torch.runtime.engine_v1 import IndexTTSV1Engine

    pe = IndexTTSV1Engine(PCFG, PVOC, trees[2], quantize_gpt=True, kv_quant=True,
                          head_quant=True, gemv_impl="pallas", bucket_max_size=2,
                          device="cpu")
    assert pe.decoder.kv_int8 and pe.gpt.mel_head.weight_q.shape == (64, 128)
    seeds, codes = [], []
    gen = pe.decoder.generate

    def spy(*a, **k):
        seeds.append(a[4])
        res = gen(*a, **k)
        codes.append(n(res.codes))
        return res

    pe.decoder.generate = spy
    rng = np.random.default_rng(14)
    segs = [rng.integers(2, 50, L) for L in (5, 9, 3)]
    out = pe.infer_fast(((0.1 * rng.standard_normal(24000)).astype(np.float32), 24000), segs,
                        max_mel_tokens=10, seed=7)
    assert seeds == [7 + 2, 7 + 1]  # buckets [2, 0] and [1]
    assert all(c.max() < PCFG.number_mel_codes for c in codes)
    assert np.isfinite(out["audio"]).all() and out["audio"].size > 0
