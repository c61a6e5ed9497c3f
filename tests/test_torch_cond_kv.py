"""The port's conditioning-prefix KV reuse (the keyed route) against the JAX
package's, on the CPU.

* `GPTDecoder.cond_prefill`: the prefix KV against the JAX `cond_prefill`
  on the same parameters, and the text tail prefilled on top of it (last
  logits, the prompt's KV) against the JAX `_prefill_with_cond`, within
  1e-5 of the largest value (float32 through two layers, summed in
  another order).
* Greedy codes of the keyed route, token-exact with the JAX keyed route
  (`generate(cond_kv=...)`) and with the port's own monolithic prefill, on
  the float cache, the int8 KV cache and W8 blocks (mirroring
  tests/test_prefix_kv.py). The JAX decoder runs attn_impl="xla", the
  layout its keyed route takes; W8 runs its GEMV and MLP kernels in
  interpret mode.
* The engine's caches: one entry a path prompt, none for an (audio, sr)
  pair, 8 keys at most; a keyed request's audio equal to the unkeyed one.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from indextts_tpu_torch.weights import from_jax_params
from torch_parity import n, parity_config, parity_params, speech_like, t, to_port_config

torch.set_num_threads(2)


def _jax_decoder(gcfg, **model_kw):
    from indextts_tpu.models.unified_voice import UnifiedVoice as JUV
    from indextts_tpu.runtime.decode import GPTDecoder as JDecoder
    from indextts_tpu.runtime.decode import SamplingConfig as JSampling

    return JDecoder(JUV(gcfg, attn_impl="xla", **model_kw), gcfg, JSampling(do_sample=False))


@pytest.fixture(scope="module")
def float_pair():
    """The tiny config's GPT from parity_params(seed=3): the JAX params,
    the port's model, and the port's float and int8-cache decoders."""
    from indextts_tpu_torch.runtime.decode import GPTDecoder, SamplingConfig
    from indextts_tpu_torch.runtime.engine import load_model

    cfg = parity_config()
    pcfg = to_port_config(cfg)
    jp = parity_params(cfg, seed=3)
    gpt = load_model("gpt", pcfg, from_jax_params(jp, pcfg)["gpt"], "cpu")
    decs = {q: GPTDecoder(gpt, pcfg.gpt, SamplingConfig(do_sample=False), kv_int8=q)
            for q in (False, True)}
    return cfg, {"params": jp["gpt"]}, decs


def _prompt(dec, rng, B, n_text, bucket, d):
    conds = rng.standard_normal((B, 34, d)).astype(np.float32)
    text = rng.integers(2, 50, (B, n_text))
    lens = np.array([n_text, min(5, n_text)][:B])
    return conds, dec.build_text_prompt_arrays(text, lens, bucket)


def test_cond_prefill_matches_jax(float_pair):
    cfg, jparams, decs = float_pair
    conds = np.random.default_rng(0).standard_normal((2, 34, cfg.gpt.model_dim)).astype(
        np.float32)
    want = _jax_decoder(cfg.gpt).cond_prefill(jparams, jnp.asarray(conds))
    got = decs[False].cond_prefill(t(conds))
    L, H = cfg.gpt.layers, cfg.gpt.heads
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape == (L, 2, H, 34, cfg.gpt.model_dim // H)
        assert np.abs(n(g) - w).max() <= 1e-5 * np.abs(w).max()


@pytest.mark.parametrize("B,n_text,bucket", [(2, 9, 9), (1, 5, 12)])
def test_keyed_tail_prefill_matches_jax(float_pair, B, n_text, bucket):
    """The prompt's tail prefilled on top of the prefix: the port's last
    logits and the float KV of the S prompt slots against the JAX
    `_prefill_with_cond` (the chunk through its decode step over the
    cap-wide cache), within 1e-5 of the largest |value|."""
    from indextts_tpu.models.unified_voice import UnifiedVoice as JUV

    cfg, jparams, decs = float_pair
    pdec, jdec = decs[False], _jax_decoder(cfg.gpt)
    conds, arrays = _prompt(pdec, np.random.default_rng(B + n_text), B, n_text, bucket,
                            cfg.gpt.model_dim)
    jm = jdec.model
    ids, pos, valid = (jnp.asarray(a) for a in arrays)
    tail = jnp.concatenate([jm.apply(jparams, ids, pos, valid, method=JUV.embed_text_prompt),
                            jm.apply(jparams, B, method=JUV.embed_mel_start)], axis=1)
    S, cap = 34 + tail.shape[1], 34 + tail.shape[1] + 8
    cap_mask = jnp.concatenate([jnp.ones((B, 34), bool), valid,
                                jnp.ones((B, 1 + cap - S), bool)], axis=1)
    hidden, ks, vs = jdec._prefill_with_cond(
        jparams, jdec.cond_prefill(jparams, jnp.asarray(conds)), tail, cap_mask, B, cap)
    want_logits = np.asarray(jm.apply(jparams, hidden, method=JUV.mel_logits_from_hidden))
    logits, (pk, pv), mask = pdec._prompt_prefill(
        t(conds), *(t(a) for a in arrays), pdec.cond_prefill(t(conds)))
    assert mask.shape == (B, S)
    for got, want in ((logits, want_logits), (pk, np.asarray(ks)[:, :, :, :S]),
                      (pv, np.asarray(vs)[:, :, :, :S])):
        assert got.shape == want.shape
        assert np.abs(n(got) - want).max() <= 1e-5 * np.abs(want).max()


def _three_routes(jdec, jparams, pdec, conds, arrays, max_new):
    """Greedy codes and lengths of the JAX keyed route, the port's keyed
    route and the port's monolithic prefill."""
    ja = [jnp.asarray(a) for a in arrays]
    jkv = jdec.cond_prefill(jparams, jnp.asarray(conds))
    jres = jdec.generate(jparams, jnp.asarray(conds), *ja, jax.random.PRNGKey(0),
                         max_new=max_new, repetition_penalty=10.0, cond_kv=jkv)
    pa = [t(a) for a in arrays]
    kw = dict(max_new=max_new, repetition_penalty_value=10.0, do_sample=False)
    keyed = pdec.generate(t(conds), *pa, None, cond_kv=pdec.cond_prefill(t(conds)), **kw)
    whole = pdec.generate(t(conds), *pa, None, **kw)
    return ((np.asarray(jres.codes), np.asarray(jres.lengths)),
            (n(keyed.codes), n(keyed.lengths)), (n(whole.codes), n(whole.lengths)))


@pytest.mark.parametrize("kv_int8", [False, True], ids=["float", "int8_kv"])
@pytest.mark.parametrize("B,n_text,bucket", [(2, 9, 9), (1, 5, 12)])
def test_keyed_greedy_codes_token_exact(float_pair, kv_int8, B, n_text, bucket):
    """Two rows, one left-padded (tests/test_prefix_kv.py:51, 79), and one
    row with a pad hole from its bucket: equal codes and lengths on the
    three routes."""
    cfg, jparams, decs = float_pair
    pdec = decs[kv_int8]
    assert pdec.supports_cond_kv
    conds, arrays = _prompt(pdec, np.random.default_rng(B * 10 + n_text), B, n_text, bucket,
                            cfg.gpt.model_dim)
    jax_keyed, keyed, whole = _three_routes(_jax_decoder(cfg.gpt, kv_quant=kv_int8),
                                            jparams, pdec, conds, arrays, 20)
    assert len(set(jax_keyed[0][0].tolist())) > 3  # not a degenerate row
    for got in (keyed, whole):
        np.testing.assert_array_equal(got[0], jax_keyed[0])
        np.testing.assert_array_equal(got[1], jax_keyed[1])


@pytest.mark.parametrize("n_text,bucket", [(7, 7), (5, 12)])
def test_keyed_greedy_codes_token_exact_w8(n_text, bucket):
    """W8A8 blocks, the int8 head and the int8 cache at D=512 (every GEMV
    and MLP gate open; the JAX side in interpret mode). The weights' seed,
    24, is tests/test_torch_quant.py's: its greedy paths have top-2 logit
    margins of at least 0.03 on both prompts, which int8 rounding of
    float32 noise between the two packages does not cross."""
    from indextts_tpu.runtime.torch_convert import quantize_gpt_tree
    from test_engine_e2e import tiny_config
    from test_torch_quant import _gpt_config, _jax_gpt_tree

    from indextts_tpu_torch import weights
    from indextts_tpu_torch.runtime.decode import GPTDecoder, SamplingConfig
    from indextts_tpu_torch.runtime.engine import load_model

    gcfg = _gpt_config(512, 8)
    tree = _jax_gpt_tree(gcfg, seed=24)
    jdec = _jax_decoder(gcfg, quantize_gpt=True, head_quant=True, kv_quant=True,
                        gemv_impl="pallas", pallas_interpret=True)
    jparams = {"params": quantize_gpt_tree(tree, head=True, bits=8)}
    cfg = tiny_config()
    rt = dataclasses.replace(cfg.runtime, gpt_quantize=True, head_quant=True,
                             gemv_impl="pallas")
    pcfg = to_port_config(dataclasses.replace(cfg, gpt=gcfg, runtime=rt))
    sd = weights.quantize_gpt_state_dict(weights.unified_voice_sd(tree, pcfg), head=True)
    pdec = GPTDecoder(load_model("gpt", pcfg, sd, "cpu"), pcfg.gpt,
                      SamplingConfig(do_sample=False), kv_int8=True)
    conds, arrays = _prompt(pdec, np.random.default_rng(n_text), 1, n_text, bucket, 512)
    jax_keyed, keyed, whole = _three_routes(jdec, jparams, pdec, conds, arrays, 16)
    assert len(set(jax_keyed[0][0].tolist())) > 3
    for got in (keyed, whole):
        np.testing.assert_array_equal(got[0], jax_keyed[0])
        np.testing.assert_array_equal(got[1], jax_keyed[1])


def test_supports_cond_kv_follows_the_jax_rule():
    """The port's rule on (attn_impl, int8 cache) equals the JAX decoder's
    on the model the JAX engine builds from the same runtime knobs."""
    from indextts_tpu.config import GPTConfig as JGPTConfig

    from indextts_tpu_torch.runtime.decode import GPTDecoder

    gcfg = JGPTConfig(model_dim=64, layers=1, heads=4)
    for impl in ("auto", "xla", "xla_bucketed", "pallas_ragged", "pallas_q8"):
        for kv_quant in (False, True):
            want = _jax_decoder_for(gcfg, impl, kv_quant).supports_cond_kv
            port = GPTDecoder.__new__(GPTDecoder)
            port.attn_impl, port.kv_int8 = impl, kv_quant or impl == "pallas_q8"
            assert port.supports_cond_kv == want, (impl, kv_quant)


def _jax_decoder_for(gcfg, impl, kv_quant):
    from indextts_tpu.models.unified_voice import UnifiedVoice as JUV
    from indextts_tpu.runtime.decode import GPTDecoder as JDecoder

    return JDecoder(JUV(gcfg, attn_impl=impl, kv_quant=kv_quant), gcfg)


@pytest.fixture(scope="module")
def engine():
    from indextts_tpu_torch.runtime.engine import IndexTTS2Engine

    cfg = parity_config()
    pcfg = to_port_config(cfg)
    return IndexTTS2Engine(pcfg, from_jax_params(parity_params(cfg, seed=1), pcfg),
                           device="cpu")


def test_engine_caches_key_path_prompts(engine, tmp_path):
    """A path prompt fills one entry of each cache, and its second request
    reuses them with the same audio (tests/test_prefix_kv.py:275); an
    (audio, sr) pair fills none and gives the keyed request's audio."""
    from indextts_tpu_torch.utils import audio as audio_utils

    path = str(tmp_path / "spk.wav")
    audio_utils.save_wav(path, speech_like(np.random.default_rng(2), 1.0, 16000), 16000)
    seg = [np.random.default_rng(4).integers(2, 50, 7)]
    engine._emoconds_cache.clear()
    engine._cond_kv_cache.clear()
    first = engine.infer(path, seg, seed=0)["audio"]
    key = (path, "", 1.0, None)
    assert list(engine._emoconds_cache) == [key] and list(engine._cond_kv_cache) == [key]
    (pk, pv), _ = engine._cond_kv_cache[key]
    g = engine.cfg.gpt
    assert pk.shape == (g.layers, 1, g.heads, 34, g.model_dim // g.heads)
    again = engine.infer(path, seg, seed=0)["audio"]
    assert len(engine._emoconds_cache) == len(engine._cond_kv_cache) == 1
    unkeyed = engine.infer(audio_utils.load_wav(path), seg, seed=0)["audio"]
    assert len(engine._emoconds_cache) == len(engine._cond_kv_cache) == 1
    np.testing.assert_array_equal(again, first)
    np.testing.assert_array_equal(unkeyed, first)


def test_engine_keys_need_both_paths(engine, tmp_path):
    """The key is (speaker path, emotion path or "", alpha, None); an
    emotion given as (audio, sr) makes no key."""
    from indextts_tpu_torch.utils import audio as audio_utils

    spk, emo = str(tmp_path / "spk.wav"), str(tmp_path / "emo.wav")
    rng = np.random.default_rng(6)
    for p in (spk, emo):
        audio_utils.save_wav(p, speech_like(rng, 1.0, 16000), 16000)
    assert engine._conditioning(spk, None, 0.3)[2:] == (1.0, (spk, "", 1.0, None))
    assert engine._conditioning(spk, emo, 0.5)[3] == (spk, emo, 0.5, None)
    assert engine._conditioning(spk, audio_utils.load_wav(emo), 0.5)[3] is None
    assert engine._conditioning(audio_utils.load_wav(spk), emo, 0.5)[3] is None


def test_engine_caches_hold_8_keys(engine):
    """Nine keys: the oldest goes from both caches, the other 8 stay; a
    key's values are the unkeyed conditioning's."""
    from indextts_tpu_torch.runtime.engine import EmotionConditioning

    engine._emoconds_cache.clear()
    engine._cond_kv_cache.clear()
    spk = engine.prepare_speaker(speech_like(np.random.default_rng(8), 1.0, 16000), 16000)
    emo = EmotionConditioning(spk.spk_cond_emb, spk.cond_len)
    keys = [("spk.wav", "", float(a), None) for a in np.linspace(0.1, 0.9, 9)]
    for k in keys:
        emovec, conds, prefix = engine._segment_inputs(spk, emo, k[2], k)
        want = engine.segment_conds(spk, emo, k[2])
        assert torch.equal(emovec, want[0]) and torch.equal(conds, want[1])
        assert all(torch.equal(a, b) for a, b in zip(prefix, engine.decoder.cond_prefill(conds)))
    assert list(engine._emoconds_cache) == keys[1:] == list(engine._cond_kv_cache)


def test_engine_caches_under_concurrent_requests(engine):
    """16 threads, 12 keys (past the 8 kept), a switch interval of 1e-5 s:
    every read gives its key's conditioning and a prefix of 34 positions;
    afterwards both caches hold the same 8 keys."""
    import sys
    import threading

    from indextts_tpu_torch.runtime.engine import EmotionConditioning

    engine._emoconds_cache.clear()
    engine._cond_kv_cache.clear()
    spk = engine.prepare_speaker(speech_like(np.random.default_rng(9), 1.0, 16000), 16000)
    emo = EmotionConditioning(spk.spk_cond_emb, spk.cond_len)
    keys = [("spk.wav", "", float(a), None) for a in np.linspace(0.05, 0.95, 12)]
    want = {k: engine.segment_conds(spk, emo, k[2]) for k in keys}
    errors, reads = [], []

    def run(i):
        try:
            for j in range(6):
                k = keys[(5 * i + j) % len(keys)]
                emovec, conds, prefix = engine._segment_inputs(spk, emo, k[2], k)
                assert torch.equal(emovec, want[k][0]) and torch.equal(conds, want[k][1])
                assert prefix[0].shape[3] == 34
                reads.append(k)
        except Exception as e:  # reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads) and errors == [] and len(reads) == 96
    assert len(engine._emoconds_cache) == 8
    assert list(engine._emoconds_cache) == list(engine._cond_kv_cache)

