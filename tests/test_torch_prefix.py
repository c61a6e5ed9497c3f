"""The port's text-prefix KV reuse against the JAX package's, on the CPU at
the tiny size (mirroring tests/test_prefix_kv.py
`test_text_prefix_kv_matches_monolithic` and
`test_engine_text_prefix_reuse`).

* `GPTDecoder.text_prefix_prefill`: the KV of [conds][start_text][text[:m]]
  against the JAX `text_prefix_prefill` on the same parameters, within 1e-5
  of the largest |value| (float32 through two layers, summed in another
  order).
* A left-aligned prompt padded to a 16-bucket: the pad hole sits between
  [stop_text] and [start_mel], and the state hands it to K1/K4 (hole_s,
  hole_e) on the sampling and the beam route.
* Decoding on top of the text-prefix KV, on the float and the int8 cache,
  the sampling and the beam route: greedy codes token-exact with the JAX
  decoder's on the same prompt and prefix, and with the port's monolithic
  prefill; sampled codes equal to the monolithic prefill's under one
  generator seed. The prefill then runs only [text[m:]][stop][pads]
  [start_mel] (the tail's length).
* The engine (TEXT_PREFIX_GRAN = 4), a miss then a hit: greedy audio
  bit-equal to a port engine whose lookup is disabled, codes token-exact
  with the JAX engine's with the flag on, the same cache keys; 8 entries
  at most; no lookup for an unkeyed request or a layout without
  `supports_cond_kv`.
"""

import hashlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from indextts_tpu_torch.weights import from_jax_params
from torch_parity import n, parity_config, parity_params, speech_like, t, to_port_config

torch.set_num_threads(2)

P = 34
GRAN = 4  # the engine tests' grid (the tiny config's texts are short)


@pytest.fixture(scope="module")
def decoders():
    """The tiny config's GPT from parity_params(seed=3): the JAX params, a
    JAX decoder (attn_impl "xla") and a port decoder for each cache."""
    from indextts_tpu.models.unified_voice import UnifiedVoice as JUV
    from indextts_tpu.runtime.decode import GPTDecoder as JDecoder
    from indextts_tpu.runtime.decode import SamplingConfig as JSampling

    from indextts_tpu_torch.runtime.decode import GPTDecoder, SamplingConfig
    from indextts_tpu_torch.runtime.engine import load_model

    cfg = parity_config()
    pcfg = to_port_config(cfg)
    jp = parity_params(cfg, seed=3)
    gpt = load_model("gpt", pcfg, from_jax_params(jp, pcfg)["gpt"], "cpu")
    out = {}
    for q in (False, True):
        jdec = JDecoder(JUV(cfg.gpt, attn_impl="xla", kv_quant=q), cfg.gpt,
                        JSampling(do_sample=False))
        out[q] = (jdec, GPTDecoder(gpt, pcfg.gpt, SamplingConfig(do_sample=False), kv_int8=q))
    return cfg, {"params": jp["gpt"]}, out


def _left_prompt(dec, seed: int, n_text: int, bucket: int, dim: int):
    rng = np.random.default_rng(seed)
    conds = rng.standard_normal((1, P, dim)).astype(np.float32)
    text = rng.integers(2, 50, (1, n_text))
    return conds, text, dec.build_text_prompt_arrays(text, np.array([n_text]), bucket,
                                                     align="left")


def test_text_prefix_prefill_matches_jax(decoders):
    cfg, jparams, decs = decoders
    jdec, pdec = decs[False]
    m = 7
    conds, text, _ = _left_prompt(pdec, 0, 11, 11, cfg.gpt.model_dim)
    want = jdec.text_prefix_prefill(jparams, jnp.asarray(conds), text[0, :m])
    got = pdec.text_prefix_prefill(t(conds), text[0, :m])
    L, H = cfg.gpt.layers, cfg.gpt.heads
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape == (L, 1, H, P + 1 + m, cfg.gpt.model_dim // H)
        assert np.abs(n(g) - w).max() <= 1e-5 * np.abs(w).max()


def test_left_aligned_prompt_layout():
    """[start][text][stop] first and the pads after it; the right-aligned
    layout unchanged; any other alignment raises."""
    from indextts_tpu_torch.runtime.decode import GPTDecoder

    dec = GPTDecoder.__new__(GPTDecoder)
    dec.cfg = to_port_config(parity_config()).gpt
    text = np.array([[5, 6, 7]])
    ids, pos, valid = dec.build_text_prompt_arrays(text, np.array([3]), 6, align="left")
    start, stop = dec.cfg.start_text_token, dec.cfg.stop_text_token
    assert ids[0].tolist() == [start, 5, 6, 7, stop, 0, 0, 0]
    assert pos[0].tolist() == [0, 1, 2, 3, 4, 0, 0, 0]
    assert valid[0].tolist() == [True] * 5 + [False] * 3
    ids, _, valid = dec.build_text_prompt_arrays(text, np.array([3]), 6)
    assert ids[0].tolist() == [0, 0, 0, start, 5, 6, 7, stop]
    with pytest.raises(ValueError):
        dec.build_text_prompt_arrays(text, np.array([3]), 6, align="center")


@pytest.mark.parametrize("beam", [False, True], ids=["sampling", "beam"])
def test_left_aligned_hole_reaches_the_state(decoders, beam):
    """n ids in a bucket of 16, left-aligned: the prompt's hole is [P + n +
    2, P + 18), between [stop_text] and [start_mel], in every row's
    hole_s / hole_e, with and without the text-prefix KV."""
    cfg, _, decs = decoders
    _, pdec = decs[False]
    n_text, m = 7, 4
    conds, text, arrays = _left_prompt(pdec, 1, n_text, 16, cfg.gpt.model_dim)
    pa = [t(a) for a in arrays]
    for kv in (None, pdec.text_prefix_prefill(t(conds), text[0, :m])):
        with torch.inference_mode():
            st = pdec.prefill(t(conds), *pa, max_new=8, cond_kv=kv, num_beams=3 if beam else 0)
        rows = 3 if beam else 1
        assert st.hole_s.tolist() == [P + n_text + 2] * rows
        assert st.hole_e.tolist() == [P + 18] * rows
        assert int(st.start) == P + 18 + 1


def _tail_lengths(pdec, monkeypatch):
    """Record the length of every tail prefilled on top of a prefix."""
    seen = []
    orig = pdec.model.gpt_prefill_with_past

    def spy(tail, mask, past):
        seen.append(tail.shape[1])
        return orig(tail, mask, past)

    monkeypatch.setattr(pdec.model, "gpt_prefill_with_past", spy)
    return seen


@pytest.mark.parametrize("do_sample", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("beam", [False, True], ids=["sampling", "beam"])
@pytest.mark.parametrize("kv_int8", [False, True], ids=["float", "int8_kv"])
def test_text_prefix_decode_token_exact(decoders, monkeypatch, kv_int8, beam, do_sample):
    """11 ids left-aligned in a bucket of 16, a prefix of m = 6: the port
    on top of its text-prefix KV gives the monolithic prefill's codes
    (sampled: under one generator seed) and, greedy, the JAX decoder's on
    top of the JAX text-prefix KV; the tail prefilled is 16 + 2 - m long."""
    cfg, jparams, decs = decoders
    jdec, pdec = decs[kv_int8]
    n_text, m, bucket, max_new = 11, 6, 16, 20
    conds, text, arrays = _left_prompt(pdec, 2 + kv_int8, n_text, bucket, cfg.gpt.model_dim)
    pa = [t(a) for a in arrays]
    kw = dict(max_new=max_new, repetition_penalty_value=10.0, do_sample=do_sample)
    if beam:
        kw.update(num_beams=3, temperature=1.0, top_p=0.8)
        run = pdec.generate_beam
    else:
        run = pdec.generate
    seen = _tail_lengths(pdec, monkeypatch)
    whole = run(t(conds), *pa, 5, **kw)
    reuse = run(t(conds), *pa, 5, cond_kv=pdec.text_prefix_prefill(t(conds), text[0, :m]), **kw)
    assert seen == [bucket + 2 - m]
    np.testing.assert_array_equal(n(reuse.codes), n(whole.codes))
    np.testing.assert_array_equal(n(reuse.lengths), n(whole.lengths))
    if do_sample:
        return
    ja = [jnp.asarray(a) for a in arrays]
    jkv = jdec.text_prefix_prefill(jparams, jnp.asarray(conds), text[0, :m])
    if beam:
        want = jdec.generate_beam(jparams, jnp.asarray(conds), *ja, max_new=max_new,
                                  num_beams=3, repetition_penalty=10.0, cond_kv=jkv)
    else:
        want = jdec.generate(jparams, jnp.asarray(conds), *ja, jax.random.PRNGKey(0),
                             max_new=max_new, repetition_penalty=10.0, cond_kv=jkv)
    assert len(set(np.asarray(want.codes)[0].tolist())) > 3  # not a degenerate row
    np.testing.assert_array_equal(n(reuse.codes), np.asarray(want.codes))
    np.testing.assert_array_equal(n(reuse.lengths), np.asarray(want.lengths))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _engines(kv_quant: bool):
    """The JAX engine and two port engines with text_prefix_reuse on,
    greedy, TEXT_PREFIX_GRAN = GRAN; the second port engine's lookup is
    disabled (it reuses the conditioning prefix only, on the same
    left-aligned prompts)."""
    from indextts_tpu.runtime.engine import IndexTTS2Engine as JaxEngine

    from indextts_tpu_torch.runtime.engine import IndexTTS2Engine

    cfg = parity_config(text_prefix_reuse=True, kv_quant=kv_quant)
    jp = parity_params(cfg, seed=1)
    pcfg = to_port_config(cfg)
    je = JaxEngine(cfg, jp)
    pe, pe0 = (IndexTTS2Engine(pcfg, from_jax_params(jp, pcfg), device="cpu")
               for _ in range(2))
    je.TEXT_PREFIX_GRAN = pe.TEXT_PREFIX_GRAN = pe0.TEXT_PREFIX_GRAN = GRAN
    pe0._lookup_text_prefix = lambda *a: None
    return je, pe, pe0


@pytest.fixture(scope="module")
def engines():
    made = {}

    def get(kv_quant: bool):
        if kv_quant not in made:
            made[kv_quant] = _engines(kv_quant)
        return made[kv_quant]

    return get


@pytest.fixture(scope="module")
def wav_path(tmp_path_factory):
    from indextts_tpu_torch.utils import audio as audio_utils

    path = str(tmp_path_factory.mktemp("prefix") / "spk.wav")
    audio_utils.save_wav(path, speech_like(np.random.default_rng(3), 1.0, 16000), 16000)
    return path


def _segments():
    """Two texts sharing an 8-id prefix: 11 ids (a miss that caches m = 8)
    and 13 ids (m = 12 misses, m = 8 hits)."""
    r = np.random.default_rng(5)
    prefix = r.integers(2, 50, 8)
    return [np.concatenate([prefix, r.integers(2, 50, k)]) for k in (3, 5)]


def _jax_codes(je, wav_path, seg, nb):
    from indextts_tpu.runtime.engine import EmotionConditioning as JEmo
    from indextts_tpu.utils import audio as jaudio

    spk = je.prepare_speaker(*jaudio.load_wav(wav_path), cache_key=wav_path)
    key = (wav_path, "", 1.0, None)
    _, codes, _ = je._decode_segment_codes(spk, JEmo(spk.spk_cond_emb, spk.cond_len), seg,
                                           seed=0, num_beams=nb, do_sample=False,
                                           cond_kv_key=key)
    return np.asarray(codes)


@pytest.mark.parametrize("beam", [False, True], ids=["sampling", "beam"])
@pytest.mark.parametrize("kv_quant", [False, True], ids=["float", "int8_kv"])
def test_engine_text_prefix_reuse(engines, wav_path, monkeypatch, kv_quant, beam):
    """A miss, then a hit: the port's greedy audio bit-equal to the port
    engine without lookup, its codes the JAX engine's with the flag on, one
    cache entry (m = 8) keyed as JAX keys it, and the hit's tail [text[8:]]
    [stop][pads][start_mel] prefilled on top of P + 1 + 8 positions."""
    je, pe, pe0 = engines(kv_quant)
    nb = 3 if beam else 1
    for e in (je, pe, pe0):
        e._text_prefix_cache.clear()
    seen = _tail_lengths(pe.decoder, monkeypatch)
    codes = []
    finish = pe._finish_from_codes
    monkeypatch.setattr(pe, "_finish_from_codes",
                        lambda spk, emovec, text, c, *rest: codes.append(np.asarray(c).copy())
                        or finish(spk, emovec, text, c, *rest))
    for i, seg in enumerate(_segments()):
        got = pe.infer(wav_path, [seg], seed=0, num_beams=nb, do_sample=False)["audio"]
        want = pe0.infer(wav_path, [seg], seed=0, num_beams=nb, do_sample=False)["audio"]
        np.testing.assert_array_equal(got, want)
        jcodes = _jax_codes(je, wav_path, seg, nb)
        assert len(jcodes) > 8
        np.testing.assert_array_equal(codes[i], jcodes)
        assert list(pe._text_prefix_cache) == list(je._text_prefix_cache)
        (key, m, _), = pe._text_prefix_cache
        assert (key, m) == ((wav_path, "", 1.0, None), 8)
        (pk, _), _ = next(iter(pe._text_prefix_cache.values()))
        assert pk.shape[3] == P + 1 + 8
        bucket = min(-(-len(seg) // 16) * 16, 32) if beam else len(seg)
        assert seen[i] == bucket + 2 - 8
    assert len(seen) == 2


def test_engine_text_prefix_cache_holds_8(engines):
    """Nine texts of distinct prefixes under one key: the oldest entry goes,
    8 stay; each entry is the text-prefix KV of its grid prefix."""
    from indextts_tpu_torch.runtime.engine import EmotionConditioning

    _, pe, _ = engines(False)
    pe._text_prefix_cache.clear()
    spk = pe.prepare_speaker(speech_like(np.random.default_rng(8), 1.0, 16000), 16000)
    emo = EmotionConditioning(spk.spk_cond_emb, spk.cond_len)
    key = ("spk.wav", "", 1.0, None)
    texts = [np.full(9, 2 + i) for i in range(9)]
    for text in texts:
        _, conds, prefix = pe._segment_inputs(spk, emo, 1.0, key, text_ids=text)
        want = pe.decoder.text_prefix_prefill(conds, text[:8])
        assert all(torch.equal(a, b) for a, b in zip(prefix, want))
    assert list(pe._text_prefix_cache) == [
        (key, 8, hashlib.sha256(np.asarray(x[:8], np.int32).tobytes()).hexdigest())
        for x in texts[1:]]


def test_engine_text_prefix_kv_needs_left_alignment(engines):
    """The prefill drops the tail's first positions as a text prefix's, so
    a text-prefix KV on a right-aligned prompt raises; on a left-aligned
    one it decodes."""
    from indextts_tpu_torch.runtime.engine import EmotionConditioning

    _, pe, _ = engines(False)
    spk = pe.prepare_speaker(speech_like(np.random.default_rng(8), 1.0, 16000), 16000)
    emo = EmotionConditioning(spk.spk_cond_emb, spk.cond_len)
    text = _segments()[0]
    _, conds, prefix = pe._segment_inputs(spk, emo, 1.0, ("spk.wav", "", 1.0, None),
                                          text_ids=text)
    assert prefix[0].shape[3] == P + 1 + 8
    with pytest.raises(ValueError, match="left-aligned"):
        pe._generate_codes(conds, text, prefix, max_mel_tokens=4, seed=0, do_sample=False)
    codes = pe._generate_codes(conds, text, prefix, max_mel_tokens=4, seed=0,
                               do_sample=False, align="left")
    assert 0 < len(codes) <= 5


@pytest.mark.parametrize("case", ["unkeyed", "no_cond_kv", "short"])
def test_engine_no_lookup(engines, wav_path, monkeypatch, case):
    """No text-prefix lookup for an (audio, sr) prompt or under a layout
    that prefills whole ("pallas_ragged"): their prompts stay right-aligned;
    a text shorter than the grid looks up, finds nothing and reuses the
    conditioning prefix on a left-aligned prompt."""
    from indextts_tpu_torch.utils import audio as audio_utils

    _, pe, _ = engines(False)
    lookups, aligns = [], []
    orig_lookup, orig_build = pe._lookup_text_prefix, pe.decoder.build_text_prompt_arrays
    monkeypatch.setattr(pe, "_lookup_text_prefix",
                        lambda *a: lookups.append(a[2]) or orig_lookup(*a))
    monkeypatch.setattr(pe.decoder, "build_text_prompt_arrays",
                        lambda *a, **k: aligns.append(a[3]) or orig_build(*a, **k))
    seg = _segments()[0]
    prompt = wav_path
    if case == "unkeyed":
        prompt = audio_utils.load_wav(wav_path)
    elif case == "no_cond_kv":
        monkeypatch.setattr(pe.decoder, "attn_impl", "pallas_ragged")
    else:
        seg = seg[:GRAN - 1]
    pe.infer(prompt, [seg], seed=0)
    if case == "short":
        assert len(lookups) == 1 and aligns == ["left"]
    else:
        assert lookups == [] and aligns == ["right"]
