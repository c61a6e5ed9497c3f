"""The port's beam search (runtime/decode.py `GPTDecoder.generate_beam`)
against the JAX package's, on the CPU at the tiny size, with 3 beams.

* Deterministic beam is token-exact with JAX `generate_beam` in float32 on
  the float cache: codes and length, with and without the conditioning
  prefix's KV, at length_penalty 0 and 1, with and without a left-pad hole
  in the prompt, and where HF's is_done ends the search before max_new.
* W8 blocks, the int8 head and the int8 cache against the JAX quantized
  beam (its GEMV and MLP kernels in interpret mode), on a weight seed whose
  beams have no near tie.
* Beam-multinomial draws from another RNG stream, so it is held to JAX's
  distribution: the warped scores a beam (min_tokens_to_keep=2) within
  1e-6 of JAX's on the same logits; over 20000 seeded draws, how often each
  entry comes first and how often it is among the 2 nb draws within 0.02
  of JAX's Gumbel-top-k; at top_p -> 0 the codes of every seed are JAX's.
* The engine routes num_beams > 1 to it: `infer(num_beams=3,
  do_sample=False)` gives the JAX engine's codes and waveform;
  `precompile(num_beams=3)` counts the JAX engine's jobs; the CLI at a
  3-beam config writes a WAV; `serve.py --num-beams` defaults to 1 and
  reads TARS_NUM_BEAMS.
"""

import wave

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from indextts_tpu_torch.weights import from_jax_params, quantize_gpt_state_dict
from torch_parity import n, parity_config, parity_params, speech_like, t, to_port_config

NB = 3
MAX_NEW = 24


def _decoders(seed: int, do_sample: bool = False):
    """The tiny config's GPT from the JAX parity parameters of `seed`: the
    JAX decoder (attn_impl "xla", the float cache) with its tree, and the
    port's decoder on the CPU."""
    from indextts_tpu.models.unified_voice import UnifiedVoice as JUV
    from indextts_tpu.runtime.decode import GPTDecoder as JDecoder
    from indextts_tpu.runtime.decode import SamplingConfig as JSampling

    from indextts_tpu_torch.runtime.decode import GPTDecoder, SamplingConfig
    from indextts_tpu_torch.runtime.engine import load_model

    cfg = parity_config()
    pcfg = to_port_config(cfg)
    jp = parity_params(cfg, seed=seed)
    jdec = JDecoder(JUV(cfg.gpt, attn_impl="xla"), cfg.gpt, JSampling(do_sample=do_sample))
    gpt = load_model("gpt", pcfg, from_jax_params(jp, pcfg)["gpt"], "cpu")
    return jdec, {"params": jp["gpt"]}, GPTDecoder(gpt, pcfg.gpt,
                                                   SamplingConfig(do_sample=do_sample))


@pytest.fixture(scope="module")
def decoders():
    # weights whose hypotheses run long (21-23 codes of 24)
    return _decoders(4)


def _prompt(dec, seed: int, n_text: int, bucket: int, dim: int):
    rng = np.random.default_rng(seed)
    conds = rng.standard_normal((1, 34, dim)).astype(np.float32)
    text = rng.integers(2, 50, (1, n_text))
    return conds, dec.build_text_prompt_arrays(text, np.array([n_text]), bucket)


def _both(jdec, jparams, pdec, conds, arrays, cond_kv=False, seed=None, **kw):
    """One beam search on each side from the same prompt, a sampled one
    from `seed` (JAX's key, the port's generator): (JAX result, port
    result)."""
    jkv = jdec.cond_prefill(jparams, jnp.asarray(conds)) if cond_kv else None
    pkv = pdec.cond_prefill(t(conds)) if cond_kv else None
    key = None if seed is None else jax.random.PRNGKey(seed)
    want = jdec.generate_beam(jparams, jnp.asarray(conds), *(jnp.asarray(a) for a in arrays),
                              max_new=MAX_NEW, num_beams=NB, cond_kv=jkv, key=key, **kw)
    got = pdec.generate_beam(t(conds), *(t(a) for a in arrays), seed, max_new=MAX_NEW,
                             num_beams=NB, cond_kv=pkv, **kw)
    return want, got


def _assert_same(want, got):
    np.testing.assert_array_equal(n(got.codes), np.asarray(want.codes))
    np.testing.assert_array_equal(n(got.lengths), np.asarray(want.lengths))


@pytest.mark.parametrize("n_text", [7, 16])
@pytest.mark.parametrize("length_penalty", [0.0, 1.0])
@pytest.mark.parametrize("cond_kv", [False, True])
def test_deterministic_beam_token_exact(decoders, cond_kv, length_penalty, n_text):
    """Equal codes and lengths. 7 ids in a bucket of 16 put a left-pad hole
    in the prompt, which K1's plain version masks; with cond_kv the prefix's
    KV comes from `cond_prefill` on both sides."""
    jdec, jparams, pdec = decoders
    conds, arrays = _prompt(jdec, n_text, n_text, 16, 64)
    want, got = _both(jdec, jparams, pdec, conds, arrays, cond_kv=cond_kv,
                      length_penalty=length_penalty)
    _assert_same(want, got)
    L = int(want.lengths[0])
    assert L > 12 and len(set(np.asarray(want.codes)[0, :L].tolist())) > 8


@pytest.mark.parametrize("length_penalty", [0.0, 1.0])
def test_deterministic_beam_stops_early_as_jax(monkeypatch, length_penalty):
    """Weights whose pool fills early: HF's is_done ends the search before
    max_new on the JAX side (its loop condition) and on the port's (a
    step that freezes the state once it holds, the host's finish check
    every 16 steps). Equal codes and lengths, and the port's state stopped
    at the JAX loop's last step (read from its final state through
    jax.debug.callback), short of max_new."""
    from indextts_tpu_torch.runtime.decode import BeamState

    steps = []
    while_loop = jax.lax.while_loop

    def recorded(cond, body, init):
        out = while_loop(cond, body, init)
        jax.debug.callback(lambda s: steps.append(int(s)), out[0])
        return out

    monkeypatch.setattr(jax.lax, "while_loop", recorded)
    jdec, jparams, pdec = _decoders(3)
    for seed in (0, 1):
        conds, arrays = _prompt(jdec, seed, 7, 16, 64)
        want, got = _both(jdec, jparams, pdec, conds, arrays, length_penalty=length_penalty)
        _assert_same(want, got)
        (st,) = [s for s in pdec._states.values() if isinstance(s, BeamState)]
        assert int(got.lengths[0]) <= int(st.step) == steps[-1] < MAX_NEW
        assert bool(st.finished.all())


def test_top_first_orders_ties_as_jax():
    """Candidate and pool selection break ties as jax.lax.top_k does, the
    lower index first: on a first step's flattened scores, where the beams
    at NEG_INF collapse to equal float32 values (their spacing is 64 near
    1e9), and on a pool of NEG_INF entries."""
    from indextts_tpu_torch.runtime.decode import NEG_INF, top_first

    rng = np.random.default_rng(0)
    logp = np.log(rng.dirichlet(np.ones(36), 3)).astype(np.float32)
    logp[0, 6:] = NEG_INF  # the warpers kept six tokens of the first beam
    flat = (np.array([0, NEG_INF, NEG_INF], np.float32)[:, None] + logp).ravel()
    pool = np.array([NEG_INF, -3.5, NEG_INF, NEG_INF, -3.5, NEG_INF, -1, NEG_INF, NEG_INF],
                    np.float32)
    for x, k in ((flat, 40), (pool, 3), (pool, 6)):
        want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
        got_v, got_i = top_first(t(x), k)
        np.testing.assert_array_equal(n(got_i), np.asarray(want_i))
        np.testing.assert_array_equal(n(got_v), np.asarray(want_v))


def test_w8_beam_matches_jax_quantized():
    """W8A8 blocks, the int8 head and the int8 cache (D=512, 8 heads, 2
    layers: every gate of the GEMV and MLP kernels opens) against the JAX
    quantized beam, its kernels in interpret mode over its int8 cache
    (kv_quant), on two prompts, the second on top of the prefix's float KV
    (quantized with the tail, as the JAX decoder does). One int8 rounding can turn float32 noise
    (XLA's fused programs against PyTorch's ops) into a flip of a near
    tie, which ends the agreement on some weights (seeds 2 and 3 here), so
    the weights' seed is one whose beams have none on these prompts, as
    test_torch_quant.py picks its seed."""
    import dataclasses

    from indextts_tpu.models.unified_voice import UnifiedVoice as JUV
    from indextts_tpu.runtime.decode import GPTDecoder as JDecoder
    from indextts_tpu.runtime.decode import SamplingConfig as JSampling
    from indextts_tpu.runtime.torch_convert import quantize_gpt_tree

    from indextts_tpu_torch import weights
    from indextts_tpu_torch.runtime.decode import GPTDecoder, SamplingConfig
    from indextts_tpu_torch.runtime.engine import load_model
    from test_engine_e2e import tiny_config
    from test_torch_quant import _gpt_config, _jax_gpt_tree

    gcfg = _gpt_config(512, 8)
    tree = _jax_gpt_tree(gcfg, seed=1)
    jmodel = JUV(gcfg, quantize_gpt=True, head_quant=True, attn_impl="xla", kv_quant=True,
                 gemv_impl="pallas", wbits=8, pallas_interpret=True)
    jdec = JDecoder(jmodel, gcfg, JSampling(do_sample=False))
    jparams = {"params": quantize_gpt_tree(tree, head=True, bits=8)}
    cfg = tiny_config()
    rt = dataclasses.replace(cfg.runtime, gpt_quantize=True, head_quant=True, gemv_impl="pallas")
    pcfg = to_port_config(dataclasses.replace(cfg, gpt=gcfg, runtime=rt))
    sd = quantize_gpt_state_dict(weights.unified_voice_sd(tree, pcfg), head=True, bits=8)
    pdec = GPTDecoder(load_model("gpt", pcfg, sd, "cpu"), pcfg.gpt,
                      SamplingConfig(do_sample=False), kv_int8=True)
    for seed in (0, 1):
        conds, arrays = _prompt(jdec, seed, 7, 16, 512)
        want, got = _both(jdec, jparams, pdec, conds, arrays, cond_kv=seed == 1)
        _assert_same(want, got)
        L = int(want.lengths[0])
        assert L > 12 and len(set(np.asarray(want.codes)[0, :L].tolist())) > 8
    assert pdec._states[("beam", NB, 256)].caches[0].dtype == torch.int8


def test_pallas_q8_beam_keeps_a_float_cache(decoders):
    """attn_impl="pallas_q8" without kv_quant gives the sampling loop an
    int8 cache, but the JAX model serves its beam search a float cache
    (indextts_tpu/models/gpt2.py:831-833): the port's beam state on such a
    decoder is float, and its codes are the JAX float beam's."""
    from indextts_tpu_torch.runtime.decode import GPTDecoder

    jdec, jparams, pdec = decoders
    q8 = GPTDecoder(pdec.model, pdec.cfg, pdec.sampling, kv_int8=True, attn_impl="pallas_q8")
    conds, arrays = _prompt(jdec, 7, 7, 16, 64)
    want, _ = _both(jdec, jparams, pdec, conds, arrays)
    got = q8.generate_beam(t(conds), *(t(a) for a in arrays), None, max_new=MAX_NEW,
                           num_beams=NB)
    _assert_same(want, got)
    (st,) = q8._states.values()
    assert st.caches[0].dtype == torch.float32 and len(st.caches) == 2


class _Stop(Exception):
    pass


@pytest.mark.parametrize("temperature,top_p", [(0.8, 0.8), (1.3, 0.3), (0.7, 0.02)])
def test_beam_warpers_match_jax(decoders, monkeypatch, temperature, top_p):
    """The scores of a sampled beam step on the same logits: the JAX loop
    runs eagerly (jax.disable_jit) up to its first candidate draw, with its
    log_softmax fed seeded logits (rows of the penalized fake-prompt
    tokens {1, start_mel} included) and its Gumbel noise zero, so the
    scores it draws from are beam_scores + the warped rows; the port's
    chain (repetition penalty, then temperature, top-k 30, top-p with two
    tokens kept) gives the first beam's row, whose score is 0, within 1e-6,
    and the same tokens at NEG_INF. At top_p 0.3 and 0.02 one token would
    pass top-p alone: min_tokens_to_keep keeps two."""
    from indextts_tpu_torch.runtime import decode as pdecode

    jdec, jparams, pdec = decoders
    V = jdec.cfg.number_mel_codes
    seen = {}
    rng = np.random.default_rng(int(temperature * 10))
    logits = (rng.standard_normal((NB, V)) * 3).astype(np.float32)
    logits[:, 5] += 6.0  # one dominant token
    log_softmax, top_k = jax.nn.log_softmax, jax.lax.top_k

    def fed(x, axis=-1):
        return log_softmax(jnp.asarray(logits), axis=axis)

    def record(x, k):
        if k == 2 * NB and x.shape == (NB * V,):
            seen["flat"] = np.asarray(x).reshape(NB, V)
            raise _Stop
        return top_k(x, k)

    monkeypatch.setattr(jax.nn, "log_softmax", fed)
    monkeypatch.setattr(jax.lax, "top_k", record)
    monkeypatch.setattr(jax.random, "gumbel", lambda key, shape, dtype=jnp.float32:
                        jnp.zeros(shape, dtype))
    conds, arrays = _prompt(jdec, 1, 7, 16, 64)
    with jax.disable_jit(), pytest.raises(_Stop):
        jdec.generate_beam(jparams, jnp.asarray(conds), *(jnp.asarray(a) for a in arrays),
                           max_new=4, num_beams=NB, do_sample=True, key=jax.random.PRNGKey(0),
                           temperature=temperature, top_p=top_p)
    penal = torch.zeros((NB, V), dtype=torch.bool)
    penal[:, [1, jdec.cfg.start_mel_token]] = True
    lp = pdecode.repetition_penalty(torch.log_softmax(t(logits), -1), penal, 10.0)
    vals, idx = pdecode.warp_top_k_top_p(lp, temperature, top_p, 30, min_tokens_to_keep=2)
    mine = torch.full_like(lp, pdecode.NEG_INF).scatter_(1, idx, vals)[0].numpy()
    want = seen["flat"][0]
    kept = want > -1e8
    np.testing.assert_array_equal(mine > -1e8, kept)
    np.testing.assert_allclose(mine[kept], want[kept], rtol=1e-6)
    assert (mine[~kept] == pdecode.NEG_INF).all()
    assert kept.sum() == 2 if top_p < 0.8 else kept.sum() > 2


def test_candidate_draws_match_jax_gumbel_top_k():
    """2 nb draws without replacement from softmax(scores) over a small
    flattened score vector (a beam at NEG_INF offset among them), 20000
    seeded draws on each side: the port's exponential race and JAX's
    Gumbel-top-k (`flat + gumbel`, `jax.lax.top_k`, as its loop draws).
    How often each entry comes first, and how often it is among the draws,
    agree within 0.02; the first draw also follows the softmax within
    0.02. A draw at twice the scores' spread lands far outside."""
    from indextts_tpu_torch.runtime.decode import NEG_INF, draw_candidates

    rng = np.random.default_rng(3)
    flat = (rng.standard_normal(3 * 12) * 1.5).astype(np.float32)
    flat[24:] += np.float32(NEG_INF)  # a beam of score NEG_INF
    flat[3] = np.float32(NEG_INF)  # a token the warpers dropped
    draws, k = 20000, 2 * NB

    def freqs(idx):
        first = np.bincount(idx[:, 0], minlength=flat.size) / draws
        among = np.bincount(idx.ravel(), minlength=flat.size) / draws
        return first, among

    g = torch.Generator().manual_seed(0)
    mine = freqs(n(draw_candidates(t(np.tile(flat, (draws, 1))), g, k)))
    gumbel = jax.random.gumbel(jax.random.PRNGKey(0), (draws, flat.size), jnp.float32)
    theirs = freqs(np.asarray(jax.lax.top_k(jnp.asarray(flat) + gumbel, k)[1]))
    p = np.exp(flat - flat.max())
    p /= p.sum()
    assert np.abs(mine[0] - theirs[0]).max() <= 0.02
    assert np.abs(mine[1] - theirs[1]).max() <= 0.02
    assert np.abs(mine[0] - p).max() <= 0.02
    assert mine[1][3] == 0 and mine[1][24:].sum() == 0
    sharp = freqs(n(draw_candidates(t(np.tile(2 * flat, (draws, 1))), g, k)))
    assert np.abs(sharp[0] - p).max() > 0.1


@pytest.mark.parametrize("seed", [1, 7])
def test_sampled_beam_at_top_p_zero_is_jax_codes(seed):
    """temperature 1e-4 and top_p 1e-6 leave each beam its two best tokens
    (min_tokens_to_keep=2), so the candidates are no longer random where it
    matters (tests/test_decode_invariants.py holds this for JAX): two seeds
    give the same codes, and those of the JAX sampled beam."""
    jdec, jparams, pdec = _decoders(seed, do_sample=True)
    conds, arrays = _prompt(jdec, 0, 7, 16, 64)
    kw = dict(do_sample=True, temperature=1e-4, top_p=1e-6)
    want, got = _both(jdec, jparams, pdec, conds, arrays, seed=0, **kw)
    _assert_same(want, got)
    again = pdec.generate_beam(t(conds), *(t(a) for a in arrays), 9, max_new=MAX_NEW,
                               num_beams=NB, **kw)
    _assert_same(want, again)
    assert int(want.lengths[0]) > 8
    free = [n(pdec.generate_beam(t(conds), *(t(a) for a in arrays), s, max_new=MAX_NEW,
                                 num_beams=NB, do_sample=True, temperature=0.8,
                                 top_p=0.8).codes) for s in (1, 2, 3)]
    assert any(not np.array_equal(f, free[0]) for f in free[1:])


# ---------------------------------------------------------------------------
# the engine, precompile, the CLI and the server
# ---------------------------------------------------------------------------


def test_engine_beam_matches_jax_engine():
    """Both engines at their defaults (bucketed tail; the decode prompt's
    text padded to a 16-bucket on both), num_beams=3, deterministic: the
    port's codes are the JAX engine's, its waveform within 1e-3 of the
    JAX peak (test_default_route_waveform_matches_jax's bound)."""
    from indextts_tpu.runtime.engine import IndexTTS2Engine as JaxEngine

    from test_torch_s2mel_graph import _inputs, _port
    from test_torch_slice import _capture_codes
    from test_torch_tail_buckets import _noise

    cfg = parity_config()
    jp = parity_params(cfg, seed=4)
    noise = _noise()
    prompt, text = _inputs()
    out = {}
    for name, eng in (("jax", JaxEngine(cfg, jp)), ("port", _port(cfg, jp))):
        codes = []
        eng._noise_hook = noise
        _capture_codes(eng, codes)
        res = eng.infer((prompt, 16000), [text], seed=0, num_beams=NB, do_sample=False)
        out[name] = (codes[0], res["audio"])
    (jc, jw), (pc, pw) = out["jax"], out["port"]
    np.testing.assert_array_equal(pc, jc)
    assert len(jc) > 8
    assert pw.shape == jw.shape
    peak = np.abs(jw).max()
    assert 0 < peak < 1.0
    assert np.abs(pw - jw).max() <= 1e-3 * peak


def test_precompile_beam_counts_jax_jobs():
    """precompile(num_beams=3) on the CPU returns the JAX engine's job count
    for the same grid (the JAX programs recorded and skipped), whose decode
    jobs are beam searches, one a text bucket."""
    import dataclasses

    from indextts_tpu.runtime.engine import IndexTTS2Engine as JaxEngine
    from indextts_tpu.runtime.engine import SpeakerConditioning as JaxSpeaker

    from indextts_tpu_torch.runtime.engine import SpeakerConditioning
    from test_torch_s2mel_graph import _port

    cfg = parity_config()
    jp = parity_params(cfg, seed=1)
    je = JaxEngine(cfg, jp)
    beams = []
    skip = lambda *a, **kw: None  # noqa: E731
    je._emovec_program = je._build_conds_program = je._latent_program = skip
    je._s2mel_program = je._vocoder_f32_program = je._vocoder_pcm16_f32_program = skip
    je.decoder.generate = lambda *a, **kw: pytest.fail("the sampling loop at num_beams=3")
    je.decoder.generate_beam = lambda p, conds, ids, *a, **kw: beams.append(
        (ids.shape[1] - 2, kw["num_beams"]))
    ref, D, z = 37, cfg.gpt.model_dim, np.zeros
    jspk = JaxSpeaker(z((1, 20, 1024), np.float32), 20, z((1, 192), np.float32),
                      z((1, ref, 512), np.float32), z((1, 80, ref), np.float32), ref,
                      z((1, 32, D), np.float32))
    pspk = SpeakerConditioning(*(torch.as_tensor(a) if isinstance(a, np.ndarray) else a
                                 for a in dataclasses.astuple(jspk)))
    kw = dict(code_lens=[5, 70], decode_variants="raw", num_beams=NB)
    n_jax = je.precompile(jspk, workers=1, **kw)
    assert beams == [(16, NB), (32, NB)]
    assert _port(cfg, jp).precompile(pspk, **kw) == n_jax


def test_cli_default_beam_config_writes_a_wav(tmp_path, monkeypatch):
    """The CLI at a config of 3 beams with sampling (the config's default
    route, the reference's beam-multinomial) decodes through generate_beam
    and writes a mono 16-bit WAV on the CPU."""
    from indextts_tpu_torch import cli
    from indextts_tpu_torch.runtime.decode import GPTDecoder
    from indextts_tpu_torch.utils import audio as audio_utils

    voice, out_path = str(tmp_path / "voice.wav"), str(tmp_path / "out.wav")
    audio_utils.save_wav(voice, speech_like(np.random.default_rng(2), 1.0, 16000), 16000)
    calls = []
    beam = GPTDecoder.generate_beam

    def spy(self, *a, **kw):
        calls.append((kw["num_beams"], kw["do_sample"]))
        return beam(self, *a, **kw)

    monkeypatch.setattr(GPTDecoder, "generate_beam", spy)
    out = cli.main(["hello", "-v", voice, "-o", out_path, "--seed", "1", "--device", "cpu"],
                   cfg=to_port_config(parity_config(num_beams=3, do_sample=True)))
    assert calls == [(3, True)]
    with wave.open(out_path) as w:
        assert (w.getnchannels(), w.getsampwidth(), w.getframerate()) == (1, 2, 22050)
        assert w.getnframes() == len(out["audio"]) > 0


@pytest.mark.parametrize("env,argv,want", [(None, [], 1), ("3", [], 3),
                                           ("3", ["--num-beams", "2"], 2)])
def test_serve_num_beams_flag(monkeypatch, env, argv, want):
    """serve.py's --num-beams: 1 by default, TARS_NUM_BEAMS when set, the
    flag over both; the engine's runtime.num_beams takes it."""
    from indextts_tpu_torch import serve

    if env is None:
        monkeypatch.delenv("TARS_NUM_BEAMS", raising=False)
    else:
        monkeypatch.setenv("TARS_NUM_BEAMS", env)
    monkeypatch.setenv("TARS_PRECOMPILE", "0")
    monkeypatch.delenv("TARS_REFERENCE_AUDIO", raising=False)
    server, engine = serve.build(["--port", "0", "--device", "cpu", *argv],
                                 cfg=to_port_config(parity_config(num_beams=3)))
    assert engine.cfg.runtime.num_beams == want
    server.pool.shutdown(wait=True)
