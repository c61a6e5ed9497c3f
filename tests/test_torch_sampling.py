"""The decoder's sampling knobs (runtime/decode.py `SamplingConfig`) against
the JAX package's, on the CPU at the tiny size.

* `typical_filter` against JAX's on seeded logits, rows with ties included,
  at masses 0.1, 0.5, 0.9 and 0.99: the same kept set and the kept values
  within 1e-6.
* Greedy codes token-exact with JAX's GPTDecoder on the same converted
  weights, each knob flipped on its own (typical_mass under typical
  sampling), on the sequential route (`generate`), the slot route (the
  continuous batchers) and the beam route (`generate_beam`, which ignores
  use_typical_sampling, as JAX's does).
* `ban_stop_token` decodes exactly max_new codes, greedy and sampled.
* Sampled decode draws from another RNG stream, so it is held to JAX's
  warped distribution: the (logit, token) pairs the JAX chain (penalty ->
  typical filter -> stop ban -> temperature -> top-k -> top-p) hands to its
  categorical draw, within 1e-6; and every draw lands on a kept token.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from indextts_tpu_torch.weights import from_jax_params
from torch_parity import n, parity_config, parity_params, t, to_port_config

MAX_NEW = 16
BUCKET = 8
NB = 3
# each knob flipped on its own from the defaults; typical_mass under typical
# sampling, where it acts
KNOBS = {
    "no_penalty": dict(use_repetition_penalty=False),
    "no_fake_prompt": dict(hf_fake_prompt_penalty=False),
    "ban_stop": dict(ban_stop_token=True),
    "typical": dict(use_typical_sampling=True),
    "typical_mass": dict(use_typical_sampling=True, typical_mass=0.5),
}


@pytest.fixture(scope="module")
def weights():
    """The tiny config, the JAX parity parameters' GPT tree and the port's
    GPT on the same weights."""
    from indextts_tpu_torch.runtime.engine import load_model

    cfg = parity_config()
    pcfg = to_port_config(cfg)
    # weights whose greedy rows stop after 10-14 codes, so that the stop ban
    # changes them
    jp = parity_params(cfg, seed=2)
    gpt = load_model("gpt", pcfg, from_jax_params(jp, pcfg)["gpt"], "cpu")
    return cfg, pcfg, {"params": jp["gpt"]}, gpt


def _decoders(weights, do_sample=False, **knobs):
    from indextts_tpu.models.unified_voice import UnifiedVoice as JUV
    from indextts_tpu.runtime.decode import GPTDecoder as JDecoder
    from indextts_tpu.runtime.decode import SamplingConfig as JSampling

    from indextts_tpu_torch.runtime.decode import GPTDecoder, SamplingConfig

    cfg, pcfg, jparams, gpt = weights
    jdec = JDecoder(JUV(cfg.gpt, attn_impl="xla"), cfg.gpt,
                    JSampling(do_sample=do_sample, **knobs))
    return jdec, jparams, GPTDecoder(gpt, pcfg.gpt, SamplingConfig(do_sample=do_sample, **knobs))


def _prompt(dec, seed: int, n_text: int, bucket: int = BUCKET):
    rng = np.random.default_rng(seed)
    conds = rng.standard_normal((1, 34, 64)).astype(np.float32)
    text = rng.integers(2, 50, (1, n_text))
    return conds, text, dec.build_text_prompt_arrays(text, np.array([n_text]), bucket)


def test_sampling_config_has_jax_fields_and_defaults():
    from indextts_tpu.runtime.decode import SamplingConfig as JSampling

    from indextts_tpu_torch.runtime.decode import SamplingConfig

    want = [(f.name, f.default) for f in dataclasses.fields(JSampling)]
    assert [(f.name, f.default) for f in dataclasses.fields(SamplingConfig)] == want
    with pytest.raises(dataclasses.FrozenInstanceError):
        SamplingConfig().ban_stop_token = True


def _typical_logits():
    """Seeded rows, two of them with ties: a row of a few repeated values
    and a row whose penalized copies make equal logits."""
    rng = np.random.default_rng(21)
    rows = (rng.standard_normal((6, 36)) * 2.5).astype(np.float32)
    rows[1] = rng.choice(np.float32([-1.0, 0.5, 2.0]), 36)
    rows[2, ::3] = rows[2, 0]
    rows[3] = 0.0
    return rows


@pytest.mark.parametrize("mass", [0.1, 0.5, 0.9, 0.99])
def test_typical_filter_matches_jax(mass):
    """The same kept set (NEG_INF elsewhere) and the kept values within
    1e-6, ties included (the stable argsort keeps the lower index first on
    both sides)."""
    from indextts_tpu.runtime import decode as jdecode

    from indextts_tpu_torch.runtime import decode as pdecode

    logits = _typical_logits()
    want = np.asarray(jdecode.typical_filter(jnp.asarray(logits), mass))
    got = n(pdecode.typical_filter(t(logits), mass))
    np.testing.assert_array_equal(got > -1e8, want > -1e8)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    kept = (got > -1e8).sum(axis=1)
    # the uniform row keeps every token; others lose some
    assert kept.min() >= 1 and kept[3] == logits.shape[1]
    assert (kept < logits.shape[1]).sum() >= 4


def test_typical_filter_min_tokens_to_keep():
    from indextts_tpu.runtime import decode as jdecode

    from indextts_tpu_torch.runtime import decode as pdecode

    logits = _typical_logits()
    want = np.asarray(jdecode.typical_filter(jnp.asarray(logits), 0.1, min_tokens_to_keep=3))
    got = n(pdecode.typical_filter(t(logits), 0.1, min_tokens_to_keep=3))
    np.testing.assert_array_equal(got > -1e8, want > -1e8)
    assert (got > -1e8).sum(axis=1).min() >= 3


@pytest.mark.parametrize("knob", list(KNOBS))
def test_sequential_greedy_matches_jax(weights, knob):
    """`generate`, greedy, two prompts (one with a left-pad hole): equal
    codes and lengths."""
    jdec, jparams, pdec = _decoders(weights, **KNOBS[knob])
    for seed, n_text in ((1, 6), (2, 8)):
        conds, _, arrays = _prompt(jdec, seed, n_text)
        want = jdec.generate(jparams, jnp.asarray(conds), *(jnp.asarray(a) for a in arrays),
                             jax.random.PRNGKey(0), max_new=MAX_NEW)
        got = pdec.generate(t(conds), *(t(a) for a in arrays), None, max_new=MAX_NEW,
                            do_sample=False)
        np.testing.assert_array_equal(n(got.codes), np.asarray(want.codes))
        np.testing.assert_array_equal(n(got.lengths), np.asarray(want.lengths))


@pytest.mark.parametrize("knob", list(KNOBS))
def test_slot_greedy_matches_jax_batcher(weights, knob):
    """The continuous batchers, 3 requests on 2 slots in chunks of 4 steps:
    equal codes a request."""
    from indextts_tpu.runtime.batcher import ContinuousBatcher as JBatcher

    from indextts_tpu_torch.runtime.batcher import ContinuousBatcher

    jdec, jparams, pdec = _decoders(weights, **KNOBS[knob])
    reqs = [_prompt(jdec, 10 + i, 4 + i)[:2] for i in range(3)]
    jbat = JBatcher(jdec, jparams, n_slots=2, text_bucket=BUCKET, max_new=MAX_NEW,
                    chunk_steps=4)
    pbat = ContinuousBatcher(pdec, n_slots=2, text_bucket=BUCKET, max_new=MAX_NEW,
                             chunk_steps=4)
    for conds, text in reqs:
        jbat.submit(jnp.asarray(conds), text[0])
        pbat.submit(t(conds), text[0])
    want = [c.codes for c in jbat.run()]
    got = [c.codes for c in pbat.run()]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if KNOBS[knob].get("ban_stop_token"):
        assert all(len(g) == MAX_NEW for g in got)


@pytest.mark.parametrize("knob", list(KNOBS))
def test_beam_greedy_matches_jax(weights, knob):
    """Deterministic 3-beam search: equal codes and length. The typical
    knobs leave both sides' beams as they are."""
    jdec, jparams, pdec = _decoders(weights, **KNOBS[knob])
    conds, _, arrays = _prompt(jdec, 3, 7, 16)
    want = jdec.generate_beam(jparams, jnp.asarray(conds), *(jnp.asarray(a) for a in arrays),
                              max_new=MAX_NEW, num_beams=NB)
    got = pdec.generate_beam(t(conds), *(t(a) for a in arrays), None, max_new=MAX_NEW,
                             num_beams=NB)
    np.testing.assert_array_equal(n(got.codes), np.asarray(want.codes))
    np.testing.assert_array_equal(n(got.lengths), np.asarray(want.lengths))
    if KNOBS[knob].get("ban_stop_token"):
        assert int(got.lengths[0]) == MAX_NEW


@pytest.mark.parametrize("do_sample", [False, True])
def test_ban_stop_token_decodes_max_new(weights, do_sample):
    """Every row decodes exactly max_new codes, none of them the stop
    token, on weights whose rows stop early without the ban."""
    cfg = weights[0]
    stop = cfg.gpt.stop_mel_token
    _, _, free = _decoders(weights, do_sample=do_sample)
    _, _, banned = _decoders(weights, do_sample=do_sample, ban_stop_token=True)
    conds, _, arrays = _prompt(free, 5, 6)
    args = (t(conds), *(t(a) for a in arrays))
    lengths = [int(free.generate(*args, s, max_new=40).lengths[0]) for s in range(4)]
    assert min(lengths) < 40
    for s in range(4):
        res = banned.generate(*args, s, max_new=40)
        assert int(res.lengths[0]) == 40
        assert not (n(res.codes) == stop).any()


@pytest.mark.parametrize("typical", [False, True])
def test_sampled_warped_distribution_matches_jax(weights, monkeypatch, typical):
    """On the same logits and penalty set: the JAX chain's warped (logit,
    token) pairs, recorded where it calls jax.random.categorical, equal the
    port's `_processed` then `warp_top_k_top_p` within 1e-6, with the stop
    token banned and, with `typical`, the typical filter at mass 0.5. Every
    seeded draw of the port lands on a kept token."""
    from indextts_tpu.runtime import decode as jdecode

    from indextts_tpu_torch.runtime import decode as pdecode

    knobs = dict(ban_stop_token=True, use_typical_sampling=typical, typical_mass=0.5)
    _, _, pdec = _decoders(weights, do_sample=True, **knobs)
    cfg = weights[0]
    rng = np.random.default_rng(31)
    B, V, k = 4, cfg.gpt.number_mel_codes, 10
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    penal = rng.random((B, V)) < 0.2
    penal[:, [1, cfg.gpt.start_mel_token]] = True

    jl = jdecode._repetition_penalty(jnp.asarray(logits), jnp.asarray(penal), 10.0)
    if typical:
        jl = jdecode.typical_filter(jl, 0.5)
    jl = jl.at[:, cfg.gpt.stop_mel_token].set(jdecode.NEG_INF)
    seen = {}

    def categorical(key, vals, axis=-1):
        seen["vals"] = np.asarray(vals)
        return jnp.argmax(vals, axis=axis)

    monkeypatch.setattr(jdecode.jax.random, "categorical", categorical)
    jdecode._apply_top_k_top_p_sample(jl, jax.random.PRNGKey(0), jnp.float32(0.8),
                                      jnp.float32(0.8), k)

    st = SimpleNamespace(logits=t(logits), penal_mask=t(penal), penalty=torch.tensor(10.0))
    processed = pdec._processed(st)
    vals, idx = pdecode.warp_top_k_top_p(processed, 0.8, 0.8, k)
    np.testing.assert_allclose(n(vals), seen["vals"], rtol=1e-6)
    kept = [set(n(idx)[b][n(vals)[b] > -1e8].tolist()) for b in range(B)]
    assert all(cfg.gpt.stop_mel_token not in s for s in kept)
    g = torch.Generator().manual_seed(0)
    for _ in range(16):
        tok = pdecode.sample_top_k_top_p(processed, g, 0.8, 0.8, k)
        assert all(int(tok[b]) in kept[b] for b in range(B))
