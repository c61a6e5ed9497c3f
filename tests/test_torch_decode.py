"""The port's decode loop against the JAX package's GPTDecoder.

Greedy decode is token-exact in float32: the JAX decoder runs with
attn_impl="xla", which tests/test_decode_attention.py shows is token-exact
with "pallas_ragged"; the port attends through K1's plain version over its
natural cache with the prompt's left-pad hole. Sampled decode draws from
another RNG stream, so it is held to the JAX warper chain on the logits
(repetition penalty -> temperature -> top-k -> top-p), not to its tokens.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from indextts_tpu_torch.weights import from_jax_params
from torch_parity import n, parity_config, parity_params, t, to_port_config


@pytest.fixture(scope="module")
def decoders():
    from indextts_tpu.models.unified_voice import UnifiedVoice as JUV
    from indextts_tpu.runtime.decode import GPTDecoder as JDecoder
    from indextts_tpu.runtime.decode import SamplingConfig as JSampling

    from indextts_tpu_torch.runtime.decode import GPTDecoder, SamplingConfig
    from indextts_tpu_torch.runtime.engine import load_model

    cfg = parity_config()
    pcfg = to_port_config(cfg)
    jp = parity_params(cfg, seed=3)
    jdec = JDecoder(JUV(cfg.gpt, attn_impl="xla"), cfg.gpt, JSampling(do_sample=False))
    gpt = load_model("gpt", pcfg, from_jax_params(jp, pcfg)["gpt"], "cpu")
    pdec = GPTDecoder(gpt, pcfg.gpt, SamplingConfig(do_sample=False))
    return cfg, jdec, jp["gpt"], pdec


@pytest.mark.parametrize("n_text,bucket", [(7, 7), (5, 12)])
def test_greedy_codes_token_exact(decoders, n_text, bucket):
    """Same conds and text: equal codes and lengths. bucket > n_text puts a
    left-pad hole inside the prompt, which K1 masks."""
    cfg, jdec, jgpt, pdec = decoders
    rng = np.random.default_rng(n_text)
    conds = rng.standard_normal((1, 34, cfg.gpt.model_dim)).astype(np.float32)
    text = rng.integers(2, 50, (1, n_text))
    arrays = jdec.build_text_prompt_arrays(text, np.array([n_text]), bucket)
    want = jdec.generate({"params": jgpt}, jnp.asarray(conds),
                         *(jnp.asarray(a) for a in arrays), jax.random.PRNGKey(0),
                         max_new=20, repetition_penalty=10.0)
    ids, pos, valid = pdec.build_text_prompt_arrays(text, np.array([n_text]), bucket)
    got = pdec.generate(t(conds), t(ids), t(pos), t(valid), None, max_new=20,
                        repetition_penalty_value=10.0, do_sample=False)
    np.testing.assert_array_equal(n(got.codes), np.asarray(want.codes))
    np.testing.assert_array_equal(n(got.lengths), np.asarray(want.lengths))


def test_prompt_hole_follows_the_mask():
    """The hole is the contiguous masked run of the prompt mask
    (indextts_tpu/models/gpt2.py), empty when nothing is masked."""
    from indextts_tpu_torch.models.gpt2 import prompt_hole

    mask = torch.tensor([[1, 1, 0, 0, 0, 1, 1], [1, 1, 1, 1, 1, 1, 1]], dtype=torch.bool)
    hs, he = prompt_hole(mask)
    assert hs.tolist() == [2, 0] and he.tolist() == [5, 0]


def test_sampling_warpers_match_jax(monkeypatch):
    """Repetition penalty (fake-prompt tokens {1, start_mel} included), then
    temperature -> top-k -> top-p: the port keeps the same (logit, token)
    pairs, with NEG_INF where top-p drops one, as the JAX chain hands to its
    categorical draw. Tolerance 1e-6 (one division and a softmax)."""
    from indextts_tpu.runtime import decode as jdecode

    from indextts_tpu_torch.runtime import decode as pdecode

    rng = np.random.default_rng(11)
    B, V, k = 3, 36, 10
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    penal = rng.random((B, V)) < 0.2
    penal[:, [1, 34]] = True
    jl = jdecode._repetition_penalty(jnp.asarray(logits), jnp.asarray(penal), 10.0)
    pl = pdecode.repetition_penalty(t(logits), t(penal), 10.0)
    np.testing.assert_allclose(n(pl), np.asarray(jl), rtol=1e-6)

    seen = {}

    def categorical(key, vals, axis=-1):
        seen["vals"] = np.asarray(vals)
        return jnp.argmax(vals, axis=axis)

    monkeypatch.setattr(jdecode.jax.random, "categorical", categorical)
    for temperature, top_p in ((0.8, 0.8), (1.3, 0.3)):
        jtok = jdecode._apply_top_k_top_p_sample(
            jl, jax.random.PRNGKey(0), jnp.float32(temperature), jnp.float32(top_p), k)
        vals, idx = pdecode.warp_top_k_top_p(pl, temperature, top_p, k)
        np.testing.assert_allclose(n(vals), seen["vals"], rtol=1e-6)
        np.testing.assert_array_equal(n(idx)[np.arange(B), n(vals).argmax(-1)],
                                      np.asarray(jtok))
        # the draw only lands on tokens the warpers kept
        g = torch.Generator().manual_seed(0)
        for _ in range(8):
            tok = pdecode.sample_top_k_top_p(pl, g, temperature, top_p, k)
            kept = [set(n(idx)[b][n(vals)[b] > -1e8].tolist()) for b in range(B)]
            assert all(int(tok[b]) in kept[b] for b in range(B))


def test_sampled_generate_is_seeded(decoders):
    """The sampling route draws from the explicit generator: one seed, one
    code row; codes stay in the mel vocabulary and are stop-padded."""
    cfg, _, _, pdec = decoders
    rng = np.random.default_rng(5)
    conds = t(rng.standard_normal((1, 34, cfg.gpt.model_dim)).astype(np.float32))
    arrays = [t(a) for a in pdec.build_text_prompt_arrays(
        rng.integers(2, 50, (1, 6)), np.array([6]), 6)]
    rows = [pdec.generate(conds, *arrays, s, max_new=12, do_sample=True) for s in (1, 1, 2)]
    assert torch.equal(rows[0].codes, rows[1].codes)
    codes = n(rows[0].codes)[0]
    L = int(rows[0].lengths[0])
    assert codes.max() < cfg.gpt.number_mel_codes
    assert (codes[L:] == cfg.gpt.stop_mel_token).all()


@pytest.mark.parametrize("compress", [False, True])
def test_stop_trim_and_silence_compression_match(compress):
    """Codes are cut at the first stop token; with compression, runs of the
    silent token (52) are capped at 10 once the row holds more than 30."""
    from indextts_tpu.runtime.engine import IndexTTS2Engine as JaxEngine

    from indextts_tpu_torch.runtime.engine import IndexTTS2Engine

    rng = np.random.default_rng(9)
    codes = np.concatenate([rng.integers(0, 60, 20), np.full(25, 52), rng.integers(0, 60, 5),
                            np.full(15, 52), [8193], rng.integers(0, 60, 7)])
    want = JaxEngine.remove_long_silence(codes, 8193, compress=compress)
    got = IndexTTS2Engine.remove_long_silence(codes, 8193, compress=compress)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] < 66
