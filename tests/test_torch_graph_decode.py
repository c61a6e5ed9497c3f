"""The port's decode loop over static state (runtime/decode.py), on the CPU.

On the card `GPTDecoder.generate` replays a captured step; here the same
step runs eagerly, so these tests hold what the card's graph is made of:
greedy codes do not depend on the cache's capacity rounding, the sampler's
exponential race draws from the JAX warper chain's distribution, the
engine's seed gives one code row, and two threads sharing one decoder get
the codes sequential calls get. tests/test_torch_cuda.py holds the graph
against the eager loop on the card.
"""

import sys
import threading

import numpy as np
import pytest
import torch
from scipy import stats

import jax
import jax.numpy as jnp

from indextts_tpu_torch.weights import from_jax_params, quantize_gpt_state_dict
from torch_parity import n, parity_config, parity_params, speech_like, t, to_port_config

# route: (gpt_quantize, gpt_wbits, kv_int8)
ROUTES = {"float": (False, 8, False), "w8": (True, 8, True), "w4": (True, 4, True)}


def port_decoder(route: str, do_sample: bool = False, seed: int = 3):
    """The tiny config's GPT on `route` (the int8 head with quantized
    blocks), from the JAX parity parameters, and its decoder on the CPU."""
    from indextts_tpu_torch.runtime.decode import GPTDecoder, SamplingConfig
    from indextts_tpu_torch.runtime.engine import load_model

    quantize, wbits, kv_int8 = ROUTES[route]
    cfg = parity_config(gpt_quantize=quantize, head_quant=quantize, gpt_wbits=wbits)
    pcfg = to_port_config(cfg)
    sd = from_jax_params(parity_params(cfg, seed=seed), pcfg)["gpt"]
    if quantize:
        sd = quantize_gpt_state_dict(sd, head=True, bits=wbits)
    gpt = load_model("gpt", pcfg, sd, "cpu")
    return GPTDecoder(gpt, pcfg.gpt, SamplingConfig(do_sample=do_sample), kv_int8=kv_int8)


def prompt(dec, seed: int, n_text: int = 7, bucket: int = 10):
    rng = np.random.default_rng(seed)
    conds = t(rng.standard_normal((1, 34, dec.cfg.model_dim)).astype(np.float32))
    arrays = dec.build_text_prompt_arrays(rng.integers(2, 50, (1, n_text)),
                                          np.array([n_text]), bucket)
    return (conds, *(t(a) for a in arrays))


@pytest.mark.parametrize("route", list(ROUTES))
def test_cap_rounding_keeps_greedy_codes(route, monkeypatch):
    """Greedy codes and lengths with the caches rounded up to 256 slots
    equal those at exactly S + max_new slots: every slot past the valid
    keys is masked, whatever it holds. The rounded state is used twice, so
    the second request finds the first one's keys past its own."""
    from indextts_tpu_torch.runtime import decode

    dec = port_decoder(route)
    args = prompt(dec, 1)
    runs = []
    for cap_round in (256, 1, 256):
        monkeypatch.setattr(decode, "CAP_ROUND", cap_round)
        runs.append(dec.generate(*args, None, max_new=20, do_sample=False))
    caps = sorted(st.cap for st in dec._states.values())
    assert caps == [34 + 12 + 1 + 20, 256]
    for r in runs[1:]:
        np.testing.assert_array_equal(n(r.codes), n(runs[0].codes))
        np.testing.assert_array_equal(n(r.lengths), n(runs[0].lengths))
    assert len(set(n(runs[0].codes)[0].tolist())) > 3  # not a degenerate row


def test_exponential_race_matches_jax_distribution(monkeypatch):
    """The port's draw (argmax(p / q), q ~ Exp(1)) against the distribution
    the JAX chain hands to jax.random.categorical, on fixed logits: 40
    seeds x 500 rows of each of two logit rows. Pearson's chi-square over
    the kept tokens stays below its 1e-4 upper quantile, and a draw at
    another temperature lands far above it, so the test can tell."""
    from indextts_tpu.runtime import decode as jdecode

    from indextts_tpu_torch.runtime import decode as pdecode

    rng = np.random.default_rng(17)
    V, k, temperature, top_p = 36, 10, 0.8, 0.8
    logits = (rng.standard_normal((2, V)) * 2).astype(np.float32)
    seen = {}

    def categorical(key, vals, axis=-1):
        seen["vals"] = np.asarray(vals)
        return jnp.argmax(vals, axis=axis)

    monkeypatch.setattr(jdecode.jax.random, "categorical", categorical)
    jdecode._apply_top_k_top_p_sample(jnp.asarray(logits), jax.random.PRNGKey(0),
                                      jnp.float32(temperature), jnp.float32(top_p), k)
    vals = seen["vals"].astype(np.float64)
    p_kept = np.exp(vals - vals.max(-1, keepdims=True))
    p_kept /= p_kept.sum(-1, keepdims=True)
    _, top_idx = torch.topk(t(logits), k, dim=-1)

    def chi2(temp):
        """Chi-square statistic of each row's draws against p_kept, its
        degrees of freedom, and the draws that fell outside the kept set."""
        rows = 500
        counts = np.zeros((2, V))
        x = t(np.repeat(logits, rows, axis=0))
        for seed in range(40):
            g = torch.Generator().manual_seed(seed)
            tok = n(pdecode.sample_top_k_top_p(x, g, torch.tensor(temp),
                                               torch.tensor(top_p), k)).reshape(2, rows)
            for b in range(2):
                counts[b] += np.bincount(tok[b], minlength=V)
        out = []
        for b in range(2):
            kept = p_kept[b] > 0
            want = p_kept[b][kept] * counts[b].sum()
            got = counts[b][n(top_idx)[b]][kept]
            out.append((((got - want) ** 2 / want).sum(), int(kept.sum()) - 1,
                        counts[b].sum() - got.sum()))
        return out

    for stat, dof, outside in chi2(temperature):
        assert dof >= 2 and outside == 0
        assert stat < stats.chi2.ppf(1 - 1e-4, dof), (stat, dof)
    assert any(stat > 10 * stats.chi2.ppf(1 - 1e-4, dof) for stat, dof, _ in chi2(2.0))


def test_engine_seed_gives_one_code_row():
    """The engine hands the request's seed to the decoder, which reseeds
    its own generator: one seed, one code row; another seed, another."""
    from indextts_tpu_torch.runtime.engine import EmotionConditioning, IndexTTS2Engine

    cfg = parity_config(do_sample=True)
    pcfg = to_port_config(cfg)
    eng = IndexTTS2Engine(pcfg, from_jax_params(parity_params(cfg, seed=2), pcfg),
                          device="cpu")
    spk = eng.prepare_speaker(speech_like(np.random.default_rng(0), 1.2, 16000), 16000)
    emo = EmotionConditioning(spk.spk_cond_emb, spk.cond_len)
    text = np.random.default_rng(1).integers(2, 50, 8)
    rows = [eng._decode_segment_codes(spk, emo, text, seed=s, max_mel_tokens=16)[1]
            for s in (4, 4, 5)]
    np.testing.assert_array_equal(rows[0], rows[1])
    assert not np.array_equal(rows[0], rows[2])
    assert rows[0].max() < pcfg.gpt.number_mel_codes


def test_concurrent_generate_matches_sequential():
    """Two threads sharing one sampling decoder (the server's thread pool
    does) each get the codes a sequential call gets with the same prompt
    and seed: the decoder's lock gives each request its state, stream and
    generator for the whole call."""
    dec = port_decoder("w8", do_sample=True)
    jobs = [(prompt(dec, 5), 11), (prompt(dec, 6, n_text=5, bucket=5), 12)]
    want = [n(dec.generate(*args, seed, max_new=24).codes) for args, seed in jobs]
    got = [[None] * 3 for _ in jobs]

    def run(i, args, seed):
        for r in range(3):
            got[i][r] = n(dec.generate(*args, seed, max_new=24).codes)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(i, *job)) for i, job in enumerate(jobs)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    for i in range(len(jobs)):
        for r in range(3):
            np.testing.assert_array_equal(got[i][r], want[i])
    assert not np.array_equal(want[0], want[1])
