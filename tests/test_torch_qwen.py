"""The port's Qwen3 text-to-emotion model against the JAX package's, on the CPU.

The TINY config of tests/test_qwen3_parity.py; the JAX Qwen3LM's own
initialization, carried across by `weights.qwen3_sd`. Tolerances: logits
within atol 5e-5 / rtol 1e-3 (the JAX test's own, float32 through two
layers summed in another order); greedy tokens exact, at a seed whose
top-2 margin at every step is above 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indextts_tpu.config import QwenEmoConfig as JaxQwenConfig
from indextts_tpu.models.qwen3 import Qwen3LM as JaxQwen3LM
from indextts_tpu.models.qwen3 import greedy_generate as jax_greedy_generate
from indextts_tpu.runtime import qwen_emo as jax_qwen_emo
from indextts_tpu_torch.config import QwenEmoConfig
from indextts_tpu_torch.models.qwen3 import Qwen3LM, QwenDecoder, greedy_generate
from indextts_tpu_torch.runtime import qwen_emo
from indextts_tpu_torch.weights import qwen3_sd
from torch_parity import n, t

TINY_FIELDS = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                   num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                   intermediate_size=96, rope_theta=1e6)
TINY = QwenEmoConfig(**TINY_FIELDS)
ATOL, RTOL = 5e-5, 1e-3


def jax_tiny(seed: int = 0):
    """(the JAX model, its params as numpy, the port's model on the same
    weights)."""
    jm = JaxQwen3LM(JaxQwenConfig(**TINY_FIELDS))
    ids = jnp.zeros((1, 4), jnp.int32)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(seed), ids, jnp.arange(4)))
    pm = Qwen3LM(TINY)
    pm.load_state_dict(qwen3_sd(params, TINY))
    return jm, params, pm.eval()


@pytest.fixture(scope="module")
def pair():
    return jax_tiny(0)


def test_logits_and_kv_match_jax(pair):
    jm, params, pm = pair
    ids = np.random.default_rng(0).integers(0, TINY.vocab_size, (1, 13))
    want, (jk, jv) = jm.apply(params, jnp.asarray(ids, jnp.int32), jnp.arange(13))
    with torch.no_grad():
        got, (pk, pv) = pm(t(ids), torch.arange(13))
    np.testing.assert_allclose(n(got), np.asarray(want), atol=ATOL, rtol=RTOL)
    for g, w in ((pk, jk), (pv, jv)):
        assert g.shape == w.shape == (2, 1, 2, 13, 16)
        np.testing.assert_allclose(n(g), np.asarray(w), atol=ATOL, rtol=RTOL)


def test_cached_steps_match_jax(pair):
    """A prefill of 11 tokens into a cache, then 3 steps at positions 11-13
    fed the same tokens: each step's logits (the cache rounded to the
    port's capacity, the JAX one exact) and the cache's written slots."""
    jm, params, pm = pair
    rng = np.random.default_rng(1)
    ids = rng.integers(0, TINY.vocab_size, 11)
    feed = rng.integers(0, TINY.vocab_size, 3)
    S, cap_jax = len(ids), len(ids) + 3
    dec = QwenDecoder(pm)
    st = dec._state(256)
    with torch.no_grad():
        dec.prefill(st, ids)
    _, (ks, vs) = jm.apply(params, jnp.asarray(ids[None], jnp.int32), jnp.arange(S))
    jks = jnp.zeros(ks.shape[:3] + (cap_jax, ks.shape[4])).at[:, :, :, :S].set(ks)
    jvs = jnp.zeros_like(jks).at[:, :, :, :S].set(vs)
    for i, tok in enumerate(feed):
        pos = S + i
        want, (jks, jvs) = jm.apply(params, jnp.asarray([[tok]], jnp.int32), jnp.asarray([pos]),
                                    kv_caches=(jks, jvs), cache_index=pos,
                                    kv_valid_len=jnp.asarray([pos + 1]))
        st.tok.fill_(int(tok))
        with torch.no_grad():
            dec.step(st)
        assert int(st.pos) == pos + 1 and int(st.valid) == pos + 2
        np.testing.assert_allclose(n(st.logits), np.asarray(want)[0, -1], atol=ATOL, rtol=RTOL)
        assert int(st.tok) == int(np.argmax(np.asarray(want)[0, -1]))
    # the port's cache holds KV head h // 2 at query head h
    for got, want in ((st.ks, jks), (st.vs, jvs)):
        got = n(got[:, :, :, :cap_jax])
        np.testing.assert_array_equal(got[:, :, 1::2], got[:, :, ::2])
        np.testing.assert_allclose(got[:, :, ::2], np.asarray(want), atol=ATOL, rtol=RTOL)


def _margins(pm, ids, max_new):
    """The top-2 margin of the port's logits at the prefill and each step
    of a greedy decode."""
    dec = QwenDecoder(pm)
    st = dec._state(256)
    out = []
    with torch.no_grad():
        dec.prefill(st, ids)
        for _ in range(max_new):
            top = torch.topk(st.logits, 2).values
            out.append(float(top[0] - top[1]))
            dec.step(st)
    return np.asarray(out)


def test_greedy_generate_token_exact_with_jax(pair):
    jm, params, pm = pair
    ids = np.random.default_rng(7).integers(0, TINY.vocab_size, 11)
    assert _margins(pm, ids, 24).min() > 1e-3  # or a float32 tie could decide a token
    want = jax_greedy_generate(jm, params, ids, 24, eos_token_id=-1)
    got = greedy_generate(pm, ids, 24, eos_token_id=-1)
    assert len(want) == 24 and len(set(want.tolist())) > 3
    np.testing.assert_array_equal(got, want)
    # the same stop at eos: its first appearance, kept
    eos = int(want[5])
    want_eos = jax_greedy_generate(jm, params, ids, 24, eos_token_id=eos)
    np.testing.assert_array_equal(greedy_generate(pm, ids, 24, eos_token_id=eos), want_eos)
    assert want_eos[-1] == eos and len(want_eos) <= 6


def test_decoder_keeps_a_state_per_capacity(pair):
    """Prompts of 11 and 30 tokens with 24 new share the capacity 256; one
    of 240 takes 512. A decoder's second call gives its first call's
    tokens."""
    _, _, pm = pair
    dec = QwenDecoder(pm)
    rng = np.random.default_rng(3)
    a, b, c = (rng.integers(0, TINY.vocab_size, k) for k in (11, 30, 240))
    first = dec.generate(a, 24, -1)
    dec.generate(b, 24, -1)
    assert list(dec._states) == [256]
    dec.generate(c, 24, -1)
    assert list(dec._states) == [256, 512]
    np.testing.assert_array_equal(dec.generate(a, 24, -1), first)
    np.testing.assert_array_equal(dec.generate(a, 24, -1, eager=True), first)


RESPONSES = [
    ('{"高兴": 0.9, "悲伤": 0.2}', "开心的一天"),
    ("高兴: 2.5, 愤怒: 0.1 not json", "text"),
    ('{"悲伤": 0.8}', "a gloomy day"),
    ("{}", "text"),
    ('"低落": 0.4, "惊讶": -1, "自然": 0.3', "I feel depressed"),
]


@pytest.mark.parametrize("response,text", RESPONSES)
def test_qwen_emotion_matches_jax(response, text):
    """The parsing, swap, clamp and calm fallback of the port's copy give the
    JAX QwenEmotion's dict, keys in the same order."""
    want = jax_qwen_emo.QwenEmotion(lambda s, u: response).inference(text)
    got = qwen_emo.QwenEmotion(lambda s, u: response).inference(text)
    assert list(got.items()) == list(want.items())


@pytest.mark.parametrize("ids", [[5, 6, 151668, 7, 8], [7, 8], [151668], [1, 151668, 2, 151668, 3]])
def test_strip_thinking_matches_jax(ids):
    assert qwen_emo.strip_thinking(ids) == jax_qwen_emo.strip_thinking(ids)


def test_generate_fn_matches_jax(pair):
    """make_generate_fn over the port's model against the JAX package's
    greedy_generate with the same encode, strip and decode: the same
    response text."""
    jm, params, pm = pair

    def encode(system, user):
        return [b % TINY.vocab_size for b in (system + "|" + user).encode()]

    def decode(ids):
        return "".join(chr(48 + i % 10) for i in ids)

    def jax_fn(system, user):
        out = jax_greedy_generate(jm, params, np.asarray(encode(system, user)), 16, -1)
        return decode(jax_qwen_emo.strip_thinking([int(x) for x in out]))

    fn = qwen_emo.make_generate_fn(pm, encode, decode, eos_token_id=-1, max_new_tokens=16)
    got = fn("文本情感分类", "a calm reply")
    assert got == jax_fn("文本情感分类", "a calm reply") and len(got) == 16


@pytest.mark.parametrize("prefix", ["model.", ""])
def test_hf_state_dict_loads_as_it_is(prefix):
    """A transformers Qwen3ForCausalLM's state dict (tied lm_head included)
    loads into the port's Qwen3LM with the `model.` prefix and without it;
    its keys are those qwen3_sd gives; the logits agree with transformers'."""
    from transformers import Qwen3Config, Qwen3ForCausalLM

    torch.manual_seed(33)
    hf = Qwen3ForCausalLM(Qwen3Config(**TINY_FIELDS, tie_word_embeddings=True,
                                      attention_dropout=0.0)).eval()
    sd = hf.state_dict()
    assert "lm_head.weight" in sd
    sd = {(k if k == "lm_head.weight" else prefix + k[len("model."):]): v
          for k, v in sd.items()}
    pm = Qwen3LM(TINY)
    pm.load_state_dict(sd)
    _, params, _ = jax_tiny(1)
    assert set(qwen3_sd(params, TINY)) == set(pm.state_dict())
    ids = np.random.default_rng(4).integers(0, TINY.vocab_size, (1, 13))
    with torch.no_grad():
        want = hf(input_ids=t(ids)).logits
        got, _ = pm.eval()(t(ids), torch.arange(13))
    np.testing.assert_allclose(n(got), n(want), atol=ATOL, rtol=RTOL)


def test_decoder_serves_concurrent_requests(pair):
    """Threads sharing one QwenDecoder (as concurrent use_emo_text requests
    share the engine's) each get the tokens of their prompt alone: the lock
    keeps them off each other's static buffers."""
    import sys
    import threading

    _, _, pm = pair
    dec = QwenDecoder(pm)
    prompts = [np.random.default_rng(20 + i).integers(0, TINY.vocab_size, 9 + i)
               for i in range(6)]
    want = [dec.generate(p, 16, -1) for p in prompts]
    got = [None] * len(prompts)

    def run(i):
        for _ in range(3):
            got[i] = dec.generate(prompts[i], 16, -1)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
