"""The port's bfloat16 compute modes against the JAX package's, on the CPU.

The JAX engine's `gpt_dtype`, `cond_dtype`, runtime.s2mel_dtype and
runtime.voc_dtype (with its float32 vocoder sibling) against the port's,
at the tiny config of tests/test_engine_e2e.py, from the same numpy
parameters and inputs.

XLA rounds bfloat16 at the ends of its fused programs, PyTorch after every
op, so the two packages' bfloat16 results differ by about as much as
bfloat16 differs from float32. Each comparison therefore holds the port's
bfloat16 output to the JAX package's bfloat16 output relative to the JAX
package's own bfloat16 error: dist(port, jax_bf16) <= 2 dist(jax_bf16,
jax_fp32), dist the largest absolute difference; and, where the JAX
package bounds its own bfloat16 fidelity, the port's distance from the JAX
float32 output within that bound (relative L2 0.08 for the CFM mel,
tests/test_s2mel_parity.py; 0.05 for the waveform, tests/
test_bigvgan_parity.py). Stored parameters are equal to the bit; greedy
codes equal on seeds whose top-2 logit margins clear bfloat16 noise.
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

BF16 = dict(s2mel_dtype="bfloat16", voc_dtype="bfloat16")
# the JAX package's bench.py quantized serving configuration (BENCH_QUANT=1)
BENCH = dict(BF16, gpt_quantize=True, kv_quant=True, gpt_wbits=8)
CFM_REL_L2 = 0.08  # tests/test_s2mel_parity.py test_cfm_bf16_estimator_close
WAV_REL_L2 = 0.05  # tests/test_bigvgan_parity.py test_bigvgan_bf16_close


def dist(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def within_jax_error(port, jax16, jax32):
    """The port's bfloat16 result against the JAX package's, relative to
    the JAX package's own bfloat16 error."""
    d, ref = dist(port, jax16), dist(jax16, jax32)
    assert ref > 0, "bfloat16 changed nothing: the comparison says nothing"
    assert d <= 2 * ref, (d, ref)


def _engines(runtime, gpt_dtype, cond_dtype=None, seed=1):
    """The JAX engine and the port's, both precise_shapes, from the same
    parameters, with `runtime` and the two constructor dtypes."""
    from indextts_tpu.runtime.engine import IndexTTS2Engine as JaxEngine

    from indextts_tpu_torch.runtime.engine import IndexTTS2Engine

    cfg = parity_config(**runtime)
    jp = parity_params(cfg, seed=seed)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    cond_dtype = cond_dtype or gpt_dtype
    je = JaxEngine(cfg, jp, precise_shapes=True, gpt_dtype=jdt[gpt_dtype],
                   cond_dtype=jdt[cond_dtype])
    pcfg = to_port_config(cfg)
    pe = IndexTTS2Engine(pcfg, from_jax_params(jp, pcfg), device="cpu", precise_shapes=True,
                         gpt_dtype=gpt_dtype, cond_dtype=cond_dtype)
    return je, pe


@pytest.fixture(scope="module")
def bf16_pair():
    """(JAX bf16, JAX fp32, port bf16) engines of the float GPT route."""
    je16, pe16 = _engines(BF16, torch.bfloat16)
    je32, _ = _engines({}, torch.float32)
    return je16, je32, pe16


def _jax_trees(je, vocoder: str = "p_bigvgan"):
    return {name: jax.tree_util.tree_map(np.asarray, getattr(je, attr)) for name, attr in (
        ("gpt", "p_gpt"), ("s2mel", "p_s2mel"), ("bigvgan", vocoder),
        ("repcodec", "p_repcodec"), ("campplus", "p_campplus"), ("w2vbert", "p_w2vbert"))}


def test_stored_params_equal_jax_put_as():
    """bench.py's configuration (W8 blocks, int8 KV cache, bf16 GPT, s2mel
    and vocoder) and cond_dtype bf16: every float tensor of the GPT, s2mel,
    vocoder and w2v-BERT is bfloat16 but the int8 layers' scales (float32),
    the int8 weights stay int8, RepCodec and CAMPPlus float32, and the
    vocoder's sibling float32: dtypes as tests/test_engine_e2e.py
    test_bf16_param_store_dtypes checks the JAX engine's. Every value equals
    what the JAX engine's put_as stored, to the bit."""
    je, pe = _engines(BENCH, torch.bfloat16)
    pcfg = pe.cfg
    want = from_jax_params(_jax_trees(je), pcfg)
    want_f32 = from_jax_params(_jax_trees(je, "p_bigvgan_f32"), pcfg)["bigvgan"]
    mods = {"gpt": pe.gpt, "s2mel": pe.s2mel, "bigvgan": pe.bigvgan, "repcodec": pe.repcodec,
            "campplus": pe.campplus, "w2vbert": pe.w2vbert}
    assert pe.bigvgan_f32 is not pe.bigvgan
    checks = [(name, m.state_dict(), want[name]) for name, m in mods.items()]
    checks.append(("bigvgan_f32", pe.bigvgan_f32.state_dict(), want_f32))
    n_scales = 0
    for name, got, ref in checks:
        assert sorted(got) == sorted(ref), name
        for k, v in got.items():
            if not v.is_floating_point():
                assert v.dtype == ref[k].dtype, (name, k)
                assert torch.equal(v, ref[k]), (name, k)
                continue
            scale = k.endswith(".weight_scale")
            n_scales += scale
            bf16 = name in ("gpt", "s2mel", "bigvgan", "w2vbert") and not scale
            assert v.dtype == (torch.bfloat16 if bf16 else torch.float32), (name, k)
            # the JAX value carried over as float32 is the bfloat16 one exactly
            assert torch.equal(v.float(), ref[k].float()), (name, k)
    assert n_scales > 0
    assert pe.gpt.gpt.h[0].attn.c_attn.weight_q.dtype == torch.int8


def _prompt(seed, d, n_text, bucket):
    rng = np.random.default_rng(seed)
    conds = rng.standard_normal((1, 34, d)).astype(np.float32)
    return conds, rng.integers(2, 50, (1, n_text)), bucket


def _jax_prefill_logits(je, conds, text, bucket):
    from indextts_tpu.models.unified_voice import UnifiedVoice as JUV

    ids, pos, valid = je.decoder.build_text_prompt_arrays(text, np.array([text.shape[1]]),
                                                          bucket)
    m, p = je.gpt, {"params": je.p_gpt}
    emb = m.apply(p, jnp.asarray(ids), jnp.asarray(pos), jnp.asarray(valid),
                  method=JUV.embed_text_prompt)
    start = m.apply(p, 1, method=JUV.embed_mel_start)
    prompt = jnp.concatenate([jnp.asarray(conds).astype(emb.dtype), emb,
                              start.astype(emb.dtype)], axis=1)
    mask = jnp.concatenate([jnp.ones((1, 34), bool), jnp.asarray(valid),
                            jnp.ones((1, 1), bool)], axis=1)
    hidden, _ = m.apply(p, prompt, mask, method=JUV.gpt_prefill)
    return np.asarray(m.apply(p, hidden[:, -1], method=JUV.mel_logits_from_hidden))


@pytest.mark.parametrize("route", ["float", "w8_kv_quant"])
def test_gpt_prefill_logits_and_greedy_codes(route):
    """The bf16 GPT's prefill logits (float32 out of the head) against JAX
    UnifiedVoice(dtype=bfloat16), on the float route and on W8 blocks with
    the int8 KV cache, within twice the JAX package's own bf16 error; then
    up to 16 greedy codes from both decoders, equal. The prompt's seed is
    one whose greedy paths keep their top-2 margins above bf16 noise on
    both routes: the smallest margin of the penalized logits is 0.087 on
    each, where the two packages' bf16 prefill logits differ by at most
    0.024 before the repetition penalty divides them by 10."""
    runtime = {} if route == "float" else dict(gpt_quantize=True, kv_quant=True)
    je16, pe16 = _engines(runtime, torch.bfloat16)
    je32, _ = _engines(runtime, torch.float32)
    assert pe16.gpt.gpt.dtype == torch.bfloat16
    assert pe16.decoder.kv_int8 == (route != "float")
    conds, text, bucket = _prompt(15, pe16.cfg.gpt.model_dim, 7, 12)
    ids, pos, valid = pe16.decoder.build_text_prompt_arrays(text, np.array([7]), bucket)
    with torch.inference_mode():
        logits, kv, _ = pe16.decoder._prompt_prefill(t(conds), t(ids), t(pos), t(valid))
    assert logits.dtype == torch.float32
    assert kv[0].dtype == (torch.bfloat16 if route == "float" else torch.int8)
    within_jax_error(n(logits), _jax_prefill_logits(je16, conds, text, bucket),
                     _jax_prefill_logits(je32, conds, text, bucket))

    want = je16.decoder.generate({"params": je16.p_gpt}, jnp.asarray(conds),
                                 *(jnp.asarray(a) for a in (ids, pos, valid)),
                                 jax.random.PRNGKey(0), max_new=16, repetition_penalty=10.0)
    got = pe16.decoder.generate(t(conds), t(ids), t(pos), t(valid), None, max_new=16,
                                repetition_penalty_value=10.0, do_sample=False)
    assert len(set(np.asarray(want.codes)[0].tolist())) > 3
    np.testing.assert_array_equal(n(got.codes), np.asarray(want.codes))


def _cfm_inputs(seed=0, B=2, T=60):
    rng = np.random.default_rng(seed)
    mu = rng.standard_normal((B, T, 32)).astype(np.float32)
    prompt_x = np.zeros((B, 80, T), np.float32)
    prompt_x[:, :, :20] = rng.normal(-4.0, 2.0, (B, 80, 20))
    style = rng.standard_normal((B, 192)).astype(np.float32)
    noise = rng.standard_normal((B, 80, T)).astype(np.float32)
    return mu, np.array([T, 45]), prompt_x, 20, style, noise


def test_cfm_bf16_against_jax(bf16_pair):
    """The CFM solve with a bf16 DiT (the Euler state, time embedding,
    norm statistics and softmax float32; the mel float32) against JAX
    cfm_inference(dtype=bfloat16), 4 steps, two rows (one with 45 of 60
    frames valid): within twice the JAX package's bf16 error, and within
    relative L2 0.08 of JAX's float32 solve."""
    from indextts_tpu.runtime.s2mel_infer import cfm_inference as jcfm

    from indextts_tpu_torch.runtime.s2mel_infer import cfm_inference

    je16, je32, pe16 = bf16_pair
    mu, lens, prompt_x, plen, style, noise = _cfm_inputs()
    jargs = (jnp.asarray(mu), jnp.asarray(lens), jnp.asarray(prompt_x), jnp.asarray(plen),
             jnp.asarray(style), jnp.asarray(noise))
    j16 = np.asarray(jcfm(je16.s2mel, {"params": je16.p_s2mel}, *jargs, n_steps=4,
                          cfg_rate=0.7, dtype=jnp.bfloat16))
    j32 = np.asarray(jcfm(je32.s2mel, {"params": je32.p_s2mel}, *jargs, n_steps=4,
                          cfg_rate=0.7))
    got = cfm_inference(pe16.s2mel, t(mu).bfloat16(), t(lens), t(prompt_x), plen, t(style),
                        t(noise), n_steps=4, cfg_rate=0.7)
    assert got.dtype == torch.float32
    within_jax_error(n(got), j16, j32)
    assert rel_l2(n(got), j32) < CFM_REL_L2


def test_dit_attention_bf16_against_jax_xla(bf16_pair, monkeypatch):
    """The DiT's attention layer (fused wqkv, RoPE, masked attention, wo)
    with bf16 weights and input: the port's plain attention, K3's twin,
    against the JAX XLA path (bf16 scores, fp32 softmax), within twice the
    JAX package's bf16 error; keys past 40 of 50 masked in one row."""
    from indextts_tpu.models.s2mel import DiTAttention as JAttn
    from indextts_tpu.models.s2mel import precompute_rope

    je16, je32, pe16 = bf16_pair
    dit = pe16.cfg.s2mel.dit
    rng = np.random.default_rng(4)
    B, T = 2, 50
    x = rng.standard_normal((B, T, dit.hidden_dim)).astype(np.float32)
    lens = np.array([T, 40])
    mask = np.arange(T)[None] < lens[:, None]
    rope = jnp.asarray(precompute_rope(dit.rope_table_size, dit.head_dim, dit.rope_base)[:T])

    def jax_out(je, dt):
        p = je.p_s2mel["cfm_estimator"]["transformer"]["layer_0"]["attention"]
        return np.asarray(JAttn(je.cfg.s2mel.dit).apply(
            {"params": p}, jnp.asarray(x).astype(dt), rope, jnp.asarray(mask)[:, None, None, :]
        ).astype(jnp.float32))

    from indextts_tpu_torch.ops import dit_attention as k3

    seen = []

    def spy(q, k, v, key_mask):
        seen.append((q.dtype, k.dtype, v.dtype))
        return kernel(q, k, v, key_mask)

    # DiTAttention calls dit_attention_train, which outside autograd calls
    # the module's dit_attention (K3)
    kernel = k3.dit_attention
    monkeypatch.setattr(k3, "dit_attention", spy)
    layer = pe16.s2mel.cfm.estimator.transformer
    with torch.inference_mode():
        got = layer.layers[0].attention(t(x).bfloat16(), layer.rope(T, torch.device("cpu")),
                                        t(mask))
    # K3 (here its twin) takes q, k and v all in bf16, as its bf16 instantiation needs
    assert seen == [(torch.bfloat16,) * 3]
    assert got.dtype == torch.bfloat16
    within_jax_error(n(got.float()), jax_out(je16, jnp.bfloat16), jax_out(je32, jnp.float32))


def test_w2vbert_cond_dtype_against_jax(bf16_pair):
    """w2v-BERT under cond_dtype=bfloat16: its weights stored in bf16 and,
    as in the JAX encoder (flax layers without a dtype), the float32
    features carrying the computation in float32: the port's features
    within 1e-4 of the JAX encoder's largest value (float32 summed in
    another order), while the bf16 weights move them by more than that
    from the float32 engine's."""
    from indextts_tpu.models.w2vbert import W2VBertEncoder as JW2V

    from indextts_tpu_torch.frontend import features as feat

    je16, je32, pe16 = bf16_pair
    features, mask = feat.seamless_features(speech_like(np.random.default_rng(6), 1.0, 16000))
    jm = JW2V(je16.cfg.w2vbert)
    j16, j32 = (np.asarray(jm.apply({"params": p}, jnp.asarray(features), jnp.asarray(mask)))
                for p in (je16.p_w2vbert, je32.p_w2vbert))
    with torch.inference_mode():
        got = pe16.w2vbert(t(features), t(mask))
    assert got.dtype == torch.float32
    top = np.abs(j16).max()
    assert dist(n(got), j16) <= 1e-4 * top
    assert dist(j16, j32) > 1e-3 * top


@pytest.mark.parametrize("B", [1, 3])
def test_snake_twin_bf16_against_jax(B):
    """K2's plain twin on a bf16 x (widened, computed in float32, rounded
    once) against JAX anti_alias_snake on bf16 x, alpha and beta (its sliced
    form at B=1, its conv form past it), within twice the JAX package's own
    bf16 error; the output bf16."""
    from indextts_tpu.ops.snake import anti_alias_snake as janti

    from indextts_tpu_torch.ops.snake import anti_alias_snake

    rng = np.random.default_rng(B)
    C, T = 24, 301
    x = rng.standard_normal((B, C, T)).astype(np.float32)
    a = (rng.standard_normal(C) * 0.3).astype(np.float32)
    b = (rng.standard_normal(C) * 0.3).astype(np.float32)
    xb, ab, bb = (t(v).bfloat16() for v in (x, a, b))
    got = anti_alias_snake(xb, ab, bb, True)
    assert got.dtype == torch.bfloat16

    def jax_out(dt):
        args = [jnp.asarray(n(v.float())).astype(dt) for v in (xb, ab, bb)]
        return np.asarray(janti(jnp.swapaxes(args[0], 1, 2), args[1], args[2], True)
                          .astype(jnp.float32)).transpose(0, 2, 1)

    within_jax_error(n(got.float()), jax_out(jnp.bfloat16), jax_out(jnp.float32))


@pytest.mark.parametrize("B", [1, 2])
def test_bigvgan_bf16_against_jax(bf16_pair, B):
    """The bf16 vocoder (K2's bf16 twin between bf16 convolutions) against
    JAX BigVGAN(dtype=bfloat16) on a mel of 40 frames: within twice the JAX
    package's bf16 error, relative L2 within 0.05 of JAX's float32
    sibling, correlated above 0.99 with it; the waveform stays bf16."""
    je16, je32, pe16 = bf16_pair
    rng = np.random.default_rng(10 + B)
    mel = rng.normal(-5.0, 2.0, (B, 80, 40)).astype(np.float32)
    j16 = np.asarray(je16.bigvgan.apply({"params": je16.p_bigvgan}, jnp.asarray(mel))
                     .astype(jnp.float32))
    j32 = np.asarray(je16.bigvgan_f32.apply({"params": je16.p_bigvgan_f32}, jnp.asarray(mel)))
    with torch.inference_mode():
        got = pe16.bigvgan(t(mel))
    assert got.dtype == torch.bfloat16
    got = n(got.float())
    assert 0 < np.abs(j32).max() < 1.0  # off the clip
    within_jax_error(got, j16, j32)
    assert rel_l2(got, j32) < WAV_REL_L2
    assert np.corrcoef(got.ravel(), j32.ravel())[0, 1] > 0.99


def test_vocoder_sibling_routes():
    """With only voc_dtype=bfloat16, the sequential route vocodes with the
    float32 sibling: its waveform equals the all-float32 engine's to the
    bit. The batched route vocodes with the bf16 model: its waveform
    differs, within relative L2 0.05 of the float32 engine's batched one."""
    from indextts_tpu_torch.runtime.engine import IndexTTS2Engine, random_params

    pcfg = to_port_config(parity_config())
    params = random_params(pcfg, seed=0, device="cpu")
    e32 = IndexTTS2Engine(pcfg, params, device="cpu")
    bcfg = dataclasses.replace(pcfg, runtime=dataclasses.replace(pcfg.runtime,
                                                                 voc_dtype="bfloat16"))
    e16 = IndexTTS2Engine(bcfg, params, device="cpu")
    assert e16.bigvgan.conv_pre.weight.dtype == torch.bfloat16
    assert e16.vocoder_runner.dtype == torch.float32
    assert e16.batch_vocoder_runner.dtype == torch.bfloat16
    rng = np.random.default_rng(13)
    prompt = (speech_like(rng, 1.0, 16000), 16000)
    segs = [rng.integers(2, 50, 7), rng.integers(2, 50, 11)]
    seq = [e.infer(prompt, segs, seed=3)["audio"] for e in (e32, e16)]
    np.testing.assert_array_equal(seq[1], seq[0])
    bat = [e.infer(prompt, segs, seed=3, batched=True)["audio"] for e in (e32, e16)]
    assert bat[1].shape == bat[0].shape and not np.array_equal(bat[1], bat[0])
    assert rel_l2(bat[1], bat[0]) < WAV_REL_L2


def _forced_codes(engine, codes):
    """Make `engine` decode `codes` whatever its GPT picks (the JAX float32
    engine runs the bf16 engine's codes through its tail)."""
    orig = engine._decode_segment_codes

    def forced(*args, **kwargs):
        emovec, _, t_gen = orig(*args, **kwargs)
        return emovec, np.asarray(codes), t_gen

    engine._decode_segment_codes = forced


def test_bench_configuration_slice_against_jax(monkeypatch):
    """The whole /tts slice in bench.py's quantized configuration (W8
    blocks, int8 KV cache, bf16 GPT, s2mel and vocoder), greedy, through
    the JAX engine and the port's from the same parameters, audio, text and
    CFM noise: equal codes (the text's seed gives greedy top-2 margins of
    at least 0.048 of the penalized logits, where other seeds' paths part
    at margins of 0.022); the mel and the waveform within twice the JAX
    bf16 engine's distance from the JAX float32 engine run on the same
    codes, and the port's within relative L2 0.08 (mel) of the float32
    engine's. The waveform takes the float32 sibling, so its bf16 error is
    the mel's."""
    from test_torch_slice import _capture_codes

    monkeypatch.setenv("INDEXTTS_NATIVE_DSP", "0")
    je16, pe16 = _engines(BENCH, torch.bfloat16, torch.float32)
    je32, _ = _engines(dict(gpt_quantize=True, kv_quant=True), torch.float32)
    rng = np.random.default_rng(13)
    prompt = speech_like(rng, 1.2, 16000)
    text = rng.integers(2, 50, 9)
    noise_rng, noises = np.random.default_rng(5), {}

    def noise(shape):
        if shape not in noises:
            noises[shape] = noise_rng.standard_normal(shape).astype(np.float32)
        return noises[shape]

    out, codes = {}, {}
    for name, eng in (("jax16", je16), ("port", pe16), ("jax32", je32)):
        if name == "jax32":
            _forced_codes(eng, codes["jax16"][0])
        eng._noise_hook = noise
        eng._mel_taps = []
        codes[name] = []
        _capture_codes(eng, codes[name])
        res = eng.infer((prompt, 16000), [text], seed=0, num_beams=1, do_sample=False)
        out[name] = (eng._mel_taps[0], res["audio"])
    assert len(codes["jax16"][0]) > 2
    np.testing.assert_array_equal(codes["port"][0], codes["jax16"][0])
    (jm, jw), (pm, pw), (fm, fw) = out["jax16"], out["port"], out["jax32"]
    assert pm.shape == jm.shape == fm.shape and pw.shape == jw.shape == fw.shape
    within_jax_error(pm, jm, fm)
    assert rel_l2(pm, fm) < CFM_REL_L2
    assert 0 < np.abs(fw).max() < 1.0
    within_jax_error(pw, jw, fw)


def test_env_dtypes_reach_the_served_engine(monkeypatch):
    """TARS_S2MEL_DTYPE and TARS_VOC_DTYPE reach the engine that serve.build
    makes through RuntimeConfig.from_env, as in the JAX package, with no
    flag of their own: a bf16 s2mel, a bf16 vocoder beside its float32
    sibling, the GPT float32 (the config's gpt_dtype is not read)."""
    from indextts_tpu_torch import serve
    from indextts_tpu_torch.config import RuntimeConfig

    monkeypatch.setenv("TARS_S2MEL_DTYPE", "bfloat16")
    monkeypatch.setenv("TARS_VOC_DTYPE", "bfloat16")
    monkeypatch.setenv("TARS_PRECOMPILE", "0")
    pcfg = to_port_config(parity_config())
    rt = dataclasses.replace(RuntimeConfig.from_env(), max_mel_tokens=24)
    _, engine = serve.build(["--port", "0", "--device", "cpu"],
                            cfg=dataclasses.replace(pcfg, runtime=rt))
    assert (engine.s2mel_dtype, engine.bigvgan.conv_pre.weight.dtype) == (torch.bfloat16,) * 2
    assert engine.bigvgan_f32.conv_pre.weight.dtype == torch.float32
    assert engine.gpt.gpt.dtype == torch.float32


def test_continuous_route_bf16_slot_caches():
    """The continuous route under a bf16 GPT: the service's slot caches hold
    bf16, and a request through it gives the waveform the sequential route
    gives from the same seed (greedy: the same codes, then the same
    float32-sibling tail), to the bit."""
    from indextts_tpu_torch.runtime.batcher import ContinuousService
    from indextts_tpu_torch.runtime.engine import IndexTTS2Engine, random_params

    pcfg = to_port_config(parity_config(**BF16))
    eng = IndexTTS2Engine(pcfg, random_params(pcfg, seed=0, device="cpu"), device="cpu",
                          gpt_dtype=torch.bfloat16)
    audio = (speech_like(np.random.default_rng(0), 1.2, 16000), 16000)
    segs = [np.random.default_rng(k).integers(2, 50, 4 + 3 * k) for k in range(2)]
    want = eng.infer(audio, segs, seed=5)["audio"]
    svc = ContinuousService(eng, n_slots=2, text_bucket=12, max_new=24, chunk_steps=4,
                            tail_workers=1)
    try:
        got = eng.infer_continuous(svc, audio, segs, seed=5)["audio"]
        caches = svc.bat.state.caches
    finally:
        svc.shutdown()
    assert caches[0].dtype == torch.bfloat16
    assert got.shape == want.shape and np.array_equal(got, want)


def test_pcm16_clip_of_a_bf16_waveform_against_jax():
    """The PCM16 clip of a bf16 waveform, as the JAX engine's _vocode_pcm16
    computes it (the product and the clip in bf16, then int16): equal to
    the bit, full scale included, where 32767 rounds to 32768 in bf16 and
    XLA's conversion saturates (a plain torch cast would wrap it to
    -32768)."""
    from indextts_tpu_torch.models.bigvgan import to_pcm16

    rng = np.random.default_rng(7)
    w = np.concatenate([[1.0, -1.0, 0.9999, -0.99991, 0.5, 0.0],
                        rng.uniform(-1, 1, 2000)]).astype(np.float32)
    wb = t(w).bfloat16()
    jw = jnp.asarray(n(wb.float())).astype(jnp.bfloat16)
    want = np.asarray(jnp.clip(jw * 32767.0, -32767.0, 32767.0).astype(jnp.int16))
    got = n(to_pcm16(wb))
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, want)
    assert (got[0], got[1]) == (32767, -32768)  # the bf16 bounds are +-32768
