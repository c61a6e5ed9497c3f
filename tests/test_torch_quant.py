"""The port's quantized GPT route (W8A8 weights, int8 logits head, int8 KV
cache) against the JAX package, on the CPU.

The same numpy-seeded inputs go through the JAX function and the port's plain
version of the kernel that replaces it (what the port's wrappers run for CPU
tensors). Pallas kernels run in interpret mode, as the JAX package's own
tests run them. tests/test_torch_cuda.py holds each CUDA kernel to its plain
version on a GPU.

Tolerances: quantization is bit-exact (same float32 operations, round half
to even); gemv_w8 1e-6 (the same int32 sums and float32 epilogue); mlp_w8
1e-4 of max|out| (XLA's tanh and the port's differ in the last bits, which
can move an int8 rounding of the hidden); q8 decode attention 1e-5 (float32
softmax summed in another order); greedy codes exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from indextts_tpu_torch.ops import decode_attention as attn_ops
from indextts_tpu_torch.ops import gemv as gemv_ops
from indextts_tpu_torch.weights import from_jax_params, quantize_gpt_state_dict
from torch_parity import n, parity_config, parity_params, speech_like, t, to_port_config


def _q8_weights(rng, d, f):
    from indextts_tpu.models.gpt2 import quantize_conv1d_params

    w = rng.standard_normal((d, f)).astype(np.float32) * np.float32(1 / np.sqrt(d))
    q = quantize_conv1d_params(
        {"kernel": w, "bias": rng.standard_normal(f).astype(np.float32) * 0.1})
    return q["kernel_q"], q["kernel_scale"], q["bias"]


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,scale", [((3, 7, 128), 1.0), ((2, 4, 9, 64), 40.0),
                                         ((1, 1280), 1e-3)])
def test_quant_row_and_quantize_kv_bit_exact(shape, scale):
    """_quant_row (eps 1e-12) and quantize_kv (eps 1e-8): equal int8 values
    and equal scales."""
    from indextts_tpu.models.gpt2 import _quant_row, quantize_kv as jquantize_kv

    from indextts_tpu_torch.models.gpt2 import quant_row, quantize_kv

    x = (np.random.default_rng(len(shape)).standard_normal(shape) * scale).astype(np.float32)
    for port_fn, jax_fn in ((quant_row, _quant_row), (quantize_kv, jquantize_kv)):
        q, s = port_fn(t(x))
        jq, js = jax_fn(jnp.asarray(x))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(n(q), np.asarray(jq))
        np.testing.assert_array_equal(n(s), np.asarray(js))


def test_quantize_gpt_state_dict_matches_quantize_gpt_tree():
    """The port's quantization of a float state dict equals the JAX
    package's quantize_gpt_tree(head=True), carried over by
    from_jax_params: the same keys, int8 bit-exact, scales and biases
    equal; no float weight of a quantized layer is left."""
    from indextts_tpu.runtime.torch_convert import quantize_gpt_tree

    cfg = parity_config()
    pcfg = to_port_config(cfg)
    jp = parity_params(cfg, seed=2)
    mine = quantize_gpt_state_dict(from_jax_params(jp, pcfg)["gpt"], head=True)
    jq = dict(jp, gpt=quantize_gpt_tree(jp["gpt"], head=True))
    want = from_jax_params(jq, pcfg)["gpt"]
    assert sorted(mine) == sorted(want)
    assert not any(k.endswith((".c_attn.weight", ".c_proj.weight", ".c_fc.weight"))
                   or k == "mel_head.weight" for k in mine)
    assert want["mel_head.weight_q"].shape == (cfg.gpt.model_dim, 128)
    for k in want:
        assert mine[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(n(mine[k]), n(want[k]), err_msg=k)


# ---------------------------------------------------------------------------
# K5 gemv_w8, K6 mlp_w8: gating and plain versions
# ---------------------------------------------------------------------------


def test_gating_matches_jax():
    """supports / supports_mlp / the group width are the JAX package's:
    at full width the MLP's hidden is quantized in 10 groups of 512."""
    from indextts_tpu.ops import gemv as jgemv

    for d, f in ((1280, 3840), (1280, 1280), (1280, 8320), (128, 384), (128, 512),
                 (64, 256), (1280, 100), (512, 2048), (96, 384), (256, 1024)):
        assert gemv_ops.supports(d, f) == jgemv.supports(d, f), (d, f)
        assert gemv_ops.supports_mlp(d, f) == jgemv.supports_mlp(d, f), (d, f)
        assert gemv_ops.mlp_group(d, f) == jgemv._pick_block(d, f), (d, f)
    assert gemv_ops.mlp_group(1280, 5120) == 512
    assert gemv_ops.mlp_group(512, 2048) == 1024


@pytest.mark.parametrize("b,d,f", [(1, 256, 768), (3, 256, 768), (1, 1280, 8320),
                                   (3, 128, 384), (16, 256, 768), (1, 256, 8320)])
def test_gemv_w8_plain_matches_jax(b, d, f):
    """y = (xq . w) * (a * s) + bias, against JAX gemv_w8 in interpret mode,
    at one, three and sixteen rows (one launch's most) and at the logits
    head's padded F (rtol and atol 1e-6)."""
    from indextts_tpu.models.gpt2 import _quant_row
    from indextts_tpu.ops.gemv import gemv_w8

    rng = np.random.default_rng(b * 1000 + f)
    w_q, w_s, bias = _q8_weights(rng, d, f)
    x = rng.standard_normal((b, d)).astype(np.float32)
    xq, a = _quant_row(jnp.asarray(x))
    want = np.asarray(gemv_w8(xq, a.reshape(b), jnp.asarray(w_q), jnp.asarray(w_s),
                              jnp.asarray(bias), interpret=True))
    got = gemv_ops.gemv_w8(t(np.asarray(xq)), t(np.asarray(a)), t(w_q), t(w_s), t(bias))
    np.testing.assert_allclose(n(got), want, rtol=1e-6, atol=1e-6)


# csrc/gemv.cu `gemv_kernel`'s blocks and boxes: the grid holds
# ceil(f / tile) clusters of CLUSTER blocks; block k of a cluster asks for
# rows [k * rows/8, (k + 1) * rows/8) of the cluster's tile of columns, as
# boxes of box_rows rows, pass_boxes at a time; columns past f come in as the
# copy engine's zeros and are not read from the weight
def _gemv_boxes(rows, f, plan):
    tile, box, pass_boxes = plan
    block_rows = rows // gemv_ops.CLUSTER
    n_boxes = block_rows // box
    for blk in range(-(-f // tile) * gemv_ops.CLUSTER):
        col0, d0 = blk // gemv_ops.CLUSTER * tile, blk % gemv_ops.CLUSTER * block_rows
        for b0 in range(0, n_boxes, pass_boxes):
            for c in range(min(pass_boxes, n_boxes - b0)):
                r0 = d0 + (b0 + c) * box
                yield r0, r0 + box, col0, min(col0 + tile, f)


H100_SMS = 132
MAIN_PATH_F = (384, 1280, 3840, 6144, 8320)


@pytest.mark.parametrize("w4", [False, True])
def test_gemv_plan_covers_each_weight_byte_once(w4):
    """K5's and K7's launch plan (gemv_plan) puts every (row, column) of the
    weight in exactly one box of one block, for every (D, F) that the JAX
    gates open at D in {128, 256, 512, 1280, 2048} and the main path's F;
    its boxes are ones the copy engine and csrc/gemv.cu take; and on an
    H100 every full-width GPT shape launches a block for every SM."""
    from indextts_tpu.ops import gemv as jgemv

    gate = jgemv.supports_w4 if w4 else jgemv.supports
    shapes = [(d, f) for d in (128, 256, 512, 1280, 2048) for f in MAIN_PATH_F if gate(d, f)]
    assert (1280, 8320) in shapes and (2048, 6144) in shapes
    for d, f in shapes:
        rows = d // 2 if w4 else d
        plan = gemv_ops.gemv_plan(rows, f, H100_SMS)
        tile, box, pass_boxes = plan
        assert tile in gemv_ops.GEMV_TILES and box % 4 == 0, (d, f, plan)
        assert box <= gemv_ops.GEMV_MAX_BOX_ROWS and (rows // gemv_ops.CLUSTER) % box == 0
        assert 1 <= pass_boxes <= gemv_ops.GEMV_MAX_PASS_BOXES
        assert pass_boxes * box * tile <= gemv_ops.GEMV_PASS_BYTES
        count = np.zeros((rows, f), np.int8)
        for r0, r1, c0, c1 in _gemv_boxes(rows, f, plan):
            count[r0:r1, c0:c1] += 1
        assert count.min() == count.max() == 1, (d, f, plan)
    main = [(640, 1280), (640, 3840)] if w4 else [(1280, 1280), (1280, 3840), (1280, 8320)]
    for rows, f in main:
        tile = gemv_ops.gemv_plan(rows, f, H100_SMS)[0]
        assert -(-f // tile) * gemv_ops.CLUSTER >= H100_SMS, (rows, f, tile)


def test_gemv_plan_passes_past_a_blocks_bytes():
    """Past GEMV_PASS_BYTES of weight a block (D=65536 at 64 columns), the
    plan goes in passes whose boxes still cover every row once."""
    rows, f = 65536, 1280
    tile, box, pass_boxes = plan = gemv_ops.gemv_plan(rows, f, H100_SMS)
    assert rows // gemv_ops.CLUSTER // box > pass_boxes
    covered = np.zeros(rows, np.int32)
    for r0, r1, c0, c1 in _gemv_boxes(rows, f, plan):
        if c0 == 0:
            covered[r0:r1] += 1
    assert covered.min() == covered.max() == 1
    with pytest.raises(ValueError):
        gemv_ops.gemv_plan(1280 + 16, f, H100_SMS)


@pytest.mark.parametrize("b,d", [(1, 512), (2, 512), (1, 1280)])
def test_mlp_w8_plain_matches_jax(b, d):
    """The fused MLP with its hidden quantized per group (2 groups of 1024
    at D=512, 10 of 512 at D=1280), against JAX mlp_w8 in interpret mode:
    within 1e-4 of max|out|."""
    from indextts_tpu.models.gpt2 import _quant_row
    from indextts_tpu.ops.gemv import mlp_w8

    rng = np.random.default_rng(d + b)
    fc = _q8_weights(rng, d, 4 * d)
    fc2 = _q8_weights(rng, 4 * d, d)
    x = rng.standard_normal((b, d)).astype(np.float32)
    xq, a = _quant_row(jnp.asarray(x))
    want = np.asarray(mlp_w8(xq, a.reshape(b), *map(jnp.asarray, fc + fc2), interpret=True))
    got = n(gemv_ops.mlp_w8(t(np.asarray(xq)), t(np.asarray(a)), *map(t, fc + fc2)))
    assert got.shape == want.shape == (b, d)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


# ---------------------------------------------------------------------------
# K4 int8 decode attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["dma", "grid"])
@pytest.mark.parametrize("valid,holes", [
    ([100, 512, 257], None),
    ([512, 1, 384], ([34, 0, 40], [60, 0, 90])),
    ([300, 77, 512], ([0, 10, 200], [0, 70, 456])),
])
def test_q8_attention_plain_matches_jax(valid, holes, variant, monkeypatch):
    """The port's natural int8 cache (B, H, cap, Dh) + scales (B, H, cap)
    against ragged_decode_attention_blocked_q8 (both TARS_Q8_VARIANT kernels,
    interpret mode) over a to_blocked_cache / to_blocked_scales view of the
    same arrays, and against the XLA oracle: atol 1e-5."""
    from indextts_tpu.models.gpt2 import quantize_kv
    from indextts_tpu.ops.decode_attention import (
        ragged_decode_attention_blocked_q8,
        ragged_decode_attention_q8_xla,
        to_blocked_cache,
        to_blocked_scales,
    )

    monkeypatch.setenv("TARS_Q8_VARIANT", variant)
    rng = np.random.default_rng(sum(valid))
    B, H, cap, Dh, blk = 3, 4, 512, 64, 128
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    k8, ksc = (np.asarray(a) for a in quantize_kv(jnp.asarray(
        rng.standard_normal((B, H, cap, Dh)).astype(np.float32))))
    v8, vsc = (np.asarray(a) for a in quantize_kv(jnp.asarray(
        rng.standard_normal((B, H, cap, Dh)).astype(np.float32))))
    hs, he = (np.zeros(B, np.int32),) * 2 if holes is None else map(np.asarray, holes)
    i32 = [jnp.asarray(a, jnp.int32) for a in (valid, hs, he)]
    blocked = (to_blocked_cache(jnp.asarray(k8), blk), to_blocked_cache(jnp.asarray(v8), blk),
               to_blocked_scales(jnp.asarray(ksc), blk), to_blocked_scales(jnp.asarray(vsc), blk))
    want = np.asarray(ragged_decode_attention_blocked_q8(
        jnp.asarray(q), *blocked, i32[0], interpret=True, hole_start=i32[1], hole_end=i32[2]))
    oracle = np.asarray(ragged_decode_attention_q8_xla(jnp.asarray(q), *blocked, *i32))
    got = n(attn_ops.ragged_decode_attention_q8(
        t(q), t(k8), t(v8), t(ksc), t(vsc),
        *(t(np.asarray(a, np.int32)) for a in (valid, hs, he))))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, oracle, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# greedy decode and the whole slice
# ---------------------------------------------------------------------------


def _gpt_config(model_dim, heads):
    from indextts_tpu.config import ConditionModuleConfig, GPTConfig

    return GPTConfig(
        model_dim=model_dim, layers=2, heads=heads, max_mel_tokens=64, max_text_tokens=32,
        number_text_tokens=50, number_mel_codes=36, start_mel_token=34, stop_mel_token=35,
        condition_module=ConditionModuleConfig(
            output_size=32, linear_units=48, attention_heads=4, num_blocks=1),
        emo_condition_module=ConditionModuleConfig(
            output_size=32, linear_units=32, attention_heads=2, num_blocks=1))


def _jax_gpt_tree(gcfg, seed):
    """A full UnifiedVoice tree of `gcfg`'s shapes, filled from numpy: fan-in
    scaled zero-mean uniform for matrices, U[0.9, 1.1) for vectors."""
    from indextts_tpu.models.unified_voice import UnifiedVoice as JUV

    m, d = JUV(gcfg), gcfg.model_dim

    def init():
        k = jax.random.PRNGKey(0)
        p = m.init(k, jnp.zeros((1, 32, d)), jnp.zeros((1, 4), jnp.int32), jnp.asarray([4]),
                   jnp.zeros((1, 4), jnp.int32), jnp.asarray([4]), jnp.zeros((1, d)),
                   method=JUV.forward_latent)["params"]
        for args, meth in (((jnp.zeros((1, 8, 1024)), jnp.asarray([8])), JUV.get_conditioning),
                           ((jnp.zeros((1, 8, 1024)), jnp.asarray([8])), JUV.get_emovec),
                           ((jnp.zeros((1, d)),), JUV.mel_logits_from_hidden)):
            for k2, v in m.init(k, *args, method=meth)["params"].items():
                p.setdefault(k2, v)
        return p

    rng = np.random.default_rng(seed)

    def fill(s):
        u = rng.uniform(-1, 1, s.shape).astype(np.float32)
        if len(s.shape) < 2:
            return 1.0 + 0.1 * u
        return u * np.float32(np.sqrt(3.0 / np.prod(s.shape[:-1])))

    return jax.tree_util.tree_map(fill, jax.eval_shape(init))


@pytest.mark.parametrize("n_text,bucket", [(7, 7), (5, 12)])
def test_greedy_decode_token_exact_with_jax_kernels(n_text, bucket):
    """D=512, 8 heads (Dh=64), 2 layers, so that every gate opens: c_attn,
    c_proj and the head through gemv_w8, the MLP through mlp_w8 (2 groups),
    attention over the int8 cache. The JAX decoder runs the Pallas kernels
    in interpret mode (attn_impl="pallas_q8", gemv_impl="pallas", blocks of
    32 tokens); the port, built with gemv_impl="pallas", runs their plain
    versions. Equal codes and lengths; bucket > n_text puts the left-pad
    hole in the prompt.

    Random weights give a 36-token vocabulary close logits, and int8
    rounding turns float32 noise (XLA's fused programs against PyTorch's
    ops) into occasional one-step flips, which moved a logit by 3e-3 on
    another seed. The weights' seed is one whose greedy paths have no near
    tie: top-2 margins of at least 0.03 on both prompts."""
    greedy_decode_matches_jax(24, n_text, bucket, wbits=8, gemv_impl="pallas")


def greedy_decode_matches_jax(seed, n_text, bucket, wbits, gemv_impl):
    """Greedy decode of the D=512 GPT with `seed`'s weights, quantized to
    `wbits` with the int8 head and an int8 cache, on the JAX decoder (its
    Pallas kernels in interpret mode) and on the port's, whose model the
    engine's load_model builds from a config with the same gemv_impl.
    Equal codes and lengths."""
    from indextts_tpu.models.unified_voice import UnifiedVoice as JUV
    from indextts_tpu.runtime.decode import GPTDecoder as JDecoder
    from indextts_tpu.runtime.decode import SamplingConfig as JSampling
    from indextts_tpu.runtime.torch_convert import quantize_gpt_tree

    from indextts_tpu_torch import weights
    from indextts_tpu_torch.runtime.decode import GPTDecoder, SamplingConfig
    from indextts_tpu_torch.runtime.engine import load_model
    from test_engine_e2e import tiny_config

    gcfg = _gpt_config(512, 8)
    tree = _jax_gpt_tree(gcfg, seed=seed)
    jmodel = JUV(gcfg, quantize_gpt=True, head_quant=True, attn_impl="pallas_q8",
                 gemv_impl=gemv_impl, wbits=wbits, pallas_interpret=True)
    jdec = JDecoder(jmodel, gcfg, JSampling(do_sample=False))
    jdec.BLKQ = 32
    jparams = {"params": quantize_gpt_tree(tree, head=True, bits=wbits)}

    cfg = tiny_config()
    rt = dataclasses.replace(cfg.runtime, gpt_quantize=True, head_quant=True, gpt_wbits=wbits,
                             gemv_impl=gemv_impl)
    pcfg = to_port_config(dataclasses.replace(cfg, gpt=gcfg, runtime=rt))
    sd = quantize_gpt_state_dict(weights.unified_voice_sd(tree, pcfg), head=True, bits=wbits)
    model = load_model("gpt", pcfg, sd, "cpu")
    pdec = GPTDecoder(model, pcfg.gpt, SamplingConfig(do_sample=False), kv_int8=True)

    rng = np.random.default_rng(n_text)
    conds = rng.standard_normal((1, 34, 512)).astype(np.float32)
    text = rng.integers(2, 50, (1, n_text))
    arrays = jdec.build_text_prompt_arrays(text, np.array([n_text]), bucket)
    want = jdec.generate(jparams, jnp.asarray(conds), *(jnp.asarray(a) for a in arrays),
                         jax.random.PRNGKey(0), max_new=16, repetition_penalty=10.0)
    got = pdec.generate(t(conds), *(t(a) for a in pdec.build_text_prompt_arrays(
        text, np.array([n_text]), bucket)), None, max_new=16, repetition_penalty_value=10.0,
        do_sample=False)
    assert len(set(np.asarray(want.codes)[0].tolist())) > 3  # not a degenerate row
    np.testing.assert_array_equal(n(got.codes), np.asarray(want.codes))
    np.testing.assert_array_equal(n(got.lengths), np.asarray(want.lengths))
    return model


def test_quantized_slice_matches_jax_engine(monkeypatch):
    """The whole /tts slice with gpt_quantize, head_quant and kv_quant, greedy:
    the JAX engine (float32 GPT, exact shapes) and the port's, from the same
    float parameters, speaker audio, text and CFM noise. Codes equal; mel
    within 1e-4 of its largest value and waveform within 1e-3 of its peak,
    as the float slice test."""
    monkeypatch.setenv("INDEXTTS_NATIVE_DSP", "0")
    pe = quantized_slice_matches_jax(parity_config(gpt_quantize=True, head_quant=True,
                                                   kv_quant=True))
    assert pe.gpt.gpt.h[0].attn.c_attn.weight_q.dtype == torch.int8


def quantized_slice_matches_jax(cfg, seed: int = 1):
    """One greedy request of `cfg` through the JAX engine and the port's
    from the same float parameters (`seed`); returns the port's engine."""
    from indextts_tpu.runtime.engine import IndexTTS2Engine as JaxEngine

    from indextts_tpu_torch.runtime.engine import IndexTTS2Engine
    from test_torch_slice import _capture_codes

    jp = parity_params(cfg, seed=seed)
    pcfg = to_port_config(cfg)
    je = JaxEngine(cfg, jp, precise_shapes=True)
    pe = IndexTTS2Engine(pcfg, from_jax_params(jp, pcfg), device="cpu", precise_shapes=True)
    assert pe.decoder.kv_int8
    rng = np.random.default_rng(0)
    prompt = speech_like(rng, 1.2, 16000)
    text = rng.integers(2, 50, 9)
    noise_rng, noises = np.random.default_rng(5), {}

    def noise(shape):
        if shape not in noises:
            noises[shape] = noise_rng.standard_normal(shape).astype(np.float32)
        return noises[shape]

    out, codes = {}, {}
    for name, eng in (("jax", je), ("port", pe)):
        eng._noise_hook = noise
        eng._mel_taps = []
        codes[name] = []
        _capture_codes(eng, codes[name])
        res = eng.infer((prompt, 16000), [text], seed=0, num_beams=1, do_sample=False)
        out[name] = (eng._mel_taps[0], res["audio"])
    assert len(codes["jax"][0]) > 2
    np.testing.assert_array_equal(codes["port"][0], codes["jax"][0])
    (jm, jw), (pm, pw) = out["jax"], out["port"]
    assert pm.shape == jm.shape and pw.shape == jw.shape
    assert np.abs(pm - jm).max() <= 1e-4 * np.abs(jm).max()
    assert 0 < np.abs(jw).max() < 1.0
    assert np.abs(pw - jw).max() <= 1e-3 * np.abs(jw).max()
    return pe
