"""The port's W4A8 decode route (packed int4 weights; kernels K7 gemv_w4 and
K8 mlp_w4) and its resolution of `gemv_impl`, against the JAX package, on
the CPU.

The same numpy-seeded inputs go through the JAX function and the port's plain
version of the kernel that replaces it (what the port's wrappers run for CPU
tensors). Pallas kernels run in interpret mode, as the JAX package's own
tests run them. tests/test_torch_cuda.py holds each CUDA kernel to its plain
version on a GPU.

Tolerances: packing, unpacking and quantization bit-exact (the same integer
and float32 operations, round half to even); gemv_w4 1e-6 (the same int32
sums and float32 epilogue); the fused and the plain MLPs 1e-4 of max|out|
(XLA's tanh and the port's differ in the last bits, which can move an int8
rounding of the hidden); greedy codes exact; the engine slice as the W8
slice test (tests/test_torch_quant.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from indextts_tpu_torch.ops import gemv as gemv_ops
from indextts_tpu_torch.runtime.engine import resolve_gemv
from indextts_tpu_torch.weights import from_jax_params, quantize_gpt_state_dict
from test_torch_quant import greedy_decode_matches_jax, quantized_slice_matches_jax
from torch_parity import n, parity_config, parity_params, t, to_port_config


def _w4_weights(rng, d, f, cols=False):
    from indextts_tpu.models.gpt2 import quantize_conv1d_params_w4

    w = rng.standard_normal((d, f)).astype(np.float32) * np.float32(1 / np.sqrt(d))
    q = quantize_conv1d_params_w4(
        {"kernel": w, "bias": rng.standard_normal(f).astype(np.float32) * 0.1}, cols=cols)
    return q["kernel_q4"], q["kernel_scale"], q["bias"]


def _row(rng, b, d):
    from indextts_tpu.models.gpt2 import _quant_row

    return _quant_row(jnp.asarray(rng.standard_normal((b, d)).astype(np.float32)))


# ---------------------------------------------------------------------------
# packing, gating, quantization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cols", [False, True])
def test_pack_unpack_w4_bit_exact(cols):
    """pack_w4 / unpack_w4 equal the JAX pair along either axis, for every
    int4 value (-8 included) and every byte."""
    from indextts_tpu.models.gpt2 import pack_w4 as jpack_w4
    from indextts_tpu.ops.gemv import unpack_w4 as junpack_w4

    axis = 1 if cols else 0
    q = np.random.default_rng(int(cols)).integers(-8, 8, (64, 96)).astype(np.int32)
    q[0, 0] = q[-1, -1] = -8  # in the low and in the high half
    want = jpack_w4(q, cols=cols)
    got = gemv_ops.pack_w4(t(q), cols=cols)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(n(got), want)
    np.testing.assert_array_equal(n(gemv_ops.unpack_w4(got, axis=axis)), q)
    every = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    np.testing.assert_array_equal(n(gemv_ops.unpack_w4(t(every), axis=axis)),
                                  np.asarray(junpack_w4(jnp.asarray(every), axis=axis)))


def test_w4_gating_matches_jax():
    """supports_w4, supports_mlp_w4 and the W4 MLP's group width are the
    JAX package's on a grid of widths, and the group width equals the W8
    one at every even width: ten groups of 512 at full width."""
    from indextts_tpu.ops import gemv as jgemv

    for d in (64, 128, 192, 256, 320, 512, 640, 768, 1024, 1280, 1536, 2048):
        for f in (100, 128, 256, 384, 512, 768, 1024, 1280, 2048, 3840, 5120, 8320):
            assert gemv_ops.supports_w4(d, f) == jgemv.supports_w4(d, f), (d, f)
            assert gemv_ops.supports_mlp_w4(d, f) == jgemv.supports_mlp_w4(d, f), (d, f)
            assert gemv_ops.mlp_group_w4(d, f) == jgemv._pick_block(
                d // 2, f, target=jgemv._TARGET_TILE_BYTES_W4), (d, f)
            assert gemv_ops.mlp_group_w4(d, f) == gemv_ops.mlp_group(d, f), (d, f)
    assert gemv_ops.mlp_group_w4(1280, 5120) == 512
    assert gemv_ops.supports_w4(1280, 3840) and gemv_ops.supports_w4(1280, 1280)
    assert gemv_ops.supports_mlp_w4(1280, 5120) and not gemv_ops.supports_mlp_w4(128, 512)


def test_quantize_gpt_state_dict_w4_matches_quantize_gpt_tree():
    """The port's W4 quantization of a float state dict equals the JAX
    package's quantize_gpt_tree(bits=4, head=True) carried over by
    from_jax_params: the same keys, packed bytes bit-exact (the MLP's c_proj
    packed along its columns), scales and biases equal."""
    from indextts_tpu.runtime.torch_convert import quantize_gpt_tree

    cfg = parity_config()
    pcfg = to_port_config(cfg)
    d = cfg.gpt.model_dim
    jp = parity_params(cfg, seed=2)
    mine = quantize_gpt_state_dict(from_jax_params(jp, pcfg)["gpt"], head=True, bits=4)
    want = from_jax_params(dict(jp, gpt=quantize_gpt_tree(jp["gpt"], head=True, bits=4)),
                           pcfg)["gpt"]
    assert sorted(mine) == sorted(want)
    assert want["gpt.h.0.attn.c_attn.weight_q4"].shape == (d // 2, 3 * d)
    assert want["gpt.h.0.mlp.c_proj.weight_q4"].shape == (4 * d, d // 2)
    assert want["mel_head.weight_q"].dtype == torch.int8
    for k in want:
        assert mine[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(n(mine[k]), n(want[k]), err_msg=k)


# ---------------------------------------------------------------------------
# K7 gemv_w4, K8 mlp_w4: plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,d,f", [(1, 256, 768), (3, 256, 768), (1, 1280, 3840),
                                   (3, 1280, 1280), (16, 256, 768), (1, 256, 8320)])
def test_gemv_w4_plain_matches_jax(b, d, f):
    """y = (xq[:, :D/2] . lo + xq[:, D/2:] . hi) * (a * s) + bias, against
    JAX gemv_w4 in interpret mode, at one, three and sixteen rows (one
    launch's most) and at the logits head's padded F (rtol and atol
    1e-6)."""
    from indextts_tpu.ops.gemv import gemv_w4

    rng = np.random.default_rng(b * 1000 + f)
    w = _w4_weights(rng, d, f)
    xq, a = _row(rng, b, d)
    want = np.asarray(gemv_w4(xq, a.reshape(b), *map(jnp.asarray, w), interpret=True))
    got = gemv_ops.gemv_w4(t(np.asarray(xq)), t(np.asarray(a)), *map(t, w))
    assert got.shape == want.shape == (b, f)
    np.testing.assert_allclose(n(got), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("b,d", [(1, 512), (3, 512), (1, 1280)])
def test_mlp_w4_plain_matches_jax(b, d):
    """The fused W4 MLP (fc packed by rows, fc2 by columns, the hidden
    quantized per group: 2 of 1024 at D=512, 10 of 512 at D=1280) against
    JAX mlp_w4 in interpret mode: within 1e-4 of max|out|."""
    from indextts_tpu.ops.gemv import mlp_w4

    rng = np.random.default_rng(d + b)
    ws = _w4_weights(rng, d, 4 * d) + _w4_weights(rng, 4 * d, d, cols=True)
    xq, a = _row(rng, b, d)
    want = np.asarray(mlp_w4(xq, a.reshape(b), *map(jnp.asarray, ws), interpret=True))
    got = n(gemv_ops.mlp_w4(t(np.asarray(xq)), t(np.asarray(a)), *map(t, ws)))
    assert got.shape == want.shape == (b, d)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


# ---------------------------------------------------------------------------
# gemv_impl, resolved as the JAX engine resolves it
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl,quantize,wbits,device,kernels", [
    ("auto", True, 8, "cuda", True),
    ("auto", True, 8, "cpu", False),
    ("auto", True, 4, "cuda", True),
    ("auto", True, 4, "cpu", False),
    ("auto", False, 4, "cuda", False),
    ("xla", True, 4, "cuda", False),
    ("pallas", True, 8, "cpu", True),
    ("pallas", True, 4, "cuda", True),
])
def test_resolve_gemv(impl, quantize, wbits, device, kernels):
    """"pallas" takes the kernels, "xla" does not, "auto" on CUDA for W8
    and W4 (the JAX engine, indextts_tpu/runtime/engine.py:117-138, keeps
    W8 on XLA under "auto"; the port's plain W8 contraction decodes at about
    half K5's and K6's rate on the card); an unquantized GPT takes none."""
    cfg = to_port_config(parity_config(gpt_quantize=quantize, gpt_wbits=wbits, gemv_impl=impl))
    assert resolve_gemv(cfg, device) is kernels


@pytest.mark.parametrize("impl", ["xla", "auto"])
def test_w8_mlp_layer_matches_jax_xla_route(impl):
    """A D=512 W8 MLP layer of a model that the engine would build for the
    card under gemv_impl="xla" or "auto", against the JAX GPT2MLP of the
    same route. "xla": its single-row call quantizes the hidden per row over
    all 2048 columns, as the JAX GPT2MLP with gemv=False, not per group of
    1024 as mlp_w8 does. "auto" takes K6 on the card; here its plain
    version, against the JAX GPT2MLP with gemv=True (the Pallas mlp_w8 in
    interpret mode). Within 1e-4 of max|out|."""
    from indextts_tpu.models.gpt2 import GPT2MLP as JMLP
    from indextts_tpu.models.gpt2 import quantize_conv1d_params

    from indextts_tpu_torch.models.gpt2 import GPT2MLP

    d = 512
    cfg = to_port_config(parity_config(gpt_quantize=True, gemv_impl=impl))
    mlp = GPT2MLP(d, quantize=True, gemv=resolve_gemv(cfg, "cuda"))
    rng = np.random.default_rng(7)
    tree = {}
    for name, (di, f) in (("c_fc", (d, 4 * d)), ("c_proj", (4 * d, d))):
        w = rng.standard_normal((di, f)).astype(np.float32) * np.float32(1 / np.sqrt(di))
        tree[name] = quantize_conv1d_params(
            {"kernel": w, "bias": rng.standard_normal(f).astype(np.float32) * 0.1})
        layer = getattr(mlp, name)
        layer.weight_q.copy_(t(tree[name]["kernel_q"]))
        layer.weight_scale.copy_(t(tree[name]["kernel_scale"]))
        layer.bias.copy_(t(tree[name]["bias"]))
    x = rng.standard_normal((1, 1, d)).astype(np.float32)
    want = np.asarray(JMLP(quantize=True, gemv=mlp.gemv, pallas_interpret=True).apply(
        {"params": tree}, jnp.asarray(x)))
    assert mlp.gemv is (impl == "auto")
    got = n(mlp(t(x)))
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


# ---------------------------------------------------------------------------
# greedy decode and the whole slice
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_text,bucket", [(7, 7), (5, 12)])
def test_greedy_decode_w4_token_exact_with_jax_kernels(n_text, bucket):
    """W4, D=512, 8 heads, 2 layers, so that every gate opens: c_attn and
    attn c_proj through gemv_w4, the MLP through mlp_w4 (2 groups), the int8
    head through gemv_w8, attention over the int8 cache. The JAX decoder
    runs the Pallas kernels in interpret mode (gemv_impl="pallas"); the
    port, built with the same gemv_impl, runs their plain versions. Equal
    codes and lengths. The weights' seed is one whose greedy paths have
    top-2 margins of at least 0.06 on both prompts (see the W8 test)."""
    model = greedy_decode_matches_jax(49, n_text, bucket, wbits=4, gemv_impl="pallas")
    assert model.gpt.h[0].mlp.gemv and model.gpt.h[0].mlp.c_proj.weight_q4.shape == (2048, 256)


@pytest.mark.parametrize("wbits,seed", [(8, 24), (4, 49)])
@pytest.mark.parametrize("n_text,bucket", [(7, 7), (5, 12)])
def test_greedy_decode_xla_route_token_exact(wbits, seed, n_text, bucket):
    """gemv_impl="xla" at D=512, where every gate would open: both packages
    take the plain contraction (the MLP's hidden quantized per row, W4
    weights unpacked per call), K4's attention over the int8 cache. Equal
    codes and lengths; the seeds' top-2 margins are at least 0.03."""
    model = greedy_decode_matches_jax(seed, n_text, bucket, wbits=wbits, gemv_impl="xla")
    assert not model.gpt.h[0].mlp.gemv


def test_w4_slice_matches_jax_engine(monkeypatch):
    """The whole /tts slice with gpt_quantize, gpt_wbits=4, head_quant and
    kv_quant, greedy, against the JAX engine from the same float parameters:
    codes equal, mel and waveform as the W8 slice test. gemv_impl="auto"
    resolves to the plain contraction on both (the CPU). The parameters'
    seed is 2: on seed 1 one int8 rounding of an activation in the latent
    pass lands on the other side in the two packages, which moves the mel
    by 1.8e-4 of its largest value (seeds 2 and 3: 5.5e-7 and 2.4e-5)."""
    monkeypatch.setenv("INDEXTTS_NATIVE_DSP", "0")
    pe = quantized_slice_matches_jax(parity_config(
        gpt_quantize=True, gpt_wbits=4, head_quant=True, kv_quant=True), seed=2)
    assert not pe.gpt.gpt.h[0].mlp.gemv
    assert pe.gpt.gpt.h[0].attn.c_attn.weight_q4.dtype == torch.int8


def test_env_selects_the_w4_route(monkeypatch):
    """TARS_GPT_QUANTIZE=1 TARS_GPT_WBITS=4 (the serving env) builds a W4
    engine: packed block weights, the int8 head, no float copy."""
    from indextts_tpu_torch.config import RuntimeConfig
    from indextts_tpu_torch.runtime.engine import IndexTTS2Engine, random_params

    monkeypatch.setenv("TARS_GPT_QUANTIZE", "1")
    monkeypatch.setenv("TARS_GPT_WBITS", "4")
    monkeypatch.setenv("TARS_HEAD_QUANT", "1")
    pcfg = to_port_config(parity_config())
    cfg = dataclasses.replace(pcfg, runtime=RuntimeConfig.from_env())
    eng = IndexTTS2Engine(cfg, random_params(cfg, seed=0, device="cpu"), device="cpu")
    sd = eng.gpt.state_dict()
    d = cfg.gpt.model_dim
    assert sd["gpt.h.0.attn.c_attn.weight_q4"].shape == (d // 2, 3 * d)
    assert sd["gpt.h.0.mlp.c_proj.weight_q4"].shape == (4 * d, d // 2)
    assert "mel_head.weight_q" in sd
    assert not any(k.endswith(".weight") and ".h." in k and "ln_" not in k for k in sd)
