"""JAX parameter trees -> the port's state dicts.

`from_jax_params(params, cfg)` takes the JAX package's parameter tree as
numpy arrays (the output of its `random_params`, or of the converters in
indextts_tpu/runtime/torch_convert.py) and inverts exactly what those
converters do, giving one state dict per model in the reference key layout
that the port's modules carry:

  flax Dense kernel (in, out)          -> nn.Linear weight (out, in)
  GPT-2 Conv1D kernel (in, out)        -> as is
  flax Conv kernel (K, I, O)           -> Conv1d weight (O, I, K)
  pointwise Dense (I, O)               -> Conv1d weight (O, I, 1)
  flax Conv2D kernel (H, W, I, O)      -> Conv2d weight (O, I, H, W)
  flax ConvTranspose (K, I, O), K flipped -> ConvTranspose1d weight (I, O, K)
  LayerNorm scale/bias                 -> weight/bias
  BatchNorm mean/var(/scale/bias)      -> running_mean/running_var(/weight/bias)

Weight-normed reference layers (weight_g/weight_v) are carried folded, as
`.weight`.

A GPT tree that the JAX package's `quantize_gpt_tree` already quantized
carries across too: each block layer's {kernel_q (bits=8) or kernel_q4
(bits=4), kernel_scale, bias} becomes {weight_q or weight_q4, weight_scale,
bias}, and the lane-padded int8 `mel_head` the same.
`quantize_gpt_state_dict` is the port's own copy of that quantization, on a
float state dict. Quantized weights keep the JAX layout byte for byte: int8
(in, out) row-major, or packed int4 pairs (in/2, out), or (in, out/2) for
the MLP's c_proj; that is what the kernels of ops/gemv.py read.

`put_as(sd, dtype)` is the JAX engine's store of a tree in a compute
dtype (indextts_tpu/runtime/engine.py `put_as`): every float tensor cast to
`dtype` (round to nearest even, as numpy's and XLA's casts), except the
int8 layers' per-channel `weight_scale` (JAX `kernel_scale`), which stays
float32; integer tensors (int8 weights, BatchNorm counters) as they are.

`qwen3_sd` carries the JAX Qwen3 tree of the text-to-emotion model across
the same way, into the Hugging Face checkpoint's keys.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from indextts_tpu_torch.config import IndexTTS2Config

SD = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _put(sd: SD, prefix: str, tensors: Dict[str, Any]):
    for k, v in tensors.items():
        sd[f"{prefix}.{k}"] = v if isinstance(v, torch.Tensor) else _t(v)


def linear(p) -> dict:
    out = {"weight": np.asarray(p["kernel"]).T}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def pointwise(p) -> dict:
    out = {"weight": np.asarray(p["kernel"]).T[:, :, None]}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def conv1d(p) -> dict:
    out = {"weight": np.asarray(p["kernel"]).transpose(2, 1, 0)}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def conv2d(p) -> dict:
    out = {"weight": np.asarray(p["kernel"]).transpose(3, 2, 0, 1)}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def conv_transpose1d(p) -> dict:
    out = {"weight": np.asarray(p["kernel"])[::-1].transpose(1, 2, 0)}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def layernorm(p) -> dict:
    return {"weight": p["scale"], "bias": p["bias"]}


def batchnorm(p) -> dict:
    out = {"running_mean": p["mean"], "running_var": p["var"],
           "num_batches_tracked": torch.zeros((), dtype=torch.long)}
    if "scale" in p:
        out["weight"] = p["scale"]
        out["bias"] = p["bias"]
    return out


# ---------------------------------------------------------------------------
# UnifiedVoice (conformer, perceiver, GPT-2 core)
# ---------------------------------------------------------------------------


def _conformer(sd: SD, pre: str, p: dict, num_blocks: int):
    _put(sd, f"{pre}.embed.conv.0", conv2d(p["embed"]["conv"]))
    _put(sd, f"{pre}.embed.out.0", linear(p["embed"]["out"]))
    for i in range(num_blocks):
        lp, b = p[f"layer_{i}"], f"{pre}.encoders.{i}"
        sa = lp["self_attn"]
        for n in ("linear_q", "linear_k", "linear_v", "linear_out", "linear_pos"):
            _put(sd, f"{b}.self_attn.{n}", linear(sa[n]))
        _put(sd, f"{b}.self_attn", {"pos_bias_u": sa["pos_bias_u"],
                                    "pos_bias_v": sa["pos_bias_v"]})
        _put(sd, f"{b}.feed_forward.w_1", linear(lp["feed_forward"]["w_1"]))
        _put(sd, f"{b}.feed_forward.w_2", linear(lp["feed_forward"]["w_2"]))
        cm = lp["conv_module"]
        _put(sd, f"{b}.conv_module.pointwise_conv1", pointwise(cm["pointwise_conv1"]))
        _put(sd, f"{b}.conv_module.depthwise_conv", conv1d(cm["depthwise_conv"]))
        _put(sd, f"{b}.conv_module.norm", layernorm(cm["norm"]))
        _put(sd, f"{b}.conv_module.pointwise_conv2", pointwise(cm["pointwise_conv2"]))
        for n in ("norm_mha", "norm_conv", "norm_ff", "norm_final"):
            _put(sd, f"{b}.{n}", layernorm(lp[n]))
    _put(sd, f"{pre}.after_norm", layernorm(p["after_norm"]))


def _perceiver(sd: SD, pre: str, p: dict, depth: int = 2):
    _put(sd, pre, {"latents": p["latents"]})
    if "proj_context" in p:
        _put(sd, f"{pre}.proj_context", linear(p["proj_context"]))
    for i in range(depth):
        for n in ("to_q", "to_kv", "to_out"):
            _put(sd, f"{pre}.layers.{i}.0.{n}", linear(p[f"attn_{i}"][n]))
        _put(sd, f"{pre}.layers.{i}.1.0", linear(p[f"ff_{i}"]["proj_in"]))
        _put(sd, f"{pre}.layers.{i}.1.2", linear(p[f"ff_{i}"]["proj_out"]))
    _put(sd, f"{pre}.norm", {"gamma": p["norm"]["gamma"]})


def _i8(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.int8))


def _quantized(p: dict) -> dict:
    """A quantized JAX Conv1D / dense-head tree -> the port's buffers."""
    key = "kernel_q4" if "kernel_q4" in p else "kernel_q"
    return {key.replace("kernel", "weight"): _i8(p[key]), "weight_scale": p["kernel_scale"],
            "bias": p["bias"]}


def unified_voice_sd(p: dict, cfg: IndexTTS2Config) -> SD:
    g = cfg.gpt
    sd: SD = {}
    _conformer(sd, "conditioning_encoder", p["conditioning_encoder"],
               g.condition_module.num_blocks)
    _perceiver(sd, "perceiver_encoder", p["perceiver_encoder"])
    _conformer(sd, "emo_conditioning_encoder", p["emo_conditioning_encoder"],
               g.emo_condition_module.num_blocks)
    _perceiver(sd, "emo_perceiver_encoder", p["emo_perceiver_encoder"])
    for n in ("text_embedding", "mel_embedding", "speed_emb"):
        _put(sd, n, {"weight": p[n]["embedding"]})
    for n in ("mel_pos_embedding", "text_pos_embedding"):
        _put(sd, f"{n}.emb", {"weight": p[n]["embedding"]})
    for n in ("emovec_layer", "emo_layer"):
        _put(sd, n, linear(p[n]))
    head = p["mel_head"]
    _put(sd, "mel_head", _quantized(head) if "kernel_q" in head else linear(head))
    _put(sd, "final_norm", layernorm(p["final_norm"]))
    gp = p["gpt"]
    for i in range(g.layers):
        lp, b = gp[f"h_{i}"], f"gpt.h.{i}"
        _put(sd, f"{b}.ln_1", layernorm(lp["ln_1"]))
        _put(sd, f"{b}.ln_2", layernorm(lp["ln_2"]))
        for mod, names in (("attn", ("c_attn", "c_proj")), ("mlp", ("c_fc", "c_proj"))):
            for n in names:
                q = lp[mod][n]
                _put(sd, f"{b}.{mod}.{n}", {"weight": q["kernel"], "bias": q["bias"]}
                     if "kernel" in q else _quantized(q))
    _put(sd, "gpt.ln_f", layernorm(gp["ln_f"]))
    return sd


# ---------------------------------------------------------------------------
# s2mel (DiT + WaveNet, length regulator, gpt_layer)
# ---------------------------------------------------------------------------


def _ada_norm(sd: SD, pre: str, p: dict):
    _put(sd, f"{pre}.norm", {"weight": p["rms_weight"]})
    _put(sd, f"{pre}.project_layer", linear(p["project_layer"]))


def s2mel_sd(p: dict, cfg: IndexTTS2Config) -> SD:
    c = cfg.s2mel
    sd: SD = {}
    e, ep = "cfm.estimator", p["cfm_estimator"]
    for n in ("t_embedder", "t_embedder2"):
        _put(sd, f"{e}.{n}.mlp.0", linear(ep[n]["mlp_0"]))
        _put(sd, f"{e}.{n}.mlp.2", linear(ep[n]["mlp_2"]))
    for n in ("cond_projection", "cond_x_merge_linear", "conv1", "res_projection"):
        _put(sd, f"{e}.{n}", linear(ep[n]))
    if "skip_linear" in ep:
        _put(sd, f"{e}.skip_linear", linear(ep["skip_linear"]))
    _put(sd, f"{e}.conv2", pointwise(ep["conv2"]))
    _put(sd, f"{e}.final_layer.linear", linear(ep["final_layer"]["linear"]))
    _put(sd, f"{e}.final_layer.adaLN_modulation.1", linear(ep["final_layer"]["adaLN_1"]))
    tr = ep["transformer"]
    for i in range(c.dit.depth):
        lp, b = tr[f"layer_{i}"], f"{e}.transformer.layers.{i}"
        _put(sd, f"{b}.attention.wqkv", linear(lp["attention"]["wqkv"]))
        _put(sd, f"{b}.attention.wo", linear(lp["attention"]["wo"]))
        for n in ("w1", "w2", "w3"):
            _put(sd, f"{b}.feed_forward.{n}", linear(lp["feed_forward"][n]))
        _ada_norm(sd, f"{b}.attention_norm", lp["attention_norm"])
        _ada_norm(sd, f"{b}.ffn_norm", lp["ffn_norm"])
        if "skip_in_linear" in lp:
            _put(sd, f"{b}.skip_in_linear", linear(lp["skip_in_linear"]))
    _ada_norm(sd, f"{e}.transformer.norm", tr["norm"])
    wn = ep["wavenet"]
    _put(sd, f"{e}.wavenet.cond_layer.conv.conv", pointwise(wn["cond_layer"]))
    for i in range(c.wavenet.num_layers):
        _put(sd, f"{e}.wavenet.in_layers.{i}.conv.conv", conv1d(wn[f"in_layer_{i}"]))
        _put(sd, f"{e}.wavenet.res_skip_layers.{i}.conv.conv",
             pointwise(wn[f"res_skip_{i}"]))
    lr = p["length_regulator"]
    n_ratios = len(c.length_regulator.sampling_ratios)
    _put(sd, "length_regulator.content_in_proj", linear(lr["content_in_proj"]))
    for i in range(n_ratios):
        _put(sd, f"length_regulator.model.{3 * i}", conv1d(lr[f"conv_{i}"]))
        _put(sd, f"length_regulator.model.{3 * i + 1}",
             {"weight": lr[f"norm_{i}"]["scale"], "bias": lr[f"norm_{i}"]["bias"]})
    _put(sd, f"length_regulator.model.{3 * n_ratios}", pointwise(lr["out_proj"]))
    for i in range(len(c.gpt_dims) - 1):
        _put(sd, f"gpt_layer.{i}", linear(p["gpt_layer"][f"linear_{i}"]))
    return sd


# ---------------------------------------------------------------------------
# BigVGAN, RepCodec, CAMPPlus, w2v-BERT
# ---------------------------------------------------------------------------


def bigvgan_sd(p: dict, cfg: IndexTTS2Config) -> SD:
    c = cfg.vocoder
    sd: SD = {}
    _put(sd, "conv_pre", conv1d(p["conv_pre"]))
    _put(sd, "conv_post", conv1d(p["conv_post"]))
    _put(sd, "activation_post.act", {"alpha": p["alpha_post"], "beta": p["beta_post"]})
    nk = len(c.resblock_kernel_sizes)
    for i in range(len(c.upsample_rates)):
        _put(sd, f"ups.{i}.0", conv_transpose1d(p[f"up_{i}"]))
        for j in range(nk):
            blk, r = p[f"resblock_{i}_{j}"], f"resblocks.{i * nk + j}"
            for m in range(len(c.resblock_dilation_sizes[j])):
                _put(sd, f"{r}.convs1.{m}", conv1d(blk[f"conv1_{m}"]))
                _put(sd, f"{r}.convs2.{m}", conv1d(blk[f"conv2_{m}"]))
                _put(sd, f"{r}.activations.{2 * m}.act",
                     {"alpha": blk[f"alpha1_{m}"], "beta": blk[f"beta1_{m}"]})
                _put(sd, f"{r}.activations.{2 * m + 1}.act",
                     {"alpha": blk[f"alpha2_{m}"], "beta": blk[f"beta2_{m}"]})
    return sd


def repcodec_sd(p: dict, cfg: IndexTTS2Config) -> SD:
    sd: SD = {}
    bb = p["encoder_backbone"]
    _put(sd, "encoder.0.embed", conv1d(bb["embed"]))
    _put(sd, "encoder.0.norm", layernorm(bb["norm"]))
    _put(sd, "encoder.0.final_layer_norm", layernorm(bb["final_layer_norm"]))
    for i in range(cfg.semantic_codec.vocos_num_layers):
        cp, b = bb[f"convnext_{i}"], f"encoder.0.convnext.{i}"
        _put(sd, f"{b}.dwconv", conv1d(cp["dwconv"]))
        _put(sd, f"{b}.norm", layernorm(cp["norm"]))
        _put(sd, f"{b}.pwconv1", linear(cp["pwconv1"]))
        _put(sd, f"{b}.pwconv2", linear(cp["pwconv2"]))
        _put(sd, b, {"gamma": cp["gamma"]})
    _put(sd, "encoder.1", linear(p["encoder_out"]))
    q, qp = "quantizer.quantizers.0", p["quantizer"]
    _put(sd, f"{q}.in_project", pointwise(qp["in_project"]))
    _put(sd, f"{q}.out_project", pointwise(qp["out_project"]))
    _put(sd, f"{q}.codebook", {"weight": qp["codebook"]})
    return sd


def _resblock(sd: SD, pre: str, p: dict):
    _put(sd, f"{pre}.conv1", conv2d(p["conv1"]))
    _put(sd, f"{pre}.bn1", batchnorm(p["bn1"]))
    _put(sd, f"{pre}.conv2", conv2d(p["conv2"]))
    _put(sd, f"{pre}.bn2", batchnorm(p["bn2"]))
    if "shortcut_conv" in p:
        _put(sd, f"{pre}.shortcut.0", conv2d(p["shortcut_conv"]))
        _put(sd, f"{pre}.shortcut.1", batchnorm(p["shortcut_bn"]))


def campplus_sd(p: dict, cfg: IndexTTS2Config) -> SD:
    sd: SD = {}
    h = p["head"]
    _put(sd, "head.conv1", conv2d(h["conv1"]))
    _put(sd, "head.bn1", batchnorm(h["bn1"]))
    for layer in ("layer1", "layer2"):
        for k in range(2):
            _resblock(sd, f"head.{layer}.{k}", h[f"{layer}_{k}"])
    _put(sd, "head.conv2", conv2d(h["conv2"]))
    _put(sd, "head.bn2", batchnorm(h["bn2"]))
    x = "xvector"
    _put(sd, f"{x}.tdnn.linear", conv1d(p["tdnn_conv"]))
    _put(sd, f"{x}.tdnn.nonlinear.batchnorm", batchnorm(p["tdnn_bn"]))
    for bi, n in enumerate((12, 24, 16)):
        for li in range(n):
            lp, b = p[f"block{bi + 1}_tdnnd{li + 1}"], f"{x}.block{bi + 1}.tdnnd{li + 1}"
            _put(sd, f"{b}.nonlinear1.batchnorm", batchnorm(lp["nonlinear1_bn"]))
            _put(sd, f"{b}.linear1", pointwise(lp["linear1"]))
            _put(sd, f"{b}.nonlinear2.batchnorm", batchnorm(lp["nonlinear2_bn"]))
            cam = lp["cam_layer"]
            _put(sd, f"{b}.cam_layer.linear_local", conv1d(cam["linear_local"]))
            _put(sd, f"{b}.cam_layer.linear1", pointwise(cam["linear1"]))
            _put(sd, f"{b}.cam_layer.linear2", pointwise(cam["linear2"]))
        _put(sd, f"{x}.transit{bi + 1}.nonlinear.batchnorm",
             batchnorm(p[f"transit{bi + 1}_bn"]))
        _put(sd, f"{x}.transit{bi + 1}.linear", pointwise(p[f"transit{bi + 1}_linear"]))
    _put(sd, f"{x}.out_nonlinear.batchnorm", batchnorm(p["out_bn"]))
    _put(sd, f"{x}.dense.linear", pointwise(p["dense_linear"]))
    _put(sd, f"{x}.dense.nonlinear.batchnorm", batchnorm(p["dense_bn"]))
    return sd


def w2vbert_sd(p: dict, cfg: IndexTTS2Config) -> SD:
    c = cfg.w2vbert
    sd: SD = {}
    _put(sd, "feature_projection.layer_norm", layernorm(p["fp_layer_norm"]))
    _put(sd, "feature_projection.projection", linear(p["fp_projection"]))
    for i in range(c.tap_layer):
        lp, b = p[f"layer_{i}"], f"encoder.layers.{i}"
        for n in ("ffn1_layer_norm", "self_attn_layer_norm", "ffn2_layer_norm",
                  "final_layer_norm"):
            _put(sd, f"{b}.{n}", layernorm(lp[n]))
        for f in ("ffn1", "ffn2"):
            for n in ("intermediate_dense", "output_dense"):
                _put(sd, f"{b}.{f}.{n}", linear(lp[f][n]))
        for n in ("linear_q", "linear_k", "linear_v", "linear_out"):
            _put(sd, f"{b}.self_attn.{n}", linear(lp["self_attn"][n]))
        if "distance_embedding" in lp["self_attn"]:
            _put(sd, f"{b}.self_attn.distance_embedding",
                 {"weight": lp["self_attn"]["distance_embedding"]})
        cm = lp["conv_module"]
        _put(sd, f"{b}.conv_module.layer_norm", layernorm(cm["layer_norm"]))
        _put(sd, f"{b}.conv_module.pointwise_conv1", pointwise(cm["pointwise_conv1"]))
        _put(sd, f"{b}.conv_module.depthwise_conv", conv1d(cm["depthwise_conv"]))
        _put(sd, f"{b}.conv_module.depthwise_layer_norm",
             layernorm(cm["depthwise_layer_norm"]))
        _put(sd, f"{b}.conv_module.pointwise_conv2", pointwise(cm["pointwise_conv2"]))
    return sd


CONVERTERS = {
    "gpt": unified_voice_sd,
    "s2mel": s2mel_sd,
    "bigvgan": bigvgan_sd,
    "repcodec": repcodec_sd,
    "campplus": campplus_sd,
    "w2vbert": w2vbert_sd,
}


def put_as(sd: SD, dtype: torch.dtype) -> SD:
    """`sd` stored in the compute dtype `dtype`: float tensors cast to it,
    the int8 layers' scales (`*.weight_scale`) float32, the rest as is.
    float32 returns `sd` itself, as the JAX engine puts a float32 tree as
    it comes."""
    if dtype == torch.float32:
        return sd
    return {k: v.to(dtype) if v.is_floating_point() and not k.endswith(".weight_scale") else v
            for k, v in sd.items()}


def quantize_gpt_state_dict(sd: SD, head: bool, bits: int = 8) -> SD:
    """A float UnifiedVoice state dict -> its quantized layout (the JAX
    package's `quantize_gpt_tree`): every GPT-2 block matmul's weight becomes
    int8 (bits=8) or packed int4 (bits=4; the MLP's c_proj packed along its
    columns) with a per-output-channel f32 scale, and with `head` the
    mel_head becomes the int8 head with its columns padded to a multiple of
    128 (padding: zero weight and bias, scale 1). Other entries are kept;
    the float weights that were quantized are not."""
    from indextts_tpu_torch.models.gpt2 import quantize_weight, quantize_weight_w4

    if bits not in (8, 4):
        raise ValueError(f"quantized GPT weights have 8 or 4 bits, not {bits}")
    out = {}
    for key, v in sd.items():
        name, _, leaf = key.rpartition(".")
        block = name.startswith("gpt.h.") and name.endswith(
            ("attn.c_attn", "attn.c_proj", "mlp.c_fc", "mlp.c_proj"))
        if block and leaf == "weight" and bits == 4:
            out[f"{name}.weight_q4"], out[f"{name}.weight_scale"] = quantize_weight_w4(
                v, cols=name.endswith("mlp.c_proj"))
        elif block and leaf == "weight":
            out[f"{name}.weight_q"], out[f"{name}.weight_scale"] = quantize_weight(v)
        elif not (head and name == "mel_head"):
            out[key] = v
    if head:
        w, b = sd["mel_head.weight"].t(), sd["mel_head.bias"].float()
        d, f = w.shape
        fpad = -(-f // 128) * 128
        w_q, scale = quantize_weight(w)
        out["mel_head.weight_q"] = torch.zeros((d, fpad), dtype=torch.int8, device=w.device)
        out["mel_head.weight_q"][:, :f] = w_q
        out["mel_head.weight_scale"] = torch.ones(fpad, device=w.device)
        out["mel_head.weight_scale"][:f] = scale
        out["mel_head.bias"] = torch.zeros(fpad, device=w.device)
        out["mel_head.bias"][:f] = b
    return out


def from_jax_params(params: Dict[str, Any], cfg: IndexTTS2Config) -> Dict[str, SD]:
    """{"gpt", "s2mel", "bigvgan", "repcodec", "campplus", "w2vbert"} flax
    trees (numpy leaves) -> the port's state dicts, same keys."""
    return {name: CONVERTERS[name](params[name], cfg) for name in CONVERTERS}


def qwen3_sd(params: Dict[str, Any], cfg) -> SD:
    """The JAX package's Qwen3LM tree (numpy leaves, with its "params" level
    or without) -> a Qwen3ForCausalLM state dict in the checkpoint's keys,
    `model.` prefix included (the inverse of torch_convert.convert_qwen3).
    cfg: QwenEmoConfig."""
    p = params.get("params", params)
    sd: SD = {"model.embed_tokens.weight": _t(p["embed_tokens"]["embedding"]),
              "model.norm.weight": _t(p["norm"]["weight"])}
    for i in range(cfg.num_hidden_layers):
        lp, pre = p[f"layer_{i}"], f"model.layers.{i}"
        for norm in ("input_layernorm", "post_attention_layernorm"):
            sd[f"{pre}.{norm}.weight"] = _t(lp[norm]["weight"])
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            _put(sd, f"{pre}.self_attn.{name}", linear(lp["self_attn"][name]))
        for name in ("q_norm", "k_norm"):
            sd[f"{pre}.self_attn.{name}.weight"] = _t(lp["self_attn"][name]["weight"])
        for name in ("gate_proj", "up_proj", "down_proj"):
            _put(sd, f"{pre}.mlp.{name}", linear(lp["mlp"][name]))
    return sd
