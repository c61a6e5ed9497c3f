"""Reference checkpoints -> the port's state dicts.

Counterpart of indextts_tpu/runtime/torch_convert.py. The port's modules
carry the reference's key names and layouts (weights.py), so no tree is
rebuilt: for each of the six models `convert` takes from the reference's
state dict exactly the keys that the JAX converter reads (`convert_unified_voice`,
`convert_s2mel`, `convert_bigvgan`, `convert_repcodec`, `convert_campplus`,
`convert_w2vbert`), as float32 numpy arrays (`to_numpy_sd`), and gives them
as tensors under the port's keys. The tensors are those of
`weights.from_jax_params` applied to the JAX converter's tree, to the bit:

- weight-norm pairs (`weight_g`, `weight_v`) are folded as the JAX package
  folds them, in numpy float32 by the same expression (`fold_weight_norm`):
  always for the DiT's final linear, WaveNet's layers and RepCodec's
  projections, and for every BigVGAN convolution that has a pair;
- the s2mel checkpoint's `net` modules become the prefixes of the port's
  keys (`cfm.`, `length_regulator.`, `gpt_layer.`), their DDP `module.`
  prefixes stripped (`strip_ddp_prefix`);
- a key the JAX converter reads that no serving module holds (the GPT's
  `text_head`) is read and dropped, and kept for a training model
  (`text_head=True`, runtime/train.py); BatchNorm's `num_batches_tracked`,
  which it never reads, is 0;
- a key the JAX converter reads that the file lacks raises a KeyError that
  names the key and the file.

Every other key of the file is ignored, as the JAX converter ignores it
(w2v-BERT's layers past `tap_layer`, `masked_spec_embed`, ...).

The v1 family has converters of its own, `convert_unified_voice_v1`,
`convert_ecapa`, `convert_bigvgan_v1` and `convert_dvae`, which give the
tensors of weights.py's `unified_voice_v1_sd`, `ecapa_sd`, `bigvgan_v1_sd`
and `dvae_sd` applied to the JAX converters' trees, by the same rules.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from indextts_tpu_torch.config import IndexTTS2Config
from indextts_tpu_torch.models.bigvgan_v1 import BigVGANv1
from indextts_tpu_torch.models.dvae import DVAE
from indextts_tpu_torch.models.ecapa import ECAPA_TDNN
from indextts_tpu_torch.models.unified_voice_v1 import UnifiedVoiceV1
from indextts_tpu_torch.runtime.engine import MODELS, _float_gpt

Array = np.ndarray
SD = Dict[str, Array]

# s2mel.pth's `net` modules, in the port's key prefixes
S2MEL_MODULES = ("cfm", "length_regulator", "gpt_layer")


def to_numpy_sd(torch_state_dict) -> SD:
    """torch state_dict -> {name: float32 numpy}."""
    return {k: v.detach().cpu().float().numpy() for k, v in torch_state_dict.items()}


def strip_ddp_prefix(sd: SD) -> SD:
    return {(k[len("module."):] if k.startswith("module.") else k): v for k, v in sd.items()}


def fold_weight_norm(sd: SD, p: str) -> Array:
    g = sd[f"{p}.weight_g"]
    v = sd[f"{p}.weight_v"]
    axes = tuple(range(1, v.ndim))
    norm = np.sqrt(np.sum(v * v, axis=axes, keepdims=True))
    return g * v / norm


def always_folded(name: str, layer: str) -> bool:
    """Is `layer`'s weight always stored as a weight-norm pair (the JAX
    converter's wn_linear / wn_conv1d / wn_conv1d_as_dense)?"""
    if name == "s2mel":
        return layer == "cfm.estimator.final_layer.linear" or layer.startswith(
            "cfm.estimator.wavenet.")
    return name == "repcodec" and layer in ("quantizer.quantizers.0.in_project",
                                            "quantizer.quantizers.0.out_project")


def port_state(name: str, cfg: IndexTTS2Config) -> Dict[str, torch.Tensor]:
    """Model `name`'s state dict as the port builds it from `cfg`, on the
    meta device (keys, shapes and dtypes only); the GPT's float layout."""
    meta = torch.device("meta")
    with meta:
        return MODELS[name](_float_gpt(cfg), meta).state_dict()


class _Reader:
    """Reads keys of one model's reference state dict; a missing one is a
    KeyError naming it and `source`."""

    def __init__(self, sd: SD, source: str):
        self.sd, self.source = sd, source

    def __call__(self, key: str) -> Array:
        if key not in self.sd:
            raise KeyError(f"{self.source}: no {key!r}, which the reference converter reads")
        return self.sd[key]

    def fold(self, layer: str) -> Array:
        self(f"{layer}.weight_g")
        self(f"{layer}.weight_v")
        return fold_weight_norm(self.sd, layer)


def _read(state: Dict[str, torch.Tensor], read: "_Reader", folded) -> Dict[str, torch.Tensor]:
    """The port's state dict whose keys, shapes and dtypes `state` gives,
    read with `read`: a weight for which `folded(layer)` holds from its
    weight-norm pair, BatchNorm's num_batches_tracked 0, the rest as is."""
    out = {}
    for key, like in state.items():
        if like.dtype == torch.int64:  # num_batches_tracked
            out[key] = torch.zeros((), dtype=torch.long)
            continue
        layer, _, leaf = key.rpartition(".")
        w = read.fold(layer) if leaf == "weight" and folded(layer) else read(key)
        out[key] = torch.from_numpy(np.ascontiguousarray(w, np.float32))
    return out


def _text_head(out, read: "_Reader", sd: SD, keep: bool):
    """Read the GPT's text_head, which the JAX converter reads, and keep it
    for a training model only."""
    for leaf in ("weight", "bias"):
        if leaf == "weight" or f"text_head.{leaf}" in sd:
            w = read(f"text_head.{leaf}")
            if keep:
                out[f"text_head.{leaf}"] = torch.from_numpy(np.ascontiguousarray(w, np.float32))


def convert(name: str, sd: SD, cfg: IndexTTS2Config, source: str,
            text_head: bool = False) -> Dict[str, torch.Tensor]:
    """One model's reference state dict (float32 numpy, DDP prefixes
    stripped; for "s2mel" the `net` modules' keys under their prefixes, see
    `s2mel_net`) -> the port's state dict for `name`. With `text_head`, a
    training GPT's: its text_head is kept."""
    read = _Reader(sd, source)
    out = _read(port_state(name, cfg), read, lambda layer: always_folded(name, layer) or (
        name == "bigvgan" and f"{layer}.weight_g" in sd))
    if name == "gpt":
        _text_head(out, read, sd, text_head)
    return out


# the v1 family: the JAX converters `convert_unified_voice_v1`,
# `convert_ecapa`, `convert_bigvgan_v1` and `convert_dvae`
# (indextts_tpu/runtime/torch_convert.py:611-722). BigVGAN v1 folds a
# weight-norm pair where the file has one in the layers that the JAX
# `_bv_conv1d` / `_bv_convtranspose1d` read (conv_pre, conv_post, ups,
# resblocks); its ECAPA and conditioning layers are plain convolutions.
V1_MAYBE_FOLDED = ("conv_pre", "conv_post", "ups.", "resblocks.")


def _meta_state(ctor) -> Dict[str, torch.Tensor]:
    with torch.device("meta"):
        return ctor().state_dict()


def convert_unified_voice_v1(sd: SD, cfg, source: str) -> Dict[str, torch.Tensor]:
    """The reference UnifiedVoice v1 state dict -> the port's (float).
    cfg: the v1 GPTConfig. The text_head is read, as the JAX converter
    reads it, and dropped."""
    read = _Reader(sd, source)
    out = _read(_meta_state(lambda: UnifiedVoiceV1(cfg)), read, lambda layer: False)
    _text_head(out, read, sd, keep=False)
    return out


def convert_ecapa(sd: SD, source: str, prefix: str = "", **ecapa) -> Dict[str, torch.Tensor]:
    """A reference ECAPA-TDNN state dict (its keys after `prefix`) -> the
    port's, keys without the prefix. `ecapa`: models/ecapa.py ECAPA_TDNN's
    arguments (input_size, lin_neurons, channels, ...)."""
    read = _Reader({k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)},
                   source)
    return _read(_meta_state(lambda: ECAPA_TDNN(**ecapa)), read, lambda layer: False)


def convert_bigvgan_v1(sd: SD, cfg, source: str) -> Dict[str, torch.Tensor]:
    """The reference BigVGAN v1 state dict (weight-norm pairs or folded)
    -> the port's. cfg: BigVGANv1Config."""
    return _read(_meta_state(lambda: BigVGANv1(cfg)), _Reader(sd, source),
                 lambda layer: layer.startswith(V1_MAYBE_FOLDED)
                 and f"{layer}.weight_g" in sd)


def convert_dvae(sd: SD, cfg, source: str) -> Dict[str, torch.Tensor]:
    """The reference DiscreteVAE state dict -> the port's encoder side.
    cfg: DVAEConfig."""
    return _read(_meta_state(lambda: DVAE(cfg)), _Reader(sd, source), lambda layer: False)


def s2mel_net(net: Dict[str, Dict[str, torch.Tensor]], source: str) -> SD:
    """s2mel.pth's `net` dict -> one flat float32 numpy dict under the
    port's prefixes (`cfm.`, `length_regulator.`, `gpt_layer.`)."""
    out = {}
    for module in S2MEL_MODULES:
        if module not in net:
            raise KeyError(f"{source}: no {module!r} in its net, which the reference "
                           "converter reads")
        out.update({f"{module}.{k}": v
                    for k, v in strip_ddp_prefix(to_numpy_sd(net[module])).items()})
    return out

