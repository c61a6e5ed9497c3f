"""Checkpoint loading: a reference checkpoint directory -> the port's engine.

Counterpart of indextts_tpu/runtime/loader.py. The reference's layout
(its config.yaml and infer_v2.py:138-289):

  gpt.pth                    UnifiedVoice state dict (or {"model": ...})
  s2mel.pth                  {"net": {"cfm", "length_regulator", "gpt_layer"}},
                             DDP `module.` prefixes
  wav2vec2bert_stats.pt      {"mean", "std"}
  feat1.pt / feat2.pt        the speaker and emotion banks
  bpe.model                  SentencePiece BPE
  config.yaml (optional)     the reference's config tree
  hf/ (optional)             w2v-bert-2.0/*.safetensors, semantic_codec.safetensors,
                             campplus_cn_common.bin, bigvgan_generator.pt
                             ({"generator": ...}, weight-normed or folded)

`convert_reference_checkpoints` reads every file that is there into the
port's state dicts (runtime/torch_convert.py) and the engine's banks and
stats; `load_engine` fills each model whose file is missing with the
port's `random_params(cfg, seed=0)`, says so on stderr, and builds the
engine on the card unless the caller asks for another device. The
safetensors files go through the port's own reader (utils/safetensors.py),
the tokenizer parses bpe.model itself, so a directory without config.yaml
loads with torch alone. Nothing is written into the directory.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from indextts_tpu_torch.config import IndexTTS2Config, load_config
from indextts_tpu_torch.frontend.normalize import TextNormalizer
from indextts_tpu_torch.frontend.tokenizer import TextTokenizer
from indextts_tpu_torch.runtime import torch_convert as tc
from indextts_tpu_torch.runtime.engine import MODELS, IndexTTS2Engine, random_params
from indextts_tpu_torch.utils.safetensors import load_file


class LoadReport(NamedTuple):
    """How `load_engine` built an engine: `engine.load_report`."""

    model_dir: str
    read_seconds: float  # the files read and converted, missing models drawn
    build_seconds: float  # the engine built on its device
    filled: List[str]  # the models that got random weights


def _load(path: Path):
    # the reference's files hold pickled containers, not only tensors
    return torch.load(path, map_location="cpu", weights_only=False)


def convert_reference_checkpoints(
        model_dir: str, cfg: IndexTTS2Config,
        text_head: bool = False) -> Tuple[Dict[str, Dict], Dict[str, Any]]:
    """Checkpoint directory -> (state dicts of the models whose files are
    there, aux: "semantic_stats", "emo_matrix", "spk_matrix" where present).
    With `text_head`, the GPT's is a training model's, gpt.pth's text_head
    kept (finetune.py `--init-from`)."""
    d = Path(model_dir)
    params: Dict[str, Dict] = {}
    aux: Dict[str, Any] = {}

    path = d / "gpt.pth"
    if path.exists():
        sd = _load(path)
        if isinstance(sd, dict) and "model" in sd:
            sd = sd["model"]
        params["gpt"] = tc.convert("gpt", tc.to_numpy_sd(sd), cfg, str(path), text_head)

    path = d / "s2mel.pth"
    if path.exists():
        state = _load(path)
        net = tc.s2mel_net(state.get("net", state), str(path))
        params["s2mel"] = tc.convert("s2mel", net, cfg, str(path))

    path = d / "wav2vec2bert_stats.pt"
    if path.exists():
        stats = _load(path)
        aux["semantic_stats"] = (stats["mean"].float().numpy(), stats["std"].float().numpy())

    for name, key in (("feat2.pt", "emo_matrix"), ("feat1.pt", "spk_matrix")):
        if (d / name).exists():
            aux[key] = _load(d / name).float().numpy()

    hf = d / "hf"
    w2v_dir = hf / "w2v-bert-2.0"
    if w2v_dir.exists():
        sd = {}
        for f in sorted(w2v_dir.glob("*.safetensors")):
            sd.update(load_file(f))
        params["w2vbert"] = tc.convert("w2vbert", tc.to_numpy_sd(sd), cfg, str(w2v_dir))

    path = hf / "semantic_codec.safetensors"
    if path.exists():
        params["repcodec"] = tc.convert("repcodec", tc.to_numpy_sd(load_file(path)), cfg,
                                        str(path))

    path = hf / "campplus_cn_common.bin"
    if path.exists():
        params["campplus"] = tc.convert("campplus", tc.to_numpy_sd(_load(path)), cfg, str(path))

    path = hf / "bigvgan_generator.pt"
    if path.exists():
        sd = _load(path)
        sd = sd.get("generator", sd)
        params["bigvgan"] = tc.convert("bigvgan", tc.to_numpy_sd(sd), cfg, str(path))

    return params, aux


def model_config(model_dir: str, cfg_path: Optional[str] = None) -> IndexTTS2Config:
    """The configuration of a checkpoint directory: `cfg_path`, else its
    config.yaml, else the defaults."""
    yaml_path = Path(model_dir) / "config.yaml"
    return load_config(cfg_path or (str(yaml_path) if yaml_path.exists() else None))


def load_engine(model_dir: str, cfg_path: Optional[str] = None,
                cfg: Optional[IndexTTS2Config] = None, device=None, **engine_kwargs):
    """Build an IndexTTS2Engine on `device` (default: the card) from a
    checkpoint directory. `cfg`, a config tree already built, comes before
    `cfg_path` and config.yaml (`model_config`): the vocoder, w2v-BERT and
    CAMPPlus sections come from their own checkpoints in the reference, and
    config.yaml does not express them. The engine's `load_report` says how
    long the load took and which models got random weights."""
    if cfg is None:
        cfg = model_config(model_dir, cfg_path)
    t0 = time.perf_counter()
    params, aux = convert_reference_checkpoints(model_dir, cfg)
    filled = [name for name in MODELS if name not in params]
    if filled:
        print(f">> {model_dir}: no checkpoint for {', '.join(filled)}: random weights "
              "(seed 0)", file=sys.stderr)
        for name, sd in random_params(cfg, seed=0, device=device).items():
            params.setdefault(name, sd)

    tokenizer = None
    bpe = Path(model_dir) / "bpe.model"
    if bpe.exists():
        tokenizer = TextTokenizer(str(bpe), TextNormalizer())
    t1 = time.perf_counter()
    engine = IndexTTS2Engine(cfg, params, device=device, emo_matrix=aux.get("emo_matrix"),
                             spk_matrix=aux.get("spk_matrix"),
                             semantic_stats=aux.get("semantic_stats"), tokenizer=tokenizer,
                             **engine_kwargs)
    engine.load_report = LoadReport(str(model_dir), t1 - t0, time.perf_counter() - t1, filled)
    return engine
