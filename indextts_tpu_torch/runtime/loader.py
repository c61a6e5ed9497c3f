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
loads with torch alone.

The converted-weights cache (`use_native_cache`, on by default, as the JAX
loader's `jax_cache/`): the first load writes `<model_dir>/torch_cache/`,
one safetensors file a converted model (`<name>.safetensors`, the port's
state dict as the converter returns it, before any quantization or dtype
change at engine build) and `aux.safetensors` (the banks and the semantic
stats), so that a later load reads them and converts nothing. Each file's
metadata records every source file's name, size and mtime_ns and a digest
of the models' config sections; a load whose records differ (a replaced
gpt.pth, a file added or removed, another config) converts again and
rewrites the cache, where the JAX loader would keep its stale `jax_cache/`.
A file is written under a temporary name and renamed, the manifest
(aux.safetensors) last, so a cut write leaves no cache that reads as
current. A write that fails (a read-only directory) is named on stderr and
the load goes on from the converted weights. Models without a file are
drawn afterwards and never cached.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
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
from indextts_tpu_torch.utils.safetensors import load_file, load_file_with_metadata, save_file

CACHE_DIR = "torch_cache"
CACHE_VERSION = "1"
# the config sections the converted state dicts depend on
MODEL_SECTIONS = ("gpt", "s2mel", "vocoder", "semantic_codec", "campplus", "w2vbert")
AUX_KEYS = ("emo_matrix", "spk_matrix")


class LoadReport(NamedTuple):
    """How `load_engine` built an engine: `engine.load_report`."""

    model_dir: str
    read_seconds: float  # the cache, or the files read and converted; missing models drawn
    build_seconds: float  # the engine built on its device
    filled: List[str]  # the models that got random weights
    cache: str = "not used"  # torch_cache/: "read", "written" or "not used"
    cache_bytes: int = 0  # the cache's files, where it was read or written
    write_seconds: float = 0.0  # writing the cache (not in read_seconds)


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


def source_records(model_dir: str) -> Dict[str, List[int]]:
    """{path relative to the directory: [size, mtime_ns]} of every file
    `convert_reference_checkpoints` reads that is there."""
    d = Path(model_dir)
    names = ["gpt.pth", "s2mel.pth", "wav2vec2bert_stats.pt", "feat1.pt", "feat2.pt",
             "hf/semantic_codec.safetensors", "hf/campplus_cn_common.bin",
             "hf/bigvgan_generator.pt"]
    paths = [d / name for name in names] + sorted((d / "hf" / "w2v-bert-2.0").glob(
        "*.safetensors"))
    out = {}
    for path in paths:
        if path.is_file():
            st = path.stat()
            out[path.relative_to(d).as_posix()] = [st.st_size, st.st_mtime_ns]
    return out


def cache_metadata(model_dir: str, cfg: IndexTTS2Config, models) -> Dict[str, str]:
    """What a current cache's files record: the source files, a digest of
    the models' config sections, the models cached."""
    sections = {s: dataclasses.asdict(getattr(cfg, s)) for s in MODEL_SECTIONS}
    digest = hashlib.sha256(json.dumps(sections, sort_keys=True, default=str).encode())
    return {"format": "pt", "version": CACHE_VERSION,
            "sources": json.dumps(source_records(model_dir), sort_keys=True),
            "config": digest.hexdigest(), "models": ",".join(models)}


def _aux_tensors(aux: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    out = {k: torch.from_numpy(aux[k]) for k in AUX_KEYS if k in aux}
    if "semantic_stats" in aux:
        out["semantic_stats.mean"], out["semantic_stats.std"] = (
            torch.from_numpy(a) for a in aux["semantic_stats"])
    return out


def _aux_arrays(tensors: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    aux = {k: tensors[k].numpy() for k in AUX_KEYS if k in tensors}
    if "semantic_stats.mean" in tensors:
        aux["semantic_stats"] = (tensors["semantic_stats.mean"].numpy(),
                                 tensors["semantic_stats.std"].numpy())
    return aux


def read_cache(model_dir: str, cfg: IndexTTS2Config):
    """(state dicts, aux, bytes) from `<model_dir>/torch_cache/` where every
    file of it is there and records the directory's sources and config as
    they are now; else None."""
    cache = Path(model_dir) / CACHE_DIR
    manifest = cache / "aux.safetensors"
    if not manifest.is_file():
        return None
    tensors, meta = load_file_with_metadata(manifest)
    models = [m for m in meta.get("models", "").split(",") if m]
    if meta != cache_metadata(model_dir, cfg, models):
        return None
    params, nbytes = {}, manifest.stat().st_size
    for name in models:
        path = cache / f"{name}.safetensors"
        if not path.is_file():
            return None
        params[name], file_meta = load_file_with_metadata(path)
        if file_meta != meta:
            return None
        nbytes += path.stat().st_size
    return params, _aux_arrays(tensors), nbytes


def write_cache(model_dir: str, cfg: IndexTTS2Config, params: Dict[str, Dict],
                aux: Dict[str, Any]) -> int:
    """Write `<model_dir>/torch_cache/` from the converted `params` and
    `aux`; each file under a temporary name, then renamed, the manifest
    last; the cached models' files of an earlier write that are no longer
    converted removed. Returns its bytes. Raises OSError where it cannot
    write."""
    cache = Path(model_dir) / CACHE_DIR
    cache.mkdir(exist_ok=True)
    meta = cache_metadata(model_dir, cfg, list(params))
    files = [(f"{name}.safetensors", sd) for name, sd in params.items()]
    files.append(("aux.safetensors", _aux_tensors(aux)))
    nbytes = 0
    for name, tensors in files:
        path = cache / name
        tmp = path.with_name(f"{name}.{os.getpid()}.tmp")
        try:
            save_file(tensors, tmp, meta)
            os.replace(tmp, path)
        finally:
            tmp.unlink(missing_ok=True)
        nbytes += path.stat().st_size
    for name in MODELS:
        if name not in params:
            (cache / f"{name}.safetensors").unlink(missing_ok=True)
    return nbytes


def load_engine(model_dir: str, cfg_path: Optional[str] = None,
                cfg: Optional[IndexTTS2Config] = None, device=None,
                use_native_cache: bool = True, **engine_kwargs):
    """Build an IndexTTS2Engine on `device` (default: the card) from a
    checkpoint directory. `cfg`, a config tree already built, comes before
    `cfg_path` and config.yaml (`model_config`): the vocoder, w2v-BERT and
    CAMPPlus sections come from their own checkpoints in the reference, and
    config.yaml does not express them. With `use_native_cache` (the JAX
    loader's keyword) the converted weights come from `torch_cache/` where
    it is current, else they are converted and the cache written (see the
    module's docstring); without it nothing is read from or written to the
    cache. The engine's `load_report` says how long the load took, what it
    did with the cache and which models got random weights."""
    if cfg is None:
        cfg = model_config(model_dir, cfg_path)
    t0 = time.perf_counter()
    cached = read_cache(model_dir, cfg) if use_native_cache else None
    write_seconds, state, nbytes = 0.0, "not used", 0
    if cached is not None:
        params, aux, nbytes = cached
        state = "read"
    else:
        params, aux = convert_reference_checkpoints(model_dir, cfg)
        if use_native_cache and (params or aux):
            tw = time.perf_counter()
            try:
                nbytes = write_cache(model_dir, cfg, params, aux)
                state = "written"
            except OSError as e:
                print(f">> {Path(model_dir) / CACHE_DIR}: the converted-weights cache was not "
                      f"written ({e}); loading on without it", file=sys.stderr)
            write_seconds = time.perf_counter() - tw
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
    engine.load_report = LoadReport(str(model_dir), t1 - t0 - write_seconds,
                                    time.perf_counter() - t1, filled, state, nbytes,
                                    write_seconds)
    return engine
