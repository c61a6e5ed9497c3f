"""Shared set-up for the tests that hold the PyTorch port (indextts_tpu_torch)
against the JAX package at the tiny size of tests/test_engine_e2e.py.

Both packages get the same numpy parameters: the JAX `random_params` tree
with its U[0.01, 0.05) fill mapped affinely, leaves of rank >= 2 onto a
zero-mean fan-in-scaled uniform and rank-1 leaves (biases, norm scales,
BatchNorm statistics) onto [0.9, 1.1), and the vocoder's conv_post scaled
by 1e-3. The all-positive fill saturates the tiny vocoder at the clip,
drives CAMPPlus to ~1e11 and lets the output biases decide every greedy
token, which would make those comparisons vacuous.
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path

import jax
import numpy as np
import torch

from indextts_tpu.runtime.engine import random_params as jax_random_params
from indextts_tpu_torch import config as port_config_mod
from test_engine_e2e import tiny_config

torch.set_num_threads(2)


def to_port_config(obj):
    """A JAX-package config dataclass tree -> the port's copy of it."""
    if dataclasses.is_dataclass(obj):
        cls = getattr(port_config_mod, type(obj).__name__)
        return cls(**{f.name: to_port_config(getattr(obj, f.name))
                      for f in dataclasses.fields(obj) if f.init})
    return obj


def parity_config(**runtime):
    """tiny_config with greedy single-beam decode (and `runtime` overrides)."""
    cfg = tiny_config()
    rt = dict(do_sample=False, num_beams=1, max_mel_tokens=24)
    rt.update(runtime)
    return dataclasses.replace(cfg, runtime=dataclasses.replace(cfg.runtime, **rt))


def parity_params(cfg, seed: int = 0):
    """JAX random_params, remapped: rank >= 2 leaves to U(-a, a) with
    a = sqrt(3 / fan_in), rank-1 leaves to U[0.9, 1.1)."""

    def remap(x):
        x = np.asarray(x)
        u = (x - 0.03) / 0.02  # U[-1, 1)
        if x.ndim < 2:
            return (1.0 + 0.1 * u).astype(x.dtype)
        fan_in = int(np.prod(x.shape[:-1]))
        return (u * np.sqrt(3.0 / fan_in)).astype(x.dtype)

    params = jax.tree_util.tree_map(remap, jax_random_params(cfg, seed=seed))
    # the snake's sin^2 / beta term adds a positive offset at every
    # activation; scaling the vocoder's last conv keeps the waveform off the
    # clip, where a comparison would say nothing
    params["bigvgan"]["conv_post"] = {
        k: v * 1e-3 for k, v in params["bigvgan"]["conv_post"].items()}
    return params


def t(a, dtype=None):
    """numpy -> torch (CPU), contiguous."""
    x = torch.from_numpy(np.array(a))
    return x if dtype is None else x.to(dtype)


def n(x):
    """torch or jax -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def speech_like(rng, seconds: float, sr: int) -> np.ndarray:
    """A seeded voiced-speech-like prompt: harmonic tone, syllable-rate
    envelope, a little noise."""
    tt = np.arange(int(seconds * sr)) / sr
    phase = 2 * np.pi * np.cumsum(120 + 20 * np.sin(2 * np.pi * 0.7 * tt)) / sr
    x = sum(np.sin(h * phase) / h for h in range(1, 6))
    x = x * (0.5 + 0.5 * np.sin(2 * np.pi * 4 * tt) ** 2)
    x = x + 0.01 * rng.standard_normal(tt.shape)
    return (0.3 * x / np.abs(x).max()).astype(np.float32)


# a minimal SentencePiece model protobuf (the bytes that
# tests/test_checkpoint_dir_rehearsal.py writes): enough vocabulary to
# tokenize "hello. hello" with ids < 50
def _varint(n):
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _piece_msg(piece, score, ptype=1):
    pb = piece.encode("utf-8")
    body = b"\x0a" + _varint(len(pb)) + pb
    body += b"\x15" + struct.pack("<f", score)
    body += b"\x18" + _varint(ptype)
    return b"\x0a" + _varint(len(body)) + body


PIECES = [
    ("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3),
    ("▁", -2.0, 1), ("h", -3.0, 1), ("e", -3.1, 1), ("l", -3.2, 1),
    ("o", -3.3, 1), ("he", -1.0, 1), ("ll", -1.2, 1), ("hello", -0.5, 1),
    ("▁hello", -0.4, 1), ("▁.", -1.5, 1), (".", -4.0, 1), (",", -4.1, 1),
]
BPE_MODEL = b"".join(_piece_msg(p, sc, t) for p, sc, t in PIECES)


def write_checkpoint_dir(d, cfg, jp, seed: int = 3, extra_w2v_layers: int = 2):
    """A reference-layout checkpoint directory at `d` from the JAX tree `jp`
    (config `cfg`), through weights.from_jax_params and chip_smoke.py's
    writer: a seeded text_head in gpt.pth (the JAX tree has none: its
    inference path never calls it), seeded banks and stats,
    w2v-BERT with `extra_w2v_layers` layers past tap_layer, and bpe.model.
    Returns (the port's state dicts, {"semantic_stats", "emo_matrix",
    "spk_matrix"} as numpy)."""
    import chip_smoke
    from indextts_tpu_torch.weights import from_jax_params

    sds = from_jax_params(jp, to_port_config(cfg))
    rng = np.random.default_rng(seed)
    vocab = cfg.gpt.number_text_tokens + 1
    text_head = (t(rng.standard_normal((vocab, cfg.gpt.model_dim)).astype(np.float32)),
                 t(rng.standard_normal(vocab).astype(np.float32)))
    rows, hs = sum(cfg.emo_num), cfg.w2vbert.hidden_size
    aux = {"semantic_stats": (rng.standard_normal(hs).astype(np.float32),
                              rng.uniform(0.5, 2.0, hs).astype(np.float32)),
           "emo_matrix": rng.standard_normal((rows, cfg.gpt.model_dim)).astype(np.float32),
           "spk_matrix": rng.standard_normal((rows, 192)).astype(np.float32)}
    chip_smoke.write_reference_dir(
        str(d), sds, text_head, tuple(t(a) for a in aux["semantic_stats"]),
        t(aux["emo_matrix"]), t(aux["spk_matrix"]),
        cfg.w2vbert.tap_layer + extra_w2v_layers, seed=seed)
    (Path(d) / "bpe.model").write_bytes(BPE_MODEL)
    return sds, aux
