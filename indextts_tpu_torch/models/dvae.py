"""DiscreteVAE mel tokenizer, encoder side (the IndexTTS v1 mel codes).

Counterpart of indextts_tpu/models/dvae.py (reference
indextts/vqvae/xtts_dvae.py:201-395, the 1-d variant over mels): strided
convolutions with ReLU, residual blocks, a pointwise projection to the
codebook's width, and the nearest codebook entry (the Quantize module's
argmin at inference). Not on the synthesis path: it defines the codes the
v1 GPT was trained on. Module names follow the reference state_dict
(`encoder.{i}.0`, `encoder.{i}.net.{0,2,4}`, `encoder.{n}`,
`codebook.embed`). The entries take (B, T, channels), as the JAX module.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn


@dataclass(frozen=True)
class DVAEConfig:
    channels: int = 100  # mel bins
    num_tokens: int = 8192
    codebook_dim: int = 512
    hidden_dim: int = 512
    num_layers: int = 2
    num_resnet_blocks: int = 3
    kernel_size: int = 3
    stride: int = 2


class ResBlock(nn.Module):
    def __init__(self, chan: int):
        super().__init__()
        self.net = nn.Sequential(nn.Conv1d(chan, chan, 3, padding=1), nn.ReLU(),
                                 nn.Conv1d(chan, chan, 3, padding=1), nn.ReLU(),
                                 nn.Conv1d(chan, chan, 1))

    def forward(self, x):
        return self.net(x) + x


class Codebook(nn.Module):
    def __init__(self, dim: int, n: int):
        super().__init__()
        self.embed = nn.Parameter(torch.randn(dim, n))


class DVAE(nn.Module):
    def __init__(self, cfg: DVAEConfig):
        super().__init__()
        self.cfg = c = cfg
        pad = (c.kernel_size - 1) // 2
        layers, cin = [], c.channels
        for i in range(c.num_layers):
            ch = c.hidden_dim * (2 ** i)
            layers.append(nn.Sequential(
                nn.Conv1d(cin, ch, c.kernel_size, stride=c.stride, padding=pad), nn.ReLU()))
            cin = ch
        layers += [ResBlock(cin) for _ in range(c.num_resnet_blocks)]
        layers.append(nn.Conv1d(cin, c.codebook_dim, 1))
        self.encoder = nn.ModuleList(layers)
        self.codebook = Codebook(c.codebook_dim, c.num_tokens)

    def encode_latents(self, mel):
        """(B, T, channels) -> (B, T // stride^num_layers, codebook_dim)."""
        h = mel.transpose(1, 2)
        for layer in self.encoder:
            h = layer(h)
        return h.transpose(1, 2)

    def get_codebook_indices(self, mel):
        """(B, T, channels) mel -> (B, T') code ids: the nearest codebook
        column in squared distance, |z|^2 - 2 z.e + |e|^2, the first on a
        tie."""
        z = self.encode_latents(mel)
        flat = z.reshape(-1, z.shape[-1])
        e = self.codebook.embed
        dist = ((flat * flat).sum(dim=1, keepdim=True) - 2.0 * flat @ e
                + (e * e).sum(dim=0)[None])
        return torch.argmin(dist, dim=1).reshape(z.shape[:-1])

    def embed_code(self, ids):
        return self.codebook.embed.t()[ids]
