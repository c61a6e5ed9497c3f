"""BigVGAN v1: the IndexTTS v1 vocoder, GPT latents in and an ECAPA speaker
embedding as conditioning.

Counterpart of indextts_tpu/models/bigvgan_v1.py (reference
indextts/BigVGAN/models.py:130-259): the GPT latents upsampled 4x in time
(linear, align_corners=False), conv_pre over gpt_dim channels, the ECAPA
embedding of the reference mel added after conv_pre (`cond_layer`) and
after each upsampling stage (`conds.{i}`), AMP resblocks with anti-aliased
SnakeBeta through kernel K2 (ops/snake.py), conv_post with a bias, tanh.
The stages are the BigVGAN v2 port's (models/bigvgan.py `_stage`): where a
stage's resblocks share their dilations (the release config's (1, 3, 5)
three times) they run in lockstep, one K2 launch over the three groups,
so a vocoder call launches K2 6 x 3 x 2 + 1 = 37 times. Float32 only, as
the JAX v1 engine runs it. Module names follow the reference state_dict
(`conv_pre`, `cond_layer`, `ups.{i}.0`, `conds.{i}`, `resblocks.{k}...`,
`activation_post.act.alpha`, `speaker_encoder.blocks.0.conv.conv`, ...).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from indextts_tpu_torch.models.bigvgan import Activation1d, AMPBlock1, BigVGAN
from indextts_tpu_torch.models.ecapa import ECAPA_TDNN


@dataclass(frozen=True)
class BigVGANv1Config:
    gpt_dim: int = 1280
    num_mels: int = 100
    upsample_rates: Tuple[int, ...] = (4, 4, 2, 2, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (8, 8, 4, 4, 4, 4)
    upsample_initial_channel: int = 1536
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5), (1, 3, 5), (1, 3, 5),
    )
    resblock: str = "1"
    activation: str = "snakebeta"
    snake_logscale: bool = True
    feat_upsample: bool = True
    cond_d_vector_in_each_upsampling_layer: bool = True
    speaker_embedding_dim: int = 512
    ecapa_channels: Tuple[int, ...] = (512, 512, 512, 512, 1536)
    ecapa_attention_channels: int = 128
    ecapa_res2net_scale: int = 8
    ecapa_se_channels: int = 128


class BigVGANv1(nn.Module):
    _stage = BigVGAN._stage
    _lockstep = BigVGAN._lockstep

    def __init__(self, cfg: BigVGANv1Config):
        super().__init__()
        self.cfg = c = cfg
        self.lockstep = all(tuple(d) == tuple(c.resblock_dilation_sizes[0])
                            for d in c.resblock_dilation_sizes)
        self.speaker_encoder = ECAPA_TDNN(
            c.num_mels, lin_neurons=c.speaker_embedding_dim, channels=c.ecapa_channels,
            attention_channels=c.ecapa_attention_channels,
            res2net_scale=c.ecapa_res2net_scale, se_channels=c.ecapa_se_channels)
        c0 = c.upsample_initial_channel
        self.conv_pre = nn.Conv1d(c.gpt_dim, c0, 7, padding=3)
        self.cond_layer = nn.Conv1d(c.speaker_embedding_dim, c0, 1)
        self.ups = nn.ModuleList()
        self.conds = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        ch = c0
        for i, (u, k) in enumerate(zip(c.upsample_rates, c.upsample_kernel_sizes)):
            cout = c0 // (2 ** (i + 1))
            # torch's padding trims (k - u) // 2 each side, as the JAX
            # module's slice of its VALID transposed convolution
            self.ups.append(nn.ModuleList(
                [nn.ConvTranspose1d(ch, cout, k, u, padding=(k - u) // 2)]))
            if c.cond_d_vector_in_each_upsampling_layer:
                self.conds.append(nn.Conv1d(c.speaker_embedding_dim, cout, 1))
            ch = cout
            for rk, rd in zip(c.resblock_kernel_sizes, c.resblock_dilation_sizes):
                self.resblocks.append(AMPBlock1(ch, rk, tuple(rd), c.snake_logscale))
        self.activation_post = Activation1d(ch, c.snake_logscale)
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3)

    def speaker_embedding(self, mel_ref):
        """mel_ref (B, Tm, num_mels) -> (B, speaker_embedding_dim, 1)."""
        return self.speaker_encoder(mel_ref).transpose(1, 2)

    def forward(self, latent, mel_ref):
        """latent (B, T, gpt_dim) GPT latents; mel_ref (B, Tm, num_mels), the
        reference mel of the speaker embedding. Returns the waveform (B,
        T * 4 * prod(upsample_rates)) in (-1, 1) (with feat_upsample)."""
        c = self.cfg
        spk = self.speaker_embedding(mel_ref)
        x = latent.float().transpose(1, 2)
        if c.feat_upsample:
            x = F.interpolate(x, scale_factor=4, mode="linear", align_corners=False)
        x = self.conv_pre(x) + self.cond_layer(spk)
        nk = len(c.resblock_kernel_sizes)
        for i, up in enumerate(self.ups):
            x = up[0](x)
            if c.cond_d_vector_in_each_upsampling_layer:
                x = x + self.conds[i](spk)
            x = self._stage(x, list(self.resblocks[i * nk:(i + 1) * nk]))
        return torch.tanh(self.conv_post(self.activation_post(x))[:, 0])
