"""BigVGAN v2 vocoder.

Counterpart of indextts_tpu/models/bigvgan.py (reference bigvgan.py:243-400,
`nvidia/bigvgan_v2_22khz_80band_256x` hyperparameters): AMPBlock1 resblocks,
SnakeBeta with log-scale alphas through kernel K2 (ops/snake.py), no
bias/tanh at the end (clip instead). Layout (B, C, T). Where the parallel
resblocks of a stage share their dilations (the release config) they run
in lockstep: one wide anti-aliased activation over the channel-
concatenated groups instead of three (channels never mix, so the math is
that of three calls). Resblocks with differing dilations run one at a
time, each with its own activations, and are averaged, as in the JAX
BigVGAN (indextts_tpu/models/bigvgan.py:176-181). Module names
follow the reference state_dict (`ups.{i}.0`, `resblocks.{k}.convs1.{m}`,
`resblocks.{k}.activations.{2m}.act.alpha`, ...).

It computes in its parameters' dtype, as the JAX BigVGAN in its `dtype`:
the mel is cast to it, and a bfloat16 model's waveform stays bfloat16 to
the PCM16 clip (`to_pcm16`). K2 takes bfloat16 in and out with float32
arithmetic inside (ops/snake.py).
"""

from __future__ import annotations

import torch
from torch import nn

from indextts_tpu_torch.config import BigVGANConfig
from indextts_tpu_torch.ops.snake import anti_alias_snake


class SnakeBeta(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(channels))
        self.beta = nn.Parameter(torch.zeros(channels))


class Activation1d(nn.Module):
    """2x up -> SnakeBeta -> 2x down, fused in kernel K2."""

    def __init__(self, channels: int, logscale: bool):
        super().__init__()
        self.logscale = logscale
        self.act = SnakeBeta(channels)

    def forward(self, x):
        return anti_alias_snake(x, self.act.alpha, self.act.beta, self.logscale)


class AMPBlock1(nn.Module):
    """Parameters of one resblock; BigVGAN._stage runs a stage's resblocks
    together."""

    def __init__(self, channels: int, kernel_size: int, dilations, logscale: bool):
        super().__init__()
        k = kernel_size
        self.convs1 = nn.ModuleList(
            nn.Conv1d(channels, channels, k, dilation=d, padding=(k * d - d) // 2)
            for d in dilations
        )
        self.convs2 = nn.ModuleList(
            nn.Conv1d(channels, channels, k, padding=(k - 1) // 2) for _ in dilations
        )
        # reference order: [a1_0, a2_0, a1_1, a2_1, ...]
        self.activations = nn.ModuleList(
            Activation1d(channels, logscale) for _ in range(2 * len(dilations))
        )


class BigVGAN(nn.Module):
    def __init__(self, cfg: BigVGANConfig):
        super().__init__()
        self.cfg = c = cfg
        self.lockstep = all(tuple(d) == tuple(c.resblock_dilation_sizes[0])
                            for d in c.resblock_dilation_sizes)
        self.conv_pre = nn.Conv1d(c.num_mels, c.upsample_initial_channel, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        ch = c.upsample_initial_channel
        for i, (u, k) in enumerate(zip(c.upsample_rates, c.upsample_kernel_sizes)):
            cout = c.upsample_initial_channel // (2 ** (i + 1))
            self.ups.append(nn.ModuleList(
                [nn.ConvTranspose1d(ch, cout, k, u, padding=(k - u) // 2)]))
            ch = cout
            for rk, rd in zip(c.resblock_kernel_sizes, c.resblock_dilation_sizes):
                self.resblocks.append(AMPBlock1(ch, rk, tuple(rd), c.snake_logscale))
        self.activation_post = Activation1d(ch, c.snake_logscale)
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3, bias=c.use_bias_at_final)

    def _stage(self, x, rs):
        """The mean of the stage's resblocks over x: in lockstep where they
        share their dilations, else each resblock alone."""
        if not self.lockstep:
            return sum(self._lockstep(x, [r]) for r in rs) / len(rs)
        return self._lockstep(x, rs)

    def _lockstep(self, x, rs):
        """The mean of resblocks `rs`, of one dilation sequence, over x, run
        in lockstep."""
        G, ch = len(rs), x.shape[1]
        X = torch.cat([x] * G, dim=1)
        for j in range(len(rs[0].convs1)):
            acts1 = [r.activations[2 * j].act for r in rs]
            acts2 = [r.activations[2 * j + 1].act for r in rs]
            ls = self.cfg.snake_logscale
            xt = anti_alias_snake(X, torch.cat([a.alpha for a in acts1]),
                                  torch.cat([a.beta for a in acts1]), ls)
            xt = torch.cat([r.convs1[j](xt[:, g * ch:(g + 1) * ch])
                            for g, r in enumerate(rs)], dim=1)
            xt = anti_alias_snake(xt, torch.cat([a.alpha for a in acts2]),
                                  torch.cat([a.beta for a in acts2]), ls)
            xt = torch.cat([r.convs2[j](xt[:, g * ch:(g + 1) * ch])
                            for g, r in enumerate(rs)], dim=1)
            X = X + xt
        return sum(X[:, g * ch:(g + 1) * ch] for g in range(G)) / G

    def forward(self, mel):
        """mel (B, n_mels, T) -> waveform (B, T * 256) in [-1, 1]."""
        c = self.cfg
        nk = len(c.resblock_kernel_sizes)
        x = self.conv_pre(mel.to(self.conv_pre.weight.dtype))
        for i in range(len(self.ups)):
            x = self._stage(self.ups[i][0](x), list(self.resblocks[i * nk:(i + 1) * nk]))
        x = self.conv_post(self.activation_post(x))[:, 0]
        return torch.tanh(x) if c.use_tanh_at_final else torch.clamp(x, -1.0, 1.0)


def to_pcm16(wav: torch.Tensor) -> torch.Tensor:
    """On-device PCM16 (reference: clamp(32767*wav).int16, infer_v2.py:866),
    computed in the waveform's dtype as the JAX engine's `_vocode_pcm16`.
    In bfloat16 the bounds round to +-32768; the conversion saturates at
    int16's range, as XLA's does, where a plain cast would wrap 32768 to
    -32768."""
    y = torch.clamp(wav * 32767.0, -32767.0, 32767.0)
    return y.float().clamp(-32768.0, 32767.0).to(torch.int16)
