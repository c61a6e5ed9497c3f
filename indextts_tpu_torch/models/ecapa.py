"""ECAPA-TDNN speaker encoder (the IndexTTS v1 vocoder's speaker embedding).

Counterpart of indextts_tpu/models/ecapa.py (reference
indextts/BigVGAN/ECAPA_TDNN.py, after speechbrain): TDNN blocks whose
convolutions pad "same" by reflection, Res2Net blocks of hierarchical
residual chunks, squeeze-excitation, multi-layer feature aggregation,
attentive statistics pooling with global context, BatchNorm in eval mode
(eps 1e-5). Inference over the full length: no padding mask. Module names
follow the reference state_dict (speechbrain's wrappers hold the torch
layers at `.conv` and `.norm`: `blocks.0.conv.conv`, `blocks.0.norm.norm`,
`blocks.1.res2net_block.blocks.0.conv.conv`, `asp_bn.norm`, `fc.conv`).
Layout (B, C, T) inside; the entry takes (B, T, input_size) as the JAX
module does.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from indextts_tpu_torch.models.layers import reflect_pad


class SBConv1d(nn.Module):
    """speechbrain Conv1d with padding "same": reflect-pad d(k-1)/2 each
    side, then a VALID convolution (speechbrain nnet/CNN.py)."""

    def __init__(self, cin: int, cout: int, kernel: int = 1, dilation: int = 1):
        super().__init__()
        self.pad = dilation * (kernel - 1) // 2
        self.conv = nn.Conv1d(cin, cout, kernel, dilation=dilation)

    def forward(self, x):
        return self.conv(reflect_pad(x, self.pad) if self.pad else x)


class SBBatchNorm1d(nn.Module):
    """speechbrain BatchNorm1d: the torch layer at `.norm`."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = nn.BatchNorm1d(channels, eps=1e-5)

    def forward(self, x):
        return self.norm(x)


class TDNNBlock(nn.Module):
    """Convolution, ReLU, BatchNorm."""

    def __init__(self, cin: int, cout: int, kernel: int, dilation: int):
        super().__init__()
        self.conv = SBConv1d(cin, cout, kernel, dilation)
        self.norm = SBBatchNorm1d(cout)

    def forward(self, x):
        return self.norm(F.relu(self.conv(x)))


class Res2NetBlock(nn.Module):
    def __init__(self, channels: int, scale: int, kernel: int, dilation: int):
        super().__init__()
        self.scale = scale
        w = channels // scale
        self.blocks = nn.ModuleList(TDNNBlock(w, w, kernel, dilation) for _ in range(scale - 1))

    def forward(self, x):
        chunks = torch.chunk(x, self.scale, dim=1)
        ys = [chunks[0]]
        y = None
        for i, xi in enumerate(chunks[1:]):
            y = self.blocks[i](xi if i == 0 else xi + y)
            ys.append(y)
        return torch.cat(ys, dim=1)


class SEBlock(nn.Module):
    def __init__(self, channels: int, se_channels: int):
        super().__init__()
        self.conv1 = SBConv1d(channels, se_channels)
        self.conv2 = SBConv1d(se_channels, channels)

    def forward(self, x):
        s = x.mean(dim=2, keepdim=True)
        return torch.sigmoid(self.conv2(F.relu(self.conv1(s)))) * x


class SERes2NetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, scale: int, se_channels: int, kernel: int,
                 dilation: int):
        super().__init__()
        if cin != cout:
            self.shortcut = SBConv1d(cin, cout)
        self.tdnn1 = TDNNBlock(cin, cout, 1, 1)
        self.res2net_block = Res2NetBlock(cout, scale, kernel, dilation)
        self.tdnn2 = TDNNBlock(cout, cout, 1, 1)
        self.se_block = SEBlock(cout, se_channels)

    def forward(self, x):
        residual = self.shortcut(x) if hasattr(self, "shortcut") else x
        h = self.tdnn2(self.res2net_block(self.tdnn1(x)))
        return self.se_block(h) + residual


class AttentiveStatsPooling(nn.Module):
    """Attention over time with the utterance's mean and std as context;
    returns the attended mean and std (B, 2C). eps 1e-12 inside the max
    before each square root."""

    def __init__(self, channels: int, attention_channels: int = 128, eps: float = 1e-12):
        super().__init__()
        self.eps = eps
        self.tdnn = TDNNBlock(channels * 3, attention_channels, 1, 1)
        self.conv = SBConv1d(attention_channels, channels)

    def forward(self, x):
        mean = x.mean(dim=2, keepdim=True)
        std = torch.sqrt(torch.clamp(((x - mean) ** 2).mean(dim=2, keepdim=True), min=self.eps))
        ctx = torch.cat([x, mean.expand_as(x), std.expand_as(x)], dim=1)
        w = torch.softmax(self.conv(torch.tanh(self.tdnn(ctx))), dim=2)
        mean2 = (w * x).sum(dim=2)
        std2 = torch.sqrt(torch.clamp((w * (x - mean2[:, :, None]) ** 2).sum(dim=2),
                                      min=self.eps))
        return torch.cat([mean2, std2], dim=1)


class ECAPA_TDNN(nn.Module):
    def __init__(self, input_size: int, lin_neurons: int = 192,
                 channels: Sequence[int] = (512, 512, 512, 512, 1536),
                 kernel_sizes: Sequence[int] = (5, 3, 3, 3, 1),
                 dilations: Sequence[int] = (1, 2, 3, 4, 1),
                 attention_channels: int = 128, res2net_scale: int = 8,
                 se_channels: int = 128):
        super().__init__()
        ch = tuple(channels)
        self.blocks = nn.ModuleList([TDNNBlock(input_size, ch[0], kernel_sizes[0],
                                               dilations[0])])
        for i in range(1, len(ch) - 1):
            self.blocks.append(SERes2NetBlock(ch[i - 1], ch[i], res2net_scale, se_channels,
                                              kernel_sizes[i], dilations[i]))
        self.mfa = TDNNBlock(sum(ch[1:-1]), ch[-1], kernel_sizes[-1], dilations[-1])
        self.asp = AttentiveStatsPooling(ch[-1], attention_channels)
        self.asp_bn = SBBatchNorm1d(ch[-1] * 2)
        self.fc = SBConv1d(ch[-1] * 2, lin_neurons)

    def forward(self, x):
        """x (B, T, input_size) -> (B, 1, lin_neurons)."""
        h = self.blocks[0](x.transpose(1, 2))
        feats = []
        for blk in self.blocks[1:]:
            h = blk(h)
            feats.append(h)
        h = self.mfa(torch.cat(feats, dim=1))
        pooled = self.asp_bn(self.asp(h))
        return self.fc(pooled[:, :, None]).transpose(1, 2)
