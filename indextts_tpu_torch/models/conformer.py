"""Wenet-style Conformer encoder (speaker / emotion conditioning).

Counterpart of indextts_tpu/models/conformer.py: Conv2dSubsampling2 input,
rel-pos multi-head attention without the rel_shift term, GLU/depthwise conv
module (kernel 15), SiLU FFN, normalize_before, macaron off. Module names
follow the reference state_dict (`embed.conv.0`, `encoders.{i}.self_attn`,
...). Layout (B, T, C).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from indextts_tpu_torch.config import ConditionModuleConfig
from indextts_tpu_torch.models.layers import (ChannelsLastConv1d, LayerNorm, Linear, Pointwise,
                                              dtype_of)

NEG_INF = -1e9


def sinusoid_position_encoding(max_len: int, d_model: int) -> np.ndarray:
    """ESPnet PositionalEncoding table (conformer/embedding.py:46-55)."""
    pe = np.zeros((max_len, d_model), dtype=np.float64)
    position = np.arange(max_len)[:, None].astype(np.float64)
    div_term = np.exp(
        np.arange(0, d_model, 2).astype(np.float64) * -(math.log(10000.0) / d_model)
    )
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe.astype(np.float32)


class Conv2dSubsampling2(nn.Module):
    """Conv2d(1->odim, 3x3, stride 2) + ReLU + Linear."""

    def __init__(self, idim: int, odim: int):
        super().__init__()
        self.conv = nn.Sequential(nn.Conv2d(1, odim, 3, 2))
        self.out = nn.Sequential(Linear(odim * ((idim - 1) // 2), odim))

    def forward(self, x):
        # (B, T, F) -> (B, C, T', F') -> (B, T', C * F') channel-major
        h = F.relu(self.conv(x[:, None]))
        B, C, Tp, Fp = h.shape
        return self.out(h.transpose(1, 2).reshape(B, Tp, C * Fp))


class RelPositionAttention(nn.Module):
    def __init__(self, heads: int, dim: int):
        super().__init__()
        self.h, self.d_k = heads, dim // heads
        self.linear_q = Linear(dim, dim)
        self.linear_k = Linear(dim, dim)
        self.linear_v = Linear(dim, dim)
        self.linear_out = Linear(dim, dim)
        self.linear_pos = Linear(dim, dim, bias=False)
        self.pos_bias_u = nn.Parameter(torch.zeros(heads, self.d_k))
        self.pos_bias_v = nn.Parameter(torch.zeros(heads, self.d_k))

    def forward(self, x, pos_emb, mask):
        B, T, D = x.shape
        H, Dk = self.h, self.d_k
        q = self.linear_q(x).reshape(B, T, H, Dk)
        k = self.linear_k(x).reshape(B, T, H, Dk).transpose(1, 2)
        v = self.linear_v(x).reshape(B, T, H, Dk).transpose(1, 2)
        p = self.linear_pos(pos_emb).reshape(1, -1, H, Dk).transpose(1, 2)
        q_u = (q + self.pos_bias_u).transpose(1, 2)
        q_v = (q + self.pos_bias_v).transpose(1, 2)
        ac = torch.einsum("bhtd,bhsd->bhts", q_u, k)
        bd = torch.einsum("bhtd,xhsd->bhts", q_v, p)
        scores = (ac + bd) / math.sqrt(Dk)
        m = mask[:, None, None, :]
        scores = scores.masked_fill(~m, NEG_INF)
        attn = torch.softmax(scores.float(), dim=-1).to(v.dtype)
        attn = attn.masked_fill(~m, 0.0)
        ctx = torch.einsum("bhts,bhsd->bhtd", attn, v)
        return self.linear_out(ctx.transpose(1, 2).reshape(B, T, D))


class ConvolutionModule(nn.Module):
    def __init__(self, channels: int, kernel_size: int):
        super().__init__()
        self.pointwise_conv1 = Pointwise(channels, 2 * channels)
        self.depthwise_conv = ChannelsLastConv1d(
            channels, channels, kernel_size, padding=(kernel_size - 1) // 2,
            groups=channels,
        )
        self.norm = LayerNorm(channels, eps=1e-5)
        self.pointwise_conv2 = Pointwise(channels, channels)

    def forward(self, x, pad_mask):
        x = x.masked_fill(~pad_mask[..., None], 0.0)
        a, b = self.pointwise_conv1(x).chunk(2, dim=-1)
        h = a * torch.sigmoid(b)
        h = F.silu(self.norm(self.depthwise_conv(h)))
        h = self.pointwise_conv2(h)
        return h.masked_fill(~pad_mask[..., None], 0.0)


class ConformerFFN(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.w_1 = Linear(dim, hidden)
        self.w_2 = Linear(hidden, dim)

    def forward(self, x):
        return self.w_2(F.silu(self.w_1(x)))


class ConformerLayer(nn.Module):
    def __init__(self, cfg: ConditionModuleConfig):
        super().__init__()
        d = cfg.output_size
        self.self_attn = RelPositionAttention(cfg.attention_heads, d)
        self.conv_module = ConvolutionModule(d, cfg.cnn_module_kernel)
        self.feed_forward = ConformerFFN(d, cfg.linear_units)
        self.norm_mha = LayerNorm(d, eps=1e-5)
        self.norm_conv = LayerNorm(d, eps=1e-5)
        self.norm_ff = LayerNorm(d, eps=1e-5)
        self.norm_final = LayerNorm(d, eps=1e-5)

    def forward(self, x, pos_emb, mask):
        x = x + self.self_attn(self.norm_mha(x), pos_emb, mask)
        x = x + self.conv_module(self.norm_conv(x), mask)
        x = x + self.feed_forward(self.norm_ff(x))
        return self.norm_final(x)


class ConformerEncoder(nn.Module):
    """forward(xs (B,T,input_size), xs_lens (B,)) -> (encoded (B,T',D),
    mask (B,T') True=valid)."""

    def __init__(self, cfg: ConditionModuleConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = Conv2dSubsampling2(cfg.input_size, cfg.output_size)
        self.encoders = nn.ModuleList(ConformerLayer(cfg) for _ in range(cfg.num_blocks))
        self.after_norm = LayerNorm(cfg.output_size, eps=1e-5)

    def forward(self, xs, xs_lens):
        """Computes in its parameters' dtype, as the JAX encoder in its
        `dtype`: the input is cast to it."""
        xs = xs.to(dtype_of(self))
        T = xs.shape[1]
        mask = torch.arange(T, device=xs.device)[None, :] < xs_lens[:, None]
        xs = self.embed(xs)
        Tp = xs.shape[1]
        mask = mask[:, 2::2][:, :Tp]
        xs = xs * math.sqrt(self.cfg.output_size)
        pe = sinusoid_position_encoding(max(5000, Tp), self.cfg.output_size)
        pos_emb = torch.from_numpy(pe[None, :Tp]).to(xs.device, xs.dtype)
        for layer in self.encoders:
            xs = layer(xs, pos_emb, mask)
        return self.after_norm(xs), mask
