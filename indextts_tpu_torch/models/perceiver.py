"""PerceiverResampler: fixed-length latent resampling of conditioning.

Counterpart of indextts_tpu/models/perceiver.py (2 blocks of
cross-attention with the latents included in the KV context, GEGLU
feed-forward, final RMSNorm). Module names follow the reference state_dict
(`layers.{i}.0.to_q`, `layers.{i}.1.0`, `norm.gamma`, ...).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from indextts_tpu_torch.models.layers import Linear

NEG_INF = -1e9


class PerceiverRMSNorm(nn.Module):
    """F.normalize(x, dim=-1) * sqrt(dim) * gamma."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = math.sqrt(dim)
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
        return x / torch.clamp(norm, min=1e-12) * self.scale * self.gamma


class PerceiverAttention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int = 64):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_q = Linear(dim, inner, bias=False)
        self.to_kv = Linear(dim, 2 * inner, bias=False)
        self.to_out = Linear(inner, dim, bias=False)

    def forward(self, latents, context, mask: Optional[torch.Tensor] = None):
        B, N, _ = latents.shape
        ctx = torch.cat([latents, context], dim=1)
        q = self.to_q(latents)
        k, v = self.to_kv(ctx).chunk(2, dim=-1)

        def heads_of(t):
            return t.reshape(B, -1, self.heads, self.dim_head).transpose(1, 2)

        q, k, v = heads_of(q), heads_of(k), heads_of(v)
        scores = torch.einsum("bhnd,bhsd->bhns", q, k) * self.dim_head ** -0.5
        if mask is not None:
            scores = scores.masked_fill(~mask[:, None, None, :], NEG_INF)
        attn = torch.softmax(scores.float(), dim=-1).to(v.dtype)
        out = torch.einsum("bhns,bhsd->bhnd", attn, v)
        return self.to_out(out.transpose(1, 2).reshape(B, N, -1))


class GEGLU(nn.Module):
    def forward(self, h):
        a, gate = h.chunk(2, dim=-1)
        return F.gelu(gate) * a


def feed_forward(dim: int, mult: int) -> nn.Sequential:
    inner = int(dim * mult * 2 / 3)
    return nn.Sequential(Linear(dim, 2 * inner), GEGLU(), Linear(inner, dim))


class PerceiverResampler(nn.Module):
    def __init__(self, dim: int, dim_context: int, num_latents: int = 32,
                 depth: int = 2, heads: int = 8, dim_head: int = 64,
                 ff_mult: int = 4):
        super().__init__()
        self.proj_context = (
            Linear(dim_context, dim) if dim_context != dim else None
        )
        self.latents = nn.Parameter(torch.empty(num_latents, dim).normal_(std=0.02))
        self.layers = nn.ModuleList(
            nn.ModuleList([PerceiverAttention(dim, heads, dim_head),
                           feed_forward(dim, ff_mult)])
            for _ in range(depth)
        )
        self.norm = PerceiverRMSNorm(dim)

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        """x (B, S, dim_context); mask (B, num_latents + S) True=valid.
        Returns (B, num_latents, dim)."""
        if self.proj_context is not None:
            x = self.proj_context(x)
        lat = self.latents[None].expand(x.shape[0], -1, -1)
        for attn, ff in self.layers:
            lat = attn(lat, x, mask) + lat
            lat = ff(lat) + lat
        return self.norm(lat)
