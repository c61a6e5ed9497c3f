"""w2v-BERT 2.0 conformer encoder (semantic feature extractor).

Counterpart of indextts_tpu/models/w2vbert.py (transformers
Wav2Vec2BertModel, facebook/w2v-bert-2.0): relative_key position bias,
causal depthwise conv k=31, swish FFNs. Only the first `tap_layer` layers run:
the engine taps hidden_states[17], the input of layer 17. Module names follow
the HF state_dict (`feature_projection.projection`, `encoder.layers.{i}...`).
Layout (B, T, C). Its layers compute in the promoted dtype of input and
weights (models/layers.py), as the JAX encoder's: under a bfloat16
cond_dtype the weights are stored in bfloat16 and the float32 features
carry the computation in float32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from indextts_tpu_torch.config import W2VBertConfig
from indextts_tpu_torch.models.layers import Conv1d, LayerNorm, Linear, Pointwise, promoted

NEG_INF = -1e9


class W2VFeedForward(nn.Module):
    def __init__(self, cfg: W2VBertConfig):
        super().__init__()
        self.intermediate_dense = Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output_dense = Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.output_dense(F.silu(self.intermediate_dense(x)))


class W2VSelfAttention(nn.Module):
    def __init__(self, cfg: W2VBertConfig):
        super().__init__()
        self.cfg = cfg
        D = cfg.hidden_size
        self.linear_q = Linear(D, D)
        self.linear_k = Linear(D, D)
        self.linear_v = Linear(D, D)
        self.linear_out = Linear(D, D)
        if cfg.position_embeddings_type == "relative_key":
            self.distance_embedding = nn.Embedding(
                cfg.left_max_position_embeddings + cfg.right_max_position_embeddings + 1,
                D // cfg.num_attention_heads,
            )

    def forward(self, x, attn_bias):
        c = self.cfg
        B, T, D = x.shape
        H = c.num_attention_heads
        Dh = D // H

        def heads(t):
            return t.reshape(B, T, H, Dh).transpose(1, 2)

        q, k, v = heads(self.linear_q(x)), heads(self.linear_k(x)), heads(self.linear_v(x))
        scores = torch.einsum("bhtd,bhsd->bhts", q, k) / math.sqrt(Dh)
        if c.position_embeddings_type == "relative_key":
            L, R = c.left_max_position_embeddings, c.right_max_position_embeddings
            ar = torch.arange(T, device=x.device)
            dist = torch.clamp(ar[None, :] - ar[:, None], -L, R) + L
            pos_emb = self.distance_embedding(dist)  # (T, T, Dh)
            pos_emb = pos_emb.to(promoted(q, pos_emb))
            rel = torch.einsum("bhld,lrd->bhlr", q, pos_emb)
            scores = scores + rel / math.sqrt(Dh)
        if attn_bias is not None:
            scores = scores + attn_bias
        probs = torch.softmax(scores.float(), dim=-1).to(v.dtype)
        ctx = torch.einsum("bhts,bhsd->bhtd", probs, v)
        return self.linear_out(ctx.transpose(1, 2).reshape(B, T, D))


class W2VConvModule(nn.Module):
    def __init__(self, cfg: W2VBertConfig):
        super().__init__()
        D, k = cfg.hidden_size, cfg.conv_depthwise_kernel_size
        self.k = k
        self.layer_norm = LayerNorm(D, eps=cfg.layer_norm_eps)
        self.pointwise_conv1 = Pointwise(D, 2 * D, bias=False)
        self.depthwise_conv = Conv1d(D, D, k, groups=D, bias=False)
        self.depthwise_layer_norm = LayerNorm(D, eps=cfg.layer_norm_eps)
        self.pointwise_conv2 = Pointwise(D, D, bias=False)

    def forward(self, x, pad_mask: Optional[torch.Tensor]):
        h = self.layer_norm(x)
        if pad_mask is not None:
            h = h.masked_fill(~pad_mask[..., None], 0.0)
        a, b = self.pointwise_conv1(h).chunk(2, dim=-1)
        h = (a * torch.sigmoid(b)).transpose(1, 2)
        h = self.depthwise_conv(F.pad(h, (self.k - 1, 0))).transpose(1, 2)
        return self.pointwise_conv2(F.silu(self.depthwise_layer_norm(h)))


class W2VEncoderLayer(nn.Module):
    def __init__(self, cfg: W2VBertConfig):
        super().__init__()
        D, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.ffn1_layer_norm = LayerNorm(D, eps=eps)
        self.ffn1 = W2VFeedForward(cfg)
        self.self_attn_layer_norm = LayerNorm(D, eps=eps)
        self.self_attn = W2VSelfAttention(cfg)
        self.conv_module = W2VConvModule(cfg)
        self.ffn2_layer_norm = LayerNorm(D, eps=eps)
        self.ffn2 = W2VFeedForward(cfg)
        self.final_layer_norm = LayerNorm(D, eps=eps)

    def forward(self, x, attn_bias, pad_mask):
        x = x + 0.5 * self.ffn1(self.ffn1_layer_norm(x))
        x = x + self.self_attn(self.self_attn_layer_norm(x), attn_bias)
        x = x + self.conv_module(x, pad_mask)
        x = x + 0.5 * self.ffn2(self.ffn2_layer_norm(x))
        return self.final_layer_norm(x)


class _FeatureProjection(nn.Module):
    def __init__(self, cfg: W2VBertConfig):
        super().__init__()
        self.layer_norm = LayerNorm(cfg.feature_projection_input_dim,
                                       eps=cfg.layer_norm_eps)
        self.projection = Linear(cfg.feature_projection_input_dim, cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: W2VBertConfig):
        super().__init__()
        self.layers = nn.ModuleList(W2VEncoderLayer(cfg) for _ in range(cfg.tap_layer))


class W2VBertEncoder(nn.Module):
    """forward(features (B, T, 160), attention_mask (B, T) or None) ->
    (B, T, hidden): the reference's hidden_states[tap_layer]."""

    def __init__(self, cfg: W2VBertConfig):
        super().__init__()
        self.feature_projection = _FeatureProjection(cfg)
        self.encoder = _Encoder(cfg)

    def forward(self, x, attention_mask: Optional[torch.Tensor] = None):
        fp = self.feature_projection
        h = fp.projection(fp.layer_norm(x))
        if attention_mask is not None:
            pad_mask = attention_mask.bool()
            h = h.masked_fill(~pad_mask[..., None], 0.0)
            attn_bias = torch.where(pad_mask[:, None, None, :],
                                    torch.zeros((), device=h.device),
                                    torch.full((), NEG_INF, device=h.device))
        else:
            pad_mask = attn_bias = None
        for layer in self.encoder.layers:
            h = layer(h, attn_bias, pad_mask)
        return h
