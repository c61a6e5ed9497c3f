"""Semantic->mel stage: length regulator + DiT flow-matching estimator.

Counterpart of indextts_tpu/models/s2mel.py (reference
s2mel/modules/{length_regulator,diffusion_transformer,wavenet,commons}.py and
gpt_fast/model.py). The DiT's attention goes through kernel K3
(ops/dit_attention.py). Kept from the JAX package: the fp32 time embedding,
interleaved-pair RoPE, AdaLN RMSNorm, SwiGLU, u-vit skips, and WaveNet's
reflect padding at each row's VALID boundary (the reference's SConv1d reflect
pads and silently drops its `padding=` kwarg, encodec.py:196-228). Module
names follow the reference state_dict (`cfm.estimator.transformer.layers.{i}
.attention.wqkv`, `length_regulator.model.{3i}`, `gpt_layer.{i}`, ...).
Layout (B, T, C) except where noted.

Its layers compute in the promoted dtype of input and weights
(models/layers.py), as the JAX modules without a `dtype`: stored in
bfloat16 (runtime.s2mel_dtype) and fed bfloat16 by the engine and the CFM
solver, the DiT and regulator compute in bfloat16, with float32 islands as
in the JAX model: the time embeddings (cast to the stack's dtype after),
the RMSNorm, LayerNorm and GroupNorm statistics and the attention softmax
(K3's bfloat16 instantiation on the card). The speaker prompt's float32
condition goes through the regulator in float32 over the bfloat16 weights.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from indextts_tpu_torch.config import (
    DiTConfig,
    LengthRegulatorConfig,
    S2MelConfig,
    WaveNetConfig,
)
from indextts_tpu_torch.models.layers import Conv1d, LayerNorm, Linear, Pointwise
from indextts_tpu_torch.ops.dit_attention import dit_attention


class TimestepEmbedder(nn.Module):
    """Sinusoidal time features (scale 1000, max_period 10000) in fp32 ->
    Linear -> SiLU -> Linear."""

    def __init__(self, hidden: int, freq_dim: int = 256):
        super().__init__()
        self.freq_dim = freq_dim
        self.mlp = nn.Sequential(Linear(freq_dim, hidden), nn.SiLU(),
                                 Linear(hidden, hidden))

    def forward(self, t):
        half = self.freq_dim // 2
        freqs = torch.exp(
            -math.log(10000.0)
            * torch.arange(half, dtype=torch.float32, device=t.device) / half
        )
        args = 1000.0 * t[:, None].float() * freqs[None]
        return self.mlp(torch.cat([torch.cos(args), torch.sin(args)], dim=-1))


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        out = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + self.eps)
        return out.to(x.dtype) * self.weight


class AdaptiveRMSNorm(nn.Module):
    """gpt_fast AdaptiveLayerNorm around RMSNorm: weight * norm(x) + bias with
    (weight, bias) projected from the time embedding."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.norm = RMSNorm(dim, eps)
        self.project_layer = Linear(dim, 2 * dim)

    def forward(self, x, c):
        weight, bias = self.project_layer(c).chunk(2, dim=-1)
        return weight * self.norm(x) + bias


def precompute_rope(n: int, head_dim: int, base: float) -> np.ndarray:
    """gpt_fast precompute_freqs_cis rows [0, n): (n, hd/2, 2) cos/sin. Row
    i depends on i alone, so a longer table's first n rows are these."""
    freqs = 1.0 / (
        base ** (np.arange(0, head_dim, 2)[: head_dim // 2].astype(np.float64) / head_dim)
    )
    ang = np.outer(np.arange(n, dtype=np.float64), freqs)
    return np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)


def apply_rotary(x, rope):
    """x (B, T, H, D); rope (T, D/2, 2): interleaved-pair rotation."""
    xs = x.reshape(*x.shape[:-1], -1, 2)
    cos = rope[None, :, None, :, 0]
    sin = rope[None, :, None, :, 1]
    out = torch.stack(
        [xs[..., 0] * cos - xs[..., 1] * sin, xs[..., 1] * cos + xs[..., 0] * sin],
        dim=-1,
    )
    # the float32 table promotes a bfloat16 x; the rotation comes back in x's dtype
    return out.reshape(x.shape).to(x.dtype)


class DiTAttention(nn.Module):
    """Fused wqkv, RoPE, then kernel K3 over the key-padding mask."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.h, self.dh = cfg.num_heads, cfg.head_dim
        self.wqkv = Linear(cfg.hidden_dim, 3 * cfg.num_heads * cfg.head_dim, bias=False)
        self.wo = Linear(cfg.num_heads * cfg.head_dim, cfg.hidden_dim, bias=False)

    def forward(self, x, rope, key_mask):
        B, T, _ = x.shape
        q, k, v = self.wqkv(x).chunk(3, dim=-1)
        q = apply_rotary(q.reshape(B, T, self.h, self.dh), rope)
        k = apply_rotary(k.reshape(B, T, self.h, self.dh), rope)
        v = v.reshape(B, T, self.h, self.dh)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        ctx = dit_attention(q, k, v, key_mask)
        return self.wo(ctx.transpose(1, 2).reshape(B, T, self.h * self.dh))


class DiTFeedForward(nn.Module):
    """SwiGLU."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.w1 = Linear(cfg.hidden_dim, cfg.intermediate_size, bias=False)
        self.w3 = Linear(cfg.hidden_dim, cfg.intermediate_size, bias=False)
        self.w2 = Linear(cfg.intermediate_size, cfg.hidden_dim, bias=False)

    def forward(self, x):
        return self.w2(F.silu(self.w1(x)) * self.w3(x))


class DiTBlock(nn.Module):
    def __init__(self, cfg: DiTConfig, receive_skip: bool):
        super().__init__()
        if receive_skip:
            self.skip_in_linear = Linear(2 * cfg.hidden_dim, cfg.hidden_dim)
        self.attention_norm = AdaptiveRMSNorm(cfg.hidden_dim, cfg.norm_eps)
        self.attention = DiTAttention(cfg)
        self.ffn_norm = AdaptiveRMSNorm(cfg.hidden_dim, cfg.norm_eps)
        self.feed_forward = DiTFeedForward(cfg)

    def forward(self, x, c_emb, rope, key_mask, skip_in):
        if skip_in is not None:
            x = self.skip_in_linear(torch.cat([x, skip_in], dim=-1))
        x = x + self.attention(self.attention_norm(x, c_emb), rope, key_mask)
        return x + self.feed_forward(self.ffn_norm(x, c_emb))


class DiTTransformer(nn.Module):
    """gpt_fast Transformer with u-vit skips."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        n = cfg.depth
        self.emit = [i for i in range(n) if i < n // 2] if cfg.uvit_skip_connection else []
        self.recv = [i for i in range(n) if i > n // 2] if cfg.uvit_skip_connection else []
        self.layers = nn.ModuleList(DiTBlock(cfg, i in self.recv) for i in range(n))
        self.norm = AdaptiveRMSNorm(cfg.hidden_dim, cfg.norm_eps)
        # {device: the rope_table_size-row RoPE table}, made on first use
        self._rope: dict = {}

    def rope(self, T: int, device):
        """The RoPE rows [0, T) on `device`: a view of the table the JAX
        model slices (rope_table_size rows), copied to the device once and
        never replaced, so a CUDA graph may read it."""
        table = self._rope.get(device)
        if table is None:
            c = self.cfg
            table = self._rope.setdefault(device, torch.from_numpy(
                precompute_rope(c.rope_table_size, c.head_dim, c.rope_base)).to(device))
        return table[:T]

    def forward(self, x, c_emb, key_mask):
        rope = self.rope(x.shape[1], x.device)
        skips = []
        for i, layer in enumerate(self.layers):
            skip_in = skips.pop() if i in self.recv and skips else None
            x = layer(x, c_emb, rope, key_mask, skip_in)
            if i in self.emit:
                skips.append(x)
        return self.norm(x, c_emb)


class _Wrap(nn.Module):
    """Naming shell: the reference nests its weight-normed convs as
    `<name>.conv.conv` (SConv1d -> NormConv1d -> Conv1d)."""

    def __init__(self, inner: nn.Module):
        super().__init__()
        self.conv = inner


def _sconv(cin: int, cout: int, k: int = 1, dilation: int = 1) -> _Wrap:
    return _Wrap(_Wrap(Conv1d(cin, cout, k, dilation=dilation)))


class WaveNet(nn.Module):
    """WN gated dilated conv stack (wavenet.py:103-166). Layout (B, C, T)."""

    def __init__(self, cfg: WaveNetConfig, gin: int):
        super().__init__()
        self.cfg = cfg
        C, n = cfg.hidden_dim, cfg.num_layers
        self.cond_layer = _sconv(gin, 2 * C * n)
        self.in_layers = nn.ModuleList(
            _sconv(C, 2 * C, cfg.kernel_size, cfg.dilation_rate ** i) for i in range(n)
        )
        self.res_skip_layers = nn.ModuleList(
            _sconv(C, 2 * C if i < n - 1 else C) for i in range(n)
        )

    def forward(self, x, x_mask, g):
        """x (B, C, T); x_mask (B, 1, T); g (B, gin, 1)."""
        c = self.cfg
        C, T = c.hidden_dim, x.shape[-1]
        g_all = self.cond_layer.conv.conv(g)
        output = torch.zeros_like(x)
        # reflect at each row's valid length, not the buffer edge
        xl = torch.clamp(x_mask[:, 0].sum(dim=1, keepdim=True), min=1).long()
        for i in range(c.num_layers):
            dilation = c.dilation_rate ** i
            eff_k = (c.kernel_size - 1) * dilation + 1
            pad_r = (eff_k - 1) // 2
            pad_l = eff_k - 1 - pad_r
            pos = torch.arange(-pad_l, T + pad_r, device=x.device)[None, :]
            q = torch.where(pos < 0, -pos, pos)
            q = torch.where(q >= xl, 2 * xl - 2 - q, q)
            q = torch.clamp(q, 0, T - 1).expand(x.shape[0], -1)
            xp = torch.gather(x, 2, q[:, None, :].expand(-1, C, -1))
            acts_in = self.in_layers[i].conv.conv(xp) + g_all[:, i * 2 * C:(i + 1) * 2 * C]
            acts = torch.tanh(acts_in[:, :C]) * torch.sigmoid(acts_in[:, C:])
            res_skip = self.res_skip_layers[i].conv.conv(acts)
            if i < c.num_layers - 1:
                x = (x + res_skip[:, :C]) * x_mask
                output = output + res_skip[:, C:]
            else:
                output = output + res_skip
        return output * x_mask


class FinalLayer(nn.Module):
    """LayerNorm (no affine, eps 1e-6) + adaLN shift/scale + Linear."""

    def __init__(self, cond_dim: int, hidden: int):
        super().__init__()
        self.norm_final = LayerNorm(hidden, eps=1e-6, elementwise_affine=False)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), Linear(cond_dim, 2 * hidden))
        self.linear = Linear(hidden, hidden)

    def forward(self, x, c):
        shift, scale = self.adaLN_modulation(c).chunk(2, dim=-1)
        h = self.norm_final(x) * (1.0 + scale[:, None]) + shift[:, None]
        return self.linear(h)


class DiT(nn.Module):
    """Flow-matching velocity estimator (diffusion_transformer.py:103-257)."""

    def __init__(self, cfg: DiTConfig, wn: WaveNetConfig):
        super().__init__()
        self.cfg, self.wn_cfg = cfg, wn
        self.t_embedder = TimestepEmbedder(cfg.hidden_dim, cfg.time_freq_dim)
        self.cond_projection = Linear(cfg.content_dim, cfg.hidden_dim)
        merge_in = 2 * cfg.in_channels + cfg.hidden_dim
        if cfg.style_condition and not cfg.style_as_token:
            merge_in += cfg.style_dim
        self.cond_x_merge_linear = Linear(merge_in, cfg.hidden_dim)
        self.transformer = DiTTransformer(cfg)
        if cfg.long_skip_connection:
            self.skip_linear = Linear(cfg.hidden_dim + cfg.in_channels, cfg.hidden_dim)
        self.conv1 = Linear(cfg.hidden_dim, wn.hidden_dim)
        self.t_embedder2 = TimestepEmbedder(wn.hidden_dim, cfg.time_freq_dim)
        self.wavenet = WaveNet(wn, wn.hidden_dim)
        self.res_projection = Linear(cfg.hidden_dim, wn.hidden_dim)
        self.final_layer = FinalLayer(cfg.hidden_dim, wn.hidden_dim)
        self.conv2 = Pointwise(wn.hidden_dim, cfg.in_channels)

    def forward(self, x, prompt_x, x_lens, t, style, cond):
        """x, prompt_x (B, 80, T); x_lens (B,); t (B,); style (B, 192);
        cond (B, T, content_dim). Returns the velocity (B, 80, T)."""
        c = self.cfg
        B, _, T = x.shape
        t1 = self.t_embedder(t)
        cond = self.cond_projection(cond)
        xt = x.transpose(1, 2)
        x_in = torch.cat([xt, prompt_x.transpose(1, 2), cond], dim=-1)
        if c.style_condition and not c.style_as_token:
            x_in = torch.cat([x_in, style[:, None].expand(B, T, style.shape[-1])], dim=-1)
        x_in = self.cond_x_merge_linear(x_in)
        # the stack computes in the caller's dtype: the float32 time
        # embedding would otherwise promote every AdaLN-modulated activation
        t1 = t1.to(x_in.dtype)
        valid = torch.arange(T, device=x.device)[None, :] < x_lens[:, None]
        x_res = self.transformer(x_in, t1[:, None], valid)
        if c.long_skip_connection:
            x_res = self.skip_linear(torch.cat([x_res, xt], dim=-1))
        h = self.conv1(x_res)
        t2 = self.t_embedder2(t).to(h.dtype)
        mask = valid[:, None, :].to(h.dtype)
        wn = self.wavenet(h.transpose(1, 2), mask, t2[:, :, None]).transpose(1, 2)
        h = wn + self.res_projection(x_res)
        h = self.final_layer(h, t1)
        return self.conv2(h).transpose(1, 2)


class CFM(nn.Module):
    """Naming shell for the reference's `cfm.estimator`."""

    def __init__(self, cfg: S2MelConfig):
        super().__init__()
        self.estimator = DiT(cfg.dit, cfg.wavenet)


class InterpolateRegulator(nn.Module):
    """length_regulator.py:28-141 (continuous input, interpolate=True), with
    GroupNorm statistics over valid frames only."""

    def __init__(self, cfg: LengthRegulatorConfig):
        super().__init__()
        C = cfg.channels
        self.n = len(cfg.sampling_ratios)
        self.content_in_proj = Linear(cfg.in_channels, C)
        mods = []
        for _ in range(self.n):
            mods += [Conv1d(C, C, 3, padding=1), nn.GroupNorm(1, C), nn.Mish()]
        mods.append(Conv1d(C, C, 1))
        self.model = nn.Sequential(*mods)

    @staticmethod
    def _masked_group_norm(gn: nn.GroupNorm, h, mask):
        """h (B, C, T); mask (B, 1, T) float 0/1."""
        C = h.shape[1]
        hf = h.float() * mask
        n = torch.clamp(mask.sum(dim=(1, 2), keepdim=True) * C, min=1.0)
        mean = hf.sum(dim=(1, 2), keepdim=True) / n
        var = (torch.square(hf - mean) * mask).sum(dim=(1, 2), keepdim=True) / n
        out = (hf - mean) * torch.rsqrt(var + gn.eps) * gn.weight[:, None] + gn.bias[:, None]
        return out.to(h.dtype)

    def forward(self, x, ylens, out_len: int, xlens=None):
        """x (B, S, in_channels); ylens (B,) valid output frames; out_len the
        buffer width; xlens (B,) valid input frames. Returns (B, out_len, C)
        zero beyond ylens."""
        B, S, _ = x.shape
        x = self.content_in_proj(x)
        if xlens is None:
            xlens = torch.full((B,), S, dtype=torch.int64, device=x.device)
        yl = torch.clamp(ylens, min=1)
        j = torch.arange(out_len, device=x.device)
        src = torch.floor(j[None, :] * (xlens[:, None].float() / yl[:, None])).long()
        src = torch.minimum(torch.clamp(src, min=0), torch.clamp(xlens[:, None] - 1, min=0))
        h = torch.gather(x, 1, src[..., None].expand(-1, -1, x.shape[-1]))
        h = h.transpose(1, 2)
        mask = (j[None, :] < ylens[:, None])[:, None, :].to(h.dtype)
        for i in range(self.n):
            h = self.model[3 * i](h * mask)
            h = self._masked_group_norm(self.model[3 * i + 1], h, mask)
            h = h * torch.tanh(F.softplus(h))
        h = self.model[3 * self.n](h)
        return (h * mask).transpose(1, 2)


class S2Mel(nn.Module):
    """Container mirroring the reference MyModel: cfm, length_regulator,
    gpt_layer."""

    def __init__(self, cfg: S2MelConfig):
        super().__init__()
        self.cfm = CFM(cfg)
        self.length_regulator = InterpolateRegulator(cfg.length_regulator)
        d = cfg.gpt_dims
        self.gpt_layer = nn.Sequential(
            *(Linear(d[i], d[i + 1]) for i in range(len(d) - 1))
        )

    def regulate(self, x, ylens, out_len: int, xlens=None):
        return self.length_regulator(x, ylens, out_len, xlens)

    def project_gpt_latent(self, x):
        return self.gpt_layer(x)

    def velocity(self, x, prompt_x, x_lens, t, style, cond):
        return self.cfm.estimator(x, prompt_x, x_lens, t, style, cond)
