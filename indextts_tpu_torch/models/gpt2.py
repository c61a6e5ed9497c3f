"""GPT-2 transformer core in PyTorch: float, W8A8 or W4A8.

Counterpart of indextts_tpu/models/gpt2.py: the reference's vendored HF
GPT-2 without wte/wpe (it consumes `inputs_embeds`), causal self-attention
with additive padding masks, gelu_new MLP, LayerNorm eps 1e-5. Two modes:

  * `forward`     full sequence (prefill / teacher-forced latent pass), plain
                  torch ops (einsum + masked softmax), as XLA ran it; with
                  `past`, the sequence continues a cached prefix's KV (the
                  keyed prefill: the prompt's text tail on top of the
                  conditioning prefix);
  * `decode_step` one token against a KV cache in its natural layout
                  (L, B, H, cap, Dh). The step writes its K/V into the cache
                  in place and attends over keys < valid_len outside the
                  prompt's left-pad hole: through kernel K1 over a float
                  cache, or, over an int8 cache with per-(head, token)
                  scales (`quantize_kv`), through kernel K4
                  (ops/decode_attention.py).

`quantize=True` is the JAX package's quantized GPT (`gpt_quantize`):
per-output-channel weights of `wbits` bits, a dynamic per-row int8
activation scale (`quant_row`) and an exact int32 contraction. W8 weights
are int8 (in, out); W4 weights are int4 pairs packed into bytes
(ops/gemv.py `pack_w4`), along the rows, except the MLP's c_proj, which is
packed along its output columns. `gemv=True` is the JAX package's
`gemv_impl="pallas"`: single-token decode calls, at any row count, take
the kernels of ops/gemv.py where the JAX package's shape gating opens them
(K5 or K7 for c_attn and attn c_proj, K6 or K8 for the whole MLP, K5 for
the int8 logits head); the wrappers launch them in chunks of rows. On a
tensor-parallel rank (parallel/tp.py) a layer's gate reads its own widths,
the fused MLP's the whole MLP's. The JAX package's row threshold
(TARS_GEMV_MAX_ROWS, 1 by default, from a TPU measurement) has no
counterpart: a continuous batch's rows take the kernels too. Every other call (prefill, the latent pass, and every call with
`gemv=False`, the JAX package's "xla" route) takes the plain contraction,
W4 weights unpacked once per call. `QuantDenseHead` is the int8 logits head
(`head_quant`); it stays W8 under W4, as in the JAX package.

The core computes in its stored parameters' dtype (`GPT2Core.dtype`, the
engine's gpt_dtype), as the JAX GPT2Core in its `dtype`: the embeddings are
cast to it, LayerNorm takes float32 statistics and rounds once
(models/layers.py), the attention softmax is float32, a float cache holds
the dtype and the decode attention reads it with a float32 query. The
quantized layers quantize a float32 copy of their input and return their
float32 result in the input's dtype; their per-channel scales stay float32.

Module names follow the reference state_dict keys (`h.{i}.attn.c_attn`, ...);
a quantized layer carries `weight_q` (W8) or `weight_q4` (W4),
`weight_scale` and `bias`.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from indextts_tpu_torch.models.layers import LayerNorm
from indextts_tpu_torch.ops import gemv as gemv_ops
from indextts_tpu_torch.ops.decode_attention import (
    ragged_decode_attention,
    ragged_decode_attention_q8,
)

NEG_INF = -1e9


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    """HF 'gelu_new' == tanh-approx GELU."""
    return 0.5 * x * (
        1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * torch.pow(x, 3.0)))
    )


def quant_row(x: torch.Tensor, amax: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row int8 activation quantization (W8A8 input side):
    (x_q int8, a f32 with a kept last axis of 1). `amax`, with that kept
    axis, is the whole row's absolute maximum where x holds a slice of the
    row (a row-cut layer, parallel/tp.py); by default x's own."""
    xf = x.float()
    if amax is None:
        amax = xf.abs().amax(dim=-1, keepdim=True)
    a = amax / 127.0 + 1e-12
    return torch.clamp(torch.round(xf / a), -127, 127).to(torch.int8), a


def quantize_kv(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-vector int8 absmax quantization over the last (head_dim) axis:
    (q int8 of t's shape, scale f32 without the last axis)."""
    tf = t.float()
    scale = tf.abs().amax(dim=-1) / 127.0 + 1e-8
    return torch.clamp(torch.round(tf / scale[..., None]), -127, 127).to(torch.int8), scale


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(in, out) float weight -> (int8 weight, f32 per-output-channel scale),
    as the JAX package's `quantize_conv1d_params`."""
    w = w.float()
    scale = w.abs().amax(dim=0) / 127.0 + 1e-12
    return torch.clamp(torch.round(w / scale[None]), -127, 127).to(torch.int8), scale


def quantize_weight_w4(w: torch.Tensor, cols: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(in, out) float weight -> (packed int4 weight, f32 per-output-channel
    scale), as the JAX package's `quantize_conv1d_params_w4`: values in
    [-7, 7], packed along the rows, or along the columns with `cols`."""
    w = w.float()
    scale = w.abs().amax(dim=0) / 7.0 + 1e-12
    q = torch.clamp(torch.round(w / scale[None]), -7, 7)
    return gemv_ops.pack_w4(q, cols=cols), scale


def _single_rows(x: torch.Tensor) -> int:
    """The row count of a single-token call (0 for anything else): the
    decode rows that the gemv kernels may take."""
    if x.dim() >= 3 and x.shape[-2] != 1:
        return 0
    return x.numel() // x.shape[-1]


def w8a8(x, w_q, w_scale, bias, amax=None, reduce=None):
    """The plain W8A8 contraction: ((x_q . w_q) * a) * s + bias, float32. A
    row-cut layer (parallel/tp.py) gives its whole row's `amax` and
    `reduce`, which sums the exact integer partial sums over the shards
    before the scales, so that the layer gives the unsharded bits."""
    x_q, a = quant_row(x, amax)
    acc = gemv_ops.int8_sums(x_q, w_q)
    if reduce is not None:
        acc = reduce(acc)
    return acc.float() * a * w_scale + bias


class Conv1D(nn.Module):
    """HF GPT-2 'Conv1D': y = x @ W + b with W stored (in, out)."""

    def __init__(self, nx: int, nf: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(nx, nf).normal_(std=0.02))
        self.bias = nn.Parameter(torch.zeros(nf))

    def forward(self, x):
        return torch.matmul(x, self.weight) + self.bias


class QConv1D(nn.Module):
    """Quantized Conv1D (the JAX Conv1D with quantize=True): per-output-
    channel scale, and an int8 weight (in, out) with wbits=8, or int4 pairs
    packed along the rows (in/2, out), or with `cols` along the columns
    (in, out/2), with wbits=4. With `gemv`, single-token decode calls take
    kernel K5 (W8) or K7 (W4, rows) where the JAX shape gating opens it.
    The widths `nx` and `nf` are the stored weight's: a tensor-parallel
    rank's (parallel/tp.py) are its own piece's, and so are its gating and
    its kernels' launch plans."""

    def __init__(self, nx: int, nf: int, gemv: bool = False, wbits: int = 8,
                 cols: bool = False):
        super().__init__()
        self.gemv, self.wbits, self.cols = gemv, wbits, cols
        if wbits == 4:
            shape = (nx, nf // 2) if cols else (nx // 2, nf)
            self.register_buffer("weight_q4", torch.zeros(shape, dtype=torch.int8))
        else:
            self.register_buffer("weight_q", torch.zeros(nx, nf, dtype=torch.int8))
        self.register_buffer("weight_scale", torch.ones(nf))
        self.register_buffer("bias", torch.zeros(nf))

    @property
    def stored_weight(self) -> torch.Tensor:
        """The weight as stored: int8, or packed int4 pairs."""
        return self.weight_q4 if self.wbits == 4 else self.weight_q

    @property
    def nx(self) -> int:
        """The contraction width of the stored weight."""
        n = self.stored_weight.shape[0]
        return 2 * n if self.wbits == 4 and not self.cols else n

    @property
    def nf(self) -> int:
        """The output width of the stored weight."""
        n = self.stored_weight.shape[1]
        return 2 * n if self.wbits == 4 and self.cols else n

    def kernel_rows(self, x: torch.Tensor) -> int:
        """The row count of a call that takes K5 or K7, 0 for any other: a
        single-token call of a `gemv` layer whose widths open the kernel."""
        rows = _single_rows(x) if self.gemv else 0
        if not rows:
            return 0
        if self.wbits == 4:
            opens = not self.cols and gemv_ops.supports_w4(self.nx, self.nf)
        else:
            opens = gemv_ops.supports(self.nx, self.nf)
        return rows if opens else 0

    def kernel(self, x_q: torch.Tensor, a: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        """K5 (W8) or K7 (W4) over the stored weight with `bias`: (rows,
        nf) float32."""
        gemv = gemv_ops.gemv_w4 if self.wbits == 4 else gemv_ops.gemv_w8
        return gemv(x_q, a, self.stored_weight, self.weight_scale, bias)

    def int8_weight(self) -> torch.Tensor:
        """The (nx, nf) int8 weight of the plain contraction: W4 weights
        unpacked anew on every call."""
        if self.wbits == 4:
            return gemv_ops.unpack_w4(self.weight_q4, axis=1 if self.cols else 0)
        return self.weight_q

    def forward(self, x):
        rows = self.kernel_rows(x)
        if rows:
            x_q, a = quant_row(x.reshape(rows, self.nx))
            y = self.kernel(x_q, a, self.bias)
            return y.reshape(*x.shape[:-1], self.nf).to(x.dtype)
        return w8a8(x, self.int8_weight(), self.weight_scale, self.bias).to(x.dtype)


class QuantDenseHead(QConv1D):
    """int8 (W8A8) logits head: a QConv1D whose output columns are padded to
    a multiple of 128 (8194 -> 8320), padding columns with zero weights and
    bias; the logits are sliced back."""

    def __init__(self, nx: int, features: int, gemv: bool = False):
        super().__init__(nx, -(-features // 128) * 128, gemv)
        self.features = features

    def forward(self, x):
        return super().forward(x)[..., :self.features]


def _linear(nx: int, nf: int, quantize: bool, gemv: bool, wbits: int,
            cols: bool = False) -> nn.Module:
    return QConv1D(nx, nf, gemv, wbits, cols) if quantize else Conv1D(nx, nf)


class GPT2Attention(nn.Module):
    """Fused [q | k | v] projection, `n_head` heads. The widths follow the
    projections' own, so that a tensor-parallel rank (parallel/tp.py), which
    holds each of q, k and v for its own heads, runs the same code."""

    def __init__(self, dim: int, n_head: int, quantize: bool = False, gemv: bool = False,
                 wbits: int = 8):
        super().__init__()
        self.n_head = n_head
        self.c_attn = _linear(dim, 3 * dim, quantize, gemv, wbits)
        self.c_proj = _linear(dim, dim, quantize, gemv, wbits)

    def _heads(self, t, B):
        return t.reshape(B, -1, self.n_head, t.shape[-1] // self.n_head).transpose(1, 2)

    def forward(self, x, attn_bias, past: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """Full sequence. x (B, T, D); `past` this layer's cached (k, v) of
        the P positions before x, (B, H, P, Dh), or None (P = 0); attn_bias
        broadcastable to (B,1,T,P+T). Returns (out, (k, v)) with k, v
        (B, H, P+T, Dh)."""
        B, T, _ = x.shape
        q, k, v = self.c_attn(x).chunk(3, dim=-1)
        q, k, v = self._heads(q, B), self._heads(k, B), self._heads(v, B)
        if past is not None:
            k, v = torch.cat([past[0], k], dim=2), torch.cat([past[1], v], dim=2)
        scale = 1.0 / math.sqrt(q.shape[-1])
        scores = torch.einsum("bhtd,bhsd->bhts", q, k).float() * scale
        probs = torch.softmax(scores + attn_bias, dim=-1).to(v.dtype)
        ctx = torch.einsum("bhts,bhsd->bhtd", probs, v)
        return self.c_proj(ctx.transpose(1, 2).reshape(B, T, -1)), (k, v)

    def decode_step(self, x, cache: Sequence[torch.Tensor], index: torch.Tensor, valid_len,
                    hole_s, hole_e):
        """One token. x (B, 1, D); `cache` this layer's (k, v) float
        (B,H,cap,Dh), or (k8, v8, ksc, vsc) int8 with (B,H,cap) scales;
        row b written IN PLACE at slot index[b], `index` a (B,) int64
        tensor on the device (rows of a continuous batch sit at different
        slots). The writes are `scatter_` over the index expanded along the
        heads: indexing with a tensor (`cache[b, :, t] = ...`) would read t
        on the host, which a captured step cannot."""
        B = x.shape[0]
        q, k, v = self.c_attn(x).chunk(3, dim=-1)
        q, k, v = self._heads(q, B), self._heads(k, B), self._heads(v, B)
        q = q[:, :, 0].float()
        at = index[:, None, None]  # (B, 1, 1)
        if len(cache) == 4:
            k8, v8, ksc, vsc = cache
            for c8, sc, t in ((k8, ksc, k), (v8, vsc, v)):
                t8, t_sc = quantize_kv(t)
                c8.scatter_(2, at[..., None].expand(t8.shape), t8)
                sc.scatter_(2, at.expand(t_sc.shape), t_sc)
            ctx = ragged_decode_attention_q8(q, k8, v8, ksc, vsc, valid_len, hole_s, hole_e)
        else:
            k_cache, v_cache = cache
            for c, t in ((k_cache, k), (v_cache, v)):
                c.scatter_(2, at[..., None].expand(t.shape), t.to(c.dtype))
            ctx = ragged_decode_attention(q, k_cache, v_cache, valid_len, hole_s, hole_e)
        return self.c_proj(ctx.to(x.dtype).reshape(B, 1, -1))


class GPT2MLP(nn.Module):
    """c_fc, gelu_new, c_proj. A quantized MLP with `gemv` takes the fused
    kernel K6 (W8) or K8 (W4) on single-token decode calls where the JAX
    gating opens it at its widths (D, 4D), its hidden quantized in groups
    of `group` columns, that gating's width (0 where it is closed). A
    tensor-parallel rank (parallel/tp.py) holds a slice of the hidden
    columns: it runs the kernel over them in groups of the same width with
    the bias of its row-cut c_proj's partial output (the whole bias on one
    rank of the model group), and sums the ranks' outputs with `reduce`."""

    def __init__(self, dim: int, quantize: bool = False, gemv: bool = False,
                 wbits: int = 8):
        super().__init__()
        self.gemv = gemv
        self.w4 = quantize and wbits == 4
        # the JAX MLP's c_fc never takes the single-row GEMV on its own; under
        # W4 its c_proj is packed along the output columns, as mlp_w4 reads it
        self.c_fc = _linear(dim, 4 * dim, quantize, False, wbits)
        self.c_proj = _linear(4 * dim, dim, quantize, gemv, wbits, cols=self.w4)
        if self.w4:
            supported, group = gemv_ops.supports_mlp_w4, gemv_ops.mlp_group_w4
        else:
            supported, group = gemv_ops.supports_mlp, gemv_ops.mlp_group
        self.group = group(dim, 4 * dim) if quantize and gemv and supported(dim, 4 * dim) else 0
        self.reduce = None

    def forward(self, x):
        rows = _single_rows(x)
        if self.group and rows:
            fc, pj = self.c_fc, self.c_proj
            fused = gemv_ops.mlp_w4 if self.w4 else gemv_ops.mlp_w8
            x_q, a = quant_row(x.reshape(rows, x.shape[-1]))
            y = fused(x_q, a, fc.stored_weight, fc.weight_scale, fc.bias,
                      pj.stored_weight, pj.weight_scale, pj.bias, self.group)
            if self.reduce is not None:
                y = self.reduce(y)
            return y.reshape(x.shape).to(x.dtype)
        return self.c_proj(gelu_new(self.c_fc(x)))


class GPT2Block(nn.Module):
    def __init__(self, dim: int, n_head: int, quantize: bool = False, gemv: bool = False,
                 wbits: int = 8):
        super().__init__()
        self.ln_1 = LayerNorm(dim, eps=1e-5)
        self.attn = GPT2Attention(dim, n_head, quantize, gemv, wbits)
        self.ln_2 = LayerNorm(dim, eps=1e-5)
        self.mlp = GPT2MLP(dim, quantize, gemv, wbits)

    def forward(self, x, attn_bias, past=None):
        a, kv = self.attn(self.ln_1(x), attn_bias, past)
        x = x + a
        return x + self.mlp(self.ln_2(x)), kv

    def decode_step(self, x, cache, index, valid_len, hole_s, hole_e):
        x = x + self.attn.decode_step(self.ln_1(x), cache, index, valid_len,
                                      hole_s, hole_e)
        return x + self.mlp(self.ln_2(x))


def prompt_hole(attention_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S) padding mask -> the contiguous masked run [hole_s, hole_e) per
    row (indextts_tpu/models/gpt2.py:727-735); empty when nothing is masked."""
    inval = ~attention_mask.bool()
    hole_s = torch.argmax(inval.int(), dim=1).to(torch.int32)
    hole_e = hole_s + inval.sum(dim=1).to(torch.int32)
    return hole_s, hole_e


class GPT2Core(nn.Module):
    """Stack of GPT-2 blocks + final LayerNorm over embeddings. `gemv` is
    the JAX GPT2Core's `gemv_impl == "pallas"`."""

    def __init__(self, n_layer: int, dim: int, n_head: int, quantize: bool = False,
                 gemv: bool = False, wbits: int = 8):
        super().__init__()
        self.h = nn.ModuleList(GPT2Block(dim, n_head, quantize, gemv, wbits)
                               for _ in range(n_layer))
        self.ln_f = LayerNorm(dim, eps=1e-5)

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype, that of the stored float parameters: the
        blocks' input is cast to it (the JAX GPT2Core's `dtype`)."""
        return self.ln_f.weight.dtype

    def forward(self, inputs_embeds, attention_mask: Optional[torch.Tensor] = None,
                past: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """Prefill. inputs_embeds (B, T, D), attention_mask (B, T) 1/0.
        With `past`, the float (ks, vs) of P cached positions before the
        sequence, each (L, B or 1, H, P, Dh): the T positions attend to all
        P of them and causally to each other (the JAX decode step's chunked
        continuation, indextts_tpu/models/gpt2.py:805-813), the mask
        applying to their own keys. Returns (hidden, (ks, vs)) with ks, vs
        (L, B, H, P+T, Dh)."""
        B, T = inputs_embeds.shape[:2]
        dev = inputs_embeds.device
        inputs_embeds = inputs_embeds.to(self.dtype)
        P = 0 if past is None else past[0].shape[3]
        causal = torch.tril(torch.ones(T, P + T, dtype=torch.bool, device=dev), diagonal=P)
        zero = torch.zeros((), device=dev)
        neg = torch.full((), NEG_INF, device=dev)
        bias = torch.where(causal[None, None], zero, neg)
        if attention_mask is not None:
            keys = attention_mask.bool()
            if P:
                keys = torch.cat([keys.new_ones((B, P)), keys], dim=1)
            bias = bias + torch.where(keys[:, None, None, :], zero, neg)
        x = inputs_embeds
        ks, vs = [], []
        for i, blk in enumerate(self.h):
            layer_past = None if past is None else tuple(
                c[i].expand(B, -1, -1, -1) for c in past)
            x, (k, v) = blk(x, bias, layer_past)
            ks.append(k)
            vs.append(v)
        return self.ln_f(x), (torch.stack(ks), torch.stack(vs))

    def decode_step(self, x, caches: Sequence[torch.Tensor], index: torch.Tensor, valid_len,
                    hole_s, hole_e):
        """x (B, 1, D); caches (ks, vs) float (L, B, H, cap, Dh), or
        (ks, vs, ksc, vsc) int8 with (L, B, H, cap) scales, row b updated
        in place at slot index[b] ((B,) int64); keys < valid_len ((B,) int32)
        outside [hole_s, hole_e) attend. Every per-token value is a device
        tensor, so the step can be captured in a CUDA graph."""
        x = x.to(self.dtype)
        for i, blk in enumerate(self.h):
            x = blk.decode_step(x, [c[i] for c in caches], index, valid_len, hole_s, hole_e)
        return self.ln_f(x)
