"""DiT full-sequence attention with a key-padding mask (kernel K3).

Non-causal attention over (B, H, T, Dh); keys where `key_mask` is False get
the JAX package's NEG_INF (-1e9) score, so every query row (pad queries
included) attends to the valid keys. The CUDA kernel (csrc/dit_attention.cu)
replaces the Pallas flash kernel that indextts_tpu/models/s2mel.py
`DiTAttention._flash` calls; `dit_attention_plain` is the XLA path beside it
in plain PyTorch, which the wrapper runs for CPU tensors.

The kernel reads q, k and v through their strides, so the transposed views
the DiT hands it are not copied, and it writes its output laid out as
(B, T, H, Dh): `out.transpose(1, 2).reshape(B, T, H * Dh)` is a view.

q, k and v are float32, or bfloat16 (a bfloat16 DiT, runtime.s2mel_dtype),
the output of their dtype. float32 takes the kernel's 3xTF32 instantiation
(`counter`), bfloat16 its one-pass bfloat16 tensor-core instantiation
(`dit_attention_bf16`, `bf16_counter`), with a float32 softmax.
`dit_attention_plain` on bfloat16 tensors follows the JAX XLA path dtype
by dtype: bfloat16 scores, a float32 softmax, bfloat16 probabilities.

Training (`dit_attention_train`, which models/s2mel.py `DiTAttention`
calls) goes, where grad is enabled, through `DiTAttentionFn`, the
counterpart of the library flash attention's custom_vjp that the JAX CFM
step differentiates: on the card the forward is K3 keeping each row's
base-2 log-sum-exp (`stats`: m and log2 l), and the backward is K9 (dK,
dV; `bwd_dkv_counter`) and K10 (dQ; `bwd_dq_counter`) of
csrc/dit_attention_bwd.cu, with D = rowsum(dO o O) a plain op, as the
library computes its `di` outside its kernels. The gradients come back in
the (B, T, H, Dh) layout of the DiT's views. On CPU tensors the backward
is autograd through `dit_attention_plain`; `dit_attention_bwd_plain` is
that autograd as K9's and K10's plain version. The
semantics are those of jax.grad of the JAX XLA path: a masked key's score
is the constant -1e9 and sends no gradient to q or k, even in a row with
no valid key (whose softmax is uniform, and whose dV is not zero). A
bfloat16 DiT does not train in the JAX package: bfloat16 inputs that
require grad raise.
"""

from __future__ import annotations

import ctypes
import math

import torch

from indextts_tpu_torch.ops import cuda_lib

NEG_INF = -1e9


counter = cuda_lib.LaunchCounter()  # the float32 instantiation's launches
bf16_counter = cuda_lib.LaunchCounter()  # the bfloat16 instantiation's
bwd_dkv_counter = cuda_lib.LaunchCounter()  # K9's
bwd_dq_counter = cuda_lib.LaunchCounter()  # K10's


def dit_attention_plain(q, k, v, key_mask):
    """q, k, v (B, H, T, Dh); key_mask (B, T) bool. Returns (B, H, T, Dh)."""
    scores = torch.einsum("bhtd,bhsd->bhts", q, k) / math.sqrt(q.shape[-1])
    scores = scores.masked_fill(~key_mask[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores.float(), dim=-1).to(v.dtype)
    return torch.einsum("bhts,bhsd->bhtd", probs, v)


def kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """t as the kernel can read it through its strides (16-byte copies of
    rows): unit stride on the last axis, the other strides multiples of 16
    bytes' elements (4 float32, 8 bfloat16), a 16-byte aligned base. A copy
    only where t is not so."""
    per16 = 16 // t.element_size()
    if t.stride(-1) != 1 or any(s % per16 for s in t.stride()[:-1]) or t.data_ptr() % 16:
        return t.clone(memory_format=torch.contiguous_format)
    return t


def _check(q, k, v, key_mask):
    B, H, T, Dh = q.shape
    if Dh != 64:
        raise ValueError(f"DiT attention kernel needs Dh=64, got {Dh}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k, v shapes differ")
    if key_mask.shape != (B, T) or key_mask.dtype != torch.bool:
        raise ValueError(f"key_mask must be bool ({B}, {T})")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must be all float32 or all bfloat16, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if any(t.device != q.device for t in (k, v, key_mask)):
        raise ValueError("all inputs must be on the same device")


def _strides(*ts) -> ctypes.Array:
    """The (b, h, t) strides of each 4-d tensor, then the mask's (b, t)."""
    out = [s for t in ts[:-1] for s in t.stride()[:3]] + list(ts[-1].stride())
    return (ctypes.c_longlong * len(out))(*out)


def _forward(q, k, v, key_mask, stats: bool = False):
    """K3 on CUDA tensors; with `stats` (float32 only) also each row's m and
    log2 l, (B, H, T, 2). Returns (out, stats or None)."""
    _check(q, k, v, key_mask)
    B, H, T, Dh = q.shape
    q, k, v = (kernel_operand(t) for t in (q, k, v))
    mask = key_mask.view(torch.uint8)
    bf16 = q.dtype == torch.bfloat16
    out = torch.empty((B, T, H, Dh), device=q.device, dtype=q.dtype).transpose(1, 2)
    strides = _strides(q, k, v, out, mask)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if bf16:
        if stats:
            raise TypeError("K3's row statistics are kept by its float32 instantiation only")
        fn = cuda_lib.function("dit_attention", "dit_attention_bf16",
                               [cuda_lib.P] * 6 + [cuda_lib.I] * 3 + [cuda_lib.F, cuda_lib.P])
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
                 ctypes.addressof(strides), B, H, T, 1.0 / math.sqrt(Dh), stream)
        cuda_lib.check(err, "dit_attention_bf16")
        bf16_counter.add()
        return out, None
    st = torch.empty((B, H, T, 2), device=q.device, dtype=torch.float32) if stats else None
    fn = cuda_lib.function("dit_attention", "dit_attention",
                           [cuda_lib.P] * 7 + [cuda_lib.I] * 3 + [cuda_lib.F, cuda_lib.P])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
             None if st is None else st.data_ptr(), ctypes.addressof(strides), B, H, T,
             1.0 / math.sqrt(Dh), stream)
    cuda_lib.check(err, "dit_attention")
    counter.add()
    return out, st


def dit_attention(q, k, v, key_mask):
    """K3 on CUDA tensors, the plain version on CPU tensors. On the card the
    result is a (B, H, T, Dh) view of a (B, T, H, Dh) tensor."""
    if q.device.type == "cpu":
        return dit_attention_plain(q, k, v, key_mask)
    return _forward(q, k, v, key_mask)[0]


def dit_attention_stats(q, k, v, key_mask):
    """K3 keeping each row's statistics: (out, stats), stats (B, H, T, 2)
    float32, each row's m and log2 l in base 2 (K9's and K10's input).
    float32 CUDA tensors only."""
    return _forward(q, k, v, key_mask, stats=True)


def _bwd_operands(q, k, v, key_mask, stats, dout, delta):
    _check(q, k, v, key_mask)
    B, H, T, Dh = q.shape
    if q.dtype != torch.float32 or dout.dtype != torch.float32 or dout.shape != q.shape \
            or dout.device != q.device:
        raise TypeError(f"K9/K10 take float32 q, k, v, dout of one shape and device, got "
                        f"{q.dtype}, {dout.dtype} {tuple(dout.shape)} on {dout.device}")
    for name, t, shape in (("stats", stats, (B, H, T, 2)), ("delta", delta, (B, H, T))):
        if t.shape != shape or t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != q.device:
            raise ValueError(f"{name} must be contiguous float32 {shape} on {q.device}")
    q, k, v, dout = (kernel_operand(t) for t in (q, k, v, dout))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(), dout.data_ptr(),
            stats.data_ptr(), delta.data_ptr())
    return (q, k, v, dout), ptrs, torch.cuda.current_stream(q.device).cuda_stream


def _grad_like(q) -> torch.Tensor:
    """A (B, H, T, Dh) view of a new (B, T, H, Dh) tensor: the layout of
    the DiT's views."""
    B, H, T, Dh = q.shape
    return torch.empty((B, T, H, Dh), device=q.device, dtype=q.dtype).transpose(1, 2)


def dit_attention_bwd_dkv(q, k, v, key_mask, stats, dout, delta):
    """K9: (dk, dv) from K3's `stats`, the output's gradient `dout` and
    `delta` = rowsum(dout o out) (B, H, T). float32 CUDA tensors."""
    (q, k, v, dout), ptrs, stream = _bwd_operands(q, k, v, key_mask, stats, dout, delta)
    B, H, T, Dh = q.shape
    dk, dv = _grad_like(q), _grad_like(q)
    strides = _strides(q, k, v, dout, dk, dv, key_mask.view(torch.uint8))
    fn = cuda_lib.function("dit_attention_bwd", "dit_attention_bwd_dkv",
                           [cuda_lib.P] * 10 + [cuda_lib.I] * 3 + [cuda_lib.F, cuda_lib.P])
    err = fn(*ptrs, dk.data_ptr(), dv.data_ptr(), ctypes.addressof(strides), B, H, T,
             1.0 / math.sqrt(Dh), stream)
    cuda_lib.check(err, "dit_attention_bwd_dkv")
    bwd_dkv_counter.add()
    return dk, dv


def dit_attention_bwd_dq(q, k, v, key_mask, stats, dout, delta):
    """K10: dq, from the same operands as K9."""
    (q, k, v, dout), ptrs, stream = _bwd_operands(q, k, v, key_mask, stats, dout, delta)
    B, H, T, Dh = q.shape
    dq = _grad_like(q)
    strides = _strides(q, k, v, dout, dq, dq, key_mask.view(torch.uint8))
    fn = cuda_lib.function("dit_attention_bwd", "dit_attention_bwd_dq",
                           [cuda_lib.P] * 9 + [cuda_lib.I] * 3 + [cuda_lib.F, cuda_lib.P])
    err = fn(*ptrs, dq.data_ptr(), ctypes.addressof(strides), B, H, T, 1.0 / math.sqrt(Dh),
             stream)
    cuda_lib.check(err, "dit_attention_bwd_dq")
    bwd_dq_counter.add()
    return dq


def dit_attention_bwd(q, k, v, key_mask, out, stats, dout):
    """K9 and K10: (dq, dk, dv) of K3 at (q, k, v, key_mask), from its
    output `out`, its `stats` and the output's gradient `dout`, each a
    (B, H, T, Dh) view of a (B, T, H, Dh) tensor. float32 CUDA tensors.
    D = rowsum(dO o O), the library's `di`, is a plain op."""
    delta = (dout * out).sum(-1).contiguous()
    dk, dv = dit_attention_bwd_dkv(q, k, v, key_mask, stats, dout, delta)
    return dit_attention_bwd_dq(q, k, v, key_mask, stats, dout, delta), dk, dv


def dit_attention_bwd_plain(q, k, v, key_mask, dout):
    """(dq, dk, dv) by autograd through `dit_attention_plain`: K9's and
    K10's plain version."""
    with torch.enable_grad():
        qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = dit_attention_plain(*qkv, key_mask)
        return torch.autograd.grad(out, qkv, dout)


class DiTAttentionFn(torch.autograd.Function):
    """K3 with its row statistics forward, K9 + K10 backward. CUDA tensors
    only: on the CPU, `dit_attention_train` differentiates the plain
    version by autograd."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask):
        out, stats = dit_attention_stats(q, k, v, key_mask)
        ctx.save_for_backward(q, k, v, key_mask, out, stats)
        return out

    @staticmethod
    def backward(ctx, dout):
        return (*dit_attention_bwd(*ctx.saved_tensors, dout), None)


def dit_attention_train(q, k, v, key_mask):
    """The DiT attention under autograd, where grad is enabled and an input
    requires it: `DiTAttentionFn` on CUDA tensors, the plain version (and
    autograd through it) on CPU tensors. Otherwise `dit_attention`.
    bfloat16 inputs that require grad raise (a bfloat16 DiT does not train
    in the JAX package)."""
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))):
        return dit_attention(q, k, v, key_mask)
    if q.dtype != torch.float32:
        raise TypeError(f"the DiT attention trains in float32, got {q.dtype}")
    if q.device.type == "cpu":
        return dit_attention_plain(q, k, v, key_mask)
    return DiTAttentionFn.apply(q, k, v, key_mask)
