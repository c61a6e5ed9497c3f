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
"""

from __future__ import annotations

import ctypes
import math

import torch

from indextts_tpu_torch.ops import cuda_lib

NEG_INF = -1e9


counter = cuda_lib.LaunchCounter()  # the float32 instantiation's launches
bf16_counter = cuda_lib.LaunchCounter()  # the bfloat16 instantiation's


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


def dit_attention(q, k, v, key_mask):
    """K3 on CUDA tensors, the plain version on CPU tensors. On the card the
    result is a (B, H, T, Dh) view of a (B, T, H, Dh) tensor."""
    if q.device.type == "cpu":
        return dit_attention_plain(q, k, v, key_mask)
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
    q, k, v = (kernel_operand(t) for t in (q, k, v))
    mask = key_mask.view(torch.uint8)
    bf16 = q.dtype == torch.bfloat16
    out = torch.empty((B, T, H, Dh), device=q.device, dtype=q.dtype).transpose(1, 2)
    strides = (ctypes.c_longlong * 14)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                       *out.stride()[:3], *mask.stride())
    symbol = "dit_attention_bf16" if bf16 else "dit_attention"
    fn = cuda_lib.function("dit_attention", symbol,
                           [cuda_lib.P] * 6 + [cuda_lib.I] * 3 + [cuda_lib.F, cuda_lib.P])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
             ctypes.addressof(strides), B, H, T, 1.0 / math.sqrt(Dh), stream)
    cuda_lib.check(err, symbol)
    (bf16_counter if bf16 else counter).add()
    return out
