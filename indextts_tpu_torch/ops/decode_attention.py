"""Ragged single-token decode attention with a masked hole (kernels K1, K4).

One query token per (row, head) attends to its KV cache, natural layout
(B, H, cap, Dh): keys at positions < valid_len that lie outside
[hole_start, hole_end) (the left-pad run inside a bucketed prompt).

* K1 `ragged_decode_attention`, a float32 or bfloat16 cache: replaces the
  JAX package's three Pallas decode kernels (indextts_tpu/ops/
  decode_attention.py `_kernel`, `_kernel_t`, `_kernel_blocked`).
* K4 `ragged_decode_attention_q8`, an int8 cache with per-(head, token) f32
  scales (B, H, cap) from `quantize_kv`: replaces `_kernel_blocked_q8` and
  `_kernel_grid_q8`, the two variants (TARS_Q8_VARIANT) of
  `ragged_decode_attention_blocked_q8`. s = (q . k8) * ksc * Dh^-1/2, and
  ctx = sum_t p_t * vsc_t * v8_t.

Both live in csrc/decode_attention.cu. Each `*_plain` function is the same
function in plain PyTorch, which the wrappers run for CPU tensors.
"""

from __future__ import annotations

import math

import torch

from indextts_tpu_torch.ops import cuda_lib

# keys per split-K range of the kernel's first pass
CHUNK = 64


class _Counter:
    launches = 0


counter = _Counter()
q8_counter = _Counter()
NEG_INF = -1e9


def ragged_decode_attention_plain(q, k, v, valid_len, hole_start, hole_end):
    """q (B,H,Dh); k, v (B,H,cap,Dh); valid_len/hole_start/hole_end (B,) int.
    Returns (B,H,Dh) float32. A row with no attending key returns zeros."""
    cap = k.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhd,bhsd->bhs", q.float(), k.float()) * scale
    pos = torch.arange(cap, device=q.device)[None, :]
    ok = (pos < valid_len[:, None]) & (
        (pos < hole_start[:, None]) | (pos >= hole_end[:, None])
    )
    s = s.masked_fill(~ok[:, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isinf(m), torch.zeros_like(m), m))
    l = p.sum(-1, keepdim=True)
    ctx = torch.einsum("bhs,bhsd->bhd", p, v.float())
    return ctx / l.clamp_min(1e-30)


def ragged_decode_attention(q, k, v, valid_len, hole_start, hole_end):
    """K1 on CUDA tensors, the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return ragged_decode_attention_plain(q, k, v, valid_len, hole_start,
                                             hole_end)
    B, H, Dh = q.shape
    cap = k.shape[2]
    if Dh != 64:
        raise ValueError(f"decode attention kernel needs Dh=64, got {Dh}")
    if k.shape != (B, H, cap, Dh) or v.shape != k.shape:
        raise ValueError(f"cache shape {tuple(k.shape)}/{tuple(v.shape)} "
                         f"does not match q {tuple(q.shape)}")
    if q.dtype != torch.float32 or k.dtype not in (torch.float32, torch.bfloat16) \
            or v.dtype != k.dtype:
        raise TypeError(f"dtypes q={q.dtype} k={k.dtype} v={v.dtype}")
    if not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError("K/V caches must be contiguous")
    for t in (k, v, valid_len, hole_start, hole_end):
        if t.device != q.device:
            raise ValueError("all inputs must be on the same device")
    q = q.contiguous()
    ints = [t.to(torch.int32).contiguous() for t in (valid_len, hole_start, hole_end)]
    n_splits = -(-cap // CHUNK)
    part = torch.empty((B, H, n_splits, Dh + 2), device=q.device,
                       dtype=torch.float32)
    out = torch.empty((B, H, Dh), device=q.device, dtype=torch.float32)
    fn = cuda_lib.function("decode_attention", "ragged_decode_attention",
                           [cuda_lib.P] * 8 + [cuda_lib.I] * 6 + [cuda_lib.F, cuda_lib.P])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ints[0].data_ptr(),
             ints[1].data_ptr(), ints[2].data_ptr(), part.data_ptr(),
             out.data_ptr(), B, H, cap, CHUNK, n_splits,
             int(k.dtype == torch.bfloat16), 1.0 / math.sqrt(Dh), stream)
    cuda_lib.check(err, "ragged_decode_attention")
    counter.launches += 1
    return out


def ragged_decode_attention_q8_plain(q, k8, v8, ksc, vsc, valid_len, hole_start,
                                     hole_end):
    """q (B,H,Dh) f32; k8, v8 (B,H,cap,Dh) int8; ksc, vsc (B,H,cap) f32;
    valid_len/hole_start/hole_end (B,) int. Returns (B,H,Dh) float32. As
    the JAX package's `ragged_decode_attention_q8_xla`, masked keys score
    -1e9."""
    cap = k8.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    raw = torch.einsum("bhd,bhsd->bhs", q.float(), k8.float())
    s = raw * ksc * scale
    pos = torch.arange(cap, device=q.device)[None, :]
    ok = (pos < valid_len[:, None]) & (
        (pos < hole_start[:, None]) | (pos >= hole_end[:, None])
    )
    s = torch.where(ok[:, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bhsd->bhd", p * vsc, v8.float())


def ragged_decode_attention_q8(q, k8, v8, ksc, vsc, valid_len, hole_start, hole_end):
    """K4 on CUDA tensors, the plain version on CPU tensors. A row with no
    attending key is not defined (the decode step always attends to its own
    token)."""
    if q.device.type == "cpu":
        return ragged_decode_attention_q8_plain(q, k8, v8, ksc, vsc, valid_len,
                                                hole_start, hole_end)
    B, H, Dh = q.shape
    cap = k8.shape[2]
    if Dh != 64:
        raise ValueError(f"decode attention kernel needs Dh=64, got {Dh}")
    if k8.shape != (B, H, cap, Dh) or v8.shape != k8.shape:
        raise ValueError(f"cache shape {tuple(k8.shape)}/{tuple(v8.shape)} "
                         f"does not match q {tuple(q.shape)}")
    if ksc.shape != (B, H, cap) or vsc.shape != ksc.shape:
        raise ValueError(f"scale shape {tuple(ksc.shape)}/{tuple(vsc.shape)} "
                         f"does not match the cache {tuple(k8.shape)}")
    if q.dtype != torch.float32 or k8.dtype != torch.int8 or v8.dtype != torch.int8 \
            or ksc.dtype != torch.float32 or vsc.dtype != torch.float32:
        raise TypeError(f"dtypes q={q.dtype} k8={k8.dtype} v8={v8.dtype} "
                        f"ksc={ksc.dtype} vsc={vsc.dtype}")
    if not all(t.is_contiguous() for t in (k8, v8, ksc, vsc)):
        raise ValueError("K/V caches and scales must be contiguous")
    for t in (k8, v8, ksc, vsc, valid_len, hole_start, hole_end):
        if t.device != q.device:
            raise ValueError("all inputs must be on the same device")
    q = q.contiguous()
    ints = [t.to(torch.int32).contiguous() for t in (valid_len, hole_start, hole_end)]
    n_splits = -(-cap // CHUNK)
    part = torch.empty((B, H, n_splits, Dh + 2), device=q.device, dtype=torch.float32)
    out = torch.empty((B, H, Dh), device=q.device, dtype=torch.float32)
    fn = cuda_lib.function("decode_attention", "ragged_decode_attention_q8",
                           [cuda_lib.P] * 10 + [cuda_lib.I] * 5 + [cuda_lib.F, cuda_lib.P])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k8.data_ptr(), v8.data_ptr(), ksc.data_ptr(), vsc.data_ptr(),
             ints[0].data_ptr(), ints[1].data_ptr(), ints[2].data_ptr(), part.data_ptr(),
             out.data_ptr(), B, H, cap, CHUNK, n_splits, 1.0 / math.sqrt(Dh), stream)
    cuda_lib.check(err, "ragged_decode_attention_q8")
    q8_counter.launches += 1
    return out
