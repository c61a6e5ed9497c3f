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

Both live in csrc/decode_attention.cu, one launch a call: a cluster of
CLUSTER blocks per (row, head), rank r taking `rank_span` of the valid keys
(computed in the kernel from valid_len, so the host never syncs), in rounds
of `round_keys`. Each `*_plain` function is the same function in plain
PyTorch, which the wrappers run for CPU tensors.
"""

from __future__ import annotations

import math

import torch

from indextts_tpu_torch.ops import cuda_lib

CLUSTER = 8  # blocks (ranks) per (row, head)
CHUNK = 16  # a rank's share is a whole number of CHUNK keys
THREADS = 256  # a block's; a round holds at most one key a thread
SCALE = 1.0 / math.sqrt(64)  # Dh^-1/2; the kernels take Dh=64
# K and V rows a round holds at most: at float32 (256-byte rows) 208 keys,
# so that two blocks fit an SM (csrc/decode_attention.cu kMaxSmem)
ROUND_KV_BYTES = 208 * 2 * 256


counter = cuda_lib.LaunchCounter()
q8_counter = cuda_lib.LaunchCounter()
NEG_INF = -1e9


def _share(n: int) -> int:
    """Keys a rank takes of n: the CLUSTER-th part of n in whole chunks."""
    return -(-n // (CHUNK * CLUSTER)) * CHUNK


def rank_span(valid: int, cap: int, rank: int):
    """Keys [start, end) of [0, min(valid, cap)) that cluster rank `rank`
    takes: the split csrc/decode_attention.cu `rank_span` computes on the
    device, a whole number of CHUNK keys a rank but the last."""
    n = max(0, min(valid, cap))
    start = min(rank * _share(n), n)
    return start, min(start + _share(n), n)


def round_keys(cap: int, row_bytes: int) -> int:
    """Keys a block holds at once for a cache of `cap` keys of `row_bytes`
    (256 fp32, 128 bf16, 64 int8): the largest share a rank can get, at
    most THREADS and ROUND_KV_BYTES of K and V rows, in whole chunks. A
    larger share goes in rounds of this many keys."""
    most = min(THREADS, ROUND_KV_BYTES // (2 * row_bytes) // CHUNK * CHUNK)
    return min(most, _share(cap))


def _i32(t):
    """t as a contiguous int32 tensor: t itself where it is one already."""
    return t if t.dtype is torch.int32 and t.is_contiguous() else t.to(torch.int32).contiguous()


def _check_common(name, q, cache, others):
    B, H, Dh = q.shape
    cap = cache.shape[2]
    if Dh != 64:
        raise ValueError(f"{name}: needs Dh=64, got {Dh}")
    if cache.shape != (B, H, cap, Dh):
        raise ValueError(f"{name}: cache shape {tuple(cache.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if q.dtype != torch.float32:
        raise TypeError(f"{name}: q must be float32, got {q.dtype}")
    for t in (cache, *others):
        if t.device != q.device:
            raise ValueError(f"{name}: all inputs must be on the same device")
    return B, H, cap


def _aligned(name, q, tensors):
    """q made contiguous; q and the caches must start 16-byte aligned (the
    kernel reads them with 16-byte loads and bulk copies)."""
    if not q.is_contiguous():
        q = q.contiguous()
    if any(t.data_ptr() % 16 for t in (q, *tensors)):
        raise ValueError(f"{name}: q and the caches must be 16-byte aligned")
    return q


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
    B, H, cap = _check_common("ragged_decode_attention", q, k,
                              (v, valid_len, hole_start, hole_end))
    if v.shape != k.shape:
        raise ValueError(f"ragged_decode_attention: v {tuple(v.shape)} is not k's "
                         f"{tuple(k.shape)}")
    if k.dtype not in (torch.float32, torch.bfloat16) or v.dtype != k.dtype:
        raise TypeError(f"ragged_decode_attention: dtypes k={k.dtype} v={v.dtype}")
    if not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError("ragged_decode_attention: K/V caches must be contiguous")
    q = _aligned("ragged_decode_attention", q, (k, v))
    vl, hs, he = _i32(valid_len), _i32(hole_start), _i32(hole_end)
    out = torch.empty((B, H, 64), device=q.device, dtype=torch.float32)
    fn = cuda_lib.function("decode_attention", "ragged_decode_attention",
                           [cuda_lib.P] * 7 + [cuda_lib.I] * 5 + [cuda_lib.F, cuda_lib.P])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), vl.data_ptr(), hs.data_ptr(),
             he.data_ptr(), out.data_ptr(), B, H, cap, round_keys(cap, 64 * k.element_size()),
             int(k.dtype is torch.bfloat16), SCALE, torch.cuda.current_stream(q.device).cuda_stream)
    cuda_lib.check(err, "ragged_decode_attention")
    counter.add()
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
    token); the kernel returns zeros there."""
    if q.device.type == "cpu":
        return ragged_decode_attention_q8_plain(q, k8, v8, ksc, vsc, valid_len,
                                                hole_start, hole_end)
    name = "ragged_decode_attention_q8"
    B, H, cap = _check_common(name, q, k8, (v8, ksc, vsc, valid_len, hole_start, hole_end))
    if v8.shape != k8.shape:
        raise ValueError(f"{name}: v8 {tuple(v8.shape)} is not k8's {tuple(k8.shape)}")
    if ksc.shape != (B, H, cap) or vsc.shape != ksc.shape:
        raise ValueError(f"{name}: scale shape {tuple(ksc.shape)}/{tuple(vsc.shape)} "
                         f"does not match the cache {tuple(k8.shape)}")
    if k8.dtype != torch.int8 or v8.dtype != torch.int8 \
            or ksc.dtype != torch.float32 or vsc.dtype != torch.float32:
        raise TypeError(f"{name}: dtypes k8={k8.dtype} v8={v8.dtype} "
                        f"ksc={ksc.dtype} vsc={vsc.dtype}")
    if not all(t.is_contiguous() for t in (k8, v8, ksc, vsc)):
        raise ValueError(f"{name}: K/V caches and scales must be contiguous")
    q = _aligned(name, q, (k8, v8))
    vl, hs, he = _i32(valid_len), _i32(hole_start), _i32(hole_end)
    out = torch.empty((B, H, 64), device=q.device, dtype=torch.float32)
    fn = cuda_lib.function("decode_attention", name,
                           [cuda_lib.P] * 9 + [cuda_lib.I] * 4 + [cuda_lib.F, cuda_lib.P])
    err = fn(q.data_ptr(), k8.data_ptr(), v8.data_ptr(), ksc.data_ptr(), vsc.data_ptr(),
             vl.data_ptr(), hs.data_ptr(), he.data_ptr(), out.data_ptr(), B, H, cap,
             round_keys(cap, 64), SCALE, torch.cuda.current_stream(q.device).cuda_stream)
    cuda_lib.check(err, name)
    q8_counter.add()
    return out
