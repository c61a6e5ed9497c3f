"""Anti-aliased SnakeBeta: 2x kaiser-sinc upsample -> snake -> 2x kaiser-sinc
downsample, replicate padding (kernel K2).

Layout (B, C, T), as torch's Conv1d gives it. The CUDA kernel
(csrc/snake.cu) replaces the JAX package's Pallas kernels
(indextts_tpu/ops/snake_pallas.py `_kernel`, `_kernel_t`);
`anti_alias_snake_plain` is the polyphase algebra of the JAX package's
`anti_alias_snake_sliced` in plain PyTorch, which the wrapper runs for CPU
tensors. `snake_plan` is the kernel's launch, worked out here and checked
by the C launcher; `kernel_taps` the taps it takes by value.

x may be float32 or bfloat16 (a bfloat16 vocoder, runtime.voc_dtype): the
output has x's dtype, and the arithmetic is float32 either way, alpha and
beta widened to it, as the JAX package's Pallas kernels upcast them
(indextts_tpu/ops/snake_pallas.py:250-255, 309-313). A bfloat16 x takes
the kernel's bfloat16 instantiation (`anti_alias_snake_bf16`, counted on
`bf16_counter`), which reads a bfloat16 model's alpha and beta as they
are stored (or float32 ones), so a call stays one launch; its plain
version widens x, computes and rounds once.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from indextts_tpu_torch.ops import cuda_lib


counter = cuda_lib.LaunchCounter()  # the float32 instantiation's launches
bf16_counter = cuda_lib.LaunchCounter()  # the bfloat16 instantiation's


def kaiser_sinc_filter1d(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """filter.py:30-62 semantics; returns (kernel_size,) float32, sum = 1."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4 * half_width
    A = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if A > 50.0:
        beta = 0.1102 * (A - 8.7)
    elif A >= 21.0:
        beta = 0.5842 * (A - 21) ** 0.4 + 0.07886 * (A - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)
    if even:
        time = np.arange(-half_size, half_size) + 0.5
    else:
        time = np.arange(kernel_size) - half_size
    if cutoff == 0:
        return np.zeros(kernel_size, dtype=np.float32)
    filt = 2 * cutoff * window * np.sinc(2 * cutoff * time)
    filt = filt / filt.sum()
    return filt.astype(np.float32)


@functools.lru_cache(maxsize=1)
def polyphase_taps() -> Tuple[List[float], List[float], List[float]]:
    """(even, odd, down) taps of the 12-tap 2x filter: up[2t] uses
    even[m] * x[t - 3 + m], up[2t+1] uses odd[m] * x[t - 2 + m]."""
    f = kaiser_sinc_filter1d(0.5 / 2, 0.6 / 2, 12)
    even = [float(f[11 - 2 * m]) for m in range(6)]
    odd = [float(f[10 - 2 * m]) for m in range(6)]
    down = [float(w) for w in f]
    return even, odd, down


def anti_alias_snake_plain(x, alpha, beta, logscale: bool = True):
    """x (B, C, T); alpha, beta (C,), all of one dtype (float32 on the
    path). Returns (B, C, T)."""
    even_taps, odd_taps, down_taps = polyphase_taps()
    T = x.shape[-1]
    n_up = T + 6
    xg = F.pad(x, (8, 8), mode="replicate")
    if logscale:
        alpha = torch.exp(alpha)
        beta = torch.exp(beta)
    a = alpha[None, :, None]
    inv = 1.0 / (beta[None, :, None] + 1e-9)

    def fir(start, taps):
        acc = taps[0] * xg[..., start:start + n_up]
        for m in range(1, 6):
            acc = acc + taps[m] * xg[..., start + m:start + m + n_up]
        return acc

    def snake(u):
        s = torch.sin(u * a)
        return u + inv * s * s

    up_even = snake(2.0 * fir(2, even_taps))
    up_odd = snake(2.0 * fir(3, odd_taps))
    # edge clamp of the up signal: up[m<0] := up[0], up[m>2T-1] := up[2T-1]
    g = torch.arange(n_up, device=x.device) - 3
    row0 = up_even[..., 3:4]
    row_t = up_odd[..., T + 2:T + 3]
    lo, hi = g < 0, g > T - 1
    up_even = torch.where(lo, row0, torch.where(hi, row_t, up_even))
    up_odd = torch.where(lo, row0, torch.where(hi, row_t, up_odd))
    acc = None
    for j, w in enumerate(down_taps):
        ofs = j - 5
        phase = ofs & 1
        per = (ofs - phase) // 2
        src = up_odd if phase else up_even
        term = w * src[..., per + 3:per + 3 + T]
        acc = term if acc is None else acc + term
    return acc


SNAKE_WARPS = 4  # warps a block: csrc/snake.cu kWarps
SNAKE_LANE_OUTPUTS = 12  # R, the consecutive outputs a lane holds in registers


def snake_plan(B: int, C: int, T: int) -> Tuple[int, int, int]:
    """K2's launch over x (B, C, T): (R, chunks, blocks).

    A warp takes a chunk of 32 * R consecutive outputs of one row, lane l
    the R from l * R; a row takes chunks = ceil(T / (32 R)) warps, of which
    only the last runs past T (its lanes past T store nothing), so at most
    one warp's chunk a row is idle. Warp w takes chunk w % chunks of row
    w // chunks (row = b * C + c), SNAKE_WARPS warps a block: blocks =
    ceil(B * C * chunks / SNAKE_WARPS), of which only the last may hold
    warps past the rows (they return)."""
    if B < 1 or C < 1 or T < 1:
        raise ValueError(f"anti_alias_snake: x must be non-empty, got ({B}, {C}, {T})")
    r = SNAKE_LANE_OUTPUTS
    chunks = -(-T // (32 * r))
    return r, chunks, -(-B * C * chunks // SNAKE_WARPS)


@functools.lru_cache(maxsize=1)
def kernel_taps() -> Tuple[float, ...]:
    """The kernel's 24 taps: even and odd times the up FIR's gain of 2,
    then down. Folding the gain is exact: a product or sum of float32
    values times 2 is the product or sum of the values with one of them
    doubled, rounded alike, away from overflow and subnormals."""
    even, odd, down = polyphase_taps()
    return tuple([2.0 * t for t in even + odd] + down)


@functools.lru_cache(maxsize=1)
def _taps_arg() -> ctypes.Array:
    return (ctypes.c_float * 24)(*kernel_taps())


def anti_alias_snake(x, alpha, beta, logscale: bool = True):
    """K2 on CUDA tensors, the plain version on CPU tensors. x (B, C, T)
    float32 or bfloat16, the output of its dtype; alpha, beta (C,) of any
    float dtype, read as float32."""
    if x.device.type == "cpu":
        return anti_alias_snake_plain(x.float(), alpha.float(), beta.float(),
                                      logscale).to(x.dtype)
    if x.dim() != 3:
        raise ValueError(f"x must be (B, C, T), got {tuple(x.shape)}")
    B, C, T = x.shape
    if alpha.shape != (C,) or beta.shape != (C,):
        raise ValueError(f"alpha/beta must be ({C},)")
    if x.dtype not in (torch.float32, torch.bfloat16) or not alpha.is_floating_point() \
            or not beta.is_floating_point():
        raise TypeError(f"x float32 or bfloat16, alpha/beta float, got "
                        f"{x.dtype}/{alpha.dtype}/{beta.dtype}")
    if alpha.device != x.device or beta.device != x.device:
        raise ValueError("all inputs must be on the same device")
    bf16 = x.dtype == torch.bfloat16
    # the bf16 instantiation reads alpha and beta as bfloat16 or float32
    ab_bf16 = bf16 and alpha.dtype == beta.dtype == torch.bfloat16
    if not ab_bf16:
        alpha, beta = alpha.float(), beta.float()
    x, alpha, beta = x.contiguous(), alpha.contiguous(), beta.contiguous()
    out = torch.empty_like(x)
    vec = T % 4 == 0 and x.data_ptr() % (4 * x.element_size()) == 0
    args = (x.data_ptr(), alpha.data_ptr(), beta.data_ptr(), ctypes.addressof(_taps_arg()),
            out.data_ptr(), B, C, T, int(logscale), *snake_plan(B, C, T), int(vec))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if bf16:
        symbol = "anti_alias_snake_bf16"
        fn = cuda_lib.function("snake", symbol, [cuda_lib.P] * 5 + [cuda_lib.I] * 9 + [cuda_lib.P])
        err = fn(*args, int(ab_bf16), stream)
    else:
        symbol = "anti_alias_snake"
        fn = cuda_lib.function("snake", symbol, [cuda_lib.P] * 5 + [cuda_lib.I] * 8 + [cuda_lib.P])
        err = fn(*args, stream)
    cuda_lib.check(err, symbol)
    (bf16_counter if bf16 else counter).add()
    return out
